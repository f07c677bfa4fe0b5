"""``repro_torch.tune`` — measured autotuning (port of ``repro/tune``):
the top-K tile and attention block search on the device, the
persistent tuning cache, and cost-model calibration.

The analytic search (:mod:`repro_torch.core.dse`, on the ``HOPPER_H100``
sheet) picks tiles from a traffic model; this package closes the loop
against the card:

* :mod:`repro_torch.tune.measure` — the shared timing harness
  (synthesized operands, warm-up, median-of-N between device syncs with
  outlier rejection and reported spread);
* :mod:`repro_torch.tune.autotune` — when enabled, ``plan()`` times the
  top-K analytic candidates and picks the measured winner, and
  ``attn_plan()`` the attention kernels' compiled blocks;
* :mod:`repro_torch.tune.cache` — winners persist to a schema-versioned
  JSON file keyed like the plan cache (spec key + shape + device mode),
  so a second process re-measures nothing;
* :mod:`repro_torch.tune.calibrate` — least-squares fit of effective
  bandwidth / compute constants from the recorded samples, optionally
  fed back into the analytic model.

Enable per spec (``GemmSpec(tune=True)``, ``AttnSpec(tune=True)``), per
process (:func:`enable` / ``--autotune`` on serve), or with the
``REPRO_AUTOTUNE`` env var.
"""

from repro_torch.tune import calibrate  # noqa: F401
from repro_torch.tune.autotune import (  # noqa: F401
    DEFAULT_K,
    attn_lookup_or_search,
    disable,
    enable,
    is_enabled,
    lookup_or_search,
    measure_device,
    search_k,
)
from repro_torch.tune.cache import (  # noqa: F401
    SCHEMA_VERSION as CACHE_SCHEMA_VERSION,
    TuningCache,
    TuningCacheInfo,
    attn_cache_key,
    cache_key,
    cache_path,
    device_mode,
    tuning_cache,
    tuning_cache_info,
    tuning_cache_reset,
)
from repro_torch.tune.measure import (  # noqa: F401
    DEFAULT_ITERS,
    DEFAULT_MAX_FLOPS,
    DEFAULT_WARMUP,
    Measurement,
    measure_attn_plan,
    measure_plan,
    synthesize_attn_operands,
    synthesize_operands,
)
