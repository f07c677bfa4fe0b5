"""``repro_torch.dist`` — the sharding and layout subsystem (port of
``repro.dist`` on ``torch.distributed``).

* :mod:`repro_torch.dist.sharding` — mechanism: the mesh of the process
  group's ranks (``Mesh``, ``use_mesh`` / ``current_mesh``), logical-axis
  resolution, shard arithmetic and ``shard_map``.
* :mod:`repro_torch.dist.layout` — policy: the name-pattern spec engine
  (``spec_for``, ``param_specs`` / ``cache_specs`` / ``batch_specs``)
  and ``choose_layout``, with ``shard_tree`` / ``gather_tree`` in place
  of ``jax.device_put``.
* :mod:`repro_torch.dist.collectives` — the all_to_all, all-gather and
  all-reduce (autograd Functions) that GSPMD and ``shard_map`` insert in
  the JAX package, on NCCL or gloo by the cards.
"""

from repro_torch.dist import collectives, layout, sharding  # noqa: F401
