"""The port's op-by-op cost counter and roofline against the JAX
package's HLO cost and roofline, on the CPU.

* **FLOPs against JAX.**  Tiny dense (``smollm-360m-smoke``) and MoE
  (``qwen3-moe-235b-a22b-smoke``) configs, 2 layers each, f32, from
  identical parameters carried by ``bridge``: the counter's FLOPs of the
  forward, the train step, a prefill and a decode step equal
  ``repro.core.hlo_cost.analyze_text(...).flops`` of the same step
  compiled by JAX on the CPU with the reference kernels
  (``REPRO_KERNELS=ref``), exactly (rel 1e-12: both are sums of
  integers), once the work that one side does and the other does not is
  added, each gap named by its op:

  - the gated GEMM's backward (``kernels/api.py`` ``_GemmCore.backward``)
    recomputes A Bg and A Bu, and the attention's
    (``kernels/attn_api.py`` ``_AttnCore.backward``) recomputes QK^T and
    PV through the reference, where XLA merges both with the
    rematerialised forward (common-subexpression elimination); a grouped
    GEMM's backward (``_GroupedCore.backward``) likewise recomputes the
    gate GEMM's pre-activation;
  - ``torch.utils.checkpoint`` recomputes a unit's last GEMM (``w_down``),
    whose output no backward reads, where XLA drops it;
  - the reference's grouped GEMM (``repro/kernels/ref.py``
    ``gemm_grouped_ref``) runs one full dot a group, every routed row
    against all E experts' weights, and its weight gradient the one-hot
    einsum over all E; B7 and the port's dB take each row against its
    own expert (E x fewer FLOPs).

* **CPU == meta.**  The same steps counted on CPU tensors with data and
  on meta tensors give equal FLOPs and bytes in every scope (B7's rows:
  live with data, capacity on meta, equal here since the smoke MoE
  drops no token).
* **Boundary bytes.**  Each kernel scope's bytes are its operands read
  once plus its result written once, on the CPU and on meta.
* **The report.**  ``RooflineReport``'s ``dominant``, ``t_bound`` and
  ``roofline_fraction`` agree with ``repro.core.roofline``'s on the same
  three terms.

The card's count against the meta count is ``tests/test_torch_cuda.py``
``test_op_cost_card_equals_meta`` (it needs the card, so it lives with
the other card tests, in a file that imports no JAX).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.core import hlo_cost
from repro.core import roofline as jroof
from repro.data import pipeline as JP
from repro.models import transformer as JT
from repro.optim import adamw as JAW
from repro.train import train_step as JTS
from repro_torch.bridge import from_jax, train_state_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.core import op_cost, roofline
from repro_torch.core.hardware import HOPPER_H100
from repro_torch.data import pipeline as P
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.kernels.gemm_aie import gemm_aie
from repro_torch.kernels.gemm_gated import gemm_gated
from repro_torch.kernels.gemm_grouped import gemm_grouped
from repro_torch.kernels.gemm_tb import gemm_tb
from repro_torch.core.tiling import TileConfig
from repro_torch.models import transformer as T
from repro_torch.train import train_step as TS

DENSE, MOE = "smollm-360m", "qwen3-moe-235b-a22b"
B, S = 4, 16                    # the batch of every step here
EXACT = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _ref_kernels():
    old = os.environ.get("REPRO_KERNELS")
    os.environ["REPRO_KERNELS"] = "ref"
    yield
    if old is None:
        os.environ.pop("REPRO_KERNELS")
    else:
        os.environ["REPRO_KERNELS"] = old


class _Case:
    """One arch's JAX and port configs, parameters, batch and states."""

    def __init__(self, arch):
        self.jcfg, self.tcfg = j_smoke(arch), get_smoke_config(arch)
        self.jp = JT.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.tp = from_jax(jax.tree.map(np.asarray, self.jp))
        dc = dict(seq_len=S, global_batch=B, seed=0)
        self.jb = JP.make_batch(self.jcfg, JP.DataConfig(**dc), 0)
        self.tb = P.make_batch(self.tcfg, P.DataConfig(**dc), 0)
        self.js = JTS.TrainState(params=self.jp, opt=JAW.init(self.jp),
                                 step=jnp.zeros((), jnp.int32))
        self.ts = train_state_from_jax(jax.tree.map(np.asarray, self.js))


@pytest.fixture(scope="module")
def cases():
    return {arch: _Case(arch) for arch in (DENSE, MOE)}


STEP_KW = dict(optimizer="adamw", n_loss_chunks=4)


def _jax_flops(fn, *args) -> float:
    compiled = jax.jit(fn).lower(*args).compile()
    return hlo_cost.analyze_text(compiled.as_text()).flops


def _count(step) -> op_cost.OpCost:
    fn, args = step
    with op_cost.count() as c:
        fn(*args)
    return c.result()


@pytest.fixture(scope="module")
def cpu_counts(cases):
    """The port's count of each (arch, kind) step on CPU tensors, made
    once for the tests that read it."""
    return {(arch, kind): _count(_port_step(cases[arch], kind))
            for arch in (DENSE, MOE)
            for kind in ("forward", "train", "prefill", "decode")}


# ---------------------------------------------------------------- the steps

def _port_step(case, kind, meta=False):
    """(callable, args) of one port step; on meta, the same shapes with
    no data."""
    cfg = case.tcfg
    if kind == "train":
        step = TS.make_train_step(cfg, **STEP_KW)
        if meta:
            return step, (TS.state_struct(cfg, "adamw"), P.batch_spec(
                cfg, P.DataConfig(seq_len=S, global_batch=B)))
        return step, (case.ts, case.tb)
    params = TS.state_struct(cfg).params if meta else case.tp
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta") \
        if meta else case.tb["tokens"]
    device = "meta" if meta else "cpu"
    if kind == "forward":
        def fwd(p, t):
            with torch.no_grad():
                return T.forward(p, cfg, t, remat=False)
        return fwd, (params, tokens)
    cache = T.init_cache(cfg, B, 2 * S, device=device)

    def prefill(p, t, c):
        with torch.inference_mode():
            return T.prefill(p, cfg, t, c)
    if kind == "prefill":
        return prefill, (params, tokens, cache)
    with torch.inference_mode():
        _, cache = T.prefill(params, cfg, tokens, cache)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)

    def decode(p, t, c):
        with torch.inference_mode():
            return T.decode_step(p, cfg, t, c)
    return decode, (params, tok, cache)


def _jax_step(case, kind) -> float:
    cfg = case.jcfg
    if kind == "forward":
        return _jax_flops(lambda p, t: JT.forward(p, cfg, t)[0], case.jp,
                          case.jb["tokens"])
    if kind == "train":
        return _jax_flops(JTS.make_train_step(cfg, **STEP_KW), case.js,
                          case.jb)
    cache = JT.init_cache(cfg, B, 2 * S)
    if kind == "prefill":
        return _jax_flops(lambda p, t, c: JT.prefill(p, cfg, t, c),
                          case.jp, case.jb["tokens"], cache)
    _, cache = jax.jit(lambda p, t, c: JT.prefill(p, cfg, t, c))(
        case.jp, case.jb["tokens"], cache)
    return _jax_flops(lambda p, t, c: JT.decode_step(p, cfg, t, c),
                      case.jp, jnp.zeros((B, 1), jnp.int32), cache)


def _named_gap(case, kind, cost: op_cost.OpCost) -> float:
    """JAX's FLOPs from the port's count: the port's, minus what only the
    port computes, plus what only the reference computes (module
    docstring)."""
    cfg = case.tcfg
    layers, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    tokens = B * S
    port = cost.flops
    # the attention backward's recompute of QK^T and PV
    attn = layers * 4 * B * cfg.n_heads * S * S * cfg.hd \
        if kind == "train" else 0
    if cfg.family == "dense":
        if kind != "train":
            return port
        gated = layers * 2 * (2 * tokens * d * ff)     # A Bg, A Bu again
        down = layers * 2 * tokens * ff * d            # w_down's remat
        return port - gated - down - attn
    e = cfg.n_experts
    b7 = cost.flops_by_scope.get("gemm_grouped", 0.0)
    db = cost.flops_by_scope.get("grouped_db", 0.0)
    if kind != "train":
        return port + (e - 1) * b7
    rows = tokens * cfg.top_k                          # no token dropped
    act = layers * 2 * rows * d * ff                   # the gate's z again
    return port - b7 - db - attn + e * (b7 - act + db)


@pytest.mark.parametrize("kind", ["forward", "train", "prefill", "decode"])
@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_flops_equal_jax_hlo_cost(cases, cpu_counts, arch, kind):
    case = cases[arch]
    cost = cpu_counts[(arch, kind)]
    assert cost.flops > 0
    want = _jax_step(case, kind)
    assert _named_gap(case, kind, cost) == pytest.approx(want, rel=EXACT)
    if kind in ("forward", "prefill", "decode") and arch == DENSE:
        assert cost.flops == pytest.approx(want, rel=EXACT)


@pytest.mark.parametrize("kind", ["forward", "train", "prefill", "decode"])
@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_cpu_count_equals_meta_count(cases, cpu_counts, arch, kind):
    case = cases[arch]
    cpu = cpu_counts[(arch, kind)]
    meta = _count(_port_step(case, kind, meta=True))
    assert cpu.flops_by_scope == meta.flops_by_scope
    assert cpu.bytes_by_scope == meta.bytes_by_scope
    assert cpu.calls_by_scope == meta.calls_by_scope
    assert cpu.collective_bytes == meta.collective_bytes
    # B7's rows: live with data, capacity on meta (equal: nothing dropped)
    assert cpu.grouped_rows["capacity"] == meta.grouped_rows["live"] == 0
    assert cpu.grouped_rows["live"] == meta.grouped_rows["capacity"]
    assert (cpu.grouped_rows["live"] > 0) == (arch == MOE)


# ------------------------------------------------------------ boundary bytes

def _t(shape, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    return x.to(dtype).to(device)


def _nb(*ts):
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _kernel_cases(device):
    """(scope, call, operands, FLOPs) of each wrapper at a small shape."""
    m, k, n = 6, 32, 24
    a, b = _t((m, k), device=device), _t((k, n), device=device, seed=1)
    bias, res = _t((n,), device=device, seed=2), _t((m, n), device=device)
    bg, bu = _t((k, n), device=device, seed=3), _t((k, n), device=device,
                                                   seed=4)
    q, kk, v = (_t((2, 8, 4, 16), device=device, seed=s) for s in (5, 6, 7))
    kk, v = kk[:, :, :2].contiguous(), v[:, :, :2].contiguous()
    qd = _t((2, 4, 16), device=device, seed=8)
    kc, vc = (_t((2, 32, 2, 16), device=device, seed=s) for s in (9, 10))
    pos = torch.tensor([5, 20], dtype=torch.int32, device=device)
    kp, vp = (_t((6, 8, 2, 16), device=device, seed=s) for s in (11, 12))
    table = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32,
                         device=device)
    xs, bank = _t((10, k), device=device), _t((3, k, n), device=device)
    sizes = torch.tensor([4, 0, 6], dtype=torch.int32, device=device)
    tile = TileConfig(8, 32, 32, "tb")
    return [
        ("gemm_aie", lambda: gemm_aie(a, b, bias=bias, residual=res),
         (a, b, bias, res), 2 * m * k * n),
        ("gemm_tb", lambda: gemm_tb(a, b, tile=tile, residual=res),
         (a, b, res), 2 * m * k * n),
        ("gemm_gated", lambda: gemm_gated(a, bg, bu), (a, bg, bu),
         4 * m * k * n),
        ("flash_attention", lambda: flash_attention(q, kk, v),
         (q, kk, v), 4 * 2 * 4 * 8 * 8 * 16),
        ("flash_decode", lambda: flash_decode(qd, kc, vc, pos),
         (qd, kc, vc, pos), 4 * 2 * 4 * 32 * 16),
        ("flash_decode_paged",
         lambda: flash_decode_paged(qd, kp, vp, table, pos),
         (qd, kp, vp, table, pos), 4 * 2 * 4 * 24 * 16),
        ("gemm_grouped", lambda: gemm_grouped(xs, bank, sizes),
         (bank, sizes), 2 * 10 * k * n),
    ], xs


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_scope_bytes_are_boundary_bytes(device):
    cases, xs = _kernel_cases(device)
    for scope, call, operands, flops in cases:
        with op_cost.count() as c:
            out = call()
        r = c.result()
        want = _nb(*operands, out)
        if scope == "gemm_grouped":       # A: the rows B7 counts (all 10)
            want += _nb(xs)
        assert r.calls_by_scope == {scope: 1}, scope
        assert r.bytes_by_scope == {scope: want}, scope
        assert r.flops_by_scope == {scope: flops}, scope


def test_grouped_scope_counts_live_rows_with_data():
    """Rows past sum(group_sizes) are not B7's work with data; on meta
    every row of A counts."""
    k, n = 16, 8
    for device, rows, kind in (("cpu", 7, "live"), ("meta", 12, "capacity")):
        xs, bank = _t((12, k), device=device), _t((3, k, n), device=device)
        sizes = torch.tensor([3, 0, 4], dtype=torch.int32, device=device)
        with op_cost.count() as c:
            out = gemm_grouped(xs, bank, sizes)
        r = c.result()
        assert r.flops_by_scope["gemm_grouped"] == 2 * rows * k * n
        assert r.bytes_by_scope["gemm_grouped"] == \
            rows * k * 4 + _nb(bank, sizes, out)
        assert r.grouped_rows[kind] == rows


def test_kernel_scope_peak_holds_only_its_result():
    """Inside a scope the plain version's temporaries (B3's scores) do
    not count: the peak is the operands plus the result."""
    q, k, v = (_t((1, 64, 2, 16), seed=s) for s in range(3))
    with op_cost.count(hold=(q, k, v)) as c:
        o = flash_attention(q, k, v)
    assert c.result().peak_bytes == _nb(q, k, v, o)


# --------------------------------------------------------------- the report

@pytest.mark.parametrize("flops,hbm,coll", [
    (4e15, 1e12, 1e9),          # compute
    (1e12, 4e12, 1e9),          # memory
    (1e12, 1e9, 4e12),          # collective
    (0.0, 0.0, 0.0),
])
def test_report_agrees_with_jax_roofline(flops, hbm, coll):
    cost = op_cost.OpCost(
        flops=flops, bytes_accessed=hbm,
        collective_bytes={"all-gather": coll, "all-reduce": 0.0,
                          "reduce-scatter": 0.0, "all-to-all": 0.0,
                          "collective-permute": 0.0},
        flops_by_scope={}, bytes_by_scope={}, calls_by_scope={},
        peak_bytes=0, grouped_rows={})
    ours = roofline.analyze(cost, model_flops_per_device=flops / 2)
    theirs = jroof.RooflineReport(
        flops_per_device=ours.flops_per_device,
        hbm_bytes_per_device=ours.hbm_bytes_per_device,
        collective_bytes_per_device=ours.collective_bytes_per_device,
        per_collective=ours.per_collective, t_compute=ours.t_compute,
        t_memory=ours.t_memory, t_collective=ours.t_collective,
        peak_flops=ours.peak_flops,
        model_flops_per_device=ours.model_flops_per_device)
    assert ours.dominant == theirs.dominant
    assert ours.t_bound == theirs.t_bound
    assert ours.roofline_fraction == theirs.roofline_fraction
    assert ours.useful_flops_ratio == theirs.useful_flops_ratio
    d = ours.as_dict()
    assert set(theirs.as_dict()) - set(d) == {"xla_flops_raw",
                                              "xla_bytes_raw", "n_while"}
    # priced on the H100 sheet: bf16 tensor cores, HBM3, one NVLink way
    assert ours.t_compute == flops / 989e12
    assert ours.t_memory == hbm / 3.35e12
    assert ours.t_collective == coll / HOPPER_H100.link_bw == coll / 450e9


def test_report_prices_f32_and_int8():
    cost = op_cost.OpCost(1e12, 0.0, {"all-gather": 0.0}, {}, {}, {}, 0, {})
    assert roofline.analyze(cost, f32=True).t_compute == 1e12 / 67e12
    assert roofline.analyze(cost, int8=True).t_compute == 1e12 / 1979e12
