"""The port's dry-run CLI (``python -m repro_torch.launch.dryrun``) on
the CPU, as ``tests/test_dryrun_cli.py`` drives the JAX package's: one
cell a step kind on a 2 x 4 debug mesh in a subprocess, the documented
``long_500k`` skip, each record's keys against the reference's record,
and the cell matrix against the reference's.

The cells run at once, each in its own process (a cell is a
meta-device trace of one rank's step: the smollm-360m training cell
alone takes some 40 s here).  The measured half (``--measure``,
``--autotune``) runs on a 16 x 1 mesh, where a rank's decode GEMMs have 8
rows: timing the plain versions at 64 rows a GEMM takes minutes here.
"""

import ast
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from repro.launch import shapes as jshapes
from repro_torch.launch import shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (arch, shape, debug mesh, extra CLI arguments): one cell a step kind
#: on 2 x 4, the decode cell with its plans; then the decode cell again
#: for the measured half on the CPU's plain versions
CELLS = [
    ("smollm-360m", "train_4k", "2,4", []),
    ("smollm-360m", "decode_32k", "2,4", ["--explain"]),
    ("mamba2-370m", "prefill_32k", "2,4", []),
    ("smollm-360m", "decode_32k", "16,1",
     ["--measure", "--autotune", "1", "--device", "cpu"]),
]
DEBUG = [(a, s) for a, s, mesh, _ in CELLS if mesh == "2,4"]


def _env(tmp: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env["REPRO_TUNE_CACHE"] = os.path.join(tmp, "tune_cache.json")
    env["OMP_NUM_THREADS"] = "2"        # several processes share the host
    return env


@pytest.fixture(scope="module")
def records():
    """Each cell's record, the cells run in parallel subprocesses."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, (arch, shape, mesh, extra) in enumerate(CELLS):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", "single",
                   "--debug-mesh", mesh, "--out", os.path.join(tmp, str(i)),
                   *extra]
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=_env(tmp), cwd=REPO))
        out = {}
        for i, ((arch, shape, mesh, _), proc) in enumerate(zip(CELLS,
                                                               procs)):
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            with open(os.path.join(tmp, str(i), "single",
                                   f"{arch}__{shape}.json")) as f:
                out[(arch, shape, mesh)] = json.load(f)
    return out


@pytest.mark.parametrize("arch,shape", DEBUG)
def test_dryrun_cell(records, arch, shape):
    rec = records[(arch, shape, "2,4")]
    assert rec["ok"] and rec["mesh_shape"] == [2, 4]
    assert rec["n_devices"] == 8 and rec["layout"]
    r = rec["roofline"]
    assert r["flops_per_device"] > 0
    assert r["hbm_bytes_per_device"] > 0
    assert r["collective_bytes_per_device"] > 0     # the parameter gather
    assert r["dominant"] in ("compute", "memory", "collective")
    mem = rec["memory_analysis"]
    assert mem["available"]
    assert mem["peak_bytes_per_device"] >= rec["arg_bytes_per_device"] > 0
    assert mem["peak_bytes_per_device"] == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    assert rec["fits"] == (mem["peak_bytes_per_device"]
                           <= rec["hbm_per_device"])
    # every FLOP is a kernel's or a plain dot's; the kernels' scopes
    assert rec["cost_analysis"]["flops"] == pytest.approx(
        sum(rec["flops_by_scope"].values()), rel=1e-9)
    assert set(rec["flops_by_scope"]) - {"<none>"} <= {
        "gemm_aie", "gemm_gated", "gemm_tb", "gemm_grouped", "grouped_db",
        "flash_attention", "flash_decode", "flash_decode_paged"}
    assert rec["gemm_plan_cache"]["entries"] > 0


def test_decode_cell_options(records):
    rec = records[("smollm-360m", "decode_32k", "2,4")]
    assert rec["gemm_plans"] and rec["attn_plans"]
    assert "flash_decode" in "\n".join(rec["attn_plans"])
    measured = records[("smollm-360m", "decode_32k", "16,1")]
    assert measured["rows_per_device"] == 8
    summary = measured["model_vs_measured_summary"]
    assert summary["n_plans"] == summary["n_measured"] == \
        measured["gemm_plan_cache"]["entries"]
    assert {r["mode"] for r in measured["model_vs_measured"]} == {"cpu"}
    assert sum(measured["gemm_sources"].values()) == \
        measured["gemm_plan_cache"]["entries"]
    assert measured["tuning_cache"]["entries"] > 0


def _reference_keys() -> set:
    """The keys ``repro/launch/dryrun.py``'s ``run_cell`` and ``main``
    put in a record, read from its source (no JAX lowering needed)."""
    import repro.launch.dryrun as ref
    tree = ast.parse(open(ref.__file__).read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript) and isinstance(
                node.targets[0].value, ast.Name) \
                and node.targets[0].value.id == "rec":
            keys.add(node.targets[0].slice.value)
        elif isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id == "rec" \
                and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "update" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "rec":
            keys |= {k.arg for k in node.keywords}
    return keys


def test_record_keys_match_the_reference(records):
    """A full record holds every key of the reference's but the skip's,
    the failure's and ``--calibrate``'s (not ported), plus ``fits``, the
    rows a rank holds and B7's row kinds."""
    ref = _reference_keys()
    assert {"roofline", "memory_analysis", "gemm_plan_cache",
            "model_vs_measured"} <= ref
    want = ref - {"skipped", "skip_reason", "error", "calibration"}
    got = set(records[("smollm-360m", "decode_32k", "2,4")]) | set(
        records[("smollm-360m", "decode_32k", "16,1")])
    assert got - want == {"fits", "rows_per_device", "grouped_rows"}
    assert want - got == set()
    plain = set(records[("smollm-360m", "train_4k", "2,4")])
    assert plain == got - {"gemm_plans", "attn_plans", "tuning_cache",
                           "gemm_sources", "attn_sources",
                           "model_vs_measured", "model_vs_measured_summary"}


def test_dryrun_records_skip():
    """long_500k on a pure full-attention arch is a documented skip, with
    the reference's skip record."""
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
               "--mesh", "single", "--archs", "minitron-8b",
               "--shapes", "long_500k", "--out", d]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           env=_env(d), cwd=REPO, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        with open(os.path.join(d, "single",
                               "minitron-8b__long_500k.json")) as f:
            rec = json.load(f)
    assert rec["ok"] and rec["skipped"]
    assert "quadratic" in rec["skip_reason"]
    assert set(rec) == {"arch", "shape", "mesh", "ok", "skipped",
                        "skip_reason"}


def test_cells_equal_the_reference():
    assert shapes.all_cells() == jshapes.all_cells()
    assert shapes.runnable_cells() == jshapes.runnable_cells()
    assert len(shapes.all_cells()) == 40
    for name, spec in shapes.SHAPES.items():
        ref = jshapes.SHAPES[name]
        assert (spec.name, spec.seq_len, spec.global_batch, spec.kind) == \
            (ref.name, ref.seq_len, ref.global_batch, ref.kind)


def test_measure_executes_grouped_plans():
    """``--measure``'s report synthesizes a grouped plan's expert bank and
    group sizes (its m rows spread over the E experts) and times it, as
    it does the dense plans."""
    import torch

    from repro_torch import ops
    from repro_torch.telemetry import report as treport
    from repro_torch.tune import measure
    ops.plan_cache_clear()
    a = torch.randn(10, 16)
    ops.gemm_grouped(a, torch.randn(4, 16, 8),
                     torch.tensor([3, 3, 2, 2], dtype=torch.int32),
                     activation="silu")
    ops.gemm(a, torch.randn(16, 8))
    (grouped,) = [pl for pl in ops.plans() if pl.spec.grouped]
    o = measure.synthesize_operands(grouped, np.random.default_rng(0),
                                    "cpu")
    assert tuple(o["b"].shape) == (4, 16, 8)
    assert o["group_sizes"].tolist() == [3, 3, 2, 2]
    rows = treport.model_vs_measured(iters=1, warmup=1, device="cpu")
    assert len(rows) == 2
    assert all(r["t_measured_us"] is not None for r in rows)
