"""The parameter bridge between the packages, and the port's isolation
from JAX: ``repro_torch`` and ``chip_smoke.py`` import neither ``jax``
nor anything of the ``repro`` package."""

import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax, to_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_round_trip_is_bit_exact(dtype):
    x = jax.random.normal(jax.random.PRNGKey(0), (3, 5, 7)).astype(dtype)
    tree = {"layers": {"u0": {"w": np.asarray(x)}}, "pos": np.arange(4)}
    t = from_jax(tree)
    assert t["layers"]["u0"]["w"].dtype == \
        {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[dtype]
    back = to_numpy(t)
    assert back["layers"]["u0"]["w"].dtype == np.asarray(x).dtype
    np.testing.assert_array_equal(
        back["layers"]["u0"]["w"].view(np.uint8),
        np.asarray(x).view(np.uint8))
    np.testing.assert_array_equal(back["pos"], np.arange(4))


def test_bf16_values_survive_the_bridge():
    x = jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16)
    t = from_jax({"x": np.asarray(x)})["x"]
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x, np.float32))


def test_import_leaves_jax_and_repro_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.ops, repro_torch.bridge\n"
        "import repro_torch.configs, repro_torch.models.transformer\n"
        "import repro_torch.serve.engine, repro_torch.serve.paging\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.kernels.gemm_aie, repro_torch.kernels.gemm_gated\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.flash_decode\n"
        "import repro_torch.kernels.gemm_tb, repro_torch.kernels.api\n"
        "import repro_torch.core.tiling, repro_torch.core.hardware\n"
        "import repro_torch.core.memory_model, repro_torch.core.bandwidth\n"
        "import repro_torch.core.dse, repro_torch.models.moe\n"
        "import repro_torch.kernels.gemm_grouped\n"
        "import repro_torch.configs.qwen3_moe_235b_a22b\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def test_sources_import_nothing_of_jax_or_repro():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|"
                     r"from repro import|import repro\s*$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, (f, hits)
