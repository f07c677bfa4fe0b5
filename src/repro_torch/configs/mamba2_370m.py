"""mamba2-370m — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified].

The same two entries as ``repro/configs/mamba2_370m.py``: the published
shape (48 Mamba-2 layers, d_inner 2048 in 32 heads of 64, d_state 128)
and its f32 smoke reduction for CPU tests.
"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=50280, ssm_state=128,
    layer_pattern=("ssm",),
    notes="attention-free; long_500k runs (O(1) state)",
))

register(ModelConfig(
    name="mamba2-370m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=512, ssm_state=16,
    layer_pattern=("ssm",),
    dtype="float32",
))
