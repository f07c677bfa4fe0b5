"""h2o-danube-3-4b — llama + mistral mix with sliding-window attention
[arXiv:2401.16818; unverified].

The same two entries as ``repro/configs/h2o_danube_3_4b.py``: the
published shape (head_dim 120, a 4096-token window that bounds the dense
KV cache to a 4096-slot ring) and its f32 smoke reduction (window 32)
for CPU tests.
"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000, head_dim=120,
    window=4096,
    notes="SWA -> long_500k runs",
))

register(ModelConfig(
    name="h2o-danube-3-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, head_dim=16, window=32,
    dtype="float32",
))
