"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 2:1
[arXiv:2402.19427; unverified].

The same two entries as ``repro/configs/recurrentgemma_9b.py``: the
published shape (38 layers, 12 x (rec, rec, local) + a (rec, rec) tail;
local attention over a 2048-token window with one kv head of 256) and
its f32 smoke reduction (window 32) for CPU tests.
"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    layer_pattern=("rec", "rec", "local"), tail_pattern=("rec", "rec"),
    local_window=2048, lru_width=4096,
    notes="RG-LRU + local attn 1:2; long_500k runs",
))

register(ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=512, head_dim=16,
    layer_pattern=("rec", "rec", "local"), tail_pattern=("rec", "rec"),
    local_window=32, lru_width=64,
    dtype="float32",
))
