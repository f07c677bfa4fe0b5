"""kimi-k2-1t-a32b — trillion-parameter MoE (384 experts, top-8)
[arXiv:2501.kimi2; unverified].

The same two entries as ``repro/configs/kimi_k2_1t_a32b.py``: about
1.03e12 parameters in all, 32e9 active a token; head_dim 112.
"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, head_dim=112,
    layer_pattern=("moe",), n_experts=384, top_k=8,
    notes="MoE 384e top-8; full attention -> long_500k skipped",
))

register(ModelConfig(
    name="kimi-k2-1t-a32b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=512, head_dim=16,
    layer_pattern=("moe",), n_experts=8, top_k=2,
    dtype="float32",
    capacity_factor=8.0,
))
