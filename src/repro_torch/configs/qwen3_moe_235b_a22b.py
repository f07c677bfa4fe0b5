"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3; hf].

The same two entries as ``repro/configs/qwen3_moe_235b_a22b.py``: the
published shape (head_dim=128: the Qwen3 family decouples head_dim from
d_model/n_heads) and its f32 smoke reduction for CPU tests.
"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128,
    layer_pattern=("moe",), n_experts=128, top_k=8,
    notes="MoE 128e top-8; full attention -> long_500k skipped",
))

register(ModelConfig(
    name="qwen3-moe-235b-a22b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=512, head_dim=16,
    layer_pattern=("moe",), n_experts=8, top_k=2,
    dtype="float32",
    capacity_factor=8.0,
))
