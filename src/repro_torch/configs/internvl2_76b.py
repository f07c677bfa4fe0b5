"""internvl2-76b — InternViT + llama-3-70B-class backbone
[arXiv:2404.16821; unverified].

The same two entries as ``repro/configs/internvl2_76b.py``.  The vision
tower is a stub: 256 precomputed patch embeddings (b, 256, d) are
prepended to the text tokens, and the loss covers text positions only.
"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    prefix_tokens=256,
    notes="ViT frontend stubbed; full attention -> long_500k skipped",
))

register(ModelConfig(
    name="internvl2-76b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, head_dim=16, prefix_tokens=8,
    dtype="float32",
))
