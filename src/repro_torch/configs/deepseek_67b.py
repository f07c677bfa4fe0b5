"""deepseek-67b — llama-arch dense LM [arXiv:2401.02954; hf].

The same two entries as ``repro/configs/deepseek_67b.py``.
"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, head_dim=128,
    notes="full attention -> long_500k skipped",
))

register(ModelConfig(
    name="deepseek-67b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=512, head_dim=16,
    dtype="float32",
))
