"""smollm-360m — small llama-arch LM [hf:HuggingFaceTB/SmolLM; hf].

The same two entries as ``repro/configs/smollm_360m.py``: the published
shape and its f32 smoke reduction for CPU tests.
"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, head_dim=64,
    notes="full attention -> long_500k skipped; heads %16 != 0",
))

register(ModelConfig(
    name="smollm-360m-smoke", family="dense",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1,
    d_ff=160, vocab=512, head_dim=20,
    dtype="float32",
))
