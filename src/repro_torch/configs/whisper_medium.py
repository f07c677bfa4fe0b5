"""whisper-medium — encoder-decoder audio model [arXiv:2212.04356;
unverified].

The same two entries as ``repro/configs/whisper_medium.py``.  The
conv / mel frontend is a stub: the encoder takes precomputed frame
embeddings (b, 1500, d).  Decoder: causal self-attention,
cross-attention over the encoder's output, a GELU MLP, LayerNorm,
absolute (sinusoidal) positions, MHA (kv heads = heads).
"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, head_dim=64,
    encoder_layers=24, encoder_seq=1500, use_rope=False,
    notes="enc-dec; full attention -> long_500k skipped",
))

register(ModelConfig(
    name="whisper-medium-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, head_dim=16,
    encoder_layers=2, encoder_seq=16, use_rope=False,
    dtype="float32",
))
