"""whisper-large-v3 [audio]: enc-dec, 32 encoder + 32 decoder layers,
d_model=1280 20H (kv=20) d_ff=5120, vocab 51866; conv frontend is a
STUB — input_specs() provides 1500 precomputed frame embeddings.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp_type="gelu",
    encoder_layers=32,
    encoder_seq=1500,
    cross_attention=True,
    source="arXiv:2212.04356 (unverified)",
)
