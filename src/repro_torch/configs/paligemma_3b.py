"""paligemma-3b [vlm]: gemma backbone 18L d_model=2048 8H (MQA kv=1)
d_ff=16384, vocab 257216; SigLIP frontend is a STUB — input_specs()
provides 256 precomputed patch embeddings per image.
[arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_type="gelu",
    num_image_tokens=256,
    source="arXiv:2407.07726",
)
