"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8, head_dim 128)
d_ff=25600, qk-norm, vocab 151936.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    source="hf:Qwen/Qwen3 family",
)
