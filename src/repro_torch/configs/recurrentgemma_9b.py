"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1)
d_ff=12288, RG-LRU + local attention in a 2:1 pattern, vocab 256000.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,                      # 12 x (rglru, rglru, attn) + 2 rglru
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),
    local_window=2048,
    lru_width=4096,
    mlp_type="gelu",
    source="arXiv:2402.19427 (unverified)",
)
