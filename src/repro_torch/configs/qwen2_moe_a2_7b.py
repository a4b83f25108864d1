"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) d_ff=1408,
MoE 60 routed top-4 + 4 shared experts, vocab 151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,            # shared-expert hidden (4x routed intermediate)
    vocab_size=151936,
    n_experts=60,
    experts_per_token=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
