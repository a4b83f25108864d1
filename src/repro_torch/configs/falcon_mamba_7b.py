"""falcon-mamba-7b [ssm]: 64L d_model=4096, attention-free mamba1,
vocab 65024, ssm_state=16.  [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    source="arXiv:2410.05355 (unverified)",
)
