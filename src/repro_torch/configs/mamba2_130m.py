"""mamba2-130m — attention-free SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768 vocab=50280, ssm_state=128, head_dim=64, expand=2.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,       # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,          # pure Mamba blocks, no MLP
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    tie_embeddings=True,
)
