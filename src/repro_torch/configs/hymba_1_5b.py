"""hymba-1.5b — hybrid parallel attention+Mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hymba runs attention heads and SSM heads in parallel on the same input and
fuses their (normalized) outputs; most layers use SWA (window 1024).
Meta-tokens are omitted (stub note: DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    window=1024,          # SWA layers (hybrid decode stays O(1)/O(w))
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
)
