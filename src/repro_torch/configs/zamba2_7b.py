"""zamba2-7b — Zyphra Zamba2 (Mamba2 backbone + shared attention blocks).

81 Mamba2 layers, d_model=3584, ssm_state=64; one *shared* attention+MLP
block (32H, kv=32, d_ff=14336) applied every 6 SSM layers (weights reused
across applications — the Zamba2 trick). vocab 32000.
[arXiv:2411.15242; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    hybrid_attn_period=6,
)
