"""mamba2-2.7b — Mamba2 (SSD, attention-free).

64L d_model=2560, ssm_state=128, expand=2 (d_inner=5120, 80 heads of 64),
vocab 50280. [arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    vocab_size=50280,
    ssm_state=128,
)
