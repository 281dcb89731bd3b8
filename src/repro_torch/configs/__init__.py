"""Model configurations the port runs.

``fpca_cnn`` is the FPCA camera model; ``ARCHS`` maps ``--arch`` ids to the
reference's ten language-model configurations, one family each or more:
the moe granite-moe-3b-a800m and qwen2-moe-a2.7b (shared experts), the
encdec seamless-m4t-medium, the vlm internvl2-76b, the dense
h2o-danube-1.8b (sliding window 4096), phi3-medium-14b, qwen3-1.7b and
yi-9b, the hybrid zamba2-7b and the ssm mamba2-2.7b.
"""

from repro_torch.configs import (
    granite_moe_3b_a800m,
    h2o_danube_1_8b,
    internvl2_76b,
    mamba2_2_7b,
    phi3_medium_14b,
    qwen2_moe_a2_7b,
    qwen3_1_7b,
    seamless_m4t_medium,
    yi_9b,
    zamba2_7b,
)
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        granite_moe_3b_a800m,
        qwen2_moe_a2_7b,
        seamless_m4t_medium,
        internvl2_76b,
        h2o_danube_1_8b,
        phi3_medium_14b,
        qwen3_1_7b,
        yi_9b,
        zamba2_7b,
        mamba2_2_7b,
    )
}

__all__ = ["ARCHS", "ModelConfig", "reduce_for_smoke"]
