"""Model configurations the port runs.

``fpca_cnn`` is the FPCA camera model; ``ARCHS`` maps ``--arch`` ids to the
ported language-model configurations: zamba2-7b (hybrid, served) and the
dense decoders qwen3-1.7b (served and trained), h2o-danube-1.8b (sliding
window 4096), yi-9b and phi3-medium-14b (served).
"""

from repro_torch.configs import h2o_danube_1_8b, phi3_medium_14b, qwen3_1_7b, yi_9b, zamba2_7b
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (h2o_danube_1_8b, phi3_medium_14b, qwen3_1_7b, yi_9b, zamba2_7b)
}

__all__ = ["ARCHS", "ModelConfig", "reduce_for_smoke"]
