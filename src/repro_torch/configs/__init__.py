"""Model configurations the port runs.

``fpca_cnn`` is the FPCA camera model; ``ARCHS`` maps ``--arch`` ids to the
ported language-model configurations: zamba2-7b (serving) and qwen3-1.7b
(training).
"""

from repro_torch.configs import qwen3_1_7b, zamba2_7b
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in (zamba2_7b, qwen3_1_7b)}

__all__ = ["ARCHS", "ModelConfig", "reduce_for_smoke"]
