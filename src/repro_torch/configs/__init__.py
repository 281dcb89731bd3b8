"""Model configurations the port serves.

``fpca_cnn`` is the FPCA camera model; ``ARCHS`` maps ``--arch`` ids to the
language-model configurations whose serving path is ported.
"""

from repro_torch.configs import zamba2_7b
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in (zamba2_7b,)}

__all__ = ["ARCHS", "ModelConfig", "reduce_for_smoke"]
