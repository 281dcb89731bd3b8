"""The FPCA compile/execute API on PyTorch::

    from repro_torch import fpca

    fe = fpca.compile(fpca.FPCAProgram(spec=fpca.FPCASpec(...)), weights=kernel)
    counts = fe.run(frames)                       # CUDA kernel on the card
"""

from repro_torch.core.adc import ADCConfig
from repro_torch.core.device_models import CircuitParams
from repro_torch.core.fpca_sim import WeightEncoding
from repro_torch.core.mapping import FPCASpec
from repro_torch.fpca.backends import (
    Backend,
    available_backends,
    default_backend_name,
    get_backend,
    register_backend,
)
from repro_torch.fpca.cache import CacheInfo, CacheInfoVerbose, ExecutableCache
from repro_torch.fpca.executable import CompiledFrontend, CompiledModel, FrontendStats, compile
from repro_torch.fpca.program import (
    ActivationSpec,
    ConvSpec,
    DeltaGateConfig,
    DenseSpec,
    FPCAModelProgram,
    FPCAProgram,
    GateControllerConfig,
    PoolSpec,
    ProgrammedConfig,
    spec_signature,
)

__all__ = [
    "ADCConfig",
    "ActivationSpec",
    "Backend",
    "CacheInfo",
    "CacheInfoVerbose",
    "CircuitParams",
    "CompiledFrontend",
    "CompiledModel",
    "ConvSpec",
    "DeltaGateConfig",
    "DenseSpec",
    "ExecutableCache",
    "FPCAModelProgram",
    "FPCAProgram",
    "FPCASpec",
    "FrontendStats",
    "GateControllerConfig",
    "PoolSpec",
    "ProgrammedConfig",
    "WeightEncoding",
    "available_backends",
    "compile",
    "default_backend_name",
    "get_backend",
    "register_backend",
    "spec_signature",
]
