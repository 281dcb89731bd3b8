"""The FPCA compile/execute API on PyTorch::

    from repro_torch import fpca

    fe = fpca.compile(fpca.FPCAProgram(spec=fpca.FPCASpec(...)), weights=kernel)
    counts = fe.run(frames)                       # CUDA kernel on the card

    model = fpca.build_model({"arch": "fpca_detect"})   # the model zoo
    m = fpca.compile(model, weights=kernel, head_params=model.init_head(gen))
    det = m.run(frames)                           # Detections (scores, boxes)

    seg = m.run_segment(video[:32])               # 32 gated ticks, one CUDA graph
    seg = m.run_segment(video[32:64], state=seg.state)
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
from repro_torch.fpca.executable import (
    CompiledFrontend,
    CompiledModel,
    FrontendStats,
    SegmentResult,
    SegmentState,
    compile,
)
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
    ProgrammedModel,
    spec_signature,
)
from repro_torch.models.heads import AddSpec, ConcatSpec, DetectSpec, Detections, HeadGraph, Node
from repro_torch.models.quant import calibrate_head_scales, logit_parity, quantize_head_params
from repro_torch.fpca.zoo import available_archs, build_model, register_arch

__all__ = [
    "ADCConfig",
    "ActivationSpec",
    "AddSpec",
    "Backend",
    "CacheInfo",
    "CacheInfoVerbose",
    "CircuitParams",
    "CompiledFrontend",
    "CompiledModel",
    "ConcatSpec",
    "ConvSpec",
    "DeltaGateConfig",
    "DenseSpec",
    "DetectSpec",
    "Detections",
    "ExecutableCache",
    "FPCAModelProgram",
    "FPCAProgram",
    "FPCASpec",
    "FrontendStats",
    "GateControllerConfig",
    "HeadGraph",
    "Node",
    "PoolSpec",
    "ProgrammedConfig",
    "ProgrammedModel",
    "SegmentResult",
    "SegmentState",
    "WeightEncoding",
    "available_archs",
    "available_backends",
    "build_model",
    "calibrate_head_scales",
    "compile",
    "default_backend_name",
    "get_backend",
    "logit_parity",
    "quantize_head_params",
    "register_arch",
    "register_backend",
    "spec_signature",
]
