"""The paper's own workload: a small CNN with an FPCA first layer
(VWW-class visual wake-word classification, paper §1/§5).

``HEAD`` is the digital classifier behind the in-pixel layer; wrap frontend
and head with :func:`make_model_program` and compile the whole network with
``repro_torch.fpca.compile``.
"""

from repro_torch.core.mapping import FPCASpec
from repro_torch.fpca.program import DenseSpec, FPCAModelProgram, FPCAProgram

# 5x5x3 kernel, 8 output channels, stride 5 (the paper's energy sweet spot)
FRONTEND_SPEC = FPCASpec(image_h=120, image_w=120, out_channels=8, kernel=5, stride=5, max_kernel=5)
N_CLASSES = 2
N_HIDDEN = 64

# The digital classifier head: 4608 features -> Dense(64, relu) -> Dense(2).
HEAD = (DenseSpec(N_HIDDEN, activation="relu"), DenseSpec(N_CLASSES))

# The model-zoo config of the same network: ``build()`` (or
# ``repro_torch.fpca.zoo.build_model(CFG)``) makes a program with the same
# signature as make_model_program(), so both share every executable.
CFG = {
    "arch": "fpca_cnn",
    "spec": FRONTEND_SPEC,
    "hidden": N_HIDDEN,
    "n_classes": N_CLASSES,
    "input_scale": 1.0,
}


def build(cfg=None, **overrides) -> FPCAModelProgram:
    """Zoo-built twin of :func:`make_model_program` (defaults = ``CFG``)."""
    from repro_torch.fpca.zoo import build_model

    return build_model({**CFG, **(dict(cfg) if cfg else {})}, **overrides)


def make_model_program(
    spec: FPCASpec = FRONTEND_SPEC,
    *,
    head: tuple = HEAD,
    input_scale: float = 1.0,
    **frontend_kw,
) -> FPCAModelProgram:
    """The whole VWW-class network as one compileable model program.

    ``frontend_kw`` (circuit / adc / enc / gate / controller) configure the
    analog first layer; ``input_scale`` is the counts -> activation-unit
    gain a trained export bakes in.
    """
    return FPCAModelProgram(
        frontend=FPCAProgram(spec=spec, **frontend_kw), head=head, input_scale=input_scale
    )
