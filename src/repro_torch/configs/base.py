"""Language-model configuration schema (the port's own copy of the
reference's ``configs/base.py``).

Each architecture module exports ``CONFIG``, the published configuration;
``repro_torch.configs.ARCHS`` maps ``--arch`` ids to the ones the port
serves.  :func:`reduce_for_smoke` gives a narrow same-family variant for
host tests.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "reduce_for_smoke"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0               # 0 -> d_model // n_heads
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_renormalize: bool = True

    # --- attention details ---------------------------------------------------
    qk_norm: bool = False
    window: int | None = None       # sliding-window attention (tokens)
    rope_theta: float = 1e4
    attn_block_k: int = 512         # the reference's flash KV-block size (the port's kernel tiles by 64)
    moe_capacity_factor: float = 1.25
    logits_vocab_shard: bool = True
    moe_local_dispatch: bool = False

    # --- SSM (Mamba2) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # --- hybrid (Zamba2): shared attention block every k SSM layers -----------
    hybrid_attn_period: int = 0

    # --- encoder-decoder (Seamless) -------------------------------------------
    n_enc_layers: int = 0

    # --- modality frontend stub (audio frames / vision patches) ---------------
    frontend: str | None = None     # 'audio' | 'vision'
    frontend_dim: int = 0
    frontend_tokens: int = 0

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def has_decode(self) -> bool:
        return True  # every config here is decoder-bearing (enc-dec included)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: the top-k routed experts and
        the shared ones): the N in 6*N*D (train) / 2*N*D (inference)."""
        if self.family != "moe":
            return self.param_count()
        return dataclasses.replace(self, n_experts=self.top_k).param_count()

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks)."""
        d = self.d_model
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            return d * self.head_dim * (2 * self.n_heads + 2 * self.n_kv_heads)

        def mlp_params(ff: int, gated: bool = True) -> int:
            return d * ff * (3 if gated else 2)

        def moe_params() -> int:
            p = d * self.n_experts + self.n_experts * mlp_params(self.moe_d_ff)
            if self.n_shared_experts:
                p += mlp_params(self.n_shared_experts * self.moe_d_ff) + d
            return p

        def mamba_params() -> int:
            d_inner = self.ssm_expand * d
            gn = self.ssm_groups * self.ssm_state
            nh = d_inner // self.ssm_head_dim
            in_dim = 2 * d_inner + 2 * gn + nh
            conv_dim = d_inner + 2 * gn
            return d * in_dim + self.ssm_conv * conv_dim + d_inner * d + 3 * nh + d_inner

        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn_params() + mlp_params(self.d_ff))
            if self.family == "vlm":
                total += self.frontend_dim * d + d * d
        elif self.family == "moe":
            total += self.n_layers * (attn_params() + moe_params())
        elif self.family == "ssm":
            total += self.n_layers * mamba_params()
        elif self.family == "hybrid":
            total += self.n_layers * mamba_params()
            total += attn_params() + mlp_params(self.d_ff)  # one shared block
        elif self.family == "encdec":
            enc_layer = attn_params() + mlp_params(self.d_ff, gated=False)
            dec_layer = 2 * attn_params() + mlp_params(self.d_ff, gated=False)
            total += self.n_enc_layers * enc_layer + self.n_layers * dec_layer
            if self.frontend:
                total += self.frontend_dim * d
        return total


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md §4)"
    return True, ""


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: a forward pass on the host in seconds."""
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.family != "hybrid" else 3),
        d_model=64,
        vocab_size=256,
        dtype="float32",
    )
    if cfg.n_heads:
        changes.update(n_heads=4, n_kv_heads=2, head_dim=16)
    if cfg.d_ff:
        changes.update(d_ff=128)
    if cfg.n_experts:
        changes.update(n_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=32)
    if cfg.n_shared_experts:
        changes.update(n_shared_experts=2)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.hybrid_attn_period:
        changes.update(hybrid_attn_period=2)
    if cfg.n_enc_layers:
        changes.update(n_enc_layers=2)
    if cfg.frontend_dim:
        changes.update(frontend_dim=32)
    if cfg.frontend_tokens:
        changes.update(frontend_tokens=4)
    if cfg.window:
        changes.update(window=32)
    return dataclasses.replace(cfg, **changes)
