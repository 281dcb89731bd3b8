"""Building blocks: the small-CNN head behind an FPCA frontend, and the
language-model layers.

Plain functions on tensors, parameters in dicts.  Layouts are the
reference's: NHWC activations, ``(c_out, k, k, c_in)`` conv kernels and
``(d_in, d_out)`` dense weights.  The CNN half is float32; convolutions run
with TF32 off, so "f32" means IEEE f32 on the card as on the host.  The LM
half computes in the config's dtype (bf16 at full width), with norms, RoPE
and logits in f32.  Its init functions draw on ``device`` from
``generator``, which must live on that device, in the requested dtype: a
full-width model is drawn on the card without a host round trip.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

__all__ = [
    "init_conv2d",
    "conv2d",
    "init_linear",
    "linear",
    "max_pool2d",
    "avg_pool2d",
    "torch_dtype",
    "init_rms_norm",
    "rms_norm",
    "init_dense",
    "dense",
    "init_swiglu",
    "swiglu",
    "init_mlp",
    "mlp",
    "gelu",
    "require_ieee_f32",
    "init_embedding",
    "embed",
    "unembed",
    "rope",
    "cross_entropy_loss",
]


def init_conv2d(
    c_in: int,
    c_out: int,
    kernel: int,
    *,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Biased conv params: ``w`` is ``(c_out, k, k, c_in)``.  ``generator``
    is a CPU generator; the draws are moved to ``device`` (the card by
    default)."""
    fan_in = kernel * kernel * c_in
    w = torch.randn((c_out, kernel, kernel, c_in), generator=generator) * fan_in**-0.5
    dev = resolve_device(device)
    return {"w": w.to(dev), "b": torch.zeros(c_out, device=dev)}


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding: output ceil(size / stride), extra pixel at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(params: dict, x: torch.Tensor, stride: int = 1, padding: str = "VALID") -> torch.Tensor:
    """NHWC convolution with bias; ``padding`` is ``"VALID"`` or ``"SAME"``."""
    w = params["w"]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        k = w.shape[1]
        (ht, hb), (wl, wr) = _same_pads(x.shape[1], k, stride), _same_pads(x.shape[2], k, stride)
        xc = F.pad(xc, (wl, wr, ht, hb))
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled, benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic, allow_tf32=False,
    ):
        out = F.conv2d(xc, w.permute(0, 3, 1, 2), stride=stride)
    return out.permute(0, 2, 3, 1) + params["b"]


def init_linear(
    d_in: int,
    d_out: int,
    *,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Biased dense params: ``w`` is ``(d_in, d_out)``."""
    w = torch.randn((d_in, d_out), generator=generator) * d_in**-0.5
    dev = resolve_device(device)
    return {"w": w.to(dev), "b": torch.zeros(d_out, device=dev)}


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def max_pool2d(x: torch.Tensor, size: int, stride: int | None = None) -> torch.Tensor:
    s = size if stride is None else stride
    return F.max_pool2d(x.permute(0, 3, 1, 2), size, s).permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, size: int, stride: int | None = None) -> torch.Tensor:
    s = size if stride is None else stride
    return F.avg_pool2d(x.permute(0, 3, 1, 2), size, s).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Language-model layers.  ``lead`` prepends stacking axes to every parameter
# (layers drawn in one call, as the reference vmaps its inits).
# ---------------------------------------------------------------------------


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a config's dtype string)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _normal(shape: tuple, scale: float, dtype: torch.dtype, generator, device) -> torch.Tensor:
    dev = resolve_device(device)
    return torch.randn(shape, generator=generator, device=dev, dtype=dtype).mul_(scale)


def init_rms_norm(
    d: int, *, lead: tuple = (), device: str | torch.device | None = None
) -> dict:
    return {"scale": torch.ones(lead + (d,), device=resolve_device(device))}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in f32, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def init_dense(
    d_in: int,
    d_out: int,
    *,
    dtype: torch.dtype = torch.bfloat16,
    lead: tuple = (),
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Bias-free dense params: ``w`` is ``(d_in, d_out)``."""
    return {"w": _normal(lead + (d_in, d_out), d_in**-0.5, dtype, generator, device)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]


def init_swiglu(
    d: int,
    d_ff: int,
    *,
    dtype: torch.dtype = torch.bfloat16,
    lead: tuple = (),
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    kw = dict(dtype=dtype, lead=lead, generator=generator, device=device)
    return {
        "gate": init_dense(d, d_ff, **kw),
        "up": init_dense(d, d_ff, **kw),
        "down": init_dense(d_ff, d, **kw),
    }


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    return dense(params["down"], F.silu(dense(params["gate"], x)) * dense(params["up"], x))


def init_mlp(
    d: int,
    d_ff: int,
    *,
    dtype: torch.dtype = torch.bfloat16,
    lead: tuple = (),
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Plain GELU MLP (the Seamless enc-dec backbone)."""
    kw = dict(dtype=dtype, lead=lead, generator=generator, device=device)
    return {"up": init_dense(d, d_ff, **kw), "down": init_dense(d_ff, d, **kw)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default is
    the erf form)."""
    return F.gelu(x, approximate="tanh")


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    return dense(params["down"], gelu(dense(params["up"], x)))


def require_ieee_f32() -> None:
    """Raise unless f32 matmuls run in IEEE f32 (PyTorch's default,
    ``torch.get_float32_matmul_precision() == "highest"``): the moe router
    picks its top-k from f32 logits, and TF32 would move its choices."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("f32 matmuls must run in IEEE f32: torch.get_float32_matmul_precision() is "
                           f"{torch.get_float32_matmul_precision()!r}, not 'highest'")


def init_embedding(
    vocab: int,
    d: int,
    *,
    dtype: torch.dtype = torch.bfloat16,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    return {"table": _normal((vocab, d), 0.02, dtype, generator, device)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32."""
    return (x @ params["table"].T.to(x.dtype)).float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding, computed in f32 and cast back.  x: (..., S, H, D),
    positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean token cross-entropy in f32.  logits (..., V), labels (...) int.

    The gold logit is gathered (the reference sums a one-hot product, which
    is the same value; a ``(..., V)`` one-hot would not fit at V = 151936)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
