"""The port's flash-attention backward against the reference's, on the host.

Inputs are made with numpy from a seed and handed to both sides.  The CUDA
dQ and dK/dV kernels do not run here: on CPU tensors their wrappers take
the plain version, ``flash_attention_bwd_ref`` (a port of the reference's
custom_vjp backward ``_flash_bwd``), which these tests hold against the
reference; the kernels are held against it on the card
(tests/test_torch_gpu.py).

Tolerances, normwise: max|got - want| <= tol * max|want| per output.
- float32: 1e-5 (f32 sums over up to 200 keys and queries, and exp, taken
  in another order or by another library's routine).
- bfloat16: two bf16 ulps of max|want| (both sides compute in f32 and
  round each gradient once to bf16, so an element may land one ulp away).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.bwd_kernel import flash_attention_bwd_pallas
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_ref,
    flash_attention_dkdv_cuda,
    flash_attention_dq_cuda,
)
from repro_torch.kernels.flash_attention.bwd import design
from repro_torch.kernels.flash_attention.kernel import design as fwd_design
from repro_torch.kernels.flash_attention.bwd_ref import attention_delta
from repro_torch.models import attention as pattn

F32 = 1e-5

# the reference kernel tests' backward grid (tests/test_kernels_attention_ssd.py)
GRID = [
    (1, 192, 4, 4, 32, True, None),    # MHA causal
    (2, 160, 4, 2, 32, True, None),    # GQA (group sum)
    (1, 128, 4, 1, 64, False, None),   # MQA bidirectional
    (1, 200, 2, 2, 32, True, 48),      # sliding window, ragged
]


def _inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), np.float32),
            rng.standard_normal((b, s, kv, d), np.float32),
            rng.standard_normal((b, s, kv, d), np.float32),
            rng.standard_normal((b, s, h, d), np.float32))


def _normwise(got: torch.Tensor, want, tol: float, name: str) -> None:
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), f"{name}: max|diff| {err:.3e}, max|want| {np.abs(want).max():.3e}"


def _bf16_ulps(want, n: int = 2) -> float:
    """``n`` bf16 ulps of max|want|, as a fraction of max|want|."""
    m = float(np.abs(np.asarray(want, np.float32)).max())
    return n * 2.0 ** (np.floor(np.log2(m)) - 7) / m


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", GRID)
def test_plain_backward_matches_jax_grad(b, s, h, kv, d, causal, window):
    """The port's forward (with LSE) and plain backward vs ``jax.vjp`` of
    the reference's ``attend_blockwise`` (its custom_vjp), float32."""
    q, k, v, g = _inputs(b, s, h, kv, d, seed=s + d)
    _, vjp = jax.vjp(lambda q, k, v: jattn.attend_blockwise(q, k, v, causal=causal, window=window),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = pattn.attend_blockwise(tq, tk, tv, causal=causal, window=window, return_lse=True)
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, causal=causal, window=window)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == w.shape and x.dtype == torch.float32
        _normwise(x, w, F32, name)
    # the kernels' entry points on CPU tensors are the plain version
    for x, y in zip(flash_attention_bwd_cuda(tq, tk, tv, out, lse, tg, causal=causal, window=window), got):
        assert torch.equal(x, y)
    delta = attention_delta(out, tg)
    assert torch.equal(flash_attention_dq_cuda(tq, tk, tv, tg, lse, delta, causal=causal, window=window), got[0])
    dk, dv = flash_attention_dkdv_cuda(tq, tk, tv, tg, lse, delta, causal=causal, window=window)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", GRID)
def test_forward_lse_matches_the_reference(b, s, h, kv, d, causal, window):
    q, k, v, _ = _inputs(b, s, h, kv, d, seed=1)
    out_j, lse_j = jattn._flash_fwd_impl(*map(jnp.asarray, (q, k, v)), causal, window, 64)
    out, lse = pattn.attend_blockwise(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
                                      block_k=64, return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    _normwise(lse, np.asarray(lse_j).reshape(b, h, s), F32, "lse")
    _normwise(out, out_j, F32, "out")


def test_plain_backward_bf16_matches_the_reference_vjp():
    """bf16 inputs, the same residuals (q, k, v, out, lse) and dO on both
    sides, through the reference's ``_flash_bwd`` directly."""
    b, s, h, kv, d, causal, window = GRID[1]
    q, k, v, g = (jnp.asarray(a, jnp.bfloat16) for a in _inputs(b, s, h, kv, d, seed=5))
    out, lse = jattn._flash_fwd_impl(q, k, v, causal, window, 512)
    want = jattn._flash_bwd(causal, window, 512, (q, k, v, out, lse), g)
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in (q, k, v, out, g)]
    tlse = torch.from_numpy(np.array(lse)).reshape(b, h, s)
    got = flash_attention_bwd_ref(t[0], t[1], t[2], t[3], tlse, t[4], causal=causal, window=window)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.bfloat16
        _normwise(x, np.asarray(w, np.float32), _bf16_ulps(np.asarray(w, np.float32)), name)


def test_plain_backward_matches_the_pallas_kernels_in_interpret_mode():
    """One GQA case against the TPU kernels themselves (interpret mode, a
    few seconds)."""
    b, s, h, kv, d, causal, window = 1, 96, 4, 2, 32, True, None
    q, k, v, g = _inputs(b, s, h, kv, d, seed=7)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = jattn._flash_fwd_impl(jq, jk, jv, causal, window, 32)
    want = flash_attention_bwd_pallas(jq, jk, jv, out, lse, jg, causal=causal, window=window,
                                      block_q=32, block_k=32, interpret=True)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, out, g)]
    got = flash_attention_bwd_ref(t[0], t[1], t[2], t[3], torch.from_numpy(np.array(lse)).reshape(b, h, s),
                                  t[4], causal=causal, window=window)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        _normwise(x, w, F32, name)


def test_flash_attention_function_gradcheck_f64():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
               for shape in ((1, 10, 4, 8), (1, 10, 2, 8), (1, 10, 2, 8)))
    for causal, window in ((True, None), (False, 4), (True, 3)):
        assert torch.autograd.gradcheck(lambda q, k, v: pattn.FlashAttention.apply(q, k, v, causal, window),
                                        (q, k, v))


def test_flash_attention_takes_the_function_only_when_a_gradient_is_needed():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 24, 4, 2, 16, seed=9))
    plain = pattn.flash_attention(q, k, v, causal=True)
    assert plain.grad_fn is None and torch.allclose(plain, pattn.attend_full(q, k, v), atol=1e-6)
    q.requires_grad_()
    out = pattn.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert pattn.flash_attention(q, k, v, causal=True).grad_fn is None


# ---------------------------------------------------------------------------
# the numerics of the tensor-core kernels, emulated on the host
# ---------------------------------------------------------------------------


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> its bf16 hi and lo parts (``x_lo = bf16(x - x_hi)``), as f32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _tensor_core_bwd(q, k, v, do, lse, delta, causal, window, split: bool):
    """What the wgmma kernels compute, in f64 so that only the split
    differs between ``split=True`` and ``split=False``: s and dp from the
    bf16 operands (each product exact), p and ds formed in f32 in the
    reference's order, then the three accumulations from p and ds either
    split into bf16 hi + lo parts or whole.  Returns unrounded
    (dq, dk, dv)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G, scale = H // KV, D**-0.5
    qg, dog = (t.double().reshape(B, S, KV, G, D) for t in (q, do))
    kd, vd = k.double(), v.double()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kd).float()
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vd).float()
    pos = torch.arange(S)
    live = torch.ones((S, S), dtype=torch.bool)
    if causal:
        live &= pos[:, None] >= pos[None, :]
    if window is not None:
        live &= pos[:, None] - pos[None, :] < window
    sv = torch.where(live, s * scale, torch.tensor(pattn.NEG_INF))
    p = torch.exp(sv - lse.reshape(B, KV, G, S, 1))
    ds = p * (dp - delta.reshape(B, KV, G, S, 1)) * scale
    parts = (lambda x: _split(x)) if split else (lambda x: (x, torch.zeros_like(x)))
    (p_hi, p_lo), (ds_hi, ds_lo) = parts(p), parts(ds)
    dq = sum(torch.einsum("bhgqk,bkhd->bqhgd", x.double(), kd) for x in (ds_hi, ds_lo))
    dk = sum(torch.einsum("bhgqk,bqhgd->bkhd", x.double(), qg) for x in (ds_hi, ds_lo))
    dv = sum(torch.einsum("bhgqk,bqhgd->bkhd", x.double(), dog) for x in (p_hi, p_lo))
    return dq.reshape(B, S, H, D), dk, dv


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", GRID + [(1, 96, 8, 2, 64, True, 40)])
def test_split_bf16_products_keep_the_reference_function(b, s, h, kv, d, causal, window):
    """The tensor-core kernels' numerics (bf16 s and dp, p and ds split into
    bf16 hi + lo for the accumulations) hold the two-bf16-ulp agreement
    with the plain backward, and the split alone moves the unrounded
    gradients by at most 2**-16 of max|value|."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(b, s, h, kv, d, seed=s + d))
    out, lse = pattn.attend_blockwise(q, k, v, causal=causal, window=window, return_lse=True)
    delta = attention_delta(out, do)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window)
    got = _tensor_core_bwd(q, k, v, do, lse, delta, causal, window, split=True)
    whole = _tensor_core_bwd(q, k, v, do, lse, delta, causal, window, split=False)
    for name, x, w, x_whole in zip(("dq", "dk", "dv"), got, want, whole):
        top = float(x_whole.abs().max())
        assert float((x - x_whole).abs().max()) <= 2.0**-16 * top, name
        rounded = x.to(torch.bfloat16)
        assert rounded.dtype == w.dtype == torch.bfloat16
        _normwise(rounded, w.float().numpy(), _bf16_ulps(w.float().numpy()), name)


def _design_case(dtype, d, offset):
    base = torch.zeros(2 * 16 * 4 * d + offset, dtype=dtype)
    q = base[offset:offset + 2 * 16 * 4 * d].view(2, 16, 4, d)
    k = torch.zeros((2, 16, 2, d), dtype=dtype)
    return q, k, k.clone(), torch.zeros_like(q)


@pytest.mark.parametrize("dtype,d,offset,want", [
    (torch.bfloat16, 128, 0, "wgmma"),
    (torch.bfloat16, 96, 0, "wgmma"),
    (torch.bfloat16, 40, 0, "simt"),     # D % 16 != 0
    (torch.float32, 128, 0, "simt"),
    (torch.float16, 64, 0, "simt"),
    (torch.bfloat16, 64, 1, "simt"),     # q's rows not 16-byte aligned
    (torch.bfloat16, 112, 0, "wgmma"),   # the served head dim (padded to 128 on the card)
    (torch.bfloat16, 64, 0, "wgmma"),
    (torch.bfloat16, 16, 0, "wgmma"),
    (torch.bfloat16, 112, 8, "wgmma"),   # an offset of 16 bytes keeps the rows aligned
    (torch.bfloat16, 128, 4, "simt"),    # 8 bytes does not
    (torch.float32, 64, 0, "simt"),
])
def test_backward_design_choice(dtype, d, offset, want):
    """The wrappers' dispatch rule, decided from the inputs before a launch:
    the backward's on (q, k, v, dO), the forward's (the same rule, in
    ``kernel.py``) on (q, k, v)."""
    q, k, v, do = _design_case(dtype, d, offset)
    assert design(q, k, v, do) == want
    assert fwd_design(q, k, v) == want
    # a misaligned k or v alone sends both to the SIMT design
    if want == "wgmma":
        odd = torch.zeros(k.numel() + 1, dtype=dtype)[1:].view(k.shape)
        assert design(q, odd, v, do) == fwd_design(q, k, odd) == "simt"
