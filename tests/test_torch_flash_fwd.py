"""The numerics of the flash-attention forward's tensor-core design, on the host.

The CUDA kernel does not run here (tests/test_torch_gpu.py holds it against
its plain version on the card).  These tests emulate what its bf16 design
computes, tile by tile as ``flash_fwd_wgmma`` walks the keys, and hold that
against three references on the same numpy-seeded inputs: the port's plain
``attend_blockwise``, the reference's JAX forward
(``repro.models.attention._flash_fwd_impl``, the custom_vjp forward that
gives the LSE) and the TPU kernel itself (``flash_attention_pallas`` in
interpret mode).

Tolerances:
- the split of p into bf16 hi + lo moves the unrounded output by at most
  2**-16 of max|value| (p_hi + p_lo holds p to about 2**-17);
- rounded to bf16, the output is within one bf16 ulp elementwise (rtol
  2**-7, atol 1e-4) of the port's plain version and of the reference's JAX
  forward: all compute in f32 and round once, so two results a few f32 ulps
  apart may round to neighbours;
- unrounded, it is within the reference kernel tests' own 2e-3 of the
  Pallas kernel run in f32 on the same bf16 values;
- the LSE (f32) within 1e-5 of max|value|.
The control: with p rounded to bf16 and no lo part, the output breaks the
one-ulp limit on every input of the grid.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro_torch.models import attention as pattn

ONE_ULP = dict(rtol=2.0**-7, atol=1e-4)
LSE_TOL = 1e-5
TILE = 64   # keys per streamed tile, rows per warpgroup

# the backward emulation's grid (tests/test_torch_flash_bwd.py), plus the
# served head dim zero-padded to 128 and a GQA window with a ragged Sq
GRID = [
    (1, 192, 4, 4, 32, True, None),    # MHA causal
    (2, 160, 4, 2, 32, True, None),    # GQA
    (1, 128, 4, 1, 64, False, None),   # MQA bidirectional
    (1, 200, 2, 2, 32, True, 48),      # sliding window, ragged
    (1, 150, 4, 2, 112, True, None),   # D = 112, padded to 128; ragged
    (1, 190, 4, 2, 128, True, 70),     # D = 128, GQA, window, ragged
]


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> its bf16 hi and lo parts (``x_lo = bf16(x - x_hi)``), as f32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _tensor_core_fwd(q, k, v, causal, window, p_as: str):
    """What ``flash_fwd_wgmma`` computes: the head dim zero-padded to DP,
    64-key tiles (keys past Sk zero-filled and masked), s from the bf16
    operands in f64 and then f32, scale, mask and the online m / l / corr in
    f32 in the TPU kernel's order, p as the kernel takes it (``p_as``
    ``"split"``: bf16 hi + lo), whole (``"f32"``) or rounded to bf16 (``"bf16"``),
    and acc in f64 so that only p's form differs between them.  A
    warpgroup (64 query rows) skips a tile wholly masked for its rows.
    Returns the unrounded output (B, Sq, H, D) f64 and the LSE (B, H, Sq)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, D**-0.5
    DP = 64 if D <= 64 else 128
    n_k = -(-Sk // TILE) * TILE
    qg = torch.nn.functional.pad(q.double(), (0, DP - D)).reshape(B, Sq, KV, G, DP)
    kd, vd = (torch.nn.functional.pad(t.double(), (0, DP - D, 0, 0, 0, n_k - Sk)) for t in (k, v))
    m = torch.full((B, KV, G, Sq), pattn.NEG_INF)
    l = torch.zeros((B, KV, G, Sq))
    acc = torch.zeros((B, KV, G, Sq, DP), dtype=torch.float64)
    rows = torch.arange(Sq)
    r0 = rows - rows % TILE                            # the row's warpgroup
    r_last = torch.clamp(r0 + TILE - 1, max=Sq - 1)
    parts = {
        "split": _split,
        "f32": lambda x: (x, torch.zeros_like(x)),
        "bf16": lambda x: (x.bfloat16().float(), torch.zeros_like(x)),
    }[p_as]
    for k0 in range(0, n_k, TILE):
        run = torch.ones(Sq, dtype=torch.bool)
        if causal:
            run &= k0 <= r_last
        if window is not None:
            run &= k0 + TILE - 1 >= r0 - window + 1
        cols = torch.arange(k0, k0 + TILE)
        live = (cols < Sk)[None, :].expand(Sq, TILE)
        if causal:
            live = live & (rows[:, None] >= cols[None, :])
        if window is not None:
            live = live & (rows[:, None] - cols[None, :] < window)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kd[:, k0 : k0 + TILE]).float() * scale
        s = torch.where(live, s, torch.tensor(pattn.NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        hi, lo = parts(p)
        acc_new = acc * corr[..., None].double() + sum(
            torch.einsum("bhgqk,bkhd->bhgqd", x.double(), vd[:, k0 : k0 + TILE]) for x in (hi, lo))
        m, l = torch.where(run, m_new, m), torch.where(run, l_new, l)
        acc = torch.where(run[:, None], acc_new, acc)
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None].double()).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, DP)[..., :D]
    return out, (m + torch.log(l_safe)).reshape(B, H, Sq)


def _inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32)).bfloat16()
                 for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))


def _lse_close(got: torch.Tensor, want, name: str) -> None:
    want = torch.from_numpy(np.array(want, np.float32)).reshape(got.shape)
    err, top = float((got - want).abs().max()), float(want.abs().max())
    assert err <= LSE_TOL * top, f"{name}: max|diff| {err:.3e}, max|want| {top:.3e}"


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", GRID)
def test_split_bf16_forward_keeps_the_reference_function(b, s, h, kv, d, causal, window):
    q, k, v = _inputs(b, s, h, kv, d, seed=s + d)
    got, lse = _tensor_core_fwd(q, k, v, causal, window, p_as="split")
    whole, _ = _tensor_core_fwd(q, k, v, causal, window, p_as="f32")
    top = float(whole.abs().max())
    assert float((got - whole).abs().max()) <= 2.0**-16 * top
    rounded = got.to(torch.bfloat16).float()

    # the port's plain version
    plain, plain_lse = pattn.attend_blockwise(q, k, v, causal=causal, window=window, return_lse=True)
    assert plain.dtype == torch.bfloat16
    torch.testing.assert_close(rounded, plain.float(), **ONE_ULP)
    _lse_close(lse, plain_lse, "lse vs plain")

    # the reference's JAX forward, in bf16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    out_j, lse_j = jattn._flash_fwd_impl(jq, jk, jv, causal, window, 512)
    torch.testing.assert_close(rounded, torch.from_numpy(np.asarray(out_j, np.float32)), **ONE_ULP)
    _lse_close(lse, lse_j, "lse vs the JAX forward")

    # the TPU kernel, in f32 on the same bf16 values (its upcast is exact)
    pallas = flash_attention_pallas(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                                    causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", GRID)
def test_p_rounded_to_bf16_breaks_the_one_ulp_limit(b, s, h, kv, d, causal, window):
    """The control of the test above: a kernel that fed p . V with p rounded
    to bf16 (no lo part) would not hold one bf16 ulp of the plain version on
    any of these inputs, so that limit does tell the split from the plain
    rounding."""
    q, k, v = _inputs(b, s, h, kv, d, seed=s + d)
    rounded, _ = _tensor_core_fwd(q, k, v, causal, window, p_as="bf16")
    plain = pattn.attend_blockwise(q, k, v, causal=causal, window=window)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(rounded.to(torch.bfloat16).float(), plain.float(), **ONE_ULP)
