"""The numerics of the SSD intra-chunk kernel's tensor-core design, on the host.

The CUDA kernel does not run here (tests/test_torch_gpu.py holds it against
its plain version on the card).  Hopper's tensor cores take no IEEE f32, so
the design splits every f32 operand into bf16 parts and sums the products of
the parts in f32 accumulators.  These tests emulate that, tile by tile as
``ssd_tc_kernel`` walks a chunk, and hold it against three references on the
same numpy-seeded inputs: the port's plain ``ssd_intra_chunk_ref``, the
reference's JAX ``repro.models.ssm.ssd_intra_chunk`` and the TPU kernel
itself (``ssd_intra_chunk_pallas`` in interpret mode, at one small shape).

The walk: two row blocks of 64 chunk rows; rows [0, 64) take cb over keys
[0, 64) only, rows [64, 128) over all 128 (the causal half is the only live
work); cb ∘ L is split in registers and multiplies xbar in 64-key halves;
the state is (B ∘ dec)ᵀ xbar, B rebuilt exactly from its staged parts, over
two 64-key halves.  Every product is one pass per pair of parts, 16
reduction terms a step, each step's exact sum rounded into the f32
accumulator.  (The kernel takes L from the hardware's exp2, ``__expf``;
the emulation uses ``exp``: the card tests hold that difference.)

The limit is the port's SSD limit, max|diff| <= 2e-5 of max|value|
(ROADMAP C; ``SSD_NORMWISE`` in chip_smoke.py).  A split is adopted only if
it holds half of that on the whole grid (the margin).  The candidates:

- ``bf16x6``, adopted: three parts and the six products down to order
  2**-16 relative.  The kernel takes the parts by truncation (hi = x's top
  16 bits, mid = the top 16 bits of x - hi, lo = the rest, exactly a bf16):
  masks and subtractions, no conversion instruction; hi + mid + lo = x;
- ``bf16x3``: hi and lo rounded to nearest, and hi·hi + hi·lo + lo·hi
  (about 2**-17): within the limit but not within the margin on this grid,
  so rejected;
- ``bf16x1``: one rounded, unsplit pass (the control), which breaks the
  limit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_intra_chunk_pallas
from repro.models import ssm as jssm
from repro_torch.kernels.ssd.kernel import design
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

LIMIT = 2e-5
MARGIN = LIMIT / 2
ROWS = 64    # chunk rows per warpgroup, keys per half
KSTEP = 16   # reduction terms per wgmma step

# (part count, pairs of parts multiplied, how the parts are taken), pairs
# in the kernel's pass order
SPLITS = {
    "bf16x6": (3, ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1)), "truncate"),
    "bf16x3": (2, ((0, 0), (0, 1), (1, 0)), "round"),
    "bf16x1": (1, ((0, 0),), "round"),
}

# (b, nc, q, h, p, n, decay per step): the served chunk and widths, the wide
# state of mamba2-2.7b, and a ragged one (zero padding adds exact zeros)
GRID = [
    (1, 2, 128, 4, 64, 64, 1.0),
    (1, 2, 128, 4, 64, 64, 0.01),
    (1, 1, 128, 4, 64, 128, 1.0),
    (1, 2, 100, 3, 48, 40, 0.1),
]


def _parts(x: torch.Tensor, k: int, how: str) -> list[torch.Tensor]:
    """f32 -> its k bf16 parts, as f32: each the bf16 rounding (``round``)
    or the top 16 bits (``truncate``) of what the earlier parts leave."""
    out, rest = [], x
    for _ in range(k):
        if how == "round":
            part = rest.bfloat16().float()
        else:
            part = (rest.view(torch.int32) & -65536).view(torch.float32)
        out.append(part)
        rest = rest - part
    return out


def _mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, split: str) -> torch.Tensor:
    """acc (..., M, N) f32 += a (..., M, K) @ b (..., K, N) as the kernel's
    passes: one per pair of parts, 16-term steps, each step's exact sum
    rounded into the f32 accumulator."""
    k, pairs, how = SPLITS[split]
    pa, pb = _parts(a, k, how), _parts(b, k, how)
    for u, v in pairs:
        for k0 in range(0, a.shape[-1], KSTEP):
            step = pa[u][..., k0 : k0 + KSTEP].double() @ pb[v][..., k0 : k0 + KSTEP, :].double()
            acc = acc + step.float()
    return acc


def _tensor_core_ssd(xbar, Bh, Ch, cum, split: str):
    """What the tensor-core design computes, walked as the kernel walks a
    chunk.  Returns (y (b,nc,q,h,p), states (b,nc,h,p,n)) in f32."""
    b, nc, q, h, p = xbar.shape
    n = Bh.shape[-1]
    X, B, C = (t.permute(0, 1, 3, 2, 4) for t in (xbar, Bh, Ch))   # (b,nc,h,q,.)
    c = cum.permute(0, 1, 3, 2)                                    # (b,nc,h,q)
    y = torch.zeros((b, nc, h, q, p))
    for r0 in range(0, q, ROWS):                                   # a warpgroup's rows
        r1 = min(r0 + ROWS, q)
        cb = _mma(torch.zeros((b, nc, h, r1 - r0, r1)), C[..., r0:r1, :], B[..., :r1, :].transpose(-1, -2), split)
        rows, cols = torch.arange(r0, r1)[:, None], torch.arange(r1)[None, :]
        seg = c[..., r0:r1, None] - c[..., None, :r1]
        pm = torch.where(cols <= rows, cb * torch.exp(torch.where(cols <= rows, seg, 0.0)), 0.0)
        for k0 in range(0, r1, ROWS):                              # 64-key halves
            k1 = min(k0 + ROWS, r1)
            y[..., r0:r1, :] = _mma(y[..., r0:r1, :], pm[..., k0:k1], X[..., k0:k1, :], split)
    # the state: A = (B ∘ dec)ᵀ from B's staged parts (their sum is B exactly)
    dec = torch.exp(c[..., -1:] - c)
    B_staged = sum(_parts(B, *SPLITS[split][::2]))
    A = (B_staged * dec[..., None]).transpose(-1, -2)              # (b,nc,h,n,q)
    st = torch.zeros((b, nc, h, n, p))
    for k0 in range(0, q, ROWS):
        st = _mma(st, A[..., k0 : k0 + ROWS], X[..., k0 : k0 + ROWS, :], split)
    return y.permute(0, 1, 3, 2, 4), st.transpose(-1, -2)


def _inputs(b, nc, q, h, p, n, rate, seed):
    rng = np.random.default_rng(seed)
    xbar = rng.standard_normal((b, nc, q, h, p), np.float32)
    Bh = rng.standard_normal((b, nc, q, h, n), np.float32)
    Ch = rng.standard_normal((b, nc, q, h, n), np.float32)
    steps = rate * np.log1p(np.exp(rng.standard_normal((b, nc, q, h))))
    return xbar, Bh, Ch, (-np.cumsum(steps, axis=2)).astype(np.float32)


def _normwise(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want, np.float32))
    return float((got - want).abs().max()) / float(want.abs().max())


def _case(b, nc, q, h, p, n, rate):
    return _inputs(b, nc, q, h, p, n, rate, seed=q + p + n)


@pytest.mark.parametrize("b,nc,q,h,p,n,rate", GRID)
def test_bf16x6_split_keeps_the_reference_function(b, nc, q, h, p, n, rate):
    args = _case(b, nc, q, h, p, n, rate)
    y, st = _tensor_core_ssd(*map(torch.from_numpy, args), "bf16x6")
    # the port's plain version
    y_p, st_p, _ = ssd_intra_chunk_ref(*map(torch.from_numpy, args))
    assert _normwise(y, y_p) <= MARGIN and _normwise(st, st_p) <= MARGIN
    # the reference's JAX function
    y_j, st_j, _ = jssm.ssd_intra_chunk(*map(jnp.asarray, args))
    assert _normwise(y, y_j) <= MARGIN and _normwise(st, st_j) <= MARGIN


def test_bf16x6_split_matches_the_pallas_kernel_in_interpret_mode():
    args = _inputs(1, 2, 128, 2, 64, 64, 1.0, seed=5)
    y, st = _tensor_core_ssd(*map(torch.from_numpy, args), "bf16x6")
    y_k, st_k = ssd_intra_chunk_pallas(*map(jnp.asarray, args), interpret=True)
    assert _normwise(y, y_k) <= MARGIN
    assert _normwise(st, np.asarray(st_k).transpose(0, 1, 2, 4, 3)) <= MARGIN   # kernel states are (N, P)-major


def test_bf16x3_split_misses_the_margin():
    """bf16 hi + lo (three passes, parts rounded to nearest) was the cheaper
    candidate: within the limit on this grid, but past half of it on the
    served widths, so it was not adopted."""
    worst = 0.0
    for case in GRID:
        args = _case(*case)
        y, st = _tensor_core_ssd(*map(torch.from_numpy, args), "bf16x3")
        y_p, st_p, _ = ssd_intra_chunk_ref(*map(torch.from_numpy, args))
        worst = max(worst, _normwise(y, y_p), _normwise(st, st_p))
    assert MARGIN < worst <= LIMIT


@pytest.mark.parametrize("b,nc,q,h,p,n,rate", GRID)
def test_one_unsplit_pass_breaks_the_limit(b, nc, q, h, p, n, rate):
    """The control: a kernel that rounded every f32 operand to bf16 once
    (one pass) would break the limit on every input of the grid."""
    args = _case(b, nc, q, h, p, n, rate)
    y, st = _tensor_core_ssd(*map(torch.from_numpy, args), "bf16x1")
    y_p, st_p, _ = ssd_intra_chunk_ref(*map(torch.from_numpy, args))
    assert _normwise(y, y_p) > LIMIT and _normwise(st, st_p) > LIMIT


def _design_case(q, p, n, cut):
    xbar = torch.zeros((1, 2, q, 4, p))
    B = torch.zeros((1, 2, q, 1, n + cut))[..., cut:].expand(1, 2, q, 4, n)
    return xbar, B, B


@pytest.mark.parametrize(
    "q,p,n,cut,chosen",
    [
        (128, 64, 64, 0, "wgmma"),    # the served chunk and widths, one group broadcast
        (128, 64, 128, 0, "wgmma"),   # the wide state
        (100, 64, 64, 0, "simt"),     # ragged chunk
        (128, 48, 64, 0, "simt"),     # other head width
        (128, 64, 40, 0, "simt"),     # other state width
        (128, 64, 64, 1, "simt"),     # B/C rows not 16-byte aligned
    ],
)
def test_design_takes_the_served_chunk_to_the_tensor_cores(q, p, n, cut, chosen):
    assert design(*_design_case(q, p, n, cut)) == chosen
