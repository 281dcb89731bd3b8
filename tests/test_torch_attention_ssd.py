"""The port's attention and SSD functions against the reference's, on the host.

Inputs are made with numpy from a seed and handed to both sides.  The CUDA
kernels do not run here: on CPU tensors their wrappers take the plain
versions these tests hold against the reference (the kernels themselves
are held against the plain versions on the card, tests/test_torch_gpu.py).

Tolerances:
- float32: 2e-5 for attention, 1e-4 for SSD — f32 sums (score rows, 128-term
  chunk contractions) and exp/softmax taken in another order or by another
  library's routine.
- bfloat16 attention: 2**-6 relative (two units in the last place of bf16)
  plus 1e-3: both sides round the probabilities and the output to bf16, so
  two f32 values an ulp apart can round to neighbours, once per rounding.
- Pallas interpret mode: 2e-3, the tolerance of the reference's own kernel
  tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduce_for_smoke as jax_reduce
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ssd import ssd_intra_chunk_pallas
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention_cuda as flash_attention
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import attention as pattn
from repro_torch.models import ssm as pssm

F32_ATTN, F32_SSD, INTERPRET = 2e-5, 1e-4, 2e-3


def _close(got: torch.Tensor, want, tol: float, rtol: float | None = None) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol if rtol is None else rtol, atol=tol)


def _qkv(b, sq, sk, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, sk, kv, d), np.float32),
            rng.standard_normal((b, sk, kv, d), np.float32))


# the reference kernel tests' grid (tests/test_kernels_attention_ssd.py) plus D=112
FLASH_GRID = [
    (1, 256, 4, 4, 64, True, None),     # MHA causal
    (2, 200, 8, 2, 32, True, None),     # GQA, ragged
    (1, 256, 4, 1, 64, False, None),    # MQA, bidirectional
    (1, 300, 4, 2, 128, True, 64),      # sliding window
    (2, 130, 4, 4, 112, True, None),    # zamba2-7b's head dim
]


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", FLASH_GRID)
def test_plain_attention_matches_reference(b, s, h, kv, d, causal, window):
    q, k, v = _qkv(b, s, s, h, kv, d, seed=s + d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want_full = jattn.attend_full(jq, jk, jv, causal=causal, window=window)
    _close(pattn.attend_full(tq, tk, tv, causal=causal, window=window), want_full, F32_ATTN)
    want_blk = jattn.attend_blockwise(jq, jk, jv, causal=causal, window=window, block_k=64)
    _close(pattn.attend_blockwise(tq, tk, tv, causal=causal, window=window, block_k=64), want_blk, F32_ATTN)
    # the kernel's entry point on CPU tensors is the plain version
    _close(flash_attention(tq, tk, tv, causal=causal, window=window), want_full, F32_ATTN)


def test_plain_attention_bf16_and_cross_shapes():
    q, k, v = _qkv(1, 96, 160, 4, 2, 32, seed=2)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    t = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    for causal in (True, False):
        want = jattn.attend_full(*j, causal=causal)
        got = pattn.attend_full(*t, causal=causal)
        assert got.dtype == torch.bfloat16
        _close(got, np.asarray(want, np.float32), 1e-3, rtol=2**-6)
        want_b = jattn.attend_blockwise(*j, causal=causal, block_k=64)
        _close(pattn.attend_blockwise(*t, causal=causal, block_k=64), np.asarray(want_b, np.float32),
               1e-3, rtol=2**-6)


def test_long_prompts_take_the_blockwise_path():
    """Above 2048 tokens the reference's prefill switches to the blockwise
    online softmax; the port's plain version follows it."""
    q, k, v = _qkv(1, 2100, 2100, 2, 1, 16, seed=5)
    want = jattn.attend_blockwise(*map(jnp.asarray, (q, k, v)), causal=True, block_k=512)
    _close(flash_attention(*map(torch.from_numpy, (q, k, v))), want, F32_ATTN)


def test_plain_attention_matches_the_pallas_kernel_in_interpret_mode():
    q, k, v = _qkv(1, 128, 128, 2, 1, 32, seed=7)
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), causal=True,
                                  block_q=64, block_k=64, interpret=True)
    _close(flash_attention(*map(torch.from_numpy, (q, k, v))), want, INTERPRET)


def test_attend_decode_matches_reference():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((3, 1, 4, 16), np.float32)
    kc = rng.standard_normal((3, 40, 2, 16), np.float32)
    vc = rng.standard_normal((3, 40, 2, 16), np.float32)
    lens = np.array([1, 17, 40])
    for window in (None, 8):
        want = jattn.attend_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(lens), window=window)
        got = pattn.attend_decode(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                                  torch.from_numpy(lens), window=window)
        _close(got, want, F32_ATTN)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


def _ssd_inputs(b, l, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 1.0)).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    B = rng.standard_normal((b, l, g, n), np.float32)
    C = rng.standard_normal((b, l, g, n), np.float32)
    return x, dt, A, B, C


def _intra_inputs(b, nc, q, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    xbar = rng.standard_normal((b, nc, q, h, p), np.float32)
    Bh = rng.standard_normal((b, nc, q, h, n), np.float32)
    Ch = rng.standard_normal((b, nc, q, h, n), np.float32)
    cum = -np.cumsum(np.log1p(np.exp(rng.standard_normal((b, nc, q, h)))), axis=2).astype(np.float32)
    return xbar, Bh, Ch, cum


def test_ssd_intra_chunk_matches_reference():
    args = _intra_inputs(2, 3, 32, 4, 16, 8, seed=7)
    want = jssm.ssd_intra_chunk(*map(jnp.asarray, args))
    got = pssm.ssd_intra_chunk(*map(torch.from_numpy, args))
    for g_, w_ in zip(got, want):
        _close(g_, w_, F32_SSD)


def test_ssd_intra_chunk_matches_the_pallas_kernel_in_interpret_mode():
    args = _intra_inputs(1, 2, 16, 2, 8, 8, seed=8)
    y_k, s_k = ssd_intra_chunk_pallas(*map(jnp.asarray, args), interpret=True)
    y, s, _ = pssm.ssd_intra_chunk(*map(torch.from_numpy, args))
    _close(y, y_k, INTERPRET)
    _close(s, np.asarray(s_k).transpose(0, 1, 2, 4, 3), INTERPRET)   # kernel states are (N, P)-major


@pytest.mark.parametrize(
    "b,l,h,p,g,n,chunk",
    [
        (1, 128, 4, 64, 1, 64, 64),     # two chunks
        (2, 96, 2, 32, 1, 16, 32),      # three chunks, small dims
        (1, 64, 8, 64, 1, 128, 64),     # single chunk, wide state
        (2, 100, 4, 16, 1, 8, 32),      # ragged length (padded last chunk)
        (1, 70, 4, 16, 2, 8, 16),       # two state groups
    ],
)
def test_ssd_chunked_matches_reference(b, l, h, p, g, n, chunk):
    args = _ssd_inputs(b, l, h, p, g, n, seed=l + n)
    y_ref, s_ref = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    targs = list(map(torch.from_numpy, args))
    y, s = pssm.ssd_chunked(*targs, chunk=chunk)
    _close(y, y_ref, F32_SSD)
    _close(s, s_ref, F32_SSD)
    # the kernel path's entry point on CPU tensors runs the same math
    y_k, s_k = ssd_ops.ssd_chunked(*targs, chunk=chunk)
    assert torch.equal(y_k, y) and torch.equal(s_k, s)


def test_ssd_initial_state_chains():
    x, dt, A, B, C = map(torch.from_numpy, _ssd_inputs(1, 64, 2, 16, 1, 8, seed=9))
    y_full, s_full = jssm.ssd_chunked(*map(jnp.asarray, (x.numpy(), dt.numpy(), A.numpy(),
                                                          B.numpy(), C.numpy())), chunk=16)
    y1, s1 = pssm.ssd_chunked(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32], chunk=16)
    y2, s2 = pssm.ssd_chunked(x[:, 32:], dt[:, 32:], A, B[:, 32:], C[:, 32:], chunk=16, initial_state=s1)
    _close(torch.cat([y1, y2], dim=1), y_full, F32_SSD)
    _close(s2, s_full, F32_SSD)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference(g):
    rng = np.random.default_rng(13 + g)
    b, h, p, n = 2, 4, 8, 16
    args = (rng.standard_normal((b, h, p, n), np.float32), rng.standard_normal((b, h, p), np.float32),
            np.abs(rng.standard_normal((b, h))).astype(np.float32), -np.abs(rng.standard_normal(h)).astype(np.float32),
            rng.standard_normal((b, g, n), np.float32), rng.standard_normal((b, g, n), np.float32))
    want = jssm.ssd_decode_step(*map(jnp.asarray, args))
    got = pssm.ssd_decode_step(*map(torch.from_numpy, args))
    for g_, w_ in zip(got, want):
        _close(g_, w_, F32_SSD)


def test_mamba2_block_and_decode_step_match_reference():
    jcfg = jax_reduce(JAX_ARCHS["zamba2-7b"])
    cfg = reduce_for_smoke(ARCHS["zamba2-7b"])
    jp = jssm.init_mamba2_block(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    y_ref, c_ref = jssm.mamba2_block(jp, jnp.asarray(x), jcfg)
    y, c = pssm.mamba2_block(tp, torch.from_numpy(x), cfg)
    _close(y, y_ref, F32_SSD)
    for k in ("conv", "ssm"):
        _close(c[k], c_ref[k], F32_SSD)
    xt = np.random.default_rng(5).standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    yt_ref, ct_ref = jssm.mamba2_decode_step(jp, jnp.asarray(xt), c_ref, jcfg)
    yt, ct = pssm.mamba2_decode_step(tp, torch.from_numpy(xt), c, cfg)
    _close(yt, yt_ref, F32_SSD)
    for k in ("conv", "ssm"):
        _close(ct[k], ct_ref[k], F32_SSD)
