"""The SSD intra-chunk piece under autograd (``kernels/ssd/bwd.py``):
``SSDIntraChunk``'s closed-form backward against ``jax.grad`` of the
reference's ``repro.models.ssm.ssd_chunked``, on the host (the Function's
forward takes the kernel wrapper's plain version on CPU tensors).

Tolerances:
- gradients of x, dt, A, B and C through the port's ``ssd_chunked``
  against ``jax.grad`` (f32): within 1e-5 of each one's max|ref| (sums in
  another order; the closed form in place of the differentiated scan);
- the Function alone in float64 against finite differences
  (``torch.autograd.gradcheck``'s defaults);
- a stride-0 (expanded) B/C: its gradient equals the heads' sum of the
  full-shape gradient bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.kernels.ssd import bwd as ssd_bwd
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.bwd import SSDIntraChunk
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.models import ssm
from repro_torch.models.transformer import init_model


def _inputs(b, l, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, p)).astype(np.float32),
            (0.5 * np.abs(rng.standard_normal((b, l, h)))).astype(np.float32),
            (-np.abs(rng.standard_normal(h))).astype(np.float32),
            rng.standard_normal((b, l, g, n)).astype(np.float32),
            rng.standard_normal((b, l, g, n)).astype(np.float32))


# (b, l, h, p, g, n, chunk): one group over the heads (a stride-0 view), two
# groups (repeated), a length that is no multiple of the chunk, one chunk
CASES = [(2, 48, 4, 8, 1, 6, 16), (1, 48, 4, 8, 2, 6, 16), (2, 37, 4, 8, 1, 6, 16), (1, 10, 2, 4, 1, 3, 16)]


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", CASES)
def test_function_gradients_match_jax_grad_of_the_reference(b, l, h, p, g, n, chunk):
    arrays = _inputs(b, l, h, p, g, n)
    rng = np.random.default_rng(1)
    wy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    ws = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def jloss(*args):
        y, s = jax_ssd_chunked(*args, chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(s * ws)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    y, s = ssd_chunked(*ts, chunk=chunk)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * torch.from_numpy(wy)).sum() + (s * torch.from_numpy(ws)).sum(), ts)
    for name, x, w in zip(("x", "dt", "A", "B", "C"), got, want):
        w = np.asarray(w)
        assert x.shape == w.shape, name
        assert float(np.abs(x.numpy() - w).max()) <= 1e-5 * float(np.abs(w).max()), name


def _chunk_inputs(dtype=torch.float64, seed=2, heads_from_one_group=False):
    g = torch.Generator().manual_seed(seed)
    b, nc, q, h, p, n = 1, 2, 8, 3, 4, 5
    xbar = torch.randn((b, nc, q, h, p), generator=g, dtype=dtype)
    if heads_from_one_group:
        Bh = torch.randn((b, nc, q, 1, n), generator=g, dtype=dtype)
        Ch = torch.randn((b, nc, q, 1, n), generator=g, dtype=dtype)
    else:
        Bh = torch.randn((b, nc, q, h, n), generator=g, dtype=dtype)
        Ch = torch.randn((b, nc, q, h, n), generator=g, dtype=dtype)
    cum = torch.cumsum(-0.3 * torch.rand((b, nc, q, h), generator=g, dtype=dtype), dim=2)
    return xbar, Bh, Ch, cum


def test_function_passes_gradcheck_in_float64():
    inputs = tuple(t.requires_grad_() for t in _chunk_inputs())
    assert torch.autograd.gradcheck(SSDIntraChunk.apply, inputs)


def test_expanded_heads_get_their_summed_gradient():
    """g = 1 reaches the Function as a stride-0 expand over the heads; the
    Function returns full-shape gradients and expand's backward sums them."""
    xbar, B1, C1, cum = _chunk_inputs(torch.float32, heads_from_one_group=True)
    h = xbar.shape[3]
    B1.requires_grad_(), C1.requires_grad_()
    Bh, Ch = B1.expand(-1, -1, -1, h, -1), C1.expand(-1, -1, -1, h, -1)
    assert Bh.stride(3) == 0
    y, st, dec = SSDIntraChunk.apply(xbar, Bh, Ch, cum)
    gy, gs = torch.randn_like(y), torch.randn_like(st)
    gB1, gC1 = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), (B1, C1))
    full = ssd_bwd.ssd_intra_chunk_bwd(xbar, Bh, Ch, cum, gy, gs, torch.zeros_like(dec))
    assert torch.equal(gB1, full[1].sum(dim=3, keepdim=True))
    assert torch.equal(gC1, full[2].sum(dim=3, keepdim=True))


def test_backward_never_reruns_the_plain_version(monkeypatch):
    calls = []
    real = ssd_kernel.ssd_intra_chunk_ref

    def counted(*a):
        calls.append(torch.is_grad_enabled())
        return real(*a)

    monkeypatch.setattr(ssd_kernel, "ssd_intra_chunk_ref", counted)
    inputs = [t.requires_grad_() for t in _chunk_inputs(torch.float32)]
    y, st, dec = SSDIntraChunk.apply(*inputs)
    assert calls == [False]   # the forward, without a graph
    torch.autograd.grad(y.sum() + st.sum() + dec.sum(), inputs)
    assert calls == [False]


def test_mamba2_block_takes_the_function_under_grad_and_the_bare_kernel_without():
    cfg = reduce_for_smoke(ARCHS["mamba2-2.7b"])
    params = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    p_l = {k: v[0] for k, v in params["blocks"]["block"].items() if not isinstance(v, dict)}
    p_l.update({k: {"w": v["w"][0]} for k, v in params["blocks"]["block"].items() if isinstance(v, dict)})
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(1))
    p_l["in_proj"]["w"].requires_grad_()
    y, _ = ssm.mamba2_block(p_l, x, cfg)
    seen, stack = set(), [y.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    assert any(type(fn).__name__ == "SSDIntraChunkBackward" for fn in seen)
    with torch.no_grad():
        y2, _ = ssm.mamba2_block(p_l, x, cfg)
    assert torch.equal(y.detach(), y2)


def test_kernel_wrapper_refuses_grad_and_names_the_function():
    xbar = torch.empty((1, 2, 16, 4, 8), device="meta", requires_grad=True)
    bc = torch.empty((1, 2, 16, 4, 8), device="meta")
    cum = torch.empty((1, 2, 16, 4), device="meta")
    with pytest.raises(RuntimeError, match="SSDIntraChunk"):
        ssd_kernel.ssd_intra_chunk_cuda(xbar, bc, bc, cum)
