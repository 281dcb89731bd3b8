"""The port's zamba2 LM serving path against the reference's, on the host.

``reduce_for_smoke(zamba2-7b)``: 3 layers (one group of 2 Mamba2 layers and
the shared attention block, then 1 tail layer), GQA 4/2, head dim 16, SSD
chunk 16.  The reference's ``init_model`` draws the params; the port takes
them as numpy through ``lm_params_from_numpy``, so both sides compute on
the same numbers.  On CPU tensors the CUDA kernels' wrappers take their
plain versions.

Tolerances:
- float32: 1e-4 on logits and every cache leaf (f32 sums in another order
  through 3 layers).
- bfloat16: 5e-2 on logits; 8e-2 plus 2**-6 relative on every cache leaf.
  Activations are rounded to bf16 after every op on both sides, but not
  always at the same points (a fused XLA op rounds once where PyTorch
  rounds twice), and the differences grow through the layers: measured
  0.01 on logits and up to 0.056 (under 4 bf16 ulps at magnitudes 2-4) on
  the attention cache after two Mamba2 layers.
- decode vs prefill of the port itself: 4e-2, the reference's own bound
  for this check (tests/test_serving.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import transformer as jt
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import transformer as pt

B, S, MAX_LEN = 2, 40, 48


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _pair(dtype: str):
    jcfg = dataclasses.replace(jax_reduce(JAX_ARCHS["zamba2-7b"]), dtype=dtype)
    cfg = dataclasses.replace(reduce_for_smoke(ARCHS["zamba2-7b"]), dtype=dtype)
    jp = jt.init_model(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def f32():
    return _pair("float32")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 256, (B, S + 4))


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.float().numpy()


def test_smoke_config_matches_the_reference_shape(f32):
    jcfg, cfg, jp, tp = f32
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert (cfg.n_layers, cfg.hybrid_attn_period, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.ssm_chunk) == (3, 2, 4, 2, 16, 16)
    assert tp["mamba_main"]["block"]["in_proj"]["w"].shape[:2] == (1, 2)
    assert tp["mamba_tail"]["block"]["in_proj"]["w"].shape[0] == 1
    assert ARCHS["zamba2-7b"].param_count() == JAX_ARCHS["zamba2-7b"].param_count()


@pytest.mark.parametrize("window", [None, 16])
def test_prefill_and_decode_match_the_reference_f32(f32, tokens, window):
    """window=16 makes the shared block's cache a 16-slot ring buffer."""
    jcfg, cfg, jp, tp = f32
    if window is not None:
        jcfg, cfg = (dataclasses.replace(c, window=window) for c in (jcfg, cfg))
    lj, cj = jt.forward_prefill(jp, jcfg, jnp.asarray(tokens[:, :S]), max_len=MAX_LEN, remat="none")
    lp, cp = pt.forward_prefill(tp, cfg, torch.as_tensor(tokens[:, :S]), max_len=MAX_LEN)
    np.testing.assert_allclose(_np(lp), _np(lj), rtol=1e-4, atol=1e-4)
    want = dict(_flat(cj))
    got = dict(_flat(cp))
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=1e-4, atol=1e-4, err_msg=key)
    for i in range(4):
        tok = tokens[:, S + i : S + i + 1]
        lj, cj = jt.forward_decode(jp, jcfg, jnp.asarray(tok), cj, jnp.int32(S + i))
        lp, cp = pt.forward_decode(tp, cfg, torch.as_tensor(tok), cp, S + i)
        np.testing.assert_allclose(_np(lp), _np(lj), rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    for key, leaf in _flat(cj):
        np.testing.assert_allclose(_np(dict(_flat(cp))[key]), _np(leaf), rtol=1e-4, atol=1e-4, err_msg=key)


def test_prefill_matches_the_reference_bf16(tokens):
    jcfg, cfg, jp, tp = _pair("bfloat16")
    assert tp["embed"]["table"].dtype == torch.bfloat16
    lj, cj = jt.forward_prefill(jp, jcfg, jnp.asarray(tokens[:, :S]), max_len=MAX_LEN, remat="none")
    lp, cp = pt.forward_prefill(tp, cfg, torch.as_tensor(tokens[:, :S]), max_len=MAX_LEN)
    np.testing.assert_allclose(_np(lp), _np(lj), rtol=5e-2, atol=5e-2)
    got = dict(_flat(cp))
    for key, leaf in _flat(cj):
        assert got[key].dtype == (torch.bfloat16 if leaf.dtype == jnp.bfloat16 else torch.float32), key
        np.testing.assert_allclose(_np(got[key]), _np(leaf), rtol=2**-6, atol=8e-2, err_msg=key)
    lj2, _ = jt.forward_decode(jp, jcfg, jnp.asarray(tokens[:, S : S + 1]), cj, jnp.int32(S))
    lp2, _ = pt.forward_decode(tp, cfg, torch.as_tensor(tokens[:, S : S + 1]), cp, S)
    np.testing.assert_allclose(_np(lp2), _np(lj2), rtol=5e-2, atol=5e-2)


def test_decode_matches_prefill(f32):
    """O(1)-state decode agrees with a fresh chunked prefill at each length
    (the reference's tests/test_serving.py check, on the port alone)."""
    _, cfg, _, tp = f32
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (2, 24)))
    n_dec = 4
    logits, cache = pt.forward_prefill(tp, cfg, toks[:, : 24 - n_dec], max_len=26)
    for i in range(n_dec):
        pos = 24 - n_dec + i
        logits, cache = pt.forward_decode(tp, cfg, toks[:, pos : pos + 1], cache, pos)
        ref, _ = pt.forward_prefill(tp, cfg, toks[:, : pos + 1], max_len=26)
        torch.testing.assert_close(logits, ref, rtol=4e-2, atol=4e-2)


def test_serve_cli_runs_on_the_host(capsys):
    assert serve.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "20", "--tokens", "3", "--requests", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("wave ") == 2 and "tok/s" in out and "logits finite: True" in out


def test_serve_returns_tokens_in_range(f32):
    _, cfg, _, tp = f32
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 18))
    res = serve.serve(tp, cfg, prompts, batch=2, tokens=4, device=torch.device("cpu"))
    seqs = res["sequences"]
    assert seqs.shape == (3, 4) and seqs.min() >= 0 and seqs.max() < cfg.vocab_size
    assert res["finite"] and len(res["prefill_ms"]) == 2
    # the host runs the plain versions: no kernel launches
    assert res["prefill_launches"] == [(0, 0), (0, 0)] and res["decode_launches"] == [(0, 0), (0, 0)]
    # wave padding does not change a request's tokens
    alone = serve.serve(tp, cfg, prompts[2:], batch=1, tokens=4, device=torch.device("cpu"))
    assert np.array_equal(alone["sequences"][0], seqs[2])


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_for_smoke(ARCHS["zamba2-7b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.init_model(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "zamba2-7b", "--smoke"])
    params = pt.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert params["mamba_main"]["block"]["in_proj"]["w"].device.type == "cpu"
    cache = pt.init_cache(cfg, 2, 16, device="cpu")
    assert cache["groups"]["attn"]["k"].shape == (1, 2, 16, 2, 16)


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "vlm", "encdec"])
def test_other_families_are_not_ported_yet(family):
    """Every family is ported now (this test once pinned the
    NotImplementedError of the families still to come): init_model,
    init_cache, forward_prefill, forward_decode and forward_train of each
    raise nothing and give finite numbers (tests/test_torch_families.py
    holds them against the reference)."""
    arch = {"dense": "qwen3-1.7b", "moe": "granite-moe-3b-a800m", "ssm": "mamba2-2.7b",
            "vlm": "internvl2-76b", "encdec": "seamless-m4t-medium"}[family]
    cfg = reduce_for_smoke(ARCHS[arch])
    assert cfg.family == family and not hasattr(pt, "_require")
    params = pt.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    fe = None
    if family in ("vlm", "encdec"):
        n = cfg.frontend_tokens if family == "vlm" else 12
        fe = torch.randn((2, n, cfg.frontend_dim), generator=torch.Generator().manual_seed(1))
    assert pt.init_cache(cfg, 2, 16, device="cpu")
    logits, cache = pt.forward_prefill(params, cfg, toks, frontend_embeds=fe, max_len=24)
    pos = 12 + (cfg.frontend_tokens if family == "vlm" else 0)
    logits2, _ = pt.forward_decode(params, cfg, toks[:, :1], cache, pos)
    batch = {"tokens": toks, "labels": toks}
    if fe is not None:
        batch["frontend"] = fe
    loss, metrics = pt.forward_train(params, cfg, batch)
    assert all(bool(torch.isfinite(t).all()) for t in (logits, logits2, loss))
    assert logits.shape == logits2.shape == (2, cfg.vocab_size)


def test_ssd_kernel_wrapper_refuses_inputs_that_need_a_gradient():
    """The kernel has no backward, so its outputs would drop the gradients
    of its inputs; a non-CPU tensor (meta here: no card on the host) that
    requires grad is refused before any launch."""
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda

    xbar = torch.empty((1, 2, 16, 4, 8), device="meta", requires_grad=True)
    bc = torch.empty((1, 2, 16, 4, 8), device="meta")
    cum = torch.empty((1, 2, 16, 4), device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_intra_chunk_cuda(xbar, bc, bc, cum)
    before = ssd_intra_chunk_cuda.launches
    with torch.no_grad(), pytest.raises(ValueError):   # past the guard: the checks want a CUDA device
        ssd_intra_chunk_cuda(xbar, bc, bc, cum)
    assert ssd_intra_chunk_cuda.launches == before


def test_serving_builds_no_graph_for_params_that_require_grad(f32, monkeypatch):
    from repro_torch.training.tree import tree_leaves, tree_map

    _, cfg, _, tp = f32
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    assert all(t.requires_grad for t in tree_leaves(params))
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 12)))
    logits, cache = pt.forward_prefill(params, cfg, toks, max_len=16)
    assert logits.grad_fn is None and not logits.requires_grad
    assert all(not t.requires_grad for _, t in _flat(cache))
    logits, _ = pt.forward_decode(params, cfg, toks[:, :1], cache, 12)
    assert logits.grad_fn is None
    seen = []
    real = serve.make_prefill_step

    def spy(*a, **kw):
        step = real(*a, **kw)

        def run(*args):
            seen.append(torch.is_grad_enabled())
            return step(*args)

        return run

    monkeypatch.setattr(serve, "make_prefill_step", spy)
    res = serve.serve(params, cfg, np.asarray(toks), batch=2, tokens=2, device=torch.device("cpu"))
    assert seen == [False] and res["finite"]
