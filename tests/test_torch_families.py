"""The port's moe, ssm, vlm, encdec and hybrid language models against the
reference's, on the host.

Each family at ``reduce_for_smoke`` of its reference config (float32, 2
layers, d_model 64; hybrid 3 Mamba2 layers in groups of 2): the
reference's ``init_model`` draws the params and the port takes them as
numpy through ``lm_params_from_numpy``, so both sides compute on the same
numbers.  On CPU tensors the flash and SSD kernels' wrappers take their
plain versions; under autograd the SSD piece goes through
``SSDIntraChunk`` (the plain forward, the closed-form backward).

Tolerances (f32, sums in another order; the port's attention is the
blockwise online softmax where the reference's is the full softmax, and
its SSD backward is the closed form where the reference differentiates
the jnp scan):
- forward_train: |loss - ref| <= 1e-5, each moe metric within 1e-5, each
  gradient leaf within 1e-4 of its max|ref|;
- prefill and 3 decode steps: logits and every cache leaf within 1e-4
  (rtol and atol);
- decode against a fresh prefill inside the port, the reference's own
  check (tests/test_serving.py): within 4e-2 (ssm, hybrid), 3e-2
  (encdec), 6e-2 (moe; its small decode group keeps every token);
- remat policies: gradients bit for bit equal to ``remat="none"``.
The moe routing indices themselves are compared in test_torch_moe.py.
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
from repro.training import optimizer as jopt
from repro.training.train_step import make_train_step as jax_train_step
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as pt
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step
from repro_torch.training.optimizer import AdamWConfig, init_adamw
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import tree_leaves, tree_unflatten

FAMILY_ARCH = {
    "moe": "granite-moe-3b-a800m",
    "moe_shared": "qwen2-moe-a2.7b",
    "ssm": "mamba2-2.7b",
    "vlm": "internvl2-76b",
    "encdec": "seamless-m4t-medium",
    "hybrid": "zamba2-7b",
}
SERVED = ("moe", "moe_shared", "ssm", "vlm", "encdec")
B, S, S_SRC = 2, 20, 12


def _draw(cfg, seed: int) -> dict:
    """Params of ``cfg``'s tree (the port's init on the meta device gives
    the names and shapes), drawn with numpy: dense weights normal over
    sqrt(fan-in), norms and skips near 1, Mamba2's ``a_log`` and
    ``dt_bias`` in the reference init's ranges."""
    rng = np.random.default_rng(seed)

    def leaf(name: str, t: torch.Tensor) -> np.ndarray:
        shape = tuple(t.shape)
        if name in ("scale", "norm_scale", "d_skip"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "a_log":
            a = np.log(rng.uniform(1.0, 16.0, shape))
        elif name == "dt_bias":
            a = rng.uniform(-4.0, -1.0, shape)
        elif name in ("table", "conv_b"):
            a = 0.05 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return a.astype(np.float32)

    def walk(node: dict) -> dict:
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v) for k, v in node.items()}

    return walk(pt.init_model(cfg, device="meta"))


@pytest.fixture(scope="module")
def pairs():
    """family -> (jax cfg, port cfg, jax params, port params): the same
    numpy draws on both sides."""
    out = {}
    for i, (fam, arch) in enumerate(FAMILY_ARCH.items()):
        jcfg, cfg = jax_reduce(JAX_ARCHS[arch]), reduce_for_smoke(ARCHS[arch])
        tree = _draw(cfg, seed=i)
        out[fam] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, device="cpu"))
    return out


def _frontend(cfg, b: int, seed: int = 5) -> np.ndarray | None:
    if cfg.family not in ("vlm", "encdec"):
        return None
    n = cfg.frontend_tokens if cfg.family == "vlm" else S_SRC
    return np.random.default_rng(seed).standard_normal((b, n, cfg.frontend_dim)).astype(np.float32)


def _batch(cfg, b: int, s: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    fe = _frontend(cfg, b, seed + 1)
    if fe is not None:
        out["frontend"] = fe
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in batch.items()}


def _np(a) -> np.ndarray:
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _leafwise(got: list, want: list, tol: float) -> None:
    assert len(got) == len(want)
    for i, (x, w) in enumerate(zip(got, want)):
        x, w = _np(x), _np(w)
        assert x.shape == w.shape, i
        err = float(np.abs(x - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-30), f"leaf {i}: max|diff| {err:.3e}"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_param_count_and_tree_match_the_reference(arch):
    """Every reference arch is in ARCHS with its fields and param_count;
    the port's own init has the reference's tree, shapes and dtypes (the
    f32 router, the stacked (L, E, d, ff) expert banks)."""
    assert dataclasses.asdict(ARCHS[arch]) == dataclasses.asdict(JAX_ARCHS[arch])
    assert ARCHS[arch].param_count() == JAX_ARCHS[arch].param_count()
    cfg = reduce_for_smoke(ARCHS[arch])
    want = jax.eval_shape(lambda: jt.init_model(jax.random.PRNGKey(0), jax_reduce(JAX_ARCHS[arch])))
    own = pt.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(own)] == [x.shape for x in jax.tree.leaves(want)]
    assert [str(x.dtype).split(".")[-1] for x in tree_leaves(own)] == [str(x.dtype) for x in jax.tree.leaves(want)]


@pytest.mark.parametrize("family", ["moe_shared", "encdec", "vlm"])
def test_lm_params_from_numpy_copies_moe_encdec_vlm_trees(pairs, family):
    _, cfg, jp, tp = pairs[family]
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(got.shape) == want.shape and np.array_equal(_np(got), np.asarray(want, np.float32))
    if family == "moe_shared":
        moe = tp["blocks"]["moe"]
        assert moe["router"]["w"].dtype == torch.float32
        assert moe["experts"]["gate"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
        assert moe["shared_gate"]["w"].shape == (cfg.n_layers, cfg.d_model, 1)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_forward_train_loss_metrics_and_grads_match_the_reference(pairs, family):
    jcfg, cfg, jp, tp = pairs[family]
    batch = _batch(cfg, B, S, seed=len(family))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jt.forward_train(p, jcfg, b, remat="none"), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    loss, met = pt.forward_train(tp, cfg, _torch_batch(batch), remat="none")
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    assert sorted(met) == sorted(jmet)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    for k in jmet:
        assert abs(float(met[k].detach()) - float(jmet[k])) <= 1e-5, k
    if family.startswith("moe"):
        assert float(met["moe_lb_loss"].detach()) > 0 and float(met["moe_z_loss"].detach()) > 0
    _leafwise(list(grads), jax.tree.leaves(jgrads), 1e-4)


@pytest.mark.parametrize("family", SERVED)
def test_prefill_cache_and_decode_match_the_reference(pairs, family):
    jcfg, cfg, jp, tp = pairs[family]
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S + 3))
    fe = _frontend(cfg, B)
    pos0 = S + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    max_len = pos0 + 8
    prefill = jax.jit(lambda p, t, f: jt.forward_prefill(p, jcfg, t, frontend_embeds=f, max_len=max_len))
    decode = jax.jit(lambda p, t, c, pos: jt.forward_decode(p, jcfg, t, c, pos))
    lj, cj = prefill(jp, jnp.asarray(tokens[:, :S]), None if fe is None else jnp.asarray(fe))
    lp, cp = pt.forward_prefill(tp, cfg, torch.as_tensor(tokens[:, :S]), max_len=max_len,
                                frontend_embeds=None if fe is None else torch.from_numpy(fe))
    np.testing.assert_allclose(_np(lp), _np(lj), rtol=1e-4, atol=1e-4)
    assert len(tree_leaves(cp)) == len(jax.tree.leaves(cj))
    for got, want in zip(tree_leaves(cp), jax.tree.leaves(cj)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    for i in range(3):
        tok = tokens[:, S + i : S + i + 1]
        lj, cj = decode(jp, jnp.asarray(tok), cj, jnp.int32(pos0 + i))
        lp, cp = pt.forward_decode(tp, cfg, torch.as_tensor(tok), cp, pos0 + i)
        np.testing.assert_allclose(_np(lp), _np(lj), rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    for got, want in zip(tree_leaves(cp), jax.tree.leaves(cj)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family,tol", [("ssm", 4e-2), ("hybrid", 4e-2), ("encdec", 3e-2),
                                        ("moe_shared", 6e-2), ("vlm", 3e-2)])
def test_decode_matches_a_fresh_prefill_inside_the_port(pairs, family, tol):
    """The reference's tests/test_serving.py checks, on the port alone:
    teacher-forced decode against a prefill of the longer prompt."""
    _, cfg, _, tp = pairs[family]
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)))
    fe = _frontend(cfg, 2)
    fe = None if fe is None else torch.from_numpy(fe)
    off = cfg.frontend_tokens if cfg.family == "vlm" else 0
    n_dec = 4
    logits, cache = pt.forward_prefill(tp, cfg, toks[:, : 24 - n_dec], frontend_embeds=fe, max_len=off + 26)
    for i in range(n_dec):
        pos = 24 - n_dec + i
        logits, cache = pt.forward_decode(tp, cfg, toks[:, pos : pos + 1], cache, off + pos)
        ref, _ = pt.forward_prefill(tp, cfg, toks[:, : pos + 1], frontend_embeds=fe, max_len=off + 26)
        torch.testing.assert_close(logits, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("family", ["moe", "ssm", "vlm", "encdec", "hybrid"])
def test_remat_policies_give_bit_equal_gradients(pairs, family, monkeypatch):
    """Under full, dots and dots_no_batch the gradients equal those under
    none bit for bit, and every flash forward is recomputed whole in the
    backward: twice the launches (the wrapper's calls counted here; the
    kernel is invisible to the dispatcher on the card)."""
    _, cfg, _, tp = pairs[family]
    batch = _torch_batch(_batch(cfg, B, S, seed=3))
    calls = []
    real = flash_kernel.flash_attention_cuda

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(flash_kernel, "flash_attention_cuda", counted)
    leaves = [p.detach().clone().requires_grad_() for p in tree_leaves(tp)]
    params = tree_unflatten(tp, leaves)
    results = {}
    for remat in pt.REMAT_POLICIES:
        calls.clear()
        loss, _ = pt.forward_train(params, cfg, batch, remat=remat)
        results[remat] = (loss.detach(), torch.autograd.grad(loss, leaves), len(calls))
    base_loss, base_grads, base_calls = results["none"]
    if cfg.family == "hybrid":
        per_pass = cfg.n_layers // cfg.hybrid_attn_period
    else:
        per_pass = {"encdec": cfg.n_enc_layers + 2 * cfg.n_layers, "ssm": 0}.get(cfg.family, cfg.n_layers)
    assert base_calls == per_pass
    for remat in ("full", "dots", "dots_no_batch"):
        loss, grads, n_calls = results[remat]
        assert torch.equal(loss, base_loss), remat
        assert all(torch.equal(g, w) for g, w in zip(grads, base_grads)), remat
        assert n_calls == 2 * per_pass, (remat, n_calls)


def test_unknown_remat_policy_raises(pairs):
    _, cfg, _, tp = pairs["moe"]
    with pytest.raises(ValueError, match="dots_no_batch"):
        pt.forward_train(tp, cfg, _torch_batch(_batch(cfg, 1, 8)), remat="everything")
    assert pt.REMAT_POLICIES == tuple(jt.REMAT_POLICIES)


@pytest.mark.parametrize("family", ["encdec", "moe_shared", "vlm"])
def test_train_step_takes_the_frontend_and_reports_the_reference_metrics(pairs, family):
    """One step of two microbatches, each carrying its slice of the
    frontend: the reference step's metric names (encdec: ce_loss alone;
    traced, not run) and the mean of the two microbatches' losses."""
    jcfg, cfg, jp, _ = pairs[family]
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg_o = AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=20)
    batch = _batch(cfg, 4, 12, seed=9)
    jstep = jax_train_step(jcfg, jopt.AdamWConfig(**dataclasses.asdict(cfg_o)), n_micro=2, remat="full")
    jm = jax.eval_shape(jstep, jp, jopt.init_adamw(jp), {k: jnp.asarray(v) for k, v in batch.items()})[2]
    tb = _torch_batch(batch)
    want = [pt.forward_train(tp, cfg, {k: v[i : i + 2] for k, v in tb.items()})[0].detach() for i in (0, 2)]
    _, _, tm = make_train_step(cfg, cfg_o, n_micro=2, remat="dots")(tp, init_adamw(tp), tb)
    assert sorted(tm) == sorted(jm)
    assert float(tm["loss"]) == pytest.approx(float(sum(want)) / 2, rel=1e-6)
    assert np.isfinite(float(tm["grad_norm"])) and float(tm["grad_norm"]) > 0


@pytest.mark.parametrize("family", SERVED)
def test_serve_steps_and_the_clis_run_every_family(pairs, family, capsys):
    _, cfg, _, tp = pairs[family]
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10)))
    fe = _frontend(cfg, 2)
    fe = None if fe is None else torch.from_numpy(fe)
    tok, logits, cache = make_prefill_step(cfg, max_len=40, remat="dots")(tp, toks, fe)
    want, _ = pt.forward_prefill(tp, cfg, toks, frontend_embeds=fe, max_len=40)
    assert torch.equal(logits, want) and torch.equal(tok, want.argmax(-1).int())
    pos0 = 10 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    nxt, _, _ = make_decode_step(cfg)(tp, tok[:, None].long(), cache, pos0)
    assert nxt.shape == (2, 1)
    arch = FAMILY_ARCH[family]
    assert serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
                           "--tokens", "3", "--requests", "3"]) == 0
    assert "logits finite: True" in capsys.readouterr().out
    assert train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1", "--global-batch", "2",
                           "--seq-len", "16", "--remat", "dots", "--log-every", "1"]) == 0
    assert "step     1 loss" in capsys.readouterr().out
