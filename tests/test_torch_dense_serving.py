"""The port's dense LM serving path against the reference's, on the host.

``reduce_for_smoke`` of each dense config: 2 layers, d_model 64, GQA 4/2,
head dim 16, vocab 256, f32; h2o-danube-1.8b keeps a sliding window, cut
to 32, so a 48-token prompt fills its 32-slot ring buffer past the end and
every decode step overwrites the oldest slot.  The reference's
``init_model`` draws the params; the port takes them as numpy through
``lm_params_from_numpy``.  On CPU tensors the flash kernel's wrapper takes
its plain version (the reference's prefill takes ``attend_full``).

Tolerances are those of ``tests/test_torch_lm.py``: 1e-4 on f32 logits and
cache leaves; bf16 5e-2 on logits and 2**-6 relative plus 8e-2 on the
cache; decode against a fresh prefill of the port itself 4e-2.
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

DENSE = ("qwen3-1.7b", "h2o-danube-1.8b", "yi-9b", "phi3-medium-14b")
B, S, MAX_LEN, N_DECODE = 2, 48, 64, 8


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _np(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _pair(arch: str, dtype: str = "float32"):
    jcfg = dataclasses.replace(jax_reduce(JAX_ARCHS[arch]), dtype=dtype)
    cfg = dataclasses.replace(reduce_for_smoke(ARCHS[arch]), dtype=dtype)
    jp = jt.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 256, (B, S + N_DECODE))


def _assert_caches_close(got: dict, want: dict, **tol) -> None:
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), err_msg=key, **tol)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_the_reference_f32(tokens, arch):
    """Prefill and 8 decode steps; for danube the prompt (48) is past the
    window (32), so prefill scatters its last 32 tokens to their ring slots
    and decode attends over the whole ring."""
    jcfg, cfg, jp, tp = _pair(arch)
    assert (cfg.window is not None) == (arch == "h2o-danube-1.8b")
    lj, cj = jt.forward_prefill(jp, jcfg, jnp.asarray(tokens[:, :S]), max_len=MAX_LEN, remat="none")
    lp, cp = pt.forward_prefill(tp, cfg, torch.as_tensor(tokens[:, :S]), max_len=MAX_LEN)
    np.testing.assert_allclose(_np(lp), _np(lj), rtol=1e-4, atol=1e-4)
    _assert_caches_close(cp, cj, rtol=1e-4, atol=1e-4)
    kv_len = cfg.window if cfg.window else MAX_LEN
    assert tuple(cp["layers"]["k"].shape) == (cfg.n_layers, B, kv_len, cfg.n_kv_heads, cfg.head_dim)
    decode = jax.jit(jt.forward_decode, static_argnums=1)
    for i in range(N_DECODE):
        tok = tokens[:, S + i : S + i + 1]
        lj, cj = decode(jp, jcfg, jnp.asarray(tok), cj, jnp.int32(S + i))
        lp, cp = pt.forward_decode(tp, cfg, torch.as_tensor(tok), cp, S + i)
        np.testing.assert_allclose(_np(lp), _np(lj), rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    _assert_caches_close(cp, cj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-1.8b"])
def test_prefill_matches_the_reference_bf16(tokens, arch):
    jcfg, cfg, jp, tp = _pair(arch, "bfloat16")
    assert tp["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    lj, cj = jt.forward_prefill(jp, jcfg, jnp.asarray(tokens[:, :S]), max_len=MAX_LEN, remat="none")
    lp, cp = pt.forward_prefill(tp, cfg, torch.as_tensor(tokens[:, :S]), max_len=MAX_LEN)
    np.testing.assert_allclose(_np(lp), _np(lj), rtol=5e-2, atol=5e-2)
    assert cp["layers"]["k"].dtype == torch.bfloat16
    _assert_caches_close(cp, cj, rtol=2**-6, atol=8e-2)
    lj2, _ = jt.forward_decode(jp, jcfg, jnp.asarray(tokens[:, S : S + 1]), cj, jnp.int32(S))
    lp2, _ = pt.forward_decode(tp, cfg, torch.as_tensor(tokens[:, S : S + 1]), cp, S)
    np.testing.assert_allclose(_np(lp2), _np(lj2), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-1.8b"])
def test_decode_matches_prefill(arch):
    """Decode against a fresh prefill of the prompt plus the tokens so far
    (the reference's tests/test_serving.py check, on the port alone); for
    danube both sides run past the 32-token window."""
    cfg = reduce_for_smoke(ARCHS[arch])
    tp = pt.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (2, 44)))
    n_dec = 6
    logits, cache = pt.forward_prefill(tp, cfg, toks[:, : 44 - n_dec], max_len=48)
    for i in range(n_dec):
        pos = 44 - n_dec + i
        logits, cache = pt.forward_decode(tp, cfg, toks[:, pos : pos + 1], cache, pos)
        ref, _ = pt.forward_prefill(tp, cfg, toks[:, : pos + 1], max_len=48)
        torch.testing.assert_close(logits, ref, rtol=4e-2, atol=4e-2)


@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_the_reference(arch):
    """Every field of the published config, and of its smoke reduction."""
    assert dataclasses.asdict(ARCHS[arch]) == dataclasses.asdict(JAX_ARCHS[arch])
    assert dataclasses.asdict(reduce_for_smoke(ARCHS[arch])) == dataclasses.asdict(jax_reduce(JAX_ARCHS[arch]))
    assert ARCHS[arch].param_count() == JAX_ARCHS[arch].param_count()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-1.8b"])
def test_init_cache_matches_the_reference_layout(arch):
    cfg, jcfg = reduce_for_smoke(ARCHS[arch]), jax_reduce(JAX_ARCHS[arch])
    got = dict(_flat(pt.init_cache(cfg, 3, 40, device="cpu")))
    want = dict(_flat(jt.init_cache(jcfg, 3, 40)))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(not v.any() for v in got.values())


def test_decode_builds_one_position_tensor_per_step(monkeypatch):
    """The decode position goes to the device once per step, not once per
    layer, and the logits and cache are bit-equal to building it per layer."""
    cfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-1.7b"]), n_layers=4)
    tp = pt.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (2, 13)))
    _, cache = pt.forward_prefill(tp, cfg, toks[:, :12], max_len=16)
    per_layer = {k: v.clone() for k, v in cache["layers"].items()}
    real, made = torch.tensor, []

    def spy(*a, **kw):
        made.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(torch, "tensor", spy)
    logits, cache = pt.forward_decode(tp, cfg, toks[:, 12:], cache, 12)
    monkeypatch.undo()
    assert made == [[12]]
    x = pt.embed(tp["embed"], toks[:, 12:])
    for i, p_l in enumerate(pt._unstack(tp["blocks"], cfg.n_layers)):
        x = pt._attn_block_decode(p_l, x, cfg, pt._index(per_layer, i), 12, torch.tensor([12]))
    want = pt._unembed(tp, cfg, pt.rms_norm(tp["final_norm"], x, cfg.norm_eps))[:, 0, :]
    assert torch.equal(logits, want)
    assert all(torch.equal(cache["layers"][k], per_layer[k]) for k in per_layer)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-1.8b"])
def test_serve_cli_serves_dense_on_the_host(capsys, arch):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "40", "--tokens", "3", "--requests", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("wave ") == 2 and "tok/s" in out and "logits finite: True" in out
    assert "(flash, ssd) (0, 0)" in out   # the host runs the plain versions
