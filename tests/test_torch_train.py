"""The port's training path against the reference's, on the host.

``reduce_for_smoke(qwen3-1.7b)``: 2 dense layers, d_model 64, GQA 4/2,
head dim 16, qk-norm, tied embeddings, float32.  The reference's
``init_model`` draws the params and the port takes them as numpy through
``lm_params_from_numpy``, so both sides compute on the same numbers.  On
CPU tensors the flash kernels' wrappers take their plain versions.

Tolerances:
- forward_train: |loss - ref| <= 1e-5; each gradient leaf within 1e-4 of
  its max|ref| (f32 sums in another order through 2 layers, the
  cross-entropy over 256 logits, and the blockwise vs full softmax).
- adamw_update on identical grads: each leaf within 1e-6 of its max|ref|
  (the same f32 operations in the same order; the global norm is summed in
  another order).
- one train step (2 microbatches): loss, grad_norm within 1e-5 relative,
  lr equal.  Params after the step: at step 1 Adam moves each element by
  about lr * sign(g), so an element whose gradient is at the level of the
  f32 noise can move the other way (2 lr apart).  Pinned: elements more
  than 1e-6 apart are under 1% of each leaf, and none is more than
  2 lr + 1e-6 apart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduce_for_smoke as jax_reduce
from repro.data import pipeline as jpipe
from repro.models import transformer as jt
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training.train_step import make_train_step as jax_train_step
from repro.training.train_step import pick_microbatches as jax_pick_microbatches
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.data.pipeline import LMStreamConfig, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as pt
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_adamw, make_lr_schedule
from repro_torch.training.train_step import make_train_step, pick_microbatches
from repro_torch.training.tree import tree_leaves

ARCH = "qwen3-1.7b"
ROOT = Path(__file__).resolve().parents[1]


def _pair(dtype: str = "float32"):
    jcfg = dataclasses.replace(jax_reduce(JAX_ARCHS[ARCH]), dtype=dtype)
    cfg = dataclasses.replace(reduce_for_smoke(ARCHS[ARCH]), dtype=dtype)
    jp = jt.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def f32():
    return _pair()


def _batch(b: int, s: int, seed: int = 0, mask: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32),
           "labels": rng.integers(0, 256, (b, s)).astype(np.int32)}
    if mask:
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in batch.items()}


def _leafwise(got: list, want: list, tol: float) -> None:
    assert len(got) == len(want)
    for i, (x, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        x = x.detach().float().numpy()
        assert x.shape == w.shape, i
        err = float(np.abs(x - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-30), f"leaf {i}: max|diff| {err:.3e}"


def test_smoke_config_and_layout_match_the_reference(f32):
    jcfg, cfg, jp, tp = f32
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.qk_norm,
            cfg.tie_embeddings) == (2, 64, 4, 2, 16, True, True)
    assert dataclasses.asdict(ARCHS[ARCH]) == dataclasses.asdict(JAX_ARCHS[ARCH])
    assert ARCHS[ARCH].param_count() == JAX_ARCHS[ARCH].param_count()
    # the port's own init has the reference's tree, shapes and dtypes
    own = pt.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(own)] == [x.shape for x in jax.tree.leaves(jp)]
    assert [x.dtype for x in tree_leaves(own)] == [x.dtype for x in tree_leaves(tp)]


@pytest.mark.parametrize("remat,b,s,mask", [("none", 2, 40, False), ("full", 2, 40, True),
                                             ("full", 1, 2080, False)])
def test_forward_train_loss_and_grads_match_the_reference(f32, remat, b, s, mask):
    """S = 2080 > 2048 makes the reference attend through its blockwise
    custom_vjp, the function the port's flash path implements."""
    jcfg, cfg, jp, tp = f32
    batch = _batch(b, s, seed=s, mask=mask)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jt.forward_train(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat),
        has_aux=True)(jp)
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    loss, met = pt.forward_train(tp, cfg, _torch_batch(batch), remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    assert sorted(met) == sorted(jmet)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    assert float(met["ce_loss"].detach()) == float(loss.detach()) and float(met["moe_lb_loss"]) == 0.0
    _leafwise(list(grads), jax.tree.leaves(jgrads), 1e-4)


def test_remat_policies_the_port_lacks_raise(f32):
    _, cfg, _, tp = f32
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.forward_train(tp, cfg, _torch_batch(_batch(1, 8)), remat="dots")


def _random_tree(like: list, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(x.shape).astype(np.float32) * 0.05 for x in like]


def test_adamw_update_matches_the_reference(f32):
    """Three updates with clipping active, so the bias corrections and the
    clip scale both differ from 1."""
    _, _, jp, tp = f32
    cfg_o = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    jcfg_o = jopt.AdamWConfig(**dataclasses.asdict(cfg_o))
    jstate, tstate = jopt.init_adamw(jp), init_adamw(tp)
    treedef = jax.tree.structure(jp)
    update = jax.jit(lambda g, s, p: jopt.adamw_update(g, s, p, jcfg_o))
    jparams = jp
    tparams = {k: v for k, v in lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu").items()}
    for step in range(3):
        g = _random_tree(jax.tree.leaves(jp), seed=step)
        jparams, jstate, jm = update(jax.tree.unflatten(treedef, [jnp.asarray(x) for x in g]), jstate, jparams)
        grads = lm_params_from_numpy(jax.tree.unflatten(treedef, g), device="cpu")
        tparams, tstate, tm = adamw_update(grads, tstate, tparams, cfg_o)
        assert int(tstate.step) == int(jstate.step) == step + 1
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        for mine, ref in ((tparams, jparams), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            _leafwise(tree_leaves(mine), jax.tree.leaves(ref), 1e-6)


def test_lr_schedule_matches_the_reference_at_warmup_peak_and_end():
    cfg_o = AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    want = jopt.make_lr_schedule(jopt.AdamWConfig(**dataclasses.asdict(cfg_o)))
    got = make_lr_schedule(cfg_o)
    for step in (0, 1, 50, 100, 5_000, 10_000, 12_000):
        assert got(step) == pytest.approx(float(want(jnp.int32(step))), rel=1e-6, abs=0.0), step
    assert got(100) == pytest.approx(3e-4, rel=1e-6) and got(10_000) == pytest.approx(3e-5, rel=1e-6)


def test_train_step_with_two_microbatches_matches_the_reference(f32):
    jcfg, cfg, jp, _ = f32
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg_o = AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=20)
    batch = _batch(4, 24, seed=3)
    jstep = jax_train_step(jcfg, jopt.AdamWConfig(**dataclasses.asdict(cfg_o)), n_micro=2, remat="full")
    jparams, jstate, jm = jstep(jp, jopt.init_adamw(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(cfg, cfg_o, n_micro=2, remat="full")
    tparams, tstate, tm = step(tp, init_adamw(tp), _torch_batch(batch))
    assert sorted(tm) == sorted(jm)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    assert float(tm["lr"]) == float(jm["lr"]) and int(tstate.step) == 1
    lr = float(jm["lr"])
    for x, w in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        d = np.abs(x.detach().numpy() - np.asarray(w))
        assert float(d.max()) <= 2 * lr + 1e-6
        assert float((d > 1e-6).mean()) < 0.01
    _leafwise(tree_leaves(tstate.mu), jax.tree.leaves(jstate.mu), 1e-4)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-7b"])
def test_pick_microbatches_matches_the_reference(arch):
    for batch, seq in ((8, 4096), (32, 4096), (6, 32768), (1, 128)):
        got = pick_microbatches(ARCHS[arch], batch, seq)
        assert got == jax_pick_microbatches(JAX_ARCHS[arch], batch, seq) and batch % got == 0


def test_synthetic_lm_batches_are_bit_identical_to_the_reference():
    for vocab, seq, gb, seed in ((256, 33, 4, 0), (151936, 64, 8, 3)):
        mine = SyntheticLM(LMStreamConfig(vocab_size=vocab, seq_len=seq, global_batch=gb, seed=seed))
        ref = jpipe.SyntheticLM(jpipe.LMStreamConfig(vocab_size=vocab, seq_len=seq, global_batch=gb, seed=seed))
        for step, shard, n in ((0, 0, 1), (7, 1, 2), (1234, 3, 4)):
            a, b = mine.batch_at(step, shard, n), ref.batch_at(step, shard, n)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (step, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_checkpoint_written_by_the_reference_restores_into_the_port(tmp_path, dtype):
    jcfg, cfg, jp, _ = _pair(dtype)
    g = jax.tree.map(lambda x: jnp.full(x.shape, 0.01, x.dtype), jp)
    jparams, jstate, _ = jopt.adamw_update(g, jopt.init_adamw(jp), jp, jopt.AdamWConfig())
    jckpt.save_checkpoint(tmp_path, 5, (jparams, jstate), extra={"cursor": 5})
    like_p = pt.init_model(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    (params, state), extra = ckpt.restore_checkpoint(tmp_path, (like_p, init_adamw(like_p)))
    assert extra["step"] == 5 and extra["cursor"] == 5 and int(state.step) == 1
    want = [jparams, jstate.mu, jstate.nu]
    for mine, ref in zip((params, state.mu, state.nu), want):
        for x, w in zip(tree_leaves(mine), jax.tree.leaves(ref)):
            assert x.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.float32)
            assert np.array_equal(x.float().numpy(), np.asarray(w, np.float32))
    conv = adamw_state_from_numpy(*jax.tree.map(np.asarray, tuple(jstate)), device="cpu")
    for x, y in zip(tree_leaves(conv), tree_leaves(state)):
        assert torch.equal(x, y)


def test_checkpoint_round_trip_retention_and_atomicity(tmp_path):
    cfg = dataclasses.replace(reduce_for_smoke(ARCHS[ARCH]), dtype="bfloat16")
    params = pt.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state = init_adamw(params)
    state = state._replace(step=torch.tensor(4, dtype=torch.int32))
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, s, (params, state), keep=3)
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*")) == [3, 4, 5]
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
    assert manifest["n_leaves"] == len(tree_leaves((params, state)))
    assert {leaf["dtype"] for leaf in manifest["leaves"]} == {"bfloat16", "float32", "int32"}
    crash = tmp_path / "step_00000006.tmp"
    crash.mkdir()
    (crash / "garbage").write_text("boom")
    assert ckpt.latest_step(tmp_path) == 5
    like = pt.init_model(cfg, generator=torch.Generator().manual_seed(9), device="cpu")
    (p2, s2), extra = ckpt.restore_checkpoint(tmp_path, (like, init_adamw(like)))
    assert extra["step"] == 5 and int(s2.step) == 4
    for x, y in zip(tree_leaves((params, state)), tree_leaves((p2, s2))):
        assert x.dtype == y.dtype and torch.equal(x, y)
    other = pt.init_model(dataclasses.replace(cfg, n_layers=1, qk_norm=False),
                          generator=torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore_checkpoint(tmp_path, other)


@contextlib.contextmanager
def _keep_signal_handlers():
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def _arrays(path: Path) -> list[np.ndarray]:
    n = json.loads((path / "manifest.json").read_text())["n_leaves"]
    return [np.load(path / "arrays" / f"{i}.npy") for i in range(n)]


def test_train_cli_resumes_and_continues_bit_exactly(tmp_path, capsys):
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--global-batch", "4", "--seq-len", "16",
              "--n-micro", "2", "--remat", "full", "--log-every", "1", "--ckpt-every", "100"]
    with _keep_signal_handlers():
        assert train_cli.main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path / "a")]) == 0
        assert train_cli.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")]) == 0
        assert train_cli.main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert out.count("[train] step") == 3 + 2 + 1 and "tokens/s" in out and "grad_norm" in out
    a, b = _arrays(tmp_path / "a" / "step_00000003"), _arrays(tmp_path / "b" / "step_00000003")
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_train_cli_checkpoints_on_sigterm(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke", "--device", "cpu",
           "--steps", "100000", "--global-batch", "2", "--seq-len", "8", "--log-every", "1",
           "--ckpt-dir", str(tmp_path)]
    proc = subprocess.Popen(cmd, cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for line in proc.stdout:
            if "[train] step" in line:
                break
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, rest
    assert "checkpointing and exiting" in rest
    assert ckpt.latest_step(tmp_path) is not None and ckpt.latest_step(tmp_path) >= 1
