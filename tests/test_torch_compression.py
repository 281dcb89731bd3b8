"""int8 gradient compression (``repro_torch.training.compression``) and the
elastic-resharding restore (``restore_checkpoint(placements=)``) against
the reference's, on the host.

Tolerances: ``g_hat`` and the new error state equal bit for bit (the same
f32 operations leaf by leaf; ``torch.round`` and ``jnp.round`` both round
half to even); ``compression_error_norm`` within 1e-6 relative (its sums run
in another order); the toy problems' thresholds are the reference's.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compression as j_comp
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import init_model
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.training.compression import compress_decompress, init_error_state, sync_grads_compressed
from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_adamw
from repro_torch.training.tree import tree_leaves, tree_map


def _tree(rng) -> dict:
    return {"a": rng.normal(0, 1, (33, 17)).astype(np.float32),
            "b": {"c": (rng.normal(0, 1e-3, (64,))).astype(np.float32),
                  "d": rng.normal(0, 5, (4, 3, 2)).astype(np.float32)}}


def test_compress_decompress_matches_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    g, e = _tree(rng), _tree(rng)
    e = jax.tree.map(lambda x: x * 0.01, e)
    # values exactly half a step apart round to even on both sides
    g["a"][0, :4] = np.array([0.5, 1.5, -2.5, 3.5], np.float32) * (np.abs(g["a"]).max() / 127.0)
    jg, je, jm = j_comp.compress_decompress(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    pg, pe, pm = compress_decompress(
        {"a": torch.tensor(g["a"]), "b": {k: torch.tensor(v) for k, v in g["b"].items()}},
        {"a": torch.tensor(e["a"]), "b": {k: torch.tensor(v) for k, v in e["b"].items()}})
    for want, got in zip(jax.tree.leaves(jg) + jax.tree.leaves(je), tree_leaves(pg) + tree_leaves(pe)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(pm["compression_error_norm"]) == pytest.approx(float(jm["compression_error_norm"]), rel=1e-6)


def test_compression_error_feedback_is_unbiased_over_time():
    """The sum of compressed grads tracks the sum of true grads (the
    residual stays within one quantisation step, not 50 of them)."""
    rng = np.random.default_rng(0)
    g_sum = np.zeros((64,), np.float32)
    ghat_sum = np.zeros((64,), np.float32)
    err = {"w": torch.zeros(64)}
    for _ in range(50):
        g = {"w": torch.tensor(rng.normal(0, 1, 64), dtype=torch.float32)}
        ghat, err, _ = compress_decompress(g, err)
        g_sum += g["w"].numpy()
        ghat_sum += ghat["w"].numpy()
    assert np.abs(g_sum - ghat_sum).max() < 0.1


def test_compressed_training_converges():
    """Linear regression with int8+EF grads reaches the uncompressed loss."""
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.normal(0, 1, (256, 16)), dtype=torch.float32)
    w_true = torch.tensor(rng.normal(0, 1, (16,)), dtype=torch.float32)
    y = X @ w_true
    cfg = AdamWConfig(lr=3e-2, weight_decay=0.0, warmup_steps=1, total_steps=400)

    def loss_of(w):
        return float(((X @ w - y) ** 2).mean())

    params = {"w": torch.zeros(16)}
    opt, err = init_adamw(params), init_error_state(params)
    for _ in range(400):
        g = {"w": 2.0 / X.shape[0] * X.T @ (X @ params["w"] - y)}
        g, err, _ = compress_decompress(g, err)
        params, opt, _ = adamw_update(g, opt, params, cfg)
    assert loss_of(params["w"]) < 1e-3


@pytest.fixture(scope="module")
def host_mesh():
    return make_host_mesh(device="cpu")


def test_sync_grads_compressed_on_one_rank_is_the_round_trip(host_mesh):
    rng = np.random.default_rng(2)
    g = {"a": torch.tensor(rng.normal(0, 1, (8, 8)), dtype=torch.float32)}
    err = init_error_state(g)
    want, want_e, _ = compress_decompress(g, err)
    got, got_e, metrics = sync_grads_compressed(g, err, host_mesh, ("data",))
    assert torch.equal(got["a"], want["a"]) and torch.equal(got_e["a"], want_e["a"])
    assert "compression_error_norm" in metrics


def test_elastic_resharding(tmp_path, host_mesh):
    """Save unsharded, restore onto the layouts of the sharding rules on a
    1x1 mesh (the elastic path): every leaf a DTensor of its layout, values
    identical."""
    from torch.distributed.tensor import DTensor

    cfg = reduce_for_smoke(ARCHS["qwen3-1.7b"])
    params = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    save_checkpoint(tmp_path, 3, params)
    layouts = sharding.param_shardings(params, host_mesh)
    restored, extra = restore_checkpoint(tmp_path, params, placements=layouts)
    assert extra["step"] == 3
    for a, b, lay in zip(tree_leaves(params), tree_leaves(restored), tree_leaves(layouts)):
        assert isinstance(b, DTensor) and tuple(b.placements) == lay.placements
        assert b.device_mesh.shape == (1, 1) and b.dtype == a.dtype
        assert torch.equal(b.full_tensor(), a)


@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "placements"])
def test_restored_bf16_params_take_an_optimizer_step(tmp_path, host_mesh, sharded):
    """Restored leaves are writable copies, not views of the memory-mapped
    files: AdamW updates bf16 params in place on the first resumed step."""
    cfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-1.7b"]), dtype="bfloat16")
    params = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert any(p.dtype == torch.bfloat16 for p in tree_leaves(params))
    save_checkpoint(tmp_path, 1, params)
    placements = sharding.param_shardings(params, host_mesh) if sharded else None
    restored, _ = restore_checkpoint(tmp_path, params, placements=placements)
    local = [getattr(p, "_local_tensor", p) for p in tree_leaves(restored)]
    if sharded:
        for p in local:
            p.add_(1)
        assert all(torch.equal(p, a + 1) for p, a in zip(local, tree_leaves(params)))
        return
    grads = tree_map(lambda p: torch.ones_like(p, dtype=torch.float32), restored)
    new, _, _ = adamw_update(grads, init_adamw(restored), restored, AdamWConfig(lr=1e-2, warmup_steps=1))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(params)))
