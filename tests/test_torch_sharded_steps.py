"""Sharded LM steps against unsharded ones, on two gloo ranks of the host.

Each case runs two ``python -c`` ranks that meet at a ``FileStore`` under
``tmp_path`` (as ``tests/test_torch_fleet.py``'s two-rank fleet does).
Both ranks draw the same seeded f32 smoke weights and inputs, run the
step unmeshed, then again with the params, batch and cache laid out as
DTensors by :mod:`repro_torch.launch.sharding` under the ambient mesh
(:func:`repro_torch.launch.cells.meshed`, as the dry run traces a cell),
and compare the gathered results.  The cases cover each sharded path of
the model code: the MoE dispatch (per data rank and global), attention
whose KV heads do not divide the model axis (6:3 heads at model 2: each
rank's query heads read their own KV heads), decode over a cache whose
sequence axis is sharded (the model axis there, the data axis for a
batch-1 cache), the Mamba2 block and decode step on their own heads,
danube's sliding-window ring past its window, and batches that do not
divide the data axis (three rows, and the batch-1 prefill, on two data
ranks): they run padded to it, one padded share a rank, as the
reference's GSPMD pads them, and the padding reaches no result.  Every
case also checks that each residual stream the model pins
(``shard_batch``) is ``Shard(0)`` on the data axis, at the padded row
count.

Tolerances, each with its reason (the moe and family tolerances
``ROADMAP.md`` C pins): outputs (loss, logits, every cache leaf) within
1e-5 of max|ref| and the moe metrics within 1e-5, since sharded sums add
in another order; gradients within 1e-4 of each leaf's max; the router's
top-k expert ids and each expert's kept token set (top-C) equal.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
OUT_TOL, METRIC_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4

# arch, config changes, mesh (data, model) or (pod, data, model), train (B, S) or None, serve (B, S,
# decode steps) or None
CASES = {
    "moe": ("granite-moe-3b-a800m", {}, (1, 2), (4, 80), (2, 40, 4)),
    "moe_global_dispatch": ("granite-moe-3b-a800m", {"moe_capacity_factor": 0.5}, (2, 1), (4, 80), None),
    "gqa_6_3": ("qwen3-1.7b", {"n_heads": 6, "n_kv_heads": 3}, (1, 2), (2, 32), (2, 24, 4)),
    "mamba2": ("mamba2-2.7b", {}, (1, 2), (2, 32), (2, 40, 4)),
    "zamba2": ("zamba2-7b", {}, (1, 2), (2, 32), (2, 24, 4)),
    "danube_ring": ("h2o-danube-1.8b", {}, (1, 2), None, (2, 48, 4)),
    "danube_ring_seq_sharded": ("h2o-danube-1.8b", {"n_heads": 6, "n_kv_heads": 3}, (1, 2), None, (2, 48, 4)),
    "batch1_sequence_parallel": ("qwen3-1.7b", {}, (2, 1), None, (1, 24, 4)),
    "odd_batch_dense": ("qwen3-1.7b", {}, (2, 1), (3, 32), (3, 24, 4)),
    "odd_batch_moe_global": ("granite-moe-3b-a800m", {"moe_capacity_factor": 0.5}, (2, 1), (3, 80), None),
    "odd_batch_moe_drops": ("granite-moe-3b-a800m", {"moe_capacity_factor": 0.5}, (2, 1), (3, 96), None),
    "odd_batch_pod2_data2": ("granite-moe-3b-a800m", {"moe_capacity_factor": 0.5}, (2, 2, 1), (5, 64), (5, 24, 4)),
}

_RANK = r'''
import contextlib, dataclasses, json, math, sys
import numpy as np, torch, torch.distributed as dist
rank, store, src, spec = int(sys.argv[1]), sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
world = math.prod(spec["mesh"])
torch.set_num_threads(1)
sys.path.insert(0, src)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
from repro_torch import compat
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.launch.cells import meshed
from torch.distributed.tensor import Replicate, Shard
from repro_torch.launch.sharding import batch_shardings, cache_shardings, distribute, param_shardings
from repro_torch.models import moe as moe_mod, transformer as tr_mod
from repro_torch.models.transformer import forward_train, init_model
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step
from repro_torch.training.tree import tree_leaves, tree_unflatten

cfg = dataclasses.replace(reduce_for_smoke(ARCHS[spec["arch"]]), **spec["changes"])
axes = ("pod", "data", "model")[-len(spec["mesh"]):]
mesh = compat.make_mesh(tuple(spec["mesh"]), axes)
data = [Shard(0) if a != "model" else Replicate() for a in axes]
params = init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
rng = np.random.default_rng(1)
full = lambda t: (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().float()
rel = lambda a, b: float((full(a) - full(b)).abs().max() / full(b).abs().max().clamp(min=1e-30))

picks = []          # every top-k / top-C of the router: (rows, values, indices)
top_k = moe_mod._top_k
def spy(x, k):
    vals, idx = top_k(x, k)
    picks.append((x.shape[-2], vals.detach().clone(), idx.clone()))
    return vals, idx
moe_mod._top_k = spy

pinned = set()      # (rows, whether sharded over the data axis) of every residual stream shard_batch pins under the mesh
shard_batch = tr_mod.shard_batch
def pin(x):
    y = shard_batch(x)
    if hasattr(y, "placements"):
        pinned.add((y.shape[0], list(y.placements) == data))
    return y
tr_mod.shard_batch = pin

rec = {}
p_dt = distribute(params, param_shardings(params, mesh))
if spec["train"]:
    B, S = spec["train"]
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S))) for k in ("tokens", "labels")}
    grads = []
    for p, b, ctx in ((params, batch, contextlib.nullcontext()),
                      (p_dt, distribute(batch, batch_shardings(mesh, batch)), meshed(mesh))):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        with ctx:
            loss, metrics = forward_train(tree_unflatten(params, leaves), cfg, b, remat="none")
            grads.append((loss, metrics, torch.autograd.grad(loss, leaves), list(picks)))
        picks.clear()
    (loss, metrics, g_ref, p_ref), (loss_m, metrics_m, g_m, p_m) = grads
    rec["loss"] = rel(loss_m, loss)
    rec["metrics"] = max(abs(float(full(metrics_m[k])) - float(metrics[k])) for k in metrics)
    rec["drop_frac"] = float(metrics["moe_drop_frac"])
    rec["grads"] = max(float((full(a) - b).abs().max() / b.abs().max().clamp(min=1e-30)) for a, b in zip(g_m, g_ref))
    # the top-k of a rank's real token rows (first in its block of a padded
    # batch) against the same rows unmeshed; the top-C whole, its token
    # positions mapped to the padded batch's
    (bl,), (b0,) = compat.box((B,), mesh, data)
    lo, n = b0 * S, bl * S
    real = compat.real_row_mask(mesh, B, compat.padded_rows(mesh, B))
    pos = real.repeat_interleave(S).nonzero()[:, 0]
    same = len(p_m) == len(p_ref)
    for (r_m, v_m, i_m), (r, v, i) in zip(p_m, p_ref):
        if r_m < r:         # a rank's rows of the router's top-k
            v_m, i_m, v, i = v_m[:n], i_m[:n], v[lo : lo + n], i[lo : lo + n]
        else:
            i = pos[i]
        same = same and torch.equal(i_m, i) and torch.allclose(v_m, v, rtol=1e-5, atol=1e-7)
    rec["picks_equal"], rec["n_picks"] = same, len(p_m)
if spec["serve"]:
    B, S, steps = spec["serve"]
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    follow = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, B, 1)))
    outs = []
    for on in (False, True):
        place = (lambda c: distribute(c, cache_shardings(c, mesh, B))) if on else None
        put = (lambda t: distribute(t, batch_shardings(mesh, t))) if on else (lambda t: t)
        p = p_dt if on else params
        prefill, decode = make_prefill_step(cfg, max_len=S + steps, place_cache=place), make_decode_step(cfg)
        with meshed(mesh) if on else contextlib.nullcontext(), torch.no_grad():
            _, logits, cache = prefill(p, put(tokens))
            lg = [full(logits)]
            for i in range(steps):
                _, logits, cache = decode(p, put(follow[i]), cache, S + i)
                lg.append(full(logits))
        outs.append((lg, [full(c) for c in tree_leaves(cache)]))
    rec["logits"] = max(rel(a, b) for a, b in zip(outs[1][0], outs[0][0]))
    rec["cache"] = max(rel(a, b) for a, b in zip(outs[1][1], outs[0][1]))
rec["pinned"] = sorted(pinned)
print(json.dumps(rec))
dist.destroy_process_group()
'''


def _run_ranks(tmp_path, spec: dict) -> list[dict]:
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), store, SRC, json.dumps(spec)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(math.prod(spec["mesh"]))]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_equals_unsharded_step(tmp_path, case):
    """The sharded train step (loss, moe metrics, gradients) and the
    sharded prefill and decode steps (logits, every cache leaf) equal the
    unmeshed ones on both ranks."""
    arch, changes, mesh, train, serve = CASES[case]
    spec = {"arch": arch, "changes": changes, "mesh": mesh, "train": train, "serve": serve}
    ext = math.prod(mesh[:-1])      # the data extent
    padded = {-(-run[0] // ext) * ext for run in (train, serve) if run}
    for rec in _run_ranks(tmp_path, spec):
        # every pinned residual stream: Shard(0) on the data axes, at the padded row count
        assert rec["pinned"] and {tuple(p) for p in rec["pinned"]} == {(b, True) for b in padded}, rec
        if train:
            assert rec["loss"] <= OUT_TOL and rec["metrics"] <= METRIC_TOL, rec
            assert rec["grads"] <= GRAD_TOL, rec
            assert rec["picks_equal"], rec
        if serve:
            assert rec["logits"] <= OUT_TOL and rec["cache"] <= OUT_TOL, rec
        if case.startswith("moe"):
            assert rec["n_picks"] == 2 * cfg_layers(arch), rec   # top-k and top-C in each layer
        if case in ("moe_global_dispatch", "odd_batch_moe_drops", "odd_batch_pod2_data2"):
            # capacity 0.5 drops tokens: the kept sets are a real top-C over
            # all 320 (288) tokens, which a per-rank top-C would not match
            assert rec["drop_frac"] > 0.1, rec
        if case == "odd_batch_moe_global":
            # a group of 240 real tokens keeps every one; counted over the
            # 320 padded positions, capacity would drop some
            assert rec["drop_frac"] == 0.0, rec


def cfg_layers(arch: str) -> int:
    from repro_torch.configs import ARCHS, reduce_for_smoke

    return reduce_for_smoke(ARCHS[arch]).n_layers
