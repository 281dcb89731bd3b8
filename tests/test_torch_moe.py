"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe``, on the host.

Both moe configs at ``reduce_for_smoke`` (d_model 64, 8 experts, top-2,
expert width 32; qwen2-moe with 2 shared experts and no renormalisation),
global and per-sequence (local) dispatch, a decode-sized group (<= 256
tokens: capacity = group, nothing dropped) and groups of 300 and 600
tokens (capacity from the capacity factor; 0.5 makes many drops).  The
params and inputs are numpy draws handed to both sides.

Tolerances:
- routing: the top-k expert indices and every expert's kept token set
  equal (both sides keep the lower index first among ties; f32 router);
- f32 outputs within 1e-5 of max|ref|; lb and z losses within 1e-6
  relative; drop fractions equal (counts of the same kept sets);
- gradients (x, router, experts, shared) against ``jax.grad`` within 1e-4
  of each leaf's max|ref| (the top-C selection is piecewise constant, so
  the gradient flows through the same kept slots on both sides);
- bf16 outputs within 4 bf16 ulps of max|ref| (each side rounds its
  matmuls and its bf16 scatter sums on its own); inside the port the bf16
  combine equals an explicit ascending-expert sum bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import moe as jm
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe as tm
from repro_torch.training.tree import tree_leaves

MOE_ARCHS = ("granite-moe-3b-a800m", "qwen2-moe-a2.7b")
# (batch, seq, local, capacity factor): a decode-sized group, 2 x 300 tokens
# routed globally (group 600) and per sequence (group 300), and a tight
# capacity that drops
CASES = [(2, 16, False, 1.25), (2, 300, False, 1.25), (2, 300, True, 1.25), (2, 300, False, 0.5),
         (2, 300, True, 0.5)]


def _cfgs(arch: str, local: bool):
    return (dataclasses.replace(jax_reduce(JAX_ARCHS[arch]), moe_local_dispatch=local),
            dataclasses.replace(reduce_for_smoke(ARCHS[arch]), moe_local_dispatch=local))


def _params(cfg, seed: int, dtype=np.float32) -> dict:
    """Numpy draws in the port's tree (names and shapes from its init on
    the meta device): weights normal over sqrt(fan-in), the router f32."""
    rng = np.random.default_rng(seed)

    def walk(node: dict, path: str) -> dict:
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, f"{path}/{k}")
            else:
                a = rng.standard_normal(tuple(v.shape)) / math.sqrt(v.shape[-2])
                out[k] = a.astype(np.float32 if "router" in path else dtype)
        return out

    return walk(tm.init_moe(cfg, dtype=torch.float32, device="meta"), "")


def _both(arch, local, seed=0, dtype=np.float32):
    jcfg, cfg = _cfgs(arch, local)
    tree = _params(cfg, seed, dtype)
    jdt = jnp.bfloat16 if dtype != np.float32 else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32 if a.dtype == np.float32 else jdt), tree)
    return jcfg, cfg, jp, lm_params_from_numpy(tree, device="cpu")


def _jax_routing(jp, jcfg, x, capacity_factor):
    """The reference's routing, step by step as moe() computes it: top-k
    indices (T, k) and each group's kept (expert, token) pairs."""
    B, S, d = x.shape
    E, k = jcfg.n_experts, jcfg.top_k
    local = jcfg.moe_local_dispatch and S > 1
    t = x.reshape(B * S, d)
    probs = jax.nn.softmax(t.astype(jnp.float32) @ jp["router"]["w"], axis=-1)
    vals, idx = jax.lax.top_k(probs, k)
    if jcfg.moe_renormalize:
        vals = vals / vals.sum(-1, keepdims=True)
    aff = jnp.zeros((B * S, E)).at[jnp.arange(B * S)[:, None], idx].set(vals)
    group = S if local else B * S
    cap = group if group <= 256 else min(max(1, math.ceil(group * k * capacity_factor / E)), group)
    w, sel = jax.lax.top_k(aff.reshape(-1, group, E).transpose(0, 2, 1), cap)
    return np.asarray(idx), _kept_sets(np.asarray(w), np.asarray(sel)), cap


def _kept_sets(w: np.ndarray, sel: np.ndarray) -> list[set]:
    """Per group, the (expert, token) pairs of the slots with a positive weight."""
    return [set(zip(*np.nonzero(wg > 0)[:1], sg[wg > 0].tolist())) for wg, sg in zip(w, sel)]


def _port_routing(tp, cfg, x, capacity_factor):
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    local = cfg.moe_local_dispatch and S > 1
    t = x.reshape(B * S, d)
    probs = torch.softmax(t.float() @ tp["router"]["w"], dim=-1)
    vals, idx = tm._top_k(probs, k)
    if cfg.moe_renormalize:
        vals = vals / vals.sum(-1, keepdim=True)
    aff = torch.zeros((B * S, E)).scatter(1, idx, vals)
    group = S if local else B * S
    cap = group if group <= 256 else min(max(1, math.ceil(group * k * capacity_factor / E)), group)
    w, sel = tm._top_k(aff.reshape(-1, group, E).transpose(1, 2), cap)
    return idx.numpy(), _kept_sets(w.numpy(), sel.numpy()), cap


def _x(b, s, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, 64)).astype(np.float32)


@pytest.mark.parametrize("b,s,local,cf", CASES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_then_outputs_and_aux_match_the_reference(arch, b, s, local, cf):
    jcfg, cfg, jp, tp = _both(arch, local)
    x = _x(b, s)
    j_idx, j_kept, cap = _jax_routing(jp, jcfg, jnp.asarray(x), cf)
    t_idx, t_kept, t_cap = _port_routing(tp, cfg, torch.from_numpy(x), cf)
    assert cap == t_cap and (cap == b * s if b * s <= 256 else cap < (s if local else b * s))
    np.testing.assert_array_equal(t_idx, j_idx)
    assert t_kept == j_kept
    jy, jaux = jax.jit(lambda p, xx: jm.moe(p, xx, jcfg, capacity_factor=cf))(jp, jnp.asarray(x))
    ty, taux = tm.moe(tp, torch.from_numpy(x), cfg, capacity_factor=cf)
    jy = np.asarray(jy)
    assert float(np.abs(ty.numpy() - jy).max()) <= 1e-5 * float(np.abs(jy).max())
    assert float(taux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    if cf == 0.5:
        assert float(taux["moe_drop_frac"]) > 0.05
    elif b * s <= 256:
        assert float(taux["moe_drop_frac"]) == 0.0
    for key in ("moe_lb_loss", "moe_z_loss"):
        assert float(taux[key]) == pytest.approx(float(jaux[key]), rel=1e-6), key


@pytest.mark.parametrize("b,s,local,cf", [CASES[0], CASES[3], CASES[4]])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_gradients_match_jax_grad(arch, b, s, local, cf):
    jcfg, cfg, jp, tp = _both(arch, local, seed=2)
    x = _x(b, s, seed=3)
    wy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jm.moe(p, xx, jcfg, capacity_factor=cf)
        return jnp.sum(y * wy) + aux["moe_lb_loss"] + 0.1 * aux["moe_z_loss"]

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tm.moe(tp, xt, cfg, capacity_factor=cf)
    loss = (y * torch.from_numpy(wy)).sum() + aux["moe_lb_loss"] + 0.1 * aux["moe_z_loss"]
    grads = torch.autograd.grad(loss, leaves + [xt])
    for got, want in zip(grads, jax.tree.leaves(jg_p) + [jg_x]):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_outputs_match_and_the_combine_sums_in_ascending_expert_order(arch):
    jcfg, cfg, jp, tp = _both(arch, False, seed=5, dtype=jnp.bfloat16)
    x = _x(2, 300, seed=6)
    jy, _ = jax.jit(lambda p, xx: jm.moe(p, xx, jcfg))(jp, jnp.asarray(x, jnp.bfloat16))
    ty, _ = tm.moe(tp, torch.from_numpy(x).bfloat16(), cfg)
    want = np.asarray(jy.astype(jnp.float32))
    top = float(np.abs(want).max())
    assert float(np.abs(ty.float().numpy() - want).max()) <= 4 * 2.0 ** (math.floor(math.log2(top)) - 7)
    # the combine against a sum written out: token t's kept expert outputs
    # in ascending expert id, each partial sum rounded to bf16
    rows = torch.randn((1, 6 * 4, 8)).bfloat16()
    slot = torch.tensor([[[3, 24, 9], [0, 5, 17], [24, 24, 24]]])
    got = tm._slot_sum(rows, slot)
    pad = torch.cat([rows[0], torch.zeros((1, 8), dtype=torch.bfloat16)])
    for s in range(3):
        acc = pad[slot[0, s, 0]]
        for j in (1, 2):
            acc = acc + pad[slot[0, s, j]]
        assert torch.equal(got[0, s], acc)
    assert torch.equal(got[0, 2], torch.zeros(8, dtype=torch.bfloat16))
    ty2, _ = tm.moe(tp, torch.from_numpy(x).bfloat16(), cfg)
    assert torch.equal(ty, ty2)


def test_dispatch_and_combine_backwards_equal_the_plain_index_backward(monkeypatch):
    """The written-out backwards of the dispatch gather (a fixed-order sum
    of a token's slots) and of the combine (each kept slot written once)
    give autograd's plain index backward bit for bit on the host, which
    sums slots in (expert, slot) order: ascending expert id.  Every leaf's
    gradient, with drops (capacity factor 0.5)."""
    cfg = reduce_for_smoke(ARCHS["qwen2-moe-a2.7b"])
    tree = _params(cfg, 7)
    x = torch.from_numpy(_x(2, 300, seed=8))
    grads = []
    for way in ("written-out", "plain"):
        if way == "plain":
            monkeypatch.setattr(tm._TokenGather, "apply",
                                lambda t, sel, slot: t[torch.arange(t.shape[0])[:, None, None], sel])
            monkeypatch.setattr(tm._Combine, "apply", tm._slot_sum)
        tp = lm_params_from_numpy(tree, device="cpu")
        leaves = [p.requires_grad_() for p in tree_leaves(tp)] + [x.clone().requires_grad_()]
        y, _ = tm.moe(tp, leaves[-1], cfg, capacity_factor=0.5)
        grads.append(torch.autograd.grad(y.square().sum(), leaves))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_launch_entry_points_refuse_tf32_matmuls(entry):
    """The router picks its top-k from f32 logits, so the launch entry
    points refuse to run when f32 matmuls may take TF32."""
    from repro_torch.launch import serve, train

    main = {"serve": serve.main, "train": train.main}[entry]
    was = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="IEEE f32"):
            main(["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu"])
    finally:
        torch.set_float32_matmul_precision(was)
    assert torch.get_float32_matmul_precision() == "highest"
