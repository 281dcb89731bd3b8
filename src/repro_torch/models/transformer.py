"""Model assembly for every language-model family the reference has.

* ``init_model(cfg, generator=, device=)``                        -> params dict
* ``forward_train(params, cfg, batch, remat=)``                   -> (loss, metrics)
* ``forward_prefill(params, cfg, tokens, frontend_embeds=, max_len=)`` -> (logits, cache)
* ``forward_decode(params, cfg, token, cache, pos)``               -> (logits, cache)
* ``init_cache(cfg, batch, max_len, device=)``                    -> cache dict

Families (the reference's):
* dense / vlm — pre-norm GQA + SwiGLU decoder (sliding windows as ring
  caches); vlm adds a GELU projector of precomputed patch embeddings
  (``frontend_embeds``, the frontend stub) prepended to the tokens;
* moe — GQA + token-choice top-k MoE FFN, optional shared experts
  (:mod:`repro_torch.models.moe`);
* ssm — a Mamba2 stack, attention-free;
* hybrid — Zamba2: a Mamba2 backbone with ONE shared attention+SwiGLU
  block applied every ``hybrid_attn_period`` layers;
* encdec — Seamless: a bidirectional encoder over projected frame
  embeddings and a causal decoder with cross-attention and GELU MLPs.

The parameter and cache layouts are the reference's: per-layer leaves are
stacked ``(n_layers, ...)`` (hybrid ``mamba_main`` ``(n_groups, period,
...)``, ``mamba_tail`` ``(n_tail, ...)``, one ``shared_attn`` block;
encdec ``enc_blocks`` and ``dec_blocks``), and the reference's
``lax.scan`` over stacked layers is a Python loop over views of them.
Full-sequence attention (causal self-attention, the encoder's and the
cross-attention's non-causal ones) goes through
:func:`repro_torch.models.attention.flash_attention` at every sequence
length (the flash kernels on the card), and every Mamba2 layer through the
SSD kernel (:class:`repro_torch.kernels.ssd.bwd.SSDIntraChunk` under
autograd).

Remat (``forward_train(remat=)``), the reference's four policies, per layer
(per group of the hybrid): ``none``; ``full`` recomputes the block in the
backward (``torch.utils.checkpoint``); ``dots`` keeps the outputs of the
matmul ops (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``) and recomputes
everything else; ``dots_no_batch`` keeps only ``mm`` / ``addmm`` outputs,
the dots without batch dims.  A kernel launched through ctypes is
invisible to the dispatcher, so the flash and SSD Functions' forwards are
recomputed whole (their output buffers are not matmul outputs, so none is
served from the first pass); the gradients equal those under ``none`` bit
for bit.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch import compat
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import _project_qkv, attend_decode, flash_attention, init_attention, split_heads
from repro_torch.models.layers import (
    cross_entropy_loss,
    dense,
    embed,
    gelu,
    init_dense,
    init_embedding,
    init_mlp,
    init_rms_norm,
    init_swiglu,
    is_dtensor,
    maybe_shard,
    mlp,
    rms_norm,
    shard_batch,
    swiglu,
    torch_dtype,
    unembed,
)
from repro_torch.models.moe import init_moe, moe
from repro_torch.models.ssm import (
    init_mamba2_block,
    mamba2_block,
    mamba2_decode_step,
    mamba2_state_shape,
)

__all__ = ["init_model", "forward_prefill", "forward_decode", "forward_train", "init_cache",
           "REMAT_POLICIES"]

REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch")
_aten = torch.ops.aten
_SAVED_DOTS = {
    "dots": {_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default},
    "dots_no_batch": {_aten.mm.default, _aten.addmm.default},
}
AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def _hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    period = cfg.hybrid_attn_period
    n_groups = cfg.n_layers // period
    return period, n_groups, cfg.n_layers - n_groups * period


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_mamba_layers(cfg, lead, dt, generator, dev) -> dict:
    return {
        "ln": init_rms_norm(cfg.d_model, lead=lead, device=dev),
        "block": init_mamba2_block(cfg, dtype=dt, lead=lead, generator=generator, device=dev),
    }


def _init_attn_block(cfg: ModelConfig, dt, generator, dev, lead: tuple = (), *, use_moe: bool = False,
                     cross: bool = False) -> dict:
    kw = dict(dtype=dt, lead=lead, generator=generator, device=dev)
    p = {
        "ln1": init_rms_norm(cfg.d_model, lead=lead, device=dev),
        "attn": init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, qk_norm=cfg.qk_norm, **kw),
        "ln2": init_rms_norm(cfg.d_model, lead=lead, device=dev),
    }
    if use_moe:
        p["moe"] = init_moe(cfg, **kw)
    elif cfg.family == "encdec":
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, **kw)
    else:
        p["mlp"] = init_swiglu(cfg.d_model, cfg.d_ff, **kw)
    if cross:
        p["ln_cross"] = init_rms_norm(cfg.d_model, lead=lead, device=dev)
        p["cross"] = init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, **kw)
    return p


def init_model(
    cfg: ModelConfig,
    *,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Random params in the config's dtype (routers f32), drawn on
    ``device`` (the card by default) from ``generator`` (a generator on
    that device)."""
    dev = resolve_device(device)
    dt = _dt(cfg)
    params: dict[str, Any] = {
        "embed": init_embedding(cfg.vocab_size, cfg.d_model, dtype=dt, generator=generator, device=dev),
        "final_norm": init_rms_norm(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(
            cfg.vocab_size, cfg.d_model, dtype=dt, generator=generator, device=dev
        )
    fam = cfg.family
    kw = dict(dtype=dt, generator=generator, device=dev)
    if fam in ("dense", "vlm", "moe"):
        params["blocks"] = _init_attn_block(cfg, dt, generator, dev, (cfg.n_layers,), use_moe=fam == "moe")
        if fam == "vlm":
            params["projector"] = {"w1": init_dense(cfg.frontend_dim, cfg.d_model, **kw),
                                   "w2": init_dense(cfg.d_model, cfg.d_model, **kw)}
    elif fam == "ssm":
        params["blocks"] = _init_mamba_layers(cfg, (cfg.n_layers,), dt, generator, dev)
    elif fam == "hybrid":
        period, n_groups, n_tail = _hybrid_layout(cfg)
        params["mamba_main"] = _init_mamba_layers(cfg, (n_groups, period), dt, generator, dev)
        if n_tail:
            params["mamba_tail"] = _init_mamba_layers(cfg, (n_tail,), dt, generator, dev)
        params["shared_attn"] = _init_attn_block(cfg, dt, generator, dev)
    elif fam == "encdec":
        params["enc_blocks"] = _init_attn_block(cfg, dt, generator, dev, (cfg.n_enc_layers,))
        params["dec_blocks"] = _init_attn_block(cfg, dt, generator, dev, (cfg.n_layers,), cross=True)
        params["enc_norm"] = init_rms_norm(cfg.d_model, device=dev)
        params["src_proj"] = init_dense(cfg.frontend_dim, cfg.d_model, **kw)
    else:
        raise ValueError(f"unknown family {fam}")
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _index(tree: dict, *idx: int) -> dict:
    """The layer ``idx`` of a stacked params/cache dict (views, no copies)."""
    return {k: _index(v, *idx) if isinstance(v, dict) else v[idx] for k, v in tree.items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked params dict as views, through one
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing each layer would add a zero-filled gradient of the whole
    stack per layer."""
    leaves = {k: _unstack(v, n) if isinstance(v, dict) else torch.unbind(v) for k, v in tree.items()}
    return [{k: v[i] for k, v in leaves.items()} for i in range(n)]


def _accumulate(acc: dict | None, aux: dict | None) -> dict | None:
    """Sum per-layer moe aux terms; a layer without them gives ``None``."""
    if aux is None or acc is None:
        return acc if aux is None else aux
    return {k: acc[k] + aux[k] for k in acc}


def _ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, rows: int | None = None) -> tuple[torch.Tensor, dict | None]:
    if "moe" in p:
        return moe(p["moe"], x, cfg, capacity_factor=cfg.moe_capacity_factor, rows=rows)
    if cfg.family == "encdec":
        return mlp(p["mlp"], x), None
    return swiglu(p["mlp"], x), None


def _cross_kv(p: dict, enc: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention K/V (B, Se, KV, D) of the encoder output."""
    KV, D = cfg.n_kv_heads, cfg.head_dim
    return split_heads(enc @ p["cross"]["wk"]["w"], KV, D), split_heads(enc @ p["cross"]["wv"]["w"], KV, D)


def _attn_block_seq(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    enc_out: torch.Tensor | None = None,
    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    rows: int | None = None,
) -> tuple[torch.Tensor, dict | None, dict]:
    """Full-sequence attention block (training, prefill, encoder) through
    the flash kernels at every S.  With ``enc_out`` (or its precomputed
    ``cross_kv``) a non-causal cross-attention follows the self-attention:
    no RoPE, no qk-norm, Sq != Sk.  ``rows``: the real rows of a padded
    batch (:func:`_pad_batch`), for the moe router.  Returns (x, moe aux or
    None, the self K/V for the cache)."""
    x = shard_batch(x)
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _project_qkv(p["attn"], h, positions, cfg)
    B, S = x.shape[:2]
    out = flash_attention(q, k, v, causal=causal, window=cfg.window)
    x = x + out.reshape(B, S, -1) @ p["attn"]["wo"]["w"]
    if enc_out is not None or cross_kv is not None:
        hc = rms_norm(p["ln_cross"], x, cfg.norm_eps)
        qc = split_heads(hc @ p["cross"]["wq"]["w"], cfg.n_heads, cfg.head_dim)
        kc, vc = cross_kv if cross_kv is not None else _cross_kv(p, enc_out, cfg)
        co = flash_attention(qc, kc, vc, causal=False)
        x = x + co.reshape(B, S, -1) @ p["cross"]["wo"]["w"]
    y, aux = _ffn(p, rms_norm(p["ln2"], x, cfg.norm_eps), cfg, rows)
    return x + y, aux, {"k": k, "v": v}


def _attn_block_decode(
    p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict, pos: int, position: torch.Tensor,
    cross_kv: dict | None = None,
) -> torch.Tensor:
    """One-token attention block against a KV cache (B, Smax, KV, D),
    written in place; sliding-window archs use a ring buffer (Smax = window).
    ``position`` is ``pos`` as a (1,) tensor on the activations' device,
    built once per decode step: a host-to-device copy per layer would block
    the host.  ``cross_kv`` (encdec): the layer's cross K/V of the encoder
    output, every slot valid."""
    B = x.shape[0]
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _project_qkv(p["attn"], h, position, cfg)
    s_max = cache["k"].shape[1]
    ring = cfg.window is not None and s_max == cfg.window
    slot = pos % s_max if ring else min(pos, s_max - 1)
    for name, new in (("k", k), ("v", v)):
        _write_slots(cache[name], new.to(cache[name].dtype), slot)
    valid = torch.full((B,), min(pos + 1, s_max), device=x.device)
    out = attend_decode(q, cache["k"], cache["v"], valid)
    x = x + out.reshape(B, 1, -1) @ p["attn"]["wo"]["w"]
    if cross_kv is not None:
        hc = rms_norm(p["ln_cross"], x, cfg.norm_eps)
        qc = split_heads(hc @ p["cross"]["wq"]["w"], cfg.n_heads, cfg.head_dim)
        full = torch.full((B,), cross_kv["k"].shape[1], device=x.device)
        co = attend_decode(qc, cross_kv["k"], cross_kv["v"], full)
        x = x + co.reshape(B, 1, -1) @ p["cross"]["wo"]["w"]
    return x + _ffn(p, rms_norm(p["ln2"], x, cfg.norm_eps), cfg)[0]


def _mamba_layer(p_l: dict, h: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    h = shard_batch(h)
    y, caches = mamba2_block(p_l["block"], rms_norm(p_l["ln"], h, cfg.norm_eps), cfg)
    return h + y, caches


def _put_states(dst: dict | None, states: dict, *idx: int, rows: int | None = None) -> None:
    """Write a Mamba2 layer's conv and SSM states into a cache leaf at ``idx``
    (under a mesh into each rank's shards, the real rows of a padded batch)."""
    if dst is not None:
        for name in ("conv", "ssm"):
            if is_dtensor(dst[name]):
                compat.assign(dst[name][idx], _real(states[name], rows))
            else:
                dst[name][idx] = states[name]


def _pad_batch(batch: dict) -> tuple[dict, int | None]:
    """A train or prefill batch (``tokens``[, ``labels``, ``loss_mask``,
    ``frontend``]) under a mesh whose rows do not divide the data extent,
    padded to it with zero rows (:func:`repro_torch.compat.pad_rows`), as
    the reference's GSPMD pads it, so every activation shards evenly over
    every data axis; with ``labels`` its ``loss_mask`` leaves the padding
    out of the loss.  Returns the batch and its real row count, the one
    number the padding's readers take (the moe router, the cache writes and
    the logits), or ``None`` where nothing was padded."""
    mesh, tokens = compat.get_abstract_mesh(), batch["tokens"]
    if mesh is None or not is_dtensor(tokens):
        return batch, None
    n = tokens.shape[0]
    n_pad = compat.padded_rows(mesh, n)
    if n_pad == n:
        return batch, None
    if "labels" in batch:
        batch = {**batch, "loss_mask": batch.get("loss_mask", torch.ones_like(batch["labels"]))}
    return {k: compat.pad_rows(v, n_pad) for k, v in batch.items()}, n


def _real(t: torch.Tensor, rows: int | None, dim: int = 0) -> torch.Tensor:
    """The ``rows`` real rows (along ``dim``) of a padded batch's tensor,
    each rank keeping its own (:func:`repro_torch.compat.unpad_rows`);
    ``t`` itself when the batch was not padded."""
    return t if rows is None else compat.unpad_rows(t, rows, dim)


def _embed_inputs(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  frontend_embeds: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings; vlm prepends its projected patch embeddings."""
    x = embed(params["embed"], tokens).to(_dt(cfg))
    if cfg.family == "vlm":
        if frontend_embeds is None:
            raise ValueError("vlm family needs frontend_embeds (patch stub)")
        proj = params["projector"]
        patches = shard_batch(frontend_embeds).to(_dt(cfg))
        x = torch.cat([dense(proj["w2"], gelu(dense(proj["w1"], patches))), shard_batch(x)], dim=1)
    return x


def _unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    if not cfg.logits_vocab_shard:   # no vocab reshard of the table under a mesh
        return (x @ table["table"].T.to(x.dtype)).float()
    return unembed(table, x)


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------


def _save_dots(saved: set, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` under the remat policy ``remat`` (one checkpoint per call)."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; the policies are {REMAT_POLICIES}")
    if remat == "none":
        return fn
    kw = {}
    if remat in _SAVED_DOTS:
        policy = functools.partial(_save_dots, _SAVED_DOTS[remat])
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, policy)

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


# ---------------------------------------------------------------------------
# Layer stacks: one walker per layout, for training (each block or group a
# remat unit) and for prefill (``cache`` takes each layer's K/V or states)
# ---------------------------------------------------------------------------


def _attn_stack(blocks: dict, n: int, cfg: ModelConfig, x: torch.Tensor, remat: str = "none", *,
                causal: bool = True, enc_out: torch.Tensor | None = None, cross: dict | None = None,
                cache: dict | None = None, rows: int | None = None) -> tuple[torch.Tensor, dict | None]:
    """``n`` attention blocks over the whole sequence.  ``enc_out`` (its
    cross K/V computed per block) or ``cross`` (stacked per layer, as
    prefill keeps it) adds the encdec cross-attention; ``cache``
    (``init_cache``'s ``layers``) takes each layer's K/V, of the ``rows``
    real rows of a padded batch.  Returns (x, the summed moe aux terms or
    None)."""
    positions = torch.arange(x.shape[1], device=x.device)

    def block(h, p_l, enc, ckv):
        return _attn_block_seq(p_l, h, cfg, positions, causal=causal, enc_out=enc, cross_kv=ckv, rows=rows)

    run, acc = _remat(block, remat), None
    for i, p_l in enumerate(_unstack(blocks, n)):
        ckv = None if cross is None else (cross["k"][i], cross["v"][i])
        x, aux, kv = run(x, p_l, enc_out, ckv)
        acc = _accumulate(acc, aux)
        if cache is not None:
            for name in ("k", "v"):
                _fill_kv(cache[name][i], kv[name], rows)
    return x, acc


def _ssm_stack(params: dict, cfg: ModelConfig, x: torch.Tensor, remat: str = "none",
               cache: dict | None = None, rows: int | None = None) -> torch.Tensor:
    run = _remat(lambda h, p_l: _mamba_layer(p_l, h, cfg), remat)
    for i, p_l in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        x, states = run(x, p_l)
        _put_states(cache, states, i, rows=rows)
    return x


def _hybrid_stack(params: dict, cfg: ModelConfig, x: torch.Tensor, remat: str = "none",
                  cache: dict | None = None, rows: int | None = None) -> torch.Tensor:
    """Mamba groups, each followed by the shared attention block, then the
    Mamba tail.  The reference's group-level checkpoint: each group of
    ``period`` Mamba2 layers and the shared block is one remat unit; the
    tail's layers are not checkpointed."""
    period, n_groups, n_tail = _hybrid_layout(cfg)
    positions = torch.arange(x.shape[1], device=x.device)

    def group(h, p_group):
        states = []
        for p_l in _unstack(p_group, period):
            h, c = _mamba_layer(p_l, h, cfg)
            states.append(c)
        h, _, kv = _attn_block_seq(params["shared_attn"], h, cfg, positions)
        return h, states, kv

    run = _remat(group, remat)
    for gi, p_group in enumerate(_unstack(params["mamba_main"], n_groups)):
        x, states, kv = run(x, p_group)
        if cache is not None:
            for li, c in enumerate(states):
                _put_states(cache["groups"]["mamba"], c, gi, li, rows=rows)
            for name in ("k", "v"):
                _fill_kv(cache["groups"]["attn"][name][gi], kv[name], rows)
    if n_tail:
        for ti, p_l in enumerate(_unstack(params["mamba_tail"], n_tail)):
            x, c = _mamba_layer(p_l, x, cfg)
            _put_states(None if cache is None else cache["tail"], c, ti, rows=rows)
    return x


def _decoder(params: dict, cfg: ModelConfig, x: torch.Tensor, remat: str = "none",
             cache: dict | None = None, rows: int | None = None) -> tuple[torch.Tensor, dict | None]:
    """The layer stack of every family but encdec; ``cache``: ``init_cache``'s;
    ``rows``: the real rows of a padded batch (:func:`_pad_batch`)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return _attn_stack(params["blocks"], cfg.n_layers, cfg, x, remat,
                           cache=None if cache is None else cache["layers"], rows=rows)
    if cfg.family == "ssm":
        return _ssm_stack(params, cfg, x, remat, None if cache is None else cache["layers"], rows), None
    return _hybrid_stack(params, cfg, x, remat, cache, rows), None


def _encode(params: dict, cfg: ModelConfig, frontend_embeds: torch.Tensor, remat: str = "none") -> torch.Tensor:
    """The encdec encoder over projected frame embeddings (non-causal)."""
    src = dense(params["src_proj"], shard_batch(frontend_embeds).to(_dt(cfg)))
    enc, _ = _attn_stack(params["enc_blocks"], cfg.n_enc_layers, cfg, src, remat, causal=False)
    return rms_norm(params["enc_norm"], enc, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _encdec_train(params: dict, cfg: ModelConfig, batch: dict, remat: str) -> tuple[torch.Tensor, dict]:
    enc = _encode(params, cfg, batch["frontend"], remat)
    x = embed(params["embed"], batch["tokens"]).to(_dt(cfg))
    x, _ = _attn_stack(params["dec_blocks"], cfg.n_layers, cfg, x, remat, enc_out=enc)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = maybe_shard(_unembed(params, cfg, x), ("pod", "data"), None, "model")
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"ce_loss": loss}


def forward_train(
    params: dict, cfg: ModelConfig, batch: dict, *, remat: str = "dots"
) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy.  batch: ``tokens`` (B, S), ``labels``
    (B, S)[, ``loss_mask`` (B, S)][, ``frontend``: vlm patch embeddings
    (B, frontend_tokens, frontend_dim), encdec frame embeddings
    (B, S_src, frontend_dim)] on the params' device.

    Returns (total loss, metrics) with the reference's keys: ``ce_loss``
    and the moe terms (each layer's summed, divided by ``n_layers``; zeros
    for families without experts), the total ``ce + 0.01 lb + 0.001 z``;
    encdec returns ``ce_loss`` alone.  ``remat`` is one of
    :data:`REMAT_POLICIES` (module docstring).  Under a mesh a batch that
    does not divide the data extent is padded to it (:func:`_pad_batch`);
    the padding enters no loss and no metric."""
    batch, rows = _pad_batch(batch)
    if cfg.family == "encdec":
        return _encdec_train(params, cfg, batch, remat)
    x = _embed_inputs(params, cfg, batch["tokens"], batch.get("frontend"))
    x, acc = _decoder(params, cfg, x, remat, rows=rows)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.family == "vlm":   # only text positions carry labels
        x = x[:, cfg.frontend_tokens :, :]
    logits = maybe_shard(_unembed(params, cfg, x), ("pod", "data"), None, "model")
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
    n_layers = max(cfg.n_layers, 1)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    metrics = {"ce_loss": loss}
    metrics.update({k: zero if acc is None else acc[k] / n_layers for k in AUX_KEYS})
    return loss + 0.01 * metrics["moe_lb_loss"] + 0.001 * metrics["moe_z_loss"], metrics


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, device: str | torch.device | None = None
) -> dict:
    """Zeroed cache (KV in the config's dtype, SSM states f32) on ``device``
    (the card by default).  encdec's ``"cross"`` stays ``None`` until
    prefill fills it."""
    dev = resolve_device(device)
    dt = _dt(cfg)
    kv_len = min(max_len, cfg.window) if cfg.window else max_len

    def kv(lead: int) -> dict:
        shape = (lead, batch, kv_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=dev), "v": torch.zeros(shape, dtype=dt, device=dev)}

    def mamba(lead: tuple) -> dict:
        shapes = mamba2_state_shape(cfg, batch)
        return {"conv": torch.zeros(lead + shapes["conv"], dtype=dt, device=dev),
                "ssm": torch.zeros(lead + shapes["ssm"], dtype=torch.float32, device=dev)}

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return {"layers": kv(cfg.n_layers)}
    if fam == "ssm":
        return {"layers": mamba((cfg.n_layers,))}
    if fam == "encdec":
        return {"layers": kv(cfg.n_layers), "cross": None}
    if fam != "hybrid":
        raise ValueError(f"unknown family {fam}")
    period, n_groups, n_tail = _hybrid_layout(cfg)
    out = {"groups": {"mamba": mamba((n_groups, period)), "attn": kv(n_groups)}}
    if n_tail:
        out["tail"] = mamba((n_tail,))
    return out


def _write_slots(dst: torch.Tensor, x: torch.Tensor, start: int, rows: int | None = None) -> None:
    """``dst[..., start : start + n, :, :] = x`` for K/V (..., n, KV, D);
    under a mesh into each rank's shards of the cache, the ``rows`` real
    rows of a padded batch."""
    if is_dtensor(dst):
        compat.write_into(dst, x, -3, start, rows)
    else:
        dst[..., start : start + x.shape[-3], :, :] = x


def _fill_kv(dst: torch.Tensor, x: torch.Tensor, rows: int | None = None) -> None:
    """Write prefill K/V (..., S, KV, D) into a zeroed serving cache
    (..., kv_len, KV, D).

    Sliding-window caches are ring buffers indexed ``slot = pos % window``:
    the kept tail of the prompt goes to its ring slots so later decode
    writes land consistently.  The slots of the tail are a rotation of one
    range: token ``S - kv_len + j`` lands in slot ``(j + S) % kv_len``, so
    two slice copies fill it.
    """
    S, kv_len = x.shape[-3], dst.shape[-3]
    if S > kv_len:   # ring buffer: token t -> slot t % window
        tail, r = x[..., S - kv_len :, :, :], S % kv_len
        _write_slots(dst, tail[..., : kv_len - r, :, :], r, rows)
        _write_slots(dst, tail[..., kv_len - r :, :, :], 0, rows)
    else:
        _write_slots(dst, x, 0, rows)


@torch.no_grad()
def forward_prefill(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    frontend_embeds: torch.Tensor | None = None,
    max_len: int | None = None,
    place_cache: Callable[[dict], dict] | None = None,
) -> tuple[torch.Tensor, dict]:
    """Process a full prompt; returns (last-position logits (B, V) f32, cache).

    ``frontend_embeds``: vlm patch embeddings (B, frontend_tokens,
    frontend_dim), prepended, so the cache holds ``S + frontend_tokens``
    positions; encdec frame embeddings (B, S_src, frontend_dim): the
    encoder runs once and each decoder layer's cross K/V lands in the
    cache's ``"cross"``.  Runs without autograd (no graph, even for params
    that require grad).

    ``place_cache`` lays out the fresh :func:`init_cache` before prefill
    fills it (a meshed dry run places it as DTensors,
    :func:`repro_torch.launch.cells.build_cell`); the reference leaves that
    to GSPMD's propagation.  Under a mesh a batch that does not divide the
    data extent runs padded to it (:func:`_pad_batch`); the cache and the
    logits take its real rows."""
    place = place_cache or (lambda c: c)
    inputs = {"tokens": tokens} if frontend_embeds is None else {"tokens": tokens, "frontend": frontend_embeds}
    inputs, rows = _pad_batch(inputs)
    tokens, frontend_embeds = inputs["tokens"], inputs.get("frontend")
    B = tokens.shape[0] if rows is None else rows
    if cfg.family == "encdec":
        if frontend_embeds is None:
            raise ValueError("encdec family needs frontend_embeds (frame stub)")
        enc = _encode(params, cfg, frontend_embeds)
        kv = [_cross_kv(p_l, enc, cfg) for p_l in _unstack(params["dec_blocks"], cfg.n_layers)]
        cross = {"k": torch.stack([k for k, _ in kv]), "v": torch.stack([v for _, v in kv])}
        del kv, enc
        x = embed(params["embed"], tokens).to(_dt(cfg))
        cache = place(init_cache(cfg, B, max_len or x.shape[1], device=x.device))
        cache["cross"] = {name: _real(t, rows, 1) for name, t in cross.items()}
        x, _ = _attn_stack(params["dec_blocks"], cfg.n_layers, cfg, x, cross=cross, cache=cache["layers"], rows=rows)
    else:
        x = _embed_inputs(params, cfg, tokens, frontend_embeds)
        cache = place(init_cache(cfg, B, max_len or x.shape[1], device=x.device))
        x, _ = _decoder(params, cfg, x, cache=cache, rows=rows)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _real(_unembed(params, cfg, x[:, -1:, :])[:, 0, :], rows), cache


@torch.no_grad()
def forward_decode(
    params: dict, cfg: ModelConfig, token: torch.Tensor, cache: dict, pos: int
) -> tuple[torch.Tensor, dict]:
    """One decode step. token (B, 1) -> (logits (B, V) f32, cache).  ``pos``
    is the token's position (vlm: after the ``frontend_tokens`` patches).

    Unlike the reference, which returns a new cache, this writes the new
    K/V rows and SSM/conv states into ``cache`` in place (a copy of the
    whole KV cache per token would be wasted bytes) and returns it.  Runs
    without autograd."""
    x = embed(params["embed"], token).to(_dt(cfg))
    position = torch.tensor([pos], device=x.device)
    fam = cfg.family

    def mamba_step(p_l, c_stack, *idx):
        nonlocal x
        h2 = rms_norm(p_l["ln"], x, cfg.norm_eps)
        y, new_c = mamba2_decode_step(p_l["block"], h2, _index(c_stack, *idx), cfg)
        _put_states(c_stack, new_c, *idx)
        x = x + y

    if fam in ("dense", "moe", "vlm", "encdec"):
        layers, cross = cache["layers"], cache.get("cross")
        blocks = params["dec_blocks" if fam == "encdec" else "blocks"]
        for i, p_l in enumerate(_unstack(blocks, cfg.n_layers)):
            ckv = None if cross is None else _index(cross, i)
            x = _attn_block_decode(p_l, x, cfg, _index(layers, i), pos, position, ckv)
    elif fam == "ssm":
        for i, p_l in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            mamba_step(p_l, cache["layers"], i)
    else:
        period, n_groups, n_tail = _hybrid_layout(cfg)
        groups = cache["groups"]
        for gi in range(n_groups):
            for li in range(period):
                mamba_step(_index(params["mamba_main"], gi, li), groups["mamba"], gi, li)
            x = _attn_block_decode(params["shared_attn"], x, cfg, _index(groups["attn"], gi), pos, position)
        for ti in range(n_tail):
            mamba_step(_index(params["mamba_tail"], ti), cache["tail"], ti)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x)[:, 0, :], cache
