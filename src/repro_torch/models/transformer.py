"""Model assembly for the language models the port runs.

* ``init_model(cfg, generator=, device=)``          -> params dict
* ``forward_train(params, cfg, batch, remat=)``     -> (loss, metrics)
* ``forward_prefill(params, cfg, tokens, max_len=)`` -> (logits, cache)
* ``forward_decode(params, cfg, token, cache, pos)`` -> (logits, cache)
* ``init_cache(cfg, batch, max_len, device=)``      -> cache dict

Ported: serving for ``dense`` (pre-norm GQA + SwiGLU decoder, e.g. Qwen3,
with sliding windows as ring-buffer caches) and ``hybrid`` (Zamba2: a
Mamba2 backbone with ONE shared attention+SwiGLU block applied every
``hybrid_attn_period`` layers), training for ``dense``.  The parameter and
cache layouts are the reference's: dense ``blocks`` leaves and the
``layers`` K/V cache are stacked ``(n_layers, ...)``; hybrid
``mamba_main`` leaves ``(n_groups, period, ...)``, ``mamba_tail`` leaves
``(n_tail, ...)``, ``shared_attn`` is one block.  The reference's
``lax.scan`` over stacked layers is a Python loop over views of the
stacked tensors.  Full-sequence
attention goes through :func:`repro_torch.models.attention.flash_attention`
at every sequence length (the flash kernels on the card), and every Mamba2
layer through the SSD kernel.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import _project_qkv, attend_decode, flash_attention, init_attention
from repro_torch.models.layers import (
    cross_entropy_loss,
    embed,
    init_embedding,
    init_rms_norm,
    init_swiglu,
    rms_norm,
    swiglu,
    torch_dtype,
    unembed,
)
from repro_torch.models.ssm import (
    init_mamba2_block,
    mamba2_block,
    mamba2_decode_step,
    mamba2_state_shape,
)

__all__ = ["init_model", "forward_prefill", "forward_decode", "forward_train", "init_cache",
           "REMAT_POLICIES"]

# what each family has in the port so far
SERVED_FAMILIES = ("dense", "hybrid")
TRAINED_FAMILIES = ("dense",)
REMAT_POLICIES = ("none", "full")   # the reference's "dots" policies: ROADMAP.md queue A item 3


def _require(cfg: ModelConfig, families: tuple[str, ...], what: str) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"{what} for family {cfg.family!r} is not ported yet (ROADMAP.md queue A item 3: "
            f"hybrid training and the moe/ssm/vlm/encdec families come in later slices); "
            f"serving is ported for {SERVED_FAMILIES}, training for {TRAINED_FAMILIES}"
        )


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


def _init_attn_block(cfg: ModelConfig, dt, generator, dev, lead: tuple = ()) -> dict:
    return {
        "ln1": init_rms_norm(cfg.d_model, lead=lead, device=dev),
        "attn": init_attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qk_norm=cfg.qk_norm, dtype=dt, lead=lead, generator=generator, device=dev,
        ),
        "ln2": init_rms_norm(cfg.d_model, lead=lead, device=dev),
        "mlp": init_swiglu(cfg.d_model, cfg.d_ff, dtype=dt, lead=lead, generator=generator, device=dev),
    }


def init_model(
    cfg: ModelConfig,
    *,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Random params in the config's dtype, drawn on ``device`` (the card by
    default) from ``generator`` (a generator on that device)."""
    _require(cfg, SERVED_FAMILIES + TRAINED_FAMILIES, "init_model")
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    params: dict[str, Any] = {
        "embed": init_embedding(cfg.vocab_size, cfg.d_model, dtype=dt, generator=generator, device=dev),
        "final_norm": init_rms_norm(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(
            cfg.vocab_size, cfg.d_model, dtype=dt, generator=generator, device=dev
        )
    if cfg.family == "dense":
        params["blocks"] = _init_attn_block(cfg, dt, generator, dev, lead=(cfg.n_layers,))
        return params
    period, n_groups, n_tail = _hybrid_layout(cfg)
    params["mamba_main"] = _init_mamba_layers(cfg, (n_groups, period), dt, generator, dev)
    if n_tail:
        params["mamba_tail"] = _init_mamba_layers(cfg, (n_tail,), dt, generator, dev)
    params["shared_attn"] = _init_attn_block(cfg, dt, generator, dev)
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


def _attn_block_seq(
    p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
) -> tuple[torch.Tensor, dict]:
    """Causal full-sequence attention block (training, prefill) through
    the flash kernels at every S; returns (x, its K/V for the cache)."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _project_qkv(p["attn"], h, positions, cfg)
    B, S = x.shape[:2]
    out = flash_attention(q, k, v, causal=True, window=cfg.window)
    x = x + out.reshape(B, S, -1) @ p["attn"]["wo"]["w"]
    x = x + swiglu(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps))
    return x, {"k": k, "v": v}


def _attn_block_decode(
    p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict, pos: int, position: torch.Tensor
) -> torch.Tensor:
    """One-token attention block against a KV cache (B, Smax, KV, D),
    written in place; sliding-window archs use a ring buffer (Smax = window).
    ``position`` is ``pos`` as a (1,) tensor on the activations' device,
    built once per decode step: a host-to-device copy per layer would block
    the host."""
    B = x.shape[0]
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _project_qkv(p["attn"], h, position, cfg)
    s_max = cache["k"].shape[1]
    ring = cfg.window is not None and s_max == cfg.window
    slot = pos % s_max if ring else min(pos, s_max - 1)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    valid = torch.full((B,), min(pos + 1, s_max), device=x.device)
    out = attend_decode(q, cache["k"], cache["v"], valid)
    x = x + out.reshape(B, 1, -1) @ p["attn"]["wo"]["w"]
    return x + swiglu(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps))


def _mamba_layer(p_l: dict, h: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    y, caches = mamba2_block(p_l["block"], rms_norm(p_l["ln"], h, cfg.norm_eps), cfg)
    return h + y, caches


def _stack(caches: list[dict]) -> dict:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _decoder_stack_seq(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict) -> torch.Tensor:
    """The dense decoder over a whole prompt; writes each layer's K/V
    straight into ``cache`` (``init_cache``'s ``layers``) and returns x."""
    positions = torch.arange(x.shape[1], device=x.device)
    for i, p_l in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        x, c = _attn_block_seq(p_l, x, cfg, positions)
        for name in ("k", "v"):
            _fill_kv(cache[name][i], c[name])
    return x


def _hybrid_stack_seq(params: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Mamba groups, each followed by the shared attention block, then the
    Mamba tail.  Returns (x, caches) with the reference's stacked layout."""
    period, n_groups, n_tail = _hybrid_layout(cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    group_m, group_a = [], []
    for gi in range(n_groups):
        layer_caches = []
        for li in range(period):
            x, c = _mamba_layer(_index(params["mamba_main"], gi, li), x, cfg)
            layer_caches.append(c)
        x, a = _attn_block_seq(params["shared_attn"], x, cfg, positions)
        group_m.append(_stack(layer_caches))
        group_a.append(a)
    tail = []
    for ti in range(n_tail):
        x, c = _mamba_layer(_index(params["mamba_tail"], ti), x, cfg)
        tail.append(c)
    return x, {"groups": {"mamba": _stack(group_m), "attn": _stack(group_a)},
               "tail": _stack(tail) if tail else None}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, device: str | torch.device | None = None
) -> dict:
    """Zeroed cache (KV in the config's dtype, SSM states f32) on ``device``
    (the card by default)."""
    _require(cfg, SERVED_FAMILIES, "init_cache")
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    kv_len = min(max_len, cfg.window) if cfg.window else max_len

    def kv(lead: int) -> dict:
        shape = (lead, batch, kv_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=dev), "v": torch.zeros(shape, dtype=dt, device=dev)}

    if cfg.family == "dense":
        return {"layers": kv(cfg.n_layers)}
    period, n_groups, n_tail = _hybrid_layout(cfg)
    shapes = mamba2_state_shape(cfg, batch)

    def mamba(lead):
        return {"conv": torch.zeros(lead + shapes["conv"], dtype=dt, device=dev),
                "ssm": torch.zeros(lead + shapes["ssm"], dtype=torch.float32, device=dev)}

    out = {"groups": {"mamba": mamba((n_groups, period)), "attn": kv(n_groups)}}
    if n_tail:
        out["tail"] = mamba((n_tail,))
    return out


def _fill_kv(dst: torch.Tensor, x: torch.Tensor) -> None:
    """Write prefill K/V (..., S, KV, D) into a zeroed serving cache
    (..., kv_len, KV, D).

    Sliding-window caches are ring buffers indexed ``slot = pos % window``:
    the kept tail of the prompt is scattered to its ring slots so later
    decode writes land consistently.
    """
    S, kv_len = x.shape[-3], dst.shape[-3]
    if S > kv_len:   # ring buffer: token t -> slot t % window
        slots = torch.arange(S - kv_len, S, device=x.device) % kv_len
        dst[..., slots, :, :] = x[..., S - kv_len :, :, :]
    else:
        dst[..., :S, :, :] = x


def _pad_kv(caches: dict, cfg: ModelConfig, max_len: int) -> dict:
    """Pad prefill K/V (L, B, S, KV, D) to the serving cache length."""
    kv_len = min(max_len, cfg.window) if cfg.window else max_len

    def pad(x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] == kv_len:
            return x
        out = x.new_zeros(x.shape[:2] + (kv_len,) + x.shape[3:])
        _fill_kv(out, x)
        return out

    return {k: pad(v) for k, v in caches.items()}


@torch.no_grad()
def forward_prefill(
    params: dict, cfg: ModelConfig, tokens: torch.Tensor, *, max_len: int | None = None
) -> tuple[torch.Tensor, dict]:
    """Process a full prompt; returns (last-position logits (B, V) f32, cache).
    Runs without autograd (no graph, even for params that require grad)."""
    _require(cfg, SERVED_FAMILIES, "forward_prefill")
    x = embed(params["embed"], tokens).to(torch_dtype(cfg.dtype))
    max_len = max_len or x.shape[1]
    if cfg.family == "dense":
        cache = init_cache(cfg, x.shape[0], max_len, device=x.device)
        x = _decoder_stack_seq(params, cfg, x, cache["layers"])
        x = rms_norm(params["final_norm"], x, cfg.norm_eps)
        return _unembed(params, cfg, x[:, -1:, :])[:, 0, :], cache
    x, caches = _hybrid_stack_seq(params, cfg, x)
    cache = {"groups": {"mamba": caches["groups"]["mamba"],
                        "attn": _pad_kv(caches["groups"]["attn"], cfg, max_len)}}
    if caches["tail"] is not None:
        cache["tail"] = caches["tail"]
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x[:, -1:, :])[:, 0, :], cache


def _unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return unembed(params["embed"] if cfg.tie_embeddings else params["unembed"], x)


@torch.no_grad()
def forward_decode(
    params: dict, cfg: ModelConfig, token: torch.Tensor, cache: dict, pos: int
) -> tuple[torch.Tensor, dict]:
    """One decode step. token (B, 1) -> (logits (B, V) f32, cache).

    Unlike the reference, which returns a new cache, this writes the new
    K/V rows and SSM/conv states into ``cache`` in place (a copy of the
    whole KV cache per token would be wasted bytes) and returns it.  Runs
    without autograd."""
    _require(cfg, SERVED_FAMILIES, "forward_decode")
    x = embed(params["embed"], token).to(torch_dtype(cfg.dtype))
    position = torch.tensor([pos], device=x.device)
    if cfg.family == "dense":
        layers = cache["layers"]
        for i, p_l in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            x = _attn_block_decode(p_l, x, cfg, _index(layers, i), pos, position)
        x = rms_norm(params["final_norm"], x, cfg.norm_eps)
        return _unembed(params, cfg, x)[:, 0, :], cache
    period, n_groups, n_tail = _hybrid_layout(cfg)

    def mamba_step(p_l, c_stack, *idx):
        nonlocal x
        h2 = rms_norm(p_l["ln"], x, cfg.norm_eps)
        y, new_c = mamba2_decode_step(p_l["block"], h2, _index(c_stack, *idx), cfg)
        for k, v in new_c.items():
            c_stack[k][idx] = v
        x = x + y

    groups = cache["groups"]
    for gi in range(n_groups):
        for li in range(period):
            mamba_step(_index(params["mamba_main"], gi, li), groups["mamba"], gi, li)
        x = _attn_block_decode(params["shared_attn"], x, cfg, _index(groups["attn"], gi), pos, position)
    for ti in range(n_tail):
        mamba_step(_index(params["mamba_tail"], ti), cache["tail"], ti)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x)[:, 0, :], cache


def forward_train(
    params: dict, cfg: ModelConfig, batch: dict, *, remat: str = "full"
) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy of a dense decoder.  batch: ``tokens``
    (B, S), ``labels`` (B, S)[, ``loss_mask`` (B, S)] on the params' device.
    Returns (total loss, metrics) with the reference's metric keys; the moe
    terms are zeros, so the total is the CE loss.

    ``remat="full"`` recomputes each block in the backward
    (``torch.utils.checkpoint``, the reference's ``nothing_saveable``), so
    the flash forward runs twice per layer; ``"none"`` keeps every
    activation."""
    _require(cfg, TRAINED_FAMILIES, "forward_train")
    if remat not in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat={remat!r} is not ported yet (ROADMAP.md queue A item 3); ported: {REMAT_POLICIES}"
        )
    x = embed(params["embed"], batch["tokens"]).to(torch_dtype(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)

    def block(h: torch.Tensor, p_l: dict) -> torch.Tensor:
        return _attn_block_seq(p_l, h, cfg, positions)[0]

    for p_l in _unstack(params["blocks"], cfg.n_layers):
        x = checkpoint(block, x, p_l, use_reentrant=False) if remat == "full" else block(x, p_l)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    loss = cross_entropy_loss(_unembed(params, cfg, x), batch["labels"], batch.get("loss_mask"))
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"ce_loss": loss, "moe_lb_loss": zero, "moe_z_loss": zero, "moe_drop_frac": zero}
