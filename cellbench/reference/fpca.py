"""The FPCA frontend in plain PyTorch: the yardstick of every cell's counts.

A frozen copy of the configuration's mathematics, written from the paper's
equations and imported from nowhere else:

* weight encoding: a float kernel ``(c_o, k, k, c_i)`` becomes positive and
  negative conductance planes, ``|w| / w_scale`` clipped to [0, 1] and
  quantised to ``nvm_levels`` levels, zero-padded to the physical
  ``max_kernel`` and flattened channel-major ``(c_i, n, n)``;
* window extraction: one ``(c_i * n * n)`` photocurrent vector per output
  window, channel-major;
* the bucket-select curvefit (paper section 4) as its monomial basis: every
  bucket surface ``f_i(I, W) = sum_ab c_iab I^a W^b`` summed over a window is
  ``sum_ab c_iab S_ab`` with ``S_ab = sum_j I_j^a W_j^b``, gated by the
  paired sigmoids of the step-1 estimate ``f_avg(mean I, mean W)``;
* the single-slope ADC: ``clip(bn + clip(round(v+ / lsb)) - clip(round(v- / lsb)))``.

``mode="float64"`` is the reference.  ``mode="tf32"`` is the control: the
same arithmetic in float32 with every matrix product's operands rounded to
TF32's 10-bit mantissa (round to nearest even), what a float32 program gets
when it lets the tensor cores take its float32 products.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MODES = ("float64", "tf32")


def dtype_of(mode: str) -> torch.dtype:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    return torch.float64 if mode == "float64" else torch.float32


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (sign, 8 exponent bits, 10 mantissa
    bits), to nearest, ties to even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ b`` in the mode's precision; TF32 rounds both operands and sums
    in float32."""
    if mode == "tf32":
        return to_tf32(a) @ to_tf32(b)
    return a @ b


def encode_weights(kernel: torch.Tensor, cfg: dict, mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(w_pos, w_neg)``, each ``(c_o, c_i * n * n)`` in [0, 1]."""
    dt = dtype_of(mode)
    c_o, k, _, c_i = kernel.shape
    n = cfg["max_kernel"]
    levels = cfg["nvm_levels"] - 1
    w = kernel.to(dt)
    w01 = (w.abs() / cfg["w_scale"]).clamp(0.0, 1.0)
    planes = []
    for keep in (w > 0, w < 0):
        q = torch.round(torch.where(keep, w01, torch.zeros_like(w01)) * levels) / levels
        q = F.pad(q.permute(0, 3, 1, 2), (0, n - k, 0, n - k))
        planes.append(q.reshape(c_o, c_i * n * n))
    return planes[0], planes[1]


def output_dims(cfg: dict) -> tuple[int, int]:
    if cfg["binning"] != 1 or cfg["padding"] != 0:
        raise ValueError("the reference covers unbinned, unpadded frames, as every configuration here")
    n, s = cfg["max_kernel"], cfg["stride"]
    return (cfg["image_h"] - n) // s + 1, (cfg["image_w"] - n) // s + 1


def extract_windows(images: torch.Tensor, cfg: dict, mode: str) -> torch.Tensor:
    """``(B, H, W, c_i)`` frames -> ``(B, h_o, w_o, c_i * n * n)`` windows."""
    n, s = cfg["max_kernel"], cfg["stride"]
    h_o, w_o = output_dims(cfg)
    win = images.to(dtype_of(mode)).unfold(1, n, s).unfold(2, n, s)[:, :h_o, :w_o]   # (B, h_o, w_o, c, n, n)
    return win.reshape(win.shape[0], h_o, w_o, -1)


def analog_read(patches: torch.Tensor, w: torch.Tensor, calib: dict, mode: str) -> torch.Tensor:
    """Bitline voltages ``(M, C)`` of windows ``patches (M, N)`` against the
    conductance planes ``w (C, N)``: the sigmoid-gated bucket model."""
    dt = dtype_of(mode)
    x = patches.to(dt)
    wt = w.to(dt).T                                            # (N, C)
    n = x.shape[1]
    exps = [tuple(int(v) for v in e) for e in calib["bucket_exps"]]
    deg = max(a + b for a, b in exps)
    xp = [torch.ones_like(x)]
    wp = [torch.ones_like(wt)]
    for _ in range(deg):
        xp.append(xp[-1] * x)
        wp.append(wp[-1] * wt)
    # S_ab = sum_j x_j^a w_j^b, one product per power of x over every power of w
    s = {}
    for a in range(deg + 1):
        bs = [b for (aa, b) in exps if aa == a]
        prod = matmul(xp[a], torch.cat([wp[b] for b in bs], dim=1), mode)
        for i, b in enumerate(bs):
            s[(a, b)] = prod[:, i * wt.shape[1] : (i + 1) * wt.shape[1]]
    mean_i = s[(1, 0)] / n
    mean_w = s[(0, 1)] / n
    avg = torch.zeros_like(mean_i)
    for c, (a, b) in zip(calib["f_avg_coeffs"], calib["f_avg_exps"]):
        avg = avg + float(c) * mean_i ** int(a) * mean_w ** int(b)
    xg = avg / calib["v_range"]
    nb = len(calib["v_centers"])
    k = calib["sharpness"]
    v = torch.zeros_like(xg)
    for i in range(nb):
        lo, hi = i / nb, (i + 1) / nb
        gate = torch.sigmoid(k * (xg - lo)) + torch.sigmoid(k * (hi - xg)) - 1.0
        summed = torch.zeros_like(xg)
        for (a, b), c in zip(exps, calib["bucket_coeffs"][i]):
            summed = summed + float(c) * s[(a, b)]
        vc = float(calib["v_centers"][i])
        v = v + gate * ((summed - n * vc) / calib["n_sweep"] + vc)
    return v


def ss_adc(v_pos: torch.Tensor, v_neg: torch.Tensor, bn_offset: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Up/down count from the BN offset, clipped to the ADC's range."""
    levels = 2 ** cfg["adc_bits"]
    lsb = cfg["adc_v_ref"] / levels
    top = levels - 1
    up = torch.round(v_pos / lsb).clamp(0, top)
    down = torch.round(v_neg / lsb).clamp(0, top)
    return (bn_offset.to(v_pos.dtype) + up - down).clamp(0, top)


def counts(images: torch.Tensor, kernel: torch.Tensor, bn_offset: torch.Tensor, calib: dict, cfg: dict,
           mode: str = "float64", block_rows: int = 1 << 19) -> torch.Tensor:
    """SS-ADC counts ``(B, h_o, w_o, c_o)`` of ``images``, computed in blocks
    of ``block_rows`` windows so that a full batch fits beside the program."""
    w_pos, w_neg = encode_weights(kernel, cfg, mode)
    h_o, w_o = output_dims(cfg)
    B = images.shape[0]
    frames_per_block = max(1, block_rows // (h_o * w_o))
    out = []
    for f0 in range(0, B, frames_per_block):
        win = extract_windows(images[f0 : f0 + frames_per_block], cfg, mode)
        flat = win.reshape(-1, win.shape[-1])
        v_pos = analog_read(flat, w_pos, calib, mode)
        v_neg = analog_read(flat, w_neg, calib, mode)
        c = ss_adc(v_pos, v_neg, bn_offset, cfg)
        out.append(c.reshape(win.shape[0], h_o, w_o, -1))
    return torch.cat(out)


def head_logits(counts_map: torch.Tensor, head: list[dict], cfg: dict, mode: str = "float64") -> torch.Tensor:
    """The dense head on ``(B, h_o, w_o, c_o)`` counts: NHWC flatten, then
    each layer ``x @ w + b`` and its activation."""
    dt = dtype_of(mode)
    x = counts_map.to(dt).reshape(counts_map.shape[0], -1) * float(cfg.get("input_scale", 1.0))
    for layer, spec in zip(head, cfg["head"]):
        x = matmul(x, layer["w"].to(dt), mode) + layer["b"].to(dt)
        if spec.get("activation") == "relu":
            x = torch.relu(x)
        elif spec.get("activation") not in (None, ""):
            raise ValueError(f"the reference head knows relu only, not {spec['activation']!r}")
    return x


def window_blocks(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """For each window and each pixel of its ``n x n`` footprint, the flat
    index of the skip block the pixel lies in, and whether it lies inside the
    frame; ``(h_o * w_o, n * n)`` each."""
    n, s, blk = cfg["max_kernel"], cfg["stride"], cfg["skip_block"]
    eff_h, eff_w = cfg["image_h"], cfg["image_w"]
    h_o, w_o = output_dims(cfg)
    bw = math.ceil(eff_w / blk)
    rows = (np.arange(h_o)[:, None] * s + np.arange(n)[None, :])[:, None, :, None]
    cols = (np.arange(w_o)[:, None] * s + np.arange(n)[None, :])[None, :, None, :]
    inside = (rows < eff_h) & (cols < eff_w)
    idx = np.where(inside, (rows // blk) * bw + cols // blk, 0)
    return idx.reshape(h_o * w_o, n * n), inside.reshape(h_o * w_o, n * n)


def window_mask_from_blocks(block_keep: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``(..., bh, bw)`` block keep grids -> ``(..., h_o, w_o)`` window keep:
    a window runs iff a pixel of its footprint inside the effective frame
    lies in a kept block."""
    idx, inside = window_blocks(cfg)
    idx = torch.as_tensor(idx, device=block_keep.device)
    inside = torch.as_tensor(inside, device=block_keep.device)
    lead = block_keep.shape[:-2]
    flat = block_keep.reshape(lead + (-1,))
    return (flat[..., idx] & inside).any(-1).reshape(lead + output_dims(cfg))
