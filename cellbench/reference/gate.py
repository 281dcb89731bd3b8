"""The temporal delta gate in plain PyTorch, and a camera stream through it.

A frozen copy of the gate's state machine (paper section 3.4.5 with a
temporal delta): the effective frame is the grayscale frame, a skip
block counts as changed when its mean absolute change since the previous
frame exceeds the threshold, and

* block ages start at ``hysteresis + 1``; once a previous frame exists an
  age resets to 0 on a change and grows by one otherwise;
* a tick is a keyframe on the first frame and whenever
  ``keyframe_interval > 0`` divides the frame index;
* a block is kept on a keyframe or while its age is at most
  ``hysteresis``; a window runs iff its footprint touches a kept block.

The block means are taken in float32, the configuration's precision, in a
fixed order: channels summed left to right times the float32 reciprocal of
their count, then the block's sum over its pixels divided by its pixel
count.  The same means in float64 mark the blocks whose float32 decision is
a tie: within ``tie`` of the threshold, where a float32 program may decide
either way.

A camera stream then runs the frontend and the head on the gated windows:
a kept window takes the tick's counts, a skipped one keeps its previous
value in the effective activation map, and the head reads that map.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cellbench.reference import fpca


def effective_frame(frames: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Frames ``(..., H, W, c_i)`` -> grayscale ``(..., H, W)`` (the
    configurations bin nothing)."""
    img = frames.to(dtype)
    acc = img[..., 0]
    for c in range(1, img.shape[-1]):
        acc = acc + img[..., c]
    return acc * float(np.float32(1.0 / img.shape[-1])) if dtype == torch.float32 else acc / img.shape[-1]


def block_delta(prev: torch.Tensor, cur: torch.Tensor, block: int) -> torch.Tensor:
    """Mean |cur - prev| over ``block x block`` tiles (edge tiles average
    their real pixels)."""
    h, w = cur.shape[-2:]
    bh, bw = math.ceil(h / block), math.ceil(w / block)
    d = torch.nn.functional.pad((cur - prev).abs(), (0, bw * block - w, 0, bh * block - h))
    sums = d.reshape(cur.shape[:-2] + (bh, block, bw, block)).sum((-3, -1))
    ones = np.zeros((bh * block, bw * block))
    ones[:h, :w] = 1.0
    count = torch.as_tensor(ones.reshape(bh, block, bw, block).sum((1, 3)), dtype=cur.dtype, device=cur.device)
    return sums / count


def gate_masks(frames: torch.Tensor, cfg: dict, gate: dict, tie: float) -> dict:
    """Run the gate over one camera's frames ``(T, H, W, c_i)`` from a fresh
    state.  Returns per tick ``keep (T, bh, bw)``, ``keyframe (T,)`` and
    ``tie (T, bh, bw)``: blocks whose float64 mean change lies within
    ``tie`` of the threshold."""
    dev = frames.device
    thr32 = torch.tensor(gate["threshold"], dtype=torch.float32, device=dev)
    hyst, interval = int(gate["hysteresis"]), int(gate["keyframe_interval"])
    blk = cfg["skip_block"]
    fpca.output_dims(cfg)                # raises on a configuration this reference does not cover
    eff32 = effective_frame(frames)
    eff64 = effective_frame(frames, torch.float64)
    T = frames.shape[0]
    bh, bw = math.ceil(eff32.shape[-2] / blk), math.ceil(eff32.shape[-1] / blk)
    age = torch.full((bh, bw), hyst + 1, dtype=torch.int32, device=dev)
    keeps, keyframes, ties = [], [], []
    for t in range(T):
        if t == 0:
            tied = torch.zeros((bh, bw), dtype=torch.bool, device=dev)
        else:
            changed = block_delta(eff32[t - 1], eff32[t], blk) > thr32
            age = torch.where(changed, torch.zeros_like(age), age + 1)
            tied = (block_delta(eff64[t - 1], eff64[t], blk) - gate["threshold"]).abs() <= tie
        keyframe = t == 0 or (interval > 0 and t % interval == 0)
        keeps.append(torch.ones_like(age, dtype=torch.bool) if keyframe else age <= hyst)
        keyframes.append(keyframe)
        ties.append(tied)
    return {"keep": torch.stack(keeps), "keyframe": np.array(keyframes), "tie": torch.stack(ties)}


def camera_stream(frames: torch.Tensor, kernel: torch.Tensor, bn_offset: torch.Tensor, head: list[dict],
                  calib: dict, cfg: dict, gate: dict, tie: float, mode: str = "float64") -> dict:
    """One camera's gated stream from a fresh state: the gate's per-tick
    ``keep``, ``keyframe``, ``tie`` and ``kept`` window counts, the kept
    windows' ``counts`` (skipped windows 0) and the head's ``logits`` on
    the effective activation map, each with a leading tick axis."""
    g = gate_masks(frames, cfg, gate, tie)
    window = fpca.window_mask_from_blocks(g["keep"], cfg)               # (T, h_o, w_o)
    every = fpca.counts(frames, kernel, bn_offset, calib, cfg, mode)    # (T, h_o, w_o, c_o)
    eff = torch.zeros_like(every[0])
    effs = []
    for t in range(every.shape[0]):
        eff = torch.where(window[t][..., None], every[t], eff)
        effs.append(eff)
    logits = fpca.head_logits(torch.stack(effs), head, cfg, mode)
    return {**g, "kept": window.reshape(window.shape[0], -1).sum(-1), "window": window,
            "counts": every * window[..., None], "logits": logits}
