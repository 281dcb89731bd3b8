"""The one generator of every traffic mix's frames.

A mix file (``traffic/<mix>.json``) names a ``frames`` kind and its
parameters; everything is drawn from the run's seed on the run's device:

* ``uniform``: frames uniform in [0, 1), one ``torch.Generator`` draw;
* ``moving_object``: the repository's ``SyntheticMovingObject`` video, a
  static low-frequency clutter (an 8-pixel grid of colours in [0.05,
  0.35)) under one Gaussian blob of ``radius`` and ``amplitude`` that
  orbits the frame's centre at ``speed`` radians a tick, 0.3 of the frame
  out.  A delta gate keeps only the blocks the blob moves over.  Unlike
  the original, the seed draws only the clutter (see ``moving_object``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

GOLDEN_ANGLE = math.pi * (3.0 - math.sqrt(5.0))


def uniform(n: int, cfg: dict, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """``n`` frames ``(n, H, W, c_i)`` float32, uniform in [0, 1)."""
    shape = (n, cfg["image_h"], cfg["image_w"], cfg["in_channels"])
    return torch.rand(shape, generator=generator, device=device)


def moving_object(seed: int, clips: int, ticks: int, cfg: dict, params: dict, device: torch.device) -> torch.Tensor:
    """``clips`` clips of ``ticks`` frames: ``(clips, ticks, H, W, c_i)``
    float32, frame ``t`` of clip ``i`` a function of ``(seed, i, t)`` alone.

    The seed draws each clip's background (``default_rng(seed * clips +
    i)``); the blob's colour (``default_rng(i)``) and the phase of its orbit
    (``i`` golden angles) belong to the clip's index.  The frame-to-frame
    change is the blob's alone, so every seed gives the gate the same work,
    on other pixels."""
    h, w, c = cfg["image_h"], cfg["image_w"], cfg["in_channels"]
    backgrounds = []
    for i in range(clips):
        rng = np.random.default_rng(seed * clips + i)
        base = rng.uniform(0.05, 0.35, (h // 8 + 1, w // 8 + 1, c))
        backgrounds.append(np.clip(np.kron(base, np.ones((8, 8, 1)))[:h, :w], 0.0, 1.0).astype(np.float32))
    colours = np.stack([np.random.default_rng(i).uniform(0.6, 1.0, c) for i in range(clips)]).astype(np.float32)
    bg = torch.as_tensor(np.stack(backgrounds), device=device)[:, None]           # (clips, 1, h, w, c)
    colour = torch.as_tensor(colours, device=device)[:, None, None, None]         # (clips, 1, 1, 1, c)
    phase = torch.arange(clips, dtype=torch.float64, device=device)[:, None] * GOLDEN_ANGLE
    angle = params["speed"] * torch.arange(ticks, dtype=torch.float64, device=device)[None] + phase
    cy = h / 2 + 0.30 * h * torch.sin(angle)                                      # (clips, ticks)
    cx = w / 2 + 0.30 * w * torch.cos(angle)
    yy = torch.arange(h, dtype=torch.float64, device=device)[None, None, :, None]
    xx = torch.arange(w, dtype=torch.float64, device=device)[None, None, None, :]
    d2 = (yy - cy[..., None, None]) ** 2 + (xx - cx[..., None, None]) ** 2
    blob = (params["amplitude"] * torch.exp(-d2 / (2.0 * params["radius"] ** 2))).float()   # (clips, ticks, h, w)
    return (bg + blob[..., None] * colour).clamp(0.0, 1.0)
