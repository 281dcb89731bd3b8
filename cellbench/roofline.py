"""The yardstick's peaks and the work a step needs, counted the same way
whatever implements it.

Peaks of one NVIDIA H100 SXM (the data sheet, dense, at its 700 W limit):
3.35 TB/s of HBM, 989 TFLOP/s in bf16, the card's highest dense rate, so no
choice of precision can carry a share past 100%.

Work is what the algorithm needs, never what a kernel happens to move:

* the frontend convolution reads each frame once in the dtype handed to
  the handle and writes each count once; its FLOPs are the ideal
  convolution of both weight phases, ``2 * windows * N * C * 2`` (the
  copy of ``launch/fpca_cell.py::FpcaCellInfo.model_flops``).  Neither the
  patch matrix, nor the split passes, nor the bucket gates' work count;
* a step reads its frames once, writes its outputs once (counts of a
  frontend, logits of a network), reads the weights once, and does the
  frontend's and the head's model FLOPs (``2 * d_in * d_out`` a row).

The least time of a piece of work is the larger of its bytes at the HBM
rate and its FLOPs at the peak; a share is that least time over a measured
time.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 989e12
FRAME_ITEMSIZE = 4          # the handle takes float32 frames


def least_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS)


def conv_flops(windows: int, n_pixels: int, channels: int) -> float:
    """The ideal convolution over ``windows`` windows, both weight phases."""
    return 2.0 * windows * n_pixels * channels * 2


def head_flops(rows: int, d_in: int, head: list[dict]) -> float:
    flops, d = 0.0, d_in
    for layer in head:
        flops += 2.0 * rows * d * layer["features"]
        d = layer["features"]
    return flops


def weight_bytes(cfg: dict, d_in: int, itemsize: int = 4) -> int:
    """The NVM kernel, the BN offsets and the head's weights and biases."""
    c = cfg["out_channels"]
    n = c * cfg["kernel"] ** 2 * cfg["in_channels"] + c
    d = d_in
    for layer in cfg["head"]:
        n += d * layer["features"] + layer["features"]
        d = layer["features"]
    return n * itemsize


def geometry(cfg: dict) -> dict:
    """Windows a frame, pixels a window, count-map size and frame size."""
    n, s, p, b = cfg["max_kernel"], cfg["stride"], cfg["padding"], cfg["binning"]
    h_o = (cfg["image_h"] // b - n + 2 * p) // s + 1
    w_o = (cfg["image_w"] // b - n + 2 * p) // s + 1
    return {"windows": h_o * w_o, "n_pixels": n * n * cfg["in_channels"],
            "counts": h_o * w_o * cfg["out_channels"],
            "pixels": cfg["image_h"] * cfg["image_w"] * cfg["in_channels"]}


def frontend_work(cfg: dict, frames: int, kept_windows: int | None = None) -> dict:
    """Bytes and FLOPs of the frontend convolution over ``frames`` frames,
    of which ``kept_windows`` windows run (all by default)."""
    g = geometry(cfg)
    windows = frames * g["windows"] if kept_windows is None else kept_windows
    return {"bytes": frames * (g["pixels"] * FRAME_ITEMSIZE + g["counts"] * 4),
            "flops": conv_flops(windows, g["n_pixels"], cfg["out_channels"])}


def step_work(cfg: dict, frames: int, kept_windows: int | None = None, head_rows: int | None = None) -> dict:
    """Bytes and FLOPs of one step over ``frames`` frames: the frames in,
    the outputs out (counts without a head, logits with one), the weights
    once, the frontend's FLOPs on ``kept_windows`` windows and the head's on
    ``head_rows`` rows (every frame by default)."""
    g = geometry(cfg)
    fe = frontend_work(cfg, frames, kept_windows)
    if not cfg["head"]:
        return {"bytes": fe["bytes"] + weight_bytes(cfg, g["counts"]), "flops": fe["flops"]}
    out = frames * cfg["head"][-1]["features"] * 4
    rows = frames if head_rows is None else head_rows
    return {"bytes": frames * g["pixels"] * FRAME_ITEMSIZE + out + weight_bytes(cfg, g["counts"]),
            "flops": fe["flops"] + head_flops(rows, g["counts"], cfg["head"])}
