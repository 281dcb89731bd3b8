"""The sensor calibration every cell serves: the bucket-select curvefit fit.

A frozen copy of the paper's two-step fit (section 4) against its circuit
model, in float64 numpy on the host, so that the calibration is the same
numbers on every machine and for every seed.  The benchmark fits once per
run and hands the same tables to the program (``fpca.compile(model=...)``)
and to the reference.

The circuit: the coupled bitline output is the fixed point of

    V = v_sat * tanh((1 - coupling * V / v_sat) * sum_j g(I_j, W_j) / (N * s0))

with the per-pixel drive ``g = (IW + a I^2 W + b I W^2) / (1 + c IW)``
(no metal-line term: the configurations set its length to 0).

The fit takes about half a second of the host; :func:`cached` keeps its
tables in a file at a fixed path inside the checkout, named by a digest of
the inputs and of this module, so that only a checkout's first run fits.

The fit: ``f_avg`` is a degree-4 surface through the output when all N
pixels share one ``(I, W)``; bucket i's degree-3 surface is fitted with
``n_sweep`` pixels sweeping the grid and the rest pinned at the point whose
shared output is the bucket's centre ``(i + 0.5) / n_buckets * v_sat``.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np


def exponent_pairs(degree: int) -> np.ndarray:
    """All ``(a, b)`` with ``a + b <= degree``, by total degree, then ``a``."""
    return np.array([(a, t - a) for t in range(degree + 1) for a in range(t + 1)], dtype=np.int32)


def bitline(I: np.ndarray, W: np.ndarray, circuit: dict, n_pixels: int) -> np.ndarray:
    """Bitline voltage of pixels ``I``, ``W`` ``(..., N)``."""
    iw = I * W
    g = (iw + circuit["drive_a"] * I * iw + circuit["drive_b"] * W * iw) / (1.0 + circuit["drive_c"] * iw)
    s = g.sum(-1)
    denom = n_pixels * circuit["s0"]
    v = circuit["v_sat"] * np.tanh(s / denom)
    for _ in range(circuit["fp_iters"]):
        v = circuit["v_sat"] * np.tanh((1.0 - circuit["coupling"] * v / circuit["v_sat"]) * s / denom)
    return v


def _shared(ti, tw, circuit: dict, n: int) -> np.ndarray:
    ti, tw = np.broadcast_arrays(np.asarray(ti, np.float64), np.asarray(tw, np.float64))
    return bitline(np.repeat(ti[..., None], n, -1), np.repeat(tw[..., None], n, -1), circuit, n)


def _lstsq(gi: np.ndarray, gw: np.ndarray, v: np.ndarray, degree: int) -> tuple[np.ndarray, np.ndarray]:
    exps = exponent_pairs(degree)
    A = np.stack([gi.ravel() ** a * gw.ravel() ** b for a, b in exps], axis=1)
    coeffs, *_ = np.linalg.lstsq(A, v.ravel(), rcond=None)
    return coeffs, exps


def fit(cfg: dict) -> dict:
    """The fitted tables for ``cfg``'s circuit and window size, as float32
    arrays under the keys the program's ``BucketCurvefitModel.from_dict``
    takes."""
    circuit = cfg["circuit"]
    fit_cfg = cfg["fit"]
    if circuit.get("r_metal_mm", 0.0):
        raise ValueError("the calibration copy models no metal-line resistance")
    n = cfg["max_kernel"] ** 2 * cfg["in_channels"]
    grid = np.linspace(0.0, 1.0, fit_cfg["grid"])
    gi, gw = np.meshgrid(grid, grid, indexing="ij")
    f_avg, f_avg_exps = _lstsq(gi, gw, _shared(gi, gw, circuit, n), fit_cfg["degree_avg"])
    nb, n_sweep = fit_cfg["n_buckets"], fit_cfg["n_sweep"]
    v_sat = circuit["v_sat"]
    coeffs, centers, v_centers = [], [], []
    for b in range(nb):
        target = (b + 0.5) / nb * v_sat
        lo, hi = 0.0, 1.0
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            if _shared(mid, mid, circuit, n) < target:
                lo = mid
            else:
                hi = mid
        c = 0.5 * (lo + hi)
        I = np.concatenate([np.repeat(gi[..., None], n_sweep, -1), np.full(gi.shape + (n - n_sweep,), c)], -1)
        W = np.concatenate([np.repeat(gw[..., None], n_sweep, -1), np.full(gw.shape + (n - n_sweep,), c)], -1)
        surf, bucket_exps = _lstsq(gi, gw, bitline(I, W, circuit, n), fit_cfg["degree_bucket"])
        coeffs.append(surf)
        centers.append((c, c))
        v_centers.append(float(_shared(c, c, circuit, n)))
    return {
        "f_avg_coeffs": f_avg.astype(np.float32),
        "f_avg_exps": f_avg_exps,
        "bucket_coeffs": np.stack(coeffs).astype(np.float32),
        "bucket_exps": bucket_exps,
        "centers": np.asarray(centers, np.float32),
        "v_centers": np.asarray(v_centers, np.float32),
        "n_pixels": n,
        "n_sweep": n_sweep,
        "v_range": float(v_sat),
        "sharpness": float(fit_cfg["sharpness"]),
    }


def cached(cfg: dict, directory: Path) -> dict:
    """:func:`fit` of ``cfg``, read from ``directory`` when a run of this
    checkout has fitted the same inputs with the same code (the tables
    are stored as they were returned, so both give the same numbers)."""
    inputs = {k: cfg[k] for k in ("circuit", "fit", "max_kernel", "in_channels")}
    h = hashlib.sha256(Path(__file__).read_bytes())
    h.update(json.dumps(inputs, sort_keys=True).encode())
    path = Path(directory) / f"calibration-{h.hexdigest()[:16]}.npz"
    if path.exists():
        with np.load(path) as z:
            return {k: (z[k] if z[k].ndim else z[k].item()) for k in z.files}
    tables = fit(cfg)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **tables)
    os.replace(tmp, path)
    return tables
