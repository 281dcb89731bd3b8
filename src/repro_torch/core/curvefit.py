"""Bucket-select curvefit model of the FPCA analog convolution (paper §4).

Two-step method, fitted against the circuit oracle in
:mod:`repro_torch.core.device_models`:

* **Step 1** — a generic surface ``f_avg(I, W)`` fitted to the oracle when all
  ``N`` activated pixels share one ``(I, W)``; a heterogeneous window's
  estimate is ``V_est = f_avg(mean I, mean W)``.
* **Step 2** — ``V_est`` selects one of ``n_buckets`` range-specific surfaces
  ``f_buc_i`` and the prediction is
  ``V_pd = sum_j [f_buc_s(I_j, W_j) - v_c_s] / n_sweep + v_c_s``.
* The differentiable single equation replaces the bucket argmax with paired
  sigmoids ``sigma(k (x - lo_i)) + sigma(k (hi_i - x)) - 1``.

The fitted tables are kept as numpy arrays (they are constants of a
deployment); prediction lifts them onto the device of its inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.device_models import CircuitParams, analog_dot_product
from repro_torch.device import resolve_device

__all__ = [
    "PolySurface",
    "BucketCurvefitModel",
    "fit_poly_surface",
    "fit_bucket_model",
    "predict_hard",
    "predict_sigmoid",
]


def _exponent_pairs(degree: int) -> np.ndarray:
    """All (a, b) with a + b <= degree, deterministic order."""
    return np.array(
        [(a, b) for total in range(degree + 1) for a in range(total + 1) for b in [total - a]],
        dtype=np.int32,
    )


def _design(I: torch.Tensor, W: torch.Tensor, exps: np.ndarray) -> torch.Tensor:
    """Design matrix of monomials, shape ``I.shape + (n_terms,)``."""
    max_deg = int(exps.max())
    pow_i = [torch.ones_like(I)]
    pow_w = [torch.ones_like(W)]
    for _ in range(max_deg):
        pow_i.append(pow_i[-1] * I)
        pow_w.append(pow_w[-1] * W)
    return torch.stack([pow_i[a] * pow_w[b] for a, b in exps], dim=-1)


@dataclasses.dataclass(frozen=True)
class PolySurface:
    """Bivariate polynomial surface ``f(I, W) = sum_t c_t I^a_t W^b_t``."""

    coeffs: np.ndarray  # (n_terms,) float32
    exps: np.ndarray    # (n_terms, 2) int32

    @property
    def degree(self) -> int:
        return int(self.exps.sum(axis=1).max())

    def __call__(self, I: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        basis = _design(I.float(), W.float(), self.exps)
        return basis @ torch.tensor(self.coeffs, device=basis.device)


def fit_poly_surface(I: np.ndarray, W: np.ndarray, V: np.ndarray, degree: int) -> PolySurface:
    """Least-squares fit of a bivariate polynomial to samples ``V(I, W)``:
    float32 design matrix, solved by ``np.linalg.lstsq`` (double precision)."""
    exps = _exponent_pairs(degree)
    A = _design(torch.as_tensor(I.ravel()), torch.as_tensor(W.ravel()), exps).numpy()
    coeffs, *_ = np.linalg.lstsq(A, V.ravel(), rcond=None)
    return PolySurface(coeffs=np.asarray(coeffs, np.float32), exps=exps)


@dataclasses.dataclass(frozen=True)
class BucketCurvefitModel:
    """Fitted two-step bucket-select model for one circuit configuration."""

    f_avg: PolySurface
    bucket_coeffs: np.ndarray     # (n_buckets, n_terms_buc) float32
    bucket_exps: np.ndarray       # (n_terms_buc, 2) int32
    centers: np.ndarray           # (n_buckets, 2) — (I_C_i, W_C_i)
    v_centers: np.ndarray         # (n_buckets,) — V at the all-centre point
    n_pixels: int                 # N (75 for a 5x5x3 kernel)
    n_sweep: int                  # subset size used for bucket fits (5)
    v_range: float                # bucket span upper edge (v_sat)
    sharpness: float = 100.0      # paper uses sigma(100 x)

    @property
    def n_buckets(self) -> int:
        return int(self.bucket_coeffs.shape[0])

    def to_dict(self) -> dict:
        return {
            "f_avg_coeffs": np.asarray(self.f_avg.coeffs),
            "f_avg_exps": self.f_avg.exps,
            "bucket_coeffs": np.asarray(self.bucket_coeffs),
            "bucket_exps": self.bucket_exps,
            "centers": np.asarray(self.centers),
            "v_centers": np.asarray(self.v_centers),
            "n_pixels": self.n_pixels,
            "n_sweep": self.n_sweep,
            "v_range": self.v_range,
            "sharpness": self.sharpness,
        }

    @staticmethod
    def from_dict(d: dict) -> "BucketCurvefitModel":
        return BucketCurvefitModel(
            f_avg=PolySurface(
                coeffs=np.asarray(d["f_avg_coeffs"], np.float32),
                exps=np.asarray(d["f_avg_exps"], np.int32),
            ),
            bucket_coeffs=np.asarray(d["bucket_coeffs"], np.float32),
            bucket_exps=np.asarray(d["bucket_exps"], np.int32),
            centers=np.asarray(d["centers"], np.float32),
            v_centers=np.asarray(d["v_centers"], np.float32),
            n_pixels=int(d["n_pixels"]),
            n_sweep=int(d["n_sweep"]),
            v_range=float(d["v_range"]),
            sharpness=float(d["sharpness"]),
        )


# ---------------------------------------------------------------------------
# Fitting (step 1 + step 2 simulation setups, paper §4)
# ---------------------------------------------------------------------------


def _all_shared_output(
    t_i: torch.Tensor, t_w: torch.Tensor, n_pixels: int, params: CircuitParams
) -> torch.Tensor:
    """Oracle output when all N pixels share (t_i, t_w); broadcasts grids."""
    I = t_i[..., None].expand(*t_i.shape, n_pixels)
    W = t_w[..., None].expand(*t_w.shape, n_pixels)
    return analog_dot_product(I, W, params, n_pixels=n_pixels)


def _find_center(
    target_v: float, n_pixels: int, params: CircuitParams, device: torch.device
) -> tuple[float, float]:
    """Bisect t so that V(all pixels at (t, t)) hits ``target_v`` (the
    all-shared transfer curve is monotonic in t)."""
    lo, hi = 0.0, 1.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        t = torch.tensor(mid, dtype=torch.float32, device=device)
        if float(_all_shared_output(t, t, n_pixels, params)) < target_v:
            lo = mid
        else:
            hi = mid
    t = 0.5 * (lo + hi)
    return t, t


def fit_bucket_model(
    params: CircuitParams | None = None,
    *,
    n_pixels: int = 75,
    n_buckets: int = 5,
    n_sweep: int = 5,
    degree_avg: int = 4,
    degree_buc: int = 3,
    grid: int = 41,
    i_range: tuple[float, float] = (0.0, 1.0),
    w_range: tuple[float, float] = (0.0, 1.0),
    device: str | torch.device | None = None,
) -> BucketCurvefitModel:
    """Run the paper's two fitting setups against the circuit oracle.

    The oracle runs in float32 on ``device`` (the card by default); the
    least-squares solves run in numpy on the host.
    """
    params = params or CircuitParams()
    dev = resolve_device(device)
    ti = torch.linspace(i_range[0], i_range[1], grid, device=dev)
    tw = torch.linspace(w_range[0], w_range[1], grid, device=dev)
    gi, gw = torch.meshgrid(ti, tw, indexing="ij")
    gi_np, gw_np = gi.cpu().numpy(), gw.cpu().numpy()

    # ---- step 1: generic surface, all N pixels swept together --------------
    v_avg = _all_shared_output(gi, gw, n_pixels, params)
    f_avg = fit_poly_surface(gi_np, gw_np, v_avg.cpu().numpy(), degree_avg)

    # ---- step 2: one tailored surface per bucket ----------------------------
    v_range = params.v_sat
    bucket_exps = _exponent_pairs(degree_buc)
    bucket_coeffs, centers, v_centers = [], [], []
    n_fixed = n_pixels - n_sweep
    for b in range(n_buckets):
        target = (b + 0.5) / n_buckets * v_range
        ic, wc = _find_center(target, n_pixels, params, dev)
        # n_sweep pixels sweep the grid; the rest pin the bitline into bucket b.
        I = torch.cat(
            [gi[..., None].expand(grid, grid, n_sweep),
             torch.full((grid, grid, n_fixed), ic, device=dev)],
            dim=-1,
        )
        W = torch.cat(
            [gw[..., None].expand(grid, grid, n_sweep),
             torch.full((grid, grid, n_fixed), wc, device=dev)],
            dim=-1,
        )
        v_buc = analog_dot_product(I, W, params, n_pixels=n_pixels)
        surf = fit_poly_surface(gi_np, gw_np, v_buc.cpu().numpy(), degree_buc)
        bucket_coeffs.append(surf.coeffs)
        centers.append((ic, wc))
        tc_i = torch.tensor(ic, dtype=torch.float32, device=dev)
        tc_w = torch.tensor(wc, dtype=torch.float32, device=dev)
        v_centers.append(float(_all_shared_output(tc_i, tc_w, n_pixels, params)))

    return BucketCurvefitModel(
        f_avg=f_avg,
        bucket_coeffs=np.stack(bucket_coeffs).astype(np.float32),
        bucket_exps=bucket_exps,
        centers=np.asarray(centers, np.float32),
        v_centers=np.asarray(v_centers, np.float32),
        n_pixels=n_pixels,
        n_sweep=n_sweep,
        v_range=float(v_range),
    )


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------


def _estimate(model: BucketCurvefitModel, I: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Step-1 estimate ``V_est`` for heterogeneous windows (mean-field)."""
    return model.f_avg(I.mean(dim=-1), W.mean(dim=-1))


def _bucket_prediction(
    model: BucketCurvefitModel, I: torch.Tensor, W: torch.Tensor
) -> torch.Tensor:
    """Per-bucket full prediction B_i, shape ``(..., n_buckets)``:
    ``B_i = sum_j [f_buc_i(I_j, W_j) - v_c_i] / n_sweep + v_c_i``."""
    basis = _design(I.float(), W.float(), model.bucket_exps)
    coeffs = torch.tensor(model.bucket_coeffs, device=basis.device)
    v_c = torch.tensor(model.v_centers, device=basis.device)
    summed = (basis @ coeffs.T).sum(dim=-2)           # (..., n_buckets)
    n = I.shape[-1]
    return (summed - n * v_c) / model.n_sweep + v_c


def predict_hard(model: BucketCurvefitModel, I: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Step-function bucket selection (paper's three-step procedure)."""
    v_est = _estimate(model, I, W)
    idx = torch.floor(v_est / model.v_range * model.n_buckets).to(torch.int64)
    idx = idx.clamp(0, model.n_buckets - 1)
    preds = _bucket_prediction(model, I, W)
    return torch.take_along_dim(preds, idx[..., None], dim=-1)[..., 0]


def predict_sigmoid(model: BucketCurvefitModel, I: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The paper's single differentiable equation (sigmoid bucket gates)."""
    x = _estimate(model, I, W) / model.v_range
    k = model.sharpness
    steps = torch.arange(model.n_buckets, dtype=torch.float32, device=x.device)
    edges_lo = steps / model.n_buckets
    edges_hi = (steps + 1.0) / model.n_buckets
    gates = (
        torch.sigmoid(k * (x[..., None] - edges_lo))
        + torch.sigmoid(k * (edges_hi - x[..., None]))
        - 1.0
    )
    return (gates * _bucket_prediction(model, I, W)).sum(dim=-1)


def make_predict_fn(
    model: BucketCurvefitModel, differentiable: bool = True
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``(I, W) -> V`` closure over ``model``: the sigmoid form when
    ``differentiable``, the step-function bucket select otherwise."""
    fn = predict_sigmoid if differentiable else predict_hard
    return lambda I, W: fn(model, I, W)
