"""Public wrapper of the fpca_conv kernel: batched images in, SS-ADC
activation maps out.

``impl="cuda"`` runs the hand-written kernel (:func:`kernel.fpca_conv_cuda`);
``impl="basis"`` runs the same math in plain PyTorch
(:func:`kernel.fpca_conv_basis`).  The dense oracle is
:mod:`repro_torch.kernels.fpca_conv.ref`.

Region skipping (§3.4.5) is compute-real: a per-window keep mask compacts
the flattened window list into a static bucket of ``m_bucket`` rows before
the kernel runs, so skipped windows never execute.  Results scatter back to
the dense ``(B, h_o, w_o, c_o)`` grid with exact zeros in skipped slots;
kept windows are bit-identical to the dense evaluation because every row of
the basis-bank math is row-independent.  The compaction index is built on
the device (:func:`compact_rows`) and the kernel reads the kept count from
the device (``n_rows``), walking only the kept rows: nothing in the call
waits on the host, so a call with ``m_bucket = M`` can be captured in a
CUDA graph and replayed for any mask (the streaming segments do so).

A dense call (no mask) of the CUDA kernel on f32 frames with
non-overlapping windows (stride = kernel, no padding, no binning) feeds the
tensor-core design straight from the frames (:func:`conv_source`): no patch
matrix is copied, and the counts are those of the patch path bit for bit.

``transfer="int8"`` (``precision="int8"`` model programs on the ``basis``
backend) replaces the sigmoid gate bank by one gather from a 256-entry
coefficient table (:func:`_transfer_lut`); only ``impl="basis"`` lowers it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.adc import ADCConfig
from repro_torch.core.curvefit import BucketCurvefitModel, PolySurface
from repro_torch.core.fpca_sim import WeightEncoding, encode_weights, extract_windows
from repro_torch.core.mapping import FPCASpec, output_dims
from repro_torch.device import resolve_device
from repro_torch.kernels.fpca_conv.kernel import (
    ConvTables,
    conv_tables,
    fpca_conv_basis,
    fpca_conv_cuda,
    fpca_conv_frames_cuda,
    frames_fit,
    weight_planes,
)

__all__ = [
    "fpca_conv",
    "make_fpca_conv_executable",
    "pad_to_lanes",
    "freeze_model",
    "thaw_model",
    "window_bucket",
    "segment_bucket",
    "compact_rows",
    "conv_source",
    "StickyBucket",
]

_LANES = 128
# the kernels by impl, and the CUDA kernel's frames source (not an impl of
# its own: :func:`conv_source` picks it for a "cuda" call)
_FRAMES = "cuda.frames"
_IMPLS = {"cuda": fpca_conv_cuda, "basis": fpca_conv_basis, _FRAMES: fpca_conv_frames_cuda}

# int8 transfer: the bucket-sigmoid gate bank collapses into a LUT over the
# 8-bit requantised gate input (256 levels, the SS-ADC's own resolution).
_TRANSFER_LEVELS = 256


def _stable_sigmoid(z: np.ndarray) -> np.ndarray:
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


def _transfer_lut(tables: ConvTables) -> np.ndarray:
    """The bucket-sigmoid transfer baked into a ``(256, 1 + 10)`` float32
    coefficient table: column 0 the effective constant, then one column per
    monomial pair in the kernel's pair order.

    Per element the f32 path sums ``gate_i(xg) * (const_i + sum_p c_i[p] *
    term_p)`` over the buckets; swapping the sums leaves coefficients that
    depend on ``xg`` alone, evaluated here at the 256 level centres in
    float64 (the reference's table, bit for bit, from the same constants)."""
    model = tables.model
    T = _TRANSFER_LEVELS
    grid = (np.arange(T, dtype=np.float64) + 0.5) / T
    edges = np.arange(model.n_buckets, dtype=np.float64) / model.n_buckets
    gates = np.stack(
        [
            _stable_sigmoid(model.sharpness * (grid - edges[i]))
            + _stable_sigmoid(model.sharpness * (edges[i] + 1.0 / model.n_buckets - grid))
            - 1.0
            for i in range(model.n_buckets)
        ],
        axis=1,
    )                                               # (T, n_buckets)
    cols = [gates @ np.asarray(tables.const, np.float64)]
    cols += [gates @ np.asarray(tables.by_pair[p], np.float64) for p in tables.by_pair]
    return np.stack(cols, axis=1).astype(np.float32)


def window_bucket(n_keep: int, m_total: int) -> int:
    """Static row-bucket size for ``n_keep`` kept windows out of ``m_total``:
    the next power of two, capped at ``m_total`` (dense fallback there)."""
    return min(1 << (max(n_keep, 1) - 1).bit_length(), m_total)


def segment_bucket(kept_counts, m_total: int, keyframes=None) -> int:
    """Compacted-row bucket for the next segment, from the per-tick kept
    counts of the last one (the between-segment half of the region-skip
    servo).  Keyframe ticks are held out (they keep everything by
    construction), and so are all-skipped ticks; a segment with no
    informative tick yields the minimal bucket of 1."""
    kept = np.asarray(kept_counts, np.int64).reshape(-1)
    if keyframes is not None:
        kf = np.asarray(keyframes, bool).reshape(-1)
        kept = kept[~kf]
    kept = kept[kept > 0]
    if kept.size == 0:
        return 1
    return window_bucket(int(kept.max()), int(m_total))


def compact_rows(keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kept rows of a flat ``(M,)`` keep mask, in order, without leaving
    the device: ``(idx (M,) int64, n_keep (1,) int32)`` where ``idx[:n_keep]``
    are the kept row numbers ascending (what ``nonzero`` gives) and the rest
    are 0.  Built from a prefix sum and a scatter, so nothing waits on the
    host: kept row r goes to slot ``cumsum[r] - 1``, every skipped row to a
    spare slot M that is dropped."""
    M = keep.shape[0]
    pos = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32)
    slot = torch.where(keep, pos.long() - 1, torch.full_like(pos, M, dtype=torch.long))
    idx = torch.zeros(M + 1, dtype=torch.long, device=keep.device)
    idx.scatter_(0, slot, torch.arange(M, device=keep.device))
    return idx[:M], pos[-1:]


class StickyBucket:
    """Cross-call hysteresis on :func:`window_bucket`.

    Growth is immediate (the bucket must hold every kept window); shrinkage
    waits for ``patience`` consecutive under-full ticks.  ``patience=1``
    reproduces the stateless behaviour.  ``switches`` counts bucket
    transitions served, ``shrinks_deferred`` the under-full ticks that kept
    the larger bucket.  All-skipped ticks launch nothing; callers report
    them with :meth:`observe_idle` so they advance the shrink streak.
    """

    def __init__(self, patience: int = 4):
        if patience < 1:
            raise ValueError("patience must be >= 1")
        self.patience = patience
        self.bucket_size: int | None = None    # bucket currently held
        self.switches = 0
        self.shrinks_deferred = 0
        self._under = 0                        # consecutive under-full ticks

    def observe_idle(self) -> None:
        """Count an all-skipped tick toward the consecutive-under-full streak."""
        if self.bucket_size is not None:
            self._under += 1

    def bucket(self, n_keep: int, m_total: int) -> int:
        """Bucket to serve this tick's ``n_keep`` kept windows with."""
        raw = window_bucket(n_keep, m_total)
        held = self.bucket_size
        if held is None or raw > held:
            new = raw
            self._under = 0
        elif raw < held:
            self._under += 1
            if self._under >= self.patience:
                new = raw
                self._under = 0
            else:
                new = held
                self.shrinks_deferred += 1
        else:
            new = held
            self._under = 0
        if held is not None and new != held:
            self.switches += 1
        self.bucket_size = new
        return new


def _tup(x) -> tuple:
    a = np.asarray(x)
    return tuple(map(tuple, a.tolist())) if a.ndim > 1 else tuple(a.tolist())


def freeze_model(model: BucketCurvefitModel) -> tuple:
    """Hashable encoding of a fitted model."""
    d = model.to_dict()
    return (
        _tup(d["f_avg_coeffs"]), _tup(d["f_avg_exps"]),
        _tup(d["bucket_coeffs"]), _tup(d["bucket_exps"]),
        _tup(d["centers"]), _tup(d["v_centers"]),
        d["n_pixels"], d["n_sweep"], d["v_range"], d["sharpness"],
    )


def thaw_model(frozen: tuple) -> BucketCurvefitModel:
    """Inverse of :func:`freeze_model`."""
    (fa_c, fa_e, b_c, b_e, cen, v_c, n_px, n_sw, v_r, sharp) = frozen
    return BucketCurvefitModel(
        f_avg=PolySurface(coeffs=np.asarray(fa_c, np.float32), exps=np.asarray(fa_e, np.int32)),
        bucket_coeffs=np.asarray(b_c, np.float32),
        bucket_exps=np.asarray(b_e, np.int32),
        centers=np.asarray(cen, np.float32),
        v_centers=np.asarray(v_c, np.float32),
        n_pixels=int(n_px),
        n_sweep=int(n_sw),
        v_range=float(v_r),
        sharpness=float(sharp),
    )


def pad_to_lanes(
    x: torch.Tensor, axis: int, lanes: int = _LANES
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad ``axis`` to a lane multiple; returns (padded, mask).  The
    CUDA path does not need it (no 128-lane tiling); kept for layouts that
    carry the reference's lane padding."""
    n = x.shape[axis]
    target = -(-n // lanes) * lanes
    pad = [0, 0] * x.ndim
    pad[2 * (x.ndim - 1 - axis % x.ndim) + 1] = target - n
    mask = torch.cat([torch.ones(n, device=x.device), torch.zeros(target - n, device=x.device)])
    return F.pad(x, pad), mask


def conv_source(
    images: torch.Tensor, spec: FPCASpec, tables: ConvTables, *, impl: str, masked: bool
) -> str:
    """Where a call's kernel reads its windows: ``"frames"`` (the tensor-core
    design straight from the frames) for an unmasked call of the CUDA
    kernel on a CUDA tensor with non-overlapping windows (stride = kernel,
    no padding, no binning) that :func:`~repro_torch.kernels.fpca_conv.kernel.frames_fit`
    takes; ``"patches"`` (the patch matrix ``extract_windows`` copies)
    otherwise.  Reads only what the call's input shows."""
    frames = (
        impl == "cuda"
        and not masked
        and images.device.type == "cuda"
        and spec.stride == spec.max_kernel
        and spec.padding == 0
        and spec.binning == 1
        and frames_fit(images, spec.max_kernel, tables)
    )
    return "frames" if frames else "patches"


def _fpca_conv_impl(
    images: torch.Tensor,
    kernel: torch.Tensor,
    bn_offset: torch.Tensor,
    window_mask: torch.Tensor | None = None,
    *,
    tables: ConvTables,
    spec: FPCASpec,
    enc: WeightEncoding,
    impl: str,
    m_bucket: int | None = None,
    lut: torch.Tensor | None = None,
) -> torch.Tensor:
    """Encode, extract, compact kept windows, run the kernel, scatter back:
    each step in its layer span (``repro_torch.fpca.telemetry.layer``)."""
    from repro_torch.fpca.telemetry import layer   # repro_torch.fpca imports this module

    with layer("encode"):
        w_pos, w_neg = encode_weights(kernel, spec, enc)          # (c_o, N)
    with layer("extract"):
        source = conv_source(images, spec, tables, impl=impl, masked=window_mask is not None)
        if source == "frames":   # the kernel reads the windows from the frames: nothing to copy
            n = spec.max_kernel
            B, h_o, w_o = images.shape[0], images.shape[1] // n, images.shape[2] // n
        else:
            patches = extract_windows(images, spec)               # (B, h_o, w_o, N)
            B, h_o, w_o, N = patches.shape
            flat = patches.reshape(B * h_o * w_o, N).contiguous()
        M = B * h_o * w_o
    with layer("planes"):
        planes = weight_planes(w_pos.T, w_neg.T, tables)

    idx = n_rows = None
    if window_mask is not None:
        if m_bucket is None:
            raise ValueError("window_mask requires a static m_bucket (see window_bucket())")
        # compact: only kept windows reach the kernel (row-independent math,
        # so kept rows stay bit-identical to a dense evaluation); the kernel
        # walks the first n_rows (the kept count, on the device) of the
        # m_bucket rows, and the padding rows (window 0) come out as zeros
        with layer("compact"):
            idx, n_rows = compact_rows(window_mask.reshape(-1).to(torch.bool))
            idx = idx[: min(m_bucket, M)]
            flat = flat[idx]

    kw = {} if lut is None else {"lut": lut}
    with layer("kernel"):
        bn = bn_offset.float().contiguous()
        if source == "frames":
            counts = _IMPLS[_FRAMES](images, n, planes, tables, bn)
        else:
            counts = _IMPLS[impl](flat, planes, tables, bn, n_rows=n_rows, **kw)
    if idx is not None:
        # scatter-add back: rows past the kept count are exact zeros, so
        # the duplicate fill index 0 adds nothing
        with layer("scatter"):
            counts = torch.zeros((M, counts.shape[-1]), device=counts.device).index_add_(0, idx, counts)
    return counts.reshape(B, h_o, w_o, -1)


def make_fpca_conv_executable(
    model: BucketCurvefitModel,
    *,
    spec: FPCASpec,
    adc: ADCConfig | None = None,
    enc: WeightEncoding | None = None,
    impl: str = "cuda",
    m_bucket: int | None = None,
    device: str | torch.device | None = None,
    transfer: str = "f32",
) -> Callable:
    """An ``(images, kernel, bn_offset) -> counts`` executable for ``device``
    (the card by default).  Its constant tables are built once, here.

    With ``m_bucket`` set it takes ``(images, kernel, bn_offset,
    window_mask)`` and serves the region-skip compacted path.  CONTRACT:
    every mask fed to it keeps at most ``m_bucket`` windows — the gather is
    fixed-size and a busier mask would drop kept windows.

    ``transfer="int8"`` serves the quantised bucket transfer
    (:func:`_transfer_lut`); only ``impl="basis"`` lowers it, any other
    impl raises here.
    """
    adc = adc or ADCConfig()
    enc = enc or WeightEncoding()
    if impl not in _IMPLS or impl == _FRAMES:
        raise ValueError(f"unknown impl {impl!r}; available: {tuple(k for k in _IMPLS if k != _FRAMES)}")
    if transfer not in ("f32", "int8"):
        raise ValueError(f"unknown transfer {transfer!r}")
    if transfer != "f32" and impl != "basis":
        raise ValueError(f"transfer={transfer!r} is only lowered by the basis impl (got impl={impl!r})")
    dev = resolve_device(device)
    tables = conv_tables(model, adc, spec.n_active_pixels, dev)
    lut = torch.as_tensor(_transfer_lut(tables), device=dev) if transfer == "int8" else None

    def run(images, kernel, bn_offset, window_mask=None):
        if (window_mask is None) != (m_bucket is None):
            raise ValueError("pass window_mask exactly when the executable has an m_bucket")
        return _fpca_conv_impl(
            images, kernel, bn_offset, window_mask,
            tables=tables, spec=spec, enc=enc, impl=impl, m_bucket=m_bucket, lut=lut,
        )

    return run


def fpca_conv(
    images: torch.Tensor,
    kernel: torch.Tensor,
    model: BucketCurvefitModel,
    *,
    spec: FPCASpec,
    adc: ADCConfig | None = None,
    enc: WeightEncoding | None = None,
    bn_offset: torch.Tensor | None = None,
    impl: str = "cuda",
    window_mask: torch.Tensor | np.ndarray | None = None,
    m_bucket: int | None = None,
) -> torch.Tensor:
    """FPCA frontend activations for a batch of images, on their device.

    Args:
      images: ``(B, H, W, c_i)`` float in [0, 1].
      kernel: ``(c_o, k, k, c_i)`` float weights.
      model:  fitted bucket model for ``spec.n_active_pixels``.
      impl:   ``"cuda"`` (the kernel; its plain version for CPU tensors) or
              ``"basis"`` (the plain version).
      window_mask: optional ``(B, h_o, w_o)`` (or flat) keep mask; skipped
              slots return exact zeros, an all-skipped mask launches nothing.
      m_bucket: compacted-row bucket; defaults to :func:`window_bucket` of
              the mask's kept count.

    Returns:
      SS-ADC counts, ``(B, h_o, w_o, c_o)`` float32 (integer-valued).
    """
    c_o = kernel.shape[0]
    dev = images.device
    if bn_offset is None:
        bn_offset = torch.zeros(c_o, device=dev)
    if window_mask is None:
        m_bucket = None
    else:
        keep_np = np.asarray(torch.as_tensor(window_mask).cpu())
        n_keep = int(np.count_nonzero(keep_np))
        if n_keep == 0:
            h_o, w_o = output_dims(spec)
            return torch.zeros((images.shape[0], h_o, w_o, c_o), device=dev)
        if m_bucket is None:
            m_bucket = window_bucket(n_keep, keep_np.size)
        elif n_keep > m_bucket:
            raise ValueError(
                f"mask keeps {n_keep} windows > m_bucket {m_bucket}; the "
                "fixed-size gather would silently drop kept windows"
            )
        window_mask = torch.as_tensor(keep_np, device=dev)
    run = make_fpca_conv_executable(
        model, spec=spec, adc=adc, enc=enc, impl=impl, m_bucket=m_bucket, device=dev
    )
    if window_mask is None:
        return run(images, kernel, bn_offset)
    return run(images, kernel, bn_offset, window_mask)
