"""The FPCA analog convolution as a basis bank: CUDA kernel and plain version.

Every windowed polynomial sum factors over the monomial basis,

    sum_j f(I_j, W_j) = sum_{a,b} c_ab * <I_patch^a, W^b>,

so the non-linear analog conv is a bank of power-basis contractions combined
by sigmoid bucket gates.  For the degree-3 bucket surfaces:

* (a=0, b)   -> per-channel constants ``cs[b, c] = sum_j mask_j W[j,c]^b``;
* (a, b=0)   -> per-window sums       ``rv[a, m] = <I^a, mask>``;
* (a,b >= 1) -> true dot products, only (1,1), (1,2), (2,1);
* step-1 estimate -> ``v_est = [mean_i^a] @ aw`` on window/channel means.

Both weight phases and the SS-ADC up/down-count epilogue are evaluated per
output.  :func:`fpca_conv_cuda` launches the hand-written kernel in
``csrc/fpca_conv.cu`` on CUDA tensors; :func:`fpca_conv_basis` is the same
math in plain PyTorch (the CPU path, and the kernel's yardstick on the card).
The patch matrix is not lane-padded: ``n_real`` is the spec's active pixel
count, and every slot is real.

The kernel has two designs in the one source, chosen by :func:`design`:
``"wgmma"`` (the three dot products on bf16 tensor cores, every f32 operand
split into three bf16 parts and each product run as six passes; a
persistent grid walking 128-row tiles, one row of blocks per 8 channels)
for at most 80 pixel slots under the default bucket model (5 buckets, 15
f_avg terms), ``"simt"`` (f32 FMAs on CUDA cores) for everything else.
Only the pixel count and the bucket model decide: a channel-stacked launch
of several configs takes the design each config's launch alone takes, and
gives each config's channels the same counts bit for bit.  A patch matrix
that is not 16-byte aligned is copied once to a fresh buffer (the
tensor-core design's tiles come in by 16-byte copies).  The choice is made
before the launch, never after a failure; a failed launch raises.  Beside
``.launches`` the wrapper counts its launches per design in ``.designs``.

The tensor-core design reads its windows from one of two sources: the
``(M, N)`` patch matrix (:func:`fpca_conv_cuda`), or the ``(B, H, W,
c_i)`` f32 frames themselves (:func:`fpca_conv_frames_cuda`), whose
non-overlapping ``n x n`` windows it stages by the runs of image rows they
cover (:func:`frames_fit` says which frames it takes; :func:`strip_map` is
its offset map).  The frames source leaves out the permuting copy that
makes the patch matrix and gives the same counts bit for bit.
``.sources`` counts the launches per source.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.adc import ADCConfig
from repro_torch.core.curvefit import BucketCurvefitModel, _exponent_pairs

__all__ = [
    "ConvTables",
    "conv_tables",
    "precompute_weight_planes",
    "weight_planes",
    "fpca_conv_basis",
    "fpca_conv_cuda",
    "fpca_conv_frames_cuda",
    "design",
    "frames_fit",
    "strip_map",
    "DESIGNS",
    "SOURCES",
]

DESIGNS = ("wgmma", "simt")
SOURCES = ("frames", "patches")
# what the tensor-core design takes: pixel slots (five k-steps of 16) and
# the bucket model its epilogue is compiled for (f_avg of degree <= 4 in the
# window mean); any channel count, in blocks of 8
TC_MAX_PIXELS, TC_BUCKETS, TC_AVG_TERMS, TC_MAX_AVG_POWER = 80, 5, 15, 4
_TC_TILE = 128   # window rows a tile of the tensor-core design

# Monomial pairs of the degree-3 bucket surfaces; the kernel combines them
# in this order (the fit's own order).
_PAIRS = tuple(tuple(int(v) for v in e) for e in _exponent_pairs(3))
_MM_PAIRS = ((1, 1), (1, 2), (2, 1))    # true dot products

# Layout of the packed constants buffer; csrc/fpca_conv.cu reads the same.
_MAX_AVG_TERMS = 16
_MAX_BUCKETS = 8
_P_N_REAL, _P_SHARP, _P_V_RANGE, _P_LSB, _P_LEVELS, _P_N_BUCKETS, _P_N_AVG = range(7)
_P_AVG_EXP = 8
_P_CONST = _P_AVG_EXP + _MAX_AVG_TERMS
_P_COEF = _P_CONST + _MAX_BUCKETS
_P_SIZE = _P_COEF + _MAX_BUCKETS * len(_PAIRS)


def _ipow(x: torch.Tensor, a: int) -> torch.Tensor:
    """``x ** a`` by binary exponentiation, the order ``lax.integer_pow``
    multiplies in (``a = 0`` gives ones)."""
    acc = None
    while a > 0:
        if a & 1:
            acc = x if acc is None else acc * x
        a >>= 1
        if a > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def _bucket_tables(model: BucketCurvefitModel) -> dict:
    """Static per-model tables: combine coefficients keyed by (a, b) pair."""
    exps = [tuple(int(v) for v in e) for e in model.bucket_exps]
    coeffs = np.asarray(model.bucket_coeffs)          # (n_buckets, n_terms)
    v_c = np.asarray(model.v_centers)
    by_pair = {pair: coeffs[:, exps.index(pair)] / model.n_sweep for pair in exps}
    const = v_c * (1.0 - model.n_pixels / model.n_sweep)   # B_i affine offset
    return {"by_pair": by_pair, "const": const}


@dataclasses.dataclass(frozen=True, eq=False)
class ConvTables:
    """Constants of one executable, built once by :func:`conv_tables`.

    ``packed`` is the kernel's copy: scalars, f_avg exponents and the bucket
    combine tables in one small float32 buffer on the device (the SIMT
    design reads it); ``packed_host`` is the same buffer on the host (the
    tensor-core design passes it to the kernel by value).
    """

    model: BucketCurvefitModel
    by_pair: dict
    const: np.ndarray
    n_real: int
    lsb: float
    levels: int
    mask: torch.Tensor        # (N,) ones — every slot of an unpadded window is real
    packed: torch.Tensor      # (_P_SIZE,) float32
    packed_host: np.ndarray   # (_P_SIZE,) float32


def conv_tables(
    model: BucketCurvefitModel, adc: ADCConfig, n_real: int, device: torch.device
) -> ConvTables:
    """Build the per-executable constants on ``device``."""
    exps = [tuple(int(v) for v in e) for e in model.bucket_exps]
    if tuple(exps) != _PAIRS:
        raise ValueError(
            f"bucket surfaces must be the degree-3 monomials {_PAIRS}, got {tuple(exps)}"
        )
    avg_a = [int(a) for a, _ in model.f_avg.exps]
    if len(avg_a) > _MAX_AVG_TERMS or model.n_buckets > _MAX_BUCKETS:
        raise ValueError(
            f"at most {_MAX_AVG_TERMS} f_avg terms and {_MAX_BUCKETS} buckets, "
            f"got {len(avg_a)} and {model.n_buckets}"
        )
    tables = _bucket_tables(model)
    packed = np.zeros(_P_SIZE, np.float32)
    packed[[_P_N_REAL, _P_SHARP, _P_V_RANGE, _P_LSB, _P_LEVELS, _P_N_BUCKETS, _P_N_AVG]] = (
        n_real, model.sharpness, model.v_range, adc.lsb, adc.levels, model.n_buckets, len(avg_a)
    )
    packed[_P_AVG_EXP : _P_AVG_EXP + len(avg_a)] = avg_a
    packed[_P_CONST : _P_CONST + model.n_buckets] = tables["const"]
    coef = np.stack([tables["by_pair"][p] for p in _PAIRS], axis=1)   # (n_buckets, 10)
    packed[_P_COEF : _P_COEF + coef.size] = coef.ravel()
    return ConvTables(
        model=model,
        by_pair=tables["by_pair"],
        const=np.asarray(tables["const"], np.float32),
        n_real=int(n_real),
        lsb=adc.lsb,
        levels=adc.levels,
        mask=torch.ones(n_real, device=device),
        packed=torch.as_tensor(packed, device=device),
        packed_host=packed,
    )


def precompute_weight_planes(
    w: torch.Tensor, mask: torch.Tensor, model: BucketCurvefitModel
) -> dict[str, torch.Tensor]:
    """Per-phase weight precomputation (w: (N, C), mask: (N,)).

    Returns:
      w_pows : (2, N, C) — masked W^1, W^2 (the dot-product operands)
      cs     : (4, C)    — per-channel constants sum_j mask W^b, b = 0..3
      aw     : (n_avg_terms, C) — f_avg coeffs folded with meanW powers
    """
    wm = w * mask[:, None]
    n_real = mask.sum()
    w_pows = torch.stack([wm, wm * wm])
    cs = torch.stack([mask @ torch.ones_like(w), mask @ w, mask @ (w * w), mask @ (w * w * w)])
    mean_w = (mask @ w) / n_real
    aw = torch.stack(
        [float(c) * _ipow(mean_w, int(b)) for c, (_, b) in zip(model.f_avg.coeffs, model.f_avg.exps)]
    )
    return {"w_pows": w_pows, "cs": cs, "aw": aw}


def weight_planes(w_pos: torch.Tensor, w_neg: torch.Tensor, tables: ConvTables) -> dict:
    """Both phases' planes stacked on a leading phase axis — the weight
    operands of :func:`fpca_conv_cuda` / :func:`fpca_conv_basis`:
    ``w_pows (2, 2, N, C)``, ``cs (2, 4, C)``, ``aw (2, T, C)``."""
    pp = precompute_weight_planes(w_pos.float(), tables.mask, tables.model)
    pn = precompute_weight_planes(w_neg.float(), tables.mask, tables.model)
    return {k: torch.stack([pp[k], pn[k]]).contiguous() for k in pp}


def fpca_conv_basis(
    patches: torch.Tensor,
    planes: dict,
    tables: ConvTables,
    bn_offset: torch.Tensor,
    *,
    row_valid: torch.Tensor | None = None,
    n_rows: torch.Tensor | None = None,
    lut: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's math in plain PyTorch: counts ``(M, C)``, float32 and
    integer-valued.  ``row_valid (M,)`` marks the real rows of a region-skip
    compacted bucket; rows with 0 come out as exact zeros.  ``n_rows``, a
    one-element int32 tensor, is the kernel's device row count: rows at or
    past it come out as exact zeros.  ``lut``, the ``(256, 1 + 10)`` table
    of :func:`repro_torch.kernels.fpca_conv.ops._transfer_lut`, selects the
    int8 transfer (see :func:`basis_epilogue`)."""
    x = patches.float()
    xp = {1: x, 2: x * x, 3: x * x * x}
    maskv = tables.mask[:, None]
    rv = {a: xp[a] @ maskv for a in (1, 2, 3)}                 # (M, 1) each
    mm = [{(a, b): xp[a] @ planes["w_pows"][p, b - 1] for (a, b) in _MM_PAIRS} for p in (0, 1)]
    counts = basis_epilogue(rv, mm, planes, tables, bn_offset, row_valid=row_valid, lut=lut)
    if n_rows is not None:
        walked = torch.arange(counts.shape[0], device=counts.device) < n_rows.reshape(())
        counts = torch.where(walked[:, None], counts, torch.zeros_like(counts))
    return counts


def basis_epilogue(
    rv: dict,
    mm: list[dict],
    planes: dict,
    tables: ConvTables,
    bn_offset: torch.Tensor,
    *,
    row_valid: torch.Tensor | None = None,
    lut: torch.Tensor | None = None,
) -> torch.Tensor:
    """Counts from the window sums ``rv[a] (M, 1)`` (a = 1..3) and each
    phase's dot products ``mm[p][(a, b)] (M, C)``: the f_avg estimate, the
    gate bank and the SS-ADC readout of :func:`fpca_conv_basis`.

    With ``lut`` the gate bank is the int8 transfer: the gate input ``xg``
    requantises to 256 levels and one gather from the table gives the
    effective constant and pair coefficients, in :data:`_PAIRS` order."""
    model = tables.model
    mean_i = rv[1] / tables.n_real
    a_i = torch.cat([_ipow(mean_i, int(a)) for a, _ in model.f_avg.exps], dim=1)
    nb = model.n_buckets
    edges = np.arange(nb, dtype=np.float32) / nb
    k = model.sharpness

    def one_phase(p: int) -> torch.Tensor:
        cs = planes["cs"][p]
        xg = (a_i @ planes["aw"][p]) / model.v_range           # (M, C)
        if lut is not None:
            levels = lut.shape[0]
            xg_q = torch.floor(xg * levels).clamp(0, levels - 1).long()
            g = lut[xg_q]                                      # (M, C, 1 + pairs)
            v_pred = g[..., 0]
            for j, (a, b) in enumerate(_PAIRS):
                term = cs[b][None, :] if a == 0 else rv[a] if b == 0 else mm[p][(a, b)]
                v_pred = v_pred + g[..., j + 1] * term
            return v_pred
        v_pred = torch.zeros_like(xg)
        for i in range(nb):
            lo, hi = float(edges[i]), float(edges[i] + 1.0 / nb)
            gate = torch.sigmoid(k * (xg - lo)) + torch.sigmoid(k * (hi - xg)) - 1.0
            acc = torch.full_like(xg, float(tables.const[i]))
            for (a, b), c in tables.by_pair.items():
                term = cs[b][None, :] if a == 0 else rv[a] if b == 0 else mm[p][(a, b)]
                acc = acc + float(c[i]) * term
            v_pred = v_pred + gate * acc
        return v_pred

    top = tables.levels - 1
    up = torch.round(one_phase(0) / tables.lsb).clamp(0, top)
    down = torch.round(one_phase(1) / tables.lsb).clamp(0, top)
    counts = (bn_offset.float()[None, :] + up - down).clamp(0, top)
    if row_valid is not None:
        counts = counts * row_valid[:, None].float()
    return counts


@functools.cache
def _launcher() -> ctypes._CFuncPtr:
    from repro_torch.kernels import _build

    fn = _build.load("fpca_conv").fpca_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _frames_launcher() -> ctypes._CFuncPtr:
    from repro_torch.kernels import _build

    fn = _build.load("fpca_conv").fpca_conv_frames_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected float32 {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def design(patches: torch.Tensor, tables: ConvTables) -> str:
    """The kernel design a launch on these inputs takes: ``"wgmma"`` for at
    most ``TC_MAX_PIXELS`` pixel slots under a model with ``TC_BUCKETS``
    buckets and ``TC_AVG_TERMS`` f_avg terms of degree at most
    ``TC_MAX_AVG_POWER`` in the window mean (the epilogue the kernel is
    compiled for), ``"simt"`` otherwise.  Neither the channel count nor the
    patch matrix's alignment decides it."""
    return _design(patches.shape[1], tables.model)


def _design(n_pixels: int, model: BucketCurvefitModel) -> str:
    takes = (
        n_pixels <= TC_MAX_PIXELS
        and model.n_buckets == TC_BUCKETS
        and len(model.f_avg.exps) == TC_AVG_TERMS
        and max(int(a) for a, _ in model.f_avg.exps) <= TC_MAX_AVG_POWER
    )
    return "wgmma" if takes else "simt"


@functools.cache
def strip_map(n: int, c_i: int) -> np.ndarray:
    """The frames source's offset map: ``TC_MAX_PIXELS / 2`` uint32 words,
    word ``p`` the offsets of pixel slots ``2 p`` (low 16 bits) and ``2 p +
    1`` (high) from a window's first float in a staged tile.  A tile stages
    its 128 windows as ``[ky][window][n c_i floats]`` (the runs of image
    rows they cover), so slot ``k = (c, ky, kx)`` (the patch matrix's
    channel-major order) of a window lies ``ky 128 n c_i + kx c_i + c``
    floats after its start; slots past ``c_i n n`` are 0 (never read)."""
    g = n * c_i
    off = np.zeros(TC_MAX_PIXELS, np.uint32)
    slots = [ky * _TC_TILE * g + kx * c_i + c for c in range(c_i) for ky in range(n) for kx in range(n)]
    if len(slots) > TC_MAX_PIXELS:
        raise ValueError(f"{len(slots)} pixel slots, the tensor-core design takes at most {TC_MAX_PIXELS}")
    off[: len(slots)] = slots
    return off[0::2] | off[1::2] << np.uint32(16)


def frames_fit(frames: torch.Tensor, window: int, tables: ConvTables) -> bool:
    """Whether the tensor-core design reads the non-overlapping ``window x
    window`` windows (stride ``window``, no padding) of these ``(B, H, W,
    c_i)`` frames straight from them (:func:`fpca_conv_frames_cuda`).  Reads
    only the tensor's metadata, whatever its device."""
    return _frames_misfit(frames, window, tables) is None


def _frames_misfit(frames: torch.Tensor, n: int, tables: ConvTables) -> str | None:
    """What keeps the frames source from these frames, or ``None``: float32,
    contiguous, ``c_i n^2`` pixel slots that the tables serve and the design
    takes, and the 16-byte rule of ``csrc/fpca_conv.cu``'s header (a
    16-byte aligned start, image rows of a multiple of 4 floats, ``n c_i
    gcd(w_o, 128)`` a multiple of 4)."""
    if frames.ndim != 4 or frames.dtype != torch.float32 or not frames.is_contiguous():
        return f"needs contiguous float32 (B, H, W, c_i) frames, got {frames.dtype} {tuple(frames.shape)}"
    B, H, W, c_i = frames.shape
    if min(B, c_i, n) < 1 or H < n or W < n:
        return f"no {n} x {n} window in frames {tuple(frames.shape)}"
    if c_i * n * n != tables.n_real:
        return f"windows of {c_i * n * n} pixel slots, the tables {tables.n_real}"
    w_o = W // n
    if _design(tables.n_real, tables.model) != "wgmma":
        return "the tables take the SIMT design"
    if B * (H // n) * w_o >= 2**31:
        return f"{B * (H // n) * w_o} windows, past the kernel's 32-bit row index"
    if frames.data_ptr() % 16 or W * c_i % 4 or n * c_i * math.gcd(w_o, _TC_TILE) % 4:
        return "its row runs break the 16-byte rule"
    return None


def fpca_conv_cuda(
    patches: torch.Tensor,
    planes: dict,
    tables: ConvTables,
    bn_offset: torch.Tensor,
    *,
    row_valid: torch.Tensor | None = None,
    n_rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """FPCA analog conv counts ``(M, C)`` through the CUDA kernel.

    ``patches (M, N)`` float32, ``planes`` from :func:`weight_planes`,
    ``bn_offset (C,)``, ``row_valid (M,)`` optional.  ``n_rows``, a
    one-element int32 tensor on the device, bounds the rows the kernel walks
    (rows at or past it are exact zeros; the launch grid stays sized by M),
    so a launch captured in a CUDA graph serves every count.  A CPU
    ``patches`` takes :func:`fpca_conv_basis`; a CUDA one launches the
    kernel on the current stream, or raises.  Every launch adds one to
    ``fpca_conv_cuda.launches``, to its design's count in
    ``fpca_conv_cuda.designs`` (:func:`design`) and to its source's in
    ``fpca_conv_cuda.sources``; a replay of a captured launch counts nothing.
    """
    if patches.device.type in ("cpu", "meta"):   # meta: shapes only, no compute exists there
        return fpca_conv_basis(patches, planes, tables, bn_offset, row_valid=row_valid, n_rows=n_rows)
    dev = patches.device
    M, N = patches.shape
    if M < 1:
        raise ValueError("fpca_conv_cuda needs at least one window row")
    if N != tables.n_real:
        raise ValueError(f"patches have {N} pixel slots, the tables {tables.n_real}")
    _check("patches", patches, (M, N), dev)
    _check_operands(planes, tables, bn_offset, dev)
    if row_valid is not None:
        _check("row_valid", row_valid, (M,), dev)
    if n_rows is not None and (
        n_rows.device != dev or n_rows.dtype != torch.int32 or n_rows.numel() != 1 or not n_rows.is_contiguous()
    ):
        raise ValueError(
            f"n_rows: expected one contiguous int32 on {dev}, got {n_rows.dtype} "
            f"{tuple(n_rows.shape)} on {n_rows.device}"
        )
    if patches.data_ptr() % 16:   # the tensor-core design's tiles come in by 16-byte copies
        patches = patches.clone()
    out = torch.empty((M, bn_offset.shape[0]), dtype=torch.float32, device=dev)
    chosen = design(patches, tables)
    err = _launch(patches, planes, tables, bn_offset, row_valid, out, tensor_cores=chosen == "wgmma", n_rows=n_rows)
    if err:
        raise RuntimeError(f"fpca_conv kernel ({chosen}) launch failed with CUDA error {err}")
    _count(chosen, "patches")
    return out


def _check_operands(planes: dict, tables: ConvTables, bn_offset: torch.Tensor, dev: torch.device) -> None:
    N, C, T = tables.n_real, bn_offset.shape[0], planes["aw"].shape[1]
    _check("w_pows", planes["w_pows"], (2, 2, N, C), dev)
    _check("cs", planes["cs"], (2, 4, C), dev)
    _check("aw", planes["aw"], (2, T, C), dev)
    _check("bn_offset", bn_offset, (C,), dev)
    _check("packed tables", tables.packed, (_P_SIZE,), dev)


def _count(chosen: str, source: str) -> None:
    fpca_conv_cuda.launches += 1
    fpca_conv_cuda.designs[chosen] += 1
    fpca_conv_cuda.sources[source] += 1


def fpca_conv_frames_cuda(
    frames: torch.Tensor, n: int, planes: dict, tables: ConvTables, bn_offset: torch.Tensor
) -> torch.Tensor:
    """The counts :func:`fpca_conv_cuda` gives the patch matrix of the
    non-overlapping ``n x n`` windows (stride n, no padding) of ``(B, H, W,
    c_i)`` frames on the card, ``(B (H // n) (W // n), C)`` bit for bit,
    with the tensor-core design reading the windows from the frames (the
    frames source): no patch matrix is made.  The frames must pass
    :func:`frames_fit`, or it raises; so does a CPU tensor (the host takes
    the patch source).  Counts its launch as :func:`fpca_conv_cuda` does."""
    if frames.device.type != "cuda":
        raise ValueError(f"the frames source runs on the card only, the frames are on {frames.device}")
    why = _frames_misfit(frames, n, tables)
    if why:
        raise ValueError(f"the frames source does not take these frames at window {n}: {why}")
    dev = frames.device
    _check_operands(planes, tables, bn_offset, dev)
    B, H, W, c_i = frames.shape
    C = bn_offset.shape[0]
    out = torch.empty((B * (H // n) * (W // n), C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _frames_launcher()(
            frames.data_ptr(), planes["w_pows"].data_ptr(), planes["cs"].data_ptr(), planes["aw"].data_ptr(),
            bn_offset.data_ptr(), tables.packed_host.ctypes.data, strip_map(n, c_i).ctypes.data, out.data_ptr(),
            B, H, W, c_i, n, C, planes["aw"].shape[1], tables.model.n_buckets,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"fpca_conv kernel (wgmma, frames) launch failed with CUDA error {err}")
    _count("wgmma", "frames")
    return out


def _launch(patches, planes, tables, bn_offset, row_valid, out, *, tensor_cores: bool, n_rows=None) -> int:
    """One launch of the C entry point on checked inputs; returns its CUDA
    error code (0 on success) and counts nothing.  :func:`fpca_conv_cuda`
    is the caller; a script may call it to time one design beside the
    other."""
    M, N = patches.shape
    with torch.cuda.device(patches.device):
        return _launcher()(
            patches.data_ptr(), planes["w_pows"].data_ptr(), planes["cs"].data_ptr(),
            planes["aw"].data_ptr(), bn_offset.data_ptr(),
            None if row_valid is None else row_valid.data_ptr(),
            None if n_rows is None else n_rows.data_ptr(),
            tables.packed.data_ptr(), tables.packed_host.ctypes.data, out.data_ptr(),
            M, N, out.shape[1], planes["aw"].shape[1], tables.model.n_buckets, int(tensor_cores),
            torch.cuda.current_stream(patches.device).cuda_stream,
        )


fpca_conv_cuda.launches = 0
fpca_conv_cuda.designs = dict.fromkeys(DESIGNS, 0)
fpca_conv_cuda.sources = dict.fromkeys(SOURCES, 0)
