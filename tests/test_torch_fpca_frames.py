"""The fpca kernel's frames source on the host: the staging and the offset
map that ``csrc/fpca_conv.cu``'s tensor-core design uses to read windows
straight from the frames, and the rule that routes a call there.

The kernel cannot run here, so :func:`_staged_windows` walks every tile as
the kernel does (the 16-byte units of ``load_strips`` with their
multiply-shift quotients, the A reads through
:func:`strip_map`) and the tests hold what it reads to ``extract_windows``'s
patch matrix exactly: the same values in the same slots are what keeps the
frames source's counts equal to the patch source's bit for bit (the card
tests in ``tests/test_torch_gpu.py`` hold the counts themselves).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.convert import bucket_model_from_dict
from repro_torch.core.adc import ADCConfig
from repro_torch.core.fpca_sim import extract_windows
from repro_torch.core.mapping import FPCASpec
from repro_torch.kernels.fpca_conv import kernel
from repro_torch.kernels.fpca_conv.ops import conv_source

TILE = 128   # the tensor-core design's window rows a tile


def _quot(x, d: int):
    """``x // d`` as ``csrc/fpca_conv.cu``'s ``quot`` takes it for 0 <= x <
    2^31: one wide multiply by ``divider(d)``'s magic and a shift."""
    log2d = max(int(d - 1).bit_length(), 0)
    magic = ((1 << (31 + log2d)) + d - 1) // d
    assert magic < 1 << 32
    return (np.asarray(x, dtype=object) * magic >> (31 + log2d)).astype(np.int64)


def _staged_windows(frames: np.ndarray, n: int) -> tuple[np.ndarray, bool]:
    """``(M, c_i n n)``: what the tensor-core design's A fragments read for
    every window of ``frames (B, H, W, c_i)`` on the frames source, walked
    tile by tile as ``csrc/fpca_conv.cu`` walks it; and whether every
    16-byte unit started on a 16-byte boundary of the frames."""
    B, H, W, c_i = frames.shape
    h_o, w_o, g = H // n, W // n, n * c_i
    M, N, pitch = B * h_o * w_o, c_i * n * n, W * c_i
    flat = np.concatenate([frames.reshape(-1), np.zeros(4, np.float32)])   # a misaligned last unit reads past
    units_ky = TILE * g // 4
    w = np.arange(units_ky)                               # load_strips: units of kernel row 0
    r = _quot(4 * w, g)                                   # the first window each unit reads
    pairs = kernel.strip_map(n, c_i)
    off = np.stack([pairs & 0xFFFF, pairs >> 16], 1).reshape(-1)[:N].astype(np.int64)
    out, aligned = np.empty((M, N), np.float32), True
    for m0 in range(0, M, TILE):
        rows = min(TILE, M - m0)
        ok = r < rows
        m = m0 + r[ok]                                    # the window's frame b, output row i, column j
        row = _quot(m, w_o)
        b = _quot(row, h_o)
        first = b * H * W * c_i + (row - b * h_o) * n * pitch + (m - row * w_o) * g + (4 * w[ok] - r[ok] * g)
        stage = np.zeros((n, units_ky, 4), np.float32)
        for ky in range(n):
            src = first + ky * pitch
            aligned &= not (src % 4).any()
            stage[ky, w[ok]] = flat[src[:, None] + np.arange(4)]
        stage = stage.reshape(-1)
        out[m0 : m0 + rows] = stage[np.arange(rows)[:, None] * g + off[None, :]]   # the A reads
    return out, aligned


GEOMETRIES = {
    # name: (B, H, W, c_i, n)
    "fpca_cnn_120x120_ragged_last_tile": (3, 120, 120, 3, 5),    # 1,728 windows: 13 tiles and 64 rows
    "frontend_1120x1120": (1, 1120, 1120, 3, 5),                  # tiles straddle rows of 224 windows
    "cropped_edges_tiles_straddle_frames": (5, 43, 44, 3, 5),    # 64 windows a frame, rows of 8
    "one_channel": (3, 50, 80, 1, 5),
    "n4_four_channels_odd_rows": (2, 36, 36, 4, 4),              # g = 16: any row length
}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_the_staged_strips_read_through_the_map_are_the_patch_matrix(name):
    B, H, W, c_i, n = GEOMETRIES[name]
    frames = np.random.default_rng(sum(GEOMETRIES[name])).uniform(0, 1, (B, H, W, c_i)).astype(np.float32)
    spec = FPCASpec(image_h=H, image_w=W, out_channels=8, kernel=n, stride=n, max_kernel=n, in_channels=c_i)
    want = extract_windows(torch.from_numpy(frames), spec).reshape(-1, c_i * n * n).numpy()
    staged, aligned = _staged_windows(frames, n)
    assert aligned and np.array_equal(staged, want)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 15, 24, 25, 224, 1000, 4095, 65537, 2**30 + 3, 2**31 - 1])
def test_the_kernels_multiply_shift_quotient_is_exact_below_2_31(d):
    x = np.array(sorted({0, 1, d - 1, d, d + 1, 2 * d - 1, 2**31 - 1, 2**31 - 2, 2**31 - 1 - (2**31 - 1) % d}
                        | set(range(0, 1 << 16, 97)) | set(range(2**31 - 1, 2**31 - 1 - 10**6, -7919))))
    x = x[(x >= 0) & (x < 2**31)]
    assert np.array_equal(_quot(x, d), x // d)


def test_the_strip_map_packs_two_slots_a_word_in_the_patch_matrix_order():
    pairs = kernel.strip_map(5, 3)
    off = np.stack([pairs & 0xFFFF, pairs >> 16], 1).reshape(-1)
    assert pairs.dtype == np.uint32 and pairs.shape == (kernel.TC_MAX_PIXELS // 2,)
    # slot k = (c, ky, kx): ky 128 g + kx c_i + c, g = 15; slots 75..79 unused
    assert list(off[[0, 1, 5, 25, 74]]) == [0, 3, TILE * 15, 1, 4 * TILE * 15 + 4 * 3 + 2]
    assert not off[75:].any()
    with pytest.raises(ValueError, match="at most 80"):
        kernel.strip_map(5, 4)


@dataclasses.dataclass
class _Frames:
    """A tensor's metadata, all the routing rule reads: the cells' calls
    without allocating their frames."""

    shape: tuple
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cuda")
    ptr: int = 1 << 20
    contiguous: bool = True

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def is_contiguous(self) -> bool:
        return self.contiguous

    def data_ptr(self) -> int:
        return self.ptr


@pytest.fixture(scope="module")
def tables(bucket_model):
    model = bucket_model_from_dict(bucket_model.to_dict())
    return {n: kernel.conv_tables(model, ADCConfig(), n, torch.device("cpu")) for n in (75, 100)}


def _spec(size, **kw) -> FPCASpec:
    return FPCASpec(image_h=size, image_w=size, out_channels=8, kernel=5, **{"stride": 5, **kw})


CELLS = {
    "frontend_1080.dense_b256": ((256, 1120, 1120, 3), _spec(1120)),
    "fpca_cnn.offline_b16384": ((16384, 120, 120, 3), _spec(120)),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_benchmarks_dense_calls_take_the_frames_source(tables, cell):
    shape, spec = CELLS[cell]
    assert conv_source(_Frames(shape), spec, tables[75], impl="cuda", masked=False) == "frames"
    small = torch.rand((2, *shape[1:]))   # the rule on a real tensor of the cell's frame size
    assert kernel.frames_fit(small, spec.max_kernel, tables[75])


EXCLUDED = {
    # name: (frames, spec, impl, masked, pixel slots)
    "masked": (_Frames((64, 120, 120, 3)), _spec(120), "cuda", True, 75),
    "stride_below_kernel": (_Frames((64, 120, 120, 3)), _spec(120, stride=4), "cuda", False, 75),
    "padding": (_Frames((64, 120, 120, 3)), _spec(120, padding=1), "cuda", False, 75),
    "binning": (_Frames((64, 120, 120, 3)), _spec(120, binning=2), "cuda", False, 75),
    "bf16_frames": (_Frames((64, 120, 120, 3), dtype=torch.bfloat16), _spec(120), "cuda", False, 75),
    "simt_design": (_Frames((64, 120, 120, 4)), dataclasses.replace(_spec(120), in_channels=4), "cuda", False, 100),
    "misaligned_runs": (_Frames((64, 48, 48, 3)), _spec(48), "cuda", False, 75),     # rows of 9 windows
    "misaligned_start": (_Frames((64, 120, 120, 3), ptr=(1 << 20) + 4), _spec(120), "cuda", False, 75),
    "not_contiguous": (_Frames((64, 120, 120, 3), contiguous=False), _spec(120), "cuda", False, 75),
    "cpu_tensor": (_Frames((64, 120, 120, 3), device=torch.device("cpu")), _spec(120), "cuda", False, 75),
    "basis_impl": (_Frames((64, 120, 120, 3)), _spec(120), "basis", False, 75),
}


@pytest.mark.parametrize("name", list(EXCLUDED))
def test_every_excluded_call_keeps_the_patch_source(tables, name):
    frames, spec, impl, masked, n_pixels = EXCLUDED[name]
    assert conv_source(frames, spec, tables[n_pixels], impl=impl, masked=masked) == "patches"


@pytest.mark.parametrize("w_o", [4, 6, 8, 9, 12, 24, 30, 224])
def test_the_rule_takes_only_frames_whose_runs_stage_whole_and_aligned(tables, w_o):
    """Output-row segments start at multiples of gcd(w_o, 128) windows, so
    with g = 15 floats a window the runs stay on 16-byte boundaries only
    for w_o a multiple of 4: the rule takes those frames, and the others
    would stage misaligned or wrong."""
    frames = np.random.default_rng(w_o).uniform(0, 1, (1, 50, 5 * w_o, 3)).astype(np.float32)
    staged, aligned = _staged_windows(frames, 5)
    want = extract_windows(torch.from_numpy(frames), _spec(5 * w_o)).reshape(-1, 75).numpy()
    fits = kernel.frames_fit(torch.from_numpy(frames), 5, tables[75])
    assert fits == (w_o % 4 == 0)
    assert (aligned and np.array_equal(staged, want)) == fits


def test_the_frames_source_refuses_the_host_and_frames_it_does_not_take(tables):
    """The frames source runs on the card only (a host call takes the patch
    source, :func:`conv_source`), and names what keeps it from frames
    before it launches anything."""
    g = torch.Generator().manual_seed(6)
    w = torch.rand((75, 8), generator=g)
    planes = kernel.weight_planes(w, w.roll(1, 1), tables[75])
    bn = torch.randint(0, 20, (8,), generator=g).float()
    launches = kernel.fpca_conv_cuda.launches
    with pytest.raises(ValueError, match="on the card only"):
        kernel.fpca_conv_frames_cuda(torch.rand((3, 40, 40, 3)), 5, planes, tables[75], bn)
    meta = torch.empty((3, 40, 40, 4), device="meta")
    assert "windows of 100 pixel slots, the tables 75" in kernel._frames_misfit(meta, 5, tables[75])
    assert "16-byte rule" in kernel._frames_misfit(torch.empty((3, 45, 45, 3), device="meta"), 5, tables[75])
    assert kernel.fpca_conv_cuda.launches == launches
    assert set(kernel.fpca_conv_cuda.sources) == {"frames", "patches"}
