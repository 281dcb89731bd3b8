"""The roofline counts against hand arithmetic."""

import pytest

from cellbench import layout, roofline


def _cfg(name):
    return layout.config(layout.cell({"fpca_frontend_1080": "frontend_1080.dense_b256",
                                      "fpca_cnn": "fpca_cnn.offline_b16384"}[name]))


def test_the_production_frontend_reads_frames_once_and_writes_counts_once():
    cfg = _cfg("fpca_frontend_1080")
    w = roofline.frontend_work(cfg, 256)
    assert w["bytes"] == 256 * 1120 * 1120 * 3 * 4 + 256 * 224 * 224 * 8 * 4 == 4_264_558_592
    assert w["flops"] == 2 * 256 * 224 * 224 * 75 * 8 * 2 == 30_828_134_400
    assert roofline.least_s(w["bytes"], w["flops"]) == pytest.approx(4_264_558_592 / 3.35e12)
    step = roofline.step_work(cfg, 256)
    assert step["bytes"] == w["bytes"] + (8 * 75 + 8) * 4


def test_a_network_step_counts_frames_logits_weights_and_both_flops():
    cfg = _cfg("fpca_cnn")
    w = roofline.step_work(cfg, 8192)
    weights = 8 * 75 + 8 + 4608 * 64 + 64 + 64 * 2 + 2
    assert w["bytes"] == 8192 * 120 * 120 * 3 * 4 + 8192 * 2 * 4 + weights * 4
    assert w["flops"] == 2 * 8192 * 576 * 75 * 8 * 2 + 2 * 8192 * (4608 * 64 + 64 * 2)


def test_a_gated_tick_counts_only_its_kept_windows_and_head_rows():
    cfg = _cfg("fpca_cnn")
    w = roofline.step_work(cfg, 32, kept_windows=1000, head_rows=20)
    assert w["flops"] == 2 * 1000 * 75 * 8 * 2 + 2 * 20 * (4608 * 64 + 64 * 2)
    assert w["bytes"] == 32 * 43200 * 4 + 32 * 2 * 4 + (8 * 75 + 8 + 4608 * 64 + 64 + 130) * 4


def test_bytes_bind_these_steps():
    for name, frames in (("fpca_frontend_1080", 256), ("fpca_cnn", 8192)):
        w = roofline.step_work(_cfg(name), frames)
        assert w["bytes"] / roofline.PEAK_BYTES_PER_S > w["flops"] / roofline.PEAK_FLOPS
