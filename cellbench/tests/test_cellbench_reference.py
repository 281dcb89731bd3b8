"""The plain references against the port's plain backends on the host, at
small sizes: the calibration, the frontend's counts, the window mask, the
gate and the head.  The reference is float64; the port's plain versions
are float32, so counts may flip by one ADC count on a small share."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _cellbench_small import small
from cellbench import calibration, harness
from cellbench.reference import fpca as ref
from cellbench.reference import gate as ref_gate


@pytest.fixture(scope="module")
def cnn():
    cfg, _ = small("fpca_cnn.segments_16cam")
    return cfg, calibration.fit(cfg)


def _weights(cfg, seed=3):
    return harness.make_weights(cfg, harness.generator(seed, torch.device("cpu")), torch.device("cpu"))


def test_the_calibration_copy_predicts_as_the_ports_fit():
    from repro_torch.core.curvefit import BucketCurvefitModel, fit_bucket_model, predict_sigmoid

    cfg, _ = small("fpca_cnn.segments_16cam")
    mine = BucketCurvefitModel.from_dict(calibration.fit(cfg))
    port = fit_bucket_model(n_pixels=75, device="cpu")
    g = torch.Generator().manual_seed(0)
    I, W = torch.rand((4096, 75), generator=g), torch.rand((4096, 75), generator=g)
    a, b = predict_sigmoid(mine, I, W), predict_sigmoid(port, I, W)
    assert float((a - b).abs().max()) < 2e-3
    np.testing.assert_allclose(mine.v_centers, port.v_centers, atol=1e-5)


def test_reference_counts_match_the_ports_basis_and_dense_backends(cnn):
    from repro_torch import fpca
    from repro_torch.core.curvefit import BucketCurvefitModel

    cfg, calib = cnn
    w = _weights(cfg)
    frames = torch.rand((4, 20, 20, 3), generator=torch.Generator().manual_seed(1))
    want = ref.counts(frames, w["kernel"], w["bn_offset"], calib, cfg)
    for backend in ("basis", "reference"):
        fe = fpca.compile(harness.build_program(cfg).frontend, backend=backend, device="cpu",
                          model=BucketCurvefitModel.from_dict(calib), weights=w["kernel"], bn_offset=w["bn_offset"])
        got = fe.run(frames).double()
        d = (got - want).abs()
        assert float(d.max()) <= 1 and float((d > 0).double().mean()) < 0.01, backend


def test_the_head_matches_the_ports(cnn):
    cfg, calib = cnn
    w = _weights(cfg)
    program = harness.build_program(cfg)
    counts = torch.randint(0, 256, (3,) + program.frontend.out_shape).float()
    got = program.apply_head([dict(layer) for layer in w["head"]], counts).double()
    want = ref.head_logits(counts, w["head"], cfg)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("size", [20, 24, 37])
def test_the_window_mask_matches_the_ports(size, cnn):
    from repro_torch.core.mapping import active_window_mask

    cfg = {**cnn[0], "image_h": size, "image_w": size + 3}
    spec = harness.build_program(cfg).frontend.spec
    rng = np.random.default_rng(size)
    bh, bw = -(-size // 8), -(-(size + 3) // 8)
    for _ in range(5):
        blocks = rng.random((bh, bw)) < 0.3
        got = ref.window_mask_from_blocks(torch.as_tensor(blocks), cfg).numpy()
        np.testing.assert_array_equal(got, active_window_mask(spec, blocks))


def test_the_gated_stream_matches_the_ports_segments(cnn):
    from repro_torch import fpca
    from repro_torch.core.curvefit import BucketCurvefitModel

    cfg, calib = cnn
    w = _weights(cfg)
    from cellbench.traffic import generator

    frames = generator.moving_object(5, 1, 24, cfg, {"radius": 3.0, "speed": 0.4, "amplitude": 0.55},
                                     torch.device("cpu"))[0]
    model = fpca.compile(harness.build_program(cfg), device="cpu", model=BucketCurvefitModel.from_dict(calib),
                         weights=w["kernel"], bn_offset=w["bn_offset"], head_params=[dict(x) for x in w["head"]])
    want = ref_gate.camera_stream(frames, w["kernel"], w["bn_offset"], w["head"], calib, cfg, cfg["gate"], 1e-6)
    state, masks, kept, logits = None, [], [], []
    for s in range(6):
        seg = model.run_segment(frames[s * 4 : (s + 1) * 4], state=state)
        state = seg.state
        masks.append(seg.block_masks)
        kept.append(seg.kept_windows)
        logits.append(seg.logits.numpy())
    np.testing.assert_array_equal(np.concatenate(masks), want["keep"].numpy())
    np.testing.assert_array_equal(np.concatenate(kept), want["kept"].numpy())
    assert not want["keep"].all() and want["keep"].any()
    np.testing.assert_allclose(np.concatenate(logits), want["logits"].numpy(), rtol=1e-4,
                               atol=1e-4 * float(want["logits"].abs().max()))


def test_tf32_rounds_to_nearest_even():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-12, -(1 + 3 * 2**-11), 3.0e-3])
    got = ref.to_tf32(x)
    assert got[:5].tolist() == [1.0, 1.0, 1 + 2**-9, 1.0, -(1 + 2**-9)]
    assert abs(float(got[5]) / 3.0e-3 - 1) <= 2**-11


def test_the_cached_calibration_is_the_fit(tmp_path):
    cfg = small("fpca_cnn.offline_b16384")[0]
    fitted = calibration.fit(cfg)
    first = calibration.cached(cfg, tmp_path)
    again = calibration.cached(cfg, tmp_path)
    assert len(list(tmp_path.iterdir())) == 1
    for tables in (first, again):
        assert set(tables) == set(fitted)
        for k, v in fitted.items():
            assert np.array_equal(np.asarray(tables[k]), np.asarray(v)) and type(tables[k]) is type(v), k
