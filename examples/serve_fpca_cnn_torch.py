"""Serve a whole FPCA model — analog frontend + digital CNN head — through
ONE ``fpca.compile()``, in PyTorch.

    PYTHONPATH=src python examples/serve_fpca_cnn_torch.py                  # fresh net
    PYTHONPATH=src python examples/serve_fpca_cnn_torch.py --weights m.npz  # trained
    PYTHONPATH=src python examples/serve_fpca_cnn_torch.py --image-h 24 --frames 6 --device cpu

The torch twin of ``examples/serve_fpca_cnn.py``: the same flags, plus
``--device`` (default: the CUDA card).  ``--backend`` defaults to the one
the device takes: the fpca kernel (``cuda``) on the card, its plain version
(``basis``) on the host.  ``--weights`` takes the bundle
``examples/train_fpca_cnn_torch.py --export`` (or the JAX example's
``--export``) writes, the hw-aware trained network; without it a
freshly-initialised network on the same architecture is served.

What it demonstrates, end to end:

1. **compile once** — ``fpca.compile(FPCAModelProgram)`` returns a
   ``CompiledModel`` whose ``.run()`` produces class logits from raw frames,
   bit-identical to composing a frontend handle with the reference head;
2. **reprogram cheaply** — rewriting the NVM planes *or* the head weights
   never builds a new executable (asserted via ``cache_info()``);
3. **stream with skip-aware classification** — each delta-gated tick patches
   its kept windows into the running effective activation map, so the head
   yields a per-tick class decision even when most windows are skipped;
4. **fleet serving** — the same model program registered into
   ``FPCAPipeline`` / ``StreamServer`` (logits in ``StreamFrameResult``),
   with the head's FLOPs/latency accounted next to the executed-window
   stats by ``analysis.model_streaming_report``.

``--precision int8`` serves the quantised head; its bucket transfer stays
f32 (only ``basis`` lowers the int8 transfer table).  ``main`` returns the
numbers it prints.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs.fpca_cnn import make_model_program
from repro_torch.core import analysis
from repro_torch.core.adc import ADCConfig
from repro_torch.core.fpca_sim import WeightEncoding
from repro_torch.core.mapping import FPCASpec
from repro_torch.data.pipeline import SyntheticMovingObject
from repro_torch.device import resolve_device
from repro_torch.fpca import DeltaGateConfig, FPCAModelProgram, compile as fpca_compile
from repro_torch.fpca.backends import default_backend_name
from repro_torch.serving.fpca_pipeline import FPCAPipeline, FrontendRequest
from repro_torch.serving.streaming import StreamServer
from repro_torch.training.tree import tree_map


def load_export(path: str, device: torch.device) -> tuple[FPCAModelProgram, dict]:
    """Rebuild the model program + parameters train_fpca_cnn_torch.py exported."""
    bundle = np.load(path)
    meta = json.loads(bytes(bundle["meta"]).decode())
    spec = FPCASpec(
        image_h=meta["image_h"], image_w=meta["image_w"],
        out_channels=meta["out_channels"], kernel=meta["kernel"],
        stride=meta["stride"], max_kernel=meta["max_kernel"],
    )
    model = make_model_program(
        spec,
        adc=ADCConfig(bits=meta["adc_bits"]),
        enc=WeightEncoding(n_levels=meta["nvm_levels"]),
        input_scale=meta["input_scale"],
    )
    head_params = []
    i = 0
    while f"head{i}_w" in bundle:
        head_params.append({"w": torch.as_tensor(bundle[f"head{i}_w"], device=device),
                            "b": torch.as_tensor(bundle[f"head{i}_b"], device=device)})
        i += 1
    out = {
        "kernel": bundle["kernel"],
        "bn_offset": bundle["bn_offset"],
        "head_params": head_params,
    }
    if "quant_scales" in bundle:
        out["quant_scales"] = bundle["quant_scales"]
    return model, out


def fresh_network(image_h: int, device: torch.device, seed: int = 0) -> tuple[FPCAModelProgram, dict]:
    spec = FPCASpec(image_h=image_h, image_w=image_h, out_channels=8,
                    kernel=5, stride=5, max_kernel=5)
    model = make_model_program(spec)
    rng = np.random.default_rng(seed)
    kernel = (rng.normal(size=model.frontend.kernel_shape) * 0.2).astype(np.float32)
    return model, {
        "kernel": kernel,
        "bn_offset": np.zeros((spec.out_channels,), np.float32),
        "head_params": model.init_head(torch.Generator().manual_seed(seed), device=device),
    }


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", metavar="NPZ",
                    help="bundle from train_fpca_cnn_torch.py --export")
    ap.add_argument("--image-h", type=int, default=60,
                    help="sensor size for the fresh-network path")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--backend", default=None,
                    help="default: cuda on the card, basis on the host")
    ap.add_argument("--precision", choices=("f32", "int8"), default="f32",
                    help="int8 serves the calibrated quantised lowering "
                         "(bounded parity vs the f32 reference)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    backend = args.backend or default_backend_name(dev)
    res: dict = {"backend": backend}

    if args.weights:
        model, params = load_export(args.weights, dev)
        print(f"loaded trained export {args.weights}")
    else:
        model, params = fresh_network(args.image_h, dev)
        print("serving a freshly-initialised network (pass --weights for the "
              "trained one)")

    serve_model, serve_head = model, params["head_params"]
    if args.precision == "int8":
        from repro_torch.models.quant import quantize_head_params, unpack_act_scales

        serve_model = model.replace(precision="int8")
        act_scales = (unpack_act_scales(model, params["quant_scales"])
                      if "quant_scales" in params else None)
        serve_head = quantize_head_params(
            serve_model, params["head_params"], act_scales=act_scales
        )
        print("precision: int8 "
              + ("(export-calibrated activation scales)" if act_scales
                 else "(data-free full-scale calibration)"))
    spec = model.spec
    print(f"model: {spec.image_h}x{spec.image_w}x{spec.in_channels} "
          f"-> frontend {model.frontend.out_shape} -> head "
          f"{' -> '.join(str(s) for s in model.head_shapes()[1:])} "
          f"({model.n_classes} classes)")

    # 1. compile the WHOLE model once; serve a batch of frames as logits
    m = fpca_compile(
        serve_model, backend=backend, device=dev, weights=params["kernel"],
        bn_offset=params["bn_offset"], head_params=serve_head,
    )
    rng = np.random.default_rng(1)
    batch = rng.uniform(0, 1, (8, spec.image_h, spec.image_w, 3)).astype(np.float32)
    logits = _np(m.run(batch))
    res["logits"] = logits
    res["classes"] = np.argmax(logits, -1).tolist()
    print(f"batched run: {batch.shape[0]} frames -> logits {logits.shape}, "
          f"classes {res['classes']}")

    # parity: the f32 model run is bit-identical to frontend handle +
    # reference head apply; int8 is parity-BOUNDED against that f32 reference
    fe = fpca_compile(model.frontend, backend=backend, device=dev,
                      weights=params["kernel"], bn_offset=params["bn_offset"],
                      model=m.model)
    counts = fe.run(batch)
    res["counts"] = _np(counts)
    ref = _np(model.apply_head(params["head_params"], counts))
    if args.precision == "int8":
        from repro_torch.models.quant import logit_parity

        par = logit_parity(ref, logits)
        res["parity"] = par
        print(f"parity (int8 vs f32 reference): max |dlogit| "
              f"{par['max_abs_divergence']:.4f}, top-1 agreement "
              f"{par['top1_agreement']:.2f}")
    else:
        assert np.array_equal(logits, ref), "fused logits diverge from reference"
        print("parity: fused frontend+head run is bit-identical to the "
              "composed reference")

    # 2. reprogram NVM planes AND head weights: guaranteed zero recompiles
    misses = m.cache_info().misses
    m.reprogram(params["kernel"] * 0.9,
                head_params=tree_map(lambda a: a * 1.1, params["head_params"]))
    m.run(batch)
    assert m.cache_info().misses == misses, "reprogram must never recompile"
    res["misses"] = misses
    print(f"reprogram (NVM + head): zero recompiles "
          f"(cache misses still {misses})")
    m.reprogram(params["kernel"], params["bn_offset"], head_params=serve_head)

    # 3. skip-aware streaming classification off the handle
    cam = SyntheticMovingObject((spec.image_h, spec.image_w), seed=3)
    gate = DeltaGateConfig(threshold=0.02, hysteresis=1, keyframe_interval=0)
    h_o, w_o, _ = model.frontend.out_shape
    kept = 0
    ticks = []
    for r in m.stream((cam.frame_at(t) for t in range(args.frames)), gate=gate):
        kept += r.kept_windows
        ticks.append({"kept": r.kept_windows, "class": r.predicted_class, "logits": np.asarray(r.logits),
                      "counts": np.asarray(r.counts), "block_mask": np.asarray(r.block_mask)})
        if r.frame_idx < 4 or r.frame_idx == args.frames - 1:
            print(f"  tick {r.frame_idx:3d}: kept {r.kept_windows:3d}/"
                  f"{r.total_windows} windows -> class "
                  f"{r.predicted_class} (logits {np.round(r.logits, 2)})")
    total = args.frames * h_o * w_o
    res["stream"] = {"ticks": ticks, "kept": kept, "total": total}
    print(f"stream: executed {kept}/{max(total, 1)} windows "
          f"({kept/max(total, 1):.1%}) with a class decision every tick")

    # 4. fleet path: pipeline + StreamServer, head cost accounted
    pipe = FPCAPipeline(m.model, backend=backend, device=dev)
    pipe.register("vww", serve_model, params["kernel"], params["bn_offset"],
                  head_params=serve_head)
    out = pipe.serve([FrontendRequest("vww", batch[0])])
    res["pipeline_logits"] = _np(out[0])
    print(f"pipeline serve: logits {res['pipeline_logits'].shape} "
          f"(class {int(np.argmax(res['pipeline_logits']))})")
    server = StreamServer(pipe, gate)
    server.add_stream("cam0", "vww")
    session = server.sessions["cam0"]
    for results in server.run({"cam0": cam.frame_at(t)}
                              for t in range(args.frames)):
        pass
    res["server"] = {"frames": server.stats.frames, "kept": server.stats.windows_kept,
                     "total": server.stats.windows_total}
    print(f"server: {server.stats.frames} frames, kept "
          f"{server.stats.windows_kept}/{server.stats.windows_total} windows")
    if session.block_masks:
        rep = analysis.model_streaming_report(model, list(session.block_masks))
        res["accounting"] = rep
        print(f"accounting: frontend energy {rep['energy_vs_dense']:.2f}x "
              f"dense, head {rep['head_macs_per_frame']/1e3:.1f} kMAC/frame, "
              f"model fps_effective {rep['model_fps_effective']:.0f}")
    return res


if __name__ == "__main__":
    main()
