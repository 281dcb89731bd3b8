"""Hardware/algorithm co-design on the paper's native workload, in PyTorch:
train a small VWW-class classifier whose first layer IS the FPCA analog
frontend, on the CUDA card (``--device cpu`` runs it on the host).

    PYTHONPATH=src python examples/train_fpca_cnn_torch.py [--steps 150] [--device cpu]

The torch twin of ``examples/train_fpca_cnn.py``: the same functions, flags
and export bundle.  Two trainings of the same network, both *deployed* on
the circuit oracle (hard NVM quantisation + analog non-linearity + SS-ADC):

* **hw-aware**  — trained THROUGH the differentiable sigmoid bucket model
                  (+ STEs), the paper's §4 contribution;
* **naive**     — trained with an ideal float convolution, then dropped onto
                  the analog hardware.

The gap in deployed accuracy is the reason the bucket-select model exists.
Training runs the dense differentiable path under autograd; deployment can
also run through the fpca kernel (``deployed_accuracy(..., backend="cuda")``).

Hardware regime: extreme-edge — 4-bit SS-ADC, 8-level (3-bit) NVM weights
(``--adc-bits 8 --nvm-levels 16`` is the paper's benign regime).

``--export model.npz`` saves the trained hw-aware network as an
``FPCAModelProgram`` parameter bundle (NVM kernel + BN offsets + head
weights + the counts->units digital gain), with the same keys and meta as
the JAX example's, so either package's ``serve_fpca_cnn`` reads it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.fpca_cnn import HEAD, N_CLASSES, N_HIDDEN
from repro_torch.core.adc import ADCConfig
from repro_torch.core.curvefit import fit_bucket_model
from repro_torch.core.device_models import CircuitParams
from repro_torch.core.fpca_sim import WeightEncoding
from repro_torch.core.frontend import FPCAFrontend
from repro_torch.core.mapping import FPCASpec
from repro_torch.data.pipeline import SyntheticVWW
from repro_torch.device import resolve_device
from repro_torch.fpca import FPCAModelProgram, FPCAProgram
from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_adamw
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten

SPEC = FPCASpec(image_h=60, image_w=60, out_channels=8, kernel=5, stride=5)
# the defaults of main's flags
STEPS, BATCH, ADC_BITS, NVM_LEVELS = 200, 32, 4, 8


# the trained MLP IS configs.fpca_cnn.HEAD: deriving its dims from there
# keeps the --export model program and the training head in lockstep
def init_head(generator, h, w, c, n_hidden=N_HIDDEN, n_classes=N_CLASSES, *, device=None):
    dev = resolve_device(device)
    d = h * w * c
    w1 = torch.randn((d, n_hidden), generator=generator) * d**-0.5
    w2 = torch.randn((n_hidden, n_classes), generator=generator) * n_hidden**-0.5
    return {
        "w1": w1.to(dev),
        "b1": torch.zeros((n_hidden,), device=dev),
        "w2": w2.to(dev),
        "b2": torch.zeros((n_classes,), device=dev),
    }


def head_apply(p, acts):
    x = acts.reshape(acts.shape[0], -1)
    x = torch.relu(x @ p["w1"] + p["b1"])
    return x @ p["w2"] + p["b2"]


def ideal_frontend(kernel, images):
    """Float conv + ReLU over the same physical 5x5 window grid, in IEEE
    f32 (cuDNN's TF32 off)."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled, benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic, allow_tf32=False,
    ):
        out = F.conv2d(images.permute(0, 3, 1, 2), kernel.permute(0, 3, 1, 2), stride=SPEC.stride)
    return torch.relu(out.permute(0, 2, 3, 1))


def loss_fn(mode: str, layer: FPCAFrontend, p: dict, images, labels):
    """Cross-entropy of the network on one batch: the frontend through the
    differentiable bucket model (``"hw_aware"``) or an ideal convolution
    (``"naive"``)."""
    if mode == "hw_aware":
        acts = layer.apply(p["frontend"], images, train=True)
    else:
        acts = ideal_frontend(p["frontend"]["kernel"], images)
    logits = head_apply(p["head"], acts)
    onehot = F.one_hot(labels, N_CLASSES).float()
    return -(onehot * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def train(mode: str, layer: FPCAFrontend, data: SyntheticVWW, steps: int, batch: int, seed=0,
          *, params: dict | None = None):
    """``steps`` AdamW steps of ``mode`` (``"hw_aware"`` or ``"naive"``) on
    the layer's device.  The initial parameters are drawn from ``seed``
    unless ``params`` gives them (copied, not updated).  Returns the trained
    parameters and, per step, the loss, the grad norm and the host
    milliseconds of the step (it ends by reading the loss)."""
    dev = layer.device
    if params is None:
        params = {
            "frontend": layer.init(torch.Generator().manual_seed(seed)),
            "head": init_head(torch.Generator().manual_seed(seed + 1), *layer.out_shape, device=dev),
        }
    params = tree_map(lambda t: torch.as_tensor(t, dtype=torch.float32).to(dev, copy=True), params)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    opt = init_adamw(params)
    opt_cfg = AdamWConfig(lr=2e-3, weight_decay=0.01, warmup_steps=10, total_steps=steps)
    history = []
    for step in range(steps):
        t0 = time.perf_counter()
        b = data.batch_at(step, batch)
        images = torch.as_tensor(b["images"], device=dev)
        labels = torch.as_tensor(b["labels"], dtype=torch.int64, device=dev)
        loss = loss_fn(mode, layer, params, images, labels)
        # naive training leaves bn_offset unused: its gradient is zeros, as jax.grad gives
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        params, opt, metrics = adamw_update(tree_unflatten(params, list(grads)), opt, params, opt_cfg)
        history.append({"loss": float(loss.detach()), "grad_norm": float(metrics["grad_norm"]),
                        "ms": (time.perf_counter() - t0) * 1e3})
        if (step + 1) % 25 == 0:
            print(f"  [{mode}] step {step+1:4d} loss {history[-1]['loss']:.4f}", flush=True)
    return tree_map(torch.Tensor.detach, params), history


@torch.no_grad()
def deployed_accuracy(layer: FPCAFrontend, params, data: SyntheticVWW, n=512, backend="reference") -> float:
    """Accuracy on ``n`` held-out images, deployed: ``backend="reference"``
    evaluates the circuit oracle (the real hardware semantics); a fused
    backend (``"cuda"``) evaluates the calibrated bucket model through the
    fpca kernel, one launch per batch of 128."""
    correct = 0
    for step in range(n // 128):
        b = data.batch_at(10_000 + step, 128)
        acts = layer.apply(params["frontend"], b["images"], train=False, backend=backend)
        pred = head_apply(params["head"], acts).argmax(-1).cpu().numpy()
        correct += int((pred == b["labels"]).sum())
    return correct / n


def export_model_program(
    layer: FPCAFrontend, params: dict
) -> tuple[FPCAModelProgram, list[dict]]:
    """The trained network as a compileable model program + head params.

    The head consumed activations in convolution units
    (``counts * adc.lsb * gain``), so the export bakes that digital gain in
    as the model's ``input_scale``: ``fpca.compile(model)`` then serves the
    trained computation from raw SS-ADC counts.
    """
    model = FPCAModelProgram(
        frontend=layer.config,
        head=HEAD,
        input_scale=float(layer.config.adc.lsb * layer.gain),
    )
    head_params = [
        {"w": params["head"]["w1"], "b": params["head"]["b1"]},
        {"w": params["head"]["w2"], "b": params["head"]["b2"]},
    ]
    return model, head_params


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def save_export(
    path: str, layer: FPCAFrontend, params: dict, calib_images=None
) -> None:
    """Serialize the export for ``serve_fpca_cnn`` (npz bundle, the JAX
    example's keys and meta).

    When ``calib_images`` is given, the bundle also carries per-stage int8
    activation scales (``quant_scales``) calibrated by running the trained
    f32 head on the circuit-oracle counts for those images.
    """
    model, head_params = export_model_program(layer, params)
    spec, adc, enc = layer.config.spec, layer.config.adc, layer.config.enc
    meta = {
        "image_h": spec.image_h, "image_w": spec.image_w,
        "out_channels": spec.out_channels, "kernel": spec.kernel,
        "stride": spec.stride, "max_kernel": spec.max_kernel,
        "adc_bits": adc.bits, "nvm_levels": enc.n_levels,
        "input_scale": model.input_scale,
    }
    arrays = {
        "kernel": _np(params["frontend"]["kernel"]),
        "bn_offset": _np(params["frontend"]["bn_offset"]),
        "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    }
    for i, p in enumerate(head_params):
        arrays[f"head{i}_w"] = _np(p["w"])
        arrays[f"head{i}_b"] = _np(p["b"])
    if calib_images is not None:
        from repro_torch.models.quant import calibrate_head_scales, pack_act_scales

        # the frontend oracle emits activation units (counts * input_scale);
        # the model program consumes raw counts, so divide the scale back out
        with torch.no_grad():
            acts = layer.apply(params["frontend"], calib_images, train=False)
        counts = acts / model.input_scale
        scales = calibrate_head_scales(model, model.bind_head_params(head_params, device=layer.device), counts)
        arrays["quant_scales"] = pack_act_scales(model, scales)
    np.savez(path, **arrays)
    print(f"exported FPCAModelProgram parameters -> {path} "
          f"(serve with examples/serve_fpca_cnn.py --weights {path})")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--adc-bits", type=int, default=ADC_BITS)
    ap.add_argument("--nvm-levels", type=int, default=NVM_LEVELS)
    ap.add_argument("--export", metavar="PATH",
                    help="save the trained hw-aware network as an "
                         "FPCAModelProgram bundle for serve_fpca_cnn.py")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    circuit = CircuitParams()
    print(f"fitting bucket model on {dev}...")
    model = fit_bucket_model(circuit, device=dev)
    layer = FPCAFrontend(
        FPCAProgram(
            spec=SPEC,
            circuit=circuit,
            adc=ADCConfig(bits=args.adc_bits),
            enc=WeightEncoding(n_levels=args.nvm_levels),
        ),
        model=model,
        device=dev,
    )
    print(f"frontend: {SPEC.image_h}x{SPEC.image_w}x3 -> {layer.out_shape}, "
          f"calibration r2={layer.calibration_r2:.4f}")
    data = SyntheticVWW((SPEC.image_h, SPEC.image_w))

    results = {}
    for mode in ("hw_aware", "naive"):
        t0 = time.time()
        print(f"training ({mode}) ...")
        params, _ = train(mode, layer, data, args.steps, args.batch)
        acc = deployed_accuracy(layer, params, data)
        results[mode] = acc
        print(f"  [{mode}] deployed-on-circuit accuracy: {acc*100:.1f}% "
              f"({time.time()-t0:.0f}s)")
        if mode == "hw_aware" and args.export:
            save_export(args.export, layer, params,
                        calib_images=data.batch_at(0, args.batch)["images"])

    gap = results["hw_aware"] - results["naive"]
    print(f"\nco-design gap (hw-aware - naive, both deployed on analog oracle): "
          f"{gap*100:+.1f} points")


if __name__ == "__main__":
    main()
