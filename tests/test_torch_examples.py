"""The port's example scripts against their JAX originals, on the host.

Each ``examples/<name>_torch.py`` prints the lines its original prints.
Both ``main``s run in this process (the original through ``sys.argv``, the
twin through ``main(argv)`` with ``--device cpu``); every number both print
that is not a time is compared, line by line.  Counts, logits and the
values derived from them may differ within the fpca limits (ROADMAP.md C:
counts within one ADC count on < 5% of counts); kept windows, cache
misses, fan-out counts, servo thresholds and LM greedy tokens must be
equal.

The originals fit their bucket model (about 10 s each): here each loaded
module's ``fit_bucket_model`` returns the session's fitted model (the
port's a copy of it), and where a script draws weights from ``jax.random``
the twin's drawing function is replaced by the reference's values, so both
compute on the same numbers.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import transformer as jt
from repro_torch.convert import bucket_model_from_dict, head_params_from_numpy, lm_params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
PATH = re.compile(r"(?<!\S)/\S+")


def _load(file: str):
    spec = importlib.util.spec_from_file_location(f"_example_{Path(file).stem}", ROOT / "examples" / file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_model(bucket_model):
    return bucket_model_from_dict(bucket_model.to_dict())


def _pair(name: str, monkeypatch, bucket_model, port_model):
    ref, tw = _load(f"{name}.py"), _load(f"{name}_torch.py")
    if hasattr(ref, "fit_bucket_model"):
        monkeypatch.setattr(ref, "fit_bucket_model", lambda *a, **kw: bucket_model)
        monkeypatch.setattr(tw, "fit_bucket_model", lambda *a, **kw: port_model)
    return ref, tw


def _run(ref, tw, capsys, monkeypatch, argv: list[str]) -> tuple[str, str, dict]:
    monkeypatch.setattr(sys, "argv", [f"{ref.__name__}.py"] + argv)
    ref.main()
    want = capsys.readouterr().out
    got = tw.main(argv + ["--device", "cpu"])
    return want, capsys.readouterr().out, got


def _numbers(out: str, drop: tuple[str, ...]) -> list[tuple[str, list[str]]]:
    """(line, its numbers) for every line that prints one, after removing
    the ``drop`` patterns (times) and file paths."""
    rows = []
    for line in out.splitlines():
        for pat in drop:
            line = re.sub(pat, " ", line)
        nums = NUMBER.findall(PATH.sub(" ", line))
        if nums:
            rows.append((line, nums))
    return rows


def _compare(want: str, got: str, *, drop: tuple[str, ...] = (), close: dict[str, float] | None = None) -> int:
    """Every printed number equal, except on lines starting with a key of
    ``close``, where they agree within its absolute tolerance.  Returns the
    count of numbers compared."""
    close = close or {}
    w, g = _numbers(want, drop), _numbers(got, drop)
    assert len(w) == len(g), (want, got)
    n = 0
    for (lw, nw), (lg, ng) in zip(w, g):
        assert len(nw) == len(ng), (lw, lg)
        tol = next((t for k, t in close.items() if lw.lstrip().startswith(k)), None)
        for a, b in zip(nw, ng):
            if tol is None:
                assert a == b, (lw, lg)
            else:
                assert abs(float(a) - float(b)) <= tol, (lw, lg, tol)
            n += 1
    return n


def test_quickstart_matches_its_original(monkeypatch, capsys, bucket_model, port_model):
    """The bucket model's error, the counts' range (the dense simulation
    on both sides: within one count), and the analytic energy, latency and
    bandwidth numbers."""
    ref, tw = _pair("quickstart", monkeypatch, bucket_model, port_model)
    want, got, res = _run(ref, tw, capsys, monkeypatch, [])
    assert _compare(want, got, close={"activation map": 1.0}) >= 10
    assert res["counts_shape"] == (24, 24, 8) and res["n_cycles"] == 384


def test_region_skipping_matches_its_original(monkeypatch, capsys, bucket_model, port_model):
    """Kept blocks and windows, cycles and energies exactly; the masked
    serving path equals the dense oracle on the kept region on both sides."""
    ref, tw = _pair("region_skipping", monkeypatch, bucket_model, port_model)
    monkeypatch.setattr(tw, "_kernel", lambda dev: torch.tensor(np.asarray(ref._kernel()), device=dev))
    want, got, res = _run(ref, tw, capsys, monkeypatch, [])
    assert _compare(want, got) == 2 + 4 * 8
    assert got.count("kept-region identical=True, skipped zeroed=True") == 4
    assert [r["kept_windows"] for r in res["images"]] == [77, 80, 87, 91]


def test_serve_frontend_matches_its_original(monkeypatch, capsys, bucket_model, port_model):
    """Shapes, compiles and reprograms of the handle, the registered
    configs' output shapes, and the pipeline's requests, fused batches,
    cache hits, misses and evictions."""
    ref, tw = _pair("serve_frontend", monkeypatch, bucket_model, port_model)
    want, got, res = _run(ref, tw, capsys, monkeypatch, [])
    assert _compare(want, got, drop=(r"^cold .*",)) >= 20
    assert (res["requests"], res["batches"], res["cache_misses"]) == (96, 6, 3)


def _export_bundle(ref, path: Path) -> Path:
    """A ``train_fpca_cnn --export``-style bundle of the original's fresh
    20x20 network (meta keys as the training examples write them)."""
    import json

    model, p = ref.fresh_network(20)
    s = model.spec
    meta = dict(image_h=s.image_h, image_w=s.image_w, out_channels=s.out_channels, kernel=s.kernel,
                stride=s.stride, max_kernel=s.max_kernel, adc_bits=8, nvm_levels=16, input_scale=0.05)
    arrays = {"kernel": p["kernel"], "bn_offset": np.full((s.out_channels,), 2.0, np.float32)}
    for i, layer in enumerate(p["head_params"]):
        arrays[f"head{i}_w"], arrays[f"head{i}_b"] = np.asarray(layer["w"]), np.asarray(layer["b"])
    np.savez(path, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
    return path


@pytest.mark.parametrize("variant", ["fresh", "weights", "int8"])
def test_serve_fpca_cnn_matches_its_original(monkeypatch, capsys, bucket_model, port_model, tmp_path, variant):
    """The fresh network (its head drawn by the original), a ``--weights``
    bundle, and that bundle under ``--precision int8``: logits within 0.02
    (counts within the fpca limit move a logit by less), classes, kept
    windows per tick, cache misses and the server's totals exactly."""
    import repro.fpca.executable as j_exe
    import repro_torch.fpca.executable as t_exe

    ref, tw = _pair("serve_fpca_cnn", monkeypatch, bucket_model, port_model)
    # the script fits through compile(): the session's model on both sides
    monkeypatch.setattr(j_exe, "fit_bucket_model", lambda *a, **kw: bucket_model)
    monkeypatch.setattr(t_exe, "fit_bucket_model", lambda *a, **kw: port_model)
    real = tw.fresh_network

    def fresh(image_h, device, seed=0):
        prog, params = real(image_h, device, seed)
        head = ref.fresh_network(image_h, seed)[1]["head_params"]
        params["head_params"] = head_params_from_numpy(
            [{k: np.asarray(v) for k, v in layer.items()} for layer in head], device=device)
        return prog, params

    monkeypatch.setattr(tw, "fresh_network", fresh)
    argv = ["--image-h", "20", "--frames", "6"]
    if variant != "fresh":
        argv += ["--weights", str(_export_bundle(ref, tmp_path / "bundle.npz"))]
    if variant == "int8":
        argv += ["--precision", "int8"]
    want, got, res = _run(ref, tw, capsys, monkeypatch, argv)
    close = {"tick": 0.02, "parity": 0.02}
    assert _compare(want, got, drop=(r"^loaded trained export .*",), close=close) >= 30
    assert res["backend"] == "basis" and res["misses"] == 1


def test_stream_video_matches_its_original(monkeypatch, capsys, bucket_model, port_model):
    """Kept windows of the gated run and the lobby camera's sensor
    accounting, exactly; the wall-clock lines are times."""
    ref, tw = _pair("stream_video", monkeypatch, bucket_model, port_model)
    for mod in (ref, tw):
        monkeypatch.setattr(mod, "N_FRAMES", 30)
    want, got, res = _run(ref, tw, capsys, monkeypatch, [])
    assert _compare(want, got, drop=(r"^delta-gated:.*", r"^dense:.*", r"speedup: [\d.]+x")) >= 10
    assert res["windows_total"] == 30 * 2 * 19 * 19


def test_adaptive_stream_matches_its_original(monkeypatch, capsys, bucket_model, port_model, tmp_path):
    """The servo's thresholds and EMAs tick by tick, convergence, fan-out,
    sticky-bucket and short-circuit counts, the fleet report's rows and the
    telemetry counts, exactly; the fleet's wall fps is a time.  The
    Prometheus snapshot line is left out: its line count and the line it
    quotes come from the process-wide registry, which also holds the cells
    of whatever ran before in this process; the example's own threshold
    gauge is compared in each registry instead."""
    import tempfile

    import repro.fpca.telemetry as j_tel
    import repro_torch.fpca.telemetry as t_tel

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ref, tw = _pair("adaptive_stream", monkeypatch, bucket_model, port_model)
    want, got, res = _run(ref, tw, capsys, monkeypatch, [])
    assert _compare(want, got, drop=(r"wall fps [\d.]+", r"^prometheus snapshot: .*")) >= 80

    def gauge(tel):
        key = 'fpca_gate_threshold{controller="cam0/edges"}'
        return next(line for line in tel.registry().render().splitlines() if line.startswith(key))

    assert gauge(t_tel) == gauge(j_tel) == f'fpca_gate_threshold{{controller="cam0/edges"}} {res["edges"]["threshold"]!r}'
    assert res["fanout_batches"] == 40 and (tmp_path / "adaptive_stream_torch_telemetry.jsonl").exists()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-1.8b", "granite-moe-3b-a800m", "mamba2-2.7b",
                                  "internvl2-76b", "seamless-m4t-medium"])
def test_serve_lm_matches_its_original(monkeypatch, capsys, arch):
    """The original's weights, prompts and frontend embeddings
    (``jax.random``) carried across: the prompt sizes and the printed
    greedy tokens (the first sequence) equal.  danube's prompt (40) runs
    past its smoke window (32); internvl2 prepends 4 patch embeddings,
    seamless encodes 40 frames."""
    ref, tw = _load("serve_lm.py"), _load("serve_lm_torch.py")
    jcfg = jax_reduce(JAX_ARCHS[arch])
    jp = jt.init_model(jax.random.PRNGKey(0), jcfg)
    monkeypatch.setattr(tw, "init_params", lambda cfg, dev, seed: lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), device=dev))
    monkeypatch.setattr(tw, "make_prompts", lambda cfg, b, s, seed: np.array(
        jax.random.randint(jax.random.PRNGKey(1), (b, s), 0, cfg.vocab_size)))

    def frontend(cfg, b, s, dev, seed):
        if cfg.family not in ("vlm", "encdec"):
            return None
        n = cfg.frontend_tokens if cfg.family == "vlm" else s
        return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), (b, n, cfg.frontend_dim))))

    monkeypatch.setattr(tw, "make_frontend", frontend)
    argv = ["--arch", arch, "--batch", "3", "--prompt-len", "40", "--tokens", "8"]
    want, got, res = _run(ref, tw, capsys, monkeypatch, argv)
    drop = (r"in \d+ ms \(\d+ tok/s\)",)
    assert _compare(want, got, drop=drop) == 2 + 2 + 8
    assert res["sequences"].shape == (3, 8) and res["finite"] and res["prefill_launches"] == (0, 0)
