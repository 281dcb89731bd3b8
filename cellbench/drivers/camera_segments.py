"""Cameras served in chained streaming segments: ``handle.run_segment``
of ``segment`` gated ticks a call, each camera's ``SegmentState`` threaded
into its next call, round robin over the cameras, each segment's logits
read on the host.

The mix sets ``cameras`` clips of ``clip_ticks`` moving-object frames
(camera ``i`` serves clip ``i`` of ``traffic/generator.py``), made in
set-up.  When a clip ends the camera
starts it again from a fresh state, so every pass serves the same segments
and set-up's pass captures every graph the window replays; the window
serves whole passes.  The clips are staged on the device: host frames
would put pageable copies, host work that spreads from run to run, into
every segment.

The check runs the reference stream of every camera once and compares
every segment's gate masks, kept-window counts and logits, and the counts
of a reservoir sample of ``checked_calls`` segments drawn from the seed.
"""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch

from cellbench import compare
from cellbench.reference import gate as ref_gate
from cellbench.timing import Marks, call_range, traced
from cellbench.traffic import generator as frames_of


def setup(ctx, gen: torch.Generator) -> None:
    from cellbench.harness import compile_handle

    del gen
    t, s = ctx.traffic, ctx.state
    if t["clip_ticks"] % t["segment"]:
        raise ValueError("a clip holds whole segments")
    t0 = time.perf_counter()
    s["clips"] = frames_of.moving_object(ctx.seed, t["cameras"], t["clip_ticks"], ctx.cfg, t["frames"], ctx.device)
    s["handle"] = compile_handle(ctx)
    s["segments"] = t["clip_ticks"] // t["segment"]
    t1 = time.perf_counter()
    _pass(ctx)                           # captures every graph the passes replay
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    s["misses"] = s["handle"].cache_info().misses
    ctx.notes.append(f"setup: clips and handle {t1 - t0!r} s, a warm pass capturing {s['misses']} executables "
                     f"{time.perf_counter() - t1!r} s")


def _pass(ctx, on_segment=None, tracing: bool = False) -> None:
    """Serve one pass: every camera's clip, segment by segment, round robin
    over the cameras, each camera from a fresh state."""
    t, s = ctx.traffic, ctx.state
    K = t["segment"]
    states = [None] * t["cameras"]
    for seg in range(s["segments"]):
        for cam in range(t["cameras"]):
            frames = s["clips"][cam, seg * K : (seg + 1) * K]
            if on_segment is None:
                res = s["handle"].run_segment(frames, state=states[cam])
                res.logits.cpu()
            else:
                res = on_segment(cam, seg, frames, states[cam], tracing)
            states[cam] = res.state


def window(ctx, seconds: float, trace: bool) -> None:
    t, s = ctx.traffic, ctx.state
    handle = s["handle"]
    marks = None           # one Marks a stretch, made by serve
    latency: list = []
    rng = random.Random(ctx.seed)
    keep_k = int(t.get("checked_calls", 0))
    records: list = []     # (pass, camera, segment, ticks, kept, block masks, logits)
    held: list = []        # (pass, camera, segment, counts) reservoir
    spans: list = []
    passes = 0

    def one(cam, seg, frames, state, tracing):
        with call_range() if tracing else contextlib.nullcontext():
            i = marks.dispatch()
            h0 = time.perf_counter()
            res = handle.run_segment(frames, state=state)
            h1 = time.perf_counter()
            logits = res.logits.cpu().numpy()
            marks.done()
            marks.wait(i)
        spans.append(((h1 - h0) * 1e3, bool(tracing)))
        records.append((passes, cam, seg, res.ticks, res.kept_windows, res.block_masks, logits))
        n = len(records) - 1
        if len(held) < keep_k:
            held.append((passes, cam, seg, res.counts))
        else:
            j = rng.randrange(n + 1)
            if j < keep_k:
                held[j] = (passes, cam, seg, res.counts)
        return res

    def serve(until: float, tracing: bool) -> None:
        # whole passes only: every stretch serves the same mix of segments
        # (a camera's first segment, fresh and with two keyframes, is the
        # slowest), so a rate or a tail never depends on where it stopped
        nonlocal passes, marks
        marks = Marks(ctx.device)
        while time.perf_counter() < until:
            _pass(ctx, one, tracing)
            passes += 1
        latency.extend(marks.ms())

    traced_segments = 0
    if trace:
        # the profiled stretch first; the rest of the window after it, timed
        # from its own start so that the profiler's teardown takes none of it
        with traced(True) as prof:
            serve(time.perf_counter() + min(seconds, t["trace_seconds"]), True)
        ctx.window["profile"] = prof
        traced_segments = len(records)
        seconds = max(seconds - t["trace_seconds"], 0.0)
    t0 = time.perf_counter()
    serve(t0 + seconds, False)
    t_end = time.perf_counter()
    if handle.cache_info().misses != s["misses"]:
        raise RuntimeError("a segment graph was captured inside the measured window")
    traced_ticks = sum(r[3] for r in records[:traced_segments])
    ctx.window.update(
        attempted=len(records), calls=len(records), traced_calls=traced_segments,
        ticks=sum(r[3] for r in records) - traced_ticks, traced_ticks=traced_ticks,
        seconds=t_end - t0, latency_ms=latency, spans=spans,
        records=records, held=held,
    )


def check(ctx, control: str | None) -> tuple[dict, int, list[str]]:
    """Every segment's gate masks, kept counts and logits, and the sampled
    segments' counts, against each camera's reference stream."""
    cfg, w, t = ctx.cfg, ctx.weights, ctx.traffic
    K = t["segment"]
    limits = cfg["limits"]
    tie = limits["gate_tie"]
    hyst = cfg["gate"]["hysteresis"]
    tally = compare.Tally()
    failed = 0
    by_run: dict = {}
    for r in ctx.window["records"]:
        by_run.setdefault((r[0], r[1]), []).append(r)
    cams = sorted({cam for _, cam in by_run})
    want, got = {}, {}
    with torch.no_grad():
        for cam in cams:
            frames = ctx.state["clips"][cam]
            args = (frames, w["kernel"], w["bn_offset"], w["head"], ctx.calib, cfg, cfg["gate"], tie)
            want[cam] = _host(ref_gate.camera_stream(*args, mode="float64"))
            if control:
                got[cam] = _host(ref_gate.camera_stream(*args, mode=control))
    valid: dict = {}
    for (p, cam), recs in sorted(by_run.items()):
        recs.sort(key=lambda r: r[2])
        n = len(recs) * K
        ref = want[cam]
        prog_keep = got[cam]["keep"][:n] if control else np.concatenate([r[5] for r in recs])
        good, mismatch = compare.gate_walk(prog_keep, ref["keep"][:n], ref["tie"][:n], hyst)
        valid[(p, cam)] = good
        tally.gate_mismatch += mismatch
        tally.compared_ticks += good
        tally.tie_ticks += n - good
        for r in recs:
            lo, hi = r[2] * K, min(r[2] * K + K, good)
            if hi <= lo:
                continue
            kept = got[cam]["kept"][lo:hi] if control else np.asarray(r[4])[: hi - lo]
            bad = int((kept != ref["kept"][lo:hi]).sum())
            tally.kept_mismatch += bad
            failed += int(bad > 0)
            tally.logits(got[cam]["logits"][lo:hi] if control else r[6][: hi - lo], ref["logits"][lo:hi])
    failed += tally.logit_failures(float("inf"), limits["logit_gap_max"])
    for p, cam, seg, counts in ctx.window["held"]:
        lo, hi = seg * K, min(seg * K + K, valid.get((p, cam), 0))
        if hi <= lo:
            continue
        prog = torch.as_tensor(got[cam]["counts"][lo:hi]) if control else counts[: hi - lo].cpu()
        window_keep = torch.as_tensor(want[cam]["window"][lo:hi])[..., None]
        if tally.counts(prog, torch.as_tensor(want[cam]["counts"][lo:hi]), window_keep) > limits["count_max_diff"]:
            failed += 1
    lines = [f"compared {len(ctx.window['records'])} segments ({tally.compared_ticks} ticks; {tally.tie_ticks} "
             f"ticks after a gate tie left out) and the counts of {len(ctx.window['held'])} sampled segments"
             + (f", the control ({control}) in the program's place" if control else "")]
    return tally.numbers(), failed, lines


def _host(out: dict) -> dict:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
