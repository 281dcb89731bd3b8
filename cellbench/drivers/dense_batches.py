"""A closed loop of one client over whole batches: ``handle.run(batch)``,
wait for the output, send the next.

The mix sets ``batch`` frames a call, ``distinct_batches`` batches staged on
the device in set-up and served in turn, the ``frames`` kind
(``traffic/generator.py``), and ``outputs_to_host``: whether each call's
output (a network's logits) is read on the host, or stays on the device
(a frontend's counts, for a head there), and ``in_flight``: how many calls
the client keeps in flight (it dispatches the next call when the oldest is
done).  A call is done when its output is ready where it is read.

The check compares every output that reached the host, and a reservoir
sample of ``checked_calls`` device outputs drawn from the seed, against the
reference on the same frames.
"""

from __future__ import annotations

import collections
import contextlib
import random
import time

import torch

from cellbench import compare
from cellbench.reference import fpca as ref
from cellbench.timing import Marks, call_range, traced
from cellbench.traffic import generator as frames_of


def _frames(ctx, gen: torch.Generator) -> list[torch.Tensor]:
    t, cfg, dev = ctx.traffic, ctx.cfg, ctx.device
    kind = t["frames"]["kind"]
    if kind == "uniform":
        return [frames_of.uniform(t["batch"], cfg, gen, dev) for _ in range(t["distinct_batches"])]
    if kind == "moving_object":
        ticks = t["frames"]["clip_ticks"]
        if t["batch"] % ticks:
            raise ValueError("a batch of moving-object frames holds whole clips")
        clips = t["batch"] // ticks
        shape = (t["batch"], cfg["image_h"], cfg["image_w"], cfg["in_channels"])
        return [frames_of.moving_object(ctx.seed * t["distinct_batches"] + b, clips, ticks, cfg, t["frames"], dev)
                .reshape(shape) for b in range(t["distinct_batches"])]
    raise ValueError(f"unknown frames kind {kind!r}")


def setup(ctx, gen: torch.Generator) -> None:
    from cellbench.harness import compile_handle

    s = ctx.state
    t0 = time.perf_counter()
    s["frames"] = _frames(ctx, gen)
    s["handle"] = compile_handle(ctx)
    t1 = time.perf_counter()
    for batch in s["frames"]:            # builds the kernel and every executable the window calls
        out = s["handle"].run(batch)
        if ctx.traffic["outputs_to_host"]:
            out.cpu()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    s["misses"] = s["handle"].cache_info().misses
    ctx.notes.append(f"setup: frames and handle {t1 - t0!r} s, warm-up calls {time.perf_counter() - t1!r} s")


def window(ctx, seconds: float, trace: bool) -> None:
    s, t = ctx.state, ctx.traffic
    handle, frames = s["handle"], s["frames"]
    k = int(t.get("in_flight", 1))
    rng = random.Random(ctx.seed)
    keep_k = int(t.get("checked_calls", 0))
    held: list = []                      # (batch, device output) reservoir
    host_out: list = []                  # (batch, host output)
    spans: list = []                     # (host ms in run(), traced)
    latency: list = []
    calls = 0
    finished = 0
    to_host = t["outputs_to_host"]
    # a ring of host buffers for the outputs in flight, page-locked on the
    # card so that each copy runs behind its call without stopping the host
    ring = []
    if to_host:
        shape = (t["batch"], ctx.cfg["head"][-1]["features"])
        ring = [torch.empty(shape, pin_memory=ctx.device.type == "cuda") for _ in range(k)]

    def finish(marks: Marks, entry: tuple) -> None:
        nonlocal finished
        i, b, out = entry
        marks.wait(i)
        if to_host:
            host_out.append((b, out.numpy().copy()))
        elif len(held) < keep_k:
            held.append((b, out))
        else:
            j = rng.randrange(finished + 1)
            if j < keep_k:
                held[j] = (b, out)
        finished += 1

    def serve(until: float, tracing: bool) -> None:
        nonlocal calls
        marks = Marks(ctx.device, k)
        pending: collections.deque = collections.deque()
        while time.perf_counter() < until:
            b = calls % len(frames)
            with call_range() if tracing else contextlib.nullcontext():
                i = marks.dispatch()
                h0 = time.perf_counter()
                out = handle.run(frames[b])
                h1 = time.perf_counter()
                if to_host:
                    out = ring[calls % k].copy_(out, non_blocking=True)
                marks.done()
            spans.append(((h1 - h0) * 1e3, tracing))
            calls += 1
            pending.append((i, b, out))
            if len(pending) == k:
                finish(marks, pending.popleft())
        while pending:
            finish(marks, pending.popleft())
        latency.extend(marks.ms())

    traced_calls = 0
    if trace:
        # the profiled stretch first; the rest of the window after it, timed
        # from its own start so that the profiler's teardown takes none of it
        with traced(True) as prof:
            serve(time.perf_counter() + min(seconds, t["trace_seconds"]), True)
        ctx.window["profile"] = prof
        traced_calls = calls
        seconds = max(seconds - t["trace_seconds"], 0.0)
    t0 = time.perf_counter()
    serve(t0 + seconds, False)
    t_end = time.perf_counter()
    if handle.cache_info().misses != s["misses"]:
        raise RuntimeError("an executable was built inside the measured window")
    ctx.window.update(
        attempted=calls, calls=calls, traced_calls=traced_calls, frames=(calls - traced_calls) * t["batch"],
        seconds=t_end - t0, latency_ms=latency, spans=spans, held=held, host_out=host_out,
    )


def check(ctx, control: str | None) -> tuple[dict, int, list[str]]:
    """The numbers compared, the calls found wrong, and a line saying what
    was compared."""
    cfg, w, frames = ctx.cfg, ctx.weights, ctx.state["frames"]
    held, host_out = ctx.window["held"], ctx.window["host_out"]
    tally = compare.Tally(per_output=True)
    failed = 0
    with torch.no_grad():
        want, got = {}, {}
        for b in sorted({b for b, _ in held + host_out}):
            want[b] = ref.counts(frames[b], w["kernel"], w["bn_offset"], ctx.calib, cfg, "float64")
            if control:
                got[b] = ref.counts(frames[b], w["kernel"], w["bn_offset"], ctx.calib, cfg, control)
            if cfg["head"]:
                want[b] = ref.head_logits(want[b], w["head"], cfg, "float64").cpu().numpy()
                if control:
                    got[b] = ref.head_logits(got[b], w["head"], cfg, control).cpu().numpy()
        for b, out in held:
            if tally.counts(got[b] if control else out, want[b]) > cfg["limits"]["count_max_diff"]:
                failed += 1
        for b, out in host_out:
            tally.logits(got[b] if control else out, want[b])
    numbers = tally.numbers()
    if host_out:
        failed += tally.logit_failures(cfg["limits"]["call_logit_gap_median"], cfg["limits"]["logit_gap_max"])
    lines = [f"compared {len(held)} device outputs and {len(host_out)} host outputs of {ctx.window['calls']} "
             "calls" + (f", the control ({control}) in the program's place" if control else "")]
    return numbers, failed, lines
