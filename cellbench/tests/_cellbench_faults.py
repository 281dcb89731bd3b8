"""Faults planted in the program under test: each a function of a
``pytest.MonkeyPatch`` that breaks the served path underneath the harness.
The check's tests plant them at small sizes on the host; ``readings.py``
plants them at a cell's own size on the card.

* ``half_left_out``: the fpca kernel's counts of the second half of the
  rows left at zero;
* ``tail_chunk``: its last 64th of the rows left at zero (a wrong tail);
* ``answer_altered``: the counts of its first row (one window) 5 ADC counts
  high, where the kernel produces them;
* ``row_altered``: one frame's logits negated where the head produces them
  (networks only);
* ``state_unchanged``: a segment that returns the state it was given
  (streams only).
"""

from __future__ import annotations

import dataclasses

from repro_torch.fpca import executable, program
from repro_torch.kernels.fpca_conv import ops


def _kernel(monkeypatch, fault) -> None:
    for name, impl in list(ops._IMPLS.items()):
        def broken(*args, _impl=impl, **kw):
            return fault(_impl(*args, **kw))

        monkeypatch.setitem(ops._IMPLS, name, broken)


def _zero_from(counts, start):
    out = counts.clone()
    out[start:] = 0
    return out


def _plus_five(counts):
    out = counts.clone()
    out[0] += 5
    return out


def half_left_out(monkeypatch) -> None:
    _kernel(monkeypatch, lambda c: _zero_from(c, c.shape[0] // 2))


def tail_chunk(monkeypatch) -> None:
    _kernel(monkeypatch, lambda c: _zero_from(c, c.shape[0] - -(-c.shape[0] // 64)))


def answer_altered(monkeypatch) -> None:
    _kernel(monkeypatch, _plus_five)


def row_altered(monkeypatch) -> None:
    inner = program.FPCAModelProgram.apply_head

    def altered(self, params, counts):
        out = inner(self, params, counts).clone()
        out[0] = -out[0]
        return out

    monkeypatch.setattr(program.FPCAModelProgram, "apply_head", altered)


def state_unchanged(monkeypatch) -> None:
    inner = executable.CompiledFrontend._dispatch_segment_inner

    def stale(self, *args, **kw):
        res = inner(self, *args, **kw)
        given = kw.get("state") or self._fresh_segment_state(self.program.gate.hysteresis, kw["head_params"] is not None)
        return dataclasses.replace(res, state=given)

    monkeypatch.setattr(executable.CompiledFrontend, "_dispatch_segment_inner", stale)


KERNEL = {"half_left_out": half_left_out, "tail_chunk": tail_chunk, "answer_altered": answer_altered}
FAULTS = {**KERNEL, "row_altered": row_altered, "state_unchanged": state_unchanged}
