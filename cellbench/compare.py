"""The numbers that decide ``correct``: each output of the served path
against the reference's, with the limits from the configuration's file.

* ``count_flip_share``: counts that differ from the reference's, over the
  counts compared; ``count_max_diff``: the largest difference, in ADC
  counts;
* the gap of an output row: its largest absolute logit difference over the
  root mean square of the reference's logits in the rows compared;
  ``logit_gap_median``: the median gap over every row compared;
  ``call_logit_gap_median``: the largest, over the outputs compared, of an
  output's median row gap (a wrong answer of one call shows);
  ``logit_gap_max``: the largest row gap, which catches one wrong row that
  no median sees.  A count one ADC step off, which the frontend's float32
  rounding gives on a few counts in 10^5, moves a row's logits about as far
  as TF32 products do, so the largest gap tells the control from a sound
  run poorly: the medians catch the control, the largest gap a row whose
  answer is wrong;
* ``gate_mismatch``: skip blocks whose keep decision differs from the
  reference's where the reference's float64 block change is no tie;
  ``kept_mismatch``: ticks whose kept-window count differs.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Tally:
    """Running sums of the compared numbers."""

    def __init__(self, per_output: bool = False):
        self.per_output = per_output
        self.flips = 0
        self.counted = 0
        self.max_diff = 0.0
        self.gaps: list[np.ndarray] = []
        self.gap_scale_sq = 0.0
        self.gap_rows = 0
        self.gate_mismatch = 0
        self.kept_mismatch = 0
        self.tie_ticks = 0
        self.compared_ticks = 0

    def counts(self, prog: torch.Tensor, ref: torch.Tensor, weight_mask: torch.Tensor | None = None) -> float:
        """Compare count maps; ``weight_mask`` (broadcastable) selects the
        counts that the denominator counts (the kept windows); every count
        enters the numerator.  Returns this pair's largest difference."""
        d = (prog.to(torch.float64) - ref.to(torch.float64)).abs()
        self.flips += int((d > 0).sum())
        self.counted += int(d.numel() if weight_mask is None else weight_mask.expand_as(d).sum())
        m = float(d.max()) if d.numel() else 0.0
        self.max_diff = max(self.max_diff, m)
        return m

    def logits(self, prog: np.ndarray, ref: np.ndarray) -> None:
        """Compare one output's logit rows."""
        prog = np.asarray(prog, np.float64).reshape(len(prog), -1)
        ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
        self.gaps.append(np.abs(prog - ref).max(-1))
        self.gap_scale_sq += float((ref * ref).sum())
        self.gap_rows += ref.size

    def _scale(self) -> float:
        return math.sqrt(self.gap_scale_sq / max(self.gap_rows, 1)) or 1.0

    def logit_failures(self, median_limit: float, max_limit: float) -> int:
        """Outputs whose median row gap passes ``median_limit`` or whose
        largest passes ``max_limit``."""
        scale = self._scale()
        return sum(int(np.median(g) / scale > median_limit or g.max() / scale > max_limit)
                   for g in self.gaps if g.size)

    def numbers(self) -> dict:
        out: dict = {}
        if self.counted:
            out["count_flip_share"] = self.flips / self.counted
            out["count_max_diff"] = self.max_diff
        if self.gaps and self.per_output:
            out["call_logit_gap_median"] = max(float(np.median(g)) for g in self.gaps) / self._scale()
        elif self.gaps:
            out["logit_gap_median"] = float(np.median(np.concatenate(self.gaps))) / self._scale()
        if self.gaps:
            out["logit_gap_max"] = max(float(g.max()) for g in self.gaps if g.size) / self._scale()
        if self.compared_ticks:
            out["gate_mismatch"] = self.gate_mismatch
            out["kept_mismatch"] = self.kept_mismatch
        return out


def gate_walk(prog_keep: np.ndarray, ref_keep: np.ndarray, ties: np.ndarray, hysteresis: int) -> tuple[int, int]:
    """Walk one camera's ticks.  Returns ``(valid, mismatch)``: the number of
    leading ticks whose gate decisions are comparable, and the skip blocks
    that differ there without a tie.  The first tick whose differing
    blocks all had a tie (a float64 change within the tie margin) on this
    or the ``hysteresis + 1`` ticks before ends the comparable stretch: a
    float32 program may rightly decide such a block either way, and its
    state then differs from the reference's."""
    n = len(prog_keep)
    mismatch = 0
    for t in range(n):
        diff = prog_keep[t] != ref_keep[t]
        if not diff.any():
            continue
        recent = ties[max(0, t - hysteresis - 1) : t + 1].any(0)
        if (diff <= recent).all():
            return t, mismatch
        mismatch += int(diff.sum())
    return n, mismatch


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and, per number compared, ``{"value", "limit"}``; a
    number without a limit fails, and so does a check that compared nothing."""
    checks = {}
    ok = bool(numbers)
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            ok = False
    return ok, checks
