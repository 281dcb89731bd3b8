"""Checks the port's tests share: error parity with the reference and the
fpca counts tolerance."""

from __future__ import annotations

import numpy as np
import pytest


def same_error(ref_call, port_call) -> None:
    """Both sides raise the same exception type, by name and bases (each
    package defines its own ``CalibrationKeyError`` or
    ``FleetAdmissionError``), with the same message."""
    with pytest.raises(Exception) as want:
        ref_call()
    with pytest.raises(Exception) as got:
        port_call()
    assert [c.__name__ for c in type(got.value).__mro__] == [c.__name__ for c in type(want.value).__mro__]
    assert str(got.value) == str(want.value)


def counts_close(got, want) -> None:
    """At most 1 ADC count and fewer than 5% of counts off (round-half flips
    of f32 sums taken in another order)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1.0, f"max count diff {diff.max()}"
    assert (diff > 0).mean() < 0.05, f"too many rounding flips: {(diff > 0).mean():.3f}"
