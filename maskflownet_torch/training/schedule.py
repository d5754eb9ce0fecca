"""Piecewise-constant learning-rate schedule that ends training at its last
boundary: the port's copy of ``maskflownet_tpu/training/schedule.py``.

The schedule is a list of ``[step_boundary, lr]`` pairs; the active lr is
that of the first entry whose boundary is >= the current step (advance
while ``steps > boundary``); past the last boundary training ends.
"""

from __future__ import annotations


def lr_at_step(schedule: list[tuple[int, float]], steps: int) -> float | None:
    """The lr for ``steps``, or None once the schedule is exhausted (the
    caller stops training)."""
    i = 0
    while i < len(schedule) and steps > schedule[i][0]:
        i += 1
    if i >= len(schedule):
        return None
    return float(schedule[i][1])


def total_steps(schedule: list[tuple[int, float]]) -> int:
    return int(schedule[-1][0]) if schedule else 0
