"""Straggler detection at the edges of the step (``repro/runtime
/straggler.py``, pure Python).

* :class:`StepTimer` keeps an EWMA of step (or tick) times and their
  deviation; the engine counts a tick as a straggler when it runs far
  past the mean.
* :class:`DeadlineSkipper`: if a host's batch misses its deadline, the
  step runs with the previous prefetched batch (data reordering, not a
  stall), at most ``max_skips`` times.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class StepTimer:
    alpha: float = 0.1
    mean_s: float = 0.0
    var_s: float = 0.0
    n: int = 0

    def observe(self, dt: float) -> None:
        if self.n == 0:
            self.mean_s = dt
        delta = dt - self.mean_s
        self.mean_s += self.alpha * delta
        self.var_s = (1 - self.alpha) * (self.var_s + self.alpha * delta * delta)
        self.n += 1

    def is_straggler(self, dt: float, k: float = 3.0) -> bool:
        if self.n < 8:
            return False
        return dt > self.mean_s + k * max(self.var_s ** 0.5,
                                          0.05 * self.mean_s)


@dataclasses.dataclass
class DeadlineSkipper:
    deadline_factor: float = 2.0     # x mean step time
    max_skips: int = 10
    skips: int = 0
    skipped_steps: List[int] = dataclasses.field(default_factory=list)

    def should_skip(self, step: int, waited_s: float,
                    timer: StepTimer) -> bool:
        if timer.n < 8 or self.skips >= self.max_skips:
            return False
        if waited_s > self.deadline_factor * timer.mean_s:
            self.skips += 1
            self.skipped_steps.append(step)
            return True
        return False
