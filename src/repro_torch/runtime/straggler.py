"""Straggler detection at the serving engine's edge.

:class:`StepTimer` keeps an EWMA of tick times and their deviation; the
engine counts a tick as a straggler when it runs far past the mean
(a pure-Python copy of the JAX package's timer).
"""

from __future__ import annotations

import dataclasses


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
