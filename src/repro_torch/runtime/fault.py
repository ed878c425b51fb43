"""Restart budgets with exponential backoff.

The port's own copy of ``RestartPolicy`` from ``repro/runtime/fault.py``
(pure Python).  The serving engine's :class:`repro_torch.serve.engine
.PreemptionPolicy` measures its backoff in engine ticks through it.  The
rest of that module (heartbeats, elastic meshes) waits for ROADMAP §1
item 11.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 100
    backoff_base_s: float = 5.0
    backoff_cap_s: float = 300.0
    restarts: int = 0

    def next_delay(self) -> float:
        """The next backoff, doubling from ``backoff_base_s`` up to
        ``backoff_cap_s``; raises :class:`RuntimeError` once
        ``max_restarts`` delays have been handed out."""
        if self.restarts >= self.max_restarts:
            raise RuntimeError(
                f"restart budget exhausted ({self.max_restarts})")
        d = min(self.backoff_base_s * (2 ** min(self.restarts, 10)),
                self.backoff_cap_s)
        self.restarts += 1
        return d
