from repro_torch.serve.allocator import BlockAllocator
from repro_torch.serve.disagg import (DegradedMode, PlanHandshakeError,
                                      PrefillFleet)
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["BlockAllocator", "DegradedMode", "PlanHandshakeError",
           "PrefillFleet", "Request", "ServeEngine"]
