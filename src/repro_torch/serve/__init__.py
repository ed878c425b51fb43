from repro_torch.serve.allocator import BlockAllocator
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["BlockAllocator", "Request", "ServeEngine"]
