from repro_torch.ckpt.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
