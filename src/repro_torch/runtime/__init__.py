from repro_torch.runtime.straggler import StepTimer

__all__ = ["StepTimer"]
