from repro_torch.runtime.fault import RestartPolicy
from repro_torch.runtime.straggler import DeadlineSkipper, StepTimer

__all__ = ["DeadlineSkipper", "RestartPolicy", "StepTimer"]
