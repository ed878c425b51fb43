from repro_torch.runtime.fault import RestartPolicy
from repro_torch.runtime.straggler import StepTimer

__all__ = ["RestartPolicy", "StepTimer"]
