from repro_torch.runtime.fault import (DeviceGrid, HealthMonitor,
                                       RestartPolicy, StepGuard,
                                       elastic_mesh)
from repro_torch.runtime.straggler import DeadlineSkipper, StepTimer

__all__ = ["DeadlineSkipper", "DeviceGrid", "HealthMonitor", "RestartPolicy",
           "StepGuard", "StepTimer", "elastic_mesh"]
