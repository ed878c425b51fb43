from repro_torch.optim.adamw import (
    OptConfig,
    apply_updates,
    global_norm,
    init_opt_state,
    lr_schedule,
)

__all__ = ["OptConfig", "apply_updates", "global_norm", "init_opt_state",
           "lr_schedule"]
