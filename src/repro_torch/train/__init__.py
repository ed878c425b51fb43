from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
