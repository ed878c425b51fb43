from repro_torch.hw.tpu import TpuTarget, get_target, KiB, MiB, GiB

__all__ = ["TpuTarget", "get_target", "KiB", "MiB", "GiB"]
