from repro_torch.data.pipeline import PrefetchPipeline, SyntheticSource, to_device

__all__ = ["PrefetchPipeline", "SyntheticSource", "to_device"]
