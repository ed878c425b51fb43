from repro_torch.models.lm import (
    RunCfg,
    decode_step,
    init_cache,
    init_paged_cache,
    init_params,
    leaf_specs,
    prefill,
)

__all__ = ["RunCfg", "decode_step", "init_cache", "init_paged_cache",
           "init_params", "leaf_specs", "prefill"]
