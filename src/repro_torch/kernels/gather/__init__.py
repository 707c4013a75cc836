from repro_torch.kernels.gather.ops import cache_gather  # noqa: F401
