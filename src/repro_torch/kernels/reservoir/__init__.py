from repro_torch.kernels.reservoir.ops import reservoir_topm  # noqa: F401
