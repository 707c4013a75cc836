from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate  # noqa: F401
