from repro_torch.kernels.segment_agg.ops import (  # noqa: F401
    neighbor_agg, neighbor_agg_backward, neighbor_mean)
