"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the JAX
package, each beside its plain PyTorch version.

Each kernel: ``csrc/<name>.cu`` (plain C interface, built by ``build.py``
with ``nvcc`` at first use and loaded with ``ctypes``), and a subpackage
with ``ops.py`` (checked wrapper with a launch count) and ``ref.py`` (the
plain version, used for CPU tensors and as the oracle).

  gather/            device-map feature-cache row gather (``cache_gather``)
  segment_agg/       masked neighbour mean / sum / weighted sum, with a
                     backward kernel (``neighbor_agg``)
  fused_gather_agg/  encoded-slot resolve + self rows + neighbour mean or
                     sum for layer 0 of the fused step (``gather_aggregate``)
  flash_attention/   blockwise causal / full self-attention forward of the
                     LM block prefill (``flash_attention``)
  reservoir/         Efraimidis–Spirakis weighted top-m of neighbour rows
                     (``reservoir_topm``); an op of its own, as in the JAX
                     package, where no path calls it: the sampler selects in
                     numpy
"""


def launch_counts() -> dict:
    """Each kernel wrapper's launch count in this process (``launches``:
    one a kernel launch, none for a call that ran the plain version)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.kernels.gather.ops import cache_gather
    from repro_torch.kernels.reservoir.ops import reservoir_topm
    from repro_torch.kernels.segment_agg.ops import (neighbor_agg,
                                                     neighbor_agg_backward)
    return {"cache_gather": cache_gather.launches,
            "gather_aggregate": gather_aggregate.launches,
            "neighbor_agg": neighbor_agg.launches,
            "neighbor_agg_backward": neighbor_agg_backward.launches,
            "flash_attention": flash_attention.launches,
            "reservoir_topm": reservoir_topm.launches}
