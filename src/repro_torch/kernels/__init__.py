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

The other two TPU kernels (reservoir, flash_attention) are not ported yet;
ROADMAP.md lists the slice of each.
"""
