"""PyTorch + CUDA port of the A³GNN system, for NVIDIA Hopper (H100).

Mirrors the JAX package ``repro`` module by module (``configs/ graph/ core/
kernels/ models/ train/ serve/ launch/``) and imports nothing of it, nor
JAX.  Every entry point takes a ``device`` (default ``"cuda"``); the CPU
is used only when the caller asks for it.

float32 matrix products on the card run in full float32, not TF32: the
port is held against the JAX package at f32 tolerances.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
