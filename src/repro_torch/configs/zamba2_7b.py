"""Zamba2-7B — Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242; unverified]."""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-7b")
def zamba2_7b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="zamba2-smoke", family="hybrid", num_layers=5,
            d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
            ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32,
            shared_attn_every=2,
            attn_chunk=0, loss_chunk=0, remat="none")
    return ModelConfig(
        name="zamba2-7b", family="hybrid", num_layers=81,
        d_model=3584, num_heads=32, num_kv_heads=32, d_ff=14336,
        vocab_size=32000, head_dim=112,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        shared_attn_every=6,
        attn_chunk=1024, loss_chunk=0, remat="dots",
        notes="81 Mamba2 layers; one shared attention+MLP block applied after "
              "every 6th layer (13 applications, 81//6).  long_500k RUNS "
              "(sub-quadratic; shared-attn KV cache sequence-sharded).")
