"""Mamba2-1.3B — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, register


@register("mamba2-1.3b")
def mamba2_1_3b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="mamba2-smoke", family="ssm", num_layers=2,
            d_model=64, num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=256,
            ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32,
            use_rope=False, attn_chunk=0, loss_chunk=0, remat="none")
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", num_layers=48,
        d_model=2048, num_heads=0, num_kv_heads=0, d_ff=0,
        vocab_size=50280, use_rope=False,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        loss_chunk=0, remat="dots",
        notes="attention-free; long_500k RUNS (O(1) decode state). "
              "64 SSD heads sharded over TP.")
