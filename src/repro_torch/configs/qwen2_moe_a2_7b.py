"""Qwen1.5/2-MoE-A2.7B — 60 routed (top-4) + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B].  Experts padded 60→64 so EP=16 divides; the
router masks the pads."""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-moe-a2.7b")
def qwen2_moe(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="qwen2-moe-smoke", family="moe", num_layers=2,
            d_model=64, num_heads=4, num_kv_heads=4, d_ff=96, vocab_size=256,
            num_experts=6, num_experts_padded=8, moe_top_k=2,
            num_shared_experts=4, shared_expert_ff=192,
            attn_chunk=0, loss_chunk=0, remat="none")
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", num_layers=24,
        d_model=2048, num_heads=16, num_kv_heads=16, d_ff=1408,
        vocab_size=151936, head_dim=128,
        num_experts=60, num_experts_padded=64, moe_top_k=4,
        num_shared_experts=4, shared_expert_ff=5632, capacity_factor=1.25,
        attn_chunk=1024, loss_chunk=0, remat="dots",
        notes="shared_expert_ff=4*1408=5632 (fused shared experts).")
