"""Kimi K2 — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2; unverified].

Assignment treats attention as GQA kv=8 (the release uses MLA; noted in
DESIGN.md §Arch-applicability).  1T total / ~32B active parameters.
Memory-critical settings: bf16 params + adafactor (factored second moment)
+ full remat — f32 Adam for 1T params cannot fit 256×16 GB HBM.
"""
from repro_torch.configs.base import ModelConfig, register


@register("kimi-k2-1t-a32b")
def kimi_k2(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="kimi-k2-smoke", family="moe", num_layers=2,
            d_model=64, num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=256,
            num_experts=6, num_experts_padded=8, moe_top_k=2,
            num_shared_experts=1, shared_expert_ff=96,
            attn_chunk=0, loss_chunk=0, remat="none")
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", num_layers=61,
        d_model=7168, num_heads=64, num_kv_heads=8, d_ff=2048,
        vocab_size=163840, head_dim=112,
        num_experts=384, num_experts_padded=384, moe_top_k=8,
        num_shared_experts=1, shared_expert_ff=2048, capacity_factor=1.25,
        param_dtype="bfloat16", optimizer="adafactor",
        attn_chunk=1024, loss_chunk=1024, remat="full",
        notes="~1.03e12 total params (61L·384e·3·7168·2048), ~32B active.")
