"""Qwen3-4B — qk-norm + GQA [hf:Qwen/Qwen3-4B]."""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-4b")
def qwen3_4b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="qwen3-4b-smoke", family="dense", num_layers=2,
            d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            qk_norm=True, attn_chunk=0, loss_chunk=0, remat="none")
    return ModelConfig(
        name="qwen3-4b", family="dense", num_layers=36,
        d_model=2560, num_heads=32, num_kv_heads=8, d_ff=9728,
        vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1000000.0,
        tie_embeddings=True,
        attn_chunk=1024, loss_chunk=0, remat="dots",
        notes="qk-norm RMSNorm on per-head q/k (Qwen3).")
