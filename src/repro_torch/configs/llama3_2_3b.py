"""Llama-3.2-3B — small Llama3 [hf:meta-llama/Llama-3.2-3B; unverified]."""
from repro_torch.configs.base import ModelConfig, register


@register("llama3.2-3b")
def llama3_2_3b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="llama3.2-3b-smoke", family="dense", num_layers=2,
            d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            attn_chunk=0, loss_chunk=0, remat="none", rope_theta=500000.0)
    return ModelConfig(
        name="llama3.2-3b", family="dense", num_layers=28,
        d_model=3072, num_heads=24, num_kv_heads=8, d_ff=8192,
        vocab_size=128256, head_dim=128, rope_theta=500000.0,
        tie_embeddings=True,
        attn_chunk=1024, loss_chunk=0, remat="dots",
        notes="24 q-heads indivisible by model axis 16 → attention runs "
              "FSDP-style (batch-sharded activations, ZeRO-gathered weights); "
              "MLP stays TP (8192 % 16 == 0).")
