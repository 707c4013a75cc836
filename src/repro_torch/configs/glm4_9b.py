"""GLM4-9B — RoPE, extreme GQA (kv=2) [hf:THUDM/glm-4-9b]."""
from repro_torch.configs.base import ModelConfig, register


@register("glm4-9b")
def glm4_9b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="glm4-9b-smoke", family="dense", num_layers=2,
            d_model=64, num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=256,
            attn_chunk=0, loss_chunk=0, remat="none")
    return ModelConfig(
        name="glm4-9b", family="dense", num_layers=40,
        d_model=4096, num_heads=32, num_kv_heads=2, d_ff=13696,
        vocab_size=151552, head_dim=128,
        attn_chunk=1024, loss_chunk=0, remat="dots",
        notes="kv=2: KV replicated over TP; decode cache sequence-sharded "
              "(kv_shard auto → sequence).")
