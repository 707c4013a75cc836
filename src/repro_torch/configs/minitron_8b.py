"""Minitron-8B — depth/width-pruned Nemotron [arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ModelConfig, register


@register("minitron-8b")
def minitron_8b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="minitron-8b-smoke", family="dense", num_layers=2,
            d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            attn_chunk=0, loss_chunk=0, remat="none")
    return ModelConfig(
        name="minitron-8b", family="dense", num_layers=32,
        d_model=4096, num_heads=32, num_kv_heads=8, d_ff=16384,
        vocab_size=256000, head_dim=128,
        attn_chunk=1024, loss_chunk=0, remat="dots",
        notes="GQA kv=8 (indivisible by model axis 16 → KV weights/cache "
              "replicated over TP, q-heads sharded; Megatron-style).")
