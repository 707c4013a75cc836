"""Qwen2-VL-2B — M-RoPE, dynamic-resolution vision (frontend stubbed)
[arXiv:2409.12191; hf].  input_specs supplies precomputed patch embeddings
over a fixed prefix + (t,h,w) position-id streams."""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-vl-2b")
def qwen2_vl_2b(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="qwen2-vl-smoke", family="vlm", num_layers=2,
            d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            head_dim=16, mrope_sections=(2, 3, 3), frontend="vision",
            attn_chunk=0, loss_chunk=0, remat="none")
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm", num_layers=28,
        d_model=1536, num_heads=12, num_kv_heads=2, d_ff=8960,
        vocab_size=151936, head_dim=128, rope_theta=1000000.0,
        mrope_sections=(16, 24, 24), frontend="vision", tie_embeddings=True,
        attn_chunk=1024, loss_chunk=0, remat="dots",
        notes="12 q-heads indivisible by model axis → FSDP-style attention; "
              "M-RoPE sections (16,24,24) over head_dim/2=64.")
