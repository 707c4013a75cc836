"""Whisper-medium — encoder-decoder, conv/mel frontend stubbed
[arXiv:2212.04356; unverified].  input_specs supplies precomputed 1500-frame
embeddings; decoder uses learned positional embeddings, LayerNorm, GELU."""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-medium")
def whisper_medium(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="whisper-smoke", family="encdec", num_layers=2,
            d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
            encoder_layers=2, encoder_seq=30, use_rope=False,
            mlp_type="gelu", max_seq=128,
            attn_chunk=0, loss_chunk=0, remat="none")
    return ModelConfig(
        name="whisper-medium", family="encdec", num_layers=24,
        d_model=1024, num_heads=16, num_kv_heads=16, d_ff=4096,
        vocab_size=51865, head_dim=64,
        encoder_layers=24, encoder_seq=1500, use_rope=False,
        mlp_type="gelu", max_seq=32768, tie_embeddings=True,
        attn_chunk=1024, loss_chunk=0, remat="dots",
        notes="decoder pos-emb table sized to 32k for the assigned decode_32k "
              "cell (the release caps at 448 — assignment shapes win).")
