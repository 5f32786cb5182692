"""Whisper large-v3 [arXiv:2212.04356] — encoder-decoder; the conv/mel
frontend is stubbed to precomputed frame embeddings, as in the reference."""
from repro_torch.configs.base import DVIConfig, EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    num_layers=32,                 # decoder layers
    d_model=1_280,
    num_heads=20,
    num_kv_heads=20,               # MHA
    head_dim=64,
    d_ff=5_120,
    vocab_size=51_866,
    act="gelu",
    glu=False,                     # plain GELU MLP
    tie_embeddings=True,
    encoder=EncoderConfig(num_layers=32, num_frames=1_500),
    dvi=DVIConfig(split_layer=2),
    citation="arXiv:2212.04356",
)

TINY = CONFIG.replace(
    name="whisper-large-v3-tiny",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512,
    encoder=EncoderConfig(num_layers=2, num_frames=24),
    dvi=DVIConfig(split_layer=1, lora_rank=8, buffer_slots=512, batch_size=64),
)
