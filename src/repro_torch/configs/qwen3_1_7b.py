"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family] — dense, GQA, per-head qk RMSNorm."""
from repro_torch.configs.base import DVIConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    arch_type="dense",
    num_layers=28,
    d_model=2_048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6_144,
    vocab_size=151_936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    dvi=DVIConfig(split_layer=2),
    citation="hf:Qwen/Qwen3-8B",
)

TINY = CONFIG.replace(
    name="qwen3-1.7b-tiny",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    dvi=DVIConfig(split_layer=1, lora_rank=8, buffer_slots=512, batch_size=64),
)
