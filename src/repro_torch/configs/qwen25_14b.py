"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family] — dense, GQA, QKV bias."""
from repro_torch.configs.base import DVIConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    num_layers=48,
    d_model=5_120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13_824,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    dvi=DVIConfig(split_layer=2),
    citation="hf:Qwen/Qwen2.5-0.5B",
)

TINY = CONFIG.replace(
    name="qwen2.5-14b-tiny",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    dvi=DVIConfig(split_layer=1, lora_rank=8, buffer_slots=512, batch_size=64),
)
