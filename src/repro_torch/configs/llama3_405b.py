"""Llama-3.1 405B [arXiv:2407.21783] — dense, GQA, 128k vocab."""
from repro_torch.configs.base import DVIConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    arch_type="dense",
    num_layers=126,
    d_model=16_384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53_248,
    vocab_size=128_256,
    rope_theta=500_000.0,
    act="silu",
    glu=True,
    dvi=DVIConfig(split_layer=2),
    citation="arXiv:2407.21783",
)

# Reduced same-family variant for CPU smoke tests.
TINY = CONFIG.replace(
    name="llama3-405b-tiny",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512, dvi=DVIConfig(split_layer=1, lora_rank=8,
                                            buffer_slots=512, batch_size=64),
)
