"""Vicuna-7B [arXiv:2306.05685] — the paper's own Spec-Bench backbone
(LLaMA-1 7B geometry), split k=2 and k_spec=4 as in the paper."""
from repro_torch.configs.base import DVIConfig, ModelConfig

CONFIG = ModelConfig(
    name="vicuna-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11_008,
    vocab_size=32_000,
    rope_theta=10_000.0,
    dvi=DVIConfig(split_layer=2, k_spec=4),
    citation="arXiv:2306.05685 (Spec-Bench backbone)",
)

TINY = CONFIG.replace(
    name="vicuna-7b-tiny",
    num_layers=4, d_model=256, num_heads=8, num_kv_heads=8, head_dim=32,
    d_ff=512, vocab_size=512,
    dvi=DVIConfig(split_layer=2, k_spec=4, lora_rank=8,
                  buffer_slots=512, batch_size=64),
)
