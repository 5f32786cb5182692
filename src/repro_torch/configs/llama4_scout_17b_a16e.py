"""Llama-4 Scout 17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE top-1 +
shared expert, chunked local attention with periodic global (iRoPE-style)."""
from repro_torch.configs.base import DVIConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    num_layers=48,
    d_model=5_120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8_192,
    vocab_size=202_048,
    rope_theta=500_000.0,
    sliding_window=8_192,          # chunked local attention
    global_attn_every=4,           # every 4th layer is global (NoPE/iRoPE style)
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8_192,
                  num_shared_experts=1, d_ff_shared=8_192),
    dvi=DVIConfig(split_layer=2),
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)

TINY = CONFIG.replace(
    name="llama4-scout-17b-a16e-tiny",
    num_layers=4, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512, sliding_window=64, global_attn_every=4,
    moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=512,
                  num_shared_experts=1, d_ff_shared=512, capacity_factor=8.0),
    dvi=DVIConfig(split_layer=1, lora_rank=8, buffer_slots=512, batch_size=64),
)
