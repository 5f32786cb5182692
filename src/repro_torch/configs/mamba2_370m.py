"""Mamba2-370M [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import DVIConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1_024,
    num_heads=32,                  # d_inner / head_dim = 2048 / 64
    num_kv_heads=32,
    d_ff=0,                        # attention-free, no MLP (Mamba-2 block only)
    vocab_size=50_280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=128),
    dvi=DVIConfig(split_layer=2),
    citation="arXiv:2405.21060",
)

TINY = CONFIG.replace(
    name="mamba2-370m-tiny",
    num_layers=2, d_model=256, num_heads=8, num_kv_heads=8, vocab_size=512,
    ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=64, chunk_size=32),
    dvi=DVIConfig(split_layer=1, lora_rank=8, buffer_slots=512, batch_size=64),
)
