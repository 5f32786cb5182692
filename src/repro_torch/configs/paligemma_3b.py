"""PaliGemma-3B [arXiv:2407.07726] — SigLIP vision stub + Gemma-2B decoder."""
from repro_torch.configs.base import DVIConfig, ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    num_layers=18,
    d_model=2_048,
    num_heads=8,
    num_kv_heads=1,               # MQA
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    act="gelu",
    glu=True,                     # GeGLU
    tie_embeddings=True,
    vision=VisionStubConfig(num_patches=256, d_embed=1_152),  # SigLIP-so400m 224px/14
    dvi=DVIConfig(split_layer=2),
    citation="arXiv:2407.07726",
)

TINY = CONFIG.replace(
    name="paligemma-3b-tiny",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=1, head_dim=64,
    d_ff=512, vocab_size=512,
    vision=VisionStubConfig(num_patches=16, d_embed=96),
    dvi=DVIConfig(split_layer=1, lora_rank=8, buffer_slots=512, batch_size=64),
)
