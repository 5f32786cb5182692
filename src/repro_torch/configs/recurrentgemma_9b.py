"""RecurrentGemma-9B [arXiv:2402.19427] — hybrid RG-LRU + local attention, 1:2."""
from repro_torch.configs.base import DVIConfig, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,                      # 12 full (rglru, rglru, local) periods + 2-layer tail
    d_model=4_096,
    num_heads=16,
    num_kv_heads=1,                     # MQA
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    act="gelu",
    glu=True,                           # GeGLU
    rglru=RGLRUConfig(lru_width=4_096, block_pattern=("rglru", "rglru", "local"),
                      local_window=2_048),
    dvi=DVIConfig(split_layer=2),
    citation="arXiv:2402.19427",
)

TINY = CONFIG.replace(
    name="recurrentgemma-9b-tiny",
    num_layers=3, d_model=256, num_heads=4, num_kv_heads=1, head_dim=64,
    d_ff=512, vocab_size=512,
    rglru=RGLRUConfig(lru_width=256, block_pattern=("rglru", "rglru", "local"),
                      local_window=64),
    dvi=DVIConfig(split_layer=1, lora_rank=8, buffer_slots=512, batch_size=64),
)
