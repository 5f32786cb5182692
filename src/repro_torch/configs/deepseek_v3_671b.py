"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA, 1 shared + 256 routed top-8 MoE,
first 3 layers dense, optional MTP auxiliary head."""
from repro_torch.configs.base import DVIConfig, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7_168,
    num_heads=128,
    num_kv_heads=128,              # MLA: heads share a compressed latent KV
    head_dim=128,
    d_ff=2_048,                    # routed expert intermediate size
    vocab_size=129_280,
    rope_theta=10_000.0,
    mla=MLAConfig(q_lora_rank=1_536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2_048,
                  num_shared_experts=1, d_ff_shared=2_048,
                  first_dense_layers=3, d_ff_dense=18_432),
    mtp_depth=1,
    dvi=DVIConfig(split_layer=2),
    citation="arXiv:2412.19437",
)

TINY = CONFIG.replace(
    name="deepseek-v3-671b-tiny",
    num_layers=3, d_model=256, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=128, vocab_size=512,
    mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                  num_shared_experts=1, d_ff_shared=128,
                  first_dense_layers=1, d_ff_dense=256, capacity_factor=8.0),
    mtp_depth=0,
    dvi=DVIConfig(split_layer=1, lora_rank=8, buffer_slots=512, batch_size=64),
)
