"""DeepSeek-V2 236B — MLA (kv_lora=512) + MoE 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]

Assignment config pins d_ff=1536 (the per-expert intermediate size); shared
experts also use 1536. All 60 layers are MoE per the assignment row (the HF
release makes layer 0 dense — the assignment config takes precedence).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    head_dim=128,
    attention="mla",
    layer_pattern=("attn",),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared_experts=2),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    rope="rope",
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    source="arXiv:2405.04434",
))
