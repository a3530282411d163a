"""deepseek-v2-lite-16b [arXiv:2405.04434; hf] — MLA + MoE 64 routed top-6,
2 shared experts, first layer dense (d_ff 10944), expert d_ff 1408,
kv_lora_rank 512, qk rope/nope 64/128."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_v2_lite", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    attn_type="mla", kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
    v_head_dim=128, rope_theta=10000.0,
    n_experts=64, n_experts_per_tok=6, n_shared_experts=2,
    moe_d_ff=1408, first_dense_layers=1,
)
