"""mixtral-8x22b [arXiv:2401.04088; hf] — MoE 8 experts top-2, sliding window.

8 experts < model-axis 16 -> TP-MoE layout (expert d_ff sharded over "model",
experts stacked); see DESIGN.md §Arch-applicability.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="mixtral_8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    window=4096, rope_theta=1000000.0,
    n_experts=8, n_experts_per_tok=2, moe_d_ff=16384,
)
