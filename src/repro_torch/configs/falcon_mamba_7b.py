"""falcon-mamba-7b [arXiv:2410.05355; unverified] — pure mamba1, attn-free."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="falcon_mamba_7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024, attn_type="none",
    ssm_type="mamba1", ssm_state=16, ssm_conv=4, d_inner=8192,
    ssm_bcdt_norm=True,
)
