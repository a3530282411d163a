"""zamba2-7b [arXiv:2411.15242; unverified] — mamba2 backbone + SHARED
attention block (one set of weights applied every 6th layer with its own KV
cache per application). ssm_state=64, d_inner=2*d_model, head_dim 64."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="zamba2_7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_type="mamba2", ssm_state=64, ssm_conv=4, ssm_head_dim=64,
    shared_attn_every=6,
)
