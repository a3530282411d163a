"""internlm2-20b [arXiv:2403.17297; hf] — dense GQA."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="internlm2_20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92544, head_dim=128,
    rope_theta=1000000.0,
)
