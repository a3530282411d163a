"""granite-3-8b [hf:ibm-granite/granite-3.0-8b-base; hf] — dense GQA.

vocab 49155 is not divisible by the model axis; the embedding is padded to a
multiple of 256 by parallel.vocab (Megatron convention) — see DESIGN.md.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="granite_3_8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab_size=49155, head_dim=128,
    rope_theta=10000000.0,
)
