"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B; unverified] — small llama3, dense GQA."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama3_2_1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=64,
    rope_theta=500000.0, tie_embeddings=True,
)
