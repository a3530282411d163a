"""paligemma-3b [arXiv:2407.07726; hf] — SigLIP frontend STUB (precomputed
patch embeddings) + gemma-style MQA decoder (kv=1), prefix-LM attention over
image+prefix, GeGLU-ish SwiGLU d_ff 16384, vocab 257216."""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="paligemma_3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab_size=257216, head_dim=256,
    rope_theta=10000.0, embed_scale=True,
    frontend="vision_stub", num_prefix_embeddings=256, prefix_lm=True,
)
