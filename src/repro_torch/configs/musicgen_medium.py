"""musicgen-medium [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

Backbone only per assignment: the text-conditioning frontend is a STUB
(input_specs() provides precomputed conditioning embeddings prepended as a
prefix; the paper's cross-attention conditioning is replaced by prefix
conditioning — recorded in DESIGN.md). MHA (kv == heads), sinusoidal pos.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="musicgen_medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    frontend="audio_stub", num_prefix_embeddings=16,
    pos_embed="sinusoidal",
)
