"""Architecture configs (a copy of ``repro.configs``).

The port keeps its own copy so that it never imports the JAX package; the
fields, the ten arch modules and ``reduced()`` are identical, and a test
holds them equal. The input-shape grid and ``input_specs`` (JAX
``ShapeDtypeStruct`` stand-ins) are left out: nothing in the port uses
them.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = ["ArchConfig", "ARCHS", "get_config", "reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                    # 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # attention
    attn_type: str = "gqa"          # gqa | mla | none
    head_dim: Optional[int] = None  # default d_model // n_heads
    window: Optional[int] = None    # sliding-window size (mixtral)
    rope_theta: float = 500000.0
    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024      # GShard dispatch group (tokens)
    # SSM
    ssm_type: str = ""              # mamba1 | mamba2
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0
    ssm_head_dim: int = 64          # mamba2
    dt_rank: int = 0                # mamba1 (0 => ceil(d_model/16))
    ssm_bcdt_norm: bool = False     # falcon-mamba: RMS-normalize dt/B/C
    # hybrid (zamba2): one shared attention block applied every k layers
    shared_attn_every: int = 0
    # modality frontends (stubs per assignment)
    frontend: str = ""              # "" | audio_stub | vision_stub
    num_prefix_embeddings: int = 0  # patches / conditioning frames
    prefix_lm: bool = False         # bidirectional prefix (paligemma)
    pos_embed: str = "rope"         # rope | sinusoidal
    embed_scale: bool = False       # gemma-style sqrt(d_model) scaling
    # numerics
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def resolved_d_inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def has_attention(self) -> bool:
        return self.attn_type != "none"

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.window is not None


ARCHS = [
    "llama3_2_1b", "internlm2_20b", "internlm2_1_8b", "granite_3_8b",
    "mixtral_8x22b", "deepseek_v2_lite", "musicgen_medium", "zamba2_7b",
    "falcon_mamba_7b", "paligemma_3b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "llama3.2-1b": "llama3_2_1b", "internlm2-1.8b": "internlm2_1_8b",
    "granite-3-8b": "granite_3_8b", "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "mixtral-8x22b": "mixtral_8x22b", "musicgen-medium": "musicgen_medium",
    "zamba2-7b": "zamba2_7b", "falcon-mamba-7b": "falcon_mamba_7b",
    "paligemma-3b": "paligemma_3b",
})


def get_config(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """CPU smoke-test variant of the same family (small dims, same structure)."""
    changes = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.shared_attn_every else 2),
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        dtype="float32",
    )
    if cfg.has_attention:
        changes.update(
            n_heads=4,
            n_kv_heads=1 if cfg.n_kv_heads == 1 else (4 if cfg.n_kv_heads == cfg.n_heads else 2),
            head_dim=32,
        )
    if cfg.attn_type == "mla":
        changes.update(kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32)
    if cfg.n_experts:
        changes.update(n_experts=4, n_experts_per_tok=min(cfg.n_experts_per_tok, 2),
                       moe_d_ff=64 if cfg.moe_d_ff else 0,
                       n_shared_experts=min(cfg.n_shared_experts, 1),
                       first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.ssm_type:
        changes.update(d_inner=256, ssm_state=min(cfg.ssm_state, 16),
                       dt_rank=8 if cfg.ssm_type == "mamba1" else 0,
                       ssm_head_dim=32)
    if cfg.window:
        changes.update(window=32)
    if cfg.shared_attn_every:
        changes.update(shared_attn_every=2)
    if cfg.num_prefix_embeddings:
        changes.update(num_prefix_embeddings=8)
    return dataclasses.replace(cfg, **changes)
