from .adamw import AdamW, WarmupCosine, global_norm

__all__ = ["AdamW", "WarmupCosine", "global_norm"]
