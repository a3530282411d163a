from .ops import flash_attention, flash_attention_fwd, paged_decode_attention
from .ref import flash_fwd_ref, mha_ref, paged_decode_ref

__all__ = ["flash_attention", "flash_attention_fwd", "paged_decode_attention",
           "flash_fwd_ref", "mha_ref", "paged_decode_ref"]
