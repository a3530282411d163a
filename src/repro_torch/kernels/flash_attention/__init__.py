from .ops import (decode_split, flash_attention, flash_attention_bwd,
                  flash_attention_fwd, flash_bwd, flash_decode, flash_delta,
                  paged_decode_attention, paged_split, ring_flash_bwd,
                  ring_flash_fwd, route)
from .ref import (decode_ref, decode_split_ref, flash_bwd_ref,
                  flash_delta_ref, flash_fwd_ref, mha_ref, paged_decode_ref, paged_decode_split_ref,
                  ring_bwd_ref, ring_bwd_tc_ref,
                  ring_fwd_ref, ring_step_ref, rolling_slot_pos)
from .ring import ring_flash_attention, ring_merge

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_delta", "flash_bwd", "flash_decode", "decode_split",
           "paged_decode_attention", "paged_split", "ring_flash_fwd",
           "ring_flash_bwd",
           "route", "ring_flash_attention", "ring_merge",
           "flash_fwd_ref", "flash_delta_ref", "flash_bwd_ref", "mha_ref",
           "decode_ref", "decode_split_ref", "paged_decode_ref",
           "paged_decode_split_ref",
           "rolling_slot_pos",
           "ring_fwd_ref", "ring_bwd_ref", "ring_bwd_tc_ref",
           "ring_step_ref"]
