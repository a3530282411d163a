from .ops import (bwd_route, head_route, lm_head_bwd, lm_head_ce,
                  lm_head_logits)
from .ref import (lm_head_bwd_ref, lm_head_bwd_split_ref, lm_head_ce_ref,
                  lm_head_ce_stats_ref, lm_head_logits_ref, masked_logits_ref,
                  split_hi_lo)

__all__ = ["lm_head_logits", "lm_head_ce", "lm_head_bwd", "head_route",
           "bwd_route", "lm_head_bwd_split_ref", "split_hi_lo",
           "lm_head_logits_ref", "masked_logits_ref", "lm_head_ce_ref",
           "lm_head_ce_stats_ref", "lm_head_bwd_ref"]
