"""repro_torch.core: the op front end and autotuning (the counterparts of
``repro.core.op`` and ``repro.core.tune``). The kernel language, its
analyzer and cost model and the OCCA host API are not ported yet."""

from .op import Op, define_op, get_op, registered_ops, to_tensors
from .tune import (SCHEMA_VERSION, Tolerance, TuneResult,
                   autotune, cached_winner, prune_candidates, target_key,
                   tune_cache_dir, tune_cache_key)

__all__ = [
    "Op",
    "SCHEMA_VERSION",
    "Tolerance",
    "TuneResult",
    "autotune",
    "cached_winner",
    "define_op",
    "get_op",
    "prune_candidates",
    "registered_ops",
    "target_key",
    "to_tensors",
    "tune_cache_dir",
    "tune_cache_key",
]
