"""repro_torch.core: the paper's contribution, a unified kernel language
and host API, with the op front end and autotuning (the counterpart of
``repro.core``).

One kernel source expands at run time to three backends, picked per
:class:`Device`: ``torch`` (vectorised PyTorch), ``loops`` (a loop over
the grid cells) and ``cuda`` (the spec's hand-written Hopper kernel,
bound in ``core.cuda``). The analyzer's grid pass gates every Spec; its
body pass and cost model, ``OpShard``, ``OpVJP`` and ``oracle_vjp`` are
not ported yet.
"""

from .analyze import (ANALYZE_MODES, SEVERITY, AnalysisError,
                      AnalysisWarning, Finding, Report)
from .cuda import Binding, bind_cuda, bound_specs, cuda_binding
from .device import BuildStats, Device, default_device, fit_block, resolve_model
from .kernel import Kernel
from .lang import (BACKENDS, Ctx, Scratch, ShardAxis, Spec, Tile, TileRef,
                   as_dtype, cdiv, defines_namespace, expand)
from .memory import Memory
from .op import Op, define_op, get_op, registered_ops, to_tensors
from .tune import (SCHEMA_VERSION, Tolerance, TuneResult,
                   autotune, cached_winner, prune_candidates, target_key,
                   tune_cache_dir, tune_cache_key)

__all__ = [
    "ANALYZE_MODES",
    "AnalysisError",
    "AnalysisWarning",
    "BACKENDS",
    "Binding",
    "BuildStats",
    "Ctx",
    "Device",
    "Finding",
    "Kernel",
    "Memory",
    "Op",
    "Report",
    "SCHEMA_VERSION",
    "SEVERITY",
    "Scratch",
    "ShardAxis",
    "Spec",
    "Tile",
    "TileRef",
    "Tolerance",
    "TuneResult",
    "as_dtype",
    "autotune",
    "bind_cuda",
    "bound_specs",
    "cached_winner",
    "cdiv",
    "cuda_binding",
    "default_device",
    "define_op",
    "defines_namespace",
    "expand",
    "fit_block",
    "get_op",
    "prune_candidates",
    "registered_ops",
    "resolve_model",
    "target_key",
    "to_tensors",
    "tune_cache_dir",
    "tune_cache_key",
]
