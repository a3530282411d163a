"""repro_torch.core: the paper's contribution, a unified kernel language
and host API, with the op front end and autotuning (the counterpart of
``repro.core``).

One kernel source expands at run time to three backends, picked per
:class:`Device`: ``torch`` (vectorised PyTorch), ``loops`` (a loop over
the grid cells) and ``cuda`` (the spec's hand-written Hopper kernel,
bound in ``core.cuda``). Every TPU builder of the JAX package has its
spec here, bound to its kernel. The analyzer's grid pass gates every
Spec, its body pass and footprint every build (``analyze=``); its cost
model (shared memory a block, device-memory bytes, FLOPs) prices a spec
and prunes tuning sweeps on torch and loops. Every public op is a
``define_op`` over its builder, differentiable through an ``OpVJP`` or
``oracle_vjp``. The JAX package's mesh schedule (``OpShard``, ``mesh=``)
is not ported yet.
"""

from .analyze import (ANALYZE_MODES, DEFAULT_SMEM_BUDGET, SEVERITY,
                      AnalysisError, AnalysisWarning, CostReport, Finding,
                      Report, analysis_mode, analyze_spec, check_body,
                      check_built_spec, estimate_cost, estimate_flops,
                      set_analysis_mode, smem_budget, smem_footprint,
                      trace_body)
from .cuda import Binding, bind_cuda, bound_specs, cuda_binding
from .device import BuildStats, Device, default_device, fit_block, resolve_model
from .kernel import Kernel
from .lang import (BACKENDS, Ctx, Scratch, ShardAxis, Spec, Tile, TileRef,
                   as_dtype, cdiv, defines_namespace, expand)
from .memory import Memory
from .op import (Op, OpVJP, define_op, get_op, oracle_vjp, registered_ops,
                 to_tensors)
from .tune import (SCHEMA_VERSION, Tolerance, TuneResult,
                   autotune, cached_winner, candidates, prune_by_cost,
                   prune_candidates, target_key, tune_cache_dir,
                   tune_cache_key)

__all__ = [
    "ANALYZE_MODES",
    "AnalysisError",
    "AnalysisWarning",
    "BACKENDS",
    "Binding",
    "BuildStats",
    "CostReport",
    "Ctx",
    "DEFAULT_SMEM_BUDGET",
    "Device",
    "Finding",
    "Kernel",
    "Memory",
    "Op",
    "OpVJP",
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
    "analysis_mode",
    "analyze_spec",
    "as_dtype",
    "autotune",
    "bind_cuda",
    "bound_specs",
    "cached_winner",
    "candidates",
    "cdiv",
    "check_body",
    "check_built_spec",
    "cuda_binding",
    "default_device",
    "define_op",
    "defines_namespace",
    "estimate_cost",
    "estimate_flops",
    "expand",
    "fit_block",
    "get_op",
    "oracle_vjp",
    "prune_by_cost",
    "prune_candidates",
    "registered_ops",
    "resolve_model",
    "set_analysis_mode",
    "smem_budget",
    "smem_footprint",
    "target_key",
    "trace_body",
    "to_tensors",
    "tune_cache_dir",
    "tune_cache_key",
]
