from .convert import from_jax_params, tree_to
from .lm import LM, StackSpec, build_program, pad_vocab

__all__ = ["LM", "StackSpec", "build_program", "pad_vocab", "from_jax_params",
           "tree_to"]
