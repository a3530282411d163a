from .context import Rules, current_rules, use_rules
from .rules import ring_axis_for
from .steps import (GraphStep, TrainGraphStep, build_paged_serve_step,
                    build_prefill_step, build_serve_step, build_train_step,
                    make_shardings)

__all__ = ["Rules", "current_rules", "use_rules", "ring_axis_for",
           "build_train_step", "build_prefill_step", "build_serve_step",
           "build_paged_serve_step", "GraphStep", "TrainGraphStep",
           "make_shardings"]
