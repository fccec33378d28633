"""Utilities (port of `stereomatch_tpu/utils/`): stage timing/profiling,
checkpoints, debug artifact savers (SURVEY.md §5 aux subsystems)."""

from .timing import StageTimer, profile_trace, timing_stat  # noqa: F401
from .checkpoint import load_state, save_state  # noqa: F401
from .debug import (  # noqa: F401
    save_cost_slice,
    save_support_weights,
    save_tree_weights,
)
