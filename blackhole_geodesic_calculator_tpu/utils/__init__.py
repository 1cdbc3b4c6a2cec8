"""Utilities: timing, profiling, observability."""

from .cache import enable_compile_cache
from .timing import PhaseTimers, timed, benchmark
from .profiling import (trace, annotate, device_memory_stats,
                        profile_steps, op_table, format_op_table)

__all__ = ["PhaseTimers", "timed", "benchmark", "trace", "annotate",
           "device_memory_stats", "enable_compile_cache"]
