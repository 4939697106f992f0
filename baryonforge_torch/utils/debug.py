"""Timing helpers (port of ``baryonforge_tpu.utils.debug``; reference
utils/debug.py).

``log_time`` injects a per-checkpoint wall-time callback. For device-side
timing use CUDA events (the runners' ``timings``) or ``torch.profiler``;
this module covers the reference's lightweight host-side instrumentation.
"""

from .misc import log_time

__all__ = ["log_time"]
