"""Host-side utilities of the port."""

from .profiling import DecodeStats, Timer, device_op_times, trace

__all__ = ["DecodeStats", "Timer", "device_op_times", "trace"]
