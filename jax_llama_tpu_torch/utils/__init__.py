"""Host-side utilities of the port."""

from .profiling import DecodeStats, Timer

__all__ = ["DecodeStats", "Timer"]
