from .profiling import device_timer, trace_to, phase_timings

__all__ = ["device_timer", "trace_to", "phase_timings"]
