"""Profiling / tracing helpers (the reference's only instrumentation is two
debug-level timers around the 2D pipeline, mcsamples.py:1869,1999; here we
provide proper device-accurate timing and jax profiler traces)."""

import contextlib
import logging
import time

__all__ = ["device_timer", "trace_to"]


@contextlib.contextmanager
def device_timer(label, sync_value=None, logger=None):
    """Wall-clock a device computation: on exit, wait for ``sync_value``
    (or ``holder["sync"]``, a pytree of arrays) with
    ``jax.block_until_ready`` so the time covers the device work, not only
    its dispatch."""
    import jax

    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        value = holder.get("sync", sync_value)
        if value is not None:
            jax.block_until_ready(value)
        dt = time.perf_counter() - t0
        holder["seconds"] = dt
        (logger or logging.getLogger("getdist_tpu")).debug("%s: %.3f s", label, dt)


@contextlib.contextmanager
def trace_to(log_dir):
    """Capture a jax profiler trace (view with tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
