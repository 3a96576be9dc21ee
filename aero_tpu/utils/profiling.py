"""Profiling helpers around jax.profiler (the observability the reference
lacks; SURVEY.md §5 'use JAX profiler/xprof')."""

from __future__ import annotations

import contextlib
import os
import time

# the repository checkout: aero_tpu/utils/ -> aero_tpu/ -> checkout
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture an xprof trace of the enclosed block:

        with trace_to("/tmp/aero-trace"):
            station.process(block)

    View with xprof/tensorboard."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class RateMeter:
    """Samples/s + realtime-factor meter for streaming loops."""

    def __init__(self, sample_rate: float):
        self.sample_rate = sample_rate
        self.samples = 0
        self.t0 = time.perf_counter()

    def update(self, n_samples: int):
        self.samples += n_samples

    @property
    def samples_per_s(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.samples / dt if dt > 0 else 0.0

    @property
    def realtime_factor(self) -> float:
        return self.samples_per_s / self.sample_rate


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``.

    The path is fixed (no temp name, pid or time in it): the cache only
    hits when a restart finds the directory where the last run left it."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Persistent XLA compilation cache: restarts skip the first-compile
    cost.  One place for the policy; all three CLIs call this.  Returns
    the directory."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
