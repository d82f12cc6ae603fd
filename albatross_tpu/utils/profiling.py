"""Profiling and tracing helpers.

The reference's introspection story is CallTrace + ostream logs (SURVEY §5.1);
the equivalent here is the jax profiler: named scopes label the hot ops in
xprof/perfetto traces, and ``trace`` captures a profile directory viewable
with tensorboard or ui.perfetto.dev.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace: ``with trace('/tmp/prof'): run_step()``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def named_scope(name: str):
    """Label a region in profiler traces (usable as decorator or context)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def wall_timer(label: str, results: Optional[dict] = None) -> Iterator[None]:
    """Host-side wall timer; stores seconds into ``results[label]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        if results is not None:
            results[label] = elapsed
