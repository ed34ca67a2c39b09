"""Tracing/observability (SURVEY.md section 5: the reference has none —
the device build provides jax.profiler traces and a per-stage device-time
breakdown)."""

from __future__ import annotations

import contextlib
import sys


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Wrap a mapping run in a jax.profiler trace when trace_dir is set
    (view with TensorBoard / xprof)."""
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def print_stage_stats(stats: dict, n_reads: int, total_bp: int, dt: float, file=sys.stderr):
    """Per-stage wall-time breakdown in the spirit of the reference's
    index stats line (main.rs:154-155)."""
    parts = " ".join(
        f"{k}:{v:.2f}s" for k, v in sorted(stats.items())
        if isinstance(v, (int, float))
    )
    print(
        f"[mm2t] mapped {n_reads} reads ({total_bp} bp) in {dt:.2f}s "
        f"({total_bp / max(dt, 1e-9):.0f} bp/s) | {parts}",
        file=file,
    )
