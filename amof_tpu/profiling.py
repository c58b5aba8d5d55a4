"""
Profiling and observability subsystem.

The reference has none (SURVEY.md §5.1 — only stale timing remarks in
comments). This module provides:

  * ``trace(logdir)``: context manager around ``jax.profiler`` traces
    (TensorBoard-compatible) for the device kernels;
  * ``timed(name)``: wall-clock section timing with a process-global
    registry, safe around async dispatch (forces a sync);
  * ``timings()`` / ``reset_timings()``: structured access, the runtime
    analog of the reference's report_search bookkeeping;
  * ``profile_stages(stages, frames)``: first call, steady wall, device
    busy time and idle share per stage, the device numbers reduced from
    a profiler trace by ``stage_device_times``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, List

logger = logging.getLogger(__name__)

_TIMINGS: Dict[str, List[float]] = defaultdict(list)


@contextlib.contextmanager
def trace(logdir, create_perfetto_link: bool = False):
    """Capture a jax profiler trace of the enclosed block."""
    import jax

    jax.profiler.start_trace(str(logdir),
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(name: str, sync: bool = True):
    """Time a section; with sync=True, waits for outstanding device work
    before stopping the clock (async dispatch otherwise lies)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            try:
                import jax

                jax.effects_barrier()
            except Exception:  # noqa: BLE001 — profiling must not raise
                pass
        elapsed = time.perf_counter() - start
        _TIMINGS[name].append(elapsed)
        logger.debug("timed[%s] = %.4fs", name, elapsed)


def timings() -> Dict[str, Dict[str, float]]:
    """{section: {count, total, mean, min, max}} of all timed blocks."""
    out = {}
    for name, values in _TIMINGS.items():
        out[name] = {
            "count": len(values),
            "total": sum(values),
            "mean": sum(values) / len(values),
            "min": min(values),
            "max": max(values),
        }
    return out


def reset_timings():
    _TIMINGS.clear()


def device_memory_stats():
    """Per-device memory stats where the backend exposes them."""
    import jax

    stats = {}
    for d in jax.devices():
        try:
            stats[str(d)] = d.memory_stats()
        except Exception:  # noqa: BLE001 — optional backend feature
            stats[str(d)] = None
    return stats


STAGE_PREFIX = "stage:"


def _union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def stage_device_times(planes, prefix: str = STAGE_PREFIX):
    """Per-stage device time from the planes of a profiler trace, and
    the names of the device lines it read.

    A stage is a host span named ``prefix + name`` (a
    ``jax.profiler.TraceAnnotation`` around work that ends in
    ``block_until_ready``). Device work is every event on a
    ``/device:`` plane line whose name starts with "Stream" (one line
    per stream: the kernels and copies). For each stage returns
    {name: {"window_ns", "kernel_ns" (sum of device event durations
    starting inside the span), "busy_ns" (their union), "idle_share"
    (1 - busy / window), "events"}}; repeated spans of one name add up.
    The planes are read in one pass (ProfileData yields them lazily).

    ``planes`` are ``jax.profiler.ProfileData(...).planes`` or anything
    with the same ``name``/``lines``/``events``/``start_ns``/
    ``duration_ns`` attributes.
    """
    spans, device, lines = [], [], set()
    for plane in planes:
        for line in plane.lines:
            if plane.name.startswith("/device:"):
                lines.add(f"{plane.name}|{line.name}")
            for ev in line.events:
                start = int(ev.start_ns)
                end = start + int(ev.duration_ns)
                if (plane.name.startswith("/host")
                        and ev.name.startswith(prefix)):
                    spans.append((ev.name[len(prefix):], start, end))
                elif (plane.name.startswith("/device:")
                        and line.name.startswith("Stream")):
                    device.append((start, end))
    device.sort()
    out = {}
    for name, s0, s1 in spans:
        inside = [(s, e) for s, e in device if s0 <= s < s1]
        rec = out.setdefault(name, {"window_ns": 0, "kernel_ns": 0,
                                    "busy_ns": 0, "events": 0})
        rec["window_ns"] += s1 - s0
        rec["kernel_ns"] += sum(e - s for s, e in inside)
        rec["busy_ns"] += _union_ns([(s, min(e, s1)) for s, e in inside])
        rec["events"] += len(inside)
    for rec in out.values():
        rec["idle_share"] = 1.0 - rec["busy_ns"] / max(rec["window_ns"], 1)
    return out, sorted(lines)


def profile_stages(stages, frames: int, repeats: int = 3,
                   wall_repeats: int = 5, logdir=None):
    """Compile, time and trace each ``(name, fn)`` of ``stages``, where
    one call of ``fn`` processes ``frames`` frames; prints one line per
    stage and returns {name: metrics}, all per frame:

    * ``first_call_s``: the first call, compile included (seconds);
    * ``wall_ms``: median host wall of ``wall_repeats`` steady calls,
      each ended by ``block_until_ready``, the profiler off;
    * ``device_busy_ms``: union of the device events of ``repeats``
      traced calls, each inside a ``stage:<name>`` span
      (``stage_device_times``);
    * ``kernel_sum_ms``: their summed durations (above busy when events
      overlap, e.g. nested or on concurrent streams);
    * ``idle_share`` of the traced windows.
    """
    import glob
    import os
    import statistics
    import tempfile
    import time

    import jax

    out = {}
    for name, fn in stages:
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        first = time.perf_counter() - t0
        walls = []
        for _ in range(wall_repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            walls.append(time.perf_counter() - t0)
        out[name] = {"first_call_s": first,
                     "wall_ms": 1e3 * statistics.median(walls) / frames}
    logdir = logdir or tempfile.mkdtemp(prefix="trace_stages_")
    with trace(logdir):
        for name, fn in stages:
            for _ in range(repeats):
                with jax.profiler.TraceAnnotation(STAGE_PREFIX + name):
                    jax.block_until_ready(fn())
    path = max(glob.glob(os.path.join(
        str(logdir), "plugins", "profile", "*", "*.xplane.pb"
    )), key=os.path.getmtime)
    times, lines = stage_device_times(
        jax.profiler.ProfileData.from_file(path).planes)
    print(f"device trace lines: {lines}")
    per = 1e6 * frames * repeats
    for name, rec in out.items():
        t = times.get(name, {})
        rec.update({
            "device_busy_ms": t.get("busy_ns", 0) / per,
            "kernel_sum_ms": t.get("kernel_ns", 0) / per,
            "idle_share": t.get("idle_share"),
            "device_events": t.get("events", 0),
        })
        print(f"stage {name}: first call {rec['first_call_s']:.3f} s, "
              f"wall {rec['wall_ms']:.4f} ms/frame, device busy "
              f"{rec['device_busy_ms']:.4f} ms/frame (kernel sum "
              f"{rec['kernel_sum_ms']:.4f}), idle share "
              f"{rec['idle_share']}, events {rec['device_events']}",
              flush=True)
    return out
