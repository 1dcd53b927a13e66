"""Observability: frame timing, throughput stats, device profiling.

Reference parity: the viewer's ms/frame + FPS + map counters
(slam_thread.cpp:200-202,240-241; slam_statistics_widget.cpp:28-34),
plus what the reference lacks — persisted timing reports and
jax.profiler trace capture for real device timelines (SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional


class FrameTimer:
    """Wall-clock per-stage timing with summary statistics."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            if not xs:
                continue
            xs_sorted = sorted(xs)
            n = len(xs)
            out[name] = {
                "n": n,
                "mean_ms": 1e3 * sum(xs) / n,
                "p50_ms": 1e3 * xs_sorted[n // 2],
                "p95_ms": 1e3 * xs_sorted[min(n - 1, int(n * 0.95))],
                "total_s": sum(xs),
            }
        return out

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_busy_ns(log_dir: str, plane_prefix: str = "/device:GPU:0"):
    """Busy time of one device in the newest trace under `log_dir`.

    -> (busy_ns, {kernel name: total ns}).  Busy is the union of the
    intervals of the events on the device plane's stream lines, so
    concurrent kernels are not counted twice.  Raises when the trace has
    no such plane (a host-only trace cannot give a device time)."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no xplane trace under {log_dir}")
    planes = [p for p in ProfileData.from_file(paths[-1]).planes
              if p.name.startswith(plane_prefix)]
    if not planes:
        raise ValueError(f"trace has no plane {plane_prefix!r}")
    spans, per_name = [], defaultdict(int)
    for line in planes[0].lines:
        if not line.name.startswith("Stream"):
            continue
        for ev in line.events:
            start, dur = int(ev.start_ns), int(ev.duration_ns)
            spans.append((start, start + dur))
            per_name[ev.name] += dur
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, dict(per_name)


def scan_times(fn, xs, n: int):
    """Time fn(*x) -> scalar inside ONE jitted lax.scan over the n
    different inputs stacked in xs.

    -> (host ms/call, device ms/call, {kernel name: total ns}): host is
    the best of 3 wall times around the whole scan; device is the busy
    time of the first GPU over one traced scan (`device_busy_ns`), so it
    excludes dispatch and needs a GPU."""
    import tempfile

    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(*xs):
        def body(c, x):
            return c + fn(*x), 0
        return jax.lax.scan(body, jnp.float32(0), xs)[0]

    jax.block_until_ready(run(*xs))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*xs))
        best = min(best, time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        with device_trace(d):
            jax.block_until_ready(run(*xs))
        busy, per_name = device_busy_ns(d)
    return best / n * 1e3, busy / n / 1e6, per_name
