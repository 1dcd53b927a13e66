"""Pin the host-CPU proxy baseline (VERDICT r3 next #7).

The headline `vs_baseline` ratio divides by the OpenCV/numpy proxy of
the reference pipeline, which is host-CPU-bound and drifts between
runs on the same nominal workload, making cross-round ratios
incomparable.
This tool measures the proxy as a median of N independent runs with
fixed seeds/scenes and stores the result in a checked-in
`BASELINE_PROXY.json`; bench.py then reports `vs_baseline` against the
PINNED denominator (and the live same-run measurement separately, as
`baseline_*_fps_live`).

Usage:  python tools/pin_baseline.py [--runs 5]
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402  (repo-root bench.py)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=str(
        Path(__file__).resolve().parent.parent / "BASELINE_PROXY.json"))
    args = ap.parse_args()

    cfg_p, frames_p, _ = bench._sequence("plane")
    cfg_b, frames_b, _ = bench._sequence("box")

    rows = {"tracking_fps": [], "tracking_ba_fps": [], "box_tracking_ba_fps": []}
    for i in range(args.runs):
        t0 = time.perf_counter()
        rows["tracking_fps"].append(
            bench.bench_opencv_baseline(cfg_p, frames_p, with_ba=False))
        rows["tracking_ba_fps"].append(
            bench.bench_opencv_baseline(cfg_p, frames_p, with_ba=True))
        rows["box_tracking_ba_fps"].append(
            bench.bench_opencv_baseline(cfg_b, frames_b, with_ba=True))
        print(f"run {i + 1}/{args.runs}: "
              f"{[round(v[-1], 2) for v in rows.values()]} "
              f"({time.perf_counter() - t0:.1f}s)", file=sys.stderr)

    out = {
        "protocol": "median of N runs, fixed seed-42 synthetic scenes, "
                    "N_FRAMES=67, same proxy code path as bench.py",
        "n_runs": args.runs,
        "pinned_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "host": platform.node(),
        "cpu": platform.processor() or platform.machine(),
        "tracking_fps": round(statistics.median(rows["tracking_fps"]), 3),
        "tracking_ba_fps": round(
            statistics.median(rows["tracking_ba_fps"]), 3),
        "box_tracking_ba_fps": round(
            statistics.median(rows["box_tracking_ba_fps"]), 3),
        "spread": {k: [round(min(v), 3), round(max(v), 3)]
                   for k, v in rows.items()},
    }
    Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
