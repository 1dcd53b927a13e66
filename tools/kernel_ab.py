"""Plain XLA versus the Pallas kernels on the GPU, per op and end to end.

Per op: device time per call of the FAST score (all pyramid levels of a
640x480 frame) and of the Hamming 2-NN matcher (512 queries x 16,384
landmarks), each as the plain version and as the kernel, from a
profiler trace of a jitted lax.scan over different inputs.

End to end: tracking frames/s through engine.make_slam_scan (detect +
track, default SlamConfig, 640x480 synthetic loop) with each op swapped
between plain and kernel, timed in the order A B C D D C B A.

    python tools/kernel_ab.py [--frames 64] [--chunk 16] [--out FILE]

Needs a GPU; prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def _render(cfg, n_frames):
    from modular_slam_tpu.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu.types import LUMA_WEIGHTS

    gen = PlaneSceneGenerator(cfg.camera, seed=0, depth_noise=0.01)
    poses = gen.loop_trajectory(n_frames, radius=1.2)
    w = np.asarray(LUMA_WEIGHTS, np.float32)
    grays, depths = [], []
    for rgb, depth, _ in gen.sequence(poses):
        grays.append(rgb.astype(np.float32) @ w)
        depths.append(depth)
    return np.stack(grays), np.stack(depths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    from modular_slam_tpu.utils import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"kernel_ab needs a GPU, found {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), file=sys.stderr)

    import modular_slam_tpu.frontend.tracker as tracker
    import modular_slam_tpu.ops.detector as detector
    from modular_slam_tpu.config import CameraConfig, SlamConfig
    from modular_slam_tpu.engine import make_slam_scan
    from modular_slam_tpu.frontend.tracker import initial_state
    from modular_slam_tpu.map.arena import empty_arena
    from modular_slam_tpu.ops.fast import fast_score
    from modular_slam_tpu.ops.fast_pallas import fast_score_pallas
    from modular_slam_tpu.ops.match import match_descriptors
    from modular_slam_tpu.ops.match_pallas import match_descriptors_pallas
    from modular_slam_tpu.ops.pyramid import build_pyramid
    from modular_slam_tpu.utils.profiling import scan_times

    # the camera eval/make_dataset writes for 640x480 (fx = width)
    cfg = SlamConfig(camera=CameraConfig(fx=640.0, fy=640.0, cx=319.5,
                                         cy=239.5))
    grays_np, depths_np = _render(cfg, args.frames)
    grays, depths = jnp.asarray(grays_np), jnp.asarray(depths_np)
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "nvidia_smi": smi.strip(), "op_ms": {}, "fps": {}}

    # ---- per op ---------------------------------------------------------
    n = min(32, args.frames)
    for name, f in (("fast_plain", fast_score), ("fast_kernel",
                                                 fast_score_pallas)):
        host, devt, kern = scan_times(
            lambda g, f=f: sum(jnp.sum(f(l))
                               for l in build_pyramid(g, cfg.detector)),
            (grays[:n],), n)
        out["op_ms"][name] = {"host": host, "device": devt,
                              "top_kernels": dict(sorted(
                                  kern.items(), key=lambda kv: -kv[1])[:6])}

    rng = np.random.default_rng(0)
    Nq, L = cfg.detector.max_keypoints, cfg.map.max_landmarks
    qs = rng.integers(0, 2, (n, Nq, 256)).astype(np.int8) * 2 - 1
    t = rng.integers(0, 2, (L, 256)).astype(np.int8) * 2 - 1
    t[:Nq] = qs[0]
    qs_d, t_d = jnp.asarray(qs), jnp.asarray(t)
    qv = jnp.ones((Nq,), bool)
    tv = jnp.asarray(rng.random(L) < 0.3)
    for name, f in (("match_plain", match_descriptors),
                    ("match_kernel", match_descriptors_pallas)):
        host, devt, kern = scan_times(
            lambda q, f=f: jnp.sum(f(q, qv, t_d, tv, cfg.matcher).distance),
            (qs_d,), n)
        out["op_ms"][name] = {"host": host, "device": devt,
                              "top_kernels": dict(sorted(
                                  kern.items(), key=lambda kv: -kv[1])[:6])}
    print(json.dumps(out["op_ms"]), file=sys.stderr, flush=True)

    # ---- end to end: tracking scan frames/s -------------------------------
    variants = {
        "plain": (fast_score, match_descriptors),
        "fast_kernel": (fast_score_pallas, match_descriptors),
        "match_kernel": (fast_score, match_descriptors_pallas),
        "both_kernels": (fast_score_pallas, match_descriptors_pallas),
    }
    C = args.chunk
    n_chunks = args.frames // C
    times = jnp.arange(args.frames, dtype=jnp.float32) / 30.0
    keys = jax.random.split(jax.random.PRNGKey(0), args.frames)
    scans = {}
    for name, (ff, mf) in variants.items():
        detector.fast_score_fastest = ff
        tracker.match_descriptors_fastest = (
            lambda q, qv, t, tv, c, mf=mf: mf(q, qv, t, tv, c))
        scan = make_slam_scan(cfg)
        t0 = time.perf_counter()
        a, s, r = scan(empty_arena(cfg.map), initial_state(), grays[:C],
                       depths[:C], times[:C], keys[:C])
        jax.block_until_ready(s)
        out.setdefault("compile_s", {})[name] = time.perf_counter() - t0
        scans[name] = scan

    def run(scan):
        a, s = empty_arena(cfg.map), initial_state()
        jax.block_until_ready((a, s))
        t0 = time.perf_counter()
        ok = []
        for c in range(n_chunks):
            sl = slice(c * C, (c + 1) * C)
            a, s, r = scan(a, s, grays[sl], depths[sl], times[sl], keys[sl])
            ok.append(r.tracking_ok)
        jax.block_until_ready((a, s, ok))
        return n_chunks * C / (time.perf_counter() - t0), int(
            np.asarray(jnp.concatenate(ok)).sum())

    order = list(variants) + list(reversed(variants))
    for name in order:
        fps, n_ok = run(scans[name])
        out["fps"].setdefault(name, []).append(fps)
        out.setdefault("tracked_ok", {})[name] = n_ok
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
