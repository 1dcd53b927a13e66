#!/usr/bin/env python3
"""Smoke run of the SLAM engine on an NVIDIA GPU.

    python chip_smoke.py               # phases 1-3, one GPU
    python chip_smoke.py --devices 4   # phase 1, then the four-GPU phase only

1. device: a GPU or nothing; prints its kind, the JAX version and
   `nvidia-smi --query-gpu=name,power.limit`.
2. kernels: each Pallas kernel on the main path, compiled for the card
   at its real widths, against its plain reference (exactly), with the
   time per call of both.
3. main path: `modular_slam_tpu.run.main` with the `full` pipeline over
   a 640x480 two-lap synthetic loop at the default SlamConfig, then a
   per-frame (`--chunk 1`) run over its first 16 frames.
4. (--devices 4) the batched tracking scan over four divergent
   sequences on a four-GPU `seq` mesh against each sequence run alone,
   and the halo-sharded global BA on a four-GPU `kf` mesh against the
   single-device global BA of backend/ba.py.

Everything runs in this one process.  A failed phase raises, so the
exit code is non-zero and the result line is never printed; otherwise
the last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Phase 3 sequence: eval/make_dataset.write_dataset(frames=48, laps=2,
# 640x480, depth_noise=0.01, seed=0), 96 frames.  The same run on the
# CPU backend (JAX_PLATFORMS=cpu) tracks 96/96 frames, closes 2 loops
# and reaches ATE RMSE 0.0593 m.  GPU sums run in other orders and
# RANSAC then draws other inlier sets, so the trajectories differ; the
# GPU run may be at most twice as far from ground truth.
SEQ = dict(frames=48, laps=2, width=640, height=480, depth_noise=0.01,
           seed=0)
CPU_ATE_RMSE = 0.0593
ATE_FACTOR = 2.0
PER_FRAME_FRAMES = 16


def _log(msg: str) -> None:
    print(msg, flush=True)


def device_phase(n_devices: int) -> dict:
    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found {d0.platform})")
    if len(devs) < n_devices:
        raise SystemExit(f"chip_smoke: need {n_devices} GPUs, "
                         f"JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    _log(f"[device] {d0.device_kind}, jax {jax.__version__}, "
         f"{len(devs)} device(s)")
    _log(smi.strip().splitlines()[0])
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}


def write_sequence(out_dir: str) -> str:
    from modular_slam_tpu.eval.make_dataset import write_dataset

    t0 = time.perf_counter()
    info = write_dataset(out_dir, SEQ["frames"], loop=True, laps=SEQ["laps"],
                         width=SEQ["width"], height=SEQ["height"],
                         depth_noise=SEQ["depth_noise"], seed=SEQ["seed"])
    _log(f"[data] {info['frames']} frames {SEQ['width']}x{SEQ['height']} "
         f"in {time.perf_counter() - t0:.1f} s")
    return out_dir


def _load_grays(dataset: str, n: int) -> np.ndarray:
    from modular_slam_tpu.io import TumRgbdDataset
    from modular_slam_tpu.types import LUMA_WEIGHTS

    ds = TumRgbdDataset(dataset)
    w = np.asarray(LUMA_WEIGHTS, np.float32)
    out = []
    for i, (rgb, _d, _t) in enumerate(ds):
        if i >= n:
            break
        out.append(rgb.astype(np.float32) @ w)
    return np.stack(out)


def _matcher_problem(cfg, seed: int = 0):
    """512 queries against a 16,384-slot landmark table whose validity
    mask looks like the tracker's: a filled prefix of the table, of
    which the landmarks of 8 keyframe-sized blocks are covisible.  A
    third of the queries are near-duplicates (<= 24 flipped bits) of
    covisible landmarks, so the ratio test has real survivors."""
    rng = np.random.default_rng(seed)
    nq, L = cfg.detector.max_keypoints, cfg.map.max_landmarks
    t = rng.integers(0, 2, (L, 256)).astype(np.int8) * 2 - 1
    q = rng.integers(0, 2, (nq, 256)).astype(np.int8) * 2 - 1
    filled = np.arange(L) < (3 * L) // 4
    blocks = rng.choice((3 * L) // 4 // 512, 8, replace=False)
    tv = filled & np.isin(np.arange(L) // 512, blocks)
    src = rng.choice(np.flatnonzero(tv), nq // 3, replace=False)
    for i, s in enumerate(src):
        row = t[s].copy()
        flip = rng.choice(256, int(rng.integers(0, 25)), replace=False)
        row[flip] *= -1
        q[i] = row
    qv = rng.random(nq) > 0.1
    return q, qv, t, tv


def kernel_phase(dataset: str) -> None:
    import jax
    import jax.numpy as jnp

    from modular_slam_tpu.config import SlamConfig
    from modular_slam_tpu.ops.fast import fast_score
    from modular_slam_tpu.ops.fast_pallas import fast_score_pallas
    from modular_slam_tpu.ops.match import match_descriptors
    from modular_slam_tpu.ops.match_pallas import match_descriptors_pallas
    from modular_slam_tpu.ops.pyramid import build_pyramid
    from modular_slam_tpu.utils.profiling import scan_times

    cfg = SlamConfig()
    n = 32
    grays = jnp.asarray(_load_grays(dataset, n))

    # FAST on every level of the 8-level 640x480 pyramid; the kernel
    # reads zeros where the plain version wraps, so the 3-pixel rim
    # (inside the detector's 19-pixel border mask) is not compared
    levels = jax.jit(lambda g: build_pyramid(g, cfg.detector))(grays[0])
    plain, kern = jax.jit(fast_score), jax.jit(fast_score_pallas)
    for lvl, img in enumerate(levels):
        a, b = np.asarray(plain(img)), np.asarray(kern(img))
        np.testing.assert_array_equal(a[3:-3, 3:-3], b[3:-3, 3:-3])
        _log(f"[kernels] fast level {lvl} {img.shape[0]}x{img.shape[1]}: "
             f"exact ({int((a > 0).sum())} nonzero scores)")
    # device time from a profiler trace of one jitted scan over n frames
    for name, f in (("plain", fast_score), ("kernel", fast_score_pallas)):
        host, dev, _ = scan_times(
            lambda g, f=f: sum(jnp.sum(f(l))
                               for l in build_pyramid(g, cfg.detector)),
            (grays,), n)
        _log(f"[kernels] pyramid + fast, 8 levels, {name}: device "
             f"{dev:.4f} ms/frame (host {host:.4f})")

    q, qv, t, tv = (jnp.asarray(x) for x in _matcher_problem(cfg))
    ref = jax.jit(lambda *a: match_descriptors(*a, cfg.matcher))(q, qv, t, tv)
    got = jax.jit(lambda *a: match_descriptors_pallas(*a, cfg.matcher))(
        q, qv, t, tv)
    for field in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, field)),
                                      np.asarray(getattr(got, field)))
    _log(f"[kernels] match {q.shape[0]}x{t.shape[0]} "
         f"({int(tv.sum())} valid landmarks): exact, "
         f"{int(ref.valid.sum())} matches")
    qs = jnp.asarray(np.stack([_matcher_problem(cfg, s)[0]
                               for s in range(n)]))
    for name, f in (("plain", match_descriptors),
                    ("kernel", match_descriptors_pallas)):
        host, dev, _ = scan_times(
            lambda qq, f=f: jnp.sum(f(qq, qv, t, tv, cfg.matcher).distance),
            (qs,), n)
        _log(f"[kernels] match 512x16384, {name}: device {dev:.4f} ms/call "
             f"(host {host:.4f})")


def _run_cli(argv) -> dict:
    from modular_slam_tpu import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    if rc != 0:
        raise RuntimeError(f"run.main({argv}) returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _scan_memory(dataset: str, chunk: int = 16):
    """memory_analysis() of the chunk scan the `full` pipeline compiles
    (same config and components, so the compile cache serves it)."""
    import jax
    import jax.numpy as jnp

    from modular_slam_tpu.config import SlamConfig
    from modular_slam_tpu.engine import make_slam_scan
    from modular_slam_tpu.frontend.tracker import initial_state
    from modular_slam_tpu.io import TumRgbdDataset
    from modular_slam_tpu.loop.detector import empty_database
    from modular_slam_tpu.loop.vocab import load_trained_vocab
    from modular_slam_tpu.map.arena import empty_arena
    from modular_slam_tpu.models.components import build_components

    cam = TumRgbdDataset(dataset).camera
    cfg = SlamConfig().replace(camera=cam)
    scan = make_slam_scan(cfg, build_components(cfg), with_features=True,
                          reloc_vocab=load_trained_vocab(cfg.loop.vocab_size))
    f32 = jnp.float32
    args = (empty_arena(cfg.map), initial_state(),
            empty_database(cfg.map.max_keyframes, cfg.loop.vocab_size),
            jax.ShapeDtypeStruct((chunk, cam.height, cam.width), f32),
            jax.ShapeDtypeStruct((chunk, cam.height, cam.width), f32),
            jax.ShapeDtypeStruct((chunk,), f32),
            jax.ShapeDtypeStruct((chunk, 2), jnp.uint32))
    return scan.lower(*args).compile().memory_analysis()


def main_path_phase(dataset: str, out_dir: str) -> None:
    n_frames = SEQ["frames"] * SEQ["laps"]
    traj = os.path.join(out_dir, "traj_full.txt")
    t0 = time.perf_counter()
    rep = _run_cli(["--dataset", dataset, "--out", traj,
                    "--pipeline", "full", "--ate"])
    ate = rep["ate"]["rmse"]
    _log(f"[main] full pipeline, chunk 16: {json.dumps(rep)}")
    _log(f"[main] wall incl. compile {time.perf_counter() - t0:.1f} s, "
         f"{rep['fps']:.2f} frames/s as run.main reports it "
         "(informational, not a benchmark)")
    assert rep["frames"] == n_frames, rep
    assert rep["tracked_ok"] == n_frames, rep
    assert rep["loop_closures"] >= 1, rep
    assert ate <= ATE_FACTOR * CPU_ATE_RMSE, (
        f"ATE {ate:.4f} m > {ATE_FACTOR} x CPU {CPU_ATE_RMSE} m")

    mem = _scan_memory(dataset)
    _log("[main] chunk scan memory_analysis: "
         + ", ".join(f"{k}={getattr(mem, k)}" for k in (
             "argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes", "generated_code_size_in_bytes")))

    rep1 = _run_cli(["--dataset", dataset,
                     "--out", os.path.join(out_dir, "traj_frame.txt"),
                     "--pipeline", "full", "--chunk", "1",
                     "--max-frames", str(PER_FRAME_FRAMES)])
    _log(f"[main] per-frame path (--chunk 1), {PER_FRAME_FRAMES} frames: "
         f"{json.dumps(rep1)}")
    assert rep1["frames"] == PER_FRAME_FRAMES, rep1
    assert rep1["tracked_ok"] == PER_FRAME_FRAMES, rep1


def _divergent_sequences(cfg, batch: int, n_frames: int):
    from modular_slam_tpu.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu.types import LUMA_WEIGHTS

    w = np.asarray(LUMA_WEIGHTS, np.float32)
    grays, depths = [], []
    for b in range(batch):
        gen = PlaneSceneGenerator(cfg.camera, seed=50 + b, depth_noise=0.01)
        sign = 1.0 if b % 2 == 0 else -1.0
        poses = gen.trajectory(n_frames, step_t=(
            sign * (0.024 + 0.006 * b), 0.016 * sign, 0.0))
        frames = list(gen.sequence(poses))
        grays.append(np.stack([f[0].astype(np.float32) @ w for f in frames]))
        depths.append(np.stack([f[1] for f in frames]))
    return np.stack(grays, axis=1), np.stack(depths, axis=1)   # [n, B, H, W]


def multi_device_phase(n_devices: int) -> None:
    """Four-GPU paths against their single-GPU equivalents."""
    import jax
    import jax.numpy as jnp

    from modular_slam_tpu.backend.ba import make_global_ba
    from modular_slam_tpu.config import SlamConfig
    from modular_slam_tpu.map.arena import MapArena
    from modular_slam_tpu.parallel import (make_kf_mesh, make_mesh,
                                           make_halo_sharded_global_ba)
    from modular_slam_tpu.parallel.dp import (make_batch_init,
                                              make_batch_slam_scan)

    devs = jax.devices()[:n_devices]
    cfg = SlamConfig()
    B, n, C = n_devices, 96, 16
    grays, depths = _divergent_sequences(cfg, B, n)
    times = np.tile((np.arange(n, dtype=np.float32) / 30.0)[:, None], (1, B))
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(0), n * B)
                      ).reshape(n, B, 2)

    def track(mesh, scan, sl):
        arenas, states = make_batch_init(cfg, mesh, batch=sl.stop - sl.start)
        qs, ts, oks = [], [], []
        for c in range(0, n, C):
            arenas, states, r = scan(
                arenas, states, jnp.asarray(grays[c:c + C, sl]),
                jnp.asarray(depths[c:c + C, sl]),
                jnp.asarray(times[c:c + C, sl]),
                jnp.asarray(keys[c:c + C, sl]))
            qs.append(np.asarray(r.pose.q))
            ts.append(np.asarray(r.pose.t))
            oks.append(np.asarray(r.tracking_ok))
        return (arenas, np.concatenate(qs), np.concatenate(ts),
                np.concatenate(oks))

    t0 = time.perf_counter()
    mesh = make_mesh(seq=B, obs=1, devices=devs)
    arenas, q4, t4, ok4 = track(mesh, make_batch_slam_scan(cfg, mesh),
                                slice(0, B))
    _log(f"[multi] batched scan, {B} sequences x {n} frames on a {B}-GPU "
         f"seq mesh: {int(ok4.sum())}/{ok4.size} tracked, "
         f"{time.perf_counter() - t0:.1f} s incl. compile")
    assert ok4.all()
    one = make_mesh(seq=1, obs=1, devices=devs[:1])
    scan_one = make_batch_slam_scan(cfg, one)
    # Each device of the seq mesh runs the batch-1 program the single-GPU
    # run compiles, so the poses agree to float noise; 1e-4 (m, and
    # quaternion units) leaves room for per-process autotuning choices.
    for b in range(B):
        _, q1, t1, ok1 = track(one, scan_one, slice(b, b + 1))
        assert ok1.all()
        np.testing.assert_allclose(t4[:, b], t1[:, 0], atol=1e-4)
        np.testing.assert_allclose(q4[:, b], q1[:, 0], atol=1e-4)
        _log(f"[multi] sequence {b} alone on one GPU: poses agree, "
             f"max |dt| {np.abs(t4[:, b] - t1[:, 0]).max():.2e} m")

    n_kf = np.asarray(arenas.n_kf)
    b = int(n_kf.argmax())
    host = [np.asarray(x[b]) for x in arenas]

    def fresh(device=None):
        return MapArena(*[jax.device_put(x, device) for x in host])

    ref_arena, ref = make_global_ba(cfg)(fresh(devs[0]))
    kf_mesh = make_kf_mesh(kf=B, obs=1, devices=devs)
    sh_arena, sh, diag = make_halo_sharded_global_ba(cfg, kf_mesh, halo=1)(
        fresh())
    _log(f"[multi] global BA on sequence {b}'s arena ({int(n_kf[b])} kf, "
         f"default capacity): single GPU cost {float(ref.initial_cost):.6e}"
         f" -> {float(ref.final_cost):.6e}; halo-sharded over {B} GPUs "
         f"{float(sh.initial_cost):.6e} -> {float(sh.final_cost):.6e}")
    # tolerances of tests/test_parallel.py's tracked-arena equivalence
    assert int(diag["n_dropped_obs"]) == 0, diag
    np.testing.assert_allclose(float(sh.initial_cost),
                               float(ref.initial_cost), rtol=1e-4)
    np.testing.assert_allclose(float(sh.final_cost),
                               float(ref.final_cost), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(sh_arena.kf_t),
                               np.asarray(ref_arena.kf_t), atol=1e-4)
    np.testing.assert_allclose(np.asarray(sh_arena.lm_pos),
                               np.asarray(ref_arena.lm_pos), atol=1e-3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="SLAM engine smoke run on GPU")
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-GPU phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from modular_slam_tpu.utils import setup_compile_cache

    setup_compile_cache()
    device = device_phase(args.devices)
    if args.devices == 1:
        with tempfile.TemporaryDirectory() as tmp:
            dataset = write_sequence(os.path.join(tmp, "seq"))
            kernel_phase(dataset)
            main_path_phase(dataset, tmp)
    else:
        multi_device_phase(args.devices)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
