"""Headless CLI runner — the reference's RgbdSlam app
(/root/reference/src/app/slam/rgbd_slam.cpp) rebuilt: run SLAM over a
TUM-format dataset, stream the trajectory to disk, report stats.

    python -m modular_slam_tpu.run --dataset /path/to/tum_seq \
        --out traj.txt [--format tum|kitti] [--max-frames N] [--no-ba] \
        [--ate]  # score against dataset groundtruth.txt if present

Unlike the reference CLI (which loops forever ignoring NoDataAvailable,
rgbd_slam.cpp:87-91 — bug #13), this exits when the dataset ends.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time as _time

import numpy as np


def apply_overrides(cfg, overrides):
    """Apply `section.field=value` strings to a SlamConfig, casting each
    value to the dataclass field's declared type."""
    for ov in overrides:
        try:
            dotted, value = ov.split("=", 1)
            section, field = dotted.split(".", 1)
        except ValueError:
            raise SystemExit(f"--set expects section.field=value, got {ov!r}")
        sub = getattr(cfg, section, None)
        if sub is None or not dataclasses.is_dataclass(sub):
            raise SystemExit(f"unknown config section {section!r}")
        ftypes = {f.name: f.type for f in dataclasses.fields(sub)}
        if field not in ftypes:
            raise SystemExit(f"unknown field {dotted!r}")
        current = getattr(sub, field)
        if isinstance(current, bool):
            cast = value.lower() in ("1", "true", "yes", "on")
        else:
            cast = type(current)(value)
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(sub, **{field: cast})})
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="RGB-D SLAM runner")
    ap.add_argument("--dataset", required=True, help="TUM-format sequence dir")
    ap.add_argument("--out", default=None, help="trajectory output path")
    ap.add_argument("--format", choices=["tum", "kitti"], default="tum")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--pipeline", choices=["odometry", "slam", "full"],
                    default="slam")
    ap.add_argument("--no-ba", action="store_true",
                    help="disable backend BA (same as --pipeline odometry)")
    ap.add_argument("--ate", action="store_true",
                    help="report ATE vs groundtruth.txt")
    ap.add_argument("--ply", default=None, help="export final map as PLY")
    ap.add_argument("--save-checkpoint", default=None)
    ap.add_argument("--load-checkpoint", default=None)
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the native decode-ahead loader")
    ap.add_argument("--ba-mode", choices=["sync", "async"], default="sync",
                    help="local-BA executor mode; 'async' offloads the "
                         "solve to the host CPU while the device tracks")
    ap.add_argument("--chunk", type=int, default=16,
                    help="frames per device dispatch (default 16: the "
                         "chunked-scan path, one host sync per chunk "
                         "instead of one per frame). SEMANTICS: with "
                         "chunking, keyframe BA, loop closures, and "
                         "relocalization land at chunk boundaries "
                         "rather than mid-chunk. Use --chunk 1 for "
                         "strict per-frame behavior; a final partial "
                         "chunk (or a dataset shorter than one chunk) "
                         "automatically falls back to per-frame "
                         "processing)")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--detector", default="orb_grid",
                    help="registry detector name")
    ap.add_argument("--matcher", default="hamming_2nn",
                    help="registry matcher name")
    ap.add_argument("--pnp", default="ransac_3p", help="registry pnp name")
    ap.add_argument("--set", action="append", default=[], metavar="S.F=V",
                    help="config override, e.g. --set loop.min_score=0.05 "
                         "(repeatable; casts to the field's declared type)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from modular_slam_tpu.config import SlamConfig
    from modular_slam_tpu.engine import SlamSystem, SlamResult
    from modular_slam_tpu.models import make_pipeline
    from modular_slam_tpu.io import (
        TumRgbdDataset, TumTrajectoryWriter, KittiTrajectoryWriter,
    )
    from modular_slam_tpu.utils import setup_compile_cache

    setup_compile_cache()
    ds = TumRgbdDataset(args.dataset)
    print(f"dataset: {len(ds)} frames", file=sys.stderr)

    pipeline = "odometry" if args.no_ba else args.pipeline
    cfg = SlamConfig().replace(camera=ds.camera)
    cfg = apply_overrides(cfg, args.set)
    system = make_pipeline(
        pipeline, cfg, seed=args.seed,
        component_names={"detector": args.detector, "matcher": args.matcher,
                         "pnp": args.pnp},
        # chunked runs get the deferred-pipelined host sync (host
        # bookkeeping of chunk N overlaps chunk N+1 on device) — the
        # benchmark's throughput configuration
        ba_mode=args.ba_mode,
        defer_chunk_sync=args.chunk > 1)
    if args.load_checkpoint:
        from modular_slam_tpu.utils.checkpoint import load_checkpoint

        load_checkpoint(args.load_checkpoint, system)
        print(f"resumed from {args.load_checkpoint}", file=sys.stderr)

    writer = None
    if args.out:
        cls = TumTrajectoryWriter if args.format == "tum" else KittiTrajectoryWriter
        writer = cls(args.out)

    # chunked mode streams the minimum-byte WIRE format (uint8 luma +
    # raw uint16 depth — io/tum.py wire_iter), 2.3x smaller than rgb +
    # f32 depth.  Per-frame mode (--chunk 1) keeps the full rgb frames
    # (the per-frame step takes rgb).
    use_wire = args.chunk > 1
    if use_wire:
        frames_iter = ds.wire_iter(native_ok=not args.no_prefetch)
    else:
        frames_iter = iter(ds) if args.no_prefetch else ds.prefetch_iter()
    buf = []
    written = 0

    def _drain_writer():
        # stream every trajectory row not yet written — correct in
        # deferred-pipelined mode too, where a chunk's results only
        # become available one chunk later
        nonlocal written
        if writer is None:
            return
        while written < len(system.trajectory):
            t, p = system.trajectory[written]
            writer.write(t, p)
            written += 1

    def _flush():
        if len(buf) == args.chunk:
            if use_wire:
                system.process_chunk_wire(*zip(*buf))
            else:
                system.process_chunk(*zip(*buf))
        else:
            for r, d, t in buf:
                if use_wire:
                    # partial tail in wire format: luma replicated to 3
                    # channels is luma-invariant; raw depth -> meters
                    rgb3 = np.repeat(r[..., None], 3, axis=-1)
                    system.process(
                        rgb3, d.astype(np.float32) * ds.camera.depth_factor,
                        t)
                else:
                    system.process(r, d, t)
        _drain_writer()
        buf.clear()

    t0 = _time.perf_counter()
    for i, (rgb, depth, ts) in enumerate(frames_iter):
        if args.max_frames is not None and i >= args.max_frames:
            break
        if args.chunk <= 1:
            system.process(rgb, depth, ts)
            _drain_writer()
        else:
            buf.append((rgb, depth, ts))
            if len(buf) == args.chunk:
                _flush()
        if (i + 1) % 50 == 0:
            st = system.stats()
            print(f"[{i+1}] kf={st['keyframes']} lm={st['landmarks']} "
                  f"inl={st['last_n_inliers']}", file=sys.stderr)
    if buf:
        _flush()
    system.flush_backend()   # deliver the deferred tail chunk
    _drain_writer()
    elapsed = _time.perf_counter() - t0
    n_ok = sum(1 for r in system.results if bool(r.tracking_ok))
    if writer is not None:
        writer.close()

    n = len(system.trajectory)
    stats = system.stats()
    report = {
        "frames": n,
        "tracked_ok": n_ok,
        "keyframes": stats["keyframes"],
        "landmarks": stats["landmarks"],
        "loop_closures": system.n_loop_closures,
        "relocalizations": system.n_relocalizations,
        "fps": n / elapsed if elapsed > 0 else 0.0,
        "wall_s": elapsed,
    }

    if args.ply:
        from modular_slam_tpu.eval.ply import export_map_ply

        report["ply_points"] = export_map_ply(args.ply, system.arena)
    if args.save_checkpoint:
        from modular_slam_tpu.utils.checkpoint import save_checkpoint

        save_checkpoint(args.save_checkpoint, system)

    if args.ate and ds.groundtruth is not None and args.out \
            and args.format == "tum":
        from modular_slam_tpu.eval.ate import ate_rmse
        from modular_slam_tpu.io import read_tum_trajectory

        est = read_tum_trajectory(args.out)
        try:
            report["ate"] = ate_rmse(est, ds.groundtruth)
        except ValueError as e:
            report["ate_error"] = str(e)

    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
