"""Detect-path substage scan probes (VERDICT r3 next #4).

Splits stage_ms.detect_in_step into pyramid / FAST / NMS+cell-topk /
blur / moments / BRIEF-gather / select, each timed INSIDE a lax.scan
over different per-frame inputs (the scan-probe method of bench.py),
plus a bytes-moved lower bound for the whole detect pass.

Usage: python tools/detect_bench.py  (runs on the default backend)
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def timed(run, args, per):
    out = run(*args)
    jax.block_until_ready(out)
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        best = min(best, time.perf_counter() - t0)
    return best / per * 1e3


def main() -> int:
    from modular_slam_tpu.utils import setup_compile_cache

    setup_compile_cache()
    import bench
    from modular_slam_tpu.config import SlamConfig
    from modular_slam_tpu.ops.blur import gaussian_blur
    from modular_slam_tpu.ops.brief import brief_from_atlas
    from modular_slam_tpu.ops.detector import (_cell_candidates,
                                               _cell_threshold_fallback,
                                               _pad_to, detect)
    from modular_slam_tpu.ops.fast import border_mask, nms3x3
    from modular_slam_tpu.ops.fast_pallas import fast_score_fastest
    from modular_slam_tpu.ops.orient import moment_maps
    from modular_slam_tpu.ops.pyramid import build_pyramid, pyramid_shapes

    cfg_all, frames, _ = bench._sequence("plane")
    cfg = cfg_all.detector
    n0 = 32
    grays0, depths0, _ = bench._stage_frames(frames[3:3 + n0])
    n = 2 * n0
    grays = jnp.concatenate([grays0, grays0])
    depths = jnp.concatenate([depths0, depths0])
    H0, W0 = grays.shape[1:]
    print(f"device: {jax.devices()[0]}", file=sys.stderr)

    def probe(body_fn, consume, extra=()):
        @jax.jit
        def run(gs, *xs):
            def body(c, x):
                out = body_fn(x[0], *x[1:])
                return c + consume(out), 0
            return lax.scan(body, jnp.float32(0), (gs, *xs))[0]
        return timed(run, (grays, *extra), n)

    res = {}

    # pyramid only
    res["pyramid_ms"] = probe(
        lambda g: build_pyramid(g, cfg),
        lambda levels: sum(jnp.sum(l) for l in levels))

    # pyramid + FAST scores
    def fast_all(g):
        return [fast_score_fastest(img) for img in build_pyramid(g, cfg)]
    res["pyr_fast_ms"] = probe(
        fast_all, lambda ss: sum(jnp.sum(s) for s in ss))

    # pyramid + FAST + NMS/threshold/cell-fallback + per-cell top-k
    thr_low, thr_high = float(cfg.fast_threshold_low), float(cfg.fast_threshold)

    def cand_all(g):
        outs = []
        for img in build_pyramid(g, cfg):
            h, w = img.shape
            s = fast_score_fastest(img)
            s = nms3x3(s) * border_mask(h, w, cfg.border, img.dtype)
            s = jnp.where(s > thr_low, s, 0.0)
            s = _cell_threshold_fallback(s, cfg.cell_size, thr_high)
            outs.append(_cell_candidates(s, cfg.cell_size, cfg.max_per_cell))
        return outs
    res["pyr_fast_cand_ms"] = probe(
        cand_all,
        lambda outs: sum(jnp.sum(yx) + jnp.sum(r) for yx, r in outs))

    # pyramid + blur atlas (padded)
    def blur_all(g):
        return [_pad_to(gaussian_blur(img, cfg.blur_ksize, cfg.blur_sigma),
                        H0, W0)
                for img in build_pyramid(g, cfg)]
    res["pyr_blur_ms"] = probe(
        blur_all, lambda ss: sum(jnp.sum(s) for s in ss))

    # pyramid + moment atlas (padded)
    def mom_all(g):
        out = []
        for img in build_pyramid(g, cfg):
            mm = moment_maps(img)
            out.append(jnp.pad(mm, ((0, 0), (0, H0 - mm.shape[1]),
                                    (0, W0 - mm.shape[2]))))
        return out
    res["pyr_moments_ms"] = probe(
        mom_all, lambda ss: sum(jnp.sum(s) for s in ss))

    # ---- cut-point bisection of the select/descriptor tail ---------------
    from modular_slam_tpu.ops.detector import detect_until

    for cut in ("select", "atlas", "orient", "brief", "full"):
        res[f"cut_{cut}_ms"] = probe(
            lambda g, d, cut=cut: detect_until(g, d, cfg, cut),
            lambda outs: sum(jnp.sum(o.astype(jnp.float32)) for o in outs),
            extra=(depths,))

    # full detect
    def det(g, d):
        f = detect(g, d, cfg)
        return f
    res["detect_ms"] = probe(
        det,
        lambda f: (jnp.sum(f.keypoints.uv) + jnp.sum(f.keypoints.angle)
                   + jnp.sum(f.descriptors.unpacked.astype(jnp.float32))
                   + jnp.sum(f.keypoints.depth)),
        extra=(depths,))

    # derived splits
    res["fast_only_ms"] = round(res["pyr_fast_ms"] - res["pyramid_ms"], 3)
    res["cand_only_ms"] = round(
        res["pyr_fast_cand_ms"] - res["pyr_fast_ms"], 3)
    res["blur_only_ms"] = round(res["pyr_blur_ms"] - res["pyramid_ms"], 3)
    res["moments_only_ms"] = round(
        res["pyr_moments_ms"] - res["pyramid_ms"], 3)
    # cut_full is the canonical whole-detect number (same computation as
    # detect(), consumed output-by-output)
    res["brief_only_ms"] = round(res["cut_brief_ms"] - res["cut_orient_ms"], 3)
    res["atlas_only_ms"] = round(res["cut_atlas_ms"] - res["cut_select_ms"], 3)

    # bytes-moved lower bound (read image once per consumer pass; write
    # each product once), fp32:
    shapes = pyramid_shapes(H0, W0, cfg)
    lvl_px = sum(h * w for h, w in shapes)
    atlas_px = cfg.n_levels * H0 * W0
    lb = {
        "pyramid_write_MB": lvl_px * 4 / 1e6,
        "score_write_MB": lvl_px * 4 / 1e6,
        "blur_atlas_write_MB": atlas_px * 4 / 1e6,
        "moment_atlas_write_MB": 2 * atlas_px * 4 / 1e6,
        "level_px_total": lvl_px,
        "padded_atlas_px": atlas_px,
        "pad_waste_ratio": atlas_px / lvl_px,
    }
    res = {k: round(v, 3) if isinstance(v, float) else v
           for k, v in res.items()}
    print(json.dumps({"substage_ms": res, "bytes_lower_bound": lb}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
