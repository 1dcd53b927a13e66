"""ORB-style feature detection over an image pyramid — the frontend's hot
path, fully jittable with static shapes.

Reference pipeline (distributed_cv_feature.cpp, OrbExtractorPimpl::extract
:719-809): pyramid -> per-cell FAST (threshold 20 falling back to 7)
-> quadtree spatial distribution keeping the max-response keypoint per
leaf -> IC orientation -> per-level Gaussian blur -> rotated BRIEF-256
-> scale correction to level-0 coords.

Static-shape redesign (same goals; SURVEY.md §7 step 3):
- one FAST *score map* per level serves both thresholds (ops/fast.py,
  ops/fast_pallas.py on the GPU);
- the quadtree becomes a fixed grid: per `cell_size` cell keep the top
  `max_per_cell` NMS survivors — the quadtree's ~1-keypoint-per-1000px²
  uniform density with a static candidate count;
- global response top-k selects `max_keypoints` BEFORE any descriptor
  work, so orientation/description cost scales with the keypoint budget,
  not the candidate count;
- orientation, blur and BRIEF run in the patch domain: one raw patch per
  selected keypoint is extracted from a padded pyramid atlas;
- depth is sampled at level-0 coords from the depth map.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

from modular_slam_tpu.config import DetectorConfig
from modular_slam_tpu.ops.blur import blur_patches
from modular_slam_tpu.ops.brief import (BRIEF_PATCH, brief_matmul_from_patches,
                                        extract_patches_matmul)
from modular_slam_tpu.ops.fast import nms3x3, border_mask
from modular_slam_tpu.ops.fast_pallas import fast_score_fastest
from modular_slam_tpu.ops.orient import ic_angle_from_patches
from modular_slam_tpu.ops.pyramid import build_pyramid
from modular_slam_tpu.types import (
    Descriptors,
    Features,
    Keypoints,
    bits_to_pm1,
    pack_bits,
)

Array = jnp.ndarray


def _cell_candidates(
    score: Array, cell: int, top_per_cell: int
) -> Tuple[Array, Array]:
    """Per-cell top-k of a score map.

    Returns (yx [C, 2] int32, resp [C]) with C = n_cells * top_per_cell.
    Remainder rows/cols beyond the last full cell are ignored (they lie
    inside the detector border for any sane cell size).
    """
    h, w = score.shape
    ncy, ncx = h // cell, w // cell
    s = score[: ncy * cell, : ncx * cell]
    s = s.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3)
    s = s.reshape(ncy * ncx, cell * cell)
    resp, idx = jax.lax.top_k(s, top_per_cell)  # [n_cells, k]

    cell_ids = jnp.arange(ncy * ncx, dtype=jnp.int32)
    cy = (cell_ids // ncx)[:, None] * cell
    cx = (cell_ids % ncx)[:, None] * cell
    y = cy + (idx // cell)
    x = cx + (idx % cell)
    yx = jnp.stack([y.reshape(-1), x.reshape(-1)], axis=-1).astype(jnp.int32)
    return yx, resp.reshape(-1)


def _cell_threshold_fallback(score: Array, cell: int, thr_high: float) -> Array:
    """Reference FAST threshold semantics per cell: detect at the high
    threshold (20); only cells with no high-threshold corner fall back to
    the low one (distributed_cv_feature.cpp:918-925).  On the score map
    this is: if a cell's max score exceeds thr_high, zero that cell's
    sub-threshold scores."""
    h, w = score.shape
    ncy, ncx = h // cell, w // cell
    s = score[: ncy * cell, : ncx * cell]
    blocks = s.reshape(ncy, cell, ncx, cell)
    cell_max = blocks.max(axis=(1, 3), keepdims=True)
    keep = (cell_max <= thr_high) | (blocks > thr_high)
    out = jnp.where(keep, blocks, 0.0).reshape(ncy * cell, ncx * cell)
    return score.at[: ncy * cell, : ncx * cell].set(out)


def _pad_to(img: Array, h: int, w: int) -> Array:
    return jnp.pad(img, ((0, h - img.shape[0]), (0, w - img.shape[1])))


def _detect_impl(gray: Array, depth: Array, cfg: DetectorConfig, cut: str):
    """Shared detect body with bench cut points ('select' | 'atlas' |
    'orient' | 'brief' | 'full')."""
    H0, W0 = gray.shape
    levels = build_pyramid(gray, cfg)
    thr_low = float(cfg.fast_threshold_low)

    yx_all: List[Array] = []
    resp_all: List[Array] = []
    lvl_all: List[Array] = []

    thr_high = float(cfg.fast_threshold)
    for lvl, img in enumerate(levels):
        h, w = img.shape
        score = fast_score_fastest(img)
        score = nms3x3(score) * border_mask(h, w, cfg.border, img.dtype)
        score = jnp.where(score > thr_low, score, 0.0)
        score = _cell_threshold_fallback(score, cfg.cell_size, thr_high)

        yx, resp = _cell_candidates(score, cfg.cell_size, cfg.max_per_cell)
        yx_all.append(yx)
        resp_all.append(resp)
        lvl_all.append(jnp.full(resp.shape, lvl, dtype=jnp.int32))

    yx_c = jnp.concatenate(yx_all)
    resp = jnp.concatenate(resp_all)
    lvls = jnp.concatenate(lvl_all)

    k = cfg.max_keypoints
    n_cand = resp.shape[0]
    if n_cand < k:  # small images: pad candidate pool up to capacity
        pad = k - n_cand
        yx_c = jnp.concatenate([yx_c, jnp.zeros((pad, 2), yx_c.dtype)])
        resp = jnp.concatenate([resp, jnp.zeros((pad,), resp.dtype)])
        lvls = jnp.concatenate([lvls, jnp.zeros((pad,), lvls.dtype)])

    # --- select the keypoint budget BEFORE descriptor work ---------------
    sel_resp, sel = jax.lax.top_k(resp, k)
    valid = sel_resp > 0.0
    yx_sel = yx_c[sel]             # level coords
    lvl_sel = lvls[sel]
    if cut == "select":
        return yx_sel, lvl_sel, sel_resp

    # --- patch-centric post-score path (round 5) --------------------------
    # The dense per-level blur + moment-map pyramids computed ~1M pixels
    # of products per frame to read 512 keypoints' worth (roofline note,
    # docs/architecture.md): instead extract ONE raw patch per keypoint
    # (BRIEF 37 + blur halo 2*3 = 43 wide) and compute orientation,
    # blur, and descriptors in the patch domain — all small dense ops.
    # Each level is reflect-padded by the blur radius first, so border
    # keypoints see the same reflect-101 halo the dense blur used.
    br = cfg.blur_ksize // 2
    atlas_raw = jnp.stack([
        _pad_to(jnp.pad(img, br, mode="reflect"), H0 + 2 * br, W0 + 2 * br)
        for img in levels])                        # [nlev, H0+6, W0+6]
    if cut == "atlas":
        return yx_sel, lvl_sel, sel_resp, atlas_raw

    P = BRIEF_PATCH + 2 * br                       # 43
    patches = extract_patches_matmul(
        atlas_raw, lvl_sel, yx_sel + br, patch=P)  # [N, P*P]
    p2d = patches.reshape(-1, P, P)

    # --- orientation: circular moments of the UNBLURRED central 31x31 ----
    angles = ic_angle_from_patches(p2d)
    if cut == "orient":
        return yx_sel, lvl_sel, sel_resp, angles

    # --- blur in the patch domain + binned int8 matmul BRIEF sampling -----
    bp = blur_patches(p2d, cfg.blur_ksize, cfg.blur_sigma)  # [N, 37, 37]
    bits = brief_matmul_from_patches(
        bp.reshape(bp.shape[0], -1), angles)
    if cut == "brief":
        return yx_sel, lvl_sel, sel_resp, angles, bits

    # --- level-0 coords + depth -------------------------------------------
    scales = jnp.asarray(
        [cfg.scale_factor ** i for i in range(cfg.n_levels)], jnp.float32)
    uv = yx_sel[:, ::-1].astype(jnp.float32) * scales[lvl_sel][:, None]
    ix = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, W0 - 1)
    iy = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, H0 - 1)
    d = jnp.take(depth.reshape(-1), iy * W0 + ix)

    kps = Keypoints(
        uv=uv,
        response=jnp.where(valid, sel_resp, 0.0),
        angle=angles,
        level=jnp.where(valid, lvl_sel, -1),
        depth=jnp.where(valid, d, 0.0),
        valid=valid,
    )
    packed = pack_bits(bits)
    desc = Descriptors(packed=packed, unpacked=bits_to_pm1(bits))
    return Features(keypoints=kps, descriptors=desc)


def detect_until(gray: Array, depth: Array, cfg: DetectorConfig, cut: str):
    """Bench-only: run detect up to `cut`, returning raw arrays."""
    out = _detect_impl(gray, depth, cfg, cut)
    if cut == "full":
        f = out
        return (f.keypoints.uv, f.keypoints.angle, f.keypoints.depth,
                f.descriptors.unpacked)
    return tuple(jnp.asarray(o) for o in out)


def detect(
    gray: Array, depth: Array, cfg: DetectorConfig
) -> Features:
    """Detect up to cfg.max_keypoints ORB features.

    gray:  [H, W] float32 luma
    depth: [H, W] float32 meters (0 invalid) — sampled per keypoint
    """
    return _detect_impl(gray, depth, cfg, "full")


