"""End-to-end detector tests: descriptor invariances, real-image behavior."""

import os

import numpy as np
import cv2
import jax
import jax.numpy as jnp
import pytest

from modular_slam_tpu.config import DetectorConfig
from modular_slam_tpu.ops.detector import detect
from modular_slam_tpu.ops.brief import brief_descriptors
from modular_slam_tpu.ops.orient import ic_angle
from modular_slam_tpu.ops.brief_pattern import PATTERN
from modular_slam_tpu.io import TumRgbdDataset

RNG = np.random.default_rng(3)


def _textured_image(h=240, w=320, n_blobs=120):
    img = np.full((h, w), 128.0, np.float32)
    ys = RNG.integers(20, h - 20, n_blobs)
    xs = RNG.integers(20, w - 20, n_blobs)
    for y, x in zip(ys, xs):
        sz = int(RNG.integers(2, 6))
        val = float(RNG.uniform(0, 255))
        img[y:y + sz, x:x + sz] = val
    return cv2.GaussianBlur(img, (3, 3), 0.8)


def test_pattern_properties():
    assert PATTERN.shape == (256, 4)
    assert np.abs(PATTERN).max() <= 13
    # no degenerate pairs
    assert not np.any((PATTERN[:, 0] == PATTERN[:, 2]) &
                      (PATTERN[:, 1] == PATTERN[:, 3]))


def test_detect_on_synthetic():
    cfg = DetectorConfig(n_levels=3, max_keypoints=256)
    img = _textured_image()
    depth = np.full(img.shape, 2.0, np.float32)
    feats = jax.jit(detect, static_argnames="cfg")(
        jnp.asarray(img), jnp.asarray(depth), cfg)
    kps = feats.keypoints
    nv = int(kps.valid.sum())
    assert nv > 50
    uv = np.array(kps.uv[np.array(kps.valid)])
    h, w = img.shape
    assert (uv[:, 0] >= 0).all() and (uv[:, 0] < w).all()
    assert (uv[:, 1] >= 0).all() and (uv[:, 1] < h).all()
    # depth got sampled
    d = np.array(kps.depth[np.array(kps.valid)])
    np.testing.assert_allclose(d, 2.0)
    # valid entries come first (top_k ordering by response)
    v = np.array(kps.valid)
    assert v[:nv].all() and not v[nv:].any()


def test_descriptors_differ_between_keypoints():
    cfg = DetectorConfig(n_levels=3, max_keypoints=256)
    img = _textured_image()
    depth = np.ones(img.shape, np.float32)
    feats = detect(jnp.asarray(img), jnp.asarray(depth), cfg)
    v = np.array(feats.keypoints.valid)
    bits = np.array(feats.descriptors.packed[v])
    # pairwise: most descriptors should be distinct
    uniq = {tuple(row) for row in bits}
    assert len(uniq) > 0.8 * v.sum()


def test_descriptor_rotation_invariance():
    """Rotating the image should leave most descriptor bits unchanged
    (steered BRIEF + IC angle)."""
    img = _textured_image(240, 240)
    center = (120, 120)
    M = cv2.getRotationMatrix2D(center, 30.0, 1.0)
    rot = cv2.warpAffine(img, M, (240, 240), flags=cv2.INTER_LINEAR,
                         borderValue=128.0)

    # take a strong corner away from center, compute descriptor before/after
    from modular_slam_tpu.ops.fast import fast_score, nms3x3, border_mask
    from modular_slam_tpu.ops.blur import gaussian_blur
    s = np.array(fast_score(jnp.asarray(img))) * np.array(border_mask(240, 240, 40))
    y, x = np.unravel_index(s.argmax(), s.shape)

    # corresponding point in rotated image
    p = M @ np.array([x, y, 1.0])
    xr, yr = int(round(p[0])), int(round(p[1]))

    def desc_at(image, yy, xx):
        yx = jnp.array([[yy, xx]], dtype=jnp.int32)
        ang = ic_angle(jnp.asarray(image), yx)
        blurred = gaussian_blur(jnp.asarray(image), 7, 2.0)
        return np.array(brief_descriptors(blurred, yx, ang))[0]

    d0 = desc_at(img, y, x)
    d1 = desc_at(rot, yr, xr)
    hamming = int((d0 != d1).sum())
    assert hamming < 60, f"rotation changed {hamming}/256 bits"


def test_detect_on_reference_frames():
    """The bundled 320x240 sample frame (data/sample): 48 cells of 40 px,
    the same 8 x 6 grid the 80-px cells make on a 640x480 frame."""
    ds = TumRgbdDataset(os.path.join(os.path.dirname(__file__), "..",
                                     "data", "sample"))
    rgb, depth, _ = ds.load(0)
    assert rgb.shape == (240, 320, 3)
    gray = rgb.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)
    cfg = DetectorConfig()
    feats = detect(jnp.asarray(gray), jnp.asarray(depth), cfg)
    kps = feats.keypoints
    nv = int(kps.valid.sum())
    assert nv > 150, f"only {nv} keypoints on a sample frame"
    # spatial spread: keypoints should cover most image regions
    uv = np.array(kps.uv[np.array(kps.valid)])
    occupied = {(int(u // 40), int(v // 40)) for u, v in uv}
    assert len(occupied) > 36
    # every keypoint lands on valid depth (the sample has no holes)
    assert int((np.array(kps.depth)[np.array(kps.valid)] > 0).sum()) == nv
    # levels populated beyond level 0
    lv = np.array(kps.level[np.array(kps.valid)])
    assert (lv > 0).sum() > 10


def test_moment_maps_match_patch_oracle():
    """moment_maps (prefix-sum strips) == patch-based circular moments at
    interior pixels (>= border away from every edge)."""
    from modular_slam_tpu.ops.orient import IC_RADIUS, _mask_np, moment_maps

    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    mm = np.array(moment_maps(jnp.asarray(img)))

    mask = _mask_np(IC_RADIUS)
    coords = np.arange(-IC_RADIUS, IC_RADIUS + 1, dtype=np.float32)
    for (y, x) in [(20, 20), (48, 64), (70, 100), (19, 108)]:
        patch = img[y - IC_RADIUS:y + IC_RADIUS + 1,
                    x - IC_RADIUS:x + IC_RADIUS + 1] * mask
        m10 = float((patch * coords[None, :]).sum())
        m01 = float((patch * coords[:, None]).sum())
        np.testing.assert_allclose(mm[0, y, x], m10, rtol=2e-4)
        np.testing.assert_allclose(mm[1, y, x], m01, rtol=2e-4)


def test_brief_matmul_matches_gather_oracle():
    """brief_matmul (int8 matmul sampling, 32 angle bins) is bit-exact
    against the gather formulation on the ROUNDED atlas at bin-center
    angles, and close to the continuous-rotation bits elsewhere."""
    from modular_slam_tpu.ops.brief import (N_ANGLE_BINS, brief_from_atlas,
                                            brief_matmul)

    rng = np.random.default_rng(7)
    # smooth synthetic atlas (blurred-image statistics, like the real one)
    base = rng.uniform(0, 255, (3, 40, 52))
    import scipy.ndimage as ndi
    atlas = np.stack([ndi.zoom(b, 3.0, order=1) for b in base])  # [3,120,156]
    atlas = jnp.asarray(atlas[:, :120, :156].astype(np.float32))
    N = 96
    yx = jnp.asarray(np.stack([rng.integers(20, 100, N),
                               rng.integers(20, 136, N)], -1).astype(np.int32))
    lvl = jnp.asarray(rng.integers(0, 3, N).astype(np.int32))

    # bin centers -> bit exact vs gather on the rounded atlas
    b = rng.integers(0, N_ANGLE_BINS, N)
    ang = jnp.asarray((2 * np.pi * b / N_ANGLE_BINS).astype(np.float32))
    atlas_q = jnp.round(atlas)
    bits_g = np.asarray(brief_from_atlas(atlas_q, lvl, yx, ang))
    bits_m = np.asarray(brief_matmul(atlas, lvl, yx, ang))
    assert (bits_g == bits_m).all(), int((bits_g != bits_m).sum())

    # arbitrary angles: binned steering stays close to continuous
    # rotation on smooth images (canonical ORB uses a 2*pi/30 table)
    ang2 = jnp.asarray(rng.uniform(-np.pi, np.pi, N).astype(np.float32))
    bg = np.asarray(brief_from_atlas(atlas_q, lvl, yx, ang2))
    bm = np.asarray(brief_matmul(atlas, lvl, yx, ang2))
    ham = (bg != bm).sum(1)
    assert ham.mean() < 40, ham.mean()
