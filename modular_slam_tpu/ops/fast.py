"""FAST-9/16 corner scoring as dense tensor ops.

Replaces the reference's per-cell cv::FAST calls
(distributed_cv_feature.cpp:918-925).  Instead of boolean corners at a
fixed threshold, we compute the *score map*: for each pixel, the maximum
threshold t for which it is still a FAST-9 corner (the standard OpenCV
corner score).  A pixel is a corner at threshold t iff score > t, so one
score map serves both the high (20) and fallback (7) thresholds — the
reference's per-cell retry (threshold 20 falling back to 7) becomes
"per-cell max of the score map, floored at 7", with high-threshold corners
winning automatically.

Pure jnp formulation — the plain reference and the CPU path; on the GPU
ops/fast_pallas.py computes the same scores (docs/architecture.md, "The
plain-vs-kernel record"):
  d[k]   = I(p + circle[k]) - I(p)                  (16 rolled images)
  m9[k]  = min(d[k], ..., d[k+8])  circular          (16 planes)
  bright = max_k m9[k]       # corner for all t < bright
  dark   = max_k min9(-d)[k]
  score  = max(bright, dark)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray

# Bresenham circle of radius 3, 16 pixels, circular order (dy, dx)
FAST_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _ring(img: Array) -> Array:
    """[16, H, W] of circle-neighbor values via rolls (edges wrap; callers
    mask a border >= 3 so wrap artifacts never survive)."""
    return jnp.stack(
        [jnp.roll(img, (-dy, -dx), axis=(0, 1)) for dy, dx in FAST_CIRCLE]
    )


def fast_score(img: Array) -> Array:
    """FAST-9/16 corner score map [H, W] (0 where not a corner at any t>0).

    score > t  <=>  pixel is a FAST-9 corner with strict threshold t.
    """
    d = _ring(img) - img[None, :, :]

    def min9(x: Array) -> Array:
        m = x
        for s in range(1, 9):
            m = jnp.minimum(m, jnp.roll(x, -s, axis=0))
        return m

    bright = jnp.max(min9(d), axis=0)
    dark = jnp.max(min9(-d), axis=0)
    return jnp.maximum(jnp.maximum(bright, dark), 0.0)


def nms3x3(score: Array) -> Array:
    """3x3 non-maximum suppression: keep score where it is the strict
    neighborhood max (ties broken toward the top-left by epsilon bias)."""
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= neigh, score, 0.0)


def border_mask(h: int, w: int, border: int, dtype=jnp.float32) -> Array:
    """[H, W] 1.0 inside the border margin, 0.0 outside."""
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = (
        (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    )
    return inside.astype(dtype)
