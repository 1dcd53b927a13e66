"""Rotated BRIEF-256 descriptor extraction.

Reference: steered BRIEF over a blurred level image with a 256-pair
pattern (distributed_cv_feature.cpp:572-630): each bit is
I(p + R(theta) a_i) < I(p + R(theta) b_i) with rotated, rounded offsets.
We use our own deterministic pattern (ops/brief_pattern.py).

Two formulations:
- `brief_from_atlas` — flat random gather of all 512 sample points per
  keypoint from the padded pyramid atlas: a 512x512-element random
  gather.
- `brief_matmul` — the path used by the detector: quantize
  the angle to 32 bins (the original ORB paper steers BRIEF with a
  2*pi/30 lookup table — rotation binning is the CANONICAL design, not
  an approximation of it), extract each keypoint's 37x37 patch with one
  contiguous ROW gather + a one-hot column matmul, then sample all 512
  rotated endpoints with a grouped (ragged) matmul against per-bin
  one-hot selector matrices — all the random access becomes matmul work.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from modular_slam_tpu.ops.brief_pattern import PATTERN
from modular_slam_tpu.ops.orient import gather_patches

Array = jnp.ndarray

# rotated endpoint radius <= 13*sqrt(2) ~= 18.39 -> 37x37 patch
BRIEF_PATCH = 37
_R = BRIEF_PATCH // 2  # 18
N_ANGLE_BINS = 32  # finer than the ORB paper's 30 (2*pi/30 lookup table)


def brief_descriptors(blurred: Array, yx: Array, angles: Array) -> Array:
    """Compute [N, 256] descriptor bits (uint8 0/1).

    blurred: [H, W] blurred level image
    yx:      [N, 2] int32 keypoint centers (y, x) in level coords
    angles:  [N] float32 IC angles (radians)
    """
    pat = jnp.asarray(PATTERN, dtype=jnp.float32)  # [256, 4] x1 y1 x2 y2
    cos = jnp.cos(angles)[:, None]
    sin = jnp.sin(angles)[:, None]

    x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
    # rotate offsets: x' = cos*x - sin*y ; y' = sin*x + cos*y (per keypoint)
    rx1 = jnp.round(cos * x1 - sin * y1).astype(jnp.int32)
    ry1 = jnp.round(sin * x1 + cos * y1).astype(jnp.int32)
    rx2 = jnp.round(cos * x2 - sin * y2).astype(jnp.int32)
    ry2 = jnp.round(sin * x2 + cos * y2).astype(jnp.int32)

    patches = gather_patches(blurred, yx, BRIEF_PATCH)  # [N, 37, 37]
    flat = patches.reshape(patches.shape[0], -1)        # [N, 1369]

    idx1 = (ry1 + _R) * BRIEF_PATCH + (rx1 + _R)        # [N, 256]
    idx2 = (ry2 + _R) * BRIEF_PATCH + (rx2 + _R)
    v1 = jnp.take_along_axis(flat, idx1, axis=1)
    v2 = jnp.take_along_axis(flat, idx2, axis=1)
    return (v1 < v2).astype(jnp.uint8)


def rotated_offsets(angles: Array):
    """Rotate the pattern for each angle.  -> (ry1, rx1, ry2, rx2), each
    [N, 256] int32."""
    pat = jnp.asarray(PATTERN, dtype=jnp.float32)
    cos = jnp.cos(angles)[:, None]
    sin = jnp.sin(angles)[:, None]
    x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
    rx1 = jnp.round(cos * x1 - sin * y1).astype(jnp.int32)
    ry1 = jnp.round(sin * x1 + cos * y1).astype(jnp.int32)
    rx2 = jnp.round(cos * x2 - sin * y2).astype(jnp.int32)
    ry2 = jnp.round(sin * x2 + cos * y2).astype(jnp.int32)
    return ry1, rx1, ry2, rx2


def brief_from_atlas(
    blur_atlas: Array,   # [n_levels, H, W] padded blurred pyramid
    level: Array,        # [N] int32
    yx: Array,           # [N, 2] int32 level coords
    angles: Array,       # [N]
) -> Array:
    """Descriptor bits via ONE flat gather from the padded pyramid atlas —
    no per-keypoint patch materialization (the gather-bound path that
    dominated the first detector implementation)."""
    nlev, H, W = blur_atlas.shape
    ry1, rx1, ry2, rx2 = rotated_offsets(angles)
    base = level.astype(jnp.int32) * (H * W)
    y = yx[:, 0:1]
    x = yx[:, 1:2]
    idx1 = base[:, None] + (y + ry1) * W + (x + rx1)
    idx2 = base[:, None] + (y + ry2) * W + (x + rx2)
    flat = blur_atlas.reshape(-1)
    v1 = jnp.take(flat, idx1)
    v2 = jnp.take(flat, idx2)
    return (v1 < v2).astype(jnp.uint8)


@lru_cache(maxsize=None)
def _bin_selector_np(n_bins: int) -> np.ndarray:
    """[n_bins, patch^2, 512] one-hot fp32 selectors: for angle bin b,
    column s selects sample endpoint s of the rotated pattern (s < 256:
    first endpoint of bit s; s >= 256: second endpoint of bit s-256)."""
    pat = np.asarray(PATTERN, np.float64)        # [256, 4] x1 y1 x2 y2
    S = np.zeros((n_bins, BRIEF_PATCH * BRIEF_PATCH, 512), np.float32)
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        c, s_ = np.cos(th), np.sin(th)
        x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
        rx1 = np.round(c * x1 - s_ * y1).astype(int)
        ry1 = np.round(s_ * x1 + c * y1).astype(int)
        rx2 = np.round(c * x2 - s_ * y2).astype(int)
        ry2 = np.round(s_ * x2 + c * y2).astype(int)
        i = np.arange(256)
        S[b, (ry1 + _R) * BRIEF_PATCH + (rx1 + _R), i] = 1.0
        S[b, (ry2 + _R) * BRIEF_PATCH + (rx2 + _R), i + 256] = 1.0
    return S


def extract_patches_matmul(
    blur_atlas: Array,   # [n_levels, H, W] padded pyramid atlas
    level: Array,        # [N] int32
    yx: Array,           # [N, 2] int32 level coords (atlas frame)
    patch: int = BRIEF_PATCH,
) -> Array:
    """[N, patch^2] flattened patches, via ONE contiguous row gather
    (take along the row axis — DMA-efficient, unlike element gathers) +
    a one-hot column-window matmul.  Exact: the one-hot
    contraction runs at Precision.HIGHEST, so every output is a
    bit-exact copy of the source pixel."""
    nlev, H, W = blur_atlas.shape
    N = yx.shape[0]
    r = patch // 2
    A2 = blur_atlas.reshape(nlev * H, W)
    d = jnp.arange(-r, r + 1)
    rows_idx = (level * H + yx[:, 0])[:, None] + d[None, :]       # [N, p]
    rows = jnp.take(A2, rows_idx.reshape(-1), axis=0)
    rows = rows.reshape(N, patch, W)
    cols = yx[:, 1][:, None] + d[None, :]                          # [N, p]
    Csel = (jnp.arange(W)[None, :, None] == cols[:, None, :])
    patches = jnp.einsum(
        "krw,kwc->krc", rows, Csel.astype(rows.dtype),
        precision=jax.lax.Precision.HIGHEST)
    return patches.reshape(N, patch * patch)


@lru_cache(maxsize=None)
def _bin_selector_i8_flat(n_bins: int) -> np.ndarray:
    """[patch^2, n_bins*512] int8 one-hot — the flat-GEMM layout."""
    S = _bin_selector_np(n_bins)                 # [B, P2, 512]
    return np.ascontiguousarray(
        S.transpose(1, 0, 2).reshape(S.shape[1], -1)).astype(np.int8)


def brief_matmul(
    blur_atlas: Array,   # [n_levels, H, W] padded blurred pyramid
    level: Array,        # [N] int32
    yx: Array,           # [N, 2] int32 level coords
    angles: Array,       # [N] float32 radians
    n_bins: int = N_ANGLE_BINS,
) -> Array:
    """Descriptor bits [N, 256] uint8 via matmul sampling (see module
    docstring).

    The patch is rounded to 8-bit intensities first — the reference
    BRIEF compares uint8 blurred pixels (cv::GaussianBlur on CV_8U,
    distributed_cv_feature.cpp:797-801), so integer comparisons ARE the
    reference semantics — then shifted to int8 (comparisons are
    shift-invariant) so the one-hot sampling runs as ONE int8 GEMM
    against all bins' selectors: exact (int8 x one-hot -> int32) and at
    double bf16 throughput.  The angle-binned result is picked with a
    one-hot reduction — no gathers anywhere.  Agrees bit-exactly with
    `brief_from_atlas` on the rounded atlas whenever the angle lies on
    a bin center; elsewhere it IS the ORB-paper semantics (steered
    BRIEF from a discrete-rotation lookup table)."""
    pf = extract_patches_matmul(blur_atlas, level, yx)             # [N, P2]
    return brief_matmul_from_patches(pf, angles, n_bins)


def brief_matmul_from_patches(
    patches_flat: Array,  # [N, BRIEF_PATCH^2] float32 blurred patches
    angles: Array,        # [N] float32 radians
    n_bins: int = N_ANGLE_BINS,
) -> Array:
    """The angle-binned int8 matmul sampling stage of `brief_matmul`, fed
    directly with pre-extracted blurred patches (the patch-centric
    detector path blurs per-keypoint patches instead of the dense
    pyramid — same quantize-then-compare semantics)."""
    N = patches_flat.shape[0]
    tau = 2.0 * np.pi
    b = jnp.round(angles / (tau / n_bins)).astype(jnp.int32) % n_bins

    pq = (jnp.clip(jnp.round(patches_flat), 0.0, 255.0)
          - 128.0).astype(jnp.int8)

    S8 = jnp.asarray(_bin_selector_i8_flat(n_bins))          # [P2, B*512]
    v = jax.lax.dot_general(
        pq, S8, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)                    # [N, B*512]
    v = v.reshape(N, n_bins, 512)
    onehot = (b[:, None] == jnp.arange(n_bins)[None, :])
    v = jnp.sum(v * onehot[:, :, None].astype(jnp.int32), axis=1)  # [N, 512]
    return (v[:, :256] < v[:, 256:]).astype(jnp.uint8)
