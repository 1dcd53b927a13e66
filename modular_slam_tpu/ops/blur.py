"""Separable Gaussian blur (pre-descriptor smoothing).

Reference: 7x7 sigma=2 GaussianBlur with BORDER_REFLECT_101 before BRIEF
description (distributed_cv_feature.cpp:797-798).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

Array = jnp.ndarray


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def blur_patches(patches: Array, ksize: int = 7,
                 sigma: float = 2.0) -> Array:
    """Valid-region separable Gaussian blur of patch stacks:
    [N, P, P] -> [N, P-2r, P-2r] (r = ksize//2).

    The patch-centric detector path extracts (BRIEF_PATCH + 2r)-wide
    raw patches once and blurs them here with two small banded matmuls
    — the dense per-level pyramid blur computed ~1 M blurred pixels per
    frame to sample 512 keypoints' patches (round-5 roofline note).
    Taps are identical to `gaussian_blur`; run at Precision.HIGHEST so
    the uint8-rounded BRIEF inputs match the dense path bit-for-bit up
    to f32 summation order."""
    import jax

    k = gaussian_kernel_1d(ksize, sigma)
    r = ksize // 2
    P = patches.shape[-1]
    Q = P - 2 * r
    # banded [P, Q]: out[j] = sum_t k[t] * in[j + t]
    B = np.zeros((P, Q), np.float32)
    for j in range(Q):
        B[j:j + ksize, j] = k
    Bj = jnp.asarray(B)
    hp = jnp.einsum("nyi,ij->nyj", patches, Bj,
                    precision=jax.lax.Precision.HIGHEST)   # [N, P, Q]
    return jnp.einsum("niw,ij->njw", hp, Bj,
                      precision=jax.lax.Precision.HIGHEST)  # [N, Q, Q]


def gaussian_blur(img: Array, ksize: int = 7, sigma: float = 2.0) -> Array:
    """[H, W] float32 -> blurred [H, W]; reflect-101 borders like OpenCV.

    Separable filter written as shifted multiply-adds rather than
    lax.conv (a single-channel conv leaves the matrix units idle); this
    form is bandwidth-bound and fuses.
    """
    k = gaussian_kernel_1d(ksize, sigma)
    r = ksize // 2
    h, w = img.shape
    # reflect-101 padding (edge pixel not duplicated)
    padded = jnp.pad(img, ((r, r), (r, r)), mode="reflect")
    tmp = sum(float(k[i]) * padded[:, i:i + w] for i in range(ksize))
    return sum(float(k[i]) * tmp[i:i + h, :] for i in range(ksize))
