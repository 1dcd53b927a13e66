"""Intensity-centroid orientation (IC angle).

Reference: orb_impl::ic_angle over a 31px circular patch
(distributed_cv_feature.cpp:543-570, u_max_ rows :522-541), exact atan2
instead of the reference's polynomial approximation (:465-501) — the
device has fast transcendentals, no need to approximate.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

Array = jnp.ndarray

IC_RADIUS = 15  # 31 px patch


def _circular_weights(radius: int) -> np.ndarray:
    """[2r+1, 2r+1] 1.0 inside the discrete circle (u_max-style rows)."""
    d = 2 * radius + 1
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    # u_max per row: floor(sqrt(r^2 - y^2) + 0.5) like the reference setup
    umax = np.floor(np.sqrt(radius * radius - ys.astype(np.float64) ** 2) + 0.5)
    return (np.abs(xs) <= umax).astype(np.float32)


from functools import lru_cache


@lru_cache(maxsize=None)
def _mask_np(radius: int) -> np.ndarray:
    return _circular_weights(radius)


def _mask(radius: int) -> Array:
    # host constant -> fresh jnp array per trace (never caches a tracer)
    return jnp.asarray(_mask_np(radius))


def gather_patches(img: Array, yx: Array, size: int) -> Array:
    """Gather [N, size, size] patches centered at integer yx [N, 2] (y, x).

    Starts are clamped to the image, so callers must mask out keypoints
    whose patch would cross the border (detector border >= radius).
    """
    h, w = img.shape
    r = size // 2
    start = yx - r
    start = jnp.clip(start, 0, jnp.array([h - size, w - size]))

    def one(s):
        return lax.dynamic_slice(img, (s[0], s[1]), (size, size))

    return jax.vmap(one)(start)


def ic_angle(img: Array, yx: Array, radius: int = IC_RADIUS) -> Array:
    """IC orientation [N] (radians) for keypoints at integer yx [N, 2]."""
    size = 2 * radius + 1
    patches = gather_patches(img, yx, size)  # [N, s, s]
    mask = _mask(radius)
    coords = jnp.arange(-radius, radius + 1, dtype=img.dtype)
    wpatches = patches * mask
    m10 = jnp.einsum("nyx,x->n", wpatches, coords)
    m01 = jnp.einsum("nyx,y->n", wpatches, coords)
    return jnp.arctan2(m01, m10)


def ic_angle_from_patches(patches: Array,
                          radius: int = IC_RADIUS) -> Array:
    """IC orientation [N] from pre-extracted patches [N, P, P] (P odd,
    P >= 2*radius+1, keypoint at the center).  The patch-centric
    detector path computes moments ONLY at the selected keypoints —
    the dense `moment_maps` pyramid pass computed ~1 M pixels of
    moments per frame to read 512 of them (round-5 roofline note).
    Same arithmetic as the dense maps: masked circular-window first
    moments of the UNBLURRED image."""
    P = patches.shape[-1]
    c = P // 2
    crop = patches[:, c - radius:c + radius + 1, c - radius:c + radius + 1]
    mask = _mask(radius)
    coords = jnp.arange(-radius, radius + 1, dtype=patches.dtype)
    w = crop * mask
    # elementwise multiply + reduce (f32-exact; no matmul precision
    # concerns)
    m10 = jnp.sum(w * coords[None, None, :], axis=(1, 2))
    m01 = jnp.sum(w * coords[None, :, None], axis=(1, 2))
    return jnp.arctan2(m01, m10)


def moment_maps(img: Array, radius: int = IC_RADIUS) -> Array:
    """Dense IC moment maps, channels-FIRST [2, H, W] = (m10, m01).

    Channels-first keeps the long spatial axes minor; a trailing
    length-2 axis would become the minor dimension of every layout.

    Exact circular-patch moments via row-strip prefix sums instead of a
    31x31 dense convolution (a single-channel 961-tap conv): this
    formulation is a handful of cumsums + rolled adds.

    Per row offset dy the circle spans x in [-u(dy), u(dy)] (u_max rows,
    distributed_cv_feature.cpp:522-541).  With P = prefix(I) and
    T = prefix(x*I) along x, the strip sums are differences of two shifted
    columns, so:
        m10(y,x) = sum_dy [T-window - x * P-window](y+dy, x)
        m01(y,x) = sum_dy dy * [P-window](y+dy, x)
    Rolls wrap, but the wrap-contaminated fringe (<= radius+1 px) lies
    inside the detector border (19 px) and is never sampled.
    """
    H, W = img.shape
    dt = img.dtype
    xs = jnp.arange(W, dtype=dt)
    # padded prefix sums: Cp[:, k] = sum img[:, :k]  (shape [H, W+1])
    Cp = jnp.pad(jnp.cumsum(img, axis=1), ((0, 0), (1, 0)))
    Tp = jnp.pad(jnp.cumsum(img * xs[None, :], axis=1), ((0, 0), (1, 0)))

    mask = _mask_np(radius)
    # u per |dy|: half-width of the circle row (same rows as the conv mask)
    u_of = [int(mask[radius + dy].sum() // 2) for dy in range(radius + 1)]

    def window(Ap: Array, u: int) -> Array:
        """Ap[:, x+u+1] - Ap[:, x-u] for every x (strip sum over 2u+1)."""
        hi = jnp.roll(Ap, -(u + 1), axis=1)[:, :W]
        lo = jnp.roll(Ap, u, axis=1)[:, :W]
        return hi - lo

    # strip sums per distinct half-width (dy and -dy share u)
    strips = {}
    for u in sorted(set(u_of)):
        s = window(Cp, u)                       # sum I over strip
        mx = window(Tp, u) - xs[None, :] * s    # sum (x'-x) I over strip
        strips[u] = (s, mx)

    m10 = jnp.zeros((H, W), dt)
    m01 = jnp.zeros((H, W), dt)
    for dy in range(-radius, radius + 1):
        s, mx = strips[u_of[abs(dy)]]
        if dy == 0:
            m10 = m10 + mx
        else:
            m10 = m10 + jnp.roll(mx, -dy, axis=0)
            m01 = m01 + dt.type(dy) * jnp.roll(s, -dy, axis=0)
    return jnp.stack([m10, m01], axis=0)
