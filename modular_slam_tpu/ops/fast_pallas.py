"""FAST-9/16 corner score as a Pallas kernel for the GPU (Triton route).

One program per (row tile, column tile) of the score map.  It loads the
centre tile and the 16 circle-offset tiles of the zero-padded image
(the 3-pixel halo comes from overlapping loads, no shared-memory
scratch), runs the circular min-9 / max-9 ladders in registers and
writes the tile's scores once.  The plain formulation (ops/fast.py) is
left to XLA's loop fusion.

Semantics equal ops/fast.py::fast_score exactly away from the 3-pixel
border, where the plain version wraps around and this one reads zeros;
the detector masks a border of >= 19 pixels.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from modular_slam_tpu.ops.fast import FAST_CIRCLE, fast_score

Array = jnp.ndarray

_HALO = 3            # circle radius
_TILE_H = 16
_TILE_W = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fast_kernel(img_ref, out_ref):
    y0 = pl.program_id(0) * _TILE_H + _HALO
    x0 = pl.program_id(1) * _TILE_W + _HALO

    def at(dy, dx):
        return img_ref[pl.ds(y0 + dy, _TILE_H), pl.ds(x0 + dx, _TILE_W)]

    center = at(0, 0)
    d = [at(dy, dx) - center for dy, dx in FAST_CIRCLE]
    bright = jnp.full(center.shape, -jnp.inf, jnp.float32)
    mn_of_mx = jnp.full(center.shape, jnp.inf, jnp.float32)
    for k in range(16):
        wmin = d[k]
        wmax = d[k]
        for j in range(1, 9):
            wmin = jnp.minimum(wmin, d[(k + j) % 16])
            wmax = jnp.maximum(wmax, d[(k + j) % 16])
        bright = jnp.maximum(bright, wmin)      # max_k min9(d)
        mn_of_mx = jnp.minimum(mn_of_mx, wmax)  # min_k max9(d)
    dark = -mn_of_mx                            # == max_k min9(-d)
    out_ref[...] = jnp.maximum(jnp.maximum(bright, dark), 0.0)


@functools.partial(jax.jit, static_argnames=("interpret",))
def fast_score_pallas(img: Array, interpret: bool = False) -> Array:
    """[H, W] float32 -> FAST score map (see module docstring)."""
    H, W = img.shape
    gh, gw = _cdiv(H, _TILE_H), _cdiv(W, _TILE_W)
    img_p = jnp.pad(img.astype(jnp.float32),
                    ((_HALO, gh * _TILE_H - H + _HALO),
                     (_HALO, gw * _TILE_W - W + _HALO)))
    score = pl.pallas_call(
        _fast_kernel,
        grid=(gh, gw),
        in_specs=[pl.BlockSpec(img_p.shape, lambda i, j: (0, 0))],
        out_specs=pl.BlockSpec((_TILE_H, _TILE_W), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((gh * _TILE_H, gw * _TILE_W),
                                       jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="fast9_score",
    )(img_p)
    return score[:H, :W]


def fast_score_fastest(img: Array) -> Array:
    """The kernel when compiled for the GPU, the plain version for the
    CPU; lowering for any other platform raises."""
    return jax.lax.platform_dependent(img, cpu=fast_score,
                                      cuda=fast_score_pallas)
