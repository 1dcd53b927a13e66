"""Fused Hamming 2-NN matcher as a Pallas kernel for the GPU (Triton route).

The plain formulation (ops/match.py) writes the [Nq, L] distance matrix
to device memory (32 MB at the 512 x 16384 default) and reads it back
for the argmin and the masked second-min.  This kernel never stores it:

- grid = (query blocks, landmark splits), blocks run in any order;
- each program loops over its split's landmark tiles; each tile is one
  int8 x int8 -> int32 `dot` on the tensor cores (the +-1 dot-product
  Hamming trick: ham(a, b) = (nbits - a.b) / 2);
- a running (best, argmin, second) triple per query lives in registers
  and is written once per split;
- a small XLA epilogue merges the splits into the global 2-NN.

Shapes that do not fill the tiles are padded with invalid rows.  The
kernel body reads no `program_id`: every offset comes from a BlockSpec
index map, and the split-local argmin is made global in the epilogue.
So `jax.vmap` (parallel/dp.py vmaps the tracker; loop verification
vmaps the candidates) may prepend its own grid axis without changing
what any block computes.

Semantics equal ops/match.py::match_descriptors exactly, ties included
(first index wins at every level); the plain version stays the CPU path
and the reference (tests/test_match_pallas.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from modular_slam_tpu.config import MatcherConfig
from modular_slam_tpu.ops.match import match_descriptors
from modular_slam_tpu.types import Matches

Array = jnp.ndarray

_BIG = 1e9
_BLOCK_Q = 64        # queries per program
_TILE_L = 128        # landmarks per inner-loop tile
_TARGET_PROGRAMS = 128   # ~one program per SM (132 on an H100)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(n_query: int, n_train: int):
    """-> (nq_pad, n_splits, tiles_per_split): the padded launch grid.

    Splits the landmark axis until the grid has about one program per
    SM; every split holds a power-of-two number of whole tiles."""
    nq_blocks = _cdiv(n_query, _BLOCK_Q)
    n_tiles = _cdiv(n_train, _TILE_L)
    n_splits = min(_next_pow2(n_tiles),
                   _next_pow2(max(1, _TARGET_PROGRAMS // nq_blocks)))
    tiles_per_split = _next_pow2(_cdiv(n_tiles, n_splits))
    return nq_blocks * _BLOCK_Q, n_splits, tiles_per_split


def _split_kernel(q_ref, t_ref, tv_ref, best_ref, idx_ref, second_ref, *,
                  n_tiles: int, tile_l: int):
    """One (query block, landmark split): loop over the split's tiles.

    q_ref  [BQ, nbits] int8 (+-1); t_ref [span, nbits] int8;
    tv_ref [span] int32 validity; outputs [BQ] rows of this split."""
    q = q_ref[...]
    nbits = q.shape[1]
    bq = q.shape[0]

    def body(k, carry):
        best, idx, second = carry
        rows = pl.ds(k * tile_l, tile_l)
        dot = jax.lax.dot_general(
            q, t_ref[rows, :], (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)            # [BQ, TILE_L]
        d = (nbits - dot).astype(jnp.float32) * 0.5
        d = jnp.where(tv_ref[rows][None, :] > 0, d, _BIG)
        t_best = jnp.min(d, axis=1)
        t_arg = jnp.argmin(d, axis=1).astype(jnp.int32)
        cols = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
        t_second = jnp.min(jnp.where(cols == t_arg[:, None], _BIG, d),
                           axis=1)
        # top-2 of the union {best, second} + {t_best, t_second}; strict
        # '<' keeps the earlier (lower) index on ties, like jnp.argmin
        second = jnp.minimum(jnp.minimum(second, t_second),
                             jnp.maximum(best, t_best))
        idx = jnp.where(t_best < best, t_arg + k * tile_l, idx)
        best = jnp.minimum(best, t_best)
        return best, idx, second

    init = (jnp.full((bq,), jnp.inf, jnp.float32),
            jnp.zeros((bq,), jnp.int32),
            jnp.full((bq,), jnp.inf, jnp.float32))
    best, idx, second = jax.lax.fori_loop(0, n_tiles, body, init)
    best_ref[...] = best
    idx_ref[...] = idx
    second_ref[...] = second


@functools.partial(jax.jit, static_argnames=("interpret",))
def split_top2(q_pm1: Array, t_pm1: Array, t_valid: Array,
               interpret: bool = False):
    """-> per-split (best, idx, second), each [n_splits, Nq]; idx global."""
    nq, nbits = q_pm1.shape
    n_train = t_pm1.shape[0]
    nq_pad, n_splits, tps = plan(nq, n_train)
    span = tps * _TILE_L
    l_pad = n_splits * span
    q = jnp.pad(q_pm1.astype(jnp.int8), ((0, nq_pad - nq), (0, 0)))
    t = jnp.pad(t_pm1.astype(jnp.int8), ((0, l_pad - n_train), (0, 0)))
    tv = jnp.pad(t_valid.astype(jnp.int32), (0, l_pad - n_train))

    kernel = functools.partial(_split_kernel, n_tiles=tps, tile_l=_TILE_L)
    row = pl.BlockSpec((None, _BLOCK_Q), lambda i, j: (j, i))
    best, idx, second = pl.pallas_call(
        kernel,
        grid=(nq_pad // _BLOCK_Q, n_splits),
        in_specs=[
            pl.BlockSpec((_BLOCK_Q, nbits), lambda i, j: (i, 0)),
            pl.BlockSpec((span, nbits), lambda i, j: (j, 0)),
            pl.BlockSpec((span,), lambda i, j: (j,)),
        ],
        out_specs=[row, row, row],
        out_shape=[
            jax.ShapeDtypeStruct((n_splits, nq_pad), jnp.float32),
            jax.ShapeDtypeStruct((n_splits, nq_pad), jnp.int32),
            jax.ShapeDtypeStruct((n_splits, nq_pad), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="hamming_2nn_split",
    )(q, t, tv)
    offsets = (jnp.arange(n_splits, dtype=jnp.int32) * span)[:, None]
    return best[:, :nq], (idx + offsets)[:, :nq], second[:, :nq]


def match_descriptors_pallas(
    query_pm1: Array,
    query_valid: Array,
    train_pm1: Array,
    train_valid: Array,
    cfg: MatcherConfig,
    interpret: bool = False,
) -> Matches:
    """The fused kernel; same result as ops.match.match_descriptors."""
    best_s, idx_s, second_s = split_top2(query_pm1, train_pm1, train_valid,
                                         interpret=interpret)
    # merge per-split top-2 -> global top-2 (tiny [S, Nq] epilogue);
    # argmin takes the first split on ties, i.e. the lowest index
    s_star = jnp.argmin(best_s, axis=0)
    qcols = jnp.arange(best_s.shape[1])
    best = best_s[s_star, qcols]
    best_idx = idx_s[s_star, qcols]
    rows = jnp.arange(best_s.shape[0])[:, None]
    others = jnp.where(rows == s_star[None, :], _BIG, best_s)
    second = jnp.minimum(second_s[s_star, qcols], jnp.min(others, axis=0))

    ok = (
        query_valid
        & (best < _BIG)
        & (best <= cfg.max_hamming)
        & (best < cfg.lowe_ratio * second)
    )
    return Matches(lm_slot=best_idx.astype(jnp.int32), distance=best,
                   valid=ok)


def match_descriptors_fastest(
    query_pm1: Array,
    query_valid: Array,
    train_pm1: Array,
    train_valid: Array,
    cfg: MatcherConfig,
) -> Matches:
    """The kernel when compiled for the GPU, the plain version for the
    CPU; lowering for any other platform raises."""
    args = (query_pm1, query_valid, train_pm1, train_valid)
    return jax.lax.platform_dependent(
        *args,
        cpu=lambda *a: match_descriptors(*a, cfg),
        cuda=lambda *a: match_descriptors_pallas(*a, cfg))
