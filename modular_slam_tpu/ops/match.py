"""Brute-force Hamming 2-NN descriptor matching with Lowe ratio test.

Reference: OrbOpenCvMatcher — BRUTEFORCE_HAMMING knnMatch(k=2) + ratio 0.7
(orb_feature.cpp:81-117).

Dense formulation: descriptors are ±1 int8 vectors, so Hamming distance
is a matmul: ham(a, b) = (256 - a·b) / 2 (the ±1 dot-product trick,
SURVEY.md §7).  2-NN and the ratio test are a masked top-2 over the
distance matrix.  This is the plain reference and the CPU path; on the
GPU, ops/match_pallas.py computes the same result without storing the
matrix.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from modular_slam_tpu.config import MatcherConfig
from modular_slam_tpu.types import Matches

Array = jnp.ndarray

# plain float: a module-level jnp scalar would initialize the
# device backend at import time
_BIG = 1e9


def hamming_matrix(a_pm1: Array, b_pm1: Array) -> Array:
    """[N, 256] x [M, 256] ±1 int8 -> [N, M] float32 Hamming distances."""
    dot = jnp.matmul(
        a_pm1.astype(jnp.int32), b_pm1.astype(jnp.int32).T,
        preferred_element_type=jnp.int32,
    )
    nbits = a_pm1.shape[-1]
    return (nbits - dot).astype(jnp.float32) * 0.5


def match_descriptors(
    query_pm1: Array,
    query_valid: Array,
    train_pm1: Array,
    train_valid: Array,
    cfg: MatcherConfig,
) -> Matches:
    """2-NN + ratio matches from query rows to train rows.

    Returns Matches(lm_slot=[N] best train index, distance, valid).
    Invalid query/train rows never match.
    """
    d = hamming_matrix(query_pm1, train_pm1)
    d = jnp.where(train_valid[None, :], d, _BIG)

    # top-2 smallest along train axis (mask-out-the-argmin instead of a
    # zipped 2-D scatter)
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    cols = jnp.arange(d.shape[1], dtype=jnp.int32)[None, :]
    d2 = jnp.where(cols == best_idx[:, None], _BIG, d)
    second = jnp.min(d2, axis=1)

    ok = (
        query_valid
        & (best < _BIG)
        & (best <= cfg.max_hamming)
        & (best < cfg.lowe_ratio * second)
    )
    return Matches(
        lm_slot=best_idx.astype(jnp.int32),
        distance=best,
        valid=ok,
    )


def dedupe_matches(m: Matches, n_train: int) -> Matches:
    """Keep only the best (smallest-distance) query per train index.

    The reference's knnMatch produces at most one match per *query*; ties
    on the train side can still collide.  For landmark association we want
    one observation per landmark — resolve collisions by (distance,
    query-index) argmin.

    Two formulations with identical semantics: the default is an [N, N]
    pairwise comparison (elementwise + reduce; N = keypoint budget, so
    512x512 bools), which needs no [n_train]-sized `.at[].min` scatter.
    The scatter path remains for very large N."""
    d = jnp.where(m.valid, m.distance, _BIG)
    N = d.shape[0]
    # tie-breaks use INTEGER keys: a float `d + idx*eps` loses the epsilon
    # below one ulp once d >= ~16, leaving equal-distance duplicates both
    # "kept" (advisor round-2 finding).  Hamming distances are multiples
    # of 0.5, so 2*d is exact in int32; (2*d)*N + query_idx is a total
    # lexicographic (distance, query index) order.
    qidx = jnp.arange(N, dtype=jnp.int32)
    key = jnp.where(m.valid,
                    (2.0 * d).astype(jnp.int32) * N + qidx,
                    jnp.int32(2**31 - 1))
    if N <= 2048:
        same = (m.lm_slot[:, None] == m.lm_slot[None, :]) & m.valid[None, :]
        better = same & (key[None, :] < key[:, None])
        keep = m.valid & ~jnp.any(better, axis=1)
        return Matches(lm_slot=m.lm_slot, distance=m.distance, valid=keep)
    # per-train best key via scatter-min
    best_key = jnp.full((n_train,), 2**31 - 1, dtype=jnp.int32)
    best_key = best_key.at[m.lm_slot].min(key)
    keep = m.valid & (key <= best_key[m.lm_slot])
    return Matches(lm_slot=m.lm_slot, distance=m.distance, valid=keep)
