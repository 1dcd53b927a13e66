"""Masked index extraction without a scatter.

`jnp.nonzero(mask, size=cap, fill_value=N)` lowers through a scatter;
the same contract via `lax.top_k` over strictly-decreasing keys needs
none.  Exact for N < 2^24 (f32 keys)."""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

Array = jnp.ndarray


def masked_indices(mask: Array, cap: int) -> Array:
    """First `cap` indices where mask is True, ascending; N for absent
    slots — drop-in for `jnp.nonzero(mask, size=cap, fill_value=N)[0]`."""
    N = mask.shape[0]
    assert N < (1 << 24), N  # f32 keys stay exact
    keys = jnp.where(mask, (N - jnp.arange(N)).astype(jnp.float32), 0.0)
    k = min(cap, N)
    v, idx = lax.top_k(keys, k)
    idx = jnp.where(v > 0, idx, N)
    if k < cap:  # nonzero(size=cap) allows cap > N; pad with N
        idx = jnp.concatenate(
            [idx, jnp.full((cap - k,), N, idx.dtype)])
    return idx
