"""Bag-of-binary-words vocabulary as batched matmul.

Replaces DBoW3 (the reference's OrbRelocalizer loads an external
`orbvoc.dbow3` vocabulary file that is not even shipped,
orb_relocalizer.cpp:28, and stubs every method :32-55).

Accelerator design: the vocabulary is a fixed ±1 projection codebook
[V, 256]; a descriptor's word is the argmax similarity (one int8
matmul), a frame's BoW vector is the L2-normalized word histogram,
and database scoring is hist @ database.T — batched matmul + top-k, no
trees, no pointer chasing.  The codebook is deterministic (seeded) so
every run shares the same vocabulary without external files.
"""

from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

Array = jnp.ndarray

_SEED = 0xB0BA
_VOCAB_DIR = os.path.join(os.path.dirname(__file__), "..", "data")


def make_vocab(vocab_size: int = 1024, n_bits: int = 256,
               seed: int = _SEED) -> np.ndarray:
    """[V, n_bits] ±1 int8 codebook (host constant, bake into jit).

    Random projection fallback — prefer `load_trained_vocab`, whose
    codebook is k-means-calibrated on real BRIEF descriptor statistics
    (BRIEF bits are far from i.i.d. uniform; see tools/train_vocab.py)."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-1, 1], np.int8), size=(vocab_size, n_bits))


def train_vocab(desc_pm1: np.ndarray, vocab_size: int = 1024,
                iters: int = 12, seed: int = _SEED) -> np.ndarray:
    """Spherical k-means over ±1 descriptors -> sign-binarized ±1 int8
    codebook [V, n_bits].

    Binary descriptors live on the hypercube; cosine similarity against a
    ±1 centroid is an affine function of Hamming distance, so assigning
    each descriptor to its max-dot-product word (the same matmul the
    runtime scoring uses) clusters by Hamming distance — the role DBoW3's
    vocabulary tree plays for the reference (orb_relocalizer.cpp:28),
    without trees or external vocabulary files."""
    rng = np.random.default_rng(seed)
    X = np.asarray(desc_pm1, np.float32)
    n = X.shape[0]
    if n < vocab_size:
        raise ValueError(f"need >= {vocab_size} descriptors, got {n}")
    C = X[rng.choice(n, vocab_size, replace=False)].copy()
    for _ in range(iters):
        assign = np.argmax(X @ C.T, axis=1)                # [N]
        sums = np.zeros_like(C)
        np.add.at(sums, assign, X)
        counts = np.bincount(assign, minlength=vocab_size)[:, None]
        # empty words re-seed from random descriptors (keeps V live words)
        empty = counts[:, 0] == 0
        C = np.where(empty[:, None], X[rng.choice(n, vocab_size)], sums)
        C = np.sign(C) + (C == 0)                          # ±1, ties -> +1
    return C.astype(np.int8)


def load_trained_vocab(vocab_size: int = 1024,
                       n_bits: int = 256) -> np.ndarray:
    """Packaged descriptor-calibrated codebook (tools/train_vocab.py);
    falls back to the random-projection vocab when no artifact matches."""
    path = os.path.join(_VOCAB_DIR, f"vocab_{vocab_size}_{n_bits}.npz")
    if os.path.exists(path):
        return np.load(path)["vocab"].astype(np.int8)
    return make_vocab(vocab_size, n_bits)


def descriptor_words(desc_pm1: Array, vocab: Array) -> Array:
    """[N, 256] ±1 -> [N] int32 word ids (argmax codebook similarity)."""
    sim = jnp.matmul(desc_pm1.astype(jnp.int32),
                     jnp.asarray(vocab).astype(jnp.int32).T,
                     preferred_element_type=jnp.int32)
    return jnp.argmax(sim, axis=1).astype(jnp.int32)


def bow_histogram(desc_pm1: Array, valid: Array, vocab: Array) -> Array:
    """[N, 256] ±1 + [N] mask -> [V] L2-normalized BoW vector."""
    V = vocab.shape[0]
    words = descriptor_words(desc_pm1, vocab)
    words = jnp.where(valid, words, V)  # invalid -> dropped bucket
    hist = jnp.zeros((V,), jnp.float32).at[words].add(1.0, mode="drop")
    n = jnp.linalg.norm(hist)
    return hist / jnp.maximum(n, 1e-6)
