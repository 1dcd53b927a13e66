"""The fused Hamming 2-NN kernel (ops/match_pallas.py) against the plain
formulation (ops/match.py) and an independent numpy XOR-popcount 2-NN.

CPU tests run the kernel in Pallas interpret mode; the `gpu` tests run
it compiled for the card (skipped without one)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from modular_slam_tpu.config import MatcherConfig
from modular_slam_tpu.ops import match_pallas as mp
from modular_slam_tpu.ops.match import match_descriptors

CFG = MatcherConfig()


def _random_problem(seed, nq=128, nl=512, planted=32):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2, (nq, 256)).astype(np.int8) * 2 - 1
    t = rng.integers(0, 2, (nl, 256)).astype(np.int8) * 2 - 1
    # plant near-duplicates so real ratio-test survivors exist
    planted = min(planted, nq, nl)
    rows = rng.choice(nl, planted, replace=False)
    qs = rng.choice(nq, planted, replace=False)
    t[rows] = q[qs]
    qv = rng.random(nq) > 0.1
    tv = rng.random(nl) > 0.1
    return tuple(jnp.asarray(x) for x in (q, qv, t, tv))


def _kernel(q, qv, t, tv):
    return mp.match_descriptors_pallas(q, qv, t, tv, CFG, interpret=True)


def _assert_same(a, b):
    for field in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                      np.asarray(getattr(b, field)),
                                      err_msg=field)


def _numpy_2nn(q, qv, t, tv, cfg):
    """Independent oracle: Hamming distance by XOR + popcount of the
    packed bits, first-index argmin, second-min with the argmin masked."""
    qb = np.packbits(np.asarray(q) > 0, axis=1)
    tb = np.packbits(np.asarray(t) > 0, axis=1)
    x = np.bitwise_xor(qb[:, None, :], tb[None, :, :])
    d = np.unpackbits(x, axis=2).sum(axis=2).astype(np.float64)
    d[:, ~np.asarray(tv)] = np.inf
    idx = d.argmin(axis=1)
    best = d[np.arange(len(idx)), idx]
    d2 = d.copy()
    d2[np.arange(len(idx)), idx] = np.inf
    second = d2.min(axis=1)
    ok = (np.asarray(qv) & np.isfinite(best) & (best <= cfg.max_hamming)
          & (best < cfg.lowe_ratio * second))
    return idx, best, ok


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_matches_xla(seed):
    q, qv, t, tv = _random_problem(seed)
    mx = match_descriptors(q, qv, t, tv, CFG)
    _assert_same(mx, _kernel(q, qv, t, tv))
    assert np.asarray(mx.valid).sum() >= 16  # planted duplicates survive


def test_pallas_multi_tile_merge():
    """Global top-2 across tiles and splits: best and second may live
    in different tiles and in different splits."""
    q, qv, t, tv = _random_problem(7, nq=512, nl=4096)
    nq_pad, n_splits, tiles = mp.plan(512, 4096)
    assert n_splits > 1 and tiles > 1
    _assert_same(match_descriptors(q, qv, t, tv, CFG), _kernel(q, qv, t, tv))


def test_pallas_ties_pick_first_index():
    """Duplicate landmarks in different tiles and splits: the lowest
    index wins, and second == best, as in the plain version."""
    q, qv, t, tv = _random_problem(11, nq=64, nl=2048, planted=0)
    t = t.at[5].set(q[0]).at[700].set(q[0]).at[1900].set(q[0])
    tv = tv.at[jnp.array([5, 700, 1900])].set(True)
    mx = match_descriptors(q, qv, t, tv, CFG)
    mk = _kernel(q, qv, t, tv)
    _assert_same(mx, mk)
    assert int(mk.lm_slot[0]) == 5 and float(mk.distance[0]) == 0.0


def test_pallas_vmap_matches_xla():
    """Batched kernel: the vmap axis becomes a grid axis, which must not
    change what any block computes (parallel/dp.py vmaps the tracker;
    loop verification vmaps candidates over an unbatched landmark
    table)."""
    probs = [_random_problem(s, nq=64, nl=512) for s in (3, 4, 5, 6)]
    q, qv, t, tv = (jnp.stack([p[i] for p in probs]) for i in range(4))
    mk = jax.vmap(_kernel)(q, qv, t, tv)
    mk_shared = jax.vmap(_kernel, in_axes=(0, 0, None, None))(
        q, qv, t[0], tv[0])
    for i in range(len(probs)):
        _assert_same(match_descriptors(q[i], qv[i], t[i], tv[i], CFG),
                     jax.tree.map(lambda x: x[i], mk))
        _assert_same(match_descriptors(q[i], qv[i], t[0], tv[0], CFG),
                     jax.tree.map(lambda x: x[i], mk_shared))


def test_supported_shapes():
    """Every shape runs: queries pad to whole blocks and landmarks to
    whole splits of power-of-two tiles (padding rows are invalid)."""
    assert mp.plan(512, 16384) == (512, 16, 8)   # 128 programs, 8 tiles
    assert mp.plan(100, 1000) == (128, 8, 1)
    assert mp.plan(1, 1) == (64, 1, 1)
    for nq, nl in ((100, 1000), (7, 130), (65, 129)):
        q, qv, t, tv = _random_problem(nq + nl, nq=nq, nl=nl)
        _assert_same(match_descriptors(q, qv, t, tv, CFG),
                     _kernel(q, qv, t, tv))


@pytest.mark.parametrize("nq,nl", [(96, 300), (512, 1024), (33, 4097)])
def test_plain_matches_numpy_oracle(nq, nl):
    """The plain reference itself against XOR-popcount at odd, padded
    and tile-straddling shapes."""
    q, qv, t, tv = _random_problem(nq * nl, nq=nq, nl=nl)
    m = match_descriptors(q, qv, t, tv, CFG)
    idx, best, ok = _numpy_2nn(q, qv, t, tv, CFG)
    np.testing.assert_array_equal(np.asarray(m.valid), ok)
    np.testing.assert_array_equal(np.asarray(m.lm_slot)[ok], idx[ok])
    np.testing.assert_array_equal(np.asarray(m.distance)[ok], best[ok])


def test_dispatch_picks_reference_on_cpu():
    q, qv, t, tv = _random_problem(2, nq=64, nl=512)
    got = jax.jit(lambda *a: mp.match_descriptors_fastest(*a, CFG))(
        q, qv, t, tv)
    _assert_same(match_descriptors(q, qv, t, tv, CFG), got)
    text = jax.jit(lambda *a: mp.match_descriptors_fastest(*a, CFG)).lower(
        q, qv, t, tv).as_text()
    assert "hamming_2nn_split" not in text


@pytest.mark.gpu
def test_kernel_on_gpu_matches_reference(gpu):
    """Compiled for the card at the engine's full width."""
    q, qv, t, tv = _random_problem(0, nq=512, nl=16384, planted=200)
    ref = jax.jit(lambda *a: match_descriptors(*a, CFG))(q, qv, t, tv)
    got = jax.jit(lambda *a: mp.match_descriptors_fastest(*a, CFG))(
        q, qv, t, tv)
    _assert_same(ref, got)
