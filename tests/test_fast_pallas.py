"""The FAST-score kernel (ops/fast_pallas.py) against the plain roll-ladder
formulation (ops/fast.py).  CPU tests run the kernel in Pallas interpret
mode; the `gpu` test runs it compiled for the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from modular_slam_tpu.ops import fast_pallas as fp
from modular_slam_tpu.ops.fast import fast_score

B = 3  # the plain version wraps around, the kernel reads zeros


@pytest.mark.parametrize("shape", [(120, 160), (95, 130)])
def test_matches_xla_away_from_border(shape):
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, shape).astype(np.float32))
    ref = np.asarray(fast_score(img))
    got = np.asarray(fp.fast_score_pallas(img, interpret=True))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[B:-B, B:-B], ref[B:-B, B:-B])


def test_vmap_rule():
    """The vmap axis becomes a grid axis; program_id still names the
    tile (parallel/dp.py vmaps the detector)."""
    rng = np.random.default_rng(1)
    imgs = jnp.asarray(rng.uniform(0, 255, (3, 64, 130)).astype(np.float32))
    ref = np.asarray(jax.vmap(fast_score)(imgs))
    got = np.asarray(jax.vmap(
        lambda x: fp.fast_score_pallas(x, interpret=True))(imgs))
    np.testing.assert_array_equal(got[:, B:-B, B:-B], ref[:, B:-B, B:-B])


def test_dispatch_picks_reference_on_cpu():
    img = jnp.asarray(np.random.default_rng(2).uniform(
        0, 255, (40, 70)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(fp.fast_score_fastest)(img)),
        np.asarray(fast_score(img)))


@pytest.mark.gpu
def test_kernel_on_gpu_matches_reference(gpu):
    img = jnp.asarray(np.random.default_rng(3).uniform(
        0, 255, (480, 640)).astype(np.float32))
    got = np.asarray(jax.jit(fp.fast_score_fastest)(img))
    ref = np.asarray(jax.jit(fast_score)(img))
    np.testing.assert_array_equal(got[B:-B, B:-B], ref[B:-B, B:-B])
