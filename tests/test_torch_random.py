"""The port's threefry RNG (stereomatch_tpu_torch/random.py) against
jax.random (jax_threefry_partitionable=True): bit-exact, so both packages
draw the same candidates from the same key."""

import jax
import numpy as np
import pytest
import torch

from stereomatch_tpu_torch import random as trandom
from stereomatch_tpu_torch.interop import key_from_jax

SEEDS = [0, 1, 5, 123456, -1, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split(seed):
    k = jax.random.PRNGKey(seed)
    kt = trandom.PRNGKey(seed, "cpu")
    np.testing.assert_array_equal(np.asarray(k).astype(np.int64), kt.numpy())
    for n in (2, 3, 7, 64):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(k, n)).astype(np.int64), trandom.split(kt, n).numpy()
        )


@pytest.mark.parametrize("data", [0, 1, 6, 2**31, 2**32 - 1])
def test_fold_in(data):
    k = jax.random.PRNGKey(42)
    np.testing.assert_array_equal(
        np.asarray(jax.random.fold_in(k, data)).astype(np.int64),
        trandom.fold_in(trandom.PRNGKey(42, "cpu"), data).numpy(),
    )


@pytest.mark.parametrize(
    "shape,lo,hi", [((5,), 0.0, 1.0), ((4, 33), -1.0, 1.0), ((1024,), 0.0, 1.0), ((3, 7), 2.0, 9.5)]
)
def test_uniform_bits(shape, lo, hi):
    for seed in (0, 9):
        k = jax.random.split(jax.random.PRNGKey(seed))[1]
        want = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
        got = trandom.uniform(key_from_jax(k, "cpu"), shape, lo, hi).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_key_chain_like_the_optimizer():
    """The chain mst_pms_optimize and make_candidate_fn walk: split, split
    into per-iteration keys, split in 3, fold_in, split again."""
    k = jax.random.PRNGKey(3)
    kt = trandom.PRNGKey(3, "cpu")
    k, _ = jax.random.split(k)
    kt, _ = trandom.split(kt)
    for ki, kti in zip(jax.random.split(k, 4), trandom.split(kt, 4)):
        ka, _, kc = jax.random.split(ki, 3)
        kta, _, ktc = trandom.split(kti, 3)
        a = jax.random.split(jax.random.fold_in(ka, 1))[1]
        b = trandom.split(trandom.fold_in(kta, 1))[1]
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())
        r = np.asarray(jax.random.uniform(jax.random.fold_in(kc, 2), (4, 50), minval=-1.0, maxval=1.0))
        rt = trandom.uniform(trandom.fold_in(ktc, 2), (4, 50), -1.0, 1.0).numpy()
        np.testing.assert_array_equal(r, rt)


def test_bad_seed_and_key():
    with pytest.raises(ValueError):
        trandom.PRNGKey(2**31)
    with pytest.raises(ValueError):
        key_from_jax(np.zeros(3, np.uint32))
    assert trandom.PRNGKey(0, "cpu").dtype == torch.int64
