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


# ---- an independent spec: threefry-2x32 on Python ints ----

_M = 0xFFFFFFFF


def _threefry_spec(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """Threefry-2x32, 20 rounds (Salmon et al., SC'11), one block in Python
    ints masked to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (x0 + ks[0]) & _M, (x1 + ks[1]) & _M
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


# Random123's known answers for threefry2x32_20: (key, counter) -> output
_KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
        ((_M, _M), (_M, _M), (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))]
_SPEC_KEYS = [(0, 0), (0, 42), (0x9E3779B9, 0x7F4A7C15), (_M, 1)]


@pytest.mark.parametrize("key,ctr,want", _KAT)
def test_spec_and_twin_give_the_known_answers(key, ctr, want):
    assert _threefry_spec(*key, *ctr) == want
    y = trandom.threefry2x32(*(torch.tensor(v, dtype=torch.int64) for v in key + ctr))
    assert tuple(int(v) for v in y) == want


@pytest.mark.parametrize("key", _SPEC_KEYS)
def test_twin_split_and_fold_in_equal_the_spec(key):
    kt = torch.tensor(key, dtype=torch.int64)
    assert trandom.split_twin(kt, 5).tolist() == [list(_threefry_spec(*key, 0, i))
                                                   for i in range(5)]
    for data in (0, 1, 2**31, _M):
        assert trandom.fold_in_twin(kt, data).tolist() == list(_threefry_spec(*key, 0, data))


@pytest.mark.parametrize("key", _SPEC_KEYS)
def test_twin_bits_split_the_counter_at_32_bits(key):
    """The bits at flat index i are y0 ^ y1 of threefry(k, (i >> 32, i & M)),
    also at and above 2^32, where the high word takes part."""
    idx = [0, 1, 77, _M, 2**32, 2**32 + 5, 2**40 + 3]
    got = trandom._bits_at(torch.tensor(key, dtype=torch.int64), torch.tensor(idx))
    want = [a ^ b for a, b in (_threefry_spec(*key, i >> 32, i & _M) for i in idx)]
    assert got.tolist() == want
    bits = trandom._random_bits32(torch.tensor(key, dtype=torch.int64), (3, 4))
    assert bits.flatten().tolist() == [a ^ b for a, b in (_threefry_spec(*key, 0, i)
                                                         for i in range(12))]


def test_cpu_keys_take_the_twin(monkeypatch):
    """A CPU key never reaches the kernel module: the draws equal the
    twins' and no launch is counted."""
    def no_kernels(*a, **k):
        raise AssertionError("a CPU key reached the kernels")

    monkeypatch.setattr(trandom._build, "load_kernels", no_kernels)
    counts = (trandom.split.launches, trandom.fold_in.launches, trandom.uniform.launches)
    k = trandom.PRNGKey(11, "cpu")
    assert torch.equal(trandom.split(k, 3), trandom.split_twin(k, 3))
    assert torch.equal(trandom.fold_in(k, 9), trandom.fold_in_twin(k, 9))
    assert torch.equal(trandom.uniform(k, (2, 9), -1.0, 1.0),
                       trandom.uniform_twin(k, (2, 9), -1.0, 1.0))
    assert (trandom.split.launches, trandom.fold_in.launches, trandom.uniform.launches) == counts


def test_keys_off_the_cpu_never_take_the_twin():
    """Off the CPU a key goes to the kernel or raises: a meta key (no CUDA
    device, no data) is refused, not drawn by the twin."""
    k = torch.zeros(2, dtype=torch.int64, device="meta")
    for draw in (lambda: trandom.split(k), lambda: trandom.fold_in(k, 1),
                 lambda: trandom.uniform(k, (3,))):
        with pytest.raises(ValueError, match="K3"):
            draw()
