"""The port's uint32 RNG (emulated in int64 on torch) against the reference
package's: bit-exact on 10^4 random uint32 values, including values at and
above 2^31, and on the pure-integer oracle's fixtures."""

import numpy as np
import torch

from spectral_tpu.ops import rng as jrng
from spectral_tpu_torch.ops import rng as trng
from tests import oracle

torch.set_num_threads(1)

N = 10_000


def _u32(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    # the edges, and a guaranteed share at and above 2^31
    v[:6] = [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
    v[6:2000] |= np.uint32(0x80000000)
    return v


def _t(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(v.astype(np.int64))


def test_radical_inverse_bit_exact():
    v = _u32(1)
    want = np.asarray(jrng.radical_inverse(v))
    got = trng.radical_inverse(_t(v)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_pcg3d_bit_exact():
    x, y, z = _u32(2), _u32(3), _u32(4)
    want = jrng.random_pcg3d(x, y, z)
    got = trng.random_pcg3d(_t(x), _t(y), _t(z))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32))


def test_pcg3d_scalar_seed_broadcasts():
    x, y = _u32(5), _u32(6)
    for seed in (0, 7, 2**31 + 5, 2**32 - 1):
        want = jrng.random_pcg3d(x, y, np.uint32(seed))
        got = trng.random_pcg3d(_t(x), _t(y), seed)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32))


def test_hammersley_bit_exact():
    for n, cap in [(0, 10), (5, 10), (9, 10), (0, 1), (99, 100), (57, 1000),
                   (2**31, 2**31 + 3), (2**32 - 2, 2**32 - 1)]:
        gx, gy = trng.hammersley(n, cap)
        wx, wy = jrng.hammersley(np.uint32(n), np.uint32(cap))
        assert gx.item() == float(wx) and gy.item() == float(wy)
        ox, oy = oracle.hammersley(n, cap)
        assert gx.item() == float(ox) and gy.item() == float(oy)


def test_radical_inverse_oracle_fixtures():
    ns = [0, 1, 2, 3, 7, 100, 12345, 2**31, 2**32 - 1]
    got = trng.radical_inverse(torch.tensor(ns, dtype=torch.int64)).numpy()
    want = np.array([oracle.radical_inverse(n) for n in ns], dtype=np.float32)
    assert np.array_equal(got, want)
