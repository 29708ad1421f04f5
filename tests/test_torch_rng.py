"""The port's PCG stream (int64 masked to 32 bits) against the reference's
uint32 ``utils/rng.py``: bit-exact on 1M random states plus the edges."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch.utils import rng as trng
from unity_webgpu_pathtracer_tpu.utils import rng as jrng

torch.set_num_threads(2)

EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _states(n=1_000_000, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    s[: EDGES.size] = EDGES
    return s


def _t(u32):
    return torch.from_numpy(u32.astype(np.int64))


def test_next_state_bit_exact():
    s = _states()
    want = np.asarray(jrng.next_state(jnp.asarray(s)))
    got = trng.next_state(_t(s)).numpy()
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_random_float_bit_exact():
    """Includes the int64 -> float32 rounding (nearest, as XLA's uint32
    convert): 0xFFFFFFFF-adjacent states round up to 2**32."""
    s = _states(seed=1)
    u_want, s_want = jrng.random_float(jnp.asarray(s))
    u_got, s_got = trng.random_float(_t(s))
    np.testing.assert_array_equal(s_got.numpy().astype(np.uint32), np.asarray(s_want))
    np.testing.assert_array_equal(u_got.numpy().view(np.uint32),
                                  np.asarray(u_want).view(np.uint32))


def test_random_floats_sequence_bit_exact():
    s = _states(4096, seed=2)
    us_want, st_want = jrng.random_floats(jnp.asarray(s), 5)
    us_got, st_got = trng.random_floats(_t(s), 5)
    for a, b in zip(us_got, us_want):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b).view(np.uint32))
    np.testing.assert_array_equal(st_got.numpy().astype(np.uint32), np.asarray(st_want))


@pytest.mark.parametrize("sample,root", [(0, 0), (7, 12345), (0xFFFFFFFE, 0xFFFFFFFF)])
def test_seed_bit_exact(sample, root):
    """pixel * (sample + 1) + root wraps mod 2**32 without int64 overflow."""
    px = _states(100_000, seed=3)
    want = np.asarray(jrng.seed(jnp.asarray(px), np.uint32(sample), np.uint32(root)))
    got = trng.seed(_t(px), sample, torch.tensor(root, dtype=torch.int64)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
