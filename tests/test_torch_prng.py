"""The port's random bits and replay buffer are bit-exact with the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergodic_exploration_tpu.ops.buffer import RingBuffer as JRingBuffer
from ergodic_exploration_tpu.ops.buffer import uniform01 as j_uniform01
from ergodic_exploration_tpu_torch.ops.buffer import RingBuffer
from ergodic_exploration_tpu_torch.utils import prng

torch.set_num_threads(2)


def _keys(n=64, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, size=(n, 2), dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("num", [2, 3, 64])
def test_split_bit_exact(num):
    keys = _keys()
    ref = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(jnp.asarray(keys)))
    got = prng.split(torch.from_numpy(keys.astype(np.int64)), num).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_uniform01_bit_exact():
    keys = _keys(seed=1)
    ref = np.asarray(jax.vmap(lambda k: j_uniform01(k, 100))(jnp.asarray(keys)))
    got = prng.uniform01(torch.from_numpy(keys.astype(np.int64)), 100).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_ring_buffer_matches_jax():
    """append wraps at capacity; sample_states / sample_mask draw the same
    entries as the JAX buffer for the same keys."""
    S, cap = 4, 8
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 3, (11, S, 2)).astype(np.float32)
    keys = _keys(S, seed=3)
    jb = jax.vmap(lambda _: JRingBuffer.create(cap))(jnp.arange(S))
    tb = RingBuffer.create(cap, S)
    for p in pts:
        jb = jax.vmap(lambda b, q: b.append(q))(jb, jnp.asarray(p))
        tb = tb.append(torch.from_numpy(p))
    np.testing.assert_array_equal(tb.states.numpy(), np.asarray(jb.states))
    np.testing.assert_array_equal(tb.cursor.numpy(), np.asarray(jb.cursor))
    np.testing.assert_array_equal(tb.count.numpy(), np.asarray(jb.count))
    tk = torch.from_numpy(keys.astype(np.int64))
    s_ref, n_ref = jax.vmap(lambda b, k: b.sample_states(5, k))(jb, jnp.asarray(keys))
    s_got, n_got = tb.sample_states(5, tk)
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(n_got.numpy(), np.asarray(n_ref))
    m_ref = jax.vmap(lambda b, k: b.sample_mask(5, k))(jb, jnp.asarray(keys))
    np.testing.assert_array_equal(tb.sample_mask(5, tk).numpy(), np.asarray(m_ref))
