"""The port's copy of ``jax.random`` (``utils/jax_prng.py``) bit for bit
against JAX: keys from seeds, a 1,000-deep split chain, uniform draws of
several shapes in float32 and float64, and the carry of a key between the
packages.  The configuration the copy follows is asserted, so that a JAX
upgrade that changes the stream fails here rather than drifting."""

import jax
import numpy as np
import pytest
import torch

from pysparselp_tpu_torch.utils import jax_prng
from pysparselp_tpu_torch.utils.convert import key_from_jax, key_to_jax

torch.set_num_threads(1)
SEEDS = [0, 1, 7, 2**31 - 1]
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def test_jax_configuration_is_the_copied_one():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_chain(seed):
    key = jax.random.PRNGKey(seed)
    mine = jax_prng.prng_key(seed)
    assert key_from_jax(key) == mine
    for _ in range(1000):
        key, sub = jax.random.split(key)
        mine, mine_sub = jax_prng.split(mine)
    assert key_from_jax(key) == mine
    assert key_from_jax(sub) == mine_sub


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(), (5,), (1160,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed, shape, dtype):
    npdt, tdt = DTYPES[dtype]
    key, sub = jax.random.split(jax.random.PRNGKey(seed))
    want = np.asarray(jax.random.uniform(sub, shape, dtype=npdt))
    got = jax_prng.uniform(key_from_jax(sub), shape, tdt).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if shape == ():
        assert jax_prng.uniform_scalar(key_from_jax(sub), tdt) == float(want)


def test_key_round_trip():
    key = jax.random.split(jax.random.PRNGKey(3))[1]
    back = key_to_jax(key_from_jax(key))
    np.testing.assert_array_equal(back, np.asarray(key))
    assert back.dtype == np.uint32
