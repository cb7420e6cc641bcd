"""The port's threefry stream (utils/prng.py) against jax.random, bit for
bit: keys, chains of splits, float32 uniforms of every shape the stages
draw, and the default RANSAC samplers of the line matcher and the floor
stage against the reference's own key chains (JaxSampler,
JaxFloorSampler).

The JAX package draws float32 uniforms where x64 is off, its default;
conftest.py turns x64 on, which makes jax.random.uniform's default dtype
float64, so every draw here names float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_graph_slam_tpu_torch.config import get_preset as p_get_preset
from delta_graph_slam_tpu_torch.lines import LineBasedScanmatcher
from delta_graph_slam_tpu_torch.models.floor_detection import (
    FloorDetectionConfig, FloorDetectionStage,
)
from delta_graph_slam_tpu_torch.utils import prng
from test_torch_hdl import JaxFloorSampler
from test_torch_lines import JaxSampler

torch.set_num_threads(2)

SEEDS = [0, 7, 42, 2 ** 31 - 1]
SHAPES = [(), (1,), (7, 3), (256, 2), (24, 256, 2)]


def words(key):
    """A JAX key's uint32 words as the port's int64 words."""
    return np.asarray(key).astype(np.int64)


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_threefry_partitionable_is_the_default():
    """utils/prng.py reproduces the partitionable counters."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain_matches_jax(seed):
    """20 splits in a chain, each holding both halves, and a wide split."""
    want, got = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for _ in range(20):
        w, g = jax.random.split(want), prng.split(got)
        np.testing.assert_array_equal(g.numpy(), words(w))
        want, got = w[0], g[0]
    np.testing.assert_array_equal(prng.split(got, 24).numpy(),
                                  words(jax.random.split(want, 24)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape):
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    want = jax.random.uniform(sub, shape, dtype=jnp.float32)
    got = prng.uniform(prng.split(prng.prng_key(seed))[1], shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_uniform_of_a_batch_of_keys_is_each_keys_draw():
    keys = jax.random.split(jax.random.PRNGKey(3), 6).reshape(2, 3, 2)
    got = prng.uniform(torch.from_numpy(words(keys)), (5, 2))
    assert tuple(got.shape) == (2, 3, 5, 2)
    for i in range(2):
        for j in range(3):
            want = jax.random.uniform(keys[i, j], (5, 2), dtype=jnp.float32)
            np.testing.assert_array_equal(bits(got[i, j].numpy()), bits(want))


def test_prng_key_rejects_seeds_outside_63_bits():
    with pytest.raises(ValueError):
        prng.prng_key(-1)
    with pytest.raises(ValueError):
        prng.prng_key(2 ** 63)


def test_default_line_sampler_is_the_reference_stream():
    """20 extractions at the delta preset's sizes (24 lines x 256
    hypotheses): the default sampler gives JaxSampler's uniforms bit for
    bit, as a (max_lines, n_hypotheses, 2) float32 tensor."""
    cfg = p_get_preset("delta").delta.scanmatcher
    sm, oracle = LineBasedScanmatcher(cfg, device="cpu"), JaxSampler(dtype=jnp.float32)
    for _ in range(20):
        got = sm.sampler(cfg.max_lines, cfg.n_hypotheses)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (cfg.max_lines, cfg.n_hypotheses, 2)
        np.testing.assert_array_equal(bits(got.numpy()),
                                      bits(oracle(cfg.max_lines, cfg.n_hypotheses)))


def test_default_floor_sampler_is_the_reference_stream():
    """20 detections at hdl_400's 512 hypotheses: the reference's key chain
    (PRNGKey(42), split once per detect)."""
    n = p_get_preset("hdl_400").floor.n_hypotheses
    stage = FloorDetectionStage(FloorDetectionConfig(), device="cpu")
    oracle = JaxFloorSampler(dtype=jnp.float32)
    for _ in range(20):
        got = stage.sampler(n)
        assert got.dtype == torch.float32 and tuple(got.shape) == (n, 3)
        np.testing.assert_array_equal(bits(got.numpy()), bits(oracle(n)))
