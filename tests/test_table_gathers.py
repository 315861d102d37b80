"""Table lookups as plain gathers: ``memops.lut_translate`` and the dense
tables behind ``rulemap`` maps, vs numpy indexing."""

import jax.numpy as jnp
import numpy as np
import pytest

from stringwars_tpu.ops import memops, rulemap


@pytest.mark.parametrize("size", [1, 100, 128, 300, 1280, 4000])
def test_lut_map_matches_take(size):
    """A step table of ``size`` entries evaluates exactly at every index."""
    rng = np.random.default_rng(size)
    table = rng.integers(-(2**30), 2**30, size).astype(np.int32)
    idx = rng.integers(0, size, 70_000).astype(np.int32)
    got = np.asarray(rulemap.step_map(jnp.asarray(idx), rulemap.compile_steps(table)))
    np.testing.assert_array_equal(got, table[idx])


def test_lut_map_shapes_preserved():
    table = np.arange(256, dtype=np.int32) * 3
    idx = np.arange(2 * 5 * 7, dtype=np.int32).reshape(2, 5, 7) % 256
    got = np.asarray(rulemap.step_map(jnp.asarray(idx), rulemap.compile_steps(table)))
    assert got.shape == (2, 5, 7)
    np.testing.assert_array_equal(got, table[idx])


def test_paged_tables_roundtrip():
    """A sparse fold-like delta map: the dense delta table reproduces every
    rule, and out-of-range codepoints read identity."""
    rng = np.random.default_rng(7)
    table = np.arange(0x10000, dtype=np.int64)
    hot = np.unique(rng.integers(0, 0x600, 500))
    table[hot] += rng.integers(1, 99, hot.size)
    table[0x1E00:0x1F00] += 7
    rules = rulemap.compile_fold(table)
    idx = np.concatenate([rng.integers(0, 0x10000, 50_000), [0x10000, 0x10FFFF]]).astype(np.int32)
    got = np.asarray(rulemap.range_map(jnp.asarray(idx), rules))
    want = np.where(idx < 0x10000, table[np.minimum(idx, 0xFFFF)], idx)
    np.testing.assert_array_equal(got, want)


def test_replicate8_pads_to_window():
    """The 256-entry byte LUT is one gather per byte."""
    rng = np.random.default_rng(3)
    lut = rng.integers(0, 256, 256, dtype=np.uint8)
    data = rng.integers(0, 256, 300, dtype=np.uint8)
    got = np.asarray(memops.lut_translate(jnp.asarray(data), jnp.asarray(lut)))
    assert got.dtype == np.uint8 and got.shape == (300,)
    np.testing.assert_array_equal(got, lut[data])
