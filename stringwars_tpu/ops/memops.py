"""Memory ops: LUT translate, fill, copy, move, PRNG fill (family K12).

Reference workloads (``memory/bench.rs:110-396``): 256-byte LUT case-invert
translate, memset/memcpy/memmove, and PRNG buffer fill (AES-CTR analog).
Device equivalents:

- ``lut_translate`` — a 256-entry table map as one gather (``jnp.take``).
- ``fill`` / ``copy`` / ``move`` — XLA broadcast / device copy / shifted
  slice; they exist mostly to calibrate the memory roofline like the
  reference's memset/memcpy rows.
- ``fill_random`` — counter-based Threefry bits via ``jax.random``; the
  counter-based analog of the reference's AES-CTR keystream
  (``memory/bench.py:54-105``): reproducible, seekable, parallel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def lut_translate(data: jax.Array, lut: jax.Array) -> jax.Array:
    """``out[i] = lut[data[i]]`` for a uint8 buffer and a 256-entry table
    (``memory/bench.rs:110-166`` is the reference workload)."""
    return jnp.take(lut, data.astype(jnp.int32))


def invert_case_lut() -> np.ndarray:
    """The reference's LUT workload: swap ASCII upper/lower case
    (``memory/bench.rs:110-160``)."""
    lut = np.arange(256, dtype=np.uint8)
    lower = (lut >= 97) & (lut <= 122)
    upper = (lut >= 65) & (lut <= 90)
    lut[lower] -= 32
    lut[upper] += 32
    return lut


@functools.partial(jax.jit, static_argnames=("n",))
def fill(n: int, value) -> jax.Array:
    return jnp.full((n,), value, dtype=jnp.uint8)


@jax.jit
def copy(data: jax.Array) -> jax.Array:
    return data + jnp.uint8(0)  # forced materialization


@functools.partial(jax.jit, static_argnames=("shift",))
def move(data: jax.Array, shift: int = 8) -> jax.Array:
    """memmove analog: the buffer shifted by ``shift`` bytes (reference
    shifts by 8, work = len - 8; ``memory/bench.rs:321-396``)."""
    return jnp.concatenate([data[shift:], jnp.zeros((shift,), data.dtype)])


@functools.partial(jax.jit, static_argnames=("n",))
def fill_random_words(seed, n: int) -> jax.Array:
    """Counter-based random u32 words covering n bytes (Threefry)."""
    key = jax.random.PRNGKey(seed) if jnp.ndim(seed) == 0 else seed
    return jax.random.bits(key, ((n + 3) // 4,), dtype=jnp.uint32)


def fill_random(seed, n: int) -> np.ndarray:
    """Counter-based random bytes (the AES-CTR-keystream analog); device
    generates u32 words, host views them as bytes."""
    return np.asarray(fill_random_words(seed, n)).view(np.uint8)[:n]
