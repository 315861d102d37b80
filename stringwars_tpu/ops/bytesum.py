"""Bytesum — the speed-of-light HBM-bandwidth probe (kernel family K4-lite).

The reference benchmarks ``sz::bytesum`` as its memory-bound reference bound
(``hash/bench.rs:298-389``; 12.62 GB/s on SPR, ``hash/README.md:78``). Here
the same role is played by a fused reduce that streams the corpus from
device memory once.

Exactness: a flat i32 reduce overflows past ~8 MB, so the sum is computed in
two tiers — per-chunk i32 partials (chunk sized so a partial can't overflow),
then a split 16-bit-limb accumulation whose (hi, lo) halves are recombined in
Python integers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from stringwars_tpu.tape import Tape


def _chunk_shape(n: int) -> tuple[int, int]:
    """Rows × chunk bytes such that chunk*255 and rows*65535 both fit in i32."""
    chunk = 4096
    while (n + chunk - 1) // chunk > 32_000:
        chunk *= 2
    rows = (n + chunk - 1) // chunk
    return rows, chunk


@functools.partial(jax.jit, static_argnames=("n",))
def _bytesum_parts(data: jax.Array, n: int) -> tuple[jax.Array, jax.Array]:
    rows, chunk = _chunk_shape(n)
    padded = data[: rows * chunk].reshape(rows, chunk)
    partials = jnp.sum(padded.astype(jnp.int32), axis=1)
    lo = jnp.sum(partials & 0xFFFF)
    hi = jnp.sum(partials >> 16)
    return hi, lo


_BYTESUM_LANES = 4096  # minor-axis width of the reduce (multiple of 128)


def _word_chunk_shape(n_words: int) -> tuple[int, int]:
    """(rows, lanes) in u32 words: the reduce runs down the major axis;
    per-lane u32 accumulation of 16-bit pair-sums (≤ 1020/word) stays
    exact for rows < 2³²/1020 ≈ 4.2 M (≈ 68 GB)."""
    lanes = _BYTESUM_LANES
    rows = (n_words + lanes - 1) // lanes
    return rows, lanes


@functools.partial(jax.jit, static_argnames=("n",))
def _bytesum_words_parts(words: jax.Array, n: int) -> tuple[jax.Array, jax.Array]:
    """Exact byte sum over little-endian u32 words (zero-padded past ``n``).

    Staying in u32 and pair-summing bytes into 16-bit fields
    ((w & 0x00FF00FF) + ((w >> 8) & 0x00FF00FF)) reads the stream a word
    at a time instead of converting every byte to i32.
    """
    n_words = (n + 3) // 4
    rows, lanes = _word_chunk_shape(n_words)
    padded = words[: rows * lanes].reshape(rows, lanes)
    m = jnp.uint32(0x00FF00FF)
    pair = (padded & m) + ((padded >> 8) & m)  # two 16-bit fields, each ≤ 510
    contrib = (pair & jnp.uint32(0xFFFF)) + (pair >> 16)  # ≤ 1020 per word
    partials = jnp.sum(contrib, axis=0)  # per-lane u32, exact (see shape note)
    lo = jnp.sum(partials & jnp.uint32(0xFFFF))
    hi = jnp.sum(partials >> 16)
    return hi, lo


def bytesum_words(words, n: int) -> int:
    """Exact sum of ``n`` corpus bytes held as little-endian u32 words.

    ``words`` must be zero-padded past byte ``n``; this is the natural
    layout of ``tape.pack_u32`` staging and the fast path for the
    speed-of-light calibration row."""
    if n == 0:
        return 0
    words = jnp.asarray(words)
    n_words = (n + 3) // 4
    rows, chunk = _word_chunk_shape(n_words)
    if rows * chunk > words.shape[0]:
        words = jnp.pad(words, (0, rows * chunk - words.shape[0]))
    hi, lo = _bytesum_words_parts(words, n)
    return (int(hi) << 16) + int(lo)


def bytesum(tape_or_bytes) -> int:
    """Exact sum of all corpus bytes, as a Python int."""
    if isinstance(tape_or_bytes, Tape):
        data, n = tape_or_bytes.data, tape_or_bytes.total_bytes
    else:
        data = jnp.asarray(tape_or_bytes, dtype=jnp.uint8)
        n = data.shape[0]
    if n == 0:
        return 0
    rows, chunk = _chunk_shape(n)
    if rows * chunk > data.shape[0]:
        data = jnp.pad(data, (0, rows * chunk - data.shape[0]))
    hi, lo = _bytesum_parts(data, n)
    return (int(hi) << 16) + int(lo)


@functools.partial(jax.jit, static_argnames=("n",))
def bytesum_device(data: jax.Array, n: int) -> jax.Array:
    """Jittable device-resident bytesum (uint32, exact below 4 GiB of 0xFF).

    Composable inside larger jitted pipelines where a host Python int is not
    wanted; uses the same two-tier reduction with a uint32 recombine.
    """
    rows, chunk = _chunk_shape(n)
    if rows * chunk > data.shape[0]:
        data = jnp.pad(data, (0, rows * chunk - data.shape[0]))
    padded = data[: rows * chunk].reshape(rows, chunk)
    partials = jnp.sum(padded.astype(jnp.int32), axis=1)
    lo = jnp.sum(partials & 0xFFFF).astype(jnp.uint32)
    hi = jnp.sum(partials >> 16).astype(jnp.uint32)
    return (hi << 16) + lo
