"""Probabilistic membership filters (kernel family K7).

The reference benchmarks Bloom (fastbloom/pyprobables) and BinaryFuse8
(xorf) filters: build + query throughput, measured FPR on a held-out 20 %
split, and bits/key (``containers/bench.rs:190-341``). Design:

- **Bloom**: the bit array is a device-resident uint32 word tensor; the k
  probe positions come from ``xxh64_multiseed`` (k independent seeds — the
  reference deliberately excludes linearly-dependent double hashing,
  ``containers/bench.rs:150-154``). Build scatters a byte-per-bit
  membership plane then packs it to words (scatter-max tolerates duplicate
  positions); queries are word gathers + bit tests, AND-reduced over k.
- **BinaryFuse8**: construction is inherently sequential peeling, so it
  runs on the host (numpy) like the reference's xorf build; the fingerprint
  table is shipped to the device and queries (3 segment gathers, xor, 8-bit
  compare) are batched device ops.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.ops import hash as H
from stringwars_tpu.tape import PaddedTokens


# ---------------------------------------------------------------------------
# Bloom filter
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BloomFilter:
    words: jax.Array  # uint32[m_bits / 32]
    seeds: tuple[int, ...]

    def tree_flatten(self):
        return (self.words,), (self.seeds,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(words=children[0], seeds=aux[0])

    @property
    def m_bits(self) -> int:
        return self.words.shape[0] * 32

    def bits_per_key(self, n_keys: int) -> float:
        return self.m_bits / max(n_keys, 1)


def bloom_positions(layout: H.HashLayout, seeds, m_bits: int) -> jax.Array:
    """[k, B] probe positions in [0, m_bits) from k-seed xxh64."""
    digests = H.xxh64_multiseed(layout, np.asarray(seeds, np.uint64))
    # Mod by m_bits using the low 32 bits mixed with the high (m is < 2^31).
    mixed = digests.lo ^ (digests.hi * jnp.uint32(0x9E3779B9))
    return (mixed % jnp.uint32(m_bits)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("m_bits", "seeds"))
def _bloom_build(layout: H.HashLayout, seeds: tuple, m_bits: int) -> jax.Array:
    pos = bloom_positions(layout, np.asarray(seeds, np.uint64), m_bits).reshape(-1)
    plane = jnp.zeros((m_bits,), jnp.uint8).at[pos].max(jnp.uint8(1))
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    return jnp.sum(plane.reshape(-1, 32).astype(jnp.uint32) * weights, axis=1, dtype=jnp.uint32)


def bloom_build(layout: H.HashLayout | PaddedTokens, seeds, m_bits: int) -> BloomFilter:
    if m_bits % 32:
        raise ValueError("m_bits must be a multiple of 32")
    layout = layout if isinstance(layout, H.HashLayout) else H.prepare(layout)
    seeds = tuple(int(s) for s in seeds)
    return BloomFilter(words=_bloom_build(layout, seeds, m_bits), seeds=seeds)


@functools.partial(jax.jit, static_argnames=("m_bits", "seeds"))
def _bloom_query(words: jax.Array, layout: H.HashLayout, seeds: tuple, m_bits: int) -> jax.Array:
    pos = bloom_positions(layout, np.asarray(seeds, np.uint64), m_bits)  # [k, B]
    word = jnp.take(words, pos >> 5)
    bit = (word >> (pos & 31).astype(jnp.uint32)) & jnp.uint32(1)
    return jnp.all(bit == 1, axis=0)


def bloom_query(filt: BloomFilter, layout: H.HashLayout | PaddedTokens) -> jax.Array:
    """bool[B]: probable membership of each token."""
    layout = layout if isinstance(layout, H.HashLayout) else H.prepare(layout)
    return _bloom_query(filt.words, layout, filt.seeds, filt.m_bits)


# ---------------------------------------------------------------------------
# BinaryFuse8
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BinaryFuse8:
    fingerprints: jax.Array  # uint8[array_len]
    segment_length: int
    segment_count_length: int
    seed: int

    def tree_flatten(self):
        return (self.fingerprints,), (self.segment_length, self.segment_count_length, self.seed)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    def bits_per_key(self, n_keys: int) -> float:
        return 8.0 * self.fingerprints.shape[0] / max(n_keys, 1)


def _fuse_hashes(keys_u64: np.ndarray, seed: int, segment_length: int, segment_count_length: int):
    """3 probe positions + fingerprint per key (splitmix-rehash of the key)."""
    x = (keys_u64 + np.uint64(seed)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(33)
    x = (x * np.uint64(0xFF51AFD7ED558CCD)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(33)
    x = (x * np.uint64(0xC4CEB9FE1A85EC53)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(33)
    fp = (x & np.uint64(0xFF)).astype(np.uint8)
    fp = np.where(fp == 0, np.uint8(0x5A), fp)  # nonzero fingerprints
    sl = np.uint64(segment_length)
    h = np.empty((3, keys_u64.shape[0]), np.int64)
    for i in range(3):
        hv = (x >> np.uint64(21 * i)) & np.uint64((1 << 21) - 1)
        seg = ((x >> np.uint64(48)) * np.uint64(segment_count_length) >> np.uint64(16)) // sl
        h[i] = ((seg + np.uint64(i)) * sl + (hv % sl)).astype(np.int64)
    return h, fp


def fuse_build(keys_u64: np.ndarray, max_attempts: int = 100) -> BinaryFuse8:
    """Host-side peeling construction over unique u64 keys."""
    keys = np.unique(np.asarray(keys_u64, np.uint64))
    n = keys.shape[0]
    segment_length = 1 << max(int(np.floor(np.log2(max(n, 2)) / 0.58 / 3.33 + 2)), 4)
    segment_length = min(segment_length, 1 << 18)
    capacity = int(max(n * 1.23, 32) + segment_length)
    segment_count_length = max((capacity // segment_length - 2), 1) * segment_length
    array_len = segment_count_length + 2 * segment_length
    for attempt in range(max_attempts):
        seed = 0xA5A5_0000 + attempt * 0x9E37
        h, fp = _fuse_hashes(keys, seed, segment_length, segment_count_length)
        order, ok = _peel(h, array_len, n)
        if ok:
            table = _assign(h, fp, order, array_len)
            return BinaryFuse8(
                fingerprints=jnp.asarray(table),
                segment_length=segment_length,
                segment_count_length=segment_count_length,
                seed=seed,
            )
    raise RuntimeError("binary fuse construction failed; increase capacity")


def _peel(h: np.ndarray, array_len: int, n: int):
    """Peeling order: repeatedly remove keys that are the sole occupant of
    some slot. Returns (ordered key indices reversed, success)."""
    counts = np.zeros(array_len, np.int32)
    xor_keys = np.zeros(array_len, np.int64)
    for i in range(3):
        np.add.at(counts, h[i], 1)
        np.bitwise_xor.at(xor_keys, h[i], np.arange(n))
    stack = list(np.flatnonzero(counts == 1))
    order = []
    removed = np.zeros(n, bool)
    while stack:
        slot = stack.pop()
        if counts[slot] != 1:
            continue
        key = int(xor_keys[slot])
        if removed[key]:
            continue
        removed[key] = True
        order.append((key, slot))
        for i in range(3):
            s = int(h[i][key])
            counts[s] -= 1
            xor_keys[s] ^= key
            if counts[s] == 1:
                stack.append(s)
    return order, len(order) == n


def _assign(h: np.ndarray, fp: np.ndarray, order, array_len: int) -> np.ndarray:
    table = np.zeros(array_len, np.uint8)
    for key, slot in reversed(order):
        v = fp[key]
        for i in range(3):
            s = int(h[i][key])
            if s != slot:
                v ^= table[s]
        table[slot] = v
    return table


def fuse_query(filt: BinaryFuse8, keys_u64: np.ndarray) -> jax.Array:
    """bool[B] membership via 3 device gathers + xor compare."""
    h, fp = _fuse_hashes(np.asarray(keys_u64, np.uint64), filt.seed, filt.segment_length, filt.segment_count_length)
    h0, h1, h2 = (jnp.asarray(h[i]) for i in range(3))
    return _fuse_query_dev(filt.fingerprints, h0, h1, h2, jnp.asarray(fp))


@jax.jit
def _fuse_query_dev(table, h0, h1, h2, fp):
    got = jnp.take(table, h0) ^ jnp.take(table, h1) ^ jnp.take(table, h2)
    return got == fp
