"""Exact substring + byteset search (kernel families K1, K2-lite).

The reference benchmarks all-matches substring scans (forward ``sz::find`` /
memmem loops, backward ``rfind``, ``find/bench.rs:56-219``) and byteset
scans over 3 charsets (``find/bench.rs:226-348``). Design:

- **Shifted byte compares.** A window starting at byte ``p`` matches when
  ``hay[p + j] == needle[j]`` for every needle byte ``j``; each ``j`` is one
  offset slice of the haystack, and XLA fuses the whole chain into one
  pass. The needle is staged into 4 offset-shifted word images with
  per-word masks (``PackedNeedle``). All compares are dense vector ops — no
  data-dependent early exit, which matches the all-matches semantics the
  reference actually measures (``find/bench.rs:88-93``).
- **Dynamic needles.** The needle arrives as packed arrays (not Python
  bytes), so cycling needles per call — the reference's workload shape —
  never recompiles. One compilation per (haystack length, needle capacity)
  bucket.
- **Reverse scan** reports the same match set walked from the end; on a
  data-parallel machine the direction is a no-op, so ``rfind`` shares the
  kernel (variant exists for name/work parity).
- Byteset membership: OR-of-compares for small sets, 256-entry one-hot
  table lookup otherwise.

Multi-chip: shard the haystack on the byte axis with an (m-1)-byte halo
(``parallel.sharding.shard_bytes``) and psum the per-shard counts.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

# Needle capacity buckets, in u32 words (16 B / 64 B / 256 B needles).
NEEDLE_WORD_BUCKETS = (4, 16, 64)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class PackedNeedle:
    """A needle staged for the packed-word scan.

    ``words[o, k]`` is the k-th LE u32 of the needle as it appears when the
    window starts at byte offset ``o`` (mod 4) — i.e. the needle shifted
    right by ``o`` bytes; ``masks[o, k]`` holds the valid-byte mask (the
    shifted image spans ``ceil((m + o) / 4)`` words). ``length`` is m.
    """

    words: jax.Array  # uint32[4, K]
    masks: jax.Array  # uint32[4, K]
    length: jax.Array  # int32 scalar

    def tree_flatten(self):
        return (self.words, self.masks, self.length), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def capacity(self) -> int:
        return self.words.shape[1]


def pack_needle(needle: bytes, capacity_words: int | None = None) -> PackedNeedle:
    """Host-side staging of a needle (≤ 4*capacity-3 bytes)."""
    m = len(needle)
    if m == 0:
        raise ValueError("empty needle")
    if capacity_words is None:
        need = (m + 3 + 3) // 4  # worst-case offset-3 image
        capacity_words = next((b for b in NEEDLE_WORD_BUCKETS if b >= need), need)
    words = np.zeros((4, capacity_words), dtype=np.uint32)
    masks = np.zeros((4, capacity_words), dtype=np.uint32)
    for o in range(4):
        shifted = bytes(o) + needle  # needle as seen from word-aligned start
        padded = shifted + bytes(-len(shifted) % 4)
        image = np.frombuffer(padded, dtype="<u4")
        k = image.shape[0]
        if k > capacity_words:
            raise ValueError(f"needle of {m} bytes exceeds capacity {capacity_words} words")
        words[o, :k] = image
        mask_bytes = (b"\x00" * o + b"\xff" * m) + bytes(-(o + m) % 4)
        masks[o, :k] = np.frombuffer(mask_bytes, dtype="<u4")
        words[o] &= masks[o]
    return PackedNeedle(
        words=jnp.asarray(words), masks=jnp.asarray(masks), length=jnp.int32(m)
    )


@functools.partial(jax.jit, static_argnames=("n",))
def _match_mask(hay: jax.Array, needle: PackedNeedle, n: int) -> jax.Array:
    """bool[n]: window starting at byte p matches, for p ≤ n - m.

    Shifted *contiguous* byte compares: position-j of the needle tests
    ``hay[p + j] == needle[j]`` via the offset slice ``hay[j : j + n]`` —
    each comparison streams the haystack once on dense u8 lanes.
    The needle bytes/mask come from the offset-0 image of the packed
    needle, so needles stay dynamic (no recompile when cycling).
    """
    cap = needle.capacity
    # Needle byte j lives in words[0, j // 4] at bit 8*(j % 4).
    match = jnp.ones((n,), dtype=bool)
    m = needle.length
    for j in range(4 * cap - 3):
        word = needle.words[0, j // 4]
        mask_b = (needle.masks[0, j // 4] >> (8 * (j % 4))) & jnp.uint32(0xFF)
        nb = ((word >> (8 * (j % 4))) & jnp.uint32(0xFF)).astype(jnp.uint8)
        ok = (hay[j : j + n] == nb) | (mask_b == 0)
        match &= ok
    p = jnp.arange(n, dtype=jnp.int32)
    return match & (p <= (n - m))


@functools.partial(jax.jit, static_argnames=("n",))
def _count_from_mask(hay, needle, n):
    return jnp.sum(_match_mask(hay, needle, n), dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("n", "limit"))
def _count_from_mask_limit(hay, needle, n, limit):
    """Matches with window start < ``limit``, compared over ``hay[:n + m - 1]``.

    The shard-halo convention: a shard owns window starts in its own
    ``chunk`` bytes but may compare across the (m-1)-byte halo; pass
    ``n > limit`` so seam-straddling windows are verified, and ``limit``
    = chunk so each window is counted by exactly one shard.
    """
    mask = _match_mask(hay, needle, n)
    p = jnp.arange(n, dtype=jnp.int32)
    return jnp.sum(mask & (p < limit), dtype=jnp.int32)


def _staged(hay, n: int, cap: int):
    pad_to = n + 4 * cap + 8
    if hay.shape[0] < pad_to:
        hay = jnp.pad(hay, (0, pad_to - hay.shape[0]))
    return hay


def find_count(hay, needle: PackedNeedle, n: int | None = None) -> jax.Array:
    """Number of (possibly overlapping) matches of ``needle`` in ``hay[:n]``."""
    hay = jnp.asarray(hay, dtype=jnp.uint8)
    n = int(hay.shape[0]) if n is None else n
    return _count_from_mask(_staged(hay, n, needle.capacity), needle, n)


@functools.partial(jax.jit, static_argnames=("n_cmp",))
def _count_from_mask_sharded(hay_row, needle, n_cmp: int, limit, lo, n_glob):
    """Per-shard all-matches count with halo compare + global end bound.

    Counts window starts ``p`` with ``p < limit`` (this shard owns them)
    and ``lo + p <= n_glob - m`` (window fully inside the global corpus),
    comparing across the shard's halo. ``limit``, ``lo``, ``n_glob`` are
    dynamic so one program serves every shard under ``shard_map``.
    """
    mask = _match_mask(hay_row, needle, n_cmp)
    p = jnp.arange(n_cmp, dtype=jnp.int32)
    ok = mask & (p < limit) & ((lo + p) <= (n_glob - needle.length))
    return jnp.sum(ok, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("n_cmp",))
def _count_last_from_mask_sharded(hay_row, needle, n_cmp: int, limit, lo, n_glob):
    """Sharded rfind program: (owned-window count, GLOBAL offset of the last
    match in this shard, -1 if none). Callers psum the count and pmax the
    offset so the pair matches ``rfind_count`` run on the whole corpus."""
    mask = _match_mask(hay_row, needle, n_cmp)
    p = jnp.arange(n_cmp, dtype=jnp.int32)
    ok = mask & (p < limit) & ((lo + p) <= (n_glob - needle.length))
    return jnp.sum(ok, dtype=jnp.int32), jnp.max(jnp.where(ok, lo + p, -1))


@functools.partial(jax.jit, static_argnames=("n",))
def _count_last_from_mask(hay, needle, n):
    mask = _match_mask(hay, needle, n)
    p = jnp.arange(n, dtype=jnp.int32)
    return jnp.sum(mask, dtype=jnp.int32), jnp.max(jnp.where(mask, p, -1))


def rfind_count(hay, needle: PackedNeedle, n: int | None = None):
    """Backward-search semantics: (all-matches count, LAST match offset).

    Distinct program from ``find_count`` (adds the max-position reduce),
    matching the reference's rfind loop (``find/bench.rs:144-219``).
    """
    hay = jnp.asarray(hay, dtype=jnp.uint8)
    n = int(hay.shape[0]) if n is None else n
    count, last = _count_last_from_mask(_staged(hay, n, needle.capacity), needle, n)
    return count, last


def find_positions(hay, needle: PackedNeedle, n: int | None = None) -> np.ndarray:
    """Sorted byte offsets of all matches (host-side; tests / conformance)."""
    hay = jnp.asarray(hay, dtype=jnp.uint8)
    n = int(hay.shape[0]) if n is None else n
    mask = np.asarray(_match_mask(_staged(hay, n, needle.capacity), needle, n))
    return np.flatnonzero(mask)


# ---------------------------------------------------------------------------
# Byteset membership
# ---------------------------------------------------------------------------

def pack_byteset(charset: bytes) -> jax.Array:
    """256-entry uint8 membership table for a byte set."""
    table = np.zeros(256, dtype=np.uint8)
    table[np.frombuffer(charset, dtype=np.uint8)] = 1
    return jnp.asarray(table)


def _byteset_member(hay: jax.Array, table: jax.Array, n: int) -> jax.Array:
    """uint32[n] membership mask of ``hay[:n]`` against the 256-entry set.

    One-hot membership is evaluated without gathers: the table is
    compressed to a 256-bit bitmap held in eight u32 lanes, and each byte
    tests its bit via shifts — O(1) ops per byte.
    """
    data = hay[:n].astype(jnp.int32)
    # Compress table to bitmap[8] u32 (static under jit because table is
    # an input array: compute on the fly, it is 256 elements — cheap).
    bits = table.astype(jnp.uint32).reshape(8, 32)
    weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    bitmap = jnp.sum(bits * weights[None, :], axis=1, dtype=jnp.uint32)  # [8]
    word_idx = data >> 5
    bit_idx = (data & 31).astype(jnp.uint32)
    selected = jnp.zeros(data.shape, dtype=jnp.uint32)
    for wi in range(8):
        selected = jnp.where(word_idx == wi, bitmap[wi], selected)
    return (selected >> bit_idx) & jnp.uint32(1)


@functools.partial(jax.jit, static_argnames=("n",))
def byteset_count(hay: jax.Array, table: jax.Array, n: int) -> jax.Array:
    """Count of bytes of ``hay[:n]`` that belong to the set."""
    return jnp.sum(_byteset_member(hay, table, n).astype(jnp.int32), dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("n",))
def byteset_count_bounded(hay, table, n: int, lo, n_glob) -> jax.Array:
    """Sharded byteset count: only positions with ``lo + p < n_glob`` count
    (excludes the zero padding past the corpus end on the last shard)."""
    member = _byteset_member(hay, table, n).astype(jnp.int32)
    p = jnp.arange(n, dtype=jnp.int32)
    return jnp.sum(jnp.where(lo + p < n_glob, member, 0), dtype=jnp.int32)
