"""UTF-8 machinery: count, validate, decode, nth-codepoint (family K8).

Reference rows: ``sz::count_utf8`` / simdutf ``count_utf8`` (codepoint
counting), ``convert_utf8_to_utf32`` (decode), ``find_nth_utf8`` (offset of
the n-th codepoint; whole-buffer scan, ``tokenization/bench.rs:459-633``).

Formulation: everything is lead-byte classification (``b & 0xC0 !=
0x80``) plus cumulative sums — branch-free and dense. Decode compacts codepoints with one scatter over the
prefix-sum destination index; validation checks structure (continuation
coverage) and value ranges (overlongs, surrogates, > U+10FFFF) in one
fused pass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _classify(data: jax.Array):
    """(is_lead, width) per byte; width 0 for continuations/invalid leads."""
    b = data.astype(jnp.int32)
    is_cont = (b & 0xC0) == 0x80
    width = jnp.where(
        b < 0x80,
        1,
        jnp.where(
            b < 0xC0, 0, jnp.where(b < 0xE0, 2, jnp.where(b < 0xF0, 3, jnp.where(b < 0xF8, 4, 0)))
        ),
    )
    return ~is_cont, width


@functools.partial(jax.jit, static_argnames=("n",))
def utf8_count(data: jax.Array, n: int) -> jax.Array:
    """Number of codepoints (= non-continuation bytes) in ``data[:n]``."""
    b = data[:n]
    return jnp.sum(((b & 0xC0) != 0x80).astype(jnp.int32), dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("n",))
def utf8_find_nth(data: jax.Array, n: int, k: jax.Array) -> jax.Array:
    """Byte offset of the k-th codepoint (0-based); n if out of range.

    The reference's workload asks for the *last* codepoint's offset, which
    forces a full scan (``tokenization/bench.rs:583-633``) — here a cumsum
    + searchsorted, both dense.
    """
    is_lead = ((data[:n] & 0xC0) != 0x80).astype(jnp.int32)
    ranks = jnp.cumsum(is_lead) - is_lead  # rank of the codepoint starting here
    # offset = first position whose (rank == k and is_lead).
    hit = (ranks == k) & (is_lead == 1)
    return jnp.where(jnp.any(hit), jnp.argmax(hit), n).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n",))
def utf8_validate(data: jax.Array, n: int) -> jax.Array:
    """Strict UTF-8 validity of ``data[:n]`` (structure + ranges)."""
    b = data[:n].astype(jnp.int32)
    is_lead, width = _classify(b)
    is_cont = ~is_lead

    def width_at(k):
        """width[i-k], zeros beyond the left edge."""
        return jnp.pad(width, (k, 0))[:n]

    covered = (width_at(1) >= 2) | (width_at(2) >= 3) | (width_at(3) >= 4)
    # Every continuation must be covered by a preceding lead's span, and
    # every covered slot must actually be a continuation (no truncation).
    structure_ok = jnp.all(is_cont == covered)
    # No invalid lead bytes (width 0 on a non-continuation byte).
    structure_ok &= jnp.all(~(is_lead & (width == 0)))
    # Last sequence complete: a lead of width w needs w-1 following bytes.
    idx = jnp.arange(n, dtype=jnp.int32)
    structure_ok &= jnp.all(~(is_lead & (idx + width > n)))

    cp = _codepoints_at(b, n)
    ok2 = (width != 2) | (cp >= 0x80)
    ok3 = (width != 3) | ((cp >= 0x800) & ~((cp >= 0xD800) & (cp <= 0xDFFF)))
    ok4 = (width != 4) | ((cp >= 0x10000) & (cp <= 0x10FFFF))
    return structure_ok & jnp.all(jnp.where(is_lead, ok2 & ok3 & ok4, True))


def _codepoints_at(b: jax.Array, n: int) -> jax.Array:
    """Codepoint value decoded at every position (junk at non-leads)."""
    def nxt(k):
        return jnp.pad(b, (0, k))[k:] & 0x3F if k else b

    _, width = _classify(b)
    b1 = nxt(1)
    b2 = nxt(2)
    b3 = nxt(3)
    cp1 = b
    cp2 = ((b & 0x1F) << 6) | b1
    cp3 = ((b & 0x0F) << 12) | (b1 << 6) | b2
    cp4 = ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3
    return jnp.where(
        width == 1, cp1, jnp.where(width == 2, cp2, jnp.where(width == 3, cp3, cp4))
    )


@functools.partial(jax.jit, static_argnames=("n",))
def utf8_decode(data: jax.Array, n: int) -> tuple[jax.Array, jax.Array]:
    """Decode to UTF-32: (codepoints int32[n] zero-padded, count).

    Output slot j holds the j-th codepoint; invalid input produces
    unspecified values (validate first when needed).
    """
    b = data[:n].astype(jnp.int32)
    is_lead = (b & 0xC0) != 0x80
    cp = _codepoints_at(b, n)
    dst = jnp.cumsum(is_lead.astype(jnp.int32)) - 1
    dst = jnp.where(is_lead, dst, n)  # out-of-bounds drop for continuations
    out = jnp.zeros((n,), jnp.int32).at[dst].set(cp, mode="drop")
    return out, jnp.sum(is_lead.astype(jnp.int32), dtype=jnp.int32)


def decode_codepoints(token: bytes) -> np.ndarray:
    """Host-side decode helper (for building codepoint-level DP inputs)."""
    return np.array([ord(c) for c in token.decode("utf-8")], dtype=np.int32)
