"""MinHash fingerprints over multi-scale byte n-grams (kernel family K6).

The reference fingerprints each document with NDIM min-hashes spread over
byte n-grams of widths [5, 9, 17, 33] (NDIM/4 dims per width), outputting
min-hash values and min-counts (``fingerprints/bench.rs:85, 190-660``).

Spec (documented here; numpy replay in tests is the oracle):

1. **Gram hash** ``G_w[p] = sum_t token[p+t] * B^(w-1-t) (mod 2^32)`` — a
   polynomial hash with odd base B = 0x01000193. Computed for all positions
   at once by log-doubling: ``H^(2k)_p = H^(k)_p * B^k + H^(k)_{p+k}``, so
   the widths {1,2,4,8,16,32} cost one fused multiply-add per level and the
   benchmark widths {5,9,17,33} = 2^k+1 cost one extra step — ~7 vector ops
   per byte for all four widths together, instead of w ops per width.
2. **Per-dimension selection** ``h_d(g) = a_d * g + b_d (mod 2^32)`` with
   odd ``a_d``/``b_d`` derived from splitmix over the dim index — the same
   linear universal family the reference's hand-rolled MinHash uses
   (``fingerprints/bench.rs:546-607``, ``(a·h+b) mod 2⁶¹−1``); an odd
   multiplier is a bijection mod 2³², so each dim ranks grams by an
   independent permutation. Min (and argmin count) is taken over all
   in-range positions ``p <= len - w``; the published min-hash is
   ``mix32(min)`` (avalanche remix restores per-bit entropy without
   changing collision probabilities). A per-value avalanche would add ~6
   vector ops to the 3-op inner loop for no MinHash-quality gain.

Outputs match the reference's shape: ``min_hashes uint32[B, ndim]``,
``min_counts int32[B, ndim]`` (how many grams attained the min).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.tape import PaddedTokens

WINDOW_WIDTHS = (5, 9, 17, 33)
_BASE = np.uint32(0x01000193)  # FNV prime, odd


def _splitmix32(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint32(0x9E3779B9)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x21F0AAAD)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x735A2D97)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    return x


def dim_coefficients(ndim: int, seed: int = 0x5EED) -> tuple[np.ndarray, np.ndarray]:
    """Per-dimension universal-hash coefficients (a odd, b arbitrary)."""
    idx = np.arange(ndim, dtype=np.uint32)
    a = _splitmix32(idx * np.uint32(2) + np.uint32(seed)) | np.uint32(1)
    b = _splitmix32(idx * np.uint32(2) + np.uint32(1) + np.uint32(seed))
    return a, b


def _mix32(x: jax.Array) -> jax.Array:
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _gram_hashes(data: jax.Array, widths: tuple[int, ...]) -> dict[int, jax.Array]:
    """Per-width polynomial window hashes G_w, shape [B, W] (junk at
    positions past W - w; masked later). Log-doubling shared across widths."""
    B, W = data.shape
    x = data.astype(jnp.uint32)

    def shift_left(arr: jax.Array, k: int) -> jax.Array:
        k = min(k, W)
        return jnp.pad(arr[:, k:], ((0, 0), (0, k)))

    levels = {1: x}
    k = 1
    power = jnp.uint32(_BASE)
    while k < max(widths):
        levels[2 * k] = levels[k] * power + shift_left(levels[k], k)
        power = power * power
        k *= 2
    out = {}
    for w in widths:
        if w in levels:
            out[w] = levels[w]
            continue
        # w = 2^k + 1: extend by one trailing byte.
        base = w - 1
        assert base in levels, f"width {w} not expressible as 2^k or 2^k+1"
        out[w] = levels[base] * jnp.uint32(_BASE) + shift_left(x, base)
    return out


@functools.partial(jax.jit, static_argnames=("ndim", "widths", "with_counts", "dim_chunk"))
def fingerprint(
    tokens: PaddedTokens,
    ndim: int = 256,
    widths: tuple[int, ...] = WINDOW_WIDTHS,
    with_counts: bool = True,
    dim_chunk: int = 16,
) -> tuple[jax.Array, jax.Array | None]:
    """MinHash signature of every token: (min_hashes [B, ndim], min_counts).

    Dims are split evenly across ``widths`` (reference: NDIM/4 per width).
    Tokens shorter than a width contribute the hash of their zero-padded
    single gram at position 0 (so signatures are total, never undefined).
    """
    if ndim % len(widths):
        raise ValueError(f"ndim {ndim} not divisible by {len(widths)} widths")
    per_width = ndim // len(widths)
    B, W = tokens.data.shape
    grams = _gram_hashes(tokens.data, widths)
    lengths = tokens.lengths[:, None]
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]

    mins = []
    counts = []
    for wi, w in enumerate(widths):
        g = grams[w]  # [B, W]
        # Mask ONCE per width instead of per (dim, position) cell: replace
        # every invalid position's gram with the position-0 gram (always
        # valid) — duplicating an existing element never changes a min, so
        # the per-dim reduction needs no select. This is the dominant-cost
        # loop's hottest op: the select would be ~1/4 of the per-cell ops.
        valid = pos <= jnp.maximum(lengths - w, 0)  # at least position 0
        g = jnp.where(valid, g, g[:, :1])
        n_dup = jnp.sum(~valid, axis=1, dtype=jnp.int32)[:, None]  # [B, 1]
        a_np, b_np = dim_coefficients(ndim)
        a = jnp.asarray(a_np[wi * per_width : (wi + 1) * per_width])
        b = jnp.asarray(b_np[wi * per_width : (wi + 1) * per_width])
        for lo in range(0, per_width, dim_chunk):
            hi = min(lo + dim_chunk, per_width)
            vals = g[:, :, None] * a[None, None, lo:hi] + b[None, None, lo:hi]
            m = jnp.min(vals, axis=1)  # [B, chunk]
            # Final avalanche: min-of-uniforms concentrates in the low range;
            # a bijective remix restores ~1.0 per-bit entropy without
            # changing MinHash collision probabilities (Jaccard property).
            mins.append(_mix32(m))
            if with_counts:
                # Duplicates inflate the count only when the min IS the
                # position-0 value; subtract the known duplicate count then.
                v0 = g[:, 0, None] * a[None, lo:hi] + b[None, lo:hi]  # [B, chunk]
                full = jnp.sum(vals == m[:, None, :], axis=1, dtype=jnp.int32)
                counts.append(full - jnp.where(m == v0, n_dup, 0))
    min_hashes = jnp.concatenate(mins, axis=1)
    min_counts = jnp.concatenate(counts, axis=1) if with_counts else None
    return min_hashes, min_counts


# ---------------------------------------------------------------------------
# Numpy oracle (spec replay) + quality metrics
# ---------------------------------------------------------------------------

def fingerprint_ref(token: bytes, ndim: int = 256, widths=WINDOW_WIDTHS):
    """Direct numpy replay of the documented spec for one token."""
    per_width = ndim // len(widths)
    a_np, b_np = dim_coefficients(ndim)
    data = np.frombuffer(token, np.uint8).astype(np.uint32)
    mins = np.zeros(ndim, np.uint32)
    counts = np.zeros(ndim, np.int64)
    for wi, w in enumerate(widths):
        n_pos = max(len(token) - w, 0) + 1
        padded = np.zeros(n_pos + w, np.uint32)
        padded[: len(data[: n_pos + w])] = data[: n_pos + w]
        ghash = np.zeros(n_pos, np.uint32)
        for p in range(n_pos):
            h = np.uint32(0)
            for t in range(w):
                h = h * _BASE + padded[p + t]
            ghash[p] = h
        for d in range(per_width):
            gd = wi * per_width + d
            vals = (ghash * a_np[gd] + b_np[gd]).astype(np.uint32)
            m = vals.min()
            counts[gd] = int((vals == m).sum())
            m = m ^ (m >> np.uint32(16))
            m = np.uint32(m * np.uint32(0x7FEB352D))
            m = m ^ (m >> np.uint32(15))
            m = np.uint32(m * np.uint32(0x846CA68B))
            mins[gd] = m ^ (m >> np.uint32(16))
    return mins, counts


def bit_entropy(min_hashes: np.ndarray) -> float:
    """Mean per-bit entropy of the signature matrix (reference
    ``fingerprints/bench.rs:92-127`` quality metric; 1.0 = ideal)."""
    bits = ((min_hashes[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1, 32)
    p = bits.mean(axis=0)
    p = np.clip(p, 1e-12, 1 - 1e-12)
    return float(np.mean(-p * np.log2(p) - (1 - p) * np.log2(1 - p)))


def collision_rate(min_hashes: np.ndarray) -> float:
    """Fraction of (doc, dim) hash values that collide with another doc in
    the same dim (reference ``fingerprints/bench.rs:130-149``)."""
    docs, ndim = min_hashes.shape
    if docs < 2:
        return 0.0
    coll = 0
    for d in range(ndim):
        _, counts = np.unique(min_hashes[:, d], return_counts=True)
        coll += int((counts > 1) @ counts)
    return coll / (docs * ndim)
