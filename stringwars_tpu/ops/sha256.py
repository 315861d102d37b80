"""Batched SHA-256 on device (family K4 — crypto checksum tier).

The reference benchmarks SHA256 via blake3/sha2/ring/StringZilla
(``hash/bench.rs:298-389``), hashing one token per call. The device
shape is *batch-parallel*: every token is one lane, its 64-byte blocks are
processed sequentially (the chain is inherently serial) while thousands of
tokens ride the batch axis in parallel — all arithmetic is u32
add/rotate/xor, which vectorizes directly.

Layout: the host stages each token's fully padded message (0x80 terminator
+ big-endian bit length, FIPS 180-4 §5.1.1) as big-endian u32 words in
``[max_blocks, 16, batch]`` — block-major so the per-block compression
reads 16 contiguous ``[batch]`` vectors. The device scans blocks with the
message schedule + 64 rounds fully unrolled; lanes whose message ended
freeze their state via ``where`` so one scan serves every token length in
the bucket.

Conformance: bit-exact against ``hashlib.sha256`` (tests/test_sha256.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.tape import PaddedTokens

_U32 = jnp.uint32

# FIPS 180-4 §4.2.2 round constants.
_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_H0 = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)


@dataclasses.dataclass(frozen=True)
class Sha256Layout:
    """Staged padded messages: ``words[k, w, b]`` = big-endian word ``w`` of
    block ``k`` of token ``b``; ``n_blocks[b]`` = blocks the lane consumes."""

    words: jax.Array  # uint32 [max_blocks, 16, batch]
    n_blocks: jax.Array  # int32 [batch]

    def tree_flatten(self):
        return (self.words, self.n_blocks), None

    @classmethod
    def tree_unflatten(cls, _aux, children):
        return cls(*children)


jax.tree_util.register_pytree_node(
    Sha256Layout, Sha256Layout.tree_flatten, Sha256Layout.tree_unflatten
)


def prepare_sha256(tokens: PaddedTokens) -> Sha256Layout:
    """Host-stage FIPS padding for every token of a rectangular bucket."""
    data = np.asarray(tokens.data)
    lengths = np.asarray(tokens.lengths).astype(np.int64)
    B, W = data.shape
    max_blocks = (W + 9 + 63) // 64
    buf = np.zeros((B, max_blocks * 64), dtype=np.uint8)
    buf[:, :W] = data
    # Zero out padding bytes past each token's length before planting the
    # 0x80 terminator (bucket rows may carry junk past `lengths`).
    col = np.arange(max_blocks * 64, dtype=np.int64)
    buf[col[None, :] >= lengths[:, None]] = 0
    rows = np.arange(B)
    buf[rows, lengths] = 0x80
    n_blocks = (lengths + 9 + 63) // 64
    bitlen = (lengths * 8).astype(np.uint64)
    msg_end = n_blocks * 64
    for i in range(8):
        buf[rows, msg_end - 8 + i] = ((bitlen >> np.uint64(8 * (7 - i))) & np.uint64(0xFF)).astype(
            np.uint8
        )
    b4 = buf.reshape(B, max_blocks, 16, 4).astype(np.uint32)
    words = (b4[..., 0] << 24) | (b4[..., 1] << 16) | (b4[..., 2] << 8) | b4[..., 3]
    words = np.ascontiguousarray(words.transpose(1, 2, 0))  # [max_blocks, 16, B]
    return Sha256Layout(
        words=jnp.asarray(words), n_blocks=jnp.asarray(n_blocks.astype(np.int32))
    )


def _rotr(x: jax.Array, r: int) -> jax.Array:
    return (x >> r) | (x << (32 - r))


def _compress(state: tuple, block: jax.Array) -> tuple:
    """One SHA-256 compression over ``block`` ([16, batch] u32 words).

    Both the message schedule and the 64 rounds run as ``lax.scan`` with a
    few-op body (a 112-step full unroll makes XLA compiles minutes-slow for
    seconds of saved loop overhead; the per-step work is [batch]-wide
    vector math either way)."""

    def sched_step(w_ring: tuple, _):
        s0 = _rotr(w_ring[1], 7) ^ _rotr(w_ring[1], 18) ^ (w_ring[1] >> 3)
        s1 = _rotr(w_ring[14], 17) ^ _rotr(w_ring[14], 19) ^ (w_ring[14] >> 10)
        w16 = w_ring[0] + s0 + w_ring[9] + s1
        return w_ring[1:] + (w16,), w16

    ring0 = tuple(block[i] for i in range(16))
    _, extra = jax.lax.scan(sched_step, ring0, None, length=48, unroll=4)
    ws = jnp.concatenate([block, extra], axis=0)  # [64, batch]

    def round_step(regs: tuple, inputs):
        kt, wt = inputs
        a, b, c, d, e, f, g, h = regs
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + kt + wt
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        return (t1 + s0 + maj, a, b, c, d + t1, e, f, g), None

    final, _ = jax.lax.scan(round_step, state, (jnp.asarray(_K), ws), unroll=4)
    return tuple(s + v for s, v in zip(state, final))


def sha256(layout: Sha256Layout) -> jax.Array:
    """Per-token SHA-256 digests as u32 ``[batch, 8]`` (big-endian words)."""
    B = layout.n_blocks.shape[0]
    init = tuple(jnp.full((B,), _U32(int(h))) for h in _H0)

    def step(state, inputs):
        block, k = inputs
        new = _compress(state, block)
        live = k < layout.n_blocks
        return tuple(jnp.where(live, n, s) for n, s in zip(new, state)), None

    ks = jnp.arange(layout.words.shape[0], dtype=jnp.int32)
    final, _ = jax.lax.scan(step, init, (layout.words, ks))
    return jnp.stack(final, axis=-1)


def sha256_digest_bytes(layout: Sha256Layout) -> np.ndarray:
    """Host-side big-endian digest bytes ``[batch, 32]`` (for conformance)."""
    words = np.asarray(sha256(layout))  # [B, 8] u32
    out = np.empty(words.shape[:1] + (32,), dtype=np.uint8)
    for i in range(8):
        out[:, 4 * i + 0] = (words[:, i] >> 24) & 0xFF
        out[:, 4 * i + 1] = (words[:, i] >> 16) & 0xFF
        out[:, 4 * i + 2] = (words[:, i] >> 8) & 0xFF
        out[:, 4 * i + 3] = words[:, i] & 0xFF
    return out
