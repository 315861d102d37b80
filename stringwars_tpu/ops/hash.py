"""64-bit / 32-bit stateless, streaming, and multiseed hashing (family K3).

The reference benchmarks third-party hashes (xxh3/xxh64/aHash/wyhash/...,
``hash/bench.rs:96-474``) and a multiseed amortization
(``containers/bench.rs:155-187``). This module owns first-party device
implementations with **exact public-spec conformance**:

- ``xxh32`` / ``xxh64`` — bit-exact xxHash (validated against the C library
  in tests), batched over a ``PaddedTokens`` matrix. All 64-bit arithmetic
  runs on u32 lane pairs (``wideint``), so no 64-bit JAX mode is needed.
- ``xxh64_multiseed`` — k seeds per token in one pass: the token stripes are
  loaded once and the per-seed accumulators ride the broadcast dimension,
  the same amortization ``sz::hash_multiseed`` performs (SURVEY.md K3).
- ``tree_hash64`` — the corpus-level streaming hash. A sequential
  streaming hasher is the wrong shape for a data-parallel device, so the
  framework *specifies* a chunked tree: hash fixed chunks in parallel with
  xxh64, then hash the digest tape, recursing to one root digest.
  Deterministic, order-sensitive, and embarrassingly parallel.

Performance layout: hashing consumes a ``HashLayout`` — the token words
**stripe-major** (transposed to ``[W4, batch]``: tokens ride the minor
axis, so every stripe load is one contiguous ``[batch]`` vector) plus each
token's last-32-bytes staged into a fixed ``[8, batch]`` block. Building the
layout costs one transpose + one gather (amortized at tape load, like the
reference's tape build); after that the kernels are gather-free: stripe
rounds run under a ``lax.scan`` with unrolling (small widths unroll fully)
with per-token masks, and tail words come from compile-time positions of the
staged block, so XLA fuses the whole hash into one pass over the bytes.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from stringwars_tpu.ops import wideint as w
from stringwars_tpu.ops.wideint import U64
from stringwars_tpu.tape import PaddedTokens

_U32 = jnp.uint32

# xxh32 primes
_P32_1 = jnp.uint32(2654435761)
_P32_2 = jnp.uint32(2246822519)
_P32_3 = jnp.uint32(3266489917)
_P32_4 = jnp.uint32(668265263)
_P32_5 = jnp.uint32(374761393)

# xxh64 primes
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5

# Stripe loops are fully unrolled up to this many stripes; wider tokens run
# a lax.scan over the stripe axis with this unroll factor.
_UNROLL_MAX = 4
_SCAN_UNROLL = 1


def _rotl32(x: jax.Array, r: int) -> jax.Array:
    return (x << r) | (x >> (32 - r))


def _select_row(block: jax.Array, idx: jax.Array) -> jax.Array:
    """Per-lane ``block[idx[b], b]`` for a small static leading axis, via
    one-hot select (no gather: the rows are plain vectors)."""
    out = jnp.zeros_like(block[0])
    for j in range(block.shape[0]):
        out = jnp.where(idx == j, block[j], out)
    return out


# ---------------------------------------------------------------------------
# HashLayout
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class HashLayout:
    """Hash-ready token layout: stripe-major words + staged 32-byte tails.

    ``words_t`` is the padded token matrix transposed to ``[W4, batch]``
    (tokens on the vector-lane axis). ``tail_t[.., b]`` holds bytes
    ``[32*(n//32), n)`` of token ``b`` (the < 32 bytes past the last full
    32-byte stripe), zero-padded, as 8 LE u32 words at fixed positions —
    so tail processing needs no gathers.
    """

    words_t: jax.Array  # uint32[W4, B]
    tail_t: jax.Array  # uint32[8, B]
    lengths: jax.Array  # int32[B]

    def tree_flatten(self):
        return (self.words_t, self.tail_t, self.lengths), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def batch(self) -> int:
        return self.words_t.shape[1]


@jax.jit
def prepare(tokens: PaddedTokens) -> HashLayout:
    """Stage the hash layout (one transpose + one gather; amortized at load).

    All intermediates keep the batch on the minor axis.
    """
    words = tokens.as_u32()  # [B, W4]
    words_t = words.T  # [W4, B]
    n = tokens.lengths
    tail_word0 = (n // 32) * 8
    idx = jnp.clip(tail_word0[:, None] + jnp.arange(8)[None, :], 0, words.shape[1] - 1)
    tail_t = jnp.take_along_axis(words, idx, axis=1).T  # [8, B]
    # Zero bytes at and past position n (the tape guarantees zero padding,
    # but staged tails may overlap the next row when W % 32 != 0).
    r = (n % 32).astype(jnp.int32)
    valid = jnp.clip(r[None, :] - 4 * jnp.arange(8)[:, None], 0, 4)
    mask = jnp.where(
        valid >= 4,
        jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << (8 * jnp.minimum(valid, 3)).astype(_U32)) - 1,
    )
    return HashLayout(words_t=words_t, tail_t=tail_t & mask, lengths=n)


def _as_layout(tokens) -> HashLayout:
    if isinstance(tokens, HashLayout):
        return tokens
    return prepare(tokens)


# ---------------------------------------------------------------------------
# Stripe loops (shared structure for xxh32 / xxh64)
# ---------------------------------------------------------------------------

def _run_stripes(words_t, n_stripes, init, stride_words, round_fn):
    """Apply ``round_fn(accs, lane_rows, stripe_index)`` for every
    ``stride_words``-word stripe, masked by ``stripe < n_stripes``.

    ``words_t`` is stripe-major [W4, B]: stripe ``s`` is the contiguous row
    block ``[s*stride : (s+1)*stride]``, so every lane load is one [B]
    vector. Small widths unroll fully; wide tokens run a lax.scan over the
    stripe axis (compile-once body, modest unroll for ILP).
    """
    w4 = words_t.shape[0]
    total = w4 // stride_words
    if total <= _UNROLL_MAX:
        accs = init
        for s in range(total):
            lane = words_t[s * stride_words : (s + 1) * stride_words]
            accs = round_fn(accs, lane, s)
        return accs

    stacked = words_t[: total * stride_words].reshape(total, stride_words, -1)

    def body(accs, xs):
        s, lane = xs
        return round_fn(accs, lane, s), None

    accs, _ = jax.lax.scan(
        body, init, (jnp.arange(total), stacked), unroll=min(_SCAN_UNROLL, total)
    )
    return accs


# ---------------------------------------------------------------------------
# xxh32
# ---------------------------------------------------------------------------

def xxh32(tokens: PaddedTokens | HashLayout, seed: int | jax.Array = 0) -> jax.Array:
    """Exact XXH32 of every token; returns uint32[batch].

    ``seed`` may be an array broadcastable against [batch] (e.g. shape
    [k, 1]) to produce multiseed digests [k, batch] in one pass.
    """
    layout = _as_layout(tokens)
    n = layout.lengths.astype(_U32)
    seed = jnp.asarray(seed, dtype=_U32)
    shape = jnp.broadcast_shapes(seed.shape, n.shape)

    n_stripes = (n // 16).astype(jnp.int32)

    def round_fn(accs, lane, s):
        active = s < n_stripes
        new = tuple(_rotl32(accs[i] + lane[i] * _P32_2, 13) * _P32_1 for i in range(4))
        return tuple(jnp.where(active, new[i], accs[i]) for i in range(4))

    init = (
        jnp.broadcast_to(seed + _P32_1 + _P32_2, shape),
        jnp.broadcast_to(seed + _P32_2, shape),
        jnp.broadcast_to(seed + jnp.uint32(0), shape),
        jnp.broadcast_to(seed - _P32_1, shape),
    )
    a1, a2, a3, a4 = _run_stripes(layout.words_t, n_stripes, init, 4, round_fn)
    h_long = _rotl32(a1, 1) + _rotl32(a2, 7) + _rotl32(a3, 12) + _rotl32(a4, 18)
    h = jnp.where(n >= 16, h_long, seed + _P32_5)
    h = h + n

    # xxh32's tail starts at 16*(n//16): either word 0 or word 4 of the
    # staged 32-byte tail, depending on whether n%32 crossed 16.
    upper_half = (n % 32) >= 16
    tail = jnp.where(upper_half[None, :], layout.tail_t[4:8], layout.tail_t[0:4])
    r = n % 16
    n_words = (r // 4).astype(jnp.int32)
    for k in range(3):
        h = jnp.where(k < n_words, _rotl32(h + tail[k] * _P32_3, 17) * _P32_4, h)
    rem = (r % 4).astype(jnp.int32)
    last = _select_row(tail, n_words)
    for j in range(3):
        byte = (last >> (8 * j)) & jnp.uint32(0xFF)
        h = jnp.where(j < rem, _rotl32(h + byte * _P32_5, 11) * _P32_1, h)

    h = h ^ (h >> 15)
    h = h * _P32_2
    h = h ^ (h >> 13)
    h = h * _P32_3
    h = h ^ (h >> 16)
    return h


# ---------------------------------------------------------------------------
# xxh64
# ---------------------------------------------------------------------------

def _round64(acc: U64, lane: U64) -> U64:
    acc = w.add(acc, w.mul(lane, U64.const(_P64_2)))
    acc = w.rotl(acc, 31)
    return w.mul(acc, U64.const(_P64_1))


def _merge_round(h: U64, acc: U64) -> U64:
    h = w.xor(h, _round64(U64.const(0), acc))
    return w.add(w.mul(h, U64.const(_P64_1)), U64.const(_P64_4))


def _avalanche64(h: U64) -> U64:
    h = w.xor(h, w.shr(h, 33))
    h = w.mul(h, U64.const(_P64_2))
    h = w.xor(h, w.shr(h, 29))
    h = w.mul(h, U64.const(_P64_3))
    h = w.xor(h, w.shr(h, 32))
    return h


def xxh64(tokens: PaddedTokens | HashLayout, seed: int | U64 = 0) -> U64:
    """Exact XXH64 of every token; returns a ``U64`` of uint32[batch] pairs.

    ``seed`` may be a ``U64`` whose limbs broadcast against [batch] (e.g.
    shape [k, 1]) for multiseed digests [k, batch].
    """
    layout = _as_layout(tokens)
    n = layout.lengths.astype(_U32)
    seed = seed if isinstance(seed, U64) else U64.const(seed)
    shape = jnp.broadcast_shapes(seed.hi.shape, n.shape)

    def bcast(v: U64) -> U64:
        return U64(jnp.broadcast_to(v.hi, shape), jnp.broadcast_to(v.lo, shape))

    n_stripes = (n // 32).astype(jnp.int32)

    def round_fn(accs, lane, s):
        active = s < n_stripes
        new = []
        for i in range(4):
            lane_i = U64(hi=lane[2 * i + 1], lo=lane[2 * i])
            new.append(_round64(accs[i], lane_i))
        return tuple(w.where(active, new[i], accs[i]) for i in range(4))

    init = (
        bcast(w.add(seed, U64.const(_P64_1 + _P64_2))),
        bcast(w.add(seed, U64.const(_P64_2))),
        bcast(seed),
        bcast(w.sub(seed, U64.const(_P64_1))),
    )
    accs = _run_stripes(layout.words_t, n_stripes, init, 8, round_fn)
    return _xxh64_epilogue(accs, layout, seed, shape)


def _xxh64_epilogue(accs, layout: HashLayout, seed: U64, shape) -> U64:
    """Merge + tail + avalanche of the xxh64 stripe accumulators."""
    n = layout.lengths.astype(_U32)

    def bcast(v: U64) -> U64:
        return U64(jnp.broadcast_to(v.hi, shape), jnp.broadcast_to(v.lo, shape))

    h_long = w.add_many(
        w.rotl(accs[0], 1), w.rotl(accs[1], 7), w.rotl(accs[2], 12), w.rotl(accs[3], 18)
    )
    for i in range(4):
        h_long = _merge_round(h_long, accs[i])
    h = w.where(n >= 32, h_long, bcast(w.add(seed, U64.const(_P64_5))))

    h = w.add(h, U64.from_u32(n))

    # Tail from the staged block: up to 3 u64 words, one u32, up to 3 bytes.
    tail = layout.tail_t
    r = n % 32
    n_words8 = (r // 8).astype(jnp.int32)
    for k in range(3):
        lane = U64(hi=tail[2 * k + 1], lo=tail[2 * k])
        mixed = w.mul(w.rotl(w.xor(h, _round64(U64.const(0), lane)), 27), U64.const(_P64_1))
        mixed = w.add(mixed, U64.const(_P64_4))
        h = w.where(k < n_words8, mixed, h)

    word4_idx = 2 * n_words8
    has4 = (r % 8) >= 4
    w32 = _select_row(tail, word4_idx)
    mixed = w.xor(h, w.mul(U64.from_u32(w32), U64.const(_P64_1)))
    mixed = w.add(w.mul(w.rotl(mixed, 23), U64.const(_P64_2)), U64.const(_P64_3))
    h = w.where(has4, mixed, h)

    rem = (r % 4).astype(jnp.int32)
    byte_word = _select_row(tail, word4_idx + has4.astype(jnp.int32))
    for j in range(3):
        byte = (byte_word >> (8 * j)) & jnp.uint32(0xFF)
        mixed = w.xor(h, w.mul(U64.from_u32(byte), U64.const(_P64_5)))
        mixed = w.mul(w.rotl(mixed, 11), U64.const(_P64_1))
        h = w.where(j < rem, mixed, h)

    return _avalanche64(h)


def xxh64_multiseed(tokens: PaddedTokens | HashLayout, seeds) -> U64:
    """XXH64 under ``k`` seeds at once: returns U64 limbs of shape [k, batch].

    ``seeds`` is a uint64 numpy array [k]; stripes are read once and
    broadcast across the seed dimension — the multiseed amortization the
    reference's ``hash_multiseed`` demonstrates (``containers/bench.rs:155-187``).
    """
    import numpy as np

    seeds_np = np.asarray(seeds, dtype=np.uint64).reshape(-1, 1)
    seed = U64(
        hi=jnp.asarray((seeds_np >> np.uint64(32)).astype(np.uint32)),
        lo=jnp.asarray((seeds_np & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )
    return xxh64(tokens, seed)


# ---------------------------------------------------------------------------
# Corpus-level tree hash (the data-parallel "streaming" hash)
# ---------------------------------------------------------------------------

TREE_CHUNK = 64 * 1024


@functools.partial(jax.jit, static_argnames=("n",))
def _tree_level(data: jax.Array, n: int) -> U64:
    """xxh64 every TREE_CHUNK-sized piece of ``data[:n]`` (padded, seed=0)."""
    chunks = max(1, -(-n // TREE_CHUNK))
    padded = chunks * TREE_CHUNK
    if data.shape[0] < padded:
        data = jnp.pad(data, (0, padded - data.shape[0]))
    mat = data[:padded].reshape(chunks, TREE_CHUNK)
    lengths = jnp.minimum(
        jnp.maximum(n - jnp.arange(chunks, dtype=jnp.int32) * TREE_CHUNK, 0), TREE_CHUNK
    )
    tokens = PaddedTokens(data=mat, lengths=lengths, width=TREE_CHUNK)
    return xxh64(tokens)


def tree_hash64(data, n: int | None = None) -> int:
    """Deterministic chunked-tree digest of a byte buffer (framework spec).

    Level 0: XXH64(seed=0) of each 64 KiB chunk (last chunk short).
    Level k+1: XXH64(seed=0) of the little-endian u64 digest tape of level k.
    Recurse until one digest remains. A buffer of <= one chunk hashes to
    exactly ``XXH64(data)``, so goldens for small inputs come straight from
    the C library; bigger inputs are covered by a numpy replay of this spec.
    """
    import numpy as np

    data = jnp.asarray(data, dtype=jnp.uint8) if not isinstance(data, jax.Array) else data
    n = int(data.shape[0]) if n is None else n
    while True:
        digests = _tree_level(data, n)
        count = digests.lo.shape[0]
        if count == 1:
            return (int(digests.hi[0]) << 32) | int(digests.lo[0])
        # Digest tape of level k+1 (tiny: count/4096 of the previous level);
        # round-trip through the host — device byte-interleaving would need
        # a layout-hostile [N, 2] u32 stack.
        tape = digests.to_numpy().astype("<u8").tobytes()
        data = jnp.asarray(np.frombuffer(tape, np.uint8))
        n = int(data.shape[0])


# ---------------------------------------------------------------------------
# swh64 — the framework's native fast 64-bit hash (twin u32 lanes)
# ---------------------------------------------------------------------------
#
# swh64 avoids the u64-pair (wideint) round chains, which compile to long
# unfused programs, while xxh32-shaped u32 chains fuse into one pass.
# swh64 is therefore specified as two
# decorrelated xxh32-core computations evaluated in one pass over the
# stripes:
#   lane L: exact xxh32 core, seed = seed_lo
#   lane H: exact xxh32 core over data words XORed with 0x85EBCA77,
#           seed = seed_hi ^ 0x9E3779B9
#   digest = (avalanche32(H + rotl(L, 16) * P32_3) << 32)
#          | avalanche32(L ^ rotl(H, 13) * P32_4)
# The numpy replay in tests is the conformance oracle (like the
# reference's own sz::hash, this is a first-party spec, not an interop
# format; use xxh64/xxh3_64 for interop digests).

_SWH_C = jnp.uint32(0x85EBCA77)
_SWH_GOLD = jnp.uint32(0x9E3779B9)


def _xxh32_core(layout: HashLayout, seed, data_xor) -> jax.Array:
    """The xxh32 algorithm with per-word XOR decorrelation (u32 lanes)."""
    n = layout.lengths.astype(_U32)
    seed = jnp.asarray(seed, dtype=_U32)
    shape = jnp.broadcast_shapes(seed.shape, n.shape)
    n_stripes = (n // 16).astype(jnp.int32)

    def round_fn(accs, lane, s):
        active = s < n_stripes
        new = tuple(
            _rotl32(accs[i] + (lane[i] ^ data_xor) * _P32_2, 13) * _P32_1 for i in range(4)
        )
        return tuple(jnp.where(active, new[i], accs[i]) for i in range(4))

    init = (
        jnp.broadcast_to(seed + _P32_1 + _P32_2, shape),
        jnp.broadcast_to(seed + _P32_2, shape),
        jnp.broadcast_to(seed + jnp.uint32(0), shape),
        jnp.broadcast_to(seed - _P32_1, shape),
    )
    a1, a2, a3, a4 = _run_stripes(layout.words_t, n_stripes, init, 4, round_fn)
    h_long = _rotl32(a1, 1) + _rotl32(a2, 7) + _rotl32(a3, 12) + _rotl32(a4, 18)
    h = jnp.where(n >= 16, h_long, seed + _P32_5)
    h = h + n

    upper_half = (n % 32) >= 16
    tail = jnp.where(upper_half[None, :], layout.tail_t[4:8], layout.tail_t[0:4]) ^ data_xor
    r = n % 16
    n_words = (r // 4).astype(jnp.int32)
    for k in range(3):
        h = jnp.where(k < n_words, _rotl32(h + tail[k] * _P32_3, 17) * _P32_4, h)
    rem = (r % 4).astype(jnp.int32)
    last = _select_row(tail, n_words)
    for j in range(3):
        byte = (last >> (8 * j)) & jnp.uint32(0xFF)
        h = jnp.where(j < rem, _rotl32(h + byte * _P32_5, 11) * _P32_1, h)

    h = h ^ (h >> 15)
    h = h * _P32_2
    h = h ^ (h >> 13)
    h = h * _P32_3
    h = h ^ (h >> 16)
    return h


def _avalanche32(h: jax.Array) -> jax.Array:
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = h * jnp.uint32(0x297A2D39)
    h = h ^ (h >> 15)
    return h


def swh64(tokens: PaddedTokens | HashLayout, seed: int | jax.Array = 0) -> U64:
    """Fast first-party 64-bit hash (see module notes); returns U64[batch].

    ``seed`` may be a uint64 scalar or an array broadcastable against
    [batch] (e.g. numpy uint64 [k, 1] for multiseed digests [k, batch]).
    """
    layout = _as_layout(tokens)
    if isinstance(seed, jax.Array) and seed.dtype == jnp.uint32:
        # Traced u32 seed (jit-friendly): low limb only.
        seed_lo, seed_hi = seed, jnp.uint32(0)
    else:
        import numpy as np

        seed_np = np.asarray(seed, dtype=np.uint64)
        seed_lo = jnp.asarray((seed_np & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        seed_hi = jnp.asarray((seed_np >> np.uint64(32)).astype(np.uint32))
    lane_l = _xxh32_core(layout, seed_lo, jnp.uint32(0))
    lane_h = _xxh32_core(layout, seed_hi ^ _SWH_GOLD, _SWH_C)
    hi = _avalanche32(lane_h + _rotl32(lane_l, 16) * _P32_3)
    lo = _avalanche32(lane_l ^ (_rotl32(lane_h, 13) * _P32_4))
    return U64(hi=hi, lo=lo)


def swh64_multiseed(tokens: PaddedTokens | HashLayout, seeds) -> U64:
    """swh64 under k seeds at once: U64 limbs of shape [k, batch]."""
    import numpy as np

    return swh64(tokens, np.asarray(seeds, np.uint64).reshape(-1, 1))


def swh64_ref(token: bytes, seed: int = 0) -> int:
    """Pure-python replay of the swh64 spec (conformance oracle)."""

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF

    def core(data: bytes, seed32: int, xor: int) -> int:
        P1, P2, P3, P4, P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
        n = len(data)
        if n >= 16:
            acc = [
                (seed32 + P1 + P2) & 0xFFFFFFFF,
                (seed32 + P2) & 0xFFFFFFFF,
                seed32 & 0xFFFFFFFF,
                (seed32 - P1) & 0xFFFFFFFF,
            ]
            p = 0
            while p + 16 <= n:
                for i in range(4):
                    lane = int.from_bytes(data[p + 4 * i : p + 4 * i + 4], "little") ^ xor
                    acc[i] = (rotl((acc[i] + lane * P2) & 0xFFFFFFFF, 13) * P1) & 0xFFFFFFFF
                p += 16
            h = (rotl(acc[0], 1) + rotl(acc[1], 7) + rotl(acc[2], 12) + rotl(acc[3], 18)) & 0xFFFFFFFF
        else:
            h = (seed32 + P5) & 0xFFFFFFFF
            p = 0
        h = (h + n) & 0xFFFFFFFF
        # Tail words come from the zero-padded 4-byte words of the input
        # (matching the device layout's aligned zero-padded reads).
        while p + 4 <= n:
            w4 = int.from_bytes(data[p : p + 4], "little") ^ xor
            h = (rotl((h + w4 * P3) & 0xFFFFFFFF, 17) * P4) & 0xFFFFFFFF
            p += 4
        if p < n:
            w4 = int.from_bytes(data[p:n] + bytes(4 - (n - p)), "little") ^ xor
            for j in range(n - p):
                byte = (w4 >> (8 * j)) & 0xFF
                h = (rotl((h + byte * P5) & 0xFFFFFFFF, 11) * P1) & 0xFFFFFFFF
        h ^= h >> 15
        h = (h * P2) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * P3) & 0xFFFFFFFF
        h ^= h >> 16
        return h

    def avalanche(h):
        h ^= h >> 15
        h = (h * 0x2C1B3C6D) & 0xFFFFFFFF
        h ^= h >> 12
        h = (h * 0x297A2D39) & 0xFFFFFFFF
        h ^= h >> 15
        return h

    lane_l = core(token, seed & 0xFFFFFFFF, 0)
    lane_h = core(token, ((seed >> 32) ^ 0x9E3779B9) & 0xFFFFFFFF, 0x85EBCA77)
    hi = avalanche((lane_h + rotl(lane_l, 16) * 3266489917) & 0xFFFFFFFF)
    lo = avalanche(lane_l ^ ((rotl(lane_h, 13) * 668265263) & 0xFFFFFFFF))
    return (hi << 32) | lo


