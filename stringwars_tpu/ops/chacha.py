"""ChaCha20-Poly1305 AEAD (kernel family K13, RFC 8439).

The reference benchmarks AEAD keygen/encrypt/decrypt via ring/openssl/
libsodium (``encryption/bench.rs``). The on-device cipher is ChaCha20 —
pure 32-bit add-rotate-xor, which XLA fuses into elementwise kernels
(SURVEY.md K13) — with Poly1305 as the authenticator.

Parallel structure:
- **ChaCha20**: every 64-byte block's state differs only in the counter
  word, so the whole keystream is one batched kernel over ``[blocks, 16]``
  u32 lanes; 20 rounds unrolled, no memory traffic between rounds.
- **Poly1305**: the sequential Horner form ``a = (a + c_i) * r`` is
  restructured as ``tag = sum_i c_i * r^(n-i+1) mod (2^130 - 5)``: the
  needed powers of r are computed host-side with Python bigints (they
  depend only on the key and length), and the device does the per-block
  130-bit multiply in ten 13-bit limbs (13x13 products fit u32 exactly)
  followed by a carry-propagated tree reduction. Final fold to 128 bits is
  host-side bigint (a few words).

Conformance: byte-exact against the ``cryptography`` library's
ChaCha20Poly1305 (OpenSSL) in tests, including RFC 8439 test vectors.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_P1305 = (1 << 130) - 5
_LIMBS = 10  # 13-bit limbs
_LIMB_BITS = 13
_LIMB_MASK = (1 << _LIMB_BITS) - 1


# ---------------------------------------------------------------------------
# ChaCha20
# ---------------------------------------------------------------------------

def _quarter(a, b, c, d):
    a = a + b
    d = d ^ a
    d = (d << 16) | (d >> 16)
    c = c + d
    b = b ^ c
    b = (b << 12) | (b >> 20)
    a = a + b
    d = d ^ a
    d = (d << 8) | (d >> 24)
    c = c + d
    b = b ^ c
    b = (b << 7) | (b >> 25)
    return a, b, c, d


@functools.partial(jax.jit, static_argnames=("n_blocks",))
def _keystream(key8: jax.Array, nonce3: jax.Array, counter0: jax.Array, n_blocks: int) -> jax.Array:
    """[n_blocks, 16] u32 keystream words, counters counter0 + i."""
    counters = counter0 + jnp.arange(n_blocks, dtype=jnp.uint32)
    consts = jnp.asarray(
        np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], np.uint32)
    )
    state = [jnp.broadcast_to(consts[i], (n_blocks,)) for i in range(4)]
    state += [jnp.broadcast_to(key8[i], (n_blocks,)) for i in range(8)]
    state += [counters]
    state += [jnp.broadcast_to(nonce3[i], (n_blocks,)) for i in range(3)]
    x = list(state)
    for _ in range(10):
        x[0], x[4], x[8], x[12] = _quarter(x[0], x[4], x[8], x[12])
        x[1], x[5], x[9], x[13] = _quarter(x[1], x[5], x[9], x[13])
        x[2], x[6], x[10], x[14] = _quarter(x[2], x[6], x[10], x[14])
        x[3], x[7], x[11], x[15] = _quarter(x[3], x[7], x[11], x[15])
        x[0], x[5], x[10], x[15] = _quarter(x[0], x[5], x[10], x[15])
        x[1], x[6], x[11], x[12] = _quarter(x[1], x[6], x[11], x[12])
        x[2], x[7], x[8], x[13] = _quarter(x[2], x[7], x[8], x[13])
        x[3], x[4], x[9], x[14] = _quarter(x[3], x[4], x[9], x[14])
    out = [x[i] + state[i] for i in range(16)]
    return jnp.stack(out, axis=1)


def _key_words(key: bytes) -> jax.Array:
    return jnp.asarray(np.frombuffer(key, "<u4"))


@functools.partial(jax.jit, static_argnames=("n_blocks",))
def _xor_keystream_u32(data_u32, key8, nonce3, counter, n_blocks: int):
    ks = _keystream(key8, nonce3, counter, n_blocks).reshape(-1)
    return data_u32 ^ ks[: data_u32.shape[0]]


def chacha20_xor(key: bytes, nonce: bytes, data, counter: int = 1) -> np.ndarray:
    """XOR ``data`` with the ChaCha20 keystream (encrypt == decrypt).

    Device compute stays in u32 lanes; the result is returned as host
    bytes. The block count rounds up to a power of two, so messages of
    similar lengths share one compiled program (the extra keystream
    blocks are discarded).
    """
    data_np = np.asarray(data, np.uint8)
    n = data_np.shape[0]
    n_blocks = 1 << (max((n + 63) // 64, 1) - 1).bit_length()
    padded = np.zeros(n_blocks * 64, np.uint8)
    padded[:n] = data_np
    data_u32 = jnp.asarray(padded.view("<u4"))
    out = _xor_keystream_u32(
        data_u32,
        _key_words(key),
        jnp.asarray(np.frombuffer(nonce, "<u4")),
        jnp.uint32(counter),
        n_blocks,
    )
    return np.asarray(out).view(np.uint8)[:n]


# ---------------------------------------------------------------------------
# Poly1305
# ---------------------------------------------------------------------------

def _to_limbs_np(values: list[int]) -> np.ndarray:
    out = np.zeros((len(values), _LIMBS), np.uint32)
    for i, v in enumerate(values):
        for j in range(_LIMBS):
            out[i, j] = (v >> (13 * j)) & _LIMB_MASK
    return out


def _from_limbs_np(limbs: np.ndarray) -> int:
    return sum(int(x) << (13 * j) for j, x in enumerate(limbs))


_CHUNK = 4096  # blocks per device chunk (one shared power table)


@functools.partial(jax.jit, static_argnames=("n_chunks",))
def _poly_chunk_partials(blocks: jax.Array, rpowers: jax.Array, n_chunks: int):
    """Per-chunk sums P_c = sum_t blocks[c, t] * rpowers[t].

    ``blocks``: [n_chunks * _CHUNK, 10] canonical 13-bit limbs;
    ``rpowers``: [_CHUNK, 10] limbs of r^_CHUNK .. r^1.
    Returns [n_chunks, 20] u32 extended limbs (values < 2^26, u32-safe:
    per-block products are carry-propagated to <2^14 limbs, then summed
    over _CHUNK=2^12 blocks -> < 2^26).
    """
    b = blocks.reshape(n_chunks, _CHUNK, _LIMBS).astype(jnp.uint32)
    p = rpowers.astype(jnp.uint32)[None, :, :]
    cols = []
    for k in range(2 * _LIMBS - 1):
        acc = jnp.zeros((n_chunks, _CHUNK), jnp.uint32)
        for i in range(max(0, k - _LIMBS + 1), min(_LIMBS, k + 1)):
            acc = acc + b[:, :, i] * p[:, :, k - i]
        cols.append(acc)
    cols.append(jnp.zeros_like(cols[0]))
    prod = jnp.stack(cols, axis=2)  # [C, K, 20], entries < 10 * 2^26 < 2^30
    for _ in range(3):
        carry = prod >> _LIMB_BITS
        prod = (prod & _LIMB_MASK) + jnp.pad(carry, ((0, 0), (0, 0), (1, 0)))[:, :, : 2 * _LIMBS]
    return jnp.sum(prod, axis=1, dtype=jnp.uint32)  # [C, 20] < 2^14 * 2^12


def limbs_from_u32(blocks_u32: jax.Array, full: jax.Array) -> jax.Array:
    """Device twin of ``_blocks_to_limbs`` for whole-block messages.

    ``blocks_u32``: [n_blocks, 4] little-endian ciphertext words;
    ``full``: bool/int [n_blocks] — 1 adds the 0x01 bit at position 128
    (all-16-byte blocks; the padded-tail variant stays host-side).
    Returns [n_blocks, 10] 13-bit limbs. Enables the chained-loop AEAD
    rows: the Poly1305 block conversion runs on device so the whole
    keystream→MAC pipeline sits inside one fori_loop body.
    """
    w = blocks_u32.astype(jnp.uint32)
    limbs = []
    for j in range(_LIMBS):
        start = 13 * j
        k, off = divmod(start, 32)
        if k < 4:
            bits = w[:, k] >> jnp.uint32(off)
            if off + 13 > 32:
                nxt = w[:, k + 1] if k + 1 < 4 else full.astype(jnp.uint32)
                bits = bits | (nxt << jnp.uint32(32 - off))
        else:
            bits = full.astype(jnp.uint32)
        limbs.append(bits & jnp.uint32(_LIMB_MASK))
    return jnp.stack(limbs, axis=1)


def _blocks_to_limbs(msg: np.ndarray) -> tuple[np.ndarray, int]:
    """Vectorized 16-byte-block -> 10x13-bit-limb conversion (+0x01 pad bit)."""
    n = msg.shape[0]
    n_blocks = (n + 15) // 16
    padded = np.zeros(n_blocks * 16 + 16, np.uint8)
    padded[:n] = msg
    if n % 16:
        padded[n] = 1  # 0x01 terminator inside the partial block
    words = padded[: n_blocks * 16].reshape(n_blocks, 16).view("<u4").astype(np.uint64)
    w64 = np.zeros((n_blocks, 3), np.uint64)
    w64[:, 0] = words[:, 0] | (words[:, 1] << np.uint64(32))
    w64[:, 1] = words[:, 2] | (words[:, 3] << np.uint64(32))
    full = np.arange(1, n_blocks + 1) * 16 <= n
    w64[:, 2] = full.astype(np.uint64)  # the 0x01 bit at position 128
    limbs = np.zeros((n_blocks, _LIMBS), np.uint32)
    for j in range(_LIMBS):
        start = 13 * j
        w, off = divmod(start, 64)
        bits = w64[:, w] >> np.uint64(off)
        if off + 13 > 64:
            bits |= w64[:, w + 1] << np.uint64(64 - off)
        limbs[:, j] = (bits & np.uint64(_LIMB_MASK)).astype(np.uint32)
    return limbs, n_blocks


@functools.lru_cache(maxsize=8)
def _r_power_limbs(r: int) -> tuple:
    """(rpowers limbs [K,10] for r^K..r^1, r^K) — host bigints, key-cached."""
    powers = [0] * _CHUNK
    acc = 1
    for t in range(_CHUNK - 1, -1, -1):
        acc = (acc * r) % _P1305
        powers[t] = acc  # powers[t] = r^(K - t)
    return _to_limbs_np(powers), acc  # acc = r^K


def poly1305_tag(key32: bytes, message: bytes | np.ndarray) -> bytes:
    """Poly1305 MAC (r||s = key32) over ``message``."""
    msg = np.frombuffer(message, np.uint8) if isinstance(message, (bytes, bytearray)) else np.asarray(message, np.uint8)
    r = int.from_bytes(key32[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:32], "little")
    n = msg.shape[0]
    if n == 0:
        return (s % (1 << 128)).to_bytes(16, "little")
    limbs, n_blocks = _blocks_to_limbs(msg)
    n_chunks = (n_blocks + _CHUNK - 1) // _CHUNK
    rpowers_np, _ = _r_power_limbs(r)
    # Right-align the final (partial) chunk so its last block lines up with
    # power r^1 (rpowers[-1]); zero blocks contribute nothing.
    stacked = np.zeros((n_chunks * _CHUNK, _LIMBS), np.uint32)
    n_full = (n_blocks // _CHUNK) * _CHUNK
    stacked[:n_full] = limbs[:n_full]
    tail = n_blocks - n_full
    if tail:
        stacked[n_chunks * _CHUNK - tail :] = limbs[n_full:]
    partials = np.asarray(
        _poly_chunk_partials(jnp.asarray(stacked), jnp.asarray(rpowers_np), n_chunks)
    )
    # Host combine: total = sum_c P_c * r^(n_blocks - end_c), where end_c is
    # the index of the block aligned with r^1 in chunk c.
    total = 0
    for c in range(n_chunks):
        p_c = sum(int(x) << (13 * j) for j, x in enumerate(partials[c]))
        end_c = (c + 1) * _CHUNK if c < n_chunks - 1 else n_blocks
        total = (total + p_c * pow(r, n_blocks - end_c, _P1305)) % _P1305
    tag = (total % _P1305 + s) % (1 << 128)
    return tag.to_bytes(16, "little")


# ---------------------------------------------------------------------------
# AEAD (RFC 8439 construction)
# ---------------------------------------------------------------------------

def _pad16(b: bytes) -> bytes:
    return b + bytes(-len(b) % 16)


def aead_encrypt(key: bytes, nonce: bytes, plaintext, aad: bytes = b"") -> tuple[np.ndarray, bytes]:
    """ChaCha20-Poly1305 seal: returns (ciphertext array, 16-byte tag)."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("key must be 32 bytes, nonce 12 bytes")
    pt = np.frombuffer(plaintext, np.uint8) if isinstance(plaintext, (bytes, bytearray)) else np.asarray(plaintext, np.uint8)
    otk = (
        np.asarray(
            _keystream(
                _key_words(key), jnp.asarray(np.frombuffer(nonce, "<u4")), jnp.uint32(0), 1
            )
        )
        .view(np.uint8)[:32]
    )
    ct = chacha20_xor(key, nonce, pt, counter=1)
    mac_data = (
        _pad16(aad)
        + _pad16(ct.tobytes())
        + len(aad).to_bytes(8, "little")
        + len(ct).to_bytes(8, "little")
    )
    tag = poly1305_tag(otk.tobytes(), mac_data)
    return ct, tag


def _hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """HChaCha20 subkey derivation (draft-irtf-cfrg-xchacha §2.2).

    20 ChaCha rounds over (consts, key, nonce16) with NO final feed-forward
    add; the subkey is words 0-3 and 12-15. Host-side u64 numpy scalars
    (one 16-word state — not worth a device dispatch)."""
    mask = np.uint64(0xFFFFFFFF)

    def rotl(v, r):
        return ((v << np.uint64(r)) | (v >> np.uint64(32 - r))) & mask

    x = np.zeros(16, np.uint64)
    x[:4] = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
    x[4:12] = np.frombuffer(key, "<u4").astype(np.uint64)
    x[12:16] = np.frombuffer(nonce16, "<u4").astype(np.uint64)

    def quarter(a, b, c, d):
        x[a] = (x[a] + x[b]) & mask
        x[d] = rotl(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & mask
        x[b] = rotl(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & mask
        x[d] = rotl(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & mask
        x[b] = rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        quarter(0, 4, 8, 12)
        quarter(1, 5, 9, 13)
        quarter(2, 6, 10, 14)
        quarter(3, 7, 11, 15)
        quarter(0, 5, 10, 15)
        quarter(1, 6, 11, 12)
        quarter(2, 7, 8, 13)
        quarter(3, 4, 9, 14)
    out = np.concatenate([x[:4], x[12:16]]).astype(np.uint32)
    return out.astype("<u4").tobytes()


def xchacha_aead_encrypt(
    key: bytes, nonce24: bytes, plaintext, aad: bytes = b""
) -> tuple[np.ndarray, bytes]:
    """XChaCha20-Poly1305 seal: 192-bit nonce via HChaCha20 subkey (the
    reference's third AEAD, encryption/bench.rs:87-125)."""
    if len(key) != 32 or len(nonce24) != 24:
        raise ValueError("key must be 32 bytes, nonce 24 bytes")
    subkey = _hchacha20(key, nonce24[:16])
    return aead_encrypt(subkey, bytes(4) + nonce24[16:], plaintext, aad)


def xchacha_aead_decrypt(
    key: bytes, nonce24: bytes, ciphertext, tag: bytes, aad: bytes = b""
) -> np.ndarray:
    """XChaCha20-Poly1305 open: raises on tag mismatch."""
    if len(key) != 32 or len(nonce24) != 24:
        raise ValueError("key must be 32 bytes, nonce 24 bytes")
    subkey = _hchacha20(key, nonce24[:16])
    return aead_decrypt(subkey, bytes(4) + nonce24[16:], ciphertext, tag, aad)


def aead_decrypt(key: bytes, nonce: bytes, ciphertext, tag: bytes, aad: bytes = b"") -> np.ndarray:
    """ChaCha20-Poly1305 open: returns plaintext; raises on tag mismatch."""
    ct = np.frombuffer(ciphertext, np.uint8) if isinstance(ciphertext, (bytes, bytearray)) else np.asarray(ciphertext, np.uint8)
    otk = (
        np.asarray(
            _keystream(
                _key_words(key), jnp.asarray(np.frombuffer(nonce, "<u4")), jnp.uint32(0), 1
            )
        )
        .view(np.uint8)[:32]
    )
    mac_data = (
        _pad16(aad)
        + _pad16(ct.tobytes())
        + len(aad).to_bytes(8, "little")
        + len(ct).to_bytes(8, "little")
    )
    expect = poly1305_tag(otk.tobytes(), mac_data)
    import hmac

    if not hmac.compare_digest(expect, tag):
        raise ValueError("authentication tag mismatch")
    return chacha20_xor(key, nonce, ct, counter=1)
