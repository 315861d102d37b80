"""The token tape — the framework's central data structure (kernel family K14).

A ``Tape`` is the device analog of the reference's zero-copy string tape
(stringtape ``BytesCowsAuto`` / ``sz.Strs``, used everywhere: reference
``utils.rs:265``, ``similarities/bench.rs:292-307``): a flat ``uint8`` byte
buffer plus an ``int32`` offsets array delimiting ``count`` tokens. Unlike the
reference's pointer-chasing CPU layout, the tape is designed for XLA: the byte
buffer is padded to a lane-aligned length, offsets are a dense prefix array so
any "which token owns byte i" query is a ``searchsorted``, and the whole
structure is a registered pytree that can be donated to jit functions and
sharded over a device mesh on the byte or the token axis.

For batched per-token kernels (hashing, edit distances, fingerprints) the tape
is reshaped once into ``PaddedTokens`` — a ``[batch, padded_len]`` uint8 matrix
with explicit lengths — because batched kernels want rectangular arrays; the padded
width is chosen per-bucket from the corpus length histogram, the same histogram
the reference logs at load time (``utils.rs:372-398``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

# Alignment quantum for flat byte buffers (keeps word reshapes exact).
BYTE_ALIGN = 4 * 1024

_ASCII_WS = np.array([9, 10, 11, 12, 13, 32], dtype=np.uint8)


def _pad_to(n: int, quantum: int) -> int:
    return ((n + quantum - 1) // quantum) * quantum


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Tape:
    """Flat token tape: ``data[offsets[i]:offsets[i+1]]`` is token ``i``.

    ``data`` is padded with zeros past ``total_bytes``; ``count`` and
    ``total_bytes`` are static (Python ints) so shapes stay compile-time
    constants under ``jit``.
    """

    data: jax.Array  # uint8[padded_n]
    offsets: jax.Array  # int32[count + 1]
    count: int
    total_bytes: int

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.data, self.offsets), (self.count, self.total_bytes)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, offsets = children
        count, total_bytes = aux
        return cls(data=data, offsets=offsets, count=count, total_bytes=total_bytes)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_numpy(cls, data: np.ndarray, offsets: np.ndarray, *, device=None) -> "Tape":
        """Wrap host arrays (uint8 bytes, int-like offsets) into a device tape."""
        total = int(offsets[-1])
        padded = _pad_to(max(total, 1), BYTE_ALIGN)
        if data.shape[0] != padded:
            buf = np.zeros(padded, dtype=np.uint8)
            buf[:total] = data[:total]
            data = buf
        put = (lambda x: jax.device_put(x, device)) if device is not None else jnp.asarray
        return cls(
            data=put(data),
            offsets=put(offsets.astype(np.int32)),
            count=int(offsets.shape[0]) - 1,
            total_bytes=total,
        )

    @classmethod
    def from_tokens(cls, tokens: Sequence[bytes], *, device=None) -> "Tape":
        """Build a tape from a Python list of byte strings (tests / small inputs)."""
        lengths = np.fromiter((len(t) for t in tokens), dtype=np.int64, count=len(tokens))
        offsets = np.zeros(len(tokens) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        data = np.frombuffer(b"".join(tokens), dtype=np.uint8) if tokens else np.zeros(0, np.uint8)
        return cls.from_numpy(data, offsets, device=device)

    @classmethod
    def from_buffer(
        cls,
        buffer: bytes | np.ndarray,
        mode: str = "lines",
        *,
        max_tokens: int | None = None,
        unique: bool = False,
        device=None,
    ) -> "Tape":
        """Tokenize a corpus buffer into a tape, fully vectorized on the host.

        ``mode`` follows the reference's granularities (``utils.py:430-446``):
        ``lines`` splits on LF, ``words`` on ASCII whitespace runs (empty
        tokens dropped, like ``str.split()``), ``file`` is one giant token.
        """
        raw = np.frombuffer(buffer, dtype=np.uint8) if isinstance(buffer, (bytes, bytearray, memoryview)) else np.ascontiguousarray(buffer, dtype=np.uint8)
        starts, ends = token_spans(raw, mode)
        if max_tokens is not None and starts.shape[0] > max_tokens:
            starts, ends = starts[:max_tokens], ends[:max_tokens]
        if unique and mode != "file":
            starts, ends = _dedup_spans(raw, starts, ends)
        return cls.from_spans(raw, starts, ends, device=device)

    @classmethod
    def from_spans(cls, raw: np.ndarray, starts: np.ndarray, ends: np.ndarray, *, device=None) -> "Tape":
        """Compact (start, end) spans over ``raw`` into a contiguous tape."""
        lengths = (ends - starts).astype(np.int64)
        offsets = np.zeros(lengths.shape[0] + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        total = int(offsets[-1])
        # Gather all spans with one fancy-index: destination index = prefix + intra-token index.
        data = np.zeros(_pad_to(max(total, 1), BYTE_ALIGN), dtype=np.uint8)
        if total:
            dst = np.arange(total, dtype=np.int64)
            token_of = np.searchsorted(offsets[1:], dst, side="right")
            src = starts[token_of] + (dst - offsets[token_of])
            data[:total] = raw[src]
        return cls.from_numpy(data, offsets, device=device)

    # -- views -------------------------------------------------------------
    @property
    def lengths(self) -> jax.Array:
        return self.offsets[1:] - self.offsets[:-1]

    def token_bytes(self, i: int) -> bytes:
        """Host-side materialization of token ``i`` (tests / debugging)."""
        o = np.asarray(self.offsets)
        return np.asarray(self.data)[o[i] : o[i + 1]].tobytes()

    def to_list(self) -> list[bytes]:
        o = np.asarray(self.offsets)
        d = np.asarray(self.data)
        return [d[o[i] : o[i + 1]].tobytes() for i in range(self.count)]

    def subtape(self, lo: int, hi: int) -> "Tape":
        """Host-side slice of tokens [lo, hi) into a fresh compact tape."""
        o = np.asarray(self.offsets).astype(np.int64)
        d = np.asarray(self.data)
        starts, ends = o[lo:hi], o[lo + 1 : hi + 1]
        return Tape.from_spans(d, starts, ends)


def pack_u32(data: jax.Array) -> jax.Array:
    """LE u32 words from a uint8 array (last axis length divisible by 4),
    via strided slices."""
    b0 = data[..., 0::4].astype(jnp.uint32)
    b1 = data[..., 1::4].astype(jnp.uint32)
    b2 = data[..., 2::4].astype(jnp.uint32)
    b3 = data[..., 3::4].astype(jnp.uint32)
    return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)


def token_spans(raw: np.ndarray, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) spans for tokens of ``raw`` under ``mode`` — pure numpy."""
    n = raw.shape[0]
    if mode == "file":
        return np.array([0], np.int64), np.array([n], np.int64)
    if mode == "lines":
        # Split on LF; like bytes.split(b"\n") this keeps empty lines.
        newline_at = np.flatnonzero(raw == 0x0A).astype(np.int64)
        starts = np.concatenate(([0], newline_at + 1))
        ends = np.concatenate((newline_at, [n]))
        return starts, ends
    if mode == "words":
        # ASCII-whitespace runs delimit words; empties dropped (str.split semantics).
        is_ws = np.isin(raw, _ASCII_WS)
        edges = np.diff(is_ws.astype(np.int8), prepend=1, append=1)
        starts = np.flatnonzero(edges == -1).astype(np.int64)
        ends = np.flatnonzero(edges == 1).astype(np.int64)
        return starts, ends
    raise ValueError(f"Unknown tokens mode: {mode!r}; use 'lines', 'words', or 'file'")


def _dedup_spans(raw: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Order-preserving token dedup (reference ``utils.py:449``), hashed on host."""
    seen: dict[bytes, None] = {}
    keep = np.zeros(starts.shape[0], dtype=bool)
    view = raw.tobytes()  # one copy; slicing bytes is cheap C memcmp-able keys
    for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        key = view[s:e]
        if key not in seen:
            seen[key] = None
            keep[i] = True
    return starts[keep], ends[keep]


# ---------------------------------------------------------------------------
# PaddedTokens: rectangular [batch, width] view for batched per-token kernels
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class PaddedTokens:
    """``[count, width]`` uint8 matrix of zero-padded tokens plus lengths.

    ``width`` is static and always a multiple of 4 so the matrix can be
    bitcast to little-endian uint32 words (``as_u32``) — the layout every
    word-at-a-time kernel (hashing, rolling n-grams) consumes.
    """

    data: jax.Array  # uint8[count, width]
    lengths: jax.Array  # int32[count]
    width: int

    def tree_flatten(self):
        return (self.data, self.lengths), (self.width,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, lengths = children
        return cls(data=data, lengths=lengths, width=aux[0])

    @property
    def count(self) -> int:
        return self.data.shape[0]

    def as_u32(self) -> jax.Array:
        """Little-endian uint32 view, shape ``[count, width // 4]``.

        Built from four strided byte slices (b0 | b1<<8 | b2<<16 | b3<<24).
        """
        return pack_u32(self.data)

    @classmethod
    def from_tape(
        cls,
        tape: Tape,
        *,
        width: int | None = None,
        align: int = 64,
        max_width: int | None = None,
        device=None,
    ) -> "PaddedTokens":
        """Pad every token of ``tape`` to a common width (host-side reshape).

        Tokens longer than ``max_width`` (if set) are truncated — callers that
        need exactness must bucket instead (``bucket_by_length``).
        """
        o = np.asarray(tape.offsets).astype(np.int64)
        d = np.asarray(tape.data)
        lengths = o[1:] - o[:-1]
        natural = int(lengths.max()) if lengths.size else 1
        w = width if width is not None else natural
        if max_width is not None:
            w = min(w, max_width)
        w = max(_pad_to(max(w, 1), align), align)
        clamped = np.minimum(lengths, w)
        count = lengths.shape[0]
        mat = np.zeros((count, w), dtype=np.uint8)
        if count and int(clamped.sum()):
            flat_dst = np.arange(int(clamped.sum()), dtype=np.int64)
            cum = np.zeros(count + 1, np.int64)
            np.cumsum(clamped, out=cum[1:])
            token_of = np.searchsorted(cum[1:], flat_dst, side="right")
            intra = flat_dst - cum[token_of]
            mat[token_of, intra] = d[o[token_of] + intra]
        put = (lambda x: jax.device_put(x, device)) if device is not None else jnp.asarray
        return cls(data=put(mat), lengths=put(clamped.astype(np.int32)), width=w)


def bucket_by_length(tape: Tape, edges: Sequence[int], *, align: int = 64) -> list[PaddedTokens]:
    """Split a tape into per-length-bucket ``PaddedTokens`` (no truncation).

    ``edges`` are inclusive upper bounds per bucket; a final bucket catches
    everything longer. Bucketing replaces the reference's pointer-chasing
    variable-length loops with a handful of rectangular kernels — the length
    histogram the loader prints is the tool for choosing ``edges``.
    """
    o = np.asarray(tape.offsets).astype(np.int64)
    lengths = o[1:] - o[:-1]
    buckets: list[PaddedTokens] = []
    bounds = list(edges) + [max(int(lengths.max(initial=1)), (edges[-1] if edges else 0) + 1)]
    lo = 0
    d = np.asarray(tape.data)
    for hi in bounds:
        mask = (lengths > lo) & (lengths <= hi)
        idx = np.flatnonzero(mask)
        if idx.size:
            sub = Tape.from_spans(d, o[idx], o[idx + 1])
            buckets.append(PaddedTokens.from_tape(sub, align=align))
        lo = hi
    return buckets
