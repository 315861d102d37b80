"""Aho-Corasick multi-pattern matching (kernel family K2).

The reference benchmarks aho-corasick DFAs for byteset/multi-pattern scans
(``find/bench.rs:226-348``, pyahocorasick ``find/bench.py:118-123``).
BASELINE.json names the design explicitly: host-built goto/fail
transition table, replicated to the device, run as an int32 gather chain.

Construction runs in the native C++ runtime (``native.ac_build``: trie +
BFS fail links compressed into a dense DFA with fail-accumulated output
counts). The device scan exploits an exact chunk-parallel decomposition:
the AC state after any prefix is a function of only the last
``maxlen - 1`` bytes (the state is the longest pattern-prefix suffix), so
the haystack is cut into chunks that re-derive their entry state from a
``maxlen - 1``-byte overlap and then count matches independently — one
``lax.scan`` over intra-chunk positions with all chunks riding the vector
lanes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.native import ac_build, ac_count_host

# Default chunk streams for ``stage_rows``: enough parallel DFA walks to
# fill the device, each a short scan.
_AC_STREAMS = 1 << 18


class Automaton:
    """A built AC automaton (dense DFA) ready for device scans."""

    def __init__(self, patterns: list[bytes]):
        if not patterns:
            raise ValueError("need at least one pattern")
        if any(len(p) == 0 for p in patterns):
            raise ValueError("empty patterns not allowed")
        built = ac_build(patterns)
        if built is None:
            raise RuntimeError("native AC builder unavailable")
        delta, out_count = built
        self.patterns = patterns
        self.max_len = max(len(p) for p in patterns)
        self.states = delta.shape[0]
        self.delta_flat = jnp.asarray(delta.reshape(-1))
        self.out_count = jnp.asarray(out_count)

    def count_host(self, data: np.ndarray) -> int:
        """Sequential native scan (oracle / baseline variant)."""
        ac_build(self.patterns)  # re-arm the thread-local builder
        return ac_count_host(np.asarray(data, np.uint8))


@functools.partial(jax.jit, static_argnames=("n", "chunk"))
def _ac_scan(delta_flat, out_count, rows, gpos0, n: int, chunk: int):
    """rows: [C, overlap + chunk] bytes; gpos0: [C] global pos of row start.

    The scan walks byte columns of the transposed rows, so each step reads
    one contiguous [C] slice and gathers C transitions from the table."""
    c_count, row_w = rows.shape
    overlap = row_w - chunk
    states = jnp.zeros((c_count,), jnp.int32)
    counts = jnp.zeros((c_count,), jnp.int32)

    def body(carry, xs):
        states, counts = carry
        col, p = xs
        byte = col.astype(jnp.int32)
        gpos = gpos0 + p
        valid = (gpos >= 0) & (gpos < n)
        nxt = jnp.take(delta_flat, states * 256 + byte)
        states = jnp.where(valid, nxt, states)
        hits = jnp.take(out_count, states)
        counts = counts + jnp.where(valid & (p >= overlap), hits, 0)
        return (states, counts), None

    (states, counts), _ = jax.lax.scan(
        body, (states, counts), (rows.T, jnp.arange(row_w, dtype=jnp.int32))
    )
    return jnp.sum(counts, dtype=jnp.int32)


def ac_count(automaton: Automaton, hay, n: int | None = None, *, chunk: int | None = None) -> int:
    """Total occurrences of all patterns in ``hay[:n]`` (device scan)."""
    hay_np = np.asarray(hay, np.uint8)
    n = int(hay_np.shape[0]) if n is None else n
    rows_dev, gpos0, chunk = stage_rows(hay_np, n, automaton.max_len, chunk)
    return int(ac_count_staged(automaton, rows_dev, gpos0, n, chunk))


def stage_rows(
    hay_np: np.ndarray, n: int, max_len: int, chunk: int | None = None
) -> tuple[jax.Array, jax.Array, int]:
    """Device-stage the chunked haystack rows once (benches reuse them)."""
    if chunk is None:
        chunk = max(64, -(-n // _AC_STREAMS))
    overlap = max_len - 1
    c_count = max((n + chunk - 1) // chunk, 1)
    buf = np.zeros(c_count * chunk + overlap, np.uint8)
    buf[overlap : overlap + n] = hay_np[:n]
    rows = np.lib.stride_tricks.sliding_window_view(buf, chunk + overlap)[::chunk][:c_count]
    rows_dev = jnp.asarray(np.ascontiguousarray(rows))
    gpos0 = jnp.asarray(np.arange(c_count, dtype=np.int32) * chunk - overlap)
    return rows_dev, gpos0, chunk


def ac_count_staged(automaton: Automaton, rows_dev, gpos0, n: int, chunk: int) -> jax.Array:
    """Scan pre-staged rows (stage_rows); returns a device scalar count."""
    return _ac_scan(automaton.delta_flat, automaton.out_count, rows_dev, gpos0, n, chunk)
