"""Edit distances & alignment scores via anti-diagonal wavefront DP (K5).

The reference's heaviest kernels: batched Levenshtein (uniform costs),
Needleman-Wunsch global and Smith-Waterman local scores with linear or
affine gaps, over dense query x candidate cross-products
(``similarities/bench.rs:269-1026``; CUPS metric = DP cells / second).

Design:
- **Batch x diagonal layout.** All pairs are padded to a common char width
  ``L``; the DP runs one ``lax.scan`` over the 2L anti-diagonals, carrying
  two (three for affine) ``[batch, L+1]`` diagonals. Every step is dense
  elementwise min/max-plus algebra on the batch x diagonal plane — no
  gathers, no data-dependent control flow.
- **Cost zones instead of per-pair shapes.** Cells beyond a pair's true
  lengths (i > |a| or j > |b|) get *free* moves in the propagation
  direction and *forbidden* (±BIG) moves otherwise, so the true answer
  D[|a|][|b|] replicates to the fixed corner D[L][L] — one static read per
  pair, regardless of length mix (the monotone-row/column property
  guarantees the free path dominates; see tests vs a brute-force DP).
- Characters are int32, so byte-level and Unicode-codepoint-level
  (``levenshtein_utf8`` analog) distances share one kernel; class-folded
  substitution (reference's ``byte % 32`` table) is a caller-side map.

Work accounting: ``dp_cells(a_len, b_len)`` = true |a|*|b| cells per pair,
matching the reference's aggregate-CUPS bookkeeping
(``similarities/bench.rs:216-224``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.int32(1 << 20)


class PairBatch(NamedTuple):
    """A batch of sequence pairs, padded to a common width L."""

    a: jax.Array  # int32[B, L]  (character codes; junk past a_len)
    b: jax.Array  # int32[B, L]
    a_len: jax.Array  # int32[B]
    b_len: jax.Array  # int32[B]

    @property
    def width(self) -> int:
        return self.a.shape[1]

    def dp_cells(self) -> int:
        return int(
            np.sum(np.asarray(self.a_len, np.int64) * np.asarray(self.b_len, np.int64))
        )


def pack_pairs(a_tokens: list[bytes], b_tokens: list[bytes], width: int | None = None) -> PairBatch:
    """Host-side staging of byte-string pairs into a PairBatch."""
    if len(a_tokens) != len(b_tokens):
        raise ValueError("pair lists must have equal length")
    L = width or max((max(len(t) for t in a_tokens), max(len(t) for t in b_tokens)), default=1)
    L = max(L, 1)
    B = len(a_tokens)
    a = np.zeros((B, L), dtype=np.int32)
    b = np.zeros((B, L), dtype=np.int32)
    a_len = np.zeros(B, dtype=np.int32)
    b_len = np.zeros(B, dtype=np.int32)
    for i, (x, y) in enumerate(zip(a_tokens, b_tokens)):
        a[i, : len(x)] = np.frombuffer(x, np.uint8)
        b[i, : len(y)] = np.frombuffer(y, np.uint8)
        a_len[i], b_len[i] = len(x), len(y)
    return PairBatch(jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_len), jnp.asarray(b_len))


def _diag_frames(pairs: PairBatch):
    """Per-diagonal windows: returns (ap, brp, i_idx, L).

    ``ap[:, i] = a[i-1]`` (the diagonal's a-char at row i); the b-window for
    diagonal d is ``brp[:, 2L-d+i]`` = b[d-1-i], realized per step with one
    dynamic_slice of the reversed-b pad buffer.
    """
    B, L = pairs.a.shape
    ap = jnp.pad(pairs.a, ((0, 0), (1, 0)))  # [B, L+1], ap[:, i] = a[i-1]
    br = pairs.b[:, ::-1]
    brp = jnp.pad(br, ((0, 0), (L, L + 1)))  # width 3L+1; br at offset L
    i_idx = jnp.arange(L + 1, dtype=jnp.int32)[None, :]  # [1, L+1]
    return ap, brp, i_idx, L


def _b_window(brp: jax.Array, d: jax.Array, L: int) -> jax.Array:
    """[B, L+1] window w[i] = b[d-1-i] (junk where out of range)."""
    start = 2 * L - d
    return jax.lax.dynamic_slice(brp, (0, start), (brp.shape[0], L + 1))


@functools.partial(jax.jit, static_argnames=())
def levenshtein(pairs: PairBatch) -> jax.Array:
    """Uniform-cost Levenshtein distance per pair -> int32[B]."""
    ap, brp, i_idx, L = _diag_frames(pairs)
    a_len = pairs.a_len[:, None]
    b_len = pairs.b_len[:, None]

    # prev = diag d-1, prev2 = diag d-2, both [B, L+1] indexed by row i.
    init_prev = jnp.broadcast_to(
        jnp.minimum(jnp.minimum(i_idx, a_len), _BIG), (pairs.a.shape[0], L + 1)
    ).astype(jnp.int32)
    # diag 0 is the single cell (0,0)=0; diag array holds D[i][0-i]: only i=0
    # valid. Use column-0/row-0 closed forms for the first two diagonals:
    # prev (d=1): [D[0][1], D[1][0]] = [min(1,Lb), min(1,La)] at i=0,1.
    d1 = jnp.concatenate(
        [jnp.minimum(1, b_len), jnp.minimum(1, a_len)], axis=1
    ).astype(jnp.int32)
    prev = jnp.pad(d1, ((0, 0), (0, L - 1)))
    prev2 = jnp.zeros((pairs.a.shape[0], L + 1), jnp.int32)  # d=0: cell (0,0)=0
    del init_prev

    def step(carry, d):
        prev, prev2 = carry
        w = _b_window(brp, d, L)
        j_idx = d - i_idx
        in_range = (i_idx >= 1) & (i_idx <= a_len) & (j_idx >= 1) & (j_idx <= b_len)
        sub = jnp.where(in_range, (ap != w).astype(jnp.int32), _BIG)
        del_cost = jnp.where(i_idx <= a_len, 1, 0)
        ins_cost = jnp.where(j_idx <= b_len, 1, 0)
        prev_shift = jnp.pad(prev[:, :-1], ((0, 0), (1, 0)), constant_values=1 << 19)
        prev2_shift = jnp.pad(prev2[:, :-1], ((0, 0), (1, 0)), constant_values=1 << 19)
        cur = jnp.minimum(
            jnp.minimum(prev + ins_cost, prev_shift + del_cost), prev2_shift + sub
        )
        # Boundary closed forms: i=0 -> D[0][d]=min(d,Lb); i=d -> D[d][0]=min(d,La).
        cur = jnp.where(i_idx == 0, jnp.minimum(d, b_len), cur)
        cur = jnp.where(i_idx == d, jnp.minimum(d, a_len), cur)
        return (cur, prev), None

    (last, _), _ = jax.lax.scan(step, (prev, prev2), jnp.arange(2, 2 * L + 1), unroll=8)
    return last[:, L]


def _score_scan(pairs: PairBatch, match, mismatch, gap_open, gap_extend, *, local: bool):
    """Shared affine-gap Gotoh wavefront for NW (global) / SW (local) scores.

    Linear-gap scoring is the special case gap_open == gap_extend.
    """
    ap, brp, i_idx, L = _diag_frames(pairs)
    B = pairs.a.shape[0]
    a_len = pairs.a_len[:, None]
    b_len = pairs.b_len[:, None]
    match = jnp.int32(match)
    mismatch = jnp.int32(mismatch)
    go = jnp.int32(gap_open)
    ge = jnp.int32(gap_extend)
    neg = -_BIG

    def zone_costs(d):
        """(sub, vo, ve, ho, he) cost planes for diagonal d."""
        j_idx = d - i_idx
        a_in = i_idx <= a_len
        b_in = j_idx <= b_len
        in_range = (i_idx >= 1) & a_in & (j_idx >= 1) & b_in
        w = _b_window(brp, d, L)
        sub = jnp.where(in_range, jnp.where(ap == w, match, mismatch), neg)
        # Vertical (gap in b, row move): free past a_len, forbidden past b_len.
        vo = jnp.where(i_idx > a_len, 0, jnp.where(j_idx > b_len, neg, go))
        ve = jnp.where(i_idx > a_len, 0, jnp.where(j_idx > b_len, neg, ge))
        # Horizontal (gap in a, column move): mirrored.
        ho = jnp.where(j_idx > b_len, 0, jnp.where(i_idx > a_len, neg, go))
        he = jnp.where(j_idx > b_len, 0, jnp.where(i_idx > a_len, neg, ge))
        return sub, vo, ve, ho, he

    floor = jnp.int32(0) if local else neg

    def boundary(h, d):
        """Closed forms for row 0 / column 0 of the padded grid."""
        row0 = jnp.maximum(go + ge * (jnp.minimum(d, b_len) - 1), floor)
        row0 = jnp.where(b_len >= 1, row0, jnp.int32(0) if local else 0)
        col0 = jnp.maximum(go + ge * (jnp.minimum(d, a_len) - 1), floor)
        row0 = jnp.where(jnp.minimum(d, b_len) >= 1, row0, 0)
        col0 = jnp.where(jnp.minimum(d, a_len) >= 1, col0, 0)
        h = jnp.where(i_idx == 0, row0, h)
        h = jnp.where(i_idx == d, col0, h)
        return h

    # State: H (best), V (gap-in-b ending), Hz (gap-in-a ending) for diagonals
    # d-1 and d-2 of H; V/Hz only need d-1.
    h0 = jnp.zeros((B, L + 1), jnp.int32)  # d=0: H[0][0] = 0
    h1 = boundary(jnp.full((B, L + 1), neg, jnp.int32), jnp.int32(1))
    v1 = jnp.full((B, L + 1), neg, jnp.int32)
    z1 = jnp.full((B, L + 1), neg, jnp.int32)
    # Seed gap states on the first diagonal boundaries.
    v1 = jnp.where(i_idx == 1, h1, v1)
    z1 = jnp.where(i_idx == 0, h1, z1)

    best0 = jnp.zeros((B,), jnp.int32) if local else None

    def step(carry, d):
        h_prev, h_prev2, v_prev, z_prev, best = carry
        sub, vo, ve, ho, he = zone_costs(d)

        def shift(x, fill=neg):
            return jnp.pad(x[:, :-1], ((0, 0), (1, 0)), constant_values=fill)

        v_cur = jnp.maximum(shift(h_prev) + vo, shift(v_prev) + ve)
        z_cur = jnp.maximum(h_prev + ho, z_prev + he)
        m_cur = shift(h_prev2) + sub
        h_cur = jnp.maximum(jnp.maximum(v_cur, z_cur), m_cur)
        if local:
            h_cur = jnp.maximum(h_cur, 0)
        h_cur = boundary(h_cur, d)
        v_cur = jnp.where(i_idx == d, h_cur, v_cur)  # column-0 gap state
        z_cur = jnp.where(i_idx == 0, h_cur, z_cur)  # row-0 gap state
        if local:
            j_idx = d - i_idx
            in_range = (i_idx <= a_len) & (j_idx >= 0) & (j_idx <= b_len)
            best = jnp.maximum(best, jnp.max(jnp.where(in_range, h_cur, 0), axis=1))
        return (h_cur, h_prev, v_cur, z_cur, best), None

    carry = (h1, h0, v1, z1, best0)
    (h_last, _, _, _, best), _ = jax.lax.scan(step, carry, jnp.arange(2, 2 * L + 1), unroll=8)
    if local:
        return best
    return h_last[:, L]


@jax.jit
def nw_score_linear(pairs: PairBatch, match=2, mismatch=-1, gap=-2) -> jax.Array:
    """Needleman-Wunsch global score, linear gaps -> int32[B]."""
    return _score_scan(pairs, match, mismatch, gap, gap, local=False)


@jax.jit
def sw_score_linear(pairs: PairBatch, match=2, mismatch=-1, gap=-2) -> jax.Array:
    """Smith-Waterman local score, linear gaps -> int32[B]."""
    return _score_scan(pairs, match, mismatch, gap, gap, local=True)


@jax.jit
def nw_score_affine(pairs: PairBatch, match=2, mismatch=-1, gap_open=-5, gap_extend=-1) -> jax.Array:
    """NW global score, affine gaps (first gap char costs gap_open,
    each further char gap_extend) -> int32[B]."""
    return _score_scan(pairs, match, mismatch, gap_open, gap_extend, local=False)


@jax.jit
def sw_score_affine(pairs: PairBatch, match=2, mismatch=-1, gap_open=-5, gap_extend=-1) -> jax.Array:
    """SW local score, affine gaps -> int32[B]."""
    return _score_scan(pairs, match, mismatch, gap_open, gap_extend, local=True)


# ---------------------------------------------------------------------------
# Brute-force references (conformance oracles; O(B * L^2) on host)
# ---------------------------------------------------------------------------

def levenshtein_ref(a: bytes, b: bytes) -> int:
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[len(b)]


def _gotoh_ref(a, b, match, mismatch, go, ge, local):
    neg = -(10**9)
    La, Lb = len(a), len(b)
    H = [[0] * (Lb + 1) for _ in range(La + 1)]
    V = [[neg] * (Lb + 1) for _ in range(La + 1)]
    Z = [[neg] * (Lb + 1) for _ in range(La + 1)]
    best = 0
    for i in range(1, La + 1):
        V[i][0] = max(H[i - 1][0] + go, V[i - 1][0] + ge)
        H[i][0] = V[i][0] if not local else max(V[i][0], 0)
    for j in range(1, Lb + 1):
        Z[0][j] = max(H[0][j - 1] + go, Z[0][j - 1] + ge)
        H[0][j] = Z[0][j] if not local else max(Z[0][j], 0)
    for i in range(1, La + 1):
        for j in range(1, Lb + 1):
            V[i][j] = max(H[i - 1][j] + go, V[i - 1][j] + ge)
            Z[i][j] = max(H[i][j - 1] + go, Z[i][j - 1] + ge)
            s = match if a[i - 1] == b[j - 1] else mismatch
            H[i][j] = max(V[i][j], Z[i][j], H[i - 1][j - 1] + s)
            if local:
                H[i][j] = max(H[i][j], 0)
                best = max(best, H[i][j])
    return best if local else H[La][Lb]


def nw_ref(a, b, match=2, mismatch=-1, go=-2, ge=-2) -> int:
    return _gotoh_ref(a, b, match, mismatch, go, ge, local=False)


def sw_ref(a, b, match=2, mismatch=-1, go=-2, ge=-2) -> int:
    return _gotoh_ref(a, b, match, mismatch, go, ge, local=True)


# ---------------------------------------------------------------------------
# Banded Levenshtein (SWTPU_ERROR_BOUND) and codepoint-level variant
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("band",))
def levenshtein_banded(pairs: PairBatch, band: int) -> jax.Array:
    """Levenshtein distance clamped to a diagonal band of half-width ``band``
    (the reference's ``STRINGWARS_ERROR_BOUND``; distances that would exceed
    the bound are reported as >= band + |len_a - len_b| saturation).

    The DP walks the same anti-diagonal scan but only 2*band + 1 cells per
    diagonal are live — cells outside the band read BIG and die. For
    band << L this cuts work from L^2 to (2*band+1)*L cells per pair.
    """
    ap, brp, i_idx, L = _diag_frames(pairs)
    a_len = pairs.a_len[:, None]
    b_len = pairs.b_len[:, None]

    d1 = jnp.concatenate(
        [jnp.minimum(1, b_len), jnp.minimum(1, a_len)], axis=1
    ).astype(jnp.int32)
    prev = jnp.pad(d1, ((0, 0), (0, L - 1)))
    prev2 = jnp.zeros((pairs.a.shape[0], L + 1), jnp.int32)

    def step(carry, d):
        prev, prev2 = carry
        w = _b_window(brp, d, L)
        j_idx = d - i_idx
        in_range = (i_idx >= 1) & (i_idx <= a_len) & (j_idx >= 1) & (j_idx <= b_len)
        in_band = jnp.abs(i_idx - j_idx) <= band
        sub = jnp.where(in_range & in_band, (ap != w).astype(jnp.int32), _BIG)
        del_cost = jnp.where((i_idx <= a_len) & in_band, 1, _BIG)
        ins_cost = jnp.where((j_idx <= b_len) & in_band, 1, _BIG)
        prev_shift = jnp.pad(prev[:, :-1], ((0, 0), (1, 0)), constant_values=1 << 19)
        prev2_shift = jnp.pad(prev2[:, :-1], ((0, 0), (1, 0)), constant_values=1 << 19)
        cur = jnp.minimum(
            jnp.minimum(prev + ins_cost, prev_shift + del_cost), prev2_shift + sub
        )
        cur = jnp.where(i_idx == 0, jnp.minimum(d, b_len), cur)
        cur = jnp.where(i_idx == d, jnp.minimum(d, a_len), cur)
        # Out-of-range frozen propagation (same zones as the full kernel).
        cur = jnp.where(i_idx > a_len, jnp.minimum(cur, prev_shift), cur)
        cur = jnp.where((j_idx > b_len) & (i_idx <= a_len), jnp.minimum(cur, prev), cur)
        return (cur, prev), None

    (last, _), _ = jax.lax.scan(step, (prev, prev2), jnp.arange(2, 2 * L + 1))
    return jnp.minimum(last[:, L], _BIG)


def pack_pairs_utf8(a_tokens: list[bytes], b_tokens: list[bytes], width: int | None = None) -> PairBatch:
    """Codepoint-level pairs: the ``LevenshteinDistancesUtf8`` analog
    (distances over decoded codepoints; CUPS counts codepoint cells,
    reference ``similarities/bench.rs:230-247``)."""
    from stringwars_tpu.ops.utf8 import decode_codepoints

    a_cps = [decode_codepoints(t) for t in a_tokens]
    b_cps = [decode_codepoints(t) for t in b_tokens]
    L = width or max(
        (max((len(c) for c in a_cps), default=1), max((len(c) for c in b_cps), default=1))
    )
    L = max(L, 1)
    B = len(a_cps)
    a = np.zeros((B, L), dtype=np.int32)
    b = np.zeros((B, L), dtype=np.int32)
    a_len = np.zeros(B, dtype=np.int32)
    b_len = np.zeros(B, dtype=np.int32)
    for i, (x, y) in enumerate(zip(a_cps, b_cps)):
        a[i, : len(x)] = x
        b[i, : len(y)] = y
        a_len[i], b_len[i] = len(x), len(y)
    return PairBatch(jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_len), jnp.asarray(b_len))
