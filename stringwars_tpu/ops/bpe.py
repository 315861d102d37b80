"""Byte-level BPE tokenization with a replicated merge table (the
north-star "regex-pre-split byte-level tokenization with replicated
merge/vocab tables" workload; BASELINE.json configs 1 & 5).

Device shape:

- **Pre-split** happens with the framework's own segmentation kernels
  (whitespace boundaries, ``ops/segment.py``) or any host regex; each
  pretoken is one row of a ``PaddedTokens`` batch.
- **Merge table** is three replicated dense arrays — sorted pair keys
  (``left * 2^16 + right`` as u32), merge rank, and new id — so a pair
  lookup is a vectorized binary search (``jnp.searchsorted``) plus one
  verifying gather, not a host dict probe.
- **Encode loop**: every iteration ranks all adjacent pairs in every row,
  merges each row's minimum-rank pair everywhere it occurs (left-to-right
  overlap resolution by run parity, so ``aaa`` under merge ``(a,a)``
  produces ``[aa, a]``), and compacts rows with a stable argsort. All rows
  advance together under one ``lax.while_loop``; a row that can't merge
  anymore just stops changing. Iteration count is bounded by the widest
  row, not the batch.

This reproduces the classic BPE greedy semantics per pretoken (lowest
merge rank first; ties resolved left-to-right), validated against the
scalar reference encoder ``bpe_encode_ref`` and a from-spec trainer
(``train_merges``) in tests/test_bpe.py.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.tape import PaddedTokens

_INF = jnp.int32(0x7FFFFFFF)
_KEY_SHIFT = 16  # ids < 2^16: key = left << 16 | right


@dataclasses.dataclass(frozen=True)
class MergeTable:
    """Replicated dense merge table: keys sorted for binary search."""

    sorted_keys: jax.Array  # uint32 [M]
    ranks: jax.Array  # int32 [M] (lower merges first)
    new_ids: jax.Array  # int32 [M]
    vocab_size: int

    @classmethod
    def from_merges(cls, merges: list[tuple[int, int]]) -> "MergeTable":
        """``merges[r]`` = (left_id, right_id) merged at rank r into id
        ``256 + r`` (byte-level base vocabulary)."""
        if len(merges) > (1 << 16) - 256:
            raise ValueError("too many merges for 16-bit ids")
        keys = np.array(
            [(left << _KEY_SHIFT) | right for left, right in merges], np.uint32
        )
        if np.unique(keys).shape[0] != keys.shape[0]:
            raise ValueError("duplicate merge pairs")
        ranks = np.arange(len(merges), dtype=np.int32)
        new_ids = 256 + ranks
        order = np.argsort(keys)
        return cls(
            sorted_keys=jnp.asarray(keys[order]),
            ranks=jnp.asarray(ranks[order]),
            new_ids=jnp.asarray(new_ids[order]),
            vocab_size=256 + len(merges),
        )


def train_merges(corpus_tokens: list[bytes], n_merges: int) -> list[tuple[int, int]]:
    """From-spec greedy BPE trainer (host): repeatedly merge the most
    frequent adjacent pair across the (deduplicated, counted) pretokens."""
    from collections import Counter

    word_counts = Counter(corpus_tokens)
    words = [(list(w), c) for w, c in word_counts.items() if len(w) > 0]
    merges: list[tuple[int, int]] = []
    for _ in range(n_merges):
        pair_counts: Counter = Counter()
        for seq, c in words:
            for a, b in zip(seq, seq[1:]):
                pair_counts[(a, b)] += c
        if not pair_counts:
            break
        # Deterministic: max count, then smallest pair ids.
        (left, right), top = max(
            pair_counts.items(), key=lambda kv: (kv[1], (-kv[0][0], -kv[0][1]))
        )
        if top < 2:
            break
        new_id = 256 + len(merges)
        merges.append((left, right))
        for wi, (seq, c) in enumerate(words):
            out = []
            i = 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == left and seq[i + 1] == right:
                    out.append(new_id)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            words[wi] = (out, c)
    return merges


def bpe_encode_ref(token: bytes, merges: list[tuple[int, int]]) -> list[int]:
    """Scalar oracle: greedy lowest-rank-first, ties merged left-to-right."""
    rank = {pair: r for r, pair in enumerate(merges)}
    new_id = {pair: 256 + r for r, pair in enumerate(merges)}
    seq = list(token)
    while len(seq) > 1:
        best = min(
            (rank.get((a, b), 1 << 30) for a, b in zip(seq, seq[1:])),
            default=1 << 30,
        )
        if best >= 1 << 30:
            break
        pair = merges[best]
        out = []
        i = 0
        while i < len(seq):
            if i + 1 < len(seq) and (seq[i], seq[i + 1]) == pair:
                out.append(new_id[pair])
                i += 2
            else:
                out.append(seq[i])
                i += 1
        seq = out
    return seq


def _row_last_value(values: jax.Array, mask: jax.Array, init) -> jax.Array:
    """Per-row (axis 1) last-valid-value scan."""
    def comb(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    v, f = jax.lax.associative_scan(comb, (jnp.where(mask, values, 0), mask), axis=1)
    return jnp.where(f, v, init)


def _last_alive_scan(values, alive):
    """Inclusive per-row scan: value at the nearest alive slot <= j
    (0 where none yet). Dead slots are transparent."""
    def comb(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    v, f = jax.lax.associative_scan(
        comb, (jnp.where(alive, values, 0), alive), axis=1
    )
    return v, f


def _encode_impl(ids, counts, lookup, max_iters: int):
    """Row-parallel exact greedy: every iteration merges ALL occurrences of
    each row's minimum-rank pair (ties resolved left-to-right by run
    parity). The row minimum can never be pre-empted — cascades from other
    merges only create pairs that get compared on the NEXT iteration — so
    the output matches the sequential greedy exactly. (Merging all
    rank-local-minima per iteration is tempting but UNSOUND: a merge two
    positions away can create a brand-new lower-rank pair that overlaps a
    current local min, e.g. (69,259)→260 spawning (259,260) r5 which
    pre-empts (251,259) r13.)

    Merged-away slots become HOLES (-1) instead of being compacted: the
    right partner of each pair is the next alive value (one log-W scan)
    and holes are identity elements in the run-parity scan, so the loop
    body has no argsort / gather; one stable compaction runs after the
    loop. Saves the per-iteration [B, W] sort + take_along_axis that
    dominated the round-2 profile.
    """
    B, W = ids.shape
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]

    def step(state):
        ids, counts, _changed = state
        alive = ids >= 0
        # Next alive value to the RIGHT (exclusive): flip, inclusive
        # first-alive scan, flip back, shift left.
        rv, rf = _last_alive_scan(jnp.flip(ids, 1), jnp.flip(alive, 1))
        # After flip-back, position j holds nearest alive value at >= j.
        inc_v = jnp.flip(rv, 1)
        inc_f = jnp.flip(rf, 1)
        nxt = jnp.concatenate([inc_v[:, 1:], jnp.full((B, 1), 0, ids.dtype)], axis=1)
        has_nxt = jnp.concatenate([inc_f[:, 1:], jnp.zeros((B, 1), bool)], axis=1)
        valid_pair = alive & has_nxt

        keys = (
            ids.astype(jnp.uint32) << _KEY_SHIFT
        ) | (nxt.astype(jnp.uint32) & jnp.uint32(0xFFFF))
        pair_rank, pair_new = lookup(keys)
        r = jnp.where(valid_pair, pair_rank, _INF)
        best = jnp.min(r, axis=1, keepdims=True)  # [B, 1]
        m = (r == best) & (best < _INF)

        # Left-to-right overlap resolution over ALIVE adjacency: trailing
        # consecutive-match length via composition of linear functions
        # x -> mult*x + add (dead = identity, unmatched = reset, matched =
        # increment); odd 1-based run positions merge ("aaaa" -> aa, aa).
        mult = jnp.where(alive, jnp.where(m, 1, 0), 1).astype(jnp.int32)
        add = (alive & m).astype(jnp.int32)

        def comb_lin(p, q):  # apply p first, then q
            pm, pa = p
            qm, qa = q
            return qm * pm, qm * pa + qa

        _, runlen = jax.lax.associative_scan(comb_lin, (mult, add), axis=1)
        do = m & ((runlen & 1) == 1)

        # The merged pair's right partner: next alive slot after a 'do'.
        pv, pf = _last_alive_scan(do.astype(jnp.int32), alive)
        prev_do = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), pv[:, :-1]], axis=1)
        eaten = alive & (prev_do == 1)

        new_ids = jnp.where(do, pair_new, ids)
        new_ids = jnp.where(eaten, -1, new_ids)
        new_counts = counts - jnp.sum(do, axis=1).astype(jnp.int32)
        return new_ids, new_counts, jnp.any(do)

    ids = jnp.where(pos < counts[:, None], ids, -1)
    state = (ids, counts, jnp.bool_(True), jnp.int32(0))

    def cond_fn(state):
        return state[2] & (state[3] < max_iters)

    def body_fn(state):
        ids, counts, changed = step(state[:3])
        return ids, counts, changed, state[3] + 1

    ids, counts, _, _ = jax.lax.while_loop(cond_fn, body_fn, state)
    # One stable compaction after the loop (holes sort last): packed
    # single-operand sort — ids fit 16 bits.
    sort_keys = jnp.where(ids >= 0, pos, W + pos)
    packed = jax.lax.sort((sort_keys << 16) | (ids & jnp.int32(0xFFFF)), dimension=1)
    vals = packed & jnp.int32(0xFFFF)
    live = pos < counts[:, None]
    return jnp.where(live, vals, -1), counts


@functools.partial(jax.jit, static_argnames=("max_iters",))
def _bpe_encode(ids, counts, sorted_keys, ranks, new_ids, max_iters: int):
    """ids: int32 [B, W] (byte values, -1 past counts); counts: int32 [B].
    Pair lookup is a binary search over the sorted merge keys."""

    def lookup(keys):
        idx = jnp.searchsorted(sorted_keys, keys)
        idx = jnp.minimum(idx, sorted_keys.shape[0] - 1)
        hit = jnp.take(sorted_keys, idx) == keys
        return (
            jnp.where(hit, jnp.take(ranks, idx), _INF),
            jnp.where(hit, jnp.take(new_ids, idx), -1),
        )

    return _encode_impl(ids, counts, lookup, max_iters)


def bpe_encode(tokens: PaddedTokens, table: MergeTable) -> tuple[jax.Array, jax.Array]:
    """Encode every pretoken row: returns (ids int32 [B, W] with -1 padding,
    counts int32 [B])."""
    ids = tokens.data.astype(jnp.int32)
    counts = tokens.lengths.astype(jnp.int32)
    W = int(tokens.data.shape[1])
    return _bpe_encode(
        ids, counts, table.sorted_keys, table.ranks, table.new_ids, max(W - 1, 1)
    )
