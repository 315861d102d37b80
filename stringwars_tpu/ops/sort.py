"""Stable string argsort, byte order and case-folded order (family K11).

Reference rows: ``sz::argsort`` (+ ``.uncased()``), arrow lexsort, polars
(``sequence/bench.rs:51-259``); all competitors forced stable; work metric
n*log2(n) "comparisons" (``sequence/bench.rs:79``); caller-owned ``out``
index buffer like the Python reference (``sequence/bench.py:212-232``).

Design: **LSD radix over packed key columns**. Each uint32
column packs three 9-bit values (byte + 1; padding = 0, so shorter strings
that are prefixes sort first, exactly byte order). Passes run from the
least-significant column to the most-significant; every pass is one
gather + one stable ``argsort`` — dense XLA sorts, no string compares.

Long tails don't inflate the key matrix: the device sorts a
``prefix_width``-byte key, and rows that tie on a maxed-out prefix (rare)
are refined host-side with a stable full-token sort — so one 4 KB line in
a words corpus costs a few tie comparisons, not a 64x wider matrix.

The case-folded variant builds its keys from the batched full case fold
(``casefold.fold_tokens`` — one device dispatch for the whole batch),
clamping each prefix to a UTF-8 boundary so a split multibyte char can't
produce garbage codepoints; fold(prefix) is a prefix of fold(token), so
prefix ordering is exact and ties refine with ``str.casefold``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.tape import PaddedTokens, Tape


def _byte_columns(data: jax.Array, lengths: jax.Array) -> jax.Array:
    """[n_cols, B] uint32 packed key columns (3 bytes + 1 each)."""
    B, W = data.shape
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]
    vals = jnp.where(pos < lengths[:, None], data.astype(jnp.uint32) + 1, 0)
    n_cols = (W + 2) // 3
    padded = jnp.pad(vals, ((0, 0), (0, n_cols * 3 - W)))
    groups = padded.reshape(B, n_cols, 3)
    packed = (groups[:, :, 0] << 18) | (groups[:, :, 1] << 9) | groups[:, :, 2]
    return packed.T  # [n_cols, B]


# Column-count ceiling for the one-shot multi-key sort. Short-word
# corpora (the reference's headline argsort rows) pack to <= 8 columns;
# past that the comparator's operand set outweighs the gathers it saves.
_MULTIKEY_MAX_COLS = 8


@jax.jit
def _lsd_argsort(columns: jax.Array) -> jax.Array:
    """Stable argsort over [n_cols, B] packed key columns.

    Short keys: ONE lexicographic ``lax.sort`` over all columns with the
    identity iota as the final key (ties broken by position == stable) —
    no gathers at all. Wide keys: LSD radix, one stable sort per column;
    the per-pass ``jnp.take`` re-gathers are the price of not carrying
    every remaining column through every pass (XLA-level gathers run
    near-scalar on this chip — PERFORMANCE.md finding #4 — which is why
    the multi-key form wins 15x on the 2 M-word row).
    """
    n_cols, B = columns.shape
    order = jnp.arange(B, dtype=jnp.int32)
    if n_cols <= _MULTIKEY_MAX_COLS:
        res = jax.lax.sort(
            [columns[k] for k in range(n_cols)] + [order], num_keys=n_cols + 1
        )
        return res[-1]

    def body(order, col):
        keys = jnp.take(col, order)
        idx = jnp.argsort(keys, stable=True)
        return jnp.take(order, idx), None

    order, _ = jax.lax.scan(body, order, columns[::-1])
    return order


def argsort_tokens(tokens: PaddedTokens) -> jax.Array:
    """Stable byte-order argsort of a padded batch: int32[B] permutation."""
    return _lsd_argsort(_byte_columns(tokens.data, tokens.lengths))


def _write_out(order: np.ndarray, out):
    if out is None:
        return order
    out[: order.shape[0]] = order
    return out


def _refine_ties(order: np.ndarray, tie_with_next: np.ndarray, key_of_index) -> np.ndarray:
    """Stable host-side re-sort of each run of prefix-tied rows."""
    if not tie_with_next.any():
        return order
    boundaries = np.flatnonzero(~tie_with_next)
    start = 0
    order = order.copy()
    for end in boundaries:
        if end > start:
            run = sorted(order[start : end + 1].tolist(), key=key_of_index)
            order[start : end + 1] = run
        start = end + 1
    if start < order.shape[0] - 1:
        run = sorted(order[start:].tolist(), key=key_of_index)
        order[start:] = run
    return order


def argsort_tape(tape: Tape, *, prefix_width: int = 96, out=None) -> np.ndarray:
    """Stable byte-order argsort of all tokens (indices into tape order).

    Device-sorts a ``prefix_width``-byte radix key; rows tying on a
    maxed-out prefix are refined host-side. ``out`` (optional) is a
    caller-owned index buffer written in place.
    """
    o = np.asarray(tape.offsets).astype(np.int64)
    full_lengths = o[1:] - o[:-1]
    tokens = PaddedTokens.from_tape(tape, align=4, max_width=prefix_width)
    order = np.asarray(argsort_tokens(tokens))
    if full_lengths.size and int(full_lengths.max()) > prefix_width:
        mat = np.asarray(tokens.data)
        sorted_mat = mat[order]
        # >= not >: a row of length exactly prefix_width has an identical
        # radix key to a longer row sharing its prefix, and must refine too.
        maxed = full_lengths[order] >= prefix_width
        tie = (
            (sorted_mat[1:] == sorted_mat[:-1]).all(axis=1) & (maxed[1:] | maxed[:-1])
        )
        toks = tape.to_list()
        order = _refine_ties(order, tie, toks.__getitem__)
    return _write_out(order, out)


def _clamp_utf8_boundary(mat: np.ndarray, lengths: np.ndarray, K: int) -> np.ndarray:
    """Per-row key length clamped so no multibyte char is split at K."""
    clamped = np.minimum(lengths, K)
    long = lengths > K
    if not long.any():
        return clamped.astype(np.int32)
    b = mat.astype(np.int32)
    width = np.where(
        b < 0x80, 1, np.where(b < 0xC0, 0, np.where(b < 0xE0, 2, np.where(b < 0xF0, 3, 4)))
    )
    cut = np.full(lengths.shape[0], K, np.int64)
    found = ~long
    for p in (K - 1, K - 2, K - 3):
        if p < 0:
            break
        w = width[:, p]
        is_lead = w > 0
        hit = ~found & is_lead
        cut = np.where(hit & (p + w > K), p, cut)
        found |= is_lead
    return np.where(long, cut, clamped).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("n_cols", "pack3"))
def _uncased_order(tokens_data, key_lengths, n_cols: int, pack3: bool):
    from stringwars_tpu.ops.casefold import fold_tokens

    folded, counts = fold_tokens(
        PaddedTokens(data=tokens_data, lengths=key_lengths, width=tokens_data.shape[1])
    )
    pos = jnp.arange(folded.shape[1], dtype=jnp.int32)[None, :]
    vals = jnp.where(pos < counts[:, None], folded.astype(jnp.uint32) + 1, 0)
    vals = vals[:, : n_cols * (3 if pack3 else 1)]
    if pack3:
        groups = vals.reshape(vals.shape[0], n_cols, 3)
        cols = (groups[:, :, 0] << 18) | (groups[:, :, 1] << 9) | groups[:, :, 2]
    else:
        cols = vals
    return _lsd_argsort(cols.T), counts


def argsort_uncased(tape: Tape, *, prefix_width: int = 96, out=None) -> np.ndarray:
    """Case-folded order: sort keys are full-case-folded codepoints.

    Mirrors ``sz::argsort.uncased()`` / ``utf8_uncased_order`` sorting
    (``sequence/bench.rs:86-93``): compares fold(a) vs fold(b) as
    codepoint sequences. One batched fold + radix sort on device; ties on
    maxed-out prefixes refine host-side with ``str.casefold``.
    """
    o = np.asarray(tape.offsets).astype(np.int64)
    full_lengths = o[1:] - o[:-1]
    tokens = PaddedTokens.from_tape(tape, align=4, max_width=prefix_width)
    mat = np.asarray(tokens.data)
    key_lengths = _clamp_utf8_boundary(mat, full_lengths, min(prefix_width, mat.shape[1]))

    # One probe fold decides the column packing (ASCII-ish folds fit 9 bits).
    from stringwars_tpu.ops.casefold import fold_tokens

    folded, counts = fold_tokens(
        PaddedTokens(data=tokens.data, lengths=jnp.asarray(key_lengths), width=mat.shape[1])
    )
    max_count = int(jnp.max(counts)) if counts.shape[0] else 1
    max_cp = int(jnp.max(folded)) if counts.shape[0] else 0
    pack3 = max_cp <= 509  # cp + 1 must fit 9 bits
    n_cols = max(1, (-(-max_count // 3)) if pack3 else max_count)
    order_dev, _ = _uncased_order(tokens.data, jnp.asarray(key_lengths), n_cols, pack3)
    order = np.asarray(order_dev)

    # >= not >: length-== -prefix_width rows can tie a longer row's folded
    # prefix key exactly and still need host refinement (see argsort_tape).
    maxed = full_lengths >= min(prefix_width, mat.shape[1])
    if maxed.any():
        folded_np = np.asarray(folded)
        counts_np = np.asarray(counts)
        sorted_f = folded_np[order]
        sorted_c = counts_np[order]
        eq = (sorted_f[1:] == sorted_f[:-1]).all(axis=1) & (sorted_c[1:] == sorted_c[:-1])
        tie = eq & (maxed[order][1:] | maxed[order][:-1])
        toks = tape.to_list()

        def fold_key(i):
            return toks[i].decode("utf-8", "ignore").casefold()

        order = _refine_ties(order, tie, fold_key)
    return _write_out(order, out)


def sorted_tokens(tape: Tape, *, uncased: bool = False) -> list[bytes]:
    order = argsort_uncased(tape) if uncased else argsort_tape(tape)
    tokens = tape.to_list()
    return [tokens[i] for i in order]


# ---------------------------------------------------------------------------
# Distributed argsort (the <Nchip> scope): stable sample sort over the mesh.
#
# The reference's multi-core sorting rows are its competitors' parallel
# sorts (polars/arrow); the device formulation is a SAMPLE SORT over
# the 1-D device mesh:
#
#   1. every shard strided-samples its leading packed key word; an
#      all_gather + replicated sort picks D-1 splitters (identical on all
#      shards — no broadcast needed);
#   2. rows partition to destination shards purely by leading-key range
#      (equal keys share a destination, so stability survives), are
#      grouped by a local stable sort on the destination id, and exchange
#      through ONE fixed-capacity lax.all_to_all (capacity 2x the mean;
#      an overflow flag psum falls the caller back to the 1-chip path —
#      correctness never depends on the sampling);
#   3. each shard LSD-radix-argsorts what it received (pads carry
#      max-keys and sink to the tail); received blocks arrive in (source,
#      source-position) = original order, so the local sort's stability
#      extends globally.
#
# Concatenating the shards' outputs in mesh order IS the global stable
# argsort. Scaling: sample/splitter work is O(D*S); everything else is
# the 1-chip sort at B/D rows per shard plus one all_to_all over ICI.
# ---------------------------------------------------------------------------

_SAMPLES_PER_SHARD = 256
_CAPACITY_FACTOR = 2


def _sharded_sort_body(cols_local, idx_local, n_dev: int, axis: str):
    """Per-shard sample-sort body (runs under shard_map)."""
    n_cols, Bl = cols_local.shape
    cap = max(_CAPACITY_FACTOR * Bl // n_dev, 8)
    big = jnp.int32(0x7FFFFFFF)

    k0 = cols_local[0].astype(jnp.int32)
    step = max(Bl // _SAMPLES_PER_SHARD, 1)
    sample = jax.lax.slice(k0, (0,), (step * min(_SAMPLES_PER_SHARD, Bl),), (step,))
    gathered = jax.lax.all_gather(sample, axis, tiled=True)
    ss = jnp.sort(gathered)
    pick = (jnp.arange(1, n_dev) * ss.shape[0]) // n_dev
    splitters = ss[pick]  # [D-1], identical on every shard

    dest = jnp.sum(
        (k0[None, :] >= splitters[:, None]).astype(jnp.int32), axis=0
    )  # [Bl] in 0..D-1
    counts = jnp.sum(
        (dest[None, :] == jnp.arange(n_dev, dtype=jnp.int32)[:, None]).astype(jnp.int32),
        axis=1,
    )
    offs = jnp.cumsum(counts) - counts
    overflow = jnp.any(counts > cap)

    order = jnp.argsort(dest, stable=True)
    # A cap-sized tail pad keeps every dynamic_slice start == offs[d]
    # exact (dynamic_slice CLAMPS starts near the array end, which would
    # silently re-read rows from the previous segment).
    csort = jnp.pad(jnp.take(cols_local, order, axis=1), ((0, 0), (0, cap)), constant_values=big)
    isort = jnp.pad(jnp.take(idx_local, order), (0, cap), constant_values=-1)

    # Fixed-capacity per-destination slots (junk rows past each segment's
    # count are masked to max-key pads).
    send_keys = []
    send_idx = []
    pos = jnp.arange(cap, dtype=jnp.int32)
    for d in range(n_dev):
        start = offs[d]
        kslab = jnp.stack(
            [jax.lax.dynamic_slice(csort[c], (start,), (cap,)) for c in range(n_cols)]
        )
        islab = jax.lax.dynamic_slice(isort, (start,), (cap,))
        live = pos < counts[d]
        send_keys.append(jnp.where(live[None, :], kslab, big))
        send_idx.append(jnp.where(live, islab, -1))
    sk = jnp.stack(send_keys)  # [D, n_cols, cap]
    si = jnp.stack(send_idx)  # [D, cap]

    rk = jax.lax.all_to_all(sk, axis, split_axis=0, concat_axis=0, tiled=False)
    ri = jax.lax.all_to_all(si, axis, split_axis=0, concat_axis=0, tiled=False)
    rkeys = rk.transpose(1, 0, 2).reshape(n_cols, n_dev * cap)
    ridx = ri.reshape(n_dev * cap)

    final = _lsd_argsort(rkeys.astype(jnp.uint32))
    out_idx = jnp.take(ridx, final)
    local_n = jnp.sum((ridx >= 0).astype(jnp.int32))
    return out_idx, local_n.reshape(1), jax.lax.psum(overflow.astype(jnp.int32), axis)


def argsort_sharded(tape: Tape, scope, *, prefix_width: int = 96, out=None) -> np.ndarray:
    """Stable byte-order argsort over a device scope (sample sort).

    ``scope`` is a ``parallel.mesh.DeviceScope``; with one device this
    degrades to the single-chip path. Falls back to the 1-chip sort if
    the sampled partition overflows its 2x capacity (adversarially skewed
    key distributions) — the result is always the exact stable order.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from stringwars_tpu.parallel.mesh import SHARD_AXIS

    n_dev = scope.chips
    if n_dev <= 1:
        return argsort_tape(tape, prefix_width=prefix_width, out=out)

    o = np.asarray(tape.offsets).astype(np.int64)
    full_lengths = o[1:] - o[:-1]
    tokens = PaddedTokens.from_tape(tape, align=4, max_width=prefix_width)
    B = tokens.data.shape[0]
    Bl = -(-B // n_dev)
    Bp = Bl * n_dev
    cols = np.asarray(_byte_columns(tokens.data, tokens.lengths))
    if Bp > B:
        # Pad rows carry max keys (sort to the global tail) and idx -1.
        cols = np.pad(cols, ((0, 0), (0, Bp - B)), constant_values=0x7FFFFFFF)
    idx = np.concatenate([np.arange(B, dtype=np.int32), np.full(Bp - B, -1, np.int32)])

    body = functools.partial(_sharded_sort_body, n_dev=n_dev, axis=SHARD_AXIS)
    stepped = jax.jit(
        shard_map(
            body,
            mesh=scope.mesh,
            in_specs=(P(None, SHARD_AXIS), P(SHARD_AXIS)),
            out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P()),
        )
    )
    out_idx, local_n, overflow = stepped(jnp.asarray(cols), jnp.asarray(idx))
    if int(overflow) > 0:
        return argsort_tape(tape, prefix_width=prefix_width, out=out)
    out_np = np.asarray(out_idx).reshape(n_dev, -1)
    ln = np.asarray(local_n).reshape(-1)
    order = np.concatenate([out_np[d, : ln[d]] for d in range(n_dev)])
    # Host tie refinement over maxed-out prefixes, exactly the 1-chip path.
    if full_lengths.size and int(full_lengths.max()) > prefix_width:
        mat = np.asarray(tokens.data)
        sorted_mat = mat[order]
        maxed = full_lengths[order] >= prefix_width
        tie = (
            (sorted_mat[1:] == sorted_mat[:-1]).all(axis=1) & (maxed[1:] | maxed[:-1])
        )
        toks = tape.to_list()
        order = _refine_ties(order, tie, toks.__getitem__)
    return _write_out(order.astype(np.intp), out)
