"""Canonical/compat normalization: NFC, NFD, NFKC, NFKD (family K10).

Reference rows: ``sz::utf8_norm`` vs unicode-normalization / icu4x
(``normalization/bench.rs:113-141``). Design:

- **Decompose** (NFD/NFKD): table-driven 1→N expansion (pool + scatter over
  prefix sums, same machinery as case folding; Hangul precomputed into the
  tables) followed by **canonical reordering** — a stable argsort of
  ``starter_run_id * 256 + ccc`` keys, which is exactly the UAX#15
  reorder expressed as one dense sort.
- **Compose** (NFC/NFKC): an "all-inert" quick check (every codepoint is
  ccc=0, decomposition-free, and not a composition combiner → the NFD
  stream is already NFC) short-circuits most real text; otherwise a
  ``lax.scan`` walks the reordered stream carrying (pending starter,
  last-ccc) state, composing via a dense rank×rank pair table and Hangul
  arithmetic. The scan is the sequential conformance path; hot corpora hit
  the quick check.

Conformance oracle: ``unicodedata.normalize`` (UCD 15.0), fuzzed in tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.unicode import tables

_MAX_NFD = 4
_MAX_NFKD = 18

# Hangul constants (UAX#15 §3.12)
_SBASE, _LBASE, _VBASE, _TBASE = 0xAC00, 0x1100, 0x1161, 0x11A7
_LCOUNT, _VCOUNT, _TCOUNT = 19, 21, 28
_NCOUNT = _VCOUNT * _TCOUNT


@functools.lru_cache(maxsize=None)
def _decomp_arrays(compat: bool):
    inline, multi, pool = tables.decomposition_tables(compat)
    return inline, multi.astype(np.int64), pool


@functools.lru_cache(maxsize=None)
def _decomp_rules(compat: bool, max_cp: int | None = None):
    """Decomposition tables compiled to rule maps (``ops/rulemap``).

    (inline delta rules, expansion-length sparse map, per-position value
    maps e_0..e_{k-1}, static max expansion k, ccc step rules, max cp any
    OUTPUT can take). ``max_cp`` prunes to the corpus codepoint ceiling,
    which shrinks the dense tables the maps gather from."""
    from stringwars_tpu.ops import rulemap

    inline, multi, pool = _decomp_arrays(compat)
    keys = np.flatnonzero(inline < 0)
    if max_cp is not None:
        keys = keys[keys <= max_cp]
    m = multi[keys]
    lengths = (m & 31).astype(np.int64)
    off = (m >> 5).astype(np.int64)
    max_exp = int(lengths.max()) if lengths.size else 1
    inline_rules = rulemap.compile_fold(inline)
    mlen_rules = rulemap.compile_sparse_values(
        keys if keys.size else np.asarray([0x10FFFF]),
        lengths if keys.size else np.asarray([0]),
    )
    pos_maps = []
    out_max = int(max_cp) if max_cp is not None else tables.MAX_CP - 1
    for k in range(max_exp):
        has = lengths > k
        kk = keys[has]
        vals = pool[np.minimum(off + k, pool.shape[0] - 1)][has].astype(np.int64)
        if kk.size:
            out_max = max(out_max, int(vals.max()))
        pos_maps.append(
            rulemap.compile_sparse_values(
                kk if kk.size else np.asarray([0x10FFFF]),
                vals if kk.size else np.asarray([0]),
            )
        )
    # Singleton (1:1) decompositions can also raise the output ceiling.
    cps = np.arange(inline.shape[0], dtype=np.int64)
    single = (inline >= 0) & (inline != cps)
    if max_cp is not None:
        single &= cps <= max_cp
    if single.any():
        out_max = max(out_max, int(inline[single].max()))
    if max_cp is not None:
        inline_rules = inline_rules.prune(max_cp)
        mlen_rules = mlen_rules.prune(max_cp)
        pos_maps = [r.prune(max_cp) for r in pos_maps]
    ccc_rules = rulemap.compile_steps(_ccc_np()).prune(out_max)
    return inline_rules, mlen_rules, tuple(pos_maps), max_exp, ccc_rules, out_max


@functools.lru_cache(maxsize=None)
def _ccc_np():
    return tables.ccc_table().astype(np.int32)


@functools.lru_cache(maxsize=None)
def _pair_tables():
    """Dense composition lookup: rank maps + [n_s, n_c] composed table."""
    starters, combiners, composed = tables.composition_pairs()
    s_unique = np.unique(starters)
    c_unique = np.unique(combiners)
    s_rank = np.zeros(tables.MAX_CP, np.int32)
    c_rank = np.zeros(tables.MAX_CP, np.int32)
    s_rank[s_unique] = np.arange(1, s_unique.size + 1)
    c_rank[c_unique] = np.arange(1, c_unique.size + 1)
    dense = np.zeros((s_unique.size + 1) * (c_unique.size + 1), np.int32)
    dense[s_rank[starters] * (c_unique.size + 1) + c_rank[combiners]] = composed
    return s_rank, c_rank, dense, c_unique.size + 1


@functools.lru_cache(maxsize=None)
def _inert_np(compat: bool) -> np.ndarray:
    """True for codepoints that can't interact with composition at all."""
    inline, multi, _ = _decomp_arrays(compat)
    ccc = _ccc_np()
    _, c_rank, _, _ = _pair_tables()
    inert = (inline == np.arange(tables.MAX_CP)) & (multi == 0) & (ccc == 0) & (c_rank == 0)
    # Hangul jamo compose arithmetically:
    jamo = np.zeros(tables.MAX_CP, bool)
    jamo[_LBASE : _LBASE + _LCOUNT] = True
    jamo[_VBASE : _VBASE + _VCOUNT] = True
    jamo[_TBASE + 1 : _TBASE + _TCOUNT] = True
    return inert & ~jamo


@functools.partial(jax.jit, static_argnames=("n", "compat"))
def decompose(cps: jax.Array, n: int, compat: bool = False) -> tuple[jax.Array, jax.Array]:
    """NFD/NFKD of a zero-padded codepoint stream: (out, true_count).

    Input slots past the caller's logical length must be zero (they map to
    zero, one slot each — subtract like ``fold_bytes`` does).
    """
    inline_np, multi_np, pool_np = _decomp_arrays(compat)
    inline = jnp.asarray(inline_np)
    multi = jnp.asarray(multi_np.astype(np.int32))
    pool = jnp.asarray(pool_np)
    max_exp = _MAX_NFKD if compat else _MAX_NFD
    cp = cps[:n]
    f = jnp.take(inline, cp)
    is_multi = f < 0
    m = jnp.take(multi, cp)
    length = jnp.where(is_multi, m & 31, 1)
    pool_off = m >> 5
    out_n = n * max_exp
    starts = jnp.cumsum(length) - length
    out = jnp.zeros((out_n,), jnp.int32)
    for k in range(max_exp):
        val = jnp.where(
            is_multi, jnp.take(pool, jnp.clip(pool_off + k, 0, pool.shape[0] - 1)), f
        )
        dst = jnp.where(k < length, starts + k, out_n)
        out = out.at[dst].set(val, mode="drop")
    count = jnp.sum(length, dtype=jnp.int32)

    return _canonical_reorder(out), count


# Longest combining-mark run the transposition loop will sort before
# falling back to the argsort formulation. UAX#15 streams in practice have
# runs of a handful of marks; only adversarial (zalgo-style) input exceeds
# this, and unbounded passes over the whole stream would make reordering
# O(n * run_length) on untrusted data.
_REORDER_MAX_PASSES = 64


def _reorder_argsort(out: jax.Array, ccc: jax.Array) -> jax.Array:
    """Canonical reordering as two stable LSD argsort passes (ccc first,
    then starter-run id), so no packed key can overflow int32. O(n log n)
    regardless of run structure — the fallback for adversarial inputs."""
    run = jnp.cumsum((ccc == 0).astype(jnp.int32))
    order = jnp.argsort(ccc, stable=True)
    order = jnp.take(order, jnp.argsort(jnp.take(run, order), stable=True))
    return jnp.take(out, order)


@functools.partial(jax.jit, static_argnames=("compat", "max_cp"))
def decompose_rows(
    cps: jax.Array, lengths: jax.Array, compat: bool = False, max_cp: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """NFD/NFKD of codepoint ROWS: (out int32[R, C*max_exp], counts[R]).

    The benchmark-scale formulation (the flat ``decompose`` kernel's
    ``.at[dst].set`` scatter and whole-stream reorder measured
    seconds-per-call): rows stay independent, the 1→N expansion compacts
    with ONE per-row sort (packed single-operand when every output stays
    in the BMP), and canonical reordering runs row-locally — callers
    stage rows cut at starter boundaries (``ccc == 0``), which the
    UAX#15 reorder never crosses, so row-local == global. All table maps
    are rule maps pruned to ``max_cp``.
    """
    from stringwars_tpu.ops import rulemap

    inline_rules, mlen_rules, pos_maps, max_exp, ccc_rules, out_max = _decomp_rules(
        compat, max_cp
    )
    R, C = cps.shape
    cp = cps.astype(jnp.int32)
    valid = jnp.arange(C, dtype=jnp.int32)[None, :] < lengths[:, None]
    f = rulemap.range_map(cp, inline_rules)
    mlen = rulemap.range_map(cp, mlen_rules)
    evals = [rulemap.range_map(cp, r) for r in pos_maps]

    length = jnp.where(valid, jnp.where(mlen > 0, mlen, 1), 0)
    starts = jnp.cumsum(length, axis=1) - length
    out_w = max_exp * C
    big = jnp.int32(out_w)
    chans = []
    keys = []
    for k in range(max_exp):
        v = jnp.where(mlen > 0, evals[k], f) if k == 0 else evals[k]
        chans.append(v)
        keys.append(jnp.where(length > k, starts + k, big))
    keyc = jnp.concatenate(keys, axis=1)
    valc = jnp.concatenate(chans, axis=1)
    if out_max <= 0xFFFF:
        packed = jax.lax.sort((keyc << 16) | valc, dimension=1)
        out = packed & jnp.int32(0xFFFF)
    else:
        _, out = jax.lax.sort([keyc, valc], dimension=1, num_keys=1)
    counts = jnp.sum(length, axis=1, dtype=jnp.int32)
    live = jnp.arange(out_w, dtype=jnp.int32)[None, :] < counts[:, None]
    out = jnp.where(live, out, 0)
    return _canonical_reorder_rows(out, ccc_rules), counts


def _canonical_reorder_rows(out: jax.Array, ccc_rules) -> jax.Array:
    """Row-local UAX#15 D109 reorder by bounded odd-even transposition.

    Same exchange condition as the flat ``_canonical_reorder`` applied
    along axis 1; rows must not split combining runs (caller staging cuts
    at starters). The fixpoint is bounded; non-convergence (zalgo rows)
    falls back to the per-row stable two-pass argsort.
    """
    from stringwars_tpu.ops import rulemap

    ccc0 = rulemap.step_map(out, ccc_rules)
    m = out.shape[1]
    parity = jnp.arange(m - 1, dtype=jnp.int32)[None, :] & 1

    def one_pass(x, c, p):
        do = (parity == p) & (c[:, :-1] > c[:, 1:]) & (c[:, 1:] > 0)
        take_next = jnp.pad(do, ((0, 0), (0, 1)))
        take_prev = jnp.pad(do, ((0, 0), (1, 0)))

        def swap(a):
            nxt = jnp.concatenate([a[:, 1:], a[:, -1:]], axis=1)
            prv = jnp.concatenate([a[:, :1], a[:, :-1]], axis=1)
            return jnp.where(take_next, nxt, jnp.where(take_prev, prv, a))

        return swap(x), swap(c), jnp.any(do)

    def body(state):
        x, c, _, i = state
        x, c, m0 = one_pass(x, c, 0)
        x, c, m1 = one_pass(x, c, 1)
        return x, c, m0 | m1, i + 1

    sorted_out, sorted_ccc, dirty, _ = jax.lax.while_loop(
        lambda s: s[2] & (s[3] < _REORDER_MAX_PASSES),
        body,
        (out, ccc0, jnp.bool_(True), jnp.int32(0)),
    )

    def argsort_rows(x, c):
        run = jnp.cumsum((c == 0).astype(jnp.int32), axis=1)
        order = jnp.argsort(c, axis=1, stable=True)
        order = jnp.take_along_axis(
            order, jnp.argsort(jnp.take_along_axis(run, order, 1), axis=1, stable=True), 1
        )
        return jnp.take_along_axis(x, order, 1)

    return jax.lax.cond(dirty, argsort_rows, lambda x, c: x, sorted_out, sorted_ccc)


def stream_starter_rows(cps_np: np.ndarray, width: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """Stage a flat codepoint stream as [R, width] rows cut ONLY at
    starters (ccc == 0), so row-local canonical reordering is exact.
    Returns (rows int32[R, width], lengths int32[R]). A combining run
    longer than ``width`` (untrusted zalgo input) raises — callers route
    such streams through the exact flat kernel instead.
    """
    ccc = _ccc_np()
    n = int(cps_np.shape[0])
    is_starter = ccc[np.clip(cps_np, 0, ccc.shape[0] - 1)] == 0
    starts = [0]
    while starts[-1] + width < n:
        e = starts[-1] + width
        while e > starts[-1] and not is_starter[e]:
            e -= 1
        if e == starts[-1]:
            raise ValueError("combining run exceeds the row width")
        starts.append(e)
    rows = len(starts)
    buf = np.zeros((rows, width), np.int32)
    lengths = np.zeros(rows, np.int32)
    for i, s in enumerate(starts):
        e = starts[i + 1] if i + 1 < rows else n
        lengths[i] = e - s
        buf[i, : e - s] = cps_np[s:e]
    return buf, lengths


def _canonical_reorder(out: jax.Array) -> jax.Array:
    """Canonical reordering (UAX#15 D109) by odd-even transposition.

    The reorder only permutes within maximal runs of nonzero-CCC marks
    (the exchange condition is ``ccc[i] > ccc[i+1] > 0``, so starters
    never move), and real runs are a handful of marks — a fixpoint loop
    of adjacent compare-exchange passes converges in ~run-length
    iterations of cheap elementwise traffic. The previous formulation
    (two stable argsorts over the n·max_exp stream) was spec-equivalent
    but sorts tens of millions of keys where these passes touch each
    element a handful of times.
    Equal CCC values never exchange, so stability is preserved.

    The fixpoint is capped at ``_REORDER_MAX_PASSES`` pass-pairs; a stream
    still unconverged (a combining run longer than ~128 marks — untrusted
    input only) reorders via the argsort fallback instead, keeping the
    worst case O(n log n).
    """
    ccc0 = jnp.take(jnp.asarray(_ccc_np()), out)
    m = out.shape[0]
    parity = jnp.arange(m - 1, dtype=jnp.int32) & 1

    def one_pass(x, c, p):
        do = (parity == p) & (c[:-1] > c[1:]) & (c[1:] > 0)
        take_next = jnp.concatenate([do, jnp.zeros((1,), bool)])
        take_prev = jnp.concatenate([jnp.zeros((1,), bool), do])

        def swap(a):
            nxt = jnp.concatenate([a[1:], a[-1:]])
            prv = jnp.concatenate([a[:1], a[:-1]])
            return jnp.where(take_next, nxt, jnp.where(take_prev, prv, a))

        return swap(x), swap(c), jnp.any(do)

    def body(state):
        x, c, _, i = state
        x, c, m0 = one_pass(x, c, 0)
        x, c, m1 = one_pass(x, c, 1)
        return x, c, m0 | m1, i + 1

    sorted_out, sorted_ccc, dirty, _ = jax.lax.while_loop(
        lambda s: s[2] & (s[3] < _REORDER_MAX_PASSES),
        body,
        (out, ccc0, jnp.bool_(True), jnp.int32(0)),
    )
    return jax.lax.cond(
        dirty,
        lambda x, c: _reorder_argsort(x, c),
        lambda x, c: x,
        sorted_out,
        sorted_ccc,
    )


def _compose_scan(cps: jax.Array):
    """Sequential UAX#15 composition over a reordered NFD stream.

    Standard algorithm: walk the stream carrying (last starter value,
    ccc of the last kept character). A character C composes with the
    carried starter L iff a primary composite (or Hangul composition)
    exists and C is not blocked (nothing kept between L and C has
    ccc >= ccc(C); tracked as ``last_cc == 0 or last_cc < ccc(C)``).

    Returns values int32[n]: -1 at consumed slots, the kept codepoint at
    mark slots, and the *final composed value* at starter slots (resolved
    by a segment-last pass after the scan).
    """
    s_rank_np, c_rank_np, dense_np, n_c = _pair_tables()
    s_rank = jnp.asarray(s_rank_np)
    c_rank = jnp.asarray(c_rank_np)
    dense = jnp.asarray(dense_np)
    ccc_t = jnp.asarray(_ccc_np())

    def step(carry, cp):
        starter, last_cc = carry
        c = jnp.take(ccc_t, cp)
        # Hangul L+V / LV+T (both have ccc 0: adjacency enforced below).
        is_l = (starter >= _LBASE) & (starter < _LBASE + _LCOUNT)
        is_v = (cp >= _VBASE) & (cp < _VBASE + _VCOUNT)
        lv = _SBASE + ((starter - _LBASE) * _VCOUNT + (cp - _VBASE)) * _TCOUNT
        is_lv = (
            (starter >= _SBASE)
            & (starter < _SBASE + 11172)
            & (((starter - _SBASE) % _TCOUNT) == 0)
        )
        is_t = (cp > _TBASE) & (cp < _TBASE + _TCOUNT)
        hangul = jnp.where(
            is_l & is_v, lv, jnp.where(is_lv & is_t, starter + (cp - _TBASE), -1)
        )
        pair = jnp.take(dense, jnp.take(s_rank, jnp.maximum(starter, 0)) * n_c + jnp.take(c_rank, cp))
        composed = jnp.where(hangul >= 0, hangul, jnp.where(pair > 0, pair, -1))
        not_blocked = (last_cc == 0) | (last_cc < c)
        do = (starter >= 0) & (composed >= 0) & not_blocked
        is_starter = (c == 0) & ~do
        new_starter = jnp.where(do, composed, jnp.where(is_starter, cp, starter))
        new_last = jnp.where(do, last_cc, jnp.where(is_starter, 0, c))
        emit = jnp.where(do, -1, jnp.where(is_starter, -2, cp))
        return (new_starter, new_last), (emit, new_starter)

    n = cps.shape[0]
    (_, _), (emits, starters_after) = jax.lax.scan(
        step, (jnp.int32(-1), jnp.int32(0)), cps
    )
    # Resolve each starter slot to the carried starter's final value: the
    # last ``starters_after`` within its run (runs delimited by starter slots).
    is_starter_slot = emits == -2
    run = jnp.cumsum(is_starter_slot.astype(jnp.int32))
    # seg_last[r] = starters_after at the last position of run r (scatter
    # with duplicate indices is order-undefined, so use searchsorted).
    last_pos = jnp.searchsorted(run, jnp.arange(n + 1, dtype=run.dtype), side="right") - 1
    seg_last = jnp.take(starters_after, jnp.clip(last_pos, 0, max(n - 1, 0)))
    return jnp.where(is_starter_slot, jnp.take(seg_last, run), emits)


@functools.lru_cache(maxsize=None)
def _nfc_inert_table(compat: bool):
    import numpy as np

    return _inert_np(compat)


@functools.partial(jax.jit, static_argnames=("n", "compat"))
def nfc_quick_check(cps: jax.Array, n: int, compat: bool = False) -> jax.Array:
    """True when every codepoint is composition-inert — the stream is
    already NFC/NFKC verbatim (most real text; skips the compose scan)."""
    inert = jnp.asarray(_nfc_inert_table(compat))
    return jnp.all(jnp.take(inert, cps[:n]))


@functools.lru_cache(maxsize=None)
def _inert_steps(compat: bool, max_cp: int | None = None):
    """Inert table compiled to step rules (ops/rulemap); ``max_cp``
    prunes to the corpus ceiling."""
    from stringwars_tpu.ops.rulemap import compile_steps

    table = _inert_np(compat).astype(np.int32)
    rules = compile_steps(table)
    if max_cp is not None:
        rules = rules.prune(max_cp)
    return rules, table


def _rows_all_in_class(data: jax.Array, lengths: jax.Array, rules, table) -> jax.Array:
    """bool[B]: every codepoint of each UTF-8 row satisfies a compiled
    boolean class table."""
    from stringwars_tpu.ops.casefold import _decode_rows
    from stringwars_tpu.ops.rulemap import step_map

    cp, is_lead = _decode_rows(data.astype(jnp.int32), lengths)
    ok = step_map(cp, rules, table).astype(bool)
    return jnp.all(ok | ~is_lead, axis=1)


@functools.partial(jax.jit, static_argnames=("compat", "max_cp"))
def rows_inert(
    data: jax.Array, lengths: jax.Array, compat: bool = False, max_cp: int | None = None
) -> jax.Array:
    """bool[B]: each UTF-8 row is normalization-inert (already NFC *and*
    NFD verbatim: identity decomposition, ccc 0, not a combiner).

    The NFD/NFKD quick check: non-inert rows route through the exact
    decompose kernel. (For NFC/NFKC use ``rows_nfc_verbatim`` — the
    UAX#15 quick-check class is much wider, since precomposed text is
    already NFC.)
    """
    rules, table = _inert_steps(compat, max_cp)
    return _rows_all_in_class(data, lengths, rules, table)


@functools.lru_cache(maxsize=None)
def _nfc_fast_steps(compat: bool, max_cp: int | None = None):
    from stringwars_tpu.ops.rulemap import compile_steps

    table = tables.nfc_fast_table(compat).astype(np.int32)
    rules = compile_steps(table)
    if max_cp is not None:
        rules = rules.prune(max_cp)
    return rules, table


@functools.partial(jax.jit, static_argnames=("compat", "max_cp"))
def rows_nfc_verbatim(
    data: jax.Array, lengths: jax.Array, compat: bool = False, max_cp: int | None = None
) -> jax.Array:
    """bool[B]: each UTF-8 row is verbatim its own NFC (NFKC w/ ``compat``).

    The production NFC quick check — the UAX#15 quick check (QC=Yes and
    ccc==0 per codepoint) that real precomposed text passes, exactly the
    fast path ICU serves; rows that fail (combining marks, compat forms)
    route through the exact compose kernels. Keying on composition
    inertness instead would misroute all precomposed Cyrillic/Latin-1
    text into the sequential compose scan.
    """
    rules, table = _nfc_fast_steps(compat, max_cp)
    return _rows_all_in_class(data, lengths, rules, table)


def rows_nfc_verbatim_host(data_np: np.ndarray, lengths_np: np.ndarray, compat: bool = False) -> np.ndarray:
    """Staging-time (numpy) twin of ``rows_nfc_verbatim``."""
    _rules, table = _nfc_fast_steps(compat)
    return _rows_check_host(data_np, lengths_np, table)


def rows_inert_host(data_np: np.ndarray, lengths_np: np.ndarray, compat: bool = False) -> np.ndarray:
    """Staging-time (numpy) twin of ``rows_inert`` for slow-row routing."""
    _rules, table = _inert_steps(compat)
    return _rows_check_host(data_np, lengths_np, table)


def _rows_check_host(data_np: np.ndarray, lengths_np: np.ndarray, table: np.ndarray) -> np.ndarray:
    B, W = data_np.shape
    b = data_np.astype(np.int64)
    is_lead = (b & 0xC0) != 0x80
    pos = np.arange(W)[None, :]
    valid = pos < lengths_np[:, None]
    # Inert check only needs lead-byte decoding; reuse the byte widths.
    nxt = lambda k: (np.pad(b, ((0, 0), (0, k)))[:, k:] & 0x3F) if k else b  # noqa: E731
    width = np.select(
        [b < 0x80, b < 0xC0, b < 0xE0, b < 0xF0, b < 0xF8],
        [1, 0, 2, 3, 4],
        0,
    )
    b1, b2, b3 = nxt(1), nxt(2), nxt(3)
    cp = np.select(
        [width == 1, width == 2, width == 3],
        [b, ((b & 0x1F) << 6) | b1, ((b & 0x0F) << 12) | (b1 << 6) | b2],
        ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3,
    )
    ok = table[np.clip(cp, 0, table.shape[0] - 1)].astype(bool)
    return np.all(ok | ~(is_lead & valid), axis=1)


@functools.partial(jax.jit, static_argnames=("n", "compat"))
def _nfc_padded(cps: jax.Array, n: int, compat: bool):
    nfd, count = decompose(cps, n, compat)
    vals = _compose_scan(nfd)
    keep = (vals >= 0) & (jnp.arange(nfd.shape[0], dtype=jnp.int32) < count)
    dst = jnp.cumsum(keep.astype(jnp.int32)) - 1
    dst = jnp.where(keep, dst, nfd.shape[0])
    out = jnp.zeros_like(nfd).at[dst].set(vals, mode="drop")
    kept = jnp.sum(keep, dtype=jnp.int32)
    return out, kept, count


def normalize(text_cps: np.ndarray, form: str = "NFC") -> np.ndarray:
    """Normalize a host codepoint array; returns the normalized array.

    Forms: NFD, NFKD, NFC, NFKC. (Host wrapper around the device kernels;
    suites call the jitted pieces directly on padded streams.)
    """
    compat = form in ("NFKD", "NFKC")
    n = int(text_cps.shape[0])
    if n == 0:
        return text_cps.astype(np.int32)
    # Pad to a power-of-two bucket so jit programs are shared across sizes
    # (padding zeros normalize to zero slots the kernels already exclude —
    # but only past `count`; zeros inside [0, n) are counted, so subtract).
    bucket = 16
    while bucket < n:
        bucket *= 2
    padded = np.zeros(bucket, np.int32)
    padded[:n] = text_cps
    pad_slots = bucket - n
    cps = jnp.asarray(padded)
    if form in ("NFD", "NFKD"):
        out, count = decompose(cps, bucket, compat)
        return np.asarray(out)[: int(count) - pad_slots]
    if bool(nfc_quick_check(cps, bucket, compat)):
        return text_cps.astype(np.int32)  # already normalized (fast path)
    out, kept, _ = _nfc_padded(cps, bucket, compat)
    return np.asarray(out)[: int(kept) - pad_slots]


def normalize_text(text: str, form: str = "NFC") -> str:
    cps = np.array([ord(c) for c in text], np.int32)
    return "".join(chr(c) for c in normalize(cps, form))
