"""Case folding, uncased compare/search, canonical normalization (K10).

Reference rows: ``sz::utf8_uncased_fold`` (full Unicode fold into an
expansion-aware buffer), ``utf8_norm`` NFC/NFD/NFKC/NFKD,
``utf8_uncased_order`` (case-insensitive compare), ``utf8_uncased_search``
(all caseless matches; only PCRE2 among the reference baselines does
*full* folding ß→ss — ``normalization/bench.rs:381-386`` — and so does
this module).

Pipeline shape: byte stream → UTF-32 (K8 decode) → table map with 1→N
expansion (scatter over prefix-sum destinations) → downstream compare /
window search on int32 codepoint lanes. Tables are 4.4 MB replicated
constants generated from UCD 15.0 (``stringwars_tpu.unicode.tables``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.ops.utf8 import utf8_decode
from stringwars_tpu.unicode import tables

_MAX_EXPANSION = 3  # full case fold expands to at most 3 codepoints


@functools.lru_cache(maxsize=None)
def _fold_arrays():
    # Cached as numpy so jit tracing embeds them as constants (never cache
    # jnp arrays created under a trace — they would be leaked tracers).
    inline, multi, pool = tables.casefold_tables()
    return inline, multi.astype(np.int32), pool


@functools.lru_cache(maxsize=None)
def _fold_rules(max_cp: int | None = None):
    """Rule sets: (simple-fold range rules, expansion-length sparse map,
    packed-e1e2 sparse map, e3 sparse map). Expansion chars are packed
    two-per-rule-value (e1 | e2 << 16; every pool char fits 16 bits).

    ``max_cp`` (static, from staging) prunes to the corpus' observed
    codepoint ceiling, which also bounds the expansion width ``max_exp``."""
    from stringwars_tpu.ops import rulemap

    inline, multi, pool = _fold_arrays()
    simple = rulemap.compile_fold(inline)
    keys = np.flatnonzero(inline < 0)
    m = multi[keys]
    lengths = (m & 31).astype(np.int64)
    off = (m >> 5).astype(np.int64)
    assert int(pool.max()) <= 0xFFFF, "expansion pool char exceeds 16 bits"
    e1 = pool[off]
    e2 = np.where(lengths >= 2, pool[np.minimum(off + 1, pool.shape[0] - 1)], 0)
    e3 = np.where(lengths >= 3, pool[np.minimum(off + 2, pool.shape[0] - 1)], 0)
    mlen_rules = rulemap.compile_sparse_values(keys, lengths)
    e12_rules = rulemap.compile_sparse_values(keys, (e1 | (e2 << 16)).astype(np.int64))
    e3_keys = keys[e3 > 0]
    e3_rules = rulemap.compile_sparse_values(
        e3_keys if e3_keys.size else np.asarray([0x10FFFF]),
        e3[e3 > 0] if e3_keys.size else np.asarray([0]),
    )
    if max_cp is not None:
        simple, mlen_rules, e12_rules, e3_rules = (
            r.prune(max_cp) for r in (simple, mlen_rules, e12_rules, e3_rules)
        )
        in_range = keys <= max_cp
        max_exp = int(lengths[in_range].max()) if in_range.any() else 1
    else:
        max_exp = _MAX_EXPANSION
    return simple, mlen_rules, e12_rules, e3_rules, max_exp


@functools.partial(jax.jit, static_argnames=("n",))
def fold_codepoints(cps: jax.Array, n: int) -> tuple[jax.Array, jax.Array]:
    """Full-case-fold a codepoint stream: returns (folded int32[ceil(3n)],
    folded_count). Slots past the count are zero."""
    inline_np, multi_np, pool_np = _fold_arrays()
    inline, multi, pool = jnp.asarray(inline_np), jnp.asarray(multi_np), jnp.asarray(pool_np)
    cp = cps[:n]
    f = jnp.take(inline, cp)
    is_multi = f < 0
    m = jnp.take(multi, cp)
    length = jnp.where(is_multi, m & 31, 1)
    pool_off = m >> 5
    out_n = n * _MAX_EXPANSION
    starts = jnp.cumsum(length) - length
    out = jnp.zeros((out_n,), jnp.int32)
    for k in range(_MAX_EXPANSION):
        val = jnp.where(is_multi, jnp.take(pool, jnp.clip(pool_off + k, 0, pool.shape[0] - 1)), f)
        dst = jnp.where(k < length, starts + k, out_n)
        out = out.at[dst].set(val, mode="drop")
    return out, jnp.sum(length, dtype=jnp.int32)


@jax.jit
def fold_tokens_ascii(tokens) -> tuple[jax.Array, jax.Array]:
    """ASCII fast-path full case fold: bytewise, 1:1, no scatters.

    For pure-ASCII tokens the full Unicode fold IS lowercase (every
    1→N expansion starts above U+00DF), so folding is three vector ops
    per byte instead of the general kernel's decode + expansion
    scatters — the analog of the reference kernels' ASCII runs
    (case fold on English measures 7.53 GB/s there,
    ``normalization/README.md``). Returns (folded uint8[B, W],
    counts = lengths). Caller guarantees ASCII purity (see
    :func:`fold_tokens_auto`)."""
    data = tokens.data
    is_upper = (data >= 65) & (data <= 90)
    return jnp.where(is_upper, data | jnp.uint8(0x20), data), tokens.lengths


def fold_tokens_auto(tokens, data_np=None):
    """Dispatch the ASCII fast path when the batch is pure ASCII.

    ``data_np`` (host bytes, optional) avoids a device readback for the
    purity check; staging-time dispatch mirrors the reference's
    run-length ASCII specialization. Returns (folded, counts, ascii_flag)
    where ``folded`` is uint8[B, W] on the fast path and the expanded
    int32 codepoint matrix otherwise."""
    import numpy as np

    probe = data_np if data_np is not None else np.asarray(tokens.data)
    if not probe.size or int(probe.max()) < 0x80:
        folded, counts = fold_tokens_ascii(tokens)
        return folded, counts, True
    folded, counts = fold_tokens(tokens)
    return folded, counts, False


def fold_bytes(data, n: int | None = None) -> tuple[jax.Array, jax.Array]:
    """UTF-8 bytes → folded codepoint stream (decode + fold)."""
    data = jnp.asarray(data, jnp.uint8)
    n = int(data.shape[0]) if n is None else n
    cps, count = utf8_decode(data, n)
    # Fold over the compacted prefix; count is dynamic, so fold the full
    # padded buffer (slots past count are zero == no expansion).
    folded, fcount = fold_codepoints(cps, cps.shape[0])
    # Zero-slots fold to zero and occupy one output slot each; subtract.
    pad_slots = jnp.int32(cps.shape[0]) - count
    return folded, fcount - pad_slots


def fold_text(text: str) -> str:
    """Host convenience: full case fold of a Python string via the tables
    (tests compare against str.casefold())."""
    data = np.frombuffer(text.encode(), np.uint8)
    folded, count = fold_bytes(data)
    return "".join(chr(c) for c in np.asarray(folded)[: int(count)])


# ---------------------------------------------------------------------------
# Uncased compare / search
# ---------------------------------------------------------------------------

def uncased_equal(a: bytes, b: bytes) -> bool:
    """Full-fold case-insensitive equality (reference
    ``utf8_uncased_order`` == 0; ``normalization/bench.rs:249-254``)."""
    fa, ca = fold_bytes(np.frombuffer(a, np.uint8))
    fb, cb = fold_bytes(np.frombuffer(b, np.uint8))
    ca, cb = int(ca), int(cb)
    if ca != cb:
        return False
    return bool(np.array_equal(np.asarray(fa)[:ca], np.asarray(fb)[:cb]))


@functools.partial(jax.jit, static_argnames=("m",))
def _window_count(hay_cp: jax.Array, needle_cp: jax.Array, hay_n: jax.Array, m: int) -> jax.Array:
    """Count occurrences of an m-cp needle in a codepoint stream."""
    n = hay_cp.shape[0]
    acc = jnp.ones((n,), bool)
    for j in range(m):
        shifted = jnp.pad(hay_cp, (0, m))[j : j + n]
        acc &= shifted == needle_cp[j]
    pos = jnp.arange(n, dtype=jnp.int32)
    acc &= pos <= hay_n - m
    return jnp.sum(acc, dtype=jnp.int32)


def uncased_count(haystack_folded: tuple[jax.Array, jax.Array], needle: bytes) -> int:
    """All caseless matches of ``needle`` in a pre-folded haystack stream.

    Match positions are in folded-codepoint space (the PCRE2-caseless
    semantic); the haystack fold is amortized across needles like the
    reference reuses its uncased needles (``normalization/bench.rs:334-351``).
    """
    folded, count = haystack_folded
    fn, fm = fold_bytes(np.frombuffer(needle, np.uint8))
    fm = int(fm)
    if fm == 0:
        return 0
    needle_cp = jnp.asarray(np.asarray(fn)[:fm])
    return int(_window_count(folded, needle_cp, count, fm))


# ---------------------------------------------------------------------------
# Batched per-token fold + caseless equality
# ---------------------------------------------------------------------------

def _decode_rows(data: jax.Array, lengths: jax.Array):
    """Row-wise UTF-8 decode WITHOUT compaction: codepoints stay at their
    lead-byte positions (gather/scatter-free). Returns (cp, is_lead)."""
    B, W = data.shape
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]
    valid = pos < lengths[:, None]

    def nxt(k):
        return jnp.pad(data, ((0, 0), (0, k)))[:, k:] & 0x3F if k else data

    width = jnp.where(
        data < 0x80,
        1,
        jnp.where(data < 0xC0, 0, jnp.where(data < 0xE0, 2, jnp.where(data < 0xF0, 3, jnp.where(data < 0xF8, 4, 0)))),
    )
    b1, b2, b3 = nxt(1), nxt(2), nxt(3)
    cp = jnp.where(
        width == 1,
        data,
        jnp.where(
            width == 2,
            ((data & 0x1F) << 6) | b1,
            jnp.where(
                width == 3,
                ((data & 0x0F) << 12) | (b1 << 6) | b2,
                ((data & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3,
            ),
        ),
    )
    is_lead = ((data & 0xC0) != 0x80) & valid
    return cp, is_lead


@functools.partial(jax.jit, static_argnames=("max_cp",))
def fold_tokens(tokens, max_cp: int | None = None) -> tuple[jax.Array, jax.Array]:
    """Row-wise full case fold of a PaddedTokens batch.

    Returns (folded int32[B, 3W], folded_count int32[B]); each row is the
    folded codepoint sequence of that token (compacted to the row front).

    Pipeline:

    1. decode leaves codepoints AT their lead-byte positions;
    2. the simple fold is ~200 range rules (``ops/rulemap``), one table
       gather;
    3. 1→3 expansions come from sparse equality maps packed two chars per
       value;
    4. compaction (drop continuation slots, splice expansions) is ONE
       ``lax.sort`` by destination index per row instead of a scatter.
    """
    from stringwars_tpu.ops import rulemap

    data = tokens.data.astype(jnp.int32)  # [B, W]
    B, W = data.shape
    cp, is_lead = _decode_rows(data, tokens.lengths)

    simple, mlen_rules, e12_rules, e3_rules, max_exp = _fold_rules(max_cp)
    folded = rulemap.range_map(cp, simple)
    mlen = rulemap.range_map(cp, mlen_rules)
    e12 = rulemap.range_map(cp, e12_rules)

    length = jnp.where(is_lead, jnp.where(mlen > 0, mlen, 1), 0)
    starts = jnp.cumsum(length, axis=1) - length  # exclusive prefix

    # max_exp is STATIC from the pruned rules (a <=0xFF corpus folds to
    # at most 2 codepoints), so the compaction sort width shrinks with
    # the corpus — the sort is the dominant per-element cost.
    out_w = max_exp * W
    big = jnp.int32(out_w)
    v0 = jnp.where(mlen > 0, e12 & 0xFFFF, folded)
    chans = [v0]
    key_list = [jnp.where(length >= 1, starts, big)]
    if max_exp >= 2:
        chans.append(e12 >> 16)
        key_list.append(jnp.where(length >= 2, starts + 1, big))
    if max_exp >= 3:
        chans.append(rulemap.range_map(cp, e3_rules))
        key_list.append(jnp.where(length >= 3, starts + 2, big))
    keys = jnp.concatenate(key_list, axis=1)
    vals = jnp.concatenate(chans, axis=1)
    if max_cp is not None and max_cp <= 0xFFFF:
        # BMP corpora: case folds of BMP codepoints stay in the BMP (the
        # expansion pool is 16-bit by assertion; simple folds never cross
        # into astral planes), so (dst << 16 | val) packs into one
        # positive int32 and the compaction is a SINGLE-operand sort —
        # half the bitonic data movement of the [keys, vals] pair sort.
        # Live dsts are unique, so packing cannot reorder equal keys.
        packed = jax.lax.sort((keys << 16) | vals, dimension=1)
        out = packed & jnp.int32(0xFFFF)
    else:
        _, out = jax.lax.sort([keys, vals], dimension=1, num_keys=1)
    counts = jnp.sum(length, axis=1, dtype=jnp.int32)
    # Zero the tail (sorted BIG-key slots carry stale channel values).
    live = jnp.arange(out_w, dtype=jnp.int32)[None, :] < counts[:, None]
    return jnp.where(live, out, 0), counts


def uncased_equal_batch(a_tokens, b_tokens) -> jax.Array:
    """bool[B]: full-fold caseless equality of token pairs (one dispatch)."""
    fa, ca = fold_tokens(a_tokens)
    fb, cb = fold_tokens(b_tokens)
    W = max(fa.shape[1], fb.shape[1])
    if fa.shape[1] < W:
        fa = jnp.pad(fa, ((0, 0), (0, W - fa.shape[1])))
    if fb.shape[1] < W:
        fb = jnp.pad(fb, ((0, 0), (0, W - fb.shape[1])))
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]
    agree = (fa == fb) | (pos >= ca[:, None])
    return (ca == cb) & jnp.all(agree, axis=1)
