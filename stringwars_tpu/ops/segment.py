"""Segmentation: whitespace/newline splits, TR29 graphemes & words (K9).

Reference rows (``tokenization/bench.rs:78-456``): tokenize-whitespace (25
Unicode WS chars), tokenize-newlines, tokenize-words-tr29,
tokenize-graphemes-tr29, tokenize-sentences-tr29, tokenize-lines-uax14 —
all counted as segments per pass over the corpus.

Formulation: segmentation is a *boundary mask* problem. Codepoint
classes come from replicated UCD tables (``unicode.tables``); every TR29
pair rule becomes dense vector logic between shifted class lanes; the
irregular parts (ignore-rules, RI parity, emoji ZWJ context, lookahead)
use cumulative scans (cummax/segmented counts) instead of backtracking.
Counts are mask sums; offsets are ``nonzero``-free (cumsum + scatter).

Each kernel is split into a FEATURE stage (``_*_feats_xla``: blocked
``associative_scan`` prefix scans) and an elementwise RULES stage that XLA
fuses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.ops.utf8 import utf8_decode
from stringwars_tpu.unicode import tables

_ASCII_WS = (9, 10, 11, 12, 13, 32)


# ---------------------------------------------------------------------------
# Building blocks. Class tables evaluate through ``ops/rulemap`` step
# maps; positional "value at the last index where P" lookups evaluate as
# last-valid-value associative scans.
# ---------------------------------------------------------------------------

_SCAN_C = 1024  # lane width of blocked scans


def _assoc_scan(comb, xs):
    """``jax.lax.associative_scan`` for huge 1-D streams, evaluated as a
    two-level blocked scan: per-row scans over a [R, 1024] reshape plus a
    tiny carry scan over the R row tails. XLA's log-depth lowering of a
    whole-stream 1-D scan at 64-128 MB scale produces very large
    programs; the blocked form compiles as small 2-D ops.

    ``comb`` must be associative over the pytree elements (the same
    contract as ``associative_scan``); zero-padding the tail is safe
    because pad slots sit after every real element and are sliced off.
    """
    tmap = jax.tree_util.tree_map
    leaves = jax.tree_util.tree_leaves(xs)
    n = int(leaves[0].shape[0])
    C = _SCAN_C
    if n <= 2 * C:
        return jax.lax.associative_scan(comb, xs)
    R = -(-n // C)
    pad = R * C - n
    blocked = tmap(lambda a: jnp.pad(a, (0, pad)).reshape(R, C), xs)
    rows = jax.lax.associative_scan(comb, blocked, axis=1)
    inc = jax.lax.associative_scan(comb, tmap(lambda a: a[:, -1], rows))
    # Rows 1..R-1 get the exclusive carry of the preceding rows' tails.
    carried = comb(
        tmap(lambda a: a[:-1, None], inc),
        tmap(lambda a: a[1:], rows),
    )
    return tmap(
        lambda first, rest: jnp.concatenate([first[None], rest], 0).reshape(R * C)[:n],
        tmap(lambda a: a[0], rows),
        carried,
    )


def _cumsum_1d(x: jax.Array) -> jax.Array:
    """Blocked ``jnp.cumsum`` twin of ``_assoc_scan`` (same compile-size
    rationale); int32 streams."""
    n = int(x.shape[0])
    C = _SCAN_C
    if n <= 2 * C:
        return jnp.cumsum(x)
    R = -(-n // C)
    b = jnp.pad(x, (0, R * C - n)).reshape(R, C)
    rc = jnp.cumsum(b, axis=1)
    tot = rc[:, -1]
    off = jnp.cumsum(tot) - tot
    return (rc + off[:, None]).reshape(R * C)[:n]


@functools.lru_cache(maxsize=None)
def _steps(table_name: str, max_cp: int | None = None):
    from stringwars_tpu.ops.rulemap import compile_steps

    table = np.asarray(getattr(tables, table_name)())
    rules = compile_steps(table)
    if max_cp is not None:
        rules = rules.prune(max_cp)
    return rules, table


def _class_of(cps: jax.Array, table_name: str, max_cp: int | None = None) -> jax.Array:
    """Class-table lookup; ``max_cp`` (static, from staging) prunes the
    table to the corpus' observed codepoint range."""
    from stringwars_tpu.ops.rulemap import step_map

    rules, table = _steps(table_name, max_cp)
    return step_map(cps, rules, table)


def _last_value(values: jax.Array, mask: jax.Array, init) -> jax.Array:
    """out[i] = values[j] for the largest j <= i with mask[j], else init.

    One max-scan over positions plus a gather: cheaper to compile and run
    than scanning (value, flag) pairs."""
    idx = _last_index(mask)
    return jnp.where(idx >= 0, jnp.take(values, jnp.maximum(idx, 0)), init)


def _last_index(mask: jax.Array) -> jax.Array:
    """Largest j <= i with mask[j], else -1."""
    pos = jnp.arange(mask.shape[0], dtype=jnp.int32)
    return _assoc_scan(jnp.maximum, jnp.where(mask, pos, -1))


def _next_value(values: jax.Array, mask: jax.Array, init) -> jax.Array:
    """out[i] = values[j] for the smallest j >= i with mask[j], else init."""
    return _last_value(values[::-1], mask[::-1], init)[::-1]


def _byte_space(data: jax.Array, n: int):
    """(cp, is_lead, count): codepoints AT their lead-byte positions.

    Segmentation runs entirely in byte-position space — the compaction
    scatter ``utf8_decode`` pays never happens; all
    per-codepoint logic is masked to lead positions and neighbor access
    goes through ``_prev1`` / last-value scans.
    """
    from stringwars_tpu.ops.utf8 import _codepoints_at

    b = data[:n].astype(jnp.int32)
    is_lead = (b & 0xC0) != 0x80
    cp = _codepoints_at(b, n)
    return cp, is_lead, jnp.sum(is_lead.astype(jnp.int32), dtype=jnp.int32)


_CONT = jnp.int32(-9)  # class sentinel at continuation bytes (matches no rule)


def _prev1(x: jax.Array, is_lead: jax.Array, default) -> jax.Array:
    """Value of ``x`` at the previous lead (strictly before each position) —
    the byte-space version of "previous codepoint's value"."""
    lv = _last_value(x, is_lead, default)
    head = jnp.full((1,), default, lv.dtype)
    return jnp.concatenate([head, lv[:-1]])


def _next1(x: jax.Array, is_lead: jax.Array, default) -> jax.Array:
    """Value of ``x`` at the next lead (strictly after each position)."""
    nv = _next_value(x, is_lead, default)
    tail = jnp.full((1,), default, nv.dtype)
    return jnp.concatenate([nv[1:], tail])


def _first_lead(is_lead: jax.Array) -> jax.Array:
    return is_lead & (_cumsum_1d(is_lead.astype(jnp.int32)) == 1)


def _last_two_values(values: jax.Array, mask: jax.Array, init) -> tuple[jax.Array, jax.Array]:
    """(last, second_to_last) masked values at or before each position
    (the two-back context of the TR29 rules WB7/7c/11, SB7)."""
    last = _last_index(mask)
    # The masked position before ``last`` is the last one at or before
    # ``last - 1``.
    prev = jnp.where(last >= 1, jnp.take(last, jnp.maximum(last - 1, 0)), -1)
    pick = lambda idx: jnp.where(idx >= 0, jnp.take(values, jnp.maximum(idx, 0)), init)  # noqa: E731
    return pick(last), pick(prev)


# ---------------------------------------------------------------------------
# Whitespace / newline splitting
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n", "max_cp"))
def whitespace_token_count(
    data: jax.Array, n: int, *, max_cp: int | None = None
) -> jax.Array:
    """Count of runs of non-whitespace codepoints (Unicode White_Space)."""
    cp, is_lead, _count = _byte_space(data, n)
    is_ws = _class_of(cp, "whitespace_table", max_cp).astype(bool)
    tok = is_lead & ~is_ws
    prev_tok = _prev1(tok, is_lead, False)
    return jnp.sum((tok & ~prev_tok).astype(jnp.int32), dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("n", "max_cp"))
def newline_split_count(data: jax.Array, n: int, *, max_cp: int | None = None) -> jax.Array:
    """Count of segments delimited by Unicode newline functions
    (LF, VT, FF, CR, NEL, LS, PS; CRLF counts once)."""
    cp, is_lead, _count = _byte_space(data, n)
    nl = _class_of(cp, "newline_table", max_cp).astype(bool) & is_lead
    # CR and LF are single-byte, so CRLF adjacency is byte adjacency.
    nxt = jnp.pad(cp, (0, 1))[1 : n + 1]
    crlf = is_lead & (cp == 0x0D) & (nxt == 0x0A)
    breaks = jnp.sum((nl & ~crlf).astype(jnp.int32), dtype=jnp.int32)
    return breaks + 1


# ---------------------------------------------------------------------------
# TR29 grapheme clusters
# ---------------------------------------------------------------------------

_G = {name: i for i, name in enumerate(tables.GCB_VALUES)}


def _cummax(x: jax.Array) -> jax.Array:
    return _assoc_scan(jnp.maximum, x)


def _graph_feats_xla(cls, pict, incb, is_lead, n):
    G = _G
    prev = _prev1(cls, is_lead, jnp.int32(0))  # class of previous cp; 0 = Other
    # GB12/13 RI parity: runs of RI ending at the previous cp, odd length.
    ri = cls == G["Regional_Indicator"]
    s = _cumsum_1d(ri.astype(jnp.int32))
    base = _cummax(jnp.where(~ri & is_lead, s, 0))
    ri_run = s - base  # consecutive RIs ending at this cp (inclusive)
    ri_run_prev = _prev1(ri_run, is_lead, jnp.int32(0))
    # GB11 context: before the ZWJ at i-1, the last non-Extend cp is ExtPict.
    pe = _last_value(pict, (cls != G["Extend"]) & is_lead, False)
    pe_before_zwj = _prev1(_prev1(pe, is_lead, False), is_lead, False)  # two cps back
    ctl = (cls == G["Control"]) | (cls == G["CR"]) | (cls == G["LF"])
    ctl_prev = _prev1(ctl, is_lead, False)
    # GB9c (Unicode 15.1 Indic conjuncts) context scans.
    el = (incb == 1) | (incb == 2)  # Extend | Linker
    linker_cum = _cumsum_1d((incb == 2).astype(jnp.int32))
    incb_at_j = _prev1(_last_value(incb, ~el & is_lead, jnp.int32(-1)), is_lead, jnp.int32(-1))
    cum_at_j = _prev1(_last_value(linker_cum, ~el & is_lead, jnp.int32(0)), is_lead, jnp.int32(0))
    linker_at_prev = _prev1(linker_cum, is_lead, jnp.int32(0))  # through prev cp
    return {
        "prev": prev,
        "ri_run_prev": ri_run_prev,
        "pe_before_zwj": pe_before_zwj,
        "ctl_prev": ctl_prev,
        "incb_at_j": incb_at_j,
        "cum_at_j": cum_at_j,
        "linker_at_prev": linker_at_prev,
        "lead_ord": _cumsum_1d(is_lead.astype(jnp.int32)),
    }


@functools.partial(jax.jit, static_argnames=("n", "max_cp"))
def grapheme_boundaries(
    data: jax.Array, n: int, *, max_cp: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """(boundary bool[n], cluster_count) over ``data[:n]`` (UTF-8).

    ``boundary[i]`` is True when a grapheme cluster starts at BYTE offset
    i (engines run in byte-position space; boundaries land on lead bytes).
    """
    cp, is_lead, count = _byte_space(data, n)
    cls = jnp.where(is_lead, _class_of(cp, "grapheme_break_table", max_cp), _CONT)
    pict = _class_of(cp, "extended_pictographic_table", max_cp).astype(bool) & is_lead
    incb = jnp.where(is_lead, _class_of(cp, "incb_table", max_cp), _CONT)
    G = _G

    feats = _graph_feats_xla(cls, pict, incb, is_lead, n)
    env = {
        "cls": cls,
        "pict": pict,
        "incb": incb,
        "lead": is_lead,
        "prev": feats["prev"],
        "ri_run_prev": feats["ri_run_prev"],
        "pe_before_zwj": feats["pe_before_zwj"],
        "ctl_prev": feats["ctl_prev"],
        "incb_at_j": feats["incb_at_j"],
        "cum_at_j": feats["cum_at_j"],
        "linker_at_prev": feats["linker_at_prev"],
        "lead_ord": feats["lead_ord"],
    }
    boundary = _graph_rules(env) > 0
    return boundary, jnp.sum(boundary.astype(jnp.int32), dtype=jnp.int32)


def _graph_rules(e):
    """TR29 grapheme pair rules — elementwise over the feature env."""
    G = _G
    cls = e["cls"]
    incb = e["incb"]
    is_lead = e["lead"] > 0
    pict = e["pict"] > 0
    prev = e["prev"]
    ri = cls == G["Regional_Indicator"]
    pe_before_zwj = e["pe_before_zwj"] > 0
    ctl = (cls == G["Control"]) | (cls == G["CR"]) | (cls == G["LF"])
    ctl_prev = e["ctl_prev"] > 0

    # GB3: CR x LF
    no_break = (prev == G["CR"]) & (cls == G["LF"])
    gb45 = (ctl_prev | ctl) & ~no_break
    # GB6-8 Hangul
    hangul = (
        ((prev == G["L"]) & ((cls == G["L"]) | (cls == G["V"]) | (cls == G["LV"]) | (cls == G["LVT"])))
        | (((prev == G["LV"]) | (prev == G["V"])) & ((cls == G["V"]) | (cls == G["T"])))
        | (((prev == G["LVT"]) | (prev == G["T"])) & (cls == G["T"]))
    )
    # GB9 / 9a / 9b
    attach = (cls == G["Extend"]) | (cls == G["ZWJ"]) | (cls == G["SpacingMark"])
    prepend = prev == G["Prepend"]
    # GB11
    zwj_pict = (prev == G["ZWJ"]) & pict & pe_before_zwj
    # GB12/13
    ri_pair = (prev == G["Regional_Indicator"]) & ri & ((e["ri_run_prev"] % 2) == 1)
    # GB9c (Unicode 15.1 Indic conjuncts): Consonant [Extend|Linker]*
    # Linker [Extend|Linker]* x Consonant. Class / linker-cumsum features
    # are taken AT the last non-(Extend|Linker) cp before this one.
    conjunct = (
        (incb == 3)
        & (e["incb_at_j"] == 3)
        & ((e["linker_at_prev"] - e["cum_at_j"]) >= 1)
    )

    no_break |= (~gb45) & (hangul | attach | prepend | zwj_pict | ri_pair | conjunct)
    boundary = ~no_break & is_lead
    boundary |= is_lead & (e["lead_ord"] == 1)
    return boundary


def _byte_segments(text: str, boundary_fn) -> list[str]:
    """Split ``text`` at the byte-offset boundaries a byte-space engine
    returns (boundaries land on lead bytes, so slices are valid UTF-8)."""
    raw = text.encode()
    data = np.frombuffer(raw, np.uint8)
    n = data.shape[0]
    if n == 0:
        return []
    boundary, _ = boundary_fn(jnp.asarray(data), n)
    starts = np.flatnonzero(np.asarray(boundary))
    ends = np.append(starts[1:], n)
    return [raw[s:e].decode("utf-8") for s, e in zip(starts, ends)]


def grapheme_clusters(text: str) -> list[str]:
    """Host oracle-facing API: split a string into grapheme clusters."""
    return _byte_segments(text, grapheme_boundaries)


# ---------------------------------------------------------------------------
# TR29 word boundaries
# ---------------------------------------------------------------------------

_W = {name: i for i, name in enumerate(tables.WB_VALUES)}


def _word_feats_xla(cls, keep, is_lead, newline, ri, basemask, n):
    last_cls, prev2_cls = _last_two_values(cls, keep, jnp.int32(-1))
    prev_eff = jnp.pad(last_cls, (1, 0), constant_values=-1)[:n]  # < this cp
    prev2_eff = jnp.pad(prev2_cls, (1, 0), constant_values=-1)[:n]
    # Effective next class (skip ignorables forward, strictly after this cp).
    next_cls = _next_value(cls, keep, jnp.int32(-1))
    next_eff = jnp.pad(next_cls, (0, 1), constant_values=-1)[1 : n + 1]
    prev_raw = _prev1(cls, is_lead, jnp.int32(0))
    prev_is_nl = _prev1(newline, is_lead, False)
    # RI parity over non-ignored RIs.
    s = _cumsum_1d(ri.astype(jnp.int32))
    base = _cummax(jnp.where(basemask, s, 0))
    ri_run = s - base
    ri_run_prev_eff = jnp.pad(_last_value(ri_run, keep, 0), (1, 0))[:n]
    return {
        "prev_eff": prev_eff,
        "prev2_eff": prev2_eff,
        "next_eff": next_eff,
        "prev_raw": prev_raw,
        "prev_is_nl": prev_is_nl,
        "ri_run_prev_eff": ri_run_prev_eff,
        "lead_ord": _cumsum_1d(is_lead.astype(jnp.int32)),
    }


@functools.partial(jax.jit, static_argnames=("n", "max_cp"))
def word_boundaries(
    data: jax.Array, n: int, *, max_cp: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """(boundary bool[n], word_segment_count) per TR29 word rules.

    ``boundary[i]`` True = a word boundary exists before codepoint slot i.
    The count reported is the number of *segments* (boundary count over
    [0, count), matching segment-iterator .count() semantics).
    """
    cp, is_lead, count = _byte_space(data, n)
    cls = jnp.where(is_lead, _class_of(cp, "word_break_table", max_cp), _CONT)
    pict = _class_of(cp, "extended_pictographic_table", max_cp).astype(bool) & is_lead
    W = _W

    ignore = (cls == W["Extend"]) | (cls == W["Format"]) | (cls == W["ZWJ"])
    newline = (cls == W["CR"]) | (cls == W["LF"]) | (cls == W["Newline"])
    keep = ~ignore & is_lead
    ri = (cls == W["Regional_Indicator"]) & ~ignore
    basemask = ~ri & ~ignore & is_lead

    feats = _word_feats_xla(cls, keep, is_lead, newline, ri, basemask, n)
    env = {
        "cls": cls,
        "pict": pict,
        "lead": is_lead,
        "prev_eff": feats["prev_eff"],
        "prev2_eff": feats["prev2_eff"],
        "next_eff": feats["next_eff"],
        "prev_raw": feats["prev_raw"],
        "prev_is_nl": feats["prev_is_nl"],
        "ri_run_prev_eff": feats["ri_run_prev_eff"],
        "lead_ord": feats["lead_ord"],
    }
    boundary = _word_rules(env) > 0
    return boundary, jnp.sum(boundary.astype(jnp.int32), dtype=jnp.int32)


def _word_rules(e):
    """TR29 word pair rules — elementwise over the feature env."""
    W = _W
    cls = e["cls"]
    is_lead = e["lead"] > 0
    pict = e["pict"] > 0
    prev_is_nl = e["prev_is_nl"] > 0
    prev_raw = e["prev_raw"]
    next_eff = e["next_eff"]
    ri_run_prev_eff = e["ri_run_prev_eff"]
    ignore = (cls == W["Extend"]) | (cls == W["Format"]) | (cls == W["ZWJ"])
    newline = (cls == W["CR"]) | (cls == W["LF"]) | (cls == W["Newline"])

    def isin(c, names):
        out = c == W[names[0]]
        for name in names[1:]:
            out |= c == W[name]
        return out

    AH = ("ALetter", "Hebrew_Letter")
    MidNumLetQ = ("MidNumLet", "Single_Quote")

    # WB3: CR x LF
    wb3 = (prev_raw == W["CR"]) & (cls == W["LF"])
    no_break = wb3
    # WB3a/3b: breaks around newlines (dominates everything except WB3).
    wb3ab = (prev_is_nl | newline) & ~wb3
    # WB3c: ZWJ x ExtPict (raw adjacency)
    no_break |= (prev_raw == W["ZWJ"]) & pict
    # WB3d: WSegSpace x WSegSpace (raw adjacency)
    no_break |= (prev_raw == W["WSegSpace"]) & (cls == W["WSegSpace"])
    # WB4: X (Extend|Format|ZWJ)* -> no break before ignorables
    # (unless after sot / newline, handled via wb3ab). X may itself be an
    # ignorable (e.g. Extend at sot absorbs a following Extend — official
    # WordBreakTest `÷ 0300 × 0300 ÷`).
    no_break |= ignore & (e["lead_ord"] > 1) & ~prev_is_nl
    # Rules on effective classes (current must be non-ignored).
    cur = jnp.where(ignore, jnp.int32(-2), cls)  # ignorables already decided
    pe, p2 = e["prev_eff"], e["prev2_eff"]
    nb = isin(pe, AH) & isin(cur, AH)  # WB5
    nb |= isin(pe, AH) & (isin(cur, ("MidLetter",)) | isin(cur, MidNumLetQ)) & isin(next_eff, AH)  # WB6
    nb |= (isin(p2, AH) & (isin(pe, ("MidLetter",)) | isin(pe, MidNumLetQ))) & isin(cur, AH)  # WB7
    nb |= (pe == W["Hebrew_Letter"]) & (cur == W["Single_Quote"])  # WB7a
    nb |= (pe == W["Hebrew_Letter"]) & (cur == W["Double_Quote"]) & (next_eff == W["Hebrew_Letter"])  # WB7b
    nb |= (p2 == W["Hebrew_Letter"]) & (pe == W["Double_Quote"]) & (cur == W["Hebrew_Letter"])  # WB7c
    nb |= (pe == W["Numeric"]) & (cur == W["Numeric"])  # WB8
    nb |= isin(pe, AH) & (cur == W["Numeric"])  # WB9
    nb |= (pe == W["Numeric"]) & isin(cur, AH)  # WB10
    nb |= (p2 == W["Numeric"]) & (isin(pe, ("MidNum",)) | isin(pe, MidNumLetQ)) & (cur == W["Numeric"])  # WB11
    nb |= (pe == W["Numeric"]) & (isin(cur, ("MidNum",)) | isin(cur, MidNumLetQ)) & (next_eff == W["Numeric"])  # WB12
    nb |= (pe == W["Katakana"]) & (cur == W["Katakana"])  # WB13
    nb |= isin(pe, ("ALetter", "Hebrew_Letter", "Numeric", "Katakana", "ExtendNumLet")) & (cur == W["ExtendNumLet"])  # WB13a
    nb |= (pe == W["ExtendNumLet"]) & isin(cur, ("ALetter", "Hebrew_Letter", "Numeric", "Katakana"))  # WB13b
    nb |= (pe == W["Regional_Indicator"]) & (cur == W["Regional_Indicator"]) & ((ri_run_prev_eff % 2) == 1)  # WB15/16
    no_break |= nb & ~wb3ab

    boundary = ~no_break & is_lead
    boundary |= is_lead & (e["lead_ord"] == 1)
    return boundary


def word_segments(text: str) -> list[str]:
    """Host API: split into TR29 word segments (including space runs)."""
    return _byte_segments(text, word_boundaries)


# ---------------------------------------------------------------------------
# TR29 sentence boundaries (SB1-SB11; default is NO break — SB998)
# ---------------------------------------------------------------------------

_S = {name: i for i, name in enumerate(tables.SB_VALUES)}


def _sent_feats_xla(cls, keep, is_lead, ign, parasep, n):
    S = _S
    eff = _last_value(cls, keep, jnp.int32(S["Other"]))
    parasep_at_keep = _last_value(parasep, keep, False)
    has_keep = _last_value(jnp.ones_like(cls), keep, 0) > 0
    eff = jnp.where(ign & parasep_at_keep & has_keep, jnp.int32(S["Other"]), eff)
    prev_raw = _prev1(cls, is_lead, jnp.int32(S["Other"]))
    prev_eff = _prev1(eff, is_lead, jnp.int32(S["Other"]))
    # prev2 effective (significant char before the previous one).
    _last_c, prev2_c = _last_two_values(cls, keep, jnp.int32(S["Other"]))
    prev2_eff = jnp.pad(prev2_c, (1, 0), constant_values=S["Other"])[:n]
    # Backward context at prev: skip Sp*, then Close*, then test SATerm.
    # Composition of two last-valid-value scans: f[i] = eff at the last
    # non-Close cp <= i; g[i] = f at the last non-Sp cp <= i.
    other = jnp.int32(S["Other"])
    f_ctx = _last_value(eff, (eff != S["Close"]) & is_lead, other)
    g_ctx = _last_value(f_ctx, (eff != S["Sp"]) & is_lead, other)
    ctx_cls = jnp.pad(g_ctx, (1, 0), constant_values=S["Other"])[:n]  # at prev
    ctx9_cls = jnp.pad(f_ctx, (1, 0), constant_values=S["Other"])[:n]  # SB9: Close* only
    prev_parasep = _prev1(parasep, is_lead, False)
    return {
        "eff": eff,
        "ctx_cls": ctx_cls,
        "ctx9_cls": ctx9_cls,
        "prev_raw": prev_raw,
        "prev_eff": prev_eff,
        "prev2_eff": prev2_eff,
        "prev_parasep": prev_parasep,
        "lead_ord": _cumsum_1d(is_lead.astype(jnp.int32)),
    }


@functools.partial(jax.jit, static_argnames=("n", "max_cp"))
def sentence_boundaries(
    data: jax.Array, n: int, *, max_cp: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """(boundary bool[n], sentence_count) per TR29 sentence rules."""
    cp, is_lead, count = _byte_space(data, n)
    cls = jnp.where(is_lead, _class_of(cp, "sentence_break_table", max_cp), _CONT)
    S = _S

    ign = (cls == S["Extend"]) | (cls == S["Format"])
    parasep = (cls == S["Sep"]) | (cls == S["CR"]) | (cls == S["LF"])
    keep = ~ign & is_lead

    feats = _sent_feats_xla(cls, keep, is_lead, ign, parasep, n)
    eff = feats["eff"]

    # Forward scan for SB8: first "stopper" at/after cur is Lower?
    stopper = (
        (eff == S["OLetter"]) | (eff == S["Upper"]) | (eff == S["Lower"])
        | parasep | (eff == S["ATerm"]) | (eff == S["STerm"])
    )
    next_stop_cls = _next_value(eff, stopper & is_lead, jnp.int32(S["Other"]))

    env = {
        "cls": cls,
        "lead": is_lead,
        "eff": eff,
        "ctx_cls": feats["ctx_cls"],
        "ctx9_cls": feats["ctx9_cls"],
        "prev_raw": feats["prev_raw"],
        "prev_eff": feats["prev_eff"],
        "prev2_eff": feats["prev2_eff"],
        "next_stop_cls": next_stop_cls,
        "prev_parasep": feats["prev_parasep"],
        "lead_ord": feats["lead_ord"],
    }
    boundary = _sent_rules(env) > 0
    return boundary, jnp.sum(boundary.astype(jnp.int32), dtype=jnp.int32)


def _sent_rules(e):
    """TR29 sentence rules (SB3-SB11), lowest to highest precedence —
    elementwise over the feature env."""
    S = _S
    cls = e["cls"]
    is_lead = e["lead"] > 0
    cur = e["eff"]
    ctx_cls, ctx9_cls = e["ctx_cls"], e["ctx9_cls"]
    prev_eff, prev2_eff = e["prev_eff"], e["prev2_eff"]
    prev_parasep = e["prev_parasep"] > 0
    ign = (cls == S["Extend"]) | (cls == S["Format"])
    parasep = (cls == S["Sep"]) | (cls == S["CR"]) | (cls == S["LF"])
    saterm_ctx = (ctx_cls == S["ATerm"]) | (ctx_cls == S["STerm"])
    aterm_ctx = ctx_cls == S["ATerm"]
    saterm_ctx9 = (ctx9_cls == S["ATerm"]) | (ctx9_cls == S["STerm"])

    # SB998: no break; build from lowest to highest precedence.
    one, zero = jnp.int32(1), jnp.int32(0)
    boundary = jnp.zeros_like(cls)
    # SB11: SATerm Close* Sp* ÷ (anything not matched below).
    boundary = jnp.where(saterm_ctx, one, boundary)
    # SB10: ... x (Sp | ParaSep) -> no break.
    boundary = jnp.where(saterm_ctx & ((cur == S["Sp"]) | parasep), zero, boundary)
    # SB9: SATerm Close* x (Close | Sp | ParaSep).
    boundary = jnp.where(
        saterm_ctx9 & ((cur == S["Close"]) | (cur == S["Sp"]) | parasep), zero, boundary
    )
    # SB8a: ... x (SContinue | SATerm).
    boundary = jnp.where(
        saterm_ctx & ((cur == S["SContinue"]) | (cur == S["ATerm"]) | (cur == S["STerm"])),
        zero,
        boundary,
    )
    # SB8: ATerm Close* Sp* x (not-stopper)* Lower.
    boundary = jnp.where(aterm_ctx & (e["next_stop_cls"] == S["Lower"]), zero, boundary)
    # SB7: (Upper|Lower) ATerm x Upper.
    boundary = jnp.where(
        ((prev2_eff == S["Upper"]) | (prev2_eff == S["Lower"]))
        & (prev_eff == S["ATerm"]) & (cur == S["Upper"]),
        zero,
        boundary,
    )
    # SB6: ATerm x Numeric.
    boundary = jnp.where((prev_eff == S["ATerm"]) & (cur == S["Numeric"]), zero, boundary)
    # SB5: x (Extend | Format) — unless after ParaSep.
    boundary = jnp.where(ign & ~prev_parasep, zero, boundary)
    # SB4: ParaSep ÷.
    boundary = jnp.where(prev_parasep, one, boundary)
    # SB3: CR x LF.
    boundary = jnp.where((e["prev_raw"] == S["CR"]) & (cls == S["LF"]), zero, boundary)

    out = (boundary > 0) & is_lead
    out |= is_lead & (e["lead_ord"] == 1)
    return out


def sentence_segments(text: str) -> list[str]:
    """Host API: split a string into TR29 sentence segments."""
    return _byte_segments(text, sentence_boundaries)


# ---------------------------------------------------------------------------
# UAX#14 line-break opportunities (core rule set LB1-LB31)
# ---------------------------------------------------------------------------

_LB_VALUES = None
_L = None


def _lb_classes():
    global _LB_VALUES, _L
    if _L is None:
        table, values = tables.line_break_table()
        _LB_VALUES = values
        _L = {name: i for i, name in enumerate(values)}
    return _L


@functools.lru_cache(maxsize=None)
def _lb_steps(max_cp: int | None = None):
    from stringwars_tpu.ops.rulemap import compile_steps

    table, _values = tables.line_break_table()
    table = np.asarray(table, np.int32)
    rules = compile_steps(table)
    if max_cp is not None:
        rules = rules.prune(max_cp)
    return rules, table


def _lb_class_of(cps: jax.Array, max_cp: int | None = None) -> jax.Array:
    from stringwars_tpu.ops.rulemap import step_map

    rules, table = _lb_steps(max_cp)
    return step_map(cps, rules, table)


def _lb_feats_xla(cls, cm, hard, base_mask, is_lead, n):
    L = _lb_classes()
    base_cls = _last_value(cls, base_mask, jnp.int32(L["AL"]))
    has_base = _last_value(jnp.ones_like(cls), base_mask, 0) > 0
    hard_at_base = _last_value(hard, base_mask, False)
    attached = cm & has_base & ~hard_at_base
    eff = jnp.where(cm, jnp.where(attached, base_cls, L["AL"]), cls)  # LB10: lone CM -> AL
    prev_raw = _prev1(cls, is_lead, jnp.int32(L["BK"]))
    prev = _prev1(eff, is_lead, jnp.int32(L["BK"]))
    # SP*-skipping context (LB8/14/16/17): class before the space run.
    before_sp = jnp.pad(
        _last_value(eff, (eff != L["SP"]) & is_lead, jnp.int32(L["BK"])),
        (1, 0),
        constant_values=L["BK"],
    )[:n]
    prev2 = _prev1(prev, is_lead, jnp.int32(L["BK"]))
    # RI parity (LB30a).
    ri = eff == L["RI"]
    s = _cumsum_1d(ri.astype(jnp.int32))
    base = _cummax(jnp.where(~ri & is_lead, s, 0))
    ri_run_prev = _prev1(s - base, is_lead, jnp.int32(0))
    nxt = _next1(eff, is_lead, jnp.int32(L["BK"]))
    return {
        "attached": attached,
        "eff": eff,
        "prev_raw": prev_raw,
        "prev": prev,
        "before_sp": before_sp,
        "prev2": prev2,
        "ri_run_prev": ri_run_prev,
        "nxt": nxt,
        "lead_ord": _cumsum_1d(is_lead.astype(jnp.int32)),
    }


@functools.partial(jax.jit, static_argnames=("n", "max_cp"))
def linebreak_opportunities(
    data: jax.Array, n: int, *, max_cp: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """(break_allowed bool[n], opportunity_count) per UAX#14 core rules.

    ``break_allowed[i]`` = a line may break before codepoint slot i
    (mandatory breaks included). Implements LB1 class resolution and the
    pair rules LB4-LB31, including LB15 (QU SP* x OP, the UCD 15.0 form)
    and LB25 numeric chains as pairs plus the (PR|PO) x (OP|HY) NU
    lookahead. Intentionally omitted (documented skip list): LB28a —
    its AK/AP/AS/VF/VI classes only exist from UCD 15.1, and this build's
    tables derive from the runtime's unicodedata (UCD 15.0).
    """
    L = _lb_classes()
    cp, is_lead, count = _byte_space(data, n)
    cls = jnp.where(is_lead, _lb_class_of(cp, max_cp), _CONT)

    # LB1 resolution: AI/SA/XX -> AL, CJ -> NS.
    cls = jnp.where((cls == L["AI"]) | (cls == L["SA"]) | (cls == L["XX"]), L["AL"], cls)
    cls = jnp.where(cls == L["CJ"], L["NS"], cls)
    cls = jnp.where(is_lead, cls, _CONT)

    # LB9: X CM* -> X (CM/ZWJ attach to base unless base is BK/CR/LF/NL/SP/ZW).
    cm = (cls == L["CM"]) | (cls == L["ZWJ"])
    hard = (
        (cls == L["BK"]) | (cls == L["CR"]) | (cls == L["LF"]) | (cls == L["NL"])
        | (cls == L["SP"]) | (cls == L["ZW"])
    )
    base_mask = ~cm & is_lead

    feats = _lb_feats_xla(cls, cm, hard, base_mask, is_lead, n)
    env = {
        "cls": cls,
        "lead": is_lead,
        "attached": feats["attached"],
        "eff": feats["eff"],
        "prev_raw": feats["prev_raw"],
        "prev": feats["prev"],
        "before_sp": feats["before_sp"],
        "prev2": feats["prev2"],
        "ri_run_prev": feats["ri_run_prev"],
        "nxt": feats["nxt"],
        "lead_ord": feats["lead_ord"],
    }
    breaks = _lb_rules(env) > 0
    return breaks, jnp.sum(breaks.astype(jnp.int32), dtype=jnp.int32)


def _lb_rules(e):
    """UAX#14 pair rules LB4-LB31 — elementwise over the feature env."""
    L = _lb_classes()
    cls = e["cls"]
    is_lead = e["lead"] > 0
    attached = e["attached"] > 0
    eff = e["eff"]
    prev_raw = e["prev_raw"]
    prev = e["prev"]
    before_sp = e["before_sp"]
    prev2 = e["prev2"]
    ri_run_prev = e["ri_run_prev"]
    ri = eff == L["RI"]

    def isin(c, names):
        out = c == L[names[0]]
        for name in names[1:]:
            out |= c == L[name]
        return out

    mandatory_prev = isin(prev_raw, ("BK", "CR", "LF", "NL")) & ~(
        (prev_raw == L["CR"]) & (cls == L["LF"])
    )

    no_break = jnp.zeros_like(is_lead)
    # LB6: x (BK|CR|LF|NL); LB5 CRxLF folded in via mandatory_prev.
    no_break |= isin(eff, ("BK", "CR", "LF", "NL"))
    # LB7: x SP, x ZW.
    no_break |= isin(eff, ("SP", "ZW"))
    # LB8a: ZWJ x.
    no_break |= prev_raw == L["ZWJ"]
    # LB9 attachment: x CM (attached).
    no_break |= attached
    # LB11: x WJ; WJ x.
    no_break |= (eff == L["WJ"]) | (prev == L["WJ"])
    # LB12: GL x; LB12a: (not SP|BA|HY) x GL.
    no_break |= prev == L["GL"]
    no_break |= (eff == L["GL"]) & ~isin(prev, ("SP", "BA", "HY"))
    # LB13: x CL|CP|EX|IS|SY.
    no_break |= isin(eff, ("CL", "CP", "EX", "IS", "SY"))
    # LB14: OP SP* x.
    no_break |= before_sp == L["OP"]
    # LB16: (CL|CP) SP* x NS.
    no_break |= isin(before_sp, ("CL", "CP")) & (eff == L["NS"])
    # LB17: B2 SP* x B2.
    no_break |= (before_sp == L["B2"]) & (eff == L["B2"])
    # LB15 (UCD 15.0 form): QU SP* x OP.
    no_break |= (before_sp == L["QU"]) & (eff == L["OP"])
    # LB19: x QU; QU x.
    no_break |= (eff == L["QU"]) | (prev == L["QU"])
    # LB21: x (BA|HY|NS); BB x.
    no_break |= isin(eff, ("BA", "HY", "NS")) | (prev == L["BB"])
    # LB21a: HL (HY|BA) x.
    no_break |= (prev2 == L["HL"]) & isin(prev, ("HY", "BA"))
    # LB21b: SY x HL.
    no_break |= (prev == L["SY"]) & (eff == L["HL"])
    # LB22: x IN.
    no_break |= eff == L["IN"]
    # LB23: (AL|HL) x NU; NU x (AL|HL).
    no_break |= isin(prev, ("AL", "HL")) & (eff == L["NU"])
    no_break |= (prev == L["NU"]) & isin(eff, ("AL", "HL"))
    # LB23a: PR x (ID|EB|EM); (ID|EB|EM) x PO.
    no_break |= (prev == L["PR"]) & isin(eff, ("ID", "EB", "EM"))
    no_break |= isin(prev, ("ID", "EB", "EM")) & (eff == L["PO"])
    # LB24: (PR|PO) x (AL|HL); (AL|HL) x (PR|PO).
    no_break |= isin(prev, ("PR", "PO")) & isin(eff, ("AL", "HL"))
    no_break |= isin(prev, ("AL", "HL")) & isin(eff, ("PR", "PO"))
    # LB25 (simplified pairs): numeric chains.
    no_break |= isin(prev, ("PR", "PO", "OP", "HY", "NU", "SY", "IS")) & (eff == L["NU"])
    no_break |= (prev == L["NU"]) & isin(eff, ("NU", "SY", "IS", "CL", "CP", "PO", "PR"))
    no_break |= isin(prev, ("CL", "CP")) & isin(eff, ("PO", "PR"))
    # LB25 lookahead piece of the full regex: (PR|PO) x (OP|HY) NU — the
    # opener/hyphen glues to a following digit ("$ (100)", "US$-10").
    no_break |= (
        isin(prev, ("PR", "PO")) & isin(eff, ("OP", "HY")) & (e["nxt"] == L["NU"])
    )
    # LB26/27: Korean syllable blocks.
    no_break |= (prev == L["JL"]) & isin(eff, ("JL", "JV", "H2", "H3"))
    no_break |= isin(prev, ("JV", "H2")) & isin(eff, ("JV", "JT"))
    no_break |= isin(prev, ("JT", "H3")) & (eff == L["JT"])
    no_break |= isin(prev, ("JL", "JV", "JT", "H2", "H3")) & (eff == L["PO"])
    no_break |= (prev == L["PR"]) & isin(eff, ("JL", "JV", "JT", "H2", "H3"))
    # LB28: (AL|HL) x (AL|HL).
    no_break |= isin(prev, ("AL", "HL")) & isin(eff, ("AL", "HL"))
    # LB29: IS x (AL|HL).
    no_break |= (prev == L["IS"]) & isin(eff, ("AL", "HL"))
    # LB30: (AL|HL|NU) x OP; CP x (AL|HL|NU).
    no_break |= isin(prev, ("AL", "HL", "NU")) & (eff == L["OP"])
    no_break |= (prev == L["CP"]) & isin(eff, ("AL", "HL", "NU"))
    # LB30a: RI x RI (pairs).
    no_break |= (prev == L["RI"]) & ri & ((ri_run_prev % 2) == 1)
    # LB30b: EB x EM.
    no_break |= (prev == L["EB"]) & (eff == L["EM"])
    # LB20: CB overrides most: break before/after CB (except LB8a/9 above).
    cb_break = ((eff == L["CB"]) | (prev == L["CB"])) & ~attached & (prev_raw != L["ZWJ"])
    no_break &= ~cb_break

    breaks = ~no_break
    # LB4/5: mandatory after BK/CR/LF/NL (overrides everything).
    breaks |= mandatory_prev
    # LB8: ZW SP* -> break.
    breaks |= (before_sp == L["ZW"]) | (prev == L["ZW"])
    breaks &= is_lead
    breaks &= ~(is_lead & (e["lead_ord"] == 1))  # LB2: no break at sot
    return breaks


def line_break_positions(text: str) -> list[int]:
    """Host API: codepoint indices where a line break is allowed."""
    data = np.frombuffer(text.encode(), np.uint8)
    n = data.shape[0]
    if n == 0:
        return []
    breaks, _ = linebreak_opportunities(jnp.asarray(data), n)
    is_lead = (data & 0xC0) != 0x80
    cp_index = np.cumsum(is_lead) - 1  # codepoint index of each lead byte
    return cp_index[np.flatnonzero(np.asarray(breaks))].tolist()
