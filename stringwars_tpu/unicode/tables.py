"""Unicode tables: dense, device-friendly arrays over [0, 0x110000).

Tables derived from CPython's ``unicodedata`` (UCD 15.0) are computed in
memory at first use (about a second each):

- ``fold``: full case folding (C+F): 1→N codepoint expansion stored as a
  flat expansion pool + per-cp (offset, length); 1:1 folds inline.
  Source of truth: ``str.casefold()`` (implements full Unicode case
  folding including ß→ss and ligatures).
- ``decomp_nfd`` / ``decomp_nfkd``: fully-expanded canonical / compat
  decompositions (pool + offsets), Hangul included (precomputed).
- ``ccc``: canonical combining class per cp.
- ``comp_pairs``: primary composites (starter, combining) → composed,
  derived by NFC round-trip so exclusions are honored.
- ``whitespace`` / ``newline``: boolean class tables (tokenization).

The break-property tables (TR29 grapheme/word/sentence, UAX#14 line,
Extended_Pictographic, InCB) come from the ``regex`` module's UCD classes
and ship with the package as compressed ``.npz`` files under ``data/``, so
running the library needs no ``regex``. Regenerate them with::

    python -m stringwars_tpu.unicode.tables
"""

from __future__ import annotations

import functools
import os
import sys
import unicodedata

import numpy as np

MAX_CP = 0x110000
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# The 25 Unicode whitespace codepoints the reference splits on
# (tokenization/bench.rs whitespaces) = str.isspace() plus NEL/ZWSP-adjacent
# set; we use Python's str.isspace() which matches UCD White_Space.
NEWLINE_CPS = (0x0A, 0x0B, 0x0C, 0x0D, 0x85, 0x2028, 0x2029)


def _pooled(mapping: dict[int, list[int]]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode cp→sequence as (inline, offsets, pool): inline[cp] is the
    mapped cp when the expansion length is 1 (the common case), else -1;
    offsets[cp] packs (pool_offset << 5 | length) for multi-cp expansions
    (max observed length 18, U+FDFA under NFKD)."""
    inline = np.arange(MAX_CP, dtype=np.int32)
    multi_off = np.zeros(MAX_CP, dtype=np.int64)
    pool: list[int] = []
    for cp, seq in mapping.items():
        if len(seq) == 1:
            inline[cp] = seq[0]
        else:
            assert len(seq) < 32, (cp, seq)
            multi_off[cp] = (len(pool) << 5) | len(seq)
            inline[cp] = -1
            pool.extend(seq)
    return inline, multi_off, np.array(pool or [0], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def casefold_tables():
    """(inline, multi, pool): full case folding per codepoint."""
    mapping: dict[int, list[int]] = {}
    for cp in range(MAX_CP):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        folded = chr(cp).casefold()
        if folded != chr(cp):
            mapping[cp] = [ord(c) for c in folded]
    return _pooled(mapping)


@functools.lru_cache(maxsize=None)
def decomposition_tables(compat: bool):
    """Fully-expanded NFD (or NFKD) decomposition per codepoint."""
    form = "NFKD" if compat else "NFD"
    mapping: dict[int, list[int]] = {}
    for cp in range(MAX_CP):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        expanded = unicodedata.normalize(form, chr(cp))
        if expanded != chr(cp):
            mapping[cp] = [ord(c) for c in expanded]
    return _pooled(mapping)


@functools.lru_cache(maxsize=None)
def ccc_table() -> np.ndarray:
    ccc = np.zeros(MAX_CP, dtype=np.uint8)
    for cp in range(MAX_CP):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ccc[cp] = unicodedata.combining(chr(cp))
    return ccc


@functools.lru_cache(maxsize=None)
def composition_pairs() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starters, combiners, composed): primary composites, exclusions
    honored (derived by NFC round-trip of each canonical 2-cp
    decomposition). Hangul LV/LVT excluded (algorithmic)."""
    starters, combiners, composed = [], [], []
    ccc = ccc_table()
    for cp in range(MAX_CP):
        if 0xD800 <= cp <= 0xDFFF or 0xAC00 <= cp <= 0xD7A3:
            continue
        raw = unicodedata.decomposition(chr(cp))
        if not raw or raw.startswith("<"):
            continue
        parts = [int(p, 16) for p in raw.split()]
        if len(parts) != 2 or ccc[parts[0]] != 0:
            continue
        if unicodedata.normalize("NFC", chr(parts[0]) + chr(parts[1])) == chr(cp):
            starters.append(parts[0])
            combiners.append(parts[1])
            composed.append(cp)
    return (
        np.array(starters, np.int32),
        np.array(combiners, np.int32),
        np.array(composed, np.int32),
    )


@functools.lru_cache(maxsize=None)
def nfc_fast_table(compat: bool) -> np.ndarray:
    """bool[MAX_CP]: cp is "NFC-fast" — UAX#15 quick-check **Yes** with
    ccc == 0, so any run of such codepoints is verbatim its own NFC
    (NFKC when ``compat``). This is the property ICU's quick check keys
    on; it is much wider than composition-inertness — precomposed text
    (й, ä, 가) is QC=Yes even though those characters HAVE canonical
    decompositions, which is exactly why real DE/RU/EL corpora take the
    fast path.

    Derivation: QC=No iff ``normalize(form, cp)`` rewrites the lone cp
    (it can never survive into the form); QC=Maybe iff the cp may compose
    with a preceding starter — primary combiners plus Hangul V/T jamo;
    plus ccc == 0 so no reordering question arises. Surrogates excluded.
    """
    form = "NFKC" if compat else "NFC"
    fast = np.zeros(MAX_CP, dtype=bool)
    ccc = ccc_table()
    for cp in range(MAX_CP):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        c = chr(cp)
        fast[cp] = ccc[cp] == 0 and unicodedata.normalize(form, c) == c
    _, combiners, _ = composition_pairs()
    fast[combiners] = False
    fast[0x1161:0x1176] = False  # Hangul V jamo (QC=Maybe)
    fast[0x11A8:0x11C3] = False  # Hangul T jamo (QC=Maybe)
    return fast


@functools.lru_cache(maxsize=None)
def whitespace_table() -> np.ndarray:
    ws = np.zeros(MAX_CP, dtype=bool)
    for cp in range(0x4000):  # all UCD White_Space cps are < 0x4000
        if chr(cp).isspace():
            ws[cp] = True
    return ws


@functools.lru_cache(maxsize=None)
def newline_table() -> np.ndarray:
    nl = np.zeros(MAX_CP, dtype=bool)
    for cp in NEWLINE_CPS:
        nl[cp] = True
    return nl


# ---------------------------------------------------------------------------
# Break-property tables (TR29 / UAX#14), generated via the `regex` module,
# which exposes the UCD break properties as \p{...} classes, and shipped
# in ``data/``.
# ---------------------------------------------------------------------------

GCB_VALUES = (
    "Other", "CR", "LF", "Control", "Extend", "ZWJ", "Regional_Indicator",
    "Prepend", "SpacingMark", "L", "V", "T", "LV", "LVT",
)
WB_VALUES = (
    "Other", "CR", "LF", "Newline", "Extend", "ZWJ", "Regional_Indicator",
    "Format", "Katakana", "Hebrew_Letter", "ALetter", "Single_Quote",
    "Double_Quote", "MidNumLet", "MidLetter", "MidNum", "Numeric",
    "ExtendNumLet", "WSegSpace",
)
SB_VALUES = (
    "Other", "CR", "LF", "Extend", "Sep", "Format", "Sp", "Lower", "Upper",
    "OLetter", "Numeric", "ATerm", "STerm", "Close", "SContinue",
)
LB_VALUES = (
    "XX", "BK", "CR", "LF", "NL", "SP", "ZW", "WJ", "GL", "BA", "BB",
    "B2", "HY", "CB", "CL", "CP", "EX", "IN", "NS", "OP", "QU", "IS",
    "NU", "PO", "PR", "SY", "AI", "AL", "CJ", "EB", "EM", "H2", "H3",
    "HL", "ID", "JL", "JT", "JV", "RI", "SA", "CM", "ZWJ",
)
INCB_VALUES = ("None", "Extend", "Linker", "Consonant")

# File stem -> (regex property, class values); values[0] is the default.
BREAK_PROPERTIES = {
    "gcb": ("Grapheme_Cluster_Break", GCB_VALUES),
    "wb": ("Word_Break", WB_VALUES),
    "sb": ("Sentence_Break", SB_VALUES),
    "lb": ("Line_Break", LB_VALUES),
    "incb": ("InCB", INCB_VALUES),
    "extpict": ("Extended_Pictographic", None),
}


def _scan_property(prop: str, values: tuple[str, ...] | None) -> np.ndarray:
    """Classify every codepoint by regex \\p{prop=value} span scans
    (a binary property when ``values`` is None)."""
    import regex

    all_chars = "".join(
        chr(c) for c in range(MAX_CP) if not (0xD800 <= c <= 0xDFFF)
    )
    cp_of_index = np.array(
        [c for c in range(MAX_CP) if not (0xD800 <= c <= 0xDFFF)], dtype=np.int64
    )
    if values is None:
        table = np.zeros(MAX_CP, dtype=bool)
        for m in regex.compile(rf"[\p{{{prop}}}]+", regex.V1).finditer(all_chars):
            table[cp_of_index[m.start() : m.end()]] = True
        return table
    table = np.zeros(MAX_CP, dtype=np.uint8)  # 0 = values[0] ("Other")
    for vi, value in enumerate(values[1:], start=1):
        pattern = regex.compile(rf"[\p{{{prop}={value}}}]+", regex.V1)
        for m in pattern.finditer(all_chars):
            table[cp_of_index[m.start() : m.end()]] = vi
    return table


def generate_break_tables(out_dir: str = DATA_DIR) -> None:
    """Regenerate every break-property table into ``out_dir`` (needs
    ``regex``)."""
    os.makedirs(out_dir, exist_ok=True)
    for stem, (prop, values) in BREAK_PROPERTIES.items():
        np.savez_compressed(os.path.join(out_dir, f"{stem}.npz"), t=_scan_property(prop, values))


@functools.lru_cache(maxsize=None)
def _break_table(stem: str) -> np.ndarray:
    path = os.path.join(DATA_DIR, f"{stem}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing; regenerate with `python -m stringwars_tpu.unicode.tables`"
        )
    with np.load(path) as z:
        return z["t"]


def grapheme_break_table() -> np.ndarray:
    return _break_table("gcb")


def word_break_table() -> np.ndarray:
    return _break_table("wb")


def sentence_break_table() -> np.ndarray:
    return _break_table("sb")


def extended_pictographic_table() -> np.ndarray:
    return _break_table("extpict")


def line_break_table() -> tuple[np.ndarray, tuple[str, ...]]:
    """UAX#14 line-break classes (resolved set used by the pair rules)."""
    return _break_table("lb"), LB_VALUES


def incb_table() -> np.ndarray:
    """Indic_Conjunct_Break: 0=None, 1=Extend, 2=Linker, 3=Consonant (GB9c)."""
    return _break_table("incb")


if __name__ == "__main__":
    generate_break_tables()
    print(f"wrote {len(BREAK_PROPERTIES)} break tables to {DATA_DIR}", file=sys.stderr)
