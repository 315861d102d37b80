"""UCD-grade conformance sweeps (SURVEY.md §4; reference README.md:544-571).

The official UCD test files (GraphemeBreakTest.txt, NormalizationTest.txt,
…) are not vendorable in this offline image, so these tests reproduce the
files' *methodology* from the same database the tables derive from:

- Grapheme: the official file enumerates ``÷``/``×`` verdicts for every
  ordered pair of break-class representatives (plus curated sequences).
  Here every GCB-class-pair sequence — with Extend/ZWJ/RI paddings that
  activate the context rules — is segmented by the kernel and checked
  against ``regex \\X``, an independent implementation of the same rules.
- Normalization: NormalizationTest.txt's core is one row per decomposable
  codepoint plus combining-reorder cases. Here EVERY codepoint with a
  canonical or compatibility decomposition round-trips through all four
  forms against ``unicodedata.normalize``, plus randomized combining-mark
  permutations (CCC reorder) and the full Hangul syllable range sampled.
"""

import sys
import unicodedata

import numpy as np
import pytest
regex = pytest.importorskip("regex")

from stringwars_tpu.ops.segment import grapheme_clusters
from stringwars_tpu.unicode import tables


def regex_clusters(text: str) -> list[str]:
    return regex.findall(r"\X", text)


def _gcb_representatives() -> dict[str, list[int]]:
    """A few representative codepoints per Grapheme_Cluster_Break class."""
    t = tables.grapheme_break_table()
    pict = tables.extended_pictographic_table()
    reps: dict[str, list[int]] = {}
    for vi, name in enumerate(tables.GCB_VALUES):
        cps = np.flatnonzero(t == vi)
        if name == "Other":
            picks = [0x41, 0x7A, 0x391, 0x4E00]
            picks.append(0x1F600)  # ExtPict Other (GB11)
        else:
            picks = []
            seen_pict = set()
            for cp in cps[:2000]:
                cp = int(cp)
                if 0xD800 <= cp <= 0xDFFF:
                    continue
                key = bool(pict[cp])
                if key not in seen_pict or len(picks) < 2:
                    picks.append(cp)
                    seen_pict.add(key)
                if len(picks) >= 3:
                    break
        reps[name] = picks
    return reps


def test_grapheme_all_class_pairs():
    """Every ordered pair of GCB-class representatives segments like regex \\X."""
    reps = _gcb_representatives()
    flat = [cp for picks in reps.values() for cp in picks]
    failures = []
    for a in flat:
        for b in flat:
            text = chr(a) + chr(b)
            got = grapheme_clusters(text)
            want = regex_clusters(text)
            if got != want:
                failures.append((hex(a), hex(b), got, want))
    assert not failures, f"{len(failures)} pair mismatches, first 5: {failures[:5]}"


def test_grapheme_context_rules():
    """Triples+ activating GB9c/GB11/GB12-13 context (parity, ZWJ chains)."""
    reps = _gcb_representatives()
    ri = reps["Regional_Indicator"][0]
    zwj = 0x200D
    ext = reps["Extend"][0]
    pict = 0x1F600
    deva_ka, virama = 0x0915, 0x094D  # GB9c consonant + linker
    seqs = [
        [ri] * 2,
        [ri] * 3,
        [ri] * 4,
        [ri] * 5,
        [0x41, ri, ri, ri],
        [pict, zwj, pict],
        [pict, ext, zwj, pict],
        [pict, ext, ext, zwj, pict],
        [0x41, zwj, pict],
        [zwj, pict],
        [deva_ka, virama, deva_ka],
        [deva_ka, ext, virama, deva_ka],
        [deva_ka, virama, virama, deva_ka],
        [deva_ka, deva_ka],
        [0x0D, 0x0A, 0x41],
        [0x41, 0x0D, 0x0A],
    ]
    for seq in seqs:
        text = "".join(chr(c) for c in seq)
        assert grapheme_clusters(text) == regex_clusters(text), [hex(c) for c in seq]


def test_grapheme_random_class_soup(rng):
    """Random sequences drawn across all classes vs regex \\X."""
    reps = _gcb_representatives()
    flat = np.array([cp for picks in reps.values() for cp in picks])
    for _ in range(150):
        n = int(rng.integers(1, 12))
        seq = flat[rng.integers(0, flat.size, n)]
        text = "".join(chr(int(c)) for c in seq)
        got = grapheme_clusters(text)
        want = regex_clusters(text)
        assert got == want, [hex(int(c)) for c in seq]


def _decomposable_codepoints():
    out = []
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        if unicodedata.decomposition(chr(cp)):
            out.append(cp)
    return out


def test_normalization_every_decomposable_codepoint():
    """All four forms agree with unicodedata for EVERY decomposable cp.

    This is the NormalizationTest.txt core (one row per decomposable
    codepoint) regenerated from the same UCD.
    """
    from stringwars_tpu.ops.normalize import normalize_text

    cps = _decomposable_codepoints()
    assert len(cps) > 5000  # sanity: the UCD has ~5.7k decomposable cps
    failures = []
    chunk = 64  # normalize in chunks to exercise multi-cp streams too
    for lo in range(0, len(cps), chunk):
        text = "".join(chr(c) for c in cps[lo : lo + chunk])
        for form in ("NFD", "NFKD", "NFC", "NFKC"):
            got = normalize_text(text, form)
            want = unicodedata.normalize(form, text)
            if got != want:
                for ch in text:
                    if normalize_text(ch, form) != unicodedata.normalize(form, ch):
                        failures.append((form, hex(ord(ch))))
    assert not failures, f"{len(failures)} mismatches, first 10: {failures[:10]}"


def test_normalization_hangul_full_rows(rng):
    """Hangul syllables: every L/V/T class combination (sampled rows +
    the algorithmic corners) round-trips through all four forms."""
    from stringwars_tpu.ops.normalize import normalize_text

    corners = [0xAC00, 0xAC01, 0xAC1C, 0xD7A3, 0xD788]
    sampled = [int(c) for c in rng.integers(0xAC00, 0xD7A4, 120)]
    text = "".join(chr(c) for c in corners + sampled)
    for form in ("NFD", "NFKD", "NFC", "NFKC"):
        assert normalize_text(text, form) == unicodedata.normalize(form, text), form


def test_normalization_combining_permutations(rng):
    """CCC reorder: random starter + shuffled combining marks must
    canonically reorder identically to unicodedata (the Part-2 rows of
    NormalizationTest.txt)."""
    from stringwars_tpu.ops.normalize import normalize_text

    ccc = tables.ccc_table()
    marks = np.flatnonzero(ccc > 0)
    starters = [0x61, 0x71, 0x915, 0x3B1, 0x5D0]
    for _ in range(120):
        base = starters[int(rng.integers(0, len(starters)))]
        k = int(rng.integers(1, 5))
        ms = marks[rng.integers(0, marks.size, k)]
        text = chr(base) + "".join(chr(int(m)) for m in ms)
        for form in ("NFC", "NFD"):
            got = normalize_text(text, form)
            want = unicodedata.normalize(form, text)
            assert got == want, (form, [hex(ord(c)) for c in text])
