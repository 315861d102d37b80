"""Segmentation at stream scale: the blocked associative-scan feature
stage (``ops/segment.py``, rows of 1024 positions plus a carry scan)
against the host references of the conformance tests, on fuzzed UTF-8
streams long enough to cross many row seams.

References: ``str.split`` (Unicode White_Space runs), ``regex`` ``\\X``
(graphemes), the scalar UAX#29 walkers of ``test_tr29_dual`` (words,
sentences), and for UAX#14 the same kernel run line by line — a
mandatory break resets every rule's context, so the full stream must
agree with its lines evaluated separately.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from stringwars_tpu.ops import segment as SEG
from test_tr29_dual import ref_sentence_segments, ref_word_segments


def _fuzz_text(seed: int, n_cps: int = 4000) -> str:
    """Multilingual + boundary-heavy soup: ASCII words, digits/punct,
    combining marks, Hangul, RI flags, ZWJ emoji, CR/LF."""
    rng = np.random.default_rng(seed)
    pieces = []
    pool = [
        "word", "Don't", "can't", "3.14", "1,000", "a.b", "U.S.A. Next",
        "א׳", "א״א",  # Hebrew quotes
        "é́", "x‍☺", "\U0001F1FA\U0001F1F8\U0001F1EB\U0001F1F7",
        "가각", " ", "  ", "\r\n", "\n", "\t",
        "Mr. Smith went. Home! now? ok", "क्ष",  # Indic conjunct
        "̀̀", "été", "あア中",
        "(foo) [bar]", "$100", "US$-10", "a-b", "“quoted”",
        "\U0001F600\U0001F3FB", "‍", "­", "ë",
    ]
    for _ in range(n_cps // 4):
        pieces.append(pool[int(rng.integers(0, len(pool)))])
    return "".join(pieces)


def _line_breaks_by_line(text: str) -> list[int]:
    """UAX#14 opportunities of each LF-terminated line, in stream indices.

    Each line is padded with LFs to one common byte length (one compiled
    program): in the stream every line but the last is followed by an LF
    anyway, and a trailing LF or the end of text look alike to the rules
    inside the line."""
    lines = text.split("\n")
    width = max(len(line.encode()) for line in lines) + 1
    out, base = [], 0
    for line in lines:
        padded = line + "\n" * (width - len(line.encode()))
        out += [base + p for p in SEG.line_break_positions(padded) if p < len(line)]
        if base + len(line) < len(text):
            # The codepoint after each LF starts a new line: LB5 breaks there.
            out.append(base + len(line) + 1)
        base += len(line) + 1
    return [p for p in out if p < len(text)]


def _check(name: str, text: str) -> None:
    if name == "whitespace":
        data = np.frombuffer(text.encode(), np.uint8)
        got = int(SEG.whitespace_token_count(jnp.asarray(data), int(data.shape[0])))
        assert got == len(text.split())
    elif name == "grapheme":
        regex = pytest.importorskip("regex")
        assert SEG.grapheme_clusters(text) == regex.findall(r"\X", text)
    elif name == "word":
        assert SEG.word_segments(text) == ref_word_segments(text)
    elif name == "sentence":
        assert SEG.sentence_segments(text) == ref_sentence_segments(text)
    else:
        assert SEG.line_break_positions(text) == _line_breaks_by_line(text)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["whitespace", "grapheme", "word", "sentence", "linebreak"])
def test_scanline_matches_xla(name, seed):
    _check(name, _fuzz_text(seed))


def test_scanline_tile_boundaries():
    """Streams straddling the 8192-element boundary: carries must hand off
    exactly (a combining run crossing the seam)."""
    text = "a" * 8189 + "é́x lorem. Ipsum\r\n" + "b" * 9000
    for name in ("grapheme", "word", "sentence", "linebreak"):
        _check(name, text)


def test_fused_scan_reverse_and_chaining():
    """The blocked scan helpers vs numpy on a stream of many rows."""
    rng = np.random.default_rng(3)
    n = 12345
    v = rng.integers(0, 50, n).astype(np.int32)
    f = rng.random(n) < 0.2
    s = np.cumsum(f.astype(np.int32))
    assert np.array_equal(np.asarray(SEG._cumsum_1d(jnp.asarray(f.astype(np.int32)))), s)
    lv = np.full(n, -5, np.int64)
    nv = np.full(n, -5, np.int64)
    cur = -5
    for i in range(n):
        if f[i]:
            cur = v[i]
        lv[i] = cur
    cur = -5
    for i in range(n - 1, -1, -1):
        if f[i]:
            cur = v[i]
        nv[i] = cur
    got_l = SEG._last_value(jnp.asarray(v), jnp.asarray(f), jnp.int32(-5))
    got_n = SEG._next_value(jnp.asarray(v), jnp.asarray(f), jnp.int32(-5))
    assert np.array_equal(np.asarray(got_l), lv)
    assert np.array_equal(np.asarray(got_n), nv)
    assert np.array_equal(np.asarray(SEG._cummax(jnp.asarray(v))), np.maximum.accumulate(v))
