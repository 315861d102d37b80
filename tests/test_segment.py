"""K9 conformance: graphemes vs regex \\X, words vs regex WORD boundaries."""

import numpy as np
import pytest
regex = pytest.importorskip("regex")

from stringwars_tpu.ops.segment import (
    grapheme_clusters,
    newline_split_count,
    whitespace_token_count,
    word_segments,
)

GRAPHEME_SAMPLES = [
    "plain",
    "é é",  # precomposed + combining
    "👩‍👩‍👧‍👦 family",  # emoji ZWJ sequence
    "🇺🇸🇫🇷🇩🇪",  # 3 flags (RI pairs)
    "한국어 가각",  # Hangul
    "a\r\nb\rc\nd",  # CRLF handling
    "x‍😀",  # ZWJ then pict after non-pict
    "क्त",  # Devanagari virama
    "é́́",  # stacked marks
    "🏴󠁧󠁢󠁥󠁮󠁧󠁿 tag sequence",
]


@pytest.mark.parametrize("text", GRAPHEME_SAMPLES)
def test_graphemes_match_regex(text):
    assert grapheme_clusters(text) == regex.findall(r"\X", text)


def test_graphemes_fuzz(rng):
    pool = (
        list(range(0x20, 0x7F))
        + [0x301, 0x302, 0x200D, 0x1F600, 0x1F1E6, 0x1F1E7, 0x1F1E8]
        + [0x0D, 0x0A, 0x1100, 0x1161, 0x11A8, 0xAC00, 0xAC01, 0x93C]
    )
    pool = np.array(pool)
    for _ in range(100):
        k = int(rng.integers(1, 20))
        text = "".join(chr(c) for c in pool[rng.integers(0, pool.size, k)])
        assert grapheme_clusters(text) == regex.findall(r"\X", text), repr(text)


WORD_SAMPLES = [
    "Hello, world! It's 3.14 can't stop",
    "a_b_c snake_case123 and CamelCase",
    "don't re-enter U.S.A. 1,234.56",
    "Hebrew אב\"ג quote",
    "katakana カタカナ mixed",
    "line\nbreaks\r\nhere",
    "🇺🇸🇫🇷 flags and 😀 emoji",
    "spaces   tabs\t\tmix",
]


def _regex_words(text: str) -> list[str]:
    # regex WORD flag implements TR29 default word boundaries for \b.
    bounds = [0]
    for m in regex.finditer(r"\b", text, flags=regex.V1 | regex.WORD):
        if m.start() not in bounds:
            bounds.append(m.start())
    if len(text) not in bounds:
        bounds.append(len(text))
    return [text[a:b] for a, b in zip(bounds, bounds[1:])]


@pytest.mark.parametrize("text", WORD_SAMPLES)
def test_words_match_regex(text):
    assert word_segments(text) == _regex_words(text)


def test_words_fuzz(rng):
    # Pool restricted to where regex's tailored \b agrees with strict TR29
    # defaults (regex joins leading apostrophes/Extends beyond UAX#29 —
    # see test_words_strict_tr29 for the divergent cases).
    pool = np.array(
        list(range(0x30, 0x3A))
        + list(range(0x41, 0x5B))
        + [0x20, 0x2E, 0x2C, 0x5F, 0x2D, 0x05D0, 0x30AB, 0x0A, 0x301]
    )
    checked = 0
    for _ in range(150):
        k = int(rng.integers(1, 24))
        text = "".join(chr(c) for c in pool[rng.integers(0, pool.size, k)])
        if 0x300 <= ord(text[0]) <= 0x36F:
            continue  # leading Extend: regex tailors, strict TR29 splits
        checked += 1
        assert word_segments(text) == _regex_words(text), repr(text)
    assert checked > 100


def test_words_strict_tr29():
    """Hand-derived strict UAX#29 defaults where regex's \\b is tailored."""
    # No rule joins Single_Quote x ALetter: break (WB999).
    assert word_segments("'Oak") == ["'", "Oak"]
    # Leading Extend is its own segment (nothing precedes it to attach to).
    assert word_segments("́ab") == ["́", "ab"]
    # But ALetter (SQ) ALetter is WB6/WB7: one word.
    assert word_segments("don't") == ["don't"]
    # Numeric (MidNum) Numeric joined; trailing MidNum split off.
    assert word_segments("1,234,") == ["1,234", ","]


def test_whitespace_count():
    text = "  hello\tworld x   y "
    data = np.frombuffer(text.encode(), np.uint8)
    assert int(whitespace_token_count(data, data.shape[0])) == len(text.split())


def test_newline_count():
    text = "a\nb\r\nc\rd e"
    data = np.frombuffer(text.encode(), np.uint8)
    assert int(newline_split_count(data, data.shape[0])) == 5
