"""Multi-pattern counting through ``ac_count`` (the ``_ac_scan`` gather
chain) vs brute force and the native sequential scan: the byteset and
small-dictionary shapes of the find suite."""

import numpy as np
import pytest

from stringwars_tpu.ops.ahocorasick import Automaton, ac_count


def brute_count(patterns, hay: bytes) -> int:
    total = 0
    for p in patterns:
        start = 0
        while True:
            i = hay.find(p, start)
            if i < 0:
                break
            total += 1
            start = i + 1
    return total


@pytest.mark.parametrize(
    "patterns",
    [
        [b"the", b"and", b"tion", b"abcd"],
        [b"a"],
        [b"ab", b"ba", b"aa"],
        [b"abc", b"bc", b"c"],  # nested: every suffix fires
    ],
)
def test_shiftand_matches_brute(rng, patterns):
    hay = bytes(rng.integers(97, 101, 9_000, dtype=np.uint8))  # a-d soup
    got = ac_count(Automaton(patterns), np.frombuffer(hay, np.uint8))
    assert got == brute_count(patterns, hay)


def test_shiftand_matches_ac(rng):
    patterns = [b"the", b"and", b"tion", b"abcd"]
    hay = rng.integers(97, 123, 40_000, dtype=np.uint8)
    auto = Automaton(patterns)
    assert ac_count(auto, hay) == auto.count_host(hay)


def test_shiftand_capacity_guard():
    with pytest.raises(ValueError, match="at least one"):
        Automaton([])
    with pytest.raises(ValueError, match="empty"):
        Automaton([b"ok", b""])


def test_shiftand_seams(rng):
    # Matches straddling chunk seams must be counted once.
    hay = np.frombuffer(b"needle" * 3000, np.uint8)
    auto = Automaton([b"needle", b"dle"])
    assert ac_count(auto, hay, chunk=1024) == 3000 * 2
    assert ac_count(auto, hay, chunk=100) == 3000 * 2


def test_shiftand_two_words(rng):
    # A dictionary longer than 32 pattern bytes in total.
    patterns = [b"needle", b"haystack", b"pattern", b"search", b"string", b"find", b"match"]
    assert sum(map(len, patterns)) > 32
    text = bytearray(rng.integers(97, 123, 20_000, dtype=np.uint8))
    for i in range(0, 19_000, 371):
        p = patterns[i % len(patterns)]
        text[i : i + len(p)] = p
    hay = bytes(text)
    got = ac_count(Automaton(patterns), np.frombuffer(hay, np.uint8))
    assert got == brute_count(patterns, hay)
