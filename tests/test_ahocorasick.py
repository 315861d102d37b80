"""K2 conformance: device AC scan vs native sequential scan vs brute force."""

import numpy as np
import pytest

from stringwars_tpu.ops.ahocorasick import Automaton, ac_count


def brute_count(hay: bytes, patterns: list[bytes]) -> int:
    total = 0
    for p in patterns:
        for i in range(len(hay) - len(p) + 1):
            total += hay[i : i + len(p)] == p
    return total


def test_ac_classic():
    a = Automaton([b"he", b"she", b"his", b"hers"])
    hay = b"ushers he said his history"
    want = brute_count(hay, a.patterns)
    data = np.frombuffer(hay, np.uint8)
    assert a.count_host(data) == want
    assert ac_count(a, data) == want


def test_ac_overlapping_and_nested():
    a = Automaton([b"aa", b"aaa", b"a"])
    hay = b"aaaaa"
    data = np.frombuffer(hay, np.uint8)
    want = brute_count(hay, a.patterns)  # 5 + 4 + 3 = 12
    assert want == 12
    assert ac_count(a, data) == want


def test_ac_chunk_boundaries(rng):
    """Matches spanning chunk seams must be counted exactly once."""
    patterns = [b"abcabc", b"cab", b"bc"]
    hay = bytes(rng.choice(np.frombuffer(b"abc", np.uint8), 20_000).tolist())
    a = Automaton(patterns)
    data = np.frombuffer(hay, np.uint8)
    want = a.count_host(data)
    assert ac_count(a, data, chunk=256) == want
    assert ac_count(a, data, chunk=4096) == want


def test_ac_random_patterns(rng):
    patterns = list({bytes(rng.integers(97, 100, rng.integers(1, 6), dtype=np.uint8)) for _ in range(20)})
    hay = bytes(rng.integers(97, 100, 5000, dtype=np.uint8).tolist())
    a = Automaton(patterns)
    data = np.frombuffer(hay, np.uint8)
    assert ac_count(a, data) == brute_count(hay, patterns) == a.count_host(data)


def test_ac_byteset_equivalence(rng):
    """Single-byte patterns == byteset counting (the reference's usage)."""
    charset = b"</>&'\"=[]"
    a = Automaton([bytes([c]) for c in charset])
    hay = rng.integers(0, 256, 30_000, dtype=np.uint8)
    want = int(np.isin(hay, np.frombuffer(charset, np.uint8)).sum())
    assert ac_count(a, hay) == want


def test_ac_pallas_matches_host(rng):
    """Default staging (many short chunk streams) == native sequential count."""
    hay = rng.integers(97, 103, 20_000, dtype=np.uint8)
    patterns = [b"ab", b"bc", b"abc", b"aa", b"f"]
    a = Automaton(patterns)
    assert ac_count(a, hay) == a.count_host(hay)


def test_ac_pallas_byteset_single_bytes(rng):
    hay = rng.integers(0, 256, 9_000, dtype=np.uint8)
    charset = b"0123456789"
    a = Automaton([bytes([c]) for c in charset])
    want = int(np.isin(hay, np.frombuffer(charset, np.uint8)).sum())
    assert ac_count(a, hay) == want


def test_ac_lut_and_walk_kernels_agree(rng):
    """Staged rows scanned on device (the find suite's row) agree with the
    native count for several chunk widths, including chunks shorter than
    the longest pattern."""
    from stringwars_tpu.ops.ahocorasick import ac_count_staged, stage_rows

    hay = rng.integers(97, 103, 30_000, dtype=np.uint8)
    a = Automaton([b"ab", b"bca", b"aaaa", b"cb", b"abcabc"])
    want = a.count_host(hay)
    n = hay.shape[0]
    got = []
    for chunk in (3, 64, 1000, None):
        rows, gpos0, c = stage_rows(hay, n, a.max_len, chunk)
        got.append(int(ac_count_staged(a, rows, gpos0, n, c)))
    assert got == [want] * 4 and want > 0
