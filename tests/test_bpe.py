"""Byte-level BPE: device encoder vs scalar oracle; trainer sanity."""

import numpy as np
import pytest

from stringwars_tpu.ops.bpe import (
    MergeTable,
    bpe_encode,
    bpe_encode_ref,
    train_merges,
)
from stringwars_tpu.tape import PaddedTokens


def _batch(tokens: list[bytes], width: int | None = None) -> PaddedTokens:
    W = width or max(max(map(len, tokens), default=1), 1)
    data = np.zeros((len(tokens), W), np.uint8)
    for i, t in enumerate(tokens):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
    return PaddedTokens(
        data=data, lengths=np.array([len(t) for t in tokens], np.int32), width=W
    )


def _check(tokens: list[bytes], merges: list[tuple[int, int]]) -> None:
    table = MergeTable.from_merges(merges)
    ids, counts = bpe_encode(_batch(tokens), table)
    ids, counts = np.asarray(ids), np.asarray(counts)
    for i, t in enumerate(tokens):
        want = bpe_encode_ref(t, merges)
        got = ids[i, : counts[i]].tolist()
        assert got == want, (t, got, want)


def test_hand_merges():
    a, b, c = ord("a"), ord("b"), ord("c")
    merges = [(a, a), (a, b), (256, c), (257, 257)]
    _check(
        [b"", b"a", b"aa", b"aaa", b"aaaa", b"aaaaa", b"ab", b"aab",
         b"aac", b"aacaac", b"abab", b"cabcab", b"bca"],
        merges,
    )


def test_overlap_runs():
    a = ord("a")
    _check([b"a" * n for n in range(1, 12)], [(a, a), (256, 256), (257, a)])


def test_trained_roundtrip():
    rng = np.random.default_rng(3)
    words = [
        bytes(rng.choice([ord(c) for c in "abcdef"], rng.integers(1, 12)))
        for _ in range(300)
    ]
    merges = train_merges(words, 40)
    assert len(merges) > 10
    _check(words[:100], merges)


def test_trained_on_text():
    text = (b"the quick brown fox jumps over the lazy dog " * 30).split()
    merges = train_merges(text, 30)
    table = MergeTable.from_merges(merges)
    ids, counts = bpe_encode(_batch(list(set(text))), table)
    ids, counts = np.asarray(ids), np.asarray(counts)
    toks = list(set(text))
    for i, t in enumerate(toks):
        assert ids[i, : counts[i]].tolist() == bpe_encode_ref(t, merges)
    # "the" is frequent: should compress to a single id
    the = toks.index(b"the")
    assert counts[the] == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_random_bytes(seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(0, 256, rng.integers(1, 20))) for _ in range(150)]
    merges = train_merges(words, 25)
    if merges:
        _check(words[:60], merges)


def test_bpe_rules_encoder_matches_ref():
    """The binary-search pair lookup encodes a 64-row batch exactly."""
    import jax.numpy as jnp

    from stringwars_tpu.ops.bpe import MergeTable, bpe_encode, bpe_encode_ref, train_merges
    from stringwars_tpu.tape import PaddedTokens

    rng = np.random.default_rng(7)
    words = [
        bytes(rng.integers(97, 105, rng.integers(1, 16), dtype=np.uint8))
        for _ in range(200)
    ]
    merges = train_merges(words, 40)
    table = MergeTable.from_merges(merges)
    W = 16
    data = np.zeros((64, W), np.uint8)
    lengths = np.zeros(64, np.int32)
    for i, t in enumerate(words[:64]):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    toks = PaddedTokens(data=jnp.asarray(data), lengths=jnp.asarray(lengths), width=W)
    ids, counts = bpe_encode(toks, table)
    ids, counts = np.asarray(ids), np.asarray(counts)
    for i, t in enumerate(words[:64]):
        assert ids[i, : counts[i]].tolist() == bpe_encode_ref(t, merges), t


def test_fused_kernel_matches_oracle(rng):
    """Batched encoder == scalar oracle on fuzzed short words, incl.
    overlap runs and merge cascades."""
    from stringwars_tpu.ops.bpe import MergeTable, bpe_encode, bpe_encode_ref, train_merges

    alphabet = b"abcde"
    words = [
        bytes(alphabet[i] for i in rng.integers(0, len(alphabet), rng.integers(1, 17)))
        for _ in range(700)
    ] + [b"aaaaaaaaaaa", b"ababababab", b"aabbaabb", b"a", b"abcabcabcabc"]
    merges = train_merges(words, 40)
    table = MergeTable.from_merges(merges)
    got, counts = bpe_encode(_batch(words), table)
    g = np.asarray(got)
    for i, w in enumerate(words):
        want = bpe_encode_ref(w, merges)
        assert g[i, : int(counts[i])].tolist() == want, f"word {w!r}"


def test_fused_kernel_group32(rng):
    """Pretokens of 17..32 bytes (the suite's widest rows) == oracle."""
    from stringwars_tpu.ops.bpe import MergeTable, bpe_encode, bpe_encode_ref, train_merges

    alphabet = b"abc"
    words = [
        bytes(alphabet[i] for i in rng.integers(0, 3, rng.integers(10, 33)))
        for _ in range(300)
    ]
    merges = train_merges(words, 30)
    toks = _batch(words)
    assert toks.data.shape[1] > 16
    got, counts = bpe_encode(toks, MergeTable.from_merges(merges))
    g = np.asarray(got)
    for i, w in enumerate(words):
        assert g[i, : int(counts[i])].tolist() == bpe_encode_ref(w, merges), f"word {w!r}"
