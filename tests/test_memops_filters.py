"""K12 memory ops + K7 filter conformance."""

import numpy as np
import pytest

from stringwars_tpu.ops import hash as H
from stringwars_tpu.ops.filters import bloom_build, bloom_query, fuse_build, fuse_query
from stringwars_tpu.ops.memops import (
    copy,
    fill,
    fill_random,
    invert_case_lut,
    lut_translate,
    move,
)
from stringwars_tpu.tape import PaddedTokens, Tape


def test_lut_translate(rng):
    data = rng.integers(0, 256, 10_000, dtype=np.uint8)
    lut = rng.integers(0, 256, 256, dtype=np.uint8)
    want = lut[data]
    np.testing.assert_array_equal(np.asarray(lut_translate(data, lut)), want)
    # Identity and constant tables.
    ident = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(lut_translate(data, ident)), data)
    np.testing.assert_array_equal(np.asarray(lut_translate(data, np.full(256, 7, np.uint8))), 7)


def test_invert_case():
    data = np.frombuffer(b"Hello World 123", np.uint8)
    got = np.asarray(lut_translate(data, invert_case_lut())).tobytes()
    assert got == b"hELLO wORLD 123"


def test_fill_copy_move(rng):
    assert (np.asarray(fill(100, 7)) == 7).all()
    data = rng.integers(0, 256, 100, dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(copy(data)), data)
    moved = np.asarray(move(data, 8))
    np.testing.assert_array_equal(moved[:92], data[8:])
    assert (moved[92:] == 0).all()


def test_fill_random_reproducible():
    a = np.asarray(fill_random(42, 1000))
    b = np.asarray(fill_random(42, 1000))
    c = np.asarray(fill_random(43, 1000))
    np.testing.assert_array_equal(a, b)
    assert not (a == c).all()
    assert a.shape == (1000,)
    # Uniformity sanity: mean of random bytes near 127.5.
    assert 100 < a.astype(np.float64).mean() < 155


@pytest.fixture
def token_split(rng):
    tokens = list({bytes(rng.integers(97, 123, rng.integers(4, 20), dtype=np.uint8)) for _ in range(3000)})
    rng.shuffle(tokens)
    cut = int(len(tokens) * 0.8)
    return tokens[:cut], tokens[cut:]


def _layout(tokens):
    return H.prepare(PaddedTokens.from_tape(Tape.from_tokens(tokens), align=4))


def test_bloom_no_false_negatives_and_fpr(token_split):
    inserted, held_out = token_split
    seeds = (1, 2, 3, 4, 5, 6, 7)
    m_bits = 1 << 15
    filt = bloom_build(_layout(inserted), seeds, m_bits)
    hits = np.asarray(bloom_query(filt, _layout(inserted)))
    assert hits.all(), "Bloom filters must have zero false negatives"
    fp = np.asarray(bloom_query(filt, _layout(held_out)))
    assert fp.mean() < 0.25  # m/n ≈ 13.6 bits/key, k=7 -> low FPR
    assert filt.bits_per_key(len(inserted)) > 8


def test_fuse_no_false_negatives_and_fpr(token_split):
    inserted, held_out = token_split
    ins_keys = H.xxh64(_layout(inserted)).to_numpy()
    out_keys = H.xxh64(_layout(held_out)).to_numpy()
    out_keys = np.setdiff1d(out_keys, ins_keys)
    filt = fuse_build(ins_keys)
    assert np.asarray(fuse_query(filt, ins_keys)).all()
    fpr = np.asarray(fuse_query(filt, out_keys)).mean()
    assert fpr < 0.02  # 8-bit fingerprints -> ~0.4 % expected
    assert filt.bits_per_key(len(ins_keys)) < 30
