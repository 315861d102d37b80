"""K6 conformance: MinHash signatures vs the numpy spec replay + quality."""

import numpy as np
import pytest

from stringwars_tpu.ops.fingerprint import (
    bit_entropy,
    collision_rate,
    fingerprint,
    fingerprint_ref,
)
from stringwars_tpu.tape import PaddedTokens, Tape


def _tokens(token_list, **kw):
    return PaddedTokens.from_tape(Tape.from_tokens(token_list), **kw)


def test_fingerprint_matches_spec(rng):
    tokens = [
        b"hello world, this is a document about fingerprinting",
        b"tiny",
        bytes(rng.integers(0, 256, 200, dtype=np.uint8)),
        b"x" * 40,
    ]
    mh, mc = fingerprint(_tokens(tokens), ndim=16)
    mh, mc = np.asarray(mh), np.asarray(mc)
    for i, t in enumerate(tokens):
        want_h, want_c = fingerprint_ref(t, ndim=16)
        np.testing.assert_array_equal(mh[i], want_h, err_msg=f"token {i} hashes")
        np.testing.assert_array_equal(mc[i], want_c, err_msg=f"token {i} counts")


def test_fingerprint_short_token_defined():
    mh, mc = fingerprint(_tokens([b"ab"]), ndim=8)
    assert np.asarray(mh).shape == (1, 8)
    assert (np.asarray(mc) >= 1).all()


def test_jaccard_similarity_ordering(rng):
    base = bytes(rng.integers(97, 123, 500, dtype=np.uint8))
    near = bytearray(base)
    for p in rng.integers(0, 500, 10):
        near[p] = 120
    far = bytes(rng.integers(97, 123, 500, dtype=np.uint8))
    mh, _ = fingerprint(_tokens([base, bytes(near), far]), ndim=128)
    mh = np.asarray(mh)
    sim_near = (mh[0] == mh[1]).mean()
    sim_far = (mh[0] == mh[2]).mean()
    assert sim_near > 0.5
    assert sim_far < 0.2


def test_quality_metrics(rng):
    docs = [bytes(rng.integers(0, 256, 300, dtype=np.uint8)) for _ in range(32)]
    mh, _ = fingerprint(_tokens(docs), ndim=64)
    mh = np.asarray(mh)
    assert bit_entropy(mh) > 0.95
    assert collision_rate(mh) < 0.1


def test_ndim_divisibility():
    with pytest.raises(ValueError):
        fingerprint(_tokens([b"abc"]), ndim=10)


def test_fingerprint_pallas_matches_xla(rng):
    """Batched signatures == the per-token numpy replay, including empty,
    one-byte and repetitive tokens, at several dim chunkings."""
    from stringwars_tpu.tape import PaddedTokens, Tape

    tokens = [
        bytes(rng.integers(32, 127, rng.integers(1, 90), dtype=np.uint8)) for _ in range(40)
    ] + [b"", b"x", b"ab" * 40]
    tokens = [t or b"\x00" for t in tokens]
    toks = PaddedTokens.from_tape(Tape.from_tokens(tokens), align=4)
    want_h, want_c = fingerprint(toks, ndim=64)
    for chunk in (4, 16):
        got_h, got_c = fingerprint(toks, ndim=64, dim_chunk=chunk)
        np.testing.assert_array_equal(np.asarray(got_h), np.asarray(want_h))
        np.testing.assert_array_equal(np.asarray(got_c), np.asarray(want_c))
    for row in list(range(8)) + [len(tokens) - 3, len(tokens) - 2, len(tokens) - 1]:
        ref_h, ref_c = fingerprint_ref(tokens[row], ndim=64)
        np.testing.assert_array_equal(np.asarray(want_h)[row], ref_h)
        np.testing.assert_array_equal(np.asarray(want_c)[row], ref_c)
