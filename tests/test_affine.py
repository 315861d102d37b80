"""Gotoh NW/SW wavefront (``ops/similarity``) vs the brute-force oracle,
linear and affine gaps, mixed and uniform lengths, empty sides."""

import jax.numpy as jnp
import numpy as np
import pytest

from stringwars_tpu.ops import similarity as S


def _rand_tokens(rng, n, lo, hi):
    return [bytes(rng.integers(65, 69, rng.integers(lo, hi), dtype=np.uint8)) for _ in range(n)]


def _scores(a_toks, b_toks, *, gap_open=-5, gap_extend=-1, local=False):
    pairs = S.pack_pairs(a_toks, b_toks)
    fn = S.sw_score_affine if local else S.nw_score_affine
    return np.asarray(fn(pairs, 2, -1, gap_open, gap_extend))


def _check_oracle(a_toks, b_toks, got, go, ge, local):
    ref = S.sw_ref if local else S.nw_ref
    for i, (x, y) in enumerate(zip(a_toks, b_toks)):
        want = ref(list(x), list(y), match=2, mismatch=-1, go=go, ge=ge)
        assert got[i] == want, f"pair {i}: got {got[i]} want {want}"


def _dense_batch(rng, B, L):
    a = rng.integers(65, 69, (B, L), dtype=np.uint8).astype(np.int32)
    b = rng.integers(65, 69, (B, L), dtype=np.uint8).astype(np.int32)
    a_len = rng.integers(1, L + 1, B).astype(np.int32)
    b_len = rng.integers(1, L + 1, B).astype(np.int32)
    pairs = S.PairBatch(jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_len), jnp.asarray(b_len))
    a_toks = [bytes(a[i, : a_len[i]].astype(np.uint8)) for i in range(B)]
    b_toks = [bytes(b[i, : b_len[i]].astype(np.uint8)) for i in range(B)]
    return pairs, a_toks, b_toks


@pytest.mark.parametrize("local", [False, True])
def test_affine_matches_oracle(rng, local):
    a_toks = _rand_tokens(rng, 33, 1, 40)
    b_toks = _rand_tokens(rng, 33, 1, 40)
    got = _scores(a_toks, b_toks, local=local)
    _check_oracle(a_toks, b_toks, got, -5, -1, local)


def test_affine_matches_xla_scan(rng):
    """A dense fixed-width batch (junk past each length) scores exactly."""
    pairs, a_toks, b_toks = _dense_batch(rng, 64, 32)
    got = np.asarray(S.nw_score_affine(pairs))
    _check_oracle(a_toks, b_toks, got, -5, -1, False)


def test_affine_empty_and_edge():
    got = _scores([b"", b"abc", b""], [b"xy", b"", b""])
    # all-gap alignments: open + (n-1) * extend
    assert got[0] == -5 + -1 * 1
    assert got[1] == -5 + -1 * 2
    assert got[2] == 0


@pytest.mark.parametrize("local", [False, True])
def test_linear_matches_oracle(rng, local):
    a_toks = _rand_tokens(rng, 33, 1, 40)
    b_toks = _rand_tokens(rng, 33, 1, 40)
    pairs = S.pack_pairs(a_toks, b_toks)
    fn = S.sw_score_linear if local else S.nw_score_linear
    got = np.asarray(fn(pairs))
    _check_oracle(a_toks, b_toks, got, -2, -2, local)


def test_linear_matches_xla_scan(rng):
    """Linear gaps are the affine engine with open == extend."""
    pairs, a_toks, b_toks = _dense_batch(rng, 64, 24)
    got = np.asarray(S.nw_score_linear(pairs))
    np.testing.assert_array_equal(got, np.asarray(S.nw_score_affine(pairs, 2, -1, -2, -2)))
    _check_oracle(a_toks, b_toks, got, -2, -2, False)


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("local", [False, True])
def test_uniform_full_slab_extraction(rng, local, linear):
    """Uniform-length batches (every pair fills the padded width): scores
    stay oracle-exact."""
    a_toks = [bytes(rng.integers(65, 69, 17, dtype=np.uint8)) for _ in range(19)]
    b_toks = [bytes(rng.integers(65, 69, 23, dtype=np.uint8)) for _ in range(19)]
    go, ge = (-2, -2) if linear else (-5, -1)
    got = _scores(a_toks, b_toks, gap_open=go, gap_extend=ge, local=local)
    _check_oracle(a_toks, b_toks, got, go, ge, local)
