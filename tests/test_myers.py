"""Bit-parallel Myers Levenshtein (Pallas, Triton route) vs the
brute-force DP oracle, run in interpret mode; the ``gpu``-marked test
compiles it for the card and checks it against the XLA wavefront.
"""

import numpy as np
import pytest

from stringwars_tpu.ops.myers_pallas import (
    BLOCK,
    myers_distances,
    myers_from_codepoints,
    myers_from_tokens,
)
from stringwars_tpu.ops.similarity import levenshtein_ref


def levenshtein_seq(a, b):
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[len(b)]


def check_pairs(a_tokens, b_tokens):
    batch = myers_from_tokens(a_tokens, b_tokens)
    got = myers_distances(batch, interpret=True)
    want = [levenshtein_ref(a, b) for a, b in zip(a_tokens, b_tokens)]
    np.testing.assert_array_equal(got, want)


def test_myers_mixed_batch(rng):
    """One batch covering: known cases, empty sides, 32-row word
    boundaries (m in {31,32,33,63,64,65,100}), random mixed lengths,
    and several pair blocks."""
    a_tokens = [b"kitten", b"flaw", b"abc", b"", b"same", b"a"]
    b_tokens = [b"sitting", b"lawn", b"abc", b"xyz", b"same", b""]
    pool = np.frombuffer(b"abcd", np.uint8)
    for m in [1, 31, 32, 33, 63, 64, 65, 100]:
        for _ in range(4):
            a_tokens.append(rng.choice(pool, m).tobytes())
            b_tokens.append(rng.choice(pool, int(rng.integers(1, 49))).tobytes())
    for _ in range(32):
        a_tokens.append(bytes(rng.integers(97, 105, int(rng.integers(0, 101)), dtype=np.uint8)))
        b_tokens.append(bytes(rng.integers(97, 105, int(rng.integers(0, 49)), dtype=np.uint8)))
    check_pairs(a_tokens, b_tokens)


def test_myers_more_than_one_tile(rng):
    """Many pair blocks plus a partial last block."""
    n = 10 * BLOCK + 3
    a_tokens = [bytes(rng.integers(97, 101, 9, dtype=np.uint8)) for _ in range(n)]
    b_tokens = [bytes(rng.integers(97, 101, 11, dtype=np.uint8)) for _ in range(n)]
    check_pairs(a_tokens, b_tokens)


def test_myers_utf8_codepoints():
    a = [
        np.array([ord(c) for c in "héllo"], np.int32),
        np.array([0x10400, 0x61], np.int32),
        np.array([0x1F600, 0x1F601, 0x1F602], np.int32),
    ]
    b = [
        np.array([ord(c) for c in "hallo"], np.int32),
        np.array([0x10400, 0x62], np.int32),
        np.array([0x1F600, 0x1F602], np.int32),
    ]
    batch = myers_from_codepoints(a, b)
    got = myers_distances(batch, interpret=True)
    want = [levenshtein_seq(x.tolist(), y.tolist()) for x, y in zip(a, b)]
    np.testing.assert_array_equal(got, want)


def test_myers_sharded_tiles_match_single_device(rng):
    """The <Nchip> path: pair blocks split across devices under
    shard_map must reproduce the single-device distances (virtual mesh,
    interpret mode)."""
    import jax

    from stringwars_tpu.parallel.mesh import make_mesh
    from stringwars_tpu.suites.similarities import myers_scorer

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual multi-device mesh")
    n_pairs = 3 * BLOCK + 5  # odd block count: the mesh pads it
    a_toks = [bytes(rng.integers(97, 101, rng.integers(1, 6), dtype=np.uint8)) for _ in range(n_pairs)]
    b_toks = [bytes(rng.integers(97, 101, rng.integers(1, 6), dtype=np.uint8)) for _ in range(n_pairs)]
    mb = myers_from_tokens(a_toks, b_toks)
    single = np.asarray(myers_scorer(make_mesh(1), mb, interpret=True)()).reshape(-1)
    sharded = np.asarray(myers_scorer(make_mesh(2), mb, interpret=True)()).reshape(-1)
    np.testing.assert_array_equal(sharded[: single.shape[0]], single)
    want = [levenshtein_ref(a, b) for a, b in zip(a_toks, b_toks)]
    np.testing.assert_array_equal(single[:n_pairs], want)


def test_myers_uniform_multiword_peel(rng):
    """Uniform pattern lengths spanning >1 word trigger the static
    last-word specialization (score read from one word only)."""
    n, m = 64, 40  # W=2, last_word=1
    a_tokens = [bytes(rng.integers(97, 105, m, dtype=np.uint8)) for _ in range(n)]
    b_tokens = [bytes(rng.integers(97, 105, int(rng.integers(1, 60)), dtype=np.uint8)) for _ in range(n)]
    batch = myers_from_tokens(a_tokens, b_tokens)
    assert batch.last_word == 1
    check_pairs(a_tokens, b_tokens)


def test_myers_requires_gpu_or_interpret():
    """Off the GPU the kernel refuses to compile instead of falling back."""
    import jax

    if jax.default_backend() == "gpu":
        pytest.skip("runs where JAX has no GPU")
    batch = myers_from_tokens([b"abc"], [b"abd"])
    with pytest.raises(RuntimeError, match="only for a GPU"):
        myers_distances(batch)


@pytest.mark.gpu
def test_myers_gpu_matches_wavefront(gpu, rng):
    """Compiled for the card: DNA reads at the similarities suite's widths
    (100 B and 256 B, 1-8 pattern words) equal the XLA wavefront."""
    from stringwars_tpu.ops import similarity as S

    for m in (100, 256):
        pool = np.frombuffer(b"ACGT", np.uint8)
        a_toks = [rng.choice(pool, m - int(rng.integers(0, 9))).tobytes() for _ in range(1000)]
        b_toks = [rng.choice(pool, m - int(rng.integers(0, 9))).tobytes() for _ in range(1000)]
        got = myers_distances(myers_from_tokens(a_toks, b_toks))
        want = np.asarray(S.levenshtein(S.pack_pairs(a_toks, b_toks)))
        np.testing.assert_array_equal(got, want)
