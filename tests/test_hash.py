"""K3 conformance: bit-exact xxHash digests vs the reference C library."""

import numpy as np
import pytest
xxhash = pytest.importorskip("xxhash")

from stringwars_tpu.ops import wideint as w
from stringwars_tpu.ops.hash import tree_hash64, xxh32, xxh64, xxh64_multiseed, TREE_CHUNK
from stringwars_tpu.tape import PaddedTokens, Tape


def _tokens(token_list):
    return PaddedTokens.from_tape(Tape.from_tokens(token_list), align=4)


LENGTH_SWEEP = list(range(0, 40)) + [63, 64, 65, 100, 255, 256, 1000, 4096]


@pytest.fixture(scope="module")
def sweep_tokens(request):
    rng = np.random.default_rng(7)
    return [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in LENGTH_SWEEP]


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF])
def test_xxh32_exact(sweep_tokens, seed):
    got = np.asarray(xxh32(_tokens(sweep_tokens), seed))
    want = np.array([xxhash.xxh32_intdigest(t, seed) for t in sweep_tokens], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 0x0123456789ABCDEF])
def test_xxh64_exact(sweep_tokens, seed):
    digest = xxh64(_tokens(sweep_tokens), seed)
    got = digest.to_numpy()
    want = np.array([xxhash.xxh64_intdigest(t, seed) for t in sweep_tokens], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_xxh64_empty_and_known():
    digest = xxh64(_tokens([b"", b"a", b"abc", b"hello world"]))
    got = digest.to_numpy()
    want = np.array(
        [xxhash.xxh64_intdigest(t) for t in [b"", b"a", b"abc", b"hello world"]],
        dtype=np.uint64,
    )
    np.testing.assert_array_equal(got, want)


def test_xxh64_multiseed_matches_per_seed(sweep_tokens):
    """The reference's startup conformance assertion (containers/bench.rs:344-357):
    amortized multiseed digests must equal per-seed hashing."""
    seeds = np.array([0, 1, 42, 0xFEEDFACE, 2**63 + 17, 2**64 - 1], dtype=np.uint64)
    toks = _tokens(sweep_tokens)
    multi = xxh64_multiseed(toks, seeds).to_numpy()  # [k, B]
    for i, s in enumerate(seeds):
        per_seed = np.array(
            [xxhash.xxh64_intdigest(t, int(s)) for t in sweep_tokens], dtype=np.uint64
        )
        np.testing.assert_array_equal(multi[i], per_seed)


def test_wideint_mul_identities(rng):
    a = rng.integers(0, 2**64, 64, dtype=np.uint64)
    b = rng.integers(0, 2**64, 64, dtype=np.uint64)

    def to_u64(x):
        import jax.numpy as jnp

        return w.U64(
            hi=jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
            lo=jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        )

    ua, ub = to_u64(a), to_u64(b)
    np.testing.assert_array_equal(w.mul(ua, ub).to_numpy(), a * b)
    np.testing.assert_array_equal(w.add(ua, ub).to_numpy(), a + b)
    np.testing.assert_array_equal(w.sub(ua, ub).to_numpy(), a - b)
    hi, lo = w.mul_wide(ua, ub)
    full = a.astype(object) * b.astype(object)
    np.testing.assert_array_equal(
        hi.to_numpy().astype(object) * (1 << 64) + lo.to_numpy().astype(object), full
    )
    for r in [1, 7, 31, 32, 33, 63]:
        rolled = ((a.astype(object) << r) | (a.astype(object) >> (64 - r))) & ((1 << 64) - 1)
        np.testing.assert_array_equal(w.rotl(ua, r).to_numpy().astype(object), rolled)


def test_tree_hash_small_equals_xxh64():
    data = np.frombuffer(b"some corpus below one chunk" * 100, dtype=np.uint8)
    assert tree_hash64(data) == xxhash.xxh64_intdigest(data.tobytes())


def test_tree_hash_spec_replay():
    """Replay the documented tree construction in pure numpy/C-xxhash."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, TREE_CHUNK * 3 + 12345, dtype=np.uint8).tobytes()

    def replay(buf: bytes) -> int:
        while True:
            chunks = [buf[i : i + TREE_CHUNK] for i in range(0, max(len(buf), 1), TREE_CHUNK)]
            digests = [xxhash.xxh64_intdigest(c) for c in chunks]
            if len(digests) == 1:
                return digests[0]
            buf = b"".join(int(d).to_bytes(8, "little") for d in digests)

    assert tree_hash64(np.frombuffer(data, np.uint8)) == replay(data)


def test_xxh64_pallas_matches(rng):
    """xxh64 around the 32-byte stripe edges == C library, two seeds."""
    tokens = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in (0, 3, 31, 32, 33, 64, 95, 100)]
    for seed in (0, 12345):
        got = xxh64(_tokens(tokens), seed=seed).to_numpy()
        want = np.array(
            [xxhash.xxh64_intdigest(t, seed) for t in tokens], dtype=np.uint64
        )
        np.testing.assert_array_equal(got, want)


def test_swh64_matches_spec(sweep_tokens):
    from stringwars_tpu.ops.hash import swh64, swh64_ref

    for seed in (0, 1, 0xDEADBEEFCAFEBABE):
        got = swh64(_tokens(sweep_tokens), seed).to_numpy()
        want = np.array([swh64_ref(t, seed) for t in sweep_tokens], dtype=np.uint64)
        np.testing.assert_array_equal(got, want)


def test_swh64_multiseed_matches_per_seed(sweep_tokens):
    from stringwars_tpu.ops.hash import swh64, swh64_multiseed

    seeds = np.array([0, 7, 2**63 + 5], dtype=np.uint64)
    toks = _tokens(sweep_tokens)
    multi = swh64_multiseed(toks, seeds).to_numpy()
    for i, s in enumerate(seeds):
        np.testing.assert_array_equal(multi[i], swh64(toks, int(s)).to_numpy())


def test_swh64_collision_quality(rng):
    from stringwars_tpu.ops.hash import swh64

    tokens = list({bytes(rng.integers(97, 123, rng.integers(3, 12), dtype=np.uint8)) for _ in range(5000)})
    digests = swh64(_tokens(tokens), 0).to_numpy()
    assert np.unique(digests).size == len(tokens)  # no collisions on 5k tokens


def test_bytesum_pallas_matches_host():
    """u32-word bytesum (the hash suite's checksum row) == python sum, odd
    sizes + padding."""
    from stringwars_tpu.ops.bytesum import bytesum_words

    rng = np.random.default_rng(3)
    for n in (1, 17, 8191, 8192, 100_000):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        padded = np.zeros(-(-n // 4) * 4, np.uint8)
        padded[:n] = data
        got = bytesum_words(padded.view("<u4"), n)
        assert got == int(data.sum()), n
