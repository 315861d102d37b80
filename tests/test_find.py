"""K1/K2 conformance: all-matches substring + byteset counts vs brute force."""

import numpy as np
import pytest

from stringwars_tpu.ops.find import (
    byteset_count,
    find_count,
    find_positions,
    pack_byteset,
    pack_needle,
)


def brute_positions(hay: bytes, needle: bytes) -> list[int]:
    return [p for p in range(len(hay) - len(needle) + 1) if hay[p : p + len(needle)] == needle]


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 7, 8, 13, 16, 31, 40])
def test_find_random(rng, m):
    hay = rng.integers(0, 4, 10_000, dtype=np.uint8) + 97  # a-d alphabet: many matches
    hay_b = hay.tobytes()
    needle = hay_b[137 : 137 + m]
    packed = pack_needle(needle)
    want = brute_positions(hay_b, needle)
    assert int(find_count(hay, packed)) == len(want)
    np.testing.assert_array_equal(find_positions(hay, packed), want)


def test_find_overlapping():
    hay = b"aaaaaa"
    packed = pack_needle(b"aaa")
    assert int(find_count(np.frombuffer(hay, np.uint8), packed)) == 4


def test_find_at_boundaries():
    hay = b"xabc" + b"m" * 100 + b"abcx" + b"abc"
    packed = pack_needle(b"abc")
    got = find_positions(np.frombuffer(hay, np.uint8), packed)
    np.testing.assert_array_equal(got, brute_positions(hay, b"abc"))


def test_find_no_match():
    hay = np.frombuffer(b"hello world", np.uint8)
    assert int(find_count(hay, pack_needle(b"zzz"))) == 0


def test_find_needle_cycling_no_recompile():
    """Different needles of one capacity bucket reuse the same jit cache."""
    hay = np.frombuffer(b"the quick brown fox jumps over the lazy dog" * 50, np.uint8)
    for needle in [b"the", b"fox", b"lazy dog", b"q"]:
        packed = pack_needle(needle, capacity_words=4)
        assert int(find_count(hay, packed)) == len(brute_positions(hay.tobytes(), needle))


def test_find_long_needle():
    hay_b = b"prefix " + b"N" * 100 + b" suffix"
    needle = b"N" * 100
    packed = pack_needle(needle)
    assert packed.capacity >= 26
    assert int(find_count(np.frombuffer(hay_b, np.uint8), packed)) == 1


def test_empty_needle_rejected():
    with pytest.raises(ValueError):
        pack_needle(b"")


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 13, 16, 33, 61])
def test_find_pallas_packed(rng, m):
    """Fused shifted-byte compare vs brute force, needles at all 4 byte
    offsets, in the smallest and a wider capacity bucket."""
    hay = rng.integers(0, 3, 300_000, dtype=np.uint8) + 97  # a-c: dense matches
    hay_b = hay.tobytes()
    for start in (0, 1, 2, 3, 1337):
        needle = hay_b[start : start + m]
        want = len(brute_positions(hay_b, needle))
        for cap in {4 if m <= 13 else 16, 16}:
            assert int(find_count(hay, pack_needle(needle, cap))) == want, (m, start, cap)


def test_rfind_count_last_position(rng):
    hay = rng.integers(0, 3, 20_000, dtype=np.uint8) + 97
    hay_b = hay.tobytes()
    for needle in [hay_b[55:58], hay_b[100:108], b"zzz"]:
        packed = pack_needle(needle, 4)
        count, last = F_rfind(hay, packed)
        want = brute_positions(hay_b, needle)
        assert int(count) == len(want)
        assert int(last) == (want[-1] if want else -1)


def F_rfind(hay, packed):
    from stringwars_tpu.ops.find import rfind_count

    return rfind_count(hay, packed)


def test_rfind_pallas_last_position(rng):
    """rfind over a longer haystack: the last match sits near the end."""
    from stringwars_tpu.ops.find import rfind_count

    hay = rng.integers(0, 3, 120_000, dtype=np.uint8) + 97
    hay_b = hay.tobytes()
    for needle in [hay_b[999:1004], hay_b[-7:], b"qqq"]:
        count, last = rfind_count(hay, pack_needle(needle, 4))
        want = brute_positions(hay_b, needle)
        assert int(count) == len(want)
        assert int(last) == (want[-1] if want else -1)


def test_byteset_count_bounded_excludes_padding():
    from stringwars_tpu.ops.find import byteset_count_bounded
    import jax.numpy as jnp

    hay = np.frombuffer(b"12ab\x00\x00\x00\x00", np.uint8)
    table = pack_byteset(b"0123456789\x00")
    # Global corpus ends at byte 4: the NUL padding (in the set!) must not count.
    got = byteset_count_bounded(hay, table, 8, jnp.int32(0), jnp.int32(4))
    assert int(got) == 2


def test_find_pallas_cycle_batch(rng):
    """Cycling needles through one staged haystack (the suite's row)."""
    hay = rng.integers(0, 3, 100_000, dtype=np.uint8) + 97
    hay_b = hay.tobytes()
    needles = [hay_b[s : s + m] for s, m in [(0, 3), (11, 5), (202, 8), (303, 13), (47, 1)]]
    counts = [int(find_count(hay, pack_needle(nd, 4))) for nd in needles]
    want = [len(brute_positions(hay_b, nd)) for nd in needles]
    np.testing.assert_array_equal(counts, want)


def test_find_pallas_batch_rejects_mixed_capacity():
    """A needle that does not fit the requested capacity is refused."""
    with pytest.raises(ValueError, match="exceeds capacity"):
        pack_needle(b"x" * 14, 4)


def test_find_pallas_rejects_oversize_needle():
    """Needles past the largest bucket get a capacity of their own."""
    needle = b"N" * 300
    packed = pack_needle(needle)
    assert packed.capacity >= (300 + 6) // 4
    hay = np.frombuffer(b"a" + needle + b"b" + needle, np.uint8)
    assert int(find_count(hay, packed)) == 2


@pytest.mark.parametrize(
    "charset", [b"\n\r\x0b\x0c", b"</>&'\"=[]", b"0123456789", bytes(range(200, 256))]
)
def test_byteset_count(rng, charset):
    hay = rng.integers(0, 256, 50_000, dtype=np.uint8)
    table = pack_byteset(charset)
    want = int(np.isin(hay, np.frombuffer(charset, np.uint8)).sum())
    assert int(byteset_count(hay, table, hay.shape[0])) == want


def test_byteset_partial_length(rng):
    hay = np.frombuffer(b"123abc456", np.uint8)
    table = pack_byteset(b"0123456789")
    assert int(byteset_count(hay, table, 4)) == 3  # "123a" has 3 digits


def test_sharded_rfind_matches_single_chip(rng):
    """The <Nchip> backward program must return the true (count, last-offset)
    pair, matching rfind_count on the whole corpus."""
    import jax
    from stringwars_tpu.ops.find import rfind_count
    from stringwars_tpu.parallel.mesh import make_mesh
    from stringwars_tpu.suites.find import make_sharded_find

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual multi-device mesh")
    scope = make_mesh(4)
    hay = rng.integers(97, 100, 40_000, dtype=np.uint8)
    needle = bytes(hay[777:781])  # guaranteed present
    packed = pack_needle(needle, 4)
    step, rows = make_sharded_find(scope, hay, hay.shape[0], 4, backward=True)
    count, last = step(
        rows, np.asarray(packed.words), np.asarray(packed.masks), np.asarray(packed.length)
    )
    ref_count, ref_last = rfind_count(hay, packed, hay.shape[0])
    assert int(count) == int(ref_count)
    assert int(last) == int(ref_last)


def test_sharded_pallas_find_matches_brute(rng):
    """<Nchip> halo-sharded forward and backward programs == brute force
    (virtual mesh)."""
    import jax

    from stringwars_tpu.parallel.mesh import make_mesh
    from stringwars_tpu.suites.find import make_sharded_find

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual multi-device mesh")
    scope = make_mesh(4)
    hay = rng.integers(97, 100, 9_000, dtype=np.uint8)
    needle = bytes(hay[4_000:4_004])  # present, likely straddles seams too
    packed = pack_needle(needle, 4)
    args = (np.asarray(packed.words), np.asarray(packed.masks), np.asarray(packed.length))
    expected = brute_positions(hay.tobytes(), needle)

    step, rows = make_sharded_find(scope, hay, hay.shape[0], 4, backward=False)
    assert int(step(rows, *args)) == len(expected)
    step_b, rows = make_sharded_find(scope, hay, hay.shape[0], 4, backward=True)
    count, last = step_b(rows, *args)
    assert int(count) == len(expected)
    assert int(last) == expected[-1]


def test_cp_window_count_matches_oracle(rng):
    """The folded-codepoint window count (uncased find) vs a numpy sliding
    compare, with matches at the head, the tail, and one truncated at n."""
    import jax.numpy as jnp

    from stringwars_tpu.ops.casefold import _window_count

    n, m = 70_000, 8
    cps = rng.integers(0x3B1, 0x3C9, n).astype(np.int32)  # Greek lowercase
    needle = rng.integers(0x3B1, 0x3C9, m).astype(np.int32)
    for pos in (0, 4093, 8184, 1234, n - m + 2, n - m):
        cps[pos : pos + m] = needle[: n - pos]
    windows = np.lib.stride_tricks.sliding_window_view(cps, m)
    want = int((windows == needle).all(axis=1).sum())
    got = int(_window_count(jnp.asarray(cps), jnp.asarray(needle), jnp.int32(n), m))
    assert got == want and want >= 5
    # Only the first n codepoints count: a match ending past n is dropped.
    assert int(_window_count(jnp.asarray(cps), jnp.asarray(needle), jnp.int32(n - 1), m)) == want - 1
