"""K10 normalization conformance vs unicodedata.normalize (UCD 15.0)."""

import unicodedata

import numpy as np
import pytest

import jax.numpy as jnp

from stringwars_tpu.ops.normalize import normalize_text

SAMPLES = [
    "plain ascii stays",
    "café résumé naïve",  # precomposed in
    "café résumé",  # decomposed in
    "á̧",  # multiple marks (acute + cedilla, reorder)
    "á̧",  # same marks, other order
    "ḍ̇",  # d-dot-above + dot-below (classic reorder case)
    "한국어",  # precomposed Hangul
    "한",  # decomposed Hangul jamo
    "ﬁﬂ ﬀ",  # compat ligatures (NFK* only)
    "①②③ ½",  # compat digits
    "Ω Å",  # singleton decompositions (U+2126, U+212B)
    "q̣̇",  # q + dot-above + dot-below
    "ཷ",  # NFKD expansion of length 2 with reorder
    "ﷺ",  # longest NFKD expansion (18)
    "ṩ",  # s + dot-below + dot-above -> composes
]


@pytest.mark.parametrize("form", ["NFD", "NFKD", "NFC", "NFKC"])
@pytest.mark.parametrize("text", SAMPLES)
def test_normalize_known(form, text):
    assert normalize_text(text, form) == unicodedata.normalize(form, text)


def test_decompose_large_stream_no_key_overflow():
    """Benchmark-scale NFKD: the reorder sort key must not wrap int32.

    Regression for the packed ``run * 256 + ccc`` key, which went negative
    past 2^23 output slots (NFKD hits that at ~466k inputs) and scrambled
    the output to a zero prefix.
    """
    import jax.numpy as jnp

    from stringwars_tpu.ops.normalize import decompose

    n = 600_000
    cps = np.full(n, ord("a"), np.int32)
    out, count = decompose(jnp.asarray(cps), n, compat=True)
    assert int(count) == n
    got = np.asarray(out)[:n]
    np.testing.assert_array_equal(got, cps)


@pytest.mark.parametrize("form", ["NFD", "NFKD", "NFC", "NFKC"])
def test_normalize_fuzz(rng, form):
    interesting = (
        list(range(0x20, 0x80))
        + list(range(0xC0, 0x180))
        + list(range(0x300, 0x370))
        + list(range(0x1E00, 0x1F00))
        + list(range(0xAC00, 0xAC20))
        + list(range(0x1100, 0x1120))
        + list(range(0x1161, 0x1176))
        + list(range(0xFB00, 0xFB10))
        + [0x2126, 0x212B, 0x0F77]
    )
    pool = np.array(interesting)
    for _ in range(60):
        n = int(rng.integers(1, 24))
        text = "".join(chr(c) for c in pool[rng.integers(0, pool.size, n)])
        assert normalize_text(text, form) == unicodedata.normalize(form, text), repr(text)


def test_rows_inert_matches_is_normalized():
    """Row quick-check: inert rows are verbatim-normalized in all forms."""
    import jax.numpy as jnp

    from stringwars_tpu.ops.normalize import rows_inert, rows_inert_host
    from stringwars_tpu.tape import PaddedTokens

    rows = [
        b"plain ascii text",
        "schon längst übliche Wörter".encode(),
        "Привет мир".encode(),
        "étude".encode(),  # combining acute: NOT inert
        "Å test".encode(),  # Angstrom sign: not inert (decomposes)
        "가힣".encode(),  # Hangul syllables: composition targets
    ]
    W = max(len(r) for r in rows)
    buf = np.zeros((len(rows), W), np.uint8)
    lengths = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        buf[i, : len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    for compat in (False, True):
        got = np.asarray(rows_inert(jnp.asarray(buf), jnp.asarray(lengths), compat))
        host = rows_inert_host(buf, lengths, compat)
        np.testing.assert_array_equal(got, host)
        forms = ("NFKC", "NFKD") if compat else ("NFC", "NFD")
        for i, r in enumerate(rows):
            text = r.decode()
            if got[i]:  # inert implies already normalized verbatim
                for form in forms:
                    assert unicodedata.normalize(form, text) == text, (compat, form, text)
        # Conservative direction: the combining/decomposable rows must not
        # be declared inert.
        assert not got[3] and not got[4]


def test_rows_nfc_verbatim_matches_is_normalized():
    """UAX#15 quick check: fast rows are verbatim NFC/NFKC (oracle:
    unicodedata.is_normalized), and precomposed DE/RU text IS fast —
    the property the inert check misses."""
    import jax.numpy as jnp

    from stringwars_tpu.ops.normalize import rows_nfc_verbatim, rows_nfc_verbatim_host
    from stringwars_tpu.ops.casefold import _decode_rows  # noqa: F401 (import check)

    rows = [
        b"plain ascii text",
        "schon längst übliche Wörter".encode(),  # precomposed umlauts: FAST
        "Привет мир йо".encode(),  # Cyrillic incl. й: FAST
        "étude".encode(),  # combining acute: slow (Maybe)
        "Å test".encode(),  # Angstrom sign: slow (QC=No)
        "가힣".encode(),  # Hangul syllables: FAST for NFC
        "ﬁle".encode(),  # fi ligature: fast for NFC, slow for NFKC
    ]
    W = max(len(r) for r in rows)
    buf = np.zeros((len(rows), W), np.uint8)
    lengths = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        buf[i, : len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    for compat in (False, True):
        form = "NFKC" if compat else "NFC"
        got = np.asarray(rows_nfc_verbatim(jnp.asarray(buf), jnp.asarray(lengths), compat))
        host = rows_nfc_verbatim_host(buf, lengths, compat)
        np.testing.assert_array_equal(got, host)
        for i, r in enumerate(rows):
            text = r.decode()
            if got[i]:  # fast implies already normalized verbatim
                assert unicodedata.is_normalized(form, text), (form, text)
    # The rows the round-2 inert check misrouted must be fast for NFC.
    nfc = np.asarray(rows_nfc_verbatim(jnp.asarray(buf), jnp.asarray(lengths), False))
    assert nfc[1] and nfc[2] and nfc[5] and nfc[6]
    assert not nfc[3] and not nfc[4]
    nfkc = np.asarray(rows_nfc_verbatim(jnp.asarray(buf), jnp.asarray(lengths), True))
    assert not nfkc[6]  # ligature rewrites under NFKC


def test_nfc_fast_table_oracle_sample():
    """Dense-table spot check against unicodedata on a stratified sample."""
    from stringwars_tpu.unicode import tables

    rng = np.random.default_rng(7)
    sample = np.concatenate([
        np.arange(0x500),
        rng.integers(0x500, 0x30000, 400),
        np.array([0xAC00, 0xD7A3, 0x1161, 0x11A8, 0x2126, 0xFB01, 0x0344]),
    ])
    for compat in (False, True):
        form = "NFKC" if compat else "NFC"
        fast = tables.nfc_fast_table(compat)
        for cp in sample:
            cp = int(cp)
            if 0xD800 <= cp <= 0xDFFF:
                continue
            if fast[cp]:
                c = chr(cp)
                assert unicodedata.normalize(form, c) == c, hex(cp)
                assert unicodedata.combining(c) == 0, hex(cp)


@pytest.mark.parametrize("compat", [False, True])
def test_decompose_rows_matches_unicodedata(compat):
    """Row-wise benchmark-scale decomposition (rule maps + packed-sort
    compaction + row-local reorder on starter-cut rows) == unicodedata
    NFD/NFKD on multilingual text with reordering marks."""
    import unicodedata

    from stringwars_tpu.ops.normalize import decompose_rows, stream_starter_rows

    rng = np.random.default_rng(7)
    pool = (
        ["é", "Å", "ñ", "ё", "й", "ü", "ø", "a", "Z", " ", "α", "ΐ", "ṩ"]
        + ["q̣̇", "ẍ̧", "가", "각", "한"]  # multiple marks (reorder) + Hangul
        + (["①", "ﬁ", "㌀", "²"] if compat else [])
    )
    text = "".join(pool[int(i)] for i in rng.integers(0, len(pool), 3000))
    cps = np.array([ord(c) for c in text], np.int32)
    rows, lengths = stream_starter_rows(cps, width=256)
    out, counts = decompose_rows(
        jnp.asarray(rows), jnp.asarray(lengths), compat, max_cp=int(cps.max())
    )
    got = "".join(
        "".join(map(chr, np.asarray(out)[i, : int(counts[i])]))
        for i in range(rows.shape[0])
    )
    want = unicodedata.normalize("NFKD" if compat else "NFD", text)
    assert got == want


def test_decompose_rows_matches_flat_kernel():
    from stringwars_tpu.ops.normalize import decompose, decompose_rows, stream_starter_rows

    text = ("mañana Å ΐ q̣̇ й ё ṩ x" * 50)
    cps = np.array([ord(c) for c in text], np.int32)
    rows, lengths = stream_starter_rows(cps, width=128)
    out, counts = decompose_rows(jnp.asarray(rows), jnp.asarray(lengths), False, max_cp=int(cps.max()))
    got = np.concatenate([
        np.asarray(out)[i, : int(counts[i])] for i in range(rows.shape[0])
    ])
    flat, fcount = decompose(jnp.asarray(cps), int(cps.shape[0]), False)
    want = np.asarray(flat)[: int(fcount)]
    assert np.array_equal(got, want)


def test_stream_starter_rows_zalgo_raises():
    from stringwars_tpu.ops.normalize import stream_starter_rows

    cps = np.array([ord("a")] + [0x0301] * 300, np.int32)
    with pytest.raises(ValueError, match="combining run"):
        stream_starter_rows(cps, width=128)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("width", [32, 64])
def test_decompose_rows_fused_engine(compat, width):
    """Width-32/64 starter-cut rows (the suite's staging) decompose
    exactly like unicodedata. Hangul NFD and ⅷ->"viii" NFKD exercise the
    4th expansion channel."""
    import unicodedata

    from stringwars_tpu.ops.normalize import decompose_rows, stream_starter_rows

    rng = np.random.default_rng(11)
    # Hangul syllables on the NFD side, compat forms on the NFKD side.
    pool = ["é", "Å", "ñ", "ё", "й", "ü", "ø", "a", "Z", " ", "α", "ΐ", "ṩ", "q̣̇", "ẍ̧", "Ω"]
    pool += ["①", "²", "ǆ", "ⅷ", "½", "℀"] if compat else ["가", "각", "한", "ᾂ"]
    text = "".join(pool[int(i)] for i in rng.integers(0, len(pool), 2500))
    cps = np.array([ord(c) for c in text], np.int32)
    max_cp = int(cps.max())
    rows, lengths = stream_starter_rows(cps, width=width)
    out, counts = decompose_rows(
        jnp.asarray(rows), jnp.asarray(lengths), compat, max_cp=max_cp
    )
    got = "".join(
        "".join(map(chr, np.asarray(out)[i, : int(counts[i])]))
        for i in range(rows.shape[0])
    )
    assert got == unicodedata.normalize("NFKD" if compat else "NFD", text)
