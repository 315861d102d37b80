"""K10 conformance: full case folding vs str.casefold, uncased search."""

import numpy as np
import pytest

from stringwars_tpu.ops.casefold import fold_bytes, fold_text, uncased_count, uncased_equal

SAMPLES = [
    "Hello World",
    "STRASSE straße ẞ",
    "İstanbul ı I i",  # Turkish dotted/dotless (folds per default UCD)
    "ΣΊΣΥΦΟΣ σίσυφος",
    "ПРИВЕТ привет",
    "ﬁre ﬂow ﬃ",  # ligatures fold to multi-char
    "한국어 普通话",
    "emoji 🎉 stays",
]


@pytest.mark.parametrize("text", SAMPLES)
def test_fold_matches_python(text):
    assert fold_text(text) == text.casefold()


def test_fold_random_fuzz(rng):
    for _ in range(50):
        cps = rng.integers(1, 0x2FFF, 30)
        text = "".join(chr(c) for c in cps if not (0xD800 <= c <= 0xDFFF))
        assert fold_text(text) == text.casefold()


def test_uncased_equal():
    assert uncased_equal("Straße".encode(), "STRASSE".encode())
    assert uncased_equal(b"Hello", b"hELLO")
    assert not uncased_equal(b"Hello", b"World")
    assert uncased_equal("ΣΊΣΥΦΟΣ".encode(), "σίσυφοσ".encode())


def test_uncased_count():
    hay = "Die Straße heißt STRASSE, die strasse!".encode()
    folded = fold_bytes(np.frombuffer(hay, np.uint8))
    # folded text: "die straße heißt strasse, die strasse!".casefold()
    # "strasse" appears where ß→ss folds make it so: Straße->strasse,
    # STRASSE->strasse, strasse->strasse.
    assert uncased_count(folded, b"STRASSE") == 3
    assert uncased_count(folded, "straße".encode()) == 3
    assert uncased_count(folded, b"die") == 2
    assert uncased_count(folded, b"zzz") == 0


def test_uncased_equal_batch():
    from stringwars_tpu.ops.casefold import uncased_equal_batch
    from stringwars_tpu.tape import PaddedTokens, Tape

    pairs = [
        ("Straße".encode(), b"STRASSE", True),
        (b"Hello", b"hELLO", True),
        (b"Hello", b"World", False),
        ("ΣΊΣΥΦΟΣ".encode(), "σίσυφοσ".encode(), True),
        (b"abc", b"abcd", False),
        (b"", b"", True),
        ("ﬁn".encode(), b"fin", True),
    ]
    a = PaddedTokens.from_tape(Tape.from_tokens([p[0] for p in pairs]), align=4)
    b = PaddedTokens.from_tape(Tape.from_tokens([p[1] for p in pairs]), align=4)
    import numpy as np

    got = np.asarray(uncased_equal_batch(a, b))
    np.testing.assert_array_equal(got, [p[2] for p in pairs])


def test_fold_tokens_ascii_matches_general():
    import jax.numpy as jnp
    from stringwars_tpu.ops.casefold import fold_tokens, fold_tokens_ascii, fold_tokens_auto
    from stringwars_tpu.tape import PaddedTokens, Tape

    toks = [b"Hello WORLD", b"MiXeD case", b"already lower", b"", b"ALLCAPS!"]
    pt = PaddedTokens.from_tape(Tape.from_tokens(toks))
    fa, ca = fold_tokens_ascii(pt)
    fg, cg = fold_tokens(pt)
    fa, ca, fg, cg = map(np.asarray, (fa, ca, fg, cg))
    for i, t in enumerate(toks):
        want = t.decode().casefold().encode()
        assert ca[i] == len(want)
        assert bytes(fa[i, : ca[i]]) == want
        # general kernel agrees codepoint-wise
        assert list(fg[i, : cg[i]]) == list(want)
    out, counts, is_ascii = fold_tokens_auto(pt)
    assert is_ascii and np.array_equal(np.asarray(out), fa)

    pt2 = PaddedTokens.from_tape(Tape.from_tokens(["Straße".encode()]))
    out2, counts2, is_ascii2 = fold_tokens_auto(pt2)
    assert not is_ascii2 and int(np.asarray(counts2)[0]) == len("Straße".casefold())


def test_fold_tokens_max_cp_packed_sort():
    """BMP-pruned fold (single-operand packed-sort compaction) == the
    unpruned pair-sort path == str.casefold, on mixed-script rows with
    1->N expansions (a ruleset-pruning + packing regression pin)."""
    import jax.numpy as jnp

    from stringwars_tpu.ops.casefold import fold_tokens
    from stringwars_tpu.tape import PaddedTokens

    rows = [
        "Straße GROSS Weiß",           # German: ss expansions
        "ΕΛΛΗΝΙΚΆ ἈΘΉΝΑ ΊΣ",          # Greek incl. breathing marks
        "РУССКИЙ Текст ЁЖ",            # Cyrillic
        "Mixed ASCII And İstanbul",    # dotted capital I (expansion)
    ]
    raw = [r.encode() for r in rows]
    W = max(len(b) for b in raw)
    data = np.zeros((len(raw), W), np.uint8)
    lengths = np.zeros(len(raw), np.int32)
    for i, b in enumerate(raw):
        data[i, : len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    pt = PaddedTokens(data=jnp.asarray(data), lengths=jnp.asarray(lengths), width=W)
    max_cp = max(ord(c) for r in rows for c in r)
    got, counts = fold_tokens(pt, max_cp=max_cp)
    want, wcounts = fold_tokens(pt)
    assert np.array_equal(np.asarray(counts), np.asarray(wcounts))
    assert np.array_equal(np.asarray(got), np.asarray(want))
    for i, r in enumerate(rows):
        folded = "".join(chr(c) for c in np.asarray(got)[i, : int(counts[i])])
        assert folded == r.casefold(), f"row {i}: {folded!r} != {r.casefold()!r}"


@pytest.mark.parametrize(
    "max_cp,spans",
    [
        # German range: max_exp == 2 (ß -> ss), two-channel kernel
        (0xFF, [(0x41, 0x7A), (0xC0, 0xFF)]),
        # Greek/Cyrillic range: includes U+0390 (-> 3 cps), three-channel
        (0x4FF, [(0x41, 0x7A), (0x386, 0x3CE), (0x410, 0x44F)]),
    ],
)
def test_fold_tokens_fused_matches_staged(max_cp, spans):
    """Pruned fold on width-32 batches (the suite's staging) == the
    unpruned fold == str.casefold, at expansion widths 2 and 3."""
    import jax.numpy as jnp

    from stringwars_tpu.ops.casefold import fold_tokens
    from stringwars_tpu.tape import PaddedTokens

    rng = np.random.default_rng(9)
    texts = []
    for _ in range(700):
        n_ch = int(rng.integers(1, 16))
        chars = []
        for _ in range(n_ch):
            lo, hi = spans[int(rng.integers(0, len(spans)))]
            chars.append(chr(int(rng.integers(lo, hi + 1))))
        texts.append("".join(chars))
    texts.append("STRASSE GROSS \xdf\xdf")  # ß expansions
    if max_cp >= 0x390:
        texts.append("ΐΰ ΐΆ")  # 1->3 expansions
    texts.append("")
    rows = []
    for t in texts:
        b = t.encode()[:32]
        while True:  # never split a multi-byte char at the width cap
            try:
                b.decode()
                break
            except UnicodeDecodeError:
                b = b[:-1]
        rows.append(b)
    W = 32
    data = np.zeros((len(rows), W), np.uint8)
    lengths = np.zeros(len(rows), np.int32)
    for i, b in enumerate(rows):
        data[i, : len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    pt = PaddedTokens(data=jnp.asarray(data), lengths=jnp.asarray(lengths), width=W)
    got, gc = fold_tokens(pt, max_cp=max_cp)
    want, wc = fold_tokens(pt)
    assert np.array_equal(np.asarray(gc), np.asarray(wc))
    g, w = np.asarray(got), np.asarray(want)
    for i in range(len(rows)):
        assert g[i, : gc[i]].tolist() == w[i, : wc[i]].tolist(), (i, rows[i])
        folded = "".join(map(chr, g[i, : int(gc[i])]))
        assert folded == rows[i].decode().casefold(), (i, rows[i])
