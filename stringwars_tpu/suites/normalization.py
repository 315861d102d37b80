"""Normalization suite: case-fold, NFC/NFD/NFKC/NFKD, case-insensitive
compare and find (reference ``normalization/bench.rs``, defaults 3 s + 20 s,
lines tokens on multilingual corpora).

Device rows run under the chained-loop protocol with workload-preserving
perturbations (row rolls — byte XOR would corrupt UTF-8). The normalize
rows use the production quick-check architecture: a per-row class-table
check covers the (overwhelming) already-normalized majority, and staging
routes the non-inert rows through the
exact stream kernels — total measured work is the full corpus, exactly
like the reference's quick-check-dominated libraries
(``normalization/bench.rs:113-141``).
"""

from __future__ import annotations

import itertools
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.ops import casefold as CF
from stringwars_tpu.ops import normalize as NORM
from stringwars_tpu.suites._common import setup_suite
from stringwars_tpu.tape import PaddedTokens, Tape
from stringwars_tpu.utils.harness import (
    DeviceRoutine,
    WorkUnits,
    fold_salt,
)


def stream_rows(data_np: np.ndarray, width: int = 1024) -> PaddedTokens:
    """Chunk a UTF-8 byte stream into [rows, width] PaddedTokens whose row
    boundaries never split a multibyte character (staging-time, host)."""
    n = int(data_np.shape[0])
    # lead_at[i]: the last non-continuation byte position <= i.
    is_lead = (data_np & 0xC0) != 0x80
    lead_at = np.maximum.accumulate(np.where(is_lead, np.arange(n), 0)).tolist()
    starts = [0]
    while starts[-1] + width < n:
        e = lead_at[starts[-1] + width]
        if e <= starts[-1]:  # pathological: a >width continuation run
            e = starts[-1] + width
        starts.append(e)
    starts_np = np.asarray(starts, np.int64)
    lengths = np.diff(np.append(starts_np, n)).astype(np.int32)
    pos = starts_np[:, None] + np.arange(width)[None, :]
    inside = np.arange(width)[None, :] < lengths[:, None]
    buf = np.where(inside, data_np[np.minimum(pos, max(n - 1, 0))], 0).astype(np.uint8)
    return PaddedTokens(data=jnp.asarray(buf), lengths=jnp.asarray(lengths), width=width)


def _roll(s, arr):
    shift = (s % jnp.uint32(max(arr.shape[0], 1))).astype(jnp.int32)
    return jnp.roll(arr, shift, axis=0)


def main() -> None:
    ctx = setup_suite(
        "Unicode normalization + caseless search throughput",
        default_tokens="file",
        default_warmup=3.0,
        default_time=20.0,
        default_synthetic="multilingual",
    )
    n = ctx.tape.total_bytes
    data_np = np.asarray(ctx.tape.data)[:n]
    host_text = data_np.tobytes().decode("utf-8", "ignore")

    toks = stream_rows(data_np)
    rows_np = np.asarray(toks.data)
    lengths_np = np.asarray(toks.lengths)

    ctx.group("case-fold")
    is_ascii = bool(data_np.size == 0 or int(data_np.max(initial=0)) < 0x80)
    # Corpus codepoint ceiling (staging-time): prunes the fold rule maps
    # and enables the BMP packed-sort compaction.
    corpus_max_cp = max(map(ord, host_text), default=0x7F)

    # Narrow staging for the fold: the per-row compaction sort scales
    # ~width log^2 width, so short rows sort less per byte.
    fold_toks = stream_rows(data_np, width=32)

    def fold_body(s, e, d, ln):
        rolled = PaddedTokens(data=_roll(s, d), lengths=_roll(s, ln), width=fold_toks.width)
        out, counts = CF.fold_tokens(rolled, max_cp=corpus_max_cp)
        return fold_salt(s, counts, out[:, :8]), e

    ctx.run(
        "case-fold/swtpu::utf8_fold<1chip>",
        "bytes",
        DeviceRoutine(
            body=fold_body,
            consts=(fold_toks.data, fold_toks.lengths),
            units=WorkUnits(1, n),
        ),
    )
    # ASCII fast path (the reference kernels specialize ASCII runs the same
    # way; on English corpora this is the production fold).
    if is_ascii:
        def ascii_body(s, e, d, ln):
            rolled = PaddedTokens(data=_roll(s, d), lengths=_roll(s, ln), width=toks.width)
            out, counts = CF.fold_tokens_ascii(rolled)
            return fold_salt(s, counts, out[:, :8].astype(jnp.int32)), e

        ctx.run(
            "case-fold/swtpu::ascii_fold<1chip>",
            "bytes",
            DeviceRoutine(
                body=ascii_body, consts=(toks.data, toks.lengths), units=WorkUnits(1, n)
            ),
        )
    ctx.run(
        "case-fold/str.casefold",
        "bytes",
        lambda: (host_text.casefold(), WorkUnits(1, n))[1],
    )

    for form in ("nfc", "nfd", "nfkc", "nfkd"):
        ctx.group(f"normalize-{form}")
        compat = form in ("nfkc", "nfkd")
        routine = _normalize_routine(
            toks, rows_np, lengths_np, form, compat, n, max_cp=corpus_max_cp
        )
        ctx.run(f"normalize-{form}/swtpu::utf8_norm<1chip>", "bytes", routine)
        ctx.run(
            f"normalize-{form}/unicodedata.normalize",
            "bytes",
            lambda f=form.upper(): (unicodedata.normalize(f, host_text), WorkUnits(1, n))[1],
        )

    ctx.group("case-insensitive-compare")
    # Adjacent line pairs, capped 1000 (reference normalization/bench.rs:249-254).
    lines = [ln.encode() for ln in host_text.split("\n") if ln][:1001]
    pairs = list(zip(lines, lines[1:]))[:1000]
    pair_bytes = sum(len(a) + len(b) for a, b in pairs)

    a_toks = PaddedTokens.from_tape(Tape.from_tokens([p[0] for p in pairs] or [b"x"]), align=4)
    b_toks = PaddedTokens.from_tape(Tape.from_tokens([p[1] for p in pairs] or [b"x"]), align=4)

    def cmp_body(s, e, ad, al, bd, bl):
        a2 = PaddedTokens(data=_roll(s, ad), lengths=_roll(s, al), width=a_toks.width)
        b2 = PaddedTokens(data=_roll(s, bd), lengths=_roll(s, bl), width=b_toks.width)
        return fold_salt(s, CF.uncased_equal_batch(a2, b2)), e

    ctx.run(
        "case-insensitive-compare/swtpu::uncased_eq<1chip>",
        "comparisons",
        DeviceRoutine(
            body=cmp_body,
            consts=(a_toks.data, a_toks.lengths, b_toks.data, b_toks.lengths),
            units=WorkUnits(len(pairs), pair_bytes),
        ),
    )

    def host_cmp() -> WorkUnits:
        for a, b in pairs:
            a.decode("utf-8", "ignore").casefold() == b.decode("utf-8", "ignore").casefold()
        return WorkUnits(len(pairs), pair_bytes)

    ctx.run("case-insensitive-compare/casefold-eq", "comparisons", host_cmp)

    ctx.group("case-insensitive-find")
    # 100 seeded random needles >= 3 bytes (reference normalization/bench.rs:334-351).
    rng = np.random.default_rng(42)
    words = [w for w in host_text.split() if len(w.encode()) >= 3]
    needles = [words[i].encode() for i in rng.integers(0, max(len(words), 1), 100)] if words else []
    folded_hay, fold_count = CF.fold_bytes(data_np if data_np.size else np.zeros(4, np.uint8))
    folded_hay = jax.block_until_ready(folded_hay)
    needle = (needles or [b"xyz"])[0]
    fn, fm = CF.fold_bytes(np.frombuffer(needle, np.uint8))
    fm = max(int(fm), 1)
    needle_cp = jnp.asarray(np.asarray(fn)[:fm])

    nfold = int(fold_count)

    def find_body(s, e, hay, nd):
        # Perturb the needle codepoints (window-compare cost is
        # data-independent; matches just change).
        pert = (s & jnp.uint32(0xFFFF)).astype(jnp.int32)
        return fold_salt(s, CF._window_count(hay, nd ^ pert, jnp.int32(nfold), fm)), e

    consts = (folded_hay, needle_cp)

    ctx.run(
        "case-insensitive-find/swtpu::uncased_find<1chip>",
        "bytes",
        DeviceRoutine(body=find_body, consts=consts, units=WorkUnits(1, n)),
    )

    lower_text = host_text.casefold()
    host_cycle = itertools.cycle([nd.decode("utf-8", "ignore").casefold() for nd in (needles or [b"xyz"])])

    def host_find() -> WorkUnits:
        needle = next(host_cycle)
        count = lower_text.count(needle)
        return WorkUnits(max(count, 1), n)

    ctx.run("case-insensitive-find/casefold-count", "bytes", host_find)
    ctx.finish()


def _normalize_routine(
    toks, rows_np, lengths_np, form: str, compat: bool, n: int, max_cp: int | None = None
):
    """Quick-check + slow-subset normalize as one chained DeviceRoutine.

    Staging (host, free) routes rows: inert rows are covered by the
    device rule-map check (they ARE their own normalization, all forms);
    non-inert rows concatenate into a stream the exact kernels normalize
    every iteration. Work per iteration = the whole corpus. ``max_cp``
    (corpus ceiling, staging-known) prunes the quick-check rule maps —
    unpruned they cost ~50 ms per 32 MB pass on-chip.
    """
    # NFC/NFKC key the quick check on the UAX#15 QC class (precomposed
    # text is verbatim NFC); NFD/NFKD need actual decompositions, so
    # their fast class is the narrower inert set.
    if form in ("nfc", "nfkc"):
        fast = NORM.rows_nfc_verbatim_host(rows_np, lengths_np, compat)
    else:
        fast = NORM.rows_inert_host(rows_np, lengths_np, compat)
    slow_rows = np.flatnonzero(~fast)
    slow_bytes = bytearray()
    for r in slow_rows:
        slow_bytes += rows_np[r, : lengths_np[r]].tobytes()
    slow_cps = np.array(
        [ord(c) for c in bytes(slow_bytes).decode("utf-8", "ignore")], np.int32
    )
    has_slow = slow_cps.shape[0] > 0

    if form in ("nfd", "nfkd"):
        # Benchmark-scale decomposition: starter-cut codepoint rows through
        # the row-wise rule-map kernel (the flat kernel's expansion scatter
        # + whole-stream reorder measured seconds per call at 32 MB).
        slow_max = int(slow_cps.max()) if has_slow else 0x7F
        try:
            # 64-cp rows: the per-row compaction sort scales ~width log^2
            # width (see the fold staging note); starter cuts within 64
            # cps exist in any non-adversarial stream.
            srows, slens = NORM.stream_starter_rows(slow_cps, width=64) if has_slow else (
                np.zeros((1, 64), np.int32), np.zeros(1, np.int32)
            )
        except ValueError:  # zalgo-style run: exact flat fallback staging
            srows = slens = None
        if srows is not None:
            rows_dev = jnp.asarray(srows)
            lens_dev = jnp.asarray(slens)

            def body(s, e, d, ln, sr, sl):
                quick = NORM.rows_inert(_roll(s, d), _roll(s, ln), compat, max_cp)
                out, counts = NORM.decompose_rows(
                    _roll(s, sr), _roll(s, sl), compat, max_cp=slow_max
                )
                return fold_salt(s, quick, counts, out[:, :8]), e

            return DeviceRoutine(
                body=body,
                consts=(toks.data, toks.lengths, rows_dev, lens_dev),
                units=WorkUnits(1, n),
            )

    bucket = 16
    while bucket < slow_cps.shape[0]:
        bucket *= 2
    padded = np.zeros(bucket, np.int32)
    padded[: slow_cps.shape[0]] = slow_cps
    slow_dev = jnp.asarray(padded)

    def body(s, e, d, ln, slow):
        if form in ("nfc", "nfkc"):
            quick = NORM.rows_nfc_verbatim(_roll(s, d), _roll(s, ln), compat, max_cp)
        else:
            quick = NORM.rows_inert(_roll(s, d), _roll(s, ln), compat, max_cp)
        outs = [quick]
        if has_slow:
            rolled = _roll(s, slow)
            if form in ("nfd", "nfkd"):
                out, count = NORM.decompose(rolled, bucket, compat)
                outs += [count, out[:64]]
            else:
                out, kept, count = NORM._nfc_padded(rolled, bucket, compat)
                outs += [kept, count, out[:64]]
        return fold_salt(s, *outs), e

    return DeviceRoutine(
        body=body,
        consts=(toks.data, toks.lengths, slow_dev),
        units=WorkUnits(1, n),
    )


if __name__ == "__main__":
    main()
