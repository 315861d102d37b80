#!/usr/bin/env python3
"""Smoke test of the whole system on one NVIDIA GPU.

    python chip_smoke.py            # one card: device, suites, references, gpu tests
    python chip_smoke.py --chips 4  # four cards: the <4chip> paths vs one card

Phases (one child process at a time, so only one process holds the card;
the children share the persistent compile cache):

1. device — the card's name and power limit from nvidia-smi, then what JAX
   sees. No GPU is a failure; the smoke never falls back to the CPU.
2. suites — every suite CLI, device rows only (``-k swtpu::``), each
   variant run once (``SWTPU_TIME=0 SWTPU_WARMUP=0``) on its default
   128 MB seeded corpus. Every expected ``<1chip>`` row must print a rate.
3. reference — each family's device output against a plain reference on
   corpus-sized inputs (samples where the host reference is slow); every
   comparison is exact.
4. gpu tests — ``pytest -m gpu`` on the card.

The last line of standard output is one JSON object; the exit code is 0
only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUDGET_S = 1150  # whole run, compilation included

SUITES = (
    "find", "hash", "memory", "sequence", "similarities", "fingerprints",
    "tokenization", "normalization", "containers", "encryption", "scaling",
)

# Corpus cuts, only where a suite cannot run at its 128 MB default within
# the smoke's time limit; each cut is printed.
DATASET_LIMITS: dict[str, str] = {}

EXPECTED_ROWS = {
    "find": [
        "substring-forward/swtpu::find_count", "substring-backward/swtpu::rfind_count",
        "byteset-forward/swtpu::byteset_count", "byteset-forward/swtpu::aho_corasick",
    ],
    "hash": [
        "stateless/swtpu::swh64", "stateless/swtpu::xxh64", "stateless/swtpu::xxh32",
        "stateless/swtpu::xxh3_64", "stateless/swtpu::swh64_multiseed8",
        "stateful/swtpu::tree_hash64", "checksum/swtpu::bytesum", "checksum/swtpu::sha256",
    ],
    "memory": [
        "lookup-table/swtpu::lut_translate", "generate-random/swtpu::fill_random",
        "memset/swtpu::fill", "memcpy/swtpu::copy", "memmove/swtpu::move",
    ],
    "sequence": ["argsort/swtpu::argsort", "argsort-uncased/swtpu::argsort_uncased"],
    "similarities": [
        "uniform/swtpu::levenshtein", "uniform-utf8/swtpu::levenshtein",
        "linear/swtpu::needleman_wunsch", "linear/swtpu::smith_waterman",
        "affine/swtpu::needleman_wunsch", "affine/swtpu::smith_waterman",
    ],
    "fingerprints": [f"minhash/ndim_{d}/swtpu::fingerprint" for d in (64, 128, 256, 512)],
    "tokenization": [
        "tokenize-whitespace/swtpu::split", "tokenize-newlines/swtpu::split",
        "tokenize-words-tr29/swtpu::words", "tokenize-graphemes-tr29/swtpu::graphemes",
        "tokenize-sentences-tr29/swtpu::sentences", "tokenize-lines-uax14/swtpu::linebreaks",
        "utf8-length/swtpu::count_utf8", "utf8-iterate/swtpu::decode_utf32",
        "find-nth-utf8/swtpu::find_nth", "tokenize-bpe/swtpu::bpe_encode",
    ],
    "normalization": [
        "case-fold/swtpu::utf8_fold", "normalize-nfc/swtpu::utf8_norm",
        "normalize-nfd/swtpu::utf8_norm", "normalize-nfkc/swtpu::utf8_norm",
        "normalize-nfkd/swtpu::utf8_norm", "case-insensitive-compare/swtpu::uncased_eq",
        "case-insensitive-find/swtpu::uncased_find",
    ],
    "containers": [
        *[f"multihash/{b}bit/swtpu::xxh64_multiseed" for b in (128, 256, 512, 1024)],
        "filters/swtpu::bloom-build", "filters/swtpu::bloom-query", "filters/swtpu::fuse8-query",
    ],
    "encryption": [
        "encryption/swtpu::chacha20poly1305", "encryption/swtpu::xchacha20poly1305",
        "encryption/swtpu::chacha20poly1305-corpus", "encryption/swtpu::xchacha20poly1305-corpus",
        "decryption/swtpu::chacha20poly1305-corpus", "decryption/swtpu::xchacha20poly1305-corpus",
    ],
    "scaling": ["pipeline/swtpu::sharded_step"],
}

# The suites' <Nchip> rows, which the four-card run exercises.
MULTICHIP_ROWS = {
    "find": EXPECTED_ROWS["find"][:3],
    "similarities": [r for r in EXPECTED_ROWS["similarities"] if "utf8" not in r],
    "sequence": ["argsort/swtpu::argsort"],
    "memory": ["lookup-table/swtpu::lut_translate", "memcpy/swtpu::copy"],
    "fingerprints": EXPECTED_ROWS["fingerprints"],
    "scaling": EXPECTED_ROWS["scaling"],
}
MULTICHIP_LIMIT = "4mb"


class PhaseError(Exception):
    pass


# ---------------------------------------------------------------------------
# Parent: runs children one after another, never imports JAX.
# ---------------------------------------------------------------------------

def _run(cmd: list[str], *, timeout: float, env: dict | None = None) -> tuple[int, str, str, float]:
    """Run one child in its own process group; kill the group on timeout."""
    start = time.monotonic()
    proc = subprocess.Popen(
        cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, **(env or {})}, start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=max(timeout, 1.0))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        err += f"\n[chip_smoke] killed after {timeout:.0f} s"
        return 124, out, err, time.monotonic() - start
    return proc.returncode, out, err, time.monotonic() - start


def _child(*args: str) -> list[str]:
    return [sys.executable, os.path.abspath(__file__), "--child", *args]


def _tail(text: str, lines: int = 30) -> str:
    return "\n".join(text.strip().splitlines()[-lines:])


def phase_device(deadline: float, chips: int) -> dict:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (FileNotFoundError, subprocess.TimeoutExpired) as error:
        raise PhaseError(f"nvidia-smi unavailable: {error}") from None
    if smi.returncode != 0 or not smi.stdout.strip():
        raise PhaseError(f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        print(f"card: {line.strip()}", flush=True)
    rc, out, err, _ = _run(_child("device"), timeout=deadline - time.monotonic())
    if rc != 0:
        raise PhaseError(f"JAX device probe failed (rc {rc}):\n{_tail(err)}")
    info = json.loads(out.strip().splitlines()[-1])
    print(
        f"jax {info['jax']}: platform {info['platform']}, device_kind {info['kind']!r}, "
        f"{info['count']} device(s); XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
        flush=True,
    )
    if info["platform"] != "gpu":
        raise PhaseError(f"no GPU: JAX runs on {info['platform']!r}")
    if info["count"] < chips:
        raise PhaseError(f"need {chips} GPUs, JAX sees {info['count']}")
    return info


_ROW = re.compile(r"^(\S+)\s+(.*)$")


def _rows(stdout: str) -> tuple[set[str], dict[str, str]]:
    """(names with a rate line, {name: skip reason})."""
    rated, skipped = set(), {}
    for line in stdout.splitlines():
        m = _ROW.match(line)
        if not m or "::" not in m.group(1):
            continue
        rest = m.group(2)
        if rest.startswith("SKIPPED"):
            skipped[m.group(1)] = rest
        elif re.match(r"[\d.]+ ", rest):
            rated.add(m.group(1))
    return rated, skipped


def run_suite(name: str, scope: str, rows: list[str], deadline: float, args: list[str], env: dict) -> None:
    rc, out, err, wall = _run(
        _child("suite", name, "-k", f"swtpu::.*{re.escape(scope)}", *args),
        timeout=deadline - time.monotonic(), env=env,
    )
    compile_s = re.findall(r"^# compile_seconds ([\d.]+) over (\d+) compile", err, re.M)
    comp = f"{float(compile_s[-1][0]):.1f} s over {compile_s[-1][1]} compiles" if compile_s else "not measured"
    print(f"suite {name}{scope}: wall {wall:.1f} s, compile {comp}, exit {rc}", flush=True)
    sys.stdout.write(out)
    rated, skipped = _rows(out)
    want = [f"{row}{scope}" for row in rows]
    missing = [row for row in want if row not in rated]
    problems = []
    if rc != 0:
        problems.append(f"exit code {rc}")
    if skipped:
        problems += [f"{k} {v}" for k, v in skipped.items()]
    if missing:
        problems.append(f"no rate line for {missing}")
    if problems:
        raise PhaseError(f"suite {name}: " + "; ".join(problems) + f"\n{_tail(err)}")


def phase_suites(deadline: float) -> None:
    env = {"SWTPU_TIME": "0", "SWTPU_WARMUP": "0"}
    for name in SUITES:
        args = []
        if name in DATASET_LIMITS:
            args = ["--dataset-limit", DATASET_LIMITS[name]]
            print(f"suite {name}: corpus cut to {DATASET_LIMITS[name]}", flush=True)
        run_suite(name, "<1chip>", EXPECTED_ROWS[name], deadline, args, env)


def phase_reference(deadline: float, which: str = "reference") -> None:
    rc, out, err, wall = _run(_child(which), timeout=deadline - time.monotonic())
    sys.stdout.write(out)
    print(f"{which}: wall {wall:.1f} s, exit {rc}", flush=True)
    if rc != 0 or "MISMATCH" in out:
        raise PhaseError(f"{which} failed (rc {rc}):\n{_tail(err)}")


def phase_gpu_tests(deadline: float) -> None:
    rc, out, err, wall = _run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p", "no:cacheprovider", "tests/"],
        timeout=deadline - time.monotonic(), env={"JAX_PLATFORMS": "cuda"},
    )
    print(f"gpu tests: wall {wall:.1f} s, exit {rc}: {_tail(out, 1)}", flush=True)
    if rc != 0 or " passed" not in out:
        raise PhaseError(f"pytest -m gpu failed (rc {rc}):\n{_tail(out)}\n{_tail(err)}")


def phase_multichip(deadline: float) -> None:
    env = {"SWTPU_TIME": "0", "SWTPU_WARMUP": "0"}
    for name, rows in MULTICHIP_ROWS.items():
        print(f"suite {name}: corpus cut to {MULTICHIP_LIMIT}", flush=True)
        run_suite(name, "<4chip>", rows, deadline, ["--dataset-limit", MULTICHIP_LIMIT], env)
    phase_reference(deadline, "multichip")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1)
    parser.add_argument("--child", nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        return child_main(args.child)

    deadline = time.monotonic() + BUDGET_S
    try:
        if not os.path.isdir(os.path.join(ROOT, "stringwars_tpu")):
            raise PhaseError(f"no stringwars_tpu package beside {os.path.basename(__file__)}")
        info = phase_device(deadline, args.chips)
        if args.chips == 4:
            phase_multichip(deadline)
        else:
            phase_suites(deadline)
            phase_reference(deadline)
            phase_gpu_tests(deadline)
    except PhaseError as error:
        print(f"chip_smoke FAILED: {error}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": info["platform"], "kind": info["kind"], "count": args.chips},
    }), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Children: each runs in its own process and may use JAX.
# ---------------------------------------------------------------------------

def child_main(argv: list[str]) -> int:
    what, rest = argv[0], argv[1:]
    if what == "device":
        import jax

        d = jax.devices()[0]
        print(json.dumps({
            "platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "jax": jax.__version__,
        }))
        return 0
    if what == "suite":
        return _child_suite(rest[0], rest[1:])
    if what == "reference":
        return _child_reference()
    if what == "multichip":
        return _child_multichip()
    raise SystemExit(f"unknown child {what!r}")


def _child_suite(name: str, argv: list[str]) -> int:
    """Run one suite CLI in-process, summing XLA backend compile time."""
    import runpy

    import jax.monitoring

    total = [0.0, 0]

    def on_event(event: str, duration: float, **_kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            total[0] += duration
            total[1] += 1

    jax.monitoring.register_event_duration_secs_listener(on_event)
    sys.argv = [f"stringwars_tpu.suites.{name}", *argv]
    code = 0
    try:
        runpy.run_module(f"stringwars_tpu.suites.{name}", run_name="__main__", alter_sys=True)
    except SystemExit as stop:
        code = stop.code if isinstance(stop.code, int) else (0 if stop.code is None else 1)
    print(f"# compile_seconds {total[0]:.2f} over {total[1]} compiles", file=sys.stderr, flush=True)
    return code


def _utf32(cps) -> str:
    import numpy as np

    return np.asarray(cps).astype("<u4").tobytes().decode("utf-32-le")


_LAST_CHECK = [time.monotonic()]


def _check(label: str, ok: bool, detail: str) -> None:
    now = time.monotonic()
    print(
        f"{'ok' if ok else 'MISMATCH'} {label}: {detail} ({now - _LAST_CHECK[0]:.1f} s)",
        flush=True,
    )
    _LAST_CHECK[0] = now


def _child_reference() -> int:
    """Device outputs vs plain references (exact)."""
    import hashlib
    import unicodedata

    import jax
    import jax.numpy as jnp
    import numpy as np

    from stringwars_tpu import datasets
    from stringwars_tpu.tape import PaddedTokens, Tape

    size = 128 << 20
    words_corpus = np.frombuffer(datasets.synthesize("english-words", size), np.uint8)
    tape = Tape.from_buffer(words_corpus.tobytes(), "words")
    tokens = tape.to_list()
    n = words_corpus.shape[0]
    print(f"reference corpus: english-words {n:,} bytes, {len(tokens):,} words", flush=True)

    # find / rfind: count + last offset vs a numpy candidate-filter compare.
    from stringwars_tpu.ops import find as F

    for needle in (tokens[1000], tokens[5] + b" " + tokens[6], b"zzzzzzzzq"):
        m = len(needle)
        nd = np.frombuffer(needle, np.uint8)
        cand = np.flatnonzero(words_corpus[: n - m + 1] == nd[0])
        for j in range(1, m):
            cand = cand[words_corpus[cand + j] == nd[j]]
        packed = F.pack_needle(needle)
        count = int(F.find_count(words_corpus, packed, n))
        rcount, last = (int(v) for v in F.rfind_count(words_corpus, packed, n))
        want_last = int(cand[-1]) if cand.size else -1
        _check(f"find/rfind {needle[:16]!r}", count == rcount == cand.size and last == want_last,
               f"count {count}/{rcount} vs numpy {cand.size}, last {last} vs {want_last}")

    # Hashes over a 1M-word sample.
    from stringwars_tpu.ops import hash as H
    from stringwars_tpu.ops import xxh3 as X3
    from stringwars_tpu.tape import bucket_by_length

    sample = Tape.from_tokens(tokens[:1_000_000])
    buckets = bucket_by_length(sample, [16, 64, 256, 1024, 4096])
    xx64, xx3, sw, order = [], [], [], []
    for b in buckets:
        layout = H.prepare(b)
        xx64.append(H.xxh64(layout).to_numpy()[: b.count])
        xx3.append(X3.xxh3_64(X3.prepare3(b)).to_numpy()[: b.count])
        sw.append(H.swh64(layout, 0).to_numpy()[: b.count])
        data, lens = np.asarray(b.data), np.asarray(b.lengths)
        order += [data[i, : lens[i]].tobytes() for i in range(b.count)]
    xx64, xx3, sw = (np.concatenate(v) for v in (xx64, xx3, sw))
    try:
        import xxhash

        want64 = np.array([xxhash.xxh64_intdigest(t) for t in order], np.uint64)
        want3 = np.array([xxhash.xxh3_64_intdigest(t) for t in order], np.uint64)
        ref = "xxhash"
    except ImportError:
        cpu = jax.devices("cpu")[0]
        want64, want3 = [], []
        for b in buckets:
            host = PaddedTokens(data=np.asarray(b.data), lengths=np.asarray(b.lengths), width=b.width)
            with jax.default_device(cpu):
                want64.append(H.xxh64(H.prepare(host)).to_numpy()[: b.count])
                want3.append(X3.xxh3_64(X3.prepare3(host)).to_numpy()[: b.count])
        want64, want3 = np.concatenate(want64), np.concatenate(want3)
        ref = "the same jitted functions on JAX's CPU backend"
    _check("xxh64", np.array_equal(xx64, want64), f"{len(order):,} words vs {ref}")
    _check("xxh3_64", np.array_equal(xx3, want3), f"{len(order):,} words vs {ref}")
    want_sw = np.array([H.swh64_ref(t) for t in order[:20_000]], np.uint64)
    _check("swh64", np.array_equal(sw[:20_000], want_sw), "20,000 words vs swh64_ref")

    from stringwars_tpu.ops.sha256 import prepare_sha256, sha256_digest_bytes

    sha_ok, n_sha = True, 0
    for b in bucket_by_length(Tape.from_tokens(tokens[:200_000]), [16, 64, 256]):
        got = sha256_digest_bytes(prepare_sha256(b))
        data, lens = np.asarray(b.data), np.asarray(b.lengths)
        for i in range(b.count):
            sha_ok &= got[i].tobytes() == hashlib.sha256(data[i, : lens[i]].tobytes()).digest()
        n_sha += b.count
    _check("sha256", sha_ok, f"{n_sha:,} words vs hashlib")

    from stringwars_tpu.ops.bytesum import bytesum_words

    padded = np.zeros(-(-n // 4) * 4, np.uint8)
    padded[:n] = words_corpus
    got = bytesum_words(padded.view("<u4"), n)
    _check("bytesum", got == int(words_corpus.sum(dtype=np.uint64)), f"{n:,} bytes vs numpy")

    # Aho-Corasick byteset scan vs the native host count.
    from stringwars_tpu.ops.ahocorasick import Automaton, ac_count

    for charset in (b"\n\r\x0b\x0c", b"</>&'\"=[]", b"0123456789", b"aeiou"):
        auto = Automaton([bytes([c]) for c in charset])
        got, want = ac_count(auto, words_corpus), auto.count_host(words_corpus)
        _check(f"aho_corasick {charset!r}", got == want, f"{got} vs native {want}")

    # Argsort: 2M words vs Python's sorted.
    from stringwars_tpu.ops.sort import argsort_tape

    sub = tape.subtape(0, min(2_000_000, tape.count))
    sub_list = sub.to_list()
    got = argsort_tape(sub)
    want = sorted(range(len(sub_list)), key=sub_list.__getitem__)
    _check("argsort", np.array_equal(got, want), f"{len(sub_list):,} words vs sorted()")

    # Filters: zero false negatives over 1M unique words.
    from stringwars_tpu.ops import filters as FLT

    uniq = list(dict.fromkeys(tokens))[:1_000_000]
    layout = H.prepare(PaddedTokens.from_tape(Tape.from_tokens(uniq), align=4))
    bloom = FLT.bloom_build(layout, tuple(range(1, 8)), 1 << 24)
    keys = H.xxh64(layout).to_numpy()
    fuse = FLT.fuse_build(keys)
    fn_bloom = int((~np.asarray(FLT.bloom_query(bloom, layout))).sum())
    fn_fuse = int((~np.asarray(FLT.fuse_query(fuse, keys))).sum())
    _check("filters", fn_bloom == 0 and fn_fuse == 0,
           f"{len(uniq):,} keys, false negatives bloom {fn_bloom}, fuse8 {fn_fuse}")
    del tokens, tape, sub_list

    # Edit distances: sampled pairs at 100 B and 1 KB reads.
    from stringwars_tpu.ops import similarity as S
    from stringwars_tpu.ops.myers_pallas import myers_distances, myers_from_tokens

    for corpus, width, n_check in (("dna-100b", 100, 32), ("dna", 1023, 2)):
        lines = datasets.synthesize(corpus, (width + 1) * 8192 + (1 << 16)).split(b"\n")
        lines = [ln[:width] for ln in lines if ln][: 2 * 4096]
        qa, qb = lines[: len(lines) // 2], lines[len(lines) // 2 :]
        lev = myers_distances(myers_from_tokens(qa, qb))
        idx = np.linspace(0, len(qa) - 1, n_check).astype(int)
        ok = all(lev[i] == S.levenshtein_ref(qa[i], qb[i]) for i in idx)
        _check(f"levenshtein {width} B", ok, f"{n_check} of {len(qa)} pairs vs levenshtein_ref")
        batch = S.pack_pairs(qa[:512], qb[:512])
        for label, fn, go, ge, local in (
            ("nw linear", S.nw_score_linear, -2, -2, False),
            ("sw linear", S.sw_score_linear, -2, -2, True),
            ("nw affine", S.nw_score_affine, -5, -1, False),
            ("sw affine", S.sw_score_affine, -5, -1, True),
        ):
            got = np.asarray(fn(batch))
            ok = all(
                got[i] == S._gotoh_ref(qa[i], qb[i], 2, -1, go, ge, local)
                for i in idx[idx < 512][: max(1, n_check // 2)]
            )
            _check(f"{label} {width} B", ok, f"{max(1, n_check // 2)} of 512 pairs vs _gotoh_ref")

    # MinHash on ~1 KB lines.
    from stringwars_tpu.ops.fingerprint import fingerprint, fingerprint_ref

    lines = Tape.from_buffer(datasets.synthesize("long-lines", 1 << 20), "lines")
    lines = lines.subtape(0, min(256, lines.count))
    toks = PaddedTokens.from_tape(lines, max_width=4096)
    mh, mc = fingerprint(toks, ndim=256)
    mh, mc = np.asarray(mh), np.asarray(mc)
    ok = True
    for i, t in enumerate(lines.to_list()[:16]):
        rh, rc = fingerprint_ref(t, ndim=256)
        ok &= np.array_equal(mh[i], rh) and np.array_equal(mc[i], rc)
    _check("minhash", ok, "16 of 256 lines (ndim 256) vs fingerprint_ref")

    # Fold and the four normal forms on the multilingual corpus.
    from stringwars_tpu.ops import casefold as CF
    from stringwars_tpu.ops.normalize import normalize
    from stringwars_tpu.suites.normalization import stream_rows

    ml = datasets.synthesize("multilingual", size)
    ml_np = np.frombuffer(ml, np.uint8)
    text = ml.decode("utf-8")
    folded, count = CF.fold_bytes(ml_np)
    got = _utf32(np.asarray(folded)[: int(count)])
    _check("casefold stream", got == text.casefold(), f"{len(ml):,} bytes vs str.casefold")
    part = ml_np[: 4 << 20]
    rows = stream_rows(part, width=32)
    out, counts = CF.fold_tokens(rows, max_cp=max(map(ord, text[: 1 << 20])) | 0xFFFF)
    out, counts = np.asarray(out), np.asarray(counts)
    got = _utf32(out[np.arange(out.shape[1])[None, :] < counts[:, None]])
    _check("casefold rows", got == part.tobytes().decode().casefold(),
           f"{part.size:,}-byte slice in 32-byte rows vs str.casefold")
    piece = text[: 1 << 16]
    cps = np.frombuffer(piece.encode("utf-32-le"), "<u4").astype(np.int32)
    for form in ("NFC", "NFD", "NFKC", "NFKD"):
        got = _utf32(normalize(cps, form))
        _check(form, got == unicodedata.normalize(form, piece),
               f"{len(piece):,} codepoints vs unicodedata")

    # Segmentation: GPU vs the same functions on JAX's CPU backend.
    from stringwars_tpu.ops import segment as SEG

    seg = jnp.asarray(ml_np[: 4 << 20])
    m_seg = int(seg.shape[0])
    cpu = jax.devices("cpu")[0]
    seg_cpu = jax.device_put(seg, cpu)
    for label, fn in (
        ("graphemes", SEG.grapheme_boundaries), ("words", SEG.word_boundaries),
        ("sentences", SEG.sentence_boundaries), ("linebreaks", SEG.linebreak_opportunities),
    ):
        gb, gc = fn(seg, m_seg)
        with jax.default_device(cpu):
            cb, cc = fn(seg_cpu, m_seg)
        ok = int(gc) == int(cc) and np.array_equal(np.asarray(gb), np.asarray(cb))
        _check(f"tr29/uax14 {label}", ok, f"{m_seg:,}-byte slice, count {int(gc)} vs CPU backend {int(cc)}")

    # BPE: the suite's pre-split and merge table vs bpe_encode_ref.
    from stringwars_tpu.ops.bpe import MergeTable, bpe_encode, bpe_encode_ref, train_merges

    pat = re.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+""")
    pre = [p.encode() for p in pat.findall(text[: 1 << 20])]
    pre = [p for p in pre if 0 < len(p) <= 32][:50_000]
    merges = train_merges(pre[:10_000], 256)
    W = max(map(len, pre))
    mat = np.zeros((len(pre), W), np.uint8)
    for i, t in enumerate(pre):
        mat[i, : len(t)] = np.frombuffer(t, np.uint8)
    ids, counts = bpe_encode(
        PaddedTokens(jnp.asarray(mat), jnp.asarray([len(t) for t in pre], dtype=jnp.int32), W),
        MergeTable.from_merges(merges),
    )
    ids, counts = np.asarray(ids), np.asarray(counts)
    ok = all(ids[i, : counts[i]].tolist() == bpe_encode_ref(pre[i], merges) for i in range(0, len(pre), 10))
    _check("bpe", ok, f"{len(pre) // 10:,} of {len(pre):,} pretokens, 256 merges, vs bpe_encode_ref")

    # ChaCha20-Poly1305: RFC 8439 §2.8.2 vector and a corpus round trip.
    from stringwars_tpu.ops import chacha as CC

    key = bytes(range(0x80, 0xA0))
    nonce = bytes.fromhex("070000004041424344454647")
    aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one "
          b"tip for the future, sunscreen would be it.")
    ct, tag = CC.aead_encrypt(key, nonce, pt, aad)
    ok = bytes(ct).hex().startswith("d31a8d34648e60db7b86afbc53ef7ec2") and \
        bytes(tag).hex() == "1ae10b594f09e26a7e902ecbd0600691"
    body = words_corpus[: 8 << 20].tobytes()
    ct2, tag2 = CC.aead_encrypt(key, nonce, body)
    ok &= bytes(CC.aead_decrypt(key, nonce, ct2, tag2)) == body
    _check("chacha20poly1305", ok, "RFC 8439 2.8.2 vector + 8 MB round trip")
    return 0


def _child_multichip() -> int:
    """Every <4chip> path against its one-card answer."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stringwars_tpu import datasets
    from stringwars_tpu.parallel.mesh import SHARD_AXIS, make_mesh
    from stringwars_tpu.tape import PaddedTokens, Tape

    one, four = make_mesh(1), make_mesh(4)
    corpus = np.frombuffer(datasets.synthesize("english-words", 16 << 20), np.uint8)
    n = corpus.shape[0]

    from stringwars_tpu.ops import find as F
    from stringwars_tpu.suites.find import make_sharded_find

    tape = Tape.from_buffer(corpus.tobytes(), "words")
    needle = tape.to_list()[777]
    packed = F.pack_needle(needle, 16)
    args = (np.asarray(packed.words), np.asarray(packed.masks), np.asarray(packed.length))
    step, rows = make_sharded_find(four, corpus, n, 16, backward=True)
    count, last = (int(v) for v in step(rows, *args))
    want = tuple(int(v) for v in F.rfind_count(corpus, packed, n))
    _check("find <4chip>", (count, last) == want, f"(count, last) {(count, last)} vs one card {want}")

    from stringwars_tpu.ops import similarity as S
    from stringwars_tpu.ops.myers_pallas import myers_from_tokens
    from stringwars_tpu.suites.similarities import make_sharded_scorer, myers_scorer

    lines = [ln for ln in datasets.synthesize("dna-100b", 2 << 20).split(b"\n") if ln]
    qa, qb = lines[:4096], lines[4096:8192]
    mb = myers_from_tokens(qa, qb)
    got = np.asarray(myers_scorer(four, mb)()).reshape(-1)[: len(qa)]
    want = np.asarray(myers_scorer(one, mb)()).reshape(-1)[: len(qa)]
    _check("levenshtein <4chip>", np.array_equal(got, want), f"{len(qa)} pairs vs one card")
    batch = S.pack_pairs(qa, qb)
    for label, fn in (("nw affine", S.nw_score_affine), ("sw linear", S.sw_score_linear)):
        got = np.asarray(make_sharded_scorer(four, batch, fn)()).reshape(-1)[: len(qa)]
        _check(f"{label} <4chip>", np.array_equal(got, np.asarray(fn(batch))), f"{len(qa)} pairs vs one card")

    from stringwars_tpu.ops.sort import argsort_sharded, argsort_tape

    got = argsort_sharded(tape, four)
    _check("argsort <4chip>", np.array_equal(got, argsort_tape(tape)), f"{tape.count:,} words vs one card")

    from stringwars_tpu.ops import memops as M

    lut = jnp.asarray(M.invert_case_lut())
    pad = (-n) % 4
    sharded = jax.device_put(np.pad(corpus, (0, pad)), four.sharding(P(SHARD_AXIS)))
    got = np.asarray(jax.jit(M.lut_translate)(sharded, lut))[:n]
    _check("lut_translate <4chip>", np.array_equal(got, np.asarray(M.lut_translate(corpus, lut))), f"{n:,} bytes vs one card")

    from stringwars_tpu.ops.fingerprint import fingerprint

    ltape = Tape.from_buffer(datasets.synthesize("long-lines", 4 << 20), "lines")
    ltape = ltape.subtape(0, min(1024, ltape.count) // 4 * 4)
    toks = PaddedTokens.from_tape(ltape, max_width=4096)
    st = PaddedTokens(
        data=jax.device_put(np.asarray(toks.data), four.sharding(P(SHARD_AXIS, None))),
        lengths=jax.device_put(np.asarray(toks.lengths), four.data_sharding),
        width=toks.width,
    )
    fp = jax.jit(lambda t: fingerprint(t, ndim=128))
    got, want = fp(st), fp(toks)
    ok = all(np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want))
    _check("minhash <4chip>", ok, f"{len(ltape.to_list())} lines vs one card")

    from stringwars_tpu.parallel.pipeline import make_sharded_step
    from stringwars_tpu.suites.scaling import build_inputs

    inputs, _total, ac_n, ac_chunk = build_inputs(four.mesh, tape, 4096, 4 << 20)
    out4 = make_sharded_step(four.mesh, ac_n=ac_n, ac_chunk=ac_chunk)(*inputs)
    host = [np.asarray(x) for x in inputs]
    specs = [x.sharding.spec for x in inputs]
    inputs1 = [jax.device_put(h, NamedSharding(one.mesh, s)) for h, s in zip(host, specs)]
    out1 = make_sharded_step(one.mesh, ac_n=ac_n, ac_chunk=ac_chunk)(*inputs1)
    keys = ("matches", "ac_matches", "digest_checksum", "bpe_tokens")
    ok = all(int(out4[k]) == int(out1[k]) for k in keys)
    _check("pipeline <4chip>", ok, ", ".join(f"{k} {int(out4[k])}/{int(out1[k])}" for k in keys))

    sys.path.insert(0, ROOT)
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(4)
    _check("dryrun_multichip(4)", True, "sharded step + sample sort asserted against one device")
    return 0


if __name__ == "__main__":
    sys.exit(main())
