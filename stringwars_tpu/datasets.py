"""Dataset layer (L1): corpus loading, generation, and stderr statistics.

Mirrors the reference's loader contract (``utils.rs:250-433``,
``utils.py:342-462``): read a corpus file (path from ``SWTPU_DATASET`` or
``--dataset``), cap its size (``--dataset-limit``), tokenize into
lines/words/file granularity honoring ``SWTPU_MAX_TOKENS`` and
``SWTPU_UNIQUE``, and log token-count/size stats with an 18-bucket log2
length histogram to stderr (``utils.rs:402-431``).

Because the build environment has no network egress, this module also owns
**reproducible synthetic corpus generators** standing in for the reference's
downloadable datasets (``README.md:377-571``): an English-like Zipfian text,
~1 KB long-line text, multilingual UTF-8 (EN/DE/RU/EL/KO/ZH/AR mix), and
ACGT DNA sequences. All generators are seeded (``SWTPU_SEED``, default 42).
"""

from __future__ import annotations

import os
import sys
import zlib

import numpy as np

from stringwars_tpu.tape import Tape
from stringwars_tpu.utils.config import get_env, get_env_bool, get_env_parsed, parse_size

DEFAULT_SEED = 42


def load_corpus(
    dataset_path: str | None = None,
    *,
    size_limit: str | None = "128mb",
    default_synthetic: str = "english-words",
) -> bytes:
    """Read the corpus file, or synthesize a deterministic one when unset.

    The reference aborts with a download hint when the dataset is missing
    (``utils.rs:144-230``); offline, we instead synthesize the named corpus
    so every suite is runnable out of the box. ``SWTPU_DATASET`` may name a
    file path or one of the synthetic corpus names (``synthetic:<name>``).
    """
    path = dataset_path if dataset_path is not None else get_env("DATASET")
    max_bytes = parse_size(size_limit) if size_limit else None
    if path is None or path.startswith("synthetic:"):
        name = path.split(":", 1)[1] if path else default_synthetic
        size = max_bytes if max_bytes else 128 << 20
        data = synthesize(name, size, seed=get_env_parsed("SEED", DEFAULT_SEED))
        print(f"Dataset: synthetic:{name} ({len(data):,} bytes, seed fixed)", file=sys.stderr)
        return data
    with open(path, "rb") as f:
        return f.read(max_bytes) if max_bytes is not None else f.read()


def load_tape(
    dataset_path: str | None = None,
    *,
    tokens_mode: str = "words",
    size_limit: str | None = "128mb",
    default_synthetic: str = "english-words",
    device=None,
) -> Tape:
    """End-to-end: load corpus → tokenize → tape → stderr stats."""
    data = load_corpus(dataset_path, size_limit=size_limit, default_synthetic=default_synthetic)
    max_tokens = get_env_parsed("MAX_TOKENS", 0) or None
    unique = get_env_bool("UNIQUE")
    tape = Tape.from_buffer(data, tokens_mode, max_tokens=max_tokens, unique=unique, device=device)
    log_tape_stats(tape, tokens_mode)
    return tape


def log_tape_stats(tape: Tape, mode: str) -> None:
    """Token stats + 18-bucket log2 length histogram, to stderr."""
    lengths = np.asarray(tape.offsets)
    lengths = (lengths[1:] - lengths[:-1]).astype(np.int64)
    total = int(lengths.sum())
    count = lengths.shape[0]
    mean = total / max(count, 1)
    print(
        f"Loaded {count:,} {mode} tokens, {total:,} bytes, mean length {mean:.1f} B",
        file=sys.stderr,
    )
    if count:
        buckets = np.clip(np.floor(np.log2(np.maximum(lengths, 1))).astype(np.int64), 0, 17)
        hist = np.bincount(buckets, minlength=18)
        for b in range(18):
            if hist[b]:
                lo, hi = (1 << b), (1 << (b + 1)) - 1
                print(f"  [{lo:>6}-{hi:>6} B] {int(hist[b]):>12,}", file=sys.stderr)


# ---------------------------------------------------------------------------
# Synthetic corpora
# ---------------------------------------------------------------------------

_CORPORA = {}


def corpus_names() -> list[str]:
    return sorted(_CORPORA)


def synthesize(name: str, size: int, *, seed: int = DEFAULT_SEED) -> bytes:
    """Generate ~``size`` bytes of the named corpus, deterministically."""
    try:
        generator = _CORPORA[name]
    except KeyError:
        raise ValueError(f"Unknown synthetic corpus {name!r}; choose from {corpus_names()}") from None
    # crc32, not hash(): str hashes differ between processes.
    return generator(size, np.random.default_rng([seed, zlib.crc32(name.encode())]))


def _register(name):
    def wrap(fn):
        _CORPORA[name] = fn
        return fn

    return wrap


def _zipf_vocabulary(rng: np.random.Generator, vocab_size: int, alphabet: np.ndarray, mean_len: float):
    """A vocabulary of random words with Zipf-ranked frequencies."""
    lengths = np.clip(rng.poisson(mean_len, vocab_size), 1, 4 * int(mean_len) + 2)
    words = [alphabet[rng.integers(0, alphabet.size, l)].tobytes() for l in lengths]
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return words, probs


def _ragged_bytes(table: np.ndarray, lengths: np.ndarray, entries: np.ndarray) -> bytes:
    """Concatenate variable-length byte strings: entry ``e`` is
    ``table[e, :lengths[e]]``; emits ``entries`` in order."""
    rows = table[entries]
    keep = np.arange(table.shape[1])[None, :] < lengths[entries][:, None]
    return rows[keep].tobytes()


def _byte_table(strings: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    lengths = np.array([len(s) for s in strings], np.int64)
    table = np.zeros((len(strings), max(int(lengths.max()), 1)), np.uint8)
    for i, s in enumerate(strings):
        table[i, : len(s)] = np.frombuffer(s, np.uint8)
    return table, lengths


def _compose_words(size: int, rng, words, probs, separator: bytes = b" ", line_words: int | None = None) -> bytes:
    """Zipf-drawn words joined by ``separator``, a newline after every
    ``line_words`` words; built in vectorized batches of words."""
    # Entries: the vocabulary with the separator appended, then with "\n".
    table, lengths = _byte_table([w + separator for w in words] + [w + b"\n" for w in words])
    mean = float(np.dot(probs, lengths[: len(words)]))
    out = bytearray()
    batch = max(1 << 16, min(1 << 21, int(size / mean) + 1))
    drawn = 0
    while len(out) < size:
        idx = rng.choice(len(words), size=batch, p=probs)
        if line_words:
            ends_line = (np.arange(drawn, drawn + batch) + 1) % line_words == 0
            idx = np.where(ends_line, idx + len(words), idx)
        drawn += batch
        out += _ragged_bytes(table, lengths, idx)
    return bytes(out[:size])


@_register("english-words")
def _english_words(size: int, rng) -> bytes:
    """ASCII words, Zipf frequencies, ~5.5 B mean length, newline every ~12 words."""
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    words, probs = _zipf_vocabulary(rng, 30_000, alphabet, 5.5)
    return _compose_words(size, rng, words, probs, line_words=12)


@_register("long-lines")
def _long_lines(size: int, rng) -> bytes:
    """~1 KB lines of ASCII words — the reference's 'long lines' shape."""
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", dtype=np.uint8)
    words, probs = _zipf_vocabulary(rng, 50_000, alphabet, 6.0)
    return _compose_words(size, rng, words, probs, line_words=150)


@_register("dna")
def _dna(size: int, rng) -> bytes:
    """ACGT sequences, one 1 KB read per line (similarities workloads)."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    flat = acgt[rng.integers(0, 4, size)]
    flat[1023::1024] = 0x0A
    return flat.tobytes()


@_register("dna-100b")
def _dna_100b(size: int, rng) -> bytes:
    """ACGT with 100-byte reads per line."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    flat = acgt[rng.integers(0, 4, size)]
    flat[100::101] = 0x0A
    return flat.tobytes()


def _range_alphabet(*ranges: tuple[int, int]) -> list[str]:
    chars = []
    for lo, hi in ranges:
        chars.extend(chr(c) for c in range(lo, hi))
    return chars


@_register("multilingual")
def _multilingual(size: int, rng) -> bytes:
    """UTF-8 mix of Latin/German/Cyrillic/Greek/Hangul/CJK/Arabic words.

    Stands in for the reference's per-language Wikipedia/UDHR corpora used by
    normalization and tokenization suites; every generated string is valid
    UTF-8 with multi-byte sequences of widths 1-3. Text comes in runs of 200
    words from one script; words are 1-8 characters, followed by a newline
    with probability 1/12 and a space otherwise.
    """
    pools = [
        _range_alphabet((0x61, 0x7B)),  # a-z
        _range_alphabet((0x61, 0x7B)) + list("äöüßéèê"),  # German/French Latin-1
        _range_alphabet((0x430, 0x450)),  # Cyrillic
        _range_alphabet((0x3B1, 0x3CA)),  # Greek
        _range_alphabet((0xAC00, 0xAC00 + 256)),  # Hangul syllables
        _range_alphabet((0x4E00, 0x4E00 + 256)),  # CJK
        _range_alphabet((0x627, 0x64B)),  # Arabic
    ]
    chars = [c for pool in pools for c in pool]
    table, lengths = _byte_table([c.encode("utf-8") for c in chars] + [b" ", b"\n"])
    space, newline = len(chars), len(chars) + 1
    pool_size = np.array([len(p) for p in pools], np.int64)
    pool_base = np.concatenate([[0], np.cumsum(pool_size)[:-1]])
    words_per_run = 200
    out = bytearray()
    while len(out) < size:
        runs = max(1, min(4096, size // (words_per_run * 10)))
        pool_of_word = np.repeat(rng.integers(0, len(pools), runs), words_per_run)
        word_len = rng.integers(1, 9, pool_of_word.shape[0])
        pool_of_char = np.repeat(pool_of_word, word_len)
        local = (rng.random(pool_of_char.shape[0]) * pool_size[pool_of_char]).astype(np.int64)
        seps = np.where(rng.integers(0, 12, word_len.shape[0]) == 0, newline, space)
        # Each word is its characters followed by one separator entry.
        ends = np.cumsum(word_len + 1) - 1
        entries = np.empty(int(ends[-1]) + 1, np.int64)
        is_sep = np.zeros(entries.shape[0], bool)
        is_sep[ends] = True
        entries[is_sep] = seps
        entries[~is_sep] = pool_base[pool_of_char] + local
        out += _ragged_bytes(table, lengths, entries)
    # Trim to a UTF-8 boundary: drop trailing continuation bytes.
    end = size
    while end > 0 and (out[end - 1] & 0xC0) == 0x80:
        end -= 1
    if end > 0 and out[end - 1] >= 0xC0:
        end -= 1
    return bytes(out[:end])


@_register("naughty")
def _naughty(size: int, rng) -> bytes:
    """Adversarial strings: empties, huge tokens, NULs, all byte values,
    UTF-8 edge sequences — the offline analog of the Big List of Naughty
    Strings corpus the reference recommends (``README.md:391-396``)."""
    pieces: list[bytes] = [
        b"",
        b"\x00" * 17,
        bytes(range(256)),
        "\x00\uffff\U0010ffff".encode("utf-8"),
        "ß SS ss ẞ".encode("utf-8"),
        "é é ﬁ ﬂ".encode("utf-8"),
        "가각갂 각".encode("utf-8"),
        b"a" * 4096,
    ]
    out = bytearray()
    ascii_pool = np.frombuffer(bytes(range(0x20, 0x7F)), dtype=np.uint8)
    while len(out) < size:
        if rng.integers(0, 4) == 0:
            out += pieces[int(rng.integers(0, len(pieces)))]
        else:
            n = int(rng.integers(1, 40))
            out += ascii_pool[rng.integers(0, ascii_pool.size, n)].tobytes()
        out += b"\n"
    return bytes(out[:size])
