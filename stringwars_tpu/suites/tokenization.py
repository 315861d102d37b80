"""Tokenization suite: whitespace/newline splits, TR29 segmentation,
UTF-8 machinery (reference ``tokenization/bench.rs``, defaults 3 s + 20 s,
lines tokens; splitters process the corpus per call and report segments,
counters scan the whole file).
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.ops import segment as SEG
from stringwars_tpu.ops import utf8 as U8
from stringwars_tpu.ops.bpe import MergeTable, bpe_encode, bpe_encode_ref, train_merges
from stringwars_tpu.suites._common import setup_suite
from stringwars_tpu.tape import PaddedTokens
from stringwars_tpu.utils.harness import DeviceRoutine, WorkUnits, fold_salt
from stringwars_tpu.utils.report import report_skip


def _cp_ceiling(max_byte: int) -> int:
    """Corpus codepoint ceiling from the max BYTE (UTF-8 lead ranges):
    static hint for the segmentation rule maps (pruned boundary walks)."""
    if max_byte < 0x80:
        return 0x7F
    if max_byte < 0xE0:
        return 0x7FF
    if max_byte < 0xF0:
        return 0xFFFF
    return 0x10FFFF


def _stream_routine(data, n: int, call, *, counts_only: bool = False) -> DeviceRoutine:
    """Chained whole-stream row: a salt-driven roll perturbs the byte
    stream every iteration (UTF-8-preserving up to the single wrap seam)
    so no iteration repeats the previous one; scalar outputs fold back
    into the salt (``counts_only`` skips folding large boundary-mask
    outputs, which would add a full extra reduce)."""

    def body(s, e, d):
        shift = (s % jnp.uint32(d.shape[0])).astype(jnp.int32)
        out = call(jnp.roll(d, shift))
        outs = out if isinstance(out, tuple) else (out,)
        if counts_only:
            outs = outs[1:]
        return fold_salt(s, *outs), e

    return DeviceRoutine(body=body, consts=(data,), units=WorkUnits(1, n))


def main() -> None:
    ctx = setup_suite(
        "Segmentation + UTF-8 machinery throughput",
        default_tokens="file",
        default_warmup=3.0,
        default_time=20.0,
        default_synthetic="multilingual",
    )
    n = ctx.tape.total_bytes
    data_np = np.asarray(ctx.tape.data)[:n]
    data = jnp.asarray(data_np)
    host_bytes = data_np.tobytes()
    mcp = _cp_ceiling(int(data_np.max()) if n else 0)

    ctx.group("tokenize-whitespace")
    ctx.run(
        "tokenize-whitespace/swtpu::split<1chip>",
        "bytes",
        _stream_routine(data, n, lambda d: SEG.whitespace_token_count(d, n, max_cp=mcp)),
    )
    host_text = host_bytes.decode("utf-8", "ignore")
    ctx.run(
        "tokenize-whitespace/str.split",
        "bytes",
        lambda: (len(host_text.split()), WorkUnits(1, n))[1],
    )

    ctx.group("tokenize-newlines")
    ctx.run(
        "tokenize-newlines/swtpu::split<1chip>",
        "bytes",
        _stream_routine(data, n, lambda d: SEG.newline_split_count(d, n, max_cp=mcp)),
    )
    ctx.run(
        "tokenize-newlines/str.splitlines",
        "bytes",
        lambda: (len(host_text.splitlines()), WorkUnits(1, n))[1],
    )

    ctx.group("tokenize-words-tr29")
    ctx.run(
        "tokenize-words-tr29/swtpu::words<1chip>",
        "bytes",
        _stream_routine(data, n, lambda d: SEG.word_boundaries(d, n, max_cp=mcp), counts_only=True),
    )
    try:
        import regex as regex_mod
    except ImportError:
        regex_mod = None
        report_skip("tokenize-words-tr29/regex-WORD", "regex not installed")
    else:
        ctx.run(
            "tokenize-words-tr29/regex-WORD",
            "bytes",
            lambda: (
                sum(1 for _ in regex_mod.finditer(r"\b", host_text, flags=regex_mod.V1 | regex_mod.WORD)),
                WorkUnits(1, n),
            )[1],
        )

    ctx.group("tokenize-graphemes-tr29")
    ctx.run(
        "tokenize-graphemes-tr29/swtpu::graphemes<1chip>",
        "bytes",
        _stream_routine(data, n, lambda d: SEG.grapheme_boundaries(d, n, max_cp=mcp), counts_only=True),
    )
    if regex_mod is None:
        report_skip("tokenize-graphemes-tr29/regex-\\X", "regex not installed")
    else:
        ctx.run(
            "tokenize-graphemes-tr29/regex-\\X",
            "bytes",
            lambda: (len(regex_mod.findall(r"\X", host_text)), WorkUnits(1, n))[1],
        )

    ctx.group("tokenize-sentences-tr29")
    ctx.run(
        "tokenize-sentences-tr29/swtpu::sentences<1chip>",
        "bytes",
        _stream_routine(data, n, lambda d: SEG.sentence_boundaries(d, n, max_cp=mcp), counts_only=True),
    )

    ctx.group("tokenize-lines-uax14")
    ctx.run(
        "tokenize-lines-uax14/swtpu::linebreaks<1chip>",
        "bytes",
        _stream_routine(data, n, lambda d: SEG.linebreak_opportunities(d, n, max_cp=mcp), counts_only=True),
    )

    ctx.group("utf8-length")
    cnt = jax.jit(U8.utf8_count, static_argnames=("n",))
    ctx.run(
        "utf8-length/swtpu::count_utf8<1chip>",
        "bytes",
        _stream_routine(data, n, lambda d: U8.utf8_count(d, n)),
    )
    ctx.run(
        "utf8-length/bytes.decode-len",
        "bytes",
        lambda: (len(host_bytes.decode("utf-8", "ignore")), WorkUnits(1, n))[1],
    )

    ctx.group("utf8-iterate")
    ctx.run(
        "utf8-iterate/swtpu::decode_utf32<1chip>",
        "bytes",
        _stream_routine(data, n, lambda d: U8.utf8_decode(d, n), counts_only=True),
    )

    ctx.group("find-nth-utf8")
    nth = jax.jit(U8.utf8_find_nth, static_argnames=("n",))
    total_cp = int(cnt(data, n))
    last = jnp.int32(max(total_cp - 1, 0))
    ctx.run(
        "find-nth-utf8/swtpu::find_nth<1chip>",
        "bytes",
        _stream_routine(data, n, lambda d: U8.utf8_find_nth(d, n, last)),
    )

    # --- Byte-level BPE over regex pre-split pretokens (BASELINE.json
    # configs 1 & 5: "regex-pre-split byte-level tokenization with
    # replicated merge/vocab tables").
    ctx.group("tokenize-bpe")
    # GPT-2's pre-tokenization pattern (public; Radford et al. 2019) in
    # stdlib ``re``: ``[^\W\d_]`` stands in for ``\p{L}`` and ``\d`` for
    # ``\p{N}`` (close for the letters and digits of real text; ``re`` has
    # no Unicode property classes).
    gpt2_pat = re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+"""
    )
    pretokens = [p.encode("utf-8") for p in gpt2_pat.findall(host_text[: 4 << 20])]
    pretokens = [p for p in pretokens if 0 < len(p) <= 32][:400_000]
    merges = train_merges(pretokens[:30_000], 512)
    # Length-sorted staging: rows of similar length finish their merge
    # loops together (batch order is the encoder's to choose).
    pretokens.sort(key=len)
    table = MergeTable.from_merges(merges)
    W = max(max(map(len, pretokens), default=1), 1)
    mat = np.zeros((len(pretokens), W), np.uint8)
    for i, t in enumerate(pretokens):
        mat[i, : len(t)] = np.frombuffer(t, np.uint8)
    staged = PaddedTokens(
        data=jax.device_put(mat),
        lengths=jax.device_put(np.array([len(t) for t in pretokens], np.int32)),
        width=W,
    )
    pre_bytes = int(sum(map(len, pretokens)))

    def bpe_body(s, e, rows, lengths):
        shift = (s % jnp.uint32(rows.shape[0])).astype(jnp.int32)
        rolled = PaddedTokens(
            data=jnp.roll(rows, shift, axis=0),
            lengths=jnp.roll(lengths, shift),
            width=staged.width,
        )
        ids, counts = bpe_encode(rolled, table)
        return fold_salt(s, ids[:64], counts[:64]), e

    ctx.run(
        "tokenize-bpe/swtpu::bpe_encode<1chip>",
        "bytes",
        DeviceRoutine(
            body=bpe_body,
            consts=(staged.data, staged.lengths),
            units=WorkUnits(elements=len(pretokens), bytes=pre_bytes),
        ),
    )

    sample = pretokens[:2000]
    sample_bytes = sum(map(len, sample))

    def bpe_host() -> WorkUnits:
        for t in sample:
            bpe_encode_ref(t, merges)
        return WorkUnits(elements=len(sample), bytes=sample_bytes)

    ctx.run("tokenize-bpe/python-bpe", "bytes", bpe_host)
    ctx.finish()


if __name__ == "__main__":
    main()
