"""The flagship sharded pipeline: the multi-chip end-to-end step.

BASELINE.json's config 5: "full pipeline on sharded corpus: Aho-Corasick
multi-pattern + MinHash fingerprints + regex pre-split tokenization across
N >= 2 hosts" — corpus shards are data-parallel across chips,
pattern/LUT/transition/merge tables are replicated, match/token/hash
counts are psum-reduced across devices. This module wires the kernel families
into one ``shard_map``-ed step used by the driver's multichip dry run, the
scaling suite rows, and ``__graft_entry__``:

- byte-axis haystack shards with (m-1)-byte halos -> substring match
  counts (K1), psum-reduced;
- Aho-Corasick multi-pattern counts (K2) over per-chip DFA lane rows with
  the replicated transition table (gather-chain scan), psum-reduced;
- token-batch shards -> xxh64 digests (K3) + MinHash fingerprints (K6) +
  byte-level BPE encoding against replicated merge tables (the regex
  pre-split happens host-side at staging), locally computed; digest
  checksum and BPE output-token count psum-reduced;
- a replicated 256-entry LUT translate (K12) over the local shard.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from stringwars_tpu.ops import find as F
from stringwars_tpu.ops import hash as H
from stringwars_tpu.ops.fingerprint import fingerprint
from stringwars_tpu.parallel.mesh import SHARD_AXIS, DeviceScope
from stringwars_tpu.tape import PaddedTokens


def _local_step(
    hay_rows,
    tokens_data,
    tokens_lengths,
    needle_words,
    needle_masks,
    needle_len,
    lut,
    ac_rows,
    ac_gpos0,
    ac_delta,
    ac_out_count,
    bpe_keys,
    bpe_ranks,
    bpe_newids,
    *,
    ac_n: int,
    ac_chunk: int,
):
    """Per-shard compute (runs under shard_map on the local block)."""
    # K1: all-matches substring count over this shard's haystack rows.
    # Each row is a chunk plus an (m-1)-byte halo: compare windows over the
    # halo (n_cmp) but count only starts the chunk owns (limit), so
    # seam-straddling matches are counted by exactly one shard.
    needle = F.PackedNeedle(words=needle_words, masks=needle_masks, length=needle_len)
    row_n = hay_rows.shape[1]
    max_m = 4 * needle.capacity - 3
    chunk = row_n - 4 * needle.capacity - 8
    n_cmp = row_n - (max_m - 1)
    match_count = jnp.int32(0)
    for r in range(hay_rows.shape[0]):
        match_count += F._count_from_mask_limit(hay_rows[r], needle, n_cmp, chunk)
    # K2: Aho-Corasick multi-pattern count over this shard's DFA lane rows
    # (replicated transition table).
    from stringwars_tpu.ops.ahocorasick import _ac_scan

    ac_count_local = _ac_scan(ac_delta, ac_out_count, ac_rows, ac_gpos0, ac_n, ac_chunk)
    # K3 + K6: hash and fingerprint the local token batch.
    tokens = PaddedTokens(data=tokens_data, lengths=tokens_lengths, width=tokens_data.shape[1])
    layout = H.prepare(tokens)
    digests = H.xxh64(layout)
    mh, _ = fingerprint(tokens, ndim=32, with_counts=False)
    digest_checksum = jnp.sum(digests.lo, dtype=jnp.uint32) + jnp.sum(digests.hi, dtype=jnp.uint32)
    # BPE (config 5 "regex pre-split tokenization"): encode the local
    # pretoken batch against the replicated merge table.
    from stringwars_tpu.ops.bpe import _bpe_encode

    bpe_ids, bpe_counts = _bpe_encode(
        tokens_data.astype(jnp.int32),
        tokens_lengths.astype(jnp.int32),
        bpe_keys,
        bpe_ranks,
        bpe_newids,
        max(tokens_data.shape[1] - 1, 1),
    )
    bpe_total = jnp.sum(bpe_counts, dtype=jnp.int32)
    # K12: replicated-LUT translate of the local token bytes.
    translated = jnp.take(lut, tokens_data.astype(jnp.int32))
    # Cross-shard reductions.
    total_matches = jax.lax.psum(match_count, SHARD_AXIS)
    total_ac = jax.lax.psum(ac_count_local, SHARD_AXIS)
    total_checksum = jax.lax.psum(digest_checksum, SHARD_AXIS)
    total_bpe = jax.lax.psum(bpe_total, SHARD_AXIS)
    return {
        "matches": total_matches,
        "ac_matches": total_ac,
        "digest_checksum": total_checksum,
        "bpe_tokens": total_bpe,
        "digests_lo": digests.lo,
        "minhash": mh,
        "bpe_ids": bpe_ids,
        "translated": translated,
    }


def make_sharded_step(mesh: Mesh, *, ac_n: int, ac_chunk: int):
    """Build the jitted multi-chip pipeline step for ``mesh``."""
    step = shard_map(
        functools.partial(_local_step, ac_n=ac_n, ac_chunk=ac_chunk),
        mesh=mesh,
        in_specs=(
            P(SHARD_AXIS, None),  # haystack rows (one per chip, with halo)
            P(SHARD_AXIS, None),  # token bytes
            P(SHARD_AXIS),  # token lengths
            P(),  # needle words (replicated)
            P(),  # needle masks
            P(),  # needle length
            P(),  # LUT
            P(SHARD_AXIS, None),  # AC lane rows
            P(SHARD_AXIS),  # AC lane global offsets
            P(),  # AC transition table [S * 256] (replicated)
            P(),  # AC output counts [S]
            P(),  # BPE sorted pair keys
            P(),  # BPE ranks
            P(),  # BPE new ids
        ),
        out_specs={
            "matches": P(),
            "ac_matches": P(),
            "digest_checksum": P(),
            "bpe_tokens": P(),
            "digests_lo": P(SHARD_AXIS),
            "minhash": P(SHARD_AXIS, None),
            "bpe_ids": P(SHARD_AXIS, None),
            "translated": P(SHARD_AXIS, None),
        },
        check_vma=False,
    )
    return jax.jit(step)


def stage_ac_rows(corpus: np.ndarray, n_chips: int, max_len: int, lanes_per_chip: int = 4096):
    """Chunked AC lane rows covering ``corpus``, ``lanes_per_chip`` rows per
    chip, each with a (max_len-1)-byte entry-state overlap."""
    n = corpus.shape[0]
    overlap = max_len - 1
    c_count = n_chips * lanes_per_chip
    chunk = max(-(-n // c_count), 8)
    buf = np.zeros(c_count * chunk + overlap, np.uint8)
    buf[overlap : overlap + n] = corpus[:n]
    rows = np.lib.stride_tricks.sliding_window_view(buf, chunk + overlap)[::chunk][:c_count]
    gpos0 = np.arange(c_count, dtype=np.int32) * chunk - overlap
    return np.ascontiguousarray(rows), gpos0, n, chunk


def _pipeline_inputs(
    mesh: Mesh,
    corpus: np.ndarray,
    tokens: np.ndarray,
    lengths: np.ndarray,
    *,
    needle: bytes = b"th",
    ac_patterns: tuple = (b"the", b"and", b"ab"),
):
    """Stage shared pipeline inputs: needle + AC + BPE tables and shardings."""
    from stringwars_tpu.ops.ahocorasick import Automaton
    from stringwars_tpu.ops.bpe import MergeTable, train_merges

    n_chips = mesh.devices.size
    packed = F.pack_needle(needle, capacity_words=4)
    auto = Automaton(list(ac_patterns))
    ac_rows, ac_gpos0, ac_n, ac_chunk = stage_ac_rows(corpus, n_chips, auto.max_len)
    sample = [tokens[i, : lengths[i]].tobytes() for i in range(min(len(lengths), 4000)) if lengths[i]]
    merges = train_merges(sample, 64) or [(ord("t"), ord("h"))]
    table = MergeTable.from_merges(merges)
    lut = np.arange(256, dtype=np.uint8)[::-1].copy()

    shard2 = NamedSharding(mesh, P(SHARD_AXIS, None))
    shard1 = NamedSharding(mesh, P(SHARD_AXIS))
    repl = NamedSharding(mesh, P())
    inputs = (
        jax.device_put(tokens, shard2),
        jax.device_put(lengths, shard1),
        jax.device_put(np.asarray(packed.words), repl),
        jax.device_put(np.asarray(packed.masks), repl),
        jax.device_put(np.asarray(packed.length), repl),
        jax.device_put(lut, repl),
        jax.device_put(ac_rows, shard2),
        jax.device_put(ac_gpos0, shard1),
        jax.device_put(np.asarray(auto.delta_flat), repl),
        jax.device_put(np.asarray(auto.out_count), repl),
        jax.device_put(np.asarray(table.sorted_keys), repl),
        jax.device_put(np.asarray(table.ranks), repl),
        jax.device_put(np.asarray(table.new_ids), repl),
    )
    return inputs, packed, ac_n, ac_chunk


def demo_inputs(mesh: Mesh, *, tokens_per_chip: int = 8, token_width: int = 64, hay_bytes: int = 4096):
    """Small sharded inputs for the dry run (one haystack row per chip).

    Returns (inputs tuple, ac_n, ac_chunk) — pass the statics to
    ``make_sharded_step``."""
    n_chips = mesh.devices.size
    rng = np.random.default_rng(0)
    packed = F.pack_needle(b"ab", capacity_words=4)
    row_len = hay_bytes + 4 * packed.capacity + 8
    hay = rng.integers(97, 99, (n_chips, row_len), dtype=np.uint8)  # 'a'/'b' soup
    tokens = rng.integers(97, 123, (n_chips * tokens_per_chip, token_width), dtype=np.uint8)
    lengths = rng.integers(1, token_width, n_chips * tokens_per_chip, dtype=np.int32)
    corpus = hay[:, :hay_bytes].reshape(-1)
    inputs, _packed, ac_n, ac_chunk = _pipeline_inputs(mesh, corpus, tokens, lengths, needle=b"ab")
    hay_dev = jax.device_put(hay, NamedSharding(mesh, P(SHARD_AXIS, None)))
    return (hay_dev,) + inputs, ac_n, ac_chunk
