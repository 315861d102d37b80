"""Containers suite: multiseed digests (Layer 1) + probabilistic filters
(Layer 2) (reference ``containers/bench.rs``, defaults 2 s + 10 s, words).

Startup runs the multiseed==per-seed conformance assertion exactly like the
reference (``containers/bench.rs:344-357``); filters use an 80/20
insert/held-out split capped at 1 M keys with measured FPR + bits/key.
"""

from __future__ import annotations

import sys

import jax
import numpy as np

from stringwars_tpu.ops import filters as FLT
from stringwars_tpu.ops import hash as H
from stringwars_tpu.suites._common import SuiteContext, chained_layouts, setup_suite
from stringwars_tpu.tape import PaddedTokens, Tape
from stringwars_tpu.utils.harness import WorkUnits
from stringwars_tpu.utils.report import report_skip

MULTISEED_SEEDS = tuple(range(1, 17))  # 16 fixed seeds (reference uses 16 odd)


def verify_multiseed_matches_naive(layout) -> None:
    """Startup conformance assertion (reference ``containers/bench.rs:344-357``)."""
    seeds = np.asarray(MULTISEED_SEEDS[:8], np.uint64)
    multi = H.xxh64_multiseed(layout, seeds).to_numpy()
    for i, s in enumerate(seeds):
        single = H.xxh64(layout, int(s)).to_numpy()
        assert (multi[i] == single).all(), f"multiseed mismatch at seed {s}"
    print("conformance: multiseed == per-seed for 8 seeds", file=sys.stderr)


def main() -> None:
    ctx = setup_suite(
        "Multiseed hashing + probabilistic filters",
        default_tokens="words",
        default_warmup=2.0,
        default_time=10.0,
    )
    # Unique tokens, capped 1M (reference caps the filter layer at 1M).
    tokens = list(dict.fromkeys(ctx.tape.to_list()))[:1_000_000]
    tape = Tape.from_tokens(tokens)
    layout = jax.block_until_ready(H.prepare(PaddedTokens.from_tape(tape, align=4)))
    total_bytes = tape.total_bytes
    count = len(tokens)
    verify_multiseed_matches_naive(layout)

    ctx.group("multihash")
    for bits in (128, 256, 512, 1024):
        k = bits // 64
        seeds = np.arange(1, k + 1, dtype=np.uint64)
        routine = chained_layouts(
            lambda l, s=seeds: H.xxh64_multiseed(l, s),
            [layout],
            WorkUnits(elements=count * bits, bytes=total_bytes),
        )
        ctx.run(f"multihash/{bits}bit/swtpu::xxh64_multiseed<1chip>", "bits", routine)

        try:
            import xxhash
        except ImportError:
            report_skip(f"multihash/{bits}bit/xxhash.xxh3_128-per-seed", "xxhash not installed")
            continue

        host_tokens = tokens[: max(count // 50, 1)]
        host_bytes = sum(map(len, host_tokens))

        def host_routine() -> WorkUnits:
            for t in host_tokens:
                for s in range(k // 2):
                    xxhash.xxh3_128_intdigest(t, seed=s)
            return WorkUnits(elements=len(host_tokens) * bits, bytes=host_bytes)

        ctx.run(f"multihash/{bits}bit/xxhash.xxh3_128-per-seed", "bits", host_routine)

    ctx.group("filters")
    cut = int(count * 0.8)
    ins_tape = Tape.from_tokens(tokens[:cut])
    out_tape = Tape.from_tokens(tokens[cut:])
    ins_layout = jax.block_until_ready(H.prepare(PaddedTokens.from_tape(ins_tape, align=4)))
    out_layout = jax.block_until_ready(H.prepare(PaddedTokens.from_tape(out_tape, align=4)))
    m_bits = 1 << max(int(np.ceil(np.log2(max(cut * 14, 1024)))), 10)
    seeds7 = tuple(range(1, 8))

    filt = FLT.bloom_build(ins_layout, seeds7, m_bits)
    fpr = float(np.asarray(FLT.bloom_query(filt, out_layout)).mean())
    fn_rate = 1.0 - float(np.asarray(FLT.bloom_query(filt, ins_layout)).mean())
    print(
        f"bloom quality: FPR {100 * fpr:.3f}%, FN {100 * fn_rate:.3f}%, "
        f"{filt.bits_per_key(cut):.1f} bits/key",
        file=sys.stderr,
    )
    assert fn_rate == 0.0, "bloom filters must have zero false negatives"

    # Chained filter rows: the salt XORs the key-words leaf so every
    # iteration builds/probes a different key set.
    ctx.run(
        "filters/swtpu::bloom-build<1chip>",
        "keys",
        chained_layouts(
            lambda l: FLT.bloom_build(l, seeds7, m_bits).words,
            [ins_layout],
            WorkUnits(elements=cut, bytes=ins_tape.total_bytes),
        ),
    )
    ctx.run(
        "filters/swtpu::bloom-query<1chip>",
        "keys",
        chained_layouts(
            lambda l: FLT.bloom_query(filt, l),
            [out_layout],
            WorkUnits(elements=count - cut, bytes=out_tape.total_bytes),
        ),
    )

    ins_keys = H.xxh64(ins_layout).to_numpy()
    out_keys = np.setdiff1d(H.xxh64(out_layout).to_numpy(), ins_keys)
    fuse = FLT.fuse_build(ins_keys)
    fuse_fpr = float(np.asarray(FLT.fuse_query(fuse, out_keys)).mean()) if out_keys.size else 0.0
    print(
        f"binary-fuse quality: FPR {100 * fuse_fpr:.3f}%, "
        f"{fuse.bits_per_key(ins_keys.size):.2f} bits/key",
        file=sys.stderr,
    )

    def fuse_build_routine() -> WorkUnits:
        FLT.fuse_build(ins_keys)
        return WorkUnits(elements=cut, bytes=ins_tape.total_bytes)

    ctx.run("filters/swtpu::fuse8-build(host)", "keys", fuse_build_routine)

    # Chained device query: the staged (h0, h1, h2, fp) probes roll by the
    # carried salt so no dispatch repeats (the hash staging is host-side
    # and excluded, as in the reference's query loop).
    import jax.numpy as jnp

    from stringwars_tpu.utils.harness import DeviceRoutine, fold_salt

    h_np, fp_np = FLT._fuse_hashes(
        np.asarray(out_keys, np.uint64), fuse.seed, fuse.segment_length, fuse.segment_count_length
    )
    probes = tuple(jnp.asarray(h_np[i]) for i in range(3)) + (jnp.asarray(fp_np),)

    def fuse_q_body(s, e, table, h0, h1, h2, fp):
        shift = (s % jnp.uint32(max(h0.shape[0], 1))).astype(jnp.int32)
        got = FLT._fuse_query_dev(
            table, jnp.roll(h0, shift), jnp.roll(h1, shift), jnp.roll(h2, shift), jnp.roll(fp, shift)
        )
        return fold_salt(s, got), e

    ctx.run(
        "filters/swtpu::fuse8-query<1chip>",
        "keys",
        DeviceRoutine(
            body=fuse_q_body,
            consts=(fuse.fingerprints,) + probes,
            units=WorkUnits(elements=max(out_keys.size, 1), bytes=out_tape.total_bytes),
        ),
    )
    ctx.finish()


if __name__ == "__main__":
    main()
