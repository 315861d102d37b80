"""Fingerprints suite: MinHash over multi-scale n-grams, NDIM sweep
(reference ``fingerprints/bench.rs:234-660``, defaults 1 s + 30 s, lines).

Sweeps ``SWTPU_NDIM`` or ``SWTPU_NDIM_SCALES`` (default 64,128,256,512 like
the reference ``fingerprints/bench.rs:253-266``); work = NDIM hash-ops per
token byte; quality (bit entropy, collision rate) printed per scale.
"""

from __future__ import annotations

import sys

import jax
import numpy as np

from stringwars_tpu.ops import fingerprint as FP
from stringwars_tpu.suites._common import setup_suite
from stringwars_tpu.tape import PaddedTokens
from stringwars_tpu.utils.config import get_env, get_env_parsed
from stringwars_tpu.utils.harness import WorkUnits, sync


def ndim_scales() -> list[int]:
    single = get_env("NDIM")
    if single:
        return [int(single)]
    scales = get_env("NDIM_SCALES")
    if scales:
        return [int(s) for s in scales.split(",")]
    return [64, 128, 256, 512]


def main() -> None:
    ctx = setup_suite(
        "MinHash fingerprint throughput + quality",
        default_tokens="lines",
        default_warmup=1.0,
        default_time=30.0,
        default_synthetic="long-lines",
    )
    batch = min(ctx.scopes[-1].auto_batch_size(default_base=256), ctx.tape.count)
    sub = ctx.tape.subtape(0, batch)
    tokens = PaddedTokens.from_tape(sub, max_width=4096)
    total_bytes = int(np.asarray(tokens.lengths).sum())

    for ndim in ndim_scales():
        ctx.group(f"minhash/ndim_{ndim}")
        fn = jax.jit(lambda t, d=ndim: FP.fingerprint(t, ndim=d))

        # One row per scope (reference 1cpu/Ncpu/1gpu sweep,
        # fingerprints/bench.rs:342-371): docs are batch-parallel, so the
        # <Nchip> row shards the token batch on the leading axis and lets
        # the partitioner run each shard's fingerprints locally.
        for scope in ctx.scopes:
            if scope.chips == 1:
                staged = tokens
            else:
                from jax.sharding import PartitionSpec as P

                from stringwars_tpu.parallel.mesh import SHARD_AXIS

                B = int(np.asarray(tokens.lengths).shape[0])
                Bp = -(-B // scope.chips) * scope.chips
                data = np.asarray(tokens.data)
                lengths = np.asarray(tokens.lengths)
                if Bp != B:
                    data = np.pad(data, ((0, Bp - B), (0, 0)))
                    lengths = np.pad(lengths, (0, Bp - B))
                staged = PaddedTokens(
                    data=jax.device_put(data, scope.sharding(P(SHARD_AXIS, None))),
                    lengths=jax.device_put(lengths, scope.data_sharding),
                    width=tokens.width,
                )

            def routine(staged=staged) -> WorkUnits:
                sync(fn(staged))
                return WorkUnits(elements=ndim * total_bytes, bytes=total_bytes)

            ctx.run(f"minhash/ndim_{ndim}/swtpu::fingerprint{scope.name}", "hashes", routine)

        mh, _ = fn(tokens)
        mh_np = np.asarray(mh)
        print(
            f"quality ndim_{ndim}: bit-entropy {FP.bit_entropy(mh_np):.4f}, "
            f"collisions {100.0 * FP.collision_rate(mh_np):.2f}%",
            file=sys.stderr,
        )

        # Host baseline: numpy replay of the same spec on a token sample.
        sample = sub.to_list()[:8]
        sample_bytes = sum(map(len, sample))

        def host_routine() -> WorkUnits:
            for t in sample:
                FP.fingerprint_ref(t, ndim=min(ndim, 16))
            return WorkUnits(elements=min(ndim, 16) * sample_bytes, bytes=sample_bytes)

        ctx.run(f"minhash/ndim_{ndim}/numpy-replay", "hashes", host_routine)
    ctx.finish()


if __name__ == "__main__":
    main()
