"""Sequence suite: stable argsort, byte order and case-folded order
(reference ``sequence/bench.rs``, defaults 5 s + 10 s, words tokens;
work metric = n*log2(n) comparisons, ``sequence/bench.rs:79``).

Device rows run through the chained-loop protocol: each iteration XORs
the staged key columns (byte order) or rolls the token rows (uncased —
XOR would corrupt UTF-8) with the carried salt, so no iteration sorts the
same keys. A salt-positioned slice of the permutation folds back into the
salt. The host tie-refinement pass (rows tying on a
maxed-out 96-byte prefix; rare on word corpora) stays outside the
chained region and is covered by the full-pipeline conformance tests.
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp

from stringwars_tpu.ops.sort import (
    _byte_columns,
    _clamp_utf8_boundary,
    _lsd_argsort,
    _uncased_order,
    argsort_tape,
)
from stringwars_tpu.suites._common import setup_suite
from stringwars_tpu.tape import PaddedTokens
from stringwars_tpu.utils.harness import (
    DeviceRoutine,
    WorkUnits,
    device_routine_factory,
    fold_salt,
)


def main() -> None:
    ctx = setup_suite(
        "Stable string argsort throughput",
        default_tokens="words",
        default_warmup=5.0,
        default_time=10.0,
    )
    count = ctx.tape.count
    comparisons = int(count * math.log2(max(count, 2)))
    total = ctx.tape.total_bytes

    ctx.group("argsort")
    # The full pipeline (device 96-byte radix prefix + host tie refinement
    # + caller-owned ``out=`` buffer, reference zero-alloc discipline
    # sequence/bench.py:212-232) runs once as a conformance exercise; the
    # measured row is the chained device sort.
    out_buf = np.empty(count, dtype=np.intp)
    argsort_tape(ctx.tape, prefix_width=96, out=out_buf)

    def byte_order_routine():
        tokens = PaddedTokens.from_tape(ctx.tape, align=4, max_width=96)
        cols = jax.block_until_ready(_byte_columns(tokens.data, tokens.lengths))
        B = cols.shape[1]
        span = min(4096, B)

        def body(s, e, c):
            perm = _lsd_argsort(c ^ s)
            start = (s % jnp.uint32(max(B - span, 1))).astype(jnp.int32)
            probe = jax.lax.dynamic_slice(perm, (start,), (span,))
            return fold_salt(s, probe), e

        return DeviceRoutine(
            body=body, consts=(cols,), units=WorkUnits(comparisons, total)
        )

    ctx.run(
        "argsort/swtpu::argsort<1chip>",
        "comparisons",
        device_routine_factory(byte_order_routine),
    )

    # Distributed sample sort over the mesh (ops/sort.argsort_sharded):
    # splitter partition + all_to_all + per-shard LSD radix. Only appears
    # when the scope spans >1 device.
    from stringwars_tpu.ops.sort import argsort_sharded

    for scope in ctx.scopes:
        if scope.chips <= 1:
            continue

        def sharded_routine(scope=scope) -> WorkUnits:
            argsort_sharded(ctx.tape, scope, prefix_width=96, out=out_buf)
            return WorkUnits(elements=comparisons, bytes=total)

        ctx.run(
            f"argsort/swtpu::argsort{scope.name}", "comparisons", sharded_routine
        )

    token_list = ctx.tape.to_list()

    def host_sorted() -> WorkUnits:
        sorted(range(len(token_list)), key=token_list.__getitem__)
        return WorkUnits(elements=comparisons, bytes=total)

    ctx.run("argsort/sorted-key", "comparisons", host_sorted)

    arr = np.array(token_list, dtype=object)

    def np_routine() -> WorkUnits:
        np.argsort(arr, kind="stable")
        return WorkUnits(elements=comparisons, bytes=total)

    ctx.run("argsort/numpy.argsort", "comparisons", np_routine)

    ctx.group("argsort-uncased")

    def uncased_routine():
        tokens = PaddedTokens.from_tape(ctx.tape, align=4, max_width=96)
        data_np = np.asarray(tokens.data)
        key_lengths = _clamp_utf8_boundary(
            data_np, np.asarray(tokens.lengths).astype(np.int64), tokens.width
        )
        d = jax.device_put(tokens.data)
        ln = jax.device_put(jnp.asarray(key_lengths))
        n_cols = (tokens.width + 2) // 3
        B = data_np.shape[0]
        span = min(4096, B)

        def body(s, e, d_, ln_):
            shift = (s % jnp.uint32(B)).astype(jnp.int32)
            order, counts = _uncased_order(
                jnp.roll(d_, shift, axis=0), jnp.roll(ln_, shift), n_cols, True
            )
            start = (s % jnp.uint32(max(B - span, 1))).astype(jnp.int32)
            probe = jax.lax.dynamic_slice(order, (start,), (span,))
            return fold_salt(s, probe, counts[:64]), e

        return DeviceRoutine(
            body=body, consts=(d, ln), units=WorkUnits(comparisons, total)
        )

    ctx.run(
        "argsort-uncased/swtpu::argsort_uncased<1chip>",
        "comparisons",
        device_routine_factory(uncased_routine),
    )

    def host_uncased() -> WorkUnits:
        sorted(token_list, key=lambda b: b.decode("utf-8", "ignore").casefold())
        return WorkUnits(elements=comparisons, bytes=total)

    ctx.run("argsort-uncased/sorted-casefold", "comparisons", host_uncased)
    ctx.finish()


if __name__ == "__main__":
    main()
