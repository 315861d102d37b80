"""Memory suite: lookup-table / generate-random / memset / memcpy / memmove
(reference ``memory/bench.rs:110-396``, defaults 1 s + 20 s, lines tokens).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from stringwars_tpu.ops import memops as M
from stringwars_tpu.suites._common import setup_suite
from stringwars_tpu.utils.harness import DeviceRoutine, WorkUnits, fold_salt, perturb_u8, sync


def main() -> None:
    ctx = setup_suite(
        "Memory-ops throughput (LUT, PRNG fill, set/copy/move)",
        default_tokens="lines",
        default_warmup=1.0,
        default_time=20.0,
        default_synthetic="long-lines",
    )
    n = ctx.tape.total_bytes
    data = jnp.asarray(np.asarray(ctx.tape.data)[:n])
    lut = jnp.asarray(M.invert_case_lut())

    # Byte-sharded copies per scope (reference scope sweeps; these ops are
    # elementwise so pjit partitions them with zero communication — the
    # <Nchip> rows measure pure per-chip-bandwidth scaling).
    def staged_for(scope):
        if scope.chips == 1:
            return data, n
        from jax.sharding import PartitionSpec as P

        from stringwars_tpu.parallel.mesh import SHARD_AXIS

        pad = (-n) % scope.chips
        arr = np.asarray(ctx.tape.data)[:n]
        if pad:
            arr = np.pad(arr, (0, pad))
        return jax.device_put(arr, scope.sharding(P(SHARD_AXIS))), n + pad

    ctx.group("lookup-table")

    # Buffer-chained LUT rows: each iteration translates the PREVIOUS
    # output, so no loop step repeats and the full buffer is a live loop
    # carry.
    def lut_routine(fn, sdata, sn):
        def body(s, e, table):
            return s + jnp.uint32(1), fn(e, table)

        return DeviceRoutine(body=body, consts=(lut,), units=WorkUnits(1, sn), extra0=sdata)

    for scope in ctx.scopes:
        sdata, sn = staged_for(scope)
        ctx.run(
            f"lookup-table/swtpu::lut_translate{scope.name}",
            "bytes",
            lut_routine(M.lut_translate, sdata, sn),
        )
    host = np.asarray(data).tobytes()
    lut_b = M.invert_case_lut().tobytes()
    ctx.run(
        "lookup-table/bytes.translate",
        "bytes",
        lambda: (host.translate(lut_b), WorkUnits(1, n))[1],
    )
    arr = np.frombuffer(host, np.uint8)
    lut_np = M.invert_case_lut()
    ctx.run(
        "lookup-table/numpy.take",
        "bytes",
        lambda: (lut_np[arr], WorkUnits(1, n))[1],
    )

    ctx.group("generate-random")

    def rand_body(s, e):
        out = M.fill_random_words(s, n)
        pick = (s % jnp.uint32(out.shape[0] - 1)).astype(jnp.int32)
        return fold_salt(s, jax.lax.dynamic_slice(out, (pick,), (1,))), e

    ctx.run(
        "generate-random/swtpu::fill_random<1chip>",
        "bytes",
        DeviceRoutine(body=rand_body, consts=(), units=WorkUnits(1, n)),
    )
    host_rng = np.random.default_rng(42)
    ctx.run(
        "generate-random/numpy.PCG64",
        "bytes",
        lambda: (host_rng.integers(0, 256, n, dtype=np.uint8), WorkUnits(1, n))[1],
    )

    ctx.group("memset")
    fill = jax.jit(M.fill, static_argnames=("n",))
    seed_box = [0]

    def memset_routine() -> WorkUnits:
        # A write-only op has no XLA-legal chained consumer (any read adds
        # a pass that isn't memset); vary the value per call so at least
        # no dispatch repeats. Wall-time loop; dispatch floor applies.
        seed_box[0] += 1
        sync(fill(n, seed_box[0] & 0xFF))
        return WorkUnits(1, n)

    ctx.run("memset/swtpu::fill<1chip>", "bytes", memset_routine)

    ctx.group("memcpy")

    # Chained copy: out = in ^ salt-byte is byte-for-byte memcpy traffic
    # (one read + one write, single fused flop) that cannot be copy-elided
    # across iterations the way a literal device copy would be.
    def copy_routine(sdata, sn):
        def body(s, e):
            return s + jnp.uint32(1), e ^ perturb_u8(s)

        return DeviceRoutine(body=body, consts=(), units=WorkUnits(1, sn), extra0=sdata)

    for scope in ctx.scopes:
        sdata, sn = staged_for(scope)
        ctx.run(f"memcpy/swtpu::copy{scope.name}", "bytes", copy_routine(sdata, sn))

    ctx.group("memmove")

    def move_body(s, e):
        return s + jnp.uint32(1), jnp.roll(e, 8) ^ perturb_u8(s)

    ctx.run(
        "memmove/swtpu::move<1chip>",
        "bytes",
        DeviceRoutine(body=move_body, consts=(), units=WorkUnits(1, n), extra0=data),
    )
    ctx.finish()


if __name__ == "__main__":
    main()
