"""Find suite: substring-forward / substring-backward / byteset groups
(reference ``find/bench.rs:350``, defaults 3 s + 20 s, words tokens).

Forward variants count all matches of needles cycled from the token list
over the full haystack per call (reference semantics,
``find/bench.rs:56-93``); backward variants run the distinct rfind
program (count + LAST match offset, ``find/bench.rs:144-219``); bytesets
scan three charsets per call (``find/bench.rs:226-348``), so byteset work
= 3x corpus bytes.

Device paths: the fused shifted-byte compare of ``ops/find`` scans the
corpus once per needle. Every device variant sweeps the available scopes:
``<1chip>`` plus a sharded ``<Nchip>`` row (haystack split on the byte
axis with halos, counts psum-reduced — reference scope sweeps,
``similarities/bench.rs:376-399``).
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from stringwars_tpu.ops import find as F
from stringwars_tpu.ops.ahocorasick import Automaton
from stringwars_tpu.parallel.mesh import SHARD_AXIS, DeviceScope
from stringwars_tpu.parallel.sharding import shard_bytes
from stringwars_tpu.suites._common import SuiteContext, setup_suite
from stringwars_tpu.utils.harness import DeviceRoutine, WorkUnits, fold_salt

BYTESETS = {
    "tabs": b"\n\r\x0b\x0c",
    "html": b"</>&'\"=[]",
    "digits": b"0123456789",
}

def staged_haystack(ctx: SuiteContext, capacity_words: int):
    data = np.asarray(ctx.tape.data)
    n = ctx.tape.total_bytes
    pad_to = n + 4 * capacity_words + 8
    if data.shape[0] < pad_to:
        data = np.pad(data, (0, pad_to - data.shape[0]))
    return jnp.asarray(data), n


def make_sharded_find(scope: DeviceScope, data: np.ndarray, n: int, cap: int, backward: bool = False):
    """Build the <Nchip> all-matches counter: byte-sharded rows with halos,
    per-shard packed compares, psum-reduced counts. The backward program
    additionally pmax-reduces the global last-match offset so the sharded
    row runs the true rfind program (count + LAST offset)."""
    overlap = 8 * cap  # >= 2*(max_m - 1), see _count_from_mask_sharded
    rows, n_glob, chunk = shard_bytes(scope, data[:n], overlap=overlap)
    row_len = chunk + overlap
    max_m = 4 * cap - 3
    n_cmp = row_len - max_m + 1

    def local(rows_blk, words, masks, length):
        needle = F.PackedNeedle(words=words, masks=masks, length=length)
        lo = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32) * chunk
        if backward:
            count, last = F._count_last_from_mask_sharded(
                rows_blk[0], needle, n_cmp, jnp.int32(chunk), lo, jnp.int32(n_glob)
            )
            return jax.lax.psum(count, SHARD_AXIS), jax.lax.pmax(last, SHARD_AXIS)
        count = F._count_from_mask_sharded(
            rows_blk[0], needle, n_cmp, jnp.int32(chunk), lo, jnp.int32(n_glob)
        )
        return jax.lax.psum(count, SHARD_AXIS)

    step = jax.jit(
        shard_map(
            local,
            mesh=scope.mesh,
            in_specs=(P(SHARD_AXIS, None), P(), P(), P()),
            out_specs=(P(), P()) if backward else P(),
            check_vma=False,
        )
    )
    return step, rows


def bench_substring(ctx: SuiteContext, group: str) -> None:
    tokens = [t for t in ctx.tape.to_list() if t]
    if not tokens:
        return
    backward = group == "substring-backward"
    capacity = 16  # sharded rows' bucket; one chip buckets per needle
    usable = tokens  # EVERY token is a needle (reference find/bench.rs:56-93)

    # --- device variants, one row per scope -------------------------------
    for scope in ctx.scopes:
        if scope.chips == 1:
            routine = _single_chip_routine(ctx, usable, capacity, backward)
        else:
            routine = _sharded_routine(ctx, scope, usable, capacity, backward)
        op = "rfind_count" if backward else "find_count"
        ctx.run(f"{group}/swtpu::{op}{scope.name}", "bytes", routine)

    # --- host baseline: bytes.find/rfind loop (all matches, one pass) -----
    n = ctx.tape.total_bytes
    hay_b = np.asarray(ctx.tape.data)[:n].tobytes()
    cycle = itertools.cycle(usable[:512])

    def host_routine() -> WorkUnits:
        needle = next(cycle)
        count = 0
        if backward:
            pos = len(hay_b)
            while True:
                pos = hay_b.rfind(needle, 0, pos + len(needle) - 1)
                if pos < 0:
                    break
                count += 1
        else:
            pos = 0
            while True:
                pos = hay_b.find(needle, pos)
                if pos < 0:
                    break
                count += 1
                pos += 1
        return WorkUnits(elements=max(count, 1), bytes=n)

    name = "bytes.rfind-loop" if backward else "bytes.find-loop"
    ctx.run(f"{group}/{name}", "bytes", host_routine)


def _needle_cap(t: bytes) -> int:
    """Capacity bucket for ANY needle length: power-of-two buckets up to
    505 B, then 64-word-quantized capacities (keeps the jit-program count
    low on long-line corpora)."""
    for cap in (4, 8, 16, 32, 64, 127):
        if len(t) <= 4 * cap - 3:
            return cap
    need = (len(t) + 6) // 4
    return -(-need // 64) * 64


def _single_chip_routine(ctx, usable, capacity, backward):
    max_cap = max(_needle_cap(t) for t in usable[:512])
    hay, n = staged_haystack(ctx, max_cap)
    packed_cycle = itertools.cycle([F.pack_needle(t, _needle_cap(t)) for t in usable[:512]])

    def routine() -> WorkUnits:
        needle = next(packed_cycle)
        if backward:
            count, _last = F.rfind_count(hay, needle, n)
            count = int(count)
        else:
            count = int(F.find_count(hay, needle, n))
        return WorkUnits(elements=max(count, 1), bytes=n)

    return routine


def _sharded_routine(ctx, scope, usable, capacity, backward):
    data = np.asarray(ctx.tape.data)
    n = ctx.tape.total_bytes
    fitting = [t for t in usable if len(t) <= 4 * capacity - 3] or [usable[0][: 4 * capacity - 3]]
    step, rows = make_sharded_find(scope, data, n, capacity, backward)
    packed = [F.pack_needle(t, capacity) for t in fitting[:512]]
    repl = scope.replicated
    staged_cycle = itertools.cycle(
        [
            (
                jax.device_put(np.asarray(p.words), repl),
                jax.device_put(np.asarray(p.masks), repl),
                jax.device_put(np.asarray(p.length), repl),
            )
            for p in packed[:64]
        ]
    )

    def routine() -> WorkUnits:
        words, masks, length = next(staged_cycle)
        if backward:
            count, _last = step(rows, words, masks, length)
            count = int(count)
        else:
            count = int(step(rows, words, masks, length))
        return WorkUnits(elements=max(count, 1), bytes=n)

    return routine


def bench_byteset(ctx: SuiteContext) -> None:
    tables = {name: F.pack_byteset(cs) for name, cs in BYTESETS.items()}
    n = ctx.tape.total_bytes

    for scope in ctx.scopes:
        if scope.chips == 1:
            hay, _ = staged_haystack(ctx, 0)
            tabs = jnp.stack(list(tables.values()))

            def body(s, e, hay_, tabs_):
                # Perturb each membership table with full byte entropy so
                # no two iterations scan for the same set (anti-memoization).
                from stringwars_tpu.utils.harness import perturb_u8

                outs = [
                    F.byteset_count(hay_, tabs_[i] ^ perturb_u8(s), n)
                    for i in range(tabs_.shape[0])
                ]
                return fold_salt(s, *outs), e

            routine = DeviceRoutine(
                body=body, consts=(hay, tabs), units=WorkUnits(elements=1, bytes=3 * n)
            )
        else:
            routine = _sharded_byteset_routine(ctx, scope, tables)
        ctx.run(f"byteset-forward/swtpu::byteset_count{scope.name}", "bytes", routine)

    from stringwars_tpu.ops.ahocorasick import _ac_scan, stage_rows
    from stringwars_tpu.utils.harness import perturb_u8

    automata = {name: Automaton([bytes([c]) for c in cs]) for name, cs in BYTESETS.items()}
    hay_np = np.asarray(ctx.tape.data)[:n]
    staged_acs = []
    flat_ac_consts: list = []
    for a in automata.values():
        rows_dev, gpos0, chunk = stage_rows(hay_np, n, a.max_len)
        staged_acs.append((a, chunk))
        flat_ac_consts += [a.delta_flat, a.out_count, rows_dev, gpos0]

    def ac_body(s, e, *flat):
        outs = []
        for i, (_a, chunk) in enumerate(staged_acs):
            tab, out_c, rows_dev, gpos0 = flat[4 * i : 4 * i + 4]
            outs.append(_ac_scan(tab, out_c, rows_dev ^ perturb_u8(s), gpos0, n, chunk))
        return fold_salt(s, *outs), e

    ctx.run(
        "byteset-forward/swtpu::aho_corasick<1chip>",
        "bytes",
        DeviceRoutine(
            body=ac_body, consts=tuple(flat_ac_consts), units=WorkUnits(elements=1, bytes=3 * n)
        ),
    )

    import re

    hay_b = hay_np.tobytes()
    regexes = {name: re.compile(b"[" + re.escape(cs) + b"]") for name, cs in BYTESETS.items()}

    def re_routine() -> WorkUnits:
        total = sum(len(r.findall(hay_b)) for r in regexes.values())
        return WorkUnits(elements=max(total, 1), bytes=3 * n)

    ctx.run("byteset-forward/re.findall", "bytes", re_routine)


def _sharded_byteset_routine(ctx, scope: DeviceScope, tables):
    data = np.asarray(ctx.tape.data)
    n = ctx.tape.total_bytes
    rows, n_glob, chunk = shard_bytes(scope, data[:n], overlap=0)

    def local(rows_blk, table):
        lo = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32) * chunk
        count = F.byteset_count_bounded(rows_blk[0], table, chunk, lo, jnp.int32(n_glob))
        return jax.lax.psum(count, SHARD_AXIS)

    step = jax.jit(
        shard_map(
            local,
            mesh=scope.mesh,
            in_specs=(P(SHARD_AXIS, None), P()),
            out_specs=P(),
            check_vma=False,
        )
    )
    repl_tables = [jax.device_put(np.asarray(t), scope.replicated) for t in tables.values()]

    def routine() -> WorkUnits:
        total = 0
        for table in repl_tables:
            total += int(step(rows, table))
        return WorkUnits(elements=max(total, 1), bytes=3 * n)

    return routine


def main() -> None:
    ctx = setup_suite(
        "Substring and byteset search throughput",
        default_tokens="words",
        default_warmup=3.0,
        default_time=20.0,
    )
    ctx.group("substring-forward")
    bench_substring(ctx, "substring-forward")
    ctx.group("substring-backward")
    bench_substring(ctx, "substring-backward")
    ctx.group("byteset-forward")
    bench_byteset(ctx)
    ctx.finish()


if __name__ == "__main__":
    main()
