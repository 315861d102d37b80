"""Hash suite: stateless / stateful / checksum groups (reference
``hash/bench.rs:483``, ``hash/bench.py:236``; defaults: words tokens,
2 s warm-up + 10 s measure).

Device variants (library ``swtpu``) hash every token of the corpus per call,
bucketed by length into rectangular layouts; host baselines (xxhash C lib,
CPython builtins) run the same corpus item-at-a-time under the same
deadline pacing as the reference's Python suite.
"""

from __future__ import annotations

import functools
import sys

import jax
import numpy as np

from stringwars_tpu.ops import hash as H
from stringwars_tpu.parallel.mesh import DeviceScope
from stringwars_tpu.suites._common import SuiteContext, chained_layouts, setup_suite
from stringwars_tpu.tape import PaddedTokens, Tape, bucket_by_length
from stringwars_tpu.utils.config import get_env_bool, should_run
from stringwars_tpu.utils.harness import (
    DeviceRoutine,
    WorkUnits,
    device_routine_factory,
    fold_salt,
    now_ns,
    paced_items,
    perturb_u8,
)
from stringwars_tpu.utils.report import report_skip

BUCKET_EDGES = [16, 64, 256, 1024, 4096]


def build_layouts(tape: Tape, scope: DeviceScope) -> list[tuple[H.HashLayout, int, int]]:
    """Bucket the tape by token length and stage sharded hash layouts.

    Returns (layout, token_count, token_bytes) per non-empty bucket; batch
    is padded to the mesh size with zero-length tokens so the leading axis
    shards evenly.
    """
    out = []
    for bucket in bucket_by_length(tape, BUCKET_EDGES):
        count = bucket.count
        total = int(np.asarray(bucket.lengths).sum())
        chips = scope.chips
        padded = ((count + chips - 1) // chips) * chips
        data = np.asarray(bucket.data)
        lengths = np.asarray(bucket.lengths)
        if padded != count:
            data = np.pad(data, ((0, padded - count), (0, 0)))
            lengths = np.pad(lengths, (0, padded - count))
        tokens = PaddedTokens(
            data=jax.device_put(data, scope.sharding(jax.sharding.PartitionSpec("shard", None))),
            lengths=jax.device_put(lengths, scope.data_sharding),
            width=bucket.width,
        )
        layout = jax.block_until_ready(H.prepare(tokens))
        out.append((layout, count, total))
    return out


def bench_device_hash(ctx: SuiteContext, group: str, fn, fn_name: str, layouts_for) -> None:
    for scope in ctx.scopes:
        try:
            layouts = layouts_for(scope)
        except Exception as error:  # noqa: BLE001 — the suite reports it
            ctx.fail(f"{group}/swtpu::{fn_name}{scope.name}", error)
            continue
        elements = sum(c for _, c, _ in layouts)
        total_bytes = sum(b for _, _, b in layouts)
        routine = chained_layouts(
            fn, [layout for layout, _, _ in layouts], WorkUnits(elements, total_bytes)
        )
        ctx.run(f"{group}/swtpu::{fn_name}{scope.name}", "bytes", routine)


def bench_device_xxh3(ctx: SuiteContext) -> None:
    """XXH3-64 (exact) over bucketed layouts — the reference's headline hash."""
    from stringwars_tpu.ops import xxh3 as X3

    for scope in ctx.scopes:
        layouts = []
        elements = 0
        total_bytes = 0
        try:
            for bucket in bucket_by_length(ctx.tape, BUCKET_EDGES):
                layouts.append(jax.block_until_ready(X3.prepare3(bucket)))
                elements += bucket.count
                total_bytes += int(np.asarray(bucket.lengths).sum())
        except Exception as error:  # noqa: BLE001 — the suite reports it
            ctx.fail(f"stateless/swtpu::xxh3_64{scope.name}", error)
            continue
        routine = chained_layouts(X3.xxh3_64, layouts, WorkUnits(elements, total_bytes))
        ctx.run(f"stateless/swtpu::xxh3_64{scope.name}", "bytes", routine)


def bench_host_hash(ctx: SuiteContext, name: str, package: str, attr: str, tokens: list) -> None:
    """Host baseline row over ``package.attr``; skips when the package is
    not installed."""
    import importlib

    try:
        module = importlib.import_module(package)
    except ImportError:
        report_skip(name, f"{package} not installed")
        return
    hash_fn = getattr(module, attr)

    def routine() -> WorkUnits:
        deadline = now_ns() + int(ctx.budget.time_seconds * 1e9)
        done = 0
        done_bytes = 0
        for token in paced_items(tokens, deadline):
            hash_fn(token)
            done += 1
            done_bytes += len(token)
        return WorkUnits(elements=done, bytes=done_bytes)

    ctx.run(name, "bytes", routine)


def report_collisions(ctx: SuiteContext) -> None:
    """Opt-in collision audit (reference ``hash/bench.rs:129-167``): count
    distinct xxh64 digests against the unique-token count, to stderr."""
    layouts = build_layouts(ctx.tape, ctx.scopes[0])
    digests = np.concatenate([H.xxh64(lay).to_numpy()[:count] for lay, count, _ in layouts])
    unique_tokens = len(set(ctx.tape.to_list()))
    unique_hashes = len(np.unique(digests))
    collisions = unique_tokens - unique_hashes
    print(
        f"collisions: {collisions:,} over {unique_tokens:,} unique tokens "
        f"({100.0 * collisions / max(unique_tokens, 1):.4f}%)",
        file=sys.stderr,
        flush=True,
    )


def main() -> None:
    ctx = setup_suite(
        "Hash throughput suite (device kernels + host baselines)",
        default_tokens="words",
        default_warmup=2.0,
        default_time=10.0,
    )
    ctx.group("stateless")
    # Every stateless row hashes the same staged layouts: stage once per scope.
    staged: dict[int, list] = {}

    def layouts_for(scope: DeviceScope) -> list:
        if scope.chips not in staged:
            staged[scope.chips] = build_layouts(ctx.tape, scope)
        return staged[scope.chips]

    bench_device_hash(ctx, "stateless", lambda l: H.swh64(l, 0), "swh64", layouts_for)
    bench_device_hash(ctx, "stateless", H.xxh64, "xxh64", layouts_for)
    bench_device_hash(ctx, "stateless", H.xxh32, "xxh32", layouts_for)
    bench_device_xxh3(ctx)
    bench_device_hash(
        ctx,
        "stateless",
        functools.partial(H.swh64_multiseed, seeds=np.arange(8, dtype=np.uint64)),
        "swh64_multiseed8",
        layouts_for,
    )
    host_rows = (
        ("stateless/xxhash.xxh3_64", "xxhash", "xxh3_64_intdigest"),
        ("stateless/xxhash.xxh64", "xxhash", "xxh64_intdigest"),
        ("stateless/builtins.hash", "builtins", "hash"),
    )
    if any(should_run(name, ctx.pattern) for name, _, _ in host_rows):
        tokens = ctx.tape.to_list()
        for name, package, attr in host_rows:
            bench_host_hash(ctx, name, package, attr, tokens)

    ctx.group("stateful")
    corpus = ctx.tape.data
    n = ctx.tape.total_bytes
    corpus_dev = jax.device_put(np.asarray(corpus))

    def tree_body(s, e, buf):
        # Level-0 digests carry >99.9% of the tree-hash work (upper levels
        # re-hash a 1/8192 tape); the host-side level fold is untraceable.
        digests = H._tree_level(buf ^ perturb_u8(s), n)
        return fold_salt(s, digests), e

    ctx.run(
        "stateful/swtpu::tree_hash64<1chip>",
        "bytes",
        DeviceRoutine(body=tree_body, consts=(corpus_dev,), units=WorkUnits(elements=1, bytes=n)),
    )

    try:
        import xxhash
    except ImportError:
        report_skip("stateful/xxhash.xxh64_stream", "xxhash not installed")
    else:

        def host_stream() -> WorkUnits:
            hasher = xxhash.xxh64()
            hasher.update(np.asarray(corpus)[:n].tobytes())
            hasher.intdigest()
            return WorkUnits(elements=1, bytes=n)

        ctx.run("stateful/xxhash.xxh64_stream", "bytes", host_stream)

    ctx.group("checksum")
    # u32-word staging: the reduce pair-sums bytes inside each word.
    from stringwars_tpu.ops.bytesum import _bytesum_words_parts, _word_chunk_shape

    rows, lanes = _word_chunk_shape(max((n + 3) // 4, 1))
    wbuf = np.zeros(rows * lanes * 4, np.uint8)
    wbuf[:n] = np.asarray(ctx.tape.data[:n])
    words_dev = jax.device_put(np.ascontiguousarray(wbuf.view("<u4")))

    def bytesum_body(s, e, words):
        hi, lo = _bytesum_words_parts(words ^ s, n)
        return fold_salt(s, hi, lo), e

    ctx.run(
        "checksum/swtpu::bytesum<1chip>",
        "bytes",
        DeviceRoutine(
            body=bytesum_body, consts=(words_dev,), units=WorkUnits(elements=1, bytes=n)
        ),
    )

    # Device SHA-256: per-token digests over bucketed layouts (reference
    # hashes one token per call, hash/bench.rs:298-389).
    from stringwars_tpu.ops.sha256 import prepare_sha256, sha256

    def make_sha_routine():
        sha_layouts = []
        sha_elements = 0
        sha_bytes = 0
        for bucket in bucket_by_length(ctx.tape, BUCKET_EDGES):
            sha_layouts.append(jax.block_until_ready(prepare_sha256(bucket)))
            sha_elements += bucket.count
            sha_bytes += int(np.asarray(bucket.lengths).sum())
        return chained_layouts(sha256, sha_layouts, WorkUnits(sha_elements, sha_bytes))

    ctx.run(
        "checksum/swtpu::sha256<1chip>", "bytes", device_routine_factory(make_sha_routine)
    )

    import hashlib
    import zlib

    host_bytes = np.asarray(corpus)[:n].tobytes()
    ctx.run(
        "checksum/zlib.crc32",
        "bytes",
        lambda: (zlib.crc32(host_bytes), WorkUnits(elements=1, bytes=n))[1],
    )
    ctx.run(
        "checksum/hashlib.sha256",
        "bytes",
        lambda: (hashlib.sha256(host_bytes).digest(), WorkUnits(elements=1, bytes=n))[1],
    )

    if get_env_bool("COLLISIONS"):
        report_collisions(ctx)
    ctx.finish()


if __name__ == "__main__":
    main()
