"""Similarities suite: uniform / linear / affine gap-cost groups over dense
query x candidate cross-products (reference ``similarities/bench.rs:269-1026``,
defaults 5 s + 30 s, words tokens on DNA-style corpora).

Workload shape mirrors the reference: ``side = round(sqrt(batch))`` queries
vs candidates from disjoint token slices, every (q, c) pair scored per call,
CUPS = sum(|q|) * sum(|c|) cells per pass (``similarities/bench.rs:113-118,
216-224``). The uniform group includes the UTF-8 codepoint variant
(``LevenshteinDistancesUtf8``, ``similarities/bench.rs:230-247``) and — when
``SWTPU_ERROR_BOUND`` is set — the banded variant (reference
``STRINGWARS_ERROR_BOUND``, ``README.md:311``).

Engines: the uniform distances run the bit-parallel Myers kernel
(``ops/myers_pallas``, Pallas through Triton on the GPU); the gap-cost
scores run the anti-diagonal wavefront (``ops/similarity``). Device rows
sweep ``<1chip>`` plus a sharded ``<Nchip>`` scope (pair batch split on the
leading axis, scores computed per shard — the reference's 1cpu/Ncpu/1gpu
sweep, ``similarities/bench.rs:376-399``).
"""

from __future__ import annotations

import functools
import math
import sys

import jax
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from stringwars_tpu.ops import similarity as S
from stringwars_tpu.ops.myers_pallas import _myers, myers_from_codepoints, myers_from_tokens
from stringwars_tpu.ops.utf8 import decode_codepoints
from stringwars_tpu.parallel.mesh import SHARD_AXIS, DeviceScope
from stringwars_tpu.suites._common import SuiteContext, setup_suite
from stringwars_tpu.utils.config import get_env_parsed
from stringwars_tpu.utils.harness import WorkUnits, sync


def build_crossproduct(ctx: SuiteContext, max_side: int = 64, max_len: int = 256):
    tokens = [t for t in ctx.tape.to_list() if t][: 2 * max_side * max_side]
    tokens = [t[:max_len] for t in tokens]
    side = int(math.sqrt(max(len(tokens) // 2, 1)))
    side = min(side, max_side)
    if side < 1:
        raise ValueError("not enough tokens for a cross-product")
    queries = tokens[:side]
    candidates = tokens[side : 2 * side]
    pairs_a, pairs_b = [], []
    for q in queries:
        for c in candidates:
            pairs_a.append(q)
            pairs_b.append(c)
    batch = S.pack_pairs(pairs_a, pairs_b)
    cells = sum(len(q) for q in queries) * sum(len(c) for c in candidates)
    total_bytes = sum(map(len, pairs_a)) + sum(map(len, pairs_b))
    return batch, cells, total_bytes, queries, candidates, pairs_a, pairs_b


def make_sharded_scorer(scope: DeviceScope, batch: S.PairBatch, fn):
    """Shard the pair batch on the leading axis; scores stay sharded."""
    B = batch.a.shape[0]
    chips = scope.chips
    Bp = -(-B // chips) * chips

    def pad(x):
        widths = [(0, Bp - B)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), widths)

    sharded = S.PairBatch(
        a=jax.device_put(pad(batch.a), scope.sharding(P(SHARD_AXIS, None))),
        b=jax.device_put(pad(batch.b), scope.sharding(P(SHARD_AXIS, None))),
        a_len=jax.device_put(pad(batch.a_len), scope.data_sharding),
        b_len=jax.device_put(pad(batch.b_len), scope.data_sharding),
    )
    spec = (P(SHARD_AXIS, None), P(SHARD_AXIS, None), P(SHARD_AXIS), P(SHARD_AXIS))

    def local(a, b, a_len, b_len):
        return fn(S.PairBatch(a=a, b=b, a_len=a_len, b_len=b_len))

    step = jax.jit(
        shard_map(local, mesh=scope.mesh, in_specs=spec, out_specs=P(SHARD_AXIS), check_vma=False)
    )
    return lambda: step(sharded.a, sharded.b, sharded.a_len, sharded.b_len)


def shard_blocks(scope: DeviceScope, arrays):
    """Pad the leading (pair-block) axis to a multiple of the mesh and
    shard it. Zero-padded blocks are inert: empty pairs score 0."""
    n_blk = arrays[0].shape[0]
    pad_blk = -(-n_blk // scope.chips) * scope.chips
    out = []
    for x in arrays:
        xn = np.asarray(x)
        if pad_blk != n_blk:
            xn = np.pad(xn, [(0, pad_blk - n_blk)] + [(0, 0)] * (xn.ndim - 1))
        spec = P(SHARD_AXIS, *([None] * (xn.ndim - 1)))
        out.append(jax.device_put(xn, scope.sharding(spec)))
    return out


def myers_scorer(scope: DeviceScope, mb, *, interpret: bool = False):
    """Zero-arg callable running the Myers kernel over a staged batch; on
    a multi-device scope the pair blocks are split across devices."""
    statics = mb.statics()
    run = functools.partial(_myers, **statics, interpret=interpret)
    if scope.chips == 1:
        arrays = mb.arrays()
        return lambda: run(*arrays)
    arrays = shard_blocks(scope, mb.arrays())
    step = jax.jit(
        shard_map(
            run,
            mesh=scope.mesh,
            in_specs=(P(SHARD_AXIS, None),) * len(arrays),
            out_specs=P(SHARD_AXIS, None),
            check_vma=False,
        )
    )
    return lambda: step(*arrays)


def run_engine(ctx, name, cells, total_bytes, scorers):
    """One engine row per scope; ``scorers(scope)`` returns the zero-arg
    device call for that scope."""
    for scope in ctx.scopes:
        call = scorers(scope)
        routine = lambda call=call: (sync(call()), WorkUnits(cells, total_bytes))[1]
        ctx.run(f"{name}{scope.name}", "cups", routine)


def wavefront_scorers(batch, fn):
    def scorer(scope):
        if scope.chips == 1:
            return lambda: fn(batch)
        return make_sharded_scorer(scope, batch, fn)

    return scorer


def main() -> None:
    ctx = setup_suite(
        "Edit distances / alignment scores (wavefront DP engines)",
        default_tokens="lines",
        default_warmup=5.0,
        default_time=30.0,
        default_synthetic="dna-100b",
    )
    try:
        batch, cells, total_bytes, queries, candidates, pairs_a, pairs_b = build_crossproduct(ctx)
    except ValueError as error:
        ctx.fail("similarities/swtpu::*", error)
        ctx.finish()

    print(
        f"cross-product {len(queries)}x{len(candidates)} pairs, width {batch.width}, "
        f"{cells:,} cells/pass",
        file=sys.stderr,
    )

    ctx.group("uniform")
    mb = myers_from_tokens(pairs_a, pairs_b)
    run_engine(
        ctx, "uniform/swtpu::levenshtein", cells, total_bytes,
        lambda scope: myers_scorer(scope, mb),
    )

    # UTF-8 codepoint distances (cells = codepoint cells).
    a_cps = [decode_codepoints(t) for t in pairs_a]
    b_cps = [decode_codepoints(t) for t in pairs_b]
    cells_u = sum(len(x) * len(y) for x, y in zip(a_cps, b_cps))
    mbu = myers_from_codepoints(a_cps, b_cps)
    ctx.run(
        "uniform-utf8/swtpu::levenshtein<1chip>",
        "cups",
        lambda: (sync(myers_scorer(ctx.scopes[0], mbu)()), WorkUnits(cells_u, total_bytes))[1],
    )

    # Banded variant, active when SWTPU_ERROR_BOUND is set (reference
    # STRINGWARS_ERROR_BOUND semantics).
    bound = get_env_parsed("ERROR_BOUND", 0)
    if bound > 0:
        band = int(bound)
        ctx.run(
            f"uniform-banded{band}/swtpu::levenshtein<1chip>",
            "cups",
            lambda: (sync(S.levenshtein_banded(batch, band)), WorkUnits(cells, total_bytes))[1],
        )

    # Host baseline: stdlib-ish DP on the diagonal only (reference baselines
    # run one pair per call on the diagonal, similarities/bench.rs:746-753).
    diag = [(q, c) for q, c in zip(queries, candidates)]
    diag_cells = sum(len(q) * len(c) for q, c in diag)
    diag_bytes = sum(len(q) + len(c) for q, c in diag)

    def host_routine() -> WorkUnits:
        for q, c in diag:
            S.levenshtein_ref(q, c)
        return WorkUnits(diag_cells, diag_bytes)

    ctx.run("uniform/python-dp-diagonal", "cups", host_routine)

    ctx.group("linear")
    run_engine(ctx, "linear/swtpu::needleman_wunsch", cells, total_bytes,
               wavefront_scorers(batch, S.nw_score_linear))
    run_engine(ctx, "linear/swtpu::smith_waterman", cells, total_bytes,
               wavefront_scorers(batch, S.sw_score_linear))

    ctx.group("affine")
    run_engine(ctx, "affine/swtpu::needleman_wunsch", cells, total_bytes,
               wavefront_scorers(batch, S.nw_score_affine))
    run_engine(ctx, "affine/swtpu::smith_waterman", cells, total_bytes,
               wavefront_scorers(batch, S.sw_score_affine))
    ctx.finish()


if __name__ == "__main__":
    main()
