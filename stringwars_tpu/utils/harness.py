"""Measurement harness (layer L2): wall-time-budgeted device-true throughput.

The device analog of the reference's ``measure_throughput`` (``utils.rs:716-799``)
and pacing generators (``utils.py:74-187``): run a variant closure under a
warm-up budget (uncounted — this is also where every shape-bucket's JIT compile
must happen) and then a measured budget, recording per-call latency samples for
p50/p99. Two rules shape the design:

1. **Device time is the truth.** An XLA dispatch returns before the work is
   done, so the closure must synchronize — ``sync()`` below wraps
   ``block_until_ready`` over any pytree. The measured region is
   host-observed wall-time around synchronized device work, exactly the
   quantity the reference measures around its FFI calls.
2. **Compile time is excluded.** First-call tracing/compilation is hoisted
   into the warm-up phase; the warm-up always runs at least one call even
   with a zero budget so ``SWTPU_TIME=0`` still smoke-runs every variant once
   (the reference's smoke-test contract, ``similarities/bench.py:223-224``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Iterator

import jax
import jax.numpy as jnp

from stringwars_tpu.utils.config import get_env_parsed
from stringwars_tpu.utils.report import BenchStats


def now_ns() -> int:
    return time.monotonic_ns()


def sync(tree) -> None:
    """Force every array in ``tree`` to be computed on its device: wait
    with ``block_until_ready``, then read one element of each leaf back to
    the host, as the end-to-end answer of a row would be."""
    import numpy as np

    jax.block_until_ready(tree)
    for leaf in jax.tree_util.tree_leaves(tree):
        if isinstance(leaf, jax.Array) and leaf.size:
            np.asarray(leaf.ravel()[:1])


@dataclasses.dataclass(frozen=True)
class WorkUnits:
    """Work accomplished by one closure call (reference ``utils.rs:524-545``)."""

    elements: int
    bytes: int

    def __add__(self, other: "WorkUnits") -> "WorkUnits":
        return WorkUnits(self.elements + other.elements, self.bytes + other.bytes)


@dataclasses.dataclass(frozen=True)
class BenchBudget:
    """Warm-up + measured seconds, env-overridable per suite
    (reference ``utils.rs:563-582``; per-suite defaults differ, SURVEY.md §2.1)."""

    warmup_seconds: float
    time_seconds: float

    @classmethod
    def from_env(cls, default_warmup: float, default_time: float) -> "BenchBudget":
        return cls(
            warmup_seconds=get_env_parsed("WARMUP", float(default_warmup)),
            time_seconds=get_env_parsed("TIME", float(default_time)),
        )

    def with_overrides(self, warmup: float | None, time_limit: float | None) -> "BenchBudget":
        return BenchBudget(
            warmup_seconds=self.warmup_seconds if warmup is None else warmup,
            time_seconds=self.time_seconds if time_limit is None else time_limit,
        )


def measure_throughput(routine: Callable[[], WorkUnits], budget: BenchBudget) -> BenchStats:
    """Run ``routine`` under ``budget`` and collect throughput statistics.

    ``routine`` performs one batch of device work, synchronizes, and returns
    the ``WorkUnits`` accomplished. Warm-up calls are uncounted. Both phases
    always execute at least one call.
    """
    warmup_deadline = now_ns() + int(budget.warmup_seconds * 1e9)
    while True:
        routine()
        if now_ns() >= warmup_deadline:
            break

    deadline = now_ns() + int(budget.time_seconds * 1e9)
    elements = 0
    total_bytes = 0
    latencies: list[float] = []
    started = now_ns()
    while True:
        call_start = now_ns()
        units = routine()
        call_end = now_ns()
        elements += units.elements
        total_bytes += units.bytes
        latencies.append((call_end - call_start) * 1e-9)
        if call_end >= deadline:
            break
    elapsed = (now_ns() - started) * 1e-9
    return BenchStats(
        elapsed_seconds=elapsed,
        elements=elements,
        bytes=total_bytes,
        latencies_seconds=latencies,
    )


# ---------------------------------------------------------------------------
# Chained-loop protocol: per-iteration device time without dispatch cost.
#
# Each measured sample is ONE dispatch of a ``lax.fori_loop`` whose
# iterations are data-dependent through a carried full-entropy u32 salt —
# no iteration can be hoisted or elided by the compiler — and the
# per-iteration time is the DIFFERENCE of the same program timed at two
# trip counts, which cancels dispatch and readback overhead. Whether the
# GPU still needs this over plain ``block_until_ready`` timing is an open
# question (PERF.md).
# ---------------------------------------------------------------------------


def fold_salt(salt, *outputs):
    """Mix kernel outputs (any pytrees/dtypes) into the carried u32 salt."""
    acc = salt * jnp.uint32(2654435761) + jnp.uint32(1)
    for leaf in jax.tree_util.tree_leaves(outputs):
        acc = acc ^ jnp.sum(leaf).astype(jnp.uint32)
    return acc


def perturb_u8(salt):
    """Full-byte-entropy perturbation of the salt (a low-cardinality one
    like ``salt & 1`` lets the compiler enumerate and hoist the cases)."""
    return (salt & jnp.uint32(255)).astype(jnp.uint8)


@dataclasses.dataclass
class DeviceRoutine:
    """A device variant measured under the chained-loop protocol.

    ``body(salt: u32[], extra, *consts) -> (salt', extra')`` runs ONE kernel
    application whose inputs depend on ``salt`` (XORed words, a seed, a
    dynamic row roll) and whose outputs fold back into ``salt'`` via
    ``fold_salt``. ``consts`` are loop-invariant device buffers passed as
    jit arguments (never closure constants) so the compiled program is
    data-independent. ``extra0`` optionally carries chained buffers (LUTs,
    stream ciphers). ``units`` is the work accomplished PER ITERATION.
    """

    body: Callable
    consts: tuple
    units: WorkUnits
    extra0: Any = ()


def device_routine_factory(fn):
    """Mark a zero-arg callable as producing a ``DeviceRoutine`` lazily, so
    suite runners defer its (possibly expensive) device staging until after
    the variant-name filter check."""
    fn._makes_device_routine = True
    return fn


# Wanted (t_{1+K} - t_1) per sample: well above host-clock jitter.
CHAINED_TARGET_EXTRA_S = 0.5


def _chained_loop_fn(body):
    def loop_fn(salt0, extra, k, *consts):
        def step(_, carry):
            s, e = carry
            return body(s, e, *consts)

        salt, extra_out = jax.lax.fori_loop(0, k, step, (salt0, extra))
        # Consume every carried leaf so loop simplification cannot drop the
        # extra chain: fold a salt-positioned slice of each into the result.
        acc = salt
        for leaf in jax.tree_util.tree_leaves(extra_out):
            flat = leaf.reshape(-1)
            span = min(int(flat.shape[0]), 1024)
            start = (salt % jnp.uint32(max(int(flat.shape[0]) - span, 1))).astype(jnp.int32)
            acc = acc ^ jnp.sum(
                jax.lax.dynamic_slice(flat, (start,), (span,)).astype(jnp.uint32)
            )
        return acc

    return loop_fn


def chained_per_iter(
    body,
    consts: tuple,
    extra0=(),
    *,
    target_extra_s: float = CHAINED_TARGET_EXTRA_S,
    smoke: bool = False,
    log=None,
) -> dict:
    """Measure one chained body; returns per-iteration diagnostics.

    ``{"per_iter_s", "k", "iters", "compile_s"}`` — ``iters`` is the total
    trip count executed during the measured phase (for work accounting).
    With ``smoke=True`` only the compile + k=1 call runs (the ``TIME=0``
    smoke contract) and ``per_iter_s`` is that single wall time.
    """
    import numpy as np

    f = jax.jit(_chained_loop_fn(body))
    salt = jnp.uint32(int(time.time_ns()) & 0x7FFFFFFF | 1)

    def timed(k: int) -> float:
        nonlocal salt
        start = time.perf_counter()
        out = np.uint32(f(salt, extra0, jnp.int32(k), *consts))  # forced readback
        elapsed = time.perf_counter() - start
        salt = jnp.uint32(out)  # chain across calls: no dispatch ever repeats
        return elapsed

    compile_start = time.perf_counter()
    first = timed(1)
    compile_s = time.perf_counter() - compile_start
    if log is not None:
        log(f"compile+first-run {compile_s:.1f}s")
    if smoke:
        # Warm-up was the compile call; one more k=1 call is the measured
        # iteration (the TIME=0 contract: ≥1 warm-up + ≥1 measured call).
        return {"per_iter_s": timed(1), "k": 1, "iters": 1, "compile_s": compile_s}

    # Pilot with escalating trip counts so second-per-iteration kernels
    # never run a huge pilot.
    t1 = min(timed(1), timed(1))
    rough = max((timed(3) - t1) / 2.0, 1e-5)
    if rough > 0.25:
        k = max(int(np.ceil(1.0 / rough)), 2)
    else:
        refined = max((timed(17) - t1) / 16.0, 1e-5)
        k = int(np.clip(target_extra_s / refined, 8, 8192))

    iters = 22  # pilot trips: 1+1+3+17 (rough path skips the 17)
    t1s, tks = [], []
    for _ in range(3):
        t1s.append(timed(1))
        tks.append(timed(1 + k))
        iters += 2 + k
    per_iter = (sorted(tks)[1] - sorted(t1s)[1]) / k
    if per_iter <= 0:  # jitter swamped the pilot k; retry with 4x
        k *= 4
        tks = [timed(1 + k) for _ in range(3)]
        iters += 3 * (1 + k)
        per_iter = max((sorted(tks)[1] - sorted(t1s)[1]) / k, 1e-9)
    return {"per_iter_s": per_iter, "k": k, "iters": iters, "compile_s": compile_s}


def measure_chained(routine: DeviceRoutine, budget: BenchBudget) -> BenchStats:
    """Measure a ``DeviceRoutine`` under ``budget`` → ``BenchStats``.

    The warm-up budget is where the compile lands (always at least the k=1
    call, preserving the ``TIME=0`` smoke contract); the measured budget
    scales the per-sample target extra time.
    """
    smoke = budget.time_seconds <= 0
    target = float(min(max(budget.time_seconds / 8.0, 0.2), 1.0)) if not smoke else 0.0
    diag = chained_per_iter(
        routine.body, routine.consts, routine.extra0, target_extra_s=target or 0.5, smoke=smoke
    )
    iters = diag["iters"]
    per_iter = diag["per_iter_s"]
    return BenchStats(
        elapsed_seconds=per_iter * iters,
        elements=routine.units.elements * iters,
        bytes=routine.units.bytes * iters,
        latencies_seconds=[per_iter],
    )


# ---------------------------------------------------------------------------
# Host-side pacing for item-at-a-time loops (Python-kernel parity paths).
#
# Same *behavior contract* as the reference's adaptive pacing (stride starts
# at 1, doubles toward a 1024 cap while the work between clock reads stays
# under ~1 ms — ``utils.rs:588-589``, ``utils.py:103-139``), expressed here
# as one small pacer object that both loop shapes share.
# ---------------------------------------------------------------------------

PACING_STRIDE_CAP = 1024
PACING_TARGET_BETWEEN_CHECKS_NS = 1_000_000


class AdaptiveStride:
    """Checkpoint cadence that widens geometrically while cheap.

    ``width`` is how many items to process before the next clock read.
    ``checkpoint()`` records one clock read, widens if the elapsed span was
    under the ~1 ms target, and reports the current time — so one slow item
    keeps the cadence at every-iteration (bounding deadline overshoot by a
    single item) while fine-grained work amortizes up to the cap.
    """

    __slots__ = ("cap", "width", "_mark")

    def __init__(self, cap: int = PACING_STRIDE_CAP):
        self.cap = cap
        self.width = 1
        self._mark = now_ns()

    def checkpoint(self) -> int:
        current = now_ns()
        if current - self._mark < PACING_TARGET_BETWEEN_CHECKS_NS and self.width < self.cap:
            self.width = min(self.width * 2, self.cap)
        self._mark = current
        return current


def paced_items(items: Iterable, deadline_ns: int, step: int = PACING_STRIDE_CAP) -> Iterator:
    """Yield from ``items`` until ``deadline_ns``, checkpointing adaptively."""
    pacer = AdaptiveStride(step)
    remaining = 1
    for item in items:
        yield item
        remaining -= 1
        if remaining == 0:
            if pacer.checkpoint() >= deadline_ns:
                return
            remaining = pacer.width


def clamped_subranges(count: int, stride: int = PACING_STRIDE_CAP) -> Iterator[tuple[int, int]]:
    """(low, high) windows covering [0, count) in stride-sized steps."""
    return ((low, min(low + stride, count)) for low in range(0, count, stride))


def reduce_in_windows(function, *columns, deadline_ns: int, step: int = PACING_STRIDE_CAP, combine=sum):
    """Window-at-a-time map-reduce over zipped columns with deadline pacing.

    Each window is ``combine(map(function, ...))`` so the per-item loop runs
    in C; the deadline is read once per adaptive window. Returns
    ``(total, processed_count)``.
    """
    count = min(map(len, columns), default=0)
    pacer = AdaptiveStride(step)
    total = 0
    done = 0
    while done < count and now_ns() < deadline_ns:
        high = min(done + pacer.width, count)
        total += combine(map(function, *(column[done:high] for column in columns)))
        pacer.checkpoint()
        done = high
    return total, done
