"""Shared suite scaffolding: arg parsing, tape loading, variant runner.

The per-suite ``main`` composes: parse flags → load tape (with stderr
stats) → resolve device scopes → run groups → ``finish``. Mirrors the
reference's suite skeleton (``find/bench.rs:350-371``,
``hash/bench.py:236-270``) with the skip-not-crash discipline: any variant
whose setup or first call fails prints ``SKIPPED (<reason>)`` and the suite
moves on (``similarities/bench.py:426-433``). A failed device (``swtpu::``)
row additionally makes the suite exit non-zero once every row has run;
host baseline rows only skip.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from typing import Callable

import jax

from stringwars_tpu import datasets
from stringwars_tpu.parallel.mesh import DeviceScope, scope_variants
from stringwars_tpu.tape import Tape
from stringwars_tpu.utils.config import add_common_args, compile_filter, resolve_tokens, should_run
from stringwars_tpu.utils.harness import (
    BenchBudget,
    DeviceRoutine,
    WorkUnits,
    fold_salt,
    measure_chained,
    measure_throughput,
)
from stringwars_tpu.utils.report import BenchStats, report_skip


class SuiteContext:
    def __init__(self, args, tape: Tape, budget: BenchBudget, pattern, scopes: list[DeviceScope]):
        self.args = args
        self.tape = tape
        self.budget = budget
        self.pattern = pattern
        self.scopes = scopes
        self.failed: list[str] = []

    def group(self, title: str) -> None:
        print(f"# {title}", flush=True)

    def run(
        self, name: str, unit: str, routine: Callable[[], WorkUnits] | DeviceRoutine
    ) -> BenchStats | None:
        """Measure one variant under the suite budget; SKIP on failure.

        A plain closure is measured with the wall-time loop; a
        ``DeviceRoutine`` goes through the chained-loop protocol. Routine
        factories (zero-arg callables returning a DeviceRoutine) defer
        device staging until after the filter check. Returns the stats, or
        None when the variant was filtered out or failed.
        """
        if not should_run(name, self.pattern):
            print(f"{name:<42} SKIPPED (filtered)", file=sys.stderr, flush=True)
            return None
        try:
            if callable(routine) and getattr(routine, "_makes_device_routine", False):
                routine = routine()
            if isinstance(routine, DeviceRoutine):
                stats = measure_chained(routine, self.budget)
            else:
                stats = measure_throughput(routine, self.budget)
        except KeyboardInterrupt:
            report_skip(name, "interrupted by user")
            raise
        except Exception as error:  # noqa: BLE001 — skip-not-crash per suite contract
            self.fail(name, error)
            return None
        stats.report(name, unit, roofline_bytes_per_second=self._roofline(name))
        return stats

    def fail(self, name: str, error: Exception) -> None:
        """Report a variant that could not run; device rows fail the suite."""
        report_skip(name, f"{type(error).__name__}: {error}")
        if datasets.get_env_bool("DEBUG_TRACEBACKS"):
            traceback.print_exception(error)
        if "swtpu::" in name:
            self.failed.append(name)

    def finish(self) -> None:
        """Exit non-zero when any device row failed."""
        if self.failed:
            print(
                f"{len(self.failed)} device row(s) failed: {', '.join(self.failed)}",
                file=sys.stderr,
                flush=True,
            )
            raise SystemExit(1)

    def _roofline(self, name: str) -> float | None:
        """Device-memory peak for on-device ``swtpu::`` rows (the SoL
        column, the analog of the reference's cyc/B + IPC columns,
        ``utils.rs:672-680``). Host baselines and CPU-backend runs report
        no SoL column; an accelerator missing from the peak table is an
        error."""
        device = jax.devices()[0]
        if "swtpu::" not in name or device.platform == "cpu":
            return None
        from stringwars_tpu.utils.peaks import hbm_peak_bytes_per_second

        return hbm_peak_bytes_per_second(device.device_kind)


def chained_layouts(fn, layouts, units: WorkUnits, *, fold_extra=()) -> DeviceRoutine:
    """DeviceRoutine applying ``fn`` to each staged layout per iteration.

    Layouts are registered pytrees whose FIRST leaf is a uint32 content
    array (hash words, SHA blocks); that leaf is XORed with the carried
    salt so no iteration hashes the same content — the anti-memoization
    rule of the chained protocol. Outputs fold back into the salt.
    """
    import jax.tree_util as jtu

    flattened = [jtu.tree_flatten(layout) for layout in layouts]
    flat: list = [leaf for leaves, _ in flattened for leaf in leaves]

    def body(s, e, *consts):
        outs = []
        at = 0
        for leaves, treedef in flattened:
            span = len(leaves)
            group = list(consts[at : at + span])
            at += span
            group[0] = group[0] ^ s
            outs.append(fn(jtu.tree_unflatten(treedef, group)))
        return fold_salt(s, *outs, *fold_extra), e

    return DeviceRoutine(body=body, consts=tuple(flat), units=units)


def setup_suite(
    description: str,
    *,
    default_tokens: str,
    default_warmup: float,
    default_time: float,
    default_synthetic: str = "english-words",
    extra_args: Callable[[argparse.ArgumentParser], None] | None = None,
) -> SuiteContext:
    parser = argparse.ArgumentParser(description=description)
    add_common_args(parser)
    if extra_args:
        extra_args(parser)
    args = parser.parse_args()

    pattern = compile_filter(args.filter)
    tokens_mode = resolve_tokens(args.tokens, default_tokens)
    tape = datasets.load_tape(
        args.dataset,
        tokens_mode=tokens_mode,
        size_limit=args.dataset_limit,
        default_synthetic=default_synthetic,
    )
    budget = BenchBudget.from_env(default_warmup, default_time).with_overrides(
        args.warmup, args.time_limit
    )
    scopes = scope_variants(args.chips)
    print(
        f"swtpu on {jax.default_backend()} "
        f"({jax.local_device_count()} device(s)); budget {budget.warmup_seconds}s+{budget.time_seconds}s",
        file=sys.stderr,
        flush=True,
    )
    return SuiteContext(args, tape, budget, pattern, scopes)
