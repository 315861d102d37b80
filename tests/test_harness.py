"""Harness (L2/L3) behavior: budgets, smoke contract, report formatting."""

import re

import pytest

from stringwars_tpu.utils.config import compile_filter, parse_size, should_run
from stringwars_tpu.utils.harness import BenchBudget, WorkUnits, measure_throughput, paced_items, now_ns
from stringwars_tpu.utils.report import format_byte_rate, format_report_line, format_seconds, format_si_rate


def test_zero_budget_runs_once():
    calls = []

    def routine():
        calls.append(1)
        return WorkUnits(elements=1, bytes=10)

    stats = measure_throughput(routine, BenchBudget(warmup_seconds=0.0, time_seconds=0.0))
    assert len(calls) >= 2  # one warm-up + one measured
    assert stats.elements >= 1 and stats.bytes >= 10


def test_measured_totals_accumulate():
    stats = measure_throughput(
        lambda: WorkUnits(elements=3, bytes=7),
        BenchBudget(warmup_seconds=0.0, time_seconds=0.02),
    )
    assert stats.elements % 3 == 0 and stats.bytes % 7 == 0
    assert stats.elements // 3 == stats.bytes // 7
    assert len(stats.latencies_seconds) == stats.elements // 3


def test_paced_items_deadline():
    deadline = now_ns() + 5_000_000
    consumed = sum(1 for _ in paced_items(iter(range(10**9)), deadline))
    assert 0 < consumed < 10**9


def test_report_line_format():
    line = format_report_line("find/sz::find<1chip>", "bytes", 1.0, 5, 11_520_000_000, [0.001, 0.002])
    assert line.startswith("find/sz::find<1chip>")
    assert "11.52 GB/s" in line
    assert "p50 1.00 ms p99 2.00 ms" in line
    assert line.index("11.52") == 43  # 42-char name column + space


def test_si_formatting():
    assert format_byte_rate(12_620_000_000) == "12.62 GB/s"
    assert format_si_rate(15_680_000_000, "CUPS", False) == "15.68 GCUPS"
    assert format_si_rate(71_850_000_000, "bits/s", True) == "71.85 G bits/s"
    assert format_si_rate(209_320_000, "cmp/s", True) == "209.32 M cmp/s"
    assert format_seconds(0.5e-7) == "50.00 ns"
    assert format_seconds(0.25) == "250.00 ms"


def test_parse_size():
    assert parse_size("128mb") == 128 << 20
    assert parse_size("1gb") == 1 << 30
    assert parse_size("100") == 100


def test_filter_substring_fallback():
    pattern = compile_filter("sz::find[")  # invalid regex → substring
    assert isinstance(pattern, re.Pattern)
    assert should_run("find/sz::find[abc]", pattern)
    assert not should_run("hash/xxh3", pattern)
    assert should_run("anything", None)


def test_reduce_in_windows():
    from stringwars_tpu.utils.harness import reduce_in_windows

    total, done = reduce_in_windows(
        lambda a, b: a * b, [1, 2, 3, 4], [10, 20, 30, 40], deadline_ns=now_ns() + 10**9
    )
    assert (total, done) == (10 + 40 + 90 + 160, 4)
    total, done = reduce_in_windows(lambda a: a, [], deadline_ns=now_ns() + 10**6)
    assert (total, done) == (0, 0)


def test_measure_chained_smoke_and_full():
    """DeviceRoutine goes through the fori_loop protocol on any backend."""
    import jax.numpy as jnp
    import numpy as np

    from stringwars_tpu.utils.harness import (
        BenchBudget,
        DeviceRoutine,
        WorkUnits,
        fold_salt,
        measure_chained,
    )

    data = jnp.asarray(np.arange(1024, dtype=np.uint32))

    def body(s, e, buf):
        return fold_salt(s, jnp.sum(buf ^ s)), e

    routine = DeviceRoutine(body=body, consts=(data,), units=WorkUnits(elements=2, bytes=4096))
    smoke = measure_chained(routine, BenchBudget(warmup_seconds=0, time_seconds=0))
    assert smoke.elements == 2 and smoke.bytes == 4096
    assert smoke.elapsed_seconds > 0

    full = measure_chained(routine, BenchBudget(warmup_seconds=0, time_seconds=0.5))
    # iters scale work: elements stays a multiple of the per-iter count.
    assert full.elements % 2 == 0 and full.elements > 2
    assert full.bytes_per_second > 0


def test_chained_extra_buffer_carries():
    """extra0 pytrees thread through iterations and are consumed."""
    import jax.numpy as jnp
    import numpy as np

    from stringwars_tpu.utils.harness import (
        BenchBudget,
        DeviceRoutine,
        WorkUnits,
        measure_chained,
    )

    buf = jnp.asarray(np.zeros(256, np.uint32))

    def body(s, e, _c):
        return s + jnp.uint32(1), e + jnp.uint32(1)

    routine = DeviceRoutine(
        body=body, consts=(buf,), units=WorkUnits(elements=1, bytes=1), extra0=buf
    )
    stats = measure_chained(routine, BenchBudget(warmup_seconds=0, time_seconds=0))
    assert stats.elements == 1


def test_peak_table_rejects_unknown_device_kind():
    """The SoL peak is looked up by exact device_kind; other H100 parts and
    unknown devices raise instead of defaulting."""
    from stringwars_tpu.utils.peaks import hbm_peak_bytes_per_second

    assert hbm_peak_bytes_per_second("NVIDIA H100 80GB HBM3") == 3.35e12
    for kind in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "TPU v5 lite", ""):
        with pytest.raises(KeyError, match="no published memory peak"):
            hbm_peak_bytes_per_second(kind)
