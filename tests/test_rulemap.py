"""Rule maps (dense gathers / boundary binary search) vs the dense
tables they were compiled from and the per-rule oracle."""

import numpy as np
import pytest

from stringwars_tpu.ops.rulemap import (
    FoldRules,
    StepRules,
    compile_fold,
    compile_sparse_values,
    compile_steps,
    expand_steps,
    range_map,
    range_map_ref,
    step_map,
)
from stringwars_tpu.ops import rulemap
from stringwars_tpu.unicode import tables


@pytest.mark.parametrize(
    "table_fn",
    ["whitespace_table", "newline_table", "grapheme_break_table", "word_break_table"],
)
def test_step_rules_roundtrip(table_fn):
    table = np.asarray(getattr(tables, table_fn)())
    rules = compile_steps(table)
    np.testing.assert_array_equal(expand_steps(rules, table.shape[0]), table)


@pytest.mark.parametrize("dense_max", [rulemap._DENSE_MAX, 1024])
def test_step_map_kernel_matches_gather(rng, monkeypatch, dense_max):
    """Both evaluators: the dense-table gather and, when the table would
    exceed the dense limit, the binary search over run starts."""
    monkeypatch.setattr(rulemap, "_DENSE_MAX", dense_max)
    table = np.asarray(tables.word_break_table())
    rules = compile_steps(table)
    cps = np.concatenate(
        [
            rng.integers(0, 0x600, 3000),
            rng.integers(0, 0x110000, 1000),
            rules.starts[rng.integers(0, rules.count, 500)],  # exact boundaries
        ]
    ).astype(np.int32)
    got = np.asarray(step_map(cps, rules))
    np.testing.assert_array_equal(got, table[cps])


def test_step_prune_exact_below_bound(rng):
    table = np.asarray(tables.grapheme_break_table())
    rules = compile_steps(table).prune(0x2FFF)
    cps = rng.integers(0, 0x3000, 4000).astype(np.int32)
    got = np.asarray(step_map(cps, rules))
    np.testing.assert_array_equal(got, table[cps])


@pytest.mark.parametrize("dense_max", [rulemap._DENSE_MAX, 1024])
def test_fold_rules_match_inline_table(rng, monkeypatch, dense_max):
    monkeypatch.setattr(rulemap, "_DENSE_MAX", dense_max)
    inline, _multi, _pool = tables.casefold_tables()
    rules = compile_fold(inline)
    cps = np.concatenate(
        [
            rng.integers(0, 0x600, 4000),
            rng.integers(0, 0x110000, 2000),
            np.arange(0x41, 0x5B),  # A-Z
            np.arange(0x391, 0x3AA),  # Greek
            np.arange(0x400, 0x460),  # Cyrillic
        ]
    ).astype(np.int32)
    got = np.asarray(range_map(cps, rules))
    # The rules fold everything the inline table folds; multi-escape slots
    # (inline < 0) stay identity here (handled by the expansion value maps).
    want = np.where(inline[cps] >= 0, inline[cps], cps)
    np.testing.assert_array_equal(got, want)


def test_fold_rules_xla_path_matches(rng):
    """The per-rule oracle agrees with the table and with ``range_map``."""
    inline, _multi, _pool = tables.casefold_tables()
    rules = compile_fold(inline)
    cps = rng.integers(0, 0x1000, 3000).astype(np.int32)
    got = np.asarray(range_map_ref(cps, rules))
    want = np.where(inline[cps] >= 0, inline[cps], cps)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(range_map(cps, rules)), want)


def test_sparse_value_map(rng):
    keys = np.asarray([0xDF, 0x130, 0x1F0, 0xFB03], np.int64)
    vals = np.asarray([7, 9, 11, 13], np.int64)
    rules = compile_sparse_values(keys, vals)
    cps = np.concatenate([keys, rng.integers(0, 0x20000, 2000)]).astype(np.int32)
    got = np.asarray(range_map(cps, rules))
    want = np.zeros_like(cps)
    for k, v in zip(keys, vals):
        want[cps == k] = v
    np.testing.assert_array_equal(got, want)
