"""Unicode table lookups: step-function / range-rule maps (K9/K10).

Per-codepoint class and fold tables are stored compiled to their run
structure, which ``prune`` can cut to a corpus' codepoint ceiling:

- A dense class table (grapheme/word/sentence break classes, whitespace,
  pictographic, ...) is a step function: ``value(cp) = Σ_r dv_r · [cp >=
  start_r]`` over its run boundaries (21 runs for whitespace, ~1.7k for
  grapheme classes).
- The case-fold map is identity plus ~200 range rules (contiguous blocks
  with a constant delta, alternating-parity blocks, singletons):
  ``fold(cp) = cp + Σ_r d_r · [lo_r <= cp <= hi_r and parity matches]``.

Both evaluate as one gather from the dense table they describe when it
spans at most a few MB, else as a binary search over the rule boundaries.
``range_map_ref`` keeps the literal per-rule sum as the test oracle.
Reference workloads: ``tokenization/bench.rs:78-456`` (TR29/UAX#14
segmentation), ``normalization/bench.rs:58-141`` (fold/normalize).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
_MAX_CP = 0x110000


@dataclasses.dataclass(frozen=True)
class StepRules:
    """A dense int table compiled to its step-function boundaries."""

    starts: np.ndarray  # int32 [R] ascending; starts[0] == 0
    deltas: np.ndarray  # int32 [R]; value(cp) = Σ deltas[starts <= cp]

    @property
    def count(self) -> int:
        return int(self.starts.shape[0])

    def prune(self, max_cp: int) -> "StepRules":
        """Keep only boundaries reachable by cp <= max_cp (staging-time
        specialization; caller guarantees the bound)."""
        keep = self.starts <= max_cp
        return StepRules(self.starts[keep], self.deltas[keep])


def compile_steps(table: np.ndarray) -> StepRules:
    """Compile a dense cp->value table into step boundaries."""
    t = np.asarray(table, np.int64)
    change = np.flatnonzero(t[1:] != t[:-1]) + 1
    starts = np.concatenate([[0], change]).astype(np.int32)
    values = t[starts]
    deltas = np.diff(values, prepend=0).astype(np.int32)
    return StepRules(starts=starts, deltas=deltas)


@dataclasses.dataclass(frozen=True)
class FoldRules:
    """Range rules for a sparse delta map (case folding and friends).

    Rule r adds ``delta_r`` where ``lo_r <= cp <= hi_r`` and
    ``cp & pmask_r == par_r`` (pmask 0 = any parity, 1 = alternating
    blocks that map every second codepoint)."""

    lo: np.ndarray
    hi: np.ndarray
    delta: np.ndarray
    pmask: np.ndarray
    par: np.ndarray
    base: int = 0  # 0: out = cp + acc (delta map); 1: out = acc (value map)

    @property
    def count(self) -> int:
        return int(self.lo.shape[0])

    def prune(self, max_cp: int) -> "FoldRules":
        keep = self.lo <= max_cp
        return FoldRules(
            self.lo[keep], self.hi[keep], self.delta[keep],
            self.pmask[keep], self.par[keep], self.base,
        )


def compile_fold(table: np.ndarray) -> FoldRules:
    """Compile a mostly-identity cp->cp map into range delta rules.

    Detects stride-1 and stride-2 (alternating) constant-delta runs;
    entries with ``table[cp] < 0`` (escape markers) are treated as
    identity here — callers handle them through a separate value map.
    """
    t = np.asarray(table, np.int64)
    cps = np.arange(t.shape[0], dtype=np.int64)
    active = (t >= 0) & (t != cps)
    idx = np.flatnonzero(active)
    delta = (t[idx] - idx).astype(np.int64)
    lo, hi, dv, pm, pr = [], [], [], [], []
    i = 0
    while i < idx.size:
        j = i
        while j + 1 < idx.size and idx[j + 1] == idx[j] + 1 and delta[j + 1] == delta[i]:
            j += 1
        k = i
        while k + 1 < idx.size and idx[k + 1] == idx[k] + 2 and delta[k + 1] == delta[i]:
            k += 1
        if (k - i) > (j - i):
            lo.append(idx[i]); hi.append(idx[k]); dv.append(delta[i])
            pm.append(1); pr.append(int(idx[i]) & 1)
            i = k + 1
        else:
            lo.append(idx[i]); hi.append(idx[j]); dv.append(delta[i])
            pm.append(0); pr.append(0)
            i = j + 1
    mk = lambda v: np.asarray(v, np.int32)  # noqa: E731
    return FoldRules(mk(lo), mk(hi), mk(dv), mk(pm), mk(pr))


def compile_sparse_values(keys: np.ndarray, values: np.ndarray) -> FoldRules:
    """Singleton value map (cp -> value, 0 elsewhere) as equality rules,
    merging consecutive-key constant-value runs."""
    keys = np.asarray(keys, np.int64)
    values = np.asarray(values, np.int64)
    order = np.argsort(keys)
    keys, values = keys[order], values[order]
    lo, hi, dv = [], [], []
    i = 0
    while i < keys.size:
        j = i
        while j + 1 < keys.size and keys[j + 1] == keys[j] + 1 and values[j + 1] == values[i]:
            j += 1
        lo.append(keys[i]); hi.append(keys[j]); dv.append(values[i])
        i = j + 1
    mk = lambda v: np.asarray(v, np.int32)  # noqa: E731
    z = np.zeros(len(lo), np.int32)
    return FoldRules(mk(lo), mk(hi), mk(dv), z, z.copy(), base=1)


# Dense tables up to this many entries (4 MiB of int32) are gathered
# directly; larger domains binary-search the rule boundaries instead.
_DENSE_MAX = 1 << 20


def _dense_delta_table(rules: FoldRules) -> np.ndarray:
    """Dense int32 delta/value table over [0, hi.max()+2) — the final
    entry is rule-free so clamped out-of-range lookups read 0."""
    size = int(rules.hi.max()) + 2
    t = np.zeros(size, np.int64)
    for r in range(rules.count):
        lo, hi = int(rules.lo[r]), int(rules.hi[r])
        seg = np.arange(lo, hi + 1, dtype=np.int64)
        pm = int(rules.pmask[r])
        if pm:
            seg = seg[(seg & pm) == int(rules.par[r])]
        t[seg] += int(rules.delta[r])
    return t.astype(np.int32)


def step_map(cps: jax.Array, rules: StepRules, table: np.ndarray | None = None) -> jax.Array:
    """Evaluate a compiled step table over any-shape int codepoints.

    A gather from the dense table (pass ``table`` to avoid rebuilding it)
    when it spans at most ``_DENSE_MAX`` entries, else a binary search over
    the run starts. Step functions are constant past their last boundary,
    so clamping the index is exact for every cp the rules were pruned to.
    """
    cps = cps.astype(jnp.int32)
    size = int(rules.starts[-1]) + 1 if rules.count else 1
    if size <= _DENSE_MAX:
        dense = expand_steps(rules, size) if table is None else np.asarray(table)[:size]
        return jnp.take(jnp.asarray(dense, jnp.int32), jnp.clip(cps, 0, size - 1))
    values = np.cumsum(rules.deltas.astype(np.int64)).astype(np.int32)
    run = jnp.searchsorted(jnp.asarray(rules.starts), cps, side="right") - 1
    return jnp.take(jnp.asarray(values), jnp.clip(run, 0, rules.count - 1))


def range_map(cps: jax.Array, rules: FoldRules) -> jax.Array:
    """Evaluate compiled range rules (delta map when ``rules.base == 0``,
    sparse value map when 1) over any-shape codepoints: a dense-table
    gather, or a binary search over the (disjoint, sorted) rule ranges
    when the table would exceed ``_DENSE_MAX`` entries."""
    cps = cps.astype(jnp.int32)
    if rules.count == 0:
        return cps if rules.base == 0 else jnp.zeros_like(cps)
    size = int(rules.hi.max()) + 2
    if size <= _DENSE_MAX:
        acc = jnp.take(jnp.asarray(_dense_delta_table(rules)), jnp.clip(cps, 0, size - 1))
    else:
        if np.any(rules.lo[1:] <= rules.hi[:-1]):
            raise ValueError("range rules must be sorted and disjoint")
        r = jnp.searchsorted(jnp.asarray(rules.lo), cps, side="right") - 1
        rc = jnp.clip(r, 0, rules.count - 1)
        ok = (
            (r >= 0)
            & (cps <= jnp.take(jnp.asarray(rules.hi), rc))
            & ((cps & jnp.take(jnp.asarray(rules.pmask), rc)) == jnp.take(jnp.asarray(rules.par), rc))
        )
        acc = jnp.where(ok, jnp.take(jnp.asarray(rules.delta), rc), 0)
    return (cps + acc) if rules.base == 0 else acc


def range_map_ref(cps: jax.Array, rules: FoldRules) -> jax.Array:
    """Test oracle for ``range_map``: one compare-and-add per rule."""
    cps = cps.astype(jnp.int32)
    out = jnp.zeros_like(cps)
    for r in range(rules.count):
        ok = (
            (cps >= int(rules.lo[r]))
            & (cps <= int(rules.hi[r]))
            & ((cps & int(rules.pmask[r])) == int(rules.par[r]))
        )
        out = out + jnp.where(ok, int(rules.delta[r]), 0)
    return (cps + out) if rules.base == 0 else out


def expand_steps(rules: StepRules, size: int = _MAX_CP) -> np.ndarray:
    """Reconstruct the dense table (tests / CPU gather path)."""
    table = np.zeros(size, np.int64)
    table[rules.starts] = rules.deltas
    return np.cumsum(table).astype(np.int32)
