"""Sharded DP engines on the virtual mesh (the <Nchip> rows of
``suites/similarities.py``): the pair batch splits across devices under
``shard_map`` and per-pair results survive the seams bit-exactly.

Reference scope sweeps: ``similarities/bench.rs:376-399``.
"""

import jax
import numpy as np
import pytest

from stringwars_tpu.ops import similarity as S
from stringwars_tpu.ops.myers_pallas import myers_from_tokens
from stringwars_tpu.parallel.mesh import make_mesh
from stringwars_tpu.suites.similarities import make_sharded_scorer, myers_scorer


def _tokens(rng, n, lo, hi):
    return [bytes(rng.integers(97, 103, int(rng.integers(lo, hi)), dtype=np.uint8)) for _ in range(n)]


@pytest.fixture(scope="module")
def scope():
    if len(jax.devices()) < 4:
        pytest.skip("needs virtual multi-device mesh")
    return make_mesh(4)


def test_sharded_gotoh_matches_oracle(rng, scope):
    # 40 pairs over 4 devices: the batch pads to a multiple of the mesh.
    n = 40
    ta, tb = _tokens(rng, n, 1, 13), _tokens(rng, n, 1, 13)
    step = make_sharded_scorer(scope, S.pack_pairs(ta, tb), S.nw_score_affine)
    got = np.asarray(step()).reshape(-1)[:n]
    for i in range(n):
        want = S.nw_ref(list(ta[i]), list(tb[i]), match=2, mismatch=-1, go=-5, ge=-1)
        assert got[i] == want, (i, got[i], want)


def test_sharded_myers_matches_oracle(rng, scope):
    n = 40
    ta, tb = _tokens(rng, n, 1, 13), _tokens(rng, n, 1, 13)
    got = np.asarray(myers_scorer(scope, myers_from_tokens(ta, tb), interpret=True)()).reshape(-1)[:n]
    for i in range(n):
        want = S.levenshtein_ref(ta[i], tb[i])
        assert got[i] == want, (i, got[i], want)
