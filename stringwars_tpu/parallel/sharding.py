"""Sharded tape placement + halo exchange (the cross-chip layer).

The reference has no distributed layer at all (SURVEY.md §2.3 "Parallelism
strategies"); this module is the first-class component this build adds:

- **Token data-parallelism**: shard a ``PaddedTokens`` batch (or any
  leading-axis array) across the mesh's ``shard`` axis; per-chip kernels run
  under ``shard_map`` and reduce counts/digests with ``psum``.
- **Byte-axis sequence sharding with halos**: a single huge haystack is
  split on the byte axis; scans whose window spans ``overlap`` bytes
  (needle length − 1) receive a halo copied from the right neighbor so no
  match is lost at shard seams (BASELINE.json "halo exchange" subsystem).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from stringwars_tpu.parallel.mesh import SHARD_AXIS, DeviceScope


def replicate(scope: DeviceScope, tree):
    """Place every array in ``tree`` fully replicated on the scope's mesh."""
    return jax.device_put(tree, scope.replicated)


def shard_tokens(scope: DeviceScope, array: jax.Array | np.ndarray, *, pad_value=0):
    """Shard ``array`` on its leading axis, padding it to a multiple of the
    mesh size. Returns (sharded_array, valid_count)."""
    n = array.shape[0]
    chips = scope.chips
    padded = ((n + chips - 1) // chips) * chips
    if padded != n:
        pad_width = [(0, padded - n)] + [(0, 0)] * (array.ndim - 1)
        array = np.pad(np.asarray(array), pad_width, constant_values=pad_value)
    return jax.device_put(array, scope.data_sharding), n


def shard_bytes(scope: DeviceScope, data: jax.Array | np.ndarray, *, overlap: int = 0, align: int = 512):
    """Split a flat byte buffer into per-chip rows ``[chips, chunk + overlap]``.

    Row ``i`` holds bytes ``[i*chunk, (i+1)*chunk + overlap)`` of the padded
    buffer — i.e. each chip sees its slice plus an ``overlap``-byte halo from
    the next chip, so windowed scans (substring search with an m-byte needle
    uses ``overlap = m - 1``) observe every window exactly once. The result is
    placed with the leading (chip) axis sharded.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    chips = scope.chips
    chunk = ((n + chips - 1) // chips + align - 1) // align * align
    buf = np.zeros(chips * chunk + overlap, dtype=np.uint8)
    buf[:n] = data
    rows = np.lib.stride_tricks.sliding_window_view(buf, chunk + overlap)[::chunk][:chips]
    sharded = jax.device_put(np.ascontiguousarray(rows), scope.sharding(P(SHARD_AXIS, None)))
    return sharded, n, chunk


def psum_scalar(value, axis_name: str = SHARD_AXIS):
    """Sum a per-chip scalar across the mesh (inside ``shard_map``)."""
    return jax.lax.psum(value, axis_name)


def all_gather_tokens(value, axis_name: str = SHARD_AXIS):
    """Gather per-chip token results back to every chip (inside ``shard_map``)."""
    return jax.lax.all_gather(value, axis_name, tiled=True)
