"""Multi-host process groups + host-local data placement (kernel K15's
multi-host half).

The reference is single-process (SURVEY.md §5 "Distributed communication
backend: absent"); this module is this build's own first-class layer, as
BASELINE.json pins (">=80 % scaling 1 chip -> 2+ hosts"):

- ``maybe_initialize()`` joins the ``jax.distributed`` process group from
  ``SWTPU_COORDINATOR`` / ``SWTPU_NUM_PROCESSES`` / ``SWTPU_PROCESS_ID``
  env (or standard cluster auto-detection). After it, ``jax.devices()``
  is global and ``parallel.mesh.make_mesh()`` naturally produces a
  ``<Nhost>`` scope (``mesh.py:66-72``).
- ``host_byte_range()`` computes which slice of a global corpus this
  process should load — each host reads only its own range **plus the
  halo tail** (windowed scans need ``overlap`` bytes of the next host's
  prefix; reading them at load time replaces a boundary exchange).
- ``shard_bytes_local()`` builds the per-chip halo rows for this host's
  range and assembles the *global* sharded array with
  ``jax.make_array_from_process_local_data`` — no host ever materializes
  another host's corpus bytes.

The resulting array feeds the exact same ``shard_map`` + ``psum`` programs
as the single-host path (``parallel/sharding.py``, ``suites/find.py``):
collectives ride ICI within a host and DCN across hosts, chosen by XLA
from the mesh layout. Validated end-to-end by ``tests/test_multihost.py``
with two real processes over Gloo CPU collectives.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import PartitionSpec as P

from stringwars_tpu.parallel.mesh import SHARD_AXIS, DeviceScope

_INITIALIZED = False


def maybe_initialize() -> bool:
    """Join the jax.distributed process group if env vars ask for it.

    Returns True when running multi-process (after initialization).
    Idempotent; safe to call from every suite.
    """
    global _INITIALIZED
    coordinator = os.environ.get("SWTPU_COORDINATOR")
    if coordinator and not _INITIALIZED:
        # Must run before anything touches the backend (jax.devices() etc.).
        num = int(os.environ["SWTPU_NUM_PROCESSES"])
        pid = int(os.environ["SWTPU_PROCESS_ID"])
        jax.distributed.initialize(coordinator, num_processes=num, process_id=pid)
        _INITIALIZED = True
    return jax.process_count() > 1


def host_byte_range(total_bytes: int, *, overlap: int = 0, align: int = 512) -> tuple[int, int, int]:
    """(offset, length_with_halo, chunk) of the global corpus this process
    loads. ``chunk`` is the per-chip slice size; each host owns
    ``local_chips`` consecutive chunks and reads ``overlap`` extra tail
    bytes so its last chip's halo needs no runtime exchange."""
    procs = max(jax.process_count(), 1)
    chips_total = jax.device_count()
    local_chips = jax.local_device_count()
    chunk = ((total_bytes + chips_total - 1) // chips_total + align - 1) // align * align
    pid = jax.process_index()
    offset = pid * local_chips * chunk
    length = min(local_chips * chunk + overlap, max(total_bytes - offset, 0) + overlap)
    del procs
    return offset, length, chunk


def shard_bytes_local(
    scope: DeviceScope,
    local_data: np.ndarray,
    global_n: int,
    *,
    overlap: int = 0,
    align: int = 512,
) -> tuple[jax.Array, int, int]:
    """Assemble the globally byte-sharded halo rows from host-local bytes.

    ``local_data`` must be the bytes of this host's ``host_byte_range()``
    (its chips' chunks plus the halo tail). Returns (global rows array
    sharded as ``P(SHARD_AXIS, None)``, global_n, chunk) — drop-in
    compatible with ``sharding.shard_bytes`` output.
    """
    chips_total = jax.device_count()
    local_chips = jax.local_device_count()
    chunk = ((global_n + chips_total - 1) // chips_total + align - 1) // align * align
    row_len = chunk + overlap
    local = np.zeros(local_chips * chunk + overlap, np.uint8)
    take = min(local_data.shape[0], local.shape[0])
    local[:take] = np.asarray(local_data[:take], np.uint8)
    rows = np.lib.stride_tricks.sliding_window_view(local, row_len)[::chunk][:local_chips]
    sharding = scope.sharding(P(SHARD_AXIS, None))
    global_rows = jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(rows), (chips_total, row_len)
    )
    return global_rows, global_n, chunk
