"""Device scopes over a JAX mesh (kernel family K15).

The device replacement for the reference's ``DeviceScope`` +
``forkunion::Topology`` layer (``similarities/bench.rs:69-75,376-379``,
``utils.rs:801-843``): a scope is a 1-D ``jax.sharding.Mesh`` over some
prefix of the local devices (axis ``"shard"``); every device reaches every
other at the same rate, so the mesh follows the algorithm alone. Batch
sizing scales with the device count (the reference scales with CPU cores
or GPU SMs). Multi-host scopes extend
the same mesh across processes (``jax.distributed``), with the variant-name
suffix following the reference's ``<1cpu>/<16cpu>/<1gpu>`` convention as
``<1chip>/<4chip>/<2host>``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stringwars_tpu.utils.config import get_env_parsed

SHARD_AXIS = "shard"


def available_chips() -> int:
    return jax.local_device_count()


@dataclasses.dataclass(frozen=True)
class DeviceScope:
    """A compute scope spanning ``chips`` devices (and ``hosts`` processes)."""

    mesh: Mesh
    chips: int
    hosts: int = 1

    @property
    def name(self) -> str:
        """Variant-name suffix, e.g. ``<1chip>`` / ``<4chip>`` / ``<2host>``."""
        if self.hosts > 1:
            return f"<{self.hosts}host>"
        return f"<{self.chips}chip>"

    def sharding(self, spec: P) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    @property
    def data_sharding(self) -> NamedSharding:
        """Leading-axis sharding over the shard axis."""
        return self.sharding(P(SHARD_AXIS))

    @property
    def replicated(self) -> NamedSharding:
        return self.sharding(P())

    def auto_batch_size(self, default_base: int = 128, base: int | None = None) -> int:
        """Batch scaled by the device count (reference
        ``utils.rs:801-843``)."""
        per_core = base if base is not None else get_env_parsed("BATCH_PER_CORE", default_base)
        return max(1, per_core) * max(1, self.chips)


@functools.lru_cache(maxsize=None)
def make_mesh(chips: int | None = None) -> DeviceScope:
    """Build a 1-D device scope over the first ``chips`` local devices."""
    devices = jax.devices()
    n = len(devices) if chips is None else min(chips, len(devices))
    mesh = Mesh(devices[:n], (SHARD_AXIS,))
    hosts = max(1, jax.process_count()) if n == len(devices) else 1
    return DeviceScope(mesh=mesh, chips=n, hosts=hosts)


def scope_variants(chips_flag: int | None = None) -> list[DeviceScope]:
    """Scopes to sweep per variant: 1 chip, and all chips when more exist —
    the analog of the reference's 1cpu/Ncpu/1gpu sweep."""
    total = available_chips() if chips_flag is None else min(chips_flag, available_chips())
    scopes = [make_mesh(1)]
    if total > 1:
        scopes.append(make_mesh(total))
    return scopes
