"""Scaling suite: multi-chip data-parallel rows (<1chip> vs <Nchip>).

The reference's scope sweep is 1cpu/Ncpu/1gpu per variant; this suite
measures the flagship sharded pipeline (halo find + AC + hash +
fingerprint + BPE + LUT, ``parallel/pipeline.py``) per scope with scaling
efficiency printed to stderr (BASELINE.json target: >= 80 % linear bytes/s
from 1 chip up).

On a single-device machine the <Nchip> rows collapse to <1chip>; run under
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``
to exercise the 8-way sharded path on the CPU.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from stringwars_tpu.parallel.pipeline import make_sharded_step
from stringwars_tpu.suites._common import setup_suite
from stringwars_tpu.utils.harness import DeviceRoutine, WorkUnits, fold_salt, perturb_u8


def build_inputs(mesh: Mesh, tape, tokens_per_chip: int, hay_bytes_per_chip: int):
    """Shard the real corpus across the mesh (tokens + haystack rows).

    Returns ((inputs...), total_bytes, ac_n, ac_chunk)."""
    from stringwars_tpu.ops import find as F
    from stringwars_tpu.parallel.pipeline import _pipeline_inputs
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_chips = mesh.devices.size
    packed = F.pack_needle(b"th", capacity_words=4)
    row_len = hay_bytes_per_chip + 4 * packed.capacity + 8
    corpus = np.asarray(tape.data)[: tape.total_bytes]
    need = n_chips * row_len
    reps = max(need // max(corpus.shape[0], 1) + 1, 1)
    big = np.tile(corpus, reps)[:need]
    hay = big.reshape(n_chips, row_len)

    token_list = [t[:64] for t in tape.to_list()[: n_chips * tokens_per_chip] if t]
    while len(token_list) < n_chips * tokens_per_chip:
        token_list.append(b"pad")
    tokens = np.zeros((n_chips * tokens_per_chip, 64), np.uint8)
    lengths = np.zeros(n_chips * tokens_per_chip, np.int32)
    for i, t in enumerate(token_list):
        tokens[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)

    inputs, _packed, ac_n, ac_chunk = _pipeline_inputs(
        mesh, big[: n_chips * hay_bytes_per_chip], tokens, lengths
    )
    hay_dev = jax.device_put(hay, NamedSharding(mesh, P("shard", None)))
    # Work = haystack bytes (find) + AC bytes + token bytes (hash + fp + BPE).
    total_bytes = 2 * n_chips * hay_bytes_per_chip + int(lengths.sum())
    return (hay_dev,) + inputs, total_bytes, ac_n, ac_chunk


def main() -> None:
    ctx = setup_suite(
        "Multi-chip scaling of the flagship sharded pipeline",
        default_tokens="words",
        default_warmup=2.0,
        default_time=10.0,
    )
    ctx.group("pipeline")
    rates = {}
    for scope in ctx.scopes:
        mesh = scope.mesh
        inputs, total_bytes, ac_n, ac_chunk = build_inputs(
            mesh, ctx.tape, tokens_per_chip=4096, hay_bytes_per_chip=4 << 20
        )
        step = make_sharded_step(mesh, ac_n=ac_n, ac_chunk=ac_chunk)

        def body(s, e, *consts):
            # Salt every byte-stream input (haystack, token rows) so no
            # two iterations repeat; counts fold back into the salt.
            pert = perturb_u8(s)
            salted = [c ^ pert if c.dtype == jnp.uint8 else c for c in consts]
            out = step(*salted)
            return fold_salt(s, *jax.tree_util.tree_leaves(out)), e

        stats = ctx.run(
            f"pipeline/swtpu::sharded_step{scope.name}",
            "bytes",
            DeviceRoutine(body=body, consts=tuple(inputs), units=WorkUnits(1, total_bytes)),
        )
        if stats is not None:
            rates[scope.chips] = stats.bytes_per_second

    if len(rates) > 1:
        base = rates[min(rates)]
        for chips, rate in sorted(rates.items()):
            eff = rate / (base * chips / min(rates))
            print(
                f"scaling {chips} chip(s): {rate / 1e9:.2f} GB/s, efficiency {100 * eff:.1f}%",
                file=sys.stderr,
            )
    ctx.finish()


if __name__ == "__main__":
    main()
