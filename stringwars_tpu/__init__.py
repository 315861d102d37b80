"""stringwars-tpu: a JAX string-processing framework for accelerators.

First-party JAX/XLA kernels (and one Pallas GPU kernel) with the
capabilities of StringWars: substring/byteset search, 64-bit + multiseed
hashing, edit distances (Levenshtein/NW/SW), MinHash fingerprints, UTF-8
machinery, Unicode case folding + normalization, segmentation, argsort,
memory ops and probabilistic filters — wrapped in a wall-time-budgeted
benchmark harness that reproduces the reference's variant naming, work
accounting and canonical report lines (reference: utils.py:243-336,
utils.rs:623-714).

Layout (maps SURVEY.md §7):
  - ``tape``       — the central (flat bytes, offsets) token container (K14)
  - ``ops``        — kernel families K1-K13, one module per family
  - ``parallel``   — mesh/device-scope + sharded collectives (K15)
  - ``utils``      — config, harness, reporting (L0-L3)
  - ``suites``     — runnable benchmark suites mirroring the reference's ten
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Multi-host: join the jax.distributed process group when SWTPU_COORDINATOR
# is set. This must happen before ANY backend touch, and importing this
# package is the first thing every suite/test does — so it lives here.
if _os.environ.get("SWTPU_COORDINATOR"):
    from stringwars_tpu.parallel.distributed import maybe_initialize as _maybe_init

    _maybe_init()

# Persistent XLA compilation cache. JAX itself honours
# JAX_COMPILATION_CACHE_DIR; when it is unset, accelerator runs cache in
# <checkout>/.jax_cache, a fixed path (the path is part of the cache key).
#
# CPU-platform runs (tests, dryruns) get NO persistent cache: XLA:CPU AOT
# round-trips are not trustworthy — deserializing a cached CPU executable
# SIGSEGVs inside `compilation_cache.get_executable_and_time` (reproduced
# with a same-machine, same-process-writes cache on a large segmentation
# program), and entries are additionally non-portable across hosts with
# different CPU features. CPU compiles are seconds.
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ and "cpu" not in (
    _os.environ.get("JAX_PLATFORMS", "") + (_jax.config.jax_platforms or "")
).lower():
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from stringwars_tpu.tape import Tape, PaddedTokens  # noqa: F401
