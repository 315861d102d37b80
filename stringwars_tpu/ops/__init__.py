"""Kernel families K1-K13 (SURVEY.md §2.3), one module per family.

Every kernel follows the same discipline:
- a pure-``jnp`` reference implementation (conformance oracle + CPU fallback),
- a device path (fused XLA, or one Pallas kernel for the GPU) selected by default,
- exactness goldens against public specs (xxhash vectors, Unicode UCD,
  textbook DP) in ``tests/``.
"""
