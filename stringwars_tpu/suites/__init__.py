"""Runnable benchmark suites mirroring the reference's ten workloads
(``find hash memory sequence similarities fingerprints tokenization
normalization containers encryption``), invoked as
``python -m stringwars_tpu.suites.<name>``.

Each suite prints ``# group`` headers and one canonical result line per
variant named ``group/library::function<scope>``, with device variants
(library ``swtpu``) measured next to host-CPU baseline variants from the
Python ecosystem — the same many-libraries-one-harness shape as the
reference (SURVEY.md §2.2).
"""
