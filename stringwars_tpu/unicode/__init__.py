"""Unicode property tables and algorithms (families K9/K10).

Tables come from CPython's ``unicodedata`` (UCD 15.0, computed at first
use) and from ``regex``'s break properties (shipped as ``.npz`` in
``data/``) — replicated constants instead of the reference's icu4x
compiled data (SURVEY.md K10: "generate dense tables offline (host Python)
and ship them as replicated constants").
"""
