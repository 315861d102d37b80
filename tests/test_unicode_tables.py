"""The break-property tables shipped in ``stringwars_tpu/unicode/data``
equal a fresh regeneration (``python -m stringwars_tpu.unicode.tables``)."""

import os

import numpy as np
import pytest

from stringwars_tpu.unicode import tables


def test_committed_break_tables_match_regeneration(tmp_path):
    pytest.importorskip("regex")
    tables.generate_break_tables(str(tmp_path))
    for stem in tables.BREAK_PROPERTIES:
        with np.load(os.path.join(tables.DATA_DIR, f"{stem}.npz")) as shipped, np.load(
            tmp_path / f"{stem}.npz"
        ) as fresh:
            assert shipped["t"].dtype == fresh["t"].dtype, stem
            np.testing.assert_array_equal(shipped["t"], fresh["t"], err_msg=stem)


def test_break_tables_load_from_package():
    gcb = tables.grapheme_break_table()
    lb, values = tables.line_break_table()
    assert gcb.shape == lb.shape == (tables.MAX_CP,)
    assert values == tables.LB_VALUES
    assert gcb[0x0D] == tables.GCB_VALUES.index("CR")
    assert lb[0x20] == values.index("SP")
    assert tables.extended_pictographic_table()[0x1F600]
