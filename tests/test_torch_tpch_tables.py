"""The port's host TPC-H generator (``arrow_tpu_torch/io/tpch.py``) for the
five tables the suite adds, against the JAX package's generator.

Part, supplier, partsupp, nation and region at SF 0.005 and 0.01 are
bit-identical to ``arrow_tpu.io.tpch``'s tables as the JAX package uploads
them (``upload_table``): every numeric column, every dictionary column's
codes and values, and each plain-string column (``p_name``, ``s_name``,
``s_address``, ``s_phone``, ``n_name``, ``r_name``) as the codes and
first-appearance dictionary that the reference's upload gives it; so are
customer's ``c_name`` and ``c_phone``, nearly one value a row.
``generate`` gives all eight tables.
"""

import numpy as np
import pytest
import torch

from arrow_tpu.device.column import upload_table
from arrow_tpu.io import tpch as jax_tpch
from arrow_tpu_torch.device.column import round_up
from arrow_tpu_torch.io import tpch
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


def _table_pair(table, sf):
    if table in ("nation", "region"):
        return (getattr(jax_tpch, f"{table}_table")(),
                getattr(tpch, f"{table}_table")(device="cpu"))
    return (getattr(jax_tpch, f"{table}_table")(sf),
            getattr(tpch, f"{table}_table")(sf, device="cpu"))


def assert_batch_matches_upload(jt, tb):
    """Every column the port keeps equals the reference's upload of it,
    bit for bit, with zero padding, no validity and the same type id and
    dictionary."""
    jb = upload_table(jt)
    n = jt.num_rows
    assert int(tb.row_count) == n and tb.capacity == round_up(n)
    assert tb.schema.names == jt.column_names
    for f, tc in zip(tb.schema.fields, tb.columns):
        jc = jb.column(f.name)
        want = np.asarray(jc.values)[:n]
        got = tc.values[:n].numpy()
        assert got.dtype == want.dtype, f.name
        assert got.tobytes() == want.tobytes(), f.name
        assert not tc.values[n:].any(), f.name
        assert int(f.type.id) == int(jc.type.id), f.name
        assert tc.validity is None
        if jc.dictionary is None:
            assert tc.dictionary is None, f.name
        else:
            assert list(tc.dictionary) == jc.dictionary.to_pylist(), f.name


@pytest.mark.parametrize("sf", [0.005, 0.01])
@pytest.mark.parametrize("table", ["part", "supplier", "partsupp", "nation",
                                   "region"])
def test_tables_bit_identical(table, sf):
    jt, tb = _table_pair(table, sf)
    assert_batch_matches_upload(jt, tb)


@pytest.mark.parametrize("sf", [0.005, 0.01])
@pytest.mark.parametrize("table,column", [("customer", "c_name"),
                                          ("customer", "c_phone"),
                                          ("part", "p_name")])
def test_high_cardinality_strings_bit_identical(table, column, sf):
    """The three plain-string columns with nearly one value a row: codes,
    first-appearance dictionary and type as the reference uploads them."""
    jt, tb = _table_pair(table, sf)
    jc = upload_table(jt.select([column])).column(column)
    tc = tb.column(column)
    n = jt.num_rows
    assert tc.values[:n].numpy().tobytes() == \
        np.asarray(jc.values)[:n].tobytes()
    assert tc.values.dtype == torch.int32 and tc.validity is None
    assert int(tc.type.id) == int(jc.type.id)
    assert list(tc.dictionary) == jc.dictionary.to_pylist()
    assert len(tc.dictionary) > n // 2


def test_plain_strings_encoded_in_first_appearance_order():
    """A plain-string column becomes int32 codes numbered in order of
    first appearance, a repeated value sharing its code."""
    from arrow_tpu_torch.io.tpch import _encode
    name, type_name, codes, validity, values = _encode(
        "s", np.array(["b", "a", "b", "c", "a"]))
    assert (name, type_name, validity) == ("s", "string", None)
    assert codes.tolist() == [0, 1, 0, 2, 1] and codes.dtype == np.int32
    assert values == ("b", "a", "c")


def test_generate_gives_all_eight_tables():
    sf = 0.002
    got = tpch.generate(sf, device="cpu")
    want = jax_tpch.generate(sf)
    assert list(got) == list(want)
    for name, batch in got.items():
        assert int(batch.row_count) == want[name].num_rows, name
        assert batch.columns[0].values.device.type == "cpu"
    assert list(got["nation"].column("n_name").dictionary) == \
        list(tpch.NATIONS)
    assert list(got["part"].column("p_brand").dictionary) == \
        list(tpch.BRANDS)


def test_generate_runs_on_the_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpch.generate(0.001)
