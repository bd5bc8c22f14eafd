"""String columns and string casts in plans, and ``chip_smoke.py``'s phase
3i at SF 0.01 on the CPU.

* Each phase 3i path (``chip_smoke.REST_PATHS``) against its numpy oracle,
  as phase 3i holds the port on the card: hashes, keys, counts, codes and
  row order exact, floats within rtol 1e-9, ``rank_normal`` within
  ``chip_smoke.NDTRI_TOL`` of ``statistics.NormalDist().inv_cdf``.
* The same plan over customer through both packages' ``Declaration``s:
  ``is_null``, ``is_valid``, ``is_nan`` (false on every valid row: the
  codes are no floats, as in the reference), ``index_in`` and ``cast``
  of a string column (each distinct value parsed once), a filter on a
  comparison against a column whose rows are all null, and the cast of a
  literal inside an expression; values, validity and order exact, sums
  within rtol 1e-9. The port's column has an empty dictionary; the
  reference uploads an all-null string column with the dictionary
  ``['']`` (its translation raises TypeError on an empty one), so both
  compare all-null columns.
* Beside the reference, kept on purpose: a projection of a cast literal
  broadcasts (the reference's plan raises IndexError); ``coalesce`` and
  ``if_else`` of two string columns give the reference's eager answer
  (its plan mixes the codes), checked by phase 3i's oracle above.
* ``hash32`` of phase 3i's columns takes its kernel's plain version here
  and launches nothing (the card-only comparisons of ``hash32`` and
  ``indices_nonzero`` are in ``test_torch_kernels_cuda.py``).
"""

import pytest
import torch

import arrow_tpu.acero as jacero
import arrow_tpu.compute.extra_kernels  # noqa: F401 - registers its names

import chip_smoke
import arrow_tpu_torch.acero as tacero
from arrow_tpu_torch.compute.hashing import column_words
from arrow_tpu_torch.device.column import DeviceBatch, DeviceColumn
from arrow_tpu_torch.io import tpch
from arrow_tpu_torch.io.tpch_device import q1_device_batch
from arrow_tpu_torch.kernels.hash32 import hash32, hash32_plain

from test_torch_q1 import assert_tables_match
from test_torch_typed_plans import _to_reference

SF = 0.01


@pytest.fixture(scope="module")
def rest():
    lineitem, _ = q1_device_batch(SF, device="cpu")
    tables = {"lineitem": lineitem}
    for name in ("part", "customer"):
        tables[name] = getattr(tpch, f"{name}_table")(SF, device="cpu")
    typed = chip_smoke.typed_tables(lineitem, tables["part"])
    s = chip_smoke.rest_inputs(tables, typed)
    return s, chip_smoke.rest_columns(s)


@pytest.mark.parametrize("path", chip_smoke.REST_PATHS,
                         ids=lambda p: p.name)
def test_path_matches_its_oracle(rest, path):
    s, cols = rest
    assert path.check(cols, path.run(s))


def test_grouped_moments_repeat_their_bits(rest):
    s, _ = rest
    first, second = chip_smoke.rest_repeats(s), chip_smoke.rest_repeats(s)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))


def test_hash32_takes_the_plain_version_on_the_cpu(rest):
    s, _ = rest
    for name in chip_smoke.HASH_COLUMNS:
        words = column_words(s["typed"].column(name))
        assert torch.equal(hash32(words), hash32_plain(words))
    assert hash32.launches == 0


def _customer_plan(ac, source, keys=None):
    """The comparable part of phase 3i's customer plan in either package:
    a filter on the all-null column or a positive balance, the country
    code parsed from the phone, the segment's null and float predicates
    and index, a cast literal added to the balance; grouped by the code
    where ``keys``."""
    D, f, call = ac.Declaration, ac.field, ac.Expression.call
    code = call("cast", call("utf8_slice_codeunits", f("c_phone"), start=0,
                             stop=2), to_type="int32")
    decls = [
        D("table_source", ac.TableSourceNodeOptions(source)),
        D("filter", ac.FilterNodeOptions(
            (f("c_empty") == "x") | (f("c_acctbal") > 0.0))),
        D("project", ac.ProjectNodeOptions(
            [code, f("c_acctbal") + call("cast", 2.5, to_type="int32",
                                         safe=False),
             call("is_null", f("c_segment")),
             call("is_valid", f("c_segment")),
             call("is_nan", f("c_segment")),
             call("index_in", f("c_segment"),
                  value_set=chip_smoke.SEGMENT_SET),
             f("c_empty") < "m", f("c_segment")],
            ["code", "balance", "seg_null", "seg_valid", "seg_nan",
             "seg_index", "empty_less", "c_segment"]))]
    if keys:
        decls.append(D("aggregate", ac.AggregateNodeOptions(
            [(None, "count_all", None, "n"),
             ("balance", "hash_sum", None, "balance"),
             ("seg_null", "hash_sum", None, "nulls"),
             ("seg_index", "hash_count", None, "indexed"),
             ("c_segment", "hash_min", None, "first_seg")], keys=keys)))
    return D.from_sequence(decls)


def _reference_customer(batch):
    """The customer inputs as a reference Table: the all-null column with
    the dictionary ``['']`` the reference's upload gives it."""
    cols = [DeviceColumn(c.values, c.validity, c.type, ("",))
            if c.dictionary == () else c for c in batch.columns]
    return _to_reference(DeviceBatch(batch.schema, cols, batch.row_count))


@pytest.mark.parametrize("keys", [None, ["code"]], ids=["rows", "grouped"])
def test_customer_plan_matches_jax(rest, keys):
    s, _ = rest
    assert s["customer"].column("c_empty").dictionary == ()
    got = _customer_plan(tacero, s["customer"], keys).to_table()
    want = _customer_plan(jacero, _reference_customer(s["customer"]),
                          keys).to_table().to_pydict()
    assert len(got["code"]) > 0
    assert set(got.get("seg_nan", [False])) <= {False, None}
    assert_tables_match(got, want)


def test_a_cast_literal_broadcasts_in_a_projection(rest):
    """Kept on purpose: the reference's plan raises IndexError on the 0-d
    column a cast literal gives."""
    s, _ = rest
    D, call = tacero.Declaration, tacero.Expression.call
    out = D.from_sequence([
        D("table_source", tacero.TableSourceNodeOptions(s["customer"])),
        D("project", tacero.ProjectNodeOptions(
            [call("cast", 7, to_type="float32")], ["seven"]))]).to_table()
    n = int(s["customer"].row_count)
    assert out["seven"] == [7.0] * n
    with pytest.raises(IndexError):
        jD, jcall = jacero.Declaration, jacero.Expression.call
        jD.from_sequence([
            jD("table_source", jacero.TableSourceNodeOptions(
                _reference_customer(s["customer"]))),
            jD("project", jacero.ProjectNodeOptions(
                [jcall("cast", 7, to_type="float32")],
                ["seven"]))]).to_table()


def test_functions_of_values_refuse_string_columns(rest):
    """What is left of the plans' refusal: a function of the values."""
    s, _ = rest
    D, f = tacero.Declaration, tacero.field
    with pytest.raises(NotImplementedError, match="codes are not values"):
        D.from_sequence([
            D("table_source", tacero.TableSourceNodeOptions(s["customer"])),
            D("project", tacero.ProjectNodeOptions(
                [f("c_segment") + 1], ["x"]))]).to_table()
