"""The element-wise functions the TPC-H suite adds, against the JAX
package on the same numpy inputs made from a seed.

* Projected literals take the reference's dtype: a float is f64, an int
  int64, a bool bool.
* ``divide``: integers truncate toward zero in their own dtype and type (a
  date32 column over an int stays date32, Q9's ``o_year``), floats divide
  as IEEE does; a zero integer divisor on a live row raises, on a null or
  dead row it does not. ``/`` of expressions is ``divide``.
* An int column with a float literal computes in f64, as under JAX's x64.
* ``if_else``: branch validity, int and float literal branches, and a
  dictionary column on both branches keeping its dictionary.
* ``is_in``: numeric and dictionary columns, a null in the value set,
  ``skip_nulls``, and the plan form, where a null row stays null.
* ``match_substring``, ``starts_with`` and ``ends_with`` on a
  dictionary-coded column with null rows, through plans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import acero as jacero
from arrow_tpu.compute.elementwise import ErrGuard
from arrow_tpu.compute.registry import ExecContext as JaxExecContext
from arrow_tpu.compute.registry import get_function as jax_get_function
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu.device.column import download_table, upload_table
from arrow_tpu.table import Table
from arrow_tpu_torch import acero as tacero
from arrow_tpu_torch import types as TT
from arrow_tpu_torch.acero.exec import execute_declaration
from arrow_tpu_torch.compute.registry import ExecContext, get_function
from arrow_tpu_torch.device.column import DeviceColumn

from test_torch_q1 import assert_tables_match, carry_across
from test_torch_q4_q13 import _strings_table
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

N = 600
_TYPES = {"int64": (np.int64, at.int64(), TT.int64()),
          "int32": (np.int32, at.int32(), TT.int32()),
          "f64": (np.float64, at.float64(), TT.float64()),
          "date32": (np.int32, at.date32(), TT.date32()),
          "bool": (np.bool_, at.bool_(), TT.bool_())}


def _column(rng, kind, null_share=0.1, lo=-50, hi=50):
    dtype = _TYPES[kind][0]
    if kind == "f64":
        values = rng.normal(0.0, 30.0, N)
    elif kind == "bool":
        values = rng.random(N) < 0.5
    else:
        values = rng.integers(lo, hi, N).astype(dtype)
    valid = rng.random(N) >= null_share
    return kind, np.where(valid, values, np.zeros((), dtype)).astype(dtype), \
        valid


def _both(col):
    """A (kind, values, validity) triple as a JAX and a port column; a
    Python scalar stays as it is."""
    if not isinstance(col, tuple):
        return col, col
    kind, values, valid = col
    _, jtype, ttype = _TYPES[kind]
    return (JaxDeviceColumn(jnp.asarray(values), jnp.asarray(valid), jtype),
            DeviceColumn(torch.from_numpy(values), torch.from_numpy(valid),
                         ttype))


def _call(fn, *cols, live=N, **options):
    """(JAX result, port result) of ``fn`` over the same inputs."""
    pairs = [_both(c) for c in cols]
    want = jax_get_function(fn).impl(JaxExecContext(N, jnp.int32(live)),
                                      *[p[0] for p in pairs], **options)
    got = get_function(fn).impl(ExecContext(N, torch.tensor(live)),
                                *[p[1] for p in pairs], **options)
    return want, got


def assert_columns_match(got, want):
    """Values, validity (None where the reference has none) and type."""
    if isinstance(want, ErrGuard):
        want = want.result
    assert int(got.type.id) == int(want.type.id)
    assert (got.validity is None) == (want.validity is None)
    if want.validity is not None:
        np.testing.assert_array_equal(got.validity.numpy(),
                                      np.asarray(want.validity))
    w = np.asarray(want.values)
    g = got.values.numpy()
    assert g.dtype == w.dtype
    np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, equal_nan=True)


# --- projected literals ------------------------------------------------------

@pytest.mark.parametrize("value", [1.5, 7, np.int64(1), np.float64(2.5),
                                   True], ids=repr)
def test_projected_literal_dtype(value):
    table = Table.from_pydict({"k": at.array(np.arange(5), at.int64())})

    def plan(mod, batch):
        return mod.Declaration.from_sequence([
            mod.Declaration("table_source",
                            mod.TableSourceNodeOptions(batch)),
            mod.Declaration("project", mod.ProjectNodeOptions(
                [mod.field("k"), mod.Expression.literal(value)],
                ["k", "lit"]))])

    want = download_table(jacero.exec.execute_declaration(plan(jacero,
                                                               table)))
    out = execute_declaration(plan(tacero, carry_across(upload_table(table))))
    col = out.column("lit")
    want_dtype = np.asarray(value).dtype
    assert col.values.numpy().dtype == want_dtype
    assert int(col.type.id) == int(want.schema.field("lit").type.id)
    assert want.column("lit").to_pylist() == [value] * 5
    assert col.values[:5].tolist() == [value] * 5


def test_float_literal_promotes_an_int_column_to_f64():
    rng = np.random.default_rng(1)
    for fn in ("multiply", "add", "subtract"):
        want, got = _call(fn, _column(rng, "int32"), 1.5)
        assert got.values.dtype == torch.float64
        assert_columns_match(got, want)
    want, got = _call("less", _column(rng, "int32"), 2.5)
    assert_columns_match(got, want)


# --- divide ------------------------------------------------------------------

_DIVIDE_CASES = {
    "int64 by int64": (("int64", -60, 60), ("int64", 1, 9)),
    "int64 by negative literal": (("int64", -60, 60), -7),
    "date32 by literal": (("date32", 8035, 10561), 365),
    "literal by int64": (1000, ("int64", 1, 40)),
    "f64 by f64": (("f64",), ("f64",)),
    "int64 by f64 literal": (("int64", -60, 60), 2.5),
}


@pytest.mark.parametrize("case", list(_DIVIDE_CASES))
def test_divide_matches_jax(case):
    rng = np.random.default_rng(list(_DIVIDE_CASES).index(case))
    args = []
    for spec in _DIVIDE_CASES[case]:
        if isinstance(spec, tuple):
            kind, *bounds = spec
            args.append(_column(rng, kind, 0.1, *bounds))
        else:
            args.append(spec)
    want, got = _call("divide", *args)
    assert_columns_match(got, want)
    if case == "date32 by literal":
        assert got.type == TT.date32()
        assert got.values.dtype == torch.int32


def test_expression_true_divide():
    """``a / b`` and ``1.0 / b`` of expressions call divide (the
    reference's expressions have no ``__rtruediv__``, so its side calls
    divide by name)."""
    rng = np.random.default_rng(4)
    table = Table.from_pydict({
        "a": at.array(rng.normal(0, 5, 50), at.float64()),
        "b": at.array(rng.normal(3, 1, 50), at.float64())})

    def plan(mod, batch):
        f = mod.field
        return mod.Declaration.from_sequence([
            mod.Declaration("table_source",
                            mod.TableSourceNodeOptions(batch)),
            mod.Declaration("project", mod.ProjectNodeOptions(
                [f("a") / f("b"), mod.Expression.call("divide", 1.0, f("b")),
                 f("a") * 100.0 / f("b")], ["q", "r", "p"]))])

    assert repr(1.0 / tacero.field("b")) == \
        repr(tacero.Expression.call("divide", 1.0, tacero.field("b")))
    want = plan(jacero, table).to_table().to_pydict()
    got = plan(tacero, carry_across(upload_table(table))).to_table().to_pydict()
    assert_tables_match(got, want)


@pytest.mark.parametrize("divisor", ["literal", "column"])
def test_integer_divide_by_zero_raises(divisor):
    rng = np.random.default_rng(5)
    a = _column(rng, "int64", 0.0)
    if divisor == "literal":
        b = 0
    else:
        kind, values, valid = _column(rng, "int64", 0.0, 1, 9)
        values[17] = 0
        b = (kind, values, valid)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    guard = jax_get_function("divide").impl(
        JaxExecContext(N, jnp.int32(N)), ja, jb)
    assert bool(guard.flag)
    with pytest.raises(ZeroDivisionError):
        get_function("divide").impl(ExecContext(N, torch.tensor(N)), ta, tb)


def test_zero_divisor_on_null_or_dead_rows_does_not_raise():
    rng = np.random.default_rng(6)
    kind, values, valid = _column(rng, "int64", 0.0, 1, 9)
    values[3], valid[3] = 0, False          # a null row
    values[N - 1] = 0                       # a dead row
    want, got = _call("divide", _column(rng, "int64", 0.0),
                      (kind, values, valid), live=N - 1)
    assert not bool(want.flag)
    assert_columns_match(got, want)


# --- if_else -----------------------------------------------------------------

_IF_ELSE_CASES = {
    "columns with nulls": ("f64", "f64"),
    "int literals": (1, 0),
    "column and float literal": ("f64", 0.0),
    "int64 columns": ("int64", "int64"),
}


@pytest.mark.parametrize("case", list(_IF_ELSE_CASES))
def test_if_else_matches_jax(case):
    rng = np.random.default_rng(list(_IF_ELSE_CASES).index(case) + 10)
    cond = _column(rng, "bool", 0.15)
    branches = [_column(rng, b, 0.2) if isinstance(b, str) else b
                for b in _IF_ELSE_CASES[case]]
    want, got = _call("if_else", cond, *branches)
    assert_columns_match(got, want)
    if case == "int literals":
        assert got.values.dtype == torch.int64


def test_if_else_keeps_a_shared_dictionary():
    table = _strings_table(np.random.default_rng(12))

    def plan(mod, batch):
        f = mod.field
        return mod.Declaration.from_sequence([
            mod.Declaration("table_source",
                            mod.TableSourceNodeOptions(batch)),
            mod.Declaration("project", mod.ProjectNodeOptions(
                [f("k"), mod.Expression.call("if_else", f("k") < 300,
                                             f("s"), f("s"))],
                ["k", "s2"]))])

    want = plan(jacero, table).to_table().to_pydict()
    got = plan(tacero, carry_across(upload_table(table))).to_table().to_pydict()
    assert_tables_match(got, want)
    assert None in got["s2"]


# --- is_in -------------------------------------------------------------------

@pytest.mark.parametrize("value_set", [[3, 7, 11], [3, None, 7], []],
                         ids=["plain", "null in set", "empty set"])
@pytest.mark.parametrize("skip_nulls", [False, True])
def test_is_in_numeric_matches_jax(value_set, skip_nulls):
    rng = np.random.default_rng(20)
    want, got = _call("is_in", _column(rng, "int64", 0.2, 0, 15),
                      value_set=value_set, skip_nulls=skip_nulls)
    assert_columns_match(got, want)


@pytest.mark.parametrize("value_set", [["abc", "a%c"], ["abc", None], []],
                         ids=["plain", "null in set", "empty set"])
def test_is_in_dictionary_matches_jax(value_set):
    """The registered function and the plan form (a null row stays null
    there) on a dictionary-coded column with null rows."""
    table = _strings_table(np.random.default_rng(21))
    jb = upload_table(table)
    tb = carry_across(jb)
    jcol, tcol = jb.column("s"), tb.column("s")
    n = table.num_rows
    want = jax_get_function("is_in").impl(
        JaxExecContext(jb.capacity, jnp.int32(n)), jcol, value_set=value_set)
    got = get_function("is_in").impl(
        ExecContext(tb.capacity, torch.tensor(n)), tcol, value_set=value_set)
    np.testing.assert_array_equal(got.values[:n].numpy(),
                                  np.asarray(want.values)[:n])
    assert got.validity is None and want.validity is None

    def plan(mod, batch):
        return mod.Declaration.from_sequence([
            mod.Declaration("table_source",
                            mod.TableSourceNodeOptions(batch)),
            mod.Declaration("project", mod.ProjectNodeOptions(
                [mod.field("k"), mod.Expression.call(
                    "is_in", mod.field("s"), value_set=value_set)],
                ["k", "hit"]))])

    want = plan(jacero, table).to_table().to_pydict()
    got = plan(tacero, tb).to_table().to_pydict()
    assert_tables_match(got, want)
    assert None in got["hit"]


# --- string predicates -------------------------------------------------------

@pytest.mark.parametrize("pattern,ignore_case", [
    ("special", False), ("Special", True), ("c%", False), ("", False),
    ("requests", False)])
@pytest.mark.parametrize("fn", ["match_substring", "starts_with",
                                "ends_with"])
def test_string_predicates_match_jax(fn, pattern, ignore_case):
    """The registered functions on the uploaded column, and the plan form
    where the reference's evaluator honours ``ignore_case`` (it drops it
    for ``match_substring``; the port does not)."""
    table = _strings_table(np.random.default_rng(len(pattern) + 30))
    jb = upload_table(table)
    tb = carry_across(jb)
    n = table.num_rows
    want = jax_get_function(fn).impl(
        JaxExecContext(jb.capacity, jnp.int32(n)), jb.column("s"),
        pattern=pattern, ignore_case=ignore_case)
    got = get_function(fn).impl(None, tb.column("s"), pattern=pattern,
                                ignore_case=ignore_case)
    np.testing.assert_array_equal(got.values[:n].numpy(),
                                  np.asarray(want.values)[:n])
    np.testing.assert_array_equal(got.validity[:n].numpy(),
                                  np.asarray(want.validity)[:n])
    assert not got.validity[:n].all()
    if ignore_case and fn == "match_substring":
        return

    def plan(mod, batch):
        call = mod.Expression.call(fn, mod.field("s"), pattern=pattern,
                                   ignore_case=ignore_case)
        return mod.Declaration.from_sequence([
            mod.Declaration("table_source",
                            mod.TableSourceNodeOptions(batch)),
            mod.Declaration("project", mod.ProjectNodeOptions(
                [mod.field("k"), call, ~call], ["k", "m", "not_m"]))])

    assert_tables_match(plan(tacero, tb).to_table().to_pydict(),
                        plan(jacero, table).to_table().to_pydict())


def test_string_predicates_need_a_dictionary_column():
    col = DeviceColumn(torch.arange(4), None, TT.int64())
    for fn in ("match_substring", "starts_with", "ends_with"):
        with pytest.raises(NotImplementedError,
                           match="requires a string column"):
            get_function(fn).impl(None, col, pattern="a")
