"""Column pruning in the port (``acero/prune.py``) against the JAX
package's ``acero/prune.py``.

* The pruned trees of all 22 TPC-H plans, walked beside the reference's:
  the same nodes, each hash join with the reference's
  ``left_output``/``right_output``, each table source with the
  reference's columns. Where the plan shares a declaration between two
  parents (Q2, Q11, Q15, Q21, Q22), the port keeps it shared and narrows
  it to the union of what its parents read, so there it may keep more
  columns than the reference's copies, never fewer.
* The cases of the reference's ``tests/test_plan_rewrites.py``: join
  outputs narrowed under a project, every join type under an aggregate,
  a collision partner kept so the suffixes do not move, dropped project
  expressions, and the pruned tree cached on the root.
* Each of the 20 plans with a join gives the same table pruned
  (``to_table()``) as unpruned, at the small SF of
  ``tests/test_torch_tpch_full.py``.
"""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import acero as jacero
from arrow_tpu.acero.prune import prune_plan as jax_prune_plan
from arrow_tpu.device.column import upload_table
from arrow_tpu.io import tpch as jax_tpch
from arrow_tpu.io import tpch_queries as jax_queries
from arrow_tpu_torch import acero as tacero
from arrow_tpu_torch.acero.exec import execute_declaration
from arrow_tpu_torch.acero.prune import output_names, prune_plan
from arrow_tpu_torch.device.column import download
from arrow_tpu_torch.io import tpch
from arrow_tpu_torch.io import tpch_queries

import test_torch_tpch_full as full
from test_torch_q1 import assert_tables_match, carry_across
from test_torch_tpch_suite import QUERIES as SUITE_QUERIES
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

SF = full.SF
# every plan -> its tables in argument order, its parameters at SF
PLANS = {"q1_plan": (("lineitem",), None),
         "q3_plan": (("customer", "orders", "lineitem"), None),
         "q4_plan": (("orders", "lineitem"), None),
         "q13_plan": (("customer", "orders"), None),
         **{q: (names, None) for q, names in SUITE_QUERIES.items()},
         **full.QUERIES}
SHARED = ("q2_plan", "q11_plan", "q15_plan", "q21_plan", "q22_plan")


@pytest.fixture(scope="module")
def tables():
    return jax_tpch.generate(SF), tpch.generate(SF, device="cpu")


def _plans(query, tables):
    jt, tt = tables
    names, params = PLANS[query]
    kw = params(tt) if params else {}
    return (getattr(jax_queries, query)(*(jt[k] for k in names), **kw),
            getattr(tpch_queries, query)(*(tt[k] for k in names), **kw))


def _walk_pair(ref, port, shared):
    """Both pruned trees in step, as trees."""
    assert ref.factory_name == port.factory_name
    if port.factory_name == "hashjoin":
        for side in ("left_output", "right_output"):
            want = getattr(ref.options, side)
            got = getattr(port.options, side)
            if shared and want is not None and got is not None:
                assert set(got) >= set(want), side
            else:
                assert got == want, side
    if port.factory_name == "table_source":
        want = list(ref.options.table.schema.names)
        got = list(port.options.batch.schema.names)
        assert set(got) >= set(want) if shared else got == want
    assert len(ref.inputs) == len(port.inputs)
    for r, p in zip(ref.inputs, port.inputs):
        _walk_pair(r, p, shared)


def _ids(decl, seen):
    seen.append(id(decl))
    for d in decl.inputs:
        _ids(d, seen)
    return seen


@pytest.mark.parametrize("query", list(PLANS))
def test_pruned_tree_matches_jax(query, tables):
    ref, port = _plans(query, tables)
    pruned = prune_plan(port)
    _walk_pair(jax_prune_plan(ref), pruned, query in SHARED)
    # a declaration shared before pruning is shared after it
    visits = _ids(port, [])
    visits_pruned = _ids(pruned, [])
    assert len(visits) - len(set(visits)) == \
        len(visits_pruned) - len(set(visits_pruned))
    assert (len(visits) > len(set(visits))) == (query in SHARED)


@pytest.mark.parametrize("query", [q for q in PLANS
                                   if q not in ("q1_plan", "q6_plan")])
def test_pruned_plan_gives_the_unpruned_table(query, tables):
    _, port = _plans(query, tables)
    got = port.to_table().to_pydict()
    assert port._pruned is not None
    want = download(execute_declaration(port))
    assert got == want
    assert len(next(iter(got.values()))) > 0


def test_plans_without_a_join_are_not_pruned(tables):
    for query in ("q1_plan", "q6_plan"):
        _, port = _plans(query, tables)
        port.to_table().to_pydict()
        assert port._pruned is None


# --- the reference's tests/test_plan_rewrites.py cases -----------------------

def _join_plan(mod, jt="inner", suffix=False):
    left = at.table({"k": [1, 2, 3, 4], "a": [10, 20, 30, 40],
                     "b": [1.0, 2.0, 3.0, 4.0]})
    right = at.table({"k": [2, 3, 5], "c": [200, 300, 500],
                      "b": [9.0, 8.0, 7.0]})
    if mod is tacero:
        left, right = (carry_across(upload_table(t)) for t in (left, right))
    return mod.Declaration("hashjoin", mod.HashJoinNodeOptions(
        jt, left_keys=["k"], right_keys=["k"],
        output_suffix_for_left="_l" if suffix else "",
        output_suffix_for_right="_r" if suffix else ""), inputs=[
            mod.Declaration("table_source", mod.TableSourceNodeOptions(t))
            for t in (left, right)])


def _both(make):
    """(reference plan, its pruned tree, port plan, its pruned tree)."""
    ref, port = make(jacero), make(tacero)
    return ref, jax_prune_plan(ref), port, prune_plan(port)


def _project(mod, exprs, names):
    return mod.Declaration("project", mod.ProjectNodeOptions(exprs, names))


def test_join_outputs_narrowed_under_a_project():
    ref, ref_p, port, port_p = _both(lambda m: m.Declaration.from_sequence([
        _join_plan(m), _project(m, [m.field("a") + m.field("c")], ["s"])]))
    _walk_pair(ref_p, port_p, False)
    j = port_p.inputs[0]
    assert (j.options.left_output, j.options.right_output) == (["a"], ["c"])
    assert output_names(j.inputs[0]) == ["k", "a"]
    assert output_names(j.inputs[1]) == ["k", "c"]
    assert_tables_match(port.to_table().to_pydict(), ref.to_table().to_pydict())


@pytest.mark.parametrize("jt", ["inner", "left outer", "full outer",
                                "left semi", "left anti"])
def test_join_types_under_an_aggregate(jt):
    ref, ref_p, port, port_p = _both(lambda m: m.Declaration.from_sequence([
        _join_plan(m, jt, suffix=True),
        m.Declaration("aggregate", m.AggregateNodeOptions(
            [("a", "sum", None, "sa")], keys=[]))]))
    _walk_pair(ref_p, port_p, False)
    assert_tables_match(port.to_table().to_pydict(), ref.to_table().to_pydict())
    assert port.to_table().to_pydict() == download(execute_declaration(port))


def test_collision_partner_kept():
    ref, ref_p, port, port_p = _both(lambda m: m.Declaration.from_sequence([
        _join_plan(m, suffix=True), _project(m, [m.field("b_l")], ["v"])]))
    _walk_pair(ref_p, port_p, False)
    j = port_p.inputs[0]
    assert "b" in j.options.left_output and "b" in j.options.right_output
    assert_tables_match(port.to_table().to_pydict(), ref.to_table().to_pydict())


def test_project_expressions_dropped():
    def make(m):
        t = at.table({"x": [1, 2, 3], "y": [4, 5, 6]})
        if m is tacero:
            t = carry_across(upload_table(t))
        return m.Declaration.from_sequence([
            m.Declaration("table_source", m.TableSourceNodeOptions(t)),
            _project(m, [m.field("x") * 2, m.field("y") * 3], ["x2", "y3"]),
            _project(m, [m.field("x2")], ["x2"])])

    ref, ref_p, port, port_p = _both(make)
    _walk_pair(ref_p, port_p, False)
    mid = port_p.inputs[0]
    assert [repr(e) for e in mid.options.expressions] == \
        [repr(port.inputs[0].options.expressions[0])]
    assert download(execute_declaration(port_p)) == port.to_table().to_pydict()


def test_residual_filter_fields_stay():
    """The residual filter's fields survive a project that reads only
    one column (the reference's ``test_join_residual.py`` pruning
    case)."""
    def make(m):
        return m.Declaration.from_sequence([
            m.Declaration("hashjoin", m.HashJoinNodeOptions(
                "inner", left_keys=["k"], right_keys=["k"],
                output_suffix_for_left="_l", output_suffix_for_right="_r",
                filter=m.field("a") < m.field("c") - 150),
                inputs=_join_plan(m).inputs),
            _project(m, [m.field("b_l")], ["bl"])])

    ref, ref_p, port, port_p = _both(make)
    _walk_pair(ref_p, port_p, False)
    assert_tables_match(port.to_table().to_pydict(), ref.to_table().to_pydict())


def test_pruned_plan_cached_on_the_root():
    port = tacero.Declaration.from_sequence([
        _join_plan(tacero), _project(tacero, [tacero.field("a")], ["a"])])
    first = port.to_table().to_pydict()
    cached = port._pruned
    assert cached is not None
    assert port.to_table().to_pydict() == first and port._pruned is cached


def test_a_join_keeps_one_column():
    """A count over a semi join reads none of its columns: the pruned
    join still keeps its key, so its batch keeps its capacity. (The
    reference prunes the join to no column, and its count then fails.)"""
    rng = np.random.default_rng(3)
    left = at.table({"k": rng.integers(0, 20, 300).tolist(),
                     "v": rng.normal(size=300).tolist()})
    right = at.table({"k": list(range(0, 20, 3))})

    def make(m, lt, rt):
        return m.Declaration.from_sequence([
            m.Declaration("hashjoin", m.HashJoinNodeOptions(
                "left semi", left_keys=["k"], right_keys=["k"]), inputs=[
                    m.Declaration("table_source",
                                  m.TableSourceNodeOptions(t))
                    for t in (lt, rt)]),
            m.Declaration("aggregate", m.AggregateNodeOptions(
                [([], "count_all", None, "n")]))])

    port = make(tacero, *(carry_across(upload_table(t))
                          for t in (left, right)))
    kept = np.isin(left.column("k").to_pylist(), list(range(0, 20, 3)))
    assert port.to_table().to_pydict() == {"n": [int(kept.sum())]} \
        == download(execute_declaration(port))
    assert port._pruned.inputs[0].options.left_output == ["k"]
