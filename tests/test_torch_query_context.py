"""Per-query control of the port against the JAX package: ``QueryOptions``
and ``QueryContext`` (the reference's ``tests/test_acero.py``
``TestQueryContext`` and the query of
``tests/test_misc_components.py``'s ``TestOtelExport``, without its
exporter, which is ROADMAP item 11's), cancellation through
``StopSource``, and ``last_plan_metrics``.

The same plans run through both packages over the same data (the JAX
package's tables, uploaded and carried across as CPU batches). Results:
keys, counts and row order exact, floats within rtol 1e-9. The node lists
of the metrics must be the reference's, and so must the tracked bytes:
on these plans the two packages' node outputs have the same capacities
and dtypes (a table source at the reference's upload capacity, an
aggregate at its group bound, a join at its power-of-two class).
"""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import acero as ja
from arrow_tpu import cancel as jcancel
from arrow_tpu.acero import exec as jexec
from arrow_tpu.acero.query_context import (ArrowMemoryError as JMemoryError,
                                           QueryOptions as JOptions)
from arrow_tpu.device.column import upload_table
import arrow_tpu_torch.acero as ta
from arrow_tpu_torch import cancel
from arrow_tpu_torch.acero import exec as texec
from arrow_tpu_torch.acero.query_context import (
    ArrowMemoryError, QueryContext, QueryOptions, current_query_context,
    query_scope)

from test_torch_q1 import assert_tables_match, carry_across
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

RTOL = 1e-9


def src(mod, t):
    return mod.Declaration("table_source", mod.TableSourceNodeOptions(t))


def filter_sum(mod, s):
    return mod.Declaration.from_sequence([
        s,
        mod.Declaration("filter", mod.FilterNodeOptions(mod.field("v") > 0)),
        mod.Declaration("aggregate", mod.AggregateNodeOptions(
            [("v", "hash_sum", None, "s")], keys=["k"]))])


@pytest.fixture(scope="module")
def plans():
    """TestQueryContext._plan in both packages: (reference, port)."""
    rng = np.random.default_rng(0)
    n = 5000
    t = at.table({"k": [int(v) for v in rng.integers(0, 7, n)],
                  "v": rng.standard_normal(n)})
    return (filter_sum(ja, src(ja, t)),
            filter_sum(ta, src(ta, carry_across(upload_table(t)))))


@pytest.fixture(scope="module")
def join_plans():
    """A join under an aggregate in both packages: (reference, port)."""
    rng = np.random.default_rng(4)
    n = 3000
    left = at.table({"key": [int(v) for v in rng.integers(0, 50, n)],
                     "q": [int(v) for v in rng.integers(1, 100, n)]})
    right = at.table({"key": list(range(50)),
                      "grp": [f"g{i % 7}" for i in range(50)]})

    def make(mod, lsrc, rsrc):
        return mod.Declaration.from_sequence([
            mod.Declaration("hashjoin", mod.HashJoinNodeOptions(
                "inner", left_keys=["key"], right_keys=["key"]),
                inputs=[lsrc, rsrc]),
            mod.Declaration("aggregate", mod.AggregateNodeOptions(
                [("q", "hash_sum", None, "s")], keys=["grp"]))])
    return (make(ja, src(ja, left), src(ja, right)),
            make(ta, *[src(ta, carry_across(upload_table(t)))
                       for t in (left, right)]))


def metrics(qc):
    return [(f, b) for f, _, b in qc.node_metrics]


def test_accounting_and_metrics(plans):
    jplan, tplan = plans
    want = jplan.to_table(query_options=JOptions()).to_pydict()
    out = tplan.to_table(query_options=QueryOptions()).to_pydict()
    assert_tables_match(out, want, RTOL)
    assert len(out["k"]) == 7
    qc, jqc = tplan.last_query_context, jplan.last_query_context
    assert qc.bytes_materialized > 0
    # the filter folds into the aggregate's run: the run and the source
    # report, each with the reference's capacities and dtypes
    assert metrics(qc) == metrics(jqc)
    assert [f for f, _ in metrics(qc)] == ["table_source", "aggregate"]
    assert qc.bytes_materialized == jqc.bytes_materialized
    assert "materialized bytes" in qc.to_string()
    assert qc.to_string().count("ms dispatch") == 2


def test_memory_limit_enforced(plans):
    jplan, tplan = plans
    with pytest.raises(JMemoryError) as jerr:
        jplan.to_table(query_options=JOptions(memory_limit=128))
    with pytest.raises(ArrowMemoryError) as err:
        tplan.to_table(query_options=QueryOptions(memory_limit=128)).to_pydict()
    assert isinstance(err.value, ValueError)
    assert str(err.value) == str(jerr.value)
    assert "at node 'table_source'" in str(err.value)


def test_memory_limit_just_below_the_total_raises_at_the_last_node(plans):
    """A limit one byte under the tracked total raises at the node the
    tracking reaches it, the last."""
    _, tplan = plans
    tplan.to_table(query_options=QueryOptions()).to_pydict()
    total = tplan.last_query_context.bytes_materialized
    with pytest.raises(ArrowMemoryError, match="at node 'aggregate'"):
        tplan.to_table(query_options=QueryOptions(memory_limit=total - 1)).to_pydict()
    tplan.to_table(query_options=QueryOptions(memory_limit=total)).to_pydict()


def test_no_context_unaffected(plans):
    _, tplan = plans
    assert current_query_context() is None
    assert len(tplan.to_table().to_pydict()["k"]) == 7


def test_collect_metrics_off_still_tracks(plans):
    _, tplan = plans
    tplan.to_table(query_options=QueryOptions(collect_metrics=False)).to_pydict()
    qc = tplan.last_query_context
    assert qc.node_metrics == [] and qc.bytes_materialized > 0


def test_filter_query_context_of_misc_components():
    """The query of ``TestOtelExport._run_query``: a filter over a table
    source under ``QueryOptions``."""
    t = at.table({"a": [1, 2, 3, 4], "b": [1.0, 2.0, 3.0, 4.0]})

    def make(mod, s):
        return mod.Declaration("filter", mod.FilterNodeOptions(
            mod.field("a") > 1), inputs=[s])
    jd = make(ja, src(ja, t))
    td = make(ta, src(ta, carry_across(upload_table(t))))
    want = jd.to_table(query_options=JOptions()).to_pydict()
    out = td.to_table(query_options=QueryOptions()).to_pydict()
    assert len(out["a"]) == 3
    assert_tables_match(out, want, RTOL)
    assert metrics(td.last_query_context) == metrics(jd.last_query_context)


def test_join_plan_metrics_match_the_reference(join_plans):
    """A pruned join under an aggregate: the reference's node list and
    ``last_plan_metrics``. The join's output capacity is a power-of-two
    class in both packages, so the bytes agree too."""
    jplan, tplan = join_plans
    want = jplan.to_table(query_options=JOptions()).to_pydict()
    jnodes = [f for f, _ in jexec.last_plan_metrics.nodes]
    out = tplan.to_table(query_options=QueryOptions()).to_pydict()
    assert_tables_match(out, want, RTOL)
    tnodes = [f for f, _ in texec.last_plan_metrics.nodes]
    assert tnodes == jnodes == ["table_source", "table_source", "hashjoin",
                                "aggregate"]
    assert metrics(tplan.last_query_context) == \
        metrics(jplan.last_query_context)
    assert "ms dispatch" in texec.last_plan_metrics.to_string()


def test_last_plan_metrics_restart_each_run(plans):
    _, tplan = plans
    tplan.to_table().to_pydict()
    tplan.to_table().to_pydict()
    assert [f for f, _ in texec.last_plan_metrics.nodes] == \
        ["table_source", "aggregate"]


@pytest.fixture
def stopped():
    """The default stop source, stopped, in both packages; reset after."""
    for mod in (cancel, jcancel):
        mod.default_stop_source().request_stop()
    yield
    for mod in (cancel, jcancel):
        mod.default_stop_source().reset()


def test_cancelled_stop_source_stops_a_plan(plans, stopped):
    jplan, tplan = plans
    with pytest.raises(jcancel.CancelledError):
        jplan.to_table()
    with pytest.raises(cancel.CancelledError, match="operation cancelled"):
        tplan.to_table().to_pydict()
    assert isinstance(cancel.CancelledError("x"), RuntimeError)


def test_cancelled_stop_source_stops_a_streamed_plan(plans, stopped):
    _, tplan = plans
    with pytest.raises(cancel.CancelledError):
        tplan.to_table(chunk_rows=1000, device="cpu").to_pydict()


def test_context_stop_token_stops_after_a_node(plans):
    """A query's own stop token is polled after each node: the source runs
    and records, then the plan stops."""
    _, tplan = plans
    source = cancel.StopSource()
    source.request_stop()
    qc = QueryContext(QueryOptions(), source.token())
    with query_scope(qc):
        with pytest.raises(cancel.CancelledError):
            tplan.to_table().to_pydict()
    assert qc.node_metrics == []
    assert current_query_context() is None
    assert cancel.default_stop_token().is_stop_requested() is False


def test_stop_source_reset_and_signal_handler():
    import signal
    source = cancel.StopSource()
    token = source.token()
    assert not token.is_stop_requested()
    source.request_stop()
    assert token.is_stop_requested()
    source.reset()
    token.poll()
    previous = signal.getsignal(signal.SIGUSR1)
    try:
        assert cancel.setup_signal_stop_source((signal.SIGUSR1,)) is \
            cancel.default_stop_source()
        signal.raise_signal(signal.SIGUSR1)
        assert cancel.default_stop_token().is_stop_requested()
    finally:
        cancel.default_stop_source().reset()
        signal.signal(signal.SIGUSR1, previous)


def test_batch_nbytes_counts_values_and_validity(plans):
    _, tplan = plans
    batch = tplan.inputs[0].inputs[0].options.batch
    want = sum(c.values.numel() * c.values.element_size()
               + (0 if c.validity is None else c.validity.numel())
               for c in batch.columns)
    assert QueryContext.batch_nbytes(batch) == want == 5120 * 16


def test_acero_exports_the_query_types():
    assert ta.QueryOptions is QueryOptions
    assert ta.ArrowMemoryError is ArrowMemoryError
    assert ta.QueryContext is QueryContext
