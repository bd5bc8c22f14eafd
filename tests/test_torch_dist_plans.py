"""The 22 TPC-H plans distributed: the port in four gloo ranks on the CPU
against the JAX package on ``make_mesh(4)`` of ``tests/conftest.py``'s
eight CPU devices, at the reference's ``tests/test_tpch_distributed.py``
SF 0.005 and parameters. Each package runs over its own generator's
tables (the same tables: ``test_torch_tpch_tables.py``); the ranks make
theirs on each rank. Keys, counts, validity and row order exact, floats
within rtol 1e-9, every rank the same result, the same float bits on a
second run, and ``EXCHANGE_COUNTS`` equal to the reference's: a plan that
silently ran locally, or took another path, fails."""

import pytest

from arrow_tpu.acero import dist_exec as jdist
from arrow_tpu.io import tpch as jax_tpch
from arrow_tpu.io import tpch_queries as jax_queries
from arrow_tpu.parallel import make_mesh

from test_torch_distributed import agreed
from test_torch_q1 import assert_tables_match
from torch_dist_ranks import TPCH, TPCH_KWARGS, WORLD, Ranks
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

SF = 0.005


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(str(tmp_path_factory.mktemp("ranks")), WORLD)
    yield r
    r.close()


@pytest.fixture(scope="module")
def reference():
    return jax_tpch.generate(SF), make_mesh(WORLD)


@pytest.mark.parametrize("query", list(TPCH))
def test_distributed_plan_matches_reference(ranks, reference, query):
    tables, mesh = reference
    fn, names = TPCH[query]
    kw = TPCH_KWARGS.get(query, {})
    plan = getattr(jax_queries, fn)(*(tables[n] for n in names), **kw)
    jdist.reset_exchange_counts()
    want = plan.to_table(mesh=mesh).to_pydict()
    want_counts = dict(jdist.EXCHANGE_COUNTS)
    out = ranks.run("tpch_case", query, SF, kw)
    assert out[0]["counts"] == want_counts
    assert_tables_match(agreed(out), want)


@pytest.mark.parametrize("query", ["q1", "q3", "q9", "q13"])
def test_plan_over_shard_sources(ranks, query):
    """Every table a ShardBatch (each rank holding only its rows, as a rank
    that made them would): the result and counts of the same plan over
    the whole tables, which the test above holds to the reference's."""
    out = ranks.run("tpch_shards_case", query, SF,
                    TPCH_KWARGS.get(query, {}))
    whole = [o["whole"] for o in out]
    assert out[0]["counts"] == whole[0]["counts"]
    assert_tables_match(agreed(out), agreed(whole), float_rtol=0)


def test_plan_over_host_table_sources(ranks, reference):
    """Q3 over host Tables on every rank, each rank uploading only its
    range of each table's rows (its strings coded over the whole column,
    so the ranks share one dictionary): the reference's result and
    exchange counts, and each rank's uploads its ``shard_rows`` range and
    nothing whole."""
    from arrow_tpu_torch.io.tpch_device import shard_rows
    tables, mesh = reference
    fn, names = TPCH["q3"]
    kw = TPCH_KWARGS.get("q3", {})
    plan = getattr(jax_queries, fn)(*(tables[n] for n in names), **kw)
    jdist.reset_exchange_counts()
    want = plan.to_table(mesh=mesh).to_pydict()
    want_counts = dict(jdist.EXCHANGE_COUNTS)
    out = ranks.run("tpch_host_case", "q3", SF, kw)
    assert out[0]["counts"] == want_counts
    assert_tables_match(agreed(out), want)
    for rank, o in enumerate(out):
        total = 0
        for name, (n, keys, ncols) in o["uploads"].items():
            start, stop = shard_rows(n, rank, len(out))
            assert keys == [f"cpu[{start}:{stop}]"], (rank, name, keys)
            total += (stop - start) * ncols
        assert o["upload_rows"] == total > 0, (rank, o["upload_rows"])


def test_all_22_plans():
    assert len(TPCH) == 22
    assert {fn for fn, _ in TPCH.values()} <= set(dir(jax_queries))
