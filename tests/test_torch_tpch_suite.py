"""The JAX package's own TPC-H suite in the port: Q6, Q10-style,
Q12-style, Q5 and the Q9-style multi-way join (``tests/test_tpch.py``'s
plans), with Q14 and Q19.

* Each query through both packages over their own generators' tables at
  SF 0.002 (the reference suite's size, where Q9 already joins a few
  hundred lineitems to partsupp) and 0.01: keys, counts, validity and row
  order exact, floats within rtol 1e-9.
* Q14 over an empty shipping window: both scalar sums are null, and so is
  their ratio, not NaN. Q9's ``o_year`` stays a date32 column.
* The joins the suite leans on, against the JAX package: two int64 keys
  with unique build pairs (Q5's ``(l_suppkey, c_nationkey)``, Q9's
  ``(l_partkey, l_suppkey)``) with the bloom prefilter on and off, and a
  build side that is itself a join (Q5's nation joined to a region).
* ``chip_smoke.py``'s numpy oracles for the seven queries against the
  port on the CPU, over the tables phase 3c uses (lineitem from
  ``q1_device_batch``).
"""

import datetime

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import acero as jacero
from arrow_tpu.device.column import upload_table
from arrow_tpu.io import tpch as jax_tpch
from arrow_tpu.io import tpch_queries as jax_queries
from arrow_tpu.table import Table
from arrow_tpu_torch import acero as tacero
from arrow_tpu_torch.acero.exec import execute_declaration
from arrow_tpu_torch.io import tpch
from arrow_tpu_torch.io import tpch_queries
from arrow_tpu_torch.io.tpch_device import q1_device_batch
from arrow_tpu_torch.types import TypeId

import chip_smoke
from test_torch_q1 import assert_tables_match, carry_across
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

# query -> the tables it takes, in its plan's argument order
QUERIES = {
    "q6_plan": ("lineitem",),
    "q10_style_plan": ("customer", "orders", "lineitem"),
    "q12_style_plan": ("orders", "lineitem"),
    "q5_plan": ("customer", "orders", "lineitem", "supplier", "nation",
                "region"),
    "q9_style_plan": ("part", "supplier", "lineitem", "partsupp", "orders",
                      "nation"),
    "q14_plan": ("lineitem", "part"),
    "q19_plan": ("lineitem", "part"),
}
SCALE_FACTORS = (0.002, 0.01)
_TABLES = {}


def _tables(sf):
    """(the JAX package's tables, the port's) at ``sf``, made once."""
    if sf not in _TABLES:
        _TABLES[sf] = (jax_tpch.generate(sf), tpch.generate(sf, device="cpu"))
    return _TABLES[sf]


@pytest.mark.parametrize("sf", SCALE_FACTORS)
@pytest.mark.parametrize("query", list(QUERIES))
def test_query_matches_jax(query, sf):
    jt, tt = _tables(sf)
    names = QUERIES[query]
    want = getattr(jax_queries, query)(*(jt[k] for k in names)) \
        .to_table().to_pydict()
    got = getattr(tpch_queries, query)(*(tt[k] for k in names)).to_table().to_pydict()
    assert_tables_match(got, want)
    rows = len(next(iter(got.values())))
    assert rows > 0 and all(v is not None for col in got.values()
                            for v in col)
    if query == "q9_style_plan":
        assert rows > 50 and got["nation"] == sorted(got["nation"])
    if query == "q5_plan":
        assert set(got["n_name"]) <= {"INDIA", "INDONESIA", "JAPAN", "CHINA",
                                      "VIETNAM"}


def test_q14_empty_window_is_null():
    jt, tt = _tables(0.002)
    after = tpch_queries.DATE_1995_09_01 + 20 * 365
    want = jax_queries.q14_plan(jt["lineitem"], jt["part"], after) \
        .to_table().to_pydict()
    got = tpch_queries.q14_plan(tt["lineitem"], tt["part"], after).to_table().to_pydict()
    assert got == {"promo_revenue": [None]}
    assert_tables_match(got, want)


def test_q9_year_is_date32():
    _, tt = _tables(0.002)
    out = execute_declaration(tpch_queries.q9_style_plan(
        *(tt[k] for k in QUERIES["q9_style_plan"])))
    col = out.column("o_year")
    assert col.type.id == TypeId.DATE32 and col.dictionary is None
    years = tacero.Declaration("table_source", tacero.TableSourceNodeOptions(
        out)).to_table().to_pydict()["o_year"]
    assert all(isinstance(y, datetime.date) for y in years)
    assert {y.toordinal() - datetime.date(1970, 1, 1).toordinal()
            for y in years} <= set(range(22, 29))


# --- the joins the suite leans on --------------------------------------------

def _pair_tables(rng, n_probe=6000, n_build=1000):
    """A probe side of (a, b) pairs, a third of them in the build side,
    and a build side of unique (a, b) pairs, as partsupp's rows give
    lineitem's (partkey, suppkey)."""
    pairs = np.unique(np.stack([rng.integers(1, 400, 3 * n_build),
                                rng.integers(1, 50, 3 * n_build)], 1),
                      axis=0)[:n_build]
    rng.shuffle(pairs)
    take = rng.integers(0, 3 * len(pairs), n_probe)
    probe_pairs = np.where((take < len(pairs))[:, None],
                           pairs[np.minimum(take, len(pairs) - 1)],
                           np.stack([rng.integers(1, 400, n_probe),
                                     rng.integers(50, 60, n_probe)], 1))
    probe = Table.from_pydict({
        "a": at.array(probe_pairs[:, 0], at.int64()),
        "b": at.array(probe_pairs[:, 1], at.int64()),
        "v": at.array(rng.normal(size=n_probe), at.float64())})
    build = Table.from_pydict({
        "a2": at.array(pairs[:, 0], at.int64()),
        "b2": at.array(pairs[:, 1], at.int64()),
        "w": at.array(np.arange(len(pairs)), at.int64())})
    return probe, build


@pytest.mark.parametrize("bloom", [True, False], ids=["bloom", "no_bloom"])
@pytest.mark.parametrize("jt", ["inner", "left semi", "left outer"])
def test_two_key_join_matches_jax(jt, bloom):
    probe, build = _pair_tables(np.random.default_rng(40))

    def plan(mod, p, b):
        src = mod.Declaration
        return src("hashjoin", mod.HashJoinNodeOptions(
            jt, left_keys=["a", "b"], right_keys=["a2", "b2"],
            disable_bloom_filter=not bloom), inputs=[
                src("table_source", mod.TableSourceNodeOptions(p)),
                src("table_source", mod.TableSourceNodeOptions(b))])

    tp = carry_across(upload_table(probe))
    tb = carry_across(upload_table(build))
    assert tp.capacity >= 4 * tb.capacity  # the bloom engages when asked
    want = plan(jacero, probe, build).to_table().to_pydict()
    got = plan(tacero, tp, tb).to_table().to_pydict()
    assert_tables_match(got, want)
    assert 0 < len(got["a"]) < probe.num_rows or jt == "left outer"


def test_join_whose_build_side_is_a_join():
    """Q5's shape: a probe side joins nation-within-region, itself a join
    whose build side is filtered; then a grouped sum by the dictionary
    column that came through both joins."""
    rng = np.random.default_rng(41)
    jt, _ = _tables(0.002)
    n = 3000
    facts = Table.from_pydict({
        "nk": at.array(rng.integers(0, 25, n), at.int64()),
        "v": at.array(rng.normal(100, 10, n), at.float64())})

    def plan(mod, facts, nation, region):
        src = mod.Declaration
        f = mod.field

        def source(t):
            return src("table_source", mod.TableSourceNodeOptions(t))

        reg = src.from_sequence([source(region), src(
            "filter", mod.FilterNodeOptions(f("r_name") == "EUROPE"))])
        nat = src("hashjoin", mod.HashJoinNodeOptions(
            "inner", left_keys=["n_regionkey"], right_keys=["r_regionkey"],
            right_output=[]), inputs=[source(nation), reg])
        return src.from_sequence([
            src("hashjoin", mod.HashJoinNodeOptions(
                "inner", left_keys=["nk"], right_keys=["n_nationkey"],
                right_output=["n_name"]), inputs=[source(facts), nat]),
            src("aggregate", mod.AggregateNodeOptions(
                [("v", "sum", None, "total")], keys=["n_name"])),
            src("order_by", mod.OrderByNodeOptions([("n_name",
                                                     "ascending")]))])

    want = plan(jacero, facts, jt["nation"], jt["region"]) \
        .to_table().to_pydict()
    got = plan(tacero, carry_across(upload_table(facts)),
               tpch.nation_table(device="cpu"),
               tpch.region_table(device="cpu")).to_table().to_pydict()
    assert got["n_name"] == ["FRANCE", "GERMANY", "ROMANIA", "RUSSIA",
                             "UNITED KINGDOM"]
    assert_tables_match(got, want)


# --- chip_smoke.py's oracles -------------------------------------------------

@pytest.fixture(scope="module")
def smoke_tables():
    """The suite's tables as phase 3c makes them, at SF 0.01."""
    tables = tpch.generate(0.01, device="cpu")
    tables["lineitem"], _ = q1_device_batch(0.01, device="cpu")
    return tables, chip_smoke._suite_columns(tables)


@pytest.mark.parametrize("query", chip_smoke.SUITE, ids=lambda q: q.name)
def test_chip_smoke_oracle_matches_port(query, smoke_tables):
    tables, cols = smoke_tables
    want, n_rows = query.oracle(tables, cols)
    assert n_rows > 0
    chip_smoke.check_result(
        query.name, chip_smoke.suite_plan(query, tables).to_table().to_pydict(), want)
