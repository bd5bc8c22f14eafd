"""The last eleven of the JAX package's 22 TPC-H plans in the port: Q2, Q7,
Q8, Q11, Q15, Q16, Q17, Q18, Q20, Q21 and Q22 (the reference's
``tests/test_tpch_full.py``).

* Each plan through both packages over their own generators' tables at
  the reference test's SF 0.005, with the parameters that test picks so
  that the result is not empty (Q2's part size, Q8's part type, Q11's
  fraction, Q17's brand and container, Q18's quantity, Q20's nation),
  chosen here with numpy over the port's tables: keys, counts, validity
  and row order exact, floats within rtol 1e-9.
* ``chip_smoke.py``'s numpy oracles for the eleven plans (``FULL``)
  against the port on the CPU, over the tables its phase 3d uses
  (lineitem from ``q1_device_batch``) at SF 0.01, with the parameters
  its ``params`` functions pick.
"""

from collections import Counter

import numpy as np
import pytest

from arrow_tpu.io import tpch as jax_tpch
from arrow_tpu.io import tpch_queries as jax_queries
from arrow_tpu_torch.io import tpch
from arrow_tpu_torch.io import tpch_queries
from arrow_tpu_torch.io.tpch_device import q1_device_batch

import chip_smoke
from test_torch_q1 import assert_tables_match
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

SF = 0.005


@pytest.fixture(scope="module")
def tables():
    return jax_tpch.generate(SF), tpch.generate(SF, device="cpu")


def _values(batch, name):
    """A column's live rows as numpy values, dictionary codes decoded."""
    col = batch.column(name)
    v = col.values[:int(batch.row_count)].numpy()
    if col.dictionary is None:
        return v
    return np.array(col.dictionary, dtype=object)[v]


def _mode(values):
    """The most common value, the least of them on a tie (pandas'
    ``mode().iloc[0]``)."""
    counts = Counter(values.tolist())
    top = max(counts.values())
    return min(v for v, c in counts.items() if c == top)


def _q2(t):
    brass = np.array([v.endswith("BRASS") for v in _values(t["part"],
                                                           "p_type")])
    return {"size": int(_mode(_values(t["part"], "p_size")[brass]))}


def _q8(t):
    return {"p_type": _mode(_values(t["part"], "p_type"))}


def _q17(t):
    """The most common (brand, container) pair, the least on a tie
    (pandas' ``groupby(...).size().idxmax()``)."""
    counts = Counter(zip(_values(t["part"], "p_brand"),
                         _values(t["part"], "p_container")))
    top = max(counts.values())
    brand, container = min(k for k, n in counts.items() if n == top)
    return {"brand": brand, "container": container}


def _q20(t):
    """The nation of the first supplier that Q20 would keep over all
    nations."""
    cols = chip_smoke._full_columns(t)
    return {"nation_name": chip_smoke.q20_params(t, cols)["nation_name"]}


# plan -> (its tables in argument order, its parameters from the tables)
QUERIES = {
    "q2_plan": (("part", "supplier", "partsupp", "nation", "region"), _q2),
    "q7_plan": (("supplier", "lineitem", "orders", "customer", "nation"),
                None),
    "q8_plan": (("part", "supplier", "lineitem", "orders", "customer",
                 "nation", "region"), _q8),
    "q11_plan": (("partsupp", "supplier", "nation"),
                 lambda t: {"fraction": 0.005}),
    "q15_plan": (("lineitem", "supplier"), None),
    "q16_plan": (("partsupp", "part", "supplier"), None),
    "q17_plan": (("lineitem", "part"), _q17),
    "q18_plan": (("customer", "orders", "lineitem"),
                 lambda t: {"quantity": 150.0}),
    "q20_plan": (("supplier", "nation", "partsupp", "part", "lineitem"),
                 _q20),
    "q21_plan": (("supplier", "lineitem", "orders", "nation"), None),
    "q22_plan": (("customer", "orders"), None),
}


@pytest.mark.parametrize("query", list(QUERIES))
def test_query_matches_jax(query, tables):
    jt, tt = tables
    names, params = QUERIES[query]
    kw = params(tt) if params else {}
    want = getattr(jax_queries, query)(*(jt[k] for k in names), **kw) \
        .to_table().to_pydict()
    got = getattr(tpch_queries, query)(*(tt[k] for k in names),
                                       **kw).to_table().to_pydict()
    assert_tables_match(got, want)
    assert len(next(iter(got.values()))) > 0
    assert all(v is not None for col in got.values() for v in col)


def test_port_has_all_22_plans():
    names = {n for n in dir(jax_queries) if n.startswith("q")
             and n.endswith("_plan")}
    assert len(names) == 22
    assert names <= set(dir(tpch_queries))


# --- chip_smoke.py's oracles -------------------------------------------------

@pytest.fixture(scope="module")
def smoke_tables():
    """The tables phase 3d uses, at SF 0.01."""
    t = tpch.generate(0.01, device="cpu")
    t["lineitem"], _ = q1_device_batch(0.01, device="cpu")
    return t, chip_smoke._full_columns(t)


# At SF 0.01 the only customer without orders whose balance is above the
# mean has country code 24, which Q22's default codes leave out.
_SMALL_SF_PARAMS = {"Q22": {"codes": ("13", "31", "23", "29", "30", "18",
                                      "17", "24")}}


@pytest.mark.parametrize("query", chip_smoke.FULL, ids=lambda q: q.name)
def test_chip_smoke_oracle_matches_port(query, smoke_tables):
    t, cols = smoke_tables
    kw = query.params(t, cols) if query.params else {}
    kw.update(_SMALL_SF_PARAMS.get(query.name, {}))
    want, n_rows = query.oracle(t, cols, **kw)
    assert n_rows > 0
    got = chip_smoke.suite_plan(query, t, kw).to_table().to_pydict()
    assert len(next(iter(got.values()))) > 0
    chip_smoke.check_result(query.name, got, want)


def test_shared_declaration_runs_once(tables, monkeypatch):
    """Q2 uses the partsupp of the region's suppliers (three joins) twice:
    it runs once, so its five distinct joins run five times, not eight,
    and both parents read one batch. ``to_table()`` runs the pruned tree,
    and pruning keeps the declaration shared, one object under both
    parents."""
    from arrow_tpu_torch.acero import exec as texec
    _, tt = tables
    calls = []
    run = texec._execute_hashjoin

    def counted(options, *args):
        calls.append(options.join_type)
        return run(options, *args)

    monkeypatch.setattr(texec, "_execute_hashjoin", counted)
    names, params = QUERIES["q2_plan"]
    got = tpch_queries.q2_plan(*(tt[k] for k in names), **params(tt))
    assert len(got.to_table().to_pydict()["p_partkey"]) > 0
    assert len(calls) == 5
    parents = Counter()

    def walk(d, seen):
        for x in d.inputs:
            parents[id(x)] += 1
            if id(x) not in seen:
                seen.add(id(x))
                walk(x, seen)
    walk(got._pruned, set())
    assert got._pruned is not got and max(parents.values()) == 2
