"""The SQL and Gandiva frontends (``arrow_tpu_torch/sql.py``,
``arrow_tpu_torch/gandiva.py``) against the JAX package's on the same
Tables, carried across by their buffers.

* ``tests/test_sql.py``'s cases but the Flight SQL ones (Flight is not
  ported): each query through both packages, the same Table, and the
  reference test's own expectations;
* its TPC-H texts (Q1, Q6, Q12 with CASE, Q14, Q18 with HAVING, a semi
  join with EXTRACT and SUBSTRING) at SF 0.002, against the reference's
  answers and the port's Declaration forms;
* ``chip_smoke.py``'s SQL Q1, Q6 and Q3 (written lineitem first) at SF
  0.01 against the reference's SQL and the port's ``q1_plan``,
  ``q6_plan`` and ``q3_plan``; Q3 written customer first fails in both
  packages, as the SQL join drops the right-hand keys;
* ``tests/test_interop_json_gandiva.py::test_gandiva_projector_filter``,
  and the Filter's ``SelectionVector`` (found on the device) against the
  reference's on seeded values with nulls.
"""

import datetime

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import gandiva as jgandiva
from arrow_tpu import sql as jsql
from arrow_tpu.acero import field as jfield
from arrow_tpu.io import tpch as jtpch
from arrow_tpu.io import tpch_queries as jq
from arrow_tpu_torch import gandiva, sql
from arrow_tpu_torch.acero import field
from arrow_tpu_torch.io import tpch_queries as tq

import chip_smoke
from test_torch_host_table import carry_table
from test_torch_q1 import assert_tables_match
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


@pytest.fixture(scope="module")
def db():
    orders = at.table({"o_id": [1, 2, 3, 4], "cust": ["x", "y", "x", "z"],
                       "total": [10.0, 20.0, 30.0, None],
                       "day": at.array([datetime.date(2021, 1, i + 1)
                                        for i in range(4)])})
    items = at.table({"o_id": [1, 1, 2, 3],
                      "amount": [5.0, 7.0, 11.0, 13.0]})
    more = at.table({"o_id": [1, 99], "v": [100, 200]})
    ref = {"orders": orders, "items": items, "more": more}
    return ref, {k: carry_table(v) for k, v in ref.items()}


def both(db, text):
    """(the port's answer, the reference's) of ``text``, as dicts."""
    ref, port = db
    want = jsql.query(text, ref).to_pydict()
    got = sql.query(text, port, device="cpu").to_pydict()
    assert got == want, (text, got, want)
    return got


def test_select_star_where(db):
    assert both(db, "SELECT * FROM orders WHERE total > 15")["o_id"] == \
        [2, 3]


def test_projection_alias_order_limit(db):
    assert both(db, "SELECT cust, total * 2 AS dbl FROM orders "
                    "ORDER BY total DESC LIMIT 2") == \
        {"cust": ["x", "y"], "dbl": [60.0, 40.0]}


def test_group_by_aggregates(db):
    d = both(db, "SELECT cust, sum(total) AS s, count(*) AS n, "
                 "avg(total) AS a FROM orders GROUP BY cust ORDER BY cust")
    assert d["cust"] == ["x", "y", "z"]
    assert d["s"] == [40.0, 20.0, None]
    assert d["n"] == [2, 1, 1]


def test_join(db):
    assert both(db, "SELECT o_id, amount, cust FROM items "
                    "JOIN orders ON items.o_id = orders.o_id "
                    "WHERE amount BETWEEN 6 AND 12") == \
        {"o_id": [1, 2], "amount": [7.0, 11.0], "cust": ["x", "y"]}


def test_left_join(db):
    assert both(db, "SELECT o_id, v FROM more LEFT JOIN orders ON "
                    "more.o_id = orders.o_id ORDER BY o_id")["o_id"] == \
        [1, 99]


@pytest.mark.parametrize("text,col,want", [
    ("SELECT cust FROM orders WHERE cust IN ('x', 'z') AND total IS NOT "
     "NULL", "cust", ["x", "x"]),
    ("SELECT o_id FROM orders WHERE total IS NULL", "o_id", [4]),
    ("SELECT cust FROM orders WHERE cust LIKE 'x%'", "cust", ["x", "x"]),
    ("SELECT o_id FROM orders WHERE day >= DATE '2021-01-03'", "o_id",
     [3, 4]),
    ("SELECT count(distinct cust) AS c FROM orders", "c", [3]),
    ("SELECT o_id FROM orders ORDER BY o_id LIMIT 2 OFFSET 1", "o_id",
     [2, 3]),
    # CASE lowers to if_else, whose null condition gives null in both
    # packages (SQL's CASE would take the ELSE branch)
    ("SELECT o_id, CASE WHEN total > 15 THEN 1 ELSE 0 END AS big FROM "
     "orders ORDER BY o_id", "big", [0, 1, 1, None]),
    ("SELECT cust, count(*) AS n FROM orders GROUP BY cust "
     "HAVING count(*) > 1", "cust", ["x"]),
    ("SELECT o_id FROM orders WHERE NOT (o_id < 3) OR cust = 'y'", "o_id",
     [2, 3, 4]),
    ("SELECT o_id FROM orders SEMI JOIN items ON orders.o_id = items.o_id",
     "o_id", [1, 2, 3]),
    ("SELECT o_id FROM orders ANTI JOIN items ON orders.o_id = items.o_id",
     "o_id", [4]),
    ("SELECT extract(day FROM day) AS d FROM orders WHERE "
     "day < DATE '2021-01-01' + INTERVAL '2' day", "d", [1, 2]),
])
def test_predicates_and_clauses(db, text, col, want):
    assert both(db, text)[col] == want


def test_parse_errors(db):
    _, port = db
    with pytest.raises(ValueError):
        sql.query("SELECT FROM orders", port, device="cpu")
    with pytest.raises(KeyError):
        sql.query("SELECT * FROM nope", port, device="cpu")
    with pytest.raises(ValueError):
        sql.declaration("SELECT o_id FROM orders WHERE o_id @ 3", port)


def test_the_card_is_the_default(db):
    _, port = db
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sql.query("SELECT * FROM orders", port)


# --- the reference's TPC-H texts ---------------------------------------------

@pytest.fixture(scope="module")
def tpch_small():
    ref = jtpch.generate(0.002)
    return ref, {k: carry_table(v) for k, v in ref.items()}


_TEXTS = {
    "q12": ("""
        select l_shipmode,
               sum(case when o_orderpriority = '1-URGENT'
                         or o_orderpriority = '2-HIGH'
                    then 1 else 0 end) as high_line_count,
               sum(case when o_orderpriority <> '1-URGENT'
                        and o_orderpriority <> '2-HIGH'
                    then 1 else 0 end) as low_line_count
        from lineitem
        join orders on l_orderkey = o_orderkey
        where l_receiptdate >= date '1994-01-01'
          and l_receiptdate < date '1995-01-01'
          and l_shipmode in ('MAIL', 'SHIP')
        group by l_shipmode
        order by l_shipmode""", ("lineitem", "orders"),
        lambda m, t: m.q12_style_plan(t["orders"], t["lineitem"])),
    "q14": ("""
        select 100.00 * sum(case when p_type like 'PROMO%'
                then l_extendedprice * (1 - l_discount)
                else 0 end)
            / sum(l_extendedprice * (1 - l_discount))
            as promo_revenue
        from lineitem
        join part on l_partkey = p_partkey
        where l_shipdate >= date '1995-09-01'
          and l_shipdate < date '1995-09-01' + interval '30' day""",
            ("lineitem", "part"),
            lambda m, t: m.q14_plan(t["lineitem"], t["part"])),
    "q18": ("""
        select l_orderkey, sum(l_quantity) as sum_qty
        from lineitem
        group by l_orderkey
        having sum(l_quantity) > 150
        order by sum_qty desc, l_orderkey
        limit 100""", ("lineitem",), None),
    "semi_extract_substring": ("""
        select extract(year from o_orderdate) as y,
               substring(o_orderpriority from 1 for 1) as pri,
               count(*) as n
        from orders
        semi join lineitem on o_orderkey = l_orderkey
        group by y, pri
        order by y, pri
        limit 5""", ("orders", "lineitem"), None),
    "q1": (chip_smoke.SQL_Q1, ("lineitem",),
           lambda m, t: m.q1_plan(t["lineitem"])),
    "q6": (chip_smoke.SQL_Q6, ("lineitem",),
           lambda m, t: m.q6_plan(t["lineitem"])),
}


@pytest.mark.parametrize("name", sorted(_TEXTS))
def test_tpch_text_matches_the_reference(tpch_small, name):
    ref, port = tpch_small
    text, names, form = _TEXTS[name]
    want = jsql.query(text, {k: ref[k] for k in names})
    got = sql.query(text, {k: port[k] for k in names}, device="cpu")
    assert got.num_rows == want.num_rows > 0
    assert_tables_match(got, want.to_pydict())
    if form is not None:
        # the port's SQL against its own Declaration form, and the
        # reference's SQL against the reference's (the reference test)
        assert_tables_match(got, form(tq, port).to_table(
            device="cpu").to_pydict())
        assert_tables_match(want.to_pydict(),
                            form(jq, ref).to_table().to_pydict())
    if name == "q18":
        d = port["lineitem"].to_pydict()
        sums = {}
        for k, v in zip(d["l_orderkey"], d["l_quantity"]):
            sums[k] = sums.get(k, 0.0) + v
        exp = sorted(((k, s) for k, s in sums.items() if s > 150),
                     key=lambda kv: (-kv[1], kv[0]))[:100]
        assert got.column("l_orderkey").to_pylist() == [k for k, _ in exp]
    if name == "semi_extract_substring":
        assert got.column_names == ["y", "pri", "n"]
        assert all(1992 <= y <= 1998 for y in got.column("y").to_pylist())


# --- chip_smoke's Q1, Q6 and Q3 at SF 0.01 -----------------------------------

@pytest.fixture(scope="module")
def tpch_01():
    names = ("lineitem", "orders", "customer")
    ref = {k: getattr(jtpch, f"{k}_table")(0.01) for k in names}
    return ref, {k: carry_table(v) for k, v in ref.items()}


_PHASE = {"Q1": (chip_smoke.SQL_Q1, lambda m, t: m.q1_plan(t["lineitem"])),
          "Q6": (chip_smoke.SQL_Q6, lambda m, t: m.q6_plan(t["lineitem"])),
          "Q3": (chip_smoke.SQL_Q3, lambda m, t: m.q3_plan(
              t["customer"], t["orders"], t["lineitem"]))}


@pytest.mark.parametrize("name", sorted(_PHASE))
def test_phase_3n_sql_at_sf_001(tpch_01, name):
    ref, port = tpch_01
    text, form = _PHASE[name]
    got = sql.query(text, port, device="cpu")
    want = jsql.query(text, ref).to_pydict()
    assert got.num_rows == len(next(iter(want.values()))) > 0
    assert_tables_match(got, want)
    assert_tables_match(got, form(tq, port).to_table(
        device="cpu").to_pydict())


def test_q3_written_customer_first_fails_in_both(tpch_01):
    """The SQL join drops the right-hand keys (``right_output``) in both
    packages, so a join naming a key of a table joined earlier on the
    right fails: Q3 must be written lineitem first."""
    ref, port = tpch_01
    text = chip_smoke.SQL_Q3.replace(
        """from lineitem
    join orders on l_orderkey = o_orderkey
    join customer on o_custkey = c_custkey""",
        """from customer
    join orders on c_custkey = o_custkey
    join lineitem on l_orderkey = o_orderkey""")
    assert "from customer" in text
    with pytest.raises(KeyError, match="l_orderkey|o_orderkey"):
        jsql.query(text, ref)
    with pytest.raises(KeyError, match="l_orderkey|o_orderkey"):
        sql.query(text, port, device="cpu")


# --- Gandiva -----------------------------------------------------------------

def test_gandiva_projector_filter():
    rb_ref = at.record_batch({"a": [1.0, 2.0, 3.0], "b": [10.0, 20.0, 30.0]})
    rb = carry_table(rb_ref).to_batches()[0]
    proj = gandiva.make_projector(rb.schema, [
        (field("a") + field("b"), "sum"),
        gandiva.TreeExprBuilder.make_expression(field("a") * 2.0, "dbl"),
    ])
    out = proj.evaluate(rb, device="cpu")
    assert out[0].to_pylist() == [11.0, 22.0, 33.0]
    assert out[1].to_pylist() == [2.0, 4.0, 6.0]
    filt = gandiva.make_filter(rb.schema, gandiva.TreeExprBuilder.make_and(
        [field("a") > 1.0, field("b") < 30.0]))
    sel = filt.evaluate(rb, device="cpu")
    assert sel.to_array().to_pylist() == [1]
    assert proj.evaluate(rb, selection=sel,
                         device="cpu")[0].to_pylist() == [22.0]
    # the cache: the same schema and expressions give the same object
    assert gandiva.make_filter(rb.schema, gandiva.TreeExprBuilder.make_and(
        [field("a") > 1.0, field("b") < 30.0])) is filt
    # compiled once, evaluated over many batches
    rb2 = carry_table(at.record_batch({"a": [5.0, 6.0, 7.0],
                                       "b": [1.0, 1.0, 1.0]})).to_batches()[0]
    assert proj.evaluate(rb2, device="cpu")[0].to_pylist() == [6.0, 7.0, 8.0]
    assert "add" in gandiva.get_registered_function_signatures()
    # the reference on the same batch
    jproj = jgandiva.make_projector(rb_ref.schema, [
        (jfield("a") + jfield("b"), "sum")])
    assert jproj.evaluate(rb_ref)[0].to_pylist() == out[0].to_pylist()


@pytest.mark.parametrize("kind", ["RecordBatch", "Table"])
def test_gandiva_uploads_a_batch_once(kind):
    """A projector and a filter over the same batch share its columns'
    uploads with every table source over it (``acero/source_cache.py``):
    only the first evaluation uploads, and a release frees them."""
    from arrow_tpu_torch import acero as tacero
    from arrow_tpu_torch.acero import source_cache
    ref = at.table({"a": [1.0, 2.0, 3.0], "b": [10.0, 20.0, 30.0]})
    tbl = carry_table(ref)
    data = tbl.to_batches()[0] if kind == "RecordBatch" else tbl
    proj = gandiva.make_projector(data.schema, [(field("a") * 2.0, "dbl")])
    filt = gandiva.make_filter(data.schema, field("b") > 15.0)
    source_cache.reset_upload_stats()
    assert proj.evaluate(data, device="cpu")[0].to_pylist() == \
        [2.0, 4.0, 6.0]
    # both columns' three rows
    assert source_cache.UPLOAD_STATS["rows"] == 6
    sel = filt.evaluate(data, device="cpu")
    assert proj.evaluate(data, selection=sel,
                         device="cpu")[0].to_pylist() == [4.0, 6.0]
    tacero.Declaration("table_source", tacero.TableSourceNodeOptions(
        data)).to_table(device="cpu")
    assert source_cache.UPLOAD_STATS["rows"] == 6
    tacero.release_uploads(data)
    assert filt.evaluate(data, device="cpu").to_array().to_pylist() == \
        jgandiva.make_filter(ref.schema, jfield("b") > 15.0).evaluate(
            ref.to_batches()[0]).to_array().to_pylist() == [1, 2]
    assert source_cache.UPLOAD_STATS["rows"] == 12


@pytest.mark.parametrize("seed", [1, 2])
def test_gandiva_selection_matches_the_reference(seed):
    """A condition with null rows: null is not selected; the positions,
    uint32, equal the reference's, and the projection under them too."""
    rng = np.random.default_rng(seed)
    n = 3000
    x = [None if rng.random() < 0.1 else float(v)
         for v in rng.normal(size=n)]
    y = [int(v) for v in rng.integers(0, 10, n)]
    rb_ref = at.record_batch({"x": at.array(x), "y": at.array(y)})
    rb = carry_table(rb_ref).to_batches()[0]
    cond = lambda f: (f("x") > 0.25) | (f("y") == 3)  # noqa: E731
    want = jgandiva.make_filter(rb_ref.schema, cond(jfield)).evaluate(rb_ref)
    got = gandiva.make_filter(rb.schema, cond(field)).evaluate(
        rb, device="cpu")
    assert got.indices.dtype == np.uint32
    np.testing.assert_array_equal(got.indices, want.indices)
    exprs = lambda f: [(f("x") * 2.0, "x2"), (f("y") + 1, "y1")]  # noqa
    w = jgandiva.make_projector(rb_ref.schema, exprs(jfield)).evaluate(
        rb_ref, selection=want)
    g = gandiva.make_projector(rb.schema, exprs(field)).evaluate(
        rb, selection=got, device="cpu")
    assert [a.to_pylist() for a in g] == [a.to_pylist() for a in w]
    with pytest.raises(IndexError):
        gandiva.make_projector(rb.schema, exprs(field)).evaluate(
            rb, selection=gandiva.SelectionVector([n]), device="cpu")


def test_chip_smoke_gandiva_oracle_matches_the_port():
    """Phase 3n's numpy oracles of the Gandiva paths against the port at
    SF 0.01 on the CPU."""
    from arrow_tpu_torch.io import tpch
    from arrow_tpu_torch.table import RecordBatch
    from arrow_tpu_torch.types import Schema
    li = tpch.generate_host(0.01)["lineitem"]
    cols = chip_smoke.GANDIVA_COLUMNS
    rb = RecordBatch(Schema([li.schema.field(c) for c in cols]),
                     [li.column(c).combine() for c in cols])
    sel = gandiva.make_filter(rb.schema, chip_smoke.q6_condition()).evaluate(
        rb, device="cpu")
    np.testing.assert_array_equal(sel.indices,
                                  np.nonzero(chip_smoke.q6_mask(li))[0])
    dp, charge = chip_smoke.gandiva_oracle(rb)
    disc_price = field("l_extendedprice") * (1.0 - field("l_discount"))
    out = gandiva.make_projector(rb.schema, [
        (disc_price, "d"), (disc_price * (1.0 + field("l_tax")), "c")
    ]).evaluate(rb, selection=sel, device="cpu")
    np.testing.assert_allclose(out[0].to_numpy(), dp[sel.indices],
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(out[1].to_numpy(), charge[sel.indices],
                               rtol=1e-9, atol=0)
