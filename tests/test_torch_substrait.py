"""The Substrait frontend (``arrow_tpu_torch/substrait.py``) against the JAX
package's ``arrow_tpu/substrait.py``: for the same Declaration over the
same Table (carried across by its buffers) the port's ``serialize_plan``
gives the reference's bytes, and ``run_query`` of them gives the
reference's answer; ``tests/test_substrait.py``'s cases, those that run
pyarrow's own Substrait consumer behind ``importorskip``; the schema and
expression interchange, the function mapping; and the departures: a sort
of an aggregate's measure decodes (the reference's consumer loses the
measures' names and fails), dictionary columns do not serialize in
either package."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import acero as jacero
import arrow_tpu.substrait as jsub
from arrow_tpu_torch import acero as tacero
import arrow_tpu_torch.substrait as sub
from arrow_tpu_torch.compute.registry import ArrowInvalid

from test_torch_host_table import carry_table, port_schema
from test_torch_q1 import assert_tables_match
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

_DATA = {"a": [1, 2, 3, 4, 5], "b": [1.5, 2.5, 3.5, 4.5, 5.5],
         "s": ["x", "y", "x", "z", "y"]}


def _tables():
    ref = at.table(_DATA)
    return ref, carry_table(ref)


def _src(mod, t, name=None):
    o = mod.TableSourceNodeOptions(t)
    if name is not None:
        o.substrait_name = name
    return mod.Declaration("table_source", o)


# each plan made of a package's acero module and its Table(s)
_PLANS = {
    "read": lambda m, t: _src(m, t),
    "filter": lambda m, t: m.Declaration(
        "filter", m.FilterNodeOptions(m.field("a") > 2), inputs=[_src(m, t)]),
    "project": lambda m, t: m.Declaration("project", m.ProjectNodeOptions(
        [m.field("a") + m.field("a"),
         m.field("b") * m.Expression.literal(2.0)], names=["a2", "b2"]),
        inputs=[_src(m, t)]),
    "sort_fetch": lambda m, t: m.Declaration(
        "fetch", m.FetchNodeOptions(1, 3), inputs=[m.Declaration(
            "order_by", m.OrderByNodeOptions([("a", "descending")]),
            inputs=[_src(m, t)])]),
    "aggregate": lambda m, t: m.Declaration(
        "aggregate", m.AggregateNodeOptions(
            [("a", "sum", None, "a_sum"), ("b", "mean", None, "b_mean"),
             ("a", "max", None, "a_max")], keys=["s"]),
        inputs=[_src(m, t)]),
    "trig_log": lambda m, t: m.Declaration("project", m.ProjectNodeOptions(
        [m.Expression.call("sin", m.field("b")),
         m.Expression.call("ln", m.field("b"))], ["sin_b", "ln_b"]),
        inputs=[_src(m, t)]),
    "kleene_and": lambda m, t: m.Declaration("filter", m.FilterNodeOptions(
        m.Expression.call("and_kleene", m.field("a") > 1,
                          m.field("b") < 5.0)), inputs=[_src(m, t)]),
    "variance": lambda m, t: m.Declaration(
        "aggregate", m.AggregateNodeOptions(
            [("b", "variance", {"ddof": 1}, "v")], keys=[]),
        inputs=[_src(m, t)]),
    "string_upper": lambda m, t: m.Declaration(
        "project", m.ProjectNodeOptions(
            [m.Expression.call("utf8_upper", m.field("s"))], ["u"]),
        inputs=[_src(m, t)]),
    "count_min": lambda m, t: m.Declaration(
        "aggregate", m.AggregateNodeOptions(
            [("a", "count", None, "n"), ("b", "min", None, "lo")],
            keys=["s"]), inputs=[m.Declaration(
                "filter", m.FilterNodeOptions(m.field("b") >= 2.0),
                inputs=[_src(m, t)])]),
}


@pytest.mark.parametrize("name", sorted(_PLANS))
def test_same_bytes_and_answer_as_the_reference(name):
    ref, port = _tables()
    want_blob = jsub.serialize_plan(_PLANS[name](jacero, ref))
    blob = sub.serialize_plan(_PLANS[name](tacero, port))
    assert blob == want_blob
    want = jsub.run_query(want_blob, lambda n, s: ref).to_pydict()
    got = sub.run_query(blob, lambda n, s: port, device="cpu").to_pydict()
    if name == "aggregate":
        assert sorted(zip(*got.values())) == sorted(zip(*want.values()))
    else:
        assert_tables_match(got, want)
    # and the plan run as a Declaration gives the same rows
    direct = _PLANS[name](tacero, port).to_table(device="cpu").to_pydict()
    assert list(direct.values()) == list(got.values()) or \
        name == "aggregate"


@pytest.mark.parametrize("name", ["read", "filter", "project", "sort_fetch",
                                  "aggregate", "kleene_and", "trig_log",
                                  "variance"])
def test_pyarrows_consumer_runs_the_ports_bytes(name):
    pa = pytest.importorskip("pyarrow")
    ps = pytest.importorskip("pyarrow.substrait")
    _, port = _tables()
    blob = sub.serialize_plan(_PLANS[name](tacero, port))
    ours = sub.run_query(blob, lambda n, s: port, device="cpu").to_pydict()
    theirs = ps.run_query(pa.py_buffer(blob), table_provider=lambda n, s=None:
                          pa.table(_DATA)).read_all().to_pydict()
    if name == "aggregate":
        assert sorted(zip(*ours.values())) == sorted(zip(*theirs.values()))
    elif name == "trig_log":
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k])
    elif name == "variance":
        # the reference's consumer maps the option the other way round
        # (its test says so): only its acceptance is compared
        np.testing.assert_allclose(ours["v"], [2.5])
        assert len(theirs["v"]) == 1
    else:
        assert ours == theirs


def _join_tables():
    lt = at.table({"k": [1, 2, 3, 4], "lv": [10, 20, 30, 40]})
    rt = at.table({"k": [2, 3], "rv": [200, 300]})
    return (lt, rt), (carry_table(lt), carry_table(rt))


def _join(m, lt, rt):
    return m.Declaration("hashjoin", m.HashJoinNodeOptions(
        join_type="inner", left_keys=["k"], right_keys=["k"]),
        inputs=[_src(m, lt, "left"), _src(m, rt, "right")])


def test_join():
    (jl, jr), (pl, pr) = _join_tables()
    names = ["k", "lv", "k2", "rv"]
    blob = sub.serialize_plan(_join(tacero, pl, pr), output_names=names)
    assert blob == jsub.serialize_plan(_join(jacero, jl, jr),
                                       output_names=names)
    got = sub.run_query(blob, lambda n, s: pl if n == ["left"] else pr,
                        device="cpu").to_pydict()
    want = jsub.run_query(blob, lambda n, s: jl if n == ["left"]
                          else jr).to_pydict()
    assert got == want
    pa = pytest.importorskip("pyarrow")
    ps = pytest.importorskip("pyarrow.substrait")
    theirs = ps.run_query(
        pa.py_buffer(blob), table_provider=lambda n, s=None: pa.table(
            {"k": [1, 2, 3, 4], "lv": [10, 20, 30, 40]}) if list(n) == [
                "left"] else pa.table({"k": [2, 3], "rv": [200, 300]})
    ).read_all().to_pydict()
    assert got == theirs


def test_set_union_all_roundtrip():
    t1, t2 = at.table({"x": [1, 2, 3], "y": [1.0, 2.0, 3.0]}), \
        at.table({"x": [4, 5], "y": [4.0, 5.0]})
    p1, p2 = carry_table(t1), carry_table(t2)

    def plan(m, a, b):
        return m.Declaration("union", None, inputs=[_src(m, a, "t0"),
                                                    _src(m, b, "t1")])
    blob = sub.serialize_plan(plan(tacero, p1, p2))
    assert blob == jsub.serialize_plan(plan(jacero, t1, t2))
    out = sub.run_query(blob, lambda n, s: p1 if n[-1] == "t0" else p2,
                        device="cpu")
    assert sorted(out.to_pydict()["x"]) == [1, 2, 3, 4, 5]


def test_unsupported_rel_and_garbage_raise():
    with pytest.raises(ArrowInvalid):
        sub.run_query(b"\x1a\x04\x12\x02\x4a\x00", lambda n, s: None,
                      device="cpu")
    with pytest.raises(Exception):
        sub.run_query(b"\xff\xff\xff\xff\x01", lambda n, s: None,
                      device="cpu")


def test_dictionary_columns_have_no_mapping_in_either_package():
    ref = at.table({"d": at.array(["a", "b"]).dictionary_encode()
                    if hasattr(at.Array, "dictionary_encode") else
                    at.array(["a", "b"], at.dictionary(at.int32(),
                                                       at.string()))})
    port = carry_table(ref)
    with pytest.raises(Exception, match="no substrait mapping"):
        jsub.serialize_plan(_src(jacero, ref))
    with pytest.raises(ArrowInvalid, match="no substrait mapping"):
        sub.serialize_plan(_src(tacero, port))


def test_a_sort_of_a_measure_decodes():
    """An aggregate's measures keep their names in the port's decoder, so
    a sort by one decodes and runs; the reference's consumer keeps only
    the keys and fails on the same bytes."""
    rng = np.random.default_rng(1)
    li = at.table({"k": rng.integers(0, 20, 200).tolist(),
                   "v": rng.random(200).tolist()})
    port = carry_table(li)

    def plan(m, t):
        return m.Declaration.from_sequence([
            _src(m, t),
            m.Declaration("aggregate", m.AggregateNodeOptions(
                [("v", "sum", None, "total")], keys=["k"])),
            m.Declaration("order_by", m.OrderByNodeOptions(
                [("total", "descending")])),
            m.Declaration("fetch", m.FetchNodeOptions(0, 5))])
    blob = sub.serialize_plan(plan(tacero, port))
    assert blob == jsub.serialize_plan(plan(jacero, li))
    got = sub.run_query(blob, lambda n, s: port, device="cpu").to_pydict()
    assert_tables_match(got, plan(jacero, li).to_table().to_pydict())
    with pytest.raises(IndexError):
        jsub.run_query(blob, lambda n, s: li)


class TestExpressionInterchange:
    def test_schema_roundtrip(self):
        sch = at.schema([at.field("a", at.int64()),
                         at.field("s", at.string())])
        s = sub.serialize_schema(port_schema(sch))
        r = jsub.serialize_schema(sch)
        assert (s.schema, s.expression) == (r.schema, r.expression)
        assert sub.deserialize_schema(s.schema).names == ["a", "s"]
        with pytest.raises(ImportError, match="substrait"):
            s.to_pysubstrait()

    def test_schema_interop_with_pyarrow(self):
        pa = pytest.importorskip("pyarrow")
        psub = pytest.importorskip("pyarrow.substrait")
        s = sub.serialize_schema(port_schema(at.schema(
            [at.field("a", at.int64()), at.field("s", at.string())])))
        assert psub.deserialize_schema(s.schema).names == ["a", "s"]
        theirs = psub.serialize_schema(
            pa.schema([("x", pa.float64())])).schema
        assert sub.deserialize_schema(theirs).names == ["x"]

    def test_expressions_both_directions(self):
        sch = at.schema([at.field("a", at.int64())])
        f = tacero.field
        buf = sub.serialize_expressions([f("a") > 1, f("a") + 2],
                                        ["gt", "plus"], port_schema(sch))
        assert buf == jsub.serialize_expressions(
            [jacero.field("a") > 1, jacero.field("a") + 2], ["gt", "plus"],
            sch)
        be = sub.deserialize_expressions(buf)
        assert list(be.expressions) == ["gt", "plus"]
        t = carry_table(at.table({"a": [0, 2, 5]}))
        assert t.filter(be.expressions["gt"], device="cpu").column(
            "a").to_pylist() == [2, 5]
        one = tacero.Expression.from_substrait(
            (f("a") > 1).to_substrait(port_schema(sch)))
        assert one.equals(f("a") > 1)

    def test_pyarrows_expressions_decode(self):
        pa = pytest.importorskip("pyarrow")
        ppc = pytest.importorskip("pyarrow.compute")
        psub = pytest.importorskip("pyarrow.substrait")
        pbuf = psub.serialize_expressions(
            [ppc.field("a") > 1], ["gt"], pa.schema([("a", pa.int64())]))
        ours = sub.deserialize_expressions(bytes(pbuf))
        assert list(ours.expressions) == ["gt"]
        pbuf = psub.serialize_expressions(
            [ppc.field("a") + ppc.field("a")], ["x"],
            pa.schema([("a", pa.int64())]))
        assert sub.deserialize_expressions(
            bytes(pbuf)).expressions["x"].fn == "add_checked"

    def test_checked_arith_overflow_option(self):
        E = tacero.Expression
        sch = port_schema(at.schema([at.field("a", at.int64())]))
        buf = sub.serialize_expressions(
            [E.call("add_checked", E.field("a"), E.literal(1))], ["x"], sch)
        assert sub.deserialize_expressions(buf).expressions["x"].fn == \
            "add_checked"

    def test_extract_year_roundtrip(self):
        E = tacero.Expression
        sch = port_schema(at.schema([at.field("ts", at.timestamp("us"))]))
        buf = sub.serialize_expressions(
            [E.call("year", E.field("ts"))], ["y"], sch)
        assert sub.deserialize_expressions(buf).expressions["y"].fn == "year"

    def test_round_mode_decode(self):
        E = tacero.Expression
        e = sub._decode_scalar_call("round", [E.field("a")], [],
                                    {"rounding": ["FLOOR"]})
        assert e.fn == "round" and e.options["round_mode"] == "down"
        e2 = sub._decode_scalar_call("round", [E.field("a"), E.literal(2)],
                                     [], {})
        assert e2.options["ndigits"] == 2

    def test_string_option_lifting(self):
        E = tacero.Expression
        f = E.field("s")
        e = sub._decode_scalar_call(
            "substring", [f, E.literal(2), E.literal(3)], [], {})
        assert e.fn == "utf8_slice_codeunits"
        assert e.options == {"start": 1, "stop": 4}
        e = sub._decode_scalar_call("contains", [f, E.literal("ab")], [], {})
        assert e.fn == "match_substring" and e.options["pattern"] == "ab"
        e = sub._decode_scalar_call(
            "replace", [f, E.literal("a"), E.literal("b")], [], {})
        assert e.fn == "replace_substring"
        assert sub._decode_scalar_call("trim", [f], [], {}).fn == \
            "utf8_trim_whitespace"
        e = sub._decode_scalar_call("trim", [f, E.literal("xy")], [], {})
        assert e.fn == "utf8_trim" and e.options["characters"] == "xy"

    def test_if_then_decode(self):
        from arrow_tpu_torch.substrait import (PB, _dec_expr,
                                               _enc_field_ref, _enc_literal,
                                               fm, fv)
        sch = port_schema(at.schema([at.field("a", at.int64())]))
        cond = fm(3, fv(1, 1) + fm(4, fm(3, _enc_field_ref(0)))
                  + fm(4, fm(3, _enc_literal(2))))
        clause = fm(1, cond) + fm(2, _enc_literal(10))
        ifthen = fm(4, fm(1, clause) + fm(2, _enc_literal(20)))
        expr = _dec_expr(PB(ifthen), sch, {1: "gt"})
        assert expr.fn == "if_else"
        t = carry_table(at.table({"a": [1, 5]}))
        out = tacero.Declaration("project", tacero.ProjectNodeOptions(
            [expr], ["r"]), inputs=[_src(tacero, t)]).to_table(device="cpu")
        assert out.column("r").to_pylist() == [20, 10]

    def test_singular_or_list_decode(self):
        from arrow_tpu_torch.substrait import (PB, _dec_expr,
                                               _enc_field_ref, _enc_literal,
                                               fm)
        sch = port_schema(at.schema([at.field("a", at.int64())]))
        sol = fm(7, fm(1, _enc_field_ref(0)) + fm(2, _enc_literal(2))
                 + fm(2, _enc_literal(4)))
        expr = _dec_expr(PB(sol), sch, {})
        t = carry_table(at.table({"a": [1, 2, 3, 4]}))
        assert t.filter(expr, device="cpu").column("a").to_pylist() == [2, 4]

    def test_supported_functions_equal_the_reference(self):
        fns = sub.get_supported_functions()
        assert fns == jsub.get_supported_functions()
        assert len(fns) > 70
        names = {f.split("#")[1] for f in fns}
        for want in ("sin", "atan2", "log2", "extract", "round",
                     "substring", "bitwise_and", "coalesce", "is_nan",
                     "variance", "first", "last"):
            assert want in names, want


# --- chip_smoke's two plans at SF 0.01 ---------------------------------------

@pytest.fixture(scope="module")
def tpch_01():
    from arrow_tpu.io import tpch as jtpch
    ref = {k: getattr(jtpch, f"{k}_table")(0.01)
           for k in ("lineitem", "orders")}
    return ref, {k: carry_table(v) for k, v in ref.items()}


def test_phase_3n_q6_bytes_equal_the_reference(tpch_01):
    """Q6 over lineitem's dictionary-free columns: the same bytes as the
    reference's (889), the same revenue as the reference's q6_plan."""
    import chip_smoke
    from arrow_tpu.io import tpch_queries as jq
    from arrow_tpu_torch.io import tpch_queries as tq
    ref, port = tpch_01
    cols = list(chip_smoke.SUBSTRAIT_Q6)
    rl, pl = ref["lineitem"].select(cols), port["lineitem"].select(cols)
    blob = sub.serialize_plan(tq.q6_plan(pl))
    assert blob == jsub.serialize_plan(jq.q6_plan(rl))
    assert len(blob) == 889
    got = sub.run_query(blob, lambda n, s: pl, device="cpu")
    assert_tables_match(got, jq.q6_plan(rl).to_table().to_pydict())


def test_phase_3n_join_matches_its_declaration(tpch_01):
    """The Q3-shaped join of phase 3n through Substrait at SF 0.01: the
    reference's bytes, the reference's Declaration's answer."""
    import chip_smoke
    ref, port = tpch_01
    lc, oc = chip_smoke.SUBSTRAIT_JOIN

    def plan(m, li, od):
        return m.Declaration.from_sequence([
            m.Declaration("hashjoin", m.HashJoinNodeOptions(
                "inner", left_keys=["l_orderkey"],
                right_keys=["o_orderkey"]),
                [_src(m, li, "lineitem"), _src(m, od, "orders")]),
            m.Declaration("project", m.ProjectNodeOptions(
                [m.field("o_orderdate"),
                 m.field("l_extendedprice") * (1.0 - m.field("l_discount"))],
                ["o_orderdate", "volume"])),
            m.Declaration("aggregate", m.AggregateNodeOptions(
                [("volume", "sum", None, "revenue")], keys=["o_orderdate"])),
            m.Declaration("order_by", m.OrderByNodeOptions(
                [("revenue", "descending")])),
            m.Declaration("fetch", m.FetchNodeOptions(0, 10))])
    rl, ro = ref["lineitem"].select(list(lc)), ref["orders"].select(list(oc))
    pl, po = port["lineitem"].select(list(lc)), port["orders"].select(list(oc))
    blob = sub.serialize_plan(plan(tacero, pl, po))
    assert blob == jsub.serialize_plan(plan(jacero, rl, ro))
    got = sub.run_query(blob, lambda n, s: pl if n == ["lineitem"] else po,
                        device="cpu")
    assert got.num_rows == 10
    assert_tables_match(got, plan(jacero, rl, ro).to_table().to_pydict())
