"""Six faults of the port against the JAX package, repaired, each on the
input that showed it (ROADMAP.md §3):

* F2: a numpy scalar literal is strongly typed, as in JAX: ``np.int64``
  widens an int32 column, ``np.float64`` an f32 one, in arithmetic and in
  comparisons. Python literals stay weak.
* F3: the sum of a bool column is uint64 (type id 8), scalar and grouped.
* F1: float sums add in an order fixed by the input. On the CPU the plain
  versions and the general path (more than 1,024 segments) give the
  reference's sums within rtol 1e-9 and repeat bit for bit; dead rows stay
  out of every slot. The card's repeat checks are in ``chip_smoke.py``.
* F4: the eager ``quantile`` and ``tdigest`` of several q give one value
  a q (they gave the first q's alone). The reference raises IndexError
  there, so the port departs from it and is held to Arrow's answer
  (pyarrow's ``quantile`` where importable, the values otherwise).
* F5: ``list_element`` with a negative index raises ArrowInvalid in both
  tiers, as the reference's CPU tier does (the port's device tier read
  the list before).
* F6: the eager ``call_function("dictionary_encode", ...)`` gives Arrow's
  dictionary Array, as both packages' ``compute.dictionary_encode`` do
  (it gave the grouper's codes over an empty dictionary). The reference's
  ``call_function`` gives codes with no dictionary, which cannot be
  read, so the port is held to the reference's
  ``compute.dictionary_encode`` and to pyarrow's.
"""

import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import acero as jacero
from arrow_tpu.device.column import upload_table
from arrow_tpu.table import Table
from arrow_tpu.types import TypeId as JaxTypeId
from arrow_tpu_torch import acero as tacero
from arrow_tpu_torch.acero.exec import execute_declaration
from arrow_tpu_torch.compute.move import segment_sum
from arrow_tpu_torch.device.column import batch_from_numpy
from arrow_tpu_torch.kernels.grouped_sum import grouped_sum
from arrow_tpu_torch.types import TypeId

from test_torch_q1 import assert_tables_match, carry_across
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

_I = [1, 2, 3, 2**30, None, -5]
_X = [1.5, -2.0, 0.25, 3.0, None, 7.0]


def _literal_tables():
    jt = Table.from_pydict({"i": at.array(_I, at.int32()),
                            "x": at.array(_X, at.float32())})
    return jt, carry_across(upload_table(jt))


# the four rows of ROADMAP.md §3 F2, one mixed-kind row, and the weak
# Python literals beside them
_F2 = {
    "i == np.int64(2**32 + 1)": lambda m: m.field("i") == np.int64(2**32 + 1),
    "i < np.int64(2**31)": lambda m: m.field("i") < np.int64(2**31),
    "i * np.int64(4)": lambda m: m.field("i") * np.int64(4),
    "x * np.float64(2.5)": lambda m: m.field("x") * np.float64(2.5),
    "i + np.float32(0.5)": lambda m: m.field("i") + np.float32(0.5),
    "np.int64(7) - i": lambda m: np.int64(7) - m.field("i"),
    "i / np.int64(2)": lambda m: m.field("i") / np.int64(2),
    "i * 3": lambda m: m.field("i") * 3,
    "x * 2.5": lambda m: m.field("x") * 2.5,
}


@pytest.mark.parametrize("name", list(_F2))
def test_numpy_literal_promotes_like_jax(name):
    jt, tb = _literal_tables()

    def plan(mod, src):
        return mod.Declaration("project", mod.ProjectNodeOptions(
            [_F2[name](mod)], ["out"]), [mod.Declaration(
                "table_source", mod.TableSourceNodeOptions(src))])

    want_tbl = plan(jacero, jt).to_table()
    want = want_tbl.to_pydict()
    got = plan(tacero, tb)
    assert_tables_match(got.to_table().to_pydict(), want)
    assert int(execute_declaration(got).schema.fields[0].type.id) == \
        int(want_tbl.schema.field("out").type.id)


def test_f2_table_rows():
    """The values ROADMAP.md §3 gives for the reference."""
    _, tb = _literal_tables()

    def run(name):
        return tacero.Declaration("project", tacero.ProjectNodeOptions(
            [_F2[name](tacero)], ["out"]), [tacero.Declaration(
                "table_source", tacero.TableSourceNodeOptions(tb))])

    assert run("i == np.int64(2**32 + 1)").to_table().to_pydict()["out"] == \
        [False, False, False, False, None, False]
    assert run("i < np.int64(2**31)").to_table().to_pydict()["out"] == \
        [True, True, True, True, None, True]
    got = run("i * np.int64(4)")
    assert got.to_table().to_pydict()["out"] == [4, 8, 12, 4294967296, None, -20]
    assert execute_declaration(got).schema.fields[0].type.id == \
        TypeId.INT64
    got = execute_declaration(run("x * np.float64(2.5)"))
    assert got.schema.fields[0].type.id == TypeId.DOUBLE


_BOOLS = [True, False, None, True, False, None, True, False, True, False]


def _bool_tables():
    jt = Table.from_pydict({"b": at.array(_BOOLS, at.bool_()),
                            "k": at.array(list("xyxyzxyzxx"), at.string())})
    return jt, carry_across(upload_table(jt))


@pytest.mark.parametrize("keys", [[], ["k"]], ids=["sum", "hash_sum"])
def test_bool_sum_is_uint64(keys):
    jt, tb = _bool_tables()

    def plan(mod, src):
        return mod.Declaration("aggregate", mod.AggregateNodeOptions(
            [("b", "sum", None, "total")], keys=keys), [mod.Declaration(
                "table_source", mod.TableSourceNodeOptions(src))])

    want_tbl = plan(jacero, jt).to_table()
    got = plan(tacero, tb)
    assert_tables_match(got.to_table().to_pydict(), want_tbl.to_pydict())
    (want_type,) = [f.type.id for f in want_tbl.schema
                    if f.name == "total"]
    assert want_type == JaxTypeId.UINT64 == 8
    out = execute_declaration(got)
    assert out.column("total").type.id == TypeId.UINT64
    if not keys:
        assert got.to_table().to_pydict()["total"] == [4]


def test_uint64_downloads_unsigned():
    b = batch_from_numpy([("u", "uint64", np.array([1, -1, 5]), None,
                           None)], 3, device="cpu")
    assert tacero.Declaration("table_source", tacero.TableSourceNodeOptions(
        b)).to_table().to_pydict()["u"] == [1, 2**64 - 1, 5]


# --- F1 ----------------------------------------------------------------------

def _sum_inputs(seed, n, segments, dead_share=0.3):
    rng = np.random.default_rng(seed)
    values = rng.normal(0.0, 1e4, n) * rng.choice([1.0, 1e-6, 1e6], n)
    gids = rng.integers(0, segments, n)
    live = rng.random(n) >= dead_share
    return values, gids, live


@pytest.mark.parametrize("segments", [12, 1024, 5000])
def test_sums_match_a_row_order_sum_and_repeat(segments):
    """The plain grouped sum (<= 1,024 slots) and the general path's
    sorted segment sum against numpy's row-order sum, twice, bit for bit;
    a dead row adds nothing, slot 0 included."""
    values, gids, live = _sum_inputs(segments, 20_000, segments)
    v = torch.from_numpy(np.where(live, values, 0.0))
    g = torch.from_numpy(np.where(live, gids, 0))
    want = np.zeros(segments)
    np.add.at(want, gids[live], values[live])
    if segments <= 1024:
        runs = [grouped_sum(v, g.to(torch.int32), segments)
                for _ in range(2)]
    else:
        runs = [segment_sum(v, g, segments, torch.from_numpy(live))
                for _ in range(2)]
    np.testing.assert_allclose(runs[0].numpy(), want, rtol=1e-9, atol=1e-9)
    assert torch.equal(runs[0].view(torch.int64), runs[1].view(torch.int64))


def test_general_path_leaves_dead_rows_out():
    """A dead row with a value of -0.0 or NaN at slot 0 changes nothing."""
    v = torch.tensor([2.0, float("nan"), -0.0, 3.0] * 400,
                     dtype=torch.float64)
    g = torch.tensor([0, 0, 0, 1500] * 400)
    live = torch.tensor([False, False, False, True] * 400)
    out = segment_sum(v, g, 2000, live)
    assert out[0].item() == 0.0 and not torch.signbit(out[0])
    assert out[1500].item() == 1200.0
    assert int(torch.count_nonzero(out)) == 1


@pytest.mark.parametrize("fn", ["sum", "mean"])
def test_general_grouper_float_sums_match_jax_and_repeat(fn):
    """Sums and means by a key with 3,000 groups (the general grouper over
    more than 1,024 segments), with null values, against the reference;
    two runs give the same bits."""
    rng = np.random.default_rng(5)
    n = 9000
    values = rng.normal(0.0, 1e5, n)
    valid = rng.random(n) >= 0.1
    jt = Table.from_pydict({
        "k": at.array(rng.integers(0, 3000, n).tolist(), at.int64()),
        "v": at.array([float(x) if ok else None
                       for x, ok in zip(values, valid)], at.float64())})
    tb = carry_across(upload_table(jt))

    def plan(mod, src):
        return mod.Declaration.from_sequence([
            mod.Declaration("table_source", mod.TableSourceNodeOptions(src)),
            mod.Declaration("filter", mod.FilterNodeOptions(
                mod.field("k") > 40)),
            mod.Declaration("aggregate", mod.AggregateNodeOptions(
                [("v", fn, None, "out")], keys=["k"])),
            mod.Declaration("order_by", mod.OrderByNodeOptions(
                [("k", "ascending")]))])

    want = plan(jacero, jt).to_table().to_pydict()
    got = [plan(tacero, tb).to_table().to_pydict() for _ in range(2)]
    assert len(want["k"]) > 1024
    assert_tables_match(got[0], want)
    assert got[0] == got[1]


# --- F4-F6 -------------------------------------------------------------------

_F4 = [1.0, 2.0, None, 4.0, 7.0]


@pytest.mark.parametrize("fn", ["quantile", "tdigest"])
def test_f4_every_q_has_its_value(fn):
    import arrow_tpu.compute as jpc
    import arrow_tpu_torch.compute as pc
    from arrow_tpu_torch.array.array import array
    a = array(_F4)
    got = pc.call_function(fn, [a], {"q": [0.1, 0.5]}, device="cpu")
    assert got.value == pytest.approx([1.3, 3.0], rel=1e-12)
    assert got.type.id == TypeId.LIST
    # the wrapper and an options object give the same
    opts = pc.QuantileOptions(q=[0.1, 0.5]) if fn == "quantile" \
        else pc.TDigestOptions(q=[0.1, 0.5])
    assert getattr(pc, fn)(a, options=opts, device="cpu").value == \
        got.value
    # one q stays one value, as in the reference
    one = pc.call_function(fn, [a], {"q": 0.5}, device="cpu")
    assert one.value == jpc.call_function(fn, [at.array(_F4)],
                                          {"q": 0.5}).value == 3.0
    # the reference raises here: a departure, to Arrow's answer
    with pytest.raises(IndexError):
        jpc.call_function(fn, [at.array(_F4)], {"q": [0.1, 0.5]})
    try:
        import pyarrow as pa
        import pyarrow.compute as ppc
    except ImportError:
        return
    assert got.value == pytest.approx(ppc.quantile(
        pa.array(_F4), q=[0.1, 0.5]).to_pylist(), rel=1e-12)


def test_f4_a_plans_scalar_quantile_keeps_a_column_a_q():
    """A plan's scalar quantile of several q is unchanged: ``x_q0``,
    ``x_q1``, as the reference's."""
    jt = Table.from_pydict({"x": at.array(_F4)})
    tb = carry_across(upload_table(jt))

    def plan(mod, src):
        return mod.Declaration("aggregate", mod.AggregateNodeOptions(
            [("x", "quantile", {"q": [0.1, 0.5]}, "x")], keys=[]),
            [mod.Declaration("table_source", mod.TableSourceNodeOptions(src))])
    want = plan(jacero, jt).to_table().to_pydict()
    got = plan(tacero, tb).to_table(device="cpu").to_pydict()
    assert list(want) == list(got) == ["x_q0", "x_q1"]
    assert_tables_match(got, want)


_F5 = [[1, 2, 3], None, [], [4, None, 6, 7], [8]]


@pytest.mark.parametrize("tier", ["device", "host"])
def test_f5_a_negative_list_index_raises_in_both_tiers(tier):
    import arrow_tpu.compute as jpc
    import arrow_tpu_torch.compute as pc
    from arrow_tpu_torch.array.array import array
    from arrow_tpu_torch.compute import device_nested
    from arrow_tpu_torch.compute.registry import ArrowInvalid
    # a list of lists has no device form: the host tier runs
    a = array(_F5) if tier == "device" else array(
        [None if v is None else [None if x is None else [x] for x in v]
         for v in _F5])
    if tier == "device":
        assert device_nested.list_element(a, 1, "cpu") is not None
        with pytest.raises(ArrowInvalid, match="index out of bounds"):
            device_nested.list_element(a, -1, "cpu")
    else:
        assert device_nested.has_device_form(
            device_nested.list_layout(a)[1]) is False
    with pytest.raises(ArrowInvalid, match="index out of bounds"):
        pc.list_element(a, -1, device="cpu")
    with pytest.raises(Exception, match="index out of bounds"):
        jpc.list_element(at.array(_F5), -1)
    # a non-negative index still reads each list's element
    assert pc.list_element(array(_F5), 2, device="cpu").to_pylist() == \
        jpc.list_element(at.array(_F5), 2).to_pylist() == \
        [3, None, None, 6, None]


def test_f6_the_eager_dictionary_encode_reads_back():
    import arrow_tpu.compute as jpc
    import arrow_tpu_torch.compute as pc
    from arrow_tpu_torch.array.array import Array, array
    values = ["a", None, "b", "a", "c", "b"]
    got = pc.call_function("dictionary_encode", [array(values)],
                           device="cpu")
    want = jpc.dictionary_encode(at.array(values))
    assert got.to_pylist() == want.to_pylist() == values
    assert got.data.values().tolist() == [0, 0, 1, 0, 2, 1]
    assert got.is_valid_mask().tolist() == [True, False, True, True, True,
                                            True]
    assert Array(got.data.dictionary).to_pylist() == ["a", "b", "c"]
    assert got.type.id == TypeId.DICTIONARY
    assert pc.dictionary_encode(array(values), device="cpu").to_pylist() \
        == values
    # its options reach it, positionally or as options=, and are not
    # dropped: the reference's one behavior runs, another raises
    for opts in ({"options": pc.DictionaryEncodeOptions()},
                 {"options": {"null_encoding_behavior": "mask"}}):
        assert pc.call_function("dictionary_encode", [array(values)],
                                device="cpu", **opts).to_pylist() == values
    assert pc.call_function("dictionary_encode", [
        array(values), pc.DictionaryEncodeOptions()],
        device="cpu").to_pylist() == values
    with pytest.raises(pc.ArrowNotImplementedError):
        pc.call_function("dictionary_encode", [array(values)],
                         pc.DictionaryEncodeOptions("encode"), device="cpu")
    try:
        import pyarrow as pa
        import pyarrow.compute as ppc
    except ImportError:
        return
    pw = ppc.dictionary_encode(pa.array(values))
    assert pw.indices.to_pylist() == [0, None, 1, 0, 2, 1]
    assert pw.dictionary.to_pylist() == ["a", "b", "c"]
