"""The in-memory dataset and the ``scan`` source
(``arrow_tpu_torch/dataset.py``, ``acero.ScanNodeOptions``,
``exec._execute_scan``) and the expression
simplification they prune with (``acero/expression.py``
``fold_constants``, ``simplify_with_guarantee``), against the JAX
package's.

* ``fold_constants`` and ``simplify_with_guarantee`` over a table of
  expressions and guarantees: the reference's trees, by structure;
* the partitionings' parse and format, and ``get_partition_keys``;
* ``tests/test_dataset_fs.py``'s in-memory cases and its partition
  pruning, and ``tests/test_acero.py``'s scan node: the reference over
  its files partitioned by year, the port over an in-memory dataset of
  the same rows, one fragment a year, each with its year's guarantee;
* the dataset's and the Scanner's methods, a repeated scan, fragments
  with different dictionaries and a scan under a join, each against the
  reference's in-memory dataset of the same slices (the one departure,
  a filter that reads a column ``columns`` leaves out, beside the
  reference's KeyError); a repeated scan uploads nothing;
  a dataset of IPC files and ``write_dataset`` run (Parquet, the default
  format, and ``Dataset.join`` raise, naming ROADMAP's item);
* ``chip_smoke.py``'s phase 3n on the CPU at SF 0.005 (no launches
  here), its paths against their Declaration forms and numpy.
"""

import pytest

import arrow_tpu as at
from arrow_tpu import dataset as jds
from arrow_tpu.acero import expression as jexpr
from arrow_tpu_torch import acero as tacero
from arrow_tpu_torch import dataset as ds
from arrow_tpu_torch.acero import (Declaration, Expression,
                                   ProjectNodeOptions, ScanNodeOptions,
                                   field, source_cache)
from arrow_tpu_torch.acero import expression as texpr

from test_torch_host_table import carry_table, port_schema
from test_torch_q1 import assert_tables_match
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


# --- fold_constants and simplify_with_guarantee ------------------------------

def _exprs(m):
    f, E = m.field, m.Expression
    return {
        "literal arithmetic": E.call("add", E.literal(2),
                                     E.call("multiply", E.literal(3),
                                            E.literal(4))),
        "comparison folds": E.call("less", E.literal(1), E.literal(2)),
        "and with false": E.call("and_kleene", f("a") > 1,
                                 E.literal(False)),
        "and with true": E.call("and_kleene", E.literal(True), f("a") > 1),
        "or with true": E.call("or_kleene", f("a") > 1, E.literal(True)),
        "or with false": E.call("or_kleene", E.literal(False), f("b") < 2),
        "invert": E.call("invert", E.literal(True)),
        "nested": E.call("and_kleene", E.call("equal", E.literal(1),
                                              E.literal(1)),
                         E.call("or_kleene", f("a") == 3,
                                E.call("greater", E.literal(0),
                                       E.literal(1)))),
        "unfoldable": E.call("sqrt", E.literal(4.0)),
        "failing fold": E.call("add", E.literal("x"), E.literal(1)),
        "field": f("a"),
        "pinned": (f("year") == 2021) & (f("v") > 3.0),
        "pinned other": (f("year") == 2020) & (f("v") > 3.0),
        "pinned both": (f("year") == 2021) & (f("s") == "c"),
        "unpinned": f("month") == 4,
    }


def _guarantees(m):
    f = m.field
    return {"none": None, "year 2021": f("year") == 2021,
            "year and s": (f("year") == 2021) & (f("s") == "c"),
            "literal first": m.Expression.call("equal", m.Expression.literal(
                2021), f("year")),
            "not an equality": f("year") > 2000}


@pytest.mark.parametrize("guarantee", sorted(_guarantees(texpr)))
@pytest.mark.parametrize("name", sorted(_exprs(texpr)))
def test_simplification_matches_the_reference(name, guarantee):
    te, je = _exprs(texpr)[name], _exprs(jexpr)[name]
    tg, jg = _guarantees(texpr)[guarantee], _guarantees(jexpr)[guarantee]
    got = texpr.simplify_with_guarantee(te, tg)
    want = jexpr.simplify_with_guarantee(je, jg)
    assert repr(got) == repr(want)
    assert got.kind == want.kind
    assert repr(texpr.fold_constants(te)) == repr(jexpr.fold_constants(je))


# --- partitionings -----------------------------------------------------------

@pytest.mark.parametrize("path", ["year=2021", "year=2021/s=c",
                                  "x/year=-3/other", "s=12a"])
def test_hive_parse_and_format(path):
    for schema in (None, at.schema([("year", at.int64()),
                                    ("s", at.string())])):
        jp = jds.HivePartitioning(schema)
        tp = ds.HivePartitioning(None if schema is None
                                 else port_schema(schema))
        (jv, jg), (tv, tg) = jp.parse(path), tp.parse(path)
        assert tv == jv and repr(tg) == repr(jg)
        assert tp.format(tv) == jp.format(jv)
        assert ds.get_partition_keys(tg) == jds.get_partition_keys(jg)


def test_directory_filename_and_factory():
    sch = at.schema([("year", at.int64()), ("s", at.string())])
    (jv, jg) = jds.DirectoryPartitioning(sch).parse("2021/c")
    (tv, tg) = ds.DirectoryPartitioning(port_schema(sch)).parse("2021/c")
    assert tv == jv and repr(tg) == repr(jg)
    assert ds.DirectoryPartitioning(port_schema(sch)).format(tv) == "2021/c"
    fsch = at.schema([("year", at.int64()), ("v", at.float64())])
    assert ds.FilenamePartitioning(port_schema(fsch)).parse(
        "/a/part_2021_1.5.parquet") == jds.FilenamePartitioning(
            fsch).parse("/a/part_2021_1.5.parquet")
    for flavor in ("hive", "filename", None):
        t = ds.PartitioningFactory(flavor, ["p"]).finish()
        j = jds.PartitioningFactory(flavor, ["p"]).finish()
        assert type(t).__name__ == type(j).__name__
        assert t.schema.names == j.schema.names == ["p"]
    assert isinstance(ds.partitioning(flavor="hive"), ds.HivePartitioning)
    with pytest.raises(ValueError):
        ds.partitioning()
    e = (field("p") == 1) & (field("q") == "x")
    assert ds.get_partition_keys(e) == {"p": 1, "q": "x"}
    assert ds.get_partition_keys(None) == {}


# --- the reference's partitioned datasets, in memory -------------------------

_SAMPLE = {"year": [2020, 2020, 2021, 2021, 2022],
           "v": [1.0, 2.0, 3.0, 4.0, 5.0], "s": ["a", "b", "c", "d", "e"]}


@pytest.fixture(scope="module")
def sample():
    return at.table(_SAMPLE)


@pytest.fixture
def partitioned(tmp_path, sample):
    """(the reference's hive-partitioned dataset of files, the port's
    in-memory dataset of the same rows, one fragment a year with its
    guarantee)."""
    root = str(tmp_path / "hive")
    jds.write_dataset(sample, root, partitioning=["year"],
                      partitioning_flavor="hive")
    ref = jds.dataset(root, partitioning=jds.partitioning(flavor="hive"))
    port = carry_table(sample)
    frags = []
    for start, n, year in ((0, 2, 2020), (2, 2, 2021), (4, 1, 2022)):
        frags.append(ds._TableFragment(port.slice(start, n),
                                       field("year") == year))
    return ref, ds.Dataset(frags, port.schema)


def _rows(d):
    return sorted(zip(*[d[k] for k in sorted(d)]))


def _same(got, want):
    g, w = got.to_pydict(), want.to_pydict()
    assert sorted(g) == sorted(w)
    assert _rows(g) == _rows(w)


def test_hive_partitioned_pruning(partitioned):
    ref, port = partitioned
    _same(port.to_table(device="cpu"), ref.to_table())
    cond = field("year") == 2021
    _same(port.to_table(filter=cond, device="cpu"),
          ref.to_table(filter=jexpr.field("year") == 2021))
    assert len(list(port.get_fragments(cond))) == \
        len(list(ref.get_fragments(jexpr.field("year") == 2021))) == 1
    mixed = port.to_table(filter=cond & (field("v") > 3.0), device="cpu")
    assert mixed.to_pydict()["v"] == ref.to_table(filter=(
        jexpr.field("year") == 2021) & (jexpr.field("v") > 3.0)
    ).to_pydict()["v"] == [4.0]
    assert port.to_table(columns=["v", "year"],
                         device="cpu").column_names == ["v", "year"]
    assert port.to_table(filter=field("year") == 2022,
                         device="cpu").to_pydict()["v"] == [5.0]


def test_scan_node_options(partitioned):
    """``tests/test_acero.py``'s scan source with partition pruning."""
    ref, port = partitioned
    from arrow_tpu import acero as jacero

    def plan(m, data, f):
        return m.Declaration.from_sequence([
            m.Declaration("scan", m.ScanNodeOptions(
                data, filter=f("year") == 2021)),
            m.Declaration("project", m.ProjectNodeOptions(
                [f("v") * 2.0], ["v2"]))])
    got = plan(tacero, port, field).to_table(device="cpu")
    want = plan(jacero, ref, jexpr.field).to_table()
    assert sorted(got.column("v2").to_pylist()) == \
        sorted(want.column("v2").to_pylist()) == [6.0, 8.0]


def test_in_memory_and_union(sample):
    ref = at.table({"a": [1, 2, 3], "b": ["x", None, "y"]})
    t = carry_table(ref)
    imd, jimd = ds.InMemoryDataset(t), jds.InMemoryDataset(ref)
    assert imd.to_table(device="cpu").to_pydict() == \
        jimd.to_table().to_pydict()
    batches = ds.InMemoryDataset(t.to_batches()[0]).to_table(device="cpu")
    assert batches.to_pydict() == jds.InMemoryDataset(
        ref.to_batches()[0]).to_table().to_pydict()
    want = jds.UnionDataset(None, [jimd, jds.InMemoryDataset(ref)])
    u = ds.UnionDataset(None, [imd, ds.InMemoryDataset(t)])
    assert u.to_table(device="cpu").to_pydict() == \
        want.to_table().to_pydict()
    assert len(u.children) == len(want.children) == 2
    # the port's dataset() of datasets is their union
    assert ds.dataset([imd, imd]).to_table(device="cpu").to_pydict() == \
        want.to_table().to_pydict()


# --- the dataset's and the scanner's methods ---------------------------------

_CUTS = ((0, 2), (2, 2), (4, 1))


@pytest.fixture
def slices(sample):
    """(the reference's in-memory dataset of the sample's three slices,
    the port's of the same rows, the port's Table)."""
    port = carry_table(sample)
    ref = jds.InMemoryDataset([sample.slice(a, n) for a, n in _CUTS])
    return ref, ds.dataset([port.slice(a, n) for a, n in _CUTS]), port


def _equal(got, want):
    """The same columns, rows, order and nulls."""
    assert got.to_pydict() == want.to_pydict()


def test_dataset_methods(slices, sample):
    ref, data, port = slices
    jf, cpu = jexpr.field, {"device": "cpu"}
    _equal(data.to_table(**cpu), ref.to_table())
    assert data.count_rows(**cpu) == ref.count_rows() == 5
    assert data.count_rows(field("v") > 2.5, **cpu) == \
        ref.count_rows(jf("v") > 2.5)
    _equal(data.head(2, **cpu), ref.head(2))
    _equal(data.head(2, ["s", "v"], field("v") > 1.5, **cpu),
           ref.head(2, ["s", "v"], jf("v") > 1.5))
    # the reference's take needs an Array; the port's takes a list too
    for idx in ([4, 0], [1, 3, 3]):
        want = ref.take(at.array(idx))
        _equal(data.take(idx, **cpu), want)
        _equal(data.take(carry_table(at.table({"i": idx})).column("i"),
                         **cpu), want)
    view, jview = data.filter(field("year") >= 2021), \
        ref.filter(jf("year") >= 2021)
    _equal(view.to_table(**cpu), jview.to_table())
    _equal(view.to_table(filter=field("v") < 4.5, **cpu),
           jview.to_table(filter=jf("v") < 4.5))
    assert view.count_rows(field("s") != "d", **cpu) == \
        jview.to_table(filter=jf("s") != "d").num_rows
    for order in ([("v", "descending")], [("year", "descending"),
                                          ("s", "ascending")]):
        _equal(data.sort_by(order, **cpu).to_table(**cpu),
               ref.sort_by(order).to_table())
    assert data.replace_schema(port.schema).schema.names == \
        ref.replace_schema(sample.schema).schema.names
    assert repr(data.partition_expression) == repr(ref.partition_expression)
    assert [b.to_pydict() for b in data.to_batches(**cpu)] == \
        [b.to_pydict() for b in ref.to_batches()]
    # the one departure: a filter may read a column that ``columns``
    # leaves out, where the reference raises
    assert data.to_table(["v"], field("s") == "c", **cpu).to_pydict() == \
        {"v": [3.0]}
    with pytest.raises(KeyError):
        ref.to_table(["v"], jf("s") == "c")
    # a filter that prunes every fragment
    jfrag = jds._TableFragment(sample)
    jfrag.partition_expression = jf("year") == 1
    with pytest.raises(ValueError, match="no fragments"):
        jds.Dataset([jfrag], sample.schema).to_table(filter=jf("year") == 2)
    with pytest.raises(ValueError, match="no fragments"):
        ds.Dataset([ds._TableFragment(port, field("year") == 1)],
                   port.schema).to_table(filter=field("year") == 2,
                                         **cpu)


def test_scanner_methods(slices, sample):
    ref, data, port = slices
    jf = jexpr.field
    sc = ds.Scanner.from_dataset(data, columns=["s", "v"],
                                 filter=field("v") >= 2.0, device="cpu")
    jsc = jds.Scanner.from_dataset(ref, columns=["s", "v"],
                                   filter=jf("v") >= 2.0)
    _equal(sc.to_table(), jsc.to_table())
    assert sc.count_rows() == jsc.count_rows() == 4
    _equal(sc.head(1), jsc.head(1))
    _equal(sc.take([0, 3]), jsc.take(at.array([0, 3])))
    assert sc.projected_schema.names == jsc.projected_schema.names
    assert sc.dataset_schema.names == jsc.dataset_schema.names
    assert [t.record_batch.to_pydict() for t in sc.scan_batches()] == \
        [t.record_batch.to_pydict() for t in jsc.scan_batches()]
    assert [b.to_pydict() for b in sc.to_batches()] == \
        [b.to_pydict() for b in jsc.to_batches()]
    assert [b.to_pydict() for b in sc.to_reader()] == \
        [b.to_pydict() for b in jsc.to_reader()]
    _equal(ds.Scanner.from_batches(port.to_batches(), device="cpu")
           .to_table(), jds.Scanner.from_batches(sample.to_batches())
           .to_table())
    _equal(ds.Scanner.from_fragment(data.fragments[1], port.schema,
                                    device="cpu").to_table(),
           jds.Scanner.from_fragment(ref.fragments[1], sample.schema)
           .to_table())
    assert data.scanner(["v"], device="cpu").count_rows() == \
        ref.scanner(["v"]).count_rows()
    _equal(data.scanner(["year"], field("s") >= "c", device="cpu")
           .to_table(), ref.scanner(["year", "s"], jf("s") >= "c")
           .to_table().select(["year"]))


def test_a_repeated_scan_uploads_nothing(slices):
    from arrow_tpu import acero as jacero
    ref, data, _ = slices
    plan = Declaration("scan", ScanNodeOptions(data, ["v", "s"],
                                               field("v") > 1.5))
    first = plan.to_table(device="cpu")
    rows = source_cache.UPLOAD_STATS["rows"]
    _equal(plan.to_table(device="cpu"), first)
    assert source_cache.UPLOAD_STATS["rows"] == rows
    _equal(first, jacero.Declaration("scan", jacero.ScanNodeOptions(
        ref, ["v", "s"], jexpr.field("v") > 1.5)).to_table())


def test_fragments_with_different_dictionaries():
    from arrow_tpu import acero as jacero
    refs = [at.table({"k": at.array(["x", "y", None, "x"]),
                      "n": [1, 2, 3, 4]}),
            at.table({"k": at.array(["z", "x"]), "n": [5, 6]})]
    data = ds.dataset([carry_table(t) for t in refs])
    ref = jds.InMemoryDataset(refs)
    _equal(data.to_table(device="cpu"), ref.to_table())
    _equal(data.to_table(filter=field("k") == "x", device="cpu"),
           ref.to_table(filter=jexpr.field("k") == "x"))

    def grouped(m, d):
        return m.Declaration.from_sequence([
            m.Declaration("scan", m.ScanNodeOptions(d)),
            m.Declaration("aggregate", m.AggregateNodeOptions(
                [("n", "sum", None, "total")], keys=["k"]))])
    _equal(grouped(tacero, data).to_table(device="cpu"),
           grouped(jacero, ref).to_table())


def test_a_scan_under_a_join_is_pruned(slices, sample):
    """The prune rewrite narrows a scan to the columns above it reads, as
    it narrows a table source (the reference's leaves a scan whole); the
    join's rows are the reference's."""
    from arrow_tpu import acero as jacero
    from arrow_tpu_torch.acero.prune import prune_plan
    ref, data, _ = slices
    right = at.table({"year": [2021, 2022], "tag": ["p", "q"]})

    def plan(m, d, r, f):
        return m.Declaration.from_sequence([
            m.Declaration("hashjoin", m.HashJoinNodeOptions(
                "inner", left_keys=["year"], right_keys=["year"],
                right_output=["tag"]), [
                m.Declaration("scan", m.ScanNodeOptions(d)),
                m.Declaration("table_source", m.TableSourceNodeOptions(r))]),
            m.Declaration("project", m.ProjectNodeOptions(
                [f("v"), f("tag")], ["v", "tag"]))])
    port = plan(tacero, data, carry_table(right), field)
    scan = prune_plan(port).inputs[0].inputs[0]
    assert scan.factory_name == "scan"
    assert sorted(scan.options.names) == ["v", "year"]
    got = port.to_table(device="cpu").to_pydict()
    want = plan(jacero, ref, right, jexpr.field).to_table().to_pydict()
    assert sorted(zip(got["v"], got["tag"])) == \
        sorted(zip(want["v"], want["tag"]))
    assert len(got["v"]) == 3


def test_files_are_not_ported_yet(tmp_path, slices, sample):
    """A dataset of IPC files and ``write_dataset`` now run, the
    reference's files and rows (``tests/test_torch_file_dataset.py`` holds
    them to the reference in full); Parquet, the format both default to,
    and ``Dataset.join`` still raise, naming ROADMAP's item."""
    _, data, port = slices
    ds.write_dataset(port, str(tmp_path / "p"), format="ipc",
                     partitioning=["year"], partitioning_flavor="hive")
    jds.write_dataset(sample, str(tmp_path / "r"), format="ipc",
                      partitioning=["year"], partitioning_flavor="hive")
    for year in ("year=2020", "year=2021", "year=2022"):
        assert (tmp_path / "p" / year / "part-0.arrow").read_bytes() == \
            (tmp_path / "r" / year / "part-0.arrow").read_bytes()
    got = ds.dataset(str(tmp_path / "r"), format="ipc",
                     partitioning=ds.partitioning(flavor="hive"))
    want = jds.dataset(str(tmp_path / "p"), format="ipc",
                       partitioning=jds.partitioning(flavor="hive"))
    _equal(got.to_table(device="cpu"), want.to_table())
    paths = [str(tmp_path / "r" / "year=2021" / "part-0.arrow")]
    _equal(ds.FileSystemDataset.from_paths(paths, format="ipc").to_table(
        device="cpu"), jds.FileSystemDataset.from_paths(
            paths, format="ipc").to_table())
    for call in (lambda: ds.dataset(str(tmp_path)),
                 lambda: ds.dataset([str(tmp_path / "a.parquet")]),
                 lambda: ds.write_dataset(port, str(tmp_path)),
                 lambda: ds.ParquetFileFormat(),
                 lambda: ds.FileSystemDataset.from_paths([]),
                 lambda: data.join(data, "year")):
        with pytest.raises(NotImplementedError, match="item 13"):
            call()


def test_the_card_is_the_default(slices):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, data, _ = slices
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data.to_table()


def test_expression_helpers_match_the_reference():
    pairs = [(field("a").isin([1, 2]), jexpr.field("a").isin([1, 2])),
             (field("a").is_null(True), jexpr.field("a").is_null(True)),
             (field("a").is_valid(), jexpr.field("a").is_valid()),
             (field("a").is_nan(), jexpr.field("a").is_nan())]
    for t, j in pairs:
        assert repr(t) == repr(j) and t.options == j.options
    assert field("a").equals(Expression.field("a"))


# --- chip_smoke's phase 3n on the CPU ----------------------------------------

def test_chip_smoke_phase_3n_on_cpu():
    """``chip_smoke.py``'s phase 3n over phase 3l's Tables at SF 0.005 on
    the CPU: every path against its Declaration form or numpy (no
    launches here)."""
    import chip_smoke
    _, host = chip_smoke.phase_host(sf=0.005, device="cpu")
    nested = chip_smoke.host_tier_inputs(host, "cpu")
    launches, facts = chip_smoke.phase_frontends(host, nested, device="cpu")
    assert launches == {}
    assert set(facts["walls"]) >= {f"3n {k}" for k in (
        "SQL Q1", "SQL Q6", "SQL Q3", "gandiva filter", "substrait Q6",
        "substrait join", "scanner Q6", "scan Q1", "quantile", "cast")}
    assert all(k in facts["host_ms"] for k in (
        "SQL Q3 parse", "substrait join encode", "substrait join decode",
        "gandiva make"))
    # the launch table names only paths the phase runs
    assert set(chip_smoke.FRONTEND_LAUNCHES) <= set(facts["walls"])


def test_phase_3n_declaration_forms_match_the_reference():
    """Phase 3n's scan forms of Q1 and Q6 over an in-memory dataset of
    lineitem slices at SF 0.01, against the reference's q1_plan and
    q6_plan over the same rows."""
    import chip_smoke
    from arrow_tpu.io import tpch as jtpch
    from arrow_tpu.io import tpch_queries as jq
    from arrow_tpu_torch.io import tpch_queries as tq
    ref = jtpch.lineitem_table(0.01)
    li = carry_table(ref)
    n = li.num_rows
    step = -(-n // chip_smoke.FRONTEND_SLICES)
    data = ds.InMemoryDataset([li.slice(i, step) for i in range(0, n, step)])
    assert len(data.fragments) == chip_smoke.FRONTEND_SLICES
    for cols, make_t, make_j in ((chip_smoke.Q1_COLUMNS, tq.q1_plan,
                                  jq.q1_plan),
                                 (chip_smoke.Q6_COLUMNS, tq.q6_plan,
                                  jq.q6_plan)):
        plan = chip_smoke._with_leaf(make_t(li), Declaration(
            "scan", ScanNodeOptions(data, cols)))
        assert_tables_match(plan.to_table(device="cpu"),
                            make_j(ref).to_table().to_pydict())
