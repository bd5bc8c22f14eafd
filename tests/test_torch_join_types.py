"""All eight hash-join types of the port against the JAX package.

Each case runs the same ``Declaration("hashjoin", ...)`` tree through both
packages over the same tables (the JAX package's host tables, uploaded and
carried across as numpy): duplicate keys on both sides with null keys and
padding rows, the bloom prefilter on (probe capacity at least 4x the
build's) and off, unique build keys (the primary-key paths, the left outer
identity among them), NaN, -0.0 and infinite float keys, an empty build
side, all-null build keys, dictionary-coded keys over two different
dictionaries that unify, and two-column keys (the grouper path). Rows,
row order, validity and values must match exactly (floats are only moved;
they are compared with rtol 1e-9, as in the other join tests).

The phase of ``chip_smoke.py`` that runs every join type on the card holds
the port against a numpy oracle; that oracle is checked here against the
port on the CPU."""

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu.acero as jacero
from arrow_tpu.device.column import upload_table
from arrow_tpu.table import Table
import arrow_tpu_torch.acero as tacero
from arrow_tpu_torch.acero.exec import execute_declaration
from arrow_tpu_torch.device.column import batch_from_numpy

import chip_smoke
from test_torch_q1 import assert_tables_match, carry_across
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

JOIN_TYPES = ("inner", "left outer", "right outer", "full outer",
              "left semi", "right semi", "left anti", "right anti")
_JAX_TYPES = {"int32": at.int32(), "int64": at.int64(),
              "float64": at.float64(), "string": at.string()}
_FLOAT_POOL = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 1e300, -np.inf],
                       dtype=np.float64)
_WORDS = ["ash", "birch", "cedar", "elm", "fir", "hazel", "larch", "maple",
          "oak", "pine", "rowan", "willow", "yew"]


def _table(rng, n, spec):
    """spec: {name: (type name, values, null fraction)}."""
    cols = {}
    for name, (type_name, values, null_frac) in spec.items():
        valid = rng.random(n) >= null_frac
        vals = [v if ok else None for v, ok in zip(list(values), valid)]
        cols[name] = at.array(vals, _JAX_TYPES[type_name])
    return Table.from_pydict(cols)


def _keys(rng, case, n_probe, n_build):
    """(key type, probe keys, build keys)."""
    if case == "unique_build":
        return ("int64", rng.integers(0, 1000, n_probe),
                rng.permutation(1000)[:n_build])
    if case == "float_keys":
        return ("float64", _FLOAT_POOL[rng.integers(0, 7, n_probe)],
                _FLOAT_POOL[rng.integers(0, 7, n_build)])
    if case == "dictionary_keys":
        # two dictionaries: the build side lacks the last words, the probe
        # side the first ones
        return ("string", [_WORDS[i] for i in rng.integers(3, 13, n_probe)],
                [_WORDS[i] for i in rng.integers(0, 10, n_build)])
    return ("int64", rng.integers(0, 80, n_probe),
            rng.integers(0, 60, n_build))


def _case_tables(case, rng):
    """(probe table, build table, join keyword arguments) for a case."""
    n_probe = 2000 if case == "bloom_off" else 5000
    n_build = 0 if case == "empty_build" else 800
    ktype, pk, bk = _keys(rng, case, n_probe, n_build)
    p_null = 0.0 if case == "unique_build" else 0.1
    b_null = {"unique_build": 0.0, "all_null_keys": 1.0}.get(case, 0.1)
    probe_spec = {"pk": (ktype, pk, p_null),
                  "pv": ("float64", rng.normal(size=n_probe), 0.05),
                  "x": ("int32", rng.integers(0, 10, n_probe), 0.0)}
    build_spec = {"bk": (ktype, bk, b_null),
                  "bv": ("int64", rng.integers(-10**9, 10**9, n_build), 0.05),
                  "x": ("int32", rng.integers(0, 10, n_build), 0.0)}
    kw = dict(left_keys=["pk"], right_keys=["bk"])
    if case == "multi_key":
        probe_spec["pk2"] = ("int32", rng.integers(0, 3, n_probe), 0.05)
        build_spec["bk2"] = ("int64", rng.integers(0, 3, n_build), 0.05)
        kw = dict(left_keys=["pk", "pk2"], right_keys=["bk", "bk2"])
    return (_table(rng, n_probe, probe_spec), _table(rng, n_build, build_spec),
            kw)


def _join(mod, jt, probe, build, **kw):
    src = mod.Declaration
    return src("hashjoin", mod.HashJoinNodeOptions(jt, **kw), inputs=[
        src("table_source", mod.TableSourceNodeOptions(probe)),
        src("table_source", mod.TableSourceNodeOptions(build))])


def _run_both(make, probe, build):
    want = make(jacero, probe, build).to_table().to_pydict()
    got = make(tacero, carry_across(upload_table(probe)),
               carry_across(upload_table(build))).to_table().to_pydict()
    return got, want


_CASES = ["dup_null", "bloom_off", "unique_build", "float_keys",
          "empty_build", "all_null_keys", "dictionary_keys", "multi_key"]


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_type_matches_jax(jt, case):
    probe, build, kw = _case_tables(case, np.random.default_rng(
        _CASES.index(case)))
    got, want = _run_both(
        lambda mod, p, b: _join(mod, jt, p, b, output_suffix_for_left="_l",
                                output_suffix_for_right="_r", **kw),
        probe, build)
    assert_tables_match(got, want)
    n = len(next(iter(want.values())))
    if case not in ("empty_build", "all_null_keys") or \
            jt in ("left outer", "full outer", "left anti"):
        assert n > 0
    if jt in ("right semi", "right anti"):
        assert list(got) == list(build.column_names)
    elif jt in ("left semi", "left anti"):
        assert list(got) == list(probe.column_names)


def test_join_outputs_and_pre_chains():
    """Filters above both inputs, output lists, and a right outer join's
    probe side null on the appended build rows."""
    probe, build, kw = _case_tables("dup_null", np.random.default_rng(40))

    def make(mod, p, b, jt):
        field = mod.field
        src = mod.Declaration
        left = src.from_sequence([
            src("table_source", mod.TableSourceNodeOptions(p)),
            src("filter", mod.FilterNodeOptions(field("x") < 7))])
        right = src.from_sequence([
            src("table_source", mod.TableSourceNodeOptions(b)),
            src("filter", mod.FilterNodeOptions(field("x") > 2))])
        return src("hashjoin", mod.HashJoinNodeOptions(
            jt, left_output=["pv", "pk"], right_output=["bv"], **kw),
            inputs=[left, right])

    for jt in JOIN_TYPES:
        got, want = _run_both(lambda mod, p, b: make(mod, p, b, jt),
                              probe, build)
        assert_tables_match(got, want)
    got, _ = _run_both(lambda mod, p, b: make(mod, p, b, "right outer"),
                       probe, build)
    assert list(got) == ["pv", "pk", "bv"]
    appended = [i for i, k in enumerate(got["pk"]) if k is None]
    assert appended and appended == list(range(appended[0], len(got["pk"])))
    assert all(got["pv"][i] is None for i in appended)


def test_dictionary_and_plain_key_raises():
    rng = np.random.default_rng(50)
    probe, _, _ = _case_tables("dictionary_keys", rng)
    _, build, _ = _case_tables("dup_null", rng)
    with pytest.raises(ValueError, match="mixes dictionary-coded and plain"):
        _join(tacero, "inner", carry_across(upload_table(probe)),
              carry_across(upload_table(build)), left_keys=["pk"],
              right_keys=["bk"]).to_table().to_pydict()


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_chip_smoke_oracle_matches_port(jt):
    """``chip_smoke.join_oracle`` (numpy) gives the port's rows in order,
    with null keys, duplicate keys on both sides and padding rows."""
    rng = np.random.default_rng(JOIN_TYPES.index(jt))
    n_p, n_b = 3000, 700
    pk = rng.integers(0, 400, n_p)
    bk = rng.integers(0, 400, n_b)
    p_valid = rng.random(n_p) >= 0.05
    b_valid = rng.random(n_b) >= 0.05
    probe = batch_from_numpy(
        [("pk", "int64", pk, p_valid, None),
         ("pid", "int64", np.arange(n_p) * 3, None, None)], n_p,
        device="cpu")
    build = batch_from_numpy(
        [("bk", "int64", bk, b_valid, None),
         ("bid", "int64", np.arange(n_b) * 5, None, None)], n_b,
        device="cpu")
    decl = _join(tacero, jt, probe, build, left_keys=["pk"],
                 right_keys=["bk"])
    probe_side = chip_smoke.JoinSide(pk, p_valid, "pid", np.arange(n_p) * 3)
    build_side = chip_smoke.JoinSide(bk, b_valid, "bid", np.arange(n_b) * 5)
    rows = chip_smoke.check_join(
        jt, execute_declaration(decl), probe_side, build_side,
        chip_smoke.match_runs(probe_side, build_side))
    assert rows == len(decl.to_table().to_pydict()["bk" if "right" in jt else "pk"]) > 0
