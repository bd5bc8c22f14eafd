"""The port's FunctionOptions classes (``arrow_tpu_torch/compute/options.py``)
against the JAX package's ``arrow_tpu/compute/options.py``: every class
with the same fields and defaults, the same ``to_kwargs`` and ``repr``,
the same positional construction and unknown-option error; and the call
forms the reference accepts (an options object as ``options=``, among the
arguments, or a dict) giving the reference's results on the same
Arrays, ``tests/test_plan_rewrites.py``'s options cases among them."""

import inspect

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu.compute as jpc
from arrow_tpu.compute import options as jopts
import arrow_tpu_torch.compute as pc
from arrow_tpu_torch import types as PT
from arrow_tpu_torch.compute import options as topts

from test_torch_host_table import carry_array
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


def _classes(mod):
    return {n: v for n, v in vars(mod).items()
            if inspect.isclass(v) and issubclass(v, mod.FunctionOptions)
            and v is not mod.FunctionOptions}


REFERENCE = _classes(jopts)


def test_the_same_58_classes():
    assert len(REFERENCE) == 58
    assert sorted(_classes(topts)) == sorted(REFERENCE)
    assert sorted(topts.__all__) == sorted(list(REFERENCE)
                                           + ["FunctionOptions"])
    for name in REFERENCE:
        assert getattr(pc, name) is getattr(topts, name)
        assert name in pc.__all__


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_fields_and_defaults_match_the_reference(name):
    ref, port = REFERENCE[name], getattr(topts, name)
    assert port._fields == ref._fields
    assert port.__name__ == ref.__name__
    r, p = ref(), port()
    assert p.to_kwargs() == r.to_kwargs()
    assert repr(p) == repr(r)
    for f in ref._fields:
        assert getattr(p, f) == getattr(r, f), f
    # positional arguments fill the fields in order; keywords override
    args = tuple(f"v{i}" for i in range(len(ref._fields)))
    assert port(*args).to_kwargs() == ref(*args).to_kwargs()
    with pytest.raises(TypeError, match="unknown options") as pe:
        port(not_an_option=1)
    with pytest.raises(TypeError) as re_:
        ref(not_an_option=1)
    assert str(pe.value) == str(re_.value)


def _pair(values, ref_type=None):
    ra = at.array(values, ref_type) if ref_type is not None \
        else at.array(values)
    return ra, carry_array(ra)


def _py(x):
    return x.to_pylist() if hasattr(x, "to_pylist") else x.value


# name -> (function, values, its options made of a package's compute
# module and its types, or None)
_CALLS = {
    "cast to string": ("cast", [1, 2, None], lambda m, T: m.CastOptions(
        target_type=T.string())),
    "cast to int32": ("cast", [1.0, 2.0, None], lambda m, T: m.CastOptions(
        target_type=T.int32())),
    "unsafe cast": ("cast", [1.5, 2.0], lambda m, T: m.CastOptions(
        target_type=T.int32(), safe=False)),
    "quantile": ("quantile", [1.0, 2.0, None, 4.0, 7.0],
                 lambda m, T: m.QuantileOptions(q=0.25)),
    "variance": ("variance", [1.0, 2.0, None, 4.0, 7.0],
                 lambda m, T: m.VarianceOptions(ddof=1)),
    "count all": ("count", [1, None, 3], lambda m, T: m.CountOptions(
        mode="all")),
    "round": ("round", [1.25, -2.5, None], lambda m, T: m.RoundOptions(
        ndigits=1, round_mode="half_up")),
    "sum min_count": ("sum", [None, None],
                      lambda m, T: m.ScalarAggregateOptions(min_count=0)),
    "is_in": ("is_in", [1, 2, 3, None], lambda m, T: m.SetLookupOptions(
        value_set=[2, 3])),
    "utf8_upper": ("utf8_upper", ["a", None, "bc"], lambda m, T: None),
}


@pytest.mark.parametrize("form", ["options=", "positional", "dict"])
@pytest.mark.parametrize("case", sorted(_CALLS))
def test_call_forms_match_the_reference(case, form):
    name, values, make = _CALLS[case]
    ra, pa_ = _pair(values)
    ropt, popt = make(jpc, at), make(pc, PT)
    if form == "options=":
        want = jpc.call_function(name, [ra], ropt)
        got = pc.call_function(name, [pa_], popt, device="cpu")
    elif form == "positional":
        want = jpc.call_function(name, [ra] + ([ropt] if ropt else []))
        got = pc.call_function(name, [pa_] + ([popt] if popt else []),
                               device="cpu")
    else:
        want = jpc.call_function(name, [ra], ropt.to_kwargs() if ropt
                                 else None)
        got = pc.call_function(name, [pa_], popt.to_kwargs() if popt
                               else None, device="cpu")
    g, w = _py(got), _py(want)
    if isinstance(w, float):
        assert g == pytest.approx(w, rel=1e-12)
    else:
        assert g == w
    # and through the wrapper, as pyarrow.compute's
    wrapped = getattr(pc, name)(pa_, options=popt, device="cpu")
    g2 = _py(wrapped)
    assert (g2 == pytest.approx(w, rel=1e-12)) if isinstance(w, float) \
        else (g2 == w)


def test_the_wrapper_merges_options_and_keywords():
    """An options object's fields, with keywords on top (the reference's
    wrapper: ``options.to_kwargs()`` updated by the keywords)."""
    ra, pa_ = _pair([1.0, 2.0, None, 4.0, 7.0])
    want = jpc.quantile(ra, options=jopts.QuantileOptions(q=0.1),
                        interpolation="lower")
    got = pc.quantile(pa_, options=pc.QuantileOptions(q=0.1),
                      interpolation="lower", device="cpu")
    assert got.value == want.value
# --- tests/test_plan_rewrites.py's options cases ---------------------------

# --- tests/test_plan_rewrites.py's options cases ---------------------------

def test_options_instance_positional():
    a = pc.call_function(
        "cast", [carry_array(at.array([1, 2], at.int64())),
                 pc.CastOptions(target_type=PT.string())], device="cpu")
    assert a.to_pylist() == ["1", "2"]


def test_positional_alias_string():
    a = carry_array(at.array([1, 2, 3], at.int64()))
    assert pc.cast(a, "string", device="cpu").to_pylist() == ["1", "2", "3"]
    assert pc.cast(a, "float32", device="cpu").to_pylist() == \
        [1.0, 2.0, 3.0]


def test_positional_with_safe_kwarg():
    a = carry_array(at.array([1.5, 2.0], at.float64()))
    with pytest.raises(Exception):
        pc.cast(a, "int32", device="cpu")
    assert pc.cast(a, "int32", safe=False,
                   device="cpu").to_pylist() == [1, 2]


def test_options_match_pyarrow_where_importable():
    pa = pytest.importorskip("pyarrow")
    ppc = pytest.importorskip("pyarrow.compute")
    a = carry_array(at.array([1, 2, 3], at.int64()))
    assert pc.call_function("cast", [a, pc.CastOptions(
        target_type=PT.string())], device="cpu").to_pylist() == \
        ppc.cast(pa.array([1, 2, 3], pa.int64()), pa.string()).to_pylist()
    x = [float(v) for v in np.random.default_rng(3).normal(size=41)]
    got = pc.quantile(carry_array(at.array(x)),
                      options=pc.QuantileOptions(q=[0.1, 0.5, 0.9]),
                      device="cpu").value
    want = ppc.quantile(pa.array(x), q=[0.1, 0.5, 0.9]).to_pylist()
    np.testing.assert_allclose(got, want, rtol=1e-12)
