"""The port's string functions against the JAX package's.

Every string name of the reference's ``strings.py`` and of its
``extra_kernels.py`` runs on the same dictionary-coded column in both
packages, one parametrised case a name, option and dictionary:

* ``small``: 33 values, non-ASCII ones, a null slot, empty and blank
  values, digits of other scripts, title cases, a control character: the
  host tier in both packages;
* ``large_ascii``: 4,300 ASCII values (above ``DEVICE_STRINGS_MIN``), a
  null slot, an empty value, values that one case maps to one: the byte
  pool in both packages, for the predicates and (the reference's eager
  call) the str -> str transforms;
* ``large_utf8``: 4,300 values, some not ASCII: the pool's predicates, the
  host tier for every transform (the pool's ASCII gate).

The reference's side is its eager call: the pool transform where its
``pre`` hook takes the call, else its function. Codes, validity, the new
dictionary, values and type must be exact. The pads run beyond the pool's
width, the patterns include empty ones, and ``ignore_case`` runs both
ways.

Beside the reference's answers: where its tiers differ the port's pool
follows its host tier (``count_substring`` of ``""`` over non-ASCII
values); the null slot of each tier; the int32 results; ``title`` and
``capitalize`` as byte rules (``3rd avenue``, ``o'neil``); the pool and
the host tier of the port give one dictionary and one set of codes; the
registry holds all 107 names of this slice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu.compute.extra_kernels  # noqa: F401 - registers its names
from arrow_tpu import acero as jacero
from arrow_tpu import types as RT
from arrow_tpu.compute import registry as jax_registry
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu.device.column import upload_table
from arrow_tpu.table import Table
from arrow_tpu_torch import acero as tacero
from arrow_tpu_torch import types as PT
from arrow_tpu_torch.compute import device_strings
from arrow_tpu_torch.compute.registry import ExecContext, get_function
from arrow_tpu_torch.device.column import DeviceColumn

from test_torch_q1 import assert_tables_match, carry_across

SMALL = ("forest green", "Été à Paris", "straße", None, "", "   ",
         "  padded  ", "3rd avenue", "o'neil", "Hello World", "12345", "٣٤",
         "½", "\t\n", "ABC", "abc", "Title Case", "a-b-c", "aaa", "aXa",
         "xx xx", "+12", "-7", "ﬁne", "\x01ctl", "İstanbul", "ǅemal",
         "Ⅻ", "aaaa", "banana", "BANANA split", "ends with 9",
         "green forest")
_WORDS = ("forest", "Forest", "FOREST", "green", "red", "lace", "banana",
          "xx", "aaa", "o'neil", "3rd", "avenue")


def _large(non_ascii: bool) -> tuple:
    """4,300 values: three words and a number, case variants that one
    case function maps to one value, and the specials of ``SMALL``'s kind
    (ASCII only unless ``non_ascii``)."""
    rng = np.random.default_rng(5)
    picks = rng.integers(0, len(_WORDS), (4_270, 3))
    vals = [" ".join(_WORDS[j] for j in p) + f" {i % 2_000}"
            for i, p in enumerate(picks)]
    vals = list(dict.fromkeys(vals))
    extra = [None, "", "   ", " \t padded \x1f", "3rd avenue", "o'neil",
             "+12", "-7", "aaaa", "xx xx", "ABC", "abc", "a-b-c", "12345"]
    if non_ascii:
        extra += ["Été à Paris", "straße", "½", "ﬁne", "İstanbul"]
    return tuple(vals + extra)


DICTS = {"small": SMALL, "large_ascii": _large(False),
         "large_utf8": _large(True)}
CAP = 8_192
LIVE = 8_000


def dict_pair(words, seed: int = 1, nulls: bool = True):
    """A dictionary-coded column in both packages: every slot used, then
    random codes; a twentieth of the live rows null."""
    rng = np.random.default_rng(seed)
    codes = np.zeros(CAP, dtype=np.int32)
    codes[:len(words)] = np.arange(len(words))
    codes[len(words):LIVE] = rng.integers(0, len(words), LIVE - len(words))
    valid = np.zeros(CAP, dtype=np.bool_)
    valid[:LIVE] = rng.random(LIVE) >= 0.05 if nulls else True
    port = DeviceColumn(torch.from_numpy(codes.copy()),
                        torch.from_numpy(valid.copy()),
                        PT.dictionary(PT.int32(), PT.string()), words)
    ref = JaxDeviceColumn(jnp.asarray(codes), jnp.asarray(valid),
                          RT.dictionary(RT.int32(), RT.string()),
                          at.array(list(words), RT.string()))
    return port, ref


def reference_eager(fn, cols, **options):
    """The reference's eager call: its pool transform where the ``pre``
    hook takes it (``registry.call_function``), else the function."""
    f = jax_registry.get_function(fn)
    if f.pre is not None:
        hit = f.pre(list(cols), [], dict(options))
        if hit is not None:
            return hit
    return f.impl(jax_registry.ExecContext(CAP, jnp.asarray(LIVE)), *cols,
                  **options)


def port_call(fn, cols, **options):
    return get_function(fn).impl(ExecContext(CAP, torch.tensor(LIVE)),
                                 *cols, **options)


def assert_same(got, want):
    """Codes or values (values of an int result compared as int64: the
    reference's host tier keeps int64 under an int32 type), validity,
    dictionary and type exact; a port int result is stored as int32."""
    g, w = got.values.numpy(), np.asarray(want.values)
    if w.dtype.kind in "iu":
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))
    else:
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity))
    if want.dictionary is not None:
        assert got.dictionary == tuple(want.dictionary.to_pylist())
        assert got.type.id == PT.TypeId.DICTIONARY
        return
    assert got.dictionary is None
    assert repr(got.type) == repr(want.type)
    if repr(want.type) == "int32":
        assert got.values.dtype == torch.int32


def _both(fn, kind, **options):
    port, ref = dict_pair(DICTS[kind])
    got = port_call(fn, [port], **options)
    want = reference_eager(fn, [ref], **options)
    assert_same(got, want)
    return got


TRANSFORMS = [
    ("utf8_upper", {}), ("utf8_lower", {}), ("utf8_swapcase", {}),
    ("utf8_capitalize", {}), ("utf8_title", {}), ("ascii_upper", {}),
    ("ascii_lower", {}), ("ascii_swapcase", {}), ("ascii_capitalize", {}),
    ("ascii_title", {}), ("utf8_reverse", {}), ("ascii_reverse", {}),
    ("binary_reverse", {}),
    ("utf8_trim_whitespace", {}), ("utf8_ltrim_whitespace", {}),
    ("utf8_rtrim_whitespace", {}), ("ascii_trim_whitespace", {}),
    ("ascii_ltrim_whitespace", {}), ("ascii_rtrim_whitespace", {}),
    ("utf8_trim", {"characters": " xa"}),
    ("utf8_ltrim", {"characters": "aFf3r"}),
    ("utf8_rtrim", {"characters": "0123456789 "}),
    ("utf8_trim", {"characters": ""}),
    ("utf8_trim", {"characters": "é "}),
    ("utf8_trim", {"characters": "abcdefghijklmnopq"}),
    ("ascii_trim", {"characters": "ab "}),
    ("ascii_ltrim", {"characters": " "}), ("ascii_rtrim", {"characters": "9"}),
    ("utf8_lpad", {"width": 12, "padding": "*"}),
    ("utf8_rpad", {"width": 12}), ("utf8_center", {"width": 13,
                                                   "padding": "-"}),
    ("utf8_center", {"width": 14}), ("utf8_lpad", {"width": 200}),
    ("ascii_center", {"width": 201, "padding": "."}),
    ("utf8_rpad", {"width": 20, "padding": "é"}),
    ("ascii_lpad", {"width": 3}), ("ascii_rpad", {"width": 15,
                                                  "padding": "#"}),
    ("utf8_slice_codeunits", {"start": 0, "stop": 2}),
    ("utf8_slice_codeunits", {"start": 3}),
    ("utf8_slice_codeunits", {"start": 2, "stop": 9}),
    ("utf8_slice_codeunits", {"start": 60}),
    ("utf8_slice_codeunits", {"start": 0, "stop": None, "step": 2}),
    ("utf8_slice_codeunits", {"start": -3}),
    ("utf8_slice_codeunits", {"start": 5, "stop": 3}),
    ("binary_slice", {"start": 1, "stop": 4}),
    ("binary_slice", {"start": -2}),
    ("binary_repeat", {"num_repeats": 3}),
    ("binary_repeat", {"num_repeats": 0}),
    ("replace_substring", {"pattern": "a", "replacement": "AA"}),
    ("replace_substring", {"pattern": "o", "replacement": "",
                           "max_replacements": 1}),
    ("replace_substring", {"pattern": "", "replacement": "-"}),
    ("replace_substring_regex", {"pattern": "[aeiou]+", "replacement": "_"}),
    ("replace_substring_regex", {"pattern": r"(\w)(\w)",
                                 "replacement": r"\2\1",
                                 "max_replacements": 2}),
    ("utf8_zero_fill", {"width": 6}),
    ("utf8_zero_fill", {"width": 4, "padding": "x"}),
    ("utf8_normalize", {"form": "NFC"}), ("utf8_normalize", {"form": "NFD"}),
    ("utf8_normalize", {"form": "NFKC"}),
    ("utf8_normalize", {"form": "NFKD"}),
    ("utf8_replace_slice", {"start": 1, "stop": 3, "replacement": "ZZ"}),
    ("utf8_replace_slice", {"start": 2, "replacement": "…"}),
    ("binary_replace_slice", {"start": 0, "stop": 1, "replacement": b"b"}),
    ("binary_replace_slice", {"start": 1, "stop": 2, "replacement": "q"}),
]


def _ids(cases):
    return [f"{fn}-{'-'.join(f'{k}={v!r}' for k, v in o.items())}"
            for fn, o in cases]


@pytest.mark.parametrize("kind", list(DICTS))
@pytest.mark.parametrize("fn,options", TRANSFORMS, ids=_ids(TRANSFORMS))
def test_transform_matches_jax(fn, options, kind):
    _both(fn, kind, **options)


PREDICATES = [(f"{p}_is_{n}", {}) for p in ("utf8", "ascii")
              for n in ("alnum", "alpha", "decimal", "lower", "upper",
                        "space", "title", "printable")] + [
    ("utf8_is_digit", {}), ("utf8_is_numeric", {}),
    ("string_is_ascii", {}), ("utf8_length", {}), ("binary_length", {}),
    ("match_substring", {"pattern": "an"}),
    ("match_substring", {"pattern": ""}),
    ("match_substring", {"pattern": "FoReSt", "ignore_case": True}),
    ("match_substring", {"pattern": "é"}),
    ("match_substring_regex", {"pattern": "^(green|red) "}),
    ("match_substring_regex", {"pattern": "A.C", "ignore_case": True}),
    ("starts_with", {"pattern": "forest"}),
    ("starts_with", {"pattern": "FOREST", "ignore_case": True}),
    ("ends_with", {"pattern": "9"}), ("ends_with", {"pattern": ""}),
    ("match_like", {"pattern": "%an%"}), ("match_like", {"pattern": "a_c%"}),
    ("match_like", {"pattern": "abc"}),
    ("count_substring", {"pattern": "a"}),
    ("count_substring", {"pattern": "aa"}),
    ("count_substring", {"pattern": "xx x"}),
    ("count_substring", {"pattern": "A", "ignore_case": True}),
    ("count_substring", {"pattern": "é"}),
    ("count_substring", {"pattern": "z" * 300}),
    ("find_substring", {"pattern": "a"}),
    ("find_substring", {"pattern": "xx"}),
    ("find_substring", {"pattern": ""}),
    ("find_substring", {"pattern": "GREEN", "ignore_case": True}),
    ("find_substring", {"pattern": "z" * 300}),
    ("count_substring_regex", {"pattern": "[aeiou]"}),
    ("count_substring_regex", {"pattern": "x*"}),
    ("count_substring_regex", {"pattern": "A", "ignore_case": True}),
    ("find_substring_regex", {"pattern": r"\d"}),
    ("find_substring_regex", {"pattern": "B+", "ignore_case": True}),
]


@pytest.mark.parametrize("kind", list(DICTS))
@pytest.mark.parametrize("fn,options", PREDICATES, ids=_ids(PREDICATES))
def test_predicate_matches_jax(fn, options, kind):
    _both(fn, kind, **options)


def test_count_of_an_empty_pattern_is_pythons_in_both_tiers(monkeypatch):
    """The reference's pool counts the bytes of a non-ASCII value (plus
    one) where its host tier and Python count characters: the port gives
    Python's on its pool too."""
    port, ref = dict_pair(DICTS["large_utf8"])
    got = port_call("count_substring", [port], pattern="")
    assert device_strings.dictionary_pool(port.dictionary,
                                          torch.device("cpu")) is not None
    pool_ref = reference_eager("count_substring", [ref], pattern="")
    monkeypatch.setenv("ARROW_TPU_DEVICE_STRINGS", "off")
    host_ref = reference_eager("count_substring", [ref], pattern="")
    assert_same(got, host_ref)
    slot = port.dictionary.index("Été à Paris")
    assert int(got.values[slot]) == len("Été à Paris") + 1
    assert int(pool_ref.values[slot]) == len("Été à Paris".encode()) + 1


def test_null_slot_follows_each_tier_of_the_reference():
    """Host tier: the case functions map a null slot to the function of
    "" (upper of null is ""), the pads keep it null. Pool: an empty
    value."""
    small, small_ref = dict_pair(SMALL)
    large, large_ref = dict_pair(DICTS["large_ascii"])
    slot = SMALL.index(None)
    up = port_call("utf8_upper", [small])
    assert up.dictionary[int(up.values[slot])] == ""
    pad = port_call("utf8_lpad", [small], width=4)
    assert pad.dictionary[int(pad.values[slot])] is None
    pool_pad = port_call("utf8_lpad", [large], width=4)
    big_slot = DICTS["large_ascii"].index(None)
    assert pool_pad.dictionary[int(pool_pad.values[big_slot])] == ""
    for got, want in ((up, reference_eager("utf8_upper", [small_ref])),
                      (pad, reference_eager("utf8_lpad", [small_ref],
                                            width=4)),
                      (pool_pad, reference_eager("utf8_lpad", [large_ref],
                                                 width=4))):
        assert_same(got, want)


def test_int_results_are_int32():
    """The reference's host tier gathers an int64 table under an int32
    type; its pool gives int32; the port stores int32 in both tiers."""
    for kind in ("small", "large_ascii"):
        port, ref = dict_pair(DICTS[kind])
        for fn, opts in (("utf8_length", {}),
                         ("count_substring", {"pattern": "a"}),
                         ("find_substring", {"pattern": "a"})):
            got = port_call(fn, [port], **opts)
            want = reference_eager(fn, [ref], **opts)
            assert got.values.dtype == torch.int32
            assert repr(want.type) == "int32" == repr(got.type)
            if kind == "small":
                assert np.asarray(want.values).dtype == np.int64


@pytest.mark.parametrize("fn", ["utf8_title", "utf8_capitalize"])
def test_title_and_capitalize_are_byte_rules_on_ascii(fn):
    port, ref = dict_pair(DICTS["large_ascii"])
    got = port_call(fn, [port])
    assert_same(got, reference_eager(fn, [ref]))
    method = str.title if fn == "utf8_title" else str.capitalize
    for v in ("3rd avenue", "o'neil", "xx xx"):
        slot = DICTS["large_ascii"].index(v)
        assert got.dictionary[int(got.values[slot])] == method(v)


@pytest.mark.parametrize("fn,options", [
    ("utf8_upper", {}), ("utf8_title", {}), ("utf8_reverse", {}),
    ("utf8_trim", {"characters": "F0 "}), ("utf8_rtrim_whitespace", {}),
    ("utf8_center", {"width": 80, "padding": "~"}),
    ("utf8_slice_codeunits", {"start": 0, "stop": 3})])
def test_pool_and_host_tiers_give_one_dictionary(fn, options):
    """Without a null slot the port's two tiers agree: the same new
    dictionary, in order of first appearance, and the same codes."""
    words = tuple(v for v in DICTS["large_ascii"] if v is not None)
    port, _ = dict_pair(words)
    device_strings.clear_pools()
    pool = port_call(fn, [port], **options)
    assert device_strings.is_pooled(words, torch.device("cpu"))
    small = device_strings.DEVICE_STRINGS_MIN
    try:
        device_strings.DEVICE_STRINGS_MIN = 10 ** 9   # the host tier
        host = port_call(fn, [port], **options)
    finally:
        device_strings.DEVICE_STRINGS_MIN = small
    assert pool.dictionary == host.dictionary
    assert torch.equal(pool.values, host.values)
    assert len(pool.dictionary) < len(words) or fn != "utf8_upper"


def test_pool_transform_gates():
    """The pool declines a dictionary below the gate, a non-ASCII pool,
    more than 16 trim characters, a non-ASCII or long padding, a step or
    a negative start."""
    cpu = torch.device("cpu")
    large, _ = dict_pair(DICTS["large_ascii"])
    utf8, _ = dict_pair(DICTS["large_utf8"])
    small, _ = dict_pair(SMALL)
    pt = device_strings.pool_transform
    assert pt("upper", large) is not None
    assert pt("upper", utf8) is None and pt("upper", small) is None
    assert pt("trim", large, {"characters": "a" * 17}) is None
    assert pt("lpad", large, {"width": 9, "padding": "é"}) is None
    assert pt("lpad", large, {"width": 9, "padding": "ab"}) is None
    assert pt("slice", large, {"start": 0, "step": 2}) is None
    assert pt("slice", large, {"start": -1}) is None
    assert device_strings.is_pooled(large.dictionary, cpu)


def test_binary_join_element_wise_matches_jax():
    """Two parts and a separator column, nulls in each; a literal among
    the columns is dropped (the last column is the separator), as in the
    reference; a product above 2**20 values raises in both."""
    a, ra = dict_pair(SMALL, seed=1)
    b, rb = dict_pair(("x", None, "yy", "", "Z"), seed=2)
    sep, rsep = dict_pair(("-", ", "), seed=3)
    for cols, rcols in (([a, b, sep], [ra, rb, rsep]),
                        ([a, b, "+"], [ra, rb, "+"]),
                        ([b, a, b, sep], [rb, ra, rb, rsep])):
        got = port_call("binary_join_element_wise", cols)
        want = reference_eager("binary_join_element_wise", rcols)
        assert_same(got, want)
    big, rbig = dict_pair(DICTS["large_ascii"])
    with pytest.raises(NotImplementedError, match="too large"):
        port_call("binary_join_element_wise", [big, big, sep])
    with pytest.raises(NotImplementedError):
        reference_eager("binary_join_element_wise", [rbig, rbig, rsep])


def test_functions_need_a_string_column():
    col = DeviceColumn(torch.arange(4), None, PT.int64())
    for fn, args in (("utf8_upper", [col]), ("utf8_length", [col]),
                     ("count_substring_regex", [col]),
                     ("utf8_normalize", [col]),
                     ("binary_join_element_wise", [col, col])):
        with pytest.raises(NotImplementedError,
                           match="requires a string column"):
            get_function(fn).impl(None, *args)


def _plan_table():
    rng = np.random.default_rng(9)
    n = 700
    s = [SMALL[i] for i in rng.integers(0, len(SMALL), n)]
    t = [("ab", "C", None, "dd")[i] for i in rng.integers(0, 4, n)]
    sep = ["/"] * n
    return Table.from_pydict({"s": at.array(s, at.string()),
                              "t": at.array(t, at.string()),
                              "sep": at.array(sep, at.string()),
                              "k": at.array(np.arange(n), at.int64())})


def test_string_functions_in_plans_match_jax():
    """A projection of str -> str, str -> int and str -> bool functions
    and a join of columns, and a filter on a derived string, through both
    packages' plans on the same table."""
    table = _plan_table()
    tb = carry_across(upload_table(table))

    def plan(mod, batch):
        f, call = mod.field, mod.Expression.call
        upper = call("utf8_upper", f("s"))
        return mod.Declaration.from_sequence([
            mod.Declaration("table_source",
                            mod.TableSourceNodeOptions(batch)),
            mod.Declaration("filter", mod.FilterNodeOptions(
                call("utf8_length", upper) > 3)),
            mod.Declaration("project", mod.ProjectNodeOptions(
                [f("k"), upper, call("utf8_lpad", f("s"), width=8),
                 call("count_substring", f("s"), pattern="a"),
                 call("ascii_is_upper", f("s")),
                 call("binary_join_element_wise", f("s"), f("t"),
                      f("sep"))],
                ["k", "up", "pad", "n_a", "is_up", "joined"]))])

    got = plan(tacero, tb).to_table()
    want = plan(jacero, table).to_table().to_pydict()
    assert 0 < len(got["k"]) < table.num_rows
    assert_tables_match(got, want)


# --- registry coverage -------------------------------------------------------

def _reference_names():
    by_module = {}
    for n, f in jax_registry._REGISTRY.items():
        mod = getattr(f.impl, "__module__", "").rsplit(".", 1)[-1]
        by_module.setdefault((mod, f.kind), []).append(n)
    return by_module


def test_every_name_of_the_slice_is_registered():
    """The 107 device-tier names of the reference's strings.py (65),
    temporal.py (21) and extra_kernels.py (15 temporal, 6 strings) resolve
    in the port, as does the rest of extra_kernels.py but for its
    host-tier names, which raise naming item 11."""
    names = _reference_names()
    strings = names[("strings", "elementwise")]
    temporal = names[("temporal", "elementwise")]
    extra = names[("extra_kernels", "elementwise")]
    assert (len(strings), len(temporal)) == (65, 21)
    ported_extra = [n for n in extra if n not in ("hypot", "round_binary")]
    assert len(ported_extra) == 21
    assert len(strings + temporal + ported_extra) == 107
    for n in strings + temporal + extra:
        assert get_function(n).kind == "elementwise", n
    host = sorted(n for (m, k), ns in names.items() if k == "host"
                  for n in ns)
    assert len(host) >= 26
    for n in host:
        with pytest.raises(NotImplementedError, match="item 11"):
            get_function(n)
    rest = [n for (m, k), ns in names.items() if m == "extra_kernels"
            and k != "host" for n in ns if n not in ported_extra]
    assert len(rest) == 15
    for n in rest:
        if n in ("hash_list", "hash_distinct", "hash_pivot_wider"):
            with pytest.raises(NotImplementedError, match="item 11"):
                get_function(n)
        else:
            assert get_function(n).name == n