"""The port's CUDA kernels against their plain PyTorch versions on the card,
the join types, Q4, Q13 and phase 3c's TPC-H suite on the card, and plans
streamed from pinned host memory over a copy stream.

These tests need a CUDA card, carry the ``cuda`` marker and skip elsewhere.
The machine with the card has no JAX, so this file imports only torch, the
port and ``chip_smoke.py`` (for its join oracle), and runs without the
suite's conftest (which imports JAX), from the root of the checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from arrow_tpu_torch.kernels.compact import (MAX_COLUMNS, compact,
                                             compact_plain)
from arrow_tpu_torch.kernels.grouped_sum import (grouped_sum,
                                                 grouped_sum_plain)
from arrow_tpu_torch.kernels.hash32 import hash32, hash32_plain
from arrow_tpu_torch.kernels.probe import probe, probe_plain


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _rtol(dtype):
    # the kernel adds f64 in another order than the plain version; f32 is
    # compared with an f64 sum
    return 1e-9 if dtype == torch.float64 else 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("num_segments,dtype", [
    (1, torch.float64), (12, torch.float64), (24, torch.float64),
    (25, torch.float64), (512, torch.float64), (1024, torch.float64),
    (16, torch.float32), (700, torch.float32)])
def test_grouped_sum_matches_plain(num_segments, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(num_segments)
    n = (1 << 20) + 3  # a ragged tail past the 16-byte loads
    v = (torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
         * 1e5).to(dtype)
    g = torch.randint(0, num_segments, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    before = grouped_sum.launches
    got = grouped_sum(v, g, num_segments)
    torch.cuda.synchronize()
    assert grouped_sum.launches == before + 1
    assert got.dtype == dtype and got.shape == (num_segments,)
    torch.testing.assert_close(
        got.double(), grouped_sum_plain(v.double(), g, num_segments),
        atol=0, rtol=_rtol(dtype))
    # a view one element in is not 16-byte aligned: the scalar loop
    got = grouped_sum(v[1:], g[1:], num_segments)
    torch.testing.assert_close(
        got.double(), grouped_sum_plain(v[1:].double(), g[1:], num_segments),
        atol=0, rtol=_rtol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("num_segments", [12, 25, 1024])
def test_grouped_sum_repeats_bit_for_bit(num_segments):
    """One input gives the same bits on every run and from a copy that
    is not 16-byte aligned; so does the general path's sum over more than
    1,024 segments."""
    from arrow_tpu_torch.compute.move import segment_sum
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(num_segments)
    n = (1 << 22) + 1
    v = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64)
    g = torch.randint(0, num_segments, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    first = grouped_sum(v, g, num_segments)
    v_odd = torch.empty(n + 1, dtype=v.dtype, device="cuda")[1:]
    g_odd = torch.empty(n + 1, dtype=g.dtype, device="cuda")[1:]
    v_odd.copy_(v)
    g_odd.copy_(g)
    for again in (grouped_sum(v, g, num_segments),
                  grouped_sum(v_odd, g_odd, num_segments)):
        assert torch.equal(again.view(torch.int64), first.view(torch.int64))
    live = torch.rand(n, generator=gen, device="cuda") < 0.5
    wide = g.long() * 977
    runs = [segment_sum(v, wide, 1024 * 977, live) for _ in range(2)]
    assert torch.equal(runs[0].view(torch.int64), runs[1].view(torch.int64))


@pytest.mark.cuda
def test_grouped_sum_inf_nan_and_empty_groups():
    _need_card()
    v = torch.ones(10_000, dtype=torch.float64, device="cuda")
    g = (torch.arange(10_000, device="cuda") % 4).to(torch.int32)
    v[5], v[6] = float("inf"), float("nan")  # groups 1 and 2
    got = grouped_sum(v, g, 8).cpu()
    assert got[0] == 2500.0 and got[3] == 2500.0
    assert torch.isinf(got[1]) and torch.isnan(got[2])
    assert torch.all(got[4:] == 0.0)


@pytest.mark.cuda
def test_grouped_sum_rejects_mixed_devices():
    _need_card()
    with pytest.raises(ValueError):
        grouped_sum(torch.ones(8, dtype=torch.float64, device="cuda"),
                    torch.zeros(8, dtype=torch.int32), 4)


@pytest.mark.cuda
def test_probe_matches_plain():
    _need_card()
    x = torch.randn(8, 128, device="cuda")
    before = probe.launches
    y = probe(x)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(y, probe_plain(x))


def _bits(t):
    """An integer view of a tensor's bits, so equality is bit for bit."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _columns(n, gen):
    f64 = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64)
    f64[::7] = float("nan")
    f64[1::7] = -0.0
    # a NaN with a payload and the sign bit set
    f64.view(torch.int64)[2::7] = -0x0007_0000_0000_1234
    return [torch.rand(n, generator=gen, device="cuda") < 0.5,
            torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                          device="cuda", dtype=torch.int32),
            torch.randint(-2**62, 2**62, (n,), generator=gen, device="cuda",
                          dtype=torch.int64),
            f64, f64.float()]


@pytest.mark.cuda
@pytest.mark.parametrize("n,frac", [
    (1, 1.0), (4095, 0.5), (4096, 0.3), (1_000_003, 0.5), (1_000_003, 0.0),
    (1_000_003, 1.0), (3 * 4096 + 1, 0.999)])
def test_compact_matches_plain(n, frac):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n)
    keep = torch.rand(n, generator=gen, device="cuda") < frac
    cols = _columns(n, gen)
    before = compact.launches
    outs, count = compact(keep, cols)
    torch.cuda.synchronize()
    assert compact.launches == before + 1
    want, want_count = compact_plain(keep, cols)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert count.device.type == "cuda"
    assert int(count) == int(want_count) == int(keep.sum())
    for got, w in zip(outs, want):
        assert got.dtype == w.dtype and got.shape == w.shape
        assert torch.equal(_bits(got), _bits(w))


@pytest.mark.cuda
@pytest.mark.parametrize("n,frac", [(1, 1.0), (4097, 0.5),
                                    (1_000_003, 0.3)])
def test_compact_two_byte_columns_match_plain(n, frac):
    """int16, uint16 (its int16 bits) and f16 columns, with f16 NaN
    payloads, -0.0 and infinities, beside 1- and 8-byte columns, bit for
    bit."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + 2)
    keep = torch.rand(n, generator=gen, device="cuda") < frac
    i16 = torch.randint(-2**15, 2**15, (n,), generator=gen, device="cuda",
                        dtype=torch.int16)
    half = torch.randn(n, generator=gen, device="cuda").to(torch.float16)
    bits = half.view(torch.int16)
    for start, pattern in ((0, 0x7E01), (1, -0x8000), (2, 0x7C00),
                           (3, 0xFE00 - 0x10000)):
        bits[start::5] = pattern
    cols = [i16, half, i16.flip(0).contiguous(),
            keep.clone(), torch.arange(n, device="cuda")]
    before = compact.launches
    outs, count = compact(keep, cols)
    torch.cuda.synchronize()
    assert compact.launches == before + 1
    want, want_count = compact_plain(keep, cols)
    assert int(count) == int(want_count)
    for got, w in zip(outs, want):
        assert got.dtype == w.dtype and torch.equal(_bits(got), _bits(w))


@pytest.mark.cuda
def test_compact_many_columns():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = 70_001
    keep = torch.rand(n, generator=gen, device="cuda") < 0.4
    # widths 1, 4, 8, 8, 4 and 2, over and over
    cols = [c for _ in range(11) for c in _columns(n, gen) + [
        torch.randint(-2**15, 2**15, (n,), generator=gen, device="cuda",
                      dtype=torch.int16)]][:MAX_COLUMNS]
    outs, _ = compact(keep, cols)
    want, _ = compact_plain(keep, cols)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(outs, want))


_WIDTH_DTYPES = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def _random_column(n, width, gen):
    """n random elements of ``width`` bytes (every bit pattern)."""
    raw = torch.randint(0, 256, (n * width,), generator=gen, device="cuda",
                        dtype=torch.uint8)
    return raw.view(_WIDTH_DTYPES[width])


def _assert_compacts(keep, cols):
    """compact against compact_plain: the count and every output bit for
    bit; returns the outputs and the count."""
    before = compact.launches
    outs, count = compact(keep, cols)
    torch.cuda.synchronize()
    assert compact.launches == before + 1
    want, want_count = compact_plain(keep, cols)
    assert count.dtype == torch.int32 and count.device.type == "cuda"
    assert int(count) == int(want_count) == int(keep.sum())
    for got, w in zip(outs, want):
        assert got.dtype == w.dtype and got.shape == w.shape
        assert torch.equal(_bits(got), _bits(w))
    return outs, count


def _mask(n, pattern, gen):
    if pattern in ("half", "sparse"):
        # 2% kept: a tile reads its 2-, 4- and 8-byte columns row by row
        # where kept and copies its 1-byte ones whole
        frac = 0.5 if pattern == "half" else 0.02
        return torch.rand(n, generator=gen, device="cuda") < frac
    keep = torch.zeros(n, dtype=torch.bool, device="cuda")
    if pattern == "all":
        keep[:] = True
    elif pattern == "first":
        keep[0] = True
    elif pattern == "last":
        keep[-1] = True
    return keep


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(1, 2, 4, 8), (2, 1), (1,)])
@pytest.mark.parametrize("pattern", ["half", "sparse", "none", "all", "first",
                                     "last"])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4095, 4096, 4097, 8193, 16383,
                               16384, 16385, 3 * 16384 + 5])
def test_compact_tile_edges(n, pattern, widths):
    """Row counts at the edges of a thread's 16 rows and of the tiles of
    4,096, 8,192 and 16,384 rows (a row with a 4- or 8-byte column, with 2
    bytes at most, with 1 byte), under masks that keep half, 2%, none, all,
    only the first or only the last row."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n)
    cols = [_random_column(n, w, gen) for w in widths]
    _assert_compacts(_mask(n, pattern, gen), cols)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(1,), (2,), (4,), (8,), (1, 2, 4, 8),
                                    (8, 1, 8, 2, 4, 1)])
def test_compact_each_width(widths):
    """Every width alone and mixed, 1,000,003 rows."""
    _need_card()
    n = 1_000_003
    gen = torch.Generator(device="cuda").manual_seed(sum(widths))
    cols = [_random_column(n, w, gen) for w in widths]
    for pattern in ("half", "sparse", "first", "last"):
        _assert_compacts(_mask(n, pattern, gen), cols)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
def test_compact_bases_off_alignment(offset):
    """Columns and the mask that start ``offset`` bytes past a 16-byte
    line (a slice of a larger tensor), at each width where the offset is
    a multiple of it, beside an aligned column."""
    _need_card()
    n = 300_007
    gen = torch.Generator(device="cuda").manual_seed(offset)
    keep = (torch.rand(n + offset, generator=gen, device="cuda")
            < 0.5)[offset:]
    cols = [_random_column(n, 8, gen)]
    for w in (1, 2, 4, 8):
        if offset % w == 0:
            cols.append(_random_column(n + offset // w, w, gen)[offset // w:])
    assert all(c.data_ptr() % 16 == offset for c in cols[1:])
    assert keep.data_ptr() % 16 == offset
    _assert_compacts(keep, cols)


@pytest.mark.cuda
def test_compact_chains_many_tiles():
    """2**26 + 7 rows: 4,097 count tiles chain their offsets by
    look-back."""
    _need_card()
    n = (1 << 26) + 7
    gen = torch.Generator(device="cuda").manual_seed(26)
    cols = [_random_column(n, w, gen) for w in (1, 4)]
    _assert_compacts(torch.rand(n, generator=gen, device="cuda") < 0.3, cols)


@pytest.mark.cuda
def test_compact_repeats_bit_for_bit():
    """The same input 20 times: the same count and bits each time."""
    _need_card()
    n = 5_000_011
    gen = torch.Generator(device="cuda").manual_seed(20)
    keep = torch.rand(n, generator=gen, device="cuda") < 0.5
    cols = [_random_column(n, w, gen) for w in (2, 8)]
    first, count = _assert_compacts(keep, cols)
    for _ in range(19):
        outs, again = compact(keep, cols)
        assert int(again) == int(count)
        assert all(torch.equal(_bits(o), _bits(f))
                   for o, f in zip(outs, first))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 16])
def test_hash32_matches_plain(k):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(k)
    n = (1 << 20) + 5
    words = [torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                           device="cuda", dtype=torch.int32)
             for _ in range(k)]
    for w in words:  # 0, 0x80000000 and 0xFFFFFFFF
        w[:3] = torch.tensor([0, -2**31, -1], dtype=torch.int32)
    before = hash32.launches
    got = hash32(words)
    torch.cuda.synchronize()
    assert hash32.launches == before + 1
    assert torch.equal(got, hash32_plain(words))


@pytest.mark.cuda
def test_hash32_strided_halves_of_int64():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(9)
    w = torch.randint(-2**62, 2**62, (100_003,), generator=gen,
                      device="cuda", dtype=torch.int64)
    halves = [w.view(torch.int32)[0::2], w.view(torch.int32)[1::2]]
    want = hash32_plain([h.contiguous() for h in halves])
    assert torch.equal(hash32(halves), want)


@pytest.mark.cuda
def test_refused_dtypes_raise_rather_than_fall_back():
    _need_card()
    keep = torch.ones(16, dtype=torch.bool, device="cuda")
    # 2-byte columns are the kernel's since it moves int16, uint16 and
    # f16 at their width; complex values stay refused at any width
    for bad in (torch.ones(16, dtype=torch.complex64, device="cuda"),
                torch.ones(16, dtype=torch.complex128, device="cuda")):
        with pytest.raises(ValueError):
            compact(keep, [bad])
    with pytest.raises(ValueError):
        compact(keep.int(), [keep])
    with pytest.raises(ValueError):
        compact(keep, [torch.ones(16, device="cuda")] * (MAX_COLUMNS + 1))
    with pytest.raises(ValueError):
        compact(keep, [torch.ones(32, device="cuda")[::2]])
    with pytest.raises(ValueError):
        hash32([torch.ones(16, dtype=torch.int64, device="cuda")])
    with pytest.raises(ValueError):
        hash32([torch.ones(16, dtype=torch.int32, device="cuda"),
                torch.ones(16, dtype=torch.int32)])


# --- the join types and Q4/Q13 on the card --------------------------------

_JOIN_TYPES = ("inner", "left outer", "right outer", "full outer",
               "left semi", "left anti", "right semi", "right anti")


@pytest.mark.cuda
@pytest.mark.parametrize("jt", _JOIN_TYPES)
def test_join_type_on_card_matches_oracle(jt):
    """Null and duplicate keys on both sides, the bloom and compaction
    kernels on the path: rows, order and validity against chip_smoke's
    numpy oracle."""
    _need_card()
    import chip_smoke
    (probe_b, probe), (build_b, build) = chip_smoke.null_key_tables(
        50_000, 10_000, "cuda", seed=len(jt))
    from arrow_tpu_torch.acero.exec import execute_declaration
    before = compact.launches
    batch = execute_declaration(chip_smoke.join_declaration(
        jt, probe_b, build_b, left_keys=["pk"], right_keys=["bk"],
        left_output=["pid"], right_output=["bid"]))
    rows = chip_smoke.check_join(jt, batch, probe, build,
                                 chip_smoke.match_runs(probe, build))
    assert rows > 0
    if jt != "left outer":  # every other type compacts on the card
        assert compact.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["q4", "q13"])
def test_q4_q13_on_card_match_cpu(query):
    _need_card()
    from arrow_tpu_torch.io import tpch, tpch_queries
    results = []
    for device in ("cuda", "cpu"):
        orders = tpch.orders_table(0.01, device=device)
        if query == "q4":
            plan = tpch_queries.q4_plan(
                orders, tpch.lineitem_table(0.01, device=device))
        else:
            plan = tpch_queries.q13_plan(
                tpch.customer_table(0.01, device=device), orders)
        results.append(plan.to_table().to_pydict())
    assert results[0] == results[1] and len(next(iter(results[0].values())))


def _suite_queries():
    import chip_smoke
    return chip_smoke.SUITE


@pytest.mark.cuda
@pytest.mark.parametrize("query", _suite_queries(), ids=lambda q: q.name)
def test_suite_query_on_card_matches_oracle(query):
    """Each query of chip_smoke's phase 3c over SF 0.05 tables made on the
    card, against its numpy oracle."""
    _need_card()
    import chip_smoke
    from arrow_tpu_torch.io import tpch
    from arrow_tpu_torch.io.tpch_device import q1_device_batch
    tables = tpch.generate(0.05)
    tables["lineitem"], _ = q1_device_batch(0.05)
    want, n_rows = query.oracle(tables, chip_smoke._suite_columns(tables))
    assert n_rows > 0
    chip_smoke.check_result(query.name, chip_smoke.suite_plan(
        query, tables).to_table().to_pydict(), want)


# --- the vector functions and statistics on the card -----------------------

_TYPED_WIDTHS = {1: "int8", 2: "int16", 4: "uint32", 8: "float64"}


def _typed_column(n, width, gen):
    """A column of ``width`` bytes with every bit pattern and 10% nulls,
    typed as the port types such a column."""
    from arrow_tpu_torch.device.column import DeviceColumn
    from arrow_tpu_torch.types import type_for_name
    valid = torch.rand(n, generator=gen, device="cuda") >= 0.1
    return DeviceColumn(_random_column(n, width, gen).view(
        {1: torch.int8, 2: torch.int16, 4: torch.int32,
         8: torch.float64}[width]), valid,
        type_for_name(_TYPED_WIDTHS[width]))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["drop", "emit_null", "drop_null"])
@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_filter_on_typed_columns_is_bit_exact(width, fn):
    """``filter`` under a nullable mask (both behaviours) and
    ``drop_null`` launch K2 once each; values and validity are those of
    ``compact_plain`` on the same buffers, bit for bit."""
    from arrow_tpu_torch.compute.registry import ExecContext, get_function
    from arrow_tpu_torch.compute.selection import _buffers, selection_mask
    from arrow_tpu_torch.device.column import DeviceColumn
    from arrow_tpu_torch.types import type_for_name
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(width)
    n = (1 << 20) + 11
    col = _typed_column(n, width, gen)
    ctx = ExecContext(n + 5, torch.tensor(n - 3, dtype=torch.int32,
                                          device="cuda"))
    col = DeviceColumn(torch.cat([col.values, col.values[:5]]),
                       torch.cat([col.validity, col.validity[:5]]), col.type)
    mask = DeviceColumn(torch.rand(n + 5, generator=gen, device="cuda") < 0.4,
                        torch.rand(n + 5, generator=gen, device="cuda") >= 0.2,
                        type_for_name("bool"))
    before = compact.launches
    if fn == "drop_null":
        got = get_function("drop_null").impl(ctx, col)
        keep, extra = col.valid_mask(ctx.row_mask()), None
    else:
        got = get_function("filter").impl(ctx, col, mask,
                                          null_selection_behavior=fn)
        keep, extra = selection_mask(ctx, mask, fn)
    torch.cuda.synchronize()
    assert compact.launches == before + 1
    arrays, _ = _buffers([col], extra)
    want, count = compact_plain(keep, arrays)
    assert int(got.count) == int(count)
    assert torch.equal(_bits(got.column.values), _bits(want[0]))
    assert torch.equal(got.column.validity, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("num_segments", [12, 1024])
def test_hash_variance_sums_match_plain(num_segments):
    """``hash_variance``'s two sums (the values, then the squared
    deviations) go through K1 up to 1,024 groups: two launches, each
    within 1e-9 of its plain version, and the variance within 1e-9 of
    the one computed from the plain sums."""
    from arrow_tpu_torch.compute.registry import ExecContext, get_function
    from arrow_tpu_torch.device.column import DeviceColumn
    from arrow_tpu_torch.types import type_for_name
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(num_segments)
    n = (1 << 22) + 3
    v = torch.randn(n, generator=gen, device="cuda",
                    dtype=torch.float64) * 1e3 + 5e4
    valid = torch.rand(n, generator=gen, device="cuda") >= 0.05
    gids = torch.randint(0, num_segments, (n,), generator=gen,
                         device="cuda")
    ctx = ExecContext(n, torch.tensor(n, dtype=torch.int32, device="cuda"))
    col = DeviceColumn(v, valid, type_for_name("float64"))
    before = grouped_sum.launches
    got = get_function("hash_variance").impl(
        ctx, col, gids, torch.tensor(num_segments, device="cuda"),
        num_segments=num_segments)
    torch.cuda.synchronize()
    assert grouped_sum.launches == before + 2
    seg = gids.to(torch.int32)
    x = torch.where(valid, v, 0.0)
    counts = torch.zeros(num_segments, dtype=torch.int64, device="cuda")
    counts.index_add_(0, gids, valid.long())
    sums = grouped_sum(x, seg, num_segments)
    torch.testing.assert_close(sums, grouped_sum_plain(x, seg, num_segments),
                               atol=0, rtol=1e-9)
    mean = grouped_sum_plain(x, seg, num_segments) / counts.clamp(min=1)
    dev = torch.where(valid, x - mean[gids], 0.0)
    squares = grouped_sum(dev * dev, seg, num_segments)
    plain_squares = grouped_sum_plain(dev * dev, seg, num_segments)
    torch.testing.assert_close(squares, plain_squares, atol=0, rtol=1e-9)
    torch.testing.assert_close(got.column.values,
                               plain_squares / counts.clamp(min=1),
                               atol=0, rtol=1e-9)


@pytest.mark.cuda
def test_segment_product_and_scan_repeat_bit_for_bit():
    """The float product over many segments (``segment_reduce`` with
    "prod" on the card) and the blocked cumulative sum give the same bits
    on every run, and agree with the CPU within 1e-12."""
    from arrow_tpu_torch.compute.move import segment_product
    from arrow_tpu_torch.compute.vector_sort import _scan
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = (1 << 22) + 7
    v = 1.0 + torch.rand(n, generator=gen, device="cuda",
                         dtype=torch.float64) * 1e-3
    gids = torch.randint(0, 1 << 20, (n,), generator=gen, device="cuda")
    live = torch.rand(n, generator=gen, device="cuda") >= 0.1
    first = segment_product(v, gids, 1 << 20, live)
    assert torch.equal(first, segment_product(v, gids, 1 << 20, live))
    torch.testing.assert_close(
        first.cpu(), segment_product(v.cpu(), gids.cpu(), 1 << 20,
                                     live.cpu()), atol=0, rtol=1e-12)
    s1 = _scan(v, "sum")
    assert torch.equal(s1, _scan(v, "sum"))
    torch.testing.assert_close(s1.cpu(), _scan(v.cpu(), "sum"), atol=0,
                               rtol=1e-12)


# --- the temporal and string functions on the card ---------------------------

def _words(n, seed):
    """``n`` distinct ASCII values (a dictionary above the pool's gate),
    case variants that one case function maps to one, a null slot."""
    import random
    rng = random.Random(seed)
    words = ("forest", "Forest", "green", "RED", "lace", "o'neil", "3rd")
    vals = {" ".join(rng.choice(words) for _ in range(3)) + f" {i % 3000}"
            for i in range(n)}
    return tuple(sorted(vals)) + (None, "", "  \t x  ")


def _dict_columns(words, seed):
    """The same dictionary-coded column on the card and on the CPU."""
    from arrow_tpu_torch.device.column import DeviceColumn
    from arrow_tpu_torch.types import type_for_name
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = 50_000
    codes = torch.randint(0, len(words), (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    valid = torch.rand(n, generator=gen, device="cuda") >= 0.05
    card = DeviceColumn(codes, valid, type_for_name("dictionary"), words)
    return card, DeviceColumn(codes.cpu(), valid.cpu(), card.type, words)


_POOL_CALLS = [
    ("utf8_upper", {}), ("utf8_lower", {}), ("utf8_swapcase", {}),
    ("utf8_capitalize", {}), ("utf8_title", {}), ("utf8_reverse", {}),
    ("utf8_trim_whitespace", {}), ("utf8_ltrim", {"characters": "Ff "}),
    ("utf8_rtrim", {"characters": "0123456789"}),
    ("utf8_lpad", {"width": 70, "padding": "*"}), ("utf8_rpad", {"width": 9}),
    ("utf8_center", {"width": 31}),
    ("utf8_slice_codeunits", {"start": 2, "stop": 8}),
    ("utf8_length", {}), ("binary_length", {}), ("string_is_ascii", {}),
    ("count_substring", {"pattern": "re"}),
    ("count_substring", {"pattern": ""}),
    ("find_substring", {"pattern": "RE", "ignore_case": True}),
    ("match_substring", {"pattern": "lace"}),
    ("starts_with", {"pattern": "forest"}), ("ends_with", {"pattern": "7"}),
    ("match_like", {"pattern": "green%"})]


@pytest.mark.cuda
@pytest.mark.parametrize("fn,options", _POOL_CALLS,
                         ids=[f"{f}-{i}" for i, (f, _) in
                              enumerate(_POOL_CALLS)])
def test_pool_tier_on_card_equals_cpu(fn, options):
    """Each byte-pool transform and predicate over a dictionary of 5,000
    values gives on the card the dictionary, codes, values and validity it
    gives on the CPU."""
    from arrow_tpu_torch.compute import device_strings
    from arrow_tpu_torch.compute.registry import ExecContext, get_function
    _need_card()
    words = _words(5_000, 1)
    card, cpu = _dict_columns(words, 2)
    assert len(words) >= device_strings.DEVICE_STRINGS_MIN
    n = card.capacity
    got = get_function(fn).impl(ExecContext(n, torch.tensor(n)), card,
                                **options)
    want = get_function(fn).impl(ExecContext(n, torch.tensor(n)), cpu,
                                 **options)
    assert device_strings.is_pooled(words, card.values.device)
    assert got.values.device.type == "cuda"
    assert got.dictionary == want.dictionary
    assert torch.equal(got.values.cpu(), want.values)
    assert torch.equal(got.validity.cpu(), want.validity)


@pytest.mark.cuda
@pytest.mark.parametrize("key,slots", [("type", 7), ("mfgr_container", 201)])
def test_derived_string_keys_take_k1_and_k3(key, slots):
    """Revenue by a key made of string functions (``strings_plan``'s two
    keys over SF 0.01's lineitem and part): one grouped-sum launch at 7
    slots (K1) and at 201 (K3's range), each key's revenue within 1e-9 of
    the CPU's run of the same plan."""
    import chip_smoke
    from arrow_tpu_torch.io import tpch
    from arrow_tpu_torch.io.tpch_device import q1_device_batch
    _need_card()
    runs = {}
    for dev in ("cuda", "cpu"):
        lineitem, _ = q1_device_batch(0.01, device=dev)
        tables = {"part": tpch.part_table(0.01, device=dev),
                  "customer": tpch.customer_table(0.01, device=dev)}
        s = chip_smoke.strings_inputs(tables)
        before = grouped_sum.launches
        result = chip_smoke.strings_plan(lineitem, s, key).to_table().to_pydict()
        torch.cuda.synchronize()
        if dev == "cuda":
            assert grouped_sum.launches == before + 1
        runs[dev] = dict(zip(result["key"], result["revenue"]))
    assert sorted(runs["cuda"]) == sorted(runs["cpu"])
    assert len(runs["cuda"]) <= slots - 1
    for k, v in runs["cpu"].items():
        assert runs["cuda"][k] == pytest.approx(v, rel=1e-9, abs=0)


_HASH_TYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
               "uint32", "uint64", "float16", "float32", "float64", "date32",
               "timestamp[ns]", "decimal128(12, 2)", "dictionary"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _HASH_TYPES)
def test_registered_hash32_on_card_matches_plain(name):
    """The registered ``hash32`` over a column of each type launches the
    hash kernel once and gives the plain version's bits, null rows (over
    stored values), NaN and -0.0 included."""
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.compute.hashing import column_words
    from arrow_tpu_torch.compute.registry import ExecContext, get_function
    from arrow_tpu_torch.device.column import DeviceColumn, torch_dtype_for
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(len(name))
    n = (1 << 20) + 5
    t = T.type_for_name(name)
    bits = torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen,
                         device="cuda", dtype=torch.int64)
    store = torch_dtype_for(t)
    if store == torch.bool:
        values = bits % 2 == 0
    elif store.is_floating_point:
        values = (bits.double() / (1 << 40)).to(store)
        values[::7] = float("nan")
        values[1::11] = -0.0
    else:
        values = bits.to(store)
    valid = torch.rand(n, generator=gen, device="cuda") > 0.1
    col = DeviceColumn(values, valid, t, ("a", "b") if name == "dictionary"
                       else None)
    ctx = ExecContext(n, torch.tensor(n, dtype=torch.int32, device="cuda"))
    before = hash32.launches
    got = get_function("hash32").impl(ctx, col)
    torch.cuda.synchronize()
    assert hash32.launches == before + 1
    assert got.validity is valid and repr(got.type) == "uint32"
    want = hash32_plain(column_words(col))
    assert torch.equal(got.values, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.bool])
def test_indices_nonzero_on_card_matches_plain(dtype):
    """``indices_nonzero`` launches the compaction once and keeps the
    positions of the live, valid, non-zero rows in order."""
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.compute.registry import ExecContext, get_function
    from arrow_tpu_torch.device.column import DeviceColumn
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, live = (1 << 21) + 3, (1 << 21) - 1000
    values = torch.randint(0, 4, (n,), generator=gen, device="cuda").to(dtype)
    valid = torch.rand(n, generator=gen, device="cuda") > 0.05
    t = {torch.float64: T.float64(), torch.int32: T.int32(),
         torch.bool: T.bool_()}[dtype]
    ctx = ExecContext(n, torch.tensor(live, dtype=torch.int32,
                                      device="cuda"))
    before = compact.launches
    got = get_function("indices_nonzero").impl(ctx, DeviceColumn(
        values, valid, t))
    torch.cuda.synchronize()
    assert compact.launches == before + 1
    keep = valid & (values != 0)
    keep[live:] = False
    idx = torch.arange(n, dtype=torch.int64, device="cuda")
    (want,), count = compact_plain(keep, [idx])
    assert int(got.count) == int(count)
    assert torch.equal(got.column.values, want)
    assert repr(got.column.type) == "uint64"


def _same_result(got, want, rtol=1e-9):
    """Keys, counts, nulls and order exact, floats within ``rtol``."""
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert [v is None for v in g] == [v is None for v in w], k
        if any(isinstance(v, float) for v in w):
            torch.testing.assert_close(
                torch.tensor([0.0 if v is None else v for v in g],
                             dtype=torch.float64),
                torch.tensor([0.0 if v is None else v for v in w],
                             dtype=torch.float64), rtol=rtol, atol=0)
        else:
            assert g == w, k


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["q1", "q3"])
def test_chunked_from_pinned_host_matches_whole(query):
    """Q1 and Q3 at SF 0.1 streamed from a pinned host lineitem in 5
    chunks on the card equal the same plan over lineitem on the card."""
    from arrow_tpu_torch.acero import chunked
    from arrow_tpu_torch.acero.exec import last_plan_metrics
    from arrow_tpu_torch.device.column import batch_to, pin_batch
    from arrow_tpu_torch.io import tpch
    from arrow_tpu_torch.io.tpch_queries import q1_plan, q3_plan
    _need_card()
    host = pin_batch(tpch.lineitem_table(0.1, device="cpu"))
    card = batch_to(host, "cuda")
    if query == "q1":
        plans = [q1_plan(li) for li in (host, card)]
    else:
        c, o = tpch.customer_table(0.1), tpch.orders_table(0.1)
        plans = [q3_plan(c, o, li) for li in (host, card)]
    got = plans[0].to_table(chunk_rows=1 << 17).to_pydict()
    source = last_plan_metrics.source
    assert chunked.LAST_FALLBACK_REASON is None
    assert source.n_chunks == 5 and source.stream is not None
    assert source.h2d_bytes > 0 and source.copy_ms() > 0
    _same_result(got, plans[1].to_table().to_pydict())


def _host_batch(n, pinned):
    import numpy as np
    from arrow_tpu_torch.device.column import batch_from_numpy, pin_batch
    rng = np.random.default_rng(5)
    b = batch_from_numpy([
        ("k", "int64", rng.integers(0, 1000, n), None, None),
        ("v", "float64", rng.normal(size=n), rng.random(n) > 0.1, None),
        ("s", "string", rng.integers(0, 3, n), None, ("a", "b", "c"))],
        n, device="cpu")
    return pin_batch(b) if pinned else b


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [True, False])
def test_chunk_source_copies_on_its_own_stream(pinned):
    """Chunks land on the card from pinned memory, copied on the source's
    own stream (not the current one); a pageable source is pinned once,
    at set-up, and its pinned copy kept for the next run."""
    from arrow_tpu_torch.acero import TableSourceNodeOptions
    from arrow_tpu_torch.acero.chunked import _ChunkSource
    _need_card()
    n, rows = 200_003, 1 << 16
    b = _host_batch(n, pinned)
    opts = TableSourceNodeOptions(b)
    source = _ChunkSource(opts, rows, torch.device("cuda"))
    assert source.stream is not None
    assert source.stream.cuda_stream != torch.cuda.current_stream().cuda_stream
    assert all(c.values.is_pinned() for c in source.batch.columns)
    assert all(c.values.is_pinned() == pinned for c in b.columns)
    again = _ChunkSource(opts, rows, torch.device("cuda"))
    assert again.batch is source.batch
    chunks = list(source)
    assert len(chunks) == 4 and source.h2d_bytes == n * (8 + 9 + 4)
    torch.cuda.synchronize()
    for i, chunk in enumerate(chunks):
        length = min(rows, n - i * rows)
        assert int(chunk.row_count) == length
        for c, h in zip(chunk.columns, b.columns):
            assert c.values.device.type == "cuda" and c.capacity == rows
            assert c.dictionary is h.dictionary
            assert torch.equal(c.values[:length].cpu(),
                               h.values[i * rows:i * rows + length])
            assert not c.values[length:].any()
    assert source.copy_ms() > 0


@pytest.mark.cuda
def test_streamed_float_sums_repeat_bit_for_bit():
    """A chunked grouped float sum on the card gives the same bits on a
    second run (``segment_sum``, not atomics)."""
    from arrow_tpu_torch.acero import (AggregateNodeOptions, Declaration,
                                       TableSourceNodeOptions)
    _need_card()
    b = _host_batch(300_000, True)
    plan = Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(b)),
        Declaration("aggregate", AggregateNodeOptions(
            [("v", "hash_sum", None, "s"), ("v", "hash_mean", None, "m")],
            keys=["s"]))])
    first = plan.to_table(chunk_rows=1 << 16).to_pydict()
    second = plan.to_table(chunk_rows=1 << 16).to_pydict()
    for k in ("s", "m"):
        a, b = (torch.tensor(r[k], dtype=torch.float64).view(torch.int64)
                for r in (first, second))
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_pinned_source_runs_on_the_card_unasked():
    """A pinned host batch's plan run whole with no device named
    (``to_table()``, ``to_batches()``) runs on the card: its filter
    launches K2."""
    from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                       TableSourceNodeOptions, field)
    _need_card()
    b = _host_batch(100_000, True)
    plan = Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(b)),
        Declaration("filter", FilterNodeOptions(field("k") < 500))])
    want = int((b.column("k").values[:100_000] < 500).sum())
    for run in (plan.to_table, lambda: plan.to_batches()[0]):
        before = compact.launches
        out = run()
        assert compact.launches == before + 1
        assert len(out["k"]) == want


@pytest.mark.cuda
def test_host_table_uploads_to_the_card():
    """A host Table of TPC-H orders uploaded to the card: the maker's
    batch bit for bit, kept on the source for the next run."""
    from arrow_tpu_torch.acero import TableSourceNodeOptions
    from arrow_tpu_torch.device.column import batch_to
    from arrow_tpu_torch.io import tpch
    _need_card()
    tbl, made = tpch.host_and_device("orders", 0.05, device="cuda")
    opts = TableSourceNodeOptions(tbl)
    up = opts.upload()
    assert up.row_count.device.type == "cuda"
    assert all(a is b for a, b in zip(up.columns, opts.upload().columns))
    for a, b in zip(up.columns, made.columns):
        assert a.values.is_cuda and torch.equal(a.values, b.values)
        assert a.dictionary == b.dictionary
    back = batch_to(up, "cpu")
    assert int(back.row_count) == tbl.num_rows


@pytest.mark.cuda
def test_q1_from_a_host_table_takes_k1():
    """Q1 from a host lineitem Table, run with no device named: on the
    card, its sums through the grouped-sum kernel, a host Table back equal
    to the CPU run."""
    from arrow_tpu_torch.io import tpch
    from arrow_tpu_torch.io.tpch_queries import q1_plan
    from arrow_tpu_torch.table import Table
    _need_card()
    li = tpch.lineitem_host_table(0.01)
    before = grouped_sum.launches
    got = q1_plan(li).to_table()
    torch.cuda.synchronize()
    assert grouped_sum.launches == before + 7
    assert isinstance(got, Table)
    want = q1_plan(li).to_table(device="cpu").to_pydict()
    got = got.to_pydict()
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k][0], float):
            torch.testing.assert_close(torch.tensor(got[k]),
                                       torch.tensor(want[k]),
                                       rtol=1e-9, atol=0)
        else:
            assert got[k] == want[k], k


@pytest.mark.cuda
def test_eager_filter_takes_k2():
    """``compute.filter`` over host Arrays runs on the card unasked and
    launches the compaction kernel; the result equals numpy's."""
    import numpy as np

    import arrow_tpu_torch.compute as pc
    from arrow_tpu_torch.array.array import array
    _need_card()
    rng = np.random.default_rng(3)
    v = rng.standard_normal(1_000_003)
    mask = v > 0.3
    before = compact.launches
    got = pc.filter(array(v), array(mask))
    assert compact.launches == before + 1
    assert np.array_equal(got.to_numpy(), v[mask])


# --- the nested device tier (compute/device_nested.py) -------------------------

def _nested_inputs(seed=5, n=50_000):
    """A list<double> with nulls in children and parents, a list<string>
    over the same offsets, and sorted int64 keys with nulls."""
    import numpy as np
    import arrow_tpu_torch.types as T
    from arrow_tpu_torch.array.array import Array, array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.buffer import Buffer
    from arrow_tpu_torch.utils import bits
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 7, n)
    offs = np.zeros(n + 1, np.int32)
    offs[1:] = np.cumsum(lens)
    total = int(offs[-1])
    child_valid = rng.random(total) > 0.1
    vals = rng.normal(size=total)
    dchild = ArrayData(T.float64(), total, [Buffer(bits.pack_bits(
        child_valid)), Buffer(vals)])
    words = np.array(["MAIL", "SHIP", "AIR", "RAIL", ""])
    strs = array([None if not ok else words[i] for ok, i in zip(
        child_valid.tolist(), rng.integers(0, 5, total).tolist())],
        T.string())
    parent_valid = rng.random(n) > 0.3
    pv = Buffer(bits.pack_bits(parent_valid))
    lists = [Array(ArrayData(T.list_(t), n, [pv, Buffer(offs)],
                             children=[c]))
             for t, c in ((T.float64(), dchild), (T.string(), strs.data))]
    keys = np.sort(rng.integers(0, n // 4, 4 * n))
    key_arr = array([None if i % 97 == 0 else int(k)
                     for i, k in enumerate(keys.tolist())], T.int64())
    return lists, key_arr


@pytest.mark.cuda
def test_list_flatten_on_card_one_compaction_matches_cpu():
    """With null parents, list_flatten on the card launches K2 once and
    equals the CPU run (the compaction's plain version) bit for bit; the
    other nested names run on the card and equal the CPU run too."""
    _need_card()
    import arrow_tpu_torch.compute as pc
    lists, _ = _nested_inputs()
    for lst in lists:
        before = compact.launches
        got = pc.list_flatten(lst)
        assert compact.launches == before + 1
        want = pc.list_flatten(lst, device="cpu")
        assert _same_bits(got, want)
        for name, opts in (("list_value_length", {}),
                           ("list_parent_indices", {}),
                           ("list_element", {"index": 0}),
                           ("list_element", {"index": 5})):
            before = compact.launches
            g = pc.call_function(name, [lst], opts)
            assert compact.launches == before
            w = pc.call_function(name, [lst], opts, device="cpu")
            assert _same_bits(g, w), name


def _same_bits(a, b):
    import numpy as np
    if a.type != b.type or len(a) != len(b):
        return False
    am, bm = a.is_valid_mask(), b.is_valid_mask()
    if not np.array_equal(am, bm):
        return False
    if a.type.is_floating or a.type.is_integer:
        return np.array_equal(a.data.values()[am].view(np.uint8),
                              b.data.values()[bm].view(np.uint8))
    return a.to_pylist() == b.to_pylist()


@pytest.mark.cuda
def test_run_end_encode_on_card_one_compaction_matches_cpu():
    """The eager run_end_encode on the card launches K2 once and gives
    the CPU run's run-end encoded Array; run_end_decode inverts it."""
    _need_card()
    import arrow_tpu_torch.compute as pc
    _, keys = _nested_inputs(7)
    before = compact.launches
    got = pc.call_function("run_end_encode", [keys])
    assert compact.launches == before + 1
    want = pc.call_function("run_end_encode", [keys], device="cpu")
    assert got.type == want.type and len(got) == len(want) == len(keys)
    for i in range(2):
        from arrow_tpu_torch.array.array import Array
        assert _same_bits(Array(got.data.children[i]),
                          Array(want.data.children[i]))
    assert _same_bits(pc.run_end_decode(got), keys)
    assert _same_bits(pc.run_end_decode(got.slice(1000, 5000)),
                      keys.slice(1000, 5000))


@pytest.mark.cuda
def test_nested_cuda_calls_never_take_the_host_tier(monkeypatch):
    """A device-representable child on the card: no host gather runs."""
    _need_card()
    import arrow_tpu_torch.compute as pc
    from arrow_tpu_torch.compute import host_kernels

    def refuse(*a, **k):
        raise AssertionError("the host tier ran")
    monkeypatch.setattr(host_kernels, "host_take", refuse)
    lists, keys = _nested_inputs(9, 5_000)
    for lst in lists:
        for name, opts in (("list_flatten", {}), ("list_value_length", {}),
                           ("list_parent_indices", {}),
                           ("list_element", {"index": 1})):
            pc.call_function(name, [lst], opts)
    pc.run_end_decode(pc.call_function("run_end_encode", [keys]))
