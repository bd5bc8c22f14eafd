#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``arrow_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

``python3 chip_smoke.py --compact`` runs phase 1, phase 2's compactions
(but those of SF10 orders) and phase 4's compaction times alone: the quick
comparison of two trees of that kernel in one call.

Phases; any failure exits non-zero without the final line:

1. Probe: versions, the card's name and power limit, the build of every
   kernel in ``arrow_tpu_torch/csrc`` (one ``nvcc`` for ``sm_90a`` per
   source, all in parallel, into ``build/``), and ``self_check()``, which
   launches the probe kernel.
2. Every kernel against its plain PyTorch version on the card: the grouped
   sum in f64 at Q1's shape (SF10's capacity, 12 slots) and at 512 and
   1,024 slots, in f32 at 16 slots, and with Inf and NaN groups, and at 12
   and 1,024 slots run twice and from an unaligned copy, bit for bit the
   same each time (its order of additions is fixed); the compaction at Q3's
   lineitem filter (SF10, four columns, and an int16 and an f16 column of
   2 bytes an element with NaN payloads and -0.0, and one bool column),
   from column bases 1 and 3 elements and a mask 5 and 15 bytes past
   16-byte alignment, under all-true and all-false masks, at Q4's
   lineitem filter (SF10, all 15 columns), at Q4's and
   Q13's orders filters and Q4's semi-join selection (all 9 columns of
   SF10 orders), and at a ragged 1,000,003 rows of bool, int32, int64 and
   f64 with NaN and -0.0 bit patterns (and a bool and an int32 column with
   the mask at each byte offset 1-15 of a 16-byte line), at 2**26 + 5
   rows (4,097 count tiles chained by look-back) run twice for the same
   bits,
   bit for bit with the count; the
   grouped sum at the suite's shapes (26 slots over 131,072 rows, 1,024
   over 1,024, 26 over 524,288 for Q22); the compaction at Q18's HAVING
   filter (a grouped output at lineitem's capacity) and of partsupp's
   columns (Q11's, Q16's and Q20's semi and anti joins); the hash of 1, 2
   and 3 words at 60M rows, of 4 words at 16,777,216 rows (Q5's two-key
   bloom), of 2 at 33,554,432 and 1,048,576 rows (Q7's and Q21's joins
   on a join's output), and of the main path's join keys (the strided
   int32 halves of ``l_orderkey``'s and ``o_custkey``'s equality words at
   SF10's capacities), bit for bit.
3. The main paths, each with every launch count set to 0 just before and
   read just after. Q1: ``self_check()``, ``q1_device_batch(10.0)``,
   ``compile_chain(q1_chain_decls())`` and the download of the result.
   Q3: ``self_check()``, ``q3_device_plan(10.0)`` and ``.to_table()``.
   Q4: ``self_check()``, ``q1_device_batch(10.0)`` as lineitem and
   ``q4_plan(orders, lineitem).to_table()``. Q13: ``self_check()`` and
   ``q13_plan(customer, orders).to_table()``. Every other table comes
   from the port's host generator (``io/tpch.py``) at SF10, made once.
   Each result is held against an independent numpy query over the
   downloaded source columns, each path's launches are exact, and each
   logs the card's peak memory over its run. ``to_table()`` prunes every
   plan with a join to the columns it reads.
   Then (3c) the JAX package's own TPC-H suite, Q6, Q10, Q12, Q5 and Q9
   (its ``tests/test_tpch.py``), with Q14 and Q19: each ``self_check()``
   and ``<plan>(...).to_table()`` over SF10's tables, lineitem being
   ``q1_device_batch(10.0)``, against its numpy oracle with its launches
   exact (``SUITE``).
   Then (3d) the last eleven of the reference's 22 plans, Q2, Q7, Q8,
   Q11, Q15, Q16, Q17, Q18, Q20, Q21 and Q22 (its
   ``tests/test_tpch_full.py``), the same way (``FULL``); Q11 takes
   TPC-H's fraction 0.0001 / SF and Q20 the nation of the first supplier
   it keeps.
   Then (3e) the plan nodes beyond those plans, the same way
   (``NODE_PATHS``): Q21 spelled as TPC-H spells it (residual semi and
   anti joins), Q1 over a ``union`` of lineitem's two halves, a
   ``sorted_merge`` of orders' two sorted halves, an ``asofjoin`` of
   orders onto the finished orders by customer within 90 days, Q1 as a
   segmented aggregate, the 100 largest orders by ``select_k_sink``, and
   Q15 with its revenue view spelled as two declarations, each run; then
   Q15's general-path float sum (60M rows) twice, bit for bit.
   Then (3f) the typed plans (``TYPED_PATHS``) over lineitem and part
   retyped on the card by the port's ``cast``, ``multiply`` and ``round``
   (``typed_tables``: uint32 keys, int8 line numbers, int16 quantities,
   decimal128(12, 2) prices, an f32 tax, a timestamp[s] ship date, a
   date64 commit date, 1% null suppliers): typed Q1, lineitem joined to
   part on uint32 keys with revenue by brand, and a top-k over all of
   lineitem on (date64 descending, uint32 with nulls, int64), each
   against its numpy oracle over the typed values, integers and decimals
   exact, with its launches exact.
   Then (3b) all eight join types, each run against a numpy oracle of
   the join (row count, row order, values and validity exact) with its
   launches exact: orders probing customer filtered to one segment at
   SF10, where the bloom engages for inner, left semi, right semi and
   right outer joins, and 1,000,000 probe rows against 200,000 build
   rows with duplicate keys on both sides and 5% null keys.
4. Times after a warm-up: Q1, Q3, Q4, Q13, the suite's and the last
   eleven plans' rows/s of their largest input and phase 3e's and 3f's
   walls (best of 5), a profile of one run of each (device busy time and
   idle share), each kernel's time beside its bound, its plain version's
   and one library call's where there is one (the compaction at five
   shapes: Q3's filter, its mask over 2-byte columns and over one bool
   column, Q4's filter over all 15 columns and Q18's sparse HAVING filter,
   each with its device time split by kernel name), by CUDA events around
   back-to-back calls and as
   device time from the profiler, and the general path's float sum beside
   ``index_add_``.

The line before the last is one JSON object with a record per kernel, its
launches by path; the last is ``{"ok": true, "device": {...}}``. The
script imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak bandwidth
F64_OPS_PER_S = 34e12       # H100 SXM FP64 outside the tensor cores
F32_OPS_PER_S = 67e12       # H100 SXM FP32 outside the tensor cores
# H100 SXM int32: 64 lanes an SM (CUDA programming guide, compute
# capability 9.0) x 132 SMs x 1.98 GHz boost
INT32_OPS_PER_S = 64 * 132 * 1.98e9
HASH_OPS_PER_WORD = 11      # xxhash32 of a word: 3 multiplies, 8 shift/xor
HASH_OPS_PER_COMBINE = 6    # 2 shifts, 3 adds, 1 xor
SF = 10.0
Q1_SLOTS = 12               # (3+1) return flags x (2+1) line statuses
RTOL_F64 = 1e-9             # f64 sums added in another order
RTOL_F32 = 1e-5             # an f32 result against an f64 reference
Q1_LAUNCHES = {"compact": 0, "hash32": 0, "grouped_sum": 7, "probe": 1}
Q3_LAUNCHES = {"compact": 7, "hash32": 4, "grouped_sum": 0, "probe": 1}
Q4_LAUNCHES = {"compact": 3, "hash32": 0, "grouped_sum": 0, "probe": 1}
Q13_LAUNCHES = {"compact": 1, "hash32": 0, "grouped_sum": 0, "probe": 1}
JOIN_TYPES = ("inner", "left outer", "right outer", "full outer",
              "left semi", "left anti", "right semi", "right anti")
# (compact, hash32) launches of one join of each type. SF10: orders probe
# customer filtered by segment (a compaction); the bloom (2 hashes, 1
# compaction) engages for inner, left semi, right semi and right outer;
# inner takes the unique-build compaction, left outer the identity; right
# and full outer append their unmatched build rows, left semi and anti
# compact the probe side, right semi and anti the build side.
JOIN_LAUNCHES_SF10 = {"inner": (3, 2), "left outer": (1, 0),
                      "right outer": (3, 2), "full outer": (2, 0),
                      "left semi": (3, 2), "left anti": (2, 0),
                      "right semi": (3, 2), "right anti": (2, 0)}
# the null-key tables: no pre-filter, and duplicate build keys take the
# general expansion (no unique-build path)
JOIN_LAUNCHES_NULLS = {"inner": (1, 2), "left outer": (0, 0),
                       "right outer": (2, 2), "full outer": (1, 0),
                       "left semi": (2, 2), "left anti": (1, 0),
                       "right semi": (2, 2), "right anti": (1, 0)}
NULL_KEY_ROWS = (1_000_000, 200_000)  # probe and build rows, 5% null keys


def log(*parts):
    print(*parts, flush=True)


def timed(phase, *args):
    """``phase(*args)``, logging its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"-- {phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernels():
    from arrow_tpu_torch.kernels.compact import compact
    from arrow_tpu_torch.kernels.grouped_sum import grouped_sum
    from arrow_tpu_torch.kernels.hash32 import hash32
    from arrow_tpu_torch.kernels.probe import probe
    return {"compact": compact, "hash32": hash32,
            "grouped_sum": grouped_sum, "probe": probe}


def zero_launches():
    for k in kernels().values():
        k.launches = 0


def read_launches():
    return {name: k.launches for name, k in kernels().items()}


def check_close(name, got, want, rtol):
    """Equal NaN/Inf pattern, finite values within rtol; returns the
    largest absolute error over the finite values."""
    got, want = got.double().cpu(), want.double().cpu()
    nan_ok = torch.equal(torch.isnan(got), torch.isnan(want))
    inf_ok = torch.equal(torch.isinf(got), torch.isinf(want)) and \
        torch.equal(got[torch.isinf(got)], want[torch.isinf(want)])
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    ok = bool((err <= rtol * want[fin].abs()).all())
    max_err = float(err.max()) if err.numel() else 0.0
    log(f"  {name}: max_abs_err={max_err!r} rtol={rtol} "
        f"{'ok' if ok and nan_ok and inf_ok else 'MISMATCH'}")
    if not (ok and nan_ok and inf_ok):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version\n kernel {got}\n plain  {want}")
    return max_err


def _bits(t):
    """An integer view of a tensor's bits, so equality is bit for bit."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def check_bit_exact(name, got, want, what="its plain version"):
    """Each tensor of ``got`` equals its twin in ``want`` bit for bit;
    returns 0.0, the largest absolute error."""
    ok = len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape
        and torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))
    log(f"  {name}: {'bit-exact' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: disagrees with {what}")
    return 0.0


def q1_like_inputs(n, num_segments, live_slots, dtype, seed):
    """Values and group ids at a grouped sum's shape on the main path:
    ``live_slots`` slots carry rows, about 4% of rows are dead (value 0,
    id 0)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gids = torch.randint(0, live_slots, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    values = torch.rand(n, generator=gen, device="cuda",
                        dtype=torch.float64) * 1e5
    dead = torch.rand(n, generator=gen, device="cuda") < 0.04
    values = torch.where(dead, 0.0, values).to(dtype)
    gids = torch.where(dead, 0, gids)
    assert live_slots <= num_segments
    return values, gids


def q3_sources(plan):
    """The Q3 plan's table-source batches: lineitem, orders, customer."""
    def walk(decl):
        if decl.factory_name == "table_source":
            return [decl.options.batch]
        return [b for d in decl.inputs for b in walk(d)]
    lineitem, orders, customer = walk(plan)
    return lineitem, orders, customer


def q3_filter_inputs(lineitem):
    """Q3's lineitem filter: its keep mask and the four columns it moves."""
    from arrow_tpu_torch.io.tpch_queries import DATE_1995_03_15
    keep = (lineitem.column("l_shipdate").values > DATE_1995_03_15) \
        & lineitem.row_mask()
    return keep, [c.values for c in lineitem.columns]


def width2_inputs(lineitem):
    """Q3's lineitem filter mask over two 2-byte columns: the ship date as
    int16 days and the discount as f16, with NaN payloads, -0.0 and
    infinities among its bit patterns."""
    keep, _ = q3_filter_inputs(lineitem)
    days = lineitem.column("l_shipdate").values.to(torch.int16)
    half = lineitem.column("l_discount").values.to(torch.float16)
    bits = half.view(torch.int16)
    # a NaN with a payload, a negative NaN (0xFE00), -0.0 and +inf
    for start, pattern in ((1, 0x7E01), (2, 0xFE00 - 0x10000),
                           (3, -0x8000), (4, 0x7C00)):
        bits[start::997] = pattern
    return keep, [days, half]


def bool_column_inputs(lineitem):
    """Q3's lineitem filter mask over one bool column alone, as a validity
    buffer moves: 1% of its rows false (seeded)."""
    keep, _ = q3_filter_inputs(lineitem)
    gen = torch.Generator(device="cuda").manual_seed(11)
    valid = torch.rand(keep.numel(), generator=gen, device="cuda") >= 0.01
    return keep, [valid]


def q4_lineitem_keep(lineitem):
    """Q4's lineitem filter: commit date before receipt date."""
    return (lineitem.column("l_commitdate").values
            < lineitem.column("l_receiptdate").values) & lineitem.row_mask()


def offset_copy(t, k):
    """A copy of ``t`` that starts ``k`` elements into a larger tensor, so
    that its base lies ``k * element_size`` bytes past the allocation's
    alignment."""
    out = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:]
    out.copy_(t)
    return out


def q18_having_inputs(n):
    """Q18's HAVING filter: a grouped sum's output at lineitem's capacity
    (order keys, sums and their validity, a quarter of the slots live),
    about one group in 10^4 kept."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    keys = torch.arange(n, dtype=torch.int64, device="cuda")
    sums = torch.rand(n, generator=gen, device="cuda",
                      dtype=torch.float64) * 300.0
    live = torch.rand(n, generator=gen, device="cuda") < 0.25
    return (sums > 299.97) & live, [keys, sums, live]


def q13_special(orders):
    """Per ``o_comment`` dictionary slot: the comment is like
    '%special%requests%'."""
    import re
    return np.array([re.search("special.*requests", c, re.S) is not None
                     for c in orders.column("o_comment").dictionary])


def q4_q13_filter_inputs(lineitem, orders):
    """(name, keep mask, columns) of each compaction on Q4's and Q13's
    paths, at the shapes the plans give it: Q4's lineitem filter moves all
    of lineitem's columns, Q4's and Q13's orders filters and Q4's semi
    join selection (of the filtered orders) all of orders' columns."""
    from arrow_tpu_torch.io.tpch_queries import DATE_1993_07_01
    li_keep = q4_lineitem_keep(lineitem)
    date = orders.column("o_orderdate").values
    q4_keep = (date >= DATE_1993_07_01) & (date < DATE_1993_07_01 + 92) \
        & orders.row_mask()
    special = torch.from_numpy(q13_special(orders)).to(date.device)
    q13_keep = ~special[orders.column("o_comment").values.long()] \
        & orders.row_mask()
    li_cols = [c.values for c in lineitem.columns]
    o_cols = [c.values for c in orders.columns]
    return [("Q4 lineitem filter", li_keep, li_cols),
            ("Q4 orders filter", q4_keep, o_cols),
            ("Q13 orders filter", q13_keep, o_cols)], li_keep


def hash_words(n, k, seed):
    """k planes of n random uint32 words (int32 bits), starting with 0,
    0x80000000 and 0xFFFFFFFF."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    words = [torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                           device="cuda", dtype=torch.int32)
             for _ in range(k)]
    for w in words:
        w[:3] = torch.tensor([0, -2**31, -1], dtype=torch.int32)
    return words


def phase_probe():
    from arrow_tpu_torch.kernels import _build
    from arrow_tpu_torch.kernels.probe import probe
    from arrow_tpu_torch.platform_check import (card_name_and_power_limit,
                                                self_check)
    log("== phase 1: probe")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, nvcc {_build.nvcc_version()}")
    card = card_name_and_power_limit()
    log(f"kernel build: {_build.build_all():.2f} s for "
        f"{[s.name for s in _build.sources()]}")
    for name, out in _build.BUILD_LOG.items():
        for line in out.strip().splitlines():
            if any(k in line for k in ("registers", "smem", "stack", "error")):
                log(f"  ptxas {name}: {line.strip()}")
    before = probe.launches
    info = self_check()
    if info.get("probe") != "ok" or probe.launches != before + 1:
        raise AssertionError(f"self_check did not launch the probe: {info}")
    log(f"self_check: {json.dumps(info)}")
    return card


def phase_kernels(n, orders):
    from arrow_tpu_torch.compute.hashing import int64_halves
    from arrow_tpu_torch.compute.keys import equality_word
    from arrow_tpu_torch.io.tpch_device import q3_device_plan
    from arrow_tpu_torch.kernels.grouped_sum import (grouped_sum,
                                                     grouped_sum_plain)
    from arrow_tpu_torch.kernels.hash32 import hash32, hash32_plain
    from arrow_tpu_torch.kernels.probe import probe, probe_plain
    log("== phase 2: kernels against their plain versions")
    errs = {}
    v, g = q1_like_inputs(n, Q1_SLOTS, 6, torch.float64, 1)
    errs["grouped_sum"] = check_close(
        f"grouped_sum f64 n={n} S={Q1_SLOTS}", grouped_sum(v, g, Q1_SLOTS),
        grouped_sum_plain(v, g, Q1_SLOTS), RTOL_F64)
    v, g = q1_like_inputs(n, 512, 512, torch.float64, 2)
    errs["grouped_sum_s512"] = check_close(
        f"grouped_sum f64 n={n} S=512", grouped_sum(v, g, 512),
        grouped_sum_plain(v, g, 512), RTOL_F64)
    del v, g
    v, g = q1_like_inputs(1 << 22, 16, 16, torch.float32, 3)
    errs["grouped_sum_f32"] = check_close(
        "grouped_sum f32 n=4194304 S=16", grouped_sum(v, g, 16),
        grouped_sum_plain(v.double(), g, 16), RTOL_F32)
    # F1: one input gives the same bits on every run, and from a copy
    # that is not 16-byte aligned (the kernel's row-by-row loads)
    for s, live in ((Q1_SLOTS, 6), (1024, 1024)):
        v, g = q1_like_inputs(n, s, live, torch.float64, 8)
        first = grouped_sum(v, g, s)
        if s == 1024:
            check_close(f"grouped_sum f64 n={n} S={s}", first,
                        grouped_sum_plain(v, g, s), RTOL_F64)
        v_odd = torch.empty(n + 1, dtype=v.dtype, device="cuda")[1:]
        g_odd = torch.empty(n + 1, dtype=g.dtype, device="cuda")[1:]
        v_odd.copy_(v)
        g_odd.copy_(g)
        check_bit_exact(f"grouped_sum f64 n={n} S={s}: a second run, and "
                        "an unaligned copy", [grouped_sum(v, g, s),
                                              grouped_sum(v_odd, g_odd, s)],
                        [first, first], "the first run")
        del v, g, first, v_odd, g_odd
    for s in (Q1_SLOTS, 512):
        v, g = q1_like_inputs(1 << 20, s, s, torch.float64, 4)
        v[1000], g[1000] = float("inf"), 3
        v[2000], g[2000] = float("nan"), 7
        got = grouped_sum(v, g, s)
        if not (torch.isinf(got[3]) and torch.isnan(got[7])):
            raise AssertionError(f"Inf/NaN did not propagate: {got[:8]}")
        check_close(f"grouped_sum f64 Inf/NaN S={s}", got,
                    grouped_sum_plain(v, g, s), RTOL_F64)
    # the suite's grouped sums: Q5's revenue by n_name (26 slots) over its
    # last join's capacity, Q9's profit over its 1,024-row join output,
    # Q22's balance by country code (26 slots, 7 live) over its anti
    # join's capacity
    for rows, s, live in ((131_072, 26, 25), (1024, 1024, 175),
                          (524_288, 26, 7)):
        v, g = q1_like_inputs(rows, s, live, torch.float64, 5)
        check_close(f"grouped_sum f64 n={rows} S={s}", grouped_sum(v, g, s),
                    grouped_sum_plain(v, g, s), RTOL_F64)
    x = torch.randn(8, 128, device="cuda")
    errs["probe"] = check_close("probe (8,128) f32", probe(x),
                                probe_plain(x), 0.0)

    q3_lineitem, q3_orders, _ = q3_sources(q3_device_plan(SF)[0])
    errs["compact"] = phase_compact(n, q3_lineitem, orders)
    # the join keys as the bloom hashes them: two strided int32 views of
    # each int64 equality word
    for batch, key in ((q3_lineitem, "l_orderkey"), (q3_orders, "o_custkey")):
        words = int64_halves(equality_word(batch.column(key)))
        err = check_bit_exact(
            f"hash32 {key} halves n={words[0].numel()} "
            f"stride {words[0].stride(0)}", [hash32(words)],
            [hash32_plain(words)])
        if key == "l_orderkey":
            errs["hash32"] = err
        del words
    del q3_lineitem, q3_orders

    h = 60_000_000
    for k in (1, 2, 3):
        words = hash_words(h, k, 10 + k)
        check_bit_exact(f"hash32 k={k} n={h}", [hash32(words)],
                        [hash32_plain(words)])
        del words
    # Q5's two-key bloom (l_suppkey, c_nationkey): four word planes over
    # its probe side's capacity; Q7's and Q21's single int64 keys over
    # their joins' 33,554,432- and 1,048,576-row probe sides
    for rows, k in ((1 << 24, 4), (1 << 25, 2), (1 << 20, 2)):
        words = hash_words(rows, k, 14 + k)
        check_bit_exact(f"hash32 k={k} n={rows}", [hash32(words)],
                        [hash32_plain(words)])
        del words
    torch.cuda.synchronize()
    return errs


def compact_case(name, keep, cols):
    """``compact`` against ``compact_plain`` on one input: the count on the
    card and every output bit for bit."""
    from arrow_tpu_torch.kernels.compact import compact, compact_plain
    outs, count = compact(keep, cols)
    want, want_count = compact_plain(keep, cols)
    if count.device.type != "cuda" or count.dtype != torch.int32 \
            or int(count) != int(want_count):
        raise AssertionError(f"{name}: count {count} != {want_count}")
    check_bit_exact(f"{name}, count {int(count)}", outs, want)
    return outs, count


def phase_compact(n, q3_lineitem, orders):
    """The compaction against its plain version at every shape the main
    paths give it, at the edges of its tiles, from bases off the 16-byte
    alignment of its vector loads and stores, and run again for the same
    bits (its tiles chain their offsets through a look-back). Without
    ``orders`` (``--compact``) the orders' shapes are left out. Returns the
    largest absolute error, 0.0."""
    from arrow_tpu_torch.io.tpch_device import q1_device_batch
    from arrow_tpu_torch.kernels.compact import compact
    keep, cols = q3_filter_inputs(q3_lineitem)
    m = keep.numel()
    compact_case(f"compact Q3 lineitem filter n={m} x4", keep, cols)
    for k in (1, 3):
        # every column k elements (k, 2k, 4k, 8k bytes) and the mask 5k
        # bytes past 16-byte alignment
        compact_case(f"compact Q3 lineitem filter n={m} x4, bases {k} "
                     f"elements and the mask {5 * k} bytes off alignment",
                     offset_copy(keep, 5 * k),
                     [offset_copy(c, k) for c in cols])
    keep2, cols2 = width2_inputs(q3_lineitem)
    compact_case(f"compact Q3 lineitem filter n={m}, int16 and f16 "
                 "(2 bytes an element)", keep2, cols2)
    del keep2, cols2
    keep1, cols1 = bool_column_inputs(q3_lineitem)
    compact_case(f"compact Q3 lineitem filter n={m}, one bool column",
                 keep1, cols1)
    del keep1, cols1
    compact_case(f"compact all kept n={m} x4",
                 torch.ones_like(keep), cols)
    compact_case(f"compact none kept n={m} x4",
                 torch.zeros_like(keep), cols)
    del keep, cols
    # Q4's and Q13's compactions, each over every column of its batch
    lineitem, _ = q1_device_batch(SF)
    if orders is None:
        li_keep = q4_lineitem_keep(lineitem)
        cases = [("Q4 lineitem filter", li_keep,
                  [c.values for c in lineitem.columns])]
    else:
        cases, li_keep = q4_q13_filter_inputs(lineitem, orders)
    for name, keep, cols in cases:
        outs, count = compact_case(
            f"compact {name} n={keep.numel()} x{len(cols)}", keep, cols)
        if name == "Q4 orders filter":
            # the semi join keeps the filtered orders with a late lineitem
            semi_keep = torch.isin(
                outs[0], lineitem.column("l_orderkey").values[li_keep]) \
                & (torch.arange(keep.numel(), device="cuda") < count)
            compact_case(f"compact Q4 semi join selection n={keep.numel()} "
                         f"x{len(outs)}", semi_keep, outs)
            del semi_keep
        del outs
    del lineitem, cases, li_keep, keep, cols
    gen = torch.Generator(device="cuda").manual_seed(7)
    r = 1_000_003
    f64 = torch.randn(r, generator=gen, device="cuda", dtype=torch.float64)
    f64[::5] = float("nan")
    f64[1::5] = -0.0
    f64.view(torch.int64)[2::5] = -0x0007_0000_0000_1234  # NaN, payload
    ragged = [torch.rand(r, generator=gen, device="cuda") < 0.5,
              torch.randint(-2**31, 2**31 - 1, (r,), generator=gen,
                            device="cuda", dtype=torch.int32),
              torch.randint(-2**62, 2**62, (r,), generator=gen,
                            device="cuda", dtype=torch.int64), f64]
    keep = torch.rand(r, generator=gen, device="cuda") < 0.5
    compact_case(f"compact ragged n={r} bool/int32/int64/f64", keep, ragged)
    # a 1-byte column and the mask at every byte offset of a 16-byte line
    for k in range(1, 16):
        compact_case(f"compact ragged n={r} bool, base and mask {k} bytes "
                     "off alignment", offset_copy(keep, k),
                     [offset_copy(ragged[0], k), offset_copy(ragged[1], k)])
    del ragged, f64, keep
    compact_case(f"compact Q18 HAVING filter n={n} int64/f64/bool",
                 *q18_having_inputs(n))
    # partsupp's four columns at its SF10 capacity, as Q11's, Q16's and
    # Q20's semi and anti joins compact them
    m = 8_000_512
    ps = [torch.randint(1, 2_000_000, (m,), generator=gen, device="cuda"),
          torch.randint(1, 100_000, (m,), generator=gen, device="cuda"),
          torch.rand(m, generator=gen, device="cuda", dtype=torch.float64),
          torch.randint(1, 10_000, (m,), generator=gen, device="cuda")]
    compact_case(f"compact partsupp semi join n={m} x4",
                 torch.rand(m, generator=gen, device="cuda") < 0.04, ps)
    del ps
    # 2**26 rows: 4,097 count tiles chain their offsets; the same input
    # again must give the same bits and count
    big = (1 << 26) + 5
    keep = torch.rand(big, generator=gen, device="cuda") < 0.5
    cols = [keep.clone(),
            torch.randint(-2**15, 2**15, (big,), generator=gen,
                          device="cuda", dtype=torch.int16),
            torch.randint(-2**31, 2**31 - 1, (big,), generator=gen,
                          device="cuda", dtype=torch.int32),
            torch.randint(-2**62, 2**62, (big,), generator=gen,
                          device="cuda", dtype=torch.int64)]
    outs, count = compact_case(f"compact n={big} widths 1/2/4/8", keep, cols)
    again, again_count = compact(keep, cols)
    if int(again_count) != int(count):
        raise AssertionError(f"compact n={big}: count {int(again_count)} "
                             f"on a second run, {int(count)} on the first")
    check_bit_exact(f"compact n={big}: a second run", again, outs,
                    "the first run")
    del keep, cols, outs, again
    torch.cuda.synchronize()
    return 0.0


def q1_oracle(batch, n):
    """Q1 with numpy bincounts over the downloaded source columns, in the
    plan's output order."""
    from arrow_tpu_torch.io.tpch_queries import DATE_1998_09_02

    def col(name):
        return batch.column(name).values[:n].cpu().numpy()

    rf_dict = batch.column("l_returnflag").dictionary
    ls_dict = batch.column("l_linestatus").dictionary
    keep = col("l_shipdate") <= DATE_1998_09_02
    key = (col("l_returnflag").astype(np.int64) * len(ls_dict)
           + col("l_linestatus"))[keep]
    size = len(rf_dict) * len(ls_dict)
    qty, price = col("l_quantity")[keep], col("l_extendedprice")[keep]
    disc, tax = col("l_discount")[keep], col("l_tax")[keep]
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    count = np.bincount(key, minlength=size)

    def s(w):
        return np.bincount(key, weights=w, minlength=size)

    groups = sorted((rf_dict[k // len(ls_dict)], ls_dict[k % len(ls_dict)],
                     k) for k in np.nonzero(count)[0])
    ks = np.array([k for _, _, k in groups])
    c = count[ks]
    return {
        "l_returnflag": [g[0] for g in groups],
        "l_linestatus": [g[1] for g in groups],
        "sum_qty": s(qty)[ks], "sum_base_price": s(price)[ks],
        "sum_disc_price": s(disc_price)[ks], "sum_charge": s(charge)[ks],
        "avg_qty": s(qty)[ks] / c, "avg_price": s(price)[ks] / c,
        "avg_disc": s(disc)[ks] / c, "count_order": c.tolist(),
    }


def q3_oracle(plan, limit=10):
    """Q3 in numpy over the downloaded source columns. o_orderkey and
    c_custkey are 1..n, so both joins are index lookups."""
    import datetime

    from arrow_tpu_torch.io.tpch_queries import DATE_1995_03_15
    lineitem, orders, customer = q3_sources(plan)

    def cols(batch):
        n = int(batch.row_count)
        return {f.name: c.values[:n].cpu().numpy()
                for f, c in zip(batch.schema.fields, batch.columns)}

    li, od, cu = cols(lineitem), cols(orders), cols(customer)
    seg = customer.column("c_mktsegment").dictionary
    assert np.array_equal(cu["c_custkey"], np.arange(1, len(cu["c_custkey"])
                                                     + 1))
    assert np.array_equal(od["o_orderkey"], np.arange(1, len(od["o_orderkey"])
                                                      + 1))
    building = cu["c_mktsegment"] == seg.index("BUILDING")
    order_ok = (od["o_orderdate"] < DATE_1995_03_15) \
        & building[od["o_custkey"] - 1]
    line_ok = (li["l_shipdate"] > DATE_1995_03_15) \
        & order_ok[li["l_orderkey"] - 1]
    okey = li["l_orderkey"][line_ok]
    volume = (li["l_extendedprice"] * (1.0 - li["l_discount"]))[line_ok]
    revenue = np.bincount(okey, weights=volume,
                          minlength=len(od["o_orderkey"]) + 1)
    groups = np.unique(okey)
    rev, date = revenue[groups], od["o_orderdate"][groups - 1]
    top = groups[np.lexsort((date, -rev))[:limit]]
    epoch = datetime.date(1970, 1, 1)
    return {
        "l_orderkey": top.tolist(),
        "o_orderdate": [epoch + datetime.timedelta(days=int(d))
                        for d in od["o_orderdate"][top - 1]],
        "o_shippriority": od["o_shippriority"][top - 1].tolist(),
        "revenue": revenue[top],
    }, len(groups), int(line_ok.sum())


class JoinSide(NamedTuple):
    """One input of a join as the numpy oracle sees it: key values and
    validity by row, and a column that names each row."""
    keys: np.ndarray
    valid: np.ndarray
    id_name: str
    ids: np.ndarray


class MatchRuns(NamedTuple):
    """Each probe row's run of matching build rows, in numpy."""
    order: np.ndarray      # live build rows by key, then by row
    lo: np.ndarray         # per probe row: its first match in ``order``
    counts: np.ndarray     # per probe row: its matches (0 on a null key)
    b_matched: np.ndarray  # per build row: some probe row matched it


def match_runs(probe: JoinSide, build: JoinSide) -> MatchRuns:
    """The runs by a counting sort of the build keys, which must be
    non-negative integers. Null keys never match."""
    b_live = np.flatnonzero(build.valid)
    bk = build.keys[b_live]
    pk = np.where(probe.valid, probe.keys, 0)
    if (bk < 0).any() or (pk < 0).any():
        raise ValueError("the join oracle takes non-negative keys")
    per_key = np.bincount(bk, minlength=int(pk.max(initial=0)) + 1)
    lo = (np.cumsum(per_key) - per_key)[pk]
    counts = np.where(probe.valid, per_key[pk], 0)
    order = b_live[np.argsort(bk, kind="stable")]
    b_matched = np.zeros(len(build.keys), dtype=bool)
    b_matched[order[np.repeat(lo, counts) + _ranks_within(counts)]] = True
    return MatchRuns(order, lo, counts, b_matched)


def join_oracle(jt, runs: MatchRuns):
    """(probe row, build row) of every output row of a single-key hash
    join, in the engine's order, -1 for a null side: probe rows in order,
    each one's matches in build-row order (an unmatched probe row of a
    left or full outer join in place), then the unmatched build rows of a
    right or full outer join."""
    counts = runs.counts
    if jt in ("left semi", "left anti"):
        rows = np.flatnonzero((counts > 0) == (jt == "left semi"))
        return rows, np.full(len(rows), -1)
    if jt in ("right semi", "right anti"):
        rows = np.flatnonzero(runs.b_matched == (jt == "right semi"))
        return np.full(len(rows), -1), rows
    out_counts = counts if jt in ("inner", "right outer") \
        else np.maximum(counts, 1)
    p_idx = np.repeat(np.arange(len(counts)), out_counts)
    pos = np.repeat(runs.lo, out_counts) + _ranks_within(out_counts)
    # an unmatched probe row reads the -1 appended after the build rows
    b_idx = np.append(runs.order, -1)[
        np.where(np.repeat(counts > 0, out_counts), pos, len(runs.order))]
    if jt in ("right outer", "full outer"):
        extra = np.flatnonzero(~runs.b_matched)
        p_idx = np.concatenate([p_idx, np.full(len(extra), -1)])
        b_idx = np.concatenate([b_idx, extra])
    return p_idx, b_idx


def asof_oracle(lkey, lon, rkey, ron, tolerance):
    """Per left row, the right row an as-of join picks, -1 for none: the
    same key, the latest ``on`` at most the left row's and at least the
    left row's plus ``tolerance`` (at most 0), and of equal (key, on) the
    last in the right input. Keys are non-negative integers. One stable
    sort of the right rows by (key, on) and one search."""
    if tolerance > 0:
        raise ValueError("the as-of oracle looks back only")
    base = min(lon.min(), ron.min())
    span = int(max(lon.max(), ron.max()) - base) + 1
    rpack = rkey.astype(np.int64) * span + (ron - base)
    order = np.argsort(rpack, kind="stable")
    lpack = lkey.astype(np.int64) * span + (lon - base)
    pos = np.searchsorted(rpack[order], lpack, side="right") - 1
    cand = order[np.maximum(pos, 0)]
    ok = (pos >= 0) & (rkey[cand] == lkey) & (ron[cand] >= lon + tolerance)
    return np.where(ok, cand, -1)


def _ranks_within(counts):
    """0, 1, .., c-1 for each count c, concatenated."""
    ends = np.cumsum(counts)
    return np.arange(ends[-1] if len(ends) else 0) - np.repeat(ends - counts,
                                                               counts)


def check_join(jt, batch, probe: JoinSide, build: JoinSide,
               runs: MatchRuns) -> int:
    """A join's result batch (one id column a side, right semi and anti
    joins the whole build side) against ``join_oracle``: row count, row
    order, values and validity exact. Returns the row count."""
    p_idx, b_idx = join_oracle(jt, runs)
    n = int(batch.row_count)
    if n != len(p_idx):
        raise AssertionError(f"{jt}: {n} rows, the oracle {len(p_idx)}")
    sides = [(probe, p_idx), (build, b_idx)]
    if jt in ("left semi", "left anti"):
        sides = sides[:1]
    elif jt in ("right semi", "right anti"):
        sides = sides[1:]
    for side, idx in sides:
        c = batch.column(side.id_name)
        vals = c.values[:n].cpu().numpy()
        valid = (np.ones(n, dtype=bool) if c.validity is None
                 else c.validity[:n].cpu().numpy())
        want_valid = idx >= 0
        if not np.array_equal(valid, want_valid) or not np.array_equal(
                vals[want_valid], side.ids[idx[want_valid]]):
            raise AssertionError(f"{jt}: column {side.id_name} differs "
                                 "from the oracle")
    return n


def _host_columns(batch, names):
    n = int(batch.row_count)
    return {k: batch.column(k).values[:n].cpu().numpy() for k in names}


def q4_oracle(orders, lineitem):
    """Q4 in numpy over the downloaded source columns: the orders of the
    quarter from 1993-07-01 with a lineitem received after its commit date,
    counted by priority. o_orderkey is 1..n, so the semi join is an index
    lookup."""
    from arrow_tpu_torch.io.tpch_queries import DATE_1993_07_01
    od = _host_columns(orders, ["o_orderkey", "o_orderdate",
                                "o_orderpriority"])
    li = _host_columns(lineitem, ["l_orderkey", "l_commitdate",
                                  "l_receiptdate"])
    assert np.array_equal(od["o_orderkey"],
                          np.arange(1, len(od["o_orderkey"]) + 1))
    has_late = np.zeros(len(od["o_orderkey"]) + 1, dtype=bool)
    has_late[li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]] \
        = True
    date = od["o_orderdate"]
    sel = (date >= DATE_1993_07_01) & (date < DATE_1993_07_01 + 92) \
        & has_late[od["o_orderkey"]]
    prio = orders.column("o_orderpriority").dictionary
    counts = np.bincount(od["o_orderpriority"][sel], minlength=len(prio))
    groups = sorted((prio[i], int(c)) for i, c in enumerate(counts) if c)
    return {"o_orderpriority": [g[0] for g in groups],
            "order_count": [g[1] for g in groups]}, int(sel.sum())


def q13_oracle(customer, orders):
    """Q13 in numpy: per customer the orders whose comment has no
    'special' followed by 'requests', then customers per order count,
    by count of customers then order count, both descending."""
    special = q13_special(orders)
    od = _host_columns(orders, ["o_custkey", "o_comment"])
    cu = _host_columns(customer, ["c_custkey"])
    kept = ~special[od["o_comment"]]
    per_customer = np.bincount(od["o_custkey"][kept],
                               minlength=int(cu["c_custkey"].max()) + 1)
    c_count = per_customer[cu["c_custkey"]]
    custdist = np.bincount(c_count)
    groups = np.flatnonzero(custdist)
    order = np.lexsort((-groups, -custdist[groups]))
    return {"c_count": groups[order].tolist(),
            "custdist": custdist[groups][order].tolist()}, int(kept.sum())


def _codes(batch, name, values):
    """The codes of ``values`` in a dictionary column's dictionary."""
    d = batch.column(name).dictionary
    return [d.index(v) for v in values]


def _check_keys(cols, name):
    """The oracles join a key 1..n by indexing: check it is 1..n."""
    assert np.array_equal(cols[name], np.arange(1, len(cols[name]) + 1)), name


def _oracle_columns(t, spec):
    """The downloaded source columns of ``spec`` (table -> column names)
    by table, with lineitem's volume; the keys the oracles join by
    indexing are checked to be 1..n."""
    cols = {name: _host_columns(t[name], keys) for name, keys in spec.items()}
    li = cols["lineitem"]
    li["volume"] = li["l_extendedprice"] * (1.0 - li["l_discount"])
    for name, key in (("orders", "o_orderkey"), ("customer", "c_custkey"),
                      ("part", "p_partkey"), ("supplier", "s_suppkey")):
        _check_keys(cols[name], key)
    assert np.array_equal(cols["nation"]["n_nationkey"], np.arange(25))
    return cols


def _suite_columns(t):
    """The downloaded source columns the suite's oracles read, by table."""
    return _oracle_columns(t, {
        "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                     "l_extendedprice", "l_discount", "l_returnflag",
                     "l_shipdate", "l_receiptdate", "l_shipinstruct",
                     "l_shipmode"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                   "o_orderpriority"],
        "customer": ["c_custkey", "c_nationkey", "c_mktsegment"],
        "part": ["p_partkey", "p_type", "p_brand", "p_container", "p_size"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"],
        "nation": ["n_nationkey", "n_name", "n_regionkey"],
        "region": ["r_regionkey", "r_name"]})


def q6_oracle(t, c):
    """Revenue of the 1994 lineitems with a discount of 5-7% and fewer
    than 24 units."""
    from arrow_tpu_torch.io.tpch_queries import (DATE_1994_01_01,
                                                 DATE_1995_01_01)
    li = c["lineitem"]
    sel = ((li["l_shipdate"] >= DATE_1994_01_01)
           & (li["l_shipdate"] < DATE_1995_01_01)
           & (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07)
           & (li["l_quantity"] < 24.0))
    revenue = np.sum(li["l_extendedprice"][sel] * li["l_discount"][sel])
    return {"revenue": np.array([revenue])}, int(sel.sum())


def q10_oracle(t, c, limit=20):
    """Revenue of returned lineitems per customer over the orders of the
    quarter from 1994-01-01, the top ``limit`` by revenue, then key."""
    from arrow_tpu_torch.io.tpch_queries import DATE_1994_01_01
    li, od, cu = c["lineitem"], c["orders"], c["customer"]
    date = od["o_orderdate"]
    order_ok = (date >= DATE_1994_01_01) & (date < DATE_1994_01_01 + 92)
    (r,) = _codes(t["lineitem"], "l_returnflag", ["R"])
    sel = (li["l_returnflag"] == r) & order_ok[li["l_orderkey"] - 1]
    cust = od["o_custkey"][li["l_orderkey"][sel] - 1]
    revenue = np.bincount(cust, weights=li["volume"][sel],
                          minlength=len(cu["c_custkey"]) + 1)
    groups = np.unique(cust)
    top = groups[np.lexsort((groups, -revenue[groups]))[:limit]]
    seg = t["customer"].column("c_mktsegment").dictionary
    return {"c_custkey": top.tolist(),
            "c_mktsegment": [seg[s] for s in cu["c_mktsegment"][top - 1]],
            "revenue": revenue[top]}, int(sel.sum())


def q12_oracle(t, c):
    """Lineitems received in 1994 by mail or ship, counted per ship mode
    for urgent or high-priority orders and for the others."""
    from arrow_tpu_torch.io.tpch_queries import (DATE_1994_01_01,
                                                 DATE_1995_01_01)
    li, od = c["lineitem"], c["orders"]
    modes = t["lineitem"].column("l_shipmode").dictionary
    sel = ((li["l_receiptdate"] >= DATE_1994_01_01)
           & (li["l_receiptdate"] < DATE_1995_01_01)
           & np.isin(li["l_shipmode"], _codes(t["lineitem"], "l_shipmode",
                                              ["MAIL", "SHIP"])))
    urgent = np.isin(od["o_orderpriority"], _codes(
        t["orders"], "o_orderpriority", ["1-URGENT", "2-HIGH"]))
    high = urgent[li["l_orderkey"][sel] - 1]
    mode = li["l_shipmode"][sel]
    n_high = np.bincount(mode[high], minlength=len(modes))
    n_all = np.bincount(mode, minlength=len(modes))
    groups = sorted((modes[m], m) for m in np.flatnonzero(n_all))
    return {"l_shipmode": [g[0] for g in groups],
            "high_line_count": [int(n_high[m]) for _, m in groups],
            "low_line_count": [int(n_all[m] - n_high[m]) for _, m in groups]
            }, int(sel.sum())


def q5_oracle(t, c, region_name="ASIA"):
    """Revenue per nation of one region from the 1994 orders whose
    customer and supplier share that nation, by revenue descending."""
    from arrow_tpu_torch.io.tpch_queries import (DATE_1994_01_01,
                                                 DATE_1995_01_01)
    li, od, cu, su, nd, rd = (c[k] for k in (
        "lineitem", "orders", "customer", "supplier", "nation", "region"))
    (region,) = _codes(t["region"], "r_name", [region_name])
    in_region = np.isin(nd["n_regionkey"],
                        rd["r_regionkey"][rd["r_name"] == region])
    date = od["o_orderdate"]
    order_ok = (date >= DATE_1994_01_01) & (date < DATE_1995_01_01)
    okey = li["l_orderkey"] - 1
    c_nation = cu["c_nationkey"][od["o_custkey"][okey] - 1]
    s_nation = su["s_nationkey"][li["l_suppkey"] - 1]
    sel = order_ok[okey] & (c_nation == s_nation) & in_region[s_nation]
    revenue = np.bincount(s_nation[sel], weights=li["volume"][sel],
                          minlength=25)
    groups = np.unique(s_nation[sel])
    groups = groups[np.argsort(-revenue[groups], kind="stable")]
    names = t["nation"].column("n_name").dictionary
    return {"n_name": [names[nd["n_name"][g]] for g in groups],
            "revenue": revenue[groups]}, int(sel.sum())


def q9_oracle(t, c):
    """Profit per nation and order year (days // 365, as date32) of the
    lineitems of BRASS parts, each joined to every partsupp row of its
    (part, supplier) pair; by nation ascending, year descending."""
    import datetime
    li, od, pt, su, ps, nd = (c[k] for k in (
        "lineitem", "orders", "part", "supplier", "partsupp", "nation"))
    brass = np.array(["BRASS" in v for v in
                      t["part"].column("p_type").dictionary])
    rows = np.flatnonzero(brass[pt["p_type"][li["l_partkey"] - 1]])
    # each pair as one int64, searched in partsupp's sorted pairs; the
    # lineitem pairs are sorted too (the groups' sums ignore row order),
    # which keeps numpy's searches cache-friendly
    radix = len(su["s_suppkey"]) + 1
    ps_pair = ps["ps_partkey"] * radix + ps["ps_suppkey"]
    order = np.argsort(ps_pair, kind="stable")
    ps_sorted = ps_pair[order]
    pair = li["l_partkey"][rows] * radix + li["l_suppkey"][rows]
    by_pair = np.argsort(pair, kind="stable")
    rows, pair = rows[by_pair], pair[by_pair]
    lo = np.searchsorted(ps_sorted, pair, side="left")
    counts = np.searchsorted(ps_sorted, pair, side="right") - lo
    rows = np.repeat(rows, counts)
    cost = ps["ps_supplycost"][order[np.repeat(lo, counts)
                                     + _ranks_within(counts)]]
    nation = su["s_nationkey"][li["l_suppkey"][rows] - 1]
    year = od["o_orderdate"][li["l_orderkey"][rows] - 1] // 365
    amount = li["volume"][rows] - cost * li["l_quantity"][rows]
    groups, inverse = np.unique(nation * 1000 + year, return_inverse=True)
    profit = np.bincount(inverse.reshape(-1), weights=amount,
                         minlength=len(groups))
    names = t["nation"].column("n_name").dictionary
    keys = sorted((names[nd["n_name"][g // 1000]], -int(g % 1000), i)
                  for i, g in enumerate(groups))
    epoch = datetime.date(1970, 1, 1)
    return {"nation": [k[0] for k in keys],
            "o_year": [epoch + datetime.timedelta(days=-k[1]) for k in keys],
            "sum_profit": profit[[k[2] for k in keys]]}, len(rows)


def q14_oracle(t, c):
    """100 x the revenue of PROMO parts over all revenue, lineitems
    shipped in the month from 1995-09-01."""
    from arrow_tpu_torch.io.tpch_queries import DATE_1995_09_01
    li, pt = c["lineitem"], c["part"]
    sel = (li["l_shipdate"] >= DATE_1995_09_01) \
        & (li["l_shipdate"] < DATE_1995_09_01 + 30)
    promo_type = np.array([v.startswith("PROMO") for v in
                           t["part"].column("p_type").dictionary])
    promo = promo_type[pt["p_type"][li["l_partkey"][sel] - 1]]
    volume = li["volume"][sel]
    return {"promo_revenue": np.array(
        [100.0 * volume[promo].sum() / volume.sum()])}, int(sel.sum())


def q19_oracle(t, c):
    """Revenue of the air-shipped, delivered-in-person lineitems inside
    one of three brand, container, quantity and size envelopes."""
    li, pt = c["lineitem"], c["part"]
    sel = np.isin(li["l_shipmode"], _codes(t["lineitem"], "l_shipmode",
                                           ["AIR", "REG AIR"])) \
        & (li["l_shipinstruct"] == _codes(t["lineitem"], "l_shipinstruct",
                                          ["DELIVER IN PERSON"])[0])
    rows = np.flatnonzero(sel)
    p = li["l_partkey"][rows] - 1
    qty = li["l_quantity"][rows]
    keep = np.zeros(len(rows), dtype=bool)
    for brand, size, qty_lo, size_hi in (("Brand#12", "SM", 1.0, 5),
                                         ("Brand#23", "MED", 10.0, 10),
                                         ("Brand#34", "LG", 20.0, 15)):
        boxes = ("BAG", "BOX", "PKG", "PACK") if size == "MED" \
            else ("CASE", "BOX", "PACK", "PKG")
        keep |= ((pt["p_brand"][p] == _codes(t["part"], "p_brand",
                                             [brand])[0])
                 & np.isin(pt["p_container"][p], _codes(
                     t["part"], "p_container",
                     [f"{size} {b}" for b in boxes]))
                 & (qty >= qty_lo) & (qty <= qty_lo + 10.0)
                 & (pt["p_size"][p] >= 1) & (pt["p_size"][p] <= size_hi))
    return {"revenue": np.array([li["volume"][rows][keep].sum()])}, \
        int(keep.sum())


class SuiteQuery(NamedTuple):
    """One query of phase 3c or 3d: its plan in ``io/tpch_queries.py``, the
    tables it takes, its numpy oracle, its launches a run, and a function
    of (tables, oracle columns) that gives the plan's and the oracle's
    parameters where the defaults do not serve at SF10."""
    name: str
    plan: str
    tables: tuple
    oracle: object
    launches: dict
    params: object = None


def _launches(compact, hash32, grouped_sum):
    return {"compact": compact, "hash32": hash32,
            "grouped_sum": grouped_sum, "probe": 1}


# Launches a run (see PERF.md §4 for the joins that take the bloom: every
# lineitem probe here does, as does orders probing customer in Q5). Each
# join's build side has unique keys, so each inner join takes the
# unique-build compaction; each filter on a join input compacts, and a
# filter below a (scalar) aggregate folds into it. Q5's revenue by n_name
# (26 slots) and Q9's profit over its 1,024-row join output take
# grouped_sum.
SUITE = (
    SuiteQuery("Q6", "q6_plan", ("lineitem",), q6_oracle,
               _launches(0, 0, 0)),
    SuiteQuery("Q10", "q10_style_plan", ("customer", "orders", "lineitem"),
               q10_oracle, _launches(5, 2, 0)),
    SuiteQuery("Q12", "q12_style_plan", ("orders", "lineitem"), q12_oracle,
               _launches(3, 2, 0)),
    SuiteQuery("Q5", "q5_plan", ("customer", "orders", "lineitem",
                                 "supplier", "nation", "region"),
               q5_oracle, _launches(11, 8, 1)),
    SuiteQuery("Q9", "q9_style_plan", ("part", "supplier", "lineitem",
                                       "partsupp", "orders", "nation"),
               q9_oracle, _launches(7, 2, 1)),
    SuiteQuery("Q14", "q14_plan", ("lineitem", "part"), q14_oracle,
               _launches(3, 2, 0)),
    SuiteQuery("Q19", "q19_plan", ("lineitem", "part"), q19_oracle,
               _launches(3, 2, 0)),
)


def suite_plan(q: SuiteQuery, tables, params=None):
    from arrow_tpu_torch.io import tpch_queries
    return getattr(tpch_queries, q.plan)(*(tables[k] for k in q.tables),
                                         **(params or {}))


# --- phase 3d: the last eleven of the 22 plans -------------------------------

def _full_columns(t):
    """The downloaded source columns the oracles of ``FULL`` read, by
    table."""
    return _oracle_columns(t, {
        "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                     "l_extendedprice", "l_discount", "l_shipdate",
                     "l_commitdate", "l_receiptdate"],
        "orders": ["o_orderkey", "o_custkey", "o_orderstatus",
                   "o_totalprice", "o_orderdate"],
        "customer": ["c_custkey", "c_name", "c_nationkey", "c_phone",
                     "c_acctbal"],
        "part": ["p_partkey", "p_name", "p_mfgr", "p_type", "p_size",
                 "p_brand", "p_container"],
        "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey",
                     "s_phone", "s_acctbal", "s_comment"],
        "partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty",
                     "ps_supplycost"],
        "nation": ["n_nationkey", "n_name", "n_regionkey"],
        "region": ["r_regionkey", "r_name"]})


def _dictionary(t, table, name):
    """A dictionary column's values as a numpy object array by code."""
    return np.array(t[table].column(name).dictionary, dtype=object)


def _value_ranks(t, table, name):
    """Per dictionary code: the rank of its value in sorted order."""
    values = _dictionary(t, table, name)
    ranks = np.empty(len(values), dtype=np.int64)
    ranks[np.argsort(values, kind="stable")] = np.arange(len(values))
    return ranks


def _days(y, m, d):
    import datetime
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _dates(days):
    import datetime
    epoch = datetime.date(1970, 1, 1)
    return [epoch + datetime.timedelta(days=int(d)) for d in days]


def _year(days):
    """The calendar year of days since 1970-01-01."""
    return days.astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970


def _nation_key(t, c, name):
    (code,) = _codes(t["nation"], "n_name", [name])
    (key,) = c["nation"]["n_nationkey"][c["nation"]["n_name"] == code]
    return key


def _nations_in_region(t, c, region_name):
    """bool per nation key: the nation lies in the region."""
    (code,) = _codes(t["region"], "r_name", [region_name])
    rd, nd = c["region"], c["nation"]
    return np.isin(nd["n_regionkey"], rd["r_regionkey"][rd["r_name"] == code])


def _nation_names(t, c, keys):
    names = _dictionary(t, "nation", "n_name")
    return list(names[c["nation"]["n_name"][keys]])


def q2_oracle(t, c, size=15, type_suffix="BRASS", region_name="EUROPE",
              limit=100):
    """The region's partsupp rows at their part's least supply cost, for
    parts of one size whose type ends with the suffix; top ``limit`` by
    balance, nation, supplier and part."""
    pt, su, ps = c["part"], c["supplier"], c["partsupp"]
    eu = _nations_in_region(t, c, region_name)[su["s_nationkey"]]
    rows = np.flatnonzero(eu[ps["ps_suppkey"] - 1])
    pk, cost = ps["ps_partkey"][rows], ps["ps_supplycost"][rows]
    least = np.full(len(pt["p_partkey"]) + 1, np.inf)
    np.minimum.at(least, pk, cost)
    suffix = np.array([v.endswith(type_suffix)
                       for v in _dictionary(t, "part", "p_type")])
    part_ok = (pt["p_size"] == size) & suffix[pt["p_type"]]
    keep = part_ok[pk - 1] & (cost == least[pk])
    rows, pk = rows[keep], pk[keep]
    s = ps["ps_suppkey"][rows] - 1
    nat = su["s_nationkey"][s]
    acct = su["s_acctbal"][s]
    order = np.lexsort((pk, _value_ranks(t, "supplier", "s_name")[
        su["s_name"][s]], _value_ranks(t, "nation", "n_name")[
        c["nation"]["n_name"][nat]], -acct))[:limit]
    s, pk = s[order], pk[order]

    def sup(name):
        return list(_dictionary(t, "supplier", name)[su[name][s]])
    return {"s_acctbal": acct[order], "s_name": sup("s_name"),
            "n_name": _nation_names(t, c, nat[order]),
            "p_partkey": pk.tolist(),
            "p_mfgr": list(_dictionary(t, "part", "p_mfgr")[
                pt["p_mfgr"][pk - 1]]),
            "s_address": sup("s_address"), "s_phone": sup("s_phone"),
            "s_comment": sup("s_comment")}, len(rows)


def q7_oracle(t, c, nation1="FRANCE", nation2="GERMANY"):
    """Revenue of 1995-1996 shipments between the two nations, by
    supplier nation, customer nation and ship year."""
    li, od, cu, su = (c[k] for k in ("lineitem", "orders", "customer",
                                     "supplier"))
    date = li["l_shipdate"]
    rows = np.flatnonzero((date >= _days(1995, 1, 1))
                          & (date <= _days(1996, 12, 31)))
    cn = cu["c_nationkey"][od["o_custkey"][li["l_orderkey"][rows] - 1] - 1]
    sn = su["s_nationkey"][li["l_suppkey"][rows] - 1]
    k1, k2 = _nation_key(t, c, nation1), _nation_key(t, c, nation2)
    ok = ((sn == k1) & (cn == k2)) | ((sn == k2) & (cn == k1))
    rows, sn, cn = rows[ok], sn[ok], cn[ok]
    key = (sn * 25 + cn) * 10_000 + _year(li["l_shipdate"][rows])
    groups, inverse = np.unique(key, return_inverse=True)
    revenue = np.bincount(inverse.reshape(-1), weights=li["volume"][rows],
                          minlength=len(groups))
    sn_g, cn_g = groups // 10_000 // 25, groups // 10_000 % 25
    sn_names = _nation_names(t, c, sn_g)
    cn_names = _nation_names(t, c, cn_g)
    order = sorted(range(len(groups)), key=lambda i: (
        sn_names[i], cn_names[i], groups[i] % 10_000))
    return {"supp_nation": [sn_names[i] for i in order],
            "cust_nation": [cn_names[i] for i in order],
            "l_year": [int(groups[i] % 10_000) for i in order],
            "revenue": revenue[order]}, len(rows)


def q8_oracle(t, c, p_type="ECONOMY ANODIZED STEEL", nation_name="BRAZIL",
              region_name="AMERICA"):
    """By order year, the share of the nation's suppliers in the revenue
    of one part type sold to the region's customers in 1995-1996."""
    li, od, cu, su, pt = (c[k] for k in ("lineitem", "orders", "customer",
                                         "supplier", "part"))
    (type_code,) = _codes(t["part"], "p_type", [p_type])
    in_region = _nations_in_region(t, c, region_name)
    date = od["o_orderdate"]
    order_ok = (date >= _days(1995, 1, 1)) & (date <= _days(1996, 12, 31))
    okey = li["l_orderkey"] - 1
    rows = np.flatnonzero((pt["p_type"][li["l_partkey"] - 1] == type_code)
                          & order_ok[okey]
                          & in_region[cu["c_nationkey"][od["o_custkey"][okey]
                                                        - 1]])
    year = _year(date[okey[rows]])
    volume = li["volume"][rows]
    mine = su["s_nationkey"][li["l_suppkey"][rows] - 1] \
        == _nation_key(t, c, nation_name)
    years, inverse = np.unique(year, return_inverse=True)
    inverse = inverse.reshape(-1)
    total = np.bincount(inverse, weights=volume, minlength=len(years))
    nation = np.bincount(inverse, weights=np.where(mine, volume, 0.0),
                         minlength=len(years))
    return {"o_year": years.tolist(), "mkt_share": nation / total}, len(rows)


def q11_params(t, c):
    """TPC-H's FRACTION, 0.0001 / SF (SF from the supplier count)."""
    return {"fraction": 0.0001 * 10_000 / len(c["supplier"]["s_suppkey"])}


def q11_oracle(t, c, nation_name="GERMANY", fraction=0.0001):
    """Stock value per part over the nation's suppliers, the parts above
    ``fraction`` of the total, by value descending."""
    su, ps = c["supplier"], c["partsupp"]
    sup_ok = su["s_nationkey"] == _nation_key(t, c, nation_name)
    rows = np.flatnonzero(sup_ok[ps["ps_suppkey"] - 1])
    value = ps["ps_supplycost"][rows] * ps["ps_availqty"][rows] \
        .astype(np.float64)
    pk = ps["ps_partkey"][rows]
    size = len(c["part"]["p_partkey"]) + 1
    per_part = np.bincount(pk, weights=value, minlength=size)
    present = np.bincount(pk, minlength=size) > 0
    parts = np.flatnonzero(present & (per_part > value.sum() * fraction))
    parts = parts[np.lexsort((parts, -per_part[parts]))]
    return {"ps_partkey": parts.tolist(), "value": per_part[parts]}, \
        len(rows)


def q15_oracle(t, c, date_lo=None):
    """The suppliers with the largest revenue over the quarter from
    1996-01-01."""
    li, su = c["lineitem"], c["supplier"]
    lo = _days(1996, 1, 1) if date_lo is None else date_lo
    sel = (li["l_shipdate"] >= lo) & (li["l_shipdate"] < lo + 90)
    size = len(su["s_suppkey"]) + 1
    revenue = np.bincount(li["l_suppkey"][sel], weights=li["volume"][sel],
                          minlength=size)
    present = np.bincount(li["l_suppkey"][sel], minlength=size) > 0
    top = np.flatnonzero(present & (revenue == revenue[present].max()))

    def sup(name):
        return list(_dictionary(t, "supplier", name)[su[name][top - 1]])
    return {"s_suppkey": top.tolist(), "s_name": sup("s_name"),
            "s_address": sup("s_address"), "s_phone": sup("s_phone"),
            "total_revenue": revenue[top]}, int(sel.sum())


def q16_oracle(t, c, brand="Brand#45", type_prefix="MEDIUM POLISHED",
               sizes=(49, 14, 23, 45, 19, 3, 36, 9)):
    """Distinct suppliers without complaints per (brand, type, size) of
    the parts kept, by count descending, then brand, type and size."""
    import re
    pt, su, ps = c["part"], c["supplier"], c["partsupp"]
    (bad_brand,) = _codes(t["part"], "p_brand", [brand])
    types = _dictionary(t, "part", "p_type")
    type_ok = np.array([not v.startswith(type_prefix) for v in types])
    part_ok = (pt["p_brand"] != bad_brand) & type_ok[pt["p_type"]] \
        & np.isin(pt["p_size"], sizes)
    complaint = np.array([re.match("^.*Customer.*Complaints.*$", v)
                          is not None
                          for v in _dictionary(t, "supplier", "s_comment")])
    bad = complaint[su["s_comment"]]
    rows = np.flatnonzero(~bad[ps["ps_suppkey"] - 1]
                          & part_ok[ps["ps_partkey"] - 1])
    p = ps["ps_partkey"][rows] - 1
    group = (pt["p_brand"][p].astype(np.int64) * len(types)
             + pt["p_type"][p]) * 64 + pt["p_size"][p]
    radix = len(su["s_suppkey"]) + 1
    pairs = np.unique(group * radix + ps["ps_suppkey"][rows])
    groups, counts = np.unique(pairs // radix, return_counts=True)
    b, ty, size = groups // 64 // len(types), groups // 64 % len(types), \
        groups % 64
    order = np.lexsort((size, _value_ranks(t, "part", "p_type")[ty],
                        _value_ranks(t, "part", "p_brand")[b], -counts))
    return {"p_brand": list(_dictionary(t, "part", "p_brand")[b[order]]),
            "p_type": list(types[ty[order]]),
            "p_size": size[order].tolist(),
            "supplier_cnt": counts[order].tolist()}, len(rows)


def q17_oracle(t, c, brand="Brand#23", container="MED BOX"):
    """A seventh of the price of the brand's and container's lines whose
    quantity is under a fifth of their part's mean quantity."""
    li, pt = c["lineitem"], c["part"]
    (b,) = _codes(t["part"], "p_brand", [brand])
    (k,) = _codes(t["part"], "p_container", [container])
    part_ok = (pt["p_brand"] == b) & (pt["p_container"] == k)
    pk = li["l_partkey"]
    size = len(pt["p_partkey"]) + 1
    mean = np.bincount(pk, weights=li["l_quantity"], minlength=size) \
        / np.maximum(np.bincount(pk, minlength=size), 1)
    sel = part_ok[pk - 1] & (li["l_quantity"] < mean[pk] * 0.2)
    return {"avg_yearly": np.array([li["l_extendedprice"][sel].sum()
                                    / 7.0])}, int(sel.sum())


def q18_oracle(t, c, quantity=300.0, limit=100):
    """The orders of more than ``quantity`` units with their customer,
    the top ``limit`` by price, date and key."""
    li, od, cu = c["lineitem"], c["orders"], c["customer"]
    size = len(od["o_orderkey"]) + 1
    units = np.bincount(li["l_orderkey"], weights=li["l_quantity"],
                        minlength=size)
    present = np.bincount(li["l_orderkey"], minlength=size) > 0
    big = np.flatnonzero(present & (units > quantity))
    price, date = od["o_totalprice"][big - 1], od["o_orderdate"][big - 1]
    top = big[np.lexsort((big, date, -price))[:limit]]
    cust = od["o_custkey"][top - 1]
    return {"c_name": list(_dictionary(t, "customer", "c_name")[
                cu["c_name"][cust - 1]]),
            "c_custkey": cust.tolist(), "o_orderkey": top.tolist(),
            "o_orderdate": _dates(od["o_orderdate"][top - 1]),
            "o_totalprice": od["o_totalprice"][top - 1],
            "sum_qty": units[top]}, len(big)


def _q20_suppliers(t, c, name_prefix, date_lo):
    """The suppliers with a partsupp row of a part named ``name_prefix``...
    whose stock exceeds half of the pair's units shipped in the year."""
    li, pt, ps = c["lineitem"], c["part"], c["partsupp"]
    lo = _days(1994, 1, 1) if date_lo is None else date_lo
    sel = (li["l_shipdate"] >= lo) & (li["l_shipdate"] < lo + 365)
    radix = len(c["supplier"]["s_suppkey"]) + 1
    pairs, inverse = np.unique(li["l_partkey"][sel] * radix
                               + li["l_suppkey"][sel], return_inverse=True)
    units = np.bincount(inverse.reshape(-1), weights=li["l_quantity"][sel],
                        minlength=len(pairs))
    names = t["part"].column("p_name").dictionary
    named = np.fromiter((v.startswith(name_prefix) for v in names),
                        dtype=bool, count=len(names))
    rows = np.flatnonzero(named[pt["p_name"]][ps["ps_partkey"] - 1])
    want = ps["ps_partkey"][rows] * radix + ps["ps_suppkey"][rows]
    pos = np.minimum(np.searchsorted(pairs, want), max(len(pairs) - 1, 0))
    found = (pairs[pos] == want) if len(pairs) else np.zeros(len(want), bool)
    keep = found & (ps["ps_availqty"][rows].astype(np.float64)
                    > units[pos] * 0.5)
    return np.unique(ps["ps_suppkey"][rows][keep])


def q20_params(t, c):
    """The nation of the first supplier Q20 keeps over all nations (as
    the reference's test picks it): at SF10 about ten suppliers qualify
    in all, so the default nation may have none."""
    (first,) = _q20_suppliers(t, c, "forest", None)[:1]
    nat = c["supplier"]["s_nationkey"][first - 1]
    return {"nation_name": _nation_names(t, c, [nat])[0]}


def q20_oracle(t, c, name_prefix="forest", nation_name="CANADA",
               date_lo=None):
    """The nation's suppliers of ``_q20_suppliers``, by name."""
    su = c["supplier"]
    keys = _q20_suppliers(t, c, name_prefix, date_lo)
    keys = keys[su["s_nationkey"][keys - 1]
                == _nation_key(t, c, nation_name)]
    keys = keys[np.argsort(_value_ranks(t, "supplier", "s_name")[
        su["s_name"][keys - 1]], kind="stable")]

    def sup(name):
        return list(_dictionary(t, "supplier", name)[su[name][keys - 1]])
    return {"s_name": sup("s_name"), "s_address": sup("s_address")}, \
        len(keys)


def q21_oracle(t, c, nation_name="SAUDI ARABIA", limit=100):
    """Per supplier of the nation, its late lines of finished orders that
    had more than one supplier, of which only it was late. Distinct
    suppliers per order, in all and late, come from one sort of the
    packed (order, supplier, late) words."""
    li, od, su = c["lineitem"], c["orders"], c["supplier"]
    ok, sk = li["l_orderkey"], li["l_suppkey"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    shift = int(sk.max()).bit_length()
    words = np.sort(((ok << shift | sk) << 1) | late)
    pair = words >> 1
    last = np.ones(len(words), dtype=bool)
    last[:-1] = pair[1:] != pair[:-1]
    # the last word of a pair's run has the late bit iff some line is late
    size = len(od["o_orderkey"]) + 1
    nsupp = np.bincount(pair[last] >> shift, minlength=size)
    nlate = np.bincount(pair[last & (words & 1 == 1)] >> shift,
                        minlength=size)
    (finished,) = _codes(t["orders"], "o_orderstatus", ["F"])
    sup_ok = su["s_nationkey"] == _nation_key(t, c, nation_name)
    rows = late & (od["o_orderstatus"][ok - 1] == finished) \
        & sup_ok[sk - 1] & (nsupp[ok] > 1) & (nlate[ok] == 1)
    names = su["s_name"][sk[rows] - 1]
    counts = np.bincount(names, minlength=len(su["s_suppkey"]))
    groups = np.flatnonzero(counts)
    groups = groups[np.lexsort((_value_ranks(t, "supplier", "s_name")[groups],
                                -counts[groups]))][:limit]
    return {"s_name": list(_dictionary(t, "supplier", "s_name")[groups]),
            "numwait": counts[groups].tolist()}, int(rows.sum())


def q22_oracle(t, c, codes=("13", "31", "23", "29", "30", "18", "17")):
    """Customers of the country codes (the first two characters of the
    phone number) richer than the codes' mean positive balance and with
    no order, counted and summed by code."""
    cu, od = c["customer"], c["orders"]
    phones = t["customer"].column("c_phone").dictionary
    code = np.fromiter((int(v[:2]) for v in phones), dtype=np.int64,
                       count=len(phones))[cu["c_phone"]]
    sel = np.isin(code, [int(k) for k in codes])
    bal = cu["c_acctbal"]
    mean = bal[sel & (bal > 0.0)].mean()
    has_order = np.bincount(od["o_custkey"],
                            minlength=len(cu["c_custkey"]) + 1) > 0
    rich = sel & (bal > mean) & ~has_order[cu["c_custkey"]]
    groups, inverse = np.unique(code[rich], return_inverse=True)
    inverse = inverse.reshape(-1)
    return {"cntrycode": [f"{g:02d}" for g in groups],
            "numcust": np.bincount(inverse, minlength=len(groups)).tolist(),
            "totacctbal": np.bincount(inverse, weights=bal[rich],
                                      minlength=len(groups))}, \
        int(rich.sum())


# Launches a run at SF10, reckoned from the code (PERF.md §4 has the
# joins of each plan): each filter on a join input, and the HAVING filter
# above Q18's grouped sum, compacts, and a filter below an aggregate folds
# into it; an inner join whose build keys are unique takes the
# unique-build compaction; a join takes the bloom (2 hash32 launches, 1
# compact) where its probe capacity is at least 4x its build capacity and
# its type is inner, left semi, right semi or right outer (at SF10 every
# lineitem probe of orders does: 60,012,544 >= 4 x 15,000,576, while
# partsupp probing part does not: 8,000,512 < 4 x 2,000,896); a left semi
# or anti join compacts its probe side; a declaration with two parents
# (Q2's region suppliers' partsupp, Q11's partsupp, Q15's revenue, Q22's
# customers of the codes) runs once.
# Only Q22's sum by its 25 country codes (26 slots) takes grouped_sum: the
# other sums group on keys that are not perfect-hashable, over
# capacities above 1,024.
FULL = (
    SuiteQuery("Q2", "q2_plan", ("part", "supplier", "partsupp", "nation",
                                 "region"), q2_oracle, _launches(9, 4, 0)),
    SuiteQuery("Q7", "q7_plan", ("supplier", "lineitem", "orders",
                                 "customer", "nation"), q7_oracle,
               _launches(11, 10, 0)),
    SuiteQuery("Q8", "q8_plan", ("part", "supplier", "lineitem", "orders",
                                 "customer", "nation", "region"), q8_oracle,
               _launches(13, 6, 0)),
    SuiteQuery("Q11", "q11_plan", ("partsupp", "supplier", "nation"),
               q11_oracle, _launches(8, 6, 0), q11_params),
    SuiteQuery("Q15", "q15_plan", ("lineitem", "supplier"), q15_oracle,
               _launches(4, 2, 0)),
    SuiteQuery("Q16", "q16_plan", ("partsupp", "part", "supplier"),
               q16_oracle, _launches(4, 0, 0)),
    SuiteQuery("Q17", "q17_plan", ("lineitem", "part"), q17_oracle,
               _launches(4, 2, 0)),
    SuiteQuery("Q18", "q18_plan", ("customer", "orders", "lineitem"),
               q18_oracle, _launches(4, 2, 0)),
    SuiteQuery("Q20", "q20_plan", ("supplier", "nation", "partsupp", "part",
                                   "lineitem"), q20_oracle,
               _launches(9, 4, 0), q20_params),
    SuiteQuery("Q21", "q21_plan", ("supplier", "lineitem", "orders",
                                   "nation"), q21_oracle, _launches(11, 6, 0)),
    SuiteQuery("Q22", "q22_plan", ("customer", "orders"), q22_oracle,
               _launches(5, 2, 1)),
)


# --- phase 3e: the plan nodes beyond the 22 plans ----------------------------

SPLIT_DATE = _days(1995, 6, 17)     # lineitem's two halves for the union
SPLIT_PRICE = 280_000.0             # orders' two halves for sorted_merge
ASOF_TOLERANCE = -90                # days an as-of match may look back
TOP_K = 100


def _source(batch):
    from arrow_tpu_torch.acero import Declaration, TableSourceNodeOptions
    return Declaration("table_source", TableSourceNodeOptions(batch))


def _chain(*decls):
    from arrow_tpu_torch.acero import Declaration
    return Declaration.from_sequence(list(decls))


def _filter_decl(predicate):
    from arrow_tpu_torch.acero import Declaration, FilterNodeOptions
    return Declaration("filter", FilterNodeOptions(predicate))


def spelled_apart(decl):
    """The tree with each declaration cloned for every parent that reaches
    it: a shared sub-plan spelled out as separate declarations, each of
    which runs."""
    from arrow_tpu_torch.acero import Declaration
    return Declaration(decl.factory_name, decl.options,
                       [spelled_apart(i) for i in decl.inputs])


def q21_residual(t):
    from arrow_tpu_torch.io.tpch_queries import q21_residual_plan
    return q21_residual_plan(t["supplier"], t["lineitem"], t["orders"],
                             t["nation"])


def check_q21_residual(t, c, result):
    want, n_rows = q21_oracle(t, c)
    check_result("Q21 residual", result, want)
    return f"{len(result['s_name'])} suppliers as q21_oracle, {n_rows} lines"


def q1_union(t):
    """Q1 over the union of lineitem's rows shipped by SPLIT_DATE and the
    rest."""
    from arrow_tpu_torch.acero import (Declaration, UnionNodeOptions,
                                       field)
    from arrow_tpu_torch.io.tpch_queries import q1_chain_decls
    date = field("l_shipdate")
    halves = [_chain(_source(t["lineitem"]), _filter_decl(p))
              for p in (date <= SPLIT_DATE, date > SPLIT_DATE)]
    return _chain(Declaration("union", UnionNodeOptions(), halves),
                  *q1_chain_decls())


def check_q1_union(t, c, result):
    li = t["lineitem"]
    check_result("Q1 over a union", result, q1_oracle(li, int(li.row_count)))
    return f"{len(result['count_order'])} groups as q1_oracle"


def q1_segmented(t):
    """Q1's filter, project and aggregates with the return flag as the
    segment key and the line status as the key."""
    from arrow_tpu_torch.acero import AggregateNodeOptions, Declaration
    from arrow_tpu_torch.io.tpch_queries import q1_chain_decls
    filt, proj, agg, _ = q1_chain_decls()
    return _chain(_source(t["lineitem"]), filt, proj, Declaration(
        "aggregate", AggregateNodeOptions(
            agg.options.aggregates, keys=["l_linestatus"],
            segment_keys=["l_returnflag"])))


def check_q1_segmented(t, c, result):
    """``q1_oracle``'s rows in the reference's order: the grouper's groups
    (by first appearance among the kept rows) stably sorted by the return
    flag's value."""
    from arrow_tpu_torch.io.tpch_queries import DATE_1998_09_02
    li = t["lineitem"]
    n = int(li.row_count)
    want = q1_oracle(li, n)
    cols = _host_columns(li, ["l_returnflag", "l_linestatus", "l_shipdate"])
    rf = li.column("l_returnflag").dictionary
    ls = li.column("l_linestatus").dictionary
    kept = cols["l_shipdate"] <= DATE_1998_09_02
    key = cols["l_returnflag"][kept].astype(np.int64) * len(ls) \
        + cols["l_linestatus"][kept]
    groups, first = np.unique(key, return_index=True)
    first_of = {(rf[k // len(ls)], ls[k % len(ls)]): f
                for k, f in zip(groups, first)}
    rows = sorted(range(len(want["l_returnflag"])), key=lambda i: (
        want["l_returnflag"][i],
        first_of[(want["l_returnflag"][i], want["l_linestatus"][i])]))
    want = {k: v[rows] if isinstance(v, np.ndarray) else [v[i] for i in rows]
            for k, v in want.items()}
    check_result("Q1 segmented", result, want)
    return f"{len(rows)} groups, segment order " + " ".join(
        f"{a}{b}" for a, b in zip(result["l_returnflag"],
                                  result["l_linestatus"]))


def sorted_merge(t):
    """orders split by SPLIT_PRICE, each half sorted by (o_orderdate,
    o_orderkey), merged."""
    from arrow_tpu_torch.acero import (Declaration, OrderByNodeOptions,
                                       SortedMergeNodeOptions, field)
    keys = [("o_orderdate", "ascending"), ("o_orderkey", "ascending")]
    price = field("o_totalprice")
    halves = [_chain(_source(t["orders"]), _filter_decl(p),
                     Declaration("order_by", OrderByNodeOptions(keys)))
              for p in (price < SPLIT_PRICE, price >= SPLIT_PRICE)]
    return Declaration("sorted_merge", SortedMergeNodeOptions(keys), halves)


def check_sorted_merge(t, c, batch):
    od = c["orders"]
    want = od["o_orderkey"][np.lexsort((od["o_orderkey"], od["o_orderdate"]))]
    got = _host_columns(batch, ["o_orderkey", "o_orderdate", "o_totalprice"])
    if not (np.array_equal(got["o_orderkey"], want)
            and np.array_equal(got["o_orderdate"], od["o_orderdate"][want - 1])
            and np.array_equal(got["o_totalprice"],
                               od["o_totalprice"][want - 1])):
        raise AssertionError("sorted_merge: rows differ from np.lexsort's "
                             "order")
    return f"{len(want)} rows in np.lexsort's order"


def asof_join(t):
    """Each order with the price of its customer's latest finished order at
    most 90 days before it (the order itself where it is finished)."""
    from arrow_tpu_torch.acero import (AsofJoinNodeOptions, Declaration,
                                       ProjectNodeOptions, field)
    right = _chain(_source(t["orders"]), _filter_decl(
        field("o_orderstatus") == "F"), Declaration(
            "project", ProjectNodeOptions(
                [field("o_custkey"), field("o_orderdate"),
                 field("o_totalprice")],
                ["o_custkey", "o_orderdate", "prev_totalprice"])))
    return Declaration("asofjoin", AsofJoinNodeOptions(
        "o_orderdate", ["o_custkey"], "o_orderdate", ["o_custkey"],
        ASOF_TOLERANCE), [_source(t["orders"]), right])


def check_asof_join(t, c, batch):
    od = c["orders"]
    (finished,) = _codes(t["orders"], "o_orderstatus", ["F"])
    rows = np.flatnonzero(od["o_orderstatus"] == finished)
    match = asof_oracle(od["o_custkey"], od["o_orderdate"],
                        od["o_custkey"][rows], od["o_orderdate"][rows],
                        ASOF_TOLERANCE)
    n = int(batch.row_count)
    col = batch.column("prev_totalprice")
    vals = col.values[:n].cpu().numpy()
    valid = col.validity[:n].cpu().numpy()
    hit = match >= 0
    got_keys = _host_columns(batch, ["o_orderkey"])["o_orderkey"]
    if not (n == len(od["o_orderkey"])
            and np.array_equal(got_keys, od["o_orderkey"])
            and np.array_equal(valid, hit)
            and np.array_equal(vals[hit], od["o_totalprice"][rows][match[hit]])):
        raise AssertionError("asofjoin: prev_totalprice differs from the "
                             "oracle")
    own = rows[match[hit]] == np.flatnonzero(hit)
    return (f"{n} rows, {int(hit.sum())} matched ({int((~own).sum())} to "
            "an earlier order)")


def select_k(t):
    from arrow_tpu_torch.acero import Declaration, SelectKSinkNodeOptions
    return _chain(_source(t["orders"]), Declaration(
        "select_k_sink", SelectKSinkNodeOptions(
            TOP_K, [("o_totalprice", "descending")])))


def check_select_k(t, c, result):
    od = c["orders"]
    top = np.lexsort((od["o_orderkey"], -od["o_totalprice"]))[:TOP_K]
    if result["o_orderkey"] != od["o_orderkey"][top].tolist() or \
            result["o_totalprice"] != od["o_totalprice"][top].tolist():
        raise AssertionError("select_k_sink: rows differ from the oracle")
    return f"{TOP_K} orders from {result['o_totalprice'][0]}"


def q15_two_views(t):
    """Q15 with its revenue view spelled as two separate declarations,
    each of which runs."""
    from arrow_tpu_torch.io.tpch_queries import q15_plan
    return spelled_apart(q15_plan(t["lineitem"], t["supplier"]))


def check_q15_two_views(t, c, result):
    want, _ = q15_oracle(t, c)
    check_result("Q15 two views", result, want)
    return f"suppliers {result['s_suppkey']} as q15_oracle"


class NodePath(NamedTuple):
    """One path of phase 3e: ``build(tables)`` gives its plan, which runs
    through ``to_table()`` (``download``) or, for a result of millions of
    rows, ``execute_declaration`` with the result left on the card for
    ``check(tables, oracle columns, result)``."""
    name: str
    build: object
    check: object
    launches: dict
    download: bool = True


# Launches a run at SF10, reckoned from the code. Q21's residual spelling:
# the late, finished and nation filters compact (3), the supplier ⋈ nation
# and late ⋈ orders semi joins and the ⋈ supplier inner join each take the
# bloom (3 compact + 6 hash32) and their own compaction (3), and the
# residual semi and anti joins one compaction each (2). The union: its two
# filters and itself compact (3), Q1's sums as in Q1 (7). sorted_merge: two
# filters and the union (3). asofjoin: the right side's filter (1). The
# segmented Q1: its filter runs apart from the aggregate and compacts (1).
# select_k_sink: a top-k, no kernel. Q15 spelled twice: as Q15 (4 + 2).
NODE_PATHS = (
    NodePath("Q21 residual", q21_residual, check_q21_residual,
             _launches(11, 6, 0)),
    NodePath("Q1 union", q1_union, check_q1_union, _launches(3, 0, 7)),
    NodePath("sorted_merge", sorted_merge, check_sorted_merge,
             _launches(3, 0, 0), download=False),
    NodePath("asofjoin", asof_join, check_asof_join, _launches(1, 0, 0),
             download=False),
    NodePath("Q1 segmented", q1_segmented, check_q1_segmented,
             _launches(1, 0, 7)),
    NodePath("select_k_sink", select_k, check_select_k, _launches(0, 0, 0)),
    NodePath("Q15 two views", q15_two_views, check_q15_two_views,
             _launches(4, 2, 0)),
)


def node_path_run(path: NodePath, plan):
    """The function that runs the path's plan once, as phase 3e does."""
    from arrow_tpu_torch.acero.exec import execute_declaration
    return plan.to_table if path.download else \
        (lambda: execute_declaration(plan))


def general_sum_inputs(lineitem):
    """Q15's revenue sum on the general path: the volume of the quarter's
    lines by supplier id over the grouper's segment bound (lineitem's
    capacity), the other lines dead."""
    lo = _days(1996, 1, 1)
    date = lineitem.column("l_shipdate").values
    live = (date >= lo) & (date < lo + 90) & lineitem.row_mask()
    price = lineitem.column("l_extendedprice").values
    volume = price * (1.0 - lineitem.column("l_discount").values)
    gids = lineitem.column("l_suppkey").values
    return (torch.where(live, volume, 0.0), torch.where(live, gids, 0), live,
            lineitem.capacity)


def phase_plan_nodes(tables, cols):
    """The plan nodes at SF10, each path with every launch count set to 0
    just before its run and read just after, against its numpy oracle,
    with the card's peak memory over the run; then the sums' repeat
    checks. Every path runs before a failure is raised. Returns the
    launches by path."""
    from arrow_tpu_torch.compute.move import segment_sum
    from arrow_tpu_torch.platform_check import self_check
    log(f"== phase 3e: the plan nodes at SF{SF:g}")
    launches, failures = {}, []
    for path in NODE_PATHS:
        plan = path.build(tables)
        base = memory_mark()
        zero_launches()
        self_check()
        t1 = time.perf_counter()
        result = node_path_run(path, plan)()
        torch.cuda.synchronize()
        log(f"{path.name} first run {time.perf_counter() - t1:.3f} s")
        launches[path.name] = read_launches()
        log_peak(path.name, base)
        try:
            check_launches(path.name, launches[path.name], path.launches)
            t2 = time.perf_counter()
            msg = path.check(tables, cols, result)
            log(f"{path.name} matches its oracle: {msg} (oracle "
                f"{time.perf_counter() - t2:.1f} s)")
        except AssertionError as exc:
            log(f"  {path.name} FAILED: {exc}")
            failures.append(path.name)
        del plan, result
    # F1: the same input gives the same bits, run after run
    v, g, live, nseg = general_sum_inputs(tables["lineitem"])
    a, b = (segment_sum(v, g, nseg, live) for _ in range(2))
    check_bit_exact(f"general float sum, Q15's shape n={v.numel()} "
                    f"S={nseg}, two runs", [a], [b], "the first run")
    want = torch.zeros(nseg, dtype=torch.float64, device="cuda")
    check_close("general float sum against index_add_", a,
                want.index_add_(0, g, v), RTOL_F64)
    del v, g, live, a, b, want
    if failures:
        raise AssertionError(f"phase 3e failed for {failures}")
    return launches


# --- phase 3f: typed plans -------------------------------------------------

SHIPDATE_1998_09_02_S = 904_694_400  # 1998-09-02 in seconds
TYPED_SEED = 7
TYPED_NULLS = 0.01                   # the share of l_suppkey's null rows
TYPED_TOP_K = 100


def typed_tables(lineitem, part, seed=TYPED_SEED):
    """lineitem and part at the widths a SQL schema or Arrow's TPC-H
    generator gives them, made from ``q1_device_batch``'s and
    ``part_table``'s columns by the port's registered functions: the
    keys uint32 by ``cast``, ``l_linenumber`` int8, ``l_quantity`` int16
    (a safe cast: whole numbers), the prices decimal128(12, 2) by
    ``multiply`` by 100, ``round``, a safe ``cast`` to int64 and a
    ``cast`` to the decimal, ``l_tax`` float32, ``l_shipdate``
    timestamp[s] and ``l_commitdate`` date64 by ``cast`` from date32.
    ``l_suppkey`` gets a validity with ``TYPED_NULLS`` nulls from a
    generator seeded with ``seed`` on the tables' device."""
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.compute.registry import ExecContext, get_function
    from arrow_tpu_torch.device.column import DeviceBatch, DeviceColumn
    from arrow_tpu_torch.types import Field, Schema

    def call(batch, fn, *args, **kw):
        ctx = ExecContext(batch.capacity, batch.row_count)
        return get_function(fn).impl(ctx, *args, **kw)

    def cast(batch, col, to):
        return call(batch, "cast", col, to_type=to, safe=True)

    def cents(batch, name):
        c = call(batch, "multiply", batch.column(name), 100)
        c = cast(batch, call(batch, "round", c), T.int64())
        return cast(batch, c, T.decimal128(12, 2))

    li = lineitem.column
    dev = lineitem.row_count.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    valid = torch.rand(lineitem.capacity, generator=gen,
                       device=dev) >= TYPED_NULLS
    suppkey = cast(lineitem, li("l_suppkey"), T.uint32())
    cols = {
        "l_orderkey": li("l_orderkey"),
        "l_partkey": cast(lineitem, li("l_partkey"), T.uint32()),
        "l_suppkey": DeviceColumn(torch.where(valid, suppkey.values, 0),
                                  valid, suppkey.type),
        "l_linenumber": cast(lineitem, li("l_linenumber"), T.int8()),
        "l_quantity": cast(lineitem, li("l_quantity"), T.int16()),
        "l_extendedprice": cents(lineitem, "l_extendedprice"),
        "l_discount": cents(lineitem, "l_discount"),
        "l_tax": cast(lineitem, li("l_tax"), T.float32()),
        "l_returnflag": li("l_returnflag"),
        "l_linestatus": li("l_linestatus"),
        "l_shipdate": cast(lineitem, li("l_shipdate"), T.timestamp("s")),
        "l_commitdate": cast(lineitem, li("l_commitdate"), T.date64()),
    }
    pcols = {"p_partkey": cast(part, part.column("p_partkey"), T.uint32()),
             "p_brand": part.column("p_brand")}

    def batch(cs, rows):
        return DeviceBatch(Schema([Field(k, c.type) for k, c in cs.items()]),
                           list(cs.values()), rows)
    return {"lineitem": batch(cols, lineitem.row_count),
            "part": batch(pcols, part.row_count)}


def _acero(ac):
    if ac is None:
        import arrow_tpu_torch.acero as ac
    return ac


def typed_q1(t, ac=None):
    """Q1 over the typed lineitem: int16 quantities summed exactly in
    int64, decimal prices and discounted prices summed exactly, the
    decimal discount's mean a decimal, the f32 tax summed in f64."""
    ac = _acero(ac)
    D, f = ac.Declaration, ac.field
    return D.from_sequence([
        D("table_source", ac.TableSourceNodeOptions(t["lineitem"])),
        D("filter", ac.FilterNodeOptions(
            f("l_shipdate") <= SHIPDATE_1998_09_02_S)),
        D("project", ac.ProjectNodeOptions(
            [f("l_returnflag"), f("l_linestatus"), f("l_quantity"),
             f("l_extendedprice"), f("l_extendedprice") * f("l_discount"),
             f("l_discount"), f("l_tax")],
            ["l_returnflag", "l_linestatus", "l_quantity",
             "l_extendedprice", "disc_price", "l_discount", "l_tax"])),
        D("aggregate", ac.AggregateNodeOptions(
            [("l_quantity", "hash_sum", None, "sum_qty"),
             ("l_extendedprice", "hash_sum", None, "sum_base_price"),
             ("disc_price", "hash_sum", None, "sum_disc_price"),
             ("l_discount", "hash_mean", None, "avg_disc"),
             ("l_tax", "hash_sum", None, "sum_tax"),
             ("l_quantity", "hash_mean", None, "avg_qty"),
             ("l_quantity", "hash_count", None, "count_order")],
            keys=["l_returnflag", "l_linestatus"])),
        D("order_by", ac.OrderByNodeOptions(
            [("l_returnflag", "ascending"), ("l_linestatus", "ascending")])),
    ])


def typed_join(t, ac=None):
    """The typed lineitem's early small lines joined to part on uint32
    keys (the direct unsigned path, with the bloom), revenue and tax by
    brand, the ten largest revenues. The lines are counted by their int16
    quantity, so the filter's, the bloom's and the join's compactions
    move a 2-byte column beside the 4- and 8-byte ones."""
    ac = _acero(ac)
    D, f = ac.Declaration, ac.field
    lines = D.from_sequence([
        D("table_source", ac.TableSourceNodeOptions(t["lineitem"])),
        D("filter", ac.FilterNodeOptions(
            (f("l_linenumber") <= 2) & (f("l_quantity") < 25)))])
    joined = D("hashjoin", ac.HashJoinNodeOptions(
        "inner", left_keys=["l_partkey"], right_keys=["p_partkey"]),
        inputs=[lines, D("table_source",
                         ac.TableSourceNodeOptions(t["part"]))])
    return D.from_sequence([
        joined,
        D("project", ac.ProjectNodeOptions(
            [f("p_brand"), f("l_extendedprice") * f("l_discount"),
             f("l_tax"), f("l_quantity")],
            ["p_brand", "revenue", "l_tax", "l_quantity"])),
        D("aggregate", ac.AggregateNodeOptions(
            [("revenue", "hash_sum", None, "revenue"),
             ("l_tax", "hash_sum", None, "sum_tax"),
             ("l_quantity", "hash_count", None, "lines")],
            keys=["p_brand"])),
        D("order_by", ac.OrderByNodeOptions(
            [("revenue", "descending"), ("p_brand", "ascending")])),
        D("fetch", ac.FetchNodeOptions(0, 10)),
    ])


def typed_topk(t, ac=None):
    """All of the typed lineitem ordered by commit date (date64)
    descending, supplier (uint32 with nulls, last) and order key, the
    first ``TYPED_TOP_K``: the fused top-k on typed keys."""
    ac = _acero(ac)
    D = ac.Declaration
    return D.from_sequence([
        D("table_source", ac.TableSourceNodeOptions(t["lineitem"])),
        D("order_by", ac.OrderByNodeOptions(
            [("l_commitdate", "descending"), ("l_suppkey", "ascending"),
             ("l_orderkey", "ascending")], null_placement="at_end")),
        D("fetch", ac.FetchNodeOptions(0, TYPED_TOP_K)),
    ])


def typed_columns(t):
    """The typed tables' live values on the host, by column: numpy arrays
    of their stored values (unsigned ones viewed unsigned, a dictionary
    column's codes with its values under ``<name>:dict``), and
    ``<name>:valid`` for a column with nulls."""
    out = {}
    for table in t.values():
        n = int(table.row_count)
        for f, c in zip(table.schema.fields, table.columns):
            v = c.values[:n].cpu().numpy()
            if f.type.is_unsigned_integer:
                v = v.view(np.dtype(f"uint{8 * v.itemsize}"))
            out[f.name] = v
            if c.dictionary is not None:
                out[f.name + ":dict"] = c.dictionary
            if c.validity is not None:
                out[f.name + ":valid"] = c.validity[:n].cpu().numpy()
    return out


def _decimal(units, scale):
    import decimal
    return decimal.Decimal(int(units)).scaleb(-scale)


def _decimal_mean(total, count):
    """The reference's decimal mean: half away from zero, exactly."""
    mag = (2 * abs(int(total)) + count) // (2 * count)
    return -mag if total < 0 else mag


def typed_q1_oracle(c):
    """Sums by the two flags' codes with ``np.bincount``, the groups in
    the order of their values. Integer and decimal sums are whole numbers
    below 2**53 a group at SF10 (at most 1.05e8 a line for the discounted
    price), so their f64 bincounts are exact."""
    keep = c["l_shipdate"] <= SHIPDATE_1998_09_02_S
    rfd, lsd = c["l_returnflag:dict"], c["l_linestatus:dict"]
    key = (c["l_returnflag"][keep].astype(np.int64) * len(lsd)
           + c["l_linestatus"][keep])
    size = len(rfd) * len(lsd)
    price, disc = c["l_extendedprice"][keep], c["l_discount"][keep]
    count = np.bincount(key, minlength=size)

    def total(w):
        return np.bincount(key, weights=w.astype(np.float64),
                           minlength=size)

    qty, base = total(c["l_quantity"][keep]), total(price)
    disc_price, disc_sum = total(price * disc), total(disc)
    tax = total(c["l_tax"][keep])
    groups = sorted((rfd[k // len(lsd)], lsd[k % len(lsd)], k)
                    for k in np.nonzero(count)[0])
    n = [int(count[k]) for _, _, k in groups]
    return {
        "l_returnflag": [g[0] for g in groups],
        "l_linestatus": [g[1] for g in groups],
        "sum_qty": [int(qty[k]) for _, _, k in groups],
        "sum_base_price": [_decimal(base[k], 2) for _, _, k in groups],
        "sum_disc_price": [_decimal(disc_price[k], 4)
                           for _, _, k in groups],
        "avg_disc": [_decimal(_decimal_mean(int(disc_sum[k]), m), 2)
                     for (_, _, k), m in zip(groups, n)],
        "sum_tax": [float(tax[k]) for _, _, k in groups],
        "avg_qty": [float(qty[k]) / m for (_, _, k), m in zip(groups, n)],
        "count_order": n,
    }


def typed_join_oracle(c):
    """Each kept line's part by a search of the part keys; revenue (whole
    units of 10**-4, below 2**53 a brand, so f64 sums are exact), tax and
    lines by brand code."""
    keep = (c["l_linenumber"] <= 2) & (c["l_quantity"] < 25)
    pk = c["l_partkey"][keep].astype(np.int64)
    order = np.argsort(c["p_partkey"])
    pkeys = c["p_partkey"][order].astype(np.int64)
    pos = np.clip(np.searchsorted(pkeys, pk), 0, len(pkeys) - 1)
    hit = pkeys[pos] == pk
    brand = c["p_brand"][order][pos[hit]].astype(np.int64)
    names = c["p_brand:dict"]
    revenue = (c["l_extendedprice"][keep] * c["l_discount"][keep])[hit]
    tax = c["l_tax"][keep][hit].astype(np.float64)
    nb = len(names)
    rev = np.bincount(brand, weights=revenue.astype(np.float64),
                      minlength=nb)
    taxes = np.bincount(brand, weights=tax, minlength=nb)
    lines = np.bincount(brand, minlength=nb)
    rows = sorted((-int(rev[b]), names[b], float(taxes[b]), int(lines[b]))
                  for b in range(nb) if lines[b])[:10]
    return {"p_brand": [r[1] for r in rows],
            "revenue": [_decimal(-r[0], 4) for r in rows],
            "sum_tax": [r[2] for r in rows], "lines": [r[3] for r in rows]}


def typed_topk_oracle(c):
    """The first rows by commit date descending, supplier ascending with
    nulls last, order key ascending, as their keys: the rows at or after
    the ``TYPED_TOP_K``-th latest commit date, sorted."""
    date = c["l_commitdate"]
    kth = np.partition(date, len(date) - TYPED_TOP_K)[len(date) - TYPED_TOP_K]
    rows = np.nonzero(date >= kth)[0]
    valid = c["l_suppkey:valid"][rows]
    supp = np.where(valid, c["l_suppkey"][rows].astype(np.int64), 0)
    rows = rows[np.lexsort((c["l_orderkey"][rows], supp, ~valid,
                            -date[rows]))[:TYPED_TOP_K]]
    valid = c["l_suppkey:valid"][rows]
    return {"l_orderkey": c["l_orderkey"][rows].tolist(),
            "l_suppkey": [int(s) if ok else None
                          for s, ok in zip(c["l_suppkey"][rows], valid)],
            "l_commitdate_ms": date[rows].tolist()}


def check_typed_q1(c, result):
    check_typed("typed Q1", result, typed_q1_oracle(c))
    return (f"{len(result['count_order'])} groups, "
            f"{sum(result['count_order'])} lines as typed_q1_oracle")


def check_typed_join(c, result):
    check_typed("typed join", result, typed_join_oracle(c))
    return f"top brand {result['p_brand'][0]} at {result['revenue'][0]}"


def check_typed_topk(c, result):
    import datetime
    want = typed_topk_oracle(c)
    epoch = datetime.date(1970, 1, 1)
    got_ms = [(d - epoch).days * 86_400_000 for d in result["l_commitdate"]]
    if result["l_orderkey"] != want["l_orderkey"] or \
            result["l_suppkey"] != want["l_suppkey"] or \
            got_ms != want["l_commitdate_ms"]:
        raise AssertionError("typed top-k: rows differ from the oracle")
    return (f"{len(got_ms)} rows from {result['l_commitdate'][0]}, "
            f"{sum(s is None for s in result['l_suppkey'])} null suppliers")


def check_typed(name, result, want):
    """Keys, counts, integers and decimals exact; floats within
    ``RTOL_F64`` (the f32 taxes are summed in f64 in another order)."""
    if list(result) != list(want):
        raise AssertionError(f"{name}: columns {list(result)} != "
                             f"{list(want)}")
    for col, w in want.items():
        got = result[col]
        if w and isinstance(w[0], float):
            ok = len(got) == len(w) and np.allclose(
                np.asarray(got, dtype=np.float64), w, rtol=RTOL_F64, atol=0)
        else:
            ok = got == w and all(type(g) is type(x)
                                  for g, x in zip(got, w))
        if not ok:
            raise AssertionError(f"{name} {col}: {got} != {w}")


# Launches a run at SF10, predicted before the first run on the card.
# Typed Q1: its filter folds into the aggregate; the f32 tax sum and the
# int16 quantity mean add in f64 (2 grouped sums), the decimal sums, the
# decimal mean, the int16 sum and the count add in int64 (no kernel).
# Typed join: the lineitem filter compacts (1), the bloom over the uint32
# keys hashes both sides (2 hash32) and compacts the probe side (1), the
# unique-build join compacts its output (1); the tax sum by brand (26
# slots) is one grouped sum. The top-k: one sort, no kernel.
TYPED_PATHS = (
    NodePath("typed Q1", typed_q1, check_typed_q1, _launches(0, 0, 2)),
    NodePath("typed join", typed_join, check_typed_join,
             _launches(3, 2, 1)),
    NodePath("typed top-k", typed_topk, check_typed_topk,
             _launches(0, 0, 0)),
)


def phase_typed(tables):
    """The typed plans at SF10 over ``typed_tables`` of lineitem and
    part, each with every launch count set to 0 just before its run and
    read just after, against its numpy oracle over the typed values, with
    the card's peak memory over the run. Returns (launches by path, the
    typed tables)."""
    from arrow_tpu_torch.platform_check import self_check
    log(f"== phase 3f: typed plans at SF{SF:g}")
    t0 = time.perf_counter()
    typed = typed_tables(tables["lineitem"], tables["part"])
    torch.cuda.synchronize()
    log(f"typed lineitem and part made on the card in "
        f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{f.name} {f.type!r}" for f in typed["lineitem"].schema.fields))
    t0 = time.perf_counter()
    cols = typed_columns(typed)
    log(f"typed columns downloaded in {time.perf_counter() - t0:.1f} s")
    launches, failures = {}, []
    for path in TYPED_PATHS:
        plan = path.build(typed)
        base = memory_mark()
        zero_launches()
        self_check()
        t1 = time.perf_counter()
        result = plan.to_table()
        log(f"{path.name} first run {time.perf_counter() - t1:.3f} s")
        launches[path.name] = read_launches()
        log_peak(path.name, base)
        try:
            check_launches(path.name, launches[path.name], path.launches)
            t2 = time.perf_counter()
            msg = path.check(cols, result)
            log(f"{path.name} matches its oracle: {msg} (oracle "
                f"{time.perf_counter() - t2:.1f} s)")
            for i in range(min(len(next(iter(result.values()))), 4)):
                log("  " + " ".join(f"{k}={result[k][i]}" for k in result))
        except AssertionError as exc:
            log(f"  {path.name} FAILED: {exc}")
            failures.append(path.name)
        del plan, result
    if failures:
        raise AssertionError(f"phase 3f failed for {failures}")
    return launches, typed


def join_declaration(jt, probe, build, **kw):
    from arrow_tpu_torch.acero import (Declaration, HashJoinNodeOptions,
                                       TableSourceNodeOptions)
    inputs = [p if isinstance(p, Declaration) else
              Declaration("table_source", TableSourceNodeOptions(p))
              for p in (probe, build)]
    return Declaration("hashjoin", HashJoinNodeOptions(jt, **kw),
                       inputs=inputs)


def null_key_tables(n_probe, n_build, device, seed=7):
    """Probe and build batches with duplicate keys on both sides and 5%
    null keys, and their oracle sides. Keys lie in [0, 2 n_build), so a
    probe row matches about half a build row on average."""
    from arrow_tpu_torch.device.column import batch_from_numpy
    rng = np.random.default_rng(seed)
    sides = []
    for n, key, ident in ((n_probe, "pk", "pid"), (n_build, "bk", "bid")):
        keys = rng.integers(0, 2 * n_build, n)
        valid = rng.random(n) >= 0.05
        ids = np.arange(n, dtype=np.int64) + 1
        batch = batch_from_numpy([(key, "int64", keys, valid, None),
                                  (ident, "int64", ids, None, None)], n,
                                 device=device)
        sides.append((batch, JoinSide(keys, valid, ident, ids)))
    return sides


def host_tables():
    """Every TPC-H table but lineitem from the port's host generator at
    SF10, uploaded, by name."""
    from arrow_tpu_torch.io import tpch
    t0 = time.perf_counter()
    tables = {name: getattr(tpch, f"{name}_table")(SF) for name in (
        "orders", "customer", "part", "supplier", "partsupp")}
    tables["nation"] = tpch.nation_table()
    tables["region"] = tpch.region_table()
    sizes = ", ".join(f"{k} ({int(b.row_count)} rows)"
                      for k, b in tables.items())
    log(f"{sizes} generated on the host and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    return tables


def phase_join_types(orders, customer):
    """Every join type, each run with every launch count set to 0 just
    before, against ``join_oracle`` and its expected launches: orders
    probing customer filtered to one segment, then the null-key
    tables."""
    from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                       TableSourceNodeOptions, field)
    from arrow_tpu_torch.acero.exec import execute_declaration
    log("== phase 3b: the eight join types")
    cu = _host_columns(customer, ["c_custkey", "c_mktsegment"])
    building = cu["c_mktsegment"] == customer.column(
        "c_mktsegment").dictionary.index("BUILDING")
    od = _host_columns(orders, ["o_orderkey", "o_custkey"])
    tpch_sides = (
        JoinSide(od["o_custkey"], np.ones(len(od["o_custkey"]), bool),
                 "o_orderkey", od["o_orderkey"]),
        JoinSide(cu["c_custkey"][building], np.ones(building.sum(), bool),
                 "c_custkey", cu["c_custkey"][building]))
    filtered_customer = Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(customer)),
        Declaration("filter", FilterNodeOptions(
            field("c_mktsegment") == "BUILDING"))])
    (probe_b, probe_side), (build_b, build_side) = null_key_tables(
        *NULL_KEY_ROWS, "cuda")
    log(f"null-key tables: {(~probe_side.valid).sum()} of {NULL_KEY_ROWS[0]}"
        f" probe and {(~build_side.valid).sum()} of {NULL_KEY_ROWS[1]} build "
        "keys "
        "null; the oracle emits them from the outer and anti joins only")
    runs = [("orders x BUILDING customers", orders, filtered_customer,
             dict(left_keys=["o_custkey"], right_keys=["c_custkey"],
                  left_output=["o_orderkey"], right_output=["c_custkey"]),
             tpch_sides, JOIN_LAUNCHES_SF10),
            ("null keys", probe_b, build_b,
             dict(left_keys=["pk"], right_keys=["bk"],
                  left_output=["pid"], right_output=["bid"]),
             (probe_side, build_side), JOIN_LAUNCHES_NULLS)]
    for name, probe, build, kw, (ps, bs), want in runs:
        match = match_runs(ps, bs)
        for jt in JOIN_TYPES:
            decl = join_declaration(jt, probe, build, **kw)
            zero_launches()
            batch = execute_declaration(decl)
            got = read_launches()
            rows = check_join(jt, batch, ps, bs, match)
            compact_n, hash_n = want[jt]
            check_launches(f"{name} {jt}", got, {
                "compact": compact_n, "hash32": hash_n, "grouped_sum": 0,
                "probe": 0})
            log(f"  {name} {jt}: {rows} rows match the oracle")
            del batch


def check_result(name, result, want):
    if list(result) != list(want):
        raise AssertionError(f"{name}: columns {list(result)} != "
                             f"{list(want)}")
    for col, w in want.items():
        got = result[col]
        if isinstance(w, np.ndarray):
            g = np.asarray(got, dtype=np.float64)
            if g.shape != w.shape or not np.all(np.isfinite(g)) or \
                    not np.allclose(g, w, rtol=RTOL_F64, atol=0.0):
                raise AssertionError(f"{name} {col}: {got} != {w.tolist()}")
        elif got != w:
            raise AssertionError(f"{name} {col}: {got} != {w}")


def check_launches(name, launches, want):
    log(f"launches on the {name} path: {launches}")
    if launches != want:
        raise AssertionError(f"{name}: expected launches {want}, got "
                             f"{launches}")


def memory_mark():
    """Resets the card's peak memory; returns the memory allocated now."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def log_peak(name, base):
    peak = torch.cuda.max_memory_allocated()
    log(f"{name} peak memory {peak / 2**30:.2f} GiB, "
        f"{(peak - base) / 2**30:.2f} GiB above the tables")


def phase_main_paths(orders, customer):
    """Q1, Q3, Q4 and Q13, each with every launch count set to 0 just
    before and read just after, against numpy oracles. Returns the
    launches by path."""
    from arrow_tpu_torch.acero import compile_chain
    from arrow_tpu_torch.device.column import download
    from arrow_tpu_torch.io.tpch_device import (q1_device_batch,
                                                q3_device_plan)
    from arrow_tpu_torch.io.tpch_queries import (q1_chain_decls, q4_plan,
                                                 q13_plan)
    from arrow_tpu_torch.platform_check import self_check
    log(f"== phase 3: the main paths, Q1, Q3, Q4 and Q13 at SF{SF:g}")
    launches = {}
    zero_launches()
    self_check()
    batch, n = q1_device_batch(SF)
    base = memory_mark()
    q1 = compile_chain(q1_chain_decls())
    result = download(q1(batch))
    launches["Q1"] = read_launches()
    log_peak("Q1", base)
    check_launches("Q1", launches["Q1"], Q1_LAUNCHES)
    check_result("Q1", result, q1_oracle(batch, n))
    log(f"Q1 result ({len(result['count_order'])} groups) matches the numpy "
        f"oracle: keys and counts exact, floats within rtol {RTOL_F64}")
    for i in range(len(result["count_order"])):
        log("  " + " ".join(f"{k}={result[k][i]}" for k in result))
    del batch, q1

    zero_launches()
    self_check()
    plan, n_li = q3_device_plan(SF)
    base = memory_mark()
    result = plan.to_table()
    launches["Q3"] = read_launches()
    log_peak("Q3", base)
    check_launches("Q3", launches["Q3"], Q3_LAUNCHES)
    want, n_groups, n_lines = q3_oracle(plan)
    check_result("Q3", result, want)
    log(f"Q3 result matches the numpy oracle ({n_lines} joined lineitem "
        f"rows in {n_groups} groups): keys and row order exact, revenue "
        f"within rtol {RTOL_F64}")
    for i in range(len(result["l_orderkey"])):
        log("  " + " ".join(f"{k}={result[k][i]}" for k in result))
    del plan

    zero_launches()
    self_check()
    lineitem, n_li = q1_device_batch(SF)
    base = memory_mark()
    result = q4_plan(orders, lineitem).to_table()
    launches["Q4"] = read_launches()
    log_peak("Q4", base)
    check_launches("Q4", launches["Q4"], Q4_LAUNCHES)
    want, n_orders = q4_oracle(orders, lineitem)
    check_result("Q4", result, want)
    log(f"Q4 result matches the numpy oracle ({n_orders} orders with a late "
        f"lineitem, {n_li} lineitem rows): keys, counts and order exact")
    for i in range(len(result["order_count"])):
        log("  " + " ".join(f"{k}={result[k][i]}" for k in result))
    del lineitem

    zero_launches()
    self_check()
    base = memory_mark()
    result = q13_plan(customer, orders).to_table()
    launches["Q13"] = read_launches()
    log_peak("Q13", base)
    check_launches("Q13", launches["Q13"], Q13_LAUNCHES)
    want, n_kept = q13_oracle(customer, orders)
    check_result("Q13", result, want)
    log(f"Q13 result matches the numpy oracle ({n_kept} orders kept, "
        f"{len(result['c_count'])} order counts): keys, counts and order "
        "exact")
    log("  c_count " + " ".join(map(str, result["c_count"])))
    log("  custdist " + " ".join(map(str, result["custdist"])))
    return launches


def phase_suite(tables):
    """The JAX package's TPC-H suite beyond Q1 and Q3, plus Q14 and Q19,
    each with every launch count set to 0 just before and read just
    after, against its numpy oracle. Every query runs before a failure is
    raised. Returns the launches by path."""
    log(f"== phase 3c: the JAX package's TPC-H suite at SF{SF:g}")
    t0 = time.perf_counter()
    cols = _suite_columns(tables)
    log(f"source columns downloaded for the oracles in "
        f"{time.perf_counter() - t0:.1f} s")
    return _run_queries("3c", SUITE, tables, cols)


def phase_full(tables):
    """The last eleven of the reference's 22 plans, as phase 3c runs its
    queries. Returns the launches by path, each plan's parameters and the
    oracles' source columns."""
    log(f"== phase 3d: the last eleven TPC-H plans at SF{SF:g}")
    t0 = time.perf_counter()
    cols = _full_columns(tables)
    log(f"source columns downloaded for the oracles in "
        f"{time.perf_counter() - t0:.1f} s")
    params = {}
    for q in FULL:
        t1 = time.perf_counter()
        params[q.name] = q.params(tables, cols) if q.params else {}
        if q.params:
            log(f"{q.name} parameters {params[q.name]} "
                f"({time.perf_counter() - t1:.1f} s)")
    return _run_queries("3d", FULL, tables, cols, params), params, cols


def _run_queries(phase, queries, tables, cols, params=None):
    """Each query with every launch count set to 0 just before its run
    and read just after, then against its oracle and its launches; every
    query runs before a failure is raised."""
    from arrow_tpu_torch.platform_check import self_check
    launches, failures = {}, []
    for q in queries:
        kw = (params or {}).get(q.name, {})
        plan = suite_plan(q, tables, kw)
        base = memory_mark()
        zero_launches()
        self_check()
        t1 = time.perf_counter()
        result = plan.to_table()
        log(f"{q.name} first run {time.perf_counter() - t1:.3f} s")
        launches[q.name] = read_launches()
        log_peak(q.name, base)
        t1 = time.perf_counter()
        want, n_rows = q.oracle(tables, cols, **kw)
        log(f"{q.name} oracle: {time.perf_counter() - t1:.1f} s")
        try:
            check_launches(q.name, launches[q.name], q.launches)
            check_result(q.name, result, want)
        except AssertionError as exc:
            log(f"  {q.name} FAILED: {exc}")
            failures.append(q.name)
            continue
        log(f"{q.name} result matches the numpy oracle ({n_rows} rows kept "
            f"by the oracle, {len(next(iter(result.values())))} result rows): "
            f"keys, counts and order exact, floats within rtol {RTOL_F64}")
        for i in range(min(len(next(iter(result.values()))), 6)):
            log("  " + " ".join(f"{k}={result[k][i]}" for k in result))
        del plan, result
    if failures:
        raise AssertionError(f"phase {phase} failed for {failures}")
    return launches


def best_wall(run, reps=6):
    """Host-clock seconds of ``run`` (which ends in a download) after a
    synchronize, every run; the first is the warm-up."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, min(walls[1:])


def profile_run(name, run):
    """Device time of one run by kernel, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    log(f"{name} profile taken and read in "
        f"{time.perf_counter() - t_start:.1f} s")
    # kernels only: an operator's device time repeats its kernels'
    rows = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    if not rows:
        log(f"{name} profile: the profiler saw no device time (not "
            "measured)")
        return
    log(f"{name} profile: device busy {device_us:.1f} us of {wall_us:.1f} "
        f"us wall (idle share {1 - device_us / wall_us:.3f}; profiler on)")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:14]:
        log(f"  {us:12.1f} us  x{count:<4d} {key[:110]}")
    # the host operators that launched that device time (self time: each
    # kernel counts once, under the operator that launched it)
    ops = [(e.key, e.self_device_time_total, e.count) for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    log(f"{name} device time by launching operator:")
    for key, us, count in sorted(ops, key=lambda r: -r[1])[:14]:
        log(f"  {us:12.1f} us  x{count:<4d} {key[:60]}")


def bound(nbytes, ops, ops_per_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, reps: int = 20):
    """Mean device time per call of ``fn``: the time of the kernels,
    memsets and copies the profiler saw over ``reps`` calls after a
    warm-up, or None where it saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def _ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def record(card, name, shape, kernel, plain, library, nbytes, ops, ops_per_s,
           reps=20):
    """A kernel's record: its time (CUDA events and profiler device time)
    beside its bound, its plain version's and the library call's."""
    b_ms, b_by = bound(nbytes, ops, ops_per_s)
    out = {"ms": cuda_ms(kernel, reps), "plain_ms": cuda_ms(plain, reps),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": cuda_ms(library, reps) if library else None,
           # device time a call from the profiler, beside the events
           "device_ms": device_ms(kernel, reps),
           "library_device_ms": device_ms(library, reps) if library
           else None}
    lib = "none" if library is None else (
        f"{out['library_ms']:.4f} ms (device "
        f"{_ms(out['library_device_ms'])})")
    log(f"  {name} ({shape}): kernel {out['ms']:.4f} ms (device "
        f"{_ms(out['device_ms'])}), bound {b_ms:.4f} ms ({b_by}), "
        f"plain {out['plain_ms']:.4f} ms, library {lib}, "
        f"{nbytes / out['ms'] / 1e6:.1f} GB/s [{card}]")
    return out


def device_split(fn, reps: int = 20):
    """Device ms a call of ``fn`` by kernel name (memsets and copies
    included), from the profiler over ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / reps / 1e3, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def compact_bytes(keep, cols):
    """The bytes ``compact(keep, cols)`` must move on this input: the mask
    read once, each column's 32-byte sectors that hold a kept row read
    once (a sector is the least the card reads; an unkept value in a
    sector of no kept row need not be read), every output row written once
    (the zero tail included) and the count."""
    n = keep.numel()
    rows = torch.nonzero(keep).flatten()
    nbytes = n + 4
    for c in cols:
        w = c.element_size()
        sector = (c.data_ptr() + rows * w) // 32
        # rows ascend, so a sector's kept rows are adjacent
        nbytes += 32 * int((sector[1:] != sector[:-1]).sum()
                           + min(1, sector.numel())) + n * w
    return nbytes


def compact_times(card, q3_lineitem, lineitem):
    """``compact``'s record at five shapes: Q3's lineitem filter (four
    columns, 28 bytes a row), its mask over an int16 and an f16 column (4
    bytes), Q4's lineitem filter over all 15 columns of
    ``q1_device_batch(10.0)``, Q3's mask over one bool column and Q18's
    HAVING filter (sparse), each with the profiler's device time split by
    kernel name."""
    from arrow_tpu_torch.kernels.compact import compact, compact_plain
    shapes = (("q3", "Q3 lineitem filter", q3_filter_inputs(q3_lineitem)),
              ("width_2", "Q3 lineitem filter, int16 and f16",
               width2_inputs(q3_lineitem)),
              ("q4", "Q4 lineitem filter, all columns",
               (q4_lineitem_keep(lineitem),
                [c.values for c in lineitem.columns])),
              ("bool", "Q3 lineitem filter, one bool column",
               bool_column_inputs(q3_lineitem)),
              ("q18", "Q18 HAVING filter, 1 in 10^4 kept",
               q18_having_inputs(q3_lineitem.capacity)))
    recs = {}
    for key, name, (keep, cols) in shapes:
        m = keep.numel()
        width = sum(c.element_size() for c in cols)
        nbytes = compact_bytes(keep, cols)
        recs[key] = rec = record(
            card, f"compact ({name})", f"n={m}, {len(cols)} columns of "
            f"{width} bytes a row, {int(keep.sum())} kept",
            lambda: compact(keep, cols), lambda: compact_plain(keep, cols),
            lambda: [c[keep] for c in cols], nbytes, 0,
            INT32_OPS_PER_S)
        rec["row_bytes"] = width
        rec["bound_bytes"] = nbytes
        rec["split"] = split = device_split(lambda: compact(keep, cols))
        log("    device ms a call by kernel: " + "; ".join(
            f"{k[:60]} {ms:.4f} (x{c:g})" for k, ms, c in split))
    return recs


def phase_times(card, launches, errs, tables, typed, params):
    from arrow_tpu_torch.acero import compile_chain
    from arrow_tpu_torch.compute.hashing import int64_halves
    from arrow_tpu_torch.compute.keys import equality_word
    from arrow_tpu_torch.compute.move import segment_sum
    from arrow_tpu_torch.device.column import download
    from arrow_tpu_torch.io.tpch_device import q3_device_plan
    from arrow_tpu_torch.io.tpch_queries import (q1_chain_decls, q4_plan,
                                                 q13_plan)
    from arrow_tpu_torch.kernels.grouped_sum import (grouped_sum,
                                                     grouped_sum_plain)
    from arrow_tpu_torch.kernels.hash32 import hash32, hash32_plain
    from arrow_tpu_torch.kernels.probe import probe, probe_plain
    log(f"== phase 4: times on {card}")
    batch = tables["lineitem"]
    n = int(batch.row_count)
    q1 = compile_chain(q1_chain_decls())
    walls, best = best_wall(lambda: download(q1(batch)))
    log(f"Q1 SF{SF:g}: {n} rows, wall {[round(w * 1e3, 3) for w in walls]}"
        f" ms; best {best * 1e3:.3f} ms = {n / best:.6g} rows/s [{card}]")
    profile_run("Q1", lambda: download(q1(batch)))
    n_cap = batch.capacity
    del batch, q1

    plan, n_li = q3_device_plan(SF)
    walls, best = best_wall(plan.to_table)
    log(f"Q3 SF{SF:g}: {n_li} lineitem rows, wall "
        f"{[round(w * 1e3, 3) for w in walls]} ms; best {best * 1e3:.3f} ms"
        f" = {n_li / best:.6g} rows/s [{card}]")
    profile_run("Q3", plan.to_table)

    # Q4's lineitem is Q1's device batch, as for the suite: it holds
    # l_orderkey, l_commitdate and l_receiptdate at the reference's ranges
    orders, lineitem = tables["orders"], tables["lineitem"]
    n_li = int(lineitem.row_count)
    q4 = q4_plan(orders, lineitem)
    walls, best = best_wall(q4.to_table)
    log(f"Q4 SF{SF:g}: {n_li} lineitem rows, wall "
        f"{[round(w * 1e3, 3) for w in walls]} ms; best {best * 1e3:.3f} ms"
        f" = {n_li / best:.6g} lineitem rows/s [{card}]")
    profile_run("Q4", q4.to_table)
    del q4

    q13 = q13_plan(tables["customer"], orders)
    n_ord = int(orders.row_count)
    walls, best = best_wall(q13.to_table)
    log(f"Q13 SF{SF:g}: {n_ord} orders rows, wall "
        f"{[round(w * 1e3, 3) for w in walls]} ms; best {best * 1e3:.3f} ms"
        f" = {n_ord / best:.6g} orders rows/s [{card}]")
    profile_run("Q13", q13.to_table)
    del q13

    # the suite and the last eleven plans, each by its largest input
    for q in SUITE + FULL:
        run = suite_plan(q, tables, params.get(q.name)).to_table
        big = max(q.tables, key=lambda k: int(tables[k].row_count))
        n_big = int(tables[big].row_count)
        walls, best = best_wall(run)
        log(f"{q.name} SF{SF:g}: {n_big} {big} rows, wall "
            f"{[round(w * 1e3, 3) for w in walls]} ms; best "
            f"{best * 1e3:.3f} ms = {n_big / best:.6g} {big} rows/s "
            f"[{card}]")
        profile_run(q.name, run)
    # phase 3e's and phase 3f's paths
    paths = [(p, node_path_run(p, p.build(tables))) for p in NODE_PATHS] + \
        [(p, p.build(typed).to_table) for p in TYPED_PATHS]
    for path, run in paths:
        walls, best = best_wall(run)
        log(f"{path.name} SF{SF:g}: wall "
            f"{[round(w * 1e3, 3) for w in walls]} ms; best "
            f"{best * 1e3:.3f} ms [{card}]")
        profile_run(path.name, run)
    del paths, run

    def grouped_sum_record(name, values, gids, s):
        acc = torch.zeros(s, dtype=values.dtype, device="cuda")
        n_rows = values.numel()
        # one f64 addition a row, f32 input included
        return record(
            card, name, f"n={n_rows} S={s}",
            lambda: grouped_sum(values, gids, s),
            lambda: grouped_sum_plain(values, gids, s),
            lambda: acc.index_add_(0, gids, values),
            n_rows * (values.element_size() + 4) + s * values.element_size(),
            n_rows, F64_OPS_PER_S)

    v, g = q1_like_inputs(n_cap, Q1_SLOTS, 6, torch.float64, 1)
    q1_shape = grouped_sum_record("grouped_sum f64 (Q1 shape)", v, g,
                                  Q1_SLOTS)
    for s in (512, 1024):
        v, g = q1_like_inputs(n_cap, s, s, torch.float64, 2)
        grouped_sum_record("grouped_sum f64 (K3 range)", v, g, s)
    v, g = q1_like_inputs(n_cap, 16, 16, torch.float32, 3)
    grouped_sum_record("grouped_sum f32", v, g, 16)
    # the general path's float sum (no kernel of the port: a stable sort
    # and torch.segment_reduce) beside the index_add_ it replaced
    v, g, live, nseg = general_sum_inputs(tables["lineitem"])
    _, skew = q1_like_inputs(v.numel(), 4, 4, torch.float64, 9)
    for shape, gids, mask in (("Q15 shape", g, live),
                              ("4 groups, all rows live", skew.long(),
                               torch.ones_like(live))):
        acc = torch.zeros(nseg, dtype=torch.float64, device="cuda")
        fixed, atomic = (lambda: segment_sum(v, gids, nseg, mask),
                         lambda: acc.index_add_(0, gids, v))
        log(f"  general float sum ({shape}, n={v.numel()} S={nseg}): "
            f"sorted segment sum {cuda_ms(fixed, 5):.4f} ms (device "
            f"{_ms(device_ms(fixed, 5))}), index_add_ "
            f"{cuda_ms(atomic, 5):.4f} ms (device "
            f"{_ms(device_ms(atomic, 5))}) [{card}]")
    del v, g, live, skew, gids, mask, acc, fixed, atomic

    lineitem, _, _ = q3_sources(plan)
    compact_recs = compact_times(card, lineitem, tables["lineitem"])
    m = int(lineitem.capacity)
    words = int64_halves(equality_word(lineitem.column("l_orderkey")))
    k = len(words)
    hash_rec = record(
        card, "hash32 (Q3 lineitem probe keys)", f"n={m}, k={k} words",
        lambda: hash32(words), lambda: hash32_plain(words), None,
        m * (4 * k + 4),
        m * (k * HASH_OPS_PER_WORD + (k - 1) * HASH_OPS_PER_COMBINE),
        INT32_OPS_PER_S)
    del words, lineitem, plan

    # 200 back-to-back calls: the events read the host's launch rate, the
    # profiler the kernel's own time
    x = torch.randn(8, 128, device="cuda")
    probe_rec = record(card, "probe", "(8,128) f32", lambda: probe(x),
                       lambda: probe_plain(x), lambda: torch.mul(x, 2.0),
                       2 * x.numel() * 4, x.numel(), F32_OPS_PER_S,
                       reps=200)

    def by_path(name):
        return {path: n[name] for path, n in launches.items()}

    return {"kernels": [
        {"name": "grouped_sum", "route": "cuda",
         "source": "arrow_tpu_torch/csrc/grouped_sum.cu",
         "replaces": "arrow_tpu/experimental/pallas_agg.py:234",
         "launches": by_path("grouped_sum"),
         "max_abs_err": errs["grouped_sum"], **q1_shape},
        {"name": "probe", "route": "cuda",
         "source": "arrow_tpu_torch/csrc/probe.cu",
         "replaces": "arrow_tpu/platform_check.py:119",
         "launches": by_path("probe"), "max_abs_err": errs["probe"],
         # the floor of one launch: torch.mul's device time on the tile
         "launch_floor_ms": probe_rec["library_device_ms"], **probe_rec},
        {"name": "compact", "route": "cuda",
         "source": "arrow_tpu_torch/csrc/compact.cu",
         "replaces": "arrow_tpu/compute/pallas_move.py:189",
         "launches": by_path("compact"), "max_abs_err": errs["compact"],
         "bit_exact": True, **compact_recs["q3"],
         # the same mask over an int16 and an f16 column, Q4's filter
         # over all of lineitem's 15 columns, Q3's mask over one bool
         # column and Q18's sparse HAVING filter
         "width_2": compact_recs["width_2"], "q4": compact_recs["q4"],
         "bool": compact_recs["bool"], "q18": compact_recs["q18"]},
        {"name": "hash32", "route": "cuda",
         "source": "arrow_tpu_torch/csrc/hash32.cu",
         "replaces": "arrow_tpu/experimental/pallas_hash.py:43",
         "launches": by_path("hash32"), "max_abs_err": errs["hash32"],
         "bit_exact": True, **hash_rec},
    ]}


def phase_compact_only(card):
    """``--compact``: phase 2's compactions and their times alone, for a
    quick comparison of two trees of the kernel in one call."""
    from arrow_tpu_torch.device.column import round_up
    from arrow_tpu_torch.io.tpch_device import q1_device_batch, q3_device_plan
    q3_lineitem = q3_sources(q3_device_plan(SF)[0])[0]
    phase_compact(round_up(int(6_001_215 * SF)), q3_lineitem, None)
    lineitem, _ = q1_device_batch(SF)
    log(f"== compact times on {card}")
    return {"compact": compact_times(card, q3_lineitem, lineitem)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--compact", action="store_true",
                        help="phase 1, phase 2's compactions and their "
                        "times alone (no final line)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import arrow_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    try:
        t0 = time.perf_counter()
        card = timed(phase_probe)
        if args.compact:
            print(card)
            print(json.dumps(timed(phase_compact_only, card)))
            return 0
        from arrow_tpu_torch.device.column import round_up
        from arrow_tpu_torch.io.tpch_device import q1_device_batch
        tables = timed(host_tables)
        orders, customer = tables["orders"], tables["customer"]
        errs = timed(phase_kernels, round_up(int(6_001_215 * SF)), orders)
        launches = timed(phase_main_paths, orders, customer)
        # the suite's lineitem: Q1's device batch, all 15 columns at the
        # reference generator's ranges, as Q4 uses it
        tables["lineitem"], _ = q1_device_batch(SF)
        launches.update(timed(phase_suite, tables))
        full_launches, params, cols = timed(phase_full, tables)
        launches.update(full_launches)
        launches.update(timed(phase_plan_nodes, tables, cols))
        del cols
        typed_launches, typed = timed(phase_typed, tables)
        launches.update(typed_launches)
        timed(phase_join_types, orders, customer)
        kernel_line = timed(phase_times, card, launches, errs, tables,
                            typed, params)
        log(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        return 1
    print(card)
    print(json.dumps(kernel_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
