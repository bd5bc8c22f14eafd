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
   Then (3g) the vector functions and the statistics aggregates
   (``STATS_PATHS``) over Q1's lineitem and the typed lineitem: a
   three-key sort with nulls (``BASELINE.json`` config 3), the takes by
   it, its inverse, a top 1,000 and ranks under all four tiebreakers;
   running sums, extremes and means and pairwise differences; unique,
   value_counts, dictionary_encode and count_distinct; filter under a
   nullable mask both ways, drop_null and take with null indices (an index
   out of range must raise IndexError); statistics by Q1's flags and per
   order (15M groups); moments, quantiles and the rest with ``keys=[]``.
   Each against a numpy oracle (run in a thread each while the next path
   runs), with its launches exact; the compaction and the grouped sum
   against their plain versions at the shapes these paths give them; the
   float results run twice, bit for bit.
   Then (3h) the temporal and string functions (``STRING_PATHS``):
   temporal_fields, every temporal name with every option over six
   columns (lineitem's date32 ship date, the typed timestamp[s] and
   date64, and a timestamp[ns] with nulls, a time64[us] and a
   duration[ms] made on the card), each result held on the card against
   numpy's datetime64 units and Python's ``datetime`` over the distinct
   inputs; temporal_plan, a calendar filter and projection of lineitem;
   strings_pool, every str -> str name on ``p_name`` (2M values, the byte
   pool) and on ``p_type`` (the host tier) and every predicate and length
   on ``p_name``, ``p_type`` and ``c_comment`` against Python's ``str``
   and ``re``, and p_brand, p_container and a separator joined;
   strings_plan, lineitem joined to part, a regex filter, revenue by two
   keys made of string functions (7 and 201 slots: K1 and K3), against
   numpy and run twice for the same bits; the pool and host tiers of two
   of p_name's transforms, the same dictionary and codes; Q22 again, its
   slice of ``c_phone`` on the byte pool. Launches exact; the compaction,
   the hash and the grouped sum against their plain versions at these
   paths' shapes.
   Then (3i) the rest of compute (``REST_PATHS``): hash_types, the
   registered ``hash32`` of the typed lineitem's 12 columns and of an f64
   column with NaN, -0.0 and nulls, bit for bit against numpy's xxhash32
   from the reference's constants, null rows included; vector_misc, the
   null fills of l_suppkey, ``run_end_encode`` of l_orderkey in order
   (15M runs) and of l_returnflag, ``replace_with_mask``, ``index_in``
   and the ``*_meta_binary`` aliases; math_stats, ``hypot``,
   ``round_binary``, ``indices_nonzero``, ``winsorize``, the two ranks
   and ``tdigest`` over 60M rows; grouped_flags and grouped_k3, skew,
   kurtosis, median, quantile and first/last by Q1's flags (12 slots)
   and by a 160-slot key; orders_median per order (15M groups); and
   customer_plan, a cast of the phone's country code as a group key,
   ``is_null``/``is_valid``/``is_nan``/``index_in`` of a nullable
   segment, ``coalesce`` and ``if_else`` over two dictionaries and a
   filter on a column with an empty dictionary. Each against a numpy
   oracle in a thread, launches exact, the kernels against their plain
   versions at these shapes, the grouped moments bit for bit over two
   runs.
   Then (3b) all eight join types, each run against a numpy oracle of
   the join (row count, row order, values and validity exact) with its
   launches exact: orders probing customer filtered to one segment at
   SF10, where the bloom engages for inner, left semi, right semi and
   right outer joins, and 1,000,000 probe rows against 200,000 build
   rows with duplicate keys on both sides and 5% null keys.
4. Times after a warm-up: Q1, Q3, Q4, Q13, the suite's and the last
   eleven plans' rows/s of their largest input and phase 3e's, 3f's, 3g's,
   3i's and 3h's walls (best of 5; one run for 3h's two sweeps, which phase
   3h ran), a profile of one run of each (device busy time and idle
   share), each kernel's time beside its bound, its plain version's and
   one library call's where there is one (the compaction at five
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
import concurrent.futures
import datetime
import functools
import json
import re
import sys
import time
import traceback
import unicodedata
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


# --- phase 3g: the vector functions and the statistics aggregates ------------

SHIPDATE_1998_09_02 = 10_471        # 1998-09-02 in days (Q1's filter)
STATS_SEED = 11
STATS_K = 1_000                     # select_k_unstable's k
STATS_NULL_MASK = 0.05              # the share of the filter mask's nulls
STATS_NULL_INDICES = 0.01           # the share of take's null indices
INDEX_SUPPLIER = 4_242              # the supplier ``index`` looks for
TIEBREAKERS = ("first", "min", "max", "dense")
INTERPOLATIONS = ("linear", "lower", "higher", "nearest", "midpoint")
QUANTILES = [0.01, 0.5, 0.99]
TAKE_COLUMNS = ("l_orderkey", "l_suppkey", "l_shipdate", "l_extendedprice",
                "l_quantity")
SORT_KEYS = [("l_suppkey", "ascending"), ("l_shipdate", "descending"),
             ("l_extendedprice", "ascending")]
TOPK_KEYS = [("l_extendedprice", "descending"), ("l_orderkey", "ascending")]


def _call(ctx, fn, *args, **kw):
    from arrow_tpu_torch.compute.registry import get_function
    return get_function(fn).impl(ctx, *args, **kw)


def _context(batch):
    return _rows_context(batch.capacity, batch.row_count)


def _rows_context(capacity, count):
    from arrow_tpu_torch.compute.registry import ExecContext
    return ExecContext(capacity, count)


def stats_inputs(lineitem, typed, seed=STATS_SEED):
    """Phase 3g's inputs: Q1's lineitem, the typed lineitem of phase 3f,
    a nullable filter mask (``l_quantity > 45`` under
    ``STATS_NULL_MASK`` nulls), take indices over the live rows with
    ``STATS_NULL_INDICES`` nulls, and indices with one out of range; the
    random draws from a generator seeded with ``seed`` on the tables'
    device."""
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.device.column import DeviceColumn
    t = typed["lineitem"]
    dev = t.row_count.device
    n, cap = int(t.row_count), t.capacity
    gen = torch.Generator(device=dev).manual_seed(seed)
    big = _call(_context(t), "greater", t.column("l_quantity"), 45)
    mask = DeviceColumn(big.values, torch.rand(cap, generator=gen,
                                               device=dev)
                        >= STATS_NULL_MASK, big.type)
    idx = torch.randint(0, n, (cap,), generator=gen, device=dev)
    ivalid = torch.rand(cap, generator=gen, device=dev) >= STATS_NULL_INDICES
    bad = idx.clone()
    bad[n // 3] = cap + 5
    return {"lineitem": lineitem, "typed": t, "mask": mask,
            "idx": DeviceColumn(idx, ivalid, T.int64()),
            "bad_idx": DeviceColumn(bad, None, T.int64())}


def stats_columns(s):
    """The host copies phase 3g's oracles read: the typed lineitem's
    columns (``typed_columns``), Q1's lineitem's (``plain``; l_orderkey at
    its whole capacity, padding rows included, for pairwise_diff), the
    mask and the take indices."""
    li = s["lineitem"]
    n = int(li.row_count)
    c = typed_columns({"lineitem": s["typed"]})
    c["n"] = n
    c["plain"] = {k: li.column(k).values[:n].cpu().numpy() for k in (
        "l_extendedprice", "l_discount", "l_shipdate", "l_linenumber")}
    c["plain"]["l_orderkey"] = li.column("l_orderkey").values.cpu().numpy()
    for name in ("mask", "idx"):
        c[name] = s[name].values[:n].cpu().numpy()
        c[name + ":valid"] = s[name].validity[:n].cpu().numpy()
    return c


def _host(col, n):
    """(values, validity or None) of a result column's first n rows."""
    v = col.values[:n].cpu().numpy()
    if col.type.is_unsigned_integer:
        v = v.view(np.dtype(f"uint{8 * v.itemsize}"))
    return v, None if col.validity is None else \
        col.validity[:n].cpu().numpy()


def _expect(name, ok, detail=""):
    if not ok:
        raise AssertionError(f"{name} differs from its oracle {detail}")


def _expect_equal(name, got, want):
    _expect(name, got.shape == want.shape and np.array_equal(got, want),
            f"(first rows {got[:5]} against {want[:5]})")


def _expect_close(name, got, want, rtol=RTOL_F64):
    """Within ``rtol`` of ``want``, NaN where it is NaN."""
    ok = got.shape == want.shape
    if ok:
        with np.errstate(invalid="ignore"):
            ok = bool(((np.abs(got - want) <= rtol * np.abs(want))
                       | (np.isnan(got) & np.isnan(want))).all())
    _expect(name, ok, f"(first rows {got[:5]} against {want[:5]})")


# sort_take: BASELINE config 3's multi-key sort with nulls, then the rows
def sort_take_run(s):
    t = s["typed"]
    li, ctx = t.column, _context(t)
    perm = _call(ctx, "sort_indices", *[li(k) for k, _ in SORT_KEYS],
                 sort_keys=SORT_KEYS, null_placement="at_start")
    pctx = _rows_context(perm.column.capacity, perm.count)
    taken = {k: _call(pctx, "take", li(k), perm.column).column
             for k in TAKE_COLUMNS}
    inv = _call(pctx, "inverse_permutation", perm.column)
    back = _call(pctx, "take", perm.column, inv.column)
    topk = _call(ctx, "select_k_unstable", *[li(k) for k, _ in TOPK_KEYS],
                 k=STATS_K, sort_keys=TOPK_KEYS)
    ranks = {tb: _call(ctx, "rank", li("l_quantity"), tiebreaker=tb)
             for tb in TIEBREAKERS}
    part = _call(ctx, "partition_nth_indices", li("l_quantity"),
                 pivot=int(t.row_count) // 2)
    return {"perm": perm, "taken": taken, "back": back, "topk": topk,
            "ranks": ranks, "part": part}


def sort_word(c):
    """One int64 word a row whose order is SORT_KEYS' order: the supplier
    (nulls first, as 0), the ship day descending, the price in cents."""
    valid = c["l_suppkey:valid"]
    k1 = np.where(valid, c["l_suppkey"].astype(np.int64) + 1, 0)
    day = c["l_shipdate"] // 86_400
    k2 = day.max() + 1 - day
    k3 = c["l_extendedprice"]
    if k1.max() >= 1 << 17 or k2.max() >= 1 << 12 or k3.min() < 0 or \
            k3.max() >= 1 << 24:
        raise AssertionError("sort_take: keys out of the word's fields")
    return (k1 << 36) | (k2 << 24) | k3


def rank_oracle(q):
    """The four ranks of ``q`` (small non-negative integers, ascending)
    and its stable argsort: ``first`` is the inverse of that argsort; a
    tie's ``min``, ``max`` and ``dense`` ranks are tables by value, from
    the counts of the values below it (``np.bincount``)."""
    n = len(q)
    order = np.argsort(q, kind="stable")
    first = np.empty(n, dtype=np.int64)
    first[order] = np.arange(1, n + 1)
    counts = np.bincount(q)
    below = np.cumsum(counts) - counts
    dense = np.cumsum(counts > 0)
    return {"first": first, "min": (below + 1)[q], "max": (below + counts)[q],
            "dense": dense[q]}, order


def check_sort_take(c, r):
    """The permutation: each live row once, its words non-decreasing and,
    among equal words, its rows ascending: that is the one stable sort by
    SORT_KEYS, checked in one pass. The taken columns are the rows it
    names, the inverse gives the row order back, the top k is
    ``np.lexsort``'s over the rows at or above the k-th largest price,
    and the ranks and the partition are ``rank_oracle``'s."""
    n = c["n"]
    perm_col = r["perm"]
    _expect("sort_indices count", int(perm_col.count) == n)
    perm, _ = _host(perm_col.column, n)
    perm = perm.astype(np.int64)
    _expect("sort_indices is a permutation", perm.min() >= 0 and
            perm.max() < n and np.bincount(perm, minlength=n).max() == 1)
    w = sort_word(c)[perm]
    ties = w[1:] == w[:-1]
    _expect("sort_indices order", bool((w[1:] >= w[:-1]).all()) and
            bool((perm[1:][ties] > perm[:-1][ties]).all()))
    for k in TAKE_COLUMNS:
        v, valid = _host(r["taken"][k], n)
        _expect_equal(f"take {k}", v, c[k][perm])
        if k == "l_suppkey":
            _expect_equal("take l_suppkey validity", valid,
                          c["l_suppkey:valid"][perm])
    back, back_valid = _host(r["back"].column, n)
    _expect_equal("inverse_permutation", back.astype(np.int64),
                  np.arange(n, dtype=np.int64))
    _expect("inverse_permutation validity",
            back_valid is None or bool(back_valid.all()))
    price, okey = c["l_extendedprice"], c["l_orderkey"]
    kth = np.partition(price, n - STATS_K)[n - STATS_K]
    cand = np.flatnonzero(price >= kth)
    want = cand[np.lexsort((okey[cand], -price[cand]))][:STATS_K]
    topk, _ = _host(r["topk"].column, STATS_K)
    _expect("select_k count", int(r["topk"].count) == STATS_K)
    _expect_equal("select_k_unstable", topk.astype(np.int64), want)
    ranks, order = rank_oracle(c["l_quantity"])
    for tb in TIEBREAKERS:
        got, _ = _host(r["ranks"][tb].column, n)
        _expect_equal(f"rank {tb}", got.astype(np.int64), ranks[tb])
    part, _ = _host(r["part"].column, n)
    _expect_equal("partition_nth_indices", part.astype(np.int64), order)
    return (f"{n} rows sorted by 3 keys ({int((~c['l_suppkey:valid']).sum())}"
            f" null suppliers first), 5 columns taken, top {STATS_K} from "
            f"price {price[want[0]] / 100:.2f}, 4 ranks, partition")


# cumulative: running sums, extremes and means, and pairwise differences
def cumulative_run(s):
    li, t = s["lineitem"], s["typed"]
    price, supp = li.column("l_extendedprice"), t.column("l_suppkey")
    ctx = _context(li)
    out = {}
    for fn in ("cumulative_sum", "cumulative_min", "cumulative_max",
               "cumulative_mean"):
        out[("price", fn)] = _call(ctx, fn, price)
        for skip in (False, True):
            out[("supp", fn, skip)] = _call(ctx, fn, supp, skip_nulls=skip)
    for period in (1, -3):
        out[("diff", period)] = _call(ctx, "pairwise_diff",
                                      li.column("l_orderkey"), period=period)
    return out


def check_cumulative(c, r):
    """numpy's cumsum, minimum/maximum.accumulate and running means:
    f64 within RTOL_F64, uint32 sums exact (wrapping at 32 bits, as
    numpy's uint32 cumsum does), extremes exact; validity the column's
    own with skip_nulls, else valid up to the first null."""
    n = c["n"]
    price = c["plain"]["l_extendedprice"]
    want = {"cumulative_sum": np.cumsum(price),
            "cumulative_min": np.minimum.accumulate(price),
            "cumulative_max": np.maximum.accumulate(price),
            "cumulative_mean": np.cumsum(price) / np.arange(1, n + 1)}
    for fn, w in want.items():
        got, _ = _host(r[("price", fn)], n)
        (_expect_close if fn in ("cumulative_sum", "cumulative_mean")
         else _expect_equal)(f"{fn} of l_extendedprice", got, w)
    valid = c["l_suppkey:valid"]
    supp = c["l_suppkey"]
    live_count = np.cumsum(valid)
    want = {"cumulative_sum": np.cumsum(np.where(valid, supp, 0),
                                        dtype=np.uint32),
            "cumulative_min": np.minimum.accumulate(
                np.where(valid, supp, np.uint32(0xFFFFFFFF))),
            "cumulative_max": np.maximum.accumulate(
                np.where(valid, supp, np.uint32(0))),
            "cumulative_mean": np.cumsum(np.where(valid, supp, 0),
                                         dtype=np.float64)
            / np.maximum(live_count, 1)}
    poisoned = valid & (np.cumsum(~valid) == 0)
    for fn, w in want.items():
        for skip in (False, True):
            got, got_valid = _host(r[("supp", fn, skip)], n)
            (_expect_close if fn == "cumulative_mean" else _expect_equal)(
                f"{fn} of l_suppkey (skip_nulls={skip})", got, w)
            _expect_equal(f"{fn} of l_suppkey validity (skip_nulls={skip})",
                          got_valid, valid if skip else poisoned)
    okey = c["plain"]["l_orderkey"]
    cap = len(okey)
    for period in (1, -3):
        got, got_valid = _host(r[("diff", period)], n)
        idx = np.arange(n)
        _expect_equal(f"pairwise_diff {period}", got,
                      okey[:n] - okey[(idx - period) % cap])
        _expect_equal(f"pairwise_diff {period} validity", got_valid,
                      idx >= period if period >= 0 else idx < cap + period)
    return (f"sum of l_extendedprice {want['cumulative_sum'][-1]}, "
            f"{int(poisoned.sum())} rows before the first null supplier")


# distinct: unique, value_counts, dictionary_encode, count_distinct
def distinct_run(s):
    t = s["typed"]
    ctx, supp = _context(t), t.column("l_suppkey")
    return {"unique": _call(ctx, "unique", supp),
            "value_counts": _call(ctx, "value_counts", supp),
            "encode": _call(ctx, "dictionary_encode", supp),
            "flags": _call(ctx, "unique", t.column("l_returnflag")),
            "parts": _call(ctx, "count_distinct", t.column("l_partkey")),
            "suppliers": _call(ctx, "count_distinct", supp, mode="all")}


def first_appearance(key, size):
    """(the keys present in order of first appearance, each one's row
    count and first row, and the rank of every key value), for keys in
    [0, size): ``np.minimum.at`` and ``np.bincount``, no sort of the
    rows."""
    n = len(key)
    first = np.full(size, n, dtype=np.int64)
    np.minimum.at(first, key, np.arange(n, dtype=np.int64))
    present = np.flatnonzero(first < n)
    order = present[np.argsort(first[present])]
    rank = np.full(size, -1, dtype=np.int64)
    rank[order] = np.arange(len(order))
    return order, np.bincount(key, minlength=size)[order], first[order], \
        rank


def check_distinct(c, r):
    """The supplier values (null as one value) in order of first
    appearance, their counts and every row's code; the return flags'
    codes in that order; distinct part keys by ``np.bincount``; the
    suppliers' distinct valid values plus one for the nulls."""
    n = c["n"]
    valid = c["l_suppkey:valid"]
    key = np.where(valid, c["l_suppkey"].astype(np.int64) + 1, 0)
    order, counts, _, rank = first_appearance(key, int(key.max()) + 1)
    g = len(order)
    _expect("unique count", int(r["unique"].count) == g)
    got, got_valid = _host(r["unique"].column, g)
    _expect_equal("unique validity", got_valid, order > 0)
    _expect_equal("unique values", got[order > 0].astype(np.int64),
                  order[order > 0] - 1)
    got, _ = _host(r["value_counts"]["counts"].column, g)
    _expect_equal("value_counts", got, counts)
    got, got_valid = _host(r["value_counts"]["values"].column, g)
    _expect_equal("value_counts values", got[order > 0].astype(np.int64),
                  order[order > 0] - 1)
    codes, codes_valid = _host(r["encode"].column, n)
    _expect_equal("dictionary_encode", codes.astype(np.int64), rank[key])
    _expect_equal("dictionary_encode validity", codes_valid, valid)
    flags = c["l_returnflag"].astype(np.int64)
    forder, _, _, _ = first_appearance(flags, len(c["l_returnflag:dict"]))
    got, _ = _host(r["flags"].column, len(forder))
    _expect("unique l_returnflag count", int(r["flags"].count) == len(forder))
    _expect_equal("unique l_returnflag", got.astype(np.int64), forder)
    parts = np.count_nonzero(np.bincount(c["l_partkey"].astype(np.int64)))
    _expect("count_distinct l_partkey", int(r["parts"].value) == parts and
            bool(r["parts"].valid), f"({int(r['parts'].value)}, {parts})")
    supps = int(np.count_nonzero(counts[order > 0])) + int((~valid).any())
    _expect("count_distinct l_suppkey all",
            int(r["suppliers"].value) == supps)
    return (f"{g} supplier values (with null), {parts} part keys, flags "
            f"{[c['l_returnflag:dict'][f] for f in forder]}")


# select: filter under a nullable mask both ways, drop_null, take
def select_run(s):
    t = s["typed"]
    ctx, supp = _context(t), t.column("l_suppkey")
    out = {"drop": _call(ctx, "filter", supp, s["mask"]),
           "emit_null": _call(ctx, "array_filter", supp, s["mask"],
                              null_selection_behavior="emit_null"),
           "drop_null": _call(ctx, "drop_null", supp)}
    # take's context is its indices'
    ictx = _rows_context(s["idx"].capacity, t.row_count)
    out["take"] = _call(ictx, "take", t.column("l_extendedprice"), s["idx"])
    try:
        _call(ictx, "take", t.column("l_extendedprice"), s["bad_idx"])
    except IndexError:
        out["bad_take_raised"] = True
    else:
        out["bad_take_raised"] = False
    return out


def check_select(c, r):
    """Boolean indexing in numpy: a null mask slot drops its row, or
    emits a null row; drop_null keeps the valid rows; take gathers with
    null indices giving nulls; an index out of range raised IndexError."""
    supp, valid = c["l_suppkey"], c["l_suppkey:valid"]
    m, mv = c["mask"], c["mask:valid"]
    for name, keep, out_valid in (
            ("drop", m & mv, valid), ("emit_null", (m & mv) | ~mv,
                                      valid & mv),
            ("drop_null", valid, valid)):
        res = r[name]
        k = int(keep.sum())
        _expect(f"filter {name} count", int(res.count) == k,
                f"({int(res.count)}, {k})")
        got, got_valid = _host(res.column, k)
        _expect_equal(f"filter {name} validity", got_valid, out_valid[keep])
        _expect_equal(f"filter {name} values", got[got_valid],
                      supp[keep][got_valid])
    n = c["n"]
    idx, iv = c["idx"], c["idx:valid"]
    got, got_valid = _host(r["take"].column, n)
    _expect_equal("take validity", got_valid, iv)
    _expect_equal("take values", got[iv], c["l_extendedprice"][idx[iv]])
    if not r["bad_take_raised"]:
        raise AssertionError("take with an index out of range did not "
                             "raise IndexError")
    return (f"{int((m & mv).sum())} rows kept, {int((~mv).sum())} null "
            f"mask slots, {int((~iv).sum())} null indices; the bad index "
            "raised IndexError")


# stats_grouped: statistics by Q1's flags, and per order
def stats_grouped_decls(s, ac=None):
    """(the typed declaration keyed on the two flags, Q1's lineitem keyed
    on l_orderkey), each with Q1's filter folded in."""
    ac = _acero(ac)
    D, f = ac.Declaration, ac.field
    flags = D.from_sequence([
        D("table_source", ac.TableSourceNodeOptions(s["typed"])),
        D("filter", ac.FilterNodeOptions(
            f("l_shipdate") <= SHIPDATE_1998_09_02_S)),
        D("project", ac.ProjectNodeOptions(
            [f("l_returnflag"), f("l_linestatus"), f("l_extendedprice"),
             f("l_tax"), f("l_suppkey"), f("l_shipdate"),
             f("l_quantity") > 45, f("l_linenumber"), f("l_discount")],
            ["l_returnflag", "l_linestatus", "l_extendedprice", "l_tax",
             "l_suppkey", "l_shipdate", "big", "l_linenumber",
             "l_discount"])),
        D("aggregate", ac.AggregateNodeOptions(
            [("l_extendedprice", "hash_variance", None, "var_price"),
             ("l_tax", "hash_stddev", {"ddof": 1}, "sd_tax"),
             ("l_suppkey", "hash_min_max", None, "supp"),
             ("l_suppkey", "hash_first", {"skip_nulls": False},
              "first_supp"),
             ("l_suppkey", "hash_last", None, "last_supp"),
             ("l_shipdate", "hash_one", None, "one_ship"),
             ("big", "hash_any", None, "any_big"),
             ("big", "hash_all", None, "all_big"),
             ("l_linenumber", "hash_product", None, "prod_line"),
             ("l_suppkey", "hash_sum", {"skip_nulls": False,
                                        "min_count": 0}, "sum_supp"),
             ("l_suppkey", "hash_count", {"mode": "only_null"},
              "null_supp"),
             ("l_discount", "hash_mean", None, "avg_disc")],
            keys=["l_returnflag", "l_linestatus"]))])
    orders = D.from_sequence([
        D("table_source", ac.TableSourceNodeOptions(s["lineitem"])),
        D("filter", ac.FilterNodeOptions(
            f("l_shipdate") <= SHIPDATE_1998_09_02)),
        D("project", ac.ProjectNodeOptions(
            [f("l_orderkey"), 1.0 + f("l_discount"), f("l_extendedprice"),
             f("l_linenumber")],
            ["l_orderkey", "disc1", "l_extendedprice", "l_linenumber"])),
        D("aggregate", ac.AggregateNodeOptions(
            [("disc1", "hash_product", None, "prod_disc"),
             ("l_extendedprice", "hash_variance", None, "var_price"),
             ("l_linenumber", "hash_first", None, "first_line"),
             ("l_linenumber", "hash_last", None, "last_line")],
            keys=["l_orderkey"]))])
    return flags, orders


def stats_grouped_run(s, decls=None):
    """The flags' statistics downloaded (``to_table``); the per-order
    ones left on the device (``execute_declaration``: about 15M
    groups)."""
    from arrow_tpu_torch.acero.exec import execute_declaration
    flags, orders = decls or stats_grouped_decls(s)
    return {"flags": flags.to_table(), "orders": execute_declaration(orders)}


def _group_rows(key, keep):
    """The kept rows of each key value in order of first appearance:
    (the present keys, each one's kept rows)."""
    rows = np.flatnonzero(keep)
    order, _, _, _ = first_appearance(key[rows], int(key.max()) + 1)
    return [(k, rows[key[rows] == k]) for k in order]


def _variance(x, ddof=0):
    m = x.sum() / len(x)
    return float(((x - m) ** 2).sum() / max(len(x) - ddof, 1))


def stats_flags_oracle(c):
    """The flags' statistics in numpy, group by group (at most 6 live
    groups of 10M rows): two-pass f64 moments, the integer reductions
    exact (the int8 product wraps in int64, as numpy's does)."""
    import datetime
    keep = c["l_shipdate"] <= SHIPDATE_1998_09_02_S
    rfd, lsd = c["l_returnflag:dict"], c["l_linestatus:dict"]
    key = c["l_returnflag"].astype(np.int64) * len(lsd) + c["l_linestatus"]
    valid, supp = c["l_suppkey:valid"], c["l_suppkey"].astype(np.int64)
    out = {k: [] for k in (
        "l_returnflag", "l_linestatus", "var_price", "sd_tax", "supp_min",
        "supp_max", "first_supp", "last_supp", "one_ship", "any_big",
        "all_big", "prod_line", "sum_supp", "null_supp", "avg_disc")}
    epoch = datetime.datetime(1970, 1, 1)
    for k, rows in _group_rows(key, keep):
        v = valid[rows]
        sv = supp[rows][v]
        big = c["l_quantity"][rows] > 45
        disc = int(c["l_discount"][rows].sum())
        first, last = rows[0], rows[v][-1]
        vals = {
            "l_returnflag": rfd[k // len(lsd)],
            "l_linestatus": lsd[k % len(lsd)],
            "var_price": _variance(c["l_extendedprice"][rows] * 0.01),
            "sd_tax": float(np.sqrt(_variance(
                c["l_tax"][rows].astype(np.float64), 1))),
            "supp_min": int(sv.min()), "supp_max": int(sv.max()),
            "first_supp": int(supp[first]) if valid[first] else None,
            "last_supp": int(supp[last]),
            "one_ship": epoch + datetime.timedelta(
                seconds=int(c["l_shipdate"][first])),
            "any_big": bool(big.any()), "all_big": bool(big.all()),
            "prod_line": int(np.prod(c["l_linenumber"][rows].astype(
                np.int64))),
            "sum_supp": None if not v.all() else int(sv.sum()),
            "null_supp": int((~v).sum()),
            "avg_disc": _decimal(_decimal_mean(disc, len(rows)), 2)}
        for name, x in vals.items():
            out[name].append(x)
    return out


def check_orders(c, batch):
    """The per-order statistics against ``np.minimum.at`` (first rows),
    ``np.maximum.at`` (last rows), ``np.multiply.at`` and ``np.add.at``
    (products and sums in row order) and a second pass for the squared
    deviations: the groups in order of first appearance, products and
    variances within RTOL_F64, line numbers exact."""
    p = c["plain"]
    n = c["n"]
    keep = p["l_shipdate"] <= SHIPDATE_1998_09_02
    rows = np.flatnonzero(keep)
    key = p["l_orderkey"][:n][rows]
    size = int(key.max()) + 1
    first = np.full(size, n, dtype=np.int64)
    np.minimum.at(first, key, rows)
    last = np.full(size, -1, dtype=np.int64)
    np.maximum.at(last, key, rows)
    counts = np.bincount(key, minlength=size)
    prod = np.ones(size)
    np.multiply.at(prod, key, 1.0 + p["l_discount"][rows])
    price = p["l_extendedprice"][rows]
    sums = np.bincount(key, weights=price, minlength=size)
    mean = sums / np.maximum(counts, 1)
    dev = price - mean[key]
    m2 = np.bincount(key, weights=dev * dev, minlength=size)
    g = int(batch.row_count)
    _expect("per-order group count", g == int((counts > 0).sum()),
            f"({g}, {int((counts > 0).sum())})")
    okey, _ = _host(batch.column("l_orderkey"), g)
    firsts = first[okey]
    _expect("per-order groups in order of first appearance",
            bool((counts[okey] > 0).all()) and
            bool((firsts[1:] > firsts[:-1]).all()))
    got, _ = _host(batch.column("prod_disc"), g)
    _expect_close("per-order hash_product", got, prod[okey])
    got, got_valid = _host(batch.column("var_price"), g)
    _expect_close("per-order hash_variance", got,
                  m2[okey] / np.maximum(counts[okey], 1))
    line = p["l_linenumber"]
    for name, at in (("first_line", first), ("last_line", last)):
        got, _ = _host(batch.column(name), g)
        _expect_equal(f"per-order {name}", got, line[at[okey]])
    return g


def check_stats_grouped(c, r):
    check_typed("stats by flags", r["flags"], stats_flags_oracle(c))
    g = check_orders(c, r["orders"])
    return (f"{len(r['flags']['var_price'])} flag groups, {g} orders "
            "(general grouper)")


# stats_scalar: moments, quantiles and the rest with keys=[]
def stats_scalar_decl(s, ac=None):
    ac = _acero(ac)
    D, f = ac.Declaration, ac.field
    aggs = [("l_extendedprice", fn, None, fn)
            for fn in ("variance", "stddev", "skew", "kurtosis")]
    aggs += [("l_tax", "quantile", {"q": QUANTILES, "interpolation": i},
              f"q_{i}") for i in INTERPOLATIONS]
    aggs += [("l_tax", "median", None, "median"),
             ("l_tax", "approximate_median", None, "approx_median"),
             ("l_suppkey", "min_max", None, "supp"),
             ("l_suppkey", "first_last", {"skip_nulls": False}, "fl"),
             ("l_suppkey", "index", {"value": INDEX_SUPPLIER}, "idx"),
             ("big", "any", None, "any_big"), ("big", "all", None, "all_big"),
             ("l_linenumber", "product", None, "prod_line")]
    return D.from_sequence([
        D("table_source", ac.TableSourceNodeOptions(s["typed"])),
        D("project", ac.ProjectNodeOptions(
            [f("l_extendedprice"), f("l_tax"), f("l_suppkey"),
             f("l_quantity") > 45, f("l_linenumber")],
            ["l_extendedprice", "l_tax", "l_suppkey", "big",
             "l_linenumber"])),
        D("aggregate", ac.AggregateNodeOptions(aggs, keys=[]))])


def sorted_cents(x):
    """``x`` (the tax: whole cents, few distinct values) as its distinct
    values ascending and their cumulative counts, from ``np.bincount``,
    with no sort of the rows."""
    cents = np.rint(x * 100).astype(np.int64)
    counts = np.bincount(cents)
    present = np.flatnonzero(counts)
    table = np.zeros(len(counts))
    table[present] = [x[np.argmax(cents == k)] for k in present]
    if not np.array_equal(table[cents], x):
        raise AssertionError("quantile oracle: a tax is not a whole cent")
    return table[present], np.cumsum(counts[present])


def quantile_oracle(values, ends, q, interpolation):
    """The reference's rule on the sorted values (``sorted_cents``): the
    two order statistics around ``q * (n - 1)``."""
    def at(k):
        return float(values[np.searchsorted(ends, k, side="right")])

    pos = q * (ends[-1] - 1.0)
    lo, hi = np.floor(pos), np.ceil(pos)
    frac = pos - lo
    vlo, vhi = at(int(lo)), at(int(hi))
    return {"linear": vlo + (vhi - vlo) * frac, "lower": vlo,
            "higher": vhi, "nearest": vlo if frac <= 0.5 else vhi,
            "midpoint": (vlo + vhi) * 0.5}[interpolation]


def stats_scalar_oracle(c):
    """Two-pass f64 moments of the prices (descaled), the quantiles of
    the f32 tax by ``quantile_oracle``, and the integer results exact."""
    x = c["l_extendedprice"] * 0.01
    n = len(x)
    cdev = x - x.sum() / n
    c2 = cdev * cdev
    m2, m3, m4 = c2.sum(), (c2 * cdev).sum(), (c2 * c2).sum()
    var = m2 / n
    out = {"variance": [var], "stddev": [float(np.sqrt(var))],
           "skew": [(m3 / n) / var ** 1.5],
           "kurtosis": [(m4 / n) / var ** 2 - 3.0]}
    taxes = sorted_cents(c["l_tax"].astype(np.float64))
    for i in INTERPOLATIONS:
        for j, q in enumerate(QUANTILES):
            out[f"q_{i}_q{j}"] = [quantile_oracle(*taxes, q, i)]
    out["median"] = [quantile_oracle(*taxes, 0.5, "linear")]
    out["approx_median"] = out["median"]
    valid, supp = c["l_suppkey:valid"], c["l_suppkey"].astype(np.int64)
    hits = np.flatnonzero(valid & (supp == INDEX_SUPPLIER))
    big = c["l_quantity"] > 45
    out.update({
        "supp_min": [int(supp[valid].min())],
        "supp_max": [int(supp[valid].max())],
        "fl_first": [int(supp[0]) if valid[0] else None],
        "fl_last": [int(supp[-1]) if valid[-1] else None],
        "idx": [int(hits[0]) if len(hits) else -1],
        "any_big": [bool(big.any())], "all_big": [bool(big.all())],
        "prod_line": [int(np.prod(c["l_linenumber"].astype(np.int64)))]})
    return out


def check_stats_scalar(c, result):
    check_typed("stats (keys=[])", result, stats_scalar_oracle(c))
    return (f"variance {result['variance'][0]:.6g}, median tax "
            f"{result['median'][0]}, index of supplier {INDEX_SUPPLIER} "
            f"{result['idx'][0]}")


def stats_scalar_run(s, decl=None):
    return (decl or stats_scalar_decl(s)).to_table()


class StatsPath(NamedTuple):
    """One path of phase 3g or 3i: ``run(inputs)`` gives its results,
    ``check(host columns, results)`` holds them against numpy."""
    name: str
    run: object
    check: object
    launches: dict


# Launches a run at SF10, reckoned from the code. sort_take, cumulative,
# distinct and stats_scalar: sorts, scans, gathers and scatters, no kernel.
# select: filter, array_filter and drop_null compact once each (3), take
# gathers. stats_grouped: Q1's filter folds into both aggregates; by the
# flags (12 slots) hash_variance's and hash_stddev's two sums each run the
# grouped sum (4); the decimal mean, the integer sums, products and counts
# add in int64; per order (15M groups) the sums and the product take the
# sorted route (no kernel).
STATS_PATHS = (
    StatsPath("sort_take", sort_take_run, check_sort_take,
              _launches(0, 0, 0)),
    StatsPath("cumulative", cumulative_run, check_cumulative,
              _launches(0, 0, 0)),
    StatsPath("distinct", distinct_run, check_distinct, _launches(0, 0, 0)),
    StatsPath("select", select_run, check_select, _launches(3, 0, 0)),
    StatsPath("stats_grouped", stats_grouped_run, check_stats_grouped,
              _launches(0, 0, 4)),
    StatsPath("stats_scalar", stats_scalar_run, check_stats_scalar,
              _launches(0, 0, 0)),
)


def stats_repeats(s):
    """The float results phase 3g holds to the same bits on a second
    run: cumulative_sum of l_extendedprice, both hash_variance results
    (by flags, per order), the per-order hash_product and the quantiles
    of l_tax."""
    from arrow_tpu_torch.acero.exec import execute_declaration
    ctx = _context(s["lineitem"])
    flags, orders = stats_grouped_decls(s)
    flags_batch = execute_declaration(flags)
    orders_batch = execute_declaration(orders)
    tax = s["typed"].column("l_tax")
    q = _call(_context(s["typed"]), "quantile", tax, q=QUANTILES,
              interpolation="linear")
    return [_call(ctx, "cumulative_sum",
                  s["lineitem"].column("l_extendedprice")).values,
            flags_batch.column("var_price").values,
            orders_batch.column("var_price").values,
            orders_batch.column("prod_disc").values,
            torch.stack(list(q.value))]


def phase_stats_kernels(s):
    """The two kernels on phase 3g's paths against their plain versions
    at the shapes the paths give them: the compaction of the select
    path's supplier column (values and validity) under the nullable mask,
    dropped and emitting nulls, bit for bit; the grouped sum of the flags'
    hash_variance (its values and its squared deviations, 12 slots),
    within RTOL_F64. Launches here are outside every path's count."""
    from arrow_tpu_torch.compute.grouper import (group_ids,
                                                 group_slot_bound_exact)
    from arrow_tpu_torch.compute.selection import _buffers, selection_mask
    from arrow_tpu_torch.kernels.grouped_sum import (grouped_sum,
                                                     grouped_sum_plain)
    t = s["typed"]
    ctx, supp = _context(t), t.column("l_suppkey")
    for behavior in ("drop", "emit_null"):
        keep, emit_null = selection_mask(ctx, s["mask"], behavior)
        arrays, _ = _buffers([supp], emit_null)
        compact_case(f"compact (select, {behavior}, n={keep.numel()})",
                     keep, arrays)
    keep = t.column("l_shipdate").values <= SHIPDATE_1998_09_02_S
    fctx = _context(t)
    fctx.row_mask_ = keep & ctx.row_mask()
    keys = [t.column("l_returnflag"), t.column("l_linestatus")]
    g = group_ids(fctx, keys)
    nseg = group_slot_bound_exact(keys, t.capacity)
    live = fctx.row_mask() & (g.group_ids < t.capacity)
    seg = torch.where(live, g.group_ids, 0).to(torch.int32)
    v = torch.where(live, t.column("l_extendedprice").values.double()
                    * 0.01, 0.0)
    err = check_close(f"grouped_sum (hash_variance sums, S={nseg})",
                      grouped_sum(v, seg, nseg),
                      grouped_sum_plain(v, seg, nseg), RTOL_F64)
    counts = torch.zeros(nseg, dtype=torch.int64, device=v.device)
    counts.index_add_(0, seg.long(), live.long())
    mean = grouped_sum_plain(v, seg, nseg) / counts.clamp(min=1)
    dev = torch.where(live, v - mean[seg.long()], 0.0)
    err = max(err, check_close(
        f"grouped_sum (hash_variance squares, S={nseg})",
        grouped_sum(dev * dev, seg, nseg),
        grouped_sum_plain(dev * dev, seg, nseg), RTOL_F64))
    return err


def _timed_check(path, cols, result):
    t0 = time.perf_counter()
    return path.check(cols, result), time.perf_counter() - t0


def phase_stats(tables, typed):
    """Phase 3g: the vector functions and the statistics aggregates at
    SF10 over Q1's lineitem and phase 3f's typed lineitem, each path with
    every launch count set to 0 just before its run and read just after,
    against its numpy oracle, with the card's peak memory over the run;
    then the float results run twice for the same bits. Returns (launches
    by path, the inputs)."""
    from arrow_tpu_torch.platform_check import self_check
    log(f"== phase 3g: vector functions and statistics at SF{SF:g}")
    t0 = time.perf_counter()
    s = stats_inputs(tables["lineitem"], typed)
    cols = stats_columns(s)
    log(f"inputs made and downloaded in {time.perf_counter() - t0:.1f} s")
    errs = phase_stats_kernels(s)
    launches, failures, checks = {}, [], {}
    # the paths run one by one; their numpy oracles run meanwhile, one
    # thread each (numpy leaves the interpreter lock in its loops)
    with concurrent.futures.ThreadPoolExecutor(len(STATS_PATHS)) as pool:
        for path in STATS_PATHS:
            base = memory_mark()
            zero_launches()
            self_check()
            t1 = time.perf_counter()
            result = path.run(s)
            torch.cuda.synchronize()
            log(f"{path.name} first run {time.perf_counter() - t1:.3f} s")
            launches[path.name] = read_launches()
            log_peak(path.name, base)
            checks[path.name] = pool.submit(_timed_check, path, cols, result)
            del result
        for path in STATS_PATHS:
            try:
                msg, seconds = checks[path.name].result()
                check_launches(path.name, launches[path.name], path.launches)
                log(f"{path.name} matches its oracle: {msg} (oracle "
                    f"{seconds:.1f} s)")
            except AssertionError as exc:
                log(f"  {path.name} FAILED: {exc}")
                failures.append(path.name)
    first, second = stats_repeats(s), stats_repeats(s)
    check_bit_exact("phase 3g float results, two runs", first, second,
                    "the first run")
    if failures:
        raise AssertionError(f"phase 3g failed for {failures}")
    log(f"phase 3g: {time.perf_counter() - t0:.1f} s (kernels against "
        f"their plain versions: max_abs_err {errs!r})")
    return launches, s


# --- phase 3h: the temporal and string functions -----------------------------

TEMPORAL_SEED = 13
OFFSET_SLOTS = 1_009            # seeded offsets within the day, by ship day
TEMPORAL_NULLS = 0.01           # the share of the timestamp[ns] column's nulls
NS_PER_DAY = 86_400 * 10 ** 9
EPOCH = datetime.date(1970, 1, 1)
TEMPORAL_COLUMNS = ("date32", "timestamp[s]", "date64", "timestamp[ns]",
                    "time64[us]", "duration[ms]")
TEMPORAL_UNARY = ("year", "month", "day", "hour", "minute", "second",
                  "millisecond", "microsecond", "nanosecond", "quarter",
                  "day_of_year", "iso_year", "iso_week", "us_week",
                  "us_year", "is_leap_year", "is_dst", "subsecond")
ROUNDINGS = (("day", 1, True), ("week", 1, True), ("week", 1, False),
             ("month", 1, True), ("quarter", 1, True), ("year", 1, True),
             ("minute", 15, True))
BETWEEN = ("years_between", "quarters_between", "month_interval_between",
           "days_between", "hours_between", "minutes_between",
           "seconds_between", "milliseconds_between", "microseconds_between",
           "nanoseconds_between")
BETWEEN_PAIRS = (("date32", "receipt"), ("timestamp[ns]", "date64"))


def temporal_calls():
    """(function, input column names, options) of the temporal_fields
    path: every temporal name over the six columns; every option of
    ``day_of_week`` and ``week`` over the date32 column; the three
    roundings at day, week (both starts), month, quarter, year and 15
    minutes over the date32 and timestamp[ns] columns, floor_temporal at
    those units over the other roundable ones; each ``*_between`` of the
    two pairs. (Each call is some tens of integer divisions over 60M rows
    on the card, so the options' product stays on two columns.)"""
    roundings = ("floor_temporal", "ceil_temporal", "round_temporal")
    calls = []
    for c in TEMPORAL_COLUMNS:
        calls += [(fn, (c,), {}) for fn in TEMPORAL_UNARY]
        every = c == "date32"
        calls += [("day_of_week", (c,), {"count_from_zero": z,
                                         "week_start": s})
                  for z in (True, False) for s in range(1, 8)
                  if every or (z, s) == (True, 1)]
        calls += [("week", (c,), {"week_starts_monday": m,
                                  "count_from_zero": z,
                                  "first_week_is_fully_in_year": f})
                  for m in (True, False) for z in (False, True)
                  for f in (False, True) if every or (m, z, f) == (
                      True, False, False)]
        if c != "duration[ms]":
            calls += [(fn, (c,), {"unit": u, "multiple": k,
                                  "week_starts_monday": m})
                      for fn in roundings for u, k, m in ROUNDINGS
                      if c in ("date32", "timestamp[ns]")
                      or fn == "floor_temporal"]
        if c.startswith("timestamp"):
            calls += [("local_timestamp", (c,), {}),
                      ("assume_timezone", (c,), {"timezone": "UTC"})]
    for pair in BETWEEN_PAIRS:
        calls += [(fn, pair, {}) for fn in BETWEEN]
        calls += [("weeks_between", pair, {"week_start": s})
                  for s in (1, 4, 7)]
    return calls


def temporal_inputs(lineitem, typed, seed=TEMPORAL_SEED):
    """Phase 3h's temporal columns: Q1's lineitem's ``l_shipdate`` (date32)
    and ``l_receiptdate``, the typed lineitem's ``l_shipdate``
    (timestamp[s]) and ``l_commitdate`` (date64), and three made on the
    card: a timestamp[ns] of the ship day plus an offset within the day
    (one of ``OFFSET_SLOTS`` drawn from a generator seeded with ``seed``,
    by the ship day; ``TEMPORAL_NULLS`` of its rows null), the time64[us]
    of that offset and the duration[ms] from ship to receipt. Each input
    has its distinct values (host) and each live row's index among them
    (card), which the oracles read."""
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.device.column import DeviceColumn
    dev = lineitem.row_count.device
    n = int(lineitem.row_count)
    gen = torch.Generator(device=dev).manual_seed(seed)
    offsets = torch.randint(0, NS_PER_DAY, (OFFSET_SLOTS,), generator=gen,
                            device=dev)
    ship = lineitem.column("l_shipdate").values.long()
    receipt = lineitem.column("l_receiptdate").values.long()
    off = offsets[ship % OFFSET_SLOTS]
    valid = torch.rand(lineitem.capacity, generator=gen,
                       device=dev) >= TEMPORAL_NULLS
    cols = {
        "date32": lineitem.column("l_shipdate"),
        "receipt": lineitem.column("l_receiptdate"),
        "timestamp[s]": typed["lineitem"].column("l_shipdate"),
        "date64": typed["lineitem"].column("l_commitdate"),
        "timestamp[ns]": DeviceColumn(ship * NS_PER_DAY + off, valid,
                                      T.timestamp("ns")),
        "time64[us]": DeviceColumn(off // 1000, None, T.time64("us")),
        "duration[ms]": DeviceColumn((receipt - ship) * 86_400_000, None,
                                     T.duration("ms")),
    }
    distinct = {}
    for key, col in cols.items():
        vals, inv = torch.unique(col.values[:n].long(), return_inverse=True)
        distinct[key] = ([vals.cpu().numpy()], inv)
    return {"cols": cols, "n": n, "distinct": distinct}


def _np_time(values, t):
    """Stored values of temporal type ``t`` as numpy datetime64 of its
    unit (a time or a duration counts from the epoch, as in the
    reference)."""
    from arrow_tpu_torch.types import TypeId
    unit = {TypeId.DATE32: "D", TypeId.DATE64: "ms"}.get(t.id) or t.unit
    return values.astype(np.int64).astype(f"datetime64[{unit}]")


# the days the calendar table covers: 1900-01-01 to 2099-12-31
CALENDAR_DAYS = (-25_567, 47_482)


def _calendar_table():
    """Python's ``datetime`` fields of every day of ``CALENDAR_DAYS``:
    year, month, day, weekday (Monday 0), day of the year, ISO year and
    week, and the ISO year and week of the next day."""
    lo, hi = CALENDAR_DAYS
    dates = [EPOCH + datetime.timedelta(days=d) for d in range(lo, hi + 1)]
    iso = [d.isocalendar() for d in dates]
    return {"year": [d.year for d in dates],
            "month": [d.month for d in dates],
            "day": [d.day for d in dates],
            "weekday": [d.weekday() for d in dates],
            "yday": [d.timetuple().tm_yday for d in dates],
            "iso_year": [i[0] for i in iso], "iso_week": [i[1] for i in iso],
            "us_year": [i[0] for i in iso[1:]] + [iso[-1][0]],
            "us_week": [i[1] for i in iso[1:]] + [iso[-1][1]]}


_CALENDAR = {}


def calendar(days):
    """The calendar table's fields of each day number (of the table's
    range but its last day)."""
    if not _CALENDAR:
        _CALENDAR.update({k: np.array(v, dtype=np.int64)
                          for k, v in _calendar_table().items()})
    lo, hi = CALENDAR_DAYS
    i = np.asarray(days, dtype=np.int64) - lo
    if i.size and (i.min() < 0 or i.max() >= hi - lo):
        raise AssertionError(f"days outside the calendar table: "
                             f"{i.min() + lo}..{i.max() + lo}")
    return {k: v[i] for k, v in _CALENDAR.items()}


def _day_numbers(us):
    return us.astype("datetime64[D]").astype(np.int64)


def _round_oracle(fn, us, t, unit, multiple, monday):
    """floor/ceil/round of ``us`` (datetime64[us]) by numpy's calendar
    units, back in type ``t``'s unit. Weeks start on Sundays where
    ``week_starts_monday`` and on Mondays where not: the reference's
    swap, kept (ROADMAP.md §3). A ceil to months, quarters or years moves
    a value on the boundary up, as the reference's does."""
    from arrow_tpu_torch.types import TypeId
    step = None
    if unit == "day":
        lo = us.astype("datetime64[D]").astype("datetime64[us]")
        step = np.timedelta64(1, "D")
    elif unit == "week":
        start = np.datetime64("1970-01-04" if monday else "1970-01-05")
        weeks = (us.astype("datetime64[D]") - start) // np.timedelta64(7, "D")
        lo = (start + weeks * np.timedelta64(7, "D")).astype("datetime64[us]")
        step = np.timedelta64(7, "D")
    elif unit == "minute":
        minutes = us.astype("datetime64[m]").astype(np.int64)
        lo = (minutes // multiple * multiple).astype("datetime64[m]") \
            .astype("datetime64[us]")
        step = np.timedelta64(multiple, "m")
    else:
        per = {"month": 1, "quarter": 3, "year": 12}[unit] * multiple
        months = us.astype("datetime64[M]").astype(np.int64)
        lo_m = months // per * per
        lo = lo_m.astype("datetime64[M]").astype("datetime64[us]")
        hi = (lo_m + per).astype("datetime64[M]").astype("datetime64[us]")
    if step is not None:
        hi = lo + step
    if fn == "floor_temporal":
        out = lo
    elif fn == "ceil_temporal":
        out = hi if step is None else np.where(us == lo, lo, hi)
    else:
        out = np.where(us - lo < hi - us, lo, hi)
    unit_out = {TypeId.DATE32: "D", TypeId.DATE64: "ms"}.get(t.id) or t.unit
    return out.astype(f"datetime64[{unit_out}]").astype(np.int64)


def temporal_oracle(fn, types, values, opts):
    """(expected values over the distinct inputs, expected type) of a
    temporal call of one column, by numpy's datetime64 units and Python's
    datetime."""
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.types import TypeId
    t = types[0]
    dt = _np_time(values[0], t)
    us = dt.astype("datetime64[us]")
    if fn in ("floor_temporal", "ceil_temporal", "round_temporal"):
        return _round_oracle(fn, us, t, opts["unit"], opts["multiple"],
                             opts["week_starts_monday"]), t
    if fn == "local_timestamp":
        return values[0], T.timestamp(t.unit)
    if fn == "assume_timezone":
        return values[0], T.timestamp(t.unit, opts["timezone"])
    days = _day_numbers(us)
    cal = calendar(days)
    clock = {u: us.astype(f"datetime64[{u}]") for u in ("h", "m", "s", "ms")}
    day = us.astype("datetime64[D]")
    if fn == "day_of_week":
        out = (cal["weekday"] - (opts["week_start"] - 1)) % 7
        return out + (0 if opts["count_from_zero"] else 1), T.int64()
    if fn == "week":
        shift = 0 if opts["week_starts_monday"] else 1
        wk = calendar(days + shift)["iso_week"]
        if opts["first_week_is_fully_in_year"]:
            jan1 = _day_numbers(us.astype("datetime64[Y]"))
            wk = np.where((calendar(jan1)["weekday"] + shift) % 7 != 0,
                          wk - 1, wk)
        return wk - (1 if opts["count_from_zero"] else 0), T.int64()
    if fn == "subsecond":
        return ((us - clock["s"]) // np.timedelta64(1, "us")) / 1e6, \
            T.float64()
    if fn in ("is_leap_year", "is_dst"):
        y = cal["year"]
        leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
        return (leap if fn == "is_leap_year"
                else np.zeros(len(y), dtype=np.bool_)), T.bool_()
    ns = t.id in (TypeId.TIMESTAMP, TypeId.TIME64, TypeId.DURATION) \
        and t.unit == "ns"
    out = {"year": lambda: cal["year"], "month": lambda: cal["month"],
           "day": lambda: cal["day"],
           "quarter": lambda: (cal["month"] - 1) // 3 + 1,
           "day_of_year": lambda: cal["yday"],
           "iso_year": lambda: cal["iso_year"],
           "iso_week": lambda: cal["iso_week"],
           "us_year": lambda: cal["us_year"],
           "us_week": lambda: cal["us_week"],
           "hour": lambda: (clock["h"] - day) // np.timedelta64(1, "h"),
           "minute": lambda: (clock["m"] - clock["h"])
           // np.timedelta64(1, "m"),
           "second": lambda: (clock["s"] - clock["m"])
           // np.timedelta64(1, "s"),
           "millisecond": lambda: (clock["ms"] - clock["s"])
           // np.timedelta64(1, "ms"),
           "microsecond": lambda: (us - clock["ms"])
           // np.timedelta64(1, "us"),
           "nanosecond": lambda: (dt - us) // np.timedelta64(1, "ns") if ns
           else np.zeros(len(days), dtype=np.int64)}[fn]()
    return out, T.int64()


def _between_parts(values, t, week_start):
    """The per-value indices a ``*_between`` subtracts: microseconds and
    days since the epoch, year, quarter and month counts, and the day
    number of the value's week's start (weeks starting on ``week_start``,
    1 = Monday), by numpy's datetime64 and Python's calendar."""
    us = _np_time(values, t).astype("datetime64[us]")
    days = _day_numbers(us)
    cal = calendar(days)
    return {"us": us.astype(np.int64), "days": days, "year": cal["year"],
            "quarter": cal["year"] * 4 + (cal["month"] - 1) // 3,
            "month": cal["year"] * 12 + cal["month"],
            "week": days - (cal["weekday"] - (week_start - 1)) % 7}


# *_between of a span in microseconds: its unit in microseconds (0: the
# span times 1,000, in nanoseconds)
_SPAN_UNITS = {"hours_between": 3_600_000_000, "minutes_between": 60_000_000,
               "seconds_between": 1_000_000, "milliseconds_between": 1000,
               "microseconds_between": 1, "nanoseconds_between": 0}
# *_between of a calendar count: the index it subtracts
_COUNTS = {"years_between": "year", "quarters_between": "quarter",
           "month_interval_between": "month", "days_between": "days",
           "weeks_between": "week"}


def between_expected(fn, types, distinct, opts):
    """(expected values on the card, expected type) of ``fn(a, b)``: each
    column's parts over its distinct values, gathered by each row's index
    among them on the card and subtracted there; a span in microseconds
    floor-divided by its unit."""
    from arrow_tpu_torch import types as T
    parts = []
    for t, (values, inv) in zip(types, distinct):
        p = _between_parts(values[0], t, opts.get("week_start", 1))
        key = "us" if fn in _SPAN_UNITS else _COUNTS[fn]
        parts.append(torch.from_numpy(p[key]).to(inv.device)[inv])
    diff = parts[1] - parts[0]
    if fn == "weeks_between":
        return diff // 7, T.int64()
    if fn == "month_interval_between":
        return diff, T.month_interval()
    if fn in _SPAN_UNITS:
        unit = _SPAN_UNITS[fn]
        return (diff * 1000 if unit == 0 else torch.div(
            diff, unit, rounding_mode="floor")), T.int64()
    return diff, T.int64()


class CardCheck:
    """Holds results against expected tables on the card: each check
    gathers a table over distinct inputs by each live row's index and
    compares, keeping a 0-d flag; ``failures()`` reads the flags back
    once."""

    def __init__(self):
        self.labels, self.flags = [], []
        self.seconds = 0.0   # host time of the oracles and checks

    def start(self, got):
        """Waits for ``got`` on the card and starts the oracle's clock."""
        if got.values.is_cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        self.seconds += time.perf_counter() - self.t0

    def values(self, label, got, table, inv, valid=None):
        """``got`` (a column) equals ``table[inv]`` on its first
        ``len(inv)`` rows, and its validity equals ``valid`` there (None:
        none or all valid)."""
        self.tensor(label, got, torch.from_numpy(np.ascontiguousarray(
            table)).to(got.values.device)[inv], valid)

    def tensor(self, label, got, exp, valid=None):
        """``got`` (a column) equals ``exp`` (a tensor on its device) on
        its first ``len(exp)`` rows, and its validity equals ``valid``
        there."""
        n = exp.numel()
        g = got.values[:n]
        if exp.dtype == torch.bool:
            ok = torch.equal(g, exp)
        elif exp.dtype.is_floating_point:
            ok = torch.equal(g.double(), exp.double())
        else:
            ok = torch.equal(g.long(), exp.long())
        flag = torch.tensor(ok, device=g.device)
        if valid is None:
            if got.validity is not None:
                flag = flag & got.validity[:n].all()
        elif got.validity is None:
            flag = flag & valid[:n].all()
        else:
            flag = flag & torch.equal(got.validity[:n], valid[:n])
        self.labels.append(label)
        self.flags.append(flag)

    def host(self, label, ok):
        self.labels.append(label)
        self.flags.append(torch.tensor(bool(ok)))

    def failures(self):
        flags = torch.stack([f.cpu() for f in self.flags]).tolist()
        return [lab for lab, ok in zip(self.labels, flags) if not ok]


def _label(fn, names, opts):
    args = ", ".join(names) + "".join(f", {k}={v!r}" for k, v in opts.items())
    return f"{fn}({args})"


def temporal_fields_run(h, check=None):
    """Every call of ``temporal_calls()`` over the inputs of
    ``temporal_inputs``; with ``check`` each result is held against its
    oracle as soon as it is made (and dropped)."""
    from arrow_tpu_torch.compute.elementwise import _and_validity
    cols = h["cols"]
    date32 = cols["date32"]
    ctx = _rows_context(date32.capacity, torch.tensor(
        h["n"], device=date32.values.device))
    for fn, names, opts in temporal_calls():
        got = _call(ctx, fn, *[cols[k] for k in names], **opts)
        if check is None:
            continue
        check.start(got)
        types = [cols[k].type for k in names]
        valid = _and_validity(*(cols[k].validity for k in names))
        label = _label(fn, names, opts)
        if len(names) == 2:
            exp, out_type = between_expected(
                fn, types, [h["distinct"][k] for k in names], opts)
            check.tensor(label, got, exp, valid)
        else:
            values, inv = h["distinct"][names[0]]
            table, out_type = temporal_oracle(fn, types, values, opts)
            check.values(label, got, table, inv, valid)
        check.host(label + " type", got.type == out_type)
        check.stop()
    return check


# temporal_plan: a filter on the calendar and a projection of its fields
def temporal_plan(lineitem, ac=None):
    """lineitem's Friday and Saturday shipments of the fourth quarter
    received more than 20 days after their commit date: their ship year,
    ISO week and month, order key and price."""
    ac = _acero(ac)
    D, f, call = ac.Declaration, ac.field, ac.Expression.call
    ship = f("l_shipdate")
    return D.from_sequence([
        D("table_source", ac.TableSourceNodeOptions(lineitem)),
        D("filter", ac.FilterNodeOptions(
            (call("day_of_week", ship, week_start=7) >= 5)
            & (call("quarter", ship) == 4)
            & (call("days_between", f("l_commitdate"), f("l_receiptdate"))
               > 20))),
        D("project", ac.ProjectNodeOptions(
            [call("year", ship), call("iso_week", ship),
             call("floor_temporal", ship, unit="month"), f("l_orderkey"),
             f("l_extendedprice")],
            ["l_year", "l_week", "l_month", "l_orderkey",
             "l_extendedprice"])),
    ])


def temporal_plan_oracle(c):
    """The plan in numpy over the downloaded lineitem columns, the
    calendar from Python's datetime over the day range."""
    ship, commit, receipt = (c[k].astype(np.int64) for k in (
        "l_shipdate", "l_commitdate", "l_receiptdate"))
    lo = int(ship.min())
    cal = calendar(np.arange(lo, int(ship.max()) + 1))
    i = ship - lo
    sunday0 = (cal["weekday"][i] + 1) % 7
    keep = (sunday0 >= 5) & ((cal["month"][i] - 1) // 3 + 1 == 4) \
        & (receipt - commit > 20)
    idx = i[keep]
    first = np.array([(datetime.date(int(y), int(m), 1) - EPOCH).days
                      for y, m in zip(cal["year"], cal["month"])])
    return {"l_year": cal["year"][idx].tolist(),
            "l_week": cal["iso_week"][idx].tolist(),
            "l_month": [EPOCH + datetime.timedelta(days=int(d))
                        for d in first[idx]],
            "l_orderkey": c["l_orderkey"][keep].tolist(),
            "l_extendedprice": c["l_extendedprice"][keep]}, int(keep.sum())


def check_temporal_plan(c, result):
    want, kept = temporal_plan_oracle(c)
    check_result("temporal_plan", result, want)
    return f"{kept} rows kept, fields and row order exact"


# strings: str -> str, predicates and lengths over part and customer
def _zero_fill(v, width, padding):
    if v and v[0] not in "+-":
        return v.rjust(width, padding)
    return v[0] + v[1:].rjust(width - 1, padding) if v else v


def _regex_find(rx, v):
    m = rx.search(v)
    return m.start() if m else -1


@functools.lru_cache(maxsize=None)
def _regex(pattern, flags=0):
    return re.compile(pattern, flags)


# name -> Python's function of one value and the options
STR_ORACLES = {
    "utf8_upper": lambda v: v.upper(), "utf8_lower": lambda v: v.lower(),
    "utf8_swapcase": lambda v: v.swapcase(),
    "utf8_capitalize": lambda v: v.capitalize(),
    "utf8_title": lambda v: v.title(), "utf8_reverse": lambda v: v[::-1],
    "binary_reverse": lambda v: v[::-1],
    "utf8_trim_whitespace": lambda v: v.strip(),
    "utf8_ltrim_whitespace": lambda v: v.lstrip(),
    "utf8_rtrim_whitespace": lambda v: v.rstrip(),
    "utf8_trim": lambda v, characters: v.strip(characters),
    "utf8_ltrim": lambda v, characters: v.lstrip(characters),
    "utf8_rtrim": lambda v, characters: v.rstrip(characters),
    "utf8_lpad": lambda v, width, padding=" ": v.rjust(width, padding),
    "utf8_rpad": lambda v, width, padding=" ": v.ljust(width, padding),
    "utf8_center": lambda v, width, padding=" ": v.center(width, padding),
    "utf8_slice_codeunits": lambda v, start, stop=None, step=1:
        v[start:stop:step],
    "binary_slice": lambda v, start, stop=None, step=1: v[start:stop:step],
    "binary_repeat": lambda v, num_repeats: v * num_repeats,
    "utf8_zero_fill": lambda v, width, padding="0":
        _zero_fill(v, width, padding),
    "utf8_normalize": lambda v, form: unicodedata.normalize(form, v),
    "utf8_replace_slice": lambda v, start, stop, replacement:
        v[:start] + replacement + v[stop:],
    "binary_replace_slice": lambda v, start, stop, replacement:
        v[:start] + replacement.decode() + v[stop:],
    "replace_substring": lambda v, pattern, replacement:
        v.replace(pattern, replacement),
    "replace_substring_regex": lambda v, pattern, replacement:
        _regex(pattern).sub(replacement, v),
    "utf8_is_alnum": str.isalnum, "utf8_is_alpha": str.isalpha,
    "utf8_is_decimal": str.isdecimal, "utf8_is_digit": str.isdigit,
    "utf8_is_numeric": str.isnumeric, "utf8_is_lower": str.islower,
    "utf8_is_upper": str.isupper, "utf8_is_space": str.isspace,
    "utf8_is_title": str.istitle, "utf8_is_printable": str.isprintable,
    "ascii_is_alnum": lambda v: v.isascii() and v.isalnum(),
    "ascii_is_alpha": lambda v: v.isascii() and v.isalpha(),
    "ascii_is_decimal": lambda v: v.isascii() and v.isdecimal(),
    "ascii_is_lower": lambda v: v.isascii() and v.islower(),
    "ascii_is_upper": lambda v: v.isascii() and v.isupper(),
    "ascii_is_space": lambda v: v.isascii() and v.isspace(),
    "ascii_is_printable": str.isprintable, "ascii_is_title": str.istitle,
    "string_is_ascii": str.isascii, "utf8_length": len,
    "binary_length": lambda v: len(v.encode()),
    "match_substring": lambda v, pattern, ignore_case=False:
        (pattern.lower() in v.lower()) if ignore_case else pattern in v,
    "starts_with": lambda v, pattern: v.startswith(pattern),
    "ends_with": lambda v, pattern: v.endswith(pattern),
    "match_like": lambda v, pattern: _regex(
        pattern.replace("%", ".*").replace("_", "."), re.S).fullmatch(v)
    is not None,
    "count_substring": lambda v, pattern, ignore_case=False:
        v.lower().count(pattern.lower()) if ignore_case
        else v.count(pattern),
    "find_substring": lambda v, pattern, ignore_case=False:
        v.lower().find(pattern.lower()) if ignore_case else v.find(pattern),
    "match_substring_regex": lambda v, pattern:
        _regex(pattern).search(v) is not None,
    "count_substring_regex": lambda v, pattern:
        len(_regex(pattern).findall(v)),
    "find_substring_regex": lambda v, pattern:
        _regex_find(_regex(pattern), v),
}
_NS = np.strings
# numpy's vectorised forms of some of the oracles over a str array, for
# the 2M values of p_name: Python's str and numpy's strings agree on them
# (not on the pads: numpy 2.0's ljust cuts a longer value to the width),
# and numpy runs them without the interpreter's loop
NP_ORACLES = {
    "utf8_upper": _NS.upper, "utf8_lower": _NS.lower,
    "utf8_swapcase": _NS.swapcase, "utf8_capitalize": _NS.capitalize,
    "utf8_title": _NS.title, "utf8_trim_whitespace": _NS.strip,
    "utf8_ltrim_whitespace": _NS.lstrip, "utf8_rtrim_whitespace": _NS.rstrip,
    "utf8_trim": lambda a, characters: _NS.strip(a, characters),
    "utf8_ltrim": lambda a, characters: _NS.lstrip(a, characters),
    "utf8_rtrim": lambda a, characters: _NS.rstrip(a, characters),
    "utf8_is_alnum": _NS.isalnum, "utf8_is_alpha": _NS.isalpha,
    "utf8_is_decimal": _NS.isdecimal, "utf8_is_digit": _NS.isdigit,
    "utf8_is_numeric": _NS.isnumeric, "utf8_is_lower": _NS.islower,
    "utf8_is_upper": _NS.isupper, "utf8_is_space": _NS.isspace,
    "utf8_is_title": _NS.istitle, "ascii_is_title": _NS.istitle,
    "utf8_length": _NS.str_len,
    "starts_with": lambda a, pattern: _NS.startswith(a, pattern),
    "ends_with": lambda a, pattern: _NS.endswith(a, pattern),
    "match_substring": lambda a, pattern, ignore_case=False: _NS.find(
        _NS.lower(a), pattern.lower()) >= 0 if ignore_case
    else _NS.find(a, pattern) >= 0,
    "count_substring": lambda a, pattern, ignore_case=False: _NS.count(
        _NS.lower(a), pattern.lower()) if ignore_case
    else _NS.count(a, pattern),
    "find_substring": lambda a, pattern, ignore_case=False: _NS.find(
        _NS.lower(a), pattern.lower()) if ignore_case
    else _NS.find(a, pattern),
}
# the ascii_* predicates: numpy's form under the values' ASCII mask
NP_ASCII = {f"ascii_is_{k}": f"utf8_is_{k}" for k in (
    "alnum", "alpha", "decimal", "lower", "upper", "space")}
# the transforms the byte pool serves (on p_name), and the others
POOL_TRANSFORMS = (
    ("utf8_upper", {}), ("utf8_lower", {}), ("utf8_swapcase", {}),
    ("utf8_capitalize", {}), ("utf8_title", {}), ("utf8_reverse", {}),
    ("utf8_trim_whitespace", {}), ("utf8_ltrim_whitespace", {}),
    ("utf8_rtrim_whitespace", {}), ("utf8_trim", {"characters": "ab "}),
    ("utf8_ltrim", {"characters": "fr"}),
    ("utf8_rtrim", {"characters": "0123456789 "}),
    ("utf8_lpad", {"width": 60, "padding": "*"}),
    ("utf8_rpad", {"width": 40}),
    ("utf8_center", {"width": 64, "padding": "-"}),
    ("utf8_slice_codeunits", {"start": 0, "stop": 5}),
    ("utf8_slice_codeunits", {"start": 6, "stop": 12}))
HOST_TRANSFORMS = (
    ("binary_reverse", {}), ("binary_repeat", {"num_repeats": 2}),
    ("utf8_zero_fill", {"width": 30}), ("utf8_normalize", {"form": "NFKD"}),
    ("binary_slice", {"start": 1, "stop": 9}),
    ("utf8_slice_codeunits", {"start": 0, "stop": None, "step": 2}),
    ("utf8_replace_slice", {"start": 0, "stop": 5, "replacement": "X"}),
    ("binary_replace_slice", {"start": 2, "stop": 4, "replacement": b"--"}),
    ("replace_substring", {"pattern": "BRASS", "replacement": "brass"}),
    ("replace_substring_regex", {"pattern": "[AEIOU]", "replacement": "_"}))
STRING_PREDICATES = tuple(
    (n, {}) for n in STR_ORACLES if "_is_" in n or n in (
        "string_is_ascii", "utf8_length", "binary_length")) + (
    ("match_substring", {"pattern": "green"}),
    ("match_substring", {"pattern": "GREEN", "ignore_case": True}),
    ("starts_with", {"pattern": "forest"}), ("ends_with", {"pattern": "e"}),
    ("match_like", {"pattern": "%red%"}),
    ("match_like", {"pattern": "f_rest%"}),
    ("count_substring", {"pattern": "e"}),
    ("count_substring", {"pattern": "re"}),
    ("count_substring", {"pattern": ""}),
    ("find_substring", {"pattern": "red"}),
    ("find_substring", {"pattern": "RED", "ignore_case": True}),
    ("match_substring_regex", {"pattern": "^(green|red) "}),
    ("count_substring_regex", {"pattern": "[aeiou]"}),
    ("find_substring_regex", {"pattern": "r[aeiou]d"}))
# the string columns: (table, column)
STRING_COLUMNS = {"p_name": ("part", "p_name"), "p_type": ("part", "p_type"),
                  "c_comment": ("customer", "c_comment")}


def string_calls():
    """(function, column, options) of the strings_pool path."""
    return ([(fn, "p_name", o) for fn, o in POOL_TRANSFORMS]
            + [(fn, "p_type", o) for fn, o in POOL_TRANSFORMS
               + HOST_TRANSFORMS]
            + [(fn, c, o) for c in STRING_COLUMNS
               for fn, o in STRING_PREDICATES])


def strings_inputs(tables):
    """part with ``sep`` (a dictionary column of one value, "-", made on
    the card), customer, and the string columns' values as numpy arrays
    for the oracles."""
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.device.column import DeviceBatch, DeviceColumn
    from arrow_tpu_torch.types import Field, Schema
    part = tables["part"]
    sep = DeviceColumn(torch.zeros(part.capacity, dtype=torch.int32,
                                   device=part.row_count.device), None,
                       T.dictionary(T.int32(), T.string()), ("-",))
    part = DeviceBatch(Schema(part.schema.fields + [Field("sep", sep.type)]),
                       part.columns + [sep], part.row_count)
    batches = {"part": part, "customer": tables["customer"]}
    return {**batches, "arrays": {
        name: _str_arrays(batches[t].column(c))
        for name, (t, c) in STRING_COLUMNS.items()}}


def _string_oracle(check, label, got, col, n, fn, opts, arrays):
    """A str -> str result against Python's function of each value (the
    new dictionary in order of first appearance, the codes remapped), a
    str -> bool or int result against Python's table; numpy's form of
    the function where it has one (``arrays``: the values as a str array
    and their ASCII mask, or None)."""
    if arrays is not None and (fn in NP_ORACLES or fn in NP_ASCII):
        values, ascii_mask = arrays
        if fn in NP_ASCII:
            vals = ascii_mask & NP_ORACLES[NP_ASCII[fn]](values)
        else:
            vals = NP_ORACLES[fn](values, **opts)
        if got.dictionary is not None:
            vals = vals.tolist()
    else:
        vals = list(map(functools.partial(STR_ORACLES[fn], **opts),
                        col.dictionary))
    if got.dictionary is None:
        check.values(label, got, np.asarray(vals), col.values[:n].long(),
                     col.validity)
        return
    first = dict.fromkeys(vals)
    if len(first) == len(vals):
        remap = np.arange(len(vals))
    else:
        index = {v: i for i, v in enumerate(first)}
        remap = np.fromiter(map(index.__getitem__, vals), dtype=np.int64,
                            count=len(vals))
    check.host(label + " dictionary", got.dictionary == tuple(first))
    check.values(label, got, remap, col.values[:n].long(), col.validity)


def _str_arrays(col):
    """A dictionary without nulls as a numpy str array and its values'
    ASCII mask (None for a dictionary with a null slot)."""
    if None in col.dictionary:
        return None
    return (np.array(col.dictionary, dtype=str),
            np.fromiter(map(str.isascii, col.dictionary), dtype=np.bool_,
                        count=len(col.dictionary)))


def strings_pool_run(s, check=None):
    """Every call of ``string_calls()`` and the product of p_brand,
    p_container and sep; with ``check`` each result is held against its
    oracle as soon as it is made (and dropped)."""
    part = s["part"]
    for fn, name, opts in string_calls() + [
            ("binary_join_element_wise", None, {})]:
        batch = part if name != "c_comment" else s["customer"]
        ctx = _context(batch)
        if name is None:
            args = [part.column(k)
                    for k in ("p_brand", "p_container", "sep")]
        else:
            args = [batch.column(STRING_COLUMNS[name][1])]
        got = _call(ctx, fn, *args, **opts)
        if check is None:
            continue
        check.start(got)
        label = _label(fn, [name or "p_brand, p_container, sep"], opts)
        n = int(batch.row_count)
        if name is not None:
            _string_oracle(check, label, got, args[0], n, fn, opts,
                           s["arrays"][name])
        else:
            brand, cont, _ = args
            vals = tuple(b + "-" + c for b in brand.dictionary
                         for c in cont.dictionary)
            codes = brand.values[:n].long() * len(cont.dictionary) \
                + cont.values[:n].long()
            check.host(label + " dictionary", got.dictionary == vals)
            check.values(label, got, np.arange(len(vals)), codes)
        check.stop()
    return check


def pool_and_host_tiers(s):
    """utf8_upper and a slice of p_name on the byte pool and on the host
    tier: the same dictionary and codes."""
    from arrow_tpu_torch.compute import device_strings
    part = s["part"]
    col, ctx = part.column("p_name"), _context(part)
    out = []
    for fn, opts in (("utf8_upper", {}),
                     ("utf8_slice_codeunits", {"start": 0, "stop": 5})):
        pool = _call(ctx, fn, col, **opts)
        gate = device_strings.DEVICE_STRINGS_MIN
        device_strings.DEVICE_STRINGS_MIN = 1 << 62
        try:
            host = _call(ctx, fn, col, **opts)
        finally:
            device_strings.DEVICE_STRINGS_MIN = gate
        out.append(pool.dictionary == host.dictionary
                   and torch.equal(pool.values, host.values))
    return out


# strings_plan: lineitem joined to part, a regex filter, two string keys
def strings_plan(lineitem, s, key, ac=None):
    """lineitem joined to part (with the bloom), the parts whose name
    starts with green or red in containers of up to 7 characters, revenue
    by ``key``: "type" (the upper case of p_type's first 5 characters, 6
    values) or "mfgr_container" (p_mfgr, p_container and sep joined, 200
    values)."""
    ac = _acero(ac)
    D, f, call = ac.Declaration, ac.field, ac.Expression.call
    joined = D("hashjoin", ac.HashJoinNodeOptions(
        "inner", left_keys=["l_partkey"], right_keys=["p_partkey"]),
        inputs=[D("table_source", ac.TableSourceNodeOptions(lineitem)),
                D("table_source", ac.TableSourceNodeOptions(s["part"]))])
    keys = {"type": call("utf8_upper", call(
                "utf8_slice_codeunits", f("p_type"), start=0, stop=5)),
            "mfgr_container": call("binary_join_element_wise", f("p_mfgr"),
                                   f("p_container"), f("sep"))}
    return D.from_sequence([
        joined,
        D("filter", ac.FilterNodeOptions(
            call("match_substring_regex", f("p_name"),
                 pattern="^(green|red) ")
            & (call("utf8_length", f("p_container")) <= 7))),
        D("project", ac.ProjectNodeOptions(
            [keys[key], f("l_extendedprice") * (1.0 - f("l_discount"))],
            ["key", "revenue"])),
        D("aggregate", ac.AggregateNodeOptions(
            [("revenue", "hash_sum", None, "revenue")], keys=["key"])),
    ])


def strings_plan_run(lineitem, s):
    return {key: strings_plan(lineitem, s, key).to_table()
            for key in ("type", "mfgr_container")}


def strings_plan_oracle(c):
    """Revenue by each key of the kept parts' lineitems, by numpy over the
    downloaded columns and Python over the dictionaries."""
    names = c["p_name:dict"]
    green_red = np.fromiter((re.match("(green|red) ", v) is not None
                             for v in names), dtype=np.bool_,
                            count=len(names))
    short = np.array([len(v) <= 7 for v in c["p_container:dict"]])
    part = c["l_partkey"] - 1
    keep = green_red[c["p_name"][part]] & short[c["p_container"][part]]
    revenue = (c["l_extendedprice"] * (1.0 - c["l_discount"]))[keep]
    out = {}
    type_key = np.array([v[:5].upper() for v in c["p_type:dict"]])
    mfgrs, conts = c["p_mfgr:dict"], c["p_container:dict"]
    pair = np.array([m + "-" + k for m in mfgrs for k in conts])
    for key, labels in (
            ("type", type_key[c["p_type"][part[keep]]]),
            ("mfgr_container", pair[c["p_mfgr"][part[keep]] * len(conts)
                                    + c["p_container"][part[keep]]])):
        groups, inv = np.unique(labels, return_inverse=True)
        out[key] = dict(zip(groups.tolist(), np.bincount(
            inv.reshape(-1), weights=revenue, minlength=len(groups))))
    return out, int(keep.sum())


def strings_plan_columns(li, s):
    part = s["part"]
    c = _host_columns(li, ["l_partkey", "l_extendedprice", "l_discount"])
    c.update(_host_columns(part, ["p_partkey", "p_name", "p_type",
                                  "p_mfgr", "p_container"]))
    _check_keys(c, "p_partkey")
    for k in ("p_name", "p_type", "p_mfgr", "p_container"):
        c[k + ":dict"] = part.column(k).dictionary
    return c


def check_strings_plan(c, result):
    want, kept = strings_plan_oracle(c)
    for key, w in want.items():
        got = dict(zip(result[key]["key"], result[key]["revenue"]))
        if sorted(got) != sorted(w):
            raise AssertionError(f"strings_plan by {key}: keys "
                                 f"{sorted(got)[:5]} != {sorted(w)[:5]}")
        g = np.array([got[k] for k in sorted(w)])
        _expect_close(f"strings_plan revenue by {key}", g,
                      np.array([w[k] for k in sorted(w)]))
    return (f"{kept} lineitem rows kept, {len(want['type'])} and "
            f"{len(want['mfgr_container'])} groups, keys exact, revenue "
            f"within rtol {RTOL_F64}")


class FunctionPath(NamedTuple):
    """One path of phase 3h: ``run(inputs, check)`` hands each result to
    ``check`` as it is made, or gives results ``verify(columns,
    results)`` holds against numpy. Phase 4 takes the best of ``reps - 1``
    walls after a warm-up."""
    name: str
    run: object
    launches: dict
    verify: object = None
    reps: int = 6


# Launches a run at SF10, reckoned from the code. temporal_fields and
# strings_pool: element-wise arithmetic, gathers by codes and the byte
# pool's transforms (its rows grouped by a sort), no kernel. temporal_plan:
# the filter compacts lineitem once. strings_plan, twice (one plan a key):
# lineitem probes part with the bloom (2 hash32 launches and a compaction,
# 60,012,544 >= 4 x 2,000,896) and the unique-build compaction; the filter
# folds into the aggregate; revenue by the type key (7 slots) and by the
# manufacturer and container key (201 slots, K3's range) takes
# grouped_sum.
# Q22 as in phase 3d.
STRING_PATHS = (
    # the two sweeps of hundreds of calls each: one run (phase 3h's run
    # warmed them)
    FunctionPath("temporal_fields",
                 lambda i, check: temporal_fields_run(i["temporal"], check),
                 _launches(0, 0, 0), reps=1),
    FunctionPath("temporal_plan",
                 lambda i, check: temporal_plan(i["lineitem"]).to_table(),
                 _launches(1, 0, 0), check_temporal_plan),
    FunctionPath("strings_pool",
                 lambda i, check: strings_pool_run(i["strings"], check),
                 _launches(0, 0, 0), reps=1),
    FunctionPath("strings_plan",
                 lambda i, check: strings_plan_run(i["lineitem"],
                                                   i["strings"]),
                 _launches(4, 4, 2), check_strings_plan),
)


def _timed_verify(verify, cols, result):
    t0 = time.perf_counter()
    return verify(cols, result), time.perf_counter() - t0


def strings_inputs_all(tables, typed):
    """Phase 3h's inputs: Q1's lineitem, the temporal columns and the
    string tables."""
    return {"lineitem": tables["lineitem"],
            "temporal": temporal_inputs(tables["lineitem"], typed),
            "strings": strings_inputs(tables)}


def phase_strings_kernels(h):
    """The kernels on phase 3h's paths against their plain versions at the
    shapes the paths give them: the compaction of temporal_plan's filter
    (all 15 columns of lineitem under its mask) bit for bit; the hash of
    strings_plan's join keys (the strided int32 halves of l_partkey's and
    p_partkey's equality words) bit for bit; the grouped sum of its
    revenue by the type key (7 slots) and by the brand and container key
    (201 slots, K3's range) over lineitem's capacity, within RTOL_F64.
    Launches here are outside every path's count."""
    from arrow_tpu_torch.compute.hashing import int64_halves
    from arrow_tpu_torch.compute.keys import equality_word
    from arrow_tpu_torch.kernels.grouped_sum import (grouped_sum,
                                                     grouped_sum_plain)
    from arrow_tpu_torch.kernels.hash32 import hash32, hash32_plain
    li, part = h["lineitem"], h["strings"]["part"]
    ctx = _context(li)
    mask = temporal_plan(li).inputs[0].options.filter_expression.evaluate(
        li, ctx)
    keep = mask.values & mask.valid_mask(ctx.row_mask())
    compact_case(f"compact (temporal_plan filter, n={keep.numel()})", keep,
                 [c.values for c in li.columns])
    errs = {"compact": 0.0}   # bit for bit, or compact_case raised
    for batch, key in ((li, "l_partkey"), (part, "p_partkey")):
        words = int64_halves(equality_word(batch.column(key)))
        errs["hash32 " + key] = check_bit_exact(
            f"hash32 {key} halves n={words[0].numel()}", [hash32(words)],
            [hash32_plain(words)])
    rows = li.column("l_partkey").values.long() - 1
    rows = rows.clamp(0, part.capacity - 1)
    revenue = li.column("l_extendedprice").values \
        * (1.0 - li.column("l_discount").values)
    live = ctx.row_mask()
    for name, codes, s in (
            ("type key", part.column("p_type").values, 7),
            ("manufacturer and container key",
             part.column("p_mfgr").values * 40
             + part.column("p_container").values, 201)):
        gid = torch.where(live, codes.long()[rows] % (s - 1), s - 1) \
            .to(torch.int32)
        v = torch.where(live, revenue, 0.0)
        errs[f"grouped_sum S={s}"] = check_close(
            f"grouped_sum ({name}, n={v.numel()} S={s})",
            grouped_sum(v, gid, s), grouped_sum_plain(v, gid, s), RTOL_F64)
    torch.cuda.synchronize()
    return errs


def q22_on_the_pool(tables):
    """Q22 with the byte-pool cache emptied first: its result against
    ``q22_oracle``, its launches as in phase 3d, and c_phone's dictionary
    pooled by the run (its slice took the pool tier)."""
    from arrow_tpu_torch.compute import device_strings
    from arrow_tpu_torch.platform_check import self_check
    q22 = next(q for q in FULL if q.name == "Q22")
    customer = tables["customer"]
    device_strings.clear_pools()
    base = memory_mark()
    zero_launches()
    self_check()
    t1 = time.perf_counter()
    result = suite_plan(q22, tables).to_table()
    log(f"Q22 (pool tier) first run {time.perf_counter() - t1:.3f} s")
    launches = read_launches()
    log_peak("Q22 (pool tier)", base)
    check_launches("Q22 (pool tier)", launches, q22.launches)
    c = {"customer": _host_columns(customer, ["c_custkey", "c_phone",
                                              "c_acctbal"]),
         "orders": _host_columns(tables["orders"], ["o_custkey"])}
    want, _ = q22.oracle(tables, c)
    check_result("Q22 (pool tier)", result, want)
    if not device_strings.is_pooled(customer.column("c_phone").dictionary,
                                    customer.row_count.device):
        raise AssertionError("Q22's slice of c_phone did not take the "
                             "byte pool")
    log("Q22 (pool tier) matches its oracle; c_phone's slice took the byte "
        "pool")
    return launches


def phase_strings(tables, typed):
    """Phase 3h: the temporal and string functions at SF10, each path with
    every launch count set to 0 just before its run and read just after,
    against its oracle (the function sweeps result by result on the card,
    the plans by numpy in a thread each), with the card's peak memory over
    the run; the pool and host tiers of p_name's transforms; Q22 on the
    pool tier; strings_plan run twice for the same bits. Returns
    (launches by path, the inputs)."""
    from arrow_tpu_torch.platform_check import self_check
    log(f"== phase 3h: temporal and string functions at SF{SF:g}")
    t0 = time.perf_counter()
    h = strings_inputs_all(tables, typed)
    cols = {"temporal_plan": _host_columns(tables["lineitem"], [
        "l_shipdate", "l_commitdate", "l_receiptdate", "l_orderkey",
        "l_extendedprice"]),
        "strings_plan": strings_plan_columns(tables["lineitem"],
                                             h["strings"])}
    log(f"inputs made, distinct values found and columns downloaded in "
        f"{time.perf_counter() - t0:.1f} s")
    errs = phase_strings_kernels(h)
    launches, failures, checks = {}, [], {}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for path in STRING_PATHS:
            base = memory_mark()
            zero_launches()
            self_check()
            check = None if path.verify else CardCheck()
            t1 = time.perf_counter()
            result = path.run(h, check)
            torch.cuda.synchronize()
            log(f"{path.name} first run {time.perf_counter() - t1:.3f} s"
                + (" (its checks included)" if check else ""))
            launches[path.name] = read_launches()
            log_peak(path.name, base)
            checks[path.name] = pool.submit(
                _timed_verify, path.verify, cols[path.name], result) \
                if path.verify else check
            del result
        for path in STRING_PATHS:
            try:
                check_launches(path.name, launches[path.name], path.launches)
                if path.verify:
                    msg, seconds = checks[path.name].result()
                    log(f"{path.name} matches its oracle: {msg} (oracle "
                        f"{seconds:.1f} s)")
                    continue
                bad = checks[path.name].failures()
                if bad:
                    raise AssertionError(f"{len(bad)} results differ: "
                                         f"{bad[:8]}")
                log(f"{path.name}: all {len(checks[path.name].labels)} "
                    "checks match their oracles (oracles and checks "
                    f"{checks[path.name].seconds:.1f} s of its first run)")
            except AssertionError as exc:
                log(f"  {path.name} FAILED: {exc}")
                failures.append(path.name)
    same = pool_and_host_tiers(h["strings"])
    log(f"p_name's utf8_upper and slice on the pool and the host tier: "
        f"same dictionary and codes {same}")
    if not all(same):
        failures.append("pool and host tiers")
    launches["Q22 (pool tier)"] = q22_on_the_pool(tables)
    first, second = (strings_plan_run(h["lineitem"], h["strings"])
                     for _ in "ab")
    check_bit_exact("phase 3h strings_plan revenue, two runs", [
        torch.tensor(first[k]["revenue"]) for k in first], [
        torch.tensor(second[k]["revenue"]) for k in first], "the first run")
    if failures:
        raise AssertionError(f"phase 3h failed for {failures}")
    log(f"phase 3h: {time.perf_counter() - t0:.1f} s (kernels against "
        f"their plain versions: max_abs_err {errs!r})")
    return launches, h


# --- phase 3i: the rest of compute -----------------------------------------

REST_SEED = 17
REST_NULLS = 0.1                # the share of the customer segment's nulls
REST_SPECIALS = 0.01            # each of NaN, -0.0 and 0.0 in the f64 column
HASH_COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate")
SEGMENT_SET = ["MACHINERY", None, "BUILDING", "NOT A SEGMENT"]
SHIPMODE_SET = ["MAIL", None, "SHIP", "TRUCK", "NOT A MODE"]
REST_QUANTILES = [0.1, 0.5, 0.9]
WINSOR = (0.05, 0.95)
RICH = 5_000.0                  # if_else's balance for the segment
# 8 x 5 x 4 = 160 perfect-hash slots: the grouped-sum kernel's K3 range
K3_KEYS = ["l_shipmode", "l_shipinstruct", "l_returnflag"]
FLAG_KEYS = ["l_returnflag", "l_linestatus"]
_XXH = (2246822519, 3266489917, 668265263, 374761393)  # PRIME32_2 .. _5


def rest_inputs(tables, typed, seed=REST_SEED):
    """Phase 3i's inputs: Q1's lineitem and phase 3f's typed lineitem (its
    12 columns for the hash, l_suppkey with its 1% nulls for the fills),
    an f64 column (l_extendedprice with ``REST_SPECIALS`` each of NaN, -0.0
    and 0.0, and 1% nulls), l_orderkey in order (lineitem as TPC-H's
    dbgen writes it: each order's lines together), a nullable mask
    (``l_quantity > 45``, 5% null) and its replacements, ``round_binary``'s digits (l_linenumber
    - 1: 0 to 6), and customer's phone and balance beside its segment
    with ``REST_NULLS`` nulls and a column with an empty dictionary (every
    row null); the draws from a generator seeded with ``seed`` on the
    tables' device."""
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.device.column import DeviceBatch, DeviceColumn
    from arrow_tpu_torch.types import Field, Schema
    li, t = tables["lineitem"], typed["lineitem"]
    dev = t.row_count.device
    cap = t.capacity
    gen = torch.Generator(device=dev).manual_seed(seed)
    price = li.column("l_extendedprice").values
    r = torch.rand(cap, generator=gen, device=dev)
    special = torch.where(r < REST_SPECIALS, float("nan"), torch.where(
        r < 2 * REST_SPECIALS, -0.0, torch.where(
            r < 3 * REST_SPECIALS, 0.0, price)))
    f64 = DeviceColumn(special, torch.rand(cap, generator=gen, device=dev)
                       >= 0.01, T.float64())
    big = _call(_context(t), "greater", t.column("l_quantity"), 45)
    mask = DeviceColumn(big.values, torch.rand(cap, generator=gen,
                                               device=dev) >= 0.05, big.type)
    digits = _call(_context(t), "subtract", t.column("l_linenumber"), 1)
    okey = li.column("l_orderkey")
    n = int(li.row_count)
    in_order = DeviceColumn(torch.cat([torch.sort(okey.values[:n]).values,
                                       okey.values[n:]]), None, okey.type)
    cust = tables["customer"]
    ccap = cust.capacity
    seg = cust.column("c_mktsegment")
    cols = {
        "c_phone": cust.column("c_phone"),
        "c_acctbal": cust.column("c_acctbal"),
        "c_segment": DeviceColumn(seg.values, torch.rand(
            ccap, generator=gen, device=dev) >= REST_NULLS, seg.type,
            seg.dictionary),
        "c_empty": DeviceColumn(torch.zeros(ccap, dtype=torch.int32,
                                            device=dev),
                                torch.zeros(ccap, dtype=torch.bool,
                                            device=dev), seg.type, ())}
    customer = DeviceBatch(Schema([Field(k, c.type) for k, c in
                                   cols.items()]), list(cols.values()),
                           cust.row_count)
    return {"lineitem": li, "typed": t, "f64": f64, "mask": mask,
            "digits": digits, "okey_in_order": in_order,
            "customer": customer}


def rest_columns(s):
    """The host copies phase 3i's oracles read: the typed lineitem's
    columns (``typed_columns``), Q1's lineitem's, the f64 column, the
    mask, the digits and the customer columns (strings decoded)."""
    from arrow_tpu_torch.device.column import DeviceBatch
    from arrow_tpu_torch.types import Field, Schema
    li = s["lineitem"]
    n = int(li.row_count)
    c = typed_columns({"lineitem": s["typed"]})
    c["n"] = n
    c["plain"] = typed_columns({"lineitem": li.select([
        "l_orderkey", "l_returnflag", "l_linestatus", "l_shipmode",
        "l_shipinstruct", "l_extendedprice", "l_tax", "l_discount",
        "l_quantity", "l_shipdate"])})
    extra = {k: s[k] for k in ("f64", "mask", "digits", "okey_in_order")}
    c["extra"] = typed_columns({"x": DeviceBatch(
        Schema([Field(k, v.type) for k, v in extra.items()]),
        list(extra.values()), li.row_count)})
    cust = typed_columns({"customer": s["customer"]})
    for k in ("c_phone", "c_segment"):
        cust[k + ":str"] = np.array(cust[k + ":dict"], dtype=object)
    c["customer"] = cust
    return c


def _np_hash32(words):
    """xxhash32 of uint32 words a row with the combiner, from the
    reference's constants (its ``hashing.py``), in numpy."""
    p2, p3, p4, p5 = (np.uint32(x) for x in _XXH)
    out = None
    for w in words:
        h = np.uint32(p5 + np.uint32(4)) + w * p3
        h = ((h << np.uint32(17)) | (h >> np.uint32(15))) * p4
        h ^= h >> np.uint32(15)
        h *= p2
        h ^= h >> np.uint32(13)
        h *= p3
        h ^= h >> np.uint32(16)
        out = h if out is None else out ^ (
            h + np.uint32(0x9E3779B9) + (out << np.uint32(6))
            + (out >> np.uint32(2)))
    return out


def _np_words(v):
    """A column's host values as the reference's uint32 words: a 64-bit
    value low word first (an f64 by its bits, every NaN one quiet NaN),
    an f32 by its bits, an f16 through f32, a narrower integer widened
    by its sign (unsigned ones by zero)."""
    if v.dtype == np.float64:
        b = v.view(np.uint64).copy()
        b[np.isnan(v)] = 0x7FF8000000000000
        v = b
    if v.itemsize == 8:
        u = v.view(np.uint64)
        return [(u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (u >> np.uint64(32)).astype(np.uint32)]
    if v.dtype.kind == "f":
        return [v.astype(np.float32).view(np.uint32)]
    return [v.astype(np.int64).astype(np.uint32)]


def hash_types_run(s):
    ctx = _context(s["typed"])
    cols = [s["typed"].column(k) for k in HASH_COLUMNS] + [s["f64"]]
    return [_call(ctx, "hash32", col) for col in cols]


def check_hash_types(c, r):
    n = c["n"]
    names = HASH_COLUMNS + ("f64",)
    for name, got in zip(names, r):
        v = c["extra"][name] if name == "f64" else c[name]
        want = _np_hash32(_np_words(v))
        src = c["extra"] if name == "f64" else c
        h, valid = _host(got, n)
        _expect_equal(f"hash32({name}), null rows included", h, want)
        want_valid = src.get(name + ":valid")
        _expect(f"hash32({name}) validity", (valid is None) == (
            want_valid is None) and (valid is None or np.array_equal(
                valid, want_valid)))
        _expect(f"hash32({name}) type", repr(got.type) == "uint32")
    f = c["extra"]["f64"]
    return (f"13 columns bit-exact ({int(np.isnan(f).sum())} NaN, "
            f"{int(((f == 0) & np.signbit(f)).sum())} -0.0 rows)")


def vector_misc_run(s):
    t, li = s["typed"], s["lineitem"]
    ctx = _context(t)
    supp = t.column("l_suppkey")
    return {
        "forward": _call(ctx, "fill_null_forward", supp),
        "backward": _call(ctx, "fill_null_backward", supp),
        "runs_order": _call(ctx, "run_end_encode", s["okey_in_order"]),
        "runs_flag": _call(ctx, "run_end_encode", li.column("l_returnflag")),
        "replaced": _call(ctx, "replace_with_mask", supp, s["mask"],
                          t.column("l_partkey")),
        "mode_index": _call(ctx, "index_in", li.column("l_shipmode"),
                            value_set=SHIPMODE_SET),
        "line_in": _call(ctx, "is_in_meta_binary", t.column("l_linenumber"),
                         value_set=[1, 7]),
        "line_index": _call(ctx, "index_in_meta_binary",
                            t.column("l_linenumber"), value_set=[3, None, 1])}


def _fill_oracle(v, valid, forward):
    idx = np.arange(len(v))
    if forward:
        src = np.maximum.accumulate(np.where(valid, idx, -1))
    else:
        src = np.minimum.accumulate(np.where(valid, idx, len(v))[::-1])[::-1]
    has = (src >= 0) & (src < len(v))
    return v[np.where(has, src, 0)], has


def _runs_oracle(v):
    new = np.ones(len(v), dtype=np.bool_)
    new[1:] = v[1:] != v[:-1]
    starts = np.flatnonzero(new)
    return np.append(starts[1:], len(v)), v[starts]


def _index_oracle(labels, codes, valid, value_set):
    """The reference's index_in over a column's values: the first index in
    the set, a null row the set's first null, else null."""
    first = {}
    for i, x in enumerate(value_set):
        if x is not None and x not in first:
            first[x] = i
    table = np.array([first.get(x, -1) for x in labels], dtype=np.int64)
    idx = table[codes]
    null_idx = next(i for i, x in enumerate(value_set) if x is None)
    if valid is None:
        valid = np.ones(len(codes), dtype=np.bool_)
    idx = np.where(valid, idx, null_idx)
    ok = idx >= 0
    return np.where(ok, idx, 0), ok


def _expect_column(name, col, n, values, valid=None):
    """A result column's first ``n`` values where valid, and validity."""
    got, got_valid = _host(col, n)
    if valid is None:
        _expect(f"{name} validity", got_valid is None or bool(
            got_valid.all()))
        _expect_equal(name, got, values)
        return
    if got_valid is None:
        got_valid = np.ones(n, dtype=np.bool_)
    _expect_equal(f"{name} validity", got_valid, valid)
    _expect_equal(name, got[valid], values[valid])


def check_vector_misc(c, r):
    n = c["n"]
    supp, sv = c["l_suppkey"], c["l_suppkey:valid"]
    for name in ("forward", "backward"):
        want, has = _fill_oracle(supp, sv, name == "forward")
        _expect_column(f"fill_null_{name}", r[name], n, want, has)
    runs = {}
    for name, col in (("runs_order", c["extra"]["okey_in_order"]),
                      ("runs_flag", c["plain"]["l_returnflag"])):
        ends, values = _runs_oracle(col)
        got = r[name]
        k = int(got["run_ends"].count)
        _expect(f"run_end_encode {name} count", k == len(ends),
                f"({k}, {len(ends)})")
        _expect_column(f"{name} ends", got["run_ends"].column, k,
                       ends.astype(np.int32))
        _expect_column(f"{name} values", got["values"].column, k, values,
                       np.ones(k, dtype=np.bool_))
        runs[name] = k
    m, mv = c["extra"]["mask"], c["extra"]["mask:valid"]
    take = m & mv
    k = np.cumsum(take) - 1
    want = np.where(take, c["l_partkey"][np.clip(k, 0, n - 1)], supp)
    _expect_column("replace_with_mask", r["replaced"].column, n, want,
                   np.where(take, True, sv) & mv)
    p = c["plain"]
    idx, ok = _index_oracle(p["l_shipmode:dict"], p["l_shipmode"], None,
                            SHIPMODE_SET)
    _expect_column("index_in(l_shipmode)", r["mode_index"], n,
                   idx.astype(np.int32), ok)
    line = c["l_linenumber"]
    _expect_column("is_in_meta_binary", r["line_in"], n,
                   (line == 1) | (line == 7))
    want = np.select([line == 3, line == 1], [0, 2], -1)
    _expect_column("index_in_meta_binary", r["line_index"], n,
                   np.maximum(want, 0).astype(np.int32), want >= 0)
    return (f"{runs['runs_order']} order runs, {runs['runs_flag']} flag "
            f"runs, {int((~sv).sum())} suppliers filled")


def math_stats_run(s):
    li = s["lineitem"]
    ctx = _context(li)
    price = li.column("l_extendedprice")
    return {
        "hypot": _call(ctx, "hypot", price, li.column("l_tax")),
        "round": _call(ctx, "round_binary", price, s["digits"]),
        "nonzero": _call(ctx, "indices_nonzero", li.column("l_discount")),
        "winsor": _call(ctx, "winsorize", price, lower_limit=WINSOR[0],
                        upper_limit=WINSOR[1]),
        "rank_q": _call(ctx, "rank_quantile", price),
        "rank_n": _call(ctx, "rank_normal", price),
        "tdigest": _call(ctx, "tdigest", price, q=REST_QUANTILES)}


def _sorted_at(uniq, ends, pos):
    """The value at sorted position ``pos`` of values given as sorted
    distinct values and their cumulative counts."""
    return uniq[np.searchsorted(ends, pos, side="right")]


def check_math_stats(c, r):
    import statistics
    n = c["n"]
    p = c["plain"]
    price = p["l_extendedprice"]
    _expect_close("hypot", _host(r["hypot"], n)[0],
                  np.hypot(price, p["l_tax"]))
    scale = 10.0 ** c["extra"]["digits"].astype(np.float64)
    _expect_close("round_binary", _host(r["round"], n)[0],
                  np.round(price * scale) / scale)
    nz = np.flatnonzero(p["l_discount"] != 0)
    got = r["nonzero"]
    _expect(f"indices_nonzero count", int(got.count) == len(nz))
    _expect_equal("indices_nonzero", _host(got.column, len(nz))[0], nz)
    uniq, inv, counts = np.unique(price, return_inverse=True,
                                  return_counts=True)
    ends = np.cumsum(counts)
    lo = _sorted_at(uniq, ends, np.ceil(WINSOR[0] * (n - 1)))
    hi = _sorted_at(uniq, ends, np.floor(WINSOR[1] * (n - 1)))
    _expect_equal("winsorize", _host(r["winsor"], n)[0],
                  np.clip(price, lo, hi))
    rank = ((ends - counts + 1) + ends) * 0.5
    q = (rank - 0.5) / n
    _expect_equal("rank_quantile", _host(r["rank_q"].column, n)[0], q[inv])
    # the probit of a sample of the exactly checked quantile ranks
    rows = np.arange(0, n, 997)
    normal = np.array([statistics.NormalDist().inv_cdf(x)
                       for x in q[inv[rows]]])
    got = _host(r["rank_n"].column, n)[0][rows]
    _expect(f"rank_normal within {NDTRI_TOL}", bool(
        (np.abs(got - normal) <= NDTRI_TOL * np.maximum(
            np.abs(normal), 1.0)).all()))
    for qi, got, ok in zip(REST_QUANTILES, r["tdigest"].value,
                           r["tdigest"].valid):
        pos = qi * (n - 1)
        a = _sorted_at(uniq, ends, np.floor(pos))
        b = _sorted_at(uniq, ends, np.ceil(pos))
        _expect_close(f"tdigest q={qi}", np.array([float(got)]),
                      np.array([a + (b - a) * (pos - np.floor(pos))]))
        _expect(f"tdigest q={qi} validity", bool(ok))
    return (f"{len(nz)} non-zero discounts, {len(uniq)} distinct prices "
            f"ranked")


def _moment_aggregates():
    return [("l_extendedprice", "hash_skew", None, "skew"),
            ("l_extendedprice", "hash_kurtosis", None, "kurt"),
            ("l_extendedprice", "hash_approximate_median", None, "median"),
            ("l_quantity", "hash_tdigest", {"q": 0.9}, "q90"),
            ("l_quantity", "hash_first_last", None, "qty")]


def grouped_rest_decl(s, keys, ac=None):
    """Q1's lineitem under Q1's filter (folded into the aggregate), the
    five grouped names by ``keys``."""
    ac = _acero(ac)
    D, f = ac.Declaration, ac.field
    names = keys + ["l_extendedprice", "l_quantity"]
    return D.from_sequence([
        D("table_source", ac.TableSourceNodeOptions(s["lineitem"])),
        D("filter", ac.FilterNodeOptions(
            f("l_shipdate") <= SHIPDATE_1998_09_02)),
        D("project", ac.ProjectNodeOptions([f(k) for k in names], names)),
        D("aggregate", ac.AggregateNodeOptions(_moment_aggregates(),
                                               keys=keys))])


def grouped_flags_run(s):
    return grouped_rest_decl(s, FLAG_KEYS).to_table()


def grouped_k3_run(s):
    return grouped_rest_decl(s, K3_KEYS).to_table()


def _groups_in_order(key, keep):
    """The kept rows of each key value, in order of first appearance:
    one stable sort of the kept rows by key."""
    rows = np.flatnonzero(keep)
    order = np.argsort(key[rows], kind="stable")
    sk = key[rows][order]
    bounds = np.flatnonzero(np.diff(sk)) + 1
    groups = np.split(rows[order], bounds)
    return sorted(((int(key[g[0]]), g) for g in groups),
                  key=lambda kg: kg[1][0])


def _linear(x, q):
    """The linear quantile of ``x``, by a partition."""
    pos = q * (len(x) - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    part = np.partition(x, [lo, hi])
    return part[lo] + (part[hi] - part[lo]) * (pos - lo)


def grouped_rest_oracle(c, keys):
    """The five grouped names in numpy, group by group (groups in order of
    first appearance): two-pass f64 moments, medians and quantiles by a
    sort of the group."""
    p = c["plain"]
    keep = p["l_shipdate"] <= SHIPDATE_1998_09_02
    key = np.zeros(c["n"], dtype=np.int64)
    for k in keys:
        key = key * (len(p[k + ":dict"]) + 1) + p[k]
    out = {k: [] for k in keys + ["skew", "kurt", "median", "q90",
                                  "qty_first", "qty_last"]}
    for k, rows in _groups_in_order(key, keep):
        x = p["l_extendedprice"][rows]
        dev = x - x.sum() / len(x)
        m2, m3, m4 = ((dev ** e).sum() for e in (2, 3, 4))
        qty = p["l_quantity"][rows]
        vals = {"skew": np.sqrt(len(x)) * m3 / max(m2, 1e-300) ** 1.5,
                "kurt": len(x) * m4 / max(m2 * m2, 1e-300) - 3.0,
                "median": _linear(x, 0.5), "q90": _linear(qty, 0.9),
                "qty_first": qty[0], "qty_last": qty[-1]}
        rest = k
        for name in reversed(keys):
            size = len(p[name + ":dict"]) + 1
            vals[name] = p[name + ":dict"][rest % size]
            rest //= size
        for name, v in vals.items():
            out[name].append(v)
    return out


def check_grouped_rest(c, result, keys):
    want = grouped_rest_oracle(c, keys)
    for name, w in want.items():
        got = result[name]
        _expect(f"{name}: {len(got)} groups", len(got) == len(w),
                f"(against {len(w)})")
        if isinstance(w[0], str):
            _expect(name, list(got) == list(w))
        else:
            _expect_close(name, np.array(got, dtype=np.float64),
                          np.array(w, dtype=np.float64))
    return f"{len(want['skew'])} groups by {'/'.join(keys)}"


def orders_median_decl(s, ac=None):
    ac = _acero(ac)
    D, f = ac.Declaration, ac.field
    return D.from_sequence([
        D("table_source", ac.TableSourceNodeOptions(s["lineitem"])),
        D("project", ac.ProjectNodeOptions(
            [f("l_orderkey"), f("l_extendedprice")],
            ["l_orderkey", "l_extendedprice"])),
        D("aggregate", ac.AggregateNodeOptions(
            [("l_extendedprice", "hash_approximate_median", None,
              "median")], keys=["l_orderkey"]))])


def orders_median_run(s):
    """The per-order medians left on the device (about 15M groups)."""
    from arrow_tpu_torch.acero.exec import execute_declaration
    return execute_declaration(orders_median_decl(s))


def check_orders_median(c, batch):
    """Each order's median price: the rows stably sorted by order key, the
    orders of each size sorted as the rows of a matrix; the groups in
    order of first appearance."""
    p = c["plain"]
    okey, price = p["l_orderkey"], p["l_extendedprice"]
    order = np.argsort(okey, kind="stable")
    sk = okey[order]
    new = np.ones(len(sk), dtype=np.bool_)
    new[1:] = sk[1:] != sk[:-1]
    starts = np.flatnonzero(new)
    lengths = np.diff(np.append(starts, len(sk)))
    median = np.zeros(len(starts))
    for size in np.unique(lengths):
        at = np.flatnonzero(lengths == size)
        rows = np.sort(price[order[starts[at][:, None] + np.arange(size)]],
                       axis=1)
        lo, hi = rows[:, (size - 1) // 2], rows[:, size // 2]
        median[at] = lo + (hi - lo) * 0.5
    firsts = order[starts]
    by_first = np.argsort(firsts)
    g = int(batch.row_count)
    _expect(f"per-order groups {g}", g == len(starts), f"({len(starts)})")
    got_key, _ = _host(batch.column("l_orderkey"), g)
    _expect_equal("per-order keys in order of first appearance", got_key,
                  sk[starts][by_first])
    got, valid = _host(batch.column("median"), g)
    _expect_close("per-order hash_approximate_median", got,
                  median[by_first])
    _expect("per-order medians valid", valid is None or bool(valid.all()))
    return f"{g} orders"


def customer_decls(s, ac=None):
    """(customer's balance by phone country code, the rows): a filter on a
    comparison against the empty dictionary (null on every row) or a
    positive balance; the code ``cast(utf8_slice_codeunits(c_phone, 0, 2),
    int32)``; is_null, is_valid, is_nan and index_in of the nullable
    segment; coalesce and if_else of the segment and the code's string
    (two dictionaries)."""
    ac = _acero(ac)
    D, f, call = ac.Declaration, ac.field, ac.Expression.call
    source = D("table_source", ac.TableSourceNodeOptions(s["customer"]))
    keep = D("filter", ac.FilterNodeOptions(
        (f("c_empty") == "x") | (f("c_acctbal") > 0.0)))
    code_str = call("utf8_slice_codeunits", f("c_phone"), start=0, stop=2)
    project = D("project", ac.ProjectNodeOptions(
        [call("cast", code_str, to_type="int32"), f("c_acctbal"),
         call("is_null", f("c_segment")), call("is_valid", f("c_segment")),
         call("is_nan", f("c_segment")),
         call("index_in", f("c_segment"), value_set=SEGMENT_SET),
         call("coalesce", f("c_segment"), code_str),
         call("if_else", f("c_acctbal") > RICH, f("c_segment"), code_str)],
        ["code", "c_acctbal", "seg_null", "seg_valid", "seg_nan",
         "seg_index", "seg_or_code", "rich_seg"]))
    grouped = D.from_sequence([source, keep, project, D(
        "aggregate", ac.AggregateNodeOptions(
            [(None, "count_all", None, "n"),
             ("c_acctbal", "hash_sum", None, "balance"),
             ("seg_null", "hash_sum", None, "nulls"),
             ("seg_index", "hash_count", None, "indexed")],
            keys=["code"]))])
    rows = D.from_sequence([source, keep, project])
    return grouped, rows


def customer_run(s):
    from arrow_tpu_torch.acero.exec import execute_declaration
    grouped, rows = customer_decls(s)
    return {"grouped": grouped.to_table(), "rows": execute_declaration(rows)}


def _strings_of(col, n):
    """A dictionary column's first ``n`` values as an object array, None
    where null."""
    codes, valid = _host(col, n)
    out = np.array(col.dictionary, dtype=object)[codes]
    if valid is not None:
        out[~valid] = None
    return out


def check_customer(c, r):
    cu = c["customer"]
    keep = cu["c_acctbal"] > 0.0
    phone = cu["c_phone:str"][cu["c_phone"]][keep]
    code_str = np.array([x[:2] for x in phone], dtype=object)
    code = code_str.astype(np.int64)
    seg = cu["c_segment:str"][cu["c_segment"]][keep].copy()
    sv = cu["c_segment:valid"][keep]
    seg[~sv] = None
    bal = cu["c_acctbal"][keep]
    idx, ok = _index_oracle(cu["c_segment:dict"], cu["c_segment"][keep], sv,
                            SEGMENT_SET)
    b = r["rows"]
    n = int(b.row_count)
    _expect(f"customer rows {n}", n == int(keep.sum()))
    _expect_column("cast(slice(c_phone), int32)", b.column("code"), n,
                   code.astype(np.int32))
    _expect_column("is_null(segment)", b.column("seg_null"), n, ~sv)
    _expect_column("is_valid(segment)", b.column("seg_valid"), n, sv)
    _expect_column("is_nan(segment)", b.column("seg_nan"), n,
                   np.zeros(n, dtype=np.bool_), sv)
    _expect_column("index_in(segment)", b.column("seg_index"), n,
                   idx.astype(np.int32), ok)
    _expect_equal("coalesce(segment, code)",
                  _strings_of(b.column("seg_or_code"), n),
                  np.where(sv, seg, code_str))
    _expect_equal("if_else(rich, segment, code)",
                  _strings_of(b.column("rich_seg"), n),
                  np.where(bal > RICH, seg, code_str))
    g = r["grouped"]
    keys, first = np.unique(code, return_index=True)
    order = np.argsort(first)
    inv = np.searchsorted(keys, code)
    want = {"code": keys[order],
            "n": np.bincount(inv)[order],
            "balance": np.bincount(inv, weights=bal)[order],
            "nulls": np.bincount(inv, weights=~sv)[order],
            "indexed": np.bincount(inv, weights=ok)[order]}
    for name, w in want.items():
        got = np.array(g[name], dtype=np.float64)
        if name == "balance":
            _expect_close(f"balance by code", got, w)
        else:
            _expect_equal(f"{name} by code", got, w.astype(np.float64))
    return f"{n} customers, {len(keys)} country codes"


NDTRI_TOL = 1e-12               # rank_normal: torch's ndtri beside inv_cdf

# Launches a run at SF10, reckoned from the code. hash_types: the
# registered hash32 of 13 columns, one hash32 each. vector_misc: the two
# run_end_encodes find their runs' starts by one compaction each; the
# fills are blocked scans and gathers, the lookups gathers by codes or
# compares. math_stats: indices_nonzero compacts once; winsorize and the
# ranks sort. grouped_flags and grouped_k3: Q1's filter folds into the
# aggregate; skew's and kurtosis' three sums each (their mean, squares,
# cubes or fourth powers) take grouped_sum over 12 slots (K1) and over
# 160 (K3); the medians and quantiles sort. orders_median: the general
# grouper and a sort, no kernel. customer_plan: the grouped plan's filter
# folds into its aggregate (by the general grouper: the sums take the
# sorted route); the rows' filter compacts once.
REST_PATHS = (
    StatsPath("hash_types", hash_types_run, check_hash_types,
              _launches(0, 13, 0)),
    StatsPath("vector_misc", vector_misc_run, check_vector_misc,
              _launches(2, 0, 0)),
    StatsPath("math_stats", math_stats_run, check_math_stats,
              _launches(1, 0, 0)),
    StatsPath("grouped_flags", grouped_flags_run,
              lambda c, r: check_grouped_rest(c, r, FLAG_KEYS),
              _launches(0, 0, 6)),
    StatsPath("grouped_k3", grouped_k3_run,
              lambda c, r: check_grouped_rest(c, r, K3_KEYS),
              _launches(0, 0, 6)),
    StatsPath("orders_median", orders_median_run, check_orders_median,
              _launches(0, 0, 0)),
    StatsPath("customer_plan", customer_run, check_customer,
              _launches(1, 0, 0)),
)


def phase_rest_kernels(s):
    """The kernels on phase 3i's paths against their plain versions at
    the shapes the paths give them: the hash of the 13 columns' words bit
    for bit; the compaction of run_end_encode's run starts (l_orderkey in
    order) and of indices_nonzero's positions bit for bit; the grouped sum of the
    moments' values by the flags (12 slots) and by the K3 key (160
    slots) within RTOL_F64. Launches here are outside every path's
    count."""
    from arrow_tpu_torch.compute.hashing import column_words
    from arrow_tpu_torch.kernels.grouped_sum import (grouped_sum,
                                                     grouped_sum_plain)
    from arrow_tpu_torch.kernels.hash32 import hash32, hash32_plain
    t, li = s["typed"], s["lineitem"]
    errs = {"hash32": 0.0, "compact": 0.0}
    for name in HASH_COLUMNS + ("f64",):
        col = s["f64"] if name == "f64" else t.column(name)
        words = column_words(col)
        check_bit_exact(f"hash32 {name} ({len(words)} words, n="
                        f"{words[0].numel()})", [hash32(words)],
                        [hash32_plain(words)])
    ctx = _context(li)
    live = ctx.row_mask()
    okey = s["okey_in_order"].values
    new = torch.ones_like(live)
    new[1:] = okey[1:] != okey[:-1]
    idx = torch.arange(li.capacity, dtype=torch.int32, device=live.device)
    compact_case(f"compact (run_end_encode starts, n={live.numel()})",
                 new & live, [idx])
    compact_case(f"compact (indices_nonzero, n={live.numel()})",
                 live & (li.column("l_discount").values != 0),
                 [idx.long()])
    keep = li.column("l_shipdate").values <= SHIPDATE_1998_09_02
    price = li.column("l_extendedprice").values
    for keys in (FLAG_KEYS, K3_KEYS):
        slot = torch.zeros_like(idx)
        for k in keys:
            col = li.column(k)
            slot = slot * (len(col.dictionary) + 1) + col.values
        size = int(np.prod([len(li.column(k).dictionary) + 1
                            for k in keys]))
        seg = torch.where(keep & live, slot, 0)
        v = torch.where(keep & live, price, 0.0)
        errs[f"grouped_sum S={size}"] = check_close(
            f"grouped_sum (moments' values, S={size})",
            grouped_sum(v, seg, size), grouped_sum_plain(v, seg, size),
            RTOL_F64)
        cube = v * v * v
        errs[f"grouped_sum S={size} cubes"] = check_close(
            f"grouped_sum (cubes, S={size})", grouped_sum(cube, seg, size),
            grouped_sum_plain(cube, seg, size), RTOL_F64)
    torch.cuda.synchronize()
    return errs


def rest_repeats(s):
    """The grouped moments by the flags (K1) and the K3 key, whose sums
    phase 3i holds to the same bits on a second run."""
    from arrow_tpu_torch.acero.exec import execute_declaration
    out = []
    for keys in (FLAG_KEYS, K3_KEYS):
        b = execute_declaration(grouped_rest_decl(s, keys))
        out += [b.column("skew").values, b.column("kurt").values]
    return out


def phase_rest(tables, typed):
    """Phase 3i: the rest of compute at SF10, each path with every launch
    count set to 0 just before its run and read just after, against its
    numpy oracle (a thread each while the next path runs), with the
    card's peak memory over the run; the kernels against their plain
    versions at these paths' shapes; the grouped moments run twice for
    the same bits. Returns (launches by path, the inputs)."""
    from arrow_tpu_torch.platform_check import self_check
    log(f"== phase 3i: the rest of compute at SF{SF:g}")
    t0 = time.perf_counter()
    s = rest_inputs(tables, typed)
    cols = rest_columns(s)
    log(f"inputs made and downloaded in {time.perf_counter() - t0:.1f} s")
    errs = phase_rest_kernels(s)
    launches, failures, checks = {}, [], {}
    with concurrent.futures.ThreadPoolExecutor(len(REST_PATHS)) as pool:
        for path in REST_PATHS:
            base = memory_mark()
            zero_launches()
            self_check()
            t1 = time.perf_counter()
            result = path.run(s)
            torch.cuda.synchronize()
            log(f"{path.name} first run {time.perf_counter() - t1:.3f} s")
            launches[path.name] = read_launches()
            log_peak(path.name, base)
            checks[path.name] = pool.submit(_timed_check, path, cols, result)
            del result
        for path in REST_PATHS:
            try:
                msg, seconds = checks[path.name].result()
                check_launches(path.name, launches[path.name], path.launches)
                log(f"{path.name} matches its oracle: {msg} (oracle "
                    f"{seconds:.1f} s)")
            except AssertionError as exc:
                log(f"  {path.name} FAILED: {exc}")
                failures.append(path.name)
    first, second = rest_repeats(s), rest_repeats(s)
    check_bit_exact("phase 3i grouped moments (K1, K3), two runs", first,
                    second, "the first run")
    if failures:
        raise AssertionError(f"phase 3i failed for {failures}")
    log(f"phase 3i: {time.perf_counter() - t0:.1f} s (kernels against "
        f"their plain versions: max_abs_err {errs!r})")
    return launches, s


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
    synchronize, every run; the first is the warm-up, but where ``reps``
    is 1 (a path the phase before ran already)."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, min(walls[1:] or walls)


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


def time_paths(card, paths):
    """Each (path, run)'s walls (``path.reps``, best after a warm-up) and
    one profiled run."""
    for path, run in paths:
        walls, best = best_wall(run, getattr(path, "reps", 6))
        log(f"{path.name} SF{SF:g}: wall "
            f"{[round(w * 1e3, 3) for w in walls]} ms; best "
            f"{best * 1e3:.3f} ms [{card}]")
        profile_run(path.name, run)


def phase_times(card, launches, errs, tables, typed, params, stats,
                strings, rest):
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
    # phase 3e's, phase 3f's and phase 3g's paths
    time_paths(card, [(p, node_path_run(p, p.build(tables)))
                      for p in NODE_PATHS]
               + [(p, p.build(typed).to_table) for p in TYPED_PATHS]
               + [(p, lambda p=p: p.run(stats)) for p in STATS_PATHS]
               + [(p, lambda p=p: p.run(rest)) for p in REST_PATHS])

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

    # phase 3h's paths last: a profile of its sweeps (thousands of
    # kernels) fills the profiler's buffer, and the kernels' device times
    # read after it come out short
    time_paths(card, [(p, lambda p=p: p.run(strings, None))
                      for p in STRING_PATHS])

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
        stats_launches, stats = timed(phase_stats, tables, typed)
        launches.update(stats_launches)
        strings_launches, strings = timed(phase_strings, tables, typed)
        launches.update(strings_launches)
        rest_launches, rest = timed(phase_rest, tables, typed)
        launches.update(rest_launches)
        timed(phase_join_types, orders, customer)
        kernel_line = timed(phase_times, card, launches, errs, tables,
                            typed, params, stats, strings, rest)
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
