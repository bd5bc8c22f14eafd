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
   strings_pool, over part and customer at STRINGS_POOL_SF / ROOM_DEPTH,
   every str -> str name on ``p_name`` (125,000 values, the byte pool) and on
   ``p_type`` (the host tier) and every predicate and length on
   ``p_name``, ``p_type`` and ``c_comment`` against Python's ``str`` and
   ``re``, and p_brand, p_container and a separator joined;
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
   Then (3j) streaming (``STREAM_PATHS``): SF10's lineitem from the
   port's host generator (``io/tpch.py``, all 15 columns) held in pinned
   host memory and run in chunks of 2**23 rows (8 chunks, each copied to
   the card on a copy stream while the chunk before computes), each path
   against its numpy oracle and the same plan whole-table over a copy of
   lineitem on the card, with its launches exact, the peak memory of
   both runs and the bytes copied and their time: Q1 (run twice for the
   same bits), Q6, Q3 (its build side, orders x customer, run once, each
   probe chunk taking the bloom), ``to_reader`` over lineitem filtered to
   about 0.18% of its rows (the time to the first dict and the last), an
   external ``order_by`` of those rows, a top-100 over all rows, a
   fetch, lines and quantity per order (15M groups: the default state
   overflows, ``ARROW_TPU_STATE_ROWS=16777216`` holds them), and Q3 under
   ``QueryOptions`` (its node metrics, and ``ArrowMemoryError`` at the
   node the tracking predicts under a limit one byte below its total);
   the copies' overlap with kernels from a profiled run of Q1 and Q3;
   the kernels against their plain versions at a chunk's shapes.
   Then (3k) distribution (``phase_dist``; it runs after 3q and 3b): the
   single-rank run of each path on this process against its numpy oracle
   (an oracle an earlier phase made of the same tables taken from it),
   then four ranks under
   gloo spawned on this one card (NCCL refuses two ranks of one
   communicator on one GPU; a rank a GPU is its production use), each
   making lineitem's and Q3's tables by row range on the card and reading
   the host generator's through CUDA IPC, each path with the rank's
   launches zeroed just before and read just after: Q1 through
   ``to_table(distributed=True)`` and ``distributed_q1``, Q3, the eight
   join types (orders probing customer), an ``order_by`` of lineitem on
   (l_shipdate, l_orderkey), a broadcast join of lineitem to supplier, a
   partitioned and a salted join of lineitem with 2/3 of its rows on one
   l_orderkey to orders (``BASELINE.json`` config 5), and Q9-style on a
   two-rank subgroup (config 4). Each result against the single-rank run
   (results of a few rows by value, floats within rtol 1e-9; the rest by
   digests of every column's bits, through ``execute_distributed``), the
   float results twice for the same bits, ``EXCHANGE_COUNTS`` and the
   launches a rank as reckoned from the code, the salted join's largest
   rank under 1/2 of the probe rows where the partitioned join's holds
   2/3 or more; each path's wall, bytes exchanged, the collectives' time
   and each rank's peak memory; then a one-rank NCCL group exchanges Q3's
   filtered lineitem here, bit for bit.
   Then (3l) the host boundary (``phase_host``): the eight TPC-H tables
   made once on the host by ``io/tpch.py`` as host Tables and as their
   makers' batches (those of the set-up's tables and 3j's lineitem taken
   from their generation there); each Table's source uploaded (timed, GB/s) and held
   bit for bit to its maker's batch; Q1, Q3, Q9, Q13 and Q18 from host
   Tables through ``to_table()`` to a host Table, against their numpy
   oracles and, digest for digest, the same plan over the batches, with
   their launches equal to that plan's, and the plan and the download
   walls apart; Q1 streamed from the host lineitem Table in chunks of
   2**23 rows against the whole-table run; ``hash_list`` and
   ``hash_distinct`` of lineitem by its flags, ``hash_pivot_wider`` of
   l_quantity's sums over l_shipmode by l_returnflag, and a list mixed
   with a device sum (K1); a ``consuming_sink`` over a filter of
   lineitem, its batches equal to ``to_table()``; and the eager
   ``compute.filter`` (K2), the registered ``hash32`` (K4) and
   ``Table.group_by(...).aggregate`` with a sum (K1) over 60M-row host
   Arrays, each against numpy. Each path's launches are set to 0 just
   before and read just after. Its host Tables stay for 3m and 3k.
   Then (3m) the rest of the host boundary (``phase_host_tier``) over
   phase 3l's Tables: lineitem sorted by l_orderkey once, one list an
   order (15M, empty ones included, over 60,012,150 children), null
   where o_orderstatus is 'P', of l_extendedprice and of l_shipmode (the
   host Table's dictionary column; a plain string child of 60M rows would
   spend about 40 s coding on the host, so list<string> runs over the
   first HOST_TIER_PREFIX orders); on the card ``list_value_length``,
   ``list_parent_indices``, ``list_flatten`` (one compaction each),
   ``list_element`` 0 and 6, the flatten without nulls (no launch) and
   of a slice at 1,000,000; ``run_end_encode`` of the sorted keys (one
   compaction) and ``run_end_decode`` of it and of a slice; ``mode``
   over 60M; ``strftime``/``strptime`` of the first HOST_TIER_DATES order
   dates, the splits and ``binary_join`` over the first HOST_TIER_TEXT part
   names, the regex extractions over the first HOST_TIER_TEXT phones, the
   per-row names over HOST_TIER_PREFIX rows, ``random`` over
   60M twice (its bits against a numpy threefry); casts of c_acctbal,
   c_custkey and order dates to strings and back through the string cast
   tier; wide decimals (decimal128(38, 2) aggregates, decimal256
   arithmetic, the 38-digit ceiling); a scalar UDF over the eager
   compute, an aggregate UDF and a tabular UDF giving Q1; Q1 under
   ``QueryOptions`` exported as OTLP/JSON to a file and read back; the
   card's memory and runtime facts. Each against numpy or Python, each
   path's launches set to 0 just before and read just after.
   Then (3n) the frontends (``phase_frontends``) over phase 3l's Tables
   and their kept uploads: TPC-H Q1, Q6 and Q3 as SQL text (Q3 lineitem
   first, joining before it filters); a Gandiva ``Projector`` of Q1's
   disc_price and charge, a ``Filter`` of Q6's condition (its
   ``SelectionVector`` found on the card with one compaction) and the
   projector under that selection, over one RecordBatch of lineitem's
   columns; Q6 and a Q3-shaped join (lineitem with orders, revenue by
   order date, the top 10) through ``substrait.serialize_plan`` and
   ``run_query`` over dictionary-free columns; an ``InMemoryDataset`` of
   lineitem as 8 slices through a ``Scanner`` under Q6's filter, its
   ``count_rows``, and ``scan`` sources under Q6's and Q1's aggregates
   (Q1 twice: the second scan uploads nothing); the eager ``quantile``
   of three q with ``QuantileOptions``, a cast by ``CastOptions`` and
   ``list_element`` -1 raising over 3m's order lists. Each result
   against its ``Declaration`` form over the same Tables or numpy, each
   path's launches set to 0 just before and read just after and held to
   FRONTEND_LAUNCHES; the parse, encode and decode times logged beside
   the plans' walls.
   Then (3o) files (``phase_files``) over phase 3l's Tables, in a
   temporary directory whose free space is checked first: lineitem as
   FILE_SLICES IPC files (3n's slices), Q1 by a ``scan`` source and Q6 by
   a ``Scanner`` over ``dataset(dir, format="ipc")``, each twice, bit for
   bit the same scans of the in-memory slices with the same launches;
   one file read whole through a memory map, every buffer inside the map;
   Q1's seven columns of all of lineitem as one Feather V2 file with LZ4
   and Q1 over it; orders' V1-storable columns through Feather V1; orders
   written partitioned by status (``write_dataset``, hive) and one
   status's orders by priority over the pruned dataset against the
   Table's plan; orders as an IPC stream in batches of FILE_STREAM_ROWS.
   Each path's launches set to 0 just before and read just after and held
   to FILE_LAUNCHES; the bytes written and mapped, the write and LZ4 rates
   and the peaks logged.
   Then (3p) Parquet (``phase_parquet``) over phase 3l's Tables, in a
   temporary directory whose free space is checked first: the first
   1/ROOM_DEPTH of lineitem's rows, its Q1 columns, as FILE_SLICES snappy
   Parquet files (dictionary on, the writer's defaults otherwise), read
   back equal to the slices (the flags as plain strings) and the flags
   uploaded alone; Q1 by a ``scan``
   source over ``dataset(dir)`` (the default format) twice and Q6 by a
   ``Scanner``, each against numpy and against the same scan of the
   in-memory slices (the flags by value, every other column bit for
   bit); ``read_table`` of one file with Q6's columns under Q6's
   condition as DNF filters, its filter plan on the card, against numpy;
   orders hive-partitioned by status through ``write_to_dataset`` with a
   ``metadata_collector`` and a ``_metadata`` from ``write_metadata``,
   and one status's orders by priority over ``parquet_dataset`` against
   the Table's plan; orders' first 1/ROOM_DEPTH of rows as one uniform
   AES-GCM encrypted file, read back equal. Each path's launches set to 0 just before and read just
   after and held to PARQUET_LAUNCHES; the bytes written, the write and
   read rates, snappy's rates on the host, the flags' upload time and
   the peaks logged.
   Then (3q) CSV, JSON and ORC (``phase_csv_json_orc``) over phase 3l's
   Tables, in a temporary directory whose free space is checked first:
   the first 1/ROOM_DEPTH of lineitem's rows, its Q1 columns, as
   FILE_SLICES CSV files by ``write_csv`` (the defaults), Q1 by a ``scan``
   source over ``dataset(dir, format="csv")`` against numpy's oracle and Q1
   over the same rows in memory (the flags by value, every other column bit
   for bit), one file through
   ``open_csv`` in blocks against that fragment's Table; the first
   1/ROOM_DEPTH of orders' rows (its dictionary columns as plain strings)
   by ``write_dataset(format="orc")``
   hive-partitioned by status, one status's orders by priority over the
   ORC dataset against the Table's plan, a ``Scanner`` under a price
   filter against numpy, one partition written again with zlib and read
   back equal; customer as newline-delimited JSON (``write_ndjson``: the
   reference writes none), its customers by segment over
   ``dataset(path, format="json")`` against numpy and the Table's plan,
   ``read_json`` of the file against the dataset's fragment. Each path's
   launches set to 0 just before and read just after and held to
   CSV_JSON_ORC_LAUNCHES; the bytes written, the write and read rates
   and the peaks logged.
   Then (3r) the host surface and the cloud file systems
   (``phase_host_surface``) over phase 3l's Tables: ``Table.join`` of
   orders with the customers of one segment (a host Table made on the
   host) for all eight join types against ``join_oracle``, the coalesced
   keys taken into account (a row of the right side alone keeps no key),
   and once with the keys kept; a left outer join of every column of
   orders (its first 1/ROOM_DEPTH of rows) and customer; lineitem's four
   columns joined to orders' three (60,012,150 probe rows against 15M, the
   bloom); phase 3e's as-of join
   through ``Table.join_asof`` against ``asof_oracle``; ``Dataset.join``
   and ``join_asof`` over in-memory datasets, equal to the Tables'
   results. The ChunkedArray methods (``filter``, ``take``,
   ``drop_null``, ``fill_null``, ``is_null``, ``sort``, ``unique``,
   ``value_counts``, ``dictionary_encode``, ``cast``, ``index``) over
   lineitem's 60M-row columns cut into FILE_SLICES chunks, against numpy.
   The host-only methods on customer: column edits, ``from_pylist`` and
   struct round trips over its first SURFACE_PY_ROWS rows, ``validate``
   (a broken copy refused), ``to_string`` and ``concat_tables``. Orders'
   first 1/ROOM_DEPTH of rows, its dictionaries as plain strings as 3q
   writes them, hive-partitioned
   by status as Parquet into the S3 emulator through ``S3FileSystem``,
   one status's orders by priority over the S3 dataset against the
   Table's plan; customer partitioned by segment as IPC through the GCS,
   Azure and WebHDFS emulators (``tests/cloud_emulators.py``, loopback
   HTTP), each fragment read back to a host Table bit for bit its local
   twin's; a file round trip
   through each client. Each path's launches set to 0 just before and
   read just after and held to HOST_SURFACE_LAUNCHES; each path's wall,
   its download's wall and its peak, and the emulators' bytes and rates
   logged.
   Then (3s) interop and extension types (``phase_interop``) over phase
   3l's Tables: lineitem's eight Q1/Q3 columns through the C stream
   (``Table.__arrow_c_stream__`` -> ``RecordBatchReader.from_stream``)
   digest for digest, the export state empty after, and Q1 over the
   imported Table bit for bit 3l's; l_extendedprice and a nullable string
   slice through ``__arrow_c_array__`` -> ``c_data.import_array``; orders
   and customer (Q3's columns) through the interchange protocol, and Q3
   over them and the imported lineitem bit for bit 3l's; numpy and torch
   over dlpack at the Arrays' addresses; lineitem's four floats as a
   Tensor written to a file and read from its map, and partsupp's
   (partkey, suppkey) -> availqty as CSR, COO and CSF tensors, each
   through its IPC message; orders with a uuid and a
   fixed_shape_tensor(float64, [2]) column through an IPC file, read back
   registered and not, and Q3 over it bit for bit 3l's; customer's
   comments as string_view and a dense union of (c_custkey |
   c_mktsegment) through the C array and an IPC stream; pandas (a round
   trip of customer's first 1/ROOM_DEPTH of rows where it is installed,
   else ImportError) and Device. Each path's
   launches set to 0 just before and read just after and held to
   INTEROP_LAUNCHES; walls, rates and peaks logged.
   Then (3t) Arrow Flight, Flight SQL, DB-API and ODBC (``phase_flight``)
   over phase 3l's Tables, each on 127.0.0.1 and shut down before the
   phase ends: a Flight SQL server of lineitem, orders and customer on
   the card, SQL Q1 and Q3 through ``FlightSqlClient.execute`` equal to
   phase 3n's answers (each statement runs twice: GetFlightInfo, then
   DoGet) with FlightInfo's row counts, a prepared Q6 with its three
   parameters bound by DoPut, the six metadata commands; DoGet of
   lineitem's eight Q1/Q3 columns chunk for chunk the source's and Q1 over
   the received Table bit for bit 3l's; DoPut of orders (every column)
   digest for digest; DoExchange of orders' four fixed-width columns
   through the server's eager filter on the card against numpy; DB-API
   Q1 and ``executemany`` of the parameterised Q6; the port's ODBC driver
   (built with the host compiler) called by ctypes through a gateway, Q1's
   cells its text; basic auth (a call without the token refused) and the
   tracing middleware on a DoGet of customer; four clients running Q1 and
   Q3 at once. Each path's launches set to 0 just before and read just
   after and held to FLIGHT_LAUNCHES; walls, rates and peaks logged.
   Then (3b) all eight join types, each run against a numpy oracle of
   the join (row count, row order, values and validity exact) with its
   launches exact: orders probing customer filtered to one segment at
   SF10, where the bloom engages for inner, left semi, right semi and
   right outer joins, and 1,000,000 probe rows against 200,000 build
   rows with duplicate keys on both sides and 5% null keys.
   Then 3k (above) runs, its single-rank runs of the eight joins 3b's,
   with Q1 and Q3 from phase 3l's host Tables split by rank added (the
   Tables shared with the ranks through shared memory; each rank uploads
   only its range, held to its share), and the host Tables' uploads
   released.
4. Times after a warm-up: phase 3m's device paths at 60M rows (the
   five nested names and the run-end encoding, best of 6 and one profile
   of them all); Q1, Q3, Q4, Q13, the suite's and the last
   eleven plans' rows/s of their largest input and phase 3e's, 3f's, 3g's,
   3i's, 3j's and 3h's walls (best of 5 after a warm-up, of 3 for 3j's,
   fewer where the timed runs pass WALL_BUDGET_S; the one profiled run for
   3h's two sweeps), a profile of one run of each (device busy time and idle
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
import io
import json
import os
import re
import shutil
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
WALL_BUDGET_S = 1.0         # phase 4's timed runs of one path, at least 1
RTOL_F32 = 1e-5             # an f32 result against an f64 reference
NODE_SPAN = "arrow_tpu::"   # the executor's profiler span of a plan node
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


# oracle results by the tables they read: the Q1 oracle over Q1's
# lineitem (phases 3e and 3k), the Q9 and Q21 oracles over the suite's
# tables (3c and 3k, 3d and 3e) are made once
_ORACLES = {}


def _memo_oracle(fn, copied=True):
    """``fn`` computed once for the same DeviceBatch objects (by identity:
    each batch's row count and column tensors, held weakly) and the same
    plain arguments; a dict argument counts by its DeviceBatch values,
    any other dict (downloaded columns, derived from the batches) is not
    part of the key. A kept result is handed out as a copy where
    ``copied`` (the callers read without writing where not)."""
    import copy
    import weakref

    def tensors(b):
        return [b.row_count] + [c.values for c in b.columns]

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        from arrow_tpu_torch.device.column import DeviceBatch
        batches, plain = [], []
        for a in args:
            if isinstance(a, DeviceBatch):
                batches.append(a)
            elif isinstance(a, dict):
                batches += [v for _, v in sorted(a.items())
                            if isinstance(v, DeviceBatch)]
            else:
                plain.append(a)
        key = (fn.__name__, tuple(map(id, batches)), tuple(plain),
               tuple(sorted(kwargs.items())))
        hit = _ORACLES.get(key)
        now = [t for b in batches for t in tensors(b)]
        if hit is not None and len(hit[0]) == len(now) and all(
                r() is t for r, t in zip(hit[0], now)):
            return copy.deepcopy(hit[1]) if copied else hit[1]
        out = fn(*args, **kwargs)
        _ORACLES[key] = ([weakref.ref(t) for t in now],
                         copy.deepcopy(out) if copied else out)
        return out
    return wrapper


_START = time.perf_counter()


def log(*parts):
    """A line of the run's log, led by the seconds since the script
    started."""
    print(f"[{time.perf_counter() - _START:7.1f}]", *parts, flush=True)


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


@_memo_oracle
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


_ASOF = {}   # the last as-of oracle, by a digest of its inputs


def asof_oracle(lkey, lon, rkey, ron, tolerance):
    """Per left row, the right row an as-of join picks, -1 for none: the
    same key, the latest ``on`` at most the left row's and at least the
    left row's plus ``tolerance`` (at most 0), and of equal (key, on) the
    last in the right input. Keys are non-negative integers. One stable
    sort of the right rows by (key, on), one sort of the left rows, and
    one search of the sorted left rows (in order, the search stays in
    cache). Made once for the same inputs (phases 3e and 3r ask for the
    same orders)."""
    import hashlib
    if tolerance > 0:
        raise ValueError("the as-of oracle looks back only")
    key = (tolerance,) + tuple(hashlib.blake2b(np.ascontiguousarray(
        a).view(np.uint8)).hexdigest() for a in (lkey, lon, rkey, ron))
    if key in _ASOF:
        return _ASOF[key].copy()
    base = min(lon.min(), ron.min())
    span = int(max(lon.max(), ron.max()) - base) + 1
    rpack = rkey.astype(np.int64) * span + (ron - base)
    order = np.argsort(rpack, kind="stable")
    lpack = lkey.astype(np.int64) * span + (lon - base)
    lorder = np.argsort(lpack)
    pos = np.empty(len(lpack), dtype=np.int64)
    pos[lorder] = np.searchsorted(rpack[order], lpack[lorder],
                                  side="right") - 1
    cand = order[np.maximum(pos, 0)]
    ok = (pos >= 0) & (rkey[cand] == lkey) & (ron[cand] >= lon + tolerance)
    _ASOF.clear()
    _ASOF[key] = np.where(ok, cand, -1)
    return _ASOF[key].copy()


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


@functools.partial(_memo_oracle, copied=False)
def _suite_columns(t):
    """The downloaded source columns the suite's oracles read, by table
    (read only: phases 3c and 3k share them)."""
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


@_memo_oracle
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


@_memo_oracle
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
    first = _first_seen(key, len(rf) * len(ls))
    groups = np.flatnonzero(first < len(key))
    first_of = {(rf[k // len(ls)], ls[k % len(ls)]): first[k]
                for k in groups}
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
    return (lambda: plan.to_table().to_pydict()) if path.download else \
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
    launches, failures, checks = {}, [], []
    # each path's check (its numpy oracle) on ORACLE_THREADS threads while
    # the next paths run
    with concurrent.futures.ThreadPoolExecutor(ORACLE_THREADS) as pool:
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
            checks.append((path, pool.submit(_timed_call, path.check,
                                             tables, cols, result)))
            del plan, result
        for path, done in checks:
            try:
                check_launches(path.name, launches[path.name],
                               path.launches)
                msg, took = done.result()
                log(f"{path.name} matches its oracle: {msg} (oracle "
                    f"{took:.1f} s on its thread)")
            except AssertionError as exc:
                log(f"  {path.name} FAILED: {exc}")
                failures.append(path.name)
        del checks
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
        result = plan.to_table().to_pydict()
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
    return {"flags": flags.to_table().to_pydict(), "orders": execute_declaration(orders)}


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
    return (decl or stats_scalar_decl(s)).to_table().to_pydict()


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
# the values of p_name: Python's str and numpy's strings agree on them
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
    return {key: strings_plan(lineitem, s, key).to_table().to_pydict()
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
                 lambda i, check: temporal_plan(i["lineitem"]).to_table().to_pydict(),
                 _launches(1, 0, 0), check_temporal_plan),
    FunctionPath("strings_pool",
                 lambda i, check: strings_pool_run(i["strings_pool"], check),
                 _launches(0, 0, 0), reps=1),
    FunctionPath("strings_plan",
                 lambda i, check: strings_plan_run(i["lineitem"],
                                                   i["strings"]),
                 _launches(4, 4, 2), check_strings_plan),
)


def _timed_verify(verify, cols, result):
    t0 = time.perf_counter()
    return verify(cols, result), time.perf_counter() - t0


# the scale of the strings_pool sweep's part and customer, before ROOM_DEPTH
# (at 2.5, 500,000 p_name and 375,000 c_comment values: ~28 s in phase 3h
# and ~13 s again in phase 4; SF10's 2M and 1.5M took ~75 s and ~29 s), most
# of it the oracles' Python a value
STRINGS_POOL_SF = 2.5


def strings_inputs_all(tables, typed, pool_tables=None):
    """Phase 3h's inputs: Q1's lineitem, the temporal columns, the string
    tables, and the strings_pool sweep's (``pool_tables``' part and
    customer where given, else ``tables``')."""
    strings = strings_inputs(tables)
    return {"lineitem": tables["lineitem"],
            "temporal": temporal_inputs(tables["lineitem"], typed),
            "strings": strings,
            "strings_pool": strings if pool_tables is None
            else strings_inputs(pool_tables)}


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
    result = suite_plan(q22, tables).to_table().to_pydict()
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
    from arrow_tpu_torch.io import tpch
    h = strings_inputs_all(tables, typed, {
        "part": tpch.part_table(STRINGS_POOL_SF / ROOM_DEPTH),
        "customer": tpch.customer_table(STRINGS_POOL_SF / ROOM_DEPTH)})
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
    return grouped_rest_decl(s, FLAG_KEYS).to_table().to_pydict()


def grouped_k3_run(s):
    return grouped_rest_decl(s, K3_KEYS).to_table().to_pydict()


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
    return {"grouped": grouped.to_table().to_pydict(), "rows": execute_declaration(rows)}


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


# --- phase 3j: streaming and per-query control -------------------------------

# Chunks of 2**23 rows: SF10's lineitem streams in 8 of them, and Q3's
# streamed probe chunk is then 4x the capacity of its build side (orders x
# customer: 1,478,464 rows at the 2**21 capacity class), so every chunk
# takes the bloom, as the whole-table Q3 does.
STREAM_CHUNK_ROWS = 1 << 23
STREAM_STATE_ROWS = 1 << 24     # a state that holds SF10's 15M orders
STREAM_COLUMNS = ["l_orderkey", "l_linenumber", "l_extendedprice",
                  "l_quantity"]
STREAM_KEYS = [("l_extendedprice", "descending"), ("l_orderkey", "ascending"),
               ("l_linenumber", "ascending")]
STREAM_FETCH = (10_000, 10_000)  # offset, count: inside the first two chunks
STREAM_TOP_K = 100
STREAM_TOP_ORDERS = 20


def stream_inputs(tables):
    """SF10's lineitem from the port's host generator, held in pinned host
    memory, and a copy on the card for the whole-table runs (kept with
    its host Table for phase 3l), beside orders and customer on the card;
    the host columns for the oracles."""
    from arrow_tpu_torch.device.column import batch_to, pin_batch
    from arrow_tpu_torch.io import tpch
    t0 = time.perf_counter()
    # lineitem_table(SF, device="cpu"), and the host Table of the same
    # generation, which phase 3l takes with the card copy
    table, host = tpch.host_and_device("lineitem", SF, device="cpu")
    t1 = time.perf_counter()
    host = pin_batch(host)
    t2 = time.perf_counter()
    card = batch_to(host, "cuda")
    torch.cuda.synchronize()
    _GENERATED["lineitem", SF] = (table, card)
    n = int(host.row_count)
    nbytes = sum(c.values.numel() * c.values.element_size()
                 for c in host.columns)
    log(f"stream lineitem: {n} rows, {len(host.columns)} columns, "
        f"{nbytes / 1e9:.3f} GB; generated on the host in {t1 - t0:.1f} s, "
        f"pinned in {t2 - t1:.1f} s, copied to the card in "
        f"{time.perf_counter() - t2:.1f} s")
    cols = {f.name: c.values[:n].numpy()
            for f, c in zip(host.schema.fields, host.columns)}
    return {"host": host, "card": card, "orders": tables["orders"],
            "customer": tables["customer"], "cols": cols, "n": n,
            "nbytes": nbytes}


def _stream_rows(c):
    """The rows phase 3j's row paths keep: about 0.18% of lineitem."""
    return (c["l_quantity"] == 1.0) & (c["l_discount"] == 0.0)


def _stream_filter(ac):
    return ac.Declaration("filter", ac.FilterNodeOptions(
        (ac.field("l_quantity") == 1.0) & (ac.field("l_discount") == 0.0)))


def _stream_project(ac):
    return ac.Declaration("project", ac.ProjectNodeOptions(
        [ac.field(k) for k in STREAM_COLUMNS], STREAM_COLUMNS))


def _stream_chain(li, *nodes):
    import arrow_tpu_torch.acero as ac
    return ac.Declaration.from_sequence(
        [ac.Declaration("table_source", ac.TableSourceNodeOptions(li))]
        + [n(ac) for n in nodes])


def stream_q1(s, li):
    from arrow_tpu_torch.io.tpch_queries import q1_plan
    return q1_plan(li)


def stream_q6(s, li):
    from arrow_tpu_torch.io.tpch_queries import q6_plan
    return q6_plan(li)


def stream_q3(s, li):
    from arrow_tpu_torch.io.tpch_queries import q3_plan
    return q3_plan(s["customer"], s["orders"], li)


def stream_rows_plan(s, li):
    return _stream_chain(li, _stream_filter, _stream_project)


def stream_order_by(s, li):
    return _stream_chain(li, _stream_filter, _stream_project,
                         lambda ac: ac.Declaration(
                             "order_by", ac.OrderByNodeOptions(STREAM_KEYS)))


def stream_top_k(s, li):
    return _stream_chain(
        li, _stream_project,
        lambda ac: ac.Declaration("order_by",
                                  ac.OrderByNodeOptions(STREAM_KEYS)),
        lambda ac: ac.Declaration("fetch",
                                  ac.FetchNodeOptions(0, STREAM_TOP_K)))


def stream_fetch(s, li):
    return _stream_chain(li, _stream_filter, _stream_project,
                         lambda ac: ac.Declaration(
                             "fetch", ac.FetchNodeOptions(*STREAM_FETCH)))


def stream_orders(s, li):
    """Lines and quantity per order (15M groups), the 20 largest."""
    return _stream_chain(
        li,
        lambda ac: ac.Declaration("aggregate", ac.AggregateNodeOptions(
            [(None, "hash_count_all", None, "n"),
             ("l_quantity", "hash_sum", None, "q")], keys=["l_orderkey"])),
        lambda ac: ac.Declaration("order_by", ac.OrderByNodeOptions(
            [("q", "descending"), ("l_orderkey", "ascending")])),
        lambda ac: ac.Declaration("fetch",
                                  ac.FetchNodeOptions(0, STREAM_TOP_ORDERS)))


def _chunked(plan, **kw):
    return plan.to_table(chunk_rows=STREAM_CHUNK_ROWS, **kw).to_pydict()


def _read_all(plan):
    """``to_reader``'s batches concatenated, as a dict; logs the time to
    the first and the last batch, their number, and the uploads enqueued
    when the first came."""
    from arrow_tpu_torch.acero.exec import last_plan_metrics
    from arrow_tpu_torch.table import Table
    t0 = time.perf_counter()
    reader = plan.to_reader(chunk_rows=STREAM_CHUNK_ROWS)
    parts = [next(reader)]
    t_first = time.perf_counter() - t0
    source = last_plan_metrics.source
    enqueued = source.uploads
    parts += list(reader)
    t_last = time.perf_counter() - t0
    log(f"  to_reader: first batch after {t_first * 1e3:.1f} ms "
        f"({parts[0].num_rows} rows, {enqueued} of "
        f"{source.n_chunks} chunk uploads enqueued), last after "
        f"{t_last * 1e3:.1f} ms, {len(parts)} batches")
    if len(parts) != source.n_chunks or enqueued >= source.n_chunks:
        raise AssertionError("to_reader: the first batch did not come "
                             "before the last chunk was consumed")
    return Table.from_batches(parts).to_pydict()


def _orders_state_rows(run):
    import os
    os.environ["ARROW_TPU_STATE_ROWS"] = str(STREAM_STATE_ROWS)
    try:
        return run()
    finally:
        del os.environ["ARROW_TPU_STATE_ROWS"]


def _query_q3(plan):
    from arrow_tpu_torch.acero import QueryOptions
    return _chunked(plan, query_options=QueryOptions())


def q1_stream_oracle(s):
    return q1_oracle(s["host"], s["n"])


def q6_stream_oracle(s):
    return q6_oracle(None, {"lineitem": s["cols"]})[0]


def q3_stream_oracle(s):
    return q3_oracle(stream_q3(s, s["host"]))[0]


def rows_oracle(s):
    c = s["cols"]
    keep = _stream_rows(c)
    return {k: c[k][keep].tolist() for k in STREAM_COLUMNS}


def order_by_oracle(s, limit=None):
    c = s["cols"]
    idx = np.nonzero(_stream_rows(c))[0] if limit is None else None
    if limit is not None:
        # the rows at or above the limit-th largest price, then sorted
        price = c["l_extendedprice"]
        kth = np.partition(price, len(price) - limit)[len(price) - limit]
        idx = np.nonzero(price >= kth)[0]
    order = np.lexsort((c["l_linenumber"][idx], c["l_orderkey"][idx],
                        -c["l_extendedprice"][idx]))
    idx = idx[order][:limit]
    return {k: c[k][idx].tolist() for k in STREAM_COLUMNS}


def fetch_oracle(s):
    off, cnt = STREAM_FETCH
    return {k: v[off:off + cnt] for k, v in rows_oracle(s).items()}


def orders_oracle(s):
    c = s["cols"]
    okey = c["l_orderkey"]
    n = np.bincount(okey)
    q = np.bincount(okey, weights=c["l_quantity"])
    keys = np.nonzero(n)[0]
    top = keys[np.lexsort((keys, -q[keys]))][:STREAM_TOP_ORDERS]
    return {"l_orderkey": top.tolist(), "n": n[top].tolist(), "q": q[top]}


class StreamPath(NamedTuple):
    """One path of phase 3j: ``plan(inputs, lineitem)`` over the pinned
    host lineitem runs chunked through ``run(plan)``, over the card's copy
    whole through ``to_table()``; ``oracle(inputs)`` is numpy's answer.
    Phase 4 takes the best of ``reps - 1`` walls after a warm-up."""
    name: str
    plan: object
    oracle: object
    launches: dict
    run: object = _chunked
    reps: int = 4


# Launches a run at SF10, reckoned from the code, over 8 chunks of 2**23
# rows. A middle filter compacts once a chunk (it is not folded into a
# chunked aggregate). Q1: each chunk's seven float sums (four sums, three
# means) at its group bound of 1,024 slots take grouped_sum (K3); the
# merges into the 2**23-row state take the sorted route. Q6: one sum a
# chunk at the keyless bound of 1,024 (K3). Q3: orders x customer runs
# once (2 filters, the bloom's 2 hash32 and compaction, the unique-build
# compaction); each chunk filters, takes the bloom (2**23 >= 4 x 2**21)
# and the unique-build compaction; the per-order sums take the sorted
# route. The row paths: the filter a chunk (the fetch stops after 2); the
# top-k and the orders sort and group without a kernel.
STREAM_PATHS = (
    StreamPath("Q1 chunked", stream_q1, q1_stream_oracle,
               _launches(8, 0, 56)),
    StreamPath("Q6 chunked", stream_q6, q6_stream_oracle,
               _launches(8, 0, 8)),
    StreamPath("Q3 chunked", stream_q3, q3_stream_oracle,
               _launches(28, 18, 0)),
    StreamPath("to_reader", stream_rows_plan, rows_oracle,
               _launches(8, 0, 0), _read_all),
    StreamPath("external order_by", stream_order_by, order_by_oracle,
               _launches(8, 0, 0)),
    StreamPath("top-k", stream_top_k,
               lambda s: order_by_oracle(s, STREAM_TOP_K),
               _launches(0, 0, 0)),
    StreamPath("fetch", stream_fetch, fetch_oracle, _launches(2, 0, 0)),
    StreamPath("orders state", stream_orders, orders_oracle,
               _launches(0, 0, 0),
               lambda plan: _orders_state_rows(lambda: _chunked(plan))),
    StreamPath("Q3 QueryOptions", stream_q3, q3_stream_oracle,
               _launches(28, 18, 0), _query_q3),
)


def as_expected(result):
    """A result of the port as ``check_result`` takes an oracle's: float
    columns as arrays, held within RTOL_F64."""
    return {k: np.asarray(v) if v and isinstance(v[0], float) else v
            for k, v in result.items()}


def copy_overlap(prof):
    """(ms of host-to-card copies, the share of it under kernels) of a
    profiled run, from the profiler's device events; None where it saw no
    copy."""
    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        iv = (e.time_range.start, e.time_range.end)
        if "HtoD" in e.name:
            copies.append(iv)
        elif not e.name.startswith(("Memcpy", "Memset", NODE_SPAN)):
            kernels.append(iv)
    if not copies:
        return None
    merged = []
    for a, b in sorted(kernels):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = sum(b - a for a, b in copies)
    under = 0.0
    for a, b in copies:
        for ka, kb in merged:
            under += max(0.0, min(b, kb) - max(a, ka))
    return total / 1e3, under / max(total, 1e-9)


def stream_profile(name, run):
    """One profiled run: device busy share and the copies' overlap with
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ov = copy_overlap(prof)
    if ov is None:
        log(f"  {name} profile: the profiler saw no host-to-card copy "
            "(overlap not measured)")
        return
    log(f"  {name} profile: host-to-card copies {ov[0]:.1f} ms of "
        f"{wall_ms:.1f} ms wall, {ov[1]:.3f} of the copy time under "
        "kernels of the compute stream (profiler on)")


def phase_stream_kernels(s):
    """The kernels on phase 3j's paths against their plain versions at a
    chunk's shapes: the compaction of Q1's filter over one chunk of all 15
    columns and of the row paths' filter, bit for bit; the grouped sum at
    a chunk's 1,024-slot bound with Q1's 6 and Q6's 1 live slot within
    RTOL_F64; the hash of a chunk's and of Q3's build side's keys, bit
    for bit. Launches here are outside every path's count."""
    from arrow_tpu_torch.compute.hashing import int64_halves
    from arrow_tpu_torch.compute.keys import equality_word
    from arrow_tpu_torch.device.column import round_up, slice_rows
    from arrow_tpu_torch.io.tpch_queries import DATE_1998_09_02
    from arrow_tpu_torch.kernels.grouped_sum import (grouped_sum,
                                                     grouped_sum_plain)
    from arrow_tpu_torch.kernels.hash32 import hash32, hash32_plain
    card = s["card"]
    cap = round_up(STREAM_CHUNK_ROWS)
    chunk = slice_rows(card, 0, STREAM_CHUNK_ROWS, cap,
                       torch.tensor(STREAM_CHUNK_ROWS, dtype=torch.int32,
                                    device="cuda"))
    live = chunk.row_mask()
    cols = [c.values for c in chunk.columns]
    compact_case(f"compact (Q1's filter over a chunk, n={cap}, 15 columns)",
                 live & (chunk.column("l_shipdate").values
                         <= DATE_1998_09_02), cols)
    compact_case(f"compact (the row paths' filter over a chunk, n={cap})",
                 live & (chunk.column("l_quantity").values == 1.0)
                 & (chunk.column("l_discount").values == 0.0), cols)
    errs = {}
    for slots, seed in ((6, 21), (1, 22)):
        v, g = q1_like_inputs(cap, 1024, slots, torch.float64, seed)
        errs[f"grouped_sum S=1024 ({slots} live)"] = check_close(
            f"grouped_sum (a chunk's bound, S=1024, {slots} live)",
            grouped_sum(v, g, 1024), grouped_sum_plain(v, g, 1024), RTOL_F64)
    words = int64_halves(equality_word(chunk.column("l_orderkey")))
    check_bit_exact(f"hash32 (a chunk's l_orderkey, n={cap})",
                    [hash32(words)], [hash32_plain(words)])
    o = s["orders"].column("o_orderkey")
    words = int64_halves(equality_word(o))
    check_bit_exact(f"hash32 (orders' keys, n={o.capacity})",
                    [hash32(words)], [hash32_plain(words)])
    torch.cuda.synchronize()
    return errs


def phase_stream(tables):
    """Phase 3j: streaming at SF10. Each path runs chunked from the pinned
    host lineitem with every launch count set to 0 just before and read
    just after, against its numpy oracle and the same plan whole-table
    over lineitem on the card, with the card's peak memory of both runs
    above the tables and the bytes copied to the card and their time. Q1
    runs twice for the same bits; the orders path first overflows the
    default state; the QueryOptions path prints its node metrics and
    raises at the node its tracking predicts under a limit one byte below
    its total. Returns (launches by path, the inputs)."""
    from arrow_tpu_torch.acero import ArrowMemoryError, QueryOptions
    from arrow_tpu_torch.acero.exec import last_plan_metrics
    from arrow_tpu_torch.platform_check import self_check
    log(f"== phase 3j: streaming at SF{SF:g} in chunks of "
        f"{STREAM_CHUNK_ROWS} rows")
    t0 = time.perf_counter()
    s = stream_inputs(tables)
    errs = phase_stream_kernels(s)
    launches, failures = {}, []
    for path in STREAM_PATHS:
        plan = path.plan(s, s["host"])
        base = memory_mark()
        zero_launches()
        self_check()
        t1 = time.perf_counter()
        result = path.run(plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches[path.name] = read_launches()
        peak = torch.cuda.max_memory_allocated() - base
        src = last_plan_metrics.source
        log(f"{path.name} first run {wall:.3f} s; {src.n_chunks} chunks, "
            f"{src.h2d_bytes / 1e9:.3f} GB to the card in "
            f"{src.copy_ms():.1f} ms of copies "
            f"({src.h2d_bytes / max(src.copy_ms(), 1e-9) / 1e6:.1f} GB/s)")
        base = memory_mark()
        whole = path.plan(s, s["card"]).to_table().to_pydict()
        whole_peak = torch.cuda.max_memory_allocated() - base
        log(f"{path.name} peak memory above the tables: chunked "
            f"{peak / 2**30:.2f} GiB, whole-table {whole_peak / 2**30:.2f} "
            f"GiB with lineitem's {s['nbytes'] / 2**30:.2f} GiB on the card")
        try:
            check_launches(path.name, launches[path.name], path.launches)
            check_result(path.name, result, path.oracle(s))
            check_result(f"{path.name} against the whole-table run",
                         result, as_expected(whole))
        except AssertionError as exc:
            log(f"  {path.name} FAILED: {exc}")
            failures.append(path.name)
            continue
        log(f"{path.name} matches its numpy oracle and the whole-table run "
            f"({len(next(iter(result.values())))} rows): keys, counts and "
            f"order exact, floats within rtol {RTOL_F64}")
        if path.name == "Q1 chunked":
            again = path.run(plan)
            check_bit_exact("Q1 chunked floats, two runs",
                            [torch.tensor(again[k], dtype=torch.float64)
                             for k in again
                             if isinstance(again[k][0], float)],
                            [torch.tensor(result[k], dtype=torch.float64)
                             for k in result
                             if isinstance(result[k][0], float)],
                            "the first run")
        if path.name in ("Q1 chunked", "Q3 chunked"):
            stream_profile(path.name, lambda: path.run(plan))
        if path.name == "Q3 QueryOptions":
            qc = plan.last_query_context
            log("  node metrics:\n    " + qc.to_string().replace(
                "\n", "\n    "))
            node = qc.node_metrics[-1][0]
            limit = qc.bytes_materialized - 1
            try:
                _chunked(plan, query_options=QueryOptions(limit))
            except ArrowMemoryError as exc:
                if f"at node '{node}'" not in str(exc):
                    raise AssertionError(f"raised elsewhere: {exc}") \
                        from None
                log(f"  memory_limit={limit}: ArrowMemoryError at node "
                    f"'{node}', as the tracking predicts: {exc}")
            else:
                raise AssertionError("memory_limit below the total did "
                                     "not raise")
        if path.name == "orders state":
            try:
                _chunked(plan)
            except ValueError as exc:
                if "exceeded the group-state capacity" not in str(exc):
                    raise
                log(f"  the default state ({STREAM_CHUNK_ROWS} rows) "
                    f"overflows: {exc}")
            else:
                raise AssertionError("the default state did not overflow")
        del result, whole
    s["card"] = None
    if failures:
        raise AssertionError(f"phase 3j failed for {failures}")
    log(f"phase 3j: {time.perf_counter() - t0:.1f} s (kernels against "
        f"their plain versions: max_abs_err {errs!r})")
    return launches, s


# --- phase 3k: distribution --------------------------------------------------

DIST_RANKS = 4
DIST_PAIR = 2                    # Q9-style's ranks: BASELINE.json config 4
DIST_TIMEOUT = 600               # seconds a rank may take for the phase
DIST_HOT_EVERY = 3               # 2 of every 3 probe rows on one key
DIST_HOT_KEY = 1                 # ... that l_orderkey
DIST_SALTS = 4 * DIST_RANKS
DIST_SORT_KEYS = [("l_shipdate", "ascending"), ("l_orderkey", "ascending")]
DIST_SORT_COLUMNS = ["l_orderkey", "l_linenumber", "l_shipdate",
                     "l_extendedprice"]
# Launches a rank, each path +1 probe (self_check): Q1 its middle filter
# (not folded into the state's consume) and 7 float sums at the 1,024-slot
# bound (K3), then 7 more in each of the 3 merges of the ranks' states
# (merged at the capacity their groups need, 1,024 slots: K3); Q3 the
# build side whole on each rank (the orders and customer filters, a bloom
# join: 4 compact, 2 hash32), the lineitem filter, and the local join of
# what each rank received (a bloom: 2 hash32, 2 compact); distributed_q1
# 7 sums over each rank's rows and 7 over the groups it received (K1, 12
# slots)
DIST_LAUNCHES = {
    "Q1": {"compact": 1, "hash32": 0, "grouped_sum": 28, "probe": 1},
    "distributed_q1": {"compact": 0, "hash32": 0, "grouped_sum": 14,
                       "probe": 1},
    "Q3": {"compact": 7, "hash32": 4, "grouped_sum": 0, "probe": 1},
}
# EXCHANGE_COUNTS by path, reckoned from dist_exec: Q1's spine, then its
# 6-row result sorted over the ranks; Q3's one join exchange (its build
# side, orders x customer, holds no aggregate: whole on each rank) with
# the lineitem filter run before it, then the spine and the top-10's sort;
# Q9-style's five joins; each join type one exchange; the order_by one
# range exchange
_NONE = {"join_exchange": 0, "join_fused_pre": 0, "sort_exchange": 0,
         "spmd_aggregate": 0, "chunked_fallback": 0}
DIST_COUNTS = {
    "Q1": {**_NONE, "spmd_aggregate": 1, "sort_exchange": 1},
    "Q3": {**_NONE, "join_exchange": 1, "join_fused_pre": 1,
           "spmd_aggregate": 1, "sort_exchange": 1},
    "Q9-style": {**_NONE, "join_exchange": 5, "spmd_aggregate": 1,
                 "sort_exchange": 1},
    "order_by": {**_NONE, "sort_exchange": 1},
    **{f"join {jt}": {**_NONE, "join_exchange": 1} for jt in JOIN_TYPES},
}


# Q1 and Q3 from host Tables split by rank: each rank uploads its range of
# phase 3l's host Tables, and the plans run as over ShardBatch sources
HOST_SPLIT_PATHS = (("Q1 host split", "q1_plan", ("lineitem",)),
                    ("Q3 host split", "q3_plan",
                     ("customer", "orders", "lineitem")))
for _name, _, _ in HOST_SPLIT_PATHS:
    DIST_COUNTS[_name] = DIST_COUNTS[_name[:2]]
    DIST_LAUNCHES[_name] = DIST_LAUNCHES[_name[:2]]

# The Table-level entry points (parallel.shard_table,
# distributed_join_tables, distributed_sort_table, broadcast_join_tables,
# salted_join_tables) over phase 3l's host orders and customer, projected to
# their fixed-width columns and one dictionary column each. Every rank gets
# the whole result as a host Table, held by its digest (host_digest) to a
# numpy oracle made once (table_oracles). The salted join's orders have 2
# of every 3 rows on o_custkey DIST_HOT_KEY.
TABLE_ORDERS = ["o_orderkey", "o_custkey", "o_totalprice", "o_orderdate",
                "o_orderpriority"]
TABLE_CUSTOMER = ["c_custkey", "c_nationkey", "c_acctbal", "c_mktsegment"]
TABLE_SORT_KEYS = [("o_orderdate", "ascending"), ("o_orderkey", "ascending")]
TABLE_JOIN_TYPES = ("inner", "full outer")
TABLE_PATHS = (["shard_table"] + [f"join_tables {jt}" for jt in
                                  TABLE_JOIN_TYPES]
               + ["sort_table", "broadcast_tables", "salted_tables"])
# Launches a rank, each path +1 probe (self_check), reckoned from
# parallel/distributed.py and acero/exec.py's join (and counted on four
# CPU ranks by wrapping the kernels' plain versions): shard_table none (an
# upload and one all-gather of the dictionaries' digests); the exchanges
# none (a stable sort by partition id); the local inner join of what a rank
# received, orders at 10x customer's rows, the bloom (2 hash32: the build's
# words, the probe's) and 2 compact (the probe rows the bloom passes, the
# matched rows); a full outer join no bloom and 1 compact (the unmatched
# build rows it appends); the sort none (splitters, a range exchange, a
# stable sort); the broadcast join's local join of a rank's orders with all
# of customer, 2.5x its rows: no bloom, 1 compact; the salted join the partitioned inner join's 2 + 2 and the
# compaction of the hot keys among the counted ones, 1
_TABLE_JOIN = {"compact": 2, "hash32": 2, "grouped_sum": 0, "probe": 1}
_TABLE_NONE = {"compact": 0, "hash32": 0, "grouped_sum": 0, "probe": 1}
_TABLE_ONE = {**_TABLE_NONE, "compact": 1}
TABLE_LAUNCHES = {
    "shard_table": _TABLE_NONE, "join_tables inner": _TABLE_JOIN,
    "join_tables full outer": _TABLE_ONE, "sort_table": _TABLE_NONE,
    "broadcast_tables": _TABLE_ONE,
    "salted_tables": {**_TABLE_JOIN, "compact": 3}}
for _name in TABLE_PATHS:
    DIST_COUNTS[_name] = _NONE  # no plan runs: EXCHANGE_COUNTS stay 0
    DIST_LAUNCHES[_name] = TABLE_LAUNCHES[_name]


def _mix_np(x):
    """splitmix64's finalizer over uint64 numpy (``io/tpch_device._mix``);
    the products wrap."""
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _value_hash(v):
    import hashlib
    return int.from_bytes(hashlib.blake2b(repr(v).encode(),
                                          digest_size=8).digest(), "little")


def _words(a):
    """(uint64 word a row, validity) of a host Array: a fixed-width value's
    bits, a dictionary column's value by its hash (two dictionaries of one
    column then compare by value)."""
    from arrow_tpu_torch.types import TypeId
    valid = a.is_valid_mask()
    v = a.data.values()
    if a.type.id == TypeId.DICTIONARY:
        vh = np.array([_value_hash(x) for x in a.dictionary.to_pylist()]
                      or [0], dtype=np.uint64)
        return vh[np.where(valid, v.astype(np.int64), 0)], valid
    if v.itemsize != 8:
        v = v.astype(np.int64)
    return v.view(np.uint64), valid


_POSITION_WEIGHTS = [np.zeros(0, np.uint64)]


def _position_weights(stop):
    """splitmix64 of each global position below ``stop`` (uint64), made
    once and grown as needed."""
    w = _POSITION_WEIGHTS[0]
    if len(w) < stop:
        w = _POSITION_WEIGHTS[0] = _mix_np(np.arange(stop, dtype=np.uint64))
    return w[:stop]


def digest_words(cols, n, offset=0):
    """Per (words, validity) column of ``n`` rows at global position
    ``offset``: the uint64 sum of word x splitmix64(position) over the
    valid rows (0 under a null), then the same of the validity. A part's
    digests add (mod 2**64) to the whole's; a row moved, dropped or
    changed changes them."""
    key = _position_weights(offset + n)[offset:]
    whole = int(key.sum(dtype=np.uint64))
    out = []
    for words, valid in cols:
        if valid.all():
            out += [int((words * key).sum(dtype=np.uint64)), whole]
        else:
            out += [int((np.where(valid, words, np.uint64(0)) * key)
                        .sum(dtype=np.uint64)),
                    int(key[valid].sum(dtype=np.uint64))]
    return out


def host_digest(table, offset=0):
    """A host Table's (names and types, rows, digests by column)."""
    return ([(f.name, repr(f.type)) for f in table.schema.fields],
            table.num_rows,
            digest_words([_words(c.combine()) for c in table.columns],
                         table.num_rows, offset))


def _timed_call(fn, *args):
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


def table_sides(host):
    """orders and customer as the Table paths take them, and the salted
    join's orders."""
    from arrow_tpu_torch.array.array import array
    orders = host["orders"].select(TABLE_ORDERS)
    ck = orders.column("o_custkey").combine().data.values()
    pos = np.arange(len(ck))
    hot = np.where(pos % DIST_HOT_EVERY < DIST_HOT_EVERY - 1, DIST_HOT_KEY,
                   ck)
    i = orders.schema.get_field_index("o_custkey")
    skewed = orders.set_column(i, orders.schema.field(i), array(hot))
    return orders, host["customer"].select(TABLE_CUSTOMER), skewed


def table_oracles(host):
    """Every Table path's expected (names and types, rows, digests) from
    numpy: o_orderkey is 1..n in order and c_custkey 1..m, every o_custkey
    a customer's, so a join with customer is a lookup in orders' order
    (each order matches one customer), a full outer join appends the
    customers without orders in their order, and the sort is numpy's
    stable argsort."""
    orders, customer, skewed = table_sides(host)
    ow = [_words(orders.column(c).combine()) for c in TABLE_ORDERS]
    cw = [_words(customer.column(c).combine()) for c in TABLE_CUSTOMER]
    n, m = orders.num_rows, customer.num_rows
    ok = orders.column("o_custkey").combine().data.values()
    if not np.array_equal(customer.column("c_custkey").combine().data
                          .values(), np.arange(1, m + 1)) \
            or ok.min() < 1 or ok.max() > m:
        raise AssertionError("3k tables: customer keys are not 1..m")
    schema = [(f.name, repr(f.type)) for f in
              list(orders.schema.fields) + list(customer.schema.fields)]

    def joined(words, look, extra=None):
        cols = list(words) + [(w[look], v[look]) for w, v in cw]
        if extra is not None:
            u = len(extra)
            cols = [(np.concatenate([w, np.zeros(u, np.uint64)]),
                     np.concatenate([v, np.zeros(u, bool)]))
                    for w, v in cols[:len(words)]] + [
                (np.concatenate([w, cw[i][0][extra]]),
                 np.concatenate([v, cw[i][1][extra]]))
                for i, (w, v) in enumerate(cols[len(words):])]
        rows = len(look) + (0 if extra is None else len(extra))
        return schema, rows, digest_words(cols, rows)

    look = ok - 1
    has = np.zeros(m, bool)
    has[look] = True
    exp = {"shard_table": (schema[:len(TABLE_ORDERS)], n,
                           digest_words(ow, n))}
    exp["join_tables inner"] = exp["broadcast_tables"] = joined(ow, look)
    exp["join_tables full outer"] = joined(ow, look,
                                           np.nonzero(~has)[0])
    perm = _stable_argsort_by(
        orders.column("o_orderdate").combine().data.values(),
        orders.column("o_orderkey").combine().data.values())
    exp["sort_table"] = (schema[:len(TABLE_ORDERS)], n, digest_words(
        [(w[perm], v[perm]) for w, v in ow], n))
    sw = [_words(skewed.column(c).combine()) for c in TABLE_ORDERS]
    exp["salted_tables"] = joined(
        sw, skewed.column("o_custkey").combine().data.values() - 1)
    return exp


def _table_paths(mesh, host, res, device):
    """The Table-level entry points on one rank, each recorded with
    ``_rank_path``: its result's host_digest (shard_table: this rank's
    part downloaded, at its offset, and its range)."""
    from arrow_tpu_torch import parallel as P
    from arrow_tpu_torch.device.column import download_table
    from arrow_tpu_torch.parallel import distributed as D
    orders, customer, skewed = table_sides(host)
    keys = (["o_custkey"], ["c_custkey"])

    def shard():
        part = P.shard_table(mesh, orders)
        return ((part.offset, int(part.row_count), part.total),
                host_digest(download_table(part), part.offset))
    _rank_path(res, "shard_table", shard, device, release=True)
    for jt in TABLE_JOIN_TYPES:
        _rank_path(res, f"join_tables {jt}", lambda jt=jt: host_digest(
            P.distributed_join_tables(mesh, orders, customer, *keys, jt)),
            device, release=True)
    _rank_path(res, "sort_table", lambda: host_digest(
        P.distributed_sort_table(mesh, orders, TABLE_SORT_KEYS)), device,
        release=True)
    _rank_path(res, "broadcast_tables", lambda: host_digest(
        P.broadcast_join_tables(mesh, orders, customer, *keys)), device,
        release=True)
    _rank_path(res, "salted_tables", lambda: host_digest(
        P.salted_join_tables(mesh, skewed, customer, *keys,
                             hot_threshold=orders.num_rows // 10,
                             n_salts=DIST_SALTS)), device, release=True)
    res["salted_tables"]["received"] = D.LAST_JOIN["probe_rows"]


def _table_check(results, exp):
    """Every rank's Table results against the oracles: the same Table on
    every rank, its names, types, rows and digests exact; shard_table's
    parts contiguous and adding to the whole; the salted join's largest
    rank under half the probe rows."""
    for name in TABLE_PATHS:
        recs = [r[name]["out"] for r in results]
        names, rows, want = exp[name]
        if name == "shard_table":
            ranges = [rec[0] for rec in recs]
            starts = [sum(r[1] for r in ranges[:i])
                      for i in range(len(ranges))]
            got = [_wrap(sum(col)) for col in zip(*(rec[1][2]
                                                    for rec in recs))]
            if [r[0] for r in ranges] != starts or \
                    {r[2] for r in ranges} != {rows} or \
                    sum(r[1] for r in ranges) != rows or \
                    got != [_wrap(w) for w in want] or \
                    any(rec[1][0] != names for rec in recs):
                raise AssertionError(f"3k {name}: parts {ranges} do not "
                                     "make the whole Table")
            log(f"  {name}: rank parts {[r[1] for r in ranges]} of {rows} "
                f"rows, bit for bit the host Table's")
            continue
        for rank, rec in enumerate(recs):
            if rec != (names, rows, want):
                raise AssertionError(
                    f"3k {name}: rank {rank} holds {rec[1]} rows "
                    f"({'same' if rec[0] == names else 'other'} columns, "
                    f"digests {'agree' if rec[2] == want else 'differ'}); "
                    f"the oracle {rows} rows")
        log(f"  {name}: every rank holds the whole {rows}-row Table, bit "
            f"for bit the numpy oracle's (keys, counts, validity and order "
            f"exact)")
    got = [r["salted_tables"]["received"] for r in results]
    n = exp["shard_table"][1]
    log(f"3k salted_tables: probe rows received by rank {got} (of {n})")
    if max(got) >= n / 2:
        raise AssertionError("3k salted_tables: salting did not spread the "
                             "hot key")


def share_host_tables(tables):
    """Host Tables as specs that cross to a spawned rank: every buffer a
    CPU tensor in shared memory (copied once), the rest as it is."""
    from arrow_tpu_torch.device.column import host_tensor

    def spec(d):
        return (d.type, d.length, d._null_count, d.offset,
                [None if b is None else host_tensor(b.to_numpy()).clone()
                 .share_memory_() for b in d.buffers],
                [spec(c) for c in d.children],
                None if d.dictionary is None else spec(d.dictionary))
    return {name: (t.schema, [[spec(ch.data) for ch in col.chunks]
                              for col in t.columns])
            for name, t in tables.items()}


def unshare_host_tables(specs):
    """``share_host_tables``' specs as host Tables over the shared memory
    (no copy)."""
    from arrow_tpu_torch.array.array import Array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.buffer import Buffer
    from arrow_tpu_torch.table import ChunkedArray, Table

    def data(sp):
        t, n, nulls, off, bufs, kids, dic = sp
        return ArrayData(t, n, [None if b is None else Buffer(b.numpy())
                                for b in bufs], [data(k) for k in kids],
                         nulls, off, None if dic is None else data(dic))
    return {name: Table(schema, [ChunkedArray([Array(data(c)) for c in col],
                                              f.type)
                                 for f, col in zip(schema.fields, cols)])
            for name, (schema, cols) in specs.items()}


def digest(batch, offset=0):
    """Per column, an order-sensitive digest of its live rows: the int64
    sum of splitmix64(value bits ^ splitmix64(global position)), values 0
    under a null, then the same of the validity. A part's digests at its
    offset add (mod 2**64) to the whole's."""
    from arrow_tpu_torch.io.tpch_device import _mix
    n = int(batch.row_count)
    key = _mix(torch.arange(offset, offset + n, dtype=torch.int64,
                            device=batch.row_count.device))
    out = []
    for c in batch.columns:
        valid = c.valid_mask()[:n]
        v = torch.where(valid, _bits(c.values[:n]).long(), 0)
        out += [int(_mix(v ^ key).sum()), int(_mix(valid.long() ^ key).sum())]
    return out


def _wrap(x):
    return (x + 2**63) % 2**64 - 2**63


def dist_tables(tables):
    """The tables the ranks read whole or by their range, narrowed to the
    columns of the paths (CUDA IPC shares them; big dictionaries stay
    behind)."""
    cols = {"orders": ["o_orderkey", "o_custkey", "o_orderdate"],
            "customer": ["c_custkey", "c_mktsegment"],
            "part": ["p_partkey", "p_type"],
            "supplier": ["s_suppkey", "s_nationkey"],
            "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"],
            "nation": ["n_nationkey", "n_name"]}
    return {k: tables[k].select(v) for k, v in cols.items()}


def _skewed(lineitem, start):
    """lineitem's (l_orderkey, l_extendedprice) with 2 of every 3 rows
    (by global position from ``start``) on l_orderkey DIST_HOT_KEY."""
    from arrow_tpu_torch.device.column import DeviceBatch, DeviceColumn
    b = lineitem.select(["l_orderkey", "l_extendedprice"])
    pos = torch.arange(start, start + b.capacity, device=b.row_count.device)
    key = b.columns[0]
    hot = torch.where(pos % DIST_HOT_EVERY < DIST_HOT_EVERY - 1,
                      DIST_HOT_KEY, key.values)
    return DeviceBatch(b.schema, [DeviceColumn(hot, None, key.type),
                                  b.columns[1]], b.row_count)


def _orders_customer(ac, orders, customer, jt):
    building = ac.Declaration.from_sequence([
        ac.Declaration("table_source", ac.TableSourceNodeOptions(customer)),
        ac.Declaration("filter", ac.FilterNodeOptions(
            ac.field("c_mktsegment") == "BUILDING"))])
    return join_declaration(jt, orders, building, left_keys=["o_custkey"],
                            right_keys=["c_custkey"],
                            left_output=["o_orderkey"],
                            right_output=["c_custkey"])


def _sort_decl(ac, lineitem):
    return ac.Declaration.from_sequence([
        ac.Declaration("table_source", ac.TableSourceNodeOptions(lineitem)),
        ac.Declaration("project", ac.ProjectNodeOptions(
            [ac.field(c) for c in DIST_SORT_COLUMNS], DIST_SORT_COLUMNS)),
        ac.Declaration("order_by", ac.OrderByNodeOptions(DIST_SORT_KEYS))])


def _broadcast_sides(lineitem, supplier):
    return (lineitem.select(["l_orderkey", "l_suppkey", "l_extendedprice"]),
            supplier.select(["s_suppkey", "s_nationkey"]))


def _rank_path(res, name, run, device, repeat=False, release=False):
    """One path on a rank: launches zeroed just before and read just after
    (with the probe of ``self_check``), EXCHANGE_COUNTS, the exchanges'
    bytes and time, the wall and this rank's peak memory; ``repeat`` runs
    it a second time for the float bits. ``release``: the rank first hands
    back what its caching allocator kept (the Table paths, each of which
    holds its whole result on every rank, so the path allocates anew).
    Keeps what ``run`` returns."""
    from arrow_tpu_torch.acero import dist_exec
    from arrow_tpu_torch.parallel import distributed as D
    from arrow_tpu_torch.platform_check import self_check
    cuda = device.type == "cuda"
    if cuda:
        if release:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    D.reset_stats()
    dist_exec.reset_exchange_counts()
    zero_launches()
    self_check()
    t0 = time.perf_counter()
    out = run()
    if cuda:
        torch.cuda.synchronize()
    rec = {"wall": time.perf_counter() - t0, "launches": read_launches(),
           "counts": dict(dist_exec.EXCHANGE_COUNTS), "stats": dict(D.STATS),
           "peak": (torch.cuda.max_memory_allocated() - base) if cuda else 0,
           "out": out}
    if repeat:
        rec["again"] = run()
    res[name] = rec


def _part_record(part):
    """(offset, rows, total, digests) of this rank's part of a result."""
    return (part.offset, int(part.row_count), part.total,
            digest(part, part.offset))


def dist_rank(rank, world, store, shared, sf, device, outbox):
    """One rank of phase 3k: joins the gloo group, makes its shards, runs
    every path and puts its records (or its traceback) in ``outbox``."""
    import datetime as dt
    import torch.distributed as dist
    res = {}
    try:
        device = torch.device(device)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=dt.timedelta(seconds=DIST_TIMEOUT))
        pair = dist.new_group(list(range(DIST_PAIR)))
        _dist_paths(rank, world, pair, shared, sf, device, res)
        outbox.put((rank, "ok", res))
    except BaseException:  # noqa: BLE001 - the parent fails the phase
        outbox.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dist_paths(rank, world, pair, shared, sf, device, res):
    """Phase 3k's paths on one rank, each recorded in ``res``."""
    import arrow_tpu_torch.acero as ac
    from arrow_tpu_torch.acero.exec import execute_distributed
    from arrow_tpu_torch.device.column import download
    from arrow_tpu_torch.io.tpch_device import (q1_device_batch,
                                                q3_device_tables, shard_rows)
    from arrow_tpu_torch.io.tpch_queries import q1_plan, q3_plan, q9_style_plan
    from arrow_tpu_torch.parallel import (ShardBatch, broadcast_join_batches,
                                          distributed_join_batches,
                                          distributed_q1, make_mesh,
                                          salted_join_batches)
    from arrow_tpu_torch.parallel import distributed as D
    mesh = make_mesh(device=device)

    def own(batch, n, start):
        return ShardBatch(batch.schema, batch.columns, batch.row_count, start,
                          n)

    n_li = int(6_001_215 * sf)
    start, stop = shard_rows(n_li, rank, world)
    li, _ = q1_device_batch(sf, device=device, rows=(start, stop))
    li = own(li, n_li, start)
    _rank_path(res, "Q1", lambda: q1_plan(li).to_table(mesh=mesh).to_pydict(), device,
               repeat=True)
    _rank_path(res, "distributed_q1",
               lambda: download(distributed_q1(mesh, li)), device,
               repeat=True)
    q3 = {k: own(b, n, shard_rows(n, rank, world)[0])
          for k, (b, n) in q3_device_tables(sf, device=device,
                                            shard=(rank, world)).items()}
    _rank_path(res, "Q3", lambda: q3_plan(
        q3["customer"], q3["orders"], q3["lineitem"]).to_table(mesh=mesh).to_pydict(),
        device, repeat=True)
    del q3
    for jt in JOIN_TYPES:
        _rank_path(res, f"join {jt}", lambda jt=jt: _part_record(
            execute_distributed(_orders_customer(
                ac, shared["orders"], shared["customer"], jt), mesh)),
            device)
    _rank_path(res, "order_by", lambda: _part_record(
        execute_distributed(_sort_decl(ac, li), mesh)), device)
    probe, build = _broadcast_sides(li, shared["supplier"])
    _rank_path(res, "broadcast", lambda: _part_record(
        broadcast_join_batches(mesh, probe, build, ["l_suppkey"],
                               ["s_suppkey"])), device)
    skewed = own(_skewed(li, start), n_li, start)
    orders = shared["orders"].select(["o_orderkey", "o_custkey"])
    for name, fn, kw in (
            ("partitioned", distributed_join_batches, {}),
            ("salted", salted_join_batches,
             {"hot_threshold": n_li // 10, "n_salts": DIST_SALTS})):
        _rank_path(res, name, lambda fn=fn, kw=kw: _part_record(
            fn(mesh, skewed, orders, ["l_orderkey"], ["o_orderkey"], **kw)),
            device)
        res[name]["received"] = D.LAST_JOIN["probe_rows"]
    del li, probe, skewed
    if "host" in shared:
        from arrow_tpu_torch.acero import source_cache
        from arrow_tpu_torch.io import tpch_queries
        host = unshare_host_tables(shared["host"])
        for name, fn, names in HOST_SPLIT_PATHS:
            source_cache.reset_upload_stats()
            _rank_path(res, name, lambda fn=fn, names=names: getattr(
                tpch_queries, fn)(*(host[t] for t in names)).to_table(
                    mesh=mesh).to_pydict(), device, repeat=True)
            res[name]["uploads"] = dict(source_cache.UPLOAD_STATS)
        res["Q1 host split"]["shares"] = {
            t: (*shard_rows(tbl.num_rows, rank, world), tbl.num_rows)
            for t, tbl in host.items()}
        source_cache.release()
        _table_paths(mesh, host, res, device)
        del host
        source_cache.release()
        if device.type == "cuda":
            # the Table paths' caches go back before Q9-style's two ranks
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    if rank < DIST_PAIR:
        pair_mesh = make_mesh(pair, device=device)
        rows = shard_rows(n_li, rank, DIST_PAIR)
        li2, _ = q1_device_batch(sf, device=device, rows=rows)
        li2 = own(li2, n_li, rows[0])
        _rank_path(res, "Q9-style", lambda: q9_style_plan(
            shared["part"], shared["supplier"], li2, shared["partsupp"],
            shared["orders"], shared["nation"]).to_table(mesh=pair_mesh).to_pydict(),
            device, repeat=True)


def _stable_argsort_by(major, minor):
    """np.argsort(major << 32 | minor, kind="stable") for int32 ``major``
    and ``minor`` in [0, 2**32), where major spans under 2**16 values, by
    stable passes of numpy's radix sort over 16-bit digits: one (major less
    its least) where minor is already nondecreasing, else three (minor's
    low, its high, then major); the same permutation."""
    major = major.astype(np.int64)
    lo = major.min(initial=0)
    if len(minor) and major.max() - lo < 1 << 16 and \
            bool((minor[1:] >= minor[:-1]).all()):
        # rows already in minor's order (lineitem by l_orderkey): within
        # one major value a stable sort keeps them so; one radix pass
        return np.argsort((major - lo).astype(np.uint16), kind="stable")
    minor = minor.astype(np.int64)
    if len(major) == 0 or major.max() - lo >= 1 << 16 or minor.min() < 0 \
            or minor.max() >= 1 << 32:
        return np.argsort(major << 32 | minor, kind="stable")
    perm = np.argsort((minor & 0xFFFF).astype(np.uint16), kind="stable")
    for digit in ((minor >> 16).astype(np.uint16), (major - lo).astype(
            np.uint16)):
        perm = perm[np.argsort(digit[perm], kind="stable")]
    return perm


def _dist_expected(tables, shared, sf, device, joins=None):
    """The single-rank whole-table run of every phase 3k path on this
    process, each held against its numpy oracle: small results as
    ``download`` dicts, the rest as (rows, digests); the joins' from
    ``joins`` where given (phase 3b's runs of them)."""
    import arrow_tpu_torch.acero as ac
    from arrow_tpu_torch.acero.exec import execute_declaration
    from arrow_tpu_torch.device.column import batch_from_numpy, download
    from arrow_tpu_torch.io.tpch_device import q3_device_plan
    from arrow_tpu_torch.io.tpch_queries import q1_plan
    t0 = time.perf_counter()
    li = tables["lineitem"]
    n = int(li.row_count)
    exp = {}
    exp["Q1"] = q1_plan(li).to_table().to_pydict()
    check_result("Q1 single-rank", exp["Q1"], q1_oracle(li, n))
    plan, _ = q3_device_plan(sf, device=device)
    exp["Q3"] = plan.to_table().to_pydict()
    check_result("Q3 single-rank", exp["Q3"], q3_oracle(plan)[0])
    del plan
    q9 = next(q for q in SUITE if q.name == "Q9")
    exp["Q9-style"] = suite_plan(q9, tables).to_table().to_pydict()
    check_result("Q9-style single-rank", exp["Q9-style"],
                 q9.oracle(tables, _suite_columns(tables))[0])
    log(f"3k: Q1, Q3 and Q9-style single-rank runs match their oracles "
        f"({time.perf_counter() - t0:.1f} s)")

    def whole(batch):
        return int(batch.row_count), digest(batch)

    orders, customer = shared["orders"], shared["customer"]
    od = _host_columns(orders, ["o_orderkey", "o_custkey"])
    if joins is not None:
        # a join's columns: the outputs named, but a right semi or anti
        # join's, which are the build side's (here 3k's narrower customer)
        for jt in JOIN_TYPES:
            names = (customer.schema.names if jt.startswith("right ")
                     and jt.endswith(("semi", "anti")) else
                     ["o_orderkey"] if jt.startswith("left ")
                     and jt.endswith(("semi", "anti")) else
                     ["o_orderkey", "c_custkey"])
            rows, by_name = joins[jt]
            exp[f"join {jt}"] = (rows, [d for nm in names
                                        for d in by_name[nm]])
    else:
        cu = _host_columns(customer, ["c_custkey", "c_mktsegment"])
        building = cu["c_mktsegment"] == customer.column(
            "c_mktsegment").dictionary.index("BUILDING")
        ps = JoinSide(od["o_custkey"], np.ones(len(od["o_custkey"]), bool),
                      "o_orderkey", od["o_orderkey"])
        bs = JoinSide(cu["c_custkey"][building],
                      np.ones(building.sum(), bool), "c_custkey",
                      cu["c_custkey"][building])
        runs = match_runs(ps, bs)
        for jt in JOIN_TYPES:
            batch = execute_declaration(_orders_customer(ac, orders,
                                                         customer, jt))
            check_join(jt, batch, ps, bs, runs)
            exp[f"join {jt}"] = whole(batch)
        del batch

    def on_card(cols, rows):
        return batch_from_numpy(cols, rows, device=device)

    batch = execute_declaration(_sort_decl(ac, li))
    exp["order_by"] = whole(batch)
    del batch
    host = _host_columns(li, DIST_SORT_COLUMNS + ["l_suppkey"])
    perm = _stable_argsort_by(host["l_shipdate"], host["l_orderkey"])
    sort_types = {"l_orderkey": "int64", "l_linenumber": "int64",
                  "l_shipdate": "date32", "l_extendedprice": "float64"}
    want = digest(on_card([(c, sort_types[c], host[c][perm], None, None)
                           for c in DIST_SORT_COLUMNS], n))
    if want != exp["order_by"][1]:
        raise AssertionError("order_by: the single-rank run differs from "
                             "numpy's stable argsort")
    del perm
    log(f"3k: order_by single-rank and its oracle at "
        f"{time.perf_counter() - t0:.1f} s")
    probe, build = _broadcast_sides(li, shared["supplier"])
    batch = execute_declaration(join_declaration(
        "inner", probe, build, left_keys=["l_suppkey"],
        right_keys=["s_suppkey"], output_suffix_for_left="_l",
        output_suffix_for_right="_r"))
    exp["broadcast"] = whole(batch)
    nations = _host_columns(shared["supplier"],
                            ["s_nationkey"])["s_nationkey"]
    sk = host["l_suppkey"]
    want = digest(on_card([
        ("l_orderkey", "int64", host["l_orderkey"], None, None),
        ("l_suppkey", "int64", sk, None, None),
        ("l_extendedprice", "float64", host["l_extendedprice"], None, None),
        ("s_suppkey", "int64", sk, None, None),
        ("s_nationkey", "int64", nations[sk - 1], None, None)], n))
    if want != exp["broadcast"][1]:
        raise AssertionError("broadcast: the single-rank join differs from "
                             "its numpy lookup")
    log(f"3k: broadcast single-rank and its oracle at "
        f"{time.perf_counter() - t0:.1f} s")
    skewed = _skewed(li, 0)
    batch = execute_declaration(join_declaration(
        "inner", skewed, orders.select(["o_orderkey", "o_custkey"]),
        left_keys=["l_orderkey"], right_keys=["o_orderkey"],
        output_suffix_for_left="_l", output_suffix_for_right="_r"))
    exp["partitioned"] = exp["salted"] = whole(batch)
    keys = _host_columns(skewed, ["l_orderkey"])["l_orderkey"]
    want = digest(on_card([
        ("l_orderkey", "int64", keys, None, None),
        ("l_extendedprice", "float64", host["l_extendedprice"], None, None),
        ("o_orderkey", "int64", keys, None, None),
        ("o_custkey", "int64", od["o_custkey"][keys - 1], None, None)], n))
    if want != exp["salted"][1]:
        raise AssertionError("skewed join: the single-rank join differs from "
                             "its numpy lookup")
    del batch, skewed, host
    log(f"3k: the single-rank runs of the joins, the order_by and the "
        f"skewed join match their oracles "
        f"({time.perf_counter() - t0:.1f} s with the above)")
    return exp


def _same_bits(a, b):
    return {k: [repr(v) for v in c] for k, c in a.items()} == \
        {k: [repr(v) for v in c] for k, c in b.items()}


def _dist_check(results, exp, cuda):
    """Every rank's records of phase 3k against the single-rank runs and
    the counts and launches reckoned from the code. Returns rank 0's
    launches by path."""
    W = len(results)
    for name in results[0]:
        recs = [r[name] for r in results if name in r]
        wall = max(r["wall"] for r in recs)
        sent = sum(r["stats"]["bytes_sent"] for r in recs)
        remote = sum(r["stats"]["bytes_remote"] for r in recs)
        ex_s = max(r["stats"]["seconds"] for r in recs)
        peaks = ", ".join(f"{r['peak'] / 2**30:.2f}" for r in recs)
        log(f"3k {name} ({len(recs)} gloo ranks sharing one card): wall "
            f"{wall:.3f} s, {sent / 1e9:.3f} GB exchanged ({remote / 1e9:.3f}"
            f" GB between ranks) in {ex_s:.3f} s of collectives, peak GiB "
            f"a rank {peaks}; counts {recs[0]['counts']}")
        for r in recs:
            want = DIST_COUNTS.get(name)
            if want is not None and r["counts"] != want:
                raise AssertionError(f"3k {name}: EXCHANGE_COUNTS "
                                     f"{r['counts']}, reckoned {want}")
            if cuda and name in DIST_LAUNCHES:
                check_launches(f"3k {name} (a rank)", r["launches"],
                               DIST_LAUNCHES[name])
            if "again" in r and not _same_bits(r["again"], r["out"]):
                raise AssertionError(f"3k {name}: a second run gave other "
                                     "float bits")
        want = exp.get(name)
        if isinstance(want, dict):
            for r in recs:
                check_result(f"3k {name} against the single-rank run",
                             r["out"], as_expected(want))
            log(f"  {name}: every rank's result matches the single-rank "
                f"run and its oracle (keys, counts and order exact, floats "
                f"within rtol {RTOL_F64}), the same float bits twice")
        elif want is not None:
            parts = [r["out"] for r in recs]
            offsets = [p[0] for p in parts]
            counts = [p[1] for p in parts]
            if offsets != [sum(counts[:i]) for i in range(len(parts))] or \
                    any(p[2] != sum(counts) for p in parts):
                raise AssertionError(f"3k {name}: parts not contiguous: "
                                     f"{[p[:3] for p in parts]}")
            got = [_wrap(sum(col)) for col in zip(*(p[3] for p in parts))]
            if sum(counts) != want[0] or got != want[1]:
                same = "agree" if got == want[1] else "differ"
                raise AssertionError(f"3k {name}: {sum(counts)} rows, "
                                     f"single-rank {want[0]}; digests "
                                     f"{same}")
            log(f"  {name}: {sum(counts)} rows in rank parts {counts}, bit "
                f"for bit the single-rank run's")
    plain = [r["partitioned"]["received"] for r in results]
    salted = [r["salted"]["received"] for r in results]
    n = sum(plain)
    log(f"3k skew: probe rows received by rank, partitioned {plain}, "
        f"salted {salted} (of {n})")
    if max(plain) < 2 * n / 3 or max(salted) >= n / 2:
        raise AssertionError("3k skew: salting did not spread the hot key")
    if W != DIST_RANKS:
        raise AssertionError(f"{W} ranks answered")
    return {f"3k {name}": rec["launches"]
            for name, rec in results[0].items()}


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nccl_check(sf, device):
    """A one-rank NCCL group in this process: Q3's filtered lineitem through
    ``exchange_rows`` comes back bit for bit."""
    import torch.distributed as dist
    from arrow_tpu_torch.acero import compile_chain
    from arrow_tpu_torch.acero import Declaration, FilterNodeOptions, field
    from arrow_tpu_torch.io.tpch_device import q3_device_tables
    from arrow_tpu_torch.io.tpch_queries import DATE_1995_03_15
    from arrow_tpu_torch.parallel import exchange_rows, make_mesh
    li, _ = q3_device_tables(sf, device=device)["lineitem"]
    kept = compile_chain([Declaration("filter", FilterNodeOptions(
        field("l_shipdate") > DATE_1995_03_15))])(li)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh()
        n = int(kept.row_count)
        back = exchange_rows(mesh, kept, torch.zeros(
            kept.capacity, dtype=torch.int32, device=mesh.device))
        if int(back.row_count) != n:
            raise AssertionError("NCCL exchange: row count changed")
        check_bit_exact(f"3k one-rank NCCL exchange of Q3's filtered "
                        f"lineitem ({n} rows, {mesh!r})",
                        [c.values[:n] for c in back.columns],
                        [c.values[:n] for c in kept.columns], "its input")
    finally:
        dist.destroy_process_group()


def _host_split_expected(host, dev, exp):
    """The single-rank runs of HOST_SPLIT_PATHS over phase 3l's host
    Tables into ``exp``, and the bytes a row of each Table's device form
    (its uploads kept from phase 3l)."""
    from arrow_tpu_torch.acero import TableSourceNodeOptions
    from arrow_tpu_torch.io import tpch_queries
    for name, fn, names in HOST_SPLIT_PATHS:
        exp[name] = getattr(tpch_queries, fn)(
            *(host[t] for t in names)).to_table(device=dev).to_pydict()
    row_bytes = {}
    for t in ("customer", "orders", "lineitem"):
        b = TableSourceNodeOptions(host[t]).upload(dev)
        row_bytes[t] = sum(c.values.element_size()
                           + (c.validity is not None) for c in b.columns)
    return row_bytes


def _host_split_check(results, row_bytes):
    """Each rank uploaded only its row share of the host Tables: its rows
    at most its share of each column, its bytes at most its share of each
    table's rows padded to the capacity of a block."""
    from arrow_tpu_torch.device.column import round_up
    for rank, r in enumerate(results):
        shares = r["Q1 host split"]["shares"]
        rows = sum(r[name]["uploads"]["rows"] for name, _, _ in
                   HOST_SPLIT_PATHS)
        nbytes = sum(r[name]["uploads"]["bytes"] for name, _, _ in
                     HOST_SPLIT_PATHS)
        bound = sum(row_bytes[t] * round_up(b - a)
                    for t, (a, b, _) in shares.items())
        whole = sum(row_bytes[t] * round_up(n) for t, (_, _, n) in
                    shares.items())
        if not 0 < nbytes <= bound or rows <= 0:
            raise AssertionError(f"3k rank {rank} uploaded {rows} rows, "
                                 f"{nbytes} bytes: its share of the host "
                                 f"Tables is at most {bound} bytes")
        log(f"3k host split: rank {rank} uploaded {rows} column rows, "
            f"{nbytes / 1e9:.3f} GB of its share's bound {bound / 1e9:.3f} "
            f"GB (ranges {shares}; whole Tables {whole / 1e9:.3f} GB)")


def phase_dist(tables, sf=SF, device="cuda", host=None, joins=None):
    """Phase 3k: distribution. The single-rank runs first, each against its
    oracle; then DIST_RANKS gloo ranks sharing this card, spawned, each
    making its shards (lineitem and Q3's tables by row range on the card,
    the host generator's tables by its range of this process's, shared
    through CUDA IPC), every path with its launches zeroed just before and
    read just after; then the one-rank NCCL exchange here. With ``host``
    (phase 3l's host Tables), Q1 and Q3 also run from host Tables split
    by rank (HOST_SPLIT_PATHS): the Tables cross to the ranks through
    shared memory, each rank uploads only its row range, and its uploads
    are held to its share; their uploads here are released first. A rank
    that fails or does not answer within DIST_TIMEOUT fails the phase.
    ``joins`` (phase 3b's single-rank runs of the same eight joins, each
    held to the join oracle there) stand for the joins' single-rank runs
    where given. Returns rank 0's launches by path."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    log(f"== phase 3k: distribution at SF{sf:g}: {DIST_RANKS} ranks under "
        f"gloo sharing one {dev.type} device (NCCL takes one rank a GPU: "
        f"it refuses two ranks of one communicator on one card); Q9-style "
        f"on ranks 0-{DIST_PAIR - 1}")
    t0 = time.perf_counter()
    if cuda:
        from arrow_tpu_torch.kernels import _build
        for src in _build.sources():
            _build.library(src.stem)
    shared = dist_tables(tables)
    # the Table paths' numpy oracles on a thread beside the single-rank runs
    # (host cores the parent leaves idle there; beside the ranks they would
    # take the ranks' cores)
    oracles = concurrent.futures.ThreadPoolExecutor(1)
    tables_done = None if host is None else oracles.submit(
        _timed_call, table_oracles, host)
    try:
        return _dist_phase(tables, sf, device, host, joins, shared,
                           tables_done, t0)
    finally:
        oracles.shutdown()


def _dist_phase(tables, sf, device, host, joins, shared, tables_done, t0):
    """``phase_dist`` once its oracles' thread runs."""
    import queue
    import shutil
    import tempfile
    import torch.multiprocessing as tmp
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    exp = _dist_expected(tables, shared, sf, dev, joins)
    if host is not None:
        t1 = time.perf_counter()
        row_bytes = _host_split_expected(host, dev, exp)
        from arrow_tpu_torch.acero import release_uploads
        for tbl in host.values():
            release_uploads(tbl)
        shared["host"] = share_host_tables(
            {t: host[t] for t in ("customer", "orders", "lineitem")})
        log(f"3k: Q1 and Q3 from phase 3l's host Tables single-rank, and "
            f"the Tables shared with the ranks, in "
            f"{time.perf_counter() - t1:.1f} s")
    if cuda:
        torch.cuda.empty_cache()
    ctx = tmp.get_context("spawn")
    d = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    outbox = ctx.Queue()
    procs = [ctx.Process(target=dist_rank, args=(
        r, DIST_RANKS, os.path.join(d, "store"), shared, sf, device, outbox))
        for r in range(DIST_RANKS)]
    results, errors = [None] * DIST_RANKS, []
    t1 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_TIMEOUT
        for _ in procs:
            while True:
                try:
                    rank, status, value = outbox.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode]
                    if dead or time.monotonic() > deadline:
                        raise AssertionError(
                            f"3k: a rank died (exit codes {dead}) or did "
                            f"not answer within {DIST_TIMEOUT} s") from None
            if status == "error":
                errors.append(f"rank {rank}:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(d, ignore_errors=True)
    if errors:
        raise AssertionError("3k: " + "\n".join(errors))
    log(f"3k: the ranks ran every path in {time.perf_counter() - t1:.1f} s, "
        f"spawning included")
    launches = _dist_check(results, exp, cuda)
    if host is not None:
        _host_split_check(results, row_bytes)
        exp_tables, took = tables_done.result()
        log(f"3k: the Table paths' numpy oracles took {took:.1f} s on their "
            f"thread")
        _table_check(results, exp_tables)
    if cuda:
        _nccl_check(sf, dev)
    log(f"phase 3k: {time.perf_counter() - t0:.1f} s")
    return launches


# --- phase 3l: the host boundary ---------------------------------------------

HOST_CHUNK_ROWS = 1 << 23
HOST_PLANS = (("Q1", "q1_plan", ("lineitem",)),
              ("Q3", "q3_plan", ("customer", "orders", "lineitem")),
              ("Q9", "q9_style_plan", ("part", "supplier", "lineitem",
                                       "partsupp", "orders", "nation")),
              ("Q13", "q13_plan", ("customer", "orders")),
              ("Q18", "q18_plan", ("customer", "orders", "lineitem")))
HOST_FLAGS = ["l_returnflag", "l_linestatus"]
HOST_SINK_QUANTITY = 49.0       # the consuming sink's filter: ~2% of rows
HOST_EAGER_QUANTITY = 25.0      # compute.filter's mask: about half the rows


def table_digest(tbl):
    """Per column, a digest of its combined Array's bits: type, length,
    null count, every buffer, its children and its dictionary. The columns
    are hashed on threads (hashlib lets the GIL go), each buffer where it
    lies."""
    import hashlib

    def data(h, d):
        h.update(repr((d.type, d.length, d.offset, d.null_count)).encode())
        for b in d.buffers:
            h.update(b"-" if b is None else b.to_numpy())
        for c in d.children:
            data(h, c)
        if d.dictionary is not None:
            data(h, d.dictionary)

    def column(item):
        f, col = item
        h = hashlib.sha256(f.name.encode())
        data(h, col.combine().data)
        return h.hexdigest()[:16]

    items = list(zip(tbl.schema.fields, tbl.columns))
    with concurrent.futures.ThreadPoolExecutor(
            max(1, min(8, len(items)))) as pool:
        return list(pool.map(column, items))


class HostTables(dict):
    """Phase 3l's host Tables by name, with what later phases take from 3l
    beside them: ``digests``, its plans' results digest by name (3s holds
    its runs of Q1 and Q3 to them), ``answers``, phase 3n's SQL results
    by name (3t holds its Flight SQL runs to them), and ``first(name)``, the first
    1/ROOM_DEPTH of a Table's rows, one slice a Table until
    ``drop_first()`` (3p and 3q share lineitem's and its uploads, 3q and
    3r orders' and its plain_orders)."""

    def __init__(self):
        super().__init__()
        self.digests = {}
        self.answers = {}
        self._first = {}

    def first(self, name):
        if name not in self._first:
            tbl = self[name]
            self._first[name] = tbl.slice(0, tbl.num_rows // ROOM_DEPTH)
        return self._first[name]

    def drop_first(self):
        self._first.clear()


def host_inputs(sf, device):
    """``sf``'s eight TPC-H tables generated once on the host: each as a
    host Table and as its maker's DeviceBatch on ``device`` (those that
    host_tables() and phase 3j generated, taken from them)."""
    from arrow_tpu_torch.io import tpch
    t0 = time.perf_counter()
    host, made = HostTables(), {}
    for name in tpch.TABLES:
        kept = _GENERATED.pop((name, sf), None)
        if kept is not None and kept[1].column(0).values.device.type == \
                torch.device(device).type:
            host[name], made[name] = kept
            continue
        host[name], made[name] = tpch.host_and_device(name, sf,
                                                      device=device)
    _sync(device)
    log(f"eight host Tables at SF{sf:g} ({host['lineitem'].num_rows} "
        f"lineitem rows) and their makers' batches generated in "
        f"{time.perf_counter() - t0:.1f} s")
    return host, made


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _same_batch(name, got, want):
    """Bit for bit: schema, capacity, row count, every column's values,
    validity and dictionary."""
    if got.schema.names != want.schema.names or \
            got.capacity != want.capacity or \
            int(got.row_count) != int(want.row_count):
        raise AssertionError(f"{name}: batch shape differs")
    for f, a, b in zip(want.schema.fields, got.columns, want.columns):
        if a.type != b.type or a.values.dtype != b.values.dtype or \
                not torch.equal(a.values, b.values):
            raise AssertionError(f"{name}.{f.name}: values differ")
        if (a.validity is None) != (b.validity is None) or (
                a.validity is not None
                and not torch.equal(a.validity, b.validity)):
            raise AssertionError(f"{name}.{f.name}: validity differs")
        if a.dictionary != b.dictionary:
            raise AssertionError(f"{name}.{f.name}: dictionary differs")


def _uploads(host, made, device):
    """Each host Table's source uploaded (its columns' uploads kept by
    ``acero.source_cache`` for the paths after), timed, against its
    maker's batch bit for bit."""
    from arrow_tpu_torch.acero import TableSourceNodeOptions
    total_bytes, total_wall = 0, 0.0
    for name in host:
        _sync(device)
        t0 = time.perf_counter()
        batch = TableSourceNodeOptions(host[name]).upload(device)
        _sync(device)
        wall = time.perf_counter() - t0
        nbytes = sum(c.values.numel() * c.values.element_size()
                     + (0 if c.validity is None else c.validity.numel())
                     for c in batch.columns)
        _same_batch(f"upload_table({name})", batch, made[name])
        total_bytes += nbytes
        total_wall += wall
        log(f"  upload {name}: {host[name].num_rows} rows, "
            f"{nbytes / 1e9:.3f} GB in {wall:.3f} s "
            f"({nbytes / wall / 1e9:.2f} GB/s), bit-identical to "
            f"{name}_table()")
    log(f"uploads: {total_bytes / 1e9:.3f} GB in {total_wall:.3f} s "
        f"({total_bytes / total_wall / 1e9:.2f} GB/s, host encoding "
        "included)")
    return total_bytes, total_wall


def _host_plan_oracle(name, made, cols, plan_over_made):
    if name == "Q1":
        return q1_oracle(made["lineitem"], int(made["lineitem"].row_count))
    if name == "Q3":
        return q3_oracle(plan_over_made)[0]
    if name == "Q9":
        return q9_oracle(made, cols)[0]
    if name == "Q13":
        return q13_oracle(made["customer"], made["orders"])[0]
    return q18_oracle(made, cols)[0]


def _host_plans(host, made, cols, device, cuda, launches):
    """Q1, Q3, Q9, Q13 and Q18 through ``table_source(Table)`` ->
    ``to_table()``, launches counted, against their oracles and, digest
    for digest, the same plan over the makers' batches; then the plan and
    the download apart."""
    from arrow_tpu_torch.acero.exec import _sources_on, execute_declaration
    from arrow_tpu_torch.device.column import download_table
    from arrow_tpu_torch.io import tpch_queries
    from arrow_tpu_torch.platform_check import self_check
    walls = {}
    for name, fn, names in HOST_PLANS:
        plan = getattr(tpch_queries, fn)(*(host[k] for k in names))
        over_made = getattr(tpch_queries, fn)(*(made[k] for k in names))
        if cuda:
            zero_launches()
            self_check()
        _sync(device)
        t0 = time.perf_counter()
        result = plan.to_table(device=device)
        _sync(device)
        first = time.perf_counter() - t0
        if cuda:
            launches[f"3l {name}"] = read_launches()
            zero_launches()
        if cuda:
            zero_launches()
            self_check()
        want_tbl = over_made.to_table(device=device)
        if cuda:
            made_launches = read_launches()
            log(f"{name} launches: Table source {launches[f'3l {name}']}, "
                f"DeviceBatch source {made_launches} (the probe "
                "launched once before each)")
            if made_launches != launches[f"3l {name}"] or not any(
                    v for k, v in made_launches.items() if k != "probe"):
                raise AssertionError(f"3l {name}: launches differ or none")
        check_result(f"3l {name}", result.to_pydict(),
                     _host_plan_oracle(name, made, cols, over_made))
        host.digests[name] = table_digest(result)
        if host.digests[name] != table_digest(want_tbl):
            raise AssertionError(f"3l {name}: digests differ from the "
                                 "DeviceBatch source's run")
        # the plan and the download apart (the sources' uploads are kept)
        pruned = _sources_on(plan._plan(), device)
        _sync(device)
        t0 = time.perf_counter()
        batch = execute_declaration(pruned)
        _sync(device)
        t1 = time.perf_counter()
        again = download_table(batch)
        t2 = time.perf_counter()
        if table_digest(again) != table_digest(result):
            raise AssertionError(f"3l {name}: a second run differs")
        walls[name] = (first, t1 - t0, t2 - t1)
        log(f"{name} from host Tables: {result.num_rows} rows, first "
            f"to_table() {first:.3f} s; plan {t1 - t0:.3f} s, download "
            f"{(t2 - t1) * 1e3:.1f} ms; matches its oracle and the "
            "DeviceBatch source's digests")
    return walls


def _first_seen(key, size):
    """Each of the ``size`` small non-negative keys' first row in ``key``
    (``len(key)`` where absent): np.unique's ``return_index`` without its
    sort of every row (the keys are found in a prefix, a key missing
    there by one scan)."""
    n = len(key)
    first = np.full(size, n, dtype=np.int64)
    head = key[:1 << 20]
    u, idx = np.unique(head, return_index=True)
    first[u] = idx
    present = np.bincount(key, minlength=size) > 0
    for v in np.flatnonzero(present & (first == n)):
        first[v] = int(np.argmax(key == v))
    return first


def _flag_groups(c):
    """Lineitem's (returnflag, linestatus) group a row, groups in order of
    first appearance, and the two flags' values a group."""
    key = c["l_returnflag"].astype(np.int64) * 8 + c["l_linestatus"]
    first = _first_seen(key, 8 * 8)
    keys = np.flatnonzero(first < len(key))
    keys = keys[np.argsort(first[keys], kind="stable")]
    rank = np.zeros(8 * 8, dtype=np.int64)
    rank[keys] = np.arange(len(keys))
    return rank[key], keys


def _list_parts(tbl, name):
    arr = tbl.column(name).combine()
    return arr.data.offsets().astype(np.int64), \
        arr.values.data.values()


def _host_aggregates(host, c, groups, device, cuda, launches):
    """hash_list and hash_distinct by lineitem's flags, hash_pivot_wider of
    l_quantity's sums over l_shipmode by l_returnflag, and a hash_list
    mixed with a device sum, each against numpy."""
    from arrow_tpu_torch.acero import (AggregateNodeOptions, Declaration,
                                       TableSourceNodeOptions)
    from arrow_tpu_torch.io.tpch import SHIPMODES
    from arrow_tpu_torch.platform_check import self_check
    li = host["lineitem"]
    gid, keys = groups
    ngroups = len(keys)
    # a stable sort of narrow ids is numpy's radix sort
    order = np.argsort(gid.astype(np.uint8), kind="stable")
    counts = np.bincount(gid, minlength=ngroups)

    def src():
        return Declaration("table_source", TableSourceNodeOptions(li))

    def run(name, decl):
        if cuda:
            zero_launches()
            self_check()
        _sync(device)
        t0 = time.perf_counter()
        out = decl.to_table(device=device)
        _sync(device)
        wall = time.perf_counter() - t0
        if cuda:
            launches[f"3l {name}"] = read_launches()
        log(f"{name}: {out.num_rows} groups in {wall:.3f} s, launches "
            f"{launches.get(f'3l {name}')}")
        return out

    out = run("hash_list", Declaration("aggregate", AggregateNodeOptions(
        [("l_quantity", "hash_list", None, "lst")], keys=HOST_FLAGS),
        [src()]))
    offs, vals = _list_parts(out, "lst")
    want = c["l_quantity"][order]
    if not (np.array_equal(offs, np.concatenate([[0], np.cumsum(counts)]))
            and np.array_equal(vals.view(np.int64), want.view(np.int64))):
        raise AssertionError("hash_list: lists differ from numpy's")

    out = run("hash_distinct", Declaration("aggregate", AggregateNodeOptions(
        [("l_linenumber", "hash_distinct", None, "dst")], keys=HOST_FLAGS),
        [src()]))
    ln = c["l_linenumber"]
    first = _first_seen(gid * 8 + ln, ngroups * 8)
    first = first[first < len(ln)]
    first = first[np.lexsort((first, gid[first]))]
    offs, vals = _list_parts(out, "dst")
    if not (np.array_equal(vals, ln[first]) and np.array_equal(
            np.diff(offs), np.bincount(gid[first], minlength=ngroups))):
        raise AssertionError("hash_distinct: lists differ from numpy's")

    inner = Declaration("aggregate", AggregateNodeOptions(
        [("l_quantity", "hash_sum", None, "qty")],
        keys=["l_returnflag", "l_shipmode"]), [src()])
    out = run("hash_pivot_wider", Declaration(
        "aggregate", AggregateNodeOptions(
            [(["l_shipmode", "qty"], "hash_pivot_wider",
              {"key_names": list(SHIPMODES)}, "by_mode")],
            keys=["l_returnflag"]), [inner]))
    rf, sm = c["l_returnflag"], c["l_shipmode"]
    sums = np.bincount(rf.astype(np.int64) * len(SHIPMODES) + sm,
                       weights=c["l_quantity"],
                       minlength=3 * len(SHIPMODES))
    rf_first = _first_seen(rf, 8)
    rf_order = np.flatnonzero(rf_first < len(rf))
    rf_order = rf_order[np.argsort(rf_first[rf_order])]
    got = out.to_pydict()
    flags = c["dict:l_returnflag"]
    if got["l_returnflag"] != [flags[k] for k in rf_order]:
        raise AssertionError("hash_pivot_wider: groups differ")
    for row, k in zip(got["by_mode"], rf_order):
        check_close("hash_pivot_wider sums", torch.tensor(
            [row[m] for m in SHIPMODES], dtype=torch.float64), torch.tensor(
                sums[k * len(SHIPMODES):(k + 1) * len(SHIPMODES)]),
            RTOL_F64)

    out = run("hash_list + hash_sum", Declaration(
        "aggregate", AggregateNodeOptions(
            [("l_quantity", "hash_list", None, "lst"),
             ("l_extendedprice", "hash_sum", None, "revenue")],
            keys=HOST_FLAGS), [src()]))
    offs, vals = _list_parts(out, "lst")
    if not np.array_equal(vals.view(np.int64), want.view(np.int64)):
        raise AssertionError("hash_list + hash_sum: lists differ")
    check_close("hash_list + hash_sum revenue", torch.tensor(
        out.column("revenue").to_numpy()), torch.tensor(np.bincount(
            gid, weights=c["l_extendedprice"], minlength=ngroups)),
        RTOL_F64)
    if cuda and not launches["3l hash_list + hash_sum"]["grouped_sum"]:
        raise AssertionError("the mixed aggregate's sum did not take K1")


def _consuming_sink(host, device, cuda, launches):
    """A filter of lineitem into a consuming sink: its batches equal
    ``to_table()`` of the same filter."""
    from arrow_tpu_torch.acero import (ConsumingSinkNodeOptions, Declaration,
                                       FilterNodeOptions,
                                       TableSourceNodeOptions, field)
    from arrow_tpu_torch.platform_check import self_check
    from arrow_tpu_torch.table import Table
    seen = []

    def chain():
        return Declaration("filter", FilterNodeOptions(
            field("l_quantity") > HOST_SINK_QUANTITY), [Declaration(
                "table_source", TableSourceNodeOptions(host["lineitem"]))])
    if cuda:
        zero_launches()
        self_check()
    Declaration("consuming_sink", ConsumingSinkNodeOptions(seen.append),
                [chain()]).to_table(device=device)
    if cuda:
        launches["3l consuming_sink"] = read_launches()
    want = chain().to_table(device=device)
    got = Table.from_batches(seen, want.schema)
    if table_digest(got) != table_digest(want):
        raise AssertionError("consuming_sink: batches differ from "
                             "to_table()")
    log(f"consuming_sink: {len(seen)} batch(es), {got.num_rows} rows, equal "
        f"to to_table(); launches {launches.get('3l consuming_sink')}")


def _eager(host, c, groups, device, cuda, launches):
    """compute.filter and the registered hash32 over 60M-row host Arrays,
    and Table.group_by(...).aggregate with a sum, each against numpy."""
    import arrow_tpu_torch.compute as pc
    from arrow_tpu_torch.array.array import array
    from arrow_tpu_torch.platform_check import self_check
    li = host["lineitem"]

    def timed_call(name, fn):
        if cuda:
            zero_launches()
            self_check()
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        if cuda:
            launches[f"3l {name}"] = read_launches()
        log(f"{name}: {time.perf_counter() - t0:.3f} s, launches "
            f"{launches.get(f'3l {name}')}")
        return out

    mask = c["l_quantity"] > HOST_EAGER_QUANTITY
    price = li.column("l_extendedprice")
    got = timed_call("compute.filter", lambda: pc.filter(
        price, array(mask), device=device))
    if not np.array_equal(got.to_numpy(), c["l_extendedprice"][mask]):
        raise AssertionError("compute.filter differs from numpy's")
    got = timed_call("compute.hash32", lambda: pc.hash32(
        li.column("l_orderkey"), device=device))
    if not np.array_equal(got.to_numpy(),
                          _np_hash32(_np_words(c["l_orderkey"]))):
        raise AssertionError("compute.hash32 differs from numpy's")
    got = timed_call("Table.group_by", lambda: li.group_by(
        HOST_FLAGS).aggregate([("l_extendedprice", "sum")], device=device))
    gid, _ = groups
    check_close("Table.group_by sum", torch.tensor(
        got.column("l_extendedprice_sum").to_numpy()), torch.tensor(
            np.bincount(gid, weights=c["l_extendedprice"])), RTOL_F64)
    if cuda:
        for name, k in (("compute.filter", "compact"),
                        ("compute.hash32", "hash32"),
                        ("Table.group_by", "grouped_sum")):
            if not launches[f"3l {name}"][k]:
                raise AssertionError(f"{name} did not launch {k}")


def _host_stream(host, device, cuda, launches):
    """Q1 streamed from the host lineitem Table in chunks, against the
    whole-table run."""
    from arrow_tpu_torch.acero.exec import last_plan_metrics
    from arrow_tpu_torch.io.tpch_queries import q1_plan
    from arrow_tpu_torch.platform_check import self_check
    plan = q1_plan(host["lineitem"])
    if cuda:
        zero_launches()
        self_check()
    rows = HOST_CHUNK_ROWS if cuda else max(host["lineitem"].num_rows // 7,
                                            1)
    t0 = time.perf_counter()
    got = plan.to_table(chunk_rows=rows, device=device)
    _sync(device)
    wall = time.perf_counter() - t0
    if cuda:
        launches["3l Q1 chunked"] = read_launches()
    src = last_plan_metrics.source
    whole = q1_plan(host["lineitem"]).to_table(device=device).to_pydict()
    check_result("3l Q1 chunked", got.to_pydict(), {
        k: np.asarray(v) if isinstance(v[0], float) else v
        for k, v in whole.items()})
    log(f"Q1 chunked from the host Table: {src.n_chunks} chunks of {rows} "
        f"rows in {wall:.3f} s, {src.h2d_bytes / 1e9:.3f} GB copied; equals "
        f"the whole-table run; launches {launches.get('3l Q1 chunked')}")


def phase_host(sf=SF, device="cuda"):
    """Phase 3l: the host boundary at ``sf``. The eight TPC-H tables made
    once on the host as Tables and as their makers' batches; each Table
    uploaded (timed) bit for bit the batch; Q1, Q3, Q9, Q13 and Q18 from
    host Tables to a host Table; Q1 streamed from the host lineitem;
    the host-tier aggregates; a consuming sink; the eager API over
    lineitem's host Arrays. Each path's launches are set to 0 just before
    and read just after (on the card). Returns the launches by path and
    the host Tables, whose uploads ``acero.source_cache`` keeps until the
    caller releases them (``acero.release_uploads``) after phases 3m and
    3k."""
    cuda = torch.device(device).type == "cuda"
    log(f"== phase 3l: the host boundary at SF{sf:g} on {device}")
    t0 = time.perf_counter()
    host, made = host_inputs(sf, device)
    launches = {}
    nbytes, up_wall = _uploads(host, made, device)
    t1 = time.perf_counter()
    cols = _full_columns(made)
    li = _host_columns(made["lineitem"], ["l_returnflag", "l_linestatus",
                                          "l_shipmode", "l_linenumber",
                                          "l_orderkey"])
    cols["lineitem"].update(li)
    cols["lineitem"]["dict:l_returnflag"] = \
        made["lineitem"].column("l_returnflag").dictionary
    log(f"oracle columns downloaded in {time.perf_counter() - t1:.1f} s")
    walls = _host_plans(host, made, cols, device, cuda, launches)
    _host_stream(host, device, cuda, launches)
    groups = _flag_groups(cols["lineitem"])
    _host_aggregates(host, cols["lineitem"], groups, device, cuda, launches)
    _consuming_sink(host, device, cuda, launches)
    _eager(host, cols["lineitem"], groups, device, cuda, launches)
    log(f"phase 3l: {time.perf_counter() - t0:.1f} s (uploads "
        f"{nbytes / 1e9:.3f} GB in {up_wall:.3f} s; plan walls "
        + ", ".join(f"{k} {v[1]:.3f} s + download {v[2] * 1e3:.1f} ms"
                    for k, v in walls.items()) + ")")
    return launches, host


# --- phase 3m: the rest of the host boundary ---------------------------------

# the depth of 3p's Parquet lineitem, 3q's CSV lineitem and ORC orders, 3r's
# S3 orders and every-column join, and 3m's list_slice and customer casts:
# the first 1/ROOM_DEPTH of the rows (all of them until phase 3s needed
# room; the seven took ~41, ~40, ~19, ~16, ~11, ~6 and ~6 s on an NVIDIA
# H100 80GB HBM3 at 700.00 W, most of it the host's page coding, parse,
# coding, byte gathers and Python a row); since phase 3t, 3p's encrypted
# orders file and 3s's pandas round trip of customer too (~9 and ~8 s), and
# the strings_pool sweep at 1/ROOM_DEPTH of its scale (~41 s;
# STRINGS_POOL_SF)
ROOM_DEPTH = 4  # HostTables.first


# rows of the per-row Python names' inputs (and of the order dates cast to
# strings, the wide decimals and the list<string> orders): 100,000, not
# 1,000,000 (169.2 s of phase 3m at 1,000,000 on an NVIDIA H100 80GB HBM3
# machine, most of it Python a row on the host; 200,000 until phase 3r
# needed room)
HOST_TIER_PREFIX = 100_000
# rows of the host names over columns (strftime and strptime over the
# first HOST_TIER_DATES order dates; the splits and joins over the first
# HOST_TIER_TEXT part names; the regex extractions over the first
# HOST_TIER_TEXT phones): cut from 15M, 2M and 1.5M rows to make room for
# phase 3r (the three sections took ~24 s, ~24 s and ~11 s on an NVIDIA
# H100 80GB HBM3 machine, most of it Python and numpy on the host)
HOST_TIER_DATES = 2_000_000
HOST_TIER_TEXT = 300_000
HOST_TIER_SLICE = 1_000_000     # where the sliced lists and runs start
HOST_TIER_SEED = 7              # random's initializer
HOST_TIER_MODES = 3             # mode's n
SPANS_FILE = os.path.join("build", "chip_smoke_spans.jsonl")
_NO_LAUNCH = {"compact": 0, "hash32": 0, "grouped_sum": 0, "probe": 1}
# launches of phase 3m's paths (each +1 probe, from self_check): a
# list_flatten with null parents and the eager run_end_encode one
# compaction (K2) each; the tabular function's Q1 and the exported Q1
# seven float sums each (K1, 12 slots); every other path none
HOST_TIER_LAUNCHES = {
    **{f"3m list_flatten {k}": {**_NO_LAUNCH, "compact": 1}
       for k in ("list<double>", "list<l_shipmode>", "list<double> sliced",
                 "list<string> prefix")},
    "3m run_end_encode": {**_NO_LAUNCH, "compact": 1},
    "3m tabular UDF Q1": {**_NO_LAUNCH, "grouped_sum": 7},
    "3m OTLP Q1": {**_NO_LAUNCH, "grouped_sum": 7},
}


def np_uniform_threefry(seed, n):
    """``jax.random.uniform(jax.random.key(seed), (n,), float64)`` in
    numpy uint32 words: Threefry-2x32 of 20 rounds over the counter
    (i >> 32, i & 0xFFFFFFFF) under the key (seed >> 32, seed &
    0xFFFFFFFF), the top 52 of the 64 output bits as the mantissa of a
    double in [1, 2), less 1."""
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))
    k = [np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF)]
    k.append(k[0] ^ k[1] ^ np.uint32(0x1BD11BDA))
    i = np.arange(n, dtype=np.uint64)
    x0 = (i >> np.uint64(32)).astype(np.uint32) + k[0]
    x1 = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32) + k[1]
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for j in range(5):
        for r in rot[j % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + k[(j + 1) % 3]
        x1 = x1 + k[(j + 2) % 3] + np.uint32(j + 1)
    bits = (x0.astype(np.uint64) << np.uint64(32)) | x1.astype(np.uint64)
    return ((bits >> np.uint64(12)) | np.uint64(0x3FF0000000000000)).view(
        np.float64) - 1.0


def _values_of(arr):
    """(values, validity mask) of a host Array, numpy."""
    return arr.data.values(), arr.is_valid_mask()


def _string_rows(arr, width):
    """A string Array of one fixed width as (n, width) bytes."""
    d = arr.data
    offs = d.offsets()
    if not np.array_equal(np.diff(offs.astype(np.int64)),
                          np.full(len(arr), width)):
        raise AssertionError(f"strings are not all {width} bytes long")
    start = int(offs[0])
    return d.data_bytes()[start:start + width * len(arr)].reshape(-1, width)


def host_tier_inputs(host, device):
    """Phase 3m's inputs from phase 3l's host Tables: lineitem sorted by
    l_orderkey once (the generator draws it at random), one list a
    TPC-H order (empty ones included) of its l_extendedprice and of its
    l_shipmode (the host Table's dictionary<int32, string> column), null
    where o_orderstatus is 'P'; the same lists without nulls; a
    list<string> of the first HOST_TIER_PREFIX orders' l_shipmode
    strings; and the sorted keys."""
    import arrow_tpu_torch.types as T
    from arrow_tpu_torch.array.array import Array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.buffer import Buffer
    from arrow_tpu_torch.device.column import _gather_bytes
    from arrow_tpu_torch.utils import bits
    li, od = host["lineitem"], host["orders"]
    t0 = time.perf_counter()
    okey = li.column("l_orderkey").combine().data.values()
    if torch.device(device).type == "cuda":
        perm = torch.sort(torch.from_numpy(okey).to(device),
                          stable=True)[1].cpu().numpy()
    else:
        perm = np.argsort(okey, kind="stable")
    skey = okey[perm]
    n, n_orders = len(okey), od.num_rows
    offs = np.searchsorted(skey, np.arange(1, n_orders + 2)).astype(np.int32)
    status = od.column("o_orderstatus").combine()
    p_code = Array(status.data.dictionary).to_pylist().index("P")
    valid = status.data.values() != p_code
    price = li.column("l_extendedprice").combine().data.values()[perm]
    mode = li.column("l_shipmode").combine()
    codes = mode.data.values()[perm]
    pv = Buffer(bits.pack_bits(valid))
    nulls = int(n_orders - valid.sum())

    def lists(child, validity=pv, count=nulls, rows=n_orders):
        return Array(ArrayData(T.list_(child.type), rows,
                               [validity, Buffer(offs[:rows + 1])],
                               children=[child], null_count=count))
    dbl = ArrayData(T.float64(), n, [None, Buffer(price)], null_count=0)
    modes = ArrayData(mode.type, n, [None, Buffer(codes)], null_count=0,
                      dictionary=mode.data.dictionary)
    words = Array(mode.data.dictionary).to_pylist()
    P = min(HOST_TIER_PREFIX, n_orders)
    m = int(offs[P])
    wd = Array(mode.data.dictionary).data
    doffs = wd.offsets().astype(np.int64)
    soffs, sbytes = _gather_bytes(wd.data_bytes(), doffs[codes[:m]],
                                  doffs[codes[:m] + 1] - doffs[codes[:m]])
    strs = ArrayData(T.string(), m, [None, Buffer(soffs.astype(np.int32)),
                                     Buffer(sbytes)], null_count=0)
    prefix_valid = valid[:P]
    out = {
        "offs": offs.astype(np.int64), "valid": valid, "price": price,
        "codes": codes, "words": words, "skey": skey, "n": n,
        "n_orders": n_orders, "P": P,
        "list<double>": lists(dbl), "list<l_shipmode>": lists(modes),
        "list<double> no nulls": lists(dbl, None, 0),
        "list<string> prefix": lists(
            strs, Buffer(bits.pack_bits(prefix_valid)),
            int(P - prefix_valid.sum()), P),
        "keys": Array(ArrayData(T.int64(), n, [None, Buffer(skey)],
                                null_count=0)),
    }
    log(f"3m inputs: lineitem sorted by l_orderkey, {n_orders} lists over "
        f"{n} children ({nulls} null parents, "
        f"{int((np.diff(offs) == 0).sum())} empty) in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


class _Paths:
    """A phase's paths (3m's unless ``prefix`` names another): each with
    every launch count set to 0 just before and read just after (on the
    card), its wall logged, its launches checked against ``expected``
    (HOST_TIER_LAUNCHES by default; a path not there launches nothing
    but the probe) at the end."""

    def __init__(self, device, prefix="3m", expected=None):
        self.device = device
        self.cuda = torch.device(device).type == "cuda"
        self.launches, self.walls = {}, {}
        self.prefix = prefix
        self.expected = HOST_TIER_LAUNCHES if expected is None else expected

    def run(self, name, fn):
        from arrow_tpu_torch.platform_check import self_check
        key = f"{self.prefix} {name}"
        if self.cuda:
            zero_launches()
            self_check()
        _sync(self.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        self.walls[key] = time.perf_counter() - t0
        if self.cuda:
            self.launches[key] = read_launches()
        log(f"  {name}: {self.walls[key]:.3f} s, launches "
            f"{self.launches.get(key)}")
        return out

    def check_launches(self):
        if not self.cuda:
            return
        bad = {k: (v, self.expected.get(k, _NO_LAUNCH))
               for k, v in self.launches.items()
               if v != self.expected.get(k, _NO_LAUNCH)}
        if bad:
            raise AssertionError(f"{self.prefix} launches (got, expected): "
                                 f"{bad}")


def _nested(s, paths, dev):
    """The five nested names on the card over the order lists, and
    run_end_encode/run_end_decode of the sorted keys, each against
    numpy."""
    import arrow_tpu_torch.compute as pc
    import arrow_tpu_torch.types as T
    offs, valid, price = s["offs"], s["valid"], s["price"]
    lens = np.diff(offs)
    keep = np.repeat(valid, lens)
    got = paths.run("list_value_length", lambda: pc.list_value_length(
        s["list<double>"], device=dev))
    v, ok = _values_of(got)
    _expect_equal("list_value_length", v, lens.astype(np.int32))
    _expect_equal("list_value_length validity", ok, valid)
    got = paths.run("list_parent_indices", lambda: pc.list_parent_indices(
        s["list<double>"], device=dev))
    _expect_equal("list_parent_indices", got.to_numpy(), np.repeat(
        np.arange(len(lens)), np.where(valid, lens, 0)))
    for kind in ("list<double>", "list<l_shipmode>"):
        got = paths.run(f"list_flatten {kind}", lambda: pc.list_flatten(
            s[kind], device=dev))
        want = (price if kind == "list<double>" else s["codes"])[keep]
        v, ok = _values_of(got)
        _expect_equal(f"list_flatten {kind}", v, want)
        _expect(f"list_flatten {kind} nulls", ok.all())
        if kind != "list<double>":
            _expect(f"list_flatten {kind} dictionary",
                    got.dictionary.to_pylist() == s["words"])
    for index in (0, 6):
        got = paths.run(f"list_element {index}", lambda: pc.list_element(
            s["list<double>"], index, device=dev))
        want_ok = valid & (lens > index)
        v, ok = _values_of(got)
        _expect_equal(f"list_element {index} validity", ok, want_ok)
        _expect_equal(f"list_element {index}", v[want_ok],
                      price[offs[:-1][want_ok] + index])
    got = paths.run("list_flatten list<double> no nulls",
                    lambda: pc.list_flatten(s["list<double> no nulls"],
                                            device=dev))
    _expect_equal("list_flatten without nulls", got.to_numpy(), price)
    S = min(HOST_TIER_SLICE, len(lens) - 1)
    sliced = s["list<double>"].slice(S, len(lens) - S)
    got = paths.run("list_flatten list<double> sliced",
                    lambda: pc.list_flatten(sliced, device=dev))
    _expect_equal("list_flatten of the slice", got.to_numpy(),
                  price[offs[S]:][np.repeat(valid[S:], lens[S:])])
    P = s["P"]
    got = paths.run("list_flatten list<string> prefix",
                    lambda: pc.list_flatten(s["list<string> prefix"],
                                            device=dev))
    words = np.array(s["words"], dtype=object)
    pkeep = np.repeat(valid[:P], lens[:P])
    _expect("list_flatten of list<string>", got.to_pylist() ==
            words[s["codes"][:offs[P]][pkeep]].tolist())

    skey = s["skey"]
    starts = np.flatnonzero(np.diff(skey)) + 1
    uniq = skey[np.concatenate([[0], starts])]
    counts = np.diff(np.concatenate([[0], starts, [len(skey)]]))
    ree = paths.run("run_end_encode", lambda: pc.call_function(
        "run_end_encode", [s["keys"]], device=dev))
    _expect("run_end_encode type", ree.type == T.run_end_encoded(
        T.int32(), T.int64()) and len(ree) == len(skey), repr(ree.type))
    _expect_equal("run_end_encode run ends", ree.run_ends.to_numpy(),
                  np.cumsum(counts).astype(np.int32))
    _expect_equal("run_end_encode values", ree.values.to_numpy(), uniq)
    got = paths.run("run_end_decode", lambda: pc.run_end_decode(
        ree, device=dev))
    _expect_equal("run_end_decode", got.to_numpy(), skey)
    got = paths.run("run_end_decode sliced", lambda: pc.run_end_decode(
        ree.slice(S), device=dev))
    _expect_equal("run_end_decode of the slice", got.to_numpy(), skey[S:])
    log(f"3m nested: {len(uniq)} runs; every result equals numpy's")
    return ree


def _host_names(host, s, paths, dev):
    """mode, strftime/strptime, the splits and joins, the regex
    extractions, the per-row names over HOST_TIER_PREFIX rows and random,
    each against numpy or Python."""
    import arrow_tpu_torch.compute as pc
    import arrow_tpu_torch.types as T
    from arrow_tpu_torch.array.array import Array, array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.buffer import Buffer
    li, od = host["lineitem"], host["orders"]
    col = lambda t, name: t.column(name).combine()  # noqa: E731
    qty = col(li, "l_quantity")
    got = paths.run("mode", lambda: pc.mode(qty, n=HOST_TIER_MODES,
                                            device=dev))
    q = qty.to_numpy()
    c = np.bincount(q.astype(np.int64))   # TPC-H quantities are 1..50
    _expect("quantities are whole", bool((q == np.round(q)).all()))
    top = sorted((-int(k), float(v)) for v, k in enumerate(c)
                 if k)[:HOST_TIER_MODES]
    _expect("mode", got.to_pylist() == [{"mode": v, "count": -k}
                                        for k, v in top], got.to_pylist())

    days = col(od, "o_orderdate").data.values()[:HOST_TIER_DATES].astype(
        np.int64)
    ts = Array(ArrayData(T.timestamp("s"), len(days),
                         [None, Buffer(days * 86_400)], null_count=0))
    text = paths.run("strftime", lambda: pc.strftime(ts))
    want = np.datetime_as_string(days.astype("M8[D]").astype("M8[s]"),
                                 unit="s").astype("S19")
    _expect_equal("strftime", _string_rows(text, 19),
                  want.view(np.uint8).reshape(-1, 19))
    back = paths.run("strptime", lambda: pc.strptime(text, unit="s"))
    _expect_equal("strptime", back.data.values(), days * 86_400)

    names = col(host["part"], "p_name").slice(0, HOST_TIER_TEXT)
    py_names = names.to_pylist()
    joined = " ".join(py_names)
    split = paths.run("split_pattern", lambda: pc.split_pattern(
        names, pattern=" "))
    _expect("split_pattern", split.values.to_pylist() == joined.split(" "))
    _expect_equal("split_pattern lengths", np.diff(
        split.data.offsets()), np.char.count(np.array(py_names), " ") + 1)

    def same_lists(name, got):
        # p_name's words are split by single spaces: the same pieces
        _expect_equal(f"{name} offsets", got.data.offsets(),
                      split.data.offsets())
        _expect_equal(f"{name} pieces", got.values.data.offsets(),
                      split.values.data.offsets())
        _expect_equal(f"{name} bytes", got.values.data.data_bytes(),
                      split.values.data.data_bytes())
    _expect("p_name's separators", "  " not in joined and
            joined == joined.strip())
    same_lists("utf8_split_whitespace", paths.run(
        "utf8_split_whitespace", lambda: pc.utf8_split_whitespace(names)))
    same_lists("split_pattern_regex", paths.run(
        "split_pattern_regex", lambda: pc.split_pattern_regex(
            names, pattern=" ")))
    joined_back = paths.run("binary_join", lambda: pc.binary_join(split,
                                                                  " "))
    _expect_equal("binary_join", joined_back.data.data_bytes(),
                  names.data.data_bytes()[:joined_back.data.offsets()[-1]])
    _expect_equal("binary_join offsets", joined_back.data.offsets(),
                  names.data.offsets() - names.data.offsets()[0])
    del split, joined_back, py_names, joined

    phone = col(host["customer"], "c_phone").slice(0, HOST_TIER_TEXT)
    rows = _string_rows(phone, 15)
    pat = r"(?P<cc>\d+)-(?P<rest>\d+)"
    got = paths.run("extract_regex", lambda: pc.extract_regex(
        phone, pattern=pat))
    _expect_equal("extract_regex cc", _string_rows(
        Array(got.data.children[0]), 2), rows[:, :2])
    _expect_equal("extract_regex rest", _string_rows(
        Array(got.data.children[1]), 3), rows[:, 3:6])
    got = paths.run("extract_regex_span", lambda: pc.extract_regex_span(
        phone, pattern=pat))
    for i, want in enumerate(([0, 2], [3, 3])):
        span = Array(got.data.children[i].children[0]).to_numpy()
        _expect_equal(f"extract_regex_span {i}", span.reshape(-1, 2),
                      np.broadcast_to(want, (len(phone), 2)))

    P = min(HOST_TIER_PREFIX, li.num_rows)
    ship = col(li, "l_shipdate").slice(0, P)
    receipt = col(li, "l_receiptdate").slice(0, P)
    sd, rd = ship.to_numpy().astype(np.int64), receipt.to_numpy().astype(
        np.int64)
    got = paths.run("day_time_interval_between",
                    lambda: pc.day_time_interval_between(ship, receipt))
    pairs = got.data.buffers[1].view(np.int32).reshape(-1, 2)
    _expect_equal("day_time_interval_between", pairs,
                  np.stack([rd - sd, np.zeros(P, np.int64)], 1))
    got = paths.run("month_day_nano_interval_between",
                    lambda: pc.month_day_nano_interval_between(ship,
                                                               receipt))
    raw = got.data.buffers[1].to_numpy().reshape(-1, 16)
    md = np.ascontiguousarray(raw[:, :8]).view(np.int32)
    ns = np.ascontiguousarray(raw[:, 8:]).view(np.int64)[:, 0]

    def ymd(d):
        M = d.astype("M8[D]").astype("M8[M]")
        return (M.astype("M8[Y]").astype(np.int64) + 1970,
                M.astype(np.int64) % 12 + 1,
                (d.astype("M8[D]") - M).astype(np.int64) + 1)
    ys, ms, ds = ymd(sd)
    yr, mr, dr = ymd(rd)
    _expect_equal("month_day_nano_interval_between", np.stack(
        [md[:, 0], md[:, 1], ns], 1), np.stack(
        [(yr - ys) * 12 + mr - ms, dr - ds, np.zeros(P, np.int64)], 1))
    got = paths.run("iso_calendar", lambda: pc.iso_calendar(ship))
    uniq, inv = np.unique(sd, return_inverse=True)
    iso = np.array([tuple(datetime.date.fromordinal(
        int(d) + EPOCH.toordinal()).isocalendar()) for d in uniq])[inv]
    for i, name in enumerate(("iso_year", "iso_week", "iso_day_of_week")):
        _expect_equal(f"iso_calendar {name}",
                      Array(got.data.children[i]).to_numpy(), iso[:, i])
    got = paths.run("year_month_day", lambda: pc.year_month_day(ship))
    for i, want in enumerate((ys, ms, ds)):
        _expect_equal(f"year_month_day {i}",
                      Array(got.data.children[i]).to_numpy(), want)
    keys = col(li, "l_orderkey").slice(0, P)
    q = qty.slice(0, P)
    st = paths.run("make_struct", lambda: pc.make_struct(
        keys, q, field_names=["k", "q"]))
    got = paths.run("struct_field", lambda: pc.struct_field(st, field="q"))
    _expect_equal("struct_field", got.to_numpy(), q.to_numpy())
    _expect_equal("struct_field index", pc.struct_field(
        st, indices=0).to_numpy(), keys.to_numpy())

    offs, valid, price = s["offs"], s["valid"], s["price"]
    P = s["P"]
    # list_slice over the first 1/ROOM_DEPTH of the P lists (Python a row)
    L = P // ROOM_DEPTH
    lp = s["list<double>"].slice(0, L)
    got = paths.run("list_slice", lambda: pc.list_slice(lp, start=1,
                                                        stop=3))
    lens = np.diff(offs[:L + 1])
    take = np.where(valid[:L], np.clip(lens - 1, 0, 2), 0)
    idx = np.repeat(offs[:L] + 1, take) + np.arange(take.sum()) - \
        np.repeat(np.cumsum(take) - take, take)
    _expect_equal("list_slice lengths", np.diff(got.data.offsets()), take)
    _expect_equal("list_slice values", got.values.to_numpy(), price[idx])
    _expect_equal("list_slice validity", got.is_valid_mask(), valid[:L])
    modes = col(li, "l_shipmode").slice(0, len(ship))
    got = paths.run("dictionary_decode", lambda: pc.dictionary_decode(modes))
    words = np.array(s["words"], dtype=object)
    _expect("dictionary_decode", got.type == T.string() and
            got.to_pylist() == words[modes.data.values()].tolist())
    m = int(offs[P])
    child = s["list<string> prefix"].values.data
    entries = ArrayData(T.map_(T.string(), T.float64()).value_type, m,
                        [None], children=[child, ArrayData(
                            T.float64(), m, [None, Buffer(price[:m])],
                            null_count=0)], null_count=0)
    mp = Array(ArrayData(T.map_(T.string(), T.float64()), P,
                         [s["list<string> prefix"].data.buffers[0],
                          Buffer(offs[:P + 1].astype(np.int32))],
                         children=[entries]))
    got = paths.run("map_lookup", lambda: pc.map_lookup(
        mp, query_key="MAIL", occurrence="first"))
    hit = np.flatnonzero(s["codes"][:m] == s["words"].index("MAIL"))
    owner = np.searchsorted(offs[:P + 1], hit, side="right") - 1
    first_owner, first = np.unique(owner, return_index=True)
    want_ok = np.zeros(P, bool)
    want_ok[first_owner] = True
    want_ok &= valid[:P]
    want = np.zeros(P)
    want[first_owner] = price[hit[first]]
    v, ok = _values_of(got)
    _expect_equal("map_lookup validity", ok, want_ok)
    _expect_equal("map_lookup", v[ok], want[want_ok])

    n = li.num_rows
    r1 = paths.run("random", lambda: pc.random(
        n, initializer=HOST_TIER_SEED, device=dev))
    r2 = pc.random(n, initializer=HOST_TIER_SEED, device=dev)
    a, b = r1.to_numpy(), r2.to_numpy()
    _expect_equal("random twice", a.view(np.int64), b.view(np.int64))
    _expect("random in [0, 1)", bool(((a >= 0) & (a < 1)).all()))
    m = min(HOST_TIER_PREFIX, n)
    _expect_equal("random's bits", a[:m].view(np.int64),
                  np_uniform_threefry(HOST_TIER_SEED, m).view(np.int64))


def _casts_decimals(host, paths, dev):
    """Casts to strings and back through the string cast tier on the card,
    then the wide decimals against Python's ``decimal``."""
    import decimal
    import arrow_tpu_torch.compute as pc
    import arrow_tpu_torch.types as T
    from arrow_tpu_torch.array.array import Array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.buffer import Buffer
    from arrow_tpu_torch.compute.registry import ArrowInvalid
    cu, od = host["customer"], host["orders"]
    # the casts of customer's columns over its first 1/ROOM_DEPTH of rows
    bal = host.first("customer").column("c_acctbal").combine()
    s = paths.run("cast c_acctbal to string", lambda: pc.cast(
        bal, T.string(), device=dev))
    back = paths.run("cast c_acctbal back", lambda: pc.cast(
        s, T.float64(), device=dev))
    _expect_equal("c_acctbal round trip", back.to_numpy().view(np.int64),
                  bal.to_numpy().view(np.int64))
    keys = host.first("customer").column("c_custkey").combine()
    s = paths.run("cast c_custkey to string", lambda: pc.cast(
        keys, T.string(), device=dev))
    _expect("c_custkey strings", s.to_pylist() ==
            keys.to_numpy().astype(str).tolist())
    back = paths.run("cast c_custkey back", lambda: pc.cast(
        s, T.int64(), device=dev))
    _expect_equal("c_custkey round trip", back.to_numpy(), keys.to_numpy())
    P = min(HOST_TIER_PREFIX, od.num_rows)
    dates = od.column("o_orderdate").combine().slice(0, P)
    s = paths.run("cast o_orderdate to string", lambda: pc.cast(
        dates, T.string(), device=dev))
    _expect_equal("o_orderdate strings", _string_rows(s, 10),
                  np.datetime_as_string(dates.to_numpy().astype(
                      "M8[D]")).astype("S10").view(np.uint8).reshape(-1, 10))
    back = paths.run("cast o_orderdate back", lambda: pc.cast(
        s, T.date32(), device=dev))
    _expect_equal("o_orderdate round trip", back.to_numpy(),
                  dates.to_numpy())

    cents = np.round(od.column("o_totalprice").combine().to_numpy()[:P]
                     * 100).astype(np.int64)

    def wide(t):
        w = t.byte_width
        raw = np.repeat(np.where(cents < 0, 0xFF, 0).astype(np.uint8)[
            :, None], w, axis=1)
        raw[:, :8] = cents.view(np.uint8).reshape(P, 8)
        return Array(ArrayData(t, P, [None, Buffer(raw.reshape(-1))],
                               null_count=0))

    def unscaled(arr):
        rows = arr.data.values()
        return np.ascontiguousarray(rows[:, :8]).view(np.int64)[:, 0]
    d128 = wide(T.decimal128(38, 2))
    D = decimal.Decimal
    total = int(cents.sum())
    for name, want in (
            ("sum", D(total).scaleb(-2)),
            ("mean", (D(total) / D(P)).quantize(
                D(1), rounding=decimal.ROUND_HALF_UP).scaleb(-2)),
            ("min", D(int(cents.min())).scaleb(-2)),
            ("max", D(int(cents.max())).scaleb(-2))):
        got = paths.run(f"wide decimal {name}", lambda: pc.call_function(
            name, [d128], device=dev))
        _expect(f"wide decimal {name}", got.as_py() == want,
                f"{got.as_py()} against {want}")
    try:
        pc.add(d128, d128, device=dev)
        raise AssertionError("decimal128(38, 2) + decimal128(38, 2) did not "
                             "pass the 38-digit ceiling")
    except ArrowInvalid:
        pass
    d256 = wide(T.decimal256(38, 2))
    got = paths.run("wide decimal add", lambda: pc.add(d256, d256,
                                                        device=dev))
    _expect("wide decimal add type", got.type == T.decimal256(39, 2))
    _expect_equal("wide decimal add", unscaled(got), cents * 2)
    got = paths.run("wide decimal multiply", lambda: pc.multiply(
        d256, D("1.5"), device=dev))
    _expect("wide decimal multiply type", got.type == T.decimal256(41, 3))
    _expect_equal("wide decimal multiply", unscaled(got), cents * 15)


def _udfs_otel_facts(host, paths, dev):
    """A scalar UDF over the eager compute on the card, an aggregate UDF,
    a tabular UDF giving Q1's Table as a reader; Q1 under QueryOptions
    exported as OTLP/JSON to a file and read back; the card's memory and
    runtime facts."""
    import arrow_tpu_torch.compute as pc
    import arrow_tpu_torch.types as T
    from arrow_tpu_torch import config, memory
    from arrow_tpu_torch.acero import QueryOptions, TableSourceNodeOptions
    from arrow_tpu_torch.io.tpch_queries import q1_plan
    li = host["lineitem"]
    price = li.column("l_extendedprice").combine()
    disc = li.column("l_discount").combine()
    qty = li.column("l_quantity").combine()
    doc = {"summary": "phase 3m", "description": ""}
    pc.register_scalar_function(
        lambda ctx, p, d: pc.multiply(p, pc.subtract(1.0, d, device=dev),
                                      device=dev),
        "chip_revenue", doc, {"p": T.float64(), "d": T.float64()},
        T.float64())
    got = paths.run("scalar UDF", lambda: pc.call_function(
        "chip_revenue", [price, disc]))
    want = price.to_numpy() * (1.0 - disc.to_numpy())
    check_close("scalar UDF revenue", torch.from_numpy(got.to_numpy()),
                torch.from_numpy(want), RTOL_F64)
    pc.register_aggregate_function(
        lambda ctx, q: pc.sum(q, device=dev).as_py() / ctx.batch_length,
        "chip_mean", doc, {"q": T.float64()}, T.float64())
    got = paths.run("aggregate UDF", lambda: pc.call_function(
        "chip_mean", [qty]))
    want = float(qty.to_numpy().mean())
    _expect("aggregate UDF", abs(got.as_py() - want) <= RTOL_F64 * want,
            f"{got.as_py()} against {want}")
    batch = TableSourceNodeOptions(li).upload(dev)
    q1_want = q1_oracle(batch, li.num_rows)
    pc.register_tabular_function(
        lambda ctx: q1_plan(li).to_table(device=dev), "chip_q1", doc, {},
        None)
    got = paths.run("tabular UDF Q1", lambda: pc.call_tabular_function(
        "chip_q1").read_all())
    check_result("3m tabular UDF Q1", got.to_pydict(), q1_want)

    os.makedirs(os.path.dirname(SPANS_FILE), exist_ok=True)
    if os.path.exists(SPANS_FILE):
        os.remove(SPANS_FILE)
    plan = q1_plan(li)
    os.environ["ARROW_TPU_OTEL_EXPORT"] = SPANS_FILE
    try:
        got = paths.run("OTLP Q1", lambda: plan.to_table(
            query_options=QueryOptions(), device=dev))
    finally:
        del os.environ["ARROW_TPU_OTEL_EXPORT"]
    check_result("3m OTLP Q1", got.to_pydict(), q1_want)
    with open(SPANS_FILE) as f:
        lines = f.read().splitlines()
    spans = json.loads(lines[-1])["resourceSpans"][0]["scopeSpans"][0][
        "spans"]
    nodes = [m[0] for m in plan.last_query_context.node_metrics]
    root = spans[0]
    _expect("OTLP spans", len(lines) == 1 and root["name"] ==
            plan.factory_name and [s["name"] for s in spans[1:]] == nodes
            and all(s["parentSpanId"] == root["spanId"]
                    for s in spans[1:]), f"{[s['name'] for s in spans]}")
    log(f"  OTLP: one root span ({root['name']}) and {len(nodes)} node spans "
        f"{nodes}, in the node metrics' order")

    stats = memory.device_memory_stats()
    info = config.runtime_info()
    if paths.cuda:
        _expect("device_memory_stats", stats["bytes_in_use"] ==
                torch.cuda.memory_allocated() and stats["peak_bytes_in_use"]
                == torch.cuda.max_memory_allocated(), str(stats))
        _expect("runtime_info", info.backend == "cuda" and
                info.num_devices == torch.cuda.device_count(), str(info))
    log(f"  device facts: {stats}; {info}; {config.build_info()}")


def phase_host_tier(host, device="cuda"):
    """Phase 3m: the rest of the host boundary over phase 3l's host Tables
    (made once there, released by the caller): the nested names' device
    tier over 15M order lists of 60M lineitem rows and the run-end
    encoding of the sorted keys, on ``device``; mode; the host names
    (strftime/strptime over HOST_TIER_DATES order dates, the splits over
    HOST_TIER_TEXT part names, the regex extractions over HOST_TIER_TEXT
    phones, the per-row Python
    names over HOST_TIER_PREFIX rows, random over 60M); casts to strings
    and back; wide decimals; UDFs; the OTLP export; the device facts.
    Each against numpy or Python, each path's launches set to 0 just
    before and read just after. Returns (launches by path, the nested
    inputs for phase 4's times)."""
    dev = torch.device(device)
    log(f"== phase 3m: the rest of the host boundary on {device}")
    t0 = time.perf_counter()
    paths = _Paths(dev)
    s = host_tier_inputs(host, dev)
    _nested(s, paths, dev)
    _host_names(host, s, paths, dev)
    _casts_decimals(host, paths, dev)
    _udfs_otel_facts(host, paths, dev)
    paths.check_launches()
    log(f"phase 3m: {time.perf_counter() - t0:.1f} s (paths "
        f"{sum(paths.walls.values()):.1f} s)")
    return paths.launches, s


# --- phase 3n: the frontends -------------------------------------------------

# TPC-H Q1, Q6 and Q3 as SQL text. Q3 is written lineitem first: the SQL
# join keeps the left side's keys and drops the right side's, so a later
# join must name a key that a table already joined holds (``sql.py``); its
# select list is in q3_plan's column order.
SQL_Q1 = """
    select l_returnflag, l_linestatus,
           sum(l_quantity) as sum_qty,
           sum(l_extendedprice) as sum_base_price,
           sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax))
               as sum_charge,
           avg(l_quantity) as avg_qty,
           avg(l_extendedprice) as avg_price,
           avg(l_discount) as avg_disc,
           count(*) as count_order
    from lineitem
    where l_shipdate <= date '1998-12-01' - interval '90' day
    group by l_returnflag, l_linestatus
    order by l_returnflag, l_linestatus"""
SQL_Q6 = """
    select sum(l_extendedprice * l_discount) as revenue
    from lineitem
    where l_shipdate >= date '1994-01-01'
      and l_shipdate < date '1994-01-01' + interval '1' year
      and l_discount between 0.05 and 0.07
      and l_quantity < 24"""
SQL_Q3 = """
    select l_orderkey, o_orderdate, o_shippriority,
           sum(l_extendedprice * (1 - l_discount)) as revenue
    from lineitem
    join orders on l_orderkey = o_orderkey
    join customer on o_custkey = c_custkey
    where c_mktsegment = 'BUILDING'
      and o_orderdate < date '1995-03-15'
      and l_shipdate > date '1995-03-15'
    group by l_orderkey, o_orderdate, o_shippriority
    order by revenue desc, o_orderdate
    limit 10"""
# the Gandiva batch: the columns of Q1's disc_price and charge and of Q6's
# condition
GANDIVA_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
                   "l_shipdate")
Q6_COLUMNS = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
Q1_COLUMNS = ["l_returnflag", "l_linestatus", "l_quantity",
              "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
# lineitem's and orders' columns of the Substrait plans: no dictionary
# column, which Substrait has no type for
SUBSTRAIT_Q6 = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice",
                "l_orderkey", "l_tax")
SUBSTRAIT_JOIN = (("l_orderkey", "l_extendedprice", "l_discount"),
                  ("o_orderkey", "o_orderdate"))
FRONTEND_SLICES = 8             # the in-memory dataset's fragments
FRONTEND_QUANTILES = [0.1, 0.5, 0.9]
# launches of phase 3n's paths, reckoned from their plan trees before the
# first run (each +1 probe, from self_check): SQL Q1 and the scan's Q1 are
# Q1's seven float sums (K1, 12 slots); SQL Q3 joins before it filters,
# lineitem probing orders and that probing customer, each with the bloom
# (60,012,544 >= 4 x 15,000,576 and 4 x 1,500,160 capacity): a compaction
# of the probe side and one of the join's output, and a hash of the build
# and of the probe keys, each join; its WHERE folds into the aggregate as
# a mask; Substrait's join is one such join; the Gandiva filter and the
# scanner under Q6's filter compact once (the row ids; the fragments' kept
# rows); count_rows the same; every other path, a scan without a filter
# (its fragments' rows concatenated) among them, launches none
_JOIN = {**_NO_LAUNCH, "compact": 2, "hash32": 2}
FRONTEND_LAUNCHES = {
    "3n SQL Q1": {**_NO_LAUNCH, "grouped_sum": 7},
    "3n SQL Q3": {**_NO_LAUNCH, "compact": 4, "hash32": 4},
    "3n gandiva filter": {**_NO_LAUNCH, "compact": 1},
    "3n substrait join": _JOIN,
    "3n scanner Q6": {**_NO_LAUNCH, "compact": 1},
    "3n scanner count_rows": {**_NO_LAUNCH, "compact": 1},
    "3n scan Q1": {**_NO_LAUNCH, "grouped_sum": 7},
    "3n scan Q1 again": {**_NO_LAUNCH, "grouped_sum": 7},
}


def _host_values(tbl, name):
    """A null-free host column's values, numpy."""
    return tbl.column(name).combine().data.values()


def _same_result(name, got, want):
    """Column names, row count, validity and every non-float value alike;
    floats within rtol 1e-9."""
    g, w = got.to_pydict(), want.to_pydict()
    if list(g) != list(w):
        raise AssertionError(f"{name}: columns {list(g)} != {list(w)}")
    for col in w:
        a, b = g[col], w[col]
        if len(a) != len(b) or [v is None for v in a] != \
                [v is None for v in b]:
            raise AssertionError(f"{name} {col}: rows or validity differ")
        if any(isinstance(v, float) for v in b):
            x = np.array([0.0 if v is None else v for v in a])
            y = np.array([0.0 if v is None else v for v in b])
            if not np.allclose(x, y, rtol=RTOL_F64, atol=0.0):
                raise AssertionError(f"{name} {col}: {a[:5]} != {b[:5]}")
        elif a != b:
            raise AssertionError(f"{name} {col}: {a[:5]} != {b[:5]}")


def _with_leaf(plan, leaf):
    """A copy of a linear plan with its table source replaced by
    ``leaf``."""
    from arrow_tpu_torch.acero import Declaration
    if not plan.inputs:
        return leaf
    return Declaration(plan.factory_name, plan.options,
                       [_with_leaf(plan.inputs[0], leaf)])


def q6_mask(li):
    """Q6's condition over lineitem's host columns, numpy."""
    from arrow_tpu_torch.io.tpch_queries import (DATE_1994_01_01,
                                                 DATE_1995_01_01)
    sd = _host_values(li, "l_shipdate")
    disc = _host_values(li, "l_discount")
    return ((sd >= DATE_1994_01_01) & (sd < DATE_1995_01_01)
            & (disc >= 0.05) & (disc <= 0.07)
            & (_host_values(li, "l_quantity") < 24.0))


def q6_condition():
    from arrow_tpu_torch.acero import field
    from arrow_tpu_torch.io.tpch_queries import (DATE_1994_01_01,
                                                 DATE_1995_01_01)
    return ((field("l_shipdate") >= DATE_1994_01_01)
            & (field("l_shipdate") < DATE_1995_01_01)
            & (field("l_discount") >= 0.05)
            & (field("l_discount") <= 0.07)
            & (field("l_quantity") < 24.0))


def gandiva_oracle(rb):
    """Q1's disc_price and charge over a batch's host columns, numpy."""
    price = rb.column("l_extendedprice").data.values()
    disc = rb.column("l_discount").data.values()
    tax = rb.column("l_tax").data.values()
    disc_price = price * (1.0 - disc)
    return disc_price, disc_price * (1.0 + tax)


def _expect_floats(name, got, want):
    got = np.asarray(got, dtype=np.float64)
    if got.shape != want.shape or not np.allclose(got, want, rtol=RTOL_F64,
                                                  atol=0.0):
        raise AssertionError(f"{name}: differs from numpy's")


def _frontend_sql(host, paths, dev, peaks):
    """SQL Q1, Q6 and Q3 as text, each against its Declaration form over
    the same Tables; the parse timed apart from the plan."""
    from arrow_tpu_torch import sql
    from arrow_tpu_torch.io import tpch_queries as tq
    li, od, cu = host["lineitem"], host["orders"], host["customer"]
    tables = {"lineitem": li, "orders": od, "customer": cu}
    forms = {"Q1": (SQL_Q1, lambda: tq.q1_plan(li)),
             "Q6": (SQL_Q6, lambda: tq.q6_plan(li)),
             "Q3": (SQL_Q3, lambda: tq.q3_plan(cu, od, li))}
    host_ms = {}
    for name, (text, form) in forms.items():
        t0 = time.perf_counter()
        decl = sql.declaration(text, tables)
        host_ms[f"SQL {name} parse"] = (time.perf_counter() - t0) * 1e3
        base = memory_mark() if paths.cuda else 0
        got = paths.run(f"SQL {name}", lambda: decl.to_table(device=dev))
        if paths.cuda:
            peaks[f"SQL {name}"] = (torch.cuda.max_memory_allocated()
                                    - base) / 2**30
        _same_result(f"SQL {name}", got, form().to_table(device=dev))
        host.answers[f"SQL {name}"] = got
        log(f"  SQL {name}: {got.num_rows} rows, parsed in "
            f"{host_ms[f'SQL {name} parse']:.2f} ms, equals its "
            "Declaration form")
    # and query(), which parses and runs in one call
    again = sql.query(SQL_Q6, tables, device=dev)
    _same_result("SQL Q6 query()", again, tq.q6_plan(li).to_table(device=dev))
    return host_ms


def _frontend_gandiva(host, paths, dev):
    """A Projector of Q1's disc_price and charge, a Filter of Q6's
    condition and the Projector under its selection, over one
    RecordBatch of lineitem's columns, against numpy."""
    from arrow_tpu_torch import gandiva
    from arrow_tpu_torch.acero import field
    from arrow_tpu_torch.table import RecordBatch
    from arrow_tpu_torch.types import Schema
    li = host["lineitem"]
    rb = RecordBatch(Schema([li.schema.field(n) for n in GANDIVA_COLUMNS]),
                     [li.column(n).combine() for n in GANDIVA_COLUMNS])
    disc_price = field("l_extendedprice") * (1.0 - field("l_discount"))
    t0 = time.perf_counter()
    proj = gandiva.make_projector(rb.schema, [
        (disc_price, "disc_price"),
        (disc_price * (1.0 + field("l_tax")), "charge")])
    filt = gandiva.make_filter(rb.schema, q6_condition())
    made_ms = (time.perf_counter() - t0) * 1e3
    want = gandiva_oracle(rb)
    out = paths.run("gandiva project", lambda: proj.evaluate(
        rb, device=dev))
    for a, w, n in zip(out, want, ("disc_price", "charge")):
        _expect_floats(f"gandiva {n}", a.data.values(), w)
    sel = paths.run("gandiva filter", lambda: filt.evaluate(rb, device=dev))
    rows = np.nonzero(q6_mask(li))[0]
    _expect_equal("gandiva SelectionVector", sel.indices.astype(np.int64),
                  rows)
    out = paths.run("gandiva project selected", lambda: proj.evaluate(
        rb, selection=sel, device=dev))
    for a, w, n in zip(out, want, ("disc_price", "charge")):
        _expect_floats(f"gandiva {n} selected", a.data.values(), w[rows])
    log(f"  gandiva: projector and filter made in {made_ms:.2f} ms, "
        f"{len(sel)} rows selected of {rb.num_rows}; all equal numpy's")
    return {"gandiva make": made_ms}


def _frontend_substrait(host, paths, dev):
    """Q6 and a Q3-shaped join through serialize_plan -> run_query over
    dictionary-free columns, each against its Declaration form; the
    encode and the decode timed apart from the plan."""
    from arrow_tpu_torch import substrait
    from arrow_tpu_torch.acero import (AggregateNodeOptions, Declaration,
                                       FetchNodeOptions, HashJoinNodeOptions,
                                       OrderByNodeOptions, ProjectNodeOptions,
                                       TableSourceNodeOptions, field)
    from arrow_tpu_torch.io.tpch_queries import q6_plan
    li, od = host["lineitem"], host["orders"]
    q6_li = li.select(list(SUBSTRAIT_Q6))
    j_li, j_od = (li.select(list(SUBSTRAIT_JOIN[0])),
                  od.select(list(SUBSTRAIT_JOIN[1])))

    def src(t, name):
        o = TableSourceNodeOptions(t)
        o.substrait_name = name
        return Declaration("table_source", o)

    def join_plan():
        return Declaration.from_sequence([
            Declaration("hashjoin", HashJoinNodeOptions(
                "inner", left_keys=["l_orderkey"],
                right_keys=["o_orderkey"]),
                [src(j_li, "lineitem"), src(j_od, "orders")]),
            Declaration("project", ProjectNodeOptions(
                [field("o_orderdate"),
                 field("l_extendedprice") * (1.0 - field("l_discount"))],
                ["o_orderdate", "volume"])),
            Declaration("aggregate", AggregateNodeOptions(
                [("volume", "sum", None, "revenue")], keys=["o_orderdate"])),
            Declaration("order_by", OrderByNodeOptions(
                [("revenue", "descending")])),
            Declaration("fetch", FetchNodeOptions(0, 10))])

    host_ms = {}
    for name, make, provide in (
            ("Q6", lambda: q6_plan(q6_li), lambda n, s: q6_li),
            ("join", join_plan,
             lambda n, s: j_li if n == ["lineitem"] else j_od)):
        decl = make()
        t0 = time.perf_counter()
        blob = substrait.serialize_plan(decl)
        t1 = time.perf_counter()
        back, names = substrait.deserialize_plan(blob, provide)
        t2 = time.perf_counter()
        host_ms[f"substrait {name} encode"] = (t1 - t0) * 1e3
        host_ms[f"substrait {name} decode"] = (t2 - t1) * 1e3
        got = paths.run(f"substrait {name}", lambda: substrait.run_query(
            blob, provide, device=dev))
        _same_result(f"substrait {name}", got, make().to_table(device=dev))
        log(f"  substrait {name}: {len(blob)} bytes, encoded in "
            f"{host_ms[f'substrait {name} encode']:.2f} ms, decoded in "
            f"{host_ms[f'substrait {name} decode']:.2f} ms; {got.num_rows} "
            "rows equal to its Declaration form")
    return host_ms


def _frontend_dataset(host, paths, dev):
    """An InMemoryDataset of lineitem as FRONTEND_SLICES slices: a Scanner
    under Q6's filter and its count_rows, then scan sources under Q6's
    and Q1's aggregates (Q1 twice: the second run uploads nothing), each
    against its Declaration form over the Table."""
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                       ScanNodeOptions,
                                       TableSourceNodeOptions, source_cache)
    from arrow_tpu_torch.io import tpch_queries as tq
    li = host["lineitem"]
    n = li.num_rows
    step = -(-n // FRONTEND_SLICES)
    data = ds.InMemoryDataset([li.slice(i, step) for i in range(0, n, step)])
    cond = q6_condition()
    got = paths.run("scanner Q6", lambda: ds.Scanner(
        data, Q6_COLUMNS, cond, device=dev).to_table())
    want = Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(
            li.select(Q6_COLUMNS))),
        Declaration("filter", FilterNodeOptions(cond))]).to_table(device=dev)
    if table_digest(got) != table_digest(want):
        raise AssertionError("scanner Q6: differs from the filter's rows")
    count = paths.run("scanner count_rows", lambda: ds.Scanner(
        data, Q6_COLUMNS, cond, device=dev).count_rows())
    _expect("scanner count_rows", count == int(q6_mask(li).sum()),
            f"({count} rows)")
    scan6 = _with_leaf(tq.q6_plan(li), Declaration(
        "scan", ScanNodeOptions(data, Q6_COLUMNS)))
    _same_result("scan Q6", paths.run("scan Q6", lambda: scan6.to_table(
        device=dev)), tq.q6_plan(li).to_table(device=dev))
    scan1 = _with_leaf(tq.q1_plan(li), Declaration(
        "scan", ScanNodeOptions(data, Q1_COLUMNS)))
    want1 = tq.q1_plan(li).to_table(device=dev)
    _same_result("scan Q1", paths.run("scan Q1", lambda: scan1.to_table(
        device=dev)), want1)
    rows = source_cache.UPLOAD_STATS["rows"]
    _same_result("scan Q1 again", paths.run(
        "scan Q1 again", lambda: scan1.to_table(device=dev)), want1)
    _expect("scan Q1 again uploads nothing",
            source_cache.UPLOAD_STATS["rows"] == rows)
    log(f"  dataset: {len(data.fragments)} fragments, {count} rows under "
        "Q6's filter; every scan equals its Declaration form; the repeated "
        "scan uploaded nothing")


def _frontend_options(host, nested, paths, dev):
    """The eager calls with options objects: quantile of three q over
    l_extendedprice (F4), a cast by CastOptions, and list_element -1
    raising over 3m's order lists (F5)."""
    import arrow_tpu_torch.compute as pc
    import arrow_tpu_torch.types as T
    from arrow_tpu_torch.compute.registry import ArrowInvalid
    li = host["lineitem"]
    price = li.column("l_extendedprice")
    got = paths.run("quantile", lambda: pc.quantile(
        price, options=pc.QuantileOptions(q=FRONTEND_QUANTILES),
        device=dev))
    _expect_floats("quantile", got.value, np.quantile(
        _host_values(li, "l_extendedprice"), FRONTEND_QUANTILES))
    got = paths.run("cast", lambda: pc.call_function(
        "cast", [li.column("l_quantity"),
                 pc.CastOptions(target_type=T.int32())], device=dev))
    _expect_equal("cast", got.data.values(),
                  _host_values(li, "l_quantity").astype(np.int32))
    for kind in ("list<double>", "list<l_shipmode>"):
        if nested is None:
            break

        def negative():
            try:
                pc.list_element(nested[kind], -1, device=dev)
            except ArrowInvalid:
                return True
            return False
        _expect(f"list_element {kind} -1 raises",
                paths.run(f"list_element {kind} -1", negative))
    log(f"  options: quantile of {FRONTEND_QUANTILES}, the cast and the "
        "negative list_element as expected")


def phase_frontends(host, nested=None, device="cuda"):
    """Phase 3n: the frontends over phase 3l's host Tables (their uploads
    kept by ``acero.source_cache``): SQL Q1, Q6 and Q3 as text; a Gandiva
    projector and filter over a RecordBatch of lineitem; Q6 and a
    Q3-shaped join through Substrait; an in-memory dataset of lineitem's
    slices through a Scanner and a scan source; eager calls with options
    objects, and list_element -1 over phase 3m's order lists (``nested``,
    where given). Each result against its Declaration form or numpy, each
    path's launches set to 0 just before and read just after (on the
    card) and checked against FRONTEND_LAUNCHES. Returns (launches by
    path, the host times and the paths' walls)."""
    dev = torch.device(device)
    log(f"== phase 3n: the frontends on {device}")
    t0 = time.perf_counter()
    paths = _Paths(dev, "3n", FRONTEND_LAUNCHES)
    peaks = {}
    host_ms = _frontend_sql(host, paths, dev, peaks)
    host_ms.update(_frontend_gandiva(host, paths, dev))
    host_ms.update(_frontend_substrait(host, paths, dev))
    _frontend_dataset(host, paths, dev)
    _frontend_options(host, nested, paths, dev)
    paths.check_launches()
    log("phase 3n host times (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in host_ms.items()))
    if peaks:
        log("phase 3n peak memory above the tables (GiB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in peaks.items()))
    log(f"phase 3n: {time.perf_counter() - t0:.1f} s (paths "
        f"{sum(paths.walls.values()):.1f} s)")
    return paths.launches, {"host_ms": host_ms, "walls": paths.walls,
                            "peaks": peaks}


# --- phase 3o: files -----------------------------------------------------------

FILE_SLICES = FRONTEND_SLICES   # lineitem's IPC files: phase 3n's slices
FILE_STREAM_ROWS = 1 << 20      # the orders stream's batch rows
HIVE_STATUS = "F"               # the order status the hive scan keeps
V1_ORDERS = ("o_orderkey", "o_custkey", "o_totalprice", "o_shippriority",
             "o_orderstatus", "o_orderpriority")
# launches of phase 3o's paths, reckoned from their plan trees before the
# first run (each +1 probe, from self_check): Q1 over the IPC files, over
# the Feather file and over the in-memory slices is 3n's scan Q1, seven
# float sums (K1, 12 slots) over the fragments' rows end to end; the
# Scanner under Q6's filter compacts the fragments' kept rows once (K2);
# the hive scan prunes to one directory, whose guarantee leaves no filter,
# and the Table's plan folds its filter into the aggregate as a mask:
# each is one float sum by the order priority (K1, 5 slots; the integer
# sum, count, min and max take no kernel); every other
# path (the writes, the round trips, the stream) launches none
_SCAN_Q1 = {**_NO_LAUNCH, "grouped_sum": 7}
_SCANNER_Q6 = {**_NO_LAUNCH, "compact": 1}
_HIVE = {**_NO_LAUNCH, "grouped_sum": 1}
FILE_LAUNCHES = {
    "3o scan Q1 in memory": _SCAN_Q1, "3o scan Q1 ipc": _SCAN_Q1,
    "3o scan Q1 ipc again": _SCAN_Q1, "3o scan Q1 feather": _SCAN_Q1,
    "3o scanner Q6 in memory": _SCANNER_Q6, "3o scanner Q6 ipc": _SCANNER_Q6,
    "3o scanner Q6 ipc again": _SCANNER_Q6,
    "3o hive orders": _HIVE, "3o hive orders (table)": _HIVE,
}


def _free_bytes(path):
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


def _table_bytes(tbl):
    """The bytes of a host Table's buffers (dictionaries included)."""
    def data(d):
        return (sum(b.size for b in d.buffers if b is not None)
                + sum(data(c) for c in d.children)
                + (0 if d.dictionary is None else data(d.dictionary)))
    return sum(data(c.data) for col in tbl.columns for c in col.chunks)


def _np_bits(values):
    """A fixed-width numpy array as unsigned integers of its width (NaN
    payloads compare by their bits)."""
    return values.view(f"u{values.dtype.itemsize}") \
        if values.dtype.kind == "f" else values


def _same_data(name, got, want):
    """Two ArrayDatas alike buffer by buffer, as numpy compares them:
    type, length, nulls, validity, values (offsets rebased and the bytes
    they span, for strings), and the dictionary."""
    from arrow_tpu_torch.types import TypeId
    _expect(f"{name} type and length", got.type == want.type
            and got.length == want.length
            and got.null_count == want.null_count)
    gv, wv = got.validity_mask(), want.validity_mask()
    _expect(f"{name} validity", (gv is None) == (wv is None) and (
        gv is None or np.array_equal(gv, wv)))
    tid = got.type.id
    if tid in (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
               TypeId.LARGE_BINARY):
        go, wo = got.offsets(), want.offsets()
        _expect_equal(f"{name} offsets", go - go[0], wo - wo[0])
        _expect_equal(f"{name} bytes", got.data_bytes()[go[0]:go[-1]],
                      want.data_bytes()[wo[0]:wo[-1]])
    else:
        _expect_equal(name, _np_bits(got.values()), _np_bits(want.values()))
    if tid == TypeId.DICTIONARY:
        _same_data(f"{name} dictionary", got.dictionary, want.dictionary)


def _same_table(name, got, want):
    """``got``'s chunks against the same rows of ``want``, buffer by
    buffer (a dictionary column's codes under its one dictionary)."""
    _expect(f"{name} schema", got.schema.names == want.schema.names
            and got.num_rows == want.num_rows)
    for n in want.schema.names:
        whole, at = want.column(n).combine(), 0
        for chunk in got.column(n).chunks:
            _same_data(f"{name} {n} rows {at}", chunk.data,
                       whole.slice(at, len(chunk)).data)
            at += len(chunk)


def _decoded(col):
    """A dictionary column of strings as a plain string Array (its codes'
    bytes gathered in numpy)."""
    from arrow_tpu_torch.array.array import Array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.buffer import Buffer
    import arrow_tpu_torch.types as T
    d = col.combine().data
    dd = d.dictionary
    doffs = dd.offsets().astype(np.int64)
    codes = d.values().astype(np.int64)
    starts, lens = doffs[codes], doffs[codes + 1] - doffs[codes]
    offs = np.zeros(len(codes) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    at = np.repeat(starts - offs[:-1], lens) + np.arange(offs[-1])
    return Array(ArrayData(T.string(), len(codes), [
        None, Buffer(offs.astype(np.int32)),
        Buffer(dd.data_bytes()[at])], null_count=0))


def _mapped_root(values):
    """The object that owns a numpy array's memory: the end of its chain
    of bases, through a memoryview to the object it exports."""
    while isinstance(values, (np.ndarray, memoryview)):
        values = values.base if isinstance(values, np.ndarray) else \
            values.obj
    return values


def _files_lineitem(li, tmp, paths, dev, peaks, facts):
    """Lineitem as FILE_SLICES IPC files; Q1 by a scan source and Q6 by a
    Scanner over ``dataset(dir, format="ipc")``, each twice, against the
    same over 3n's in-memory slices (exact, with the same launches); one
    file read whole through a memory map, without a copy."""
    import mmap
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch import ipc
    from arrow_tpu_torch.acero import Declaration, ScanNodeOptions
    from arrow_tpu_torch.io import tpch_queries as tq
    from arrow_tpu_torch.io_streams import memory_map
    n = li.num_rows
    step = -(-n // FILE_SLICES)
    slices = [li.slice(i, step) for i in range(0, n, step)]
    root = os.path.join(tmp, "lineitem")
    os.makedirs(root)

    def write():
        for i, part in enumerate(slices):
            with open(os.path.join(root, f"part-{i}.arrow"), "wb") as f:
                with ipc.new_file(f, part.schema) as w:
                    w.write_table(part)
    paths.run("write lineitem ipc", write)
    files = sorted(os.listdir(root))
    nbytes = sum(os.path.getsize(os.path.join(root, f)) for f in files)
    wall = paths.walls["3o write lineitem ipc"]
    facts["lineitem ipc GB"] = nbytes / 1e9
    facts["lineitem ipc write GB/s"] = nbytes / 1e9 / wall
    log(f"  lineitem as {len(files)} IPC files: {nbytes / 1e9:.3f} GB in "
        f"{wall:.3f} s ({nbytes / 1e9 / wall:.2f} GB/s)")
    data = ds.dataset(root, format="ipc")
    memory = ds.InMemoryDataset(slices)
    q1_read = sum(_table_bytes(frag.to_table(Q1_COLUMNS))
                  for frag in data.fragments)
    facts["Q1 bytes mapped GB"] = q1_read / 1e9
    log(f"  Q1 maps {q1_read / 1e9:.3f} GB of the files' {nbytes / 1e9:.3f}"
        f" GB ({len(Q1_COLUMNS)} of {len(li.schema)} columns, "
        f"{q1_read / n:.1f} of {nbytes / n:.1f} B a row)")
    cond = q6_condition()
    results = {}
    for source, dset, runs in (("in memory", memory, ("",)),
                               ("ipc", data, ("", " again"))):
        for again in runs:
            scan1 = _with_leaf(tq.q1_plan(li), Declaration(
                "scan", ScanNodeOptions(dset, Q1_COLUMNS)))
            key = f"scan Q1 {source}{again}"
            base = memory_mark() if paths.cuda else 0
            results[key] = paths.run(key, lambda: scan1.to_table(device=dev))
            if paths.cuda:
                peaks[key] = (torch.cuda.max_memory_allocated() - base) / 2**30
            key = f"scanner Q6 {source}{again}"
            base = memory_mark() if paths.cuda else 0
            results[key] = paths.run(key, lambda: ds.Scanner(
                dset, Q6_COLUMNS, cond, device=dev).to_table())
            if paths.cuda:
                peaks[key] = (torch.cuda.max_memory_allocated() - base) / 2**30
    for q in ("scan Q1", "scanner Q6"):
        want = table_digest(results[f"{q} in memory"])
        for again in ("", " again"):
            _expect(f"{q} ipc{again}",
                    table_digest(results[f"{q} ipc{again}"]) == want)
    log(f"  {data.schema.names[:3]}...: the file scans equal the in-memory "
        "slices' bit for bit")
    # one file through a memory map: its slice buffer for buffer, no copy
    f = memory_map(os.path.join(root, files[1]))
    try:
        back = paths.run("read_all mapped", lambda: ipc.open_file(
            f).read_all())
        _same_table("mapped read_all", back, slices[1])
        lo = f.mapped().ctypes.data
        hi = lo + f.size()
        for col in back.columns:
            for buf in col.chunks[0].data.buffers:
                if buf is not None:
                    at = buf.to_numpy().ctypes.data
                    _expect("mapped read_all copies no body byte",
                            lo <= at < hi)
        root_obj = _mapped_root(back.column("l_extendedprice").chunks[0]
                                .data.buffers[1].to_numpy())
        _expect("a mapped column's base is the map",
                isinstance(root_obj, mmap.mmap))
    finally:
        f.close()
    log(f"  {files[1]} read whole through a memory map: equal to its slice, "
        "every buffer inside the map")
    for name in files:
        os.remove(os.path.join(root, name))
    return table_digest(results["scan Q1 in memory"])


def _files_feather(li, od, tmp, paths, dev, want_q1, facts):
    """Q1's columns of all of lineitem as one Feather V2 file with LZ4, Q1
    over ``dataset(path, format="feather")`` against the in-memory
    slices' (``want_q1``, its digest: the same rows end to end, so the
    same bits); orders' V1 columns through Feather V1."""
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch import feather
    from arrow_tpu_torch.acero import Declaration, ScanNodeOptions
    from arrow_tpu_torch.io import tpch_queries as tq
    from arrow_tpu_torch.table import Table
    from arrow_tpu_torch.types import TypeId
    path = os.path.join(tmp, "q1.feather")
    q1 = li.select(Q1_COLUMNS)
    raw = _table_bytes(q1)
    paths.run("write feather lz4", lambda: feather.write_feather(
        q1, path, compression="lz4"))
    size = os.path.getsize(path)
    back = paths.run("read feather lz4", lambda: feather.read_table(path))
    _same_table("feather lz4", back, q1)
    w, r = (paths.walls[f"3o {k} feather lz4"] for k in ("write", "read"))
    facts.update({"feather raw GB": raw / 1e9, "feather lz4 GB": size / 1e9,
                  "lz4 compress GB/s": raw / 1e9 / w,
                  "lz4 decompress GB/s": raw / 1e9 / r})
    log(f"  Feather V2 LZ4 of Q1's columns: {raw / 1e9:.3f} GB to "
        f"{size / 1e9:.3f} GB, compressed and written at "
        f"{raw / 1e9 / w:.2f} GB/s, read and decompressed at "
        f"{raw / 1e9 / r:.2f} GB/s (host)")
    del back
    data = ds.dataset([path], format="feather")
    scan1 = _with_leaf(tq.q1_plan(li), Declaration(
        "scan", ScanNodeOptions(data, Q1_COLUMNS)))
    got = paths.run("scan Q1 feather", lambda: scan1.to_table(device=dev))
    _expect("scan Q1 feather", table_digest(got) == want_q1)
    os.remove(path)
    # Feather V1: orders' integer and float columns, and two dictionary
    # columns as plain strings (V1 stores no dictionary and no date)
    cols = [_decoded(od.column(c)) if od.column(c).type.id ==
            TypeId.DICTIONARY else od.column(c).combine() for c in V1_ORDERS]
    v1 = Table.from_arrays(cols, list(V1_ORDERS))
    path = os.path.join(tmp, "orders.feather")
    paths.run("write feather v1", lambda: feather.write_feather(
        v1, path, version=1))
    back = paths.run("read feather v1", lambda: feather.read_table(path))
    _same_table("feather v1", back, v1)
    facts["orders v1 GB"] = os.path.getsize(path) / 1e9
    log(f"  Feather V1 of orders' {len(V1_ORDERS)} columns: "
        f"{facts['orders v1 GB']:.3f} GB, read back equal")
    del back
    os.remove(path)


HIVE_COLUMNS = ["o_orderpriority", "o_totalprice", "o_custkey"]


def hive_orders_plan(source, ac=None):
    """The orders of ``source`` by priority: their count, total price,
    lowest and highest price and sum of customer keys, the priorities in
    order."""
    if ac is None:
        import arrow_tpu_torch.acero as ac
    return ac.Declaration.from_sequence([
        source,
        ac.Declaration("aggregate", ac.AggregateNodeOptions(
            [("o_totalprice", "hash_count", None, "orders"),
             ("o_totalprice", "hash_sum", None, "total"),
             ("o_totalprice", "hash_min", None, "lowest"),
             ("o_totalprice", "hash_max", None, "highest"),
             ("o_custkey", "hash_sum", None, "customers")],
            keys=["o_orderpriority"])),
        ac.Declaration("order_by", ac.OrderByNodeOptions(
            [("o_orderpriority", "ascending")]))])


def _files_hive(od, tmp, paths, dev, facts):
    """write_dataset of orders partitioned by o_orderstatus (hive); the
    orders of HIVE_STATUS by priority over a scan of the dataset under
    that filter (pruned to one directory) against the same aggregate over
    the host Table under a filter node: counts, integer sums, the lowest
    and highest prices exact, the float sum within rtol 1e-9 (its
    additions follow other row positions)."""
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                       ScanNodeOptions,
                                       TableSourceNodeOptions, field)
    from arrow_tpu_torch.types import Field, Schema
    root = os.path.join(tmp, "orders_hive")
    paths.run("write_dataset hive", lambda: ds.write_dataset(
        od, root, format="ipc", partitioning=["o_orderstatus"],
        partitioning_flavor="hive"))
    dirs = sorted(os.listdir(root))
    facts["hive GB"] = sum(os.path.getsize(os.path.join(root, d, f))
                           for d in dirs
                           for f in os.listdir(os.path.join(root, d))) / 1e9
    data = ds.dataset(root, format="ipc", partitioning=ds.HivePartitioning(
        Schema([Field("o_orderstatus", T.string())])))
    cond = field("o_orderstatus") == HIVE_STATUS
    kept = list(data.get_fragments(cond))
    _expect("hive pruning", len(kept) == 1 and len(data.fragments)
            == len(dirs), f"({len(kept)} of {len(data.fragments)})")
    got = paths.run("hive orders", lambda: hive_orders_plan(Declaration(
        "scan", ScanNodeOptions(data, HIVE_COLUMNS, cond))).to_table(
            device=dev))
    want = paths.run("hive orders (table)", lambda: hive_orders_plan(
        Declaration.from_sequence([
            Declaration("table_source", TableSourceNodeOptions(
                od.select(["o_orderstatus"] + HIVE_COLUMNS))),
            Declaration("filter", FilterNodeOptions(cond))])).to_table(
                device=dev))
    _same_result("hive orders", got, want)
    g, w = got.to_pydict(), want.to_pydict()
    _expect("hive orders exact", all(g[k] == w[k] for k in (
        "o_orderpriority", "orders", "lowest", "highest", "customers")))
    log(f"  hive: {dirs}, {facts['hive GB']:.3f} GB; the filter prunes "
        f"{len(data.fragments) - len(kept)} of {len(data.fragments)} "
        f"fragments; {got.num_rows} priorities equal to the Table's plan")
    shutil.rmtree(root)


def _files_stream(od, tmp, paths):
    """orders as an IPC stream in batches of FILE_STREAM_ROWS rows, its
    dictionaries written once, read back through a memory map."""
    from arrow_tpu_torch import ipc
    from arrow_tpu_torch.io_streams import memory_map
    path = os.path.join(tmp, "orders.arrows")

    def write():
        with open(path, "wb") as f:
            with ipc.new_stream(f, od.schema) as w:
                w.write_table(od, FILE_STREAM_ROWS)
    paths.run("write stream", write)
    f = memory_map(path)
    try:
        back = paths.run("read stream", lambda: ipc.open_stream(
            f).read_all())
        _expect("stream batches", back.columns[0].num_chunks ==
                -(-od.num_rows // FILE_STREAM_ROWS))
        _same_table("stream", back, od)
    finally:
        f.close()
    log(f"  orders stream: {os.path.getsize(path) / 1e9:.3f} GB in "
        f"{back.columns[0].num_chunks} batches, read back equal")
    os.remove(path)


def phase_files(host, device="cuda"):
    """Phase 3o: files, over phase 3l's host Tables. Lineitem as
    FILE_SLICES IPC files, scanned by Q1 and Q6 (twice each) against the
    same scans of the in-memory slices; one file read whole through a
    memory map without a copy; Q1's columns as a Feather V2 file with LZ4
    and Q1 over it; orders through Feather V1; orders written partitioned
    by status (hive) and one status's orders by priority over the pruned
    dataset against the Table's plan; orders as an IPC stream in batches.
    Each path's launches are set to 0 just before and read just after (on
    the card) and held to FILE_LAUNCHES. The files go to a temporary
    directory, removed at the end; the phase refuses to start where its
    free space is short. Returns (launches by path, facts)."""
    import tempfile
    dev = torch.device(device)
    log(f"== phase 3o: files on {device}")
    t0 = time.perf_counter()
    li, od = host["lineitem"], host["orders"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        # the most the phase holds at once: lineitem's files
        need = _table_bytes(li) + (1 << 26)
        free = _free_bytes(tmp)
        log(f"  {tmp}: {free / 1e9:.3f} GB free, the phase writes at most "
            f"{need / 1e9:.3f} GB at once")
        if free < need:
            raise RuntimeError(f"{tmp} lacks {(need - free) / 1e9:.3f} GB "
                               "for phase 3o's files")
        paths = _Paths(dev, "3o", FILE_LAUNCHES)
        peaks, facts = {}, {}
        want_q1 = _files_lineitem(li, tmp, paths, dev, peaks, facts)
        _files_feather(li, od, tmp, paths, dev, want_q1, facts)
        _files_hive(od, tmp, paths, dev, facts)
        _files_stream(od, tmp, paths)
        paths.check_launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("phase 3o facts: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in facts.items()))
    if peaks:
        log("phase 3o peak memory above the tables (GiB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in peaks.items()))
    log(f"phase 3o: {time.perf_counter() - t0:.1f} s (paths "
        f"{sum(paths.walls.values()):.1f} s)")
    return paths.launches, {"walls": paths.walls, "peaks": peaks,
                            "facts": facts}


# --- phase 3p: Parquet ---------------------------------------------------------

# orders' columns in Parquet: all but the clerk and the comment, whose
# strings would add writing and reading time and exercise nothing more
PARQUET_ORDERS = ["o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
                  "o_orderdate", "o_orderpriority", "o_shippriority"]
PARQUET_KEY = bytes(range(16))  # the encrypted orders file's footer key
PARQUET_READ_FILE = 1           # the lineitem file read_table filters
PARQUET_CODER_ROWS = 1 << 20    # flags the two fallback coders are timed on
# launches of phase 3p's paths, reckoned from their plan trees before the
# first run (each +1 probe, from self_check): Q1 over the Parquet files is
# 3o's scan Q1 (seven float sums, K1, 12 slots: the flags come back as
# plain strings and are coded on upload to the same three and two
# values); the Scanner under Q6's filter compacts the kept rows once
# (K2); read_table's DNF filters become one filter plan over the file's
# Table, one compaction (K2); the orders of one status by priority over
# parquet_dataset, and over the Table, are 3o's hive paths (one float
# sum, K1, 5 slots); every other path (the writes, the reads, the
# encrypted round trip) launches none
PARQUET_LAUNCHES = {
    "3p scan Q1 in memory": _SCAN_Q1, "3p scan Q1 parquet": _SCAN_Q1,
    "3p scan Q1 parquet again": _SCAN_Q1,
    "3p scanner Q6 in memory": _SCANNER_Q6,
    "3p scanner Q6 parquet": _SCANNER_Q6,
    "3p read_table Q6 filters": _SCANNER_Q6,
    "3p parquet_dataset orders": _HIVE,
    "3p parquet_dataset orders (table)": _HIVE,
}


def q6_filters():
    """Q6's condition as DNF filters (one AND group)."""
    from arrow_tpu_torch.io.tpch_queries import (DATE_1994_01_01,
                                                 DATE_1995_01_01)
    return [("l_shipdate", ">=", DATE_1994_01_01),
            ("l_shipdate", "<", DATE_1995_01_01),
            ("l_discount", ">=", 0.05), ("l_discount", "<=", 0.07),
            ("l_quantity", "<", 24.0)]


def q1_host_oracle(li):
    """Q1 with numpy bincounts over a host lineitem Table whose flags are
    dictionary columns, in the plan's output order."""
    from arrow_tpu_torch.array.array import Array
    from arrow_tpu_torch.io.tpch_queries import DATE_1998_09_02

    def flag(name):
        d = li.column(name).combine().data
        return d.values().astype(np.int64), Array(d.dictionary).to_pylist()
    rf, rf_dict = flag("l_returnflag")
    ls, ls_dict = flag("l_linestatus")
    keep = _host_values(li, "l_shipdate") <= DATE_1998_09_02
    key = (rf * len(ls_dict) + ls)[keep]
    size = len(rf_dict) * len(ls_dict)
    qty = _host_values(li, "l_quantity")[keep]
    price = _host_values(li, "l_extendedprice")[keep]
    disc = _host_values(li, "l_discount")[keep]
    tax = _host_values(li, "l_tax")[keep]
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


def _same_scan(name, got, want):
    """A result over Parquet against the same over the in-memory slices:
    the same columns and rows, a column whose source was a dictionary by
    value (Parquet gives it back as plain strings), every other column
    bit for bit."""
    from arrow_tpu_torch.types import TypeId
    _expect(f"{name} columns", got.column_names == want.column_names
            and got.num_rows == want.num_rows)
    for n, g, w in zip(want.column_names, table_digest(got),
                       table_digest(want)):
        if want.column(n).type.id == TypeId.DICTIONARY:
            _expect(f"{name} {n}", got.column(n).to_pylist()
                    == want.column(n).to_pylist())
        else:
            _expect(f"{name} {n} bits", g == w)


def _selected_rows(name, got, tbl, mask, columns):
    """``got`` is ``tbl``'s ``columns`` at ``mask``, bit for bit, with no
    null."""
    _expect(f"{name} rows", got.column_names == list(columns)
            and got.num_rows == int(mask.sum()))
    for c in columns:
        col = got.column(c).combine()
        _expect(f"{name} {c} nulls", col.null_count == 0)
        _expect_equal(f"{name} {c}", _np_bits(col.data.values()),
                      _np_bits(_host_values(tbl, c)[mask]))


def _parquet_lineitem(li, tmp, paths, dev, peaks, facts):
    """The first 1/ROOM_DEPTH of lineitem's rows, its Q1 columns, as
    FILE_SLICES snappy Parquet files; Q1 by a
    scan source over ``dataset(dir)`` twice and Q6 by a Scanner, each
    against numpy and against the same over the in-memory slices;
    read_table of one file under Q6's filters; the reads, the flags'
    uploads and snappy alone timed."""
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch.acero import Declaration, ScanNodeOptions
    from arrow_tpu_torch.device import column
    from arrow_tpu_torch.device.column import upload_table
    from arrow_tpu_torch.io import parquet as pq
    from arrow_tpu_torch.io import tpch_queries as tq
    from arrow_tpu_torch.utils import snappy
    n = li.num_rows
    step = -(-n // FILE_SLICES)
    slices = [li.slice(i, step) for i in range(0, n, step)]
    q1_slices = [s.select(Q1_COLUMNS) for s in slices]
    root = os.path.join(tmp, "lineitem")
    os.makedirs(root)

    def write():
        for i, part in enumerate(q1_slices):
            pq.write_table(part, os.path.join(root, f"part-{i}.parquet"),
                           compression="snappy")
    paths.run("write lineitem parquet", write)
    files = sorted(os.listdir(root))
    nbytes = sum(os.path.getsize(os.path.join(root, f)) for f in files)
    raw = _table_bytes(li.select(Q1_COLUMNS))  # the slices share buffers
    wall = paths.walls["3p write lineitem parquet"]
    facts.update({"lineitem parquet GB": nbytes / 1e9,
                  "lineitem Q1 columns GB": raw / 1e9,
                  "parquet write GB/s": raw / 1e9 / wall})
    log(f"  lineitem's Q1 columns ({raw / 1e9:.3f} GB) as {len(files)} "
        f"snappy Parquet files: {nbytes / 1e9:.3f} GB in {wall:.3f} s "
        f"({raw / 1e9 / wall:.2f} GB/s of columns)")
    data = ds.dataset(root)
    _expect("parquet is the default format",
            isinstance(data.fragments[0].format, ds.ParquetFileFormat))
    # the files read alone, then their flags uploaded alone
    read = paths.run("read lineitem parquet", lambda: [
        frag.to_table(Q1_COLUMNS) for frag in data.fragments])
    wall = paths.walls["3p read lineitem parquet"]
    facts["parquet read GB/s"] = raw / 1e9 / wall
    for part, back in zip(q1_slices, read):
        _expect("parquet read", back.column_names == Q1_COLUMNS
                and back.num_rows == part.num_rows)
        for c in Q1_COLUMNS:
            if c in HOST_FLAGS:
                _same_data(f"read {c}", back.column(c).combine().data,
                           _decoded(part.column(c)).data)
            else:
                _same_data(f"read {c}", back.column(c).combine().data,
                           part.column(c).combine().data)
    _expect("the reader hands the flags' codes over", all(
        chunk.data in column._KNOWN_CODES for t in read for c in HOST_FLAGS
        for chunk in t.column(c).chunks))
    flags = paths.run("upload flags", lambda: [upload_table(
        t.select(HOST_FLAGS), device=dev) for t in read])
    facts["flags upload s"] = paths.walls["3p upload flags"]
    log(f"  read back at {raw / 1e9 / wall:.2f} GB/s, equal to the slices "
        "(the flags as plain strings); the flags' upload takes "
        f"{2 * n} strings in {facts['flags upload s']:.3f} s, their codes "
        "handed over by the reader from the dictionary pages")
    # the upload's coders where no codes are handed over: of short values
    # and the checked hash of longer ones, over PARQUET_CODER_ROWS of one
    # file's l_returnflag: the same codes
    d = read[0].column("l_returnflag").combine().data
    offs = d.offsets().astype(np.int64)[:PARQUET_CODER_ROWS + 1]
    starts, lens, fbytes = offs[:-1], np.diff(offs), d.data_bytes()
    t0 = time.perf_counter()
    short = column._first_appearance(column._short_keys(fbytes, starts,
                                                        lens))
    t1 = time.perf_counter()
    hashed = column._codes_by_hash(fbytes, starts, lens)
    t2 = time.perf_counter()
    _expect("the flag coders", all(np.array_equal(a, b)
                                   for a, b in zip(short, hashed)))
    facts.update({"flag coder short keys s": t1 - t0,
                  "flag coder hash s": t2 - t1})
    log(f"  {len(lens)} of one file's l_returnflag strings coded by short "
        f"keys in {t1 - t0:.3f} s, by the checked hash in {t2 - t1:.3f} s "
        "(a scan takes the reader's codes instead)")
    del flags, read
    # snappy alone over one file's l_extendedprice, on the host
    col = slices[0].column("l_extendedprice").combine().data.values() \
        .view(np.uint8)
    t0 = time.perf_counter()
    packed = snappy.compress(col)
    t1 = time.perf_counter()
    back = snappy.decompress(packed)
    t2 = time.perf_counter()
    _expect("snappy round trip", back == col.tobytes())
    facts.update({"snappy compress GB/s": col.size / 1e9 / (t1 - t0),
                  "snappy decompress GB/s": col.size / 1e9 / (t2 - t1)})
    log(f"  snappy over a file's l_extendedprice ({col.size / 1e9:.3f} GB to "
        f"{len(packed) / 1e9:.3f} GB): compress "
        f"{facts['snappy compress GB/s']:.3f} GB/s, decompress "
        f"{facts['snappy decompress GB/s']:.3f} GB/s (host, one thread)")
    del packed, back
    memory = ds.InMemoryDataset(slices)
    cond = q6_condition()
    results = {}
    for source, dset, runs in (("in memory", memory, ("",)),
                               ("parquet", data, ("", " again"))):
        for again in runs:
            scan1 = _with_leaf(tq.q1_plan(li), Declaration(
                "scan", ScanNodeOptions(dset, Q1_COLUMNS)))
            key = f"scan Q1 {source}{again}"
            base = memory_mark() if paths.cuda else 0
            results[key] = paths.run(key, lambda: scan1.to_table(device=dev))
            if paths.cuda:
                peaks[key] = (torch.cuda.max_memory_allocated() - base) / 2**30
            if again:
                continue
            key = f"scanner Q6 {source}"
            base = memory_mark() if paths.cuda else 0
            results[key] = paths.run(key, lambda: ds.Scanner(
                dset, Q6_COLUMNS, cond, device=dev).to_table())
            if paths.cuda:
                peaks[key] = (torch.cuda.max_memory_allocated() - base) / 2**30
    q1_oracle = q1_host_oracle(li)
    check_result("scan Q1 parquet", results["scan Q1 parquet"].to_pydict(),
                 q1_oracle)
    for again in ("", " again"):
        _same_scan(f"scan Q1 parquet{again}",
                   results[f"scan Q1 parquet{again}"],
                   results["scan Q1 in memory"])
    mask = q6_mask(li)
    _selected_rows("scanner Q6 parquet", results["scanner Q6 parquet"], li,
                   mask, Q6_COLUMNS)
    _same_scan("scanner Q6 parquet", results["scanner Q6 parquet"],
               results["scanner Q6 in memory"])
    # one file under Q6's DNF filters: a filter plan on the card
    part = slices[PARQUET_READ_FILE]
    got = paths.run("read_table Q6 filters", lambda: pq.read_table(
        os.path.join(root, files[PARQUET_READ_FILE]), columns=Q6_COLUMNS,
        filters=q6_filters(), device=dev))
    # a Parquet read keeps the file's column order
    _selected_rows("read_table Q6 filters", got, part, q6_mask(part),
                   [c for c in Q1_COLUMNS if c in Q6_COLUMNS])
    log(f"  Q1 over the Parquet files (twice) and Q6's Scanner equal numpy "
        "and the in-memory slices' scans; read_table under Q6's filters "
        f"kept {got.num_rows} of {part.num_rows} rows, equal to numpy")
    shutil.rmtree(root)


def _parquet_orders(od, first, tmp, paths, dev, facts):
    """orders' PARQUET_ORDERS by write_to_dataset, hive-partitioned by
    o_orderstatus, with a metadata_collector and a ``_metadata`` file by
    write_metadata; the orders of HIVE_STATUS by priority over
    parquet_dataset against the Table's plan (3o's check); orders' first
    rows (``first``) as one uniformly AES-GCM encrypted file, read back
    equal."""
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                       ScanNodeOptions,
                                       TableSourceNodeOptions, field)
    from arrow_tpu_torch.io import parquet as pq
    from arrow_tpu_torch.io.parquet import encryption as pe
    from arrow_tpu_torch.table import Table
    from arrow_tpu_torch.types import Field, Schema, TypeId
    sel = od.select(PARQUET_ORDERS)
    root = os.path.join(tmp, "orders_parquet")
    collector = []
    paths.run("write_to_dataset orders", lambda: pq.write_to_dataset(
        sel, root, partition_cols=["o_orderstatus"],
        metadata_collector=collector))
    rest = Schema([f for f in sel.schema if f.name != "o_orderstatus"])
    pq.write_metadata(rest, os.path.join(root, "_metadata"),
                      metadata_collector=collector)
    dirs = sorted(d for d in os.listdir(root) if not d.startswith("_"))
    _expect("metadata_collector", [m.file_path for m in collector] ==
            [f"{d}/part-0.parquet" for d in dirs]
            and sum(m.num_rows for m in collector) == od.num_rows)
    facts["orders parquet GB"] = sum(
        os.path.getsize(os.path.join(root, d, "part-0.parquet"))
        for d in dirs) / 1e9
    data = ds.parquet_dataset(
        os.path.join(root, "_metadata"), partitioning=ds.HivePartitioning(
            Schema([Field("o_orderstatus", T.string())])))
    cond = field("o_orderstatus") == HIVE_STATUS
    kept = list(data.get_fragments(cond))
    _expect("parquet_dataset fragments", len(data.fragments) == len(dirs)
            and len(kept) == 1, f"({len(kept)} of {len(data.fragments)})")
    got = paths.run("parquet_dataset orders", lambda: hive_orders_plan(
        Declaration("scan", ScanNodeOptions(data, HIVE_COLUMNS, cond)))
        .to_table(device=dev))
    want = paths.run("parquet_dataset orders (table)", lambda: (
        hive_orders_plan(Declaration.from_sequence([
            Declaration("table_source", TableSourceNodeOptions(
                od.select(["o_orderstatus"] + HIVE_COLUMNS))),
            Declaration("filter", FilterNodeOptions(cond))]))
        .to_table(device=dev)))
    _same_result("parquet_dataset orders", got, want)
    g, w = got.to_pydict(), want.to_pydict()
    _expect("parquet_dataset orders exact", all(g[k] == w[k] for k in (
        "o_orderpriority", "orders", "lowest", "highest", "customers")))
    log(f"  orders hive-partitioned in Parquet: {dirs}, "
        f"{facts['orders parquet GB']:.3f} GB, {len(collector)} files "
        "collected; parquet_dataset over _metadata prunes to one "
        f"directory; {got.num_rows} priorities equal to the Table's plan")
    shutil.rmtree(root)
    # one encrypted file: every module AES-GCM under the footer key
    sel = first.select(PARQUET_ORDERS)
    path = os.path.join(tmp, "orders_encrypted.parquet")
    paths.run("write orders encrypted", lambda: pq.write_table(
        sel, path, encryption_properties=pe.FileEncryptionProperties(
            PARQUET_KEY)))
    with open(path, "rb") as f:
        head = f.read(4)
    _expect("encrypted footer", head == pe.MAGIC_ENCRYPTED)
    back = paths.run("read orders encrypted", lambda: pq.read_table(
        path, decryption_properties=pe.FileDecryptionProperties(
            footer_key=PARQUET_KEY)))
    want = Table.from_arrays(
        [_decoded(sel.column(c)) if sel.column(c).type.id ==
         TypeId.DICTIONARY else sel.column(c).combine()
         for c in PARQUET_ORDERS], PARQUET_ORDERS)
    _same_table("orders encrypted", back, want)
    size = os.path.getsize(path)
    facts["orders encrypted GB"] = size / 1e9
    log(f"  orders as one AES-GCM file: {size / 1e9:.3f} GB, written in "
        f"{paths.walls['3p write orders encrypted']:.3f} s, read back "
        f"equal in {paths.walls['3p read orders encrypted']:.3f} s")
    os.remove(path)


# F8 and F9 (ROADMAP.md §3) on the card's machine: orders' fixed-width
# columns declared non-nullable; the nested form over the first
# PARQUET_NESTED_ROWS orders (its levels are shredded a row at a time)
PARQUET_REQUIRED = ["o_orderkey", "o_custkey", "o_totalprice", "o_orderdate"]
PARQUET_NESTED_ROWS = 100_000


def _parquet_required(od, tmp, paths, facts):
    """F8: orders' PARQUET_REQUIRED declared non-nullable, written with
    snappy and read back equal, flat at SF10 and as a non-nullable struct
    and list over the first PARQUET_NESTED_ROWS orders; every field stays
    non-nullable."""
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.array.array import array
    from arrow_tpu_torch.io import parquet as pq
    from arrow_tpu_torch.table import ChunkedArray, Table
    from arrow_tpu_torch.types import Field, Schema
    sel = od.select(PARQUET_REQUIRED)
    flat = Table(Schema([Field(f.name, f.type, False) for f in sel.schema]),
                 list(sel.columns))
    path = os.path.join(tmp, "orders_required.parquet")
    paths.run("write orders non-nullable", lambda: pq.write_table(
        flat, path, compression="snappy"))
    back = paths.run("read orders non-nullable",
                     lambda: pq.read_table(path))
    _expect("non-nullable fields", [f.nullable for f in back.schema] ==
            [False] * len(PARQUET_REQUIRED))
    for c in PARQUET_REQUIRED:
        _expect_equal(f"non-nullable {c}",
                      back.column(c).combine().data.values(),
                      sel.column(c).combine().data.values())
    facts["orders non-nullable GB"] = os.path.getsize(path) / 1e9
    os.remove(path)
    n = PARQUET_NESTED_ROWS
    keys = sel.column("o_orderkey").combine().data.values()[:n].tolist()
    price = sel.column("o_totalprice").combine().data.values()[:n].tolist()
    st = T.struct([("k", T.int64()), ("p", T.float64())])
    lt = T.list_(T.int64())
    rows = {"s": [{"k": k, "p": p} for k, p in zip(keys, price)],
            "l": [[k] * (k % 3) for k in keys]}
    nested = Table(Schema([Field("s", st, False), Field("l", lt, False)]),
                   [ChunkedArray([array(rows["s"], st)], st),
                    ChunkedArray([array(rows["l"], lt)], lt)])
    path = os.path.join(tmp, "orders_nested_required.parquet")
    paths.run("write nested non-nullable", lambda: pq.write_table(
        nested, path, compression="snappy"))
    back = paths.run("read nested non-nullable", lambda: pq.read_table(path))
    _expect("nested non-nullable", [f.nullable for f in back.schema] ==
            [False, False] and all(back.column(c).to_pylist() == rows[c]
                                   for c in rows))
    log(f"  F8: {len(PARQUET_REQUIRED)} non-nullable orders columns, "
        f"{facts['orders non-nullable GB']:.3f} GB of snappy Parquet, and a "
        f"non-nullable struct and list of {len(keys)} orders read back "
        f"equal")


def _bad_page_start():
    """F9's subprocess, started where nothing is measured: it reads a
    Parquet file of [1, 2] whose first page gives an uncompressed size of
    -64 (zigzag 0x7f in the header's third field) and must end normally
    with the OSError it caught printed (the host library aborted the process
    before the repair). Returns (the process, when it started, its
    directory); ``_bad_page_finish`` awaits it."""
    import subprocess
    import tempfile
    from arrow_tpu_torch.array.array import array
    from arrow_tpu_torch.io import parquet as pq
    from arrow_tpu_torch.table import Table
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bad_page_")
    path = os.path.join(tmp, "bad_page.parquet")
    pq.write_table(Table.from_arrays([array([1, 2])], ["x"]), path,
                   compression="snappy")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    _expect("page header", data[4:7] == b"\x15\x00\x15" and data[7] < 0x80)
    data[7] = 0x7F
    with open(path, "wb") as f:
        f.write(data)
    root = os.path.dirname(os.path.abspath(__file__))
    code = ("from arrow_tpu_torch.io import parquet as pq\n"
            "try:\n"
            f"    pq.read_table({path!r})\n"
            "except OSError as exc:\n"
            "    print('OSError:', exc)\n"
            "else:\n"
            "    raise SystemExit('read a malformed page')\n")
    return (subprocess.Popen([sys.executable, "-c", code], cwd=root,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=dict(os.environ,
                                                 PYTHONPATH=root)),
            time.perf_counter(), tmp)


def _bad_page_finish(bad_page):
    """Awaits ``_bad_page_start``'s process and removes its directory.
    Returns (its exit status, its output, its errors, its seconds)."""
    proc, t0, tmp = bad_page
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return proc.returncode, out, err, time.perf_counter() - t0


def _bad_page_check(bad_page):
    """F9 in phase 3p: ``bad_page`` is ``_bad_page_finish``'s record."""
    code, out, err, took = bad_page
    _expect("malformed page header", code == 0 and out.startswith("OSError"),
            f"(exit {code}: {out} {err[-400:]})")
    log(f"  F9: a page header with uncompressed size -64 read in a "
        f"subprocess: exit 0 with {out.strip()!r} in {took:.2f} s")


def phase_parquet(host, device="cuda", bad_page=None):
    """Phase 3p: Parquet, over phase 3l's host Tables. Lineitem's Q1
    columns as FILE_SLICES snappy Parquet files, read back and their
    flags uploaded alone, scanned by Q1 (twice) and Q6 against numpy and
    against the same scans of the in-memory slices; one file through
    read_table under Q6's filters on ``device``; orders hive-partitioned
    by write_to_dataset with a metadata_collector and a ``_metadata``
    file, one status's orders by priority over parquet_dataset against
    the Table's plan; orders as one AES-GCM encrypted file. Each path's
    launches are set to 0 just before and read just after (on the card)
    and held to PARQUET_LAUNCHES. The files go to a temporary directory,
    removed at the end; the phase refuses to start where its free space
    is short. F9: ``bad_page``, ``_bad_page_finish``'s record of a
    subprocess run during the set-up, or None to run one here after the
    timed paths. Returns (launches by path, facts)."""
    import tempfile
    dev = torch.device(device)
    log(f"== phase 3p: Parquet on {device}")
    t0 = time.perf_counter()
    li, od = host["lineitem"], host["orders"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parquet_")
    try:
        # the most the phase holds at once: lineitem's Q1 columns, as
        # files no larger than their columns
        need = _table_bytes(li.select(Q1_COLUMNS)) + (1 << 26)
        free = _free_bytes(tmp)
        log(f"  {tmp}: {free / 1e9:.3f} GB free, the phase writes at most "
            f"{need / 1e9:.3f} GB at once")
        if free < need:
            raise RuntimeError(f"{tmp} lacks {(need - free) / 1e9:.3f} GB "
                               "for phase 3p's files")
        paths = _Paths(dev, "3p", PARQUET_LAUNCHES)
        peaks, facts = {}, {}
        _parquet_lineitem(host.first("lineitem"), tmp, paths, dev, peaks,
                          facts)
        _parquet_orders(od, host.first("orders"), tmp, paths, dev, facts)
        _parquet_required(od, tmp, paths, facts)
        paths.check_launches()
        _bad_page_check(bad_page or _bad_page_finish(_bad_page_start()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("phase 3p facts: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in facts.items()))
    if peaks:
        log("phase 3p peak memory above the tables (GiB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in peaks.items()))
    log(f"phase 3p: {time.perf_counter() - t0:.1f} s (paths "
        f"{sum(paths.walls.values()):.1f} s)")
    return paths.launches, {"walls": paths.walls, "peaks": peaks,
                            "facts": facts}


# --- phase 3q: CSV, JSON and ORC ----------------------------------------------

CSV_OPEN_BLOCK = 1 << 27        # open_csv's block size over one file
ORC_ZLIB_STATUS = "P"           # the partition written again with zlib
ORC_PRICE = 400_000.0           # the Scanner keeps orders above this price
ORC_SCAN_COLUMNS = ["o_orderkey", "o_totalprice", "o_orderdate"]
JSON_FILE = "customer.json"
# launches of phase 3q's paths, reckoned from their plan trees before the
# first run (each +1 probe, from self_check): Q1 over the CSV files is 3p's
# scan Q1 (seven float sums, K1, 12 slots: the flags arrive as plain
# strings and are coded on upload to the same three and two values); the
# ORC Scanner under its price filter compacts the kept rows of the three
# partitions once (K2); the orders of one status by priority over the ORC
# dataset, and over the Table, are 3o's hive paths (one float sum, K1, 5
# slots); the customers by segment over the JSON dataset and over the host
# Table are one float sum each (K1, 5 slots; the count takes no kernel);
# every other path (the writes, the reads, open_csv, the zlib round trip)
# launches none
_SEGMENTS = {**_NO_LAUNCH, "grouped_sum": 1}
CSV_JSON_ORC_LAUNCHES = {
    "3q scan Q1 csv": _SCAN_Q1, "3q scanner orc price": _SCANNER_Q6,
    "3q orc dataset orders": _HIVE, "3q orc dataset orders (table)": _HIVE,
    "3q json segments": _SEGMENTS, "3q json segments (table)": _SEGMENTS,
}


def _codes_and_values(tbl, name):
    """A dictionary column's codes (numpy) and its values."""
    from arrow_tpu_torch.array.array import Array
    d = tbl.column(name).combine().data
    return d.values().astype(np.int64), Array(d.dictionary).to_pylist()


def _files_size(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs_ in os.walk(root) for f in fs_)


def _csv_lineitem(li, tmp, paths, dev, peaks, facts):
    """The first 1/ROOM_DEPTH of lineitem's rows, its Q1 columns, as
    FILE_SLICES CSV files by write_csv; Q1 by a scan source over
    ``dataset(dir, format="csv")`` against numpy and Q1 over the same rows
    in memory; open_csv over one file against that fragment's Table."""
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch.acero import Declaration, ScanNodeOptions
    from arrow_tpu_torch.io import csv
    from arrow_tpu_torch.io import tpch_queries as tq
    from arrow_tpu_torch.table import Table
    n = li.num_rows
    step = -(-n // FILE_SLICES)
    q1 = li.select(Q1_COLUMNS)
    root = os.path.join(tmp, "lineitem_csv")
    os.makedirs(root)

    def write():
        for i, s in enumerate(range(0, n, step)):
            csv.write_csv(q1.slice(s, step),
                          os.path.join(root, f"part-{i}.csv"))
    paths.run("write lineitem csv", write)
    nbytes = _files_size(root)
    wall = paths.walls["3q write lineitem csv"]
    facts.update({"lineitem csv GB": nbytes / 1e9,
                  "csv write GB/s": nbytes / 1e9 / wall})
    log(f"  lineitem's Q1 columns as {FILE_SLICES} CSV files: "
        f"{nbytes / 1e9:.3f} GB in {wall:.3f} s ({nbytes / 1e9 / wall:.3f} "
        "GB/s of text)")
    data = paths.run("dataset csv", lambda: ds.dataset(root, format="csv"))
    _expect("csv dataset", len(data.fragments) == FILE_SLICES
            and data.schema.names == Q1_COLUMNS)
    q1_in_memory = tq.q1_plan(li).to_table(device=dev)
    q1_oracle = q1_host_oracle(li)
    scan1 = _with_leaf(tq.q1_plan(li), Declaration(
        "scan", ScanNodeOptions(data, Q1_COLUMNS)))
    base = memory_mark() if paths.cuda else 0
    got = paths.run("scan Q1 csv", lambda: scan1.to_table(device=dev))
    if paths.cuda:
        peaks["scan Q1 csv"] = (torch.cuda.max_memory_allocated()
                                - base) / 2**30
    wall = paths.walls["3q scan Q1 csv"]
    facts["csv scan GB/s"] = nbytes / 1e9 / wall
    check_result("scan Q1 csv", got.to_pydict(), q1_oracle)
    _same_scan("scan Q1 csv", got, q1_in_memory)
    # one file streamed in blocks against that fragment's Table
    frag = data.fragments[0]
    blocks = paths.run("open_csv", lambda: list(csv.open_csv(
        frag.path, read_options=csv.ReadOptions(
            block_size=CSV_OPEN_BLOCK))))
    whole = paths.run("read_csv one file", lambda: frag.to_table())
    facts["csv read GB/s"] = os.path.getsize(frag.path) / 1e9 / \
        paths.walls["3q read_csv one file"]
    _same_table("open_csv", Table.from_batches(blocks), whole)
    log(f"  Q1 over the CSV files equals numpy and 3p's in-memory scan "
        f"({nbytes / 1e9 / wall:.3f} GB/s of text to a host Table); "
        f"open_csv gave {len(blocks)} blocks equal to read_csv of "
        f"{os.path.basename(frag.path)}")
    shutil.rmtree(root)


_PLAIN = {}  # the last plain_orders, by the orders Table's identity


def plain_orders(od):
    """orders with its dictionary columns as plain strings, but the
    partition column o_orderstatus, which no file holds (the ORC writer
    takes no dictionary type): made once for the same Table, for phases
    3q and 3r."""
    from arrow_tpu_torch.io.host_arrays import decoded
    from arrow_tpu_torch.table import Table
    from arrow_tpu_torch.types import TypeId
    hit = _PLAIN.get(id(od))
    if hit is None or hit[0] is not od:
        _PLAIN.clear()
        _PLAIN[id(od)] = hit = (od, Table.from_arrays(
            [decoded(c.combine()) if c.type.id == TypeId.DICTIONARY
             and n != "o_orderstatus" else c.combine()
             for n, c in zip(od.column_names, od.columns)],
            od.column_names))
    return hit[1]


def _orc_orders(od, tmp, paths, dev, facts):
    """The first 1/ROOM_DEPTH of orders' rows, every column, by
    write_dataset(format="orc") hive-partitioned
    by o_orderstatus (its dictionary columns but the partition column, which
    no file holds, as plain strings: the ORC writer takes no dictionary
    type); the orders of HIVE_STATUS by
    priority over the ORC dataset against the Table's plan (3o's check); a
    Scanner under a price filter against numpy; one partition written
    again with zlib and read back equal."""
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                       ScanNodeOptions,
                                       TableSourceNodeOptions, field)
    from arrow_tpu_torch.io import orc
    from arrow_tpu_torch.types import Field, Schema
    plain = plain_orders(od)
    root = os.path.join(tmp, "orders_orc")
    paths.run("write_dataset orc", lambda: ds.write_dataset(
        plain, root, format="orc", partitioning=["o_orderstatus"],
        partitioning_flavor="hive"))
    dirs = sorted(os.listdir(root))
    facts["orders orc GB"] = _files_size(root) / 1e9
    facts["orc write GB/s"] = _table_bytes(plain) / 1e9 / \
        paths.walls["3q write_dataset orc"]
    data = ds.dataset(root, format="orc", partitioning=ds.HivePartitioning(
        Schema([Field("o_orderstatus", T.string())])))
    cond = field("o_orderstatus") == HIVE_STATUS
    _expect("orc dataset", len(data.fragments) == len(dirs)
            and len(list(data.get_fragments(cond))) == 1)
    got = paths.run("orc dataset orders", lambda: hive_orders_plan(
        Declaration("scan", ScanNodeOptions(data, HIVE_COLUMNS, cond)))
        .to_table(device=dev))
    want = paths.run("orc dataset orders (table)", lambda: hive_orders_plan(
        Declaration.from_sequence([
            Declaration("table_source", TableSourceNodeOptions(
                od.select(["o_orderstatus"] + HIVE_COLUMNS))),
            Declaration("filter", FilterNodeOptions(cond))])).to_table(
                device=dev))
    _same_result("orc dataset orders", got, want)
    g, w = got.to_pydict(), want.to_pydict()
    _expect("orc dataset orders exact", all(g[k] == w[k] for k in (
        "o_orderpriority", "orders", "lowest", "highest", "customers")))
    # every partition under a price filter: the kept rows, partition by
    # partition in directory order, each in its rows' order
    scanned = paths.run("scanner orc price", lambda: ds.Scanner(
        data, ORC_SCAN_COLUMNS, field("o_totalprice") > ORC_PRICE,
        device=dev).to_table())
    codes, values = _codes_and_values(od, "o_orderstatus")
    price = _host_values(od, "o_totalprice")
    rows = np.concatenate([np.flatnonzero(
        np.isin(codes, [i for i, v in enumerate(values) if v == d[-1]])
        & (price > ORC_PRICE)) for d in dirs])
    _expect("scanner orc price rows", scanned.num_rows == len(rows))
    for c in ORC_SCAN_COLUMNS:
        _expect_equal(f"scanner orc price {c}",
                      _np_bits(scanned.column(c).combine().data.values()),
                      _np_bits(_host_values(od, c)[rows]))
    # one partition again, zlib-compressed
    part = os.path.join(root, f"o_orderstatus={ORC_ZLIB_STATUS}",
                        "part-0.orc")
    tbl = orc.read_table(part)
    zpath = os.path.join(tmp, "orders_zlib.orc")
    paths.run("write orc zlib", lambda: orc.write_table(tbl, zpath,
                                                        compression="zlib"))
    back = paths.run("read orc zlib", lambda: orc.read_table(zpath))
    _same_table("orc zlib", back, tbl)
    facts["orders orc zlib GB"] = os.path.getsize(zpath) / 1e9
    log(f"  orders as hive-partitioned ORC: {dirs}, "
        f"{facts['orders orc GB']:.3f} GB; {got.num_rows} priorities equal "
        f"to the Table's plan; the Scanner kept {len(rows)} orders above "
        f"{ORC_PRICE:g}, equal to numpy; {ORC_ZLIB_STATUS}'s {tbl.num_rows} "
        f"rows zlib-compressed ({os.path.getsize(part) / 1e9:.3f} -> "
        f"{facts['orders orc zlib GB']:.3f} GB) read back equal")
    os.remove(zpath)
    shutil.rmtree(root)


def write_ndjson(tbl, path):
    """A host Table of int64, float64, string and dictionary-of-string
    columns as newline-delimited JSON, a record a row: the values' cells
    (floats as Python's repr writes them, so they read back bit for bit)
    and the constant text between them gathered row by row by the host
    library, no Python a row. The strings must need no JSON escape."""
    from arrow_tpu_torch.io import csv_host
    from arrow_tpu_torch.io.parquet.host import gather_var_bytes
    from arrow_tpu_torch.types import TypeId
    n, names = tbl.num_rows, tbl.column_names
    cells, quoted = [], []
    for name in names:
        col = tbl.column(name)
        arr = _decoded(col) if col.type.id == TypeId.DICTIONARY else \
            col.combine()
        if arr.type.id in (TypeId.INT64, TypeId.DOUBLE):
            fmt = csv_host.csv_format_i64 if arr.type.id == TypeId.INT64 \
                else csv_host.csv_format_f64
            cells.append(fmt(arr.data.values(), None, raw=True))
            quoted.append(False)
            continue
        d = arr.data
        offs = d.offsets().astype(np.int64)
        pool = d.data_bytes()[offs[0]:offs[-1]]
        if (pool < 0x20).any() or (pool == ord('"')).any() \
                or (pool == ord("\\")).any():
            raise ValueError(f"{name} needs JSON escapes")
        cells.append((offs - offs[0], pool))
        quoted.append(True)
    # the text before, between and after the values
    consts = []
    for k, name in enumerate(names):
        before = ('"' if k and quoted[k - 1] else "") + \
            (", " if k else "{") + f'"{name}": ' + ('"' if quoted[k] else "")
        consts.append(before.encode())
    consts.append((('"' if quoted[-1] else "") + "}\n").encode())
    m = len(consts)
    const_offs = np.zeros(m + 1, dtype=np.int64)
    np.cumsum([len(c) for c in consts], out=const_offs[1:])
    offsets, pools = [const_offs], [np.frombuffer(b"".join(consts), np.uint8)]
    end = int(const_offs[-1])
    for offs, pool in cells:
        offsets.append(offs[1:] + end)
        pools.append(pool)
        end += int(offs[-1])
    ids = np.empty((n, 2 * len(names) + 1), dtype=np.int64)
    ids[:, 0::2] = np.arange(m)
    ids[:, 1::2] = m + np.arange(len(names)) * n + np.arange(n)[:, None]
    _, body = gather_var_bytes(np.concatenate(pools),
                               np.concatenate(offsets), ids.reshape(-1))
    with open(path, "wb") as f:
        f.write(memoryview(body))


def segments_plan(source, ac=None):
    """The customers of ``source`` by market segment: their count and the
    sum of their account balances, the segments in order."""
    if ac is None:
        import arrow_tpu_torch.acero as ac
    return ac.Declaration.from_sequence([
        source,
        ac.Declaration("aggregate", ac.AggregateNodeOptions(
            [("c_acctbal", "hash_count", None, "customers"),
             ("c_acctbal", "hash_sum", None, "balance")],
            keys=["c_mktsegment"])),
        ac.Declaration("order_by", ac.OrderByNodeOptions(
            [("c_mktsegment", "ascending")]))])


def _json_customer(cu, tmp, paths, dev, facts):
    """customer as newline-delimited JSON (the reference writes none);
    the customers by segment over ``dataset(path, format="json")`` against
    numpy and the same plan over the host Table; read_json of the file
    against the dataset's fragment Table."""
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch.acero import (Declaration, ScanNodeOptions,
                                       TableSourceNodeOptions)
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.io import json
    from arrow_tpu_torch.types import TypeId
    path = os.path.join(tmp, JSON_FILE)
    paths.run("write customer json", lambda: write_ndjson(cu, path))
    size = os.path.getsize(path)
    facts.update({"customer json GB": size / 1e9, "json write GB/s":
                  size / 1e9 / paths.walls["3q write customer json"]})
    data = ds.dataset([path], format="json")
    got = paths.run("json segments", lambda: segments_plan(Declaration(
        "scan", ScanNodeOptions(data, ["c_mktsegment", "c_acctbal"])))
        .to_table(device=dev))
    want = paths.run("json segments (table)", lambda: segments_plan(
        Declaration("table_source", TableSourceNodeOptions(
            cu.select(["c_mktsegment", "c_acctbal"])))).to_table(device=dev))
    _same_result("json segments", got, want)
    codes, values = _codes_and_values(cu, "c_mktsegment")
    names = sorted(set(values))
    key = np.array([names.index(v) for v in values], dtype=np.int64)[codes]
    bal = _host_values(cu, "c_acctbal")
    g = got.to_pydict()
    _expect("json segments keys", g["c_mktsegment"] == names
            and g["customers"] == np.bincount(key).tolist())
    _expect_close("json segments balance", np.array(g["balance"]),
                  np.bincount(key, weights=bal))
    frag = paths.run("json fragment", lambda: data.fragments[0].to_table())
    back = paths.run("read_json", lambda: json.read_json(path))
    facts["json read GB/s"] = size / 1e9 / paths.walls["3q read_json"]
    _same_table("read_json", back, frag)
    _expect("read_json types", back.schema.names == cu.column_names and [
        f.type for f in back.schema] == [
            T.string() if f.type.id == TypeId.DICTIONARY else f.type
            for f in cu.schema])
    log(f"  customer as ndjson: {size / 1e9:.3f} GB; {got.num_rows} segments "
        "equal to numpy and the Table's plan; read_json equals the "
        "dataset's fragment")
    os.remove(path)


def phase_csv_json_orc(host, device="cuda"):
    """Phase 3q: CSV, JSON and ORC, over phase 3l's host Tables. The first
    1/ROOM_DEPTH of lineitem's rows, its Q1 columns, as FILE_SLICES CSV
    files, scanned by Q1 against numpy's oracle and Q1 over the same rows in
    memory, one file through open_csv; the first 1/ROOM_DEPTH of orders'
    rows hive-partitioned as ORC, one
    status by priority against the Table's plan, a price Scanner against
    numpy, one partition zlib-compressed; customer as ndjson, grouped by
    segment against numpy and the Table's plan, read_json against the
    dataset's fragment. Each path's launches are set to 0 just before and
    read just after (on the card) and held to CSV_JSON_ORC_LAUNCHES. The
    files go to a temporary directory, removed at the end; the phase
    refuses to start where its free space is short. Returns (launches by
    path, facts)."""
    import tempfile
    dev = torch.device(device)
    log(f"== phase 3q: CSV, JSON and ORC on {device}")
    t0 = time.perf_counter()
    li, od, cu = host.first("lineitem"), host.first("orders"), \
        host["customer"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_text_")
    try:
        # the most the phase holds at once: lineitem's Q1 columns as text,
        # about 1.3 times their bytes
        need = 2 * _table_bytes(li.select(Q1_COLUMNS)) + (1 << 26)
        free = _free_bytes(tmp)
        log(f"  {tmp}: {free / 1e9:.3f} GB free, the phase writes at most "
            f"{need / 1e9:.3f} GB at once")
        if free < need:
            raise RuntimeError(f"{tmp} lacks {(need - free) / 1e9:.3f} GB "
                               "for phase 3q's files")
        paths = _Paths(dev, "3q", CSV_JSON_ORC_LAUNCHES)
        peaks, facts = {}, {}
        _csv_lineitem(li, tmp, paths, dev, peaks, facts)
        _orc_orders(od, tmp, paths, dev, facts)
        _json_customer(cu, tmp, paths, dev, facts)
        paths.check_launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("phase 3q facts: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in facts.items()))
    if peaks:
        log("phase 3q peak memory above the tables (GiB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in peaks.items()))
    log(f"phase 3q: {time.perf_counter() - t0:.1f} s (paths "
        f"{sum(paths.walls.values()):.1f} s)")
    return paths.launches, {"walls": paths.walls, "peaks": peaks,
                            "facts": facts}


# --- phase 3r: the host surface and the cloud file systems ---------------------

SURFACE_SEGMENT = "BUILDING"    # the customers the eight joins build on
SURFACE_TAKE = 1 << 20          # the rows the eager take gathers
SURFACE_NULL_QUANTITY = 5.0     # l_discount made null below this quantity
SURFACE_PY_ROWS = 100_000       # customer rows through Python rows
SURFACE_BATTERY = 1 << 20       # the bytes of each client's file round trip
FULL_WIDTH_LINEITEM = ["l_orderkey", "l_partkey", "l_extendedprice",
                       "l_discount"]
FULL_WIDTH_ORDERS = ["o_orderkey", "o_orderdate", "o_custkey"]


def _joins(compact, hash32):
    return {**_NO_LAUNCH, "compact": compact, "hash32": hash32}


# launches of phase 3r's paths, reckoned from their plan trees before the
# first run (each +1 probe, from self_check): the eight joins of orders to
# the customers of one segment are 3b's (JOIN_LAUNCHES_SF10) less the
# filter's compaction, the segment's customers being a host Table made on
# the host; the left outer join of every column takes no kernel (no bloom,
# the identity of a unique build); the full-width join is an inner join
# (every lineitem row has its order) that takes the bloom (probe capacity
# >= 4x build: 2 hashes and 1 compaction) and the unique-build compaction;
# the datasets' join is the segment's inner join over the datasets' Tables
# (a scan without a filter compacts nothing); the eager filter and
# drop_null compact once; the orders of one status by priority over the S3
# dataset and over the Table are 3o's hive paths (one float sum, K1); every
# other path (the as-of joins, the other column methods, the host-only
# methods, the writes and reads) launches none
HOST_SURFACE_LAUNCHES = {
    **{f"3r join {jt}": _joins(c - 1, h)
       for jt, (c, h) in JOIN_LAUNCHES_SF10.items()},
    "3r join full width": _joins(2, 2), "3r dataset join": _joins(2, 2),
    "3r chunked filter": _joins(1, 0), "3r chunked drop_null": _joins(1, 0),
    "3r s3 orders": _HIVE, "3r s3 orders (table)": _HIVE,
}


class _Downloads:
    """The wall of every download of a plan's result to a host Table
    (``acero.exec.download_table``) while it is entered, summed."""

    def __enter__(self):
        from arrow_tpu_torch.acero import exec as ex
        self.ex, self.inner, self.wall = ex, ex.download_table, 0.0

        def timed_download(batch):
            t0 = time.perf_counter()
            out = self.inner(batch)
            self.wall += time.perf_counter() - t0
            return out
        ex.download_table = timed_download
        return self

    def __exit__(self, *exc):
        self.ex.download_table = self.inner


def _plan_path(paths, name, fn, peaks, facts):
    """``fn`` as a path of ``paths``, its download wall and its peak above
    the tables recorded."""
    cuda = paths.cuda
    base = memory_mark() if cuda else 0
    with _Downloads() as dl:
        out = paths.run(name, fn)
    facts[f"{name} download s"] = dl.wall
    if cuda:
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
    return out


def _column(tbl, name, rows=None):
    """A host Table's column as numpy values and validity (all True where
    it has no bitmap), at ``rows`` where given."""
    d = tbl.column(name).combine().data
    vals, valid = d.values(), d.validity_mask()
    valid = np.ones(len(vals), dtype=bool) if valid is None else valid
    return (vals, valid) if rows is None else (vals[rows], valid[rows])


def _check_table_join(jt, out, src, runs, coalesced):
    """A Table.join of orders (o_orderkey, o_custkey) with the segment's
    customers (c_custkey, c_id) against ``join_oracle``: each column the
    join emits (the right key not where it is coalesced away), null on a
    row of the other side alone. ``src``: the inputs' columns by name."""
    p_idx, b_idx = join_oracle(jt, runs)
    _expect(f"3r join {jt} rows", out.num_rows == len(p_idx),
            f"({out.num_rows} against {len(p_idx)})")
    sides = [("o_orderkey", p_idx), ("o_custkey", p_idx),
             ("c_custkey", b_idx), ("c_id", b_idx)]
    if coalesced:
        del sides[2]
    if jt in ("left semi", "left anti"):
        sides = sides[:2]
    elif jt in ("right semi", "right anti"):
        sides = sides[2:]
    _expect(f"3r join {jt} columns", sorted(out.column_names) == sorted(
        s[0] for s in sides), f"({out.column_names})")
    for name, idx in sides:
        vals, valid = _column(out, name)
        hit = idx >= 0
        _expect(f"3r join {jt} {name} validity", np.array_equal(valid, hit))
        _expect_equal(f"3r join {jt} {name}", vals[hit] if not hit.all()
                      else vals, src[name][idx[hit]] if not hit.all()
                      else src[name][idx])
    return out.num_rows


def _same_strings_by_code(name, col, codes, values):
    """A string column, row by row, against ``values[codes]``: a
    dictionary column by its codes mapped to ``values``' codes; a plain
    one by its lengths, then for each value its rows' bytes, one position
    at a time (no index array as long as the bytes)."""
    from arrow_tpu_torch.array.array import Array
    from arrow_tpu_torch.types import TypeId
    arr = col.combine().data
    if arr.type.id == TypeId.DICTIONARY:
        own = np.array([values.index(v) for v in
                        Array(arr.dictionary).to_pylist()], dtype=np.int64)
        _expect_equal(name, own[arr.values().astype(np.int64)], codes)
        return
    offs = arr.offsets().astype(np.int64)
    raw = arr.data_bytes()
    enc = [v.encode() for v in values]
    lens = np.array([len(v) for v in enc], dtype=np.int64)
    _expect_equal(f"{name} lengths", np.diff(offs), lens[codes])
    for c, v in enumerate(enc):
        starts = offs[:-1][codes == c]
        for k, byte in enumerate(v):
            _expect(f"{name} bytes", bool((raw[starts + k] == byte).all()))


def _surface_joins(od, odp, cu, li, paths, dev, peaks, facts):
    """The eight join types of orders with one segment's customers (a host
    Table made on the host), a left outer join of every column of both,
    the full-width join of lineitem with orders, and as-of joins and the
    datasets' joins, each against numpy."""
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.array.array import Array, array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.buffer import Buffer
    from arrow_tpu_torch.table import Table
    codes, values = _codes_and_values(cu, "c_mktsegment")
    rows = np.flatnonzero(codes == values.index(SURFACE_SEGMENT))
    ck = _host_values(cu, "c_custkey")
    seg = Table.from_arrays([array(ck[rows]), array(ck[rows])],
                            ["c_custkey", "c_id"])
    left = od.select(["o_orderkey", "o_custkey"])
    ok, ock = _host_values(od, "o_orderkey"), _host_values(od, "o_custkey")
    runs = match_runs(JoinSide(ock, np.ones(len(ock), bool), "o_orderkey",
                               ok),
                      JoinSide(ck[rows], np.ones(len(rows), bool), "c_id",
                               ck[rows]))
    src = {"o_orderkey": ok, "o_custkey": ock, "c_custkey": ck[rows],
           "c_id": ck[rows]}
    results = {}
    for jt in JOIN_TYPES:
        coalesced = jt not in ("right semi", "right anti")
        out = _plan_path(paths, f"join {jt}", lambda: left.join(
            seg, "o_custkey", "c_custkey", join_type=jt, device=dev),
            peaks, facts)
        n = _check_table_join(jt, out, src, runs, coalesced)
        results[jt] = out
        log(f"    {jt}: {n} rows match the oracle")
    # the same inner join, its keys kept
    kept = left.join(seg, "o_custkey", "c_custkey", join_type="inner",
                     coalesce_keys=False, device=dev)
    _check_table_join("inner", kept, src, runs, False)
    log("    inner with its keys kept matches the oracle")
    inner = results["inner"]
    del results, kept
    # every column of both, over the first 1/ROOM_DEPTH of orders' rows
    m = odp.num_rows
    wide = _plan_path(paths, "join left outer all columns", lambda: odp.join(
        cu, "o_custkey", "c_custkey", device=dev), peaks, facts)
    _expect("3r wide join columns", wide.column_names == od.column_names + [
        n for n in cu.column_names if n != "c_custkey"])
    _expect("3r wide join rows", wide.num_rows == m)
    _expect_equal("3r wide join o_orderkey", _column(wide, "o_orderkey")[0],
                  ok[:m])
    at_cust = ock[:m] - 1
    for n in ("c_nationkey", "c_acctbal"):
        _expect_equal(f"3r wide join {n}", _np_bits(_column(wide, n)[0]),
                      _np_bits(_host_values(cu, n)[at_cust]))
    _same_strings_by_code("3r wide join c_mktsegment",
                          wide.column("c_mktsegment"), codes[at_cust],
                          values)
    log("    every column: the customers' columns match theirs")
    del wide
    # lineitem's four columns against orders' three
    lsel, osel = li.select(FULL_WIDTH_LINEITEM), od.select(FULL_WIDTH_ORDERS)
    full = _plan_path(paths, "join full width", lambda: lsel.join(
        osel, "l_orderkey", "o_orderkey", join_type="inner", device=dev),
        peaks, facts)
    lok = _host_values(li, "l_orderkey")
    _expect("3r full width rows", full.num_rows == li.num_rows)
    for n in FULL_WIDTH_LINEITEM:
        _expect_equal(f"3r full width {n}", _np_bits(_column(full, n)[0]),
                      _np_bits(_host_values(li, n)))
    for n in FULL_WIDTH_ORDERS[1:]:
        _expect_equal(f"3r full width {n}", _np_bits(_column(full, n)[0]),
                      _np_bits(_host_values(od, n)[lok - 1]))
    log("    the full width: every row matches lineitem's and its order's")
    del full
    # phase 3e's as-of join through Table.join_asof
    sc, sv = _codes_and_values(od, "o_orderstatus")
    fin = np.flatnonzero(sc == sv.index("F"))
    odate, price = _host_values(od, "o_orderdate"), \
        _host_values(od, "o_totalprice")
    finished = Table.from_arrays(
        [array(ock[fin]), Array(ArrayData(T.date32(), len(fin), [
            None, Buffer(odate[fin])])), array(price[fin])],
        ["o_custkey", "o_orderdate", "prev_totalprice"])
    lasof = od.select(["o_orderkey", "o_custkey", "o_orderdate"])
    asof = _plan_path(paths, "join_asof", lambda: lasof.join_asof(
        finished, "o_orderdate", "o_custkey", ASOF_TOLERANCE, device=dev),
        peaks, facts)
    match = asof_oracle(ock, odate, ock[fin], odate[fin], ASOF_TOLERANCE)
    log("    the as-of oracle made")
    pv, pvalid = _column(asof, "prev_totalprice")
    hit = match >= 0
    _expect_equal("3r join_asof o_orderkey", _column(asof, "o_orderkey")[0],
                  ok)
    _expect("3r join_asof matches", np.array_equal(pvalid, hit))
    _expect_equal("3r join_asof prev_totalprice", _np_bits(pv[hit]),
                  _np_bits(price[fin][match[hit]]))
    log("    the as-of join matches its oracle")
    # the datasets of the same Tables
    dl, dr = ds.InMemoryDataset(left), ds.InMemoryDataset(seg)
    dj = _plan_path(paths, "dataset join", lambda: dl.join(
        dr, "o_custkey", "c_custkey", join_type="inner", device=dev),
        peaks, facts)
    _expect("3r dataset join", table_digest(dj) == table_digest(inner))
    da = _plan_path(paths, "dataset join_asof", lambda: ds.InMemoryDataset(
        lasof).join_asof(ds.InMemoryDataset(finished), "o_orderdate",
                         "o_custkey", ASOF_TOLERANCE, device=dev),
        peaks, facts)
    _expect("3r dataset join_asof", table_digest(da) == table_digest(asof))
    log(f"  joins: the eight types over {len(rows)} {SURFACE_SEGMENT} "
        f"customers, every column, the full width, as-of "
        f"({int(hit.sum())} matched) and the datasets' joins match their "
        "oracles")


def _first_seen_order(key):
    """Small non-negative keys in order of first appearance, and each
    key's count."""
    counts = np.bincount(key)
    first = _first_seen(key, len(counts))
    return np.argsort(first, kind="stable")[:int((counts > 0).sum())], \
        counts


def _sliced(arr, n=FILE_SLICES):
    """An Array as a ChunkedArray of ``n`` slices (no copy)."""
    from arrow_tpu_torch.table import ChunkedArray
    step = -(-len(arr) // n)
    return ChunkedArray([arr.slice(o, min(step, len(arr) - o))
                         for o in range(0, len(arr), step)], arr.type)


def _surface_columns(li, paths, dev, facts):
    """The ChunkedArray methods on lineitem's 60M-row columns cut into
    FILE_SLICES chunks, each against numpy."""
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.array.array import Array, array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.buffer import Buffer
    n = li.num_rows
    q = _host_values(li, "l_quantity")
    qi = q.astype(np.int64)
    ep = _host_values(li, "l_extendedprice")
    lok = _host_values(li, "l_orderkey")
    ln = _host_values(li, "l_linenumber").astype(np.int64)
    disc = _host_values(li, "l_discount")
    cq, cep, cok, cln = (_sliced(li.column(c).combine()) for c in (
        "l_quantity", "l_extendedprice", "l_orderkey", "l_linenumber"))
    valid = q >= SURFACE_NULL_QUANTITY
    cdisc = _sliced(Array(ArrayData(T.float64(), n, [
        Buffer(np.packbits(valid, bitorder="little")), Buffer(disc)])))
    mask = q > HOST_EAGER_QUANTITY
    log("    the columns cut into chunks")
    got = paths.run("chunked filter", lambda: cep.filter(array(mask),
                                                         device=dev))
    _expect_equal("3r filter", _np_bits(got.combine().data.values()),
                  _np_bits(ep[mask]))
    idx = np.random.default_rng(HOST_TIER_SEED).integers(0, n, SURFACE_TAKE)
    got = paths.run("chunked take", lambda: cok.take(array(idx), device=dev))
    _expect_equal("3r take", got.combine().data.values(), lok[idx])
    got = paths.run("chunked drop_null", lambda: cdisc.drop_null(device=dev))
    _expect_equal("3r drop_null", _np_bits(got.combine().data.values()),
                  _np_bits(disc[valid]))
    got = paths.run("chunked fill_null", lambda: cdisc.fill_null(
        -1.0, device=dev))
    _expect_equal("3r fill_null", _np_bits(got.combine().data.values()),
                  _np_bits(np.where(valid, disc, -1.0)))
    got = paths.run("chunked is_null", lambda: cdisc.is_null(device=dev))
    _expect_equal("3r is_null", got.combine().data.values(), ~valid)
    order, counts = _first_seen_order(qi)
    got = paths.run("chunked sort", lambda: cq.sort(device=dev))
    _expect_equal("3r sort", got.combine().data.values(), np.repeat(
        np.arange(len(counts), dtype=np.float64), counts))
    got = paths.run("chunked unique", lambda: cq.unique(device=dev))
    _expect_equal("3r unique", got.data.values(), order.astype(np.float64))
    got = paths.run("chunked value_counts", lambda: cq.value_counts(
        device=dev))
    _expect_equal("3r value_counts values",
                  got.data.children[0].values(), order.astype(np.float64))
    _expect_equal("3r value_counts counts", got.data.children[1].values(),
                  counts[order])
    lorder, lcounts = _first_seen_order(ln)
    rank = np.zeros(len(lcounts), dtype=np.int64)
    rank[lorder] = np.arange(len(lorder))
    got = paths.run("chunked dictionary_encode",
                    lambda: cln.dictionary_encode(device=dev)).combine()
    _expect_equal("3r dictionary_encode codes",
                  got.data.values().astype(np.int64), rank[ln])
    _expect_equal("3r dictionary_encode values",
                  got.data.dictionary.values().astype(np.int64), lorder)
    got = paths.run("chunked cast", lambda: cq.cast(T.int64(), device=dev))
    _expect_equal("3r cast", got.combine().data.values(), qi)
    v = int(lok[n // 2])
    got = paths.run("chunked index", lambda: (
        cok.index(v, device=dev), cok.index(v, n // 2 + 1, device=dev)))
    hits = np.flatnonzero(lok == v)
    later = hits[hits > n // 2]
    _expect("3r index", got == (int(hits[0]), int(later[0]) if len(later)
                                else -1), f"({got})")
    facts["chunked columns GB"] = sum(c.nbytes for c in (cq, cep, cok, cln,
                                                          cdisc)) / 1e9
    log(f"  ChunkedArray methods over {n} rows in {FILE_SLICES} chunks "
        "match numpy")


def _surface_host(cu, paths, facts):
    """The host-only methods on customer: column edits, from_pylist and
    struct round trips over its first SURFACE_PY_ROWS rows, validate (a
    broken copy refused), to_string and concat_tables."""
    from arrow_tpu_torch import api, pretty
    from arrow_tpu_torch.array.array import Array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.array.validate import ValidationError
    from arrow_tpu_torch.buffer import Buffer
    from arrow_tpu_torch.table import Table
    from arrow_tpu_torch.types import field, int64
    key = cu.column("c_custkey")

    def edits():
        return (cu.add_column(1, "c_key2", key)
                .set_column(0, field("c_key", int64(), False), key)
                .remove_column(2).drop_columns(["c_comment"])
                .append_column("c_segment", cu.column("c_mktsegment")))
    t = paths.run("column edits", edits)
    want = ["c_key", "c_key2"] + [n for n in cu.column_names[2:]
                                  if n != "c_comment"] + ["c_segment"]
    _expect("3r column edits", t.column_names == want and t.column("c_key")
            is key and t.column("c_segment") is cu.column("c_mktsegment"),
            f"({t.column_names})")
    head = cu.slice(0, SURFACE_PY_ROWS)
    want = head.to_pydict()
    back = paths.run("from_pylist", lambda: Table.from_pylist(
        head.to_pylist()))
    _expect("3r from_pylist", back.to_pydict() == want)
    back = paths.run("struct round trip", lambda: Table.from_struct_array(
        head.to_struct_array()))
    _expect("3r struct round trip", back.to_pydict() == want
            and back.schema.names == head.schema.names)
    paths.run("validate full", lambda: cu.validate(full=True))
    seg = cu.column("c_mktsegment").combine().data
    bad = seg.values().copy()
    bad[len(bad) // 2] = seg.dictionary.length
    broken = Array(ArrayData(seg.type, seg.length, [None, Buffer(bad)],
                             dictionary=seg.dictionary))
    try:
        broken.validate(full=True)
        raise AssertionError("3r validate: an index out of range passed")
    except ValidationError as exc:
        _expect("3r validate refuses", "out of range" in str(exc))
    text = paths.run("to_string", lambda: (
        cu.to_string(), pretty.table_to_string(cu.slice(0, 1000), 5)))
    _expect("3r to_string", text[0] == f"<Table rows={cu.num_rows} "
            f"cols={cu.column_names}>" and len(text[1].splitlines()) == 8)
    two = paths.run("concat_tables", lambda: api.concat_tables([cu, cu]))
    _expect("3r concat_tables", two.num_rows == 2 * cu.num_rows and all(
        c.num_chunks == 2 * o.num_chunks for c, o in zip(two.columns,
                                                         cu.columns)))
    wide = api.concat_tables([cu.select(["c_custkey"]), cu.select(
        ["c_custkey", "c_acctbal"]).slice(0, 10)], promote_options="default")
    _expect("3r concat_tables promoted", wide.column("c_acctbal").null_count
            == cu.num_rows and wide.num_rows == cu.num_rows + 10)
    log(f"  host methods on customer ({cu.num_rows} rows, Python rows over "
        f"{SURFACE_PY_ROWS}) checked")


def _battery(fs, base, kind):
    """One file through a client: written, listed, read, moved,
    deleted."""
    from arrow_tpu_torch.fs import FileSelector
    body = np.random.default_rng(1).integers(0, 256, SURFACE_BATTERY,
                                             dtype=np.uint8).tobytes()
    fs.create_dir(base)
    with fs.open_output_stream(f"{base}/dir/a.bin") as f:
        f.write(body)
    info = fs.get_file_info(f"{base}/dir/a.bin")
    with fs.open_input_file(f"{base}/dir/a.bin") as f:
        back = f.read()
    listed = fs.get_file_info(FileSelector(base, recursive=True))
    fs.move(f"{base}/dir/a.bin", f"{base}/dir/b.bin")
    gone = fs.get_file_info(f"{base}/dir/a.bin").type
    fs.delete_file(f"{base}/dir/b.bin")
    _expect(f"3r {kind} file round trip", info.size == len(body)
            and back == body and gone == "NotFound"
            and any(i.path.endswith("dir/a.bin") for i in listed)
            and fs.get_file_info(f"{base}/dir/b.bin").type == "NotFound")


def _stored_bytes(em):
    state = em.state
    if hasattr(state, "files"):
        return sum(len(v) for v in state.files.values())
    tops = state.containers if hasattr(state, "containers") \
        else state.buckets
    return sum(len(v) for objs in tops.values() for v in objs.values())


def _surface_cloud(od, cu, tmp, paths, dev, facts):
    """The first 1/ROOM_DEPTH of orders' rows (every column, its
    dictionaries as plain strings as 3q writes them) hive-partitioned by
    status as Parquet into the S3 emulator, one
    status's orders by priority over the S3 dataset against the Table's
    plan; customer partitioned by segment as IPC through the GCS, Azure
    and WebHDFS emulators, each fragment read back (host Tables) bit for
    bit the same fragment of the dataset on the local disk; one file round
    trip through each client."""
    import base64
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    from cloud_emulators import AzureEmulator, GcsEmulator, WebHdfsEmulator
    from s3_emulator import S3Emulator
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch import fs as afs
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                       ScanNodeOptions,
                                       TableSourceNodeOptions, field)
    from arrow_tpu_torch.types import Field, Schema
    plain = plain_orders(od)
    hive = ds.HivePartitioning(Schema([Field("o_orderstatus", T.string())]))
    log("    orders' dictionaries decoded to plain strings")
    with S3Emulator() as em:
        s3 = afs.S3FileSystem(access_key="chip", secret_key="smoke",
                              endpoint_override=em.endpoint,
                              allow_bucket_creation=True)
        s3.create_dir("lake")
        paths.run("s3 write_dataset", lambda: ds.write_dataset(
            plain, "lake/orders", partitioning=["o_orderstatus"],
            partitioning_flavor="hive", filesystem=s3))
        facts["s3 GB"] = _stored_bytes(em) / 1e9
        facts["s3 write GB/s"] = facts["s3 GB"] / \
            paths.walls["3r s3 write_dataset"]
        data = ds.dataset("lake/orders", partitioning=hive, filesystem=s3)
        cond = field("o_orderstatus") == HIVE_STATUS
        _expect("3r s3 pruning", len(list(data.get_fragments(cond))) == 1)
        got = paths.run("s3 orders", lambda: hive_orders_plan(Declaration(
            "scan", ScanNodeOptions(data, HIVE_COLUMNS, cond))).to_table(
                device=dev))
        want = paths.run("s3 orders (table)", lambda: hive_orders_plan(
            Declaration.from_sequence([
                Declaration("table_source", TableSourceNodeOptions(
                    od.select(["o_orderstatus"] + HIVE_COLUMNS))),
                Declaration("filter", FilterNodeOptions(cond))])).to_table(
                    device=dev))
        _same_result("3r s3 orders", got, want)
        g, w = got.to_pydict(), want.to_pydict()
        _expect("3r s3 orders exact", all(g[k] == w[k] for k in (
            "o_orderpriority", "orders", "lowest", "highest", "customers")))
        paths.run("s3 file round trip", lambda: _battery(s3, "bkt", "s3"))
    log(f"  S3: orders as hive Parquet, {facts['s3 GB']:.3f} GB at "
        f"{facts['s3 write GB/s']:.3f} GB/s; {got.num_rows} priorities "
        "equal to the Table's plan")
    local = os.path.join(tmp, "customer_ipc")
    ds.write_dataset(cu, local, format="ipc", partitioning=["c_mktsegment"],
                     partitioning_flavor="hive")
    seg_hive = ds.HivePartitioning(Schema([Field("c_mktsegment",
                                                 T.string())]))
    twin = [f.to_table() for f in ds.dataset(
        local, format="ipc", partitioning=seg_hive).fragments]
    _expect("3r customer twin", np.array_equal(np.sort(np.concatenate(
        [_host_values(t, "c_custkey") for t in twin])),
        np.sort(_host_values(cu, "c_custkey"))))
    twin = [table_digest(t) for t in twin]
    log("    customer's local twin written and read")
    account_key = base64.b64encode(np.random.default_rng(0).integers(
        0, 256, 32, dtype=np.uint8).tobytes()).decode()
    clients = (
        ("gcs", GcsEmulator, lambda em: afs.GcsFileSystem(
            access_token="chip", endpoint_override=em.endpoint,
            project_id="smoke", scheme="http"), "bkt"),
        ("azure", AzureEmulator, lambda em: afs.AzureFileSystem(
            "chip", account_key=account_key,
            blob_storage_authority=em.endpoint, scheme="http"), "ctr"),
        ("hdfs", WebHdfsEmulator, lambda em: afs.HadoopFileSystem(
            *em.host_port, user="chip"), "/data"))
    for kind, emulator, make, base in clients:
        with emulator() as em:
            fs = make(em)
            fs.create_dir(base)
            root = f"{base}/customer"
            paths.run(f"{kind} write_dataset", lambda: ds.write_dataset(
                cu, root, format="ipc", partitioning=["c_mktsegment"],
                partitioning_flavor="hive", filesystem=fs))
            facts[f"{kind} GB"] = _stored_bytes(em) / 1e9
            back = paths.run(f"{kind} dataset", lambda: [
                f.to_table() for f in ds.dataset(
                    root, format="ipc", partitioning=seg_hive,
                    filesystem=fs).fragments])
            _expect(f"3r {kind} dataset", [table_digest(t) for t in back]
                    == twin)
            facts[f"{kind} write GB/s"] = facts[f"{kind} GB"] / \
                paths.walls[f"3r {kind} write_dataset"]
            facts[f"{kind} read GB/s"] = facts[f"{kind} GB"] / \
                paths.walls[f"3r {kind} dataset"]
            paths.run(f"{kind} file round trip", lambda: _battery(
                fs, f"{base}/files", kind))
        log(f"  {kind}: customer as hive IPC, {facts[f'{kind} GB']:.3f} GB "
            "read back equal to its local twin; a file round trip")
    shutil.rmtree(local)


def phase_host_surface(host, device="cuda"):
    """Phase 3r: the host containers' methods, the top-level API and the
    cloud file systems over phase 3l's host Tables. Table.join of orders
    with one segment's customers for all eight join types against
    ``join_oracle`` (the coalesced keys taken into account), a left outer
    join of every column (the first 1/ROOM_DEPTH of orders' rows),
    lineitem's four columns joined to orders' three
    (60M probe rows, the bloom), phase 3e's as-of join through
    ``Table.join_asof`` against ``asof_oracle``, and the datasets' joins
    equal to the Tables'; the ChunkedArray methods over lineitem's 60M-row
    columns in FILE_SLICES chunks against numpy; the host-only methods on
    customer; the first 1/ROOM_DEPTH of orders' rows through the S3 client
    and customer through the GCS, Azure and WebHDFS clients, each to its
    emulator over loopback. Each
    path's launches are set to 0 just before and read just after (on the
    card) and held to HOST_SURFACE_LAUNCHES; the plan and download walls,
    the peaks and the emulators' bytes and rates logged. Returns (launches
    by path, facts)."""
    import tempfile
    dev = torch.device(device)
    log(f"== phase 3r: the host surface and the cloud file systems on "
        f"{device}")
    t0 = time.perf_counter()
    li, od, cu = host["lineitem"], host["orders"], host["customer"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_surface_")
    try:
        need = 2 * _table_bytes(cu) + (1 << 26)
        free = _free_bytes(tmp)
        log(f"  {tmp}: {free / 1e9:.3f} GB free, the phase writes at most "
            f"{need / 1e9:.3f} GB")
        if free < need:
            raise RuntimeError(f"{tmp} lacks {(need - free) / 1e9:.3f} GB "
                               "for phase 3r's files")
        paths = _Paths(dev, "3r", HOST_SURFACE_LAUNCHES)
        peaks, facts = {}, {}
        _surface_joins(od, host.first("orders"), cu, li, paths, dev, peaks,
                       facts)
        _surface_columns(li, paths, dev, facts)
        _surface_host(cu, paths, facts)
        _surface_cloud(host.first("orders"), cu, tmp, paths, dev, facts)
        paths.check_launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _PLAIN.clear()
        host.drop_first()
    log("phase 3r walls (s): " + ", ".join(
        f"{k[3:]} {v:.3f}" for k, v in paths.walls.items()))
    log("phase 3r facts: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in facts.items()))
    if peaks:
        log("phase 3r peak memory above the tables (GiB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in peaks.items()))
    log(f"phase 3r: {time.perf_counter() - t0:.1f} s (paths "
        f"{sum(paths.walls.values()):.1f} s)")
    return paths.launches, {"walls": paths.walls, "peaks": peaks,
                            "facts": facts}


# --- phase 3s: interop and extension types -----------------------------------

# the columns Q1 and Q3 read of lineitem, orders and customer
INTEROP_LINEITEM = ["l_orderkey", "l_quantity", "l_extendedprice",
                    "l_discount", "l_tax", "l_returnflag", "l_linestatus",
                    "l_shipdate"]
INTEROP_ORDERS = ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"]
INTEROP_CUSTOMER = ["c_custkey", "c_mktsegment"]
INTEROP_TENSOR = ["l_quantity", "l_extendedprice", "l_discount", "l_tax"]
INTEROP_NULL_EVERY = 7        # the nullable columns' nulls: every 7th row
_Q1_LAUNCHES = {**_NO_LAUNCH, "grouped_sum": 7}
# launches of phase 3s's paths, reckoned from the code before the first run
# (each +1 probe, from self_check): Q1 over the Table imported through the
# C stream is 3l's Q1 (seven float sums, K1); Q3 over the interchange's
# orders and customer and the imported lineitem, and Q3 over the orders
# with extension columns read back from an IPC file, are 3l's Q3 (seven
# compactions, K2, and four hash words, K4: the same row counts, so the
# same bloom and compaction choices); every other path (the C data
# interface, dlpack, tensors, the IPC files and streams, the views and
# unions, pandas, Device) is host work and launches none
INTEROP_LAUNCHES = {
    "3s Q1 from the C stream": _Q1_LAUNCHES,
    "3s Q3 from the interchange": _joins(7, 4),
    "3s Q3 over the extension Table": _joins(7, 4),
}


def _nullable(arr, every=INTEROP_NULL_EVERY):
    """``arr`` (no nulls) with every ``every``-th row null, its buffers
    shared."""
    from arrow_tpu_torch.array.array import Array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.buffer import Buffer
    from arrow_tpu_torch.utils import bits
    d = arr.data
    valid = np.ones(d.length, dtype=bool)
    valid[::every] = False
    return Array(ArrayData(d.type, d.length, [Buffer(bits.pack_bits(valid))]
                           + d.buffers[1:], d.children, offset=d.offset,
                           dictionary=d.dictionary))


def dense_union_of(ints, strings):
    """A dense union of an int64 and a string column, alternating by row
    (codes 0 and 1: even rows the ints' even rows, odd rows the strings'
    odd rows), built from its buffers."""
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.array.array import Array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.buffer import Buffer
    n = len(ints)
    type_ids = (np.arange(n) % 2).astype(np.int8)
    offsets = (np.arange(n) // 2).astype(np.int32)
    d = strings.data
    offs = d.offsets().astype(np.int64)
    starts, ends = offs[1:-1:2], offs[2::2]
    lens = ends - starts
    new_offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=new_offs[1:])
    at = np.repeat(starts - new_offs[:-1], lens) + np.arange(new_offs[-1])
    kids = [Array(ArrayData(ints.type, (n + 1) // 2, [
                None, Buffer(ints.data.values()[0::2].copy())],
                null_count=0)),
            Array(ArrayData(strings.type, len(lens), [
                None, Buffer(new_offs.astype(np.int32)),
                Buffer(d.data_bytes()[at])], null_count=0))]
    ut = T.dense_union([T.field("c_custkey", kids[0].type),
                        T.field("c_mktsegment", kids[1].type)], [0, 1])
    return Array.from_buffers(ut, n, [type_ids, offsets], children=kids)


def uuid_rows(keys):
    """16 bytes a key, made from it by numpy: the key (little-endian
    int64) and a mix of it, as the uuid column's storage."""
    k = keys.astype(np.int64)
    out = np.empty((len(k), 2), dtype=np.uint64)
    out[:, 0] = k.view(np.uint64)
    out[:, 1] = _mix_np(k.view(np.uint64))
    return out.view(np.uint8).reshape(-1, 16)


def _interop_stream(li, digests, paths, dev, facts, peaks):
    """Lineitem's eight Q1/Q3 columns through the C stream and back, its
    digest the source's and the export state empty after; then Q1 over
    the imported Table."""
    from arrow_tpu_torch import RecordBatchReader, c_data
    from arrow_tpu_torch.io.tpch_queries import q1_plan
    li8 = li.select(INTEROP_LINEITEM)
    want = table_digest(li8)

    def run():
        return RecordBatchReader.from_stream(
            li8.__arrow_c_stream__()).read_all()
    got = paths.run("C stream lineitem", run)
    nbytes = _table_bytes(li8)
    facts["C stream GB/s"] = nbytes / paths.walls["3s C stream lineitem"] \
        / 1e9
    _expect("3s C stream digest", table_digest(got) == want)
    _expect("3s C stream export state", not any(
        c_data.export_state().values()), str(c_data.export_state()))
    result = _plan_path(paths, "Q1 from the C stream",
                        lambda: q1_plan(got).to_table(device=dev),
                        peaks, facts)
    _expect("3s Q1 from the C stream", table_digest(result) ==
            digests["Q1"])
    return got


def _interop_arrays(li, cu, paths):
    """``__arrow_c_array__`` -> ``import_array`` of l_extendedprice, and
    of a slice of a nullable string column (c_phone with every 7th row
    null): offsets, validity and values carried."""
    from arrow_tpu_torch import c_data
    price = li.column("l_extendedprice").combine()
    phone = _nullable(cu.column("c_phone").combine())
    part = phone.slice(1000, len(phone) // 3)

    def run():
        out = []
        for a in (price, part):
            schema, array = a.__arrow_c_array__()
            out.append(c_data.import_array(array, schema))
        return out
    got_price, got_part = paths.run("C array", run)
    _same_data("3s C array l_extendedprice", got_price.data, price.data)
    _expect("3s C array c_phone slice",
            got_part.offset == part.offset and got_part.null_count ==
            part.null_count and got_part.to_pylist() == part.to_pylist())
    _expect("3s C array export state", not any(
        c_data.export_state().values()), str(c_data.export_state()))


def _interop_interchange(od, cu, li8, digests, paths, dev, facts, peaks):
    """Orders and customer, projected to Q3's columns, through the
    interchange protocol; then Q3 over them and the C stream's
    lineitem."""
    from arrow_tpu_torch import interchange
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.io.tpch_queries import q3_plan
    od4, cu2 = od.select(INTEROP_ORDERS), cu.select(INTEROP_CUSTOMER)

    def run():
        return [interchange.from_dataframe(t.__dataframe__())
                for t in (od4, cu2)]
    got_od, got_cu = paths.run("interchange orders and customer", run)
    for name, got, src in (("orders", got_od, od4),
                           ("customer", got_cu, cu2)):
        for f in src.schema:
            g = got.column(f.name).combine()
            w = src.column(f.name).combine()
            if f.type.id == T.TypeId.DICTIONARY:  # the values, any order
                _same_data(f"3s interchange {name}.{f.name}",
                           _decoded(got.column(f.name)).data,
                           _decoded(src.column(f.name)).data)
            else:
                _same_data(f"3s interchange {name}.{f.name}", g.data,
                           w.data)
    result = _plan_path(paths, "Q3 from the interchange",
                        lambda: q3_plan(got_cu, got_od,
                                        li8).to_table(device=dev),
                        peaks, facts)
    _expect("3s Q3 from the interchange", table_digest(result) ==
            digests["Q3"])


def _interop_dlpack(li, paths):
    """numpy and torch take l_quantity and l_extendedprice through dlpack
    at the Array's own address; a column with nulls refuses."""
    cols = [li.column(n).combine() for n in ("l_quantity",
                                             "l_extendedprice")]

    def run():
        return [(np.from_dlpack(a), torch.from_dlpack(a),
                 a.__dlpack_device__()) for a in cols]
    for a, (n, t, where) in zip(cols, paths.run("dlpack", run)):
        addr = a.data.buffers[1].address + a.offset * 8
        _expect("3s dlpack address", n.ctypes.data == addr ==
                t.data_ptr() and len(n) == len(a) == t.numel(),
                f"({n.ctypes.data}, {t.data_ptr()}, {addr})")
        _expect("3s dlpack device", tuple(where) == (1, 0), str(where))
    try:
        np.from_dlpack(_nullable(cols[0]))
    except ValueError:
        pass
    else:
        raise AssertionError("3s dlpack of a column with nulls did not "
                             "raise")


def _interop_tensors(li, ps, tmp, paths, facts):
    """Lineitem's four float columns as a Tensor written to a file and
    read back from its map; partsupp's (partkey, suppkey) -> availqty as
    CSR, COO and CSF tensors, written and read back."""
    from arrow_tpu_torch import ipc, memory_map
    from arrow_tpu_torch.tensor import (SparseCOOTensor, SparseCSFTensor,
                                        SparseCSRMatrix)
    li4 = li.select(INTEROP_TENSOR)
    path = os.path.join(tmp, "lineitem.tensor")

    def dense():
        ten = li4.to_tensor()
        with open(path, "wb") as f:
            written = ipc.write_tensor(ten, f)
        back = ipc.read_tensor(memory_map(path))
        return ten, written, back
    ten, written, back = paths.run("tensor lineitem", dense)
    facts["tensor GB"] = ten.data.nbytes / 1e9
    _expect("3s tensor size", written == os.path.getsize(path) ==
            ipc.get_tensor_size(ten))
    _expect("3s tensor read back", back.shape == ten.shape and
            np.array_equal(back.data, ten.data))
    for j, name in enumerate(INTEROP_TENSOR):
        _expect_equal(f"3s tensor column {name}", ten.data[:, j],
                      li4.column(name).combine().data.values())
    del ten, back
    os.remove(path)

    key = ps.column("ps_partkey").combine().data.values()
    supp = ps.column("ps_suppkey").combine().data.values()
    qty = ps.column("ps_availqty").combine().data.values()
    shape = (int(key.max()) + 1, int(supp.max()) + 1)

    def sparse():
        # the coordinates sorted, a pair drawn twice (the generator draws
        # each part's suppliers at random) summed into one non-zero
        flat = key * shape[1] + supp
        order = np.argsort(flat)
        flat = flat[order]
        first = np.flatnonzero(np.concatenate([[True],
                                               flat[1:] != flat[:-1]]))
        coords = np.stack([flat[first] // shape[1], flat[first] % shape[1]],
                          axis=1)
        data = np.add.reduceat(qty[order], first)
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.cumsum(np.bincount(coords[:, 0], minlength=shape[0]),
                  out=indptr[1:])
        made = [SparseCSRMatrix(data, indptr, coords[:, 1], shape),
                SparseCOOTensor(data, coords, shape),
                SparseCSFTensor.from_coords(data, coords, shape)]
        out = []
        for st in made:
            buf = io.BytesIO()
            ipc.write_sparse_tensor(st, buf)
            out.append((st, ipc.read_sparse_tensor(buf.getvalue()),
                        buf.tell()))
        return coords, out
    coords, out = paths.run("sparse partsupp", sparse)
    facts["sparse non-zeros"] = len(coords)
    for st, got, nbytes in out:
        name = type(st).__name__
        _expect(f"3s {name} read back", type(got) is type(st) and
                tuple(got.shape) == shape and
                np.array_equal(got.data, st.data))
        parts = {"SparseCSRMatrix": ("indptr", "indices"),
                 "SparseCOOTensor": ("coords",)}.get(name, ())
        for attr in parts:
            _expect_equal(f"3s {name}.{attr}", getattr(got, attr),
                          getattr(st, attr))
        if name == "SparseCSFTensor":
            _expect_equal("3s SparseCSFTensor coords", got.coords(), coords)
        facts[f"{name} MB"] = nbytes / 1e6


def _interop_extension(od, cu, li8, digests, tmp, paths, dev, facts,
                       peaks):
    """Orders (Q3's columns) with a uuid column from o_orderkey and a
    fixed_shape_tensor(float64, [2]) of (o_totalprice, o_shippriority),
    written as an IPC file and read back registered (the types rebuilt)
    and unregistered (their storage); then Q3 over the read-back Table."""
    from arrow_tpu_torch import extension as X
    from arrow_tpu_torch import ipc, memory_map
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.array.array import Array
    from arrow_tpu_torch.array.data import ArrayData
    from arrow_tpu_torch.buffer import Buffer
    from arrow_tpu_torch.io.tpch_queries import q3_plan
    from arrow_tpu_torch.table import Table
    n = od.num_rows
    keys = od.column("o_orderkey").combine().data.values()
    pair = np.stack([od.column("o_totalprice").combine().data.values(),
                     od.column("o_shippriority").combine().data.values()
                     .astype(np.float64)], axis=1).reshape(-1)
    fst = X.fixed_shape_tensor(T.float64(), [2])
    uuid = Array(ArrayData(X.uuid(), n, [None, Buffer(uuid_rows(keys))],
                           null_count=0))
    tensor = Array(ArrayData(fst, n, [None], [ArrayData(
        T.float64(), 2 * n, [None, Buffer(pair)], null_count=0)],
        null_count=0))
    ext = od.select(INTEROP_ORDERS).append_column(
        T.field("o_uuid", X.uuid()), uuid).append_column(
        T.field("o_tensor", fst), tensor)
    path = os.path.join(tmp, "orders_ext.arrow")

    def run():
        with open(path, "wb") as f, ipc.new_file(f, ext.schema) as w:
            w.write_table(ext)
        registered = ipc.open_file(memory_map(path)).read_all()
        for name in (X.UuidType.EXTENSION_NAME,
                     X.FixedShapeTensorType.EXTENSION_NAME):
            X.unregister_extension_type(name)
        try:
            storage = ipc.open_file(memory_map(path)).read_all()
        finally:
            X.register_extension_type(X.UuidType)
            X.register_extension_type(X.FixedShapeTensorType)
        return registered, storage
    registered, storage = paths.run("extension IPC file", run)
    facts["extension file GB"] = os.path.getsize(path) / 1e9
    _expect("3s extension types rebuilt", registered.schema.field(
        "o_uuid").type == X.uuid() and registered.schema.field(
        "o_tensor").type == fst)
    _expect("3s extension digest", table_digest(registered) ==
            table_digest(ext))
    as_storage = Table(T.schema([T.field(f.name, getattr(
        f.type, "storage_type", f.type)) for f in ext.schema]), [
        c if f.type.id != T.TypeId.EXTENSION else
        type(c)([Array(ArrayData(f.type.storage_type, a.data.length,
                                 a.data.buffers, a.data.children,
                                 offset=a.data.offset))
                 for a in c.chunks]) for f, c in zip(ext.schema,
                                                    ext.columns)])
    _expect("3s extension storage", [f.type for f in storage.schema] ==
            [f.type for f in as_storage.schema] and
            table_digest(storage) == table_digest(as_storage))
    result = _plan_path(paths, "Q3 over the extension Table",
                        lambda: q3_plan(cu, registered,
                                        li8).to_table(device=dev),
                        peaks, facts)
    _expect("3s Q3 over the extension Table", table_digest(result) ==
            digests["Q3"])
    del registered, storage
    os.remove(path)


def _interop_views_unions(cu, paths):
    """Customer's c_comment cast to string_view and a dense union of
    (c_custkey | c_mktsegment), each through the C array round trip and
    an IPC stream, its rows the source's."""
    from arrow_tpu_torch import c_data, ipc
    from arrow_tpu_torch import types as T
    from arrow_tpu_torch.table import Table
    comment = _decoded(cu.column("c_comment"))
    ints = cu.column("c_custkey").combine()
    segment = _decoded(cu.column("c_mktsegment"))
    want_comment = comment.to_pylist()
    ki, ks = ints.to_pylist(), segment.to_pylist()
    want_union = [ki[i] if i % 2 == 0 else ks[i] for i in range(len(ki))]

    def run():
        sv = comment.cast(T.string_view())
        du = dense_union_of(ints, segment)
        out = {"made": (sv, du)}
        out["C array"] = [c_data.import_array(*reversed(a.__arrow_c_array__()))
                          for a in (sv, du)]
        t = Table.from_arrays([sv, du], ["c_comment", "c_union"])
        back = ipc.deserialize_table(ipc.serialize_table(t))
        out["IPC stream"] = [back.column(0).combine(),
                             back.column(1).combine()]
        return out
    out = paths.run("views and unions", run)
    sv, du = out["made"]
    _expect("3s string_view", sv.type == T.string_view() and
            sv.to_pylist() == want_comment)
    _expect("3s dense union", du.type.mode == "dense" and
            du.to_pylist() == want_union)
    made = table_digest(Table.from_arrays([sv, du], ["v", "u"]))
    for how in ("C array", "IPC stream"):
        _expect(f"3s views and unions ({how})", table_digest(
            Table.from_arrays(out[how], ["v", "u"])) == made)
    sv.validate(full=True)
    du.validate(full=True)
    _expect("3s views export state", not any(
        c_data.export_state().values()), str(c_data.export_state()))


def _interop_pandas_device(cu, paths, facts):
    """``Table.to_pandas`` raises ImportError where pandas is absent, else
    customer's rows make a round trip: each column buffer by buffer (a
    dictionary, which comes back as plain strings, by its values); the
    card's Device and a host Buffer's."""
    from arrow_tpu_torch import Buffer, Device, DeviceAllocationType, Table
    from arrow_tpu_torch import types as T

    def run():
        try:
            import pandas  # noqa: F401
        except ImportError:
            try:
                cu.to_pandas()
            except ImportError:
                return "absent"
            raise AssertionError("3s to_pandas without pandas did not raise")
        back = Table.from_pandas(cu.to_pandas())
        _expect("3s pandas names", back.column_names == cu.column_names)
        for f in cu.schema:
            want = cu.column(f.name)
            _same_data(f"3s pandas {f.name}",
                       back.column(f.name).combine().data,
                       (_decoded(want) if f.type.id == T.TypeId.DICTIONARY
                        else want.combine()).data)
        return "round trip"
    facts["pandas"] = paths.run("pandas", run)
    card = Device("cuda:0" if paths.cuda else "cpu")
    _expect("3s Device", (card.type_name, card.device_id, card.device_type)
            == (("cuda", 0, DeviceAllocationType.CUDA) if paths.cuda else
                ("cpu", 0, DeviceAllocationType.CPU)), repr(card))
    buf = Buffer(b"abc")
    _expect("3s Buffer.device", buf.device.is_cpu and buf.device_type ==
            DeviceAllocationType.CPU and buf.memory_manager.is_cpu)


def phase_interop(host, device="cuda"):
    """Phase 3s: interop and extension types over phase 3l's host Tables
    (its Q1 and Q3 digests in ``host.digests``). Lineitem's eight Q1/Q3
    columns through the C stream, then Q1 over the imported Table;
    l_extendedprice and a nullable string slice through the C array;
    orders and customer through the interchange protocol, then Q3 over
    them and the imported lineitem; dlpack to numpy and torch; a Tensor
    of lineitem's four floats and partsupp's sparse tensors through their
    IPC messages; orders with uuid and fixed_shape_tensor columns through
    an IPC file, registered and not, and Q3 over it; customer's comments
    as string_view and a dense union through the C array and IPC; pandas
    and Device. Each path's launches are set to 0 just before and read
    just after (on the card) and held to INTEROP_LAUNCHES; every result
    is held exactly. Returns (launches by path, facts)."""
    import tempfile
    dev = torch.device(device)
    log(f"== phase 3s: interop and extension types on {device}")
    t0 = time.perf_counter()
    li, od, cu, ps = (host[n] for n in ("lineitem", "orders", "customer",
                                        "partsupp"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_interop_")
    paths = _Paths(dev, "3s", INTEROP_LAUNCHES)
    peaks, facts = {}, {}
    try:
        need = 8 * li.num_rows * len(INTEROP_TENSOR) + 2 * _table_bytes(
            od.select(INTEROP_ORDERS)) + (1 << 26)
        free = _free_bytes(tmp)
        log(f"  {tmp}: {free / 1e9:.3f} GB free, the phase writes at most "
            f"{need / 1e9:.3f} GB")
        if free < need:
            raise RuntimeError(f"{tmp} lacks {(need - free) / 1e9:.3f} GB "
                               "for phase 3s's files")
        li8 = _interop_stream(li, host.digests, paths, dev, facts, peaks)
        _interop_arrays(li, cu, paths)
        _interop_interchange(od, cu, li8, host.digests, paths, dev, facts,
                             peaks)
        _interop_dlpack(li, paths)
        _interop_tensors(li, ps, tmp, paths, facts)
        _interop_extension(od, cu, li8, host.digests, tmp, paths, dev,
                           facts, peaks)
        _interop_views_unions(cu, paths)
        _interop_pandas_device(host.first("customer"), paths, facts)
        paths.check_launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("phase 3s walls (s): " + ", ".join(
        f"{k[3:]} {v:.3f}" for k, v in paths.walls.items()))
    log("phase 3s facts: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in facts.items()))
    if peaks:
        log("phase 3s peak memory above the tables (GiB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in peaks.items()))
    log(f"phase 3s: {time.perf_counter() - t0:.1f} s (paths "
        f"{sum(paths.walls.values()):.1f} s)")
    return paths.launches, {"walls": paths.walls, "peaks": peaks,
                            "facts": facts}


# --- phase 3t: Arrow Flight, Flight SQL, DB-API and ODBC ----------------------

FLIGHT_TIMEOUT_S = 600        # every Flight client call's deadline in 3t
FLIGHT_CLIENTS = 4            # the concurrent Flight SQL clients
FLIGHT_USER = ("flight", "smoke")   # the basic-auth user and password
EXCHANGE_COLUMNS = ["o_orderkey", "o_custkey", "o_totalprice", "o_orderdate"]
EXCHANGE_PRICE = 400_000.0    # the exchange's filter keeps orders above it
Q6_PARAMETERS = (0.05, 0.07, 24)   # Q6's discount bounds and quantity
Q6_OTHER_PARAMETERS = (0.02, 0.04, 25)
# SQL_Q6 with its discount bounds and quantity as placeholders: bound to
# Q6_PARAMETERS, it is SQL_Q6's text again
SQL_Q6_PARAMS = SQL_Q6.replace("between 0.05 and 0.07",
                               "between ? and ?").replace(
                                   "l_quantity < 24", "l_quantity < ?")
_Q3_LAUNCHES = {**_NO_LAUNCH, "compact": 4, "hash32": 4}


def _runs(n, launches):
    """``n`` runs of a plan of ``launches`` (one probe)."""
    return {k: v if k == "probe" else n * v for k, v in launches.items()}


# launches of phase 3t's paths, reckoned from the code before the first run
# (each +1 probe, from self_check): a Flight SQL statement runs its plan
# twice, once in GetFlightInfo (its schema and row count) and again in
# DoGet, so SQL Q1 is 3n's seven float sums (K1) twice and SQL Q3 3n's
# four compactions (K2) and four hash words (K4) twice; GetFlightInfo
# alone runs it once; the DB-API cursor and the ODBC gateway execute
# through the same client, two runs each; Q6 and the metadata commands
# launch none; Q1 over the DoGet Table is 3l's Q1; the exchange's eager
# filter compacts every column in one K2; the four concurrent clients run
# Q1 and Q3 twice each; DoGet, DoPut and the authenticated DoGet are host
# work
FLIGHT_LAUNCHES = {
    "3t Flight SQL Q1": _runs(2, _Q1_LAUNCHES),
    "3t Flight SQL Q1 info": _Q1_LAUNCHES,
    "3t Flight SQL Q3": _runs(2, _Q3_LAUNCHES),
    "3t Flight SQL Q3 info": _Q3_LAUNCHES,
    "3t Q1 over the DoGet Table": _Q1_LAUNCHES,
    "3t DoExchange filter": {**_NO_LAUNCH, "compact": 1},
    "3t DB-API Q1": _runs(2, _Q1_LAUNCHES),
    "3t ODBC Q1": _runs(2, _Q1_LAUNCHES),
    "3t concurrent Q1 and Q3": {
        k: FLIGHT_CLIENTS * 2 * (_Q1_LAUNCHES[k] + _Q3_LAUNCHES[k])
        if k != "probe" else 1 for k in _NO_LAUNCH},
}


def tables_server(location, tables, device):
    """A Flight server of host Tables: ``do_get`` gives the Table its
    ticket names, ``do_put`` keeps the Table it receives in ``received``
    by the descriptor's path, and ``do_exchange`` runs the port's eager
    filter on ``device`` over the orders it receives (o_totalprice above
    EXCHANGE_PRICE) and streams the rows back."""
    from arrow_tpu_torch import compute as pc
    from arrow_tpu_torch import flight

    class Server(flight.FlightServerBase):
        received = {}

        def do_get(self, ticket):
            return tables[ticket.ticket.decode()]

        def do_put(self, descriptor, table):
            self.received[descriptor.path[0].decode()] = table

        def do_exchange(self, descriptor, table):
            keep = pc.greater(table.column("o_totalprice"), EXCHANGE_PRICE,
                              device=device)
            return pc.filter(table, keep, device=device)
    return Server(location)


def call_options():
    """3t's Flight client calls' options: their deadline."""
    from arrow_tpu_torch.flight import FlightCallOptions
    return FlightCallOptions(timeout=FLIGHT_TIMEOUT_S)


def within(fn, *args):
    """``fn(*args)`` on a thread joined within FLIGHT_TIMEOUT_S: the
    deadline of 3t's calls that take no call options (DB-API's, and ODBC's
    through its gateway)."""
    import threading
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - raised below
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(FLIGHT_TIMEOUT_S)
    if t.is_alive():
        raise TimeoutError(f"{fn.__name__} passed its deadline of "
                           f"{FLIGHT_TIMEOUT_S} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def statement_descriptor(text):
    """The FlightDescriptor of a Flight SQL statement, as
    FlightSqlClient.execute sends it to GetFlightInfo."""
    from google.protobuf import any_pb2
    from arrow_tpu_torch.flight import FlightDescriptor
    from arrow_tpu_torch.flight.proto import FlightSql_pb2
    cmd = any_pb2.Any()
    cmd.Pack(FlightSql_pb2.CommandStatementQuery(query=text))
    return FlightDescriptor.for_command(cmd.SerializeToString())


def _traced_server(location, tables, seen):
    """A Flight server behind basic auth and the tracing middleware: its
    ``do_get`` (the context-first signature) serves ``tables`` and notes
    the trace context its middleware saw in ``seen``."""
    from arrow_tpu_torch import flight

    class Server(flight.FlightServerBase):
        def do_get(self, context, ticket):
            seen.append(context.get_middleware("trace").trace_context)
            return tables[ticket.ticket.decode()]
    return Server(location, auth_handler=flight.BasicServerAuthHandler(
        dict([FLIGHT_USER])), middleware={
            "trace": flight.TracingServerMiddlewareFactory()})


def _rows(tbl):
    """A host Table as a list of row tuples."""
    cols = tbl.to_pydict()
    return list(zip(*cols.values()))


def _same_answer(name, got, want):
    """Column names and every value alike, floats bit for bit: the same
    plan over the same Tables gives the same bits on every run."""
    g, w = got.to_pydict(), want.to_pydict()
    _expect(name, g == w, f"({list(g)}: {str(g)[:200]} against "
            f"{str(w)[:200]})")


def q6_revenue(li, lo, hi, quantity):
    """SQL_Q6_PARAMS's revenue at (lo, hi, quantity) over lineitem's host
    columns, numpy."""
    from arrow_tpu_torch.io.tpch_queries import (DATE_1994_01_01,
                                                 DATE_1995_01_01)
    sd = _host_values(li, "l_shipdate")
    disc = _host_values(li, "l_discount")
    keep = ((sd >= DATE_1994_01_01) & (sd < DATE_1995_01_01)
            & (disc >= lo) & (disc <= hi)
            & (_host_values(li, "l_quantity") < quantity))
    return float(np.sum(_host_values(li, "l_extendedprice")[keep]
                        * disc[keep]))


def _flight_sql(loc, host, paths, peaks, facts):
    """Q1 and Q3 through FlightSqlClient.execute, each equal to 3n's answer
    and its FlightInfo's total_records to its rows; a prepared Q6 with its
    three parameters bound by DoPut, equal to 3n's Q6; the six metadata
    commands."""
    from arrow_tpu_torch.flight import FlightClient
    from arrow_tpu_torch.flight.sql import FlightSqlClient
    answers = host.answers
    opts = call_options()
    cli = FlightSqlClient(loc)
    info_client = FlightClient(loc)
    try:
        for name, text in (("Q1", SQL_Q1), ("Q3", SQL_Q3)):
            got = _plan_path(paths, f"Flight SQL {name}",
                             lambda: cli.execute(text, opts).read_all(),
                             peaks, facts)
            _same_answer(f"3t Flight SQL {name}", got, answers[f"SQL {name}"])
            info = paths.run(f"Flight SQL {name} info",
                             lambda: info_client.get_flight_info(
                                 statement_descriptor(text), opts))
            _expect(f"3t Flight SQL {name} total_records",
                    info.total_records == got.num_rows and
                    info.schema.names == got.schema.names,
                    f"({info.total_records} against {got.num_rows})")

        def prepared():
            stmt = cli.prepare(SQL_Q6_PARAMS, opts)
            try:
                from arrow_tpu_torch import types as T
                from arrow_tpu_torch.array.array import array
                from arrow_tpu_torch.table import Table
                lo, hi, qty = Q6_PARAMETERS
                stmt.set_parameters(Table.from_arrays(
                    [array([lo], T.float64()), array([hi], T.float64()),
                     array([qty], T.int64())], ["lo", "hi", "quantity"]),
                    opts)
                return stmt.execute(opts).read_all()
            finally:
                stmt.close(opts)
        got = paths.run("prepared Q6", prepared)
        _same_answer("3t prepared Q6", got, answers["SQL Q6"])

        def metadata():
            return {m: getattr(cli, m)(options=opts).read_all() for m in (
                "get_tables", "get_catalogs", "get_db_schemas",
                "get_table_types", "get_primary_keys", "get_sql_info")}
        meta = paths.run("metadata commands", metadata)
        _expect("3t get_tables", meta["get_tables"].column(
            "table_name").to_pylist() == ["customer", "lineitem", "orders"])
        _expect("3t get_table_types", meta["get_table_types"].to_pydict()
                == {"table_type": ["TABLE"]})
        _expect("3t get_primary_keys", meta["get_primary_keys"].num_rows
                == 0 and meta["get_primary_keys"].num_columns == 6)
        info = meta["get_sql_info"].to_pydict()
        _expect("3t get_sql_info", info["value"][0] == "arrow_tpu_torch"
                and len(info["info_name"]) == 8, str(info))
        _expect("3t get_catalogs and get_db_schemas",
                meta["get_catalogs"].num_rows == 1
                and meta["get_db_schemas"].num_rows == 1)
    finally:
        cli.close()
        info_client.close()


def _flight_data(host, paths, dev, peaks, facts):
    """DoGet of lineitem's eight Q1/Q3 columns, held to the source chunk
    for chunk, and Q1 over the received Table bit for bit 3l's; DoPut of
    orders, every column, the server's Table the source's digest; the
    exchange of orders' four fixed-width columns through the server's
    eager filter on the card, against numpy."""
    from arrow_tpu_torch import flight
    from arrow_tpu_torch.io.tpch_queries import q1_plan
    li, od = host["lineitem"], host["orders"]
    li8 = li.select(INTEROP_LINEITEM)
    od4 = od.select(EXCHANGE_COLUMNS)
    opts = call_options()
    with tables_server("grpc://127.0.0.1:0", {"lineitem": li8},
                       dev) as srv:
        cli = flight.FlightClient(f"grpc://127.0.0.1:{srv.port}")
        try:
            got = paths.run("DoGet lineitem", lambda: cli.do_get(
                flight.Ticket(b"lineitem"), opts).read_all())
            nbytes = _table_bytes(li8)
            facts["DoGet GB"] = nbytes / 1e9
            facts["DoGet GB/s"] = nbytes / paths.walls["3t DoGet lineitem"] \
                / 1e9
            facts["DoGet batches"] = len(got.column(0).chunks)
            _same_table("3t DoGet lineitem", got, li8)
            result = _plan_path(paths, "Q1 over the DoGet Table",
                                lambda: q1_plan(got).to_table(device=dev),
                                peaks, facts)
            _expect("3t Q1 over the DoGet Table", table_digest(result) ==
                    host.digests["Q1"])
            del got
            paths.run("DoPut orders", lambda: cli.do_put(
                flight.FlightDescriptor.for_path("orders"), od, opts))
            nbytes = _table_bytes(od)
            facts["DoPut GB"] = nbytes / 1e9
            facts["DoPut GB/s"] = nbytes / paths.walls["3t DoPut orders"] \
                / 1e9
            _expect("3t DoPut orders", table_digest(srv.received.pop(
                "orders")) == table_digest(od))
            out = paths.run("DoExchange filter", lambda: cli.do_exchange(
                flight.FlightDescriptor.for_path("orders"), od4, opts))
            keep = _host_values(od, "o_totalprice") > EXCHANGE_PRICE
            _expect("3t DoExchange rows", out.num_rows == int(keep.sum()),
                    f"({out.num_rows} against {int(keep.sum())})")
            for n in EXCHANGE_COLUMNS:
                _expect_equal(f"3t DoExchange {n}", _np_bits(
                    out.column(n).combine().data.values()),
                    _np_bits(_host_values(od, n)[keep]))
            facts["DoExchange rows kept"] = out.num_rows
        finally:
            cli.close()


def _flight_dbapi(loc, host, paths):
    """DB-API over Flight SQL: Q1's rows as 3n's; executemany of Q6 with
    its placeholders, the first parameters against numpy, the last Q6's
    own and its rows 3n's. Returns Q1's rows."""
    from arrow_tpu_torch.flight import dbapi
    li = host["lineitem"]
    with dbapi.connect(loc) as con:
        cur = con.cursor()
        rows = paths.run("DB-API Q1", lambda: cur.execute(SQL_Q1).fetchall())
        _expect("3t DB-API Q1", rows == _rows(host.answers["SQL Q1"]))
        _expect("3t DB-API description", [d[0] for d in cur.description]
                == host.answers["SQL Q1"].schema.names)
        first = cur.execute(SQL_Q6_PARAMS, Q6_OTHER_PARAMETERS).fetchall()
        _expect_close("3t DB-API Q6 other parameters",
                      np.array([first[0][0]]),
                      np.array([q6_revenue(li, *Q6_OTHER_PARAMETERS)]))
        paths.run("DB-API Q6 executemany", lambda: cur.executemany(
            SQL_Q6_PARAMS, [Q6_OTHER_PARAMETERS, Q6_PARAMETERS]))
        _expect("3t DB-API Q6", cur.fetchall() ==
                _rows(host.answers["SQL Q6"]))
    return rows


def odbc_query(driver, port, text):
    """``text``'s rows through the ODBC driver's own exports (the calls a
    driver manager forwards to), every cell as the text the driver gives
    for SQL_C_CHAR (None for SQL NULL)."""
    import ctypes
    lib = ctypes.CDLL(driver)
    for fn in ("SQLAllocHandle", "SQLDriverConnect", "SQLExecDirect",
               "SQLNumResultCols", "SQLFetch", "SQLGetData",
               "SQLGetDiagRec", "SQLFreeHandle", "SQLDisconnect"):
        getattr(lib, fn).restype = ctypes.c_short

    def check(rc, what, kind=None, handle=None):
        if rc in (0, 1):
            return
        text = ctypes.create_string_buffer(1024)
        if kind is not None:
            state, nat, ln = (ctypes.create_string_buffer(8), ctypes.c_int(),
                              ctypes.c_short())
            lib.SQLGetDiagRec(kind, handle, 1, state, ctypes.byref(nat),
                              text, 1024, ctypes.byref(ln))
        raise AssertionError(f"ODBC {what}: rc {rc} {text.value!r}")
    env, dbc, stmt = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
    check(lib.SQLAllocHandle(1, None, ctypes.byref(env)), "env")
    check(lib.SQLAllocHandle(2, env, ctypes.byref(dbc)), "dbc")
    conn = f"Gateway_Host=127.0.0.1;Gateway_Port={port}".encode()
    out, out_len = ctypes.create_string_buffer(1024), ctypes.c_short()
    check(lib.SQLDriverConnect(dbc, None, conn, len(conn), out, 1024,
                               ctypes.byref(out_len), 0), "connect", 2, dbc)
    try:
        check(lib.SQLAllocHandle(3, dbc, ctypes.byref(stmt)), "stmt")
        sql = text.encode()
        check(lib.SQLExecDirect(stmt, sql, len(sql)), "execute", 3, stmt)
        ncols = ctypes.c_short()
        check(lib.SQLNumResultCols(stmt, ctypes.byref(ncols)), "columns")
        rows, buf, ind = [], ctypes.create_string_buffer(256), \
            ctypes.c_ssize_t()
        while True:
            rc = lib.SQLFetch(stmt)
            if rc == 100:  # SQL_NO_DATA
                break
            check(rc, "fetch", 3, stmt)
            row = []
            for i in range(1, ncols.value + 1):
                check(lib.SQLGetData(stmt, i, 1, buf, 256,
                                     ctypes.byref(ind)), "get data")
                row.append(None if ind.value == -1 else buf.value.decode())
            rows.append(tuple(row))
        lib.SQLFreeHandle(3, stmt)
        return rows
    finally:
        lib.SQLDisconnect(dbc)
        lib.SQLFreeHandle(2, dbc)
        lib.SQLFreeHandle(1, env)


def _flight_odbc(loc, want_rows, paths, facts):
    """The port's ODBC driver built, a gateway forwarding to the Flight SQL
    server, and Q1 through the driver: the rows 3n's, each float as its
    text (repr), exactly."""
    import ctypes.util
    from arrow_tpu_torch.flight.odbc import driver_path
    from arrow_tpu_torch.flight.odbc_gateway import OdbcGateway
    t0 = time.perf_counter()
    driver = driver_path()
    facts["ODBC driver build s"] = time.perf_counter() - t0
    facts["libodbc"] = ctypes.util.find_library("odbc") or "absent"
    with OdbcGateway(loc) as gw:
        got = paths.run("ODBC Q1", lambda: odbc_query(driver, gw.port,
                                                      SQL_Q1))
    want = [tuple(None if v is None else str(v) for v in row)
            for row in want_rows]
    _expect("3t ODBC Q1", got == want, f"({got[:1]} against {want[:1]})")


def _flight_auth(host, paths):
    """Basic auth and the tracing middleware on a DoGet of customer: a call
    without the token refused, then the authenticated call's Table the
    source's digest and the caller's trace context seen by the handler."""
    from arrow_tpu_torch import flight
    cu = host["customer"]
    seen, opts = [], call_options()
    with _traced_server("grpc://127.0.0.1:0", {"customer": cu},
                        seen) as srv:
        cli = flight.FlightClient(
            f"grpc://127.0.0.1:{srv.port}",
            middleware=[flight.ClientTracingMiddlewareFactory()])
        try:
            try:
                cli.do_get(flight.Ticket(b"customer"), opts)
                refused = False
            except flight.FlightUnauthenticatedError:
                refused = True
            _expect("3t a call without the token refused", refused)

            def run():
                cli.authenticate_basic_token(*FLIGHT_USER, opts)
                return cli.do_get(flight.Ticket(b"customer"),
                                  opts).read_all()
            got = paths.run("auth DoGet customer", run)
        finally:
            cli.close()
    _expect("3t auth DoGet customer", table_digest(got) == table_digest(cu))
    _expect("3t the handler saw the trace context", len(seen) == 1 and
            seen[0].get("traceparent", "").startswith("00-"), str(seen))


def _flight_concurrent(loc, host, paths, peaks, facts):
    """FLIGHT_CLIENTS clients on threads, each running Q1 then Q3 through
    FlightSqlClient.execute at once against one server; every answer 3n's
    and the launches the sum of theirs."""
    import threading
    from arrow_tpu_torch.flight.sql import FlightSqlClient
    start = threading.Barrier(FLIGHT_CLIENTS)
    opts = call_options()

    def client(i):
        cli = FlightSqlClient(loc)
        try:
            start.wait(FLIGHT_TIMEOUT_S)
            return [cli.execute(t, opts).read_all()
                    for t in (SQL_Q1, SQL_Q3)]
        finally:
            cli.close()

    def run():
        with concurrent.futures.ThreadPoolExecutor(FLIGHT_CLIENTS) as pool:
            return list(pool.map(client, range(FLIGHT_CLIENTS)))
    for i, (q1, q3) in enumerate(_plan_path(paths, "concurrent Q1 and Q3",
                                            run, peaks, facts)):
        _same_answer(f"3t concurrent client {i} Q1", q1,
                     host.answers["SQL Q1"])
        _same_answer(f"3t concurrent client {i} Q3", q3,
                     host.answers["SQL Q3"])


def phase_flight(host, device="cuda"):
    """Phase 3t: Arrow Flight, Flight SQL, DB-API and ODBC over phase 3l's
    host Tables, with phase 3n's SQL answers (``host.answers``). A Flight
    SQL server of lineitem, orders and customer on ``device``: SQL Q1 and
    Q3 through FlightSqlClient.execute, each 3n's answer with its
    FlightInfo's row count; a prepared Q6 with its parameters bound by
    DoPut; the metadata commands. A Flight server of host Tables: DoGet of
    lineitem's eight Q1/Q3 columns chunk for chunk the source's and Q1
    over it bit for bit 3l's; DoPut of orders (every column), the server's
    Table the source's digest; DoExchange through the server's eager
    filter on ``device``. DB-API and the port's ODBC driver (built with
    the host compiler, called by ctypes through a gateway) against the
    Flight SQL server; basic auth and the tracing middleware on a DoGet of
    customer; FLIGHT_CLIENTS clients at once. Every client call has a
    deadline of FLIGHT_TIMEOUT_S (its call options', or ``within``'s for
    DB-API and ODBC), and every server and gateway is shut down before
    the phase ends. Each path's launches are set to 0 just
    before and read just after (on the card) and held to FLIGHT_LAUNCHES.
    Returns (launches by path, facts)."""
    from arrow_tpu_torch.flight.sql import FlightSqlServer
    dev = torch.device(device)
    log(f"== phase 3t: Arrow Flight, Flight SQL, DB-API and ODBC on "
        f"{device}")
    t0 = time.perf_counter()
    paths = _Paths(dev, "3t", FLIGHT_LAUNCHES)
    peaks, facts = {}, {}
    tables = {n: host[n] for n in ("lineitem", "orders", "customer")}
    with FlightSqlServer("grpc://127.0.0.1:0", tables, device=dev) as srv:
        loc = f"grpc://127.0.0.1:{srv.port}"
        _flight_sql(loc, host, paths, peaks, facts)
        q1_rows = within(_flight_dbapi, loc, host, paths)
        within(_flight_odbc, loc, q1_rows, paths, facts)
        _flight_concurrent(loc, host, paths, peaks, facts)
    _flight_data(host, paths, dev, peaks, facts)
    _flight_auth(host, paths)
    paths.check_launches()
    log("phase 3t walls (s): " + ", ".join(
        f"{k[3:]} {v:.3f}" for k, v in paths.walls.items()))
    log("phase 3t facts: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in facts.items()))
    if peaks:
        log("phase 3t peak memory above the tables (GiB): " + ", ".join(
            f"{k} {v:.2f}" for k, v in peaks.items()))
    log(f"phase 3t: {time.perf_counter() - t0:.1f} s (paths "
        f"{sum(paths.walls.values()):.1f} s)")
    return paths.launches, {"walls": paths.walls, "peaks": peaks,
                            "facts": facts}


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


# the host Tables and their batches that host_tables() and phase 3j
# generated, by (name, scale factor): phase 3l takes them instead of
# generating them again
_GENERATED = {}


def host_tables():
    """Every TPC-H table but lineitem from the port's host generator at
    SF10, uploaded, by name (its host Table kept for phase 3l)."""
    from arrow_tpu_torch.io import tpch
    t0 = time.perf_counter()
    tables = {}
    for name in ("orders", "customer", "part", "supplier", "partsupp",
                 "nation", "region"):
        _GENERATED[name, SF] = tpch.host_and_device(name, SF)
        tables[name] = _GENERATED[name, SF][1]
    sizes = ", ".join(f"{k} ({int(b.row_count)} rows)"
                      for k, b in tables.items())
    log(f"{sizes} generated on the host and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    return tables


def phase_join_types(orders, customer):
    """Every join type, each run with every launch count set to 0 just
    before, against ``join_oracle`` and its expected launches: orders
    probing customer filtered to one segment, then the null-key tables.
    Returns the first's runs by join type as (rows, its columns' digests
    by name), which phase 3k's single-rank runs of the same joins are."""
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
    digests = {}
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
            if probe is orders:
                d = digest(batch)
                digests[jt] = (int(batch.row_count), dict(zip(
                    batch.schema.names, zip(d[0::2], d[1::2]))))
            del batch
    return digests


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
    result = plan.to_table().to_pydict()
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
    result = q4_plan(orders, lineitem).to_table().to_pydict()
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
    result = q13_plan(customer, orders).to_table().to_pydict()
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


# the numpy oracles of a phase's plans run on this many threads beside the
# plans (numpy lets go of the GIL in its array work); the checks are the same
ORACLE_THREADS = 4


def _run_queries(phase, queries, tables, cols, params=None):
    """Each query with every launch count set to 0 just before its run
    and read just after, then against its oracle and its launches; every
    query runs before a failure is raised. The oracles start at once on
    ORACLE_THREADS threads and each is awaited after its query's run."""
    launches, failures = {}, []
    with concurrent.futures.ThreadPoolExecutor(ORACLE_THREADS) as pool:
        oracles = {q.name: pool.submit(_timed_call, functools.partial(
            q.oracle, **(params or {}).get(q.name, {})), tables, cols)
            for q in queries}
        for q in queries:
            _run_query(q, tables, params, launches, failures,
                       oracles[q.name])
    if failures:
        raise AssertionError(f"phase {phase} failed for {failures}")
    return launches


def _run_query(q, tables, params, launches, failures, oracle):
    """One query of ``_run_queries``: its run, launches and peak, then its
    result against ``oracle``'s (a future); a failure is appended to
    ``failures``."""
    from arrow_tpu_torch.platform_check import self_check
    plan = suite_plan(q, tables, (params or {}).get(q.name, {}))
    base = memory_mark()
    zero_launches()
    self_check()
    t1 = time.perf_counter()
    result = plan.to_table().to_pydict()
    log(f"{q.name} first run {time.perf_counter() - t1:.3f} s")
    launches[q.name] = read_launches()
    log_peak(q.name, base)
    t1 = time.perf_counter()
    (want, n_rows), took = oracle.result()
    log(f"{q.name} oracle: {took:.1f} s on its thread, awaited "
        f"{time.perf_counter() - t1:.1f} s")
    try:
        check_launches(q.name, launches[q.name], q.launches)
        check_result(q.name, result, want)
    except AssertionError as exc:
        log(f"  {q.name} FAILED: {exc}")
        failures.append(q.name)
        return
    log(f"{q.name} result matches the numpy oracle ({n_rows} rows kept "
        f"by the oracle, {len(next(iter(result.values())))} result rows): "
        f"keys, counts and order exact, floats within rtol {RTOL_F64}")
    for i in range(min(len(next(iter(result.values()))), 6)):
        log("  " + " ".join(f"{k}={result[k][i]}" for k in result))


def best_wall(run, reps=6):
    """Host-clock seconds of ``run`` (which ends in a download) after a
    synchronize, every run; the first is the warm-up, but where ``reps``
    is 1. The timed runs stop before ``reps`` once they have taken
    WALL_BUDGET_S: a path of seconds a run is timed once, which keeps the
    script inside its limit as phases are added."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(walls) >= 2 and sum(walls[1:]) > WALL_BUDGET_S:
            break
    return walls, min(walls[1:] or walls)


def profile_run(name, run):
    """Device time of one run by kernel, from torch.profiler; returns the
    run's host-clock seconds (profiler on)."""
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
    # kernels only: an operator's device time repeats its kernels', and a
    # plan node's span (``arrow_tpu::<factory>``) the kernels under it
    cuda = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows = [r for r in cuda if not r[0].startswith(NODE_SPAN)]
    spans = [r for r in cuda if r[0].startswith(NODE_SPAN)]
    device_us = sum(r[1] for r in rows)
    if not rows:
        log(f"{name} profile: the profiler saw no device time (not "
            "measured)")
        return wall_us / 1e6
    log(f"{name} profile: device busy {device_us:.1f} us of {wall_us:.1f} "
        f"us wall (idle share {1 - device_us / wall_us:.3f}; profiler on)")
    h2d_us = sum(r[1] for r in rows if r[0].startswith("Memcpy HtoD"))
    if h2d_us:
        # a streamed run copies on a stream of its own, beside the kernels
        compute_us = device_us - h2d_us
        log(f"{name} profile: {h2d_us:.1f} us of host-to-card copies; the "
            f"rest busy {compute_us:.1f} us (idle share "
            f"{1 - compute_us / wall_us:.3f})")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:14]:
        log(f"  {us:12.1f} us  x{count:<4d} {key[:110]}")
    if spans:
        # nested: a node's span holds those of the nodes below it
        log(f"{name} device span by plan node: " + ", ".join(
            f"{k[len(NODE_SPAN):]} {us / 1e3:.1f} ms (x{c})"
            for k, us, c in sorted(spans, key=lambda r: -r[1])))
    # the host operators that launched that device time (self time: each
    # kernel counts once, under the operator that launched it)
    ops = [(e.key, e.self_device_time_total, e.count) for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    log(f"{name} device time by launching operator:")
    for key, us, count in sorted(ops, key=lambda r: -r[1])[:14]:
        log(f"  {us:12.1f} us  x{count:<4d} {key[:60]}")
    return wall_us / 1e6


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
    one profiled run; a path of one rep (a sweep the phase before ran with
    its checks) is run once, under the profiler, which gives its wall."""
    for path, run in paths:
        if getattr(path, "reps", 6) == 1:
            wall = profile_run(path.name, run)
            log(f"{path.name} SF{SF:g}: wall [{wall * 1e3:.3f}] ms (the "
                f"profiled run) [{card}]")
            continue
        walls, best = best_wall(run, getattr(path, "reps", 6))
        log(f"{path.name} SF{SF:g}: wall "
            f"{[round(w * 1e3, 3) for w in walls]} ms; best "
            f"{best * 1e3:.3f} ms [{card}]")
        profile_run(path.name, run)


def time_host_tier(card, s):
    """Phase 3m's device paths at 60M rows, each the best of 5 after a
    warm-up (host clock to a host Array, the eager call's upload and
    download included), beside its bound (its inputs read once and its
    output written once at HBM_BYTES_PER_S); then their device time by
    operator from one profiled run of all of them."""
    import arrow_tpu_torch.compute as pc
    dev = torch.device("cuda")
    lst, dbl = s["list<l_shipmode>"], s["list<double>"]
    n, n_lists = s["n"], s["n_orders"]
    lens = np.diff(s["offs"])
    kept = int(np.repeat(s["valid"], lens).sum())
    runs = len(np.unique(s["skey"]))
    ree = pc.call_function("run_end_encode", [s["keys"]], device=dev)
    offs_b = 4 * (n_lists + 1)
    calls = (
        ("list_value_length", lambda: pc.list_value_length(dbl, device=dev),
         offs_b + 5 * n_lists),
        ("list_parent_indices",
         lambda: pc.list_parent_indices(dbl, device=dev),
         offs_b + n_lists + 8 * kept),
        ("list_flatten list<double>",
         lambda: pc.list_flatten(dbl, device=dev),
         offs_b + n_lists + 8 * n + 8 * kept),
        ("list_flatten list<l_shipmode>",
         lambda: pc.list_flatten(lst, device=dev),
         offs_b + n_lists + 4 * n + 4 * kept),
        ("list_element 0", lambda: pc.list_element(dbl, 0, device=dev),
         offs_b + n_lists + 8 * n_lists + 9 * n_lists),
        ("run_end_encode", lambda: pc.call_function(
            "run_end_encode", [s["keys"]], device=dev), 8 * n + 12 * runs),
        ("run_end_decode", lambda: pc.run_end_decode(ree, device=dev),
         12 * runs + 8 * n))
    for name, run, nbytes in calls:
        walls, best = best_wall(run, reps=6)
        log(f"3m {name}: wall {[round(w * 1e3, 3) for w in walls]} ms; best "
            f"{best * 1e3:.3f} ms; bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f}"
            f" ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s) [{card}]")

    def all_calls():
        for _, run, _ in calls:
            run()
    profile_run("3m nested and run-end paths", all_calls)


def phase_times(card, launches, errs, tables, typed, params, stats,
                strings, rest, stream, nested):
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

    # phase 3j's and 3h's paths last: a profile of thousands of kernels
    # (3j's chunks, 3h's sweeps) fills the profiler's buffer, and the
    # kernels' device times read after it come out short
    time_paths(card, [(p, functools.partial(p.run, p.plan(stream,
                                                          stream["host"])))
                      for p in STREAM_PATHS]
               + [(p, lambda p=p: p.run(strings, None))
                  for p in STRING_PATHS])

    time_host_tier(card, nested)

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
        # F9's subprocess (phase 3p checks it) beside the set-up's table
        # generation, which is not measured, and awaited at its end
        bad_page = _bad_page_start()
        try:
            tables = timed(host_tables)
        finally:
            bad_page = _bad_page_finish(bad_page)
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
        stream_launches, stream = timed(phase_stream, tables)
        launches.update(stream_launches)
        host_launches, host = timed(phase_host)
        launches.update(host_launches)
        tier_launches, nested = timed(phase_host_tier, host)
        launches.update(tier_launches)
        front_launches, _ = timed(phase_frontends, host, nested)
        launches.update(front_launches)
        file_launches, _ = timed(phase_files, host)
        launches.update(file_launches)
        parquet_launches, _ = timed(phase_parquet, host, "cuda", bad_page)
        launches.update(parquet_launches)
        text_launches, _ = timed(phase_csv_json_orc, host, "cuda")
        launches.update(text_launches)
        surface_launches, _ = timed(phase_host_surface, host)
        launches.update(surface_launches)
        interop_launches, _ = timed(phase_interop, host)
        launches.update(interop_launches)
        flight_launches, _ = timed(phase_flight, host)
        launches.update(flight_launches)
        # phase 3b before 3k: its runs of the eight joins are 3k's
        # single-rank runs of them
        joins = timed(phase_join_types, orders, customer)
        launches.update(timed(phase_dist, tables, SF, "cuda", host, joins))
        del host
        kernel_line = timed(phase_times, card, launches, errs, tables,
                            typed, params, stats, strings, rest, stream,
                            nested)
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
