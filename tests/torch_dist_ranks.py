"""Ranks for the port's distributed tests (``test_torch_distributed.py``,
``test_torch_dist_plans.py``).

``Ranks(root, world)`` spawns ``world`` processes (``multiprocessing`` in
spawn mode: the test process holds JAX's threads, which a fork would copy
half alive). Each joins one gloo process group through a ``FileStore``
under ``root`` (the test module's ``tmp_path``), with one torch thread,
makes a ``Mesh`` of the whole group on the CPU, one of ranks 0-2 (ragged
shards) and one of rank 0 alone, and then serves
cases one after another: ``Ranks.run(name, *args, size=..., **kwargs)``
calls the function ``name`` of this module on every rank of the mesh of
that size and returns each rank's result. A rank that raises or does not
answer in time fails the case, and the ranks are started anew for the
next one. The ranks import torch, numpy and the port only.

The plan makers (``PLANS``) take the acero module as their first
argument, so one maker makes the reference's plan and the port's.
Tables cross to the ranks as numpy column specs (``batch_from_numpy``'s
arguments).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

WORLD = 4
RAGGED = 3


# --- the ranks' side ---------------------------------------------------------

def _rank_main(rank, world, store_path, inbox, outbox):
    try:
        import torch
        torch.set_num_threads(1)
        import torch.distributed as dist
        from arrow_tpu_torch.parallel import make_mesh
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        meshes = {world: make_mesh(device="cpu")}
        sub = dist.new_group(list(range(RAGGED)))
        if rank < RAGGED:
            meshes[RAGGED] = make_mesh(sub, device="cpu")
        alone = dist.new_group([0])
        if rank == 0:
            meshes[1] = make_mesh(alone, device="cpu")
        outbox.put((rank, "ready", None))
    except BaseException:  # noqa: BLE001 - reported to the test
        outbox.put((rank, "error", traceback.format_exc()))
        return
    while True:
        msg = inbox.get()
        if msg is None:
            break
        name, size, args, kwargs = msg
        mesh = meshes.get(size)
        if mesh is None:
            outbox.put((rank, "skip", None))
            continue
        try:
            outbox.put((rank, "ok", globals()[name](mesh, *args, **kwargs)))
        except BaseException:  # noqa: BLE001 - reported to the test
            outbox.put((rank, "error", traceback.format_exc()))
    dist.destroy_process_group()


class Ranks:
    """``world`` spawned ranks serving cases (see the module's doc)."""

    def __init__(self, root: str, world: int = WORLD,
                 timeout: float = 240.0):
        self.root = root
        self.world = world
        self.timeout = timeout
        self.procs = []
        self._start()

    def _start(self):
        ctx = mp.get_context("spawn")
        self.dir = tempfile.mkdtemp(prefix="ranks_", dir=self.root)
        store = os.path.join(self.dir, "store")
        self.inboxes = [ctx.Queue() for _ in range(self.world)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, self.world, store, self.inboxes[r], self.outbox))
            for r in range(self.world)]
        for p in self.procs:
            p.start()
        self._collect("ready")

    def _get(self):
        """The next answer; raises queue.Empty after the timeout or as
        soon as a rank has died without one."""
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                return self.outbox.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in self.procs
                        if p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    raise

    def _collect(self, what):
        out, errors = [None] * self.world, []
        for _ in range(self.world):
            try:
                rank, status, value = self._get()
            except queue.Empty:
                self.close()
                self._start()
                raise AssertionError(f"a rank died or did not answer "
                                     f"({what}) within {self.timeout} s")
            if status == "error":
                errors.append(f"rank {rank}:\n{value}")
            out[rank] = value
        if errors:
            self.close()
            self._start()
            raise AssertionError("\n".join(errors))
        return out

    def run(self, name, *args, size=None, **kwargs):
        """``name(mesh, *args, **kwargs)`` on every rank of the mesh of
        ``size`` ranks (all where None); the results by rank (None for a
        rank outside the mesh)."""
        size = size or self.world
        for q in self.inboxes:
            q.put((name, size, args, kwargs))
        return self._collect(name)[:size]

    def close(self):
        for q in getattr(self, "inboxes", []):
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self.procs = []
        shutil.rmtree(getattr(self, "dir", ""), ignore_errors=True)


# --- tables ------------------------------------------------------------------

def batch_of(spec):
    """A port batch on the CPU from ``(columns, row count)``, the columns
    as ``batch_from_numpy`` takes them."""
    from arrow_tpu_torch.device.column import batch_from_numpy
    cols, n = spec
    return batch_from_numpy(cols, n, device="cpu")


def _bits(result):
    """A result's values as text: NaN and -0.0 compare by their bits."""
    return {k: [repr(v) for v in col] for k, col in result.items()}


def _twice(fn):
    """``fn()``'s result and whether a second run gave the same bits."""
    first = fn()
    return first, _bits(fn()) == _bits(first)


# --- cases -------------------------------------------------------------------

def _plan_runs(mesh, make_plan):
    """``make_plan().to_table(mesh=...)`` run twice: {"result", "counts"
    (``EXCHANGE_COUNTS`` of the first run), "repeat"}."""
    from arrow_tpu_torch.acero import dist_exec
    counts = {}

    def once():
        plan = make_plan()
        dist_exec.reset_exchange_counts()
        out = plan.to_table(mesh=mesh).to_pydict()
        counts.setdefault("c", dict(dist_exec.EXCHANGE_COUNTS))
        return out

    result, repeat = _twice(once)
    return {"result": result, "counts": counts["c"], "repeat": repeat}


def plan_case(mesh, plan_name, specs, kwargs=None):
    """``PLANS[plan_name](port acero, *batches, **kwargs)``
    (``_plan_runs``)."""
    import arrow_tpu_torch.acero as ac
    batches = [batch_of(s) for s in specs]
    return _plan_runs(mesh, lambda: PLANS[plan_name](ac, *batches,
                                                   **(kwargs or {})))


def tpch_case(mesh, query, sf, kwargs=None):
    """A TPC-H plan of ``tpch_queries`` over ``io.tpch.generate(sf)``'s
    tables, made on each rank (``_plan_runs``)."""
    from arrow_tpu_torch.io import tpch, tpch_queries
    t = tpch.generate(sf, device="cpu")
    fn, names = TPCH[query]
    return _plan_runs(mesh, lambda: getattr(tpch_queries, fn)(
        *(t[n] for n in names), **(kwargs or {})))


def tpch_host_case(mesh, query, sf, kwargs=None):
    """``tpch_case`` over host Tables (``io.tpch.generate_host``): each
    rank uploads only its range of each table's rows to its device and
    runs the plan. Adds, by table, its rows, the (start, stop) ranges this
    rank uploaded of the columns it read and how many columns; and the
    rows all uploads took (``source_cache.UPLOAD_STATS``)."""
    from arrow_tpu_torch.acero import source_cache
    from arrow_tpu_torch.io import tpch, tpch_queries
    t = tpch.generate_host(sf)
    fn, names = TPCH[query]
    source_cache.reset_upload_stats()
    out = _plan_runs(mesh, lambda: getattr(tpch_queries, fn)(
        *(t[n] for n in names), **(kwargs or {})))
    out["uploads"] = {n: (t[n].num_rows, sorted({
        k for c in t[n].columns for k in source_cache._uploads.get(c, {})}),
        sum(c in source_cache._uploads for c in t[n].columns))
        for n in names}
    out["upload_rows"] = source_cache.UPLOAD_STATS["rows"]
    return out


def tpch_shards_case(mesh, query, sf, kwargs=None):
    """``tpch_case`` with every table a ShardBatch: each rank's own copy of
    its range (a plan over shards, as a rank that made its rows would
    run it). Returns it with the whole tables' run beside it
    (``"whole"``)."""
    from arrow_tpu_torch.device.column import DeviceColumn
    from arrow_tpu_torch.io import tpch, tpch_queries
    from arrow_tpu_torch.parallel import ShardBatch, shard_batch

    def copy(t):
        return None if t is None else t.clone()

    t = {}
    for name, whole in tpch.generate(sf, device="cpu").items():
        part = shard_batch(mesh, whole)
        t[name] = ShardBatch(part.schema, [
            DeviceColumn(copy(c.values), copy(c.validity), c.type,
                         c.dictionary) for c in part.columns],
            part.row_count, part.offset, part.total)
    fn, names = TPCH[query]
    out = _plan_runs(mesh, lambda: getattr(tpch_queries, fn)(
        *(t[n] for n in names), **(kwargs or {})))
    out["whole"] = tpch_case(mesh, query, sf, kwargs)
    return out


def tpch_spec_case(mesh, query, specs, kwargs=None):
    """A TPC-H plan over tables given as specs, in its argument order."""
    from arrow_tpu_torch.io import tpch_queries
    batches = [batch_of(s) for s in specs]
    return _plan_runs(mesh, lambda: getattr(tpch_queries, TPCH[query][0])(
        *batches, **(kwargs or {})))


def call_case(mesh, fn, specs, args=(), kwargs=None):
    """``parallel.<fn>(mesh, *batches, *args, **kwargs)``, its result
    gathered whole and downloaded, run twice: {"result", "repeat",
    "received" (this rank's probe rows of the last join exchange)}."""
    from arrow_tpu_torch import parallel
    from arrow_tpu_torch.device.column import download
    from arrow_tpu_torch.parallel import distributed as D
    batches = [batch_of(s) for s in specs]

    def once():
        out = getattr(parallel, fn)(mesh, *batches, *args, **(kwargs or {}))
        return download(D.gather_host(mesh, out)
                        if isinstance(out, D.ShardBatch) else out)

    result, repeat = _twice(once)
    return {"result": result, "repeat": repeat,
            "received": D.LAST_JOIN.get("probe_rows")}


def table_case(mesh, fn, blobs, args=(), kwargs=None):
    """``parallel.<fn>(mesh, *tables, *args, **kwargs)`` over host Tables
    (the reference's Tables as IPC stream bytes), run twice: {"result"
    (the Table's columns), "schema" (its names and type names), "repeat",
    "received" (this rank's probe rows of the last join exchange)}; for
    ``shard_table``, this rank's part downloaded and its (offset, rows,
    total)."""
    from arrow_tpu_torch import ipc, parallel
    from arrow_tpu_torch.device.column import download
    from arrow_tpu_torch.parallel import distributed as D
    tables = [ipc.deserialize_table(b) for b in blobs]
    if fn == "shard_table":
        part = parallel.shard_table(mesh, *tables, *args)
        return {"result": download(part),
                "range": (part.offset, int(part.row_count), part.total)}
    out = {}

    def once():
        t = getattr(parallel, fn)(mesh, *tables, *args, **(kwargs or {}))
        out["schema"] = [(f.name, repr(f.type)) for f in t.schema.fields]
        return t.to_pydict()

    result, repeat = _twice(once)
    return {"result": result, "schema": out["schema"], "repeat": repeat,
            "received": D.LAST_JOIN.get("probe_rows")}


def pre_fns_case(mesh, left, right):
    """``distributed_join_batches`` with a filter (``lx > 0``) lowered to
    ``left_pre_fns``, as ``call_case``."""
    import arrow_tpu_torch.acero as ac
    from arrow_tpu_torch.acero.exec import _segment_fns
    pre = _segment_fns([ac.Declaration("filter", ac.FilterNodeOptions(
        ac.field("lx") > 0.0))])
    return call_case(mesh, "distributed_join_batches", [left, right],
                     (["k"], ["k"], "inner"), {"left_pre_fns": pre})


def shard_case(mesh, spec):
    """A whole batch sharded and gathered back, and each rank's range."""
    from arrow_tpu_torch.device.column import download
    from arrow_tpu_torch.parallel import gather_host, shard_batch
    whole = batch_of(spec)
    part = shard_batch(mesh, whole)
    return {"back": download(gather_host(mesh, part)),
            "range": (part.offset, int(part.row_count), part.total)}


def exchange_case(mesh, spec, key):
    """Every row sent to rank ``key % size``: what this rank received."""
    import torch
    from arrow_tpu_torch.device.column import download
    from arrow_tpu_torch.parallel import exchange_rows, shard_batch
    part = shard_batch(mesh, batch_of(spec))
    dest = part.column(key).values.long() % mesh.size
    return download(exchange_rows(mesh, part, dest.to(torch.int32)))


# --- plan makers -------------------------------------------------------------

def _src(ac, batch):
    return ac.Declaration("table_source", ac.TableSourceNodeOptions(batch))


def _seq(ac, *decls):
    return ac.Declaration.from_sequence(list(decls))


def _agg(ac, aggs, keys=()):
    return ac.Declaration("aggregate", ac.AggregateNodeOptions(aggs,
                                                               keys=keys))


def spmd_groupby(ac, t):
    return _seq(ac, _src(ac, t), _agg(ac, [
        ("i", "hash_sum", None, "s"), ("i", "hash_min", None, "mn"),
        ("i", "hash_max", None, "mx"), ("i", "hash_count", None, "c"),
        (None, "hash_count_all", None, "ca")], ["k"]))


def spmd_filter_project_groupby(ac, t):
    return _seq(ac, _src(ac, t),
                ac.Declaration("filter", ac.FilterNodeOptions(
                    ac.field("g") > 4)),
                ac.Declaration("project", ac.ProjectNodeOptions(
                    [ac.field("k"), ac.field("i"), ac.field("i") * 3],
                    ["k", "i", "i3"])),
                _agg(ac, [("i3", "hash_sum", None, "s"),
                          ("i", "hash_first", None, "fst"),
                          ("i", "hash_last", None, "lst")], ["k"]))


def spmd_scalar_agg(ac, t):
    return _seq(ac, _src(ac, t), _agg(ac, [
        ("i", "sum", None, "s"), ("i", "count", None, "c"),
        ("i", "min", None, "mn"), ("i", "max", None, "mx")]))


def spmd_float_aggs(ac, t):
    return _seq(ac, _src(ac, t), _agg(ac, [
        ("f", "hash_sum", None, "s"), ("f", "hash_mean", None, "m"),
        ("f", "hash_variance", None, "v")], ["g"]))


def spmd_two_string_keys(ac, t):
    return _seq(ac, _src(ac, t), _agg(ac, [("i", "hash_sum", None, "s")],
                                      ["k", "g"]))


def groupby_sum_by_k(ac, t):
    return _seq(ac, _src(ac, t), _agg(ac, [("i", "hash_sum", None, "s")],
                                      ["k"]))


def order_by_two_keys(ac, t):
    return _seq(ac, _src(ac, t), ac.Declaration(
        "order_by", ac.OrderByNodeOptions([("i", "ascending"),
                                           ("g", "descending")])))


def order_by_nulls(ac, t, placement="at_end"):
    return _seq(ac, _src(ac, t),
                ac.Declaration("filter", ac.FilterNodeOptions(
                    ac.field("g") >= 3)),
                ac.Declaration("order_by", ac.OrderByNodeOptions(
                    [("f", "descending")], null_placement=placement)))


def order_by_string_fetch(ac, t):
    return _seq(ac, _src(ac, t),
                ac.Declaration("order_by", ac.OrderByNodeOptions(
                    [("k", "descending"), ("i", "ascending")])),
                ac.Declaration("fetch", ac.FetchNodeOptions(37, 1500)))


def _join(ac, jt, left, right, keys=("key",), **kw):
    return ac.Declaration("hashjoin", ac.HashJoinNodeOptions(
        jt, left_keys=list(keys), right_keys=list(keys), **kw),
        inputs=[left if isinstance(left, ac.Declaration) else _src(ac, left),
                right if isinstance(right, ac.Declaration)
                else _src(ac, right)])


def join_then_sum(ac, left, right):
    return _seq(ac, _join(ac, "inner", left, right),
                _agg(ac, [("v", "hash_sum", None, "s")], ["w"]))


def join_suffixed(ac, left, right, jt="inner"):
    return _join(ac, jt, left, right, output_suffix_for_left="_l",
                 output_suffix_for_right="_r")


def join_type(ac, left, right, jt="inner"):
    return _join(ac, jt, left, right, keys=("k",))


def fused_pre_join(ac, left, right):
    filtered = ac.Declaration("filter", ac.FilterNodeOptions(
        ac.field("lx") > 0.0), inputs=[_src(ac, left)])
    return _join(ac, "inner", filtered, right, keys=("k",))


def join_type_then_sum(ac, left, right, jt="inner"):
    return ac.Declaration("aggregate", ac.AggregateNodeOptions(
        [("lx", "hash_sum", None, "s")], keys=["k"]),
        inputs=[join_type(ac, left, right, jt)])


PLANS = {f.__name__: f for f in (
    spmd_groupby, spmd_filter_project_groupby, spmd_scalar_agg,
    spmd_float_aggs, spmd_two_string_keys, groupby_sum_by_k,
    order_by_two_keys, order_by_nulls, order_by_string_fetch, join_then_sum,
    join_suffixed, join_type, fused_pre_join, join_type_then_sum)}

# the reference's tests/test_tpch_distributed.py plans and parameters:
# query -> (tpch_queries function, its tables in argument order)
TPCH = {
    "q1": ("q1_plan", ("lineitem",)),
    "q2": ("q2_plan", ("part", "supplier", "partsupp", "nation", "region")),
    "q3": ("q3_plan", ("customer", "orders", "lineitem")),
    "q4": ("q4_plan", ("orders", "lineitem")),
    "q5": ("q5_plan", ("customer", "orders", "lineitem", "supplier",
                       "nation", "region")),
    "q6": ("q6_plan", ("lineitem",)),
    "q7": ("q7_plan", ("supplier", "lineitem", "orders", "customer",
                       "nation")),
    "q8": ("q8_plan", ("part", "supplier", "lineitem", "orders", "customer",
                       "nation", "region")),
    "q9": ("q9_style_plan", ("part", "supplier", "lineitem", "partsupp",
                             "orders", "nation")),
    "q10": ("q10_style_plan", ("customer", "orders", "lineitem")),
    "q11": ("q11_plan", ("partsupp", "supplier", "nation")),
    "q12": ("q12_style_plan", ("orders", "lineitem")),
    "q13": ("q13_plan", ("customer", "orders")),
    "q14": ("q14_plan", ("lineitem", "part")),
    "q15": ("q15_plan", ("lineitem", "supplier")),
    "q16": ("q16_plan", ("partsupp", "part", "supplier")),
    "q17": ("q17_plan", ("lineitem", "part")),
    "q18": ("q18_plan", ("customer", "orders", "lineitem")),
    "q19": ("q19_plan", ("lineitem", "part")),
    "q20": ("q20_plan", ("supplier", "nation", "partsupp", "part",
                         "lineitem")),
    "q21": ("q21_plan", ("supplier", "lineitem", "orders", "nation")),
    "q22": ("q22_plan", ("customer", "orders")),
}
TPCH_KWARGS = {"q18": {"quantity": 25.0}}
