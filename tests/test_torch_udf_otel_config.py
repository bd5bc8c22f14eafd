"""The UDF registrations (``compute/__init__.py``), the OTLP exporter
(``utils/otel.py``, hooked into ``to_table(query_options=...)``) and the
facts of ``memory.py`` and ``config.py``, against the JAX package where it
has the same thing, on the CPU; and the memory accounting's garbage
collection under its own lock, which finishes."""

import gc
import json
import threading

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu.compute as jpc
import arrow_tpu_torch.acero as pac
import arrow_tpu_torch.compute as pc
import arrow_tpu_torch.types as PT
from arrow_tpu.utils import otel as jotel
from arrow_tpu_torch import config, memory
from arrow_tpu_torch.array.array import array
from arrow_tpu_torch.compute.registry import Scalar
from arrow_tpu_torch.utils import otel

from test_torch_host_table import carry_array, carry_table
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


def _doc(name):
    return {"summary": name, "description": ""}


@pytest.fixture(autouse=True)
def registries_restored():
    """Each test's UDFs leave both packages' registries (and the two
    compute modules' wrappers) as they were: other test files count the
    registered names."""
    from arrow_tpu.compute import registry as jreg
    from arrow_tpu_torch.compute import registry as preg
    saved = [(r, dict(r)) for r in (jreg._REGISTRY,
                                    preg.function_registry())]
    mods = [(m, set(vars(m))) for m in (jpc, pc)]
    yield
    for r, before in saved:
        r.clear()
        r.update(before)
    for m, names in mods:
        for k in set(vars(m)) - names:
            delattr(m, k)


# --- UDFs ----------------------------------------------------------------------

def test_scalar_udf_runs_the_eager_compute():
    """A scalar UDF whose body calls the eager compute (on the CPU here,
    the card by default), registered and called in both packages alike."""
    rng = np.random.default_rng(1)
    price = [float(x) for x in rng.uniform(1, 100, 20)]
    disc = [None if i % 7 == 0 else float(x)
            for i, x in enumerate(rng.uniform(0, 0.1, 20))]

    def port_body(ctx, p, d):
        assert ctx.memory_pool is memory.default_memory_pool()
        return pc.multiply(p, pc.subtract(1.0, d, device="cpu"),
                           device="cpu")

    def ref_body(ctx, p, d):
        return jpc.multiply(p, jpc.subtract(1.0, d))

    pc.register_scalar_function(port_body, "udf_revenue",
                                _doc("revenue"), {}, PT.float64())
    jpc.register_scalar_function(ref_body, "udf_revenue", _doc("revenue"),
                                 {}, at.float64())
    want = jpc.call_function("udf_revenue", [at.array(price),
                                             at.array(disc)])
    got = pc.call_function("udf_revenue", [array(price), array(disc)])
    assert got.to_pylist() == want.to_pylist()
    assert pc.udf_revenue(array(price), array(disc)).to_pylist() == \
        want.to_pylist()
    assert "udf_revenue" in pc.list_functions()


def test_scalar_udf_values_become_an_array():
    pc.register_scalar_function(lambda ctx, a: [len(a)] * len(a),
                                "udf_len", _doc("len"), {}, PT.int64())
    got = pc.call_function("udf_len", [array([1, 2, 3])])
    assert got.type == PT.int64() and got.to_pylist() == [3, 3, 3]


def test_aggregate_and_vector_udfs():
    def mean_of(ctx, a):
        assert ctx.batch_length == len(a)
        v = [x for x in a.to_pylist() if x is not None]
        return sum(v) / len(v)
    for mod, make in ((pc, array), (jpc, at.array)):
        mod.register_aggregate_function(
            mean_of, "udf_mean", _doc("mean"), {},
            PT.float64() if mod is pc else at.float64())
        mod.register_vector_function(
            lambda ctx, a, mod=mod: a.sort() if mod is jpc else
            a.sort(device="cpu"), "udf_sorted", _doc("sorted"), {},
            PT.int64() if mod is pc else at.int64())
    want = jpc.call_function("udf_mean", [at.array([1.0, None, 3.0])])
    got = pc.call_function("udf_mean", [array([1.0, None, 3.0])])
    assert isinstance(got, Scalar) and got.as_py() == want.as_py() == 2.0
    assert got.type == PT.float64()
    assert pc.call_function("udf_sorted", [array([3, 1, 2])]).to_pylist() \
        == jpc.call_function("udf_sorted",
                             [at.array([3, 1, 2])]).to_pylist()


def test_tabular_udf_gives_a_reader():
    rt = at.table({"k": ["a", "b", "a"], "v": [1.0, 2.0, 3.0]})
    pt = carry_table(rt)
    pc.register_tabular_function(lambda ctx: pt, "udf_table", _doc("t"),
                                 {}, None)
    jpc.register_tabular_function(lambda ctx: rt, "udf_table", _doc("t"),
                                  {}, None)
    got = pc.call_tabular_function("udf_table").read_all()
    want = jpc.call_tabular_function("udf_table").read_all()
    assert got.to_pydict() == want.to_pydict()
    with pytest.raises(KeyError):
        pc.call_tabular_function("no_such_table_udf")


# --- OTLP --------------------------------------------------------------------------

METRICS = [("table_source", 0.001, 1024), ("filter", 0.002, 512),
           ("aggregate", 0.0005, 64)]


def _shape(payload):
    """The payload with its random ids and times blanked."""
    out = json.loads(json.dumps(payload))
    for rs in out["resourceSpans"]:
        for ss in rs["scopeSpans"]:
            for sp in ss["spans"]:
                for k in ("traceId", "spanId", "parentSpanId",
                          "startTimeUnixNano", "endTimeUnixNano"):
                    if k in sp:
                        sp[k] = k
    return out


def test_otlp_payload_matches_the_reference():
    end = 1_700_000_000_000_000_000
    got = otel._otlp_payload(METRICS, "acero.plan", end)
    want = jotel._otlp_payload(METRICS, "acero.plan", end)
    assert _shape(got) == _shape(want)
    spans = got["resourceSpans"][0]["scopeSpans"][0]["spans"]
    wspans = want["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert [(s["startTimeUnixNano"], s["endTimeUnixNano"]) for s in spans] \
        == [(s["startTimeUnixNano"], s["endTimeUnixNano"]) for s in wspans]
    root = spans[0]
    assert all(s["parentSpanId"] == root["spanId"] for s in spans[1:])
    assert len({s["traceId"] for s in spans}) == 1
    assert otel.export_query(None, destination=None) is None


def test_to_table_exports_its_spans(tmp_path, monkeypatch):
    """``ARROW_TPU_OTEL_EXPORT`` set to a file: a plan run with
    ``query_options`` appends one payload whose spans are the plan and
    its nodes, in ``last_query_context.node_metrics``' order."""
    dest = tmp_path / "spans.jsonl"
    monkeypatch.setenv("ARROW_TPU_OTEL_EXPORT", str(dest))
    rt = at.table({"k": [1, 2, 1, 3], "v": [1.0, 2.0, 3.0, 4.0]})
    plan = pac.Declaration.from_sequence([
        pac.Declaration("table_source",
                        pac.TableSourceNodeOptions(carry_table(rt))),
        pac.Declaration("filter", pac.FilterNodeOptions(
            pac.field("v") > 1.5)),
        pac.Declaration("aggregate", pac.AggregateNodeOptions(
            [("v", "sum", None, "s")], keys=["k"]))])
    out = plan.to_table(query_options=pac.QueryOptions(), device="cpu")
    assert out.num_rows == 3
    lines = dest.read_text().splitlines()
    assert len(lines) == 1
    spans = json.loads(lines[0])["resourceSpans"][0]["scopeSpans"][0][
        "spans"]
    names = [m[0] for m in plan.last_query_context.node_metrics]
    assert spans[0]["name"] == "aggregate"
    assert [s["name"] for s in spans[1:]] == names
    plan.to_table(device="cpu")  # no query options: no export
    assert len(dest.read_text().splitlines()) == 1


# --- memory.py and config.py ---------------------------------------------------------

def test_pool_statistics():
    pool = memory.MemoryPool("test")
    base = pool.bytes_allocated()
    bufs = [pool.allocate(100), pool.allocate(28)]
    assert pool.bytes_allocated() == base + 128
    assert pool.num_allocations() == 2 and pool.max_memory() >= 128
    del bufs
    gc.collect()
    assert pool.bytes_allocated() == base
    assert pool.max_memory() >= 128
    assert memory.total_allocated_bytes() >= 0
    assert memory.default_memory_pool().backend_name == "system"


def test_collection_inside_the_critical_section_finishes():
    """A garbage collection that runs a Buffer's finalizer while the
    accounting holds its lock, on the same thread: the finalizer only
    queues the freed bytes, so the collection finishes; the next reading
    drains them. (The reference's finalizer takes the lock and hangs
    here.)"""
    pool = memory.MemoryPool("gc")

    class Cycle:
        pass
    c = Cycle()
    c.self = c
    c.buf = pool.allocate(4096)
    del c
    assert pool.bytes_allocated() == 4096
    done = threading.Event()

    def collect_under_lock():
        with pool._lock:
            gc.collect()
        done.set()
    t = threading.Thread(target=collect_under_lock, daemon=True)
    t.start()
    t.join(30)
    assert done.is_set(), "the collection hung under the pool's lock"
    assert pool.bytes_allocated() == 0
    assert pool.num_allocations() == 1


def test_device_memory_stats_and_runtime_info():
    import torch
    stats = memory.device_memory_stats()
    info = config.runtime_info()
    assert info.x64_enabled
    if torch.cuda.is_available():
        assert info.backend == "cuda"
        assert info.num_devices == torch.cuda.device_count()
        assert stats["bytes_in_use"] == torch.cuda.memory_allocated()
    else:
        assert stats == {}
        assert (info.backend, info.num_devices) == ("cpu", 1)


def test_build_info_and_env_options(monkeypatch):
    b = config.build_info()
    assert b.compute_functions >= 310
    assert isinstance(b.with_cuda, bool)
    monkeypatch.setenv("ARROW_TPU_CHUNK_ROWS", "4096")
    env = config.env_options()
    assert env["ARROW_TPU_CHUNK_ROWS"] == "4096"
    assert "ARROW_TPU_OTEL_EXPORT" in env
    assert carry_array(at.array([1])).to_pylist() == [1]
