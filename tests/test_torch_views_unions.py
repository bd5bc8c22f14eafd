"""The view and union layouts of the port (``array/data.py``,
``construct.py``, ``array.py``, ``ipc/``), ``Device`` and the Buffer's
device facts, against the JAX package's; and ``chip_smoke.py``'s phase 3s
on the CPU.

* string_view, binary_view, list_view and large_list_view from a
  sequence: the reference's buffers, ``to_pylist`` and slices; a union
  built from its buffers, sparse and dense, sliced; a union from a
  sequence refused as the reference refuses it;
* a string or binary column cast to its view type (the port's widening):
  the buffers the reference builds from the same values;
* ``validate``: the reference's answers, but where it refuses its own
  view arrays (a reference defect the port does not copy);
* IPC streams and files of every layout byte for byte the reference's,
  and read back by both packages and by pyarrow;
* ``Device`` of the CPU and of a card, ``MemoryManager``, and a Buffer's
  ``device``, ``device_type`` and ``memory_manager``.
"""

import io

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import ipc as rip
from arrow_tpu_torch import ipc as pip

from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

LONG = "a value longer than twelve bytes"
VIEW_CASES = {
    "string_view": (["a", None, LONG, "", "exactly12byt", "thirteen byte",
                     "déjà vu, déjà"], "string_view"),
    "binary_view": ([b"x", None, b"y" * 40, b""], "binary_view"),
    "empty string_view": ([], "string_view"),
    "all null string_view": ([None, None], "string_view"),
    "list_view": ([[1, 2], None, [], [3, None]], "list_view"),
    "large_list_view": ([[1.5], [None, 2.5], None], "large_list_view"),
}


def _view(P, name):
    vals, tname = VIEW_CASES[name]
    factory = getattr(P, tname)
    t = factory(P.int64() if tname == "list_view" else P.float64()) \
        if "list" in tname else factory()
    return P.array(vals, t)


def _bytes(d):
    return [None if b is None else b.to_pybytes() for b in d.buffers] + \
        [_bytes(c) for c in d.children]


@pytest.mark.parametrize("name", sorted(VIEW_CASES))
def test_views_are_the_references(name):
    r, p = _view(at, name), _view(att, name)
    assert _bytes(p.data) == _bytes(r.data)
    assert p.to_pylist() == r.to_pylist() == VIEW_CASES[name][0]
    assert (p.null_count, len(p)) == (r.null_count, len(r))
    for off, ln in ((1, 2), (0, 0), (2, None)):
        assert p.slice(off, ln).to_pylist() == r.slice(off, ln).to_pylist()


def _unions(P):
    fs = [P.field("a", P.int64()), P.field("b", P.string())]
    sparse = P.Array.from_buffers(
        P.sparse_union(fs), 5, [np.array([0, 1, 1, 0, 1], np.int8)],
        children=[P.array([1, 2, 3, None, 5]),
                  P.array(["v", None, "x", "y", "z"])])
    dense = P.Array.from_buffers(
        P.dense_union(fs, [4, 9]), 5,
        [np.array([4, 9, 9, 4, 4], np.int8),
         np.array([0, 0, 1, 1, 2], np.int32)],
        children=[P.array([10, None, 30]), P.array(["p", "q"])])
    return {"sparse": sparse, "dense": dense,
            "sparse sliced": sparse.slice(1, 3),
            "dense sliced": dense.slice(2, 3)}


@pytest.mark.parametrize("name", ["sparse", "dense", "sparse sliced",
                                  "dense sliced"])
def test_unions_are_the_references(name):
    r, p = _unions(at)[name], _unions(att)[name]
    assert p.to_pylist() == r.to_pylist()
    assert (p.null_count, p.offset, len(p)) == (r.null_count, r.offset,
                                                len(r))
    assert p.data.validity_mask() is r.data.validity_mask() is None
    assert np.array_equal(p.data.type_ids(), r.data.type_ids())
    p.validate(full=True)
    r.validate(full=True)


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_a_union_from_a_sequence_is_refused_as_in_the_reference(mode):
    fs = [("a", "int64"), ("b", "string")]
    for P in (at, att):
        t = getattr(P, f"{mode}_union")(
            [P.field(n, getattr(P, tn)()) for n, tn in fs])
        with pytest.raises(NotImplementedError, match="construction for"):
            P.array([1, "x"], t)


@pytest.mark.parametrize("name", ["string_view", "binary_view", "list_view",
                                  "large_list_view"])
def test_validate_counts_the_view_buffers(name):
    """The reference refuses its own view arrays (it expects two buffers);
    the port counts the variadic data buffers and the sizes."""
    from arrow_tpu.array.validate import ValidationError as RErr
    with pytest.raises(RErr, match="expected 2 buffers"):
        _view(at, name).validate()
    _view(att, name).validate(full=True)
    broken = _view(att, name)
    broken.data.buffers = broken.data.buffers[:1]
    with pytest.raises(ValueError):
        broken.validate()


def _batch(P):
    cols = [_view(P, n).slice(0, 4) for n in ("string_view", "binary_view")]
    cols += [_view(P, "list_view"),
             P.array([[1.5], None, [2.5, 3.5], []],
                     P.large_list_view(P.float64())),
             _unions(P)["sparse"].slice(0, 4),
             _unions(P)["dense"].slice(1, 4)]
    return P.RecordBatch.from_arrays(cols, ["sv", "bv", "lv", "llv", "su",
                                            "du"])


@pytest.mark.parametrize("kind", ["stream", "file"])
def test_ipc_of_views_and_unions_is_the_references(kind):
    blobs = []
    for P, I in ((at, rip), (att, pip)):
        rb = _batch(P)
        sink = io.BytesIO()
        make = I.new_stream if kind == "stream" else I.new_file
        with make(sink, rb.schema) as w:
            w.write_batch(rb)
            w.write_batch(rb.slice(1, 2))
        blobs.append(sink.getvalue())
    assert blobs[0] == blobs[1]
    opener = (lambda I, b: I.open_stream(io.BytesIO(b))) if kind == "stream" \
        else (lambda I, b: I.open_file(io.BytesIO(b)))
    got = opener(pip, blobs[0]).read_all()
    want = opener(rip, blobs[0]).read_all()
    assert got.to_pydict() == want.to_pydict()
    assert [repr(f.type) for f in got.schema] == \
        [repr(f.type) for f in _batch(att).schema]
    theirs = (pa.ipc.open_stream if kind == "stream" else
              pa.ipc.open_file)(blobs[1]).read_all()
    assert theirs.to_pydict() == got.to_pydict()
    if kind == "file":
        part = pip.open_file(io.BytesIO(blobs[1])).read_all(["du", "sv"])
        assert part.to_pydict() == {"du": got.column("du").to_pylist(),
                                    "sv": got.column("sv").to_pylist()}


def test_pyarrow_views_and_unions_read_as_the_reference_reads_them():
    tbl = pa.table({
        "sv": pa.array(["x", None, LONG], pa.string_view()),
        "lv": pa.array([[1], None, [2, 3]], pa.list_view(pa.int32())),
        "du": pa.UnionArray.from_dense(
            pa.array([0, 1, 0], pa.int8()), pa.array([0, 0, 1], pa.int32()),
            [pa.array([7, 8]), pa.array(["q"])])})
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl)
    blob = sink.getvalue().to_pybytes()
    got, want = pip.deserialize_table(blob), rip.deserialize_table(blob)
    assert got.to_pydict() == want.to_pydict() == tbl.to_pydict()


# --- Device and the Buffer's device facts ------------------------------------------

def test_devices():
    import torch
    cpu = att.Device()
    assert (cpu.type_name, cpu.device_id, cpu.is_cpu) == ("cpu", 0, True)
    assert cpu.device_type == att.DeviceAllocationType.CPU == \
        at.Device().device_type
    assert repr(cpu) == "<Device cpu:0>" == repr(at.Device())
    card = att.Device("cuda:1")
    assert (card.type_name, card.device_id, card.is_cpu) == ("cuda", 1, False)
    assert card.device_type == att.DeviceAllocationType.CUDA == 2
    assert att.Device(torch.device("cuda")).device_id == 0
    assert att.Device("meta").device_type == att.DeviceAllocationType.EXT_DEV
    mm = att.default_cpu_memory_manager()
    assert mm.is_cpu and mm.device.type_name == "cpu"
    assert repr(mm) == repr(at.default_cpu_memory_manager())
    assert not att.MemoryManager(card).is_cpu


def test_buffer_device_facts_are_the_references():
    p, r = att.py_buffer(b"abc"), at.py_buffer(b"abc")
    assert p.device.is_cpu and p.device.type_name == r.device.type_name
    assert p.device_type == r.device_type == 1
    assert p.memory_manager.is_cpu and r.memory_manager.is_cpu


# --- chip_smoke.py's phase 3s on the CPU --------------------------------------------

def test_chip_smoke_phase_3s_on_cpu():
    """Phase 3s over phase 3l's Tables at SF 0.005 on the CPU: every round
    trip equal, Q1 and Q3 from the imported Tables digest for digest 3l's,
    the export state empty (no launches here)."""
    import chip_smoke
    from arrow_tpu_torch import c_data
    _, host = chip_smoke.phase_host(sf=0.005, device="cpu")
    launches, facts = chip_smoke.phase_interop(host, device="cpu")
    assert launches == {}
    assert set(chip_smoke.INTEROP_LAUNCHES) <= set(facts["walls"])
    assert facts["facts"]["sparse non-zeros"] > 0
    assert not any(c_data.export_state().values())


CAST_CASES = {
    "string": (["", "short", LONG, "exactly12byt", "x" * 13, "déjà",
                LONG * 2], "string", "string_view"),
    "large_string": (["", None, LONG, "ab"], "large_string", "string_view"),
    "binary": ([b"x" * 13, None, b"", b"y"], "binary", "binary_view"),
    "large_binary": ([b"z" * 40, b"w"], "large_binary", "binary_view"),
    "empty": ([], "string", "string_view"),
}


@pytest.mark.parametrize("name", sorted(CAST_CASES) + ["sliced",
                                                      "dictionary"])
def test_a_cast_to_a_view_is_the_references_view(name):
    """A string or binary column cast to its view type (the port's
    widening, phase 3s's c_comment) has the buffers that the reference
    builds from the same values."""
    if name in CAST_CASES:
        vals, src, dst = CAST_CASES[name]
        col = att.array(vals, getattr(att, src)())
    elif name == "sliced":
        vals, dst = [None, "ab", LONG, None, "c" * 12], "string_view"
        col = att.array(["head", LONG * 3] + vals + ["tail"]).slice(2, 5)
    else:
        vals, dst = ["a", None, LONG, "a"], "string_view"
        col = att.array(vals, att.dictionary(att.int32(), att.string()))
    got = col.cast(getattr(att, dst)())
    want = at.array(vals, getattr(at, dst)())
    assert got.type == getattr(att, dst)()
    assert _bytes(got.data) == _bytes(want.data)
    assert got.to_pylist() == want.to_pylist() == vals
    got.validate(full=True)


def test_chip_smokes_dense_union_maker():
    """``dense_union_of`` makes the rows it promises, a valid union."""
    import chip_smoke
    ints = att.array([1, 2, 3, 4, 5])
    strs = att.array(["a", "b", "c", "d", "e"])
    du = chip_smoke.dense_union_of(ints, strs)
    assert du.to_pylist() == [1, "b", 3, "d", 5]
    du.validate(full=True)
