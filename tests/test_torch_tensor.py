"""Dense and sparse tensors of the port (``arrow_tpu_torch/tensor.py``,
``Table.to_tensor``, ``ipc.read_tensor``/``write_tensor``/
``get_tensor_size``) against the JAX package's (``arrow_tpu/tensor.py``):
the Tensor and SparseTensor IPC messages byte for byte, read back by both
packages and by pyarrow, from bytes, a file and a memory map."""

import io

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import ipc as rip
from arrow_tpu import tensor as rt
from arrow_tpu_torch import ipc as pip
from arrow_tpu_torch import tensor as pt

from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


def _dense():
    rng = np.random.default_rng(5)
    return {
        "f64 2d": (rng.normal(size=(7, 3)), None),
        "i32 3d named": (np.arange(24, dtype=np.int32).reshape(2, 3, 4),
                         ["a", "b", "c"]),
        "u8 1d": (np.arange(11, dtype=np.uint8), ["x"]),
        "f32 fortran": (np.asfortranarray(rng.normal(size=(4, 5))
                                          .astype(np.float32)), None),
        "i16 strided": (np.arange(40, dtype=np.int16).reshape(8, 5)[::2],
                        None),
        "empty": (np.zeros((0, 3)), None),
        "f16": (np.linspace(0, 1, 6, dtype=np.float16).reshape(2, 3), None),
        "nan": (np.array([[np.nan, 1.0], [2.0, np.inf]]), None),
    }


@pytest.mark.parametrize("name", sorted(_dense()))
def test_a_tensor_message_is_the_references(name):
    arr, names = _dense()[name]
    want, got = io.BytesIO(), io.BytesIO()
    n_want = rt.write_tensor(rt.Tensor(arr, names), want)
    n_got = pt.write_tensor(pt.Tensor(arr, names), got)
    assert got.getvalue() == want.getvalue() and n_got == n_want
    assert pip.get_tensor_size(pt.Tensor(arr, names)) == \
        rip.get_tensor_size(rt.Tensor(arr, names)) == len(want.getvalue())
    for back in (pt.read_tensor(want.getvalue()),
                 rt.read_tensor(got.getvalue())):
        assert back.shape == arr.shape and back.dim_names == (
            list(names) if names else None)
        assert np.array_equal(back.to_numpy(), arr, equal_nan=True)
    if arr.dtype != np.float16:
        theirs = pa.ipc.read_tensor(pa.BufferReader(got.getvalue()))
        assert np.array_equal(theirs.to_numpy(), arr, equal_nan=True)


def test_a_tensor_from_a_file_and_its_map(tmp_path):
    arr = np.arange(60, dtype=np.float64).reshape(12, 5)
    path = str(tmp_path / "t.tensor")
    with open(path, "wb") as f:
        written = pip.write_tensor(pt.Tensor(arr), f)
    assert written == (tmp_path / "t.tensor").stat().st_size
    for src in (open(path, "rb"), att.memory_map(path)):
        back = pip.read_tensor(src)
        assert np.array_equal(back.to_numpy(), arr)
    assert np.array_equal(rip.read_tensor(open(path, "rb")).to_numpy(), arr)


def test_a_tensor_message_from_pyarrow():
    arr = np.arange(12, dtype=np.int64).reshape(3, 4)
    sink = pa.BufferOutputStream()
    pa.ipc.write_tensor(pa.Tensor.from_numpy(arr, ["r", "c"]), sink)
    blob = sink.getvalue().to_pybytes()
    got, want = pip.read_tensor(blob), rip.read_tensor(blob)
    assert np.array_equal(got.to_numpy(), want.to_numpy())
    assert got.dim_names == want.dim_names == ["r", "c"]


def test_tensor_attributes_are_the_references():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    p, r = pt.Tensor.from_numpy(arr, ["a", "b"]), rt.Tensor.from_numpy(
        arr, ["a", "b"])
    assert (p.shape, p.strides, p.ndim, p.size) == \
        (r.shape, r.strides, r.ndim, r.size)
    assert repr(p) == repr(r) and p.type == att.float32()
    assert p.equals(pt.Tensor(arr.copy())) and not p.equals(
        pt.Tensor(arr + 1))


def _tables(P):
    return {
        "floats": P.table({"a": P.array([1.5, 2.5, 3.5]),
                           "b": P.array([4.0, 5.0, 6.0])}),
        "ints": P.table({"a": P.array([1, 2], P.int32()),
                         "b": P.array([3, 4], P.int32())}),
        "nulls": P.table({"a": P.array([1.0, None]),
                          "b": P.array([None, 2.0])}),
        "empty": P.table({"a": P.array([], P.float64())}),
    }


@pytest.mark.parametrize("name", ["floats", "ints", "nulls", "empty"])
@pytest.mark.parametrize("row_major", [True, False])
def test_table_to_tensor_is_the_references(name, row_major):
    r, p = _tables(at)[name], _tables(att)[name]
    if name == "nulls":
        for t in (r, p):
            with pytest.raises(ValueError, match="null_to_nan"):
                t.to_tensor()
        want = r.to_tensor(null_to_nan=True, row_major=row_major)
        got = p.to_tensor(null_to_nan=True, row_major=row_major)
    else:
        want = r.to_tensor(row_major=row_major)
        got = p.to_tensor(row_major=row_major)
    assert got.shape == want.shape and got.to_numpy().dtype == \
        want.to_numpy().dtype
    assert np.array_equal(got.to_numpy(), want.to_numpy(), equal_nan=True)
    a, b = io.BytesIO(), io.BytesIO()
    rt.write_tensor(want, a)
    pt.write_tensor(got, b)
    assert a.getvalue() == b.getvalue()


def _sparse_dense():
    dense = np.zeros((4, 5, 3))
    dense[0, 1, 2], dense[3, 0, 0], dense[3, 4, 1], dense[2, 2, 2] = \
        1.5, -2, 7, 0.25
    return dense


SPARSE = {
    "coo": lambda M: M.SparseCOOTensor.from_dense_numpy(_sparse_dense()),
    "coo 2d ints": lambda M: M.SparseCOOTensor.from_dense_numpy(
        (_sparse_dense()[:, :, 0] * 4).astype(np.int32)),
    "csr": lambda M: M.SparseCSRMatrix.from_dense_numpy(
        _sparse_dense()[:, :, 2]),
    "csc": lambda M: M.SparseCSCMatrix.from_dense_numpy(
        _sparse_dense()[:, :, 2]),
    "csf": lambda M: M.SparseCSFTensor.from_dense_numpy(_sparse_dense()),
    "csf 4d": lambda M: M.SparseCSFTensor.from_dense_numpy(
        _sparse_dense().reshape(2, 2, 5, 3)),
    "empty csr": lambda M: M.SparseCSRMatrix.from_dense_numpy(
        np.zeros((3, 2))),
}


@pytest.mark.parametrize("name", sorted(SPARSE))
def test_a_sparse_tensor_message_is_the_references(name):
    want, got = io.BytesIO(), io.BytesIO()
    rt.write_sparse_tensor(SPARSE[name](rt), want)
    n = pip.write_sparse_tensor(SPARSE[name](pt), got)
    assert got.getvalue() == want.getvalue() and n == len(want.getvalue())
    mine = SPARSE[name](pt)
    for back in (pip.read_sparse_tensor(want.getvalue()),
                 rt.read_sparse_tensor(got.getvalue())):
        assert type(back).__name__ == type(mine).__name__
        assert tuple(back.shape) == tuple(mine.shape)
        assert np.array_equal(back.to_dense(), mine.to_dense())
        assert back.non_zero_length == mine.non_zero_length


def test_a_csf_tensor_from_sorted_coordinates():
    dense = _sparse_dense()
    by_dense = pt.SparseCSFTensor.from_dense_numpy(dense)
    nz = np.argwhere(dense != 0)
    made = pt.SparseCSFTensor.from_coords(dense[tuple(nz.T)], nz,
                                          dense.shape)
    assert np.array_equal(made.coords(), nz)
    for a, b in zip(made.indptr + made.indices,
                    by_dense.indptr + by_dense.indices):
        assert np.array_equal(a, b)
    assert made.equals(rt.SparseCSFTensor.from_dense_numpy(dense))
