"""Dense and sparse tensors and their IPC messages (counterpart of
``arrow_tpu/tensor.py``; reference: cpp/src/arrow/tensor.h,
sparse_tensor.h, format/Tensor.fbs and format/SparseTensor.fbs). The
messages are built with the port's flatbuffer builder (``ipc/fb.py``) and
are the reference's bytes.

Two departures for speed, with the same results: a tensor's body is
written from its array without a copy, and read from a memory map (an
object with ``read_buffer``) as a view of the map.
"""

from __future__ import annotations

import io
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

from . import types as T
from .ipc import fb
from .ipc.fb import Builder, Reader, _table
from .ipc.message import _PAIR, _pad_to, encapsulate
from .ipc.schema_fb import _read_type, _write_type
from .types import DataType

_MSG_TENSOR = 4
_MSG_SPARSE_TENSOR = 5


class Tensor:
    """A dense n-dimensional tensor over one contiguous buffer."""

    def __init__(self, data: np.ndarray,
                 dim_names: Optional[Sequence[str]] = None):
        self.data = np.ascontiguousarray(data)
        self.dim_names = list(dim_names) if dim_names else None

    @classmethod
    def from_numpy(cls, arr, dim_names=None) -> "Tensor":
        return cls(np.asarray(arr), dim_names)

    def to_numpy(self) -> np.ndarray:
        return self.data

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    @property
    def strides(self) -> Tuple[int, ...]:
        return self.data.strides

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def size(self) -> int:
        return self.data.size

    @property
    def type(self) -> DataType:
        return T.from_numpy_dtype(self.data.dtype)

    def equals(self, other: "Tensor") -> bool:
        return (self.shape == other.shape
                and bool(np.array_equal(self.data, other.data,
                                        equal_nan=True)))

    def __repr__(self):
        return f"Tensor({self.data.dtype}, shape={self.shape})"


def _buffer_struct(b: Builder, slot: int, offset: int, length: int) -> None:
    """An inline Buffer struct {offset, length} in ``slot`` of the object
    being built."""
    b.prep(8, 16)
    b.prepend_int64(length)
    b.prepend_int64(offset)
    b.slot(slot)


def _tensor_meta(tensor: Tensor) -> Tuple[bytes, int]:
    """(the framed Tensor message, the body's length)."""
    b = Builder(256)
    arr = tensor.data
    body_len = arr.nbytes
    b.start_vector(8, arr.ndim, 8)
    for s in reversed(arr.strides):
        b.prepend_int64(s)
    strides_vec = b.end_vector()
    dims = []
    for i, sz in enumerate(arr.shape):
        name_off = b.create_string(tensor.dim_names[i]) \
            if tensor.dim_names else 0
        dims.append(_table(b, 2, [(1, "off", name_off, 0),
                                  (0, "i64", sz, 0)]))
    b.start_vector(4, len(dims), 4)
    for off in reversed(dims):
        b.prepend_uoffset(off)
    shape_vec = b.end_vector()
    disc, type_off = _write_type(b, tensor.type)
    # Tensor: type_type(0) type(1) shape(2) strides(3) data(4)
    b.start_object(5)
    _buffer_struct(b, 4, 0, body_len)
    b.prepend_uoffset_slot(3, strides_vec)
    b.prepend_uoffset_slot(2, shape_vec)
    b.prepend_uoffset_slot(1, type_off)
    b.prepend_slot("u8", 0, disc, 0)
    tensor_off = b.end_object()
    msg = _table(b, 5, [
        (3, "i64", _pad_to(body_len), 0),
        (2, "off", tensor_off, 0),
        (1, "u8", _MSG_TENSOR, 0),
        (0, "i16", fb.METADATA_V5, 0),
    ])
    return encapsulate(b.finish(msg)), body_len


def write_tensor(tensor: Tensor, sink) -> int:
    """Write ``tensor`` as a Tensor IPC message (format/Tensor.fbs);
    returns the bytes written."""
    meta, body_len = _tensor_meta(tensor)
    sink.write(meta)
    if body_len:
        sink.write(memoryview(tensor.data.reshape(-1)).cast("B"))
    pad = _pad_to(body_len) - body_len
    if pad:
        sink.write(b"\x00" * pad)
    return len(meta) + _pad_to(body_len)


def get_tensor_size(tensor: Tensor) -> int:
    """The bytes ``write_tensor`` writes (ipc/writer.h GetTensorSize)."""
    meta, body_len = _tensor_meta(tensor)
    return len(meta) + _pad_to(body_len)


def _source(source):
    if isinstance(source, (bytes, bytearray, memoryview)):
        return io.BytesIO(source)
    return source


def _read_meta(source) -> bytes:
    cont, meta_len = struct.unpack("<II", source.read(8))
    if cont != 0xFFFFFFFF:  # the legacy framing: no continuation
        meta_len = cont
        source.seek(source.tell() - 4)
    return source.read(meta_len)


def _read_body(source, n: int) -> np.ndarray:
    """The message body, a view of the map where ``source`` is one."""
    if hasattr(source, "read_buffer"):
        return source.read_buffer(n).to_numpy()
    return np.frombuffer(source.read(n), dtype=np.uint8)


def read_tensor(source) -> Tensor:
    """A Tensor IPC message (bytes, a file or a memory map)."""
    source = _source(source)
    r = Reader.root(_read_meta(source))
    if r.u8(1) != _MSG_TENSOR:
        raise ValueError("not a Tensor message")
    body_len = r.i64(3)
    tr = r.union(2)
    dtype = _read_type(tr.u8(0), tr.table(1), [])
    shape, names = [], []
    for i in range(tr.vector_len(2)):
        dim = tr.vector_table(2, i)
        shape.append(dim.i64(0))
        nm = dim.string(1)
        names.append(nm.decode() if nm else None)
    strides = tr.vector_i64(3)
    data_off, data_len = tr.struct_i64_pair(4)
    body = _read_body(source, body_len)
    arr = body[data_off:data_off + data_len].view(dtype.to_numpy_dtype())
    arr = np.lib.stride_tricks.as_strided(arr, shape=shape, strides=strides) \
        if strides else arr.reshape(shape)
    return Tensor(np.ascontiguousarray(arr),
                  names if any(n is not None for n in names) else None)


class SparseCOOTensor:
    """A sparse tensor of coordinates (sparse_tensor.h SparseCOOIndex):
    ``coords`` (non-zeros, ndim) beside ``data``."""

    def __init__(self, data: np.ndarray, coords: np.ndarray,
                 shape: Sequence[int]):
        self.data = np.asarray(data)
        self.coords = np.asarray(coords)
        self.shape = tuple(shape)

    @classmethod
    def from_dense_numpy(cls, arr: np.ndarray) -> "SparseCOOTensor":
        arr = np.asarray(arr)
        coords = np.argwhere(arr != 0)
        return cls(arr[tuple(coords.T)], coords, arr.shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        out[tuple(self.coords.T)] = self.data
        return out

    @property
    def non_zero_length(self) -> int:
        return len(self.data)


class SparseCSRMatrix:
    """A compressed sparse row matrix (sparse_tensor.h SparseCSRIndex)."""

    def __init__(self, data, indptr, indices, shape):
        self.data = np.asarray(data)
        self.indptr = np.asarray(indptr)
        self.indices = np.asarray(indices)
        self.shape = tuple(shape)

    @classmethod
    def from_dense_numpy(cls, arr: np.ndarray) -> "SparseCSRMatrix":
        arr = np.asarray(arr)
        assert arr.ndim == 2
        rows, cols = np.nonzero(arr)
        indptr = np.zeros(arr.shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        return cls(arr[rows, cols], np.cumsum(indptr),
                   cols.astype(np.int64), arr.shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out

    @property
    def non_zero_length(self) -> int:
        return len(self.data)


class SparseCSCMatrix(SparseCSRMatrix):
    """A compressed sparse column matrix (sparse_tensor.h SparseCSCIndex):
    CSR over the transpose, compressedAxis Column on the wire."""

    @classmethod
    def from_dense_numpy(cls, arr: np.ndarray) -> "SparseCSCMatrix":
        arr = np.asarray(arr)
        assert arr.ndim == 2
        t = SparseCSRMatrix.from_dense_numpy(arr.T)
        return cls(t.data, t.indptr, t.indices, arr.shape)

    def to_dense(self) -> np.ndarray:
        return SparseCSRMatrix(self.data, self.indptr, self.indices,
                               (self.shape[1], self.shape[0])).to_dense().T


class SparseCSFTensor:
    """A compressed sparse fiber tensor (sparse_tensor.h SparseCSFIndex):
    a prefix tree of the non-zeros' coordinates; ``indices[k]`` the nodes
    at depth k, ``indptr[k]`` their children's ranges at depth k+1, the
    leaves aligned with ``data``."""

    def __init__(self, data, indptr, indices, axis_order, shape):
        self.data = np.asarray(data)
        self.indptr = [np.asarray(p, dtype=np.int64) for p in indptr]
        self.indices = [np.asarray(i, dtype=np.int64) for i in indices]
        self.axis_order = list(axis_order)
        self.shape = tuple(int(s) for s in shape)

    @property
    def non_zero_length(self) -> int:
        return len(self.data)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @classmethod
    def from_dense_numpy(cls, arr: np.ndarray) -> "SparseCSFTensor":
        arr = np.asarray(arr)
        nz = np.argwhere(arr != 0)  # in lexicographic order
        return cls.from_coords(arr[tuple(nz.T)], nz, arr.shape)

    @classmethod
    def from_coords(cls, data, coords, shape) -> "SparseCSFTensor":
        """The tree of lexicographically sorted coordinates (non-zeros,
        ndim), axes in order."""
        nd = len(shape)
        indices, indptr = [], []
        prev_starts = None
        for k in range(nd):
            pref = coords[:, :k + 1]
            if len(pref):
                change = np.any(np.diff(pref, axis=0) != 0, axis=1)
                starts = np.concatenate([[True], change])
            else:
                starts = np.zeros(0, dtype=bool)
            uniq = np.nonzero(starts)[0]
            indices.append(pref[uniq, k].astype(np.int64))
            if k > 0:
                parent_id = np.cumsum(prev_starts) - 1
                counts = np.bincount(parent_id[uniq],
                                     minlength=int(prev_starts.sum()))
                ptr = np.zeros(len(counts) + 1, dtype=np.int64)
                np.cumsum(counts, out=ptr[1:])
                indptr.append(ptr)
            prev_starts = starts
        return cls(data, indptr, indices, list(range(nd)), shape)

    def coords(self) -> np.ndarray:
        """The non-zeros' coordinates (non-zeros, ndim), in the tensor's
        axis order."""
        coords = self.indices[0].reshape(-1, 1)
        for k in range(1, self.ndim):
            coords = np.repeat(coords, np.diff(self.indptr[k - 1]), axis=0)
            coords = np.concatenate(
                [coords, self.indices[k].reshape(-1, 1)], axis=1)
        full = np.empty_like(coords)
        full[:, self.axis_order] = coords
        return full

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        full = self.coords()
        if len(full):
            out[tuple(full.T)] = self.data
        return out

    def equals(self, other) -> bool:
        return (self.shape == other.shape
                and np.array_equal(self.to_dense(), other.to_dense()))


# --- sparse tensor IPC (format/SparseTensor.fbs) ------------------------------
# the SparseTensorIndex union: COO 1, CSX 2, CSF 3

_SPARSE_COO, _SPARSE_CSX, _SPARSE_CSF = 1, 2, 3


def _int64_type(b: Builder) -> int:
    """An Int table {bitWidth 64, is_signed true}: the index buffers'."""
    return _table(b, 2, [(1, "bool", True, False), (0, "i32", 64, 0)])


def _body_parts(parts):
    """(offsets, lengths, the parts joined, each padded to 8 bytes)."""
    offs, lens, chunks, pos = [], [], [], 0
    for p in parts:
        p = memoryview(p).cast("B")
        offs.append(pos)
        lens.append(len(p))
        pad = _pad_to(len(p)) - len(p)
        chunks.append(p)
        if pad:
            chunks.append(bytes(pad))
        pos += len(p) + pad
    return offs, lens, b"".join(chunks)


def _bytes(a: np.ndarray) -> memoryview:
    return memoryview(np.ascontiguousarray(a).reshape(-1)).cast("B")


def write_sparse_tensor(st, sink) -> int:
    """Write a SparseCOOTensor, SparseCSRMatrix, SparseCSCMatrix or
    SparseCSFTensor as a SparseTensor IPC message (ipc/writer.cc
    WriteSparseTensor); returns the bytes written."""
    b = Builder(256)
    data = np.ascontiguousarray(st.data)
    vtype = T.from_numpy_dtype(data.dtype)
    if isinstance(st, SparseCOOTensor):
        coords = np.ascontiguousarray(st.coords.astype(np.int64))
        offs, lens, body = _body_parts([_bytes(coords), _bytes(data)])
        ityp = _int64_type(b)
        b.start_vector(8, 2, 8)
        b.prepend_int64(8)                     # the innermost stride
        b.prepend_int64(coords.shape[1] * 8)   # a row's (row-major)
        strides_vec = b.end_vector()
        b.start_object(4)
        b.prepend_slot("bool", 3, True, False)  # canonical: rows sorted
        _buffer_struct(b, 2, offs[0], lens[0])
        b.prepend_uoffset_slot(1, strides_vec)
        b.prepend_uoffset_slot(0, ityp)
        idx_off, idx_disc = b.end_object(), _SPARSE_COO
        data_off, data_len = offs[1], lens[1]
    elif isinstance(st, SparseCSFTensor):
        nd = st.ndim
        offs, lens, body = _body_parts(
            [_bytes(p) for p in st.indptr] + [_bytes(i) for i in st.indices]
            + [_bytes(data)])
        ptyp = _int64_type(b)
        ityp = _int64_type(b)
        b.start_vector(16, nd - 1, 8)
        for j in reversed(range(nd - 1)):
            b.prep(8, 16)
            b.prepend_int64(lens[j])
            b.prepend_int64(offs[j])
        indptr_vec = b.end_vector()
        b.start_vector(16, nd, 8)
        for j in reversed(range(nd - 1, 2 * nd - 1)):
            b.prep(8, 16)
            b.prepend_int64(lens[j])
            b.prepend_int64(offs[j])
        indices_vec = b.end_vector()
        b.start_vector(4, nd, 4)
        for a in reversed(st.axis_order):
            b.prepend_int32(a)
        axis_vec = b.end_vector()
        # SparseTensorIndexCSF: indptrType(0) indptrBuffers(1)
        # indicesType(2) indicesBuffers(3) axisOrder(4)
        b.start_object(5)
        b.prepend_uoffset_slot(4, axis_vec)
        b.prepend_uoffset_slot(3, indices_vec)
        b.prepend_uoffset_slot(2, ityp)
        b.prepend_uoffset_slot(1, indptr_vec)
        b.prepend_uoffset_slot(0, ptyp)
        idx_off, idx_disc = b.end_object(), _SPARSE_CSF
        data_off, data_len = offs[-1], lens[-1]
    else:
        axis = 1 if isinstance(st, SparseCSCMatrix) else 0
        offs, lens, body = _body_parts([
            _bytes(st.indptr.astype(np.int64)),
            _bytes(st.indices.astype(np.int64)), _bytes(data)])
        ityp1 = _int64_type(b)
        ityp2 = _int64_type(b)
        b.start_object(5)
        _buffer_struct(b, 4, offs[1], lens[1])
        b.prepend_uoffset_slot(3, ityp2)
        _buffer_struct(b, 2, offs[0], lens[0])
        b.prepend_uoffset_slot(1, ityp1)
        b.prepend_slot("i16", 0, axis, 0)
        idx_off, idx_disc = b.end_object(), _SPARSE_CSX
        data_off, data_len = offs[2], lens[2]

    dims = [_table(b, 2, [(0, "i64", sz, 0)]) for sz in st.shape]
    b.start_vector(4, len(dims), 4)
    for off in reversed(dims):
        b.prepend_uoffset(off)
    shape_vec = b.end_vector()
    disc, type_off = _write_type(b, vtype)
    # SparseTensor: type_type(0) type(1) shape(2) non_zero_length(3)
    # sparseIndex_type(4) sparseIndex(5) data(6)
    b.start_object(7)
    _buffer_struct(b, 6, data_off, data_len)
    b.prepend_uoffset_slot(5, idx_off)
    b.prepend_slot("u8", 4, idx_disc, 0)
    b.prepend_slot("i64", 3, st.non_zero_length, 0)
    b.prepend_uoffset_slot(2, shape_vec)
    b.prepend_uoffset_slot(1, type_off)
    b.prepend_slot("u8", 0, disc, 0)
    st_off = b.end_object()
    msg = _table(b, 5, [
        (3, "i64", len(body), 0),
        (2, "off", st_off, 0),
        (1, "u8", _MSG_SPARSE_TENSOR, 0),
        (0, "i16", fb.METADATA_V5, 0),
    ])
    meta = encapsulate(b.finish(msg))
    sink.write(meta)
    sink.write(body)
    return len(meta) + len(body)


def read_sparse_tensor(source):
    """A SparseTensor IPC message: a SparseCOOTensor, SparseCSRMatrix,
    SparseCSCMatrix or SparseCSFTensor."""
    source = _source(source)
    r = Reader.root(_read_meta(source))
    if r.u8(1) != _MSG_SPARSE_TENSOR:
        raise ValueError("not a SparseTensor message")
    body = _read_body(source, r.i64(3))
    tr = r.union(2)
    dtype = _read_type(tr.u8(0), tr.table(1), []).to_numpy_dtype()
    nd = tr.vector_len(2)
    shape = [tr.vector_table(2, i).i64(0) for i in range(nd)]
    nnz = tr.i64(3)
    idx_disc = tr.u8(4)
    ir = tr.union(5)
    doff, dlen = tr.struct_i64_pair(6)
    data = body[doff:doff + dlen].view(dtype).copy()

    def int64s(off, ln):
        return body[off:off + ln].view(np.int64).copy()

    if idx_disc == _SPARSE_COO:
        ioff, ilen = ir.struct_i64_pair(2)
        flat = int64s(ioff, ilen)
        strides = ir.vector_i64(1)
        if strides and strides[0] == 8 and nd > 1:
            # column-major coordinates (other writers): transposed back
            coords = flat.reshape(nd, nnz).T
        else:
            coords = flat.reshape(nnz, nd)
        return SparseCOOTensor(data, np.ascontiguousarray(coords), shape)
    if idx_disc == _SPARSE_CSX:
        indptr = int64s(*ir.struct_i64_pair(2))
        indices = int64s(*ir.struct_i64_pair(4))
        cls = SparseCSCMatrix if ir.i16(0) == 1 else SparseCSRMatrix
        return cls(data, indptr, indices, shape)
    if idx_disc == _SPARSE_CSF:
        indptr = [int64s(o, ln) for o, ln in
                  ir.vector_structs(1, _PAIR).tolist()]
        indices = [int64s(o, ln) for o, ln in
                   ir.vector_structs(3, _PAIR).tolist()]
        return SparseCSFTensor(data, indptr, indices, ir.vector_i32(4),
                               shape)
    raise NotImplementedError(f"sparse index discriminant {idx_disc}")
