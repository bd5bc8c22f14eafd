"""The whole Q1 slice of the port against the JAX package, and the port's
package rules.

Q1 runs through ``compile_chain(q1_chain_decls())`` over
``q1_device_batch(0.002)`` and through ``q1_plan`` over the JAX package's
``upload_table(lineitem_table(0.01))`` carried across as numpy. Keys,
counts, validity and row order must be exact, floats within rtol 1e-9.
Entry points refuse to run on the CPU unless asked, and nothing in the port
or in chip_smoke.py imports JAX or the JAX package."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from arrow_tpu.acero.exec import compile_chain as jax_compile_chain
from arrow_tpu.device.column import download_table, upload_table
from arrow_tpu.io import tpch
from arrow_tpu.io.tpch_device import q1_device_batch as jax_q1_device_batch
from arrow_tpu.io.tpch_queries import q1_plan as jax_q1_plan
from arrow_tpu.types import TypeId
from arrow_tpu_torch.acero import (AggregateNodeOptions, Declaration,
                                   FilterNodeOptions, HashJoinNodeOptions,
                                   TableSourceNodeOptions, compile_chain,
                                   field)
from arrow_tpu_torch.device.column import batch_from_numpy, download
from arrow_tpu_torch.io.tpch_device import q1_device_batch
from arrow_tpu_torch.io.tpch_queries import q1_chain_decls, q1_plan
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent

_TYPE_NAMES = {TypeId.BOOL: "bool", TypeId.INT32: "int32",
               TypeId.INT64: "int64", TypeId.FLOAT: "float32",
               TypeId.DOUBLE: "float64", TypeId.DATE32: "date32",
               TypeId.DICTIONARY: "dictionary", TypeId.STRING: "string"}


def carry_across(jax_batch, device="cpu"):
    """A JAX DeviceBatch as a port DeviceBatch over the same codes and
    dictionaries, through plain numpy."""
    cols = []
    for f, c in zip(jax_batch.schema.fields, jax_batch.columns):
        cols.append((f.name, _TYPE_NAMES[f.type.id], np.asarray(c.values),
                     None if c.validity is None else np.asarray(c.validity),
                     None if c.dictionary is None
                     else c.dictionary.to_pylist()))
    return batch_from_numpy(cols, int(jax_batch.row_count), device=device)


def assert_tables_match(port, jax, float_rtol=1e-9):
    """``port``: a dict of columns, or the port's host Table (its
    ``to_pydict()``)."""
    if hasattr(port, "to_pydict"):
        port = port.to_pydict()
    assert list(port) == list(jax)
    for name in jax:
        a, b = port[name], jax[name]
        assert len(a) == len(b), name
        assert [v is None for v in a] == [v is None for v in b], name
        if any(isinstance(v, float) for v in b):
            np.testing.assert_allclose(
                np.array([0.0 if v is None else v for v in a]),
                np.array([0.0 if v is None else v for v in b]),
                rtol=float_rtol, atol=0, err_msg=name)
        else:
            assert a == b, name


def test_q1_compile_chain_over_device_batch():
    jb, _ = jax_q1_device_batch(0.002)
    want = download_table(
        jax_compile_chain(__graft_entry__._q1_chain_decls())(jb)).to_pydict()
    tb, _ = q1_device_batch(0.002, device="cpu")
    got = download(compile_chain(q1_chain_decls())(tb))
    assert len(got["count_order"]) == 6
    assert_tables_match(got, want)


def test_q1_plan_over_carried_lineitem():
    lineitem = tpch.lineitem_table(0.01)
    want = jax_q1_plan(lineitem).to_table().to_pydict()
    port_batch = carry_across(upload_table(lineitem))
    got = q1_plan(port_batch).to_table().to_pydict()
    assert_tables_match(got, want)


def test_q1_output_layout():
    tb, _ = q1_device_batch(0.002, device="cpu")
    out = compile_chain(q1_chain_decls())(tb)
    assert out.capacity == 1024  # round_up of the 12 perfect-hash slots
    assert int(out.row_count) == 6
    assert out.schema.names[:2] == ["l_returnflag", "l_linestatus"]


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        q1_device_batch(0.002)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_from_numpy([("x", "int64", np.arange(3), None, None)], 3)


def _unported(kind, source, filtered, seen):
    from arrow_tpu_torch.acero import (ConsumingSinkNodeOptions,
                                       PivotLongerNodeOptions,
                                       ProjectNodeOptions)
    if kind == "product":
        # product (item 9.7) and tdigest (item 9.9) were ported first; the
        # host tier's grouped aggregates came with the host boundary
        return Declaration("aggregate", AggregateNodeOptions(
            [("l_suppkey", "hash_list", None, "suppliers")],
            keys=["l_returnflag"]), [filtered])
    if kind == "consuming_sink":
        return Declaration(kind, ConsumingSinkNodeOptions(
            lambda rb: seen.append(rb.to_pydict())), [filtered])
    if kind == "pivot_longer":
        return Declaration(kind, PivotLongerNodeOptions(
            [(["q"], ["l_quantity"]), (["d"], ["l_discount"])], ["which"],
            ["value"]), [Declaration("project", ProjectNodeOptions(
                [field("l_orderkey"), field("l_quantity"),
                 field("l_discount")],
                ["l_orderkey", "l_quantity", "l_discount"]), [filtered])])
    return Declaration("aggregate", AggregateNodeOptions(
        [("l_quantity", "distinct", None, "total")]), [filtered])


@pytest.mark.parametrize("kind", ["product", "consuming_sink",
                                  "pivot_longer", "scalar aggregate"])
def test_unported_nodes_raise(kind):
    """A standalone filter and an inner hash join run; so do the nodes and
    functions that raised naming their ROADMAP item until the host
    boundary ported them (a grouped and a scalar host-tier aggregate, a
    consuming sink, pivot_longer), each against numpy over the filtered
    rows; a ``scan`` source runs since the dataset frontend was ported,
    and a dataset of a missing Parquet file raises as the reference's."""
    tb, _ = q1_device_batch(0.001, device="cpu")
    source = Declaration("table_source", TableSourceNodeOptions(tb))
    filtered = Declaration("filter", FilterNodeOptions(
        field("l_quantity") > 45.0), [source])
    kept = filtered.to_table().to_pydict()
    quantity = tb.column("l_quantity").values[:int(tb.row_count)]
    assert len(kept["l_quantity"]) == int((quantity > 45.0).sum()) > 0
    joined = Declaration("hashjoin", HashJoinNodeOptions(
        "inner", left_keys=["l_orderkey"], right_keys=["l_orderkey"],
        right_output=["l_linenumber"]), [filtered, source]).to_table(
            ).to_pydict()
    assert len(joined["l_orderkey"]) >= len(kept["l_orderkey"])
    seen = []
    got = _unported(kind, source, filtered, seen).to_table(
        device="cpu").to_pydict()
    if kind == "product":
        flags = list(dict.fromkeys(kept["l_returnflag"]))
        assert got == {"l_returnflag": flags, "suppliers": [
            [s for f, s in zip(kept["l_returnflag"], kept["l_suppkey"])
             if f == g] for g in flags]}
    elif kind == "consuming_sink":
        assert seen == [kept] and got == kept
    elif kind == "pivot_longer":
        assert got["which"] == ["q", "d"] * len(kept["l_quantity"])
        assert got["value"] == [v for pair in zip(
            kept["l_quantity"], kept["l_discount"]) for v in pair]
    else:
        assert got == {"total": [list(dict.fromkeys(kept["l_quantity"]))]}
    # a scan source runs over an in-memory dataset of those rows in two
    # fragments; a dataset of a missing Parquet file (the default format,
    # now ported) raises as the reference's does
    from arrow_tpu_torch import dataset as ds
    from arrow_tpu_torch.acero import ScanNodeOptions
    tbl = filtered.to_table(device="cpu")
    scanned = Declaration("scan", ScanNodeOptions(ds.dataset(
        [tbl.slice(0, 3), tbl.slice(3)]))).to_table(device="cpu")
    assert scanned.to_pydict() == kept
    from arrow_tpu import dataset as jds
    for mod in (ds, jds):
        with pytest.raises(FileNotFoundError):
            mod.dataset("lineitem.parquet")


def _port_sources():
    files = sorted((REPO / "arrow_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "arrow_tpu", "pyarrow"), \
                f"{path.name} imports {name}"


_HOST_BOUNDARY_MODULES = (
    "buffer.py", "utils/bits.py", "array/data.py", "array/construct.py",
    "array/array.py", "table.py", "compute/host_concat.py",
    "compute/dispatch.py", "compute/__init__.py", "compute/registry.py",
    "acero/host_agg.py", "acero/options.py", "acero/exec.py",
    "acero/chunked.py", "acero/source_cache.py", "device/column.py",
    "io/tpch.py", "types.py", "compute/device_nested.py",
    "compute/host_kernels.py", "compute/cast_host.py",
    "compute/decimal_host.py", "compute/extra_kernels.py",
    "compute/vector_misc.py", "acero/dist_exec.py", "memory.py",
    "config.py", "utils/otel.py", "compute/options.py", "api.py",
    "sql.py", "gandiva.py", "substrait.py", "dataset.py",
    "acero/expression.py", "acero/prune.py", "errors.py", "io_streams.py",
    "fs.py", "feather.py", "io/feather_v1.py", "utils/lz4frame.py",
    "ipc/__init__.py", "ipc/fb.py", "ipc/schema_fb.py", "ipc/message.py",
    "ipc/reader_writer.py", "ipc/compat.py", "kernels/_build.py",
    "io/caching.py", "io/parquet/__init__.py", "io/parquet/thrift.py",
    "io/parquet/rle.py", "io/parquet/host.py", "io/parquet/delta.py",
    "io/parquet/bloom.py", "io/parquet/nested.py", "io/parquet/reader.py",
    "io/parquet/writer.py", "io/parquet/metadata.py",
    "io/parquet/encryption.py", "utils/snappy.py", "utils/brotli_ctypes.py",
    "utils/aes_ctypes.py", "io/csv.py", "io/csv_host.py", "io/json.py",
    "io/orc.py", "io/host_arrays.py", "array/validate.py",
    "array/builder.py", "pretty.py", "compare.py", "fs_s3.py", "fs_gcs.py",
    "fs_azure.py", "fs_hdfs.py", "utils/tdigest.py",
    "parallel/distributed.py", "device/__init__.py", "extension.py",
    "compat_names.py", "c_data.py", "interchange.py", "tensor.py")


@pytest.mark.parametrize("module", _HOST_BOUNDARY_MODULES)
def test_the_host_boundary_modules_are_guarded(module):
    """The host boundary's modules are among the guarded sources above,
    and import no flatbuffers or cryptography either (the card's machine
    lacks the first; the port's AES is libcrypto's, by ctypes), nor
    pandas, fsspec or zstandard when they are imported (the port runs
    without them): the pandas methods import pandas when they are called,
    fs.py alone imports fsspec, inside the fsspec adapters, when one is
    made, and ORC's zstd zstandard where a file needs it."""
    path = REPO / "arrow_tpu_torch" / module
    assert path in _port_sources()
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Import):
            top = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            top = [node.module or ""]
        else:
            continue
        for name in top:
            assert name.split(".")[0] not in ("zstandard", "pandas",
                                              "fsspec"), name
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            if node not in tree.body and (
                    name.split(".")[0] == "pandas" or
                    (name == "fsspec" and module == "fs.py")):
                continue
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "arrow_tpu", "pyarrow", "pandas",
                "flatbuffers", "fsspec", "cryptography"), name


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import pkgutil, sys, arrow_tpu_torch\n"
        "for m in pkgutil.walk_packages(arrow_tpu_torch.__path__,\n"
        "                               'arrow_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'arrow_tpu', 'pyarrow', 'flatbuffers',\n"
        "        'fsspec', 'cryptography')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_fails_without_a_card_or_the_port(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
