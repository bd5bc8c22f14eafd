"""The host libraries' build (``arrow_tpu_torch/kernels/_build.py``
``host_library``), as the test suite's workers meet it: several processes
that start together on an empty build directory.

One of them compiles ``csrc/lz4_host.cpp``; the others wait on the
build's lock and load the library it put in place; every process then
codes an LZ4 frame and decodes it. A failed build names the compiler's
exit status and keeps its output.
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest

from arrow_tpu_torch.kernels import _build

from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESSES = 6

_CHILD = """
    import os, sys, time
    from pathlib import Path
    from arrow_tpu_torch.kernels import _build
    _build.BUILD_DIR = Path(sys.argv[1])
    go = Path(sys.argv[2])
    while not go.exists():
        time.sleep(0.005)
    from arrow_tpu_torch.utils import lz4frame
    data = bytes(range(256)) * 40000 + b"tail"
    frame = lz4frame.compress(data)
    assert lz4frame.decompress(frame, len(data)) == data
    print("compiled" if "lz4_host" in _build.BUILD_LOG else "loaded")
"""


def test_processes_that_start_together_build_once(tmp_path):
    build = tmp_path / "build"
    go = tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_CHILD), str(build), str(go)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for _ in range(PROCESSES)]
    time.sleep(1.0)  # the interpreters start; then all go at once
    go.touch()
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * PROCESSES, outs
    said = sorted(o.strip().splitlines()[-1] for o in outs)
    assert said == ["compiled"] + ["loaded"] * (PROCESSES - 1), outs
    libs = sorted(p.name for p in build.iterdir())
    assert len([n for n in libs if n.endswith(".so")]) == 1, libs
    assert not [n for n in libs if n.endswith(".tmp")], libs


def test_a_failed_build_names_the_compilers_status(tmp_path, monkeypatch):
    """A source that does not compile: BuildError with the status and the
    output, and nothing left in the build directory but the lock."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cpp").write_text("int f() { return }\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.BuildError) as err:
        _build.host_library("broken")
    assert err.value.returncode not in (0, None)
    assert "broken.cpp" in err.value.output
    assert f"status {err.value.returncode}" in str(err.value)
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".lock"]
    assert "host:broken" not in _build._LIBS


def test_a_failed_cuda_build_carries_the_status(tmp_path, monkeypatch):
    """The CUDA sources' build: a compiler that fails gives BuildError with
    the first failed compiler's status and its output (a stand-in for
    ``nvcc`` that fails for one source of two)."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "good.cu").write_text("// builds\n")
    (src / "bad.cu").write_text("// does not build\n")
    fake = tmp_path / "nvcc"
    fake.write_text(textwrap.dedent("""\
        #!/bin/sh
        for a; do src=$a; done
        case $src in *bad.cu) echo "bad.cu(1): error: no kernel"; exit 3;;
        esac
        while [ "$1" != "-o" ]; do shift; done
        touch "$2"
        """))
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    with pytest.raises(_build.BuildError) as err:
        _build.build_all()
    assert err.value.returncode == 3
    assert "bad.cu(1): error: no kernel" in err.value.output
    assert "good.cu" not in err.value.output
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == ["cuda.lock", _build.library_path(src / "good.cu").name]
