"""Flight SQL, DB-API and ODBC in the port (``arrow_tpu_torch/flight``)
against the JAX package's, on the CPU:

* ``chip_smoke.py``'s SQL Q1, Q3 and Q6 at SF 0.005 through the port's
  Flight SQL server (``device="cpu"``) and the reference's, each client
  against each server: rows and keys exact, floats within rtol 1e-9;
  Q6 prepared, its parameters bound by DoPut;
* the six metadata commands against the reference server's;
* DB-API: the fetches, ``description``, ``executemany``, the errors;
* the two reference defects the port does not copy, each beside the
  reference's output: ``_bind_parameters`` binds a ``?`` inside a quoted
  literal and lets ``StopIteration`` out when parameters run short, and
  ``odbc.driver_path()`` answers a failed build with a cached ``None``;
* the ODBC driver through unixODBC's driver manager (skipped where
  ``libodbc`` is missing, as ``tests/test_odbc.py``), and the gateway on
  local Tables;
* plans on four threads at once: exact answers, exact launch counts and
  one upload a column; prepared statements of four DB-API connections at
  once, each with its own parameters and answer; phase 3t of
  ``chip_smoke.py`` at SF 0.005.

Every server and gateway lives in a ``with`` block or a module fixture,
and every client call has a deadline: the port's client's
``FlightCallOptions`` timeout, or a thread joined with that deadline
(the reference's client, DB-API, ODBC).
"""

import ctypes
import ctypes.util
import os
import socket
import struct
import threading
import time

import pytest

import arrow_tpu_torch as att
from arrow_tpu.flight import odbc as rodbc
from arrow_tpu.flight import sql as rsql
from arrow_tpu.io import tpch as jtpch
from arrow_tpu_torch.flight import dbapi
from arrow_tpu_torch.flight import sql as psql

import chip_smoke
from test_torch_flight import DEADLINE_S, OPTIONS, within
from test_torch_host_table import carry_table
from test_torch_q1 import assert_tables_match
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

SF = 0.005
TEXTS = {"Q1": chip_smoke.SQL_Q1, "Q3": chip_smoke.SQL_Q3,
         "Q6": chip_smoke.SQL_Q6}


@pytest.fixture(scope="module")
def tpch():
    names = ("lineitem", "orders", "customer")
    ref = {k: getattr(jtpch, f"{k}_table")(SF) for k in names}
    return ref, {k: carry_table(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def servers(tpch):
    ref, port = tpch
    with psql.FlightSqlServer(tables=port, device="cpu") as ps, \
            rsql.FlightSqlServer(tables=ref) as rs:
        yield {"port": f"grpc://127.0.0.1:{ps.port}",
               "reference": f"grpc://127.0.0.1:{rs.port}"}


@pytest.fixture(scope="module")
def answers(tpch):
    """The reference's SQL answers over its own Tables, no Flight."""
    from arrow_tpu import sql as jsql
    ref, _ = tpch
    return {name: jsql.query(text, ref).to_pydict()
            for name, text in TEXTS.items()}


def execute(kind, loc, text):
    if kind == "port":
        cli = psql.FlightSqlClient(loc)
        try:
            return cli.execute(text, OPTIONS).read_all().to_pydict()
        finally:
            cli.close()
    cli = rsql.FlightSqlClient(loc)
    try:
        return within(lambda: cli.execute(text).read_all().to_pydict())
    finally:
        cli.close()


PAIRS = [("port", "port"), ("port", "reference"), ("reference", "port")]


@pytest.mark.parametrize("cli,srv", PAIRS)
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_tpch_through_flight_sql(servers, answers, name, cli, srv):
    got = execute(cli, servers[srv], TEXTS[name])
    assert len(next(iter(got.values()))) > 0
    assert_tables_match(got, answers[name])


@pytest.mark.parametrize("kind", ["port", "reference"])
def test_prepared_q6_binds_its_parameters_by_doput(servers, answers, kind):
    """The port's PreparedStatement against either server: Q6 with its
    discount bounds and quantity as placeholders."""
    cli = psql.FlightSqlClient(servers[kind])
    try:
        stmt = cli.prepare(chip_smoke.SQL_Q6_PARAMS, OPTIONS)
        lo, hi, qty = chip_smoke.Q6_PARAMETERS
        stmt.set_parameters(att.table({"lo": [lo], "hi": [hi],
                                       "q": [qty]}), OPTIONS)
        got = stmt.execute(OPTIONS).read_all().to_pydict()
        stmt.close(OPTIONS)
    finally:
        cli.close()
    assert_tables_match(got, answers["Q6"])


METADATA = ("get_tables", "get_catalogs", "get_db_schemas",
            "get_table_types", "get_primary_keys", "get_sql_info")


@pytest.mark.parametrize("method", METADATA)
def test_metadata_commands(servers, method):
    """Each command's Table from the port's server, the reference's
    server's but the server's name."""
    got = getattr(psql.FlightSqlClient(servers["port"]), method)(
        options=OPTIONS).read_all()
    rcli = rsql.FlightSqlClient(servers["port"])
    via_ref = within(lambda: getattr(rcli, method)().read_all())
    want = within(lambda: getattr(rsql.FlightSqlClient(
        servers["reference"]), method)().read_all())
    assert got.schema.names == want.schema.names == via_ref.schema.names
    g, w = got.to_pydict(), want.to_pydict()
    if method == "get_sql_info":
        assert g["value"][0] == "arrow_tpu_torch" and \
            w["value"][0] == "arrow_tpu"
        g["value"][0] = w["value"][0]
        assert [str(f.type) for f in got.schema] == \
            [str(f.type) for f in want.schema]
    assert g == w
    assert via_ref.to_pydict() == got.to_pydict()


# --- DB-API ------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    data = {"a": [1, 2, 3, None], "b": [1.5, 2.5, 3.5, 4.5],
            "s": ["x", "y?", None, "w"]}
    with psql.FlightSqlServer(tables={"t": att.table(data)},
                              device="cpu") as ps:
        yield f"grpc://127.0.0.1:{ps.port}"


def test_dbapi_fetches_and_description(small):
    within(_dbapi_fetches, small)


def _dbapi_fetches(small):
    with dbapi.connect(small) as con:
        cur = con.cursor()
        cur.execute("SELECT a, b, s FROM t ORDER BY b")
        assert [d[0] for d in cur.description] == ["a", "b", "s"]
        assert cur.description[0][1] == dbapi.NUMBER
        assert cur.description[2][1] == dbapi.STRING
        assert cur.rowcount == 4
        assert cur.fetchone() == (1, 1.5, "x")
        assert cur.fetchmany(2) == [(2, 2.5, "y?"), (3, 3.5, None)]
        assert cur.fetchall() == [(None, 4.5, "w")]
        assert cur.fetchone() is None
        cur.execute("SELECT a FROM t WHERE b > ?", (2.0,))
        assert list(cur) == [(2,), (3,), (None,)]
        assert cur.fetch_arrow_table().to_pydict() == {"a": [2, 3, None]}
        cur.executemany("SELECT a FROM t WHERE b > ?", [(1.0,), (3.0,)])
        assert cur.fetchall() == [(3,), (None,)]
        assert con.get_tables().column("table_name").to_pylist() == ["t"]


def test_dbapi_errors(small):
    within(_dbapi_errors, small)


def _dbapi_errors(small):
    con = dbapi.connect(small)
    cur = con.cursor()
    with pytest.raises(dbapi.ProgrammingError):
        cur.execute("SELECT nonsense FROM missing_table")
    with pytest.raises(dbapi.ProgrammingError, match="placeholders"):
        cur.execute("SELECT a FROM t WHERE b > ?", (1.0, 2.0))
    with pytest.raises(dbapi.InterfaceError):
        dbapi.Cursor(con).fetchall()
    with pytest.raises(dbapi.NotSupportedError):
        con.rollback()
    con.close()
    with pytest.raises(dbapi.InterfaceError):
        con.cursor()
    with pytest.raises(dbapi.InterfaceError):
        dbapi.connect()


# --- the reference defects the port does not copy ----------------------------

BIND_CASES = {
    "quoted ?": ("SELECT a FROM t WHERE s = '?' AND a = ?", [3],
                 "SELECT a FROM t WHERE s = '?' AND a = 3"),
    "too few": ("SELECT ?, ?", [1], ValueError),
    "too many": ("SELECT ?", [1, 2], ValueError),
    "doubled quote": ("SELECT 'it''s ?' , ?", ["o'k"],
                      "SELECT 'it''s ?' , 'o''k'"),
    "quoted name": ('SELECT "a?" FROM t WHERE b > ?', [1.5],
                    'SELECT "a?" FROM t WHERE b > 1.5'),
}


@pytest.mark.parametrize("case", sorted(BIND_CASES))
def test_bind_parameters_leaves_quoted_text_and_counts(case):
    """The reference binds every ``?`` character, quoted or not, and lets
    a bare StopIteration out when the parameters run short (it ignores a
    surplus); the port binds placeholders only and raises ValueError on a
    count mismatch."""
    text, params, want = BIND_CASES[case]
    if case in ("quoted ?", "too few"):
        with pytest.raises(StopIteration):
            rsql._bind_parameters(text, params)
    if isinstance(want, str):
        assert psql._bind_parameters(text, params) == want
    else:
        with pytest.raises(want, match="placeholders"):
            psql._bind_parameters(text, params)


def test_a_quoted_placeholder_through_the_server(small):
    """``s = '?'`` is text: the port's server answers the statement the
    reference's would fail to bind."""
    def run():
        with dbapi.connect(small) as con:
            cur = con.cursor()
            cur.execute("SELECT a FROM t WHERE s = 'y?' OR b > ?", (3.0,))
            return cur.fetchall()
    assert within(run) == [(2,), (3,), (None,)]


def test_a_failed_driver_build_raises(tmp_path, monkeypatch):
    """The reference's ``driver_path()`` answers a failed build with None,
    and keeps answering None; the port's raises BuildError with the
    compiler's exit status and output."""
    from arrow_tpu_torch.flight import odbc as podbc
    from arrow_tpu_torch.kernels import _build
    cxx = tmp_path / "failing-cxx"
    cxx.write_text("#!/bin/sh\necho 'odbc_driver.cpp: no compiler here' "
                   ">&2\nexit 3\n")
    cxx.chmod(0o755)
    # the reference: a build that cannot start, into a fresh path
    monkeypatch.setattr(rodbc, "_SO", str(tmp_path / "libref.so"))
    monkeypatch.setattr(rodbc, "_failed", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert rodbc.driver_path() is None
    assert rodbc._failed is True
    monkeypatch.setenv("PATH", os.defpath)
    assert rodbc.driver_path() is None  # cached, though g++ is back
    # the port: the compiler's failure, reported
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(_build.BuildError) as e:
        podbc.driver_path()
    assert e.value.returncode == 3
    assert "no compiler here" in e.value.output


# --- ODBC --------------------------------------------------------------------

SQL_HANDLE_ENV, SQL_HANDLE_DBC, SQL_HANDLE_STMT = 1, 2, 3
SQL_C_CHAR, SQL_C_SBIGINT, SQL_C_DOUBLE, SQL_NO_DATA = 1, -25, 8, 100


def test_odbc_through_the_driver_manager(small):
    """unixODBC's libodbc -> the port's driver -> the port's gateway -> the
    port's Flight SQL server (tests/test_odbc.py's case)."""
    from arrow_tpu_torch.flight.odbc import driver_path
    path = ctypes.util.find_library("odbc") or "libodbc.so.2"
    try:
        dm = ctypes.CDLL(path)
    except OSError:
        pytest.skip("unixODBC driver manager not available")
    drv = driver_path()
    assert within(_odbc_rows, dm, drv, small) == [
        (1, 1.5, "x"), (2, 2.5, "y?"), (3, 3.5, None), (None, 4.5, "w")]


def _odbc_rows(dm, drv, small):
    from arrow_tpu_torch.flight.odbc_gateway import OdbcGateway
    with OdbcGateway(small) as gw:
        env, dbc, stmt = (ctypes.c_void_p() for _ in range(3))
        assert dm.SQLAllocHandle(SQL_HANDLE_ENV, None, ctypes.byref(env)) \
            in (0, 1)
        assert dm.SQLSetEnvAttr(env, 200, ctypes.c_void_p(3), 0) in (0, 1)
        assert dm.SQLAllocHandle(SQL_HANDLE_DBC, env, ctypes.byref(dbc)) \
            in (0, 1)
        conn = f"Driver={drv};Gateway_Host=127.0.0.1;" \
               f"Gateway_Port={gw.port}".encode()
        out, ln = ctypes.create_string_buffer(1024), ctypes.c_short()
        assert dm.SQLDriverConnect(dbc, None, conn, len(conn), out, 1024,
                                   ctypes.byref(ln), 0) in (0, 1)
        assert dm.SQLAllocHandle(SQL_HANDLE_STMT, dbc, ctypes.byref(stmt)) \
            in (0, 1)
        text = b"SELECT a, b, s FROM t ORDER BY b"
        assert dm.SQLExecDirect(stmt, text, len(text)) in (0, 1)
        rows = []
        while dm.SQLFetch(stmt) != SQL_NO_DATA:
            a, b = ctypes.c_longlong(), ctypes.c_double()
            s = ctypes.create_string_buffer(64)
            ia, ib, is_ = (ctypes.c_ssize_t() for _ in range(3))
            dm.SQLGetData(stmt, 1, SQL_C_SBIGINT, ctypes.byref(a), 8,
                          ctypes.byref(ia))
            dm.SQLGetData(stmt, 2, SQL_C_DOUBLE, ctypes.byref(b), 8,
                          ctypes.byref(ib))
            dm.SQLGetData(stmt, 3, SQL_C_CHAR, s, 64, ctypes.byref(is_))
            rows.append((None if ia.value == -1 else a.value, b.value,
                         None if is_.value == -1 else s.value.decode()))
        dm.SQLFreeHandle(SQL_HANDLE_STMT, stmt)
        dm.SQLDisconnect(dbc)
        dm.SQLFreeHandle(SQL_HANDLE_DBC, dbc)
        dm.SQLFreeHandle(SQL_HANDLE_ENV, env)
    return rows


def test_odbc_driver_exports_through_the_gateway(small):
    """chip_smoke's ODBC path: the driver's own exports by ctypes, every
    cell the gateway's text."""
    from arrow_tpu_torch.flight.odbc import driver_path
    from arrow_tpu_torch.flight.odbc_gateway import OdbcGateway
    with OdbcGateway(small) as gw:
        rows = within(chip_smoke.odbc_query, driver_path(), gw.port,
                      "SELECT a, b, s FROM t ORDER BY b")
        with pytest.raises(AssertionError, match="missing_table"):
            within(chip_smoke.odbc_query, driver_path(), gw.port,
                   "SELECT x FROM missing_table")
    assert rows == [("1", "1.5", "x"), ("2", "2.5", "y?"), ("3", "3.5",
                                                           None),
                    (None, "4.5", "w")]


def test_gateway_on_local_tables_and_its_close():
    """The gateway's own protocol over Tables in this process on the CPU;
    close() ends the connection threads, an open connection's too."""
    from arrow_tpu_torch.flight.odbc_gateway import OdbcGateway
    gw = OdbcGateway(tables={"t": att.table({"x": [10, 20]})},
                     device="cpu")
    with gw:
        s = socket.create_connection(("127.0.0.1", gw.port), timeout=30)
        sql = b"XSELECT x FROM t"
        s.sendall(struct.pack("<I", len(sql)) + sql)
        (ln,) = struct.unpack("<I", s.recv(4))
        buf = b""
        while len(buf) < ln:
            buf += s.recv(ln - len(buf))
        status, ncols = struct.unpack_from("<II", buf, 0)
        assert status == 0 and ncols == 1
        assert buf.endswith(b"\x02\x00\x00\x0010\x02\x00\x00\x0020")
        held = socket.create_connection(("127.0.0.1", gw.port), timeout=30)
        for _ in range(3000):  # until the gateway serves both connections
            if len(gw._conns) == 2:
                break
            time.sleep(0.01)
        assert len(gw._conns) == 2
    assert not gw._accept_thread.is_alive()
    assert not any(t.is_alive() for t in gw._threads)
    assert held.recv(4) == b""
    held.close()
    s.close()


# --- plans on threads, phase 3t ----------------------------------------------

def test_plans_on_four_threads(tpch):
    """Q1 and Q3 from four threads at once over fresh Tables: each answer
    the one-thread answer, each column uploaded once (``UPLOAD_STATS``
    as one thread's), and a launch counter bumped from eight threads
    exact."""
    from arrow_tpu_torch import sql
    from arrow_tpu_torch.acero import source_cache
    from arrow_tpu_torch.kernels import count_launch
    ref, _ = tpch

    def run(tables):
        return [sql.query(TEXTS[q], tables, device="cpu").to_pydict()
                for q in ("Q1", "Q3")]
    before = source_cache.UPLOAD_STATS["rows"]
    want = run({k: carry_table(v) for k, v in ref.items()})
    once = source_cache.UPLOAD_STATS["rows"] - before
    fresh = {k: carry_table(v) for k, v in ref.items()}
    start = threading.Barrier(4)
    got, before = [None] * 4, source_cache.UPLOAD_STATS["rows"]

    def worker(i):
        start.wait(DEADLINE_S)
        got[i] = run(fresh)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE_S)
    assert not any(t.is_alive() for t in threads)
    assert got == [want] * 4
    assert source_cache.UPLOAD_STATS["rows"] - before == once > 0

    def bump():
        for _ in range(20_000):
            count_launch(bump)
    bump.launches = 0
    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE_S)
    assert bump.launches == 8 * 20_000


def test_a_column_in_preparation_holds_back_no_other(monkeypatch):
    """A column's entries are made under the column's own lock: while one
    thread prepares a column, another prepares and uploads a second one;
    a third thread asking for the first column waits and gets the one
    preparation."""
    import torch
    from arrow_tpu_torch.acero import source_cache
    t = att.table({"x": [1, 2, 3], "y": [4.0, 5.0, 6.0]})
    x, y = t.column("x"), t.column("y")
    entered, go, made = threading.Event(), threading.Event(), []
    real = source_cache.host_column_repr

    def held(col):
        made.append(col)
        if len(made) == 1:  # x's, held until y is done
            entered.set()
            go.wait(DEADLINE_S)
        return real(col)
    monkeypatch.setattr(source_cache, "host_column_repr", held)
    out = {}

    def run(name, col):
        out[name] = source_cache.prepared_column(col)
    first = threading.Thread(target=run, args=("x", x), daemon=True)
    first.start()
    try:
        assert entered.wait(DEADLINE_S)
        again = threading.Thread(target=run, args=("x again", x),
                                 daemon=True)
        again.start()
        other = threading.Thread(target=lambda: out.setdefault(
            "y", source_cache.uploaded_column(y, torch.device("cpu"))),
            daemon=True)
        other.start()
        other.join(DEADLINE_S)
        assert not other.is_alive() and "y" in out
        assert "x" not in out and "x again" not in out
    finally:
        go.set()
    for th in (first, again):
        th.join(DEADLINE_S)
    assert out["x"] is out["x again"]
    assert len(made) == 2


BOUND = {0.0: [(1,), (2,), (3,), (None,)], 2.0: [(2,), (3,), (None,)],
         3.0: [(3,), (None,)], 4.0: [(None,)]}


def test_prepared_statements_on_four_threads(small):
    """Four DB-API connections at once, each preparing, binding and running
    one statement with a parameter of its own, ten times: each gets its
    own answer (two statements given one handle would share their
    parameters)."""
    start = threading.Barrier(len(BOUND))
    got = {}

    def worker(bound):
        start.wait(DEADLINE_S)
        with dbapi.connect(small) as con:
            cur = con.cursor()
            got[bound] = [cur.execute("SELECT a FROM t WHERE b > ?",
                                      (bound,)).fetchall()
                          for _ in range(10)]
    threads = [threading.Thread(target=worker, args=(b,), daemon=True)
               for b in BOUND]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE_S)
    assert not any(t.is_alive() for t in threads)
    assert got == {b: [rows] * 10 for b, rows in BOUND.items()}


def test_phase_3t_on_the_cpu():
    """chip_smoke's phase 3t at SF 0.005 on the CPU after 3l and 3n: every
    path held to 3n's answers, numpy and the sources; its servers and
    gateway shut down when it returns."""
    _, host = chip_smoke.phase_host(sf=SF, device="cpu")
    chip_smoke.phase_frontends(host, None, "cpu")
    before = set(threading.enumerate())
    launches, out = chip_smoke.phase_flight(host, "cpu")
    assert launches == {}
    assert set(out["walls"]) >= set(chip_smoke.FLIGHT_LAUNCHES)
    assert set(threading.enumerate()) <= before
