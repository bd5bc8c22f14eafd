"""PEP 249 (DB-API 2.0) driver over Arrow Flight SQL (counterpart of
``arrow_tpu/flight/dbapi.py``).

Reference analogue: the Flight SQL ODBC driver
(cpp/src/arrow/flight/sql/odbc/ — a C++ ODBC 3.x driver exposing Flight
SQL results to generic database tooling). The python-native equivalent of
a driver-manager interface is DB-API: ``connect()`` returns a Connection
whose cursors execute SQL over Flight SQL RPC and iterate Arrow results
as python rows.

    from arrow_tpu_torch.flight import dbapi
    con = dbapi.connect("grpc://127.0.0.1:12345")
    cur = con.cursor()
    cur.execute("SELECT a, b FROM t WHERE a > ?", (3,))
    print(cur.fetchall())

Parameter style ``qmark``: ``?`` placeholders bind positionally through a
Flight SQL prepared statement (DoPut of a parameter record batch, the same
wire exchange the reference's ODBC driver issues).
"""

from __future__ import annotations

import datetime
import time
from typing import List, Optional, Sequence, Tuple

from .. import types as T
from ..array.array import array as make_array
from ..table import Table

apilevel = "2.0"
threadsafety = 1  # threads may share the module, not connections
paramstyle = "qmark"


class Error(Exception):
    pass


class Warning(Exception):  # noqa: A001 - DB-API mandated name
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class DataError(DatabaseError):
    pass


class OperationalError(DatabaseError):
    pass


class IntegrityError(DatabaseError):
    pass


class InternalError(DatabaseError):
    pass


class ProgrammingError(DatabaseError):
    pass


class NotSupportedError(DatabaseError):
    pass


# --- type objects (PEP 249 §Type Objects) ----------------------------------

class _DBAPITypeObject:
    def __init__(self, *ids):
        self.ids = set(ids)

    def __eq__(self, other):
        return other in self.ids


STRING = _DBAPITypeObject(T.TypeId.STRING, T.TypeId.LARGE_STRING,
                          T.TypeId.STRING_VIEW)
BINARY = _DBAPITypeObject(T.TypeId.BINARY, T.TypeId.LARGE_BINARY,
                          T.TypeId.FIXED_SIZE_BINARY, T.TypeId.BINARY_VIEW)
NUMBER = _DBAPITypeObject(
    T.TypeId.INT8, T.TypeId.INT16, T.TypeId.INT32, T.TypeId.INT64,
    T.TypeId.UINT8, T.TypeId.UINT16, T.TypeId.UINT32, T.TypeId.UINT64,
    T.TypeId.HALF_FLOAT, T.TypeId.FLOAT, T.TypeId.DOUBLE,
    T.TypeId.DECIMAL128, T.TypeId.DECIMAL256, T.TypeId.BOOL)
DATETIME = _DBAPITypeObject(T.TypeId.TIMESTAMP, T.TypeId.DATE32,
                            T.TypeId.DATE64, T.TypeId.TIME32,
                            T.TypeId.TIME64)
ROWID = _DBAPITypeObject(T.TypeId.INT64)


def Date(year, month, day):
    return datetime.date(year, month, day)


def Time(hour, minute, second):
    return datetime.time(hour, minute, second)


def Timestamp(year, month, day, hour, minute, second):
    return datetime.datetime(year, month, day, hour, minute, second)


def DateFromTicks(ticks):
    return Date(*time.localtime(ticks)[:3])


def TimeFromTicks(ticks):
    return Time(*time.localtime(ticks)[3:6])


def TimestampFromTicks(ticks):
    return Timestamp(*time.localtime(ticks)[:6])


Binary = bytes


# --- connection / cursor ----------------------------------------------------

def connect(location: str = None, *, client=None) -> "Connection":
    """Open a DB-API connection to a Flight SQL endpoint, e.g.
    ``connect("grpc://host:port")``. An existing FlightSqlClient can be
    wrapped via the ``client`` keyword."""
    if client is None:
        if location is None:
            raise InterfaceError("connect() needs a location or a client")
        from .sql import FlightSqlClient
        client = FlightSqlClient(location)
    return Connection(client)


class Connection:
    def __init__(self, client):
        self._client = client
        self._closed = False

    def close(self):
        if not self._closed:
            self._closed = True
            try:
                self._client.close()
            except Exception:
                pass

    def commit(self):
        # queries are read-only / auto-committed; parity with the
        # reference ODBC driver's autocommit-only mode
        self._check()

    def rollback(self):
        raise NotSupportedError("transactions are not supported")

    def cursor(self) -> "Cursor":
        self._check()
        return Cursor(self)

    def _check(self):
        if self._closed:
            raise InterfaceError("connection is closed")

    # context manager
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # convenience introspection mirroring common DB-API extensions
    def get_tables(self) -> Table:
        self._check()
        return self._client.get_tables()


def _param_array(column: Sequence):
    vals = list(column)
    probe = next((v for v in vals if v is not None), None)
    if probe is None:
        return make_array(vals, T.null())
    if isinstance(probe, bool):
        return make_array(vals, T.bool_())
    if isinstance(probe, int):
        return make_array(vals, T.int64())
    if isinstance(probe, float):
        return make_array(vals, T.float64())
    if isinstance(probe, str):
        return make_array(vals, T.string())
    if isinstance(probe, bytes):
        return make_array(vals, T.binary())
    if isinstance(probe, datetime.datetime):
        return make_array(vals, T.timestamp("us"))
    if isinstance(probe, datetime.date):
        return make_array(vals, T.date32())
    import decimal
    if isinstance(probe, decimal.Decimal):
        scale = max(max(-v.as_tuple().exponent, 0)
                    for v in vals if v is not None)
        return make_array(vals, T.decimal128(38, scale))
    raise ProgrammingError(f"cannot bind parameter of type {type(probe)}")


class Cursor:
    arraysize = 1

    def __init__(self, connection: Connection):
        self.connection = connection
        self.description: Optional[List[Tuple]] = None
        self.rowcount = -1
        self._rows: List[tuple] = []
        self._pos = 0
        self._closed = False

    # --- execution -----------------------------------------------------
    def execute(self, operation: str, parameters: Sequence = ()) -> "Cursor":
        self._check()
        client = self.connection._client
        try:
            if parameters:
                stmt = client.prepare(operation)
                try:
                    cols = [_param_array([p]) for p in parameters]
                    names = [f"param_{i}" for i in range(len(cols))]
                    stmt.set_parameters(Table.from_arrays(cols, names))
                    result = stmt.execute()
                finally:
                    stmt.close()
            else:
                result = client.execute(operation)
        except Error:
            raise
        except Exception as e:  # surface engine errors as DatabaseError
            raise ProgrammingError(str(e)) from e
        self._load(result)
        return self

    def executemany(self, operation: str,
                    seq_of_parameters: Sequence[Sequence]) -> "Cursor":
        for parameters in seq_of_parameters:
            self.execute(operation, parameters)
        return self

    def _load(self, table: Table):
        self.description = [
            (f.name, f.type.id, None, None,
             getattr(f.type, "precision", None),
             getattr(f.type, "scale", None), f.nullable)
            for f in table.schema.fields]
        cols = [table.column(i).combine().to_pylist()
                for i in range(table.num_columns)]
        self._rows = list(zip(*cols)) if cols else []
        self.rowcount = table.num_rows
        self._pos = 0

    # --- fetch ----------------------------------------------------------
    def fetchone(self) -> Optional[tuple]:
        self._check_result()
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> List[tuple]:
        self._check_result()
        size = self.arraysize if size is None else size
        out = self._rows[self._pos:self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[tuple]:
        self._check_result()
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def fetch_arrow_table(self) -> Table:
        """ADBC-style extension: the current result set as an Arrow
        Table."""
        self._check_result()
        cols = list(zip(*self._rows)) if self._rows else []
        names = [d[0] for d in self.description or []]
        if not names:
            raise InterfaceError("no result set")
        arrays = [make_array(list(c)) for c in cols] if cols else \
            [make_array([]) for _ in names]
        return Table.from_arrays(arrays, names)

    # --- misc -------------------------------------------------------
    def setinputsizes(self, sizes):
        pass

    def setoutputsize(self, size, column=None):
        pass

    def close(self):
        self._closed = True
        self._rows = []
        self.description = None

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def _check(self):
        if self._closed:
            raise InterfaceError("cursor is closed")
        self.connection._check()

    def _check_result(self):
        self._check()
        if self.description is None:
            raise InterfaceError("no result set; call execute() first")
