"""Flight SQL: SQL-over-Flight protocol (counterpart of
``arrow_tpu/flight/sql.py``).

Reference analogue: cpp/src/arrow/flight/sql/server.h + client.h (the
FlightSql.proto wire contract is vendored). Commands travel as
protobuf.Any-wrapped FlightSql messages inside FlightDescriptors/Tickets;
results are ordinary Flight record-batch streams. The server executes
statements with the port's SQL frontend (``arrow_tpu_torch.sql``) over
registered tables, on its ``device`` (the card unless ``device="cpu"``).
A statement runs twice, as the reference's protocol has it: once in
``GetFlightInfo``, for its schema and row count, and again in ``DoGet``.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

from google.protobuf import any_pb2

from ..table import Table
from . import (FlightClient, FlightDescriptor, FlightEndpoint, FlightInfo,
               FlightServerBase, Ticket)
from .proto import FlightSql_pb2 as fsql


def _pack(msg) -> bytes:
    a = any_pb2.Any()
    a.Pack(msg)
    return a.SerializeToString()


def _unpack(data: bytes, cls):
    a = any_pb2.Any()
    a.ParseFromString(data)
    msg = cls()
    if not a.Unpack(msg):
        return None
    return msg


def _sql_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, bool):
        return "1" if v else "0"
    return repr(v)


def _bind_parameters(query: str, params) -> str:
    """Substitute positional `?` placeholders with SQL literals (the
    reference binds parameters inside the server's own engine,
    flight/sql/server.h DoPutPreparedStatementQuery; this frontend folds
    them into the statement text). A ``?`` inside a quoted literal
    (``'...'``, a quote doubled within it) or a quoted name (``"..."``)
    is text. Raises ValueError where the parameters are more or fewer
    than the placeholders."""
    params = list(params or ())
    out, used, quote = [], 0, None
    for ch in query:
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "?":
            if used == len(params):
                raise ValueError(f"the statement has more placeholders "
                                 f"than its {len(params)} parameters")
            ch = _sql_literal(params[used])
            used += 1
        out.append(ch)
    if used != len(params):
        raise ValueError(f"the statement has {used} placeholders but "
                         f"{len(params)} parameters")
    return "".join(out)


class FlightSqlServer(FlightServerBase):
    """Executes SQL statements over registered tables.

    Supported commands: CommandStatementQuery (+ TicketStatementQuery),
    CommandPreparedStatementQuery with DoPut parameter binding,
    CreatePreparedStatement / ClosePreparedStatement actions,
    CommandGetTables, CommandGetDbSchemas, CommandGetTableTypes,
    CommandGetCatalogs, CommandGetPrimaryKeys, CommandGetSqlInfo
    (reference surface: flight/sql/server.h)."""

    def __init__(self, location: str = "grpc://127.0.0.1:0",
                 tables: Optional[Dict[str, Table]] = None, device=None):
        super().__init__(location)
        self.tables: Dict[str, Table] = dict(tables or {})
        self.device = device
        self._prepared: Dict[bytes, str] = {}
        self._params: Dict[bytes, list] = {}
        # the prepared handles' numbers: handlers run on several threads,
        # and each handle must go to one statement
        self._handles = itertools.count()

    def register_table(self, name: str, table: Table):
        self.tables[name] = table

    def _execute(self, query: str) -> Table:
        from .. import sql as attsql
        return attsql.query(query, self.tables, device=self.device)

    # Flight overrides ----------------------------------------------------
    def get_flight_info(self, descriptor: FlightDescriptor) -> FlightInfo:
        cmd = _unpack(descriptor.command, fsql.CommandStatementQuery)
        if cmd is not None:
            result = self._execute(cmd.query)
            ticket = fsql.TicketStatementQuery()
            ticket.statement_handle = cmd.query.encode()
            return FlightInfo(result.schema, descriptor,
                              [FlightEndpoint(_pack(ticket))],
                              result.num_rows, -1)
        pq = _unpack(descriptor.command, fsql.CommandPreparedStatementQuery)
        if pq is not None and pq.prepared_statement_handle in self._prepared:
            q = _bind_parameters(
                self._prepared[pq.prepared_statement_handle],
                self._params.get(pq.prepared_statement_handle))
            result = self._execute(q)
            return FlightInfo(result.schema, descriptor,
                              [FlightEndpoint(descriptor.command)],
                              result.num_rows, -1)
        for cls in (fsql.CommandGetTables, fsql.CommandGetCatalogs,
                    fsql.CommandGetDbSchemas, fsql.CommandGetTableTypes,
                    fsql.CommandGetPrimaryKeys, fsql.CommandGetSqlInfo):
            if _unpack(descriptor.command, cls) is not None:
                return FlightInfo(
                    self._metadata_table(cls).schema, descriptor,
                    [FlightEndpoint(descriptor.command)], -1, -1)
        raise NotImplementedError("unsupported FlightSql command")

    def do_get(self, ticket: Ticket) -> Table:
        tq = _unpack(ticket.ticket, fsql.TicketStatementQuery)
        if tq is not None:
            return self._execute(tq.statement_handle.decode())
        pq = _unpack(ticket.ticket, fsql.CommandPreparedStatementQuery)
        if pq is not None and pq.prepared_statement_handle in self._prepared:
            return self._execute(_bind_parameters(
                self._prepared[pq.prepared_statement_handle],
                self._params.get(pq.prepared_statement_handle)))
        for cls in (fsql.CommandGetTables, fsql.CommandGetCatalogs,
                    fsql.CommandGetDbSchemas, fsql.CommandGetTableTypes,
                    fsql.CommandGetPrimaryKeys, fsql.CommandGetSqlInfo):
            if _unpack(ticket.ticket, cls) is not None:
                return self._metadata_table(cls)
        raise NotImplementedError("unsupported FlightSql ticket")

    def do_action(self, action_type: str, body: bytes):
        if action_type == "CreatePreparedStatement":
            req = _unpack(body, fsql.ActionCreatePreparedStatementRequest)
            handle = f"stmt{next(self._handles)}".encode()
            self._prepared[handle] = req.query
            res = fsql.ActionCreatePreparedStatementResult()
            res.prepared_statement_handle = handle
            return [_pack(res)]
        if action_type == "ClosePreparedStatement":
            req = _unpack(body, fsql.ActionClosePreparedStatementRequest)
            self._prepared.pop(req.prepared_statement_handle, None)
            self._params.pop(req.prepared_statement_handle, None)
            return []
        raise NotImplementedError(f"action {action_type!r}")

    def list_actions(self):
        return [("CreatePreparedStatement", "prepare a SQL statement"),
                ("ClosePreparedStatement", "release a prepared handle")]

    def do_put(self, descriptor: FlightDescriptor, table: Table):
        """Parameter binding: the client DoPuts a one-row batch of
        positional parameter values for a prepared handle."""
        pq = _unpack(descriptor.command, fsql.CommandPreparedStatementQuery)
        if pq is None or pq.prepared_statement_handle not in self._prepared:
            raise NotImplementedError("DoPut expects a prepared handle")
        d = table.to_pydict()
        self._params[pq.prepared_statement_handle] = [
            d[name][0] for name in table.column_names]

    def _metadata_table(self, cls) -> Table:
        if cls is fsql.CommandGetTables:
            return self._tables_table()
        if cls is fsql.CommandGetCatalogs:
            return self._catalogs_table()
        if cls is fsql.CommandGetDbSchemas:
            return self._db_schemas_table()
        if cls is fsql.CommandGetTableTypes:
            return self._table_types_table()
        if cls is fsql.CommandGetPrimaryKeys:
            return self._primary_keys_table()
        return self._sql_info_table()

    def _tables_table(self) -> Table:
        from ..table import table
        names = sorted(self.tables)
        return table({
            "catalog_name": [""] * len(names),
            "db_schema_name": [""] * len(names),
            "table_name": names,
            "table_type": ["TABLE"] * len(names),
        })

    def _catalogs_table(self) -> Table:
        from ..table import table
        return table({"catalog_name": [""]})

    def _db_schemas_table(self) -> Table:
        from ..table import table
        return table({"catalog_name": [""], "db_schema_name": ["main"]})

    def _table_types_table(self) -> Table:
        from ..table import table
        return table({"table_type": ["TABLE"]})

    def _primary_keys_table(self) -> Table:
        from .. import types as T
        from ..array.array import array as make_array
        from ..table import table
        names = ["catalog_name", "db_schema_name", "table_name",
                 "column_name", "key_name"]
        cols = {n: make_array([], T.string()) for n in names}
        cols["key_sequence"] = make_array([], T.int32())
        return table(cols)

    def _sql_info_table(self) -> Table:
        """GetSqlInfo result: info_name uint32 + dense-union value column
        (string/bool/bigint arms populated; flight/sql protocol schema)."""
        import numpy as np

        from .. import types as T
        from ..array.array import Array
        from ..array.array import array as make_array
        from ..config import build_info
        from ..table import table

        infos = [
            (fsql.FLIGHT_SQL_SERVER_NAME, "arrow_tpu_torch"),
            (fsql.FLIGHT_SQL_SERVER_VERSION, build_info().version),
            (fsql.FLIGHT_SQL_SERVER_ARROW_VERSION, build_info().version),
            (fsql.FLIGHT_SQL_SERVER_READ_ONLY, True),
            (fsql.SQL_DDL_CATALOG, False),
            (fsql.SQL_DDL_SCHEMA, False),
            (fsql.SQL_DDL_TABLE, False),
            (fsql.SQL_MAX_COLUMNS_IN_TABLE, 10_000),
        ]
        strings, bools, bigints = [], [], []
        type_ids = np.zeros(len(infos), np.int8)
        offsets = np.zeros(len(infos), np.int32)
        for i, (_, v) in enumerate(infos):
            if isinstance(v, str):
                type_ids[i], offsets[i] = 0, len(strings)
                strings.append(v)
            elif isinstance(v, bool):
                type_ids[i], offsets[i] = 1, len(bools)
                bools.append(v)
            else:
                type_ids[i], offsets[i] = 2, len(bigints)
                bigints.append(v)
        ut = T.dense_union(
            [T.field("string_value", T.string()),
             T.field("bool_value", T.bool_()),
             T.field("bigint_value", T.int64())], [0, 1, 2])
        value = Array.from_buffers(
            ut, len(infos), [type_ids, offsets], null_count=0,
            children=[make_array(strings, T.string()),
                      make_array(bools, T.bool_()),
                      make_array(bigints, T.int64())])
        return table({
            "info_name": make_array(
                np.asarray([n for n, _ in infos], np.uint32)),
            "value": value,
        })


class FlightSqlClient:
    """A Flight SQL client. Each call takes pyarrow's ``options``
    (FlightCallOptions: the call's deadline and headers); a statement's
    ``execute`` passes them to both of its calls."""

    def __init__(self, location: str):
        self._client = FlightClient(location)

    def execute(self, query: str, options=None) -> Table:
        cmd = fsql.CommandStatementQuery()
        cmd.query = query
        desc = FlightDescriptor.for_command(_pack(cmd))
        info = self._client.get_flight_info(desc, options)
        return self._client.do_get(info.endpoints[0].ticket, options)

    def _command(self, cmd, options) -> Table:
        return self._client.do_get(Ticket(_pack(cmd)), options)

    def get_tables(self, options=None) -> Table:
        return self._command(fsql.CommandGetTables(), options)

    def get_catalogs(self, options=None) -> Table:
        return self._command(fsql.CommandGetCatalogs(), options)

    def get_db_schemas(self, options=None) -> Table:
        return self._command(fsql.CommandGetDbSchemas(), options)

    def get_table_types(self, options=None) -> Table:
        return self._command(fsql.CommandGetTableTypes(), options)

    def get_sql_info(self, info=(), options=None) -> Table:
        cmd = fsql.CommandGetSqlInfo()
        cmd.info.extend(info)
        return self._command(cmd, options)

    def get_primary_keys(self, table: str = "", options=None) -> Table:
        cmd = fsql.CommandGetPrimaryKeys()
        cmd.table = table
        return self._command(cmd, options)

    def prepare(self, query: str, options=None) -> "PreparedStatement":
        req = fsql.ActionCreatePreparedStatementRequest()
        req.query = query
        results = self._client.do_action("CreatePreparedStatement",
                                         _pack(req), options)
        res = _unpack(results[0], fsql.ActionCreatePreparedStatementResult)
        return PreparedStatement(self, res.prepared_statement_handle)

    def close(self):
        self._client.close()


class PreparedStatement:
    """Client handle for a server-side prepared statement
    (reference: flight/sql/client.h PreparedStatement)."""

    def __init__(self, client: FlightSqlClient, handle: bytes):
        self._sql = client
        self.handle = handle

    def _command(self):
        cmd = fsql.CommandPreparedStatementQuery()
        cmd.prepared_statement_handle = self.handle
        return cmd

    def set_parameters(self, table: Table, options=None):
        desc = FlightDescriptor.for_command(_pack(self._command()))
        self._sql._client.do_put(desc, table, options)

    def execute(self, options=None) -> Table:
        desc = FlightDescriptor.for_command(_pack(self._command()))
        info = self._sql._client.get_flight_info(desc, options)
        return self._sql._client.do_get(info.endpoints[0].ticket, options)

    def close(self, options=None):
        req = fsql.ActionClosePreparedStatementRequest()
        req.prepared_statement_handle = self.handle
        self._sql._client.do_action("ClosePreparedStatement", _pack(req),
                                    options)
