"""Arrow Flight RPC (gRPC data plane), the counterpart of
``arrow_tpu/flight/``.

Reference analogue: cpp/src/arrow/flight/ (FlightServerBase server.h:248,
FlightClient client.h). The wire protocol (vendored format/Flight.proto,
``proto/``) is the compatibility contract: streams carry IPC record
batches inside FlightData frames, so any Arrow Flight implementation can
exchange data with this engine over the network. Tables travel as host
Tables; a handler that runs a plan runs it on the device it names (the
card unless ``device="cpu"``).

The generated message modules are imported from this package
(``flight.proto``), never as top-level modules: a process that has also
loaded another copy of ``Flight_pb2`` keeps the two apart.

A client call that fails with a gRPC status raises the Flight error of
that status (``FlightUnauthenticatedError`` for UNAUTHENTICATED, ...),
which is also a ``grpc.RpcError`` with its ``code()`` and ``details()``.
Each client call takes pyarrow's ``options=FlightCallOptions(...)``: its
``timeout`` (seconds) is the call's deadline and its ``headers`` go with
the call.
"""

from __future__ import annotations

import contextlib
from concurrent import futures
from typing import Dict, Iterator, List, Optional, Tuple

import grpc

from .proto import Flight_pb2 as fp

from ..ipc.message import parse_message_meta, \
    serialize_record_batch_parts, serialize_schema_message
from ..ipc.reader_writer import RecordBatchStreamReader, \
    _attach_dictionaries, _collect_dictionaries
from ..ipc import fb as _fb
from ..ipc.message import ArrayLoader, RecordBatchMeta, \
    serialize_dictionary_batch
from ..ipc.schema_fb import DictionaryFieldMapper, read_schema
from ..array.array import Array
from ..table import RecordBatch, Table
from ..types import Schema

_SERVICE = "arrow.flight.protocol.FlightService"


class FlightDescriptor:
    PATH = fp.FlightDescriptor.PATH
    CMD = fp.FlightDescriptor.CMD
    # class-level defaults (pyarrow exposes these as properties)
    descriptor_type = None
    path = None
    command = None

    def __init__(self, dtype, path=None, cmd=None):
        self.descriptor_type = dtype
        self.path = list(path) if path else []
        self.command = cmd

    @classmethod
    def for_path(cls, *path) -> "FlightDescriptor":
        return cls(cls.PATH, path=[p if isinstance(p, bytes)
                                   else p.encode() for p in path])

    @classmethod
    def for_command(cls, cmd) -> "FlightDescriptor":
        return cls(cls.CMD, cmd=cmd if isinstance(cmd, bytes)
                   else cmd.encode())

    def to_pb(self) -> fp.FlightDescriptor:
        d = fp.FlightDescriptor()
        d.type = self.descriptor_type
        if self.descriptor_type == self.PATH:
            d.path.extend([p.decode() for p in self.path])
        else:
            d.cmd = self.command or b""
        return d

    @classmethod
    def from_pb(cls, d) -> "FlightDescriptor":
        if d.type == fp.FlightDescriptor.PATH:
            return cls.for_path(*d.path)
        return cls.for_command(d.cmd)

    def serialize(self) -> bytes:
        return self.to_pb().SerializeToString()

    @classmethod
    def deserialize(cls, serialized: bytes) -> "FlightDescriptor":
        d = fp.FlightDescriptor()
        d.ParseFromString(bytes(serialized))
        return cls.from_pb(d)

    def __repr__(self):
        if self.descriptor_type == self.PATH:
            return f"FlightDescriptor(path={self.path})"
        return f"FlightDescriptor(cmd={self.command})"


class Ticket:
    def __init__(self, ticket: bytes):
        self.ticket = ticket if isinstance(ticket, bytes) \
            else ticket.encode()


class FlightEndpoint:
    def __init__(self, ticket, locations=()):
        self.ticket = ticket if isinstance(ticket, Ticket) \
            else Ticket(ticket)
        self.locations = list(locations)


class FlightInfo:
    # class-level defaults (pyarrow exposes these as properties)
    schema = None
    descriptor = None
    endpoints = None
    total_records = -1
    total_bytes = -1
    ordered = False
    app_metadata = b""

    def __init__(self, schema: Schema, descriptor: FlightDescriptor,
                 endpoints: List[FlightEndpoint],
                 total_records: int = -1, total_bytes: int = -1,
                 ordered: bool = False, app_metadata: bytes = b""):
        self.schema = schema
        self.descriptor = descriptor
        self.endpoints = endpoints
        self.total_records = total_records
        self.total_bytes = total_bytes
        self.ordered = ordered
        self.app_metadata = app_metadata

    def serialize(self) -> bytes:
        return self.to_pb().SerializeToString()

    @classmethod
    def from_pb(cls, pb) -> "FlightInfo":
        rdr = RecordBatchStreamReader(pb.schema)
        endpoints = [FlightEndpoint(Ticket(e.ticket.ticket))
                     for e in pb.endpoint]
        return cls(rdr.schema,
                   FlightDescriptor.from_pb(pb.flight_descriptor),
                   endpoints, pb.total_records, pb.total_bytes)

    @classmethod
    def deserialize(cls, serialized: bytes) -> "FlightInfo":
        pb = fp.FlightInfo()
        pb.ParseFromString(bytes(serialized))
        return cls.from_pb(pb)

    def to_pb(self) -> fp.FlightInfo:
        out = fp.FlightInfo()
        mapper = DictionaryFieldMapper()
        out.schema = serialize_schema_message(self.schema, mapper)
        out.flight_descriptor.CopyFrom(self.descriptor.to_pb())
        for ep in self.endpoints:
            e = out.endpoint.add()
            e.ticket.ticket = ep.ticket.ticket
        out.total_records = self.total_records
        out.total_bytes = self.total_bytes
        return out


# --- IPC <-> FlightData framing -------------------------------------------

def _strip_framing(framed: bytes) -> bytes:
    """Remove the <continuation><len> prefix: FlightData.data_header is the
    bare flatbuffer message."""
    import struct
    (word,) = struct.unpack_from("<I", framed, 0)
    if word == 0xFFFFFFFF:
        (ln,) = struct.unpack_from("<I", framed, 4)
        return framed[8:8 + ln]
    return framed[4:4 + word]


class _FD:
    """FlightData stand-in, hand-encoded to/from the protobuf wire
    format (format/Flight.proto FlightData: flight_descriptor=1,
    data_header=2, app_metadata=3, data_body=1000). The reference
    bypasses protobuf for exactly this message to avoid copying
    multi-MB bodies (flight/serialization_internal.cc); here the custom
    codec saves protobuf's copy-in + copy-out per direction and parses
    bodies as zero-copy memoryviews."""

    __slots__ = ("descriptor", "data_header", "app_metadata",
                 "data_body")

    def __init__(self, descriptor=None, data_header=b"",
                 app_metadata=b"", data_body=b""):
        self.descriptor = descriptor  # serialized FlightDescriptor
        self.data_header = data_header
        self.app_metadata = app_metadata
        self.data_body = data_body


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data, pos: int):
    v = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, pos
        shift += 7


_BODY_TAG = _varint((1000 << 3) | 2)


# Shared channel/server tuning (reference: flight C++ sets analogous
# grpc args in server.cc/client.cc). The HTTP/2 knobs matter most for
# localhost bulk streams: bigger frames + BDP-free static windows cut
# per-frame framing and flow-control stalls.
_GRPC_PERF_OPTIONS = (
    ("grpc.max_send_message_length", -1),
    ("grpc.max_receive_message_length", -1),
    ("grpc.http2.max_frame_size", 8 * 1024 * 1024),
    ("grpc.http2.write_buffer_size", 16 * 1024 * 1024),
    ("grpc.http2.lookahead_bytes", 64 * 1024 * 1024),
    ("grpc.http2.bdp_probe", 0),
)


def _fd_serialize(fd: "_FD") -> bytes:
    """data_body may be bytes OR a list of buffer views: the views are
    joined directly into the wire frame, so each body byte is copied
    exactly once here (writev-style; the reference's zero-copy
    serializer plays the same trick, flight/serialization_internal.cc)."""
    parts = []
    if fd.descriptor:
        parts += [b"\x0a", _varint(len(fd.descriptor)), fd.descriptor]
    if fd.data_header:
        parts += [b"\x12", _varint(len(fd.data_header)), fd.data_header]
    if fd.app_metadata:
        parts += [b"\x1a", _varint(len(fd.app_metadata)),
                  fd.app_metadata]
    body = fd.data_body
    if body is not None and not isinstance(body, (bytes, bytearray,
                                                  memoryview)):
        blen = sum(len(p) for p in body)
        if blen:
            parts += [_BODY_TAG, _varint(blen)]
            parts += [p if isinstance(p, bytes) else bytes(p)
                      for p in body]
    elif body:
        parts += [_BODY_TAG, _varint(len(body)), body]
    return b"".join(parts)


def _fd_parse(data: bytes) -> "_FD":
    fd = _FD()
    mv = memoryview(data)
    pos, end = 0, len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 2:
            ln, pos = _read_varint(data, pos)
            if field == 1:
                fd.descriptor = bytes(mv[pos:pos + ln])
            elif field == 2:
                fd.data_header = bytes(mv[pos:pos + ln])
            elif field == 3:
                fd.app_metadata = bytes(mv[pos:pos + ln])
            elif field == 1000:
                fd.data_body = mv[pos:pos + ln]  # zero-copy
            pos += ln
        elif wt == 0:
            _, pos = _read_varint(data, pos)
        elif wt == 5:
            pos += 4
        elif wt == 1:
            pos += 8
        else:
            raise ValueError(f"bad wire type {wt} in FlightData")
    return fd


def _table_to_flight_datas(tbl: Table) -> Iterator["_FD"]:
    mapper = DictionaryFieldMapper()
    schema_msg = serialize_schema_message(tbl.schema, mapper)
    yield _FD(data_header=_strip_framing(schema_msg))
    # stream in <=256Ki-row chunks: large enough to amortize
    # python-grpc per-message overhead, small enough to pipeline
    # (measured optimum on localhost; 1Mi-row chunks LOSE ~20% to
    # reduced overlap); bodies ride as buffer-view lists so
    # _fd_serialize copies each byte once
    for rb in tbl.to_batches(max_chunksize=1 << 18):
        dicts = []
        for col in rb.columns:
            _collect_dictionaries(col.data, dicts)
        for did, dd in zip(mapper.ordered_ids, dicts):
            meta, body = serialize_dictionary_batch(did, dd)
            yield _FD(data_header=_strip_framing(meta), data_body=body)
        meta, parts = serialize_record_batch_parts(
            [c.data for c in rb.columns], rb.num_rows)
        yield _FD(data_header=_strip_framing(meta), data_body=parts)


class _FlightStreamAssembler:
    """Rebuild RecordBatches from a FlightData stream."""

    def __init__(self):
        self.schema: Optional[Schema] = None
        self.mapper = DictionaryFieldMapper()
        self.memo: Dict[int, object] = {}
        self._memo_bytes: Dict[int, bytes] = {}
        self.descriptor: Optional[FlightDescriptor] = None

    def feed(self, fd: "_FD") -> Optional[RecordBatch]:
        if fd.descriptor:
            self.descriptor = FlightDescriptor.from_pb(
                fp.FlightDescriptor.FromString(fd.descriptor))
        if not fd.data_header:
            return None
        htype, header, body_len = parse_message_meta(fd.data_header)
        body = fd.data_body
        if htype == _fb.MSG_SCHEMA:
            self.schema = read_schema(header, self.mapper)
            return None
        if htype == _fb.MSG_DICTIONARY_BATCH:
            did = header.i64(0)
            # the sender repeats each batch's dictionaries: the same bytes
            # again keep the memo's object, so the batches share one
            # dictionary (and concatenate by their indices)
            key = bytes(fd.data_header) + bytes(body)
            if self._memo_bytes.get(did) == key:
                return None
            self._memo_bytes[did] = key
            meta = RecordBatchMeta(header.table(1))
            loader = ArrayLoader(meta, body)
            vtype = self.mapper.id_to_type[did].value_type
            self.memo[did] = loader.load(vtype)
            return None
        if htype == _fb.MSG_RECORD_BATCH:
            meta = RecordBatchMeta(header)
            loader = ArrayLoader(meta, body)
            cols = [loader.load(f.type) for f in self.schema.fields]
            pos = [0]
            for c in cols:
                _attach_dictionaries(c, self.mapper.ordered_ids,
                                     self.memo, pos)
            return RecordBatch(self.schema, [Array(c) for c in cols])
        raise ValueError(f"unexpected flight message type {htype}")


# --- auth -------------------------------------------------------------------

class ServerAuthHandler:
    """Handshake-based authentication (reference: flight/server_auth.h).
    authenticate() maps credentials to a bearer token; is_valid() checks
    the token presented on later calls and returns the peer identity."""

    def authenticate(self, payload: bytes) -> bytes:
        raise NotImplementedError

    def is_valid(self, token: bytes) -> Optional[str]:
        raise NotImplementedError


class BasicServerAuthHandler(ServerAuthHandler):
    """Username/password handshake issuing opaque bearer tokens
    (reference: flight/auth handling of BasicAuth payloads)."""

    def __init__(self, credentials: Dict[str, str]):
        self.credentials = dict(credentials)
        self._tokens: Dict[bytes, str] = {}

    def authenticate(self, payload: bytes) -> bytes:
        import secrets
        ba = fp.BasicAuth()
        ba.ParseFromString(payload)
        if self.credentials.get(ba.username) != ba.password:
            raise PermissionError("invalid username/password")
        token = secrets.token_urlsafe(16).encode()
        self._tokens[token] = ba.username
        return token

    def is_valid(self, token: bytes) -> Optional[str]:
        return self._tokens.get(token)


# --- server ----------------------------------------------------------------

def _wants_context(fn) -> bool:
    """True when a handler uses the pyarrow signature whose first
    positional parameter is the ServerCallContext (flight/server.h
    handlers all receive `const ServerCallContext&` first). Detected by
    parameter name so both the compact no-context signatures and the
    pyarrow ones are accepted."""
    import inspect
    try:
        params = [p for p in inspect.signature(fn).parameters.values()
                  if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    except (TypeError, ValueError):
        return False
    return bool(params) and params[0].name == "context"


def _result_to_table(out) -> Optional[Table]:
    """Normalize a do_get/do_exchange return value: Table,
    FlightDataStream (RecordBatchStream/GeneratorStream), or reader."""
    if out is None or isinstance(out, Table):
        return out
    if hasattr(out, "to_table"):
        return out.to_table()
    if hasattr(out, "read_all"):
        return out.read_all()
    return out


class FlightServerBase:
    """Subclass and override list_flights / get_flight_info / do_get /
    do_put / do_exchange / do_action / list_actions (reference:
    flight/server.h:248). Handlers may use either the pyarrow
    signatures (context first, e.g. ``do_get(self, context, ticket)``
    returning a FlightDataStream) or the compact ones without context
    returning a Table."""

    port = 0  # bound port (set at construction)

    def __init__(self, location: str = "grpc://0.0.0.0:0",
                 auth_handler: Optional[ServerAuthHandler] = None,
                 tls_certificates=None, middleware=None):
        """``tls_certificates``: list of (cert_chain_pem, private_key_pem)
        pairs enables TLS (reference: flight/server.h FlightServerOptions
        tls_certificates); use a grpc+tls:// location with it.
        ``middleware``: dict name -> ServerMiddlewareFactory; handlers
        reach per-call instances via context.get_middleware(name)
        (server_middleware.h)."""
        self._location = location
        self.auth_handler = auth_handler
        self._middleware = dict(middleware or {})
        self._pool = futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="flight-server")
        self._server = grpc.server(self._pool, options=_GRPC_PERF_OPTIONS)

        def stream(fn, method):
            return self._mw_wrap_stream(fn, method)

        handlers = {
            "Handshake": grpc.stream_stream_rpc_method_handler(
                stream(self._handshake, FlightMethod.HANDSHAKE),
                request_deserializer=fp.HandshakeRequest.FromString,
                response_serializer=fp.HandshakeResponse.SerializeToString),
            "DoExchange": grpc.stream_stream_rpc_method_handler(
                stream(self._do_exchange, FlightMethod.DO_EXCHANGE),
                request_deserializer=_fd_parse,
                response_serializer=_fd_serialize),
            "ListFlights": grpc.unary_stream_rpc_method_handler(
                stream(self._list_flights, FlightMethod.LIST_FLIGHTS),
                request_deserializer=fp.Criteria.FromString,
                response_serializer=fp.FlightInfo.SerializeToString),
            "GetFlightInfo": grpc.unary_unary_rpc_method_handler(
                self._mw_wrap_unary(self._get_flight_info,
                                    FlightMethod.GET_FLIGHT_INFO),
                request_deserializer=fp.FlightDescriptor.FromString,
                response_serializer=fp.FlightInfo.SerializeToString),
            "GetSchema": grpc.unary_unary_rpc_method_handler(
                self._mw_wrap_unary(self._get_schema,
                                    FlightMethod.GET_SCHEMA),
                request_deserializer=fp.FlightDescriptor.FromString,
                response_serializer=fp.SchemaResult.SerializeToString),
            "DoGet": grpc.unary_stream_rpc_method_handler(
                stream(self._do_get, FlightMethod.DO_GET),
                request_deserializer=fp.Ticket.FromString,
                response_serializer=_fd_serialize),
            "DoPut": grpc.stream_stream_rpc_method_handler(
                stream(self._do_put, FlightMethod.DO_PUT),
                request_deserializer=_fd_parse,
                response_serializer=fp.PutResult.SerializeToString),
            "DoAction": grpc.unary_stream_rpc_method_handler(
                stream(self._do_action, FlightMethod.DO_ACTION),
                request_deserializer=fp.Action.FromString,
                response_serializer=fp.Result.SerializeToString),
            "ListActions": grpc.unary_stream_rpc_method_handler(
                stream(self._list_actions, FlightMethod.LIST_ACTIONS),
                request_deserializer=fp.Empty.FromString,
                response_serializer=fp.ActionType.SerializeToString),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),))
        host_port = location.replace("grpc://", "").replace(
            "grpc+tcp://", "").replace("grpc+tls://", "")
        if tls_certificates:
            creds = grpc.ssl_server_credentials(
                [(key, cert) for cert, key in tls_certificates])
            self.port = self._server.add_secure_port(host_port, creds)
        else:
            self.port = self._server.add_insecure_port(host_port)

    # -- overridables --
    def list_flights(self, criteria: bytes) -> Iterator[FlightInfo]:
        return iter(())

    def get_flight_info(self, descriptor: FlightDescriptor) -> FlightInfo:
        raise NotImplementedError

    def do_get(self, ticket: Ticket) -> Table:
        raise NotImplementedError

    def get_schema(self, context_or_descriptor, descriptor=None):
        """Default GetSchema: derive from get_flight_info
        (server.h:318 GetSchema)."""
        d = descriptor if descriptor is not None else \
            context_or_descriptor
        if _wants_context(self.get_flight_info):
            ctx = (context_or_descriptor if descriptor is not None
                   else ServerCallContext())
            return self.get_flight_info(ctx, d).schema
        return self.get_flight_info(d).schema

    def do_put(self, descriptor: FlightDescriptor, table: Table):
        raise NotImplementedError

    def do_exchange(self, descriptor: FlightDescriptor,
                    table: Optional[Table]) -> Table:
        """Bidirectional stream: receives the client's table, returns the
        table to stream back (reference: server.h DoExchange)."""
        raise NotImplementedError

    def do_action(self, action_type: str, body: bytes) -> List[bytes]:
        raise NotImplementedError(f"action {action_type!r}")

    def list_actions(self) -> List[Tuple[str, str]]:
        return []

    # -- middleware lifecycle --
    def _mw_start(self, method: int, context):
        """Start one instance per registered factory; send their headers
        as initial metadata (deferred for Handshake, whose auth path
        sends its own — merged there)."""
        if not self._middleware:
            return {}
        try:
            headers = {k: v for k, v in context.invocation_metadata()}
        except Exception:
            headers = {}
        info = CallInfo(method)
        insts = {}
        send = []
        for name, fac in self._middleware.items():
            inst = fac.start_call(info, headers)
            if inst is not None:
                insts[name] = inst
                for k, v in _headers_items(inst.sending_headers()):
                    send.append((str(k).lower(), v))
        context._at_middleware = insts
        if send:
            if method == FlightMethod.HANDSHAKE:
                context._at_pending_headers = send
            else:
                try:
                    context.send_initial_metadata(tuple(send))
                except Exception:
                    pass
        return insts

    @staticmethod
    def _mw_end(context, exc: Optional[BaseException]):
        for inst in getattr(context, "_at_middleware", {}).values():
            try:
                inst.call_completed(exc)
            except Exception:
                pass

    def _mw_wrap_stream(self, fn, method: int):
        def handler(request, context):
            self._mw_start(method, context)
            try:
                yield from fn(request, context)
            except BaseException as e:
                self._mw_end(context, e)
                raise
            self._mw_end(context, None)
        return handler

    def _mw_wrap_unary(self, fn, method: int):
        def handler(request, context):
            self._mw_start(method, context)
            try:
                out = fn(request, context)
            except BaseException as e:
                self._mw_end(context, e)
                raise
            self._mw_end(context, None)
            return out
        return handler

    # -- grpc glue --
    def _make_ctx(self, context) -> "ServerCallContext":
        headers = {}
        try:
            headers = {k: v for k, v in context.invocation_metadata()}
        except Exception:
            pass
        return ServerCallContext(
            peer=context.peer(), headers=headers,
            middleware=getattr(context, "_at_middleware", None))

    def _check_auth(self, context):
        if self.auth_handler is None:
            return
        token = None
        for k, v in context.invocation_metadata():
            if k == "authorization":
                val = v.encode() if isinstance(v, str) else v
                if val.startswith(b"Bearer "):
                    token = val[7:]
        peer = self.auth_handler.is_valid(token) \
            if token is not None else None
        if peer is None:
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "invalid token")

    def _handshake(self, request_iterator, context):
        # header-based flow (reference: client.h AuthenticateBasicToken):
        # "authorization: Basic <b64>" in, "authorization: Bearer <t>" out
        basic = None
        for k, v in context.invocation_metadata():
            if k == "authorization":
                val = v if isinstance(v, str) else v.decode()
                if val.startswith("Basic "):
                    basic = val[6:]
        if basic is not None and self.auth_handler is not None:
            import base64
            user, _, pw = base64.b64decode(basic).decode().partition(":")
            ba = fp.BasicAuth()
            ba.username = user
            ba.password = pw
            try:
                token = self.auth_handler.authenticate(
                    ba.SerializeToString())
            except PermissionError as e:
                context.abort(grpc.StatusCode.UNAUTHENTICATED, str(e))
            pending = list(getattr(context, "_at_pending_headers", []))
            context.send_initial_metadata(tuple(
                pending + [("authorization", "Bearer " + token.decode())]))
        elif getattr(context, "_at_pending_headers", None):
            try:
                context.send_initial_metadata(
                    tuple(context._at_pending_headers))
            except Exception:
                pass
        got_any = False
        for req in request_iterator:
            got_any = True
            resp = fp.HandshakeResponse()
            if self.auth_handler is not None and req.payload:
                try:
                    resp.payload = self.auth_handler.authenticate(
                        req.payload)
                except PermissionError as e:
                    context.abort(grpc.StatusCode.UNAUTHENTICATED, str(e))
            yield resp
        if not got_any:
            yield fp.HandshakeResponse()

    def _do_exchange(self, request_iterator, context):
        self._check_auth(context)
        asm = _FlightStreamAssembler()
        batches = []
        for fd in request_iterator:
            rb = asm.feed(fd)
            if rb is not None:
                batches.append(rb)
        tbl_in = Table.from_batches(batches, asm.schema) \
            if asm.schema is not None else None
        if _wants_context(self.do_exchange):
            chunks = [FlightStreamChunk(b, None) for b in batches]
            reader = MetadataRecordBatchReader(chunks)
            reader.schema = asm.schema
            writer = MetadataRecordBatchWriter()
            if asm.schema is not None:
                writer.begin(asm.schema)
            self.do_exchange(self._make_ctx(context), asm.descriptor,
                             reader, writer)
            if writer._batches:
                schema = getattr(writer, "schema", None) or \
                    writer._batches[0].schema
                out = Table.from_batches(writer._batches, schema)
                yield from _table_to_flight_datas(out)
            return
        out = _result_to_table(self.do_exchange(asm.descriptor, tbl_in))
        if out is not None:
            yield from _table_to_flight_datas(out)

    def _list_flights(self, request, context):
        self._check_auth(context)
        if _wants_context(self.list_flights):
            infos = self.list_flights(self._make_ctx(context),
                                      request.expression)
        else:
            infos = self.list_flights(request.expression)
        for info in infos:
            yield info.to_pb()

    def _get_flight_info(self, request, context):
        self._check_auth(context)
        desc = FlightDescriptor.from_pb(request)
        if _wants_context(self.get_flight_info):
            return self.get_flight_info(self._make_ctx(context),
                                        desc).to_pb()
        return self.get_flight_info(desc).to_pb()

    def _get_schema(self, request, context):
        self._check_auth(context)
        desc = FlightDescriptor.from_pb(request)
        if _wants_context(self.get_schema):
            res = self.get_schema(self._make_ctx(context), desc)
        else:
            res = self.get_schema(desc)
        schema = res.schema if isinstance(res, SchemaResult) else res
        mapper = DictionaryFieldMapper()
        out = fp.SchemaResult()
        out.schema = serialize_schema_message(schema, mapper)
        return out

    def _do_get(self, request, context):
        self._check_auth(context)
        if _wants_context(self.do_get):
            out = self.do_get(self._make_ctx(context),
                              Ticket(request.ticket))
        else:
            out = self.do_get(Ticket(request.ticket))
        yield from _table_to_flight_datas(_result_to_table(out))

    def _do_put(self, request_iterator, context):
        self._check_auth(context)
        asm = _FlightStreamAssembler()
        batches = []
        for fd in request_iterator:
            rb = asm.feed(fd)
            if rb is not None:
                batches.append(rb)
        if _wants_context(self.do_put):
            chunks = [FlightStreamChunk(b, None) for b in batches]
            reader = MetadataRecordBatchReader(chunks)
            reader.schema = asm.schema
            writer = FlightMetadataWriter()
            self.do_put(self._make_ctx(context), asm.descriptor, reader,
                        writer)
            if writer.messages:
                for m in writer.messages:
                    pr = fp.PutResult()
                    if hasattr(m, "to_pybytes"):
                        m = m.to_pybytes()
                    pr.app_metadata = bytes(m)
                    yield pr
                return
            yield fp.PutResult()
            return
        tbl = Table.from_batches(batches) if batches else None
        self.do_put(asm.descriptor, tbl)
        yield fp.PutResult()

    def _do_action(self, request, context):
        self._check_auth(context)
        if _wants_context(self.do_action):
            results = self.do_action(self._make_ctx(context),
                                     Action(request.type, request.body))
        else:
            results = self.do_action(request.type, request.body)
        for item in results or ():
            body = item.body if isinstance(item, Result) else item
            if hasattr(body, "to_pybytes"):
                body = body.to_pybytes()
            if isinstance(body, str):
                body = body.encode()
            r = fp.Result()
            r.body = bytes(body)
            yield r

    def _list_actions(self, request, context):
        self._check_auth(context)
        if _wants_context(self.list_actions):
            actions = self.list_actions(self._make_ctx(context))
        else:
            actions = self.list_actions()
        for a_in in actions:
            a = fp.ActionType()
            if isinstance(a_in, ActionType):
                a.type, a.description = a_in.type, a_in.description
            else:
                a.type, a.description = a_in
            yield a

    def serve(self, block: bool = False):
        self._server.start()
        if block:
            self._server.wait_for_termination()

    def run(self):
        """Blocking serve (pyarrow FlightServerBase.serve blocks)."""
        self.serve(block=True)

    def wait(self):
        """Block until the server shuts down."""
        self._server.wait_for_termination()

    def shutdown(self):
        """Stop serving, cancel the calls in flight and end the handler
        threads."""
        self._server.stop(grace=None).wait()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        self.serve()
        return self

    def __exit__(self, *exc):
        self.shutdown()


# --- middleware -------------------------------------------------------------
# Reference: flight/middleware.h, flight/server_middleware.h,
# flight/client_middleware.h, client_tracing_middleware.cc /
# server_tracing_middleware.cc. Factories start one middleware instance
# per call; instances see outgoing/incoming headers and call completion.


class FlightMethod:
    """RPC method ids (flight/types.h FlightMethod)."""
    INVALID = 0
    HANDSHAKE = 1
    LIST_FLIGHTS = 2
    GET_FLIGHT_INFO = 3
    GET_SCHEMA = 4
    DO_GET = 5
    DO_PUT = 6
    DO_ACTION = 7
    LIST_ACTIONS = 8
    DO_EXCHANGE = 9


class CallInfo:
    """Information about an in-flight RPC (middleware.h CallInfo)."""

    def __init__(self, method: int):
        self.method = method


class ServerMiddlewareFactory:
    """Per-server hook: start_call returns a ServerMiddleware instance
    (or None to skip this call). Raising FlightError rejects the call
    (server_middleware.h ServerMiddlewareFactory::StartCall)."""

    def start_call(self, info: CallInfo, headers: dict):
        return None


class ServerMiddleware:
    """Per-call server middleware (server_middleware.h)."""

    def sending_headers(self) -> dict:
        return {}

    def call_completed(self, exception: Optional[BaseException]):
        pass


class ClientMiddlewareFactory:
    """Per-client hook (client_middleware.h)."""

    def start_call(self, info: CallInfo):
        return None


class ClientMiddleware:
    """Per-call client middleware (client_middleware.h)."""

    def sending_headers(self) -> dict:
        return {}

    def received_headers(self, headers: dict):
        pass

    def call_completed(self, exception: Optional[BaseException]):
        pass


class TracingServerMiddleware(ServerMiddleware):
    """Exposes the caller's W3C trace context to handlers
    (server_tracing_middleware.cc: context propagated from the
    `traceparent` header)."""

    def __init__(self, trace_context: dict):
        self.trace_context = dict(trace_context)


class TracingServerMiddlewareFactory(ServerMiddlewareFactory):
    trace_key = "traceparent"

    def start_call(self, info, headers):
        ctx = {}
        for k, v in headers.items():
            if k.lower() in (self.trace_key, "tracestate"):
                ctx[k.lower()] = v
        return TracingServerMiddleware(ctx)


class ClientTracingMiddleware(ClientMiddleware):
    def __init__(self, traceparent: str):
        self._traceparent = traceparent

    def sending_headers(self):
        return {"traceparent": self._traceparent}


class ClientTracingMiddlewareFactory(ClientMiddlewareFactory):
    """Propagates a W3C `traceparent` on every call
    (client_tracing_middleware.cc). Pass ``current_context`` returning
    the active traceparent string, or omit for a fresh random trace id
    per call."""

    def __init__(self, current_context=None):
        self._current = current_context

    def start_call(self, info):
        if self._current is not None:
            tp = self._current()
            if not tp:
                return None
        else:
            import secrets
            tp = (f"00-{secrets.token_hex(16)}-"
                  f"{secrets.token_hex(8)}-01")
        return ClientTracingMiddleware(tp)


def _headers_items(h):
    return h.items() if isinstance(h, dict) else (h or ())


def _option_headers(options) -> List[Tuple[str, object]]:
    """A call's FlightCallOptions headers as gRPC metadata: keys in lower
    case, values as text but for a binary (``-bin``) key's."""
    md = []
    for k, v in _headers_items(None if options is None else options.headers):
        k = (k.decode() if isinstance(k, bytes) else k).lower()
        if isinstance(v, bytes) and not k.endswith("-bin"):
            v = v.decode()
        md.append((k, v))
    return md


def _timeout(options) -> Optional[float]:
    """A call's deadline in seconds from its FlightCallOptions (None: no
    deadline)."""
    return None if options is None else options.timeout


# --- client ----------------------------------------------------------------

class FlightClient:
    def __init__(self, location: str, tls_root_certs: bytes = None,
                 middleware=None):
        """``middleware``: list of ClientMiddlewareFactory — one
        instance starts per RPC and sees outgoing/received headers
        (client_middleware.h)."""
        host_port = location.replace("grpc://", "").replace(
            "grpc+tcp://", "").replace("grpc+tls://", "")
        opts = list(_GRPC_PERF_OPTIONS)
        if location.startswith("grpc+tls://") or tls_root_certs:
            creds = grpc.ssl_channel_credentials(
                root_certificates=tls_root_certs)
            self._channel = grpc.secure_channel(host_port, creds,
                                                options=opts)
        else:
            self._channel = grpc.insecure_channel(host_port,
                                                  options=opts)
        self._metadata: List[Tuple[str, str]] = []
        self._mw_factories = list(middleware or [])

    def _method(self, name):
        return f"/{_SERVICE}/{name}"

    def _md(self, options=None):
        """The metadata of one RPC: the session's and the call options'
        headers."""
        return self._metadata + _option_headers(options) or None

    def _mw_begin(self, method: int, options=None):
        """(metadata, instances) for one RPC: the metadata of ``_md`` plus
        each started middleware's sending_headers."""
        if not self._mw_factories:
            return self._md(options), []
        insts = []
        md = list(self._md(options) or ())
        info = CallInfo(method)
        for fac in self._mw_factories:
            inst = fac.start_call(info)
            if inst is not None:
                insts.append(inst)
                for k, v in _headers_items(inst.sending_headers()):
                    md.append((str(k).lower(), v))
        return (md or None), insts

    @staticmethod
    def _mw_finish(insts, call, exc: Optional[BaseException] = None):
        """Feed received headers (initial+trailing metadata) to each
        instance, then signal completion."""
        for inst in insts:
            if call is not None and exc is None:
                try:
                    hdrs = {}
                    for k, v in tuple(call.initial_metadata() or ()) + \
                            tuple(call.trailing_metadata() or ()):
                        hdrs[k] = v
                    inst.received_headers(hdrs)
                except Exception:
                    pass
            try:
                inst.call_completed(exc)
            except Exception:
                pass

    @classmethod
    def connect(cls, location, **kwargs) -> "FlightClient":
        return cls(location, **kwargs)

    def wait_for_available(self, timeout: int = 5):
        import grpc as _grpc
        _grpc.channel_ready_future(self._channel).result(timeout=timeout)

    @property
    def supports_async(self) -> bool:
        return False

    def as_async(self):
        raise NotImplementedError("async flight client not supported")

    def authenticate(self, auth_handler, options=None):
        """Generic handshake driven by a ClientAuthHandler
        (client.h Authenticate)."""
        stub = self._channel.stream_stream(
            self._method("Handshake"),
            request_serializer=fp.HandshakeRequest.SerializeToString,
            response_deserializer=fp.HandshakeResponse.FromString)

        import queue as _q
        outgoing: "_q.Queue" = _q.Queue()

        class _Out:
            def write(self, payload: bytes):
                outgoing.put(payload)

        def requests():
            while True:
                item = outgoing.get()
                if item is None:
                    return
                req = fp.HandshakeRequest()
                req.payload = item
                yield req

        responses = stub(requests(), metadata=self._md(options),
                         timeout=_timeout(options))

        class _In:
            def read(self):
                try:
                    return next(responses).payload
                except StopIteration:
                    outgoing.put(None)
                    return b""

        try:
            with _flight_errors():
                auth_handler.authenticate(_Out(), _In())
        finally:
            # ends the request stream, also after a failed call
            outgoing.put(None)
        token = auth_handler.get_token()
        if token:
            tok = token.decode() if isinstance(token, bytes) else token
            self._metadata.append(("authorization", f"Bearer {tok}"))

    def get_schema(self, descriptor: FlightDescriptor, options=None):
        """GetSchema RPC (client.h GetSchema)."""
        stub = self._channel.unary_unary(
            self._method("GetSchema"),
            request_serializer=fp.FlightDescriptor.SerializeToString,
            response_deserializer=fp.SchemaResult.FromString)
        md, insts = self._mw_begin(FlightMethod.GET_SCHEMA, options)
        try:
            with _flight_errors():
                res, call = stub.with_call(descriptor.to_pb(), metadata=md,
                                           timeout=_timeout(options))
        except BaseException as e:
            self._mw_finish(insts, None, e)
            raise
        self._mw_finish(insts, call)
        rdr = RecordBatchStreamReader(res.schema)
        return SchemaResult(rdr.schema)

    def authenticate_basic_token(self, username: str, password: str,
                                 options=None):
        """Handshake with BasicAuth credentials; returns the
        ('authorization', 'Bearer <token>') pair and attaches it to all
        later calls (reference: client.h AuthenticateBasicToken)."""
        stub = self._channel.stream_stream(
            self._method("Handshake"),
            request_serializer=fp.HandshakeRequest.SerializeToString,
            response_deserializer=fp.HandshakeResponse.FromString)
        ba = fp.BasicAuth()
        ba.username = username
        ba.password = password
        req = fp.HandshakeRequest()
        req.payload = ba.SerializeToString()
        with _flight_errors():
            resp = next(iter(stub(iter([req]),
                                  metadata=_option_headers(options) or None,
                                  timeout=_timeout(options))))
        pair = ("authorization", "Bearer " + resp.payload.decode())
        self._metadata = [pair]
        return pair

    def do_exchange(self, descriptor: FlightDescriptor,
                    tbl: Optional[Table], options=None) -> Table:
        """Send a table and receive the server's response table over one
        bidirectional stream (reference: client.h DoExchange)."""
        stub = self._channel.stream_stream(
            self._method("DoExchange"),
            request_serializer=_fd_serialize,
            response_deserializer=_fd_parse)

        def gen():
            first = True
            desc_bytes = descriptor.to_pb().SerializeToString()
            if tbl is None:
                yield _FD(descriptor=desc_bytes)
                return
            for fd in _table_to_flight_datas(tbl):
                if first:
                    fd.descriptor = desc_bytes
                    first = False
                yield fd

        asm = _FlightStreamAssembler()
        batches = []
        md, insts = self._mw_begin(FlightMethod.DO_EXCHANGE, options)
        try:
            with _flight_errors():
                resp = stub(gen(), metadata=md, timeout=_timeout(options))
                for fd in resp:
                    rb = asm.feed(fd)
                    if rb is not None:
                        batches.append(rb)
        except BaseException as e:
            self._mw_finish(insts, None, e)
            raise
        self._mw_finish(insts, resp)
        return Table.from_batches(batches, asm.schema)

    def get_flight_info(self, descriptor: FlightDescriptor, options=None):
        stub = self._channel.unary_unary(
            self._method("GetFlightInfo"),
            request_serializer=fp.FlightDescriptor.SerializeToString,
            response_deserializer=fp.FlightInfo.FromString)
        md, insts = self._mw_begin(FlightMethod.GET_FLIGHT_INFO, options)
        try:
            with _flight_errors():
                info, call = stub.with_call(descriptor.to_pb(), metadata=md,
                                            timeout=_timeout(options))
        except BaseException as e:
            self._mw_finish(insts, None, e)
            raise
        self._mw_finish(insts, call)
        mapper = DictionaryFieldMapper()
        rdr = RecordBatchStreamReader(info.schema)
        endpoints = [FlightEndpoint(Ticket(e.ticket.ticket))
                     for e in info.endpoint]
        return FlightInfo(rdr.schema, descriptor, endpoints,
                          info.total_records, info.total_bytes)

    def list_flights(self, criteria: bytes = b"", options=None):
        stub = self._channel.unary_stream(
            self._method("ListFlights"),
            request_serializer=fp.Criteria.SerializeToString,
            response_deserializer=fp.FlightInfo.FromString)
        req = fp.Criteria()
        req.expression = criteria
        md, insts = self._mw_begin(FlightMethod.LIST_FLIGHTS, options)
        with _flight_errors():
            resp = stub(req, metadata=md, timeout=_timeout(options))
            infos = list(resp)
        for info in infos:
            rdr = RecordBatchStreamReader(info.schema)
            yield FlightInfo(
                rdr.schema, FlightDescriptor.from_pb(
                    info.flight_descriptor),
                [FlightEndpoint(Ticket(e.ticket.ticket))
                 for e in info.endpoint],
                info.total_records, info.total_bytes)
        self._mw_finish(insts, resp)

    def do_get(self, ticket: Ticket,
               options=None) -> "FlightStreamReader":
        """Returns a FlightStreamReader (client.h DoGet): use
        ``.read_all()`` / ``.read_chunk()`` like pyarrow; Table methods
        also work directly for convenience."""
        stub = self._channel.unary_stream(
            self._method("DoGet"),
            request_serializer=fp.Ticket.SerializeToString,
            response_deserializer=_fd_parse)
        req = fp.Ticket()
        req.ticket = ticket.ticket
        asm = _FlightStreamAssembler()
        batches = []
        md, insts = self._mw_begin(FlightMethod.DO_GET, options)
        try:
            with _flight_errors():
                resp = stub(req, metadata=md, timeout=_timeout(options))
                for fd in resp:
                    rb = asm.feed(fd)
                    if rb is not None:
                        batches.append(rb)
        except BaseException as e:
            self._mw_finish(insts, None, e)
            raise
        self._mw_finish(insts, resp)
        tbl = Table.from_batches(batches, asm.schema)
        return _DoGetResult([FlightStreamChunk(b, None) for b in batches],
                            tbl)

    def do_put(self, descriptor: FlightDescriptor, data, options=None):
        """pyarrow form: ``writer, meta = client.do_put(desc, schema)``
        then write batches and ``writer.close()``. Compact form: pass a
        Table/RecordBatch to upload it directly."""
        from ..types import Schema as _Schema
        if isinstance(data, _Schema):
            return (_ClientPutWriter(self, descriptor, data, options),
                    FlightMetadataReader())
        tbl = data if isinstance(data, Table) else \
            Table.from_batches([data], data.schema)
        self._do_put_table(descriptor, tbl, options)

    def _do_put_table(self, descriptor: FlightDescriptor, tbl: Table,
                      options=None):
        stub = self._channel.stream_stream(
            self._method("DoPut"),
            request_serializer=_fd_serialize,
            response_deserializer=fp.PutResult.FromString)

        def gen():
            first = True
            desc_bytes = descriptor.to_pb().SerializeToString()
            for fd in _table_to_flight_datas(tbl):
                if first:
                    fd.descriptor = desc_bytes
                    first = False
                yield fd
        md, insts = self._mw_begin(FlightMethod.DO_PUT, options)
        try:
            with _flight_errors():
                resp = stub(gen(), metadata=md, timeout=_timeout(options))
                list(resp)
        except BaseException as e:
            self._mw_finish(insts, None, e)
            raise
        self._mw_finish(insts, resp)

    def do_action(self, action_type: str, body: bytes = b"",
                  options=None):
        stub = self._channel.unary_stream(
            self._method("DoAction"),
            request_serializer=fp.Action.SerializeToString,
            response_deserializer=fp.Result.FromString)
        a = fp.Action()
        a.type = action_type
        a.body = body
        md, insts = self._mw_begin(FlightMethod.DO_ACTION, options)
        with _flight_errors():
            resp = stub(a, metadata=md, timeout=_timeout(options))
            out = [r.body for r in resp]
        self._mw_finish(insts, resp)
        return out

    def list_actions(self, options=None):
        stub = self._channel.unary_stream(
            self._method("ListActions"),
            request_serializer=fp.Empty.SerializeToString,
            response_deserializer=fp.ActionType.FromString)
        md, insts = self._mw_begin(FlightMethod.LIST_ACTIONS, options)
        with _flight_errors():
            resp = stub(fp.Empty(), metadata=md, timeout=_timeout(options))
            out = [(a.type, a.description) for a in resp]
        self._mw_finish(insts, resp)
        return out

    def close(self):
        self._channel.close()


def connect(location: str) -> FlightClient:
    return FlightClient(location)


# --- pyarrow.flight class-surface parity -------------------------------------
# (reference: flight/types.h Location/Action/ActionType, flight/error
# hierarchy in flight/client.h, middleware in flight/middleware.h)


class FlightError(grpc.RpcError):
    """A failed Flight call. A client call's carries its gRPC status:
    ``code()`` and ``details()``, as the ``grpc.RpcError`` it replaces."""

    def __init__(self, message="", extra_info=b"", code=None):
        super().__init__(message)
        self.extra_info = extra_info
        self._code = code

    def code(self):
        return self._code

    def details(self):
        return str(self)


class FlightInternalError(FlightError):
    pass


class FlightTimedOutError(FlightError):
    pass


class FlightCancelledError(FlightError):
    pass


class FlightServerError(FlightError):
    pass


class FlightUnauthenticatedError(FlightError):
    pass


class FlightUnauthorizedError(FlightError):
    pass


class FlightUnavailableError(FlightError):
    pass


class FlightWriteSizeExceededError(FlightError):
    pass


# the Flight error of a gRPC status (flight/transport/grpc/util_internal.cc
# FromGrpcStatus); any other status is a FlightServerError
_STATUS_ERRORS = {
    grpc.StatusCode.UNAUTHENTICATED: FlightUnauthenticatedError,
    grpc.StatusCode.PERMISSION_DENIED: FlightUnauthorizedError,
    grpc.StatusCode.UNAVAILABLE: FlightUnavailableError,
    grpc.StatusCode.DEADLINE_EXCEEDED: FlightTimedOutError,
    grpc.StatusCode.CANCELLED: FlightCancelledError,
    grpc.StatusCode.INTERNAL: FlightInternalError,
}


@contextlib.contextmanager
def _flight_errors():
    """A client call's gRPC failure raised as the Flight error of its
    status."""
    try:
        yield
    except FlightError:
        raise
    except grpc.RpcError as e:
        code = e.code() if callable(getattr(e, "code", None)) else None
        details = e.details() if callable(getattr(e, "details", None)) \
            else str(e)
        raise _STATUS_ERRORS.get(code, FlightServerError)(
            details or "", code=code) from e


class Location:
    """flight/types.h Location."""

    def __init__(self, uri: str):
        self.uri = uri

    @classmethod
    def for_grpc_tcp(cls, host: str, port: int) -> "Location":
        return cls(f"grpc+tcp://{host}:{port}")

    @classmethod
    def for_grpc_tls(cls, host: str, port: int) -> "Location":
        return cls(f"grpc+tls://{host}:{port}")

    @classmethod
    def for_grpc_unix(cls, path: str) -> "Location":
        return cls(f"grpc+unix://{path}")

    def __repr__(self):
        return f"<Location {self.uri}>"

    def __eq__(self, other):
        return isinstance(other, Location) and self.uri == other.uri


class Action:
    """flight/types.h Action (type + opaque body)."""

    def __init__(self, action_type: str, body: bytes = b""):
        self.type = action_type
        self.body = bytes(body)


class ActionType:
    def __init__(self, type: str, description: str = ""):
        self.type = type
        self.description = description


class BasicAuth:
    def __init__(self, username: str = "", password: str = ""):
        self.username = username
        self.password = password


class CertKeyPair:
    """(cert_chain_pem, private_key_pem) pair for tls_certificates."""

    def __init__(self, cert: bytes, key: bytes):
        self.cert = cert
        self.key = key

    def __iter__(self):
        return iter((self.cert, self.key))


class DescriptorType:
    UNKNOWN, PATH, CMD = 0, 1, 2


class FlightCallOptions:
    def __init__(self, timeout=None, write_options=None, headers=None):
        self.timeout = timeout
        self.write_options = write_options
        self.headers = headers or []


class FlightStreamChunk:
    def __init__(self, data, app_metadata=None):
        self.data = data
        self.app_metadata = app_metadata


class GeneratorStream:
    """Server do_get return value built from a schema + batch iterator
    (pyarrow.flight.GeneratorStream)."""

    def __init__(self, schema, generator):
        self.schema = schema
        self.generator = generator

    def to_table(self) -> Table:
        batches = list(self.generator)
        return Table.from_batches(batches, self.schema)


class RecordBatchStream:
    """Server do_get return value wrapping a table/reader."""

    def __init__(self, data_source):
        self.data_source = data_source

    def to_table(self) -> Table:
        src = self.data_source
        if isinstance(src, Table):
            return src
        batches = list(src)
        return Table.from_batches(batches, batches[0].schema)


# --- remaining pyarrow.flight names ------------------------------------------

class Result:
    """One result of a DoAction call (flight/types.h Result)."""

    def __init__(self, body):
        from ..buffer import Buffer
        if isinstance(body, str):
            body = body.encode()
        self.body = body if isinstance(body, Buffer) else Buffer(body)

    def __repr__(self):
        return f"<flight.Result body={self.body.size}b>"


class SchemaResult:
    """GetSchema response (flight/types.h SchemaResult)."""

    def __init__(self, schema):
        self.schema = schema


class ServerCallContext:
    """Per-call server context (flight/server.h ServerCallContext)."""

    def __init__(self, peer: str = "", peer_identity: bytes = b"",
                 headers=None, middleware=None):
        self._peer = peer
        self._peer_identity = peer_identity
        self._headers = dict(headers or {})
        self._middleware = dict(middleware or {})

    def peer(self) -> str:
        return self._peer

    def peer_identity(self) -> bytes:
        return self._peer_identity

    def is_cancelled(self) -> bool:
        return False

    def get_middleware(self, key):
        """Per-call middleware instance registered under ``key``
        (server_middleware.h ServerCallContext::GetMiddleware)."""
        return self._middleware.get(key)


class ClientAuthHandler:
    """Client-side auth handshake (flight/client_auth.h)."""

    def authenticate(self, outgoing, incoming):
        raise NotImplementedError

    def get_token(self) -> bytes:
        raise NotImplementedError


import abc as _abc


class FlightDataStream(_abc.ABC):
    """Abstract server stream; GeneratorStream / RecordBatchStream are
    registered as virtual subclasses."""


FlightDataStream.register(GeneratorStream)
FlightDataStream.register(RecordBatchStream)


class MetadataRecordBatchReader:
    """Batch reader that also yields per-batch app_metadata."""

    def __init__(self, chunks):
        self._chunks = list(chunks)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self._chunks):
            raise StopIteration
        c = self._chunks[self._i]
        self._i += 1
        return c

    def read_chunk(self):
        return next(self)

    def read_all(self) -> Table:
        batches = [c.data for c in self._chunks[self._i:]]
        self._i = len(self._chunks)
        return Table.from_batches(batches,
                                  batches[0].schema if batches else None)


class FlightStreamReader(MetadataRecordBatchReader):
    """Client-side DoGet stream (flight/client.h FlightStreamReader)."""

    def cancel(self):
        pass


class _DoGetResult(FlightStreamReader):
    """FlightClient.do_get result: a FlightStreamReader that also
    forwards Table attributes, so both pyarrow-style ``.read_all()``
    and direct table use work."""

    def __init__(self, chunks, table):
        super().__init__(chunks)
        self._table = table

    @property
    def schema(self):
        return self._table.schema

    def read_all(self) -> Table:
        self._i = len(self._chunks)
        return self._table

    def to_reader(self):
        return self._table.to_reader()

    def __getattr__(self, name):
        # fallback for Table API (to_pydict, num_rows, column, ...)
        return getattr(self._table, name)

    def __eq__(self, other):
        other_tbl = other._table if isinstance(other, _DoGetResult) \
            else other
        return self._table == other_tbl

    def __len__(self):
        return len(self._table)


class MetadataRecordBatchWriter:
    """Batch writer that can attach app_metadata per batch."""

    def __init__(self, sink=None):
        self._batches = []
        self._metadata = []

    def begin(self, schema, options=None):
        self.schema = schema

    def write_batch(self, batch):
        self._batches.append(batch)

    def write_table(self, table, max_chunksize=None):
        for b in table.to_batches(max_chunksize):
            self._batches.append(b)

    def write_with_metadata(self, batch, app_metadata):
        self._batches.append(batch)
        self._metadata.append(app_metadata)

    def close(self):
        pass


class FlightStreamWriter(MetadataRecordBatchWriter):
    """Client-side DoPut writer (flight/client.h FlightStreamWriter)."""

    def done_writing(self):
        pass


class _ClientPutWriter(MetadataRecordBatchWriter):
    """Client-side DoPut writer (client.h FlightStreamWriter): batches
    buffer locally and upload on close/done_writing."""

    def __init__(self, client, descriptor, schema, options=None):
        super().__init__()
        self._client = client
        self._descriptor = descriptor
        self._options = options
        self.begin(schema)
        self._sent = False

    def done_writing(self):
        self.close()

    def close(self):
        if self._sent:
            return
        self._sent = True
        tbl = (Table.from_batches(self._batches, self.schema)
               if self._batches else
               Table.from_batches([], self.schema))
        self._client._do_put_table(self._descriptor, tbl,
                                   self._options)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FlightMetadataReader:
    """Reads server app_metadata on a DoPut (flight/client.h)."""

    def __init__(self, messages=()):
        self._messages = list(messages)
        self._i = 0

    def read(self):
        if self._i >= len(self._messages):
            return None
        m = self._messages[self._i]
        self._i += 1
        return m


class FlightMetadataWriter:
    """Writes server app_metadata on a DoPut (flight/server.h)."""

    def __init__(self):
        self.messages = []

    def write(self, message):
        self.messages.append(message)
