"""Arrow Flight in the port (``arrow_tpu_torch/flight``) against the JAX
package's (``arrow_tpu/flight``), both on the CPU:

* the FlightData codec: the same Table gives the same wire bytes in both
  packages, and each package reads the other's frames;
* the port's client against the reference's server and the reference's
  client against the port's, over every RPC (DoGet, DoPut, DoExchange,
  GetFlightInfo, GetSchema, ListFlights, DoAction, ListActions);
* errors (a gRPC status as its Flight error), deadlines, basic auth, TLS
  with a certificate made by ``cryptography`` (here only), middleware;
* pyarrow's Flight client and server against the port's, where pyarrow is
  installed;
* the generated protocol modules: the port's own copies, byte for byte
  the reference's, imported from the port's package beside the
  reference's;
* no thread the port starts outlives its servers, clients and gateways.

Every server lives in a ``with`` block or a module fixture that shuts it
down, and every client call has a deadline: its ``FlightCallOptions``
timeout, or a thread joined with that deadline (the reference's client
takes no options).
"""

import datetime
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import grpc
import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import flight as rflight
from arrow_tpu_torch import flight

from test_torch_host_table import carry_table
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 60


# the port's client calls' options: their deadline
OPTIONS = flight.FlightCallOptions(timeout=DEADLINE_S)


def within(fn, *args):
    """``fn(*args)`` on a thread joined within DEADLINE_S: the deadline of
    calls that take no options (the reference's client, DB-API, ODBC)."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - raised below
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(DEADLINE_S)
    assert not t.is_alive(), f"{fn} passed its deadline"
    if "error" in out:
        raise out["error"]
    return out["value"]


def sample(n=1000, seed=3):
    """A reference Table of seeded numpy values with nulls: int64,
    float64 with NaN, string, dictionary string, date32 and bool."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.1
    ints = rng.integers(-10**12, 10**12, n)
    floats = rng.normal(size=n)
    floats[rng.random(n) < 0.05] = np.nan
    words = np.array(["alpha", "beta", "", "gamma delta", "é"])
    strs = words[rng.integers(0, len(words), n)]
    days = rng.integers(0, 20_000, n)
    return at.table({
        "i": at.array([int(v) if k else None for v, k in zip(ints, valid)]),
        "f": at.array([float(v) for v in floats]),
        "s": at.array([str(v) if k else None for v, k in zip(strs, valid)]),
        "d": at.array([str(v) for v in strs]).dictionary_encode(),
        "day": at.array([datetime.date(1970, 1, 1) + datetime.timedelta(
            days=int(v)) for v in days]),
        "b": at.array([bool(v) for v in valid]),
    })


def large(n=300_000, seed=5):
    """More rows than one FlightData batch (2**18): int64 and a
    dictionary column."""
    rng = np.random.default_rng(seed)
    flags = np.array(["A", "N", "R"])
    return at.table({
        "k": at.array(rng.integers(0, 10**9, n)),
        "flag": at.array(flags[rng.integers(0, 3, n)].tolist()
                         ).dictionary_encode(),
    })


TABLES = {"sample": sample, "large": large,
          "empty": lambda: at.table({"x": at.array([], at.int64())})}


@pytest.fixture(scope="module")
def tables():
    return {name: make() for name, make in TABLES.items()}


def port_of(rt):
    return carry_table(rt)


def same(got, want):
    """Two Tables of either package alike value for value (NaN equal to
    NaN)."""
    g, w = got.to_pydict(), want.to_pydict()
    assert list(g) == list(w)
    for name in w:
        a, b = g[name], w[name]
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            assert x == y or (x != x and y != y), (name, x, y)


# --- the FlightData codec ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(TABLES))
def test_fd_serialize_gives_the_reference_bytes(tables, name):
    rt = tables[name]
    want = [rflight._fd_serialize(fd)
            for fd in rflight._table_to_flight_datas(rt)]
    got = [flight._fd_serialize(fd)
           for fd in flight._table_to_flight_datas(port_of(rt))]
    assert len(got) == len(want) >= 2
    assert got == want


@pytest.mark.parametrize("name", sorted(TABLES))
def test_each_package_reads_the_others_frames(tables, name):
    rt = tables[name]
    pt = port_of(rt)
    for frames, parse, assembler, want in (
            ([flight._fd_serialize(fd)
              for fd in flight._table_to_flight_datas(pt)],
             rflight._fd_parse, rflight._FlightStreamAssembler(), rt),
            ([rflight._fd_serialize(fd)
              for fd in rflight._table_to_flight_datas(rt)],
             flight._fd_parse, flight._FlightStreamAssembler(), pt)):
        batches = [b for b in (assembler.feed(parse(f)) for f in frames)
                   if b is not None]
        got = type(want).from_batches(batches, assembler.schema)
        same(got, want)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_serialize_record_batch_gives_the_reference_bytes(tables, name):
    """``ipc.message.serialize_record_batch`` (framed metadata, body) of
    each package over the same batch."""
    from arrow_tpu.ipc.message import serialize_record_batch as ref
    from arrow_tpu_torch.ipc.message import serialize_record_batch
    rt = tables[name]
    pt = port_of(rt)
    want = ref([c.combine().data for c in rt.columns], rt.num_rows)
    got = serialize_record_batch([c.combine().data for c in pt.columns],
                                 pt.num_rows)
    assert got == want


def test_received_batches_share_their_dictionary(tables):
    """A stream repeats each batch's dictionary; the port's assembler keeps
    one object, so the column concatenates by its indices to the sent
    column, bit for bit."""
    from test_torch_host_table import assert_same_data
    rt = tables["large"]
    asm = flight._FlightStreamAssembler()
    batches = [b for b in (asm.feed(flight._fd_parse(flight._fd_serialize(
        fd))) for fd in flight._table_to_flight_datas(port_of(rt)))
        if b is not None]
    assert len(batches) == 2
    col = att.Table.from_batches(batches).column("flag")
    assert col.chunks[0].data.dictionary is col.chunks[1].data.dictionary
    assert_same_data(col.combine().data, rt.column("flag").combine().data)


# --- servers of both packages ------------------------------------------------

def tables_server(m, tables):
    """A server of package ``m`` serving ``tables`` (the compact
    handler signatures)."""

    class Server(m.FlightServerBase):
        def __init__(self):
            super().__init__("grpc://127.0.0.1:0")
            self.tables, self.received = dict(tables), {}

        def get_flight_info(self, desc):
            name = desc.path[0].decode()
            t = self.tables[name]
            return m.FlightInfo(t.schema, desc,
                                [m.FlightEndpoint(name.encode())],
                                t.num_rows, -1)

        def do_get(self, ticket):
            return self.tables[ticket.ticket.decode()]

        def do_put(self, desc, tbl):
            self.received[desc.path[0].decode()] = tbl

        def do_exchange(self, desc, tbl):
            return tbl

        def list_flights(self, criteria):
            for name, t in sorted(self.tables.items()):
                yield m.FlightInfo(t.schema, m.FlightDescriptor.for_path(
                    name), [m.FlightEndpoint(name.encode())], t.num_rows, -1)

        def do_action(self, action_type, body):
            return [b"echo:" + body]

        def list_actions(self):
            return [("ping", "echo the body")]
    return Server()


@pytest.fixture(scope="module")
def servers(tables):
    ref = {"sample": tables["sample"], "large": tables["large"]}
    port = {k: port_of(v) for k, v in ref.items()}
    with tables_server(flight, port) as ps, tables_server(rflight,
                                                          ref) as rs:
        yield {"port": ps, "reference": rs}, {"port": port,
                                               "reference": ref}


PAIRS = [("port", "port"), ("port", "reference"), ("reference", "port")]


def client(kind, port):
    m = flight if kind == "port" else rflight
    return m, m.FlightClient(f"grpc://127.0.0.1:{port}")


@pytest.mark.parametrize("cli,srv", PAIRS)
def test_do_get(servers, cli, srv):
    (srvs, data) = servers
    m, c = client(cli, srvs[srv].port)
    try:
        for name in ("sample", "large"):
            got = within(lambda: c.do_get(m.Ticket(name.encode()))
                         .read_all())
            same(got, data[srv][name])
    finally:
        c.close()


@pytest.mark.parametrize("cli,srv", PAIRS)
def test_do_put(servers, cli, srv, tables):
    (srvs, _) = servers
    m, c = client(cli, srvs[srv].port)
    rt = tables["sample"]
    sent = rt if cli == "reference" else port_of(rt)
    try:
        within(c.do_put, m.FlightDescriptor.for_path(f"up-{cli}"), sent)
    finally:
        c.close()
    same(srvs[srv].received.pop(f"up-{cli}"), rt)


@pytest.mark.parametrize("cli,srv", PAIRS)
def test_do_exchange(servers, cli, srv, tables):
    (srvs, _) = servers
    m, c = client(cli, srvs[srv].port)
    rt = tables["large"]
    sent = rt if cli == "reference" else port_of(rt)
    try:
        got = within(c.do_exchange, m.FlightDescriptor.for_path("x"),
                   sent)
    finally:
        c.close()
    same(got, rt)


@pytest.mark.parametrize("cli,srv", PAIRS)
def test_listing_info_schema_and_actions(servers, cli, srv):
    (srvs, data) = servers
    m, c = client(cli, srvs[srv].port)
    try:
        infos = within(lambda: list(c.list_flights()))
        assert [i.total_records for i in infos] == [300_000, 1000]
        info = within(c.get_flight_info,
                    m.FlightDescriptor.for_path("sample"))
        assert info.schema.names == data[srv]["sample"].schema.names
        assert info.total_records == 1000
        assert info.endpoints[0].ticket.ticket == b"sample"
        schema = within(c.get_schema, m.FlightDescriptor.for_path("large"))
        assert schema.schema.names == ["k", "flag"]
        assert within(c.do_action, "ping", b"hi") == [b"echo:hi"]
        assert within(c.list_actions) == [("ping", "echo the body")]
    finally:
        c.close()


def test_descriptors_and_infos_serialize_as_the_reference(tables):
    pt = port_of(tables["sample"])
    for make in (lambda m: m.FlightDescriptor.for_path("a", "b"),
                 lambda m: m.FlightDescriptor.for_command(b"\x01cmd")):
        assert make(flight).serialize() == make(rflight).serialize()
        back = flight.FlightDescriptor.deserialize(make(rflight).serialize())
        assert back.serialize() == make(rflight).serialize()
    info = flight.FlightInfo(pt.schema, flight.FlightDescriptor.for_path("x"),
                             [flight.FlightEndpoint(b"t")], 1000, 5)
    rinfo = rflight.FlightInfo(tables["sample"].schema,
                               rflight.FlightDescriptor.for_path("x"),
                               [rflight.FlightEndpoint(b"t")], 1000, 5)
    assert info.serialize() == rinfo.serialize()
    back = flight.FlightInfo.deserialize(rinfo.serialize())
    assert (back.schema.names, back.total_records, back.total_bytes) == \
        (pt.schema.names, 1000, 5)


# --- errors, deadlines, auth, TLS, middleware --------------------------------

class Failing(flight.FlightServerBase):
    def do_get(self, ticket):
        raise KeyError(ticket.ticket)

    def do_action(self, action_type, body):
        time.sleep(float(body))
        return [b"late"]


def test_a_failed_call_raises_its_flight_error():
    with Failing("grpc://127.0.0.1:0") as srv:
        c = flight.FlightClient(f"grpc://127.0.0.1:{srv.port}")
        try:
            with pytest.raises(flight.FlightServerError) as e:
                c.do_get(flight.Ticket(b"missing"), OPTIONS)
            assert isinstance(e.value, grpc.RpcError)
            assert e.value.code() == grpc.StatusCode.UNKNOWN
            assert "missing" in e.value.details()
            with pytest.raises(flight.FlightTimedOutError) as e:
                c.do_action("sleep", b"1.0",
                            options=flight.FlightCallOptions(timeout=0.2))
            assert e.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        finally:
            c.close()
    # the server gone: unavailable
    c = flight.FlightClient(f"grpc://127.0.0.1:{srv.port}")
    try:
        with pytest.raises(flight.FlightUnavailableError):
            c.do_get(flight.Ticket(b"x"), OPTIONS)
    finally:
        c.close()


SLOW_S = 1.0   # each handler of the slow server sleeps this long
TOKEN = [(b"authorization", b"Bearer ok")]


class SlowAuth(flight.ServerAuthHandler):
    def authenticate(self, payload):
        time.sleep(SLOW_S)
        return b"ok"

    def is_valid(self, token):
        return "ann" if token == b"ok" else None


class Slow(flight.FlightServerBase):
    """Every handler sleeps SLOW_S first; a call without TOKEN is
    refused."""

    def __init__(self):
        super().__init__("grpc://127.0.0.1:0", auth_handler=SlowAuth())

    def get_flight_info(self, descriptor):
        time.sleep(SLOW_S)
        t = att.table({"x": [1]})
        return flight.FlightInfo(t.schema, descriptor,
                                 [flight.FlightEndpoint(b"t")], 1, -1)

    def list_flights(self, criteria):
        time.sleep(SLOW_S)
        return iter(())

    def do_get(self, ticket):
        time.sleep(SLOW_S)
        return att.table({"x": [1]})

    def do_put(self, descriptor, table):
        time.sleep(SLOW_S)

    def do_exchange(self, descriptor, table):
        time.sleep(SLOW_S)
        return table

    def do_action(self, action_type, body):
        time.sleep(float(body or SLOW_S))
        return [b"done"]

    def list_actions(self):
        time.sleep(SLOW_S)
        return []


class Handshake(flight.ClientAuthHandler):
    def authenticate(self, outgoing, incoming):
        outgoing.write(b"hello")
        incoming.read()


def _put_by_writer(c, desc, tbl, options):
    writer, _ = c.do_put(desc, tbl.schema, options)
    writer.write_table(tbl)
    writer.close()


CALLS = {
    "do_get": lambda c, d, t, o: c.do_get(flight.Ticket(b"t"), o),
    "do_put": lambda c, d, t, o: c.do_put(d, t, o),
    "do_put_writer": _put_by_writer,
    "do_exchange": lambda c, d, t, o: c.do_exchange(d, t, o),
    "get_flight_info": lambda c, d, t, o: c.get_flight_info(d, o),
    "get_schema": lambda c, d, t, o: c.get_schema(d, o),
    "list_flights": lambda c, d, t, o: list(c.list_flights(b"", o)),
    "do_action": lambda c, d, t, o: c.do_action("sleep", b"", o),
    "list_actions": lambda c, d, t, o: c.list_actions(o),
    "authenticate_basic_token": lambda c, d, t, o:
        c.authenticate_basic_token("ann", "pw", o),
    "authenticate": lambda c, d, t, o: c.authenticate(Handshake(), o),
}


@pytest.fixture(scope="module")
def slow():
    with Slow() as srv:
        yield srv


@pytest.mark.parametrize("method", sorted(CALLS))
def test_call_options_give_the_call_its_deadline_and_headers(slow, method):
    """Each client method takes pyarrow's ``options``: its timeout ends
    the call with FlightTimedOutError, and its headers carry the token
    (without them the call would be refused at once, unauthenticated)."""
    c = flight.FlightClient(f"grpc://127.0.0.1:{slow.port}")
    try:
        with pytest.raises(flight.FlightTimedOutError):
            within(CALLS[method], c, flight.FlightDescriptor.for_path("p"),
                   att.table({"x": [1, 2]}),
                   flight.FlightCallOptions(timeout=0.2, headers=TOKEN))
        with pytest.raises(flight.FlightUnauthenticatedError):
            within(c.do_action, "sleep", b"0", OPTIONS)
        assert within(c.do_action, "sleep", b"0", flight.FlightCallOptions(
            timeout=DEADLINE_S, headers=TOKEN)) == [b"done"]
    finally:
        c.close()


def auth_server(m, tables):
    class Server(m.FlightServerBase):
        def do_get(self, ticket):
            return tables[ticket.ticket.decode()]
    return Server("grpc://127.0.0.1:0",
                  auth_handler=m.BasicServerAuthHandler({"ann": "pw"}))


@pytest.mark.parametrize("cli,srv", PAIRS)
def test_basic_auth(tables, cli, srv):
    rt = tables["sample"]
    data = {"t": rt if srv == "reference" else port_of(rt)}
    sm = flight if srv == "port" else rflight
    with auth_server(sm, data) as s:
        m, c = client(cli, s.port)
        try:
            with pytest.raises(grpc.RpcError) as e:
                within(c.do_get, m.Ticket(b"t"))
            assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED
            if cli == "port":
                assert isinstance(e.value, flight.FlightUnauthenticatedError)
            with pytest.raises(grpc.RpcError):
                within(c.authenticate_basic_token, "ann", "wrong")
            pair = within(c.authenticate_basic_token, "ann", "pw")
            assert pair[0] == "authorization" and \
                pair[1].startswith("Bearer ")
            same(within(lambda: c.do_get(m.Ticket(b"t")).read_all()), rt)
        finally:
            c.close()


def _certificate():
    """A self-signed certificate for 127.0.0.1 and its key, PEM."""
    pytest.importorskip("cryptography")
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    import ipaddress
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "127.0.0.1")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key()).serial_number(1)
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(x509.SubjectAlternativeName(
                [x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
                critical=False)
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .sign(key, hashes.SHA256()))
    return (cert.public_bytes(serialization.Encoding.PEM),
            key.private_bytes(serialization.Encoding.PEM,
                              serialization.PrivateFormat.PKCS8,
                              serialization.NoEncryption()))


@pytest.mark.parametrize("cli", ["port", "reference"])
def test_tls(tables, cli):
    cert, key = _certificate()
    pt = port_of(tables["sample"])

    class Server(flight.FlightServerBase):
        def do_get(self, ticket):
            return pt

    with Server("grpc+tls://127.0.0.1:0",
                tls_certificates=[(cert, key)]) as srv:
        m = flight if cli == "port" else rflight
        c = m.FlightClient(f"grpc+tls://127.0.0.1:{srv.port}",
                           tls_root_certs=cert)
        try:
            got = within(lambda: c.do_get(m.Ticket(b"t")).read_all())
        finally:
            c.close()
    same(got, tables["sample"])


class Recording(flight.ServerMiddlewareFactory):
    def __init__(self):
        self.calls = []

    def start_call(self, info, headers):
        rec = self

        class M(flight.ServerMiddleware):
            def sending_headers(self):
                return {"x-server": "port"}

            def call_completed(self, exception):
                rec.calls.append((info.method, exception is None))
        return M()


def test_middleware_lifecycle_and_tracing(tables):
    rec, seen, got_headers = Recording(), [], []
    pt = port_of(tables["sample"])

    class Server(flight.FlightServerBase):
        def do_get(self, context, ticket):
            seen.append(context.get_middleware("trace").trace_context)
            assert context.get_middleware("rec") is not None
            return flight.RecordBatchStream(pt)

    class Client(flight.ClientMiddlewareFactory):
        def start_call(self, info):
            class M(flight.ClientMiddleware):
                def received_headers(self, headers):
                    got_headers.append(headers.get("x-server"))
            return M()

    with Server("grpc://127.0.0.1:0", middleware={
            "trace": flight.TracingServerMiddlewareFactory(),
            "rec": rec}) as srv:
        c = flight.FlightClient(
            f"grpc://127.0.0.1:{srv.port}", middleware=[
                flight.ClientTracingMiddlewareFactory(lambda: "00-" + "1" * 32
                                                      + "-" + "2" * 16
                                                      + "-01"), Client()])
        try:
            same(c.do_get(flight.Ticket(b"t"), OPTIONS).read_all(),
                 tables["sample"])
            # the reference's client's traceparent reaches the port's
            rc = rflight.FlightClient(
                f"grpc://127.0.0.1:{srv.port}",
                middleware=[rflight.ClientTracingMiddlewareFactory()])
            try:
                within(lambda: rc.do_get(rflight.Ticket(b"t")).read_all())
            finally:
                rc.close()
        finally:
            c.close()
    assert seen[0] == {"traceparent": "00-" + "1" * 32 + "-" + "2" * 16
                       + "-01"}
    assert seen[1]["traceparent"].startswith("00-") and \
        seen[1] != seen[0]
    assert rec.calls == [(flight.FlightMethod.DO_GET, True)] * 2
    assert got_headers == ["port"]


# --- pyarrow -----------------------------------------------------------------

def test_pyarrow_client_and_server(servers, tables):
    paf = pytest.importorskip("pyarrow.flight")
    import pyarrow as pa
    (srvs, data) = servers
    pc = paf.connect(f"grpc://127.0.0.1:{srvs['port'].port}")
    opts = paf.FlightCallOptions(timeout=DEADLINE_S)
    try:
        got = pc.do_get(paf.Ticket(b"sample"), opts).read_all()
        assert got.column_names == data["port"]["sample"].schema.names
        assert got.column("i").to_pylist() == \
            data["port"]["sample"].column("i").to_pylist()
        writer, _ = pc.do_put(paf.FlightDescriptor.for_path("from-pyarrow"),
                              pa.schema([("v", pa.float64())]), opts)
        writer.write_table(pa.table({"v": [1.5, None]}))
        writer.close()
    finally:
        pc.close()
    assert srvs["port"].received.pop("from-pyarrow").to_pydict() == \
        {"v": [1.5, None]}

    class PaServer(paf.FlightServerBase):
        def do_get(self, context, ticket):
            return paf.RecordBatchStream(pa.table({"x": [1, None, 3],
                                                   "s": ["a", "b", None]}))

    with PaServer("grpc://127.0.0.1:0") as ps:
        c = flight.FlightClient(f"grpc://127.0.0.1:{ps.port}")
        try:
            got = c.do_get(flight.Ticket(b"t"), OPTIONS).read_all()
        finally:
            c.close()
    assert got.to_pydict() == {"x": [1, None, 3], "s": ["a", "b", None]}


# --- the protocol modules, the names, the threads ----------------------------

PROTO_FILES = ("Flight.proto", "FlightSql.proto", "Flight_pb2.py",
               "FlightSql_pb2.py", "__init__.py")


@pytest.mark.parametrize("name", PROTO_FILES)
def test_proto_files_are_the_reference_bytes(name):
    assert (REPO / "arrow_tpu_torch/flight/proto" / name).read_bytes() == \
        (REPO / "arrow_tpu/flight/proto" / name).read_bytes()


def test_the_port_imports_its_own_protocol_modules():
    """The reference imports its generated modules as the top-level
    ``Flight_pb2`` (it puts their directory on ``sys.path``); with the
    reference imported first, the port still uses its own files."""
    code = (
        "import arrow_tpu.flight, arrow_tpu.flight.sql\n"
        "import Flight_pb2, FlightSql_pb2\n"
        "from arrow_tpu_torch import flight\n"
        "from arrow_tpu_torch.flight import sql\n"
        "from arrow_tpu_torch.flight.proto import Flight_pb2 as pf, "
        "FlightSql_pb2 as ps\n"
        "assert 'arrow_tpu_torch' in pf.__file__, pf.__file__\n"
        "assert 'arrow_tpu_torch' in ps.__file__, ps.__file__\n"
        "assert flight.fp is pf and sql.fsql is ps\n"
        "assert 'arrow_tpu_torch' not in Flight_pb2.__file__\n"
        "d = flight.FlightDescriptor.for_path('a')\n"
        "r = arrow_tpu.flight.FlightDescriptor.for_path('a')\n"
        "assert d.serialize() == r.serialize()\n"
        "print('own', pf.__file__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("own ")


def test_no_thread_outlives_the_servers_clients_and_gateways():
    """Servers, clients and a gateway with a connection left open, each
    in its ``with`` block: after them no thread but the main one is left
    that would keep the process (or a test worker) from ending."""
    code = (
        "import socket, threading\n"
        "import arrow_tpu_torch as att\n"
        "from arrow_tpu_torch import flight\n"
        "from arrow_tpu_torch.flight import sql\n"
        "from arrow_tpu_torch.flight.odbc_gateway import OdbcGateway\n"
        "t = {'t': att.table({'a': [1, 2, 3]})}\n"
        "with sql.FlightSqlServer(tables=t, device='cpu') as srv:\n"
        "    loc = f'grpc://127.0.0.1:{srv.port}'\n"
        "    c = sql.FlightSqlClient(loc)\n"
        "    o = flight.FlightCallOptions(timeout=60)\n"
        "    assert c.execute('select a from t', o).read_all().num_rows == 3\n"
        "    c.close()\n"
        "    with OdbcGateway(loc) as gw:\n"
        "        s = socket.create_connection(('127.0.0.1', gw.port))\n"
        "    s.close()\n"
        "left = [x.name for x in threading.enumerate()\n"
        "        if x is not threading.main_thread()]\n"
        "assert not left, left\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("module", ["", ".sql", ".dbapi", ".odbc_gateway",
                                    ".odbc"])
def test_the_reference_public_names(module):
    import importlib
    ref = importlib.import_module("arrow_tpu.flight" + module)
    port = importlib.import_module("arrow_tpu_torch.flight" + module)
    names = {n for n in dir(ref) if not n.startswith("_")
             and not isinstance(getattr(ref, n), types.ModuleType)
             and getattr(getattr(ref, n), "__module__", ref.__name__)
             .startswith("arrow_tpu.flight")}
    missing = {n for n in names if not hasattr(port, n)}
    assert missing == set()
