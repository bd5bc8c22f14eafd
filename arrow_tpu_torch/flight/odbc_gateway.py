"""ODBC driver gateway: the socket peer of the native ODBC driver
(counterpart of ``arrow_tpu/flight/odbc_gateway.py``).

Reference analogue: cpp/src/arrow/flight/sql/odbc/ — the reference's
ODBC driver embeds a C++ Flight SQL client; here the native driver
(arrow_tpu_torch/csrc/odbc_driver.cpp) is a thin C shim loadable by any
ODBC driver manager (unixODBC's libodbc), and THIS gateway carries its
queries to a Flight SQL endpoint. Protocol (little-endian):

  request frame:   [u32 len][payload]; payload[0] is the op:
                   'X' + sql-utf8   execute a statement
                   'Q'              close the session
  response ('X'):  [u32 status]  0=ok else error:
                   error: [u32 len][utf8 message]
                   ok:    [u32 ncols]
                          ncols x ([u16 namelen][name][u8 typecode])
                          [u64 nrows]
                          nrows*ncols x ([u32 len | 0xFFFFFFFF=null][utf8])

Typecodes: 1=int 2=float 3=string 4=bool 5=date 6=timestamp 0=other.
Cell payloads are UTF-8 text — the driver converts to the C type the
application binds (ODBC chardata model).

Run standalone:  python -m arrow_tpu_torch.flight.odbc_gateway \
                     --flight grpc://host:port [--port N]
or in-process via ``OdbcGateway``: ``with OdbcGateway(location) as gw:``
serves on ``gw.port`` from daemon threads, which ``close()`` (the
``with`` block's end) ends, the connections open then included.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

_NULL = 0xFFFFFFFF


def _typecode(t) -> int:
    from .. import types as T
    if t.id in (T.TypeId.INT8, T.TypeId.INT16, T.TypeId.INT32,
                T.TypeId.INT64, T.TypeId.UINT8, T.TypeId.UINT16,
                T.TypeId.UINT32, T.TypeId.UINT64):
        return 1
    if t.id in (T.TypeId.HALF_FLOAT, T.TypeId.FLOAT, T.TypeId.DOUBLE):
        return 2
    if t.id in (T.TypeId.STRING, T.TypeId.LARGE_STRING):
        return 3
    if t.id == T.TypeId.BOOL:
        return 4
    if t.id in (T.TypeId.DATE32, T.TypeId.DATE64):
        return 5
    if t.id == T.TypeId.TIMESTAMP:
        return 6
    return 0


def _encode_result(table) -> bytes:
    out = [struct.pack("<I", 0), struct.pack("<I", table.num_columns)]
    for f in table.schema:
        nm = f.name.encode()
        out.append(struct.pack("<H", len(nm)) + nm +
                   struct.pack("<B", _typecode(f.type)))
    out.append(struct.pack("<Q", table.num_rows))
    cols = [c.to_pylist() for c in table.columns]
    for i in range(table.num_rows):
        for col in cols:
            v = col[i]
            if v is None:
                out.append(struct.pack("<I", _NULL))
            else:
                if isinstance(v, bool):
                    b = b"1" if v else b"0"
                elif isinstance(v, bytes):
                    b = v
                else:
                    b = str(v).encode()
                out.append(struct.pack("<I", len(b)) + b)
    return b"".join(out)


def _encode_error(msg: str) -> bytes:
    m = msg.encode()[:4096]
    return struct.pack("<I", 1) + struct.pack("<I", len(m)) + m


class OdbcGateway:
    """Accepts native-driver connections and executes their SQL against
    a Flight SQL endpoint, or against ``tables`` in this process on
    ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, flight_location: Optional[str] = None,
                 tables=None, host: str = "127.0.0.1", port: int = 0,
                 device=None):
        if flight_location is None and tables is None:
            raise ValueError("need flight_location or tables")
        self._location = flight_location
        self._tables = tables
        self._device = device
        self._sock = socket.create_server((host, port))
        self._threads = []
        self._conns = set()
        self._lock = threading.Lock()
        self._accept_thread = None
        self._closing = False

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def _execute(self, sql: str):
        if self._location is not None:
            from .sql import FlightSqlClient
            cli = FlightSqlClient(self._location)
            try:
                out = cli.execute(sql)
                return out.read_all() if hasattr(out, "read_all") \
                    else out
            finally:
                getattr(cli, "close", lambda: None)()
        from ..sql import query
        return query(sql, self._tables, device=self._device)

    def _serve_conn(self, conn: socket.socket):
        try:
            while True:
                hdr = self._recv_exact(conn, 4)
                if hdr is None:
                    return
                (ln,) = struct.unpack("<I", hdr)
                payload = self._recv_exact(conn, ln)
                if payload is None or not payload:
                    return
                op, body = payload[:1], payload[1:]
                if op == b"Q":
                    return
                if op != b"X":
                    self._send(conn, _encode_error("bad op"))
                    continue
                try:
                    tbl = self._execute(body.decode())
                    self._send(conn, _encode_result(tbl))
                except Exception as e:  # noqa: BLE001 - to the client
                    self._send(conn, _encode_error(str(e)))
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    @staticmethod
    def _recv_exact(conn, n):
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    @staticmethod
    def _send(conn, payload: bytes):
        conn.sendall(struct.pack("<I", len(payload)) + payload)

    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            with self._lock:
                if self._closing:
                    conn.close()
                    return
                self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def __enter__(self):
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def __exit__(self, *a):
        self.close()

    def close(self):
        """Stop accepting, end every open connection and wait for the
        threads (a statement running finishes first)."""
        with self._lock:
            self._closing = True
            conns = list(self._conns)
        for s in [self._sock] + conns:
            try:
                s.shutdown(socket.SHUT_RDWR)  # wakes a blocked accept/recv
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join()
        for t in self._threads:
            t.join()


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--flight", required=True,
                   help="Flight SQL endpoint, e.g. grpc://host:port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=31337)
    args = p.parse_args(argv)
    gw = OdbcGateway(args.flight, host=args.host, port=args.port)
    print(f"odbc gateway on {args.host}:{gw.port} -> {args.flight}",
          flush=True)
    with gw:
        threading.Event().wait()


if __name__ == "__main__":
    main()
