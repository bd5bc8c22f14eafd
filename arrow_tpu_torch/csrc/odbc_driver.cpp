// The ODBC driver of arrow_tpu_torch (the port's copy of
// arrow_tpu/flight/odbc/driver.cpp).
//
// Reference analogue: cpp/src/arrow/flight/sql/odbc/ — the reference
// builds its ODBC driver on the C++ Flight SQL client; this driver is a
// dependency-free C++ shim implementing the ODBC 3.x entry points a
// driver manager (unixODBC libodbc) calls, and forwards statements over
// a length-prefixed socket protocol to the ODBC gateway
// (arrow_tpu_torch/flight/odbc_gateway.py), which executes them against a
// Flight SQL endpoint. The ODBC types/constants below follow the
// public Microsoft ODBC 3.x ABI (stable since 1996); no sql.h needed.
//
// Connection string keys: GATEWAY_HOST (default 127.0.0.1),
// GATEWAY_PORT (required). Example:
//   Driver=/path/libodbc_driver-<hash>.so;Gateway_Port=31337
//
// Built with the host compiler by arrow_tpu_torch/kernels/_build.py
// (host_library_file("odbc_driver")); by hand:
//   g++ -O3 -std=c++17 -shared -fPIC -pthread -o libodbc_driver.so odbc_driver.cpp

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

// ---- ODBC ABI (public, fixed) ---------------------------------------------
using SQLRETURN = int16_t;
using SQLSMALLINT = int16_t;
using SQLUSMALLINT = uint16_t;
using SQLINTEGER = int32_t;
using SQLUINTEGER = uint32_t;
using SQLLEN = intptr_t;
using SQLULEN = uintptr_t;
using SQLCHAR = unsigned char;
using SQLHANDLE = void*;
using SQLHENV = void*;
using SQLHDBC = void*;
using SQLHSTMT = void*;
using SQLPOINTER = void*;

#define SQL_SUCCESS 0
#define SQL_SUCCESS_WITH_INFO 1
#define SQL_NO_DATA 100
#define SQL_ERROR (-1)
#define SQL_INVALID_HANDLE (-2)

#define SQL_HANDLE_ENV 1
#define SQL_HANDLE_DBC 2
#define SQL_HANDLE_STMT 3

#define SQL_NULL_DATA (-1)
#define SQL_NTS (-3)

// C data types
#define SQL_C_CHAR 1
#define SQL_C_LONG 4
#define SQL_C_SHORT 5
#define SQL_C_DOUBLE 8
#define SQL_C_DEFAULT 99
#define SQL_C_SBIGINT (-25)
#define SQL_C_BIT (-7)

// SQL data types
#define SQL_CHAR 1
#define SQL_INTEGER 4
#define SQL_DOUBLE 8
#define SQL_VARCHAR 12
#define SQL_TYPE_DATE 91
#define SQL_TYPE_TIMESTAMP 93
#define SQL_BIGINT (-5)
#define SQL_BIT (-7)

#define SQL_NO_NULLS 0
#define SQL_NULLABLE 1

// GetInfo keys
#define SQL_DRIVER_NAME 6
#define SQL_DRIVER_VER 7
#define SQL_DRIVER_ODBC_VER 77
#define SQL_DBMS_NAME 17
#define SQL_DBMS_VER 18
#define SQL_GETDATA_EXTENSIONS 81
#define SQL_CURSOR_COMMIT_BEHAVIOR 23
#define SQL_CURSOR_ROLLBACK_BEHAVIOR 24
#define SQL_TXN_CAPABLE 46

#define SQL_ATTR_ODBC_VERSION 200

// ---- handles ---------------------------------------------------------------
namespace {

struct Env {
  int32_t odbc_version = 3;
};

struct Conn {
  int fd = -1;
  std::string last_error;
  bool connected = false;
};

struct Col {
  std::string name;
  uint8_t typecode = 3;  // gateway typecode
};

struct Bound {
  SQLUSMALLINT col = 0;          // 1-based
  SQLSMALLINT c_type = SQL_C_CHAR;
  SQLPOINTER value = nullptr;
  SQLLEN buflen = 0;
  SQLLEN* ind = nullptr;
};

struct Stmt {
  Conn* conn = nullptr;
  std::string sql;
  std::vector<Col> cols;
  // row-major cells; (null, text)
  std::vector<std::pair<bool, std::string>> cells;
  size_t nrows = 0;
  size_t cursor = 0;  // next row to fetch (1 past after SQLFetch)
  bool has_result = false;
  std::string last_error;
  std::vector<Bound> bindings;
};

std::mutex g_mutex;

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t w = ::send(fd, p, n, 0);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Parse "k1=v1;k2=v2" (case-insensitive keys).
std::string conn_value(const std::string& s, const char* key) {
  std::string low;
  low.reserve(s.size());
  for (char c : s) low.push_back(static_cast<char>(tolower(c)));
  std::string k(key);
  for (auto& c : k) c = static_cast<char>(tolower(c));
  size_t pos = 0;
  while (pos < low.size()) {
    size_t eq = low.find('=', pos);
    if (eq == std::string::npos) break;
    size_t end = low.find(';', eq);
    if (end == std::string::npos) end = low.size();
    std::string cur = low.substr(pos, eq - pos);
    // trim
    while (!cur.empty() && isspace((unsigned char)cur.front()))
      cur.erase(cur.begin());
    while (!cur.empty() && isspace((unsigned char)cur.back()))
      cur.pop_back();
    if (cur == k) return s.substr(eq + 1, end - eq - 1);
    pos = end + (end < low.size() ? 1 : 0);
  }
  return "";
}

bool execute_remote(Stmt* st) {
  Conn* c = st->conn;
  st->cols.clear();
  st->cells.clear();
  st->nrows = 0;
  st->cursor = 0;
  st->has_result = false;
  // request: [u32 len]['X' sql]
  uint32_t len = static_cast<uint32_t>(1 + st->sql.size());
  std::string req;
  req.resize(4 + len);
  memcpy(&req[0], &len, 4);
  req[4] = 'X';
  memcpy(&req[5], st->sql.data(), st->sql.size());
  if (!send_all(c->fd, req.data(), req.size())) {
    st->last_error = "gateway send failed";
    return false;
  }
  uint32_t rlen = 0;
  if (!recv_all(c->fd, &rlen, 4)) {
    st->last_error = "gateway recv failed";
    return false;
  }
  std::vector<char> resp(rlen);
  if (!recv_all(c->fd, resp.data(), rlen)) {
    st->last_error = "gateway recv failed";
    return false;
  }
  size_t off = 0;
  auto rd_u32 = [&](uint32_t* v) {
    memcpy(v, &resp[off], 4);
    off += 4;
  };
  uint32_t status = 0;
  rd_u32(&status);
  if (status != 0) {
    uint32_t mlen = 0;
    rd_u32(&mlen);
    st->last_error.assign(&resp[off], mlen);
    return false;
  }
  uint32_t ncols = 0;
  rd_u32(&ncols);
  for (uint32_t i = 0; i < ncols; ++i) {
    uint16_t nl = 0;
    memcpy(&nl, &resp[off], 2);
    off += 2;
    Col col;
    col.name.assign(&resp[off], nl);
    off += nl;
    col.typecode = static_cast<uint8_t>(resp[off]);
    off += 1;
    st->cols.push_back(std::move(col));
  }
  uint64_t nrows = 0;
  memcpy(&nrows, &resp[off], 8);
  off += 8;
  st->nrows = static_cast<size_t>(nrows);
  st->cells.reserve(st->nrows * ncols);
  for (uint64_t i = 0; i < nrows * ncols; ++i) {
    uint32_t vl = 0;
    rd_u32(&vl);
    if (vl == 0xFFFFFFFFu) {
      st->cells.emplace_back(true, std::string());
    } else {
      st->cells.emplace_back(false, std::string(&resp[off], vl));
      off += vl;
    }
  }
  st->has_result = true;
  return true;
}

SQLSMALLINT sql_type_of(uint8_t tc) {
  switch (tc) {
    case 1: return SQL_BIGINT;
    case 2: return SQL_DOUBLE;
    case 4: return SQL_BIT;
    case 5: return SQL_TYPE_DATE;
    case 6: return SQL_TYPE_TIMESTAMP;
    default: return SQL_VARCHAR;
  }
}

SQLRETURN put_data(Stmt* st, SQLUSMALLINT icol, SQLSMALLINT c_type,
                   SQLPOINTER value, SQLLEN buflen, SQLLEN* ind,
                   size_t row) {
  if (icol < 1 || icol > st->cols.size()) return SQL_ERROR;
  const auto& cell = st->cells[row * st->cols.size() + (icol - 1)];
  if (cell.first) {
    if (ind) *ind = SQL_NULL_DATA;
    return SQL_SUCCESS;
  }
  const std::string& v = cell.second;
  if (c_type == SQL_C_DEFAULT) c_type = SQL_C_CHAR;
  switch (c_type) {
    case SQL_C_CHAR: {
      if (!value || buflen <= 0) {
        if (ind) *ind = static_cast<SQLLEN>(v.size());
        return SQL_SUCCESS_WITH_INFO;
      }
      size_t ncopy = v.size() < static_cast<size_t>(buflen - 1)
                         ? v.size()
                         : static_cast<size_t>(buflen - 1);
      memcpy(value, v.data(), ncopy);
      static_cast<char*>(value)[ncopy] = 0;
      if (ind) *ind = static_cast<SQLLEN>(v.size());
      return ncopy == v.size() ? SQL_SUCCESS : SQL_SUCCESS_WITH_INFO;
    }
    case SQL_C_SBIGINT: {
      int64_t x = strtoll(v.c_str(), nullptr, 10);
      memcpy(value, &x, 8);
      if (ind) *ind = 8;
      return SQL_SUCCESS;
    }
    case SQL_C_LONG: {
      int32_t x = static_cast<int32_t>(strtoll(v.c_str(), nullptr, 10));
      memcpy(value, &x, 4);
      if (ind) *ind = 4;
      return SQL_SUCCESS;
    }
    case SQL_C_SHORT: {
      int16_t x = static_cast<int16_t>(strtoll(v.c_str(), nullptr, 10));
      memcpy(value, &x, 2);
      if (ind) *ind = 2;
      return SQL_SUCCESS;
    }
    case SQL_C_DOUBLE: {
      double x = strtod(v.c_str(), nullptr);
      memcpy(value, &x, 8);
      if (ind) *ind = 8;
      return SQL_SUCCESS;
    }
    case SQL_C_BIT: {
      uint8_t x = (v == "1" || v == "true" || v == "True") ? 1 : 0;
      memcpy(value, &x, 1);
      if (ind) *ind = 1;
      return SQL_SUCCESS;
    }
    default:
      return SQL_ERROR;
  }
}

std::string g_env_error;  // diagnostics for env-level failures

}  // namespace

// ---- entry points -----------------------------------------------------------
extern "C" {

SQLRETURN SQLAllocHandle(SQLSMALLINT type, SQLHANDLE input,
                         SQLHANDLE* out) {
  std::lock_guard<std::mutex> g(g_mutex);
  if (!out) return SQL_ERROR;
  switch (type) {
    case SQL_HANDLE_ENV:
      *out = new Env();
      return SQL_SUCCESS;
    case SQL_HANDLE_DBC:
      if (!input) return SQL_INVALID_HANDLE;
      *out = new Conn();
      return SQL_SUCCESS;
    case SQL_HANDLE_STMT: {
      if (!input) return SQL_INVALID_HANDLE;
      Stmt* st = new Stmt();
      st->conn = static_cast<Conn*>(input);
      *out = st;
      return SQL_SUCCESS;
    }
    default:
      return SQL_ERROR;
  }
}

SQLRETURN SQLFreeHandle(SQLSMALLINT type, SQLHANDLE h) {
  std::lock_guard<std::mutex> g(g_mutex);
  if (!h) return SQL_INVALID_HANDLE;
  switch (type) {
    case SQL_HANDLE_ENV:
      delete static_cast<Env*>(h);
      return SQL_SUCCESS;
    case SQL_HANDLE_DBC: {
      Conn* c = static_cast<Conn*>(h);
      if (c->fd >= 0) ::close(c->fd);
      delete c;
      return SQL_SUCCESS;
    }
    case SQL_HANDLE_STMT:
      delete static_cast<Stmt*>(h);
      return SQL_SUCCESS;
    default:
      return SQL_ERROR;
  }
}

SQLRETURN SQLSetEnvAttr(SQLHENV, SQLINTEGER attr, SQLPOINTER value,
                        SQLINTEGER) {
  (void)attr;
  (void)value;
  return SQL_SUCCESS;
}

SQLRETURN SQLSetConnectAttr(SQLHDBC, SQLINTEGER, SQLPOINTER, SQLINTEGER) {
  return SQL_SUCCESS;
}

SQLRETURN SQLSetStmtAttr(SQLHSTMT, SQLINTEGER, SQLPOINTER, SQLINTEGER) {
  return SQL_SUCCESS;
}

SQLRETURN SQLDriverConnect(SQLHDBC hdbc, SQLHANDLE /*hwnd*/,
                           SQLCHAR* in_conn, SQLSMALLINT in_len,
                           SQLCHAR* out_conn, SQLSMALLINT out_max,
                           SQLSMALLINT* out_len,
                           SQLUSMALLINT /*completion*/) {
  Conn* c = static_cast<Conn*>(hdbc);
  if (!c) return SQL_INVALID_HANDLE;
  std::string s(reinterpret_cast<char*>(in_conn),
                in_len == SQL_NTS
                    ? strlen(reinterpret_cast<char*>(in_conn))
                    : static_cast<size_t>(in_len));
  std::string host = conn_value(s, "gateway_host");
  if (host.empty()) host = "127.0.0.1";
  std::string port_s = conn_value(s, "gateway_port");
  if (port_s.empty()) {
    c->last_error = "GATEWAY_PORT missing in connection string";
    return SQL_ERROR;
  }
  int port = atoi(port_s.c_str());
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    c->last_error = "socket() failed";
    return SQL_ERROR;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    ::close(fd);
    c->last_error = "bad GATEWAY_HOST";
    return SQL_ERROR;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr),
                sizeof(addr)) != 0) {
    ::close(fd);
    c->last_error = "gateway connect failed";
    return SQL_ERROR;
  }
  c->fd = fd;
  c->connected = true;
  if (out_conn && out_max > 0) {
    size_t n = s.size() < static_cast<size_t>(out_max - 1)
                   ? s.size()
                   : static_cast<size_t>(out_max - 1);
    memcpy(out_conn, s.data(), n);
    out_conn[n] = 0;
    if (out_len) *out_len = static_cast<SQLSMALLINT>(s.size());
  }
  return SQL_SUCCESS;
}

SQLRETURN SQLConnect(SQLHDBC hdbc, SQLCHAR* dsn, SQLSMALLINT dsn_len,
                     SQLCHAR*, SQLSMALLINT, SQLCHAR*, SQLSMALLINT) {
  // DSN-less only: treat the DSN text as a connection string
  return SQLDriverConnect(hdbc, nullptr, dsn, dsn_len, nullptr, 0,
                          nullptr, 0);
}

SQLRETURN SQLDisconnect(SQLHDBC hdbc) {
  Conn* c = static_cast<Conn*>(hdbc);
  if (!c) return SQL_INVALID_HANDLE;
  if (c->fd >= 0) {
    uint32_t len = 1;
    char req[5];
    memcpy(req, &len, 4);
    req[4] = 'Q';
    send_all(c->fd, req, 5);
    ::close(c->fd);
    c->fd = -1;
  }
  c->connected = false;
  return SQL_SUCCESS;
}

SQLRETURN SQLExecDirect(SQLHSTMT hstmt, SQLCHAR* text, SQLINTEGER len) {
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st || !st->conn || st->conn->fd < 0) return SQL_INVALID_HANDLE;
  st->sql.assign(reinterpret_cast<char*>(text),
                 len == SQL_NTS ? strlen(reinterpret_cast<char*>(text))
                                : static_cast<size_t>(len));
  return execute_remote(st) ? SQL_SUCCESS : SQL_ERROR;
}

SQLRETURN SQLPrepare(SQLHSTMT hstmt, SQLCHAR* text, SQLINTEGER len) {
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st) return SQL_INVALID_HANDLE;
  st->sql.assign(reinterpret_cast<char*>(text),
                 len == SQL_NTS ? strlen(reinterpret_cast<char*>(text))
                                : static_cast<size_t>(len));
  return SQL_SUCCESS;
}

SQLRETURN SQLExecute(SQLHSTMT hstmt) {
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st || !st->conn || st->conn->fd < 0) return SQL_INVALID_HANDLE;
  return execute_remote(st) ? SQL_SUCCESS : SQL_ERROR;
}

SQLRETURN SQLNumResultCols(SQLHSTMT hstmt, SQLSMALLINT* n) {
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st || !n) return SQL_INVALID_HANDLE;
  *n = static_cast<SQLSMALLINT>(st->cols.size());
  return SQL_SUCCESS;
}

SQLRETURN SQLRowCount(SQLHSTMT hstmt, SQLLEN* n) {
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st || !n) return SQL_INVALID_HANDLE;
  *n = static_cast<SQLLEN>(st->nrows);
  return SQL_SUCCESS;
}

SQLRETURN SQLDescribeCol(SQLHSTMT hstmt, SQLUSMALLINT icol,
                         SQLCHAR* name, SQLSMALLINT name_max,
                         SQLSMALLINT* name_len, SQLSMALLINT* sql_type,
                         SQLULEN* col_size, SQLSMALLINT* decimals,
                         SQLSMALLINT* nullable) {
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st || icol < 1 || icol > st->cols.size())
    return SQL_INVALID_HANDLE;
  const Col& c = st->cols[icol - 1];
  if (name && name_max > 0) {
    size_t n = c.name.size() < static_cast<size_t>(name_max - 1)
                   ? c.name.size()
                   : static_cast<size_t>(name_max - 1);
    memcpy(name, c.name.data(), n);
    name[n] = 0;
  }
  if (name_len) *name_len = static_cast<SQLSMALLINT>(c.name.size());
  if (sql_type) *sql_type = sql_type_of(c.typecode);
  if (col_size) *col_size = c.typecode == 3 ? 65535 : 20;
  if (decimals) *decimals = 0;
  if (nullable) *nullable = SQL_NULLABLE;
  return SQL_SUCCESS;
}

SQLRETURN SQLBindCol(SQLHSTMT hstmt, SQLUSMALLINT icol,
                     SQLSMALLINT c_type, SQLPOINTER value, SQLLEN buflen,
                     SQLLEN* ind) {
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st) return SQL_INVALID_HANDLE;
  for (auto& b : st->bindings) {
    if (b.col == icol) {
      b = Bound{icol, c_type, value, buflen, ind};
      return SQL_SUCCESS;
    }
  }
  st->bindings.push_back(Bound{icol, c_type, value, buflen, ind});
  return SQL_SUCCESS;
}

SQLRETURN SQLFetch(SQLHSTMT hstmt) {
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st) return SQL_INVALID_HANDLE;
  if (!st->has_result || st->cursor >= st->nrows) return SQL_NO_DATA;
  size_t row = st->cursor++;
  for (const auto& b : st->bindings) {
    if (b.value == nullptr) continue;
    SQLRETURN r = put_data(st, b.col, b.c_type, b.value, b.buflen,
                           b.ind, row);
    if (r == SQL_ERROR) return SQL_ERROR;
  }
  return SQL_SUCCESS;
}

SQLRETURN SQLGetData(SQLHSTMT hstmt, SQLUSMALLINT icol,
                     SQLSMALLINT c_type, SQLPOINTER value, SQLLEN buflen,
                     SQLLEN* ind) {
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st) return SQL_INVALID_HANDLE;
  if (!st->has_result || st->cursor == 0 || st->cursor > st->nrows)
    return SQL_ERROR;
  return put_data(st, icol, c_type, value, buflen, ind, st->cursor - 1);
}

SQLRETURN SQLMoreResults(SQLHSTMT) { return SQL_NO_DATA; }

#define SQL_CLOSE 0
#define SQL_UNBIND 2
#define SQL_RESET_PARAMS 3

SQLRETURN SQLFreeStmt(SQLHSTMT hstmt, SQLUSMALLINT option) {
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st) return SQL_INVALID_HANDLE;
  if (option == SQL_CLOSE) {
    st->cells.clear();
    st->cols.clear();
    st->nrows = 0;
    st->cursor = 0;
    st->has_result = false;
  } else if (option == SQL_UNBIND) {
    st->bindings.clear();
  }
  return SQL_SUCCESS;
}

SQLRETURN SQLEndTran(SQLSMALLINT, SQLHANDLE, SQLSMALLINT) {
  return SQL_SUCCESS;  // autocommit engine
}

SQLRETURN SQLCancel(SQLHSTMT) { return SQL_SUCCESS; }

SQLRETURN SQLGetInfo(SQLHDBC, SQLUSMALLINT key, SQLPOINTER value,
                     SQLSMALLINT buflen, SQLSMALLINT* outlen) {
  const char* s = nullptr;
  switch (key) {
    case SQL_DRIVER_NAME: s = "libodbc_driver.so"; break;
    case SQL_DRIVER_VER: s = "01.00.0000"; break;
    case SQL_DRIVER_ODBC_VER: s = "03.00"; break;
    case SQL_DBMS_NAME: s = "arrow_tpu_torch"; break;
    case SQL_DBMS_VER: s = "01.00.0000"; break;
    default: break;
  }
  if (s) {
    size_t n = strlen(s);
    if (value && buflen > 0) {
      size_t ncopy = n < static_cast<size_t>(buflen - 1)
                         ? n
                         : static_cast<size_t>(buflen - 1);
      memcpy(value, s, ncopy);
      static_cast<char*>(value)[ncopy] = 0;
    }
    if (outlen) *outlen = static_cast<SQLSMALLINT>(n);
    return SQL_SUCCESS;
  }
  switch (key) {
    case SQL_GETDATA_EXTENSIONS:
    case SQL_TXN_CAPABLE:
    case SQL_CURSOR_COMMIT_BEHAVIOR:
    case SQL_CURSOR_ROLLBACK_BEHAVIOR: {
      if (value) memset(value, 0, 4);
      if (outlen) *outlen = 4;
      return SQL_SUCCESS;
    }
    default:
      if (value && buflen >= 4) memset(value, 0, 4);
      if (outlen) *outlen = 4;
      return SQL_SUCCESS;
  }
}

SQLRETURN SQLGetDiagRec(SQLSMALLINT type, SQLHANDLE h, SQLSMALLINT rec,
                        SQLCHAR* state, SQLINTEGER* native,
                        SQLCHAR* text, SQLSMALLINT text_max,
                        SQLSMALLINT* text_len) {
  if (rec != 1 || !h) return SQL_NO_DATA;
  std::string msg;
  if (type == SQL_HANDLE_STMT) msg = static_cast<Stmt*>(h)->last_error;
  else if (type == SQL_HANDLE_DBC)
    msg = static_cast<Conn*>(h)->last_error;
  else
    msg = g_env_error;
  if (msg.empty()) return SQL_NO_DATA;
  if (state) memcpy(state, "HY000", 6);
  if (native) *native = 1;
  if (text && text_max > 0) {
    size_t n = msg.size() < static_cast<size_t>(text_max - 1)
                   ? msg.size()
                   : static_cast<size_t>(text_max - 1);
    memcpy(text, msg.data(), n);
    text[n] = 0;
  }
  if (text_len) *text_len = static_cast<SQLSMALLINT>(msg.size());
  return SQL_SUCCESS;
}

SQLRETURN SQLGetDiagField(SQLSMALLINT, SQLHANDLE, SQLSMALLINT,
                          SQLSMALLINT, SQLPOINTER, SQLSMALLINT,
                          SQLSMALLINT*) {
  return SQL_NO_DATA;
}

SQLRETURN SQLColAttribute(SQLHSTMT hstmt, SQLUSMALLINT icol,
                          SQLUSMALLINT field, SQLPOINTER char_attr,
                          SQLSMALLINT buflen, SQLSMALLINT* outlen,
                          SQLLEN* num_attr) {
#define SQL_DESC_NAME 1011
#define SQL_DESC_TYPE 1002
#define SQL_DESC_CONCISE_TYPE 2
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st || icol < 1 || icol > st->cols.size())
    return SQL_INVALID_HANDLE;
  const Col& c = st->cols[icol - 1];
  switch (field) {
    case SQL_DESC_NAME: {
      if (char_attr && buflen > 0) {
        size_t n = c.name.size() < static_cast<size_t>(buflen - 1)
                       ? c.name.size()
                       : static_cast<size_t>(buflen - 1);
        memcpy(char_attr, c.name.data(), n);
        static_cast<char*>(char_attr)[n] = 0;
      }
      if (outlen) *outlen = static_cast<SQLSMALLINT>(c.name.size());
      return SQL_SUCCESS;
    }
    case SQL_DESC_TYPE:
    case SQL_DESC_CONCISE_TYPE:
      if (num_attr) *num_attr = sql_type_of(c.typecode);
      return SQL_SUCCESS;
    default:
      if (num_attr) *num_attr = 0;
      return SQL_SUCCESS;
  }
}

SQLRETURN SQLTables(SQLHSTMT hstmt, SQLCHAR*, SQLSMALLINT, SQLCHAR*,
                    SQLSMALLINT, SQLCHAR*, SQLSMALLINT, SQLCHAR*,
                    SQLSMALLINT) {
  // not surfaced through the gateway protocol yet
  Stmt* st = static_cast<Stmt*>(hstmt);
  if (!st) return SQL_INVALID_HANDLE;
  st->cols.clear();
  st->cells.clear();
  st->nrows = 0;
  st->cursor = 0;
  st->has_result = true;
  return SQL_SUCCESS;
}

}  // extern "C"
