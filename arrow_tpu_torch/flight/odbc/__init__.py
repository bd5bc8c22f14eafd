"""Flight SQL ODBC driver (reference: cpp/src/arrow/flight/sql/odbc/;
counterpart of ``arrow_tpu/flight/odbc/``).

``driver_path()`` builds the native driver shared library on first use
(``arrow_tpu_torch/csrc/odbc_driver.cpp``, a dependency-free ODBC 3.x
driver any driver manager can load) with the host C++ compiler, into
``build/arrow_tpu_torch/`` (``kernels/_build.py``), and returns its path.
The driver forwards statements to an
``arrow_tpu_torch.flight.odbc_gateway.OdbcGateway``, which executes them on
a Flight SQL endpoint. Connection string:

    Driver=<driver_path()>;Gateway_Host=127.0.0.1;Gateway_Port=<port>
"""

from __future__ import annotations


def driver_path() -> str:
    """Path to the built ODBC driver .so. Raises
    ``arrow_tpu_torch.kernels._build.BuildError``, with the compiler's
    exit status and output, where it cannot be built."""
    from ...kernels._build import host_library_file
    return str(host_library_file("odbc_driver"))
