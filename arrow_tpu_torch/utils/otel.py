"""OpenTelemetry export of a query's execution (counterpart of
``arrow_tpu/utils/otel.py``; reference: cpp/src/arrow/util/tracing.h and
tracing_internal.cc, Acero's spans through opentelemetry-cpp).

A ``QueryContext``'s node metrics become OTLP/JSON ResourceSpans (the
protobuf-JSON mapping of opentelemetry-proto trace/v1/trace.proto): one
root span for the plan and one span a node, laid end to end in dispatch
order up to the export time, each with its output bytes and seconds. They
are appended as one JSON line to a file, or POSTed to an OTLP/HTTP
collector, with no third-party package.

``ARROW_TPU_OTEL_EXPORT=<path or http(s) URL>`` exports every plan run
with ``to_table(query_options=...)``; ``export_query(qc, destination)``
exports one context.
"""

from __future__ import annotations

import json
import os
import secrets
import time
from typing import Optional

_SPAN_KIND_INTERNAL = 1


def _otlp_payload(node_metrics, plan_name: str,
                  end_unix_nano: Optional[int] = None) -> dict:
    """The OTLP/JSON ExportTraceServiceRequest of one run:
    ``node_metrics`` is [(factory_name, seconds, out_bytes), ...] in
    dispatch order."""
    end = end_unix_nano or time.time_ns()
    total_s = sum(s for _f, s, _b in node_metrics) or 1e-9
    trace_id = secrets.token_hex(16)
    root_id = secrets.token_hex(8)
    start = end - int(total_s * 1e9)
    spans = [{
        "traceId": trace_id,
        "spanId": root_id,
        "name": plan_name,
        "kind": _SPAN_KIND_INTERNAL,
        "startTimeUnixNano": str(start),
        "endTimeUnixNano": str(end),
        "attributes": [
            {"key": "arrow.engine", "value": {"stringValue": "arrow_tpu"}},
            {"key": "arrow.node_count",
             "value": {"intValue": str(len(node_metrics))}},
        ],
    }]
    t = start
    for factory, seconds, out_bytes in node_metrics:
        t2 = t + int(seconds * 1e9)
        spans.append({
            "traceId": trace_id,
            "spanId": secrets.token_hex(8),
            "parentSpanId": root_id,
            "name": factory,
            "kind": _SPAN_KIND_INTERNAL,
            "startTimeUnixNano": str(t),
            "endTimeUnixNano": str(t2),
            "attributes": [
                {"key": "arrow.out_bytes",
                 "value": {"intValue": str(int(out_bytes))}},
                {"key": "arrow.seconds", "value": {"doubleValue": seconds}},
            ],
        })
        t = t2
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name", "value": {"stringValue": "arrow_tpu"}},
        ]},
        "scopeSpans": [{"scope": {"name": "arrow_tpu.acero"},
                        "spans": spans}],
    }]}


def export_query(query_context, destination: Optional[str] = None,
                 plan_name: str = "acero.plan") -> Optional[dict]:
    """Export a finished QueryContext's node metrics as OTLP/JSON to
    ``destination`` (a file path, one JSON line appended; an http(s) URL,
    POSTed) or, where None, to ``ARROW_TPU_OTEL_EXPORT``. Returns the
    payload, or None where no destination is set. A failed export does
    not fail the query."""
    dest = destination or os.environ.get("ARROW_TPU_OTEL_EXPORT")
    if not dest:
        return None
    payload = _otlp_payload(getattr(query_context, "node_metrics", None)
                            or [], plan_name)
    if dest.startswith(("http://", "https://")):
        import urllib.request
        req = urllib.request.Request(
            dest, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            urllib.request.urlopen(req, timeout=10).close()
        except Exception:  # noqa: BLE001 - tracing never fails a query
            pass
    else:
        try:
            with open(dest, "a") as f:
                f.write(json.dumps(payload) + "\n")
        except OSError:
            pass
    return payload
