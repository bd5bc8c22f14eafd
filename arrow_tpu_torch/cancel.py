"""Cooperative cancellation (counterpart of ``arrow_tpu/cancel.py``).

Reference analogue: util/cancel.h:37,58 (StopSource/StopToken,
RequestStopFromSignal). The executor polls between plan nodes and between
the chunks of a streamed plan; work already queued on the card completes
(kernels are not interruptible), as in the reference's cooperative model.
"""

from __future__ import annotations

import signal
import threading


class CancelledError(RuntimeError):
    pass


class StopToken:
    __slots__ = ("_source",)

    def __init__(self, source: "StopSource"):
        self._source = source

    def is_stop_requested(self) -> bool:
        return self._source._stopped.is_set()

    def poll(self):
        if self.is_stop_requested():
            raise CancelledError("operation cancelled")


class StopSource:
    def __init__(self):
        self._stopped = threading.Event()

    def request_stop(self):
        self._stopped.set()

    def reset(self):
        self._stopped.clear()

    def token(self) -> StopToken:
        return StopToken(self)


_default_source = StopSource()


def default_stop_source() -> StopSource:
    return _default_source


def default_stop_token() -> StopToken:
    return _default_source.token()


def setup_signal_stop_source(signals=(signal.SIGINT,)) -> StopSource:
    """Route signals to the default stop source (the signal-safe analogue
    of RequestStopFromSignal)."""
    def handler(signum, frame):
        _default_source.request_stop()
    for s in signals:
        signal.signal(s, handler)
    return _default_source
