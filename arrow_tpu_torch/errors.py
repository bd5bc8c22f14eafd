"""The exception family (counterpart of ``arrow_tpu/errors.py``; reference:
cpp/src/arrow/status.h's status codes, surfaced in pyarrow as
``pyarrow.lib.Arrow*``).

``ArrowInvalid`` and ``ArrowNotImplementedError`` (``compute.registry``),
``ArrowMemoryError`` (``acero.query_context``, the byte budget's error) and
``CancelledError`` (``cancel``) predate this module; they are re-exported
here so that every error type has one import point.
"""

from .acero.query_context import ArrowMemoryError  # noqa: F401
from .cancel import CancelledError as ArrowCancelled  # noqa: F401
from .compute.registry import (  # noqa: F401
    ArrowInvalid, ArrowNotImplementedError)


class ArrowException(Exception):
    """The base of the Arrow errors that map to no builtin."""


class ArrowTypeError(TypeError):
    pass


class ArrowKeyError(KeyError):
    pass


class ArrowIndexError(IndexError):
    pass


class ArrowCapacityError(ArrowException):
    pass


class ArrowSerializationError(ArrowException):
    pass


ArrowIOError = IOError
