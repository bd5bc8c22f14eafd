"""The RLE / bit-packed hybrid encoding of Parquet's levels and dictionary
indices (counterpart of ``arrow_tpu/io/parquet/rle.py``; reference:
cpp/src/arrow/util/rle_encoding_internal.h).

Both directions run in the port's host library (``csrc/parquet_host.cpp``)
at every length: the encoder is the reference's (runs of 8 or more equal
values as RLE runs, the rest bit-packed in groups of 8 up to the next run
of 16), so the pages are the reference's bytes.
"""

from __future__ import annotations

import numpy as np

from . import host


def bit_width_for(max_value: int) -> int:
    return max(int(max_value).bit_length(), 1) if max_value > 0 else 1


def decode_rle(data, pos: int, num_values: int,
               bit_width: int) -> np.ndarray:
    """``num_values`` int64 values of the hybrid stream at ``data[pos:]``."""
    return host.rle_decode(data, pos, num_values, bit_width)


def encode_rle(values: np.ndarray, bit_width: int) -> bytes:
    return host.rle_encode(values, bit_width)
