"""The brotli codec over the system libbrotli, by ctypes (counterpart of
``arrow_tpu/utils/brotli_ctypes.py``; reference:
cpp/src/arrow/util/compression_brotli.cc, one-shot BrotliEncoderCompress /
BrotliDecoderDecompress at quality 8 and window 22, the reference's
kBrotliDefaultCompressionLevel and window).

Where libbrotli does not load, ``available()`` is False and
``compress``/``decompress`` raise NotImplementedError, as the reference's
do."""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

_enc = _dec = None


def _load():
    global _enc, _dec
    if _enc is not None:
        return True
    try:
        enc_name = ctypes.util.find_library("brotlienc") or \
            "libbrotlienc.so.1"
        dec_name = ctypes.util.find_library("brotlidec") or \
            "libbrotlidec.so.1"
        enc = ctypes.CDLL(enc_name)
        dec = ctypes.CDLL(dec_name)
        enc.BrotliEncoderCompress.restype = ctypes.c_int
        enc.BrotliEncoderCompress.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_char_p]
        enc.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
        enc.BrotliEncoderMaxCompressedSize.argtypes = [ctypes.c_size_t]
        dec.BrotliDecoderDecompress.restype = ctypes.c_int
        dec.BrotliDecoderDecompress.argtypes = [
            ctypes.c_size_t, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
    except OSError:
        return False
    _enc, _dec = enc, dec
    return True


def available() -> bool:
    return _load()


def compress(data: bytes, quality: int = 8, lgwin: int = 22) -> bytes:
    if not _load():
        raise NotImplementedError("libbrotli not available")
    data = bytes(data)
    max_out = _enc.BrotliEncoderMaxCompressedSize(len(data)) or \
        (len(data) + 1024)
    out = ctypes.create_string_buffer(max_out)
    out_len = ctypes.c_size_t(max_out)
    ok = _enc.BrotliEncoderCompress(quality, lgwin, 0, len(data), data,
                                    ctypes.byref(out_len), out)
    if not ok:
        raise RuntimeError("brotli compression failed")
    return out.raw[:out_len.value]


def decompress(data: bytes,
               decompressed_size: Optional[int] = None) -> bytes:
    if not _load():
        raise NotImplementedError("libbrotli not available")
    data = bytes(data)
    # one-shot with known size, else geometric growth retries
    sizes = ([decompressed_size] if decompressed_size else
             [max(4 * len(data), 1 << 16) << i for i in range(12)])
    for cap in sizes:
        out = ctypes.create_string_buffer(cap)
        out_len = ctypes.c_size_t(cap)
        res = _dec.BrotliDecoderDecompress(len(data), data,
                                           ctypes.byref(out_len), out)
        if res == 1:  # BROTLI_DECODER_RESULT_SUCCESS
            return out.raw[:out_len.value]
    raise RuntimeError("brotli decompression failed")
