"""AES-GCM and AES-CTR over the system libcrypto (OpenSSL's EVP interface),
by ctypes, as ``brotli_ctypes`` reaches libbrotli. Parquet's modular
encryption (``io/parquet/encryption.py``) needs nothing else; the reference
uses the ``cryptography`` package for the same ciphers (AESGCM, and
Cipher(AES, CTR)).

* ``gcm_encrypt(key, nonce, plaintext, aad)`` gives the ciphertext and its
  16-byte tag, as ``AESGCM(key).encrypt`` does; ``gcm_decrypt`` checks the
  tag and raises ValueError where it does not match.
* ``ctr_xcrypt(key, iv, data)`` runs AES in counter mode from the 16-byte
  initial counter block ``iv`` (the counter is its last 32 bits, big
  endian, as NIST SP 800-38A's standard incrementing function).

Keys of 16, 24 or 32 bytes choose AES-128, -192 or -256. The library loads
at the first call; where it does not, ``available()`` is False and the
calls raise NotImplementedError. Every call makes its own cipher context,
so calls on several threads do not share state.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

TAG_LEN = 16
_SET_IVLEN, _GET_TAG, _SET_TAG = 0x9, 0x10, 0x11  # EVP_CTRL_GCM_*
_CHUNK = 1 << 30  # the most bytes one EVP update takes here (an int)


@functools.lru_cache(maxsize=None)
def _lib():
    name = ctypes.util.find_library("crypto") or "libcrypto.so.3"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    p, i, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.EVP_CIPHER_CTX_new.restype = p
    lib.EVP_CIPHER_CTX_new.argtypes = []
    lib.EVP_CIPHER_CTX_free.restype = None
    lib.EVP_CIPHER_CTX_free.argtypes = [p]
    lib.EVP_CIPHER_CTX_ctrl.restype = i
    lib.EVP_CIPHER_CTX_ctrl.argtypes = [p, i, i, p]
    for mode in ("gcm", "ctr"):
        for bits in (128, 192, 256):
            fn = getattr(lib, f"EVP_aes_{bits}_{mode}")
            fn.restype = p
            fn.argtypes = []
    for op in ("Encrypt", "Decrypt"):
        fn = getattr(lib, f"EVP_{op}Init_ex")
        fn.restype = i
        fn.argtypes = [p, p, p, p, p]
        fn = getattr(lib, f"EVP_{op}Update")
        fn.restype = i
        fn.argtypes = [p, p, pi, p, i]
        fn = getattr(lib, f"EVP_{op}Final_ex")
        fn.restype = i
        fn.argtypes = [p, p, pi]
    return lib


def available() -> bool:
    return _lib() is not None


def _loaded():
    lib = _lib()
    if lib is None:
        raise NotImplementedError(
            "AES needs the system libcrypto, which did not load")
    return lib


def _cipher(lib, key: bytes, mode: str):
    if len(key) not in (16, 24, 32):
        raise ValueError("an AES key is 16, 24 or 32 bytes")
    return getattr(lib, f"EVP_aes_{len(key) * 8}_{mode}")()


class _Context:
    def __init__(self, lib):
        self.lib = lib
        self.ctx = lib.EVP_CIPHER_CTX_new()
        if not self.ctx:
            raise MemoryError("EVP_CIPHER_CTX_new failed")

    def __enter__(self):
        return self.ctx

    def __exit__(self, *exc):
        self.lib.EVP_CIPHER_CTX_free(self.ctx)


def _check(ok, what):
    if ok != 1:
        raise RuntimeError(f"libcrypto {what} failed")


def _update(lib, op, ctx, data: bytes, out, at: int) -> int:
    """Runs ``data`` through the context into ``out`` from ``at``: the
    bytes written."""
    n = ctypes.c_int(0)
    done = 0
    src = ctypes.c_char_p(data)
    base = ctypes.cast(src, ctypes.c_void_p).value
    dst = ctypes.addressof(out)
    for s in range(0, len(data), _CHUNK):
        step = min(_CHUNK, len(data) - s)
        _check(getattr(lib, f"EVP_{op}Update")(
            ctx, dst + at + done, ctypes.byref(n), base + s, step), op)
        done += n.value
    return done


def _aad(lib, op, ctx, aad: bytes):
    if aad:
        n = ctypes.c_int(0)
        _check(getattr(lib, f"EVP_{op}Update")(
            ctx, None, ctypes.byref(n), aad, len(aad)), f"{op} aad")


def gcm_encrypt(key: bytes, nonce: bytes, plaintext: bytes,
                aad: bytes = b"") -> bytes:
    """AES-GCM: the ciphertext followed by its 16-byte tag."""
    lib = _loaded()
    key, nonce, plaintext = bytes(key), bytes(nonce), bytes(plaintext)
    with _Context(lib) as ctx:
        _check(lib.EVP_EncryptInit_ex(ctx, _cipher(lib, key, "gcm"), None,
                                      None, None), "EncryptInit")
        _check(lib.EVP_CIPHER_CTX_ctrl(ctx, _SET_IVLEN, len(nonce), None),
               "set iv length")
        _check(lib.EVP_EncryptInit_ex(ctx, None, None, key, nonce),
               "EncryptInit key")
        _aad(lib, "Encrypt", ctx, bytes(aad))
        out = ctypes.create_string_buffer(len(plaintext) + TAG_LEN + 16)
        n = _update(lib, "Encrypt", ctx, plaintext, out, 0)
        tail = ctypes.c_int(0)
        _check(lib.EVP_EncryptFinal_ex(ctx, ctypes.addressof(out) + n,
                                       ctypes.byref(tail)), "EncryptFinal")
        n += tail.value
        tag = ctypes.create_string_buffer(TAG_LEN)
        _check(lib.EVP_CIPHER_CTX_ctrl(ctx, _GET_TAG, TAG_LEN, tag),
               "get tag")
        return out.raw[:n] + tag.raw


def gcm_decrypt(key: bytes, nonce: bytes, data: bytes,
                aad: bytes = b"") -> bytes:
    """The plaintext of AES-GCM's ciphertext-and-tag ``data``; ValueError
    where the tag does not match."""
    lib = _loaded()
    key, nonce, data = bytes(key), bytes(nonce), bytes(data)
    if len(data) < TAG_LEN:
        raise ValueError("AES-GCM data shorter than its tag")
    ct, tag = data[:-TAG_LEN], data[-TAG_LEN:]
    with _Context(lib) as ctx:
        _check(lib.EVP_DecryptInit_ex(ctx, _cipher(lib, key, "gcm"), None,
                                      None, None), "DecryptInit")
        _check(lib.EVP_CIPHER_CTX_ctrl(ctx, _SET_IVLEN, len(nonce), None),
               "set iv length")
        _check(lib.EVP_DecryptInit_ex(ctx, None, None, key, nonce),
               "DecryptInit key")
        _aad(lib, "Decrypt", ctx, bytes(aad))
        out = ctypes.create_string_buffer(len(ct) + 16)
        n = _update(lib, "Decrypt", ctx, ct, out, 0)
        _check(lib.EVP_CIPHER_CTX_ctrl(ctx, _SET_TAG, TAG_LEN, tag),
               "set tag")
        tail = ctypes.c_int(0)
        if lib.EVP_DecryptFinal_ex(ctx, ctypes.addressof(out) + n,
                                   ctypes.byref(tail)) != 1:
            raise ValueError("AES-GCM tag mismatch (wrong key or corrupt "
                             "data)")
        return out.raw[:n + tail.value]


def ctr_xcrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-CTR from the initial counter block ``iv`` (16 bytes); the same
    call encrypts and decrypts."""
    lib = _loaded()
    key, iv, data = bytes(key), bytes(iv), bytes(data)
    if len(iv) != 16:
        raise ValueError("an AES-CTR counter block is 16 bytes")
    with _Context(lib) as ctx:
        _check(lib.EVP_EncryptInit_ex(ctx, _cipher(lib, key, "ctr"), None,
                                      key, iv), "EncryptInit")
        out = ctypes.create_string_buffer(len(data) + 16)
        n = _update(lib, "Encrypt", ctx, data, out, 0)
        tail = ctypes.c_int(0)
        _check(lib.EVP_EncryptFinal_ex(ctx, ctypes.addressof(out) + n,
                                       ctypes.byref(tail)), "EncryptFinal")
        return out.raw[:n + tail.value]
