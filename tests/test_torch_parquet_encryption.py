"""Parquet modular encryption in the port
(``arrow_tpu_torch/io/parquet/encryption.py`` over ``utils/aes_ctypes.py``,
the system libcrypto) against the JAX package's (over ``cryptography``),
with pyarrow as an oracle only.

* AES-GCM and AES-CTR against the NIST vectors (SP 800-38D's GCM test
  cases, SP 800-38A's F.5.1) and against ``cryptography`` on inputs from a
  seed;
* with the same random bytes (``os.urandom`` made deterministic for both
  packages), the port's encrypted files are the reference's bytes: every
  algorithm, footer mode, column keys, AAD prefixes, compression, blooms
  and the page index, the KMS layer;
* with real randomness, each package reads the other's files, both
  directions, and pyarrow's KMS files both directions;
* wrong or missing keys fail, statistics survive, filters prune.

Exact throughout (bytes, or Python values).
"""

import base64
import io
import os

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu.io import parquet as rpq
from arrow_tpu.io.parquet import encryption as rpe
from arrow_tpu_torch.io import parquet as pq
from arrow_tpu_torch.io.parquet import encryption as pe
from arrow_tpu_torch.utils import aes_ctypes

from test_torch_host_table import carry_table
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

FOOTER_KEY = b"0123456789112345"
COL_KEY = b"1234567890123450"
MASTER_KEYS = {"kf": b"0123456789012345", "kc": b"1234567890123456"}

H = bytes.fromhex
# (key, iv, plaintext, aad, ciphertext, tag): the GCM spec's test cases
# 2, 3, 4 and 14 (NIST SP 800-38D's reference document)
GCM_VECTORS = [
    (H("00" * 16), H("00" * 12), H("00" * 16), b"",
     H("0388dace60b6a392f328c2b971b2fe78"),
     H("ab6e47d42cec13bdf53a67b21257bddf")),
    (H("feffe9928665731c6d6a8f9467308308"), H("cafebabefacedbaddecaf888"),
     H("d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
       "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255"),
     b"",
     H("42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
       "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091473f5985"),
     H("4d5c2af327cd64a62cf35abd2ba6fab4")),
    (H("feffe9928665731c6d6a8f9467308308"), H("cafebabefacedbaddecaf888"),
     H("d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
       "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b39"),
     H("feedfacedeadbeeffeedfacedeadbeefabaddad2"),
     H("42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
       "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091"),
     H("5bc94fbc3221a5db94fae95ae7121a47")),
    (H("00" * 32), H("00" * 12), H("00" * 16), b"",
     H("cea7403d4d606b6e074ec5d3baf39d18"),
     H("d0d1c8a799996bf0265b98b5d48ab919")),
]
# NIST SP 800-38A F.5.1, CTR-AES128.Encrypt
CTR_VECTOR = (
    H("2b7e151628aed2a6abf7158809cf4f3c"),
    H("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"),
    H("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
      "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710"),
    H("874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
      "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee"))


@pytest.mark.parametrize("case", range(len(GCM_VECTORS)))
def test_gcm_nist_vectors(case):
    aead = pytest.importorskip(
        "cryptography.hazmat.primitives.ciphers.aead")
    key, iv, pt, aad, ct, tag = GCM_VECTORS[case]
    assert aes_ctypes.gcm_encrypt(key, iv, pt, aad) == ct + tag
    assert aead.AESGCM(key).encrypt(iv, pt, aad or None) == ct + tag
    assert aes_ctypes.gcm_decrypt(key, iv, ct + tag, aad) == pt
    with pytest.raises(ValueError, match="tag"):
        aes_ctypes.gcm_decrypt(key, iv, ct + tag[:-1] + b"\x00", aad)


def test_ctr_nist_vector_and_random_inputs():
    ciphers = pytest.importorskip("cryptography.hazmat.primitives.ciphers")
    key, iv, pt, ct = CTR_VECTOR
    assert aes_ctypes.ctr_xcrypt(key, iv, pt) == ct
    assert aes_ctypes.ctr_xcrypt(key, iv, ct) == pt
    rng = np.random.default_rng(12)
    for klen in (16, 24, 32):
        for n in (0, 1, 15, 16, 17, 4097):
            k, nonce, data, aad = (rng.bytes(klen), rng.bytes(12),
                                   rng.bytes(n), rng.bytes(n % 29))
            want = ciphers.aead.AESGCM(k).encrypt(nonce, data, aad)
            assert aes_ctypes.gcm_encrypt(k, nonce, data, aad) == want
            assert aes_ctypes.gcm_decrypt(k, nonce, want, aad) == data
            block = nonce + b"\x00\x00\x00\x01"
            enc = ciphers.Cipher(ciphers.algorithms.AES(k),
                                 ciphers.modes.CTR(block)).encryptor()
            assert aes_ctypes.ctr_xcrypt(k, block, data) == \
                enc.update(data) + enc.finalize()
    with pytest.raises(ValueError, match="16, 24 or 32"):
        aes_ctypes.gcm_encrypt(b"short", H("00" * 12), b"x")


def _tables():
    rng = np.random.default_rng(21)
    n = 400
    rt = at.table({
        "a": at.array([None if v % 11 == 0 else int(v)
                       for v in rng.integers(0, 10**6, n)], at.int64()),
        "b": at.array([None if v == 3 else f"w{int(v)}"
                       for v in rng.integers(0, 9, n)], at.string()),
        "c": at.array([float(v) for v in rng.normal(size=n)], at.float64()),
    })
    return rt, carry_table(rt)


@pytest.fixture(scope="module")
def tables():
    return _tables()


class _Kms:
    """A test KMS: AES-GCM wrap under the master key (nonce||ct, base64),
    written with libcrypto for either package."""

    def __init__(self, *args):
        pass

    def wrap_key(self, key_bytes, master_key_identifier):
        nonce = os.urandom(12)
        ct = aes_ctypes.gcm_encrypt(MASTER_KEYS[master_key_identifier],
                                    nonce, key_bytes)
        return base64.b64encode(nonce + ct).decode()

    def unwrap_key(self, wrapped_key, master_key_identifier):
        raw = base64.b64decode(wrapped_key)
        return aes_ctypes.gcm_decrypt(MASTER_KEYS[master_key_identifier],
                                      raw[:12], raw[12:])


def _props(mod, case):
    """(encryption, decryption) properties of ``mod`` for a case."""
    if case == "kms":
        factory = mod.CryptoFactory(lambda cfg: _Kms())
        return (factory.file_encryption_properties(
            mod.KmsConnectionConfig(), mod.EncryptionConfiguration(
                footer_key="kf", column_keys={"kc": ["a", "b"]})),
            factory.file_decryption_properties(mod.KmsConnectionConfig()))
    kw = {
        "uniform": {},
        "ctr": {"algorithm": mod.ALG_AES_GCM_CTR_V1},
        "column keys": {"column_keys": {"a": COL_KEY}},
        "aad prefix": {"aad_prefix": b"file1"},
        "supplied aad": {"aad_prefix": b"file2", "supply_aad_prefix": True},
        "plaintext footer": {"plaintext_footer": True},
        "plaintext footer, column keys": {"plaintext_footer": True,
                                          "column_keys": {"a": COL_KEY}},
    }[case]
    enc = mod.FileEncryptionProperties(FOOTER_KEY, **kw)
    dec = mod.FileDecryptionProperties(
        footer_key=FOOTER_KEY, column_keys={"a": COL_KEY},
        aad_prefix=b"file2" if case == "supplied aad" else b"")
    return enc, dec


CASES = ["uniform", "ctr", "column keys", "aad prefix", "supplied aad",
         "plaintext footer", "plaintext footer, column keys", "kms"]
OPTIONS = [{}, {"compression": "snappy", "row_group_size": 150},
           {"write_bloom_filters": True, "data_page_size": 512}]


def _write(mod, tbl, enc, row_group_size=None, **options):
    buf = io.BytesIO()
    with mod.ParquetWriter(buf, tbl.schema, encryption_properties=enc,
                           **options) as w:
        w.write_table(tbl, row_group_size)
    return buf.getvalue()


class _Urandom:
    """``os.urandom`` from a seed: the same bytes for the same calls."""

    def __init__(self):
        self.rng = np.random.default_rng(99)

    def __call__(self, n):
        return self.rng.bytes(n)


@pytest.mark.parametrize("options", range(len(OPTIONS)))
@pytest.mark.parametrize("case", CASES)
def test_bytes_equal_the_reference_with_the_same_randomness(
        monkeypatch, tables, case, options):
    rt, pt = tables
    kw = dict(OPTIONS[options])
    out = []
    for mod, tbl in ((rpe, rt), (pe, pt)):
        monkeypatch.setattr(os, "urandom", _Urandom())
        enc, _ = _props(mod, case)
        out.append(_write(rpq if mod is rpe else pq, tbl, enc, **kw))
    monkeypatch.undo()
    assert out[1] == out[0]


@pytest.mark.parametrize("case", CASES)
def test_each_reads_the_others_files(tables, case):
    rt, pt = tables
    ours = _write(pq, pt, _props(pe, case)[0], compression="snappy")
    theirs = _write(rpq, rt, _props(rpe, case)[0], compression="snappy")
    assert ours != theirs  # random nonces and file ids
    want = rt.to_pylist()
    assert rpq.read_table(ours, decryption_properties=_props(
        rpe, case)[1]).to_pylist() == want
    assert pq.read_table(theirs, decryption_properties=_props(
        pe, case)[1]).to_pylist() == want
    assert pq.read_table(ours, decryption_properties=_props(
        pe, case)[1]).to_pylist() == want


def test_wrong_or_missing_keys_fail(tables):
    _, pt = tables
    data = _write(pq, pt, pe.FileEncryptionProperties(FOOTER_KEY))
    assert data[:4] == data[-4:] == pe.MAGIC_ENCRYPTED
    with pytest.raises(pe.ArrowInvalid, match="decryption failed"):
        pq.read_table(data, decryption_properties=pe.FileDecryptionProperties(
            footer_key=b"x" * 16))
    with pytest.raises(pe.ArrowInvalid, match="decryption_properties"):
        pq.read_table(data)
    signed = _write(pq, pt, pe.FileEncryptionProperties(
        FOOTER_KEY, plaintext_footer=True))
    assert signed[:4] == signed[-4:] == b"PAR1"
    assert pq.ParquetFile(signed).schema_arrow.names == ["a", "b", "c"]
    with pytest.raises(pe.ArrowInvalid, match="signature"):
        pq.read_table(signed, decryption_properties=(
            pe.FileDecryptionProperties(footer_key=b"x" * 16)))
    mixed = _write(pq, pt, pe.FileEncryptionProperties(
        FOOTER_KEY, column_keys={"a": COL_KEY}, plaintext_footer=True))
    assert pq.ParquetFile(mixed).read(columns=["b"]).to_pylist() == \
        pt.select(["b"]).to_pylist()


def test_statistics_and_filters_survive_encryption(tables):
    rt, pt = tables
    data = _write(pq, pt, pe.FileEncryptionProperties(FOOTER_KEY), 100,
                  write_bloom_filters=True)
    dec = pe.FileDecryptionProperties(footer_key=FOOTER_KEY)
    pf = pq.ParquetFile(data, decryption_properties=dec)
    rf = rpq.ParquetFile(data, decryption_properties=(
        rpe.FileDecryptionProperties(footer_key=FOOTER_KEY)))
    for i in range(pf.num_row_groups):
        assert pf.statistics(i) == rf.statistics(i)
        assert pf.offset_index(i, 0) == rf.offset_index(i, 0)
        assert pf.bloom_filter(i, 1).bitset() == rf.bloom_filter(i, 1).bitset()
    value = rt.column("a").to_pylist()[5]
    got = pf.read(filters=[("a", "=", value)], device="cpu")
    assert got.to_pylist() == rf.read(filters=[("a", "=", value)]).to_pylist()
    assert got.column("a").to_pylist() == [value]


def test_the_create_helpers(tables):
    rt, pt = tables
    enc = pe.create_encryption_properties(FOOTER_KEY, aad_prefix=b"p2",
                                          store_aad_prefix=False)
    data = _write(pq, pt, enc)
    with pytest.raises(pe.ArrowInvalid, match="AAD prefix"):
        pq.read_table(data, decryption_properties=(
            pe.create_decryption_properties(FOOTER_KEY)))
    got = pq.read_table(data, decryption_properties=(
        pe.create_decryption_properties(FOOTER_KEY, aad_prefix=b"p2")))
    assert got.to_pylist() == rt.to_pylist()


def test_pyarrow_kms_files_both_ways(tmp_path, tables):
    pa = pytest.importorskip("pyarrow")
    papq = pytest.importorskip("pyarrow.parquet")
    pae = pytest.importorskip("pyarrow.parquet.encryption")

    class PaKms(pae.KmsClient):
        def __init__(self, config=None):
            pae.KmsClient.__init__(self)

        def wrap_key(self, key_bytes, master_key_identifier):
            return _Kms().wrap_key(key_bytes, master_key_identifier).encode()

        def unwrap_key(self, wrapped_key, master_key_identifier):
            return _Kms().unwrap_key(wrapped_key, master_key_identifier)

    rt, pt = tables
    for algo in ("AES_GCM_V1", "AES_GCM_CTR_V1"):
        for plaintext_footer in (False, True):
            theirs = str(tmp_path / f"pa-{algo}-{plaintext_footer}.parquet")
            props = pae.CryptoFactory(PaKms).file_encryption_properties(
                pae.KmsConnectionConfig(), pae.EncryptionConfiguration(
                    footer_key="kf", column_keys={"kc": ["a", "b"]},
                    encryption_algorithm=algo,
                    plaintext_footer=plaintext_footer))
            papq.write_table(pa.table(rt.to_pydict()), theirs,
                             encryption_properties=props)
            factory = pe.CryptoFactory(lambda cfg: _Kms())
            dec = factory.file_decryption_properties(
                pe.KmsConnectionConfig())
            if algo == "AES_GCM_CTR_V1" and plaintext_footer:
                # a shared fault, kept (ROADMAP.md): neither package
                # reads pyarrow's CTR pages under a plaintext footer
                rdec = rpe.CryptoFactory(lambda cfg: _Kms())
                for mod, d in ((pq, dec), (rpq, rdec.file_decryption_properties(
                        rpe.KmsConnectionConfig()))):
                    with pytest.raises(Exception, match="decryption failed"):
                        mod.read_table(theirs, decryption_properties=d)
            else:
                got = pq.read_table(theirs, decryption_properties=dec)
                assert got.to_pylist() == rt.to_pylist()
            ours = str(tmp_path / f"ours-{algo}-{plaintext_footer}.parquet")
            enc = factory.file_encryption_properties(
                pe.KmsConnectionConfig(), pe.EncryptionConfiguration(
                    footer_key="kf", column_keys={"kc": ["a", "b"]},
                    encryption_algorithm=algo,
                    plaintext_footer=plaintext_footer))
            pq.write_table(pt, ours, encryption_properties=enc)
            dec = pae.CryptoFactory(PaKms).file_decryption_properties(
                pae.KmsConnectionConfig(), pae.DecryptionConfiguration())
            back = papq.ParquetFile(ours, decryption_properties=dec).read()
            assert back.to_pylist() == rt.to_pylist()


def test_without_libcrypto_only_encrypted_files_raise(monkeypatch, tables):
    _, pt = tables
    plain = _write(pq, pt, None)
    data = _write(pq, pt, pe.FileEncryptionProperties(FOOTER_KEY))
    monkeypatch.setattr(aes_ctypes, "_lib", lambda: None)
    assert not aes_ctypes.available()
    assert pq.read_table(plain).num_rows == pt.num_rows
    with pytest.raises(NotImplementedError, match="libcrypto"):
        pq.read_table(data, decryption_properties=(
            pe.FileDecryptionProperties(footer_key=FOOTER_KEY)))
    with pytest.raises(NotImplementedError, match="libcrypto"):
        _write(pq, pt, pe.FileEncryptionProperties(FOOTER_KEY))
