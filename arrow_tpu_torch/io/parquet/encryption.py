"""Parquet Modular Encryption, AES-GCM and AES-GCM-CTR (counterpart of
``arrow_tpu/io/parquet/encryption.py``; reference:
cpp/src/parquet/encryption/: encryption.h's FileEncryptionProperties and
FileDecryptionProperties, the AES context of encryption_internal.cc, the
key tools of key_toolkit.cc and key_material.h, the KMS layer of
crypto_factory.h).

The ciphers are the system libcrypto's, by ctypes
(``utils/aes_ctypes.py``), where the reference uses the ``cryptography``
package; this module imports without either, and only an encrypted read
or write loads libcrypto (NotImplementedError where it does not load).

Wire format (validated byte-level against pyarrow-written files):
- Encrypted-footer mode: magic ``PARE``; file tail =
  ``FileCryptoMetaData (plain thrift) || encrypted FileMetaData module ||
  i32 combined_len || PARE``.
- Every encrypted module = ``u32 LE buffer_len || 12-byte nonce ||
  ciphertext [|| 16-byte GCM tag]``. GCM modules carry the tag; in
  AES_GCM_CTR_V1 mode *page* modules use CTR (no tag, initial counter
  block = nonce || 0x00000001 big-endian) while headers/metadata stay GCM.
- Module AAD = aad_prefix? || aad_file_unique || module_type(1 byte)
  [|| u16 row_group_ordinal || u16 column_ordinal [|| u16 page_ordinal]].
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Callable, Dict, List, Optional

from ...compute.registry import ArrowInvalid
from ...utils import aes_ctypes

# module types (parquet/encryption/encryption_internal.h ModuleType)
MOD_FOOTER = 0
MOD_COLUMN_METADATA = 1
MOD_DATA_PAGE = 2
MOD_DICT_PAGE = 3
MOD_DATA_PAGE_HEADER = 4
MOD_DICT_PAGE_HEADER = 5
MOD_COLUMN_INDEX = 6
MOD_OFFSET_INDEX = 7
MOD_BLOOM_HEADER = 8
MOD_BLOOM_BITSET = 9

ALG_AES_GCM_V1 = "AES_GCM_V1"
ALG_AES_GCM_CTR_V1 = "AES_GCM_CTR_V1"

MAGIC_ENCRYPTED = b"PARE"

NONCE_LEN = 12
TAG_LEN = 16


def module_aad(file_aad: bytes, module_type: int,
               row_group: Optional[int] = None,
               column: Optional[int] = None,
               page: Optional[int] = None) -> bytes:
    aad = file_aad + bytes([module_type])
    if row_group is not None:
        aad += struct.pack("<H", row_group)
    if column is not None:
        aad += struct.pack("<H", column)
    if page is not None:
        aad += struct.pack("<H", page)
    return aad


def encrypt_module_gcm(key: bytes, aad: bytes, plaintext: bytes) -> bytes:
    nonce = os.urandom(NONCE_LEN)
    ct = aes_ctypes.gcm_encrypt(key, nonce, plaintext, aad)
    buf = nonce + ct
    return struct.pack("<I", len(buf)) + buf


def decrypt_module_gcm(key: bytes, aad: bytes, data: bytes,
                       pos: int = 0):
    """Returns (plaintext, end_pos)."""
    (buflen,) = struct.unpack_from("<I", data, pos)
    nonce = bytes(data[pos + 4:pos + 4 + NONCE_LEN])
    ct = bytes(data[pos + 4 + NONCE_LEN:pos + 4 + buflen])
    try:
        pt = aes_ctypes.gcm_decrypt(key, nonce, ct, aad)
    except ValueError as e:
        raise ArrowInvalid(
            f"parquet module decryption failed (wrong key or corrupt "
            f"data): {e}") from e
    return pt, pos + 4 + buflen


def encrypt_module_ctr(key: bytes, plaintext: bytes) -> bytes:
    nonce = os.urandom(NONCE_LEN)
    ct = aes_ctypes.ctr_xcrypt(key, nonce + struct.pack(">I", 1), plaintext)
    buf = nonce + ct
    return struct.pack("<I", len(buf)) + buf


def decrypt_module_ctr(key: bytes, data: bytes, pos: int = 0):
    (buflen,) = struct.unpack_from("<I", data, pos)
    nonce = bytes(data[pos + 4:pos + 4 + NONCE_LEN])
    ct = bytes(data[pos + 4 + NONCE_LEN:pos + 4 + buflen])
    return (aes_ctypes.ctr_xcrypt(key, nonce + struct.pack(">I", 1), ct),
            pos + 4 + buflen)


# --- low-level properties (parquet/encryption/encryption.h) ---------------

class FileEncryptionProperties:
    """Direct-key encryption properties (encryption.h:FileEncryption
    Properties::Builder). ``column_keys`` maps column name -> key bytes;
    columns absent from the map are written in plaintext unless
    ``uniform`` (everything under the footer key)."""

    def __init__(self, footer_key: bytes,
                 column_keys: Optional[Dict[str, bytes]] = None,
                 algorithm: str = ALG_AES_GCM_V1,
                 footer_key_metadata: bytes = b"",
                 column_key_metadata: Optional[Dict[str, bytes]] = None,
                 aad_prefix: bytes = b"",
                 supply_aad_prefix: bool = False,
                 uniform: bool = True,
                 plaintext_footer: bool = False):
        if len(footer_key) not in (16, 24, 32):
            raise ValueError("footer key must be 16/24/32 bytes")
        if algorithm not in (ALG_AES_GCM_V1, ALG_AES_GCM_CTR_V1):
            raise ValueError(f"unknown encryption algorithm {algorithm!r}")
        self.footer_key = footer_key
        self.column_keys = dict(column_keys or {})
        self.algorithm = algorithm
        self.footer_key_metadata = footer_key_metadata
        self.column_key_metadata = dict(column_key_metadata or {})
        self.aad_prefix = aad_prefix
        self.supply_aad_prefix = supply_aad_prefix
        self.uniform = uniform and not self.column_keys
        # plaintext footer: magic stays PAR1, the footer is readable by
        # legacy readers and carries a GCM signature (nonce||tag)
        self.plaintext_footer = plaintext_footer
        self.aad_file_unique = os.urandom(8)

    @property
    def file_aad(self) -> bytes:
        return self.aad_prefix + self.aad_file_unique


class FileDecryptionProperties:
    """Direct-key decryption properties. ``key_retriever`` resolves key
    metadata bytes -> key bytes (encryption.h:DecryptionKeyRetriever);
    explicit ``footer_key``/``column_keys`` take precedence."""

    def __init__(self, footer_key: Optional[bytes] = None,
                 column_keys: Optional[Dict[str, bytes]] = None,
                 key_retriever: Optional[Callable[[bytes], bytes]] = None,
                 aad_prefix: bytes = b""):
        self.footer_key = footer_key
        self.column_keys = dict(column_keys or {})
        self.key_retriever = key_retriever
        self.aad_prefix = aad_prefix

    def resolve_footer_key(self, key_metadata: bytes) -> bytes:
        if self.footer_key is not None:
            return self.footer_key
        if self.key_retriever is not None:
            return self.key_retriever(key_metadata)
        raise ArrowInvalid("file is encrypted: no footer key or key "
                           "retriever in decryption properties")

    def resolve_column_key(self, name: str, key_metadata: bytes) -> bytes:
        if name in self.column_keys:
            return self.column_keys[name]
        if self.key_retriever is not None:
            return self.key_retriever(key_metadata)
        if self.footer_key is not None:
            return self.footer_key
        raise ArrowInvalid(f"no decryption key for column {name!r}")


# --- KMS / envelope-encryption layer (crypto_factory.h, pyarrow
#     pyarrow.parquet.encryption API) ---------------------------------------

class KmsClient:
    """Abstract master-key service (kms_client.h). Subclasses implement
    wrap_key/unwrap_key (string-typed wrapped keys)."""

    def wrap_key(self, key_bytes: bytes,
                 master_key_identifier: str) -> str:
        raise NotImplementedError

    def unwrap_key(self, wrapped_key: str,
                   master_key_identifier: str) -> bytes:
        raise NotImplementedError


class KmsConnectionConfig:
    def __init__(self, kms_instance_id: str = "DEFAULT",
                 kms_instance_url: str = "DEFAULT",
                 key_access_token: str = "DEFAULT",
                 custom_kms_conf: Optional[Dict[str, str]] = None):
        self.kms_instance_id = kms_instance_id
        self.kms_instance_url = kms_instance_url
        self.key_access_token = key_access_token
        self.custom_kms_conf = dict(custom_kms_conf or {})


class EncryptionConfiguration:
    def __init__(self, footer_key: str,
                 column_keys: Optional[Dict[str, List[str]]] = None,
                 encryption_algorithm: str = ALG_AES_GCM_V1,
                 plaintext_footer: bool = False,
                 double_wrapping: bool = True,
                 data_key_length_bits: int = 128,
                 uniform_encryption: bool = False):
        self.footer_key = footer_key
        self.column_keys = dict(column_keys or {})
        self.encryption_algorithm = encryption_algorithm
        self.plaintext_footer = plaintext_footer
        self.double_wrapping = double_wrapping
        self.data_key_length_bits = data_key_length_bits
        self.uniform_encryption = uniform_encryption
        if not self.column_keys and not uniform_encryption:
            raise ArrowInvalid(
                "either column_keys or uniform_encryption must be set")


class DecryptionConfiguration:
    def __init__(self, cache_lifetime=None):
        self.cache_lifetime = cache_lifetime


def _wrap_dek_double(kek: bytes, kek_id: bytes, dek: bytes) -> str:
    """KEK-wraps a DEK the parquet-mr way (key_toolkit_internal.cc
    EncryptKeyLocally): AES-GCM under the KEK with the raw KEK id as
    AAD, base64 of nonce||ct||tag."""
    nonce = os.urandom(NONCE_LEN)
    ct = aes_ctypes.gcm_encrypt(kek, nonce, dek, kek_id)
    return base64.b64encode(nonce + ct).decode()


def _unwrap_dek_double(kek: bytes, kek_id: bytes, wrapped: str) -> bytes:
    raw = base64.b64decode(wrapped)
    return aes_ctypes.gcm_decrypt(kek, raw[:NONCE_LEN], raw[NONCE_LEN:],
                                  kek_id)


class CryptoFactory:
    """Envelope encryption over a user KMS (crypto_factory.h). Produces
    pyarrow-compatible PKMT1 key material (key_material.h) so files are
    mutually readable with the reference implementation."""

    def __init__(self, kms_client_factory:
                 Callable[[KmsConnectionConfig], KmsClient]):
        self._factory = kms_client_factory

    def _client(self, cfg: KmsConnectionConfig) -> KmsClient:
        return self._factory(cfg)

    def file_encryption_properties(
            self, kms_config: KmsConnectionConfig,
            encryption_config: EncryptionConfiguration
    ) -> FileEncryptionProperties:
        ec = encryption_config
        client = self._client(kms_config)
        key_len = ec.data_key_length_bits // 8
        keks: Dict[str, tuple] = {}  # master key id -> (kek, kek_id)

        def make_material(master_key_id: str, is_footer: bool):
            dek = os.urandom(key_len)
            material = {"keyMaterialType": "PKMT1",
                        "internalStorage": True,
                        "isFooterKey": is_footer}
            if is_footer:
                material["kmsInstanceID"] = kms_config.kms_instance_id
                material["kmsInstanceURL"] = kms_config.kms_instance_url
            material["masterKeyID"] = master_key_id
            if ec.double_wrapping:
                if master_key_id not in keks:
                    kek = os.urandom(16)
                    kek_id = os.urandom(16)
                    keks[master_key_id] = (kek, kek_id)
                kek, kek_id = keks[master_key_id]
                material["wrappedDEK"] = _wrap_dek_double(kek, kek_id, dek)
                material["doubleWrapping"] = True
                material["keyEncryptionKeyID"] = \
                    base64.b64encode(kek_id).decode()
                material["wrappedKEK"] = client.wrap_key(kek,
                                                         master_key_id)
            else:
                material["wrappedDEK"] = client.wrap_key(dek,
                                                         master_key_id)
                material["doubleWrapping"] = False
            return dek, json.dumps(material,
                                   separators=(",", ":")).encode()

        footer_key, footer_md = make_material(ec.footer_key, True)
        column_keys: Dict[str, bytes] = {}
        column_md: Dict[str, bytes] = {}
        for master_id, columns in ec.column_keys.items():
            for col in columns:
                column_keys[col], column_md[col] = \
                    make_material(master_id, False)
        return FileEncryptionProperties(
            footer_key, column_keys,
            algorithm=ec.encryption_algorithm,
            footer_key_metadata=footer_md,
            column_key_metadata=column_md,
            uniform=ec.uniform_encryption,
            plaintext_footer=ec.plaintext_footer)

    def file_decryption_properties(
            self, kms_config: KmsConnectionConfig,
            decryption_config: Optional[DecryptionConfiguration] = None
    ) -> FileDecryptionProperties:
        client = self._client(kms_config)

        def retrieve(key_metadata: bytes) -> bytes:
            try:
                material = json.loads(key_metadata)
            except Exception as e:
                raise ArrowInvalid(
                    f"unsupported parquet key metadata (expected PKMT1 "
                    f"JSON): {e}") from e
            if material.get("keyMaterialType") != "PKMT1":
                raise ArrowInvalid("unsupported key material type "
                                   f"{material.get('keyMaterialType')!r}")
            master_id = material["masterKeyID"]
            if material.get("doubleWrapping"):
                kek_id = base64.b64decode(material["keyEncryptionKeyID"])
                kek = client.unwrap_key(material["wrappedKEK"], master_id)
                return _unwrap_dek_double(kek, kek_id,
                                          material["wrappedDEK"])
            return client.unwrap_key(material["wrappedDEK"], master_id)

        return FileDecryptionProperties(key_retriever=retrieve)


class FileColumnCryptoState:
    """Per-(file, column) module cipher used by reader/writer: knows the
    key, the file AAD, and whether pages use CTR."""

    __slots__ = ("key", "file_aad", "ctr_pages")

    def __init__(self, key: bytes, file_aad: bytes, ctr_pages: bool):
        self.key = key
        self.file_aad = file_aad
        self.ctr_pages = ctr_pages

    def encrypt(self, module_type: int, plaintext: bytes,
                rg: Optional[int] = None, col: Optional[int] = None,
                page: Optional[int] = None) -> bytes:
        if self.ctr_pages and module_type in (MOD_DATA_PAGE,
                                              MOD_DICT_PAGE):
            return encrypt_module_ctr(self.key, plaintext)
        aad = module_aad(self.file_aad, module_type, rg, col, page)
        return encrypt_module_gcm(self.key, aad, plaintext)

    def decrypt(self, module_type: int, data: bytes, pos: int = 0,
                rg: Optional[int] = None, col: Optional[int] = None,
                page: Optional[int] = None):
        if self.ctr_pages and module_type in (MOD_DATA_PAGE,
                                              MOD_DICT_PAGE):
            return decrypt_module_ctr(self.key, data, pos)
        aad = module_aad(self.file_aad, module_type, rg, col, page)
        return decrypt_module_gcm(self.key, aad, data, pos)


def create_encryption_properties(footer_key, *, aad_prefix=None,
                                 store_aad_prefix: bool = True,
                                 encryption_algorithm: str = ALG_AES_GCM_V1,
                                 plaintext_footer: bool = False,
                                 column_keys=None) -> \
        "FileEncryptionProperties":
    """Direct-key encryption properties (pyarrow.parquet.encryption.
    create_encryption_properties)."""
    return FileEncryptionProperties(
        bytes(footer_key), column_keys=column_keys,
        algorithm=encryption_algorithm,
        aad_prefix=bytes(aad_prefix) if aad_prefix else b"",
        supply_aad_prefix=not store_aad_prefix,
        plaintext_footer=plaintext_footer)


def create_decryption_properties(footer_key, *, aad_prefix=None,
                                 column_keys=None) -> \
        "FileDecryptionProperties":
    """Direct-key decryption properties (pyarrow.parquet.encryption.
    create_decryption_properties)."""
    return FileDecryptionProperties(
        footer_key=bytes(footer_key), column_keys=column_keys,
        aad_prefix=bytes(aad_prefix) if aad_prefix else b"")


def sign_footer(key: bytes, file_aad: bytes, footer: bytes) -> bytes:
    """Plaintext-footer signature = nonce || GCM tag over the footer
    bytes (metadata.cc FileMetaData::WriteTo signing path,
    SignedFooterEncrypt)."""
    nonce = os.urandom(NONCE_LEN)
    aad = module_aad(file_aad, MOD_FOOTER)
    ct = aes_ctypes.gcm_encrypt(key, nonce, footer, aad)
    return nonce + ct[-TAG_LEN:]


def verify_footer_signature(key: bytes, file_aad: bytes, footer: bytes,
                            signature: bytes) -> bool:
    """Re-encrypt with the stored nonce and compare tags
    (metadata.cc VerifySignature)."""
    nonce, tag = signature[:NONCE_LEN], signature[NONCE_LEN:]
    aad = module_aad(file_aad, MOD_FOOTER)
    ct = aes_ctypes.gcm_encrypt(key, nonce, footer, aad)
    return ct[-TAG_LEN:] == tag
