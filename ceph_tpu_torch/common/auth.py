"""cephx-style ticket authentication (the src/auth/cephx/ role).

The reference's cephx (CephxProtocol.h:1-60, CephxServiceHandler.cc)
is Kerberos-shaped: every entity shares a secret with the monitor; a
client asks the mon for a TICKET for a target service; the ticket holds
a fresh session key and is sealed under the SERVICE's secret, so the
service can unseal it without talking to the mon; the client proves
possession of the session key with an authorizer; both sides then share
the session key for per-message authentication.

This module re-creates that shape on the stdlib only:

  * Keyring — entity name -> 32-byte secret (mon holds all of them;
    daemons hold their own), JSON file on disk.
  * seal/unseal — authenticated encryption.  AES-256-GCM when the
    `cryptography` package is importable (the reference's secure-mode
    AES-GCM, src/msg/async/crypto_onwire.cc — hardware AES moves the
    wire from ~10 MB/s to ~1 GB/s per stream); otherwise a
    stdlib-only fallback: SHAKE-256 XOF keystream XORed over the
    plaintext with an encrypt-then-MAC HMAC-SHA256 tag.  Blobs are
    format-tagged ("G"/"P"): a host with AES support opens both
    formats; a stdlib-only host opens only "P", so MIXED-capability
    deployments must run every peer stdlib-only (all daemons and
    clients of one cluster share a venv here — heterogeneous installs
    would need a capability handshake this module does not provide).
  * TicketServer (mon side): grant(entity, service) -> (ticket_blob,
    sealed_session_key) where ticket_blob is sealed under the service
    secret and the session key copy under the requesting entity's
    secret — the CephxServiceHandler build_session_auth_info role.
  * verify_authorizer (service side): unseal the ticket with the
    service secret, check expiry, then check the client's
    HMAC(session_key, nonce) proof — CephxAuthorizeHandler::verify.

Every daemon connection in the process cluster (cluster/daemon.py)
performs this handshake before any op frame is accepted; frames after
the handshake carry per-message HMACs keyed by the ticket's session
key (msg/wire.py).
"""
from __future__ import annotations

import hmac
import json
import os
import secrets
import struct
import time
from hashlib import sha256
from typing import Dict, Optional, Tuple

TICKET_TTL_S = 3600.0


class AuthError(PermissionError):
    pass


# ------------------------------------------------ HMAC-CTR sealed boxes ---

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    _HAVE_AESGCM = True
except ImportError:                       # stdlib-only environment
    _HAVE_AESGCM = False


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    """SHAKE-256 XOF keystream: ONE C call for the whole frame
    (~170 MB/s) instead of an HMAC invocation per 32 bytes (~10 MB/s
    with Python-loop overhead on MB-scale secure-mode frames)."""
    from hashlib import shake_256
    return shake_256(b"ks" + key + nonce).digest(n)


def _xor(a: bytes, b: bytes) -> bytes:
    """Constant-width XOR via big-int ops (C-speed; a per-byte Python
    zip is ~1000x slower on MB-scale secure-mode frames)."""
    n = len(a)
    return (int.from_bytes(a, "little") ^
            int.from_bytes(b, "little")).to_bytes(n, "little")


def seal(key: bytes, plaintext: bytes) -> bytes:
    """Format-tagged authenticated encryption:
    "G" | nonce12 | AES-GCM(ct||tag16)          (hardware AES path)
    "P" | nonce16 | ct | hmac-sha256 tag32      (stdlib fallback)"""
    if _HAVE_AESGCM:
        nonce = secrets.token_bytes(12)
        return b"G" + nonce + AESGCM(key).encrypt(nonce, plaintext,
                                                  b"seal")
    nonce = secrets.token_bytes(16)
    ct = _xor(plaintext, _keystream(key, nonce, len(plaintext)))
    tag = hmac.new(key, b"seal" + nonce + ct, sha256).digest()
    return b"P" + nonce + ct + tag


def seal_parts(key: bytes, parts) -> list:
    """``seal`` over a scatter-gather payload WITHOUT first joining it:
    returns the sealed blob as a list of buffers suitable for
    ``socket.sendmsg`` (wire.py's scatter-gather frame path).  Each
    plaintext byte is touched exactly once by the cipher XOR and once
    by the MAC — no intermediate whole-payload assembly.  The AES-GCM
    path has no streaming API here, so it joins (hardware AES makes
    the copy irrelevant next to the cipher win)."""
    if _HAVE_AESGCM:
        return [seal(key, b"".join(bytes(p) for p in parts))]
    nonce = secrets.token_bytes(16)
    total = sum(len(p) for p in parts)
    ks = _keystream(key, nonce, total)
    out = [b"P" + nonce]
    tag = hmac.new(key, b"seal" + nonce, sha256)
    off = 0
    for p in parts:
        n = len(p)
        ct = _xor(bytes(p), ks[off:off + n])
        off += n
        tag.update(ct)
        out.append(ct)
    out.append(tag.digest())
    return out


def unseal(key: bytes, blob: bytes) -> bytes:
    fmt = blob[:1]
    if fmt == b"G":
        if not _HAVE_AESGCM:
            raise AuthError("AES-GCM sealed blob but no AES support")
        if len(blob) < 29:
            raise AuthError("sealed blob too short")
        try:
            return AESGCM(key).decrypt(blob[1:13], blob[13:], b"seal")
        except Exception:
            raise AuthError("sealed blob rejected") from None
    if fmt == b"P":
        body = blob[1:]
        if len(body) < 48:
            raise AuthError("sealed blob too short")
        nonce, ct, tag = body[:16], body[16:-32], body[-32:]
        want = hmac.new(key, b"seal" + nonce + ct, sha256).digest()
        if not hmac.compare_digest(tag, want):
            raise AuthError("sealed blob MAC rejected")
        return _xor(ct, _keystream(key, nonce, len(ct)))
    raise AuthError(f"unknown sealed-blob format {fmt!r}")


# ------------------------------------------------------------- keyring ---

class Keyring:
    """entity name -> secret; JSON-file backed (the keyring file role)."""

    def __init__(self, entries: Optional[Dict[str, bytes]] = None):
        self.entries: Dict[str, bytes] = dict(entries or {})

    @staticmethod
    def generate(names) -> "Keyring":
        return Keyring({n: secrets.token_bytes(32) for n in names})

    def secret(self, name: str) -> bytes:
        try:
            return self.entries[name]
        except KeyError:
            raise AuthError(f"no key for entity {name!r}") from None

    def subset(self, *names: str) -> "Keyring":
        return Keyring({n: self.secret(n) for n in names})

    def save(self, path: str) -> None:
        blob = {n: s.hex() for n, s in self.entries.items()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f)
        os.replace(tmp, path)
        os.chmod(path, 0o600)

    @staticmethod
    def load(path: str) -> "Keyring":
        with open(path) as f:
            blob = json.load(f)
        return Keyring({n: bytes.fromhex(s) for n, s in blob.items()})


# ------------------------------------------------------------- tickets ---

def _ticket_payload(entity: str, service: str, session_key: bytes,
                    expires: float) -> bytes:
    return json.dumps({"entity": entity, "service": service,
                       "key": session_key.hex(),
                       "expires": expires}).encode()


class TicketServer:
    """Mon-side ticket granting (CephxServiceHandler role)."""

    def __init__(self, keyring: Keyring):
        self.keyring = keyring

    def grant(self, entity: str, service: str,
              ttl: float = TICKET_TTL_S) -> Tuple[bytes, bytes]:
        """-> (ticket sealed under the SERVICE secret, session key
        sealed under the ENTITY secret)."""
        entity_secret = self.keyring.secret(entity)
        service_secret = self.keyring.secret(service)
        session_key = secrets.token_bytes(32)
        expires = time.time() + ttl
        ticket = seal(service_secret,
                      _ticket_payload(entity, service, session_key,
                                      expires))
        key_box = seal(entity_secret, session_key +
                       struct.pack("<d", expires))
        return ticket, key_box


def open_key_box(entity_secret: bytes, key_box: bytes) -> bytes:
    """Client side: recover the session key from the mon's grant."""
    blob = unseal(entity_secret, key_box)
    if len(blob) != 40:
        raise AuthError("malformed key box")
    return blob[:32]


def make_authorizer(session_key: bytes, nonce: bytes) -> bytes:
    """Proof of session-key possession for the connection nonce."""
    return hmac.new(session_key, b"authorizer" + nonce, sha256).digest()


def verify_authorizer(service_secret: bytes, ticket: bytes,
                      authorizer: bytes, nonce: bytes) -> Tuple[str, bytes]:
    """Service side: -> (entity name, session key); raises AuthError on
    any forgery, expiry, or wrong-service ticket."""
    payload = json.loads(unseal(service_secret, ticket).decode())
    if payload["expires"] < time.time():
        raise AuthError("ticket expired")
    session_key = bytes.fromhex(payload["key"])
    want = hmac.new(session_key, b"authorizer" + nonce, sha256).digest()
    if not hmac.compare_digest(authorizer, want):
        raise AuthError("authorizer rejected")
    return payload["entity"], session_key
