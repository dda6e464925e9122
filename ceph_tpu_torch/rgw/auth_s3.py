"""S3 SigV4-shaped request authentication (rgw_auth_s3 role).

The reference authenticates S3 requests by recomputing the AWS
Signature Version 4 over a canonical form of the request
(src/rgw/rgw_auth_s3.cc).  This module implements the same shape:

    canonical request = METHOD \n uri \n sorted(query) \n
                        canonical headers \n signed header names \n
                        sha256(payload)
    string to sign    = AWS4-HMAC-SHA256 \n amz-date \n scope \n
                        sha256(canonical request)
    signing key       = HMAC chain over (secret, date, region,
                        service, "aws4_request")
    Authorization: AWS4-HMAC-SHA256 Credential=<ak>/<scope>,
                   SignedHeaders=<names>, Signature=<hex>

Verification is constant-time on the signature; unknown access keys,
malformed headers and stale signatures map to the S3 error codes
(InvalidAccessKeyId / AccessDenied / SignatureDoesNotMatch).
"""
from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from typing import Dict, Optional, Tuple

ALGO = "AWS4-HMAC-SHA256"
REGION = "ceph-tpu"
SERVICE = "s3"


class S3AuthError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def signing_key(secret: str, date: str) -> bytes:
    k = _hmac(b"AWS4" + secret.encode(), date)
    k = _hmac(k, REGION)
    k = _hmac(k, SERVICE)
    return _hmac(k, "aws4_request")


def _canonical_query(query: str) -> str:
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    return "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(pairs))


def canonical_request(method: str, path: str, query: str,
                      headers: Dict[str, str], signed: str,
                      payload_hash: str) -> str:
    names = signed.split(";")
    canon_headers = "".join(
        f"{n}:{' '.join(headers.get(n, '').split())}\n" for n in names)
    return "\n".join([method, urllib.parse.quote(path, safe="/-_.~"),
                      _canonical_query(query), canon_headers, signed,
                      payload_hash])


def string_to_sign(amz_date: str, scope: str, creq: str) -> str:
    return "\n".join([ALGO, amz_date, scope,
                      _sha256(creq.encode())])


MAX_SKEW = 900.0          # seconds: the AWS replay window


def _now_amz(now: Optional[float] = None) -> str:
    import time as _time
    t = _time.gmtime(_time.time() if now is None else now)
    return _time.strftime("%Y%m%dT%H%M%SZ", t)


def _amz_to_epoch(amz_date: str) -> float:
    import calendar
    import time as _time
    return calendar.timegm(_time.strptime(amz_date,
                                          "%Y%m%dT%H%M%SZ"))


def sign_request(method: str, path: str, query: str,
                 headers: Dict[str, str], payload: bytes,
                 access_key: str, secret_key: str,
                 amz_date: Optional[str] = None) -> Dict[str, str]:
    """Client side: returns the headers to add (Authorization,
    x-amz-date, x-amz-content-sha256).  ``headers`` must already hold
    'host'."""
    if amz_date is None:
        amz_date = _now_amz()
    date = amz_date[:8]
    payload_hash = _sha256(payload)
    hdrs = {k.lower(): v for k, v in headers.items()}
    hdrs["x-amz-date"] = amz_date
    hdrs["x-amz-content-sha256"] = payload_hash
    signed = ";".join(sorted(["host", "x-amz-date",
                              "x-amz-content-sha256"]))
    scope = f"{date}/{REGION}/{SERVICE}/aws4_request"
    creq = canonical_request(method, path, query, hdrs, signed,
                             payload_hash)
    sts = string_to_sign(amz_date, scope, creq)
    sig = hmac.new(signing_key(secret_key, date), sts.encode(),
                   hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (f"{ALGO} Credential={access_key}/{scope}, "
                          f"SignedHeaders={signed}, Signature={sig}"),
    }


def _parse_authorization(value: str
                         ) -> Tuple[str, str, str, str]:
    """-> (access_key, scope, signed_headers, signature)."""
    if not value.startswith(ALGO + " "):
        raise S3AuthError("AccessDenied",
                          "unsupported authorization scheme")
    fields = {}
    for part in value[len(ALGO):].split(","):
        part = part.strip()
        if "=" not in part:
            raise S3AuthError("AccessDenied", "malformed authorization")
        k, v = part.split("=", 1)
        fields[k] = v
    try:
        cred = fields["Credential"]
        ak, scope = cred.split("/", 1)
        return (ak, scope, fields["SignedHeaders"],
                fields["Signature"])
    except (KeyError, ValueError):
        raise S3AuthError("AccessDenied", "malformed authorization")


def verify_request(method: str, path: str, query: str,
                   headers: Dict[str, str], payload: bytes,
                   users: Dict[str, Dict[str, str]]) -> str:
    """Server side: -> authenticated user id, or raises S3AuthError.
    ``users``: access_key -> {"secret": ..., "user": ...}."""
    hdrs = {k.lower(): v for k, v in headers.items()}
    auth = hdrs.get("authorization")
    if not auth:
        raise S3AuthError("AccessDenied", "anonymous access denied")
    ak, scope, signed, signature = _parse_authorization(auth)
    ent = users.get(ak)
    if ent is None:
        raise S3AuthError("InvalidAccessKeyId",
                          f"unknown access key {ak}")
    amz_date = hdrs.get("x-amz-date", "")
    date = scope.split("/", 1)[0]
    if not amz_date.startswith(date):
        raise S3AuthError("SignatureDoesNotMatch",
                          "scope date != x-amz-date")
    # replay window: a captured request dies after MAX_SKEW seconds
    import time as _time
    try:
        signed_at = _amz_to_epoch(amz_date)
    except ValueError:
        raise S3AuthError("AccessDenied", "malformed x-amz-date")
    if abs(_time.time() - signed_at) > MAX_SKEW:
        raise S3AuthError("AccessDenied",
                          "request time too skewed (replay window)")
    payload_hash = hdrs.get("x-amz-content-sha256", "")
    if payload_hash != _sha256(payload):
        raise S3AuthError("SignatureDoesNotMatch",
                          "payload hash mismatch")
    creq = canonical_request(method, path, query, hdrs, signed,
                             payload_hash)
    sts = string_to_sign(amz_date, scope, creq)
    want = hmac.new(signing_key(ent["secret"], date), sts.encode(),
                    hashlib.sha256).hexdigest()
    if not hmac.compare_digest(signature, want):
        raise S3AuthError("SignatureDoesNotMatch",
                          "signature mismatch")
    return ent.get("user", ak)
