"""S3 HTTP frontend for the RGW gateway slice.

The REST layer of src/rgw (beast frontend + RGWOp handlers) reduced to
the S3 object-API core so stock HTTP clients can drive the gateway:

    PUT    /<bucket>                 create bucket
    DELETE /<bucket>                 delete bucket (must be empty)
    GET    /                         ListAllMyBucketsResult XML
    GET    /<bucket>?prefix&marker&max-keys&delimiter
                                     ListBucketResult XML
    PUT    /<bucket>/<key>           put object (ETag header returned)
    GET    /<bucket>/<key>           object bytes (+ ETag)
    HEAD   /<bucket>/<key>           metadata only
    DELETE /<bucket>/<key>           delete object

Errors use the S3 XML error envelope with the gateway's error codes
(NoSuchBucket, NoSuchKey, BucketAlreadyExists, BucketNotEmpty).
"""
from __future__ import annotations

import http.server
import threading
import urllib.parse
from typing import Optional, Tuple
from xml.sax.saxutils import escape

from .gateway import RGWError, RGWGateway


def _err_xml(code: str, message: str) -> bytes:
    return (f"<?xml version='1.0'?><Error><Code>{escape(code)}</Code>"
            f"<Message>{escape(message)}</Message></Error>").encode()


_STATUS = {"NoSuchBucket": 404, "NoSuchKey": 404,
           "BucketAlreadyExists": 409, "BucketNotEmpty": 409,
           "InvalidBucketName": 400, "NoSuchUpload": 404,
           "InvalidPart": 400, "AccessDenied": 403,
           "InvalidAccessKeyId": 403, "SignatureDoesNotMatch": 403}


class S3Frontend:
    def __init__(self, gateway: RGWGateway,
                 users: Optional[dict] = None):
        """``users``: access_key -> {"secret":…, "user":…}.  When set,
        every request must carry a valid SigV4-shaped signature
        (rgw_auth_s3 role); None = auth disabled (dev mode, like
        rgw_auth anonymous)."""
        self.gw = gateway
        self.users = users
        self._server: Optional[http.server.ThreadingHTTPServer] = None

    # --------------------------------------------------------------- ops --
    def start(self, port: int = 0) -> int:
        fe = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _split(self) -> Tuple[str, str, dict]:
                parsed = urllib.parse.urlparse(self.path)
                parts = parsed.path.strip("/").split("/", 1)
                bucket = urllib.parse.unquote(parts[0]) if parts[0] else ""
                key = urllib.parse.unquote(parts[1]) \
                    if len(parts) > 1 else ""
                q = {k: v[0] for k, v in
                     urllib.parse.parse_qs(
                         parsed.query,
                         keep_blank_values=True).items()}
                return bucket, key, q

            def _send(self, status: int, body: bytes = b"",
                      ctype: str = "application/xml", etag: str = None,
                      head_only: bool = False, extra: dict = None):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if etag:
                    self.send_header("ETag", f'"{etag}"')
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                if not head_only and body:
                    self.wfile.write(body)

            def _fail(self, e: Exception, head_only=False):
                code = str(e).split(":", 1)[0]
                self._send(_STATUS.get(code, 400),
                           _err_xml(code, str(e)), head_only=head_only)

            def _authenticate(self, body: bytes,
                              head_only: bool = False) -> bool:
                """SigV4 verification against the frontend's user set
                (True = proceed).  Anonymous requests are refused when
                auth is enabled.  The verified uid is bound as this
                request thread's TENANT on the gateway's cluster
                handle, so every RADOS op this request issues
                dispatches under the tenant's own dmClock class (the
                S3-auth -> objecter -> op-dispatch QoS plumbing)."""
                from .auth_s3 import S3AuthError, verify_request
                rc = getattr(fe.gw.ioctx, "_rc", None)
                if rc is not None and hasattr(rc, "set_tenant"):
                    # clear any binding a previous request left on
                    # this pooled server thread
                    rc.set_tenant(None, thread_only=True)
                if fe.users is None:
                    return True
                parsed = urllib.parse.urlparse(self.path)
                try:
                    uid = verify_request(self.command, parsed.path,
                                         parsed.query,
                                         dict(self.headers.items()),
                                         body, fe.users)
                    if rc is not None and hasattr(rc, "set_tenant"):
                        rc.set_tenant(uid, thread_only=True)
                    return True
                except S3AuthError as e:
                    self._fail(e, head_only=head_only)
                    return False

            def _body(self) -> bytes:
                ln = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(ln) if ln else b""

            def do_PUT(self):             # noqa: N802
                bucket, key, q = self._split()
                body = self._body()
                if not self._authenticate(body):
                    return
                try:
                    if not key:
                        fe.gw.create_bucket(bucket)
                        self._send(200)
                    elif "uploadId" in q:
                        etag = fe.gw.bucket(bucket).upload_part(
                            q["uploadId"], int(q.get("partNumber", 0)),
                            body)
                        self._send(200, etag=etag)
                    else:
                        meta = {k[11:]: v for k, v in
                                self.headers.items()
                                if k.lower().startswith("x-amz-meta-")}
                        etag = fe.gw.bucket(bucket).put_object(
                            key, body, metadata=meta or None)
                        self._send(200, etag=etag)
                except RGWError as e:
                    self._fail(e)

            def do_POST(self):            # noqa: N802
                bucket, key, q = self._split()
                body = self._body()
                if not self._authenticate(body):
                    return
                try:
                    if "uploads" in q:
                        uid = fe.gw.bucket(bucket).initiate_multipart(
                            key)
                        xml = ("<?xml version='1.0'?>"
                               "<InitiateMultipartUploadResult>"
                               f"<Bucket>{escape(bucket)}</Bucket>"
                               f"<Key>{escape(key)}</Key>"
                               f"<UploadId>{uid}</UploadId>"
                               "</InitiateMultipartUploadResult>")
                        self._send(200, xml.encode())
                    elif "uploadId" in q:
                        import re
                        nums = [int(n) for n in re.findall(
                            r"<PartNumber>(\d+)</PartNumber>",
                            body.decode(errors="replace"))]
                        etag = fe.gw.bucket(bucket).complete_multipart(
                            q["uploadId"], nums)
                        xml = ("<?xml version='1.0'?>"
                               "<CompleteMultipartUploadResult>"
                               f"<Key>{escape(key)}</Key>"
                               f"<ETag>&quot;{etag}&quot;</ETag>"
                               "</CompleteMultipartUploadResult>")
                        self._send(200, xml.encode(), etag=etag)
                    else:
                        self._send(400, _err_xml(
                            "InvalidRequest", "unsupported POST"))
                except RGWError as e:
                    self._fail(e)

            def do_GET(self, head_only=False):    # noqa: N802
                bucket, key, q = self._split()
                if not self._authenticate(b"", head_only=head_only):
                    return
                try:
                    if not bucket:
                        names = fe.gw.list_buckets()
                        xml = ("<?xml version='1.0'?>"
                               "<ListAllMyBucketsResult><Buckets>" +
                               "".join(f"<Bucket><Name>{escape(n)}"
                                       "</Name></Bucket>"
                                       for n in names) +
                               "</Buckets></ListAllMyBucketsResult>")
                        self._send(200, xml.encode(),
                                   head_only=head_only)
                    elif not key:
                        r = fe.gw.bucket(bucket).list_objects(
                            prefix=q.get("prefix", ""),
                            marker=q.get("marker", ""),
                            max_keys=int(q.get("max-keys", 1000)),
                            delimiter=q.get("delimiter", ""))
                        xml = ["<?xml version='1.0'?><ListBucketResult>",
                               f"<Name>{escape(bucket)}</Name>",
                               "<IsTruncated>" +
                               str(r["is_truncated"]).lower() +
                               "</IsTruncated>"]
                        if r["next_marker"]:
                            xml.append("<NextMarker>" +
                                       escape(r["next_marker"]) +
                                       "</NextMarker>")
                        for c in r["contents"]:
                            xml.append(
                                f"<Contents><Key>{escape(c['key'])}"
                                f"</Key><Size>{c['size']}</Size>"
                                f"<ETag>&quot;{c['etag']}&quot;</ETag>"
                                "</Contents>")
                        for cp in r["common_prefixes"]:
                            xml.append("<CommonPrefixes><Prefix>" +
                                       escape(cp) +
                                       "</Prefix></CommonPrefixes>")
                        xml.append("</ListBucketResult>")
                        self._send(200, "".join(xml).encode(),
                                   head_only=head_only)
                    else:
                        data, ent = fe.gw.bucket(bucket).get_object(key)
                        extra = {f"x-amz-meta-{k}": v for k, v in
                                 ent.get("meta", {}).items()}
                        self._send(200, data,
                                   ctype="application/octet-stream",
                                   etag=ent["etag"],
                                   head_only=head_only, extra=extra)
                except RGWError as e:
                    self._fail(e, head_only=head_only)

            def do_HEAD(self):            # noqa: N802
                self.do_GET(head_only=True)

            def do_DELETE(self):          # noqa: N802
                bucket, key, q = self._split()
                if not self._authenticate(b""):
                    return
                try:
                    if key and "uploadId" in q:
                        fe.gw.bucket(bucket).abort_multipart(
                            q["uploadId"])
                        self._send(204)
                    elif key:
                        fe.gw.bucket(bucket).delete_object(key)
                        self._send(204)
                    else:
                        fe.gw.delete_bucket(bucket)
                        self._send(204)
                except RGWError as e:
                    self._fail(e)

            def log_message(self, *a):
                pass

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1",
                                                        port), Handler)
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self._server.server_address[1]

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
