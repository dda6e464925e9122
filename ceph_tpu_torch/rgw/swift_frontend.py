"""Swift HTTP frontend for the RGW gateway slice.

The reference gateway speaks BOTH S3 and Swift (src/rgw/rgw_rest_swift.cc,
rgw_swift_auth.cc); this is the Swift object-API core over the same
RGWGateway/buckets the S3 frontend drives (a Swift container IS a
bucket, like the reference's shared bucket index):

    GET  /auth/v1.0                      TempAuth: X-Auth-User/X-Auth-Key
                                         -> X-Auth-Token + X-Storage-Url
    GET  /v1/<acct>                      list containers (text or ?format=json)
    PUT  /v1/<acct>/<container>          create container (201)
    DELETE /v1/<acct>/<container>        delete container (204; 409 nonempty)
    GET  /v1/<acct>/<container>          list objects (prefix/marker/limit/
                                         delimiter; text or ?format=json)
    PUT  /v1/<acct>/<container>/<obj>    put object (201 + ETag,
                                         X-Object-Meta-* stored)
    GET  /v1/<acct>/<container>/<obj>    object bytes + ETag + meta headers
    HEAD                                 metadata only
    DELETE /v1/<acct>/<container>/<obj>  delete object (204)

Swift returns errors as plain status codes (404/409/401), not XML —
kept faithful to the protocol rather than to the S3 sibling.
"""
from __future__ import annotations

import http.server
import json
import secrets
import threading
import urllib.parse
from typing import Dict, Optional, Tuple

from .gateway import RGWError, RGWGateway

_STATUS = {"NoSuchBucket": 404, "NoSuchKey": 404,
           "BucketAlreadyExists": 202,     # Swift PUT is idempotent: 202
           "BucketNotEmpty": 409, "InvalidBucketName": 400}


class SwiftFrontend:
    def __init__(self, gateway: RGWGateway, account: str = "AUTH_test",
                 users: Optional[Dict[str, str]] = None):
        """``users``: "account:user" -> key (the TempAuth shape).
        None disables auth (dev mode)."""
        self.gw = gateway
        self.account = account
        self.users = users
        self._tokens: Dict[str, str] = {}       # token -> user
        self._server: Optional[http.server.ThreadingHTTPServer] = None

    def issue_token(self, user: str) -> str:
        tok = "AUTH_tk" + secrets.token_hex(16)
        self._tokens[tok] = user
        return tok

    # --------------------------------------------------------------- ops --
    def start(self, port: int = 0) -> int:
        fe = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _split(self) -> Tuple[str, str, str, dict]:
                parsed = urllib.parse.urlparse(self.path)
                parts = [urllib.parse.unquote(p)
                         for p in parsed.path.strip("/").split("/")]
                q = {k: v[0] for k, v in urllib.parse.parse_qs(
                    parsed.query, keep_blank_values=True).items()}
                # /v1/<acct>[/<container>[/<obj...>]]
                acct = parts[1] if len(parts) > 1 else ""
                cont = parts[2] if len(parts) > 2 else ""
                obj = "/".join(parts[3:]) if len(parts) > 3 else ""
                return acct, cont, obj, q

            def _send(self, status: int, body: bytes = b"",
                      ctype: str = "text/plain; charset=utf-8",
                      head_only: bool = False, extra: dict = None):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                if not head_only and body:
                    self.wfile.write(body)

            def _fail(self, e: RGWError, head_only=False):
                code = str(e).split(":", 1)[0]
                self._send(_STATUS.get(code, 400), str(e).encode(),
                           head_only=head_only)

            def _authed(self, head_only=False) -> bool:
                if fe.users is None:
                    return True
                tok = self.headers.get("X-Auth-Token", "")
                if tok in fe._tokens:
                    return True
                self._send(401, b"Unauthorized", head_only=head_only)
                return False

            def _body(self) -> bytes:
                ln = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(ln) if ln else b""

            def _auth_v1(self) -> None:
                """GET /auth/v1.0 — TempAuth handshake."""
                user = self.headers.get("X-Auth-User", "")
                key = self.headers.get("X-Auth-Key", "")
                if fe.users is not None and \
                        fe.users.get(user) != key:
                    self._send(401, b"Unauthorized")
                    return
                tok = fe.issue_token(user)
                host, port_ = self.server.server_address
                self._send(200, extra={
                    "X-Auth-Token": tok,
                    "X-Storage-Token": tok,
                    "X-Storage-Url":
                        f"http://{host}:{port_}/v1/{fe.account}"})

            def do_GET(self, head_only=False):      # noqa: N802
                if self.path.startswith("/auth/"):
                    self._auth_v1()
                    return
                acct, cont, obj, q = self._split()
                if not self._authed(head_only=head_only):
                    return
                try:
                    if not cont:
                        names = fe.gw.list_buckets()
                        if q.get("format") == "json":
                            body = json.dumps(
                                [{"name": n} for n in names]).encode()
                            self._send(200, body, "application/json",
                                       head_only=head_only)
                        else:
                            self._send(200,
                                       ("\n".join(names) + "\n").encode()
                                       if names else b"",
                                       head_only=head_only)
                    elif not obj:
                        r = fe.gw.bucket(cont).list_objects(
                            prefix=q.get("prefix", ""),
                            marker=q.get("marker", ""),
                            max_keys=int(q.get("limit", 10000)),
                            delimiter=q.get("delimiter", ""))
                        if q.get("format") == "json":
                            body = json.dumps(
                                [{"name": c["key"], "bytes": c["size"],
                                  "hash": c["etag"]}
                                 for c in r["contents"]] +
                                [{"subdir": p}
                                 for p in r["common_prefixes"]]).encode()
                            self._send(200, body, "application/json",
                                       head_only=head_only)
                        else:
                            names = [c["key"] for c in r["contents"]] + \
                                list(r["common_prefixes"])
                            self._send(200,
                                       ("\n".join(names) + "\n").encode()
                                       if names else b"",
                                       head_only=head_only)
                    else:
                        data, ent = fe.gw.bucket(cont).get_object(obj)
                        extra = {"ETag": ent["etag"]}
                        for k, v in ent.get("meta", {}).items():
                            extra[f"X-Object-Meta-{k}"] = v
                        self._send(200, data,
                                   "application/octet-stream",
                                   head_only=head_only, extra=extra)
                except RGWError as e:
                    self._fail(e, head_only=head_only)

            def do_HEAD(self):                      # noqa: N802
                self.do_GET(head_only=True)

            def do_PUT(self):                       # noqa: N802
                acct, cont, obj, q = self._split()
                body = self._body()
                if not self._authed():
                    return
                try:
                    if not obj:
                        try:
                            fe.gw.create_bucket(cont)
                            self._send(201)
                        except RGWError as e:
                            if str(e).startswith("BucketAlreadyExists"):
                                self._send(202)     # idempotent PUT
                            else:
                                raise
                    else:
                        meta = {k[len("X-Object-Meta-"):]: v
                                for k, v in self.headers.items()
                                if k.lower().startswith("x-object-meta-")}
                        etag = fe.gw.bucket(cont).put_object(
                            obj, body, metadata=meta or None)
                        self._send(201, extra={"ETag": etag})
                except RGWError as e:
                    self._fail(e)

            def do_DELETE(self):                    # noqa: N802
                acct, cont, obj, q = self._split()
                if not self._authed():
                    return
                try:
                    if obj:
                        fe.gw.bucket(cont).delete_object(obj)
                    else:
                        fe.gw.delete_bucket(cont)
                    self._send(204)
                except RGWError as e:
                    self._fail(e)

            def log_message(self, *a):
                pass

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler)
        threading.Thread(target=self._server.serve_forever,
                        daemon=True).start()
        return self._server.server_address[1]

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
