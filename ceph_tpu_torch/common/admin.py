"""Admin command server — the AdminSocket analog.

The reference exposes per-daemon JSON commands over a Unix socket
(src/common/admin_socket.{h,cc}: `ceph daemon <name> perf dump`,
`config show`, `config set`, ...).  Here the same surface is a command
registry dispatchable in-process (for tools/tests) or served over a
Unix domain socket (for a live runtime): newline-delimited JSON
requests {"prefix": "...", ...args} -> JSON replies.

Built-ins registered on every AdminServer:
  config show / config get / config set    (options.py registry)
  perf dump / perf reset                   (perf_counters.py collection)
"""
from __future__ import annotations

import json
import os
import socket
import threading
from typing import Any, Callable, Dict, Optional

from .options import OptionError, config
from .perf_counters import perf

Handler = Callable[[Dict[str, Any]], Any]


class AdminServer:
    def __init__(self):
        self._handlers: Dict[str, Handler] = {}
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._path: Optional[str] = None
        self.register("config show", lambda a: config().dump())
        self.register("config get",
                      lambda a: {a["key"]: config().get(a["key"])})
        self.register("config set", self._config_set)
        self.register("perf dump", lambda a: perf().dump())
        self.register("perf reset", self._perf_reset)
        from .tracer import tracer
        self.register("trace dump", lambda a: tracer().dump())
        self.register("trace reset",
                      lambda a: (tracer().reset(), {"success": True})[1])
        # cross-process trace collection surface (`ceph daemon <name>
        # dump_traces` / the `ceph trace <op>` assembler's per-daemon
        # fetch): spans + buffer occupancy/drop health
        self.register("dump_traces", lambda a: tracer().dump_traces())
        from .op_tracker import tracker
        self.register("dump_ops_in_flight",
                      lambda a: tracker().dump_ops_in_flight())
        self.register("dump_historic_ops",
                      lambda a: tracker().dump_historic_ops())
        self.register("dump_historic_slow_ops",
                      lambda a: tracker().dump_historic_slow_ops())
        # runtime fault-injection control (the thrasher's per-daemon
        # arming surface; fire counts prove injections happened)
        from .faults import admin_handler as _fault_admin
        self.register("fault_injection", _fault_admin)
        self.register("help", lambda a: sorted(self._handlers))

    @staticmethod
    def _config_set(args: Dict[str, Any]) -> Any:
        v = config().set(args["key"], args["value"])
        return {"success": True, "value": v}

    @staticmethod
    def _perf_reset(args: Dict[str, Any]) -> Any:
        perf().reset()
        return {"success": True}

    # ---------------------------------------------------------- registry --
    def register(self, prefix: str, handler: Handler) -> None:
        if prefix in self._handlers:
            raise ValueError(f"duplicate admin command {prefix!r}")
        self._handlers[prefix] = handler

    def handle(self, request: Dict[str, Any]) -> Dict[str, Any]:
        prefix = request.get("prefix", "")
        handler = self._handlers.get(prefix)
        if handler is None:
            return {"error": f"unknown command {prefix!r}",
                    "commands": sorted(self._handlers)}
        try:
            return {"result": handler(request)}
        except (KeyError, OptionError, ValueError) as e:
            return {"error": str(e)}

    def handle_json(self, line: str) -> str:
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            return json.dumps({"error": f"bad json: {e}"})
        return json.dumps(self.handle(req))

    # ------------------------------------------------------------ socket --
    def serve(self, path: str) -> None:
        """Listen on a Unix socket; one JSON request per line."""
        if self._sock is not None:
            raise RuntimeError("already serving")
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(8)
        self._path = path
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            sock = self._sock
            if sock is None:
                return
            try:
                conn, _ = sock.accept()
            except (OSError, ValueError):
                return            # closed
            with conn:
                try:
                    # a silent client must not wedge the admin socket
                    conn.settimeout(5.0)
                    buf = b""
                    while b"\n" not in buf:
                        chunk = conn.recv(65536)
                        if not chunk:
                            break
                        buf += chunk
                    if buf:
                        line = buf.split(b"\n", 1)[0].decode()
                        conn.sendall(
                            self.handle_json(line).encode() + b"\n")
                except OSError:
                    continue       # timeout / reset: drop this client

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
            if self._path and os.path.exists(self._path):
                os.unlink(self._path)


def admin_request(path: str, request: Dict[str, Any],
                  timeout: float = 5.0) -> Dict[str, Any]:
    """Client side: one request to a served AdminServer socket."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(path)
        s.sendall(json.dumps(request).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.split(b"\n", 1)[0].decode())
