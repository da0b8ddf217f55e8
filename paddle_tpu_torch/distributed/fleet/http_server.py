"""KV http server (port of `paddle_tpu.distributed.fleet.http_server`;
reference `fleet/utils/http_server.py`, the HTTP store behind the gloo
rendezvous of `role_maker.py:33-200`): the store the elastic heartbeats
ride on. Plain Python, the same on both packages."""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib import request as urlrequest

__all__ = ["KVServer", "KVClient"]


class _Handler(BaseHTTPRequestHandler):
    store = {}
    lock = threading.Lock()

    def log_message(self, *args):
        pass

    def do_GET(self):
        # self.store resolves through the per-server subclass (KVServer
        # builds one per instance) — never name _Handler here
        with self.lock:
            val = self.store.get(self.path)
        if val is None:
            self.send_response(404)
            self.end_headers()
        else:
            self.send_response(200)
            self.end_headers()
            self.wfile.write(val)

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)
        with self.lock:
            self.store[self.path] = data
        self.send_response(200)
        self.end_headers()

    do_POST = do_PUT

    def do_DELETE(self):
        with self.lock:
            self.store.pop(self.path, None)
        self.send_response(200)
        self.end_headers()


class KVServer:
    def __init__(self, port=0, size=None):
        # per-instance store: two KV servers in one process (tests, PS +
        # elastic side by side) must not share keys
        handler = type("_KVHandler", (_Handler,),
                       {"store": {}, "lock": threading.Lock()})
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()

    def should_stop(self):
        return False


class KVClient:
    def __init__(self, endpoint):
        if not endpoint.startswith("http"):
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")

    def get(self, key):
        try:
            with urlrequest.urlopen(f"{self.endpoint}/{key.lstrip('/')}",
                                    timeout=5) as r:
                return r.read().decode()
        except Exception:
            return None

    def put(self, key, value):
        req = urlrequest.Request(f"{self.endpoint}/{key.lstrip('/')}",
                                 data=str(value).encode(), method="PUT")
        try:
            urlrequest.urlopen(req, timeout=5)
            return True
        except Exception:
            return False

    def delete(self, key):
        req = urlrequest.Request(f"{self.endpoint}/{key.lstrip('/')}",
                                 method="DELETE")
        try:
            urlrequest.urlopen(req, timeout=5)
            return True
        except Exception:
            return False
