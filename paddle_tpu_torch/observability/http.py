"""Stdlib HTTP plumbing — a copy of ``paddle_tpu/observability/http.py``
for the port: ``JsonHTTPHandler`` carries the response helpers,
``BackgroundHTTPServer`` is a ``ThreadingHTTPServer`` with a daemon-thread
serve loop (``start_background`` / ``stop``); ``free_port`` probes a free
TCP port for a process that must know its port before it starts."""

import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["JsonHTTPHandler", "BackgroundHTTPServer", "free_port"]


def free_port(host="127.0.0.1"):
    """Pick a currently-free TCP port on ``host`` (bind-to-0 probe) — for
    processes that must KNOW their port before launch (fleet replica
    spawns). Prefer binding port 0 directly when the consumer is
    in-process."""
    s = socket.socket()
    try:
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


class JsonHTTPHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _send(self, code, body, content_type="application/json",
              extra_headers=None):
        data = body if isinstance(body, bytes) else body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code, obj, extra_headers=None):
        self._send(code, json.dumps(obj), extra_headers=extra_headers)

    def log_message(self, fmt, *args):  # quiet by default
        if getattr(self.server, "verbose", False):
            BaseHTTPRequestHandler.log_message(self, fmt, *args)


class BackgroundHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer (one handler thread per connection) with a
    daemon-thread serve loop. ``port=0`` picks a free port —
    ``server_address`` has the final one."""

    daemon_threads = True
    # the listen backlog: a burst of concurrent clients (64 and more at a
    # saturated generation server) overflows socketserver's default of 5,
    # and the kernel then drops or resets their connections
    request_queue_size = 128

    def __init__(self, addr, handler_cls, verbose=False):
        ThreadingHTTPServer.__init__(self, addr, handler_cls)
        self.verbose = verbose
        self._thread = None

    @property
    def url(self):
        host, port = self.server_address[:2]
        return "http://%s:%d" % (host, port)

    def start_background(self, name="paddle-tpu-torch-http"):
        """serve_forever on a daemon thread; returns self."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        name=name, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=None):
        """Stop the serve loop, join it, close the socket."""
        self.shutdown()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.server_close()
