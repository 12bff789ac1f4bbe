"""Networking helpers (the port's copy of ``gethostip`` from
``areal_tpu/base/network.py``) and the HTTP scaffold the port's servers
share.

The reference's ``gethostip`` asks the routing table for the address of
a route to an outside host; the port's names no outside host and serves
on the loopback address, which is enough for a fleet on one host.

:class:`OwnedHTTPServer` is the standard library's
``ThreadingHTTPServer`` (one daemon thread a request, HTTP/1.1) whose
handler passes every GET and POST to ``owner._dispatch(handler,
method)``: the generation server, the weight plane's holders and the
reward executor serve through it.
"""

from __future__ import annotations

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from areal_tpu_torch.base import logging

logger = logging.getLogger("http")


def gethostip() -> str:
    return "127.0.0.1"


class OwnedHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # aiohttp's listen backlog: a fleet's burst of concurrent requests
    # must queue, not be reset (socketserver's default is 5).
    request_queue_size = 128

    def __init__(self, addr, owner):
        self.owner = owner
        super().__init__(addr, _OwnerHandler)


class _OwnerHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):
        self.server.owner._dispatch(self, "GET")

    def do_POST(self):
        self.server.owner._dispatch(self, "POST")

    def log_message(self, fmt, *args):
        logger.debug("%s " + fmt, self.address_string(), *args)
