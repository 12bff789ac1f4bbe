"""Networking helpers (the port's copy of ``gethostip`` from
``areal_tpu/base/network.py``).

The reference's ``gethostip`` asks the routing table for the address of
a route to an outside host; the port's names no outside host and serves
on the loopback address, which is enough for a fleet on one host.
"""

from __future__ import annotations


def gethostip() -> str:
    return "127.0.0.1"
