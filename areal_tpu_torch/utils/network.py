"""Host networking helpers (counterpart of `areal_tpu/utils/network.py`)."""

from __future__ import annotations

import socket


def find_free_ports(count: int = 1, low: int = 10000, high: int = 60000) -> list[int]:
    """`count` distinct free TCP ports, found by binding ephemeral sockets."""
    socks, ports = [], []
    try:
        for _ in range(count):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def gethostname() -> str:
    return socket.gethostname()


def gethostip() -> str:
    """The address this host's servers are reached at: loopback. The port
    runs on one host (several nodes are ROADMAP.md queue 1, item 5), and
    this asks no resolver and touches no outside address (the JAX version
    asks the routing table for the way to 8.8.8.8)."""
    return "127.0.0.1"
