"""Network helpers: free-port finder and TCP liveness probe.

Reference parity: edl/utils/network_utils.py:29 (find_free_ports) and
edl/discovery/server_alive.py:19-34 (is_server_alive).
"""

import contextlib
import socket


def get_host_ip():
    try:
        with contextlib.closing(
                socket.socket(socket.AF_INET, socket.SOCK_DGRAM)) as s:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def find_free_port():
    with contextlib.closing(socket.socket(socket.AF_INET,
                                          socket.SOCK_STREAM)) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", 0))
        return s.getsockname()[1]


def find_free_ports(n):
    ports = set()
    while len(ports) < n:
        ports.add(find_free_port())
    return list(ports)


def is_server_alive(endpoint, timeout=3.0):
    """True iff a TCP connect to "host:port" succeeds within timeout."""
    host, port = endpoint.rsplit(":", 1)
    try:
        with contextlib.closing(
                socket.create_connection((host, int(port)), timeout=timeout)):
            return True
    except OSError:
        return False
