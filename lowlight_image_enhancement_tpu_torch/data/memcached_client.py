"""Minimal memcached backend (reference FileClient 'memcached' parity):
the port's copy of ``lowlight_image_enhancement_tpu/data/memcached_client.py``.

The reference's ``FileClient`` supports a memcached backend via the
``mc``/``pymemcache`` libraries (``utils/file_client.py``); neither is
bundled here, so this is a dependency-free text-protocol client (get/set)
over a TCP socket — enough to serve encoded image buffers from a memcached
farm, with graceful errors when no server is reachable.
"""

from __future__ import annotations

import socket
from typing import Optional


class MemcachedClient:
    """Tiny memcached text-protocol client (get/set/close)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 11211,
                 timeout: float = 3.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        if self._sock is None:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=self.timeout
                )
            except OSError as e:
                raise ConnectionError(
                    f"memcached unreachable at {self.host}:{self.port} "
                    f"({e}); start a server or use the 'pack'/'disk' "
                    "backends"
                ) from e
        return self._sock

    def _read_line(self, sock: socket.socket) -> bytes:
        buf = b""
        while not buf.endswith(b"\r\n"):
            chunk = sock.recv(1)
            if not chunk:
                raise ConnectionError("memcached closed the connection")
            buf += chunk
        return buf[:-2]

    def get(self, key: str) -> Optional[bytes]:
        """-> value bytes, or None on miss."""
        sock = self._connect()
        sock.sendall(f"get {key}\r\n".encode())
        header = self._read_line(sock)
        if header == b"END":
            return None
        # "VALUE <key> <flags> <bytes>"
        parts = header.split()
        if len(parts) < 4 or parts[0] != b"VALUE":
            raise ConnectionError(f"unexpected memcached reply: {header!r}")
        nbytes = int(parts[3])
        data = b""
        while len(data) < nbytes + 2:  # payload + trailing \r\n
            chunk = sock.recv(nbytes + 2 - len(data))
            if not chunk:
                raise ConnectionError("memcached closed mid-value")
            data += chunk
        end = self._read_line(sock)
        if end != b"END":
            raise ConnectionError(f"unexpected memcached trailer: {end!r}")
        return data[:-2]

    def set(self, key: str, value: bytes, expire: int = 0) -> bool:
        sock = self._connect()
        sock.sendall(
            f"set {key} 0 {expire} {len(value)}\r\n".encode()
            + value + b"\r\n"
        )
        return self._read_line(sock) == b"STORED"

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class MemcachedBackend:
    """FileClient-style backend: ``get(key) -> bytes`` of an encoded image
    (decode with ``data.transforms.decode_png_uint16``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 11211,
                 **_ignored):
        self._client = MemcachedClient(host, port)

    def get(self, key: str) -> bytes:
        value = self._client.get(key)
        if value is None:
            raise KeyError(f"memcached miss for {key!r}")
        return value

    def close(self) -> None:
        self._client.close()
