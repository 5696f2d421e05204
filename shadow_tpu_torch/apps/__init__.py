"""Built-in applications for the process plane.

Parity: the reference runs real binaries (`examples/apps/{curl,nginx,
iperf-2,http-server,...}`, tgen); until the native interposition plane
lands, these Python coroutine apps cover the same simulation roles:

- http-server / http-client: the BASELINE rung-1 basic-file-transfer pair
  (`examples/docs/basic-file-transfer/shadow.yaml` — python http.server
  serving a file + curl fetching it).
- udp-echo-server / udp-client: datagram smoke traffic.
- tgen-server / tgen-client: fixed-size stream transfers like the tgen
  throughput tests (`src/test/tgen/README.md`).

Config `processes[].path` selects an app by name; `args` pass through as
strings (argv-style).
"""

from __future__ import annotations

from typing import Callable

from ..kernel import errors

MS = 1_000_000


def http_server(api, port="80", size="10485760"):
    """Serve `size` bytes to every GET, forever (like `python3 -m
    http.server` with one file)."""
    port, size = int(port), int(size)
    payload = bytes(i & 0xFF for i in range(1024)) * (size // 1024 + 1)
    payload = payload[:size]
    lst = api.tcp_socket()
    lst.bind(("0.0.0.0", port))
    lst.listen()
    header = (
        b"HTTP/1.0 200 OK\r\nContent-Length: " + str(size).encode() + b"\r\n\r\n"
    )
    while True:
        conn = yield from api.accept(lst)
        # serve sequentially (http.server is single-threaded too)
        req = b""
        while b"\r\n\r\n" not in req:
            chunk = yield from api.recv(conn)
            if not chunk:
                break
            req += chunk
        if b"\r\n\r\n" in req:
            yield from api.send_all(conn, header + payload)
        api.close(conn)


def http_client(api, server="server", port="80", path="/file"):
    """GET a file and check the declared Content-Length arrived (curl)."""
    s = api.tcp_socket()
    yield from api.connect(s, (server, int(port)))
    yield from api.send_all(
        s, b"GET " + path.encode() + b" HTTP/1.0\r\nHost: x\r\n\r\n"
    )
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = yield from api.recv(s)
        if not chunk:
            raise errors.SyscallError(errors.ECONNRESET, "short response")
        data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    length = None
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"content-length:"):
            length = int(line.split(b":")[1])
    assert length is not None, "no Content-Length"
    while len(body) < length:
        chunk = yield from api.recv(s)
        if not chunk:
            break
        body += chunk
    api.close(s)
    if len(body) != length:
        raise errors.SyscallError(errors.ECONNRESET, "truncated body")
    return 0


def udp_echo_server(api, port="5353"):
    s = api.udp_socket()
    s.bind(("0.0.0.0", int(port)))
    while True:
        data, src = yield from api.recvfrom(s)
        yield from api.sendto(s, data, src)


def udp_client(api, server="server", port="5353", count="10", interval_ms="100"):
    s = api.udp_socket()
    got = 0
    for i in range(int(count)):
        yield from api.sendto(s, b"ping-%d" % i, (server, int(port)))
        data, _src = yield from api.recvfrom(s)
        got += 1
        yield from api.sleep(int(interval_ms) * MS)
    assert got == int(count)
    return 0


def tgen_server(api, port="8888"):
    """Fixed-size transfer server: reads an 8-byte size request, streams
    that many bytes (tgen's fixed-size transfer model)."""
    lst = api.tcp_socket()
    lst.bind(("0.0.0.0", int(port)))
    lst.listen()
    chunk = bytes(range(256)) * 256  # 64 KiB pattern
    while True:
        conn = yield from api.accept(lst)
        req = yield from api.recv_exact(conn, 8)
        if len(req) == 8:
            want = int.from_bytes(req, "big")
            sent = 0
            while sent < want:
                n = yield from api.send(conn, chunk[: min(65536, want - sent)])
                sent += n
        api.close(conn)


def tgen_client(api, server="server", port="8888", size="1048576", count="1"):
    for _ in range(int(count)):
        s = api.tcp_socket()
        yield from api.connect(s, (server, int(port)))
        want = int(size)
        yield from api.send_all(s, want.to_bytes(8, "big"))
        body = yield from api.recv_exact(s, want)
        api.close(s)
        if len(body) != want:
            raise errors.SyscallError(errors.ECONNRESET, "short transfer")
    return 0


APP_REGISTRY: dict[str, Callable] = {
    "http-server": http_server,
    "http-client": http_client,
    "udp-echo-server": udp_echo_server,
    "udp-client": udp_client,
    "tgen-server": tgen_server,
    "tgen-client": tgen_client,
}


def resolve(path: str) -> Callable:
    """Map a config `path` to an app. Accepts bare names and ignores
    directory prefixes so configs can say `/bin/http-server`."""
    name = path.rsplit("/", 1)[-1]
    try:
        return APP_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown app {path!r}; available: {sorted(APP_REGISTRY)}"
        ) from None
