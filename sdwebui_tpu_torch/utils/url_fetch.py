"""HTTP(S) fetches of user-given URLs: image fields that hold a URL
(``sdwebui_tpu/server/app.py:478-492``) and the extensions index.

JAX fetches any URL it is given, so a request can make the server read
its own loopback or private network.  The port resolves the host first and
refuses the URL unless every address it resolves to is global, as the
reference's ``verify_url`` does (modules/api/api.py:64-80); it then
connects to the address it checked, so a second lookup cannot swap in
another, and it follows no redirect.  ``resolve`` and ``open_socket`` are
the module's two points of contact with the network.
"""

from __future__ import annotations

import http.client
import ipaddress
import socket
import ssl
import urllib.parse


class URLRefused(ValueError):
    """A URL this server will not fetch, or a fetch that failed."""


def resolve(host: str, port: int) -> list[str]:
    """Every address `host` resolves to."""
    return [info[4][0] for info in socket.getaddrinfo(host, port, type=socket.SOCK_STREAM)]


def open_socket(address: str, port: int, timeout: float) -> socket.socket:
    return socket.create_connection((address, port), timeout=timeout)


def is_global(address: str) -> bool:
    ip = ipaddress.ip_address(address)
    if isinstance(ip, ipaddress.IPv6Address) and ip.ipv4_mapped is not None:
        ip = ip.ipv4_mapped
    return ip.is_global


def check_url(url: str) -> tuple:
    """(scheme, host, port, request target, the checked address) of an
    http(s) URL whose host resolves to global addresses only; URLRefused
    before any connection otherwise."""
    parts = urllib.parse.urlsplit(url)
    if parts.scheme not in ("http", "https") or not parts.hostname:
        raise URLRefused(f"not an http(s) URL: {url!r}")
    try:
        port = parts.port or (443 if parts.scheme == "https" else 80)
        addresses = resolve(parts.hostname, port)
    except (OSError, ValueError) as e:
        raise URLRefused(f"cannot resolve {parts.hostname!r}: {e}") from e
    local = [a for a in addresses if not is_global(a)]
    if not addresses or local:
        raise URLRefused(f"request to a local resource not allowed: {parts.hostname!r} "
                         f"resolves to {local or 'nothing'}")
    target = urllib.parse.urlunsplit(("", "", parts.path or "/", parts.query, ""))
    return parts.scheme, parts.hostname, port, target, addresses[0]


def fetch(url: str, useragent: str = "", timeout: float = 30.0) -> bytes:
    """The body of a GET of `url` (status 200 only), from the address
    check_url checked."""
    scheme, host, port, target, address = check_url(url)
    try:
        sock = open_socket(address, port, timeout)
        if scheme == "https":
            sock = ssl.create_default_context().wrap_socket(sock, server_hostname=host)
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        conn.sock = sock
        try:
            conn.request("GET", target, headers={"User-Agent": useragent} if useragent else {})
            resp = conn.getresponse()
            if resp.status != 200:
                raise URLRefused(f"{url!r} answered HTTP {resp.status}")
            return resp.read()
        finally:
            conn.close()
    except (OSError, http.client.HTTPException) as e:
        raise URLRefused(f"could not fetch {url!r}: {e}") from e
