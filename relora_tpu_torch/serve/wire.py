"""Minimal HTTP/1.1 wire helpers of the serving front end.

The port's own copy of the HTTP half of ``relora_tpu/serve/wire.py`` (the
page-run codec and migration records wait for the disaggregated tier).  The
dialect is deliberately tiny: HTTP/1.1, ``Connection: close`` on every
response, ``Content-Length`` bodies on requests, close-delimited bodies on
streaming responses.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, Optional, Tuple

MAX_BODY_BYTES = 16 << 20

REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    413: "Payload Too Large", 429: "Too Many Requests", 500: "Internal Server Error",
    501: "Not Implemented", 502: "Bad Gateway", 503: "Service Unavailable",
}


def head(
    status: int,
    reason: str,
    content_type: str,
    extra: Optional[Dict[str, str]] = None,
    content_length: Optional[int] = None,
) -> bytes:
    lines = [
        f"HTTP/1.1 {status} {reason}",
        f"Content-Type: {content_type}",
        "Connection: close",
    ]
    if content_length is not None:
        lines.append(f"Content-Length: {content_length}")
    for k, v in (extra or {}).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def sse(obj: Dict[str, Any]) -> bytes:
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


async def respond(
    writer: asyncio.StreamWriter,
    status: int,
    body: str,
    *,
    content_type: str = "text/plain",
    extra_headers: Optional[Dict[str, str]] = None,
) -> None:
    payload = body.encode()
    writer.write(
        head(status, REASONS.get(status, "?"), content_type, extra_headers, len(payload))
    )
    writer.write(payload)
    await writer.drain()


async def respond_json(
    writer: asyncio.StreamWriter,
    status: int,
    obj: Dict[str, Any],
    *,
    extra_headers: Optional[Dict[str, str]] = None,
) -> None:
    await respond(
        writer, status, json.dumps(obj), content_type="application/json",
        extra_headers=extra_headers,
    )


async def read_http_request(
    reader: asyncio.StreamReader,
) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
    """Request line, headers (lower-cased names) and a Content-Length body.
    Returns None on an empty connection (a port probe); raises ValueError on
    a malformed request line or an oversized body."""
    line = await reader.readline()
    if not line.strip():
        return None
    parts = line.decode("latin-1").split()
    if len(parts) < 3:
        raise ValueError(f"malformed request line: {line!r}")
    method, target = parts[0].upper(), parts[1]
    headers: Dict[str, str] = {}
    while True:
        raw = await reader.readline()
        if raw in (b"\r\n", b"\n", b""):
            break
        key, _, value = raw.decode("latin-1").partition(":")
        headers[key.strip().lower()] = value.strip()
    length = int(headers.get("content-length", "0") or "0")
    if length > MAX_BODY_BYTES:
        raise ValueError(f"body too large: {length} bytes")
    body = await reader.readexactly(length) if length else b""
    return method, target, headers, body
