"""Minimal HTTP/1.1 wire helpers of the serving tier.

The port's own copy of ``relora_tpu/serve/wire.py``: the HTTP dialect of
the front end, the page-run codec of the disaggregated tier
(:func:`encode_page_run`, :func:`decode_page_run`) and the migration record
(:func:`build_migration_record`, :func:`parse_migration_record`).  Stdlib
only, so a front-end process can import it without torch.  The dialect is
deliberately tiny: HTTP/1.1, ``Connection: close`` on every response,
``Content-Length`` bodies on requests, close-delimited bodies on streaming
responses.
"""

from __future__ import annotations

import asyncio
import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

MAX_BODY_BYTES = 16 << 20

#: frame magic of the binary page-run transfer format (bump on a layout change)
PAGE_RUN_MAGIC = b"RPR1"

REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    409: "Conflict", 413: "Payload Too Large", 422: "Unprocessable Entity",
    429: "Too Many Requests", 500: "Internal Server Error", 501: "Not Implemented",
    502: "Bad Gateway", 503: "Service Unavailable",
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


def encode_page_run(
    meta: Dict[str, Any],
    arrays: Sequence[Tuple[str, str, Sequence[int], bytes]],
) -> bytes:
    """Frame a migrated KV page run for ``POST /internal/migrate``.

    ``arrays`` is ``(name, dtype, shape, raw_bytes)`` per pool leaf (the
    engine's ``export_page_run``).  Layout: ``RPR1 | u32 header_len | header
    JSON | payload bytes | u32 crc``, the header holding ``meta`` and each
    array's ``(name, dtype, shape, nbytes)``, the trailing crc32 covering
    everything before it: the JAX package's frame byte for byte."""
    entries = []
    payload = bytearray()
    for name, dtype, shape, raw in arrays:
        if len(raw) > MAX_BODY_BYTES:
            raise ValueError(f"page-run array {name!r} too large: {len(raw)} bytes")
        entries.append({"name": name, "dtype": dtype, "shape": list(shape), "nbytes": len(raw)})
        payload += raw
    header = json.dumps({"meta": meta, "arrays": entries}).encode()
    blob = PAGE_RUN_MAGIC + struct.pack("<I", len(header)) + header + bytes(payload)
    return blob + struct.pack("<I", zlib.crc32(blob) & 0xFFFFFFFF)


def decode_page_run(
    blob: bytes,
) -> Tuple[Dict[str, Any], List[Tuple[str, str, Tuple[int, ...], bytes]]]:
    """Inverse of :func:`encode_page_run`.  Raises ValueError on a torn or
    corrupt frame (short blob, bad magic, bad crc, header or payload length
    mismatch), so a receiver rejects it and the donor decodes locally."""
    if len(blob) < len(PAGE_RUN_MAGIC) + 8:
        raise ValueError(f"page-run blob truncated: {len(blob)} bytes")
    if blob[: len(PAGE_RUN_MAGIC)] != PAGE_RUN_MAGIC:
        raise ValueError(f"bad page-run magic: {blob[:4]!r}")
    body, (crc,) = blob[:-4], struct.unpack("<I", blob[-4:])
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ValueError("page-run crc mismatch (torn transfer?)")
    (header_len,) = struct.unpack("<I", blob[4:8])
    header_end = 8 + header_len
    if header_end > len(body):
        raise ValueError("page-run header overruns blob")
    try:
        header = json.loads(body[8:header_end].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"page-run header unparseable: {e}") from e
    if not isinstance(header, dict) or "meta" not in header or "arrays" not in header:
        raise ValueError("page-run header missing meta/arrays")
    arrays: List[Tuple[str, str, Tuple[int, ...], bytes]] = []
    off = header_end
    for ent in header["arrays"]:
        nbytes = int(ent["nbytes"])
        if nbytes < 0 or off + nbytes > len(body):
            raise ValueError(f"page-run array {ent.get('name')!r} overruns payload")
        arrays.append((str(ent["name"]), str(ent["dtype"]),
                       tuple(int(d) for d in ent["shape"]), body[off : off + nbytes]))
        off += nbytes
    if off != len(body):
        raise ValueError(f"page-run trailing garbage: {len(body) - off} bytes")
    return header["meta"], arrays


def build_migration_record(
    *,
    uid: int,
    prompt: Sequence[int],
    max_new_tokens: int,
    temperature: float,
    top_p: float,
    spec: bool,
    adapter: Optional[str],
    first_token: int,
    position: int,
    token_index: int,
    n_pages: int,
) -> Dict[str, Any]:
    """The migration record's JSON shape: the request, its first token, the
    decode position and token index it resumes at, and its run's page
    count, every field cast to a JSON-native type."""
    return {
        "uid": int(uid),
        "prompt": [int(t) for t in prompt],
        "max_new_tokens": int(max_new_tokens),
        "temperature": float(temperature),
        "top_p": float(top_p),
        "spec": bool(spec),
        "adapter": adapter,
        "first_token": int(first_token),
        "position": int(position),
        "token_index": int(token_index),
        "n_pages": int(n_pages),
    }


def parse_migration_record(record: Dict[str, Any]) -> Dict[str, Any]:
    """An inbound record's fields as host scalars.  Raises KeyError,
    ValueError or TypeError on a malformed record: a receiver maps any raise
    to a rejected handoff."""
    return {
        "uid": int(record["uid"]),
        "prompt": [int(t) for t in record["prompt"]],
        "max_new_tokens": int(record["max_new_tokens"]),
        "temperature": float(record.get("temperature", 0.0)),
        "top_p": float(record.get("top_p", 1.0)),
        "spec": bool(record.get("spec", True)),
        "adapter": record.get("adapter"),
        "first_token": int(record["first_token"]),
        "position": int(record["position"]),
        "token_index": int(record.get("token_index", 1)),
        "n_pages": int(record["n_pages"]),
    }


async def read_http_request(
    reader: asyncio.StreamReader,
    route_limits: Optional[Dict[str, int]] = None,
) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
    """Request line, headers (lower-cased names) and a Content-Length body.
    Returns None on an empty connection (a port probe); raises ValueError on
    a malformed request line or an oversized body: over ``MAX_BODY_BYTES``,
    or over ``route_limits[route]`` where the route has its own limit."""
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
    if length > (route_limits or {}).get(target.split("?", 1)[0], MAX_BODY_BYTES):
        raise ValueError(f"body too large: {length} bytes")
    body = await reader.readexactly(length) if length else b""
    return method, target, headers, body
