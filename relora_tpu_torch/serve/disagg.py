"""Disaggregated prefill/decode serving: roles, request classification and
peer discovery.

The port's own copy of ``relora_tpu/serve/disagg.py``.  A fleet split by
role serves each request on two replicas:

- **prefill** replicas run the prompt, then ship the finished page run
  (the pool's codes, and for an int8 pool its per-page k/v scales) to a
  decode peer over ``POST /internal/migrate`` (``wire.encode_page_run``);
- **decode** replicas adopt migrated runs into free slots
  (``scheduler.submit_migrated``) and continue the sample stream with the
  keys ``(uid, token_index)`` unchanged, token-identical to a mixed replica;
- **mixed** replicas serve everything and are the fallback pool.

The router classifies by prompt length (:func:`classify_request`); a
``peers.json`` roster (:func:`load_peers`) lets replicas find each other
without a discovery service.  Every failure path of this module's consumers
fails open to local work.

The fleet prefix-page directory (the reference's ``PrefixPageDirectory``,
fed by the collector and served at its ``/fleet/prefix``) waits for the
fleet front-end slice (ROADMAP Queue 1 item 5b), with the router, the
supervisor that writes ``peers.json`` and the collector.

Stdlib only (json, threading, http.client), so a front-end process can
import it without torch.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

ROLES = ("prefill", "decode", "mixed")

#: default prompt-length threshold (tokens) at and above which a request
#: routes to the prefill pool
DEFAULT_CLASSIFY_THRESHOLD = 128


def classify_request(prompt_tokens: int, threshold: int) -> str:
    """Route class of a request: long prompts are prefill-heavy work, short
    ones decode-dominated chat traffic."""
    return "prefill" if prompt_tokens >= threshold else "decode"


_peers_cache: Dict[str, Tuple[float, List[Dict[str, Any]]]] = {}
_peers_lock = threading.Lock()


def load_peers(path: Optional[str]) -> List[Dict[str, Any]]:
    """The ``peers.json`` roster: its ``replicas`` list of ``{"rid", "host",
    "port", "role"}`` dicts (entries without a port dropped).  Cached by the
    file's mtime, and fail-open: any read error returns the last good
    roster, or ``[]``."""
    if not path:
        return []
    with _peers_lock:
        cached = _peers_cache.get(path)
        try:
            mtime = os.stat(path).st_mtime
            if cached is not None and cached[0] == mtime:
                return cached[1]
            with open(path) as f:
                doc = json.load(f)
            peers = [p for p in doc.get("replicas", []) if isinstance(p, dict) and p.get("port")]
            _peers_cache[path] = (mtime, peers)
            return peers
        except Exception:
            return cached[1] if cached is not None else []


def pick_peers(
    peers: Sequence[Dict[str, Any]],
    *,
    role: str,
    exclude_rid: Optional[str] = None,
    fallback_role: str = "mixed",
) -> List[Dict[str, Any]]:
    """Candidates of a handoff: ``role`` replicas first, then
    ``fallback_role`` ones (a degraded fleet), never the caller itself."""
    live = [p for p in peers if p.get("rid") != exclude_rid]
    primary = [p for p in live if p.get("role") == role]
    fallback = [p for p in live if p.get("role") == fallback_role]
    return primary + fallback


def http_fetch(
    host: str,
    port: int,
    path: str,
    *,
    method: str = "GET",
    body: Optional[bytes] = None,
    timeout_s: float = 5.0,
    headers: Optional[Dict[str, str]] = None,
) -> Tuple[int, bytes]:
    """One blocking HTTP/1.1 exchange with a peer: ``(status, body)``.
    Raises the OSError family on a failed connect or a timeout; callers
    treat any raise as fail-open."""
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
    try:
        hdrs = dict(headers or {})
        if body is not None:
            hdrs.setdefault("Content-Type", "application/octet-stream")
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()
