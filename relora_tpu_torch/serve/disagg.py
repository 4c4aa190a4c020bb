"""Disaggregated prefill/decode serving: roles, request classification, the
fleet prefix-page directory and peer discovery.

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
``peers.json`` roster (:func:`load_peers`, kept by the supervisor) lets
replicas find each other without a discovery service; the collector feeds
:class:`PrefixPageDirectory` from the prefix digests each replica advertises
on ``/healthz`` and serves lookups at ``/fleet/prefix``, so a local prefix
miss becomes a fetch from a peer instead of a recompute.  Every failure
path of this module's consumers fails open to local work.

Stdlib only (json, threading, http.client), so a front-end process can
import it without torch.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

ROLES = ("prefill", "decode", "mixed")

#: default prompt-length threshold (tokens) at and above which a request
#: routes to the prefill pool
DEFAULT_CLASSIFY_THRESHOLD = 128


def classify_request(prompt_tokens: int, threshold: int) -> str:
    """Route class of a request: long prompts are prefill-heavy work, short
    ones decode-dominated chat traffic."""
    return "prefill" if prompt_tokens >= threshold else "decode"


class PrefixPageDirectory:
    """Fleet-wide map: page-aligned prefix digest (hex) -> the replica
    holding those pages, ``(rid, host, port)``.

    The collector feeds it from the ``prefix_digests`` each replica
    advertises on ``/healthz`` (``PrefixCache.digests``, salted per adapter
    in the port); replicas query it through ``GET /fleet/prefix?d=<hex>,...``
    on the router.  It is advisory: an entry may be stale (the donor evicted
    the run since its last scrape), and then the fetch answers 404 and the
    requester prefills locally.  Capacity is a plain LRU bound.

    Written from the collector's scrape thread, read from the router's event
    loop: every operation takes the one lock.
    """

    def __init__(self, max_entries: int = 4096):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._lock = threading.Lock()
        # digest hex -> (rid, host, port); insertion order is the LRU order
        self._entries: "OrderedDict[str, Tuple[str, str, int]]" = OrderedDict()
        self._by_rid: Dict[str, set] = {}
        self.updates = 0
        self.lookups = 0
        self.hits = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def update(self, rid: str, host: str, port: int, digests: Sequence[str]) -> None:
        """Replace ``rid``'s advertised set: digests it no longer holds drop
        out (unless another replica advertised them since), new ones file in."""
        with self._lock:
            self.updates += 1
            fresh = {str(d) for d in digests}
            for stale in self._by_rid.get(rid, set()) - fresh:
                if self._entries.get(stale, (None,))[0] == rid:
                    del self._entries[stale]
            for digest in fresh:
                self._entries[digest] = (rid, host, int(port))
                self._entries.move_to_end(digest)
            self._by_rid[rid] = fresh
            while len(self._entries) > self.max_entries:
                dropped, (drid, _, _) = self._entries.popitem(last=False)
                self._by_rid.get(drid, set()).discard(dropped)

    def drop_replica(self, rid: str) -> None:
        """Forget a replica's entries (it went down or left the fleet)."""
        with self._lock:
            for digest in self._by_rid.pop(rid, set()):
                if self._entries.get(digest, (None,))[0] == rid:
                    del self._entries[digest]

    def lookup(
        self, digests: Sequence[str], exclude_rid: Optional[str] = None
    ) -> Optional[Tuple[str, str, str, int]]:
        """The first digest (in the caller's order, longest prefix first)
        with a known holder, as ``(digest, rid, host, port)``; None on a
        total miss.  ``exclude_rid`` keeps a replica from fetching from
        itself."""
        with self._lock:
            self.lookups += 1
            for digest in digests:
                entry = self._entries.get(str(digest))
                if entry is None or entry[0] == exclude_rid:
                    continue
                self._entries.move_to_end(str(digest))
                self.hits += 1
                return (str(digest),) + entry
            return None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "replicas": sum(1 for s in self._by_rid.values() if s),
                "updates": self.updates,
                "lookups": self.lookups,
                "hits": self.hits,
            }


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
