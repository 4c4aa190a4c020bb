"""Block-granular KV-cache paging: free-list allocator + prefix cache.

A standalone copy of ``relora_tpu/serve/paging.py`` (host-side bookkeeping,
no device code): the PyTorch port imports nothing of the JAX package.

- :class:`PageAllocator` — a free-list stack over page ids with per-page
  refcounts.  ``alloc`` is all-or-nothing: a request either gets every page
  its worst case needs (``ceil((prompt + max_new_tokens) / page_size)``) or
  stays queued.  Page id 0 is the **null page**: never allocated, it is
  where padded block-table entries point, so garbage writes from idle
  decode rows and chunk padding land in a page nothing reads unmasked.
- :class:`PrefixCache` — refcounted sharing of page-aligned prompt
  prefixes, keyed by the digest of their tokens, evicted LRU under
  allocation pressure.  A tenant adapter's name salts the digest: pages
  written through one adapter are never shared with another (the JAX
  package keys by tokens alone, and so mixes tenants).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["NULL_PAGE", "PageAllocator", "PrefixCache", "pages_needed"]

#: reserved pool page: block-table padding points here, trash writes land
#: here, and the allocator never hands it out
NULL_PAGE = 0


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages required to hold ``n_tokens`` cache entries (ceil division)."""
    return -(-n_tokens // page_size)


class PageAllocator:
    """Free-list allocator over pool pages ``1..num_pages-1`` (0 is null).

    ``alloc(n)`` pops ``n`` pages (refcount 1 each) or returns ``None``
    without allocating anything — the caller keeps the request queued and
    retries after pages free up.  ``incref``/``decref`` implement sharing
    (prefix cache): a page returns to the free list only when its last
    reference drops.

    ``page_bytes`` is the resident HBM one page costs across every layer —
    codes plus, for an int8 pool, its per-page scales (the scheduler passes
    ``engine.pool_bytes() / num_pages``).  It only feeds the ``used_bytes``
    / ``free_bytes`` accounting views; allocation itself counts pages.
    """

    def __init__(self, num_pages: int, page_size: int, page_bytes: int = 0):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is reserved), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.page_bytes = page_bytes
        # stack: pop() hands out low page ids first (cosmetic, but makes the
        # allocation order deterministic for tests and debugging)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: List[int] = [0] * num_pages
        self.peak_used = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def used_bytes(self) -> int:
        """HBM held by allocated pages (0 when ``page_bytes`` unset)."""
        return self.used_pages * self.page_bytes

    @property
    def free_bytes(self) -> int:
        return self.free_pages * self.page_bytes

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages, all-or-nothing.  Returns None when fewer than
        ``n`` pages are free (nothing is allocated in that case)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for page in pages:
            self._refs[page] = 1
        self.peak_used = max(self.peak_used, self.used_pages)
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        for page in pages:
            if self._refs[page] < 1:
                raise ValueError(f"incref of free page {page}")
            self._refs[page] += 1

    def decref(self, pages: Sequence[int]) -> int:
        """Drop one reference per page; pages reaching zero return to the
        free list.  Returns how many pages were actually freed."""
        freed = 0
        for page in pages:
            if page == NULL_PAGE or not 0 < page < self.num_pages:
                raise ValueError(f"decref of invalid page {page}")
            if self._refs[page] < 1:
                raise ValueError(f"double free of page {page}")
            self._refs[page] -= 1
            if self._refs[page] == 0:
                self._free.append(page)
                freed += 1
        return freed

    def refcount(self, page: int) -> int:
        return self._refs[page]


@dataclasses.dataclass
class _PrefixEntry:
    pages: Tuple[int, ...]  # pool pages holding this prefix, logical order
    n_tokens: int  # len(pages) * page_size


class PrefixCache:
    """Digest-keyed cache of page-aligned prompt prefixes over a
    :class:`PageAllocator`.

    ``lookup(prompt)`` returns the longest cached page-aligned prefix of the
    prompt (pages increfed for the caller) — capped at ``(len(prompt)-1) //
    page_size`` pages so at least one prompt token is always re-prefilled
    (the first sampled token needs its logits).  ``register(prompt, pages)``
    files every page-aligned prefix of a *fully prefilled* prompt; only
    pages completely covered by prompt tokens are ever registered, so a
    donor's decode writes (at positions >= len(prompt)) never touch a
    shared page.  ``evict(n)`` drops least-recently-used entries until the
    allocator has ``n`` pages free — it only releases the cache's own
    references, so pages shared with live requests survive.
    """

    def __init__(self, allocator: PageAllocator, *, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.allocator = allocator
        self.max_entries = max_entries
        # insertion/touch order is the LRU order: move_to_end on every hit
        self._entries: "OrderedDict[bytes, _PrefixEntry]" = OrderedDict()
        self.lookups = 0
        self.hits = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    @staticmethod
    def _digest(tokens: Sequence[int], salt: Optional[str] = None) -> bytes:
        """Key of a token prefix.  ``salt`` (an adapter's name) keys the
        prefix per tenant: K/V pages depend on the adapter that wrote them,
        so a tenant must never read another's.  No salt gives the plain
        token digest."""
        h = hashlib.sha1()
        if salt is not None:
            h.update(b"adapter\0" + salt.encode() + b"\0")
        for t in tokens:
            h.update(int(t).to_bytes(8, "little", signed=True))
        return h.digest()

    def lookup(self, prompt: Sequence[int], salt: Optional[str] = None) -> Tuple[List[int], int]:
        """Longest cached page-aligned proper prefix of ``prompt`` under
        ``salt``.  Returns ``(pages, n_tokens)`` with every returned page
        increfed for the caller (who must decref them at retire), or
        ``([], 0)``."""
        ps = self.allocator.page_size
        self.lookups += 1
        for k in range((len(prompt) - 1) // ps, 0, -1):
            digest = self._digest(prompt[: k * ps], salt)
            entry = self._entries.get(digest)
            if entry is None:
                continue
            self._entries.move_to_end(digest)
            self.allocator.incref(entry.pages)
            self.hits += 1
            return list(entry.pages), entry.n_tokens
        return [], 0

    def register(
        self, prompt: Sequence[int], pages: Sequence[int], salt: Optional[str] = None
    ) -> int:
        """File every page-aligned prefix of a fully prefilled prompt whose
        block pages are ``pages`` (logical order), under ``salt``.  Returns
        how many new entries were created.  Capacity overflow evicts LRU
        entries."""
        ps = self.allocator.page_size
        created = 0
        for k in range(1, len(prompt) // ps + 1):
            digest = self._digest(prompt[: k * ps], salt)
            if digest in self._entries:
                self._entries.move_to_end(digest)
                continue
            entry = _PrefixEntry(pages=tuple(pages[:k]), n_tokens=k * ps)
            self.allocator.incref(entry.pages)
            self._entries[digest] = entry
            created += 1
            while len(self._entries) > self.max_entries:
                self._drop_lru()
        return created

    def digests(self, limit: int = 64) -> List[str]:
        """Hex digests of the most-recently-used entries, MRU first — the
        replica advertises these on /healthz for the fleet prefix-page
        directory (bounded so the payload stays scrape-sized)."""
        out: List[str] = []
        for digest in reversed(self._entries):
            out.append(digest.hex())
            if len(out) >= limit:
                break
        return out

    def acquire(self, digest_hex: str) -> Optional[Tuple[List[int], int]]:
        """Pin an entry's pages for an in-flight export: increfs every page
        and returns ``(pages, n_tokens)``, or None when the digest is not
        cached.  The caller must ``allocator.decref(pages)`` once the
        transfer completes — the pin is what keeps LRU eviction (or a
        concurrent ``clear``) from freeing a run mid-transfer."""
        try:
            digest = bytes.fromhex(digest_hex)
        except ValueError:
            return None
        entry = self._entries.get(digest)
        if entry is None:
            return None
        self._entries.move_to_end(digest)
        self.allocator.incref(entry.pages)
        return list(entry.pages), entry.n_tokens

    def evict(self, pages_wanted: int) -> int:
        """Drop LRU entries until the allocator has ``pages_wanted`` free
        pages or the cache is empty.  Returns pages actually freed."""
        freed = 0
        while self._entries and self.allocator.free_pages < pages_wanted:
            freed += self._drop_lru()
        return freed

    def clear(self) -> int:
        freed = 0
        while self._entries:
            freed += self._drop_lru()
        return freed

    def _drop_lru(self) -> int:
        _, entry = self._entries.popitem(last=False)
        return self.allocator.decref(entry.pages)

    def stats(self) -> Dict[str, float]:
        return {
            "entries": len(self._entries),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": round(self.hit_rate, 4),
        }
