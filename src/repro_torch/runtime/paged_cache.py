"""Host-side block-paged KV bookkeeping: free-list allocator + prefix radix.

Port of ``repro.runtime.paged_cache`` (pure Python, kept here as a copy so
that the port imports nothing of the JAX package): the same operations,
eviction order and metric names. The device side of the paged cache is a
physical page pool per layer group (``models.paged``: ``(n_groups,
n_pages, page_size, KV, hd)`` leaves) read through a per-slot page table
that rides every decode and verify call as an operand. THIS module is the
host half: which physical page backs which (slot, logical page), who else
holds a reference to it, and which committed prompt prefixes are resident
so a newly admitted request can map its first pages onto blocks another
request already computed.

* ``BlockAllocator`` — a free list plus per-page reference counts. A page is
  handed out with refcount 1, shared by ``incref`` (a second slot mapping it,
  or the radix tree retaining it), and returns to the free list when the last
  reference drops. Underflow is a hard error: the serving engine's page
  accounting must balance exactly (asserted by the engine-invariant property
  tests).

* ``RadixCache`` — a radix tree over committed prompt prefixes, one node per
  FULL page of ``page_size`` tokens, keyed by the page's token chunk. Roots
  are per ``(depth, width)``: cached K/V depends on the admission width (the
  morph operand gates the kv projection) and on how many layer groups are
  populated, so prefixes are only shared within one (depth, width) class.
  Matching returns the longest resident prefix as a physical-page list (the
  caller increfs what it maps); inserting retains the pages (one radix-owned
  reference per node); eviction drops least-recently-used leaves until the
  allocator can satisfy demand again. Only full pages participate — a
  partially filled tail page is private to its slot by construction, which is
  also what makes sharing write-free: every later write lands at a position
  >= the prompt length >= the shared-prefix length in tokens.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Hashable, List, Optional, Sequence, Tuple


class BlockAllocator:
    """Free-list page allocator with reference counts.

    Pages are small integers in ``[0, n_pages)``. ``alloc`` pops the free
    list (refcount 1); ``incref``/``decref`` adjust sharing; the last
    ``decref`` returns the page to the free list. All methods are O(1).
    """

    def __init__(self, n_pages: int):
        if n_pages <= 0:
            raise ValueError(f"page pool needs at least one page, got {n_pages}")
        self.n_pages = n_pages
        self.refcount = [0] * n_pages
        self._free: Deque[int] = deque(range(n_pages))
        self.peak_in_use = 0
        self.allocs = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def occupancy(self) -> float:
        return self.n_in_use / self.n_pages

    def can_alloc(self) -> bool:
        return bool(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("kv page pool exhausted (no free pages)")
        pid = self._free.popleft()
        assert self.refcount[pid] == 0, \
            f"free-list page {pid} has refcount {self.refcount[pid]}"
        self.refcount[pid] = 1
        self.allocs += 1
        self.peak_in_use = max(self.peak_in_use, self.n_in_use)
        return pid

    def incref(self, pid: int) -> None:
        if self.refcount[pid] <= 0:
            raise RuntimeError(f"incref on unallocated page {pid}")
        self.refcount[pid] += 1

    def decref(self, pid: int) -> None:
        if self.refcount[pid] <= 0:
            raise RuntimeError(f"refcount underflow on page {pid}")
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            self._free.append(pid)

    def metric_values(self) -> Dict[str, float]:
        """Flat pool-occupancy gauges for a MetricsRegistry callback."""
        return {"n_pages": self.n_pages, "in_use": self.n_in_use,
                "free": self.n_free, "occupancy": self.occupancy(),
                "peak_in_use": self.peak_in_use, "allocs": self.allocs}


class _RadixNode:
    __slots__ = ("children", "page", "last_used")

    def __init__(self, page: int = -1):
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.page = page
        self.last_used = 0


class RadixCache:
    """Radix tree of committed full-page prompt prefixes.

    One node per full page; a node's edge key is the tuple of ``page_size``
    token ids that page holds. Every resident node owns one allocator
    reference on its physical page, so a prefix stays mappable after the
    request that computed it completes; ``evict_lru`` releases those
    references leaf-first when the pool runs dry.
    """

    def __init__(self, allocator: BlockAllocator):
        self.alloc = allocator
        self.roots: Dict[Hashable, _RadixNode] = {}
        self._clock = 0
        self.hits = 0  # pages served from the tree by match()
        self.misses = 0  # chunks requested but not resident

    # -- queries ------------------------------------------------------------

    def match(self, key: Hashable, chunks: Sequence[Tuple[int, ...]]) -> List[int]:
        """Longest resident prefix of ``chunks`` under root ``key``.

        Returns the physical pages backing that prefix, in order. The caller
        owns NO reference on them yet — it must ``incref`` each page it maps
        into a slot's table.
        """
        node = self.roots.get(key)
        pages: List[int] = []
        if node is None:
            self.misses += len(chunks)
            return pages
        self._clock += 1
        for ch in chunks:
            nxt = node.children.get(tuple(ch))
            if nxt is None:
                break
            nxt.last_used = self._clock
            pages.append(nxt.page)
            node = nxt
        self.hits += len(pages)
        self.misses += len(chunks) - len(pages)
        return pages

    def insert(self, key: Hashable, chunks: Sequence[Tuple[int, ...]],
               pages: Sequence[int]) -> int:
        """Record ``chunks[i] -> pages[i]``; returns the number of NEW nodes.

        Existing nodes keep their page (the caller's pages for a matched
        prefix are the same physical blocks); each newly created node takes
        one allocator reference on its page.
        """
        if len(chunks) != len(pages):
            raise ValueError(f"{len(chunks)} chunks vs {len(pages)} pages")
        node = self.roots.setdefault(key, _RadixNode())
        self._clock += 1
        created = 0
        for ch, pid in zip(chunks, pages):
            ch = tuple(ch)
            nxt = node.children.get(ch)
            if nxt is None:
                nxt = _RadixNode(int(pid))
                node.children[ch] = nxt
                self.alloc.incref(int(pid))
                created += 1
            nxt.last_used = self._clock
            node = nxt
        return created

    # -- eviction -----------------------------------------------------------

    def _lru_leaf(self):
        """(parent, edge-key, node) of the least-recently-used leaf, or None."""
        best = None
        stack = [(root, k, node) for root in self.roots.values()
                 for k, node in root.children.items()]
        while stack:
            parent, k, node = stack.pop()
            if node.children:
                stack.extend((node, ck, cn) for ck, cn in node.children.items())
            elif best is None or node.last_used < best[2].last_used:
                best = (parent, k, node)
        return best

    def evict_lru(self, n: int = 1) -> int:
        """Drop up to ``n`` LRU leaves, releasing their page references.

        Returns the number of nodes evicted (0 when the tree is empty). A
        dropped reference only frees the physical page if no slot still maps
        it — evicting a prefix another request is reading is safe.
        """
        evicted = 0
        while evicted < n:
            leaf = self._lru_leaf()
            if leaf is None:
                break
            parent, k, node = leaf
            del parent.children[k]
            self.alloc.decref(node.page)
            evicted += 1
        return evicted

    # -- accounting (engine invariants / telemetry) -------------------------

    def held_pages(self) -> List[int]:
        """Physical pages the tree holds a reference on (one per node)."""
        out: List[int] = []
        stack = [n for root in self.roots.values()
                 for n in root.children.values()]
        while stack:
            node = stack.pop()
            out.append(node.page)
            stack.extend(node.children.values())
        return out

    @property
    def n_nodes(self) -> int:
        return len(self.held_pages())

    def freeable_pages(self) -> List[int]:
        """Pages ONLY the tree references (refcount 1): what eviction could
        actually return to the pool right now. Backpressure telemetry — a
        deferral with many freeable pages means the admission budget, not
        physical memory, is the binding constraint."""
        return [p for p in self.held_pages() if self.alloc.refcount[p] == 1]

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"nodes": self.n_nodes, "hits": self.hits,
                "misses": self.misses,
                "freeable": len(self.freeable_pages()),
                "hit_rate": self.hits / total if total else 0.0}

    def metric_values(self) -> Dict[str, float]:
        """Flat radix-reuse gauges for a MetricsRegistry callback (same
        values as ``stats`` — kept as the observability-facing alias so
        export call sites read uniformly across allocator/radix/spec)."""
        return self.stats()
