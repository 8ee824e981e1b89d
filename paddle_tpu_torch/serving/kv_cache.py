"""Paged KV cache — the HBM-bounded substrate of autoregressive decode.

The decode-serving problem (PAPERS.md, Ragged Paged Attention): every
live sequence needs its keys/values kept on-device, sequences have
ragged lengths that change every step, and a batched step wants
one fixed SHAPE. Contiguous per-sequence KV buffers force a choice
between one shape per ragged length or padding every sequence to max length (HBM scales with max_len x
max_sequences even when traffic is short). Paging dissolves both:

  - K/V live in ONE preallocated pool of fixed-size pages
    (``[layers, pages, page_size, kv_heads, head_dim]``) — the HBM
    footprint is set at construction and never moves, no matter how
    ragged the traffic;
  - each sequence owns an ordered list of page ids (its PAGE TABLE);
    the attention kernel reads K/V *through* the table, so sequences
    of any length batch into one shape per (slot-count, table-width)
    bucket;
  - pages return to a free list at completion and are reused — the
    allocator is the admission-control surface: when pages run out the
    refusal is an immediate structured ``ServerOverloaded``, never an
    OOM mid-decode.

Page 0 is RESERVED as the garbage page: dead decode slots and padded
page-table entries all point at it, so masked lanes in the batched
step have somewhere harmless to write/read without branching. The
allocator never hands it out.

PREFIX CACHING: the attention kernel only ever sees a page
TABLE, never ownership — so nothing stops two sequences' tables from
naming the same physical page. ``PrefixIndex`` exploits exactly that:
full prompt pages are published into a radix-over-pages index (each
entry keyed by a chained digest of its page's token content, so a
lookup walks the prompt page by page), refcounted, and IMMUTABLE from
publication on. A request whose prompt extends a cached chain maps the
shared pages read-only and prefills only its suffix; the partial tail
page is COPY-ON-WRITE — a mapper that needs to write into the page
region (its own suffix tokens, its decode tokens) gets a private
device copy, the shared page stays untouched. The last prompt token is
ALWAYS left to recompute (``cached <= len(prompt) - 1``): logits for
it come from running the model, not from cached K/V. Freed shared
pages stay in the index (refcount 0 = reclaimable, evicted LRU
leaf-first when the free list runs short) — ``pages_free`` counts them
as free because one eviction pass away is economically free.

RESERVATION: ``alloc`` still takes a worst-case token
count; demand-mode engines reserve only ``prompt + headroom`` and
``grow()`` one page at a time mid-decode — on exhaustion the ENGINE
preempts (spills a victim's pages to ``HostSpillStore``, frees them,
restores bitwise later), so admitted concurrency is priced by actual
token demand, not by the ``max_new_tokens`` long tail. The allocator's
refusals stay side-effect-free either way.
"""
from __future__ import annotations

import hashlib
import os
import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability import metrics as _metrics
from .errors import ServerOverloaded, ServingError

__all__ = ["PageAllocator", "PagedKvCache", "PrefixIndex",
           "HostSpillStore", "GARBAGE_PAGE", "PREFIX_ROOT", "chain_digest"]

# page id 0 is never allocated: dead slots / table padding target it
GARBAGE_PAGE = 0

_m_allocs = _metrics.counter("serving.kv.page_allocs")
_m_frees = _metrics.counter("serving.kv.page_frees")
_m_exhausted = _metrics.counter("serving.kv.exhaustions")
# prefix cache: hits/misses count REQUESTS (a hit mapped >=1
# cached token), cached_tokens counts prompt tokens answered from the
# index instead of prefilled, published counts pages that became
# shared, evictions counts cached pages reclaimed under pressure,
# cow_copies counts private copies of shared partial pages
_m_prefix_hits = _metrics.counter("serving.prefix.hits")
_m_prefix_misses = _metrics.counter("serving.prefix.misses")
_m_prefix_cached_tokens = _metrics.counter("serving.prefix.cached_tokens")
_m_prefix_published = _metrics.counter("serving.prefix.published_pages")
_m_prefix_evictions = _metrics.counter("serving.prefix.evictions")
_m_prefix_cow = _metrics.counter("serving.prefix.cow_copies")
# preemption spill traffic: pages/bytes that crossed to host
_m_spilled_pages = _metrics.counter("serving.kv.spilled_pages")
_m_spill_bytes = _metrics.counter("serving.kv.spill_bytes")
# speculative-decode rollback: pages that were grown for a
# verify chunk but ended up holding ONLY rejected tokens, returned to
# the free list by PageAllocator.shrink (the exact-pool invariant)
_m_shrunk_pages = _metrics.counter("serving.kv.shrunk_pages")

# the root of every prefix chain; depth-1 entries hang off it
PREFIX_ROOT = "root"


def chain_digest(parent: str, tokens) -> str:
    """Chained content digest of one prompt page: H(parent digest ||
    token ids). Walking a prompt page by page through these digests IS
    the prefix lookup — equal digests mean equal token history, so a
    matching entry's K/V pages are exactly the K/V this prompt would
    have computed. Stable across processes (the fleet router computes
    the same digests client-side to find warm replicas)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent.encode("utf-8"))
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.hexdigest()


class _PrefixEntry:
    __slots__ = ("key", "parent", "tokens", "page", "refs", "tick")

    def __init__(self, key: str, parent: str, tokens: Tuple[int, ...],
                 page: int):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.page = page
        self.refs = 0       # live sequences whose table names this page
        self.tick = 0       # LRU recency (allocator's monotonic clock)


class PrefixIndex:
    """Radix-over-pages prefix index: one entry per published prompt
    page, keyed by ``chain_digest`` so lookups walk digest by digest
    from ``PREFIX_ROOT``. Entries are IMMUTABLE from publication
    (their pages are never written again; a would-be writer copies —
    the COW rule) and refcounted by the live sequences mapping them;
    refcount-0 entries are reclaimable, evicted LRU and LEAF-FIRST
    (a parent is only removable once childless, so a chain can never
    dangle mid-walk).

    NOT independently locked: every method is ``*_locked`` and runs
    under the OWNING allocator's mutex, which is shared in as
    ``self._mu`` so the guard declarations (and the runtime sanitizer)
    name the real lock."""

    def __init__(self, mu, page_size: int):
        self._mu = mu  # lint: lock-alias — the OWNING allocator's mutex
        self.page_size = int(page_size)
        self._entries: Dict[str, _PrefixEntry] = {}  # guarded-by: _mu
        # parent digest -> child entry keys (full and partial children)
        self._children: Dict[str, List[str]] = {}  # guarded-by: _mu
        self._by_page: Dict[int, str] = {}  # guarded-by: _mu
        self._tick = 0  # guarded-by: _mu
        # memoized evictable count: the full walk is O(entries x
        # depth) and sits on the per-step gauge-publish path — refs/
        # structure changes invalidate, per-step token accounting
        # (which changes neither) reuses the memo
        self._evictable: Optional[int] = None  # guarded-by: _mu

    def invalidate_locked(self):
        self._evictable = None

    # -- queries ----------------------------------------------------------
    def pages_retained_locked(self) -> int:
        return len(self._entries)

    def shared_pages_locked(self) -> int:
        """Pages mapped by two or more live sequences right now —
        refs >= 2 (publisher + at least one sharer, or several
        sharers). The allocator-counter proof that n-best/beam
        siblings SHARE their prompt pages through the
        refcount rather than copying them."""
        return sum(1 for e in self._entries.values() if e.refs >= 2)

    def evictable_count_locked(self) -> int:
        """Entries a cascading leaf-first eviction could reclaim right
        now: refcount-0 entries with no referenced descendant (an
        ancestor of a live mapping must stay — the chain walk needs
        it). Memoized between refcount/structure changes (the walk
        would otherwise run once per decode STEP via the
        fragmentation gauge publish)."""
        if self._evictable is not None:
            return self._evictable
        keep: set = set()
        for key, e in self._entries.items():
            if e.refs <= 0:
                continue
            k = key
            while k != PREFIX_ROOT and k not in keep:
                keep.add(k)
                k = self._entries[k].parent
        self._evictable = len(self._entries) - len(keep)
        return self._evictable

    def match_locked(self, tokens: Sequence[int]
                     ) -> Tuple[List[_PrefixEntry],
                                Optional[Tuple[_PrefixEntry, int]]]:
        """Longest cached cover of ``tokens`` that still leaves >= 1
        token to recompute: ``(full shared entries, cow)`` where
        ``cow = (source entry, n_tokens)`` is the best partial-page
        extension (the caller device-copies the source page and trusts
        its first ``n_tokens`` offsets)."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        n = len(toks)
        matched: List[_PrefixEntry] = []
        parent = PREFIX_ROOT
        pos = 0
        # a full page is mappable read-only iff the request never
        # writes inside it: true while it ends at or before token n-2
        while pos + ps <= n - 1:
            key = chain_digest(parent, toks[pos:pos + ps])
            e = self._entries.get(key)
            if e is None or len(e.tokens) != ps or \
                    e.tokens != tuple(toks[pos:pos + ps]):
                break
            matched.append(e)
            parent = key
            pos += ps
        cow: Optional[Tuple[_PrefixEntry, int]] = None
        cap = (n - 1) - pos
        if cap > 0:
            best = 0
            for key in self._children.get(parent, ()):
                e = self._entries[key]
                lim = min(len(e.tokens), cap)
                m = 0
                while m < lim and e.tokens[m] == toks[pos + m]:
                    m += 1
                if m > best:
                    best, cow = m, (e, m)
        return matched, cow

    def roots_locked(self, cap: int = 32) -> List[str]:
        """Most-recently-used depth-1 entry digests — what a replica
        advertises in its load_report so the fleet router can tell a
        warm replica from a cold one without shipping the trie."""
        roots = [self._entries[k]
                 for k in self._children.get(PREFIX_ROOT, ())]
        roots.sort(key=lambda e: -e.tick)
        return [e.key for e in roots[:cap]]

    def cached_tokens_locked(self) -> int:
        return sum(len(e.tokens) for e in self._entries.values())

    # -- mutation ---------------------------------------------------------
    def touch_locked(self, e: _PrefixEntry):
        self._tick += 1
        e.tick = self._tick

    def publish_locked(self, pages: Sequence[int],
                       tokens: Sequence[int]) -> int:
        """Insert a completed prompt's pages: every full prompt page,
        plus the partial tail page (COW source for extenders). Pages
        whose chain digest already has an entry are skipped — the
        owner's private duplicate stays private and returns to the
        free list at its free(). From here on the inserted pages are
        immutable: their owner only ever writes positions PAST the
        published token range, and every other sequence either maps
        them read-only (full pages) or copies (the partial tail)."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        nfull = len(toks) // ps
        parent = PREFIX_ROOT
        created = 0
        for i in range(nfull):
            pt = tuple(toks[i * ps:(i + 1) * ps])
            key = chain_digest(parent, pt)
            e = self._entries.get(key)
            if e is None:
                if pages[i] in self._by_page:
                    # this page is already someone's published entry
                    # under a different chain — cannot happen for a
                    # privately-held page; defensive skip
                    break
                e = _PrefixEntry(key, parent, pt, pages[i])
                # the publisher still maps this page: it holds a ref
                # until its own free() (an unreffed entry would be
                # evictable while a live table names its page)
                e.refs = 1
                self._entries[key] = e
                self._children.setdefault(parent, []).append(key)
                self._by_page[pages[i]] = key
                created += 1
            elif e.tokens != pt:  # pragma: no cover - digest collision
                break
            self.touch_locked(e)
            parent = key
        tail = tuple(toks[nfull * ps:])
        if tail and nfull < len(pages) and \
                pages[nfull] not in self._by_page:
            if not any(self._entries[k].tokens == tail
                       for k in self._children.get(parent, ())):
                key = chain_digest(parent, tail)
                e = _PrefixEntry(key, parent, tail, pages[nfull])
                e.refs = 1  # the publisher's own mapping (see above)
                self._entries[key] = e
                self._children.setdefault(parent, []).append(key)
                self._by_page[pages[nfull]] = key
                self.touch_locked(e)
                created += 1
        if created:
            self.invalidate_locked()
        return created

    def release_page_locked(self, page: int) -> bool:
        """A sequence freed this page. True = the page belongs to a
        published entry and STAYS (refcount drops, LRU tick refreshed);
        False = private page, caller returns it to the free list."""
        key = self._by_page.get(page)
        if key is None:
            return False
        e = self._entries[key]
        e.refs = max(0, e.refs - 1)
        self.touch_locked(e)
        self.invalidate_locked()
        return True

    def evict_locked(self, want: int) -> List[int]:
        """Reclaim up to ``want`` pages: refcount-0 LEAVES first (a
        parent with children is structurally pinned), LRU among them.
        Returns the freed page ids."""
        out: List[int] = []
        while len(out) < want:
            best: Optional[_PrefixEntry] = None
            for key, e in self._entries.items():
                if e.refs == 0 and not self._children.get(key):
                    if best is None or e.tick < best.tick:
                        best = e
            if best is None:
                break
            self._entries.pop(best.key)
            self._by_page.pop(best.page, None)
            kids = self._children.get(best.parent)
            if kids is not None:
                kids.remove(best.key)
                if not kids:
                    self._children.pop(best.parent, None)
            self._children.pop(best.key, None)
            out.append(best.page)
            _m_prefix_evictions.inc()
            self.invalidate_locked()
        return out


class HostSpillStore:
    """Host-side refuge for a preempted sequence's KV pages.

    ``put`` parks the gathered page contents (bitwise — restore is an
    exact copy back), keyed by sequence id; ``pop`` surrenders them for
    restore; ``drop`` discards (cancel/deadline/retirement of a
    preempted sequence must leak nothing — spill files included).
    ``FLAGS['kv_spill_dir']`` (or the ``spill_dir`` argument) moves the
    payload to disk as one ``.npz`` per sequence — host RAM stays flat
    under heavy preemption; '' keeps spills in memory."""

    def __init__(self, spill_dir: Optional[str] = None,
                 label: Optional[str] = None):
        from ..flags import FLAGS

        self._dir = str(FLAGS["kv_spill_dir"]
                        if spill_dir is None else spill_dir)
        self._label = f"{label or 'kv'}-{uuid.uuid4().hex[:8]}"
        self._mu = threading.Lock()
        # seq_id -> (k, v) arrays, or the path holding them
        self._store: Dict[int, Any] = {}  # guarded-by: _mu

    def _path(self, seq_id: int) -> str:
        return os.path.join(self._dir,
                            f"kvspill-{self._label}-{int(seq_id)}.npz")

    def put(self, seq_id: int, *arrays: np.ndarray):
        """Park one preempted sequence's page contents: ``(k, v)`` for
        a plain decoder, ``(k, v, draft_k, draft_v)`` when a
        speculative draft's mirrored pool spills alongside (same page ids, so one spill covers both pools)."""
        n_pages = int(arrays[0].shape[1])
        nbytes = int(sum(a.nbytes for a in arrays))
        if self._dir:
            # disk I/O outside the mutex: count()/stats() callers hold
            # the engine condition and must not stall on a slow savez
            os.makedirs(self._dir, exist_ok=True)
            ent: Any = self._path(seq_id)
            np.savez(ent, **{f"a{i}": a for i, a in enumerate(arrays)})
        else:
            ent = tuple(arrays)
        with self._mu:
            self._store[int(seq_id)] = ent
        _m_spilled_pages.inc(n_pages)
        _m_spill_bytes.inc(nbytes)

    def pop(self, seq_id: int) -> Optional[Tuple[np.ndarray, ...]]:
        with self._mu:
            ent = self._store.pop(int(seq_id), None)
        if ent is None:
            return None
        if isinstance(ent, str):
            with np.load(ent) as z:
                out = tuple(z[f"a{i}"] for i in range(len(z.files)))
            try:
                os.remove(ent)
            except OSError:  # pragma: no cover - already swept
                pass
            return out
        return ent

    def drop(self, seq_id: int) -> bool:
        with self._mu:
            ent = self._store.pop(int(seq_id), None)
        if isinstance(ent, str):
            try:
                os.remove(ent)
            except OSError:  # pragma: no cover - already swept
                pass
        return ent is not None

    def clear(self):
        with self._mu:
            ents = list(self._store.values())
            self._store.clear()
        for ent in ents:
            if isinstance(ent, str):
                try:
                    os.remove(ent)
                except OSError:  # pragma: no cover
                    pass

    def count(self) -> int:
        with self._mu:
            return len(self._store)


class PageAllocator:
    """Free-list page allocator over a fixed pool of ``num_pages``.

    Deterministic by construction (tested): fresh pages are handed out
    in ascending id order, freed pages are reused LIFO — the same
    admit/complete sequence always yields the same page tables, which
    is what makes decode runs replayable and the chaos tests exact.
    With ``prefix_cache=True`` an embedded ``PrefixIndex`` (same lock)
    retains published prompt pages for reuse; ``pages_free`` then
    counts reclaimable (refcount-0) cached pages as free, because one
    LRU eviction pass inside ``alloc`` turns them into free pages.

    Thread-safe via one internal lock; every operation under it is a
    list/dict edit (no blocking calls — L102-clean by construction).
    """

    def __init__(self, num_pages: int, page_size: int,
                 label: Optional[str] = None, prefix_cache: bool = False):
        if num_pages < 2:
            raise ValueError(
                f"need >= 2 pages (one is the reserved garbage page), "
                f"got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._mu = threading.Lock()
        # stack: pop() yields 1, 2, 3, ... when fresh; freed pages are
        # pushed on top and reused first (LIFO)
        self._free: List[int] = list(
            range(self.num_pages - 1, 0, -1))  # guarded-by: _mu
        self._owner: Dict[int, List[int]] = {}  # guarded-by: _mu
        self._tokens: Dict[int, int] = {}  # guarded-by: _mu
        self._total_tokens = 0  # guarded-by: _mu
        self.prefix = (PrefixIndex(self._mu, self.page_size)
                       if prefix_cache else None)
        # gauges are keyed per allocator when a label (engine name.vN)
        # is given — coexisting pools (hot-swap drain, multi-model)
        # must not last-writer-wins-clobber each other's occupancy;
        # the plain names serve the bare/single-allocator case
        sfx = f".{label}" if label else ""
        self._g_pages_total = _metrics.gauge(f"serving.kv.pages_total{sfx}")
        self._g_pages_used = _metrics.gauge(f"serving.kv.pages_used{sfx}")
        # fraction of ALLOCATED token capacity not (yet) holding a real
        # token — the price of reserve-at-admission, and the signal
        # that page_size is too coarse for the traffic's length mix
        self._g_fragmentation = _metrics.gauge(
            f"serving.kv.fragmentation{sfx}")
        # pages the prefix index retains (shared + reclaimable)
        self._g_prefix_pages = _metrics.gauge(
            f"serving.kv.prefix_pages{sfx}")
        self._g_pages_total.set(self.num_pages)
        # under the lock even here: _publish_locked reads the (already
        # armed) PrefixIndex, and the guard sanitizer rightly insists
        with self._mu:
            self._publish_locked()

    # -- introspection ----------------------------------------------------
    def _free_count_locked(self) -> int:
        """Free-list pages plus reclaimable (refcount-0, unpinned)
        cached pages — what an alloc can actually obtain."""
        n = len(self._free)
        if self.prefix is not None:
            n += self.prefix.evictable_count_locked()
        return n

    @property
    def pages_free(self) -> int:
        with self._mu:
            return self._free_count_locked()

    @property
    def pages_used(self) -> int:
        """Pages held by live sequences or pinned shared prefixes
        (excluding the reserved garbage page and reclaimable cache)."""
        with self._mu:
            return (self.num_pages - 1) - self._free_count_locked()

    def held_pages(self, seq_id: int) -> int:
        with self._mu:
            return len(self._owner.get(seq_id, ()))

    def pages_of(self, seq_id: int) -> List[int]:
        with self._mu:
            return list(self._owner.get(seq_id, ()))

    def stats(self) -> Dict[str, float]:
        with self._mu:
            free = self._free_count_locked()
            used = (self.num_pages - 1) - free
            toks = self._total_tokens
            cap = used * self.page_size
            out = {
                "pages_total": self.num_pages,
                "pages_used": used,
                "pages_free": free,
                "page_size": self.page_size,
                "sequences": len(self._owner),
                "tokens": toks,
                # shared pages enter cap once but their tokens can be
                # counted by several mappers: clamp at 0
                "fragmentation": (max(0.0, 1.0 - toks / cap)
                                  if cap else 0.0),
            }
            if self.prefix is not None:
                out["prefix_pages"] = self.prefix.pages_retained_locked()
                out["prefix_reclaimable"] = \
                    self.prefix.evictable_count_locked()
                out["prefix_shared_pages"] = \
                    self.prefix.shared_pages_locked()
            return out

    def prefix_stats(self, roots_cap: int = 32) -> Optional[Dict[str, Any]]:
        """The load_report view of this allocator's prefix cache: entry
        count, cached prompt tokens, and the MRU depth-1 chain digests
        a router matches request prefixes against. None when prefix
        caching is off."""
        if self.prefix is None:
            return None
        with self._mu:
            return {
                "pages": self.prefix.pages_retained_locked(),
                "tokens": self.prefix.cached_tokens_locked(),
                "page_size": self.page_size,
                "shared": self.prefix.shared_pages_locked(),
                "roots": self.prefix.roots_locked(roots_cap),
            }

    def _publish_locked(self):
        free = self._free_count_locked()
        used = (self.num_pages - 1) - free
        self._g_pages_used.set(used)
        toks = self._total_tokens
        cap = used * self.page_size
        self._g_fragmentation.set(
            round(max(0.0, 1.0 - toks / cap), 6) if cap else 0.0)
        if self.prefix is not None:
            self._g_prefix_pages.set(self.prefix.pages_retained_locked())

    def retire(self):
        """Zero this allocator's gauges (engine retirement) so a
        drained pool's final values don't linger as live occupancy."""
        with self._mu:
            self._g_pages_total.set(0)
            self._g_pages_used.set(0)
            self._g_fragmentation.set(0.0)
            self._g_prefix_pages.set(0)

    # -- lifecycle --------------------------------------------------------
    def pages_for_tokens(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.page_size))

    def _take_locked(self, need: int, what: str) -> List[int]:
        """Pop ``need`` pages, reclaiming LRU refcount-0 prefix pages
        when the free list alone is short. Raises side-effect-free on
        the FREE LIST (evicted cache entries stay evicted — they were
        reclaimable by definition)."""
        if need > len(self._free) and self.prefix is not None:
            self._free.extend(
                self.prefix.evict_locked(need - len(self._free)))
        if need > len(self._free):
            _m_exhausted.inc()
            raise ServerOverloaded(
                f"KV page pool exhausted: need {need} pages for "
                f"{what}, {len(self._free)} of "
                f"{self.num_pages - 1} free — retry later, raise "
                f"kv_num_pages, or shed to another replica")
        return [self._free.pop() for _ in range(need)]

    def alloc(self, seq_id: int, n_tokens: int) -> List[int]:
        """Reserve pages for a sequence of up to ``n_tokens``. Raises
        ``ServerOverloaded`` (the pool IS the admission bound) without
        side effects when short."""
        need = self.pages_for_tokens(n_tokens)
        with self._mu:
            if seq_id in self._owner:
                raise ValueError(f"sequence {seq_id} already has pages")
            pages = self._take_locked(need, f"{n_tokens} tokens")
            self._owner[seq_id] = pages
            self._tokens[seq_id] = 0
            _m_allocs.inc(need)
            self._publish_locked()
            return list(pages)

    def alloc_prefix(self, seq_id: int, prompt: Sequence[int],
                     reserve_tokens: int) -> Dict[str, Any]:
        """Prefix-aware reservation: map the longest cached chain of
        ``prompt``'s full pages read-only (refcounted), pick the best
        COW source for the partial tail, and take fresh pages for the
        rest of ``reserve_tokens``. Returns ``{"pages", "cached_tokens",
        "cow"}`` where ``cow = {"key", "src", "dst", "tokens"}`` names
        the device copy the ENGINE must perform before the sequence's
        first step (the source entry is reffed until ``release_cow`` so
        eviction can't yank it mid-copy). Falls back to a plain miss
        when prefix caching is off."""
        prompt = [int(t) for t in prompt]
        with self._mu:
            if seq_id in self._owner:
                raise ValueError(f"sequence {seq_id} already has pages")
            matched: List[_PrefixEntry] = []
            cow = None
            if self.prefix is not None:
                matched, cow = self.prefix.match_locked(prompt)
            cached = len(matched) * self.page_size + \
                (cow[1] if cow else 0)
            need_total = self.pages_for_tokens(
                max(int(reserve_tokens), len(prompt)))
            # the COW destination is a fresh page; shared pages cover
            # the first len(matched) table slots
            fresh_need = max(1, need_total - len(matched))
            # pin the matched chain and the COW source BEFORE taking
            # fresh pages: _take_locked may evict refcount-0 entries,
            # and without the pin it could reclaim a page of the very
            # chain we just matched and hand it back as "fresh" —
            # one physical page aliased into two table slots
            # (unpinned again on refusal, so the
            # raise stays side-effect-free on refcounts)
            pinned = list(matched)
            if cow is not None:
                pinned.append(cow[0])
            for e in pinned:
                e.refs += 1
                self.prefix.touch_locked(e)
            if pinned:
                self.prefix.invalidate_locked()
            try:
                fresh = self._take_locked(
                    fresh_need, f"{reserve_tokens} tokens "
                    f"({cached} cached)")
            except ServerOverloaded:
                for e in pinned:
                    e.refs = max(0, e.refs - 1)
                if pinned:
                    self.prefix.invalidate_locked()
                raise
            cow_out = None
            if cow is not None:
                src, n = cow
                cow_out = {"key": src.key, "src": src.page,
                           "dst": fresh[0], "tokens": n}
            pages = [e.page for e in matched] + fresh
            self._owner[seq_id] = pages
            self._tokens[seq_id] = cached
            self._total_tokens += cached
            _m_allocs.inc(fresh_need)
            if cached:
                _m_prefix_hits.inc()
                _m_prefix_cached_tokens.inc(cached)
                _m_prefix_cow.inc(1 if cow_out else 0)
            elif self.prefix is not None:
                _m_prefix_misses.inc()
            self._publish_locked()
            return {"pages": list(pages), "cached_tokens": cached,
                    "cow": cow_out}

    def release_cow(self, key: str):
        """Drop the pin ``alloc_prefix`` took on a COW source entry —
        called once the device copy landed (or the request died before
        it could)."""
        with self._mu:
            if self.prefix is None:
                return
            e = self.prefix._entries.get(key)
            if e is not None:
                e.refs = max(0, e.refs - 1)
                self.prefix.touch_locked(e)
                self.prefix.invalidate_locked()

    def grow(self, seq_id: int, n_pages: int = 1) -> List[int]:
        """Extend a live sequence's reservation (demand-mode decode:
        the engine grows one page at a time as generation crosses page
        boundaries). All-or-nothing and side-effect-free on refusal —
        the engine answers a refusal with preemption, never a partial
        grant."""
        with self._mu:
            if seq_id not in self._owner:
                raise ValueError(f"sequence {seq_id} holds no pages")
            pages = self._take_locked(int(n_pages),
                                      f"growth of seq {seq_id}")
            self._owner[seq_id].extend(pages)
            _m_allocs.inc(len(pages))
            self._publish_locked()
            return pages

    def shrink(self, seq_id: int, n_pages: int) -> int:
        """Return the LAST ``n_pages`` of a live sequence's reservation
        to the free list — the speculative-decode rollback:
        a verify chunk grows the reservation to cover ``k+1`` writes,
        and a page that ended up holding ONLY rejected tokens must not
        stay reserved (the exact-pool invariant). Tail pages during
        decode are always private fresh pages, but each popped page
        still routes through the prefix-release check defensively.
        Returns how many pages were actually freed (capped so the
        sequence always keeps >= 1 page)."""
        with self._mu:
            pages = self._owner.get(seq_id)
            if pages is None:
                raise ValueError(f"sequence {seq_id} holds no pages")
            take = max(0, min(int(n_pages), len(pages) - 1))
            freed = 0
            for _ in range(take):
                p = pages.pop()
                if self.prefix is not None and \
                        self.prefix.release_page_locked(p):
                    continue  # pragma: no cover - published tail page
                self._free.append(p)
                freed += 1
            if freed:
                _m_shrunk_pages.inc(freed)
                _m_frees.inc(freed)
                self._publish_locked()
            return freed

    def publish(self, seq_id: int, prompt: Sequence[int]) -> int:
        """Publish a sequence's completed prompt pages into the prefix
        index (no-op without prefix caching). Metadata only — the K/V
        bytes are already on-device; from here those pages are
        immutable and shareable."""
        with self._mu:
            if self.prefix is None or seq_id not in self._owner:
                return 0
            n = self.prefix.publish_locked(self._owner[seq_id], prompt)
            if n:
                _m_prefix_published.inc(n)
                self._publish_locked()
            return n

    def reserved_tokens(self, seq_id: int) -> int:
        """Token capacity of the sequence's reservation (held pages x
        page_size). Appends — single decode tokens AND multi-token
        prefill chunks alike — always land inside this bound; it grows
        only through an explicit ``grow()`` (demand mode), never as a
        side effect of a step (the chunked-prefill invariant test
        reads it)."""
        with self._mu:
            return len(self._owner.get(seq_id, ())) * self.page_size

    def note_tokens(self, seq_id: int, n_tokens: int):
        """Record how many tokens the sequence has actually written —
        feeds the fragmentation gauge; never moves pages."""
        self.note_tokens_many({seq_id: n_tokens})

    def note_tokens_many(self, updates: Dict[int, int]):
        """Batched ``note_tokens`` for a whole decode step: one lock
        acquisition and one gauge publish for all live slots (the
        per-step hot path must not take the lock once per slot).
        Unknown (already freed) sequences are skipped."""
        with self._mu:
            changed = False
            for seq_id, n_tokens in updates.items():
                if seq_id in self._tokens:
                    n = int(n_tokens)
                    self._total_tokens += n - self._tokens[seq_id]
                    self._tokens[seq_id] = n
                    changed = True
            if changed:
                self._publish_locked()

    def free(self, seq_id: int) -> int:
        """Return a sequence's pages: private pages go back to the free
        list (LIFO reuse), published shared pages stay in the prefix
        index with their refcount dropped (refcount 0 = reclaimable).
        Idempotent: freeing an unknown sequence is a no-op (the
        completion path and an abort path may race)."""
        with self._mu:
            pages = self._owner.pop(seq_id, None)
            self._total_tokens -= self._tokens.pop(seq_id, 0)
            if not pages:
                return 0
            freed = 0
            # reversed: re-allocating immediately yields the same ids in
            # the same order the sequence held them (determinism test)
            for p in reversed(pages):
                if self.prefix is not None and \
                        self.prefix.release_page_locked(p):
                    continue
                self._free.append(p)
                freed += 1
            if freed:
                _m_frees.inc(freed)
            self._publish_locked()
            return freed

    def _fill_row_locked(self, seq_id: int, out: np.ndarray):
        pages = self._owner.get(seq_id, [])
        if len(pages) > out.shape[0]:
            raise ValueError(
                f"sequence {seq_id} holds {len(pages)} pages, table "
                f"width bucket {out.shape[0]} too narrow")
        out[:len(pages)] = pages

    def table_row(self, seq_id: int, width: int) -> np.ndarray:
        """The sequence's page table padded to ``width`` with the
        garbage page — the row shape is a COMPILED shape, so padding
        happens here, once, deterministically."""
        with self._mu:
            row = np.full((width,), GARBAGE_PAGE, dtype=np.int32)
            self._fill_row_locked(seq_id, row)
            return row

    def table_rows(self, seq_ids: Sequence[int], width: int,
                   rows: int) -> np.ndarray:
        """Stacked padded page tables ``[rows, width]`` for a whole
        decode batch under ONE lock acquisition — the per-step hot
        path must not take the allocator lock once per live slot."""
        out = np.full((int(rows), width), GARBAGE_PAGE, dtype=np.int32)
        with self._mu:
            for i, sid in enumerate(seq_ids):
                self._fill_row_locked(sid, out[i])
        return out


class PagedKvCache:
    """The device-side pool the allocator's page ids index into.

    K and V are each ``[layers, pages, page_size, kv_heads, head_dim]``
    torch tensors allocated ONCE on ``device`` — ``hbm_bytes`` is the
    whole KV budget of the engine, independent of how ragged the
    traffic is. Where the JAX package threads the pools through each
    step functionally (donated so XLA updates them in place), here the
    decode step and the page moves update the two tensors IN PLACE;
    ``rebind`` survives as the shape check a step's result must pass.

    MESH-SHARDED pools (``mesh=`` a ``DeviceMesh``, ``shard_spec=`` a
    ``PartitionSpec`` over the five dims, the kv-head dim sharded): K
    and V are DTensors whose every rank holds its kv heads' slice of
    every page. ``hbm_bytes`` stays the GLOBAL budget, as in the JAX
    package; ``device_bytes`` is one rank's share. The page moves act on
    each rank's local slice (the engine replays them on every rank), so
    a spill holds this rank's heads only.

    The page-move helpers (``copy_pages`` for copy-on-write,
    ``gather_pages`` / ``scatter_pages`` for preemption spill/restore)
    are in-place ``index_select`` / ``index_copy_`` on the page axis —
    the ENGINE serializes them with live steps under its step mutex,
    the same discipline ``warm()`` follows. A bfloat16 pool spills its
    raw bits as int16 arrays (numpy has no bfloat16).
    """

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 *, page_size: int, num_pages: int, dtype=None,
                 label: Optional[str] = None, prefix_cache: bool = False,
                 allocator: Optional[PageAllocator] = None,
                 mesh=None, shard_spec=None, device=None):
        import torch

        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        # a speculative DRAFT pool MIRRORS its target's page geometry:
        # pass the target's allocator and the two pools share one set of
        # page ids and tables — one reservation, one free, one set of
        # occupancy gauges; only the per-page payload shape
        # (layers/heads/dim) differs
        if allocator is not None:
            if (allocator.num_pages != int(num_pages)
                    or allocator.page_size != int(page_size)):
                raise ValueError(
                    f"shared allocator geometry "
                    f"({allocator.num_pages}x{allocator.page_size}) != "
                    f"pool geometry ({num_pages}x{page_size})")
            self.allocator = allocator
        else:
            self.allocator = PageAllocator(num_pages, page_size,
                                           label=label,
                                           prefix_cache=prefix_cache)
        self.dtype = torch.float32 if dtype is None else dtype
        shape = (self.num_layers, int(num_pages), int(page_size),
                 self.num_kv_heads, self.head_dim)
        self.mesh = None
        self.placements = None
        if mesh is not None and shard_spec is not None:
            from torch.distributed.tensor import DTensor

            from ..parallel.api import spec_to_placements

            self.mesh = mesh
            self.placements = spec_to_placements(
                shard_spec, tuple(mesh.mesh_dim_names))
            local = _local_shape(shape, mesh, self.placements)
            self.k, self.v = (
                DTensor.from_local(
                    torch.zeros(local, dtype=self.dtype, device=device),
                    mesh, self.placements, run_check=False,
                    shape=torch.Size(shape),
                    stride=torch.empty(shape, device="meta").stride())
                for _ in range(2))
        else:
            self.k = torch.zeros(shape, dtype=self.dtype, device=device)
            self.v = torch.zeros(shape, dtype=self.dtype, device=device)

    @property
    def page_size(self) -> int:
        return self.allocator.page_size

    @property
    def num_pages(self) -> int:
        return self.allocator.num_pages

    @property
    def hbm_bytes(self) -> int:
        """The preallocated KV budget over every device: fixed at
        construction."""
        return 2 * self.k.numel() * self.k.element_size()

    @property
    def device_bytes(self) -> int:
        """One device's share of ``hbm_bytes`` (all of it unsharded)."""
        return 2 * self._local(self.k).numel() * self.k.element_size()

    def local_pools(self):
        """This rank's (K, V) tensors: the local kv-head slices of a
        sharded pool, else the pools themselves."""
        return self._local(self.k), self._local(self.v)

    def _local(self, t):
        return t.to_local() if self.mesh is not None else t

    def rebind(self, k, v):
        """Adopt the pools a decode step returned. Shape-checked: the
        whole point is that the footprint NEVER changes."""
        if tuple(k.shape) != tuple(self.k.shape) or \
                tuple(v.shape) != tuple(self.v.shape):
            raise ValueError(
                f"decode step changed the pool shape: "
                f"{tuple(self.k.shape)} -> {tuple(k.shape)}")
        self.k = k
        self.v = v

    def _index(self, pages: Sequence[int]):
        import torch

        return torch.as_tensor(np.asarray(list(pages), np.int64),
                               device=self._local(self.k).device)

    def copy_pages(self, pairs: Sequence[Tuple[int, int]]):
        """Copy-on-write: duplicate page contents src -> dst, in place
        (whole pages: the mapper trusts only the published token offsets
        and overwrites the rest itself). ``index_select`` materializes
        the sources before ``index_copy_`` writes, so a pair whose dst
        is another pair's src cannot read a half-written page. Caller
        holds the engine's step mutex."""
        if not pairs:
            return
        if self.k is None:
            raise ServingError("KV pools released — engine retired")
        src = self._index([p[0] for p in pairs])
        dst = self._index([p[1] for p in pairs])
        for t in self.local_pools():
            t.index_copy_(1, dst, t.index_select(1, src))

    def gather_pages(self, pages: Sequence[int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Read page contents to host (preemption spill): bitwise
        copies of ``[layers, len(pages), page_size, heads, dim]`` (this
        rank's heads of a sharded pool; int16 bits of a bfloat16 one)."""
        import torch

        if self.k is None:
            raise ServingError("KV pools released — engine retired")
        idx = self._index(pages)
        out = []
        for t in self.local_pools():
            g = t.index_select(1, idx).cpu()
            if g.dtype == torch.bfloat16:
                g = g.view(torch.int16)
            out.append(g.numpy())
        return out[0], out[1]

    def scatter_pages(self, pages: Sequence[int], k: np.ndarray,
                      v: np.ndarray):
        """Write spilled page contents back (preemption restore) —
        the bitwise inverse of ``gather_pages``, into a possibly
        DIFFERENT set of physical pages (the table rebinds; content,
        not placement, is what round-trips). In place."""
        import torch

        if self.k is None:
            raise ServingError("KV pools released — engine retired")
        idx = self._index(pages)
        if k.shape[1] != idx.shape[0]:
            raise ServingError(
                f"spill restore shape mismatch: {k.shape[1]} spilled "
                f"pages vs {idx.shape[0]} target pages")
        for t, a in zip(self.local_pools(), (k, v)):
            src = torch.from_numpy(np.asarray(a))
            if t.dtype == torch.bfloat16 and src.dtype == torch.int16:
                src = src.view(torch.bfloat16)
            t.index_copy_(1, idx, src.to(t.device, t.dtype))

    def table_array(self, seq_ids: Sequence[int], width: int,
                    rows: Optional[int] = None) -> np.ndarray:
        """Stacked page tables for a decode batch: ``[rows, width]``
        int32, dead rows (beyond ``seq_ids``) all-garbage."""
        n = len(seq_ids) if rows is None else int(rows)
        return self.allocator.table_rows(seq_ids, width, n)

    def release(self):
        """Drop the device pools (engine retirement) so device memory
        frees, and zero the allocator's gauges so the dead pool stops
        reporting."""
        self.k = None
        self.v = None
        self.allocator.retire()


def _local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    """One rank's slice of ``shape`` under ``placements`` (each sharded
    dim divides evenly: the engine checks it first)."""
    out = list(shape)
    for size, p in zip(mesh.shape, placements):
        dim = getattr(p, "dim", None)
        if dim is not None:
            if out[dim] % int(size):
                raise ValueError(f"pool dim {dim} ({shape[dim]}) does not "
                                 f"divide over {int(size)} devices")
            out[dim] //= int(size)
    return tuple(out)
