"""Paged KV cache for the continuous-batching server — counterpart of
`repro.launch.kv_cache`.

Every full-attention layer stores KV in a shared `(num_pages, page_size,
Hk, dh)` pool; a host-side `PageTable` maps each slot to the ordered list
of physical pages backing its token range. The `PageTable` bookkeeping
(refcounts, free list, prefix-share index) is host numpy and is copied
verbatim from the reference (tests/test_torch_kv_cache.py holds the two to
the same state under random traces); the device-side `scatter_prefill` is
torch.
Physical page 0 is reserved scratch: unassigned table entries point at it,
so inactive slots' decode writes land there and reads from it are masked.
The server of this port uses admission, extension and retirement; prefix
sharing, copy-on-write and swap are not wired into it yet.
"""
from __future__ import annotations

import numpy as np
import torch

NULL_PAGE = 0   # reserved scratch page: garbage writes land here, reads are masked
_ROOT = -1      # share-index chain parent of every prompt's first page

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_MASK64 = (1 << 64) - 1


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold n_tokens."""
    return -(-int(n_tokens) // page_size)


def prefix_keys(tokens, page_size: int, *,
                namespace: bytes = b"") -> list[tuple[int, int, bytes]]:
    """Content keys for prefix sharing, one per page.

    Key for page i is `(covered, fnv64(prefix), own_page_bytes)` with
    `covered = min((i+1)*page_size, len(tokens))` — a rolling FNV-1a chain
    over the *whole* prefix `tokens[0:covered]` (the page's KV depends on
    everything before it, so the hash must too), plus the verbatim bytes of
    the page's OWN tokens only. The exact covered length means a page
    holding k prompt tokens only matches a request whose prompt covers
    exactly those k tokens (a longer prompt that merely starts the same gets
    a different key for its partial page).

    Exactness without O(n²) key material: the share index composes each key
    with the *parent physical page* of the preceding prefix page
    (vLLM-style block chaining). By induction, an index hit therefore proves
    the full prefix matches verbatim — parent identity pins tokens[0:i*P]
    exactly, own bytes pin the rest — so a 64-bit hash collision between
    different prompts can never alias one request's KV pages into another's.
    Total key material per prompt is O(n) and the chain hash is just a fast
    prefilter that makes unequal tuples fail comparison early.

    `namespace` (multi-tenant serving): a model-id byte string absorbed into
    the rolling-hash root AND prepended to every key's verbatim bytes. KV is
    a function of (weights, tokens), so two models must never alias a page
    even for identical token streams — namespacing makes their key spaces
    disjoint at both the hash prefilter and the exact-bytes comparison.
    """
    keys: list[tuple[int, int, bytes]] = []
    h = _FNV_OFFSET
    for b in bytes(namespace):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    toks = np.ascontiguousarray(np.asarray(tokens, np.int64))
    for i in range(toks.shape[0]):
        h = ((h ^ (int(toks[i]) & _MASK64)) * _FNV_PRIME) & _MASK64
        if (i + 1) % page_size == 0 or i + 1 == toks.shape[0]:
            start = (i // page_size) * page_size
            keys.append((i + 1, h,
                         bytes(namespace) + toks[start: i + 1].tobytes()))
    return keys


class PageTable:
    """Host-side block-pool allocator: per-slot ordered page lists, page
    refcounts, and a prefix-hash share index.

    Everything here is host numpy/dicts — refcounts, the free list, the hash
    index, and swap bookkeeping never live on device. The server copies
    `table`, a dense (slots, max_pages) int32 array, to the device once per
    decode tick.
    """

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 max_pages_per_slot: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        if page_size < 1 or max_pages_per_slot < 1:
            raise ValueError("page_size and max_pages_per_slot must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.max_pages = int(max_pages_per_slot)
        # LIFO free list: retired pages are reused first (cache-friendly)
        self._free = list(range(self.num_pages - 1, 0, -1))
        self.table = np.full((self.slots, self.max_pages), NULL_PAGE, np.int32)
        self.held = np.zeros(self.slots, np.int32)     # pages mapped per slot
        self.tokens = np.zeros(self.slots, np.int32)   # tokens covered per slot
        self.active = np.zeros(self.slots, bool)
        self.refcount = np.zeros(self.num_pages, np.int32)
        self._index: dict = {}      # prefix key -> physical page
        self._page_key: dict = {}   # physical page -> prefix key (reverse)

    # -- queries ---------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    def stats(self) -> dict:
        """Pool occupancy over *usable* pages: page 0 is reserved scratch
        (never allocatable) and inert phys-slot padding rows never map pages,
        so neither is real demand — `occupancy` is live/(num_pages-1), which
        is what a utilization column should report (the raw num_pages
        denominator understated pressure by the scratch page and the old
        peak-vs-num_pages bench column overstated headroom)."""
        usable = self.usable_pages
        live = usable - self.free_pages
        return {"usable_pages": usable, "free_pages": self.free_pages,
                "live_pages": live,
                "occupancy": live / usable if usable else 0.0}

    def can_admit(self, n_tokens: int, *, reclaimable: int = 0) -> bool:
        """Whether n_tokens' pages fit the free list. `reclaimable` counts
        pages held by lower-priority *preemptable* running requests — the
        server passes it when `--preempt` is on, so admission stops rejecting
        work the scheduler could make room for by swapping a victim out. It
        may overcount (a victim's shared pages survive its preemption), so
        callers must still verify the free list after actually preempting."""
        return self.free_pages + int(reclaimable) >= pages_for(n_tokens,
                                                               self.page_size)

    def lookup_keys(self, keys) -> list:
        """Share-index probe: physical page per key, or None on a miss.

        Keys compose with the PARENT physical page of the preceding prefix
        page (`_ROOT` for page 0), so a hit proves the whole prefix chain
        matches — see `prefix_keys`. A broken chain cannot resume: sharing
        is prefix-closed (every owner of page i also maps page i-1, so a
        live indexed page always has a live parent)."""
        out: list = []
        parent = _ROOT
        for k in keys:
            hit = self._index.get((parent, k))
            out.append(hit)
            if hit is None:
                out.extend([None] * (len(keys) - len(out)))
                break
            parent = hit
        return out

    def slot_pages(self, slot: int) -> np.ndarray:
        return self.table[slot, : self.held[slot]].copy()

    def cow_pending(self, slot: int, token_pos: int,
                    extra_shared=frozenset()) -> bool:
        """True iff writing `token_pos` for `slot` would land in a page the
        slot shares (refcount > 1) — i.e. `fork_cow` will need one free page
        before the decode write. `extra_shared` lets admission ask the
        hypothetical "...or would share, if these pages gain a co-owner"
        (the server's fork-debt reservation), so the write-page rule lives
        in exactly one place."""
        idx = int(token_pos) // self.page_size
        if not self.active[slot] or idx >= int(self.held[slot]):
            return False
        pid = int(self.table[slot, idx])
        return int(self.refcount[pid]) > 1 or pid in extra_shared

    # -- mutations -------------------------------------------------------------

    def _take_page(self) -> int:
        if not self._free:
            raise RuntimeError("page pool exhausted: want 1, free 0")
        p = self._free.pop()
        self.refcount[p] = 1
        return p

    def _alloc(self, slot: int, n_pages: int) -> list[int]:
        if n_pages > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n_pages}, free {len(self._free)}")
        got = [self._take_page() for _ in range(n_pages)]
        h = int(self.held[slot])
        self.table[slot, h: h + n_pages] = got
        self.held[slot] = h + n_pages
        return got

    def _map_page(self, slot: int, page: int):
        """Map an existing (indexed) page into the slot: one more reference."""
        h = int(self.held[slot])
        self.table[slot, h] = page
        self.held[slot] = h + 1
        self.refcount[page] += 1

    def _register_key(self, parent, key, page: int):
        """Register `page` in the share index under `(parent, key)`. The
        single write point for index entries — cache_tiers.TieredPageTable
        overrides it to record the page's namespace and verbatim prefix
        chain (its content address in the host/disk tiers)."""
        self._index[(parent, key)] = page
        self._page_key[page] = (parent, key)

    def _drop_page(self, page: int) -> bool:
        """Drop one reference; free the page iff the count hits zero (and
        evict its share-index entry — a free page must never be findable)."""
        self.refcount[page] -= 1
        if self.refcount[page] > 0:
            return False
        key = self._page_key.pop(page, None)
        if key is not None:
            self._index.pop(key, None)
        self._free.append(int(page))
        return True

    def _check_admit(self, slot: int, n_tokens: int):
        if self.active[slot]:
            raise RuntimeError(f"slot {slot} already active")
        if n_tokens < 1 or n_tokens > self.max_pages * self.page_size:
            raise ValueError(
                f"n_tokens={n_tokens} outside (0, {self.max_pages * self.page_size}]")

    def admit(self, slot: int, n_tokens: int) -> np.ndarray:
        """Claim `slot` and allocate private pages covering n_tokens.
        Returns the slot's page list."""
        self._check_admit(slot, n_tokens)
        if not self.can_admit(n_tokens):
            raise RuntimeError(
                f"page pool exhausted: want {pages_for(n_tokens, self.page_size)},"
                f" free {self.free_pages}")
        self.active[slot] = True
        self._alloc(slot, pages_for(n_tokens, self.page_size))
        self.tokens[slot] = n_tokens
        return self.slot_pages(slot)

    def admit_shared(self, slot: int, n_tokens: int, keys, *,
                     defer_index: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Claim `slot`, mapping share-index hits and allocating the misses.

        `keys` is one `prefix_keys` entry per page (must be distinct — the
        rolling chain guarantees it for real prompts). Returns
        `(page_ids, shared)` where `shared[i]` marks pages mapped from the
        index — the caller must NOT scatter prefill KV into those (their
        bytes already hold the shared prefix, and may hold a co-owner's live
        decode tokens past the key's coverage). Newly allocated pages are
        registered under their key for future admissions to hit — unless
        `defer_index` is set: chunked prefill writes page bytes chunk by
        chunk AFTER admission, and an indexed page must never be mappable
        before its bytes exist, so the server registers progressively via
        `index_pages` as chunks land instead.
        """
        need = pages_for(n_tokens, self.page_size)
        if len(keys) != need:
            raise ValueError(f"need {need} keys, got {len(keys)}")
        self._check_admit(slot, n_tokens)
        hits = self.lookup_keys(keys)
        misses = sum(1 for p in hits if p is None)
        if self.free_pages < misses:
            raise RuntimeError(
                f"page pool exhausted: want {misses}, free {self.free_pages}")
        self.active[slot] = True
        shared = np.zeros(need, bool)
        parent = _ROOT
        for i, (key, hit) in enumerate(zip(keys, hits)):
            if hit is not None:
                self._map_page(slot, hit)
                shared[i] = True
                parent = hit
            else:
                (page,) = self._alloc(slot, 1)
                if not defer_index:
                    self._register_key(parent, key, page)
                parent = page
        self.tokens[slot] = n_tokens
        return self.slot_pages(slot), shared

    def index_pages(self, slot: int, keys, covered: int):
        """Deferred share-index registration (pairs with
        `admit_shared(defer_index=True)`): register the slot's leading pages
        whose key coverage lies within `covered` prompt tokens — i.e. whose
        bytes the chunked prefill has now written. Idempotent: call after
        every chunk with the growing `covered`; already-registered pages
        (including shared hits mapped at admission) just advance the chain
        parent. The final partial page's key covers the whole prompt, so it
        registers only once the prefill completes — exactly when its bytes
        match what the key promises.

        If another slot won a registration race for the same (parent, key)
        (two identical prompts admitted concurrently past the server's
        deferral heuristic), this slot's duplicate page stays private and
        registration stops — entries chained past an unregistered page would
        be unreachable by `lookup_keys` anyway."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} not active")
        parent = _ROOT
        for i, key in enumerate(keys):
            if i >= int(self.held[slot]) or key[0] > int(covered):
                break
            page = int(self.table[slot, i])
            have = self._page_key.get(page)
            if have is None:
                if (parent, key) in self._index:
                    break                      # lost the race: stay private
                self._register_key(parent, key, page)
            parent = page

    def extend(self, slot: int, n_tokens: int) -> list[int]:
        """Grow slot coverage to n_tokens; returns newly allocated (private,
        unindexed) pages — decode growth is per-request, never shared."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} not active")
        if n_tokens > self.max_pages * self.page_size:
            raise ValueError(f"n_tokens={n_tokens} exceeds slot capacity")
        if n_tokens <= self.tokens[slot]:
            return []
        need = pages_for(n_tokens, self.page_size) - int(self.held[slot])
        got = self._alloc(slot, need) if need > 0 else []
        self.tokens[slot] = n_tokens
        return got

    def fork_cow(self, slot: int, token_pos: int) -> tuple[int, int] | None:
        """Copy-on-write fork before `slot` writes `token_pos`.

        If the page backing token_pos is shared (refcount > 1), allocate a
        fresh page, remap the slot's table entry to it, drop one reference on
        the source, and return `(src, dst)` — the caller MUST copy the page
        bytes device-side (`copy_page`) before the decode write runs. Returns
        None when the page is exclusively owned (write in place; a solely
        owned indexed page may grow decode bytes past its key's coverage —
        safe, because a future sharer's validity mask only reaches tokens it
        wrote or the keyed prefix, and it overwrites-before-read beyond it).
        The fork is never indexed: it diverges immediately.
        """
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} not active")
        idx = int(token_pos) // self.page_size
        if idx >= int(self.held[slot]):
            return None                      # next write opens a fresh page
        src = int(self.table[slot, idx])
        if self.refcount[src] <= 1:
            return None
        dst = self._take_page()
        self.table[slot, idx] = dst
        self.refcount[src] -= 1              # never hits 0 here (was > 1)
        return src, dst

    def _release(self, slot: int) -> list[int]:
        freed = [int(p) for p in self.table[slot, : self.held[slot]]
                 if self._drop_page(p)]
        self.table[slot] = NULL_PAGE
        self.held[slot] = 0
        self.tokens[slot] = 0
        self.active[slot] = False
        return freed

    def retire(self, slot: int) -> list[int]:
        """Release the slot; pages whose refcount hits zero return to the
        free list (shared pages survive for their co-owners)."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} not active")
        return self._release(slot)

    def swap_out(self, slot: int) -> list[int]:
        """Preemption: release the slot's mapping (same page accounting as
        retire). The caller must gather the slot's page bytes to the host
        slab BEFORE calling this — the freed pages are immediately reusable."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} not active")
        return self._release(slot)

    def swap_in(self, slot: int, n_tokens: int) -> np.ndarray:
        """Resume a preempted request: allocate fresh private pages covering
        its saved n_tokens (the caller scatters the host slab back into
        them). Swapped-in pages are not re-registered in the share index —
        the request's decode tail has already diverged from any prefix key."""
        return self.admit(slot, n_tokens)


# ---------------------------------------------------------------------------
# cache helper: prefill scatter
# ---------------------------------------------------------------------------

def scatter_prefill(cache, req_cache, page_ids, page_size: int):
    """Write one request's prefill cache (batch 1) into the paged pools, in
    place: each layer's contiguous KV is chopped into page_size chunks and
    scattered to the physical pages `page_ids` (NULL_PAGE entries receive
    the request's right-padding, which is fine — page 0 is scratch).

    Every ported layer is full attention, whose KV lives in the pool, so
    there is no slab leaf to copy and no paged-leaf mask to consult (the
    reference derives one for window rings and recurrent state)."""
    ids = torch.as_tensor(np.asarray(page_ids, np.int64), device=cache[0]["k"].device)
    n = ids.shape[0]
    for layer, req in zip(cache, req_cache):
        for name, pool in layer.items():
            body = req[name][0, : n * page_size].to(pool.dtype)
            pool[ids] = body.reshape(n, page_size, *body.shape[1:])
    return cache
