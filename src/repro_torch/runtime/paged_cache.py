"""Paged KV cache plumbing: page pool, block tables, and step contexts —
torch port of ``repro.runtime.paged_cache``.

Attention KV lives in fixed-size pages of ``page_size`` token positions,
and every decode slot owns an ordered list of page ids (its *block-table
row*).  Position ``p`` of a slot lives at ``(row[p // page_size],
p % page_size)`` — the same page ids index every layer's pool, so
allocation happens once per slot, not per layer.

Layout per attention layer (see ``models.attention.init_paged_cache``)::

    k, v        (num_pages + 1, page_size, n_kv, head_dim)

The **last** page is the trash page: writes from inactive slots (and padded
prefill-chunk rows) are steered there instead of being predicated out, so
the step has no data-dependent control flow.  No block-table row references
it as a valid position, so its contents never touch logits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PrefillChunkCtx(NamedTuple):
    """Per-chunk step inputs for one slot's chunked prefill (fixed shapes).

    block_row: (P,) int32 — the slot's page ids, padded with the trash page.
    offset:    ()   int32 — global position of the chunk's first token.
    valid:     ()   int32 — real tokens in this chunk (rest is padding).
    """
    block_row: torch.Tensor
    offset: torch.Tensor
    valid: torch.Tensor


class DecodeCtx(NamedTuple):
    """Per-step inputs for the batched decode over all B slots.

    block_tables: (B, P) int32 — page ids per slot (trash-padded).
    pos:          (B,)   int32 — tokens already absorbed per slot.
    active:       (B,)   bool  — occupied decode slots.
    """
    block_tables: torch.Tensor
    pos: torch.Tensor
    active: torch.Tensor


class PagePool:
    """Deterministic host-side page allocator (lowest free id first).

    Determinism matters: the same trace produces identical per-request
    streams regardless of slot assignment order, and page ids feed the
    steps' block tables.

    With ``ranks > 1`` (the engine's data-parallel slot pool) the pool is
    partitioned into per-rank regions: rank ``r`` owns global page ids
    ``[r*(num_pages+1), r*(num_pages+1) + num_pages)`` — each rank's region
    mirrors the single-rank device layout of ``num_pages`` real pages plus
    one trash row, so rank 0's ids (and thus block tables, and thus streams)
    are those of the ``ranks=1`` pool.  Allocation is per rank
    (``alloc(n, rank=r)``); a slot's pages never cross ranks.  Per-rank
    trash rows below the last rank exist in the device layout but are
    unused — only the single global trash page is ever written."""

    def __init__(self, num_pages: int, page_size: int, ranks: int = 1):
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"need >= 1 page of >= 1 token, got "
                             f"{num_pages} x {page_size}")
        if ranks < 1:
            raise ValueError(f"need >= 1 rank, got {ranks}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.ranks = ranks
        self._stride = num_pages + 1
        # per-rank free lists, each kept sorted ascending (global ids)
        self._free = [list(range(r * self._stride,
                                 r * self._stride + num_pages))
                      for r in range(ranks)]
        self.high_water = 0

    @property
    def trash_page(self) -> int:
        """Id of the write-sink page: the last device row across all ranks
        (``num_pages`` with one rank)."""
        return self.ranks * self._stride - 1

    @property
    def total_pages(self) -> int:
        """Real (non-trash) pages across all ranks."""
        return self.ranks * self.num_pages

    @property
    def in_use(self) -> int:
        return self.total_pages - self.free_pages

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free)

    def _rank_of(self, page: int) -> int:
        rank = page // self._stride
        if not (0 <= rank < self.ranks) or \
                page % self._stride >= self.num_pages:
            raise ValueError(f"free of out-of-range page {page}")
        return rank

    def alloc(self, n: int, rank: int = 0) -> Optional[list[int]]:
        """Take the n lowest free page ids of ``rank``, or None (nothing
        taken) if that rank's region cannot satisfy the request."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if not 0 <= rank < self.ranks:
            raise ValueError(f"alloc on rank {rank} of {self.ranks}")
        free = self._free[rank]
        if n > len(free):
            return None
        pages, self._free[rank] = free[:n], free[n:]
        self.high_water = max(self.high_water, self.in_use)
        return pages

    def free_lists(self) -> list[list[int]]:
        """The per-rank free lists (copies, for snapshots)."""
        return [list(f) for f in self._free]

    def restore_free(self, lists: list[list[int]]) -> None:
        """Reinstate a snapshot's per-rank free lists (``in_use`` follows
        from them); the rank count must match."""
        if len(lists) != self.ranks:
            raise ValueError(f"snapshot has {len(lists)} rank free-lists, "
                             f"pool has {self.ranks}")
        out = []
        for r, free in enumerate(lists):
            lo = r * self._stride
            if len(set(free)) != len(free) or not all(
                    lo <= p < lo + self.num_pages for p in free):
                raise ValueError(f"invalid free list for rank {r} of "
                                 f"{self.num_pages} pages")
            out.append(sorted(int(p) for p in free))
        self._free = out

    def free(self, pages: list[int]) -> None:
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate page ids in free: {pages}")
        for p in pages:
            if p in self._free[self._rank_of(p)]:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._free[self._rank_of(p)].append(p)
        for f in self._free:
            f.sort()


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold n_tokens positions (at least one)."""
    return max(1, -(-n_tokens // page_size))
