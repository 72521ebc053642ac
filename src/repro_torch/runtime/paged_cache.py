"""Paged KV cache plumbing: page pool, block tables, and step contexts —
torch port of ``repro.runtime.paged_cache`` (one rank: no data-parallel
mesh).

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
    steps' block tables."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"need >= 1 page of >= 1 token, got "
                             f"{num_pages} x {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages))
        self.high_water = 0

    @property
    def trash_page(self) -> int:
        """Id of the write-sink page (the last device row)."""
        return self.num_pages

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        """Take the n lowest free page ids, or None (nothing taken)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages, self._free = self._free[:n], self._free[n:]
        self.high_water = max(self.high_water, self.in_use)
        return pages

    def free_list(self) -> list[int]:
        """The free page ids, in allocation order (for snapshots)."""
        return list(self._free)

    def restore_free(self, free: list[int]) -> None:
        """Reinstate a snapshot's free list (``in_use`` follows from it)."""
        if len(set(free)) != len(free) or not all(
                0 <= p < self.num_pages for p in free):
            raise ValueError(f"invalid free list for {self.num_pages} pages")
        self._free = sorted(free)

    def free(self, pages: list[int]) -> None:
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate page ids in free: {pages}")
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"free of out-of-range page {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
        self._free = sorted(self._free + list(pages))


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold n_tokens positions (at least one)."""
    return max(1, -(-n_tokens // page_size))
