"""Block/paged KV-cache management for the serving runtime.

The physical decode cache is a fixed pytree of `n_slots` per-request
cache rows (so the vmapped decode step compiles once per bucketed
(n_slots, cache_len) shape — batch composition changes never re-jit).
On top of that sits *paged accounting* in the vLLM style: KV capacity is
divided into fixed-size token blocks handed out by a free-list
allocator, every admitted request holds a block table, and admission
control is driven by block availability — so memory pressure behaves
like a real paged server even though the demo's physical layout is
slot-dense.

Invariants the tests pin down:
  * a block is owned by at most one request (`alloc` hands out each id
    once until it is freed);
  * `free` of a block not currently owned raises (double-free guard);
  * used + free == total at all times (no leaks);
  * releasing a request returns its slot AND all its blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


class OutOfBlocks(RuntimeError):
    """KV pool exhausted — the scheduler must defer admission."""


class KVCacheError(RuntimeError):
    """Allocator misuse: double-free, unknown request, foreign block."""


@dataclasses.dataclass
class BlockTable:
    """Per-request logical->physical mapping: block i holds tokens
    [i*block_size, (i+1)*block_size) of the request's context."""

    request_id: int
    block_size: int
    block_ids: List[int] = dataclasses.field(default_factory=list)
    n_tokens: int = 0

    @property
    def capacity(self) -> int:
        return len(self.block_ids) * self.block_size


class BlockAllocator:
    """Free-list allocator over `n_blocks` KV blocks."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._owner: Dict[int, int] = {}      # block id -> request id

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._owner)

    def alloc(self, n: int, request_id: int) -> List[int]:
        """Pop `n` blocks for `request_id`; all-or-nothing."""
        if n > len(self._free):
            raise OutOfBlocks(
                f"need {n} blocks, {len(self._free)} free "
                f"(of {self.n_blocks})")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._owner[b] = request_id
        return blocks

    def free(self, blocks: List[int], request_id: int) -> None:
        # validate the whole batch BEFORE mutating, so a double-free /
        # foreign-free raises with the allocator unchanged instead of
        # half the blocks already returned to the free list
        for b in blocks:
            owner = self._owner.get(b)
            if owner is None:
                raise KVCacheError(f"double free of block {b}")
            if owner != request_id:
                raise KVCacheError(
                    f"block {b} owned by request {owner}, freed by "
                    f"{request_id}")
        for b in blocks:
            del self._owner[b]
            self._free.append(b)

    def check_conservation(self) -> None:
        assert self.n_free + self.n_used == self.n_blocks, (
            self.n_free, self.n_used, self.n_blocks)


@dataclasses.dataclass
class KVStats:
    admitted: int = 0
    released: int = 0
    peak_blocks: int = 0
    peak_slots: int = 0


class KVCacheManager:
    """Decode slots + paged block accounting for one serving engine.

    `admit(request_id, n_tokens)` reserves a decode slot and enough
    blocks for the request's full context (prompt + max generated) up
    front — eager reservation means an admitted request can never be
    preempted mid-decode by memory pressure, which keeps the runtime
    loop simple (the trade-off vs vLLM-style incremental allocation is
    noted in docs/api.md). `release` recycles both.
    """

    def __init__(self, n_slots: int, n_blocks: int, block_size: int = 16):
        self.n_slots = n_slots
        self.block_size = block_size
        self.allocator = BlockAllocator(n_blocks)
        self._free_slots: List[int] = list(range(n_slots - 1, -1, -1))
        self._tables: Dict[int, BlockTable] = {}
        self._slot_of: Dict[int, int] = {}
        self.stats = KVStats()

    # -- queries ---------------------------------------------------------
    @property
    def n_free_slots(self) -> int:
        return len(self._free_slots)

    def blocks_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.block_size))

    def can_admit(self, n_tokens: int) -> bool:
        return (bool(self._free_slots)
                and self.blocks_for(n_tokens) <= self.allocator.n_free)

    @property
    def occupancy(self) -> float:
        """Fraction of KV blocks currently owned by live requests."""
        return self.allocator.n_used / max(self.allocator.n_blocks, 1)

    def table(self, request_id: int) -> BlockTable:
        return self._tables[request_id]

    def slot(self, request_id: int) -> int:
        return self._slot_of[request_id]

    # -- lifecycle -------------------------------------------------------
    def admit(self, request_id: int, n_tokens: int) -> int:
        """Reserve a slot + blocks for `n_tokens` of context; returns the
        slot index. Raises OutOfBlocks / KVCacheError when infeasible."""
        if request_id in self._tables:
            raise KVCacheError(f"request {request_id} already admitted")
        if not self._free_slots:
            raise OutOfBlocks("no free decode slot")
        n = self.blocks_for(n_tokens)
        blocks = self.allocator.alloc(n, request_id)   # may raise
        slot = self._free_slots.pop()
        self._tables[request_id] = BlockTable(
            request_id=request_id, block_size=self.block_size,
            block_ids=blocks, n_tokens=n_tokens)
        self._slot_of[request_id] = slot
        self.stats.admitted += 1
        self.stats.peak_blocks = max(self.stats.peak_blocks,
                                     self.allocator.n_used)
        self.stats.peak_slots = max(self.stats.peak_slots,
                                    self.n_slots - self.n_free_slots)
        return slot

    def release(self, request_id: int) -> int:
        """Recycle the request's slot and blocks; returns the slot."""
        tab = self._tables.pop(request_id, None)
        if tab is None:
            raise KVCacheError(f"release of unknown request {request_id}")
        self.allocator.free(tab.block_ids, request_id)
        slot = self._slot_of.pop(request_id)
        self._free_slots.append(slot)
        self.stats.released += 1
        return slot
