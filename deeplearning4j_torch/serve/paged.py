"""Paged KV-cache block management for the continuous batcher —
counterpart of ``deeplearning4j_tpu/serve/paged.py`` (the port's own copy:
it imports nothing of the JAX package).

KV memory is carved into fixed-size token blocks in one shared pool per
attention layer (vLLM's PagedAttention scheme):

- ``k_pool`` / ``v_pool``: ``(num_blocks, block_size, Hkv, hd)`` tensors on
  the model's device, written in place by every decode tick and prefill
  chunk;
- a per-slot block table ``(slots, max_blocks)`` mapping logical block
  ``p // block_size`` to a physical block, a tensor operand of the decode
  step, so growing or retiring a sequence never changes a shape;
- physical block 0 is the trash block: unallocated table entries point at
  it, so the fixed-shape decode step writes every slot every tick
  (inactive slots scribble on trash) and right-padded prefill garbage
  lands there too. Nothing ever reads block 0 unmasked.

Device memory is then proportional to allocated blocks, and per-request
capacity is a logical limit. Every live block carries a refcount, so one
physical block can back the same prefix in many slots: the
:class:`PrefixCache` maps ``(params generation, rolling sha256 of
whole-block token runs)`` to physical blocks, and a slot that must write a
block someone else still references copies it first (copy-on-write; the
batcher does the copy). Everything here is host-side bookkeeping; the
layout contract lives beside ``cache_append`` / ``cache_read`` in
``nn/generation.py``.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..nn.generation import cache_spec
from .errors import CapacityError

TRASH_BLOCK = 0  # physical block 0 is never allocated; see module docstring


class BlockAllocator:
    """Refcounted free-list allocator over physical block ids
    ``1..num_blocks-1``.

    ``alloc`` hands out blocks at refcount 1; ``retain`` adds a reference
    (prefix adoption, forks); ``release`` drops one and returns the block
    to the free list when the count hits zero. LIFO reuse (a freed block
    is the next handed out) keeps the working set compact. Releasing a
    free block (double release) or the trash block stays a hard error —
    a refcount bug here is silent KV corruption, never something to limp
    past. Pure host-side and NOT thread-safe by itself — the batcher
    serializes calls under its own lock.
    """

    def __init__(self, num_blocks: int,
                 reclaimer: Optional[Callable[[int], int]] = None):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 usable + trash), "
                             f"got {num_blocks}")
        self.num_blocks = int(num_blocks)
        # LIFO: low ids at the tail so fresh pools fill from block 1 up
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        # last-ditch supply: asked to make `n` more blocks reclaimable
        # before alloc gives up (the prefix cache's LRU plugs in here, so
        # cached-but-unreferenced runs are reclaimed before anyone sheds)
        self._reclaimer = reclaimer

    def set_reclaimer(self, fn: Optional[Callable[[int], int]]) -> None:
        self._reclaimer = fn

    @property
    def usable(self) -> int:
        """Total allocatable blocks (excludes the trash block)."""
        return self.num_blocks - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return len(self._refs)

    def refcount(self, block: int) -> int:
        """Current references on ``block`` (0 == free)."""
        return self._refs.get(int(block), 0)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks at refcount 1 or raise :class:`CapacityError`
        (taking none).

        Callers gate admission on worst-case commitment, so exhaustion here
        means a bookkeeping bug — but it stays a *typed* failure either way.
        A registered reclaimer (prefix-cache LRU) is asked to free the
        shortfall first, so cached-but-idle blocks never starve live work.
        """
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free) and self._reclaimer is not None:
            self._reclaimer(n - len(self._free))
        if n > len(self._free):
            raise CapacityError(
                f"KV block pool exhausted: need {n}, {len(self._free)} of "
                f"{self.usable} free")
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._refs[b] = 1
        return ids

    def retain(self, ids) -> None:
        """Add one reference to each live block (sharing a prefix/fork)."""
        for b in ids:
            b = int(b)
            if b == TRASH_BLOCK:
                raise ValueError("attempted to retain the trash block")
            if b not in self._refs:
                raise ValueError(f"retain of free block {b}")
            self._refs[b] += 1

    def release(self, ids) -> None:
        """Drop one reference per block; a block hitting zero goes back to
        the free list. Double release stays a hard error."""
        for b in ids:
            b = int(b)
            if b == TRASH_BLOCK:
                raise ValueError("attempted to release the trash block")
            c = self._refs.get(b)
            if c is None:
                raise ValueError(f"double free of block {b}")
            if c == 1:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = c - 1

    def free(self, ids) -> None:
        """Alias of :meth:`release` (the pre-refcount name)."""
        self.release(ids)


def build_pools(model, num_blocks: int, block_size: int, dtype) -> Dict:
    """Zero-filled per-attention-layer block pools on the model's device:
    ``{layer_key: {"k": (N, bs, Hkv, hd), "v": ...}}``."""
    spec = cache_spec(model)
    if not spec:
        raise ValueError("model has no attention layers to page")
    return {lk: {"k": torch.zeros((num_blocks, block_size, hkv, hd),
                                  dtype=dtype, device=model.device),
                 "v": torch.zeros((num_blocks, block_size, hkv, hd),
                                  dtype=dtype, device=model.device)}
            for lk, hkv, hd in spec}


def block_bytes(model, block_size: int, dtype) -> int:
    """Bytes of KV one block holds across ALL attention layers (k + v) —
    the unit the live-KV-bytes gauge counts in. ``dtype``: a torch or
    numpy dtype."""
    itemsize = (dtype.itemsize if isinstance(dtype, torch.dtype)
                else np.dtype(dtype).itemsize)
    return sum(2 * block_size * hkv * hd * itemsize
               for _, hkv, hd in cache_spec(model))


def blocks_needed(tokens: int, block_size: int) -> int:
    """Blocks covering ``tokens`` positions (ceil division)."""
    return -(-int(tokens) // int(block_size))


def prefix_hashes(tokens, block_size: int) -> List[bytes]:
    """Rolling sha256 over whole-block token runs.

    ``hashes[i]`` commits to tokens ``[0, (i+1)*block_size)`` — the entire
    run, not just block ``i`` — so two prompts share a cache entry only
    when every block before it matches too. Partial tail tokens are never
    hashed: only whole blocks are shareable.
    """
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: List[bytes] = []
    h = hashlib.sha256()
    for i in range(toks.shape[0] // int(block_size)):
        h.update(toks[i * block_size:(i + 1) * block_size].tobytes())
        out.append(h.digest())
    return out


class PrefixCache:
    """LRU of cached whole-block prefix runs, keyed on
    ``(params generation, rolling block-run sha256)``.

    The cache holds exactly ONE allocator reference per cached block, so a
    cached block survives its writer's retirement but is reclaimable the
    moment no slot references it. ``match`` finds the longest cached run
    for a prompt (pure lookup, no side effects — admission gates on the
    result before committing); ``adopt`` takes the references. A
    generation flip invalidates wholesale: stale-params KV can never be
    adopted, because every entry of the old generation is released before
    the first new-generation lookup returns.

    Not thread-safe by itself — the batcher serializes calls under its
    own lock, same as :class:`BlockAllocator`.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int,
                 max_blocks: Optional[int] = None):
        self._alloc = allocator
        self.block_size = int(block_size)
        # hard size bound (entries == blocks); None = bounded only by the
        # pool via the allocator's reclaimer
        self.max_blocks = int(max_blocks) if max_blocks is not None else None
        self.generation: Optional[int] = None
        self._runs: "OrderedDict[bytes, int]" = OrderedDict()
        self.evictions = 0
        self.flushes = 0

    def __len__(self) -> int:
        return len(self._runs)

    def blocks(self) -> List[int]:
        """Cached physical block ids (diagnostics/tests)."""
        return list(self._runs.values())

    def _ensure_generation(self, generation: int) -> None:
        if generation != self.generation:
            if self._runs:
                self.flush()
            self.generation = generation

    def flush(self) -> int:
        """Drop every entry, releasing the cache's references. Returns the
        number of entries released."""
        n = len(self._runs)
        if n:
            self._alloc.release(list(self._runs.values()))
            self._runs.clear()
            self.flushes += 1
        return n

    def match(self, hashes: Sequence[bytes], generation: int,
              limit: int) -> List[int]:
        """Longest cached run of full blocks from the start of the prompt
        (<= ``limit`` blocks), as physical ids. NO references are taken
        and no LRU state moves — call :meth:`adopt` once admission commits."""
        self._ensure_generation(generation)
        run: List[int] = []
        for h in hashes[:max(0, int(limit))]:
            b = self._runs.get(h)
            if b is None:
                break
            run.append(b)
        return run

    def adopt(self, hashes: Sequence[bytes], run: List[int]) -> None:
        """Take one reference per matched block and mark the run
        recently-used. ``run`` must be a fresh :meth:`match` result under
        the same lock."""
        if not run:
            return
        self._alloc.retain(run)
        for h in hashes[:len(run)]:
            self._runs.move_to_end(h)

    def insert(self, hashes: Sequence[bytes], blocks: Sequence[int],
               generation: int) -> int:
        """Cache a slot's full prompt blocks (the cache takes its own
        reference per newly inserted block). Entries already present keep
        their existing physical block — the newcomer's copy stays private
        and retires with its slot. Returns the number inserted."""
        self._ensure_generation(generation)
        ins = 0
        for h, b in zip(hashes, blocks):
            if h in self._runs:
                self._runs.move_to_end(h)
                continue
            if self.max_blocks is not None \
                    and len(self._runs) >= self.max_blocks \
                    and not self._evict_lru():
                break
            self._alloc.retain([b])
            self._runs[h] = b
            ins += 1
        return ins

    def _evict_lru(self) -> bool:
        """Drop the least-recently-used entry (size bound), releasing the
        cache's reference — the block itself is freed only if no slot
        still references it."""
        if not self._runs:
            return False
        _, b = self._runs.popitem(last=False)
        self._alloc.release([b])
        self.evictions += 1
        return True

    def reclaim(self, need: int) -> int:
        """Capacity pressure: free up to ``need`` blocks by evicting LRU
        entries whose ONLY reference is the cache (those actually return
        to the free list). Entries still adopted by live slots are left
        alone — evicting them would free nothing. This is the allocator's
        reclaimer hook, so idle cached runs are always reclaimed before
        any request sheds."""
        freed = 0
        if need <= 0:
            return 0
        for h in list(self._runs.keys()):
            if freed >= need:
                break
            b = self._runs[h]
            if self._alloc.refcount(b) == 1:
                del self._runs[h]
                self._alloc.release([b])
                self.evictions += 1
                freed += 1
        return freed

    def stats(self) -> dict:
        return {"entries": len(self._runs),
                "max_blocks": self.max_blocks,
                "evictions": self.evictions,
                "flushes": self.flushes,
                "generation": self.generation}


class SlotPages:
    """One slot's view of the pool: its blocks, in logical order, plus
    which of them are *shared* (held via ``retain`` — adopted prefix runs
    or fork parents' blocks — rather than privately allocated).

    ``ensure(tokens)`` grows the mapping to cover ``tokens`` positions,
    allocating lazily — so the pool's *used* count tracks live tokens, not
    requested worst cases. The batcher writes the returned new block ids
    into its host block-table row. Releasing is uniform under refcounts:
    every block drops one reference, shared blocks simply survive in
    their other holders.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self._alloc = allocator
        self.block_size = int(block_size)
        self.blocks: List[int] = []
        self.shared: set = set()  # subset of blocks held by retain, not alloc

    def adopt(self, blocks: Sequence[int]) -> None:
        """Front-load already-retained shared blocks (prefix adoption).
        Must run before any private allocation."""
        if self.blocks:
            raise ValueError("adopt() must precede any allocation")
        self.blocks = [int(b) for b in blocks]
        self.shared.update(self.blocks)

    def ensure(self, tokens: int) -> List[int]:
        """Cover ``tokens`` positions; returns the NEWLY allocated ids."""
        need = blocks_needed(tokens, self.block_size) - len(self.blocks)
        if need <= 0:
            return []
        new = self._alloc.alloc(need)
        self.blocks.extend(new)
        return new

    def swap(self, idx: int, new_block: int) -> int:
        """Copy-on-write bookkeeping: replace the block at logical index
        ``idx`` with ``new_block`` (already allocated, private), dropping
        this slot's reference on the old one. Returns the old id — the
        caller has already copied its KV device-side."""
        old = self.blocks[idx]
        self.blocks[idx] = int(new_block)
        self.shared.discard(old)
        self._alloc.release([old])
        return old

    def release(self) -> None:
        """Copy-free retirement: drop one reference on every block; fully
        private blocks go straight back to the free list."""
        if self.blocks:
            self._alloc.release(self.blocks)
            self.blocks = []
            self.shared.clear()
