"""Ragged / continuous batching runtime: blocked KV cache + sequence manager.

A copy of ``deepspeed_tpu/inference/ragged.py`` (pure Python, no framework
import), kept in the port so that it imports nothing of the JAX package.
Reference parity: ``inference/v2/ragged`` — ``BlockedAllocator``
(``blocked_allocator.py``), ``DSSequenceDescriptor``/``DSStateManager``
(``ragged_manager.py``). The device state is a pair of fixed-shape block
pools plus fixed-width block tables; this module is the host-side
bookkeeping over them.

Block 0 is reserved as the trash block: padded/invalid writes land there.

Prefix-aware KV reuse (vLLM/SGLang-style): blocks are ref-counted so multiple
sequences may point their tables at the same block; a chain-hash index over
FULL blocks lets ``admit_prompt`` resolve the longest cached prefix of a new
prompt to existing blocks instead of re-prefilling it; retired sequences'
indexed blocks park in a retained LRU pool (refcount 0, off the free list)
and are evicted back to the free list only under allocation pressure.
Copy-on-write (``ensure_writable``) keeps appends into a shared block safe.
``truncate`` is the inverse of ``extend`` — KV rollback for speculative
decoding. The port's engine does not turn the prefix cache or speculative
decoding on yet; the bookkeeping is carried over whole so that the slices
that do need no second copy.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class UnknownSequenceError(KeyError):
    """An operation named a uid that is not currently tracked — never
    admitted, already finished, or parked by the scheduler. One error type
    with the uid in the message, regardless of which internal structure
    would have missed first (``seqs``, slot arrays, pending-prefill map);
    subclasses ``KeyError`` so pre-existing callers keep working."""

    def __init__(self, uid):
        super().__init__(
            f"uid {uid} is not a tracked sequence (never admitted, already "
            f"finished, or parked)")
        self.uid = uid

    def __str__(self) -> str:          # KeyError.__str__ would repr-quote it
        return self.args[0]


class BlockedAllocator:
    """Ref-counted free-list allocator over a fixed pool of KV blocks
    (reference ``inference/v2/ragged/blocked_allocator.py``). Block 0 is never
    handed out — it is the trash block for masked writes.

    A block is in exactly one of three states:

    - **free**: refcount 0, on the free list — available to ``allocate``;
    - **live**: refcount >= 1 — referenced by that many sequences;
    - **retained**: refcount 0, NOT on the free list — held by the prefix
      cache's LRU pool until ``reclaim`` pushes it back to the free list.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = np.zeros((num_blocks,), np.int32)
        self._in_free = np.zeros((num_blocks,), bool)
        self._in_free[1:] = True

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def _check(self, b: int) -> None:
        if not 0 < b < self.num_blocks:
            raise ValueError(f"block {b} outside pool [1, {self.num_blocks})"
                             if b != 0 else "block 0 is reserved")

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"KV pool exhausted: want {n}, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._in_free[b] = False
            self._ref[b] = 1
        return out

    def incref(self, b: int) -> int:
        """Add a reference to a live or retained block (a retained block is
        thereby reactivated). Returns the new refcount."""
        self._check(b)
        if self._in_free[b]:
            raise ValueError(f"block {b} is free — cannot incref")
        self._ref[b] += 1
        return int(self._ref[b])

    def refcount(self, b: int) -> int:
        return int(self._ref[b])

    def release(self, b: int) -> int:
        """Drop one reference WITHOUT returning the block to the free list
        when the count hits zero — the caller decides (retain vs ``reclaim``).
        Returns the new refcount."""
        self._check(b)
        if self._in_free[b]:
            raise ValueError(f"double free of KV block {b}")
        if self._ref[b] <= 0:
            raise ValueError(f"free of unallocated KV block {b}")
        self._ref[b] -= 1
        return int(self._ref[b])

    def reclaim(self, b: int) -> None:
        """Return a RETAINED block (refcount 0, off the free list) to the
        free list — the prefix pool's eviction endpoint."""
        self._check(b)
        if self._in_free[b]:
            raise ValueError(f"double free of KV block {b}")
        if self._ref[b] != 0:
            raise ValueError(f"reclaim of live KV block {b} "
                             f"(refcount {int(self._ref[b])})")
        self._free.append(b)
        self._in_free[b] = True

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block; blocks whose count hits zero go back
        to the free list. Freeing a block twice, freeing block 0, or freeing
        a block that was never allocated raises with the block id (a silent
        append used to corrupt the free list with duplicates)."""
        for b in blocks:
            if self.release(b) == 0:
                self.reclaim(b)


class PrefixBlockIndex:
    """Block-granular prefix index: chain-hash of token chunks → block id,
    plus the LRU over retained-but-unreferenced blocks.

    Keying is by CHAIN hash — each full block's key digests its own
    ``block_size`` token ids *and* the key of the previous block — so a hit
    on block *i* proves the entire token prefix ``[0, (i+1)·block_size)``
    matches, not just block *i*'s chunk. Only full blocks are indexed
    (partial tails are never shared through the index), and only blocks
    whose KV content has actually been written are inserted."""

    def __init__(self, max_retained_blocks: int = -1):
        self.max_retained = max_retained_blocks
        self._by_hash: Dict[bytes, int] = {}
        self._hash_of: Dict[int, bytes] = {}     # canonical block → its key
        self._lru: "OrderedDict[int, None]" = OrderedDict()

    # -- hashing -------------------------------------------------------- #
    @staticmethod
    def chunk_hash(parent: bytes, chunk: Sequence[int]) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(parent)
        h.update(np.asarray(chunk, np.int32).tobytes())
        return h.digest()

    @classmethod
    def chain_hashes(cls, tokens: Sequence[int], block_size: int,
                     n_chunks: int) -> List[bytes]:
        """Chain keys for the first ``n_chunks`` full blocks of ``tokens``."""
        out: List[bytes] = []
        parent = b""
        for i in range(n_chunks):
            parent = cls.chunk_hash(parent,
                                    tokens[i * block_size:(i + 1) * block_size])
            out.append(parent)
        return out

    # -- index ---------------------------------------------------------- #
    def match(self, hashes: Sequence[bytes]) -> List[int]:
        """Blocks for the longest indexed prefix of ``hashes``."""
        blocks: List[int] = []
        for h in hashes:
            b = self._by_hash.get(h)
            if b is None:
                break
            blocks.append(b)
        return blocks

    def insert(self, block: int, h: bytes) -> bool:
        """Index ``block`` under ``h`` unless the key is already held by a
        canonical block (concurrent identical prefills keep their private
        copies; only the first becomes matchable)."""
        if h in self._by_hash:
            return False
        self._by_hash[h] = block
        self._hash_of[block] = h
        return True

    def is_indexed(self, block: int) -> bool:
        return block in self._hash_of

    def hash_of(self, block: int) -> Optional[bytes]:
        """The chain key ``block`` is indexed under (None if unindexed) —
        the host-spill path reads it BEFORE eviction drops the entry."""
        return self._hash_of.get(block)

    def drop(self, block: int) -> None:
        """Forget a block entirely (it is being freed / reallocated)."""
        h = self._hash_of.pop(block, None)
        if h is not None:
            self._by_hash.pop(h, None)
        self._lru.pop(block, None)

    # -- retained pool -------------------------------------------------- #
    @property
    def retained_blocks(self) -> int:
        return len(self._lru)

    def lru_add(self, block: int) -> None:
        self._lru[block] = None
        self._lru.move_to_end(block)

    def lru_remove(self, block: int) -> None:
        self._lru.pop(block, None)

    def pop_lru(self) -> Optional[int]:
        """Evict the least-recently-used retained block: removed from the
        index and the pool; the caller reclaims it into the free list."""
        if not self._lru:
            return None
        block, _ = self._lru.popitem(last=False)
        h = self._hash_of.pop(block, None)
        if h is not None:
            self._by_hash.pop(h, None)
        return block


@dataclasses.dataclass
class SequenceDescriptor:
    """Host-side state for one tracked sequence (reference
    ``DSSequenceDescriptor`` ``ragged_manager.py``)."""

    uid: int
    slot: int                      # decode-batch slot index
    blocks: List[int] = dataclasses.field(default_factory=list)
    seen_tokens: int = 0           # tokens already in the KV cache
    last_token: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    prefilling: bool = False       # split prefill in flight — not decodable
    # prefix-cache bookkeeping: ``tokens`` are the ids at KV positions
    # [0, seen_tokens) (prompt first, then sampled tokens as their KV is
    # written); ``block_hashes`` are chain keys for the first
    # len(block_hashes) FULL blocks
    tokens: List[int] = dataclasses.field(default_factory=list)
    block_hashes: List[bytes] = dataclasses.field(default_factory=list)


class StateManager:
    """Tracks live sequences, their slots and block tables (reference
    ``DSStateManager``). Purely host-side; device state lives in the engine.

    With ``prefix_cache=True`` it also runs the prefix-reuse protocol:
    ``admit_prompt`` resolves cached prefixes to shared blocks,
    ``ensure_writable`` copy-on-writes shared blocks before appends,
    ``mark_filled`` indexes newly-completed blocks, and ``retire`` parks
    indexed blocks in the retained LRU instead of freeing them."""

    def __init__(self, max_sequences: int, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int, prefix_cache: bool = False,
                 max_retained_blocks: int = -1):
        self.block_size = block_size
        self.max_sequences = max_sequences
        self.max_blocks_per_seq = max_blocks_per_seq
        self.allocator = BlockedAllocator(num_blocks)
        self.seqs: Dict[int, SequenceDescriptor] = {}
        self._free_slots: List[int] = list(range(max_sequences - 1, -1, -1))
        self.prefix_cache = prefix_cache
        self.index = PrefixBlockIndex(max_retained_blocks)
        self.prefix_stats: Dict[str, int] = {
            "lookups": 0, "hits": 0, "hit_tokens": 0,
            "prefill_tokens_saved": 0, "evictions": 0, "cow_copies": 0,
            "spills": 0, "restores": 0, "restored_tokens": 0}
        # host-spill tier (inference.prefix_cache.host_spill; docs/memory.md):
        # evicted unreferenced blocks copy to a HostKVPool keyed by their
        # chain hash instead of being dropped, and admit_prompt restores
        # spilled blocks on a prefix hit. Wired by the engine via
        # enable_host_spill; None → the pre-spill eviction path, unchanged.
        self.spill_pool = None
        self._spill_read = None      # block id → per-cache-leaf host copies
        self._spill_write = None     # (block id, data) → device write

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def retained_blocks(self) -> int:
        return self.index.retained_blocks

    @property
    def headroom_blocks(self) -> int:
        """Blocks an admission or decode extension could obtain right now:
        the free list plus the retained prefix pool (``_reclaim`` evicts
        retained blocks on demand, so they are allocatable capacity — the
        same accounting ``can_admit`` uses)."""
        return self.allocator.free_blocks + self.index.retained_blocks

    def lookup(self, uid: int) -> SequenceDescriptor:
        """The descriptor for ``uid``, or :class:`UnknownSequenceError` —
        the one consistent error surface for unknown/already-finished uids."""
        try:
            return self.seqs[uid]
        except KeyError:
            raise UnknownSequenceError(uid) from None

    def blocks_needed(self, prompt_len: int) -> int:
        """Blocks ``admit``/``admit_prompt`` would claim for a prompt of
        this length (prompt coverage + one pre-reserved decode block) —
        the admission-control number a scheduler budgets against."""
        return self._admit_need(prompt_len)

    def growth_blocks_short(self, descs=None, n: int = 1) -> int:
        """Shortfall (0 = safe) between the blocks the next ``n`` decode
        tokens of ``descs`` (default: every live, non-prefilling sequence)
        would claim and the current headroom. Counts both fresh tail blocks
        (``extend``) and copy-on-write allocations for shared blocks in the
        write range (``ensure_writable``) — the scheduler preempts until
        this returns 0, so a decode step can never surface a pool-exhausted
        error to a request."""
        if descs is None:
            descs = [d for d in self.seqs.values()
                     if not d.finished and not d.prefilling]
        bs = self.block_size
        need = 0
        for d in descs:
            want = d.seen_tokens + n
            need += max(0, (want + bs - 1) // bs - len(d.blocks))
            first = d.seen_tokens // bs
            last = min((want - 1) // bs, len(d.blocks) - 1)
            for i in range(first, last + 1):
                if self.allocator.refcount(d.blocks[i]) > 1:
                    need += 1          # COW copy before the write lands
        return max(0, need - self.headroom_blocks)

    def _admit_need(self, prompt_len: int) -> int:
        """Blocks for the prompt + one pre-reserved decode block, capped at
        the fixed table width (a prompt near max_seq_len already owns the
        last block — reserving past the table would overflow it)."""
        need = (prompt_len + self.block_size - 1) // self.block_size + 1
        return min(need, self.max_blocks_per_seq)

    def can_admit(self, prompt_len: int) -> bool:
        """Retained blocks count as available: eviction runs inside
        ``admit_prompt``/``extend`` before an allocation can fail, so
        admission pressure drains the prefix pool before this reports
        False (with the cache off, the retained pool is always empty and
        this is exactly the free-list check)."""
        avail = self.allocator.free_blocks + self.index.retained_blocks
        return bool(self._free_slots) and avail >= self._admit_need(prompt_len)

    def enable_host_spill(self, pool, reader, writer) -> None:
        """Arm the host-spill tier: ``pool`` is a
        :class:`~deepspeed_tpu.memory.HostKVPool`, ``reader(block)`` returns
        the block's per-cache-leaf contents (host-materializable), and
        ``writer(block, data)`` stamps spilled contents into a freshly
        allocated device block. Called by the engine when
        ``inference.prefix_cache.host_spill`` is on."""
        self.spill_pool = pool
        self._spill_read = reader
        self._spill_write = writer

    def _evict_retained(self) -> Optional[int]:
        """Evict the LRU retained block — the ONE spot every eviction path
        funnels through. With the spill tier armed, the block's KV copies to
        the host pool under its chain hash BEFORE ``pop_lru`` drops the
        index entry (read the hash first: pop_lru is the single point that
        removes it, so the entry is dropped exactly once)."""
        if self.spill_pool is not None:
            b = next(iter(self.index._lru), None)
            if b is not None:
                h = self.index.hash_of(b)
                if h is not None and h not in self.spill_pool:
                    self.spill_pool.put(h, self._spill_read(b))
                    self.prefix_stats["spills"] += 1
        return self.index.pop_lru()

    def _reclaim(self, n_needed: int) -> None:
        """Evict retained LRU blocks until ``n_needed`` are allocatable."""
        while self.allocator.free_blocks < n_needed:
            b = self._evict_retained()
            if b is None:
                break
            self.allocator.reclaim(b)
            self.prefix_stats["evictions"] += 1

    def admit(self, uid: int, prompt_len: int) -> SequenceDescriptor:
        if uid in self.seqs:
            raise ValueError(f"uid {uid} already tracked")
        if not self._free_slots:
            raise MemoryError("no free sequence slots")
        need = self._admit_need(prompt_len)
        self._reclaim(need)
        # allocate BEFORE popping the slot: a pool-exhausted MemoryError
        # must not leak a sequence slot (debug_check-pinned)
        blocks = self.allocator.allocate(need)
        desc = SequenceDescriptor(uid=uid, slot=self._free_slots.pop(),
                                  blocks=blocks)
        self.seqs[uid] = desc
        return desc

    def admit_prompt(self, uid: int,
                     prompt_tokens: Sequence[int]) -> Tuple[SequenceDescriptor, int]:
        """Admit with prefix lookup → ``(descriptor, cached_tokens)``: the
        first ``cached_tokens`` positions of the prompt are already resolved
        to shared blocks, so prefill may start there. At least one prompt
        token is always left uncached — its forward pass produces the logits
        that sample the first token (the vLLM "never hit the full prompt"
        rule), which also guarantees matched blocks are full and therefore
        never appended into at admission."""
        prompt = [int(t) for t in prompt_tokens]
        if not self.prefix_cache:
            desc = self.admit(uid, len(prompt))
            desc.tokens = prompt
            return desc, 0
        if uid in self.seqs:
            raise ValueError(f"uid {uid} already tracked")
        if not self._free_slots:
            raise MemoryError("no free sequence slots")
        bs = self.block_size
        need = self._admit_need(len(prompt))
        hashes = PrefixBlockIndex.chain_hashes(
            prompt, bs, max(0, (len(prompt) - 1) // bs))
        matched = self.index.match(hashes)
        self.prefix_stats["lookups"] += 1
        for b in matched:               # reactivate/share before any eviction
            self.allocator.incref(b)    # can evict them out from under us
            self.index.lru_remove(b)
        if self.spill_pool is not None and self._spill_write is not None:
            # extend the resident match through the host-spill tier: each
            # spilled chain hash restores into a freshly allocated device
            # block (capacity via the NORMAL eviction path — _reclaim — so
            # a full pool degrades to a miss instead of over-committing)
            # and rejoins the index as the canonical block. A restored
            # block covers a block `fresh` would otherwise allocate, so
            # total blocks claimed never exceeds the plain admission's.
            for h in hashes[len(matched):]:
                data = self.spill_pool.get(h)
                if data is None:
                    break
                self._reclaim(1)
                if self.allocator.free_blocks < 1:
                    break               # every block is live — normal miss
                blk = self.allocator.allocate(1)[0]
                self._spill_write(blk, data)
                self.index.insert(blk, h)
                self.spill_pool.pop(h)  # the device copy is canonical again
                self.spill_pool.note_restore()
                matched.append(blk)
                self.prefix_stats["restores"] += 1
                self.prefix_stats["restored_tokens"] += bs
        try:
            self._reclaim(need - len(matched))
            fresh = self.allocator.allocate(need - len(matched))
        except MemoryError:
            for b in matched:
                self._release_block(b)
            raise
        slot = self._free_slots.pop()
        desc = SequenceDescriptor(uid=uid, slot=slot, blocks=matched + fresh,
                                  tokens=prompt,
                                  block_hashes=hashes[:len(matched)])
        self.seqs[uid] = desc
        cached = len(matched) * bs
        if cached:
            self.prefix_stats["hits"] += 1
            self.prefix_stats["hit_tokens"] += cached
            self.prefix_stats["prefill_tokens_saved"] += cached
        return desc, cached

    def adopt_block(self, h: bytes) -> Optional[int]:
        """Land a foreign full block (disaggregated prefill→decode handoff)
        as a RETAINED canonical block keyed by chain hash ``h``, returning
        the device block id the caller must fill, or ``None`` when the
        adoption is refused (hash already canonical here, pool exhausted,
        or retention disabled so the orphan block would leak).

        The block rides the normal retained-landing path (allocate →
        index → release-to-zero), so the retention cap, eviction order and
        ``debug_check`` invariants all apply to imported blocks exactly as
        to locally produced ones. A later ``admit_prompt`` on the same
        token prefix then matches it as an ordinary admit-time hit."""
        if not self.prefix_cache or h in self.index._by_hash:
            return None
        self._reclaim(1)
        if self.allocator.free_blocks < 1:
            return None
        blk = self.allocator.allocate(1)[0]
        self.index.insert(blk, h)
        if self.spill_pool is not None:
            # the device copy is canonical: a stale host-spilled twin would
            # violate the "never both spilled and resident" invariant
            self.spill_pool.pop(h)
        self._release_block(blk)        # refcount 1 → 0: retained (or freed
        if not self.index.is_indexed(blk):  # when max_retained == 0)
            return None
        return blk

    def fork(self, uid: int, new_uid: int) -> SequenceDescriptor:
        """Admit ``new_uid`` sharing ALL of ``uid``'s blocks (parallel
        sampling / best-of-n). Both sequences now share the partial tail
        block; whichever appends first triggers copy-on-write."""
        parent = self.lookup(uid)
        if parent.prefilling:
            raise ValueError(f"uid {uid} is still prefilling — cannot fork")
        if new_uid in self.seqs:
            raise ValueError(f"uid {new_uid} already tracked")
        if not self._free_slots:
            raise MemoryError("no free sequence slots")
        for b in parent.blocks:
            self.allocator.incref(b)
        desc = SequenceDescriptor(
            uid=new_uid, slot=self._free_slots.pop(),
            blocks=list(parent.blocks), seen_tokens=parent.seen_tokens,
            last_token=parent.last_token, tokens=list(parent.tokens),
            block_hashes=list(parent.block_hashes))
        self.seqs[new_uid] = desc
        return desc

    def ensure_writable(self, desc: SequenceDescriptor,
                        upto_tokens: int) -> List[Tuple[int, int]]:
        """Copy-on-write guard before KV positions ``[seen_tokens,
        upto_tokens)`` are written: every EXISTING block covering that range
        that is shared (refcount > 1) is swapped for a private copy. Returns
        ``(src, dst)`` pairs — the caller must copy the device block contents
        src → dst before the write executes. Blocks `extend` will allocate
        for the tail of the range are fresh (refcount 1) and need no copy."""
        if upto_tokens <= desc.seen_tokens:
            return []
        bs = self.block_size
        first = desc.seen_tokens // bs
        last = min((upto_tokens - 1) // bs, len(desc.blocks) - 1)
        pairs: List[Tuple[int, int]] = []
        for i in range(first, last + 1):
            src = desc.blocks[i]
            if self.allocator.refcount(src) <= 1:
                continue
            self._reclaim(1)
            dst = self.allocator.allocate(1)[0]
            self.allocator.release(src)   # still >= 1 holder remains
            desc.blocks[i] = dst
            # the private copy is NOT the canonical indexed block; its chain
            # key (if any) stays with src
            pairs.append((src, dst))
            self.prefix_stats["cow_copies"] += 1
        return pairs

    def mark_filled(self, desc: SequenceDescriptor) -> None:
        """Index any blocks of ``desc`` that are now FULL and written
        (``seen_tokens`` covers them) but not yet chain-hashed — called after
        prefill chunks complete and after decode steps cross block
        boundaries. No-op with the cache off."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        n_full = min(desc.seen_tokens, len(desc.tokens)) // bs
        while len(desc.block_hashes) < n_full:
            i = len(desc.block_hashes)
            parent = desc.block_hashes[i - 1] if i else b""
            h = PrefixBlockIndex.chunk_hash(parent,
                                            desc.tokens[i * bs:(i + 1) * bs])
            desc.block_hashes.append(h)
            if self.index.insert(desc.blocks[i], h) and \
                    self.spill_pool is not None:
                # a resident block just became canonical for this prefix —
                # any host copy under the same chain hash is redundant
                self.spill_pool.pop(h)

    def truncate(self, desc: SequenceDescriptor,
                 new_len: int) -> List[Tuple[int, int]]:
        """KV rollback: un-fill positions ``[new_len, seen_tokens)`` — the
        speculative-decoding endpoint that discards rejected draft positions
        after batched verification (docs/serving.md). Host-side only: the
        device cache keeps the stale KV, but ``seen_tokens`` bounds every
        read and the positions are rewritten before they are next visible.

        - trailing blocks that no longer cover any kept position are
          released through the normal refcount protocol (shared blocks lose
          one holder, indexed blocks park in the retained LRU, the rest go
          back to the free list);
        - a now-PARTIAL tail block that is **shared** (prefix-cache match or
          ``fork``) is copied on write immediately — the rolled-back suffix
          will be rewritten, and the other holders must keep the original.
          Returns ``(src, dst)`` pairs exactly like :meth:`ensure_writable`;
          the caller must stamp the device copies before the next write;
        - a now-partial tail block that is privately owned but *indexed* is
          dropped from the prefix index: its content is about to diverge
          from its chain hash, and a future admission must not resolve to it.

        ``desc.tokens`` and ``desc.block_hashes`` are trimmed to match, so
        ``debug_check`` invariants hold immediately after the call."""
        if isinstance(desc, int):
            desc = self.lookup(desc)
        if not 0 < new_len <= desc.seen_tokens:
            raise ValueError(
                f"truncate(uid={desc.uid}): new_len {new_len} outside "
                f"(0, {desc.seen_tokens}]")
        bs = self.block_size
        n_keep = (new_len + bs - 1) // bs
        while len(desc.blocks) > n_keep:
            self._release_block(desc.blocks.pop())
        del desc.tokens[new_len:]
        desc.seen_tokens = new_len
        n_full = new_len // bs
        if len(desc.block_hashes) > n_full:
            del desc.block_hashes[n_full:]
        pairs: List[Tuple[int, int]] = []
        if new_len % bs:                 # tail block now only partially valid
            tail = desc.blocks[n_keep - 1]
            if self.allocator.refcount(tail) > 1:
                self._reclaim(1)
                dst = self.allocator.allocate(1)[0]
                self.allocator.release(tail)   # >= 1 holder remains
                desc.blocks[n_keep - 1] = dst
                pairs.append((tail, dst))
                self.prefix_stats["cow_copies"] += 1
            elif self.index.is_indexed(tail):
                self.index.drop(tail)
        return pairs

    def extend(self, desc: SequenceDescriptor, n: int = 1) -> None:
        """Ensure the block table covers ``n`` more tokens (n > 1 is the
        multi-step decode path: capacity is reserved up front so a fused
        k-step scan never needs host allocation mid-flight)."""
        need = desc.seen_tokens + n
        short = need - len(desc.blocks) * self.block_size
        if short > 0:
            blocks = (short + self.block_size - 1) // self.block_size
            self._reclaim(blocks)
            desc.blocks.extend(self.allocator.allocate(blocks))
        if len(desc.blocks) > self.max_blocks_per_seq:
            raise MemoryError(f"sequence {desc.uid} exceeds max_blocks_per_seq")

    def _release_block(self, b: int) -> None:
        """Drop one reference; a block reaching refcount 0 is RETAINED (LRU)
        if it is a canonical indexed block and retention is configured,
        otherwise freed. Over-cap retention evicts the LRU tail."""
        if self.allocator.release(b) > 0:
            return
        cap = self.index.max_retained
        if self.prefix_cache and cap != 0 and self.index.is_indexed(b):
            self.index.lru_add(b)
            while cap >= 0 and self.index.retained_blocks > cap:
                evicted = self._evict_retained()
                self.allocator.reclaim(evicted)
                self.prefix_stats["evictions"] += 1
        else:
            self.index.drop(b)
            self.allocator.reclaim(b)

    def retire(self, uid: int) -> SequenceDescriptor:
        desc = self.lookup(uid)
        del self.seqs[uid]
        if not self.prefix_cache:
            self.allocator.free(desc.blocks)
        else:
            for b in desc.blocks:
                self._release_block(b)
        self._free_slots.append(desc.slot)
        return desc

    def block_table(self, desc: SequenceDescriptor) -> np.ndarray:
        """Fixed-width table; unused entries point at the trash block 0."""
        t = np.zeros((self.max_blocks_per_seq,), np.int32)
        t[:len(desc.blocks)] = desc.blocks
        return t

    # ------------------------------------------------------------------ #
    def debug_check(self) -> None:
        """Accounting invariants (tests: randomized admit/decode/finish
        soak). Raises AssertionError on any violation."""
        alloc = self.allocator
        free = list(alloc._free)
        assert len(free) == len(set(free)), "duplicate blocks on free list"
        assert 0 not in free, "trash block on free list"
        live_refs: Dict[int, int] = {}
        for d in self.seqs.values():
            for b in d.blocks:
                live_refs[b] = live_refs.get(b, 0) + 1
        retained = set(self.index._lru)
        for b in range(1, alloc.num_blocks):
            want = live_refs.get(b, 0)
            assert alloc.refcount(b) == want, \
                f"block {b}: refcount {alloc.refcount(b)} != {want} live refs"
            states = [b in set(free), want > 0, b in retained]
            assert sum(states) == 1, \
                f"block {b} state invalid (free/live/retained = {states})"
        for b in retained:
            assert self.index.is_indexed(b), f"retained block {b} not indexed"
        if self.spill_pool is not None:
            # spill-then-evict drops the resident index entry exactly once:
            # a chain hash is resident-canonical OR host-spilled, never both
            inter = set(self.spill_pool.keys()) & set(self.index._by_hash)
            assert not inter, \
                f"{len(inter)} chain hashes both spilled and resident"
        assert len(free) + len(live_refs) + len(retained) == \
            alloc.num_blocks - 1, "free + live + retained != pool size"
        n_slots = len(self._free_slots) + len(self.seqs)
        assert n_slots == self.max_sequences, "slot accounting broken"
        bs = self.block_size
        for d in self.seqs.values():
            assert len(d.blocks) * bs >= d.seen_tokens, \
                f"uid {d.uid}: {len(d.blocks)} blocks cannot cover " \
                f"{d.seen_tokens} seen tokens"
            assert len(d.block_hashes) <= len(d.blocks), \
                f"uid {d.uid}: more block hashes than blocks"
            # hashes only ever cover FULL written-and-recorded chunks
            # (truncate trims them alongside tokens/seen_tokens)
            assert len(d.block_hashes) * bs <= max(d.seen_tokens,
                                                   len(d.tokens)), \
                f"uid {d.uid}: block hashes past the recorded tokens"
