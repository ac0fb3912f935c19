"""KV capacity subsystem: radix prefix index + host-memory block tier
(port of ``jax_llama_tpu/kvcache.py``).

Two cooperating parts that multiply how many concurrent chat sessions
one card's pool can hold:

  * **Radix prefix index** (:class:`RadixPrefixStore`): a block-granular
    trie over token chains.  Each node is ONE full prompt block, keyed
    by the cumulative chain hash of its tokens (:func:`chain_keys`: key_j
    certifies the whole prefix up to block j), children keyed by the
    next block's hash.  An admission claims the longest shared block
    prefix across all cached chains; divergent chains share their common
    prefix nodes by construction; eviction is leaves-first; per-node
    residency (pool block / host slab / gone) is what the host tier
    hangs off.  Refcounts stay block-granular in the batcher
    (``_block_refs``): the index tracks keyed-ness, LRU order and
    residency, not ownership.
  * **Host block tier** (:class:`HostTier`).  Cold (refcount-0,
    LRU-expired) blocks evict INTO a bounded host-memory pool instead of
    being freed: eviction copies the block's KV (plus scales on int8
    pools, plus the draft pool's twin under speculative serving) into
    pinned host tensors (:func:`fetch_slab`), and the radix node flips
    pool-resident -> host-resident, staying matchable.  Admission of a
    session whose prefix blocks were demoted starts an asynchronous
    swap-in (:func:`stage_restore`): the slabs copy into staging tensors
    on a side CUDA stream the batcher owns, deliberately NOT on the
    pool's stream, so decode chunks dispatched meanwhile never wait on
    the copy; the request parks in the batcher's ``restoring`` state,
    and once the copy's event has passed (:func:`restore_ready`, a
    non-blocking ``Event.query()`` at step boundaries) ONE scatter on the
    main stream (:func:`adopt_into_pool`) lands the blocks in the pool
    and the session admits as a plain prefix hit.

Three index modes (``run.py --prefix-index``): ``radix`` (the default:
partial-prefix sharing + host tier), ``exact`` (the legacy flat chain
map, kept as the behavioural oracle; no host tier), ``off`` (no prefix
matching or retention, as ``prefix_cache=False``).

Every store also maintains a :class:`KvDigest`: an incrementally
updated, lock-guarded, cross-thread-readable digest of the published
chains (an order-independent content hash, version and loss-version
counters, residency aggregates, a bounded per-node walk and an event
journal), which ``GET /debug/kv`` and ``/healthz``'s ``kv.digest`` read.
Digest maintenance is host bookkeeping at mutation points the store
already owns: no device work.

The host bookkeeping (digest, stores, tier, chain keys) is the JAX
package's, line for line; only the three device-boundary primitives
(:func:`fetch_slab`, :func:`stage_restore` with :func:`restore_ready`,
:func:`adopt_into_pool`) are PyTorch's.  The admission state machine
lives in ``serving.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import uuid
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .utils.programs import program


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(n - 1, 0).bit_length()


def chain_keys(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Chain hash per FULL prompt block: ``key_j = H(key_{j-1}, block-j
    tokens)``, a blake2b chain over the int32 bytes of each block, so a
    hit at block j certifies the whole prefix up to it.  Only blocks
    strictly before the last token are keyed (at least one token must
    run through the model to produce the first sample).

    The one key schema of the prefix-cache stack: the batcher's index,
    the digest's journal and a fleet router's global index all speak
    these keys, byte for byte the JAX package's ``router.chain_keys``."""
    m = (len(tokens) - 1) // block_size
    keys: List[bytes] = []
    h = hashlib.blake2b(digest_size=16)
    for j in range(m):
        h.update(
            np.asarray(
                tokens[j * block_size:(j + 1) * block_size], np.int32
            ).tobytes()
        )
        keys.append(h.digest())  # digest() is non-destructive
    return keys


PREFIX_INDEX_MODES = ("radix", "exact", "off")


# ---------------------------------------------------------------------------
# Chain digest (replica radix digests — the fleet cache view's sensor)
# ---------------------------------------------------------------------------

def _entry_hash(key: bytes, tier: str) -> int:
    """Order-independent per-entry hash: XOR-accumulating these over
    the digest's (key, tier) set yields the same value for the same
    published chains regardless of publish/evict interleaving — the
    determinism the digest-correctness tests pin."""
    h = hashlib.blake2b(key + tier.encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class KvDigest:
    """Incrementally-maintained, cross-thread-readable digest of one
    prefix store's published chains.

    The store (serving-loop thread) calls the ``on_*`` hooks at every
    content mutation; HTTP handler threads read :meth:`summary` (O(1)
    aggregates — the compact form piggybacked on ``/healthz``'s ``kv``
    section for the router poller) and :meth:`nodes_json` (the bounded
    tree walk behind ``GET /debug/kv``).  All state lives under one
    leaf lock (``_lock``), so the
    readers need no racy-read pragmas and the writers pay two dict ops
    per mutation — pure host bookkeeping, zero device work.

    Versioning: ``version`` bumps on every content mutation (publish /
    evict / demote / restore), so a consumer holding an older version
    knows its copy is stale; ``loss_version`` bumps only on mutations
    that can LOSE a chain's HBM residency (evict, demote, host-tier
    drop) — the signal the router's affinity policy consults before
    trusting a pinned session's cache locality.  Both reset when a
    crash-recovery/quarantine rebuild replaces the store (a rebuild
    empties the cache, so any change of version IS staleness —
    consumers compare with ``!=``, not ``>``).

    ``hash`` is an order-independent XOR set-hash over (chain key,
    residency tier): equal for equal published content, cheap to
    maintain under removals (XOR is its own inverse).

    The **event journal** (``_journal``, bounded deque) records every
    content mutation as ``(version, op, key_hex, depth, tier)`` so a
    consumer holding version V can catch up INCREMENTALLY
    (:meth:`events_since`) instead of re-walking the whole tree — the
    router-side global radix index syncs off it, paying O(changes)
    per poll instead of O(nodes).  A consumer whose V fell out of the
    bounded window (or predates a rebuild) gets ``None`` and must
    full-resync via :meth:`nodes_json`."""

    # Journal window: at ~60 B/event this bounds the journal at a few
    # hundred KB while covering thousands of mutations between health
    # polls — a poller more than JOURNAL_MAX versions behind resyncs.
    JOURNAL_MAX = 4096

    def __init__(self):
        self._lock = threading.Lock()
        # Instance identity: versions RESET on rebuild, so a consumer
        # comparing versions alone can be fooled when a rebuild's
        # replay re-advances past its synced version (version
        # aliasing across histories).  The epoch is ctor-stable and
        # unique per digest instance — a consumer that sees it change
        # must full-resync regardless of version arithmetic.
        self.epoch = uuid.uuid4().hex[:16]
        # key -> [depth, tier("hbm"|"host"), idle(bool), seq]
        self._entries: Dict[bytes, List[Any]] = {}
        self._seq = 0
        self._hash = 0
        self._hbm = 0
        self._host = 0
        self._idle = 0
        self.version = 0
        self.loss_version = 0
        self.depth_max = 0  # high-water mark, not current max
        self.publishes_total = 0
        self.evictions_total = 0
        self.demotions_total = 0
        self.restores_total = 0
        self.host_evictions_total = 0
        # (version, op, key_hex, depth, tier) content-mutation journal.
        self._journal: "deque[Tuple[int, str, str, int, str]]" = deque(
            maxlen=self.JOURNAL_MAX
        )

    def _journal_locked(self, op: str, key: bytes, depth: int,
                        tier: str) -> None:
        self._journal.append(
            (self.version, op, key.hex(), int(depth), tier)
        )

    # -- mutation hooks (store/serving-loop thread) -------------------------

    def _set_tier_locked(self, ent: List[Any], key: bytes,
                         tier: str) -> None:
        if ent[1] != tier:
            self._hash ^= _entry_hash(key, ent[1])
            self._hash ^= _entry_hash(key, tier)
            if tier == "hbm":
                self._hbm += 1
                self._host -= 1
            else:
                self._host += 1
                self._hbm -= 1
                if ent[2]:
                    ent[2] = False
                    self._idle -= 1
            ent[1] = tier
        self._seq += 1
        ent[3] = self._seq

    def on_publish(self, key: bytes, depth: int) -> None:
        """A chain block became HBM-resident under ``key`` (fresh node
        or a re-publish adopting a new copy over a demoted one)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self._seq += 1
                self._entries[key] = [int(depth), "hbm", False, self._seq]
                self._hash ^= _entry_hash(key, "hbm")
                self._hbm += 1
                self.depth_max = max(self.depth_max, int(depth))
            else:
                self._set_tier_locked(ent, key, "hbm")
            self.publishes_total += 1
            self.version += 1
            self._journal_locked("publish", key, int(depth), "hbm")

    def on_remove(self, key: bytes) -> None:
        """``key`` left the index entirely (eviction drop, non-finite
        unpublish, host-tier victim's subtree)."""
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is None:
                return
            self._hash ^= _entry_hash(key, ent[1])
            if ent[1] == "hbm":
                self._hbm -= 1
                if ent[2]:
                    self._idle -= 1
            else:
                self._host -= 1
            self.evictions_total += 1
            self.version += 1
            self.loss_version += 1
            self._journal_locked("remove", key, ent[0], ent[1])

    def on_demote(self, key: bytes) -> None:
        """HBM -> host-tier demotion (stays matchable, loses HBM)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return
            self._set_tier_locked(ent, key, "host")
            self.demotions_total += 1
            self.version += 1
            self.loss_version += 1
            self._journal_locked("demote", key, ent[0], "host")

    def on_restore(self, key: bytes) -> None:
        """Host-tier -> HBM swap-in landed."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return
            self._set_tier_locked(ent, key, "hbm")
            self.restores_total += 1
            self.version += 1
            self._journal_locked("restore", key, ent[0], "hbm")

    def on_host_evict(self, key: bytes) -> None:
        """The host tier's LRU dropped ``key``'s slab (the node itself
        leaves via :meth:`on_remove` when that strands its subtree)."""
        with self._lock:
            self.host_evictions_total += 1
            self.version += 1
            self.loss_version += 1
            # Journaled so every version bump has a row (exact gap
            # detection in events_since); index consumers ignore the
            # op — the node's REMOVAL, when the slab loss strands it,
            # journals separately via on_remove.
            self._journal_locked("host_evict", key, 0, "host")

    def on_idle(self, key: bytes, idle: bool) -> None:
        """Refcount-boundary flip: idle (refcount 0, evictable) vs
        claimed.  Recency (``seq``) updates; versions do not — claims
        happen every admission and would drown real staleness."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None or ent[2] == idle:
                return
            ent[2] = idle
            self._idle += 1 if idle else -1
            self._seq += 1
            ent[3] = self._seq

    # -- readers (any thread) -----------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """O(1) aggregate snapshot — the bounded payload piggybacked on
        ``/healthz``'s ``kv.digest`` section (the router poller scrapes
        it for free; no new poll endpoint)."""
        with self._lock:
            return {
                "epoch": self.epoch,
                "version": self.version,
                "loss_version": self.loss_version,
                "hash": format(self._hash, "016x"),
                "nodes": len(self._entries),
                "hbm_blocks": self._hbm,
                "host_blocks": self._host,
                "idle_blocks": self._idle,
                "depth_max": self.depth_max,
                "publishes_total": self.publishes_total,
                "evictions_total": self.evictions_total,
                "demotions_total": self.demotions_total,
                "restores_total": self.restores_total,
                "host_evictions_total": self.host_evictions_total,
            }

    def events_since(
        self, since: int,
    ) -> Optional[Tuple[List[Dict[str, Any]], int]]:
        """``(events, version)``: content mutations with
        ``version > since`` (oldest first) plus the digest version they
        bring the consumer to, captured under ONE lock hold so the
        pair is never torn — the incremental-sync payload behind
        ``GET /debug/kv?since=V``.

        Returns ``None`` when the journal cannot prove completeness
        and the consumer must full-resync via :meth:`nodes_json`:
        ``since`` beyond the current version (a rebuild reset the
        digest), or the bounded journal already dropped events the
        consumer needs."""
        with self._lock:
            if since > self.version:
                return None  # rebuild reset: consumer is from the past
            if since == self.version:
                return [], self.version
            if not self._journal or self._journal[0][0] > since + 1:
                return None  # window lost events the consumer needs
            return [
                {"version": v, "op": op, "key": k, "depth": d,
                 "tier": t}
                for v, op, k, d, t in self._journal if v > since
            ], self.version

    def nodes_json(self, depth: Optional[int] = None,
                   max_nodes: int = 2048) -> Dict[str, Any]:
        """The full (bounded) tree walk behind ``GET /debug/kv``:
        per-node chain-prefix hash, depth, residency tier, refcount>0
        flag, and recency seq — depth-capped by ``depth`` and
        truncated (shallowest-first, deterministic order) past
        ``max_nodes``, so the payload stays bounded at max radix
        occupancy."""
        with self._lock:
            items = [
                (d, key.hex(), tier, idle, seq)
                for key, (d, tier, idle, seq) in self._entries.items()
                if depth is None or d <= depth
            ]
            version = self.version
        items.sort()
        truncated = max(0, len(items) - max_nodes)
        return {
            "version": version,
            "nodes": [
                {"key": k, "depth": d, "tier": tier,
                 "refcount": not idle, "seq": seq}
                for d, k, tier, idle, seq in items[:max_nodes]
            ],
            "truncated": truncated,
            "depth_cap": depth,
        }


# ---------------------------------------------------------------------------
# Match result (shared by all stores)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MatchResult:
    """Longest cached chain prefix for an admission.

    blocks:  the HBM-RESIDENT hit blocks, contiguous from the root —
             what a no-swap admission reuses (stops at the first
             non-resident node).
    path:    the full reachable node path (radix only; includes
             host-resident nodes past ``blocks``' depth).
    restore: the host-resident nodes on ``path`` needing swap-in before
             the whole path is claimable (empty = plain hit)."""

    blocks: List[int]
    path: List["RadixNode"]
    restore: List["RadixNode"]


# ---------------------------------------------------------------------------
# Host-DRAM tier
# ---------------------------------------------------------------------------

class HostTier:
    """Bounded LRU store of demoted block slabs, keyed by chain hash.

    A *slab* is the host-tensor image of one pool block —
    ``fetch_slab``'s dict of tensors (k/v/pos, + scales on int8 pools,
    + ``d_``-prefixed draft-pool twins under speculative serving).
    Capacity is counted in BLOCKS; inserting past it evicts the
    least-recently-stored unpinned slab (pinned = mid-swap-in; its
    node's restore must not lose the bytes under it)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._slabs: "OrderedDict[bytes, Dict[str, Any]]" = (
            OrderedDict()
        )
        self.pinned: set = set()

    def __len__(self) -> int:
        return len(self._slabs)

    def get(self, key: bytes) -> Optional[Dict[str, Any]]:
        return self._slabs.get(key)

    def drop(self, key: bytes) -> None:
        self._slabs.pop(key, None)
        self.pinned.discard(key)

    def put(self, key: bytes, slab: Dict[str, Any]) -> List[bytes]:
        """Store a slab; returns the keys evicted to make room (their
        nodes lose host residency — the caller drops/strands them)."""
        self._slabs[key] = slab
        evicted: List[bytes] = []
        while len(self._slabs) > self.capacity:
            victim = next(
                (k for k in self._slabs if k not in self.pinned and
                 k != key),
                None,
            )
            if victim is None:
                break  # everything pinned: tolerate transient overflow
            del self._slabs[victim]
            evicted.append(victim)
        return evicted


# ---------------------------------------------------------------------------
# Radix index
# ---------------------------------------------------------------------------

class RadixNode:
    """One full prompt block in the radix tree.

    ``key`` is the block's CUMULATIVE chain hash (position-invariant,
    certifies the whole prefix — ``chain_keys``), so node identity is
    chain-prefix identity and divergent chains share nodes for free.
    Residency: ``block`` (HBM) and ``host`` (demoted slab, held by the
    tier) are mutually exclusive; both ``None`` only transiently during
    teardown.  ``restoring`` marks an in-flight swap-in — unreachable
    for NEW matches (a second admission racing the swap would double-
    allocate), adopted into ``block`` when the transfer lands."""

    __slots__ = (
        "key", "parent", "children", "block", "host", "depth",
        "restoring",
    )

    def __init__(self, key: bytes, parent: Optional["RadixNode"],
                 depth: int):
        self.key = key
        self.parent = parent
        self.children: Dict[bytes, "RadixNode"] = {}
        self.block: Optional[int] = None
        self.host: Optional[Dict[str, Any]] = None
        self.depth = depth
        self.restoring = False

    @property
    def reachable(self) -> bool:
        return self.block is not None or (
            self.host is not None and not self.restoring
        )


class RadixPrefixStore:
    """The radix/trie prefix index + host tier (mode ``radix``).

    Interface contract with ``ContinuousBatcher`` (the batcher keeps
    per-block refcounts; the store keeps keyed-ness, tree structure,
    idle-LRU order and residency):

      match(keys)            longest reachable path -> MatchResult
      publish(keys, blocks)  register a freshly prefilled chain;
                             returns idle blocks to free NOW
      unpublish(blk)         non-finite-guard: drop the node AND its
                             subtree (suspect KV must never be hit);
                             returns stranded idle blocks to free
      is_keyed(blk)          retain on last-ref free?
      retain(blocks)         freed keyed blocks -> idle LRU (chain
                             order in; reversed so leaves evict first)
      on_claim(blocks)       admission claimed blocks -> leave LRU
      evictable()            idle count (capacity accounting)
      pop_evictable(demote)  reclaim one idle block, demoting its KV
                             into the host tier when there is room
      pin/unpin/complete_restore   the swap-in lifecycle
    """

    kind = "radix"
    enabled = True

    def __init__(self, host_blocks: int = 0, on_event=None):
        self.root = RadixNode(b"", None, 0)
        self._by_key: Dict[bytes, RadixNode] = {}
        self._by_block: Dict[int, RadixNode] = {}
        # refcount-0 HBM-resident keyed nodes; front = evict first.
        self._idle: "OrderedDict[bytes, RadixNode]" = OrderedDict()
        self.tier = HostTier(host_blocks) if host_blocks > 0 else None
        # Cross-thread-readable chain digest (fleet cache telemetry):
        # updated at every content mutation below, read by /debug/kv
        # and the /healthz kv section from handler threads.
        self.digest = KvDigest()
        # Optional observability sink (obs.Observability.annotate):
        # tier transitions — demotions, host-LRU drops, completed
        # restores — land as instant events in the serving trace, so a
        # /debug/trace window explains WHY a session re-prefilled cold
        # (its slab was the host tier's LRU victim) without log
        # archaeology.  Pure host bookkeeping, never on the decode hot
        # path.
        self._on_event = on_event

    def _event(self, name: str, **fields) -> None:
        if self._on_event is not None:
            self._on_event(name, **fields)

    # -- matching / publication --------------------------------------------

    def match(self, keys: Sequence[bytes]) -> MatchResult:
        path: List[RadixNode] = []
        node = self.root
        for key in keys:
            child = node.children.get(key)
            if child is None or not child.reachable:
                break
            path.append(child)
            node = child
        blocks: List[int] = []
        for n in path:
            if n.block is None:
                break
            blocks.append(n.block)
        restore = [n for n in path if n.block is None]
        return MatchResult(blocks=blocks, path=path, restore=restore)

    def publish(self, keys: Sequence[bytes],
                blocks: Sequence[int]) -> List[int]:
        """Register a freshly prefilled full-prompt chain.  Existing
        RESIDENT nodes keep their block — the publisher's duplicate
        copy stays private/unkeyed and frees plainly with its slot
        (shared-by-construction replaces the flat map's supersede
        churn); a demoted node adopts the fresh HBM copy (newer bytes,
        host slab dropped)."""
        parent = self.root
        for key, blk in zip(keys, blocks):
            node = self._by_key.get(key)
            if node is None:
                node = RadixNode(key, parent, parent.depth + 1)
                parent.children[key] = node
                self._by_key[key] = node
                node.block = blk
                self._by_block[blk] = node
                self.digest.on_publish(key, node.depth)
            elif node.block is None and not node.restoring:
                node.block = blk
                self._by_block[blk] = node
                if node.host is not None:
                    node.host = None
                    if self.tier is not None:
                        self.tier.drop(key)
                self.digest.on_publish(key, node.depth)
            parent = node
        return []

    def unpublish(self, blk: int) -> List[int]:
        node = self._by_block.get(blk)
        if node is None or node.block != blk:
            return []
        return self._drop_subtree(node)

    def _drop_subtree(self, node: RadixNode) -> List[int]:
        """Remove ``node`` and every descendant from the index.  Idle
        (refcount-0 retained) blocks in the subtree are returned for
        the caller to free; blocks with live users merely lose their
        keying and free plainly when their slots do."""
        freed: List[int] = []
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self._by_key.pop(n.key, None)
            self.digest.on_remove(n.key)
            if n.block is not None:
                if self._by_block.get(n.block) is n:
                    del self._by_block[n.block]
                if n.key in self._idle:
                    del self._idle[n.key]
                    freed.append(n.block)
                n.block = None
            if n.host is not None:
                n.host = None
                if self.tier is not None:
                    self.tier.drop(n.key)
            n.restoring = False
        return freed

    # -- refcount-boundary hooks -------------------------------------------

    def is_keyed(self, blk: int) -> bool:
        node = self._by_block.get(blk)
        return node is not None and node.block == blk

    def retain(self, blocks: Sequence[int]) -> None:
        # Later chain blocks enter the LRU first (reversed) so chains
        # evict back-to-front — the leaves-first discipline.
        for blk in reversed(list(blocks)):
            node = self._by_block.get(blk)
            if node is not None and node.block == blk:
                self._idle[node.key] = node
                self.digest.on_idle(node.key, True)

    def on_claim(self, blocks: Sequence[int]) -> None:
        for blk in blocks:
            node = self._by_block.get(blk)
            if node is not None:
                self._idle.pop(node.key, None)
                self.digest.on_idle(node.key, False)

    # -- eviction / demotion -----------------------------------------------

    def evictable(self) -> int:
        return len(self._idle)

    def pop_evictable(
        self,
        demote: Optional[Callable[[int], Dict[str, Any]]] = None,
    ) -> Tuple[Optional[int], List[int]]:
        """Reclaim one idle keyed block for the allocator.

        With a host tier and a ``demote`` callback the block's KV is
        fetched to a host slab first and the node stays matchable
        (host-resident); otherwise the node is DROPPED — choosing an
        idle node with no reachable children when one exists, so an
        interior drop never strands a resident suffix (the flat map
        relied on insertion order for this; the tree checks).

        Returns ``(block, extra_free)``: the reclaimed block plus any
        additional idle blocks orphaned by a forced subtree drop (the
        caller returns those to the free list)."""
        if not self._idle:
            return None, []
        if self.tier is not None and demote is not None:
            key, node = next(iter(self._idle.items()))
            blk = self._demote_node(key, node, demote)
            return blk, self._host_put(key, node.host)
        # Drop path (no tier): leaves first.
        chosen = None
        for key, node in self._idle.items():
            if not any(c.reachable or c.restoring
                       for c in node.children.values()):
                chosen = node
                break
        if chosen is None:
            chosen = next(iter(self._idle.values()))
        blk = chosen.block
        self._event("kv_evict", block=blk, depth=chosen.depth)
        extra = self._drop_subtree(chosen)
        extra.remove(blk)
        return blk, extra

    def _demote_node(
        self, key: bytes, node: RadixNode,
        demote: Callable[[int], Dict[str, Any]],
    ) -> int:
        """Demote one idle HBM-resident node into a host slab (caller
        guarantees idleness and residency); returns the freed block.
        The slab lands on ``node.host`` — the caller feeds it to
        :meth:`_host_put` for tier insertion + LRU fallout."""
        blk = node.block
        slab = demote(blk)
        del self._idle[key]
        del self._by_block[blk]
        node.block = None
        node.host = slab
        self.digest.on_demote(key)
        self._event("kv_demote", block=blk, depth=node.depth)
        return blk

    def _host_put(
        self, key: bytes, slab: Dict[str, Any],
    ) -> List[int]:
        """Insert a demoted slab into the host tier; host-LRU victims
        lose their slab (and their now-unreachable subtrees drop),
        returning any idle blocks that strands for the caller to
        free."""
        extra: List[int] = []
        for ekey in self.tier.put(key, slab):
            enode = self._by_key.get(ekey)
            if enode is None:
                continue
            enode.host = None
            self.digest.on_host_evict(ekey)
            self._event("kv_host_evict", depth=enode.depth)
            if enode.block is None:
                extra.extend(self._drop_subtree(enode))
        return extra

    def demote_keys(
        self,
        keys: Sequence[bytes],
        demote: Optional[
            Callable[[int], Dict[str, Any]]
        ] = None,
    ) -> List[int]:
        """TARGETED demotion of one exported chain (the
        demote-after-export half of a cross-replica handoff): each
        key's node, if idle and HBM-resident, demotes into the host
        tier (stays matchable) — or, with no tier, DROPS when nothing
        reachable hangs below it (leaves-first; an interior node with
        a resident suffix is kept so the drop never strands it).
        Claimed (refcount>0) nodes are skipped — a live session's KV
        never moves under it.  Returns the freed HBM blocks (plus any
        host-LRU fallout) for the caller to invalidate+free.  Walks
        deepest-first so the no-tier drop path sees leaves before
        their parents."""
        freed: List[int] = []
        for key in reversed(list(keys)):
            node = self._by_key.get(key)
            if (
                node is None or node.block is None
                or key not in self._idle
            ):
                continue
            if self.tier is not None and demote is not None:
                blk = self._demote_node(key, node, demote)
                freed.append(blk)
                freed.extend(self._host_put(key, node.host))
            else:
                if any(c.reachable or c.restoring
                       for c in node.children.values()):
                    continue  # resident suffix below: keep the node
                blk = node.block
                self._event(
                    "kv_evict", block=blk, depth=node.depth
                )
                freed.extend(self._drop_subtree(node))
        return freed

    # -- swap-in lifecycle --------------------------------------------------

    def pin_restoring(self, nodes: Sequence[RadixNode]) -> None:
        for n in nodes:
            n.restoring = True
            if self.tier is not None:
                self.tier.pinned.add(n.key)

    def unpin_restoring(self, nodes: Sequence[RadixNode]) -> None:
        """Abort a swap-in (injected failure / cancel): the nodes stay
        host-resident and matchable again."""
        for n in nodes:
            n.restoring = False
            if self.tier is not None:
                self.tier.pinned.discard(n.key)

    def complete_restore(self, nodes: Sequence[RadixNode],
                         blocks: Sequence[int]) -> None:
        """The swap-in landed: nodes flip host-resident -> HBM-resident
        under their freshly scattered blocks (claimed by the admission,
        so NOT idle), slabs leave the tier."""
        for n, blk in zip(nodes, blocks):
            n.block = blk
            self._by_block[blk] = n
            n.host = None
            n.restoring = False
            if self.tier is not None:
                self.tier.drop(n.key)
            self.digest.on_restore(n.key)
        if nodes:
            self._event("kv_restore_complete", blocks=len(nodes))

    # -- observability -------------------------------------------------------

    def cached_blocks(self) -> int:
        return len(self._idle)

    def nodes_total(self) -> int:
        return len(self._by_key)

    def host_blocks(self) -> int:
        return len(self.tier) if self.tier is not None else 0

    def resident_chains(self) -> List[List[bytes]]:
        """Every maximal HBM-resident chain as its ordered key path
        (root child → deepest resident node) — the drain/migration
        enumeration surface.  A path is cut at the first non-HBM node
        (demoted or restoring): only the contiguous resident prefix can
        be exported, exactly what ``export_prefix`` would move.  Nodes
        whose chain continues resident are not emitted separately —
        their keys appear as prefixes of the longer chain."""
        chains: List[List[bytes]] = []
        stack: List[Tuple[RadixNode, List[bytes]]] = [(self.root, [])]
        while stack:
            node, path = stack.pop()
            nxt = [c for c in node.children.values() if c.block is not None]
            if not nxt and path:
                chains.append(path)
            for child in nxt:
                stack.append((child, path + [child.key]))
        return chains


# ---------------------------------------------------------------------------
# Exact (legacy) and off modes
# ---------------------------------------------------------------------------

class ExactPrefixStore:
    """The pre-radix flat chain map (mode ``exact``), kept as the
    behavioral oracle: one ``Dict[bytes, block]`` keyed by cumulative
    chain hash, duplicate publications SUPERSEDE (the old
    ``_register_chain`` churn), eviction is pure insertion-order LRU,
    and there is no host tier."""

    kind = "exact"
    enabled = True

    def __init__(self):
        self._prefix_index: Dict[bytes, int] = {}
        self._block_chain: Dict[int, bytes] = {}
        self._reusable: "OrderedDict[int, None]" = OrderedDict()
        # Flat-map digest: depth = chain index + 1 (no tree, but the
        # same versioned surface every store exposes).
        self.digest = KvDigest()

    def match(self, keys: Sequence[bytes]) -> MatchResult:
        hits: List[int] = []
        for key in keys:
            blk = self._prefix_index.get(key)
            if blk is None:
                break
            hits.append(blk)
        return MatchResult(blocks=hits, path=[], restore=[])

    def publish(self, keys: Sequence[bytes],
                blocks: Sequence[int]) -> List[int]:
        superseded: List[int] = []
        for depth, (blk, key) in enumerate(zip(blocks, keys)):
            old = self._prefix_index.get(key)
            if old is not None and old != blk:
                self._block_chain.pop(old, None)
                if old in self._reusable:
                    del self._reusable[old]
                    superseded.append(old)
                # The key now binds the freshly published (claimed)
                # block: clear any idle flag inherited from the
                # superseded one, or /debug/kv would report a live
                # session's block as evictable for its whole life.
                self.digest.on_idle(key, False)
            self._block_chain[blk] = key
            self._prefix_index[key] = blk
            self.digest.on_publish(key, depth + 1)
        return superseded

    def unpublish(self, blk: int) -> List[int]:
        key = self._block_chain.pop(blk, None)
        if key is not None and self._prefix_index.get(key) == blk:
            del self._prefix_index[key]
            self.digest.on_remove(key)
        return []

    def is_keyed(self, blk: int) -> bool:
        return blk in self._block_chain

    def retain(self, blocks: Sequence[int]) -> None:
        for blk in reversed(list(blocks)):
            self._reusable[blk] = None
            key = self._block_chain.get(blk)
            if key is not None:
                self.digest.on_idle(key, True)

    def on_claim(self, blocks: Sequence[int]) -> None:
        for blk in blocks:
            self._reusable.pop(blk, None)
            key = self._block_chain.get(blk)
            if key is not None:
                self.digest.on_idle(key, False)

    def evictable(self) -> int:
        return len(self._reusable)

    def pop_evictable(self, demote=None) -> Tuple[Optional[int], List[int]]:
        if not self._reusable:
            return None, []
        blk, _ = self._reusable.popitem(last=False)
        self.unpublish(blk)
        return blk, []

    def demote_keys(self, keys, demote=None) -> List[int]:
        """Demote-after-export is a radix/tier feature; the exact
        oracle keeps its published chains in place."""
        return []

    def pin_restoring(self, nodes) -> None:  # pragma: no cover - no tier
        raise AssertionError("exact store has no host tier")

    unpin_restoring = complete_restore = pin_restoring

    def cached_blocks(self) -> int:
        return len(self._reusable)

    def nodes_total(self) -> int:
        return len(self._prefix_index)

    def host_blocks(self) -> int:
        return 0

    def resident_chains(self) -> List[List[bytes]]:
        """Flat map: no parent links, so chains cannot be reassembled —
        each published key is emitted as its own depth-1 chain.  Because
        ``match`` looks every cumulative key up independently, importing
        these singletons on another replica reproduces the same hit
        surface; only the radix store's shared-prefix structure is
        lost (it never existed here)."""
        return [[key] for key in self._prefix_index]


class NullPrefixStore:
    """Mode ``off``: nothing matches, nothing is retained."""

    kind = "off"
    enabled = False

    def __init__(self):
        self.digest = KvDigest()  # permanently empty, version 0

    def match(self, keys) -> MatchResult:
        return MatchResult(blocks=[], path=[], restore=[])

    def publish(self, keys, blocks) -> List[int]:
        return []

    def unpublish(self, blk) -> List[int]:
        return []

    def is_keyed(self, blk) -> bool:
        return False

    def retain(self, blocks) -> None:
        pass

    def on_claim(self, blocks) -> None:
        pass

    def evictable(self) -> int:
        return 0

    def pop_evictable(self, demote=None) -> Tuple[Optional[int], List[int]]:
        return None, []

    def demote_keys(self, keys, demote=None) -> List[int]:
        return []

    def cached_blocks(self) -> int:
        return 0

    def nodes_total(self) -> int:
        return 0

    def host_blocks(self) -> int:
        return 0

    def resident_chains(self) -> List[List[bytes]]:
        return []


def make_prefix_store(mode: str, host_blocks: int = 0, on_event=None):
    """Store factory.  The host tier only attaches to the radix index
    (``exact`` is the legacy oracle, ``off`` retains nothing — in both
    a nonzero ``host_blocks`` is inert by design: the degradation
    layer's prefix-cache quarantine rebuilds with the cache off and
    must not trip a constructor error over the tier flag).
    ``on_event`` (radix only) is an observability sink for tier
    transitions — the batcher wires ``obs.Observability.annotate`` so
    demote/host-evict/restore events land in the serving trace."""
    if mode not in PREFIX_INDEX_MODES:
        raise ValueError(
            f"unknown prefix_index mode {mode!r}; have {PREFIX_INDEX_MODES}"
        )
    if mode == "radix":
        return RadixPrefixStore(host_blocks=host_blocks,
                                on_event=on_event)
    if mode == "exact":
        return ExactPrefixStore()
    return NullPrefixStore()


# ---------------------------------------------------------------------------
# Device-boundary primitives (demote copy / staged swap-in / adoption)
# ---------------------------------------------------------------------------

# Slab tensor names in pool order; the draft pool's twins carry the
# ``d_`` prefix.  ``pos`` is per-block [BLK]; k/v are [L, KVH, BLK, hd];
# scales (int8 pools only) are [L, KVH, BLK].
_POOL_FIELDS = ("k", "v", "pos", "k_scale", "v_scale")


def _pool_names(pool) -> Tuple[str, ...]:
    return _POOL_FIELDS if pool.k_scale is not None else _POOL_FIELDS[:3]


def pool_block_bytes(pool) -> int:
    """Bytes of pool memory ONE block occupies (k + v + pos + scales on
    int8 pools): every pool tensor carries exactly one n_blocks axis, so
    total bytes / n_blocks is exact.  Host arithmetic on shapes only."""
    n_blocks = pool.pos.shape[0]
    total = sum(getattr(pool, name).nbytes for name in _pool_names(pool))
    return int(total // max(1, n_blocks))


def _block_plane(arr: torch.Tensor, name: str, blk: int) -> torch.Tensor:
    return arr[blk] if name == "pos" else arr[:, :, blk]


class Slab(dict):
    """One block's KV image: {name: host tensor} (k/v/pos, + scales on
    int8 pools, + ``d_``-prefixed draft twins).  A dict that can be
    weakly referenced, so a :class:`SlabArena` slot returns to its free
    list when the last reference (the tier, a radix node, an in-flight
    swap-in) lets go of the slab."""

    __slots__ = ("__weakref__",)


class SlabArena:
    """Host slabs for the tier, allocated ONCE (pinned on a CUDA pool:
    per-slab pinned allocations cost milliseconds each and serialise the
    host) and reused.  ``capacity`` slots of one plane per slab field;
    :meth:`take` hands out a free slot's views as a :class:`Slab`, and
    the slot comes back when that slab is garbage, which cannot happen
    while a swap-in that reads it is in flight (``_Restore`` holds its
    sources until the copy's event has passed).  Past ``capacity`` live
    slabs (the tier's transient overflow), :meth:`take` allocates a slab
    of its own."""

    def __init__(self, pools: Sequence[Tuple[str, Any]], capacity: int,
                 pin: bool):
        self.pin = bool(pin)
        self._specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        for prefix, pool in pools:
            for name in _pool_names(pool):
                sl = _block_plane(getattr(pool, name), name, 0)
                self._specs[prefix + name] = (tuple(sl.shape), sl.dtype)
        self._planes = {
            name: torch.empty((capacity,) + shape, dtype=dtype,
                              pin_memory=self.pin)
            for name, (shape, dtype) in self._specs.items()
        }
        self._free: List[int] = list(range(capacity))[::-1]
        self.overflow_total = 0

    def __len__(self) -> int:
        return len(self._free)

    def take(self) -> Slab:
        if not self._free:
            self.overflow_total += 1
            return Slab({
                name: torch.empty(shape, dtype=dtype, pin_memory=self.pin)
                for name, (shape, dtype) in self._specs.items()
            })
        i = self._free.pop()
        slab = Slab({name: plane[i] for name, plane in self._planes.items()})
        weakref.finalize(slab, self._free.append, i)
        return slab


def fetch_slab(pool, blk: int, prefix: str = "",
               into: Optional[Slab] = None) -> Dict[str, torch.Tensor]:
    """Demotion D2H: one block's KV image.  Must run BEFORE the caller
    invalidates the block's pool positions (the slab keeps the live
    ``pos`` row the future restore re-installs).

    With ``into`` (an arena slab) the copies are asynchronous, on the
    pool's stream, into its (pinned) tensors, and that stream order is
    what puts them before the caller's invalidation: the caller waits
    once for a whole demotion sweep before the slab is read anywhere
    else.  Without, fresh host tensors come back filled (a blocking copy:
    the export path)."""
    out: Dict[str, torch.Tensor] = {} if into is None else into
    for name in _pool_names(pool):
        sl = _block_plane(getattr(pool, name), name, blk)
        if into is None:
            out[prefix + name] = sl.to("cpu", copy=True)
        else:
            into[prefix + name].copy_(sl, non_blocking=True)
    return out


@dataclasses.dataclass
class Staged:
    """A swap-in in flight (:func:`stage_restore`): staging tensors
    ``planes`` ({name: [nb, ...]}, block-major) and the destination
    block ids ``ids`` ([nb] int32, padded with the sentinel past the
    ``n`` real rows), filled by copies on ``stream``; ``event`` passes
    when they have landed (None: the copies ran as they were called, on
    the CPU).  ``sources`` keeps the host slabs referenced until then."""

    ids: torch.Tensor
    n: int
    planes: Dict[str, torch.Tensor]
    sources: List[Dict[str, torch.Tensor]]
    event: Optional[Any] = None

    @property
    def nbytes(self) -> int:
        return int(self.ids.nbytes) + sum(
            int(t.nbytes) for t in self.planes.values())


def stage_restore(
    slabs: Sequence[Dict[str, torch.Tensor]],
    block_ids: Sequence[int],
    sentinel: int,
    device="cpu",
    stream=None,
    shardings: Optional[Dict[str, Any]] = None,
) -> Staged:
    """Swap-in H2D: copy the slabs into STAGING tensors on ``device``,
    one block-major plane per slab field, with ``copy_(non_blocking=
    True)`` on ``stream`` (a side CUDA stream the batcher owns), and
    record an event after the copies.  The staging tensors are not the
    pool's: decode chunks dispatched on the main stream while the copies
    fly have no dependency on them, which is what makes the overlap real.
    Readiness is :func:`restore_ready`.

    ``block_ids`` are the fresh pool blocks the adoption lands in,
    padded to a pow2 bucket with ``sentinel`` (an out-of-range id: the
    adoption drops pad rows), as the JAX package pads them for its jit
    cache.  Without a stream (a CPU pool) the copies run as called.

    ``shardings`` (``parallel.serve_mesh.staging_shardings``; a serving
    mesh) places each plane, and ``ids``, on its rank's device: each rank
    stages its own KV-head slice of the slabs, which its own pool
    demoted, so the adoption lands shard-local."""
    n = len(slabs)
    nb = pow2_bucket(n)
    ids = np.full((nb,), sentinel, np.int32)
    ids[:n] = list(block_ids)
    device = torch.device(device)

    def where(name):
        return device if shardings is None else shardings[name].device

    planes: Dict[str, torch.Tensor] = {}
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        ids_t = torch.from_numpy(ids).to(where("ids"))
        for name in slabs[0]:
            first = slabs[0][name]
            # audit: host-upload(one staging buffer per pool plane of a
            # swap-in, allocated on the device at admission: the loop runs
            # over the pool's planes, not over tokens)
            buf = torch.empty((nb,) + tuple(first.shape), dtype=first.dtype,
                              device=where(name))
            for i, s in enumerate(slabs):
                buf[i].copy_(s[name], non_blocking=stream is not None)
            planes[name] = buf
        event = None
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
    return Staged(ids=ids_t, n=n, planes=planes, sources=list(slabs),
                  event=event)


def restore_ready(staged: Staged) -> bool:
    """Non-blocking readiness poll of a staged swap-in."""
    return staged.event is None or staged.event.query()


def wait_restore(staged: Staged) -> None:
    """Block until a staged swap-in's copies have landed (the idle path,
    and before an in-flight swap-in's memory may be let go)."""
    if staged.event is not None:
        # audit: host-fetch(a swap-in's copies land before its staging
        # memory may go: the idle path, a rebuild and teardown only)
        staged.event.synchronize()


def adopt_into_pool(pool, staged: Staged, prefix: str = ""):
    """Land a completed swap-in's staged blocks in the pool, in place:
    on the pool's current stream after it waits for the staging copies'
    event, ONE scatter (``_adopt_jit``); sentinel pad rows drop.  The
    staging tensors were allocated on the side stream and are read here
    on the main one, so each is marked used by the main stream
    (``record_stream``): the caching allocator then does not hand its
    memory out again before this scatter has run.  ``prefix`` picks the
    staged planes of this pool (``"d_"``: the draft pool's).  Returns the
    pool."""
    planes = {name: staged.planes[prefix + name]
              for name in _pool_names(pool)}
    if staged.event is not None:
        main = torch.cuda.current_stream(pool.k.device)
        main.wait_event(staged.event)
        staged.ids.record_stream(main)
        for s in planes.values():
            s.record_stream(main)
    _adopt_jit(pool, staged.ids, planes)
    return pool


@program("_adopt_jit", donate=("pool",), graph=True, copied=("planes",))
def _adopt_jit(pool, ids, planes):
    """The adoption's scatter (JAX :1081): staged block i of each plane
    ({name: [nb, ...]}, block-major) lands in pool block ``ids[i]``, in
    place.  The staged planes are new tensors at every swap-in: a replay
    copies them into the ones its graph captured (``copied``).  ``ids`` [nb] int32 is padded with the sentinel (an id past the
    pool's blocks), which drops: a pad row rewrites the first row's block
    with the first row's bytes.  A staged plane of another head count
    than the pool's (a slab of another tensor width) raises."""
    ids = ids.long()
    rows = torch.arange(ids.numel(), device=ids.device)
    src = torch.where(ids < pool.pos.shape[0], rows, 0)
    ids = ids[src]
    for name, s in planes.items():
        a = getattr(pool, name)
        s = s[src].to(a.dtype)
        if name == "pos":      # [NB, BLK] <- [nb, BLK]
            a[ids] = s
        else:                  # [L, KVH, NB, ...] <- [nb, L, KVH, ...]
            if s.shape[2] != a.shape[1]:
                raise ValueError(
                    f"adopt_into_pool: a staged {name} plane holds "
                    f"{s.shape[2]} KV heads, the pool {a.shape[1]}")
            a[:, :, ids] = s.movedim(0, 2)
