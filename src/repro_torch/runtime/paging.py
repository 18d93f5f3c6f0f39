"""Paged KV-cache pool: fixed page arena + per-slot page-index tables.

The paper's configuration discipline — work at the granularity the
memory hierarchy can actually hold (§3.3) — applied to serving memory:
instead of one dense ``seq_cap`` KV lane per slot (``n_slots × max_len``
bytes regardless of load), the engine owns a fixed arena of fixed-size
**pages** and each slot holds a small index list mapping its logical
cache positions onto arena pages.  Memory then scales with *live
tokens*: a slot allocates only the pages its request actually needs
(``ceil(min(prompt + max_new, s_cache) / page_size)``) and returns them
to the free list the moment it retires — EOS-stopped requests free
mid-stream, budget-stopped at their last token — so the next admission
reuses them immediately.

Host-side only: the device never sees this object.  The engine passes a
fresh ``(B, W)`` int32 page-table array into every jitted step (exactly
like the per-slot position vector from PR 5), and the arena itself is a
donated decode-state leaf ``(L, n_pages, page_size, Hkv, Dh)``.

Layout invariants the decode path relies on:

  * ``W · page_size == s_cache`` exactly — the gathered per-slot view
    reshapes to the dense cache lane shape, which is what makes the XLA
    gather fallback *bit-identical* to the dense slot-table path.
  * Pages are **pod-partitioned**: pod ``p`` allocates only from
    ``[p · pages_per_pod, (p+1) · pages_per_pod)``, so under the
    class-sharded mixed step the arena shards on its page dim exactly
    like a dense cache shards on its slot dim, with no cross-pod
    gathers.  (The engine localizes table entries per shard.)
  * Unallocated table entries hold :data:`SENTINEL` — far out of range,
    so jit scatters drop the write (``mode="drop"``) and jit gathers
    clip to an arbitrary page whose values are always masked off.
  * One shared **phantom page set per pod**: every free-but-refreshed
    lane points at the same pages, so phantom rows (which all carry the
    identical zero-prompt content — required for MoE cross-row
    bit-identity with the dense engine) cost one lane of pages per pod
    instead of one per slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Far beyond any real arena: scatters drop it, gathers clip it, and it
# survives per-pod localization (subtracting a pod offset) still
# out-of-range.  int32 to match the device table dtype.
SENTINEL = np.int32(1 << 30)


def divisor_page_size(s_cache: int, requested: int) -> int:
    """The largest divisor of ``s_cache`` that is ``<= requested``.

    The table width must satisfy ``W · page_size == s_cache`` exactly
    (the gathered view reshapes to the dense lane — the bit-identity
    contract), so a requested page size that does not divide the cache
    length rounds *down* to the nearest divisor.
    """

    ps = max(1, min(int(requested), int(s_cache)))
    while s_cache % ps:
        ps -= 1
    return ps


@dataclasses.dataclass(frozen=True)
class PageSpec:
    """Static shape of one pool: page granularity and arena capacity."""

    page_size: int       # tokens per page (divides s_cache)
    pages_per_slot: int  # W — table width; W * page_size == s_cache
    pages_per_pod: int   # physical pages in each pod's arena partition
    n_pods: int

    @property
    def n_pages(self) -> int:
        return self.pages_per_pod * self.n_pods

    def pages_for(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` of cache (capped at the table width)."""

        need = -(-int(n_tokens) // self.page_size)  # ceil
        return min(need, self.pages_per_slot)


class PagePool:
    """Free-list page allocator over a pod-partitioned arena (host side).

    Slots are pod-major (slot ``s`` belongs to pod ``s // c_max``) and
    allocate only from their pod's partition.  Allocation is
    all-or-nothing per request: the engine reserves every page a request
    can touch at admission time, so decode never hits mid-stream
    exhaustion — admission *defers* instead (the pool-exhaustion
    contract: a deferred request never corrupts live slots).
    """

    def __init__(self, spec: PageSpec, c_max: int):
        self.spec = spec
        self.c_max = int(c_max)
        n_slots = spec.n_pods * self.c_max
        self.table = np.full((n_slots, spec.pages_per_slot), SENTINEL, np.int32)
        pp = spec.pages_per_pod
        # LIFO free lists (pop from the end): lowest page ids first.
        self._free = [
            list(range((p + 1) * pp - 1, p * pp - 1, -1))
            for p in range(spec.n_pods)
        ]
        self.allocs = 0          # cumulative pages ever allocated
        self.peak_live = 0
        self.phantom: "np.ndarray | None" = None  # (n_pods, W) shared rows

    # -- accounting --------------------------------------------------------

    @property
    def pages_free(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def pages_live(self) -> int:
        return self.spec.n_pages - self.pages_free

    def pod_of(self, slot: int) -> int:
        return slot // self.c_max

    def _bump(self, n: int):
        self.allocs += n
        self.peak_live = max(self.peak_live, self.pages_live)

    # -- allocation --------------------------------------------------------

    def alloc(self, slot: int, n_tokens: int) -> bool:
        """Reserve pages covering ``n_tokens`` for ``slot`` (all-or-nothing).

        Returns False — leaving the pool and the slot's row untouched —
        when the slot's pod partition cannot cover the request.
        """

        need_cols = self.spec.pages_for(n_tokens)
        row = self.table[slot]
        have = int((row != SENTINEL).sum())
        missing = need_cols - have
        if missing <= 0:
            return True
        free = self._free[self.pod_of(slot)]
        if len(free) < missing:
            return False
        for col in range(have, need_cols):
            row[col] = free.pop()
        self._bump(missing)
        return True

    def free_slot(self, slot: int) -> int:
        """Return every page of ``slot`` to its pod's free list; returns count."""

        row = self.table[slot]
        pages = row[row != SENTINEL]
        if len(pages):
            self._free[self.pod_of(slot)].extend(int(p) for p in pages)
            row[:] = SENTINEL
        return int(len(pages))

    def alloc_phantom(self, *, per_slot: bool = False) -> np.ndarray:
        """Reserve the phantom page set for free-but-live (pad) lanes.

        ``per_slot=False`` (row-local archs): one shared lane per pod —
        every refreshed free lane of pod ``p`` points at row ``p`` of the
        returned ``(n_pods, W)`` table.  Their writes are identical by
        construction (same zero-prompt streams at the same positions), so
        sharing is exact, and the fixed overhead is one lane per pod
        instead of one per free slot.

        ``per_slot=True`` (MoE archs): one lane per *slot* — ``(n_slots,
        W)``, each row drawn from its slot's pod partition.  MoE capacity
        routing ranks tokens by a cumsum over the merged decode group, so
        *identical* pad rows can be dropped differentially when capacity
        binds; their streams then diverge and a shared page would take
        conflicting writes.  A private phantom lane per slot reproduces
        the dense engine's pad lanes exactly (each owns its content), at
        the dense cost for free lanes only.

        Reserved once, never freed.
        """

        if self.phantom is not None:
            return self.phantom
        w = self.spec.pages_per_slot
        n_rows = self.spec.n_pods * self.c_max if per_slot else self.spec.n_pods
        rows = np.full((n_rows, w), SENTINEL, np.int32)
        for r in range(n_rows):
            p = self.pod_of(r) if per_slot else r
            free = self._free[p]
            if len(free) < w:
                raise ValueError(
                    f"pool too small: pod {p} has {len(free)} free pages, "
                    f"phantom lane needs {w} (pages_per_pod="
                    f"{self.spec.pages_per_pod})"
                )
            for col in range(w):
                rows[r, col] = free.pop()
        self._bump(n_rows * w)
        self.phantom = rows
        return rows

    def localize(self, table: np.ndarray, pod_of_row: np.ndarray) -> np.ndarray:
        """Rewrite global page ids as pod-local ids (class-sharded step).

        Under the mixed shard_map each pod's shard holds only its arena
        partition, so entries must index within it.  SENTINEL stays out
        of range after the subtraction (it dwarfs any real offset).
        """

        off = (pod_of_row * self.spec.pages_per_pod).astype(np.int32)
        return table - off[:, None]


__all__ = ["PagePool", "PageSpec", "SENTINEL", "divisor_page_size"]
