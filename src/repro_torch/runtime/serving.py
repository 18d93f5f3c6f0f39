"""Persistent asymmetric serving runtime: slot table + per-class queues.

The port's counterpart of ``repro.runtime.serving.ServingEngine`` on its
single-program path (one card: the whole slot table decodes under the
fastest class's control tree, as the reference does whenever it has
fewer devices than pods).  What carries over:

  * **Fixed pod-major slot table** — ``n_pods × c_max`` decode slots; pod
    *i* owns ``[i·c_max, (i+1)·c_max)``.
  * **Paged KV pool** (``paged="auto"|"on"``) — a fixed arena of pages and
    a page-index list per slot (:mod:`repro_torch.runtime.paging`); pages
    are reserved all-or-nothing at admission and freed at retirement.
  * **Continuous batching** — one admission round takes mixed-length
    prompts from every queue head (right-padded; ``plens`` selects each
    row's own last real token).
  * **Per-token EOS stopping**, **per-class queues + admission router**,
    **rebalance hysteresis** on slot budgets, and zero host relayout in
    the decode loop.
  * **Bulk prefill** through the decode recurrence, so a prefilled slot is
    bitwise indistinguishable from one that decoded its prompt.

The decode state is updated in place (the reference donates it through
its jitted step).  Exactness contract, as in the reference: the paged
engine's tokens equal the dense engine's when both read the cache through
the gather route (free-but-refreshed lanes decode the same pad streams
through a shared phantom page lane per pod; retired lanes are marked dead
via ``live`` in both engines).

Waiting for later slices: the class-sharded mixed step (never taken on
one card), the energy/EDP parking objectives, engine metrics and the
step-time probe with its ``pod_time_hook`` (the reference's default probe
returns ``None`` while observability is off, so the scheduler's
calibration stays frozen, as it does here), and the fleet surface.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.asymmetric import AsymmetricMesh
from repro_torch.core.schedule import deficit_route
from repro_torch.models import model_zoo as Z
from repro_torch.models import transformer as TX
from repro_torch.observability import trace as T
from repro_torch.runtime.paging import PagePool, PageSpec, SENTINEL, divisor_page_size

# Modeled wall seconds for one slot-row of decode work on a pod of unit
# aggregate throughput; only ratios between pods matter.
MODELED_ROW_S = 1e-3


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; ``cuda`` without a card raises."""

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA card is available "
                           "(pass device='cpu' to run the plain versions)")
    return device


@dataclasses.dataclass(frozen=True)
class Request:
    """One queued generation request."""

    rid: int
    prompt: np.ndarray        # (P,) int32
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    """A finished request: prompt + generated tokens, and where it ran."""

    rid: int
    tokens: np.ndarray        # (P + n_generated,) int32
    prompt_len: int
    slot: int                 # global slot id (pod-major)
    pod: int
    device_class: str
    stop: str = "budget"      # "budget" | "eos"


@dataclasses.dataclass
class EngineStats:
    """Timing/behavior counters (warm-up vs steady state split out)."""

    compile_s: float = 0.0        # first prefill per prompt length + first decode step
    prefill_s: float = 0.0        # steady-state bulk prefill seconds
    decode_s: float = 0.0         # steady-state decode seconds (warm-up excluded)
    decode_steps: int = 0         # steady-state steps counted in decode_s
    tokens: int = 0               # tokens generated in steady-state steps
    admitted: int = 0
    completed: int = 0
    completed_eos: int = 0        # retired by emitting eos_id
    completed_budget: int = 0     # retired by exhausting max_new_tokens
    admission_rounds: int = 0
    admission_deferrals: int = 0  # admissions deferred by page-pool exhaustion
    host_relayouts: int = 0       # structurally zero (requests keep their slot)
    rebalances: int = 0           # slot-budget re-derivations past hysteresis
    energy_j: float = 0.0         # modeled joules burned by decode steps
    modeled_decode_s: float = 0.0 # modeled decode seconds those joules cover
    pod_parks: int = 0            # pods parked by the energy objective
    pod_unparks: int = 0          # pods re-admitted as load ramped

    @property
    def tokens_per_s(self) -> float:
        """Steady-state decode throughput (warm-up excluded)."""

        return self.tokens / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def tokens_per_j(self) -> float:
        return self.tokens / self.energy_j if self.energy_j > 0 else 0.0

    @property
    def modeled_tokens_per_s(self) -> float:
        return self.tokens / self.modeled_decode_s if self.modeled_decode_s > 0 else 0.0

    def snapshot(self) -> dict:
        out = dataclasses.asdict(self)
        out["tokens_per_s"] = round(self.tokens_per_s, 3)
        out["tokens_per_j"] = round(self.tokens_per_j, 3)
        out["modeled_tokens_per_s"] = round(self.modeled_tokens_per_s, 3)
        return out


class ServingEngine:
    """Persistent slot-table serving engine over an :class:`AsymmetricMesh`.

    Parameters
    ----------
    cfg, params : the model (token-in archs only — serving contract).
    asym : the asymmetric mesh (scheduling state; per-class control trees).
    seq_cap : per-slot cache length (prompt + generation must fit).
    slots_per_pod : ``c_max`` — each pod's fixed slot-region size.
    paged : "off" (default) | "auto" | "on" — the paged KV pool.
    page_size : tokens per page; default the min ``block.bm`` across the
        classes' trees, rounded down to a divisor of the cache length.
    pool_pages : physical pages per pod partition (default: every slot's
        full lane plus the phantom lane — never defers).
    eos_id : token id that stops a request mid-stream.
    device : where the params, caches and kernels live (``"cuda"``).
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        asym: AsymmetricMesh,
        *,
        seq_cap: int,
        slots_per_pod: int = 4,
        paged: Union[str, bool] = "off",
        page_size: Optional[int] = None,
        pool_pages: Optional[int] = None,
        eos_id: Optional[int] = None,
        device="cuda",
    ):
        if cfg.embed_inputs or cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the serving engine targets token-in archs")
        if asym.objective != "perf":
            raise ValueError(
                f"objective {asym.objective!r}: the port's engine serves the 'perf' "
                "objective; the energy/EDP parking objectives are not ported yet"
            )
        if isinstance(paged, bool):
            paged = "on" if paged else "off"
        if paged not in ("auto", "on", "off"):
            raise ValueError(f"paged={paged!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.asym = asym
        self.seq_cap = int(seq_cap)
        self.c_max = int(slots_per_pod)
        self.n_pods = asym.n_pods
        self.n_slots = self.n_pods * self.c_max
        self.eos_id = None if eos_id is None else int(eos_id)

        # -- per-class request queues fed by the admission router ----------
        self.queues: list[collections.deque] = [collections.deque() for _ in asym.classes]
        self._routed = [0] * len(asym.classes)
        self._next_rid = 0
        self._pod_class = asym.pod_class_indices()

        # -- host-side slot bookkeeping (the device never sees it) ---------
        self.slot_rid = np.full(self.n_slots, -1, np.int64)     # -1 = free
        self.slot_pos = np.zeros(self.n_slots, np.int64)
        self.slot_remaining = np.zeros(self.n_slots, np.int64)
        self._slot_req: dict[int, Request] = {}
        self._slot_toks: dict[int, list[int]] = {}
        self.budgets = [0] * self.n_pods
        self.completions: list[Completion] = []
        self.stats = EngineStats()
        self._rebalances0 = asym.scheduler.rebalances
        self._active_w = asym.pod_active_watts()
        self._idle_w = asym.pod_idle_watts()
        self._poll_w = asym.pod_poll_watts()
        self._pod_agg = [
            asym.class_of_pod(p).rel_throughput * asym.class_of_pod(p).chips_per_pod
            for p in range(self.n_pods)
        ]
        # Lane liveness: True for busy slots and free lanes refreshed as
        # pad streams at the last admission; False for retired lanes.
        self._live = np.zeros(self.n_slots, bool)
        self._pod_of_row = np.arange(self.n_slots) // self.c_max

        # -- KV storage: dense per-slot lanes or the paged pool ------------
        # The dense family pages (its state is a pure KV cache), so "auto"
        # means on; the families whose state does not page are not ported.
        self.paged = paged != "off"
        self.s_cache = TX.cache_len(cfg, self.seq_cap)
        if self.paged:
            if page_size is None:
                page_size = min(t.block.bm for t in asym.control_trees().values())
            ps = divisor_page_size(self.s_cache, page_size)
            w = self.s_cache // ps
            if pool_pages is None:
                pool_pages = (self.c_max + 1) * w  # every slot plus the phantom lane
            spec = PageSpec(
                page_size=ps, pages_per_slot=w,
                pages_per_pod=int(pool_pages), n_pods=self.n_pods,
            )
            self.pool: Optional[PagePool] = PagePool(spec, self.c_max)
            # One shared phantom lane per pod (row-local archs: the free
            # lanes of a pod write identical values to it).
            self.phantom = self.pool.alloc_phantom()
            self.state = Z.init_decode_state_paged(cfg, spec.n_pages, ps, device=self.device)
        else:
            self.pool = None
            self.phantom = None
            self.state = Z.init_decode_state(cfg, self.n_slots, self.seq_cap, device=self.device)

        self.tokens = torch.zeros((self.n_slots, 1), dtype=torch.int32, device=self.device)
        self._pos = np.zeros(self.n_slots, np.int64)
        self._step_calls = 0
        self._prefill_compiled: set[int] = set()
        self._ctx = asym.execution_context()
        self.prefill_logits: Optional[torch.Tensor] = None
        self._decode = Z.make_decode_fn(cfg)
        self._bulk = Z.bulk_prefill_from_decode(self._decode)

    # -- device programs ----------------------------------------------------

    def _t(self, array, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), dtype=dtype).to(self.device)

    @staticmethod
    def _argmax(logits) -> torch.Tensor:
        # On the bf16 logits, first maximum on ties (as jnp.argmax).
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]

    def _step_program(self, batch, pos):
        with torch.no_grad(), self._ctx:
            logits, self.state = self._decode(self.params, batch, self.state, pos)
            return self._argmax(logits)

    def _prefill_program(self, batch, state, plens):
        pos0 = torch.zeros((self.n_slots,), dtype=torch.int32, device=self.device)
        with torch.no_grad(), self._ctx:
            logits, state = self._bulk(self.params, batch, state, pos0, plens=plens)
            self.prefill_logits = logits  # the latest admission round's (B, 1, V)
            return self._argmax(logits), state

    def _merge(self, fresh, new_tokens, take_new: torch.Tensor):
        """Lanes in ``take_new`` — the admitted slots plus every free
        (phantom) lane — take their freshly prefilled lane wholesale; busy
        slots keep theirs bit for bit.  The slot dim of every leaf is 1."""

        for name, leaf in self.state.items():
            leaf[:, take_new] = fresh[name][:, take_new]
        self.tokens = torch.where(take_new[:, None], new_tokens, self.tokens)

    # -- page-table assembly (paged mode only; host-side, O(B·W)) -----------

    def _step_table(self) -> np.ndarray:
        """The decode step's (B, W) page table: busy slots read their own
        pages, live pad lanes their phantom row, dead lanes SENTINEL."""

        busy = self.slot_rid >= 0
        table = self.phantom[self._pod_of_row].copy()
        table[busy] = self.pool.table[busy]
        table[~busy & ~self._live] = SENTINEL
        return table

    # -- admission router ----------------------------------------------------

    def _class_weights(self) -> np.ndarray:
        rates = np.zeros(len(self.asym.classes), np.float64)
        for pod, ci in enumerate(self._pod_class):
            rates[ci] += self.asym.scheduler.rates[pod]
        return rates

    def submit(self, prompt, max_new_tokens: int, *, route_class: Optional[int] = None) -> int:
        """Queue one request; returns its rid (largest-remainder routing
        over the calibrated per-class throughput shares)."""

        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) + int(max_new_tokens) > self.seq_cap:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new_tokens}) exceeds "
                f"seq_cap={self.seq_cap}"
            )
        if len(prompt) == 0 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens >= 1")
        rid = self._next_rid
        self._next_rid += 1
        if route_class is None:
            route_class = deficit_route(self._class_weights(), self._routed)
        self.queues[route_class].append(
            Request(rid=rid, prompt=prompt, max_new_tokens=int(max_new_tokens))
        )
        self._routed[route_class] += 1
        return rid

    # -- slot-region budgets (resize between steps only) ---------------------

    def _refresh_budgets(self):
        old_budgets = list(self.budgets)
        old_count = self.stats.rebalances
        n_work = int((self.slot_rid >= 0).sum()) + sum(len(q) for q in self.queues)
        self.budgets = self.asym.slot_budgets(self.c_max, n_work)
        self.stats.rebalances = self.asym.scheduler.rebalances - self._rebalances0
        if T.enabled() and self.stats.rebalances > old_count:
            T.instant(
                "engine.rebalance", cat="engine",
                before=old_budgets, after=list(self.budgets),
                n_work=n_work, drift=self.asym.scheduler.drift(),
                rebalances=self.stats.rebalances,
            )

    def _admission_pods(self, ci: int) -> list[int]:
        return [p for p, c in enumerate(self._pod_class) if c == ci]

    def _pod_active(self) -> list[int]:
        act = (self.slot_rid >= 0).reshape(self.n_pods, self.c_max)
        return [int(a.sum()) for a in act]

    def _free_slot(self, pod: int) -> Optional[int]:
        if self._pod_active()[pod] >= self.budgets[pod]:
            return None
        return self._any_free_slot(pod)

    def _any_free_slot(self, pod: int) -> Optional[int]:
        lo = pod * self.c_max
        for s in range(lo, lo + self.c_max):
            if self.slot_rid[s] < 0:
                return s
        return None

    # -- admission (bulk prefill into free slots) -----------------------------

    def admit(self) -> int:
        """Admit queued requests into free budgeted slots; returns count.

        One round takes mixed-length prompts from every queue head, right-
        padded to the round maximum; the prefill runs over the full slot
        table (free lanes see zero prompts — the phantom rows).  Paged:
        every page a request can touch is reserved all-or-nothing first; a
        pod partition that cannot cover the head request defers it.
        """

        self._refresh_budgets()
        busy_before = self.slot_rid >= 0
        if not any(self.queues):
            return 0

        def take(budgeted: bool) -> list[tuple[int, Request]]:
            out = []
            for ci, q in enumerate(self.queues):
                pods = self._admission_pods(ci)
                while q:
                    req = q[0]
                    slot = None
                    for pod in pods:
                        slot = self._free_slot(pod) if budgeted else self._any_free_slot(pod)
                        if slot is not None:
                            break
                    if slot is None:
                        break
                    if self.pool is not None:
                        need = min(len(req.prompt) + req.max_new_tokens, self.s_cache)
                        if not self.pool.alloc(slot, need):
                            self.stats.admission_deferrals += 1
                            break
                    q.popleft()
                    out.append((slot, req))
                    self.slot_rid[slot] = req.rid  # reserve before next _free_slot
            return out

        batch = take(budgeted=True)
        if not batch and not busy_before.any():
            # Starvation guard: progress when nothing is running.
            batch = take(budgeted=False)
        if not batch:
            return 0

        rp = max(len(req.prompt) for _, req in batch)
        prompts = np.zeros((self.n_slots, rp), np.int32)
        plens = np.full(self.n_slots, rp, np.int32)
        for slot, req in batch:
            prompts[slot, : len(req.prompt)] = req.prompt
            plens[slot] = len(req.prompt)
        take_new = ~busy_before

        t0 = time.perf_counter()
        live_all = torch.ones((self.n_slots,), dtype=torch.bool, device=self.device)
        take_new_t = self._t(take_new, torch.bool)
        plens_t = self._t(plens, torch.int32)
        if self.pool is not None:
            table = self.phantom[self._pod_of_row].copy()
            for slot, _ in batch:
                table[slot] = self.pool.table[slot]
            pbatch = {
                "tokens": self._t(prompts, torch.int32),
                "page_table": self._t(table, torch.int32),
                "live": live_all,
            }
            # In place through the page tables: busy slots' rows point at
            # phantom pages, so their live pages are untouched.
            nxt, self.state = self._prefill_program(pbatch, self.state, plens_t)
            self.tokens = torch.where(take_new_t[:, None], nxt, self.tokens)
        else:
            pbatch = {"tokens": self._t(prompts, torch.int32), "live": live_all}
            fresh = Z.init_decode_state(self.cfg, self.n_slots, self.seq_cap, device=self.device)
            nxt, fresh = self._prefill_program(pbatch, fresh, plens_t)
            self._merge(fresh, nxt, take_new_t)
        first = nxt.cpu().numpy()  # blocks; first generated token per lane
        dt = time.perf_counter() - t0
        if rp not in self._prefill_compiled:
            self._prefill_compiled.add(rp)
            self.stats.compile_s += dt
        else:
            self.stats.prefill_s += dt

        self._live[take_new] = True
        self._pos[take_new] = plens[take_new]
        for slot, req in batch:
            self.slot_pos[slot] = len(req.prompt)
            self._slot_req[slot] = req
            self._slot_toks[slot] = [int(first[slot, 0])]
            self.slot_remaining[slot] = req.max_new_tokens - 1
            self.stats.admitted += 1
            if self.eos_id is not None and int(first[slot, 0]) == self.eos_id:
                self._retire(slot, stop="eos")
            elif self.slot_remaining[slot] == 0:
                self._retire(slot, stop="budget")
        self.stats.admission_rounds += 1
        return len(batch)

    def _retire(self, slot: int, stop: str = "budget"):
        req = self._slot_req.pop(slot)
        pod = slot // self.c_max
        self.completions.append(
            Completion(
                rid=req.rid,
                tokens=np.concatenate(
                    [req.prompt, np.asarray(self._slot_toks.pop(slot), np.int32)]
                ),
                prompt_len=len(req.prompt),
                slot=slot,
                pod=pod,
                device_class=self.asym.class_of_pod(pod).name,
                stop=stop,
            )
        )
        self.slot_rid[slot] = -1
        self.slot_remaining[slot] = 0
        self._live[slot] = False
        self.stats.completed += 1
        if stop == "eos":
            self.stats.completed_eos += 1
        else:
            self.stats.completed_budget += 1
        if self.pool is not None:
            self.pool.free_slot(slot)

    # -- steady-state decode ---------------------------------------------------

    def step(self) -> int:
        """One decode step over the whole slot table; returns active count.

        No host relayout: the step consumes the resident token vector, the
        position vector, the lane-liveness mask and (paged) the page table
        assembled from pool state.  Every slot advances (free slots as
        phantom rows).
        """

        active = self.slot_rid >= 0
        n_active = int(active.sum())
        if n_active == 0:
            return 0
        units = self._pod_active_before(active)
        t0 = time.perf_counter()
        batch = {"tokens": self.tokens, "live": self._t(self._live, torch.bool)}
        if self.pool is not None:
            batch["page_table"] = self._t(self._step_table(), torch.int32)
        nxt = self._step_program(batch, self._t(self._pos, torch.int32))
        self.tokens = nxt
        toks = nxt.cpu().numpy()  # blocks: the step's wall time is real
        dt = time.perf_counter() - t0
        if self._step_calls == 0:
            self.stats.compile_s += dt
        else:
            self.stats.decode_s += dt
            self.stats.decode_steps += 1
            self.stats.tokens += n_active
            self._account_energy(units)
        self._step_calls += 1
        self._pos += 1  # every slot ages (phantom rows match one-shot padding)

        for slot in np.nonzero(active)[0]:
            slot = int(slot)
            tok = int(toks[slot, 0])
            self._slot_toks[slot].append(tok)
            self.slot_remaining[slot] -= 1
            if self.eos_id is not None and tok == self.eos_id:
                self._retire(slot, stop="eos")
            elif self.slot_remaining[slot] == 0:
                self._retire(slot, stop="budget")
        return n_active

    def _pod_active_before(self, active_mask: np.ndarray) -> list[int]:
        act = active_mask.reshape(self.n_pods, self.c_max)
        return [int(a.sum()) for a in act]

    def _account_energy(self, units: Sequence[int]):
        """Modeled joules for one steady-state decode step (the reference's
        power-model clock: deterministic, no wall clocks)."""

        span = MODELED_ROW_S * max(
            (u / agg for u, agg in zip(units, self._pod_agg) if agg > 0),
            default=0.0,
        )
        if span <= 0:
            return
        watts = 0.0
        for p, u in enumerate(units):
            if u > 0:
                watts += self._idle_w[p] + (self._active_w[p] - self._idle_w[p]) * u / self.c_max
            else:
                watts += self._poll_w[p]
        self.stats.energy_j += watts * span
        self.stats.modeled_decode_s += span

    # -- KV memory accounting ---------------------------------------------------

    def kv_stats(self) -> dict:
        """KV memory accounting (dense lanes, or the pool's occupancy)."""

        arena = int(sum(x.numel() * x.element_size() for x in self.state.values()))
        if self.pool is None:
            return {"paged": False, "kv_bytes": arena}
        spec = self.pool.spec
        itemsize = self.state["pages_k"].element_size()
        per_tok = 2 * self.cfg.n_layers * self.cfg.n_kv_heads * self.cfg.head_dim
        page_bytes = per_tok * spec.page_size * itemsize
        return {
            "paged": True,
            "page_size": spec.page_size,
            "pages_per_slot": spec.pages_per_slot,
            "n_pages": spec.n_pages,
            "pages_live": self.pool.pages_live,
            "pages_free": self.pool.pages_free,
            "peak_live_pages": self.pool.peak_live,
            "phantom_pages": int(self.phantom.size),
            "page_bytes": page_bytes,
            "peak_kv_bytes": self.pool.peak_live * page_bytes,
            "arena_kv_bytes": arena,
            "dense_kv_bytes": per_tok * self.n_slots * self.s_cache * itemsize,
        }

    # -- driver ----------------------------------------------------------------

    def run(self, *, max_steps: Optional[int] = None) -> list[Completion]:
        """Admit + decode until queues and slots drain; returns the
        completions produced by this call."""

        start = len(self.completions)
        steps = 0
        while True:
            if any(self.queues):
                admitted = self.admit()
                if admitted == 0 and not (self.slot_rid >= 0).any():
                    raise RuntimeError(
                        "admission made no progress with an empty slot table "
                        "(a queued request's page reservation exceeds its pod's "
                        "pool partition?)"
                    )
            if not (self.slot_rid >= 0).any():
                break
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.completions[start:]

    def generate(self, prompts: np.ndarray, gen_len: int) -> np.ndarray:
        """Batch convenience: decode ``prompts`` (B, P) for ``gen_len``
        tokens, routed per the scheduler's chunk table in request order
        (the one-shot path's pod-major placement).  Returns ``(B, P +
        gen_len)`` tokens in submission order."""

        prompts = np.asarray(prompts, np.int32)
        n = prompts.shape[0]
        sizes = self.asym.chunk_table(n).sizes()
        rid_of = {}
        pos = 0
        for pod, size in enumerate(sizes):
            ci = self._pod_class[pod]
            for r in range(pos, pos + size):
                rid_of[self.submit(prompts[r], gen_len, route_class=ci)] = r
            pos += size
        done = self.run()
        out = np.zeros((n, prompts.shape[1] + gen_len), np.int32)
        for c in done:
            if c.rid in rid_of:
                out[rid_of[c.rid], : len(c.tokens)] = c.tokens
        return out


__all__ = ["ServingEngine", "Request", "Completion", "EngineStats", "resolve_device"]
