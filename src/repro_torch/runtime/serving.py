"""Persistent asymmetric serving runtime: slot table + per-class queues.

The port's counterpart of ``repro.runtime.serving.ServingEngine``.  What
carries over:

  * **Fixed pod-major slot table** — ``n_pods × c_max`` decode slots; pod
    *i* owns ``[i·c_max, (i+1)·c_max)``.
  * **Class-sharded mixed step** (``launch.mesh.resolve_pods``) — each
    pod decodes its slot region under its own class's control tree
    (``AsymmetricMesh.class_sharded``): the step, the bulk prefill and
    the merge run per pod on its rows, and the paged arena splits into
    the pods' page partitions, each pod's table holding pod-local page
    ids (``PagePool.localize``).  A rank a pod (a ``torch.distributed``
    world of one rank a pod): every rank runs this engine loop on the
    same submitted requests, allocates the decode state or page partition
    of its own pod only, and all-gathers what the host reads (the
    logits, so the sampled tokens) over the pod group, so every rank's
    slot bookkeeping, admission, parking and completions are identical.
    A stream a pod on one card in one process.  Otherwise the whole slot
    table decodes under the fastest class's tree.
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
  * **Measured straggler feedback** — after every step the
    ``pod_time_hook`` (by default a
    :class:`~repro_torch.observability.probe.StepTimeProbe` timing each
    class's own kernel on the card) feeds per-pod seconds to
    ``asym.observe_step``, so the DAS scheduler re-derives slot budgets
    from measured speed.  The probe is inert while observability is off.
  * **Telemetry** — spans (``engine.prefill``, ``engine.decode_step``,
    ``engine.decode_shard``, page, rebalance and park instants) and the
    engine metric families, recorded only while observability is enabled.
  * **Energy objectives** (``asym.objective`` ``"energy"`` or ``"edp"``) —
    load-adaptive pod parking: at low queue depth the least
    energy-efficient pods (``AsymmetricMesh.pods_by_efficiency``) draw a
    zero slot budget and model gated watts; as load ramps they re-admit.
    Joules are modeled from the class specs' ``PowerModel`` on a
    deterministic clock (``MODELED_ROW_S`` a row), never read from the
    card.  ``perf`` never parks.

The decode state is updated in place (the reference donates it through
its jitted step).  Exactness contract, as in the reference: the paged
engine's tokens equal the dense engine's when both read the cache through
the gather route.  Free-but-refreshed lanes decode the same pad streams
as the dense engine's phantom rows through *phantom pages*: one shared
lane per pod for row-local families (all pad writers are identical), one
private lane per slot for MoE (capacity routing couples the rows of a
group, so pad lanes must own their content as dense lanes do).  Retired
lanes are marked dead via ``live`` in both engines.

The fleet surface (:meth:`ServingEngine.withdraw`, ``export_queued``,
``partial_tokens``, ``calibrated_tps``, ``health``) is what
:class:`repro_torch.runtime.fleet.Fleet` drives: queued requests leave
with the router's counts rolled back, admitted ones run to completion.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.asymmetric import AsymmetricMesh
from repro_torch.core.schedule import deficit_route
from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import resolve_pods
from repro_torch.models import model_zoo as Z
from repro_torch.models import transformer as TX
from repro_torch.observability import metrics as MET
from repro_torch.observability import trace as T
from repro_torch.runtime.paging import PagePool, PageSpec, SENTINEL, divisor_page_size

_M = None


def _metrics():
    """Engine metric families, registered once on first enabled use."""

    global _M
    if _M is None:
        _M = {
            "queue_depth": MET.gauge(
                "engine_queue_depth", "Requests waiting per class queue",
                labels=("device_class",)),
            "slot_occupancy": MET.gauge(
                "engine_slot_occupancy", "Active decode slots per pod",
                labels=("pod",)),
            "admissions": MET.counter(
                "engine_admissions_total", "Requests admitted into slots",
                labels=("device_class",)),
            "tokens": MET.counter(
                "engine_tokens_total", "Tokens generated by decode steps"),
            "tokens_per_s": MET.gauge(
                "engine_tokens_per_s", "Decode throughput EMA (tokens/s)"),
            "step_seconds": MET.histogram(
                "engine_decode_step_seconds", "Decode step wall time"),
            "rebalances": MET.counter(
                "engine_rebalances_total",
                "Slot-budget re-derivations past the drift hysteresis"),
            "kv_pages_free": MET.gauge(
                "engine_kv_pool_pages_free",
                "Unallocated pages in the KV page pool"),
            "kv_pages_live": MET.gauge(
                "engine_kv_pool_pages_live",
                "Allocated pages in the KV page pool"),
            "page_allocs": MET.counter(
                "engine_page_allocs_total",
                "KV pages allocated at admission",
                labels=("device_class",)),
            "modeled_watts": MET.gauge(
                "engine_modeled_watts",
                "Modeled power draw over the last decode step (W)"),
            "pods_parked": MET.gauge(
                "engine_pods_parked",
                "Pods currently parked (power-gated) by the energy objective"),
        }
    return _M


# Modeled wall seconds for one slot-row of decode work on a pod of unit
# aggregate throughput; only ratios between pods matter.
MODELED_ROW_S = 1e-3


def _hook_takes_units(hook) -> bool:
    """Does a pod_time_hook accept ``(step, pod_units)`` (new style) or
    just ``(step)`` (the legacy signature)?"""

    try:
        sig = inspect.signature(hook)
    except (TypeError, ValueError):
        return False
    n = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n += 1
        elif p.kind == p.VAR_POSITIONAL:
            return True
    return n >= 2


def _paged_supported(cfg: ArchConfig) -> tuple[bool, str]:
    """Can this arch's decode state page?  (pure KV-cache families only)"""

    if TX.block_kind(cfg) == "mamba":
        return False, "recurrent (Mamba2) state has no KV pages to allocate"
    if cfg.shared_attn_every:
        return False, "the hybrid shared-attention cache is not paged"
    return True, ""


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _merge_lanes(old: dict, new: dict, take_new: torch.Tensor) -> None:
    """Copy the lanes in ``take_new`` of ``new`` into ``old``, in place.
    The slot dim of every leaf of the state tree (KV lanes, the Mamba2
    state, the hybrid's shared-block cache) is 1."""

    for name, leaf in old.items():
        if isinstance(leaf, dict):
            _merge_lanes(leaf, new[name], take_new)
        else:
            leaf[:, take_new] = new[name][:, take_new]


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
    class_sharded : "auto" (default) | "on" | "off", resolved by
        :func:`~repro_torch.launch.mesh.resolve_pods`: "on" runs the
        mixed step (more than one class), a rank a pod under a world of
        ``asym.n_pods`` ranks, else ``asym.n_pods`` pods sharing
        ``device`` as streams; "auto" takes it only where each pod's rank
        has a card of its own; "off" never.
    mesh : the pod mesh when the caller has resolved it already
        (``launch.serve`` does, before it makes the weights); it replaces
        ``class_sharded``.
    paged : "off" (default) | "auto" | "on" — the paged KV pool.  "auto"
        pages every pure KV-cache family and stays dense where paging is
        unsupported (Mamba2 / hybrid state); "on" raises there.
    page_size : tokens per page; default the min ``block.bm`` across the
        classes' trees, rounded down to a divisor of the cache length.
    pool_pages : physical pages per pod partition (default: every slot's
        full lane plus the phantom lanes — never defers).
    eos_id : token id that stops a request mid-stream.
    device : where the params, caches and kernels live (``"cuda"``).
    pod_time_hook : feeds the scheduler's straggler calibration.  The
        default ``"auto"`` installs a
        :class:`~repro_torch.observability.probe.StepTimeProbe` that times
        each class's kernel at ``(128, d_model, d_model)`` on the engine's
        device, but only while observability is enabled (otherwise it
        returns ``None`` and the calibration stays frozen).  A callable
        may take ``(step)`` or ``(step, pod_units)`` and may return
        ``None`` to skip a step; ``None`` disables the feedback.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        asym: AsymmetricMesh,
        *,
        seq_cap: int,
        slots_per_pod: int = 4,
        class_sharded: str = "auto",
        paged: Union[str, bool] = "off",
        page_size: Optional[int] = None,
        pool_pages: Optional[int] = None,
        eos_id: Optional[int] = None,
        device="cuda",
        pod_time_hook: Union[str, None, Callable[..., Optional[Sequence[float]]]] = "auto",
        mesh=None,
    ):
        if cfg.embed_inputs or cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the serving engine targets token-in archs")
        if isinstance(paged, bool):
            paged = "on" if paged else "off"
        if paged not in ("auto", "on", "off"):
            raise ValueError(f"paged={paged!r}")
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else resolve_pods(class_sharded, asym, self.device)
        self.mixed = self.mesh is not None
        # A rank a pod: this rank holds its pod's state and runs its rows.
        self.ranks = hasattr(self.mesh, "coord")
        self.pod = self.mesh.coord("pod") if self.ranks else None
        if self.ranks:
            self.device = self.mesh.device
        self.cfg = cfg
        self.params = params
        self.asym = asym
        self.seq_cap = int(seq_cap)
        self.c_max = int(slots_per_pod)
        self.n_pods = asym.n_pods
        self.n_slots = self.n_pods * self.c_max
        self.eos_id = None if eos_id is None else int(eos_id)
        if pod_time_hook == "auto":
            from repro_torch.observability.probe import StepTimeProbe

            pod_time_hook = StepTimeProbe(
                asym, probe_shape=(128, cfg.d_model, cfg.d_model), device=self.device
            )
        self.pod_time_hook = pod_time_hook
        self._hook_takes_units = (
            _hook_takes_units(pod_time_hook) if pod_time_hook is not None else False
        )
        self._tps_ema: Optional[float] = None

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
        # -- load-adaptive parking + modeled power (energy objective) ------
        # Parked pods draw a zero slot budget and model gated watts; the
        # ``perf`` objective never parks.
        self._parked: set[int] = set()
        self._active_w = asym.pod_active_watts()
        self._idle_w = asym.pod_idle_watts()
        self._poll_w = asym.pod_poll_watts()
        self._gated_w = asym.pod_gated_watts()
        self._pod_agg = [
            asym.class_of_pod(p).rel_throughput * asym.class_of_pod(p).chips_per_pod
            for p in range(self.n_pods)
        ]
        # Lane liveness: True for busy slots and free lanes refreshed as
        # pad streams at the last admission; False for retired lanes.
        self._live = np.zeros(self.n_slots, bool)
        self._pod_of_row = np.arange(self.n_slots) // self.c_max
        self._state_rows = self.c_max if self.ranks else self.n_slots

        # -- KV storage: dense per-slot lanes or the paged pool ------------
        supported, why = _paged_supported(cfg)
        if paged == "on" and not supported:
            raise ValueError(f"paged='on': {cfg.name}: {why}")
        self.paged = paged == "on" or (paged == "auto" and supported)
        self.s_cache = TX.cache_len(cfg, self.seq_cap) if supported else self.seq_cap
        if self.paged:
            if page_size is None:
                page_size = min(t.block.bm for t in asym.control_trees().values())
            ps = divisor_page_size(self.s_cache, page_size)
            w = self.s_cache // ps
            # MoE capacity routing couples batch rows: pad lanes must own
            # their phantom content as dense lanes do (one lane per slot);
            # row-local families share one phantom lane per pod.
            per_slot_phantom = TX.block_kind(cfg) == "attn_moe"
            phantom_per_pod = self.c_max if per_slot_phantom else 1
            if pool_pages is None:
                pool_pages = (self.c_max + phantom_per_pod) * w
            spec = PageSpec(
                page_size=ps, pages_per_slot=w,
                pages_per_pod=int(pool_pages), n_pods=self.n_pods,
            )
            self.pool: Optional[PagePool] = PagePool(spec, self.c_max)
            self.phantom = self.pool.alloc_phantom(per_slot=per_slot_phantom)
            self._phantom_rows_idx = (
                np.arange(self.n_slots) if per_slot_phantom else self._pod_of_row
            )
            pages = spec.pages_per_pod if self.ranks else spec.n_pages
            self.state = Z.init_decode_state_paged(cfg, pages, ps, device=self.device)
        else:
            self.pool = None
            self.phantom = None
            self.state = Z.init_decode_state(cfg, self._state_rows, self.seq_cap,
                                             device=self.device)

        self.tokens = torch.zeros((self.n_slots, 1), dtype=torch.int32, device=self.device)
        self._pos = np.zeros(self.n_slots, np.int64)
        self._step_calls = 0
        self._prefill_compiled: set[int] = set()
        self._ctx = asym.execution_context()
        self.prefill_logits: Optional[torch.Tensor] = None
        self._build()

    def _build(self):
        """The decode step, class-sharded over the pods' slot regions when
        mixed, and the bulk prefill through it (on ranks, the bulk prefill
        of the rank's own rows, its logits gathered once)."""

        decode, merge, bulk = Z.make_decode_fn(self.cfg), _merge_lanes, None
        if self.mixed:
            from repro_torch.distributed.sharding import PodSplit, pod_decode_specs

            keys = ("tokens", "page_table", "live") if self.paged else ("tokens", "live")
            in_specs, out_specs = pod_decode_specs(self.state, batch_keys=keys, held=self.ranks)
            sspecs = in_specs[2]
            if self.ranks:  # (params, batch, state, pos0, plens)
                bulk = self.asym.class_sharded(Z.bulk_prefill_from_decode(decode), mesh=self.mesh,
                                               in_specs=in_specs + (PodSplit(0),),
                                               out_specs=out_specs)
            decode = self.asym.class_sharded(decode, mesh=self.mesh, in_specs=in_specs,
                                             out_specs=out_specs)
            merge = self.asym.class_sharded(merge, mesh=self.mesh, out_specs=None,
                                            in_specs=(sspecs, sspecs, PodSplit(0)))
            self.provenance = decode.provenance
        else:
            self.provenance = None
        self._decode = decode
        self._bulk = bulk or Z.bulk_prefill_from_decode(decode)
        self._merge_state = merge

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
            logits, state = self._bulk(self.params, batch, state, pos0, plens)
            self.prefill_logits = logits  # the latest admission round's (B, 1, V)
            return self._argmax(logits), state

    def _merge(self, fresh, new_tokens, take_new: torch.Tensor):
        """Lanes in ``take_new`` — the admitted slots plus every free
        (phantom) lane — take their freshly prefilled lane wholesale; busy
        slots keep theirs bit for bit (per pod on its slot region under
        the mixed step)."""

        with torch.no_grad():
            self._merge_state(self.state, fresh, take_new)
        self.tokens = torch.where(take_new[:, None], new_tokens, self.tokens)

    # -- page-table assembly (paged mode only; host-side, O(B·W)) -----------

    def _localize(self, table: np.ndarray) -> np.ndarray:
        """Pod-local page ids under the mixed step: each pod's shard of the
        arena is its page partition."""

        if not self.mixed:
            return table
        return self.pool.localize(table, self._pod_of_row)

    def _step_table(self) -> np.ndarray:
        """The decode step's (B, W) page table: busy slots read their own
        pages, live pad lanes their phantom row, dead lanes SENTINEL."""

        busy = self.slot_rid >= 0
        table = self.phantom[self._phantom_rows_idx].copy()
        table[busy] = self.pool.table[busy]
        table[~busy & ~self._live] = SENTINEL
        return self._localize(table)

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

    # -- fleet surface: drain/export, health, calibration --------------------

    def withdraw(self, rid: int) -> Optional[Request]:
        """Remove one *queued* (not yet admitted) request; returns it, or
        ``None`` if ``rid`` is not queued.  The router's cumulative count
        is rolled back, so future routing reflects only the kept work."""

        for ci, q in enumerate(self.queues):
            for i, req in enumerate(q):
                if req.rid == rid:
                    del q[i]
                    self._routed[ci] -= 1
                    return req
        return None

    def export_queued(self) -> list[Request]:
        """Drain every class queue in submission (rid) order, rolling the
        router's counts back as :meth:`withdraw` does (the fleet's
        migration path off a saturated, parked or dead engine)."""

        out: list[Request] = []
        for ci, q in enumerate(self.queues):
            while q:
                out.append(q.popleft())
                self._routed[ci] -= 1
        out.sort(key=lambda r: r.rid)
        return out

    def partial_tokens(self, rid: int) -> Optional[np.ndarray]:
        """Tokens generated so far for an in-flight request (else ``None``)."""

        for slot, req in self._slot_req.items():
            if req.rid == rid:
                return np.asarray(self._slot_toks[slot], np.int32)
        return None

    def calibrated_tps(self) -> float:
        """Aggregate calibrated throughput (the sum of the per-pod EMA
        rates): the engine's ``rel_throughput`` in a fleet."""

        return float(np.sum(self.asym.scheduler.rates))

    def health(self) -> dict:
        """The engine health surface a fleet front polls each tick (on
        ranks also this rank's pod, its active slots and its rate; the
        rest is the whole engine's, the same on every rank)."""

        out = {
            "queued": sum(len(q) for q in self.queues),
            "active": int((self.slot_rid >= 0).sum()),
            "slots": self.n_slots,
            "parked_pods": sorted(self._parked),
            "calibrated_tps": self.calibrated_tps(),
            "completed": self.stats.completed,
            "admission_deferrals": self.stats.admission_deferrals,
        }
        if self.ranks:
            out.update(pod=self.pod, pod_active=self._pod_active()[self.pod],
                       pod_tps=float(self.asym.scheduler.rates[self.pod]))
        return out

    # -- slot-region budgets (resize between steps only) ---------------------

    def _refresh_budgets(self):
        old_budgets = list(self.budgets)
        old_count = self.stats.rebalances
        n_work = int((self.slot_rid >= 0).sum()) + sum(len(q) for q in self.queues)
        self._update_parking(n_work)
        self.budgets = self.asym.slot_budgets(
            self.c_max, n_work, parked=sorted(self._parked)
        )
        self.stats.rebalances = self.asym.scheduler.rebalances - self._rebalances0
        if T.enabled() and self.stats.rebalances > old_count:
            _metrics()["rebalances"].inc(self.stats.rebalances - old_count)
            T.instant(
                "engine.rebalance", cat="engine",
                before=old_budgets, after=list(self.budgets),
                n_work=n_work, drift=self.asym.scheduler.drift(),
                rebalances=self.stats.rebalances,
            )

    # -- load-adaptive pod parking (energy objective only) --------------------

    def _update_parking(self, n_work: int):
        """Park/unpark pods against the offered load, with hysteresis.

        At low queue depth the least energy-efficient pods park (zero slot
        budget, modeled gated watts); as offered load ramps past the
        unparked capacity, parked pods re-admit, most efficient first.  A
        pod parks only when the load sits below the *remaining* capacity by
        the scheduler's drift threshold ``h`` (``n_work <= cap·(1-h)``) and
        unparks as soon as capacity falls short; the gap prevents thrash.
        The most efficient pod never parks, and requests on a freshly
        parked pod run to completion (parking only refuses admissions).
        ``perf`` never parks.
        """

        if self.asym.objective == "perf" or self.n_pods < 2:
            return
        h = self.asym.scheduler.rebalance_threshold
        order = self.asym.pods_by_efficiency()  # most efficient first
        for p in order:
            if (self.n_pods - len(self._parked)) * self.c_max >= n_work:
                break
            if p in self._parked:
                self._unpark(p, n_work)
        for p in reversed(order):
            if p in self._parked:
                continue
            if len(self._parked) >= self.n_pods - 1:
                break
            remaining = (self.n_pods - len(self._parked) - 1) * self.c_max
            if n_work <= remaining * (1.0 - h):
                self._park(p, n_work)
            else:
                break

    def _park(self, pod: int, n_work: int):
        self._parked.add(pod)
        self.stats.pod_parks += 1
        self._note_parking("engine.pod_park", pod, n_work)

    def _unpark(self, pod: int, n_work: int):
        self._parked.discard(pod)
        self.stats.pod_unparks += 1
        self._note_parking("engine.pod_unpark", pod, n_work)

    def _note_parking(self, name: str, pod: int, n_work: int):
        if T.enabled():
            _metrics()["pods_parked"].set(len(self._parked))
            T.instant(
                name, cat="engine", pod=pod,
                device_class=self.asym.class_of_pod(pod).name,
                n_work=n_work, parked=sorted(self._parked),
            )

    @property
    def parked_pods(self) -> list[int]:
        """The pods the energy objective has parked, ascending."""

        return sorted(self._parked)

    def _admission_pods(self, ci: int) -> list[int]:
        """The pods class ``ci``'s queue may admit into: the class's
        unparked pods; when the whole class is parked, the unparked pods
        of other classes, most efficient first (the queue must not starve
        behind a parked class, nor defeat parking by admitting into it)."""

        pods = [
            p for p, c in enumerate(self._pod_class)
            if c == ci and p not in self._parked
        ]
        if not pods:
            pods = [
                p for p in self.asym.pods_by_efficiency() if p not in self._parked
            ]
        return pods

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
                        self._note_page_alloc(slot, need)
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
            table = self.phantom[self._phantom_rows_idx].copy()
            for slot, _ in batch:
                table[slot] = self.pool.table[slot]
            pbatch = {
                "tokens": self._t(prompts, torch.int32),
                "page_table": self._t(self._localize(table), torch.int32),
                "live": live_all,
            }
            # In place through the page tables: busy slots' rows point at
            # phantom pages, so their live pages are untouched.
            nxt, self.state = self._prefill_program(pbatch, self.state, plens_t)
            self.tokens = torch.where(take_new_t[:, None], nxt, self.tokens)
        else:
            pbatch = {"tokens": self._t(prompts, torch.int32), "live": live_all}
            fresh = Z.init_decode_state(self.cfg, self._state_rows, self.seq_cap,
                                        device=self.device)
            nxt, fresh = self._prefill_program(pbatch, fresh, plens_t)
            self._merge(fresh, nxt, take_new_t)
        first = nxt.cpu().numpy()  # blocks; first generated token per lane
        dt = time.perf_counter() - t0
        compiling = rp not in self._prefill_compiled
        if compiling:
            self._prefill_compiled.add(rp)
            self.stats.compile_s += dt
        else:
            self.stats.prefill_s += dt
        if T.enabled():
            self._record_admit_telemetry(t0, dt, rp, batch, compiling)

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
            freed = self.pool.free_slot(slot)
            if T.enabled() and freed:
                m = _metrics()
                m["kv_pages_free"].set(self.pool.pages_free)
                m["kv_pages_live"].set(self.pool.pages_live)
                T.instant(
                    "engine.page_free", cat="engine", slot=slot, pages=freed,
                    stop=stop, pages_live=self.pool.pages_live,
                    pages_free=self.pool.pages_free,
                )

    def _note_page_alloc(self, slot: int, n_tokens: int):
        if not T.enabled():
            return
        m = _metrics()
        pages = self.pool.spec.pages_for(n_tokens)
        name = self.asym.class_of_pod(slot // self.c_max).name
        m["page_allocs"].labels(device_class=name).inc(pages)
        m["kv_pages_free"].set(self.pool.pages_free)
        m["kv_pages_live"].set(self.pool.pages_live)
        T.instant(
            "engine.page_alloc", cat="engine", slot=slot, pages=pages,
            pages_live=self.pool.pages_live, pages_free=self.pool.pages_free,
        )

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

        if T.enabled():
            self._record_step_telemetry(t0, dt, n_active, active, self._step_calls - 1)

        # Straggler feedback: per-pod timings re-calibrate the scheduler
        # (budgets re-derive only at admission, past hysteresis).  One step
        # yields one wall time, not per-pod times, so the signal comes only
        # from the hook (the default probe measures each class's per-row
        # cost, and returns None while observability is off).
        if self.pod_time_hook is not None:
            times = (
                self.pod_time_hook(self._step_calls - 1, units)
                if self._hook_takes_units
                else self.pod_time_hook(self._step_calls - 1)
            )
            if self.ranks:  # each rank's own pod's time, the same vector on every rank
                times = C.pod_values(None if times is None else times[self.pod], self.mesh)
            if times is not None:
                self.asym.observe_step(units, list(times))
        return n_active

    def _pod_active_before(self, active_mask: np.ndarray) -> list[int]:
        act = active_mask.reshape(self.n_pods, self.c_max)
        return [int(a.sum()) for a in act]

    def _account_energy(self, units: Sequence[int]):
        """Modeled joules for one steady-state decode step.

        The step's modeled span is the slowest pod's row count over its
        aggregate throughput (x ``MODELED_ROW_S``).  Per-pod draw over the
        span: a pod with rows interpolates idle to active by occupancy; an
        empty parked pod draws gated watts; an empty unparked pod polls.
        Deterministic (no wall clocks), so the figures are host-independent.
        """

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
            elif p in self._parked:
                watts += self._gated_w[p]
            else:
                watts += self._poll_w[p]
        self.stats.energy_j += watts * span
        self.stats.modeled_decode_s += span
        if T.enabled():
            _metrics()["modeled_watts"].set(watts)

    # -- KV memory accounting ---------------------------------------------------

    def kv_stats(self) -> dict:
        """KV memory accounting (dense lanes, or the pool's occupancy).  On
        ranks the state's bytes are the whole engine's (every pod's state
        has this rank's shape), and ``pod`` / ``pod_kv_bytes`` this rank's
        own."""

        arena = int(sum(x.numel() * x.element_size() for x in _leaves(self.state)))
        own = {}
        if self.ranks:
            own = {"pod": self.pod, "pod_kv_bytes": arena}
            arena *= self.n_pods
        if self.pool is None:
            return {"paged": False, "kv_bytes": arena, **own}
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
            **own,
        }

    # -- telemetry (every method below only runs while tracing is enabled) ----

    def _shard_tags(self) -> list[dict]:
        """Per-class provenance tags for decode-shard spans: device class,
        backend variant, block_source, and the pods running it (every pod
        under the fastest class's tree off the mixed step)."""

        by_class: dict[str, dict] = {}
        if self.mixed:
            for p in self.provenance:
                t = by_class.setdefault(p.device_class, {
                    "device_class": p.device_class, "backend": p.backend,
                    "block_source": p.block_source, "pods": []})
                t["pods"].append(p.pod)
        else:
            ctx = self._ctx
            by_class[ctx.device_class] = {
                "device_class": ctx.device_class, "backend": ctx.backend(),
                "block_source": ctx.tree.block_source, "pods": list(range(self.n_pods))}
        return list(by_class.values())

    def _record_step_telemetry(self, t0, dt, n_active, active_mask, step_idx):
        m = _metrics()
        T.complete("engine.decode_step", t0, dt, cat="engine",
                   step=step_idx, active=n_active)
        per_pod = self._pod_active_before(active_mask)
        for tags in self._shard_tags():
            T.complete("engine.decode_shard", t0, dt, cat="engine",
                       device_class=tags["device_class"], backend=tags["backend"],
                       block_source=tags["block_source"],
                       slots=int(sum(per_pod[p] for p in tags["pods"])))
        for ci, c in enumerate(self.asym.classes):
            m["queue_depth"].labels(device_class=c.name).set(len(self.queues[ci]))
        for pod, occ in enumerate(per_pod):
            m["slot_occupancy"].labels(pod=str(pod)).set(occ)
        m["tokens"].inc(n_active)
        m["step_seconds"].observe(dt)
        if dt > 0:
            inst = n_active / dt
            self._tps_ema = inst if self._tps_ema is None else 0.8 * self._tps_ema + 0.2 * inst
            m["tokens_per_s"].set(self._tps_ema)

    def _record_admit_telemetry(self, t0, dt, plen, batch, compiling):
        m = _metrics()
        T.complete("engine.prefill", t0, dt, cat="engine", plen=plen,
                   admitted=len(batch), compiled=compiling)
        per_class: dict[str, int] = {}
        for slot, _ in batch:
            name = self.asym.class_of_pod(slot // self.c_max).name
            per_class[name] = per_class.get(name, 0) + 1
        for name, n in per_class.items():
            m["admissions"].labels(device_class=name).inc(n)
        for ci, c in enumerate(self.asym.classes):
            m["queue_depth"].labels(device_class=c.name).set(len(self.queues[ci]))

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
