"""Asymmetric device-class abstraction (the port's ``repro.core.asymmetric``).

The paper's big.LITTLE clusters become *device classes*: groups of pods
with unequal sustained throughput.  On one H100 the little class is a
modeled spec on the same card (half the shared memory, half the peak and
bandwidth — ``blocking.H100_LITTLE``).  :meth:`AsymmetricMesh.class_sharded`
runs each pod's shard of a step under its own class's control tree, the
pods as CUDA streams on the one card (``core.execution.class_sharded``).
:meth:`AsymmetricMesh.from_calibration` replaces the typed ratios with
calibrated ones (the cost model, or the step-time probe's measurements).

:class:`AsymmetricMesh` couples the classes with a per-class performance
model and the schedulers of :mod:`repro_torch.core.schedule`:

  * ``chunk table``   — per-pod batch share (rows of the paper's Loop 3),
  * ``batch layout``  — ``(n_pods, c_max, ...)`` plus per-pod valid counts,
  * ``slot budgets``  — the serving engine's per-pod admission budgets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import blocking as B
from repro_torch.core import schedule as S


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """One throughput class of accelerators (the analogue of a cluster)."""

    name: str
    n_pods: int = 1
    chips_per_pod: int = 1
    peak_flops: float = 989e12      # per chip, bf16
    hbm_bw: float = 3.35e12         # per chip
    ici_bw: float = 450e9           # per link (NVLink, each way)
    # Sustained throughput relative to the fastest class (the paper's ratio
    # knob normalizes the A15 to 1).  Calibrated online by DynamicScheduler.
    rel_throughput: float = 1.0
    spec: B.HopperClassSpec = B.H100


# The motivating heterogeneous fleet: a full-rate class plus a class at
# 0.25 relative sustained throughput — the analogue of the paper's 9.6 vs
# 2.4 GFLOPS clusters (ratio 4).  The little class's spec is the modeled
# half-budget Hopper class; both specs read the card's shared memory and
# SM count when a card is present.
def biglittle_classes(chips_per_pod: int = 1) -> list[DeviceClass]:
    big_spec = B.hopper_spec()
    little_spec = B.hopper_spec(little=True)
    big = DeviceClass(
        name="big", chips_per_pod=chips_per_pod, rel_throughput=1.0,
        peak_flops=big_spec.peak_flops, hbm_bw=big_spec.hbm_bw, spec=big_spec,
    )
    little = DeviceClass(
        name="little",
        chips_per_pod=chips_per_pod,
        peak_flops=little_spec.peak_flops,
        hbm_bw=little_spec.hbm_bw,
        rel_throughput=0.25,
        spec=little_spec,
    )
    return [big, little]


@dataclasses.dataclass
class BatchLayout:
    """Padded per-pod batch layout for the asymmetric SPMD step."""

    global_batch: int
    sizes: list[int]          # valid rows per pod, sum == global_batch
    c_max: int                # padded per-pod rows
    mask: np.ndarray          # (n_pods, c_max) float32 validity mask

    @property
    def padded_batch(self) -> int:
        return len(self.sizes) * self.c_max


class AsymmetricMesh:
    """Couples device classes with the paper's schedulers.

    This object is pure scheduling state — it never touches a device — so
    it can be built anywhere (tests, launcher).
    """

    def __init__(
        self,
        classes: Sequence[DeviceClass],
        *,
        strategy: str = "ca-das",
        batch_tile: int = 8,
        init_ratio: Optional[float] = None,
        tree_shape: tuple[int, int, int] = (1024, 1024, 1024),
        backend: str = "auto",
        objective: str = "perf",
    ):
        if strategy not in ("sss", "sas", "ca-sas", "das", "ca-das"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.classes = list(classes)
        self.strategy = strategy
        self.batch_tile = batch_tile
        self.tree_shape = tuple(tree_shape)  # canonical GEMM shape for the trees
        self.backend = backend
        self.objective = S.validate_objective(objective)
        self._trees: dict[tuple[int, int, int], dict] = {}
        self.calibration = None  # set by from_calibration()
        self.n_pods = sum(c.n_pods for c in self.classes)
        # Per-pod throughput weights (a class may own several pods).
        self._pod_class = [
            (ci, c) for ci, c in enumerate(self.classes) for _ in range(c.n_pods)
        ]
        ratios = [c.rel_throughput for _, c in self._pod_class]
        if init_ratio is not None and len(ratios) == 2:
            ratios = [init_ratio, 1.0]
        workers = [c.chips_per_pod for _, c in self._pod_class]
        tiles = self._tiles()
        self.scheduler = S.DynamicScheduler(
            self.n_pods,
            init_ratios=ratios,
            workers=workers,
            tiles=tiles if strategy in ("ca-sas", "ca-das") else [batch_tile] * self.n_pods,
            objective=objective,
            powers=self.pod_active_watts() if objective != "perf" else None,
        )

    @classmethod
    def from_calibration(
        cls,
        classes: Sequence[DeviceClass],
        calibration=None,
        *,
        probe_shape: tuple[int, int, int] = (1024, 1024, 1024),
        backend: str = "cost-model",
        measurements=None,
        **kwargs,
    ) -> "AsymmetricMesh":
        """Build a mesh whose per-class throughputs are *measured*, not typed.

        Runs (or accepts) a :class:`repro_torch.tuning.ratio.Calibration`
        over ``classes`` and replaces each class's hand-set
        ``rel_throughput`` with the calibrated ratio — the paper's Section
        5.2.2 knob, set empirically.  With ``backend="wallclock"`` pass
        ``measurements`` (per-class
        :class:`~repro_torch.tuning.ratio.ClassMeasurement` records, e.g.
        the step-time probe's per-class seconds): one card cannot
        wallclock-compare heterogeneous class specs itself.  The result
        seeds ``DynamicScheduler.init_ratios``; the between-steps feedback
        keeps refining from there.
        """

        from repro_torch.tuning.ratio import calibrate_class_ratios

        if calibration is None:
            calibration = calibrate_class_ratios(
                classes,
                probe_shape=probe_shape,
                backend=backend,
                measurements=measurements,
            )
        if len(calibration.ratios) != len(classes):
            raise ValueError(
                f"calibration covers {len(calibration.ratios)} classes, "
                f"got {len(classes)}"
            )
        calibrated = [
            dataclasses.replace(c, rel_throughput=float(r))
            for c, r in zip(classes, calibration.ratios)
        ]
        mesh = cls(calibrated, **kwargs)
        mesh.calibration = calibration
        return mesh

    def _tiles(self) -> list[int]:
        # CA: each pod's chunk aligns to its own microbatch tile — a slower
        # class gets a proportionally *smaller* stride, mirroring the
        # per-class m_c of the paper (A15 m_c=152 vs A7 m_c=32).  The
        # fastest class keeps the full batch_tile; others scale down by
        # their relative throughput, floored at 1.
        top = max(cc.rel_throughput for cc in self.classes)
        out = []
        for _, c in self._pod_class:
            out.append(max(1, int(round(self.batch_tile * c.rel_throughput / top))))
        return out

    # -- execution contexts (per-class control trees) ---------------------

    def _primary_class(self) -> DeviceClass:
        """The fastest class (ties broken by listed order) — the anchor."""

        return max(self.classes, key=lambda c: c.rel_throughput)

    # -- per-shard class lookup (the pod→class mapping) -------------------

    def pod_class_indices(self) -> list[int]:
        """Class index (into ``self.classes``) per pod — pod→class map."""

        return [ci for ci, _ in self._pod_class]

    def class_of_pod(self, pod: int) -> DeviceClass:
        """The device class that owns pod ``pod``."""

        return self._pod_class[pod][1]

    def control_trees(self, shape: Optional[tuple[int, int, int]] = None) -> dict:
        """Per-class control trees for ``shape`` (default: ``tree_shape``).

        Built once per shape and memoized.  The *fastest* class anchors
        the shared-B-panel ``bk`` regardless of listing order (classes are
        sorted by throughput before ``build_control_trees``, whose first
        entry is the anchor) — so the primary class never trains with
        panel strides constrained by a slow class's VMEM.  Each class's
        block config resolves through the tuning cache for *its own* core
        spec, falling back to the analytical derivation.
        """

        from repro_torch.core import execution as X
        from repro_torch.core.control_tree import build_control_trees

        shape = tuple(shape) if shape is not None else self.tree_shape
        trees = self._trees.get(shape)
        if trees is None:
            ordered = sorted(
                self.classes, key=lambda c: -c.rel_throughput
            )  # stable: listed order breaks ties
            specs = {c.name: c.spec for c in ordered}
            trees = build_control_trees(
                specs, *shape, backend=X.resolve_backend(self.backend)
            )
            self._trees[shape] = trees
        return trees

    def class_backends(
        self, shape: Optional[tuple[int, int, int]] = None
    ) -> dict[str, str]:
        """Resolved micro-kernel variant per class (paper §5.3).

        The per-class trees may name *different* ``execution.BACKENDS``
        entries — e.g. ``big → "cuda"`` and ``little → "cuda_lean"`` when
        only the one-stage ring holds the shared panel in little's shared
        memory.
        """

        from repro_torch.core import execution as X

        return {
            name: X.resolve_backend(tree.backend)
            for name, tree in self.control_trees(shape).items()
        }

    def execution_context(
        self,
        class_name: Optional[str] = None,
        *,
        shape: Optional[tuple[int, int, int]] = None,
    ):
        """An :class:`~repro_torch.core.execution.ExecutionContext` for one class.

        ``class_name=None`` binds the fastest class (ties broken by listed
        order) — the tree the single SPMD program runs under when the mesh
        is homogeneous-per-program.  Activate it around the calls::

            with mesh.execution_context("little"):
                y = ops.gemm(x, w)   # little's tree governs
        """

        from repro_torch.core.execution import ExecutionContext

        trees = self.control_trees(shape)
        if class_name is None:
            class_name = self._primary_class().name  # same anchor as the trees
        if class_name not in trees:
            raise KeyError(
                f"unknown device class {class_name!r}; have {sorted(trees)}"
            )
        return ExecutionContext(device_class=class_name, tree=trees[class_name])

    def class_contexts(self, *, shape: Optional[tuple[int, int, int]] = None):
        """One :class:`ExecutionContext` per class, in ``classes`` order
        (the order ``pod_class_indices`` indexes into)."""

        from repro_torch.core.execution import ExecutionContext

        trees = self.control_trees(shape)
        return [
            ExecutionContext(device_class=c.name, tree=trees[c.name])
            for c in self.classes
        ]

    def class_sharded(
        self,
        fn,
        *,
        mesh,
        in_specs,
        out_specs,
        axis: str = "pod",
        shape: Optional[tuple[int, int, int]] = None,
        epilogue=None,
    ):
        """Wrap ``fn`` so each pod shard runs under its own class's tree.

        The one-card realization of the paper's CA-SAS (§5.3): one step in
        which every pod executes under *its* class's execution context —
        big pods under big's control tree, LITTLE pods under little's,
        each on its own CUDA stream — instead of the whole step running
        under a single primary-class context.

        ``mesh`` is the :class:`~repro_torch.launch.mesh.PodMesh` whose
        ``axis`` indexes the pods (``mesh.shape[axis]`` must equal
        ``n_pods``).  Falls back to the single-context wrapper (bitwise
        ``execution_context()`` activation, no pods) when the mesh has one
        class, when the mesh lacks the pod axis, or when the axis size is
        1.  See :func:`repro_torch.core.execution.class_sharded`.
        """

        from repro_torch.core import execution as X
        from repro_torch.distributed.sharding import pod_class_indices

        contexts = self.class_contexts(shape=shape)
        single = (
            len(contexts) == 1
            or axis not in getattr(mesh, "axis_names", ())
            or mesh.shape[axis] == 1
        )
        if single:
            primary = self._primary_class().name
            ctx = next(c for c in contexts if c.device_class == primary)
            contexts, pod_class = [ctx], [0] * self.n_pods
        else:
            pod_class = pod_class_indices(self)
        return X.class_sharded(
            fn,
            mesh=mesh,
            contexts=contexts,
            pod_class=pod_class,
            in_specs=in_specs,
            out_specs=out_specs,
            axis=axis,
            epilogue=epilogue,
        )

    # -- power ------------------------------------------------------------

    def pod_active_watts(self) -> list[float]:
        """Modeled draw per pod while executing at its sustained rates.

        Per-chip active power from the class spec's :class:`~repro_torch.core.
        blocking.PowerModel` (idle + per-FLOP + per-byte at the chip's peak
        rates), scaled by chips per pod.
        """

        return [
            c.spec.power.active_w(c.peak_flops, c.hbm_bw) * c.chips_per_pod
            for _, c in self._pod_class
        ]

    def pod_idle_watts(self) -> list[float]:
        """Modeled draw per pod while powered but idle."""

        return [c.spec.power.idle_w * c.chips_per_pod for _, c in self._pod_class]

    def pod_poll_watts(self) -> list[float]:
        """Modeled draw per pod while busy-waiting (powered, no work)."""

        return [
            c.spec.power.poll_w(c.peak_flops, c.hbm_bw) * c.chips_per_pod
            for _, c in self._pod_class
        ]

    def pod_gated_watts(self) -> list[float]:
        """Modeled draw per pod while parked (power-gated)."""

        return [c.spec.power.gated_w * c.chips_per_pod for _, c in self._pod_class]

    def pods_by_efficiency(self) -> list[int]:
        """Pod indices sorted most energy-efficient first (fewest modeled
        joules per unit of work: active watts / aggregate throughput),
        ties broken by pod index."""

        active = self.pod_active_watts()
        agg = [
            c.rel_throughput * c.chips_per_pod for _, c in self._pod_class
        ]
        return sorted(
            range(self.n_pods),
            key=lambda i: (active[i] / agg[i] if agg[i] > 0 else float("inf"), i),
        )

    # -- scheduling -------------------------------------------------------

    def chunk_table(self, global_batch: int) -> S.ChunkTable:
        if self.strategy == "sss":
            return S.sss_partition(global_batch, self.n_pods)
        return self.scheduler.table(global_batch)

    def observe_step(self, per_pod_units: Sequence[int], per_pod_times: Sequence[float]):
        """Feed measured step times back (DAS/CA-DAS straggler mitigation)."""

        if self.strategy in ("das", "ca-das"):
            self.scheduler.observe(per_pod_units, per_pod_times)

    def slot_budgets(
        self,
        slots_per_pod: int,
        n_work: int,
        *,
        parked: Optional[Sequence[int]] = None,
    ) -> list[int]:
        """Per-pod admission budgets over a fixed ``n_pods × slots_per_pod``
        slot table (the serving engine's slot regions).

        ``n_work`` is the offered load (in-flight + queued requests); the
        scheduler's chunk table splits it across pods proportionally to
        calibrated throughput — under the same rebalance hysteresis as
        training — and any share exceeding a pod's fixed region spills to
        pods with headroom, highest *aggregate* pod throughput
        (``rel_throughput × chips_per_pod``) first, consistent with how
        ``sas_partition(workers=...)`` apportions and with
        :meth:`imbalance`.  At saturation every region is full; below it,
        slow pods hold proportionally fewer concurrent requests, the
        serving analogue of the paper's smaller LITTLE panel.  Budgets
        change only when the scheduler re-derives its table (drift past
        the threshold) or the load level changes — never mid-step.

        ``parked`` pods (the energy objective's power-gated pods) get a
        hard zero budget; their share and any spill go to unparked pods
        only, and the total is capped by unparked capacity.
        """

        cap = int(slots_per_pod)
        parked_set = set(int(p) for p in parked) if parked else set()
        unparked = [i for i in range(self.n_pods) if i not in parked_set]
        total = min(int(n_work), len(unparked) * cap)
        if total <= 0 or not unparked:
            return [0] * self.n_pods
        sizes = list(self.chunk_table(total).sizes())
        while len(sizes) < self.n_pods:
            sizes.append(0)
        budgets = [
            0 if i in parked_set else min(cap, int(s)) for i, s in enumerate(sizes)
        ]
        spill = total - sum(budgets)
        # Highest-aggregate-throughput pods absorb the spill first
        # (stable by pod order); parked pods never do.
        order = sorted(
            unparked,
            key=lambda i: (
                -(self._pod_class[i][1].rel_throughput
                  * self._pod_class[i][1].chips_per_pod),
                i,
            ),
        )
        while spill > 0:
            for i in order:
                if spill == 0:
                    break
                take = min(cap - budgets[i], spill)
                budgets[i] += take
                spill -= take
        return budgets

    def batch_layout(self, global_batch: int) -> BatchLayout:
        table = self.chunk_table(global_batch)
        sizes = table.sizes()
        while len(sizes) < self.n_pods:
            sizes.append(0)
        c_max = max(
            self.batch_tile,
            int(np.ceil(max(sizes) / self.batch_tile)) * self.batch_tile,
        )
        mask = np.zeros((self.n_pods, c_max), np.float32)
        for i, s in enumerate(sizes):
            mask[i, :s] = 1.0
        return BatchLayout(global_batch=global_batch, sizes=sizes, c_max=c_max, mask=mask)

    # -- analysis ---------------------------------------------------------

    def imbalance(self, layout: BatchLayout) -> float:
        """Relative makespan excess vs a perfectly rate-proportional split."""

        rates = np.array(
            [c.rel_throughput * c.chips_per_pod for _, c in self._pod_class], np.float64
        )
        t = np.array(layout.sizes) / rates
        ideal = layout.global_batch / rates.sum()
        return float(t.max() / ideal - 1.0)


def calibrate_ratios(step_times: Sequence[Sequence[float]], units: Sequence[int]) -> list[float]:
    """Throughput ratios from measured per-pod step times (median-robust)."""

    rates = [u / float(np.median(ts)) for u, ts in zip(units, step_times)]
    top = max(rates)
    return [r / top for r in rates]


__all__ = [
    "DeviceClass",
    "AsymmetricMesh",
    "BatchLayout",
    "biglittle_classes",
    "calibrate_ratios",
]
