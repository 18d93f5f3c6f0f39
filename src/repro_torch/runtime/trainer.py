"""Fault-tolerant asymmetric training loop on one card (the port's
``repro.runtime.trainer``).

Composes:

  * the model zoo's training loss (``make_loss_fn``: attention through
    the flash kernels and their backward on a card, ``chunked_attention``
    on the CPU, each layer recomputed in the backward), whose
    every projection, shared-expert GLU and LM head goes through
    ``ops.gemm`` in both directions (``kernels/ops.GemmFn``); the MoE
    experts and the Mamba2 projections are plain products, as in the
    reference,
  * class-routed execution: on a multi-class mesh with a pod axis the
    step runs *class-sharded* — every pod's rows of the batch run under
    its own class's control tree, a rank a pod (each rank holding the
    whole params and AdamW state, the pods' gradients all-reduced over
    the pod group) or a CUDA stream a pod, and a mask-weighted sum of the
    pods' gradients keeps the update the global masked mean (true CA-SAS,
    :func:`build_class_sharded_grad_step`);
    otherwise the whole step runs under one
    :class:`~repro_torch.core.execution.ExecutionContext`, the asymmetric
    mesh's primary class by default.  Either way each class's tree picks
    its GEMMs' kernel and blocks, forward, recompute and backward,
  * gradient accumulation and AdamW on fp32 masters (``optim/adamw.py``),
  * checkpoint/restart: a step-0 baseline and a save every ``ckpt_every``
    steps; a :class:`SimulatedFailure` restores the newest committed step
    and the loop replays from there (the data is seeded by step),
  * straggler feedback: per-pod step times feed the CA-DAS scheduler,
    which re-derives the next step's batch shares (the step's host time
    for every pod unless a ``pod_time_hook`` gives them),
  * telemetry: :meth:`Trainer.train_step` is the ``trainer.step`` span,
    with ``trainer.forward``, ``trainer.backward`` and
    ``trainer.optimizer`` inside it (``class_sharded.pod`` around each
    pod's, on the mixed step),
  * elastic re-placement: :meth:`Trainer.reshard` rebuilds the step for
    another pod mesh, the state left in place.

On a :class:`~repro_torch.launch.mesh.RankMesh` (``mesh=``) whose pod
axis takes the class-sharded step (:meth:`Trainer.class_sharded_enabled`)
each process is one pod's rank: it draws the whole params from the seed
(rank 0 checks every rank drew the same), takes its pod's rows of each
global batch, runs its class's program, and AdamW updates its replica
from the all-reduced gradients, so the replicas stay equal; the pods'
step times are all-gathered, so every rank's scheduler derives the same
split, and rank 0 writes the checkpoints.  On any other
:class:`~repro_torch.launch.mesh.RankMesh` each process
is one rank of the ``(data, model)`` / ``(pod, data, model)`` mesh and
the trainer runs the sharded step (:func:`sharded_train_step`; every
family it trains): the params and the AdamW state are this
rank's shards by the reference's rules (FSDP over ``data`` when
``TrainerConfig.fsdp``, tensor-parallel over ``model``), built one leaf at
a time from the seeded generator (the same numbers as the one-card
trainer's), each batch cut to this rank's rows after the asymmetric
layout, the gradients reduce-scattered / all-reduced, the norm and the
loss global; checkpoints are gathered to rank 0 and sliced on restore,
and :meth:`Trainer.reshard` moves the state to another mesh of the same
world.

It trains the families whose batches ``SyntheticLM`` gives (tokens and
labels): dense, MoE (the router's auxiliary loss in the gradient), Mamba2
and hybrid, on one card or on a mesh.  The enc-dec family (``frames``)
and embedding inputs (``embeds``) raise at construction, where the
reference's trainer fails at its first step; the enc-dec's sharded
gradient step is :func:`sharded_train_step` on
``model_zoo.make_loss_fn(cfg, mesh=)`` directly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ArchConfig
from repro_torch.core.asymmetric import AsymmetricMesh
from repro_torch.core.execution import ClassShardedFn, ExecutionContext, PodRanks
from repro_torch.data.pipeline import AsymmetricBatcher, SyntheticLM
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd
from repro_torch.distributed import collectives as C
from repro_torch.distributed.collectives import note_collective
from repro_torch.distributed.sharding import PodSplit
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model_zoo as Z
from repro_torch.observability import trace as T
from repro_torch.optim import adamw as O


class SimulatedFailure(RuntimeError):
    """Raised by failure-injection hooks to model a node loss."""


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 20
    n_micro: int = 1
    # FSDP: on a rank mesh, shard the params and AdamW state over "data"
    # too (else only over "model"); no effect on one card.
    fsdp: bool = True
    # True CA-SAS: per-class programs within one step (a rank or a stream
    # a pod).  None = auto (on when the asym mesh has more than one class
    # and the mesh a matching pod axis of one rank or stream a pod, ranks
    # each with a card); False = always the single primary-class context;
    # True = required (raises if the mesh cannot support it).
    class_sharded: Optional[bool] = None


def _shard_weight(batch) -> torch.Tensor:
    """Valid-token weight of a batch (or micro-batch): the mask's sum, or
    the row count when the batch carries no mask (every row valid)."""

    if "mask" in batch:
        return batch["mask"].sum().to(torch.float32)
    first = next(iter(batch.values()))
    return torch.tensor(float(first.shape[0]), dtype=torch.float32, device=first.device)


def _masked_micro_grads(loss_fn, params, batch, n_micro: int):
    """Micro-batch accumulation weighted by per-micro valid tokens.

    Returns the shard's *exact* masked mean ``(loss, metrics, grads)`` —
    ``Σ_j w_j·x_j / Σ_j w_j`` over micro-batches — so a fully-padded
    micro-batch contributes nothing and the cross-pod ``w_i/W`` scaling
    composes to the global masked mean.  (``accumulate_gradients`` takes
    the unweighted micro mean, exact only when every micro-batch has the
    same valid count.)
    """

    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"n_micro={n_micro} does not divide the shard's {b} rows")
    size = b // n_micro
    acc_g = acc_l = acc_w = None
    ms, ws = [], []
    for j in range(n_micro):
        mb = {k: v[j * size:(j + 1) * size] for k, v in batch.items()}
        loss, metrics, grads = O.value_and_grad(loss_fn, params, mb, micro=j)
        w = _shard_weight(mb)
        if acc_g is None:
            acc_g = O.tree_map(lambda g: w * g.float(), grads)
            acc_l, acc_w = w * loss, w
        else:
            O.tree_map(lambda a, g: a.add_(w * g.float()), acc_g, grads)
            acc_l, acc_w = acc_l + w * loss, acc_w + w
        ms.append(metrics)
        ws.append(w)
        del grads
    denom = torch.clamp(acc_w, min=1.0)
    grads = O.tree_map(lambda g: g / denom, acc_g)
    metrics = {k: sum(m[k] * w for m, w in zip(ms, ws)) / denom for k in ms[0]}
    return acc_l / denom, metrics, grads


def weighted_mean_epilogue(outs, shard_args, axis):
    """The class-sharded step's cross-pod reduction.

    With ``w_i`` pod *i*'s valid tokens and ``W = Σ w_i``: ``loss = Σ
    (w_i/W)·loss_i``, and likewise the metrics and the gradients (each
    pod's term cast back to its dtype, as the reference's ``psum`` of
    ``g·scale`` does), so the result is the global masked mean; a pod with
    no valid rows contributes zero.  ``axis=None`` is the single-class
    fallback, whose ``outs`` is already the global mean.

    A rank a pod (``axis`` a :class:`~repro_torch.core.execution.PodRanks`):
    ``outs`` and ``shard_args`` are this rank's; ``W`` is its ``w``
    all-reduced over the pod group, and each scaled term is all-reduced
    (summed) there, the reference's ``psum(g·scale)``.  A stream a pod:
    ``outs`` and ``shard_args`` hold every pod's, summed here after the
    join (at two pods ``a + b`` either way, so the two realisations agree
    bitwise).
    """

    if axis is None:
        return outs
    if isinstance(axis, PodRanks):
        mesh, name = axis.mesh, axis.name
        loss, metrics, grads = outs
        w = _shard_weight(shard_args[1])
        total = C.all_reduce(w, mesh, name)
        scale = torch.where(total > 0, w / torch.clamp(total, min=1.0), torch.zeros_like(w))
        return (C.all_reduce(loss * scale, mesh, name),
                {k: C.all_reduce(v * scale, mesh, name) for k, v in metrics.items()},
                O.tree_map(lambda g: C.all_reduce((g * scale).to(g.dtype), mesh, name), grads))
    # The reference's psum of each pod's (loss, metrics, grads): one pod's
    # tree is the operand every device sends.
    note_collective("all-reduce", [outs[0][0], list(outs[0][1].values()), outs[0][2]])
    ws = [_shard_weight(batch) for _, batch in shard_args]
    total = sum(ws)
    scales = [torch.where(total > 0, w / torch.clamp(total, min=1.0), torch.zeros_like(w))
              for w in ws]
    loss = sum(out[0] * s for out, s in zip(outs, scales))
    metrics = {k: sum(out[1][k] * s for out, s in zip(outs, scales)) for k in outs[0][1]}
    grads = O.tree_map(lambda *gs: sum((g * s).to(g.dtype) for g, s in zip(gs, scales)),
                       *[out[2] for out in outs])
    return loss, metrics, grads


def build_class_sharded_grad_step(
    loss_fn,
    asym: AsymmetricMesh,
    mesh,
    *,
    n_micro: int = 1,
    axis: str = "pod",
) -> ClassShardedFn:
    """``(params, batch) -> (loss, metrics, grads)`` with per-class programs.

    Each pod's rows of the batch (pod-major, ``c_max`` rows a pod, as
    ``AsymmetricBatcher`` lays them out) take their *local* loss and
    gradients under the pod's own class's control tree, on the pod's own
    rank or stream: ``torch.autograd.grad`` returns each pod's own
    gradient tree (nothing accumulates into a shared ``.grad``), and
    ``ops.GemmFn`` runs each pod's backward on the kernel of its forward's
    context.  :func:`weighted_mean_epilogue` then reduces them to the
    global masked mean: over the pod group on ranks, on the caller's
    stream after the pods join on one card.

    With ``n_micro > 1`` the local accumulation weights each micro-batch
    by *its* valid tokens (:func:`_masked_micro_grads`): a shard's padding
    sits in its tail micro-batches, and the unweighted micro mean would
    deflate that shard's loss and gradients before the ``w_i/W`` scaling.
    ``n_micro`` must divide the per-shard (not global) row count.
    """

    def local_grads(params, batch):
        if n_micro <= 1:
            return O.accumulate_gradients(loss_fn, params, batch, 1)
        return _masked_micro_grads(loss_fn, params, batch, n_micro)

    return asym.class_sharded(
        local_grads,
        mesh=mesh,
        in_specs=(None, PodSplit(0, axis)),   # params whole, batch rows per pod
        out_specs=(None, None, None),         # reduced by the epilogue
        axis=axis,
        epilogue=weighted_mean_epilogue,
    )


def sharded_train_step(loss_fn, params, opt_state, batch, opt_cfg, lay, n_micro: int = 1):
    """One training step of a rank on a mesh: its gradients (FSDP leaves
    reduce-scattered by their gathers' backward), the leaves replicated
    over a dp axis summed over it (``spmd.sync_grads``), AdamW on the
    shards with the global norm; returns ``(params, opt_state, metrics)``
    with the loss and metrics summed over the dp ranks (the global mean)."""

    loss, metrics, grads = O.accumulate_gradients(loss_fn, params, batch, n_micro)
    grads = spmd.sync_grads(grads, lay.specs, lay.mesh)
    params, opt_state, om = O.adamw_update(
        params, grads, opt_state, opt_cfg,
        norm=lambda g: spmd.global_norm(g, lay.specs, lay.mesh))
    metrics = {k: spmd.dp_sum(v, lay.mesh) if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    metrics.update(om)
    metrics["loss"] = spmd.dp_sum(loss, lay.mesh)
    return params, opt_state, metrics


class Trainer:
    def __init__(
        self,
        arch: ArchConfig,
        *,
        tcfg: TrainerConfig,
        opt_cfg: Optional[O.AdamWConfig] = None,
        asym: Optional[AsymmetricMesh] = None,
        exec_ctx: Optional[ExecutionContext] = None,
        failure_hook: Optional[Callable[[int], None]] = None,
        pod_time_hook: Optional[Callable[[int], list]] = None,
        seed: int = 0,
        device="cuda",
        mesh=None,
        params: Optional[dict] = None,
        opt_state: Optional[dict] = None,
    ):
        missing = "frames" if arch.family == "encdec" else "embeds" if arch.embed_inputs else None
        if missing:
            raise ValueError(f"{arch.name}: its batches need {missing!r}, which the trainer's "
                             "SyntheticLM data does not give (the reference's trainer fails "
                             f"with KeyError: {missing!r} at its first step)")
        self.arch = arch
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or O.AdamWConfig(total_steps=tcfg.steps)
        self.asym = asym
        self.device = torch.device(device)
        # The pod mesh (``launch.mesh``); the default has no pod axis, so
        # the step runs under one context unless a caller gives pods.
        self.mesh = mesh if mesh is not None else make_host_mesh(device=self.device)
        # Ambient context for the non-class-sharded paths (the whole step
        # when the mixed path is off): the asymmetric mesh's primary
        # (fastest) class; with no asym mesh the pre-context defaults
        # apply.  Under the class-sharded step each pod enters its own
        # class's context on top of this one (innermost wins).
        self.exec_ctx = exec_ctx if exec_ctx is not None else (
            asym.execution_context() if asym is not None else None
        )
        self.failure_hook = failure_hook
        self.pod_time_hook = pod_time_hook
        self.ckpt = Checkpointer(tcfg.ckpt_dir)
        self.restarts = 0

        self.data = SyntheticLM(vocab=arch.vocab, seed=seed)
        self.batcher = AsymmetricBatcher(self.data, asym) if asym else None

        # A rank mesh whose pod axis takes the class-sharded step runs it
        # a rank a pod, every rank holding the whole state; any other rank
        # mesh runs the sharded step.
        self.pod_ranks = spmd.is_sharded(self.mesh) and self.class_sharded_enabled()
        self.sharded = spmd.is_sharded(self.mesh) and not self.pod_ranks
        if spmd.is_sharded(self.mesh):
            self.device = self.mesh.device
        self.loss_fn = self._make_loss_fn()
        self._build_step()
        gen = torch.Generator(device=self.device).manual_seed(seed) if params is None else None
        if self.sharded:
            specs = self.layout.specs
            full = Z.init_params(arch, None, "meta", dtype=torch.float32)
            if params is None:
                params = spmd.init_sharded(
                    lambda g, d: Z.init_params(arch, g, d, dtype=torch.float32), gen, specs,
                    self.mesh)
            params = O.tree_map(lambda p: p.requires_grad_(True),
                                spmd.localize(params, specs, self.mesh, full))
            if opt_state is not None:
                opt_state = dict(opt_state, m=spmd.localize(opt_state["m"], specs, self.mesh, full),
                                 v=spmd.localize(opt_state["v"], specs, self.mesh, full))
        elif params is None:
            params = O.tree_map(lambda p: p.requires_grad_(True),
                                Z.init_params(arch, gen, self.device, dtype=torch.float32))
            if self.pod_ranks:  # every pod's rank drew the same replica
                C.check_replicas(params, self.mesh)
        self.params = params
        self.opt_state = opt_state if opt_state is not None else O.init_opt_state(params)
        self.step = 0

    def _make_loss_fn(self):
        if not self.sharded:
            return Z.make_loss_fn(self.arch)
        fn = Z.make_loss_fn(self.arch, mesh=self.mesh, fsdp=self.tcfg.fsdp)
        self.layout = fn.layout
        return fn

    def state_specs(self) -> dict:
        """The spec tree of ``{"params", "opt"}`` on the rank mesh (every
        leaf replicated when the ranks are pods)."""

        if self.pod_ranks:
            return O.tree_map(lambda _: SH.P(), self._state())
        specs = self.layout.specs
        return {"params": specs, "opt": SH.shard_opt_state(None, specs, self.mesh)}

    def _execution(self):
        return self.exec_ctx if self.exec_ctx is not None else contextlib.nullcontext()

    def class_sharded_enabled(self) -> bool:
        """Is the per-class-programs step active?

        Auto mode requires a multi-class asym mesh *and* a mesh whose
        ``pod`` axis matches the pod count (and no other axis above 1:
        pods of one stream or rank), on a rank mesh each rank with a card
        of its own (``nccl``), the reference's ``device_count() >=
        n_pods``; ``class_sharded=True`` makes a mismatch an error instead
        of a silent fallback, and on a rank mesh replicates each pod's
        program over its ranks where ``data`` or ``model`` exceed 1.
        """

        flag = self.tcfg.class_sharded
        if flag is False or self.asym is None:
            return False
        shape = dict(self.mesh.shape)
        ok = len(self.asym.classes) > 1 and shape.get("pod") == self.asym.n_pods
        if flag is True and not ok:
            raise ValueError(
                "class_sharded=True requires a multi-class AsymmetricMesh "
                f"and a mesh pod axis of size {self.asym.n_pods}; mesh axes={shape}"
            )
        if flag is None:
            intra = 1
            for a, n in shape.items():
                if a != "pod":
                    intra *= n
            ok = ok and intra == 1
            if spmd.is_sharded(self.mesh):
                ok = ok and self.mesh.transport == "nccl"
        return ok

    def _build_step(self):
        """The class-sharded gradient step when the mesh allows it, else
        ``None`` (the single-context step)."""

        self.class_sharded_step = (
            build_class_sharded_grad_step(self.loss_fn, self.asym, self.mesh,
                                          n_micro=self.tcfg.n_micro)
            if self.class_sharded_enabled() else None
        )

    def train_step(self, batch) -> dict:
        """One step under the ambient context: the gradients (per pod
        under its class's tree when class-sharded, else accumulated over
        ``n_micro`` micro-batches), then AdamW in place; returns the
        metrics as tensors.  The step is the ``trainer.step`` span, on
        every path."""

        rows, seq = batch["tokens"].shape[:2]
        with T.span("trainer.step", cat="trainer", step=self.step, tokens=rows * seq):
            return self._train_step(batch)

    def _train_step(self, batch) -> dict:
        if self.sharded:
            with self._execution():
                self.params, self.opt_state, metrics = sharded_train_step(
                    self.loss_fn, self.params, self.opt_state, batch, self.opt_cfg, self.layout,
                    self.tcfg.n_micro)
            return metrics
        with self._execution():
            if self.class_sharded_step is not None:
                loss, metrics, grads = self.class_sharded_step(self.params, batch)
            else:
                loss, metrics, grads = O.accumulate_gradients(
                    self.loss_fn, self.params, batch, self.tcfg.n_micro)
            self.params, self.opt_state, om = O.adamw_update(
                self.params, grads, self.opt_state, self.opt_cfg)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return metrics

    def reshard(self, new_mesh):
        """Elastic re-placement: the step rebuilt for ``new_mesh`` (pods
        joining or leaving between steps).  Between rank meshes of one
        world the params and AdamW state move to the new mesh's shards one
        leaf at a time (gathered whole, cut again); on one card they stay
        where they are: nothing is sharded."""

        if self.pod_ranks:
            raise ValueError("the pods are ranks: their mesh is the world's, and stays")
        if self.sharded or spmd.is_sharded(new_mesh):
            if not (self.sharded and spmd.is_sharded(new_mesh)) or \
                    new_mesh.world != self.mesh.world:
                raise ValueError(f"reshard moves state between rank meshes of one world, not "
                                 f"{dict(self.mesh.shape)} to {dict(new_mesh.shape)}")
            old_specs, old_mesh = self.layout.specs, self.mesh
            self.mesh = new_mesh
            self.loss_fn = self._make_loss_fn()
            new_specs = self.layout.specs

            def move(x, old, new):
                full = spmd.gather_full(x, old, old_mesh)
                out = SH.local_slice(full, new, new_mesh).clone()
                return out.requires_grad_(x.requires_grad)

            tm = spmd.map_specs
            self.params = tm(move, self.params, old_specs, new_specs)
            self.opt_state = dict(self.opt_state,
                                  m=tm(move, self.opt_state["m"], old_specs, new_specs),
                                  v=tm(move, self.opt_state["v"], old_specs, new_specs))
            self._build_step()
            return
        self.mesh = new_mesh
        self._build_step()

    # -- data ---------------------------------------------------------------

    def next_batch(self, step: int):
        if self.batcher is not None:
            bw = self.batcher.batch(step, self.tcfg.global_batch, self.tcfg.seq_len)
            arrays, layout = bw.arrays, bw.layout
        else:
            arrays = self.data.batch(step, self.tcfg.global_batch, self.tcfg.seq_len)
            layout = None
        if self.sharded:  # this rank's rows, after the asymmetric layout
            specs = SH.batch_sharding(self.mesh, arrays)
            arrays = {k: SH.local_slice(v, specs[k], self.mesh) for k, v in arrays.items()}
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                 for k, v in arrays.items()}
        return batch, layout

    # -- fault tolerance ------------------------------------------------------

    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def _checkpoint(self):
        ranks = self.sharded or self.pod_ranks
        shard = dict(mesh=self.mesh, specs=self.state_specs()) if ranks else {}
        self.ckpt.save(self.step, self._state(), extra={"restarts": self.restarts}, **shard)

    def _restart(self):
        """Restore the newest committed state (node-failure recovery),
        copied into the live tensors: no second copy of the state on the
        card."""

        self.restarts += 1
        ranks = self.sharded or self.pod_ranks
        shard = dict(mesh=self.mesh, specs=self.state_specs()) if ranks else {}
        tree, manifest = self.ckpt.restore(self._state(), device="cpu", **shard)
        with torch.no_grad():
            O.tree_map(lambda live, saved: live.copy_(saved), self._state(), tree)
        self.step = int(manifest["step"])

    def pod_times(self, times):
        """``times`` (per pod) as the scheduler takes them: on pod ranks
        each rank's own pod's entry, all-gathered, so every rank derives
        the same split; unchanged elsewhere."""

        if not self.pod_ranks:
            return times
        return C.pod_values(times[self.mesh.coord("pod")], self.mesh)

    # -- main loop ------------------------------------------------------------

    def run(self, steps: Optional[int] = None):
        steps = steps if steps is not None else self.tcfg.steps
        history = []
        self._checkpoint()  # step-0 baseline so any failure can restore
        while self.step < steps:
            try:
                if self.failure_hook is not None:
                    self.failure_hook(self.step)
                batch, layout = self.next_batch(self.step)
                t0 = time.perf_counter()
                metrics = {k: float(v) for k, v in self.train_step(batch).items()}
                dt = time.perf_counter() - t0

                # Straggler feedback: measured (or injected) per-pod times
                # re-derive the next step's chunk table (CA-DAS).
                if self.asym is not None and layout is not None:
                    times = (
                        self.pod_time_hook(self.step)
                        if self.pod_time_hook is not None
                        else [dt] * len(layout.sizes)
                    )
                    self.asym.observe_step(layout.sizes, self.pod_times(times))

                self.step += 1
                history.append(metrics)
                if self.step % self.tcfg.ckpt_every == 0:
                    self._checkpoint()
            except SimulatedFailure:
                self._restart()
        self.ckpt.wait()
        return history


__all__ = [
    "SimulatedFailure",
    "Trainer",
    "TrainerConfig",
    "build_class_sharded_grad_step",
    "sharded_train_step",
    "weighted_mean_epilogue",
]
