"""Fault-tolerant asymmetric training loop on one card (the port's
``repro.runtime.trainer``, its single-class path).

Composes:

  * the model zoo's training loss (``make_loss_fn``: attention through
    ``chunked_attention``, each layer recomputed in the backward), whose
    every projection, shared-expert GLU and LM head goes through
    ``ops.gemm`` in both directions (``kernels/ops.GemmFn``); the MoE
    experts and the Mamba2 projections are plain products, as in the
    reference,
  * class-routed execution: the whole step runs under one
    :class:`~repro_torch.core.execution.ExecutionContext`, the asymmetric
    mesh's primary class by default, so its control tree picks each
    GEMM's kernel and blocks, forward, recompute and backward,
  * gradient accumulation and AdamW on fp32 masters (``optim/adamw.py``),
  * checkpoint/restart: a step-0 baseline and a save every ``ckpt_every``
    steps; a :class:`SimulatedFailure` restores the newest committed step
    and the loop replays from there (the data is seeded by step),
  * straggler feedback: per-pod step times feed the CA-DAS scheduler,
    which re-derives the next step's batch shares.

Left out on one card: the class-sharded step (per-class programs in one
step, ROADMAP Queue 1's class-sharded mixed step: ``class_sharded=True``
raises) and
``reshard``; ``fsdp`` is accepted and has no effect (nothing is sharded).
It trains the families whose batches ``SyntheticLM`` gives (tokens and
labels): dense, MoE (the router's auxiliary loss in the gradient), Mamba2
and hybrid.  The enc-dec family (``frames``) and embedding inputs
(``embeds``) raise at construction, where the reference's trainer fails
at its first step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ArchConfig
from repro_torch.core.asymmetric import AsymmetricMesh
from repro_torch.core.execution import ExecutionContext
from repro_torch.data.pipeline import AsymmetricBatcher, SyntheticLM
from repro_torch.models import model_zoo as Z
from repro_torch.observability import metrics as MET
from repro_torch.observability import trace as T
from repro_torch.optim import adamw as O

_M = None


def _metrics():
    global _M
    if _M is None:
        _M = {
            "steps": MET.counter("trainer_steps_total", "Training steps completed"),
            "step_seconds": MET.histogram(
                "trainer_step_seconds", "Train step wall time (incl. compile)"),
        }
    return _M


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
    # The reference's parameter-sharding switch, kept so its configs carry
    # over; nothing is sharded on one card, so it has no effect here.
    fsdp: bool = True
    # The class-sharded step is not ported: None and False run the single
    # primary-class step, True raises.
    class_sharded: Optional[bool] = None


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
        params: Optional[dict] = None,
        opt_state: Optional[dict] = None,
    ):
        missing = "frames" if arch.family == "encdec" else "embeds" if arch.embed_inputs else None
        if missing:
            raise ValueError(f"{arch.name}: its batches need {missing!r}, which the trainer's "
                             "SyntheticLM data does not give (the reference's trainer fails "
                             f"with KeyError: {missing!r} at its first step)")
        if tcfg.class_sharded:
            raise ValueError("class_sharded=True: the class-sharded mixed step is not "
                             "ported (ROADMAP Queue 1)")
        self.arch = arch
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or O.AdamWConfig(total_steps=tcfg.steps)
        self.asym = asym
        # The ambient context of the whole step: the asymmetric mesh's
        # primary (fastest) class; with no asym mesh the pre-context
        # defaults apply.
        self.exec_ctx = exec_ctx if exec_ctx is not None else (
            asym.execution_context() if asym is not None else None
        )
        self.failure_hook = failure_hook
        self.pod_time_hook = pod_time_hook
        self.ckpt = Checkpointer(tcfg.ckpt_dir)
        self.restarts = 0
        self.device = torch.device(device)

        self.data = SyntheticLM(vocab=arch.vocab, seed=seed)
        self.batcher = AsymmetricBatcher(self.data, asym) if asym else None

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = O.tree_map(lambda p: p.requires_grad_(True),
                                Z.init_params(arch, gen, self.device, dtype=torch.float32))
        self.params = params
        self.opt_state = opt_state if opt_state is not None else O.init_opt_state(params)
        self.loss_fn = Z.make_loss_fn(arch)
        self.step = 0

    def _execution(self):
        return self.exec_ctx if self.exec_ctx is not None else contextlib.nullcontext()

    def train_step(self, batch) -> dict:
        """One step under the ambient context: the gradients (accumulated
        over ``n_micro`` micro-batches), then AdamW in place; returns the
        metrics as tensors."""

        with self._execution():
            loss, metrics, grads = O.accumulate_gradients(
                self.loss_fn, self.params, batch, self.tcfg.n_micro)
            self.params, self.opt_state, om = O.adamw_update(
                self.params, grads, self.opt_state, self.opt_cfg)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return metrics

    # -- data ---------------------------------------------------------------

    def next_batch(self, step: int):
        if self.batcher is not None:
            bw = self.batcher.batch(step, self.tcfg.global_batch, self.tcfg.seq_len)
            arrays, layout = bw.arrays, bw.layout
        else:
            arrays = self.data.batch(step, self.tcfg.global_batch, self.tcfg.seq_len)
            layout = None
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}
        return batch, layout

    # -- fault tolerance ------------------------------------------------------

    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def _checkpoint(self):
        self.ckpt.save(self.step, self._state(), extra={"restarts": self.restarts})

    def _restart(self):
        """Restore the newest committed state (node-failure recovery),
        copied into the live tensors: no second copy of the state on the
        card."""

        self.restarts += 1
        tree, manifest = self.ckpt.restore(self._state(), device="cpu")
        with torch.no_grad():
            O.tree_map(lambda live, saved: live.copy_(saved), self._state(), tree)
        self.step = int(manifest["step"])

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
                if T.enabled():
                    m = _metrics()
                    T.complete("trainer.step", t0, dt, cat="trainer",
                               step=self.step, loss=metrics.get("loss"))
                    m["steps"].inc()
                    m["step_seconds"].observe(dt)

                # Straggler feedback: measured (or injected) per-pod times
                # re-derive the next step's chunk table (CA-DAS).
                if self.asym is not None and layout is not None:
                    times = (
                        self.pod_time_hook(self.step)
                        if self.pod_time_hook is not None
                        else [dt] * len(layout.sizes)
                    )
                    self.asym.observe_step(layout.sizes, times)

                self.step += 1
                history.append(metrics)
                if self.step % self.tcfg.ckpt_every == 0:
                    self._checkpoint()
            except SimulatedFailure:
                self._restart()
        self.ckpt.wait()
        return history


__all__ = ["SimulatedFailure", "Trainer", "TrainerConfig"]
