"""Training: ``Trainer.train_step`` on the benchmark's batches.

The trainer is built by the program's own entry point
(``launch.train.make_trainer``), from the cell's traffic file, with the
benchmark's weights from the seed.  Set-up drives it through the first
``checked_steps`` steps, whose readings the comparison takes: each step's
loss and gradient norm as the step returns them, the first step's clipped
gradient as AdamW's first moment holds it after one step (``m / (1 -
b1)``), and each leaf's change after the last of them, by its norm and by
its decay share (:func:`change_readings`).  Each is worked out a leaf at
a time.  The same object then runs the window.

Once the window has closed and its memory peak is read, the same object
is put back to the seed's weights and a zero optimizer state, a leaf at
a time, and takes the first checked step again through the same call:
its first moment, ``m / (1 - b1)`` in place, is then the first gradient
as tensors, which the reference holds its own against leaf by leaf
(``first_grad_diff_gap``).  The trainer's other state is freed before
the reference runs; neither set-up nor the window holds a second tree,
and nothing goes through the host.

With ``class_sharded`` on, the step is the class-sharded mixed step (the
pods as CUDA streams on one card): the benchmark's rows are laid out
pod-major as the program's scheduler splits them
(``asym.batch_layout``), each pod padded to the widest with masked rows.
Padding is not counted as tokens.  The reference takes the rows as made:
the program's masked mean over the pods has to equal its plain mean.

``fault`` plants a fault in the program's call (the checks must then fail):
``"half_batch"`` hands the step the first half of the rows,
``"frozen"`` puts the params and the optimizer state back as they were
after every step; ``"no_decay"`` runs AdamW without its weight decay.
"""

from __future__ import annotations

import dataclasses
import gc
import os

import torch

from portbench import compare, counts, traffic
from portbench import weights as W
from portbench.cell import ROOT
from portbench.reference import train as R

_OPT_KEYS = ("lr", "b1", "b2", "eps", "weight_decay", "clip_norm", "warmup_steps",
             "total_steps", "schedule")


def change_readings(params, conf, seed, device, opt: dict, steps: int) -> tuple:
    """Each leaf's change from the weights of ``seed``, made again a leaf
    at a time: its norm a layer (``layer_norms``), and its decay share,
    ``-<Δ, w0> / (weight_decay · Σ lr_t · ‖w0‖²)`` over the ``steps``
    steps taken: what the change moved along the leaf's own weights, as a
    share of what decoupled decay alone moves it by.  The Adam step adds
    its own small part, alike on both sides; a leaf decayed on one side
    only reads 1 apart."""

    now = dict(R.leaves(params))
    lr_sum = sum(R.lr_at(opt, t) for t in range(1, steps + 1))
    norms, share = {}, {}
    for name, w0 in W.iter_params(conf, seed, device, torch.float32):
        delta = now[name].detach().float() - w0
        norms.update(R.layer_norms([(name, delta)]))
        dot = float(torch.sum(delta * w0, dtype=torch.float64))
        sq = float(torch.sum(w0 * w0, dtype=torch.float64))
        share[name] = -dot / (opt["weight_decay"] * lr_sum * sq)
        del delta, w0
    return norms, share


def trainer_args(cell, device, ckpt_dir: str) -> list:
    tr = cell.traffic
    opt = tr["optimizer"]
    return [
        "--arch", cell.conf["port_arch"], "--device", device.type,
        "--global-batch", str(tr["batch"]), "--seq", str(tr["seq"]),
        "--lr", repr(opt["lr"]), "--steps", str(opt["total_steps"]),
        "--strategy", tr["strategy"], "--class-sharded", tr["class_sharded"],
        "--ckpt-dir", ckpt_dir, "--ckpt-every", str(10 ** 9),
    ] + (["--heterogeneous"] if tr["heterogeneous"] else [])


class Session:
    def __init__(self, cell, seed: int, device, fault=None):
        self.cell, self.seed, self.device, self.fault = cell, seed, torch.device(device), fault
        tr = cell.traffic
        self.rows, self.seq = tr["batch"], tr["seq"]
        products = counts.gemm_products(cell.conf, self.rows * self.seq, train=True)
        self.counts = {"model_flops": counts.train_flops(cell.conf, self.rows, self.seq),
                       "gemm_bound_s": counts.gemm_bound_s(products, counts.peaks()),
                       "flash_bound_s": 0.0}
        self.batches = [self.batch(k) for k in range(tr["checked_steps"])]

    # -- the program ----------------------------------------------------------

    def _build(self):
        from repro_torch.launch import train as LT
        from repro_torch.models import model_zoo as Z

        cell = self.cell
        params = W.make_params(cell.conf, self.seed, self.device, torch.float32)
        want = W.tree_signature(Z.init_params(cell.port_cfg, None, "meta", dtype=torch.float32))
        if W.tree_signature(params) != want:
            raise SystemExit(f"the program's parameter tree of {cell.port_cfg.name} is not the "
                             "benchmark's")
        for _, p in R.leaves(params):
            p.requires_grad_(True)
        # The trainer makes its checkpoint directory; no step here saves.
        ckpt = os.path.join(ROOT, "build", "portbench_ckpt")
        args = LT.build_parser().parse_args(trainer_args(cell, self.device, ckpt))
        trainer = LT.make_trainer(args, cfg=cell.port_cfg, params=params)
        opt = cell.traffic["optimizer"]
        have = {k: getattr(trainer.opt_cfg, k) for k in _OPT_KEYS}
        if have != {k: opt[k] for k in _OPT_KEYS}:
            raise SystemExit(f"the trainer's AdamW {have} is not the traffic file's {opt}")
        if self.fault == "no_decay":
            trainer.opt_cfg = dataclasses.replace(trainer.opt_cfg, weight_decay=0.0)
        return trainer

    def _feed(self, batch):
        """The rows as the step takes them: as made, or laid out over the
        pods by the program's split, each pod's share padded and masked."""

        if self.cell.traffic["class_sharded"] != "on":
            return batch
        lay = self.trainer.asym.batch_layout(batch["tokens"].shape[0])
        out = {}
        for k, v in batch.items():
            padded = v.new_zeros((len(lay.sizes) * lay.c_max,) + tuple(v.shape[1:]))
            pos = 0
            for i, size in enumerate(lay.sizes):
                padded[i * lay.c_max:i * lay.c_max + size] = v[pos:pos + size]
                pos += size
            out[k] = padded
        mask = torch.as_tensor(lay.mask.reshape(-1, 1), device=self.device)
        out["mask"] = mask.expand(-1, batch["tokens"].shape[1]).contiguous()
        return out

    def _step(self, batch):
        t = self.trainer
        if self.fault == "half_batch":
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        batch = self._feed(batch)
        if self.fault == "frozen":
            trees = (t.params, t.opt_state["m"], t.opt_state["v"])
            state = lambda: [x for tree in trees for _, x in R.leaves(tree)]  # noqa: E731
            keep = [x.detach().clone() for x in state()]
            metrics = t.train_step(batch)
            with torch.no_grad():
                for x, k in zip(state(), keep):
                    x.copy_(k)
            return metrics
        return t.train_step(batch)

    def batch(self, step: int) -> dict:
        return traffic.train_batch(self.cell.traffic, self.seed, step, self.cell.vocab, self.device)

    def setup(self):
        self.trainer = self._build()
        opt = self.cell.traffic["optimizer"]
        loss, norm = [], []
        for k, b in enumerate(self.batches):
            metrics = self._step(b)
            loss.append(float(metrics["loss"]))
            norm.append(float(metrics["grad_norm"]))
            if k == 0:
                first = R.layer_norms((name, m / (1 - opt["b1"]))
                                      for name, m in R.leaves(self.trainer.opt_state["m"]))
        change, share = change_readings(self.trainer.params, self.cell.conf, self.seed,
                                        self.device, opt, len(self.batches))
        self.readings = {"loss": loss, "grad_norm": norm, "first_grad": first,
                         "change": change, "decay_share": share}
        self.next_step = len(self.batches)

    def unit(self, i: int) -> dict:
        batch = self.batch(self.next_step + i)
        metrics = self._step(batch)
        float(metrics["loss"])      # the host reads the step's loss, as the trainer's loop does
        return dict(self.counts, tokens=self.rows * self.seq)

    def _first_gradient_again(self) -> dict:
        """``{name: tensor}``: the first checked step's clipped gradient,
        each leaf the program's own first moment divided in place."""

        t, b1 = self.trainer, self.cell.traffic["optimizer"]["b1"]
        params = dict(R.leaves(t.params))
        with torch.no_grad():
            for name, w0 in W.iter_params(self.cell.conf, self.seed, self.device, torch.float32):
                params[name].copy_(w0)
                del w0
            for _, x in R.leaves(t.opt_state["m"]) + R.leaves(t.opt_state["v"]):
                x.zero_()
        t.opt_state = dict(t.opt_state, step=torch.zeros_like(t.opt_state["step"]))
        self._step(self.batches[0])
        first = dict(R.leaves(t.opt_state["m"]))
        with torch.no_grad():
            for x in first.values():
                x.div_(1 - b1)
        return first

    def finish(self) -> dict:
        self.readings["first_grad_leaves"] = self._first_gradient_again()
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return self.readings

    # -- the reference --------------------------------------------------------

    def reference(self, readings: dict, precision: str = "fp32") -> dict:
        """The reference's readings on the same weights and batches.  Its
        first gradient is held against the judged side's
        (``readings["first_grad_leaves"]``: the program's, or a
        control's) a leaf at a time, each of those freed once read; a
        control (any precision but fp32) keeps its own for the reference
        that judges it."""

        conf, opt = self.cell.conf, self.cell.traffic["optimizer"]
        theirs = readings["first_grad_leaves"]
        diff, kept = {}, {}

        def on_first(named):
            for name, g in named:
                if name in theirs:
                    diff.update(R.layer_norms([(name, g - theirs.pop(name))]))
                if precision != "fp32":
                    kept[name] = g.detach().clone()

        params = W.make_params(conf, self.seed, self.device, torch.float32)
        history, first = R.train(params, conf, self.batches, opt, precision, on_first)
        change, share = change_readings(params, conf, self.seed, self.device, opt,
                                        len(self.batches))
        del params
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"loss": [h["loss"] for h in history],
                "grad_norm": [h["grad_norm"] for h in history],
                "first_grad": first, "first_grad_diff": diff, "first_grad_leaves": kept,
                "change": change, "decay_share": share}


def numbers(prog: dict, ref: dict) -> dict:
    return compare.training_numbers(prog, ref)
