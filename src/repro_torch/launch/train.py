"""End-to-end training entry point on one card (the port's ``repro.launch.train``).

Every projection and the LM head run through ``ops.gemm`` in both
directions, on the kernel of the primary class's control tree
(``gemm_cuda`` on the card), or, class-sharded, each pod's rows on its own
class's; attention through the flash kernels and their backward
(``chunked_attention`` on the CPU).
Weights are random fp32 masters from ``--seed``; data is ``SyntheticLM``.
``--arch`` takes every token-in family (dense, MoE, Mamba2, hybrid); the
enc-dec and embedding-input configs need batch keys ``SyntheticLM`` does
not give, and the trainer refuses them.

Examples::

    # one H100: full-width internlm2-1.8b (or mamba2-1.3b, zamba2-2.7b), 8 x 512 tokens a step
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --steps 6
    # the CPU, reduced config, the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --reduced \\
        --device cpu --steps 3 --seq 64
    # the class-sharded step: the big pod's rows on gemm_cuda, the little pod's on
    # gemm_cuda_lean, each pod on its own CUDA stream
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --steps 3 \\
        --seq 512 --heterogeneous --class-sharded on
    # the same step a rank a pod: two processes, each on its own card (nccl)
    # where the node has two, else sharing one over gloo
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch internlm2-1.8b --steps 3 --seq 512 --heterogeneous --class-sharded on

Flags are the reference's (with its defaults), plus ``--device`` and
``--seed``.  ``launch.mesh.resolve_pods`` decides ``--class-sharded``:
``on`` runs the pods as ranks under a launcher's world of one rank a pod
(every rank its pod's rows under its class's tree; only rank 0 prints the
summary) and as CUDA streams on one card in one process; ``auto`` takes
the ranks only where each rank has a card of its own (``nccl``), the
reference's ``device_count() >= n_pods``, and is off everywhere else (the
summary's ``shard_classes`` lists each pod's class, block source and
kernel).  ``--mesh 16x16`` / ``2x16x16`` train every family
the trainer takes (dense, MoE, Mamba2, hybrid) on the reference's
production mesh, FSDP over ``data`` and tensor
parallelism over ``model``, one process a rank: they run under a launcher
with a world of 256 / 512 ranks (``torchrun --nnodes ... --nproc-per-node
...``, each rank on ``cuda:LOCAL_RANK``, over ``nccl``) and raise a
``ValueError`` naming the world they need anywhere else::

    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --arch internlm2-1.8b --mesh 16x16
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.core import execution
from repro_torch.core.asymmetric import AsymmetricMesh, DeviceClass, biglittle_classes
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh, process_rank,
                                    resolve_pods)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.serving import resolve_device
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--strategy", default="ca-das",
                    choices=["sss", "sas", "ca-sas", "das", "ca-das", "none"])
    ap.add_argument("--heterogeneous", action="store_true",
                    help="simulate a big+little two-pod fleet for the scheduler")
    ap.add_argument("--mesh", default="host", choices=["host", "16x16", "2x16x16"])
    ap.add_argument("--class-sharded", default="auto", choices=["auto", "on", "off"],
                    help="per-class programs in one step: a rank a pod under a launcher's "
                         "world of one rank a pod, else the pods as CUDA streams on one "
                         "card; auto = on only where each pod's rank has a card of its own")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    return ap


def make_trainer(args, cfg=None, mesh=None, **hooks) -> Trainer:
    """The trainer the CLI runs for parsed ``args``; ``cfg`` replaces the
    config of ``--arch`` (a caller's depth cut), ``mesh`` the mesh of
    ``--mesh`` (a caller's rank mesh), ``hooks`` are passed on
    (``failure_hook``, ``pod_time_hook``)."""

    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    asym = None
    if args.strategy != "none":
        classes = (
            biglittle_classes(chips_per_pod=1)
            if args.heterogeneous
            else [DeviceClass("pod0", chips_per_pod=1), DeviceClass("pod1", chips_per_pod=1)]
        )
        asym = AsymmetricMesh(classes, strategy=args.strategy, batch_tile=2)
    if mesh is not None:
        pass
    elif args.mesh == "host":
        # The class-sharded step needs a pod axis: give the mesh one when
        # the run wants the mixed step.
        mesh = (resolve_pods(args.class_sharded, asym, device) if asym is not None else None) \
            or make_host_mesh(device=device)
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "2x16x16", device=device)
        if mesh.is_abstract:
            raise ValueError(f"--mesh {args.mesh} needs {mesh.world} ranks (a launcher such as "
                             f"torchrun with a world of {mesh.world}); this process is not one "
                             "rank of such a world")
    # The asymmetric mesh's primary control tree governs every GEMM of a
    # single-context step; homogeneous runs get the default single-class
    # context.
    exec_ctx = asym.execution_context() if asym is not None else execution.default_context()
    tcfg = TrainerConfig(
        steps=args.steps,
        global_batch=args.global_batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        n_micro=args.n_micro,
        class_sharded={"auto": None, "on": True, "off": False}[args.class_sharded],
    )
    return Trainer(cfg, tcfg=tcfg, opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps),
                   asym=asym, exec_ctx=exec_ctx, seed=args.seed, device=device, mesh=mesh,
                   **hooks)


def main(argv=None) -> dict:
    """Train from CLI ``argv``; prints and returns the reference's summary."""

    args = build_parser().parse_args(argv)
    trainer = make_trainer(args)
    t0 = time.time()
    history = trainer.run()
    ctx, asym, step = trainer.exec_ctx, trainer.asym, trainer.class_sharded_step
    out = {
        "arch": trainer.arch.name,
        "device_class": ctx.device_class,
        "exec_backend": ctx.backend(),
        "class_sharded": trainer.class_sharded_enabled(),
        "shard_classes": None if step is None else [
            (p.pod, p.device_class, p.block_source, p.backend) for p in step.provenance],
        "steps": len(history),
        "first_loss": history[0]["loss"],
        "last_loss": history[-1]["loss"],
        "restarts": trainer.restarts,
        "wall_s": round(time.time() - t0, 2),
        "chunk_sizes": asym.batch_layout(args.global_batch).sizes if asym else None,
    }
    if process_rank() == 0:  # under a launcher every rank trains; one prints
        print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
