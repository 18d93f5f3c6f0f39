"""Rank functions for ``tests/test_torch_spmd.py``, run in spawned
``torch.distributed`` processes (``launch.mesh.spawn_ranks``): this module
is imported there by its path, so it imports the port only.

:func:`mesh_run` builds the reduced internlm2-1.8b trainer on one mesh
from the reference's parameters and reports, on rank 0, what the test
holds against the reference and the one-process port.
"""

import contextlib

import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core import execution as X
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model_zoo as Z
from repro_torch.optim import adamw as O
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ARCH = "internlm2-1.8b"


@contextlib.contextmanager
def counting():
    """``{"gemm": calls through the GEMM funnel, "bytes": {kind: bytes}}``
    of what runs inside."""

    seen = {"gemm": 0, "bytes": {}}
    orig = X.dispatch_gemm

    def gemm(*a, **k):
        seen["gemm"] += 1
        return orig(*a, **k)

    def coll(kind, nbytes):
        seen["bytes"][kind] = seen["bytes"].get(kind, 0) + nbytes

    X.dispatch_gemm = gemm
    C.COLLECTIVE_OBSERVERS.append(coll)
    try:
        yield seen
    finally:
        C.COLLECTIVE_OBSERVERS.remove(coll)
        X.dispatch_gemm = orig


def _gathered_logits(logits, mesh):
    out = C.all_gather(logits, mesh, "model", logits.ndim - 1)
    return C.all_gather(out, mesh, SH.dp_axes(mesh), 0)


def _logits(cfg, mesh, params_np, tokens, prefill_len, seq_len):
    """Prefill logits over ``tokens`` and the logits of one decode step
    after a bulk prefill of ``prefill_len`` of them, gathered whole."""

    params = params_from_jax(params_np, cfg, device="cpu", mesh=mesh)
    b = tokens.shape[0]
    rows = SH.local_slice(tokens, SH.batch_pspec(mesh, b), mesh)
    prefill = Z.make_prefill_fn(cfg, mesh=mesh)(params, {"tokens": rows})
    state = Z.init_decode_state(cfg, b, seq_len, device="cpu", mesh=mesh)
    with torch.no_grad():
        _, state = Z.make_prefill_fn(cfg, with_cache=True, mesh=mesh, batch=b, seq_len=seq_len)(
            params, {"tokens": rows[:, :prefill_len]}, state, 0)
        step, _ = Z.make_decode_fn(cfg, mesh=mesh, batch=b, seq_len=seq_len)(
            params, {"tokens": rows[:, prefill_len:prefill_len + 1]}, state, prefill_len)
    return _gathered_logits(prefill, mesh), _gathered_logits(step, mesh)


def _grads(cfg, mesh, params, batch, seq_shard):
    """Loss and whole gradients of one batch, the stream sequence-sharded
    or not."""

    lf = Z.make_loss_fn(cfg, mesh=mesh, seq_shard=seq_shard)
    specs = lf.layout.specs
    b = batch["tokens"].shape[0]
    rows = {k: SH.local_slice(v, SH.batch_pspec(mesh, b), mesh) for k, v in batch.items()}
    loss, _, grads = O.value_and_grad(lf, params, rows)
    grads = spmd.sync_grads(grads, specs, mesh)
    return float(spmd.dp_sum(loss, mesh)), spmd.gather_full(grads, specs, mesh)


def mesh_run(rank, plan):
    """One mesh's run (``plan``: a dict, see the test); rank 0 returns the
    results, the others ``None``."""

    data, model, pod = plan["mesh"]
    mesh = make_host_mesh(data=data, model=model, pod=pod, device="cpu")
    cfg = get_config(ARCH).reduced()
    out = {}
    params, _ = train_state_from_jax(plan["params"], None, device="cpu", cfg=cfg, mesh=mesh)
    tcfg = TrainerConfig(ckpt_dir=plan["ckpt_dir"], ckpt_every=100, **plan["tcfg"])
    opt_cfg = O.AdamWConfig(**plan["opt"])
    trainer = Trainer(cfg, tcfg=tcfg, opt_cfg=opt_cfg, device="cpu", mesh=mesh, params=params)
    batch0, _ = trainer.next_batch(0)
    full0 = {k: torch.from_numpy(v) for k, v in trainer.data.batch(0, tcfg.global_batch,
                                                                   tcfg.seq_len).items()}
    out["grads"] = _grads(cfg, mesh, trainer.params, full0, seq_shard=False)
    if plan.get("seq_shard_grads"):
        out["grads_seq_shard"] = _grads(cfg, mesh, trainer.params, full0, seq_shard=True)

    history = []
    for step in range(tcfg.steps):
        batch, _ = trainer.next_batch(step)
        with counting() as seen:
            m = trainer.train_step(batch)
        history.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                        "lr": float(m["lr"]), "gemm_calls": seen["gemm"],
                        "collective_bytes": seen["bytes"]})
        trainer.step = step + 1
    out["history"] = history
    out["local_batch_rows"] = int(batch0["tokens"].shape[0])
    out["specs"] = trainer.layout.specs
    out["logits"] = _logits(cfg, mesh, plan["params"], plan["tokens"], plan["prefill_len"],
                            plan["seq_len"])

    if plan.get("reshard"):
        trainer._checkpoint()  # written whole by rank 0
        out["params_at_ckpt"] = spmd.gather_full(trainer.params, trainer.layout.specs, mesh)
        d2, m2, p2 = plan["reshard"]
        new_mesh = make_host_mesh(data=d2, model=m2, pod=p2, device="cpu")
        trainer.reshard(new_mesh)
        batch, _ = trainer.next_batch(trainer.step)
        out["resharded_loss"] = float(trainer.train_step(batch)["loss"])
        fresh = Trainer(cfg, tcfg=tcfg, opt_cfg=opt_cfg, device="cpu", mesh=new_mesh)
        fresh._restart()
        out["restored_step"] = fresh.step
        batch, _ = fresh.next_batch(fresh.step)
        out["restored_loss"] = float(fresh.train_step(batch)["loss"])

    if plan.get("cp"):  # context-parallel heads: n_heads the model axis does not divide
        ccfg = plan["cp"]["cfg"]
        specs = Z.param_specs(ccfg, mesh, fsdp=True)
        cparams = spmd.shard_tree(plan["cp"]["params"], specs, mesh, requires_grad=True)
        batch = plan["cp"]["batch"]
        lf = Z.make_loss_fn(ccfg, mesh=mesh)
        rows = {k: SH.local_slice(v, SH.batch_pspec(mesh, v.shape[0]), mesh) for k, v in batch.items()}
        loss, _, grads = O.value_and_grad(lf, cparams, rows)
        grads = spmd.sync_grads(grads, specs, mesh)
        sspecs = Z.param_specs(ccfg, mesh, fsdp=False)
        serve = spmd.shard_tree(plan["cp"]["serve"], sspecs, mesh)
        logits = Z.make_prefill_fn(ccfg, mesh=mesh)(serve, {"tokens": rows["tokens"]})
        out["cp"] = (float(spmd.dp_sum(loss, mesh)), spmd.gather_full(grads, specs, mesh),
                     _gathered_logits(logits, mesh))
    return out if rank == 0 else None


def card_run(rank, plan):
    """Reduced internlm2-1.8b from seed 0 on ``cuda`` ranks sharing the
    card (``gloo``, staged through host memory): ``plan["steps"]`` training
    steps, each step's loss and its launches, and the collectives on CUDA
    tensors against their definitions; every rank returns its results."""

    from repro_torch.kernels import gemm as G

    data, model, pod = plan["mesh"]
    mesh = make_host_mesh(data=data, model=model, pod=pod, device="cuda")
    cfg = get_config(ARCH).reduced()
    tcfg = TrainerConfig(ckpt_dir=plan["ckpt_dir"], ckpt_every=100, **plan["tcfg"])
    trainer = Trainer(cfg, tcfg=tcfg, opt_cfg=O.AdamWConfig(**plan["opt"]), device="cuda", mesh=mesh)
    out = {"device": str(mesh.device), "transport": mesh.transport, "steps": []}
    for step in range(tcfg.steps):
        batch, _ = trainer.next_batch(step)
        G.reset_launches()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        out["steps"].append({"loss": float(m["loss"]), "launches": dict(G.LAUNCHES)})
    x = torch.full((2, 3), float(rank + 1), device=mesh.device)
    out["gathered"] = C.all_gather(x, mesh, "model", 1).cpu()
    out["reduced"] = C.all_reduce(x, mesh, ("data", "model")).cpu()
    out["scattered"] = C.reduce_scatter(torch.arange(8.0, device=mesh.device).reshape(4, 2), mesh,
                                        "data", 0).cpu()
    return out
