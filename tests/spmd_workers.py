"""Rank functions for ``tests/test_torch_spmd*.py``, run in spawned
``torch.distributed`` processes (``launch.mesh.spawn_ranks``): this module
is imported there by its path, so it imports the port only.

:func:`mesh_run` builds the reduced internlm2-1.8b trainer on one mesh
from the reference's parameters and reports, on rank 0, what the test
holds against the reference and the one-process port; :func:`family_run`
runs the other families' cases (the trainer, gradients, prefill and
decode steps, the MoE routing optionally forced).
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
    """``{"gemm": calls through the GEMM funnel, "flash": full-sequence
    attention calls, "bytes": {kind: bytes}}`` of what runs inside."""

    seen = {"gemm": 0, "flash": 0, "bytes": {}}
    orig, orig_flash = X.dispatch_gemm, X.dispatch_flash_attention

    def gemm(*a, **k):
        seen["gemm"] += 1
        return orig(*a, **k)

    def flash(*a, **k):
        seen["flash"] += 1
        return orig_flash(*a, **k)

    def coll(kind, nbytes):
        seen["bytes"][kind] = seen["bytes"].get(kind, 0) + nbytes

    X.dispatch_gemm, X.dispatch_flash_attention = gemm, flash
    C.COLLECTIVE_OBSERVERS.append(coll)
    try:
        yield seen
    finally:
        C.COLLECTIVE_OBSERVERS.remove(coll)
        X.dispatch_gemm, X.dispatch_flash_attention = orig, orig_flash


@contextlib.contextmanager
def local_mean_norm():
    """A planted sharding fault: ``spmd.rms_norm_split`` taking its mean
    over this rank's features alone, as a rank-local norm would."""

    from repro_torch.distributed import spmd
    from repro_torch.models import layers as L

    real = spmd.rms_norm_split
    spmd.rms_norm_split = lambda x, w, lay, eps=1e-5: L.rms_norm(x, w, eps)
    try:
        yield
    finally:
        spmd.rms_norm_split = real


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


# ---------------------------------------------------------------------------
# The other families (tests/test_torch_spmd_{moe,ssm,encdec}.py)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def forced_routing(ids, mesh):
    """``moe.route`` patched to take the given top-k ids, one (G, S, k)
    array a call in call order, each over the whole batch's routing
    groups: a rank routing only its own groups takes its block of them
    (its dp index).  The gate weights stay the port's probabilities at
    those ids, renormalised."""

    from repro_torch.models import moe as M

    real = M.route
    calls = [0]

    def route(p, x, cfg):
        _, _, probs = real(p, x, cfg)
        idx = torch.from_numpy(ids[calls[0]]).long()
        calls[0] += 1
        g = x.shape[0]
        if idx.shape[0] != g:
            i = mesh.index(SH.dp_axes(mesh))
            idx = idx[i * g:(i + 1) * g]
        assert tuple(idx.shape[:2]) == tuple(x.shape[:2]), (idx.shape, x.shape)
        gate_w = probs.gather(-1, idx)
        return gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9), idx, probs

    M.route = route
    try:
        yield calls
    finally:
        M.route = real


def _maybe_forced(ids, mesh):
    return forced_routing(ids, mesh) if ids is not None else contextlib.nullcontext([0])


def _rows(tree, mesh, b):
    spec = SH.batch_pspec(mesh, b)
    return {k: SH.local_slice(torch.as_tensor(v), spec, mesh) for k, v in tree.items()}


def _family_grads(cfg, mesh, params_np, batch, ids, seq_shard):
    """Loss and whole gradients of one batch (no remat: a forced routing is
    read once a layer in order)."""

    params, _ = train_state_from_jax(params_np, None, device="cpu", cfg=cfg, mesh=mesh)
    lf = Z.make_loss_fn(cfg, mesh=mesh, remat=False, seq_shard=seq_shard)
    rows = _rows(batch, mesh, next(iter(batch.values())).shape[0])
    with _maybe_forced(ids, mesh) as calls:
        loss, metrics, grads = O.value_and_grad(lf, params, rows)
    grads = spmd.sync_grads(grads, lf.layout.specs, mesh)
    return {"loss": float(spmd.dp_sum(loss, mesh)), "aux": float(spmd.dp_sum(metrics["aux"], mesh)),
            "grads": spmd.gather_full(grads, lf.layout.specs, mesh), "route_calls": calls[0]}


def _family_prefill(cfg, mesh, serve, batch, ids):
    b = batch["tokens"].shape[0]
    with torch.no_grad(), _maybe_forced(ids, mesh):
        with counting() as seen:
            logits = Z.make_prefill_fn(cfg, mesh=mesh)(serve, _rows(batch, mesh, b))
    return {"logits": Z.gather_logits(logits, cfg, mesh, b), "gemm_calls": seen["gemm"],
            "flash_calls": seen["flash"]}


def _family_decode(cfg, mesh, serve, case):
    """A bulk prefill of ``prefill_len`` tokens through the decode step,
    then one step, over a cache of ``seq_len`` positions: the last step's
    logits, whole, and its GEMM calls and collective bytes."""

    from repro_torch.models import encdec as E

    tokens = torch.as_tensor(case["tokens"])
    b, n = tokens.shape[0], case["prefill_len"]
    state = Z.init_decode_state(cfg, b, case["seq_len"], device="cpu", mesh=mesh)
    decode = Z.make_decode_fn(cfg, mesh=mesh, batch=b, seq_len=case["seq_len"])
    rows = _rows({"tokens": tokens}, mesh, b)["tokens"]
    with torch.no_grad(), _maybe_forced(case.get("ids"), mesh):
        if "frames" in case:
            frames = _rows({"f": case["frames"]}, mesh, b)["f"]
            E.fill_cross_kv_sharded(serve, cfg, frames, state, decode.layout, decode.cache_specs)
        if n:
            _, state = Z.make_prefill_fn(cfg, with_cache=True, mesh=mesh, batch=b,
                                         seq_len=case["seq_len"])(
                serve, {"tokens": rows[:, :n]}, state, 0)
        with counting() as seen:
            logits, _ = decode(serve, {"tokens": rows[:, n:n + 1]}, state, n)
    return {"logits": Z.gather_logits(logits, cfg, mesh, b), "gemm_calls": seen["gemm"],
            "flash_calls": seen["flash"], "collective_bytes": seen["bytes"],
            "specs": {k: v for k, v in decode.cache_specs.items() if k != "mamba"},
            "ssm_spec": decode.cache_specs.get("mamba", {}).get("ssm")}


def _family_step(cfg, mesh, params_np, batch):
    """One ``trainer.sharded_train_step`` on the training loss (remat):
    the enc-dec's gradient step, which the trainer's data cannot feed."""

    from repro_torch.runtime.trainer import sharded_train_step

    params, opt_state = train_state_from_jax(params_np, None, device="cpu", cfg=cfg, mesh=mesh)
    lf = Z.make_loss_fn(cfg, mesh=mesh)
    rows = _rows(batch, mesh, next(iter(batch.values())).shape[0])
    _, _, m = sharded_train_step(lf, params, opt_state, rows, O.AdamWConfig(), lf.layout)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def _family_train(cfg, mesh, case):
    params, _ = train_state_from_jax(case["params"], None, device="cpu", cfg=cfg, mesh=mesh)
    tcfg = TrainerConfig(ckpt_dir=case["ckpt_dir"], ckpt_every=100, **case["tcfg"])
    trainer = Trainer(cfg, tcfg=tcfg, opt_cfg=O.AdamWConfig(**case["opt"]), device="cpu",
                      mesh=mesh, params=params)
    history = []
    for step in range(tcfg.steps):
        batch, _ = trainer.next_batch(step)
        with counting() as seen:
            m = trainer.train_step(batch)
        history.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                        "lr": float(m["lr"]), "aux": float(m.get("aux", 0.0)),
                        "gemm_calls": seen["gemm"], "collective_bytes": seen["bytes"]})
        trainer.step = step + 1
    # Each step again from the reference's state before it: AdamW turns
    # last-bit differences of near-zero gradients into whole-lr updates,
    # so free-running grad norms part by more than their tolerance (the
    # reference's own trainer on two meshes does too).
    replay = []
    for step, state in enumerate(case.get("states", ())):
        trainer.params, trainer.opt_state = train_state_from_jax(*state, device="cpu", cfg=cfg,
                                                                 mesh=mesh)
        m = trainer.train_step(trainer.next_batch(step)[0])
        replay.append({k: float(v) for k, v in m.items() if k in ("loss", "grad_norm", "lr", "aux")})
    return {"history": history, "replay": replay}


def family_run(rank, plan):
    """Every case of ``plan["cases"]`` on one mesh (``plan["mesh"]``:
    ``(data, model)``); rank 0 returns ``{case name: results}``.  A case
    holds the config (``cfg``), the reference's numpy params and any of:
    ``train`` (the trainer's steps), ``grads`` (a batch, its forced routing
    ``ids`` or ``None``; with ``seq_shard`` also sequence-sharded),
    ``prefill`` (a batch and ``ids``), ``decodes`` (name -> a decode case
    of :func:`_family_decode`)."""

    data, model = plan["mesh"]
    mesh = make_host_mesh(data=data, model=model, device="cpu")
    out = {}
    for case in plan["cases"]:
        cfg, res = case["cfg"], {}
        if "train" in case:
            res.update(_family_train(cfg, mesh, dict(case["train"], params=case["params"])))
        if "grads" in case:
            g = case["grads"]
            res["grads"] = _family_grads(cfg, mesh, case["params"], g["batch"], g["ids"], False)
            if g.get("seq_shard"):
                res["grads_seq_shard"] = _family_grads(cfg, mesh, case["params"], g["batch"],
                                                       g["ids"], True)
        if "step" in case:  # the sharded gradient step itself (AdamW, the global norm)
            res["step"] = _family_step(cfg, mesh, case["params"], case["step"])
        serve = params_from_jax(case["params"], cfg, device="cpu", mesh=mesh)
        if "prefill" in case:
            res["prefill"] = _family_prefill(cfg, mesh, serve, case["prefill"]["batch"],
                                             case["prefill"]["ids"])
            if case["prefill"].get("local_norm"):  # a planted fault: each rank's own mean
                with local_mean_norm():
                    res["prefill_local_norm"] = _family_prefill(cfg, mesh, serve, case["prefill"]["batch"],
                                                                case["prefill"]["ids"])
        for name, dec in case.get("decodes", {}).items():
            res[name] = _family_decode(cfg, mesh, serve, dec)
        out[case["name"]] = res
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# The class-sharded step a rank a pod (tests/test_torch_pod_ranks.py)
# ---------------------------------------------------------------------------


def grad_asym():
    """Two classes at a 2:1 ratio, ``sas`` over tiles of 2 (the mixed
    gradient step's fixture in ``test_torch_class_sharded.py``)."""

    from repro_torch.core import blocking as B
    from repro_torch.core.asymmetric import AsymmetricMesh, DeviceClass

    return AsymmetricMesh([DeviceClass("big", spec=B.hopper_spec()),
                           DeviceClass("little", rel_throughput=0.5, spec=B.hopper_spec(little=True))],
                          strategy="sas", batch_tile=2,
                          backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)


def serve_asym():
    """The serving tests' two classes (``test_torch_mixed_serving._mesh``)."""

    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes

    return AsymmetricMesh(biglittle_classes(chips_per_pod=1), strategy="ca-das", batch_tile=1,
                          backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)


def serve_requests(engine, reqs) -> dict:
    """``{rid: tokens}`` of ``reqs`` ((prompt, max_new) pairs) served to
    completion."""

    rids = [engine.submit(p, n) for p, n in reqs]
    done = {c.rid: c.tokens.tolist() for c in engine.run()}
    return {r: done[r] for r in rids}


def pod_run(rank, plan):
    """One rank of the class-sharded step a rank a pod on a (pod, data, 1)
    mesh; every rank returns its results (``plan``: see the test)."""

    from repro_torch.distributed import collectives as C
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.runtime import trainer as TR
    from repro_torch.runtime.serving import ServingEngine

    mesh = make_host_mesh(pod=2, data=plan.get("data", 1), device="cpu")
    assert isinstance(mesh, RankMesh) and mesh.transport == "gloo", mesh
    cfg = get_config(ARCH).reduced()
    out = {"rank": rank, "pod": mesh.coord("pod"), "shape": mesh.shape}
    params, _ = train_state_from_jax(plan["params"], None, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in plan["batch"].items()}
    out["grad"] = {}
    for n_micro in plan["n_micro"]:
        step = TR.build_class_sharded_grad_step(Z.make_loss_fn(cfg), grad_asym(), mesh,
                                                n_micro=n_micro)
        with counting() as seen:
            loss, metrics, grads = step(params, batch)
        out["grad"][n_micro] = {"loss": loss, "metrics": metrics, "grads": grads, "pod": step.pod,
                                "mixed": step.mixed, "trace": list(step.trace_log),
                                "backends": [p.backend for p in step.provenance],
                                "gemm_calls": seen["gemm"], "bytes": seen["bytes"]}
    if not plan.get("serve"):
        return out

    # The engine, dense and paged, and the one-shot path.
    serving = params_from_jax(plan["params"], cfg, device="cpu")
    out["engine"] = {}
    for paged in ("off", "on"):
        eng = ServingEngine(cfg, serving, serve_asym(), seq_cap=plan["seq_cap"], device="cpu",
                            class_sharded="on", pod_time_hook=None, slots_per_pod=3, paged=paged,
                            page_size=4, eos_id=plan["eos_id"])
        assert eng.ranks and eng.pod == mesh.coord("pod")
        out["engine"][paged] = {"tokens": serve_requests(eng, plan["reqs"]),
                                "kv": eng.kv_stats(), "health": eng.health(),
                                "state_rows": [int(x.shape[1]) for x in
                                               (eng.state.values() if paged == "off" else [])]}
    eng = ServingEngine(cfg, serving, serve_asym(), seq_cap=plan["seq_cap"], device="cpu",
                        class_sharded="on", pod_time_hook=None,
                        slots_per_pod=serve_asym().batch_layout(len(plan["prompts"])).c_max)
    out["generate"] = eng.generate(plan["prompts"], plan["gen"])
    asym = serve_asym()
    padded, order = SV.pad_requests(plan["prompts"], asym.batch_layout(len(plan["prompts"])))
    step = SV.mixed_decode_step(cfg, asym, mesh, len(padded), plan["seq_cap"])
    tokens, _ = SV.generate(cfg, serving, padded, plan["gen"], plan["seq_cap"], device="cpu",
                            decode=step, prefill=Z.bulk_prefill_from_decode(step),
                            state_rows=len(padded) // 2)
    out["one_shot"] = tokens[order]

    # Different per-rank step times: every rank's scheduler sees the same
    # gathered vector (each rank's own pod's entry).
    times = plan["pod_times"][rank]
    tr = Trainer(cfg, tcfg=TrainerConfig(steps=2, global_batch=8, seq_len=16, ckpt_every=100,
                                         ckpt_dir=plan["ckpt_dir"], class_sharded=True),
                 asym=serve_asym(), device="cpu", mesh=mesh, params=params,
                 pod_time_hook=lambda step: times,
                 opt_cfg=O.AdamWConfig(lr=1e-3, total_steps=2, warmup_steps=1))
    assert tr.pod_ranks and not tr.sharded
    hist = tr.run()
    out["das"] = {"rates": [float(r) for r in tr.asym.scheduler.rates],
                  "sizes": tr.asym.batch_layout(8).sizes, "losses": [h["loss"] for h in hist],
                  "params": O.tree_leaves(tr.params)[0].detach().clone()}

    # The int8 cross-pod mean: the reference's replicated tree, then a
    # tree of this rank's own.
    g = O.tree_map(torch.from_numpy, plan["crosspod"]["g"])
    e = O.tree_map(torch.from_numpy, plan["crosspod"]["e"])
    out["crosspod_same"] = C.compressed_crosspod_mean(g, e, mesh)
    mine = O.tree_map(lambda t: t * (1 - 3 * mesh.coord("pod")), g)
    out["crosspod_own"] = C.compressed_crosspod_mean(mine, C.init_error_feedback(mine), mesh)

    # Both CLIs on the ranks (the process group is the launcher's).
    out["serve_cli"] = SV.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "4",
                                "--prompt-len", "4", "--gen-len", "3", "--class-sharded", "on"])
    out["train_cli"] = TL.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2",
                                "--seq", "16", "--heterogeneous", "--class-sharded", "on",
                                "--ckpt-dir", plan["ckpt_dir"] + "_cli"])
    return out
