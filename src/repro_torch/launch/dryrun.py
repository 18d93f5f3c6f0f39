"""Dry-run: every (arch x shape x mesh) cell's step on the ``meta`` device.

The port's counterpart of ``repro.launch.dryrun``.  The reference
AOT-lowers and compiles each cell on a 512-device placeholder mesh and
reads the program's memory and cost.  The port runs each cell's step
once on PyTorch's ``meta`` device (its ``jax.eval_shape``: shapes and
dtypes, no memory, no kernel) under the operator counter of
:mod:`repro_torch.launch.op_analysis`, and proves, without a card:

  * the step runs end to end at the cell's full shapes (every operator
    has a shape rule for its inputs);
  * whether it fits one H100 (``memory``: the arguments, the most bytes
    the step's own tensors held at once, the outputs, the state updated
    in place; ``fits`` against 80 GiB);
  * the roofline's inputs (``hlo_cost``: FLOPs, bytes, collective bytes,
    the GEMM funnel's calls and FLOPs), read by ``launch.roofline``.

The mesh is one card (tag ``card1``) unless ``--multi-pod`` (the
reference's 2x16x16, tag ``pod2x16x16``) or ``--both-meshes`` (16x16 and
2x16x16, tags ``pod16x16`` and ``pod2x16x16``) name the production
meshes.  There each cell runs once as rank 0 of the abstract mesh
(``launch.mesh.make_production_mesh`` without the ranks): its params,
AdamW state, batch and caches are rank 0's shards by the reference's
rules (FSDP unless ``--no-fsdp``, the stream sequence-sharded unless
``--no-seq-shard``, as the reference's dry-run), its collectives make
shapes and report their bytes, and the record is per device (``n_chips``
the mesh's size).  Every family runs sharded; a ``long_500k`` cell of a
full-attention model is skipped for the reference's reason.  ``--little-spec``
runs the cell class-sharded (``execution.class_sharded``: pod 0 under
``--spec``, pod 1 under the little spec): on one card the pods in turn;
with ``--multi-pod`` a rank a pod, the reference's ``run_cell`` with
``--multi-pod --little-spec``: rank 0 of the abstract (pod, data, model)
mesh runs its pod's program under its pod's class over its pod's rows
(the whole params and AdamW state, replicated over the pod's ``data`` and
``model`` ranks, as the reference's fully manual ``shard_map``), and the
record counts the epilogue's cross-pod collectives (a train cell's
all-reduces) or the logits' all-gather over ``pod``.  On the 16x16 mesh,
which has no pod axis, the cell runs sharded and single-class, as the
reference's does.

The backend is set, never probed: the cells run under an execution
context whose GEMM backend is ``--backend`` (default ``matmul``) and whose
attention runs the plain versions (``flash_attn_torch``; the decode cells'
dense caches attend in ``layers.grouped_attention``).  A kernel backend
(``cuda``, ``cuda_lean``) cannot run on the meta device and the cell
records the error, as the reference's Pallas backends fail off a TPU.  The
funnel's counts do not depend on the backend.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--force]
    python -m repro_torch.launch.dryrun --all --both-meshes

One JSON artifact per cell lands in ``artifacts/dryrun_torch/``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ArchConfig, ShapeSpec, get_config, list_configs
from repro_torch.core import execution as X
from repro_torch.launch import op_analysis
from repro_torch.models import model_zoo as Z
from repro_torch.optim import adamw as O

MESH_TAG = "card1"
# Device memory of one H100 80GB.
CARD_BYTES = 80 * 2**30
# The attention routes every dry-run cell takes (the plain versions).
ATTN_BACKENDS = {"flash_attn": "flash_attn_torch", "paged_attn": "paged_attn_torch"}
DEFAULT_OUT = os.path.join("artifacts", "dryrun_torch")


def _config(arch) -> ArchConfig:
    return arch if isinstance(arch, ArchConfig) else get_config(arch)


def _shape(cfg, shape) -> ShapeSpec:
    if isinstance(shape, ShapeSpec):
        return shape
    return next(s for s in cfg.shapes(include_skipped=True) if s.name == shape)


def meta_params(cfg, *, train: bool, device="meta"):
    """The cell's params: fp32 masters that require grad for a train cell
    (the trainer's), else the reference's serving rule (fp32 leaves of two
    or more dims in bf16, the rest fp32).  On ``meta`` nothing is drawn."""

    params = Z.init_params(cfg, None, device, dtype=torch.float32)
    if train:
        return O.tree_map(lambda p: p.requires_grad_(True), params)
    return O.tree_map(
        lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 and p.ndim >= 2 else p,
        params,
    )


def make_asym(spec_name: str, little_spec: str, backend: str):
    """The two-class mesh of a class-sharded cell (the reference's: the
    little class at 0.35 of the big class's throughput)."""

    from repro_torch.core.asymmetric import AsymmetricMesh, DeviceClass
    from repro_torch.tuning.candidates import get_spec

    return AsymmetricMesh(
        [DeviceClass("big", spec=get_spec(spec_name)),
         DeviceClass("little", spec=get_spec(little_spec), rel_throughput=0.35)],
        backend=backend,
    )


def mesh_tag(mesh) -> str:
    """``card1``, the production meshes' ``pod16x16`` / ``pod2x16x16``, or
    ``mesh`` and the sizes of another rank mesh (``mesh2x2``)."""

    if mesh is None:
        return MESH_TAG
    sizes = tuple(mesh.axis_sizes)
    if sizes in ((16, 16), (2, 16, 16)):
        return "pod" + "x".join(map(str, sizes))
    return "mesh" + "x".join(map(str, sizes))


def _build_sharded(cfg, shape, mesh, *, remat: bool, fsdp: bool, seq_shard: bool, batch=None):
    """The cell as rank ``mesh.rank`` runs it on a rank mesh
    (``transformer.*_sharded``, ``encdec.*_sharded``)."""

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import spmd
    from repro_torch.runtime.trainer import sharded_train_step

    device = mesh.device
    if batch is None:
        batch = Z.batch_spec(cfg, shape, device=device, mesh=mesh)
    else:  # the caller's whole batch: this rank's rows
        rows = SH.batch_pspec(mesh, shape.global_batch)
        batch = {k: SH.local_slice(v, rows, mesh) for k, v in batch.items()}
    if shape.kind == "train":
        loss = Z.make_loss_fn(cfg, remat=remat, mesh=mesh, fsdp=fsdp, seq_shard=seq_shard)
        lay = loss.layout
        params = spmd.shard_tree(meta_params(cfg, train=True, device=device), lay.specs, mesh,
                                 requires_grad=True)
        opt_state = O.init_opt_state(params)
        opt_cfg = O.AdamWConfig()

        def train_step(params, opt_state, b):
            with torch.enable_grad():
                params, opt_state, metrics = sharded_train_step(loss, params, opt_state, b,
                                                                opt_cfg, lay)
            return params, opt_state, metrics["loss"]

        return train_step, (params, opt_state, batch), (0, 1)
    params = spmd.shard_tree(meta_params(cfg, train=False, device=device),
                             Z.param_specs(cfg, mesh, fsdp=False), mesh)
    if shape.kind == "prefill":
        fn = Z.make_prefill_fn(cfg, attn_backend=ATTN_BACKENDS["flash_attn"], mesh=mesh,
                               seq_shard=seq_shard)
        return fn, (params, batch), ()
    state = Z.decode_state_spec(cfg, shape.global_batch, shape.seq_len, device=device, mesh=mesh)
    fn = torch.no_grad()(Z.make_decode_fn(cfg, mesh=mesh, batch=shape.global_batch,
                                          seq_len=shape.seq_len))
    pos = torch.zeros((), dtype=torch.int32, device=device)
    return fn, (params, batch, state, pos), (2,)


def _build_pod_ranks(cfg, shape, mesh, asym, *, remat: bool, batch=None):
    """The class-sharded cell as rank ``mesh.rank`` runs it, a rank a pod:
    its pod's program over the pod's rows of the whole batch (the whole
    params, and for a decode cell its pod's rows of the state)."""

    from repro_torch.distributed import sharding as SH

    device = mesh.device
    if batch is None:
        batch = Z.batch_spec(cfg, shape, device=device)
    if shape.kind == "train":
        from repro_torch.runtime.trainer import build_class_sharded_grad_step

        params = meta_params(cfg, train=True, device=device)
        opt_state = O.init_opt_state(params)
        opt_cfg = O.AdamWConfig()
        grad_fn = build_class_sharded_grad_step(Z.make_loss_fn(cfg, remat=remat), asym, mesh)

        def train_step(params, opt_state, b):
            with torch.enable_grad():
                l, _, grads = grad_fn(params, b)
            params, opt_state, _ = O.adamw_update(params, grads, opt_state, opt_cfg)
            return params, opt_state, l

        train_step.provenance = grad_fn.provenance
        return train_step, (params, opt_state, batch), (0, 1)
    params = meta_params(cfg, train=False, device=device)
    bspecs = SH.pod_batch_specs(batch)
    if shape.kind == "prefill":
        fn = asym.class_sharded(Z.make_prefill_fn(cfg, attn_backend=ATTN_BACKENDS["flash_attn"]),
                                mesh=mesh, in_specs=(None, bspecs), out_specs=SH.PodSplit(0))
        return fn, (params, batch), ()
    if shape.global_batch % asym.n_pods:
        raise ValueError(f"a batch of {shape.global_batch} does not split over {asym.n_pods} pods")
    state = Z.decode_state_spec(cfg, shape.global_batch // asym.n_pods, shape.seq_len,
                                device=device)
    fn = asym.class_sharded(torch.no_grad()(Z.make_decode_fn(cfg)), mesh=mesh,
                            in_specs=(None, bspecs, None, None),
                            out_specs=(SH.PodSplit(0), None))
    pos = torch.zeros((), dtype=torch.int32, device=device)
    return fn, (params, batch, state, pos), (2,)


def build_cell(arch, shape, *, remat: bool = True, asym=None, device="meta", mesh=None,
               fsdp: bool = True, seq_shard: bool = True, batch=None):
    """``(fn, args, alias)``: the cell's step, its inputs on ``device``, and
    the positions of ``args`` the step updates in place (params and
    optimizer state for a train cell, the decode state for a decode cell).

    ``arch`` is a config name or an :class:`ArchConfig` (a reduced one in
    the CPU tests); ``shape`` a shape name of the config or a
    :class:`ShapeSpec`.  With
    a multi-class ``asym`` the step runs class-sharded: each pod's rows
    under its own class's control tree (``execution.class_sharded``), the
    train cell's pods reduced by the trainer's epilogue.  With a rank
    ``mesh`` (abstract, on ``meta``) the step is the rank's part of the
    sharded step (``fsdp``, ``seq_shard`` as the reference's dry-run).
    ``batch`` (the whole batch, on ``device``) replaces ``batch_spec``'s
    inputs: an enc-dec's frames longer than its tokens, as
    ``chip_smoke.py`` trains whisper-small.  A multi-class ``asym`` on a
    rank ``mesh`` whose pod axis has its pod count runs the cell a rank a
    pod (:func:`_build_pod_ranks`).
    """

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import PodMesh

    cfg = _config(arch)
    shape = _shape(cfg, shape)
    mixed = asym is not None and len(asym.classes) > 1
    if mesh is not None:
        if mixed and mesh.shape.get("pod") == asym.n_pods:
            return _build_pod_ranks(cfg, shape, mesh, asym, remat=remat, batch=batch)
        return _build_sharded(cfg, shape, mesh, remat=remat, fsdp=fsdp, seq_shard=seq_shard,
                              batch=batch)
    if batch is None:
        batch = Z.batch_spec(cfg, shape, device=device)
    # One card: the pods as streams, in any world of ranks.
    mesh = PodMesh(("pod", "data", "model"), (asym.n_pods, 1, 1), torch.device(device)) \
        if mixed else None

    if shape.kind == "train":
        params = meta_params(cfg, train=True, device=device)
        opt_state = O.init_opt_state(params)
        opt_cfg = O.AdamWConfig()
        loss = Z.make_loss_fn(cfg, remat=remat)
        if mixed:
            from repro_torch.runtime.trainer import build_class_sharded_grad_step

            grad_fn = build_class_sharded_grad_step(loss, asym, mesh)
        else:
            grad_fn = lambda p, b: O.accumulate_gradients(loss, p, b, 1)  # noqa: E731

        def train_step(params, opt_state, b):
            with torch.enable_grad():
                l, _, grads = grad_fn(params, b)
            params, opt_state, _ = O.adamw_update(params, grads, opt_state, opt_cfg)
            return params, opt_state, l

        train_step.provenance = getattr(grad_fn, "provenance", ())
        return train_step, (params, opt_state, batch), (0, 1)

    params = meta_params(cfg, train=False, device=device)
    if shape.kind == "prefill":
        fn = Z.make_prefill_fn(cfg, attn_backend=ATTN_BACKENDS["flash_attn"])
        if mixed:
            fn = asym.class_sharded(fn, mesh=mesh, in_specs=(None, SH.pod_batch_specs(batch)),
                                    out_specs=SH.PodSplit(0))
        return fn, (params, batch), ()

    state = Z.decode_state_spec(cfg, shape.global_batch, shape.seq_len, device=device)
    decode = Z.make_decode_fn(cfg)
    fn = torch.no_grad()(decode)
    if mixed:
        sspecs = SH.pod_state_specs(state)
        fn = asym.class_sharded(fn, mesh=mesh,
                                in_specs=(None, SH.pod_batch_specs(batch), sspecs, None),
                                out_specs=(SH.PodSplit(0), sspecs))
    pos = torch.zeros((), dtype=torch.int32, device=device)
    return fn, (params, batch, state, pos), (2,)


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for t in op_analysis._tensors(tree)}


def run_cell(arch, shape, *, out_dir: str = DEFAULT_OUT, force: bool = False,
             remat: bool = True, tag: str = "", spec_name: str = "h100",
             little_spec: str = "", backend: str = "matmul", write: bool = True,
             mesh=None, fsdp: bool = True, seq_shard: bool = True, batch=None) -> dict:
    """Dry-run one cell and write its record (``write``); a record already
    on disk is returned unless ``force``.  ``mesh``: an abstract
    :class:`~repro_torch.launch.mesh.RankMesh` (``None``: one card);
    ``batch``: :func:`build_cell`'s."""

    cfg = _config(arch)
    shape = _shape(cfg, shape)
    tag_m = mesh_tag(mesh)
    cell_id = (
        f"{cfg.name}__{shape.name}__{tag_m}"
        + (f"__{spec_name}" if spec_name != "h100" else "")
        + (f"__mixed-{little_spec}" if little_spec else "")
        + (f"__{backend}" if backend != "matmul" else "")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
        + (f"__{tag}" if tag else "")
    )
    path = os.path.join(out_dir, cell_id + ".json")
    if write and os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    rec = {"arch": cfg.name, "shape": shape.name, "mesh": tag_m, "tag": tag,
           "ok": False, "skipped": False}
    if shape.name == "long_500k" and not cfg.subquadratic:
        rec.update(skipped=True, reason="full quadratic attention (see DESIGN.md)")
        if write:
            _write(path, rec)
        return rec

    try:
        from repro_torch.tuning.candidates import get_spec

        if X.PLAIN_TWIN.get(backend) != backend:
            raise ValueError(
                f"backend {backend!r} launches a CUDA kernel, which cannot run on the "
                "meta device; the dry-run takes a plain GEMM backend "
                f"({sorted(n for n, t in X.PLAIN_TWIN.items() if n == t and X.BACKEND_OPS[n] == 'gemm')})"
            )
        asym = make_asym(spec_name, little_spec, backend) if little_spec else None
        exec_ctx = X.default_context(spec=get_spec(spec_name), backend=backend)
        t0 = time.time()
        with exec_ctx:
            fn, args, alias = build_cell(cfg, shape, remat=remat, asym=asym, mesh=mesh,
                                         fsdp=fsdp, seq_shard=seq_shard, batch=batch)
            with op_analysis.count_ops() as cost:
                out = fn(*args)
        t_lower = time.time() - t0
        # The arguments the step reads or writes (an unused one, such as a
        # recurrent decode step's position, is pruned by the reference's
        # jit and held by nobody here).
        arg_bytes = sum(t.numel() * t.element_size() for t in op_analysis._tensors(args)
                        if t.untyped_storage()._cdata in cost.touched)
        alias_bytes = op_analysis.tree_bytes([args[i] for i in alias])
        out_bytes = op_analysis.tree_bytes(out)
        # Outputs in storages the step created (the logits, the loss) are
        # part of its peak; those it updated in place are arguments.
        in_store = _storages(args)
        new_out = sum(t.numel() * t.element_size() for t in op_analysis._tensors(out)
                      if t.untyped_storage()._cdata not in in_store)
        total = arg_bytes + cost.peak_live_bytes
        provenance = getattr(fn, "provenance", ())
        rec.update(
            ok=True,
            device="meta",
            device_class=exec_ctx.device_class,
            exec_backend=exec_ctx.backend(),
            attn_backends=dict(ATTN_BACKENDS),
            class_sharded=bool(provenance),
            shard_classes=(
                [(p.pod, p.device_class, p.block_source, p.backend) for p in provenance]
                if provenance else None
            ),
            n_chips=mesh.world if mesh is not None else 1,
            mesh_shape=dict(mesh.shape) if mesh is not None else None,
            fsdp=fsdp if mesh is not None else None,
            seq_shard=seq_shard if mesh is not None else None,
            batch=shape.global_batch,
            seq_len=shape.seq_len,
            kind=shape.kind,
            lower_s=round(t_lower, 2),
            memory={
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": cost.peak_live_bytes - new_out,
                "alias_bytes": alias_bytes,
                "total_bytes": total,
            },
            fits=total <= CARD_BYTES,
            hlo_cost=cost.as_dict(),
            op_count=cost.op_count,
            top=cost.top(8),
        )
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        rec.update(error=f"{type(e).__name__}: {e}", trace=traceback.format_exc()[-2000:])
    if write:
        _write(path, rec)
    return rec


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.tuning.candidates import SPECS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2x16x16 mesh (rank 0 of 512, abstract)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the reference's 16x16 and 2x16x16 meshes")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="on a production mesh, shard the train cells' params over model only")
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="on a production mesh, keep the residual stream's sequence whole")
    ap.add_argument("--spec", default="h100", choices=sorted(SPECS),
                    help="class spec whose execution context runs the cells")
    ap.add_argument("--little-spec", default="", choices=[""] + sorted(SPECS),
                    help="second device class: run the cell class-sharded (pod 0 under "
                         "--spec, pod 1 under this spec): on one card in turn, with "
                         "--multi-pod a rank a pod")
    ap.add_argument("--backend", default="matmul",
                    choices=sorted(n for n, op in X.BACKEND_OPS.items() if op == "gemm"),
                    help="GEMM dispatch entry the cells run with (never probed); the "
                         "kernel entries cannot run on the meta device and fail the cell")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.both_meshes:
        meshes = [make_production_mesh(multi_pod=False, device="meta"),
                  make_production_mesh(multi_pod=True, device="meta")]
    elif args.multi_pod:
        meshes = [make_production_mesh(multi_pod=True, device="meta")]
    else:
        meshes = [None]
    if any(m is not None and not m.is_abstract for m in meshes):
        ap.error("the dry-run runs rank 0 of the abstract mesh, not under a launcher's world")

    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    n_ok = n_fail = n_skip = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = (
            [s.name for s in cfg.shapes(include_skipped=True)]
            if (args.all or not args.shape) else [args.shape]
        )
        for shape in shapes:
            for mesh in meshes:
                rec = run_cell(arch, shape, out_dir=args.out, force=args.force,
                               remat=not args.no_remat, tag=args.tag, spec_name=args.spec,
                               little_spec=args.little_spec, backend=args.backend, mesh=mesh,
                               fsdp=not args.no_fsdp, seq_shard=not args.no_seq_shard)
                if rec.get("skipped"):
                    n_skip += 1
                    status = "SKIP"
                elif rec.get("ok"):
                    n_ok += 1
                    status = "ok"
                else:
                    n_fail += 1
                    status = "FAIL"
                mem = rec.get("memory", {}).get("total_bytes")
                mem_s = f"{mem / 2**30:8.2f} GiB/card" if mem else "-"
                print(
                    f"[{status:4s}] {arch:18s} {shape:12s} {rec['mesh']:10s} {mem_s} "
                    f"fits={rec.get('fits', '-')} lower={rec.get('lower_s', '-')}s"
                    + (f"  err={rec.get('error', '')[:120]}" if status == "FAIL" else ""),
                    flush=True,
                )
    print(f"\ndry-run summary: ok={n_ok} fail={n_fail} skip={n_skip}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()


__all__ = ["CARD_BYTES", "MESH_TAG", "build_cell", "main", "make_asym", "mesh_tag", "meta_params",
           "run_cell"]
