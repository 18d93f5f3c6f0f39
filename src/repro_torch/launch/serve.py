"""Serving driver: a thin CLI over the persistent slot-table engine.

The port's counterpart of ``repro.launch.serve``.  The default path is
:class:`repro_torch.runtime.serving.ServingEngine`; ``--one-shot`` keeps
the legacy path (a per-call batch, prompt replayed through the decode
recurrence, token-by-token decode) as the comparison baseline, and
``--device-class`` serves it under one class's control tree.  Both run on
the CUDA card unless ``--device cpu`` is given (the kernels' plain
versions then run).  ``--trace``/``--metrics`` enable observability: the
engine's spans and metric families, and its default step-time probe,
which times each class's kernel and feeds the DAS scheduler.
``--objective energy|edp`` lets the engine park energy-inefficient pods
at low load; its joules are modeled from the class specs' power models,
not read from the card.  The Mamba2 families (mamba2-1.3b, zamba2-2.7b)
serve on dense lanes: ``--paged auto`` keeps them dense and ``--paged on``
is refused, as in the reference; the encoder-decoder and embedding-input
archs are refused.  ``--class-sharded on`` runs the mixed step: each pod
decodes its request shard under its own class's control tree
(``gemm_cuda`` for the big pod, ``gemm_cuda_lean`` for the little one),
a rank a pod under a launcher's world of one rank a pod (``torchrun
--nproc-per-node 2``: each rank holds the weights and its pod's state,
the logits are all-gathered over the pods, only rank 0 prints the
summary), else the pods as CUDA streams on the one card; ``auto`` takes
it only where each pod's rank has a card of its own (``nccl``), the
reference's ``device_count() >= n_pods`` (``launch.mesh.resolve_pods``).
``--fleet N`` serves through a fault-tolerant fleet of N engines
(:class:`repro_torch.runtime.fleet.Fleet`) behind one submit front; the
engines share the one device and one copy of the weights, and the fleet
steps them one after another each tick.

Examples (one H100; add ``--reduced --device cpu`` to run on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --batch 8 --prompt-len 16 --gen-len 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --paged on
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --one-shot \\
        --device-class little
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --batch 3 --slots-per-pod 4 --objective energy
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --class-sharded on [--paged on | --one-shot]
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch internlm2-1.8b --class-sharded on [--paged on | --one-shot]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --fleet 2 [--objective energy]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import process_rank, resolve_pods
from repro_torch.models import model_zoo as Z
from repro_torch.runtime.serving import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts, gen_len: int, seq_cap: int, *, device="cuda", decode=None,
             prefill=None, state_rows: int = 0):
    """Greedy decode: bulk prefill through the decode recurrence, then
    token by token, updating one cache in place.  ``decode`` / ``prefill``
    replace the model's (the mixed path passes its class-sharded step and
    the bulk prefill through it); ``state_rows`` sizes the cache when it
    holds fewer rows than the batch (a rank a pod: its pod's rows).

    Returns ``(tokens, timings)``; ``timings`` splits warm-up (the prefill
    and the first decode call) from steady-state decode.
    """

    device = resolve_device(device)
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(device)
    b, plen = prompts.shape
    decode = decode or Z.make_decode_fn(cfg)
    prefill = prefill or Z.make_prefill_fn(cfg, with_cache=True)
    state = Z.init_decode_state(cfg, state_rows or b, seq_cap, device=device)

    with torch.no_grad():
        t0 = time.perf_counter()
        logits, state = prefill(params, {"tokens": prompts}, state, 0)
        _sync(device)
        timings = {"compile_s": time.perf_counter() - t0, "decode_s": 0.0, "decode_steps": 0}
        out = [prompts.cpu().numpy()]
        for t in range(plen, plen + gen_len):
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            out.append(nxt.cpu().numpy())
            t1 = time.perf_counter()
            logits, state = decode(params, {"tokens": nxt}, state, t)
            _sync(device)
            dt = time.perf_counter() - t1
            if t == plen:  # first decode call warms up
                timings["compile_s"] += dt
            else:
                timings["decode_s"] += dt
                timings["decode_steps"] += 1
    return np.concatenate(out, axis=1), timings


def mixed_decode_step(cfg, asym, mesh, batch_padded: int, seq_cap: int):
    """The decode fn wrapped so each pod decodes its request shard under
    its own class's control tree (true CA-SAS serving: one step, two
    per-class programs).  Decode is pure data parallelism over requests —
    no cross-pod work, so no epilogue.  A rank a pod holds its pod's
    ``batch_padded / n_pods`` rows of the state (nothing to split or
    gather); the logits are all-gathered over the pods."""

    state_spec = Z.init_decode_state(cfg, batch_padded, seq_cap, device="meta")
    sspecs = None if hasattr(mesh, "coord") else SH.pod_state_specs(state_spec)
    bspecs = SH.pod_batch_specs({"tokens": 0})  # the decode batch tree
    return asym.class_sharded(
        Z.make_decode_fn(cfg),
        mesh=mesh,
        in_specs=(None, bspecs, sspecs, None),
        out_specs=(SH.PodSplit(0), sspecs),
    )


def _shard_summary(provenance):
    """``(shard_classes, device_class, exec_backend)`` of a mixed run: every
    pod's (pod, class, block source, backend), and every kernel variant."""

    return ([(p.pod, p.device_class, p.block_source, p.backend) for p in provenance], "mixed",
            "+".join(sorted({p.backend for p in provenance})))


def _one_shot(cfg, params, asym, prompts, args, seq_cap, device, mesh="resolve"):
    """The legacy path: under one class's control tree, or the mixed step
    over the requests laid out pod-major by the chunk table (``mesh``: the
    pods :func:`serve` resolved, else resolved here)."""

    if isinstance(mesh, str):
        try:  # an explicit class wins; a CLI error exits, as the reference's
            mesh = None if args.device_class is not None else \
                resolve_pods(args.class_sharded, asym, device)
        except ValueError as err:
            raise SystemExit(str(err)) from err
    layout = asym.batch_layout(args.batch)
    _say("request split across classes:", layout.sizes)
    if mesh is not None:
        # One step, one program per class: pod i's shard runs under
        # class(i)'s control tree (paper §5.3, serving side).
        padded, order = pad_requests(prompts, layout)
        step = mixed_decode_step(cfg, asym, mesh, padded.shape[0], seq_cap)
        rows = padded.shape[0] // asym.n_pods if hasattr(mesh, "coord") else 0
        out_padded, timings = generate(cfg, params, padded, args.gen_len, seq_cap, device=device,
                                       decode=step, prefill=Z.bulk_prefill_from_decode(step),
                                       state_rows=rows)
        return (out_padded[order], timings, *_shard_summary(step.provenance), None)
    exec_ctx = asym.execution_context(args.device_class)
    with exec_ctx:
        out, timings = generate(cfg, params, prompts, args.gen_len, seq_cap, device=device)
    return out, timings, None, exec_ctx.device_class, exec_ctx.backend(), None


def pad_requests(prompts: np.ndarray, layout):
    """Lay requests out pod-major per the chunk table; returns ``(padded,
    order)`` with ``padded[order] == prompts`` row for row.

    The padded rows are the engine's slot table with zero prompts in its
    free lanes, so the one-shot path over ``padded`` decodes what the
    engine decodes, the MoE family's capacity routing across rows
    included."""

    c_max = layout.c_max
    padded = np.zeros((len(layout.sizes) * c_max,) + prompts.shape[1:], prompts.dtype)
    order, pos = [], 0
    for i, size in enumerate(layout.sizes):
        padded[i * c_max : i * c_max + size] = prompts[pos : pos + size]
        order.extend(range(i * c_max, i * c_max + size))
        pos += size
    return padded, np.asarray(order, np.int64)


def truncate_at_eos(out: np.ndarray, prompt_len: int, eos_id: int):
    """EOS-aware stop for the one-shot path's dense output (the EOS token
    is kept, the tail zeroed).  Returns ``(out, n_eos, n_budget)``."""

    out = out.copy()
    gen = out[:, prompt_len:]
    hit = gen == eos_id
    n_eos = 0
    for r in range(out.shape[0]):
        idx = np.nonzero(hit[r])[0]
        if len(idx):
            gen[r, idx[0] + 1:] = 0
            n_eos += 1
    return out, n_eos, out.shape[0] - n_eos


def _engine(cfg, params, asym, prompts, args, seq_cap, device, mesh=None):
    """The persistent slot-table engine path (the default), on the pods
    :func:`serve` resolved (``None``: the single program)."""

    from repro_torch.runtime.serving import ServingEngine

    layout = asym.batch_layout(args.batch)
    _say("request split across classes:", layout.sizes)
    eng = ServingEngine(
        cfg, params, asym,
        seq_cap=seq_cap,
        slots_per_pod=args.slots_per_pod or layout.c_max,
        class_sharded="off" if mesh is None else args.class_sharded,
        paged=args.paged,
        page_size=args.page_size,
        pool_pages=args.pool_pages,
        eos_id=args.eos_id,
        device=device,
        mesh=mesh,
    )
    out = eng.generate(prompts, args.gen_len)
    st = eng.stats
    timings = {"compile_s": st.compile_s, "decode_s": st.decode_s,
               "decode_steps": st.decode_steps, "tokens": st.tokens}
    if eng.mixed:
        return (out, timings, *_shard_summary(eng.provenance), eng)
    ctx = asym.execution_context()
    return out, timings, None, ctx.device_class, ctx.backend(), eng


def _say(*words) -> None:
    """Print on rank 0 only (under a launcher every rank runs the CLI)."""

    if process_rank() == 0:
        print(*words)


def _fleet(cfg, params, asym, prompts, args, seq_cap, device, mesh=None):
    """The multi-engine fleet path (``--fleet N``): N engines, each on its
    own mesh, sharing ``params`` on ``device``, behind one submit front
    with DAS request scheduling over calibrated per-engine throughput."""

    from repro_torch.runtime.fleet import Fleet
    from repro_torch.runtime.serving import ServingEngine

    engines = []
    for _ in range(args.fleet):
        a = AsymmetricMesh(biglittle_classes(chips_per_pod=1), strategy=args.strategy,
                           batch_tile=1, objective=args.objective)
        layout = a.batch_layout(max(1, args.batch // args.fleet))
        engines.append(ServingEngine(
            cfg, params, a,
            seq_cap=seq_cap,
            slots_per_pod=args.slots_per_pod or layout.c_max,
            class_sharded=args.class_sharded,
            paged=args.paged,
            page_size=args.page_size,
            pool_pages=args.pool_pages,
            eos_id=args.eos_id,
            device=device,
        ))
    fleet = Fleet(engines, objective=args.objective)
    print("fleet rel_throughput:", [round(r, 3) for r in fleet.rel_throughput])
    out = fleet.generate(prompts, args.gen_len)
    # The fleet's span is the slowest engine's (engines would run side by
    # side given a device each), and each engine warms up once.
    timings = {
        "compile_s": max(e.stats.compile_s for e in engines),
        "decode_s": max(e.stats.decode_s for e in engines),
        "decode_steps": max(e.stats.decode_steps for e in engines),
        "tokens": sum(e.stats.tokens for e in engines),
    }
    if engines[0].mixed:
        return (out, timings, None, *_shard_summary(engines[0].provenance)[1:], fleet)
    ctx = engines[0].asym.execution_context()
    return out, timings, None, ctx.device_class, ctx.backend(), fleet


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (runs the kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--strategy", default="ca-das")
    ap.add_argument("--objective", default="perf", choices=["perf", "energy", "edp"],
                    help="engine scheduling objective: perf (default), energy (park "
                         "energy-inefficient pods at low load, weight shares by "
                         "joules a unit) or edp; the summary's energy_j and "
                         "tokens_per_j are modeled from the classes' PowerModel, "
                         "not read from the card")
    ap.add_argument("--device-class", default=None,
                    help="one-shot: serve under this class's control tree "
                         "(default: fastest)")
    ap.add_argument("--class-sharded", default="auto", choices=["auto", "on", "off"],
                    help="decode each pod's request shard under its own class's tree in "
                         "one step: a rank a pod under a launcher's world of one rank a "
                         "pod, else the pods as CUDA streams on one card; auto = on only "
                         "where each pod's rank has a card of its own")
    ap.add_argument("--one-shot", action="store_true",
                    help="legacy path: per-call batch + token-by-token decode")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve through a fault-tolerant fleet of N engines behind one "
                         "scheduler, sharing the device and the weights (0 = single engine)")
    ap.add_argument("--slots-per-pod", type=int, default=None,
                    help="engine slot-region size (default: the layout's c_max)")
    ap.add_argument("--paged", default="off", choices=["auto", "on", "off"],
                    help="engine KV storage: paged page pool instead of dense lanes")
    ap.add_argument("--page-size", type=int, default=None)
    ap.add_argument("--pool-pages", type=int, default=None)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable observability and write the trace here (summarize "
                         "with python -m repro_torch.observability.report)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="enable observability and write a metrics JSON snapshot here")
    return ap


def serve(args, *, params=None):
    """Run one serving session from parsed CLI ``args``.

    Returns ``(summary, tokens, engine)``: the JSON summary, the ``(batch,
    prompt + generated)`` tokens, and the
    :class:`~repro_torch.runtime.serving.ServingEngine` that served, the
    :class:`~repro_torch.runtime.fleet.Fleet` under ``--fleet N``
    (``None`` on the one-shot path).  ``params`` defaults to the random weights of
    ``--seed``.
    """

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.embed_inputs or cfg.family == "encdec":
        raise SystemExit(f"{cfg.name}: serving demo targets token-in archs")
    if args.class_sharded == "on" and args.device_class is not None:
        raise SystemExit(
            "--class-sharded on serves every class simultaneously; "
            "it cannot be combined with --device-class"
        )
    if not args.one_shot and args.device_class is not None:
        raise SystemExit("--device-class applies to the --one-shot path only")
    if args.one_shot and args.paged != "off":
        raise SystemExit("--paged applies to the engine path only")
    if args.one_shot and args.objective != "perf":
        raise SystemExit("--objective applies to the engine path only")
    if args.fleet and args.one_shot:
        raise SystemExit("--fleet fronts engine instances; it cannot be "
                         "combined with --one-shot")
    if args.fleet < 0:
        raise SystemExit(f"--fleet must be >= 0, got {args.fleet}")

    if args.trace or args.metrics:
        from repro_torch import observability as OBS

        OBS.enable()

    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), strategy=args.strategy,
                          batch_tile=1, objective=args.objective)
    # The pods are resolved before the weights: a rank a pod makes them on
    # its own card.  An explicit class and the fleet decide their own.
    mesh = None
    if args.device_class is None and not args.fleet:
        try:  # a CLI error exits, as the reference's
            mesh = resolve_pods(args.class_sharded, asym, device)
        except ValueError as err:
            raise SystemExit(str(err)) from err
    ranks = hasattr(mesh, "coord")
    if ranks:
        device = mesh.device
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = Z.init_params(cfg, gen, device)
        if ranks:  # every pod's rank drew the same weights
            from repro_torch.distributed.collectives import check_replicas

            check_replicas(params, mesh)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len), dtype=np.int32)
    seq_cap = args.prompt_len + args.gen_len

    t0 = time.time()
    run = _one_shot if args.one_shot else (_fleet if args.fleet else _engine)
    out, timings, shard_classes, device_class, exec_backend, engine = run(
        cfg, params, asym, prompts, args, seq_cap, device, mesh
    )
    dt = time.time() - t0
    engines = engine.engines if args.fleet else [engine]
    stop_counts = None
    if args.eos_id is not None:
        if engine is not None:
            stop_counts = {"eos": sum(e.stats.completed_eos for e in engines),
                           "budget": sum(e.stats.completed_budget for e in engines)}
        else:
            out, n_eos, n_budget = truncate_at_eos(out, args.prompt_len, args.eos_id)
            stop_counts = {"eos": n_eos, "budget": n_budget}
    tokens = timings.get("tokens", args.batch * timings["decode_steps"])
    steady = tokens / timings["decode_s"] if timings["decode_s"] > 0 else 0.0
    summary = {
        "arch": cfg.name,
        "path": ("one-shot" if args.one_shot
                 else f"fleet:{args.fleet}" if args.fleet else "engine"),
        "objective": args.objective,
        "device_class": device_class,
        "exec_backend": exec_backend,
        "class_sharded": shard_classes is not None,
        "shard_classes": shard_classes,
        "batch": args.batch,
        "generated": out.shape[1] - args.prompt_len,
        "wall_s": round(dt, 2),
        "compile_s": round(timings["compile_s"], 3),
        "tokens_per_s": round(steady, 1),
        "sample": out[0, -8:].tolist(),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    if ranks:
        summary["pod_ranks"] = mesh.world
    if stop_counts is not None:
        summary["stop_counts"] = stop_counts
    if args.fleet:
        # energy_j / tokens_per_j are modeled joules (PowerModel), not the card's.
        summary["engine"] = {
            "fleet": engine.stats.snapshot(),
            "health": engine.health(),
            "engines": [e.stats.snapshot() for e in engines],
            "completed_eos": sum(e.stats.completed_eos for e in engines),
            "completed_budget": sum(e.stats.completed_budget for e in engines),
        }
    elif engine is not None:
        # energy_j / tokens_per_j are modeled joules (PowerModel), not the card's.
        summary["engine"] = {"slots": [engine.n_pods, engine.c_max],
                             **engine.stats.snapshot(), "parked_pods": engine.parked_pods,
                             "kv_pool": engine.kv_stats()}
    if args.trace or args.metrics:
        from repro_torch import observability as OBS
        from repro_torch.util.atomic import atomic_write_json

        buf = OBS.disable()  # the session is over; later work goes untraced
        if args.trace:
            summary["trace"] = buf.save(args.trace)
        if args.metrics:
            summary["metrics"] = atomic_write_json(
                args.metrics, OBS.REGISTRY.snapshot(), indent=1, sort_keys=True
            )
    return summary, out, engine


def main(argv=None) -> dict:
    summary, _, _ = serve(build_parser().parse_args(argv))
    if process_rank() == 0:  # under a launcher every rank serves; one prints
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
