"""Autotune CLI: search block configs per shape and persist the cache.

The port's ``repro.tuning.tune``.  Workflow (the paper's Section 3.3
search, driven to a cache file)::

    # search two shapes with the deterministic cost model and write the cache
    PYTHONPATH=src python -m repro_torch.tuning.tune \
        --spec h100 --backend cost-model \
        --shapes 512x512x512,12x2048x2048 --cache artifacts/tuning/torch_cache.json

    # second invocation: every shape is already cached -> logged hits, no search
    # (same command)

    # time the real kernels on the card (the default --device cuda)
    PYTHONPATH=src python -m repro_torch.tuning.tune \
        --spec h100-little --backend wallclock --shapes 12x2048x2048

    # consume from the GEMM path (control trees and execution contexts)
    REPRO_TORCH_TUNING_CACHE=artifacts/tuning/torch_cache.json \
        python -m repro_torch.launch.serve --arch internlm2-1.8b

``--backend wallclock`` times the CUDA kernels' device time on the card
(``--device cuda``, the default; bf16 only) or their plain versions on
the CPU (``--device cpu``).  Wallclock search
runs the paper's two-stage protocol by default (``--two-stage auto``): the
roofline cost model prunes the grid to ``--coarse-keep`` promising
candidates, only those are wallclock-timed, and the timed winner's
neighborhood is refined (Figure 4's coarse sweep -> refine).  ``--dry-run``
searches a tiny default shape set and writes nothing (the CI smoke step).
``--calibrate-ratios`` additionally runs the Section 5.2.2 per-class
calibration over the big.LITTLE device classes and records the resulting
``init_ratios`` in the cache metadata block.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
from typing import Optional, Sequence

from repro_torch.core.blocking import BlockConfig, HopperClassSpec
from repro_torch.observability import metrics as MET
from repro_torch.observability import trace as T
from repro_torch.tuning import cache as C
from repro_torch.tuning import candidates as CAND
from repro_torch.tuning import measure as M

log = logging.getLogger("repro_torch.tuning.tune")

_M = None


def _obs_metrics():
    global _M
    if _M is None:
        _M = {
            "cache": MET.counter(
                "tuning_cache_lookups_total", "Tuning-cache lookups by outcome",
                labels=("result",)),
            "candidate_seconds": MET.histogram(
                "tuning_candidate_seconds",
                "Per-candidate score from the timing backend (seconds)"),
        }
    return _M

DTYPES = {"bf16": ("bfloat16", 2), "f32": ("float32", 4)}
DRY_RUN_SHAPES = [(256, 256, 256), (512, 512, 512)]


@dataclasses.dataclass
class SearchResult:
    """Outcome of tuning one shape (or of a cache hit skipping the search)."""

    shape: tuple[int, int, int]
    best: BlockConfig
    best_time_s: float
    analytical: BlockConfig
    analytical_time_s: float
    n_candidates: int          # candidates actually scored by `backend`
    cache_hit: bool = False
    n_pruned: int = 0          # candidates dropped by the cost-model prefilter
    # Micro-kernel variant the winner runs on (a BACKENDS key): the §5.3
    # search dimension — "cuda" (pipelined) or "cuda_lean".
    best_backend: str = "cuda"
    search_s: float = 0.0      # host seconds the search took

    @property
    def speedup(self) -> float:
        return self.analytical_time_s / self.best_time_s if self.best_time_s else 1.0


def search_shape(
    m: int,
    k: int,
    n: int,
    *,
    spec: HopperClassSpec,
    dtype_bytes: int,
    backend,
    max_candidates: Optional[int] = None,
    prefilter=None,
    coarse_keep: int = 8,
    kernel_backends: Sequence[str] = ("cuda",),
) -> SearchResult:
    """Score candidates; the analytical config is always candidate #0,
    so the winner's time is <= the analytical default's by construction.

    ``prefilter`` enables the paper's two-stage Figure-4 sweep: a cheap
    ``(m, k, n, cfg) -> seconds`` scorer (the roofline cost model) ranks
    the full grid first, only the ``coarse_keep`` most promising
    candidates (plus the analytical seed) are timed with ``backend``, and
    the timed winner's one-step neighborhood is then refined with
    ``backend`` as well.  This is what makes wallclock search affordable:
    the expensive timer runs on tens of candidates, not hundreds.

    ``kernel_backends`` enumerates micro-kernel variants as a search
    dimension (each config feasibility-checked under *its* variant's ring
    in shared memory).  With the default single ``("cuda",)`` the scorer is called
    ``backend(m, k, n, cfg)`` exactly as before; with variants enabled it
    must also accept ``kernel_backend=`` (``measure.make_backend`` scorers
    do).
    """

    t_search = time.perf_counter()
    kernel_backends = tuple(kernel_backends)
    multi = kernel_backends != ("cuda",)
    if multi:
        cands = CAND.enumerate_kernel_candidates(
            m, k, n, spec=spec, dtype_bytes=dtype_bytes, backends=kernel_backends
        )
    else:
        cands = [
            CAND.KernelCandidate(cfg)
            for cfg in CAND.enumerate_candidates(
                m, k, n, spec=spec, dtype_bytes=dtype_bytes
            )
        ]
    if max_candidates is not None and len(cands) > max_candidates:
        # Keep the analytical seed, truncate the tail of the coarse grid.
        cands = cands[:max_candidates]
    analytical = cands[0]

    def _score(fn, cand: CAND.KernelCandidate) -> float:
        t0 = time.perf_counter()
        if multi:
            t = fn(m, k, n, cand.cfg, kernel_backend=cand.backend)
        else:
            t = fn(m, k, n, cand.cfg)
        # Telemetry covers the real scorer only (not the cheap prefilter):
        # one span per timed candidate, wall = what the search paid,
        # score_s = what the backend measured/estimated.
        if fn is backend and T.enabled():
            T.complete("tuning.candidate", t0, time.perf_counter() - t0,
                       cat="tuning",
                       block=[cand.cfg.bm, cand.cfg.bk, cand.cfg.bn],
                       kernel_backend=cand.backend, score_s=t)
            _obs_metrics()["candidate_seconds"].observe(t)
        return t

    n_pruned = 0
    if prefilter is not None and len(cands) > coarse_keep + 1:
        # Coarse stage: rank by the cheap model, keep the best region.
        ranked = sorted(cands[1:], key=lambda c: _score(prefilter, c))
        kept = [analytical] + ranked[:coarse_keep]
        n_pruned = len(cands) - len(kept)
        cands = kept

    best, best_t, ana_t = None, float("inf"), None
    timed: set[tuple[int, int, int, str]] = set()
    for cand in cands:
        t = _score(backend, cand)
        timed.add(cand.key)
        if cand == analytical:
            ana_t = t
        if t < best_t:
            best, best_t = cand, t
    assert best is not None and ana_t is not None

    if prefilter is not None and n_pruned:
        # Fine stage: refine around the coarse winner (paper Figure 4),
        # staying on the winner's kernel variant.  Skipped when the coarse
        # stage pruned nothing — the grid was already timed exhaustively.
        from repro_torch.core.execution import backend_stages

        for cfg in CAND.neighborhood(
            best.cfg, spec=spec, stages=backend_stages(best.backend), shape=(m, k, n),
        ):
            cand = CAND.KernelCandidate(cfg=cfg, backend=best.backend)
            if cand.key in timed:
                continue
            t = _score(backend, cand)
            timed.add(cand.key)
            if t < best_t:
                best, best_t = cand, t

    return SearchResult(
        shape=(m, k, n),
        best=best.cfg,
        best_time_s=best_t,
        analytical=analytical.cfg,
        analytical_time_s=ana_t,
        n_candidates=len(timed),
        n_pruned=n_pruned,
        best_backend=best.backend,
        search_s=time.perf_counter() - t_search,
    )


def parse_shapes(text: str) -> list[tuple[int, int, int]]:
    """``"512x512x512,1024x1024x1024"`` → [(512,512,512), (1024,1024,1024)]."""

    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        dims = part.lower().split("x")
        if len(dims) != 3:
            raise ValueError(f"shape {part!r} is not MxKxN")
        out.append(tuple(int(d) for d in dims))
    if not out:
        raise ValueError("no shapes given")
    return out


def tune_shapes(
    shapes: Sequence[tuple[int, int, int]],
    *,
    spec: HopperClassSpec,
    dtype: str = "bf16",
    backend_name: str = "cost-model",
    cache: Optional[C.TuningCache] = None,
    force: bool = False,
    max_candidates: Optional[int] = None,
    two_stage: Optional[bool] = None,
    coarse_keep: int = 8,
    kernel_backends: Sequence[str] = CAND.KERNEL_BACKENDS,
    objective: str = "perf",
    device=None,
) -> list[SearchResult]:
    """Library entry point: search ``shapes``, updating ``cache`` in place.

    ``two_stage=None`` (auto) enables the cost-model prefilter exactly when
    the scoring backend is wallclock — the cost model pruning itself would
    be circular.  Pass True/False to force either way.

    The micro-kernel variant is a search dimension by default
    (``kernel_backends``); the cache entry records the winner under
    ``"backend"`` and the scorer under ``"measured_with"``.

    ``objective`` selects what the search minimizes (seconds, joules, or
    energy-delay product — cost-model backend only); the cache entry
    records it, and a cached entry tuned under a *different* objective is
    re-scored rather than trusted (its winner optimized the wrong metric).

    ``device`` is where the wallclock backend times (default: the card when
    one is present); a wallclock search never falls back to the cost model.
    """

    from repro_torch.core.schedule import validate_objective

    validate_objective(objective)
    dtype_name, dtype_bytes = DTYPES[dtype]
    backend = M.make_backend(backend_name, spec=spec, objective=objective, device=device)
    if two_stage is None:
        two_stage = backend_name == "wallclock"
    prefilter = (
        (
            lambda m, k, n, cfg, kernel_backend="cuda": M.cost_model_time(
                m, k, n, cfg, spec=spec, kernel_backend=kernel_backend
            )
        )
        if two_stage
        else None
    )
    results = []
    for m, k, n in shapes:
        cached = cache.get(spec.name, dtype_name, m, k, n) if cache else None
        if cached is not None and not force:
            key = C.shape_bucket_key(spec.name, dtype_name, m, k, n)
            # Entries tuned under a different objective optimized the wrong
            # metric — their winner is not this search's winner.  Treat as a
            # miss (entries predating the objective field scored seconds).
            entry_obj = cache.entries.get(key, {}).get("objective", "perf")
            if entry_obj != objective:
                log.info(
                    "cache entry for %s tuned for objective %r, want %r — re-searching",
                    key, entry_obj, objective,
                )
                cached = None
        if cached is not None and not force:
            log.info("cache hit for %s — skipping search (use --force to redo)", key)
            if T.enabled():
                _obs_metrics()["cache"].labels(result="hit").inc()
            ana = CAND.analytical_config(m, k, n, spec=spec, dtype_bytes=dtype_bytes)
            # Report the times recorded at tuning, not fresh measurements —
            # re-timing a hit would defeat the point of the cache under the
            # wallclock backend (2 real kernel runs per already-tuned shape).
            entry = cache.entries.get(key, {})
            best_t = entry.get("time_s")
            ana_t = entry.get("analytical_time_s")
            recorded = entry.get("backend")
            from repro_torch.kernels.gemm import GEMM_KERNELS

            # Guard against scorer names and dispatch entries the timers
            # cannot model ("matmul", the plain twins): only a registered
            # kernel variant is reported.
            best_backend = recorded if recorded in GEMM_KERNELS else "cuda"
            if best_t is None or ana_t is None:
                best_t = backend(m, k, n, cached, kernel_backend=best_backend)
                ana_t = backend(m, k, n, ana)
            results.append(
                SearchResult(
                    shape=(m, k, n),
                    best=cached,
                    best_time_s=float(best_t),
                    analytical=ana,
                    analytical_time_s=float(ana_t),
                    n_candidates=0,
                    cache_hit=True,
                    best_backend=best_backend,
                )
            )
            continue
        if T.enabled():
            _obs_metrics()["cache"].labels(result="miss").inc()
        t0 = time.perf_counter()
        with T.span("tuning.search_shape", cat="tuning",
                    shape=f"{m}x{k}x{n}", spec=spec.name,
                    backend=backend_name) as sp:
            res = search_shape(
                m, k, n,
                spec=spec,
                dtype_bytes=dtype_bytes,
                backend=backend,
                max_candidates=max_candidates,
                prefilter=prefilter,
                coarse_keep=coarse_keep,
                kernel_backends=kernel_backends,
            )
            sp.tag(n_candidates=res.n_candidates, n_pruned=res.n_pruned,
                   best=[res.best.bm, res.best.bk, res.best.bn],
                   best_backend=res.best_backend)
        log.info(
            "tuned %dx%dx%d: best=(%d,%d,%d)@%s %.3es vs analytical=(%d,%d,%d) "
            "%.3es (%.2fx, %d timed, %d pruned, %.1fs search)",
            m, k, n,
            res.best.bm, res.best.bk, res.best.bn, res.best_backend,
            res.best_time_s,
            res.analytical.bm, res.analytical.bk, res.analytical.bn,
            res.analytical_time_s, res.speedup, res.n_candidates, res.n_pruned,
            time.perf_counter() - t0,
        )
        if cache is not None:
            cache.put(
                spec.name, dtype_name, m, k, n, res.best,
                backend=res.best_backend,
                measured_with=backend_name,
                time_s=res.best_time_s,
                analytical_time_s=res.analytical_time_s,
                objective=objective,
            )
        results.append(res)
    return results


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning.tune",
        description="Architecture-aware GEMM block-config autotuner for Hopper.",
    )
    ap.add_argument("--spec", default="h100", choices=sorted(CAND.SPECS))
    ap.add_argument("--shapes", default=None, help="comma-separated MxKxN list")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--backend", default="cost-model", choices=["cost-model", "wallclock"])
    ap.add_argument("--objective", default="perf", choices=["perf", "energy", "edp"],
                    help="what the search minimizes: seconds, modeled joules, "
                         "or energy-delay product (cost-model backend only)")
    ap.add_argument(
        "--kernel-backends", default=",".join(CAND.KERNEL_BACKENDS),
        help="comma-separated micro-kernel variants to search (e.g. "
             "'cuda,cuda_lean', or a single 'cuda_lean' to force the "
             "one-stage kernel); the cache entry records the winner",
    )
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default: ${C.ENV_VAR} or {C.DEFAULT_PATH})")
    ap.add_argument("--device", default="cuda",
                    help="where --backend wallclock times: cuda (default, the kernels) "
                         "or cpu (their plain versions)")
    ap.add_argument("--force", action="store_true", help="re-search cached shapes")
    ap.add_argument("--max-candidates", type=int, default=None)
    ap.add_argument("--two-stage", default="auto", choices=["auto", "on", "off"],
                    help="cost-model prefilter before timing (auto: on for wallclock)")
    ap.add_argument("--coarse-keep", type=int, default=8,
                    help="candidates surviving the coarse prefilter stage")
    ap.add_argument("--calibrate-ratios", action="store_true",
                    help="also calibrate big.LITTLE class ratios (Section 5.2.2)")
    ap.add_argument("--dry-run", action="store_true",
                    help="search a tiny default shape set, write nothing")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    import os

    spec = CAND.get_spec(args.spec)
    try:
        shapes = parse_shapes(args.shapes) if args.shapes else list(DRY_RUN_SHAPES)
    except ValueError as e:
        ap.error(str(e))
    cache_path = args.cache or os.environ.get(C.ENV_VAR) or C.DEFAULT_PATH
    cache = C.TuningCache.load(cache_path)

    kernel_backends = [b.strip() for b in args.kernel_backends.split(",") if b.strip()]
    if not kernel_backends:
        ap.error("--kernel-backends needs at least one variant")

    results = tune_shapes(
        shapes,
        spec=spec,
        dtype=args.dtype,
        backend_name=args.backend,
        cache=cache,
        force=args.force,
        max_candidates=args.max_candidates,
        two_stage={"auto": None, "on": True, "off": False}[args.two_stage],
        coarse_keep=args.coarse_keep,
        kernel_backends=kernel_backends,
        objective=args.objective,
        device=args.device if args.backend == "wallclock" else None,
    )

    summary: dict = {
        "spec": spec.name,
        "backend": args.backend,
        "objective": args.objective,
        "dtype": args.dtype,
        "cache_path": None if args.dry_run else cache_path,
        "shapes": [
            {
                "shape": list(r.shape),
                "best": [r.best.bm, r.best.bk, r.best.bn],
                "best_backend": r.best_backend,
                "best_time_s": r.best_time_s,
                "analytical": [r.analytical.bm, r.analytical.bk, r.analytical.bn],
                "analytical_time_s": r.analytical_time_s,
                "speedup_vs_analytical": r.speedup,
                "cache_hit": r.cache_hit,
                "n_candidates": r.n_candidates,
                "n_pruned": r.n_pruned,
                "search_s": r.search_s,
            }
            for r in results
        ],
    }

    if args.calibrate_ratios:
        from repro_torch.core.asymmetric import biglittle_classes
        from repro_torch.tuning.ratio import calibrate_class_ratios

        # Always the cost model here: wallclock cannot compare the two
        # heterogeneous class specs on one card (ratio.py raises) — a
        # measured ratio comes from the step-time probe's per-class
        # seconds through calibrate_class_ratios(measurements=...).
        cal = calibrate_class_ratios(biglittle_classes(), backend="cost-model")
        log.info("calibrated class ratios %s -> %s (knob=%.2f)",
                 cal.class_names, [round(x, 4) for x in cal.ratios], cal.knob())
        cache.entries.setdefault("__meta__", {})["init_ratios"] = {
            "classes": list(cal.class_names),
            "ratios": list(cal.ratios),
            "probe_shape": list(cal.probe_shape),
            "backend": cal.backend,
        }
        summary["init_ratios"] = list(cal.ratios)

    if args.dry_run:
        log.info("dry run: searched %d shapes, cache not written", len(results))
    else:
        cache.save(cache_path)
        log.info("wrote %d entries to %s", len(cache.entries), cache_path)

    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
