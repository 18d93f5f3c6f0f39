"""Config/artifact contracts: tuning caches, shipped trees, bench JSONs.

* **RPR201 — block-config contracts.**  Every tuning-cache entry and
  every control tree buildable from the shipped class specs (``h100``,
  ``h100-little``: ``tuning.candidates.SPECS``, which resolve to the
  card's own shared memory when a card is present) must satisfy, *under
  the stage model of the kernel that will consume it* (one stage for the
  lean kernel, the pipelined kernel's shortest ring,
  ``execution.min_stages(execution.backend_stages(backend))``, otherwise):

    - the A/B ring fits the spec's shared memory, the accumulator's
      register share and the thread count fit (``BlockConfig.fits``),
    - the block is a tile the CUDA GEMM is compiled for
      (``kernels.gemm.compiled_tile``: ``BM_TILES``, ``BN_TILES``, ``bk``
      whole ``BK_ALIGN`` rows up to ``MAX_BK``),
    - no block dim exceeds the problem it was recorded for, padded to the
      port's alignment (16 for M/N, ``BK_ALIGN`` for K, at least the
      smallest compiled tile: ``kernels.gemm.validate_block_config``'s
      rule, the oversized-block bug class),
    - cache keys bucket by ``tuning.cache.shape_bucket_key`` under the
      current ``CACHE_VERSION``,
    - under the Loop-3 (rows) coarse loop, all classes of a tree family
      share one ``bk`` (the shared-B-panel constraint of §5.3).

* **RPR202 — bench artifact schema.**  ``artifacts/bench/BENCH_*.json``
  must be ``{"meta": {...}, "records": [...]}``: framework-neutral, the
  reference's check as it is.

Nothing here launches a kernel: caches are parsed, trees are *built*
(pure Python derivation), artifacts are schema-checked.
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterator, Optional

from repro_torch.analysis.diagnostics import Diagnostic

_KEY_RE = re.compile(r"^(?P<spec>[^/]+)/(?P<dtype>[^/]+)/(?P<m>\d+)x(?P<k>\d+)x(?P<n>\d+)$")

# Required provenance keys of a harness ``meta`` block.
_META_KEYS = ("git_sha", "jax_version", "timestamp")

# The shapes and GEMM backends the shipped-tree check builds trees for.
SHIPPED_SHAPES = ((1024, 1024, 1024), (2048, 2048, 2048), (512, 4096, 512))
SHIPPED_BACKENDS = ("matmul", "cuda")
COARSE_LOOPS = ("rows", "cols")


def looks_like_tuning_cache(payload: object) -> bool:
    return (
        isinstance(payload, dict)
        and "entries" in payload
        and "version" in payload
        and isinstance(payload.get("entries"), dict)
    )


def consumer_stages(backend: object) -> int:
    """The ring a block must fit for the kernel ``backend`` names: one
    stage for the lean kernel, the pipelined kernel's shortest ring
    otherwise (also for a missing or unknown name: the strictest model)."""

    from repro_torch.core.execution import BACKEND_OPS, backend_stages, min_stages

    if isinstance(backend, str) and BACKEND_OPS.get(backend) == "gemm":
        return min_stages(backend_stages(backend))
    return min_stages(backend_stages("cuda"))


def block_problems(cfg, spec, stages: int, shape=None) -> list[str]:
    """What is wrong with ``cfg`` for ``spec`` under a ``stages``-deep
    ring (and, given its recorded ``(m, k, n)``, against that problem)."""

    from repro_torch.kernels.gemm import compiled_tile, validate_block_config

    out = []
    if not compiled_tile(cfg):
        out.append(f"{cfg.bm}x{cfg.bk}x{cfg.bn} is not a compiled tile shape")
    if not cfg.fits(spec, stages=stages):
        out.append(
            f"a {stages}-stage ring of {cfg.bm}x{cfg.bk}x{cfg.bn} needs "
            f"{cfg.smem_bytes(stages)} B of shared memory "
            f"(budget {int(spec.smem_bytes * spec.smem_fill)} B of "
            f"{spec.name}'s {spec.smem_bytes}), "
            f"{cfg.acc_regs_per_thread()} accumulator registers a thread "
            f"(budget {spec.acc_regs_per_thread}), {cfg.threads()} threads "
            f"(budget {spec.threads_per_block})"
        )
    if shape is not None:
        try:
            validate_block_config(*shape, cfg)
        except ValueError as e:
            out.append(f"{e} (the oversized-block bug class)")
    return out


def check_tuning_cache_file(path: str) -> list[Diagnostic]:
    """Validate one tuning-cache JSON against the block-config contracts."""

    from repro_torch.core.blocking import BlockConfig
    from repro_torch.tuning.cache import CACHE_VERSION, shape_bucket_key
    from repro_torch.tuning.candidates import SPECS

    diags: list[Diagnostic] = []

    def bad(msg: str) -> None:
        diags.append(Diagnostic(code="RPR201", path=path, line=1, message=msg))

    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        bad(f"unreadable tuning cache: {e}")
        return diags
    if not looks_like_tuning_cache(payload):
        return diags  # not a cache; nothing to assert
    if payload.get("version") != CACHE_VERSION:
        # Version-mismatched caches are invalidated wholesale at load time
        # (by design), so their entries carry no contract to verify.
        return diags

    for key, entry in payload["entries"].items():
        m = _KEY_RE.match(key)
        if m is None:
            bad(f"entry key {key!r} is not spec/dtype/MxKxN")
            continue
        spec_name = m.group("spec")
        if spec_name not in SPECS:
            bad(
                f"entry {key!r} names unknown class spec {spec_name!r} "
                f"(known: {sorted(SPECS)})"
            )
            continue
        spec = SPECS[spec_name]
        try:
            cfg = BlockConfig(
                bm=int(entry["bm"]),
                bk=int(entry["bk"]),
                bn=int(entry["bn"]),
                dtype_bytes=int(entry.get("dtype_bytes", 2)),
                acc_bytes=int(entry.get("acc_bytes", 4)),
            )
        except (KeyError, TypeError, ValueError) as e:
            bad(f"entry {key!r} malformed: {e}")
            continue

        backend = entry.get("backend")
        shape = entry.get("shape")
        valid_shape = (
            isinstance(shape, (list, tuple))
            and len(shape) == 3
            and all(isinstance(d, int) and d > 0 for d in shape)
        )
        for problem in block_problems(
            cfg, spec, consumer_stages(backend),
            tuple(shape) if valid_shape else None,
        ):
            bad(f"entry {key!r} (backend={backend!r}): {problem}")
        if valid_shape:
            sm, sk, sn = shape
            expect = shape_bucket_key(spec_name, m.group("dtype"), sm, sk, sn)
            if expect != key:
                bad(
                    f"entry {key!r}: recorded shape {sm}x{sk}x{sn} buckets "
                    f"to {expect!r} — key and shape drifted apart"
                )
    return diags


def shipped_trees(
    shapes=SHIPPED_SHAPES, backends=SHIPPED_BACKENDS,
) -> Iterator[tuple[tuple[int, int, int], str, str, dict]]:
    """``((m, k, n), backend, coarse_loop, trees)`` for every control-tree
    family the shipped specs build (``build_control_trees`` over
    ``tuning.candidates.SPECS``): the trees the contract check visits."""

    from repro_torch.core.control_tree import build_control_trees
    from repro_torch.tuning.candidates import SPECS

    specs = {name: SPECS[name] for name in SPECS}
    for m, k, n in shapes:
        for backend in backends:
            for coarse_loop in COARSE_LOOPS:
                yield (m, k, n), backend, coarse_loop, build_control_trees(
                    specs, m, k, n, backend=backend, coarse_loop=coarse_loop,
                )


def check_shipped_trees(
    shapes: Optional[list[tuple[int, int, int]]] = None,
) -> list[Diagnostic]:
    """Build control trees from the shipped specs; verify their contracts.

    Every ``BlockConfig`` reachable from the registered spec family
    through :func:`build_control_trees` must fit its class's shared memory
    under the tree backend's stage model, be a compiled tile, stay within
    its padded problem, and honor the shared-``bk`` constraint when the
    coarse loop shares the B panel.
    """

    anchor = "src/repro_torch/core/control_tree.py"
    diags: list[Diagnostic] = []
    for shape, backend, coarse_loop, trees in shipped_trees(shapes or SHIPPED_SHAPES):
        m, k, n = shape
        bks = set()
        for name, tree in trees.items():
            where = (
                f"tree[{name}] ({m}x{k}x{n}, backend={backend}, "
                f"coarse={coarse_loop}, kernel={tree.backend})"
            )
            for problem in block_problems(
                tree.block, tree.spec, consumer_stages(tree.backend), shape
            ):
                diags.append(
                    Diagnostic(code="RPR201", path=anchor, line=1,
                               message=f"{where}: {problem}")
                )
            bks.add(tree.block.bk)
        if coarse_loop == "rows" and len(bks) > 1:
            diags.append(
                Diagnostic(
                    code="RPR201", path=anchor, line=1,
                    message=(
                        f"shared-B-panel violation at {m}x{k}x{n} "
                        f"(backend={backend}): classes disagree on "
                        f"the shared bk: {sorted(bks)}"
                    ),
                )
            )
    return diags


def check_bench_artifact(path: str) -> list[Diagnostic]:
    """Schema-check one ``BENCH_*.json`` against the harness contract."""

    diags: list[Diagnostic] = []

    def bad(msg: str) -> None:
        diags.append(Diagnostic(code="RPR202", path=path, line=1, message=msg))

    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        bad(f"unreadable bench artifact: {e}")
        return diags
    if not isinstance(payload, dict):
        bad(f"top level must be an object, got {type(payload).__name__}")
        return diags
    meta = payload.get("meta")
    records = payload.get("records")
    if not isinstance(meta, dict):
        bad("missing/non-object `meta` block (harness.write_json stamps it)")
    else:
        missing = [k for k in _META_KEYS if k not in meta]
        if missing:
            bad(f"meta block missing provenance keys: {missing}")
    if not isinstance(records, list):
        bad("missing/non-list `records`")
    elif not all(isinstance(r, dict) for r in records):
        bad("every record must be an object")
    else:
        for i, rec in enumerate(records):
            if "objective_ab" in rec:
                _check_objective_ab(rec["objective_ab"], i, bad)
    return diags


def _check_objective_ab(block, idx: int, bad) -> None:
    """Schema for a record's ``objective_ab`` A/B comparison block.

    Emitted by ``benchmarks.bench_serving.objective_ab``: a perf side and
    one non-perf side, each carrying the modeled energy columns the CI
    energy gate reads (``energy_j``, ``tokens_per_j``), plus the derived
    ratios the ``--check`` gate thresholds.
    """

    where = f"records[{idx}].objective_ab"
    if not isinstance(block, dict):
        bad(f"{where} must be an object, got {type(block).__name__}")
        return
    obj = block.get("objective")
    if not isinstance(obj, str) or obj == "perf":
        bad(f"{where}.objective must name a non-perf objective, got {obj!r}")
        return
    for side in ("perf", obj):
        cols = block.get(side)
        if not isinstance(cols, dict):
            bad(f"{where}.{side} side missing/non-object")
            continue
        for col in ("energy_j", "tokens_per_j"):
            v = cols.get(col)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                bad(f"{where}.{side}.{col} must be a number, got {v!r}")
    for ratio in ("energy_ratio", "throughput_ratio"):
        v = block.get(ratio)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            bad(f"{where}.{ratio} must be a number, got {v!r}")
    if block.get("tokens_identical") is not True:
        bad(f"{where}.tokens_identical must be true — the objective knob "
            "must not change decoded tokens")


def check_artifacts_dir(art_dir: str) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    if not os.path.isdir(art_dir):
        return diags
    for fname in sorted(os.listdir(art_dir)):
        if fname.startswith("BENCH_") and fname.endswith(".json"):
            diags.extend(check_bench_artifact(os.path.join(art_dir, fname)))
    return diags


__all__ = [
    "SHIPPED_BACKENDS",
    "SHIPPED_SHAPES",
    "block_problems",
    "consumer_stages",
    "shipped_trees",
    "check_tuning_cache_file",
    "check_shipped_trees",
    "check_bench_artifact",
    "check_artifacts_dir",
    "looks_like_tuning_cache",
]
