#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it, phase by phase.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result line):

  0. setup — the card's name and power limit, torch/CUDA versions, and the
     build of every kernel under ``src/repro_torch/csrc`` (one ``nvcc`` per
     source, all started together);
  1. kernels vs their plain PyTorch versions at the serving path's shapes
     (bf16; tolerance below), the lean GEMM bitwise equal to the pipelined
     one at equal blocks, each timed with CUDA events beside its plain
     version, its bound and (GEMM) ``torch.matmul``;
  2. the dense serving engine on the full-width 24-layer internlm2-1.8b
     (random weights from a fixed seed), through ``repro_torch.launch.serve``:
     every GEMM of the decode recurrence must launch ``gemm_cuda``;
  3. the paged engine on the same requests: 24 ``paged_attention_cuda``
     launches per step, first-step logits within tolerance of phase 2;
  4. the one-shot path under ``--device-class little``: ``gemm_cuda_lean``;
  5. a teacher-forced replay of phase 2's tokens: at every generated step,
     the paged path's and the little class's logits against the dense
     big-class path on the same inputs (random weights make greedy decode
     collapse onto a repeated token, so equal tokens prove little);
  6. the reduced model's prefill logits on the card (both classes, dense
     and paged) against the same code's plain versions on the CPU.

Each of phases 2-4 resets the kernels' launch counters just before it
and reads them just after; the launches of phases 1, 5 and 6 count for
no path.  The engines' tokens/s are smoke readings over a few steps, not
throughputs: ``python -m repro_torch.launch.profile_decode`` measures those.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Details go to ``chiprun_out/``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# Tolerances (max |kernel - plain| <= ATOL + RTOL * |plain|), per dtype as in
# tests/test_backend_parity.py: bf16 outputs round to 8 mantissa bits.
BF16_TOL = 2e-2
FP32_TOL = 1e-4
# Logits of the paged path (CUDA kernel, online softmax) or the little
# class against the dense big-class path: bf16 residual streams through
# 24 layers; logits have a standard deviation near 0.9.
LOGIT_TOL = 0.25

PEAK_BF16 = 989e12   # dense bf16 tensor-core peak, H100 SXM data sheet
HBM_BW = 3.35e12     # bytes/s, H100 SXM data sheet

ARCH = "internlm2-1.8b"
BATCH, PROMPT_LEN, GEN_LEN = 8, 16, 8
# Tokens per KV page of the paged engine: three pages per 24-token slot, so
# the kernel walks a real page table (the default, min block.bm = 64, would
# give each slot a single page).
PAGE_SIZE = 8


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BW, n_ops / PEAK_BF16
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, args_list, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call with CUDA events, cycling over input sets
    (so weight matrices are cold in the 50 MB L2, as in a decode step)."""

    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def within(torch, got, ref, tol: float) -> tuple[bool, float]:
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    ok = bool(torch.isfinite(g).all()) and bool((err <= tol + tol * r.abs()).all())
    return ok, float(err.max())


def phase0(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}", flush=True)
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"phase 0: built {sorted(logs)} in {build_s:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, log in logs.items():
        with open(os.path.join(OUT_DIR, f"nvcc_{name}.log"), "w") as f:
            f.write(log)
    return card


def phase1(torch, detail: dict) -> dict:
    """Kernels against their plain versions; returns the per-kernel records."""

    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.configs import get_config
    from repro_torch.runtime.paging import SENTINEL, divisor_page_size

    cfg = get_config(ARCH)
    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    big, little = asym.execution_context("big"), asym.execution_context("little")
    check(big.backend() == "cuda" and little.backend() == "cuda_lean",
          f"class kernels {big.backend()} / {little.backend()}, want cuda / cuda_lean")
    m = asym.n_pods * asym.batch_layout(BATCH).c_max  # the engine's slot table
    d, hq = cfg.d_model, cfg.n_heads * cfg.head_dim
    hkv, ff, L = cfg.n_kv_heads * cfg.head_dim, cfg.d_ff, cfg.n_layers
    # (K, N) of every GEMM in one decode step, with its count per step.
    step_shapes = [((d, hq), L), ((d, hkv), 2 * L), ((hq, d), L),
                   ((d, ff), 2 * L), ((ff, d), L), ((d, cfg.vocab), 1)]
    check(sum(c for _, c in step_shapes) == 7 * L + 1, "step shape counts")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def operands(mm, k, n):
        a = torch.randn((mm, k), generator=gen, device="cuda").to(torch.bfloat16)
        copies = max(1, math.ceil(128e6 / (k * n * 2)))  # > L2, weights arrive cold
        bs = [(torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
              for _ in range(min(copies, 4 if k * n > 50e6 else copies))]
        return a, bs

    records = {}
    rows = []
    for name, ctx, fn, plain in (
        ("gemm_cuda", big, G.gemm_cuda, G.gemm_plain),
        ("gemm_cuda_lean", little, G.gemm_cuda_lean, G.gemm_lean_plain),
    ):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes_s": 0.0, "ops_s": 0.0}
        max_err = 0.0
        for (k, n), count in step_shapes:
            cfgb = ctx.block_config(m, k, n, "bfloat16", 2)
            a, bs = operands(m, k, n)
            got, ref = fn(a, bs[0], cfgb), plain(a, bs[0], cfgb)
            torch.cuda.synchronize()
            ok, err = within(torch, got, ref, BF16_TOL)
            check(ok, f"{name} {m}x{k}x{n} {cfgb}: max err {err} over tol {BF16_TOL}")
            other = (G.gemm_cuda if fn is G.gemm_cuda_lean else G.gemm_cuda_lean)(a, bs[0], cfgb)
            check(torch.equal(got, other), f"lean != pipelined bitwise at {m}x{k}x{n} {cfgb}")
            max_err = max(max_err, err)
            iters = 10 if n > 50000 else 50
            t_k = time_ms(torch, lambda x, y: fn(x, y, cfgb), [(a, b) for b in bs], iters)
            t_p = time_ms(torch, lambda x, y: plain(x, y, cfgb), [(a, b) for b in bs], max(3, iters // 5))
            t_l = time_ms(torch, torch.matmul, [(a, b) for b in bs], iters)
            n_bytes = (m * k + k * n + m * n) * 2
            b_ms, by = bound_ms(n_bytes, 2 * m * k * n)
            rows.append({"kernel": name, "shape": [m, k, n], "block": [cfgb.bm, cfgb.bk, cfgb.bn],
                         "calls_per_step": count, "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                         "bound_ms": b_ms, "bound_by": by, "max_abs_err": err})
            print(f"  {name} {m}x{k}x{n} block {cfgb.bm}x{cfgb.bk}x{cfgb.bn}: err {err:.3g} "
                  f"kernel {t_k:.4f} ms plain {t_p:.4f} matmul {t_l:.4f} bound {b_ms:.4f} ({by})",
                  flush=True)
            for key, val in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b_ms)):
                tot[key] += count * val
            tot["bytes_s"] += count * n_bytes / HBM_BW
            tot["ops_s"] += count * 2 * m * k * n / PEAK_BF16
        records[name] = {
            "max_abs_err": max_err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "library_ms": tot["library_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_s"] >= tot["ops_s"] else "operations",
        }

    # The tree shape, with the big and the little class's blocks.
    for name, ctx, fn, plain in (("gemm_cuda", big, G.gemm_cuda, G.gemm_plain),
                                 ("gemm_cuda_lean", little, G.gemm_cuda_lean, G.gemm_lean_plain)):
        blk = ctx.tree.block
        a = torch.randn((1024, 1024), generator=gen, device="cuda").to(torch.bfloat16)
        b = (torch.randn((1024, 1024), generator=gen, device="cuda") / 32).to(torch.bfloat16)
        got, ref = fn(a, b, blk), plain(a, b, blk)
        other = (G.gemm_cuda if fn is G.gemm_cuda_lean else G.gemm_cuda_lean)(a, b, blk)
        torch.cuda.synchronize()
        ok, err = within(torch, got, ref, BF16_TOL)
        check(ok, f"{name} tree shape {blk}: max err {err}")
        check(torch.equal(got, other), f"lean != pipelined bitwise at the tree shape {blk}")
        t_k = time_ms(torch, lambda x, y: fn(x, y, blk), [(a, b)], 20)
        t_l = time_ms(torch, torch.matmul, [(a, b)], 20)
        b_ms, by = bound_ms(3 * 1024 * 1024 * 2, 2 * 1024 ** 3)
        rows.append({"kernel": name, "shape": [1024, 1024, 1024], "block": [blk.bm, blk.bk, blk.bn],
                     "calls_per_step": 0, "ms": t_k, "library_ms": t_l, "bound_ms": b_ms,
                     "bound_by": by, "max_abs_err": err})
        print(f"  {name} tree 1024^3 block {blk.bm}x{blk.bk}x{blk.bn}: err {err:.3g} "
              f"kernel {t_k:.4f} ms matmul {t_l:.4f} bound {b_ms:.4f} ({by})", flush=True)

    # fp32 output of the pipelined kernel at one decode shape.
    cfgb = big.block_config(m, d, d, "bfloat16", 2)
    a, bs = operands(m, d, d)
    ok, err = within(torch, G.gemm_cuda(a, bs[0], cfgb, out_dtype=torch.float32),
                     G.gemm_plain(a, bs[0], cfgb, out_dtype=torch.float32), FP32_TOL)
    check(ok, f"gemm_cuda fp32 output: max err {err} over tol {FP32_TOL}")
    print(f"  gemm_cuda fp32 out {m}x{d}x{d}: err {err:.3g}", flush=True)

    # Paged attention at the paged engine's shapes (phase 3).
    seq_cap = PROMPT_LEN + GEN_LEN
    ps = divisor_page_size(seq_cap, PAGE_SIZE)
    w = seq_cap // ps
    n_pages = asym.n_pods * (asym.batch_layout(BATCH).c_max + 1) * w
    g_hq, g_hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def paged_case(b_rows, n_p, page, width, label):
        q = torch.randn((b_rows, g_hq, dh), generator=gen, device="cuda").to(torch.bfloat16)
        pk = torch.randn((n_p, page, g_hkv, dh), generator=gen, device="cuda").to(torch.bfloat16)
        pv = torch.randn((n_p, page, g_hkv, dh), generator=gen, device="cuda").to(torch.bfloat16)
        table = torch.randint(0, n_p, (b_rows, width), generator=gen, device="cuda", dtype=torch.int32)
        pos = torch.randint(0, width * page, (b_rows,), generator=gen, device="cuda", dtype=torch.int32)
        table[0] = int(SENTINEL)           # a dead row: every entry unallocated
        pos[1] = width * page + 7          # a row aged past the cache
        got = PA.paged_attention_cuda(q, pk, pv, table, pos)
        ref = PA.paged_attention_torch(q, pk, pv, table, pos)
        torch.cuda.synchronize()
        ok, err = within(torch, got, ref, BF16_TOL)
        check(ok, f"paged_attention_cuda {label}: max err {err} over tol {BF16_TOL}")
        t_k = time_ms(torch, PA.paged_attention_cuda, [(q, pk, pv, table, pos)], 50)
        t_p = time_ms(torch, PA.paged_attention_torch, [(q, pk, pv, table, pos)], 20)
        attended = torch.clamp(pos.long() + 1, max=width * page).sum().item()
        n_bytes = (2 * attended * g_hkv * dh * 2 + 2 * b_rows * g_hq * dh * 2
                   + table.numel() * 4 + pos.numel() * 4)
        n_ops = 4 * attended * g_hq * dh
        b_ms, by = bound_ms(n_bytes, n_ops)
        rows.append({"kernel": "paged_attention_cuda", "shape": [b_rows, g_hq, g_hkv, dh, n_p, page, width],
                     "label": label, "calls_per_step": L if label == "engine" else 0, "ms": t_k,
                     "plain_ms": t_p, "library_ms": None, "bound_ms": b_ms, "bound_by": by,
                     "max_abs_err": err})
        print(f"  paged_attention_cuda {label} B={b_rows} P={n_p} ps={page} W={width}: err {err:.3g} "
              f"kernel {t_k:.4f} ms plain {t_p:.4f} bound {b_ms:.5f} ({by})", flush=True)
        return t_k, t_p, b_ms, by, err

    t_k, t_p, b_ms, by, err = paged_case(m, n_pages, ps, w, "engine")
    records["paged_attention_cuda"] = {"max_abs_err": err, "ms": L * t_k, "plain_ms": L * t_p,
                                       "library_ms": None, "bound_ms": L * b_ms, "bound_by": by}
    paged_case(m, m * 64 + 1, 64, 64, "long-4096")  # a long cache, for the record only
    detail["phase1"] = rows
    return records


def phase5(torch, tokens) -> dict:
    """Teacher-forced replay of ``tokens`` (the dense engine's): the max
    |logit difference| at every generated step of the paged path and of
    the little class's tree against the dense big-class path."""

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.models import model_zoo as Z
    from repro_torch.runtime.paging import divisor_page_size

    cfg = get_config(ARCH)
    params = Z.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    decode = Z.make_decode_fn(cfg)
    b, total = tokens.shape
    ps = divisor_page_size(total, PAGE_SIZE)
    w = total // ps
    toks = torch.as_tensor(tokens, device="cuda")

    def logits(cls, paged):
        if paged:
            state = Z.init_decode_state_paged(cfg, b * w, ps, device="cuda")
            extra = {"page_table": torch.arange(b * w, dtype=torch.int32,
                                                device="cuda").reshape(b, w)}
        else:
            state, extra = Z.init_decode_state(cfg, b, total, device="cuda"), {}
        out = []
        with torch.no_grad(), mesh.execution_context(cls):
            for t in range(total - 1):
                lg, state = decode(params, dict(extra, tokens=toks[:, t:t + 1]), state, t)
                if t >= PROMPT_LEN - 1:
                    out.append(lg[:, 0].float())
        return out

    want = logits("big", paged=False)
    diffs = {}
    for label, cls, paged in (("paged", "big", True), ("little", "little", False)):
        got = logits(cls, paged)
        diffs[label] = [float((g - r).abs().max()) for g, r in zip(got, want)]
        print(f"  {label} vs dense, max |logit diff| per generated step: "
              f"{[round(x, 4) for x in diffs[label]]} (tol {LOGIT_TOL})", flush=True)
        check(all(math.isfinite(x) and x <= LOGIT_TOL for x in diffs[label]),
              f"{label} vs dense logits differ by {max(diffs[label])}")
    return diffs


def phase6(torch) -> dict:
    """The port on the card against the port on the CPU, on a small input:
    the reduced model's prefill logits through the CUDA kernels (each
    class's GEMM, dense and paged attention) within the bf16 tolerance of
    the same code's plain versions on the CPU, same weights."""

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.models import model_zoo as Z

    cfg = get_config(ARCH).reduced()
    b, plen, ps = 4, 8, 4
    weights = Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on = lambda tree, dev: ({k: on(v, dev) for k, v in tree.items()}  # noqa: E731
                            if isinstance(tree, dict) else tree.to(dev))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (b, plen), dtype=np.int32)
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1, backend="cuda")
    prefill = Z.make_prefill_fn(cfg)

    def logits(device, cls, paged):
        batch = {"tokens": torch.as_tensor(prompts, device=device)}
        if paged:
            state = Z.init_decode_state_paged(cfg, b * plen // ps, ps, device=device)
            batch["page_table"] = torch.arange(b * plen // ps, dtype=torch.int32,
                                               device=device).reshape(b, plen // ps)
        else:
            state = Z.init_decode_state(cfg, b, plen, device=device)
        with torch.no_grad(), mesh.execution_context(cls):
            out, _ = prefill(on(weights, device), batch, state, 0)
        return out

    errs = {}
    for cls in ("big", "little"):
        want = logits("cpu", cls, paged=False)
        for paged in (False, True):
            got = logits("cuda", cls, paged)
            torch.cuda.synchronize()
            ok, err = within(torch, got.cpu(), want, BF16_TOL)
            label = f"{cls}{' paged' if paged else ''}"
            print(f"  {label}: prefill logits {tuple(got.shape)} max err vs CPU {err:.4g}", flush=True)
            check(ok and got.shape == (b, 1, cfg.vocab), f"{label}: card vs CPU logits err {err}")
            errs[label] = err
    return errs


def run_serve(argv):
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    summary, tokens, engine = serve.serve(serve.build_parser().parse_args(argv))
    return summary, tokens, engine, time.perf_counter() - t0


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch is missing: run from the root of a checkout")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import paged_attention as PA

    detail: dict = {}
    card = phase0(torch)
    detail["card"] = card

    print("phase 1: kernels vs plain versions (bf16 tol "
          f"{BF16_TOL}, fp32 tol {FP32_TOL})", flush=True)
    records = phase1(torch, detail)

    def counts():
        return {**G.LAUNCHES, **PA.LAUNCHES}

    def reset():
        G.reset_launches()
        PA.reset_launches()

    base = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT_LEN),
            "--gen-len", str(GEN_LEN), "--seed", "0"]
    gemms_per_step = 7 * 24 + 1

    # Phase 2: the dense engine.
    reset()
    s2, tok2, eng2, wall2 = run_serve(base)
    c2 = counts()
    steps2 = PROMPT_LEN * eng2.stats.admission_rounds + eng2._step_calls
    print(f"phase 2: dense engine {s2['arch']} smoke reading {s2['tokens_per_s']} tokens/s "
          f"({eng2.stats.decode_steps} steady steps), warm-up {s2['compile_s']} s, "
          f"wall {wall2:.2f} s; launches {c2}; recurrence steps {steps2}", flush=True)
    check(s2["exec_backend"] == "cuda", f"dense engine ran {s2['exec_backend']}")
    check(c2["gemm_cuda"] == gemms_per_step * steps2,
          f"gemm_cuda launches {c2['gemm_cuda']} != {gemms_per_step} x {steps2}")
    check(tok2.shape == (BATCH, PROMPT_LEN + GEN_LEN), f"dense tokens {tok2.shape}")
    check(((tok2 >= 0) & (tok2 < 92544)).all(), "dense tokens out of vocabulary")
    lg2 = eng2.prefill_logits
    check(lg2 is not None and bool(torch.isfinite(lg2.float()).all()), "dense logits not finite")
    launches = {"gemm_cuda": c2["gemm_cuda"]}

    # Phase 3: the paged engine on the same requests.
    reset()
    s3, tok3, eng3, wall3 = run_serve(base + ["--paged", "on", "--page-size", str(PAGE_SIZE)])
    c3 = counts()
    steps3 = PROMPT_LEN * eng3.stats.admission_rounds + eng3._step_calls
    print(f"phase 3: paged engine smoke reading {s3['tokens_per_s']} tokens/s, warm-up {s3['compile_s']} s, "
          f"wall {wall3:.2f} s; launches {c3}; page size {eng3.pool.spec.page_size} "
          f"x {eng3.pool.spec.pages_per_slot}", flush=True)
    check(c3["paged_attention_cuda"] == 24 * steps3,
          f"paged launches {c3['paged_attention_cuda']} != 24 x {steps3}")
    check(c3["gemm_cuda"] == gemms_per_step * steps3, "paged engine GEMM launches")
    busy = torch.as_tensor([c.slot for c in eng2.completions], device="cuda")
    lg3 = eng3.prefill_logits
    dlog = float((lg3[busy].float() - lg2[busy].float()).abs().max())
    agree = float((tok3[:, PROMPT_LEN:] == tok2[:, PROMPT_LEN:]).mean())
    print(f"  paged vs dense: first-step max |logit diff| {dlog:.4f} (tol {LOGIT_TOL}), "
          f"equal generated tokens {agree:.3f}", flush=True)
    check(dlog <= LOGIT_TOL, f"paged vs dense logits differ by {dlog}")
    launches["paged_attention_cuda"] = c3["paged_attention_cuda"]

    # Phase 4: the one-shot path under the little class's tree.
    reset()
    s4, tok4, _, wall4 = run_serve(base + ["--one-shot", "--device-class", "little"])
    c4 = counts()
    agree4 = float((tok4[:, PROMPT_LEN:] == tok2[:, PROMPT_LEN:]).mean())
    print(f"phase 4: one-shot little ({s4['exec_backend']}) smoke reading {s4['tokens_per_s']} tokens/s, "
          f"wall {wall4:.2f} s; launches {c4}; equal generated tokens vs phase 2 {agree4:.3f}",
          flush=True)
    check(s4["exec_backend"] == "cuda_lean", f"little ran {s4['exec_backend']}")
    check(c4["gemm_cuda_lean"] > 0, "gemm_cuda_lean never launched on the little path")
    check(c4["gemm_cuda_lean"] == gemms_per_step * (PROMPT_LEN + GEN_LEN), "lean launch count")
    launches["gemm_cuda_lean"] = c4["gemm_cuda_lean"]

    print("phase 5: teacher-forced replay of phase 2's tokens", flush=True)
    replay = phase5(torch, tok2)

    print(f"phase 6: the card against the CPU at the reduced size (bf16 tol {BF16_TOL})",
          flush=True)
    detail["phase6"] = phase6(torch)

    meta = {
        "gemm_cuda": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:182"),
        "gemm_cuda_lean": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:273"),
        "paged_attention_cuda": ("src/repro_torch/csrc/paged_attention.cu",
                                 "src/repro/kernels/paged_attention.py:176"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "per": "one decode step of the serving path (169 GEMMs / 24 attention calls)",
        })
    detail["engines"] = {"dense": s2, "paged": s3, "one_shot_little": s4,
                         "paged_vs_dense_logit_diff": dlog, "paged_token_agreement": agree,
                         "little_token_agreement": agree4, "replay_logit_diff": replay}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_detail.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
