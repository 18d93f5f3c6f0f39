"""Mamba2-1.3B as published in the port (``mamba2-1.3b-published``).

Its config against the reference's variant (``mamba2-1.3b``, which the
JAX-parity tests hold) and against the benchmark's configuration file;
its tied head, fp32 residual and published initialisation; the scan's
spans and counter; and the program held to the benchmark's plain fp32
reference (``portbench/families/ssm.py``, the quadratic form of the SSD)
at the reduced sizes on the CPU, on the benchmark's seeded weights.

Tolerances.  The program computes every product in bf16 and rounds the
mixer's conv outputs, its scan output and its gated norm to bf16 (the
reference's arithmetic); at the reduced sizes the mixers add the whole
stream, so the logits read 1.2-1.3% from the fp32 reference in L2
(three seeds), the loss 1e-5-1.1e-4 and the worst leaf's gradient
2.3-4.6% (the small vectors ``A_log``, ``D``, ``dt_bias``, ``ln``).  The
limits sit at about twice those readings.  A bf16 residual (the port's
variant precision) moves these by less than the products' noise at this
size, so its control is read where each layer adds a tenth of a large
stream, as late layers of a deep stack do: there the fp32 residual keeps
the final stream within 6e-4 and a bf16 one reads 4e-3.
"""

import dataclasses
import json
import math
import os
import sys

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import cell as C  # noqa: E402
from portbench import traffic  # noqa: E402
from portbench import weights as W  # noqa: E402
from portbench.families import ssm as FS  # noqa: E402
from portbench.reference import models as M  # noqa: E402
from portbench.reference import train as RT  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.observability import trace  # noqa: E402

PUB = "mamba2-1.3b-published"
SEEDS = (2**31 + 11, 2**33 + 12, 5)
LOGIT_TOL = 0.03      # L2, relative; readings 1.2-1.3%
LOSS_TOL = 1e-3       # relative; readings 1e-5-1.1e-4
GRAD_TOL = 0.1        # a leaf's L2, relative; worst readings 2.3-4.6%
HIDDEN_TOL = 2e-3     # the control's regime: fp32 residual 6e-4, bf16 residual 4e-3


def _conf():
    with open(os.path.join(ROOT, "portbench", "configs", "mamba2-1.3b.json")) as f:
        return json.load(f)


def _reduced():
    cfg = get_config(PUB).reduced()
    return cfg, FS.reduced(_conf(), cfg)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _batch(conf, seed, rows=2, seq=32):
    return traffic.train_batch({"batch": rows, "seq": seq}, seed, 0, conf["vocab_size"], "cpu")


# ---------------------------------------------------------------------------
# The config
# ---------------------------------------------------------------------------


def test_the_published_config():
    cfg = get_config(PUB)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.vocab) == ("ssm", 48, 2048, 50288)
    s = cfg.ssm
    assert (s.d_model, s.d_state, s.headdim, s.expand, s.n_groups, s.d_conv, s.chunk) == \
        (2048, 128, 64, 2, 1, 4, 256)
    assert cfg.tie_embeddings and cfg.residual_in_fp32 and s.published_init
    assert (s.A_init_range, s.dt_min, s.dt_max, s.dt_init_floor) == ((1.0, 16.0), 0.001, 0.1, 1e-4)
    assert PUB not in list_configs() and "mamba2-1.3b" in list_configs()


def test_the_two_configs_differ_only_in_the_published_fields():
    """The parity tests hold ``mamba2-1.3b`` to the JAX package; every
    code path the two configs share is held with it."""

    mirror, pub = get_config("mamba2-1.3b"), get_config(PUB)
    assert not mirror.tie_embeddings and not mirror.residual_in_fp32
    assert not mirror.ssm.published_init and mirror.vocab == 50280
    fields = {"name", "notes", "vocab", "tie_embeddings", "residual_in_fp32", "ssm"}
    a, b = dataclasses.asdict(mirror), dataclasses.asdict(pub)
    assert {k for k in a if a[k] != b[k]} <= fields
    init = {"A_init_range", "dt_min", "dt_max", "dt_init_floor"}
    assert {k for k in a["ssm"] if a["ssm"][k] != b["ssm"][k]} == init
    red_a, red_b = dataclasses.asdict(mirror.reduced()), dataclasses.asdict(pub.reduced())
    assert {k for k in red_a if red_a[k] != red_b[k]} <= fields


def test_reduced_keeps_the_published_fields():
    cfg = get_config(PUB).reduced()
    assert cfg.tie_embeddings and cfg.residual_in_fp32 and cfg.ssm.published_init
    assert cfg.ssm.A_init_range == (1.0, 16.0) and cfg.ssm.dt_init_floor == 1e-4


def test_the_benchmark_file_checks_the_port_config():
    conf = _conf()
    assert conf["reduced"] == [] and FS.held_vocab(conf) == 50288
    C.check_port_config(conf, get_config(PUB))
    cfg, red = _reduced()
    C.check_port_config(red, cfg)
    with pytest.raises(SystemExit, match="residual_in_fp32"):
        C.check_port_config(conf, dataclasses.replace(get_config(PUB), residual_in_fp32=False))
    with pytest.raises(SystemExit, match="held_vocab"):
        C.check_port_config(conf, get_config("mamba2-1.3b"))


def test_param_count_counts_the_tied_head_once():
    pub, mirror = get_config(PUB), get_config("mamba2-1.3b")
    per_layer = mirror._mamba_params()
    assert pub.param_count() == 48 * per_layer + 50288 * 2048
    assert mirror.param_count() == 48 * per_layer + 2 * 50280 * 2048


def test_the_tree_holds_no_lm_head_and_is_the_benchmarks():
    tree = Z.init_params(get_config(PUB), None, "meta", dtype=torch.float32)
    assert sorted(tree) == ["blocks", "embed", "final_norm"]
    assert tuple(tree["embed"].shape) == (50288, 2048)
    assert {n: tuple(shape) for n, shape, _ in W.leaf_specs(_conf())} == \
        {n: shape for n, (shape, _) in W.tree_signature(tree).items()}
    cfg, conf = _reduced()
    assert W.tree_signature(W.make_params(conf, 1, "cpu")) == \
        W.tree_signature(Z.init_params(cfg, None, "meta", dtype=torch.float32))


# ---------------------------------------------------------------------------
# The initialisation
# ---------------------------------------------------------------------------


def _check_published_init(m, nl, di):
    A = -torch.exp(m["A_log"])
    assert float(A.min()) >= -16.0 and float(A.max()) <= -1.0
    dt = F.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-4 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert float(dt.max()) > 0.01 and float(dt.min()) < 0.01     # log-uniform, spread
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    for k in ("conv_w_x", "conv_b_x", "conv_w_bc", "conv_b_bc"):
        assert float(m[k].abs().max()) <= 0.5 and float(m[k].abs().max()) > 0.3
    std = float(m["out_proj"].float().std())
    assert std == pytest.approx(1.0 / math.sqrt(di * nl), rel=0.1)


def test_the_port_draws_the_published_initialisation():
    cfg = get_config(PUB).reduced()
    p = Z.init_params(cfg, torch.Generator().manual_seed(3), "cpu", dtype=torch.float32)
    _check_published_init(p["blocks"]["mamba"], cfg.n_layers, cfg.ssm.d_inner)
    assert float(p["embed"].std()) == pytest.approx(0.02, rel=0.1)
    for k in ("A_log", "dt_bias", "D"):
        assert p["blocks"]["mamba"][k].dtype == torch.float32


def test_the_benchmark_draws_the_published_initialisation():
    cfg, conf = _reduced()
    p = W.make_params(conf, 2**31 + 3, "cpu")
    _check_published_init(p["blocks"]["mamba"], cfg.n_layers, cfg.ssm.d_inner)


def test_the_mirrored_config_keeps_the_reference_initialisation():
    cfg = get_config("mamba2-1.3b").reduced()
    m = Z.init_params(cfg, torch.Generator().manual_seed(3), "cpu")["blocks"]["mamba"]
    for k in ("A_log", "dt_bias", "conv_b_x", "conv_b_bc"):
        assert float(m[k].abs().max()) == 0.0, k
    assert "lm_head" in Z.init_params(cfg, torch.Generator().manual_seed(3), "cpu")


def test_the_small_vectors_enter_the_scan_in_fp32():
    cfg = get_config(PUB).reduced()
    blocks = Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           dtype=torch.float32)["blocks"]
    cast = T._cast_params(blocks, T._fp32_leaves(cfg))["mamba"]
    assert {k for k, v in cast.items() if v.dtype == torch.float32} == set(S.FP32_LEAVES)
    mirror = dataclasses.replace(cfg, residual_in_fp32=False)
    cast = T._cast_params(blocks, T._fp32_leaves(mirror))["mamba"]
    assert all(v.dtype == torch.bfloat16 for v in cast.values())


# ---------------------------------------------------------------------------
# The program against the plain reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_logits_and_loss_match_the_reference(seed):
    cfg, conf = _reduced()
    params = W.make_params(conf, seed, "cpu")
    batch = _batch(conf, seed)
    with torch.no_grad():
        got, _ = T.forward_lm(params, cfg, batch)
        want = M.logits(params, conf, batch["tokens"])
        loss, _ = Z.make_loss_fn(cfg)(params, batch)
    assert got.shape == want.shape == (2, 32, cfg.vocab) and got.dtype == torch.bfloat16
    assert _rel(got, want) < LOGIT_TOL
    ref_loss = float(F.cross_entropy(want.reshape(-1, cfg.vocab), batch["labels"].reshape(-1).long()))
    assert abs(float(loss.detach()) - ref_loss) / ref_loss < LOSS_TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_every_leaf_gradient_matches_the_reference(seed):
    """The training loss (fp32 masters, each layer recomputed) through the
    GEMM funnel's head; ``embed`` carries the lookup's part and the
    head's, the padding rows the head's alone."""

    cfg, conf = _reduced()
    batch = _batch(conf, seed)
    prog = W.make_params(conf, seed, "cpu")
    for _, p in RT.leaves(prog):
        p.requires_grad_(True)
    loss, _ = Z.make_loss_fn(cfg)(prog, batch)
    loss.backward()
    ref = W.make_params(conf, seed, "cpu")
    named = RT.leaves(ref)
    for _, p in named:
        p.requires_grad_(True)
    ref_loss, grads = RT.loss_and_grads(ref, conf, batch, "fp32")
    want = {n: g for (n, _), g in zip(named, grads)}
    assert abs(float(loss.detach()) - ref_loss) / ref_loss < LOSS_TOL
    got = dict(RT.leaves(prog))
    assert set(got) == set(want) and "lm_head" not in got
    for name, g in want.items():
        assert _rel(got[name].grad, g) < GRAD_TOL, name
    pad = slice(conf["vocab_size"], cfg.vocab)
    head_only = want["embed"][pad]
    assert float(head_only.abs().max()) > 0
    assert _rel(got["embed"].grad[pad], head_only) < GRAD_TOL


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_prefill_and_decode_match_the_reference_forward(seed):
    """The bulk prefill (the decode recurrence over the prompt) and decode
    steps after it, each step's logits against the reference's full
    forward at that position; the logits-only prefill too."""

    cfg, conf = _reduced()
    params = W.make_params(conf, seed, "cpu", torch.bfloat16)
    tokens = _batch(conf, seed, seq=24)["tokens"]
    with torch.no_grad():
        want = M.logits(params, conf, tokens)
        prompt, steps = 16, 8
        state = Z.init_decode_state(cfg, 2, 24, device="cpu")
        last, state = Z.make_prefill_fn(cfg, with_cache=True)(
            params, {"tokens": tokens[:, :prompt]}, state, 0)
        assert _rel(last[:, 0], want[:, prompt - 1]) < LOGIT_TOL
        decode = Z.make_decode_fn(cfg)
        for t in range(prompt, prompt + steps):
            lg, state = decode(params, {"tokens": tokens[:, t:t + 1]}, state, t)
            assert _rel(lg[:, 0], want[:, t]) < LOGIT_TOL, t
        full = Z.make_prefill_fn(cfg)(params, {"tokens": tokens})
    assert _rel(full, want) < LOGIT_TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_a_bf16_residual_fails_the_stream_tolerance(seed):
    """The control.  With the embedding 50 times larger and ``out_proj``
    a tenth, each layer adds about a tenth of the stream: the fp32
    residual keeps the final-normed stream within ``HIDDEN_TOL`` of the
    reference's; the same program with its residual in bf16 (the port's
    variant precision, ``residual_in_fp32`` off) does not."""

    cfg, conf = _reduced()
    params = W.make_params(conf, seed, "cpu")
    params["embed"] *= 50.0
    params["blocks"]["mamba"]["out_proj"] *= 0.1
    batch = _batch(conf, seed)
    with torch.no_grad():
        want = M.hidden(params, conf, batch["tokens"])
        got, _ = T.hidden_lm(params, cfg, batch)
        bf16, _ = T.hidden_lm(params, dataclasses.replace(cfg, residual_in_fp32=False), batch)
    assert got.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert _rel(got, want) < HIDDEN_TOL
    assert _rel(bf16, want) > HIDDEN_TOL


# ---------------------------------------------------------------------------
# Spans and the scan counter
# ---------------------------------------------------------------------------


def _trainer(tmp_path, seq=32):
    args = LT.build_parser().parse_args(
        ["--arch", PUB, "--reduced", "--device", "cpu", "--global-batch", "2", "--seq", str(seq),
         "--steps", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1000000000"])
    return LT.make_trainer(args)


def test_a_training_step_spans_every_scan_and_counts_them(tmp_path):
    trainer = _trainer(tmp_path)
    cfg = trainer.arch
    batch = _batch({"vocab_size": cfg.vocab}, 7)
    trace.profiled_spans()
    S.reset_scans()
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step(batch)
    spans = trace.profiled_spans()
    nl, chunks = cfg.n_layers, 32 // cfg.ssm.chunk
    # forward and the remat recompute, each layer once
    assert S.SCANS == {"calls": 2 * nl, "chunks": 2 * nl * chunks}
    scans = [s for s in spans if s.name == "ssm.scan"]
    back = [s for s in spans if s.name == "ssm.scan.backward"]
    assert sorted(s.args["phase"] for s in scans) == ["forward"] * nl + ["recompute"] * nl
    assert len(back) == nl
    tags = dict(rows=2, seq=32, heads=cfg.ssm.n_heads, headdim=cfg.ssm.headdim,
                d_state=cfg.ssm.d_state, groups=1, chunk=cfg.ssm.chunk)
    for s in scans + back:
        assert {k: s.args[k] for k in tags} == tags and s.device_s is None   # no card
    # each layer's backward span after its recompute, inside the step's backward
    step = next(s for s in spans if s.name == "trainer.backward")
    rec = sorted((s for s in scans if s.args["phase"] == "recompute"), key=lambda s: s.ts)
    for r, b in zip(rec, sorted(back, key=lambda s: s.ts)):
        assert r.ts + r.dur <= b.ts
        assert step.ts <= b.ts and b.ts + b.dur <= step.ts + step.dur


def test_the_spans_change_nothing_and_cost_nothing_off(tmp_path):
    """Off, the scan takes no bracket nodes and records nothing; its
    gradients equal those taken under the profiler bitwise."""

    cfg, conf = _reduced()
    batch = _batch(conf, 9)
    out = []
    for traced in (False, True):
        params = W.make_params(conf, 9, "cpu")
        for _, p in RT.leaves(params):
            p.requires_grad_(True)
        S.reset_scans()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                loss, _ = Z.make_loss_fn(cfg)(params, batch)
                loss.backward()
            assert any(s.name == "ssm.scan.backward" for s in trace.profiled_spans())
        else:
            assert not trace.live()
            loss, _ = Z.make_loss_fn(cfg)(params, batch)
            loss.backward()
        assert S.SCANS["calls"] == 2 * cfg.n_layers
        out.append((loss.detach(), [p.grad for _, p in RT.leaves(params)]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_a_scan_without_gradients_takes_no_backward_span():
    cfg = get_config(PUB).reduced()
    p = Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(1, 16, cfg.d_model).bfloat16()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        S.apply_mamba2(T.layer_params(p["blocks"]["mamba"], 0), x, cfg.ssm)
    names = [s.name for s in trace.profiled_spans()]
    assert names == ["ssm.scan"]


# ---------------------------------------------------------------------------
# One card only; the train CLI from scratch
# ---------------------------------------------------------------------------


def test_the_sharded_steps_refuse_the_tied_head():
    cfg = get_config(PUB).reduced()
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.long)}
    for call in (lambda: T.forward_lm_sharded({}, cfg, batch, None),
                 lambda: T.loss_fn_sharded({}, cfg, batch, None),
                 lambda: T.decode_step_sharded({}, cfg, batch, {}, 0, None, {}),
                 lambda: Z.gather_logits(None, cfg, None, 2)):
        with pytest.raises(ValueError, match=cfg.name):
            call()


def test_the_train_cli_trains_the_published_model_from_scratch(tmp_path):
    out = LT.main(["--arch", PUB, "--reduced", "--device", "cpu", "--steps", "2",
                   "--seq", "32", "--ckpt-dir", str(tmp_path)])
    assert out["arch"] == PUB + "-smoke" and out["steps"] == 2
    assert math.isfinite(out["first_loss"]) and math.isfinite(out["last_loss"])
    # a fresh model's loss is about log of the held rows
    assert abs(out["first_loss"] - math.log(256)) < 0.5
