"""The SSD scan kernels' plain versions, and the scan's route, on the CPU.

``ssd_fwd_torch`` and ``ssd_bwd_torch`` (``kernels/ssd.py``) run the stages
of ``csrc/ssd_scan.cu`` with its arithmetic; the kernels themselves are
held to them on a card (``test_torch_cuda_ssd.py``).  Here they are held:

  * in fp32 (x, B, C and the output's gradient bf16 values carried in
    fp32, so that both sides multiply the same numbers) to ``_ssd_chunked``
    and to autograd through it: every output and gradient within
    ``FP32_TOL`` = 1e-4 in relative L2.  The plain versions split each fp32
    operand into a bf16 high and low pair (``split``), about 16 bits of it,
    and sum in other orders: readings up to 5e-6 (dA, a sum with
    cancellation, the highest).  With one bf16 rounding of those operands
    in place of the pair the same checks read 2.2e-3 to 2.8e-3: a planted
    fault that must fail them;
  * in bf16 (the kernels' dtypes) to ``_ssd_chunked`` and its autograd:
    within ``BF16_TOL`` = 2e-3, both rounding y, dx, dB and dC to bf16 at the
    end (readings up to 1.5e-4, dx).

Shapes: headdim 16, d_state 16 and 64, chunks of 8 and 16, one and two
groups, with and without an entering state; decays at both ends of the
published ranges (A in [1, 16], dt in [1e-4, 0.1]) and a step past them.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import SSMConfig
from repro_torch.kernels import ssd as SSD
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

torch.set_num_threads(1)

FP32_TOL = 1e-4
BF16_TOL = 2e-3

# (rows, seq, heads, groups, d_state, chunk, entering state, decays)
CASES = [
    (2, 32, 4, 1, 16, 8, False, "published"),
    (2, 32, 4, 2, 16, 8, True, "published"),
    (1, 48, 4, 2, 64, 16, False, "published"),
    (1, 64, 6, 1, 64, 16, True, "published"),
    (2, 32, 4, 2, 16, 16, True, "slowest"),
    (2, 32, 4, 1, 64, 8, False, "fastest"),
    (1, 32, 4, 2, 16, 8, True, "past"),
]
IDS = [f"b{b}-s{s}-h{h}-g{g}-n{n}-q{q}-{'init' if i else 'zero'}-{d}" for b, s, h, g, n, q, i, d in CASES]
HEADDIM = 16


def _inputs(case, dtype, seed=0):
    """bf16 values of x, B, C and the output's gradient (in ``dtype``),
    fp32 dt and A, an fp32 entering state and final-state gradient."""

    b, s, h, g, n, q, init, decays = case
    rng = np.random.default_rng(seed + 7 * s + n + 3 * h + g)
    bf = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(  # noqa: E731
        torch.bfloat16).to(dtype)
    x, Bm, Cm, dy = bf(b, s, h, HEADDIM), bf(b, s, g, n), bf(b, s, g, n), bf(b, s, h, HEADDIM)
    if decays == "slowest":
        A, dt = np.full(h, 1.0), np.full((b, s, h), 1e-4)
    elif decays == "fastest":
        A, dt = np.full(h, 16.0), np.full((b, s, h), 0.1)
    else:
        A = rng.uniform(1.0, 16.0, h)
        dt = np.exp(rng.uniform(math.log(1e-4), math.log(0.1), (b, s, h)))
        if decays == "past":  # one step a row past the published range
            dt[:, s // 2 + 1] = 1.0
    A = -torch.from_numpy(A.astype(np.float32))
    dt = torch.from_numpy(dt.astype(np.float32))
    f32 = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    h0 = f32(b, h, n, HEADDIM) if init else None
    return x, dt, A, Bm, Cm, h0, dy, f32(b, h, n, HEADDIM)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _autograd(x, dt, A, Bm, Cm, h0, dy, dfinal, chunk):
    """``_ssd_chunked``'s outputs and, by autograd, its gradients."""

    cfg = SSMConfig(d_model=64, d_state=Bm.shape[3], headdim=HEADDIM, chunk=chunk)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    init = None if h0 is None else h0.clone().requires_grad_(True)
    y, final = S._ssd_chunked(*ins, cfg, init_state=init)
    torch.autograd.backward([y, final], [dy, dfinal])
    grads = [t.grad for t in ins] + ([init.grad] if init is not None else [])
    return y.detach(), final.detach(), grads


def _readings(case, dtype):
    *ins, h0, dy, dfinal = _inputs(case, dtype)
    q = case[5]
    y, final = SSD.ssd_fwd_torch(*ins, q, h0)
    grads = SSD.ssd_bwd_torch(*ins, q, dy, dfinal, h0)
    y_ref, final_ref, grads_ref = _autograd(*ins, h0, dy, dfinal, q)
    names = ["dx", "ddt", "dA", "dB", "dC", "d_init"]
    out = {"y": _rel(y, y_ref), "final": _rel(final, final_ref)}
    out.update({k: _rel(g, r) for k, g, r in zip(names, grads, grads_ref)})
    assert y.dtype == dtype and grads[0].dtype == dtype and grads[3].dtype == dtype
    assert grads[1].dtype == grads[2].dtype == torch.float32
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_ssd_chunked(case):
    r = _readings(case, torch.float32)
    assert r["y"] <= FP32_TOL and r["final"] <= FP32_TOL, r


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd(case):
    r = _readings(case, torch.float32)
    grads = {k: v for k, v in r.items() if k not in ("y", "final")}
    assert len(grads) == (6 if case[6] else 5)
    assert all(v <= FP32_TOL for v in grads.values()), grads


@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_plain_versions_in_bf16(case):
    r = _readings(case, torch.bfloat16)
    assert all(v <= BF16_TOL for v in r.values()), r


@pytest.mark.parametrize("case", CASES[1:3], ids=IDS[1:3])
def test_one_bf16_rounding_of_the_fp32_operands_fails(case, monkeypatch):
    monkeypatch.setattr(SSD, "split", lambda v: v.to(torch.bfloat16).float())
    r = _readings(case, torch.float32)
    assert max(r.values()) > FP32_TOL, r


def test_plain_backward_with_no_final_gradient():
    case = CASES[1]
    *ins, h0, dy, _ = _inputs(case, torch.float32)
    grads = SSD.ssd_bwd_torch(*ins, case[5], dy, None, h0)
    _, _, grads_ref = _autograd(*ins, h0, dy, torch.zeros(h0.shape), case[5])
    assert max(_rel(g, r) for g, r in zip(grads, grads_ref)) <= FP32_TOL


def test_scan_on_the_cpu_is_ssd_chunked_bitwise():
    """``_scan`` on CPU tensors never takes the kernels: no launch, no
    count of a CUDA fallback, and its outputs and gradients are
    ``_ssd_chunked``'s bit for bit."""

    case = CASES[1]
    x, dt, A, Bm, Cm, h0, dy, dfinal = _inputs(case, torch.bfloat16)
    cfg = SSMConfig(d_model=64, d_state=case[4], headdim=HEADDIM, chunk=case[5])
    SSD.reset_launches()
    fallbacks = L.CUDA_CALLS["ssd_chunked"]
    assert not SSD.kernel_takes(x, dt, A, Bm, Cm, case[5], h0)
    results = []
    for fn in (S._scan, S._ssd_chunked):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y, final = fn(*ins, cfg, init_state=h0)
        torch.autograd.backward([y, final], [dy, dfinal])
        results.append([y, final] + [t.grad for t in ins])
    assert all(torch.equal(a, b) for a, b in zip(*results))
    assert all(v == 0 for v in SSD.LAUNCHES.values())
    assert L.CUDA_CALLS["ssd_chunked"] == fallbacks


def test_ssd_scan_cuda_refuses_cpu_tensors():
    x, dt, A, Bm, Cm, *_ = _inputs(CASES[0], torch.bfloat16)
    with pytest.raises(ValueError, match="ssd_scan_cuda takes"):
        SSD.ssd_scan_cuda(x, dt, A, Bm, Cm, 8)
    assert SSD.LAUNCHES["ssd_scan_cuda"] == 0


@pytest.mark.parametrize("rep,hps", [(64, 8), (80, 8), (1, 1), (6, 6), (12, 6), (9, 3)])
def test_heads_per_split_divides_the_group(rep, hps):
    assert SSD.heads_per_split(rep) == hps
