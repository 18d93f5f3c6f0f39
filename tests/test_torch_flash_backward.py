"""The flash attention backward's plain version, on the CPU.

``flash_attention_bwd_torch`` walks the backward kernels' blocks with their
arithmetic (``csrc/flash_attention.cu``; the kernels themselves are held to
it on a card, in ``test_torch_cuda.py``).  It is held here:

  * in fp32 to autograd through ``flash_attention_torch``, the forward's
    plain version: relative L2 error a gradient at most ``FP32_TOL`` = 2e-5
    (both sides fp32 end to end, sums in other orders; readings about
    4e-7);
  * in bf16 to autograd through ``chunked_attention``, the CPU's training
    route: dQ and dK within ``BF16_TOLS["dqdk"]`` = 1e-2, because the
    kernels round ``dS`` to bf16 as the operand of ``dQ = dS K`` and ``dK =
    dS^T Q`` where ``chunked_attention``'s autograd multiplies it in fp32
    (8 mantissa bits, readings 3.0e-3 to 3.5e-3); dV within
    ``BF16_TOLS["dv"]`` = 1e-3, because both round the normalised ``P`` to
    bf16 for ``P^T dO`` and differ only where ``exp(s - lse)`` and the
    softmax part in the last fp32 bit (readings up to 1.4e-4).

A dropped key block and ``dS`` left unmasked, planted in the plain
version, fail each check.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import execution as X
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L
from repro_torch.models import model_zoo as Z

torch.set_num_threads(1)

FP32_TOL = 2e-5
BF16_TOLS = {"dqdk": 1e-2, "dv": 1e-3}

# (B, Sq, Sk, Hq, Hkv, D, causal, window): a GQA group of 1, 2 and 4; a
# query suffix; non-causal (whisper's encoder, its cross-attention's Sq <
# Sk); a causal and a non-causal window; head dims 64, 80 (zamba2's, padded
# to 128 by the kernels) and 128.
CASES = [
    (2, 130, 130, 2, 2, 64, True, None),
    (1, 96, 200, 4, 2, 80, True, None),
    (1, 150, 150, 4, 1, 128, False, None),
    (1, 70, 190, 4, 4, 64, False, None),
    (1, 200, 200, 4, 2, 64, True, 50),
    (1, 100, 180, 8, 2, 80, False, 40),
]
IDS = [f"b{b}-q{sq}-k{sk}-h{hq}/{hkv}-d{d}-{'causal' if c else 'bidir'}-w{w}"
       for b, sq, sk, hq, hkv, d, c, w in CASES]


def _inputs(case, dtype, seed=0):
    b, sq, sk, hq, hkv, d, _, _ = case
    rng = np.random.default_rng(seed + 31 * sq + sk + d)
    shapes = ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype) for s in shapes]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def _autograd(fn, q, k, v, dout, **kw):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fn(*leaves, **kw).backward(dout)
    return [t.grad for t in leaves]


def _errors(case, dtype):
    """The plain backward's relative errors (dq, dk, dv) against autograd
    through the dtype's route: ``flash_attention_torch`` in fp32,
    ``chunked_attention`` in bf16."""

    *_, causal, window = case
    kw = dict(causal=causal, window=window)
    q, k, v, dout = _inputs(case, dtype)
    ref = FA.flash_attention_torch if dtype == torch.float32 else L.chunked_attention
    want = _autograd(ref, q, k, v, dout, **kw)
    o, lse = FA.flash_attention_torch(q, k, v, with_lse=True, **kw)
    got = FA.flash_attention_bwd_torch(q, k, v, o, dout, lse, **kw)
    assert [g.dtype for g in got] == [dtype] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    return [_rel(g, w) for g, w in zip(got, want)]


def _within(errors, dtype) -> bool:
    if dtype == torch.float32:
        return max(errors) <= FP32_TOL
    return max(errors[:2]) <= BF16_TOLS["dqdk"] and errors[2] <= BF16_TOLS["dv"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd(case, dtype):
    errors = _errors(case, dtype)
    assert _within(errors, dtype), errors


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_training_forward_lse_is_the_rows_logsumexp(case):
    b, sq, sk, hq, hkv, d, causal, window = case
    q, k, v, _ = _inputs(case, torch.float32)
    out, lse = FA.flash_attention_torch(q, k, v, causal=causal, window=window, with_lse=True)
    assert torch.equal(out, FA.flash_attention_torch(q, k, v, causal=causal, window=window))
    s = torch.einsum("bqhd,bkhd->bhqk", q, L.repeat_kv(k, hq // hkv)) / math.sqrt(d)
    q_pos = torch.arange(sq)[:, None] + (sk - sq)
    mask = FA._visible(q_pos, torch.arange(sk)[None, :], causal, window)
    want = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def _drop_last_key_block(walk):
    def dropped(*args):
        blocks = walk(*args)
        return range(blocks.start, blocks.stop - 1)
    return dropped


PLANTED = {
    "dropped_key_block": lambda mp: mp.setattr(FA, "key_blocks", _drop_last_key_block(FA.key_blocks)),
    "dS_unmasked": lambda mp: mp.setattr(
        FA, "_visible", lambda q_pos, k_idx, causal, window: torch.ones(
            (q_pos.shape[0], k_idx.shape[1]), dtype=torch.bool)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_faults_fail_each_check(fault, dtype, monkeypatch):
    """The reference gradients come first; the fault is planted in the
    plain backward alone (the forward's walk and mask run before it)."""

    case = CASES[4]
    *_, causal, window = case
    kw = dict(causal=causal, window=window)
    q, k, v, dout = _inputs(case, dtype)
    ref = FA.flash_attention_torch if dtype == torch.float32 else L.chunked_attention
    want = _autograd(ref, q, k, v, dout, **kw)
    o, lse = FA.flash_attention_torch(q, k, v, with_lse=True, **kw)
    PLANTED[fault](monkeypatch)
    got = FA.flash_attention_bwd_torch(q, k, v, o, dout, lse, **kw)
    errors = [_rel(g, w) for g, w in zip(got, want)]
    assert not _within(errors, dtype), errors


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_query_walk_skips_only_blocks_that_see_none_of_the_keys(case):
    """The dK/dV kernel's (key block, q-block) walk: every q-block it leaves
    out sees none of the key block's keys, and every one it visits sees
    some (tight at block granularity, as the forward's key walk)."""

    _, sq, sk, _, _, _, causal, window = case
    q_pos = torch.arange(sq)[:, None] + (sk - sq)
    vis = FA._visible(q_pos, torch.arange(sk)[None, :], causal, window)
    for kb in range(-(-sk // FA.BLOCK_K)):
        walk = FA.query_blocks(kb, sq, sk, causal, window)
        keys = vis[:, kb * FA.BLOCK_K:(kb + 1) * FA.BLOCK_K]
        for qb in range(-(-sq // FA.BLOCK_Q)):
            seen = bool(keys[qb * FA.BLOCK_Q:(qb + 1) * FA.BLOCK_Q].any())
            assert seen == (qb in walk), (kb, qb)


def test_training_route_is_chunked_attention_on_the_cpu(monkeypatch):
    """The training loss takes its attention by ``"auto"``: on the CPU that
    resolves to ``chunked_attention`` (the reference's training
    arithmetic), for a CUDA device to the kernels; the kernels' wrapper
    refuses CPU tensors that require grad rather than fall back."""

    assert X.resolve_flash_attn_backend("auto", torch.device("cpu")) == "flash_attn_torch"
    assert X.resolve_flash_attn_backend("auto", torch.device("cuda", 0)) == "flash_attn_cuda"
    calls = []
    chunked = L.chunked_attention
    monkeypatch.setattr(L, "chunked_attention", lambda *a, **kw: calls.append(1) or chunked(*a, **kw))
    cfg = get_config("internlm2-1.8b").reduced()
    params = Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    for t in _leaves(params):
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg.vocab, seed=0).batch(0, 2, 16).items()}
    FA.reset_launches()
    loss, _ = Z.make_loss_fn(cfg)(params, batch)
    loss.backward()
    assert len(calls) == 2 * cfg.n_layers  # the forward and the remat recompute
    assert not any(FA.LAUNCHES.values())
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention_cuda(q, q, q)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []
