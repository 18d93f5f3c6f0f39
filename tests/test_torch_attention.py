"""Port vs reference: full-sequence attention.

Inputs are drawn with numpy from a seed and handed to both packages.  The
JAX side runs its Pallas ``flash_attention`` as its own tests do on the CPU
(``interpret=True``, 64-row blocks) and its ``kernels/ref.py`` oracle; it
takes equal head counts, so for GQA it gets ``repeat_kv``'d K/V while the
port reads the KV heads in place.  The CUDA kernel itself is held against
its plain version in ``test_torch_cuda.py``, on a card.

Tolerances, as ``tests/test_kernels_gemm.py`` uses for the JAX kernel:
fp32 rtol = atol = 2e-5 (both sides run fp32 arithmetic end to end, in
other orders); bf16 3e-2 (``p`` and the output round to 8 mantissa bits).
``chunked_attention`` rounds q, k, v and ``p`` to bf16 whatever the input
dtype, so it is held at the bf16 tolerance in both dtypes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models import layers as JL

from repro_torch.core import execution as X
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as R
from repro_torch.models import layers as L

torch.set_num_threads(1)

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (B, Sq, Sk, Hq, Hkv, D, causal, window): ATTN_CASES of
# tests/test_kernels_gemm.py (equal heads), then GQA groups of 2 and 3.
CASES = [
    (2, 128, 128, 2, 2, 64, True, None),
    (1, 100, 100, 1, 1, 64, True, None),     # ragged padding
    (1, 64, 192, 2, 2, 64, True, None),      # query suffix
    (2, 128, 128, 2, 2, 64, False, None),    # bidirectional
    (1, 256, 256, 1, 1, 64, True, 64),       # sliding window
    (1, 128, 128, 2, 2, 128, True, None),    # head dim 128
    (2, 96, 96, 4, 2, 32, True, None),       # GQA group 2
    (1, 100, 300, 6, 2, 64, True, None),     # GQA group 3, ragged suffix
    (1, 200, 200, 3, 1, 16, True, 48),       # GQA group 3, window
    (1, 70, 130, 6, 2, 32, False, 40),       # GQA group 3, bidirectional window
]
IDS = [f"b{b}-q{sq}-k{sk}-h{hq}/{hkv}-d{d}-{'causal' if c else 'bidir'}-w{w}"
       for b, sq, sk, hq, hkv, d, c, w in CASES]


def _inputs(case, dt, seed=0):
    b, sq, sk, hq, hkv, d, _, _ = case
    rng = np.random.default_rng(seed + sq * 7 + sk)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    return ([jnp.asarray(a, JAX_DT[dt]) for a in arrs],
            [torch.from_numpy(a).to(TORCH_DT[dt]) for a in arrs])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dt):
    np.testing.assert_allclose(_np(got), _np(want), **TOLS[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_attention_torch_matches_pallas_interpret_and_oracles(case, dt):
    *_, hq, hkv, _, causal, window = case
    (jq, jk, jv), (q, k, v) = _inputs(case, dt)
    g = hq // hkv
    jk_rep, jv_rep = JL.repeat_kv(jk, g), JL.repeat_kv(jv, g)
    pallas = jax_flash_attention(jq, jk_rep, jv_rep, causal=causal, window=window,
                                 block_q=64, block_k=64, interpret=True)
    got = FA.flash_attention_torch(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, pallas, dt)
    _close(got, JR.attention_ref(jq, jk_rep, jv_rep, causal=causal, window=window), dt)
    k_rep, v_rep = L.repeat_kv(k, g), L.repeat_kv(v, g)
    assert np.array_equal(_np(k_rep), _np(jk_rep))
    ref = R.attention_ref(q, k_rep, v_rep, causal=causal, window=window)
    _close(ref, JR.attention_ref(jq, jk_rep, jv_rep, causal=causal, window=window), dt)
    _close(got, ref, dt)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_walk_skips_only_wholly_masked_key_blocks(case):
    """The (q-block, key-block) walk the kernel and its plain version share:
    every key block it leaves out is masked for every row of the q-block,
    and every block it visits is seen by some row (the causal and window
    bounds are tight at block granularity)."""

    _, sq, sk, _, _, _, causal, window = case
    q_pos = np.arange(sq)[:, None] + (sk - sq)
    k_pos = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), dtype=bool)
    if causal:
        vis &= q_pos >= k_pos
    if window is not None:
        vis &= (q_pos - k_pos) < window
    for q0 in range(0, sq, FA.BLOCK_Q):
        walk = FA.key_blocks(q0, sq, sk, causal, window)
        rows = vis[q0:q0 + FA.BLOCK_Q]
        for kb in range(-(-sk // FA.BLOCK_K)):
            seen = rows[:, kb * FA.BLOCK_K:(kb + 1) * FA.BLOCK_K].any()
            assert seen == (kb in walk), (q0, kb)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chunked_attention_matches_reference(case, dt):
    *_, causal, window = case
    (jq, jk, jv), (q, k, v) = _inputs(case, dt, seed=1)
    for q_chunk in (32, 512):  # several ragged chunks (and the window's key span); one chunk
        want = JL.chunked_attention(jq, jk, jv, causal=causal, window=window, q_chunk=q_chunk)
        got = L.chunked_attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk)
        assert got.dtype == q.dtype and got.shape == q.shape
        _close(got, want, "bfloat16")


def test_flash_attention_cuda_refuses_cpu_tensors_and_counts_no_launch():
    (_, (q, k, v)) = _inputs(CASES[6], "bfloat16")
    FA.reset_launches()
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention_cuda(q, k, v)
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention_cuda(*meta)
    assert FA.LAUNCHES == dict.fromkeys(FA.LAUNCHES, 0) and "flash_attention_cuda" in FA.LAUNCHES


def test_flash_attention_rejects_bad_operands():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="incompatible"):
        FA.flash_attention_torch(q, torch.zeros((1, 8, 3, 16)), torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention_torch(q, q, q, window=0)


def test_attention_backends_resolve_by_device():
    """``"auto"`` is the CUDA kernel for tensors on a card and
    ``chunked_attention`` for tensors on the CPU; the family's names are
    closed under the registry checks."""

    assert X.validate_registry() == []
    assert X.plain_twin("flash_attn_cuda") == "flash_attn_torch"
    assert X.resolve_flash_attn_backend("auto", torch.device("cpu")) == "flash_attn_torch"
    assert X.resolve_flash_attn_backend("auto", torch.device("cuda", 0)) == "flash_attn_cuda"
    assert X.resolve_flash_attn_backend("flash_attn_torch", "cuda") == "flash_attn_torch"
    with pytest.raises(ValueError, match="not a full-sequence attention"):
        X.resolve_flash_attn_backend("cuda", "cuda")  # repro: noqa=RPR005 -- a negative test: a name of the other op family must raise
    with pytest.raises(ValueError, match="not a GEMM"):
        X.resolve_backend("flash_attn_cuda")  # repro: noqa=RPR005 -- a negative test: a name of the other op family must raise


def test_dispatch_routes_the_cpu_forward_through_chunked_attention():
    (_, (q, k, v)) = _inputs(CASES[7], "bfloat16")
    got = X.dispatch_flash_attention(q, k, v, causal=True)
    assert torch.equal(got, L.chunked_attention(q, k, v, causal=True))
