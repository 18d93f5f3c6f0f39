"""internlm2-1.8b's tree and draws stay as they were before the family
chose its head and its held vocabulary: the whole tree's names, shapes
and initialisers, and the first and last drawn leaves of a fixed seed by
a SHA-256 of their bytes (reduced on the CPU; whole on the card, where a
run draws them)."""

import hashlib

import pytest
import torch

from cells import reduced_cell
from portbench import cell as C
from portbench import weights as W

SEED = 2**31 + 4321

FULL_SPECS = [
    ("blocks.ln1", (24, 2048), "ones"), ("blocks.attn.wq", (24, 2048, 2048), "proj"),
    ("blocks.attn.wk", (24, 2048, 1024), "proj"), ("blocks.attn.wv", (24, 2048, 1024), "proj"),
    ("blocks.attn.wo", (24, 2048, 2048), "proj"), ("blocks.ln2", (24, 2048), "ones"),
    ("blocks.mlp.w1", (24, 2048, 8192), "proj"), ("blocks.mlp.w3", (24, 2048, 8192), "proj"),
    ("blocks.mlp.w2", (24, 8192, 2048), "proj"), ("final_norm", (2048,), "ones"),
    ("lm_head", (2048, 92544), "head"), ("embed", (92544, 2048), "embed"),
]

# (name, shape, dtype): SHA-256 of the bytes, drawn on the CPU at the reduced sizes.
REDUCED = {
    ("blocks.ln1", (4, 64), torch.float32):
        "893a106828fbdb9521e1d868c985aab7ad2ae2f606edc55329265a5e7676006c",
    ("blocks.attn.wq", (4, 64, 64), torch.float32):
        "51e1d995d2ec500c911fe8ff8bee9e6545e18b64f880bb8aafcba257674fc507",
    ("lm_head", (64, 256), torch.float32):
        "29c9892315ad99e392c3f098517984a39efd4057196863808ac4b3b42b71f299",
    ("embed", (256, 64), torch.float32):
        "33112ed3283604cd6a95185fbf8fb881bad58910a835fff16be6f0c6addfecfe",
    ("blocks.attn.wq", (4, 64, 64), torch.bfloat16):
        "8f4eb3ea3b3e576c0984a8d6c128f27253b936a0432e8f3507d8d1fdfd9c268a",
    ("embed", (256, 64), torch.bfloat16):
        "e7f0e6e72970b8a06baabe5e0e26357fee63d6a09178566b50ca32d47977af9d",
}

# The same at full size, drawn on the card (an H100, CUDA's generator).
CARD = {
    ("blocks.ln1", (24, 2048), torch.float32):
        "26c0417ccc34ee4e71842942561d0bfed76fb701454da823b3d1882d573c3d77",
    ("blocks.attn.wq", (24, 2048, 2048), torch.float32):
        "8b736d9cd67877b0733f75e4fad1cf8054e1e229dc3e1a7c51788dbe48b1f967",
    ("lm_head", (2048, 92544), torch.float32):
        "5d0ca309ad0082034f760be66067beb70e3e35812f8ec8a18b7efd0f9ad9b219",
    ("embed", (92544, 2048), torch.float32):
        "7dd71292f0ec5c3ad3ebecbe5dce977b419366ff4c0609aad60e498d60d92e3f",
}


def sha(x: torch.Tensor) -> str:
    x = x.detach().contiguous().cpu()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return hashlib.sha256(x.numpy().tobytes()).hexdigest()


def _drawn(conf, device, dtype, names):
    return {(n, tuple(x.shape), x.dtype): sha(x)
            for n, x in W.iter_params(conf, SEED, device, dtype) if n in names}


def test_internlm2_leaf_specs_are_as_before():
    conf = C.load_cell("internlm2-1.8b.train").conf
    assert [(n, tuple(s), i) for n, s, i in W.leaf_specs(conf)] == FULL_SPECS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_reduced_internlm2_draws_are_as_before(dtype):
    conf = reduced_cell("internlm2-1.8b.train").conf
    want = {k: v for k, v in REDUCED.items() if k[2] == dtype or k[0].startswith("blocks.ln")}
    got = _drawn(conf, "cpu", dtype, {k[0] for k in want})
    assert got == want


@pytest.mark.cuda
def test_internlm2_draws_on_the_card_are_as_before():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    conf = C.load_cell("internlm2-1.8b.train").conf
    assert _drawn(conf, "cuda", torch.float32, {k[0] for k in CARD}) == CARD
