"""The frozen counts: the floating-point operations, the bytes and the
GEMM shapes that a cell's work needs, worked out from the configuration
file's sizes and the cell's shapes alone.

They count what the model needs, not what the program happens to do, so a
change that removes work from the program leaves them as they are.

  * model FLOPs: ``2·N`` a token forward and ``6·N`` a token trained, ``N``
    the weights of every matrix product (the projections and the output
    head over the held vocabulary, tied or not; the embedding is a
    lookup), plus the sequence mixer's own
    products (causal attention's ``2·Hq·Dh·S²`` a sequence and layer
    forward); training counts the mixer three times its forward.  No
    recomputation counted.
  * the GEMM funnel's products: the family's products that go through
    the funnel (an InternLM2 layer's projections) and the head; a
    training step runs each
    forward product, each layer's product again in the recompute, and the
    two backward products ``dA = dC·Bᵀ`` and ``dB = Aᵀ·dC``.
  * roofline bounds: a product's least time on the chip is the larger of
    its operations over the peak rate and its bytes (each operand read
    once, the result written once, bfloat16) over the peak bandwidth.
"""

from __future__ import annotations

import json
import os

from portbench import families

HERE = os.path.dirname(os.path.abspath(__file__))
BF16 = 2


def peaks() -> dict:
    with open(os.path.join(os.path.dirname(HERE), "peaks.json")) as f:
        return json.load(f)


def matmul_params(conf: dict) -> int:
    """``N``: the weights that enter a matrix product for every token."""

    fam = families.load(conf["family"])
    head = fam.d_model(conf) * fam.held_vocab(conf)
    return fam.n_layers(conf) * fam.layer_matmul_params(conf) + head


def mixer_flops(conf: dict, seq: int) -> int:
    """The sequence mixer's forward operations for one sequence of
    ``seq`` tokens, all layers."""

    return families.load(conf["family"]).mixer_flops(conf, seq)


def train_flops(conf: dict, rows: int, seq: int) -> int:
    return 6 * matmul_params(conf) * rows * seq + 3 * rows * mixer_flops(conf, seq)


def forward_flops(conf: dict, rows: int, seq: int) -> int:
    return 2 * matmul_params(conf) * rows * seq + rows * mixer_flops(conf, seq)


def gemm_products(conf: dict, m: int, *, train: bool) -> list:
    """``[(M, K, N, count)]``: the GEMM funnel's products for ``m`` rows
    of tokens, a forward (``train=False``) or a training step."""

    fam = families.load(conf["family"])
    layer = fam.funnel_products(conf, m)
    forward = layer + [(m, fam.d_model(conf), fam.held_vocab(conf), 1)]
    if not train:
        return forward
    backward = []
    for (mm_, k, n, c) in forward:
        backward += [(mm_, n, k, c), (k, mm_, n, c)]   # dA = dC·Bᵀ, dB = Aᵀ·dC
    return forward + layer + backward


def launches(products) -> int:
    return sum(c for *_, c in products)


def product_flops(products) -> int:
    return sum(2 * m * k * n * c for m, k, n, c in products)


def gemm_bound_s(products, pk: dict) -> float:
    t = 0.0
    for m, k, n, c in products:
        ops = 2 * m * k * n
        nbytes = BF16 * (m * k + k * n + m * n)
        t += c * max(ops / pk["bf16_flops"], nbytes / pk["hbm_bytes_per_s"])
    return t


def flash_bound_s(conf: dict, rows: int, seq: int, pk: dict) -> float:
    """The causal attention calls of one forward of ``rows`` x ``seq``."""

    return families.load(conf["family"]).flash_bound_s(conf, rows, seq, pk)
