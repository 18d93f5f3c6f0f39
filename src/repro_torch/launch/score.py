"""Scoring CLI: the full-sequence forward on random prompts.

A thin CLI over ``model_zoo.make_prefill_fn`` (logits-only prefill) and
``model_zoo.make_loss_fn`` (the eval loss of each prompt's next tokens),
under the big class's control tree.  On the CUDA card every GEMM runs
the class's kernel and every layer's attention ``flash_attention_cuda``;
``--device cpu`` runs the kernels' plain versions and ``chunked_attention``.
Weights are random, from ``--seed``.  The loss is ``ce + aux``: the
cross-entropy and, for the MoE family, the router's load-balance loss,
reported apart.  Inputs follow the family: random tokens (the loss on the
tokens shifted by one); for whisper-small random normal bf16 ``frames``
(B, ``enc_frames``, D) beside the decoder's tokens; for pixtral-12b random
normal bf16 ``embeds`` (B, S, D) and random labels.

Example (one H100)::

    PYTHONPATH=src python -m repro_torch.launch.score --arch minitron-4b \\
        --batch 2 --seq-len 2048
    PYTHONPATH=src python -m repro_torch.launch.score --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.launch.score --arch whisper-small --seq-len 448
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import execution as X
from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
from repro_torch.models import model_zoo as Z
from repro_torch.runtime.serving import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--reduced", action="store_true", help="the config's tiny CPU-test variant")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_batch(cfg, b: int, s: int, seed: int, device):
    """The forward's inputs and the loss's labels, from numpy's generator
    at ``seed``: ``frames`` (B, enc_frames, D) and ``tokens`` for the
    encoder-decoder, ``embeds`` (B, S, D) with embedding inputs (normal
    draws in bf16), else ``tokens``; token-in labels are the tokens shifted
    by one."""

    rng = np.random.default_rng(seed)
    bf16 = lambda shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,  # noqa: E731
                                         device=device).to(torch.bfloat16)
    ints = lambda shape: torch.as_tensor(rng.integers(0, cfg.vocab, size=shape, dtype=np.int32),  # noqa: E731
                                         device=device)
    if cfg.embed_inputs:
        return {"embeds": bf16((b, s, cfg.d_model))}, ints((b, s))
    batch = {"frames": bf16((b, cfg.enc_frames, cfg.d_model))} if cfg.family == "encdec" else {}
    toks = ints((b, s + 1))
    return dict(batch, tokens=toks[:, :-1]), toks[:, 1:]


def score(args, *, params=None) -> dict:
    """One forward and one eval loss from parsed CLI ``args``; returns the
    JSON summary.  ``params`` defaults to the random weights of ``--seed``."""

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if params is None:
        params = Z.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    batch, labels = make_batch(cfg, args.batch, args.seq_len, args.seed, device)
    ctx = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1).execution_context("big")
    with ctx:
        _sync(device)
        t0 = time.perf_counter()
        logits = Z.make_prefill_fn(cfg)(params, batch)
        _sync(device)
        forward_s = time.perf_counter() - t0
        loss, metrics = Z.make_loss_fn(cfg)(params, dict(batch, labels=labels))
    return {
        "arch": cfg.name,
        "exec_backend": ctx.backend(),
        "attn_backend": X.resolve_flash_attn_backend("auto", device),
        "batch": args.batch,
        "seq_len": args.seq_len,
        "logits": list(logits.shape),
        "forward_s": round(forward_s, 4),
        "tokens_per_s": round(args.batch * args.seq_len / forward_s, 1),
        "loss": float(loss),
        "ce": float(metrics["ce"]),
        "aux": float(metrics["aux"]),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def main(argv=None) -> dict:
    summary = score(build_parser().parse_args(argv))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
