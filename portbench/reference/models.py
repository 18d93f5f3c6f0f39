"""The language model around a family's layers, forward passes in float32.

An embedding lookup, the family's layers in turn (``families/<family>.py``,
``layer``), a final RMSNorm and the output head: ``lm_head``, or the
embedding's transpose where the family ties them (the embedding's
gradient then sums the lookup's part and the head's).  The logits span
every row the embedding holds.  The weights come in the
program's tree layout, every layer's tensor stacked on a leading axis,
projections stored ``(in, out)``.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from portbench import families
from portbench.reference.precision import mm


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _layer_params(blocks, i):
    if isinstance(blocks, dict):
        return {k: _layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


def hidden(params, conf, tokens, precision: str = "fp32", remat: bool = False):
    """The final-normed hidden states (B, S, D) float32 of ``tokens`` (B, S)."""

    fam = families.load(conf["family"])
    x = params["embed"].float()[tokens.long()]
    for i in range(fam.n_layers(conf)):
        p = _layer_params(params["blocks"], i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(fam.layer, x, p, conf, precision,
                                                  use_reentrant=False)
        else:
            x = fam.layer(x, p, conf, precision)
    return rms_norm(x, params["final_norm"], fam.norm_eps(conf))


def logits(params, conf, tokens, precision: str = "fp32", remat: bool = False):
    """(B, S, V) float32 logits, V the held vocabulary."""

    tied = families.load(conf["family"]).tied_head(conf)
    head = params["embed"].T if tied else params["lm_head"]
    return mm(hidden(params, conf, tokens, precision, remat), head, precision)


def token_logprobs(params, conf, tokens, labels, precision: str = "fp32"):
    """log p(label | prefix) at every position, (B, S) float32, a row at
    a time (a row's logits and nothing more are held at once)."""

    out = []
    for r in range(tokens.shape[0]):
        lg = logits(params, conf, tokens[r:r + 1], precision)
        lp = torch.log_softmax(lg, dim=-1)
        out.append(lp.gather(-1, labels[r:r + 1, :, None].long())[..., 0])
        del lg, lp
    return torch.cat(out)
