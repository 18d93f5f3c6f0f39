"""One model family a module, found by the ``family`` of a configuration
file (``families/<family>.py``).  A module exposes:

  * ``n_layers(conf)``, ``d_model(conf)``, ``norm_eps(conf)``: the
    file's sizes under the family's published keys;
  * ``tied_head(conf) -> bool``: whether the output head is the
    embedding's transpose; then the tree holds no ``lm_head`` leaf and
    the reference multiplies by ``embed``ᵀ, so the embedding's gradient
    sums the lookup's part and the head's;
  * ``held_vocab(conf) -> int``: the rows the embedding and the head
    hold, the published vocabulary padded as the model pads it.  The
    softmax, the weights and the counts run over every held row; the
    traffic's token ids and labels stay in the published ``vocab_size``
    (``cell.Cell.vocab``);
  * ``port_widths(conf, cfg) -> [(key, file value, program value)]``:
    every size the program's config ``cfg`` of the same model must share
    with the file;
  * ``block_leaves(conf) -> [(name, shape, init)]``: one layer's weights
    as the program's tree holds them (``name`` dotted under ``blocks``),
    in the order ``weights.py`` draws them (``init``: ``"ones"``,
    ``"proj"``, or ``init(gen, shape, device)`` giving a float32 tensor);
  * ``layer(x, p, conf, precision)``: one layer of the plain reference,
    float32, every matrix product through ``reference.precision.mm``;
  * ``layer_matmul_params(conf)``, ``mixer_flops(conf, seq)``,
    ``funnel_products(conf, m)``, ``flash_bound_s(conf, rows, seq, pk)``:
    the frozen counts of a layer (``counts/``);
  * ``reduced(conf, cfg)``: the file with its sizes replaced by those of
    a reduced program config, for the CPU tests.
"""

from __future__ import annotations

import importlib


def load(family: str):
    return importlib.import_module(f"portbench.families.{family}")
