"""A family with a tied output head and a padded vocabulary: the dense
family with ``tie_word_embeddings`` set, its held rows the published
vocabulary rounded up to ``pad_vocab_size_multiple`` by a stubbed
``held_vocab``.  The tree, the reference, the traffic and the counts."""

import sys
import types

import pytest
import torch

from portbench import cell as C
from portbench import counts, traffic
from portbench import weights as W
from portbench.families import dense
from portbench.reference import models as M
from portbench.reference import train as RT

SEED = 2**31 + 2024
CONF = {"family": "padded_dense", "hidden_size": 32, "intermediate_size": 64,
        "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
        "vocab_size": 50, "pad_vocab_size_multiple": 16, "tie_word_embeddings": True,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0}
HELD = 64


@pytest.fixture(autouse=True)
def padded_family(monkeypatch):
    mod = types.ModuleType("portbench.families.padded_dense")
    mod.__dict__.update({k: v for k, v in vars(dense).items() if not k.startswith("__")})
    mult = "pad_vocab_size_multiple"
    mod.held_vocab = lambda conf: -(-conf["vocab_size"] // conf[mult]) * conf[mult]
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


def _untied(params):
    """The same weights with an untied head equal to the embedding's
    transpose, a leaf of its own."""

    out = dict(params, embed=params["embed"].detach().clone())
    out["lm_head"] = params["embed"].detach().T.clone()
    return out


def test_the_tree_holds_no_head_and_the_held_rows():
    specs = {n: (s, i) for n, s, i in W.leaf_specs(CONF)}
    assert "lm_head" not in specs and specs["embed"] == ((HELD, 32), "embed")
    assert list(specs)[-2:] == ["final_norm", "embed"]
    tied_dense = dict(CONF, family="dense")
    assert {n: s for n, s, _ in W.leaf_specs(tied_dense)}["embed"] == (50, 32)
    untied = {n: s for n, s, _ in W.leaf_specs(dict(CONF, tie_word_embeddings=False))}
    assert untied["lm_head"] == (32, HELD) and untied["embed"] == (HELD, 32)
    params = W.make_params(CONF, SEED, "cpu")
    assert W.tree_signature(params)["embed"] == ((HELD, 32), "torch.float32")


def test_tied_logits_are_the_untied_with_the_embedding_as_head():
    params = W.make_params(CONF, SEED, "cpu")
    tokens = traffic.token_batch(SEED, "t", 2, 12, CONF["vocab_size"], "cpu")["tokens"]
    tied = M.logits(params, CONF, tokens)
    assert tied.shape == (2, 12, HELD)            # the softmax spans every held row
    untied = M.logits(_untied(params), dict(CONF, tie_word_embeddings=False), tokens)
    torch.testing.assert_close(tied, untied)


def test_the_tied_embedding_gradient_sums_both_parts():
    params = W.make_params(CONF, SEED, "cpu")
    batch = traffic.train_batch({"batch": 2, "seq": 12}, SEED, 0, CONF["vocab_size"], "cpu")
    untied = _untied(params)
    for tree in (params, untied):
        for _, p in RT.leaves(tree):
            p.requires_grad_(True)
    loss_t, g_t = RT.loss_and_grads(params, CONF, batch, "fp32")
    loss_u, g_u = RT.loss_and_grads(untied, dict(CONF, tie_word_embeddings=False), batch, "fp32")
    g_t = dict(zip([n for n, _ in RT.leaves(params)], g_t))
    g_u = dict(zip([n for n, _ in RT.leaves(untied)], g_u))
    assert loss_t == pytest.approx(loss_u, rel=1e-6)
    lookup, head = g_u["embed"], g_u["lm_head"].T
    assert float(lookup.abs().sum()) > 0 and float(head.abs().sum()) > 0
    torch.testing.assert_close(g_t["embed"], lookup + head)
    # No token is a padding row: those rows learn from the softmax alone.
    assert float(lookup[CONF["vocab_size"]:].abs().max()) == 0.0
    assert float(g_t["embed"][CONF["vocab_size"]:].abs().max()) > 0.0
    for name in g_u:
        if name not in ("embed", "lm_head"):
            torch.testing.assert_close(g_t[name], g_u[name])


def test_token_ids_and_labels_stay_in_the_published_vocabulary():
    cell = C.Cell(name="padded.train", entry={}, conf=CONF, traffic={"batch": 8, "seq": 512},
                  workload={"limits": {}})
    assert cell.vocab == CONF["vocab_size"]
    score = {"rows": 4, "length_min": 64, "length_max": 512, "length_multiple": 64, "deck": 4}
    batches = [traffic.train_batch(cell.traffic, SEED, k, cell.vocab, "cpu") for k in range(3)]
    batches += [traffic.score_request(score, SEED, i, cell.vocab, "cpu") for i in range(4)]
    for b in batches:
        for t in (b["tokens"], b["labels"]):
            assert int(t.min()) >= 0 and int(t.max()) < CONF["vocab_size"]
    assert max(int(b["tokens"].max()) for b in batches) == CONF["vocab_size"] - 1


def test_the_counts_run_the_head_over_the_held_rows():
    d, m = 32, 24
    forward = counts.gemm_products(CONF, m, train=False)
    assert forward[-1] == (m, d, HELD, 1)
    train = counts.gemm_products(CONF, m, train=True)
    assert (m, HELD, d, 1) in train and (d, m, HELD, 1) in train     # the head's dA and dB
    assert counts.matmul_params(CONF) == 2 * dense.layer_matmul_params(CONF) + d * HELD
    tied_at_published = dict(CONF, family="dense")
    assert counts.matmul_params(CONF) - counts.matmul_params(tied_at_published) == d * (HELD - 50)
