"""The port's BERT heads and metrics against the JAX package's
``semantic/bert.py`` (``transformers``' Flax heads).

Flax parameters from the JAX ``build_model`` go through the port's
converter: both heads' logits match at 1e-5 on a batch with padded rows
(the train steps: ``tests/test_torch_semantic_step.py``). The metrics
equal scikit-learn's (through the JAX function) on label sets where a class
is never predicted or never true; the converter round-trips. A Hugging
Face pretraining directory loads by name: the MLM head and
``position_ids`` dropped, TF-era LayerNorm names read, a missing classifier
drawn as the seeded model's; an activation or position embedding that this
BERT does not run, and a name it cannot place, are refused.
"""

import json
import os

import numpy as np
import pytest
import torch

from speaker3d_tpu.semantic import bert as jbert
from speaker3d_tpu_torch.compat.flax_convert import (
    flax_from_state_dict, state_dict_from_flax)
from speaker3d_tpu_torch.semantic import bert as tbert
from tests.semantic_common import (
    TASKS, TINY, batch, jax_logits, jax_models as build_jax_models, port,
    torch_batch)
from tests.torch_threads import cap_torch_threads  # noqa: F401

LOGIT_TOL = 1e-5
EMBED = ("word_embeddings", "position_embeddings", "token_type_embeddings")


@pytest.fixture(scope="module")
def jax_models():
    return build_jax_models()


@pytest.mark.parametrize("task,token_level", TASKS)
def test_logits_match_the_flax_heads(jax_models, task, token_level):
    jm = jax_models[task]
    b = batch(np.random.default_rng(3), token_level)
    want = jax_logits(jm, jm.params, b["input_ids"], b["attention_mask"])
    model = port(task, jm.params)
    tb = torch_batch(b)
    with torch.no_grad():
        got = model(tb["input_ids"], tb["attention_mask"]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("labels,preds", [
    ([0, 1, 2, 2, 1, 0], [0, 0, 0, 2, 2, 0]),           # 1 never predicted
    ([0, 0, 1, 1], [0, 0, 0, 0]),                       # one class predicted
    ([1, 1, 1, -100, 0], [1, 1, 2, 0, 1]),              # 2 never true
    ([[-100, 0, 1, 1], [-100, 1, 0, -100]], [[1, 0, 1, 0], [0, 1, 1, 1]]),
])
def test_metrics_equal_sklearn(labels, preds):
    want = jbert.classification_metrics(np.asarray(labels), np.asarray(preds))
    got = tbert.classification_metrics(np.asarray(labels), np.asarray(preds))
    assert got == want


@pytest.mark.parametrize("task", ["sequence", "token"])
def test_converter_round_trip(jax_models, task):
    params = jax_models[task].params
    sd = state_dict_from_flax({"params": params})
    back = flax_from_state_dict(sd, embed=EMBED)
    assert list(back) == ["params"]

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    want, got = dict(flat(params)), dict(flat(back["params"]))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    again = state_dict_from_flax(back)
    assert sorted(again) == sorted(sd)
    for key in sd:
        assert torch.equal(again[key], sd[key]), key


def _pretraining_dir(root, **config):
    """A pretraining checkpoint of the port's seeded sequence model (seed 1)
    as ``pytorch_model.bin``: ``bert.*`` with the embeddings' LayerNorm under
    TF-era names, an MLM head and ``position_ids``, no classifier."""
    model = tbert.build_model("sequence", seed=1, device="cpu", **TINY)
    sd = {k.replace("embeddings.LayerNorm.weight", "embeddings.LayerNorm.gamma")
          .replace("embeddings.LayerNorm.bias", "embeddings.LayerNorm.beta"): v
          for k, v in model.state_dict().items()
          if not k.startswith("classifier.")}
    sd["cls.predictions.bias"] = torch.zeros(TINY["vocab_size"])
    sd["bert.embeddings.position_ids"] = torch.arange(512)[None]
    os.makedirs(root)
    torch.save(sd, os.path.join(root, "pytorch_model.bin"))
    cfg = {"model_type": "bert", "hidden_act": "gelu",
           "vocab_size": TINY["vocab_size"], "hidden_size": 32,
           "num_hidden_layers": 2, "num_attention_heads": 2,
           "intermediate_size": 128, **config}
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f)
    return model


def test_pretrained_dir_loads_by_name_with_seeded_heads(tmp_path):
    saved = _pretraining_dir(str(tmp_path / "ckpt")).state_dict()
    seeded = tbert.build_model("sequence", seed=7, device="cpu",
                               **TINY).state_dict()
    model = tbert.build_model("sequence", pretrained_dir=str(tmp_path / "ckpt"),
                              seed=7, device="cpu")
    for key, val in model.state_dict().items():
        want = seeded[key] if key.startswith("classifier.") else saved[key]
        assert torch.equal(val, want), key
    # the token head has no pooler: the checkpoint's is left unused
    token = tbert.build_model("token", pretrained_dir=str(tmp_path / "ckpt"),
                              num_labels=3, device="cpu")
    assert token.classifier.weight.shape == (3, 32)
    assert torch.equal(token.bert.encoder.layer[1].output.dense.weight,
                       saved["bert.encoder.layer.1.output.dense.weight"])


@pytest.mark.parametrize("config,error", [
    ({"hidden_act": "relu"}, "hidden_act is 'relu'"),
    ({"position_embedding_type": "relative_key"},
     "position_embedding_type is 'relative_key'"),
])
def test_pretrained_dir_refuses_what_this_bert_does_not_run(tmp_path, config,
                                                            error):
    _pretraining_dir(str(tmp_path / "ckpt"), **config)
    with pytest.raises(ValueError, match=error):
        tbert.build_model("sequence", pretrained_dir=str(tmp_path / "ckpt"),
                          device="cpu")


def test_pretrained_dir_refuses_names_it_cannot_place(tmp_path):
    root = str(tmp_path / "ckpt")
    _pretraining_dir(root)
    sd = torch.load(os.path.join(root, "pytorch_model.bin"))
    sd["bert.encoder.layer.2.output.dense.weight"] = torch.zeros(32, 128)
    del sd["bert.encoder.layer.0.output.dense.bias"]
    torch.save(sd, os.path.join(root, "pytorch_model.bin"))
    with pytest.raises(KeyError, match="layer.0.output.dense.bias"):
        tbert.build_model("sequence", pretrained_dir=root, device="cpu")
