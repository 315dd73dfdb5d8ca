"""Semantic speaker analysis on one card: BERT dialogue detection (sequence
classification) and speaker-turn detection (token classification).

The counterpart of ``speaker3d_tpu/semantic/bert.py``, which drives
``transformers``' Flax BERT heads. The port has a BERT of its own, so that
the code the CPU tests hold against the JAX module is the code that runs on
the card:

- the modules carry ``transformers``' torch state_dict names
  (``bert.embeddings.word_embeddings.weight``,
  ``bert.encoder.layer.{i}.attention.self.query.weight``, ...,
  ``classifier.weight``), so a Hugging Face torch checkpoint loads by name;
- the forward is Flax's (``FlaxBertModule`` as the JAX step and eval call
  it): token types 0 and positions ``arange(L)``, the embeddings summed
  word + token type + position, LayerNorm at the config's eps, the query
  scaled by 1/sqrt(head size) before its product with the keys, masked keys
  biased by the float32 minimum, exact (erf) GELU, the pooler tanh on
  ``[CLS]``, and no dropout (the JAX step and eval pass
  ``deterministic=True``).

The products are the dense layers that the JAX package computes outside
Pallas (``nn.Linear``, ``torch.matmul``), fp32 with TF32 off in the step.

``make_semantic_train_step`` computes the JAX step's arithmetic on one
device: the lr's linear warm-up and decay in float32, the masked mean token
loss or the mean sequence NLL, and decoupled AdamW on every parameter
(LayerNorms, biases and embedding tables included):

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    p -= lr * ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd * p)

with t the step after the increment and the bias corrections in float32.
``torch.optim.AdamW`` decays ``p`` before its update and rounds in another
order.

Deliberate difference from the JAX module: the seeded weights draw Flax's
distributions (normal(initializer_range) for kernels and embedding tables,
zero biases, LayerNorms at one and zero) from a torch generator seeded by
``seed``; the JAX module draws from ``PRNGKey(seed)``, whose stream cannot
be reproduced. From one checkpoint the two packages agree.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.eval.embedding import matmul_precision
from speaker3d_tpu_torch.train.vad_train import AdamTrainState


class BertConfig(NamedTuple):
    """The fields of a Hugging Face BERT ``config.json`` that the forward
    reads; the defaults are bert-base-chinese's."""
    vocab_size: int = 21128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02


def read_config(pretrained_dir: str) -> BertConfig:
    """``pretrained_dir/config.json`` -> BertConfig; raises ValueError for
    an activation or a position embedding that this BERT does not run."""
    path = os.path.join(pretrained_dir, "config.json")
    with open(path) as f:
        raw = json.load(f)
    for key, want in (("hidden_act", "gelu"),
                      ("position_embedding_type", "absolute")):
        got = raw.get(key, want)
        if got != want:
            raise ValueError(f"{path}: {key} is {got!r}; this BERT runs "
                             f"{want!r} only")
    return BertConfig(**{k: raw[k] for k in BertConfig._fields if k in raw})


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids):
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)
        # token type 0 everywhere; Flax's order of the sum
        h = (self.word_embeddings(input_ids)
             + self.token_type_embeddings.weight[0]
             + self.position_embeddings(positions))
        return self.LayerNorm(h)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        if cfg.hidden_size % cfg.num_attention_heads:
            raise ValueError(f"hidden_size {cfg.hidden_size} is not a "
                             f"multiple of num_attention_heads "
                             f"{cfg.num_attention_heads}")
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, h, bias):
        """``h`` [B, L, D]; ``bias`` [B, 1, 1, L], 0 or the float32 minimum
        per key."""
        b, n = h.shape[:2]

        def heads(x):  # [B, L, D] -> [B, H, L, D / H]
            return x.view(b, n, self.num_heads, self.head_dim).transpose(1, 2)

        q = heads(self.query(h)) / float(np.sqrt(np.float32(self.head_dim)))
        scores = torch.matmul(q, heads(self.key(h)).transpose(-1, -2)) + bias
        ctx = torch.matmul(torch.softmax(scores, dim=-1), heads(self.value(h)))
        return ctx.transpose(1, 2).reshape(b, n, -1)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, h, bias):
        return self.output(self.self(h, bias), h)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, h):
        return nn.functional.gelu(self.dense(h))  # exact (erf), as Flax's


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, h, bias):
        a = self.attention(h, bias)
        return self.output(self.intermediate(a), a)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, h, bias):
        for layer in self.layer:
            h = layer(h, bias)
        return h


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, h):
        return torch.tanh(self.dense(h[:, 0]))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, add_pooling_layer: bool = True):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = BertPooler(cfg) if add_pooling_layer else None

    def forward(self, input_ids, attention_mask):
        """-> (hidden states [B, L, D], the pooled ``[CLS]`` [B, D] or
        None)."""
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(torch.float32).min)
        h = self.encoder(self.embeddings(input_ids), bias)
        return h, (self.pooler(h) if self.pooler is not None else None)


class BertForSequenceClassification(nn.Module):
    """Dialogue detection: the pooled ``[CLS]`` -> [B, num_labels]."""

    def __init__(self, cfg: BertConfig, num_labels: int = 2):
        super().__init__()
        self.bert = BertModel(cfg, add_pooling_layer=True)
        self.classifier = nn.Linear(cfg.hidden_size, num_labels)

    def forward(self, input_ids, attention_mask):
        return self.classifier(self.bert(input_ids, attention_mask)[1])


class BertForTokenClassification(nn.Module):
    """Speaker-turn detection: every token -> [B, L, num_labels]."""

    def __init__(self, cfg: BertConfig, num_labels: int = 2):
        super().__init__()
        self.bert = BertModel(cfg, add_pooling_layer=False)
        self.classifier = nn.Linear(cfg.hidden_size, num_labels)

    def forward(self, input_ids, attention_mask):
        return self.classifier(self.bert(input_ids, attention_mask)[0])


def init_bert_(model: nn.Module, seed: int, std: float) -> nn.Module:
    """Flax's initial weights drawn from a torch generator seeded with
    ``seed``, in module order: normal(``std``) for Dense kernels and
    embedding tables, zero biases, LayerNorms at one and zero."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, std, generator=gen)
                if isinstance(module, nn.Linear):
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
    return model


def _read_checkpoint(pretrained_dir: str) -> Dict[str, torch.Tensor]:
    path = os.path.join(pretrained_dir, "model.safetensors")
    if os.path.isfile(path):
        from safetensors.torch import load_file

        return load_file(path)
    path = os.path.join(pretrained_dir, "pytorch_model.bin")
    if os.path.isfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{pretrained_dir} holds neither "
                            f"model.safetensors nor pytorch_model.bin")


def load_pretrained_weights(model: nn.Module, pretrained_dir: str) -> None:
    """Load a Hugging Face torch BERT checkpoint into ``model`` by name.

    A pretraining checkpoint's MLM head (``cls.*``) and the
    ``bert.embeddings.position_ids`` buffer are dropped, and so is the pooler
    for a token head, which has none; LayerNorm ``gamma``/``beta`` (TF-era
    checkpoints) read as ``weight``/``bias``. Every other name must match the
    model's. ``classifier.*`` and ``bert.pooler.*``, where the checkpoint
    lacks them, keep the model's own (seeded) weights, as Flax's
    ``from_pretrained`` draws them."""
    own = model.state_dict()
    sd = {}
    for key, val in _read_checkpoint(pretrained_dir).items():
        if key.startswith("cls.") or key == "bert.embeddings.position_ids":
            continue
        if key.startswith("bert.pooler.") and not any(
                k.startswith("bert.pooler.") for k in own):
            continue
        sd[re.sub(r"LayerNorm\.beta$", "LayerNorm.bias",
                  re.sub(r"LayerNorm\.gamma$", "LayerNorm.weight", key))] = val
    missing = [k for k in own if k not in sd
               and not k.startswith(("classifier.", "bert.pooler."))]
    unexpected = [k for k in sd if k not in own]
    if missing or unexpected:
        raise KeyError(f"{pretrained_dir}: the checkpoint lacks {missing} "
                       f"and has no place for {unexpected}")
    model.load_state_dict({**own, **sd}, strict=True)


def build_model(task: str, *, num_labels: int = 2,
                pretrained_dir: Optional[str] = None, vocab_size: int = 21128,
                hidden_size: int = 768, num_hidden_layers: int = 12,
                num_attention_heads: int = 12, seed: int = 0,
                device=DEFAULT_DEVICE) -> nn.Module:
    """task: 'sequence' (dialogue detection) or anything else (turn
    detection, token classification). With ``pretrained_dir`` the widths
    come from its ``config.json`` and the weights from its
    ``model.safetensors`` or ``pytorch_model.bin``
    (``load_pretrained_weights``); without, the widths are the arguments
    (intermediate ``4 * hidden_size``), and the weights the seeded draw
    (``init_bert_``)."""
    device = resolve_device(device)
    if pretrained_dir:
        cfg = read_config(pretrained_dir)
    else:
        cfg = BertConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                         num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         intermediate_size=hidden_size * 4)
    cls = (BertForSequenceClassification if task == "sequence"
           else BertForTokenClassification)
    with torch.device("meta"):  # init_bert_ writes every parameter
        model = cls(cfg, num_labels)
    model = init_bert_(model.to_empty(device="cpu"), seed,
                       cfg.initializer_range)
    if pretrained_dir:
        load_pretrained_weights(model, pretrained_dir)
    return model.to(device)


class SemanticTrainConfig(NamedTuple):
    lr: float = 2e-5
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    warmup_steps: int = 0
    total_steps: int = 10000


def semantic_lr(step: int, cfg: SemanticTrainConfig) -> np.float32:
    """``lr * min(1, (step + 1) / max(warmup, 1)) * max(0, 1 - step /
    max(total, 1))``, each operation in float32 as the JAX step's."""
    f32 = np.float32
    lin = min(f32(1.0), f32(step + 1) / f32(max(cfg.warmup_steps, 1)))
    decay = max(f32(0.0), f32(1.0) - f32(step) / f32(max(cfg.total_steps, 1)))
    return f32(cfg.lr) * lin * decay


def semantic_loss(logits, labels, attention_mask, token_level: bool):
    """Token level: the mean NLL over the tokens whose label is not -100 and
    whose mask is set; else the mean NLL over the batch."""
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    if token_level:
        mask = (labels != -100) & (attention_mask > 0)
        nll = -logp.gather(-1, torch.where(mask, labels, 0)[..., None])[..., 0]
        return (nll * mask).sum() / mask.sum().clamp(min=1)
    return -logp.gather(1, labels[:, None]).mean()


def make_semantic_train_step(model: nn.Module, cfg: SemanticTrainConfig,
                             token_level: bool) -> Callable:
    """``step(state, batch) -> {'loss', 'lr', 'preds'}``: one AdamW step of
    ``model`` in place (the module docstring's arithmetic). ``state``: the
    moments by parameter name and the step
    (``train/vad_train.py::init_adam_train_state(model, device)``).
    ``batch``: ``input_ids``, ``attention_mask`` [B, L] and ``labels`` ([B]
    or [B, L], -100 ignored) on the model's device. ``loss`` and ``preds``
    (the argmax of the logits) are tensors on the device (no host sync),
    ``lr`` a float32 scalar."""
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay

    def step(state: AdamTrainState, batch) -> Dict:
        lr = semantic_lr(state.step, cfg)
        t = np.float32(state.step + 1)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        names, params = zip(*model.named_parameters())
        ids, att = batch["input_ids"], batch["attention_mask"]
        with matmul_precision("float32", ids.device):
            logits = model(ids, att)
            loss = semantic_loss(logits, batch["labels"], att, token_level)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                m = [state.adam_m[n] for n in names]
                v = [state.adam_v[n] for n in names]
                torch._foreach_mul_(m, b1)
                torch._foreach_add_(m, grads, alpha=1 - b1)
                torch._foreach_mul_(v, b2)
                torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
                denom = torch._foreach_div(v, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, eps)
                upd = torch._foreach_div(m, bc1)
                torch._foreach_div_(upd, denom)
                torch._foreach_add_(upd, list(params), alpha=wd)
                torch._foreach_add_(list(params), upd, alpha=-float(lr))
        state.step += 1
        return {"loss": loss.detach(), "lr": lr,
                "preds": logits.detach().argmax(dim=-1)}

    return step


def classification_metrics(labels, preds, ignore: int = -100) -> Dict:
    """Accuracy and macro precision, recall and F1 over the sorted union of
    the classes in ``labels`` and ``preds`` (a class never predicted, or
    never true, scores 0 there), ``ignore`` labels dropped: scikit-learn's
    ``accuracy_score`` and ``*_score(average='macro', zero_division=0)``,
    in their float64 arithmetic."""
    labels = np.asarray(labels).reshape(-1)
    preds = np.asarray(preds).reshape(-1)
    keep = labels != ignore
    labels, preds = labels[keep], preds[keep]
    classes = np.union1d(labels, preds)
    tp = np.array([np.sum((labels == c) & (preds == c)) for c in classes])
    n_true = np.array([np.sum(labels == c) for c in classes])
    n_pred = np.array([np.sum(preds == c) for c in classes])

    def ratio(num, den):  # zero_division=0
        return np.where(den > 0, num / np.maximum(den, 1), 0.0)

    precision, recall = ratio(tp, n_pred), ratio(tp, n_true)
    return {"accuracy": float(np.mean(labels == preds)),
            "precision": float(np.mean(precision)),
            "recall": float(np.mean(recall)),
            "f1": float(np.mean(ratio(2 * tp, n_true + n_pred)))}
