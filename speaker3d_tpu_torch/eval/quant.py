"""Post-training int8 quantization of the embedding backbones.

The counterpart of ``speaker3d_tpu/eval/quant.py``: every ``nn.Conv1d``,
``nn.Conv2d`` and ``nn.Linear`` of a model (on every backbone these are
exactly the modules the JAX package's interceptor quantizes, its ``nn.Conv``
and ``nn.Dense``; where the port holds a Flax ``Dense`` as a k=1 ``Conv1d``,
the product is the same) runs as

  - weights: per-output-channel symmetric int8, from the float32 weights;
  - activations: per-tensor symmetric int8 at ``scale / 127``, the scale
    the module's largest input magnitude over calibration batches (float32);
  - the int8 x int8 product accumulated exactly in int32 (``torch._int_mm``
    on the activations cut into im2col rows with the module's kernel shape,
    stride, padding and dilation), dequantized in float32, plus the bias of
    the ``compute_dtype``-cast model, cast to ``compute_dtype``.

Grouped and depthwise convs, and modules without a scale or with a zero
scale, stay float; the rest of the model runs in ``compute_dtype``. The
products are plain matrix products, as the JAX package leaves them to XLA
outside any Pallas kernel.

The Res2 blocks of ERes2NetV2 and ERes2Net run the Res2 kernel on folded
float weights in eval mode and never call their convs, so calibration and
the quantized model turn the kernel off in every block
(``BasicBlockERes2NetV2.use_kernel``): the int8 path launches no K2.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speaker3d_tpu_torch.eval.embedding import matmul_precision

QUANTIZED = (nn.Conv1d, nn.Conv2d, nn.Linear)


def quantizable(model: nn.Module) -> list:
    """(dotted name, module) of every Conv1d, Conv2d and Linear."""
    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, QUANTIZED)]


@contextlib.contextmanager
def res2_kernel_off(model: nn.Module):
    """Within the block, every Res2 block of ``model`` runs its convs."""
    blocks = [m for m in model.modules() if hasattr(m, "use_kernel")]
    saved = [b.use_kernel for b in blocks]
    for b in blocks:
        b.use_kernel = False
    try:
        yield
    finally:
        for b, on in zip(blocks, saved):
            b.use_kernel = on


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def calibrate_act_scales(model: nn.Module, feats,
                         percentile: float = 100.0) -> Dict[str, float]:
    """Run one representative batch in eval mode (fp32 products, the Res2
    kernel off) and record the max-abs (or ``percentile``) input of every
    quantizable module, keyed by its dotted name; a module called more than
    once keeps its largest."""
    records: Dict[str, float] = {}

    def recorder(name):
        def pre_hook(mod, args):
            a = args[0].detach().float().abs()
            v = (float(a.max()) if percentile >= 100.0 else
                 float(np.percentile(a.cpu().numpy(), percentile)))
            records[name] = max(records.get(name, 0.0), v)
        return pre_hook

    dev = _device(model)
    was_training = model.training
    handles = [mod.register_forward_pre_hook(recorder(name))
               for name, mod in quantizable(model)]
    try:
        model.eval()
        with torch.inference_mode(), res2_kernel_off(model), \
                matmul_precision("float32", dev):
            model(torch.as_tensor(feats, device=dev))
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return records


def _im2col(xq, kernel, stride, padding, dilation):
    """int8 [B, C, H, W] -> (rows [B * Ho * Wo, C * kh * kw] in the (c, kh,
    kw) order of an OIHW weight's rows, Ho, Wo), zero padding."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    x = F.pad(xq, (pw, pw, ph, ph))
    v = x.unfold(2, dh * (kh - 1) + 1, sh)[..., ::dh]   # [B, C, Ho, W, kh]
    v = v.unfold(3, dw * (kw - 1) + 1, sw)[..., ::dw]   # [B, C, Ho, Wo, kh, kw]
    b, c, ho, wo = v.shape[:4]
    return v.permute(0, 2, 3, 1, 4, 5).reshape(b * ho * wo, c * kh * kw), ho, wo


class _Int8Forward:
    """The quantized forward of one Conv1d, Conv2d or Linear (set as the
    module's ``forward``)."""

    def __init__(self, mod: nn.Module, w32: torch.Tensor, scale: float,
                 compute_dtype: torch.dtype):
        if isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            if isinstance(mod.padding, str) or mod.padding_mode != "zeros":
                raise NotImplementedError(
                    f"int8 conv with padding {mod.padding!r} "
                    f"({mod.padding_mode})")
        self.mod, self.compute_dtype = mod, compute_dtype
        n = w32.shape[0]
        w2 = w32.reshape(n, -1)
        w_scale = torch.clamp(w2.abs().amax(dim=1), min=1e-8) / 127.0
        wq = torch.clamp(torch.round(w2 / w_scale[:, None]), -127, 127)
        # torch._int_mm on the card takes more than 16 rows and K and N in
        # multiples of 8, and cuBLASLt refused N = 56 at K = 64 (its int8
        # kernels): K and N are padded to multiples of 16 with zeros, which
        # leave the int32 sums exact
        k = w2.shape[1]
        self.n = n
        kp, np_ = -(-k // 16) * 16, -(-n // 16) * 16
        wpad = torch.zeros((np_, kp), dtype=torch.int8, device=w32.device)
        wpad[:n, :k] = wq.to(torch.int8)
        self.wq_t = wpad.t()                     # [Kp, Np], column-major
        self.a_scale = torch.tensor(scale / 127.0, dtype=torch.float32,
                                    device=w32.device)
        self.dequant = self.a_scale * w_scale    # [N] float32

    def _matmul(self, rows):
        m, k = rows.shape
        kp = self.wq_t.shape[0]
        if k != kp or m <= 16:
            rows = F.pad(rows, (0, kp - k, 0, max(0, 17 - m)))
        return torch._int_mm(rows, self.wq_t)[:m, :self.n]

    def __call__(self, x):
        mod = self.mod
        xq = torch.clamp(torch.round(x.float() / self.a_scale),
                         -127, 127).to(torch.int8)
        if isinstance(mod, nn.Linear):
            acc = self._matmul(xq.reshape(-1, xq.shape[-1]))
            acc = acc.reshape(*x.shape[:-1], self.n)
        else:
            if isinstance(mod, nn.Conv1d):   # [B, C, T] as [B, C, 1, T]
                xq = xq.unsqueeze(2)
                geom = [(1, v[0]) for v in (mod.kernel_size, mod.stride,
                                            mod.dilation)]
                geom.insert(2, (0, mod.padding[0]))
            else:
                geom = [mod.kernel_size, mod.stride, mod.padding, mod.dilation]
            rows, ho, wo = _im2col(xq, *geom)
            acc = self._matmul(rows).reshape(x.shape[0], ho, wo, self.n)
        # channels last: the dequantization and the bias along the last axis
        y = acc.float() * self.dequant
        if mod.bias is not None:
            y = y + mod.bias.float()
        if not isinstance(mod, nn.Linear):
            y = y.permute(0, 3, 1, 2)
            if isinstance(mod, nn.Conv1d):
                y = y.squeeze(2)
        return y.to(self.compute_dtype)


def quantized_apply_fn(model: nn.Module, act_scales: Dict[str, float],
                       compute_dtype: torch.dtype = torch.bfloat16):
    """Return ``fn(feats) -> embeddings`` (in ``compute_dtype``) running the
    model's Conv1d/Conv2d/Linear in int8 on ``model``'s device.

    ``model`` is the float checkpoint and is left as it is: the quantized
    model is a copy cast to ``compute_dtype``, its int8 weights quantized
    from ``model``'s float32 weights. ``act_scales`` is
    ``calibrate_act_scales``'s output. The Res2 kernel is off in every block
    whose convs run in int8."""
    qmodel = copy.deepcopy(model).eval().to(compute_dtype)
    float_weights = {name: mod.weight.detach().float()
                     for name, mod in quantizable(model)}
    quantized = set()
    for name, mod in quantizable(qmodel):
        scale = act_scales.get(name)
        if scale is None or scale <= 0.0 or getattr(mod, "groups", 1) != 1:
            continue
        mod.forward = _Int8Forward(mod, float_weights[name], scale,
                                   compute_dtype)
        quantized.add(mod)
    for block in qmodel.modules():
        if hasattr(block, "use_kernel") and any(
                m in quantized for m in block.modules()):
            block.use_kernel = False
    dev = _device(qmodel)

    def apply_fn(feats):
        with torch.inference_mode(), matmul_precision("float32", dev):
            return qmodel(torch.as_tensor(feats, device=dev).to(compute_dtype))

    apply_fn.model = qmodel
    return apply_fn
