"""One BN-folded, inference-only Res2 block: the Hopper kernel and its plain
version.

The counterpart of ``speaker3d_tpu/ops/pallas/res2_block_kernel.py``. A
scale-2 ERes2NetV2 block without AFF, every BatchNorm folded into its conv:
1x1 expand + Hardtanh(0, 20), split into halves of width w, 3x3 conv on the
first half, add to the second half, 3x3 conv, concat, 1x1 project plus the
shortcut (1x1 conv + BN, or identity), Hardtanh(0, 20). The CUDA kernel
(``csrc/res2_block.cu``) takes NCHW activations, reads the even rows and
columns itself when the stride is 2, and runs every contraction on the
tensor cores in 3xTF32 (fp32-level error) with weights that the fold splits
and packs into fragment order once (``ops/kernels/tf32.py``).

``res2_block`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; ``res2_block.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from speaker3d_tpu_torch.kernels.build import check, library
from speaker3d_tpu_torch.models.common import relu20
from speaker3d_tpu_torch.ops.kernels.tf32 import pack_b, round8


@dataclass(frozen=True)
class FoldedRes2Block:
    """BN-folded weights of one scale-2 block: OIHW for the plain version,
    packed 3xTF32 B fragments (``pack_b``) for the kernel."""

    w1: torch.Tensor            # [2w, Cin, 1, 1]
    b1: torch.Tensor            # [2w]
    wc1: torch.Tensor           # [w, w, 3, 3]
    bc1: torch.Tensor           # [w]
    wc2: torch.Tensor           # [w, w, 3, 3]
    bc2: torch.Tensor           # [w]
    w3: torch.Tensor            # [Cout, 2w, 1, 1]
    b3: torch.Tensor            # [Cout]: bn3's and the shortcut BN's biases
    wsc: Optional[torch.Tensor]  # [Cout, Cin, 1, 1] or None (identity)
    p_w1: torch.Tensor          # K = Cin, N = 2w
    p_wc1: torch.Tensor         # K = 9w, row (df*3 + dt)*w + c; N = w
    p_wc2: torch.Tensor
    p_w3: torch.Tensor          # K = 2w, N = Cout
    p_wsc: Optional[torch.Tensor]  # K = Cin, N = Cout

    @property
    def width(self) -> int:
        return self.bc1.shape[0]


def fold_res2_block(sd: Mapping[str, torch.Tensor],
                    eps: float = 1e-5) -> FoldedRes2Block:
    """Fold BatchNorm (running statistics) into the preceding convs, and
    pack the kernel's weights.

    ``sd`` maps the block's state_dict names (``conv1.weight``,
    ``bn1.running_var``, ``convs.0.weight``, ``shortcut.1.bias``, ...) to
    tensors; the fold runs in float32 on their device."""

    def fold(conv, bn):
        k = sd[f"{conv}.weight"].detach().float()
        g = sd[f"{bn}.weight"].detach().float() / torch.sqrt(
            sd[f"{bn}.running_var"].detach().float() + eps)
        b = sd[f"{bn}.bias"].detach().float() - sd[f"{bn}.running_mean"].detach().float() * g
        return (k * g[:, None, None, None]).contiguous(), b.contiguous()

    def kmajor(k):  # OIHW -> [(kh*KW + kw)*I + i, O]
        o, i, kh, kw = k.shape
        return k.permute(2, 3, 1, 0).reshape(kh * kw * i, o)

    w1, b1 = fold("conv1", "bn1")
    wc1, bc1 = fold("convs.0", "bns.0")
    wc2, bc2 = fold("convs.1", "bns.1")
    w3, b3 = fold("conv3", "bn3")
    wsc = p_wsc = None
    if "shortcut.0.weight" in sd:
        wsc, bsc = fold("shortcut.0", "shortcut.1")
        p_wsc = pack_b(kmajor(wsc))
        b3 = (b3 + bsc).contiguous()
    return FoldedRes2Block(w1, b1, wc1, bc1, wc2, bc2, w3, b3, wsc,
                           pack_b(kmajor(w1)), pack_b(kmajor(wc1)),
                           pack_b(kmajor(wc2)),
                           pack_b(kmajor(w3)), p_wsc)


def res2_block_plain(x, p: FoldedRes2Block, stride: int = 1):
    """x [B, Cin, F, T] -> [B, Cout, F', T'] with F.conv2d on the folded
    weights."""
    w = p.width
    h = relu20(F.conv2d(x, p.w1, p.b1, stride=stride))
    y1 = relu20(F.conv2d(h[:, :w], p.wc1, p.bc1, padding=1))
    y2 = relu20(F.conv2d(h[:, w:] + y1, p.wc2, p.bc2, padding=1))
    out = F.conv2d(torch.cat([y1, y2], dim=1), p.w3, p.b3)
    res = x if p.wsc is None else F.conv2d(x, p.wsc, stride=stride)
    return relu20(out + res)


def _lib():
    lib = library("res2_block")
    if not getattr(lib, "_s3d_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.s3d_res2_block_f32.restype = i
        lib.s3d_res2_block_f32.argtypes = [p] * 11 + [i] * 7 + [p]
        lib._s3d_bound = True
    return lib


def res2_block_cuda(x, p: FoldedRes2Block, stride: int = 1):
    """Launch csrc/res2_block.cu on x's CUDA device. The launch picks the
    output tile; a shape that no tile takes (w > 64, Cout > 256) returns
    ``cudaErrorInvalidValue``, raised here."""
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim != 4:
        raise ValueError("res2 kernel: x must be a float32 [B, C, F, T] "
                         "CUDA tensor")
    if stride not in (1, 2):
        raise ValueError(f"res2 kernel: unsupported stride {stride}")
    x = x.contiguous()
    batch, cin, fin, tin = x.shape
    w, cout = p.width, p.w3.shape[0]
    if p.w1.shape[1] != cin:
        raise ValueError(f"res2 kernel: x has {cin} channels, the block "
                         f"expects {p.w1.shape[1]}")
    if p.wsc is None and (stride != 1 or cin != cout):
        raise ValueError("res2 kernel: identity shortcut needs stride 1 and "
                         "Cin == Cout")
    want = {"p_w1": (cin, 2 * w), "p_wc1": (9 * w, w),
            "p_wc2": (9 * w, w), "p_w3": (2 * w, cout)}
    if p.p_wsc is not None:
        want["p_wsc"] = (cin, cout)
    for name, (k, n) in want.items():
        if getattr(p, name).shape != (round8(k) // 8, round8(n) // 8, 32, 4):
            raise ValueError(f"res2 kernel: {name} is not packed for "
                             f"K = {k}, N = {n}")
    weights = [getattr(p, name) for name in want] + [p.b1, p.bc1, p.bc2, p.b3]
    for t in weights:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("res2 kernel: folded weights must be contiguous "
                             "float32 on x's device")
    out = torch.empty((batch, cout, -(-fin // stride), -(-tin // stride)),
                      dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.s3d_res2_block_f32(
        x.data_ptr(), p.p_w1.data_ptr(), p.b1.data_ptr(),
        p.p_wc1.data_ptr(), p.bc1.data_ptr(), p.p_wc2.data_ptr(),
        p.bc2.data_ptr(), p.p_w3.data_ptr(), p.b3.data_ptr(),
        p.p_wsc.data_ptr() if p.p_wsc is not None else None,
        out.data_ptr(), batch, cin, w, cout, fin, tin, stride, stream)
    check(lib, rc, "s3d_res2_block_f32")
    res2_block.launches += 1
    return out


def res2_block(x, p: FoldedRes2Block, stride: int = 1):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.is_cuda:
        return res2_block_cuda(x, p, stride)
    if x.device.type != "cpu":
        raise ValueError(f"res2 block: unsupported device {x.device}")
    return res2_block_plain(x, p, stride)


res2_block.launches = 0
