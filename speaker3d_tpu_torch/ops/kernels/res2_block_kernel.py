"""One BN-folded, inference-only Res2 block: the Hopper kernel and its plain
version.

The counterpart of ``speaker3d_tpu/ops/pallas/res2_block_kernel.py``. A
scale-2 ERes2NetV2 block without AFF, every BatchNorm folded into its conv:
1x1 expand + Hardtanh(0, 20), split into halves of width w, 3x3 conv on the
first half, add to the second half, 3x3 conv, concat, 1x1 project plus the
shortcut (1x1 conv + BN, or identity), Hardtanh(0, 20). The CUDA kernel
(``csrc/res2_block.cu``) takes NCHW activations, reads the even rows and
columns itself when the stride is 2, and comes in the two dtypes the TPU
kernel serves:

- float32: every contraction on the tensor cores in 3xTF32 (fp32-level
  error) with weights that the fold splits and packs into fragment order
  once (``ops/kernels/tf32.py``);
- bfloat16 (the TPU kernel's default serving dtype): bf16 weights and
  activations, ``mma.sync.m16n8k16`` BF16 products accumulated in fp32,
  fp32 biases, and bf16 rounding where the TPU kernel rounds: h, y1, u =
  s2 + y1, y2 and the output (``res2_block_plain`` does the same on the
  CPU).

``res2_block`` calls the registered operator ``s3d::res2_block``
(``SCHEMA``): its CPU implementation is the plain version, its CUDA one
launches the kernel, and its fake one gives the output's shape, so eager
calls, ``torch.export`` programs and AOTInductor packages all reach the
same kernel (the native runtime registers the same schema in C++,
``runtime/src/res2_op.cpp``). ``res2_block.launches`` counts the float32
launches and ``res2_block.launches_bf16`` the bfloat16 ones.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from speaker3d_tpu_torch.kernels.build import check, library
from speaker3d_tpu_torch.models.common import relu20
from speaker3d_tpu_torch.ops.kernels.tf32 import pack_b, round8

DTYPES = (torch.float32, torch.bfloat16)  # the dtypes of x the block takes


def round16(n: int) -> int:
    return -(-n // 16) * 16


def pack_b_bf16(kmat: torch.Tensor) -> torch.Tensor:
    """A K-major weight [K, N] as bf16 ``mma.m16n8k16`` B fragments:
    [Kp/16, Np/8, 32, 4] bf16 with K zero-padded to a multiple of 16 and N
    to one of 8 and, for k-step ks, n-tile nt and lane 4g + t, (W[k, n],
    W[k + 1, n], W[k + 8, n], W[k + 9, n]) with k = 16 ks + 2t and n = 8 nt
    + g: two registers of two consecutive k, the lower in the low half."""
    k, n = kmat.shape
    m = kmat.new_zeros((round16(k), round8(n)), dtype=torch.bfloat16)
    m[:k, :n] = kmat
    # [ks, h, t, e, nt, g] with k = 16 ks + 8 h + 2 t + e -> [ks, nt, g, t, h, e]
    return m.view(m.shape[0] // 16, 2, 4, 2, m.shape[1] // 8, 8).permute(
        0, 4, 5, 2, 1, 3).reshape(m.shape[0] // 16, m.shape[1] // 8, 32,
                                  4).contiguous()


@dataclass(frozen=True)
class FoldedRes2Block:
    """BN-folded weights of one scale-2 block in one dtype (float32 or
    bfloat16; the biases are float32 in both): OIHW for the plain version,
    packed B fragments for the kernel (3xTF32 ``pack_b`` in float32,
    ``pack_b_bf16`` in bfloat16)."""

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

    @property
    def dtype(self) -> torch.dtype:
        return self.w1.dtype


def fold_res2_block(sd: Mapping[str, torch.Tensor], eps: float = 1e-5,
                    dtype: torch.dtype = torch.float32) -> FoldedRes2Block:
    """Fold BatchNorm (running statistics) into the preceding convs, and
    pack the kernel's weights.

    ``sd`` maps the block's state_dict names (``conv1.weight``,
    ``bn1.running_var``, ``convs.0.weight``, ``shortcut.1.bias``, ...) to
    tensors; the fold runs in float32 on their device, from their values
    up-cast (a bf16 model's bf16 parameters and statistics, as the JAX
    fold up-casts bf16-cast variables). The weights are then cast to
    ``dtype`` (float32 or bfloat16) and the biases stay float32, as the
    TPU kernel's fold and wrapper keep them."""
    if dtype not in DTYPES:
        raise ValueError(f"res2 fold: dtype must be one of {DTYPES}, "
                         f"got {dtype}")

    def fold(conv, bn):
        k = sd[f"{conv}.weight"].detach().float()
        g = sd[f"{bn}.weight"].detach().float() / torch.sqrt(
            sd[f"{bn}.running_var"].detach().float() + eps)
        b = sd[f"{bn}.bias"].detach().float() - sd[f"{bn}.running_mean"].detach().float() * g
        return (k * g[:, None, None, None]).contiguous(), b.contiguous()

    def kmajor(k):  # OIHW -> [(kh*KW + kw)*I + i, O]
        o, i, kh, kw = k.shape
        return k.permute(2, 3, 1, 0).reshape(kh * kw * i, o)

    pack = pack_b if dtype == torch.float32 else pack_b_bf16
    w1, b1 = fold("conv1", "bn1")
    wc1, bc1 = fold("convs.0", "bns.0")
    wc2, bc2 = fold("convs.1", "bns.1")
    w3, b3 = fold("conv3", "bn3")
    w1, wc1, wc2, w3 = (k.to(dtype) for k in (w1, wc1, wc2, w3))
    wsc = p_wsc = None
    if "shortcut.0.weight" in sd:
        wsc, bsc = fold("shortcut.0", "shortcut.1")
        wsc = wsc.to(dtype)
        p_wsc = pack(kmajor(wsc))
        b3 = (b3 + bsc).contiguous()
    return FoldedRes2Block(w1, b1, wc1, bc1, wc2, bc2, w3, b3, wsc,
                           pack(kmajor(w1)), pack(kmajor(wc1)),
                           pack(kmajor(wc2)), pack(kmajor(w3)), p_wsc)


def _res2_block_plain_bf16(x, p: FoldedRes2Block, stride: int):
    """The bf16 block as the TPU kernel computes it on a bf16 x: each
    product in float32 on the bf16 values plus the fp32 bias, rounded to
    bf16 at h, y1, y2 and the output; u = s2 + y1 a bf16 sum; the identity
    shortcut adds x up-cast."""
    w, f32, bf16 = p.width, torch.float32, torch.bfloat16
    conv = lambda a, k, b=None, **kw: F.conv2d(a.to(f32), k.to(f32), b, **kw)
    h = relu20(conv(x, p.w1, p.b1, stride=stride)).to(bf16)
    y1 = relu20(conv(h[:, :w], p.wc1, p.bc1, padding=1)).to(bf16)
    u = h[:, w:] + y1
    y2 = relu20(conv(u, p.wc2, p.bc2, padding=1)).to(bf16)
    out = conv(torch.cat([y1, y2], dim=1), p.w3, p.b3)
    res = x.to(f32) if p.wsc is None else conv(x, p.wsc, stride=stride)
    return relu20(out + res).to(bf16)


def res2_block_plain(x, p: FoldedRes2Block, stride: int = 1):
    """x [B, Cin, F, T] -> [B, Cout, F', T'] with F.conv2d on the folded
    weights, in x's dtype (``p``'s)."""
    if x.dtype != p.dtype:
        raise ValueError(f"res2 block: x is {x.dtype}, the fold {p.dtype}")
    if x.dtype == torch.bfloat16:
        return _res2_block_plain_bf16(x, p, stride)
    w = p.width
    h = relu20(F.conv2d(x, p.w1, p.b1, stride=stride))
    y1 = relu20(F.conv2d(h[:, :w], p.wc1, p.bc1, padding=1))
    y2 = relu20(F.conv2d(h[:, w:] + y1, p.wc2, p.bc2, padding=1))
    out = F.conv2d(torch.cat([y1, y2], dim=1), p.w3, p.b3)
    res = x if p.wsc is None else F.conv2d(x, p.wsc, stride=stride)
    return relu20(out + res)


_ENTRY = {torch.float32: "s3d_res2_block_f32",
          torch.bfloat16: "s3d_res2_block_bf16"}


def _lib():
    lib = library("res2_block")
    if not getattr(lib, "_s3d_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in _ENTRY.values():
            getattr(lib, name).restype = i
            getattr(lib, name).argtypes = [p] * 11 + [i] * 7 + [p]
        lib._s3d_bound = True
    return lib


def res2_block_cuda(x, p: FoldedRes2Block, stride: int = 1):
    """Launch csrc/res2_block.cu on x's CUDA device, the instantiation of
    x's dtype (float32 or bfloat16, which must be the fold's). The launch
    picks the output tile; a shape that no tile takes (w > 64, Cout > 256)
    returns ``cudaErrorInvalidValue``, raised here."""
    if not x.is_cuda or x.ndim != 4:
        raise ValueError("res2 kernel: x must be a [B, C, F, T] CUDA tensor")
    if x.dtype not in DTYPES:
        raise ValueError(f"res2 kernel: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if p.dtype != x.dtype:
        raise ValueError(f"res2 kernel: x is {x.dtype}, the fold {p.dtype}")
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
    ks = 8 if x.dtype == torch.float32 else 16  # K per mma k-step
    for name, (k, n) in want.items():
        if getattr(p, name).shape != (-(-k // ks), round8(n) // 8, 32, 4):
            raise ValueError(f"res2 kernel: {name} is not packed for "
                             f"K = {k}, N = {n}")
    packed = [getattr(p, name) for name in want]
    for t in packed + [p.b1, p.bc1, p.bc2, p.b3]:
        want_dtype = x.dtype if t.ndim == 4 else torch.float32
        if t.device != x.device or t.dtype != want_dtype or not t.is_contiguous():
            raise ValueError("res2 kernel: folded weights must be contiguous "
                             f"{x.dtype} (biases float32) on x's device")
    out = torch.empty((batch, cout, -(-fin // stride), -(-tin // stride)),
                      dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    entry = _ENTRY[x.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, entry)(
        x.data_ptr(), p.p_w1.data_ptr(), p.b1.data_ptr(),
        p.p_wc1.data_ptr(), p.bc1.data_ptr(), p.p_wc2.data_ptr(),
        p.bc2.data_ptr(), p.p_w3.data_ptr(), p.b3.data_ptr(),
        p.p_wsc.data_ptr() if p.p_wsc is not None else None,
        out.data_ptr(), batch, cin, w, cout, fin, tin, stride, stream)
    check(lib, rc, entry)
    if x.dtype == torch.float32:
        res2_block.launches += 1
    else:
        res2_block.launches_bf16 += 1
    return out


# The operator's schema: x, the fields of FoldedRes2Block in their order,
# the stride. runtime/src/res2_op.cpp registers the same string.
SCHEMA = ("res2_block(Tensor x, Tensor w1, Tensor b1, Tensor wc1, Tensor bc1, "
          "Tensor wc2, Tensor bc2, Tensor w3, Tensor b3, Tensor? wsc, "
          "Tensor p_w1, Tensor p_wc1, Tensor p_wc2, Tensor p_w3, "
          "Tensor? p_wsc, int stride) -> Tensor")
FIELDS = tuple(f.name for f in fields(FoldedRes2Block))

_LIB = torch.library.Library("s3d", "DEF")
_LIB.define(SCHEMA)


def _op_cpu(x, *args):
    return res2_block_plain(x, FoldedRes2Block(*args[:-1]), args[-1])


def _op_cuda(x, *args):
    return res2_block_cuda(x, FoldedRes2Block(*args[:-1]), args[-1])


def _op_fake(x, *args):
    stride, w3 = args[-1], args[FIELDS.index("w3")]
    batch, _, fin, tin = x.shape
    return x.new_empty((batch, w3.shape[0], (fin + stride - 1) // stride,
                        (tin + stride - 1) // stride))


_LIB.impl("res2_block", _op_cpu, "CPU")
_LIB.impl("res2_block", _op_cuda, "CUDA")
torch.library.register_fake("s3d::res2_block", _op_fake, lib=_LIB)


def res2_block(x, p: FoldedRes2Block, stride: int = 1):
    """``s3d::res2_block``: the kernel on a CUDA tensor, the plain version
    on a CPU tensor; x float32 or bfloat16, the fold's dtype."""
    if x.dtype not in DTYPES:
        raise ValueError(f"res2 block: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.dtype != p.dtype:
        raise ValueError(f"res2 block: x is {x.dtype}, the fold {p.dtype}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"res2 block: unsupported device {x.device}")
    return torch.ops.s3d.res2_block(
        x, *(getattr(p, name) for name in FIELDS), stride)


res2_block.launches = 0       # float32 launches
res2_block.launches_bf16 = 0  # bfloat16 launches
