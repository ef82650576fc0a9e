"""The plain PyTorch reference that decides ``correct``.

Written from the papers, not from the program: it imports neither ``jax``
nor ``dvf_tpu`` nor anything of ``dvf_tpu_torch``, and takes only the
weights and inputs the benchmark made itself.

- ``johnson``: Johnson, Alahi and Fei-Fei (arXiv:1603.08155) transform
  net, NHWC in and out, float32 with TF32 off: reflect padding, instance
  norm, ReLU, residual blocks, nearest ×2 upsample then conv, scaled tanh.
- ``vgg``: the VGG prefix (Simonyan and Zisserman, arXiv:1409.1556), 3×3
  zero-padded convs, ReLU, 2×2 average pool; per-block features.
- ``train``: the perceptual loss (content, relative Gram error, total
  variation) and Adam (optax's defaults), one step at a time.

``prec`` says where the reference rounds (``Precision``): ``F32``, the
reference, rounds nowhere; ``FP8``, the control, computes every conv with
float8 e4m3 operands (per-tensor scale) and stores every activation in
float8, forward and backward, where the program rounds to bf16.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 means float32: TF32 off for matmuls and cuDNN convs inside."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale (amax → 448),
    returned in ``x``'s dtype."""
    amax = x.abs().amax().clamp_min(1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Fp8Conv(torch.autograd.Function):
    """A conv whose every product has float8 operands, forward and
    backward: the input and weight going in, the output gradient coming
    back (float32 accumulation, as float8 tensor cores accumulate)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        xq, wq = _q8(x), _q8(w)
        ctx.save_for_backward(xq, wq)
        ctx.stride, ctx.padding, ctx.has_bias = stride, padding, b is not None
        return F.conv2d(xq, wq, b, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = _q8(gy)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride=ctx.stride,
                                        padding=ctx.padding)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride=ctx.stride,
                                         padding=ctx.padding)
        gb = gy.sum(dim=(0, 2, 3)) if ctx.has_bias else None
        return gx, gw, gb, None, None


def fp8_conv2d(x, w, b=None, stride=1, padding=0):
    """``F.conv2d`` computed in float8 (e4m3) operands: the control."""
    return _Fp8Conv.apply(x, w, b, stride, padding)


class _Fp8Round(torch.autograd.Function):
    """An activation stored in float8 (e4m3): rounded going forward, its
    gradient rounded coming back."""

    @staticmethod
    def forward(ctx, x):
        return _q8(x)

    @staticmethod
    def backward(ctx, g):
        return _q8(g)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Round.apply(x)


class Precision:
    """Where the reference rounds: ``conv2d`` for every conv and ``act`` for
    every activation a layer hands on (a norm's output, a ReLU's, a
    residual sum, the net's output, a pooled feature), where the program
    rounds to its compute dtype. The default is float32 throughout."""

    def __init__(self, conv2d=F.conv2d, act=lambda x: x):
        self.conv2d = conv2d
        self.act = act


F32 = Precision()
FP8 = Precision(conv2d=fp8_conv2d, act=fp8_round)
