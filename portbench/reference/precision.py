"""The arithmetic of the plain reference: f32, or the control's fp8.

Every product of the reference (convolutions, dense layers, the attention's
two products) goes through one ``Precision``. ``F32`` computes in float32
with TF32 off. ``FP8`` is the control: each operand of each product is
rounded to float8 e4m3 after a per-tensor scale that maps its largest
magnitude to 448 (the format's largest finite value), and in training each
product's incoming gradient to e5m2 (largest 57344) the same way, so that
the backward's products take fp8 operands too; the products accumulate in
float32. Normalisations, softmax and the loss stay float32 in both.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


class Precision:
    """float32 products; subclasses round the operands first."""

    name = "f32"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t.float()

    def linear(self, x, w, b=None):
        y = F.linear(self.operand(x), self.operand(w))
        return y if b is None else y + b.float()

    def conv(self, x, w, b):
        return F.conv2d(self.operand(x), self.operand(w), b.float(),
                        padding=w.shape[-1] // 2)

    def matmul(self, a, b):
        return torch.matmul(self.operand(a), self.operand(b))


def _fp8(t: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under the scale that maps its largest
    magnitude to ``fmax``."""
    t = t.float()
    amax = t.abs().max()
    scale = torch.where(amax > 0, fmax / amax, torch.ones_like(amax))
    return (t * scale).to(dtype).float() / scale


class _Operand(torch.autograd.Function):
    """Forward: the operand in e4m3. Backward: the gradient as it comes."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradOperand(torch.autograd.Function):
    """Forward: the product as it is. Backward: the incoming gradient, the
    operand of the backward's products, in e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


class FP8(Precision):
    """The control: e4m3 operands under a per-tensor scale, and in training
    the products' incoming gradients in e5m2, the usual fp8 recipe."""

    name = "fp8"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(t.float())

    def linear(self, x, w, b=None):
        y = _GradOperand.apply(F.linear(self.operand(x), self.operand(w)))
        return y if b is None else y + b.float()

    def conv(self, x, w, b):
        return _GradOperand.apply(F.conv2d(
            self.operand(x), self.operand(w), padding=w.shape[-1] // 2)) + \
            b.float()[None, :, None, None]

    def matmul(self, a, b):
        return _GradOperand.apply(torch.matmul(self.operand(a),
                                               self.operand(b)))


F32 = Precision()
CONTROL = FP8()
