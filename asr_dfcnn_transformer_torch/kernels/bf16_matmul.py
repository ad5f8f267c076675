"""The bf16 logits head's product as a custom op, ``asr_port::bf16_matmul``.

Not a kernel of this package: on the card it is one cuBLAS product with
bf16 operands and an f32 output (``torch.mm(..., out_dtype=float32)``), on
the CPU an f32 product of the bf16 operands (a product of two bf16 values
is exact in f32). As one op with a CPU and a CUDA implementation, a
program that ``torch.export`` traces through it holds the op and not the
route of the device it was traced on, so a serving artifact exported on
the CPU runs cuBLAS's product on the card. It counts no launch.
"""

from __future__ import annotations

import torch

from asr_dfcnn_transformer_torch.kernels import _build


def _bf16_matmul_cpu(xb: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """xb [N, K] and wb [M, K], both bf16 -> xb wb^T [N, M] f32."""
    return xb.float() @ wb.float().t()


def _bf16_matmul_cuda(xb: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    return torch.mm(xb, wb.t(), out_dtype=torch.float32)


def _bf16_matmul_fake(xb, wb):
    return xb.new_empty((xb.shape[0], wb.shape[0]), dtype=torch.float32)


bf16_matmul = _build.define_op("bf16_matmul", _bf16_matmul_cpu,
                               _bf16_matmul_cuda, _bf16_matmul_fake)
