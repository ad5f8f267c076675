"""The kernels' forwards as ``torch.library`` custom ops (``kernels.OPS``):
``torch.library.opcheck`` on the CPU, where each op runs its kernel's twin;
each fake's output shapes and types against the twin's; and a one-op module
through ``torch.export`` and ``torch.export.save`` / ``load`` with the same
outputs. (The CUDA implementations launch the kernels: chip_smoke.py holds
them to the twins on the card.)"""

import io
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from asr_dfcnn_transformer_torch import kernels
from asr_dfcnn_transformer_torch.kernels.topk import topk_last_reference
from tests._torch_cpu import use_two_threads

use_two_threads()


def _cases():
    """op name -> (tensor args, other args), small CPU inputs."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    lp = torch.log_softmax(randn(2, 4, 6), dim=-1)
    top_lp, top_ids = topk_last_reference(lp, 3)
    return {
        "log_mel": ((0.3 * randn(2, 1000),
                     torch.tensor([1000, 700], dtype=torch.int32)),
                    (4, 8, 0.97, 16000, 0.0, None)),
        "cmvn": ((randn(2, 5, 6), torch.tensor([5, 3], dtype=torch.int32)),
                 ()),
        "masked_attention": ((randn(1, 2, 4, 8), randn(1, 2, 4, 8),
                              randn(1, 2, 4, 8),
                              torch.tensor([[True, True, True, False]])),
                             (None, 1.0, True)),
        "topk_last": ((randn(2, 3, 10),), (3,)),
        "beam_search": ((lp, top_lp, top_ids,
                         torch.tensor([4, 2], dtype=torch.int32)),
                        (3, 3, 5, 4)),
        "dual_axis_attention": ((randn(3, 5, 8), randn(3, 5, 8),
                                 randn(3, 5, 8)), ()),
        "fused_ffn": ((randn(4, 16), randn(32, 16), randn(32),
                       randn(16, 32), randn(16)), ()),
    }


def _op(name):
    return getattr(torch.ops.asr_port, name).default


def _flat(out):
    return out if isinstance(out, (tuple, list)) else (out,)


@pytest.mark.parametrize("name", kernels.OPS)
def test_opcheck(name):
    tensors, rest = _cases()[name]
    torch.library.opcheck(_op(name), (*tensors, *rest))


@pytest.mark.parametrize("name", kernels.OPS)
def test_fake_matches_twin(name):
    """The fake's outputs have the twin's shapes and types (the kernels
    write those same outputs; chip_smoke.py compares them there)."""
    tensors, rest = _cases()[name]
    real = _flat(_op(name)(*tensors, *rest))
    with FakeTensorMode() as mode:
        fakes = [mode.from_tensor(t) for t in tensors]
        fake = _flat(_op(name)(*fakes, *rest))
    assert len(fake) == len(real)
    for f, r in zip(fake, real):
        assert f.shape == r.shape and f.dtype == r.dtype
        assert f.device == r.device


class _OneOp(torch.nn.Module):
    def __init__(self, name, rest):
        super().__init__()
        self.name, self.rest = name, rest

    def forward(self, *tensors):
        return _op(self.name)(*tensors, *self.rest)


@pytest.mark.parametrize("name", kernels.OPS)
def test_export_save_load_roundtrip(name):
    tensors, rest = _cases()[name]
    mod = _OneOp(name, rest)
    ep = torch.export.export(mod, tensors, strict=False)
    assert any(n.target == _op(name) for n in ep.graph.nodes)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    loaded = torch.export.load(buf).module()
    for got, want in zip(_flat(loaded(*tensors)), _flat(mod(*tensors))):
        assert torch.equal(got, want)


def test_ops_refuse_other_devices():
    """A tensor on neither the CPU nor CUDA is refused by the wrapper; the
    op itself has no implementation there."""
    x = torch.empty((2, 10), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.topk_last(x, 2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.cmvn(torch.empty((1, 2, 3), device="meta"),
                     torch.empty((1,), dtype=torch.int32, device="meta"))


def test_training_forward_goes_through_the_op(monkeypatch):
    """With a backward to record, the autograd Functions call the same op
    for their forward; without one the wrappers call it directly."""
    from asr_dfcnn_transformer_torch.kernels import attention
    calls = []
    real = attention._masked_attention_op

    def spy(*a):
        calls.append(a[0].requires_grad)
        return real(*a)

    monkeypatch.setattr(attention, "_masked_attention_op", spy)
    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    attention.masked_attention(q, q, q, causal=True).sum().backward()
    with torch.no_grad():
        attention.masked_attention(q, q, q)
    assert len(calls) == 2 and q.grad is not None


def test_op_call_imports_no_dynamo():
    """An op's first call loads no ``torch._dynamo`` (``torch.library``'s
    ``custom_op`` would, at the first request of a serving process)."""
    code = ("import sys, torch\n"
            "from asr_dfcnn_transformer_torch import kernels\n"
            "x = torch.randn(2, 3, 16)\n"
            "kernels.topk_last(x, 4)\n"
            "kernels.cmvn(x, torch.tensor([3, 1], dtype=torch.int32))\n"
            "print('torch._dynamo' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"
