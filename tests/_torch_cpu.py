"""CPU set-up shared by the port's test files (tests/test_torch_*.py)."""

import torch


def use_two_threads() -> None:
    """Two intra-op threads for each test process, then one parallel
    ``torch.exp`` before any test. On an x86 CPU, PyTorch's ``exp``,
    ``tanh`` and ``log`` run MKL's vector math, whose first parallel call
    in a process can leave one thread's share about 1e-4 off in relative
    terms (about one fresh process in ten with six processes at once on
    eight cores), while every later call agrees with the first correct one
    bit for bit; the tests' 1e-5 and 1e-4 tolerances hold from the second
    call on."""
    torch.set_num_threads(2)
    torch.exp(torch.zeros(1 << 18))
