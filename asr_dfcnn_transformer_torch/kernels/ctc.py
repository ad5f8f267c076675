"""``ctc_alpha`` and ``ctc_beta_xi``: the CTC time DPs, each with its twin.

``ctc_alpha`` replaces ``ops/pallas/ctc_kernel.py: alpha_stack`` and
``ctc_beta_xi`` replaces ``beta_xi``; the CUDA source is ``csrc/ctc.cu``.
Both work on the blank-interleaved extended labels that ``ops/ctc.py``
prepares (emissions gathered to [T, B, S], S = 2L + 1, no lane padding).
Each wrapper runs its plain-PyTorch twin (``*_reference``) for CPU tensors,
launches the kernel for CUDA tensors, and raises for anything else.

The recurrence's numerics (``NEG_INF``, ``logaddexp3``) are shared with
``ops/ctc.py`` and the CUDA source, as the JAX package shares them between
its scan and Pallas backends: a change to one must be made to all.

The ``ctc_beta_xi`` kernel stages each step's emission and alpha rows in a
shared-memory ring ahead of its chain; ``beta_xi_plan`` mirrors its launch
and ``beta_ring_schedule`` its slot and phase arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from asr_dfcnn_transformer_torch.kernels import _build

NEG_INF = -1e30
# csrc/ctc.cu's beta_xi constants: steps staged ahead (the ring's slots),
# the chain's threads at most, the producer, watcher and writer warps'
# threads
BETA_RING, BETA_CHAIN_MAX, BETA_HELPERS = 8, 512, 192


def logaddexp3(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b + e^c) that stays NEG_INF when every input is: the
    1e-37 clamp keeps the log finite, the readout pins the dead branch."""
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp_min(m, NEG_INF / 2)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe)
    out = m_safe + torch.log(torch.clamp_min(s, 1e-37))
    return torch.where(m <= NEG_INF / 2, NEG_INF, out)


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[:, s] <- x[:, s - k] (k > 0) or x[:, s + |k|] (k < 0), NEG_INF fill."""
    s = x.shape[1]
    if k > 0:
        return F.pad(x, (k, 0), value=NEG_INF)[:, :s]
    return F.pad(x, (0, -k), value=NEG_INF)[:, -k:]


def alpha_stack_reference(emit: torch.Tensor, init: torch.Tensor,
                          can_skip: torch.Tensor, valid: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of ``ctc_alpha`` (same contract)."""
    t_total = emit.shape[0]
    lens = lens.to(emit.device)[:, None]
    alphas = torch.empty_like(emit, dtype=torch.float32)
    alpha = init.float()
    if t_total:
        alphas[0] = alpha
    for t in range(1, t_total):
        prev2 = torch.where(can_skip, _shift(alpha, 2), NEG_INF)
        new = logaddexp3(alpha, _shift(alpha, 1), prev2) + emit[t]
        new = torch.where(valid, new, NEG_INF)
        alpha = torch.where(t < lens, new, alpha)       # freeze past len
        alphas[t] = alpha
    return alphas


def beta_xi_reference(emit: torch.Tensor, alphas: torch.Tensor,
                      init: torch.Tensor, skip_from: torch.Tensor,
                      valid: torch.Tensor, lens: torch.Tensor,
                      log_total: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of ``ctc_beta_xi`` (same contract)."""
    t_total = emit.shape[0]
    lens = lens.to(emit.device)[:, None]
    log_total = log_total.float()[:, None]
    finite = log_total > NEG_INF / 2
    xi = torch.empty_like(emit, dtype=torch.float32)

    def write_xi(t, beta):
        lg = alphas[t] + beta - log_total
        on = finite & (t < lens) & valid
        xi[t] = torch.where(on, torch.exp(torch.clamp_max(lg, 0.0)), 0.0)

    beta = init.float()
    if t_total:
        write_xi(t_total - 1, beta)
    for t in range(t_total - 2, -1, -1):
        nxt = beta + emit[t + 1]
        n2 = torch.where(skip_from, _shift(nxt, -2), NEG_INF)
        new = logaddexp3(nxt, _shift(nxt, -1), n2)
        new = torch.where(valid, new, NEG_INF)
        beta = torch.where(t < lens - 1, new, init)    # pinned to end states
        write_xi(t, beta)
    return xi


def beta_xi_plan(s: int) -> dict:
    """``ctc_beta_xi``'s launch at S states (``asr_ctc_beta_xi_plan``): the
    ring's slots, states a chain thread, threads a block (the chain's warps,
    then a producer, a watcher and four writer warps) and shared bytes (two
    mbarriers a slot; a slot holds the emission, alpha and beta rows, each
    with room for a row copied from the 16-byte boundary below it)."""
    per = 1 if s <= BETA_CHAIN_MAX else 2
    chain = -(-(-(-s // per)) // 32) * 32
    return {"ring": BETA_RING, "states": per, "threads": chain + BETA_HELPERS,
            "smem": 2 * BETA_RING * 8 + BETA_RING * 3 * ((s + 6) // 4 * 4) * 4}


def beta_ring_schedule(t_total: int, ring: int = BETA_RING) -> list:
    """The kernel's ring arithmetic for T steps, step k being frame t = T -
    1 - k: step k lives in slot k % ring and its ``full`` mbarrier's
    (k // ring)-th phase, parity (k // ring) & 1, says its rows landed; the
    producer fills the slot once the ``empty`` phase of step k - ring, which
    the watcher completes after step k - ring + 1, has completed. Returns
    per step: the slot, the ``full`` parity, the ``empty`` parity the
    producer waits on (None for the first ``ring`` steps), the emission
    frame copied there (None at k = 0), the alpha frame, the slot of the
    beta row the chain reads (step k - 1's; None at k = 0) and the step
    after whose barrier the watcher frees the slot (None for the last
    step, whose slot is never freed)."""
    steps = []
    for k in range(t_total):
        t = t_total - 1 - k
        steps.append({
            "slot": k % ring, "parity": (k // ring) & 1,
            "empty_parity": None if k < ring else ((k - ring) // ring) & 1,
            "emit_frame": t + 1 if k else None, "alpha_frame": t,
            "prev_slot": (k - 1) % ring if k else None,
            "freed_after": k + 1 if k + 1 < t_total else None})
    return steps


def _check(name: str, emit: torch.Tensor, rows: dict, lens: torch.Tensor,
           extra: Optional[dict] = None) -> None:
    if emit.dim() != 3 or emit.dtype != torch.float32:
        raise ValueError(f"{name}: emit must be [T, B, S] float32, got "
                         f"{tuple(emit.shape)} {emit.dtype}")
    _, b, s = emit.shape
    for key, (t, dtype) in rows.items():
        if t.shape != (b, s) or t.dtype != dtype:
            raise ValueError(f"{name}: {key} must be [B, S] {dtype}")
    if lens.shape != (b,) or lens.dtype != torch.int32:
        raise ValueError(f"{name}: lens must be [B] int32")
    for key, (t, shape, dtype) in (extra or {}).items():
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {list(shape)} {dtype}")


def _max_states(name: str, s: int) -> None:
    limit = _build.library().asr_ctc_max_states()
    if s > limit:
        raise ValueError(f"{name}: S = {s} extended-label states, above the "
                         f"{limit} one block takes")


def ctc_alpha(emit: torch.Tensor, init: torch.Tensor, can_skip: torch.Tensor,
              valid: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The whole CTC forward DP: every alpha_t.

    emit [T, B, S] f32 extended-label emission log-probs; init [B, S] f32
    the alpha_0 row; can_skip [B, S] bool (a skip INTO state s is allowed);
    valid [B, S] bool; lens [B] int32 valid frames. Returns alphas
    [T, B, S] f32, each row frozen from its ``lens`` on.
    """
    _check("ctc_alpha", emit, {"init": (init, torch.float32),
                               "can_skip": (can_skip, torch.bool),
                               "valid": (valid, torch.bool)}, lens)
    tensors = (emit, init, can_skip, valid, lens)
    if all(t.device.type == "cpu" for t in tensors):
        return alpha_stack_reference(emit, init, can_skip, valid, lens)
    dev = _build.require_cuda("ctc_alpha", *tensors)
    t, b, s = emit.shape
    out = torch.empty_like(emit)
    if out.numel() == 0:
        return out
    _max_states("ctc_alpha", s)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.asr_ctc_alpha(emit.data_ptr(), init.data_ptr(),
                               can_skip.data_ptr(), valid.data_ptr(),
                               lens.data_ptr(), out.data_ptr(), t, b, s,
                               _build.stream_ptr(dev))
    _build.check("ctc_alpha", rc)
    return out


def ctc_beta_xi(emit: torch.Tensor, alphas: torch.Tensor, init: torch.Tensor,
                skip_from: torch.Tensor, valid: torch.Tensor,
                lens: torch.Tensor, log_total: torch.Tensor) -> torch.Tensor:
    """The reverse CTC DP fused with the posteriors.

    emit / alphas [T, B, S] f32; init [B, S] f32 the end-state beta row;
    skip_from [B, S] bool (the s -> s + 2 transition is allowed); valid
    [B, S] bool; lens [B] int32; log_total [B] f32 log P(labels), -1e30 for
    an unsatisfiable alignment. Returns xi [T, B, S] f32 = exp(min(alpha +
    beta - logP, 0)) on valid frames and states of a finite logP, else 0.
    """
    _check("ctc_beta_xi", emit, {"init": (init, torch.float32),
                                 "skip_from": (skip_from, torch.bool),
                                 "valid": (valid, torch.bool)}, lens,
           {"alphas": (alphas, emit.shape, torch.float32),
            "log_total": (log_total, (emit.shape[1],), torch.float32)})
    tensors = (emit, alphas, init, skip_from, valid, lens, log_total)
    if all(t.device.type == "cpu" for t in tensors):
        return beta_xi_reference(emit, alphas, init, skip_from, valid, lens,
                                 log_total)
    dev = _build.require_cuda("ctc_beta_xi", *tensors)
    t, b, s = emit.shape
    out = torch.empty_like(emit)
    if out.numel() == 0:
        return out
    _max_states("ctc_beta_xi", s)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.asr_ctc_beta_xi(emit.data_ptr(), alphas.data_ptr(),
                                 init.data_ptr(), skip_from.data_ptr(),
                                 valid.data_ptr(), lens.data_ptr(),
                                 log_total.data_ptr(), out.data_ptr(), t, b,
                                 s, _build.stream_ptr(dev))
    _build.check("ctc_beta_xi", rc)
    return out
