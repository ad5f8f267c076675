"""The port's CTC: the DP twins against the JAX package's Pallas DP kernels
(interpret mode on the CPU), and ``ctc_loss`` with its analytic gradient
against ``ops.ctc_loss`` on both JAX backends.

The CUDA kernels are held against these twins on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu import ops as jops
from asr_dfcnn_transformer_tpu.ops import ctc as jctc
from asr_dfcnn_transformer_tpu.ops.pallas import ctc_kernel
from asr_dfcnn_transformer_torch.kernels import (alpha_stack_reference,
                                                 beta_xi_reference, ctc_alpha,
                                                 ctc_beta_xi)
from asr_dfcnn_transformer_torch.ops import ctc as tctc
from asr_dfcnn_transformer_torch.ops import ctc_loss
from tests._torch_cpu import use_two_threads

use_two_threads()

B, T, V, L = 4, 16, 10, 5


def _problem(seed=0):
    """test_pallas_ctc.py's problem, with its last row made unsatisfiable:
    a full label, a repeated label, an empty label at a short logit length,
    and five labels in four frames."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    logit_len = np.array([T, T - 3, L + 2, 4], np.int32)
    labels = rng.integers(0, V - 1, size=(B, L)).astype(np.int32)
    labels[1, :2] = [3, 3]                         # repeated label
    label_len = np.array([L, 2, 0, L], np.int32)   # incl. empty
    return logits, logit_len, labels, label_len


def _jax_dp_inputs(logits, logit_len, labels, label_len):
    """The padded inputs ops/ctc.py hands the Pallas kernels."""
    blank = V - 1
    lp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    ext, valid, can_skip = jctc._extended_labels(
        jnp.asarray(labels), jnp.asarray(label_len), blank)
    emit_all = jctc._emissions(lp, ext)
    _, emit_tbs, valid_p, skip_p, init, s = jctc._prepare_pallas(
        lp, emit_all, jnp.asarray(label_len), valid, can_skip, blank)
    return lp, valid, can_skip, emit_tbs, valid_p, skip_p, init, s


def _torch_dp_inputs(logits, labels, label_len):
    blank = V - 1
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    lab_len = torch.from_numpy(label_len)
    ext, valid, can_skip = tctc._extended_labels(
        torch.from_numpy(labels).long(), lab_len, blank)
    emit = tctc._emissions(lp, ext)
    init = tctc._alpha0(lp, emit, lab_len, valid, blank)
    return emit, init, valid, can_skip


@pytest.mark.parametrize("seed", [0, 3])
def test_alpha_twin_matches_pallas_interpret(seed):
    logits, logit_len, labels, label_len = _problem(seed)
    _, _, _, emit_tbs, valid_p, skip_p, init_p, s = _jax_dp_inputs(
        logits, logit_len, labels, label_len)
    want = np.asarray(ctc_kernel.alpha_stack(
        emit_tbs, init_p, skip_p, valid_p, jnp.asarray(logit_len),
        interpret=True))[:, :, :s]

    # the port prepares the DP's inputs as ops/ctc.py does ...
    emit, init, valid, can_skip = _torch_dp_inputs(logits, labels, label_len)
    for mine, theirs in ((emit, emit_tbs), (init, init_p)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs)[..., :s],
                                   rtol=1e-6, atol=1e-6)
    for mine, theirs in ((valid, valid_p), (can_skip, skip_p)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs)[:, :s])
    # ... and the twin runs the DP on the very same inputs
    emit = torch.from_numpy(np.asarray(emit_tbs)[:, :, :s].copy())
    init = torch.from_numpy(np.asarray(init_p)[:, :s].copy())
    lens = torch.from_numpy(logit_len)
    got = alpha_stack_reference(emit, init, can_skip, valid, lens).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the wrapper takes the twin for CPU tensors
    np.testing.assert_array_equal(
        ctc_alpha(emit, init, can_skip, valid, lens).numpy(), got)


@pytest.mark.parametrize("seed", [0, 3])
def test_beta_xi_twin_matches_pallas_interpret(seed):
    logits, logit_len, labels, label_len = _problem(seed)
    lp, valid_j, can_skip_j, emit_tbs, valid_p, skip_p, init_p, s = \
        _jax_dp_inputs(logits, logit_len, labels, label_len)
    alphas_p = ctc_kernel.alpha_stack(emit_tbs, init_p, skip_p, valid_p,
                                      jnp.asarray(logit_len), interpret=True)
    total = jctc._total_from_alpha(alphas_p[-1, :, :s],
                                   jnp.asarray(label_len),
                                   jnp.asarray(logit_len))
    s_pad = emit_tbs.shape[-1]
    binit = jctc._pad_lane(jctc._beta_init(valid_j, jnp.asarray(label_len)),
                           s_pad, jctc._NEG_INF)
    skip_from = jctc._pad_lane(
        jnp.pad(can_skip_j, ((0, 0), (0, 2)))[:, 2:], s_pad, False)
    want = np.asarray(ctc_kernel.beta_xi(
        emit_tbs, alphas_p, binit, skip_from, valid_p,
        jnp.asarray(logit_len), total, interpret=True))[:, :, :s]

    _, _, valid, can_skip = _torch_dp_inputs(logits, labels, label_len)
    emit = torch.from_numpy(np.asarray(emit_tbs)[:, :, :s].copy())
    lab_len = torch.from_numpy(label_len)
    alphas = torch.from_numpy(np.asarray(alphas_p)[:, :, :s].copy())
    got = beta_xi_reference(
        emit, alphas, tctc._beta_init(valid, lab_len),
        torch.nn.functional.pad(can_skip, (0, 2))[:, 2:], valid,
        torch.from_numpy(logit_len), torch.from_numpy(np.array(total)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.all(got.numpy()[:, 3] == 0.0)       # the unsatisfiable row
    assert np.asarray(total)[3] <= jctc._NEG_INF / 2


def _jax_loss_and_vjp(logits, logit_len, labels, label_len, g, backend,
                      log_probs):
    x = jnp.asarray(logits)
    if log_probs:
        x = jax.nn.log_softmax(x, -1)
    loss, vjp = jax.vjp(
        lambda lg: jops.ctc_loss(lg, jnp.asarray(logit_len),
                                 jnp.asarray(labels), jnp.asarray(label_len),
                                 logits_are_log_probs=log_probs,
                                 backend=backend), x)
    return np.asarray(loss), np.asarray(vjp(jnp.asarray(g))[0])


def _torch_loss_and_grad(logits, logit_len, labels, label_len, g, log_probs):
    x = torch.from_numpy(logits)
    if log_probs:
        x = torch.log_softmax(x, -1)
    x = x.detach().requires_grad_(True)
    loss = ctc_loss(x, torch.from_numpy(logit_len), torch.from_numpy(labels),
                    torch.from_numpy(label_len),
                    logits_are_log_probs=log_probs)
    (grad,) = torch.autograd.grad(loss, x, torch.from_numpy(g))
    return loss.detach().numpy(), grad.numpy()


@pytest.mark.parametrize("log_probs", [False, True])
@pytest.mark.parametrize("backend", ["pallas", "scan"])
def test_ctc_loss_and_grad_match_jax(backend, log_probs):
    logits, logit_len, labels, label_len = _problem(1)
    g = np.array([1.0, 0.5, 2.0, 0.25], np.float32)
    want_loss, want_grad = _jax_loss_and_vjp(
        logits, logit_len, labels, label_len, g, backend, log_probs)
    got_loss, got_grad = _torch_loss_and_grad(
        logits, logit_len, labels, label_len, g, log_probs)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-4, atol=1e-5)
    assert got_loss[3] >= 1e29                     # unsatisfiable
    assert np.all(got_grad[3] == 0.0)


@pytest.mark.parametrize("log_probs", [False, True])
def test_zero_length_logit_row(log_probs):
    """Zero valid frames: log P is 0 for an empty label and -1e30 for any
    other, and such rows get no gradient."""
    logits, logit_len, labels, label_len = _problem(2)
    logit_len = np.array([T, 0, 0, 5], np.int32)
    label_len = np.array([L, 0, 3, 2], np.int32)
    g = np.ones(B, np.float32)
    want_loss, want_grad = _jax_loss_and_vjp(
        logits, logit_len, labels, label_len, g, "pallas", log_probs)
    got_loss, got_grad = _torch_loss_and_grad(
        logits, logit_len, labels, label_len, g, log_probs)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-4, atol=1e-5)
    assert got_loss[1] == 0.0 and got_loss[2] >= 1e29
    assert np.all(got_grad[1:3] == 0.0)


def test_blank_id_and_label_padding():
    """An explicit blank id, and label padding out of the vocabulary, give
    the JAX answer (one-hot semantics: padding reads and gets nothing)."""
    logits, logit_len, labels, label_len = _problem(4)
    labels = labels.copy()
    labels[0, 3:] = -1                      # padding past label_len = 3
    label_len = np.array([3, 2, 0, 1], np.int32)
    labels[labels == 0] = 1                 # blank 0 is never a label
    want = np.asarray(jops.ctc_loss(
        jnp.asarray(logits), jnp.asarray(logit_len), jnp.asarray(labels),
        jnp.asarray(label_len), blank_id=0, backend="scan"))
    got = ctc_loss(torch.from_numpy(logits), torch.from_numpy(logit_len),
                   torch.from_numpy(labels), torch.from_numpy(label_len),
                   blank_id=0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_wrappers_reject_bad_inputs():
    emit = torch.zeros((3, 2, 5))
    row = torch.zeros((2, 5))
    mask = torch.ones((2, 5), dtype=torch.bool)
    lens = torch.full((2,), 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        ctc_alpha(emit.double(), row, mask, mask, lens)
    with pytest.raises(ValueError, match="can_skip"):
        ctc_alpha(emit, row, mask.float(), mask, lens)
    with pytest.raises(ValueError, match="lens"):
        ctc_alpha(emit, row, mask, mask, lens.long())
    with pytest.raises(ValueError, match="log_total"):
        ctc_beta_xi(emit, emit, row, mask, mask, lens, torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        m = emit.to("meta")
        ctc_alpha(m, row.to("meta"), mask.to("meta"), mask.to("meta"),
                  lens.to("meta"))
    with pytest.raises(ValueError, match="labels"):
        ctc_loss(torch.zeros((2, 3, 4)), lens, torch.zeros(2), lens)
