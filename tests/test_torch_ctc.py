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


class _Barrier:
    """An mbarrier of one expected arrival: its count of completed phases.
    A wait on parity p passes while the current (open) phase's parity is
    not p, as ``mbarrier.try_wait.parity`` does."""

    def __init__(self):
        self.done = 0

    def passes(self, parity, phase):
        ok = (self.done & 1) != parity
        # the wait means phase `phase`; it must never see a later one
        assert not ok or self.done == phase + 1, (self.done, phase)
        return ok


def _run_ring(t_total, ring, seed):
    """The ``ctc_beta_xi`` kernel's roles on ``beta_ring_schedule``'s
    arithmetic, interleaved at random: the producer fills step k's slot
    once the ``empty`` phase of step k - ring has passed, the watcher waits
    on step k + 1's ``full`` before barrier k and frees step k - 1's slot
    after it, the chain reads step k's emissions and step k - 1's beta
    after barrier k - 1 and writes beta before barrier k, the writers read
    step k's alpha and beta after barrier k. Returns the frames each read
    saw."""
    from asr_dfcnn_transformer_torch.kernels import ctc as kctc
    steps = kctc.beta_ring_schedule(t_total, ring)
    full = [_Barrier() for _ in range(ring)]
    empty = [_Barrier() for _ in range(ring)]
    emit = [None] * ring            # frame held by each slot's sections
    alpha = [None] * ring
    beta = [None] * ring            # the step whose beta the slot holds
    seen = {"emit": [], "alpha": [], "prev": [], "beta": []}
    arrived = {}                    # barrier k -> roles arrived

    def wait(bar, parity, phase):
        while not bar.passes(parity, phase):
            yield

    def barrier(k, role):
        arrived.setdefault(k, set()).add(role)
        while len(arrived[k]) < 3:
            yield

    def producer():
        for k, st in enumerate(steps):
            i = st["slot"]
            if st["empty_parity"] is not None:
                yield from wait(empty[i], st["empty_parity"], k // ring - 1)
            yield
            emit[i], alpha[i] = st["emit_frame"], st["alpha_frame"]
            full[i].done += 1

    def watcher():
        yield from wait(full[0], steps[0]["parity"], 0)
        if t_total > 1:
            yield from wait(full[1 % ring], steps[1]["parity"], 1 // ring)
        yield from barrier(0, "watcher")
        for k in range(1, t_total):
            if k + 1 < t_total:
                st = steps[k + 1]
                yield from wait(full[st["slot"]], st["parity"],
                                (k + 1) // ring)
            yield from barrier(k, "watcher")
            done = steps[k - 1]
            assert done["freed_after"] == k
            empty[done["slot"]].done += 1

    def chain():
        beta[0] = 0
        yield from barrier(0, "chain")
        for k in range(1, t_total):
            st = steps[k]
            seen["emit"].append((k, emit[st["slot"]]))
            seen["prev"].append((k, beta[st["prev_slot"]]))
            yield
            beta[st["slot"]] = k
            yield from barrier(k, "chain")

    def writers():
        for k, st in enumerate(steps):
            yield from barrier(k, "writers")
            yield
            seen["alpha"].append((k, alpha[st["slot"]]))
            seen["beta"].append((k, beta[st["slot"]]))

    rng = np.random.default_rng(seed)
    roles = [producer(), watcher(), chain(), writers()]
    while roles:
        role = roles[rng.integers(len(roles))]
        try:
            next(role)
        except StopIteration:
            roles.remove(role)
    return seen


@pytest.mark.parametrize("t_total", [1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 200])
def test_beta_ring_reads_frame_t_plus_1(t_total):
    """``beta_ring_schedule``'s slot and phase arithmetic (ring of 8): under
    random interleavings of the kernel's four roles, every wait on a parity
    means the phase it should, step k's chain reads frame t + 1's emissions
    and step k - 1's beta, and its writers frame t's alpha and step k's
    beta, for T below, at and past the ring's multiples and T = 1."""
    for seed in range(4):
        seen = _run_ring(t_total, 8, seed)
        assert seen["emit"] == [(k, t_total - k) for k in range(1, t_total)]
        assert seen["prev"] == [(k, k - 1) for k in range(1, t_total)]
        assert seen["alpha"] == [(k, t_total - 1 - k)
                                 for k in range(t_total)]
        assert seen["beta"] == [(k, k) for k in range(t_total)]


@pytest.mark.parametrize("s", [1, 5, 129, 512, 513, 1023, 1024])
def test_beta_xi_plan(s):
    """``beta_xi_plan``, the mirror of the launcher: one state a chain
    thread up to 512 states, two above, the chain a warp multiple, the
    producer, watcher and writer warps after it, at most 1024 threads, and
    the ring's shared memory within the card's 232,448 bytes."""
    from asr_dfcnn_transformer_torch.kernels import ctc as kctc
    p = kctc.beta_xi_plan(s)
    chain = p["threads"] - kctc.BETA_HELPERS
    assert p["states"] == (1 if s <= 512 else 2)
    assert chain % 32 == 0 and chain * p["states"] >= s
    assert chain - 32 < -(-s // p["states"]) <= chain
    assert p["threads"] <= 1024 and p["smem"] <= 232448


def test_work_counts_only_the_cells_the_output_needs():
    """``bounds.ctc_alpha_work`` and ``ctc_beta_xi_work`` count emissions of
    frames 1 .. len - 1 (and, for xi, alphas of frames 0 .. len - 1) at
    valid states of utterances whose log P is finite: every other cell may
    hold any log-probability without changing the twins' outputs."""
    from asr_dfcnn_transformer_torch import bounds
    from asr_dfcnn_transformer_torch.check_inputs import (ctc_dp_inputs,
                                                          ctc_problem)
    from asr_dfcnn_transformer_torch.kernels import ctc as kctc
    rng = np.random.default_rng(5)
    d = ctc_dp_inputs(*ctc_problem(rng, b=5, t=14, lmax=5, v=9),
                      torch.device("cpu"))
    emit, alphas, init, can_skip, valid, lens, total = (
        d[k] for k in ("emit", "alphas", "init", "can_skip", "valid", "lens",
                       "total"))
    xi = kctc.beta_xi_reference(*d["xi_args"])
    frame = torch.arange(emit.shape[0])[:, None, None]
    cells = valid[None] & (frame < lens[None, :, None].long())
    e_need = cells & (frame >= 1)
    finite = (total > kctc.NEG_INF / 2)[None, :, None]
    other = -20 * torch.rand(emit.shape)
    a_emit = torch.where(e_need, emit, other)
    assert torch.equal(kctc.alpha_stack_reference(a_emit, init, can_skip,
                                                  valid, lens), alphas)
    args = list(d["xi_args"])
    args[0] = torch.where(e_need & finite, emit, other)
    args[1] = torch.where(cells & finite, alphas, other)
    assert torch.equal(kctc.beta_xi_reference(*args), xi)
    rest = bounds.nbytes(init, can_skip, valid, lens, alphas)
    assert bounds.ctc_alpha_work(emit, init, can_skip, valid, lens,
                                 alphas) == (
        4 * int(e_need.sum()) + rest, {"f32": 14 * int(e_need.sum())})
    e_cells = int((e_need & finite).sum())
    a_cells = int((cells & finite).sum())
    rest = bounds.nbytes(*d["xi_args"][2:], xi)
    assert bounds.ctc_beta_xi_work(*d["xi_args"], xi) == (
        4 * (e_cells + a_cells) + rest, {"f32": 20 * a_cells})


@pytest.mark.parametrize("t,b,s", [(1, 3, 129), (2, 3, 129), (12, 3, 1),
                                   (9, 3, 32), (9, 3, 33), (9, 3, 64),
                                   (9, 4, 65), (9, 3, 160), (9, 3, 161),
                                   (5, 1, 129)])
def test_alpha_twin_matches_pallas_interpret_at_edges(t, b, s):
    """The twin, and the wrapper on CPU tensors, against ``alpha_stack`` in
    interpret mode on ``check_inputs.alpha_inputs`` at the card's edge
    shapes cut to a few frames: T 1 and 2, S 1 and at and one past the warp
    multiples 32, 64 and 160, B 1,
    ragged valid states and lengths of 0 and past T. The Pallas kernel
    takes S padded to 128 lanes with invalid states, which no lower state
    reads."""
    from asr_dfcnn_transformer_torch.check_inputs import alpha_inputs
    emit, init, can_skip, valid, lens = alpha_inputs(
        np.random.default_rng(t * 1000 + s), t, b, s)
    pad = (-s) % 128
    f32 = lambda m: np.pad(m.astype(np.float32),
                           [(0, 0)] * (m.ndim - 1) + [(0, pad)])
    want = np.asarray(ctc_kernel.alpha_stack(
        f32(emit), np.pad(init, ((0, 0), (0, pad)),
                          constant_values=np.float32(-1e30)),
        f32(can_skip), f32(valid), jnp.asarray(lens),
        interpret=True))[:, :, :s]
    args = [torch.from_numpy(a) for a in (emit, init, can_skip, valid, lens)]
    got = alpha_stack_reference(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ctc_alpha(*args).numpy(), got)
