"""The port's masked-attention twins against the JAX masked_flash_attention
(Pallas, interpret mode on the CPU) and the einsum path's attention_mask:
the forward with and without dropout, and the VJP through the port's
``MaskedAttention`` autograd Function.

The CUDA kernels are held against these twins on the card by chip_smoke.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.models.layers import (
    attention_mask as jax_attention_mask,
)
from asr_dfcnn_transformer_tpu.ops.pallas.attn_kernel import (
    masked_flash_attention,
)
from asr_dfcnn_transformer_torch.kernels import (MaskedAttention, cmvn,
                                                 log_mel, masked_attention)
from asr_dfcnn_transformer_torch.models.layers import attention_mask
from tests._torch_cpu import use_two_threads

use_two_threads()

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, b, h, tq, tk, dh, ragged, full_invalid_row=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, dh)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, dh)).astype(np.float32)
    k_valid = None
    if ragged:
        # non-contiguous validity: the contract is any boolean vector
        k_valid = rng.uniform(size=(b, tk)) > 0.3
        k_valid[:, 0] = True
    if full_invalid_row:
        k_valid = np.ones((b, tk), bool) if k_valid is None else k_valid
        k_valid[0] = False
    return q, k, v, k_valid


def _both(q, k, v, k_valid, causal, dtype):
    jdt, tdt, _ = _DTYPES[dtype]
    want = masked_flash_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
        None if k_valid is None else jnp.asarray(k_valid), causal=causal)
    got = masked_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        None if k_valid is None else torch.from_numpy(k_valid),
        causal=causal)
    assert got.shape == tuple(want.shape) and got.dtype == tdt
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,tq,tk,dh,causal,ragged", [
    (4, 8, 64, 64, 64, True, True),      # LM shape class
    (2, 8, 100, 100, 64, True, False),   # LM position cap
    (2, 2, 7, 7, 32, True, True),        # tiny everything
    (3, 4, 24, 40, 64, False, True),     # rectangular (Tq != Tk)
    (3, 4, 24, 40, 64, True, True),      # rectangular causal (Tq != Tk)
    (2, 2, 65, 134, 64, False, True),    # the decoder's cross-attention
])
def test_twin_matches_masked_flash(b, h, tq, tk, dh, causal, ragged, dtype):
    got, want = _both(*_inputs(0, b, h, tq, tk, dh, ragged), causal, dtype)
    tol = _DTYPES[dtype][2]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_fully_invalid_row_is_uniform(dtype, causal):
    """A batch row whose keys are ALL invalid reproduces the einsum path's
    uniform softmax over the -1e9 scores: finite, the mean of v."""
    q, k, v, k_valid = _inputs(2, 2, 2, 16, 16, 32, ragged=True,
                               full_invalid_row=True)
    got, want = _both(q, k, v, k_valid, causal, dtype)
    tol = _DTYPES[dtype][2]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    if dtype == "float32":
        mean_v = np.broadcast_to(v[0].mean(axis=1, keepdims=True), got[0].shape)
        np.testing.assert_allclose(got[0], mean_v, atol=1e-5, rtol=1e-5)


def test_attention_mask_matches_jax():
    rng = np.random.default_rng(4)
    k_valid = rng.uniform(size=(3, 9)) > 0.4
    q_valid = np.ones((3, 6), bool)
    for causal in (False, True):
        want = np.asarray(jax_attention_mask(jnp.asarray(q_valid),
                                             jnp.asarray(k_valid), causal))
        got = attention_mask(torch.from_numpy(q_valid),
                             torch.from_numpy(k_valid), causal).numpy()
        np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="disagree"):
        masked_attention(q, torch.zeros((1, 2, 4, 4)), torch.zeros((1, 2, 4, 4)))
    with pytest.raises(ValueError, match="dtype"):
        masked_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="Dh"):
        big = torch.zeros((1, 1, 2, 130))
        masked_attention(big, big, big)
    with pytest.raises(ValueError, match="bool"):
        masked_attention(q, q, q, torch.ones((1, 4)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        m = q.to("meta")
        masked_attention(m, m, m)


def _vjp_both(q, k, v, k_valid, g, causal, dtype, keep):
    """(out, dq, dk, dv) from the JAX kernel's custom VJP (interpreted) and
    from the port's Function, on one shared numpy keep mask (or none)."""
    jdt, tdt, _ = _DTYPES[dtype]
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    dmask = None
    if keep < 1.0:
        dmask = np.random.default_rng(11).uniform(size=(b, h, tq, tk)) < keep
    kv = jnp.asarray(k_valid)

    def jax_fn(q_, k_, v_):
        return masked_flash_attention(
            q_, k_, v_, kv, causal=causal,
            dropout_mask=None if dmask is None else jnp.asarray(dmask),
            keep_prob=keep, interpret=True)

    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    out, vjp = jax.vjp(jax_fn, jq, jk, jv)
    want = [out] + list(vjp(jnp.asarray(g, jdt)))

    tq_, tk_, tv_ = (torch.from_numpy(x).to(tdt).requires_grad_(True)
                     for x in (q, k, v))
    got_out = masked_attention(
        tq_, tk_, tv_, torch.from_numpy(k_valid), causal=causal,
        keep_mask=None if dmask is None else torch.from_numpy(dmask),
        keep_prob=keep)
    got = [got_out] + list(torch.autograd.grad(
        got_out, (tq_, tk_, tv_), torch.from_numpy(g).to(tdt)))
    return ([x.detach().float().numpy() for x in got],
            [np.asarray(x, np.float32) for x in want])


@pytest.mark.parametrize("keep", [1.0, 0.5])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_matches_masked_flash(dtype, causal, keep):
    """dq, dk, dv (and the forward) against jax.vjp of the interpreted
    kernel, ragged keys with one fully invalid row, with and without a
    dropout keep mask at 0.5."""
    q, k, v, k_valid = _inputs(5, 3, 2, 12, 12, 32, ragged=True,
                               full_invalid_row=True)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    got, want = _vjp_both(q, k, v, k_valid, g, causal, dtype, keep)
    tol = _DTYPES[dtype][2]
    for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        assert np.all(np.isfinite(x)), name
        np.testing.assert_allclose(x, y, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_keep_prob_one_ignores_the_mask(dtype, causal):
    """A keep mask at keep_prob 1.0 means no dropout, as in
    masked_flash_attention (``dropout_mask is not None and keep_prob <
    1.0``): the forward and the VJP with a random mask equal JAX's and the
    port's own unmasked call."""
    jdt, tdt, tol = _DTYPES[dtype]
    q, k, v, k_valid = _inputs(9, 2, 2, 8, 8, 16, ragged=True,
                               full_invalid_row=True)
    g = np.random.default_rng(10).standard_normal(q.shape).astype(np.float32)
    dmask = np.random.default_rng(12).uniform(size=(2, 2, 8, 8)) < 0.5
    kv = jnp.asarray(k_valid)

    def jax_fn(q_, k_, v_):
        return masked_flash_attention(q_, k_, v_, kv, causal=causal,
                                      dropout_mask=jnp.asarray(dmask),
                                      keep_prob=1.0, interpret=True)

    out, vjp = jax.vjp(jax_fn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = [np.asarray(x, np.float32)
            for x in [out] + list(vjp(jnp.asarray(g, jdt)))]

    def port(mask):
        xs = [torch.from_numpy(x).to(tdt).requires_grad_(True)
              for x in (q, k, v)]
        o = masked_attention(*xs, torch.from_numpy(k_valid), causal=causal,
                             keep_mask=mask, keep_prob=1.0)
        grads = torch.autograd.grad(o, xs, torch.from_numpy(g).to(tdt))
        return [x.detach().float().numpy() for x in (o, *grads)]

    got = port(torch.from_numpy(dmask))
    plain = port(None)
    for name, x, y, z in zip(("out", "dq", "dk", "dv"), got, want, plain):
        np.testing.assert_allclose(x, y, atol=tol, rtol=tol, err_msg=name)
        np.testing.assert_array_equal(x, z, err_msg=name)


def test_vjp_rectangular_matches_masked_flash():
    q, k, v, k_valid = _inputs(7, 2, 2, 8, 20, 16, ragged=True)
    g = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    got, want = _vjp_both(q, k, v, k_valid, g, True, "float32", 0.5)
    for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, y, atol=1e-5, rtol=1e-5, err_msg=name)


def test_masked_attention_is_differentiable():
    """On the CPU the wrapper goes through the port's autograd Function, so
    q, k and v all receive gradients, as they must on the card."""
    q, k, v = (torch.randn(2, 2, 5, 8, requires_grad=True) for _ in range(3))
    out = masked_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == f"{MaskedAttention.__name__}Backward"
    out.square().sum().backward()
    for x in (q, k, v):
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())
        assert float(x.grad.abs().sum()) > 0


def test_front_end_kernels_refuse_grad():
    """log_mel and cmvn have no backward: an input that requires grad is
    refused rather than silently cut from the graph."""
    sig = torch.zeros((1, 800), requires_grad=True)
    lens = torch.tensor([800], dtype=torch.int32)
    with pytest.raises(ValueError, match="no backward"):
        log_mel(sig, lens, 3)
    feat = torch.zeros((1, 3, 200), requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        cmvn(feat, torch.tensor([3], dtype=torch.int32))


def test_keep_mask_is_checked():
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="keep_mask"):
        masked_attention(q, q, q, keep_mask=torch.ones((1, 2, 4, 4)),
                         keep_prob=0.5)
    with pytest.raises(ValueError, match="keep_prob"):
        masked_attention(q, q, q,
                         keep_mask=torch.ones((1, 2, 4, 4), dtype=torch.bool),
                         keep_prob=0.0)


def test_backward_shared_memory_fits_every_forward_shape():
    """The backward kernel walks keys and queries in chunks, so its shared
    memory (``bwd_smem_bytes``, the mirror of csrc/attention.cu's layout)
    depends on Dh alone and fits the card's 232,448 bytes at every
    (Tq, Tk, Dh <= 128) the forward admits: here every Dh in both types and
    the f32 shapes of e2e training at bucket 1600 whose earlier
    one-block-per-(b, h) layout needed 294,624 bytes."""
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    for dtype in (torch.float32, torch.bfloat16):
        need = [attn.bwd_smem_bytes(dh, dtype)
                for dh in range(1, attn.MAX_DH + 1)]
        assert max(need) <= attn.MAX_SMEM, (dtype, max(need))
        assert need == sorted(need)        # grows with Dh only
    assert attn.bwd_smem_bytes(64, torch.float32) < 100_000
    # the mirror's tiling is the kernel's (chip_smoke.py holds the mirror
    # to the C query on the card)
    src = (attn._build.CSRC / "attention.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kKeyChunk"]) == attn._KEY_CHUNK
    assert int(consts["kQueryChunk"]) == attn._QUERY_CHUNK
    assert int(consts["kBwdWarps"]) == attn._BWD_WARPS
    assert int(consts["kBwdWarps"]) * int(consts["kRowsPerWarp"]) \
        == attn._BWD_QROWS
    assert int(consts["kBwdWarps"]) * int(consts["kKeysPerWarp"]) \
        == attn._BWD_KROWS
    # the one-block tensor-core backward takes bf16 at Tq, Tk <= 160 and
    # Dh <= 64 and fits the card at every such shape (its layout grows with
    # each, so the largest is the limit); everything else (f32, wider heads,
    # longer rows) keeps the chunked launches above
    assert int(consts["kMmaMaxT"]) == attn._MMA_MAX_T
    assert int(consts["kMmaMaxDh"]) == attn._MMA_MAX_DH
    assert attn.mma_bwd_smem_bytes(160, 160, 64) == 199_696 <= attn.MAX_SMEM
    for tq in (1, 15, 16, 17, 64, 65, 100, 134, 160, 161, 1600):
        for tk in (1, 16, 64, 134, 160, 161, 1600):
            for dh in (1, 16, 63, 64, 65, 128):
                fits = tq <= 160 and tk <= 160 and dh <= 64
                assert attn.bwd_path(tq, tk, dh, torch.bfloat16) == (
                    "mma" if fits else "chunked"), (tq, tk, dh)
                assert attn.bwd_path(tq, tk, dh, torch.float32) == "chunked"


@pytest.mark.parametrize("label,tq,tk,smem", [
    ("lm", 64, 64, 55_312),            # [64, 8, 64, 64] causal, keep 0.5
    ("e2e_encoder", 134, 134, 150_096),  # [8, 8, 134, 64], keep 0.9
    ("e2e_time_rows", 134, 134, 150_096),  # [640, 1, 134, 64]
    ("decoder_causal", 65, 65, 56_176),  # [8, 8, 65, 64], keep 0.9
    ("decoder_cross", 65, 134, 92_688),  # q [8, 8, 65, 64], kv 134
])
def test_backward_takes_the_tensor_cores_at_main_path_shapes(label, tq, tk,
                                                             smem):
    """Every bf16 backward shape of the LM and e2e training paths takes
    the one-block tensor-core kernel, with the shared memory its source
    note gives (csrc/attention.cu; chip_smoke.py holds the mirror to the C
    query on the card); f32 keeps the chunked launches."""
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    assert attn.bwd_path(tq, tk, 64, torch.bfloat16) == "mma"
    assert attn.bwd_path(tq, tk, 64, torch.float32) == "chunked"
    assert attn.mma_bwd_smem_bytes(tq, tk, 64) == smem


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_twin_matches_masked_flash_at_cross_shape(dtype):
    """The dropout forward at the decoder's cross-attention shape (Tq 65
    against Tk 134, keep 0.9) against the interpreted JAX kernel."""
    jdt, tdt, tol = _DTYPES[dtype]
    q, k, v, k_valid = _inputs(13, 2, 2, 65, 134, 64, ragged=True)
    dmask = np.random.default_rng(14).uniform(size=(2, 2, 65, 134)) < 0.9
    want = masked_flash_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(k_valid),
        dropout_mask=jnp.asarray(dmask), keep_prob=0.9, interpret=True)
    got = masked_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(k_valid), keep_mask=torch.from_numpy(dmask),
        keep_prob=0.9)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_forward_path_follows_the_kernel_limits():
    """``fwd_path`` mirrors csrc/attention.cu's ``fwd_path``: bf16 at Tk <=
    160 and Dh <= 64 takes the tensor-core forward at any Tq, everything
    else the scalar one; the limits are the source's constants, and the
    tensor-core forward's shared memory (``mma_fwd_smem_bytes``) grows with
    Tk and Dh only and stays within the 48 KB a block gets without opting
    in (chip_smoke.py holds both mirrors to the C queries on the card)."""
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    src = (attn._build.CSRC / "attention.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kFwdMaxTk"]) == attn._FWD_MAX_TK == 160
    assert int(consts["kFwdMaxDh"]) == attn._FWD_MAX_DH == 64
    for tq in (1, 16, 17, 64, 65, 100, 134, 160, 161, 1600):
        for tk in (1, 15, 16, 17, 64, 65, 100, 134, 159, 160, 161, 1600):
            for dh in (1, 7, 16, 63, 64, 65, 128):
                fits = tk <= 160 and dh <= 64
                assert attn.fwd_path(tq, tk, dh, torch.bfloat16) == (
                    "mma" if fits else "scalar"), (tq, tk, dh)
                assert attn.fwd_path(tq, tk, dh, torch.float32) == "scalar"
    need = [attn.mma_fwd_smem_bytes(tk, dh)
            for tk in range(1, 161) for dh in (1, 7, 8, 16, 32, 63, 64)]
    assert max(need) == attn.mma_fwd_smem_bytes(160, 64) == 46_736
    assert max(need) <= 48 * 1024
    assert attn.mma_fwd_smem_bytes(1, 7) == 112
    assert attn.mma_fwd_smem_bytes(65, 32) == 10_736


@pytest.mark.parametrize("label,tq,tk,smem", [
    ("lm_serving", 100, 100, 29_264),       # [8, 8, 100, 64] causal
    ("lm_training", 64, 64, 18_704),        # [64, 8, 64, 64] causal, keep 0.5
    ("e2e_encoder", 134, 134, 39_184),      # [8, 8, 134, 64], keep 0.9
    ("e2e_time_rows", 134, 134, 39_184),    # [640, 1, 134, 64]
    ("decoder_causal", 65, 65, 19_056),     # [8, 8, 65, 64], keep 0.9
    ("decoder_cross", 65, 134, 39_184),     # q 65 / kv 134, keep 0.9
])
def test_forward_takes_the_tensor_cores_at_main_path_shapes(label, tq, tk,
                                                            smem):
    """Every bf16 forward shape of the LM and e2e paths takes the
    tensor-core kernel, with the shared memory its source note gives
    (csrc/attention.cu); f32 keeps the scalar kernel."""
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    assert attn.fwd_path(tq, tk, 64, torch.bfloat16) == "mma"
    assert attn.fwd_path(tq, tk, 64, torch.float32) == "scalar"
    assert attn.mma_fwd_smem_bytes(tk, 64) == smem
    src = (attn._build.CSRC / "attention.cu").read_text()
    note = " ".join(line.strip().lstrip("/").strip()
                    for line in src.splitlines())
    assert f"{smem:,} at Tk {tk}" in note, smem


def _f32_round(x):
    """An exact rational rounded to the nearest float32 (ties to even)."""
    from fractions import Fraction
    c = np.float32(float(x))
    cands = (np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf)))
    return min(cands, key=lambda t: (abs(Fraction(float(t)) - x),
                                     int(t.view(np.uint32)) & 1))


def test_reciprocal_division_is_correctly_rounded():
    """csrc/attention.cu's tensor-core forward divides by the row sum and by
    keep as ``div_by``: q = x r with r = 1 / y, then q + (x - q y) r with
    each step one float32 FMA. Emulated here exactly, it equals the
    correctly rounded x / y (what ``/`` gives) at probabilities against
    sums of 1-160 keys and against bf16 keep probabilities, wherever the
    quotient is above 1e-36 (below it, it may differ by one ulp of a value
    that adds nothing to P.V)."""
    from fractions import Fraction
    rng = np.random.default_rng(20)
    xs = np.concatenate([rng.uniform(0, 1, 1500),
                         np.exp(-rng.uniform(0, 87, 1500)), [0.0, 1.0]]
                        ).astype(np.float32)
    sums = np.concatenate([rng.uniform(1, 160, 1500),
                           rng.uniform(1, 2, 1500), [1.0, 3.0]]
                          ).astype(np.float32)
    keeps = np.float32([0.5, 0.8984375, 0.69921875])   # bf16 0.5, 0.9, 0.7

    def fma(a, b, c):
        return _f32_round(Fraction(float(a)) * Fraction(float(b))
                          + Fraction(float(c)))

    def div_by(x, y):
        r = _f32_round(1 / Fraction(float(y)))
        q = np.float32(x * r)
        return fma(fma(-q, y, x), r, q)

    pairs = list(zip(xs, sums)) + [(x, kp) for kp in keeps for x in xs[:500]]
    for x, y in pairs:
        want = _f32_round(Fraction(float(x)) / Fraction(float(y)))
        if want > 1e-36 or want == 0:
            assert div_by(x, y) == want, (x, y)


def test_forward_shared_memory_fits_every_key_length():
    """The scalar forward walks the keys in chunks of 64 and keeps the
    block's scores in shared memory only up to Tk 512, so its shared
    memory (``fwd_smem_bytes``, the mirror of csrc/attention.cu's
    ``FwdLayout``) fits the card's 232,448 bytes at every Tk up to 4096 and
    every Dh <= 128 in both types, and stops growing with Tk above 512:
    no key length is refused (the earlier layout, a (b, h)'s whole K and
    V, stopped at Tk 435 in f32 at Dh 64 and at Tk 220 at Dh 128)."""
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    for dtype in (torch.float32, torch.bfloat16):
        for dh in range(1, attn.MAX_DH + 1):
            need = [attn.fwd_smem_bytes(dh, dtype, tk)
                    for tk in range(1, 4097)]
            assert max(need) <= attn.MAX_SMEM, (dtype, dh, max(need))
            assert need[:512] == sorted(need[:512])  # scores kept
            assert len(set(need[512:])) == 1         # recomputed
            assert need[512] < need[0]
        for tk in (1, 64, 65, 160, 161, 220, 221, 435, 436, 512, 513, 600,
                   1000, 4096):
            for dh in (1, 64, 65, 128):
                assert attn.fwd_path(1, tk, dh, dtype) == (
                    "mma" if dtype == torch.bfloat16 and tk <= 160
                    and dh <= 64 else "scalar")
    assert attn.fwd_smem_bytes(64, torch.float32, 513) == 38_144
    assert attn.fwd_smem_bytes(128, torch.float32, 4096) == 75_008
    assert attn.fwd_smem_bytes(64, torch.bfloat16, 513) == 21_760
    assert attn.fwd_smem_bytes(128, torch.bfloat16, 4096) == 42_240
    assert attn.fwd_smem_bytes(64, torch.float32, 134) == 38_144 + 8_576
    assert attn.fwd_smem_bytes(128, torch.float32, 512) == 107_776
    # the mirror's tiling is the kernel's (chip_smoke.py holds the mirror
    # to the C query on the card)
    src = (attn._build.CSRC / "attention.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kWarps"]) == attn._FWD_WARPS
    assert int(consts["kRowsPerBlock"]) == attn._FWD_ROWS
    assert int(consts["kKeyChunk"]) == attn._KEY_CHUNK
    assert int(consts["kMaxKeptTk"]) == attn._FWD_MAX_KEPT_TK


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_twin_matches_masked_flash_at_long_keys(dtype, causal):
    """Key lengths past the earlier scalar forward's limit (Tk 600, ragged
    keys with key 0 invalid, so that causal query row 0 has no valid key):
    the twin that chip_smoke.py holds the card's kernel to agrees with the
    JAX kernel."""
    q, k, v, k_valid = _inputs(5, 1, 2, 40, 600, 64, True)
    k_valid[:, 0] = False
    got, want = _both(q, k, v, k_valid, causal, dtype)
    tol = _DTYPES[dtype][2]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
