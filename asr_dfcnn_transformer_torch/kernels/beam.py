"""``beam_search``: the CTC prefix beam search in one kernel, with its twin.

Replaces ``ops/pallas/beam_kernel.py: beam_search``; the CUDA source is
``csrc/beam.cu``. The semantics are those of the JAX package's scan
backend (``ops/ctc_decode.py`` ``_beam_state_init`` and ``_make_beam_step``):
the same candidates in the same order, the same double rolling hash, the
same masked logsumexp, first-occurrence rule, top-W order, prefix rebuild
and freeze past each length. ``beam_step`` is that scan step in torch; the
twin (``beam_search_reference``) runs it frame by frame, and the streaming
decode (``ops/ctc_decode.py``) runs it chunk by chunk. The wrapper calls the
custom op ``asr_port::beam_search``, which runs the twin for CPU tensors and
launches the kernel for CUDA tensors; the wrapper raises for anything else.

Hashes are uint32 in the JAX package; here they are int64 holding the
uint32 value, multiplied in 16-bit halves so that no product overflows.

The kernel keeps no prefix table: each frame records a back-pointer per
beam and one trace-back at the end writes the prefixes.
``beam_step_backpointers`` records them as the kernel packs them and
``trace_back`` mirrors the kernel's walk, so the CPU tests can show that
the back-pointers rebuild the twin's prefixes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from asr_dfcnn_transformer_torch.kernels import _build

NEG_INF = -1e30
MUL1 = 2654435761
MUL2 = 40503
_U32 = 0xFFFFFFFF
# csrc/beam.cu's back-pointer bits: source beam, extension, source at the
# cap, then the added symbol
_SRC_MASK, _EXT_BIT, _CAP_BIT, _ADD_SHIFT = 0x7F, 0x80, 0x100, 9

#: (prefixes [B, W, L] int32, plen [B, W] int32, h1 [B, W] int64,
#: h2 [B, W] int64, pb [B, W] f32, pnb [B, W] f32)
BeamState = Tuple[torch.Tensor, ...]


def _mul32(h: torch.Tensor, mul: int) -> torch.Tensor:
    """(h * mul) mod 2^32 for 0 <= h < 2^32 in int64, without overflow."""
    lo = (h & 0xFFFF) * mul
    hi = ((h >> 16) * mul) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def beam_state_init(b: int, w: int, lcap: int,
                    device: torch.device) -> BeamState:
    """Fresh state: beam 0 is the live empty prefix (hash 0); dead beams get
    the sentinel hashes w + 0x7fffffff and w + 0x1fffffff, so that they
    never merge with a live prefix."""
    prefixes = torch.zeros((b, w, lcap), dtype=torch.int32, device=device)
    plen = torch.zeros((b, w), dtype=torch.int32, device=device)
    pb = torch.full((b, w), NEG_INF, device=device)
    pb[:, 0] = 0.0
    pnb = torch.full((b, w), NEG_INF, device=device)
    sent = torch.arange(w, dtype=torch.int64, device=device)
    h1 = torch.where(sent == 0, 0, sent + 0x7fffffff).expand(b, w)
    h2 = torch.where(sent == 0, 0, sent + 0x1fffffff).expand(b, w)
    return prefixes, plen, h1.contiguous(), h2.contiguous(), pb, pnb


def _masked_lse(scores: torch.Tensor, eq: torch.Tensor) -> torch.Tensor:
    """Per candidate i, logsumexp of scores[j] over the j with eq[i, j];
    NEG_INF when the largest of them is (the readout)."""
    s_exp = torch.where(eq, scores[:, None, :], NEG_INF)          # [B, M, M]
    mx = torch.amax(s_exp, dim=2)
    mx_safe = torch.clamp_min(mx, NEG_INF / 2)
    out = mx_safe + torch.log(
        torch.sum(torch.exp(s_exp - mx_safe[..., None]), dim=2))
    return torch.where(mx <= NEG_INF / 2, NEG_INF, out)


def beam_step(state: BeamState, lp: torch.Tensor, top_lp: torch.Tensor,
              top_ids: torch.Tensor, active: Optional[torch.Tensor], *,
              blank: int) -> BeamState:
    """One frame of the prefix beam search (the scan backend's step).

    lp [B, V] f32 log-probs of the frame, top_lp / top_ids [B, K] its top-k,
    active [B] bool (None = every row): rows not active keep their state.
    """
    return _step(state, lp, top_lp, top_ids, active, blank, False)[0]


def beam_step_backpointers(state: BeamState, lp: torch.Tensor,
                           top_lp: torch.Tensor, top_ids: torch.Tensor,
                           active: Optional[torch.Tensor], *, blank: int
                           ) -> Tuple[BeamState, torch.Tensor]:
    """``beam_step``, and the [B, W] back-pointers the kernel records for
    the frame, packed as ``csrc/beam.cu`` packs them: the source beam, bit
    7 for an extension, bit 8 where its source was at the cap L, the added
    symbol from bit 9. A row not active records each beam as its own stay.
    """
    return _step(state, lp, top_lp, top_ids, active, blank, True)


def trace_back(backpointers: torch.Tensor, plen: torch.Tensor,
               lcap: int) -> torch.Tensor:
    """Python mirror of the kernel's trace-back: back-pointers [T, B, W]
    (``beam_step_backpointers``, frame by frame) and the final lengths
    [B, W] -> prefixes [B, W, L] int32. Walking a lineage from the last
    frame, an extension writes its symbol at the child's length - 1 and
    takes the source's length (L at the cap, else one less); positions
    below L - 1 are written at most once along a lineage, and the latest
    write wins at L - 1."""
    bps = backpointers.tolist()
    lens = plen.tolist()
    b, w = plen.shape
    out = torch.zeros((b, w, lcap), dtype=torch.int32)
    for i in range(b):
        for beam in range(w):
            cur, n, wrote_last = beam, lens[i][beam], False
            for frame in reversed(bps):
                e = frame[i][cur]
                if e & _EXT_BIT:
                    pos = n - 1
                    if pos >= 0 and (pos < lcap - 1 or not wrote_last):
                        out[i, beam, pos] = e >> _ADD_SHIFT
                        wrote_last = wrote_last or pos == lcap - 1
                    n = lcap if e & _CAP_BIT else n - 1
                cur = e & _SRC_MASK
    return out


def _step(state, lp, top_lp, top_ids, active, blank, backpointers):
    prefixes, plen, h1, h2, pb, pnb = state
    b, w, lcap = prefixes.shape
    k = top_ids.shape[1]
    dev = lp.device
    last = torch.gather(prefixes, 2,
                        torch.clamp_min(plen - 1, 0)[..., None].long())[..., 0]
    last = torch.where(plen > 0, last, -1)                        # [B, W]

    # "stay" candidates: the prefix unchanged
    tot = torch.logaddexp(pb, pnb)
    stay_pb = tot + lp[:, blank][:, None]
    rep_lp = torch.gather(lp, 1, torch.clamp_min(last, 0).long())
    stay_pnb = torch.where(plen > 0, pnb + rep_lp, NEG_INF)

    # "extend" candidates: beam w extended by symbol c, beam-major
    c_ids = top_ids[:, None, :]                                   # [B, 1, K]
    base = torch.where(c_ids == last[..., None], pb[..., None],
                       tot[..., None])
    ext_pnb = torch.where((c_ids == blank) | (plen[..., None] >= lcap),
                          NEG_INF, base + top_lp[:, None, :])     # [B, W, K]
    cid = c_ids.long() + 2
    ext_h1 = (_mul32(h1[..., None], MUL1) + cid) & _U32
    ext_h2 = (_mul32(h2[..., None], MUL2) + cid) & _U32
    ext_len = torch.clamp_max(plen[..., None] + 1, lcap).expand(b, w, k)

    cand_pb = torch.cat([stay_pb, torch.full((b, w * k), NEG_INF,
                                             device=dev)], 1)
    cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(b, -1)], 1)
    cand_h1 = torch.cat([h1, ext_h1.reshape(b, -1)], 1)
    cand_h2 = torch.cat([h2, ext_h2.reshape(b, -1)], 1)
    cand_len = torch.cat([plen, ext_len.reshape(b, -1)], 1)
    beams = torch.arange(w, dtype=torch.int64, device=dev)
    src = torch.cat([beams, beams.repeat_interleave(k)]).expand(b, -1)
    add = torch.cat([torch.full((b, w), -1, dtype=torch.int32, device=dev),
                     top_ids[:, None, :].expand(b, w, k).reshape(b, -1)], 1)

    # merge duplicates: equality of (h1, h2)
    eq = ((cand_h1[:, :, None] == cand_h1[:, None, :])
          & (cand_h2[:, :, None] == cand_h2[:, None, :]))          # [B, M, M]
    merged_pb = _masked_lse(cand_pb, eq)
    merged_pnb = _masked_lse(cand_pnb, eq)
    idx = torch.arange(eq.shape[1], device=dev)
    first = ~(eq & (idx[None, None, :] < idx[None, :, None])).any(dim=2)
    total = torch.where(first, torch.logaddexp(merged_pb, merged_pnb),
                        NEG_INF)

    # top W: descending, ties to the lower candidate index
    top = torch.sort(total, dim=1, descending=True, stable=True).indices[:, :w]

    def sel(arr):
        return torch.gather(arr, 1, top)

    new_src = sel(src)
    new_add = sel(add)
    src_prefix = torch.gather(prefixes, 1,
                              new_src[..., None].expand(b, w, lcap))
    app_pos = torch.clamp_max(torch.gather(plen, 1, new_src), lcap - 1)
    onehot = (torch.arange(lcap, device=dev)[None, None, :]
              == app_pos[..., None])
    new_prefixes = torch.where((new_add[..., None] >= 0) & onehot,
                               new_add[..., None], src_prefix)
    new = (new_prefixes, sel(cand_len), sel(cand_h1), sel(cand_h2),
           sel(merged_pb), sel(merged_pnb))
    bp = None
    if backpointers:
        ext = top >= w
        capped = torch.gather(plen, 1, new_src) >= lcap
        bp = (new_src + torch.where(ext, _EXT_BIT, 0)
              + torch.where(ext & capped, _CAP_BIT, 0)
              + torch.where(ext, new_add.long() << _ADD_SHIFT, 0))
    if active is None:
        return new, bp
    act = active.to(dev)
    if backpointers:
        bp = torch.where(act[:, None], bp, beams[None, :])
    return tuple(torch.where(act.view(-1, *([1] * (n.dim() - 1))), n, o)
                 for n, o in zip(new, state)), bp


def _check(lp, top_lp, top_ids, lens, w, k, blank, lcap) -> None:
    if lp.dim() != 3 or lp.dtype != torch.float32:
        raise ValueError(f"beam_search: lp must be [B, T, V] float32, got "
                         f"{tuple(lp.shape)} {lp.dtype}")
    b, t, v = lp.shape
    if top_lp.shape != (b, t, k) or top_lp.dtype != torch.float32:
        raise ValueError(f"beam_search: top_lp must be [{b}, {t}, {k}] "
                         "float32")
    if top_ids.shape != (b, t, k) or top_ids.dtype != torch.int32:
        raise ValueError(f"beam_search: top_ids must be [{b}, {t}, {k}] "
                         "int32")
    if lens.shape != (b,) or lens.dtype != torch.int32:
        raise ValueError("beam_search: lens must be [B] int32")
    if w < 1 or k < 1 or lcap < 1 or not 0 <= blank < v:
        raise ValueError(f"beam_search: needs beam_width, topk and "
                         f"max_decode_len >= 1 and 0 <= blank < V, got "
                         f"{w}, {k}, {lcap}, blank {blank}, V {v}")


def beam_search_reference(lp: torch.Tensor, top_lp: torch.Tensor,
                          top_ids: torch.Tensor, lens: torch.Tensor, *,
                          beam_width: int, topk: int, blank: int,
                          max_decode_len: int):
    """Plain-PyTorch twin of ``beam_search`` (same contract): the scan step,
    frame by frame."""
    _check(lp, top_lp, top_ids, lens, beam_width, topk, blank, max_decode_len)
    b, t, _ = lp.shape
    state = beam_state_init(b, beam_width, max_decode_len, lp.device)
    lens = lens.to(lp.device)
    for i in range(t):
        state = beam_step(state, lp[:, i], top_lp[:, i], top_ids[:, i],
                          i < lens, blank=blank)
    prefixes, plen, _, _, pb, pnb = state
    return prefixes, plen, pb, pnb


def _beam_search_cpu(lp: torch.Tensor, top_lp: torch.Tensor,
                     top_ids: torch.Tensor, lens: torch.Tensor,
                     beam_width: int, topk: int, blank: int,
                     max_decode_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The op under ``beam_search``: the twin for CPU tensors."""
    return beam_search_reference(lp, top_lp, top_ids, lens,
                                 beam_width=beam_width, topk=topk,
                                 blank=blank, max_decode_len=max_decode_len)


def _beam_search_cuda(lp, top_lp, top_ids, lens, beam_width, topk, blank,
                      max_decode_len):
    """The op under ``beam_search``: the kernel for CUDA tensors."""
    dev = _build.require_cuda("beam_search", lp, top_lp, top_ids, lens)
    b, t, v = lp.shape
    w, k, lcap = beam_width, topk, max_decode_len
    prefixes, plen, pb, pnb = _beam_outputs(lp, w, lcap)
    if b == 0:
        return prefixes, plen, pb, pnb
    # the back-pointers of each frame, read by the kernel's trace-back
    backpointers = torch.empty((b, t, w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().asr_beam_search(
            lp.data_ptr(), top_lp.data_ptr(), top_ids.data_ptr(),
            lens.data_ptr(), backpointers.data_ptr(), prefixes.data_ptr(),
            plen.data_ptr(), pb.data_ptr(), pnb.data_ptr(), b, t, v, w, k,
            blank, lcap, _build.stream_ptr(dev))
    _build.check("beam_search", rc, f"W {w}, K {k}, L {lcap}")
    return prefixes, plen, pb, pnb


def _beam_outputs(lp, w, lcap):
    """Empty (prefixes [B, W, L] int32, plen [B, W] int32, pb, pnb [B, W]
    f32) beside ``lp``."""
    b = lp.shape[0]
    return (lp.new_empty((b, w, lcap), dtype=torch.int32),
            lp.new_empty((b, w), dtype=torch.int32),
            lp.new_empty((b, w)), lp.new_empty((b, w)))


def _beam_search_fake(lp, top_lp, top_ids, lens, beam_width, topk, blank,
                      max_decode_len):
    return _beam_outputs(lp, beam_width, max_decode_len)


_beam_search_op = _build.define_op(
    "beam_search", _beam_search_cpu, _beam_search_cuda, _beam_search_fake)


def beam_search(lp: torch.Tensor, top_lp: torch.Tensor,
                top_ids: torch.Tensor, lens: torch.Tensor, *,
                beam_width: int, topk: int, blank: int, max_decode_len: int):
    """The whole CTC prefix beam search.

    lp [B, T, V] f32 log-probs; top_lp / top_ids [B, T, K] f32 / int32 their
    per-frame top-k (K = topk); lens [B] int32 valid frames. Returns
    (prefixes [B, W, L] int32, plen [B, W] int32, pb [B, W] f32, pnb [B, W]
    f32), W = beam_width, L = max_decode_len.
    """
    _check(lp, top_lp, top_ids, lens, beam_width, topk, blank, max_decode_len)
    _build.check_device("beam_search", lp, top_lp, top_ids, lens)
    return _beam_search_op(lp, top_lp, top_ids, lens, beam_width, topk,
                           blank, max_decode_len)
