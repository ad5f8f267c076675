"""StreamPool: N concurrent incremental streams, batched on the device.

The port of ``infer/stream_pool.py``: the production counterpart of
:class:`~.streaming.IncrementalRecognizer`, as ``BatchingServer`` is for
whole utterances. Running each stream's programs separately costs N small
device calls per tick; the pool multiplexes up to ``n_slots`` streams
through ONE call per stage and round:

- **features**: every slot's completed frame group rides one
  ``[N, samples]`` ``log_mel`` launch;
- **encoder**: every slot's ready AM window rides one ``[N, window,
  nfilt]`` forward (slots are windowed independently on the host, so the
  head / tail edge alignment of streaming.py holds slot by slot);
- **beam decode**: one prefix-beam state ``[N, W, Lcap]`` lives on the
  device for ALL slots and advances in one
  :func:`ops.ctc_beam_search_stream_step` per round, with
  ``frame_counts`` freezing rows whose slot produced fewer (or no) new
  frames;
- **LM partials**: :meth:`partials` refreshes every active slot's
  hypothesis with one batched LM pass.

Per-slot host state (pre-emphasis carry, running CMVN, CTC collapse) is
numpy, shared by construction with the single-stream engine: each slot IS
an ``IncrementalRecognizer``; the pool drives its ``_feat_take`` /
``_feat_put`` and ``_plan_chunk`` / ``_consume_ids`` hooks and runs the
same batched device programs (``infer.streaming``) at the pool's batch, so
the two engines cannot drift (the tests hold a pool of N streams to N
independent recognizers token for token, greedy and beam).

Static shapes throughout: a round with fewer ready slots pads with zeros
and drops the dead rows on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from asr_dfcnn_transformer_torch.infer.pipeline import Pipeline
from asr_dfcnn_transformer_torch.infer.streaming import (
    IncrementalRecognizer, am_argmax, am_log_probs, feature_groups, lm_prefix)
from asr_dfcnn_transformer_torch.ops.ctc_decode import (
    ctc_beam_search_stream_best, ctc_beam_search_stream_init,
    ctc_beam_search_stream_step)


class StreamPool:
    """Batched multi-stream incremental recognizer.

    Typical server loop::

        pool = StreamPool(pipeline, n_slots=16)
        a, b = pool.open(), pool.open()
        pool.push(a, chunk_a, step=False)
        pool.push(b, chunk_b, step=False)
        pool.step()                  # one batched pass for every stage
        hyps = pool.partials()       # {slot: (pinyin, hanzi)}, one LM call
        final_a = pool.finalize(a)   # flush + final hypothesis
        pool.close(a)                # the slot is reusable
    """

    def __init__(self, pipeline: Pipeline, n_slots: int = 8, *,
                 chunk_logits: int = 16, halo_frames: int = 64,
                 frame_group: int = 128, cmvn: str = "running",
                 global_stats=None, max_logits: int = 200,
                 decode: Optional[str] = None,
                 beam_width: Optional[int] = None):
        if n_slots <= 0:
            raise ValueError("n_slots must be positive")
        self.pipeline = pipeline
        self.n_slots = n_slots
        self._slot_kw = dict(chunk_logits=chunk_logits,
                             halo_frames=halo_frames,
                             frame_group=frame_group, cmvn=cmvn,
                             global_stats=global_stats,
                             max_logits=max_logits, decode=decode,
                             beam_width=beam_width)
        self._slots: List[Optional[IncrementalRecognizer]] = [None] * n_slots
        self._finalized: Dict[int, Tuple[List[str], str]] = {}

        # one template slot fixes the decode mode and geometry
        template = IncrementalRecognizer(pipeline, **self._slot_kw)
        self.decode = template.decode
        self.beam_width = template.beam_width
        self.chunk_logits = template.chunk_logits
        self._window_frames = template._window_frames
        self._lm_cap = template._lm_cap
        self.nfilt = template.nfilt
        self._cfg = cfg = template.cfg
        self._feat_need = ((template.frame_group - 1) * cfg.hop
                           + cfg.win_len)
        self._device = pipeline.device
        if self.decode == "beam":
            self._beam_state = ctc_beam_search_stream_init(
                n_slots, self.beam_width, self._lm_cap, device=self._device)

    # -- slot lifecycle --------------------------------------------------

    def open(self) -> int:
        """Claim a free slot; returns its id."""
        for i, s in enumerate(self._slots):
            if s is None and i not in self._finalized:
                self._slots[i] = IncrementalRecognizer(self.pipeline,
                                                       **self._slot_kw)
                if self.decode == "beam":
                    self._reset_beam_row(i)
                return i
        raise RuntimeError(f"all {self.n_slots} slots busy")

    def close(self, slot: int):
        """Release a slot (discarding any un-finalized audio)."""
        self._check(slot, allow_finalized=True)
        self._slots[slot] = None
        self._finalized.pop(slot, None)

    @property
    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _check(self, slot: int, allow_finalized: bool = False):
        if not (0 <= slot < self.n_slots) or self._slots[slot] is None:
            raise KeyError(f"slot {slot} is not open")
        if not allow_finalized and slot in self._finalized:
            raise ValueError(f"slot {slot} is already finalized")

    def _reset_beam_row(self, slot: int):
        fresh = ctc_beam_search_stream_init(1, self.beam_width, self._lm_cap,
                                            device=self._device)
        state = [a.clone() for a in self._beam_state]
        for arr, f in zip(state, fresh):
            arr[slot] = f[0]
        self._beam_state = tuple(state)

    # -- streaming -------------------------------------------------------

    def push(self, slot: int, chunk: np.ndarray, *, step: bool = True):
        """Buffer audio for ``slot`` (host-side pre-emphasis only). With
        ``step=True`` (default) runs :meth:`step` afterwards; pass
        ``step=False`` when pushing several slots, then call :meth:`step`
        once so all of them share the batched passes."""
        self._check(slot)
        s = self._slots[slot]
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        if chunk.size == 0:
            return
        s._buffer_push(chunk)
        if step:
            self.step()

    def step(self, *, final_slots: frozenset = frozenset()):
        """Drain every slot's ready work with batched device calls."""
        self._feat_rounds(final_slots)
        self._decode_rounds(final_slots)

    def _feat_rounds(self, final_slots):
        n, need = self.n_slots, self._feat_need
        while True:
            segs = {}
            for i in self.active_slots:
                if i in self._finalized:
                    continue
                s = self._slots[i]
                seg = s._feat_take()
                if seg is None and i in final_slots:
                    tf = s._feat_take_final()
                    if tf is not None:
                        segs[i] = (tf[0], tf[1], True)
                        continue
                if seg is not None:
                    segs[i] = (seg, None, False)
            if not segs:
                break
            batch = np.zeros((n, need), np.float32)
            for i, (seg, _, _) in segs.items():
                batch[i] = seg
            feats = feature_groups(batch, self._cfg, self._device)
            for i, (_, rem, is_final) in segs.items():
                rows = feats[i] if rem is None else feats[i][:rem]
                self._slots[i]._feat_put(rows, final=is_final)
        # flush the sub-group CMVN remainder of finalizing slots
        for i in final_slots:
            if i in self.active_slots and i not in self._finalized:
                self._slots[i]._feat_put(
                    np.zeros((0, self.nfilt), np.float32), final=True)

    def _decode_rounds(self, final_slots):
        n, cl = self.n_slots, self.chunk_logits
        while True:
            plans = {}
            for i in self.active_slots:
                if i in self._finalized:
                    continue
                p = self._slots[i]._plan_chunk(final=i in final_slots)
                if p is not None:
                    plans[i] = p
            if not plans:
                break
            # group by window size: interior / head windows are all the
            # full size; only a short-bucket finalize uses fewer rows
            for size in sorted({p[1] for p in plans.values()}):
                sel = {i: p for i, p in plans.items() if p[1] == size}
                windows = np.zeros((n, size, self.nfilt), np.float32)
                for i, (start, win_rows, _, _) in sel.items():
                    windows[i] = self._slots[i]._window(start, win_rows)
                if self.decode == "beam":
                    self._beam_round(am_log_probs(self.pipeline, windows),
                                     sel, n, cl)
                else:
                    ids = am_argmax(self.pipeline, windows)
                    for i, (_, _, r0, n_new) in sel.items():
                        self._slots[i]._consume_ids(ids[i, r0: r0 + n_new])

    def _beam_round(self, lp: torch.Tensor, sel, n: int, cl: int):
        """One batched stream step over each selected slot's kept rows of
        ``lp`` [N, R//8, V]; the other rows are frozen by their count 0."""
        first = np.zeros((n,), np.int64)
        counts = np.zeros((n,), np.int32)
        for i, (_, _, r0, n_new) in sel.items():
            first[i], counts[i] = r0, n_new
        dev = lp.device
        rows = (torch.from_numpy(first).to(dev)[:, None]
                + torch.arange(cl, device=dev)[None, :])
        rows = torch.clamp(rows, max=lp.shape[1] - 1)
        chunk_lp = torch.gather(
            lp, 1, rows[..., None].expand(n, cl, lp.shape[-1]))
        self._beam_state = ctc_beam_search_stream_step(
            self._beam_state, chunk_lp, beam_width=self.beam_width,
            topk=self.beam_width, blank_id=-1,
            frame_counts=torch.from_numpy(counts))
        for i, (_, _, _, n_new) in sel.items():
            self._slots[i]._advance(n_new)

    # -- results ---------------------------------------------------------

    def _beam_ids_all(self):
        ids, lens, _ = ctc_beam_search_stream_best(self._beam_state)
        return ids.cpu().numpy(), lens.cpu().numpy()

    def pinyin_ids(self, slot: int) -> List[int]:
        self._check(slot, allow_finalized=True)
        if self.decode == "beam":
            ids, lens = self._beam_ids_all()
            return [int(x) for x in ids[slot][: int(lens[slot])]]
        return list(self._slots[slot]._ids)

    def partials(self) -> Dict[int, Tuple[List[str], str]]:
        """Current hypothesis for every active slot; ONE batched LM pass
        refreshes all of them."""
        act = self.active_slots
        if not act:
            return {}
        if self.decode == "beam":
            bids, blens = self._beam_ids_all()
            cur = {i: [int(x) for x in bids[i][: int(blens[i])]]
                   for i in act}
        else:
            cur = {i: list(self._slots[i]._ids) for i in act}
        av, lv = self.pipeline.av, self.pipeline.lv
        if self.pipeline.lm_model is None or lv is None:
            return {i: (av.decode(cur[i]), "") for i in act}
        cap = self._lm_cap
        ids = np.zeros((self.n_slots, cap), np.int32)
        lens = np.zeros((self.n_slots,), np.int32)
        for i in act:
            k = min(len(cur[i]), cap)
            ids[i, :k] = cur[i][:k]
            lens[i] = k
        han = lm_prefix(self.pipeline, ids, lens)
        return {i: (av.decode(cur[i]),
                    "".join(lv.decode(list(han[i][: lens[i]])))
                    if lens[i] else "")
                for i in act}

    def partial(self, slot: int) -> Tuple[List[str], str]:
        self._check(slot, allow_finalized=True)
        if slot in self._finalized:
            return self._finalized[slot]
        return self.partials()[slot]

    def finalize(self, slot: int) -> Tuple[List[str], str]:
        """Flush ``slot``'s tail frames / logits; returns and caches the
        final hypothesis (the slot stays open until :meth:`close`)."""
        self._check(slot)
        self.step(final_slots=frozenset({slot}))
        result = self.partials()[slot]
        self._finalized[slot] = result
        return result
