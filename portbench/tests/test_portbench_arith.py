"""The metric arithmetic on known inputs: the union for idle, work over
window time, a roofline from known work, and the served-path gap on
hand-built logits."""

import numpy as np
import pytest

from portbench import manifest, readers, trace, work
from portbench.reference import ctc


class FakeTrace(trace.Trace):
    def __init__(self, window, device, ranges=None):
        super().__init__(window, device, ranges or {}, [])


def test_union_and_idle():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36), (90, 120)]
    assert trace.union_ns(iv, 0, 100) == 20 + 10 + 10
    assert trace.gaps_ns(iv, 0, 100) == [(20, 30), (40, 90)]
    tr = FakeTrace((0, 100), [(s, e, "k", None) for s, e in iv])
    assert readers.idle_pct({"trace": tr}) == pytest.approx(60.0)


def test_device_time_in_ranges_and_per_span():
    dev = [(10, 20, "a", 5), (30, 50, "b", 25), (60, 61, "c", None),
           (70, 75, "d", 99)]
    tr = FakeTrace((0, 100), dev, {"portbench.am": [(0, 10), (20, 30)],
                                   "portbench.batch": [(0, 40), (40, 80)]})
    assert tr.device_s_in(["portbench.am"]) == pytest.approx(30e-9)
    assert tr.kernel_s(["b", "d"]) == pytest.approx(25e-9)
    assert readers.per({"trace": tr}, 30e-9, "batch") == pytest.approx(
        15e-9 * 1e3)


def test_rates_over_the_window():
    assert manifest.reader("audio_s_per_s")(
        {"audio_s": 500.0, "window_s": 2.0}) == 250.0
    assert manifest.reader("train_step_ms")(
        {"steps": 40, "window_s": 10.0}) == 250.0


def test_roofline_from_known_work():
    w = (3.35e9, {"bf16": 0.0})            # one millisecond of bytes
    assert work.bound_s(w) == pytest.approx(1e-3)
    assert readers.roofline_pct(work.bound_s(w), 4e-3) == pytest.approx(25.0)
    w = (0.0, {"bf16": 989e9, "f32": 67e9})  # 1 ms + 1 ms of operations
    assert work.bound_s(w) == pytest.approx(2e-3)
    assert readers.roofline_pct(1.0, 0.0) is None


def test_causal_attention_work():
    b, ops = work.causal_attention(2, 3, 4, 8)
    assert ops == {"bf16": 4 * (2 * 3 * 10) * 8}
    assert b == 4 * 2 * 3 * 4 * 8 * 2 + 2 * 4


def test_mfu_counts_the_widths():
    cfg = {"am": {"family": "keras_dfcnn", "feature_dim": 16,
                  "stage_features": [2, 2, 2, 2, 2],
                  "stage_pool": [True, True, True, False, False],
                  "dense_units": 4, "vocab_size": 5}}
    f = work.am_flops(cfg, 8)
    convs = 2 * 9 * (1 * 2 * 8 * 16 + 2 * 2 * 8 * 16 + 2 * 2 * 4 * 8 * 2
                     + 2 * 2 * 2 * 4 * 2 + 2 * 2 * 1 * 2 * 4)
    assert f == convs + 2 * 1 * 2 * 2 * 4 + 2 * 1 * 4 * 5


def _lattice(path, v=5, hi=5.0):
    lg = np.full((len(path), v), -5.0)
    lg[np.arange(len(path)), path] = hi
    return lg


def test_served_gap_zero_for_the_reference_decode():
    blank = 4
    lg = _lattice([blank, 1, 1, blank, 2, 2, blank, 1])
    assert ctc.served_gap(lg, [1, 2, 1], cap=100) == 0.0
    assert ctc.served_gap(lg, [1, 2], cap=100) == pytest.approx(10.0)
    assert ctc.served_gap(lg, [1, 3, 1], cap=100) == pytest.approx(10.0)
    # capped: the served prefix of a longer decode is what the cap leaves
    assert ctc.served_gap(lg, [1, 2], cap=2) == 0.0


def test_served_gap_repeats_need_a_blank():
    blank = 4
    lg = _lattice([1, 1, 1])
    # 1 1 needs a blank between: one frame must leave the best class
    assert ctc.served_gap(lg, [1, 1], cap=10) == pytest.approx(10.0)
    lg[1, blank] = 4.5
    assert ctc.served_gap(lg, [1, 1], cap=10) == pytest.approx(0.5)


def test_greedy_merges_repeats_drops_blanks_and_caps():
    import torch
    lg = torch.tensor(_lattice([4, 1, 1, 4, 1, 2, 2, 3]))[None]
    assert ctc.greedy(lg, torch.tensor([8]), 10) == [[1, 1, 2, 3]]
    assert ctc.greedy(lg, torch.tensor([5]), 10) == [[1, 1]]
    assert ctc.greedy(lg, torch.tensor([8]), 2) == [[1, 1]]
