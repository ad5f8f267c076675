"""The traffic is the same for one seed, differs between two seeds, gives
every seed the same sizes in another order, and keeps the corpora's
published figures."""

import numpy as np
import pytest

from helpers import DATA, PB
from portbench import manifest, traffic

OFFLINE = manifest.load(DATA / "traffic" / "tiny_offline.json")
TRAIN = manifest.load(DATA / "traffic" / "tiny_train.json")
BIG = 2 ** 31 + 12345


def test_offline_same_seed_same_traffic_other_seed_other():
    a = traffic.offline_batches(OFFLINE, BIG, "cpu")
    b = traffic.offline_batches(OFFLINE, BIG, "cpu")
    c = traffic.offline_batches(OFFLINE, BIG + 1, "cpu")
    assert all(np.array_equal(x.signals, y.signals) for x, y in zip(a, b))
    assert not all(np.array_equal(x.signals, y.signals) and x.bucket == y.bucket
                   for x, y in zip(a, c))
    lens = lambda bs: sorted(int(n) for x in bs for n in x.lengths)  # noqa
    assert lens(a) == lens(c)
    assert sorted(x.bucket for x in a) == sorted(x.bucket for x in c)


def test_offline_rows_fit_their_bucket():
    for b in traffic.offline_batches(OFFLINE, 7, "cpu"):
        assert b.signals.shape == (OFFLINE["batch"],
                                   traffic.samples_for_frames(b.bucket))
        for n, row in zip(b.lengths, b.signals):
            assert traffic.bucket_of(int(n), OFFLINE["buckets"]) == b.bucket
            assert not row[n:].any() and row[:n].any()


def test_train_labels_are_ctc_feasible_and_seeded():
    a = traffic.train_batches(TRAIN, BIG, "cpu")
    b = traffic.train_batches(TRAIN, BIG, "cpu")
    c = traffic.train_batches(TRAIN, BIG + 1, "cpu")
    assert all(np.array_equal(x.labels, y.labels) for x, y in zip(a, b))
    assert not all(np.array_equal(x.labels, y.labels) for x, y in zip(a, c))
    for x in a:
        frames = np.array([traffic.frames_for(int(n)) for n in x.lengths])
        t = np.minimum(frames // 8 + 1, x.bucket // 8)
        assert (2 * x.label_lengths + 1 <= t).all()
        assert (x.labels[:, :x.label_lengths.min()] > 0).all()


SPEC = manifest.load(PB / "traffic" / "offline_b128.json")["durations"]


def test_durations_keep_the_corpora_published_means():
    # unclipped, the mixture's mean is the corpora's hours over their
    # utterances
    d = traffic.durations({**SPEC, "max_s": 1000.0}, 20001)
    hours = sum(c["hours"] for c in SPEC["corpora"])
    utts = sum(c["utterances"] for c in SPEC["corpora"])
    assert np.mean(d) / traffic.SAMPLE_RATE == pytest.approx(
        hours * 3600 / utts, rel=2e-3)
    d = traffic.durations(SPEC, 2001) / traffic.SAMPLE_RATE
    assert d.min() >= SPEC["min_s"] and d.max() <= SPEC["max_s"]
    assert traffic.frames_for(int(SPEC["max_s"] * traffic.SAMPLE_RATE)) \
        == 1600


def test_bucket_batches_follow_the_shares():
    t = manifest.load(PB / "traffic" / "offline_b128.json")
    n = traffic.bucket_batches(t["durations"], t["buckets"],
                               t["cycle_batches"])
    assert n == {400: 18, 800: 18, 1200: 3, 1600: 1}
    for c in (7, 17, 40, 101):
        assert sum(traffic.bucket_batches(t["durations"], t["buckets"],
                                          c).values()) == c
