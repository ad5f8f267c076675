"""Offline recognition: a corpus in fixed batches through
``Pipeline.recognize_batch``, whole cycles over the corpus until the window
has lasted ``--seconds``, so that every run does the same work per cycle.

Set-up: the corpus, the models with the seed's weights, two batches of
every bucket. Check: a sample of the finished utterances (the longest
among them) against the reference (``compare.served``).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import compare, harness, system, trace, traffic


def run(ctx: harness.Context) -> dict:
    t, cfg = ctx.cell.traffic, ctx.cell.config
    batches = traffic.offline_batches(t, ctx.seed, ctx.device)
    pipe = system.pipeline(cfg, ctx.seed, ctx.device, t["decode"])
    warm = {b.bucket: b for b in batches}
    for _ in range(2):
        for b in warm.values():
            pipe.recognize_batch(b.signals, b.lengths, b.bucket)
    ctx.synchronize()
    hooks = trace.Hooks()
    if ctx.trace:
        hooks.attach(pipe.am_model, "am")
        hooks.attach(pipe.lm_model, "lm")
    setup_peak = ctx.reset_peak()
    done, walls = [], []
    with trace.profiled(ctx.trace, ctx.device) as prof:
        with trace.span(ctx.trace, "window"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < ctx.seconds:
                for i, b in enumerate(batches):
                    s = time.perf_counter()
                    with trace.span(ctx.trace, "batch"):
                        out = pipe.recognize_batch(b.signals, b.lengths,
                                                   b.bucket)
                    walls.append(time.perf_counter() - s)
                    done.append((i, out))
            t1 = time.perf_counter()
    window_peak = ctx.peak()
    hooks.remove()
    tr = trace.Trace.from_profiler(prof) if prof is not None else None
    del pipe, prof
    harness.release()

    missing = sum(len(batches[i].lengths) - len(out[1]) for i, out in done)
    r = traffic.rng(ctx.seed, "check")
    flat = [(j, row) for j, (i, out) in enumerate(done)
            for row in range(len(out[1]))]
    lengths = [int(batches[done[j][0]].lengths[row]) for j, row in flat]
    picks = harness.sample(r, len(flat), t["check_sample"],
                           int(np.argmax(lengths)))
    samples = []
    for p in picks:
        j, row = flat[p]
        b, (pny, plen, han) = batches[done[j][0]], done[j][1]
        k = int(plen[row])
        samples.append({"signal": b.signals[row, :b.lengths[row]],
                        "bucket": b.bucket, "pinyin": pny[row, :k].tolist(),
                        "hanzi": han[row, :k].tolist()})
    readings = compare.served(cfg, ctx.seed, samples, ctx.device)
    return {
        "control": lambda: compare.served(cfg, ctx.seed, samples, ctx.device,
                                          control=True),
        "cfg": cfg, "setup_s": t0 - ctx.started, "window_s": t1 - t0,
        "done": [batches[i] for i, _ in done], "batch_walls_s": walls,
        "audio_s": sum(batches[i].audio_s for i, _ in done),
        "peak_window_bytes": window_peak,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "trace": tr, "readings": readings, "missing": missing,
        "attempted": sum(len(batches[i].lengths) for i, _ in done),
        "failed": missing,
    }
