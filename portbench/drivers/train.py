"""AM training: ``AMTrainer.train_step`` on fixed batches padded to one
bucket, dispatched back to back until the window has lasted ``--seconds``,
then one synchronise.

Set-up builds the trainer (model with the seed's weights, Adam) and drives
it through its first three steps on three different batches, through the
window's own call and feed; the reference follows them from the seed's
weights (``compare.train_reference``). A forward hook keeps the first
step's best class of every frame of the model's logits. The window then
goes on from step 4 with the same trainer.

After the window: the state the window left (parameters, Adam's moments)
is kept, and the trainer takes two steps more through the same call: on
the batch its rotation has due, which it has trained on, so that a batch
trained in part reads apart from the reference there; then on a batch it
has never seen, so that a step that replays old inputs does. The
reference takes both steps from the kept state with its own step count
(``compare.train_reference_next``). A leaf that the window left where step
3 left it, and a window loss that is not finite, are counted.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import torch

from portbench import compare, harness, system, trace, traffic

CHECKED_STEPS = 3


def _gen(ctx, step: int) -> int:
    return traffic.derive(ctx.seed, f"dropout:{step}")


def _moments(opt, params: dict) -> tuple:
    """Copies of Adam's (first, second) moment of each leaf; zeros for a
    leaf the optimizer holds no state of (it took no step)."""
    m, v = {}, {}
    for n, p in params.items():
        st = opt.state.get(p, {})
        m[n] = st["exp_avg"].detach().clone() if "exp_avg" in st \
            else torch.zeros_like(p)
        v[n] = st["exp_avg_sq"].detach().clone() if "exp_avg_sq" in st \
            else torch.zeros_like(p)
    return m, v


def _params(params: dict, device=None) -> dict:
    return {n: p.detach().to(device, copy=True) for n, p in params.items()}


def run(ctx: harness.Context) -> dict:
    t, cfg = ctx.cell.traffic, ctx.cell.config
    pool = traffic.train_batches(t, ctx.seed, ctx.device)
    fresh = traffic.train_batches({**t, "pool": 1},
                                  traffic.derive(ctx.seed, "fresh"),
                                  ctx.device)[0]
    feed = [system.am_batch(b) for b in pool]
    fresh_feed = system.am_batch(fresh)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    model = system.build_am(cfg, ctx.seed, ctx.device)
    tr = system.trainer(cfg, model, workdir)
    params = dict(model.named_parameters())
    p0 = _params(params)
    beta1 = tr.opt.param_groups[0]["betas"][0]
    losses = []

    def step(k: int, batch=None):
        g = torch.Generator(device=ctx.device).manual_seed(_gen(ctx, k))
        return tr.train_step(feed[(k - 1) % len(feed)] if batch is None
                             else batch, g)["loss"]

    first = []
    hook = model.register_forward_hook(
        lambda m, args, out: first.append(out.detach().argmax(-1).cpu()))
    for k in range(1, CHECKED_STEPS + 1):
        losses.append(step(k))
        if k == 1:
            hook.remove()
            # the first moment after one step is (1 - beta1) g; kept on
            # the host, as is all the check holds through the window, so
            # that the window's peak is the program's
            grad = {n: (x / (1 - beta1)).cpu() for n, x in
                    _moments(tr.opt, params)[0].items()}
    p3 = _params(params, "cpu")
    prog = {"losses": [float(x) for x in losses], "grad": grad,
            "update": {n: p3[n] - p0[n].cpu() for n in params},
            "argmax": first[0]}
    del p0
    ctx.synchronize()

    hooks = trace.Hooks()
    if ctx.trace:
        hooks.attach(model, "am")
    setup_peak = ctx.reset_peak()
    k = CHECKED_STEPS
    window_losses = []
    with trace.profiled(ctx.trace, ctx.device) as prof:
        with trace.span(ctx.trace, "window"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < ctx.seconds:
                k += 1
                with trace.span(ctx.trace, "step"):
                    window_losses.append(step(k))
            ctx.synchronize()
            t1 = time.perf_counter()
    window_peak = ctx.peak()
    hooks.remove()
    trc = trace.Trace.from_profiler(prof) if prof is not None else None
    steps = k - CHECKED_STEPS
    failed = sum(not torch.isfinite(x).item() for x in window_losses)

    # the state the window left, and two steps more through the same call
    state = {"params": _params(params)}
    state["exp_avg"], state["exp_avg_sq"] = _moments(tr.opt, params)
    next_loss = float(step(k + 1))
    m_after = _moments(tr.opt, params)[0]
    prog["next"] = {
        "loss": next_loss,
        "grad": {n: (m_after[n] - beta1 * state["exp_avg"][n]) / (1 - beta1)
                 for n in params},
        "update": {n: p.detach() - state["params"][n]
                   for n, p in params.items()},
        "unmoved": {n: torch.equal(state["params"][n].cpu(), p3[n])
                    for n in params},
        "fresh_loss": float(step(k + 2, fresh_feed))}
    del tr, model, params, prof, window_losses, m_after, p3
    harness.release()
    shutil.rmtree(workdir, ignore_errors=True)

    gens = [_gen(ctx, j) for j in range(1, CHECKED_STEPS + 1)]
    nxt = ([(pool[k % len(pool)], _gen(ctx, k + 1)),
            (fresh, _gen(ctx, k + 2))], k)

    def reference(pr=compare.F32) -> dict:
        out = compare.train_reference(cfg, ctx.seed, pool[:CHECKED_STEPS],
                                      gens, ctx.device, pr)
        out["next"] = compare.train_reference_next(cfg, ctx.seed, state,
                                                   *nxt, ctx.device, pr)
        return out

    ref = reference()
    readings = compare.train_gaps(prog, ref)

    def control() -> dict:
        c = reference(compare.CONTROL)
        return compare.train_gaps(
            {**c, "next": {**c["next"], "unmoved": prog["next"]["unmoved"]}},
            ref)

    return {
        "control": control,
        "cfg": cfg, "setup_s": t0 - ctx.started, "window_s": t1 - t0,
        "steps": steps, "done": [pool[(j - 1) % len(pool)] for j in
                                 range(CHECKED_STEPS + 1, k + 1)],
        "peak_window_bytes": window_peak,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "trace": trc, "readings": readings, "missing": 0,
        "attempted": steps, "failed": failed,
    }
