"""Serving traffic: a closed loop with one caller of ``Predictor.predict``,
for a regression model over spectra.

Set-up makes the weights and a pool of call inputs from the seed, builds
the model through the project's builder, loads the weights, wraps it in a
``Predictor`` at the mix's batch size (``label_norm: minmax`` with the
label range given) and calls it once on every pool entry, which builds and
warms every kernel the window uses. The window then calls ``predict`` on
the pool's entries in turn, each call timed from the call to the return of
its numpy result, until it has lasted ``--seconds``. A traced run traces
``trace_calls`` calls instead.

Once the window has closed, a sample of the answers drawn from the seed,
over every call, is held against the reference's logits of the same
inputs. The control is the reference in fp8 in the program's place.
"""

from __future__ import annotations

import copy
import gc
import math
import time

import numpy as np
import torch

from benchlib import checks, inputs, reference
from benchlib.dims import dims
from benchlib.trace import Tracer


def _pool(ctx, d):
    p = ctx.params
    g = inputs.generator(ctx.seed, ctx.device, 3)
    pool = []
    for _ in range(int(p["pool_calls"])):
        x = inputs.spectra(int(p["rows_per_call"]), d.length, g, ctx.device)["flux"]
        pool.append(np.ascontiguousarray(x, np.float32))
    return pool


def run(ctx) -> dict:
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.serve import Predictor

    cfg = copy.deepcopy(ctx.config)
    d = dims(cfg)
    if d.task != "reg" or d.image:
        raise ValueError("the predict traffic serves a regression model over spectra")
    p = ctx.params
    ctx.mark("imports")
    pool = _pool(ctx, d)
    w = inputs.weights(d, inputs.generator(ctx.seed, ctx.device, 0), ctx.device)
    ctx.mark("data_and_weights")
    bundle = get_model(copy.deepcopy(cfg))
    bundle.module.load_state_dict(w, strict=True)
    w = {n: t.cpu() for n, t in w.items()}
    lo, hi = p["label_range"]
    pred = Predictor(bundle.module.to(ctx.device), bundle.vit_config,
                     batch_size=int(p["batch_size"]), label_norm="minmax",
                     label_norm_stats={"label_min": [lo], "label_max": [hi]})
    del bundle
    ctx.mark("predictor")
    for x in pool:
        pred.predict(x)
    ctx.mark("warm_calls")
    tracer = Tracer() if ctx.trace else None
    ctx.sync()
    start = time.perf_counter()
    if tracer is not None:
        tracer.start()
    times, answers, failed = [], [], 0
    calls = int(p["trace_calls"]) if tracer is not None else None
    while True:
        i = len(times)
        t0 = time.perf_counter()
        try:
            out = pred.predict(pool[i % len(pool)])
        except RuntimeError:
            out = None
        t1 = time.perf_counter()
        times.append(t1 - t0)
        ok = out is not None and len(out) == len(pool[i % len(pool)]) and np.isfinite(out).all()
        failed += not ok
        answers.append(out if ok else None)
        if (calls is not None and len(times) >= calls) or (
                calls is None and t1 - start >= ctx.seconds):
            break
    window_s = t1 - start
    rows = sum(len(pool[i % len(pool)]) for i in range(len(times)))
    batches = sum(math.ceil(len(pool[i % len(pool)]) / pred.batch_size)
                  for i in range(len(times)))
    trace = None
    if tracer is not None:
        trace = tracer.stop({"calls": len(times), "rows": rows, "batches": batches,
                             "batch_size": pred.batch_size})
    ranked = sorted(times)
    p95 = ranked[max(0, math.ceil(0.95 * len(ranked)) - 1)]
    peak = ctx.memory_peak()
    counters = {"calls": len(times), "rows": rows, "batches": batches,
                "calls_beyond_p95": len(ranked) - math.ceil(0.95 * len(ranked))}
    del pred
    gc.collect()
    ctx.free()
    numbers = _check(ctx, d, pool, answers, w, lo, hi)
    return {"metrics": {"predict_samples_per_s": rows / window_s,
                        "predict_call_ms_p95": p95 * 1e3, "setup_s": start - ctx.t_start},
            "attempted": len(times), "failed": failed, "memory_peak_bytes": peak,
            "numbers": numbers, "trace": trace, "counters": counters}


def _sample(ctx, pool, n_calls):
    """(call, row) pairs drawn from the seed over every call."""
    rng = np.random.default_rng(ctx.seed)
    calls = rng.integers(0, n_calls, size=int(ctx.params["check_rows"]))
    rows = np.array([rng.integers(0, len(pool[c % len(pool)])) for c in calls])
    return calls, rows


def _reference(ctx, d, pool, calls, rows, w, quant=None) -> np.ndarray:
    reference.plain_mode()
    x = torch.from_numpy(np.stack([pool[c % len(pool)][r] for c, r in zip(calls, rows)]))
    return reference.logits(d, {k: t.to(ctx.device) for k, t in w.items()}, x.to(ctx.device),
                            int(ctx.params["ref_block_rows"]), quant).double().cpu().numpy()


def _compare(served, ref, lo, hi) -> dict:
    return {"pred_gap": checks.regression_gap(served, ref * (hi - lo) + lo, lo, hi)}


def _check(ctx, d, pool, answers, w, lo, hi) -> dict:
    """A sample of (call, row) answers drawn from the seed against the
    reference. A failed call counts as a wrong answer."""
    calls, rows = _sample(ctx, pool, len(answers))
    if any(answers[c] is None for c in calls):
        return {"pred_gap": float("inf")}
    ref = _reference(ctx, d, pool, calls, rows, w)
    served = np.stack([np.asarray(answers[c])[r] for c, r in zip(calls, rows)])
    return _compare(served, ref, lo, hi)


def control(ctx) -> dict:
    """The control: the reference in fp8 in the program's place, its
    answers held against the fp32 reference's."""
    d = dims(ctx.config)
    pool = _pool(ctx, d)
    w = {n: t.cpu() for n, t in
         inputs.weights(d, inputs.generator(ctx.seed, ctx.device, 0), ctx.device).items()}
    lo, hi = ctx.params["label_range"]
    calls, rows = _sample(ctx, pool, 4 * len(pool))
    ref = _reference(ctx, d, pool, calls, rows, w)
    low = _reference(ctx, d, pool, calls, rows, w, quant="fp8")
    return {"numbers": _compare(low[:, 0] * (hi - lo) + lo, ref, lo, hi)}
