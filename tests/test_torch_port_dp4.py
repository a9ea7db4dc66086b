"""Data parallelism with ZeRO-1 over four ranks (``train.opt_state_sharding``
under ``train.gpus: 4``), the layout of ``configs/exp/image/
vit_l16_multihost.yaml`` on one four-card host, held against the plain fp32
reference of the benchmark (``benchmark/benchlib/reference.py::train_steps``,
one process over the global batch).

Four gloo ranks on the CPU (``torch_ranks.Ranks``, started once for the
module) run three ``Experiment.train_step`` calls of a small ViT in the
``vit-l16`` preset's layout, with clip 1.0 and dropout 0.1. Losses, the
gradients as averaged before the clip and the parameters after step 3 are
held at 1e-5 (fp32); the new spans are recorded once a step on each rank,
and ``comm.STATS`` counts the all-reduce's and the all-gather's bytes. One
rank that keeps its own gradient fails the comparison.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from torch_ranks import Ranks, dp_steps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(os.path.join(ROOT, "benchmark"))  # after the tests' own modules

from benchlib import checks, inputs, reference  # noqa: E402
from benchlib.dims import dims  # noqa: E402

TOL = 1e-5  # fp32 on both sides; the ranks sum their rows in another order
WORLD = 4
CFG = {
    "project": "vit-image",
    "model": {"name": "vit-l16", "task_type": "cls", "input_kind": "image", "image_size": 32,
              "num_labels": 8, "num_channels": 3, "pos_encoding_type": "learned",
              "remat": "mlp", "attn_impl": "auto", "hidden_size": 64, "num_hidden_layers": 4,
              "num_attention_heads": 4, "intermediate_size": 256},
    "train": {"batch_size": 16, "precision": "fp32", "grad_clip": 1.0, "model_parallel": 1,
              "gpus": WORLD, "opt_state_sharding": True, "fused_epoch": False, "save": False},
    "loss": {"name": "ce"},
    "opt": {"type": "AdamW", "lr": 0.004, "weight_decay": 0.3, "lr_sch": "cosine"},
    "warmup": {"epochs": 10},
    "data": {"num_samples": 48, "num_test_samples": 16},
    "noise": {"noise_level": 0},
    "viz": {"enable": False},
}
STEPS = 3
SEED = 42  # the Experiment's dropout generator (torch_ranks._experiment's default)


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(WORLD)
    yield r
    r.close()


@pytest.fixture(scope="module")
def case():
    d = dims(CFG)
    w = inputs.weights(d, inputs.generator(7, "cpu", 0), "cpu")
    rng = np.random.default_rng(3)
    batches = [{"x": rng.standard_normal((d.batch, 32, 32, 3)).astype(np.float32),
                "label": rng.integers(0, d.labels, d.batch).astype(np.int32)}
               for _ in range(STEPS)]
    seeds = reference.epoch_seeds(SEED, STEPS, d.sites)
    ref = reference.train_steps(d, w, [(torch.from_numpy(b["x"]), torch.from_numpy(b["label"]))
                                       for b in batches], seeds, d.first_lr(), 4)
    # the step-1 gradient of the global batch, whole, from the same model
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    b = batches[0]
    reference.loss(d, reference.Plain(d, params)(torch.from_numpy(b["x"]),
                                                 [int(s) for s in seeds[0]], 0),
                   torch.from_numpy(b["label"])).backward()
    grad1 = {k: p.grad.numpy() for k, p in params.items()}
    return d, {k: v.numpy() for k, v in w.items()}, batches, ref, grad1


def _prog(d, w, out):
    """The program's first-step readings as the benchmark takes them."""
    _, losses, _, grads, params, _, _, _ = out
    norm = float(np.sqrt(sum(np.square(g, dtype=np.float64).sum() for g in grads.values())))
    scale = d.grad_clip / norm if norm >= d.grad_clip else 1.0
    return {"losses": losses,
            "grad1": {n: float(np.linalg.norm(g)) * scale for n, g in grads.items()},
            "change": {n: float(np.linalg.norm(p - w[n])) for n, p in params.items()}}, norm


def test_four_zero1_ranks_match_the_plain_reference(ranks, case):
    d, w, batches, ref, grad1 = case
    outs = ranks.run(dp_steps, copy.deepcopy(CFG), w, batches)
    r0 = outs[0]
    prog, norm = _prog(d, w, r0)
    assert r0[2] == pytest.approx([d.first_lr()] * STEPS, rel=1e-12)
    numbers = checks.train_numbers(prog, ref)
    assert all(v < TOL for v in numbers.values()), numbers
    assert abs(norm - ref["grad_norm"]) <= TOL * ref["grad_norm"]
    global_norm = float(np.sqrt(sum(np.square(g).sum() for g in grad1.values())))
    for n, g in r0[3].items():  # the averaged gradient, tensor by tensor
        err = np.linalg.norm(g - grad1[n]) / max(np.linalg.norm(grad1[n]), 1e-3 * global_norm)
        assert err < TOL, n
    for out in outs[1:]:  # ZeRO-1's gather leaves every rank the same parameters
        assert out[1] == r0[1]
        assert all(np.array_equal(out[4][n], p) for n, p in r0[4].items())


def test_the_new_spans_and_counts_once_a_step(ranks, case):
    d, w, batches, _, _ = case
    outs = ranks.run(dp_steps, copy.deepcopy(CFG), w, batches)
    n_params = sum(p.size for p in w.values())
    split = outs[0][7]
    gathered = sum(w[n].size for n, s in split.items() if s)
    assert 0 < gathered < n_params  # the CLS token and the positions are stepped whole
    for rank, _, _, _, _, spans, stats, _ in outs:
        assert spans == {"vtt.train.step": STEPS, "vtt.train.grad_sync": STEPS,
                         "vtt.train.zero1_gather": STEPS, "vtt.comm.all_reduce": STEPS,
                         "vtt.comm.all_gather": STEPS}, rank
        assert stats["ops"] == {"all_reduce": {"calls": STEPS, "bytes": STEPS * 4 * (n_params + 1)},
                                "all_gather": {"calls": STEPS, "bytes": STEPS * 4 * gathered}}
        assert stats["calls"] == 2 * STEPS and stats["staged_bytes"] == 0


def test_a_rank_that_keeps_its_own_gradient_fails_the_comparison(ranks, case):
    d, w, batches, ref, _ = case
    outs = ranks.run(dp_steps, copy.deepcopy(CFG), w, batches, True)
    prog, _ = _prog(d, w, outs[0])
    numbers = checks.train_numbers(prog, ref)
    assert max(numbers["grad1_gap"], numbers["change3_gap"]) > 100 * TOL, numbers
