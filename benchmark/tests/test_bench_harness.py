"""The benchmark's harness on the CPU: its files against ``BENCHMARK.json``
and the contract's limits, the operation counts against hand counts, the
frozen hash against the port's, the reference against the port's CPU path
at a tiny size, the faults a cell must catch, the result line's schema
and the no-JAX rule. ``test_control_on_the_card`` runs a cell's control
at the cell's own size on the card.
"""

import ast
import copy
import glob
import importlib
import io
import json
import os
import re
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from benchlib import checks, counts, reference, runner, spec
from benchlib.dims import dims

BENCH = spec.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
TRAIN = [c for c in CELLS if spec.cell(c)["traffic_mix"]["driver"] == "train"]


# -- the files -------------------------------------------------------------------
def test_benchmark_json_keeps_the_contract():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and 0 < len(m["layer"]) <= 200
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(CELLS) // 4)
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(spec.ROOT,
                                                                                  c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert not any(k.endswith(("_dim", "_rank", "_size")) and "batch" not in k
                       for k in c["reduced"])


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_files(name):
    cell = spec.cell(name)
    assert cell["chips"] in (1, 4) and 0 < len(cell["why"]) <= 200
    assert callable(spec.load_module("drivers", cell["traffic_mix"]["driver"]).run)
    cfg = cell["config_file"]
    d = dims(cfg["config"])
    assert d.layers > 0 and d.seq > 1
    entry = [c for c in spec.benchmark()["configs"] if c["name"] == cell["config"]][0]
    assert sorted(entry["reduced"]) == sorted(cfg["changed"])
    e2e = [m["name"] for m in spec.end_to_end_for(name)]
    assert "setup_s" in e2e and len(e2e) >= 2 and spec.per_layer_for(name)
    assert set(cell["limits"]) and all(isinstance(k, str) for k in cell["limits"])


@pytest.mark.parametrize("metric", [m["name"] for m in spec.benchmark()["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(spec.load_module("metrics", metric).read)


def test_configs_are_the_program_configs_with_the_listed_changes():
    import yaml

    for path in glob.glob(os.path.join(BENCH, "configs", "*.json")):
        with open(path) as f:
            c = json.load(f)
        with open(os.path.join(spec.ROOT, c["program_config"])) as f:
            source = yaml.safe_load(f)
        for key, change in c["changed"].items():
            sec, k = key.split(".")
            assert (source.get(sec) or {}).get(k) == change["source"]
            source[sec][k] = change["run"]
        assert source == c["config"]


# -- counts ----------------------------------------------------------------------
def test_counts_against_hand_counts():
    s = dims(spec.cell("stride1_train")["config_file"]["config"])
    b = dims(spec.cell("vitb16_train")["config_file"]["config"])
    assert (s.seq, s.head_dim, s.flash, b.seq, b.head_dim, b.flash) == (4066, 64, True, 197, 64,
                                                                       False)
    # stride1, one spectrum: 3 layers of 8TH^2 + 4T^2H + 4THI, the patch embedding, the head
    layer = 8 * 4066 * 128**2 + 4 * 4066**2 * 128 + 4 * 4066 * 128 * 512
    one = 3 * layer + 2 * 4065 * 32 * 128 + 2 * 128
    assert counts.model_flops(s, 16, True) == pytest.approx(48 * one)
    assert counts.model_flops(s, 1000, False) == pytest.approx(1000 * one)
    layer = 8 * 197 * 768**2 + 4 * 197**2 * 768 + 4 * 197 * 768 * 3072
    one = 12 * layer + 2 * 196 * 768 * 768 + 2 * 768 * 1000
    assert counts.model_flops(b, 128, True) == pytest.approx(3 * 128 * one)
    assert counts.model_flops(b, 128, True) == pytest.approx(13.48e12, rel=1e-3)
    # K1 at B16 H2 T4066 d64: 4BHT^2d; K4 + K5: 10BHT^2d; bytes read and written once
    f, e, n = counts.attention_fwd(16, 2, 4066, 64)
    assert (f, e, n) == (4 * 32 * 4066**2 * 64, 32 * 4066**2, 32 * 4066 * (4 * 64 * 2 + 4))
    f, e, n = counts.attention_bwd(16, 2, 4066, 64)
    assert (f, e, n) == (10 * 32 * 4066**2 * 64, 32 * 4066**2, 32 * 4066 * (7 * 64 * 2 + 8))
    assert counts.least_seconds(*counts.attention_fwd(16, 2, 4066, 64)) == pytest.approx(
        0.13694e-3, rel=1e-3)
    assert counts.least_seconds(*counts.attention_bwd(16, 2, 4066, 64)) == pytest.approx(
        0.34235e-3, rel=1e-3)


@pytest.mark.parametrize("name", ["stride1_train", "vitb16_train"])
def test_flops_match_the_programs_count(name):
    from vit_tpu_torch.models.builder import get_model, step_matmul_flops

    cfg = copy.deepcopy(spec.cell(name)["config_file"]["config"])
    cfg["model"]["num_hidden_layers"] = 1
    vc = get_model(copy.deepcopy(cfg)).vit_config
    d = dims(cfg)
    assert counts.model_flops(d, 7, True) == pytest.approx(step_matmul_flops(vc, 7, True))


# -- the hash ---------------------------------------------------------------------
def test_frozen_hash_is_the_ports():
    from vit_tpu_torch.ops.dropout import hash_dropout_mask, hash_keep_mask

    for shape, row0 in (((3, 5, 7), 0), ((2, 3, 4, 5), 6), ((4, 9, 16), 2**20)):
        want = hash_keep_mask(shape, 0.1, -123456789 & 0x7FFFFFFF,
                              offsets=(row0,) + (0,) * (len(shape) - 1) if row0 else None)
        got = reference.coord_mask(shape, -123456789 & 0x7FFFFFFF, 0.1, row0, "cpu")
        assert torch.equal(got, want)
    b, h, t, seed, row0 = 3, 2, 37, 987654321, 5
    got = reference.attention_mask(b, h, t, seed, 0.1, row0, "cpu")
    bh = torch.arange(row0 * h, (row0 + b) * h)
    want = hash_dropout_mask(t, t, bh, seed, 0.1).view(b, h, t, t)
    assert torch.equal(got, want)


def test_first_epoch_rows_and_seeds_are_the_programs():
    from vit_tpu_torch.data.pipeline import epoch_permutation

    assert np.array_equal(reference.epoch_rows(2048, 16, 128, 12345),
                          epoch_permutation(2048, 16, 128, 12345, 0))
    g = torch.Generator().manual_seed(777)
    want = torch.randint(0, 2**31 - 1, (128, 1, 10), generator=g)[:, 0].numpy()
    assert np.array_equal(reference.epoch_seeds(777, 128, 10), want)


# -- runs at a tiny size on the CPU --------------------------------------------------
def tiny(fp32=False, limits=None, fused=None):
    def apply(cell):
        c = copy.deepcopy(cell)
        cfg = c["config_file"]["config"]
        m, t, data = cfg["model"], cfg["train"], cfg["data"]
        if fused is not None:
            t["fused_epoch"] = fused
        if m.get("input_kind") == "image":
            m.update(image_size=32, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=128, num_labels=10)
        else:
            m.update(image_size=256, stride_size=4, num_hidden_layers=2)
        t["batch_size"] = 8
        if fp32:
            t["precision"] = "fp32"
        data.update(num_samples=32, num_test_samples=8)
        c["params"].update(rows_per_call=20, pool_calls=2, batch_size=8, check_rows=8,
                           ref_block_rows=4, trace_calls=2)
        if limits is not None:
            c["limits"] = {k: limits for k in c["limits"]}
        return c
    return apply


def run_cpu(name, trace=0, seed=2147483901, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = runner.main(["--workload", name, "--seed", str(seed), "--seconds", "0.5",
                          "--trace", str(trace)], t_start=time.perf_counter(), device="cpu",
                         cell_override=tiny(**kw))
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), lines


@pytest.mark.parametrize("name,fused", [(c, None) for c in CELLS] + [(c, True) for c in TRAIN])
def test_reference_matches_the_ports_cpu_path_in_fp32(name, fused):
    """fp32 on both sides: the reference's masks, rows, seeds, loss, clip
    and AdamW (or forward and denormalisation) are the program's, to
    rounding; on the path the cell runs, and for training on the fused
    epoch too (the program's default for data under 4 GB)."""
    rc, line, _ = run_cpu(name, fp32=True, limits=1e-5, fused=fused)
    assert rc == 0
    assert line["correct"], line["checks"]
    assert all(c["value"] < 1e-5 for c in line["checks"].values())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["stride1_train", "stride1_predict"])
def test_last_line_schema(name, trace):
    rc, line, lines = run_cpu(name, trace=trace, limits=1.0)
    assert rc == 0
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert any(x.startswith("counters ") for x in lines)
    else:
        want = {m["name"] for m in spec.end_to_end_for(name)}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


FAULTS = {
    # a step that returns its state unchanged
    "state_unchanged": ("stride1_train", "torch.optim.AdamW.step",
                        lambda orig: (lambda self, *a, **k: None)),
    # half of the batch left out, the mean taken over the rest
    "half_batch": ("vitb16_train", "vit_tpu_torch.train.loop.compute_loss",
                   lambda orig: (lambda logits, labels, *a, **k: orig(
                       logits[:len(logits) // 2], labels[:len(labels) // 2], *a, **k))),
    # an answer altered where it is produced
    "answer_altered": ("stride1_predict", "vit_tpu_torch.serve.Predictor._batched_logits",
                       lambda orig: (lambda self, x: _bump(orig(self, x)))),
}


def _bump(y):
    return y + 0.5  # every served value moved by half the label range


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    """The cell's own limits, a run on the CPU with the fault planted
    underneath the timed path: ``correct`` comes out false."""
    name, target, make = FAULTS[fault]
    module, attr = target.rsplit(".", 1)
    try:
        owner = importlib.import_module(module)
    except ModuleNotFoundError:
        mod, cls = module.rsplit(".", 1)
        owner = getattr(importlib.import_module(mod), cls)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    limits = spec.cell(name)["limits"]
    rc, line, _ = run_cpu(name, fp32=True, seed=31337)
    assert rc == 0
    assert not line["correct"]
    for n, c in line["checks"].items():
        assert c["limit"] == limits[n]


@pytest.mark.parametrize("name", TRAIN)
def test_training_control_reads_above_the_program(name):
    """At a tiny size the fp8 reference departs from the fp32 reference by
    more than the bf16 program does, in at least one number."""
    from benchlib import runner as r

    ctl = spec.load_module("drivers", "train")
    cell = tiny()(spec.cell(name))
    args = r.parse(["--workload", name, "--seed", "99", "--seconds", "0.5"])
    low = ctl.control(r.context(args, time.perf_counter(), torch.device("cpu"), cell))
    _, line, _ = run_cpu(name, seed=99, limits=1.0)
    prog = {n: c["value"] for n, c in line["checks"].items()}
    assert any(low["numbers"][n] > 3 * prog[n] for n in prog)


def test_a_cells_regressor_bias_is_in_the_weights_both_sides_get():
    """``regressor_bias`` in a cell's parameters sets the head's bias in the
    one set of weights that the program loads and the reference starts
    from; the other weights are the seed's draw."""
    from benchlib import inputs
    from benchlib import runner as r
    from benchlib.dims import dims

    drv = spec.load_module("drivers", "train")
    cell = tiny()(spec.cell("stride1_train"))
    args = r.parse(["--workload", "stride1_train", "--seed", "77", "--seconds", "0.5"])
    ctx = r.context(args, time.perf_counter(), torch.device("cpu"), cell)
    d = dims(ctx.config)
    w = drv._weights(ctx, d)
    drawn = inputs.weights(d, inputs.generator(77, torch.device("cpu"), 0), torch.device("cpu"))
    assert torch.all(w["regressor.bias"] == cell["params"]["regressor_bias"])
    assert all(torch.equal(w[n], drawn[n]) for n in drawn if n != "regressor.bias")


# -- the no-JAX rule ---------------------------------------------------------------------
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "vit_tpu_torch_extra", types.ModuleType("x"))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vit_tpu.models", types.ModuleType("x"))
    assert runner.forbidden_modules() == ["vit_tpu"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_harness_sources_import_no_jax_and_the_reference_none_of_the_program():
    files = [p for p in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
             if "/tests/" not in p]
    for p in files:
        assert not set(_imports(p)) & set(runner.FORBIDDEN), p
        with open(p) as f:
            text = f.read()
        assert "bench.py" not in text and "chip_smoke" not in text, p
    for name in ("reference.py", "checks.py", "counts.py", "dims.py", "inputs.py"):
        assert "vit_tpu_torch" not in set(_imports(os.path.join(BENCH, "benchlib", name)))


# -- on the card ----------------------------------------------------------------------
@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's program runs its CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    """The control at the cell's own size, one seed: not correct."""
    import calibrate

    (r,) = calibrate.readings(name, "control", [4242], 3.0)
    verdict = checks.verdict(r["numbers"], r["limits"])
    assert not all(v["ok"] for v in verdict.values()), verdict
