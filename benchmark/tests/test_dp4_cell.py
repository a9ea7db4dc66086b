"""The data-parallel cell ``vitl16_dp4_train`` on the CPU: its readers on
synthetic traces, a traced run of four gloo ranks at a tiny size, and the
planted faults its limits must catch there.
"""

import copy
import io
import json
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from benchlib import collectives, runner, spec
from benchlib.dims import dims
from benchlib.trace import Trace
from test_bench_harness import tiny

CELL = "vitl16_dp4_train"
DP4 = [m["name"] for m in spec.benchmark()["per_layer"] if CELL in m.get("workloads", [])]


def _read(metric, trace, d=None):
    d = d or dims(spec.cell(CELL)["config_file"]["config"])
    return spec.load_module("metrics", metric).read(trace, d, {})


def _trace(device, host=(), span=1.0, steps=2):
    return Trace(span_s=span, device=sorted(device), host=list(host),
                 counts={"train_steps": steps, "val_batches": 1, "val_batch_rows": 512,
                         "ranks": 4})


def test_the_cell_reports_its_readers():
    """Its five readers, and the spectra training cell's that move the rate
    this cell reports and read what any per-step fit records."""
    assert sorted(DP4) == sorted(
        ["mfu.train.dp4", "idle_share.train.dp4", "comm_share.train.dp4",
         "comm_exposed_share.train.dp4", "grad_allreduce_roofline.train.dp4"]
        + [f"{m}.train.spectra" for m in ("elementwise_share", "host_step_ms", "input_share",
                                          "validate_share", "op_host_share")])


def test_the_roofline_share_reaches_100_only_at_the_least_time():
    d = dims(spec.cell(CELL)["config_file"]["config"])
    least = collectives.grad_bytes(d) / collectives.NVLINK_BYTES_PER_S
    # ViT-L/16's 304.3 M parameters and the loss, fp32, at 450 GB/s
    assert collectives.grad_bytes(d) == 4 * (304326632 + 1)
    flag = ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 0.0, 1e-6)
    for scale, want in ((1.0, 100.0), (2.0, 50.0), (4.0, 25.0)):
        ks = [(0.1, 0.1 + scale * least, "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)"),
              (0.5, 0.5 + scale * least * 1.01, "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)"),
              (0.9, 0.9 + flag[2], flag[0]),
              (0.2, 0.3, "ncclDevKernel_AllGather_RING_LL(x)")]
        got = _read("grad_allreduce_roofline.train.dp4", _trace(ks), d)
        assert got <= 100.0 and got == pytest.approx(want / 1.005, rel=1e-9)


def test_the_exposed_share_is_within_the_comm_share():
    ks = [(0.00, 0.30, "sm90_xmma_gemm_bf16"), (0.20, 0.40, "ncclDevKernel_AllReduce_Sum_f32"),
          (0.35, 0.45, "Memcpy HtoD (Pinned -> Device)"),
          (0.50, 0.60, "ncclDevKernel_AllGather_RING"), (0.55, 0.70, "ncclDevKernel_AllGather_RING"),
          (0.65, 0.66, "void at::native::elementwise_kernel")]
    t = _trace(ks)
    comm = _read("comm_share.train.dp4", t)
    exposed = _read("comm_exposed_share.train.dp4", t)
    assert comm == pytest.approx(40.0)  # 0.20-0.40 and 0.50-0.70
    assert exposed == pytest.approx(100 * (0.05 + 0.15 + 0.04))
    assert exposed <= comm
    assert _read("idle_share.train.dp4", t) == pytest.approx(35.0)


def test_device_readers_find_nothing_without_nccl():
    t = _trace([(0.0, 0.5, "sm90_xmma_gemm_bf16"), (0.6, 0.7, "Memcpy HtoD")])
    for m in ("comm_share.train.dp4", "comm_exposed_share.train.dp4",
              "grad_allreduce_roofline.train.dp4"):
        assert _read(m, t) is None, m


def test_mfu_divides_the_global_step_over_the_ranks():
    from benchlib import counts

    d = dims(spec.cell(CELL)["config_file"]["config"])
    t = _trace([(0.0, 1.0, "k")], span=10.0, steps=8)
    want = (8 * counts.model_flops(d, 1024, True) / 4 + counts.model_flops(d, 512, False))
    assert _read("mfu.train.dp4", t, d) == pytest.approx(100 * want / 10.0 / 989e12)


def _run(trace=0, fault=None, seed=2147483901):
    def apply(cell):
        c = tiny(fp32=True)(cell)
        c["params"]["fault"] = fault
        return c

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = runner.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                          "--trace", str(trace)], t_start=time.perf_counter(), device="cpu",
                         cell_override=apply)
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), lines


def test_a_traced_run_reads_the_programs_spans():
    rc, line, lines = _run(trace=1)
    assert rc == 0 and line["correct"], line["checks"]
    # the CPU profiler records no device event: the span readers find theirs, and
    # the MFU reads the span alone
    shares = {f"{m}.train.spectra" for m in ("input_share", "validate_share", "op_host_share")}
    assert set(line["metrics"]) == shares | {"host_step_ms.train.spectra", "mfu.train.dp4"}
    assert all(0 < line["metrics"][m]["value"] < 100 for m in shares | {"mfu.train.dp4"})
    assert line["metrics"]["host_step_ms.train.spectra"]["value"] > 0
    counters = json.loads(next(x for x in lines if x.startswith("counters "))[9:])
    assert counters["backend"] == "gloo" and counters["world"] == 4
    stats = counters["comm_stats_rank0"]
    assert stats["staged_bytes"] == 0
    assert stats["ops"]["all_reduce"]["calls"] >= counters["window_steps"]


@pytest.mark.parametrize("fault", ["fault:skip_sync", "fault:half_batch"])
def test_a_planted_fault_is_not_correct(fault):
    """The cell's own limits; the fault planted in the ranks' own processes
    (``skip_sync``: the last rank, a started one, keeps its own gradient)."""
    limits = spec.cell(CELL)["limits"]
    rc, line, _ = _run(fault=fault, seed=31337)
    assert rc == 0
    assert not line["correct"]
    for n, c in line["checks"].items():
        assert c["limit"] == limits[n]
    assert np.isfinite([c["value"] for c in line["checks"].values()]).all()


def test_the_control_is_the_one_card_drivers():
    drv = spec.load_module("drivers", "train_dp")
    cell = tiny()(copy.deepcopy(spec.cell(CELL)))
    args = runner.parse(["--workload", CELL, "--seed", "99", "--seconds", "0.5"])
    low = drv.control(runner.context(args, time.perf_counter(), torch.device("cpu"), cell))
    assert set(low["numbers"]) >= set(cell["limits"])
