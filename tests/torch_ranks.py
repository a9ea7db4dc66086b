"""A group of gloo ranks for the port's parallel tests (on the CPU, or
sharing the card in ``tests/test_torch_port_cuda.py``), and the work they
run.

:class:`Ranks` spawns ``world`` processes once (a test module's fixture),
each joined to one gloo process group on a free localhost port, and runs a
function of this module on every rank: ``ranks.run(fn, *args)`` returns
each rank's result, or raises with the failing rank's traceback. The
functions import torch and ``vit_tpu_torch`` only, so a rank starts
without JAX; the tests hold what they return against ``vit_tpu``.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import socket
import traceback

import numpy as np

_TIMEOUT = 120  # seconds a call may take on any rank


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank: int, world: int, port: int, tasks, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=_TIMEOUT))
    while True:
        item = tasks.get()
        if item is None:
            break
        fn, args = item
        try:
            results.put((rank, True, fn(*args)))
        except BaseException:  # noqa: BLE001 - the parent reports it
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class Ranks:
    def __init__(self, world: int) -> None:
        ctx = mp.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_serve, args=(r, world, port, self.tasks[r],
                                                       self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args) -> list:
        for q in self.tasks:
            q.put((fn, args))
        out = [None] * self.world
        for _ in range(self.world):
            try:
                rank, ok, value = self.results.get(timeout=2 * _TIMEOUT)
            except queue.Empty:
                self.close()
                raise AssertionError(f"{fn.__name__}: a rank did not answer")
            if not ok:
                raise AssertionError(f"{fn.__name__} failed on rank {rank}:\n{value}")
            out[rank] = value
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()


# -- work for the ranks ------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


def ring(n: int, data: int, q, k, v, g, rate: float, seed, block_k, device: str = "cpu"):
    """vit_tpu_torch's ring over a (data, n) mesh, on ``device``: this rank's
    rows of the output and of dq, dk, dv (None off the mesh)."""
    import torch

    from vit_tpu_torch.ops.ring_attention import ring_attention
    from vit_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(num_devices=n * data, model_parallel=n)
    if not mesh.member:
        return None
    b = q.shape[0] // data
    rows = slice(mesh.coord("data") * b, (mesh.coord("data") + 1) * b)
    xs = [torch.from_numpy(a[rows]).to(device).requires_grad_(True) for a in (q, k, v)]
    out = ring_attention(*xs, mesh, axis="model", batch_axis="data" if data > 1 else None,
                         dropout_rate=rate, dropout_seed=seed, block_k=block_k)
    (out * torch.from_numpy(g[rows]).to(device)).sum().backward()
    return rows, _np(out), *(_np(x.grad) for x in xs)


def _experiment(cfg, gpus, state_dict=None):
    import torch

    from vit_tpu_torch.parallel.checkpoint import local_state_dict
    from vit_tpu_torch.train.loop import Experiment

    exp = Experiment(cfg, device="cpu", num_devices=gpus, datamodule=object())
    if state_dict is not None and exp.mesh.member:
        full = {k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()}
        exp.module.load_state_dict(local_state_dict(exp.module, full), strict=True)
    return exp


def first_step(cfg, gpus, state_dict, batch, seeds):
    """The step's loss and gradients (after their reductions) in the
    one-rank layout, from rank 0; None elsewhere."""
    import torch

    from vit_tpu_torch.parallel.checkpoint import canonical_grads
    from vit_tpu_torch.parallel.mesh import active_mesh_scope
    from vit_tpu_torch.train.loop import loss_and_grads

    exp = _experiment(cfg, gpus, state_dict)
    if not exp.mesh.member:
        return None
    mesh = exp.mesh
    exp.module.train()
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with active_mesh_scope(mesh):
        loss = loss_and_grads(exp.module, b, exp.bundle.vit_config.task_type,
                              exp.bundle.loss_name, seeds,
                              shard=(mesh.coord("data"), mesh.size("data")))
        loss = exp.reduce_gradients(loss)
        grads = canonical_grads(exp.module, mesh, exp._param_names)
    split = sorted(n for n, p in exp.module.named_parameters() if getattr(p, "_shard", None))
    return (float(loss), {k: _np(v) for k, v in grads.items()}, split) if mesh.rank == 0 else None


def fit(cfg, gpus, n, length, seed, ckpt_dir, ckpt_path=None):
    """``Experiment.fit`` over in-memory spectra (resumed from ``ckpt_path``
    when given): (metrics, the one-rank state_dict, optimizer state bytes
    of this rank) from every rank."""
    os.environ["CKPT_DIR"] = ckpt_dir
    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.parallel.checkpoint import canonical_state_dict
    from vit_tpu_torch.train.loop import Experiment
    from vit_tpu_torch.train.optim import state_bytes

    dm = SpecDataModule(cfg, source=make_dummy_spectra(n=n, length=length, seed=seed))
    exp = Experiment(cfg, device="cpu", num_devices=gpus, datamodule=dm, ckpt_path=ckpt_path)
    metrics = exp.fit()
    if not exp.mesh.member:
        return None
    sd = canonical_state_dict(exp.module, exp.mesh, exp._state_names)
    return metrics, {k: _np(v) for k, v in sd.items()}, state_bytes(exp.optimizer)


def pipeline_forward(cfg, state_dict, x, microbatches: int, moe: bool):
    """vit_tpu_torch's deterministic forward with the encoder pipelined over
    two stages (rank 0's logits, and MoE stats)."""
    import torch

    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.parallel.mesh import make_mesh
    from vit_tpu_torch.parallel.pipeline import apply_pipelined

    mesh = make_mesh(num_devices=2, pipeline_parallel=2)
    if not mesh.member:
        return None
    module = get_model(cfg).module
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    module.eval()
    with torch.no_grad():
        out = apply_pipelined(module, torch.from_numpy(x), mesh=mesh,
                              num_microbatches=microbatches)
    held = sorted({k.split(".")[3] for k in module.state_dict() if k.startswith("vit.encoder.")})
    if moe:
        return _np(out[0]), _np(out[1]), held
    return _np(out), None, held


def restored_state(cfg, gpus, n, length, seed, ckpt_dir, spec):
    """An Experiment over in-memory spectra restored from ``spec`` (best |
    last | PATH) as a resumed fit restores it: rank 0's checkpoint of it
    (the one-rank layout: weights, optimizer state, step), None elsewhere."""
    os.environ["CKPT_DIR"] = ckpt_dir
    import torch

    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.parallel.mesh import active_mesh_scope
    from vit_tpu_torch.train.loop import Experiment
    from vit_tpu_torch.train.optim import OptSpec

    dm = SpecDataModule(cfg, source=make_dummy_spectra(n=n, length=length, seed=seed))
    exp = Experiment(cfg, device="cpu", num_devices=gpus, datamodule=dm)
    if not exp.mesh.member:
        return None
    exp.optimizer = exp._make_optimizer(OptSpec.from_config(cfg, 1))
    with active_mesh_scope(exp.mesh):
        exp._restore(spec, training=True)
        state = exp._state()
    if exp.mesh.rank != 0:
        return None
    as_np = lambda x: (_np(x) if isinstance(x, torch.Tensor) else  # noqa: E731
                       {k: as_np(v) for k, v in x.items()} if isinstance(x, dict) else x)
    return {"state_dict": as_np(state["state_dict"]), "step": state["step"],
            "optimizer": as_np(state["optimizer"]["state"])}


def dp_steps(cfg, state_dict, batches, skip_sync=False):
    """``Experiment.train_step`` over ``batches`` (each the global batch,
    numpy) on every rank of the mesh, under a profiler: (this rank, the
    losses, learning rates, the step-1 gradients as averaged before the clip
    and the parameters after the last step (both in the one-rank names),
    the number of each new span, ``comm.STATS``, and each parameter's
    ZeRO-1 split). ``skip_sync``: the last rank keeps its own gradient (it
    takes part in the all-reduce, then puts its gradients back)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vit_tpu_torch.parallel import comm
    from vit_tpu_torch.parallel.mesh import active_mesh_scope
    from vit_tpu_torch.train import loop
    from vit_tpu_torch.train.optim import OptSpec, schedule_scale

    exp = _experiment(cfg, None, state_dict)
    mesh = exp.mesh
    spec = OptSpec.from_config(cfg, len(batches))
    exp.optimizer = exp._make_optimizer(spec)
    schedule = schedule_scale(spec)
    grads = {}
    orig_clip, orig_sync = loop.clip_by_global_norm, loop.sync_gradients

    def clip(gs, *args, **kwargs):
        if not grads:
            grads.update({n: _np(p.grad).copy() for n, p in exp.module.named_parameters()})
        return orig_clip(gs, *args, **kwargs)

    def own_sync(params, m, extra=None):
        params = list(params)
        own = [p.grad.clone() for p in params]
        out = orig_sync(params, m, extra)
        for p, g in zip(params, own):
            p.grad.copy_(g)
        return out

    loop.clip_by_global_norm = clip
    if skip_sync and mesh.rank == mesh.world_size - 1:
        loop.sync_gradients = own_sync
    comm.reset_stats()
    losses, lrs = [], []
    exp.module.train()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof, active_mesh_scope(mesh):
            for batch in batches:
                loss, lr = exp.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                          spec, schedule)
                losses.append(float(loss))
                lrs.append(float(lr))
    finally:
        loop.clip_by_global_norm, loop.sync_gradients = orig_clip, orig_sync
    spans = {}
    for e in prof.events():
        if e.name in ("vtt.train.grad_sync", "vtt.train.zero1_gather", "vtt.train.step") \
                or e.name.startswith("vtt.comm."):
            spans[e.name] = spans.get(e.name, 0) + 1
    params = {n: _np(p) for n, p in exp.module.named_parameters()}
    split = {n: bool(s) for n, s in zip(exp._param_names, exp.optimizer.split)}
    return (mesh.rank, losses, lrs, grads, params, spans, dict(comm.STATS), split)
