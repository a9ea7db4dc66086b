"""Checkpoints: best/last torch files with atomic pointers, and their
metadata (port of ``vit_tpu/train/checkpoint.py``).

Layout, as ``vit_tpu`` lays out its orbax checkpoints::

    <ckpt_dir>/<model_name>/
        best        symlink -> .versions/best-<n>
        last        symlink -> .versions/last-<n>
        .versions/  one directory per save, holding ``state.pt``
        meta.yaml   monitor name/mode, best value/epoch, last epoch, config,
                    label-norm stats, plateau and early-stop states

Every save lands in a fresh version directory (written to a temporary name
and renamed into place), and only then does the ``best``/``last`` symlink
flip to it with ``os.replace``, one atomic rename; the superseded version
is deleted after the pointer has moved off it. A crash at any point leaves
the previous pointer and its target whole, so ``--ckpt last`` always finds
a complete file.

``train.async_ckpt`` (``async_save``, ``vit_tpu/train/checkpoint.py:63-79,
151-215``): the snapshot of the state to host memory stays synchronous (a
copy of every tensor, so later steps cannot change what is written), the
write of the version directory runs on a background thread, at most one
at a time, and the pointer flips wait until their write has landed.
:meth:`CheckpointManager.wait` fences every read-back (test, restore,
artifact upload). Both modes write the same bytes.

``state.pt`` holds the model's state dict under ``state_dict`` (the HF keys,
so :class:`vit_tpu_torch.serve.Predictor` serves it) beside the training
state: optimizer state, step, ``plateau_scale``, the plateau and
early-stop states and the dropout and noise generators' states. Orbax
checkpoints of ``vit_tpu`` cannot be read without orbax: convert one to a
``.pt`` with ``scripts/convert.py --export``.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["CheckpointManager", "default_ckpt_dir", "read_meta", "ORBAX_HINT", "STATE_FILE"]

ORBAX_HINT = (
    "vit_tpu_torch reads torch .pt/.pth/.ckpt state dicts and its own best/last "
    "checkpoints only; convert an orbax checkpoint first: python scripts/convert.py "
    "-f CONFIG --export --ckpt best --out model.pt"
)
STATE_FILE = "state.pt"


def default_ckpt_dir() -> str:
    """``$CKPT_DIR`` env or ``./checkpoints``."""
    return os.environ.get("CKPT_DIR", "./checkpoints")


def read_meta(ckpt_dir: str, model_name: str) -> dict:
    """``<ckpt_dir>/<model_name>/meta.yaml`` as a dict; ``{}`` when absent
    (``yaml`` is imported only when the file exists)."""
    path = os.path.join(os.path.abspath(ckpt_dir), model_name, "meta.yaml")
    if not os.path.exists(path):
        return {}
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


class CheckpointManager:
    """best + last checkpoints keyed on a monitored metric."""

    def __init__(self, root_dir: str, model_name: str, monitor: str = "mae", mode: str = "min",
                 enabled: bool = True, async_save: bool = False) -> None:
        self.root_dir = root_dir
        self.model_name = model_name
        self.dir = os.path.abspath(os.path.join(root_dir, model_name))
        self.monitor = monitor
        self.mode = mode
        self.enabled = enabled
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        # (pointer, committed version) pairs whose flip waits for the write.
        self._pending: List[Tuple[str, str]] = []
        # Best is tracked in memory per run; --ckpt resume seeds it from meta.
        self.best_value: Optional[float] = None
        self.best_epoch: Optional[int] = None
        self._counter = 0
        if enabled:
            os.makedirs(self.dir, exist_ok=True)
            self._counter = self._scan_version_counter()

    @property
    def best_path(self) -> str:
        return os.path.join(self.dir, "best")

    @property
    def last_path(self) -> str:
        return os.path.join(self.dir, "last")

    def _meta_path(self) -> str:
        return os.path.join(self.dir, "meta.yaml")

    def _version_root(self) -> str:
        return os.path.join(self.dir, ".versions")

    def _scan_version_counter(self) -> int:
        """Continue numbering past any version already on disk."""
        n = 0
        if os.path.isdir(self._version_root()):
            for name in os.listdir(self._version_root()):
                tail = name.rsplit("-", 1)[-1]
                if tail.isdigit():
                    n = max(n, int(tail))
        return n

    def load_best_from_meta(self) -> None:
        """Seed the best tracker from a previous run's meta (resume only)."""
        meta = self.read_meta()
        self.best_value = meta.get("best_value")
        self.best_epoch = meta.get("best_epoch")

    def read_meta(self) -> dict:
        return read_meta(self.root_dir, self.model_name)

    def _write_meta(self, epoch: int, config: Optional[dict], extra: Optional[dict]) -> None:
        import yaml

        meta = {"monitor": f"val_{self.monitor}", "mode": self.mode,
                "best_value": self.best_value, "best_epoch": self.best_epoch,
                "last_epoch": epoch}
        if config is not None:
            meta["config"] = config
        if extra:
            meta.update(extra)
        tmp = f"{self._meta_path()}.tmp"
        with open(tmp, "w") as f:
            yaml.safe_dump(meta, f, sort_keys=False)
        os.replace(tmp, self._meta_path())

    def wait(self) -> None:
        """Fence: block until the write in flight has landed, then flip the
        pointers that wait for it. Re-raises the writer's error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise RuntimeError("checkpoint write failed") from err
        self._flip_pending()

    def _flip_pending(self) -> None:
        """Point each pending pointer at its committed version (one atomic
        rename) and delete the version it pointed at before."""
        pending, self._pending = self._pending, []
        for pointer, version in pending:
            old = os.path.realpath(pointer) if os.path.islink(pointer) else None
            link_tmp = f"{pointer}.lnk-{self._counter:08d}"
            if os.path.lexists(link_tmp):
                os.remove(link_tmp)
            os.symlink(version, link_tmp)
            os.replace(link_tmp, pointer)  # atomic pointer flip
            if old and old != version and os.path.exists(old):
                shutil.rmtree(old, ignore_errors=True)

    def _write(self, version: str, state: Dict[str, Any]) -> None:
        import torch

        try:
            tmp_dir = f"{version}.tmp"
            shutil.rmtree(tmp_dir, ignore_errors=True)
            os.makedirs(tmp_dir)
            torch.save(state, os.path.join(tmp_dir, STATE_FILE))
            os.replace(tmp_dir, version)  # the version is whole before anything names it
        except Exception as e:  # re-raised by wait()
            self._write_error = e

    def _save(self, pointer: str, state: Dict[str, Any]) -> None:
        self.wait()  # at most one write in flight; its flips happen now
        os.makedirs(self._version_root(), exist_ok=True)
        self._counter += 1
        version = os.path.join(self._version_root(),
                               f"{os.path.basename(pointer)}-{self._counter:08d}")
        snapshot = _snapshot(state)
        self._pending.append((pointer, version))
        if self.async_save:
            self._writer = threading.Thread(target=self._write, args=(version, snapshot),
                                            name="checkpoint-writer", daemon=False)
            self._writer.start()
        else:
            self._write(version, snapshot)
            self.wait()

    def _improved(self, value: Optional[float]) -> bool:
        if value is None:
            return False
        if self.best_value is None:
            return True
        return value < self.best_value if self.mode == "min" else value > self.best_value

    def on_epoch_end(self, state: Dict[str, Any], epoch: int, metric_value: Optional[float],
                     config: Optional[dict] = None, extra: Optional[dict] = None) -> bool:
        """Save ``last`` (and ``best`` when the monitor improved); returns
        whether this epoch became the new best. Tracks best when disabled."""
        improved = self._improved(metric_value)
        if improved:
            self.best_value, self.best_epoch = metric_value, epoch
        if not self.enabled:
            return improved
        self._save(self.last_path, state)
        if improved:
            self._save(self.best_path, state)
        self._write_meta(epoch, config, extra)
        return improved

    def resolve(self, spec: str) -> str:
        """``'best' | 'last' | <path>`` -> the checkpoint file (a directory
        argument means its ``state.pt``)."""
        path = {"best": self.best_path, "last": self.last_path}.get(spec, os.path.abspath(spec))
        if os.path.isdir(path):
            path = os.path.join(path, STATE_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"Checkpoint not found: {path}")
        return path


def _snapshot(obj: Any) -> Any:
    """A host copy of every tensor in a nest of dicts, lists and tuples."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return obj
