"""Batching and host-to-device prefetch (port of ``vit_tpu/data/pipeline.py``).

Data lives fully in host memory, so batching is numpy slicing, bit-equal
to ``vit_tpu``'s: every batch has exactly ``batch_size`` rows; train batches
shuffle with ``epoch_permutation`` and cycle from the epoch start to fill
the last batch, eval batches repeat the last row and carry a boolean
``mask`` of the real rows. ``prefetch_to_device`` copies batches from
pinned host memory to the card with ``non_blocking=True``, ``size``
batches ahead of the consumer, so the copy of the next batch overlaps the
current step.
"""

from __future__ import annotations

import collections
import itertools
from collections.abc import Sized
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

from vit_tpu_torch.tracing import span

__all__ = ["Batcher", "epoch_permutation", "prefetch_to_device"]


def epoch_permutation(
    n: int, batch_size: int, steps_per_epoch: int, seed: int, epoch: int
):
    """The Batcher's shuffle contract as a flat index vector.

    Permutation seeded by ``seed + epoch``; the final partial batch is
    cycled from the epoch's start; length ``steps_per_epoch * batch_size``
    (int32). The fused-epoch, multi-epoch-block, vmapped-sweep, and bench
    paths all gather with this — one implementation keeps them bit-equal
    to the per-step Batcher.
    """
    if n <= 0:
        raise ValueError("epoch_permutation: empty dataset (n == 0)")
    order = np.random.default_rng(seed + epoch).permutation(n)
    total = steps_per_epoch * batch_size
    if total > len(order):
        # Cycle as many times as needed (n < batch_size needs > 1 extra
        # cycle; a single-cycle pad produced a short vector that crashed
        # the fused-epoch reshape). Bit-equal to the old pad when one
        # cycle suffices.
        order = np.tile(order, -(-total // len(order)))
    return np.asarray(order[:total], np.int32)


class Batcher:
    """Iterate dict-of-arrays into fixed-size dict batches.

    Args:
        arrays: column dict, each value shaped ``(N, ...)``.
        batch_size: rows per batch (static).
        shuffle: reshuffle each epoch (train).
        seed: base seed; epoch ``e`` uses ``seed + e``.
        eval_mode: pad with repeated rows + emit a ``mask`` column instead of
            cycling.
        drop_last: drop the partial batch instead of padding.
    """

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        eval_mode: bool = False,
        drop_last: bool = False,
    ) -> None:
        if not arrays:
            raise ValueError("Batcher needs at least one array column")
        self.arrays = arrays
        self.n = int(next(iter(arrays.values())).shape[0])
        for k, v in arrays.items():
            if v.shape[0] != self.n:
                raise ValueError(f"Column '{k}' has {v.shape[0]} rows, expected {self.n}")
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.eval_mode = eval_mode
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _order(self) -> np.ndarray:
        if self.shuffle:
            # epoch_permutation with total == n is exactly the shuffled order;
            # sharing it keeps per-step and fused paths bit-equal by
            # construction (vit_tpu's tests/test_fused_epoch.py).
            return epoch_permutation(self.n, self.n, 1, self.seed, self.epoch)
        return np.arange(self.n)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        bs = self.batch_size
        n_batches = len(self)
        if self.shuffle and not self.eval_mode and not self.drop_last:
            # Canonical shuffle+cycle contract, one implementation
            # (epoch_permutation) for this and every fused path.
            flat = epoch_permutation(self.n, bs, n_batches, self.seed, self.epoch)
            for b in range(n_batches):
                idx = flat[b * bs : (b + 1) * bs]
                yield {k: v[idx] for k, v in self.arrays.items()}
            self.epoch += 1
            return
        order = self._order()
        for b in range(n_batches):
            idx = order[b * bs : (b + 1) * bs]
            n_real = idx.shape[0]
            if n_real < bs and not self.drop_last:
                if self.eval_mode:
                    pad = np.repeat(idx[-1:], bs - n_real)
                else:
                    # cycle from epoch start, repeating if n < batch_size
                    pad = np.resize(order, bs - n_real)
                idx = np.concatenate([idx, pad])
            batch = {k: v[idx] for k, v in self.arrays.items()}
            if self.eval_mode:
                mask = np.zeros(bs, dtype=bool)
                mask[:n_real] = True
                batch["mask"] = mask
            yield batch
        self.epoch += 1


def prefetch_to_device(batches: Iterable[Dict[str, np.ndarray]], device,
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield each numpy batch as tensors on ``device``, issuing the copies
    of up to ``size`` batches ahead. On the card a batch is first copied
    into pinned host memory, then to the device with ``non_blocking=True``
    on the current stream, so later kernels on that stream see it whole.

    Each batch's pull from ``batches`` (a ``Batcher``'s gather) and its copy
    is one ``vtt.input`` span (:mod:`vit_tpu_torch.tracing`). Where
    ``batches`` has a length (a ``Batcher``, a list), exactly that many are
    pulled under a span, and the iterator is then run to its end outside
    one; an iterator without a length records one last, empty span."""
    device = torch.device(device)
    n = len(batches) if isinstance(batches, Sized) else None
    iterator = iter(batches)

    def _put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    def _pulls():
        for _ in itertools.count() if n is None else range(n):
            with span("vtt.input"):
                batch = next(iterator, None)
                if batch is None:
                    return
                out = _put(batch)
            yield out
        next(iterator, None)  # a Batcher counts its epoch at its end

    pulls = _pulls()
    queue = collections.deque(itertools.islice(pulls, size))
    for out in pulls:
        queue.append(out)
        yield queue.popleft()
    while queue:
        yield queue.popleft()
