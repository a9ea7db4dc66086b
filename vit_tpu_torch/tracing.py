"""Profiler spans at the port's layer boundaries.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
``torch.profiler`` runs in the process (the benchmark's ``--trace 1``,
``train.profile``, or one an operator starts) and one shared no-op context
otherwise: with no profiler a span costs a flag read, not a
``record_function`` enter and exit. The flag is the profiler's own, which
autograd's backward threads see too, so the op wrappers' backward spans are
recorded. There is no switch of its own: a span is recorded exactly when a
profiler runs, lands as a ``user_annotation`` event in the profiler's Chrome
trace, beside the device's kernels and on the same clock, and leaves with
that trace. A count is the number of spans of a name in a trace.

The spans, each on host work (names ``vtt.``):

* ``vtt.train.step``: all of :meth:`~vit_tpu_torch.train.loop.Experiment.
  train_step`, from the seed draws to the frozen preprocessor's restore;
  inside it ``vtt.train.forward_backward`` (the loss, the gradients and
  their reduction over the mesh) and ``vtt.train.optimizer`` (the clip, the
  learning rate, the optimizer's step);
* ``vtt.train.grad_sync``: :meth:`~vit_tpu_torch.train.loop.Experiment.
  reduce_gradients` on a mesh of more than one rank (the gradients and the
  loss averaged over ``data``, the replicated pipeline's exchange), inside
  ``vtt.train.forward_backward``; ``vtt.train.zero1_gather``: ZeRO-1's
  all-gather of the stepped blocks and their copy back into the parameters
  (:meth:`~vit_tpu_torch.train.optim.Zero1Optimizer.step`), inside
  ``vtt.train.optimizer``;
* ``vtt.comm.<op>``: each collective of :mod:`vit_tpu_torch.parallel.comm`
  (``all_reduce``, ``all_gather``, ``broadcast``, ``broadcast_bucket``,
  ``exchange``, ``all_gather_object``) over a group of more than one rank;
  a one-rank run records none of these;
* ``vtt.input``: one batch's pull from its iterator (a ``Batcher``'s numpy
  gather) and its copy toward the device (pin, non-blocking copy), in
  :func:`~vit_tpu_torch.data.pipeline.prefetch_to_device`;
* ``vtt.train.validate``: an epoch's validation, the forward and the
  metrics (per step), or the metrics of the fused epoch's logits;
* ``vtt.train.epoch_end``: the rest of an epoch's host work after its last
  step: the losses' read-back and the epoch's metrics before validation;
  the plateau, early stopping and the checkpoint after it. The epoch's log
  comes after the last;
* ``vtt.op.<kernel>``: the host side of the custom ops on the training
  path: ``flash_fwd``, ``short_fwd``, ``flash_bwd``, ``short_bwd``,
  ``fused_mlp_fwd``, ``fused_mlp_bwd`` (the autograd functions' forward and
  backward) and ``site_dropout``;
* ``vtt.predict.call``: one :meth:`~vit_tpu_torch.serve.Predictor.predict`
  or ``predict_proba``; inside it, for each batch, ``vtt.predict.stage``
  (padding, ``torch.from_numpy``, the copy to the device),
  ``vtt.predict.forward`` (the module's forward) and
  ``vtt.predict.readback`` (the logits to numpy).

No span lies in code that ``torch.export`` traces (the model's forward):
an exported artifact holds no profiler op.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a profiler span while a profiler
    runs, else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
