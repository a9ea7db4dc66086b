"""PyTorch/CUDA port of ``vit_tpu``: the spectra ViT served and trained on an NVIDIA H100.

The package mirrors ``vit_tpu``'s layout (``config``, ``models``, ``ops``,
``train``, ``data``, ``viz``, ``serve``) so each module has a counterpart
there. Plain tensor code is PyTorch; each Pallas kernel of ``vit_tpu``
is a hand-written CUDA C++ kernel under ``csrc/`` (built at first use by
:mod:`vit_tpu_torch.ops._build`), with a plain PyTorch version of the same
function beside it that CPU tensors take.

Entry points run on the card unless the caller passes ``device="cpu"``:

* :class:`vit_tpu_torch.serve.Predictor` (``from_checkpoint(..., device=)``)
* :class:`vit_tpu_torch.train.loop.Experiment` (``device=``): ``fit``, ``test``, ``run``
* ``python -m vit_tpu_torch run|test|predict|lr|sweep ... [--device cuda|cpu]``
  (``lr``: :class:`vit_tpu_torch.opt.parallel_sweep.ParallelSweepRunner`)
* :func:`vit_tpu_torch.prepca.stats.compute_covariance_stats` (``device=``):
  the statistics a ``warmup.preprocessor`` reads from ``warmup.cov_path``
* the offline statistics of :mod:`vit_tpu_torch.prepca` (``compute_pca``,
  ``compute_kernel_pca``, ``ZCAWhitening``, ``compute_pcp``,
  ``PreprocessingPipeline``, ``KPCAWarmSelfAttention``; ``device=``) and
  ``python -m vit_tpu_torch.prepca.precompute_pca|precompute_kpca ...
  [--device cuda|cpu]``; :class:`vit_tpu_torch.spectro.SVDDenoiser`
"""

__version__ = "0.1.0"
