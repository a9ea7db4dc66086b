#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Print the card (``nvidia-smi --query-gpu=name,power.limit``), build every
   CUDA kernel from ``vit_tpu_torch/csrc`` (one nvcc each, in parallel) and
   print the build seconds, ptxas' registers and spills per function, and
   the tensor-core instructions (HGMMA, HMMA) of each function of K1-K7 in
   ``cuobjdump --dump-sass``. The run fails unless every bf16 tensor-core
   instantiation of K1, K2 (``attn_fwd_tc``), K3 (``fused_mlp_tc``) and K7
   (``fused_mlp_bwd_tc``: its dx and weight-gradient passes) holds HGMMA,
   and so does every pass of K3's and K7's wide route
   (``fused_mlp_wide_tc``, 128 < D <= 1024: K3's act and out passes, K7's
   act, out and weight-gradient passes), each of which must be there;
   the bf16 flash backward (K4 and K5 as one pass, ``attn_bwd_fused_tc``)
   and K6's dQ and dK/dV passes (``attn_bwd_tc``) hold exactly their HGMMA
   counts (the one pass 14, 16, 20, 28, K6's dQ 6, 8, 12, 20 and dK/dV 10,
   12, 16, 24 at d = 16, 32, 64, 128: the wgmma in the source, so a
   drift in the shared header shows), and no other instantiation (fp32,
   K3's and K7's bf16 FMA bodies) holds any.
2. Hold each kernel against its plain PyTorch version on the same inputs on
   the card, at the serving and training shapes and a few others, forward
   kernels with and without dropout; one JSON line each with the error, the
   kernel's, the plain version's and the library's device times (``ms``:
   calls back to back behind a spin kernel, so the card never waits for the
   host), the kernel's per-call time (``call_ms``: the median CUDA-event
   time of single calls, host launch overhead included), and the card's
   bound for the work. The library call is SDPA for the forward
   kernels and SDPA's backward (forward+backward minus forward, no
   dropout) for the flash backward and K6; a dropout row adds
   ``library_dropout_ms``, SDPA (or its backward) at the same
   ``dropout_p``: the same rate, other bits. The flash backward (K4 and K5
   as one kernel, ``flash_bwd``) is timed through its wrapper, its dQ
   workspace and counters included. K3
   and K7 have no library call; their rows add ``unfused_ms``, F.linear,
   exact-erf GELU and F.linear in the same dtype (for K7 its autograd
   backward: forward+backward minus forward), and hold the kernel
   bit-repeatable. K7's rows also hold its device memory beyond dx, the
   gradients and the partials: below one (R, F) tensor on the on-chip
   tensor-core body (D <= 128: g and dh stay in registers), at least two
   (g and dh) on the wide and FMA bodies.
   Tolerances: fp32 max-abs 1e-4 with TF32 off for matmuls and cuDNN;
   bf16 on O, y, dq, dk, dv and dx the smaller of 2e-2 and four roundings
   to bf16 (4 * 2**-8) of the largest reference value, since the two round
   in different places. K7's fp32 weight gradients are sums over every row:
   1e-5 of the largest value for fp32 inputs, 1e-3 for bf16 (a g or dh
   rounded to the other side of a boundary moves dW by one bf16 ulp times
   |x| or |dy|; dW rounded to bf16 would be off by up to 2**-9 of it). The typical reference value is printed beside the limit: at
   the stride-1 attention shape |O| is ~0.02, so a fixed 2e-2 would be
   blind. Then the dropout mask check: K1 and K2 with Q = 0 and V the
   identity (T = d = 128, 32 heads, rate 0.5, seeds 0, -1, 2**31-1) give
   O = M/(keep*T), zero exactly where ``hash_dropout_mask`` drops, so a
   single wrong mask bit fails (a tolerance on O at T = 4066 is blind to
   one dropped element): in fp32, and in bf16, where O is exact and held
   bit for bit; and the flash backward and K6 in bf16 with lse = log T and
   delta = 0 passed in: both with Q = 0, K = V = I, dO = 1 give
   dQ = scale*M/(keep*T), both with Q = K = 0, dO = I give
   dV[j, c] = M[c, j]/(keep*T), K6 with Q = K6_Q*I, K = 0, V = I, dO = 1
   gives dK[j, c] = M[c, j]/(keep*T) * bf16(K6_Q*bf16(scale)), all exact in
   bf16 and held bit for bit; then the same with one seed for each of four
   groups of 8 heads (a stacked launch over four replicas, ``bh_per_seed``):
   each group's mask is its own seed's, bit for bit. The kernel rows
   include the image family's shapes: K2/K6 at B128 H6 T65 d64 and K3/K7 at
   R8320 D384 F1536, bf16 (ViT-S/16 on 32-pixel images at batch 128), and
   K3/K7 at ViT-B/16's R12608 D768 F3072 (batch 64) and ViT-L/16's R6304
   D1024 F4096 (batch 32), all three on the wide route; then the wide
   route's bf16 roundings of h, g and dh against float64 beside the plain
   version's (K7's at most 1.25 times as often). The hash dropout kernel
   (``csrc/hash_dropout.cu``, the port's own: no Pallas counterpart) has
   rows at the cells' site shapes in bf16, rate 0.1 (ViT-B/16's B128 H12
   T197 T197 and B128 T197 D768, stride1's B16 T4066 D128; ``--only H``
   prints them alone): its output bit for bit the torch ops' (the plain
   version on the card, ``plain_ms``), and the byte bound (read x, write
   y). The runs below hold its launches too: one a dropout site in each
   training step's forward and backward and in remat's recompute
   (``hash_per_step``), held at the end of the script so that one call
   shows every run's count.
3. Serve the main path through ``Predictor.from_checkpoint(..., device=
   "cuda")`` three times, each from a ``.pt`` written from a port model
   initialised from a seeded ``torch.Generator``: (a) stride1 in bf16
   (streaming flash kernel), (b) stride1 with ``fused_mlp`` (adds the MLP
   kernel), (c) baseline with ``attn_impl: flash`` (short kernel), 64
   spectra at batch 16 each. Launch counts are set to 0 just before each
   served pass and read just after; spectra/s is all spectra of 9 further
   passes over their total time (a smoke figure, not a benchmark), and
   torch.profiler splits one batch's device time by kernel. The first two
   served spectra and two standard-normal probe spectra are held against
   the same model in fp32 on the CPU: the logits, and the final LayerNorm's
   output for every token. With the std-0.02 init the logits barely depend
   on the input and the synthetic spectra barely differ, so the per-token
   features of the probes are what tells one input from another; the run
   fails unless the probes' features lie at least 10 tolerances apart.
4. Train the main path through ``Experiment(config, device="cuda",
   datamodule=...).fit()`` three times, one epoch of 64 synthetic spectra
   (``make_dummy_spectra``, seed 1, held in memory: the card's machine has
   no h5py) at batch 16: (d) stride1.yaml as it stands (bf16, remat: mlp,
   dropout 0.1/0.1: K1 with dropout, K4, K5), (e) baseline.yaml with
   ``attn_impl: flash`` and ``fused_mlp: true`` (fp32: K2 with dropout, K6,
   K3, K7), (f) as (e) in bf16 (K2, K6, K3 and K7 on the tensor cores),
   (g) as (d) with ``fused_mlp: true`` (K1 with dropout, K3, K4, K5, K7 in
   bf16 at the stride-1 width). Counts are set to 0 just before ``fit`` and
   read just after, and must equal layers x (train steps + val batches) for
   the forward kernels and layers x train steps for the backward ones, and
   for K3 in (g) layers x (2 x train steps + val batches): remat: mlp runs
   the MLP again in the backward ((d) has no MLP kernel). Each run
   prints its per-step losses (all finite), steps/s and ms/step (smoke
   figures), peak memory and torch.profiler's split of one further step.
   Before it, on a batch of 4 with fixed dropout seeds, the first step's
   loss and every parameter gradient on the card are held against the same
   step in fp32 on the CPU: relative L2 error per tensor, against the
   larger of the tensor's norm and 1e-3 of the global norm (gradients that
   are zero in exact arithmetic, as the key bias's, are noise in both),
   at most 1e-4 for (e) in fp32 and 2e-2 for (d), (f) and (g) in bf16; and, as in the
   serving runs, a probe batch (four standard-normal spectra with uniform
   random labels) must move the CPU gradients at least 10 limits away.
5. Run the reference's default ``run`` and the long sequence with its
   diagnostics, each reading its YAML file as a user's run does, with
   ``use_wandb=True`` over the same 64 spectra. The card's machine has
   wandb but no network, so the script hides wandb (an import of it
   raises) and the run must print the console-fallback line: (h) baseline.yaml as it
   stands (fp32, ``viz.enable`` with its GIFs, the full test report) with
   batch 16, three epochs, ``train.save`` into a temporary ``CKPT_DIR``:
   a SIGTERM sent to this process at the start of epoch 1 must stop
   ``fit`` at the end of epoch 1 with ``last`` saved, and a resume from
   ``last`` must start at epoch 2; (i) stride1.yaml with baseline's ``viz``
   block, ``compute_cka``, ``train.log_mfu`` against the H100's dense bf16
   peak (989 TFLOP/s) and ``train.profile``, two epochs: the capture batch
   is capped at 3 (``capture_batch_cap(4066, 2, 512, 512 MB)``), the Chrome
   trace of epoch 1 must name K1's, K4's and K5's kernels, and 0 < mfu <=
   1.05. Both run ``.run()`` (fit, then test with its report). Every
   capture is counted (only calls that return count): one an epoch, so the
   loop's "diagnostics skipped" guard cannot hide a failed capture. The
   last capture is held against the same capture of the same weights on
   the same spectra by the port on the CPU at the config's precision, and
   a probe set (standard-normal spectra) is captured on the card and the
   CPU by a direct call: relative L2 per captured tensor (attention
   probabilities, MLP stats and samples, CLS states; the activation
   shares as shares of all elements) at most 1e-4 (h) and 2e-2 (i); the
   CKA monitor's layer-by-layer CKA matrix of the probe capture within
   1e-6 (h) and 1e-2 (i), and of the served one reported (the synthetic
   spectra's CLS states differ by ~1e-5 of their norm, too little for a
   CKA to be held); the probes' activation samples at least 10 limits from
   the served ones. Launch counts exact (a capture launches
   no kernel: flash takes the xla math under capture). Without matplotlib
   on the machine a line says rendering is not exercised there, and only
   "skipped" lines naming matplotlib are allowed; with it, the GIFs, the
   CKA report and the report PNGs must be written.
6. Runs (j)-(o), the options the port adds to that path, each at its
   config's full width and depth on the same synthetic spectra, launch
   counts exact: (j) stride1 with RoPE (bf16, one epoch: K1 with dropout,
   K4, K5; the first step against fp32 on the CPU to 2e-2), then its
   trained weights served in bf16 (held as (a)), and in fp32 the same
   weights without RoPE must move the per-token features at least 10 fp32
   limits; (k) baseline with flash, the fused MLP and RoPE (fp32, one
   epoch: K2, K6, K3, K7; first step to 1e-4); (l) the port's covariance
   statistics of 8192 spectra of 4096 pixels (seed 2) on the card, held
   against the CPU (mean, covariance 1e-5 relative L2; eigenvalues and the
   ZCA matrix 1e-4; ``zca_self_check`` passes), written to a ``.npz``, then
   stride1 behind that ZCA preprocessor (shrinkage 0.1, freeze_epochs 1),
   two epochs with async checkpoints: the first step's gradients, the
   preprocessor's included, against the CPU to 2e-2, the preprocessor
   bit-unchanged through epoch 0 and moved in epoch 1,
   ``preprocessor_frozen`` 1.0 then 0.0, and a fresh Experiment's test of
   ``best`` equal to the run's; (m) stride1 served in bf16 behind PCA (r
   2048, T 2018) and attention (r 1024, T 994, flash) preprocessors, the
   builder's lines vit_tpu's, held as (a); (n) each optimizer three steps
   on the card and the CPU at (e)'s shape, the parameters within 1e-5
   relative L2 (bf16 first moments 2e-2), adamw's state bytes with fp32
   and bf16 moments; (o) (e) with ``fast_dropout: false`` and ``remat:
   true``: K2 and K6 keep the hash mask, the stream sites keep 0.9 of
   their elements within 4 standard deviations, a repeated step and the
   step without remat give the same gradients. ``--only jklmno`` runs the
   build and the named runs alone, for iterating, and prints no result.
   Runs (e), (f), (k), (n), (o) pin ``fused_epoch: false`` (their per-step
   figures and counts); (h) trains as ``auto`` decides (the fused epoch)
   and its row says so; (n) builds the card's optimizers graph-safe, as
   Experiment does there; the mask check also calls each attention kernel
   with the seed as an int32 device scalar and holds it bit for bit.
7. Runs (w), (p), (q), (r), each over more steps: (w) the per-step window,
   stride1 over 1024 spectra (64 steps an epoch) for 3 epochs: host
   ms/step of epochs 1-2, device ms/step of a further profiled window,
   the busy share; (p) baseline's training shape in fp32 and bf16 over the
   same window per step, then with ``fused_epoch: true`` (the step a CUDA
   graph) from the same seed: parameters within vit_tpu's bound (rel 1e-6,
   abs 1e-7; bit-equal printed), in fp32 also ``epoch_gather: block`` and
   ``epochs_per_dispatch: 3``, each path's host and device ms/step, busy
   share, peak MiB (the graph's pool included), capture seconds, the
   replays' device span and host enqueue time a step, and an epoch end's
   cost (the validation forward with its read-back; metrics, plateau and
   early stopping on the host); launches counted as each graph's captured
   launches times its replays, plus the calls outside graphs, 3 a step of
   K2, K6, K3, K7; (q) stride1 through the graph over 256 spectra, 2
   epochs, against the per-step path (relative L2 per tensor within 2e-2),
   K1, K4, K5 counted from the replays; (r) ``lr --engine sequential`` by
   its runner over 256 in-memory spectra: six trials, ``summary.yaml`` and
   ``best_config.yaml`` read back, trial 3 bit-equal to its standalone
   Experiment. Each run's seconds are printed. ``--only`` takes these
   letters too.
8. Runs (s), (s'), (u): (s) ``lr`` with its default engine, vmap, at (r)'s
   shape and grid: the six trials as stacked replicas through one CUDA
   graph of the replica step (K2 and K6 once a layer, the replicas folded
   into the heads with a seed each; K3 and K7 once a layer and replica),
   vit_tpu's summary schema, the sweep's seconds beside (r)'s, device ms per
   replica-step; with dropout off each replica's metric within 1e-4 of its
   sequential trial, and a replica at lr 1e3 'error' (non-finite) with the
   others' metrics unchanged. (s') (``--only v``) K1/K4/K5 over three
   stacked replicas at stride1's shape and K2/K6 at (e)'s, bit for bit
   their single launches and within tolerance of the plain versions; three
   stride1 replicas through the graph. (u) the image family on synthetic
   images at full width: cifar_vit_s16.yaml as it stands (the fused
   epoch), with flash and the fused MLP (per step, exact launches), behind
   patch-PCA statistics made on the card (held against the CPU's), and
   vit_b16_bf16.yaml with flash and the fused MLP at batch 64 (of 1024)
   and 4 of its 12 layers:
   the first step in fp32 on the card against the CPU per tensor (1e-4)
   and in bf16 (2e-2, global relative L2; per tensor reported), one epoch,
   then served in bf16 (features 0.125, logits what that implies through
   the fp32 head) and fp32 (1e-4). ViT-B/16's D768 lies outside
   vit_tpu's fused-MLP envelope, so its fused run takes ``library_mlp``
   and launches no K3/K7 (held exactly). Each model also trains with flash
   and the dense MLP (one step timed), and vit_b16_bf16.yaml as it stands
   (xla attention, dense MLP) at the same batch and layers; a row of the
   six device ms a step: each model with xla + dense, flash + dense and
   flash + the fused MLP.
9. Runs (v), (x), (y): (v) int8 serving (``--only z``; 'v' runs (s')):
   stride1.yaml in bf16 at batch 16, unquantized, int8-w8a8 dynamic,
   calibrated and int8-wo, K1 launched exactly, each held against the same
   variant on the CPU in bf16 (logits 1e-2, features 0.125), with
   spectra/s, device ms a batch, the int8 table's bytes and the device
   bytes held after the strip; then ViT-B/16 (4 of its 12 layers) the same
   four ways at batch 8 and 128 (images/s, device ms a batch: the W8A8 / weight-only route on
   this card). (x) ``Predictor.export`` of stride1 bf16, stride1 with the
   fused MLP, baseline with flash in fp32 and stride1 int8-w8a8, loaded in
   one fresh process that imports no model code: predictions against the
   live ones (1e-6 fp32, 1e-2 bf16), K1, K2, K3 counted inside the loaded
   programs, export seconds and bytes. (y) the repairs: ``opt.type: lbfgs``
   through the vmapped sweep at (s)'s grid (one full-batch step held within
   1e-4 of the sequential trials; at (s)'s batch the gaps reported),
   ``fast_dropout: false`` at (p)'s shape per step and through the CUDA
   graph (parameters bit-equal), and three replicas' masks under vmap in
   a graph bit-equal to single calls with the engine's seeds.
10. Run (z), the Mixture-of-Experts ViT (``--only M``; 'z' runs (v)):
   cifar_vit_s16_moe.yaml at full width (hidden 384, 6 of its 12 layers,
   T 65, 8 experts, top-2, C 21, bf16, batch 128) with ``attn_impl: flash`` and
   ``train.model_parallel: 1``, on synthetic images (512 train, 128 val).
   (z1) The first step on 4 images: the routing on the card against the
   CPU's in bf16 and fp32 (assignments that differ, reported); the same
   weights in fp32 on the card against the CPU per tensor (1e-4); the
   bf16 step at (u)'s per-tensor limits against fp32 on the CPU with the
   card's routing imposed on the CPU steps and the CPU's own bf16 error
   taken over both of its matmul backends (without the imposed routing the
   distance is reported). Two epochs per step, then ``fused_epoch: true``
   from the same seed: parameters bit-equal, K2/K6 launches exact (the
   per-epoch ``moe_dropped_frac`` forward included), host and device ms a
   step, busy share, and the step's device time split by torch.profiler
   into K2+K6, the experts' products, dispatch and combine, and the rest;
   the dense cifar_vit_s16.yaml with the same overrides beside it. (z2) The
   trained weights served at batch 128, bf16 and int8-wo: K2 exact,
   images/s, device ms a batch, the int8 table's bytes, logits and features
   against the same variant on the CPU in bf16 (1e-2, 0.125) with the
   card's routing imposed. (z3) Three 2-layer fp32 replicas through ``lr
   --engine vmap``, each within SWEEP_REL of its sequential trial (val_acc
   and the epoch's training loss). (z4) (z2)'s bf16 predictor exported and
   served by EXPORT_LOADER in a fresh process: against the live logits,
   K2 counted inside the loaded program.
11. Run (P), the offline statistics (``--only P``), on 16384 synthetic
   spectra of 4096 pixels (``make_dummy_spectra``, seed 2; 4096 more held
   out), each card result held against the port's ``device="cpu"`` run of
   the same call: (P1) ``compute_pca`` at patch 32, step 32 over all and at
   step 1 over 2048 (8,325,120 windows); (P2) ``ZCAWhitening`` (gamma 0.1,
   eps 1e-5; then rank 64, alpha 0.1) with the whitening check and the
   held-out spectra's whitened covariance; (P3) ``compute_kernel_pca`` at
   the CLI's defaults, the transform of all spectra at chunk 4096 against
   one pass and the Nyström property on the landmarks; (P4) ``compute_pcp``
   on 1024 spectra at its defaults, with one SVT timed as Gram-eigh and as
   ``torch.linalg.svd``; (P5) ``SVDDenoiser(32)`` and 1024 noisy copies;
   (P6) ``KPCAWarmSelfAttention`` forward and backward at stride1's width
   (batch 16, T 4066); (P7) ``python -m vit_tpu_torch.prepca.
   precompute_pca --images`` in a subprocess, its artifact behind
   cifar_vit_s16_pca.yaml. Eigenvectors and what flips with them are
   compared after aligning each group of near-equal eigenvalues
   (``aligned_err``). Limits: float64 results 1e-5, float32 products 1e-4
   (relative to the largest value), PCP's L and S 1e-4 of ||D||.
12. Print the kernels' summary, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Needs torch with CUDA, nvcc and one card; exits non-zero without them.
"""

from __future__ import annotations

import copy
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 on the
# CUDA cores (TF32 is off), HBM3 bandwidth. Special-function units: 16 per
# SM (Hopper white paper) at the card's max SM clock, read from nvidia-smi.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
SFU_PER_SM = 16

FP32_TOL = 1e-4
BF16_TOL = 2e-2  # cap on O and y in bf16; see kernel_tol
BF16_ROUNDINGS = 4 * 2**-8  # four roundings to bf16, relative
LSE_TOL = 1e-3  # lse is fp32 in both; sums taken in another order
# Served features (final LayerNorm output, |f| up to ~5) in bf16 against
# fp32 on the CPU: four bf16 ulps at |f| in [4, 8). A CPU rehearsal of
# stride1 in bf16 against fp32 differed by 0.053 at most.
BF16_FEATURE_TOL = 0.125
DISTINCT = 10  # probes' features must lie this many tolerances apart
SPIN_HZ = 2.0e9  # spin cycles a second for time_ms (the H100's SM clock is at most 1.98 GHz)

# The configurations of configs/exp/att_clp/stride1.yaml and baseline.yaml
# (model, train.batch_size/precision, data.param), copied so no YAML parser
# is needed on the card's machine. Label stats are passed to the Predictor.
STRIDE1_MODEL = dict(name="vit", task_type="reg", image_size=4096, patch_size=32,
                     hidden_size=128, num_hidden_layers=3, num_attention_heads=2,
                     stride_size=1, proj_fn="SW", attn_impl="auto", remat="mlp")
BASELINE_MODEL = dict(name="vit", task_type="reg", image_size=4096, patch_size=32,
                      hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                      stride_size=32, proj_fn="SW")
LOGG_STATS = {"label_min": [0.0], "label_max": [5.0]}  # log_g range of the synthetic set
# The training sections of the two YAML files; the runs cut ep to 1 and
# baseline's batch to 16, and (e) turns on flash and the fused MLP and
# turns off viz (run (h) drives it). The data paths are unused: the spectra
# come from memory.
_DATA = {"file_path": "in-memory", "val_path": "in-memory", "test_path": "in-memory",
         "num_samples": 10000, "num_test_samples": 512, "param": "log_g",
         "label_norm": "minmax"}
_OPT = {"type": "AdamW", "lr": 0.001, "lr_sch": "plateau", "factor": 0.8, "patience": 10}
STRIDE1_TRAIN = {"project": "vit-viz", "model": STRIDE1_MODEL,
                 "train": {"batch_size": 16, "ep": 1, "precision": "bf16", "save": False,
                           "fused_epoch": False},
                 "loss": {"name": "mae"}, "opt": _OPT, "data": _DATA,
                 "noise": {"noise_level": 0}, "viz": {"enable": False}}
# Runs (e), (f), (k), (n), (o) keep the per-step path (their launch counts
# and per-step figures); run (p) trains this shape through the CUDA graph.
BASELINE_TRAIN = {"project": "vit-viz",
                  "model": dict(BASELINE_MODEL, attn_impl="flash", fused_mlp=True),
                  "train": {"batch_size": 16, "ep": 1, "debug": 0, "save": False,
                            "fused_epoch": False},
                  "loss": {"name": "mae"}, "opt": _OPT, "data": _DATA,
                  "noise": {"noise_level": 0}, "viz": {"enable": False}}
BASELINE_BF16_TRAIN = dict(BASELINE_TRAIN,
                           train=dict(BASELINE_TRAIN["train"], precision="bf16"))
STRIDE1_FUSED_TRAIN = dict(STRIDE1_TRAIN, model=dict(STRIDE1_MODEL, fused_mlp=True))
N_INPUTS = 64
BATCH = 16
SERVE_REPEATS = 9  # timed passes over the N_INPUTS spectra; all over their total time
K7_FP32_REL = 1e-5  # K7 weight gradients against their largest value, fp32 inputs
K7_BF16_REL = 1e-3  # the same with bf16 inputs; rounding dW to bf16 moves it ~2e-3
# K7's wide route: its g and dh may round off the float64 reference at most
# this many times as often as the plain version's (rounding_check).
ROUNDING_SLACK = 1.25
GRAD_FLOOR = 1e-3  # per-tensor gradient norms are floored at this share of the global norm
# (u)'s bf16 first step: a tensor's limit is at least this many times the
# CPU's own bf16 error on it (the card's bf16 step stands about as far from
# fp32 as the CPU's; each row reports grad_nearest_limit_share).
BF16_OWN = 2.0
TRAIN_GRAD_TOL = {"d_stride1_bf16": 2e-2, "e_baseline_flash_fused_fp32": 1e-4,
                  "f_baseline_flash_fused_bf16": 2e-2, "g_stride1_bf16_fused_mlp": 2e-2,
                  "j_stride1_rope_bf16": 2e-2, "k_baseline_rope_fp32": 1e-4,
                  "l_stride1_zca_train": 2e-2, "u_cifar_s16_bf16": 2e-2,
                  "u_cifar_s16_flash_fused_bf16": 2e-2, "u_cifar_s16_pca_bf16": 2e-2,
                  "u_vit_b16_flash_fused_bf16": 2e-2, "z_cifar_s16_moe_bf16": 2e-2}
# Run (l)'s covariance: more spectra than pixels, so the centred covariance
# of the 4096-pixel spectra has full rank (rank <= samples - 1).
COV_SAMPLES = 8192
MASK_SEEDS = (0, -1, 2**31 - 1)
SEED_VECTOR = (0, -1, 2**31 - 1)  # one seed a replica in the stacked checks
# Q = K6_Q * I in K6's dK mask check: a bf16 value where bf16(K6_Q *
# bf16(scale)) (K6) and bf16(K6_Q * scale) (K5) differ at d = 32 and 128.
K6_Q = 1.046875
# HGMMA in each bf16 instantiation of the attention backward by head dim:
# the wgmma in the source per tile (S and dP, d/16 k-steps each; then four
# each of dS K in K6's dQ pass; P~^T dO and dS^T Q in its dK/dV pass; and
# all three in the one-pass flash backward, K4 and K5 as one kernel).
DQ_HGMMA = {16: 6, 32: 8, 64: 12, 128: 20}
DKV_HGMMA = {16: 10, 32: 12, 64: 16, 128: 24}
FUSED_HGMMA = {16: 14, 32: 16, 64: 20, 128: 28}
BWD_HGMMA = {"flash_bwd": {"bwd_kernel": FUSED_HGMMA},
             "short_bwd": {"dq_kernel": DQ_HGMMA, "dkv_kernel": DKV_HGMMA}}
# The libraries' bf16 tensor-core instantiations live in these namespaces,
# one per head dim and pass (K3: per column tile of 16, 32, 64 or 128 and
# one or two warpgroups; K7: its dx and weight-gradient passes per box width
# 16, 32, 64 and column tile of 64 or 128; and the wide route's passes).
TC_NAMESPACE = {"flash_fwd": ("attn_fwd_tc",), "short_fwd": ("attn_fwd_tc",),
                "fused_mlp_fwd": ("fused_mlp_tc", "fused_mlp_wide_tc"),
                "flash_bwd": ("attn_bwd_fused_tc",),
                "short_bwd": ("attn_bwd_tc",),
                "fused_mlp_bwd": ("fused_mlp_bwd_tc", "fused_mlp_wide_tc")}
TC_INSTANTIATIONS = {"flash_fwd": 4, "short_fwd": 4, "fused_mlp_fwd": 10, "flash_bwd": 4,
                     "short_bwd": 8, "fused_mlp_bwd": 11}
# The wide route's passes (fused_mlp_wide_tc.cuh), each of which must be
# built and hold HGMMA: K3 forms h then y; K7 forms g and dh, then dx, then
# the weight gradients.
WIDE_PASSES = {"fused_mlp_fwd": ("act_kernel", "out_kernel"),
               "fused_mlp_bwd": ("act_kernel", "out_kernel", "wgt_kernel")}
DROPOUT_SEED = -123456789  # the kernel rows' dropout seed (any int32)
# Runs (h) and (i): the last diagnostics capture on the card against the
# port on the CPU at the config's precision (relative L2 per tensor; the
# training checks' limits), and the CKA matrix of its representations.
CAPTURE_TOL = {"h_baseline_default_run": 1e-4, "i_stride1_diagnostics": 2e-2}
CKA_TOL = {"h_baseline_default_run": 1e-6, "i_stride1_diagnostics": 1e-2}
SHARES = ("sparsity", "dead_frac", "sat_frac")  # activation stats that are shares of elements


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up: what a caller waits
    for one call, the host's launch overhead included where the kernel is
    shorter than it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms(fn, reps: int = 20, warmup: int = 3, groups: int = 3) -> float:
    """Device time of one call: ``reps`` calls back to back behind a spin
    kernel (``torch.cuda._sleep``) that lasts longer than the host takes to
    enqueue them, CUDA events around the calls, elapsed over ``reps``; the
    median of ``groups`` such runs. The card never waits for the host, so a
    kernel shorter than its launch overhead shows its own time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(1.5 * host_s + 1e-3, 0.5) * SPIN_HZ))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(flops: float, exps: float, nbytes: float, dtype, sfu_rate: float):
    """(bound_ms, bound_by): the larger of the bytes' time and the
    operations' time (multiply-adds at the dtype's peak, exps on the SFUs)."""
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    t_ops = max(flops / peak, exps / sfu_rate)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def device_profile(fn, top: int = 6) -> dict:
    """Device time of one call of ``fn`` by torch.profiler (CUPTI): the sum
    of the device kernels' times (the operators that launched them, and the
    device-side spans of ``record_function`` scopes such as
    ``Optimizer.step#AdamW.step``, are left out, or each kernel would count
    twice) and the ``top`` kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
           and "#" not in e.key]
    ops.sort(key=lambda o: -o[1])
    return dict(device_ms=sum(o[1] for o in ops),
                top=[dict(op=k[:80], ms=ms, calls=n) for k, ms, n in ops[:top]])


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def hash_per_step(vc) -> int:
    """The hash dropout kernel's launches in one training step of a model
    (its VitConfig): one a site in the forward and one in the backward, and
    one again for each site that remat's recompute redraws. The sites, with
    ``fast_dropout`` and a rate above 0: the embeddings' output, and in each
    layer the attention probabilities (the plain route only: the flash
    kernels drop them inside), the attention output and the MLP output.
    Non-reentrant checkpointing stops its recompute once the region's last
    saved tensor is back: ``remat: true`` redraws a layer's probabilities and
    attention output but not its MLP output (nothing is saved after it), and
    ``remat: mlp`` redraws none (the MLP output's site ends its region)."""
    from vit_tpu_torch.models.attention import select_attn_impl

    if not vc.fast_dropout:
        return 0
    hidden = int(vc.hidden_dropout > 0)
    probs = int(vc.attention_dropout > 0
                and select_attn_impl(vc.attn_impl, vc.seq_len, vc.head_dim) == "xla")
    forward = hidden + vc.num_hidden_layers * (probs + 2 * hidden)
    return 2 * forward + (vc.num_hidden_layers * (probs + hidden) if vc.remat is True else 0)


def counted_steps(exp, steps: int) -> int:
    """The training steps of ``exp``'s last fit whose launches the wrappers
    count: all ``steps`` on the per-step path; on the fused path its eager
    steps and one a captured graph (a replay calls no wrapper)."""
    fused = exp.fused
    return steps if fused is None else fused.eager_steps + len(fused.graphs)


def with_sites(expect: dict, vc, steps: int) -> dict:
    """``expect`` with the hash dropout kernel's launches of ``steps``
    training steps of the model ``vc`` configures."""
    return dict(expect, hash_dropout=hash_per_step(vc) * steps)


# Runs whose hash dropout launches differ from their count: held to the end
# of the script, so that one call shows every run's count; main() fails then.
SITE_MISCOUNTS = []


def check_launches(tag: str, got: dict, want: dict) -> None:
    """Every kernel's launches exactly ``want``'s: each but the hash dropout
    kernel at once, that one at the end of the script (SITE_MISCOUNTS)."""
    name = "hash_dropout"
    check({n: c for n, c in got.items() if n != name}
          == {n: c for n, c in want.items() if n != name},
          f"{tag}: launches {got}, expected {want}")
    if got.get(name) != want.get(name):
        SITE_MISCOUNTS.append(f"{tag}: {got.get(name)}, expected {want.get(name)}")
        print(f"chip_smoke: {name} launches of {SITE_MISCOUNTS[-1]}", flush=True)


def kernel_tol(ref: torch.Tensor) -> float:
    """fp32: FP32_TOL. bf16: the smaller of BF16_TOL and four roundings
    to bf16 of the largest reference value."""
    if ref.dtype != torch.bfloat16:
        return FP32_TOL
    return min(BF16_TOL, BF16_ROUNDINGS * ref.float().abs().max().item())


def attention_case(name, fwd, plain, b, h, t, d, dtype, g, sfu_rate, kernels, rate=0.0):
    import torch.nn.functional as F

    q, k, v = (torch.randn(b * h, t, d, generator=g, device="cuda").to(dtype) for _ in range(3))
    scale = d**-0.5
    kernels[name].launches = 0
    o, lse = fwd(q, k, v, scale, rate, DROPOUT_SEED)
    torch.cuda.synchronize()
    check(kernels[name].launches == 1, f"{name} did not launch")
    o_ref, lse_ref = plain(q, k, v, scale, rate, DROPOUT_SEED)
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    tol = kernel_tol(o_ref)
    check(torch.isfinite(o.float()).all().item(), f"{name} gave non-finite output")
    check(err <= tol and lse_err <= LSE_TOL,
          f"{name} {(b, h, t, d)} {dtype}: max|O err| {err} (tol {tol}), max|lse err| {lse_err}")
    q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
    ms = time_ms(lambda: fwd(q, k, v, scale, rate, DROPOUT_SEED))
    plain_ms = time_ms(lambda: plain(q, k, v, scale, rate, DROPOUT_SEED), reps=5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
    # SDPA at the same dropout_p (the same rate, other bits): a dropout
    # row's like-for-like yardstick
    lib_drop_ms = (time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, dropout_p=rate))
                   if rate > 0 else None)
    per_call = dict(kernel_call_ms=call_ms(lambda: fwd(q, k, v, scale, rate, DROPOUT_SEED)),
                    library_call_ms=call_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)))
    item = torch.finfo(dtype).bits // 8
    bms, by = bound(4.0 * b * h * t * t * d, float(b * h * t * t),
                    4.0 * b * h * t * d * item + 4.0 * b * h * t, dtype, sfu_rate)
    row = dict(phase="kernel", kernel=name, shape=dict(B=b, H=h, T=t, d=d), dtype=str(dtype),
               dropout=rate, max_abs_err=err, lse_max_abs_err=lse_err, tol=tol,
               mean_abs_ref=o_ref.float().abs().mean().item(),
               max_abs_ref=o_ref.float().abs().max().item(), kernel_ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, library_dropout_ms=lib_drop_ms,
               bound_ms=bms, bound_by=by, launches=kernels[name].launches, **per_call)
    emit(row)
    return row


def mlp_case(r, d, f, dtype, g, sfu_rate, kernels):
    """K3 against its plain version; beside its times, ``unfused_ms``: the
    unfused path it exists to beat (F.linear, exact-erf GELU, F.linear in
    the same dtype), timed here and called nowhere in the port."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain, mlp_body

    x = torch.randn(r, d, generator=g, device="cuda").to(dtype)
    w1 = (torch.randn(f, d, generator=g, device="cuda") / d**0.5).to(dtype)  # nn.Linear layout
    b1 = (0.1 * torch.randn(f, generator=g, device="cuda")).to(dtype)
    w2 = (torch.randn(d, f, generator=g, device="cuda") / f**0.5).to(dtype)
    b2 = (0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)
    name = "fused_mlp_fwd"
    kernels[name].launches = 0
    y = fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    check(kernels[name].launches == 1, f"{name} did not launch")
    y_ref = fused_mlp_plain(x, w1, b1, w2, b2)
    err = (y.float() - y_ref.float()).abs().max().item()
    tol = kernel_tol(y_ref)
    check(torch.isfinite(y.float()).all().item(), f"{name} gave non-finite output")
    check(err <= tol, f"{name} {(r, d, f)} {dtype}: max|y err| {err} (tol {tol})")
    ms = time_ms(lambda: fused_mlp(x, w1, b1, w2, b2))
    kernel_call_ms = call_ms(lambda: fused_mlp(x, w1, b1, w2, b2))
    plain_ms = time_ms(lambda: fused_mlp_plain(x, w1, b1, w2, b2), reps=5)
    unfused_ms = time_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2))
    again = fused_mlp(x, w1, b1, w2, b2)
    check(torch.equal(y, again), f"{name} {(r, d, f)} {dtype} is not bit-repeatable")
    item = torch.finfo(dtype).bits // 8
    bms, by = bound(4.0 * r * d * f, float(r * f),
                    (2.0 * r * d + 2.0 * d * f + f + d) * item, dtype, sfu_rate)
    row = dict(phase="kernel", kernel=name, shape=dict(R=r, D=d, F=f), dtype=str(dtype),
               body=mlp_body(d, f, dtype), max_abs_err=err, tol=tol,
               mean_abs_ref=y_ref.float().abs().mean().item(),
               max_abs_ref=y_ref.float().abs().max().item(), kernel_ms=ms,
               kernel_call_ms=kernel_call_ms, plain_ms=plain_ms, library_ms=None,
               unfused_ms=unfused_ms, bound_ms=bms, bound_by=by,
               launches=kernels[name].launches)
    emit(row)
    return row


def hash_dropout_case(shape, rate: float, g, kernels) -> dict:
    """The hash dropout kernel (bf16) against the torch ops it replaces, the
    port's plain version on the card: bit-equal output; its device time
    beside theirs (``plain_ms``) and the byte bound (read x, write y)."""
    from vit_tpu_torch.ops.dropout import hash_dropout, hash_keep_mask

    name = "hash_dropout"
    x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    kernels[name].launches = 0
    y = hash_dropout(x, rate, DROPOUT_SEED)
    torch.cuda.synchronize()
    check(kernels[name].launches == 1, f"{name} did not launch")

    def plain():
        return x * hash_keep_mask(x.shape, rate, DROPOUT_SEED, device=x.device).to(x.dtype)

    check(torch.equal(y.view(torch.int16), plain().view(torch.int16)),
          f"{name} {shape}: bits differ from the torch ops")
    ms = time_ms(lambda: hash_dropout(x, rate, DROPOUT_SEED))
    bms, by = bound(0.0, 0.0, 2.0 * x.numel() * x.element_size(), x.dtype, 1.0)
    row = dict(phase="kernel", kernel=name, shape=list(shape), dtype=str(x.dtype), dropout=rate,
               max_abs_err=0.0, bit_equal=True, kernel_ms=ms,
               kernel_call_ms=call_ms(lambda: hash_dropout(x, rate, DROPOUT_SEED)),
               plain_ms=time_ms(plain, reps=5), library_ms=None, bound_ms=bms, bound_by=by,
               launches=kernels[name].launches)
    emit(row)
    return row


def hash_dropout_rows(g, kernels) -> dict:
    """H: the kernel at the cells' site shapes, bf16, rate 0.1: ViT-B/16's
    attention probabilities (B128 H12 T197 T197) and hidden sites (B128 T197
    D768), stride1's hidden sites (B16 T4066 D128). Returns the first."""
    rows = [hash_dropout_case(shape, 0.1, g, kernels)
            for shape in ((128, 12, 197, 197), (128, 197, 768), (16, 4066, 128))]
    return rows[0]


def sdpa_bwd_ms(q4, k4, v4, do4, rate: float = 0.0) -> float:
    """Device ms of SDPA's backward at ``dropout_p = rate``: its forward and
    backward less its forward (the library yardstick of the backward rows)."""
    import torch.nn.functional as F

    fwd = lambda: F.scaled_dot_product_attention(q4, k4, v4, dropout_p=rate)  # noqa: E731
    return (time_ms(lambda: torch.autograd.grad(fwd(), (q4, k4, v4), do4)) - time_ms(fwd))


def attention_bwd_case(short, b, h, t, d, dtype, rate, g, sfu_rate, kernels):
    """K6, or the flash backward (K4 and K5 as one kernel), against the
    plain backward on the forward's lse: one row. Beside SDPA's backward
    without dropout (``library_ms``), a dropout row gives SDPA's backward at
    the same ``dropout_p`` (``library_dropout_ms``: the same rate, other
    bits). The flash backward is timed through its wrapper, its scratch
    (the dQ workspace, the counters' memset) included; K6 at its launch."""
    from vit_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (torch.randn(b * h, t, d, generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    scale = d**-0.5
    o, lse = (fa.short_fwd if short else fa.flash_fwd)(q, k, v, scale, rate, DROPOUT_SEED)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, scale, rate, DROPOUT_SEED)
    name = "short_bwd" if short else "flash_bwd"
    wrapper, plain = (fa.short_bwd, fa.short_bwd_plain) if short else (fa.flash_bwd,
                                                                         fa.flash_bwd_plain)
    kernels[name].launches = 0
    got = wrapper(*args)
    torch.cuda.synchronize()
    check(kernels[name].launches == 1, f"{name} did not launch once")
    want = plain(*args)
    errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
    tols = [kernel_tol(w) for w in want]
    check(all(torch.isfinite(a.float()).all().item() for a in got),
          f"{name} gave non-finite output")
    check(all(e <= tl for e, tl in zip(errs, tols)),
          f"{name} {(b, h, t, d)} {dtype} rate {rate}: errors {errs} (tols {tols})")
    if short:
        bufs = [torch.empty_like(q) for _ in range(3)]
        launch = lambda: fa._launch_bwd(name, bufs, *args)  # noqa: E731
    else:
        launch = lambda: wrapper(*args)  # noqa: E731
    ms = time_ms(launch)
    kernel_call_ms = call_ms(launch)
    plain_ms = time_ms(lambda: plain(*args), reps=5)
    q4, k4, v4 = (x.view(b, h, t, d).detach().requires_grad_() for x in (q, k, v))
    do4 = do.view(b, h, t, d)
    item = torch.finfo(dtype).bits // 8
    # Five T x T x d products (S, dP, P~^T dO, dS^T Q, dS K); q, k, v, dO in
    # and dq, dk, dv out, lse and delta in fp32.
    bms, by = bound(10.0 * b * h * t * t * d, float(b * h * t * t),
                    7.0 * b * h * t * d * item + 2.0 * 4 * b * h * t, dtype, sfu_rate)
    row = dict(
        phase="kernel", kernel=name, shape=dict(B=b, H=h, T=t, d=d), dtype=str(dtype),
        dropout=rate, max_abs_err=max(errs), errs=errs, tol=min(tols),
        max_abs_ref=max(w.float().abs().max().item() for w in want),
        kernel_ms=ms, kernel_call_ms=kernel_call_ms, plain_ms=plain_ms,
        library_ms=sdpa_bwd_ms(q4, k4, v4, do4),
        library="SDPA backward (fwd+bwd - fwd), no dropout",
        library_dropout_ms=sdpa_bwd_ms(q4, k4, v4, do4, rate) if rate > 0 else None,
        bound_ms=bms, bound_by=by)
    emit(row)
    return {name: row}


def mlp_bwd_case(r, d, f, dtype, g, sfu_rate, kernels):
    """K7 against its plain version; beside its times, ``unfused_ms``: the
    backward of the unfused path (F.linear, exact-erf GELU, F.linear in the
    same dtype; forward and autograd backward, less the forward, as the SDPA
    rows), timed here and called nowhere in the port."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops.fused_mlp import (
        bwd_plan, fused_mlp_bwd, fused_mlp_bwd_plain, mlp_body,
    )

    x, dy = (torch.randn(r, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    w1 = (torch.randn(f, d, generator=g, device="cuda") / d**0.5).to(dtype)
    b1 = (0.1 * torch.randn(f, generator=g, device="cuda")).to(dtype)
    w2 = (torch.randn(d, f, generator=g, device="cuda") / f**0.5).to(dtype)
    name = "fused_mlp_bwd"
    kernels[name].launches = 0
    tensor_cores, n_seg = bwd_plan(r, d, f, dtype)
    body = mlp_body(d, f, dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = fused_mlp_bwd(x, dy, w1, b1, w2)
    torch.cuda.synchronize()
    check(kernels[name].launches == 1, f"{name} did not launch")
    # Device memory the call held beyond dx, the fp32 gradients and the
    # partials (none on the wide body with one segment): the on-chip body
    # keeps g and dh in registers, so less than one (R, F) tensor; the wide
    # and FMA bodies move both through device memory.
    n = 2 * f * d + f + d
    item = torch.finfo(dtype).bits // 8
    partials = 0 if body == "wide" and n_seg == 1 else n_seg * n * 4
    scratch = torch.cuda.max_memory_allocated() - base - (r * d * item + n * 4 + partials)
    check(scratch < r * f * item if body == "tc" else scratch >= 2 * r * f * item,
          f"{name} {(r, d, f)} {dtype}: {scratch} bytes of scratch on the {body} body")
    want = fused_mlp_bwd_plain(x, dy, w1, b1, w2)
    rel = K7_FP32_REL if dtype == torch.float32 else K7_BF16_REL
    tols = [kernel_tol(want[0])] + [rel * max(1.0, w.abs().max().item()) for w in want[1:]]
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
    check(all(torch.isfinite(a).all().item() for a in got), f"{name} gave non-finite output")
    check(all(e <= tl for e, tl in zip(errs, tols)),
          f"{name} {(r, d, f)} {dtype}: errors (dx, dW1, db1, dW2, db2) {errs}, tols {tols}")
    again = fused_mlp_bwd(x, dy, w1, b1, w2)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{name} is not bit-repeatable")
    ms = time_ms(lambda: fused_mlp_bwd(x, dy, w1, b1, w2))
    kernel_call_ms = call_ms(lambda: fused_mlp_bwd(x, dy, w1, b1, w2))
    plain_ms = time_ms(lambda: fused_mlp_bwd_plain(x, dy, w1, b1, w2), reps=5)
    leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, torch.zeros_like(x[0]))]
    unfused = lambda: F.linear(F.gelu(F.linear(leaves[0], leaves[1], leaves[2])),  # noqa: E731
                               leaves[3], leaves[4])
    unfused_ms = (time_ms(lambda: torch.autograd.grad(unfused(), leaves, dy))
                  - time_ms(unfused))
    passes = device_profile(lambda: fused_mlp_bwd(x, dy, w1, b1, w2))["top"]  # K7's launches
    bms, by = bound(10.0 * r * d * f, 2.0 * r * f,
                    (3.0 * r * d + 2.0 * d * f + f) * item + (2.0 * d * f + f + d) * 4, dtype,
                    sfu_rate)
    row = dict(phase="kernel", kernel=name, shape=dict(R=r, D=d, F=f), dtype=str(dtype),
               max_abs_err=max(errs), errs=dict(zip(("dx", "dW1", "db1", "dW2", "db2"), errs)),
               tols=tols, max_abs_ref=[w.float().abs().max().item() for w in want],
               tensor_cores=tensor_cores, body=body, segments=n_seg, scratch_bytes=scratch,
               bit_repeatable=True, kernel_ms=ms, kernel_call_ms=kernel_call_ms,
               plain_ms=plain_ms, library_ms=None, unfused_ms=unfused_ms, passes=passes,
               bound_ms=bms, bound_by=by)
    emit(row)
    return row


def library_mlp_case(r, d, f, g, kernels, k3: dict, k7: dict) -> dict:
    """``library_mlp``, the model's MLP outside ``vit_tpu``'s envelope (its
    ``_jnp_mlp``: library products summed in fp32, the fp32 erf GELU, h in
    bf16), at a wide shape in bf16: no kernel of the package launches; its
    forward and autograd gradients against the plain versions of K3 and K7
    (y and dx at the bf16 limit; its weight gradients come out of bf16
    operands, so four bf16 ulps of the largest value, not K7's 1e-3); its
    device ms (the backward: forward and backward less the forward) beside
    K3's and K7's rows at the shape, and the same with ``_gelu_f32``'s A&S
    GELU as eager passes (``gelu_as``), the GELU it does not take."""
    from vit_tpu_torch.ops.fused_mlp import (
        _F32Product, fused_mlp_bwd_plain, fused_mlp_plain, gelu_as, library_mlp,
    )

    dtype = torch.bfloat16
    x, dy = (torch.randn(r, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    w1 = (torch.randn(f, d, generator=g, device="cuda") / d**0.5).to(dtype)
    b1 = (0.1 * torch.randn(f, generator=g, device="cuda")).to(dtype)
    w2 = (torch.randn(d, f, generator=g, device="cuda") / f**0.5).to(dtype)
    b2 = (0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)
    leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
    before = {n: k.launches for n, k in kernels.items()}
    y = library_mlp(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    check(all(k.launches == before[n] for n, k in kernels.items()),
          "library_mlp launched a kernel of the package")
    want = [fused_mlp_plain(x, w1, b1, w2, b2), *fused_mlp_bwd_plain(x, dy, w1, b1, w2)]
    names = ("y", "dx", "dW1", "db1", "dW2", "db2")
    tols = [kernel_tol(want[0]), kernel_tol(want[1])] + [
        BF16_ROUNDINGS * w.abs().max().item() for w in want[2:]]
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip([y, *got], want)]
    check(all(torch.isfinite(a.float()).all().item() for a in (y, *got)),
          "library_mlp gave non-finite output")
    check(all(e <= tl for e, tl in zip(errs, tols)),
          f"library_mlp {(r, d, f)}: errors {dict(zip(names, errs))}, tols {tols}")
    fwd_ms = time_ms(lambda: library_mlp(*leaves))
    bwd_ms = time_ms(lambda: torch.autograd.grad(library_mlp(*leaves), leaves, dy)) - fwd_ms

    def gelu_as_mlp(x, w1, b1, w2, b2):  # _gelu_f32's A&S erf, eager: the GELU not taken
        h = gelu_as(_F32Product.apply(x, w1) + b1.float()).to(x.dtype)
        return (_F32Product.apply(h, w2) + b2.float()).to(x.dtype)

    as_fwd_ms = time_ms(lambda: gelu_as_mlp(*leaves), reps=5)
    as_bwd_ms = time_ms(lambda: torch.autograd.grad(gelu_as_mlp(*leaves), leaves, dy),
                        reps=5) - as_fwd_ms
    row = dict(phase="kernel_counterpart", counterpart="library_mlp", replaces_at_this_width=
               "K3, K7 (vit_tpu: _jnp_mlp past its 12 MiB envelope)",
               shape=dict(R=r, D=d, F=f), dtype=str(dtype), errs=dict(zip(names, errs)),
               tols=dict(zip(names, tols)), fwd_ms=fwd_ms, bwd_ms=bwd_ms,
               gelu_as_fwd_ms=as_fwd_ms, gelu_as_bwd_ms=as_bwd_ms,
               k3_ms=k3["kernel_ms"], k7_ms=k7["kernel_ms"], k3_unfused_ms=k3["unfused_ms"],
               k7_unfused_ms=k7["unfused_ms"], kernel_launches=0)
    emit(row)
    return row


def rounding_check(g, kernels, r: int = 2000, d: int = 1024, f: int = 4096) -> dict:
    """The wide route's bf16 roundings against float64 (bf16 of the float64
    GELU, and of dg times its derivative, of float64 sums), beside the plain
    version's fp32 sums: the share of elements of K3's h (pre summed by the
    tensor cores over all of D) and of K7's g and dh (each k-block's
    products added in fp32 registers) that round to another bf16 than the
    reference. K7's g and dh feed fp32 sums over every row, so they are held
    to at most ROUNDING_SLACK times the plain version's share."""
    from vit_tpu_torch.ops import fused_mlp as fm

    x, dy = (torch.randn(r, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    w1 = (torch.randn(f, d, generator=g, device="cuda") / d**0.5).bfloat16()
    b1 = (0.1 * torch.randn(f, generator=g, device="cuda")).bfloat16()
    w2 = (torch.randn(d, f, generator=g, device="cuda") / f**0.5).bfloat16()
    stream = torch.cuda.current_stream().cuda_stream
    h = fm._fwd_scratch(r, d, f, torch.bfloat16, x.device)
    kernels["fused_mlp_fwd"].launch(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                    torch.zeros_like(x[0]).data_ptr(),
                                    torch.empty_like(x).data_ptr(), h.data_ptr(), r, d, f, 1,
                                    stream)
    body, n_seg, gg, dh, part = fm._bwd_scratch(r, d, f, torch.bfloat16, x.device)
    kernels["fused_mlp_bwd"].launch(
        x.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        torch.empty_like(x).data_ptr(), gg.data_ptr(), dh.data_ptr(),
        None if part is None else part.data_ptr(),
        torch.empty(2 * f * d + f + d, device="cuda").data_ptr(), r, d, f, n_seg, 1,
        fm.BODIES.index(body), stream)
    torch.cuda.synchronize()
    pre64, dg64 = x.double() @ w1.double().t() + b1.double(), dy.double() @ w2.double()
    pre32, dg32 = x.float() @ w1.float().t() + b1.float(), dy.float() @ w2.float()
    ref = {"h": fm.gelu_as(pre64).bfloat16(), "dh": (dg64 * fm.dgelu_as(pre64)).bfloat16()}
    plain = {"h": fm.gelu_as(pre32).bfloat16(), "dh": (dg32 * fm.dgelu_as(pre32)).bfloat16()}
    def share(a, b):
        return (a != b).float().mean().item()

    shares = {"K3 h": (share(h, ref["h"]), share(plain["h"], ref["h"])),
              "K7 g": (share(gg, ref["h"]), share(plain["h"], ref["h"])),
              "K7 dh": (share(dh, ref["dh"]), share(plain["dh"], ref["dh"]))}
    for name in ("K7 g", "K7 dh"):
        kernel, plain_share = shares[name]
        check(kernel <= ROUNDING_SLACK * plain_share,
              f"{name}: rounds off float64 in {kernel} of elements, plain {plain_share}")
    row = dict(phase="rounding", shape=dict(R=r, D=d, F=f), body=body,
               off_float64={k: dict(kernel=v[0], plain=v[1]) for k, v in shares.items()},
               limit=f"K7: kernel <= {ROUNDING_SLACK} x plain")
    emit(row)
    return row


def mask_check(kernels) -> dict:
    """K1 and K2 with Q = 0 and V the identity: O = M/(keep*T), so O is zero
    exactly where hash_dropout_mask drops (fp32 and bf16; in bf16 every value
    is exact and held bit for bit). The flash backward (K4 and K5 as one
    kernel) and K6 in bf16 with lse = log T and delta = 0 (P = 1/T): Q = 0,
    K = V = I, dO = 1 gives dQ = scale*M/(keep*T); Q = K = 0, dO = I gives dV[j, c]
    = M[c, j]/(keep*T); K6 with Q = K6_Q * I, K = 0, V = I, dO = 1 gives
    dK[j, c] = M[c, j]/(keep*T) * bf16(K6_Q * bf16(scale)), K6's rounding of
    Q*scale (K5's would round K6_Q * scale). Every value is exact in bf16:
    held bit for bit. Then the same with one seed for each of four groups
    of 8 heads (a stacked launch over four replicas): each group's mask is
    its own seed's at its own head indices, bit for bit."""
    from vit_tpu_torch.ops.dropout import hash_dropout_mask
    from vit_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd, short_bwd, short_fwd

    t = d = 128
    bh, scale = 32, d**-0.5
    q = torch.zeros(bh, t, d, device="cuda")
    v = torch.eye(t, device="cuda").expand(bh, t, d).contiguous()
    zeros, eye = q.bfloat16(), v.bfloat16()
    lse = torch.full((bh, t), float(torch.log(torch.tensor(float(t)))), device="cuda")
    delta = torch.zeros(bh, t, device="cuda")
    ones, q_k6 = torch.ones_like(zeros), (K6_Q * eye).contiguous()
    qs_k6 = float((K6_Q * torch.tensor(scale, dtype=torch.bfloat16).float()).bfloat16())
    out = {}
    vector = torch.tensor(SEED_VECTOR + (12345,), dtype=torch.int32, device="cuda")
    for seed in (*MASK_SEEDS, vector):
        per = bh // len(vector) if isinstance(seed, torch.Tensor) else 0
        if per:  # (replicas, heads per replica, t, t) -> (bh, t, t)
            mask = hash_dropout_mask(t, t, torch.arange(per), seed.cpu(), 0.5).view(bh, t, t)
        else:
            mask = hash_dropout_mask(t, t, torch.arange(bh), seed, 0.5)  # 0 or 1/keep
        mask = mask.cuda()
        drop = (0.5, seed, per)
        got, want = {}, {}
        for name, fwd in (("short_fwd", short_fwd), ("flash_fwd", flash_fwd)):
            got[name] = fwd(q, q, v, scale, *drop)[0]
            want[name] = mask / t
            got[f"{name}_bf16"] = fwd(zeros, zeros, eye, scale, *drop)[0]
            want[f"{name}_bf16"] = (mask / t).bfloat16()
        got["flash_bwd_dq"] = flash_bwd(zeros, eye, eye, torch.ones_like(zeros), lse, delta,
                                        scale, *drop)[0]
        want["flash_bwd_dq"] = (mask / t * scale).bfloat16()
        got["flash_bwd_dv"] = flash_bwd(zeros, zeros, zeros, eye, lse, delta, scale, *drop)[2]
        want["flash_bwd_dv"] = (mask / t).transpose(1, 2).bfloat16()
        got["short_bwd_dq"] = short_bwd(zeros, eye, eye, ones, lse, delta, scale, *drop)[0]
        want["short_bwd_dq"] = want["flash_bwd_dq"]
        got["short_bwd_dv"] = short_bwd(zeros, zeros, zeros, eye, lse, delta, scale, *drop)[2]
        want["short_bwd_dv"] = want["flash_bwd_dv"]
        got["short_bwd_dk"] = short_bwd(q_k6, zeros, eye, ones, lse, delta, scale, *drop)[1]
        want["short_bwd_dk"] = ((mask / t).transpose(1, 2) * qs_k6).bfloat16()
        if per:
            seed = "vector:" + ",".join(str(int(x)) for x in vector.tolist())
        else:
            # The same calls with the seed as an int32 device scalar: the same bits.
            dev_seed = torch.tensor(seed, dtype=torch.int32, device="cuda")
            again = {"flash_fwd": flash_fwd(q, q, v, scale, 0.5, dev_seed)[0],
                     "short_fwd_bf16": short_fwd(zeros, zeros, eye, scale, 0.5, dev_seed)[0],
                     "flash_bwd_dv": flash_bwd(zeros, zeros, zeros, eye, lse, delta, scale,
                                                0.5, dev_seed)[2],
                     "short_bwd_dk": short_bwd(q_k6, zeros, eye, ones, lse, delta, scale, 0.5,
                                               dev_seed)[1]}
            for name, o in again.items():
                check(torch.equal(o, got[name]), f"{name} seed {seed}: a device-scalar seed "
                      "gives other values than the int seed")
        for name, o in got.items():
            ref = want[name]
            wrong = int(((o == 0) != (ref == 0)).sum().item())
            check(wrong == 0, f"{name} seed {seed}: {wrong} mask bits differ from hash_dropout_mask")
            if ref.dtype == torch.bfloat16:
                check(torch.equal(o, ref), f"{name} seed {seed}: values differ from "
                      "M/(keep*T), which is exact in bf16")
            out[f"{name}/{seed}"] = dict(wrong_bits=wrong, dropped=float((o == 0).float().mean()))
    emit(dict(phase="mask_check", T=t, d=d, heads=bh, rate=0.5, results=out))
    return out


def tensor_core_instructions(lib: str) -> dict:
    """{function: {"HGMMA": n, "HMMA": n}} from ``cuobjdump --dump-sass`` of a
    built library."""
    import re

    from vit_tpu_torch.ops._build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                counts[fn][op] += bool(re.search(rf"\b{op}\.", line))
    return counts


def demangle(names) -> dict:
    """{mangled: "ns::kernel<args>"} through c++filt where it exists."""
    import shutil

    names = list(names)
    if not names or shutil.which("c++filt") is None:
        return {n: n for n in names}
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                         timeout=60, check=True).stdout.splitlines()
    return {n: d.replace("(anonymous namespace)", "anon").split("(")[0].replace("void ", "")
            for n, d in zip(names, out)}


def ptxas_report(log: str) -> dict:
    """{mangled function: {"registers": n, "spill_stores": bytes}} from nvcc's
    ``-Xptxas -v`` output."""
    import re

    out, fn, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out[fn] = {"registers": int(m.group(1)), "spill_stores": spill}
    return out


def check_tensor_cores(mma: dict) -> None:
    """Every bf16 tensor-core instantiation of K1-K7 holds HGMMA (the flash
    backward and K6's passes exactly BWD_HGMMA's counts; every pass of the wide route,
    WIDE_PASSES, is there), and no other instantiation (fp32, and K3's and
    K7's bf16 FMA bodies for widths off the tensor-core rule) holds any
    tensor-core instruction."""
    import re

    for lib, funcs in mma.items():
        tc = {f: c for f, c in funcs.items() if any(ns in f for ns in TC_NAMESPACE[lib])}
        plain = {f: c for f, c in funcs.items() if f not in tc}
        check(len(tc) == TC_INSTANTIATIONS[lib] and all(c["HGMMA"] > 0 for c in tc.values()),
              f"{lib}: a bf16 instantiation is missing or holds no HGMMA: {funcs}")
        check(plain and all(c["HGMMA"] + c["HMMA"] == 0 for c in plain.values()),
              f"{lib}: an fp32 instantiation holds tensor-core instructions: {funcs}")
        if lib in BWD_HGMMA:
            got = {}
            for f, c in tc.items():
                kind, d = re.search(r"(bwd_kernel|dq_kernel|dkv_kernel)ILi(\d+)E", f).groups()
                got[kind, int(d)] = c["HGMMA"]
            want = {(kind, d): n for kind, by_d in BWD_HGMMA[lib].items()
                    for d, n in by_d.items()}
            check(got == want, f"{lib}: HGMMA by pass and head dim {got}, expected {want}")
        for kernel in WIDE_PASSES.get(lib, ()):
            wide = [c for f, c in tc.items() if "fused_mlp_wide_tc" in f and kernel in f]
            check(len(wide) > 0 and all(c["HGMMA"] > 0 for c in wide),
                  f"{lib}: the wide route's {kernel} is missing or holds no HGMMA: {funcs}")


def rel_l2(a: torch.Tensor, b: torch.Tensor, floor: float) -> float:
    return ((a - b).norm() / max(b.norm().item(), floor)).item()


def cpu_step(exp, cfg, precision: str, batches, seeds, prepare=None) -> list:
    """(loss, gradients) of one step on each of ``batches`` on the CPU in
    ``precision``, from the card's weights; ``prepare(model)`` adjusts the
    CPU model first."""
    import copy

    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.train.loop import loss_and_grads

    cpu_cfg = copy.deepcopy(cfg)
    cpu_cfg["train"] = dict(cpu_cfg.get("train", {}), precision=precision)
    cpu_model = get_model(cpu_cfg).module.train()
    cpu_model.load_state_dict({k: v.cpu() for k, v in exp.module.state_dict().items()})
    if prepare is not None:
        prepare(cpu_model)
    task, loss_name = exp.bundle.vit_config.task_type, exp.bundle.loss_name
    out = []
    for b in batches:
        loss = loss_and_grads(cpu_model, b, task, loss_name, seeds).item()
        out.append((loss, [p.grad.float().clone() for p in cpu_model.parameters()]))
    return out


def first_step_check(tag, exp, cfg, tol, cpu_ref=None, bf16_limits: bool = False,
                     prepare=None, both_backends: bool = False) -> dict:
    """Loss and parameter gradients of one step on a batch of 4 with fixed
    dropout seeds, on the card against fp32 on the CPU, each tensor's in
    relative L2 at ``tol``; and the CPU gradients of that batch and of a
    probe batch (four standard-normal spectra or images, as the serving
    runs' probes, with uniform random labels or classes), which must lie at
    least DISTINCT limits apart. ``cpu_ref``: a dict that keeps the CPU's
    fp32 step for a further check of the same weights (filled on the first
    call, read on the next).

    ``bf16_limits``: the same step also runs in the config's bf16 on the
    CPU, and each tensor's limit is the larger of ``tol`` and BF16_OWN
    times that step's own distance from fp32 on the tensor: the card's bf16
    step may stand as far from fp32 as bf16 itself puts the CPU, twice over,
    and never further than ``tol`` where bf16 moves the CPU less. The global
    relative L2 is then held at ``tol`` as well, and the card's distance
    from the CPU's bf16 step is reported. ``prepare``: passed to every CPU
    step (cpu_step). ``both_backends``: the CPU's own bf16 error on a tensor
    is the larger of its bf16 step's with oneDNN's bf16 products and with
    ATen's own (``torch.backends.mkldnn`` off): two sums of the same
    products in other orders."""
    arrays = exp.datamodule.train.arrays()
    task = exp.bundle.vit_config.task_type
    exp.module.train()
    seeds = [list(range(1000, 1000 + exp.module.num_dropout_sites))]

    batch = {k: torch.from_numpy(arrays[k][:4]) for k in ("x", "label")}
    g3 = torch.Generator().manual_seed(3)
    probes = {"x": torch.randn(batch["x"].shape, generator=torch.Generator().manual_seed(2)),
              "label": (torch.randint(0, exp.bundle.vit_config.num_labels, batch["label"].shape,
                                      generator=g3, dtype=batch["label"].dtype)
                        if task == "cls" else torch.rand(batch["label"].shape, generator=g3))}
    from vit_tpu_torch.train.loop import loss_and_grads

    card_loss = loss_and_grads(exp.module, {k: v.cuda() for k, v in batch.items()}, task,
                               exp.bundle.loss_name, seeds).item()
    card = [p.grad.float().cpu() for p in exp.module.parameters()]
    for p in exp.module.parameters():
        p.grad = None
    ref = (cpu_ref or {}).get("ref")
    if ref is None:
        ref = cpu_step(exp, cfg, "float32", (batch, probes), seeds, prepare)
        if cpu_ref is not None:
            cpu_ref["ref"] = ref
    (ref_loss, ref_a), (_, ref_b) = ref
    total = torch.sqrt(sum(r.square().sum() for r in ref_a)).item()
    names = [n for n, _ in exp.module.named_parameters()]

    def rel(grads, against):
        return {n: rel_l2(c, r, GRAD_FLOOR * total) for n, c, r in zip(names, grads, against)}

    errs = rel(card, ref_a)
    limits = dict.fromkeys(names, tol)
    extra = {}
    if bf16_limits:
        (_, cpu16), = cpu_step(exp, cfg, cfg["train"]["precision"], (batch,), seeds, prepare)
        own = rel(cpu16, ref_a)
        if both_backends:
            with torch.backends.mkldnn.flags(enabled=False):
                (_, aten16), = cpu_step(exp, cfg, cfg["train"]["precision"], (batch,), seeds,
                                        prepare)
            aten = rel(aten16, ref_a)
            ratio = {n: aten[n] / max(own[n], 1e-12) for n in names}
            extra_own = dict(cpu_backend_own_ratio={
                kind: dict(min=min(v), median=statistics.median(v), max=max(v))
                for kind, v in (("router", [r for n, r in ratio.items() if "router" in n]),
                                ("other", [r for n, r in ratio.items() if "router" not in n]))
                if v})
            own = {n: max(own[n], aten[n]) for n in names}
        limits = {n: max(tol, BF16_OWN * own[n]) for n in names}
        vs16 = rel(card, cpu16)
        extra = dict(cpu_bf16_rel_l2_max=max(own.values()),
                     cpu_bf16_rel_l2_median=statistics.median(own.values()),
                     vs_cpu_bf16_rel_l2_max=max(vs16.values()),
                     vs_cpu_bf16_rel_l2_median=statistics.median(vs16.values()),
                     limits_above_tol={n: lim for n, lim in limits.items() if lim > tol},
                     **(extra_own if both_backends else {}))
    worst = max(errs, key=errs.get)
    used = max(names, key=lambda n: errs[n] / limits[n])  # nearest its limit
    glob = (torch.sqrt(sum((c - r).square().sum() for c, r in zip(card, ref_a))) / total).item()
    apart = (torch.sqrt(sum((a - b).square().sum() for a, b in zip(ref_a, ref_b))) / total).item()
    loss_err = abs(card_loss - ref_loss) / abs(ref_loss)
    nearest = sorted(names, key=lambda n: -errs[n] / limits[n])[:6]
    emit(dict(phase="first_step_nearest_limits", run=tag, global_rel_l2=glob, tensors={
        n: dict(rel_l2=errs[n], limit=limits[n], numel=ref_a[names.index(n)].numel(),
                norm_share=ref_a[names.index(n)].norm().item() / total,
                **({"cpu_bf16_own": own[n], "vs_cpu_bf16": vs16[n]} if bf16_limits else {}))
        for n in nearest}))
    check(loss_err <= tol, f"{tag}: first-step loss {card_loss} vs CPU fp32 {ref_loss} "
          f"(relative {loss_err}, tol {tol})")
    check(errs[used] <= limits[used], f"{tag}: gradient of {used} differs from the CPU fp32 "
          f"step by relative L2 {errs[used]} (limit {limits[used]})")
    if bf16_limits:
        check(glob <= tol, f"{tag}: the gradients differ from the CPU fp32 step by global "
              f"relative L2 {glob} (tol {tol})")
    check(apart >= DISTINCT * tol, f"{tag}: the probe batch's gradients only {apart} apart "
          f"(relative L2): the check cannot tell batches apart at tol {tol}")
    return dict(first_step_loss=card_loss, first_step_loss_cpu_fp32=ref_loss,
                loss_rel_err=loss_err, grad_rel_l2_max=errs[worst], grad_rel_l2_worst=worst,
                grad_rel_l2_median=statistics.median(errs.values()), grad_rel_l2_global=glob,
                grad_nearest_limit=used, grad_nearest_limit_share=errs[used] / limits[used],
                grad_tol=tol, grad_batches_apart=apart, grad_batches_apart_min=DISTINCT * tol,
                **extra)


def train_run(tag, cfg, expect, kernels, after=None, grad_check=None) -> dict:
    """One epoch of Experiment.fit on the card over in-memory spectra (or,
    for an image config, the synthetic images its data section sizes);
    ``after(exp)`` adds its dict of further checks to the row;
    ``grad_check(tag, exp, cfg)`` replaces the first-step check."""
    import copy

    import numpy as np

    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.images import ImageDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.train.loop import Experiment

    if cfg["model"].get("input_kind") == "image":
        dm = ImageDataModule(cfg)
    else:
        data = make_dummy_spectra(n=N_INPUTS, length=cfg["model"]["image_size"], seed=1)
        dm = SpecDataModule(cfg, source=data)
    exp = Experiment(copy.deepcopy(cfg), device="cuda", datamodule=dm)
    dm.setup("fit")
    grads = (first_step_check(tag, exp, cfg, TRAIN_GRAD_TOL[tag]) if grad_check is None
             else grad_check(tag, exp, cfg))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    metrics = exp.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in exp.epoch_losses]
    steps = -(-len(dm.train) // exp.batch_size)
    vc = exp.bundle.vit_config
    expect = with_sites(expect, vc, counted_steps(exp, steps * exp.max_epochs))
    check_launches(tag, launches, expect)
    check(len(losses) == steps and all(np.isfinite(losses)), f"{tag}: step losses {losses}")

    prof = step_profile(exp)
    step_ms = metrics["epoch_time_s"] * 1e3 / steps
    row = dict(phase="train", run=tag, T=vc.seq_len, layers=vc.num_hidden_layers,
               dtype=str(vc.dtype), batch=exp.batch_size, inputs=len(dm.train), steps=steps,
               path="per-step" if exp.fused is None else "fused (CUDA graph)", losses=losses,
               train_loss=metrics["train_loss"], val_mae=metrics.get("val_mae"),
               val_acc=metrics.get("val_acc"),
               smoke_ms_per_step=step_ms, smoke_steps_per_s=1e3 / step_ms, fit_seconds=fit_s,
               peak_mem_bytes=peak, launches=launches, expected_launches=expect,
               device_ms_per_step=prof["device_ms"], device_busy_share=prof["device_ms"] / step_ms,
               top_device_ops=prof["top"], **grads)
    if after is not None:
        row.update(after(exp))
    emit(row)
    return row


def max_span(feats: torch.Tensor) -> float:
    """Smallest max-abs distance between any two inputs' outputs."""
    n = len(feats)
    return min((feats[i] - feats[j]).abs().max().item() for i in range(n) for j in range(i))


def serve_run(tag, cfg, expect, tol, feat_tol, ckpt_dir, kernels, module=None,
              n=N_INPUTS, batch=BATCH):
    """Serve ``n`` spectra (an image config: synthetic images) on the card at
    ``batch``; check launches, finiteness, and the logits and per-token
    features of two served inputs and two probes against the same weights in
    fp32 on the CPU. ``module``: the weights to serve (default: the
    config's model initialised from seed 0). ``tol`` None: the logits are
    held to what the feature limit implies through the fp32 head, feat_tol
    times the largest L1 norm of a row of its weight."""
    import copy

    import numpy as np

    from vit_tpu_torch.data.images import ImageDataset
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.serve import Predictor
    from vit_tpu_torch.train.torch_bridge import save_torch_checkpoint

    pt = os.path.join(ckpt_dir, f"{tag}.pt")
    if module is None:  # a copy: a preprocessor's builder adjusts model.image_size
        module = get_model(copy.deepcopy(cfg), generator=torch.Generator().manual_seed(0)).module
    save_torch_checkpoint(module, pt)
    loaded = Predictor.from_checkpoint(cfg, ckpt=pt, batch_size=batch, device="cuda")
    reg = loaded.vit_config.task_type != "cls"
    pred = Predictor(loaded.module, loaded.vit_config, label_norm="minmax" if reg else "none",
                     label_norm_stats=LOGG_STATS if reg else None, batch_size=batch)
    if pred.image_shapes is not None:
        images = ImageDataset(num_test_samples=n, image_size=pred.vit_config.image_size,
                              num_classes=pred.vit_config.num_labels)
        images.load_data("test")  # the synthetic test split: n images
        x = images.images
    else:  # the raw spectra, before any preprocessor
        x = make_dummy_spectra(n=n, length=pred.input_length, seed=1)["flux"]
    pred.predict(x[:batch])  # warm-up: cuBLAS handles, allocator
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    log_g = pred.predict(x)
    launches = {n: k.launches for n, k in kernels.items()}
    runs = []
    for _ in range(SERVE_REPEATS):
        t0 = time.perf_counter()
        pred.predict(x)  # ends in a copy to the host
        runs.append(time.perf_counter() - t0)
    vc = pred.vit_config
    check_launches(tag, launches, expect)
    check(log_g.shape == ((n, 1) if reg else (n,))
          and bool(torch.isfinite(torch.from_numpy(log_g).double()).all()),
          f"{tag}: predictions not finite or of shape {log_g.shape}")

    probes = torch.randn((2,) + x.shape[1:], generator=torch.Generator().manual_seed(2)).numpy()
    xs = np.concatenate([x[:2], probes])
    cpu = Predictor.from_checkpoint(cfg, ckpt=pt, batch_size=len(xs), precision="float32",
                                    device="cpu")
    logits_ref = cpu._batched_logits(xs)
    err = float(abs(logits_ref - pred._batched_logits(xs)).max())
    with torch.inference_mode():
        feats_ref = cpu.module.features(torch.from_numpy(xs)).float()
        feats = pred.module.features(torch.from_numpy(xs).to(pred.device)).float().cpu()
    feat_err = (feats - feats_ref).abs().max().item()
    probe_span = max_span(feats_ref[2:])
    if tol is None:
        tol = feat_tol * cpu.module.head.weight.abs().sum(1).max().item()
    check(err <= tol, f"{tag}: logits differ from the CPU fp32 run by {err} (tol {tol})")
    check(feat_err <= feat_tol,
          f"{tag}: features differ from the CPU fp32 run by {feat_err} (tol {feat_tol})")
    check(probe_span >= DISTINCT * feat_tol,
          f"{tag}: probes' features only {probe_span} apart: the comparison cannot tell "
          f"inputs apart at tol {feat_tol}")

    batch_ms = sum(runs) * 1e3 / (SERVE_REPEATS * -(-n // batch))
    prof = device_profile(lambda: pred._batched_logits(x[:batch]))
    per_s = "smoke_images_per_s" if pred.image_shapes is not None else "smoke_spectra_per_s"
    row = dict(phase="serve", run=tag, T=vc.seq_len, layers=vc.num_hidden_layers,
               dtype=str(vc.dtype), batch=batch, inputs=n, repeats=SERVE_REPEATS,
               **{per_s: SERVE_REPEATS * n / sum(runs)},
               pass_seconds_min_max=[min(runs), max(runs)], batch_ms=batch_ms,
               peak_mem_bytes=torch.cuda.max_memory_allocated(), launches=launches,
               max_abs_logit_err_vs_cpu_fp32=err, logit_tol=tol,
               logit_span_probes=float(abs(logits_ref[2] - logits_ref[3]).max()),
               max_abs_feature_err_vs_cpu_fp32=feat_err, feature_tol=feat_tol,
               feature_span_served=max_span(feats_ref[:2]), feature_span_probes=probe_span,
               device_ms_per_batch=prof["device_ms"],
               device_busy_share=prof["device_ms"] / batch_ms, top_device_ops=prof["top"])
    if reg:
        row.update(log_g_min=float(log_g.min()), log_g_max=float(log_g.max()),
                   logit_span_served=float(log_g.max() - log_g.min())
                   / (LOGG_STATS["label_max"][0] - LOGG_STATS["label_min"][0]))
    else:
        row.update(classes_served=sorted({int(c) for c in log_g}))
    emit(row)
    return row


class Tee(io.TextIOBase):
    """Standard output that is also kept, to hold a run to what it printed."""

    def __init__(self, out) -> None:
        self.out, self.parts = out, []

    def write(self, text: str) -> int:
        self.out.write(text)
        self.parts.append(text)
        return len(text)

    def flush(self) -> None:
        self.out.flush()

    @property
    def text(self) -> str:
        return "".join(self.parts)


def count_captures(exp, record: dict) -> None:
    """Wrap the Experiment's capture: count the calls that return, keep the
    last one's result, inputs and weights, and the capture's own peak device
    memory above what was allocated before it (the run's peak is kept
    aside, since the capture resets the counter)."""
    import numpy as np

    capture = exp._run_capture_eval

    def counted(dataset, num_samples):
        torch.cuda.synchronize()
        record["run_peak_bytes"] = max(record["run_peak_bytes"],
                                       torch.cuda.max_memory_allocated())
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = capture(dataset, num_samples)
        record["capture_peak_bytes"] = max(record["capture_peak_bytes"],
                                           torch.cuda.max_memory_allocated() - before)
        record["captures"] += 1
        record["last"] = out
        record["x"] = np.asarray(dataset.arrays()["x"][:len(out[0])])
        record["state"] = {k: v.detach().cpu().clone() for k, v in exp.module.state_dict().items()}
        return out

    exp._run_capture_eval = counted


def flat_diag(diag: dict) -> dict:
    """{name: float64 tensor} of every captured number."""
    out = {f"attn/layer_{i}": a for i, a in enumerate(diag["attn"])}
    for layer, stats in diag["mlp"].items():
        out.update({f"mlp/{layer}/{k}": v for k, v in stats.items()})
    out.update({f"cls_hidden/{k}": v for k, v in diag["cls_hidden"].items()})
    out["cls_embedding"] = diag["cls_embedding"]
    return {k: torch.as_tensor(v).double().reshape(-1) for k, v in out.items()}


def capture_check(tag: str, cfg: dict, record: dict, tol: float, cka_tol: float) -> dict:
    """The run's last capture on the card against the same capture of the
    same weights on the same spectra, run by the port on the CPU at the
    config's own precision: relative L2 per captured tensor within ``tol``.
    The three activation shares (sparsity, dead and saturated fractions)
    count elements on either side of a threshold; they are held as shares
    of all elements (their norm floored at 1, as the training checks floor
    near-zero gradients), since in bf16 a pre-activation one rounding away
    from a threshold moves a count of a few elements by a large relative
    amount. A probe set (standard-normal spectra) is captured on both too,
    by a direct call: its per-token captures, the MLP activation samples,
    must lie DISTINCT limits from the served ones, and its captures within
    ``tol`` of the CPU's. The CKA monitor's layer-by-layer CKA matrix is
    held within ``cka_tol`` on the probe capture. On the served capture it
    is reported only: the synthetic spectra's CLS states differ by ~1e-5
    of their norm at these weights (``rep_spread``), so rounding at 1e-7
    already moves its entries by ~1e-5."""
    import copy

    import numpy as np

    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.viz.diagnostics import CKAMonitor, capture_diagnostics, cka_matrix

    rate = float(cfg["viz"].get("sample_rate", 0.15))
    models = {}
    for device in ("cpu", "cuda"):
        models[device] = get_model(copy.deepcopy(cfg)).module.to(device)
        models[device].load_state_dict(record["state"], strict=True)
    x = torch.from_numpy(record["x"])
    probe = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    diags = {"served": (record["last"][2], capture_diagnostics(models["cpu"], x, rate)[1]),
             "probes": (capture_diagnostics(models["cuda"], probe.cuda(), rate)[1],
                        capture_diagnostics(models["cpu"], probe, rate)[1])}
    out = dict(capture_samples=len(x), capture_tol=tol, cka_tol=cka_tol)
    monitor = CKAMonitor()
    for name, (card, cpu) in diags.items():
        card_t, cpu_t = flat_diag(card), flat_diag(cpu)
        check(card_t.keys() == cpu_t.keys(),
              f"{tag}: {name} captured {sorted(card_t)} vs CPU {sorted(cpu_t)}")
        errs = {k: rel_l2(card_t[k], cpu_t[k], 1.0 if k.split("/")[-1] in SHARES else 1e-30)
                for k in cpu_t}
        worst = max(errs, key=errs.get)
        check(errs[worst] <= tol, f"{tag}: {name} capture {worst} differs from the CPU's by "
              f"relative L2 {errs[worst]} (tol {tol})")
        reps_card, reps_cpu = monitor._reps(card), monitor._reps(cpu)
        cka_card, cka_cpu = cka_matrix(reps_card, reps_card), cka_matrix(reps_cpu, reps_cpu)
        cka_err = float(abs(cka_card - cka_cpu).max())
        spread = {k: float(np.linalg.norm(v - v.mean(0)) / np.linalg.norm(v))
                  for k, v in reps_cpu.items()}
        out[name] = dict(rel_l2_max=errs[worst], rel_l2_worst=worst,
                         rel_l2_median=statistics.median(errs.values()),
                         cka_matrix=cka_card.tolist(), cka_max_abs_err=cka_err,
                         rep_spread=spread)
        check(name == "served" or cka_err <= cka_tol, f"{tag}: {name} CKA matrix differs "
              f"from the CPU's by {cka_err} (tol {cka_tol}); spread of the representations "
              f"{spread}")
    samples = [k for k in flat_diag(diags["served"][1]) if k.endswith("/sample")]
    served, probes = flat_diag(diags["served"][1]), flat_diag(diags["probes"][1])
    apart = rel_l2(torch.cat([probes[k] for k in samples]),
                   torch.cat([served[k] for k in samples]), 1e-30)
    check(apart >= DISTINCT * tol, f"{tag}: the probes' activation samples only {apart} apart "
          f"(relative L2): the check cannot tell inputs apart at tol {tol}")
    out.update(probe_samples_apart=apart, probe_samples_apart_min=DISTINCT * tol)
    return out


def rendering_check(tag: str, text: str, viz_dir: str, plot_dir: str, model_name: str) -> bool:
    """With matplotlib, the GIFs, the CKA report and the test report must be
    written and nothing skipped; without it (the card's machine), the only
    lines that may say "skipped" are those naming matplotlib."""
    import importlib.util

    skipped = [ln for ln in text.splitlines() if "skipped" in ln]
    if importlib.util.find_spec("matplotlib") is None:
        check(all("matplotlib" in ln for ln in skipped), f"{tag}: {skipped}")
        return False
    check(not skipped, f"{tag}: {skipped}")
    gifs = os.path.join(viz_dir, model_name)
    for key in ("distribution", "activation", "attention", "attention_analytics",
                "embedding", "collinearity"):
        check(os.path.isfile(os.path.join(gifs, f"{key}.gif")), f"{tag}: no {key}.gif")
    check(os.path.isfile(os.path.join(gifs, "cka_report.png")), f"{tag}: no cka_report.png")
    for fig in ("pred_vs_true", "residual_hist", "error_vs_true", "metric_bars",
                "qq_residuals", "summary"):
        check(os.path.isfile(os.path.join(plot_dir, model_name, f"{fig}.png")),
              f"{tag}: no {fig}.png")
    return True


def viz_experiment(cfg: dict, record: dict, **kw):
    """An Experiment over N_INPUTS in-memory spectra with W&B asked for, its
    captures counted and its epoch lines kept."""
    import copy

    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.train.loop import Experiment

    data = make_dummy_spectra(n=N_INPUTS, length=cfg["model"]["image_size"], seed=1)
    exp = Experiment(copy.deepcopy(cfg), use_wandb=True, device="cuda",
                     datamodule=SpecDataModule(cfg, source=data), **kw)
    count_captures(exp, record)
    log_epoch = exp.logger.log_epoch

    def kept(epoch, metrics, step=None):
        record["epochs"].append((epoch, dict(metrics)))
        log_epoch(epoch, metrics, step)

    exp.logger.log_epoch = kept
    return exp


def new_record() -> dict:
    return dict(captures=0, run_peak_bytes=0, capture_peak_bytes=0, epochs=[])


def step_profile(exp) -> dict:
    """torch.profiler's device time of one further training step."""
    from vit_tpu_torch.train.optim import OptSpec, schedule_scale

    steps = -(-len(exp.datamodule.train) // exp.batch_size)
    spec = OptSpec.from_config(exp.config, steps, monitor_metric=exp.monitor)
    arrays = exp.datamodule.train.arrays()
    batch = {k: torch.from_numpy(arrays[k][:exp.batch_size]).cuda() for k in ("x", "label")}
    return device_profile(lambda: exp.train_step(batch, spec, schedule_scale(spec)))


def default_run(cfg: dict, expect: dict, kernels) -> dict:
    """(h) baseline.yaml as ``./launch.sh run`` trains it, with W&B asked for
    and the diagnostics on, for three epochs; a SIGTERM after the first step
    of epoch 1 must stop it at the end of epoch 1 with ``last`` saved, and a
    resume from ``last`` must start at epoch 2."""
    import contextlib
    import signal

    from vit_tpu_torch.ops._build import reset_launches

    tag = "h_baseline_default_run"
    steps = -(-N_INPUTS // BATCH)
    first, resumed = new_record(), new_record()
    tee = Tee(sys.stdout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with contextlib.redirect_stdout(tee):
        exp = viz_experiment(cfg, first)
        frozen_flag = exp._frozen_flag

        def sigterm_in_epoch_1(epoch):  # read once at the start of each epoch
            if epoch == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return frozen_flag(epoch)

        exp._frozen_flag = sigterm_in_epoch_1
        t0 = time.perf_counter()
        exp.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        first["run_peak_bytes"] = max(first["run_peak_bytes"], torch.cuda.max_memory_allocated())
        first_text, first_meta = tee.text, exp.ckpt.read_meta()
        exp2 = viz_experiment(cfg, resumed, ckpt_path="last")
        exp2.run()
    launches = {n: k.launches for n, k in kernels.items()}
    text = tee.text
    # epochs 0 and 1 until the preemption, then epoch 2 after the resume
    check_launches(tag, launches, with_sites(expect, exp.bundle.vit_config,
                                             counted_steps(exp, 2 * steps)
                                             + counted_steps(exp2, steps)))
    check("[logger] wandb not installed — console logging only" in first_text,
          f"{tag}: no console-fallback line")
    check("[preempt] signal 15 received" in first_text
          and "[experiment] preemption stop at epoch 1 (resume with --ckpt last)" in first_text,
          f"{tag}: the SIGTERM did not stop the run at the end of epoch 1")
    path = "per-step" if exp.fused is None else "fused (CUDA graph)"
    check(exp.step == 2 * steps and first_meta.get("last_epoch") == 1,
          f"{tag}: stopped at step {exp.step}, last epoch {first_meta.get('last_epoch')}")
    check(first["captures"] == 2 and [e for e, _ in first["epochs"]] == [0, 1, -1],
          f"{tag}: {first['captures']} captures, epochs {[e for e, _ in first['epochs']]}")
    check("[experiment] resumed from last at epoch 2" in text and exp2.step == 3 * steps
          and resumed["captures"] == 1, f"{tag}: the resume ran to step {exp2.step} with "
          f"{resumed['captures']} captures")
    rendered = rendering_check(tag, text, cfg["viz"]["save_dir"], os.environ["PLOT_DIR"],
                               exp.bundle.model_name)
    held = capture_check(tag, cfg, first, CAPTURE_TOL[tag], CKA_TOL[tag])
    epoch1 = first["epochs"][1][1]
    step_ms = epoch1["epoch_time_s"] * 1e3 / steps
    prof = step_profile(exp2)
    vc = exp.bundle.vit_config
    row = dict(phase="train", run=tag, T=vc.seq_len, layers=vc.num_hidden_layers,
               dtype=str(vc.dtype), batch=BATCH, inputs=N_INPUTS, steps=steps, path=path,
               epochs_run=[e for e, _ in first["epochs"] + resumed["epochs"]],
               train_loss=epoch1["train_loss"], val_mae=epoch1.get("val_mae"),
               cka_mean=epoch1.get("cka/mean"), smoke_ms_per_step=step_ms,
               smoke_spectra_per_s=BATCH * 1e3 / step_ms, run_seconds=run_s,
               peak_mem_bytes=first["run_peak_bytes"],
               capture_peak_bytes=first["capture_peak_bytes"],
               captures=[first["captures"], resumed["captures"]], launches=launches,
               expected_launches=expect, preempted_at_epoch=1, resumed_at_epoch=2,
               rendered=rendered, device_ms_per_step=prof["device_ms"],
               device_busy_share=prof["device_ms"] / step_ms, top_device_ops=prof["top"],
               **held)
    emit(row)
    return row


def diagnostics_run(cfg: dict, expect: dict, kernels, cap: int) -> dict:
    """(i) stride1.yaml with baseline's diagnostics, CKA, log_mfu against the
    H100's bf16 peak and a profiler trace of the steady-state epoch."""
    import contextlib
    import json as _json

    from vit_tpu_torch.ops._build import reset_launches

    tag = "i_stride1_diagnostics"
    steps = -(-N_INPUTS // BATCH)
    record = new_record()
    tee = Tee(sys.stdout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with contextlib.redirect_stdout(tee):
        exp = viz_experiment(cfg, record)
        t0 = time.perf_counter()
        exp.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    record["run_peak_bytes"] = max(record["run_peak_bytes"], torch.cuda.max_memory_allocated())
    launches = {n: k.launches for n, k in kernels.items()}
    text = tee.text
    check_launches(tag, launches, with_sites(expect, exp.bundle.vit_config,
                                             counted_steps(exp, steps * exp.max_epochs)))
    check(record["captures"] == cfg["train"]["ep"] and len(record["x"]) == cap,
          f"{tag}: {record['captures']} captures of {len(record['x'])} spectra")
    check(f"[viz] capture batch capped at {cap} by token count "
          f"(T={exp.bundle.vit_config.seq_len}, budget=512 MB)" in text,
          f"{tag}: no capture-cap line for {cap}")
    trace = os.path.join(cfg["train"]["profile"], f"{exp.bundle.model_name}_epoch1.json")
    check(f"[experiment] profiler trace written to {trace}\n" in text and os.path.isfile(trace),
          f"{tag}: no trace of epoch 1 at {trace}")
    with open(trace) as f:
        names = {e.get("name", "") for e in _json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    traced = {k: sorted(n for n in names if pat in n) for k, pat in
              (("flash_fwd", "flash_kernel"), ("flash_bwd", "attn_bwd_fused_tc::bwd_kernel"))}
    check(all(traced.values()), f"{tag}: the trace names no kernel for {traced}")
    mfus = [(m["tflops_per_s"], m["mfu"]) for e, m in record["epochs"] if e >= 0]
    check(len(mfus) == 2 and all(0 < mfu <= 1.05 for _, mfu in mfus), f"{tag}: mfu {mfus}")
    rendered = rendering_check(tag, text, cfg["viz"]["save_dir"], os.environ["PLOT_DIR"],
                               exp.bundle.model_name)
    held = capture_check(tag, cfg, record, CAPTURE_TOL[tag], CKA_TOL[tag])
    epochs = [m for e, m in record["epochs"] if e >= 0]
    prof = step_profile(exp)
    step_ms = [m["epoch_time_s"] * 1e3 / steps for m in epochs]
    vc = exp.bundle.vit_config
    row = dict(phase="train", run=tag, T=vc.seq_len, layers=vc.num_hidden_layers,
               dtype=str(vc.dtype), batch=BATCH, inputs=N_INPUTS, steps=steps,
               train_loss=epochs[-1]["train_loss"], val_mae=epochs[-1].get("val_mae"),
               cka_mean=epochs[-1].get("cka/mean"),
               smoke_ms_per_step_by_epoch=step_ms,
               smoke_ms_per_step_note="epoch 0 includes warm-up, epoch 1 the profiler",
               tflops_per_s_by_epoch=[t for t, _ in mfus], mfu_by_epoch=[m for _, m in mfus],
               peak_tflops=cfg["train"]["peak_tflops"], run_seconds=run_s,
               peak_mem_bytes=record["run_peak_bytes"],
               capture_peak_bytes=record["capture_peak_bytes"], captures=record["captures"],
               launches=launches, expected_launches=expect, trace=os.path.basename(trace),
               traced_kernels=traced, rendered=rendered, device_ms_per_step=prof["device_ms"],
               device_busy_share=prof["device_ms"] / min(step_ms), top_device_ops=prof["top"],
               **held)
    emit(row)
    return row


def viz_runs(work: str, none: dict, kernels) -> dict:
    """Runs (h) and (i), which read the YAML files themselves as a user's run
    does; checkpoints, GIFs, reports and the trace go under ``work``."""
    import copy
    import importlib.util

    from vit_tpu_torch.config import load_config
    from vit_tpu_torch.viz.diagnostics import capture_batch_cap

    if importlib.util.find_spec("wandb") is not None:
        sys.modules["wandb"] = None  # no network here: wandb.init must never try
    if importlib.util.find_spec("matplotlib") is None:
        print("chip_smoke: matplotlib is absent on this machine: GIF and plot rendering "
              "are not exercised here (the CPU tests hold it); runs (h) and (i) hold the "
              "captured numbers only", flush=True)
    os.environ["PLOT_DIR"] = os.path.join(work, "plots")
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs/exp/att_clp")
    baseline_yaml = load_config(os.path.join(configs, "baseline.yaml"))
    default = copy.deepcopy(baseline_yaml)
    default["train"].update(batch_size=BATCH, ep=3, save=True)
    default["viz"]["save_dir"] = os.path.join(work, "viz_h")
    runs = {"h_baseline_default_run": default_run(default, none, kernels)}

    long_viz = load_config(os.path.join(configs, "stride1.yaml"))
    long_viz["viz"] = dict(copy.deepcopy(baseline_yaml["viz"]), compute_cka=True,
                           save_local=True, save_dir=os.path.join(work, "viz_i"))
    long_viz["train"].update(ep=2, log_mfu=True, peak_tflops=PEAK_BF16 / 1e12,
                             profile=os.path.join(work, "profile"))
    cap = capture_batch_cap(4066, 2, 512, 512 * 1024**2)
    check(cap == 3, f"capture_batch_cap(4066, 2, 512, 512 MB) = {cap}, not 3")
    # Two epochs of train steps and val batches, then test and its report,
    # each a pass over the spectra in batches; the captures launch no K1.
    steps = -(-N_INPUTS // BATCH)
    layers = STRIDE1_MODEL["num_hidden_layers"]
    k1 = layers * (2 * (steps + steps) + 2 * steps)
    runs["i_stride1_diagnostics"] = diagnostics_run(
        long_viz, dict(none, flash_fwd=k1, flash_bwd=2 * layers * steps), kernels, cap)
    return runs


def rope_serve_check(exp, ckpt_dir: str, none: dict, kernels) -> dict:
    """(j) after training: serve the trained RoPE weights in bf16 (as run (a)
    is held), then the probe: in fp32 on the card, the same weights with
    ``pos_encoding_type`` unset must move the per-token features at least
    DISTINCT fp32 limits, while the card's RoPE features stay within one
    limit of the CPU's. At these weights (std-0.02 init, four steps) the
    scores q.k/sqrt(d) are ~0.05, so attention is nearly uniform and RoPE
    moves the logits by ~2e-4 (a CPU rehearsal), below the bf16 logit limit:
    the per-token features in fp32 are where a missing rotation shows."""
    import copy

    cfg = {"model": dict(STRIDE1_MODEL, pos_encoding_type="rope"),
           "train": {"batch_size": BATCH, "precision": "bf16"}, "data": {"param": "log_g"},
           "noise": {"noise_level": 0}}
    calls = STRIDE1_MODEL["num_hidden_layers"] * (N_INPUTS // BATCH)
    served = serve_run("j_stride1_rope_serve_bf16", cfg, dict(none, flash_fwd=calls), 1e-2,
                       BF16_FEATURE_TOL, ckpt_dir, kernels, module=exp.module)
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.models.builder import get_model

    state = {k: v.detach().cpu() for k, v in exp.module.state_dict().items()}
    # two served spectra and two standard-normal probes, as serve_run's: the
    # synthetic spectra alone differ too little for their tokens to tell
    # positions apart at these weights
    x = torch.cat([torch.from_numpy(make_dummy_spectra(n=2, length=4096, seed=1)["flux"]),
                   torch.randn(2, 4096, generator=torch.Generator().manual_seed(2))])
    feats = {}
    for pos, device in (("rope", "cuda"), ("rope", "cpu"), (None, "cuda")):
        c = copy.deepcopy(cfg)
        c["model"]["pos_encoding_type"] = pos
        c["train"]["precision"] = "float32"
        m = get_model(c).module.to(device).eval()
        m.load_state_dict(state, strict=True)
        with torch.no_grad():
            feats[pos, device] = m.features(x.to(device)).float().cpu()
    err = (feats["rope", "cuda"] - feats["rope", "cpu"]).abs().max().item()
    moved = (feats[None, "cuda"] - feats["rope", "cuda"]).abs().max().item()
    check(err <= FP32_TOL, f"j: fp32 RoPE features differ from the CPU's by {err}")
    check(moved >= DISTINCT * FP32_TOL, f"j: without RoPE the features move only {moved}")
    return dict(serve=dict((k, served[k]) for k in (
        "smoke_spectra_per_s", "batch_ms", "device_ms_per_batch", "launches",
        "max_abs_logit_err_vs_cpu_fp32", "max_abs_feature_err_vs_cpu_fp32",
        "feature_span_probes")),
        rope_probe=dict(fp32_feature_err_vs_cpu=err, features_moved_without_rope=moved,
                        limit=FP32_TOL, min_moved=DISTINCT * FP32_TOL))


def covariance_stats_check(data) -> tuple:
    """(l) the port's covariance statistics on the card against the CPU over
    the same spectra: mean and covariance within 1e-5 relative L2 (fp32
    products summed in another order), eigenvalues within 1e-4, the ZCA
    matrix (shrinkage 0.1, eps 1e-5) within 1e-4; eigenvectors are not
    compared (signs and order inside near-degenerate clusters are
    arbitrary). ``zca_self_check`` passes on the card's statistics (its
    gate holds for the unshrunk matrix). Returns (stats, row)."""
    import numpy as np

    from vit_tpu_torch.models.preprocessor import compute_zca_matrix
    from vit_tpu_torch.prepca.stats import compute_covariance_stats, zca_self_check

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = compute_covariance_stats(data, device="cuda")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = compute_covariance_stats(data, device="cpu")
    cpu_s = time.perf_counter() - t0
    errs = {k: rel(getattr(card, k), getattr(cpu, k)) for k in ("mean", "cov", "eigvals")}
    zca = [compute_zca_matrix(st.eigvecs, st.eigvals, eps=1e-5, shrinkage=0.1)
           for st in (card, cpu)]
    errs["zca"] = rel(*zca)
    tols = {"mean": 1e-5, "cov": 1e-5, "eigvals": 1e-4, "zca": 1e-4}
    for k, tol in tols.items():
        check(errs[k] <= tol, f"l: {k} on the card differs from the CPU's by relative L2 "
              f"{errs[k]} (tol {tol})")
    P0 = compute_zca_matrix(card.eigvecs, card.eigvals, eps=1e-5, shrinkage=0.0)
    rel_err, cond_before, cond_after = zca_self_check(P0, card.cov, eps=1e-5)
    row = dict(samples=int(data.shape[0]), pixels=int(data.shape[1]), rel_l2=errs, tol=tols,
               card_seconds=card_s, cpu_seconds=cpu_s,
               eigval_min=float(card.eigvals.min()), eigval_max=float(card.eigvals.max()),
               zca_self_check=dict(rel=rel_err, cond_before=cond_before,
                                   cond_after=cond_after))
    return card, row


def zca_train_run(work: str, none: dict, kernels) -> dict:
    """(l) stride1.yaml with a ZCA preprocessor built from the port's own
    statistics, two epochs with freeze_epochs: 1, train.save and async
    checkpoints, then test of best; a fresh Experiment's test of best
    reproduces the run's test metrics exactly."""
    import copy

    import numpy as np

    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.models.preprocessor import compute_zca_matrix
    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.train.loop import Experiment
    from vit_tpu_torch.utils import save_cov_stats

    tag = "l_stride1_zca_train"
    flux = make_dummy_spectra(n=COV_SAMPLES, length=4096, seed=2)["flux"]
    stats, stats_row = covariance_stats_check(flux)
    del flux
    cov_path = save_cov_stats(stats.as_dict(), os.path.join(work, "cov.npz"))
    cfg = copy.deepcopy(STRIDE1_TRAIN)
    cfg["train"].update(ep=2, save=True, async_ckpt=True)
    cfg["warmup"] = {"preprocessor": "zca", "cov_path": cov_path, "shrinkage": 0.1,
                     "freeze_epochs": 1}
    data = make_dummy_spectra(n=N_INPUTS, length=4096, seed=1)
    exp = Experiment(copy.deepcopy(cfg), device="cuda", datamodule=SpecDataModule(cfg, source=data))
    name, length = exp.bundle.model_name, exp.module.input_length
    check(name == "ZCA_fz1_s1_ViT_p32_h128_l3_a2_s1_pSW" and length == 4096,
          f"{tag}: model {name}, input length {length}")
    p0 = compute_zca_matrix(stats.eigvecs, stats.eigvals, eps=1e-5, shrinkage=0.1)
    weight = exp.module.preprocessor.linear.weight
    check(torch.equal(weight.detach().cpu(), torch.from_numpy(p0)), f"{tag}: not prefilled")
    exp.datamodule.setup("fit")
    # The first step's CPU reference is cut to make room for (D): (d) holds
    # stride1's first step against the CPU, P2 the ZCA statistics.
    grads = dict(first_step_cpu_reference="cut for (D)'s time")
    epochs, kept = [], []
    log_epoch = exp.logger.log_epoch

    def record(epoch, metrics, step=None):
        epochs.append((epoch, dict(metrics)))
        if epoch >= 0:
            kept.append(weight.detach().cpu().clone())
        log_epoch(epoch, metrics, step)

    exp.logger.log_epoch = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    test_metrics = exp.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    steps, layers = -(-N_INPUTS // BATCH), STRIDE1_MODEL["num_hidden_layers"]
    # two epochs of train steps and val batches, then the test batches
    expect = with_sites(dict(none, flash_fwd=layers * (2 * (steps + steps) + steps),
                             flash_bwd=2 * layers * steps),
                        exp.bundle.vit_config, counted_steps(exp, 2 * steps))
    check_launches(tag, launches, expect)
    frozen = [m.get("preprocessor_frozen") for e, m in epochs if e >= 0]
    check(frozen == [1.0, 0.0], f"{tag}: preprocessor_frozen {frozen}")
    check(torch.equal(kept[0], torch.from_numpy(p0)), f"{tag}: the preprocessor moved in epoch 0")
    moved = (kept[1] - kept[0]).abs().max().item()
    check(moved > 0, f"{tag}: the preprocessor did not move in epoch 1")
    fresh = Experiment(copy.deepcopy(cfg), device="cuda",
                       datamodule=SpecDataModule(cfg, source=data))
    again = fresh.test(ckpt="best")
    check(again == test_metrics, f"{tag}: test of best {again} vs in-run {test_metrics}")
    prof = step_profile(exp)
    train = [m for e, m in epochs if e >= 0]
    step_ms = [m["epoch_time_s"] * 1e3 / steps for m in train]
    row = dict(phase="train", run=tag, T=exp.bundle.vit_config.seq_len, layers=layers,
               dtype=str(exp.bundle.vit_config.dtype), batch=BATCH, inputs=N_INPUTS,
               steps=steps, epochs=2, model_name=exp.bundle.model_name,
               covariance=stats_row, losses_by_epoch=[m["train_loss"] for m in train],
               preprocessor_frozen=frozen, preprocessor_moved_in_epoch_1=moved,
               test_metrics=test_metrics, fresh_test_equal=True, run_seconds=run_s,
               smoke_ms_per_step_by_epoch=step_ms, peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches, expected_launches=expect,
               device_ms_per_step=prof["device_ms"],
               device_busy_share=prof["device_ms"] / min(step_ms), top_device_ops=prof["top"],
               **grads)
    emit(row)
    return row


def preprocessor_serve_runs(cov_path: str, ckpt_dir: str, none: dict, kernels) -> dict:
    """(m) serve stride1 in bf16 behind a PCA (r 2048) and an attention (r
    1024) preprocessor: the builder's printed image_size and model name are
    vit_tpu's (tests/test_torch_port_preprocessor.py holds the port's lines
    equal to vit_tpu's), T = 2018 and 994, K1 three launches a batch (the
    attention one sets ``attn_impl: flash``: ``auto`` takes xla below 1024
    tokens)."""
    import contextlib
    import copy

    from vit_tpu_torch.models.builder import get_model

    calls = STRIDE1_MODEL["num_hidden_layers"] * (N_INPUTS // BATCH)
    cases = {
        "m_stride1_pca2048_serve_bf16": (
            {"preprocessor": "pca", "r": 2048}, {}, 2018,
            ["[builder] Auto-adjusting image_size: 4096 -> 2048",
             "[builder] Created PCA with r=2048, bias=True preprocessor -> "
             "PCA2048_fz0_ViT_p32_h128_l3_a2_s1_pSW"]),
        "m_stride1_attn1024_serve_bf16": (
            {"preprocessor": "attention", "r": 1024}, {"attn_impl": "flash"}, 994,
            ["[builder] Auto-adjusting image_size: 4096 -> 1024",
             "[builder] Created Attention preprocessor with r=1024, scale_by_eigvals=True "
             "preprocessor -> Attn1024_scaled_fz0_ViT_p32_h128_l3_a2_s1_pSW"]),
    }
    runs = {}
    for tag, (warmup, model, seq_len, lines) in cases.items():
        cfg = {"model": dict(STRIDE1_MODEL, **model),
               "train": {"batch_size": BATCH, "precision": "bf16"}, "data": {"param": "log_g"},
               "noise": {"noise_level": 0}, "warmup": dict(warmup, cov_path=cov_path)}
        out = io.StringIO()
        built = copy.deepcopy(cfg)
        with contextlib.redirect_stdout(out):
            bundle = get_model(built, generator=torch.Generator().manual_seed(0))
        printed = out.getvalue().splitlines()
        check(printed == lines and bundle.vit_config.seq_len == seq_len,
              f"{tag}: printed {printed}, T {bundle.vit_config.seq_len}")
        row = serve_run(tag, cfg, dict(none, flash_fwd=calls), 1e-2, BF16_FEATURE_TOL,
                        ckpt_dir, kernels, module=bundle.module)
        runs[tag] = dict(row, image_size=built["model"]["image_size"], printed=printed)
    return runs


def optimizer_runs(kernels) -> dict:
    """(n) each optimizer three steps on the card and on the CPU from the same
    weights, batches and dropout seeds at run (e)'s shape (baseline, flash,
    fused MLP, fp32), optax's clip and learning-rate injection as the
    training step applies them. The parameters after step 3 must agree
    within 1e-5 relative L2 (adam and adamw with bf16 first moments 2e-2),
    over every parameter but the attention key biases: their gradients are
    zero in exact arithmetic, rounding noise on each side, which rprop's
    sign steps and adamax's and adam's normalised steps turn into moves of
    up to ~lr per element that differ between the two; they are held to
    stay within 10 * lr * steps of each other and reported."""
    import copy

    import numpy as np

    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.train.loop import loss_and_grads
    from vit_tpu_torch.train.optim import (
        OptSpec, build_optimizer, clip_by_global_norm, set_learning_rate, state_bytes,
    )

    cfg = copy.deepcopy(BASELINE_TRAIN)
    base = get_model(copy.deepcopy(cfg), generator=torch.Generator().manual_seed(0))
    vc = base.vit_config
    data = make_dummy_spectra(n=3 * BATCH, length=4096, seed=1)
    labels = torch.from_numpy((data["params"]["log_g"] / 5.0).astype(np.float32)).view(-1, 1)
    batches = [{"x": torch.from_numpy(data["flux"][i * BATCH:(i + 1) * BATCH]),
                "label": labels[i * BATCH:(i + 1) * BATCH]} for i in range(3)]
    seeds = [[list(range(100 * i, 100 * i + base.module.num_dropout_sites))] for i in range(3)]
    lr, steps = 1e-3, 3
    cases = [(n, None, 1e-5) for n in ("rmsprop", "adadelta", "adagrad", "adamax", "lbfgs",
                                        "rprop", "asgd", "sparseadam", "adam", "adamw", "sgd")]
    cases += [("adam", "bf16", 2e-2), ("adamw", "bf16", 2e-2)]
    out, launches = {}, {n: 0 for n in kernels}
    for name, moment, tol in cases:
        params = {}
        for device in ("cuda", "cpu"):
            m = get_model(copy.deepcopy(cfg)).module.to(device).train()
            m.load_state_dict(base.module.state_dict(), strict=True)
            # The card's as Experiment builds it there: graph-safe.
            opt = build_optimizer(OptSpec(lr=lr, opt_type=name, weight_decay=0.01,
                                          moment_dtype=moment), m.parameters(),
                                  capturable=device == "cuda")
            reset_launches()
            for b, sd in zip(batches, seeds):
                loss_and_grads(m, {k: v.to(device) for k, v in b.items()}, vc.task_type,
                               base.loss_name, sd)
                clip_by_global_norm([p.grad for p in m.parameters()], 0.5)
                set_learning_rate(opt, lr)
                opt.step()
            if device == "cuda":
                torch.cuda.synchronize()
                for n, k in kernels.items():
                    launches[n] += k.launches
            params[device] = {k: v.detach().float().cpu() for k, v in m.named_parameters()}
        keys = [k for k in params["cpu"] if not k.endswith("attention.key.bias")]
        diff = torch.sqrt(sum((params["cuda"][k] - params["cpu"][k]).square().sum() for k in keys))
        norm = torch.sqrt(sum(params["cpu"][k].square().sum() for k in keys))
        rel = (diff / norm).item()
        key_bias = max((params["cuda"][k] - params["cpu"][k]).abs().max().item()
                       for k in params["cpu"] if k.endswith("attention.key.bias"))
        finite = all(torch.isfinite(v).all() for v in params["cuda"].values())
        label = name if moment is None else f"{name}_{moment}"
        check(finite and rel <= tol, f"n: {label}: parameters after {steps} steps differ from "
              f"the CPU's by relative L2 {rel} (tol {tol})")
        check(key_bias <= 10 * lr * steps, f"n: {label}: key biases apart by {key_bias}")
        out[label] = dict(rel_l2=rel, tol=tol, key_bias_max_abs_diff=key_bias)
    sizes = {}
    for moment in (None, "bf16"):
        m = get_model(copy.deepcopy(cfg)).module.cuda().train()
        opt = build_optimizer(OptSpec(lr=lr, opt_type="adamw", moment_dtype=moment),
                              m.parameters(), capturable=True)
        loss_and_grads(m, {k: v.cuda() for k, v in batches[0].items()}, vc.task_type,
                       base.loss_name, seeds[0])
        opt.step()
        sizes["fp32" if moment is None else moment] = state_bytes(opt)
    check(sizes["bf16"] < sizes["fp32"], f"n: adamw state bytes {sizes}")
    reset_launches()
    row = dict(phase="train", run="n_optimizers", shape="(e)", steps=steps, lr=lr,
               weight_decay=0.01, results=out, adamw_state_bytes=sizes,
               parameters=sum(p.numel() for p in base.module.parameters()), launches=launches)
    emit(row)
    return row


def stream_dropout_run(none: dict, kernels) -> dict:
    """(o) run (e) with ``fast_dropout: false`` and ``remat: true``: one epoch
    (K2 and K6 launch with their hash mask, K2 and K3 twice a step as the
    layers are recomputed); the stream sites' keep share within 4 standard
    deviations of 0.9; a step repeated from the same state and seeds gives
    bit-identical gradients, and the same step without remat the same ones
    (the recompute drew the same masks); the flash route's output is the
    same with fast_dropout true and false (the probabilities keep the hash)."""
    import copy

    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.models.attention import MultiHeadSelfAttention
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.ops.dropout import stream_dropout
    from vit_tpu_torch.train.loop import Experiment, loss_and_grads

    tag = "o_baseline_stream_dropout_remat"
    cfg = copy.deepcopy(BASELINE_TRAIN)
    cfg["model"].update(fast_dropout=False, remat=True)
    data = make_dummy_spectra(n=N_INPUTS, length=4096, seed=1)
    exp = Experiment(copy.deepcopy(cfg), device="cuda", datamodule=SpecDataModule(cfg, source=data))
    exp.datamodule.setup("fit")
    arrays = exp.datamodule.train.arrays()
    batch = {k: torch.from_numpy(arrays[k][:BATCH]).cuda() for k in ("x", "label")}
    vc = exp.bundle.vit_config
    seeds = [list(range(500, 500 + exp.module.num_dropout_sites))]

    def grads(module):
        loss_and_grads(module, batch, vc.task_type, exp.bundle.loss_name, seeds)
        return [p.grad.clone() for p in module.parameters()]

    first, second = grads(exp.module.train()), grads(exp.module)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          f"{tag}: a repeated step gave other gradients")
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg["model"]["remat"] = False
    plain = get_model(plain_cfg).module.cuda().train()
    plain.load_state_dict(exp.module.state_dict(), strict=True)
    no_remat = grads(plain)
    remat_rel = max(rel_l2(a, b, 1e-30) for a, b in zip(first, no_remat))
    check(remat_rel <= 1e-6, f"{tag}: remat and no remat differ by relative L2 {remat_rel}")
    shape = (BATCH, vc.seq_len, vc.hidden_size)
    ones = torch.ones(shape, device="cuda")
    stream_seeds = [seeds[0][0]] + [seeds[0][1 + 3 * i + j] for i in range(vc.num_hidden_layers)
                                    for j in (1, 2)]
    kept = sum(int((stream_dropout(ones, vc.hidden_dropout, s) != 0).sum()) for s in stream_seeds)
    n = len(stream_seeds) * ones.numel()
    keep = 1.0 - vc.hidden_dropout
    share, sigma = kept / n, (keep * (1 - keep) / n) ** 0.5
    check(abs(share - keep) <= 4 * sigma, f"{tag}: keep share {share} (sigma {sigma})")
    x = torch.randn(BATCH, vc.seq_len, vc.hidden_size, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    outs = []
    for fast in (True, False):
        attn = MultiHeadSelfAttention(vc.hidden_size, vc.num_attention_heads, impl="flash",
                                      dropout_rate=vc.attention_dropout, out_dropout_rate=0.0,
                                      fast_dropout=fast).cuda()
        attn.load_state_dict(exp.module.vit.encoder.layer[0].attention.state_dict())
        with torch.no_grad():
            outs.append(attn.train()(x, seeds=(seeds[0][1], seeds[0][2])))
    check(torch.equal(*outs), f"{tag}: the flash route's probabilities are not the hash mask's")
    for p in exp.module.parameters():
        p.grad = None

    steps, layers = -(-N_INPUTS // BATCH), BASELINE_MODEL["num_hidden_layers"]
    expect = dict(none, short_fwd=layers * (2 * steps + steps), short_bwd=layers * steps,
                  fused_mlp_fwd=layers * (2 * steps + steps), fused_mlp_bwd=layers * steps)
    torch.cuda.synchronize()
    reset_launches()
    metrics = exp.fit()
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    expect = with_sites(expect, exp.bundle.vit_config, counted_steps(exp, steps * exp.max_epochs))
    check_launches(tag, launches, expect)
    losses = [float(v) for v in exp.epoch_losses]
    check(all(math.isfinite(v) for v in losses), f"{tag}: losses {losses}")
    prof = step_profile(exp)
    step_ms = metrics["epoch_time_s"] * 1e3 / steps
    row = dict(phase="train", run=tag, T=vc.seq_len, layers=layers, dtype=str(vc.dtype),
               batch=BATCH, steps=steps, losses=losses, keep_share=share, keep_sigma=sigma,
               stream_elements=n, repeated_step_bit_identical=True,
               remat_vs_no_remat_rel_l2=remat_rel, flash_hash_mask_kept=True,
               smoke_ms_per_step=step_ms, launches=launches, expected_launches=expect,
               device_ms_per_step=prof["device_ms"],
               device_busy_share=prof["device_ms"] / step_ms, top_device_ops=prof["top"])
    emit(row)
    return row


# -- runs (w), (p), (q): many steps, per step and as a CUDA graph ------------
WINDOW_INPUTS = 1024  # 64 steps an epoch at batch 16
WINDOW_EPOCHS = 3
FUSED_RTOL, FUSED_ATOL = 1e-6, 1e-7  # vit_tpu's bound, tests/test_fused_epoch.py:26-28
PROFILE_STEPS = 16  # per-step steps in a device-time window


def window_fit(cfg: dict, inputs: int, epochs: int, fused, **train) -> dict:
    """``epochs`` epochs of ``inputs`` synthetic spectra (an image config:
    the synthetic images its data section sizes) at the config's batch on
    the card from seed 0, per step (``fused`` False) or fused: the
    Experiment, its epochs' metrics, host ms/step of each epoch, the steady
    one (epochs 1 on), the fit's seconds, peak MiB (the graph's pool
    included) and the wrappers' counts."""
    import copy

    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.images import ImageDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.ops._build import KERNELS, reset_launches
    from vit_tpu_torch.train.loop import Experiment

    cfg = copy.deepcopy(cfg)
    cfg["train"].update(ep=epochs, fused_epoch=fused, **train)
    if cfg["model"].get("input_kind") == "image":
        dm = ImageDataModule(cfg)
    else:
        data = make_dummy_spectra(n=inputs, length=cfg["model"]["image_size"], seed=1)
        dm = SpecDataModule(cfg, source=data)
    exp = Experiment(copy.deepcopy(cfg), device="cuda", seed=0, datamodule=dm)
    logged = []
    exp.logger.log_epoch = lambda epoch, metrics, step=None: logged.append(dict(metrics))
    steps = -(-inputs // cfg["train"]["batch_size"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    exp.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    host = [m["epoch_time_s"] * 1e3 / steps for m in logged]
    check(len(logged) == epochs and all(math.isfinite(m["train_loss"]) for m in logged),
          f"window fit: epochs {logged}")
    check((exp.fused is not None) == bool(fused), f"window fit: fused {exp.fused} for {fused}")
    return dict(exp=exp, logged=logged, steps=steps, host_ms_per_step=host,
                steady_host_ms_per_step=statistics.mean(host[1:]), fit_seconds=fit_s,
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                reserved_mib=torch.cuda.memory_reserved() / 2**20,
                counts={n: k.launches for n, k in KERNELS.items()},
                params={k: v.detach().float().cpu().clone()
                        for k, v in exp.module.state_dict().items()})


def window_device(fit: dict) -> dict:
    """torch.profiler's device time a step over a further window, after the
    fit's figures are taken: PROFILE_STEPS per-step steps on batches
    already on the card, or one more fused epoch of replays; the kernels'
    names and calls in it."""
    from vit_tpu_torch.train.optim import OptSpec, schedule_scale

    exp, steps = fit["exp"], fit["steps"]
    if exp.fused is None:
        spec = OptSpec.from_config(exp.config, steps, monitor_metric=exp.monitor)
        sched = schedule_scale(spec)
        arrays = exp.datamodule.train.arrays()
        n, bs = min(PROFILE_STEPS, steps), exp.batch_size
        batches = [{k: torch.from_numpy(arrays[k][i * bs:(i + 1) * bs]).cuda()
                    for k in ("x", "label")} for i in range(n)]
        prof = device_profile(lambda: [exp.train_step(b, spec, sched) for b in batches], top=12)
    else:
        fused = exp.fused
        prof = device_profile(lambda: fused.run([exp.step // steps], [0.0], False), top=12)
        n = steps
    check(prof["device_ms"] > 0, "window: torch.profiler saw no device time")
    return dict(device_ms_per_step=prof["device_ms"] / n, window_steps=n,
                busy_share=prof["device_ms"] / n / fit["steady_host_ms_per_step"],
                top_device_ops=prof["top"])


def device_gaps(fn, top: int = 5) -> dict:
    """The device timeline of ``fn`` under torch.profiler: its device events
    (kernels, copies, fills) merged into busy intervals, the idle gaps
    between them, and the ``top`` largest gaps with the events on either
    side: what stands between the kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # record_function scopes (``Optimizer.step#AdamW.step``) have device-side
    # spans over many kernels and the gaps between them: left out.
    evs = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start
                 and not e.is_user_annotation and "#" not in e.name)
    check(len(evs) > 1, "device_gaps: torch.profiler saw no device events")
    gaps, busy, end, prev = [], 0.0, evs[0][0], evs[0][2]
    for start, stop, name in evs:
        if start > end:
            gaps.append((start - end, prev[:60], name[:60]))
        busy += max(0.0, stop - max(start, end))
        if stop > end:
            end, prev = stop, name
    gaps.sort(reverse=True)
    by_pair = {}  # idle time summed over each (event before, event after) pair
    for g, a, b in gaps:
        us, n = by_pair.get((a, b), (0.0, 0))
        by_pair[(a, b)] = (us + g, n + 1)
    pairs = sorted(by_pair.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(events=len(evs), span_ms=(end - evs[0][0]) / 1e3, busy_ms=busy / 1e3,
                idle_ms=sum(g for g, _, _ in gaps) / 1e3, gaps=len(gaps),
                top_gaps=[dict(us=g, after=a, before=b) for g, a, b in gaps[:top]],
                idle_by_pair=[dict(us=us, gaps=n, after=a, before=b)
                              for (a, b), (us, n) in pairs])


def replay_span(fit: dict) -> dict:
    """One epoch of replays of a fused fit's graph timed on both clocks:
    the device span a step (CUDA events around the replays: kernels and
    the gaps between them) and the host's time to enqueue one."""
    fused = fit["exp"].fused
    fused.counter.zero_()  # the last epoch's buffers, replayed again
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(fused.steps):
        fused._run_step()
    enqueue_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    fused.counter.zero_()
    gaps = device_gaps(lambda: [fused._run_step() for _ in range(4)])
    return dict(replay_span_ms_per_step=start.elapsed_time(end) / fused.steps,
                replay_enqueue_ms_per_step=enqueue_s * 1e3 / fused.steps,
                replay_timeline_4_steps=gaps)


def epoch_end(fit: dict) -> dict:
    """What an epoch's end costs on the host clock: the validation forward
    with its read-back (per step: ``_run_eval``'s batches, each read back;
    fused: one more fused epoch with its validation minus one without), and
    the host's metrics, plateau and early-stopping steps on the logits."""
    import copy

    import numpy as np

    exp = fit["exp"]
    dm = exp.datamodule
    torch.cuda.synchronize()
    if exp.fused is None:
        t0 = time.perf_counter()
        logits, labels = exp._run_eval(dm.val, dm.val_batch_size)
        val_s = time.perf_counter() - t0
    else:
        fused, epoch = exp.fused, exp.step // fit["steps"]
        t0 = time.perf_counter()
        logits = fused.run([epoch], [0.0], True)[0][2]
        with_val = time.perf_counter() - t0
        t0 = time.perf_counter()
        fused.run([epoch + 1], [0.0], False)
        val_s = with_val - (time.perf_counter() - t0)
        labels = np.asarray(dm.val.arrays()["label"])
    t0 = time.perf_counter()
    mon = exp._metrics_from_arrays(logits, labels, "val")[f"val_{exp.monitor}"]
    for scheduler in (exp.plateau, exp.early):  # copies: the run's own are not stepped
        if scheduler is not None:
            copy.deepcopy(scheduler).step(mon)
    host_s = time.perf_counter() - t0
    return dict(val_forward_and_read_ms=val_s * 1e3, val_rows=len(labels),
                metrics_plateau_early_stop_ms=host_s * 1e3)


def params_close(a: dict, b: dict) -> tuple:
    """(every tensor within FUSED_RTOL/FUSED_ATOL, bit-equal, max abs diff)."""
    close = all(torch.allclose(a[k], b[k], rtol=FUSED_RTOL, atol=FUSED_ATOL) for k in a)
    equal = all(torch.equal(a[k], b[k]) for k in a)
    return close, equal, max((a[k] - b[k]).abs().max().item() for k in a)


def graph_launches(fit: dict, expect_per_step: dict, kernels) -> dict:
    """Launches of a fused fit counted from its replays: each graph's
    launches at capture times its replays (stated so), plus the calls made
    outside a graph (the warm-up steps, the validation forwards). Every
    graph must hold ``expect_per_step`` launches a step."""
    fused = fit["exp"].fused
    check(len(fused.graphs) >= 1 and fused.replays > 0, f"no replays: {fused.replays}")
    expect_per_step = with_sites(expect_per_step, fit["exp"].bundle.vit_config, 1)
    per_graph = list(fused.captured_launches.values())
    for got in per_graph:
        check_launches("a captured step", got, expect_per_step)
    replayed = {n: per_graph[0][n] * fused.replays for n in kernels}
    outside = {n: fit["counts"][n] - len(per_graph) * per_graph[0][n] for n in kernels}
    total = {n: replayed[n] + outside[n] for n in kernels}
    for n, per_step in expect_per_step.items():
        check(per_step == 0 or replayed[n] > 0, f"{n}: no launch from the replays")
    return dict(launches=total, launches_from_replays=replayed, launches_outside_graphs=outside,
                launch_count_method="capture count x replays, plus calls outside the graph",
                captured_launches_per_step=per_graph[0], graphs=len(fused.graphs),
                replays=fused.replays, eager_steps=fused.eager_steps,
                capture_seconds=fused.capture_seconds)


def fit_summary(fit: dict) -> dict:
    return {k: fit[k] for k in ("host_ms_per_step", "steady_host_ms_per_step", "fit_seconds",
                                "peak_mib", "reserved_mib")}


def window_runs(kernels) -> dict:
    """(w) the per-step path over a window of many steps: 1024 spectra at
    batch 16 (64 steps an epoch), 3 epochs, at baseline's training shape
    (flash, fused MLP, fp32; the per-step half of run (p)) and stride1's
    (bf16, remat: mlp); host ms/step of epochs 1-2, device ms/step of a
    further window and the busy share."""
    none = {n: 0 for n in kernels}
    fit = window_fit(STRIDE1_TRAIN, WINDOW_INPUTS, WINDOW_EPOCHS, False)
    layers, steps = STRIDE1_MODEL["num_hidden_layers"], fit["steps"]
    dm = fit["exp"].datamodule
    val_batches = -(-len(dm.val) // dm.val_batch_size)
    expect = with_sites(dict(none, flash_fwd=layers * (steps + val_batches) * WINDOW_EPOCHS,
                             flash_bwd=layers * steps * WINDOW_EPOCHS),
                        fit["exp"].bundle.vit_config, steps * WINDOW_EPOCHS)
    check_launches("w", fit["counts"], expect)
    row = dict(phase="window", run="w_stride1_per_step", inputs=WINDOW_INPUTS,
               epochs=WINDOW_EPOCHS, steps_per_epoch=steps, launches=fit["counts"],
               **fit_summary(fit), **window_device(fit))
    emit(row)
    return row


def graph_runs(kernels) -> dict:
    """(p) baseline's training shape in fp32 and bf16 over the window: per
    step, then ``fused_epoch: true`` from the same seed; the parameters after
    3 epochs within vit_tpu's bound (bit-equal printed); in fp32 also
    ``epoch_gather: block`` against ``step`` and ``epochs_per_dispatch: 3``
    against 1; each path's steady host ms/step, device ms/step and busy
    share, peak MiB, capture seconds and launches counted from the replays
    (3 of K2, K6, K3, K7 a step)."""
    import copy

    none = {n: 0 for n in kernels}
    layers = BASELINE_MODEL["num_hidden_layers"]
    per_step = dict(none, short_fwd=layers, short_bwd=layers, fused_mlp_fwd=layers,
                    fused_mlp_bwd=layers)
    rows = {}
    for tag, cfg in (("p_baseline_graph_fp32", BASELINE_TRAIN),
                     ("p_baseline_graph_bf16", BASELINE_BF16_TRAIN)):
        t0 = time.perf_counter()
        eager = window_fit(cfg, WINDOW_INPUTS, WINDOW_EPOCHS, False)
        eager_dev = window_device(eager)
        graph = window_fit(cfg, WINDOW_INPUTS, WINDOW_EPOCHS, True)
        launches = graph_launches(graph, per_step, kernels)
        close, equal, diff = params_close(graph["params"], eager["params"])
        check(close, f"{tag}: graph against per-step parameters apart by {diff}")
        variants = {}
        if cfg is BASELINE_TRAIN:
            for name, train in (("gather_block", {"epoch_gather": "block"}),
                                ("epochs_per_dispatch_3", {"epochs_per_dispatch": 3})):
                other = window_fit(copy.deepcopy(cfg), WINDOW_INPUTS, WINDOW_EPOCHS, True,
                                   **train)
                v_close, v_equal, v_diff = params_close(other["params"], graph["params"])
                check(v_close, f"{tag}: {name} against one epoch a dispatch, gather step, "
                      f"apart by {v_diff}")
                variants[name] = dict(within_bound=v_close, bit_equal=v_equal,
                                      max_abs_diff=v_diff, **fit_summary(other))
        graph_dev = window_device(graph)
        graph_dev.update(replay_span(graph), **epoch_end(graph))
        eager_dev.update(epoch_end(eager))
        row = dict(phase="graph", run=tag, inputs=WINDOW_INPUTS, epochs=WINDOW_EPOCHS,
                   steps_per_epoch=graph["steps"], rtol=FUSED_RTOL, atol=FUSED_ATOL,
                   graph_vs_per_step_within_bound=close, graph_vs_per_step_bit_equal=equal,
                   graph_vs_per_step_max_abs_diff=diff,
                   per_step=dict(**fit_summary(eager), **eager_dev, launches=eager["counts"]),
                   graph=dict(**fit_summary(graph), **graph_dev), variants=variants,
                   seconds=time.perf_counter() - t0, **launches)
        emit(row)
        rows[tag] = row
    return rows


def long_graph_run(kernels) -> dict:
    """(q) stride1 (bf16, remat: mlp, dropout) with ``fused_epoch: true``
    over 256 spectra (16 steps), 2 epochs, against the per-step path in the
    same call: the final parameters within the bf16 training limit (relative
    L2 per tensor, as TRAIN_GRAD_TOL), the figures of (p), and K1, K4, K5
    launches counted from the replays."""
    none = {n: 0 for n in kernels}
    layers = STRIDE1_MODEL["num_hidden_layers"]
    tol = TRAIN_GRAD_TOL["d_stride1_bf16"]
    t0 = time.perf_counter()
    eager = window_fit(STRIDE1_TRAIN, 256, 2, False)
    eager_dev = window_device(eager)
    graph = window_fit(STRIDE1_TRAIN, 256, 2, True)
    launches = graph_launches(graph, dict(none, flash_fwd=layers, flash_bwd=layers), kernels)
    a, b = graph["params"], eager["params"]
    errs = {k: rel_l2(a[k], b[k], 1e-30) for k in a}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= tol, f"q: {worst} apart by relative L2 {errs[worst]} (tol {tol})")
    graph_dev = window_device(graph)
    graph_dev.update(replay_span(graph), **epoch_end(graph))
    eager_dev.update(epoch_end(eager))
    row = dict(phase="graph", run="q_stride1_graph_bf16", inputs=256, epochs=2,
               steps_per_epoch=graph["steps"], rel_l2_max=errs[worst], rel_l2_worst=worst,
               tol=tol, bit_equal=all(torch.equal(a[k], b[k]) for k in a),
               per_step=dict(**fit_summary(eager), **eager_dev, launches=eager["counts"]),
               graph=dict(**fit_summary(graph), **graph_dev),
               seconds=time.perf_counter() - t0, **launches)
    emit(row)
    return row



def option_runs(work: str, none: dict, kernels, only=None) -> dict:
    """Runs (j)-(o): RoPE, the covariance preprocessors with their freeze
    schedule, the optimizers and the nn.Dropout streams; ``only``: the
    letters to run (all by default; (m) needs (l)'s statistics)."""
    import copy

    want = set("jklmno") if only is None else set(only)
    t0 = time.perf_counter()

    def timed(letter):  # each run's wall-clock seconds, CPU references included
        nonlocal t0
        emit(dict(phase="run_seconds", run=letter, seconds=time.perf_counter() - t0))
        t0 = time.perf_counter()

    steps = -(-N_INPUTS // BATCH)
    fwd = STRIDE1_MODEL["num_hidden_layers"] * 2 * steps  # train steps + val batches
    bwd = STRIDE1_MODEL["num_hidden_layers"] * steps
    runs = {}
    if "j" in want:
        rope_long = copy.deepcopy(STRIDE1_TRAIN)
        rope_long["model"]["pos_encoding_type"] = "rope"
        # The first step's CPU reference is cut to make room for (D): (d)
        # holds stride1's first step against the CPU, (k) RoPE's.
        runs["j_stride1_rope_bf16"] = train_run(
            "j_stride1_rope_bf16", rope_long,
            dict(none, flash_fwd=fwd, flash_bwd=bwd), kernels,
            after=lambda exp: rope_serve_check(exp, work, none, kernels),
            grad_check=lambda tag, exp, cfg: dict(first_step_cpu_reference="cut for (D)'s time"))
        timed("j")
    if "k" in want:
        rope_short = copy.deepcopy(BASELINE_TRAIN)
        rope_short["model"]["pos_encoding_type"] = "rope"
        runs["k_baseline_rope_fp32"] = train_run(
            "k_baseline_rope_fp32", rope_short,
            dict(none, short_fwd=fwd, short_bwd=bwd, fused_mlp_fwd=fwd, fused_mlp_bwd=bwd),
            kernels)
        timed("k")
    if "l" in want or "m" in want:
        runs["l_stride1_zca_train"] = zca_train_run(work, none, kernels)
        timed("l")
    if "m" in want:
        runs.update(preprocessor_serve_runs(os.path.join(work, "cov.npz"), work, none, kernels))
        timed("m")
    if "n" in want:
        runs["n_optimizers"] = optimizer_runs(kernels)
        timed("n")
    if "o" in want:
        runs["o_baseline_stream_dropout_remat"] = stream_dropout_run(none, kernels)
        timed("o")
    return runs


def sweep_run(work: str, kernels) -> dict:
    """(r) ``python -m vit_tpu_torch lr --engine sequential`` as its runner
    drives it, on the card: baseline's training shape (``fused_epoch`` as
    ``auto`` decides: the graph) over 256 in-memory spectra, lr in {1e-4,
    1e-3, 1e-2} x {none, plateau(0.8, 0)}, 2 epochs. Six trials, every one
    ok; ``summary.yaml`` and ``best_config.yaml`` written and read back;
    best = the smallest metric; trial 3 bit-equal to a standalone
    Experiment with seed + 3 and its opt; each trial's seconds."""
    import copy

    import yaml

    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.opt.parallel_sweep import ParallelSweepRunner, _SequentialSweepEngine
    from vit_tpu_torch.train.loop import Experiment

    cfg = copy.deepcopy(BASELINE_TRAIN)
    cfg["train"].update(ep=2)
    del cfg["train"]["fused_epoch"]  # auto, as a user's base config leaves it
    base = os.path.join(work, "sweep_base.yaml")
    with open(base, "w") as f:
        yaml.safe_dump(cfg, f)
    data = make_dummy_spectra(n=256, length=cfg["model"]["image_size"], seed=1)

    def datamodule(c):
        return SpecDataModule(c, source=data)

    runner = ParallelSweepRunner(base, lr_values=[1e-4, 1e-3, 1e-2],
                                 schedulers=["none", "plateau"], plateau_factors=[0.8],
                                 plateau_patience=[0], results_dir=os.path.join(work, "sweep"),
                                 seed=0, engine="sequential", device="cuda",
                                 datamodule=datamodule, gpu_ids=[0])
    reset_launches()
    t0 = time.perf_counter()
    best = runner.run()
    sweep_s = time.perf_counter() - t0
    calls = {n: k.launches for n, k in kernels.items()}
    with open(runner.summary_path) as f:
        summary = yaml.safe_load(f)
    with open(runner.best_config_path) as f:
        best_cfg = yaml.safe_load(f)
    results = summary["results"]
    ok = [r["metric"] for r in results if r["status"] == "ok"]
    check(len(results) == 6 and len(ok) == 6, f"r: trials {results}")
    check(summary["best"]["metric"] == min(ok) == best.metric, f"r: best {summary['best']}")
    check(best_cfg["_meta"]["generator"] == "vit_tpu_torch.opt.parallel_sweep"
          and best_cfg["opt"]["lr"] == summary["best"]["config"]["lr"],
          f"r: best_config {best_cfg.get('_meta')} {best_cfg.get('opt')}")
    c = runner.sweep_configs[3]
    trial = _SequentialSweepEngine(runner.base_config, [c], runner.metric_name,
                                   runner.metric_goal, runner.seed).trial_config(c)
    alone = Experiment(trial, seed=runner.seed + c.idx, device="cuda",
                       datamodule=datamodule(trial))
    alone_metric = alone.fit()["val_mae"]
    check(alone.fused is not None, "r: the standalone trial did not take the fused epoch")
    check(alone_metric == results[3]["metric"], f"r: trial 3's metric {results[3]['metric']} "
          f"against its standalone Experiment's {alone_metric}")
    row = dict(phase="sweep", run="r_lr_sweep", inputs=256, epochs=2, trials=len(results),
               engine=summary["engine"], summary_keys=list(summary),
               best=summary["best"], metrics=[r["metric"] for r in results],
               trial_seconds=[r["duration_sec"] for r in results], sweep_seconds=sweep_s,
               trial_3_standalone_metric=alone_metric, trial_3_bit_equal=True,
               python_kernel_calls=calls,
               python_kernel_calls_note="wrapper calls: warm-up steps, captures and "
                                        "validation; replays are not counted here")
    emit(row)
    return row


# -- runs (s), (s'), (u): the vmapped sweep, the seed vector, the image family --
SWEEP_GRID = dict(lr_values=[1e-4, 1e-3, 1e-2], schedulers=["none", "plateau"],
                  plateau_factors=[0.8], plateau_patience=[0])
# vit_tpu's summary.yaml schema (ParallelSweepRunner._write_summary), in order.
SUMMARY_KEYS = ["generated_at", "base_config", "metric", "search_space", "gpus", "engine",
                "num_configs", "results", "best"]
SWEEP_REL = 1e-4  # a replica's validation metric against its sequential trial
IMAGE_INPUTS, IMAGE_VAL = 512, 128  # (u)'s synthetic training and validation images
B16_BATCH = 64  # vit_b16_bf16.yaml's batch of 1024 cut to 64 for (u)'s steps
# ViT-B/16's 12 layers cut to 4 in (u) and (v) for the script's time: the
# width (768, 12 heads, T 197, K3/K7 at D768) and remat are as configured,
# and the kernel rows at its shapes stand in the kernel phase.
B16_LAYERS = 4
L16_BATCH = 32  # ViT-L/16's kernel rows: 32 x 197 = 6304 MLP rows at D1024 F4096
IMAGE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "exp", "image")


def sweep_base(work: str, name: str, **model) -> tuple:
    """(r)'s base config with ``model`` overrides, written to ``work``:
    (path, config)."""
    import copy

    import yaml

    cfg = copy.deepcopy(BASELINE_TRAIN)
    cfg["train"].update(ep=2)
    del cfg["train"]["fused_epoch"]  # auto, as a user's base config leaves it
    cfg["model"].update(model)
    path = os.path.join(work, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


def replica_launches(ep, calls: dict, expect_step: dict, kernels) -> dict:
    """Launches of a ReplicaEpochs counted from its replays: the captured
    step's launches (which must be ``expect_step``) times the replays, plus
    the wrapper calls outside the graph (the eager step, validation)."""
    check(ep.graph is not None and ep.replays > 0, f"replica graph: {ep.replays} replays")
    # one launch a site for all the replicas
    expect_step = with_sites(expect_step, ep.module.cfg, 1)
    check_launches("a captured replica step", ep.captured_launches, expect_step)
    replayed = {n: expect_step[n] * ep.replays for n in kernels}
    outside = {n: calls[n] - expect_step[n] for n in kernels}  # less the capture itself
    for n, per_step in expect_step.items():
        check(per_step == 0 or replayed[n] > 0, f"{n}: no launch from the replays")
    return dict(launches={n: replayed[n] + outside[n] for n in kernels},
                launches_from_replays=replayed, launches_outside_graphs=outside,
                launch_count_method="capture count x replays, plus calls outside the graph",
                captured_launches_per_step=expect_step, replays=ep.replays,
                eager_steps=ep.eager_steps, capture_seconds=ep.capture_seconds)


def replica_timing(ep) -> dict:
    """One further epoch of the replica graph's replays over the last
    epoch's buffers: the device span a step (CUDA events) and the host's
    enqueue time, then torch.profiler's kernel time of another epoch; per
    step of all replicas and per replica-step."""
    ep.counter.zero_()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(ep.steps):
        ep.run_step()
    enqueue_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    span = start.elapsed_time(end) / ep.steps
    ep.counter.zero_()
    prof = device_profile(lambda: [ep.run_step() for _ in range(ep.steps)], top=8)
    dev = prof["device_ms"] / ep.steps
    return dict(replicas=ep.replicas, replay_span_ms_per_step=span,
                replay_enqueue_ms_per_step=enqueue_s * 1e3 / ep.steps,
                device_ms_per_step=dev, device_ms_per_replica_step=dev / ep.replicas,
                device_busy_share=dev / span, top_device_ops=prof["top"])


def vmap_sweep_run(work: str, kernels) -> dict:
    """(s) ``python -m vit_tpu_torch lr`` with its default engine, vmap, as
    its runner drives it: (r)'s shape and grid (baseline + flash + fused
    MLP, fp32, dropout on; 256 in-memory spectra, 2 epochs), the six trials
    as six stacked replicas through a CUDA graph of one replica step.
    Checks: six ok results, vit_tpu's summary schema, best = the smallest
    metric, best_config; the captured step launches K2 and K6 once a layer
    (the replicas folded into the heads) and K3 and K7 once a layer and
    replica. Reports the sweep's seconds (beside (r)'s, same call), the
    replica step's device ms and peak memory. Then, with dropout off, the
    engine against the sequential engine's trials (the same inits, seed +
    idx): each replica's validation metric within SWEEP_REL; and the grid
    plus one replica at lr 1e3, which must end 'error' (non-finite) and
    leave the six others' metrics as they were."""
    import yaml

    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.opt.parallel_sweep import (
        ParallelSweepRunner,
        SweepConfig,
        _SequentialSweepEngine,
        _VmapSweepEngine,
    )

    data = make_dummy_spectra(n=256, length=BASELINE_MODEL["image_size"], seed=1)

    def datamodule(c):
        return SpecDataModule(c, source=data)

    base, _ = sweep_base(work, "vmap_sweep_base.yaml")
    runner = ParallelSweepRunner(base, **SWEEP_GRID, results_dir=os.path.join(work, "vmap"),
                                 seed=0, device="cuda", datamodule=datamodule, gpu_ids=[0])
    check(runner.engine == "vmap", f"s: the runner's default engine is {runner.engine}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    best = runner.run()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    calls = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    with open(runner.summary_path) as f:
        summary = yaml.safe_load(f)
    with open(runner.best_config_path) as f:
        best_cfg = yaml.safe_load(f)
    results = summary["results"]
    ok = [r["metric"] for r in results if r["status"] == "ok"]
    check(list(summary) == SUMMARY_KEYS and summary["engine"] == "vmap",
          f"s: summary keys {list(summary)}, engine {summary.get('engine')}")
    check(len(results) == 6 and len(ok) == 6, f"s: trials {results}")
    check(summary["best"]["metric"] == min(ok) == best.metric, f"s: best {summary['best']}")
    check(best_cfg["_meta"]["generator"] == "vit_tpu_torch.opt.parallel_sweep"
          and best_cfg["opt"]["lr"] == summary["best"]["config"]["lr"],
          f"s: best_config {best_cfg.get('_meta')} {best_cfg.get('opt')}")
    ep = runner.engine_run.epochs
    layers, replicas = BASELINE_MODEL["num_hidden_layers"], len(results)
    expect_step = dict({n: 0 for n in kernels}, short_fwd=layers, short_bwd=layers,
                       fused_mlp_fwd=layers * replicas, fused_mlp_bwd=layers * replicas)
    launches = replica_launches(ep, calls, expect_step, kernels)
    check(ep.replays + ep.eager_steps == 2 * ep.steps,
          f"s: {ep.replays} replays + {ep.eager_steps} eager steps for 2 x {ep.steps}")
    timing = replica_timing(ep)

    # Dropout off: the replicas against the sequential engine's trials.
    _, off = sweep_base(work, "vmap_nodrop.yaml", hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    configs = runner.sweep_configs
    args = ("val_mae", "minimize", 0)
    t0 = time.perf_counter()
    seq = _SequentialSweepEngine(off, configs, *args, device="cuda",
                                 datamodule=datamodule).run()
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vm = _VmapSweepEngine(off, configs, *args, device="cuda", datamodule=datamodule).run()
    vm_s = time.perf_counter() - t0
    wild = _VmapSweepEngine(off, configs + [SweepConfig(len(configs), 1e3)], *args,
                            device="cuda", datamodule=datamodule).run()
    rel = []
    for a, b in zip(vm, seq):
        check(a.status == b.status == "ok", f"s: dropout-off trial {a.config} {a.status} "
              f"{a.message}; sequential {b.status} {b.message}")
        rel.append(abs(a.metric - b.metric) / abs(b.metric))
    check(max(rel) <= SWEEP_REL, f"s: replica metrics {[r.metric for r in vm]} against the "
          f"sequential trials' {[r.metric for r in seq]} (relative {rel}, tol {SWEEP_REL})")
    check(wild[-1].status == "error" and "non-finite" in (wild[-1].message or ""),
          f"s: the lr 1e3 replica ended {wild[-1].status}: {wild[-1].message}")
    moved = [abs(a.metric - b.metric) / abs(b.metric) for a, b in zip(wild, vm)]
    check(all(r.status == "ok" for r in wild[:-1]) and max(moved) <= 1e-6,
          f"s: the other replicas moved with the diverged one: {moved}")
    row = dict(phase="sweep", run="s_vmap_sweep", engine=summary["engine"], inputs=256,
               epochs=2, trials=len(results), summary_keys=list(summary),
               best=summary["best"], metrics=[r["metric"] for r in results],
               sweep_seconds=sweep_s, peak_mib=peak / 2**20, **launches, **timing,
               dropout_off=dict(vmap_metrics=[r.metric for r in vm],
                                sequential_metrics=[r.metric for r in seq],
                                max_rel_diff=max(rel), tol=SWEEP_REL, vmap_seconds=vm_s,
                                sequential_seconds=seq_s),
               diverged=dict(lr=1e3, status=wild[-1].status, message=wild[-1].message,
                             others_max_rel_move=max(moved),
                             others_bit_equal=all(a.metric == b.metric
                                                  for a, b in zip(wild, vm))))
    emit(row)
    return row


def stacked_case(name: str, short: bool, b, h, t, d, dtype, rate, g) -> dict:
    """One stacked launch over len(SEED_VECTOR) replicas of (b, h) heads with
    one seed each (bh_per_seed = b*h), forward and backward, against one
    launch per replica with its seed: bit for bit (each head's arithmetic
    is its own), and against the plain version with the seed vector within
    the kernel's tolerance."""
    from vit_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_plain, flash_fwd, flash_fwd_plain, short_bwd, short_bwd_plain,
        short_fwd, short_fwd_plain,
    )

    fwd, bwd = (short_fwd, short_bwd) if short else (flash_fwd, flash_bwd)
    fwd_plain, bwd_plain = ((short_fwd_plain, short_bwd_plain) if short
                            else (flash_fwd_plain, flash_bwd_plain))
    r, per = len(SEED_VECTOR), b * h
    seeds = torch.tensor(SEED_VECTOR, dtype=torch.int32, device="cuda")
    q, k, v, do = (torch.randn(r * per, t, d, generator=g, device="cuda", dtype=dtype)
                   for _ in range(4))
    scale = d**-0.5
    o, lse = fwd(q, k, v, scale, rate, seeds, per)
    delta = (do.float() * o.float()).sum(-1)
    grads = bwd(q, k, v, do, lse, delta, scale, rate, seeds, per)
    for i, seed in enumerate(SEED_VECTOR):
        sl = slice(i * per, (i + 1) * per)
        o1, lse1 = fwd(q[sl], k[sl], v[sl], scale, rate, seed)
        g1 = bwd(q[sl], k[sl], v[sl], do[sl], lse1, delta[sl], scale, rate, seed)
        check(torch.equal(o[sl], o1) and torch.equal(lse[sl], lse1),
              f"{name}: replica {i}'s stacked forward differs from its single launch")
        for what, a, c in zip(("dq", "dk", "dv"), grads, g1):
            check(torch.equal(a[sl], c), f"{name}: replica {i}'s stacked {what} differs from "
                  "its single launch")
    o_ref, _ = fwd_plain(q, k, v, scale, rate, seeds, per)
    g_ref = bwd_plain(q, k, v, do, lse, delta, scale, rate, seeds, per)
    errs = {"o": (o.float() - o_ref.float()).abs().max().item()}
    for what, a, c in zip(("dq", "dk", "dv"), grads, g_ref):
        errs[what] = (a.float() - c.float()).abs().max().item()
        check(errs[what] <= kernel_tol(c), f"{name}: stacked {what} vs the plain version "
              f"{errs[what]} (tol {kernel_tol(c)})")
    check(errs["o"] <= kernel_tol(o_ref), f"{name}: stacked o vs the plain version {errs['o']}")
    row = dict(phase="stacked_seeds", kernel=name, replicas=r, b=b, h=h, T=t, d=d,
               dtype=str(dtype), rate=rate, seeds=list(SEED_VECTOR), bit_equal_to_singles=True,
               max_abs_err_vs_plain=errs)
    emit(row)
    return row


def seed_vector_runs(work: str, kernels) -> dict:
    """(s') The seed vector at full width: K1, K4, K5 over three stacked
    replicas at stride1's shape (B16 H2 T4066 d64 bf16, dropout 0.1) and K2,
    K6 at (e)'s (B16 H2 T129 d16 fp32), each bit for bit its three single
    launches (stacked_case); the masks themselves are mask_check's. Then a
    few replica steps of stride1.yaml (3 layers, hidden 128, T 4066, bf16,
    remat: mlp, dropout 0.1) as a three-replica vmapped sweep over 128
    in-memory spectra (8 steps of 16, one epoch) through the replica graph:
    launches and its device ms."""
    import copy

    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.opt.parallel_sweep import SweepConfig, _VmapSweepEngine

    g = torch.Generator(device="cuda").manual_seed(5)
    out = {"stacked_flash": stacked_case("K1_K4_K5_stride1", False, 16, 2, 4066, 64,
                                         torch.bfloat16, 0.1, g),
           "stacked_short": stacked_case("K2_K6_baseline", True, 16, 2, 129, 16,
                                         torch.float32, 0.1, g)}
    cfg = copy.deepcopy(STRIDE1_TRAIN)
    del cfg["train"]["fused_epoch"]
    data = make_dummy_spectra(n=128, length=STRIDE1_MODEL["image_size"], seed=1)
    configs = [SweepConfig(i, lr) for i, lr in enumerate((1e-4, 1e-3, 1e-2))]
    engine = _VmapSweepEngine(cfg, configs, "val_mae", "minimize", 0, device="cuda",
                              datamodule=lambda c: SpecDataModule(c, source=data))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    calls = {n: k.launches for n, k in kernels.items()}
    check(all(r.status == "ok" for r in results), f"s': {[r.message for r in results]}")
    ep = engine.epochs
    layers = STRIDE1_MODEL["num_hidden_layers"]
    expect_step = dict({n: 0 for n in kernels}, flash_fwd=layers, flash_bwd=layers)
    row = dict(phase="replica_steps", run="s2_stride1_replicas",
               inputs=128, steps=ep.steps, metrics=[r.metric for r in results],
               sweep_seconds=sweep_s, peak_mib=torch.cuda.max_memory_allocated() / 2**20,
               **replica_launches(ep, calls, expect_step, kernels), **replica_timing(ep))
    emit(row)
    out["s2_stride1_replicas"] = row
    return out


def image_grad_check(tag, exp, cfg, cpu_ref=None, prepare=None,
                     both_backends: bool = False) -> dict:
    """(u)'s first step: the same weights in fp32 on the card (the kernels'
    fp32 bodies at the run's shapes) held per tensor at 1e-4 against the
    CPU; the config's bf16 step held per tensor at 2e-2, or at BF16_OWN
    times the CPU's own bf16 error on the tensor where that is larger
    (``first_step_check``'s ``bf16_limits``). At 12 layers the query and key
    weights' gradients, ~1e-3 of the global norm under the near-uniform
    attention of the std-0.02 init, come out of a cancellation in dS and
    differ from fp32 by more than 2e-2 in bf16 on the CPU alone (up to 0.03
    at ViT-S, 0.08 at ViT-B); every other tensor stays under 0.015.
    ``cpu_ref``: receives the CPU's fp32 step of the fp32 check; ``prepare``
    and ``both_backends`` go to the bf16 check (first_step_check), which
    then takes a CPU fp32 step of its own."""
    import copy
    import types

    from vit_tpu_torch.models.builder import get_model

    cfg32 = copy.deepcopy(cfg)
    cfg32["train"]["precision"] = "float32"
    b32 = get_model(copy.deepcopy(cfg32))
    b32.module.load_state_dict(exp.module.state_dict())
    exp32 = types.SimpleNamespace(module=b32.module.cuda(), datamodule=exp.datamodule,
                                  bundle=b32)
    cpu_ref = {} if cpu_ref is None else cpu_ref  # one CPU step serves both checks
    fp32 = first_step_check(f"{tag}/fp32", exp32, cfg32, FP32_TOL, cpu_ref=cpu_ref)
    del exp32, b32
    return dict(first_step_fp32=fp32, **first_step_check(
        tag, exp, cfg, TRAIN_GRAD_TOL[tag], cpu_ref=cpu_ref if prepare is None else None,
        bf16_limits=True, prepare=prepare, both_backends=both_backends))


def image_config(name: str, **model) -> dict:
    """``configs/exp/image/<name>`` as it stands but for the data: no paths
    (the synthetic images of ImageDataset's fallback), IMAGE_INPUTS training
    and IMAGE_VAL validation images; one epoch; ``model`` overrides."""
    from vit_tpu_torch.config import load_config

    cfg = load_config(os.path.join(IMAGE_DIR, name))
    cfg["data"] = {"num_samples": IMAGE_INPUTS, "num_test_samples": IMAGE_VAL}
    cfg["train"].update(ep=1, save=False)
    cfg["model"].update(model)
    return cfg


def image_step_run(tag: str, cfg: dict) -> dict:
    """One epoch of an image config on the card, without the first-step
    check and the serving of ``image_runs``' runs, then torch.profiler's
    device ms of one further step (the figure beside the fused MLP's)."""
    import copy

    import numpy as np

    from vit_tpu_torch.data.images import ImageDataModule
    from vit_tpu_torch.train.loop import Experiment

    exp = Experiment(copy.deepcopy(cfg), device="cuda", datamodule=ImageDataModule(cfg))
    metrics = exp.fit()
    check(np.isfinite(metrics["train_loss"]), f"{tag}: train loss {metrics['train_loss']}")
    prof = step_profile(exp)
    vc = exp.bundle.vit_config
    row = dict(phase="train", run=tag, T=vc.seq_len, layers=vc.num_hidden_layers,
               dtype=str(vc.dtype), batch=exp.batch_size, train_loss=metrics["train_loss"],
               device_ms_per_step=prof["device_ms"], top_device_ops=prof["top"])
    emit(row)
    return row


def image_runs(work: str, none: dict, kernels) -> dict:
    """(u) The image family at full width on synthetic class-conditional
    images: cifar_vit_s16.yaml as it stands (ViT-S: hidden 384, 12 layers,
    6 heads, patch 4, T 65, bf16, batch 128; xla attention, dense MLP, the
    fused epoch as ``auto`` decides), then with ``attn_impl: flash`` and
    ``fused_mlp: true`` (K2/K6 at T65 d64, K3/K7 at R8320 D384 F1536, per
    step: exact launches); cifar_vit_s16_pca.yaml behind patch-PCA
    statistics computed on the card (held against the CPU's); and
    vit_b16_bf16.yaml (hidden 768, B16_LAYERS of its 12 layers, T 197,
    remat) with flash and the fused MLP, its batch of 1024 cut to
    B16_BATCH. Each run: the first
    step's gradients against fp32 on the CPU (2e-2), one epoch, then the
    trained weights served on the card and held as (a)-(c) are. Last,
    vit_b16_bf16.yaml as it stands (xla attention, dense MLP) at the same
    cuts, one epoch and one profiled step (image_step_run), so that each
    model's xla + dense step stands beside its flash + fused one."""
    import copy

    import numpy as np

    from vit_tpu_torch.data.images import make_dummy_images
    from vit_tpu_torch.models.builder import get_vit_config
    from vit_tpu_torch.ops.fused_mlp import in_envelope
    from vit_tpu_torch.prepca.pipeline import compute_patch_pca_images

    rows = {}

    def run(tag, cfg, expect, serve_expect, serve_batch):
        trained = {}

        def keep(exp):
            trained["module"] = exp.module
            return {}

        rows[tag] = train_run(tag, cfg, expect, kernels, after=keep,
                              grad_check=image_grad_check)
        module = trained["module"].cpu()
        rows[f"{tag}_serve"] = serve_run(f"{tag}_serve", cfg, serve_expect, None,
                                         BF16_FEATURE_TOL, work, kernels, module=module,
                                         n=2 * serve_batch, batch=serve_batch)
        fp32 = copy.deepcopy(cfg)
        fp32["train"]["precision"] = "float32"
        if fp32["model"].get("fused_mlp"):  # fp32 moves the MLP's width against the envelope
            serve_expect = counts(fp32)[1]
        rows[f"{tag}_serve_fp32"] = serve_run(f"{tag}_serve_fp32", fp32, serve_expect,
                                              FP32_TOL, FP32_TOL, work, kernels, module=module,
                                              n=2 * serve_batch, batch=serve_batch)

    def counts(cfg, remat_layer=False):
        """Exact per-step launches of one epoch's fit, and of serving two
        batches, for a config with flash and the fused MLP: K3 and K7
        inside vit_tpu's envelope only (library_mlp outside launches none)."""
        vc = get_vit_config(copy.deepcopy(cfg))
        layers = vc.num_hidden_layers
        mlp = int(in_envelope(vc.hidden_size, vc.intermediate_size, vc.dtype))
        bs = cfg["train"]["batch_size"]
        steps, val = -(-IMAGE_INPUTS // bs), -(-IMAGE_VAL // min(bs, IMAGE_VAL))
        fwd = layers * ((2 if remat_layer else 1) * steps + val)
        return dict(none, short_fwd=fwd, short_bwd=layers * steps, fused_mlp_fwd=mlp * fwd,
                    fused_mlp_bwd=mlp * layers * steps), dict(none, short_fwd=layers * 2,
                                                              fused_mlp_fwd=mlp * layers * 2)

    s16 = image_config("cifar_vit_s16.yaml")
    run("u_cifar_s16_bf16", s16, none, none, 128)
    flash = image_config("cifar_vit_s16.yaml", attn_impl="flash", fused_mlp=True)
    flash["train"]["fused_epoch"] = False  # per step: exact launch counts
    expect, serve_expect = counts(flash)
    run("u_cifar_s16_flash_fused_bf16", flash, expect, serve_expect, 128)
    flash_dense = image_config("cifar_vit_s16.yaml", attn_impl="flash")
    flash_dense["train"]["fused_epoch"] = False  # as the flash + fused run steps
    rows["u_cifar_s16_flash_dense_bf16"] = image_step_run("u_cifar_s16_flash_dense_bf16",
                                                          flash_dense)

    images = make_dummy_images(n=IMAGE_INPUTS, image_size=32, num_classes=10, seed=0)["images"]
    t0 = time.perf_counter()
    card = compute_patch_pca_images(images, patch_size=4, device="cuda")
    pca_s = time.perf_counter() - t0
    cpu = compute_patch_pca_images(images, patch_size=4, device="cpu")
    evr_err = float(np.abs(card["explained_variance_ratio"] - cpu["explained_variance_ratio"])
                    .max())
    mean_err = float(np.abs(card["mean"] - cpu["mean"]).max())
    top = cpu["explained_variance_ratio"] > 1e-3
    signs = np.sign((card["components"] * cpu["components"]).sum(0))
    basis_err = float(np.abs(card["components"] * signs - cpu["components"])[:, top].max())
    check(evr_err <= 1e-5 and mean_err <= 1e-6 and basis_err <= 1e-3,
          f"u: patch PCA card vs CPU: evr {evr_err}, mean {mean_err}, basis {basis_err}")
    pca_path = os.path.join(work, "pca_patch_img_4.npz")
    np.savez(pca_path, **card)
    pca = image_config("cifar_vit_s16_pca.yaml")
    pca["warmup"]["cov_path"] = pca_path
    run("u_cifar_s16_pca_bf16", pca, none, none, 128)
    rows["u_cifar_s16_pca_bf16"].update(pca_stats_seconds=pca_s, pca_evr_err_vs_cpu=evr_err,
                                        pca_mean_err_vs_cpu=mean_err,
                                        pca_basis_err_vs_cpu=basis_err)

    b16 = image_config("vit_b16_bf16.yaml", attn_impl="flash", fused_mlp=True,
                       num_hidden_layers=B16_LAYERS)
    b16["train"].update(batch_size=B16_BATCH, fused_epoch=False)
    expect, serve_expect = counts(b16, remat_layer=True)
    run("u_vit_b16_flash_fused_bf16", b16, expect, serve_expect, B16_BATCH)
    dense = image_config("vit_b16_bf16.yaml", num_hidden_layers=B16_LAYERS)
    dense["train"].update(batch_size=B16_BATCH, fused_epoch=False)
    rows["u_vit_b16_bf16"] = image_step_run("u_vit_b16_bf16", dense)
    b16_flash_dense = image_config("vit_b16_bf16.yaml", attn_impl="flash",
                                   num_hidden_layers=B16_LAYERS)
    b16_flash_dense["train"].update(batch_size=B16_BATCH, fused_epoch=False)
    rows["u_vit_b16_flash_dense_bf16"] = image_step_run("u_vit_b16_flash_dense_bf16",
                                                        b16_flash_dense)
    ms = lambda tag: rows[tag]["device_ms_per_step"]  # noqa: E731
    emit(dict(phase="image_steps", device_ms_per_step={
        "vit_s16": dict(xla_dense=ms("u_cifar_s16_bf16"),
                        flash_dense=ms("u_cifar_s16_flash_dense_bf16"),
                        flash_fused=ms("u_cifar_s16_flash_fused_bf16")),
        f"vit_b16_{B16_LAYERS}_layers": dict(
            xla_dense=ms("u_vit_b16_bf16"), flash_dense=ms("u_vit_b16_flash_dense_bf16"),
            flash_fused=ms("u_vit_b16_flash_fused_bf16"))},
        fused_mlp_route={"vit_s16": "K3/K7 (inside vit_tpu's envelope)",
                         f"vit_b16_{B16_LAYERS}_layers":
                             "library_mlp (outside vit_tpu's envelope: no K3/K7 launch)"}))
    emit(dict(phase="image_cuts", reduced={
        "all": f"synthetic class-conditional images ({IMAGE_INPUTS} train, {IMAGE_VAL} val) "
               "in place of the npz files; 1 epoch",
        "u_vit_b16_*": f"train.batch_size 1024 -> {B16_BATCH}; "
                       f"num_hidden_layers 12 -> {B16_LAYERS}"}))
    return rows


# Run (v), int8 serving: the unquantized bf16 model and three int8 variants
# (tag, Predictor quantize, calibrated on the first batch).
QUANT_VARIANTS = (("bf16", None, False), ("int8_w8a8", "int8-w8a8", False),
                  ("int8_w8a8_calibrated", "int8-w8a8", True), ("int8_wo", "int8-wo", False))
B16_SERVE_BATCHES = (8, 128)  # ViT-B/16 serving: both sides of the W8A8 / weight-only route
B16_SERVE_IMAGES = 256


def quant_features(p, x: torch.Tensor) -> torch.Tensor:
    """The final LayerNorm's output for every token through ``p``'s served
    forward (its int8 table where it has one), fp32 on the host."""
    from vit_tpu_torch.models.layers import intercept_linear
    from vit_tpu_torch.ops.quant import quantized_interceptor

    with torch.inference_mode():
        if not p._qtable:
            return p.module.features(x).float().cpu()
        with intercept_linear(quantized_interceptor(p.module, p._qtable,
                                                    p.quant_variant == "int8-wo")):
            return p.module.features(x).float().cpu()


def resident_predictor(build):
    """(the Predictor ``build()`` returns, the device bytes it holds: weights
    after the strip, the int8 table, label buffers)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    p = build()
    torch.cuda.synchronize()
    return p, torch.cuda.memory_allocated() - base


def serve_timing(p, x) -> dict:
    """Inputs/s over SERVE_REPEATS passes of ``x`` (after a warm-up batch),
    host ms a batch, torch.profiler's device ms of one batch, busy share."""
    p.predict(x[:p.batch_size])
    torch.cuda.synchronize()
    runs = []
    for _ in range(SERVE_REPEATS):
        t0 = time.perf_counter()
        p.predict(x)  # ends in a copy to the host
        runs.append(time.perf_counter() - t0)
    batch_ms = sum(runs) * 1e3 / (SERVE_REPEATS * -(-len(x) // p.batch_size))
    prof = device_profile(lambda: p._batched_logits(x[:p.batch_size]))
    return dict(inputs_per_s=SERVE_REPEATS * len(x) / sum(runs), batch_ms=batch_ms,
                device_ms_per_batch=prof["device_ms"],
                device_busy_share=prof["device_ms"] / batch_ms, top_device_ops=prof["top"])


def quant_serve_runs(work: str, kernels) -> dict:
    """(v) int8 serving. stride1.yaml in bf16 at batch 16 (seeded weights,
    64 synthetic spectra) four ways: unquantized, int8-w8a8 dynamic, int8-w8a8
    calibrated on the first batch, int8-wo. Each: K1 launched exactly layers
    x batches, finite predictions, logits and per-token features of two
    served spectra and two probes against the same variant run by the port
    on the CPU in bf16 (1e-2 on logits, 0.125 on features), spectra/s,
    device ms a batch, busy share, the int8 table's bytes and the device
    bytes the predictor holds after the strip. Then ViT-B/16
    (vit_b16_bf16.yaml: attn auto -> xla at T 197, dense MLP) the same four
    ways at batch 8 and 128 on 256 synthetic images, each variant a
    Predictor over a copy of one seeded module: images/s and device ms a
    batch (the calibrated variant calibrated on the first 8 images),
    logits finite and each int8 variant's distance from bf16 reported."""
    import copy

    import numpy as np

    from vit_tpu_torch.data.images import ImageDataset
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.ops.quant import quantized_size_bytes
    from vit_tpu_torch.serve import Predictor
    from vit_tpu_torch.train.torch_bridge import save_torch_checkpoint

    none = {n: 0 for n in kernels}
    stride1 = {"model": STRIDE1_MODEL, "train": {"batch_size": BATCH, "precision": "bf16"},
               "data": {"param": "log_g"}, "noise": {"noise_level": 0}}
    module = get_model(copy.deepcopy(stride1), generator=torch.Generator().manual_seed(0)).module
    pt = os.path.join(work, "v_stride1.pt")
    save_torch_checkpoint(module, pt)
    x = make_dummy_spectra(n=N_INPUTS, length=STRIDE1_MODEL["image_size"], seed=1)["flux"]
    probes = torch.randn((2, x.shape[1]), generator=torch.Generator().manual_seed(2)).numpy()
    xs = torch.from_numpy(np.concatenate([x[:2], probes]))
    expect = dict(none, flash_fwd=STRIDE1_MODEL["num_hidden_layers"] * (N_INPUTS // BATCH))
    rows, logits = {}, {}
    for tag, mode, calibrate in QUANT_VARIANTS:
        calib = x[:BATCH] if calibrate else None
        p, held = resident_predictor(lambda: Predictor.from_checkpoint(
            stride1, ckpt=pt, batch_size=BATCH, quantize=mode, calibration=calib,
            device="cuda"))
        p.label_norm = "minmax"
        p.label_norm_stats = {k: np.asarray(v, np.float64) for k, v in LOGG_STATS.items()}
        p.predict(x[:BATCH])  # warm-up: cuBLAS handles, allocator
        reset_launches()
        out = p.predict(x)
        launches = {n: k.launches for n, k in kernels.items()}
        check_launches(f"v {tag}", launches, expect)
        check(out.shape == (N_INPUTS, 1) and bool(np.isfinite(out).all()),
              f"v {tag}: predictions not finite or of shape {out.shape}")
        timing = serve_timing(p, x)
        cpu = Predictor.from_checkpoint(stride1, ckpt=pt, batch_size=BATCH, quantize=mode,
                                        calibration=calib, device="cpu")
        with torch.inference_mode():
            want = cpu._forward(xs).float()
            got = p._forward(xs.cuda()).float().cpu()
        logit_err = (got - want).abs().max().item()
        feat_err = (quant_features(p, xs.cuda()) - quant_features(cpu, xs)).abs().max().item()
        check(logit_err <= 1e-2 and feat_err <= BF16_FEATURE_TOL,
              f"v {tag}: card against the CPU's {tag}: logits {logit_err} (tol 1e-2), "
              f"features {feat_err} (tol {BF16_FEATURE_TOL})")
        logits[tag] = got
        row = dict(phase="int8_serve", run=f"v_stride1_{tag}", quantize=mode,
                   variant=p.quant_variant, calibrated=calibrate, batch=BATCH,
                   inputs=N_INPUTS, launches=launches, smoke_spectra_per_s=timing.pop(
                       "inputs_per_s"), **timing,
                   quantized_layers=len(p._qtable or {}),
                   quantized_size_bytes=quantized_size_bytes(p._qtable or {}),
                   resident_device_bytes=held,
                   max_abs_logit_err_vs_cpu_same_variant=logit_err, logit_tol=1e-2,
                   max_abs_feature_err_vs_cpu_same_variant=feat_err,
                   feature_tol=BF16_FEATURE_TOL,
                   max_abs_logit_diff_vs_bf16=(got - logits["bf16"]).abs().max().item())
        emit(row)
        rows[row["run"]] = row
        del p, cpu

    b16 = image_config("vit_b16_bf16.yaml", num_hidden_layers=B16_LAYERS)
    bundle = get_model(copy.deepcopy(b16), generator=torch.Generator().manual_seed(0))
    images = ImageDataset(num_test_samples=B16_SERVE_IMAGES, image_size=b16["model"]["image_size"],
                          num_classes=b16["model"]["num_labels"])
    images.load_data("test")
    imgs = images.images
    b16_logits, b16_rows = {}, {}
    for tag, mode, calibrate in QUANT_VARIANTS:
        calib = imgs[:B16_SERVE_BATCHES[0]] if calibrate else None
        p, held = resident_predictor(lambda: Predictor(
            copy.deepcopy(bundle.module).cuda(), bundle.vit_config,
            batch_size=B16_SERVE_BATCHES[0], quantize=mode, calibration=calib))
        per_batch = {}
        for batch in B16_SERVE_BATCHES:
            p.batch_size = batch  # the variant is pinned: the route does not depend on it
            per_batch[batch] = serve_timing(p, imgs)
        lg = p._batched_logits(imgs[:B16_SERVE_BATCHES[0]])
        check(bool(np.isfinite(lg).all()), f"v ViT-B/16 {tag}: logits not finite")
        b16_logits[tag] = lg
        b16_rows[tag] = dict(quantize=mode, variant=p.quant_variant, calibrated=calibrate,
                             quantized_layers=len(p._qtable or {}),
                             quantized_size_bytes=quantized_size_bytes(p._qtable or {}),
                             resident_device_bytes=held,
                             max_abs_logit_diff_vs_bf16=float(abs(lg - b16_logits["bf16"]).max()),
                             **{f"batch_{b}": {k: v for k, v in t.items()
                                               if k != "top_device_ops"}
                                for b, t in per_batch.items()},
                             top_device_ops_largest_batch=per_batch[B16_SERVE_BATCHES[-1]][
                                 "top_device_ops"])
        del p
    speedups = {tag: {f"batch_{b}": b16_rows["bf16"][f"batch_{b}"]["device_ms_per_batch"]
                      / r[f"batch_{b}"]["device_ms_per_batch"] for b in B16_SERVE_BATCHES}
                for tag, r in b16_rows.items()}
    row = dict(phase="int8_serve", run="v_vit_b16_int8", images=B16_SERVE_IMAGES,
               reduced={"num_hidden_layers": f"12 -> {B16_LAYERS}"},
               batches=list(B16_SERVE_BATCHES), launches=dict(none), variants=b16_rows,
               device_speedup_vs_bf16=speedups,
               route_threshold=64, note="vit_tpu's W8A8_WO_BATCH_THRESHOLD kept as it is")
    emit(row)
    rows[row["run"]] = row
    return rows


EXPORT_LOADER = r"""
import json, sys, time
import numpy as np
import torch
from vit_tpu_torch.export import load_exported
from vit_tpu_torch.ops._build import KERNELS, reset_launches
out = {}
for path, inputs, npy in zip(sys.argv[1::3], sys.argv[2::3], sys.argv[3::3]):
    x = np.load(inputs)
    t0 = time.perf_counter()
    p = load_exported(path, device="cuda")
    load_s = time.perf_counter() - t0
    p._batched(x[:p.batch_size])  # warm-up: loads the kernels' libraries
    torch.cuda.synchronize()
    reset_launches()
    y = p._batched(x)  # what the program returns: denormalised values, or logits
    torch.cuda.synchronize()
    np.save(npy, y)
    out[path] = dict(load_seconds=load_s, launches={n: k.launches for n, k in KERNELS.items()})
bad = sorted(m for m in sys.modules if m.startswith(("vit_tpu_torch.models",
      "vit_tpu_torch.config", "vit_tpu_torch.train", "vit_tpu_torch.serve", "jax", "flax",
      "optax", "orbax")) or m == "vit_tpu" or m.startswith("vit_tpu."))
print("EXPORT_RESULT " + json.dumps(dict(results=out, model_modules=bad)))
"""


def load_in_fresh_process(tag: str, args: list) -> tuple:
    """EXPORT_LOADER in a new process over (artifact, inputs .npy, output
    .npy) triplets ``args``: (its result, the process's seconds). Fails
    unless it ran and imported no model code."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_LOADER, *args],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=900)
    load_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"{tag}: the loading process failed:\n{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("EXPORT_RESULT ")]
    check(len(line) == 1, f"{tag}: no result from the loading process:\n{proc.stdout[-2000:]}")
    result = json.loads(line[0][len("EXPORT_RESULT "):])
    check(result["model_modules"] == [],
          f"{tag}: the loading process imported model code: {result['model_modules']}")
    return result, load_s


def export_runs(work: str, kernels) -> dict:
    """(x) export: (a) stride1 bf16, (b) stride1 + fused_mlp, (c) baseline +
    flash fp32, and stride1 int8-w8a8, each served live on the card at batch
    16 and exported (seconds, bytes); then one fresh process that imports
    vit_tpu_torch.export alone (no model code: checked in its sys.modules)
    loads each artifact on the card and serves the 64 spectra: predictions
    against the live Predictor's (expected 0 apart before the
    denormalisation, which the artifact does in fp32: 1e-6 in fp32, 1e-2 in
    bf16), and K1, K2, K3 counted inside the loaded programs, exactly layers
    x batches."""
    import copy

    import numpy as np

    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.serve import Predictor
    from vit_tpu_torch.train.torch_bridge import save_torch_checkpoint

    none = {n: 0 for n in kernels}
    stride1 = {"model": STRIDE1_MODEL, "train": {"batch_size": BATCH, "precision": "bf16"},
               "data": {"param": "log_g"}, "noise": {"noise_level": 0}}
    baseline = {"model": dict(BASELINE_MODEL, attn_impl="flash"), "train": {"batch_size": BATCH},
                "data": {"param": "log_g"}, "noise": {"noise_level": 0}}
    calls = STRIDE1_MODEL["num_hidden_layers"] * (N_INPUTS // BATCH)
    cases = (("x_a_stride1_bf16", stride1, None, 1e-2, dict(none, flash_fwd=calls)),
             ("x_b_stride1_fused_mlp_bf16", dict(stride1, model=dict(STRIDE1_MODEL,
                                                                      fused_mlp=True)),
              None, 1e-2, dict(none, flash_fwd=calls, fused_mlp_fwd=calls)),
             ("x_c_baseline_flash_fp32", baseline, None, 1e-6, dict(none, short_fwd=calls)),
             ("x_stride1_int8_w8a8", stride1, "int8-w8a8", 1e-2, dict(none, flash_fwd=calls)))
    x = make_dummy_spectra(n=N_INPUTS, length=STRIDE1_MODEL["image_size"], seed=1)["flux"]
    x_path = os.path.join(work, "x_spectra.npy")
    np.save(x_path, x)
    live, meta, args = {}, {}, []
    for tag, cfg, mode, tol, expect in cases:
        module = get_model(copy.deepcopy(cfg), generator=torch.Generator().manual_seed(0)).module
        pt = os.path.join(work, f"{tag}.pt")
        save_torch_checkpoint(module, pt)
        p = Predictor.from_checkpoint(cfg, ckpt=pt, batch_size=BATCH, quantize=mode,
                                      device="cuda")
        p.label_norm = "minmax"
        p.label_norm_stats = {k: np.asarray(v, np.float64) for k, v in LOGG_STATS.items()}
        live[tag] = p.predict(x)
        path = os.path.join(work, f"{tag}.vittxpt")
        t0 = time.perf_counter()
        header = p.export(path)
        meta[tag] = dict(export_seconds=time.perf_counter() - t0,
                         artifact_bytes=os.path.getsize(path), header=header)
        args += [path, x_path, os.path.join(work, f"{tag}_loaded.npy")]
        del p
    result, load_s = load_in_fresh_process("x", args)
    rows = {}
    for (tag, cfg, mode, tol, expect), path in zip(cases, args[::3]):
        got = np.load(os.path.join(work, f"{tag}_loaded.npy"))
        diff = float(abs(got - live[tag]).max())
        launches = result["results"][path]["launches"]
        check_launches(f"{tag}: the loaded program", launches, expect)
        check(got.shape == live[tag].shape and diff <= tol,
              f"{tag}: loaded against live predictions {diff} apart (tol {tol})")
        row = dict(phase="export", run=tag, quantize=mode, batch=BATCH, inputs=N_INPUTS,
                   launches=launches, max_abs_diff_loaded_vs_live=diff, tol=tol,
                   load_seconds=result["results"][path]["load_seconds"],
                   loading_process_seconds=load_s, loading_process_model_modules=[],
                   **meta[tag])
        emit(row)
        rows[tag] = row
    return rows


def repair_runs(work: str, kernels) -> dict:
    """(y) the two repaired faults on the card. (y1) opt.type lbfgs through
    the vmapped sweep at (s)'s shape and grid, dropout off, against the
    sequential engine's trials: with one full-batch step (batch 256, 1
    epoch) each replica within SWEEP_REL; at (s)'s batch 16 over 2 epochs
    the engines' gaps reported (L-BFGS without a line search amplifies the
    two engines' fp32 summation orders after its first step: the CPU shows
    0.5-2.5% after two). (y2) fast_dropout: false, dropout 0.1, at (p)'s
    shape over 256 spectra, 2 epochs: per step, then fused_epoch: true,
    which now runs the step as a CUDA graph; parameters bit-equal, host
    ms/step of both. (y3) three replicas with fast_dropout: false through
    the vmapped sweep's graph: each replica's nn.Dropout masks, drawn under
    vmap inside a CUDA graph from the engine's own site seeds, bit-equal to
    single calls with those seeds, and each replica's forward within 1e-5
    of its model alone."""
    import copy

    import numpy as np

    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.ops.dropout import stream_dropout
    from vit_tpu_torch.opt.parallel_sweep import (
        ParallelSweepRunner,
        _SequentialSweepEngine,
        _VmapSweepEngine,
    )

    none = {n: 0 for n in kernels}
    data = make_dummy_spectra(n=256, length=BASELINE_MODEL["image_size"], seed=1)

    def datamodule(c):
        return SpecDataModule(c, source=data)

    base, _ = sweep_base(work, "lbfgs_base.yaml")
    configs = ParallelSweepRunner(base, **SWEEP_GRID, results_dir=os.path.join(work, "lb"),
                                  seed=0, device="cuda", datamodule=datamodule,
                                  gpu_ids=[0]).sweep_configs
    args = ("val_mae", "minimize", 0)
    lbfgs = {}
    for tag, train in (("full_batch_one_step", dict(batch_size=256, ep=1)),
                       ("s_shape_2_epochs", {})):
        _, cfg = sweep_base(work, f"lbfgs_{tag}.yaml", hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
        cfg["opt"]["type"] = "lbfgs"
        cfg["train"].update(train)
        t0 = time.perf_counter()
        seq = _SequentialSweepEngine(cfg, configs, *args, device="cuda",
                                     datamodule=datamodule).run()
        seq_s = time.perf_counter() - t0
        engine = _VmapSweepEngine(cfg, configs, *args, device="cuda", datamodule=datamodule)
        t0 = time.perf_counter()
        vm = engine.run()
        vm_s = time.perf_counter() - t0
        check(engine.epochs.graph is not None and engine.epochs.replays > 0
              or engine.epochs.steps == 1,
              f"y1 {tag}: the replica step did not run as a graph")
        rel = [abs(a.metric - b.metric) / abs(b.metric)
               if a.metric is not None and b.metric is not None and math.isfinite(a.metric)
               and math.isfinite(b.metric) else None for a, b in zip(vm, seq)]
        if tag == "full_batch_one_step":
            check(all(a.status == b.status == "ok" for a, b in zip(vm, seq))
                  and max(rel) <= SWEEP_REL,
                  f"y1: lbfgs replicas {[(a.status, a.metric) for a in vm]} against the "
                  f"sequential trials {[(b.status, b.metric) for b in seq]} (relative {rel})")
        lbfgs[tag] = dict(vmap=[(a.status, a.metric) for a in vm],
                          sequential=[(b.status, b.metric) for b in seq], rel_diff=rel,
                          held=tag == "full_batch_one_step", tol=SWEEP_REL,
                          vmap_seconds=vm_s, sequential_seconds=seq_s)
    row = dict(phase="repair", run="y1_lbfgs_vmap_sweep", launches=dict(none), **lbfgs)
    emit(row)
    rows = {row["run"]: row}

    cfg = copy.deepcopy(BASELINE_TRAIN)
    cfg["model"]["fast_dropout"] = False  # dropout 0.1 / 0.1, the builder's defaults
    layers = BASELINE_MODEL["num_hidden_layers"]
    per_step = dict(none, short_fwd=layers, short_bwd=layers, fused_mlp_fwd=layers,
                    fused_mlp_bwd=layers)
    eager = window_fit(cfg, 256, 2, False)
    graph = window_fit(cfg, 256, 2, True)
    launches = graph_launches(graph, per_step, kernels)
    close, equal, diff = params_close(graph["params"], eager["params"])
    check(equal, f"y2: fast_dropout false through the graph against per step: parameters "
          f"{diff} apart (bit-equal required)")
    row = dict(phase="repair", run="y2_stream_dropout_graph", inputs=256, epochs=2,
               steps_per_epoch=graph["steps"], bit_equal=equal, max_abs_diff=diff,
               per_step=dict(**fit_summary(eager), launches=eager["counts"]),
               graph=fit_summary(graph),
               host_ms_per_step_speedup=eager["steady_host_ms_per_step"]
               / graph["steady_host_ms_per_step"], **launches)
    emit(row)
    rows[row["run"]] = row

    _, cfg3 = sweep_base(work, "stream_replicas.yaml", fast_dropout=False)
    engine = _VmapSweepEngine(cfg3, configs[:3], *args, device="cuda", datamodule=datamodule)
    reset_launches()
    res = engine.run()
    calls = {n: k.launches for n, k in kernels.items()}
    ep = engine.epochs
    check(all(r.status == "ok" for r in res) and ep.graph is not None and ep.replays > 0,
          f"y3: {[(r.status, r.message) for r in res]}, graph {ep.graph}, {ep.replays} replays")
    launches = replica_launches(ep, calls, dict(none, short_fwd=layers, short_bwd=layers,
                                                fused_mlp_fwd=layers * len(res),
                                                fused_mlp_bwd=layers * len(res)), kernels)
    seeds = ep.seeds[:, 0].contiguous()  # (R, sites): the last epoch's first step
    shape = (BATCH, 129, BASELINE_MODEL["hidden_size"])
    ones = torch.ones(shape, device="cuda")
    site = torch.zeros(len(configs[:3]), dtype=torch.int32, device="cuda")
    out = torch.empty((len(configs[:3]),) + shape, device="cuda")

    def masks():
        out.copy_(torch.func.vmap(lambda s_: stream_dropout(ones, 0.1, s_))(site))

    masks()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        masks()
    wrong = 0
    for j in range(seeds.shape[1]):
        site.copy_(seeds[:, j])
        g.replay()
        for r in range(len(configs[:3])):
            wrong += int((out[r] != stream_dropout(ones, 0.1, seeds[r, j])).sum())
    check(wrong == 0, f"y3: {wrong} mask elements of the replicas differ from single calls")
    module = ep.module.train()
    xb = torch.from_numpy(data["flux"][:BATCH]).cuda()
    with torch.no_grad():
        stacked = torch.func.vmap(lambda p_, s_: torch.func.functional_call(
            module, p_, (xb,), {"dropout_seeds": s_}))(ep.params, seeds)
        alone = [torch.func.functional_call(module, {k: v[r] for k, v in ep.params.items()},
                                            (xb,), {"dropout_seeds": seeds[r]})
                 for r in range(len(configs[:3]))]
    fwd_err = max((stacked[r] - alone[r]).abs().max().item() / alone[r].abs().max().item()
                  for r in range(len(alone)))
    check(fwd_err <= 1e-5, f"y3: a replica's forward {fwd_err} from its model alone")
    row = dict(phase="repair", run="y3_stream_dropout_replicas", replicas=len(res),
               statuses=[r.status for r in res], metrics=[r.metric for r in res],
               mask_sites_checked=int(seeds.shape[1]), wrong_mask_elements=wrong,
               forward_rel_err_vs_alone=fwd_err, **launches)
    emit(row)
    rows[row["run"]] = row
    return rows


# Run (z), the Mixture-of-Experts ViT: cifar_vit_s16_moe.yaml at full width
# with one card's overrides (expert parallelism waits for a mesh; the
# short kernels K2/K6 for attention; no diagnostics), 6 of its 12 layers
# for the script's time (the dense model beside it likewise).
MOE_CONFIG = "cifar_vit_s16_moe.yaml"
MOE_OVERRIDES = dict(attn_impl="flash", num_hidden_layers=6)
MOE_EPOCHS = 2  # (z1): epoch 1 is the steady one
MOE_SERVE_IMAGES = 256  # (z2): two batches of 128
MOE_SWEEP_LRS = [1e-4, 1e-3, 1e-2]  # (z3): three replicas
ATTENTION_KERNELS = ("short_kernel", "dq_kernel", "dkv_kernel")  # K2's and K6's functions


def moe_config(**model) -> dict:
    """cifar_vit_s16_moe.yaml as image_config cuts it (synthetic images, one
    epoch) with MOE_OVERRIDES, ``train.model_parallel: 1`` and ``model``."""
    cfg = image_config(MOE_CONFIG, **dict(MOE_OVERRIDES, **model))
    cfg["train"]["model_parallel"] = 1
    cfg["viz"] = {"enable": False}
    return cfg


def moe_routing(module, x: torch.Tensor, seeds=None, forward=None) -> list:
    """Each MoE layer's (gate_idx, keep) on the host, in one forward of
    ``x`` (no gradient), read by a hook on the layer's router input: in
    training mode with ``seeds``, else in eval mode; ``forward(x)`` in place
    of the module's own call (a quantized predictor's)."""
    seen = []

    def hook(mod, args, out):
        _, _, _, idx = mod.route(*args)
        seen.append((idx.cpu(), mod.slots(idx, args[0].shape[1])[1].cpu()))

    was_training = module.training
    hooks = [layer.moe.register_forward_hook(hook) for layer in module.vit.encoder.layer]
    try:
        with torch.no_grad():
            module.train(seeds is not None)
            if forward is not None:
                forward(x)
            else:
                module(x, dropout_seeds=seeds)
    finally:
        for h in hooks:
            h.remove()
        module.train(was_training)
    return seen


def routing_diff(a: list, b: list) -> dict:
    """Assignments (token, choice) whose expert differs, and (choice,
    expert) slots whose keep differs, summed over the layers."""
    return dict(gate_idx_differ=int(sum((x[0] != y[0]).sum() for x, y in zip(a, b))),
                keep_differ=int(sum((x[1] != y[1]).sum() for x, y in zip(a, b))),
                assignments=int(sum(x[0].numel() for x in a)))


def force_routing(routing: list):
    """A ``prepare`` for cpu_step: each MoE layer of the CPU model takes the
    experts ``routing`` (one (gate_idx, keep) a layer, the card's) chose;
    its router still computes the probabilities, and the gates are those
    of the chosen experts (renormalised for top-k > 1), so every gradient
    but the discrete choice is the CPU's own. A probe batch routes as the
    recorded batch did: it only has to give other gradients."""
    def route_as(moe, idx):
        real = moe.route

        def route(x, seed=None):
            logits, probs, _, _ = real(x, seed)
            vals = probs.gather(-1, idx)
            if moe.top_k > 1:
                vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
            return logits, probs, vals, idx

        return route

    def prepare(model):
        for layer, (idx, _) in zip(model.vit.encoder.layer, routing):
            layer.moe.route = route_as(layer.moe, idx)

    return prepare


def moe_first_step(tag, exp, cfg) -> dict:
    """(z1)'s first step on a batch of 4 with first_step_check's seeds. The
    routing of that batch on the card, against the CPU's in bf16 and fp32
    from the same weights: the assignments that differ. The same weights
    in fp32 on the card against the CPU (image_grad_check's 1e-4). Then the
    config's bf16 step at (u)'s per-tensor limits against fp32 on the CPU
    with the card's routing imposed on every CPU step (force_routing): a
    routing decision is discrete, and one class token's choice that bf16
    flips in the last layer moves that layer's expert gradients by tens of
    percent (the loss reads the class tokens only). Without the imposed
    routing the distance is reported, not held. The CPU's own bf16 error
    is taken over both of its bf16 matmul backends (first_step_check's
    ``both_backends``): a router's gradient is a difference of two experts'
    contributions, and two CPU bf16 steps that sum the same products in
    other orders can put it several times as far from fp32 as each other
    (the row's ``cpu_backend_own_ratio``), so one CPU step alone is no
    measure of bf16's own error there."""
    import copy

    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.train.loop import loss_and_grads

    x = torch.from_numpy(exp.datamodule.train.arrays()["x"][:4])
    seeds = list(range(1000, 1000 + exp.module.num_dropout_sites))  # first_step_check's
    card = moe_routing(exp.module, x.cuda(), seeds)
    state = {k: v.cpu() for k, v in exp.module.state_dict().items()}
    row = {}
    for precision in ("bf16", "float32"):
        c = copy.deepcopy(cfg)
        c["train"]["precision"] = precision
        cpu = get_model(c).module
        cpu.load_state_dict(state)
        row[f"routing_vs_cpu_{precision}"] = routing_diff(card, moe_routing(cpu, x, seeds))

    cpu_ref = {}
    row.update(image_grad_check(tag, exp, cfg, cpu_ref=cpu_ref, prepare=force_routing(card),
                                both_backends=True))
    batch = {"x": x.cuda(), "label": torch.from_numpy(
        exp.datamodule.train.arrays()["label"][:4]).cuda()}
    exp.module.train()
    loss_and_grads(exp.module, batch, exp.bundle.vit_config.task_type, exp.bundle.loss_name,
                   [seeds])
    (_, ref), _ = cpu_ref["ref"]
    total = torch.sqrt(sum(r.square().sum() for r in ref)).item()
    names = [n for n, _ in exp.module.named_parameters()]
    errs = {n: rel_l2(p.grad.float().cpu(), r, GRAD_FLOOR * total)
            for n, p, r in zip(names, exp.module.parameters(), ref)}
    for p in exp.module.parameters():
        p.grad = None
    worst = max(errs, key=errs.get)
    row["unforced_routing"] = dict(grad_rel_l2_max=errs[worst], grad_rel_l2_worst=worst,
                                   grad_rel_l2_median=statistics.median(errs.values()),
                                   tensors_over_2e2=sum(e > 2e-2 for e in errs.values()),
                                   tensors=len(errs))
    return row


def moe_step_shares(exp, ffn: int, slots: int) -> dict:
    """torch.profiler over one training step (inputs shapes recorded): the
    shares of its device time in K2 and K6 (by kernel name), in the
    experts' products (the bmm whose operands hold the MLP width ``ffn``)
    and in the dispatch and combine products (the bmm over ``slots`` =
    E x C), forward and backward; the rest (projections, routing, one-hots,
    norms, optimizer) is the remainder."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vit_tpu_torch.train.optim import OptSpec, schedule_scale

    steps = -(-len(exp.datamodule.train) // exp.batch_size)
    spec = OptSpec.from_config(exp.config, steps, monitor_metric=exp.monitor)
    arrays = exp.datamodule.train.arrays()
    batch = {k: torch.from_numpy(arrays[k][:exp.batch_size]).cuda() for k in ("x", "label")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        exp.train_step(batch, spec, schedule_scale(spec))
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and "#" not in e.key]
    total = sum(e.self_device_time_total for e in kernels)
    attention = sum(e.self_device_time_total for e in kernels
                    if any(n in e.key for n in ATTENTION_KERNELS))
    experts = dispatch = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key != "aten::bmm" or e.device_type == DeviceType.CUDA:
            continue
        dims = {d for shape in e.input_shapes for d in shape}
        if ffn in dims:
            experts += e.self_device_time_total
        elif slots in dims:
            dispatch += e.self_device_time_total
    check(total > 0 and attention > 0, f"z: the step's profile: total {total}, K2+K6 {attention}")
    return dict(step_device_ms=total / 1e3, share_k2_k6=attention / total,
                share_expert_products=experts / total,
                share_dispatch_combine=dispatch / total,
                share_rest=1.0 - (attention + experts + dispatch) / total,
                attribution="K2/K6 by kernel name; bmm by its operands' shapes")


def moe_train_runs(kernels) -> tuple:
    """(z1) ViT-S/16-MoE on one card: per step (2 epochs, after the
    first-step check of moe_first_step), then ``fused_epoch: true`` from the
    same seed (parameters bit-equal to the per-step run's); K2/K6 launches
    exact in each fit (the per-epoch moe_dropped_frac forward included; the
    row's ``launches`` are both fits'); host and device ms a step, busy
    share, and the step's profile split; beside it, a row of its own, the
    dense cifar_vit_s16.yaml with the same overrides, per step."""
    import copy

    from vit_tpu_torch.data.images import ImageDataModule
    from vit_tpu_torch.models.builder import get_vit_config
    from vit_tpu_torch.models.moe import moe_capacity
    from vit_tpu_torch.train.loop import Experiment

    none = {n: 0 for n in kernels}
    cfg = moe_config()
    vc = get_vit_config(copy.deepcopy(cfg))
    layers, bs = vc.num_hidden_layers, cfg["train"]["batch_size"]
    steps, val = -(-IMAGE_INPUTS // bs), -(-IMAGE_VAL // min(bs, IMAGE_VAL))
    # Each epoch: the steps, the validation batches, one batch of moe_dropped_frac.
    expect = with_sites(dict(none, short_fwd=layers * (steps + val + 1) * MOE_EPOCHS,
                             short_bwd=layers * steps * MOE_EPOCHS), vc, steps * MOE_EPOCHS)
    dense_expect = dict(expect, short_fwd=layers * (steps + val) * MOE_EPOCHS)
    tag = "z_cifar_s16_moe_bf16"
    probe = Experiment(copy.deepcopy(cfg), device="cuda", seed=0,
                       datamodule=ImageDataModule(cfg))
    probe.datamodule.setup("fit")
    t0 = time.perf_counter()
    first = dict(moe_first_step(tag, probe, cfg), first_step_seconds=time.perf_counter() - t0)
    del probe

    eager = window_fit(cfg, IMAGE_INPUTS, MOE_EPOCHS, False)
    check_launches("z1 per step", eager["counts"], expect)
    eager_dev = window_device(eager)
    shares = moe_step_shares(eager["exp"], vc.intermediate_size,
                             vc.moe_experts * moe_capacity(vc.seq_len, vc.moe_experts,
                                                           vc.moe_top_k,
                                                           vc.moe_capacity_factor))
    graph = window_fit(cfg, IMAGE_INPUTS, MOE_EPOCHS, True)
    launches = graph_launches(graph, dict(none, short_fwd=layers, short_bwd=layers), kernels)
    check_launches("z1 graph", launches["launches"], expect)
    _, equal, diff = params_close(graph["params"], eager["params"])
    check(equal, f"z1: the graph's parameters differ from the per-step run's by {diff}")
    graph_dev = window_device(graph)
    dropped = [m["moe_dropped_frac"] for m in eager["logged"]]
    check(all(0.0 <= d <= 1.0 for d in dropped)
          and [m["moe_dropped_frac"] for m in graph["logged"]] == dropped,
          f"z1: moe_dropped_frac per step {dropped}, graph "
          f"{[m['moe_dropped_frac'] for m in graph['logged']]}")

    dense = window_fit(image_config("cifar_vit_s16.yaml", **MOE_OVERRIDES), IMAGE_INPUTS,
                       MOE_EPOCHS, False)
    check_launches("z1 dense", dense["counts"],
                   with_sites(dense_expect, dense["exp"].bundle.vit_config, steps * MOE_EPOCHS))
    dense_dev = window_device(dense)
    dense_row = dict(phase="moe_train", run="z_cifar_s16_dense_bf16",
                     config="cifar_vit_s16.yaml", launches=dense["counts"],
                     **fit_summary(dense), **dense_dev)
    emit(dense_row)
    row = dict(phase="moe_train", run=tag, T=vc.seq_len, layers=layers, experts=vc.moe_experts,
               top_k=vc.moe_top_k, capacity=moe_capacity(vc.seq_len, vc.moe_experts,
                                                         vc.moe_top_k, vc.moe_capacity_factor),
               dtype=str(vc.dtype), batch=bs, inputs=IMAGE_INPUTS, epochs=MOE_EPOCHS,
               steps_per_epoch=steps,
               launches={n: eager["counts"][n] + launches["launches"][n] for n in kernels},
               launches_per_fit=expect,
               moe_dropped_frac=dropped, train_loss=[m["train_loss"] for m in eager["logged"]],
               val_acc=[m.get("val_acc") for m in eager["logged"]],
               graph_vs_per_step_bit_equal=equal, graph_vs_per_step_max_abs_diff=diff,
               per_step=dict(**fit_summary(eager), **eager_dev),
               graph=dict(**fit_summary(graph), **graph_dev,
                          **{k: v for k, v in launches.items() if k != "launches"}),
               step_profile=shares, moe_over_dense_device_ms=eager_dev["device_ms_per_step"]
               / dense_dev["device_ms_per_step"],
               moe_over_dense_host_ms=eager["steady_host_ms_per_step"]
               / dense["steady_host_ms_per_step"], **first)
    emit(row)
    return {tag: row, dense_row["run"]: dense_row}, graph["exp"].module


def moe_serve_runs(work: str, module, kernels) -> tuple:
    """(z2) (z1)'s trained weights served at batch 128 in bf16 over
    MOE_SERVE_IMAGES synthetic images, unquantized and int8-wo: K2 launched
    exactly layers x batches, finite logits, the logits and per-token
    features of two served images and two probes against the same variant
    on the CPU in bf16 (1e-2, 0.125) with the card's routing of those four
    imposed on the CPU (force_routing; the assignments the CPU would route
    otherwise are counted), images/s, device ms a batch, busy share;
    int8-wo's table bytes and the device bytes held."""
    import numpy as np

    from vit_tpu_torch.data.images import ImageDataset
    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.ops.quant import quantized_size_bytes
    from vit_tpu_torch.serve import Predictor
    from vit_tpu_torch.train.torch_bridge import save_torch_checkpoint

    cfg = moe_config()
    pt = os.path.join(work, "z_moe.pt")
    save_torch_checkpoint(module, pt)
    images = ImageDataset(num_test_samples=MOE_SERVE_IMAGES, image_size=cfg["model"]["image_size"],
                          num_classes=cfg["model"]["num_labels"])
    images.load_data("test")
    x = images.images
    probes = torch.randn((2,) + x.shape[1:], generator=torch.Generator().manual_seed(2)).numpy()
    xs = torch.from_numpy(np.concatenate([x[:2], probes]))
    layers, bs = module.cfg.num_hidden_layers, 128
    expect = dict({n: 0 for n in kernels}, short_fwd=layers * -(-len(x) // bs))
    rows, live = {}, None
    for mode in (None, "int8-wo"):
        tag = f"z_moe_serve_{mode or 'bf16'}"
        p, held = resident_predictor(lambda: Predictor.from_checkpoint(
            cfg, ckpt=pt, batch_size=bs, quantize=mode, device="cuda"))
        p.predict(x[:bs])  # warm-up
        reset_launches()
        out = p._batched_logits(x)
        launches = {n: k.launches for n, k in kernels.items()}
        check_launches(tag, launches, expect)
        check(out.shape == (len(x), cfg["model"]["num_labels"]) and bool(np.isfinite(out).all()),
              f"{tag}: logits not finite or of shape {out.shape}")
        timing = serve_timing(p, x)
        cpu = Predictor.from_checkpoint(cfg, ckpt=pt, batch_size=len(xs), quantize=mode,
                                        device="cpu")
        card = moe_routing(p.module, xs.cuda(), forward=p._forward)
        routing = routing_diff(card, moe_routing(cpu.module, xs, forward=cpu._forward))
        force_routing(card)(cpu.module)
        with torch.inference_mode():
            want = cpu._forward(xs).float()
            got = p._forward(xs.cuda()).float().cpu()
        logit_err = (got - want).abs().max().item()
        feat_err = (quant_features(p, xs.cuda()) - quant_features(cpu, xs)).abs().max().item()
        check(logit_err <= 1e-2 and feat_err <= BF16_FEATURE_TOL,
              f"{tag}: card against the CPU's: logits {logit_err} (tol 1e-2), features "
              f"{feat_err} (tol {BF16_FEATURE_TOL})")
        row = dict(phase="moe_serve", run=tag, quantize=mode, variant=p.quant_variant,
                   batch=bs, inputs=len(x), launches=launches,
                   smoke_images_per_s=timing.pop("inputs_per_s"), **timing,
                   quantized_layers=len(p._qtable or {}),
                   quantized_size_bytes=quantized_size_bytes(p._qtable or {}),
                   resident_device_bytes=held, max_abs_logit_err_vs_cpu_same_variant=logit_err,
                   logit_tol=1e-2, max_abs_feature_err_vs_cpu_same_variant=feat_err,
                   feature_tol=BF16_FEATURE_TOL, routing_vs_cpu_unforced=routing)
        emit(row)
        rows[tag] = row
        if mode is None:
            live = p
        del cpu
    return rows, live, x


def moe_sweep_run(work: str, kernels) -> dict:
    """(z3) ``lr --engine vmap`` by its runner over three replicas of a
    2-layer MoE at (z)'s widths (dropout and jitter off, fp32: in bf16 the
    stacked and single products would round apart), one epoch, against the
    sequential engine's trials (its Experiments, built as it builds them):
    each replica's validation accuracy (the metric a classifier's sweep
    ranks by) and its epoch's mean training loss, the regulariser
    included, within SWEEP_REL; the captured replica step launches K2 and
    K6 once a layer."""
    import yaml

    from vit_tpu_torch.ops._build import reset_launches
    from vit_tpu_torch.opt.parallel_sweep import ParallelSweepRunner, _SequentialSweepEngine
    from vit_tpu_torch.train.loop import Experiment

    cfg = moe_config(num_hidden_layers=2, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, moe_router_jitter=0.0)
    cfg["train"]["precision"] = "float32"
    cfg["train"].pop("fused_epoch", None)
    path = os.path.join(work, "z_moe_sweep.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    runner = ParallelSweepRunner(path, lr_values=MOE_SWEEP_LRS, schedulers=["none"],
                                 metric_name="val_acc", metric_goal="maximize",
                                 results_dir=os.path.join(work, "z_vmap"), seed=0,
                                 device="cuda", gpu_ids=[0])
    reset_launches()
    t0 = time.perf_counter()
    runner.run()
    sweep_s = time.perf_counter() - t0
    calls = {n: k.launches for n, k in kernels.items()}
    with open(runner.summary_path) as f:
        summary = yaml.safe_load(f)
    vm = summary["results"]
    launches = replica_launches(runner.engine_run.epochs, calls,
                                dict({n: 0 for n in kernels}, short_fwd=2, short_bwd=2), kernels)
    vm_losses = runner.engine_run.epochs.losses.mean(dim=1).tolist()  # the one epoch's
    engine = _SequentialSweepEngine(runner.base_config, runner.sweep_configs, "val_acc",
                                    "maximize", 0, device="cuda")
    t0 = time.perf_counter()
    seq = [Experiment(engine.trial_config(c), seed=c.idx, device="cuda").fit()
           for c in runner.sweep_configs]
    seq_s = time.perf_counter() - t0
    rel = []
    for a, loss, b in zip(vm, vm_losses, seq):
        check(a["status"] == "ok", f"z3: replica {a}")
        rel.append(max(abs(a["metric"] - b["val_acc"]) / max(abs(b["val_acc"]), 1e-12),
                       abs(loss - b["train_loss"]) / abs(b["train_loss"])))
    check(max(rel) <= SWEEP_REL, f"z3: replicas' val_acc {[a['metric'] for a in vm]} and "
          f"train loss {vm_losses} against the sequential trials' "
          f"{[(b['val_acc'], b['train_loss']) for b in seq]} (relative {rel})")
    row = dict(phase="moe_sweep", run="z_moe_vmap_sweep", engine=summary["engine"],
               layers=2, replicas=len(vm), dtype="float32", lrs=MOE_SWEEP_LRS,
               val_acc=[a["metric"] for a in vm], train_loss=vm_losses,
               sequential_val_acc=[b["val_acc"] for b in seq],
               sequential_train_loss=[b["train_loss"] for b in seq], max_rel_diff=max(rel),
               tol=SWEEP_REL, sweep_seconds=sweep_s, sequential_seconds=seq_s, **launches)
    emit(row)
    return {row["run"]: row}


def moe_export_run(work: str, live, x, kernels) -> dict:
    """(z4) (z2)'s bf16 predictor exported and loaded by EXPORT_LOADER in a
    fresh process: its logits against the live predictor's (the same
    kernels in the same order: 0 expected), K2 counted inside the loaded
    program, layers x batches."""
    import numpy as np

    path, x_path = os.path.join(work, "z_moe.vittxpt"), os.path.join(work, "z_images.npy")
    out_path = os.path.join(work, "z_moe_loaded.npy")
    np.save(x_path, x)
    want = live._batched_logits(x)
    t0 = time.perf_counter()
    live.export(path)
    export_s = time.perf_counter() - t0
    result, load_s = load_in_fresh_process("z4", [path, x_path, out_path])
    got = np.load(out_path)
    diff = float(abs(got - want).max())
    expect = dict({n: 0 for n in kernels},
                  short_fwd=live.module.cfg.num_hidden_layers * -(-len(x) // live.batch_size))
    launches = result["results"][path]["launches"]
    check_launches("z4: the loaded program", launches, expect)
    check(got.shape == want.shape and diff <= 1e-2,
          f"z4: loaded against live logits {diff} apart (tol 1e-2)")
    row = dict(phase="export", run="z_moe_export", batch=live.batch_size, inputs=len(x),
               launches=launches, max_abs_diff_loaded_vs_live=diff, bit_equal=diff == 0.0,
               tol=1e-2, export_seconds=export_s, artifact_bytes=os.path.getsize(path),
               load_seconds=result["results"][path]["load_seconds"],
               loading_process_seconds=load_s)
    emit(row)
    return {row["run"]: row}


def moe_runs(work: str, kernels) -> dict:
    """Run (z), the Mixture-of-Experts ViT: (z1) training, (z2) serving,
    (z3) the vmapped sweep, (z4) export. Its seconds, and each part's, are
    printed."""
    t0 = time.perf_counter()
    parts = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    runs, module = timed("z1", moe_train_runs, kernels)
    serve, live, x = timed("z2", moe_serve_runs, work, module, kernels)
    runs.update(serve)
    runs.update(timed("z3", moe_sweep_run, work, kernels))
    runs.update(timed("z4", moe_export_run, work, live, x, kernels))
    emit(dict(phase="run_seconds", run="z (MoE)", seconds=time.perf_counter() - t0, parts=parts))
    return runs


# Run (P), the offline statistics (vit_tpu_torch.prepca, spectro): the sizes
# of a survey's preprocessing run, each card result held against the port's
# own device="cpu" run of the same call. The whole run (P1-P6) is float32
# exact on the card only with TF32 off, which main() sets for the script:
# the PCA scores, the KPCA kernels and transforms, PCP's power iteration and
# the attention are float32 products; the Grams, covariances, ZCA, PCP's
# loop and the eigendecompositions are float64 and do not depend on it.
P_SIZES = dict(spectra=16384, held_out=4096, length=4096, step1_spectra=2048, pcp_rows=1024,
               noisy=1024, r=64, landmarks=2048, chunk=4096, attn_batch=16, attn_tokens=4066,
               attn_dim=128, attn_heads=2, attn_fit_tokens=16384, attn_cpu_batch=2, images=512)
P_GAP = 1e-4  # relative eigengap under which columns are compared as one group
P_F64 = 1e-5  # float64 results (rounded to float32 where vit_tpu stores float32)
P_F32 = 1e-4  # float32 products: PCA scores, KPCA transforms, the attention
# Chunked against one-pass KPCA transforms on the card: only the float32
# reduction order differs (the CPU rehearsal, permuting the pixels: 1.8e-6).
P_CHUNK = 1e-5
P_PCP = 1e-4  # PCP's L and S within P_PCP * ||D||; iterations within P_PCP_ITERS
P_PCP_ITERS = 2
P_SELF_CHECK = 0.1  # ||W^T C W - I|| / ||I||: zca_self_check's gate (CPU rehearsal 4.6e-6)
P_NYSTROM = 1e-4  # landmark features' Z^T Z off-diagonal over its largest diagonal entry


def eig_groups(lam, gap: float = P_GAP) -> list:
    """Index groups of eigenvalues ``lam`` (any order) whose sorted
    neighbours lie within ``gap`` of the largest."""
    import numpy as np

    lam = np.asarray(lam, np.float64)
    order = np.argsort(lam)
    rel = np.diff(lam[order]) / max(float(np.abs(lam).max()), 1e-300)
    return [order[g] for g in np.split(np.arange(len(lam)), np.flatnonzero(rel > gap) + 1)]


def aligned_err(want, got, lam, gap: float = P_GAP, dev: str = "cpu") -> float:
    """Largest |got - want| over the largest |want| after each group of
    columns with near-equal eigenvalues ``lam`` is rotated onto ``want``'s by
    the orthogonal Procrustes solution (a sign for a lone column):
    eigenvectors, and features or scores that flip with them, have no sign
    convention, and a near-degenerate group none within its span. In
    float64 on ``dev`` (the card for the 8.3M-row scores of P1)."""
    a = torch.as_tensor(want).to(dev, torch.float64)
    b = torch.as_tensor(got).to(dev, torch.float64)
    err = 0.0
    for g in eig_groups(lam, gap):
        g = torch.as_tensor(g, device=dev)
        ag, bg = a[:, g], b[:, g]
        u, _, vt = torch.linalg.svd(bg.T @ ag)
        err = max(err, (bg @ (u @ vt) - ag).abs().max().item())
    return err / a.abs().max().item()


def rel_err(got, want) -> float:
    import numpy as np

    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def on_card(dev: str, fn):
    """(fn(), seconds, peak MiB allocated) with the card synchronised around
    fn; ``dev`` "cpu" (a rehearsal of run (P) on the CPU) reports no memory."""
    cuda = dev == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**20 if cuda else None)


def on_cpu(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def hold(tag: str, errors: dict) -> dict:
    """Check each ``name: (error, limit)``; the errors with their limits."""
    for name, (err, limit) in errors.items():
        check(err <= limit, f"{tag}: {name} {err} over its limit {limit}")
    return {name: dict(err=err, limit=limit) for name, (err, limit) in errors.items()}


def offline_pca(flux, x, sizes, dev) -> dict:
    """(P1) compute_pca at the CLI's example (patch 32, step 32) over every
    spectrum, then at step 1 over the first step1_spectra."""
    import numpy as np

    from vit_tpu_torch.prepca.pipeline import compute_pca

    rows = {}
    for tag, n, step in (("P1_pca_step32", sizes["spectra"], 32),
                         ("P1_pca_step1", sizes["step1_spectra"], 1)):
        card, card_s, peak = on_card(dev, lambda: compute_pca(x[:n], patch_size=32,
                                                              step=step, device=dev))
        cpu, cpu_s = on_cpu(lambda: compute_pca(flux[:n], patch_size=32, step=step,
                                                device="cpu"))
        lam = cpu["singular_values"].astype(np.float64) ** 2
        s_err = float(np.abs(card["singular_values"] / cpu["singular_values"] - 1).max())
        errors = hold(tag, {
            "singular_values_rel": (s_err, P_F64),
            "explained_variance_ratio_abs": (float(np.abs(
                card["explained_variance_ratio"] - cpu["explained_variance_ratio"]).max()), P_F64),
            "mean_rel": (rel_err(card["mean"], cpu["mean"]), P_F64),
            "components_aligned": (aligned_err(cpu["components"], card["components"], lam), P_F64),
            "scores_aligned": (aligned_err(cpu["scores"], card["scores"], lam, dev=dev), P_F32),
        })
        check(int(card["num_patches"]) == n * ((sizes["length"] - 32) // step + 1),
              f"{tag}: {int(card['num_patches'])} windows")
        rows[tag] = dict(phase="offline", step=tag, spectra=n, length=sizes["length"], patch=32,
                         stride=step, windows=int(card["num_patches"]), card_seconds=card_s,
                         cpu_seconds=cpu_s, peak_device_mib=peak, errors=errors,
                         top5_explained_variance=card["explained_variance_ratio"][:5].tolist())
        emit(rows[tag])
    return rows


def offline_zca(flux, x, held_out, sizes, dev) -> dict:
    """(P2) ZCAWhitening over every spectrum (N > D: full rank) with gamma
    0.1, eps 1e-5; then rank 64, alpha 0.1. Held against the CPU: the
    whitening matrix, covariance, eigenvalues and mean (sign free); the full
    fit's whitening check ||W^T C W - I|| / ||I|| from the stored float32
    state in float64 on the card; the low-rank fit's projector subspace.
    The held-out spectra's whitened covariance is reported."""
    import numpy as np

    from vit_tpu_torch.prepca.pipeline import ZCAWhitening

    rows = {}
    for tag, kw in (("P2_zca", dict(gamma=0.1, eps=1e-5)),
                    ("P2_zca_rank64", dict(gamma=0.1, eps=1e-5, rank=64, alpha=0.1))):
        card, card_s, peak = on_card(dev, lambda: ZCAWhitening(device=dev, **kw).fit(x))
        cpu, cpu_s = on_cpu(lambda: ZCAWhitening(device="cpu", **kw).fit(flux))
        sc, sp = card._state, cpu._state
        errors = {k: (rel_err(getattr(sc, k), getattr(sp, k)), P_F64)
                  for k in ("whitening", "covariance", "eigenvalues", "mean")}
        W = torch.from_numpy(sc.whitening).to(dev).double()
        eye = torch.eye(W.shape[0], dtype=torch.float64, device=dev)
        if kw.get("rank") is None:
            C = torch.from_numpy(sc.covariance).to(dev).double()
            errors["self_check"] = ((W.T @ C @ W - eye).norm().item() / eye.norm().item(),
                                    P_SELF_CHECK)
        else:
            pc, pp = (torch.from_numpy(p).double() for p in (sc.projector, sp.projector))
            errors["projector_subspace"] = ((pc.T @ pc - pp.T @ pp).abs().max().item(), P_F64)
        z = torch.from_numpy(card.transform(held_out)).to(dev).double()
        z = z - z.mean(dim=0)
        cov = z.T @ z / (z.shape[0] - 1)
        rows[tag] = dict(phase="offline", step=tag, spectra=sizes["spectra"],
                         length=sizes["length"], **{k: v for k, v in kw.items()},
                         card_seconds=card_s, cpu_seconds=cpu_s, peak_device_mib=peak,
                         errors=hold(tag, errors), held_out=len(held_out),
                         held_out_whitened_cov=dict(
                             diag_mean=cov.diagonal().mean().item(),
                             off_identity_fro_over_sqrt_d=((cov - eye).norm()
                                                           / math.sqrt(cov.shape[0])).item()),
                         eigenvalue_range=[float(sp.eigenvalues.min()),
                                           float(sp.eigenvalues.max())])
        del W, eye, z, cov
        emit(rows[tag])
    return rows


def offline_kpca(flux, x, sizes, dev) -> dict:
    """(P3) compute_kernel_pca at the CLI's defaults (r 64, 2048 landmarks,
    rbf, gamma auto) over every spectrum; its transform of every spectrum at
    chunk 4096 against one pass, against the CPU's state and transform
    (eigenvalues, then features aligned by eigenvalue group), and the
    Nyström property on the landmarks (Z^T Z diagonal, Z centred)."""
    import numpy as np

    from vit_tpu_torch.prepca.pipeline import compute_kernel_pca

    kw = dict(r=sizes["r"], landmarks=sizes["landmarks"])
    card, fit_s, peak = on_card(dev, lambda: compute_kernel_pca(x, device=dev, **kw))
    cpu, cpu_fit_s = on_cpu(lambda: compute_kernel_pca(flux, device="cpu", **kw))
    check(np.array_equal(card.landmarks, cpu.landmarks) and card.gamma == cpu.gamma,
          "P3: the card's landmarks or gamma differ from the CPU's")
    lam_card = 1.0 / (card.A.astype(np.float64) ** 2).sum(0)  # A = V Lam^-1/2
    lam_cpu = 1.0 / (cpu.A.astype(np.float64) ** 2).sum(0)
    z, chunk_s, chunk_peak = on_card(dev, lambda: card.transform(x, chunk=sizes["chunk"]))
    one, one_s, one_peak = on_card(dev, lambda: card.transform(x))
    z_cpu, cpu_tr_s = on_cpu(lambda: cpu.transform(flux))
    zl = card.transform(card.landmarks).astype(np.float64)
    gram = zl.T @ zl
    off = gram - np.diag(np.diag(gram))
    errors = hold("P3", {
        "eigenvalues_over_largest": (float(np.abs(lam_card - lam_cpu).max() / lam_cpu.max()),
                                     P_F64),
        "chunked_vs_one_pass": (rel_err(z, one), P_CHUNK),
        "features_aligned_vs_cpu": (aligned_err(z_cpu, z, lam_cpu), P_F32),
        "nystrom_off_diagonal": (float(np.abs(off).max() / np.abs(np.diag(gram)).max()),
                                 P_NYSTROM),
        "nystrom_mean": (float(np.abs(zl.mean(axis=0)).max()), 1e-3),
    })
    groups = eig_groups(lam_cpu)
    row = dict(phase="offline", step="P3_kpca", spectra=sizes["spectra"], length=sizes["length"],
               **kw, kernel="rbf", gamma=card.gamma, fit_card_seconds=fit_s,
               fit_cpu_seconds=cpu_fit_s, fit_peak_device_mib=peak,
               transform_chunked_card_seconds=chunk_s, transform_one_pass_card_seconds=one_s,
               transform_peak_device_mib=[chunk_peak, one_peak],
               transform_cpu_seconds=cpu_tr_s, errors=errors,
               eigenvalue_range=[float(lam_cpu.min()), float(lam_cpu.max())],
               eigen_groups=len(groups), largest_group=max(len(g) for g in groups))
    emit(row)
    return {"P3_kpca": row}


def offline_pcp(flux, x, sizes, dev) -> dict:
    """(P4) compute_pcp on the first pcp_rows spectra at the defaults (tol
    1e-7, max_iter 1000): L and S against the CPU within P_PCP * ||D||, the
    iterations within P_PCP_ITERS, the final residual under tol; the rank
    reported (it may move by one at the threshold). One SVT of D on the
    card two ways: the Gram-eigh the loop uses, and torch.linalg.svd."""
    import numpy as np

    from vit_tpu_torch.prepca.pipeline import _svt, compute_pcp

    n = sizes["pcp_rows"]
    (L, S, hist), card_s, peak = on_card(dev, lambda: compute_pcp(x[:n], device=dev))
    (Lc, Sc, hc), cpu_s = on_cpu(lambda: compute_pcp(flux[:n], device="cpu"))
    norm = float(np.linalg.norm(flux[:n].astype(np.float64)))
    errors = hold("P4", {
        "low_rank_over_norm": (float(np.abs(L - Lc).max()) / norm, P_PCP),
        "sparse_over_norm": (float(np.abs(S - Sc).max()) / norm, P_PCP),
        "iterations_apart": (abs(hist["iters"] - hc["iters"]), P_PCP_ITERS),
        "final_residual": (hist["primal_resid"][-1], 1e-7),
    })
    M = x[:n].double()
    svt_ms = {}
    for name, fn in (("gram_eigh", lambda: _svt(M, 1.0)),
                     ("linalg_svd", lambda: torch.linalg.svd(M, full_matrices=False))):
        fn()
        svt_ms[name] = call_ms(fn, reps=2, warmup=0) if dev == "cuda" else None
    row = dict(phase="offline", step="P4_pcp", rows=n, length=sizes["length"], tol=1e-7,
               max_iter=1000, card_seconds=card_s, cpu_seconds=cpu_s, peak_device_mib=peak,
               iterations=hist["iters"], cpu_iterations=hc["iters"],
               final_residual=hist["primal_resid"][-1], rank=hist["rank"][-1],
               cpu_rank=hc["rank"][-1], nnz=hist["nnz"][-1], errors=errors,
               svt_ms_of_d=svt_ms, reduced={"rows": f"16384 -> {n} (time)"})
    emit(row)
    return {"P4_pcp": row}


def offline_denoise(flux, x, sizes, dev) -> dict:
    """(P5) SVDDenoiser(32) fit on every spectrum, then the first noisy
    spectra with seeded noise at the spectra's noise floor denoised; held
    against the CPU: ratios, mean, basis (aligned), the denoised spectra."""
    import numpy as np

    from vit_tpu_torch.spectro import SVDDenoiser

    n = sizes["noisy"]
    card, fit_s, peak = on_card(dev, lambda: SVDDenoiser(32, device=dev).fit(x))
    cpu, cpu_fit_s = on_cpu(lambda: SVDDenoiser(32, device="cpu").fit(flux))
    noise = np.random.default_rng(4).standard_normal((n, sizes["length"])).astype(np.float32)
    noisy = flux[:n] + 0.01 * noise
    out, den_s, den_peak = on_card(dev, lambda: card.denoise(torch.from_numpy(noisy).to(dev)))
    out_cpu, cpu_den_s = on_cpu(lambda: cpu.denoise(noisy))
    evr = cpu.explained_variance_ratio_
    errors = hold("P5", {
        "explained_variance_ratio_rel": (float(np.abs(
            card.explained_variance_ratio_ / evr - 1).max()), P_F64),
        "mean_rel": (rel_err(card.mean_spectrum, cpu.mean_spectrum), P_F64),
        "basis_aligned": (aligned_err(cpu.V, card.V, evr), P_F64),
        "denoised_rel": (rel_err(out, out_cpu), P_F64),
    })
    rms = lambda a: float(np.sqrt(((a - flux[:n]) ** 2).mean()))  # noqa: E731
    row = dict(phase="offline", step="P5_svd_denoiser", spectra=sizes["spectra"],
               length=sizes["length"], components=32, noisy=n, fit_card_seconds=fit_s,
               fit_cpu_seconds=cpu_fit_s, denoise_card_seconds=den_s,
               denoise_cpu_seconds=cpu_den_s, peak_device_mib=[peak, den_peak],
               errors=errors, explained_variance_top32=float(evr.sum()),
               rms_noisy=rms(noisy), rms_denoised=rms(out))
    emit(row)
    return {"P5_svd_denoiser": row}


def offline_attention(sizes, dev) -> dict:
    """(P6) KPCAWarmSelfAttention at stride1's width (dim 128, 2 heads, T
    4066, batch 16), its KPCA state (r 64, 2048 landmarks) fitted on the
    card on seeded 128-wide tokens; forward (with the probabilities) and
    backward of sum(w * out) in float32. Held against the CPU at the first
    attn_cpu_batch items (each item's output, probabilities and input
    gradient depend on it alone), the parameter gradients against a card
    run at that batch."""
    import numpy as np

    from vit_tpu_torch.prepca.attention import KPCAWarmSelfAttention
    from vit_tpu_torch.prepca.pipeline import compute_kernel_pca

    rng = np.random.default_rng(5)
    d, b, t, cb = sizes["attn_dim"], sizes["attn_batch"], sizes["attn_tokens"], \
        sizes["attn_cpu_batch"]
    tokens = torch.from_numpy(rng.standard_normal((sizes["attn_fit_tokens"], d))
                              .astype(np.float32))
    state, fit_s, _ = on_card(dev, lambda: compute_kernel_pca(
        tokens.to(dev), r=sizes["r"], landmarks=sizes["landmarks"], device=dev))
    module = KPCAWarmSelfAttention(d, sizes["attn_heads"], state,
                                   generator=torch.Generator().manual_seed(0), device=dev)
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))

    def step(m, xx, ww):
        m.zero_grad(set_to_none=True)
        xx = xx.clone().requires_grad_(True)
        out, probs = m(xx, need_weights=True)
        (out * ww).sum().backward()
        return out.detach(), probs.detach(), xx.grad, {k: p.grad for k, p in m.named_parameters()}

    full, card_s, peak = on_card(dev, lambda: step(module, x.to(dev), w.to(dev)))
    check(all(bool(torch.isfinite(v).all()) for v in full[:3]),
          "P6: the full-batch forward or backward is not finite")
    small = step(module, x[:cb].to(dev), w[:cb].to(dev))
    cpu_module = KPCAWarmSelfAttention(d, sizes["attn_heads"], state, device="cpu")
    cpu_module.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
    ref, cpu_s = on_cpu(lambda: step(cpu_module, x[:cb], w[:cb]))
    errors = {"output": (rel_err(full[0][:cb].cpu(), ref[0]), P_F32),
              "probs": (rel_err(full[1][:cb].cpu(), ref[1]), P_F32),
              "input_grad": (rel_err(full[2][:cb].cpu(), ref[2]), P_F32)}
    errors.update({f"grad_{k}": (rel_err(small[3][k].cpu(), ref[3][k]), P_F32) for k in ref[3]})
    row = dict(phase="offline", step="P6_kpca_attention", batch=b, tokens=t, dim=d,
               heads=sizes["attn_heads"], d_k=module.d_k, r=sizes["r"],
               landmarks=sizes["landmarks"], state_fit_card_seconds=fit_s,
               fwd_bwd_card_seconds=card_s, peak_device_mib=peak, cpu_batch=cb,
               fwd_bwd_cpu_seconds=cpu_s, errors=hold("P6", errors))
    del full, small
    emit(row)
    return {"P6_kpca_attention": row}


def offline_cli(work: str, sizes, dev) -> dict:
    """(P7) ``python -m vit_tpu_torch.prepca.precompute_pca --images NPZ
    --patch-size 4 --device cuda`` on synthetic 32-pixel images in a
    subprocess; the artifact read by the port's load_patch_pca_stats and
    held against compute_patch_pca_images on the CPU at (u)'s limits; then
    cifar_vit_s16_pca.yaml built from it on the card and served a batch."""
    import copy

    import numpy as np

    from vit_tpu_torch.data.images import make_dummy_images
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.prepca.pipeline import compute_patch_pca_images
    from vit_tpu_torch.serve import Predictor
    from vit_tpu_torch.utils import load_patch_pca_stats

    images = make_dummy_images(n=sizes["images"], image_size=32, num_classes=10, seed=0)["images"]
    npz = os.path.join(work, "p7_images.npz")
    np.savez(npz, images=images)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vit_tpu_torch.prepca.precompute_pca", "--images", npz,
         "--patch-size", "4", "--device", dev, "--out", "p7_pca_img_4.npz"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=dict(os.environ, PCA_DIR=work),
        capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"P7: precompute_pca failed:\n{proc.stderr[-4000:]}")
    path = os.path.join(work, "p7_pca_img_4.npz")
    stats = load_patch_pca_stats(path)
    cpu = compute_patch_pca_images(images, patch_size=4, device="cpu")
    top = cpu["explained_variance_ratio"] > 1e-3
    signs = np.sign((stats["components"] * cpu["components"]).sum(0))
    errors = hold("P7", {
        "explained_variance_ratio_abs": (float(np.abs(
            stats["explained_variance_ratio"] - cpu["explained_variance_ratio"]).max()), 1e-5),
        "mean_abs": (float(np.abs(stats["mean"] - cpu["mean"]).max()), 1e-6),
        "basis_top_abs": (float(np.abs(stats["components"] * signs - cpu["components"])
                                [:, top].max()), 1e-3),
    })
    cfg = image_config("cifar_vit_s16_pca.yaml")
    cfg["warmup"]["cov_path"] = path
    bundle = get_model(copy.deepcopy(cfg), generator=torch.Generator().manual_seed(0))
    p = Predictor(bundle.module.to(dev), bundle.vit_config, batch_size=8)
    logits = p._batched_logits(images[:16])
    check(logits.shape == (16, 10) and bool(np.isfinite(logits).all()),
          f"P7: logits of shape {logits.shape} or not finite")
    row = dict(phase="offline", step="P7_precompute_pca_cli", images=sizes["images"],
               patch=4, cli_process_seconds=cli_s, artifact_keys=sorted(stats),
               errors=errors, served_logits_shape=list(logits.shape))
    emit(row)
    return {"P7_precompute_pca_cli": row}


def offline_runs(work: str, sizes=None, dev: str = "cuda") -> dict:
    """Run (P): P1-P7 on the synthetic spectra (make_dummy_spectra, seed 2:
    the first ``spectra`` fitted, the last ``held_out`` held out) moved to
    the card once. Its seconds, and each part's, are printed. ``sizes``
    overrides P_SIZES and ``dev="cpu"`` runs the "card" side on the CPU: a
    rehearsal of the run's control flow at small sizes."""
    from vit_tpu_torch.data.synthetic import make_dummy_spectra

    sizes = dict(P_SIZES, **(sizes or {}))
    t0 = time.perf_counter()
    parts = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    data = timed("data", lambda: make_dummy_spectra(n=sizes["spectra"] + sizes["held_out"],
                                                    length=sizes["length"], seed=2)["flux"])
    flux, held_out = data[:sizes["spectra"]], data[sizes["spectra"]:]
    x = torch.from_numpy(flux).to(dev)
    runs = {}
    runs.update(timed("P1", offline_pca, flux, x, sizes, dev))
    runs.update(timed("P2", offline_zca, flux, x, held_out, sizes, dev))
    runs.update(timed("P3", offline_kpca, flux, x, sizes, dev))
    runs.update(timed("P4", offline_pcp, flux, x, sizes, dev))
    runs.update(timed("P5", offline_denoise, flux, x, sizes, dev))
    del x
    runs.update(timed("P6", offline_attention, sizes, dev))
    runs.update(timed("P7", offline_cli, work, sizes, dev))
    emit(dict(phase="run_seconds", run="P (offline statistics)",
              seconds=time.perf_counter() - t0, parts=parts))
    return runs


def offset_check(kernels) -> dict:
    """A data-parallel rank's launches: K1/K2 forward and K4+K5/K6 backward
    over rows [2, 4) of a batch of 4 (two heads) with dropout and
    ``bh_offset`` 4 give the full launch's heads 4..7 bit for bit (the
    masks of the global batch), and the plain versions with the same
    offset agree at the kernel limits (values), in fp32 and bf16, at
    baseline's and stride1's head shapes."""
    from vit_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(5)
    h, lo, rate = 2, 2, 0.1
    out = {}
    for short, t, d in ((True, 129, 16), (False, 4066, 64)):
        fwd, bwd = (fa.short_fwd, fa.short_bwd) if short else (fa.flash_fwd, fa.flash_bwd)
        pfwd, pbwd = ((fa.short_fwd_plain, fa.short_bwd_plain) if short
                      else (fa.flash_fwd_plain, fa.flash_bwd_plain))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(4 * h, t, d, generator=g, device="cuda").to(dtype)
                           for _ in range(4))
            scale = d**-0.5
            part = [x[lo * h:].contiguous() for x in (q, k, v, do)]
            o, lse = fwd(q, k, v, scale, rate, DROPOUT_SEED)
            o2, lse2 = fwd(*part[:3], scale, rate, DROPOUT_SEED, bh_offset=lo * h)
            delta = (do.float() * o.float()).sum(-1)
            full = bwd(q, k, v, do, lse, delta, scale, rate, DROPOUT_SEED)
            args = (*part, lse[lo * h:].contiguous(), delta[lo * h:].contiguous(), scale, rate,
                    DROPOUT_SEED)
            mine = bwd(*args, bh_offset=lo * h)
            name = f"{'K2/K6' if short else 'K1/K4+K5'} T{t} d{d} {str(dtype).split('.')[-1]}"
            same = [torch.equal(o2, o[lo * h:]), torch.equal(lse2, lse[lo * h:])]
            same += [torch.equal(a, b[lo * h:]) for a, b in zip(mine, full)]
            check(all(same), f"{name}: a launch at bh_offset {lo * h} is not the full launch's "
                  f"slice bit for bit ({same})")
            po, _ = pfwd(*part[:3], scale, rate, DROPOUT_SEED, bh_offset=lo * h)
            pg = pbwd(*args, bh_offset=lo * h)
            errs = [(o2.float() - po.float()).abs().max().item()]
            errs += [(a.float() - b.float()).abs().max().item() for a, b in zip(mine, pg)]
            tols = [kernel_tol(po)] + [kernel_tol(b) for b in pg]
            check(all(e <= tl for e, tl in zip(errs, tols)),
                  f"{name}: against the plain versions at bh_offset {lo * h}: {errs} > {tols}")
            out[name] = dict(bit_equal_to_full_launch_slice=True,
                             max_abs_err=dict(zip(("o", "dq", "dk", "dv"), errs)),
                             limits=dict(zip(("o", "dq", "dk", "dv"), tols)))
    emit(dict(phase="offset_check", rows=f"[{lo}, 4) of 4", heads=h, rate=rate, results=out))
    return out


# -- (D) parallelism: two ranks sharing the card ---------------------------------
# The runs' sizes (PERF.md section 4 lists each cut): (D1) "spectra" at
# batch 16 for "epochs" epochs; (D2) stride1 over "stride1_spectra"; (D3)
# ViT-B/16 at "b16_layers" layers and batch "b16_batch" of "images"; (D4)
# ViT-S/16-MoE at "moe_layers" layers over "moe_images", ViT-L/16 at
# "l16_layers" layers and batch "l16_batch" of "l16_images"; the ring op
# alone at B "ring_batch", T "ring_t". (D3b) is (D3) with the replicated
# pipeline (train.pipeline_stage_params: false); (D3c) and (D3d, + ZeRO-1)
# run it on four ranks, data 2 x pipe 2, over "images4".
D_SIZES = dict(spectra=1024, epochs=2, stride1_spectra=32, images=512, images4=128,
               moe_images=256, val=128,
               b16_batch=64, b16_layers=4, moe_layers=6, l16_layers=2, l16_batch=32,
               l16_images=64, ring_batch=16, ring_t=4066, profile_steps=2, forward_rows=8)
D_LIMITS = {"float32": FP32_TOL, "bfloat16": 2e-2}  # first steps, per tensor
D_TIMEOUT = 600  # seconds for a group of ranks to finish its runs


def d_spectra_config(name: str, **train) -> dict:
    """``configs/exp/att_clp/<name>`` as it stands but for the data (in
    memory), ``viz`` (off) and ``train`` overrides."""
    from vit_tpu_torch.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                   "exp", "att_clp", name))
    cfg["data"] = dict(_DATA)
    cfg["viz"] = {"enable": False}
    cfg["train"].update(save=False, **train)
    return cfg


def d_jobs(s: dict) -> list:
    """(D1)-(D4): each run's two-rank config, its data and what it holds."""
    spectra = dict(kind="spectra", n=s["spectra"], length=4096, seed=1)
    base = dict(batch_size=16, ep=s["epochs"], gpus=2)
    flash = d_spectra_config("baseline.yaml", **base)
    flash["model"].update(attn_impl="flash", fused_mlp=True)
    jobs = [
        dict(tag="D1a_baseline_dp", cfg=d_spectra_config("baseline.yaml", **base),
             data=spectra, first_step=True, save_params=True),
        dict(tag="D1b_baseline_dp_zero1",
             cfg=d_spectra_config("baseline.yaml", opt_state_sharding=True, **base),
             data=spectra, save_params=True, same_as="D1a_baseline_dp"),
        dict(tag="D1c_baseline_dp_flash_fused", cfg=flash, data=spectra, first_step=True,
             kernels=("short_fwd", "short_bwd", "fused_mlp_fwd", "fused_mlp_bwd")),
    ]
    s1 = d_spectra_config("stride1.yaml", ep=1, gpus=2, sequence_parallel=2)
    s1["model"]["attn_impl"] = "ring"
    if s.get("stride1_batch"):
        s1["train"]["batch_size"] = s["stride1_batch"]
    jobs.append(dict(tag="D2_stride1_ring_sp2", cfg=s1,
                     data=dict(kind="spectra", n=s["stride1_spectra"], length=4096, seed=1),
                     first_step=True))
    b16 = image_config("vit_b16_bf16.yaml", num_hidden_layers=s["b16_layers"],
                       attn_impl="flash", hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    b16["data"] = {"num_samples": s["images"], "num_test_samples": s["val"]}
    b16["train"].update(batch_size=s["b16_batch"], gpus=2, pipeline_parallel=2,
                        pipeline_microbatches=4)
    jobs.append(dict(tag="D3_vit_b16_pp2", cfg=b16, data=dict(kind="images"), first_step=True,
                     forward=True, save_params=True, kernels=("short_fwd", "short_bwd")))
    replicated = copy.deepcopy(b16)
    replicated["train"]["pipeline_stage_params"] = False
    jobs.append(dict(tag="D3b_vit_b16_pp2_replicated", cfg=replicated, data=dict(kind="images"),
                     first_step=True, one_rank_as="D3_vit_b16_pp2", save_params=True,
                     params_as="D3_vit_b16_pp2", kernels=("short_fwd", "short_bwd")))
    moe = image_config("cifar_vit_s16_moe.yaml", num_hidden_layers=s["moe_layers"],
                       attn_impl="flash")
    moe["data"] = {"num_samples": s["moe_images"], "num_test_samples": s["val"]}
    moe["train"].update(gpus=2)  # model_parallel: 2 as the file has it
    jobs.append(dict(tag="D4a_cifar_s16_moe_ep2", cfg=moe, data=dict(kind="images"),
                     first_step=True, kernels=("short_fwd", "short_bwd")))
    l16 = image_config("vit_l16_multihost.yaml", num_hidden_layers=s["l16_layers"])
    l16["data"] = {"num_samples": s["l16_images"], "num_test_samples": s["val"]}
    l16["train"].update(batch_size=s["l16_batch"], gpus=2)  # model_parallel: 2 as written
    jobs.append(dict(tag="D4b_vit_l16_tp2", cfg=l16, data=dict(kind="images"), first_step=True))
    jobs.append(dict(tag="D2_ring_op", kind="ring_op"))
    return jobs


def d_jobs4(s: dict) -> list:
    """(D3c), (D3d): (D3b) on four ranks, data 2 x pipe 2, over images4
    images; (D3d) with ZeRO-1 over each stage's data group, its parameters
    held bit for bit to (D3c)'s."""
    b16 = next(j for j in d_jobs(s) if j["tag"] == "D3b_vit_b16_pp2_replicated")["cfg"]
    c = copy.deepcopy(b16)
    c["data"]["num_samples"] = s["images4"]
    c["train"]["gpus"] = 4
    d = copy.deepcopy(c)
    d["train"]["opt_state_sharding"] = True
    kernels = ("short_fwd", "short_bwd")
    return [dict(tag="D3c_vit_b16_dp2_pp2_replicated", cfg=c, data=dict(kind="images"),
                 first_step=True, save_params=True, kernels=kernels),
            dict(tag="D3d_vit_b16_dp2_pp2_replicated_zero1", cfg=d, data=dict(kind="images"),
                 save_params=True, same_as="D3c_vit_b16_dp2_pp2_replicated", kernels=kernels)]


def d_one_rank(cfg: dict) -> dict:
    """The one-rank reference of a two-rank config: the same run with every
    parallel setting at 1."""
    ref = copy.deepcopy(cfg)
    for key in ("gpus", "model_parallel", "sequence_parallel", "pipeline_parallel",
                "pipeline_microbatches", "pipeline_stage_params", "opt_state_sharding"):
        ref["train"].pop(key, None)
    return ref


def d_datamodule(job: dict, cfg: dict):
    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.images import ImageDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra

    d = job["data"]
    if d["kind"] == "images":
        return ImageDataModule(cfg)
    return SpecDataModule(cfg, source=make_dummy_spectra(n=d["n"], length=d["length"],
                                                         seed=d["seed"]))


def d_profile(exp, steps: int, dev: str) -> dict:
    """``steps`` more training steps on a batch already on the device: host
    ms a step, torch.profiler's device ms a step and the collectives' share
    of it (NCCL's kernels, and gloo's host-staging copies: Memcpy), and the
    host seconds inside the collective wrapper."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vit_tpu_torch.parallel import comm
    from vit_tpu_torch.parallel.mesh import active_mesh_scope
    from vit_tpu_torch.train.optim import OptSpec, schedule_scale

    n = len(exp.datamodule.train)
    spec = OptSpec.from_config(exp.config, -(-n // exp.batch_size), monitor_metric=exp.monitor)
    arrays = exp.datamodule.train.arrays()
    batch = {k: torch.from_numpy(arrays[k][:exp.batch_size]).to(dev) for k in ("x", "label")}
    sched = schedule_scale(spec)
    cuda = dev == "cuda"
    with active_mesh_scope(exp.mesh):
        exp.train_step(batch, spec, sched)  # warm
        if cuda:
            torch.cuda.synchronize()
        comm.reset_stats()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        t0 = time.perf_counter()
        try:
            with profile(activities=acts) as prof:
                for _ in range(steps):
                    exp.train_step(batch, spec, sched)
                if cuda:
                    torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ops = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and "#" not in e.key]
            dev_ms = sum(ms for _, ms in ops)
            coll = sum(ms for k, ms in ops if "nccl" in k.lower() or "memcpy" in k.lower())
            row = dict(device_ms_per_step=dev_ms / steps if dev_ms else "not measured",
                       collective_device_share=coll / dev_ms if dev_ms else "not measured")
        except Exception as e:  # the profiler is untried with two processes on one card
            wall = time.perf_counter() - t0
            row = dict(device_ms_per_step="not measured", collective_device_share="not measured",
                       profiler_error=f"{type(e).__name__}: {e}")
        row.update(profiled_steps=steps, profiled_host_ms_per_step=wall * 1e3 / steps,
                   collective_host_share=comm.STATS["seconds"] / wall,
                   staged_bytes_per_step=comm.STATS["staged_bytes"] / steps,
                   collective_calls_per_step=comm.STATS["calls"] / steps)
    return row


def d_run(job: dict, world: int, out_dir: str, dev: str, sizes: dict) -> dict:
    """One (D) run on this rank (``world`` 1: the one-rank reference):
    Experiment through its entry points; the first step's gradients (rank 0
    writes them in the one-rank layout), the pipelined forward, ``fit``
    with its launch counts and timings, then a profiled window."""
    import copy

    import numpy as np

    from vit_tpu_torch.ops import _build
    from vit_tpu_torch.parallel import comm
    from vit_tpu_torch.parallel.checkpoint import canonical_grads, canonical_state_dict
    from vit_tpu_torch.parallel.mesh import active_mesh_scope
    from vit_tpu_torch.train.loop import Experiment, loss_and_grads
    from vit_tpu_torch.train.optim import state_bytes

    if job.get("kind") == "ring_op":
        return d_ring_op(world, out_dir, dev, sizes)
    cfg = copy.deepcopy(job["cfg"] if world > 1 else d_one_rank(job["cfg"]))
    dm = d_datamodule(job, cfg)
    exp = Experiment(copy.deepcopy(cfg), device=dev, num_devices=world, datamodule=dm)
    dm.setup("fit")
    mesh = exp.mesh
    rank0 = mesh.rank == 0
    path = lambda what: os.path.join(out_dir, f"{job['tag']}_{what}_w{world}.pt")  # noqa: E731
    row = dict(tag=job["tag"], world=world, backend=mesh.backend or "none (one process)",
               mesh=dict(mesh.shape))
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if job.get("first_step"):
        arrays = dm.train.arrays()
        batch = {k: torch.from_numpy(np.ascontiguousarray(arrays[k][:exp.batch_size])).to(dev)
                 for k in ("x", "label")}
        sites = exp.module.num_dropout_sites
        seeds = [list(range(1000 + 97 * a, 1000 + 97 * a + sites))
                 for a in range(exp.accum_steps)]
        exp.module.train()
        with active_mesh_scope(mesh):
            loss = loss_and_grads(exp.module, batch, exp.bundle.vit_config.task_type,
                                  exp.bundle.loss_name, seeds,
                                  shard=(mesh.coord("data"), mesh.size("data")))
            loss = exp.reduce_gradients(loss)
            grads = canonical_grads(exp.module, mesh, exp._param_names)
        for p in exp.module.parameters():
            p.grad = None
        row["first_step_loss"] = float(loss)
        if rank0:
            torch.save(grads, path("grads"))
    if job.get("forward"):
        x = torch.from_numpy(np.ascontiguousarray(
            dm.val.arrays()["x"][:sizes["forward_rows"]])).to(dev)
        exp.module.eval()
        with torch.no_grad(), active_mesh_scope(mesh):
            logits = exp.module(x).float().cpu()
        exp.module.train()
        if rank0:
            torch.save(logits, path("logits"))
    _build.reset_launches()
    comm.reset_stats()
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = exp.fit()
    if dev == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = len(exp.epoch_losses)
    row.update(fit_seconds=fit_s, steps_per_epoch=steps, epochs=int(cfg["train"].get("ep", 1)),
               host_ms_per_step_last_epoch=metrics["epoch_time_s"] * 1e3 / steps,
               fit_collective_calls=comm.STATS["calls"],
               fit_staged_bytes=comm.STATS["staged_bytes"],
               fit_collective_host_seconds=comm.STATS["seconds"],
               fit_bucket_bytes=comm.STATS["bucket_bytes"],
               fit_bucket_seconds=comm.STATS["bucket_seconds"],
               path="per-step" if exp.fused is None else "fused (CUDA graph)",
               last_epoch_losses_finite=bool(np.isfinite(exp.epoch_losses).all()),
               train_loss=metrics["train_loss"],
               launches={n: k.launches for n, k in _build.KERNELS.items()},
               opt_state_bytes=state_bytes(exp.optimizer))
    if job.get("save_params"):
        sd = canonical_state_dict(exp.module, mesh, exp._state_names)
        if rank0:
            torch.save(sd, path("params"))
    pipe = exp.module.vit.encoder.pipeline
    if pipe is not None:
        pipe.stats = {}
    row.update(d_profile(exp, sizes["profile_steps"], dev))
    if pipe is not None:
        fw = pipe.stats.get("forward", [])
        row["stage_forward_busy_share"] = (statistics.mean(r["busy_share"] for r in fw)
                                           if fw else None)
        row["bubble_share_ideal"] = fw[0]["bubble_share_ideal"] if fw else None
        pipe.stats = None
    row["peak_mib"] = (torch.cuda.max_memory_allocated() / 2**20 if dev == "cuda"
                       else "not measured")
    return row


def d_ring_inputs(sizes: dict, dtype, dev: str):
    g = torch.Generator(device=dev).manual_seed(11)
    shape = (sizes["ring_batch"], 2, sizes["ring_t"], 64)
    return [torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4)]


def d_ring_op(world: int, out_dir: str, dev: str, sizes: dict) -> dict:
    """(D2) the ring alone at B16 H2 T4066 d64 over the ranks, fp32 and bf16,
    dropout 0.1 and 0: rank 0 writes the output and dq, dk, dv (the whole
    sequence's, gathered); the host ms of a forward and backward, synced."""
    from vit_tpu_torch.ops.ring_attention import ring_attention
    from vit_tpu_torch.parallel import comm
    from vit_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(num_devices=world, model_parallel=world)
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.1):
            q, k, v, g = d_ring_inputs(sizes, dtype, dev)
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]

            def step():
                for x in xs:
                    x.grad = None
                out = ring_attention(*xs, mesh, axis="model", dropout_rate=rate,
                                     dropout_seed=DROPOUT_SEED if rate else None)
                (out.float() * g.float()).sum().backward()
                return out

            out = step()
            if dev == "cuda":
                torch.cuda.synchronize()
            comm.reset_stats()
            reps = 1
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            if dev == "cuda":
                torch.cuda.synchronize()
            seconds = (time.perf_counter() - t0) / reps
            key = f"{str(dtype).split('.')[-1]}_rate{rate}"
            cases[key] = dict(host_ms_fwd_bwd=seconds * 1e3,
                              staged_bytes=comm.STATS["staged_bytes"] / reps,
                              collective_host_share=comm.STATS["seconds"] / (seconds * reps))
            if mesh.rank == 0:
                torch.save([t.detach().float().cpu() for t in (out, *(x.grad for x in xs))],
                           os.path.join(out_dir, f"ring_{key}_w{world}.pt"))
            del q, k, v, g, xs, out
    return dict(tag="D2_ring_op", world=world, backend=mesh.backend, cases=cases)


def d_worker(rank: int, world: int, port: int, backend: str, jobs: list, out_dir: str,
             dev: str, sizes: dict) -> None:
    """A rank of (D): joins the group, runs every job in order, writes its
    rows (or its traceback) to ``out_dir``."""
    import datetime
    import traceback

    import torch.distributed as dist

    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    result = {}
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=D_TIMEOUT))
        for job in jobs:
            t0 = time.perf_counter()
            result[job["tag"]] = d_run(job, world, out_dir, dev, sizes)
            result[job["tag"]]["run_seconds"] = time.perf_counter() - t0
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent process reports it
        result["error"] = traceback.format_exc()
        torch.save(result, os.path.join(out_dir, f"rows_w{world}_r{rank}.pt"))
        os._exit(1)
    torch.save(result, os.path.join(out_dir, f"rows_w{world}_r{rank}.pt"))


def d_group(world: int, backend: str, jobs: list, out_dir: str, dev: str, sizes: dict) -> list:
    """Start ``world`` ranks of d_worker and wait for them (D_TIMEOUT; the
    stragglers are killed): each rank's rows."""
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=d_worker, args=(r, world, port, backend, jobs, out_dir, dev,
                                                sizes)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + D_TIMEOUT
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.time()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    rows = []
    for r in range(world):
        f = os.path.join(out_dir, f"rows_w{world}_r{r}.pt")
        rows.append(torch.load(f, weights_only=False) if os.path.exists(f) else {})
    errors = [r["error"] for r in rows if r.get("error")]
    check(not alive and not errors, f"(D) {world} rank(s) on {backend}: "
          f"{'timed out; ' if alive else ''}{errors[0][-3000:] if errors else ''}")
    return rows


def d_nccl_probe_worker(rank: int, port: int, q) -> None:
    import datetime

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=60))
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        q.put((rank, "ok" if float(t[0]) == 2.0 else f"wrong sum {float(t[0])}"))
        dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 - the refusal is the expected answer
        q.put((rank, f"{type(e).__name__}: {e}"))


def d_nccl_probe(dev: str) -> dict:
    """(D0) Two NCCL ranks on the one card, one all-reduce. NCCL refuses a
    communicator with two ranks on one device; what it answers decides the
    two-rank backend (gloo when it refuses)."""
    import multiprocessing as mp
    import queue
    import socket

    if dev != "cuda":
        return dict(nccl_two_ranks_one_card="not tried (CPU rehearsal)", backend="gloo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=d_nccl_probe_worker, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    answers = []
    deadline = time.time() + 120
    while len(answers) < 2 and time.time() < deadline:
        try:
            answers.append(q.get(timeout=max(0.1, deadline - time.time())))
        except queue.Empty:
            break
    for p in procs:
        p.join(timeout=10)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    ok = len(answers) == 2 and all(a[1] == "ok" for a in answers)
    row = dict(phase="parallel", run="D0_nccl_two_ranks_one_card",
               nccl_two_ranks_one_card="accepted" if ok else "refused",
               answers=[a[1][-400:] for a in answers], killed=len(hung),
               backend="nccl" if ok else "gloo")
    emit(row)
    return row


def d_grad_errors(got: dict, want: dict) -> dict:
    check(got.keys() == want.keys(), "(D) gradients of other parameters than the one-rank run's")
    total = torch.sqrt(sum(w.double().square().sum() for w in want.values())).item()
    return {n: rel_l2(got[n].double(), want[n].double(), GRAD_FLOOR * total) for n in want}


_D_RANK_KEYS = ("host_ms_per_step_last_epoch", "profiled_host_ms_per_step", "device_ms_per_step",
                "collective_device_share", "collective_host_share", "staged_bytes_per_step",
                "peak_mib", "opt_state_bytes", "fit_bucket_bytes", "fit_bucket_seconds",
                "run_seconds", "profiler_error")


def d_compare(job: dict, ranks: list, one, out_dir: str, card: str, kernels,
              dev: str = "cuda") -> dict:
    """Hold a run on ``len(ranks)`` ranks against its one-rank reference
    (``one_rank_as``: another job's), or, for ZeRO-1 (``same_as``) and the
    replicated pipeline (``params_as``), against another run's parameters
    after the epochs; its row. ``ranks``: each rank's rows of its group."""
    tag = job["tag"]
    world = len(ranks)
    r0 = ranks[0][tag]
    precision = job["cfg"]["train"].get("precision") or "float32"
    dtype = "bfloat16" if precision in ("bf16", "bfloat16") else "float32"
    limit = D_LIMITS[dtype]
    row = dict(phase="parallel", run=tag, card=card, backend=r0["backend"], world=world,
               mesh=r0["mesh"], dtype=dtype, path=r0["path"],
               steps_per_epoch=r0["steps_per_epoch"], epochs=r0["epochs"],
               train_loss=r0["train_loss"],
               per_rank={k: [ranks[r][tag].get(k) for r in range(world)] for k in _D_RANK_KEYS},
               fit_staged_bytes_per_rank=[ranks[r][tag]["fit_staged_bytes"]
                                          for r in range(world)],
               launches={n: sum(ranks[r][tag]["launches"][n] for r in range(world))
                         for n in kernels})
    check(all(ranks[r][tag]["last_epoch_losses_finite"] for r in range(world)),
          f"{tag}: a step loss is not finite")
    if one is not None:
        row["one_rank"] = {k: one.get(k) for k in ("backend", "path", "train_loss",
                                                   *_D_RANK_KEYS)}
    if job.get("first_step"):
        ref = job.get("one_rank_as", tag)
        got = torch.load(os.path.join(out_dir, f"{tag}_grads_w{world}.pt"))
        want = torch.load(os.path.join(out_dir, f"{ref}_grads_w1.pt"))
        errs = d_grad_errors(got, want)
        worst = max(errs, key=errs.get)
        loss_err = abs(r0["first_step_loss"] - one["first_step_loss"]) / abs(one["first_step_loss"])
        row.update(first_step_limit=limit, first_step_worst=worst,
                   first_step_rel_l2_max=errs[worst],
                   first_step_rel_l2_median=statistics.median(errs.values()),
                   first_step_loss=r0["first_step_loss"],
                   first_step_loss_one_rank=one["first_step_loss"], first_step_loss_rel=loss_err)
        check(errs[worst] <= limit, f"{tag}: first-step gradient of {worst} differs from the "
              f"one-rank step by relative L2 {errs[worst]} (limit {limit})")
        check(loss_err <= limit, f"{tag}: first-step loss {r0['first_step_loss']} against the "
              f"one-rank {one['first_step_loss']}")
    if job.get("forward"):
        got = torch.load(os.path.join(out_dir, f"{tag}_logits_w{world}.pt"))
        want = torch.load(os.path.join(out_dir, f"{tag}_logits_w1.pt"))
        err = rel_l2(got, want, 0.0)
        row.update(pipelined_forward_rel_l2=err, pipelined_forward_limit=limit,
                   stage_forward_busy_share=[ranks[r][tag].get("stage_forward_busy_share")
                                             for r in range(world)],
                   bubble_share_ideal=r0.get("bubble_share_ideal"))
        check(err <= limit, f"{tag}: the pipelined forward differs from the monolithic one by "
              f"relative L2 {err} (limit {limit})")
    b = (torch.load(os.path.join(out_dir, f"{tag}_params_w{world}.pt"))
         if job.get("save_params") else None)
    if job.get("same_as"):
        other = job["same_as"]
        a = torch.load(os.path.join(out_dir, f"{other}_params_w{world}.pt"))
        same = all(torch.equal(a[n], b[n]) for n in a)
        opt = [ranks[r][tag]["opt_state_bytes"] for r in range(world)]
        opt_other = [ranks[r][other]["opt_state_bytes"] for r in range(world)]
        row.update(zero1_params_rel_max=max(rel_l2(b[n].double(), a[n].double(), 1e-30)
                                            for n in a),
                   zero1_bit_equal=same, opt_state_bytes_without_zero1=opt_other,
                   opt_state_bytes_ratio=[x / y for x, y in zip(opt, opt_other)])
        check(same, f"{tag}: ZeRO-1's parameters are not {other}'s bit for bit")
        check(all(x < 0.6 * y for x, y in zip(opt, opt_other)),
              f"{tag}: optimizer bytes a rank {opt} against {opt_other} without ZeRO-1")
    if job.get("params_as"):
        # The replicated layout against the stage-resident run: bit for bit
        # (the same schedule, each layer stepped from the same gradient under
        # the same norm); held at the first-step limit otherwise.
        other = job["params_as"]
        a = torch.load(os.path.join(out_dir, f"{other}_params_w{world}.pt"))
        same = all(torch.equal(a[n], b[n]) for n in a)
        rel = max(rel_l2(b[n].double(), a[n].double(), 1e-30) for n in a)
        row.update(params_bit_equal_to=other, params_bit_equal=same, params_rel_max=rel,
                   params_limit=None if same else limit,
                   peak_mib_beside=[ranks[r][other].get("peak_mib") for r in range(world)],
                   opt_state_bytes_beside=[ranks[r][other]["opt_state_bytes"]
                                           for r in range(world)])
        check(same or rel <= limit, f"{tag}: parameters differ from {other}'s by relative "
              f"L2 {rel} (limit {limit})")
    for name in job.get("kernels", ()) if dev == "cuda" else ():  # the CPU runs plain versions
        check(row["launches"][name] > 0, f"{tag}: {name} was never launched")
    emit(row)
    return row


def d_ring_compare(two: list, out_dir: str, sizes: dict, card: str, dev: str) -> dict:
    """The ring's output and gradients against K1 and K4+K5 on the whole
    sequence (no dropout), and against the plain attention with the
    coordinate-hash mask of the whole (B, H, T, T) probabilities (dropout
    0.1: the ring draws that mask's blocks, as vit_tpu's ring does; K1
    draws another hash). Then one of the ring's block masks (rank 1's
    queries, the second key block) against the whole mask's slice, bit for
    bit."""
    from vit_tpu_torch.ops.dropout import hash_keep_mask
    from vit_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from vit_tpu_torch.ops.ring_attention import _DEFAULT_BLOCK_K, _pick_block

    out = {}
    names = ("o", "dq", "dk", "dv")
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.1):
            q, k, v, g = d_ring_inputs(sizes, dtype, dev)
            b, h, t, d = q.shape
            key = f"{str(dtype).split('.')[-1]}_rate{rate}"
            got = torch.load(os.path.join(out_dir, f"ring_{key}_w2.pt"))
            if rate == 0.0:
                flat = [x.reshape(b * h, t, d).contiguous() for x in (q, k, v, g)]
                o, lse = flash_fwd(*flat[:3], d**-0.5)
                delta = (flat[3].float() * o.float()).sum(-1)
                grads = flash_bwd(*flat[:3], flat[3], lse, delta, d**-0.5)
                want = [x.reshape(b, h, t, d).float().cpu() for x in (o, *grads)]
                against = "K1, K4+K5 (no dropout)"
            else:
                xs = [x.float().clone().requires_grad_(True) for x in (q, k, v)]
                p = torch.softmax(torch.matmul(xs[0] * d**-0.5, xs[1].transpose(-1, -2)), -1)
                o = torch.matmul(p * hash_keep_mask(p.shape, rate, DROPOUT_SEED, device=dev),
                                 xs[2])
                (o * g.float()).sum().backward()
                want = [x.detach().float().cpu() for x in (o, *(x.grad for x in xs))]
                against = "plain attention, the (B, H, T, T) coordinate-hash mask"
                del p, o, xs
            errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
            tols = [FP32_TOL if dtype == torch.float32
                    else min(BF16_TOL, BF16_ROUNDINGS * w.abs().max().item()) for w in want]
            check(all(e <= tl for e, tl in zip(errs, tols)),
                  f"D2 ring {key}: against {against}: {dict(zip(names, errs))} > {tols}")
            out[key] = dict(against=against, max_abs_err=dict(zip(names, errs)),
                            limits=dict(zip(names, tols)),
                            per_rank=[two[r]["D2_ring_op"]["cases"][key] for r in range(2)])
            del got, want
            if dev == "cuda":
                torch.cuda.empty_cache()
    t_local = sizes["ring_t"] // 2
    bk = _pick_block(_DEFAULT_BLOCK_K, t_local)
    block = hash_keep_mask((2, 2, t_local, bk), 0.1, DROPOUT_SEED, offsets=(0, 0, t_local, bk),
                           device=dev)
    whole = hash_keep_mask((2, 2, sizes["ring_t"], sizes["ring_t"]), 0.1, DROPOUT_SEED,
                           device=dev)
    same = torch.equal(block, whole[:, :, t_local:, bk:2 * bk])
    check(same, "D2: the ring's block mask is not the whole mask's slice")
    row = dict(phase="parallel", run="D2_ring_op", card=card,
               backend=two[0]["D2_ring_op"]["backend"], world=2,
               shape=dict(B=sizes["ring_batch"], H=2, T=sizes["ring_t"], d=64),
               block_k=bk, block_mask_bit_equal=same, cases=out)
    emit(row)
    return row


def d_predict_cli(work: str, bundle, n: int, dev: str) -> dict:
    """``python -m vit_tpu_torch predict ... -g n`` in a process of its own,
    over ``bundle``'s weights saved as a ``.pt`` and 8 spectra in a
    ``.npz``: its exit code and the end of its standard error."""
    import numpy as np
    import yaml

    d = os.path.join(work, "predict_cli")
    os.makedirs(d, exist_ok=True)
    cfg_path, pt, inp = (os.path.join(d, f) for f in ("cfg.yaml", "model.pt", "x.npz"))
    with open(cfg_path, "w") as f:
        yaml.safe_dump(d_spectra_config("baseline.yaml"), f)
    torch.save({k: v.cpu() for k, v in bundle.module.state_dict().items()}, pt)
    np.savez(inp, flux=np.random.default_rng(0).standard_normal((8, 4096)).astype(np.float32))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vit_tpu_torch", "predict", "-f", cfg_path,
                           "--ckpt", pt, "--input", inp, "--output", os.path.join(d, "p.npz"),
                           "--batch-size", "8", "-g", str(n), "--device", dev],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    return dict(args=f"predict ... -g {n} --device {dev}", returncode=proc.returncode,
                seconds=time.perf_counter() - t0, stderr_tail=proc.stderr[-400:])


def parallel_runs(work: str, kernels, sizes=None, dev: str = "cuda") -> dict:
    """Run (D): (D0) NCCL with two ranks on one card; the one-rank
    references (NCCL at world size 1, through the same entry points);
    (D1)-(D4) and (D3b) on two ranks sharing the card (gloo, the
    collectives staged through the host, when NCCL refuses), (D3c) and
    (D3d) on four, each held against its reference; (D5) serving (the
    Predictor and ``predict -g 2``) and the sweep on one card. ``dev="cpu"``
    with small ``sizes`` rehearses it on the CPU (gloo throughout)."""
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.opt.parallel_sweep import _replica_devices
    from vit_tpu_torch.serve import Predictor

    sizes = dict(D_SIZES, **(sizes or {}))
    t0 = time.perf_counter()
    card = nvidia_smi("name,power.limit") if dev == "cuda" else "cpu rehearsal"
    out_dir = os.path.join(work, "parallel")
    os.makedirs(out_dir, exist_ok=True)
    probe = d_nccl_probe(dev)
    jobs, jobs4 = d_jobs(sizes), d_jobs4(sizes)
    parts = {}
    t = time.perf_counter()
    one = d_group(1, "nccl" if dev == "cuda" else "gloo",
                  [j for j in jobs + jobs4 if (j.get("first_step") or j.get("forward"))
                   and not j.get("one_rank_as")], out_dir, dev, sizes)[0]
    parts["one_rank_group"] = time.perf_counter() - t
    t = time.perf_counter()
    two = d_group(2, probe["backend"], jobs, out_dir, dev, sizes)
    parts["two_rank_group"] = time.perf_counter() - t
    t = time.perf_counter()
    four = d_group(4, probe["backend"], jobs4, out_dir, dev, sizes)
    parts["four_rank_group"] = time.perf_counter() - t
    runs = {"D0_nccl_two_ranks_one_card": probe}
    for job in jobs:
        if job.get("kind") == "ring_op":
            runs[job["tag"]] = d_ring_compare(two, out_dir, sizes, card, dev)
        else:
            runs[job["tag"]] = d_compare(job, two, one.get(job.get("one_rank_as", job["tag"])),
                                         out_dir, card, kernels, dev)
    for job in jobs4:
        runs[job["tag"]] = d_compare(job, four, one.get(job["tag"]), out_dir, card, kernels, dev)
    # (D5) serving over two devices needs two cards here; the sweep's
    # replicas stay on the one (vit_tpu's _replica_devices(R, 1) = 1).
    bundle = get_model(d_spectra_config("baseline.yaml"))
    n_dev = torch.cuda.device_count() if dev == "cuda" else 1
    try:
        Predictor(bundle.module.to(dev), bundle.vit_config, batch_size=16, num_devices=2)
        raised = None
    except ValueError as e:
        raised = str(e)
    if n_dev < 2:
        check(raised == f"num_devices=2 requested but only {n_dev} devices are available",
              f"D5: Predictor(num_devices=2) on {n_dev} device(s): {raised}")
    cli = d_predict_cli(work, bundle, 2, dev)
    if n_dev < 2:
        check(cli["returncode"] != 0 and f"num_devices=2 requested but only {n_dev} devices are "
              "available" in cli["stderr_tail"], f"D5: predict -g 2 on {n_dev} device(s): {cli}")
    replicas = {r: _replica_devices(r, n_dev) for r in (1, 6, 7)}
    runs["D5_serving_and_sweep"] = dict(phase="parallel", run="D5_serving_and_sweep", card=card,
                                        devices=n_dev, predictor_raised=raised,
                                        predict_cli_g2=cli, replica_devices=replicas)
    emit(runs["D5_serving_and_sweep"])
    emit(dict(phase="run_seconds", run="D (parallelism)", seconds=time.perf_counter() - t0,
              parts=parts))
    return runs


def slice11_runs(work: str, kernels, only=None) -> dict:
    """Runs (v) int8 serving ('z' for --only: 'v' runs (s')), (x) export and
    (y) the repairs; ``only``: the letters to run (all by default). Each
    run's seconds are printed."""
    want = set("zxy") if only is None else set(only)
    runs = {}
    for letter, fn in (("z", lambda: quant_serve_runs(work, kernels)),
                       ("x", lambda: export_runs(work, kernels)),
                       ("y", lambda: repair_runs(work, kernels))):
        if letter in want:
            t0 = time.perf_counter()
            runs.update(fn())
            emit(dict(phase="run_seconds", run=letter, seconds=time.perf_counter() - t0))
    return runs


def graph_and_sweep_runs(work: str, kernels, only=None) -> dict:
    """Runs (w), (p), (q) and (r): the per-step window, the fused epoch as a
    CUDA graph at baseline's and stride1's shapes, and the sequential LR
    sweep; ``only``: the letters to run (all by default). Each run's
    seconds are printed."""
    want = set("wpqr") if only is None else set(only)
    runs = {}
    for letter, fn in (("w", lambda: {"w_stride1_per_step": window_runs(kernels)}),
                       ("p", lambda: graph_runs(kernels)),
                       ("q", lambda: {"q_stride1_graph_bf16": long_graph_run(kernels)}),
                       ("r", lambda: {"r_lr_sweep": sweep_run(work, kernels)})):
        if letter in want:
            t0 = time.perf_counter()
            runs.update(fn())
            emit(dict(phase="run_seconds", run=letter, seconds=time.perf_counter() - t0))
    return runs


def replica_and_image_runs(work: str, none: dict, kernels, only=None) -> dict:
    """Runs (s), (s') ('v') and (u); ``only``: the letters to run (all by
    default). Each run's seconds are printed."""
    want = set("svu") if only is None else set(only)
    runs = {}
    for letter, fn in (("s", lambda: {"s_vmap_sweep": vmap_sweep_run(work, kernels)}),
                       ("v", lambda: seed_vector_runs(work, kernels)),
                       ("u", lambda: image_runs(work, none, kernels))):
        if letter in want:
            t0 = time.perf_counter()
            runs.update(fn())
            emit(dict(phase="run_seconds", run=letter, seconds=time.perf_counter() - t0))
    return runs


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=None,
                        help="letters of runs (j)-(r), (w), (s), (u), 'v' for (s'), 'z' for "
                             "(v) int8 serving, 'x' export, 'y' the repairs, 'M' for (z) "
                             "MoE, 'P' for (P) the offline statistics and 'D' for (D) "
                             "parallelism (with the batch-offset kernel check), to run after "
                             "the build, e.g. 'jkl' or 'pqr' or 'svu' or 'zxy' or 'M' or 'P' "
                             "or 'D', skipping the kernel phases and runs (a)-(i); 'H' adds "
                             "the hash dropout kernel's rows; prints no result")
    args = parser.parse_args(argv)
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    from vit_tpu_torch.ops import _build
    from vit_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_plain, short_fwd, short_fwd_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    max_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_rate = SFU_PER_SM * sms * max_clock_hz
    emit(dict(phase="device", torch=torch.__version__, cuda=torch.version.cuda,
              name=torch.cuda.get_device_name(0), sms=sms, max_sm_clock_hz=max_clock_hz,
              tf32_matmul=False, tf32_cudnn=False))

    seconds, logs = _build.build_all()
    ptxas = {n: ptxas_report(log) for n, log in logs.items()}
    mma = {n: tensor_core_instructions(_build.KERNELS[n].lib_path) for n in TC_NAMESPACE}
    names = demangle({f for per in (*ptxas.values(), *mma.values()) for f in per})
    emit(dict(phase="build", seconds=seconds,
              ptxas={n: {names[f]: r for f, r in per.items()} for n, per in ptxas.items()},
              wgmma_serialized_notes={n: log.count("C7515") for n, log in logs.items()},
              sass_tensor_core_instructions={n: {names[f]: c for f, c in per.items()}
                                             for n, per in mma.items()}))
    check_tensor_cores(mma)
    kernels = _build.KERNELS
    if args.only is not None:  # a partial run for iterating on runs (j)-(r), (w)
        if "H" in args.only:
            hash_dropout_rows(torch.Generator(device="cuda").manual_seed(0), kernels)
        with tempfile.TemporaryDirectory() as work:
            os.environ["CKPT_DIR"] = work
            option_runs(work, {n: 0 for n in kernels}, kernels,
                        only=set(args.only) & set("jklmno"))
            graph_and_sweep_runs(work, kernels, only=set(args.only) & set("wpqr"))
            replica_and_image_runs(work, {n: 0 for n in kernels}, kernels,
                                   only=set(args.only) & set("svu"))
            slice11_runs(work, kernels, only=set(args.only) & set("zxy"))
            if "M" in args.only:
                moe_runs(work, kernels)
            if "P" in args.only:
                offline_runs(work)
            if "D" in args.only:
                offset_check(kernels)
                parallel_runs(work, kernels)
        check(not SITE_MISCOUNTS, f"hash_dropout launches: {'; '.join(SITE_MISCOUNTS)}")
        print("chip_smoke: partial run (--only): no result line", flush=True)
        return 0

    g = torch.Generator(device="cuda").manual_seed(0)
    main_rows = {
        "flash_fwd": attention_case("flash_fwd", flash_fwd, flash_fwd_plain, 16, 2, 4066, 64,
                                    torch.bfloat16, g, sfu_rate, kernels),
        "short_fwd": attention_case("short_fwd", short_fwd, short_fwd_plain, 16, 2, 129, 16,
                                    torch.float32, g, sfu_rate, kernels),
        "fused_mlp_fwd": mlp_case(16 * 4066, 128, 512, torch.bfloat16, g, sfu_rate, kernels),
        "hash_dropout": hash_dropout_rows(g, kernels),
    }
    attention_case("flash_fwd", flash_fwd, flash_fwd_plain, 16, 2, 4066, 64, torch.float32,
                   g, sfu_rate, kernels)
    attention_case("flash_fwd", flash_fwd, flash_fwd_plain, 16, 2, 640, 128, torch.bfloat16,
                   g, sfu_rate, kernels)
    attention_case("short_fwd", short_fwd, short_fwd_plain, 16, 12, 197, 64, torch.bfloat16,
                   g, sfu_rate, kernels)
    mlp_case(1000, 384, 1536, torch.float32, g, sfu_rate, kernels)
    mlp_case(1000, 384, 1536, torch.bfloat16, g, sfu_rate, kernels)
    mlp_case(16 * 129, 32, 128, torch.float32, g, sfu_rate, kernels)  # (e)'s shape
    mlp_case(16 * 129, 32, 128, torch.bfloat16, g, sfu_rate, kernels)  # (f)'s shape
    # The training slice: forward kernels with dropout, then the backward ones.
    attention_case("flash_fwd", flash_fwd, flash_fwd_plain, 16, 2, 4066, 64, torch.bfloat16,
                   g, sfu_rate, kernels, rate=0.1)
    attention_case("short_fwd", short_fwd, short_fwd_plain, 16, 2, 129, 16, torch.float32,
                   g, sfu_rate, kernels, rate=0.1)
    attention_case("short_fwd", short_fwd, short_fwd_plain, 16, 12, 197, 64, torch.bfloat16,
                   g, sfu_rate, kernels, rate=0.1)
    main_rows.update(attention_bwd_case(False, 16, 2, 4066, 64, torch.bfloat16, 0.1, g,
                                        sfu_rate, kernels))
    for dtype, rate in ((torch.bfloat16, 0.0), (torch.float32, 0.1), (torch.float32, 0.0)):
        attention_bwd_case(False, 16, 2, 4066, 64, dtype, rate, g, sfu_rate, kernels)
    main_rows.update(attention_bwd_case(True, 64, 2, 129, 16, torch.float32, 0.1, g, sfu_rate,
                                        kernels))
    attention_bwd_case(True, 16, 2, 129, 16, torch.float32, 0.1, g, sfu_rate, kernels)
    attention_bwd_case(True, 16, 12, 197, 64, torch.bfloat16, 0.1, g, sfu_rate, kernels)
    attention_bwd_case(True, 16, 2, 129, 16, torch.bfloat16, 0.1, g, sfu_rate, kernels)  # (f)'s
    main_rows["fused_mlp_bwd"] = mlp_bwd_case(16 * 4066, 128, 512, torch.bfloat16, g,
                                              sfu_rate, kernels)
    mlp_bwd_case(16 * 129, 32, 128, torch.float32, g, sfu_rate, kernels)  # (e)'s shape
    mlp_bwd_case(16 * 129, 32, 128, torch.bfloat16, g, sfu_rate, kernels)  # (f)'s shape
    mlp_bwd_case(1000, 384, 1536, torch.float32, g, sfu_rate, kernels)
    mlp_bwd_case(1000, 384, 1536, torch.bfloat16, g, sfu_rate, kernels)
    # The image family's shapes (run (u)): ViT-S/16 on 32-pixel images at
    # batch 128 (T 65, d 64; 128 x 65 = 8320 MLP rows).
    attention_case("short_fwd", short_fwd, short_fwd_plain, 128, 6, 65, 64, torch.bfloat16,
                   g, sfu_rate, kernels, rate=0.1)
    attention_bwd_case(True, 128, 6, 65, 64, torch.bfloat16, 0.1, g, sfu_rate, kernels)
    mlp_case(128 * 65, 384, 1536, torch.bfloat16, g, sfu_rate, kernels)
    mlp_bwd_case(128 * 65, 384, 1536, torch.bfloat16, g, sfu_rate, kernels)
    # ViT-B/16 on 224-pixel images at (u)'s cut batch of B16_BATCH (T 197,
    # d 64; B16_BATCH x 197 MLP rows at D768 F3072), then ViT-L/16
    # (vit_l16_multihost.yaml, D1024 F4096) at batch L16_BATCH: K3 and K7 on
    # the wide route.
    attention_case("short_fwd", short_fwd, short_fwd_plain, B16_BATCH, 12, 197, 64,
                   torch.bfloat16, g, sfu_rate, kernels, rate=0.1)
    attention_bwd_case(True, B16_BATCH, 12, 197, 64, torch.bfloat16, 0.1, g, sfu_rate, kernels)
    b16_k3 = mlp_case(B16_BATCH * 197, 768, 3072, torch.bfloat16, g, sfu_rate, kernels)
    b16_k7 = mlp_bwd_case(B16_BATCH * 197, 768, 3072, torch.bfloat16, g, sfu_rate, kernels)
    library_mlp_case(B16_BATCH * 197, 768, 3072, g, kernels, b16_k3, b16_k7)
    mlp_case(L16_BATCH * 197, 1024, 4096, torch.bfloat16, g, sfu_rate, kernels)
    mlp_bwd_case(L16_BATCH * 197, 1024, 4096, torch.bfloat16, g, sfu_rate, kernels)
    rounding_check(g, kernels)
    mask_check(kernels)
    offset_check(kernels)

    none = {n: 0 for n in kernels}
    stride1 = {"model": STRIDE1_MODEL, "train": {"batch_size": BATCH, "precision": "bf16"},
               "data": {"param": "log_g"}, "noise": {"noise_level": 0}}
    baseline = {"model": dict(BASELINE_MODEL, attn_impl="flash"),
                "train": {"batch_size": BATCH}, "data": {"param": "log_g"},
                "noise": {"noise_level": 0}}
    batches = N_INPUTS // BATCH
    calls = STRIDE1_MODEL["num_hidden_layers"] * batches  # one launch per layer and batch
    base_calls = BASELINE_MODEL["num_hidden_layers"] * batches
    # bf16 serving vs the fp32 CPU run: logits of size ~0.05 computed
    # through three bf16 layers (a CPU rehearsal differed by 1.7e-3).
    bf16_serve_tol = 1e-2
    runs = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        os.environ["CKPT_DIR"] = ckpt_dir  # no meta.yaml: stats come from LOGG_STATS
        runs["a_stride1_bf16"] = serve_run(
            "a_stride1_bf16", stride1,
            dict(none, flash_fwd=calls), bf16_serve_tol, BF16_FEATURE_TOL, ckpt_dir, kernels)
        runs["b_stride1_bf16_fused_mlp"] = serve_run(
            "b_stride1_bf16_fused_mlp",
            dict(stride1, model=dict(STRIDE1_MODEL, fused_mlp=True)),
            dict(none, flash_fwd=calls, fused_mlp_fwd=calls), bf16_serve_tol,
            BF16_FEATURE_TOL, ckpt_dir, kernels)
        runs["c_baseline_flash_fp32"] = serve_run(
            "c_baseline_flash_fp32", baseline, dict(none, short_fwd=base_calls), FP32_TOL,
            FP32_TOL, ckpt_dir, kernels)

        # Training: one epoch, BATCH-sized steps and validation batches over
        # the N_INPUTS spectra (train and val splits both read them).
        steps = -(-N_INPUTS // BATCH)
        fwd = STRIDE1_MODEL["num_hidden_layers"] * 2 * steps  # train steps + val batches
        bwd = STRIDE1_MODEL["num_hidden_layers"] * steps
        runs["d_stride1_bf16"] = train_run(
            "d_stride1_bf16", STRIDE1_TRAIN,
            dict(none, flash_fwd=fwd, flash_bwd=bwd), kernels)
        short_fused = dict(none, short_fwd=fwd, short_bwd=bwd, fused_mlp_fwd=fwd,
                           fused_mlp_bwd=bwd)
        runs["e_baseline_flash_fused_fp32"] = train_run(
            "e_baseline_flash_fused_fp32", BASELINE_TRAIN, short_fused, kernels)
        runs["f_baseline_flash_fused_bf16"] = train_run(
            "f_baseline_flash_fused_bf16", BASELINE_BF16_TRAIN, short_fused, kernels)
        # (d) with the fused MLP: remat: mlp runs K3 again in each backward.
        runs["g_stride1_bf16_fused_mlp"] = train_run(
            "g_stride1_bf16_fused_mlp", STRIDE1_FUSED_TRAIN,
            dict(none, flash_fwd=fwd, flash_bwd=bwd,
                 fused_mlp_fwd=fwd + bwd, fused_mlp_bwd=bwd), kernels)

        runs.update(viz_runs(ckpt_dir, none, kernels))
        runs.update(option_runs(ckpt_dir, none, kernels))
        runs.update(graph_and_sweep_runs(ckpt_dir, kernels))
        runs.update(replica_and_image_runs(ckpt_dir, none, kernels))
        runs.update(slice11_runs(ckpt_dir, kernels))
        runs.update(moe_runs(ckpt_dir, kernels))
        runs.update(offline_runs(ckpt_dir))
        runs.update(parallel_runs(ckpt_dir, kernels))
    check(not SITE_MISCOUNTS, f"hash_dropout launches: {'; '.join(SITE_MISCOUNTS)}")

    summary = []
    for name, k in kernels.items():
        row = main_rows[name]
        summary.append(dict(
            name=name, route="cuda", source=os.path.relpath(k.source, os.path.dirname(
                os.path.abspath(__file__))), replaces=k.replaces,
            launches=sum(r["launches"][name] for r in runs.values() if "launches" in r),
            max_abs_err=row["max_abs_err"], ms=row["kernel_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
        ))
    emit(dict(phase="script_seconds", seconds=time.perf_counter() - started))
    emit({"kernels": summary})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
