#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA GPU and check them.

    python3 chip_smoke.py

Twenty-nine paths at full width (s=5, widths 64/128/256; the VAE's latent
512): AE serving, AE training, VAE serving, VAE training, AE and VAE
``Trainer.fit`` with validation, checkpoints and resume, AE and VAE
evaluation of the files written (``--process test``, encode, decode,
``--load_pt``), the AE's and the VAE's explorer server on those files over
HTTP, the standard conv at stride 2 through its own entry point
(``fused_ico_conv_s2s(..., stride=2)`` and its gradient), AE and VAE
training on the merged backward route (``merged_bwd="all"``); AE and VAE
training on the merged blocks (``merged_block="all"``: every UpBlock's
training forward one launch of kernel o, every DownBlock's one of p), the
AE's also with the merged backward and on both chains (o at up0 alone); the encoder's
phase chain (``phase_chain="enc"``: kernel m): AE serving, AE and VAE
training, AE training on the merged route, and AE training with the stats
fold outside the kernels (``kernel_geff=""``, JAX's built-in fold set:
kernel l); both halves chained (``phase_chain="1"``: m and the decoder's
kernel n): AE and VAE serving, AE and VAE training, AE training on the
merged route and with every fold outside (``kernel_geff="0"``); and AE
training on the decoder's chain alone (``phase_chain="dec"``). Then the
subdivision-6/7 stretch config and data parallelism: AE training at s=6
and s=7 (bs36, full width), at s=6 also on the decoder's chain, both
chains, the merged backward, the merged blocks and the VAE; and AE and VAE
training over two data-parallel ranks that the script starts. Phases, each
printed on its own lines, each fatal on failure:

1. card: ``nvidia-smi`` name and power limit;
2. build: compile ``geniconet_tpu_torch/csrc/*.cu`` (sm_90a; one nvcc per
   source, all started together, then one link);
3. kernel vs plain, serving: each of the four forward kernels against its
   plain PyTorch version at the shapes the AE and VAE serving paths give it
   (B=16; the head also at a B=1 decode), in float32 (TF32 off) and
   bfloat16, with the error against the stated tolerance and the median
   CUDA-event time of both;
4. kernel vs plain, training: the forward kernels' BatchNorm stats and the
   nine backward and loss kernels (phase-conv, up-conv and standard-conv
   dx and dtaps, with the stats fold; the head's forward and backward; the
   head+MSE forward and backward) at the shapes of AE and VAE training at B=36
   (the DownBlocks' and the VAE heads' stride-2 convs with and without an
   act prologue), the same way; and the standard conv at stride 2 (group
   "std s2": its forward at B=16 and, with stats, at B=36 with and without
   the act, its dx, dtaps and merged backward k with the fold in the
   kernels and outside, at the DownBlocks' stride-2 shapes; in bf16 its
   forward must equal the phase conv's at output phase 2 on the input's
   parity phases and k f's split pair, bit for bit); then the path "std s2
   train (op)": that op's forward and gradient on the split route, k and
   the fold outside, float32 against the plain route's autograd. Every case also prints its bound (the
   least time the card could take: bytes over 3.35 TB/s or FLOPs over the
   peak for the dtype, whichever is larger) and, for the convs, the time of
   the one cuDNN call that does the same contraction on an input already
   haloed (upsampled, for the up conv), which the port never calls. The
   three merged backward kernels (i, j, k) also print the time of the
   split pair they replace at the same shape (its dx call, with the Σg
   pass, and its dtaps call, each timed alone: they run the merged
   kernel's two tile roles on their own) and cuDNN's dx + dweight (in
   bf16 i's seven outputs and j's and k's five must equal the split
   pair's bit for bit, m's forward the phase conv's at output phase 2
   followed by ``phase_split``, outputs and stats, and m's dx and dtaps the
   phase conv's on the merged cotangents; i, j, k and m's forward and dx
   print their parts and device time, i, j and k beside the split pair's
   kernels, m's forward beside b's forward at phase 2 on the same phases,
   m's dx beside a's call); kernel
   m (``ds2s_*``) at the chain's DownBlock shapes and l (``stats_geff``)
   at each group it folds on the chain, with the phase conv's kernels at
   the chain's conv01 shapes; l at down0 also prints what the fold costs
   inside m's dx + dtaps (those two with and without it). l's time comes
   from a ``torch.profiler`` trace: CUDA events around a call that short
   measure its wrapper's host time; n (``up_pair_*``) at up1 and up2, its
   forward at the serving and the training batch, its dx and dtaps with
   the fold in the kernels and without; o (``up_block_fwd``) and p
   (``dn_block_fwd``) at every block they run at, each beside the split
   pair it replaces (the first conv with stats; bn00's affine and conv01
   with stats) and cuDNN's two contractions; in bf16 each of their eight
   outputs must equal the split route's bit for bit, and they print their
   cooperative kernel's device time beside the split pair's kernels', its
   registers and blocks an SM; the head's training kernels (g, h, e) also
   at a head of 320 channels. The bf16 forward of the up
   conv and of n (serving and training shapes), their dtaps (d, n's),
   the grid convs' forward and dtaps (b, f; a C_in of at most 64 on the
   dtaps' NARROW tile) and the phase conv's, up conv's, standard conv's
   and n's dx (a, c, f, n) also print their parts from a trace: the
   operand pass (a's, c's, f's and n's: the folded cotangent with its
   combined rows) against its byte bound, the tap pack, the tensor-core
   GEMM's TFLOP/s, the sums, c's upsample adjoint pass and n's pair adjoint
   pass against their byte bound, and the
   GEMM's registers and blocks an SM; the pair head's forwards (the
   head's, g) and backwards (e, h) print their main pass's achieved GB/s
   against its byte bound, g's and h's pole pass and the backwards'
   partial rows' sum;
4b. s6/s7 kernels (``s67_kernels``, ``batch_split_check``): the host-built
   halo tables of levels 6 and 7 (build time, MiB), then every kernel at
   its s=6 and s=7 shapes (the serving and training cases at B=2, the s=5
   shapes scaled; not the stride-2 standard conv nor the 320-channel head)
   against its plain version within ``TOL`` in float32 and bf16, the bf16
   merged kernels and m also bit for bit against the split route, timed
   in bf16; and at s=7, B=56 the grid convs' and the up conv's bf16
   forward and dx at conv_in, up2 conv01 and up2 (71,680 GEMM row tiles,
   past ``gridDim.y``'s 65,535): each half of the batch's outputs must
   equal the B=28 call on that half bit for bit;
5. serving: ``AppState.load`` of an AE and of a VAE on 32 synthetic meshes
   with seeded random weights (non-trivial BN statistics), then
   ``handle_api`` requests (the VAE's ``/api/regenerate`` too), in bfloat16
   and float32; every mesh must have 10,242 finite vertices, every serving
   kernel must have launched on each path, and two float32 decodes must
   match the same model run through the plain route on the CPU; then the
   AE on the encoder's chain, whose latent cache must match the unchained
   one, and the AE and the VAE on both chains, whose latent caches and
   decodes must;
6. timings: p50 single-mesh decode latency and encode+decode meshes/s at B=16;
7. training: the AE ``Trainer`` and the VAE ``Trainer`` (the default
   routing, every block on the kernels; the AE's loss from the head+MSE
   kernel, the VAE's from the head kernel and the P2P+KLD loss), each on
   the default backward route, the merged one (``merged_bwd="all"``), the
   phase chains and the merged blocks (``TRAIN_ROUTES``), take 6 Adam steps each at B=36 on
   64 synthetic meshes, in bfloat16 and float32; every loss must be finite,
   every kernel of each path must have launched and none that the path
   must not run (``PATH_FORBIDDEN``), n twice and the up conv once a
   forward on the decoder's chain, o and p once a block and forward on the
   merged blocks (``BLOCKS_PER_FORWARD``), and training meshes/s is the median of
   the last 4 steps; then one float32 step of each model and routing at B=4 (the
   VAE's eps fixed) must match the same step on the CPU's plain route of
   the same chain setting (loss, every gradient, the new BatchNorm
   statistics), and each check must catch a 1% error planted in one kernel
   output at a time; then whole training steps of each model's routings
   (the AE's also ``pallas_blocks="up0,up1,up2"``, encoder and head on
   cuDNN), in turns at B=36 bfloat16, side by side (default, enc, dec,
   both chains, merged blocks, ...);
8. fit: for the AE and the VAE on the default route at B=36 bfloat16,
   ``Trainer.fit`` for 3 epochs of the 64 training meshes (the last batch
   ragged) with validation on 16 more, in a temporary log directory: the
   checkpoints written must be exactly the EB and E files the JAX
   package's rules give for the printed validation history; ``restore`` of
   the newest E file into a fresh Trainer must equal the in-memory weights,
   BatchNorm statistics, Adam state, epoch and best loss bit for bit, and
   one step of each on the same batch must give bit-equal metrics; the
   command line (``cli.main``) resumes from that file for one more epoch
   on the meshes written as .npz files; ``AppState.load(epoch=0)`` of the
   newest EB file must give the latent cache and a B=1 decode of the same
   weights loaded from memory bit for bit, and ``/api/load`` and
   ``/api/epochs`` must list the files written. It prints each epoch's wall
   time and training meshes/s (the log cadence's host syncs included),
   ``validate``'s time, the checkpoint's bytes, ``save_checkpoint``'s and
   ``load_checkpoint``'s ms and ``AppState.load``'s seconds; the launches of
   each ``fit`` join the paths as "AE train (fit)" and "VAE train (fit)";
   then eval, on those files and the 16 validation meshes: ``cli.main``'s
   ``--process test`` (``--write_output_mesh``), encode and decode, and for
   the AE ``--load_pt`` of a seeded reference-shaped ``.pt`` then test; every
   CSV must hold one finite row a mesh and decode(encode(x)) test's
   distances; the AE's point-to-mesh distance on the card must agree with
   the float64 numpy oracle and the native C++, and its float32 kernel
   route on 2 meshes with the float32 plain route on the CPU; it prints the
   processes' wall times, the distance's ms a mesh and peak memory; the
   processes' launches join the paths as "AE serve (eval)" and "VAE serve
   (eval)"; then explorer, on the same files: the port's HTTP server
   (``app/server.py``) in a thread on 127.0.0.1 with its state on the
   card, over HTTP /api/load, /api/pca, /api/pca_decode, /api/pairs,
   /api/arithmetic with its nearest neighbour, /api/viewpoint, /api/export
   (.off and figure), /api/view_file of the export, GET / and a gzip
   /api/mesh; every mesh checked, each route's wall printed, the launches
   joining the paths "AE serve (explorer)" and "VAE serve (explorer)";
8b. s6/s7 train (``s67_train``): the AE at s=6 and s=7, bs36 bf16, full
   width, default route, from seeded weights on 36 meshes (4 distinct; the
   targets computed on the card): 3 Adam steps with finite losses, the
   step time, one step's device busy time and the peak memory; at s=6 the
   first step's loss within 1e-2 of the plain route's (``pallas_blocks=
   "none"``), then one step each on the decoder's chain, both chains, the
   merged backward, the merged blocks, and of the VAE; each path must
   launch its kernels (paths "AE train (s6)", "AE train (s7)", "AE train
   (s6, chain dec)", ..., "VAE train (s6)");
8c. dp (``dp_phase``): two ranks spawned by the script (``parallel/
   dist.py``: one card each over NCCL where there are two, else both on
   the one card over gloo; the phase prints which), each running two
   float32 AE steps at s=5 and global bs36 on the kernel route and its
   eval, which must match one process at bs36 (loss and eval to rtol 2e-6,
   parameters and BatchNorm statistics to rtol 1e-4 / atol 1e-6) with
   every rank's state bit-equal, then an s=6 bf16 AE step and a VAE bf16
   step with finite losses; a rank's failure fails the phase (paths "AE
   train (dp)", "VAE train (dp)");
9. profile: where the device time goes in the timed serving workloads and
   in AE and VAE training steps on every training path (bfloat16), read
   from a ``torch.profiler``
   trace, with the device's idle share; every bf16 call of the grid
   convs' forward and dtaps (b, f, m's forward and dtaps) and of a's,
   c's, f's and m's dx must show its operand pass and tensor-core GEMM
   there (c also its upsample adjoint; i, j and k their two passes and
   their one launch of both GEMMs, j its adjoint), and no window the SIMT
   ``dx_gemm<bf16>``, ``conv_gemm<bf16, GridLoad>``, ``dtaps_gemm<bf16,
   GridLoad>`` (m's split forward, dx and dtaps too) or the merged tiles
   ``merged_bwd<bf16, UpLoad>`` (j) and ``merged_bwd<bf16, GridLoad>``
   (k); the Chrome traces are kept in ``build/profile/``.

The line before the last is ``{"kernels": [...]}``, with each kernel's
route, sources, the TPU kernel it replaces, how it was redesigned for the
card (``redesigned``; null: it runs its first SIMT port), its launches on
the serving and training paths (AE and VAE summed, and per path), its
bf16 time, its plain version's, its bound and the library
call's, summed over its shapes (a forward kernel's times are its serving
shapes', and ``training_shapes`` holds those of its training shapes;
``by_shapes`` splits each sum into the AE's shapes, the standard conv's
stride-2 shapes, the no-act stride-2 shapes, the VAE's new shapes, the
chains' and the wide head's), and ``s6`` and ``s7``: its largest error,
cases and bf16 kernel, plain and bound times summed over its s=6 and s=7
shapes at B=2; the last is ``{"ok": true, "device": {...}}``. Without a
CUDA device the script exits with an error before printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import re
import statistics
import subprocess
import time
from pathlib import Path

import torch

SUBDIVISIONS = 5
WIDTHS = (64, 128, 256)
LATENT = 512  # the VAE's latent_features
BATCH = 16
N_MESHES = 32
TRAIN_BATCH = 36
TRAIN_MESHES = 64
TRAIN_STEPS, TRAIN_WARMUP = 6, 2
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # times each output's max|ref|
TOL_WHY = {
    torch.float32: "only the order of the float32 sums differs",
    torch.bfloat16: "float32 sums round to bf16 at different points",
}
# Published dense peaks of one H100 SXM (NVIDIA's data sheet): bf16 on the
# tensor cores, float32 on the CUDA cores, device memory bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
_ALL = (0, 1, 2, 3)
KERNELS = {
    "phase_conv_fwd": ("geniconet_tpu_torch/csrc/phase_conv.cu",
                       "geniconet_tpu/ops/pallas/phase_kernel.py:1272"),
    "up_dual_conv_fwd": ("geniconet_tpu_torch/csrc/up_conv.cu",
                         "geniconet_tpu/ops/pallas/phase_kernel.py:1999"),
    "pair_head_fwd": ("geniconet_tpu_torch/csrc/pair_head.cu",
                      "geniconet_tpu/ops/pallas/phase_kernel.py:3241"),
    "ico_conv_s2s_fwd": ("geniconet_tpu_torch/csrc/phase_conv.cu",
                         "geniconet_tpu/ops/pallas/conv_kernel.py:253"),
    "phase_conv_dx": ("geniconet_tpu_torch/csrc/phase_conv_bwd.cu",
                      "geniconet_tpu/ops/pallas/phase_kernel.py:1336"),
    "phase_conv_dtaps": ("geniconet_tpu_torch/csrc/phase_conv_bwd.cu",
                         "geniconet_tpu/ops/pallas/phase_kernel.py:1406"),
    "up_dual_conv_dx": ("geniconet_tpu_torch/csrc/up_conv_bwd.cu",
                        "geniconet_tpu/ops/pallas/phase_kernel.py:2123"),
    "up_dual_conv_dtaps": ("geniconet_tpu_torch/csrc/up_conv_bwd.cu",
                           "geniconet_tpu/ops/pallas/phase_kernel.py:2150"),
    "ico_conv_s2s_dx": ("geniconet_tpu_torch/csrc/ico_conv_bwd.cu",
                        "geniconet_tpu/ops/pallas/conv_kernel.py:727"),
    "ico_conv_s2s_dtaps": ("geniconet_tpu_torch/csrc/ico_conv_bwd.cu",
                           "geniconet_tpu/ops/pallas/conv_kernel.py:665"),
    "pair_head_mse_fwd": ("geniconet_tpu_torch/csrc/pair_head.cu",
                          "geniconet_tpu/ops/pallas/phase_kernel.py:3528"),
    "pair_head_mse_bwd": ("geniconet_tpu_torch/csrc/pair_head.cu",
                          "geniconet_tpu/ops/pallas/phase_kernel.py:3577"),
    "pair_head_bwd": ("geniconet_tpu_torch/csrc/pair_head.cu",
                      "geniconet_tpu/ops/pallas/phase_kernel.py:3287"),
    "phase_conv_bwd": ("geniconet_tpu_torch/csrc/phase_conv_bwd.cu",
                       "geniconet_tpu/ops/pallas/phase_kernel.py:932"),
    "up_dual_conv_bwd": ("geniconet_tpu_torch/csrc/up_conv_bwd.cu",
                         "geniconet_tpu/ops/pallas/phase_kernel.py:2068"),
    "ico_conv_s2s_bwd": ("geniconet_tpu_torch/csrc/ico_conv_bwd.cu",
                         "geniconet_tpu/ops/pallas/conv_kernel.py:601"),
    "stats_geff": ("geniconet_tpu_torch/csrc/stats_geff.cu",
                   "geniconet_tpu/ops/pallas/phase_kernel.py:1462"),
    "ds2s_fwd": ("geniconet_tpu_torch/csrc/ds2s.cu",
                 "geniconet_tpu/ops/pallas/phase_kernel.py:1818"),
    "ds2s_dx": ("geniconet_tpu_torch/csrc/ds2s.cu",
                "geniconet_tpu/ops/pallas/phase_kernel.py:1895"),
    "ds2s_dtaps": ("geniconet_tpu_torch/csrc/ds2s.cu",
                   "geniconet_tpu/ops/pallas/phase_kernel.py:1936"),
    "up_pair_fwd": ("geniconet_tpu_torch/csrc/up_pair.cu",
                    "geniconet_tpu/ops/pallas/phase_kernel.py:2380"),
    "up_pair_dx": ("geniconet_tpu_torch/csrc/up_pair.cu",
                   "geniconet_tpu/ops/pallas/phase_kernel.py:2458"),
    "up_pair_dtaps": ("geniconet_tpu_torch/csrc/up_pair.cu",
                      "geniconet_tpu/ops/pallas/phase_kernel.py:2490"),
    "up_block_fwd": ("geniconet_tpu_torch/csrc/up_block.cu",
                     "geniconet_tpu/ops/pallas/phase_kernel.py:2718"),
    "dn_block_fwd": ("geniconet_tpu_torch/csrc/dn_block.cu",
                     "geniconet_tpu/ops/pallas/phase_kernel.py:2994"),
}
# sources beyond the one named in KERNELS: in bf16 the up conv's, n's and
# the grid convs' forward and dtaps (the grid convs' dtaps: b, f, m's; m's
# forward), the phase conv's, the up conv's, the standard conv's and m's dx
# (a, c, f, m), the merged backwards (i, j, k; one launch of both GEMMs,
# csrc/mma_merged_bwd.cuh) and the merged blocks (o, p) run an operand pass
# of csrc/mma.cuh and the tensor-core GEMMs of csrc/mma_conv_fwd.cuh and
# csrc/mma_dtaps.cuh
_MMA = "geniconet_tpu_torch/csrc/mma.cuh"
SOURCES = {**{k: ("geniconet_tpu_torch/csrc/mma_dtaps.cuh", _MMA)
              for k in ("up_dual_conv_dtaps", "up_pair_dtaps", "phase_conv_dtaps",
                        "ico_conv_s2s_dtaps", "ds2s_dtaps")},
           **{k: ("geniconet_tpu_torch/csrc/mma_merged_bwd.cuh",
                  "geniconet_tpu_torch/csrc/mma_dtaps.cuh",
                  "geniconet_tpu_torch/csrc/mma_conv_fwd.cuh", _MMA)
              for k in ("up_dual_conv_bwd", "phase_conv_bwd", "ico_conv_s2s_bwd")},
           **{k: ("geniconet_tpu_torch/csrc/mma_conv_fwd.cuh", _MMA)
              for k in ("up_dual_conv_fwd", "up_pair_fwd", "phase_conv_fwd",
                        "ico_conv_s2s_fwd", "phase_conv_dx", "up_dual_conv_dx",
                        "ico_conv_s2s_dx", "ds2s_fwd", "ds2s_dx", "up_pair_dx")},
           # o and p: float32 block_fwd.cuh's SIMT tiles; bf16 the split
           # route's tensor-core passes in one cooperative launch
           **{k: ("geniconet_tpu_torch/csrc/mma_block_fwd.cuh",
                  "geniconet_tpu_torch/csrc/block_fwd.cuh",
                  "geniconet_tpu_torch/csrc/mma_conv_fwd.cuh", _MMA)
              for k in ("up_block_fwd", "dn_block_fwd")}}
# how each kernel was redesigned for the card since its first SIMT port
# (None: it still runs that port's float32 SIMT core in both dtypes)
_TC = "bf16 on the tensor cores: "
REDESIGNED = {
    "phase_conv_fwd": _TC + "the operand pass and mma_conv with the stats epilogue",
    "up_dual_conv_fwd": _TC + "the upsampled operand pass and mma_conv",
    "pair_head_fwd": "the lane-group cell routine of the head's backward",
    "ico_conv_s2s_fwd": _TC + "the operand pass and mma_conv with the stats epilogue",
    "phase_conv_dx": _TC + "the cotangent pass and mma_conv with the act-adjoint epilogue",
    "phase_conv_dtaps": _TC + "the operand pass and mma_dtaps",
    "up_dual_conv_dx": _TC + "the cotangent pass, mma_conv into dU, the upsample adjoint",
    "up_dual_conv_dtaps": _TC + "the upsampled operand pass and mma_dtaps",
    "ico_conv_s2s_dx": _TC + "the cotangent pass and mma_conv over the standard table",
    "ico_conv_s2s_dtaps": _TC + "the operand pass and mma_dtaps",
    "pair_head_mse_fwd": "the lane-group cell routine, one partial a 64 cells",
    "pair_head_mse_bwd": "one coalesced read a cell (head_bwd_body)",
    "pair_head_bwd": "one coalesced read a cell (head_bwd_body)",
    "phase_conv_bwd": _TC + "a's cotangent pass and b's operand pass, both GEMMs in one launch",
    "up_dual_conv_bwd": _TC + "c's cotangent pass and d's operand pass, both GEMMs in one launch",
    "ico_conv_s2s_bwd": _TC + "f's cotangent pass and operand pass, both GEMMs in one launch",
    "stats_geff": None,
    "ds2s_fwd": _TC + "the operand pass and mma_conv with the split store in its epilogue",
    "ds2s_dx": _TC + "a's cotangent pass over the parity phases and a's dx GEMM",
    "ds2s_dtaps": _TC + "b's operand pass and mma_dtaps over the parity phases",
    "up_pair_fwd": _TC + "the joined pair's operand pass and mma_conv",
    "up_pair_dx": _TC + "c's cotangent pass and mma_conv into dU, the pair tail in the adjoint pass",
    "up_pair_dtaps": _TC + "the joined pair's operand pass and mma_dtaps",
    "up_block_fwd": _TC + "the split route's passes and GEMM in one cooperative launch",
    "dn_block_fwd": _TC + "the split route's passes and GEMM in one cooperative launch",
}
_FORWARD = ("phase_conv_fwd", "up_dual_conv_fwd", "pair_head_fwd", "ico_conv_s2s_fwd")
_BACKWARD = ("phase_conv_dx", "phase_conv_dtaps", "up_dual_conv_dx", "up_dual_conv_dtaps",
             "ico_conv_s2s_dx", "ico_conv_s2s_dtaps")
# the merged route: i, j, k, and conv_in's dtaps (it has no input cotangent)
_MERGED = ("phase_conv_bwd", "up_dual_conv_bwd", "ico_conv_s2s_bwd", "phase_conv_dtaps")
_AE_HEAD = ("pair_head_mse_fwd", "pair_head_mse_bwd")
# the phase chain: m in place of the DownBlocks' stride-2 phase conv and
# standard conv01 (conv01 runs as the phase conv); l with the fold outside
_STD = ("ico_conv_s2s_fwd", "ico_conv_s2s_dx", "ico_conv_s2s_dtaps", "ico_conv_s2s_bwd")
_CHAIN = ("ds2s_fwd", "ds2s_dx", "ds2s_dtaps")
_CHAIN_FWD = ("phase_conv_fwd", "ds2s_fwd", "up_dual_conv_fwd")
_CHAIN_SPLIT = (*_CHAIN[1:], "phase_conv_dx", "phase_conv_dtaps", "up_dual_conv_dx",
                "up_dual_conv_dtaps")
_N = ("up_pair_fwd", "up_pair_dx", "up_pair_dtaps")
_N_BWD = _N[1:]
# the merged blocks: o and p in place of the up conv's and the standard
# conv's forward (and of the phase conv's, but at conv_in and the VAE's heads)
_BLOCKS = ("up_block_fwd", "dn_block_fwd")
_SPLIT_FWD = ("up_dual_conv_fwd", "ico_conv_s2s_fwd")
# the kernels each path must launch: the AE's training loss runs the
# head+MSE pair (g, h), the VAE's the head and its backward (e)
PATH_KERNELS = {
    "AE serve": _FORWARD,
    "AE train": (*(k for k in _FORWARD if k != "pair_head_fwd"), *_BACKWARD, *_AE_HEAD),
    "AE train (merged)": (*(k for k in _FORWARD if k != "pair_head_fwd"), *_MERGED, *_AE_HEAD),
    # Trainer.fit (train_epoch, validate) on the default route
    "AE train (fit)": (*(k for k in _FORWARD if k != "pair_head_fwd"), *_BACKWARD, *_AE_HEAD),
    "VAE train (fit)": (*_FORWARD, *_BACKWARD, "pair_head_bwd"),
    # the evaluation on [fit]'s files: --process test, encode, decode (the AE
    # also --load_pt + test), eval mode on the default route
    "AE serve (eval)": _FORWARD,
    "VAE serve (eval)": _FORWARD,
    # the explorer's HTTP server on [fit]'s files (load, PCA, decodes, export)
    "AE serve (explorer)": _FORWARD,
    "VAE serve (explorer)": _FORWARD,
    # the standard conv at stride 2 through fused_ico_conv_s2s(..., stride=2)
    # and its gradient, the split and the merged backward
    "std s2 train (op)": (*_STD, "stats_geff"),  # l: the route with the fold outside
    "VAE serve": _FORWARD,
    "VAE train": (*_FORWARD, *_BACKWARD, "pair_head_bwd"),
    "VAE train (merged)": (*_FORWARD, *_MERGED, "pair_head_bwd"),
    "AE serve (chain)": (*_CHAIN_FWD, "pair_head_fwd"),
    "AE train (chain)": (*_CHAIN_FWD, *_CHAIN_SPLIT, *_AE_HEAD),
    "VAE train (chain)": (*_CHAIN_FWD, *_CHAIN_SPLIT, "pair_head_fwd", "pair_head_bwd"),
    "AE train (chain, merged)": (*_CHAIN_FWD, *_CHAIN[1:], *_MERGED[:2], "phase_conv_dtaps",
                                 *_AE_HEAD),
    "AE train (chain, fold outside)": (*_CHAIN_FWD, *_CHAIN_SPLIT, "stats_geff", *_AE_HEAD),
    # both chains: n at up1 and up2 (up0 keeps the up conv, which reads the latent grid)
    "AE serve (chain all)": (*_CHAIN_FWD, "up_pair_fwd", "pair_head_fwd"),
    "VAE serve (chain all)": (*_CHAIN_FWD, "up_pair_fwd", "pair_head_fwd"),
    "AE train (chain all)": (*_CHAIN_FWD, "up_pair_fwd", *_CHAIN_SPLIT, *_N_BWD, *_AE_HEAD),
    "VAE train (chain all)": (*_CHAIN_FWD, "up_pair_fwd", *_CHAIN_SPLIT, *_N_BWD,
                              "pair_head_fwd", "pair_head_bwd"),
    "AE train (chain all, merged)": (*_CHAIN_FWD, "up_pair_fwd", *_CHAIN[1:], *_MERGED[:2],
                                     "phase_conv_dtaps", *_N_BWD, *_AE_HEAD),
    "AE train (chain all, fold outside)": (*_CHAIN_FWD, "up_pair_fwd", *_CHAIN_SPLIT, *_N_BWD,
                                           "stats_geff", *_AE_HEAD),
    "AE train (chain dec)": (*(k for k in _FORWARD if k != "pair_head_fwd"), "up_pair_fwd",
                             *_BACKWARD, *_N_BWD, *_AE_HEAD),
    "AE train (merged block)": ("phase_conv_fwd", *_BLOCKS, *_BACKWARD, *_AE_HEAD),
    "VAE train (merged block)": ("phase_conv_fwd", "pair_head_fwd", *_BLOCKS, *_BACKWARD,
                                 "pair_head_bwd"),
    "AE train (merged block, merged)": ("phase_conv_fwd", *_BLOCKS, *_MERGED, *_AE_HEAD),
    # both chains: o at up0 (the latent grid), n at up1-2, m at the DownBlocks
    "AE train (chain all, merged block)": ("phase_conv_fwd", "ds2s_fwd", "up_block_fwd",
                                           "up_pair_fwd", *_CHAIN_SPLIT, *_N_BWD, *_AE_HEAD),
}
# ... and the kernels it must not launch: each backward route runs none of
# the other's conv backward kernels, the default paths neither l nor m, the
# encoder's chain none of the standard conv's, no path without the
# decoder's chain n, and the decoder's chain no merged up conv at up1-2
_SPLIT_ONLY = tuple(k for k in _BACKWARD if k != "phase_conv_dtaps")
_NEW = ("stats_geff", *_CHAIN, *_N)
PATH_FORBIDDEN = {
    "AE serve": _NEW, "VAE serve": _NEW,
    "AE train": (*_MERGED[:3], *_NEW), "VAE train": (*_MERGED[:3], *_NEW),
    "AE train (fit)": (*_MERGED[:3], *_NEW), "VAE train (fit)": (*_MERGED[:3], *_NEW),
    "AE serve (eval)": _NEW, "VAE serve (eval)": _NEW,
    "AE serve (explorer)": _NEW, "VAE serve (explorer)": _NEW,
    "std s2 train (op)": ("phase_conv_fwd", *_BACKWARD[:4], *_MERGED[:2], "up_dual_conv_fwd",
                          "pair_head_fwd", *_AE_HEAD, "pair_head_bwd", *_CHAIN, *_N),
    "AE train (merged)": (*_SPLIT_ONLY, *_NEW), "VAE train (merged)": (*_SPLIT_ONLY, *_NEW),
    "AE serve (chain)": (*_STD, *_N),
    "AE train (chain)": (*_STD, *_MERGED[:2], "stats_geff", *_N),
    "VAE train (chain)": (*_STD, *_MERGED[:2], "stats_geff", *_N),
    "AE train (chain, merged)": (*_STD, *_SPLIT_ONLY, "stats_geff", *_N),
    "AE train (chain, fold outside)": (*_STD, *_MERGED[:2], *_N),
    "AE serve (chain all)": _STD, "VAE serve (chain all)": _STD,
    "AE train (chain all)": (*_STD, *_MERGED[:2], "stats_geff"),
    "VAE train (chain all)": (*_STD, *_MERGED[:2], "stats_geff"),
    "AE train (chain all, merged)": (*_STD, *_SPLIT_ONLY, "stats_geff"),
    "AE train (chain all, fold outside)": (*_STD, *_MERGED[:2]),
    "AE train (chain dec)": (*_MERGED[:3], *_NEW[:4]),
    "AE train (merged block)": (*_SPLIT_FWD, *_MERGED[:3], *_NEW),
    "VAE train (merged block)": (*_SPLIT_FWD, *_MERGED[:3], *_NEW),
    "AE train (merged block, merged)": (*_SPLIT_FWD, *_SPLIT_ONLY, *_NEW),
    "AE train (chain all, merged block)": (*_STD, *_MERGED[:2], "stats_geff", "up_dual_conv_fwd",
                                           "dn_block_fwd"),
}
# no other path runs o or p (eval never merges)
PATH_FORBIDDEN = {path: (*ks, *(() if "merged block" in path else _BLOCKS))
                  for path, ks in PATH_FORBIDDEN.items()}
# (o, p) launches a forward on the merged-block paths
BLOCKS_PER_FORWARD = {"AE train (merged block)": (3, 3), "VAE train (merged block)": (3, 2),
                      "AE train (merged block, merged)": (3, 3),
                      "AE train (chain all, merged block)": (1, 0)}
# the training routings, by path: (merged_bwd, phase_chain, kernel_geff, merged_block)
ROUTES = {
    "": (None, None, None, None),
    " (merged)": ("all", None, None, None),
    " (chain)": (None, "enc", None, None),
    " (chain, merged)": ("all", "enc", None, None),
    " (chain, fold outside)": (None, "enc", "", None),
    " (chain all)": (None, "1", None, None),
    " (chain all, merged)": ("all", "1", None, None),
    " (chain all, fold outside)": (None, "1", "0", None),
    " (chain dec)": (None, "dec", None, None),
    " (merged block)": (None, None, None, "all"),
    " (merged block, merged)": ("all", None, None, "all"),
    " (chain all, merged block)": (None, "1", None, "all"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def trace_kernels(fn, reps: int = 20, per_launch: bool = False) -> dict:
    """Device time per call of fn()'s kernels in ms, by ``kernel_group`` row:
    their durations in a torch.profiler trace. ``per_launch``: fn launches
    each of its kernels once, and a row sums each kernel's mean duration,
    which stays right when the trace loses events (seen on the card). A trace
    that holds no kernel at all (also seen there) is taken again, up to three
    times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = Path(__file__).resolve().parent / "build" / "profile" / "kernel_case.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    durs = collections.defaultdict(list)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(out))
        for e in json.loads(out.read_text())["traceEvents"]:
            if e.get("cat") == "kernel":
                durs[e["name"]].append(e["dur"] / 1e3)
        if durs:
            break
    rows = collections.Counter()
    for name, ds in durs.items():
        rows[kernel_group({"cat": "kernel", "name": name})] += (
            statistics.mean(ds) if per_launch else sum(ds) / reps)
    return dict(rows)


def trace_ms(fn, reps: int = 20) -> float:
    """Device time of fn() in ms from a trace (``trace_kernels``). For a
    kernel shorter than its wrapper's host time, where CUDA events around
    one call measure the host."""
    return sum(trace_kernels(fn, reps).values())


def _rnd(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _act(gen, c):
    return (torch.rand(c, generator=gen, device="cuda") + 0.5, _rnd(gen, c, scale=0.3))


def _taps(gen, cin, cout, dt):
    return _rnd(gen, 7, cin, cout, dtype=dt, scale=(7 * cin) ** -0.5), _rnd(gen, cout, dtype=dt)


def _pair_inputs(gen, B, h, w, cin, dt):
    """A level-s (h, w) grid's raw phase pair (4 + 4 phases (B, 5, h/2, w/2,
    C_in)) and its 4 float32 affines, as kernel n takes them."""
    ph = [_rnd(gen, B, 5, h // 2, w // 2, cin, dtype=dt) for _ in range(8)]
    return ph[:4], ph[4:], [*_act(gen, cin), *_act(gen, cin)]


class Case:
    """One kernel call at one shape: the kernel and its plain version, the
    FLOPs the function needs, its input tensors (each read once), where
    cuDNN computes the same contraction that call, for a merged kernel the
    split pair it replaces (two calls: a merged backward's dx and dtaps, a
    merged block's two convs; ``split_keys`` name them in the results and
    ``split_labels`` in the print), and other calls to time beside it
    (``compare``: label -> call). ``short``: the kernel is timed from a
    profiler trace (``trace_ms``). ``parts``: a call that returns the
    kernel's parts from a trace (``mma_parts``, bf16: the up conv's, n's
    and the grid convs' forward, d's, n's, b's and f's dtaps, a's, c's and
    f's dx; ``head_parts``: the pair head's forwards and backwards, the
    head's, g, e and h; ``block_parts``: o's and p's cooperative kernel).
    ``exact``: in bf16, a call that checks the kernel's outputs equal the
    split route's bit for bit (o, p, i, j, k; m's forward, dx and dtaps:
    the phase conv's) and returns what it compared."""

    def __init__(self, kernel, plain, flops, inputs, library=None, split=None, compare=None,
                 short=False, split_keys=("dx", "dtaps"), split_labels=("dx + Σg", "dtaps"),
                 parts=None, exact=None):
        self.kernel, self.plain, self.flops, self.library = kernel, plain, flops, library
        self.split, self.compare, self.short = split, compare or {}, short
        self.parts, self.exact = parts, exact
        self.split_keys, self.split_labels = split_keys, split_labels
        self.inputs = [t for t in flat(inputs) if t is not None]


def mma_parts(call, flops, inputs, operand, info, adjoint=None, split=None):
    """A bf16 tensor-core kernel's parts from a trace (the up conv's, n's
    and the grid convs' forward and dtaps; a's, c's, m's and n's dx; i and j):
    its operand passes (against their bound: the inputs they read once,
    ``inputs``, and the bf16 operands of ``operand`` = (rows, width), or a
    list of them, they write), the tap pack, the tensor-core GEMM (``flops``
    over its time against the bf16 peak), the sums (the partials' and
    Σg's), for c and j the upsample adjoint pass, for n the pair adjoint
    pass, against the ``adjoint`` bytes it must move; and ``info``, the GEMM instantiation's registers a
    thread, blocks an SM, shared and local memory as the runtime reports
    them (``build.mma_dtaps_info``, ``grid_dtaps_info``, ``mma_fwd_info``,
    ``grid_fwd_info``, ``mma_dx_info``, ``up_bwd_info``, ``phase_bwd_info``);
    the call's device time (every kernel it launches) and its split
    route's (``split``: a merged kernel's two calls; m's forward, b's
    forward at output phase 2)."""
    rows = trace_kernels(call, per_launch=True)
    op_bytes = sum(t.numel() * t.element_size() for t in flat(inputs) if t is not None)
    op_bytes += sum(r * w * 2 for r, w in (operand if isinstance(operand, list) else [operand]))
    gemm = sum(ms for k, ms in rows.items() if k.startswith("mma_"))
    parts = {"operand_ms": sum(ms for k, ms in rows.items() if "operand_pass" in k),
             "operand_bound_ms": op_bytes / PEAK_BYTES * 1e3,
             "pack_ms": sum(ms for k, ms in rows.items() if k.startswith("pack_taps")),
             "gemm_ms": gemm, "gemm_tflops": flops / gemm / 1e9 if gemm else 0.0,
             "gemm_bound_ms": flops / PEAK_FLOPS[torch.bfloat16] * 1e3,
             "sum_ms": sum(ms for k, ms in rows.items() if k.startswith("sum_rows")),
             "device_ms": sum(rows.values()), **info}
    if split is not None:
        parts["split_device_ms"] = sum(sum(trace_kernels(f, per_launch=True).values())
                                       for f in split)
    if adjoint is not None:  # c: dU (float32) read once, dx (bf16) written once; n: and the pair
        parts["adjoint_ms"] = sum(ms for k, ms in rows.items() if "adjoint_pass" in k)
        parts["adjoint_bound_ms"] = adjoint / PEAK_BYTES * 1e3
    return parts


def head_parts(call, inputs, main):
    """The pair head's parts (its forward, g, e, h) from a trace: its main
    pass, the ``kernel_group`` row that starts with ``main`` (the achieved
    GB/s of the bytes the call must move, each input read once and each
    output written once, against its byte bound), g's and h's pole pass
    and the backwards' partial rows' sum."""
    rows = trace_kernels(call, per_launch=True)
    nbytes = sum(t.numel() * t.element_size() for t in flat(inputs) + flat(call()))
    ms = sum(v for k, v in rows.items() if k.startswith(main))
    return {"head_ms": ms, "head_gbs": nbytes / ms / 1e6 if ms else 0.0,
            "head_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "poles_ms": sum(v for k, v in rows.items() if k.startswith("phmse_poles")),
            "sum_ms": sum(v for k, v in rows.items() if k.startswith("sum_rows"))}


def block_parts(call, split, info):
    """o's or p's parts (bf16) from a trace: the cooperative kernel's device
    time against the split pair's kernels' (``split``: its two calls), and
    ``info``, the kernel's registers a thread, blocks an SM, shared and
    local memory (``build.block_fwd_info``)."""
    block = sum(trace_kernels(call, per_launch=True).values())
    pair = sum(sum(trace_kernels(f, per_launch=True).values()) for f in split)
    return {"block_ms": block, "split_device_ms": pair, **info}


def up_operand(B, h, w, cin):
    """(rows, width) of the up conv's (and n's) operand of a level-s grid."""
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

    return pk.operand_rows(B, h, w), build.operand_width(cin)


def dx_operand(B, h, w, ntot, out_phases):
    """(rows, width) of a's, c's and f's cotangent operand at (B, h, w) for
    ``ntot`` columns of the cotangents of ``out_phases`` (None: f's one
    grid, ``halo.std_dx_codes``)."""
    from geniconet_tpu_torch.ops.kernels import build, halo

    codes = (halo.std_dx_codes(h, w, "average") if out_phases is None
             else halo.phase_dx_codes(h, w, "average", tuple(out_phases)))
    n_out = 1 if out_phases is None else len(out_phases)
    return build.cot_operand_shape(B, n_out * 5 * h * w, len(codes[1][0]) - 1, ntot)


def grid_parts(call, flops, inputs, B, h, w, cin, n_src, info):
    """``mma_parts`` of a grid conv's bf16 forward or dtaps (b, f) at (B, h,
    w, C_in) over ``n_src`` sources (the phase conv's 4, the standard
    conv's 1), with its GEMM's ``info``."""
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

    return mma_parts(call, flops, inputs,
                     (pk.grid_operand_rows(B, h, w, n_src), build.operand_width(cin)), info)


def conv_flops(B, cells, cin, ntot):
    """2·rows·7·C_in·C_out of a hex conv whose outputs are B·cells rows of ntot channels."""
    return 2 * B * cells * 7 * cin * ntot


def up_dx_flops(B, h, w, cin, cout):
    """The FLOPs an up conv's dx needs (c, n's dx, j's dx): the function is
    linear and composes down to the level-s grid (``halo.up_dx_table``: 7
    taps over B·5hw rows), a quarter of the stride-1 contraction over the 4
    upsampled phases that c's bf16 GEMM and cuDNN's conv2d_input run."""
    return conv_flops(B, 5 * h * w, cin, 2 * cout)


def cudnn(kind, gen, dt, n, cin, cout, hp, wp, stride=1):
    """The cuDNN call of one hex conv's contraction, on an input already
    haloed to (n, C_in, hp, wp), channels-last, with a 3×3 kernel: conv2d
    (fwd), conv2d_input (dx) or conv2d_weight (dtaps)."""
    import torch.nn.functional as F

    def nhwc(*shape):
        return _rnd(gen, *shape, dtype=dt).contiguous(memory_format=torch.channels_last)

    x, wt = nhwc(n, cin, hp, wp), nhwc(cout, cin, 3, 3)
    y = F.conv2d(x, wt, stride=stride)
    gy = nhwc(*y.shape)
    if kind == "fwd":
        return lambda: F.conv2d(x, wt, stride=stride)
    if kind == "dx":
        return lambda: torch.nn.grad.conv2d_input(x.shape, wt, gy, stride=stride)
    return lambda: torch.nn.grad.conv2d_weight(x, wt.shape, gy, stride=stride)


def split_fwd_case(B, h, w, cin, cout, with_act, with_stats):
    """m's forward (``ds2s_fwd``) at batch B on the level-s input phases (h,
    w), with its yardstick, b's forward at output phase 2 on the same phases
    (``phase_conv_fwd`` (2,)); in bf16 its outputs (and stats) must equal that
    call's followed by ``phase_split`` bit for bit, and its parts print
    beside b's kernels."""
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk
    from geniconet_tpu_torch.ops.phase import phase_split

    def make(dt, gen):
        ph = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
        sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
        a = _act(gen, cin) if with_act else None
        call = lambda: pk.ds2s_fwd(ph, sets, "average", a, with_stats)  # noqa: E731
        b_fwd = lambda: pk.phase_conv_fwd(ph, sets, "average", (2,), a, with_stats)  # noqa: E731
        flops = conv_flops(B, 5 * h * w, cin, 2 * cout)
        bf16 = dt == torch.bfloat16

        def exact():
            """m's bf16 outputs (and stats) against b's at output phase 2 on
            the same phases, split by ``phase_split``."""
            ref = b_fwd()
            sets_ref = ref[0] if with_stats else ref
            split = [tuple(p.contiguous() for p in phase_split(y)) for (y,) in sets_ref]
            want = flat((split, ref[1]) if with_stats else split)
            got = flat(call())
            if len(got) != len(want) or not all(map(torch.equal, got, want)):
                raise AssertionError("m: bf16 forward differs from phase_conv_fwd (2,) + "
                                     "phase_split")
            return ("each set's 4 parity phases" + (" and stats" if with_stats else "")
                    + " (phase_conv_fwd at phase 2 + phase_split)")

        parts = (lambda: mma_parts(call, flops, [ph, a],
                                   (pk.grid_operand_rows(B, h, w, 4), build.operand_width(cin)),
                                   build.ds2s_fwd_info(with_stats), split=(b_fwd,))
                 ) if bf16 else None
        return Case(call, lambda: pk.ds2s_fwd_plain(ph, sets, "average", a, with_stats), flops,
                    [ph, sets, a],
                    cudnn("fwd", gen, dt, B * 5, cin, 2 * cout, 2 * h + 1, 2 * w + 2, 2),
                    compare={"b's forward at phase 2": b_fwd}, parts=parts,
                    exact=exact if bf16 else None)
    return make


def at_level(s: int):
    """(z, relabel) of the cases at subdivision s: the s=5 shapes times z =
    2^(s-5), and a label's "(h,w)" shapes at that level."""
    z = 2 ** (s - 5)

    def relabel(label: str) -> str:
        return re.sub(r"\((\d+),(\d+)\)", lambda m: f"({int(m[1]) * z},{int(m[2]) * z})", label)
    return z, relabel


def serving_cases(B: int = BATCH, s: int = 5):
    """(kernel, label, make(dtype, gen) -> Case, group) at the serving shapes
    (batch B, subdivision s: the s=5 shapes scaled by ``at_level``)."""
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

    (w0, w1, w2), (z, relabel) = WIDTHS, at_level(s)

    def phase(h, w, cin, cout, n_sets, out_phases, with_act):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            ph = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
            sets = [_taps(gen, cin, cout, dt) for _ in range(n_sets)]
            a = _act(gen, cin) if with_act else None
            stride = 2 if out_phases == (2,) else 1
            call = lambda: pk.phase_conv_fwd(ph, sets, "average", out_phases, a)  # noqa: E731
            flops = conv_flops(B, len(out_phases) * 5 * h * w, cin, n_sets * cout)
            info = build.grid_fwd_info(False, False) if dt == torch.bfloat16 else None
            parts = (lambda: grid_parts(call, flops, [ph, a], B, h, w, cin, 4, info)
                     ) if info is not None else None
            return Case(call, lambda: pk.phase_conv_fwd_plain(ph, sets, "average", out_phases, a),
                        flops, [ph, sets, a],
                        cudnn("fwd", gen, dt, B * 5, cin, n_sets * cout, 2 * h + 3 - stride,
                              2 * w + 2, stride), parts=parts)
        return make

    def up(h, w, cin, cout):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            x = _rnd(gen, B, 5, h, w, cin, dtype=dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            call = lambda: pk.up_dual_conv_fwd(x, sets)  # noqa: E731
            flops = conv_flops(B, 4 * 5 * h * w, cin, 2 * cout)
            parts = (lambda: mma_parts(call, flops, [x], up_operand(B, h, w, cin),
                                       build.mma_fwd_info(False, False))
                     ) if dt == torch.bfloat16 else None
            return Case(call, lambda: pk.up_dual_conv_fwd_plain(x, sets), flops, [x, sets],
                        cudnn("fwd", gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2),
                        parts=parts)
        return make

    def std(h, w, c):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            x = _rnd(gen, B, 5, h, w, c, dtype=dt)
            t, b = _taps(gen, c, c, dt)
            a = _act(gen, c)
            call = lambda: ck.ico_conv_s2s_fwd(x, t, b, "average", a)  # noqa: E731
            flops = conv_flops(B, 5 * h * w, c, c)
            info = build.grid_fwd_info(True, False) if dt == torch.bfloat16 else None
            parts = (lambda: grid_parts(call, flops, [x, a], B, h, w, c, 1, info)
                     ) if info is not None else None
            return Case(call, lambda: ck.ico_conv_s2s_fwd_plain(x, t, b, "average", a), flops,
                        [x, t, b, a], cudnn("fwd", gen, dt, B * 5, c, c, h + 2, w + 2),
                        parts=parts)
        return make

    cases = [
        ("phase_conv_fwd", "conv_in (16,32) 3->64", phase(16, 32, 3, w0, 1, (0, 1, 2, 3), False)),
        ("phase_conv_fwd", "down0 s2 (16,32) 64->2x128", phase(16, 32, w0, w1, 2, (2,), True)),
        ("phase_conv_fwd", "down1 s2 (8,16) 128->2x256", phase(8, 16, w1, w2, 2, (2,), True)),
        ("phase_conv_fwd", "down2 s2 (4,8) 256->2x256", phase(4, 8, w2, w2, 2, (2,), True)),
        ("phase_conv_fwd", "up0 conv01 (4,8) 256->256", phase(4, 8, w2, w2, 1, (0, 1, 2, 3), True)),
        ("phase_conv_fwd", "up1 conv01 (8,16) 128->128", phase(8, 16, w1, w1, 1, (0, 1, 2, 3), True)),
        ("phase_conv_fwd", "up2 conv01 (16,32) 64->64", phase(16, 32, w0, w0, 1, (0, 1, 2, 3), True)),
        ("up_dual_conv_fwd", "up0 (4,8) 256->2x256", up(4, 8, w2, w2)),
        ("up_dual_conv_fwd", "up1 (8,16) 256->2x128", up(8, 16, w2, w1)),
        ("up_dual_conv_fwd", "up2 (16,32) 128->2x64", up(16, 32, w1, w0)),
        ("ico_conv_s2s_fwd", "down0 conv01 (16,32) 128", std(16, 32, w1)),
        ("ico_conv_s2s_fwd", "down1 conv01 (8,16) 256", std(8, 16, w2)),
        ("ico_conv_s2s_fwd", "down2 conv01 (4,8) 256", std(4, 8, w2)),
        ("pair_head_fwd", "head (16,32) 64->3", head_fwd(B, 16 * z, 32 * z, w0)),
        ("pair_head_fwd", "head (16,32) 64->3 B=1", head_fwd(1, 16 * z, 32 * z, w0)),
    ]
    # the VAE's own shapes: its heads (no act) and up0 from the 512-channel latent
    vae = [
        ("phase_conv_fwd", "VAE heads s2 (4,8) 256->2x512", phase(4, 8, w2, LATENT, 2, (2,), False)),
        ("up_dual_conv_fwd", "VAE up0 (4,8) 512->2x256", up(4, 8, LATENT, w2)),
    ]

    def split(h, w, cin, cout, with_act):
        h, w = h * z, w * z  # the s=5 shapes at level s
        return split_fwd_case(B, h, w, cin, cout, with_act, False)

    def pair(h, w, cin, cout):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            b0, y10, aff = _pair_inputs(gen, B, h, w, cin, dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            call = lambda: pk.up_pair_fwd(b0, y10, aff, sets)  # noqa: E731
            flops = conv_flops(B, 4 * 5 * h * w, cin, 2 * cout)
            parts = (lambda: mma_parts(call, flops, [b0, y10, aff], up_operand(B, h, w, cin),
                                       build.mma_fwd_info(True, False))
                     ) if dt == torch.bfloat16 else None
            return Case(call, lambda: pk.up_pair_fwd_plain(b0, y10, aff, sets), flops,
                        [b0, y10, aff, sets],
                        cudnn("fwd", gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2),
                        parts=parts)
        return make

    # the phase chains (the AE's, and the VAE trunk's down0-1): m at the
    # DownBlocks (an act prologue at down0 only), conv01 as the phase conv;
    # n at up1 and up2 (the AE's and the VAE's decoders share these shapes)
    chain = [
        ("ds2s_fwd", "down0 s2 split (16,32) 64->2x128", split(16, 32, w0, w1, True)),
        ("ds2s_fwd", "down1 s2 split (8,16) 128->2x256 (no act)", split(8, 16, w1, w2, False)),
        ("ds2s_fwd", "down2 s2 split (4,8) 256->2x256 (no act)", split(4, 8, w2, w2, False)),
        ("phase_conv_fwd", "down0 conv01 (8,16) 128->128", phase(8, 16, w1, w1, 1, _ALL, True)),
        ("phase_conv_fwd", "down1 conv01 (4,8) 256->256", phase(4, 8, w2, w2, 1, _ALL, True)),
        ("phase_conv_fwd", "down2 conv01 (2,4) 256->256", phase(2, 4, w2, w2, 1, _ALL, True)),
        ("up_pair_fwd", "up1 pair (8,16) 256->2x128", pair(8, 16, w2, w1)),
        ("up_pair_fwd", "up2 pair (16,32) 128->2x64", pair(16, 32, w1, w0)),
    ]
    return [(name, relabel(label), make, group) for name, label, make, group in
            [(*c, "AE") for c in cases] + [(*c, "VAE") for c in vae]
            + [(*c, "chain") for c in chain]]


def head_fwd(B, h, w, c):
    """The head's forward (``pair_head_fwd``) at batch B, with its parts."""
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

    def make(dt, gen):
        b0 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
        y10 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
        aff = [*_act(gen, c), *_act(gen, c)]
        W, bias = _rnd(gen, c, 3, dtype=dt, scale=c**-0.5), _rnd(gen, 3, dtype=dt)
        args = (b0, y10, aff, W, bias)
        call = lambda: pk.pair_head_fwd(*args)  # noqa: E731
        return Case(call, lambda: pk.pair_head_fwd_plain(*args), head_flops(B, h, w, c, 3), args,
                    parts=lambda: head_parts(call, args, "pair_head_kernel"))
    return make


def head_flops(B, h, w, c, F, backward=False):
    """The join (5 FLOPs a channel) and the 1×1 head (2·C·F) of every cell of
    the four phases; the backward recomputes both and adds dW and dt."""
    per_cell = 5 * c + 2 * c * F
    return 4 * B * 5 * h * w * (per_cell + (2 * 2 * c * F + 6 * c if backward else 0))


def training_cases(B: int = TRAIN_BATCH, s: int = 5):
    """(kernel, label, make, group) at the shapes of AE and VAE training
    (s=5, B=36; or batch B at subdivision s, the s=5 shapes scaled by
    ``at_level``): the forward kernels with BatchNorm stats, the six conv
    backward kernels with the stats fold, the head's backward, and the
    head+MSE forward and backward."""
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk
    from geniconet_tpu_torch.ops.phase import phase_merge, phase_split

    (w0, w1, w2), (z, relabel) = WIDTHS, at_level(s)

    def cotangents(gen, dt, h, w, cout, n_sets, n_out):
        """g and forward outputs y per set, and small stats cotangents gs."""
        def group():
            return [[_rnd(gen, B, 5, h, w, cout, dtype=dt) for _ in range(n_out)]
                    for _ in range(n_sets)]
        return group(), group(), [_rnd(gen, 2, cout, scale=1e-3) for _ in range(n_sets)]

    def phase_fwd(h, w, cin, cout, n_sets=1, out_phases=(0, 1, 2, 3), with_act=True):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            ph = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
            sets = [_taps(gen, cin, cout, dt) for _ in range(n_sets)]
            a = _act(gen, cin) if with_act else None
            stride = 2 if out_phases == (2,) else 1
            call = lambda: pk.phase_conv_fwd(ph, sets, "average", out_phases, a, True)  # noqa: E731
            flops = conv_flops(B, len(out_phases) * 5 * h * w, cin, n_sets * cout)
            info = build.grid_fwd_info(False, True) if dt == torch.bfloat16 else None
            parts = (lambda: grid_parts(call, flops, [ph, a], B, h, w, cin, 4, info)
                     ) if info is not None else None
            return Case(call, lambda: pk.phase_conv_fwd_plain(ph, sets, "average", out_phases,
                                                              a, True),
                        flops, [ph, sets, a],
                        cudnn("fwd", gen, dt, B * 5, cin, n_sets * cout, 2 * h + 3 - stride,
                              2 * w + 2, stride), parts=parts)
        return make

    def up_fwd(h, w, cin, cout):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            x = _rnd(gen, B, 5, h, w, cin, dtype=dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            call = lambda: pk.up_dual_conv_fwd(x, sets, "average", True)  # noqa: E731
            flops = conv_flops(B, 4 * 5 * h * w, cin, 2 * cout)
            parts = (lambda: mma_parts(call, flops, [x], up_operand(B, h, w, cin),
                                       build.mma_fwd_info(False, True))
                     ) if dt == torch.bfloat16 else None
            return Case(call, lambda: pk.up_dual_conv_fwd_plain(x, sets, "average", True), flops,
                        [x, sets],
                        cudnn("fwd", gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2),
                        parts=parts)
        return make

    def std_fwd(h, w, c):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            x, (t, b), a = _rnd(gen, B, 5, h, w, c, dtype=dt), _taps(gen, c, c, dt), _act(gen, c)
            call = lambda: ck.ico_conv_s2s_fwd(x, t, b, "average", a, True)  # noqa: E731
            flops = conv_flops(B, 5 * h * w, c, c)
            info = build.grid_fwd_info(True, True) if dt == torch.bfloat16 else None
            parts = (lambda: grid_parts(call, flops, [x, a], B, h, w, c, 1, info)
                     ) if info is not None else None
            return Case(call, lambda: ck.ico_conv_s2s_fwd_plain(x, t, b, "average", a, True),
                        flops, [x, t, b, a], cudnn("fwd", gen, dt, B * 5, c, c, h + 2, w + 2),
                        parts=parts)
        return make

    def phase_bwd(which, h, w, cin, cout, n_sets, out_phases, with_act=True, emit_gsum=False,
                  fold=True):
        """A phase-conv dx or dtaps call; without the fold (the fold outside
        the kernels) it gets neither y nor gs, and dtaps emits Σg."""
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            ph = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
            sets = [_taps(gen, cin, cout, dt) for _ in range(n_sets)]
            a = _act(gen, cin) if with_act else None
            g, y, gs = cotangents(gen, dt, h, w, cout, n_sets, len(out_phases))
            y, gs = (y, gs) if fold else (None, None)
            stride = 2 if out_phases == (2,) else 1
            flops = conv_flops(B, len(out_phases) * 5 * h * w, cin, n_sets * cout)
            lib = cudnn(which, gen, dt, B * 5, cin, n_sets * cout, 2 * h + 3 - stride,
                        2 * w + 2, stride)
            if which == "dx":
                args = (g, sets, "average", out_phases, cin, dt, a, ph, y, gs)
                call = lambda: pk.phase_conv_dx(*args)  # noqa: E731
                parts = (lambda: mma_parts(
                    call, flops, [g, y, gs],
                    dx_operand(B, h, w, n_sets * cout, out_phases),
                    build.mma_dx_info(False, a is not None))) if dt == torch.bfloat16 else None
                return Case(call, lambda: pk.phase_conv_dx_plain(*args), flops,
                            [g, [t for t, _ in sets], a, ph, y, gs], lib, parts=parts)
            args = (ph, g, [(7, cin, cout)] * n_sets, "average", out_phases, a, y, gs,
                    emit_gsum or not fold)
            call = lambda: pk.phase_conv_dtaps(*args)  # noqa: E731
            info = (build.grid_dtaps_info(False, fold, build.mma_narrow(cin))
                    if dt == torch.bfloat16 else None)
            parts = (lambda: grid_parts(call, flops, [ph, a], B, h, w, cin, 4, info)
                     ) if info is not None else None
            return Case(call, lambda: pk.phase_conv_dtaps_plain(*args), flops,
                        [ph, g, a, y, gs], lib, parts=parts)
        return make

    def split_fwd(h, w, cin, cout, with_act):
        h, w = h * z, w * z  # the s=5 shapes at level s
        return split_fwd_case(B, h, w, cin, cout, with_act, True)

    def phase_merged(groups):
        """Per set the ``phase_merge`` of its 4 phase cotangents (m's split
        route: the phase conv at output phase 2)."""
        return [(phase_merge(tuple(gg)).contiguous(),) for gg in groups]

    def split_bwd(which, h, w, cin, cout, with_act, fold):
        """m's dx or dtaps on the level-s input phases (h, w): the 2 x 4
        phase cotangents (h/2, w/2) with the fold in the kernel, or none
        (the fold outside: dtaps then emits Σg). In bf16 m's dx must equal
        a's and m's dtaps b's on the merged cotangents bit for bit; m's dx
        prints its parts and is timed beside a's call on the merged
        cotangents."""
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            ph = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            a = _act(gen, cin) if with_act else None
            g, y, gs = cotangents(gen, dt, h // 2, w // 2, cout, 2, 4)
            fk = dict(y_groups=y, gs_list=gs) if fold else {}
            flops = conv_flops(B, 5 * h * w, cin, 2 * cout)
            lib = cudnn(which, gen, dt, B * 5, cin, 2 * cout, 2 * h + 1, 2 * w + 2, 2)
            bf16 = dt == torch.bfloat16
            fm = {k: phase_merged(v) if k == "y_groups" else v for k, v in fk.items()}
            if which == "dx":
                args = (g, sets, "average", cin, dt, a, ph if a else None)
                call = lambda: pk.ds2s_dx(*args, **fk)  # noqa: E731
                gm = phase_merged(g)
                a_dx = lambda: pk.phase_conv_dx(gm, *args[1:3], (2,), *args[3:], **fm)  # noqa: E731

                def exact_dx():
                    """m's bf16 dx, d_mul/d_add and Σg_eff against a's at output
                    phase 2 on the phase_merge'd cotangents (its split route)."""
                    got, ref = call(), a_dx()
                    if [u is None for u in got] != [v is None for v in ref] or not all(
                            map(torch.equal, flat(got), flat(ref))):
                        raise AssertionError("m: bf16 dx differs from phase_conv_dx's")
                    return ("dphases" + (", d_mul/d_add" if a else "")
                            + (", Σg_eff a/b" if fold else "")
                            + " (phase_conv_dx at phase 2 on the merged cotangents)")

                parts = (lambda: mma_parts(call, flops, [g, list(fk.values())],
                                           dx_operand(B, h, w, 2 * cout, (2,)),
                                           build.mma_dx_info(False, a is not None, split=True))
                         ) if bf16 else None
                return Case(call, lambda: pk.ds2s_dx_plain(*args, **fk), flops,
                            [g, [t for t, _ in sets], a, ph if a else None, list(fk.values())],
                            lib, compare={"a's dx on the merged cotangents": a_dx}, parts=parts,
                            exact=exact_dx if bf16 else None)
            args = (ph, g, [(7, cin, cout)] * 2, "average", a)
            call = lambda: pk.ds2s_dtaps(*args, **fk, emit_gsum=not fold)  # noqa: E731

            def exact():
                """m's bf16 dtaps and Σg_eff against b's on the phase_merge'd
                cotangents (its split route)."""
                ref = pk.phase_conv_dtaps(ph, phase_merged(g), args[2], "average", (2,), a, **fm,
                                          emit_gsum=not fold)
                if not all(torch.equal(u, v) for u, v in zip(flat(call()), flat(ref))):
                    raise AssertionError("m: bf16 dtaps or Σg_eff differ from phase_conv_dtaps'")
                return ("dtaps a/b" + (" and Σg_eff a/b" if not fold else "")
                        + " (phase_conv_dtaps at phase 2 on the merged cotangents)")

            info = build.grid_dtaps_info(False, fold, build.mma_narrow(cin), split=True) if bf16 \
                else None
            return Case(call, lambda: pk.ds2s_dtaps_plain(*args, **fk, emit_gsum=not fold), flops,
                        [ph, g, a, list(fk.values())], lib,
                        parts=(lambda: grid_parts(call, flops, [ph, a], B, h, w, cin, 4, info)
                               ) if bf16 else None, exact=exact if bf16 else None)
        return make

    def geff(h, w, c, fold_cost=None):
        """l over a group of 4 phases (B, 5, h, w, c); with ``fold_cost`` =
        (h, w, cin) of m's input, also m's dx + dtaps with the fold in the
        kernels and without it, whose difference is what l replaces."""
        h, w = h * z, w * z  # the s=5 shapes at level s
        fold_cost = fold_cost and (fold_cost[0] * z, fold_cost[1] * z, fold_cost[2])
        def make(dt, gen):
            g = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            y = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            gs = _rnd(gen, 2, c, scale=1e-3)
            compare = {}
            if fold_cost:
                hi, wi, cin = fold_cost
                ph = [_rnd(gen, B, 5, hi, wi, cin, dtype=dt) for _ in range(4)]
                sets = [_taps(gen, cin, c, dt) for _ in range(2)]
                a = _act(gen, cin)
                gg = [g, [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]]
                yy = [y, [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]]

                def m_pair(fold):
                    fk = dict(y_groups=yy, gs_list=[gs, gs]) if fold else {}
                    pk.ds2s_dx(gg, sets, "average", cin, dt, a, ph, **fk)
                    pk.ds2s_dtaps(ph, gg, [(7, cin, c)] * 2, "average", a, **fk,
                                  emit_gsum=not fold)
                compare = {"m dx + dtaps with the fold in-kernel": lambda: m_pair(True),
                           "without it": lambda: m_pair(False)}
            return Case(lambda: pk.stats_geff(g, y, gs), lambda: pk.geff_plain(g, y, gs),
                        4 * 4 * B * 5 * h * w * c, [g, y, gs], compare=compare, short=True)
        return make

    def pair_fwd(h, w, cin, cout):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            b0, y10, aff = _pair_inputs(gen, B, h, w, cin, dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            call = lambda: pk.up_pair_fwd(b0, y10, aff, sets, "average", True)  # noqa: E731
            flops = conv_flops(B, 4 * 5 * h * w, cin, 2 * cout)
            parts = (lambda: mma_parts(call, flops, [b0, y10, aff], up_operand(B, h, w, cin),
                                       build.mma_fwd_info(True, True))
                     ) if dt == torch.bfloat16 else None
            return Case(call, lambda: pk.up_pair_fwd_plain(b0, y10, aff, sets, "average", True),
                        flops, [b0, y10, aff, sets],
                        cudnn("fwd", gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2),
                        parts=parts)
        return make

    def pair_bwd(which, h, w, cin, cout, fold):
        """n's dx (with Σg) or dtaps on the level-s (h, w) pair, with the fold
        in the kernel or none (the fold outside)."""
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            b0, y10, aff = _pair_inputs(gen, B, h, w, cin, dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            g, y, gs = cotangents(gen, dt, h, w, cout, 2, 4)
            fk = dict(y_groups=y, gs_list=gs) if fold else {}
            flops = conv_flops(B, 4 * 5 * h * w, cin, 2 * cout)
            lib = cudnn(which, gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2)
            reads = [g, b0, y10, aff, list(fk.values())]
            if which == "dx":
                args = (g, b0, y10, aff, sets, "average")
                call = lambda: pk.up_pair_dx(*args, emit_gsum=True, **fk)  # noqa: E731
                # the adjoint pass: dU (float32) read once, the pair read and
                # its 8 cotangents written once (bf16)
                pass_bytes = B * 4 * 5 * h * w * cin * 4 + 2 * 2 * B * 5 * h * w * cin * 2
                parts = (lambda: mma_parts(call, flops, [g, list(fk.values())],
                                           dx_operand(B, h, w, 2 * cout, _ALL),
                                           build.mma_dx_info(True, pair=True), pass_bytes)
                         ) if dt == torch.bfloat16 else None
                return Case(call, lambda: pk.up_pair_dx_plain(*args, emit_gsum=True, **fk),
                            up_dx_flops(B, h, w, cin, cout), [*reads, [t for t, _ in sets]], lib,
                            parts=parts)
            args = (b0, y10, aff, g, "average")
            call = lambda: pk.up_pair_dtaps(*args, **fk)  # noqa: E731
            parts = (lambda: mma_parts(call, flops, [b0, y10, aff], up_operand(B, h, w, cin),
                                       build.mma_dtaps_info(True, fold))
                     ) if dt == torch.bfloat16 else None
            return Case(call, lambda: pk.up_pair_dtaps_plain(*args, **fk), flops, reads, lib,
                        parts=parts)
        return make

    def up_bwd(which, h, w, cin, cout):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            x = _rnd(gen, B, 5, h, w, cin, dtype=dt)
            sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
            g, y, gs = cotangents(gen, dt, h, w, cout, 2, 4)
            flops = conv_flops(B, 4 * 5 * h * w, cin, 2 * cout)
            lib = cudnn(which, gen, dt, B * 5, cin, 2 * cout, 2 * h + 2, 2 * w + 2)
            if which == "dx":
                args = (g, sets, "average", dt, y, gs, True)
                call = lambda: pk.up_dual_conv_dx(*args)  # noqa: E731
                du_bytes = B * 4 * 5 * h * w * cin * 4 + B * 5 * h * w * cin * 2
                parts = (lambda: mma_parts(call, flops, [g, y, gs],
                                           dx_operand(B, h, w, 2 * cout, _ALL),
                                           build.mma_dx_info(True), du_bytes)
                         ) if dt == torch.bfloat16 else None
                return Case(call, lambda: pk.up_dual_conv_dx_plain(*args),
                            up_dx_flops(B, h, w, cin, cout), [g, [t for t, _ in sets], y, gs],
                            lib, parts=parts)
            args = (x, g, "average", y, gs)
            call = lambda: pk.up_dual_conv_dtaps(*args)  # noqa: E731
            parts = (lambda: mma_parts(call, flops, [x], up_operand(B, h, w, cin),
                                       build.mma_dtaps_info(False, True))
                     ) if dt == torch.bfloat16 else None
            return Case(call, lambda: pk.up_dual_conv_dtaps_plain(*args), flops, [x, g, y, gs],
                        lib, parts=parts)
        return make

    def std_bwd(which, h, w, c):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            x, (t, _), a = _rnd(gen, B, 5, h, w, c, dtype=dt), _taps(gen, c, c, dt), _act(gen, c)
            gg, yy, gss = cotangents(gen, dt, h, w, c, 1, 1)
            g, y, gs = gg[0][0], yy[0][0], gss[0]
            flops = conv_flops(B, 5 * h * w, c, c)
            lib = cudnn(which, gen, dt, B * 5, c, c, h + 2, w + 2)
            if which == "dx":
                args = (g, t, "average", dt, a, x, y, gs, True)
                call = lambda: ck.ico_conv_s2s_dx(*args)  # noqa: E731
                parts = (lambda: mma_parts(call, flops, [g, y, gs], dx_operand(B, h, w, c, None),
                                           build.mma_dx_info(False, True, std=True))
                         ) if dt == torch.bfloat16 else None
                return Case(call, lambda: ck.ico_conv_s2s_dx_plain(*args), flops,
                            [g, t, a, x, y, gs], lib, parts=parts)
            args = (x, g, "average", a, y, gs)
            call = lambda: ck.ico_conv_s2s_dtaps(*args)  # noqa: E731
            info = (build.grid_dtaps_info(True, True, build.mma_narrow(c))
                    if dt == torch.bfloat16 else None)
            parts = (lambda: grid_parts(call, flops, [x, a], B, h, w, c, 1, info)
                     ) if info is not None else None
            return Case(call, lambda: ck.ico_conv_s2s_dtaps_plain(*args), flops,
                        [x, g, a, y, gs], lib, parts=parts)
        return make

    def std_s2(which, h, w, cin, cout, batch=B, with_act=True, fold=True):
        """The standard conv at stride 2 (``fused_ico_conv_s2s(..., stride=2)``'s
        kernels) over the level-s phase grid (h, w) of a DownBlock, its input
        the (2h, 2w) grid: the forward (with stats at the training batch,
        without at the serving one), dx, dtaps or the merged backward k, the
        fold in the kernels or outside them (no y, gs; k without stats).
        FLOPs: the function's, 2·7·C_in·C_out a output cell (k: dx +
        dtaps); cuDNN's stride-2 call on the haloed (2h + 1, 2w + 2) input.
        In bf16 the forward must equal b's forward at output phase 2 on the
        input's parity phases (the same function; PERF.md) and k the split
        pair at stride 2, bit for bit."""
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            x = _rnd(gen, batch, 5, 2 * h, 2 * w, cin, dtype=dt)
            t, b = _taps(gen, cin, cout, dt)
            a = _act(gen, cin) if with_act else None
            flops = conv_flops(batch, 5 * h * w, cin, cout)
            halo = (batch * 5, cin, cout, 2 * h + 1, 2 * w + 2, 2)
            bf16 = dt == torch.bfloat16
            if which == "fwd":
                stats = batch == B
                args = (x, t, b, "average", a, stats)
                call = lambda: ck.ico_conv_s2s_fwd(*args, stride=2)  # noqa: E731
                ph = [p.contiguous() for p in phase_split(x)]
                b_fwd = lambda: pk.phase_conv_fwd(ph, [(t, b)], "average", (2,), a,  # noqa: E731
                                                  stats)

                def exact():
                    got, ref = flat(call()), flat(b_fwd())
                    if len(got) != len(ref) or not all(map(torch.equal, got, ref)):
                        raise AssertionError("f at stride 2: bf16 forward differs from "
                                             "phase_conv_fwd (2,) on the parity phases")
                    return "the output" + (" and stats" if stats else "") + \
                        " (b's forward at phase 2 on the parity phases)"

                parts = (lambda: grid_parts(call, flops, [x, a], batch, 2 * h, 2 * w, cin, 1,
                                            build.grid_fwd_info(True, stats))) if bf16 else None
                return Case(call, lambda: ck.ico_conv_s2s_fwd_plain(*args, stride=2), flops,
                            [x, t, b, a], cudnn("fwd", gen, dt, *halo),
                            compare={"b's forward at phase 2": b_fwd}, parts=parts,
                            exact=exact if bf16 else None)
            g = _rnd(gen, batch, 5, h, w, cout, dtype=dt)
            y, gs = ((_rnd(gen, batch, 5, h, w, cout, dtype=dt), _rnd(gen, 2, cout, scale=1e-3))
                     if fold else (None, None))
            cot = build.cot_operand_shape(batch, 5 * h * w, 0, cout)
            if which == "dx":
                args = (g, t, "average", dt, a, x if a else None, y, gs, True)
                call = lambda: ck.ico_conv_s2s_dx(*args, stride=2)  # noqa: E731
                parts = (lambda: mma_parts(call, flops, [g, y, gs], cot,
                                           build.mma_dx_info(False, a is not None, std=True))
                         ) if bf16 else None
                return Case(call, lambda: ck.ico_conv_s2s_dx_plain(*args, stride=2), flops,
                            [g, t, a, x if a else None, y, gs], cudnn("dx", gen, dt, *halo),
                            parts=parts)
            if which == "dtaps":
                args = (x, g, "average", a, y, gs)
                call = lambda: ck.ico_conv_s2s_dtaps(*args, stride=2)  # noqa: E731
                parts = (lambda: grid_parts(call, flops, [x, a], batch, 2 * h, 2 * w, cin, 1,
                                            build.grid_dtaps_info(True, fold,
                                                                  build.mma_narrow(cin)))
                         ) if bf16 else None
                return Case(call, lambda: ck.ico_conv_s2s_dtaps_plain(*args, stride=2), flops,
                            [x, g, a, y, gs], cudnn("dtaps", gen, dt, *halo), parts=parts)
            args = (x, g, t, y, gs, "average", a, fold, dt)
            call = lambda: ck.ico_conv_s2s_bwd(*args, stride=2)  # noqa: E731
            split = (lambda: ck.ico_conv_s2s_dx(g, t, "average", dt, a, x, y, gs, True,
                                                stride=2),
                     lambda: ck.ico_conv_s2s_dtaps(x, g, "average", a, y, gs, stride=2))

            def exact():
                got = call()
                (dx, dmul, dadd, gsum), dtaps = split[0](), split[1]()
                for key, u, v in zip(("dx", "dtaps", "Σg_eff", "d_mul", "d_add"), got,
                                     (dx, dtaps, gsum, dmul, dadd)):
                    if (u is None) != (v is None) or (u is not None and not torch.equal(u, v)):
                        raise AssertionError(f"k at stride 2: bf16 {key} differs from the "
                                             "split route's")
                return ("dx, bf16 dtaps, Σg_eff" + (", d_mul, d_add" if a else "")
                        + " (f's dx + f's dtaps at stride 2)")

            parts = (lambda: mma_parts(
                call, 2 * flops, [x, g, y, gs, a],
                [cot, (pk.grid_operand_rows(batch, 2 * h, 2 * w, 1), build.operand_width(cin))],
                build.std_bwd_info(build.mma_narrow(cin), a is not None), split=split)
            ) if bf16 else None
            lib_dx, lib_dw = cudnn("dx", gen, dt, *halo), cudnn("dtaps", gen, dt, *halo)
            return Case(call, lambda: ck.ico_conv_s2s_bwd_plain(*args, stride=2), 2 * flops,
                        [x, g, t, y, gs, a], lambda: (lib_dx(), lib_dw()), split, parts=parts,
                        exact=exact if bf16 else None)
        return make

    def head_mse(which, h, w, c):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            b0 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            y10 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            aff = [*_act(gen, c), *_act(gen, c)]
            W, bias = _rnd(gen, c, 3, dtype=dt, scale=c**-0.5), _rnd(gen, 3, dtype=dt, scale=0.1)
            tpack = torch.rand(B, 5, h, w, 12, generator=gen, device="cuda") * 2 - 1
            tpoles = torch.rand(B, 6, generator=gen, device="cuda") * 2 - 1
            args = (b0, y10, aff, W, bias, tpack, tpoles)
            if which == "fwd":
                call = lambda: pk.pair_head_mse_fwd(*args)  # noqa: E731
                return Case(call, lambda: pk.pair_head_mse_fwd_plain(*args),
                            head_flops(B, h, w, c, 3), args,
                            parts=lambda: head_parts(call, args, "phmse_fwd"))
            g = torch.rand(B, generator=gen, device="cuda")
            call = lambda: pk.pair_head_mse_bwd(g, *args)  # noqa: E731
            return Case(call, lambda: pk.pair_head_mse_bwd_plain(g, *args),
                        head_flops(B, h, w, c, 3, backward=True), [g, *args],
                        parts=lambda: head_parts(call, [g, *args], "phmse_bwd"))
        return make

    def head_bwd(h, w, c):
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            b0 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            y10 = [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]
            aff = [*_act(gen, c), *_act(gen, c)]
            W, bias = _rnd(gen, c, 3, dtype=dt, scale=c**-0.5), _rnd(gen, 3, dtype=dt, scale=0.1)
            g = tuple(_rnd(gen, B, 5, h, w, 3) for _ in range(4))
            args = (g, b0, y10, aff, W, bias)
            call = lambda: pk.pair_head_bwd(*args)  # noqa: E731
            return Case(call, lambda: pk.pair_head_bwd_plain(*args),
                        head_flops(B, h, w, c, 3, backward=True), args,
                        parts=lambda: head_parts(call, args, "phead_bwd"))
        return make

    def merged_bwd(kind, h, w, cin, cout, n_sets=1, out_phases=(0, 1, 2, 3), with_act=True):
        """Kernel i ("phase"), j ("up") or k ("std") with the stats fold, the
        split pair it replaces (dx with its Σg pass, then dtaps) and cuDNN's
        dx + dweight on the haloed input. FLOPs: dx (an up conv's composed,
        ``up_dx_flops``) + dtaps. In bf16 i's seven outputs, j's five and
        k's five must equal the split pair's bit for bit, and i, j and k
        print their parts (their two passes, the one launch of both GEMMs,
        whose FLOPs are the dx GEMM's and the dtaps', j's adjoint, the sums,
        and the device time against the split pair's kernels)."""
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            a = _act(gen, cin) if with_act else None
            exact = parts = None
            if kind == "up":
                x = _rnd(gen, B, 5, h, w, cin, dtype=dt)
                sets = [_taps(gen, cin, cout, dt) for _ in range(2)]
                g, y, gs = cotangents(gen, dt, h, w, cout, 2, 4)
                args = (x, g, sets, "average", y, gs)
                fn, plain = pk.up_dual_conv_bwd, pk.up_dual_conv_bwd_plain
                split = (lambda: pk.up_dual_conv_dx(g, sets, "average", dt, y, gs, True),
                         lambda: pk.up_dual_conv_dtaps(x, g, "average", y, gs))
                reads = [x, g, y, gs, [t for t, _ in sets]]
                rows, ntot, stride, halo = 4 * 5 * h * w, 2 * cout, 1, (2 * h + 2, 2 * w + 2)

                def exact(split=split, args=args):
                    got = pk.up_dual_conv_bwd(*args)
                    (dx, (ga, gb)), (da, db) = split[0](), split[1]()
                    for key, u, v in zip(("dx", "dtaps a", "dtaps b", "Σg_eff a", "Σg_eff b"),
                                         got, (dx, da, db, ga, gb)):
                        if not torch.equal(u, v):
                            raise AssertionError(f"j: bf16 {key} differs from the split route's")
                    return "dx, dtaps a/b and Σg_eff a/b"

                if dt == torch.bfloat16:
                    du_bytes = B * 4 * 5 * h * w * cin * 4 + B * 5 * h * w * cin * 2
                    parts = (lambda args=args, split=split: mma_parts(
                        lambda: pk.up_dual_conv_bwd(*args), 2 * conv_flops(B, rows, cin, ntot),
                        [x, g, y, gs], [dx_operand(B, h, w, ntot, _ALL), up_operand(B, h, w, cin)],
                        build.up_bwd_info(), du_bytes, split))
            elif kind == "std":
                x = _rnd(gen, B, 5, h, w, cin, dtype=dt)
                t, _ = _taps(gen, cin, cout, dt)
                gg, yy, gss = cotangents(gen, dt, h, w, cout, 1, 1)
                g, y, gs = gg[0][0], yy[0][0], gss[0]
                args = (x, g, t, y, gs, "average", a, True, dt)
                fn, plain = ck.ico_conv_s2s_bwd, ck.ico_conv_s2s_bwd_plain
                split = (lambda: ck.ico_conv_s2s_dx(g, t, "average", dt, a, x, y, gs, True),
                         lambda: ck.ico_conv_s2s_dtaps(x, g, "average", a, y, gs))
                reads = [x, g, y, gs, t, a]
                rows, ntot, stride, halo = 5 * h * w, cout, 1, (h + 2, w + 2)

                def exact(split=split, args=args):
                    """k's 5 outputs against f's dx (dx, d_mul/d_add, Σg_eff)
                    and f's bf16 dtaps."""
                    got = ck.ico_conv_s2s_bwd(*args)
                    (dx, dmul, dadd, gsum), dtaps = split[0](), split[1]()
                    for key, u, v in zip(("dx", "dtaps", "Σg_eff", "d_mul", "d_add"), got,
                                         (dx, dtaps, gsum, dmul, dadd)):
                        if (u is None) != (v is None) or (u is not None and not torch.equal(u, v)):
                            raise AssertionError(f"k: bf16 {key} differs from the split route's")
                    return ("dx, bf16 dtaps, Σg_eff" + (", d_mul, d_add" if a else "")
                            + " (f's dx + f's dtaps)")

                if dt == torch.bfloat16:
                    parts = (lambda args=args, split=split: mma_parts(
                        lambda: ck.ico_conv_s2s_bwd(*args), 2 * conv_flops(B, rows, cin, ntot),
                        [x, g, y, gs, a],
                        [dx_operand(B, h, w, ntot, None),
                         (pk.grid_operand_rows(B, h, w, 1), build.operand_width(cin))],
                        build.std_bwd_info(build.mma_narrow(cin), a is not None), split=split))
            else:
                x = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
                sets = [_taps(gen, cin, cout, dt) for _ in range(n_sets)]
                g, y, gs = cotangents(gen, dt, h, w, cout, n_sets, len(out_phases))
                args = (x, g, y, gs, sets, "average", out_phases, a, True, dt)
                fn, plain = pk.phase_conv_bwd, pk.phase_conv_bwd_plain
                shapes = [(7, cin, cout)] * n_sets
                split = (lambda: pk.phase_conv_dx(g, sets, "average", out_phases, cin, dt, a, x,
                                                  y, gs),
                         lambda: pk.phase_conv_dtaps(x, g, shapes, "average", out_phases, a, y,
                                                     gs))
                reads = [x, g, y, gs, [t for t, _ in sets], a]
                stride = 2 if out_phases == (2,) else 1
                rows, ntot = len(out_phases) * 5 * h * w, n_sets * cout
                halo = (2 * h + 3 - stride, 2 * w + 2)

                def exact(args=args):
                    """i's 7 outputs against a's dx (dphases, d_mul/d_add,
                    Σg_eff) and b's dtaps with its Σg_eff."""
                    got = pk.phase_conv_bwd(*args)
                    dph, dmul, dadd, gdx = pk.phase_conv_dx(g, sets, "average", out_phases, cin,
                                                            dt, a, x, y, gs)
                    dtaps, gsums = pk.phase_conv_dtaps(x, g, shapes, "average", out_phases, a, y,
                                                       gs, emit_gsum=True)
                    for key, u, v in zip(("dphases", "dtaps", "Σg_eff", "d_mul", "d_add",
                                          "Σg_eff (a's pass)"),
                                         (*got, got[2]), (dph, dtaps, gsums, dmul, dadd, gdx)):
                        fu, fv = flat(u), flat(v)
                        if len(fu) != len(fv) or not all(map(torch.equal, fu, fv)):
                            raise AssertionError(f"i: bf16 {key} differs from the split route's")
                    return ("dphases, dtaps and Σg_eff of each set"
                            + (", d_mul, d_add" if a else "") + " (a's dx + b's dtaps)")

                if dt == torch.bfloat16:
                    parts = (lambda args=args, split=split: mma_parts(
                        lambda: pk.phase_conv_bwd(*args), 2 * conv_flops(B, rows, cin, ntot),
                        [x, g, y, gs, a],
                        [dx_operand(B, h, w, ntot, out_phases),
                         (pk.grid_operand_rows(B, h, w, 4), build.operand_width(cin))],
                        build.phase_bwd_info(build.mma_narrow(cin), a is not None), split=split))
            lib_dx = cudnn("dx", gen, dt, B * 5, cin, ntot, *halo, stride)
            lib_dw = cudnn("dtaps", gen, dt, B * 5, cin, ntot, *halo, stride)
            dx_flops = (up_dx_flops(B, h, w, cin, cout) if kind == "up"
                        else conv_flops(B, rows, cin, ntot))
            return Case(lambda: fn(*args), lambda: plain(*args),
                        dx_flops + conv_flops(B, rows, cin, ntot), reads,
                        lambda: (lib_dx(), lib_dw()), split, parts=parts,
                        exact=exact if dt == torch.bfloat16 else None)
        return make

    def block(kind, h, w, cin, c0, c2, with_act=False):
        """Kernel o ("up": the level-s grid (h, w)) or p ("down": the 4
        parity phases (h, w) of the level-s input, whose stride-2 output
        is (h, w) too) at one block, with bn00's gamma and beta; the split
        pair it replaces (the first conv with stats and its sums; then
        bn00's affine from them and conv01 with stats) and cuDNN's two
        contractions on haloed inputs. FLOPs: both passes. The first convs'
        biases are 0.1 of ``_taps``': with unit biases a channel's batch
        mean can be many of its standard deviations, and bn00's variance,
        Σy²/n − mean², then loses bits to cancellation in float32 (the
        plain version's sums are in another order), which the float32
        tolerance would measure instead of the kernel."""
        h, w = h * z, w * z  # the s=5 shapes at level s
        def make(dt, gen):
            sets = [_taps(gen, cin, c0, dt), _taps(gen, cin, c0, dt), _taps(gen, c0, c2, dt)]
            sets[:2] = [(t, 0.1 * b) for t, b in sets[:2]]
            gamma, beta = _act(gen, c0)
            a = _act(gen, cin) if with_act else None
            if kind == "up":
                x = _rnd(gen, B, 5, h, w, cin, dtype=dt)
                args = (x, sets, gamma, beta)
                fn, plain = pk.up_block_fwd, pk.up_block_fwd_plain
                count, rows = 4.0 * B * 5 * h * w, 4 * 5 * h * w
                (y00, _), (s00, _) = pk.up_dual_conv_fwd(x, sets[:2], "average", True)

                def first():
                    return pk.up_dual_conv_fwd(x, sets[:2], "average", True)

                def second():
                    aff = pk.bn_affine_plain(s00, count, gamma, beta)
                    return pk.phase_conv_fwd(y00, sets[2:], "average", _ALL, aff, True)

                lib_a = cudnn("fwd", gen, dt, B * 5, cin, 2 * c0, 2 * h + 2, 2 * w + 2)
                lib_b = cudnn("fwd", gen, dt, B * 5, c0, c2, 2 * h + 2, 2 * w + 2)
            else:
                x = [_rnd(gen, B, 5, h, w, cin, dtype=dt) for _ in range(4)]
                args = (x, sets, gamma, beta, a)
                fn, plain = pk.dn_block_fwd, pk.dn_block_fwd_plain
                count, rows = 1.0 * B * 5 * h * w, 5 * h * w
                ((y00,), _), (s00, _) = pk.phase_conv_fwd(x, sets[:2], "average", (2,), a, True)

                def first():
                    return pk.phase_conv_fwd(x, sets[:2], "average", (2,), a, True)

                def second():
                    aff = pk.bn_affine_plain(s00, count, gamma, beta)
                    return ck.ico_conv_s2s_fwd(y00, *sets[2], "average", aff, True)

                lib_a = cudnn("fwd", gen, dt, B * 5, cin, 2 * c0, 2 * h + 1, 2 * w + 2, 2)
                lib_b = cudnn("fwd", gen, dt, B * 5, c0, c2, h + 2, w + 2)
            def exact():
                """o's or p's 8 outputs against the split route's: the first
                conv with stats, then the second on the kernel's y00 and
                affine; the affine against bn_affine_plain's on the card
                (mul within one float32 ulp, rsqrtf against PyTorch's rsqrt,
                as the card tests hold it; add the formula on that mul)."""
                b0, y10, y00_k, s00_k, s01, s10, mul, add = fn(*args)
                if kind == "up":
                    (r00, r10), (rs00, rs10) = first()
                    (rb0,), (rs01,) = pk.phase_conv_fwd(y00_k, sets[2:], "average", _ALL,
                                                        (mul, add), True)
                else:
                    ((r00,), (r10,)), (rs00, rs10) = first()
                    rb0, rs01 = ck.ico_conv_s2s_fwd(y00_k, *sets[2], "average", (mul, add), True)
                pairs = {"y00": (y00_k, r00), "y10": (y10, r10), "s00": (s00_k, rs00),
                         "s10": (s10, rs10), "b0": (b0, rb0), "s01": (s01, rs01)}
                for key, (u, v) in pairs.items():
                    if not all(torch.equal(g, r) for g, r in zip(flat(u), flat(v))):
                        raise AssertionError(f"{'o' if kind == 'up' else 'p'}: bf16 {key} "
                                             "differs from the split route's")
                ref_mul, _ = pk.bn_affine_plain(s00_k, count, gamma, beta)
                ulp = torch.nextafter(ref_mul.abs(), torch.tensor(math.inf, device="cuda"))
                if not (bool(((mul - ref_mul).abs() <= ulp - ref_mul.abs()).all())
                        and torch.equal(add, beta - s00_k[0] / count * mul)):
                    raise AssertionError(f"{'o' if kind == 'up' else 'p'}: bf16 mul00/add00 "
                                         "are not bn00's affine")
                return (f"y00, y10, s00, s10, b0, s01 and add00 (mul00 "
                        f"{'equal' if torch.equal(mul, ref_mul) else 'within one ulp'})")

            info = build.block_fwd_info(kind == "up") if dt == torch.bfloat16 else None
            call = lambda: fn(*args)  # noqa: E731
            return Case(call, lambda: plain(*args),
                        conv_flops(B, rows, cin, 2 * c0) + conv_flops(B, rows, c0, c2),
                        [x, sets, gamma, beta, a], lambda: (lib_a(), lib_b()), (first, second),
                        split_keys=("first", "second"),
                        split_labels=("conv00+conv10 + stats", "affine + conv01 + stats"),
                        parts=(lambda: block_parts(call, (first, second), info)
                               ) if info is not None else None,
                        exact=exact)
        return make

    conv01 = [("up0 conv01 (4,8) 256->256", (4, 8, w2, w2)),
              ("up1 conv01 (8,16) 128->128", (8, 16, w1, w1)),
              ("up2 conv01 (16,32) 64->64", (16, 32, w0, w0))]
    down = [("down0 s2 (16,32) 64->2x128", (16, 32, w0, w1)),
            ("down1 s2 (8,16) 128->2x256", (8, 16, w1, w2)),
            ("down2 s2 (4,8) 256->2x256", (4, 8, w2, w2))]
    ups = [("up0 (4,8) 256->2x256", (4, 8, w2, w2)), ("up1 (8,16) 256->2x128", (8, 16, w2, w1)),
           ("up2 (16,32) 128->2x64", (16, 32, w1, w0))]
    std = [("down0 conv01 (16,32) 128", (16, 32, w1)), ("down1 conv01 (8,16) 256", (8, 16, w2)),
           ("down2 conv01 (4,8) 256", (4, 8, w2))]
    cases = [("phase_conv_fwd", "conv_in (16,32) 3->64 +stats",
              phase_fwd(16, 32, 3, w0, with_act=False))]
    cases += [("phase_conv_fwd", f"{label} act+stats", phase_fwd(*shape, 2, (2,)))
              for label, shape in down]
    cases += [("phase_conv_fwd", f"{label} +stats", phase_fwd(*shape)) for label, shape in conv01]
    cases += [("up_dual_conv_fwd", f"{label} +stats", up_fwd(*shape)) for label, shape in ups]
    cases += [("ico_conv_s2s_fwd", f"{label} act+stats", std_fwd(*shape)) for label, shape in std]
    for which in ("dx", "dtaps"):
        name = f"phase_conv_{which}"
        cases += [(name, f"{label} act+fold", phase_bwd(which, *shape, 1, (0, 1, 2, 3)))
                  for label, shape in conv01]
        cases += [(name, f"{label} act+fold", phase_bwd(which, *shape, 2, (2,)))
                  for label, shape in down]
        cases += [(f"up_dual_conv_{which}", f"{label} fold", up_bwd(which, *shape))
                  for label, shape in ups]
        cases += [(f"ico_conv_s2s_{which}", f"{label} act+fold+bias", std_bwd(which, *shape))
                  for label, shape in std]
    # conv_in trains without dx, so its dtaps call emits the bias gradient
    cases += [("phase_conv_dtaps", "conv_in (16,32) 3->64 fold+bias",
               phase_bwd("dtaps", 16, 32, 3, w0, 1, (0, 1, 2, 3), with_act=False,
                         emit_gsum=True))]
    cases += [(f"pair_head_mse_{which}", "head (16,32) 64->3", head_mse(which, 16, 32, w0))
              for which in ("fwd", "bwd")]
    # a head wider than 256 channels (widths (320, ...)): g, h and e, whose
    # backward walks the cell in rounds
    wide = [(f"pair_head_mse_{which}", "head (16,32) 320->3", head_mse(which, 16, 32, 320))
            for which in ("fwd", "bwd")]
    wide += [("pair_head_bwd", "head (16,32) 320->3", head_bwd(16, 32, 320))]
    # the AE's DownBlocks after down0 run their stride-2 convs without an act
    # prologue (the pending BN-apply is down0's alone)
    no_act = [(f"phase_conv_{which}", f"{label} fold (no act)",
               phase_bwd(which, *shape, 2, (2,), with_act=False))
              for which in ("dx", "dtaps") for label, shape in down[1:]]
    no_act = [("phase_conv_fwd", f"{label} +stats (no act)", phase_fwd(*shape, 2, (2,), False))
              for label, shape in down[1:]] + no_act
    heads = ("VAE heads s2 (4,8) 256->2x512", (4, 8, w2, LATENT))
    up0 = ("VAE up0 (4,8) 512->2x256", (4, 8, LATENT, w2))
    vae = [("phase_conv_fwd", f"{heads[0]} +stats", phase_fwd(*heads[1], 2, (2,), False)),
           ("up_dual_conv_fwd", f"{up0[0]} +stats", up_fwd(*up0[1]))]
    vae += [(f"phase_conv_{which}", f"{heads[0]} fold",
             phase_bwd(which, *heads[1], 2, (2,), with_act=False)) for which in ("dx", "dtaps")]
    vae += [(f"up_dual_conv_{which}", f"{up0[0]} fold", up_bwd(which, *up0[1]))
            for which in ("dx", "dtaps")]
    vae += [("pair_head_fwd", "head (16,32) 64->3", head_fwd(B, 16 * z, 32 * z, w0)),
            ("pair_head_bwd", "head (16,32) 64->3", head_bwd(16, 32, w0))]
    # the merged route's kernels i, j, k at every site they run at, with the
    # fold (every site has stats); the DownBlocks after down0 and the VAE's
    # heads have no act prologue
    merged = [("phase_conv_bwd", f"{label} act+fold", merged_bwd("phase", *shape, 1))
              for label, shape in conv01]
    merged += [("phase_conv_bwd", f"{label} {'act+fold' if k == 0 else 'fold (no act)'}",
                merged_bwd("phase", *shape, 2, (2,), with_act=k == 0))
               for k, (label, shape) in enumerate(down)]
    merged += [("up_dual_conv_bwd", f"{label} fold", merged_bwd("up", *shape))
               for label, shape in ups]
    merged += [("ico_conv_s2s_bwd", f"{label} act+fold", merged_bwd("std", shape[0], shape[1],
                                                                    shape[2], shape[2]))
               for label, shape in std]
    vae += [("phase_conv_bwd", f"{heads[0]} fold",
             merged_bwd("phase", *heads[1], 2, (2,), with_act=False)),
            ("up_dual_conv_bwd", f"{up0[0]} fold", merged_bwd("up", *up0[1]))]
    # the phase chain (the AE's, and the VAE trunk's down0-1): m at the
    # DownBlocks with the fold in-kernel and (kernel_geff="") without; conv01
    # as the phase conv at the level-(s-1) phases, also merged (i); l at
    # each group it folds there (conv01 and m's outputs, per set; the
    # decoder's conv01 at (16,32) 64)
    chain = []
    for k, (label, (h, w, cin, cout)) in enumerate(down):
        label = label.replace("s2", "s2 split")
        tail = "" if k == 0 else " (no act)"
        chain.append(("ds2s_fwd", f"{label} {'act+' if k == 0 else ''}stats{tail}",
                      split_fwd(h, w, cin, cout, k == 0)))
        for which in ("dx", "dtaps"):
            chain += [(f"ds2s_{which}", f"{label} {'act+' if k == 0 else ''}{f}{tail}",
                       split_bwd(which, h, w, cin, cout, k == 0, f == "fold"))
                      for f in ("fold", "no fold")]
    conv01_chain = [("down0 conv01 (8,16) 128->128", (8, 16, w1, w1)),
                    ("down1 conv01 (4,8) 256->256", (4, 8, w2, w2)),
                    ("down2 conv01 (2,4) 256->256", (2, 4, w2, w2))]
    for label, shape in conv01_chain:
        chain.append(("phase_conv_fwd", f"{label} act+stats", phase_fwd(*shape)))
        for which in ("dx", "dtaps"):
            chain += [(f"phase_conv_{which}", f"{label} act+{f}",
                       phase_bwd(which, *shape, 1, _ALL, fold=f == "fold"))
                      for f in ("fold", "no fold")]
        chain.append(("phase_conv_bwd", f"{label} act+fold", merged_bwd("phase", *shape, 1)))
    chain += [("stats_geff", "down0 (8,16) 4x128", geff(8, 16, w1, fold_cost=(16, 32, w0))),
              ("stats_geff", "down1 (4,8) 4x256", geff(4, 8, w2)),
              ("stats_geff", "down2 (2,4) 4x256", geff(2, 4, w2)),
              ("stats_geff", "up2 conv01 (16,32) 4x64", geff(16, 32, w0))]
    # the decoder's chain: n at up1 and up2, the fold in the kernels and not
    for label, (h, w, cin, cout) in ups[1:]:
        label = label.replace(" (", " pair (")
        chain.append(("up_pair_fwd", f"{label} +stats", pair_fwd(h, w, cin, cout)))
        for which in ("dx", "dtaps"):
            chain += [(f"up_pair_{which}", f"{label} {f}",
                       pair_bwd(which, h, w, cin, cout, f == "fold"))
                      for f in ("fold", "no fold")]
    # the merged blocks: o at every UpBlock, p at every DownBlock (an act
    # prologue at down0 only; the VAE's encoder has down0-1)
    blocks = [("up_block_fwd", f"{label}, conv01 {shape[3]}", block("up", *shape, shape[3]))
              for label, shape in ups]
    blocks += [("dn_block_fwd", f"{label}, conv01 {shape[3]}{'' if k == 0 else ' (no act)'}",
                block("down", *shape, shape[3], k == 0)) for k, (label, shape) in enumerate(down)]
    vae += [("up_block_fwd", f"{up0[0]}, conv01 {w2}", block("up", *up0[1], w2))]
    # the standard conv at stride 2 (fused_ico_conv_s2s's own entry point; the
    # model routes stride 2 elsewhere) at the DownBlocks' stride-2 shapes:
    # the forward at the serving batch and with stats at the training batch,
    # with and without act; dx, dtaps and k with the fold in and out
    s2 = []
    for label, (h, w, cin, cout) in down:
        label = label.replace("s2 (", "std s2 (").replace("2x", "")
        s2.append(("ico_conv_s2s_fwd", f"{label} act B={BATCH}",
                   std_s2("fwd", h, w, cin, cout, batch=BATCH)))
        s2 += [("ico_conv_s2s_fwd", f"{label} {'act+' if act else ''}stats",
                std_s2("fwd", h, w, cin, cout, with_act=act)) for act in (True, False)]
        s2 += [(f"ico_conv_s2s_{which}", f"{label} act+{f}",
                std_s2(which, h, w, cin, cout, fold=f == "fold"))
               for which in ("dx", "dtaps", "bwd") for f in ("fold", "no fold")]
    return [(name, relabel(label), make, group) for name, label, make, group in
            [(*c, "AE") for c in cases + merged + blocks]
            + [(*c, "std s2") for c in s2]
            + [(*c, "AE no act") for c in no_act]
            + [(*c, "VAE") for c in vae] + [(*c, "chain") for c in chain]
            + [(*c, "wide head") for c in wide]]


def flat(out):
    """Nested tuples/lists of tensors (None allowed) -> list of tensors."""
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat(o)]


def bound(case: Case, outputs, dt):
    """(ms, "bytes" or "operations"): the larger of the bytes the function
    must move (each input read once, each output written once) over the
    memory rate, and its FLOPs over the peak for its dtype."""
    nbytes = sum(t.numel() * t.element_size() for t in case.inputs + outputs)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, case.flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_vs_plain(card: str, cases, phase: str, reps: int = 20, lean: bool = False) -> dict:
    """Phases 3 and 4. Returns per kernel its largest max_abs_err over its
    cases, their count and, summed over its shapes in bf16: ms and plain_ms
    (median times), bound_ms (with what bounds the largest share of it),
    library_ms (None where no cuDNN call does the same work) and, for a
    merged kernel, split_ms (the split pair: split_dx_ms + split_dtaps_ms
    for a merged backward, split_first_ms + split_second_ms for a merged
    block); ``by_shapes`` holds the same sums per group of shapes.
    ``lean`` (the s=6/7 cases): every case against its plain version and
    the bf16 ones against the split route, the kernel and the plain version
    timed in bf16 only (one warm-up), no library, split or parts timing."""
    def sums():
        return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {}, "library_ms": None}

    def add(s, key, v):
        s[key] = (s.get(key) or 0.0) + v

    stats = collections.defaultdict(lambda: {"max_abs_err": 0.0, "cases": 0, **sums(),
                                             "by_shapes": {}})
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, label, make, group in cases:
        for dt in (torch.float32, torch.bfloat16):
            case = make(dt, gen)
            got, ref = flat(case.kernel()), flat(case.plain())
            torch.cuda.synchronize()
            if len(got) != len(ref):
                raise AssertionError(f"{name} {label}: {len(got)} outputs, plain {len(ref)}")
            # each output is held against its own max|ref|
            errs = [((g.float() - r.float()).abs().max().item(), r.float().abs().max().item())
                    for g, r in zip(got, ref)]
            rel, err, scale = max((e / s if s else (math.inf if e else 0.0), e, s)
                                  for e, s in errs)
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            if lean:
                case.library, case.split, case.compare, case.parts = None, None, {}, None
            warm = 1 if lean else 3
            if lean and dt != torch.bfloat16:
                ms = plain_ms = math.nan
            else:
                ms, plain_ms = cuda_ms(case.kernel, reps, warm), cuda_ms(case.plain, reps, warm)
            event = ""
            # the events measured the wrapper: the trace gives the kernel
            if case.short and not math.isnan(ms):
                event, ms = f" (CUDA events around one call: {ms:.4f} ms)", trace_ms(case.kernel)
            lib_ms = cuda_ms(case.library, reps) if case.library is not None else None
            split_ms = [cuda_ms(f, reps) for f in case.split] if case.split else None
            compare_ms = {k: cuda_ms(f, reps) for k, f in case.compare.items()}
            b_ms, b_by = bound(case, got, dt)
            tag = "bf16" if dt == torch.bfloat16 else "fp32"
            lib = ("none" if lib_ms is None else
                   f"{lib_ms:.4f} ms (cuDNN, contraction only, on a haloed input)")
            split = ("" if split_ms is None else
                     f", split pair {sum(split_ms):.4f} ms ("
                     + ", ".join(f"{k} {v:.4f}" for k, v in zip(case.split_labels, split_ms))
                     + ")")
            split += "".join(f", {k} {v:.4f} ms" for k, v in compare_ms.items())
            print(f"[{phase}] {name} {label} {tag}: worst of {len(got)} outputs "
                  f"max_abs_err={err:.3e} max|ref|={scale:.3e} rel={rel:.3e} tol={TOL[dt]:.0e} "
                  f"({TOL_WHY[dt]}); kernel {ms:.4f} ms{event}, plain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}), library {lib}{split} [{card}]", flush=True)
            if not finite or not rel <= TOL[dt]:
                raise AssertionError(f"{name} {label} {tag}: error {err} over tolerance "
                                     f"{TOL[dt]} x {scale} (finite={finite})")
            if case.exact is not None and dt == torch.bfloat16:
                print(f"[{phase}] {name} {label} {tag}: {case.exact()} equal the split route's "
                      f"bit for bit [{card}]", flush=True)
            p = case.parts() if case.parts is not None else None
            if p is not None and "block_ms" in p:
                print(f"[{phase}] {name} {label} {tag} parts (profiler trace, per call): the "
                      f"cooperative kernel {p['block_ms']:.4f} ms against the split pair's "
                      f"kernels {p['split_device_ms']:.4f} ms "
                      f"({p['block_ms'] / p['split_device_ms']:.3f}x); {p['registers']} "
                      f"registers a thread, {p['blocks_per_sm']} blocks an SM, {p['smem_bytes']} "
                      f"B shared, {p['local_bytes']} B local [{card}]", flush=True)
            elif p is not None and "head_ms" in p:
                print(f"[{phase}] {name} {label} {tag} parts (profiler trace, per call): main "
                      f"pass {p['head_ms']:.4f} ms = {p['head_gbs']:.1f} GB/s (bound "
                      f"{p['head_bound_ms']:.4f} ms, bytes, at {PEAK_BYTES / 1e9:.0f} GB/s), "
                      f"pole pass {p['poles_ms']:.4f} ms, partial rows' sum {p['sum_ms']:.4f} "
                      f"ms; whole call {ms:.4f} ms [{card}]", flush=True)
            elif p is not None:
                pack = f"tap pack {p['pack_ms']:.4f} ms, " if p["pack_ms"] else ""
                if "adjoint_ms" in p:
                    pack += (f"upsample adjoint pass {p['adjoint_ms']:.4f} ms (bound "
                             f"{p['adjoint_bound_ms']:.4f} ms, bytes), ")
                device = f"device {p['device_ms']:.4f} ms"
                if "split_device_ms" in p:
                    device += (f" against the split route's kernels {p['split_device_ms']:.4f} ms"
                               f" ({p['device_ms'] / p['split_device_ms']:.3f}x)")
                print(f"[{phase}] {name} {label} {tag} parts (profiler trace, per call): operand "
                      f"pass {p['operand_ms']:.4f} ms (bound {p['operand_bound_ms']:.4f} ms, "
                      f"bytes), {pack}tensor-core GEMM {p['gemm_ms']:.4f} ms = "
                      f"{p['gemm_tflops']:.1f} TFLOP/s (bound {p['gemm_bound_ms']:.4f} ms, "
                      f"operations), partials' sum {p['sum_ms']:.4f} ms, {device}; whole call "
                      f"{ms:.4f} ms against cuDNN {lib_ms:.4f} ms; GEMM {p['registers']} "
                      f"registers a thread, {p['blocks_per_sm']} blocks an SM, "
                      f"{p['smem_bytes']} B shared, {p['local_bytes']} B local [{card}]",
                      flush=True)
            if p is not None:
                stats[name].setdefault("parts", {})[f"{label} {tag}"] = p
            stats[name]["max_abs_err"] = max([stats[name]["max_abs_err"]] + [e for e, _ in errs])
            stats[name]["cases"] += dt == torch.bfloat16  # shapes, each run in both dtypes
            if dt == torch.bfloat16:
                for s in (stats[name], stats[name]["by_shapes"].setdefault(group, sums())):
                    s["ms"] += ms
                    s["plain_ms"] += plain_ms
                    s["bound_ms"] += b_ms
                    s["bound_by"][b_by] = s["bound_by"].get(b_by, 0.0) + b_ms
                    if lib_ms is not None:
                        add(s, "library_ms", lib_ms)
                    if split_ms is not None:
                        add(s, "split_ms", sum(split_ms))
                        for key, v in zip(case.split_keys, split_ms):
                            add(s, f"split_{key}_ms", v)
                    for k, v in compare_ms.items():
                        s.setdefault("compare_ms", {})[f"{label}: {k}"] = v
            del case, got, ref
    for s in stats.values():
        for t in (s, *s["by_shapes"].values()):
            t["bound_by"] = max(t["bound_by"], key=t["bound_by"].get)
    return stats


def stride2_op(card: str) -> dict:
    """Path "std s2 train (op)": the standard conv at stride 2 through its
    user entry point, ``fused_ico_conv_s2s(..., stride=2)`` with the act and
    the stats and its gradient (the split backward, the merged one k, and
    the fold outside the kernels), at the DownBlocks' stride-2 shapes (B=36;
    inputs (32,64) 64->128, (16,32) 128->256, (8,16) 256->256), in bfloat16
    and float32. Every output and gradient finite; in float32 each against
    autograd of the plain route (the act, ``ops/conv.py:ico_conv_s2s`` at
    stride 2, the stats as sums) on the same card tensors, within TOL.
    Returns the run's kernel launches."""
    from geniconet_tpu_torch.ops.conv import ico_conv_s2s
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.ops.kernels.fused import fused_ico_conv_s2s

    (w0, w1, w2), B = WIDTHS, TRAIN_BATCH
    shapes = [(SUBDIVISIONS, w0, w1), (SUBDIVISIONS - 1, w1, w2), (SUBDIVISIONS - 2, w2, w2)]
    gen = torch.Generator(device="cuda").manual_seed(3)
    routes = {"split": {}, "merged": {"merged_bwd": True}, "fold outside": {"kernel_geff": "0"}}
    worst = 0.0
    build.reset_launches()
    for s, cin, cout in shapes:
        for dt in (torch.float32, torch.bfloat16):
            x = _rnd(gen, B, 5, 2**s, 2 ** (s + 1), cin, dtype=dt)
            (t, b), (mul, add) = _taps(gen, cin, cout, dt), _act(gen, cin)
            ry = _rnd(gen, B, 5, 2 ** (s - 1), 2**s, cout)
            rs = _rnd(gen, 2, cout, scale=1e-3)
            leaves = [v.detach().clone().requires_grad_() for v in (x, t, b, mul, add)]

            def loss_of(y, st):
                return (y.float() * ry).sum() + (st * rs).sum()

            grads = {}
            for name, kw in routes.items():
                ins = [v.detach().clone().requires_grad_() for v in leaves]
                y, st = fused_ico_conv_s2s(ins[0], ins[1], ins[2], s, "average", 2,
                                           act=(ins[3], ins[4]), with_stats=True, **kw)
                got = torch.autograd.grad(loss_of(y, st), ins)
                if not all(bool(torch.isfinite(v).all()) for v in (y, st, *got)):
                    raise AssertionError(f"std s2 op {name} s={s} {dt}: non-finite outputs")
                grads[name] = (y, st, *got)
            if dt == torch.float32:
                ins = [v.detach().clone().requires_grad_() for v in leaves]
                xa = torch.relu(ins[0] * ins[3] + ins[4])
                y = ico_conv_s2s(xa, ins[1], ins[2], s, 2, "average")
                st = torch.stack([y.sum(dim=(0, 1, 2, 3)), (y * y).sum(dim=(0, 1, 2, 3))])
                ref = (y, st, *torch.autograd.grad(loss_of(y, st), ins))
                for name, got in grads.items():
                    for key, u, v in zip(("y", "stats", "dx", "dtaps", "dbias", "d_mul",
                                          "d_add"), got, ref):
                        err, scale = (u - v).abs().max().item(), v.abs().max().item()
                        worst = max(worst, err / scale)
                        if err > TOL[dt] * scale:
                            raise AssertionError(f"std s2 op {name} s={s}: {key} error {err} "
                                                 f"over {TOL[dt]} x {scale}")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"[std s2 op] fused_ico_conv_s2s(stride=2) forward + gradient at 3 shapes x 2 dtypes "
          f"x (split, merged, fold outside); float32 against the plain route's autograd: worst "
          f"{worst:.3e} of max|ref| (tol {TOL[torch.float32]:.0e}); launches {launches} "
          f"[{card}]", flush=True)
    return launches


def check_mesh(vertices, n: int, what: str):
    import numpy as np

    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    if v.shape[0] != n or not np.isfinite(v).all():
        raise AssertionError(f"{what}: {v.shape[0]} vertices (want {n}), "
                             f"finite={bool(np.isfinite(v).all())}")


def model_config(model: str, dtype_name: str):
    from geniconet_tpu_torch import Config

    cfg = Config()
    cfg.model.name = model
    cfg.model.subdivisions, cfg.model.widths = SUBDIVISIONS, WIDTHS
    cfg.model.latent_features = LATENT
    cfg.model.compute_dtype = dtype_name
    return cfg


def serve(model: str, dtype_name: str, variables, card: str, phase_chain=None):
    """Phase 5 for one model and compute dtype: load + requests. Returns the state."""
    from geniconet_tpu_torch import geometry as ico
    from geniconet_tpu_torch.app.server import handle_api
    from geniconet_tpu_torch.app.state import AppState

    cfg = model_config(model, dtype_name)
    cfg.data.synthetic = N_MESHES
    V = ico.num_vertices(SUBDIVISIONS)
    tag = f"serve {model} {dtype_name}{' phase_chain=' + phase_chain if phase_chain else ''}"
    st = AppState(device="cuda")
    t0 = time.perf_counter()
    info = st.load(cfg, variables=variables, phase_chain=phase_chain)
    torch.cuda.synchronize()
    print(f"[{tag}] load: {info['n']} meshes, latent {info['latent_shape']}, "
          f"{time.perf_counter() - t0:.2f} s (dataset build included)", flush=True)
    if handle_api(st, "/api/info", {})["n"] != N_MESHES or info["is_vae"] != cfg.model.is_vae:
        raise AssertionError("/api/info: wrong mesh count or model kind")
    requests = [
        ("/api/mesh", {"i": 0, "coloring": "patch"}),
        ("/api/interpolate", {"i": 0, "j": 1, "t": 0.5, "coloring": "patch"}),
        ("/api/explore", {"i": 0, "channel": 3, "delta": 1.5, "coloring": "patch"}),
    ]
    if cfg.model.is_vae:
        requests.append(("/api/regenerate", {"i": 1, "k": 1.0, "seed": 3, "coloring": "patch"}))
    for path, body in requests:
        check_mesh(handle_api(st, path, body)["vertices"], V, f"{tag} {path}")
    out = handle_api(st, "/api/decode", {"indices": list(range(8))})
    if len(out["vertices"]) != 8:
        raise AssertionError(f"/api/decode returned {len(out['vertices'])} meshes")
    for k, v in enumerate(out["vertices"]):
        check_mesh(v, V, f"{tag} /api/decode mesh {k}")
    print(f"[{tag}] /api/info {' '.join(p for p, _ in requests)} /api/decode(8): "
          f"every mesh {V} finite vertices [{card}]", flush=True)
    return st


def plain_route_check(st, card: str):
    """Two float32 decodes on the card against the same model on the CPU."""
    model = st.cfg.model.name
    from geniconet_tpu_torch.ops.vertices import grid_to_vertices

    z = st.latents[:2]
    got = st.decode_batch(z)
    cpu_model = copy.deepcopy(st.model).cpu()
    with torch.inference_mode():
        ref = grid_to_vertices(cpu_model.decode(torch.from_numpy(z)), SUBDIVISIONS).numpy()
    err = float(abs(got - ref).max())
    scale = float(abs(ref).max())
    print(f"[serve {model} float32] kernel route vs plain route on CPU, 2 meshes: "
          f"max_abs_err={err:.3e} "
          f"max|ref|={scale:.3e} tol=1e-4 x max|ref| [{card}]", flush=True)
    if not err <= 1e-4 * scale:
        raise AssertionError(f"kernel route differs from the plain route: {err}")


def chain_cache_check(chained, unchained, dtype_name: str, card: str):
    """The latent cache built through the phase chain against the unchained
    one (the VAE's mu and logvar), and, where the decoder is chained, 4
    decodes of the unchained latents: eval BatchNorm uses the running
    statistics, so the chained and unchained models compute one function
    with other sums; within TOL of max|ref|."""
    import numpy as np

    dt = torch.float32 if dtype_name == "float32" else torch.bfloat16
    pairs = [(f"latent cache of {N_MESHES} meshes", chained.latents, unchained.latents)]
    if unchained.logvars is not None:
        pairs.append((f"logvar cache of {N_MESHES} meshes", chained.logvars, unchained.logvars))
    chain = chained.model.phase_chain
    if chain in ("1", "dec"):
        z = unchained.latents[:4]
        pairs.append(("decode of 4 latents", chained.decode_batch(z), unchained.decode_batch(z)))
    for what, got, ref in pairs:
        err = float(np.abs(got - ref).max())
        scale = float(np.abs(ref).max())
        print(f"[serve {chained.cfg.model.name} {dtype_name} phase_chain={chain!r}] {what} "
              f"vs the unchained model's: max_abs_err={err:.3e} "
              f"max|ref|={scale:.3e} tol={TOL[dt]:.0e} x max|ref| ({TOL_WHY[dt]}) [{card}]",
              flush=True)
        if not err <= TOL[dt] * scale:
            raise AssertionError(f"the chained {what} differs from the unchained one: {err}")


def encode_decode(st, x):
    """The model's encode then decode of x (the VAE decodes its mu)."""
    z = st.model.encode(x)
    return st.model.decode(z[0] if isinstance(z, tuple) else z)


def timings(st, dtype_name: str, card: str):
    """Phase 6: p50 single-mesh decode latency, encode+decode meshes/s at B=16."""
    lat = []
    for i in range(40):
        t0 = time.perf_counter()
        st.decode_latent(st.latents[i % N_MESHES])
        lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat[5:]) * 1e3
    x = torch.as_tensor(st.dataset.inputs[:BATCH], device="cuda")
    with torch.inference_mode():
        ms = cuda_ms(lambda: encode_decode(st, x), reps=10)
    chain = f" phase_chain={st.model.phase_chain!r}" if st.model.phase_chain else ""
    print(f"[timing {st.cfg.model.name} {dtype_name}{chain}] p50 single-mesh decode latency {p50:.3f} ms (host clock, "
          f"latent in -> vertices out); encode+decode B={BATCH}: {ms:.3f} ms = "
          f"{BATCH / ms * 1e3:.1f} meshes/s [{card}]", flush=True)


def kernel_group(event: dict) -> str:
    """The profile's row for one device event of a Chrome trace."""
    name = event["name"]
    if event.get("cat") != "kernel":
        return event.get("cat", "other")  # gpu_memcpy, gpu_memset
    dtype = "bf16" if "bfloat16" in name else "fp32"
    # the bf16 tensor-core kernels: the operand passes (the up conv's
    # forward's and d's, n's; b's and f's), the forward's tap pack, the GEMMs
    # (by the rows they read: the up conv's grid, the pair, the phase conv's
    # phases, the standard conv's grid)
    pair = "PairCells" in name
    j = "MergedUp" in name  # the merged up-conv backward's passes and GEMMs
    i = "MergedPhase" in name  # the merged phase-conv backward's
    k = "MergedStd" in name  # the merged standard-conv backward's
    which = "(n)" if pair else "(j)" if j else "(d)"
    grid = ("(f)" if "StdGrid" in name else "(b)" if "PhaseGrid" in name
            else "(m)" if "SplitGrid" in name else "(i)" if i else "(k)" if k else None)
    # the dx of a, c, f, m and n: by Tag the phase conv's (a), the standard
    # conv's (f), the phase chain's stride-2 conv's (m), the pair's (n) or
    # the up conv's (c); i's, j's and k's cotangent passes by their own
    dx = ("(a)" if "PhaseGrid" in name else "(f)" if "StdGrid" in name
          else "(m)" if "SplitGrid" in name else "(n)" if pair else "(i)" if i
          else "(j)" if j else "(k)" if k else "(c)")
    if "mma_bwd<" in name:  # i, j, k: the dtaps and the dx tiles in one launch
        return f"mma_bwd<bf16> {'(j)' if j else '(k)' if k else '(i)'}"
    if "up_operand_pass" in name or "pair_join_pass" in name:
        return f"up_operand_pass<{dtype}> {which}"
    if "grid_operand_pass" in name:
        return f"grid_operand_pass<{dtype}> {grid}"
    if "cot_operand_pass" in name:
        return f"cot_operand_pass<bf16> {dx}"
    if "up_adjoint_pass" in name:
        return f"up_adjoint_pass {'(j)' if j else '(c)'}"
    if "pair_adjoint_pass" in name:  # n's: c's adjoint with the pair tail
        return "pair_adjoint_pass (n)"
    if "mma_dtaps" in name:
        return f"mma_dtaps<bf16> {grid or which}"
    if "mma_conv" in name and ("DxEpi" in name or "DuEpi" in name):
        return f"mma_conv_dx<bf16> {dx}"
    if "mma_conv" in name:  # the forwards' GEMM (mma_conv with FwdEpi; m's SplitFwdEpi)
        return f"mma_conv_fwd<bf16> {grid or ('(n)' if pair else '(up conv)')}"
    if "pack_taps_t" in name:
        return f"pack_taps {dx}"
    if "pack_taps" in name:
        return f"pack_taps {grid or '(up conv, n)'}"
    loader = "UpLoad" if "UpLoad" in name else "GridLoad"
    # kernel m: the phase conv's GEMMs with the split store / split loader;
    # kernel n: the up conv's with the pair loader / the pair's dx epilogue
    split = ", split> (m)" if "true>" in name else ">"
    if "PairCells" in name or "DxPairOut" in name:
        split = ", pair> (n)"
    if "conv_gemm" in name:
        # the float32 phase_conv_fwd and ico_conv_s2s_fwd share the GridLoad
        # instantiation; in bf16 they run mma_conv_fwd (b), (f)
        return f"conv_gemm<{dtype}, {loader}{split}"
    if "dx_gemm" in name:  # in bf16 a, c and f run mma_conv_dx
        return f"dx_gemm<{dtype}{split}"
    if "dtaps_gemm" in name:
        return f"dtaps_gemm<{dtype}, {loader}{split}"
    if "stats_geff" in name:
        return "stats_geff (l)"
    if "merged_bwd" in name:  # float32 i and k share the GridLoad instantiation
        return f"merged_bwd<{dtype}, {loader}>"
    if "two_pass_block" in name:  # the merged blocks: o (UpLoad), p (GridLoad)
        kind = "mma_" if "mma_two_pass_block" in name else ""  # bf16: the tensor cores
        return f"{kind}two_pass_block<{dtype}, {loader}> ({'o' if loader == 'UpLoad' else 'p'})"
    if "sum_rows" in name or "colsum" in name or "sum_chunks" in name:
        return "sum_rows + colsum (cross-block sums)"
    if "pair_head_kernel" in name:
        return "pair_head_kernel"
    if "phead_bwd" in name:
        return "phead_bwd (head bwd, kernel e)"
    if "phmse_bwd" in name:
        return "phmse_bwd (head+MSE bwd, kernel h)"
    if "phmse_fwd" in name:
        return "phmse_fwd (head+MSE fwd, kernel g)"
    if "phmse_poles" in name:
        return "phmse_poles (pole pass, g and h)"
    if any(k in name.lower() for k in ("cudnn", "xmma", "cutlass", "gemm", "conv")):
        return "cuDNN / cuBLAS (plain route)"
    return "PyTorch ops"


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in the trace's µs, as ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def device_profile(workloads, card: str):
    """Phase 8: device time per kernel group and the idle share, for each
    (tag, fn, iterations) workload.

    Idle share = 1 - (device busy time per iteration, from the union of the
    trace's device events) / (host wall time per iteration, measured without
    the profiler, synchronised at both ends)."""
    from torch.profiler import ProfilerActivity, profile

    from geniconet_tpu_torch.ops.kernels import build

    out_dir = Path(__file__).resolve().parent / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    for tag, fn, iters in workloads:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
        build.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        launches = {k: v / iters for k, v in sorted(build.LAUNCHES.items())}
        trace = out_dir / f"{tag}.json"
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if not events:
            raise AssertionError(f"profile {tag}: the trace holds no device events")
        busy = busy_ms((e["ts"], e["ts"] + e["dur"]) for e in events) / iters
        span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3 / iters
        groups = collections.defaultdict(lambda: [0, 0.0])
        for e in events:
            g = groups[kernel_group(e)]
            g[0] += 1
            g[1] += e["dur"] / 1e3
        summed = sum(ms for _, ms in groups.values()) / iters
        check_device_launches(tag, groups, launches, iters)
        print(f"[profile bfloat16 {tag}] {iters} iterations: host wall {wall:.4f} ms/iter "
              f"(profiler off); device busy {busy:.4f} ms/iter (union of {len(events) / iters:.1f} "
              f"device events/iter, summed {summed:.4f} ms); device idle share "
              f"{1 - busy / wall:.4f}; first-to-last device event {span:.4f} ms/iter "
              f"(profiler on); wrapper launches/iter {launches} [{card}]", flush=True)
        for name, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
            print(f"[profile bfloat16 {tag}]   {name}: {n / iters:.1f} calls/iter, "
                  f"{ms / iters:.4f} ms/iter, {ms / iters / busy:.4f} of busy", flush=True)
        glue = collections.Counter()
        for e in events:
            if kernel_group(e) in ("PyTorch ops", "cuDNN / cuBLAS (plain route)"):
                glue[e["name"][:80]] += e["dur"] / 1e3 / iters
        for name, ms in glue.most_common(5):
            print(f"[profile bfloat16 {tag}]     top {name}: {ms:.4f} ms/iter", flush=True)


# the profile rows of the device launches of the bf16 grid convs, by kernel
# tag: their wrappers (forward, dtaps: b, f, and m's forward and dtaps, which
# share the SplitGrid operand pass), each call's operand pass and its
# tensor-core GEMM (the forward's or the dtaps')
GRID_ROWS = {"(b)": ("phase_conv_fwd", "phase_conv_dtaps"),
             "(f)": ("ico_conv_s2s_fwd", "ico_conv_s2s_dtaps"),
             "(m)": ("ds2s_fwd", "ds2s_dtaps")}
# ... and of the bf16 dx of a, c and f: each call's cotangent pass and
# GEMM (and c's upsample adjoint), by wrapper
DX_ROWS = {"(a)": "phase_conv_dx", "(c)": "up_dual_conv_dx", "(f)": "ico_conv_s2s_dx"}
# ... and of the bf16 merged backwards (i, k: their two passes and the one
# launch of both GEMMs; j: the same and its upsample adjoint), m's bf16
# dx (a's pass and GEMM over the split cotangent) and n's (c's pass and
# GEMM, then the adjoint pass with the pair tail), by wrapper
SPLIT_ROUTE_ROWS = {
    "phase_conv_bwd": ("cot_operand_pass<bf16> (i)", "grid_operand_pass<bf16> (i)",
                       "mma_bwd<bf16> (i)"),
    "up_dual_conv_bwd": ("cot_operand_pass<bf16> (j)", "up_operand_pass<bf16> (j)",
                         "mma_bwd<bf16> (j)", "up_adjoint_pass (j)"),
    "ico_conv_s2s_bwd": ("cot_operand_pass<bf16> (k)", "grid_operand_pass<bf16> (k)",
                         "mma_bwd<bf16> (k)"),
    "ds2s_dx": ("cot_operand_pass<bf16> (m)", "mma_conv_dx<bf16> (m)"),
    "up_pair_dx": ("cot_operand_pass<bf16> (n)", "mma_conv_dx<bf16> (n)",
                   "pair_adjoint_pass (n)"),
}
# the SIMT kernels no bf16 window may run: a's, c's, f's dx, b's and f's
# dtaps and the grid forwards (o's and p's tiles have rows of their own),
# the merged tiles of i, j and k, m's split forward, dx and dtaps, and n's
# pair dx
BF16_SIMT = ("dx_gemm<bf16>", "conv_gemm<bf16, GridLoad>", "dtaps_gemm<bf16, GridLoad>",
             "merged_bwd<bf16, UpLoad>", "merged_bwd<bf16, GridLoad>",
             "conv_gemm<bf16, GridLoad, split> (m)", "dtaps_gemm<bf16, GridLoad, split> (m)",
             "dx_gemm<bf16, split> (m)", "dx_gemm<bf16, pair> (n)")


def check_device_launches(tag, groups, launches, iters):
    """Fail unless, in a profiled bf16 window, the calls of the grid convs'
    forward and dtaps (``launches``, wrapper calls an iteration; b, f, m's)
    ran their operand pass (one a call of either) and their tensor-core GEMM
    (``mma_conv_fwd`` a forward, ``mma_dtaps`` a dtaps), each call of a, c
    and f its cotangent pass and ``mma_conv_dx`` (c also its upsample
    adjoint), and each call of i, j, k, m's dx and n's dx the rows of
    ``SPLIT_ROUTE_ROWS``: each row present where its wrappers ran, and at
    most once a call (a trace may lose events, never add them); and no
    launch of a ``BF16_SIMT`` kernel."""
    def check(row, calls, wrappers):
        n = groups[row][0] / iters if row in groups else 0
        if (calls > 0) != (n > 0) or n > calls:
            raise AssertionError(f"profile {tag}: {row} {n} a step for {calls} calls of "
                                 f"{' + '.join(wrappers)}")

    for which, (fwd, dtaps) in GRID_ROWS.items():
        n_fwd, n_dtaps = launches.get(fwd, 0), launches.get(dtaps, 0)
        check(f"grid_operand_pass<bf16> {which}", n_fwd + n_dtaps, (fwd, dtaps))
        check(f"mma_conv_fwd<bf16> {which}", n_fwd, (fwd,))
        check(f"mma_dtaps<bf16> {which}", n_dtaps, (dtaps,))
    for which, dx in DX_ROWS.items():
        n_dx = launches.get(dx, 0)
        check(f"cot_operand_pass<bf16> {which}", n_dx, (dx,))
        check(f"mma_conv_dx<bf16> {which}", n_dx, (dx,))
    check("up_adjoint_pass (c)", launches.get("up_dual_conv_dx", 0), ("up_dual_conv_dx",))
    for wrapper, rows in SPLIT_ROUTE_ROWS.items():
        for row in rows:
            check(row, launches.get(wrapper, 0), (wrapper,))
    for simt in BF16_SIMT:
        if simt in groups:
            raise AssertionError(f"profile {tag}: the SIMT {simt} ran")


def serving_workloads(st, tag="", b1=True):
    """encode+decode at B=16 and, with ``b1``, decode_latent at B=1 (the
    encoder's chain leaves the decoder as it is: its B=1 decode is the
    default's)."""
    x = torch.as_tensor(st.dataset.inputs[:BATCH], device="cuda")
    z = st.latents[0]

    def run():
        with torch.inference_mode():
            encode_decode(st, x)

    return [(f"encode_decode_B{BATCH}{tag}", run, 20),
            *([(f"decode_latent_B1{tag}", lambda: st.decode_latent(z), 20)] if b1 else [])]


def train_config(dtype_name: str, batch: int, model: str = "ico2ico"):
    cfg = model_config(model, dtype_name)
    cfg.train.batch_size = batch
    return cfg


def routing(route: str) -> dict:
    """The Trainer's routing options of a path suffix of ``ROUTES``."""
    return dict(zip(("merged_bwd", "phase_chain", "kernel_geff", "merged_block"), ROUTES[route]))


def train(model: str, dtype_name: str, variables, dataset, card: str, route: str = ""):
    """Phase 7 for one model, compute dtype and routing (a ``ROUTES`` key):
    TRAIN_STEPS Adam steps at B=36. Returns the trainer, its state, a fixed
    batch for the profile and the kernel launches."""
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.train.trainer import Trainer

    opts = routing(route)
    tr = Trainer(train_config(dtype_name, TRAIN_BATCH, model), device="cuda", **opts)
    st = tr.init_state(variables)
    batches = Batches(dataset, TRAIN_BATCH, drop_remainder=True, seed=0, device="cuda")

    def stream():
        while True:
            yield from batches.epoch()

    it = stream()
    losses, times = [], []
    build.reset_launches()
    for _ in range(TRAIN_STEPS):
        x, y, wt = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(st, x, y, wt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["total"]))
    launches = dict(build.LAUNCHES)
    ms = statistics.median(times[TRAIN_WARMUP:]) * 1e3
    tag = f"train {model} {dtype_name}"
    print(f"[{tag}] {TRAIN_STEPS} steps at B={TRAIN_BATCH}, s={SUBDIVISIONS}, widths {WIDTHS}"
          f"{f', latent {LATENT}' if tr.is_vae else ''}, pallas_blocks="
          f"{tr.model.pallas_blocks!r}, {', '.join(f'{k}={v!r}' for k, v in opts.items())}: "
          f"losses {[round(v, 6) for v in losses]}; step {ms:.3f} ms (median of the last "
          f"{TRAIN_STEPS - TRAIN_WARMUP}, host clock, synchronised) = "
          f"{TRAIN_BATCH / ms * 1e3:.1f} training meshes/s [{card}]", flush=True)
    print(f"[{tag}] kernel launches on the training path: {launches}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    check_launches(f"{'VAE' if tr.is_vae else 'AE'} train{route}", launches, TRAIN_STEPS)
    # on the merged route conv_in (no dx) keeps its dtaps kernel, and on the
    # decoder's chain only up0 runs the merged up conv (j): once a step each
    once = ("phase_conv_dtaps", *(("up_dual_conv_bwd",) if opts["phase_chain"] in ("1", "dec")
                                  else ()))
    wrong = {k: launches.get(k, 0) for k in once if launches.get(k, 0) != TRAIN_STEPS}
    if opts["merged_bwd"] and wrong:
        raise AssertionError(f"{tag}: launched {wrong} times, want once a step (conv_in; up0)")
    return tr, st, next(it), launches


def check_launches(path: str, launches, forwards=None):
    """Fail unless every kernel of the path launched at least once, and none
    that the path must not run; on the decoder's chain, n (up1, up2) twice
    as often as up0's forward kernel (the up conv, or o on the merged
    blocks), and that once a forward where ``forwards`` is known; on the
    merged blocks, o and p ``BLOCKS_PER_FORWARD`` times a forward."""
    missing = [k for k in PATH_KERNELS[path] if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing}")
    stray = [k for k in PATH_FORBIDDEN.get(path, ()) if launches.get(k, 0)]
    if stray:
        raise AssertionError(f"kernels the {path} path must not launch: {stray}")
    n = launches.get("up_pair_fwd", 0)
    up = launches.get("up_dual_conv_fwd", 0) + launches.get("up_block_fwd", 0)
    if "up_pair_fwd" in PATH_KERNELS[path] and (n != 2 * up or forwards not in (None, up)):
        raise AssertionError(f"the {path} path launched n {n} and up0's kernel {up} times "
                             f"({forwards} forwards): want n twice a forward, up0's once")
    if path in BLOCKS_PER_FORWARD and forwards is not None:
        got = tuple(launches.get(k, 0) for k in _BLOCKS)
        want = tuple(k * forwards for k in BLOCKS_PER_FORWARD[path])
        if got != want:
            raise AssertionError(f"the {path} path launched (o, p) {got} times in {forwards} "
                                 f"forwards: want {want}")


def routing_compare(variables, dataset, card: str, iters: int = 4):
    """Whole training steps (``Trainer.train_step``: forward, backward, Adam)
    at B=36 bf16 of each model under each of its routings, in turns: every
    routing once, then again in the reverse order. The AE's routings: the
    default (every block fused, the split backward kernels),
    ``merged_bwd="all"``, ``pallas_blocks="up0,up1,up2"`` (the encoder and
    the head on cuDNN and PyTorch ops), every chained ``ROUTES`` entry
    (the encoder's chain "chain", the decoder's "chain dec", both "chain
    all", on the split and merged routes, with the fold outside and on the
    merged blocks) and the merged blocks on the split and merged backward;
    the VAE's: the default, the merged, the encoder's chain, both chains
    and the merged blocks.
    Losses must be finite; prints each routing's median host-clock step
    time, synchronised."""
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.nn.models import IcoAE
    from geniconet_tpu_torch.train.trainer import Trainer

    chain = [(route.strip(" ()"), route, None) for route in ROUTES if "chain" in route]
    block = [(route.strip(" ()"), route, None) for route in ROUTES
             if "merged block" in route and "chain" not in route]
    routings = {"ico2ico": (("default", "", None), ("merged", " (merged)", None),
                            ("decoder-only", "", "up0,up1,up2"), *chain, *block),
                "ico2ico_vae": (("default", "", None), ("merged", " (merged)", None),
                                *(c for c in chain if c[0] in ("chain", "chain all")),
                                block[0])}
    x, y, wt = next(iter(Batches(dataset, TRAIN_BATCH, drop_remainder=True, seed=0,
                                 device="cuda").epoch()))
    for model, routes in routings.items():
        trainers = {}
        for name, route, blocks in routes:
            tr = Trainer(train_config("bfloat16", TRAIN_BATCH, model), device="cuda",
                         **routing(route))
            if blocks:
                tr.model = IcoAE(SUBDIVISIONS, WIDTHS, dtype=torch.bfloat16, pallas_blocks=blocks,
                                 device="cuda")
            trainers[name] = (tr, tr.init_state(variables[model]))
        names = [name for name, _, _ in routes]
        times = collections.defaultdict(list)
        for name in names + names[::-1]:
            tr, st = trainers[name]
            for i in range(iters + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(tr.train_step(st, x, y, wt)["total"])
                torch.cuda.synchronize()
                if i:  # the first step of each turn warms up
                    times[name].append(time.perf_counter() - t0)
                if not math.isfinite(loss):
                    raise AssertionError(f"{model} {name} routing: loss {loss}")
        for name, ts in times.items():
            ms = statistics.median(ts) * 1e3
            print(f"[train routing] {model} {name}: training step at B={TRAIN_BATCH} bf16 "
                  f"{ms:.3f} ms (median of {len(ts)}, two turns, host clock, synchronised) = "
                  f"{TRAIN_BATCH / ms * 1e3:.1f} meshes/s [{card}]", flush=True)


def train_step_check(model: str, variables, card: str, routes):
    """One float32 step at B=4 on the card, per routing in ``routes``
    ((``ROUTES`` key, planted) pairs), against the same step on the CPU
    (plain route, with the routing's ``phase_chain``): the loss and the new BatchNorm statistics within 1e-4 of
    max|ref|, every gradient within 1e-4·max|ref| plus twice the float32
    spread on it. That spread is measured on both sides: the largest change
    of a step's gradient when the batch's samples come in five other orders
    (the VAE's eps, fixed for the check, permuted with its samples, so that
    each order computes the same function), on the CPU and on the card (on
    the route under check), and on the CPU also when no block is fused
    (``pallas_blocks="none"``: masked 3×3 convs, the same function with
    other float32 sums inside each sample, which a reorder leaves alone).
    The card's own spread counts because its kernels sum in fixed blocks of
    rows, which a reorder of the samples regroups and the CPU's sums do not
    show; the VAE's normal term amplifies such differences. The BatchNorm
    backward at B=4 loses digits to cancellation (a float32 gradient leaf
    moves by up to 1e-2·max|ref| with the summation order alone), so a fixed
    bound would measure the conditioning, not the kernels. The bound is that
    loose only on some leaves, which the check names. The CPU's plain
    versions of the backward routes and fold placements are the same
    function, so one CPU reference serves each ``phase_chain`` (the spread,
    measured on the default's, serves every routing). To show that the check still catches a kernel error, the
    card's step then runs once per entry of ``planted``, with that kernel
    output 1% off: the check must read above its bound for each."""
    from unittest import mock

    import numpy as np

    from geniconet_tpu_torch.data.datasets import synthetic_dataset
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.nn import models
    from geniconet_tpu_torch.nn.models import IcoAE, IcoVAE
    from geniconet_tpu_torch.ops.kernels import fused
    from geniconet_tpu_torch.train.trainer import Trainer

    ds = synthetic_dataset(SUBDIVISIONS, 4, seed=1)
    is_vae = model.endswith("_vae")
    eps = torch.from_numpy(np.random.RandomState(2).randn(
        4, 5 * 2 ** (SUBDIVISIONS - 3), 2 ** (SUBDIVISIONS - 2), LATENT).astype(np.float32))

    def fixed_eps(order, device):
        if not is_vae:
            return contextlib.nullcontext()
        e = eps[order].to(device)
        return mock.patch.object(models, "reparameterize",
                                 lambda mu, logvar, generator=None: e * torch.exp(0.5 * logvar) + mu)

    def step(device, order, unfused=False, route=""):
        tr = Trainer(train_config("float32", 4, model), device=device, **routing(route))
        if unfused:  # "none" names no block: no block is fused
            kw = dict(pallas_blocks="none", device=device)
            tr.model = (IcoVAE(SUBDIVISIONS, WIDTHS, LATENT, **kw) if is_vae
                        else IcoAE(SUBDIVISIONS, WIDTHS, **kw))
        st = tr.init_state(variables)
        x, y, wt = next(iter(Batches(ds, 4, shuffle=False, device=device).epoch()))
        with fixed_eps(order, device):
            loss = float(tr.train_step(st, x[order], y[order], wt)["total"])
        grads = {k: p.grad.detach().cpu() for k, p in tr.model.named_parameters()}
        stats = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()
                 if k.endswith((".mean", ".var"))}
        return loss, grads, stats

    def spread_of(base, runs):
        out = {k: 0.0 for k in base}
        for args in runs:
            _, other, _ = step(*args)
            for k, ref in base.items():
                out[k] = max(out[k], (other[k] - ref).abs().max().item())
        return out

    refs = {None: step("cpu", [0, 1, 2, 3])}  # phase_chain -> the CPU's step
    ref_grads = refs[None][1]
    orders = [[3, 2, 1, 0], [1, 0, 3, 2], [2, 3, 0, 1], [0, 2, 1, 3], [1, 3, 0, 2]]
    cpu_spread = spread_of(ref_grads, [("cpu", o) for o in orders]
                           + [("cpu", [0, 1, 2, 3], True)])
    for route, planted in routes:
        chain = routing(route)["phase_chain"]
        if chain not in refs:
            refs[chain] = step("cpu", [0, 1, 2, 3], route=route)
        ref_loss, ref_grads, ref_stats = refs[chain]
        base = step("cuda", [0, 1, 2, 3], route=route)[1]
        card_spread = spread_of(base, [("cuda", o, False, route) for o in orders])
        bounds = {}  # leaf -> (bound, scale)
        for k, ref in ref_grads.items():
            # a conv's bias feeds a BatchNorm: its exact gradient is 0, so it
            # is held against its taps' scale
            conv_bias = "conv" in k.rsplit(".", 2)[-2] and k.endswith(".bias")
            scale = (ref_grads[k[: -len("bias")] + "taps"] if conv_bias else ref).abs().max().item()
            bounds[k] = (1e-4 * scale + 2 * max(cpu_spread[k], card_spread[k]), scale)

        def card_step(route=route, bounds=bounds, ref_loss=ref_loss, ref_grads=ref_grads,
                      ref_stats=ref_stats):
            """The card's step read against the bounds: (loss, worst error / its bound, leaf)."""
            loss, grads, stats = step("cuda", [0, 1, 2, 3], route=route)
            ratio = {"loss": abs(loss - ref_loss) / (1e-4 * abs(ref_loss))}
            for k, ref in ref_stats.items():
                ratio[k] = (stats[k] - ref).abs().max().item() / (1e-4 * ref.abs().max().item())
            for k, ref in ref_grads.items():
                ratio[k] = (grads[k] - ref).abs().max().item() / bounds[k][0]
            name, worst = max(ratio.items(), key=lambda kv: kv[1])
            return loss, worst, name

        tag = f"train {model} float32{route}"
        loss, worst, name = card_step()
        loose = {k: b / s for k, (b, s) in bounds.items() if b > 2e-3 * s}
        print(f"[{tag}] one step at B=4 on the card vs the CPU plain route"
              f"{' (eps fixed)' if is_vae else ''}: loss {loss:.6f} vs {ref_loss:.6f}; loss, "
              f"{len(ref_stats)} BatchNorm statistics within 1e-4·max|ref|, {len(ref_grads)} "
              f"gradients within 1e-4·max|ref| + 2x the larger float32 spread, the CPU's over "
              f"{len(orders)} other sample orders and the unfused routing or the card's over "
              f"the orders; largest error {worst:.3f} of its bound ({name}) [{card}]", flush=True)
        widest = sorted(loose.items(), key=lambda kv: -kv[1])[:4]
        print(f"[{tag}] {len(loose)} gradients have a bound above 2e-3·max|ref| "
              f"(widest: {', '.join(f'{k} {v:.2e}' for k, v in widest)}): this check holds "
              f"them loosely, and the kernels that make them only the kernel-vs-plain phase "
              f"holds at 1e-4", flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"{tag} step on the card differs from the CPU: {name} {worst}")
        missed = []
        for kernel, where, path, hit in planted:
            real = getattr(fused, kernel)

            def plant(*args, _real=real, _path=path, _hit=hit, **kwargs):
                r = _real(*args, **kwargs)
                return one_percent_off(r, _path) if _hit(args) else r

            with mock.patch.object(fused, kernel, plant):
                _, worst, name = card_step()
            print(f"[{tag}] planted fault, {kernel} 1% off at {where}: the check reads "
                  f"{worst:.3f} of its bound ({name}), "
                  f"{'caught' if worst > 1.0 else 'NOT caught'} [{card}]", flush=True)
            if not worst > 1.0:
                missed.append(f"{kernel} at {where}")
        if missed:
            raise AssertionError(f"the {tag} step check misses a planted 1% fault: {missed}")


# Kernel outputs the step checks' probes put 1% off, one at a time: (wrapper
# as ``fused`` calls it, where, index path of the output, which calls).
PLANTED = {
    "ico2ico": (
        ("ico_conv_s2s_dtaps", "down0-2 conv01, dtaps", (), lambda a: True),
        ("ico_conv_s2s_dx", "down0-2 conv01, dx", (0,), lambda a: True),
        ("ico_conv_s2s_dx", "down1 conv01, d_mul (to encoder.down1.bn00)", (1,),
         lambda a: a[0].shape[2] == 8),
        ("phase_conv_dtaps", "conv_in, dtaps", (0, 0), lambda a: a[0][0].shape[-1] == 3),
    ),
    "ico2ico_vae": (
        ("pair_head_bwd", "head, db0 phase 0", (0, 0), lambda a: True),
        ("pair_head_bwd", "head, dW", (2,), lambda a: True),
        ("phase_conv_dtaps", "heads (256->2x512), mu's dtaps", (0,),
         lambda a: a[2][0][-1] == LATENT),
        ("up_dual_conv_dx", "up0 (C_in 512), dx", (0,), lambda a: a[1][0][0].shape[1] == LATENT),
    ),
}
# ... and on the merged route: i's dtaps, j's dx and dtaps and k's dtaps. k's Σg_eff
# is not among them: it is the gradient of a conv bias that feeds a
# BatchNorm, exactly 0, so 1% of it is 1% of float32 rounding noise, which
# no gradient check can see.
PLANTED_MERGED = {
    "ico2ico": (
        ("phase_conv_bwd", "down0-2 stride-2 and up0-2 conv01, dtaps of set a", (1, 0),
         lambda a: True),
        ("up_dual_conv_bwd", "up0-2, dx", (0,), lambda a: True),
        ("up_dual_conv_bwd", "up0-2, dtaps of set a", (1,), lambda a: True),
        ("ico_conv_s2s_bwd", "down0-2 conv01, dtaps", (1,), lambda a: True),
    ),
    "ico2ico_vae": (
        ("phase_conv_bwd", "heads (256->2x512), mu's dtaps", (1, 0),
         lambda a: a[0][0].shape[-1] == WIDTHS[2] and a[4][0][0].shape[-1] == LATENT),
        ("up_dual_conv_bwd", "up0 (C_in 512), dx", (0,), lambda a: a[0].shape[-1] == LATENT),
        ("up_dual_conv_bwd", "up0 (C_in 512), dtaps of set a", (1,),
         lambda a: a[0].shape[-1] == LATENT),
        ("ico_conv_s2s_bwd", "down0-1 conv01, dtaps", (1,), lambda a: True),
    ),
}
# ... and on the phase chain (every routing; the VAE's trunk has down0-1):
# m's dx and dtaps, and with the fold outside the kernels l's output too
# (m's dtaps then also emits the bias gradients, so its dtaps are (0, 0)).
_M_DX = ("ds2s_dx", "down0-2 m, dphase 0", (0, 0), lambda a: True)
PLANTED_CHAIN = {
    " (chain)": (_M_DX, ("ds2s_dtaps", "down0-2 m, dtaps of set a", (0,), lambda a: True)),
    " (chain, merged)": (_M_DX, ("ds2s_dtaps", "down0-2 m, dtaps of set a", (0,),
                                 lambda a: True)),
    " (chain, fold outside)": (
        ("stats_geff", "every group it folds, phase 0", (0,), lambda a: True), _M_DX,
        ("ds2s_dtaps", "down0-2 m, dtaps of set a", (0, 0), lambda a: True)),
}
# ... and on the decoder's chain (every routing; up1 and up2): n's forward
# output, a phase cotangent and an affine gradient of its dx, and its dtaps
PLANTED_N = (
    ("up_pair_fwd", "up1-2 n, output phase 0 of set a", (0, 0, 0), lambda a: True),
    ("up_pair_dx", "up1-2 n, db0 phase 0", (0, 0), lambda a: True),
    ("up_pair_dx", "up1-2 n, d_mul1 (to up0-1's bn01)", (2,), lambda a: True),
    ("up_pair_dtaps", "up1-2 n, dtaps of set a", (0,), lambda a: True),
)
# ... and on the merged blocks: o's and p's b0, and a residual of each that
# only the backward reads (o's y00, p's mul00); on both chains o at up0 alone
PLANTED_BLOCK = (
    ("up_block_fwd", "up0-2 o, b0 phase 0", (0, 0), lambda a: True),
    ("up_block_fwd", "up0-2 o, y00 phase 0 (the backward's residual)", (2, 0), lambda a: True),
    ("dn_block_fwd", "down0-2 p, b0", (0,), lambda a: True),
    ("dn_block_fwd", "down0-2 p, mul00 (the backward's residual)", (6,), lambda a: True),
)
# the training routings of each model (``ROUTES`` keys)
FIT_EPOCHS, FIT_SAVE_FREQ, VAL_MESHES = 3, 2, 16


def expected_checkpoints(name: str, history, save_freq: int, start: int = 0,
                         best: float = math.inf, keep: int = 6) -> set:
    """The file names the JAX package's ``Trainer.fit`` writes for a
    validation history from epoch ``start``: an EB file whenever the loss is
    at or below the best (ties too), then only the newest ``keep`` EB files
    kept; an E file every ``save_freq`` epochs and one at the end."""
    eb, e = [], set()
    for k, cur in enumerate(history):
        epoch = start + k + 1
        if cur <= best:
            best = cur
            eb = sorted(eb + [epoch])[-keep:]
        if epoch % save_freq == 0:
            e.add(epoch)
    if history:
        e.add(start + len(history))
    return {f"{name}_EB{k}.ckpt" for k in eb} | {f"{name}_E{k}.ckpt" for k in e}


def _same_weights(a, b, what: str):
    """Every parameter and BatchNorm statistic of models a and b bit for bit."""
    sa, sb = a.state_dict(), b.state_dict()
    bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
    if set(sa) != set(sb) or bad:
        raise AssertionError(f"{what}: {len(bad)} tensors differ, e.g. {bad[:3]}")


def fit_phase(model: str, variables, dataset, val_dataset, card: str):
    """Phase [fit] for one model at B=36 bf16: ``Trainer.fit`` for
    FIT_EPOCHS epochs (EB/E checkpoints in the JAX format, E every
    FIT_SAVE_FREQ), then ``restore`` of the newest E file into a fresh
    Trainer (weights, BatchNorm statistics, Adam state, epoch and best loss
    bit for bit), one step of each on the same batch (metrics bit for bit),
    a resume by the command line for one more epoch from the dataset written
    as .npz files, and the explorer loading the newest EB file from disk,
    its latent cache and a B=1 decode bit-equal to a load from the same
    weights in memory; then ``eval_phase`` and ``explorer_phase`` on the
    files written. Returns the kernel launches of the ``fit`` run, of the
    evaluation's processes and of the explorer's server."""
    import os
    import tempfile

    import numpy as np

    from geniconet_tpu_torch import cli
    from geniconet_tpu_torch.app.server import handle_api
    from geniconet_tpu_torch.app.state import AppState
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.train import checkpoint as ckpt
    from geniconet_tpu_torch.train.config import apply_model_presets
    from geniconet_tpu_torch.train.trainer import Trainer

    tag = f"fit {model} bfloat16"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as root:
        data_root = os.path.join(root, "data")
        for split, ds in (("train", dataset), ("test", val_dataset)):
            os.makedirs(os.path.join(data_root, "synth", split))
            for k, target in enumerate(ds.targets):
                np.savez(os.path.join(data_root, "synth", split, f"m{k}.npz"), data=target.T)
        cfg = apply_model_presets(train_config("bfloat16", TRAIN_BATCH, model))
        cfg.train.train_epoch, cfg.train.save_epoch_freq = FIT_EPOCHS, FIT_SAVE_FREQ
        cfg.log_dir, cfg.data.data_dir = os.path.join(root, "log"), data_root
        ckpt_dir = os.path.join(cfg.model_log_dir(), "savedModel")
        tr = Trainer(cfg, device="cuda")
        st = tr.init_state(variables)
        trn = Batches(dataset, TRAIN_BATCH, seed=0, device="cuda")
        val = Batches(val_dataset, TRAIN_BATCH, shuffle=False, device="cuda")
        epoch_s, val_s = [], []

        def timed(fn, into):
            def run(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
                return out
            return run

        tr.train_epoch, tr.validate = timed(tr.train_epoch, epoch_s), timed(tr.validate, val_s)
        build.reset_launches()
        st, history = tr.fit(st, trn, val)
        launches = dict(build.LAUNCHES)
        del tr.train_epoch, tr.validate
        files = set(os.listdir(ckpt_dir))
        want = expected_checkpoints(cfg.model.name, history, FIT_SAVE_FREQ)
        print(f"[{tag}] {FIT_EPOCHS} epochs of {len(dataset)} meshes at B={TRAIN_BATCH} "
              f"(the last batch {len(dataset) % TRAIN_BATCH or TRAIN_BATCH}), validation on "
              f"{len(val_dataset)}: history {history}; epoch wall "
              f"{[round(t, 4) for t in epoch_s]} s = "
              f"{[round(len(dataset) / t, 1) for t in epoch_s]} training meshes/s (the log_freq "
              f"{cfg.train.log_freq} cadence's host syncs included); validate "
              f"{[round(t, 4) for t in val_s]} s; files {sorted(files)} [{card}]", flush=True)
        if not all(math.isfinite(v) for v in history):
            raise AssertionError(f"{tag}: non-finite validation history {history}")
        if files != want:
            raise AssertionError(f"{tag}: wrote {sorted(files)}, JAX's rules give {sorted(want)}")

        # restore the newest E file into a fresh Trainer
        path = ckpt.latest_checkpoint(ckpt_dir, cfg.model.name)
        t0 = time.perf_counter()
        blob = ckpt.load_checkpoint(path)
        load_ms = (time.perf_counter() - t0) * 1e3
        fresh = Trainer(cfg, device="cuda")
        fst, epoch, best = fresh.restore(fresh.init_state(variables), path)
        _same_weights(fresh.model, tr.model, f"{tag} restore of {os.path.basename(path)}")
        for (k, p), q in zip(tr.model.named_parameters(), fresh.model.parameters()):
            a, b = st.optimizer.state[p], fst.optimizer.state[q]
            if any(not torch.equal(a[n], b[n]) for n in ("exp_avg", "exp_avg_sq", "step")):
                raise AssertionError(f"{tag} restore: Adam's state of {k} differs")
        if (epoch, best, fst.step) != (FIT_EPOCHS, min(history), st.step):
            raise AssertionError(f"{tag} restore: epoch {epoch}, best {best}, step {fst.step}; "
                                 f"want {FIT_EPOCHS}, {min(history)}, {st.step}")
        t0 = time.perf_counter()
        tr._save(st, os.path.join(root, "timed"), cfg.model.name, epoch, history[-1], best=False,
                 best_loss=best)
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = os.path.getsize(path)

        # one step of each on the same batch: the kernels have no atomics
        x, y, wt = next(Batches(dataset, TRAIN_BATCH, seed=5, device="cuda").epoch())
        if fresh.is_vae:
            fresh.generator.set_state(tr.generator.get_state())
        ma, mb = (t.train_step(s, x, y, wt, epoch) for t, s in ((tr, st), (fresh, fst)))
        bad = [k for k in ma if not (torch.equal(ma[k], mb[k]) if torch.is_tensor(ma[k])
                                     else ma[k] == mb[k])]
        if bad:
            raise AssertionError(f"{tag}: the restored trainer's step differs in {bad}: "
                                 f"{ {k: (float(ma[k]), float(mb[k])) for k in bad} }")
        print(f"[{tag}] restore of {os.path.basename(path)}: weights, BatchNorm statistics, "
              f"Adam's state, epoch {epoch} and best {best} bit for bit, and the next step's "
              f"metrics too (total {float(ma['total'])}); checkpoint {nbytes} bytes, "
              f"save_checkpoint (with the device-to-host copy) {save_ms:.1f} ms, "
              f"load_checkpoint {load_ms:.1f} ms (the pure-Python codec) [{card}]", flush=True)
        del blob

        # resume by the command line for one more epoch
        argv = ["--model", model, "--process", "train", "--dataDir", data_root,
                "--logDir", cfg.log_dir, "--batch_size", str(TRAIN_BATCH),
                "--compute_dtype", "bfloat16", "--subdivision", str(SUBDIVISIONS),
                "--widths", *map(str, WIDTHS), "--latent_features", str(LATENT),
                "--train_epoch", str(FIT_EPOCHS + 1),
                "--load_pretrained_model", "--load_epoch", str(FIT_EPOCHS)]
        t0 = time.perf_counter()
        resumed = cli.main(argv)
        cli_s = time.perf_counter() - t0
        if len(resumed) != 1 or not math.isfinite(resumed[0]):
            raise AssertionError(f"{tag}: the resume ran {len(resumed)} epochs ({resumed}), "
                                 f"want 1 from epoch {FIT_EPOCHS}")
        files = set(os.listdir(ckpt_dir))
        want |= expected_checkpoints(cfg.model.name, resumed, 50 if fresh.is_vae else 100,
                                     start=FIT_EPOCHS, best=min(history))
        if files != want:
            raise AssertionError(f"{tag} resume: {sorted(files)}, JAX's rules give {sorted(want)}")
        print(f"[{tag}] cli.main --load_pretrained_model --load_epoch {FIT_EPOCHS}: one epoch "
              f"from epoch {FIT_EPOCHS}, validation {resumed}, {cli_s:.2f} s with the .npz "
              f"dataset's load; files {sorted(files)} [{card}]", flush=True)

        # the explorer from disk against the same weights in memory
        serve_cfg = model_config(model, "bfloat16")
        serve_cfg.log_dir, serve_cfg.data.data_dir = cfg.log_dir, data_root
        disk, memory = AppState(device="cuda"), AppState(device="cuda")
        t0 = time.perf_counter()
        info = disk.load(serve_cfg, epoch=0)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        blob = ckpt.load_checkpoint(ckpt.checkpoint_path(ckpt_dir, cfg.model.name,
                                                         ckpt.latest_best_epoch(ckpt_dir,
                                                                                cfg.model.name),
                                                         best=True))
        memory.load(serve_cfg, variables={k: blob[k] for k in ("params", "batch_stats")})
        if not (np.array_equal(disk.latents, memory.latents)
                and np.array_equal(disk.decode_latent(disk.latents[0]),
                                   memory.decode_latent(memory.latents[0]))):
            raise AssertionError(f"{tag}: the explorer's load from disk differs from the load "
                                 "of the same weights")
        served = AppState(device="cuda")
        api = handle_api(served, "/api/load", {"model": model, "logDir": cfg.log_dir,
                                               "subdivision": SUBDIVISIONS, "widths": WIDTHS,
                                               "dataDir": data_root, "epoch": 0})
        listed = {f"{cfg.model.name}_{'EB' if kind == 'best' else 'E'}{e}.ckpt"
                  for kind, epochs in api["epochs"].items() for e in epochs}
        if listed != files or handle_api(served, "/api/epochs", {}) != api["epochs"]:
            raise AssertionError(f"{tag}: /api/load lists {sorted(listed)}, wrote {sorted(files)}")
        check_mesh(served.reconstruct(0), served.dataset.targets.shape[1], f"{tag} /api/load")
        print(f"[{tag}] AppState.load(epoch=0) of EB{info['epoch']}: {load_s:.2f} s for "
              f"{info['n']} meshes; latent cache and a B=1 decode bit-equal to the load of the "
              f"same weights in memory; /api/load (float32) and /api/epochs list "
              f"{api['epochs']} [{card}]", flush=True)
        eval_launches = eval_phase(model, cfg.log_dir, data_root, val_dataset, card)
        explorer_launches = explorer_phase(model, cfg.log_dir, data_root, card)
    return launches, eval_launches, explorer_launches


def _http(url: str, body=None, gzip_ok: bool = False):
    """(status, headers, body bytes) of a GET (``body`` None) or a JSON POST;
    a 4xx/5xx answer is returned, not raised."""
    import gzip
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Accept-Encoding": "gzip"} if gzip_ok else {})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, headers, data = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, headers, data = e.code, dict(e.headers), e.read()
    if headers.get("Content-Encoding") == "gzip":
        data = gzip.decompress(data)
    return status, headers, data


def explorer_phase(model: str, log_dir: str, data_root: str, card: str) -> dict:
    """Phase [explorer] on [fit]'s files: the port's explorer server
    (``app/server.py:make_server``) in a thread on 127.0.0.1, port 0, its
    ``AppState`` on the card, driven over HTTP: /api/load of the newest EB
    file (float32, the validation meshes), /api/pca, /api/pca_decode,
    /api/pairs (closest and farthest), /api/arithmetic with its nearest
    neighbour, /api/viewpoint save / list / delete, /api/export as .off and
    as a figure, /api/view_file of the exported .off (its vertices the
    export's), GET / and a gzip /api/mesh. Each mesh must have the level's
    vertices, finite; a route that fails fails the run. Prints each route's
    wall time (the HTTP round trip included) and returns the kernel
    launches of the run."""
    import os
    import threading

    import numpy as np

    from geniconet_tpu_torch.app import server
    from geniconet_tpu_torch.app.state import AppState
    from geniconet_tpu_torch.geometry import ico
    from geniconet_tpu_torch.ops.kernels import build

    tag = f"explorer {model}"
    V = ico.num_vertices(SUBDIVISIONS)
    srv = server.make_server(AppState(device="cuda"), "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    walls = {}

    def call(route, body=None, gzip_ok=False, label=""):
        t0 = time.perf_counter()
        status, headers, data = _http(url + route, body, gzip_ok)
        walls[f"{'GET ' if body is None else ''}{route}{label}"] = (time.perf_counter() - t0) * 1e3
        if status != 200:
            raise AssertionError(f"{tag}: {route} answered {status}: {data[:500]!r}")
        return headers, (data if body is None else json.loads(data))

    build.reset_launches()
    try:
        _, info = call("/api/load", {"model": model, "logDir": log_dir, "dataDir": data_root,
                                     "subdivision": SUBDIVISIONS, "widths": list(WIDTHS),
                                     "epoch": 0})
        n = info["n"]
        _, pca = call("/api/pca", {})
        points = np.asarray(pca["points"], np.float32)
        if points.shape != (n, 3) or not np.isfinite(points).all():
            raise AssertionError(f"{tag}: /api/pca gave points {points.shape}")
        _, near = call("/api/pca_decode", {"p": points[1].tolist(), "coloring": "patch"})
        check_mesh(near["vertices"], V, f"{tag} /api/pca_decode")
        if near["index"] != 1:
            raise AssertionError(f"{tag}: /api/pca_decode at point 1 decoded {near['index']}")
        for farthest in (False, True):
            _, pairs = call("/api/pairs", {"k": 5, "farthest": farthest},
                            label=" farthest" if farthest else " closest")
            if len(pairs["pairs"]) != 5 or not all(0 <= p["i"] < p["j"] < n
                                                   for p in pairs["pairs"]):
                raise AssertionError(f"{tag}: /api/pairs gave {pairs}")
        _, arith = call("/api/arithmetic", {"terms": [{"op": "+", "i": 0}, {"op": "-", "i": 1},
                                                      {"op": "+", "i": 2}]})
        check_mesh(arith["vertices"], V, f"{tag} /api/arithmetic")
        if not 0 <= arith["nearest"]["index"] < n:
            raise AssertionError(f"{tag}: /api/arithmetic nearest {arith['nearest']}")
        cam = {"eye": [0.0, 0.0, 3.0]}
        call("/api/viewpoint", {"op": "save", "name": "front", "camera": cam}, label=" save")
        vps = call("/api/viewpoint", {"op": "list"}, label=" list")[1]["viewpoints"]
        if vps.get("front") != cam:
            raise AssertionError(f"{tag}: /api/viewpoint did not keep the saved camera")
        vps = call("/api/viewpoint", {"op": "delete", "name": "front"}, label=" delete")[1]
        if "front" in vps["viewpoints"]:
            raise AssertionError(f"{tag}: /api/viewpoint did not delete the camera")
        off = call("/api/export", {"i": 3}, label=" off")[1]["path"]
        fig = call("/api/export", {"i": 3, "fmt": "fig", "coloring": "patch"},
                   label=" fig")[1]["path"]
        if not (os.path.basename(off) == f"{info['names'][3]}_recon.off"
                and os.path.basename(fig) == f"{info['names'][3]}_recon.fig.json"
                and os.path.exists(off) and os.path.exists(fig)):
            raise AssertionError(f"{tag}: /api/export wrote {off}, {fig}")
        _, viewed = call("/api/view_file", {"path": off})
        check_mesh(viewed["vertices"], V, f"{tag} /api/view_file")
        with open(fig) as f:
            exported = json.load(f)
        if np.abs(np.asarray(viewed["vertices"]) - np.asarray(exported["vertices"])).max() > 1e-5:
            raise AssertionError(f"{tag}: /api/view_file of the .off differs from the export")
        page = call("/")[1]
        if b"<html" not in page.lower():
            raise AssertionError(f"{tag}: GET / is not the page")
        headers, mesh = call("/api/mesh", {"i": 0}, gzip_ok=True, label=" (gzip)")
        if headers.get("Content-Encoding") != "gzip":
            raise AssertionError(f"{tag}: /api/mesh was not gzipped")
        check_mesh(mesh["vertices"], V, f"{tag} /api/mesh")
        torch.cuda.synchronize()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    launches = dict(build.LAUNCHES)
    print(f"[{tag}] {n} meshes of EB{info['epoch']}; routes' wall (ms, HTTP included): "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + f" [{card}]", flush=True)
    return launches


EVAL_CPU_MESHES = 2  # meshes of the float32 kernel route held against the CPU's plain route
EVAL_WORKERS = 4  # processes for [eval]'s CPU sides: the CPU route's meshes, the two oracles
# the CPU sides' distances take every 8th vertex of a mesh (1,281 of 10,242)
# against all its faces: the host CPU of a one-H100 machine computed all of
# one s=5 mesh in 32-39 s with PyTorch and in 56 s with the numpy oracle
EVAL_STRIDE = 8


def reference_state_dict(seed: int = 0) -> dict:
    """A seeded state dict shaped like the reference's AE checkpoint at
    WIDTHS (reference models.py:101-232 names: masked 3x3 OIHW conv
    weights, BatchNorm buffers, an icocnn index buffer): ``--load_pt``'s input."""
    gen = torch.Generator().manual_seed(seed)
    w0, w1, w2 = WIDTHS
    sd = {}

    def rnd(*shape, scale=0.05, offset=0.0):
        return offset + scale * torch.randn(*shape, generator=gen)

    def conv(prefix, cin, cout):
        w = rnd(cout, cin, 3, 3)
        w[:, :, 0, 0] = w[:, :, 2, 2] = 0.0  # the hex stencil has no corner taps
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = w, rnd(cout)

    def bn(prefix, c):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = rnd(c, scale=0.1, offset=1.0), rnd(c)
        sd[f"{prefix}.running_mean"] = rnd(c, scale=0.1)
        sd[f"{prefix}.running_var"] = rnd(c, scale=0.1, offset=1.0) ** 2
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(100)

    def block(prefix, cin, cout):
        for k, c in (("00", cin), ("01", cout), ("10", cin)):
            conv(f"{prefix}.conv{k}", c, cout)
            bn(f"{prefix}.icobn{k}", cout)

    conv("encoder.0", 3, w0)
    bn("encoder.1", w0)
    for k, (cin, cout) in enumerate(((w0, w1), (w1, w2), (w2, w2))):
        block(f"encoder.{k + 3}", cin, cout)
    for k, (cin, cout) in enumerate(((w2, w2), (w2, w1), (w1, w0))):
        block(f"decoder.{k}", cin, cout)
    sd["enc2icoConv.0.weight"], sd["enc2icoConv.0.bias"] = rnd(3, w0, 1, 1), rnd(3)
    sd["encoder.0.pad_index"] = torch.arange(10)
    return sd


def cpu_route(cfg, path: str, grid, ref, faces, stride: int, threads: int):
    """[eval]'s job in a worker process: the float32 plain route on the CPU
    for one mesh: the model of ``cfg`` (on the CPU) restored from ``path``,
    its reconstruction of ``grid`` and the squared distances of every
    ``stride``-th vertex to the reference mesh. Returns (vertices, distances)."""
    from geniconet_tpu_torch.eval import test_driver
    from geniconet_tpu_torch.ops.point_mesh import point_to_mesh_distance

    torch.set_num_threads(threads)
    with torch.no_grad():
        model = test_driver.restore_model(cfg, path)[0]
        v = test_driver.reconstruct(model, torch.from_numpy(grid[None]))[0]
        d = point_to_mesh_distance(v[::stride], torch.from_numpy(ref), faces,
                                   chunk=test_driver.distance_chunk(v.device, len(v[::stride])))
    return v.numpy(), d.numpy()


def eval_phase(model: str, log_dir: str, data_root: str, val_dataset, card: str) -> dict:
    """Phase [eval] for one model on [fit]'s files (s=5, full width, bf16,
    the validation meshes), through ``cli.main`` as a user runs it: test
    with ``--write_output_mesh``, encode, decode, and for the AE
    ``--load_pt`` of a seeded reference-shaped ``.pt`` (``torch.save``) into
    a log directory of its own, then test on the imported file. Every CSV
    must hold one finite row for each mesh, and decode(encode(x)) must give
    test's distances (bit for bit, else point2point within 1e-5). For the
    AE also: the distance of one reconstruction to its reference mesh on the
    card (ms a mesh by CUDA events, peak memory) against the float64 numpy
    oracle (every EVAL_STRIDE-th point) and the native C++ (every point),
    and the float32 kernel route (model and distance on the card) on
    EVAL_CPU_MESHES meshes against the float32 plain route on the CPU (the
    vertices, and the distances of every EVAL_STRIDE-th one). The CPU sides
    run in EVAL_WORKERS spawned processes beside the card's work, after the
    timed processes. Returns the kernel launches of the command line's
    processes."""
    import concurrent.futures
    import multiprocessing
    import os

    import numpy as np

    from geniconet_tpu_torch import cli, native
    from geniconet_tpu_torch import geometry as ico
    from geniconet_tpu_torch.data.offio import read_off
    from geniconet_tpu_torch.eval import test_driver
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.ops.point_mesh import (point_to_mesh_distance,
                                                    point_to_mesh_distance_numpy)
    from geniconet_tpu_torch.train.config import parse_args

    t_phase = time.perf_counter()
    ae = model == "ico2ico"
    tag = f"eval {model} bfloat16"
    names = [f"m{k}" for k in range(len(val_dataset))]  # [fit]'s .npz files

    def argv(log=log_dir):
        return ["--model", model, "--dataDir", data_root, "--logDir", log, "--batch_size",
                str(TRAIN_BATCH), "--compute_dtype", "bfloat16", "--subdivision",
                str(SUBDIVISIONS), "--widths", *map(str, WIDTHS), "--latent_features", str(LATENT)]

    walls = {}

    def run(name, *extra, log=log_dir):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.main([*argv(log), *extra])
        torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - t0, 3)
        return out

    cfg = parse_args([*argv(), "--process", "test"])
    root = os.path.dirname(log_dir)
    build.reset_launches()
    tested = run("test", "--process", "test", "--write_output_mesh")[0]
    run("encode", "--process", "encode")
    decoded = run("decode", "--process", "decode")[0]
    csvs = {"test": (os.path.join(cfg.model_log_dir(), f"{model}_point2mesh.csv"), tested),
            "decode": (os.path.join(cfg.model_log_dir(), f"{model}_decode_point2mesh.csv"),
                       decoded)}
    if ae:
        pt_path, pt_log = os.path.join(root, "ico2ico_EB696.pt"), os.path.join(root, "pt_log")
        torch.save({"model_state_dict": reference_state_dict(), "optimizer_state_dict": {},
                    "epoch": 696, "loss": 0.5, "misc": None}, pt_path)
        imported = run("--load_pt + test", "--load_pt", pt_path, "--process", "test", log=pt_log)[0]
        csvs["--load_pt + test"] = (os.path.join(pt_log, "ae", "ico2ico_point2mesh.csv"), imported)
    launches = dict(build.LAUNCHES)
    for what, (path, pairs) in csvs.items():
        with open(path) as f:
            rows = [r.split(",") for r in f.read().strip().splitlines()]
        got = {name: float(d) for name, d in rows[1:]}
        if (rows[0] != ["Name", "Distance"] or len(rows) != len(names) + 1
                or sorted(got) != sorted(names) or not all(map(math.isfinite, got.values()))
                or got != {name: float(f"{d:f}") for name, d in pairs}):
            raise AssertionError(f"{tag} {what}: {path} holds {rows[:3]}...; want one finite "
                                 f"row for each of {len(names)} meshes")
    if dict(tested) == dict(decoded):
        roundtrip = "bit for bit"
    else:
        p2p = {p: dict(run(f"{p} point2point", "--process", p, "--test_mode", "point2point")[0])
               for p in ("test", "decode")}
        worst = max(abs(p2p["test"][k] - p2p["decode"][k]) for k in names)
        if not worst < 1e-5:
            raise AssertionError(f"{tag}: decode(encode(x)) differs from test by {worst} "
                                 "(point2point; want < 1e-5)")
        roundtrip = f"point2point within {worst:.3e} (< 1e-5), point2mesh not bit-equal"
    means = {what: round(float(np.mean([d for _, d in pairs])), 8)
             for what, (_, pairs) in csvs.items()}
    print(f"[{tag}] cli.main on the {len(names)} validation meshes at B={TRAIN_BATCH} (s="
          f"{SUBDIVISIONS}, widths {WIDTHS}): wall s {walls} (each with its checkpoint load and "
          f"the .npz dataset's); mean point2mesh {means}; one finite CSV row a mesh; "
          f"decode(encode(x)) equals test {roundtrip} [{card}]", flush=True)
    print(f"[{tag}] kernel launches of the processes (path "
          f"'{'AE' if ae else 'VAE'} serve (eval)'): {launches}", flush=True)
    if not ae:
        print(f"[{tag}] phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
        return launches

    # the metric on the card: one reconstruction against its reference mesh
    faces = ico.get_ico_faces(SUBDIVISIONS)
    f_c = torch.as_tensor(faces, device="cuda")
    points = read_off(os.path.join(cfg.model_log_dir(), "data", "test", "m0.off"))[0]
    mesh = val_dataset.targets[0][:, :3]
    p_c, m_c = torch.from_numpy(points).cuda(), torch.from_numpy(mesh).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    card_d = point_to_mesh_distance(p_c, m_c, f_c)
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    ms = cuda_ms(lambda: point_to_mesh_distance(p_c, m_c, f_c), reps=5, warmup=1)
    card_d = card_d.cpu().numpy()
    extent = float(np.abs(mesh).max()) ** 2

    # the float32 kernel route (model and distance on the card) against the
    # float32 plain route on the CPU, from the same checkpoint; the CPU sides
    # run in worker processes beside the card's
    cfg32 = parse_args([*argv(), "--process", "test", "--compute_dtype", "float32"])
    path = test_driver.resolve_checkpoint(cfg32)
    grids = val_dataset.inputs[:EVAL_CPU_MESHES]
    refs = val_dataset.targets[:EVAL_CPU_MESHES, :, :3]
    cfg_cpu = copy.deepcopy(cfg32)
    cfg_cpu.device = "cpu"
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(EVAL_WORKERS, mp_context=spawn) as pool:
        routes = [pool.submit(cpu_route, cfg_cpu, path, g, r, faces, EVAL_STRIDE, 2)
                  for g, r in zip(grids, refs)]
        oracles = {"float64 numpy": pool.submit(point_to_mesh_distance_numpy,
                                                points[::EVAL_STRIDE], mesh, faces),
                   "native C++": pool.submit(native.point_to_mesh_distance_native, points,
                                             mesh, faces)}
        with torch.no_grad():
            model32 = test_driver.restore_model(cfg32, path)[0]
            v_card = test_driver.reconstruct(model32, torch.from_numpy(grids).cuda())
            d_card = [point_to_mesh_distance(v, torch.from_numpy(r).cuda(), f_c).cpu().numpy()
                      for v, r in zip(v_card, refs)]
        v_card = v_card.cpu().numpy()
        oracles = {k: f.result() for k, f in oracles.items()}
        routes = [f.result() for f in routes]
    errs = {}
    for name, ref in oracles.items():
        got = card_d[::EVAL_STRIDE] if len(ref) < len(card_d) else card_d
        err = np.abs(got - ref)
        if not (err <= 1e-4 * np.abs(ref) + 1e-6 * extent).all():
            raise AssertionError(f"{tag}: the card's distances differ from the {name} oracle "
                                 f"by up to {err.max()} (tol rtol 1e-4 + 1e-6 x {extent})")
        errs[name] = float(err.max())
    print(f"[{tag}] point_to_mesh_distance on the card, s={SUBDIVISIONS} ({len(points)} "
          f"points of mesh m0's reconstruction, {len(faces)} faces of its reference, chunk "
          f"{test_driver.distance_chunk(p_c.device, len(points))}): {ms:.3f} ms a mesh (CUDA "
          f"events, median of 5), "
          f"peak {peak_mib:.1f} MiB above its inputs; mean {float(card_d.mean()):.8f}; max abs "
          f"err {errs} against the float64 numpy oracle at every {EVAL_STRIDE}th point and the "
          f"native C++ at every point (tol rtol 1e-4 + 1e-6 x extent^2 {extent:.4f}) [{card}]",
          flush=True)

    v_cpu = np.stack([v for v, _ in routes])
    dv = float(np.abs(v_card - v_cpu).max())
    if not dv <= 1e-4 * np.abs(v_cpu).max():
        raise AssertionError(f"{tag}: the float32 kernel route's vertices differ from the CPU's "
                             f"by {dv} (tol 1e-4 x {np.abs(v_cpu).max()})")
    rows = []
    for k, (dc, (vp, dp)) in enumerate(zip(d_card, routes)):
        # sqrt of a squared distance is 1-Lipschitz in the point: a vertex
        # moved by delta moves it by at most delta (2 sqrt(d) + delta)
        delta = np.linalg.norm(v_card[k] - vp, axis=-1)[::EVAL_STRIDE]
        tol = delta * (2 * np.sqrt(dp) + delta) + 1e-4 * dp + 1e-6 * extent
        diff = np.abs(dc[::EVAL_STRIDE] - dp)
        if not (diff <= tol).all():
            raise AssertionError(f"{tag}: mesh {k}'s distances on the float32 kernel route "
                                 f"differ from the CPU's by up to {diff.max()} (tol {tol})")
        rows.append((round(float(dc[::EVAL_STRIDE].mean()), 8), round(float(dp.mean()), 8),
                     f"{diff.max():.2e}", round(float(dc.mean()), 8)))
    print(f"[{tag}] float32 kernel route vs the float32 plain route on the CPU, "
          f"{EVAL_CPU_MESHES} meshes: vertices max abs err {dv:.3e} (tol 1e-4 x max|ref| "
          f"{np.abs(v_cpu).max():.4f}); squared distances at every {EVAL_STRIDE}th vertex, per "
          f"mesh (card's mean, CPU's mean, max |diff|, the card's mean over every vertex) {rows} "
          f"(tol per point delta (2 sqrt(d) + delta) + 1e-4 d + 1e-6 x extent^2) [{card}]",
          flush=True)
    print(f"[{tag}] phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# The subdivision-6/7 phases: every kernel at its s=6 and s=7 shapes, the
# s=7 batch whose row tiles pass gridDim.y's 65,535, and AE training at
# bs36 (s=6: also the routings and the VAE).
S67_LEVELS = (6, 7)
S67_BATCH = 2  # the kernel cases at s=6 and s=7
SPLIT_LEVEL, SPLIT_BATCH = 7, 56  # 71,680 row tiles of 128 at conv_in and up2 (B=52 passes 65,535)
S67_MESHES = 4  # distinct synthetic meshes a training batch at s=6/7 repeats
S67_STEPS = 3
S67_ROUTES = (" (chain dec)", " (chain all)", " (merged)", " (merged block)")
# the s=6/7 and data-parallel paths launch what the s=5 path of their routing does
_SCALED_PATHS = {"AE train (dp)": "AE train", "VAE train (dp)": "VAE train",
                 **{f"AE train (s{s})": "AE train" for s in S67_LEVELS},
                 f"VAE train (s{S67_LEVELS[0]})": "VAE train",
                 **{f"AE train (s{S67_LEVELS[0]}, {r[2:]}": f"AE train{r}" for r in S67_ROUTES}}
for _path, _base in _SCALED_PATHS.items():
    PATH_KERNELS[_path] = PATH_KERNELS[_base]
    PATH_FORBIDDEN[_path] = PATH_FORBIDDEN[_base]
    if _base in BLOCKS_PER_FORWARD:
        BLOCKS_PER_FORWARD[_path] = BLOCKS_PER_FORWARD[_base]


def nbytes(obj) -> int:
    """Bytes of the arrays in nested tuples/lists of numpy arrays or tensors."""
    if isinstance(obj, (tuple, list)):
        return sum(nbytes(o) for o in obj)
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return getattr(obj, "nbytes", 0)


def s67_kernels(card: str) -> dict:
    """Phase [s6/s7 kernels]: the host-built halo tables of the top level
    (build time and bytes), then every kernel at its s=6 and s=7 shapes
    (the serving and training cases at B=2, the s=5 shapes scaled; not the
    stride-2 standard conv, off the model, nor the 320-channel head) in
    float32 and bf16 against its plain version within ``TOL`` (the bf16
    merged kernels also bit for bit against the split route), timed in
    bf16. Returns {kernel: {"s6": ..., "s7": ...}}: the largest error, the
    cases, and the bf16 ms, plain_ms and bound_ms summed over them."""
    from geniconet_tpu_torch.ops.kernels import halo

    out = collections.defaultdict(dict)
    for s in S67_LEVELS:
        h, w = 2 ** (s - 1), 2 ** s  # level s's phases: level s-1's chart
        t0 = time.perf_counter()
        tables = [halo.phase_conv_table(h, w, "average"), halo.std_conv_table(h, w, "average"),
                  halo.upsample_table(h, w, "average"), halo.phase_dx_codes(h, w, "average"),
                  halo.std_dx_codes(h, w, "average"), halo.up_adjoint_table(h, w, "average")]
        print(f"[s{s} kernels] the halo tables of level {s} (the phase conv's, the standard "
              f"conv's, the upsample's, the dx codes and the upsample adjoint at ({h},{w})) "
              f"built on the host in {time.perf_counter() - t0:.2f} s: "
              f"{nbytes(tables) / 2**20:.1f} MiB [{card}]", flush=True)
        cases = [c for c in serving_cases(S67_BATCH, s) + training_cases(S67_BATCH, s)
                 if c[3] not in ("std s2", "wide head")]
        stats = kernel_vs_plain(card, cases, f"s{s} kernel", reps=3, lean=True)
        for k, v in stats.items():
            out[k][f"s{s}"] = {key: v[key] for key in ("max_abs_err", "cases", "ms", "plain_ms",
                                                       "bound_ms")}
        torch.cuda.empty_cache()
    missing = [k for k in KERNELS if set(out[k]) != {f"s{s}" for s in S67_LEVELS}]
    if missing:
        raise AssertionError(f"[s6/s7 kernels] kernels with no s=6 or s=7 case: {missing}")
    return dict(out)


def batch_split_check(card: str):
    """Phase [s6/s7 kernels], s=7 at B=56: the grid convs' and the up conv's
    bf16 forward and dx at the shapes with the most GEMM rows (conv_in, up2
    conv01, up2; 71,680 row tiles of 128, past gridDim.y's 65,535). Rows
    are independent: each half of the batch's outputs must equal the B=28
    call on that half bit for bit (the stats, the d_mul/d_add and Σg sums
    over the batch, apart)."""
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

    B, half, dt = SPLIT_BATCH, SPLIT_BATCH // 2, torch.bfloat16
    h, w = 2 ** (SPLIT_LEVEL - 1), 2 ** SPLIT_LEVEL  # the level's phases
    gen = torch.Generator(device="cuda").manual_seed(7)
    w0, w1 = WIDTHS[:2]

    def phases(c):
        return [_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)]

    def cot(c, n_sets):
        return [[_rnd(gen, B, 5, h, w, c, dtype=dt) for _ in range(4)] for _ in range(n_sets)]

    def grid_fwd(cin, act):
        x, sets, a = phases(cin), [_taps(gen, cin, w0, dt)], _act(gen, cin) if act else None
        return [x], lambda x: pk.phase_conv_fwd(x, sets, "average", _ALL, a, True)[0]

    def grid_dx():
        sets, a, x = [_taps(gen, w0, w0, dt)], _act(gen, w0), phases(w0)
        g, y, gs = cot(w0, 1), cot(w0, 1), [_rnd(gen, 2, w0, scale=1e-3)]
        return [g, x, y], lambda g, x, y: pk.phase_conv_dx(g, sets, "average", _ALL, w0, dt, a, x,
                                                           y, gs)[0]

    def up_fwd():
        x, sets = _rnd(gen, B, 5, h, w, w1, dtype=dt), [_taps(gen, w1, w0, dt) for _ in range(2)]
        return [x], lambda x: pk.up_dual_conv_fwd(x, sets, "average", True)[0]

    def up_dx():
        sets = [_taps(gen, w1, w0, dt) for _ in range(2)]
        g, y, gs = cot(w0, 2), cot(w0, 2), [_rnd(gen, 2, w0, scale=1e-3) for _ in range(2)]
        return [g, y], lambda g, y: pk.up_dual_conv_dx(g, sets, "average", dt, y, gs, True)[0]

    def part(t, sl):
        if isinstance(t, (list, tuple)):
            return [part(u, sl) for u in t]
        return t[sl].contiguous()

    rows = B * 4 * 5 * h * w
    at = f"({h},{w})"
    for label, make in ((f"phase_conv_fwd conv_in {at} 3->64 +stats", lambda: grid_fwd(3, False)),
                        (f"phase_conv_fwd up2 conv01 {at} 64->64 act+stats",
                         lambda: grid_fwd(w0, True)),
                        (f"phase_conv_dx up2 conv01 {at} 64->64 act+fold", grid_dx),
                        (f"up_dual_conv_fwd up2 {at} 128->2x64 +stats", up_fwd),
                        (f"up_dual_conv_dx up2 {at} 128->2x64 fold", up_dx)):
        inputs, fn = make()
        whole = flat(fn(*inputs))
        torch.cuda.synchronize()
        for k, sl in enumerate((slice(0, half), slice(half, B))):
            got = flat(fn(*part(inputs, sl)))
            torch.cuda.synchronize()
            if len(got) != len(whole) or not all(torch.equal(u, v[sl])
                                                  for u, v in zip(got, whole)):
                raise AssertionError(f"[s{SPLIT_LEVEL} batch split] {label}: the B={B} call's "
                                     f"samples "
                                     f"{sl.start}-{sl.stop - 1} differ from the B={half} call")
        print(f"[s{SPLIT_LEVEL} batch split] {label} bf16: B={B} ({rows} GEMM rows a set of output "
              f"phases, {-(-rows // 128)} row tiles of 128), each half's {len(whole)} outputs "
              f"equal the B={half} call on it bit for bit [{card}]", flush=True)
        del inputs, fn, whole
        torch.cuda.empty_cache()


def device_synthetic(s: int, n: int, batch: int, seed: int):
    """A training set of ``batch`` meshes at subdivision s: ``n`` distinct
    random smooth meshes (``datasets.synthetic_vertices``, the JAX
    package's recipe) repeated, their normal and Laplacian targets
    computed on the card in one call each (``ops/mesh_math.py``, the
    loss's own forms; ``synthetic_dataset``'s per-vertex Laplacian loop
    takes seconds a mesh on the host at s=6/7)."""
    import numpy as np

    from geniconet_tpu_torch.data.datasets import IcoDataset, synthetic_vertices
    from geniconet_tpu_torch.geometry import ico
    from geniconet_tpu_torch.ops.mesh_math import laplacian, vertex_normals

    rng = np.random.RandomState(seed)
    v = np.stack([synthetic_vertices(s, rng) for _ in range(n)])[np.arange(batch) % n]
    vc = torch.from_numpy(v).cuda()
    targets = torch.cat([vc, vertex_normals(vc, s), laplacian(vc, s)], dim=-1)
    H, W = ico.grid_shape(s)
    return IcoDataset(v[:, :-2].reshape(batch, H, W, 3).astype(np.float32),
                      targets.cpu().numpy(), subdivisions=s)


def step_busy_ms(fn) -> float:
    """The device busy time of one call of fn (the union of its device
    events in a torch.profiler trace), in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = Path(__file__).resolve().parent / "build" / "profile" / "step.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out))
    events = [e for e in json.loads(out.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        raise AssertionError("step trace holds no device events")
    return busy_ms((e["ts"], e["ts"] + e["dur"]) for e in events)


def plain_of(kernel: str):
    """The plain PyTorch version of a kernel wrapper (same arguments, same
    outputs)."""
    from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

    if kernel == "stats_geff":
        return pk.geff_plain
    return getattr(pk, f"{kernel}_plain", None) or getattr(ck, f"{kernel}_plain")


@contextlib.contextmanager
def held_calls(tag: str, dt, card: str):
    """Every kernel wrapper that ``ops/kernels/fused.py`` calls, held against
    its plain version inside a step: each call runs the kernel as the path
    does (its launch counts; its outputs go on), then the plain version on
    the call's own inputs, and every output must be finite and within
    ``TOL[dt]`` of its own max|ref|, as in the kernel-vs-plain phase; the
    plain version must launch nothing. So each kernel is held at the shapes
    and on the data of the path, the batch-wide sums included (the stats,
    d_mul/d_add, Σg, the dtaps chunks). Yields {kernel: [calls, worst
    error / max|ref|, worst max_abs_err, the most memory a plain call took
    above what was allocated before it (MiB)]} and prints it on exit, with
    the step's peak memory."""
    from unittest import mock

    from geniconet_tpu_torch.ops.kernels import build, fused

    held, peak = {}, [0]

    def holding(name, real, plain):
        def call(*args, **kwargs):
            got = real(*args, **kwargs)
            before = dict(build.LAUNCHES)
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            m0 = torch.cuda.memory_allocated()
            ref = plain(*args, **kwargs)
            extra = (torch.cuda.max_memory_allocated() - m0) / 2**20
            if dict(build.LAUNCHES) != before:
                raise AssertionError(f"[{tag}] {name}'s plain version launched a kernel")
            g, r = flat(got), flat(ref)
            if len(g) != len(r):
                raise AssertionError(f"[{tag}] {name}: {len(g)} outputs, plain {len(r)}")
            worst = held.setdefault(name, [0, 0.0, 0.0, 0.0])
            worst[3] = max(worst[3], extra)
            worst[0] += 1
            for k, (u, v) in enumerate(zip(g, r)):
                err = (u.float() - v.float()).abs().max().item()
                scale = v.float().abs().max().item()
                rel = err / scale if scale else (math.inf if err else 0.0)
                if not (bool(torch.isfinite(u).all()) and rel <= TOL[dt]):
                    raise AssertionError(f"[{tag}] {name} call {worst[0]} output {k} "
                                         f"{tuple(u.shape)}: error {err} over tolerance "
                                         f"{TOL[dt]} x {scale}")
                worst[1], worst[2] = max(worst[1], rel), max(worst[2], err)
            del ref, r
            return got
        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for k in KERNELS:
            stack.enter_context(mock.patch.object(fused, k, holding(k, getattr(fused, k),
                                                                    plain_of(k))))
        yield held
    peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
    hog = max(held, key=lambda k: held[k][3])
    print(f"[{tag}] every kernel call of the step held against its plain version on its own "
          f"inputs, each output within {TOL[dt]:.0e} of its max|ref| (calls, worst relative "
          f"error): " + ", ".join(f"{k} {n} {rel:.2e}" for k, (n, rel, *_) in sorted(held.items()))
          + f"; peak memory {peak[0] / 2**20:.1f} MiB allocated (the plain versions' included; "
          f"{hog}'s took the most, {held[hog][3]:.1f} MiB above what was allocated before it) "
          f"[{card}]", flush=True)


def s67_config(model: str, s: int, dtype_name: str = "bfloat16"):
    cfg = train_config(dtype_name, TRAIN_BATCH, model)
    cfg.model.subdivisions = s
    return cfg


def s67_train(card: str, launches: dict, held_bs: dict) -> dict:
    """Phase [s6/s7 train]: the AE at s=6 and s=7, full width, bs36 bf16, on
    the default route: S67_STEPS Adam steps from seeded weights, each loss
    finite; the step time (host clock, synchronised; the first step apart),
    the device busy time of one step and the peak memory of the run; then
    one more step with every kernel call held against its plain version
    (``held_calls``), which must hold every kernel of the path. At s=6 the
    first step's loss must equal the plain route's (``pallas_blocks=
    "none"``: every block on PyTorch ops and cuDNN) within 1e-2 (the bf16
    step tests' bound), then one step of each routing of ``S67_ROUTES`` and
    of the VAE, each with its calls held. Each path's launches join
    ``launches`` (the held steps' plain versions launch nothing); the held
    calls join ``held_bs`` ({kernel: {"s6"/"s7": {"calls", "max_rel_err",
    "max_abs_err"}}}). Returns the s=6 dataset for [dp]."""
    from geniconet_tpu_torch import bridge
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.nn.models import IcoAE
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.train.trainer import Trainer

    def held_step(path, tr, st, batch):
        """One step of ``path`` with every kernel call held; the path's
        kernels must all have been held. Returns the loss."""
        level = f"s{tr.cfg.model.subdivisions}"
        with held_calls(f"{level} train held] [{path}", torch.bfloat16, card) as held:
            loss = float(tr.train_step(st, *batch)["total"])
        missing = [k for k in PATH_KERNELS[path] if k not in held]
        if missing or not math.isfinite(loss):
            raise AssertionError(f"[{level} train] {path}: loss {loss}; kernels of the path "
                                 f"not held: {missing}")
        for k, (n, rel, err, _) in held.items():
            v = held_bs.setdefault(k, {}).setdefault(level, {"calls": 0, "max_rel_err": 0.0,
                                                             "max_abs_err": 0.0})
            v["calls"] += n
            v["max_rel_err"], v["max_abs_err"] = max(v["max_rel_err"], rel), max(v["max_abs_err"],
                                                                                 err)
        return loss

    data = {}
    for s in S67_LEVELS:
        t0 = time.perf_counter()
        ds = data[s] = device_synthetic(s, S67_MESHES, TRAIN_BATCH, seed=s)
        print(f"[s{s} train] {TRAIN_BATCH} meshes ({S67_MESHES} distinct) built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        variables = bridge.init_variables(s, WIDTHS, seed=1)
        x, y, wt = next(iter(Batches(ds, TRAIN_BATCH, shuffle=False, device="cuda").epoch()))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tr = Trainer(s67_config("ico2ico", s), device="cuda")
        st = tr.init_state(variables)
        build.reset_launches()
        losses, times = [], []
        for _ in range(S67_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(tr.train_step(st, x, y, wt)["total"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        path = f"AE train (s{s})"
        launches[path] = dict(build.LAUNCHES)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        busy = step_busy_ms(lambda: tr.train_step(st, x, y, wt))
        print(f"[s{s} train] AE bs{TRAIN_BATCH} bf16, widths {WIDTHS}, default route: losses "
              f"{[round(v, 6) for v in losses]}; step {statistics.median(times[1:]):.3f} ms "
              f"(median of {len(times) - 1} after the first, {times[0]:.1f} ms; host clock, "
              f"synchronised) = {TRAIN_BATCH / statistics.median(times[1:]) * 1e3:.1f} "
              f"meshes/s; device busy {busy:.3f} ms a step; peak memory {peak:.1f} MiB above "
              f"the batch (torch.cuda.max_memory_allocated, model, Adam and activations; "
              f"{base / 2**20:.1f} MiB allocated before) [{card}]", flush=True)
        print(f"[s{s} train] kernel launches: {launches[path]}", flush=True)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"[s{s} train] non-finite loss: {losses}")
        check_launches(path, launches[path], S67_STEPS)
        held_step(path, tr, st, (x, y, wt))
        del tr, st
        torch.cuda.empty_cache()
        if s != S67_LEVELS[0]:
            continue
        tr = Trainer(s67_config("ico2ico", s), device="cuda")
        tr.model = IcoAE(s, WIDTHS, dtype=torch.bfloat16, pallas_blocks="none", device="cuda")
        ref = float(tr.train_step(tr.init_state(variables), x, y, wt)["total"])
        print(f"[s{s} train] the first step's loss {losses[0]:.6f}, the plain route's "
              f"{ref:.6f}: {abs(losses[0] - ref) / abs(ref):.2e} of it (bound 1e-2) [{card}]",
              flush=True)
        if not abs(losses[0] - ref) <= 1e-2 * abs(ref):
            raise AssertionError(f"[s{s} train] loss {losses[0]} vs the plain route's {ref}")
        del tr
        for route in S67_ROUTES:
            tr = Trainer(s67_config("ico2ico", s), device="cuda", **routing(route))
            st = tr.init_state(variables)
            path = f"AE train (s{s}, {route[2:]}"
            build.reset_launches()
            loss = held_step(path, tr, st, (x, y, wt))
            launches[path] = dict(build.LAUNCHES)
            print(f"[s{s} train] AE{route}: one step, loss {loss:.6f} [{card}]", flush=True)
            check_launches(path, launches[path], 1)
            del tr, st
        vae = "ico2ico_vae"
        tr = Trainer(s67_config(vae, s), device="cuda")
        st = tr.init_state(bridge.init_variables(s, WIDTHS, seed=1, model=vae,
                                                 latent_features=LATENT))
        path = f"VAE train (s{s})"
        build.reset_launches()
        loss = held_step(path, tr, st, (x, y, wt))
        launches[path] = dict(build.LAUNCHES)
        print(f"[s{s} train] VAE bs{TRAIN_BATCH} bf16, latent {LATENT}: one step, loss {loss:.6f} "
              f"[{card}]", flush=True)
        check_launches(path, launches[path], 1)
        del tr, st
        torch.cuda.empty_cache()
    return data[S67_LEVELS[0]]


# [dp]: two ranks, started by the script
DP_RANKS = 2


def state_bits(dp, tensors) -> torch.Tensor:
    """(world, n) int32: each rank's float32 tensors flattened into one row
    as raw bits (``DataParallel.gather``), to show the ranks hold the same
    values bit for bit."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    return dp.gather(flat.view(torch.int32)[None])


def dp_steps(dp, arrays, model: str, dtype_name: str, s: int, steps: int, evaluate: bool):
    """``steps`` Adam steps of the default route at the global batch of
    ``arrays`` (inputs, targets), this rank's slice under ``dp``, then the
    eval step: metrics, eval and count, the variables, the launches and,
    under ``dp``, every rank's state bits."""
    from geniconet_tpu_torch import bridge
    from geniconet_tpu_torch.data.datasets import IcoDataset
    from geniconet_tpu_torch.data.pipeline import Batches
    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.train.trainer import Trainer

    tr = Trainer(s67_config(model, s, dtype_name), device="cuda", dp=dp)
    st = tr.init_state(bridge.init_variables(s, WIDTHS, seed=1, model=model,
                                             latent_features=LATENT))
    shard = {} if dp is None else dict(rank=dp.rank, world=dp.world)
    ds = IcoDataset(*arrays, subdivisions=s)
    x, y, wt = next(iter(Batches(ds, TRAIN_BATCH, shuffle=False, device=tr.device,
                                 **shard).epoch()))
    build.reset_launches()
    out, times = {"steps": []}, []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["steps"].append({k: float(v) for k, v in tr.train_step(st, x, y, wt).items()})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = times
    if evaluate:
        ev, cnt = tr.eval_step(x, y, wt)
        out.update(eval={k: float(v) for k, v in ev.items()}, count=float(cnt))
    out["launches"] = dict(build.LAUNCHES)
    out["variables"] = tr.variables()
    if dp is not None:
        out["bits"] = state_bits(dp, tr.model.state_dict().values()).cpu().numpy()
    return out


def dp_rank(rank: int, world: int, port: int, work: str):
    """One rank of [dp] (a spawned process): the process group over the
    card(s) (``parallel/dist.py``: one card each over NCCL, else one shared
    card over gloo), then the AE float32 s=5 steps with eval, an s=6 bf16
    step and a VAE bf16 step; its results into ``work``."""
    import numpy as np

    from geniconet_tpu_torch.ops.kernels import build
    from geniconet_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp = dist.init(rank=rank, world=world, local_rank=rank, local_world=world,
                   init_method=f"tcp://localhost:{port}", timeout_s=600)
    try:
        build.library()
        data = np.load(f"{work}/data.npz")
        s5, s6 = (data["x5"], data["y5"]), (data["x6"], data["y6"])
        out = {"dp": str(dp), "backend": dp.backend,
               "ae": dp_steps(dp, s5, "ico2ico", "float32", SUBDIVISIONS, 2, True),
               "s6": dp_steps(dp, s6, "ico2ico", "bfloat16", S67_LEVELS[0], 1, False),
               "vae": dp_steps(dp, s5, "ico2ico_vae", "bfloat16", SUBDIVISIONS, 1, False)}
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, f"{work}/rank{rank}.pt")


def dp_phase(card: str, s5, s6, launches: dict):
    """Phase [dp]: ``DP_RANKS`` ranks started here (torch.multiprocessing,
    spawn), on one card each over NCCL where there are as many, else
    sharing the card over gloo. Two float32 steps and an eval of the AE on
    the kernel route at s=5, global bs36, must match one process at bs36
    (this one): the loss and eval to rtol 2e-6, the parameters and
    BatchNorm statistics to rtol 1e-4 / atol 1e-6 (the JAX package's bounds
    for its own DP, tests/test_pallas_dp.py); every rank's parameters and
    running statistics bit for bit; an s=6 bf16 step at full width and a
    VAE bf16 step with finite losses. A rank's failure fails the phase (the
    spawn raises)."""
    import socket
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    def close(a, b, rtol, atol, what):
        a, b = np.asarray(a), np.asarray(b)
        if not np.allclose(a, b, rtol=rtol, atol=atol):
            err = np.abs(a - b).max()
            raise AssertionError(f"[dp] {what}: max |DP - one process| {err} over rtol {rtol}, "
                                 f"atol {atol}")

    def leaves(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}") if isinstance(v, dict) else {f"{prefix}/{k}": v})
        return out

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        np.savez(f"{work}/data.npz", x5=s5[0], y5=s5[1], x6=s6[0], y6=s6[1])
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        mp.spawn(dp_rank, args=(DP_RANKS, port, work), nprocs=DP_RANKS, join=True)
        wall = time.perf_counter() - t0
        ranks = [torch.load(f"{work}/rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    one = dp_steps(None, s5, "ico2ico", "float32", SUBDIVISIONS, 2, True)
    print(f"[dp] {DP_RANKS} ranks, {ranks[0]['dp']} (rank 1: {ranks[1]['dp']}; "
          f"{torch.cuda.device_count()} card(s)): the ranks ran {wall:.1f} s, start included "
          f"[{card}]", flush=True)
    for r, res in enumerate(ranks):
        got = res["ae"]
        for k, (g, o) in enumerate(zip(got["steps"], one["steps"], strict=True)):
            close(g["total"], o["total"], 2e-6, 0.0, f"rank {r} step {k} loss")
        close(got["eval"]["total"], one["eval"]["total"], 2e-6, 0.0, f"rank {r} eval")
        if not got["count"] == one["count"] == TRAIN_BATCH:
            raise AssertionError(f"[dp] rank {r} count {got['count']}, one process "
                                 f"{one['count']}")
        ref = leaves(one["variables"])
        for k, v in leaves(got["variables"]).items():
            close(v, ref[k], 1e-4, 1e-6, f"rank {r} {k}")
        bits = res["ae"]["bits"]
        if not (bits == bits[:1]).all():
            raise AssertionError(f"[dp] rank {r} sees the ranks' parameters and statistics "
                                 "differ")
    print(f"[dp] AE float32 s={SUBDIVISIONS}, global bs{TRAIN_BATCH} "
          f"({TRAIN_BATCH // DP_RANKS} a rank), kernel route: losses {[s['total'] for s in ranks[0]['ae']['steps']]} vs one "
          f"process {[s['total'] for s in one['steps']]}, eval {ranks[0]['ae']['eval']['total']}"
          f" vs {one['eval']['total']} (rtol 2e-6), count {ranks[0]['ae']['count']}; "
          f"parameters and BatchNorm statistics within rtol 1e-4 / atol 1e-6; the ranks' "
          f"state bit-equal; step ms rank 0 {[round(t, 3) for t in ranks[0]['ae']['ms']]}, "
          f"one process {[round(t, 3) for t in one['ms']]} [{card}]", flush=True)
    for key, what in (("s6", f"AE bf16 s={S67_LEVELS[0]}, full width, global bs{TRAIN_BATCH}"),
                      ("vae", f"VAE bf16 s={SUBDIVISIONS}, global bs{TRAIN_BATCH}")):
        losses = [res[key]["steps"][0]["total"] for res in ranks]
        if not all(math.isfinite(v) for v in losses) or len(set(losses)) != 1:
            raise AssertionError(f"[dp] {what}: the ranks' losses {losses}")
        print(f"[dp] {what}: one step, loss {losses[0]:.6f} on every rank, "
              f"{ranks[0][key]['ms'][0]:.1f} ms on rank 0 (its first step) [{card}]", flush=True)
    for path, keys in (("AE train (dp)", ("ae", "s6")), ("VAE train (dp)", ("vae",))):
        launches[path] = dict(sum((collections.Counter(res[k]["launches"]) for res in ranks
                                   for k in keys), collections.Counter()))
        print(f"[dp] {path} kernel launches, both ranks: {launches[path]}", flush=True)
        check_launches(path, launches[path])
    return ranks[0]["backend"]


TRAIN_ROUTES = {"ico2ico": ("", " (merged)", " (chain)", " (chain, merged)",
                            " (chain, fold outside)", " (chain all)", " (chain all, merged)",
                            " (chain all, fold outside)", " (chain dec)", " (merged block)",
                            " (merged block, merged)", " (chain all, merged block)"),
                "ico2ico_vae": ("", " (merged)", " (chain)", " (chain all)", " (merged block)")}


def planted_for(model: str, route: str):
    if "merged block" in route:
        return PLANTED_BLOCK[:2] if "chain" in route else PLANTED_BLOCK
    if "chain all" in route or "chain dec" in route:
        return PLANTED_N
    return {"": PLANTED[model], " (merged)": PLANTED_MERGED[model]}.get(route) or \
        PLANTED_CHAIN[route]


def one_percent_off(r, path):
    """r with the tensor at the index path (into nested tuples) times 1.01."""
    if not path:
        return r * 1.01
    i, *rest = path
    return (*r[:i], one_percent_off(r[i], rest), *r[i + 1:])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU")
    from geniconet_tpu_torch import bridge
    from geniconet_tpu_torch.data.datasets import synthetic_dataset
    from geniconet_tpu_torch.ops.kernels import build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit

    t0 = time.perf_counter()
    build.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    stats = kernel_vs_plain(card, serving_cases(), "kernel", reps=10)
    train_stats = kernel_vs_plain(card, training_cases(), "train kernel", reps=10)
    for k, v in train_stats.items():
        if k in stats:  # a forward kernel: its main times stay the serving shapes'
            stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], v["max_abs_err"])
            stats[k]["training_shapes"] = {key: v[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "by_shapes")}
        else:
            stats[k] = v
    s67 = s67_kernels(card)
    batch_split_check(card)
    launches = {"std s2 train (op)": stride2_op(card)}  # path -> kernel launches in its run
    check_launches("std s2 train (op)", launches["std s2 train (op)"])

    vae = "ico2ico_vae"
    serve_vars = {
        "ico2ico": bridge.init_variables(SUBDIVISIONS, WIDTHS, seed=0, random_stats=True),
        vae: bridge.init_variables(SUBDIVISIONS, WIDTHS, seed=0, random_stats=True, model=vae,
                                   latent_features=LATENT),
    }
    states = {}
    for model, path in (("ico2ico", "AE serve"), (vae, "VAE serve")):
        build.reset_launches()
        states[model] = {name: serve(model, name, serve_vars[model], card)
                         for name in ("bfloat16", "float32")}
        launches[path] = dict(build.LAUNCHES)
        print(f"[serve {model}] kernel launches on the serving path: {launches[path]}", flush=True)
        check_launches(path, launches[path])
        plain_route_check(states[model]["float32"], card)
        for name, st in states[model].items():
            timings(st, name, card)
    # the AE on the encoder's phase chain (its latent cache goes through m),
    # and the AE and the VAE on both chains (every decode through n too)
    chained = {}
    for model, chain, path in (("ico2ico", "enc", "AE serve (chain)"),
                               ("ico2ico", "1", "AE serve (chain all)"),
                               (vae, "1", "VAE serve (chain all)")):
        build.reset_launches()
        chained[path] = {name: serve(model, name, serve_vars[model], card, phase_chain=chain)
                         for name in ("bfloat16", "float32")}
        launches[path] = dict(build.LAUNCHES)
        print(f"[serve {model} phase_chain={chain!r}] kernel launches on the serving path: "
              f"{launches[path]}", flush=True)
        check_launches(path, launches[path])
        for name, st in chained[path].items():
            chain_cache_check(st, states[model][name], name, card)
            timings(st, name, card)

    t0 = time.perf_counter()
    dataset = synthetic_dataset(SUBDIVISIONS, TRAIN_MESHES, seed=0)
    print(f"[train] {TRAIN_MESHES} synthetic meshes in {time.perf_counter() - t0:.1f} s",
          flush=True)
    train_vars = {
        "ico2ico": bridge.init_variables(SUBDIVISIONS, WIDTHS, seed=1),
        vae: bridge.init_variables(SUBDIVISIONS, WIDTHS, seed=1, model=vae,
                                   latent_features=LATENT),
    }
    runs = {}
    for model in ("ico2ico", vae):
        for route in TRAIN_ROUTES[model]:
            path = f"{'VAE' if model == vae else 'AE'} train{route}"
            runs[path] = {name: train(model, name, train_vars[model], dataset, card, route)
                          for name in ("bfloat16", "float32")}
            launches[path] = dict(sum((collections.Counter(r[-1]) for r in runs[path].values()),
                                      collections.Counter()))
        train_step_check(model, train_vars[model], card,
                         [(route, planted_for(model, route)) for route in TRAIN_ROUTES[model]])
    routing_compare(train_vars, dataset, card)
    t0 = time.perf_counter()
    val_dataset = synthetic_dataset(SUBDIVISIONS, VAL_MESHES, seed=1)
    for model in ("ico2ico", vae):
        kind = "VAE" if model == vae else "AE"
        path, eval_path = f"{kind} train (fit)", f"{kind} serve (eval)"
        explorer_path = f"{kind} serve (explorer)"
        launches[path], launches[eval_path], launches[explorer_path] = fit_phase(
            model, train_vars[model], dataset, val_dataset, card)
        for p in (path, eval_path, explorer_path):
            check_launches(p, launches[p])
    print(f"[fit] phase ran {time.perf_counter() - t0:.1f} s, the {VAL_MESHES} validation "
          f"meshes' build and the [eval] phase included", flush=True)
    t0 = time.perf_counter()
    held_bs = {}  # kernel -> its calls held inside the s=6/7 bs36 steps
    s6_data = s67_train(card, launches, held_bs)
    print(f"[s6/s7 train] phase ran {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dp_phase(card, (dataset.inputs[:TRAIN_BATCH], dataset.targets[:TRAIN_BATCH]),
             (s6_data.inputs, s6_data.targets), launches)
    print(f"[dp] phase ran {time.perf_counter() - t0:.1f} s", flush=True)

    profiled = []
    for path, (tr, st, (x, y, wt), _) in ((p, r["bfloat16"]) for p, r in runs.items()):
        route = path.partition(" train")[2].strip(" ()").replace(", ", "_").replace(" ", "_")
        tag = f"train_step_{tr.cfg.model.name}{'_' + route if route else ''}"
        profiled.append((f"{tag}_B{TRAIN_BATCH}",
                         lambda tr=tr, st=st, x=x, y=y, wt=wt: tr.train_step(st, x, y, wt), 5))
    device_profile(serving_workloads(states["ico2ico"]["bfloat16"])
                   + serving_workloads(chained["AE serve (chain)"]["bfloat16"], "_chain", b1=False)
                   + serving_workloads(chained["AE serve (chain all)"]["bfloat16"], "_chain_all")
                   + profiled, card)
    print(f"[time] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s, the build included",
          flush=True)

    def count(k, kind):
        return sum(n.get(k, 0) for path, n in launches.items() if kind in path)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "sources": [src, *SOURCES.get(k, ())],
         "replaces": rep, "redesigned": REDESIGNED[k],
         "launches": count(k, "serve") + count(k, "train"),
         "serving_launches": count(k, "serve"), "training_launches": count(k, "train"),
         "launches_by_path": {path: n.get(k, 0) for path, n in launches.items()},
         **stats[k], **s67[k], f"held_bs{TRAIN_BATCH}": held_bs.get(k, {})}
        for k, (src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
