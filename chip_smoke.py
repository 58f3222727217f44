#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serve and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, the
CUDA toolkit (nvcc) and PyTorch built for CUDA.  It imports nothing of JAX
and nothing of the ``repro`` package.  Phases, each of which exits
non-zero on failure:

1. the card: ``nvidia-smi``'s name and power limit; the kernels' build
   (``nvcc`` for sm_90a, from ``src/repro_torch/kernels/csrc`` alone);
2. each of the eleven Hopper kernels against its plain PyTorch version on
   the card, at the paper's ``dlrm-criteo-tb`` widths (F=26, d=128, Z=32,
   |M| = 26,135,627 slots; QR m = 8,192; TT factors (589, 589, 589), dims
   (2, 8, 8), rank 8): ``robe_lookup`` and ``qrobe_lookup`` exactly
   (torch.equal), ``qr_lookup`` exactly in f32 and within 1e-2 in bf16,
   ``dot_interaction``, ``serve_fused`` and ``tt_lookup`` within
   rtol = atol = 1e-5 in f32 and 1e-2 in bf16; ``robe_lookup`` and
   ``qrobe_lookup`` in every regime of their block hash
   (``ROBE_REGIMES``, the recsys family's (10, 32) and (256, 32) among
   them), f32 and bf16, the sign on and off, B in 1, 509,
   512, with a row of 2^31 - 1, ``robe_lookup`` also at phase (g)'s
   shapes (``family_lookups``: F = 39 on the 337,634- and 540,214-slot
   arrays of xDeepFM and AutoInt, the two-tower's 8 fields at d = 256 and
   its item fields alone at table ids (4, 5, 6, 7), the Table-3 models' 8
   fields on 3,222 slots, and xDeepFM's array under a zipf batch of
   65,536 x 39), and at the LM family's token embeddings
   (``lm_lookups``: F = 1 at d = 1,024, 2,048, 2,560 and 5,120 on each
   LM's 8x array, 19.4M to 97.3M slots, B in 1, 509, 4,096),
   ``qrobe_lookup`` without and with a
   nonzero ``delta``, and also on rows that cross the circular wrap at |M|
   inside the last, partial scale group; ``tt_lookup`` at
   full width, with cores off 16-byte alignment, and at ``TT_SHAPES``
   (ranks 4 and 8, d3 = 3, d1 = 1, and rank 3, which has no instance),
   f32 and bf16, B in 1, 509, 512; ``dot_interaction`` also
   at the ragged shapes of its register tiling (F in 1..64, D in 1..130,
   B in 1..4099, with and without the diagonal) and ``serve_fused`` in the
   hash's general regime (Z = 16 with d = 24 and 40, bags of 3 with -1
   pads and an empty bag); the five backward kernels, each a sum in no
   fixed order, within ``1e-5 · A + 1e-7`` in f32 and ``1e-2 · A`` in
   bf16 of each element, ``A`` the same backward of the inputs'
   magnitudes: ``robe_lookup_bwd`` (the scatter-add into M) at every
   ``ROBE_REGIMES`` (d, Z), f32 and bf16, the sign on and off, B in 1,
   509, 512, on a B = 65,536 zipf batch from ``CtrStream`` (head rows
   repeat thousands of times), the same with one field at a single row (a
   chain of 65,536), on 65,536 samples of all-distinct rows, on rows that
   cross the wrap at |M| and rows whose ROBE block straddles a band edge
   of the bucketed scatter, on a cotangent with the strides autograd hands
   over, and on the quickstart's 18,400-slot array (d = 16, Z = 32) under
   a batch of 1,024 of its stream, and at phase (g)'s shapes as the
   forward and at the LM family's (F = 1, 32 to 160 pairs an item);
   ``qrobe_lookup_bwd`` (the scales' and
   delta's gradients) at every ``ROBE_REGIMES`` (d, Z) and B in 1, 509,
   512, on the zipf batch, on it with one field at a single row, on 65,536
   samples of all-distinct rows, on wrap rows, on rows whose line of slots
   straddles a scale group's edge, on an array whose last scale group (5
   slots) is shorter than Z, and with g at the concat's strides;
   ``qr_lookup_bwd`` at B in 1, 2,
   509, 512, on the zipf batch (13 fields of a single quotient row) and on
   it with a multi-Q-row field at one id, and on small tables at m = 1 and
   at m above every vocab, g contiguous and at the concat's strides;
   ``tt_lookup_bwd`` at full width (its ranked walk), off 16-byte
   alignment, at B in 1, 2, 509, 512, on the zipf batch, on it with one
   field at a single id and with one field whose samples share core1's
   row (an i2 run far longer than a group's share of the places), g also
   at the concat's strides, and at ``TT_SHAPES`` aligned and not (ranks 4
   and 8 on the ranked walk, rank 3 and 64,000-wide rows on the first
   design's walks, as ``bwd_plan`` says); ``serve_fused``'s backward
   (composed of ``robe_lookup``, ``dot_interaction_bwd`` and
   ``robe_lookup_bwd``) at the forward's shapes, dM and dbot; each in f32
   and bf16; ``dot_interaction_bwd`` at full width (F = 27, D = 128)
   at B = 512, 509 and the training batch 65,536, at the quickstart's
   (B = 1,024, F = 5, D = 16), at the forward's ragged shapes, and at B =
   1, 2 with D = 1, 3, 130 (4-byte copies), F = 1, 2, 27 and the largest
   F of each stage count at D = 128 up to the largest the wrapper takes,
   with g at the concat's row stride too, with and without the diagonal,
   within rtol = atol = 1e-5 in f32 and 1e-2 in bf16; then the ops'
   backwards through autograd with their launch counts (``serve_fused``:
   one each of its three kernels; ``qrobe_lookup`` without and with
   ``delta``);
3. the main paths at full width, each answering four padded batches of
   512 requests (one with n_valid < 512) with every kernel's launch count
   set to 0 before the path and read after it:
   ``EmbeddingServer.score("robe", ...)`` through the fused path
   (``use_kernel=True``) and the unfused path on the same weights, then
   ``score`` for the ``qrobe``, ``hashed`` and ``tt`` substrates, each of
   which must launch its lookup kernel once a batch, ``dot_interaction``,
   and no other kernel (``qrobe`` adds its ``delta`` term inside its own
   launch); the scores must be finite, the two robe paths must agree within
   rtol = atol = 1e-4, and every path must agree as closely with the same
   entry point run on the CPU (the plain versions);
   then the training path of ``robe``, ``qrobe``, ``hashed`` and ``tt``,
   through ``train_loop.build_train_step``, ``init_state`` and ``run``
   with ``models.recsys.loss_fn`` (and ``make_project_fn`` for qrobe):
   (a) the quickstart config (4 fields, dim 16, 100x ROBE, batch 1024)
   with the substrate, adagrad (lr 0.08; qrobe 0.05), 400 steps for robe
   and 100 for the others, from the port's own init (seed 0) on the card,
   each step's loss within 2e-3 of the CPU step's from the same state and
   each param leaf's update read step by step (``UpdateErr``: each leaf's
   median within 1e-4 of its norm, and a leaf above 1e-3 in at most 1% of
   the steps, each such step printed); qrobe's step is read before its
   ``project`` (codes, scales and ``delta`` as leaves), then ``project``
   runs on the card's array on the card and on the CPU, which must agree
   bit for bit, ``delta`` zero after it; for robe then the CPU's own run,
   the two held-out AUCs (steps 5000-5007) within 2e-3; (b) full ``dlrm-criteo-tb`` width: three SGD steps at
   B = 512, the CPU's in the card's ReLU decisions (at most 4 of them
   taken a step), params after each within rtol = atol = 1e-4 of the CPU
   run and (robe, hashed, tt) each leaf's change since the start within
   1e-3 of its norm, then each card step again from the CPU's state, read as in
   (a); then five adagrad steps at B = 65,536 with finite losses and
   exactly one launch a step of the substrate's lookup and its backward,
   ``dot_interaction`` and ``dot_interaction_bwd``, and none of the
   others; every run with no restart and no non-finite loss; (a) again for
   ``full`` (100 steps; its lookup is PyTorch's row gather, so a step
   launches only ``dot_interaction`` and its backward); (c) the restart
   drill at full width (``restart_path``): robe adagrad at B = 65,536, 12
   steps of ``run`` with a checkpoint every 4 into a temporary directory
   and a node failure injected at step 9, beside the same run without it:
   one restart, 12 steps done, the global step going on at 8 from a state
   ``torch.equal`` to the step-8 checkpoint, the kernels launched once a
   step, losses within 2e-3 and each param leaf's change since the start
   within 1e-3 of its norm against the unbroken run's, then the
   ``AsyncCheckpointer.save`` stall, its write and ``restore_latest``
   timed (the directory is deleted);
4. times with CUDA events (median of 21 repetitions, launches queued behind
   a sleep kernel so the host does not starve the card): each forward
   kernel at B=512 and B=262144 beside its bound (``qrobe_lookup`` also
   with the params' ``delta``, whose bound adds a 4-byte read per touched
   slot), each backward kernel at B=512 and B=65536 (the training batch,
   with its passes by ``torch.profiler``), ``serve_fused``'s backward at
   B=512, each plain version at B=512,
   ``torch.bmm`` as the library yardstick of ``dot_interaction`` and of its
   backward, and ``score`` end to end for every path; plus a
   ``torch.profiler`` breakdown of ``score`` at B=262144 by device kernel
   for every path, with the card's busy share of the window; and one
   full-width adagrad training step at B=65536 of every substrate (host
   clock, median) with its own breakdown;
5. last of the paths, after the earlier phases' tensors are freed, (e)
   ``full`` against ``robe`` at ``dlrm-rm2`` width (d = 64) in one
   ``EmbeddingServer``, both unfused (``full_vs_robe``): the 52.3 GB full
   table's device lookup bit for bit equal to its ``cacheable_rows`` on a
   zipf batch, each path's launch counts and scores (full's against the
   CPU fed the same host rows through ``"emb"``), ``score`` at B=512 and
   B=262,144 in turns (robe, full, full, robe), a ``torch.profiler``
   breakdown of each at B=262,144, and the phase's peak device memory;
   then (f) the serving tier: on (e)'s tensors, a server of full, hashed
   (its own init) and robe with a 16,384-row ``HotRowCache`` in front of
   full and hashed, warmed on zipf-1.05 traffic (hashed's misses launch
   ``qr_lookup``, nothing else launches); cached scores ``np.array_equal``
   to uncached ones for full and hashed on four padded batches of 512,
   every resident row equal to the card's lookup of its id, ``score``
   cached against uncached at B=512 in turns with the hit rates; the
   replay (``run_grid``: full, hashed, robe × deadline, fixed on the JAX
   grid's trace, 1,024 requests at 2,000 Hz, 25 ms, batches of 32, on the
   measured card scorer; the zipf-4.0 control; one ``max_batch`` = 512
   row a backend at 70% of the capacity its B=512 ``score`` gives), each
   cell's launches; one ``AsyncRouter`` pass of 320 requests on hashed,
   each batch's scores equal to ``score`` of the same padded batch; then,
   with the 52 GB table freed, at full ``dlrm-criteo-tb`` width, the
   online push drill (``OnlineTrainer``, adagrad, B=65,536, 8 steps, a
   publish at 0 and 8 on a stream drifting every 4; a second server pushes
   each publish): on hashed with the cache, after every push the server's
   params ``torch.equal`` to the trainer's, the surviving cache rows equal
   to the new params' lookup, cached scores equal to uncached ones, then
   ``run_push_cell``; the same drill on robe without a cache; and a
   ``ReplicaFleet`` of 4 hashed replicas (``run_fleet_cell``, and
   ``run_fleet_push_cell`` staggered and synchronized with the drill's
   publishes); the phase's peak device memory;
   before (e), (g) the rest of the recsys family (``recsys_family``), on
   robe at 1000x with Z = 32: the registry's full ``autoint``
   (540,214 slots), ``xdeepfm`` (337,634; its CIN a chunk of the batch at
   a time) and ``two-tower-retrieval`` (28,726,016) bundles, and DCN,
   DeepFM and FiBiNET at the Table-3 widths (``TABLE3``), each from its
   own seeded init: ``serve_scores`` at B = 512 (padded) and 262,144 (the
   two-tower: ``retrieval_batch``'s query against 4,096 and 1,000,000
   candidates), launching robe_lookup once a call (retrieval twice) and
   nothing else, the first within ``SCORE_TOL`` of the CPU; three adam
   steps (lr 0.002) at B = 4,096 each shadowed by the CPU step from the
   same state (losses within 2e-3, each leaf's gradient, taken from
   adam's first moment, read by ``UpdateErr`` as phase 3 reads its three
   SGD steps; adam's update read beside it); five adagrad steps at B =
   65,536 (the two-tower: 16,384) with finite losses and one robe_lookup
   and one robe_lookup_bwd a step;
   ``score`` and the step timed (host clock, median of 3) with the step's
   device breakdown; robe_lookup and robe_lookup_bwd alone at each new
   shape beside their bounds; each configuration's peak device memory;
   (h) distribution on a one-rank NCCL mesh (a ``FileStore`` in a
   temporary directory; ``make_mesh((1, 1), ("data", "model"))`` on the
   card), every sharded code path at full width: inside (e), on its
   52.3 GB table (the rank's shard is the table itself), ``full``
   row-sharded over ``model`` and over the whole mesh (``2d``):
   ``score`` at B = 512 and 262,144 ``np.array_equal`` to the unsharded
   path's, timed in turns with it; after (f), ZeRO-3 ``robe`` at
   ``dlrm-criteo-tb`` width (26,135,627 slots): ``score`` at B = 512 and
   262,144 equal to the replicated unfused path's, one robe_lookup a call
   and no serve_fused; five adagrad steps at B = 65,536, each held to the
   undistributed card step from the same state (loss within 2e-3, updates
   by ``UpdateErr``), one robe_lookup and one robe_lookup_bwd a step, the
   array's gather and reduce-scatter once a step, timed beside the
   replicated step (host clock, median of 7); ``bf16`` and ``int8``
   compressed steps (three, finite), and on the card's gradient g with
   residual r: out + new_r == g + r exactly, |out - (g + r)| within half
   a bf16 ulp or half the int8 grid step; ``save`` of the ZeRO-3 state on
   the mesh and ``restore_onto`` it, bit for bit; the two-tower's
   retrieval of 10^6 candidates under the mesh, ``torch.equal`` to (g)'s
   scores;
   last, (i) the LM family and GatedGCN (``lm_gnn``), one part after
   another: GatedGCN's full config on ``full_graph_sm``, ``molecule`` and
   ``minibatch_lg`` (a Reddit-sized graph of 4,000,000 edges), 10 adam
   steps (lr 1e-3) each, each step against the CPU step from the same
   state in the card's ReLU decisions (at most RELU_FLIP_LIMIT of them
   taken a step): the loss, and ``UpdateErr`` on the step's gradient,
   taken from adam's first moment (minibatch_lg's first and last; with
   molecule, what a planted lost edge reads); ``qwen3-0.6b`` at
   full width and depth (28 layers, d = 1,024, 751.6M params), ``full`` and
   ``robe`` (8x: 19,447,808 slots) on the same layers: the f32 card against
   a CPU copy at B = 2, T = 64 (logits, loss, a decode chain and, on
   robe, one adam step read by ``UpdateErr``: its gradient, taken from
   adam's first moment, and its update held), bf16 decode against the bf16
   forward after a 256-token prefill, then the prefill of 32,768 tokens
   (last logits, the cache collected; its attention timed by CUDA events),
   16 decode steps at B = 8 on a 32,768-slot bf16 cache (30.1 GB) and 5
   adam steps (lr 3e-4) at B = 4, T = 4,096 with remat, each timed with its
   peak memory and launches (robe: one ``robe_lookup`` a forward and one
   ``robe_lookup_bwd`` a training step; full: none), a ``torch.profiler``
   breakdown of robe's last training step, and both ROBE kernels at the
   LM's shapes on its tokens, held to their plain versions (the forward
   equal, the backward within the scatter's bound) and timed beside their
   bounds; the MoE (``qwen3-moe-30b-a3b``), MLA
   (``minicpm3-4b``) and ``qwen1.5-32b`` configs at full width and 2
   layers: the f32 CPU check, a prefill of 4,096 tokens and 16 decode steps
   on its cache, and for ``qwen1.5-32b`` 16 decode steps at B = 8 on 32,768
   slots with an int8 cache against a bf16 cache of the same keys and
   values;
   then (j) the LM family and GatedGCN on a new one-rank NCCL mesh
   (``lm_gnn_mesh``), each call on the mesh held to the same call without
   it from the same state: ``qwen3-0.6b`` robe at full width and depth in
   f32 (params placed by ``transformer_specs``): a prefill of 4,096 tokens
   (``collect_cache``), 4 decode steps on caches cut along the sequence
   (``fill_cache``), logits within 1e-5, and 2 adam steps at B = 4, T =
   4,096 (remat), the loss within 1e-5 and the gradient (adam's first
   moment, ``UpdateErr``) with every leaf's median within 1e-5; one
   ``robe_lookup`` a forward and one ``robe_lookup_bwd`` a step, the
   collectives a call; ``qwen3-moe-30b-a3b`` at full width and 2 layers
   in f32, ``moe_dispatch="ep"`` at a capacity where no slot can drop
   against the dense dispatch without the mesh (a prefill of 4,096 tokens
   and 4 decode steps within 1e-5, two ``all_to_all`` a MoE layer a
   forward), then at the config's 1.25 the prefill's dropped slots
   (``Drops``); GatedGCN ``full_graph_sm`` through the edge-parallel body,
   3 adam steps held as (i) holds them, then timed in turns with the steps
   without the mesh; each path's times and peak memory;
   then (k) the launch tooling (``launch_cells``) on a new one-rank NCCL
   mesh: ``launch.cells.build_cell`` builds ``dlrm-criteo-tb``'s
   serve_p99, serve_bulk and train_batch cells on robe and GatedGCN's
   molecule cell; each cell's ``fn`` runs on real inputs from the seed
   (params from the port's init on the card), held with ``torch.equal``
   to the same function called without the mesh (``serve_scores``, or
   ``build_train_step`` of ``loss_fn`` and the cell's optimizer; the
   ROBE array's update, which ``robe_lookup_bwd``'s atomics sum in no
   fixed order, within the scatter's tolerance), with exactly the
   launches of ``K_LAUNCHES`` and no other kernel, and timed (median of
   ``K_REPS``); beside it, in processes on the host, the dry run's
   counters on the same one-rank calls (their FLOPs, bytes and H100
   roofline time) and ``python -m repro_torch.launch.dryrun --arch
   dlrm-rm2 --mesh both --force``, every record of which must be ok;
6. one JSON line of the recsys family's numbers, one of (h)'s, one of
   (i)'s, one of (j)'s, one of (k)'s, one of kernel numbers (the
   training kernels' ``launches_mesh``: (h)'s five ZeRO-3 steps; the ROBE
   kernels' ``launches_lm`` and ``lm`` times at (i)'s shapes and
   ``launches_lm_mesh`` of (j)'s prefill, decode step and training step;
   ``launches_cells``, (k)'s launches a cell), then, last, the ok line.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import unittest.mock
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np
import torch

from repro_torch.configs import GNN_SHAPES, get_arch
from repro_torch.configs.recsys_archs import CRITEO_TB_VOCABS
from repro_torch.core.robe import (init_memory,
                                   robe_slots)
from repro_torch.data import (CsrGraph, CtrDataConfig, CtrStream,
                              GraphSpec, LmDataConfig, LmStream,
                              NeighborSampler, RequestStream, SamplerConfig,
                              molecule_batch, retrieval_batch)
from repro_torch.dist import api as dist
from repro_torch.dist import collectives as coll
from repro_torch.dist.param_specs import (recsys_specs, replicated_specs,
                                          transformer_specs)
from repro_torch.kernels import (_build, dot_interaction_bwd_cuda,
                                 dot_interaction_cuda, launch_counts,
                                 qr_lookup_bwd_cuda, qr_lookup_cuda,
                                 qrobe_lookup_bwd_cuda, qrobe_lookup_cuda,
                                 reset_launches, robe_lookup_bwd_cuda,
                                 robe_lookup_cuda, serve_fused_cuda,
                                 tt_lookup_bwd_cuda, tt_lookup_cuda)
from repro_torch.kernels.dot_interaction import bwd_plan as di_bwd_plan
from repro_torch.kernels.ref import (dot_interaction_bwd_ref,
                                     dot_interaction_ref, interaction_sym,
                                     qr_indices, qr_lookup_bwd_ref,
                                     qr_lookup_ref, qrobe_dequant_ref,
                                     qrobe_lookup_bwd_ref, qrobe_lookup_ref,
                                     robe_lookup_bwd_ref, robe_lookup_ref,
                                     serve_fused_bwd_ref, serve_fused_ref,
                                     tt_indices, tt_lookup_bwd_ref,
                                     tt_lookup_ref)
from repro_torch.kernels import ops
from repro_torch.kernels.robe_lookup import bwd_plan
from repro_torch.kernels.tt_lookup import RANKS as TT_RANKS
from repro_torch.kernels.tt_lookup import bwd_plan as tt_bwd_plan
from repro_torch.kernels.serve_fused import serve_fused_bwd_cuda
from repro_torch.launch import cells as lcells
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import gatedgcn as gcn
from repro_torch.models import transformer as lm
from repro_torch.models.recsys import (RecsysConfig, forward, init_params,
                                       loss_fn, make_project_fn,
                                       serve_scores)
from repro_torch.nn import attention as attn_mod
from repro_torch.nn import moe as moe_mod
from repro_torch.nn.embeddings import get_backend
from repro_torch.nn.embedding_backends.hashed import (default_buckets,
                                                      qr_layout)
from repro_torch.nn.embedding_backends.qrobe import GROUP_LOG2
from repro_torch.nn.embedding_backends.tt import factor_dim, factor_rows
from repro_torch.serve.fleet import ReplicaFleet
from repro_torch.serve.replay import (ReplayConfig, run_cell,
                                      run_fleet_cell, run_fleet_push_cell,
                                      run_grid, run_push_cell)
from repro_torch.serve.router import (AsyncRouter, DeadlineBatcher,
                                      RouterConfig, stack_and_pad)
from repro_torch.serve.server import EmbeddingServer, ServerConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.metrics import auc
from repro_torch.train.online import OnlineConfig, OnlineTrainer
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.compression import compressed_psum
from repro_torch.train.elastic import train_state_specs
from repro_torch.train.train_loop import (TrainConfig, build_train_step,
                                          init_state, run)
from repro_torch.tree import leaves, tree_map, unflatten

SEED = 0
F, D = 26, 128
B_P99, B_BULK = 512, 262144           # RECSYS_SHAPES serve_p99 / serve_bulk
B_TRAIN = 65536                       # RECSYS_SHAPES train_batch
#: the compressed substrates served beside robe, and the kernel each
#: substrate's lookup runs
SUBSTRATES = {"qrobe": "qrobe_lookup", "hashed": "qr_lookup",
              "tt": "tt_lookup"}
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
#: the ragged dot_interaction shapes phase 2 checks beside full width
DI_ROWS = (1, 2, 4, 5, 8, 9, 28, 33, 64)
DI_WIDTHS = (1, 3, 24, 40, 130)
DI_BATCHES = (1, 31, 33, 509, 4099)
#: robe_lookup's phase-2 regimes (d, Z): Z < d with d not a multiple of Z,
#: Z = d, Z > d (rows share blocks), Z = 1, full width, and the recsys
#: family's: xDeepFM's Z > d with d not dividing Z (an item spans two
#: segments of the backward) and the two-tower's d = 256
ROBE_REGIMES = ((24, 16), (16, 16), (8, 32), (40, 1), (D, 32), (10, 32),
                (256, 32))
#: tt_lookup's narrow phase-2 shapes (dim, rank): (2, 3, 4) at rank 4,
#: (2, 3, 3) with d3 not a multiple of four, (1, 4, 4) with d1 = 1, and
#: rank 3, which has no instance of its own
TT_SHAPES = ((24, 4), (18, 8), (16, 8), (24, 3))
PHASE2_BATCHES = (1, 509, 512)
#: the substrate backwards' batches (B = 2: two items a field)
SUB_BWD_BATCHES = (1, 2, 509, 512)
SCORE_TOL = 1e-4
#: the scatter's bound: |got - want| <= rel · A + abs slot by slot, A the
#: scatter of |g| (a sum of aliased terms in no fixed order)
SCATTER_TOL = {torch.float32: (1e-5, 1e-7), torch.bfloat16: (1e-2, 0.0)}
#: the quickstart config of examples/quickstart.py (4 fields, dim 16, 100x
#: ROBE, batch 1024, adagrad lr 0.08, 400 steps) and its bounds, card
#: against CPU: every step's loss from the same state, the held-out AUC
QS_VOCABS = (40_000, 10_000, 60_000, 5_000)
QS_DIM, QS_BATCH = 16, 1024
QS_STEPS, QS_LOSS_TOL, QS_AUC_TOL = 400, 2e-3, 2e-3
TRAIN_TOL = 1e-4                      # full-width SGD params, card vs CPU
#: each param leaf's update, card against the CPU from the same state
#: (``UpdateErr``: |Δcard - Δcpu| / |Δcpu|, norms over the leaf).  The
#: quickstart runs read it step by step: each leaf's median over the steps
#: must be within UPDATE_MEDIAN_TOL, and at most UPDATE_FLAG_SHARE of the
#: steps may have any leaf above UPDATE_TOL (each such step is printed).
#: One step whose ReLU input, or adagrad's first touch of a slot, sits
#: within rounding of 0 can read far above UPDATE_TOL while the run is
#: sound; a zeroed, mis-signed or mis-slotted gradient reads about 1 on
#: every step.  The full-width SGD run, its CPU steps in the card's ReLU
#: decisions, reads its change since the start, each step within
#: UPDATE_TOL.  Summation order alone reads 2.4e-6 (the
#: port against the JAX package on the CPU, tests/test_torch_train.py)
#: and, card against CPU on an NVIDIA H100 80GB HBM3 at 700 W, about 7.5e-7
#: on the quickstart and 3.6e-5 after three free SGD steps at full width
#: (1.8e-4 on hashed's tables)
UPDATE_TOL = 1e-3
UPDATE_MEDIAN_TOL = 1e-4
UPDATE_FLAG_SHARE = 0.01
#: the compressed substrates' quickstart runs: steps and adagrad lr (qrobe
#: at tests/test_qrobe.py's 0.05)
SUB_QS_STEPS = 100
SUB_QS_LR = {"qrobe": 0.05, "hashed": 0.08, "tt": 0.08}
#: the kernels of a training step of each substrate, each launched once a
#: step
TRAIN_KERNELS = {
    kind: (lookup, lookup + "_bwd", "dot_interaction", "dot_interaction_bwd")
    for kind, lookup in (("robe", "robe_lookup"),
                         ("qrobe", "qrobe_lookup"), ("hashed", "qr_lookup"),
                         ("tt", "tt_lookup"))}
#: full's lookup is PyTorch's row gather (the JAX package's is a jnp.take,
#: no Pallas kernel): its step runs the interaction's two kernels
TRAIN_KERNELS["full"] = ("dot_interaction", "dot_interaction_bwd")
#: the restart drill at full width: robe adagrad at B_TRAIN, a checkpoint
#: every RESTART_EVERY steps, a node failure injected at RESTART_FAULT
RESTART_STEPS, RESTART_EVERY, RESTART_FAULT = 12, 4, 9
#: full against robe at dlrm-rm2 width (d = 64): the uncompressed table,
#: 204,185,088 padded rows x 64 f32 = 52.3 GB, fits one 80 GB card
RM2_DIM, RM2_BOT, RM2_TOP = 64, (512, 256, 64), (512, 512, 256, 1)
RM2_ROWS = 204_185_088
CACHE_CHECK_BATCH = 4096
#: (f) the serving tier: hot-row caches of 16,384 rows warmed on 32
#: batches of 256 requests; zipf 1.05 traffic and the 4.0 control; the
#: JAX package's serving grid trace (2,000 Hz, a 25 ms deadline, batches
#: of 32: benchmarks/table4_inference_throughput.py) cut to its first
#: 1,024 requests; one row a backend at max_batch 512 offered BIG_LOAD of
#: the capacity its B=512 score gives, 4,096 requests; the router's pass;
#: the online drill's steps, publishes (a full one and a delta) and
#: drift; the fleet's replicas.  The repetition counts were cut (from 64
#: warm batches, 4,096 and 16,384 requests, 24 drill steps with a publish
#: every 8 on a stream drifting every 8) to make room for phase (i); every
#: check of the phase stands
CACHE_ROWS, WARM_BATCHES = 16384, 32
ZIPF, ZIPF_CONTROL = 1.05, 4.0
GRID = ReplayConfig(n_requests=1024, rate_hz=2000.0, deadline_s=0.025,
                    max_batch=32, max_wait_s=0.050)
BIG_BATCH, BIG_LOAD, BIG_REQUESTS = 512, 0.7, 4096
ROUTER_REQUESTS = 320
ONLINE_STEPS, PUBLISH_EVERY, DRIFT_PERIOD = 8, 8, 4
#: the restart drill's rate: OnlineTrainer's default (adagrad at 0.05)
#: moves every weight by 0.05 on its first step, which at full width sends
#: the next loss past 1e6
ONLINE_LR = 1e-3
FLEET_REPLICAS = 4
#: the backwards of the compressed substrates' lookups and of serve_fused
#: (composed of robe_lookup, dot_interaction_bwd and robe_lookup_bwd)
SUBSTRATE_BWD = ("qrobe_lookup_bwd", "qr_lookup_bwd", "tt_lookup_bwd",
                 "serve_fused_bwd")
#: (g) the rest of the recsys family on robe at 1000x, Z = 32: the
#: registry's full autoint, xdeepfm and two-tower-retrieval bundles, and
#: DCN, DeepFM and FiBiNET at the Table-3 widths the repo trains them at
#: (benchmarks/common.py:22,36-54: BENCH_VOCABS, d = 16, |M| =
#: max(512, rows * d // 1000)); Table 3's optimizer for these families
#: (adam, lr 0.002: benchmarks/table3_kaggle_models.py) for the steps held
#: against the CPU, adagrad at full batch
BENCH_VOCABS = (50_000, 20_000, 80_000, 5_000, 30_000, 1_000, 15_000, 400)
TABLE3 = {"dcn": dict(arch="dcn", cross_layers=3, dnn=(64, 64)),
          "deepfm": dict(arch="deepfm", dnn=(64, 64)),
          "fibinet": dict(arch="fibinet", dnn=(64, 64))}
FAMILY = ("autoint", "xdeepfm", "two-tower-retrieval", *TABLE3)
FAMILY_LR, FAMILY_ADAM_B, FAMILY_ADAM_STEPS = 0.002, 4096, 3
FAMILY_STEPS, FAMILY_N_VALID = 5, 437
#: two-tower trains at 16,384: its in-batch logits are B^2 f32, 1.07 GB
#: there and 17.2 GB at 65,536 (and as much again in the softmax's
#: backward)
TWO_TOWER_B = 16384
#: retrieval_cand (1 query, 10^6 candidates) and the CPU's check of it
N_CAND, CPU_CAND = 1_000_000, 4096
G_SCORES = {}                         # (g)'s retrieval scores, for (h)
H_STEPS, H_COMPRESSED_STEPS, H_REPS = 5, 3, 7
FAMILY_REPS = 3
REPS = 21
#: card clock cycles a millisecond of ``torch.cuda._sleep`` (~2 GHz)
SLEEP_CYCLES_MS = 2_000_000
PROFILE_TRIES = 3
#: (i) the LM family and GatedGCN (the registry's LM_SHAPES and GNN_SHAPES,
#: cut to one card).  LM_ARCH at full width and depth, full and robe (8x):
#: the prefill at prefill_32k's length (batch 32 -> 1), decode on
#: decode_32k's cache length (batch 128 -> 8), train_4k's length (batch
#: 256 -> 4) with cells.py's adam lr; the card against the CPU at a small
#: batch in f32, and bf16 decode against the bf16 forward
LM_ARCH = "qwen3-0.6b"
LM_PREFILL_T = 32768
LM_DECODE_B, LM_CACHE, LM_DECODE_STEPS = 8, 32768, 16
LM_TRAIN_B, LM_TRAIN_T, LM_TRAIN_STEPS, LM_LR = 4, 4096, 5, 3e-4
LM_CHECK_B, LM_CHECK_T, LM_CPU_TOL = 2, 64, 1e-4
#: bf16 decode steps after a 256-token prefill, each step's logits within
#: LM_DECODE_TOL of the forward's largest |logit| at that position; the
#: int8 cache's decode logits within LM_INT8_TOL (relative norm) of the
#: bf16 cache's on the same keys and values (the JAX package's own int8
#: bound, tests/test_attention.py, is 0.05 of the logits)
LM_DECODE_CHECK_T, LM_DECODE_TOL, LM_INT8_TOL = 256, 5e-2, 5e-2
#: full width at reduced depth (layers kept), prefill 1 x LM_REDUCED_T
LM_REDUCED = {"qwen3-moe-30b-a3b": 2, "minicpm3-4b": 2, "qwen1.5-32b": 2}
LM_REDUCED_T = 4096
#: phase 2 at the LM family's token embeddings: F = 1, d = 1,024 to 5,120
#: (8 to 40 chunks of 128 a row), each LM's 8x array
LM_ROBE = ("qwen3-0.6b", "qwen3-moe-30b-a3b", "minicpm3-4b", "qwen1.5-32b")
LM_PHASE2_BATCHES = (1, 509, 4096)
#: (j) the LM and GatedGCN on the one-rank mesh, each held to the same
#: call without it: J_ARCH at full width and depth, f32 (robe); J_MOE_ARCH
#: at J_MOE_LAYERS layers, EP against the dense dispatch; GatedGCN's
#: full_graph_sm edge-parallel
J_ARCH, J_MOE_ARCH, J_MOE_LAYERS = "qwen3-0.6b", "qwen3-moe-30b-a3b", 2
J_PREFILL_T, J_DECODE_STEPS = 4096, 4
J_TRAIN_B, J_TRAIN_T, J_TRAIN_STEPS = 4, 4096, 2
J_GNN_STEPS, J_TOL = 3, 1e-5
# (k): the launch tooling's cells on a one-rank mesh, the launches each
# cell's call must make (every other kernel 0), the timed repetitions
K_CELLS = (("dlrm-criteo-tb", "serve_p99", "robe"),
           ("dlrm-criteo-tb", "serve_bulk", "robe"),
           ("dlrm-criteo-tb", "train_batch", "robe"),
           ("gatedgcn", "molecule", "default"))
_K_SERVE = {"robe_lookup": 1, "dot_interaction": 1}
K_LAUNCHES = {"serve": _K_SERVE,
              "train": {**_K_SERVE, "robe_lookup_bwd": 1,
                        "dot_interaction_bwd": 1},
              "gnn": {}}
K_REPS = 5
#: GatedGCN's full config, cells.py's adam lr; minibatch_lg samples a
#: graph of Reddit's 232,965 nodes and REDDIT_EDGES of its 114,615,892
#: edges (the most whose CsrGraph numpy builds in about 10 s on one core)
GNN_STEPS, GNN_LR, GNN_LOSS_TOL = 10, 1e-3, 1e-4
#: the median gradient reading of ``edge_sums``' leaves (UPDATE_TOL)
GNN_EDGE_SUM_TOL = UPDATE_TOL
GNN_TIME_STEPS = 3                    # timed after the held steps
ADAM_BETA1 = OptimizerConfig().beta1   # adam's first-moment decay
REDDIT_EDGES = 4_000_000
#: the steps of each cell held against the CPU (default every step):
#: minibatch_lg's CPU step takes ~20 s on the card's host, so its other
#: steps are checked on the card alone (finite losses, no kernel launched)
GNN_HELD = {"minibatch_lg": (0, 9)}
#: the most ReLU decisions a step the CPU may take from the card
#: (``ReluMasks``), about four times the most that sound runs read (NVIDIA
#: H100 80GB HBM3, 700 W; two whole-script runs and one of phase (i)):
#: GatedGCN full_graph_sm 8, molecule 46, minibatch_lg 50 of 13.5M-385.6M
#: a step; the recsys family 2 (``family_adam``); phase 3's full-width
#: SGD runs 1 of 1,900,544 (``full_width_path``: robe 0 at each of its
#: three steps, qrobe and hashed 1 then 0 and 0, tt 1, 1 and 0)
RELU_FLIP_LIMIT = {"full_graph_sm": 32, "molecule": 160,
                   "minibatch_lg": 200, "family": 8, "full_width": 4}
#: card -> (device memory bytes/s, f32 FLOP/s outside the tensor cores):
#: the H100 SXM data sheet's peaks
PEAKS = {"H100": (3.35e12, 67e12)}
KERNELS = {
    "robe_lookup": dict(
        source="src/repro_torch/kernels/csrc/robe_lookup.cu",
        replaces="src/repro/kernels/robe_lookup.py:262"),
    "dot_interaction": dict(
        source="src/repro_torch/kernels/csrc/dot_interaction.cu",
        replaces="src/repro/kernels/dot_interaction.py:37"),
    "serve_fused": dict(
        source="src/repro_torch/kernels/csrc/serve_fused.cu",
        replaces="src/repro/kernels/serve_fused.py:98"),
    "qrobe_lookup": dict(
        source="src/repro_torch/kernels/csrc/qrobe_lookup.cu",
        replaces="src/repro/kernels/robe_lookup.py:214"),
    "qr_lookup": dict(
        source="src/repro_torch/kernels/csrc/qr_lookup.cu",
        replaces="src/repro/kernels/qr_lookup.py:48"),
    "tt_lookup": dict(
        source="src/repro_torch/kernels/csrc/tt_lookup.cu",
        replaces="src/repro/kernels/tt_lookup.py:57"),
    "robe_lookup_bwd": dict(
        source="src/repro_torch/kernels/csrc/robe_lookup_bwd.cu",
        replaces="src/repro/kernels/ops.py:67"),
    "dot_interaction_bwd": dict(
        source="src/repro_torch/kernels/csrc/dot_interaction_bwd.cu",
        replaces="src/repro/kernels/ops.py:159"),
    "qrobe_lookup_bwd": dict(
        source="src/repro_torch/kernels/csrc/qrobe_lookup_bwd.cu",
        replaces="src/repro/kernels/ops.py:120"),
    "qr_lookup_bwd": dict(
        source="src/repro_torch/kernels/csrc/qr_lookup_bwd.cu",
        replaces="src/repro/kernels/ops.py:279"),
    "tt_lookup_bwd": dict(
        source="src/repro_torch/kernels/csrc/tt_lookup_bwd.cu",
        replaces="src/repro/kernels/ops.py:322"),
}


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple:
    for key, rates in PEAKS.items():
        if key in name:
            return rates
    raise SmokeFailure(f"no peak rates known for {name!r}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_rows(gen, shape, dev) -> torch.Tensor:
    """Uniform row ids per field over the CriteoTB vocabularies (so rows
    reach 40M-1, x*d past 2^32), last sample at each field's largest id."""
    vocab = torch.tensor(CRITEO_TB_VOCABS, dtype=torch.float64, device=dev)
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=dev)
    v = vocab.view((1, F) + (1,) * (len(shape) - 2))
    rows = torch.minimum(u * v, v - 1).to(torch.int32)
    rows[-1] = (v[0] - 1).to(torch.int32)
    return rows.contiguous()


def wrap_rows(gen, spec, dev, b: int = 509, chunk: int = 8192,
              edges=(0,)) -> torch.Tensor:
    """[b, F] random rows with, in place of some, every (row, field) found
    among 2^18 random samples whose d=128 elements reach slot e - 1 and go
    on to slot e inside one ROBE block, for an e of ``edges``; by default
    e = 0: slot |M| - 1 (in the last, partial scale group), then slot 0,
    the circular wrap.  Fails if none is found."""
    rows = random_rows(gen, (b, F), dev)
    tids = torch.arange(F, device=dev)[None, :]
    hits = []
    for _ in range(2 ** 18 // chunk):
        cand = random_rows(gen, (chunk, F), dev)
        s = robe_slots(spec, tids, cand, D)
        at = torch.zeros(s.shape[:-1], dtype=torch.bool, device=dev)
        for e in edges:
            at |= ((s[..., :-1] == (e - 1) % spec.size)
                   & (s[..., 1:] == e)).any(-1)
        hits += [(int(c), int(f), cand[c, f]) for c, f in
                 torch.nonzero(at).tolist()]
    require(len(hits) > 0, f"no row crosses a slot edge of {edges[:3]}")
    for k, (_, f, x) in enumerate(hits[:b]):
        rows[k, f] = x
    return rows.contiguous()


def group_edge_rows(gen, spec, dev, b: int = 509,
                    chunk: int = 8192) -> torch.Tensor:
    """[b, F] rows, each (row, field) one whose d=128 elements reach the
    last slot of a scale group and go on to the next group's first slot
    inside one ROBE block (so a line of the qrobe backward's flush sums two
    groups), drawn from random rows.  Fails if too few are found."""
    tids = torch.arange(F, device=dev)[None, :]
    found = [[] for _ in range(F)]
    for _ in range(64):
        cand = random_rows(gen, (chunk, F), dev)
        s = robe_slots(spec, tids, cand, D)
        at = ((s[..., 1:] == s[..., :-1] + 1)
              & (s[..., 1:] % (1 << GROUP_LOG2) == 0)).any(-1)
        for f in range(F):
            found[f].append(cand[at[:, f], f])
        if min(sum(x.numel() for x in c) for c in found) >= b:
            break
    cols = [torch.cat(c)[:b] for c in found]
    require(min(c.numel() for c in cols) == b,
            "too few rows straddle a scale group's edge")
    return torch.stack(cols, 1).contiguous()


def max_err(got, want) -> float:
    if got.numel() == 0:
        return 0.0
    return float((got.float() - want.float()).abs().max())


def qr_args(subs) -> tuple:
    """(q_off, r_off, m) of the ``hashed`` substrate's full-width layout."""
    vocabs = subs.recsys_config("hashed").vocab_sizes
    m = default_buckets(vocabs)
    _, q_off, r_off = qr_layout(vocabs, m)
    return tuple(map(int, q_off)), tuple(map(int, r_off)), m


def shared_i2(gen, rows, offsets, factors, field=None) -> torch.Tensor:
    """``rows`` with every sample of ``field`` (by default the one of the
    largest vocabulary) moved to one core1 row i2, its i1 and i3 drawn
    uniformly among those whose global row stays inside the field."""
    n1, n2, n3 = factors
    f = field if field is not None else max(
        range(F), key=lambda k: CRITEO_TB_VOCABS[k])
    lo, hi = offsets[f], offsets[f] + CRITEO_TB_VOCABS[f]
    first, last = -(-lo // (n2 * n3)), hi // (n2 * n3) - 1
    require(last > first, f"field {f} spans no whole i1")
    b = rows.shape[0]
    dev = rows.device
    i1 = torch.randint(first, last, (b,), generator=gen, device=dev)
    i3 = torch.randint(0, n3, (b,), generator=gen, device=dev)
    out = rows.clone()
    out[:, f] = ((i1 * n2 + 7) * n3 + i3 - lo).to(torch.int32)
    return out


def tt_args(subs) -> tuple:
    """(offsets, factors) of the ``tt`` substrate's full-width layout."""
    spec = subs.recsys_config("tt").embedding_spec()
    return tuple(map(int, spec.offsets)), factor_rows(spec.total_rows)


def check_kernels(gen, memory, spec, subs, dev) -> dict:
    """Max abs error of each kernel against its plain version, per dtype:
    {kernel: {"float32": e, "bfloat16": e}}.  ``subs`` is the server of the
    compressed substrates, whose full-width params the lookups read."""
    err = {k: {"float32": 0.0, "bfloat16": 0.0}
           for k in (*KERNELS, "serve_fused_bwd")}

    def record(k, got, want):
        key = str(got.dtype).removeprefix("torch.")
        err[k][key] = max(err[k][key], max_err(got, want))
    tids = tuple(range(F))
    rows = random_rows(gen, (B_P99, F), dev)

    # robe_lookup: a gather and a ±1 multiply, so exactly equal, in every
    # regime of the block hash (ROBE_REGIMES), both dtypes, the sign on and
    # off, on rows that include 2^31 - 1 (x*d past 2^32)
    robe_rows = rows.clone()
    robe_rows[0, 0] = 2 ** 31 - 1
    mems = {torch.float32: memory, torch.bfloat16: memory.to(torch.bfloat16)}
    for (dim, z), (dt, mem), sign, b in itertools.product(
            ROBE_REGIMES, mems.items(), (False, True), PHASE2_BATCHES):
        sp = dataclasses.replace(spec, block_size=z, use_sign=sign)
        got = robe_lookup_cuda(mem, robe_rows[:b], tids, dim, sp)
        want = robe_lookup_ref(mem, robe_rows[:b], tids, dim, sp)
        require(torch.equal(got, want),
                f"robe_lookup B={b} Z={z} d={dim} sign={sign} {dt}: max err "
                f"{max_err(got, want)}")
        record("robe_lookup", got, want)
    del mems
    # the recsys family's lookups (phase (g)), exactly equal too, both
    # dtypes, the sign on and off (``family_lookups``)
    for what, mem, idx, ids, dim, base in family_lookups(gen, dev):
        for m, sign in itertools.product((mem, mem.to(torch.bfloat16)),
                                         (False, True)):
            sp = dataclasses.replace(base, use_sign=sign)
            got = robe_lookup_cuda(m, idx, ids, dim, sp)
            want = robe_lookup_ref(m, idx, ids, dim, sp)
            require(torch.equal(got, want),
                    f"robe_lookup {what} d={dim} sign={sign} {m.dtype}: "
                    f"max err {max_err(got, want)}")
            record("robe_lookup", got, want)
    # the LM family's token embeddings (``lm_lookups``): one field, rows
    # of 8 to 40 chunks of 128
    for what, mem, idx, ids, dim, base in lm_lookups(gen, dev):
        for m, sign in itertools.product((mem, mem.to(torch.bfloat16)),
                                         (False, True)):
            sp = dataclasses.replace(base, use_sign=sign)
            got = robe_lookup_cuda(m, idx, ids, dim, sp)
            want = robe_lookup_ref(m, idx, ids, dim, sp)
            require(torch.equal(got, want),
                    f"robe_lookup {what} d={dim} sign={sign} {m.dtype}: "
                    f"max err {max_err(got, want)}")
            record("robe_lookup", got, want)
    torch.cuda.synchronize()

    # full width, then the ragged shapes of the register tiling: F rows not
    # a multiple of four, D not a multiple of four, batches of one, primes;
    # last, rows that leave the output stage only a window of shared memory
    # (inputs scaled down so that 2,148-long f32 sums stay within 1e-5)
    di_cases = [(b, F + 1, D, 1.0) for b in (B_P99, 509)] + [
        (b, f, d, 1.0) for f in DI_ROWS for d in DI_WIDTHS
        for b in DI_BATCHES] + [(3, F + 1, 2148, 0.125)]
    for b, f, d, scale in di_cases:
        for dtype in (torch.float32, torch.bfloat16):
            feats = (scale * torch.randn((b, f, d), generator=gen,
                                         device=dev)).to(dtype)
            for self_int in (False, True):
                got = dot_interaction_cuda(feats, self_int)
                want = dot_interaction_ref(feats, self_int)
                tol = TOL[dtype]
                require(got.shape == want.shape and got.dtype == dtype
                        and torch.allclose(got.float(), want.float(),
                                           rtol=tol, atol=tol),
                        f"dot_interaction B={b} F={f} D={d} {dtype} "
                        f"self={self_int}: max err {max_err(got, want)}")
                record("dot_interaction", got, want)
    torch.cuda.synchronize()

    # full width, then the hash's general regime (Z = 16 < d, d not a
    # multiple of Z's span of a warp); bags of 3 with -1 pads and an empty bag
    sf_cases = [(rows, D, spec)]
    for dim, z in ((D, 32), (24, 16), (40, 16)):
        bag3 = random_rows(gen, (509, F, 3), dev)
        pad = torch.rand((509, F, 3), generator=gen, device=dev) < 0.3
        bag3 = torch.where(pad, torch.full_like(bag3, -1), bag3)
        bag3[0, 0, :] = -1                                  # an empty bag
        sf_cases.append((bag3.contiguous(), dim,
                         dataclasses.replace(spec, block_size=z)))
    for idx, dim, base in sf_cases:
        b = idx.shape[0]
        for dtype in (torch.float32, torch.bfloat16):
            bot = torch.randn((b, dim), generator=gen, device=dev).to(dtype)
            for sign in (False, True):
                s = dataclasses.replace(base, use_sign=sign)
                got = serve_fused_cuda(memory, idx, bot, tids, dim, s)
                want = serve_fused_ref(memory, idx, bot, tids, dim, s)
                tol = TOL[dtype]
                require(got.shape == want.shape and got.dtype == dtype
                        and torch.allclose(got.float(), want.float(),
                                           rtol=tol, atol=tol),
                        f"serve_fused idx={tuple(idx.shape)} d={dim} "
                        f"Z={s.block_size} {dtype} sign={sign}: max err "
                        f"{max_err(got, want)}")
                record("serve_fused", got, want)
    torch.cuda.synchronize()

    # qrobe_lookup: codes and scales from quantizing the full |M|-slot
    # array, and a nonzero delta; a gather, f32 multiplies, one rounding
    # (and with delta a second term and one more), so exactly equal, in
    # every regime of the block hash, both dtypes, the sign on and off,
    # without and with delta; then on rows whose runs cross the circular
    # wrap at |M| inside the last, partial scale group
    qp = subs.params("qrobe")["embedding"]
    qspec = subs.recsys_config("qrobe").embedding_spec().robe
    scales = {torch.float32: qp["scale"],
              torch.bfloat16: qp["scale"].to(torch.bfloat16)}
    delta = 1e-3 * torch.randn(qspec.size, generator=gen, device=dev)
    wrap = wrap_rows(gen, qspec, dev)
    cases = [(robe_rows[:b], dataclasses.replace(qspec, block_size=z,
                                                 use_sign=s), dim)
             for (dim, z), s, b in itertools.product(
                 ROBE_REGIMES, (False, True), PHASE2_BATCHES)]
    cases += [(wrap, dataclasses.replace(qspec, use_sign=s), D)
              for s in (False, True)]
    for (idx, sp, dim), dt, dl in itertools.product(cases, scales,
                                                    (None, delta)):
        got = qrobe_lookup_cuda(qp["codes"], scales[dt], idx, tids, dim,
                                sp, GROUP_LOG2, dl)
        want = qrobe_lookup_ref(qp["codes"], scales[dt], idx, tids, dim,
                                sp, GROUP_LOG2, dl)
        require(torch.equal(got, want),
                f"qrobe_lookup B={idx.shape[0]} Z={sp.block_size} d={dim} "
                f"sign={sp.use_sign} {dt} delta={dl is not None}: max err "
                f"{max_err(got, want)}")
        record("qrobe_lookup", got, want)
    del delta
    torch.cuda.synchronize()

    # qr_lookup: one product rounded once, exactly equal in f32
    hp = subs.params("hashed")["embedding"]
    q_off, r_off, m = qr_args(subs)
    for b in (B_P99, 509):
        for dtype in (torch.float32, torch.bfloat16):
            q, r = hp["q_table"].to(dtype), hp["r_table"].to(dtype)
            got = qr_lookup_cuda(q, r, rows[:b], q_off, r_off, m)
            want = qr_lookup_ref(q, r, rows[:b], q_off, r_off, m)
            tol = TOL[dtype]
            same = torch.equal(got, want) if dtype == torch.float32 else \
                torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            require(same and got.shape == (b, F, D),
                    f"qr_lookup B={b} {dtype}: max err {max_err(got, want)}")
            record("qr_lookup", got, want)
    torch.cuda.synchronize()

    # tt_lookup: the full-width cores (the rank-8 instance), the same cores
    # off 16-byte alignment (the any-rank path), then narrow cores over the
    # full-width rows at each (dim, rank) of TT_SHAPES
    tp = subs.params("tt")["embedding"]
    offsets, factors = tt_args(subs)
    n1, n2, n3 = factors
    wide = [tp["core0"], tp["core1"], tp["core2"]]
    tt_cases = [("full width", wide, D), ("unaligned", wide, D)]
    for dim, rank in TT_SHAPES:
        d1, d2, d3 = factor_dim(dim)
        tt_cases.append((f"rank {rank}", [
            torch.randn(shape, generator=gen, device=dev) for shape in
            ((n1, d1, rank), (n2, rank, d2, rank), (n3, rank, d3))], dim))
    for (what, cores, dim), dtype, b in itertools.product(
            tt_cases, (torch.float32, torch.bfloat16), PHASE2_BATCHES):
        c = [x.to(dtype) for x in cores]
        if what == "unaligned":   # one element past an aligned start
            c = [torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:]
                 .view(x.shape).copy_(x) for x in c]
        got = tt_lookup_cuda(*c, rows[:b], offsets, factors, dim)
        want = tt_lookup_ref(*c, rows[:b], offsets, factors, dim)
        tol = TOL[dtype]
        require(got.shape == (b, F, dim) and got.dtype == dtype
                and torch.allclose(got.float(), want.float(), rtol=tol,
                                   atol=tol),
                f"tt_lookup {what} B={b} d={dim} {dtype}: max err "
                f"{max_err(got, want)}")
        record("tt_lookup", got, want)
    torch.cuda.synchronize()

    # an empty batch gives an empty output and launches nothing
    empty = rows[:0]
    for got in (qrobe_lookup_cuda(qp["codes"], qp["scale"], empty, tids, D,
                                  qspec, GROUP_LOG2),
                qr_lookup_cuda(hp["q_table"], hp["r_table"], empty, q_off,
                               r_off, m),
                tt_lookup_cuda(*wide, empty, offsets, factors, D)):
        require(got.shape == (0, F, D), f"B=0 gave {tuple(got.shape)}")
    err["robe_lookup_bwd"]["over_a"] = check_backwards(
        gen, spec, dev, robe_rows, di_cases, record)
    over = check_substrate_backwards(gen, spec, subs, dev, rows, robe_rows,
                                     record)
    for k, v in over.items():
        err[k]["over_a"] = v
    check_op_backwards(gen, spec, subs, rows, dev)
    return err


def scatter_err(got, want, a, dtype) -> float:
    """Fails unless every slot is within the scatter's bound; returns the
    largest |got - want| / A."""
    rel, abs_ = SCATTER_TOL[dtype]
    err = (got.float() - want.float()).abs()
    a = a.float()
    bad = int((err > rel * a + abs_).sum())
    require(bad == 0, f"{bad} slots outside the scatter bound: max err "
            f"{float(err.max())}")
    return float((err / a.clamp_min(1e-30)).max())


def check_substrate_backwards(gen, spec, subs, dev, rows, robe_rows,
                              record) -> dict:
    """Phase 2 for the backwards of the compressed substrates' lookups and
    of ``serve_fused``, beside their plain versions; returns each one's
    largest |error| / A per dtype.  Every gradient is a sum in no fixed
    order, held within ``SCATTER_TOL`` of the plain version element by
    element, ``A`` the same backward of the inputs' magnitudes (|g|,
    |code|, |Q|, |R|, the cores', M's and bot's), sign off."""
    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in SUBSTRATE_BWD}
    tids = tuple(range(F))

    def held(k, got, want, a, what):
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{k} {what}: {got.dtype} {tuple(got.shape)}, expected "
                f"{want.dtype} {tuple(want.shape)}")
        try:
            e = scatter_err(got, want, a, got.dtype)
        except SmokeFailure as exc:
            raise SmokeFailure(f"{k} {what}: {exc}") from None
        key = str(got.dtype).removeprefix("torch.")
        worst[k][key] = max(worst[k][key], e)
        record(k, got, want)

    zipf = bulk_inputs(gen, dev, B_TRAIN, 1)[0]
    # ids in the vocabularies; the qrobe lookup also takes a row of 2^31 - 1
    small = [(rows[:b], f"B={b}") for b in SUB_BWD_BATCHES]
    dtypes = (torch.float32, torch.bfloat16)

    # qrobe_lookup_bwd: every regime of the block hash at B = 1, 509, 512;
    # the zipf training batch; rows that cross the wrap at |M| inside the
    # partial last scale group; an array whose last group (5 slots) is
    # shorter than Z; at B = 65,536 one field at a single row (one band's
    # run over many chunks) and all-distinct rows; rows whose line of
    # slots straddles a scale group's edge; g at the concat's strides
    qp = subs.params("qrobe")["embedding"]
    qspec = subs.recsys_config("qrobe").embedding_spec().robe
    short = dataclasses.replace(qspec, size=(1 << 20) + 5)
    short_codes = torch.randint(-127, 128, (short.size,), generator=gen,
                                device=dev, dtype=torch.int8)
    cases = [(robe_rows[:b], dataclasses.replace(qspec, block_size=z,
                                                 use_sign=sg),
              dim, qp["codes"], f"B={b} Z={z} d={dim}")
             for (dim, z), sg, b in itertools.product(
                 ROBE_REGIMES, (False, True), PHASE2_BATCHES)]
    for sg in (False, True):
        cases += [
            (zipf, dataclasses.replace(qspec, use_sign=sg), D, qp["codes"],
             f"zipf B={B_TRAIN}"),
            (wrap_rows(gen, qspec, dev), dataclasses.replace(
                qspec, use_sign=sg), D, qp["codes"], "wrap rows"),
            (wrap_rows(gen, short, dev), dataclasses.replace(
                short, use_sign=sg), D, short_codes,
             f"|M| = {short.size}, wrap rows")]
    chain = zipf.clone()
    chain[:, 5] = 12345
    distinct = (torch.arange(B_TRAIN * F, device=dev, dtype=torch.int32)
                .view(F, B_TRAIN).t().contiguous())
    edge = group_edge_rows(gen, qspec, dev)
    for sg in (False, True):
        sp = dataclasses.replace(qspec, use_sign=sg)
        cases += [(chain, sp, D, qp["codes"],
                   f"one row in field 5 B={B_TRAIN}"),
                  (distinct, sp, D, qp["codes"],
                   f"distinct rows B={B_TRAIN}"),
                  (edge, sp, D, qp["codes"], "scale-group-edge rows"),
                  (zipf, sp, D, qp["codes"],
                   f"zipf B={B_TRAIN}, strided g"),
                  (edge, sp, D, qp["codes"],
                   "scale-group-edge rows, strided g")]
    for (idx, sp, dim, codes, what), dt in itertools.product(cases, dtypes):
        g = torch.randn((idx.shape[0], idx.shape[1] + 1, dim), generator=gen,
                        device=dev).to(dt)
        g = g[:, 1:] if what.endswith("strided g") else g[:, 1:].contiguous()
        gs, gd = qrobe_lookup_bwd_cuda(g, codes, idx, tids, dim, sp,
                                       GROUP_LOG2)
        ws, wd = qrobe_lookup_bwd_ref(g, codes, idx, tids, dim, sp,
                                      GROUP_LOG2)
        a_s, a_d = qrobe_lookup_bwd_ref(
            g.abs().float(), codes.abs(), idx, tids, dim,
            dataclasses.replace(sp, use_sign=False), GROUP_LOG2)
        tag = f"{what} sign={sp.use_sign} {dt}"
        held("qrobe_lookup_bwd", gs, ws, a_s, f"scale grad {tag}")
        held("qrobe_lookup_bwd", gd, wd, a_d, f"delta grad {tag}")
        del g, gs, gd, ws, wd, a_s, a_d
    del cases, short_codes, chain, distinct, edge
    torch.cuda.synchronize()

    # qr_lookup_bwd: the full-width tables at B = 1, 2, 509, 512, on the
    # zipf batch (13 fields of a single Q row: chains of B) and on it with
    # a multi-Q-row field at one id; small tables at m = 1 (a single R row
    # a field) and at m above every vocab (a single Q row a field); g also
    # at the strides of the model's concat
    hp = subs.params("hashed")["embedding"]
    q_off, r_off, m = qr_args(subs)
    full = (hp["q_table"], hp["r_table"], q_off, r_off, m)
    one_q = zipf.clone()
    multi = next(f for f in range(F) if CRITEO_TB_VOCABS[f] > 4 * m)
    one_q[:, multi] = 3 * m + 17
    qr_cases = [(idx, full, what) for idx, what in small + [
        (zipf, f"zipf B={B_TRAIN}"),
        (one_q, f"zipf, field {multi} at one id")]]
    vocab = 1000
    small_ids = torch.randint(0, vocab, (509, F), generator=gen, device=dev,
                              dtype=torch.int32)
    for mm in (1, 4096):
        q_rows = -(-vocab // mm)
        qr_cases.append((small_ids, (
            torch.randn((F * q_rows, D), generator=gen, device=dev),
            torch.randn((F * mm, D), generator=gen, device=dev),
            tuple(f * q_rows for f in range(F)),
            tuple(f * mm for f in range(F)), mm),
            f"vocab {vocab} m={mm}"))
    for (idx, (q, r, qo, ro, mm), what), dt, strided in itertools.product(
            qr_cases, dtypes, (False, True)):
        q, r = q.to(dt), r.to(dt)
        g = torch.randn((idx.shape[0], F + 1, D), generator=gen,
                        device=dev).to(dt)
        g = g[:, 1:] if strided else g[:, 1:].contiguous()
        got = qr_lookup_bwd_cuda(g, q, r, idx, qo, ro, mm)
        want = qr_lookup_bwd_ref(g, q, r, idx, qo, ro, mm)
        a = qr_lookup_bwd_ref(g.abs().float(), q.abs().float(),
                              r.abs().float(), idx, qo, ro, mm)
        for name, x, y, z in zip(("dQ", "dR"), got, want, a):
            held("qr_lookup_bwd", x, y, z,
                 f"{name} {what} strided={strided} {dt}")
        del g, got, want, a
    del qr_cases, one_q, small_ids
    torch.cuda.synchronize()

    # tt_lookup_bwd: the full-width cores (the ranked walk at rank 8) and
    # the same cores off 16-byte alignment, at B = 1, 2, 509, 512, on the
    # zipf batch, on it with one field at a single id (every item of the
    # field shares i1, i2 and i3) and with one field whose samples share
    # i2 but not i1 or i3 (an i2 run far longer than a group's share of the
    # places), g also at the concat's strides; narrow cores at each
    # TT_SHAPES, aligned and not (ranks 4 and 8 on the ranked walk, rank 3
    # on the first design's walks); rows too wide to stage
    tp = subs.params("tt")["embedding"]
    offsets, factors = tt_args(subs)
    n1, n2, n3 = factors
    chain = zipf.clone()
    chain[:, 5] = 12345
    wide = [tp["core0"], tp["core1"], tp["core2"]]
    tt_cases = [("full width", wide, D, idx, what)
                for idx, what in small + [(zipf, f"zipf B={B_TRAIN}"),
                                          (chain, "one id in field 5")]]
    for idx, what in ((rows[:509], "B=509"),
                      (shared_i2(gen, rows[:509], offsets, factors),
                       "B=509, one i2 in a field"),
                      (shared_i2(gen, zipf, offsets, factors),
                       f"zipf B={B_TRAIN}, one i2 in a field")):
        tt_cases += [(name, wide, D, idx, what)
                     for name in ("full width", "unaligned", "strided")]
    for dim, rank in TT_SHAPES:
        d1, d2, d3 = factor_dim(dim)
        cores = [torch.randn(shape, generator=gen, device=dev) for shape in
                 ((n1, d1, rank), (n2, rank, d2, rank), (n3, rank, d3))]
        tt_cases += [(f"rank {rank} d={dim}", cores, dim, idx, what)
                     for idx, what in small]
        tt_cases.append((f"unaligned rank {rank} d={dim}", cores, dim,
                         rows[:509], "B=509"))
    # rows of 64,000 elements at rank 1, which a block of the walk cannot
    # stage: g's row is read through L1 (tt_lookup.bwd_plan)
    cores = [torch.randn(shape, generator=gen, device=dev) for shape in
             ((n1, 8, 1), (n2, 1, 8, 1), (n3, 1, 1000))]
    tt_cases += [("rank 1 d=64000", cores, 64000, rows[:b], f"B={b}")
                 for b in (1, 2)]
    for (name, cores, dim, idx, what), dt in itertools.product(tt_cases,
                                                               dtypes):
        c = [x.to(dt) for x in cores]
        if name.startswith("unaligned"):   # one element past an aligned start
            c = [torch.empty(x.numel() + 1, dtype=dt, device=dev)[1:]
                 .view(x.shape).copy_(x) for x in c]
        rank, d1, d2, d3 = c[0].shape[2], c[0].shape[1], c[1].shape[2], \
            c[2].shape[2]
        want_inst = rank if rank in TT_RANKS else 0
        inst = tt_bwd_plan(d1, d2, d3, rank, n1, n2, n3).instance
        require(inst == want_inst,
                f"tt_lookup_bwd {name}: rank {rank} should take "
                f"{'the ranked walk' if want_inst else 'the first design'}")
        g = torch.randn((idx.shape[0], F + (name == "strided"), dim),
                        generator=gen, device=dev).to(dt)
        g = g[:, 1:] if name == "strided" else g
        got = tt_lookup_bwd_cuda(g, *c, idx, offsets, factors)
        want = tt_lookup_bwd_ref(g, *c, idx, offsets, factors)
        a = tt_lookup_bwd_ref(g.abs().float(), *(x.abs().float() for x in c),
                              idx, offsets, factors)
        for k, (x, y, z) in enumerate(zip(got, want, a)):
            held("tt_lookup_bwd", x, y, z, f"core{k} {name} {what} {dt}")
        del g, c, got, want, a
    del chain, zipf
    torch.cuda.synchronize()

    # serve_fused's backward (robe_lookup, dot_interaction_bwd and
    # robe_lookup_bwd composed) at the forward's shapes: full width, then
    # the hash's general regime with bags of 3, -1 pads and an empty bag
    memory = subs_memory(subs)
    sf_cases = [(rows, D, spec)]
    for dim, z in ((D, 32), (24, 16), (40, 16)):
        bag3 = random_rows(gen, (509, F, 3), dev)
        pad = torch.rand((509, F, 3), generator=gen, device=dev) < 0.3
        bag3 = torch.where(pad, torch.full_like(bag3, -1), bag3)
        bag3[0, 0, :] = -1                                  # an empty bag
        sf_cases.append((bag3.contiguous(), dim,
                         dataclasses.replace(spec, block_size=z)))
    for (idx, dim, base), dt, sg in itertools.product(sf_cases, dtypes,
                                                       (False, True)):
        b = idx.shape[0]
        sp = dataclasses.replace(base, use_sign=sg)
        bot = torch.randn((b, dim), generator=gen, device=dev).to(dt)
        g = torch.randn((b, (F + 1) * F // 2), generator=gen,
                        device=dev).to(dt)
        got = serve_fused_bwd_cuda(g, memory, idx, bot, tids, dim, sp)
        want = serve_fused_bwd_ref(g, memory, idx, bot, tids, dim, sp)
        a = serve_fused_bwd_ref(g.abs().float(), memory.abs(), idx,
                                bot.abs().float(), tids, dim,
                                dataclasses.replace(sp, use_sign=False))
        tag = f"idx={tuple(idx.shape)} d={dim} Z={sp.block_size} sign={sg}"
        held("serve_fused_bwd", got[0], want[0], a[0], f"dM {tag} {dt}")
        held("serve_fused_bwd", got[1], want[1], a[1],
             f"dbot {tag} {dt}")
    torch.cuda.synchronize()
    return worst


def check_op_backwards(gen, spec, subs, rows, dev) -> None:
    """The ops' backwards through autograd on the card, beside the plain
    versions, with the kernels each launches: ``serve_fused``'s (one
    ``robe_lookup``, ``dot_interaction_bwd`` and ``robe_lookup_bwd``, no
    other) and ``qrobe_lookup``'s without and with ``delta``."""
    tids = tuple(range(F))
    b = rows.shape[0]
    memory = subs_memory(subs).requires_grad_(True)
    bot = torch.randn((b, D), generator=gen, device=dev, requires_grad=True)
    ct = torch.randn((b, (F + 1) * F // 2), generator=gen, device=dev)
    reset_launches()
    out = ops.serve_fused(memory, rows, bot, tids, D, spec)
    gm, gb = torch.autograd.grad((out * ct).sum(), (memory, bot))
    torch.cuda.synchronize()
    c = launch_counts()
    need = ("serve_fused", "robe_lookup", "dot_interaction_bwd",
            "robe_lookup_bwd")
    require(all(n == (1 if k in need else 0) for k, n in c.items()),
            f"serve_fused's forward and backward launched {c}")
    with torch.no_grad():
        want = serve_fused_bwd_ref(ct, memory, rows, bot, tids, D, spec)
        a = serve_fused_bwd_ref(ct.abs(), memory.abs(), rows, bot.abs(),
                                tids, D,
                                dataclasses.replace(spec, use_sign=False))
    for x, y, z in zip((gm, gb), want, a):
        scatter_err(x, y, z, torch.float32)
    del memory, gm, want, a

    qp = subs.params("qrobe")["embedding"]
    qspec = subs.recsys_config("qrobe").embedding_spec().robe
    ct = torch.randn((b, F, D), generator=gen, device=dev)
    for with_delta in (False, True):
        scale = qp["scale"].clone().requires_grad_(True)
        delta = qp["delta"].clone().requires_grad_(True) if with_delta \
            else None
        reset_launches()
        out = ops.qrobe_lookup(qp["codes"], scale, rows, tids, D, qspec,
                               GROUP_LOG2, delta=delta)
        grads = torch.autograd.grad(
            (out * ct).sum(), (scale, delta) if with_delta else (scale,))
        torch.cuda.synchronize()
        c = launch_counts()
        require(all(n == (1 if k in ("qrobe_lookup", "qrobe_lookup_bwd")
                          else 0) for k, n in c.items()),
                f"qrobe_lookup's forward and backward launched {c}")
        want = qrobe_lookup_bwd_ref(ct, qp["codes"], rows, tids, D, qspec,
                                    GROUP_LOG2)
        a = qrobe_lookup_bwd_ref(ct.abs(), qp["codes"].abs(), rows, tids, D,
                                 dataclasses.replace(qspec, use_sign=False),
                                 GROUP_LOG2)
        for x, y, z in zip(grads, want, a):
            scatter_err(x, y, z, torch.float32)
    torch.cuda.synchronize()


def subs_memory(subs) -> torch.Tensor:
    """A full-width f32 ROBE array for serve_fused's backward: the qrobe
    substrate's dequantized codes."""
    qp = subs.params("qrobe")["embedding"]
    return qrobe_dequant_ref(qp["codes"], qp["scale"], GROUP_LOG2)


def check_backwards(gen, spec, dev, robe_rows, di_cases, record) -> dict:
    """Phase 2 for the two backward kernels, beside their plain versions;
    returns the scatter's largest |error| / A per dtype."""
    worst = {"float32": 0.0, "bfloat16": 0.0}

    def robe_case(rows, g, sp, what, tids=None):
        tids = tuple(range(rows.shape[1])) if tids is None else tids
        got = robe_lookup_bwd_cuda(g, rows, tids, g.shape[2], sp)
        want = robe_lookup_bwd_ref(g, rows, tids, g.shape[2], sp)
        a = robe_lookup_bwd_ref(g.abs(), rows, tids, g.shape[2],
                                dataclasses.replace(sp, use_sign=False))
        require(got.shape == (sp.size,) and got.dtype == g.dtype,
                f"robe_lookup_bwd {what}: {got.dtype} {tuple(got.shape)}")
        try:
            key = str(g.dtype).removeprefix("torch.")
            worst[key] = max(worst[key], scatter_err(got, want, a, g.dtype))
        except SmokeFailure as e:
            raise SmokeFailure(f"robe_lookup_bwd {what}: {e}") from None
        record("robe_lookup_bwd", got, want)

    # every regime of the block hash, both dtypes, the sign on and off
    for (dim, z), dt, sign, b in itertools.product(
            ROBE_REGIMES, (torch.float32, torch.bfloat16), (False, True),
            PHASE2_BATCHES):
        sp = dataclasses.replace(spec, block_size=z, use_sign=sign)
        g = torch.randn((b, F, dim), generator=gen, device=dev).to(dt)
        robe_case(robe_rows[:b], g, sp,
                  f"B={b} Z={z} d={dim} sign={sign} {dt}")
    # a zipf batch of the training shape: head rows repeat thousands of
    # times, so their slots take contended atomics; the same with one field
    # at a single row (a chain of B); a batch of all-distinct rows; rows
    # that cross the wrap at |M|, and rows whose ROBE block straddles the
    # edge of a band of the bucketed scatter (slot k * 2^BAND_LOG2); a
    # cotangent at the strides of the model's concat
    zipf = bulk_inputs(gen, dev, B_TRAIN, 1)[0]
    chain = zipf.clone()
    chain[:, 5] = 12345
    distinct = (torch.arange(B_TRAIN * F, device=dev, dtype=torch.int32)
                .view(F, B_TRAIN).t().contiguous())
    wrap = wrap_rows(gen, spec, dev)
    band = bwd_plan(spec, F, B_TRAIN * F, D).band_log2
    straddle = wrap_rows(gen, spec, dev, edges=tuple(
        k << band for k in range(1, ((spec.size - 1) >> band) + 1)))
    wide = torch.randn((wrap.shape[0], F + 1, D), generator=gen, device=dev)
    for dt, sign in itertools.product((torch.float32, torch.bfloat16),
                                      (False, True)):
        sp = dataclasses.replace(spec, use_sign=sign)
        g = torch.randn((B_TRAIN, F, D), generator=gen, device=dev).to(dt)
        robe_case(zipf, g, sp, f"zipf B={B_TRAIN} sign={sign} {dt}")
        robe_case(chain, g, sp, f"one row in field 5 B={B_TRAIN} "
                  f"sign={sign} {dt}")
        robe_case(distinct, g, sp, f"distinct rows B={B_TRAIN} sign={sign} "
                  f"{dt}")
        robe_case(wrap, wide[:, 1:].to(dt), sp,
                  f"wrap rows, strided g, sign={sign} {dt}")
        robe_case(straddle, wide[:, 1:].to(dt), sp,
                  f"band-edge rows, strided g, sign={sign} {dt}")
    # the quickstart's array (18,400 slots, d = 16, Z = 32) under a batch
    # of its own stream: 65,536 elements a step on so few slots contend
    qs_rows = quickstart_rows(dev)
    qs_spec = quickstart_config().embedding_spec().robe
    for dt, sign in itertools.product((torch.float32, torch.bfloat16),
                                      (False, True)):
        g = torch.randn(tuple(qs_rows.shape) + (QS_DIM,), generator=gen,
                        device=dev).to(dt)
        robe_case(qs_rows, g, dataclasses.replace(qs_spec, use_sign=sign),
                  f"quickstart B={qs_rows.shape[0]} sign={sign} {dt}")
    # the recsys family's shapes (``family_lookups``): on arrays that fit
    # in L2 a step's 2.6M items land on few slots
    for what, _, idx, ids, dim, base in family_lookups(gen, dev):
        for dt, sign in itertools.product((torch.float32, torch.bfloat16),
                                          (False, True)):
            g = torch.randn(tuple(idx.shape) + (dim,), generator=gen,
                            device=dev).to(dt)
            robe_case(idx, g, dataclasses.replace(base, use_sign=sign),
                      f"{what} d={dim} sign={sign} {dt}", ids)
    # the LM family's token embeddings: an item spans 32 to 160 pairs
    for what, _, idx, ids, dim, base in lm_lookups(gen, dev):
        for dt, sign in itertools.product((torch.float32, torch.bfloat16),
                                          (False, True)):
            g = torch.randn(tuple(idx.shape) + (dim,), generator=gen,
                            device=dev).to(dt)
            robe_case(idx, g, dataclasses.replace(base, use_sign=sign),
                      f"{what} d={dim} sign={sign} {dt}", ids)
    del zipf, chain, distinct, g
    torch.cuda.synchronize()

    # the forward's shapes, the training batch at full width (the grid
    # stride loop takes many samples a block) and the quickstart's; at
    # full width also a cotangent with the row stride of the top MLP's
    # input (the concat of [bot, interaction])
    # then the pipeline's edges (B = 1, 2: a block holds fewer samples
    # than stages), the 4-byte copies (D = 1, 3, 130), F = 1, 2 and, at
    # D = 128, the largest F of each stage count (2, then 1 with narrower
    # windows of columns and rows), the last the largest the wrapper
    # takes; every one also with g at the concat's row stride
    def takes(f, dt, s):
        return di_bwd_plan(f, D, s, dt.itemsize).smem <= _build.MAX_SMEM \
            and (f * (f + 1) if s else f * (f - 1)) // 2 < 0x7FFF
    wide_f = set()
    for dt, s in itertools.product((torch.float32, torch.bfloat16),
                                   (False, True)):
        fits = [f for f in range(1, 300) if takes(f, dt, s)]
        stages = {di_bwd_plan(f, D, s, dt.itemsize).stages for f in fits}
        for k in stages:
            wide_f.add(max(f for f in fits
                           if di_bwd_plan(f, D, s, dt.itemsize).stages >= k))
    edge_cases = [(b, f, d, 1.0) for b in (1, 2) for f in (1, 2, F + 1)
                  for d in (1, 3, 130)] + [(2, f, D, 1.0)
                                           for f in sorted(wide_f)]
    di_cases = list(di_cases) + [(B_TRAIN, F + 1, D, 1.0),
                                 (QS_BATCH, len(QS_VOCABS) + 1, QS_DIM, 1.0)]
    for b, f, d, scale in di_cases + edge_cases:
        p = f * (f - 1) // 2
        for dtype, self_int in itertools.product(
                (torch.float32, torch.bfloat16), (False, True)):
            if d == D and f > F + 1 and not takes(f, dtype, self_int):
                continue
            feats = (scale * torch.randn((b, f, d), generator=gen,
                                         device=dev)).to(dtype)
            n = p + f if self_int else p
            g = torch.randn((b, D + n), generator=gen,
                            device=dev).to(dtype)[:, D:]
            strided = (f, d) == (F + 1, D) or (b, f, d, scale) in edge_cases
            for gg in ((g, g.contiguous()) if strided
                       else (g.contiguous(),)):
                got = dot_interaction_bwd_cuda(gg, feats, self_int)
                want = dot_interaction_bwd_ref(gg, feats, self_int)
                tol = TOL[dtype]
                require(got.shape == feats.shape and got.dtype == dtype
                        and torch.allclose(got.float(), want.float(),
                                           rtol=tol, atol=tol),
                        f"dot_interaction_bwd B={b} F={f} D={d} {dtype} "
                        f"self={self_int} stride={gg.stride(0)}: max err "
                        f"{max_err(got, want)}")
                record("dot_interaction_bwd", got, want)
    torch.cuda.synchronize()
    return worst


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def padded_batches(n_valids, size: int, vocabs=CRITEO_TB_VOCABS,
                   n_dense: int = 13) -> list:
    """Padded request batches from ``RequestStream``: (batch, n_valid)."""
    stream = RequestStream(CtrDataConfig(vocab_sizes=vocabs,
                                         n_dense=n_dense, batch_size=size,
                                         seed=SEED))
    out = []
    for k, n in enumerate(n_valids):
        reqs = stream.requests(n, start=k * size)
        batch = {}
        for key in ("dense", "sparse"):
            rows = np.stack([r[key] for r in reqs])
            padded = np.zeros((size,) + rows.shape[1:], rows.dtype)
            padded[:n] = rows
            batch[key] = padded
        out.append((batch, n))
    return out


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def run_path(server, batches, backend: str = "robe") -> tuple:
    """Scores of every batch, with the launch counts of just this run."""
    reset_launches()
    scores = [server.score(backend, b, n) for b, n in batches]
    torch.cuda.synchronize()
    return scores, launch_counts()


def main_path(cfg: ServerConfig) -> tuple:
    fused = EmbeddingServer(cfg, device="cuda")
    params = fused.params("robe")
    unfused = EmbeddingServer(dataclasses.replace(cfg, use_kernel=False),
                              params={"robe": params}, device="cuda")
    robe_size = fused.recsys_config("robe").robe_size
    require(robe_size == 26_135_627 and
            params["embedding"]["memory"].shape == (robe_size,),
            f"ROBE array of {robe_size} slots, expected 26,135,627")
    batches = padded_batches((512, 512, 437, 512), B_P99)

    s_fused, c_fused = run_path(fused, batches)
    s_unfused, c_unfused = run_path(unfused, batches)
    print(f"launches fused path: {c_fused}; unfused path: {c_unfused}")
    require(c_fused["serve_fused"] > 0,
            "the fused path never launched serve_fused")
    require(c_unfused["robe_lookup"] > 0 and c_unfused["dot_interaction"] > 0,
            "the unfused path did not launch robe_lookup and "
            "dot_interaction")
    for (_, n), a, b in zip(batches, s_fused, s_unfused):
        require(a.shape == (n,) and b.shape == (n,),
                f"scores of shape {a.shape} / {b.shape}, expected ({n},)")
        require(np.isfinite(a).all() and np.isfinite(b).all(),
                "non-finite scores")
        require(np.allclose(a, b, rtol=SCORE_TOL, atol=SCORE_TOL),
                f"fused and unfused scores differ by "
                f"{np.abs(a - b).max()}")

    # the same entry point on the CPU (the plain versions), padded batch
    cpu = EmbeddingServer(dataclasses.replace(cfg, use_kernel=False),
                          params={"robe": to_device(params, "cpu")},
                          device="cpu")
    want = cpu.score("robe", *batches[2])
    for got in (s_fused[2], s_unfused[2]):
        require(np.allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL),
                f"card scores differ from the CPU run by "
                f"{np.abs(got - want).max()}")
    cpu_err = max(float(np.abs(want - s).max())
                  for s in (s_fused[2], s_unfused[2]))
    agree = max(float(np.abs(a - b).max()) for a, b in zip(s_fused,
                                                           s_unfused))
    print(f"main path: 4 batches of {B_P99}, n_valid "
          f"{[n for _, n in batches]}; fused vs unfused max diff {agree}; "
          f"card vs CPU max diff {cpu_err}")
    return fused, unfused, c_fused, c_unfused


def substrate_paths(subs) -> dict:
    """``score`` of each compressed substrate at full width: launch counts
    of each path, finite scores, agreement with the CPU run of the same
    entry point on the same params.  Returns {substrate: launch counts}."""
    batches = padded_batches((512, 512, 437, 512), B_P99)
    cpu = EmbeddingServer(subs.cfg, params={
        k: to_device(subs.params(k), "cpu") for k in subs.backends},
        device="cpu")
    counts = {}
    for kind, kernel in SUBSTRATES.items():
        scores, c = run_path(subs, batches, kind)
        counts[kind] = c
        need = [kernel, "dot_interaction"]
        print(f"launches {kind} path: {c}")
        require(c[kernel] == len(batches) and
                all(c[k] > 0 for k in need) and
                all(n == 0 for k, n in c.items() if k not in need),
                f"the {kind} path must launch {kernel} once a batch, "
                f"dot_interaction, and no other kernel")
        diff = 0.0
        for (batch, n), got in zip(batches, scores):
            require(got.shape == (n,) and np.isfinite(got).all(),
                    f"{kind}: scores of shape {got.shape}, expected ({n},), "
                    f"or not finite")
            want = cpu.score(kind, batch, n)
            diff = max(diff, float(np.abs(got - want).max()))
            require(np.allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL),
                    f"{kind}: card scores differ from the CPU run by "
                    f"{np.abs(got - want).max()}")
        print(f"{kind} path: 4 batches of {B_P99}, n_valid "
              f"{[n for _, n in batches]}; card vs CPU max diff {diff}")
    return counts


def quickstart_config(kind: str = "robe") -> RecsysConfig:
    return RecsysConfig(
        name="quickstart", arch="dlrm", n_dense=4, bot_mlp=(32, QS_DIM),
        top_mlp=(32, 1), embed_dim=QS_DIM, vocab_sizes=QS_VOCABS,
        embedding=kind, robe_size=sum(QS_VOCABS) * QS_DIM // 100,
        robe_block=32)


def quickstart_stream() -> CtrStream:
    return CtrStream(CtrDataConfig(vocab_sizes=QS_VOCABS, n_dense=4,
                                   batch_size=QS_BATCH))


def quickstart_rows(dev) -> torch.Tensor:
    """The sparse ids [QS_BATCH, 4] of the quickstart's first batch."""
    return torch.from_numpy(quickstart_stream().batch_at(0)["sparse"]).to(dev)


def train_run(cfg: RecsysConfig, params, opt: OptimizerConfig, batch_at,
              n_steps: int, step_hook=None, project=None):
    """``run`` of ``n_steps`` from ``params`` (on their device) through
    the port's entry points, with the post-step ``project`` (qrobe's
    requantization, ``make_project_fn``) if given; ``step_hook(step_fn)``
    may wrap the step."""
    optimizer = make_optimizer(opt)
    # no restarts: a step that raises on the card fails the smoke
    tc = TrainConfig(max_restarts=0)
    step_fn = build_train_step(lambda p, b: loss_fn(p, cfg, b), optimizer,
                               tc, project=project)
    if step_hook is not None:
        step_fn = step_hook(step_fn)
    rep = run(init_state(params, optimizer, tc), step_fn, batch_at,
              n_steps, tc)
    require(rep.restarts == 0 and rep.nan_events == 0 and
            rep.steps_done == n_steps,
            f"{cfg.name} {opt.kind} on {leaves(params)[0].device}: "
            f"{rep.steps_done} steps, {rep.restarts} restarts, "
            f"{rep.nan_events} non-finite losses")
    return rep


def leaf_names(tree, prefix: str = "") -> list:
    """Names of ``tree``'s leaves in ``leaves`` order ("top/0/w")."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for k, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


class UpdateErr:
    """Per param leaf, the card's update (new - old) against the CPU's from
    the same state.  ``add`` reads one step: |Δcard - Δcpu| / |Δcpu| (norms
    over the leaf) per leaf; ``check`` holds each leaf's median over the
    steps within UPDATE_MEDIAN_TOL and lets at most UPDATE_FLAG_SHARE of
    the steps have any leaf above UPDATE_TOL, printing each such step.
    ``rel()`` is the whole run's sqrt(Σ|Δcard - Δcpu|² / Σ|Δcpu|²) per leaf,
    kept as information.  A backward that left a leaf's gradient zero reads
    1 there; summation order alone reads ~1e-7."""

    def __init__(self, params, device="cpu"):
        self.device = device     # where the readings are computed
        self.names = leaf_names(params)
        self.diff = [0.0] * len(self.names)
        self.norm = [0.0] * len(self.names)
        self.steps = []          # per step: {leaf: reading}
        self.flagged = []        # the readings above UPDATE_TOL

    def add(self, old, card, cpu) -> None:
        row = {}
        for i, (name, o, c, h) in enumerate(zip(
                self.names, leaves(old), leaves(card), leaves(cpu))):
            o = o.to(self.device).double()
            want = h.to(self.device).double() - o
            d = (c.to(self.device).double() - o) - want
            dn, wn = float(d.square().sum()), float(want.square().sum())
            self.diff[i] += dn
            self.norm[i] += wn
            r = (dn / wn) ** 0.5 if wn > 0 else (0.0 if dn == 0 else 1.0)
            row[name] = r
            if r > UPDATE_TOL:
                self.flagged.append({
                    "step": len(self.steps), "leaf": name, "reading": r,
                    "elements": int((d.abs() > 1e-3 * wn ** 0.5).sum())})
        self.steps.append(row)

    def rel(self) -> dict:
        return {n: (d / w) ** 0.5 if w > 0 else (0.0 if d == 0 else 1.0)
                for n, d, w in zip(self.names, self.diff, self.norm)}

    def medians(self) -> dict:
        return {n: statistics.median(row[n] for row in self.steps)
                for n in self.steps[0]}

    def check(self, what: str, median: bool = True,
              median_tol: float = UPDATE_MEDIAN_TOL) -> dict:
        """Fails unless the per-step reading holds (each leaf's median
        within ``median_tol``; without ``median``, only the bound on the
        flagged steps); returns its summary."""
        for f in self.flagged:
            print(f"{what}: step {f['step']} {f['leaf']} update reads "
                  f"{f['reading']:.3e} of its norm ({f['elements']} "
                  f"elements off by more than 1e-3 of it)")
        med = self.medians()
        bad = sorted({f["step"] for f in self.flagged})
        most = math.ceil(UPDATE_FLAG_SHARE * len(self.steps))
        require(not median or max(med.values()) <= median_tol,
                f"{what}: a leaf's median update reading is above "
                f"{median_tol}: {med}")
        require(len(bad) <= most,
                f"{what}: {len(bad)} of {len(self.steps)} steps have a leaf "
                f"above {UPDATE_TOL} (at most {most}): steps {bad}")
        return {"median": med, "max_median": max(med.values()),
                "flagged_steps": bad, "flagged": self.flagged,
                "whole_run": self.rel()}


def project_both(project, params, what: str):
    """qrobe's ``project`` of the card's unprojected ``params`` on the card
    and on a CPU copy: plain elementwise torch, so every leaf must agree bit
    for bit, and ``delta`` is zero after it.  Returns the card's."""
    card = project(params)
    cpu = project(to_device(params, "cpu"))
    for name, a, b in zip(leaf_names(card), leaves(card), leaves(cpu)):
        require(torch.equal(a.cpu(), b),
                f"{what}: project's {name} on the card differs from the "
                f"CPU's on the same array")
    require(not bool(card["embedding"]["delta"].any()),
            f"{what}: delta is not zero after project")
    return card


def codes_differ(card, cpu) -> int:
    """How many qrobe codes the projected params ``card`` hold otherwise
    than ``cpu`` (the CPU step's from the same state, projected): a slot
    whose w / scale sits at a rounding tie may round either way."""
    return int((card["embedding"]["codes"].cpu()
                != cpu["embedding"]["codes"]).sum())


def quickstart_path(kind: str = "robe") -> dict:
    """(a): examples/quickstart.py's run with the ``kind`` substrate on the
    card from the port's own init (seed 0), each step shadowed by the CPU
    step from the same state; for robe (400 steps) then the CPU's own run
    from the same params, for the compressed substrates 100 steps.

    Every card step's loss is held to the CPU step's from the same state,
    and so is its update of every param leaf (``UpdateErr``, read step by
    step): that reading sees the card's backward and optimizer, which the
    loss of a step does not.  For qrobe both steps are read before their
    ``project`` (its codes, scales and ``delta`` are leaves of the reading),
    then the card's state is projected by ``project_both``; the codes that
    the card's step sets otherwise than the CPU's (ties, each rounding the
    other way) are counted.
    Two free-running trajectories are not held to each other step by step:
    any change of summation order (the scatter's atomics, cuBLAS against
    the CPU's GEMMs) can flip a ReLU whose input is within rounding of 0,
    which changes a rarely seen ROBE slot's gradient by a large fraction
    and so, after adagrad's per-slot scaling, its update by up to ±lr; the
    runs then drift apart by 1e-3 and more.  Their held-out AUCs are held
    to each other, and the free runs' largest loss difference is reported.
    """
    cfg = quickstart_config(kind)
    n_steps = QS_STEPS if kind == "robe" else SUB_QS_STEPS
    gen = torch.Generator()
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, "cpu")
    stream = quickstart_stream()
    opt = OptimizerConfig(kind="adagrad", lr=SUB_QS_LR.get(kind, 0.08))
    project = make_project_fn(cfg)
    # both steps without the projection, which the shadow applies after
    # reading them (build_train_step applies it last, the same)
    cpu_step = build_train_step(lambda p, b: loss_fn(p, cfg, b),
                                make_optimizer(opt), TrainConfig())
    step_diff, card_s, off = [], [0.0], []
    upd = UpdateErr(params)

    def shadow(step_fn):
        def step(state, batch):
            old = to_device(state, "cpu")
            want, wm = cpu_step(old, to_device(batch, "cpu"))
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            loss = float(m["loss"])
            card_s[0] += time.perf_counter() - t0
            step_diff.append(abs(loss - float(wm["loss"])))
            upd.add(old["params"], state["params"], want["params"])
            if project is not None:
                state = dict(state, params=project_both(
                    project, state["params"],
                    f"quickstart qrobe step {len(step_diff) - 1}"))
                off.append(codes_differ(state["params"],
                                        project(want["params"])))
            return state, m
        return step

    def held_out_auc(p, where) -> float:
        scores, labels = [], []
        with torch.no_grad():
            for s in range(5000, 5008):
                b = stream.batch_at(s)
                batch = {k: torch.from_numpy(v).to(where)
                         for k, v in b.items()}
                scores.append(forward(p, cfg, batch).cpu().numpy())
                labels.append(b["label"])
        return auc(np.concatenate(labels), np.concatenate(scores))

    reset_launches()
    card = train_run(cfg, to_device(params, "cuda"), opt, stream.batch_at,
                     n_steps, shadow)
    torch.cuda.synchronize()
    c = launch_counts()
    losses = np.asarray(card.losses)
    what = f"quickstart {kind}"
    require(len(losses) == n_steps and np.isfinite(losses).all() and
            len(step_diff) == n_steps,
            f"{what}: non-finite or missing losses on the card")
    require(all(n == (n_steps if k in TRAIN_KERNELS[kind] else 0)
                for k, n in c.items()),
            f"{what} on the card launched {c}")
    require(max(step_diff) <= QS_LOSS_TOL,
            f"{what}: a card step's loss differs from the CPU step's "
            f"from the same state by {max(step_diff)} at step "
            f"{int(np.argmax(step_diff))}")
    reading = upd.check(what)
    res = {"steps": n_steps, "lr": opt.lr, "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]),
           "max_step_loss_diff": max(step_diff), "update": reading,
           "card_steps_s": card_s[0], "launches": c}
    if off:
        res["codes_differing_from_cpu_steps"] = sum(off)
    if kind == "robe":
        t0 = time.perf_counter()
        cpu = train_run(cfg, params, opt, stream.batch_at, n_steps)
        res["cpu_run_s"] = time.perf_counter() - t0
        free = np.abs(losses - np.asarray(cpu.losses))
        auc_card = held_out_auc(card.state["params"], "cuda")
        auc_cpu = held_out_auc(cpu.state["params"], "cpu")
        require(abs(auc_card - auc_cpu) <= QS_AUC_TOL,
                f"{what}: held-out AUC {auc_card} on the card, {auc_cpu} "
                f"on the CPU")
        res.update(loss_last_cpu=float(cpu.losses[-1]),
                   max_free_loss_diff=float(free.max()),
                   free_diff_step=int(free.argmax()), auc=auc_card,
                   auc_cpu=auc_cpu)
    print(json.dumps({f"train_quickstart_{kind}": res}))
    return res


def train_batches(b: int, n: int, dev) -> list:
    stream = CtrStream(CtrDataConfig(vocab_sizes=CRITEO_TB_VOCABS,
                                     n_dense=13, batch_size=b, seed=SEED))
    return [{k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(k).items()} for k in range(n)]


def full_width_path(cfg: RecsysConfig, params, kind: str = "robe") -> dict:
    """(b): three SGD steps at B=512 on the card and on the CPU, each CPU
    step in the card step's ReLU decisions (``ReluMasks``; the decisions
    that differ are counted, at most RELU_FLIP_LIMIT["full_width"] a
    step), params compared after each, and their change since the start
    by ``UpdateErr`` (M's change is far below the params' 1e-4 bound);
    then
    each card step again from the CPU run's state before it, read as the
    quickstart's steps are; then five adagrad steps at B=65536 with the
    launch counts of every step.

    The steps from the CPU's state: every leaf within UPDATE_TOL of its
    update's norm but in at most UPDATE_FLAG_SHARE of the steps, rounded up
    (one of three): a sample whose ReLU input sits within rounding of 0
    moves its whole backward (qrobe's bot/0/w read 1.1e-3 at step 0 on an
    NVIDIA H100 80GB HBM3 at 700 W, every element within 1e-3 of the
    update's norm).  The free runs are held in the card's decisions because
    one of them moves a run as much: a sample whose ReLU input the card
    puts on the other side of 0 than the CPU read up to 5.1e-3 of a leaf's
    change at step 0 (hashed and tt, one flip of 1,900,544 decisions, with
    the bias added in the GEMM's epilogue on the card), and the runs then
    part further at every step (to 1.1e-2 at step 2, tt); in the card's
    decisions the step-0 gradients agree to 2.2e-6 and the three steps'
    change since the start to 1.8e-4 (hashed's r_table), while a bias
    gradient 1% off on the card reads 1e-2.  qrobe's steps are read before
    their ``project``, which ``project_both`` then holds, as the
    quickstart's.  The free runs of
    qrobe are held by their losses and their params but the scales and
    codes: plain SGD moves its scales by about two orders more than its
    weights (their gradient sums g · code over a group), and once a code
    rounds the other way at a tie the two runs part (by 2e-2 of the
    changes since the start in two steps on that card); their change since
    the start is not read (the step-0 flip above read 1.1e-3 there)."""
    small = train_batches(B_P99, 3, "cpu")
    opt = OptimizerConfig(kind="sgd", lr=0.01)
    project = make_project_fn(cfg)
    start = to_device(params, "cpu")
    names = leaf_names(start)
    free = {"embedding/codes", "embedding/scale"} if project else set()
    runs, masks, flips = {}, [], []
    for on_card in (True, False):
        snaps = []

        def hook(step_fn, snaps=snaps, cpu=not on_card):
            def step(state, batch):
                before = state
                if cpu:
                    with ReluMasks(masks[len(snaps)]) as rep:
                        state, m = step_fn(state, batch)
                    require(rep.at == len(rep.masks) > 0,
                            f"{kind} full width SGD step {len(snaps)}: the "
                            f"CPU step made {rep.at} ReLU calls, the card's "
                            f"{len(rep.masks)}")
                    flips.append(rep.flips)
                else:
                    with ReluMasks() as rec:
                        state, m = step_fn(state, batch)
                    masks.append(rec.masks)
                raw = state
                if cpu and project is not None:
                    # the projection the card's step runs inside, here
                    # after the state before it is kept
                    state = dict(state, params=project(state["params"]))
                snaps.append({"loss": float(m["loss"]),
                              "before": before if cpu else None,
                              "raw": raw if cpu else None,
                              "after": state if cpu else None,
                              "params": [x.cpu()
                                         for x in leaves(state["params"])]})
                return state, m
            return step
        train_run(cfg, to_device(params, "cuda" if on_card else "cpu"), opt,
                  lambda k: small[k], 3, hook, project if on_card else None)
        runs[on_card] = snaps
    del masks
    require(max(flips) <= RELU_FLIP_LIMIT["full_width"],
            f"{kind} full width SGD: the CPU steps took {flips} ReLU "
            f"decisions from the card's (at most "
            f"{RELU_FLIP_LIMIT['full_width']} a step)")
    sgd_diff, since = 0.0, {}
    for k, (c, h) in enumerate(zip(runs[True], runs[False])):
        require(np.isfinite(c["loss"]) and
                abs(c["loss"] - h["loss"]) <= TRAIN_TOL,
                f"{kind} full width SGD step {k}: loss {c['loss']} on the "
                f"card, {h['loss']} on the CPU")
        for name, a, b in zip(names, c["params"], h["params"]):
            if name in free:
                continue
            require(torch.allclose(a, b, rtol=TRAIN_TOL, atol=TRAIN_TOL),
                    f"{kind} full width SGD step {k}: {name} differs by "
                    f"{float((a - b).abs().max())}")
            sgd_diff = max(sgd_diff, float((a - b).abs().max()))
        if project is None:
            upd = UpdateErr(start)
            upd.add(start, unflatten(start, c["params"]),
                    unflatten(start, h["params"]))
            for name, r in upd.rel().items():
                require(r <= UPDATE_TOL,
                        f"{kind} full width SGD step {k}: {name}'s change "
                        f"since the start differs from the CPU's by {r} of "
                        f"its norm")
                since[name] = max(since.get(name, 0.0), r)
    # each card step from the CPU run's state before it, read before its
    # projection
    card_step = build_train_step(lambda p, b: loss_fn(p, cfg, b),
                                 make_optimizer(opt), TrainConfig())
    upd = UpdateErr(start)
    off = 0
    for k, h in enumerate(runs[False]):
        new, _ = card_step(to_device(h["before"], "cuda"),
                           to_device(small[k], "cuda"))
        upd.add(h["before"]["params"], new["params"], h["raw"]["params"])
        if project is not None:
            off += codes_differ(
                project_both(project, new["params"],
                             f"{kind} full width SGD step {k}"),
                h["after"]["params"])
    # three steps: their medians would be one step's reading
    reading = upd.check(f"{kind} full width SGD", median=False)
    reading["change_since_start"] = since
    sgd_losses = [c["loss"] for c in runs[True]]
    del runs

    big = train_batches(B_TRAIN, 5, "cpu")
    per_step = []

    def count(step_fn):
        def step(state, batch):
            reset_launches()
            out = step_fn(state, batch)
            torch.cuda.synchronize()
            per_step.append(launch_counts())
            return out
        return step
    rep = train_run(cfg, params, OptimizerConfig(kind="adagrad", lr=1e-3),
                    lambda k: big[k], 5, count, project)
    require(len(rep.losses) == 5 and np.isfinite(rep.losses).all(),
            f"{kind} full width adagrad: losses {rep.losses}")
    for k, c in enumerate(per_step):
        require(all(n == (1 if name in TRAIN_KERNELS[kind] else 0)
                    for name, n in c.items()),
                f"{kind} full width adagrad step {k} launched {c}; expected "
                f"one each of {TRAIN_KERNELS[kind]} and no other kernel")
    res = {"sgd_b512_max_param_diff": sgd_diff,
           "sgd_b512_update": reading, "sgd_b512_losses": sgd_losses,
           "sgd_b512_relu_flips": flips,
           "sgd_b512_codes_differing_from_cpu_steps": off,
           "adagrad_b65536_losses": rep.losses,
           "launches_per_step": per_step[0],
           "launches": {k: sum(c[k] for c in per_step) for k in per_step[0]}}
    print(json.dumps({f"train_full_width_{kind}": res}))
    return res


def state_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree)
               if x is not None)


def restart_path(cfg: RecsysConfig, params) -> dict:
    """(c): the checkpoint and restart paths of ``run`` at full width.

    ``run`` of RESTART_STEPS robe adagrad steps at B_TRAIN with a
    checkpoint every RESTART_EVERY steps into a temporary directory and a
    node failure injected at step RESTART_FAULT, beside the same run
    without the fault.  The faulted run must restart once and rewind to
    the newest checkpoint (step 8): its first step after the restart sees
    global step 8 and batch 8, and a state ``torch.equal`` both to the
    step-8 checkpoint on disk and to the state its first step 8 saw; every
    step launches each kernel of ``TRAIN_KERNELS["robe"]`` once.  The
    replayed step 8 is read against the first step 8, from that same
    state, as the quickstart reads a step: the loss within QS_LOSS_TOL and
    each param leaf's update within UPDATE_TOL of its norm (the scatter's
    float atomics add in another order).  The faulted run's losses (steps
    0..8, then 8..11 again) must be within QS_LOSS_TOL of the unbroken
    run's.  Its final params are not held to the unbroken run's: two free
    runs on the card drift apart by their atomics alone, so the change
    since the start is read against the unbroken run and, as the control,
    between the unbroken run and a second unbroken run, and both are
    reported.  Then the ``AsyncCheckpointer.save`` stall (the host
    snapshot), its write and ``restore_latest`` onto the card are timed
    on the final state."""
    batches = train_batches(B_TRAIN, RESTART_STEPS, "cpu")
    optimizer = make_optimizer(OptimizerConfig(kind="adagrad", lr=1e-3))
    tc = TrainConfig(checkpoint_every=RESTART_EVERY, max_restarts=1)
    step_fn = build_train_step(lambda p, b: loss_fn(p, cfg, b), optimizer,
                               tc)
    rewind = RESTART_FAULT // RESTART_EVERY * RESTART_EVERY
    res = {"steps": RESTART_STEPS, "checkpoint_every": RESTART_EVERY,
           "fault_at": RESTART_FAULT, "batch": B_TRAIN}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for label, fault, keep in (("faulted", RESTART_FAULT, True),
                                   ("unbroken", None, True),
                                   ("control", None, False)):
            steps, fetched, at_rewind = [], [], []

            def spy(state, batch, steps=steps, at_rewind=at_rewind):
                steps.append(int(state["step"]))
                out = step_fn(state, batch)
                if steps[-1] == rewind:
                    at_rewind.append((state, out[0]))
                return out

            def batch_at(k, fetched=fetched):
                fetched.append(k)
                return batches[k]
            d = str(Path(tmp) / label) if keep else None
            reset_launches()
            t0 = time.perf_counter()
            rep = run(init_state(params, optimizer, tc), spy, batch_at,
                      RESTART_STEPS, tc, ckpt_dir=d, inject_fault_at=fault)
            torch.cuda.synchronize()
            runs[label] = (rep, steps, fetched, at_rewind, d,
                           launch_counts())
            res[f"{label}_run_s"] = time.perf_counter() - t0
            if keep:
                res[f"{label}_checkpoints"] = sorted(os.listdir(d))
        rep, steps, fetched, at_rewind, d, c = runs["faulted"]
        print(f"restart drill: step_fn saw global steps {steps}; batches "
              f"fetched {fetched}; checkpoints {res['faulted_checkpoints']}")
        require(rep.restarts == 1 and rep.steps_done == RESTART_STEPS and
                rep.nan_events == 0,
                f"restart drill: {rep.restarts} restarts, {rep.steps_done} "
                f"steps done, {rep.nan_events} non-finite losses")
        require(steps == list(range(RESTART_FAULT))
                + list(range(rewind, RESTART_STEPS)) and
                fetched == steps,
                f"restart drill: the global step did not go on at {rewind}")
        for label, r in runs.items():
            n, cc = len(r[1]), r[5]
            require(all(v == (n if k in TRAIN_KERNELS["robe"] else 0)
                        for k, v in cc.items()),
                    f"restart drill ({label}, {n} steps) launched {cc}")
        (first, first_out), (restored, replay_out) = at_rewind
        t0 = time.perf_counter()
        disk, man = ckpt.restore_latest(d, restored, step=rewind)
        torch.cuda.synchronize()
        res["restore_latest_s"] = time.perf_counter() - t0
        require(man["step"] == rewind and int(restored["step"]) == rewind,
                f"restart drill: restored step {int(restored['step'])}")
        for name, a, b, o in zip(leaf_names(restored), leaves(restored),
                                 leaves(disk), leaves(first)):
            require(a.device == b.device and torch.equal(a, b) and
                    torch.equal(a, o),
                    f"restart drill: the restored state's {name} differs "
                    f"from the step-{rewind} checkpoint or from the state "
                    f"the first step {rewind} saw")
        # the replayed step against the first run of it, same state
        replay = UpdateErr(first["params"])
        replay.add(to_device(first["params"], "cpu"), replay_out["params"],
                   to_device(first_out["params"], "cpu"))
        replay_reading = replay.rel()
        for name, r in replay_reading.items():
            require(r <= UPDATE_TOL,
                    f"restart drill: the replayed step {rewind}'s update of "
                    f"{name} reads {r} of its norm against the first run "
                    f"of that step from the same state")
        clean, control = runs["unbroken"][0], runs["control"][0]
        # the losses of the first and the replayed step `rewind`
        require(abs(rep.losses[rewind] - rep.losses[RESTART_FAULT])
                <= QS_LOSS_TOL,
                "restart drill: the replayed step's loss differs")
        want = clean.losses[:RESTART_FAULT] + clean.losses[rewind:]
        diff = np.abs(np.asarray(rep.losses) - np.asarray(want))
        require(len(rep.losses) == len(want) and
                float(diff.max()) <= QS_LOSS_TOL,
                f"restart drill: losses {rep.losses} against the unbroken "
                f"run's {want}")
        start = to_device(params, "cpu")
        since = {}
        for label, a, b in (("vs_unbroken", rep, clean),
                            ("control", control, clean)):
            upd = UpdateErr(start)
            upd.add(start, a.state["params"],
                    to_device(b.state["params"], "cpu"))
            since[label] = upd.rel()
        final_disk, fman = ckpt.restore_latest(d, rep.state)
        require(fman["step"] == RESTART_STEPS and all(
            torch.equal(a, b) for a, b in zip(leaves(final_disk),
                                              leaves(rep.state))),
                "restart drill: the final checkpoint is not the final state")
        res.update(max_loss_diff=float(diff.max()),
                   replayed_step_update=replay_reading,
                   change_since_start=since, losses=rep.losses,
                   losses_unbroken=clean.losses,
                   losses_control=control.losses, launches=c,
                   state_bytes=state_bytes(rep.state))
        del runs, at_rewind, first, first_out, restored, replay_out, disk
        # one save of the final state: the stall is the host snapshot, the
        # write runs on the saver's thread until wait() returns
        saver = ckpt.AsyncCheckpointer(str(Path(tmp) / "timed"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save(RESTART_STEPS, rep.state)
        t1 = time.perf_counter()
        saver.wait()
        t2 = time.perf_counter()
        ckpt.restore_latest(str(Path(tmp) / "timed"), rep.state)
        torch.cuda.synchronize()
        res.update(save_stall_ms=(t1 - t0) * 1e3, write_ms=(t2 - t1) * 1e3,
                   restore_ms=(time.perf_counter() - t2) * 1e3)
    print(json.dumps({"restart_full_width_robe": res}))
    return res


def rm2_server_config() -> ServerConfig:
    """full and robe at ``dlrm-rm2`` width (d = 64), both unfused."""
    return ServerConfig(vocab_sizes=CRITEO_TB_VOCABS, embed_dim=RM2_DIM,
                        n_dense=13, bot_mlp=RM2_BOT, top_mlp=RM2_TOP,
                        backends=("full", "robe"), robe_compression=1000,
                        robe_block=32, cache_capacity=0, use_kernel=False,
                        seed=SEED)


def full_vs_robe() -> tuple:
    """(e): one ``EmbeddingServer`` holding full and robe at dlrm-rm2 width,
    both on the unfused path.  full's device lookup must equal its
    ``cacheable_rows`` bit for bit on a zipf batch; each path answers four
    padded batches of 512 with its launch counts (full: dot_interaction
    once a batch and nothing else; robe: robe_lookup and dot_interaction);
    full's scores must equal, within SCORE_TOL, the CPU's ``serve_scores``
    fed those host rows through the batch's ``"emb"`` key (the hot-row
    cache's route: the 52 GB table never leaves the card), robe's the CPU
    run of the same entry point.  Then ``score`` is timed at B=512 (median
    of 21) and B=262,144 in turns (robe, full, full, robe), profiled at
    B=262,144, and the card's peak memory of the phase is read.  Returns
    (results, server): the serving tier's phase reuses the server."""
    torch.cuda.reset_peak_memory_stats()
    cfg = rm2_server_config()
    t0 = time.perf_counter()
    srv = EmbeddingServer(cfg, device="cuda")
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0}
    full_p = srv.params("full")
    table = full_p["embedding"]["table"]
    spec = srv.recsys_config("full").embedding_spec()
    require(tuple(table.shape) == (RM2_ROWS, RM2_DIM),
            f"full table of shape {tuple(table.shape)}")
    res.update(table_bytes=table.numel() * 4,
               robe_slots=srv.recsys_config("robe").robe_size)
    with torch.inference_mode():
        idx = bulk_inputs(None, "cuda", CACHE_CHECK_BATCH, 1)[0]
        emb = get_backend("full").lookup(full_p["embedding"], spec, idx)
        host = emb.cpu().numpy()
        for f in range(F):
            rows = get_backend("full").cacheable_rows(
                full_p["embedding"], spec, f, idx[:, f].cpu().numpy())
            require(np.array_equal(rows, host[:, f]),
                    f"full: cacheable_rows of field {f} differ from the "
                    f"device lookup")
        res["cache_check_rows"] = CACHE_CHECK_BATCH * F
        del emb, host
        batches = padded_batches((512, 512, 437, 512), B_P99)
        robe_cpu = EmbeddingServer(dataclasses.replace(
            cfg, backends=("robe",)), params={
                "robe": to_device(srv.params("robe"), "cpu")}, device="cpu")
        mlp_cpu = {k: to_device(v, "cpu") for k, v in full_p.items()
                   if k != "embedding"}
        counts = {}
        for kind, need in (("full", ("dot_interaction",)),
                           ("robe", ("robe_lookup", "dot_interaction"))):
            scores, c = run_path(srv, batches, kind)
            counts[kind] = c
            print(f"launches {kind} path (dlrm-rm2): {c}")
            require(all(v == (len(batches) if k in need else 0)
                        for k, v in c.items()),
                    f"the {kind} path at dlrm-rm2 width must launch each of "
                    f"{need} once a batch and no other kernel")
            diff = 0.0
            for (batch, n), got in zip(batches, scores):
                require(got.shape == (n,) and np.isfinite(got).all(),
                        f"{kind} (dlrm-rm2): scores of shape {got.shape}")
                if kind == "full":
                    ids = batch["sparse"]
                    rows = np.stack([get_backend("full").cacheable_rows(
                        full_p["embedding"], spec, f, ids[:, f])
                        for f in range(F)], axis=1)
                    want = serve_scores(
                        dict(mlp_cpu, embedding={}),
                        srv.recsys_config("full"),
                        {"dense": torch.from_numpy(batch["dense"]),
                         "emb": torch.from_numpy(rows)}).numpy()[:n]
                else:
                    want = robe_cpu.score("robe", batch, n)
                diff = max(diff, float(np.abs(got - want).max()))
                require(np.allclose(got, want, rtol=SCORE_TOL,
                                    atol=SCORE_TOL),
                        f"{kind} (dlrm-rm2): card scores differ from the CPU "
                        f"by {np.abs(got - want).max()}")
            res[f"{kind}_cpu_max_diff"] = diff
        res["launches"] = counts
        del robe_cpu, mlp_cpu
        times = {}
        for size in (B_P99, B_BULK):
            batch, n = padded_batches((size,), size)[0]
            for turn, kind in enumerate(("robe", "full", "full", "robe")):
                times[f"{kind}_{size}_turn{turn}"] = host_ms(
                    lambda: srv.score(kind, batch, n))
        res["score_ms"] = times
        for size in (B_P99, B_BULK):
            f_ms = statistics.mean(v for k, v in times.items()
                                   if k.startswith(f"full_{size}_"))
            r_ms = statistics.mean(v for k, v in times.items()
                                   if k.startswith(f"robe_{size}_"))
            res[f"full_over_robe_{size}"] = f_ms / r_ms
        batch, n = padded_batches((B_BULK,), B_BULK)[0]
        res["profile_score_262144"] = {
            kind: device_breakdown(lambda: srv.score(kind, batch, n))
            for kind in ("robe", "full")}
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(json.dumps({"full_vs_robe_dlrm_rm2": res}))
    return res, srv


# ---------------------------------------------------------------------------
# phase 5 (f): the serving tier on the card
# ---------------------------------------------------------------------------

def tier_server(base: EmbeddingServer) -> EmbeddingServer:
    """The serving tier's server at ``base``'s widths: ``full`` and ``robe``
    on ``base``'s tensors (no copy of the 52 GB table), ``hashed`` from its
    own init, and a ``HotRowCache`` of CACHE_ROWS rows in front of full and
    hashed."""
    cfg = dataclasses.replace(base.cfg, backends=("full", "hashed", "robe"),
                              cache_capacity=CACHE_ROWS)
    gen = torch.Generator(device=base.device)
    gen.manual_seed(SEED + 2)
    params = {"full": base.params("full"), "robe": base.params("robe"),
              "hashed": init_params(cfg.recsys_cfg("hashed"), gen,
                                    base.device)}
    return EmbeddingServer(cfg, params=params, device=base.device)


def zipf_batches(cfg: ServerConfig, b: int, n: int, start: int) -> list:
    """``n`` distinct [b]-request batches of zipf-1.05 traffic, full
    (n_valid = b)."""
    stream = CtrStream(CtrDataConfig(vocab_sizes=cfg.vocab_sizes,
                                     n_dense=cfg.n_dense, batch_size=b,
                                     zipf_exponent=ZIPF, seed=SEED + 7))
    out = []
    for k in range(n):
        raw = stream.batch_at(start + k)
        out.append({"dense": raw["dense"], "sparse": raw["sparse"]})
    return out


def check_resident(srv: EmbeddingServer, kind: str) -> int:
    """Every row resident in ``kind``'s cache equals, bit for bit, the
    card's lookup of its id through the uncached path's shape (all fields
    of a [n, F] batch at once; the id in its field's column).  Returns the
    number of rows checked."""
    cache = srv.cache(kind)
    spec = srv.recsys_config(kind).embedding_spec()
    keys = np.fromiter(cache._rows.keys(), np.int64, count=len(cache._rows))
    fields = np.searchsorted(spec.offsets, keys, side="right") - 1
    params = srv.params(kind)["embedding"]
    with torch.inference_mode():
        for f in np.unique(fields):
            sel = keys[fields == f]
            idx = np.zeros((sel.size, spec.n_fields), np.int32)
            idx[:, f] = sel - spec.offsets[f]
            got = get_backend(kind).lookup(
                params, spec, torch.from_numpy(idx).to(srv.device))
            want = np.stack([cache._rows[int(g)] for g in sel])
            require(np.array_equal(got[:, f].cpu().numpy(), want),
                    f"{kind}: a resident cache row of field {f} differs "
                    f"from the card's lookup of its id")
    return int(keys.size)


def median_score_ms(srv: EmbeddingServer, kind: str, batches,
                    use_cache: bool = True) -> float:
    """Median host-clock ``score`` of each of ``batches`` but the first
    (a warm-up call), ms."""
    srv.score(kind, batches[0], use_cache=use_cache)
    per = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        srv.score(kind, b, use_cache=use_cache)
        per.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(per)


def score_turns(srv: EmbeddingServer, kinds, reps: int = REPS) -> dict:
    """``score`` at B=512 on distinct zipf batches (host clock, median of
    ``reps``), uncached and cached in turns (off, on, on, off) for the
    cached substrates, and each cached turn's hit rate:
    {kind: {"uncached": [ms], "cached": [ms], "hit_rate": [...]}}."""
    out = {}
    for kind in kinds:
        turns = (False, True, True, False) if srv.cache(kind) is not None \
            else (False, False)
        got = out[kind] = {"uncached": [], "cached": [], "hit_rate": []}
        for turn, use in enumerate(turns):
            batches = zipf_batches(srv.cfg, B_P99, reps + 1,
                                   20_000 + 100 * turn)
            srv.reset_cache_stats()
            got["cached" if use else "uncached"].append(
                median_score_ms(srv, kind, batches, use))
            if use:
                got["hit_rate"].append(srv.cache_stats(kind)["hit_rate"])
    return out


def cache_path(srv: EmbeddingServer) -> dict:
    """The hot-row cache at dlrm-rm2 width: warm from zipf-1.05 traffic
    (hashed's misses launch ``qr_lookup``, full's gather none of ours),
    cached scores equal to uncached ones on four padded batches of 512 for
    full and hashed, every resident row equal to the card's lookup, and
    ``score`` timed cached against uncached."""
    cfg = srv.cfg
    warm = RequestStream(CtrDataConfig(
        vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense, batch_size=256,
        zipf_exponent=ZIPF, seed=SEED + 7)).id_batches(WARM_BATCHES,
                                                         start_step=10_000)
    reset_launches()
    t0 = time.perf_counter()
    srv.warm_caches(warm)
    res = {"warm_s": time.perf_counter() - t0, "warm_launches":
           launch_counts()}
    c = res["warm_launches"]
    require(c["qr_lookup"] > 0 and all(v == 0 for k, v in c.items()
                                       if k != "qr_lookup"),
            f"warming the caches launched {c}: hashed's misses must run "
            f"qr_lookup, and nothing else may run")
    batches = padded_batches((512, 512, 437, 512), B_P99, cfg.vocab_sizes,
                             cfg.n_dense)
    for kind in ("full", "hashed"):
        reset_launches()
        cached = [srv.score(kind, b, n) for b, n in batches]
        c_on = launch_counts()
        reset_launches()
        direct = [srv.score(kind, b, n, use_cache=False) for b, n in batches]
        c_off = launch_counts()
        lookup = {"full": (), "hashed": ("qr_lookup",)}[kind]
        require(c_on["dot_interaction"] == len(batches) and all(
            v == 0 for k, v in c_on.items()
            if k not in ("dot_interaction",) + lookup),
                f"{kind}'s cached path launched {c_on}")
        require(all(v == (len(batches) if k in ("dot_interaction",) + lookup
                          else 0) for k, v in c_off.items()),
                f"{kind}'s uncached path launched {c_off}")
        for (_, n), a, b in zip(batches, cached, direct):
            require(a.shape == (n,) and np.isfinite(a).all(),
                    f"{kind}: cached scores of shape {a.shape}")
            require(np.array_equal(a, b),
                    f"{kind}: cached scores differ from uncached ones by "
                    f"{np.abs(a - b).max()}")
        res[f"{kind}_launches_cached"] = c_on
        res[f"{kind}_launches_uncached"] = c_off
        res[f"{kind}_resident_checked"] = check_resident(srv, kind)
        res[f"{kind}_stats"] = srv.cache_stats(kind)
    print(f"cache (dlrm-rm2): cached == uncached for full and hashed on "
          f"{len(batches)} batches; hashed's cached launches "
          f"{res['hashed_launches_cached']}")
    res["score_ms"] = score_turns(srv, ("full", "hashed", "robe"))
    return res


def replay_rows(srv: EmbeddingServer, svc_ms: dict) -> dict:
    """``run_grid`` cells (full, hashed, robe × deadline, fixed at zipf
    1.05, the JAX grid's trace), the zipf-4.0 control for full and hashed,
    and one ``max_batch`` = 512 row a backend at BIG_LOAD of the capacity
    that ``svc_ms`` (its B=512 ``score``) gives, with no deadline: once a
    batch's service exceeds the deadline, the deadline policy sheds every
    later request as infeasible and observes no service again, so a
    deadline row of a scorer slower than 25 ms measures that lock-out
    (the grid rows show it), not latency at a load; each cell's
    launches."""
    rows = []
    for kind in ("full", "hashed", "robe"):
        for policy in ("deadline", "fixed"):
            reset_launches()
            row = run_grid(srv, policies=(policy,), zipfs=(ZIPF,),
                           backends=(kind,), base=GRID,
                           warm_batches=WARM_BATCHES)[0]
            rows.append(dict(row, launches=launch_counts()))
    for kind in ("full", "hashed"):
        srv.reset_caches()
        reset_launches()
        row = run_cell(srv, kind, GRID, zipf=ZIPF_CONTROL,
                       warm_batches=WARM_BATCHES)
        rows.append(dict(row, launches=launch_counts()))
    for kind in ("full", "hashed", "robe"):
        capacity = BIG_BATCH / (svc_ms[kind] / 1e3)
        cfg = dataclasses.replace(GRID, n_requests=BIG_REQUESTS,
                                  rate_hz=BIG_LOAD * capacity,
                                  deadline_s=None, max_batch=BIG_BATCH,
                                  max_queue=4 * BIG_BATCH)
        srv.reset_caches()
        reset_launches()
        row = run_cell(srv, kind, cfg, zipf=ZIPF, warm_batches=WARM_BATCHES)
        rows.append(dict(row, capacity_qps=capacity, launches=launch_counts()))
    for row in rows:
        c = row["launches"]
        need = {"full": ("dot_interaction",),
                "hashed": ("qr_lookup", "dot_interaction"),
                "robe": ("robe_lookup", "dot_interaction")}[row["backend"]]
        require(row["completed"] > 0 and all(c[k] > 0 for k in need) and
                all(v == 0 for k, v in c.items() if k not in need),
                f"replay cell {row['backend']}/{row['policy']}/z"
                f"{row['zipf']}/{row['max_batch']} launched {c} or completed "
                f"nothing")
        print("replay " + json.dumps({k: v for k, v in row.items()
                                      if k != "launches"}))
    return {"rows": rows}


def router_path(srv: EmbeddingServer) -> dict:
    """One asyncio pass of ROUTER_REQUESTS requests through ``AsyncRouter``
    to hashed (max_batch 32, 2 ms close-out, no deadline): every request
    completes, and each dispatched batch's scores equal ``score`` of the
    same padded batch, uncached."""
    cfg = srv.cfg
    reqs = RequestStream(CtrDataConfig(
        vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense, batch_size=256,
        zipf_exponent=ZIPF, seed=SEED + 11)).requests(ROUTER_REQUESTS)
    kind = "hashed"
    fn = srv.score_fn(kind)
    sizes = []

    def score(batch, n_valid=None):
        sizes.append(n_valid)
        return fn(batch, n_valid=n_valid)

    async def drive():
        router = AsyncRouter(score, DeadlineBatcher(RouterConfig(
            max_batch=32, max_queue=4 * ROUTER_REQUESTS, max_wait_s=0.002)))
        await router.start()
        got = await asyncio.gather(*[router.submit(r) for r in reqs])
        await router.stop()
        return got, router.dispatched_batches

    reset_launches()
    t0 = time.perf_counter()
    got, n_batches = asyncio.run(drive())
    wall = time.perf_counter() - t0
    c = launch_counts()
    require(len(got) == len(reqs) and sum(sizes) == len(reqs) and
            n_batches == len(sizes),
            f"router: {len(got)} of {len(reqs)} requests answered in "
            f"{n_batches} batches")
    got = np.asarray(got, np.float32)
    require(np.isfinite(got).all(), "router: non-finite scores")
    k = 0
    for n in sizes:
        batch, nv = stack_and_pad(reqs[k:k + n], 32)
        want = srv.score(kind, batch, nv, use_cache=False)
        require(np.array_equal(got[k:k + n], want),
                f"router: a batch of {n} scored otherwise than score() of "
                f"the same padded batch")
        k += n
    require(c["qr_lookup"] > 0 and c["dot_interaction"] == n_batches,
            f"router: launches {c}")
    res = {"requests": len(reqs), "batches": n_batches, "wall_s": wall,
           "mean_batch": len(reqs) / n_batches, "launches": c}
    print("router " + json.dumps(res))
    return res


def online_drill(cfg: ServerConfig, kind: str, pub: str,
                 cache: bool = True) -> dict:
    """``OnlineTrainer`` on ``kind`` at ``cfg``'s widths (adagrad at
    ONLINE_LR, B_TRAIN, ONLINE_STEPS steps, a publish every
    PUBLISH_EVERY on a stream drifting every DRIFT_PERIOD steps), a second
    server pushing each publish.  After
    every push: the server's params ``torch.equal`` to the trainer's, every
    surviving cache row equal to the new params' lookup, and (after a warm
    pass on the current phase's traffic) cached scores equal to uncached
    ones on a probe batch of 512."""
    scfg = dataclasses.replace(cfg, backends=(kind,), model_dir=pub,
                               cache_capacity=CACHE_ROWS if cache else 0)
    srv = EmbeddingServer(scfg, device="cuda")
    data = dict(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense,
                drift_period=DRIFT_PERIOD, seed=SEED)
    trainer = OnlineTrainer(
        srv.recsys_config(kind), CtrStream(CtrDataConfig(
            batch_size=B_TRAIN, **data)),
        OnlineConfig(publish_dir=pub, publish_every=PUBLISH_EVERY),
        optimizer=make_optimizer(OptimizerConfig(kind="adagrad",
                                                 lr=ONLINE_LR)),
        device="cuda", seed=SEED + 5)
    probe = CtrStream(CtrDataConfig(batch_size=B_P99, **data))
    log = []

    def on_publish(rec):
        rep = srv.push(kind, step=rec.step)
        for a, b in zip(leaves(srv.params(kind)),
                        leaves(trainer.state["params"])):
            require(a.device == b.device and torch.equal(a, b),
                    f"{kind} drill: the pushed params at step {rec.step} "
                    f"differ from the trainer's")
        entry = {"step": rec.step, "publish": rec.kind,
                 "publish_s": rec.wall_s, "n_changed": rec.n_changed,
                 "n_touched": rec.n_touched, **dataclasses.asdict(rep)}
        # the probe batch drifts with the stream (CtrStream phases by step)
        raw = probe.batch_at(rec.step)
        b = {"dense": raw["dense"], "sparse": raw["sparse"]}
        if cache:
            entry["survivors_checked"] = check_resident(srv, kind)
            srv.cache(kind).warm([probe.batch_at(rec.step + k)["sparse"]
                                  for k in range(1, 9)])
            on = srv.score(kind, b)
            off = srv.score(kind, b, use_cache=False)
            require(np.array_equal(on, off),
                    f"{kind} drill: cached scores differ from uncached ones "
                    f"after the push at step {rec.step}")
            entry["resident_after_warm"] = len(srv.cache(kind)._rows)
        else:
            on = srv.score(kind, b)
        require(on.shape == (B_P99,) and np.isfinite(on).all(),
                f"{kind} drill: scores after the push at step {rec.step}")
        log.append(entry)
        print(f"push {kind} " + json.dumps(entry))

    reset_launches()
    t0 = time.perf_counter()
    rep = trainer.run(ONLINE_STEPS, on_publish=on_publish)
    torch.cuda.synchronize()
    c = launch_counts()
    res = {"kind": kind, "batch": B_TRAIN, "steps": ONLINE_STEPS,
           "run_s": time.perf_counter() - t0, "pushes": log,
           "losses": rep.losses, "launches": c}
    require(rep.steps_done == ONLINE_STEPS and rep.restarts == 0 and
            rep.nan_events == 0 and np.isfinite(rep.losses).all(),
            f"{kind} drill: {rep.steps_done} steps, {rep.restarts} restarts, "
            f"{rep.nan_events} non-finite losses")
    require([p.step for p in rep.publishes] ==
            list(range(0, ONLINE_STEPS + 1, PUBLISH_EVERY)) and
            len(log) == len(rep.publishes),
            f"{kind} drill: publishes {[p.step for p in rep.publishes]}")
    require(all(c[k] >= ONLINE_STEPS for k in TRAIN_KERNELS[kind]),
            f"{kind} drill: a training kernel of {TRAIN_KERNELS[kind]} "
            f"launched fewer than {ONLINE_STEPS} times: {c}")
    if cache:
        srv.reset_caches()
        row = run_push_cell(srv, kind, GRID, publish_dir=pub,
                            push_steps=[p.step for p in rep.publishes],
                            zipf=ZIPF, drift_period=2,
                            warm_batches=WARM_BATCHES)
        require(row["pushes"] == len(rep.publishes) - 1 and
                row["completed"] > 0, f"{kind} push cell: {row}")
        res["push_cell"] = row
        print("push cell " + json.dumps(row))
    return res


def fleet_path(cfg: ServerConfig, pub: str, push_steps) -> dict:
    """``ReplicaFleet`` of FLEET_REPLICAS hashed replicas (cache on):
    ``run_fleet_cell``, then ``run_fleet_push_cell`` staggered and
    synchronized on the same trace with the drill's publishes.  The trace
    is the grid's, FLEET_REPLICAS times as long, offered BIG_LOAD of the
    fleet's capacity (from replica 0's warm cached ``score`` of batches of
    32), with no deadline (``replay_rows`` says why)."""
    kind = "hashed"
    fcfg = dataclasses.replace(cfg, backends=(kind,), model_dir=pub,
                               cache_capacity=CACHE_ROWS)
    fleet = ReplicaFleet(fcfg, n_replicas=FLEET_REPLICAS, device="cuda")
    probe = fleet.replicas[0]
    probe.warm_caches(RequestStream(CtrDataConfig(
        vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense, batch_size=256,
        zipf_exponent=ZIPF, seed=SEED + 7)).id_batches(WARM_BATCHES,
                                                         start_step=10_000))
    svc_ms = median_score_ms(probe, kind, zipf_batches(
        fcfg, GRID.max_batch, REPS + 1, 30_000))
    fleet.reset_caches()
    capacity = FLEET_REPLICAS * GRID.max_batch / (svc_ms / 1e3)
    rcfg = dataclasses.replace(GRID, n_requests=FLEET_REPLICAS *
                               GRID.n_requests,
                               rate_hz=BIG_LOAD * capacity, deadline_s=None)
    rows = []
    reset_launches()
    rows.append(dict(run_fleet_cell(fleet, kind, rcfg, zipf=ZIPF,
                                    warm_batches=WARM_BATCHES),
                     launches=launch_counts()))
    for staggered in (True, False):
        reset_launches()
        row = run_fleet_push_cell(fleet, kind, rcfg, publish_dir=pub,
                                  push_steps=push_steps, staggered=staggered,
                                  zipf=ZIPF, warm_batches=WARM_BATCHES)
        rows.append(dict(row, launches=launch_counts()))
        require(fleet.pushed_steps(kind) == [push_steps[-1]] * FLEET_REPLICAS,
                f"fleet: replicas at {fleet.pushed_steps(kind)}")
    for row in rows:
        row["capacity_qps"] = capacity
        c = row["launches"]
        require(row["completed"] > 0 and row["n_replicas"] == FLEET_REPLICAS
                and c["qr_lookup"] > 0 and
                c["dot_interaction"] > 0,
                f"fleet cell {row.get('push_mode', 'plain')}: {row}")
        print("fleet " + json.dumps({k: v for k, v in row.items()
                                     if k != "launches"}))
    return {"rows": rows}


def rm2_tier(base: EmbeddingServer) -> dict:
    """(f), first half, at ``base``'s dlrm-rm2 widths: the cache
    (``cache_path``), the replay rows (``replay_rows``, the B=512 rows'
    capacity from the cached ``score`` times, uncached for robe) and the
    router (``router_path``).  The tier server is freed on return."""
    srv = tier_server(base)
    res = {"cache": cache_path(srv)}
    times = res["cache"]["score_ms"]
    svc = {k: statistics.mean(v["cached"] or v["uncached"])
           for k, v in times.items()}
    res["replay"] = replay_rows(srv, svc)
    res["router"] = router_path(srv)
    return res


# ---------------------------------------------------------------------------
# phase (g): the rest of the recsys family
# ---------------------------------------------------------------------------

def family_config(name: str) -> RecsysConfig:
    """Phase (g)'s configuration ``name``, on robe at 1000x with Z = 32."""
    if name in TABLE3:
        return RecsysConfig(
            name=f"{name}-robe-z32", vocab_sizes=BENCH_VOCABS, embed_dim=16,
            embedding="robe", robe_size=max(512, sum(BENCH_VOCABS) * 16
                                            // 1000),
            robe_block=32, **TABLE3[name])
    return get_arch(name).make_config("full")


def family_stream(cfg: RecsysConfig, b: int) -> CtrStream:
    return CtrStream(CtrDataConfig(vocab_sizes=cfg.vocab_sizes,
                                   batch_size=b, seed=SEED))


def family_rows(cfg: RecsysConfig, b: int, dev, step: int = 0
                ) -> torch.Tensor:
    """Zipf ids [b, F] of the configuration's vocabularies."""
    return torch.from_numpy(family_stream(cfg, b).batch_at(step)["sparse"]
                            ).to(dev)


def family_lookups(gen, dev) -> list:
    """(what, memory, rows, table ids, dim, spec) of the ``robe_lookup``
    shapes phase (g) runs, each on a fresh array of its configuration's
    size: every array at B = 1, 509, 512 on zipf rows of its vocabularies
    (F = 39 on xDeepFM's and AutoInt's arrays, 337,634 and 540,214 slots,
    which fit in L2; the two-tower's 8 fields at d = 256 and its item
    fields alone, table ids (4, 5, 6, 7); the Table-3 models' 8 fields on
    3,222 slots), then xDeepFM's array (d = 10 < Z = 32, which d does not
    divide) under a zipf batch of the training shape, 65,536 x 39."""
    out, seen = [], set()
    for name in FAMILY:
        cfg = family_config(name)
        spec = cfg.embedding_spec().robe
        if (cfg.vocab_sizes, cfg.embed_dim, spec) in seen:
            continue
        seen.add((cfg.vocab_sizes, cfg.embed_dim, spec))
        mem = init_memory(gen, spec, dev)
        rows = family_rows(cfg, B_P99, dev)
        sets = [(tuple(range(cfg.n_fields)), rows)]
        if cfg.arch == "two_tower":
            sets.append((tuple(range(cfg.n_user_fields, cfg.n_fields)),
                         rows[:, cfg.n_user_fields:].contiguous()))
        for ids, r in sets:
            out += [(f"{name} F={len(ids)} tids {ids[0]}.. B={b}", mem,
                     r[:b], ids, cfg.embed_dim, spec)
                    for b in PHASE2_BATCHES]
        if name == "xdeepfm":
            out.append((f"{name} zipf B={B_TRAIN} F={cfg.n_fields}", mem,
                        family_rows(cfg, B_TRAIN, dev, 1),
                        tuple(range(cfg.n_fields)), cfg.embed_dim, spec))
    return out


def lm_lookups(gen, dev) -> list:
    """(what, memory, rows, table ids, dim, spec) of the LM family's token
    embeddings (phase (i)): each LM_ROBE config's 8x array (d = 1,024,
    2,048, 2,560, 5,120 at Z = 32; 19.4M to 97.3M slots), F = 1 (table
    0), uniform tokens of its vocabulary with the last id among them, at
    B in LM_PHASE2_BATCHES."""
    out = []
    for arch in LM_ROBE:
        cfg = lm_config(arch, "robe")
        spec = cfg.robe_spec()
        mem = init_memory(gen, spec, dev)
        rows = torch.randint(0, cfg.vocab, (max(LM_PHASE2_BATCHES), 1),
                             generator=gen, device=dev, dtype=torch.int32)
        rows[-1] = cfg.vocab - 1
        out += [(f"{arch} F=1 B={b}", mem, rows[-b:].contiguous(), (0,),
                 cfg.d_model, spec) for b in LM_PHASE2_BATCHES]
    return out


def family_serve(cfg: RecsysConfig, params, cpu_params) -> dict:
    """``serve_scores`` on the card: CTR models at B = 512 (a zipf batch
    of ``CtrStream``, its rows past FAMILY_N_VALID zeroed as padding) and
    B = 262,144; the two-tower's ``retrieval_batch`` query against
    CPU_CAND and N_CAND candidates.  Each call launches robe_lookup once
    (retrieval: twice, the query's fields and the candidates' item
    fields) and no other kernel; its scores are finite, and the first
    call's within SCORE_TOL of the CPU's from the same params.  Times:
    host clock, median of FAMILY_REPS, the batch on the card and the
    scores read back to the host."""
    if cfg.arch == "two_tower":
        rb = retrieval_batch(CtrDataConfig(vocab_sizes=cfg.vocab_sizes,
                                           batch_size=B_P99, seed=SEED),
                             0, cfg.n_user_fields, N_CAND)
        cases = [(f"retrieval_{CPU_CAND}", dict(
            rb, cand_sparse=rb["cand_sparse"][:CPU_CAND]), 1, 2),
            (f"retrieval_{N_CAND}", rb, 1, 2)]
    else:
        small = family_stream(cfg, B_P99).batch_at(0)["sparse"]
        small[FAMILY_N_VALID:] = 0
        bulk = family_stream(cfg, B_BULK).batch_at(0)["sparse"]
        cases = [(f"score_{B_P99}", {"sparse": small}, FAMILY_N_VALID, 1),
                 (f"score_{B_BULK}", {"sparse": bulk}, B_BULK, 1)]
    res = {}
    for k, (label, host, n, launches) in enumerate(cases):
        batch = {key: torch.from_numpy(v).to("cuda")
                 for key, v in host.items()}
        reset_launches()
        got = serve_scores(params, cfg, batch)[:n].cpu()
        c = launch_counts()
        require(c["robe_lookup"] == launches and sum(c.values()) == launches,
                f"{cfg.name} {label} launched {c}; expected robe_lookup "
                f"{launches} times and no other kernel")
        shape = (1, len(host["cand_sparse"])) if "cand_sparse" in host \
            else (n,)
        require(tuple(got.shape) == shape and bool(torch.isfinite(got).all()),
                f"{cfg.name} {label}: scores of shape {tuple(got.shape)}, "
                f"expected {shape}, or not finite")
        row = {"launches": {kk: v for kk, v in c.items() if v}}
        if label == f"retrieval_{N_CAND}":
            G_SCORES[cfg.name] = got          # phase (h) holds its own to it
        if k == 0:
            want = serve_scores(cpu_params, cfg, {
                key: torch.from_numpy(v) for key, v in host.items()})[:n]
            row["cpu_max_diff"] = float((got - want).abs().max())
            require(torch.allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL),
                    f"{cfg.name} {label}: card scores differ from the CPU "
                    f"run by {row['cpu_max_diff']}")
        row["ms"] = host_ms(lambda: serve_scores(params, cfg, batch)[:n].cpu(),
                            reps=FAMILY_REPS)
        res[label] = row
        del batch, got
    return res


class ReluMasks(torch.overrides.TorchFunctionMode):
    """Within it, every ReLU call records its decisions (x > 0) in call
    order; given another run's decisions, it applies those instead: x *
    mask, whose gradient is the mask, counting the decisions that differ
    from its own (``flips``).  A CPU step in the card step's decisions is
    the same function up to the inputs within rounding of 0, and its
    backward takes the card's branch there: a ReLU input that falls on
    the other side of 0 on the other device moves one sample's whole
    backward (up to 1.7e-3 of a bias leaf's gradient at B = 4,096 on an
    NVIDIA H100 80GB HBM3 at 700 W), which a reading of the step would
    otherwise charge to the card."""

    RELU = (torch.relu, torch.nn.functional.relu, torch.Tensor.relu)

    def __init__(self, masks=None):
        super().__init__()
        self.replay = masks is not None
        self.masks = [] if masks is None else masks
        self.at, self.flips = 0, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self.RELU:
            return func(*args, **kwargs)
        x = args[0]
        if not self.replay:
            self.masks.append((x > 0).cpu())
            return func(*args, **kwargs)
        m = self.masks[self.at].to(x.device)
        self.at += 1
        self.flips += int(((x > 0) != m).sum())
        return x * m.to(x.dtype)


def loss_grads(cfg: RecsysConfig, params, batch):
    """``loss_fn``'s gradient of every param leaf (the robe models' leaves
    are all float), in the params' tree."""
    xs = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, xs), cfg, batch)[0]
        return unflatten(params, list(torch.autograd.grad(loss, xs)))


def family_adam(cfg: RecsysConfig, params) -> dict:
    """FAMILY_ADAM_STEPS adam steps (lr FAMILY_LR) at B = FAMILY_ADAM_B
    through ``run``, each card step shadowed by the CPU step from the same
    state in the card step's ReLU decisions (``ReluMasks``; the decisions
    that differ are counted, at most RELU_FLIP_LIMIT["family"] a step):
    its loss within QS_LOSS_TOL, each param
    leaf's update read by ``UpdateErr`` as phase 3 reads its three
    full-width steps (at most UPDATE_FLAG_SHARE of the steps, rounded up,
    with a leaf above UPDATE_TOL), and each leaf's gradient, card against
    CPU, taken from adam's first moment (``grad_reading``) and read as
    phase 3 reads its quickstart (each leaf's median within
    UPDATE_MEDIAN_TOL too).  The median is not asked of adam's update:
    its first steps move each element by about lr * g / (|g| + eps), so
    an element whose gradient is near eps (1e-8) turns last-bit
    differences of g into fractions of lr (90% of the two-tower's update
    reading at its first step, 2.1e-4 of the norm, came from elements with
    |g| < 1e-8, where its gradient read 1.5e-6; NVIDIA H100 80GB HBM3,
    700 W)."""
    opt = OptimizerConfig(kind="adam", lr=FAMILY_LR)
    cpu_step = build_train_step(lambda p, b: loss_fn(p, cfg, b),
                                make_optimizer(opt), TrainConfig())
    start = to_device(params, "cpu")
    grad, upd = UpdateErr(start), UpdateErr(start)
    diffs, flips = [], []

    def shadow(step_fn):
        def step(state, batch):
            old = to_device(state, "cpu")
            host = to_device(batch, "cpu")
            with ReluMasks() as rec:
                state, m = step_fn(state, batch)
                loss = float(m["loss"])
            with ReluMasks(rec.masks) as rep_step:
                want, wm = cpu_step(old, host)
            diffs.append(abs(loss - float(wm["loss"])))
            flips.append(rep_step.flips)
            require(rep_step.at == len(rec.masks) > 0,
                    f"{cfg.name}: the CPU step made {rep_step.at} ReLU "
                    f"calls, the card's {len(rec.masks)}")
            grad_reading(grad, old["opt"]["m"], state["opt"]["m"],
                         want["opt"]["m"])
            upd.add(old["params"], state["params"], want["params"])
            return state, m
        return step
    rep = train_run(cfg, params, opt,
                    family_stream(cfg, FAMILY_ADAM_B).batch_at,
                    FAMILY_ADAM_STEPS, shadow)
    what = f"{cfg.name} adam B={FAMILY_ADAM_B}"
    require(max(flips) <= RELU_FLIP_LIMIT["family"],
            f"{what}: the CPU steps took {flips} ReLU decisions from the "
            f"card's (at most {RELU_FLIP_LIMIT['family']} a step)")
    require(max(diffs) <= QS_LOSS_TOL,
            f"{what}: a card step's loss differs from the CPU step's from "
            f"the same state by {max(diffs)}")
    g_read = grad.check(f"{what} gradient")
    # three steps: their medians would be one step's reading
    u_read = upd.check(f"{what} update", median=False)
    keep = ("max_median", "flagged_steps", "flagged")
    return {"losses": rep.losses, "max_step_loss_diff": max(diffs),
            "relu_flips": flips, "grad": {k: g_read[k] for k in keep},
            "update": {k: u_read[k] for k in keep}}


def family_full_batch(cfg: RecsysConfig, params) -> tuple:
    """FAMILY_STEPS adagrad steps at the training batch (the two-tower's
    TWO_TOWER_B): finite losses, and each step launches robe_lookup and
    robe_lookup_bwd once and no other kernel.  Returns (the run's
    numbers, its first batch on the card)."""
    b = TWO_TOWER_B if cfg.arch == "two_tower" else B_TRAIN
    stream = family_stream(cfg, b)
    batches = [stream.batch_at(k) for k in range(FAMILY_STEPS)]
    per_step = []

    def count(step_fn):
        def step(state, batch):
            reset_launches()
            out = step_fn(state, batch)
            torch.cuda.synchronize()
            per_step.append(launch_counts())
            return out
        return step
    rep = train_run(cfg, params, OptimizerConfig(kind="adagrad",
                                                 lr=FAMILY_LR),
                    lambda k: batches[k], FAMILY_STEPS, count)
    require(len(rep.losses) == FAMILY_STEPS and np.isfinite(rep.losses).all(),
            f"{cfg.name} adagrad B={b}: losses {rep.losses}")
    for k, c in enumerate(per_step):
        require(all(n == (1 if name in ("robe_lookup", "robe_lookup_bwd")
                          else 0) for name, n in c.items()),
                f"{cfg.name} adagrad B={b} step {k} launched {c}; expected "
                f"one robe_lookup, one robe_lookup_bwd and no other kernel")
    first = {k: torch.from_numpy(v).to("cuda") for k, v in batches[0].items()}
    return {"batch": b, "losses": rep.losses,
            "launches_per_step": {k: v for k, v in per_step[0].items()
                                  if v}}, first


def robe_fwd_times(mem, spec, d: int, ids, rows, rates,
                   plain=None) -> dict:
    """``robe_lookup`` of width ``d`` on ``rows`` (batches [B, F] of table
    ids ``ids``) beside its bound (the rows and the touched slots read,
    the output written) and, on ``plain`` (batches), its plain version."""
    b, nf = rows[0].shape
    uniq = int(touched_slots(spec, rows[0], table_ids=ids, dim=d).sum())
    out = {"touched_slots": uniq, "library_ms": None}
    out["bound_ms"], out["bound_by"] = bound(
        b * nf * 4 + uniq * 4 + b * nf * d * 4, 0, rates)
    out["ms"] = device_ms(lambda r: robe_lookup_cuda(mem, r, ids, d, spec),
                          [(r,) for r in rows])
    if plain is not None:
        out["plain_ms"] = device_ms(
            lambda r: robe_lookup_ref(mem, r, ids, d, spec),
            [(r,) for r in plain])
    return out


def robe_bwd_times(spec, d: int, ids, pairs, rates, plain=None) -> dict:
    """``robe_lookup_bwd`` on ``pairs`` ((rows, g) of table ids ``ids``)
    beside its bound (g and the rows read, the |M| f32 gradient written)
    and, on ``plain`` (pairs), its plain version."""
    rows = pairs[0][0]
    b, nf = rows.shape
    out = {"touched_slots": int(touched_slots(spec, rows, table_ids=ids,
                                              dim=d).sum()),
           "library_ms": None}
    out["bound_ms"], out["bound_by"] = bound(
        b * nf * d * 4 + b * nf * 4 + spec.size * 4, 0, rates)
    out["ms"] = device_ms(
        lambda r, g: robe_lookup_bwd_cuda(g, r, ids, d, spec), pairs)
    if plain is not None:
        out["plain_ms"] = device_ms(
            lambda r, g: robe_lookup_bwd_ref(g, r, ids, d, spec), plain)
    return out


def family_kernel_times(cfg: RecsysConfig, params, train_rows, rates,
                        dev) -> dict:
    """``robe_lookup`` at the configuration's serve shapes (B = 512 and
    262,144; the two-tower's query at 512 and its N_CAND candidates' item
    fields) and ``robe_lookup_bwd`` at its training batch, each beside its
    bound (``robe_fwd_times``, ``robe_bwd_times``), the backward's passes
    (``device_breakdown``) and both plain versions at B = 512."""
    spec = cfg.embedding_spec().robe
    mem = params["embedding"]["memory"]
    d, f = cfg.embed_dim, cfg.n_fields
    every = tuple(range(f))
    stream = family_stream(cfg, B_P99)
    small = [torch.from_numpy(stream.batch_at(k)["sparse"]).to(dev)
             for k in range(8)]
    if cfg.arch == "two_tower":
        items = tuple(range(cfg.n_user_fields, f))
        cand = torch.from_numpy(retrieval_batch(
            CtrDataConfig(vocab_sizes=cfg.vocab_sizes, batch_size=B_P99,
                          seed=SEED), 0, cfg.n_user_fields,
            N_CAND)["cand_sparse"]).to(dev)
        fwd = {"": (every, small), f"_cand_{N_CAND}": (items, [cand])}
    else:
        fwd = {"": (every, small),
               "_bulk": (every, [family_rows(cfg, B_BULK, dev)])}
    out = {"robe_lookup": {}, "robe_lookup_bwd": {}}
    rl, rb = out["robe_lookup"], out["robe_lookup_bwd"]
    for tag, (ids, rows) in fwd.items():
        t = robe_fwd_times(mem, spec, d, ids, rows, rates,
                           small if tag == "" else None)
        rl.update({(k if k == "plain_ms" else k + tag): v
                   for k, v in t.items()})
    b = train_rows.shape[0]
    gs = [torch.randn((b, f, d), device=dev) for _ in range(2)]
    g_small = [torch.randn((B_P99, f, d), device=dev) for _ in small]
    t = robe_bwd_times(spec, d, every, [(train_rows, g) for g in gs], rates,
                       list(zip(small, g_small)))
    rb.update({(k if k == "plain_ms" else k + "_train"): v
               for k, v in t.items()})
    rb["batch_train"] = b
    rb["passes_ms_train"] = device_breakdown(
        lambda: robe_lookup_bwd_cuda(gs[0], train_rows, every, d,
                                     spec))["top_ms"]
    out["config"] = {"fields": f, "dim": d, "z": spec.block_size,
                     "slots": spec.size}
    del gs, g_small, small
    return out


def recsys_family(rates, dev) -> dict:
    """Phase (g): each configuration of FAMILY from its own seeded init on
    the card: ``family_serve``, ``family_adam``, ``family_full_batch``, the
    full-batch step's time with its device breakdown
    (``time_train_step``), ``family_kernel_times`` (once a lookup shape:
    the Table-3 models share theirs), and the configuration's peak device
    memory."""
    out, timed = {}, {}
    for name in FAMILY:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = family_config(name)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        params = init_params(cfg, gen, dev)
        res = {"arch": cfg.arch, "fields": cfg.n_fields,
               "dim": cfg.embed_dim, "robe_size": cfg.robe_size,
               "robe_block": cfg.robe_block}
        with torch.inference_mode():
            res["serve"] = family_serve(cfg, params, to_device(params, "cpu"))
        res["train_adam"] = family_adam(cfg, params)
        res["train_full_batch"], batch = family_full_batch(cfg, params)
        res["step"] = time_train_step(cfg, params, batch, FAMILY_REPS)
        top = res["step"]["profile"]["top_ms"]
        res["step"]["profile"]["top_ms"] = dict(list(top.items())[:8])
        key = (cfg.vocab_sizes, cfg.embed_dim, cfg.robe_size)
        if key in timed:
            res["kernels"] = f"as {timed[key]}"
        else:
            timed[key] = name
            with torch.inference_mode():
                res["kernels"] = family_kernel_times(cfg, params,
                                                     batch["sparse"], rates,
                                                     dev)
        del params, batch
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        res["wall_s"] = time.perf_counter() - t0
        print(f"recsys family {name}: ok ({res['wall_s']:.1f} s), peak "
              f"memory {res['max_memory_allocated']} B")
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# phase (i): the LM family and GatedGCN
# ---------------------------------------------------------------------------

def lm_config(arch: str, embedding: str = "full", train: bool = False,
              **over):
    """``arch``'s full config as ``launch/cells._lm_cfg`` sets it: remat on
    for training and off for serving (bf16 compute, f32 params)."""
    over.setdefault("remat", train)
    return get_arch(arch).make_config("full", embedding=embedding, **over)


def lm_tokens(cfg, b: int, t: int, step: int = 0) -> dict:
    """A batch of ``LmStream`` at the config's vocabulary, on the card."""
    raw = LmStream(LmDataConfig(vocab=cfg.vocab, seq_len=t, batch_size=b,
                                seed=SEED)).batch_at(step)
    return {k: torch.from_numpy(v).to("cuda") for k, v in raw.items()}


def lm_expect(counts: dict, want: dict, what: str) -> None:
    """Every kernel launched exactly ``want.get(name, 0)`` times."""
    require(all(n == want.get(k, 0) for k, n in counts.items()),
            f"{what} launched {counts}; expected {want} and no other kernel")


def mean_launches(counts: list) -> dict:
    """Each kernel's launches a step, the mean of the steps' counts (the
    kernels launched at all)."""
    names = sorted({k for c in counts for k, v in c.items() if v})
    return {k: sum(c.get(k, 0) for c in counts) / len(counts)
            for k in names}


def lm_step_kernels(cfg, train: bool = False) -> dict:
    """The kernels one forward (and, training, its backward) launches:
    the ROBE token embedding's, none on ``full``."""
    if cfg.embedding != "robe":
        return {}
    return {"robe_lookup": 1, **({"robe_lookup_bwd": 1} if train else {})}


def lm_prefill(cfg, params, b: int, t: int):
    """One prefill of [b, t] tokens (``logits_mode="last"``,
    ``collect_cache``): (its time, the device time of its attention
    (``Spans`` of ``chunked_attention``), tokens/s, peak memory and
    launches; the cache)."""
    toks = lm_tokens(cfg, b, t)["tokens"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.inference_mode(), Spans(attn_mod, "chunked_attention") as sp:
        (logits, _, cache), ms = synced_ms(lambda: lm.forward(
            params, cfg, toks, collect_cache=True, logits_mode="last"))
    c = launch_counts()
    lm_expect(c, lm_step_kernels(cfg), f"{cfg.name} prefill")
    require(logits.shape == (b, cfg.vocab_padded) and
            bool(torch.isfinite(logits).all()),
            f"{cfg.name} prefill: logits {tuple(logits.shape)} not finite")
    n_kv = sum(v.numel() * v.element_size()
               for v in cache["layers"].values())
    return {"batch": b, "seq": t, "ms": ms, "attention_ms": sp.ms(),
            "tokens_per_s": b * t / ms * 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "cache_bytes": n_kv, "launches": {k: v for k, v in c.items()
                                              if v}}, cache


def lm_decode(cfg, params, caches, b: int, pos0: int) -> dict:
    """LM_DECODE_STEPS decode steps of [b, 1] tokens at positions pos0.. on
    ``caches``: per step host-clock ms (median), tokens/s, peak memory,
    the launches read a step (``mean_launches``); the last step's
    logits."""
    steps = LM_DECODE_STEPS
    toks = lm_tokens(cfg, b, steps, 7)["tokens"]
    per, counts, logits = [], [], None
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for k in range(steps):
            reset_launches()
            (logits, caches), ms = synced_ms(lambda: lm.decode_step(
                params, cfg, caches, toks[:, k:k + 1], pos0 + k))
            counts.append(launch_counts())
            lm_expect(counts[-1], lm_step_kernels(cfg),
                      f"{cfg.name} decode step {k}")
            require(logits.shape == (b, cfg.vocab_padded) and
                    bool(torch.isfinite(logits).all()),
                    f"{cfg.name} decode step {k}: logits not finite")
            per.append(ms)
    med = statistics.median(per)
    return {"batch": b, "slots": caches["layers"][next(iter(
        caches["layers"]))].shape[2], "positions": [pos0, pos0 + steps - 1],
        "ms": med, "ms_each": per, "tokens_per_s": b / med * 1e3,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches_per_step": mean_launches(counts)}, logits


def random_caches(cfg, b: int, slots: int, gen) -> dict:
    """``lm.init_cache`` filled with N(0, 1) keys and values (bf16), as a
    cache whose every slot holds a token."""
    caches = lm.init_cache(cfg, b, slots, "cuda")
    for v in caches["layers"].values():
        v.normal_(generator=gen)
    return caches


def lm_train(cfg, params, b: int, t: int, profile: bool = False) -> dict:
    """LM_TRAIN_STEPS adam steps (lr LM_LR) of ``build_train_step`` on
    ``LmStream`` batches: per step host-clock ms (median), tokens/s, the
    losses (finite), peak memory and the launches read a step
    (``mean_launches``).  With ``profile`` the last step is also
    ``device_breakdown``'s, with the device time of its
    calls of ``chunked_attention`` and ``cross_entropy`` (``Spans``)."""
    optimizer = make_optimizer(OptimizerConfig(kind="adam", lr=LM_LR))
    tc = TrainConfig(max_restarts=0)
    step_fn = build_train_step(lambda p, bb: lm.loss_fn(p, cfg, bb),
                               optimizer, tc)
    state = init_state(params, optimizer, tc)
    torch.cuda.reset_peak_memory_stats()
    per, losses, counts = [], [], []
    steps = LM_TRAIN_STEPS
    prof = None
    for k in range(steps):
        batch = lm_tokens(cfg, b, t, k)
        reset_launches()
        if profile and k == steps - 1:
            box = {}

            def one():
                box["out"] = step_fn(state, batch)
                float(box["out"][1]["loss"])
            with Spans(attn_mod, "chunked_attention") as att, \
                    Spans(lm, "cross_entropy") as ce:
                prof = device_breakdown(one, calls=1, warm=False)
            prof["forward_ranges_ms"] = {"attention": att.ms(),
                                         "loss": ce.ms()}
            (state, m), ms = box.pop("out"), prof["wall_ms"]
        else:
            (state, m), ms = synced_ms(lambda: step_fn(state, batch))
        counts.append(launch_counts())
        lm_expect(counts[-1], lm_step_kernels(cfg, train=True),
                  f"{cfg.name} train step {k}")
        losses.append(float(m["loss"]))
        per.append(ms)
    require(np.isfinite(losses).all(), f"{cfg.name} train: {losses}")
    med = statistics.median(per)
    out = {"batch": b, "seq": t, "steps": steps, "lr": LM_LR, "ms": med,
           "ms_each": per, "tokens_per_s": b * t / med * 1e3,
           "losses": losses,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches_per_step": mean_launches(counts)}
    if prof is not None:
        out["profile"] = prof
    del state
    return out


def lm_cpu_check(cfg, params, adam: bool = False) -> dict:
    """At B = LM_CHECK_B, T = LM_CHECK_T in f32 (caches f32 too): the
    card's logits and loss against a CPU copy of the same params (rtol =
    atol = LM_CPU_TOL), then a prefill of all but 4 tokens and 4 decode
    steps on both (each step's logits likewise); with ``adam``, one adam
    step (lr LM_LR) from the same state on both, read by
    ``adam_readings`` (on the card, in f64): each leaf's gradient held as
    phase 3 holds updates, and each leaf's update within UPDATE_TOL (phase
    3's bound on a flagged step; of one step, none may be flagged)."""
    c32 = dataclasses.replace(cfg, compute_dtype=torch.float32,
                              cache_dtype=torch.float32, remat=False)
    batch = lm_tokens(cfg, LM_CHECK_B, LM_CHECK_T, 3)
    host = to_device(batch, "cpu")
    cpu = to_device(params, "cpu")
    out = {}
    with torch.inference_mode():
        lg, _ = lm.forward(params, c32, batch["tokens"])
        want, _ = lm.forward(cpu, c32, host["tokens"])
        loss = float(lm.loss_fn(params, c32, batch)[0])
        wloss = float(lm.loss_fn(cpu, c32, host)[0])
        err = max_err(lg.cpu(), want)
        require(torch.allclose(lg.cpu(), want, rtol=LM_CPU_TOL,
                               atol=LM_CPU_TOL) and
                abs(loss - wloss) <= LM_CPU_TOL * max(1.0, abs(wloss)),
                f"{cfg.name} f32: card logits within {err} of the CPU's, "
                f"loss {loss} against {wloss}")
        out.update(logits_max_diff=err, loss=loss, loss_diff=abs(loss - wloss))
        n = LM_CHECK_T - 4
        caches = {}
        for dev, p, toks in (("cuda", params, batch["tokens"]),
                             ("cpu", cpu, host["tokens"])):
            _, _, pre = lm.forward(p, c32, toks[:, :n], collect_cache=True,
                                   logits_mode="last")
            cache = lm.init_cache(c32, LM_CHECK_B, LM_CHECK_T, dev)
            for k, v in cache["layers"].items():
                v[:, :, :n] = pre["layers"][k]
            steps = []
            for t in range(n, LM_CHECK_T):
                lgt, cache = lm.decode_step(p, c32, cache, toks[:, t:t + 1],
                                            t)
                steps.append(lgt.cpu())
            caches[dev] = steps
        derr = max(max_err(a, b) for a, b in zip(caches["cuda"],
                                                 caches["cpu"]))
        require(all(torch.allclose(a, b, rtol=LM_CPU_TOL, atol=LM_CPU_TOL)
                    for a, b in zip(caches["cuda"], caches["cpu"])),
                f"{cfg.name} f32 decode: card logits within {derr} of the "
                f"CPU's")
        out["decode_logits_max_diff"] = derr
    if adam:
        opt = make_optimizer(OptimizerConfig(kind="adam", lr=LM_LR))
        step = build_train_step(lambda p, b: lm.loss_fn(p, c32, b), opt,
                                TrainConfig())
        start = init_state(cpu, opt, TrainConfig())
        card, cm = step(init_state(params, opt, TrainConfig()), batch)
        want, wm = step(start, host)
        m_err, p_err = adam_readings(
            start, {"params": card["params"], "m": card["opt"]["m"]},
            {"params": want["params"], "m": want["opt"]["m"]}, "cuda")
        read = m_err.check(f"{cfg.name} f32 adam step's gradient")
        upd = p_err.check(f"{cfg.name} f32 adam step's update", median=False)
        require(not upd["flagged_steps"],
                f"{cfg.name} f32 adam step's update: a leaf reads above "
                f"{UPDATE_TOL}: {upd['median']}")
        out["adam"] = {"loss_diff": abs(float(cm["loss"]) -
                                        float(wm["loss"])),
                       "grad_max_reading": read["max_median"],
                       "grad_reading": read["median"],
                       "update_max_reading": upd["max_median"],
                       "update_reading": upd["median"]}
        del card, want, start
    del cpu
    return out


def lm_decode_check(cfg, params) -> dict:
    """In bf16 (bf16 cache): after a LM_DECODE_CHECK_T-token prefill, each
    of LM_DECODE_STEPS decode steps' logits against the forward's logits at
    that position on the same tokens, within LM_DECODE_TOL of the
    forward's largest |logit|."""
    n, s = LM_DECODE_CHECK_T, LM_DECODE_CHECK_T + LM_DECODE_STEPS
    toks = lm_tokens(cfg, LM_CHECK_B, s, 5)["tokens"]
    errs = []
    with torch.inference_mode():
        full, _ = lm.forward(params, cfg, toks)
        _, _, pre = lm.forward(params, cfg, toks[:, :n], collect_cache=True,
                               logits_mode="last")
        cache = lm.init_cache(cfg, LM_CHECK_B, s, "cuda")
        for k, v in cache["layers"].items():
            v[:, :, :n] = pre["layers"][k]
        for t in range(n, s):
            lg, cache = lm.decode_step(params, cfg, cache, toks[:, t:t + 1],
                                       t)
            ref = full[:, t].float()
            errs.append(float((lg.float() - ref).abs().max()
                              / ref.abs().max()))
    require(max(errs) <= LM_DECODE_TOL,
            f"{cfg.name} bf16 decode against the forward: {errs}")
    return {"prefill": n, "steps": LM_DECODE_STEPS, "rel_err": errs,
            "max_rel_err": max(errs)}


class Spans:
    """Within it, every call of ``mod.name`` is timed on the card (a CUDA
    event before and after it); ``ms()`` after a synchronise is their
    sum."""

    def __init__(self, mod, name: str):
        self.mod, self.name, self.events = mod, name, []

    def __enter__(self):
        self.orig = fn = getattr(self.mod, self.name)
        events = self.events

        def wrapped(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            events.append((start, end))
            return out
        setattr(self.mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)

    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)



def lm_kernel_times(cfg, params, rates, dev) -> dict:
    """``robe_lookup`` at the LM's token counts (B·T = 8: a decode step;
    16,384: a training step; 32,768: the prefill) and ``robe_lookup_bwd``
    at the training step's, F = 1 on the config's array and
    ``LmStream``'s tokens: each held against its plain version on the
    same rows (the forward equal, the backward within SCATTER_TOL's
    bound), then timed beside its bound and its plain version
    (``robe_fwd_times``, ``robe_bwd_times``)."""
    spec, mem, d = cfg.robe_spec(), params["embed"]["memory"], cfg.d_model
    out = {"robe_lookup": {}, "robe_lookup_bwd": {}}
    for tag, (b, t) in {"decode": (LM_DECODE_B, 1),
                        "train": (LM_TRAIN_B, LM_TRAIN_T),
                        "prefill": (1, LM_PREFILL_T)}.items():
        rows = [lm_tokens(cfg, b, t, k)["tokens"].reshape(-1, 1).int()
                .contiguous() for k in range(2)]
        what = f"at the LM's {tag} ({b * t} tokens, d = {d})"
        got = robe_lookup_cuda(mem, rows[0], (0,), d, spec)
        want = robe_lookup_ref(mem, rows[0], (0,), d, spec)
        require(torch.equal(got, want), f"robe_lookup {what}: max err "
                f"{max_err(got, want)}")
        out["robe_lookup"][tag] = {
            "items": b * t, "max_abs_err": max_err(got, want),
            **robe_fwd_times(mem, spec, d, (0,), rows, rates, rows)}
        if tag == "train":
            gs = [torch.randn((b * t, 1, d), device=dev) for _ in range(2)]
            got = robe_lookup_bwd_cuda(gs[0], rows[0], (0,), d, spec)
            want = robe_lookup_bwd_ref(gs[0], rows[0], (0,), d, spec)
            a = robe_lookup_bwd_ref(gs[0].abs(), rows[0], (0,), d,
                                    dataclasses.replace(spec, use_sign=False))
            try:
                over_a = scatter_err(got, want, a, torch.float32)
            except SmokeFailure as e:
                raise SmokeFailure(f"robe_lookup_bwd {what}: {e}") from None
            pairs = list(zip(rows, gs))
            out["robe_lookup_bwd"][tag] = {
                "items": b * t, "max_abs_err": max_err(got, want),
                "max_err_over_a": over_a,
                **robe_bwd_times(spec, d, (0,), pairs, rates, pairs)}
            del gs, a
        del got, want
    out["config"] = {"fields": 1, "dim": d, "z": spec.block_size,
                     "slots": spec.size}
    return out


class Parts:
    """Host-clock seconds of each named part of a phase: ``with
    parts("name"):``."""

    def __init__(self):
        self.s = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0


def lm_full_depth(rates, dev) -> dict:
    """(i) 1: LM_ARCH at full width and depth, ``full`` and ``robe`` (8x)
    on the same layers.  First the checks: the f32 card-against-CPU check
    (robe's with one adam step: full's CPU adam step over its 751.6M
    params takes ~25 s on the card's host) and the bf16
    decode-against-forward check of each;
    then on each: the prefill (1 x
    LM_PREFILL_T, last logits, the cache collected), LM_DECODE_STEPS
    decode steps at B = LM_DECODE_B on a LM_CACHE-slot bf16 cache,
    LM_TRAIN_STEPS adam steps at B = LM_TRAIN_B, T = LM_TRAIN_T (remat on;
    robe's last step also ``device_breakdown``'s); last, the ROBE kernels
    at the LM's shapes (``lm_kernel_times``)."""
    parts = Parts()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    full_cfg = lm_config(LM_ARCH)
    robe_cfg = lm_config(LM_ARCH, "robe")
    params = {"full": lm.init_params(full_cfg, gen, dev)}
    params["robe"] = dict(params["full"], embed={
        "memory": init_memory(gen, robe_cfg.robe_spec(), dev)})
    out = {"arch": LM_ARCH, "params": full_cfg.param_count(),
           "robe_slots": robe_cfg.robe_size,
           "table_bytes": full_cfg.vocab_padded * full_cfg.d_model * 4,
           "robe_bytes": robe_cfg.robe_size * 4}
    kinds = (("full", full_cfg), ("robe", robe_cfg))
    for kind, cfg in kinds:
        res = out[kind] = {}
        with parts(f"{kind}_check_f32"):
            res["check_f32"] = lm_cpu_check(cfg, params[kind],
                                            adam=kind == "robe")
        with parts(f"{kind}_check_decode"):
            res["check_decode_bf16"] = lm_decode_check(cfg, params[kind])
    torch.cuda.empty_cache()
    for kind, cfg in kinds:
        p, res = params[kind], out[kind]
        with parts(f"{kind}_prefill"):
            res["prefill"], cache = lm_prefill(cfg, p, 1, LM_PREFILL_T)
            del cache
            torch.cuda.empty_cache()
        with parts(f"{kind}_decode"):
            caches = random_caches(cfg, LM_DECODE_B, LM_CACHE, gen)
            res["decode"], _ = lm_decode(cfg, p, caches, LM_DECODE_B,
                                         LM_CACHE - LM_DECODE_STEPS)
            res["decode"]["cache_bytes"] = sum(
                v.numel() * v.element_size()
                for v in caches["layers"].values())
            del caches
            torch.cuda.empty_cache()
        with parts(f"{kind}_train"):
            tcfg = lm_config(LM_ARCH, kind, train=True)
            res["train"] = lm_train(tcfg, p, LM_TRAIN_B, LM_TRAIN_T,
                                    profile=kind == "robe")
            torch.cuda.empty_cache()
        print(f"(i) {LM_ARCH} {kind}: prefill {res['prefill']['ms']:.1f} ms, "
              f"decode {res['decode']['ms']:.2f} ms a step, train "
              f"{res['train']['ms']:.1f} ms a step", flush=True)
    with parts("kernels"), torch.inference_mode():
        out["kernels"] = lm_kernel_times(robe_cfg, params["robe"], rates,
                                         dev)
    del params
    torch.cuda.empty_cache()
    out["parts_s"] = parts.s
    print(f"(i) {LM_ARCH} parts (s): "
          + json.dumps({k: round(v, 1) for k, v in parts.s.items()}))
    return out


def lm_reduced_depth(arch: str, dev) -> dict:
    """(i) 2: ``arch`` at full width, LM_REDUCED[arch] layers, ``full``:
    the f32 card-against-CPU check (logits, loss, a decode chain), then a
    bf16 prefill of 1 x LM_REDUCED_T and LM_DECODE_STEPS decode steps on
    its cache; for qwen1.5-32b also the int8 cache's decode at B =
    LM_DECODE_B on LM_CACHE slots against the same decode on a bf16 cache
    holding the same keys and values (relative logit error within
    LM_INT8_TOL), both timed.  No kernel launches (``full``)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cfg = lm_config(arch, n_layers=LM_REDUCED[arch])
    params = lm.init_params(cfg, gen, dev)
    out = {"arch": arch, "layers": cfg.n_layers,
           "layers_full": get_arch(arch).make_config("full").n_layers,
           "params": cfg.param_count()}
    parts = Parts()
    with parts("check_f32"):
        out["check_f32"] = lm_cpu_check(cfg, params)
    with parts("prefill"):
        out["prefill"], pre = lm_prefill(cfg, params, 1, LM_REDUCED_T)
    caches = lm.init_cache(cfg, 1, LM_REDUCED_T + LM_DECODE_STEPS, "cuda")
    for k, v in caches["layers"].items():
        v[:, :, :LM_REDUCED_T] = pre["layers"][k]
    del pre
    out["decode"], _ = lm_decode(cfg, params, caches, 1, LM_REDUCED_T)
    del caches
    torch.cuda.empty_cache()
    if arch == "qwen1.5-32b":
        t0 = time.perf_counter()
        bf = random_caches(cfg, LM_DECODE_B, LM_CACHE, gen)
        q8 = lm.init_cache(dataclasses.replace(cfg, cache_dtype=torch.int8),
                           LM_DECODE_B, LM_CACHE, "cuda")
        for k in ("k", "v"):
            for i in range(cfg.n_layers):
                codes, scale = attn_mod._q8(bf["layers"][k][i].float())
                q8["layers"][k][i] = codes
                q8["layers"][k + "_scale"][i] = scale
        dec = {}
        logits = {}
        for name, c, caches in (("bf16", cfg, bf),
                                ("int8", dataclasses.replace(
                                    cfg, cache_dtype=torch.int8), q8)):
            dec[name], logits[name] = lm_decode(c, params, caches,
                                                LM_DECODE_B,
                                                LM_CACHE - LM_DECODE_STEPS)
            dec[name]["cache_bytes"] = sum(
                v.numel() * v.element_size()
                for v in caches["layers"].values())
        ref = logits["bf16"].float()
        rel = float((logits["int8"].float() - ref).norm() / ref.norm())
        require(rel <= LM_INT8_TOL,
                f"{arch}: the int8 cache's decode logits differ from the "
                f"bf16 cache's by {rel} of their norm")
        out["decode_32k"] = dict(dec, int8_rel_err=rel)
        del bf, q8
        parts.s["decode_32k"] = time.perf_counter() - t0
    out["parts_s"] = parts.s
    del params
    torch.cuda.empty_cache()
    return out


def reddit_sampler() -> tuple:
    """(GNN_STEPS batches, their graph): a ``CsrGraph`` with Reddit's node
    count and REDDIT_EDGES of its edges at d_feat 602
    (``GNN_SHAPES["minibatch_lg"]``), sampled by ``NeighborSampler`` with
    its seeds and fanouts."""
    shape = GNN_SHAPES["minibatch_lg"]
    t0 = time.perf_counter()
    g = CsrGraph(GraphSpec(n_nodes=shape["n_nodes"], n_edges=REDDIT_EDGES,
                           d_feat=shape["d_feat"], n_classes=16))
    build_s = time.perf_counter() - t0
    s = NeighborSampler(g, SamplerConfig(batch_nodes=shape["batch_nodes"],
                                         fanouts=shape["fanouts"]))
    return [s.sample(k) for k in range(GNN_STEPS)], {
        "graph_nodes": g.spec.n_nodes, "graph_edges": REDDIT_EDGES,
        "graph_build_s": build_s, "padded_nodes": s.max_nodes,
        "padded_edges": s.max_edges}


def gnn_batches(shape: str) -> tuple:
    """(GNN_STEPS numpy batches of the cell: the full graph each step
    (full_graph_sm), ``molecule_batch`` of step k, or ``reddit_sampler``'s;
    the sampled graph's numbers)."""
    if shape == "molecule":
        b, n, e = (GNN_SHAPES["molecule"][k]
                   for k in ("batch", "n_nodes", "n_edges"))
        return [molecule_batch(b, n, e, step=k) for k in range(GNN_STEPS)], {}
    if shape == "minibatch_lg":
        return reddit_sampler()
    s = GNN_SHAPES[shape]
    g = CsrGraph(GraphSpec(n_nodes=s["n_nodes"], n_edges=s["n_edges"],
                           d_feat=s["d_feat"], n_classes=16))
    return [g.full_batch()] * GNN_STEPS, {}


def drop_degenerate(tree):
    """The GatedGCN params without the A biases: each feeds only a
    BatchNorm over the nodes, which subtracts it again, so its gradient is
    zero up to rounding and adam turns that rounding into steps of ±lr on
    either device (tests/test_torch_gnn.py reads the JAX package so)."""
    return dict(tree, layers=[{k: ({"w": v["w"]} if k == "A" else v)
                               for k, v in layer.items()}
                              for layer in tree["layers"]])


def edge_sums(tree) -> dict:
    """The GatedGCN leaves whose gradient is a sum over every edge of terms
    that the edge BatchNorm makes cancel: the edge gates' biases (C, D and
    E enter ê only through their sum, the same on every edge) and, at
    layer 0, C's weight and the edge embedding (their input is the same on
    every edge).  Summation order alone moves them by up to ~7e-5 of their
    norm (the CPU alone, the molecule cell's step 0 with the edges
    reordered and the ReLU decisions kept; other leaves ≤ 2.5e-5), so
    ``gnn_shadow`` holds them to GNN_EDGE_SUM_TOL."""
    return {"edge_embed": tree["edge_embed"],
            "layers": [{k: ({"b": layer[k]["b"], "w": layer[k]["w"]}
                            if (k == "C" and i == 0) else
                            {"b": layer[k]["b"]}) for k in "CDE"}
                       for i, layer in enumerate(tree["layers"])]}


def gnn_rest(tree) -> dict:
    """The GatedGCN leaves read at UPDATE_MEDIAN_TOL: all but the A biases
    (``drop_degenerate``) and ``edge_sums``."""
    t = drop_degenerate(tree)
    layers = []
    for i, layer in enumerate(t["layers"]):
        layer = {k: ({"w": v["w"]} if k in "DE" or (k == "C" and i)
                     else v) for k, v in layer.items() if (k, i) != ("C", 0)}
        layers.append(layer)
    return {k: (layers if k == "layers" else v) for k, v in t.items()
            if k != "edge_embed"}


def gnn_card_steps(shape: str, batches, held=None) -> tuple:
    """GNN_STEPS adam steps (lr GNN_LR) of the full GatedGCN on the card,
    then GNN_TIME_STEPS more timed (host clock, median); records the
    steps in ``held`` (default: every step) for ``gnn_shadow``; returns
    (the config; per recorded step: its index, the state before it on the
    host, the card's params and adam first moment after it on the host,
    its loss and its ReLU decisions (``ReluMasks``); the card's run
    numbers)."""
    dev = torch.device("cuda")
    cfg = get_arch("gatedgcn").make_config("full", shape=shape)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = gcn.init_params(cfg, gen, dev)
    optimizer = make_optimizer(OptimizerConfig(kind="adam", lr=GNN_LR))
    tc = TrainConfig(max_restarts=0)
    step_fn = build_train_step(lambda p, b: gcn.loss_fn(p, cfg, b),
                               optimizer, tc)
    state = init_state(params, optimizer, tc)
    torch.cuda.reset_peak_memory_stats()
    record, per = [], []
    losses = []
    for k, raw in enumerate(batches):
        batch = {key: torch.from_numpy(v).to(dev) for key, v in raw.items()}
        keep = held is None or k in held
        old = to_device(state, "cpu") if keep else None
        reset_launches()
        with ReluMasks() if keep else contextlib.nullcontext() as rec:
            state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        lm_expect(launch_counts(), {}, f"gatedgcn {shape} step {k}")
        if keep:
            record.append((k, old, to_device({"params": state["params"],
                                              "m": state["opt"]["m"]},
                                             "cpu"),
                           losses[-1], rec.masks))
    # the step's time, without the ReLU decisions' copies to the host
    for raw in batches[:GNN_TIME_STEPS]:
        batch = {key: torch.from_numpy(v).to(dev) for key, v in raw.items()}
        (state, m), ms = synced_ms(lambda: step_fn(state, batch))
        per.append(ms)
    run = {"steps": len(batches), "lr": GNN_LR,
           "losses": losses, "ms": statistics.median(per),
           "ms_each": per,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "nodes": int(batches[0]["nodes"].shape[0]
                        * batches[0]["nodes"].shape[1]),
           "edges": int(batches[0]["edges"].shape[0]
                        * batches[0]["edges"].shape[1])}
    require(np.isfinite(run["losses"]).all(),
            f"gatedgcn {shape}: losses {run['losses']}")
    return cfg, record, run


def grad_reading(err: "UpdateErr", old_m, card_m, cpu_m, keep=None):
    """Adds to ``err`` one adam step's gradient, card against CPU from the
    same first moment ``old_m``: the new moment is beta1·m + (1 - beta1)·g,
    so against beta1·``old_m`` the moments' updates are (1 - beta1)·g on
    each side, and ``UpdateErr`` reads |g_card - g_cpu| / |g_cpu|.
    ``keep`` (a tree map) selects the leaves read."""
    keep = keep or (lambda t: t)
    base = tree_map(lambda t: t * ADAM_BETA1, old_m)
    err.add(keep(base), keep(card_m), keep(cpu_m))


def adam_readings(old, card, cpu, device="cpu") -> tuple:
    """(gradient, params' update) ``UpdateErr``s of one adam step each,
    card against CPU from the same ``old`` state: ``card`` and ``cpu`` are
    {"params", "m"} after it.  The gradient (``grad_reading``, from adam's
    first moment) is read as phase 3 reads updates.  Adam's first steps
    move every element of the params by about lr·g/(|g| + eps), so an
    element whose gradient is within rounding of 0 moves by ±lr with the
    sign of that rounding: one such element of a 70 x 70 leaf reads 2/70
    of its norm, so GatedGCN's update is kept as information
    (``update_info``)."""
    g_err = UpdateErr(old["opt"]["m"], device)
    grad_reading(g_err, old["opt"]["m"], card["m"], cpu["m"])
    p_err = UpdateErr(old["params"], device)
    p_err.add(old["params"], card["params"], cpu["params"])
    return g_err, p_err


def update_info(err: UpdateErr) -> dict:
    """An ``UpdateErr`` kept as information: the largest leaf median,
    the steps with a leaf above UPDATE_TOL and how many elements were off
    by more than 1e-3 of their leaf's norm."""
    return {"max_median": max(err.medians().values()),
            "flagged_steps": sorted({f["step"] for f in err.flagged}),
            "elements_off": sum(f["elements"] for f in err.flagged)}


def lost_edges(rows):
    """A planted fault: ``gcn._segment_sum`` without the contributions of
    edge rows ``rows`` (atomic adds lost from every segment sum of every
    layer)."""
    real = gcn._segment_sum
    rows = torch.as_tensor(rows)

    def faulty(vals, seg, n):
        return real(vals.index_fill(0, rows, 0), seg, n)
    return unittest.mock.patch.object(gcn, "_segment_sum", faulty)


def gnn_shadow(shape: str, cfg, record, batches, planted: bool = False
               ) -> dict:
    """Each recorded card step against the CPU step from the same state,
    taken in the card step's ReLU decisions (``ReluMasks``; the decisions
    that differ are counted, at most RELU_FLIP_LIMIT[shape] a step): its
    loss within GNN_LOSS_TOL of it (relative) and each leaf of its
    gradient (``grad_reading``) read by ``UpdateErr`` as phase 3 reads
    updates (``gnn_rest``; ``edge_sums`` with their median within
    GNN_EDGE_SUM_TOL); the params' update reading kept as information
    (``update_info``).  With ``planted``, also what the two gradient
    readings give the first step's CPU step with ``lost_edges`` in place
    of the card's: its first valid edge, and every 100th (not held: it
    shows what the limits let through)."""
    optimizer = make_optimizer(OptimizerConfig(kind="adam", lr=GNN_LR))
    cpu_step = build_train_step(lambda p, b: gcn.loss_fn(p, cfg, b),
                                optimizer, TrainConfig())
    first = record[0][1]
    g_err = UpdateErr(gnn_rest(first["opt"]["m"]))
    e_err = UpdateErr(edge_sums(first["opt"]["m"]))
    p_err = UpdateErr(drop_degenerate(first["params"]))
    diffs, flips = [], []
    t0 = time.perf_counter()
    for k, old, card, loss, masks in record:
        host = {key: torch.from_numpy(v) for key, v in batches[k].items()}
        with ReluMasks(masks) as rep:
            want, wm = cpu_step(old, host)
        require(rep.at == len(masks) > 0,
                f"gatedgcn {shape}: the CPU step made {rep.at} ReLU calls, "
                f"the card's {len(masks)}")
        flips.append(rep.flips)
        wl = float(wm["loss"])
        diffs.append(abs(loss - wl) / max(1.0, abs(wl)))
        for err, keep in ((g_err, gnn_rest), (e_err, edge_sums)):
            grad_reading(err, old["opt"]["m"], card["m"], want["opt"]["m"],
                         keep)
        p_err.add(drop_degenerate(old["params"]),
                  drop_degenerate(card["params"]),
                  drop_degenerate(want["params"]))
        if planted and k == record[0][0]:
            valid = np.flatnonzero(batches[k]["edges"][..., 0].reshape(-1)
                                   >= 0)
            fault = {}
            for label, rows in (("one_edge", valid[:1]),
                                ("every_100th_edge", valid[::100])):
                with lost_edges(rows), ReluMasks(masks):
                    bad, _ = cpu_step(old, host)
                fault[label] = {"edges": len(rows)}
                for name, keep in (("rest", gnn_rest),
                                   ("edge_sums", edge_sums)):
                    err = UpdateErr(keep(first["opt"]["m"]))
                    grad_reading(err, old["opt"]["m"], bad["opt"]["m"],
                                 want["opt"]["m"], keep)
                    fault[label][name] = max(err.medians().values())
                del bad
    cpu_s = time.perf_counter() - t0
    what = f"gatedgcn {shape}"
    require(max(flips) <= RELU_FLIP_LIMIT[shape],
            f"{what}: the CPU steps took {flips} ReLU decisions from the "
            f"card's (at most {RELU_FLIP_LIMIT[shape]} a step)")
    require(max(diffs) <= GNN_LOSS_TOL,
            f"{what}: a card step's loss differs from the CPU step's from "
            f"the same state by {max(diffs)} of it")
    read = g_err.check(f"{what} gradient")
    edge = e_err.check(f"{what} gradient of the edge sums",
                       median_tol=GNN_EDGE_SUM_TOL)
    out = {"held_steps": [r[0] for r in record],
           "max_step_loss_rel_diff": max(diffs), "relu_flips": flips,
           "grad_max_median": read["max_median"],
           "grad_worst_leaf": max(read["median"], key=read["median"].get),
           "grad_flagged_steps": read["flagged_steps"],
           "edge_sums_max_median": edge["max_median"],
           "params_update": update_info(p_err), "cpu_s": cpu_s}
    if planted:
        out["lost_edges_read"] = fault
    return out


def lm_gnn(rates, dev, smi: str) -> dict:
    """Phase (i), one part after another with nothing beside the timed
    runs: GatedGCN's three cells (``gnn_card_steps``, their GNN_HELD steps
    held by ``gnn_shadow``, molecule's with the planted fault's reading),
    then ``lm_full_depth`` and ``lm_reduced_depth`` of each of
    LM_REDUCED."""
    t0 = time.perf_counter()
    parts = Parts()
    out = {"card": smi}
    gnn = out["gatedgcn"] = {}
    for shape in ("full_graph_sm", "molecule", "minibatch_lg"):
        with parts(f"{shape}_batches"):
            batches, graph = gnn_batches(shape)
        with parts(f"{shape}_card"):
            cfg, record, run = gnn_card_steps(shape, batches,
                                              GNN_HELD.get(shape))
        with parts(f"{shape}_cpu"):
            run["check"] = gnn_shadow(shape, cfg, record, batches,
                                      planted=shape == "molecule")
        gnn[shape] = dict(run, **graph)
        del record, batches
    with parts("lm_full_depth"):
        out["lm_full_depth"] = lm_full_depth(rates, dev)
    out["lm_reduced_depth"] = {}
    for arch in LM_REDUCED:
        with parts(arch):
            out["lm_reduced_depth"][arch] = lm_reduced_depth(arch, dev)
    out["parts_s"] = parts.s
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase (h): distribution on a one-rank NCCL mesh
# ---------------------------------------------------------------------------

def one_rank_mesh(tmp: str, device: str = "cuda") -> dist.DistContext:
    """A world of this one process (NCCL on the card; a ``FileStore`` in
    ``tmp``) and the (1, 1) ("data", "model") mesh on it."""
    import torch.distributed as tdist
    tdist.init_process_group("nccl" if device == "cuda" else "gloo",
                             init_method=f"file://{tmp}/pg", rank=0,
                             world_size=1, timeout=timedelta(seconds=300))
    return dist.DistContext(mesh=make_mesh((1, 1), ("data", "model"),
                                           device=device),
                            rules=dist.default_rules())


def mesh_scores(srv: EmbeddingServer, kind: str, batches) -> tuple:
    """``score`` of every (batch, n_valid) under the active mesh, with the
    kernel launches and the collectives of just these calls."""
    reset_launches()
    coll.counts.clear()
    out = [srv.score(kind, b, n) for b, n in batches]
    torch.cuda.synchronize()
    return out, launch_counts(), dict(coll.counts)


def score_ms_turns(servers: dict, kind: str, batch, n: int,
                   reps: int) -> dict:
    """Host-clock ``score`` (median of ``reps``) of each server in turns,
    the first again last: {label: [ms, ...]}."""
    out = {label: [] for label in servers}
    order = list(servers) + list(servers)[::-1]
    for label in order:
        ctx = servers[label][1]
        with dist.use(ctx) if ctx is not None else contextlib.nullcontext():
            out[label].append(host_ms(
                lambda: servers[label][0].score(kind, batch, n), reps=reps))
    return out


def score_profiles(servers: dict, kind: str, batch, n: int) -> dict:
    """``device_breakdown`` of ``score`` for each server (under its
    context), top kernels cut to 8: {label: breakdown}."""
    out = {}
    for label, (srv, ctx) in servers.items():
        with dist.use(ctx) if ctx is not None else contextlib.nullcontext():
            prof = device_breakdown(lambda: srv.score(kind, batch, n))
        prof["top_ms"] = dict(list(prof["top_ms"].items())[:8])
        out[label] = prof
    return out


def mesh_full_path(ctx, base: EmbeddingServer) -> dict:
    """(h) 2: ``full`` row-sharded over ``model``, then over the whole mesh
    (``2d``), on (e)'s 52.3 GB table (its shard on one rank is the table
    itself: no second copy): ``score`` at B = 512 (padded) and 262,144
    ``np.array_equal`` to the unsharded path's, dot_interaction once a
    call and no other kernel, and the table's collectives once a call;
    timed in turns with the unsharded path."""
    params = base.params("full")
    small = padded_batches((512, 437), B_P99)
    bulk = padded_batches((B_BULK,), B_BULK)
    want = [base.score("full", b, n) for b, n in small + bulk]
    res = {}
    for placement in ("model", "2d"):
        with dist.use(ctx):
            srv = EmbeddingServer(dataclasses.replace(
                base.cfg, backends=("full",), cache_capacity=0),
                params={"full": params}, device="cuda",
                placement={"full": placement})
            require(srv.params("full")["embedding"]["table"].data_ptr()
                    == params["embedding"]["table"].data_ptr(),
                    "the one-rank shard of the full table is a copy")
            got, c, cc = mesh_scores(srv, "full", small + bulk)
        calls = len(small) + len(bulk)
        require(c["dot_interaction"] == calls and sum(c.values()) == calls,
                f"sharded full ({placement}) launched {c}; expected "
                f"dot_interaction once a call and no other kernel")
        ids = calls if placement == "2d" else 0
        require(cc.get("reduce_scatter") == calls and
                cc.get("all_gather") == calls + ids,
                f"sharded full ({placement}): collectives {cc}; expected "
                f"one reduce-scatter a call, one all-gather of the logits "
                f"(and, 2d, of the ids)")
        for (b, n), g, w in zip(small + bulk, got, want):
            require(np.array_equal(g, w),
                    f"sharded full ({placement}) at B={len(b['sparse'])}: "
                    f"scores differ from the unsharded path by "
                    f"{np.abs(g - w).max()}")
        res[placement] = {
            "launches": {k: v for k, v in c.items() if v},
            "collectives": cc,
            "ms_512": score_ms_turns({"unsharded": (base, None),
                                      "sharded": (srv, ctx)}, "full",
                                     *small[0], REPS),
            "ms_262144": score_ms_turns({"unsharded": (base, None),
                                         "sharded": (srv, ctx)}, "full",
                                        *bulk[0], H_REPS),
            "profile_512": score_profiles({"unsharded": (base, None),
                                           "sharded": (srv, ctx)}, "full",
                                          *small[0])}
        del srv
        print(f"(h) full {placement}: scores equal to the unsharded path's "
              f"at B=512 and {B_BULK}; {res[placement]['ms_262144']}")
    return res


def z3_steps(ctx, cfg: RecsysConfig, params, batches) -> dict:
    """(h) 1, training: ZeRO-3 adagrad steps on the mesh, each held to the
    undistributed card step from the same state (loss within 2e-3, each
    leaf's update by ``UpdateErr``: medians within 1e-4 of its norm), one
    launch a step of each of ``TRAIN_KERNELS["robe"]``, the gather and its
    transpose once a step; then both steps timed (host clock, median of
    7).  Returns the numbers and the mesh run's last state."""
    opt = make_optimizer(OptimizerConfig(kind="adagrad", lr=1e-3))
    tc = TrainConfig()
    lossf = (lambda p, b: loss_fn(p, cfg, b))
    whole = init_state(params, opt, tc)
    plain = build_train_step(lossf, opt, tc)
    with dist.use(ctx):
        specs = dist.prune_specs(recsys_specs(
            params, ctx.rules, cfg.embedding_spec(), mesh=ctx.mesh), params,
            ctx.mesh)
        require(specs["embedding"]["memory"] == dist.P("model"),
                f"ZeRO-3 spec {specs['embedding']}")
        state = init_state(dist.place(params, specs, ctx), opt, tc)
        step = build_train_step(lossf, opt, tc, specs=specs)
    upd = UpdateErr(params)
    per_step, coll_step, losses = [], [], []
    for k, batch in enumerate(batches):
        batch = to_device(batch, "cuda")
        before = to_device(state["params"], "cpu")
        reset_launches()
        coll.counts.clear()
        with dist.use(ctx):
            new, m = step(state, batch)
            loss = float(m["loss"])
        torch.cuda.synchronize()
        per_step.append(launch_counts())
        coll_step.append(dict(coll.counts))
        ref, mr = plain(state, batch)
        require(np.isfinite(loss) and abs(loss - float(mr["loss"])) <= 2e-3,
                f"ZeRO-3 step {k}: loss {loss}, undistributed {mr['loss']}")
        upd.add(before, new["params"], to_device(ref["params"], "cpu"))
        losses.append(loss)
        state = new
        del ref
    reading = upd.check("ZeRO-3 adagrad against the undistributed step")
    for k, (c, cc) in enumerate(zip(per_step, coll_step)):
        require(all(n == (1 if name in TRAIN_KERNELS["robe"] else 0)
                    for name, n in c.items()),
                f"ZeRO-3 step {k} launched {c}; expected one each of "
                f"{TRAIN_KERNELS['robe']}")
        require(cc.get("all_gather") == 1 and cc.get("reduce_scatter") == 1,
                f"ZeRO-3 step {k}: collectives {cc}; expected the array's "
                f"gather and its reduce-scatter once")
    box = {"mesh": state, "plain": whole}
    batch = to_device(batches[0], "cuda")

    def mesh_one():
        with dist.use(ctx):
            box["mesh"], mm = step(box["mesh"], batch)
        float(mm["loss"])

    def plain_one():
        box["plain"], mm = plain(box["plain"], batch)
        float(mm["loss"])
    times = {"replicated": [], "zero3": []}
    for label, fn in (("replicated", plain_one), ("zero3", mesh_one),
                      ("zero3", mesh_one), ("replicated", plain_one)):
        times[label].append(host_ms(fn, reps=H_REPS))
    profile = {}
    for label, fn in (("replicated", plain_one), ("zero3", mesh_one)):
        prof = device_breakdown(fn)
        prof["top_ms"] = dict(list(prof["top_ms"].items())[:8])
        profile[label] = prof
    state = box["mesh"]
    del box
    return {"losses": losses, "update": reading,
            "launches_per_step": per_step[0],
            "launches": {k: sum(c[k] for c in per_step)
                         for k in per_step[0]},
            "collectives_per_step": coll_step[0], "step_ms": times,
            "profile": profile}, \
        state, specs


def compression_check(ctx, cfg: RecsysConfig, state, specs, batches) -> dict:
    """(h) 3: ``bf16`` and ``int8`` on the ZeRO-3 step: three compressed
    steps with finite losses; then on the card's own gradient g (of the
    next batch) with the run's residual r, ``compressed_psum``'s out and
    new residual: out + new_r == g + r exactly, and |out - (g + r)|
    within half a bf16 ulp of g + r, or half the int8 grid step."""
    opt = make_optimizer(OptimizerConfig(kind="adagrad", lr=1e-3))
    res = {}
    for method in ("bf16", "int8"):
        tc = TrainConfig(grad_compression=method)
        with dist.use(ctx):
            st = init_state(state["params"], opt, tc, specs=specs)
            step = build_train_step(lambda p, b: loss_fn(p, cfg, b), opt,
                                    tc, specs=specs)
            losses = []
            for batch in batches[:H_COMPRESSED_STEPS]:
                st, m = step(st, to_device(batch, "cuda"))
                losses.append(float(m["loss"]))
            require(all(np.isfinite(losses)),
                    f"{method} compressed steps: losses {losses}")
            g = loss_grads(cfg, st["params"], to_device(
                batches[H_COMPRESSED_STEPS], "cuda"))
            flat_g = leaves(g)
            flat_r = [r[0] for r in leaves(st["ef"])]
            out, new_r = compressed_psum(flat_g, flat_r, ctx.dp_axes, method,
                                         ctx)
        worst, exact = 0.0, True
        for gg, rr, o, nr in zip(flat_g, flat_r, out, new_r):
            x = gg.float() + rr
            exact &= bool(torch.equal(o + nr, x))
            if method == "bf16":
                # half an ulp of x in bf16 (8 significant bits; the
                # subnormals' spacing below 2^-126)
                ulp = torch.exp2(torch.floor(torch.log2(x.abs()))
                                 .clamp_min(-126) - 7)
                bound = torch.where(x == 0, torch.zeros_like(x), ulp / 2)
            else:
                scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
                bound = torch.full_like(x, float(scale) / 2 * (1 + 1e-6))
            over = float(((o - x).abs() - bound).max())
            worst = max(worst, over)
        require(exact, f"{method}: out + new residual != g + r")
        require(worst <= 0.0, f"{method}: |out - (g + r)| exceeds its "
                f"bound by {worst}")
        res[method] = {"losses": losses, "exact_bookkeeping": exact,
                       "max_over_bound": worst,
                       "residual_norm": float(sum(
                           float(r.double().square().sum())
                           for r in new_r) ** 0.5)}
        del st, g, out, new_r
    return res


def checkpoint_check(ctx, state, specs) -> dict:
    """(h) 4: ``save`` of the ZeRO-3 state from the mesh, then
    ``restore_onto`` it: every leaf ``torch.equal``."""
    sspecs = train_state_specs(state, specs, ctx.rules)
    with tempfile.TemporaryDirectory() as d, dist.use(ctx):
        t0 = time.perf_counter()
        ckpt.save(d, int(state["step"]), state,
                  shardings=dist.named_shardings(ctx, sspecs))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, man = ckpt.restore_onto(d, state, ctx, sspecs)
        restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(state))
               if a is not None)
    require(same and int(man["step"]) == int(state["step"]),
            "the ZeRO-3 checkpoint did not restore bit for bit")
    return {"save_s": save_s, "restore_s": restore_s,
            "bytes": state_bytes(state)}


def retrieval_check(ctx) -> dict:
    """(h) 5: the two-tower bundle's retrieval of N_CAND candidates under
    the mesh: scores ``torch.equal`` to the same call without it and to
    phase (g)'s (same seeded init), robe_lookup twice and no other
    kernel."""
    cfg = family_config("two-tower-retrieval")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, "cuda")
    rb = retrieval_batch(CtrDataConfig(vocab_sizes=cfg.vocab_sizes,
                                       batch_size=B_P99, seed=SEED),
                         0, cfg.n_user_fields, N_CAND)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in rb.items()}
    with torch.inference_mode():
        want = serve_scores(params, cfg, batch).cpu()
        with dist.use(ctx):
            reset_launches()
            coll.counts.clear()
            got = serve_scores(params, cfg, batch).cpu()
            c, cc = launch_counts(), dict(coll.counts)
            ms = host_ms(lambda: serve_scores(params, cfg, batch).cpu(),
                         reps=H_REPS)
    require(c["robe_lookup"] == 2 and sum(c.values()) == 2,
            f"retrieval under the mesh launched {c}")
    require(torch.equal(got, want), f"retrieval under the mesh differs by "
            f"{float((got - want).abs().max())}")
    g = G_SCORES.get(cfg.name)
    require(g is not None and torch.equal(got, g),
            "retrieval under the mesh differs from phase (g)'s scores")
    return {"launches": {k: v for k, v in c.items() if v},
            "collectives": cc, "ms": ms, "shape": list(got.shape)}


def mesh_robe_path(ctx, cfg: ServerConfig, params) -> dict:
    """(h) 1, 3, 4, 5 at full ``dlrm-criteo-tb`` width (|M| = 26,135,627):
    ZeRO-3 ``score`` at B = 512 (padded) and 262,144 ``torch.equal`` to the
    replicated unfused path's, one robe_lookup a call and no serve_fused
    (the fused kernel declines a sharded array); ``z3_steps``;
    ``compression_check``; ``checkpoint_check``; ``retrieval_check``."""
    t0 = time.perf_counter()
    rep = EmbeddingServer(dataclasses.replace(cfg, use_kernel=False),
                          params={"robe": params}, device="cuda")
    small = padded_batches((512, 437), B_P99)
    bulk = padded_batches((B_BULK,), B_BULK)
    want = [rep.score("robe", b, n) for b, n in small + bulk]
    with dist.use(ctx):
        z3 = EmbeddingServer(cfg, params={"robe": params}, device="cuda",
                             placement={"robe": "model"})
        got, c, cc = mesh_scores(z3, "robe", small + bulk)
    calls = len(small) + len(bulk)
    require(c["robe_lookup"] == calls and c["serve_fused"] == 0 and
            c["dot_interaction"] == calls and sum(c.values()) == 2 * calls,
            f"ZeRO-3 score launched {c}; expected robe_lookup and "
            f"dot_interaction once a call and no serve_fused")
    require(cc.get("all_gather") == 2 * calls,
            f"ZeRO-3 score: collectives {cc}; expected the array's gather "
            f"and the logits' once a call")
    for (b, n), g, w in zip(small + bulk, got, want):
        require(np.array_equal(g, w),
                f"ZeRO-3 score at B={len(b['sparse'])} differs from the "
                f"replicated path by {np.abs(g - w).max()}")
    res = {"score": {"launches": {k: v for k, v in c.items() if v},
                     "collectives": cc,
                     "ms_512": score_ms_turns(
                         {"replicated": (rep, None), "zero3": (z3, ctx)},
                         "robe", *small[0], REPS),
                     "ms_262144": score_ms_turns(
                         {"replicated": (rep, None), "zero3": (z3, ctx)},
                         "robe", *bulk[0], H_REPS),
                     "profile_512": score_profiles(
                         {"replicated": (rep, None), "zero3": (z3, ctx)},
                         "robe", *small[0])}}
    del rep, z3
    print(f"(h) ZeRO-3 score equal to the replicated path's; "
          f"{res['score']['ms_262144']}")
    mcfg = cfg.recsys_cfg("robe")
    mcfg = dataclasses.replace(mcfg, robe_shard_model=True)
    batches = train_batches(B_TRAIN, max(H_STEPS, H_COMPRESSED_STEPS + 1),
                            "cpu")
    res["train"], state, specs = z3_steps(ctx, mcfg, params,
                                          batches[:H_STEPS])
    print(f"(h) ZeRO-3 steps ok: {res['train']['step_ms']}")
    res["compression"] = compression_check(ctx, mcfg, state, specs, batches)
    res["checkpoint"] = checkpoint_check(ctx, state, specs)
    del state
    torch.cuda.empty_cache()
    res["retrieval"] = retrieval_check(ctx)
    res["wall_s"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# phase (j): the LM family and GatedGCN on the one-rank NCCL mesh
# ---------------------------------------------------------------------------

def j_placed(ctx, params, cfg) -> tuple:
    """``params`` placed on the mesh by ``transformer_specs`` (pruned; on
    one rank each shard is the leaf itself) and the spec tree."""
    specs = dist.prune_specs(transformer_specs(params, ctx.rules), params,
                             ctx.mesh)
    return dist.place(params, specs, ctx), specs


def j_call(ctx, specs, fn):
    """(fn()'s result, host ms, kernel launches, collectives) of one call
    under the mesh, the counts set to 0 just before it."""
    with dist.use(ctx), dist.placed(specs):
        reset_launches()
        coll.counts.clear()
        out, ms = synced_ms(fn)
        return out, ms, launch_counts(), dict(coll.counts)


def j_hold(what: str, got, want) -> float:
    err = max_err(got, want)
    require(torch.allclose(got, want, rtol=J_TOL, atol=J_TOL),
            f"(j) {what}: the mesh's result is {err} from the run without "
            f"one (tolerance {J_TOL})")
    return err


def j_lm_dense(ctx, dev) -> dict:
    """(j) 1: J_ARCH at full width and depth, ``robe`` (8x), f32 compute
    and caches: a prefill of 1 x J_PREFILL_T tokens (``collect_cache``),
    J_DECODE_STEPS decode steps on caches cut along the sequence
    (``fill_cache``), J_TRAIN_STEPS adam steps (lr LM_LR, remat) at B =
    J_TRAIN_B, T = J_TRAIN_T; each on the mesh (params placed by
    ``transformer_specs``) held to the same call without one from the
    same state: logits within J_TOL, a step's loss within J_TOL and its
    gradient (adam's first moment, ``grad_reading``) with every leaf's
    median reading within J_TOL.  Reads one ``robe_lookup`` a forward and
    one ``robe_lookup_bwd`` a step, and the collectives a call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cfg = lm_config(J_ARCH, "robe", compute_dtype=torch.float32,
                    cache_dtype=torch.float32)
    params = lm.init_params(cfg, gen, dev)
    mparams, specs = j_placed(ctx, params, cfg)
    toks = lm_tokens(cfg, 1, J_PREFILL_T + J_DECODE_STEPS, 11)["tokens"]
    out = {"arch": J_ARCH, "params": cfg.param_count()}
    runs = {}
    for label, c, p, sp in (("plain", None, params, None),
                            ("mesh", ctx, mparams, specs)):
        torch.cuda.reset_peak_memory_stats()
        with dist.use(c) if c else contextlib.nullcontext(), \
                dist.placed(sp), torch.inference_mode():
            reset_launches()
            coll.counts.clear()
            (last, _, pre), ms = synced_ms(lambda: lm.forward(
                p, cfg, toks[:, :J_PREFILL_T], collect_cache=True,
                logits_mode="last"))
            pf = {"ms": ms, "launches": launch_counts(),
                  "collectives": dict(coll.counts)}
            caches = lm.fill_cache(cfg, lm.init_cache(
                cfg, 1, J_PREFILL_T + J_DECODE_STEPS, dev), pre,
                J_PREFILL_T)
            del pre
            steps, dec = [], []
            for t in range(J_PREFILL_T, J_PREFILL_T + J_DECODE_STEPS):
                reset_launches()
                coll.counts.clear()
                (lg, caches), ms = synced_ms(lambda: lm.decode_step(
                    p, cfg, caches, toks[:, t:t + 1], t))
                steps.append(lg)
                dec.append({"ms": ms, "launches": launch_counts(),
                            "collectives": dict(coll.counts)})
            del caches
        runs[label] = {"last": last, "steps": steps, "prefill": pf,
                       "decode": dec,
                       "max_memory_allocated":
                           torch.cuda.max_memory_allocated()}
        lm_expect(pf["launches"], {"robe_lookup": 1}, f"(j) {label} prefill")
        for d in dec:
            lm_expect(d["launches"], {"robe_lookup": 1},
                      f"(j) {label} decode step")
    m, w = runs["mesh"], runs["plain"]
    out["prefill_logits_max_diff"] = j_hold("prefill logits", m["last"],
                                            w["last"])
    out["decode_logits_max_diff"] = max(
        j_hold(f"decode step {k}", a, b)
        for k, (a, b) in enumerate(zip(m["steps"], w["steps"])))
    require(m["prefill"]["collectives"].get("all_gather", 0) > 0 and
            all(d["collectives"].get("all_reduce", 0) > 0
                for d in m["decode"]),
            f"(j) {J_ARCH}: the mesh's calls exchanged nothing: "
            f"{m['prefill']['collectives']}, {m['decode'][0]['collectives']}")
    for label in runs:
        r = runs[label]
        out[label] = {"prefill_ms": r["prefill"]["ms"],
                      "decode_ms": [d["ms"] for d in r["decode"]],
                      "max_memory_allocated_serve":
                          r["max_memory_allocated"]}
    out["mesh"]["prefill_collectives"] = m["prefill"]["collectives"]
    out["mesh"]["decode_collectives"] = m["decode"][-1]["collectives"]
    out["launches"] = {"prefill": mean_launches([m["prefill"]["launches"]]),
                       "decode_step": mean_launches(
                           [d["launches"] for d in m["decode"]])}
    del runs, m, w
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(cfg, remat=True)
    opt = make_optimizer(OptimizerConfig(kind="adam", lr=LM_LR))
    tc = TrainConfig(max_restarts=0)
    plain = build_train_step(lambda q, b: lm.loss_fn(q, tcfg, b), opt, tc)
    state = init_state(params, opt, tc)
    g_err = UpdateErr(state["opt"]["m"], "cuda")
    train = {"plain_ms": [], "mesh_ms": [], "loss_diff": [],
             "launches": [], "collectives": [], "max_memory_allocated": []}
    with dist.use(ctx):
        mesh = build_train_step(lambda q, b: lm.loss_fn(q, tcfg, b), opt,
                                tc, specs=specs)
    for k in range(J_TRAIN_STEPS):
        batch = lm_tokens(tcfg, J_TRAIN_B, J_TRAIN_T, k)
        # the step without the mesh first; of it only adam's first moment
        # and the loss are kept
        torch.cuda.reset_peak_memory_stats()
        (want, wm), ms = synced_ms(lambda: plain(state, batch))
        want_m, want_loss = want["opt"]["m"], float(wm["loss"])
        del want
        train["plain_ms"].append(ms)
        (new, nm), ms, launches, cc = j_call(ctx, specs,
                                             lambda: mesh(state, batch))
        train["max_memory_allocated"].append(
            torch.cuda.max_memory_allocated())
        train["mesh_ms"].append(ms)
        train["launches"].append({n: v for n, v in launches.items() if v})
        train["collectives"].append(cc)
        lm_expect(launches, lm_step_kernels(tcfg, train=True),
                  f"(j) {J_ARCH} mesh train step {k}")
        loss = float(nm["loss"])
        train["loss_diff"].append(abs(loss - want_loss))
        require(abs(loss - want_loss) <= J_TOL * max(1.0, abs(want_loss)),
                f"(j) {J_ARCH} train step {k}: loss {loss} on the mesh, "
                f"{want_loss} without")
        grad_reading(g_err, state["opt"]["m"], new["opt"]["m"], want_m)
        del want_m
        state = new
    read = g_err.check(f"(j) {J_ARCH} mesh train steps' gradient",
                       median_tol=J_TOL)
    train["grad_max_reading"] = read["max_median"]
    out["train"] = train
    out["launches"]["train_step"] = mean_launches(train["launches"])
    del state, params, mparams
    torch.cuda.empty_cache()
    return out


class Drops:
    """Within it, every ``moe_apply_ep`` call of the transformer also
    counts the (token, choice) slots its capacity drops, from the same
    router: ``slots`` and ``dropped``."""

    def __init__(self):
        self.slots, self.dropped = 0, 0

    def __enter__(self):
        self.orig = fn = lm.moe_apply_ep

        def wrapped(p, cfg, x, *a, **k):
            _, idx, _ = moe_mod._router(p, cfg, x)
            cnt = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
            cap = moe_mod.capacity(cfg, x.shape[0])
            self.slots += idx.numel()
            self.dropped += int((cnt - cap).clamp_min(0).sum())
            return fn(p, cfg, x, *a, **k)
        lm.moe_apply_ep = wrapped
        return self

    def __exit__(self, *exc):
        lm.moe_apply_ep = self.orig


def j_lm_moe(ctx, dev) -> dict:
    """(j) 2: J_MOE_ARCH at full width, J_MOE_LAYERS layers, ``full``,
    f32: with ``moe_dispatch="ep"`` on the mesh at a capacity where no
    slot can drop (capacity_factor E / k: an expert's slots hold every
    token), a prefill of 1 x J_PREFILL_T and J_DECODE_STEPS decode steps
    held to the dense dispatch without the mesh (J_TOL), two all_to_alls
    a MoE layer a forward; then at the config's capacity_factor the
    prefill's dropped slots (``Drops``)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    base = lm_config(J_MOE_ARCH, n_layers=J_MOE_LAYERS,
                     compute_dtype=torch.float32, cache_dtype=torch.float32)
    params = lm.init_params(base, gen, dev)
    dense = dataclasses.replace(base, moe_dispatch="dense")
    ep = dataclasses.replace(base, moe_dispatch="ep", capacity_factor=float(
        base.n_experts // base.top_k))
    toks = lm_tokens(base, 1, J_PREFILL_T + J_DECODE_STEPS, 13)["tokens"]
    mparams, specs = j_placed(ctx, params, base)
    out = {"arch": J_MOE_ARCH, "layers": J_MOE_LAYERS,
           "params": base.param_count(),
           "capacity_factor_held": ep.capacity_factor}
    runs = {}
    for label, cfg, c, p, sp in (("dense", dense, None, params, None),
                                 ("ep", ep, ctx, mparams, specs)):
        torch.cuda.reset_peak_memory_stats()
        with dist.use(c) if c else contextlib.nullcontext(), \
                dist.placed(sp), torch.inference_mode(), Drops() as dr:
            coll.counts.clear()
            (last, _, pre), pms = synced_ms(lambda: lm.forward(
                p, cfg, toks[:, :J_PREFILL_T], collect_cache=True,
                logits_mode="last"))
            pcc = dict(coll.counts)
            caches = lm.fill_cache(cfg, lm.init_cache(
                cfg, 1, J_PREFILL_T + J_DECODE_STEPS, dev), pre,
                J_PREFILL_T)
            del pre
            steps, dms, dcc = [], [], []
            for t in range(J_PREFILL_T, J_PREFILL_T + J_DECODE_STEPS):
                coll.counts.clear()
                (lg, caches), ms = synced_ms(lambda: lm.decode_step(
                    p, cfg, caches, toks[:, t:t + 1], t))
                steps.append(lg)
                dms.append(ms)
                dcc.append(dict(coll.counts))
            del caches
        runs[label] = (last, steps)
        out[label] = {"prefill_ms": pms, "decode_ms": dms,
                      "prefill_collectives": pcc,
                      "decode_collectives": dcc[-1],
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated(),
                      "dropped_slots": dr.dropped, "slots": dr.slots}
    n_moe = J_MOE_LAYERS - base.first_k_dense
    ep_out = out["ep"]
    require(ep_out["prefill_collectives"].get("all_to_all") == 2 * n_moe and
            all(c.get("all_to_all") == 2 * n_moe for c in dcc),
            f"(j) {J_MOE_ARCH} EP: all_to_all {ep_out['prefill_collectives']}"
            f" / {dcc}; expected 2 a MoE layer a forward")
    require(ep_out["dropped_slots"] == 0,
            f"(j) {J_MOE_ARCH} EP dropped {ep_out['dropped_slots']} slots at "
            f"capacity_factor {ep.capacity_factor}")
    out["prefill_logits_max_diff"] = j_hold(
        f"{J_MOE_ARCH} EP prefill logits", runs["ep"][0], runs["dense"][0])
    out["decode_logits_max_diff"] = max(
        j_hold(f"{J_MOE_ARCH} EP decode step {k}", a, b)
        for k, (a, b) in enumerate(zip(runs["ep"][1], runs["dense"][1])))
    del runs
    # at the config's capacity: how many slots the EP prefill drops
    at_cap = dataclasses.replace(base, moe_dispatch="ep")
    with dist.use(ctx), dist.placed(specs), torch.inference_mode(), \
            Drops() as dr:
        lg, ms = synced_ms(lambda: lm.forward(
            mparams, at_cap, toks[:, :J_PREFILL_T], logits_mode="last")[0])
    require(bool(torch.isfinite(lg).all()),
            f"(j) {J_MOE_ARCH} EP at capacity {base.capacity_factor}: "
            f"logits not finite")
    out["capacity_config"] = {"capacity_factor": base.capacity_factor,
                              "prefill_ms": ms, "dropped_slots": dr.dropped,
                              "slots": dr.slots}
    del params, mparams
    torch.cuda.empty_cache()
    return out


def j_gnn(ctx, dev) -> dict:
    """(j) 3: GatedGCN ``full_graph_sm`` (one graph of 10,556 edges: the
    edge-parallel body) at full width: J_GNN_STEPS adam steps (lr GNN_LR)
    on the mesh, each held to the step without it from the same state as
    phase (i) holds GatedGCN (``gnn_shadow``): the step's loss within
    GNN_LOSS_TOL, its gradient read by ``grad_reading`` (``gnn_rest`` at
    UPDATE_MEDIAN_TOL, ``edge_sums`` at GNN_EDGE_SUM_TOL), the step
    without the mesh taken in the mesh step's ReLU decisions
    (``ReluMasks``, at most RELU_FLIP_LIMIT of them differing); then
    GNN_TIME_STEPS steps of each, timed in turns."""
    shape = "full_graph_sm"
    cfg = get_arch("gatedgcn").make_config("full", shape=shape)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = gcn.init_params(cfg, gen, dev)
    batches, _ = gnn_batches(shape)
    raw = batches[0]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    optimizer = make_optimizer(OptimizerConfig(kind="adam", lr=GNN_LR))
    tc = TrainConfig(max_restarts=0)
    specs = replicated_specs(params)
    plain = build_train_step(lambda p, b: gcn.loss_fn(p, cfg, b),
                             optimizer, tc)
    mesh = build_train_step(lambda p, b: gcn.loss_fn(p, cfg, b), optimizer,
                            tc, specs=specs)
    state = init_state(params, optimizer, tc)
    g_err = UpdateErr(gnn_rest(state["opt"]["m"]), "cuda")
    e_err = UpdateErr(edge_sums(state["opt"]["m"]), "cuda")
    out = {"edges": int(raw["edges"].shape[1]), "steps": J_GNN_STEPS,
           "loss_rel_diff": [], "relu_flips": [], "collectives": []}
    torch.cuda.reset_peak_memory_stats()
    for k in range(J_GNN_STEPS):
        with ReluMasks() as rec:
            (new, nm), _, launches, cc = j_call(ctx, specs,
                                                lambda: mesh(state, batch))
        lm_expect(launches, {}, f"(j) gatedgcn mesh step {k}")
        out["collectives"].append(cc)
        with ReluMasks(rec.masks) as rep:
            want, wm = plain(state, batch)
        require(rep.at == len(rec.masks) > 0,
                f"(j) gatedgcn: {rep.at} ReLU calls without the mesh, "
                f"{len(rec.masks)} on it")
        out["relu_flips"].append(rep.flips)
        wl = float(wm["loss"])
        out["loss_rel_diff"].append(abs(float(nm["loss"]) - wl)
                                    / max(1.0, abs(wl)))
        for err, keep in ((g_err, gnn_rest), (e_err, edge_sums)):
            grad_reading(err, state["opt"]["m"], new["opt"]["m"],
                         want["opt"]["m"], keep)
        del want
        state = new
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    require(max(out["relu_flips"]) <= RELU_FLIP_LIMIT[shape],
            f"(j) gatedgcn: {out['relu_flips']} ReLU decisions differ "
            f"(at most {RELU_FLIP_LIMIT[shape]} a step)")
    require(max(out["loss_rel_diff"]) <= GNN_LOSS_TOL,
            f"(j) gatedgcn: losses differ by {out['loss_rel_diff']}")
    require(all(c.get("all_reduce", 0) > 0 for c in out["collectives"]),
            f"(j) gatedgcn: the edge-parallel steps exchanged nothing: "
            f"{out['collectives']}")
    read = g_err.check("(j) gatedgcn mesh steps' gradient")
    edge = e_err.check("(j) gatedgcn mesh steps' gradient of the edge sums",
                       median_tol=GNN_EDGE_SUM_TOL)
    out.update(grad_max_median=read["max_median"],
               edge_sums_max_median=edge["max_median"])
    out["collectives"] = out["collectives"][-1]
    per = {"plain": [], "mesh": []}
    for _ in range(GNN_TIME_STEPS):
        for label in ("plain", "mesh", "mesh", "plain"):
            with dist.use(ctx) if label == "mesh" else \
                    contextlib.nullcontext():
                fn = mesh if label == "mesh" else plain
                (state, _), ms = synced_ms(lambda: fn(state, batch))
            per[label].append(ms)
    out["step_ms"] = {k: statistics.median(v) for k, v in per.items()}
    out["step_ms_each"] = per
    del state, params
    torch.cuda.empty_cache()
    return out


def lm_gnn_mesh(smi: str) -> dict:
    """Phase (j): ``j_lm_dense``, ``j_lm_moe`` and ``j_gnn`` on a one-rank
    NCCL mesh (a new world: phase (h) ended its own)."""
    import torch.distributed as tdist
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    parts = Parts()
    out = {"card": smi}
    ctx = one_rank_mesh(tempfile.mkdtemp())
    try:
        # NCCL starts a group's communicator at its first collective: start
        # them all before any timed call
        for axes in ("data", "model", ("data", "model")):
            coll.all_reduce_(torch.zeros(1, device=dev), ctx, axes)
        with parts("lm_dense"):
            out["lm_dense"] = j_lm_dense(ctx, dev)
        print(f"(j) {J_ARCH}: " + json.dumps({k: out["lm_dense"][k] for k in
                                              ("prefill_logits_max_diff",
                                               "decode_logits_max_diff")}),
              flush=True)
        with parts("lm_moe"):
            out["lm_moe"] = j_lm_moe(ctx, dev)
        with parts("gnn"):
            out["gatedgcn"] = j_gnn(ctx, dev)
    finally:
        tdist.destroy_process_group()
    out["parts_s"] = parts.s
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase (k): the launch tooling's cells on a one-rank mesh
# ---------------------------------------------------------------------------

# the dry run's counters on the same one-rank calls, in a process on the
# host: a fake world of one rank, the (1, 1) mesh, every tensor fake
K_FIGURES = """
import json, sys
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.dist import api as dist
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import make_mesh
dryrun.fake_world(1)
ctx = dist.DistContext(mesh=make_mesh((1, 1), ("data", "model"),
                                      device="cpu"),
                       rules=dist.default_rules())
out = {}
for arch, shape, emb in json.loads(sys.argv[1]):
    with FakeTensorMode(allow_non_fake_inputs=True), dist.use(ctx):
        m = dryrun.measure(cells.build_cell(arch, shape, ctx, emb))
    out["/".join((arch, shape, emb))] = {
        k: m[k] for k in ("flops", "bytes_accessed", "collectives")}
print(json.dumps(out))
"""


def k_host_runs() -> dict:
    """Start the host's two processes of (k): the one-rank figures and
    the ``dlrm-rm2`` dry run on both meshes (results to the checkout's
    ``results/dryrun_torch``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    run = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
               env=env, cwd=ROOT)
    return {"figures": subprocess.Popen(
                [sys.executable, "-c", K_FIGURES, json.dumps(K_CELLS)],
                **run),
            "dryrun": subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", "dlrm-rm2", "--mesh", "both", "--force"], **run)}


def k_host_results(procs: dict) -> tuple:
    """(the one-rank figures, the dlrm-rm2 records), each process's exit
    required 0 and every record ok."""
    outs = {}
    for k, p in procs.items():
        out, err = p.communicate(timeout=600)
        require(p.returncode == 0, f"(k) the {k} process exited "
                f"{p.returncode}: {err[-2000:]}")
        outs[k] = out
    figures = json.loads(outs["figures"].strip().splitlines()[-1])
    recs = {}
    for path in sorted((ROOT / "results" / "dryrun_torch").glob(
            "dlrm-rm2__*.json")):
        if "probe" not in path.name:
            recs[path.stem] = json.loads(path.read_text())
    require(len(recs) == 32, f"(k) {len(recs)} dlrm-rm2 records, not 32")
    bad = {k: r.get("error") for k, r in recs.items() if not r.get("ok")}
    require(not bad, f"(k) dlrm-rm2 dry-run records failed: {bad}")
    return figures, recs


def k_inputs(cell, cfg, gen, dev) -> tuple:
    """Real inputs of a cell's ``arg_shapes`` on the card, from ``gen``:
    params from the port's init, zero optimizer state and step, a batch of
    valid ids (each field below its vocabulary) and random dense rows;
    each leaf required to have the fake leaf's shape and dtype."""
    kind = cell.cell_id.split("/")[0]
    if kind == "gatedgcn":
        params = gcn.init_params(cfg, gen, dev)
        shape = GNN_SHAPES["molecule"]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in molecule_batch(
            shape["batch"], shape["n_nodes"], shape["n_edges"],
            seed=SEED).items()}
    else:
        params = init_params(cfg, gen, dev)
        n = cell.arg_shapes[-1]["sparse"].shape[0]
        vocab = torch.tensor(cfg.vocab_sizes, device=dev)
        batch = {"sparse": (torch.rand((n, len(cfg.vocab_sizes)),
                                       generator=gen, device=dev)
                            * vocab).long().clamp_max(vocab - 1).to(
                                torch.int32),
                 "dense": torch.randn((n, cfg.n_dense), generator=gen,
                                      device=dev)}
        if "label" in cell.arg_shapes[-1]:
            batch["label"] = torch.randint(0, 2, (n,), generator=gen,
                                           device=dev, dtype=torch.int32)
    first = cell.arg_shapes[0]
    if "params" in first:                  # a train cell's state
        args = ({"params": params,
                 "opt": tree_map(lambda x: torch.zeros(
                     x.shape, dtype=x.dtype, device=dev), first["opt"]),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)},
                batch)
    else:
        args = (params, batch)
    for a, f in zip(args, cell.arg_shapes):
        for x, y in zip(leaves(a), leaves(f)):
            require(tuple(x.shape) == tuple(y.shape) and x.dtype == y.dtype,
                    f"(k) {cell.cell_id}: an input {tuple(x.shape)} "
                    f"{x.dtype} against the cell's {tuple(y.shape)} "
                    f"{y.dtype}")
    return args


def k_clone(args):
    return tree_map(lambda x: x.clone(), args)


def k_hold(cell_id: str, got, want, memory_tol=None) -> dict:
    """``got`` against ``want`` leaf by leaf with ``torch.equal``; with
    ``memory_tol`` (the train cell) the ROBE array within it: its update
    is a sum of atomics in no fixed order."""
    out = {"equal": True}
    flat_g, flat_w = leaves(got), leaves(want)
    require(len(flat_g) == len(flat_w), f"(k) {cell_id}: the trees differ")
    mem = None if memory_tol is None else \
        got[0]["params"]["embedding"]["memory"]
    for i, (a, b) in enumerate(zip(flat_g, flat_w)):
        if torch.equal(a, b):
            continue
        if a is mem:
            d = max_err(a, b)
            out["memory_max_diff"] = d
            require(d <= memory_tol, f"(k) {cell_id}: the ROBE array's "
                    f"update is {d} from the call without the mesh "
                    f"(tolerance {memory_tol})")
            continue
        out["equal"] = False
        require(False, f"(k) {cell_id}: leaf {i} differs from the call "
                f"without the mesh by {max_err(a, b)}")
    return out


def launch_cells(smi: str) -> dict:
    """Phase (k): the ``K_CELLS`` of ``launch.cells`` on a one-rank NCCL
    mesh, each held to its direct call, with its launches and its time;
    the dry run's counters and the dlrm-rm2 dry run in processes on the
    host beside it."""
    import torch.distributed as tdist
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    procs = k_host_runs()
    out = {"card": smi, "cells": {}}
    ctx = one_rank_mesh(tempfile.mkdtemp())
    try:
        for axes in ("data", "model", ("data", "model")):
            coll.all_reduce_(torch.zeros(1, device=dev), ctx, axes)
        for arch, shape, emb in K_CELLS:
            with dist.use(ctx):
                cell = lcells.build_cell(arch, shape, ctx, emb)
            gnn = arch == "gatedgcn"
            train = "params" in cell.arg_shapes[0]
            if gnn:
                cfg = get_arch(arch).make_config("full", shape=shape)
                opt = lcells.GNN_OPT
                loss = lambda p, b: gcn.loss_fn(p, cfg, b)
            else:
                cfg = lcells.recsys_config(arch, emb)
                opt = lcells.recsys_optimizer(arch)
                loss = lambda p, b: loss_fn(p, cfg, b)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            args = k_inputs(cell, cfg, gen, dev)
            real = dataclasses.replace(cell, arg_shapes=args)
            rank_args = lcells.rank_args(real)
            if train:
                step = build_train_step(loss, make_optimizer(opt),
                                        TrainConfig())
                direct = lambda a=args: (lambda s, m: (s, m["loss"]))(
                    *step(k_clone(a[0]), a[1]))
            else:
                direct = lambda a=args: serve_scores(a[0], cfg, a[1])
            # the GNN's segment sums (index_add_) in their deterministic
            # form, so that two runs of a step can agree bit for bit
            det = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(gnn, warn_only=True)
            try:
                reset_launches()
                got, ms_first = synced_ms(
                    lambda: cell.fn(*k_clone(rank_args)))
                c = launch_counts()
                want = direct()
                rerun = direct() if train and not gnn else None
                # neither call writes into its inputs: time them as they are
                ms = statistics.median(
                    synced_ms(lambda: cell.fn(*rank_args))[1]
                    for _ in range(K_REPS))
            finally:
                torch.use_deterministic_algorithms(det)
            kind = "gnn" if gnn else ("train" if train else "serve")
            expect = K_LAUNCHES[kind]
            require(all(c.get(k, 0) == expect.get(k, 0)
                        for k in set(c) | set(expect)),
                    f"(k) {cell.cell_id}: launches {c}, expected {expect}")
            tol = None
            rec = {"launches": {k: v for k, v in c.items() if v},
                   "ms": ms, "first_ms": ms_first}
            if rerun is not None:
                # the scatter's tolerance on the update, lr · |g|: the
                # card's own rerun of the direct call shows its spread
                upd = (want[0]["params"]["embedding"]["memory"]
                       - args[0]["params"]["embedding"]["memory"]).abs()
                tol = 1e-5 * float(upd.max()) + 1e-7
                rec["memory_rerun_max_diff"] = max_err(
                    rerun[0]["params"]["embedding"]["memory"],
                    want[0]["params"]["embedding"]["memory"])
                rec["memory_tol"] = tol
            rec.update(k_hold(cell.cell_id, got, want, tol))
            out["cells"]["/".join((arch, shape, emb))] = rec
            print(f"(k) {cell.cell_id}: equal to the direct call, "
                  f"launches {rec['launches']}, {ms:.3f} ms", flush=True)
            del args, real, rank_args, got, want, rerun
            torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
    t_host = time.perf_counter()
    figures, recs = k_host_results(procs)
    out["host_wait_s"] = time.perf_counter() - t_host
    for key, f in figures.items():
        rec = out["cells"][key]
        rec.update(flops=f["flops"], bytes_accessed=f["bytes_accessed"],
                   collectives_counted=f["collectives"],
                   roofline_ms=1e3 * max(f["flops"] / roofline.PEAK_FLOPS,
                                         f["bytes_accessed"]
                                         / roofline.HBM_BW))
    print("(k) the dry run's counters on the same one-rank calls: "
          + json.dumps({k: {f: v[f] for f in ("flops", "bytes_accessed",
                                               "roofline_ms", "ms")}
                        for k, v in out["cells"].items()}), flush=True)
    out["dryrun_dlrm_rm2"] = {"records": len(recs),
                              "ok": sum(r["ok"] for r in recs.values()),
                              "wall_s": {k: r["wall_s"]
                                         for k, r in recs.items()}}
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 4: times and bounds
# ---------------------------------------------------------------------------

def device_ms(fn, inputs, inner: int = 8) -> float:
    """Median per-call device time of ``fn(*args)`` over REPS repetitions
    of ``inner`` calls cycling through ``inputs``, queued behind a sleep
    kernel so that the calls run back to back on the card: the sleep
    lasts three times the host's time to queue the ``inner`` calls, plus
    1 ms."""
    fn(*inputs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(inner):
        fn(*inputs[i % len(inputs)])
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(SLEEP_CYCLES_MS * (3 * queue_ms + 1))
    per = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(inner):
            fn(*inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / inner)
    return statistics.median(per)


def synced_ms(fn):
    """(fn()'s result, its host-clock ms with the card drained before and
    after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def host_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` ``synced_ms`` of ``fn`` after one warm call."""
    fn()
    return statistics.median(synced_ms(fn)[1] for _ in range(reps))


def touched_slots(spec, idx, chunk: int = 8192, table_ids=None,
                  dim: int = D) -> torch.Tensor:
    """Mask of the slots of M a lookup of ``idx`` [B, F(, bag)] (default
    table ids 0..F-1, width ``dim``) reads (-1 pads read nothing): what
    this run's data needs from M."""
    seen = torch.zeros(spec.size, dtype=torch.bool, device=idx.device)
    f = idx.shape[1]
    tids = torch.as_tensor(range(f) if table_ids is None else table_ids,
                           device=idx.device).view(
        (1, f) + (1,) * (idx.dim() - 2))
    for s in range(0, idx.shape[0], chunk):
        part = idx[s:s + chunk]
        slots = robe_slots(spec, tids, part.clamp_min(0), dim)
        seen[slots[part >= 0]] = True
    return seen


def n_unique(t: torch.Tensor) -> int:
    return int(torch.unique(t).numel())


def bound(bytes_moved: float, flops: float, rates: tuple) -> tuple:
    t_bytes, t_ops = bytes_moved / rates[0] * 1e3, flops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bulk_inputs(gen, dev, b: int, n: int) -> list:
    """``n`` distinct zipf-skewed id batches [b, F] from the CTR stream."""
    stream = CtrStream(CtrDataConfig(vocab_sizes=CRITEO_TB_VOCABS,
                                     n_dense=13, batch_size=b, seed=SEED))
    return [torch.from_numpy(stream.batch_at(100 + k)["sparse"]).to(dev)
            for k in range(n)]


def time_kernels(gen, memory, spec, subs, rates, dev) -> dict:
    tids = tuple(range(F))
    p = (F + 1) * F // 2
    qp = subs.params("qrobe")["embedding"]
    qspec = subs.recsys_config("qrobe").embedding_spec().robe
    hp = subs.params("hashed")["embedding"]
    q_off, r_off, m = qr_args(subs)
    tp = subs.params("tt")["embedding"]
    cores = (tp["core0"], tp["core1"], tp["core2"])
    offsets, factors = tt_args(subs)
    (d1, d2, d3), rank = factor_dim(D), cores[0].shape[2]
    calls = {   # kernel -> (CUDA call, plain call) on [B, F] rows
        "qrobe_lookup": (
            lambda r: qrobe_lookup_cuda(qp["codes"], qp["scale"], r, tids, D,
                                        qspec, GROUP_LOG2),
            lambda r: qrobe_lookup_ref(qp["codes"], qp["scale"], r, tids, D,
                                       qspec, GROUP_LOG2)),
        "qr_lookup": (
            lambda r: qr_lookup_cuda(hp["q_table"], hp["r_table"], r, q_off,
                                     r_off, m),
            lambda r: qr_lookup_ref(hp["q_table"], hp["r_table"], r, q_off,
                                    r_off, m)),
        "tt_lookup": (
            lambda r: tt_lookup_cuda(*cores, r, offsets, factors, D),
            lambda r: tt_lookup_ref(*cores, r, offsets, factors, D)),
    }
    q_delta = (   # qrobe_lookup with the params' delta term
        lambda r: qrobe_lookup_cuda(qp["codes"], qp["scale"], r, tids, D,
                                    qspec, GROUP_LOG2, qp["delta"]),
        lambda r: qrobe_lookup_ref(qp["codes"], qp["scale"], r, tids, D,
                                   qspec, GROUP_LOG2, qp["delta"]))
    out = {k: {} for k in KERNELS}
    for b, n_in in ((B_P99, 8), (B_BULK, 1)):
        tag = "" if b == B_P99 else "_bulk"
        rows = bulk_inputs(gen, dev, b, n_in)
        feats = [torch.randn((b, F + 1, D), generator=gen, device=dev)
                 for _ in range(n_in)]
        bots = [torch.randn((b, D), generator=gen, device=dev)
                for _ in range(n_in)]
        seen = touched_slots(spec, rows[0])      # qrobe hashes as robe does
        uniq = int(seen.sum())
        groups = n_unique(torch.nonzero(seen).flatten() >> GROUP_LOG2)
        qi, ri = qr_indices(rows[0], q_off, r_off, m)
        i1, i2, i3 = tt_indices(rows[0], offsets, factors)
        out_bytes = b * F * D * 4
        touched = {   # kernel -> (bytes, FLOP) this run's data needs
            "robe_lookup": (b * F * 4 + uniq * 4 + out_bytes, 0),
            "dot_interaction": (b * (F + 1) * D * 4 + b * p * 4,
                                2 * b * p * D),
            "serve_fused": (b * F * 4 + b * D * 4 + uniq * 4 + b * p * 4,
                            2 * b * p * D + b * F * D),
            "qrobe_lookup": (b * F * 4 + uniq + groups * 4 + out_bytes,
                             b * F * D * (2 if qspec.use_sign else 1)),
            "qr_lookup": (b * F * 4 + (n_unique(qi) + n_unique(ri)) * D * 4
                          + out_bytes, b * F * D),
            "tt_lookup": (b * F * 4 + 4 * (n_unique(i1) * d1 * rank
                                           + n_unique(i2) * rank * d2 * rank
                                           + n_unique(i3) * rank * d3)
                          + out_bytes,
                          b * F * 2 * (d1 * d2 * rank * rank
                                       + d1 * d2 * d3 * rank)),
        }
        torch.cuda.synchronize()
        # qrobe_lookup with delta: the same, plus a 4-byte read of delta
        # for each touched slot
        nbytes, flops = touched["qrobe_lookup"]
        touched["qrobe_lookup_delta"] = (nbytes + uniq * 4, flops)
        for k, (nbytes, flops) in touched.items():
            o, sfx = (out["qrobe_lookup"], "_delta" + tag) \
                if k == "qrobe_lookup_delta" else (out[k], tag)
            o["bound_ms" + sfx], o["bound_by" + sfx] = bound(nbytes, flops,
                                                             rates)
            o["library_ms" + sfx] = None
        out["robe_lookup"]["touched_slots" + tag] = uniq

        out["robe_lookup"]["ms" + tag] = device_ms(
            lambda r: robe_lookup_cuda(memory, r, tids, D, spec),
            [(r,) for r in rows])
        out["dot_interaction"]["ms" + tag] = device_ms(
            dot_interaction_cuda, [(x,) for x in feats])
        out["dot_interaction"]["library_ms" + tag] = device_ms(
            lambda x: torch.bmm(x, x.transpose(1, 2)), [(x,) for x in feats])
        out["serve_fused"]["ms" + tag] = device_ms(
            lambda r, bt: serve_fused_cuda(memory, r, bt, tids, D, spec),
            list(zip(rows, bots)))
        for k, (cuda, _) in calls.items():
            out[k]["ms" + tag] = device_ms(cuda, [(r,) for r in rows])
        out["qrobe_lookup"]["ms_delta" + tag] = device_ms(
            q_delta[0], [(r,) for r in rows])

        if b == B_P99:
            out["robe_lookup"]["plain_ms"] = device_ms(
                lambda r: robe_lookup_ref(memory, r, tids, D, spec),
                [(r,) for r in rows])
            out["dot_interaction"]["plain_ms"] = device_ms(
                dot_interaction_ref, [(x,) for x in feats])
            out["serve_fused"]["plain_ms"] = device_ms(
                lambda r, bt: serve_fused_ref(memory, r, bt, tids, D, spec),
                list(zip(rows, bots)))
            for k, (_, plain) in calls.items():
                out[k]["plain_ms"] = device_ms(plain, [(r,) for r in rows])
            out["qrobe_lookup"]["plain_ms_delta"] = device_ms(
                q_delta[1], [(r,) for r in rows])
        del rows, feats, bots, seen, qi, ri, i1, i2, i3
        torch.cuda.empty_cache()
    return out


def time_backwards(gen, spec, rates, dev) -> dict:
    """The two backward kernels at B=512 and at the training batch
    (B=65536, tag "_train"), each beside its bound; the plain versions at
    B=512; ``torch.bmm(sym, feats)`` as ``dot_interaction_bwd``'s library
    yardstick.  Each time is of the wrapper call: for ``robe_lookup_bwd``
    the zeroing of its |M| f32 workspace, the bucketing passes (count,
    scan, place) and the scatter together, each pass's device time at the
    training batch beside it (``passes_ms_train``, ``torch.profiler``)."""
    tids = tuple(range(F))
    n = F + 1
    p = n * (n - 1) // 2
    out = {"robe_lookup_bwd": {}, "dot_interaction_bwd": {}}
    rb, db = out["robe_lookup_bwd"], out["dot_interaction_bwd"]
    for b, n_in in ((B_P99, 8), (B_TRAIN, 2)):
        tag = "" if b == B_P99 else "_train"
        rows = bulk_inputs(gen, dev, b, n_in)
        gs = [torch.randn((b, F, D), generator=gen, device=dev)
              for _ in range(n_in)]
        feats = [torch.randn((b, n, D), generator=gen, device=dev)
                 for _ in range(n_in)]
        gts = [torch.randn((b, p), generator=gen, device=dev)
               for _ in range(n_in)]
        uniq = int(touched_slots(spec, rows[0]).sum())
        # bytes: g and the rows read, the |M| f32 gradient written once
        rb["bound_ms" + tag], rb["bound_by" + tag] = bound(
            b * F * D * 4 + b * F * 4 + spec.size * 4, 0, rates)
        rb["touched_slots" + tag] = uniq
        rb["library_ms" + tag] = None
        # bytes: feats and g read, dfeats written; FLOP 2·B·F²·D
        db["bound_ms" + tag], db["bound_by" + tag] = bound(
            2 * b * n * D * 4 + b * p * 4, 2 * b * n * n * D, rates)
        rb["ms" + tag] = device_ms(
            lambda r, g: robe_lookup_bwd_cuda(g, r, tids, D, spec),
            list(zip(rows, gs)))
        db["ms" + tag] = device_ms(
            lambda g, x: dot_interaction_bwd_cuda(g, x, False),
            list(zip(gts, feats)))
        syms = [interaction_sym(g, n, False) for g in gts]
        db["library_ms" + tag] = device_ms(torch.bmm, list(zip(syms, feats)))
        if b == B_TRAIN:   # device time by pass (the bucketed scatter's)
            rb["passes_ms" + tag] = device_breakdown(
                lambda: robe_lookup_bwd_cuda(gs[0], rows[0], tids, D,
                                             spec))["top_ms"]
        if b == B_P99:
            rb["plain_ms"] = device_ms(
                lambda r, g: robe_lookup_bwd_ref(g, r, tids, D, spec),
                list(zip(rows, gs)))
            db["plain_ms"] = device_ms(
                lambda g, x: dot_interaction_bwd_ref(g, x, False),
                list(zip(gts, feats)))
        del rows, gs, feats, gts, syms
        torch.cuda.empty_cache()
    return out


def time_substrate_backwards(gen, spec, subs, rates, dev) -> dict:
    """The three new backward kernels at B=512 and at the training batch
    (B=65536, tag "_train"), each beside its bound (and its passes at the
    training batch); the plain versions at B=512; and
    serve_fused's composed backward at B=512 beside its plain version.
    Each time is of the wrapper call, the zeroing of its f32 workspaces
    included."""
    tids = tuple(range(F))
    qp = subs.params("qrobe")["embedding"]
    qspec = subs.recsys_config("qrobe").embedding_spec().robe
    hp = subs.params("hashed")["embedding"]
    q_off, r_off, m = qr_args(subs)
    tp = subs.params("tt")["embedding"]
    cores = (tp["core0"], tp["core1"], tp["core2"])
    offsets, factors = tt_args(subs)
    (d1, d2, d3), rank = factor_dim(D), cores[0].shape[2]
    n_q, n_r = hp["q_table"].shape[0], hp["r_table"].shape[0]
    calls = {   # kernel -> (CUDA call, plain call) on ([B, F] ids, g)
        "qrobe_lookup_bwd": (
            lambda r, g: qrobe_lookup_bwd_cuda(g, qp["codes"], r, tids, D,
                                               qspec, GROUP_LOG2),
            lambda r, g: qrobe_lookup_bwd_ref(g, qp["codes"], r, tids, D,
                                              qspec, GROUP_LOG2)),
        "qr_lookup_bwd": (
            lambda r, g: qr_lookup_bwd_cuda(g, hp["q_table"], hp["r_table"],
                                            r, q_off, r_off, m),
            lambda r, g: qr_lookup_bwd_ref(g, hp["q_table"], hp["r_table"],
                                           r, q_off, r_off, m)),
        "tt_lookup_bwd": (
            lambda r, g: tt_lookup_bwd_cuda(g, *cores, r, offsets, factors),
            lambda r, g: tt_lookup_bwd_ref(g, *cores, r, offsets, factors)),
    }
    # multiply-adds an item: t, dc3, dt, dc1, dc2
    tt_macs = 3 * d1 * d2 * rank * rank + 2 * d1 * d2 * d3 * rank
    out = {k: {} for k in (*calls, "serve_fused_bwd")}
    for b, n_in in ((B_P99, 8), (B_TRAIN, 2)):
        tag = "" if b == B_P99 else "_train"
        rows = bulk_inputs(gen, dev, b, n_in)
        gs = [torch.randn((b, F, D), generator=gen, device=dev)
              for _ in range(n_in)]
        g_bytes = b * F * D * 4 + b * F * 4     # g and the ids, read once
        uniq = int(touched_slots(qspec, rows[0]).sum())
        qi, ri = qr_indices(rows[0], q_off, r_off, m)
        i1, i2, i3 = tt_indices(rows[0], offsets, factors)
        touched = {   # kernel -> (bytes, FLOP) this run's data needs
            # the touched codes read; delta's gradient (|M| f32) and the
            # scales' written
            "qrobe_lookup_bwd": (g_bytes + uniq + qspec.size * 4
                                 + qp["scale"].numel() * 4, 2 * b * F * D),
            # the touched rows of Q and R read, both gradients written
            "qr_lookup_bwd": (g_bytes + (n_unique(qi) + n_unique(ri)) * D * 4
                              + (n_q + n_r) * D * 4, 4 * b * F * D),
            # the touched core rows read, the three gradients written
            "tt_lookup_bwd": (g_bytes + 4 * (n_unique(i1) * d1 * rank
                                             + n_unique(i2) * rank * d2 * rank
                                             + n_unique(i3) * rank * d3)
                              + 4 * sum(c.numel() for c in cores),
                              2 * tt_macs * b * F),
        }
        for k, (nbytes, flops) in touched.items():
            out[k]["bound_ms" + tag], out[k]["bound_by" + tag] = bound(
                nbytes, flops, rates)
            out[k]["library_ms" + tag] = None
            out[k]["ms" + tag] = device_ms(calls[k][0], list(zip(rows, gs)))
            if b == B_P99:
                out[k]["plain_ms"] = device_ms(calls[k][1],
                                               list(zip(rows, gs)))
        if b == B_P99:
            serve_bwd_times(out["serve_fused_bwd"], gen, spec, subs, rows,
                            uniq, rates, dev)
        else:
            out["tt_lookup_bwd"]["passes_ms_train"] = device_breakdown(
                lambda: calls["tt_lookup_bwd"][0](rows[0], gs[0]))["top_ms"]
            out["qr_lookup_bwd"]["passes_ms_train"] = device_breakdown(
                lambda: calls["qr_lookup_bwd"][0](rows[0], gs[0]))["top_ms"]
            out["qrobe_lookup_bwd"]["passes_ms_train"] = device_breakdown(
                lambda: calls["qrobe_lookup_bwd"][0](rows[0], gs[0]))[
                    "top_ms"]
        del rows, gs, qi, ri, i1, i2, i3
        torch.cuda.empty_cache()
    return out


def serve_bwd_times(sf: dict, gen, spec, subs, rows, uniq: int, rates,
                    dev) -> None:
    """serve_fused's composed backward (robe_lookup, dot_interaction_bwd
    and robe_lookup_bwd) on ``rows`` beside its plain version, into ``sf``.
    Bytes: g, the ids and bot read, the ``uniq`` touched slots of M read,
    gM (|M| f32) and gbot written; FLOP: the gram transpose's
    2·B·(F+1)²·D."""
    tids = tuple(range(F))
    b = rows[0].shape[0]
    memory = subs_memory(subs)
    p = (F + 1) * F // 2
    cts = [torch.randn((b, p), generator=gen, device=dev) for _ in rows]
    bots = [torch.randn((b, D), generator=gen, device=dev) for _ in rows]
    sf["bound_ms"], sf["bound_by"] = bound(
        b * p * 4 + b * F * 4 + 2 * b * D * 4 + uniq * 4 + spec.size * 4,
        2 * b * (F + 1) ** 2 * D, rates)
    sf["library_ms"] = None
    sf["ms"] = device_ms(
        lambda r, g, bt: serve_fused_bwd_cuda(g, memory, r, bt, tids, D,
                                              spec),
        list(zip(rows, cts, bots)))
    sf["plain_ms"] = device_ms(
        lambda r, g, bt: serve_fused_bwd_ref(g, memory, r, bt, tids, D,
                                             spec),
        list(zip(rows, cts, bots)))


#: kernel name -> class in ``device_breakdown`` (first match)
KERNEL_CLASSES = (("robe", ("robe_", "rb_")),
                  ("gemm", ("gemm", "Gemm", "cutlass", "xmma", "sm90_",
                            "cublas", "Kernel2", "nvjet")),
                  ("softmax", ("softmax", "Softmax")),
                  ("reduce", ("reduce", "Reduce")),
                  ("index", ("index", "scatter", "gather", "Index")),
                  ("copy", ("Memcpy", "Memset", "copy", "Copy", "cat")))


def device_breakdown(fn, calls: int = 3, warm: bool = True) -> dict:
    """Device time per call of ``fn`` by kernel name and by kernel class
    (``KERNEL_CLASSES``, the rest "elementwise/other"; ``torch.profiler``
    of the card's activity), the ROBE kernels' share, and the card's busy
    share of the host-clock window; ``warm`` calls ``fn`` once before.  A
    trace that came back with no device event (a short one sometimes
    does on the card) is taken again, up to PROFILE_TRIES in all; if every
    try is empty, the shares are None and the tables empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        per = {}
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                per[evt.name] = per.get(evt.name, 0.0) + \
                    evt.time_range.elapsed_us()
        if per:
            break
    busy = sum(per.values())
    top = {}
    for name, us in per.items():
        top[name[:60]] = top.get(name[:60], 0.0) + us
    top = sorted(top.items(), key=lambda kv: -kv[1])[:20]
    by = {}
    for name, us in per.items():
        c = next((c for c, keys in KERNEL_CLASSES
                  if any(k in name for k in keys)), "elementwise/other")
        by[c] = by.get(c, 0.0) + us
    return {"wall_ms": wall_us / calls / 1e3,
            "device_ms": busy / calls / 1e3,
            "busy_share": busy / wall_us if busy else None,
            "by_class_ms": {k: v / calls / 1e3 for k, v in sorted(
                by.items(), key=lambda kv: -kv[1])},
            "robe_share": by.get("robe", 0.0) / busy if busy else None,
            "top_ms": {k: v / calls / 1e3 for k, v in top},
            "profile_tries": tries}


def time_train_step(cfg: RecsysConfig, params, batch=None,
                    reps: int = 7) -> dict:
    """One full-width adagrad ``step_fn`` at B=65536 (with qrobe's
    ``project``) on ``batch`` (default: the dlrm stream's first batch):
    host-clock median of ``reps`` (batch on the card, the loss read back
    as ``run`` reads it), and its device breakdown."""
    optimizer = make_optimizer(OptimizerConfig(kind="adagrad", lr=1e-3))
    tc = TrainConfig()
    step_fn = build_train_step(lambda p, b: loss_fn(p, cfg, b), optimizer,
                               tc, project=make_project_fn(cfg))
    if batch is None:
        batch = train_batches(B_TRAIN, 1, "cuda")[0]
    box = {"state": init_state(params, optimizer, tc)}

    def one():
        box["state"], m = step_fn(box["state"], batch)
        float(m["loss"])
    ms = host_ms(one, reps=reps)
    prof = device_breakdown(one)
    return {"step_ms": ms, "batch": int(batch["sparse"].shape[0]),
            "profile": prof}


def time_scores(paths: dict, batches: dict) -> dict:
    """Host-clock ``score`` time per batch of every path ({label: (server,
    backend)}) at each size of ``batches`` ({size: (batch, n_valid)})."""
    out = {}
    for size, (batch, n) in batches.items():
        for label, (server, backend) in paths.items():
            out[f"{label}_{size}"] = host_ms(
                lambda: server.score(backend, batch, n))
    return out


def profile_scores(paths: dict, batch, n: int) -> dict:
    """``device_breakdown`` of ``score`` per path."""
    return {label: device_breakdown(lambda: server.score(backend, batch, n))
            for label, (server, backend) in paths.items()}


def server_config() -> ServerConfig:
    """The full-width ``dlrm-criteo-tb`` server of robe (fused)."""
    return ServerConfig(vocab_sizes=CRITEO_TB_VOCABS, embed_dim=D,
                        n_dense=13, bot_mlp=(512, 256, 128),
                        top_mlp=(1024, 1024, 512, 256, 1), backends=("robe",),
                        robe_compression=1000, robe_block=32,
                        cache_capacity=0, use_kernel=True, seed=SEED)


def substrate_server(cfg: ServerConfig) -> EmbeddingServer:
    """The compressed substrates' server on the card: each backend's own
    full-width init (qrobe quantizes a full |M|-slot array)."""
    return EmbeddingServer(dataclasses.replace(
        cfg, backends=tuple(SUBSTRATES)), device="cuda")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    rates = peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {name}; "
          f"peaks {rates[0] / 1e12} TB/s, {rates[1] / 1e12} TFLOP/s f32")

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build and load: {time.perf_counter() - t0:.2f} s")
    log = (_build.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.strip())

    cfg = server_config()
    spec = cfg.recsys_cfg("robe").embedding_spec().robe
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    memory = init_memory(gen, spec, dev)

    subs = substrate_server(cfg)

    t0 = time.perf_counter()
    err = check_kernels(gen, memory, spec, subs, dev)
    print(f"kernels match their plain versions ({time.perf_counter() - t0:.1f}"
          f" s): max abs err {err}")

    t0 = time.perf_counter()
    with torch.inference_mode():
        fused, unfused, c_fused, c_unfused = main_path(cfg)
        c_subs = substrate_paths(subs)
    print(f"main paths ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    # the served weights, copied out of inference mode for training
    train_cfgs = {"robe": cfg.recsys_cfg("robe"),
                  **{k: subs.recsys_config(k) for k in SUBSTRATES}}
    train_params = {"robe": tree_map(torch.clone, fused.params("robe")),
                    **{k: tree_map(torch.clone, subs.params(k))
                       for k in SUBSTRATES}}
    full = {}
    for kind in train_cfgs:
        quickstart_path(kind)
        full[kind] = full_width_path(train_cfgs[kind], train_params[kind],
                                     kind)
    quickstart_path("full")
    print(f"training paths ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    restart_path(train_cfgs["robe"], train_params["robe"])
    print(f"restart drill ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    paths = {"fused": (fused, "robe"), "unfused": (unfused, "robe"),
             **{kind: (subs, kind) for kind in SUBSTRATES}}
    batches = {size: padded_batches((size,), size)[0]
               for size in (B_P99, B_BULK)}
    with torch.inference_mode():
        times = time_kernels(gen, memory, spec, subs, rates, dev)
        times.update(time_backwards(gen, spec, rates, dev))
        times.update(time_substrate_backwards(gen, spec, subs, rates, dev))
        scores = time_scores(paths, batches)
        prof = profile_scores(paths, *batches[B_BULK])
    train_step = {k: time_train_step(train_cfgs[k], train_params[k])
                  for k in train_cfgs}
    print(f"timing done ({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"profile_score_262144": prof}))
    print(json.dumps({"train_step_65536": train_step}))
    print(json.dumps({"score_ms": scores, "batch": B_P99,
                      "batch_bulk": B_BULK, "card": smi}))

    # then, with the earlier phases' tensors freed (their peak is kept),
    # (g) the rest of the recsys family, and last full against robe at
    # dlrm-rm2 width, with the 52 GB table
    peak = torch.cuda.max_memory_allocated()
    h_robe = train_params["robe"]         # phase (h)'s ZeRO-3 weights
    del fused, unfused, subs, paths, train_params, memory
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    family = recsys_family(rates, dev)
    family["wall_s"] = time.perf_counter() - t0
    family["card"] = smi
    print(f"recsys family ok ({family['wall_s']:.1f} s)")
    t0 = time.perf_counter()
    _, rm2 = full_vs_robe()
    print(f"full against robe ok ({time.perf_counter() - t0:.1f} s); peak "
          f"memory of the earlier phases {peak} B")

    # (f) the serving tier: at dlrm-rm2 width on (e)'s server, then, with
    # the 52 GB table freed, the online drills and the fleet at full width
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tier = rm2_tier(rm2)
    tier["rm2_s"] = time.perf_counter() - t0
    # (h), first part: a one-rank NCCL mesh; full row-sharded on (e)'s
    # table before it is freed
    t_h = time.perf_counter()
    pg_dir = tempfile.mkdtemp()
    mesh = one_rank_mesh(pg_dir)
    mesh_res = {"full": mesh_full_path(mesh, rm2)}
    mesh_res["full_s"] = time.perf_counter() - t_h
    t0 += mesh_res["full_s"]               # the tier's wall leaves (h) out
    del rm2
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tier["online_hashed"] = online_drill(cfg, "hashed",
                                             str(Path(tmp) / "hashed"))
        tier["online_robe"] = online_drill(cfg, "robe",
                                           str(Path(tmp) / "robe"),
                                           cache=False)
        tier["fleet"] = fleet_path(cfg, str(Path(tmp) / "hashed"),
                                   [p["step"] for p in
                                    tier["online_hashed"]["pushes"]])
    tier["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    tier["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"serving_tier": tier, "card": smi}))
    print(f"serving tier ok ({tier['wall_s']:.1f} s); peak memory of the "
          f"phase {tier['max_memory_allocated']} B")

    # (h), the rest: ZeRO-3 robe at full width on the mesh
    t_h = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh_res["robe"] = mesh_robe_path(mesh, cfg, h_robe)
    del h_robe
    mesh_res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    mesh_res["wall_s"] = mesh_res["full_s"] + time.perf_counter() - t_h
    mesh_res["card"] = smi
    import torch.distributed as tdist
    tdist.destroy_process_group()
    print(f"mesh phase ok ({mesh_res['wall_s']:.1f} s)")

    # (i) the LM family and GatedGCN, on a card the earlier phases left
    torch.cuda.empty_cache()
    lmg = lm_gnn(rates, dev, smi)
    print(f"LM family and GatedGCN ok ({lmg['wall_s']:.1f} s): "
          + json.dumps({k: round(v, 1) for k, v in lmg["parts_s"].items()}))
    lm_runs = lmg["lm_full_depth"]["robe"]

    # (j) the LM and GatedGCN on a one-rank NCCL mesh
    torch.cuda.empty_cache()
    lmj = lm_gnn_mesh(smi)
    print(f"LM and GatedGCN on the mesh ok ({lmj['wall_s']:.1f} s): "
          + json.dumps({k: round(v, 1) for k, v in lmj["parts_s"].items()}))
    lmj_launches = lmj["lm_dense"]["launches"]

    # (k) the launch tooling's cells on a one-rank NCCL mesh
    torch.cuda.empty_cache()
    lmk = launch_cells(smi)
    print(f"launch tooling's cells ok ({lmk['wall_s']:.1f} s)")

    launches = {"robe_lookup": c_unfused["robe_lookup"],
                "dot_interaction": c_unfused["dot_interaction"],
                "serve_fused": c_fused["serve_fused"],
                **{k: c_subs[kind][k] for kind, k in SUBSTRATES.items()},
                **{k: full["robe"]["launches"][k]
                   for k in ("robe_lookup_bwd", "dot_interaction_bwd")},
                **{k + "_bwd": full[kind]["launches"][k + "_bwd"]
                   for kind, k in SUBSTRATES.items()}}
    launches_mesh = mesh_res["robe"]["train"]["launches"]
    kernels = []
    for k, meta in KERNELS.items():
        row = {"name": k, "route": "cuda", **meta, "launches": launches[k],
               "max_abs_err": err[k]["float32"],
               "max_abs_err_bf16": err[k]["bfloat16"]}
        if k in TRAIN_KERNELS["robe"]:    # (h)'s ZeRO-3 steps
            row["launches_mesh"] = launches_mesh[k]
        if k in ("robe_lookup", "robe_lookup_bwd"):   # (i)'s LM runs
            row["launches_lm"] = {
                "prefill": lm_runs["prefill"]["launches"].get(k, 0),
                "decode_step": lm_runs["decode"]["launches_per_step"].get(
                    k, 0),
                "train_step": lm_runs["train"]["launches_per_step"].get(
                    k, 0)}
            row["lm"] = lmg["lm_full_depth"]["kernels"][k]
            row["launches_lm_mesh"] = {part: lmj_launches[part].get(k, 0)
                                       for part in lmj_launches}
        if k in TRAIN_KERNELS["robe"]:    # (k)'s cells
            row["launches_cells"] = {
                cell: rec["launches"].get(k, 0)
                for cell, rec in lmk["cells"].items()}
        if "over_a" in err[k]:            # the scatter's error / A
            row["max_err_over_a"] = err[k]["over_a"]["float32"]
            row["max_err_over_a_bf16"] = err[k]["over_a"]["bfloat16"]
        row.update(times[k])
        kernels.append(row)
    sf_bwd = {"max_abs_err": err["serve_fused_bwd"]["float32"],
              "max_abs_err_bf16": err["serve_fused_bwd"]["bfloat16"],
              "max_err_over_a": err["serve_fused_bwd"]["over_a"]["float32"],
              "max_err_over_a_bf16":
                  err["serve_fused_bwd"]["over_a"]["bfloat16"],
              **times["serve_fused_bwd"]}
    print(json.dumps({"serve_fused_bwd": sf_bwd}))
    print(json.dumps({"recsys_family": family}))
    print(json.dumps({"mesh": mesh_res}))
    print(json.dumps({"lm_gnn": lmg}))
    print(json.dumps({"lm_gnn_mesh": lmj}))
    print(json.dumps({"launch_cells": lmk}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
