#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the NVTraverse map, its serving path over
every model family, and its training, on the card.

    python3 chip_smoke.py                 # on the card, at full size
    python3 chip_smoke.py --device cpu    # rehearsal on the host, small

Seventeen phases, each of which fails the run when it fails:

1. ``build``  -- compile the three hand-written kernels from ``src/`` with
   nvcc, all at once, and report each compiled function's registers and
   spills (``ptxas -v``) and tensor-core instructions (``HMMA`` and
   ``HGMMA`` in ``cuobjdump --dump-sass``); ``flash_attention`` and
   ``ssd_scan`` must have some (their bf16 kernels run on ``wgmma`` and
   ``mma.sync``), each wgmma function -- the flash forward
   ``flash_fwd_wg`` and the backward pair ``flash_bwd_dq_wg`` and
   ``flash_bwd_dkdv_wg`` at tile widths 64 and 128, the SSD forward's
   ``ssd_fwd_state_wg`` and ``ssd_fwd_chunk_wg`` and the SSD backward's
   ``ssd_bwd_delta_wg`` and ``ssd_bwd_chunk_wg`` at N <= 64 and <= 128
   -- must have ``HGMMA`` and no spill, and no ``nvt_probe`` function
   may spill;
2. ``map``    -- the main path at card scale: a durable index of 2^22
   keys (2^23-node pool, 2^20 buckets) takes the repo's mixed workload
   (uniform keys in ``[1, 2*prefill)``, updates split between inserts
   and deletes, the rest lookups) at 20% and 50% updates through
   ``update_parallel``/``lookup``, is converted to 2^20 x 32 bucket tiles
   and probed with 2^20 queries through ``nvt_probe``.  Checked against a
   host dict replay (live set, ok flags, flush/fence accounting), the
   kernel against ``probe_ref`` bit for bit and against the chain lookup
   (and, on its element-load path, on the same tiles 4 bytes off a
   16-byte boundary and widened to cap 33), and ``update_parallel``
   against the ``apply`` oracle on a 4096-op batch;
3. ``sharded`` -- the map phase's stream on a ``ShardedDurableMap`` of
   4 shards on the card (the same 2^23-node pool and 2^20 buckets, split
   evenly; all shards on one card, committed one after another), held
   against the map phase: per-op ok, per-bucket flushes, no foreign op,
   every lookup and 2^20 more, flush/fence totals and every node.  Then a
   journaled ``RebalancingShardedMap`` of 2^20 keys beside an uncrashed
   twin takes zipf-skewed rounds of 2^16 ops (half updates) with
   ``AutoRebalancePolicy(threshold=1.3, check_every=2)`` armed and 2^15
   buckets a rebalance round: the policy must trigger, the map crashes
   (``evict="random"``) at the publish of its 5th journaled round, and
   ``recover`` must equal the twin at that boundary, then finish equal to
   it and to a host dict replay, the final load imbalance at most the
   trigger's;
4. ``serve``  -- a ``RequestLog`` whose dedup map lives on the card
   commits and evicts past its seed capacity (so ``migrate_state`` runs
   on the card), snapshots, crashes and reopens: exactly-once must hold.
   The log's spans must bill every flush and fence to its commit or
   snapshot; their times, the restart's phases and the first-call stalls
   of the growth rounds are printed.  The same commits then go through a
   ``RequestLog(shards=4, rebalance=True)``, which must hold exactly-once
   across its growth, snapshot, crash and restart;
5. ``model``  -- the serving path at full width: zamba2-7b (bf16, 81
   layers, random weights from ``--seed``) behind a ``ServeEngine`` serves
   8 requests (4 prompts of 512 tokens, 4 of 500; 16 new tokens, batches
   of 4), crashes after the first batch and is served again by a new
   engine on the same log: exactly-once must hold, and every prefill must
   launch ``flash_attention`` 13 times and ``ssd_scan`` 81 times, every
   launch on the wgmma route (``kernel.py:fwd_route``: ``flash_fwd_wg``,
   the three SSD passes), counted by route (``check_routes``; the same in
   the families and train phases).  Its
   prefill and decode-step times, tokens/s and peak memory are printed,
   and one profiled prefill and decode step: device time, busy share,
   the top kernels and the share of each of the port's own kernels.
   Then the same for qwen2-7b (dense, bf16, 28 layers, d_model 3584,
   random weights from ``--seed``), once zamba2 is freed: every prefill
   must launch ``flash_attention`` 28 times (GQA 28:4, d = 128) and no
   ``ssd_scan``;
6. ``families`` -- the other families served the same way, one model on
   the card at a time, bf16, random weights from ``--seed``, each
   through a crash and a new engine (exactly-once, the dedup hits, the
   launches a prefill): qwen2-moe-a2.7b (moe, 60 routed top-4 experts and
   4 shared; 24 ``flash_attention`` launches a prefill), mamba2-370m
   (ssm, N = 128; 48 ``ssd_scan``), whisper-medium (encdec: frames from
   the engine's stub, 24 non-causal launches over 1500 frames, 24 cross
   launches and 24 causal ones at d = 64, each counted at its shape),
   internvl2-26b (vlm: a 256-token vision prefix, GQA 48:8; 48) at full
   width and depth, arctic-480b (moe, 128 experts top-2 and a dense
   residual, GQA 56:8; 1) at full width cut to one layer
   (``DEPTH_CUTS``), and the two largest dense archs at full width and
   depth: qwen1.5-32b (35.2 B parameters, MHA 40:40, QKV bias; 64) and
   gemma3-27b (28.4 B, GQA 32:16, qk-norm; 62 a prefill, counted by
   shape: 52 local layers with their window of 1024, 10 global ones);
   the same numbers as the model phase for each, the init's peak memory
   among them;
7. ``train``  -- qwen3-1.7b at full width and depth (bf16, 2.03 B
   parameters, AdamW with f32 moments, ``remat="block"``) trained 3
   steps through ``make_train_step`` on ``TokenPipeline`` batches of
   train_4k's 4096 tokens, global batch 4 in the config's 2
   microbatches, under deterministic algorithms: every step must launch
   ``flash_attention`` 2 x 28 x 2 times (each layer's forward and its
   remat recompute, a microbatch) and its backward kernels 28 x 2 times,
   the loss must be finite and every layer's wq/wk/wv/q_norm/k_norm
   gradient nonzero; a second run from the same seed must give the same
   losses bit for bit.  Then, one model on the card at a time, the same
   for mamba2-370m at full width and depth (0.37 B, 2 microbatches of
   [2, 4096]: ``ssd_scan`` 2 x 48 x 2 launches a step and its backward
   48 x 2) and zamba2-7b at full width cut to 24 layers
   (``TRAIN_DEPTH_CUTS``; 2.31 B, 4 microbatches of [1, 4096]:
   ``ssd_scan`` 2 x 24 x 4 and 24 x 4, its shared block's
   ``flash_attention`` 2 x 4 x 4 and 4 x 4), every launch at the
   training shape and every layer's A_log and dt_bias gradient nonzero
   (only the SSD backward feeds them); and qwen2-moe-a2.7b at full width
   cut to 4 layers (2.90 B, 4 microbatches of [1, 4096]: flash 2 x 4 x 4
   and 4 x 4 at MHA 16:16), every layer's wq/wk/wv and QKV-bias gradient
   and its router and expert tensors' nonzero (the dispatch's backward
   alone feeds the experts).  Step seconds, tokens/s, peak memory and one
   profiled step (the SSD backward's share; the MoE dispatch's and
   combine's) are printed.  Then ``run_training``'s crash/resume recipe
   on the tiny form of each, in f32 and in bf16: 30 steps with a
   checkpoint every 10, a crash before step 20's manifest publish, a
   restart that resumes from step 10 and repeats the uninterrupted run's
   losses bit for bit (``reduced``: ``train_reduced``); the same recipe on
   tiny arctic-480b (bf16 AdamW moments), and three AdamW steps of its
   tiny form in 2 microbatches on the card held against the CPU: the
   bf16 accumulator bit for bit, the bf16 moments within one bf16 ulp;
8. ``load``   -- ``obs/loadgen.py``'s ``LoadHarness`` (the points of
   ``benchmarks/loadtest.py``) against a ``RequestLog`` whose dedup map
   lives, and grows, on the card: batches of 1024 rids, a 2^16 retain
   window, a truncating snapshot every 20 commits; closed loop at zipf
   1.1 and 1.5 and uniform, open loop (zipf 1.3) at half the rate
   closed_zipf1.1 sustained, a torn crash mid-run with its flight dump,
   a log of 4 rebalancing shards, and the engine point over qwen2-7b at
   full width.  Each point must keep its schedule's fingerprint, count
   every op once in its windows, give ``0 < p50 <= p99``, and answer
   ``took_effect`` for every acked rid of its retain window after a
   reopen; the crash must lose no acked rid and dump the ring with spans
   and persistence events; the engine point must launch
   ``flash_attention`` 28 times an update (warm-up included) and never on
   its reads, which are dedup hits.  p50/p99, sustained rids/s,
   excursions and their attribution, counters and growth events are
   printed;
9. ``checkpoint`` -- zamba2-7b at full width (bf16, random weights from
   ``--seed``) cut to 12 layers, its parameters saved by a
   ``CheckpointManager`` as 4 steps, each changing one leaf (steps 2-4
   are delta saves), ``gc(keep=2)`` after step 3 and a crash
   (``evict="random"``) at step 4's manifest publish: ``recover`` must
   land on step 3, ``restore`` onto the card must give step 3's tensors
   bit for bit, and a 4 x 512 prefill with them (through
   ``flash_attention`` and ``ssd_scan``) the in-memory step-3 model's
   logits; the Izraelevitz policy runs the same sequence for its fences;
10. ``checks`` -- each new kernel against its plain versions at the serve
   shapes and on the reference's sweep, and prefill (kernels) against
   prefill + one decode step (plain recurrent and attention steps) in f32
   at full width and depth 12, for zamba2-7b and qwen2-7b (whose bf16
   attention shapes, B=4, H=28, K=4, d=128 in the model phase and the
   load phase's engine point's, B=2, S=6, are checked beside zamba2's),
   and for qwen2-moe-a2.7b (its capacity factor raised so that no token
   is dropped), mamba2-370m, whisper-medium and internvl2-26b; the
   families' attention shapes in bf16 (whisper's non-causal encoder over
   1500 frames, its cross shape, Sq = 512 and 500 over Sk = 1500, and its
   decoder's at d = 64; internvl2's GQA 6:1 over 768; qwen2-moe's;
   arctic's GQA 7:1) and mamba2-370m's scan (N = 128) in bf16 and f32;
   the flash backward kernels through autograd against the plain
   backward and against autograd through the plain forward, each
   gradient within 2e-2 (bf16) or 1e-5 (f32) of its max magnitude, two
   calls repeating their bits, and the forward's lse against the plain
   log-sum-exp, at qwen3-1.7b's training shape, zamba2's d = 112,
   whisper's cross shape, a gemma3-27b local layer (window 1024), rows
   with no visible key, d = 96 (the wgmma pair's 128-column tile) and d
   = 100 (not a multiple of 8: the mma.sync pair), each with the
   backward route it took (``kernel.bwd_route``: wgmma, mma.sync or
   scalar), zamba2-7b's training shape among them; the SSD backward
   kernels through autograd on strided xBC slices against the plain
   backward and against autograd
   through the plain chunked scan in f32, each gradient (ddt and dA on
   their own) within 5e-2 (bf16) or 1e-4 (f32) of its max magnitude, two
   calls repeating their bits, at mamba2-370m's and zamba2-7b's training
   shapes and a ragged S with an init_state and a cotangent on the final
   state; and the loss and every gradient in f32 at full width, [1, 512],
   with the kernels against the plain attention and plain scan (1e-4 of
   each leaf's max), for qwen3-1.7b, mamba2-370m and qwen2-moe-a2.7b (no
   token dropped) at 2 layers and zamba2-7b at 6 (one shared-block call);
   ``make_compressed_psum_grads`` over 4 replicas of a 2^26-element leaf,
   the card's bits the CPU's, its NCCL form at world size 1 (a
   ``FileStore``) equal to the replica form, and the 50-step error
   feedback sum; and the GPipe schedule (4 stages of 2 blocks, d_model
   2048, d_ff 8192, 8 microbatches of [2, 512], f32) against the
   sequential stack at 1e-5 of its max; qwen1.5-32b's and gemma3-27b's
   bf16 attention shapes (gemma3's local ones with their window) and
   f32 consistency at depth 12; qwen2-moe-a2.7b's training shape in the
   backward checks;
11. ``ordered`` -- the map phase's stream on the ordered map at the same
   scale (2^22 keys in a 2^23-node pool) through
   ``update_parallel_ordered``, the towers rebuilt after every batch,
   then 1024 zipf-placed ``range_query`` spans (``max_items`` 1024, one
   batch), a ``scan`` and a ``top_k`` of 128.  Checked against
   ``oracle_apply`` (ok flags, lookups, every node), the accounting law,
   the sorted live keys (and ``oracle_range``), ``check_sorted``, and
   ``update_parallel_ordered`` against ``apply_ordered`` on 4096 ops.
   Then a ``DurableOrderedMap`` of 2^20 keys in a 2^21-node pool (cut
   from 2^22: its snapshot is JSON) journals a prefill and 8 mixed
   batches of 2^16 ops, snapshots after the 4th, crashes at the publish
   of the 7th (``evict="random"``) and recovers: exactly the acked
   batches, arrays and towers equal to an uncrashed twin;
12. ``migrate`` -- a journaled ``MigratingMap`` of 3 * 2^20 keys in a
   2^22-node pool with 2^19 buckets takes a batch of 2^20 fresh keys that
   does not fit, grows to 2^23 nodes and 2^20 buckets in drain rounds of
   2^15 buckets between mixed rounds of 2^16 ops, and crashes
   (``evict="random"``) at the publish of its 9th journaled round;
   ``recover`` must equal an uncrashed twin at that boundary and finish
   equal to it and to a host dict replay;
13. ``crash`` -- ``sweep`` of each crash scenario (``log``, ``log2``,
   ``checkpoint``, ``migrate``, ``rebalance`` at 1 and at 4 shards,
   ``ordered``) at every site under the ``none``, ``random`` and ``torn``
   adversaries, with the site counts the CPU tests pin; any failure fails
   the run;
14. ``paper`` -- the paper's transformation itself, on the host's
   instruction-level machine (``PMem`` is numpy by design: it runs one
   word at a time), bridged to the card's engines.  The count sweep of
   ``benchmarks/paper_figures.py:run_workload`` (the list at 256 and
   4096 keys, 150 ops; hash, bst and skiplist at 512, 100 ops; 20%
   updates) under the volatile, Izraelevitz and NVTraverse policies, with
   ``tests/test_paper_claims.py``'s bounds (NVTraverse: no traverse
   flush or fence, under 4 fences an op on the list; Izraelevitz at 4096:
   more than 0.8 x 4096 x 0.9); every structure interleaved under
   NVTraverse and Izraelevitz, crashed at each quarter of its steps under
   the ``none``, ``random`` and ``all`` adversaries, recovered and
   durably linearizable (the volatile list's history must be rejected);
   each crash scenario traced on the card with its pinned event count
   and no finding of the trace checker; 2^12 keys through the
   instruction-level ``HashTable`` (3 fences an op) and the card map's
   ``update_parallel`` (2), the card map's tiles probed by ``nvt_probe``
   against the ``HashTable``; 8 rounds of 2^14 concurrent ops through
   ``update_parallel`` judged by ``check_linearizable``; a
   ``DurableOrderedMap`` on the card crashed at each of 4 batches of
   2^12 ops, every recovered prefix durably linearizable; and
   ``SkipList.rebuild_index`` over 2^12 keys against ``build_towers``;
15. ``examples`` -- the port's five examples and three tools, in this
   process, on the card: ``torch_quickstart.py`` and
   ``torch_nvtraverse_demo.py`` (host numpy), ``torch_rebalance_live.py``
   (its four shards on the card; the live keys must equal a dict),
   ``torch_serve_batch.py`` (exactly once through a crash, its prefills
   through ``flash_attention``), ``torch_train_tiny_lm.py --steps 100``
   (the ~100M qwen3-family config, a checkpoint every 25, resumed after a
   crash with a drift under 1e-5, and learning; forward and backward
   through the kernels),
   ``torch_crash_sweep.py --layers log,migrate --budget 6 --evict
   none,torn`` (no failure) and ``torch_persist_lint.py --static
   --trace`` (its scenarios on the card: the report and exit code of the
   same command on the host); each one's seconds and the
   ``flash_attention`` launches by shape;
16. ``timing`` -- each kernel's time (CUDA events), its plain version's,
   one PyTorch library call's where one computes the same function, and
   its bound from the bytes it must move and the operations it must do;
   where the forward's route is wgmma, the mma.sync kernel it replaced
   (``flash_fwd_tc``, ``ssd_scan_tc``) timed and checked beside it on the
   same tensors (``tc_ms``);
   ``nvt_probe`` also with L2 flushed before each launch, and in turns
   with the earlier one-warp-a-query kernel where a copy of its source
   lies at ``build/chip_scripts/nvt_probe_warp_a_query.cu``;
   ``flash_attention`` once a main-path shape, each entry with the
   launches made at its shape: zamba2-7b's and qwen2-7b's serve shapes,
   the engine point's and the families' nine (SDPA with the same mask, and
   ``enable_gqa`` where K < H); at qwen3-1.7b's training shape the
   forward and each backward kernel (``flash_bwd_dq``, ``flash_bwd_dkdv``,
   beside SDPA's backward), and the same at zamba2-7b's (the wgmma pair
   at d = 112, on 128-column tiles) and qwen2-moe-a2.7b's (MHA 16:16);
   qwen1.5-32b's and gemma3-27b's serve shapes (gemma3's global and
   windowed local ones); ``ssd_scan`` at zamba2-7b's and
   mamba2-370m's serve shapes, each also timed in f32, and at their
   training shapes the
   forward (writing the chunk states) and the backward
   (``ssd_scan_bwd``: no library call); every bound is the kernel's own
   ``work`` formula (``kernels/*/ops.py``, the dry-run's count) at the
   card's rates;
   ``flash_attention`` in f32 (the scalar kernel) at the examples'
   shapes (``path: "examples"``);
17. ``dryrun`` -- the port's cells (``repro_torch.launch.cells``) on the
   meta device, traced in ``DRYRUN_WORKERS`` processes once the card's
   phases are over, so that no host-clock reading shares the host: (a)
   every cell the card ran in this run (each served arch's 4 x 512
   prefill and decode step, the train phase's four training steps) with
   its predicted argument, temp and total bytes beside the peak the phase
   measured, which must be predicted to fit 80 GB; (b) the depth cuts the
   card needs (zamba2-7b trained at 81 layers, qwen2-moe-a2.7b trained at
   24, arctic-480b served at 35), which must be predicted not to; (c)
   qwen3-1.7b's parameter and AdamW tensors' bytes equal to the train
   phase's, and the rise of ``torch.cuda.memory_allocated`` across their
   init within the caching allocator's bounds for them; (d) the
   roofline's compute term of qwen3-1.7b's train step beside the
   profiled step's device time.

The last lines are the ``kernels`` JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Without a card (and without
``--device cpu``, which rehearses every phase but timing on small shapes
and on the tiny form of every arch) it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis import check_events, trace_scenario  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_arch, tiny  # noqa: E402
from repro_torch.core import batched as B  # noqa: E402
from repro_torch.core import ordered as O  # noqa: E402
from repro_torch.core.migrate import (MigratingMap,  # noqa: E402
                                      live_chain_nodes)
from repro_torch.core.rebalance import (  # noqa: E402
    AutoRebalancePolicy, RebalancingShardedMap)
from repro_torch.core.sharded import ShardedDurableMap  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    kernel as da_kernel)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, decode_attention_plain, work as decode_work)
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_lse_plain, flash_attention_plain, visible_pairs)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    work as flash_work)
from repro_torch.kernels.nvt_probe import kernel as probe_kernel  # noqa: E402
from repro_torch.kernels.nvt_probe.ops import nvt_probe  # noqa: E402
from repro_torch.kernels.nvt_probe.ref import (  # noqa: E402
    mix32, probe_ref, tiles_from_hashmap)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import (ssd_scan,  # noqa: E402
                                              ssd_scan_bwd)
from repro_torch.kernels.ssd_scan.ops import work as ssd_work  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked, ssd_ref, ssd_scan_bwd_plain)
from repro_torch.launch.cells import leaves as cell_leaves  # noqa: E402
from repro_torch.launch.cells import lower_cell, make_cell  # noqa: E402
from repro_torch.launch.mesh import (HBM_BYTES, PEAK_FLOPS_BF16,  # noqa
                                     make_card_mesh)
from repro_torch.launch.train import (CUBLAS_WORKSPACE,  # noqa: E402
                                      deterministic, run_training)
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import mamba2 as model_mamba2  # noqa: E402
from repro_torch.models import transformer as model_transformer  # noqa
from repro_torch.models.frontends import (  # noqa: E402
    synth_audio_frames, synth_vision_patches)
from repro_torch.models.model import (Model, padded_vocab,  # noqa: E402
                                      prefix_tokens)
from repro_torch.obs.compile import get_tracker  # noqa: E402
from repro_torch.obs.loadgen import (LoadHarness, LoadSpec,  # noqa: E402
                                     make_schedule)
from repro_torch.obs.metrics import MetricsRegistry, get_registry  # noqa
from repro_torch.persistence.checkpoint import (  # noqa: E402
    CheckpointManager)
from repro_torch.robustness.faultinject import (  # noqa: E402
    SCENARIOS, CrashPlan, CrashPoint, sweep)
from repro_torch.serving.engine import (RequestLog,  # noqa: E402
                                        ServeEngine, stub_inputs)
from repro_torch.training.optimizer import (Optimizer,  # noqa: E402
                                            make_optimizer)
from repro_torch.training.pipeline import (  # noqa: E402
    gpipe_ticks, init_pipeline_params, make_gpipe_fn, sequential_forward)
from repro_torch.training.train_loop import (  # noqa: E402
    make_compressed_psum_grads, make_train_step)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
KERNELS = (probe_kernel, fa_kernel, ssd_kernel, da_kernel)
WRAPPERS = (nvt_probe, flash_attention, flash_attention_bwd, ssd_scan,
            ssd_scan_bwd, decode_attention)
# the wrappers a training step may launch through
TRAIN_WRAPPERS = (flash_attention, flash_attention_bwd, ssd_scan,
                  ssd_scan_bwd)
TENSOR_CORE_SOURCES = ("flash_attention", "ssd_scan")
# the earlier one-warp-a-query nvt_probe, timed beside the kernel
WARP_A_QUERY_PROBE = Path(__file__).resolve().parent / "build" / \
    "chip_scripts" / "nvt_probe_warp_a_query.cu"
L2_FLUSH_BYTES = 128 << 20       # written between cold-L2 launches


@dataclasses.dataclass(frozen=True)
class Sizes:
    capacity: int = 2**23        # node pool
    n_buckets: int = 2**20
    prefill: int = 2**22
    round_ops: int = 2**20       # ops per mixed round
    ratios: tuple = (20, 50)     # update percentage of each round
    queries: int = 2**20         # nvt_probe queries
    cap: int = 32                # tile row width
    check_ops: int = 4096        # update_parallel vs apply batch
    serve_capacity: int = 1 << 15
    serve_batches: int = 40
    serve_batch: int = 1024
    serve_retain: int = 8192
    # model phase: zamba2-7b served through a crash and a restart
    model_tiny: bool = False     # tiny(zamba2-7b) instead of the full arch
    prompt_lens: tuple = (512, 500)   # rids 0-3, rids 4-7
    new_tokens: int = 16
    model_batch: int = 4
    # checks phase: serve shapes of the kernels, and the depth of the f32
    # prefill/decode consistency model
    check_lens: tuple = (512, 500)
    consistency_layers: int = 12
    # ordered phase: the map phase's stream on the ordered map, then reads
    ranges: int = 1024           # range_query bounds, one batch
    max_items: int = 1024
    top_k: int = 128
    # ... and the journaled DurableOrderedMap (cut: its JSON snapshot)
    dur_capacity: int = 2**21
    dur_keys: int = 2**20
    dur_batches: int = 8         # mixed batches after the prefill batch
    dur_batch: int = 2**16
    # migrate phase: a journaled MigratingMap grows through a crash
    mig_capacity: int = 2**22
    mig_buckets: int = 2**19
    mig_prefill: int = 3 * 2**20
    mig_fresh: int = 2**20       # the batch that does not fit
    mig_bpr: int = 2**15         # old buckets a drain round
    mig_round_ops: int = 2**16   # mixed user rounds, 50% updates
    mig_crash_round: int = 8     # the 9th journaled round's publish
    # sharded phase: the map phase's stream over 4 shards, then a
    # journaled live-rebalancing map under zipf-skewed rounds
    shards: int = 4
    reb_prefill: int = 2**20     # cut: the re-split must fit one shard
    reb_round_ops: int = 2**16   # mixed rounds, 50% updates
    reb_rounds: int = 24         # skewed rounds with the policy armed
    reb_post: int = 4            # rounds on the final split, disarmed
    reb_bpr: int = 2**15         # buckets a rebalance round
    reb_crash_round: int = 4     # the 5th journaled round's publish
    # checkpoint phase: zamba2-7b at full width, cut in depth
    ckpt_layers: int = 12
    # paper phase: run_workload's sweep (tests/test_paper_claims.py's
    # sizes), then the bridges from the instruction level to the card
    paper_list_sizes: tuple = (256, 4096)
    paper_list_ops: int = 150
    paper_size: int = 512        # hash, bst and skiplist
    paper_ops: int = 100
    bridge_keys: int = 2**12     # the fence bridge and the towers
    bridge_buckets: int = 2**10
    hist_rounds: int = 8         # the card map's concurrent history
    hist_ops: int = 2**14
    hist_key_hi: int = 2**15
    prefix_batches: int = 4      # DurableOrderedMap crash prefixes
    prefix_ops: int = 2**12
    # load phase: LoadHarness points against a card-resident RequestLog
    # (benchmarks/loadtest.py's points at the serve phase's scale, raised
    # to a 2^16 retain window; n_ops 400 / 300 cut to 200 / 150)
    load_ops: int = 200          # closed-loop points
    load_open_ops: int = 150     # the open-loop and sharded points
    load_batch: int = 1024
    load_retain: int = 2**16
    load_capacity: int = 2**15
    # train phase: qwen3-1.7b at full width and depth, steps of the
    # train_4k sequence length at global batch 4 in the config's 2
    # microbatches; the f32 check of its gradients at 2 layers, [1, 512]
    train_seq: int = 4096
    train_batch: int = 4
    train_steps: int = 3
    train_check_layers: int = 2
    train_check_seq: int = 512
    # checks phase: the compressed gradient reduce over 4 replicas of a
    # 2^26-element leaf, and the GPipe demo stack (4 stages of 2 blocks at
    # d_model 2048, d_ff 8192; 8 microbatches of [2, 512], f32)
    reduce_replicas: int = 4
    reduce_elems: int = 2**26
    gpipe_stages: int = 4
    gpipe_layers: int = 2
    gpipe_d: int = 2048
    gpipe_ff: int = 8192
    gpipe_micro: int = 8
    gpipe_batch: int = 2
    gpipe_seq: int = 512


FULL = Sizes()
SMALL = Sizes(capacity=2**12, n_buckets=2**8, prefill=2**10,
              round_ops=2**9, queries=2**9, check_ops=256,
              serve_capacity=64, serve_batches=6, serve_batch=32,
              serve_retain=64, model_tiny=True, prompt_lens=(24, 20),
              new_tokens=4, check_lens=(40, 37), consistency_layers=7,
              ranges=64, max_items=64, top_k=16, dur_capacity=2**11,
              dur_keys=2**10, dur_batch=2**6, mig_capacity=2**12,
              mig_buckets=2**9, mig_prefill=3 * 2**10, mig_fresh=2**10,
              mig_bpr=2**5, mig_round_ops=2**6, reb_prefill=2**9,
              reb_round_ops=2**8, reb_bpr=2**3, ckpt_layers=7,
              paper_list_sizes=(64, 256), paper_list_ops=60,
              paper_size=128, paper_ops=60, bridge_keys=2**8,
              bridge_buckets=2**5, hist_ops=2**8, hist_key_hi=2**9,
              prefix_ops=2**6, load_ops=24, load_open_ops=18,
              load_batch=16, load_retain=256, load_capacity=64,
              train_seq=32, train_steps=2, train_check_seq=24,
              reduce_elems=2**10, gpipe_d=16, gpipe_ff=32, gpipe_seq=8)
# crash sites of each ported scenario (tests/test_torch_faultinject.py
# pins the same counts against the JAX scenarios)
CRASH_SITES = {"log": 29, "log2": 31, "checkpoint": 19, "migrate": 25,
               "rebalance": 22, "rebalance4": 22, "ordered": 25}
# each sweep of the crash phase: its scenario and its own arguments
CRASH_SWEEPS = {**{name: (name, {}) for name in SCENARIOS},
                "rebalance4": ("rebalance", {"n_shards": 4})}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_stream(sz: Sizes, seed: int = 1) -> dict:
    """The map phase's whole input, from one seed, as numpy int32."""
    rng = np.random.default_rng(seed)
    pre = np.arange(1, sz.prefill + 1, dtype=np.int32)
    rounds = []
    for ratio in sz.ratios:
        n_upd = sz.round_ops * ratio // 100
        ops = rng.integers(0, 2, size=n_upd).astype(np.int32)
        ks = rng.integers(1, 2 * sz.prefill, size=n_upd).astype(np.int32)
        look = rng.integers(1, 2 * sz.prefill,
                            size=sz.round_ops - n_upd).astype(np.int32)
        rounds.append((ops, ks, ks * 3, look))
    queries = rng.integers(1, 2 * sz.prefill, size=sz.queries).astype(
        np.int32)
    queries[:2] = (0, -1)        # the empty-slot and padding keys
    check = (rng.integers(0, 2, size=sz.check_ops).astype(np.int32),
             rng.integers(1, sz.check_ops // 2,
                          size=sz.check_ops).astype(np.int32),
             rng.integers(0, 1 << 20, size=sz.check_ops).astype(np.int32))
    return {"prefill": pre, "rounds": rounds, "queries": queries,
            "check": check}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def same_arrays(a, b, what: str) -> None:
    """Raise unless two states (or tower indexes) hold equal tensors."""
    for f in a._fields:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: field {f} differs")


def _timer(dev):
    """``stage(name, fn)``: run ``fn`` with the device synced at both
    ends, keep its host-clock seconds in the returned dict."""
    times = {}

    def stage(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        r = fn()
        _sync(dev)
        times[name] = time.perf_counter() - t0
        return r
    return stage, times


def run_map(sz: Sizes, stream: dict, device) -> dict:
    """The main path, timed per stage on the host clock (each stage ends
    in a device sync).  Returns every result the checks read."""
    dev = B.resolve_device(device)
    stage, times = _timer(dev)
    out = {"ok": [], "lookups": []}
    st = stage("make_state", lambda: B.make_state(sz.capacity, sz.n_buckets,
                                                  dev))
    pre = torch.as_tensor(stream["prefill"], device=dev)
    st, ok, stats = stage("prefill", lambda: B.update_parallel(
        st, torch.zeros_like(pre), pre, pre, sz.n_buckets))
    out["prefill_ok"] = ok
    out["bucket_flushes"] = [stats.bucket_flushes]
    for ratio, (ops, ks, vs, look) in zip(sz.ratios, stream["rounds"]):
        st, ok, stats = stage(f"update_{ratio}", lambda: B.update_parallel(
            st, torch.as_tensor(ops, device=dev),
            torch.as_tensor(ks, device=dev),
            torch.as_tensor(vs, device=dev), sz.n_buckets))
        out["ok"].append(ok)
        out["bucket_flushes"].append(stats.bucket_flushes)
        out["lookups"].append(stage(f"lookup_{ratio}", lambda: B.lookup(
            st, torch.as_tensor(look, device=dev), sz.n_buckets)))
    out["state"] = st
    out["tiles"] = stage("tiles", lambda: tiles_from_hashmap(
        st, sz.n_buckets, sz.cap))
    q = torch.as_tensor(stream["queries"], device=dev)
    out["probe"] = stage("probe", lambda: nvt_probe(*out["tiles"], q))
    out["times"] = times
    return out


def replay(sz: Sizes, stream: dict) -> dict:
    """Host dict replay of the map phase's op stream (independent of the
    engine): per-op ok flags, flush/fence totals, the lookups and the
    final live key -> value set."""
    node = {}                    # key -> [live, val] for keys with a node
    flushes = fences = 0

    def run(ops, ks, vs):
        nonlocal flushes, fences
        ok = np.zeros(len(ks), np.bool_)
        for i, (op, k, v) in enumerate(zip(ops.tolist(), ks.tolist(),
                                           vs.tolist())):
            cell = node.get(k)
            if op == B.OP_INSERT:
                if cell is None:
                    node[k] = [True, v]
                    flushes += 2
                elif not cell[0]:
                    cell[0], cell[1] = True, v
                    flushes += 1
                else:
                    continue
            elif cell is not None and cell[0]:
                cell[0] = False
                flushes += 1
            else:
                continue
            fences += 2
            ok[i] = True
        return ok

    pre = stream["prefill"]
    res = {"prefill_ok": run(np.zeros_like(pre), pre, pre), "ok": [],
           "lookups": []}
    for ops, ks, vs, look in stream["rounds"]:
        res["ok"].append(run(ops, ks, vs))
        cells = [node.get(k) for k in look.tolist()]
        found = np.array([c is not None and c[0] for c in cells], np.bool_)
        vals = np.array([c[1] if c is not None and c[0] else 0
                         for c in cells], np.int32)
        res["lookups"].append((found, vals))
    res["live"] = {k: c[1] for k, c in node.items() if c[0]}
    res["flushes"], res["fences"] = flushes, fences
    return res


def check_map(sz: Sizes, stream: dict, out: dict) -> dict:
    """Every check of the map phase; raises on the first failure."""
    want = replay(sz, stream)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    if not np.array_equal(host(out["prefill_ok"]), want["prefill_ok"]):
        raise AssertionError("prefill ok flags differ from the replay")
    for i, ratio in enumerate(sz.ratios):
        if not np.array_equal(host(out["ok"][i]), want["ok"][i]):
            raise AssertionError(f"round {ratio}%: ok flags differ")
        for got, exp in zip(out["lookups"][i], want["lookups"][i]):
            if not np.array_equal(host(got), exp):
                raise AssertionError(f"round {ratio}%: lookups differ")
    st = B.state_to_numpy(out["state"])
    if (int(st["flushes"]), int(st["fences"])) != (want["flushes"],
                                                   want["fences"]):
        raise AssertionError("flush/fence accounting differs")
    c = int(st["cursor"])
    live = st["live"][1:c]
    got = dict(zip(st["key"][1:c][live].tolist(),
                   st["val"][1:c][live].tolist()))
    if got != want["live"] or int(live.sum()) != len(want["live"]):
        raise AssertionError("final live set differs from the replay")

    # the kernel: bit for bit against its plain version on the same inputs
    kt, vt = out["tiles"]
    q = torch.as_tensor(stream["queries"], device=kt.device)
    found, vals = out["probe"]
    err = probe_err(out["probe"], probe_ref(kt, vt, q))
    if err:
        raise AssertionError(f"nvt_probe differs from probe_ref by {err}")
    # ... and consistent with the chain walk (query 0 "finds" any bucket
    # with an empty slot in the tile layout, by design)
    cf, cv = B.lookup(out["state"], q, sz.n_buckets)
    real = q != 0
    f = found.bool()
    if not (torch.equal(f[real], cf[real]) and torch.equal(
            (vals * f)[real], (cv * cf)[real])):
        raise AssertionError("nvt_probe disagrees with the chain lookup")
    element_loads = check_probe_element_loads(kt, vt, q)

    # the plan/commit engine against the sequential oracle, field by field
    ops, ks, vs = (torch.as_tensor(a, device=kt.device)
                   for a in stream["check"])
    st_p, ok_p, stats = B.update_parallel(out["state"], ops, ks, vs,
                                          sz.n_buckets)
    st_o, ok_o = B.apply(out["state"], ops, ks, vs, sz.n_buckets)
    if not torch.equal(ok_p, ok_o):
        raise AssertionError("update_parallel ok flags differ from apply")
    same_arrays(st_p, st_o, "update_parallel vs apply")
    max_chain, mean_chain = B.chain_stats(out["state"], sz.n_buckets)
    return {"max_abs_err": err, "element_loads": element_loads,
            "live_keys": len(want["live"]),
            "flushes": want["flushes"], "fences": want["fences"],
            "check_ops_committed": int(stats.ops_committed),
            "max_chain": int(max_chain), "mean_chain": float(mean_chain)}


def probe_err(got, want) -> int:
    """Largest difference between two ``(found, vals)`` answers."""
    return max(int((g.long() - w.long()).abs().max())
               for g, w in zip(got, want))


def check_probe_element_loads(kt, vt, q) -> dict:
    """``nvt_probe`` bit for bit against ``probe_ref`` on the tiles' two
    shapes the kernel reads word by word: the same rows starting 4 bytes
    past a 16-byte boundary, and the rows widened to cap 33 (the new
    column empty, its values 5, which query 0 sums)."""
    nb, cap = kt.shape
    buf = torch.zeros((2, nb * cap + 1), dtype=torch.int32, device=kt.device)
    okt, ovt = (buf[i, 1:].view(nb, cap) for i in range(2))
    okt.copy_(kt)
    ovt.copy_(vt)
    pad = torch.nn.functional.pad
    shapes = {"offset_view": (okt, ovt),
              f"cap{cap + 1}": (pad(kt, (0, 1)), pad(vt, (0, 1), value=5))}
    errs = {}
    for name, (a, b) in shapes.items():
        errs[name] = probe_err(nvt_probe(a, b, q), probe_ref(a, b, q))
        if errs[name]:
            raise AssertionError(f"nvt_probe on {name} tiles differs from "
                                 f"probe_ref by {errs[name]}")
    return errs


def run_serve(sz: Sizes, device) -> dict:
    """Exactly-once across growth, snapshot, crash and restart, with what
    the log's own instrumentation saw (:func:`serve_trace`)."""
    dev = B.resolve_device(device)
    get_registry().reset()
    get_tracker().reset()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        rlog = RequestLog(d, capacity=sz.serve_capacity, device=dev)
        rid = 0
        for _ in range(sz.serve_batches):
            batch = {r: [r, (r * 7) % 1000]
                     for r in range(rid, rid + sz.serve_batch)}
            rlog.commit(batch, evict=rlog.expired_rids(sz.serve_retain))
            rid += sz.serve_batch
        if rlog.dedup_migrations < 1:
            raise AssertionError("the dedup map never grew")
        rlog.snapshot()
        rlog.commit({rid: [rid, 0]},
                    evict=rlog.expired_rids(sz.serve_retain))
        rid += 1
        before = rlog.committed()
        kept = sorted(before)
        evicted = sorted(set(range(rid)) - set(before))
        if not evicted:
            raise AssertionError("nothing was evicted")
        rlog.io.crash()
        t1 = time.perf_counter()
        again = RequestLog(d, capacity=sz.serve_capacity, device=dev)
        t2 = time.perf_counter()
        if again.committed() != before:
            raise AssertionError("committed() changed across the crash")
        if not again.took_effect(kept).all():
            raise AssertionError("a kept rid lost its effect")
        if again.took_effect(evicted).any():
            raise AssertionError("an evicted rid took effect")
        if again.records_parsed != 1:
            raise AssertionError("restart replayed more than the suffix")
        return {"rids": rid, "kept": len(kept), "evicted": len(evicted),
                "dedup_migrations": rlog.dedup_migrations,
                "commit_s": t1 - t0, "restart_s": t2 - t1,
                **serve_trace(rlog, again, sz.serve_batches + 1, 1)}


def serve_trace(rlog, again, n_commits: int, n_snaps: int) -> dict:
    """Read the request log's spans, counters and first-call events, and
    check them against the flush -> fence -> publish discipline: each
    commit stages one record outside its flush/fence, every flush and
    fence falls inside a ``flush_fence`` span (one of each per commit
    and per snapshot), the snapshot publishes once, and the tracer's
    totals equal ``StagedIO``'s own counters."""
    reg = get_registry()
    n, bill = {}, {}
    for r in rlog.tracer.records():
        n[r["span"]] = n.get(r["span"], 0) + 1
        b = bill.setdefault(r["span"], {})
        for k, c in r["counts"].items():
            b[k] = b.get(k, 0) + c
    want = {"commit": {"write": n_commits},
            "flush_fence": {"flush": n_commits + n_snaps,
                            "fence": n_commits + n_snaps},
            "publish": {"publish": n_snaps}}
    for phase, counts in want.items():
        if bill.get(phase) != counts:
            raise AssertionError(f"span {phase!r} bill {bill.get(phase)} "
                                 f"!= {counts}")
    if bill["snapshot"].get("write") != n_snaps or {"flush", "fence"} & \
            set(bill["snapshot"]):
        raise AssertionError(f"snapshot span bill {bill['snapshot']}")
    io = rlog.io.counters
    if (rlog.tracer.totals.get("flush"), rlog.tracer.totals.get("fence")) \
            != (io.flushes, io.fences):
        raise AssertionError("span totals disagree with StagedIO counters")
    counters = {e.name + ("{%s}" % ",".join(
        f"{k}={v}" for k, v in sorted(e.labels.items())) if e.labels
        else ""): e.obj.value for e in reg.entries() if e.kind == "counter"}
    if counters.get("serving_commits_total") != n_commits or \
            counters.get("dedup_migrations_total") != \
            rlog.dedup_migrations + again.dedup_migrations:
        raise AssertionError(f"registry counters {counters}")
    first = get_tracker().stats()
    if first.get("capacity_ladder", {}).get("events", 0) < 1:
        raise AssertionError("no first-call event on the capacity ladder")
    span_us = {ph: {"n": n[ph], **{q: reg.histogram(
        "span_us", lo=0.1, hi=1e8, growth=1.25, phase=ph).quantile(v)
        for q, v in (("p50", 0.5), ("p99", 0.99))}} for ph in sorted(n)}
    return {"span_us": span_us, "span_bill": bill,
            "restart_phase_us": again.restart_timing,
            "counters": counters, "first_calls": first}


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    for w in WRAPPERS:
        w.launches = 0
    for counter in (flash_attention.shapes, flash_attention_bwd.shapes,
                    ssd_scan.shapes, ssd_scan_bwd.shapes,
                    decode_attention.shapes,
                    fa_kernel.flash_attention_kernel.routes,
                    ssd_kernel.ssd_scan_kernel.routes):
        counter.clear()


def route_launches() -> dict:
    """The forward kernels' launches since the last reset, by route
    (``kernel.py``'s ``fwd_route``: "wgmma", "mma_sync" or "scalar")."""
    return {"flash_attention": dict(fa_kernel.flash_attention_kernel.routes),
            "ssd_scan": dict(ssd_kernel.ssd_scan_kernel.routes)}


def check_routes(what: str, routes: dict, launches: dict) -> None:
    """Every forward launch of a main-path run went through the wgmma
    kernels: the bf16 attention of every arch (d = 64, 112 or 128) takes
    ``flash_fwd_wg`` and every bf16 scan (P = 64, N <= 128, chunk 128)
    the three wgmma passes, by the routes' own rules."""
    for name in ("flash_attention", "ssd_scan"):
        n = launches.get(name, 0)
        if routes[name] != ({"wgmma": n} if n else {}):
            raise AssertionError(f"{what}: {name} launched {routes[name]}, "
                                 f"not {n} on the wgmma route")


# full-width archs cut in depth to fit one card: (layers, why)
DEPTH_CUTS = {"arctic-480b": (1, "477 B parameters, about 954 GB in bf16, "
                              "cannot be held by one 80 GB card")}


def model_config(sz: Sizes, arch: str = "zamba2-7b", **overrides):
    """``arch`` at full width (cut in depth where ``DEPTH_CUTS`` says so)
    or, at a tiny size, ``tiny(arch)``; ``overrides`` last."""
    cfg = get_arch(arch)
    if sz.model_tiny:
        return tiny(cfg, **overrides)
    if arch in DEPTH_CUTS:
        overrides = {"n_layers": DEPTH_CUTS[arch][0], **overrides}
    return dataclasses.replace(cfg, **overrides)


def attn_launches_per_prefill(cfg) -> int:
    """flash_attention launches of one prefill: one a layer of a dense,
    MoE or VLM model, one a shared-block call of a hybrid one, none in an
    SSM, and an encoder-decoder's encoder layers plus two a decoder layer
    (causal self-attention and cross-attention)."""
    fam = cfg.family
    if fam == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if fam == "ssm":
        return 0
    if fam == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def decode_launches_per_step(cfg) -> int:
    """decode_attention launches of one decode step: one a self-attention
    layer (a decoder layer of an encoder-decoder; its cross-attention
    reads the encoder's k/v in plain PyTorch), one a shared-block call of
    a hybrid, none in an SSM."""
    if cfg.family == "encdec":
        return cfg.n_layers
    return attn_launches_per_prefill(cfg)


def ssd_launches_per_prefill(cfg) -> int:
    """ssd_scan launches of one prefill: one a Mamba2 layer."""
    return cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0


def synth_inputs(cfg, batch: int, gen) -> dict:
    """A VLM's vision prefix or an encoder-decoder's frames drawn from
    ``gen`` by the frontend stubs, in the compute dtype."""
    ct = getattr(torch, cfg.compute_dtype)
    if cfg.family == "vlm":
        return {"vis": synth_vision_patches(gen, batch, cfg, ct)}
    if cfg.family == "encdec":
        return {"frames": synth_audio_frames(gen, batch, cfg, ct)}
    return {}


def free_card(dev) -> None:
    """Give the caching allocator's free blocks back before the next
    full-width model (the phases hold one model at a time)."""
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def model_requests(sz: Sizes, vocab: int, seed: int) -> dict:
    """rids 0-3 with prompts of ``prompt_lens[0]`` tokens, rids 4-7 of
    ``prompt_lens[1]``, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {rid: rng.integers(0, vocab, size=sz.prompt_lens[rid // 4])
            .astype(np.int32) for rid in range(8)}


def run_model(sz: Sizes, dev, seed: int, arch: str = "zamba2-7b") -> dict:
    """The serving path: ``arch`` (of any family) behind a ServeEngine
    serves 8 requests, crashes after its first batch, and a new engine on
    the same log serves all 8 again.  Checks exactly-once, the dedup hits
    and the kernels' launch counts per prefill; returns the phase's
    numbers, ``flash_shapes`` the flash_attention launches by shape and
    ``decode_shapes`` the decode_attention launches by ``(B, H, K, d,
    S_max, window)``."""
    cfg = model_config(sz, arch)
    model = Model(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    _sync(dev)
    init_s = time.perf_counter() - t0
    # each leaf is drawn in f32 before its cast: the largest draw is the
    # init's temporary (arctic-480b's expert leaves: 17.8 GB)
    init_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else None
    n_params = sum(p.numel() for p in params.parameters())
    requests = model_requests(sz, cfg.vocab, seed)
    max_len = max(sz.prompt_lens) + sz.new_tokens + prefix_tokens(cfg)
    reg = get_registry()
    hits = reg.counter("serving_dedup_hits_total")
    with tempfile.TemporaryDirectory() as d:
        kw = dict(max_len=max_len, log_dir=d, batch_size=sz.model_batch,
                  device=dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        first_eng = ServeEngine(model, params, **kw)
        first = first_eng.serve(requests, n_new=sz.new_tokens,
                                crash_after_batches=1)
        hits0 = hits.value
        again = ServeEngine(model, params, **kw)
        out = again.serve(requests, n_new=sz.new_tokens)
        launches = {"flash_attention": flash_attention.launches,
                    "ssd_scan": ssd_scan.launches,
                    "nvt_probe": nvt_probe.launches,
                    "decode_attention": decode_attention.launches}
        routes = route_launches()
        flash_shapes = sorted([*k, n] for k, n in
                              flash_attention.shapes.items())
        decode_shapes = sorted([*k, n] for k, n in
                               decode_attention.shapes.items())
        dedup_hits = hits.value - hits0
        records = sorted(n for n in os.listdir(d) if n.startswith("log_"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    short = sorted(r for r in requests
                   if len(requests[r]) == min(sz.prompt_lens))
    if sorted(first) != short[:sz.model_batch]:
        raise AssertionError(f"first batch committed {sorted(first)}")
    if any(out.get(r) != first[r] for r in first):
        raise AssertionError("the first batch's results changed across "
                             "the crash")
    if sorted(out) != sorted(requests) or any(
            len(v) != sz.new_tokens or not all(0 <= t < cfg.vocab
                                               for t in v)
            for v in out.values()):
        raise AssertionError("not every request was served in full")
    if len(records) != -(-len(requests) // sz.model_batch):
        raise AssertionError(f"{len(records)} log records for "
                             f"{len(requests)} requests: not exactly once")
    if dedup_hits != len(first):
        raise AssertionError(f"the second serve counted {dedup_hits} "
                             f"dedup hits, not {len(first)}")
    prefills = len(first_eng.step_times["prefill_s"]) + \
        len(again.step_times["prefill_s"])
    steps = len(first_eng.step_times["decode_step_s"]) + \
        len(again.step_times["decode_step_s"])
    if dev.type == "cuda" and (
            launches["flash_attention"]
            != attn_launches_per_prefill(cfg) * prefills
            or launches["ssd_scan"] != ssd_launches_per_prefill(cfg)
            * prefills
            or launches["decode_attention"]
            != decode_launches_per_step(cfg) * steps
            or sum(k[-1] for k in decode_shapes)
            != launches["decode_attention"]):
        raise AssertionError(f"launches {launches} for {prefills} "
                             f"prefills and {steps} decode steps of "
                             f"{cfg.n_layers} layers")
    if dev.type == "cuda":
        check_routes(cfg.name, routes, launches)
    times = {k: first_eng.step_times[k] + again.step_times[k]
             for k in first_eng.step_times}
    profiled = profile_model(model, params, requests, sz, dev) \
        if dev.type == "cuda" else None
    del first_eng, again, params
    free_card(dev)
    decode = times["decode_step_s"]
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.compute_dtype,
            "n_params": n_params, "init_s": init_s,
            "prompt_lens": list(sz.prompt_lens),
            "new_tokens": sz.new_tokens, "batch": sz.model_batch,
            "max_len": max_len, "prefills": prefills,
            "launches": launches, "routes": routes,
            "flash_shapes": flash_shapes, "decode_shapes": decode_shapes,
            "dedup_hits": dedup_hits,
            "records": len(records), "prefill_s": times["prefill_s"],
            "decode_step_s_median": float(np.median(decode)),
            "decode_step_s": decode,
            "prefill_tokens_per_s": sz.model_batch * sum(sz.prompt_lens)
            / sum(times["prefill_s"]),
            "decode_tokens_per_s": sz.model_batch / float(np.median(decode)),
            "prefill_compute_bound_ms": prefill_bound_ms(cfg, sz),
            "peak_bytes": peak, "init_peak_bytes": init_peak,
            "profile": profiled, "reduced": []}


def prefill_bound_ms(cfg, sz: Sizes):
    """A dense model's 4 x 512 prefill at the bf16 peak: 2 flops a
    weight (the embedding table is a lookup, not a product) a token, the
    attention scores left out.  None for the hybrid family, whose shared
    block runs once a call site."""
    if cfg.family != "dense":
        return None
    weights = cfg.n_params() - padded_vocab(cfg) * cfg.d_model
    return 2 * weights * sz.model_batch * max(sz.prompt_lens) \
        / BF16_FLOP_PER_S * 1e3


# families phase: the MoE, SSM, encoder-decoder and VLM archs, and the two
# largest dense archs, served at full width one at a time (arctic-480b cut
# in depth, DEPTH_CUTS)
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "mamba2-370m", "whisper-medium",
                "internvl2-26b", "arctic-480b", "qwen1.5-32b", "gemma3-27b")
# family_flash_shapes' keys and the arch of each (whisper's three keys are
# whisper-medium's)
FLASH_SHAPE_ARCHS = {"qwen2_moe": "qwen2-moe-a2.7b",
                     "internvl2": "internvl2-26b", "arctic": "arctic-480b",
                     "qwen1_5": "qwen1.5-32b", "gemma3_global": "gemma3-27b",
                     "gemma3_local": "gemma3-27b"}


def family_flash_shapes(sz: Sizes, S: int = None) -> dict:
    """(B, Sq, Sk, H, K, d, causal, window) of each flash_attention shape
    the families' prefills launch, at prompt length ``S`` (default the
    longer): the MoE archs', internvl2's (over the vision prefix and the
    prompt) and qwen1.5-32b's causal self-attention, gemma3-27b's at its
    global layers and, with the window of ``_layer_window``, at its local
    ones, whisper's bidirectional encoder over its frames, its
    cross-attention from the prompt to them, and its decoder's causal
    self-attention."""
    S = S or max(sz.prompt_lens)
    B = sz.model_batch
    out = {}
    for key, arch in FLASH_SHAPE_ARCHS.items():
        cfg = model_config(sz, arch)
        Sv = S + prefix_tokens(cfg)
        window = cfg.local_window if key == "gemma3_local" else 0
        out[key] = (B, Sv, Sv, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                    True, window)
    w = model_config(sz, "whisper-medium")
    heads = (w.n_heads, w.n_kv_heads, w.head_dim)
    out["whisper_encoder"] = (B, w.enc_seq, w.enc_seq, *heads, False, 0)
    out["whisper_cross"] = (B, S, w.enc_seq, *heads, False, 0)
    out["whisper_decoder"] = (B, S, S, *heads, True, 0)
    return out


def layer_windows(cfg) -> dict:
    """{window: layers} of a dense arch's attention (gemma3's local and
    global layers; one window, 0, elsewhere)."""
    out = {}
    for idx in range(cfg.n_layers):
        w = model_transformer._layer_window(cfg, idx)
        out[w] = out.get(w, 0) + 1
    return out


def launches_at(flash_shapes, shape) -> int:
    """The launches among ``flash_shapes`` (run_model's rows ``[B, Sq,
    Sk, H, K, d, causal, window, count]``) at ``shape`` with either prompt
    length: the same batch, heads, head dim, mask and window, and
    self-attention (Sq == Sk) for a self-attention shape, the same keys
    (Sk != Sq) for a cross-attention one."""
    B, Sq, Sk, H, K, d, causal, window = shape
    total = 0
    for b, sq, sk, h, k, dd, c, w, n in flash_shapes:
        if (b, h, k, dd, bool(c), w) != (B, H, K, d, causal, window):
            continue
        if (sq == sk) if Sq == Sk else (sk == Sk and sq != sk):
            total += n
    return total


def families_reduced(sz: Sizes) -> list:
    """How the families phase departs from each published config."""
    if sz.model_tiny:
        return ["every arch as tiny(arch), f32: a rehearsal"]
    return [f"{arch}: n_layers {get_arch(arch).n_layers} -> {n} ({why}); "
            f"{model_config(sz, arch).n_params() / 1e9:.1f} B parameters "
            f"at full width" for arch, (n, why) in DEPTH_CUTS.items()]


def run_families(sz: Sizes, dev, seed: int) -> dict:
    """Each of FAMILY_ARCHS through run_model's flow (8 requests, a crash
    after the first batch, a new engine on the same log; exactly-once, the
    dedup hits and the launches a prefill checked), one model on the card
    at a time.  whisper-medium must launch flash_attention once an
    encoder layer, once a decoder layer at its cross shape and once at
    its causal shape, a prefill; gemma3-27b once a local layer with its
    window and once a global layer without."""
    t0 = time.perf_counter()
    archs = []
    for arch in FAMILY_ARCHS:
        out = run_model(sz, dev, seed, arch)
        cfg = model_config(sz, arch)
        shapes = family_flash_shapes(sz)
        per_layer = {}
        if arch == "whisper-medium":
            per_layer = {"whisper_encoder": cfg.enc_layers,
                         "whisper_cross": cfg.n_layers,
                         "whisper_decoder": cfg.n_layers}
        elif arch == "gemma3-27b":
            windows = layer_windows(cfg)
            per_layer = {"gemma3_local": windows.get(cfg.local_window, 0),
                         "gemma3_global": windows.get(0, 0)}
            out["layers_by_window"] = windows
        for key, layers in per_layer.items():
            got = launches_at(out["flash_shapes"], shapes[key])
            if dev.type == "cuda" and got != layers * out["prefills"]:
                raise AssertionError(
                    f"{arch} {key}: {got} launches for {out['prefills']} "
                    f"prefills of {layers} layers")
        archs.append(out)
    return {"archs": archs, "reduced": families_reduced(sz),
            "phase_s": time.perf_counter() - t0}


# --------------------------------------------------------------------- #
# train phase: qwen3-1.7b, mamba2-370m and zamba2-7b trained at full      #
# width, and the crash/resume recipe of run_training on each              #
# --------------------------------------------------------------------- #
TRAIN_ARCH = "qwen3-1.7b"
# the archs the SSD backward trains, after qwen3-1.7b, one at a time
SSM_TRAIN_ARCHS = ("mamba2-370m", "zamba2-7b")
# the MoE arch trained after them
MOE_TRAIN_ARCH = "qwen2-moe-a2.7b"
# full-width archs the train phase cuts in depth: (layers, why)
TRAIN_DEPTH_CUTS = {"zamba2-7b": (
    24, "6.75 B parameters are about 108 GB with AdamW's f32 moments and "
        "the f32 gradient accumulator (16 B a parameter), more than one "
        "80 GB card holds; 24 layers, a multiple of shared_attn_every = 6, "
        "keep 4 shared-attention calls"),
    "qwen2-moe-a2.7b": (
    4, "14.32 B parameters are about 229 GB with AdamW's f32 moments and "
       "the f32 gradient accumulator (16 B a parameter); 6 layers (4.05 B, "
       "64.7 GB) leave too little of 80 GB for the f32 logits and the "
       "activations, 4 layers hold 2.90 B (46.5 GB)")}
# the leaves whose gradient flows only through a kernel's or the MoE
# dispatch's backward, by group: each layer's must be nonzero.  Attention:
# the projections (and the QKV biases, the head norms) that feed q, k and
# v; a Mamba2 layer: A_log and dt_bias; a MoE layer: the router and each
# expert tensor
SSM_GRAD_LEAVES = ("A_log", "dt_bias")


def grad_leaf_groups(cfg) -> dict:
    """{group: the suffixes of the leaves of one layer} that
    :func:`_train_run` holds nonzero: ``attn`` for the archs that attend
    in every layer (from the arch's own leaves: QKV biases where
    ``qkv_bias``, the head norms where ``qk_norm``), ``moe`` for a MoE
    arch, ``ssm`` for the SSM and hybrid ones."""
    if cfg.family in ("ssm", "hybrid"):
        return {"ssm": SSM_GRAD_LEAVES}
    fused = ("wqkv",) if cfg.fused_qkv else ("wq", "wk", "wv")
    attn = fused + ((("bqkv",) if cfg.fused_qkv else ("bq", "bk", "bv"))
                    if cfg.qkv_bias else ()) \
        + (("q_norm", "k_norm") if cfg.qk_norm else ())
    out = {"attn": tuple(f"attn.{n}" for n in attn)}
    if cfg.family == "moe":
        experts = ("w_gate_up",) if cfg.fused_gate_up else ("w_gate", "w_up")
        out["moe"] = ("moe.router",) + tuple(
            f"moe.experts.{n}" for n in experts + ("w_down",))
    return out


# run_training's crash/resume recipe (the README's train CLI example), on
# the tiny form of each trained arch
RECIPE = dict(arch="tiny:qwen3-1.7b", steps=30, ckpt_every=10)
RECIPE_CRASH = dict(crash_at=20, crash_phase="manifest")


def train_config(sz: Sizes, arch: str = TRAIN_ARCH, **overrides):
    """``arch`` (or its tiny form) with the config's microbatches, which
    tiny() would set to 1, cut in depth at full size where
    ``TRAIN_DEPTH_CUTS`` says so."""
    if not sz.model_tiny and arch in TRAIN_DEPTH_CUTS:
        overrides = {"n_layers": TRAIN_DEPTH_CUTS[arch][0], **overrides}
    return model_config(sz, arch, **{
        "microbatches": get_arch(arch).microbatches, **overrides})


def train_shape(sz: Sizes, arch: str = TRAIN_ARCH) -> tuple:
    """(B, Sq, Sk, H, K, d, causal) of a training microbatch's attention
    (flash_attention.shapes' key)."""
    cfg = train_config(sz, arch)
    S = sz.train_seq
    return (sz.train_batch // cfg.microbatches, S, S, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, True)


def ssd_train_shape(sz: Sizes, arch: str) -> tuple:
    """(B, S, H, P, N, chunk) of a training microbatch's SSD
    (ssd_scan.shapes' key)."""
    cfg = train_config(sz, arch)
    return (sz.train_batch // cfg.microbatches, sz.train_seq, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)


def train_reduced(sz: Sizes, arch: str = TRAIN_ARCH) -> list:
    cfg = train_config(sz, arch)
    if sz.model_tiny:
        return [f"tiny({arch}), f32, sequences of {sz.train_seq}: a "
                "rehearsal"]
    out = ["global batch 256 -> 4 (train_4k's 256 sequences of 4096; "
           "a smoke run has room for a few steps)"]
    if arch in TRAIN_DEPTH_CUTS:
        out.append(f"n_layers {get_arch(arch).n_layers} -> {cfg.n_layers}: "
                   f"{TRAIN_DEPTH_CUTS[arch][1]}")
    out.append("no checkpoint at this size: the checkpoint manager digests "
               "every byte on the host (5-10 s per 2.74 GB), minutes a save "
               "of parameters and AdamW moments; the crash/resume recipe "
               f"runs on tiny({arch}) instead")
    out.append(f"the f32 gradient check: n_layers {get_arch(arch).n_layers}"
               f" -> {train_check_layers(sz, arch)}, one sequence of "
               f"{sz.train_check_seq}")
    return out


def _train_run(sz: Sizes, dev, seed: int, arch: str = TRAIN_ARCH,
               profile: bool = False) -> dict:
    """``sz.train_steps`` steps of ``arch`` from the parameters of ``seed``
    through ``make_train_step`` (AdamW, remat, the config's microbatches),
    deterministic on the card: losses, step seconds, the kernel launches
    of the steps (all and at the training shapes), the first step's
    gradients of the leaves a kernel's backward alone feeds that are zero,
    peak memory; with ``profile``, one more step under ``torch.profiler``
    after the counts are read."""
    cfg = train_config(sz, arch)
    groups = grad_leaf_groups(cfg)
    model = Model(cfg)
    opt = make_optimizer(cfg)
    nonzero = {}

    def update(grads, state, params, step):
        if not nonzero:            # the first step's, read after the run
            for group, suffixes in groups.items():
                nonzero[group] = {
                    n: g.abs().max() > 0 for n, g in grads.items()
                    if any(n.endswith("." + x) for x in suffixes)}
        return opt.update(grads, state, params, step)
    train_step = make_train_step(model, cfg, Optimizer(opt.init, update))
    pipe = TokenPipeline(cfg, ShapeConfig("train_4k", sz.train_seq,
                                          sz.train_batch, "train"),
                         seed=seed, microbatches=cfg.microbatches)
    out = {}
    on_card = dev.type == "cuda"
    held = lambda: torch.cuda.memory_allocated(dev) if on_card else 0
    with deterministic(dev):
        t0 = time.perf_counter()
        held0 = held()
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            trainable=True)
        held1 = held()
        opt_state = opt.init(params)
        held2 = held()
        _sync(dev)
        out["init_s"] = time.perf_counter() - t0
        out["n_params"] = sum(p.numel() for p in params.parameters())
        # what the card holds for them (the dryrun phase's check (c))
        out["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in params.parameters())
        out["opt_bytes"] = sum(t.numel() * t.element_size()
                               for t in cell_leaves(opt_state))
        # and what the card's allocator took for them
        out["param_alloc_bytes"] = held1 - held0 if on_card else None
        out["opt_alloc_bytes"] = held2 - held1 if on_card else None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        losses, times = [], []
        for step in range(sz.train_steps):
            batch = pipe.next_batch()
            _sync(dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state,
                                                    batch, step)
            losses.append(float(metrics["loss"]))
            _sync(dev)
            times.append(time.perf_counter() - t0)
        out["launches"] = {w.__name__: w.launches for w in TRAIN_WRAPPERS}
        out["routes"] = route_launches()
        key = train_shape(sz, arch) + (0,)     # no window
        out["launches_at_shape"] = {
            "flash_attention": flash_attention.shapes[key],
            "flash_attention_bwd": flash_attention_bwd.shapes[key]}
        if "ssm" in groups:
            out["launches_at_shape"].update(
                ssd_scan=ssd_scan.shapes[ssd_train_shape(sz, arch)],
                ssd_scan_bwd=ssd_scan_bwd.shapes[ssd_train_shape(sz, arch)])
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else None
        out["zero_grads"] = sorted(n for g in nonzero.values()
                                   for n, nz in g.items() if not bool(nz))
        out["grad_leaves"] = {g: len(v) for g, v in nonzero.items()}
        if profile and dev.type == "cuda":
            batch = pipe.next_batch()
            out["profile"] = profile_step(lambda: train_step(
                params, opt_state, batch, sz.train_steps), dev, top=10,
                groups=DISPATCH_KERNELS if "moe" in groups else None)
    del params, opt_state
    free_card(dev)
    out.update(losses=losses, step_s=times)
    return out


def train_recipe(dev, seed: int, arch: str = RECIPE["arch"]) -> dict:
    """``run_training``'s crash/resume recipe on ``dev`` for ``arch``, in
    f32 (the scalar kernels on the card) and bf16 (the tensor-core
    kernels): an uninterrupted run of RECIPE, a run crashed before step
    20's manifest publish, and its restart, which must log "resumed from
    committed step 10" and repeat every loss of the uninterrupted run bit
    for bit."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        kw = dict(RECIPE, arch=arch, device=dev, dtype=dtype, seed=seed)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            ref = run_training(ckpt_dir=f"{d}/ref", **kw)
            crashed = run_training(ckpt_dir=f"{d}/crash", **RECIPE_CRASH,
                                   **kw)
            resumed = run_training(ckpt_dir=f"{d}/crash", **kw)
        if crashed.get("crashed_at") != RECIPE_CRASH["crash_at"]:
            raise AssertionError(f"recipe {arch} {dtype}: no crash at step "
                                 f"20")
        if resumed["log"] != ["resumed from committed step 10"]:
            raise AssertionError(f"recipe {arch} {dtype}: {resumed['log']}")
        if any(resumed["losses"][s] != ref["losses"][s]
               for s in resumed["losses"]) or \
                resumed["final_loss"] != ref["final_loss"] or \
                resumed["final_step"] != RECIPE["steps"]:
            raise AssertionError(f"recipe {arch} {dtype}: the resumed "
                                 f"losses are not the uninterrupted run's")
        out[dtype] = {"final_loss": resumed["final_loss"],
                      "first_loss": ref["losses"][1],
                      "resumed_steps": len(resumed["losses"]),
                      "fences": resumed["io"]["fences"],
                      "seconds": time.perf_counter() - t0}
    return out


def train_launches(cfg, steps: int) -> dict:
    """The kernel launches ``steps`` training steps of ``cfg`` make at its
    training shapes: each layer's forward and its remat recompute a
    microbatch (2 L M) and its backward (L M) -- flash_attention once a
    dense layer or a hybrid's shared-block call, ssd_scan once a Mamba2
    layer."""
    M = cfg.microbatches
    attn = attn_launches_per_prefill(cfg)
    ssd = ssd_launches_per_prefill(cfg)
    want = {"flash_attention": 2 * attn * M * steps,
            "flash_attention_bwd": attn * M * steps}
    if ssd:
        want.update(ssd_scan=2 * ssd * M * steps,
                    ssd_scan_bwd=ssd * M * steps)
    return want


def _train_arch(sz: Sizes, dev, seed: int, arch: str) -> dict:
    """``arch`` trained ``sz.train_steps`` steps twice from the same seed:
    finite losses, the same bits in both runs, every layer's gradients
    that only a kernel's or the MoE dispatch's backward feeds nonzero
    (:func:`grad_leaf_groups`), and on the card the launches of
    :func:`train_launches`, at the training shapes and nowhere else; then
    the crash/resume recipe on ``tiny(arch)``."""
    t0 = time.perf_counter()
    cfg = train_config(sz, arch)
    first = _train_run(sz, dev, seed, arch, profile=True)
    again = _train_run(sz, dev, seed, arch)
    losses = first["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch} train losses {losses}")
    if again["losses"] != losses:
        raise AssertionError(f"{arch}: two runs from seed {seed} differ: "
                             f"{losses} and {again['losses']}")
    n_leaves = {g: cfg.n_layers * len(v)
                for g, v in grad_leaf_groups(cfg).items()}
    if first["zero_grads"] or first["grad_leaves"] != n_leaves:
        raise AssertionError(f"{arch}: gradients zero or missing: "
                             f"{first['zero_grads']} "
                             f"({first['grad_leaves']} of {n_leaves})")
    L, M, steps = cfg.n_layers, cfg.microbatches, sz.train_steps
    want = train_launches(cfg, steps)
    launched = {k: v for k, v in first["launches"].items() if v}
    if dev.type == "cuda" and (launched != {k: v for k, v in want.items()
                                            if v}
                               or any(first["launches_at_shape"][k] != n
                                      for k, n in want.items())):
        raise AssertionError(f"{arch} train launches {first['launches']} "
                             f"({first['launches_at_shape']} at the "
                             f"training shapes), not {want}")
    if dev.type == "cuda":
        check_routes(f"{arch} train", first["routes"], first["launches"])
    tokens = sz.train_batch * sz.train_seq
    step_s = first["step_s"]
    out = {"arch": cfg.name, "n_layers": L, "d_model": cfg.d_model,
           "dtype": cfg.compute_dtype, "microbatches": M,
           "global_batch": sz.train_batch, "seq_len": sz.train_seq,
           "n_params": first["n_params"], "init_s": first["init_s"],
           **{k: first[k] for k in ("param_bytes", "opt_bytes",
                                    "param_alloc_bytes", "opt_alloc_bytes")},
           "losses": losses, "rerun_losses_equal": True,
           "step_s": step_s, "step_s_rerun": again["step_s"],
           "tokens_per_step": tokens,
           "tokens_per_s": tokens / float(np.median(step_s)),
           "peak_bytes": first["peak_bytes"],
           "launches": first["launches"], "routes": first["routes"],
           "launches_at_shape": first["launches_at_shape"],
           "launches_per_step": {k: v / steps
                                 for k, v in first["launches"].items()},
           **{f"{g}_grad_leaves_nonzero": n
              for g, n in first["grad_leaves"].items()},
           "profile": first.get("profile"),
           "recipe": train_recipe(dev, seed, f"tiny:{arch}"),
           "reduced": train_reduced(sz, arch)}
    ssm = cfg.family in ("ssm", "hybrid")
    if ssm:
        out["ssd_shape"] = list(ssd_train_shape(sz, arch))
        if out["profile"]:         # the SSD backward's share of the step
            out["ssd_bwd_share"] = sum(k["share"] for k in
                                       out["profile"]["port"]
                                       if "ssd_bwd" in k["name"])
    if cfg.family == "moe" and out["profile"]:
        # the dispatch's and the combine's indexing and sorts, with their
        # backward, under deterministic algorithms
        out["dispatch_share"] = out["profile"]["groups"]["dispatch_combine"][
            "share"]
    if cfg.family == "hybrid":
        out["shared_attn_calls"] = cfg.n_layers // cfg.shared_attn_every
        out["attn_shape"] = list(train_shape(sz, arch))
    out["phase_s"] = time.perf_counter() - t0
    return out


# arctic-480b trains only in its tiny form: the recipe (bf16 moments), and
# three AdamW steps on the card held against the CPU
BF16_OPT_ARCH = "arctic-480b"


def bf16_ulps(got: torch.Tensor, want: torch.Tensor,
              scale: torch.Tensor) -> float:
    """max |got - want| over one bf16 ulp of ``scale`` (elementwise: the
    spacing of bf16 at |scale|'s binade, normal numbers only)."""
    mag = scale.float().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got.float() - want.float()).abs() / ulp).max())


def check_bf16_optimizer(sz: Sizes, dev, seed: int,
                         arch: str = BF16_OPT_ARCH) -> dict:
    """Three steps of ``make_train_step`` with ``microbatches=2`` and
    AdamW on ``tiny(arch)`` (bf16 moments and a bf16 microbatch
    accumulator: its ``opt_dtype``) on ``dev`` and on the CPU from the
    same parameters and seeded gradients.  The loss is linear in the
    parameters, sum(p o g), so that both devices differentiate to ``g``
    exactly (a model's own gradients differ at f32 noise, hundreds of
    bf16 ulps where they cancel), as ``tests/test_torch_train.py`` holds
    the port's accumulator against the reference's.  Each step: the accumulator
    handed to AdamW bit for bit; each bf16 moment within one bf16 ulp of
    its update's largest operand (|new|, b |old| or (1 - b) |g|, with g^2
    for nu: the global norm's clip scale sums in another order on the
    card, and a moment one f32 ulp off may round the other way); the
    parameters within 1e-5."""
    cfg = dataclasses.replace(tiny(get_arch(arch)), microbatches=2)
    if cfg.opt_dtype != "bfloat16":
        raise AssertionError(f"{arch}: opt_dtype {cfg.opt_dtype}")
    model = Model(cfg)
    cpu = torch.device("cpu")
    host = model.init(torch.Generator().manual_seed(seed), trainable=True)
    rng = np.random.default_rng(seed)
    names = [n for n, _ in host.named_parameters()]
    batches = [{n: np.stack([rng.standard_normal(p.shape).astype(np.float32)
                             for _ in range(2)])
                for n, p in host.named_parameters()} for _ in range(3)]
    lin = SimpleNamespace(loss=lambda p, mb: sum(
        (leaf * mb[n]).sum() for n, leaf in p.named_parameters()))
    runs = {}
    for where in (cpu, dev):
        params = copy.deepcopy(host).to(where)
        opt = make_optimizer(cfg)
        seen = []

        def update(grads, state, p, step, opt=opt, seen=seen):
            seen.append({n: g.clone() for n, g in grads.items()})
            return opt.update(grads, state, p, step)
        step_fn = make_train_step(lin, cfg, Optimizer(opt.init, update))
        state = opt.init(params)
        moments = []
        with deterministic(where):
            for i, batch in enumerate(batches):
                params, state, _ = step_fn(params, state, batch, i)
                moments.append({m: {n: t.clone().cpu()
                                    for n, t in state[m].items()}
                                for m in ("mu", "nu")})
        runs[where.type] = {"acc": [{n: g.cpu() for n, g in a.items()}
                                    for a in seen],
                            "moments": moments,
                            "params": {n: p.detach().cpu() for n, p in
                                       params.named_parameters()}}
    host_run, card = runs["cpu"], runs[dev.type]
    worst = {"mu": 0.0, "nu": 0.0}
    for i in range(len(batches)):
        for n in names:
            a, w = card["acc"][i][n], host_run["acc"][i][n]
            if not torch.equal(a, w):
                raise AssertionError(f"bf16 accumulator step {i} {n}: not "
                                     f"the CPU's bits")
        prev = host_run["moments"][i - 1] if i else None
        for m, b in (("mu", 0.9), ("nu", 0.95)):
            for n in names:
                t, w = card["moments"][i][m][n], host_run["moments"][i][m][n]
                if t.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
                    raise AssertionError(f"{m} {n}: {t.dtype}, not bf16")
                g = host_run["acc"][i][n].float()
                term = (1 - b) * (g if m == "mu" else g * g).abs()
                old = b * prev[m][n].float().abs() if prev else \
                    torch.zeros_like(term)
                scale = torch.maximum(w.float().abs(),
                                      torch.maximum(old, term))
                ulps = bf16_ulps(t, w, scale)
                if ulps > 1.0:
                    raise AssertionError(f"bf16 {m} step {i} {n}: {ulps} "
                                         f"ulps from the CPU's")
                worst[m] = max(worst[m], ulps)
    param_err = max(max_err(card["params"][n], host_run["params"][n])
                    for n in names)
    if not param_err <= 1e-5:
        raise AssertionError(f"bf16 optimizer: parameters {param_err} from "
                             f"the CPU's")
    return {"arch": f"tiny:{arch}", "steps": len(batches),
            "microbatches": cfg.microbatches, "opt_dtype": cfg.opt_dtype,
            "leaves": len(names), "accumulator_bitwise": True,
            "worst_moment_ulps": worst, "param_max_abs_err": param_err}


def run_train(sz: Sizes, dev, seed: int) -> dict:
    """qwen3-1.7b (its results at the top level), then mamba2-370m,
    zamba2-7b and qwen2-moe-a2.7b (under their names), one model on the
    card at a time, each trained twice from one seed and put through the
    crash/resume recipe (:func:`_train_arch`); then arctic-480b's tiny
    form: the recipe under its bf16 moments and
    :func:`check_bf16_optimizer`."""
    t0 = time.perf_counter()
    out = _train_arch(sz, dev, seed, TRAIN_ARCH)
    for arch in SSM_TRAIN_ARCHS + (MOE_TRAIN_ARCH,):
        out[arch] = _train_arch(sz, dev, seed, arch)
    t1 = time.perf_counter()
    out[BF16_OPT_ARCH] = {
        "recipe": train_recipe(dev, seed, f"tiny:{BF16_OPT_ARCH}"),
        "bf16_optimizer": check_bf16_optimizer(sz, dev, seed),
        "reduced": [f"{BF16_OPT_ARCH} trains only as tiny(): one layer at "
                    f"full width is 14.07 B parameters, about 141 GB under "
                    f"its bf16 AdamW, more than one 80 GB card holds"],
        "phase_s": time.perf_counter() - t1}
    out["phase_s"] = time.perf_counter() - t0
    return out


# the kernels of the MoE dispatch and combine and their backward under
# deterministic algorithms (profile_step's ``groups``): gathers, the
# sort-based index_put, scatters, sorts and searchsorted (the embedding's
# backward sorts its indices through the same radix sort)
DISPATCH_KERNELS = {"dispatch_combine": (
    "index_elementwise", "indexing_backward", "index_put", "scatter",
    "RadixSort", "SortKV", "sort", "searchsorted")}


PORT_KERNELS = ("nvt_probe", "flash_fwd", "flash_bwd", "ssd_scan_tc",
                "ssd_chunk_scan", "ssd_fwd", "ssd_bwd")


def profile_step(fn, dev, top: int = 8, groups: dict = None) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its host-clock wall
    time (device synced), the device time of every kernel and copy it
    ran, the share of the wall the device was busy, the kernels that took
    the most device time, and the port's own kernels wherever they rank
    (``port``: each one's device time and share of the step's); with
    ``groups`` ({name: substrings of kernel names}) each group's device
    time, share and calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)
    # the kernels and copies themselves, not the host ops that launched
    # them (those carry the same device time again)
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    device_ms = sum(dev_us(e) for e in events) / 1e3
    events.sort(key=dev_us, reverse=True)
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall * 1e3),
            "device_kernels": sum(e.count for e in events),
            "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                     "calls": e.count} for e in events[:top]],
            "port": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                      "calls": e.count,
                      "share": dev_us(e) / 1e3 / device_ms}
                     for e in events
                     if any(k in e.key for k in PORT_KERNELS)],
            "groups": {name: {
                "ms": sum(dev_us(e) for e in hit) / 1e3,
                "share": sum(dev_us(e) for e in hit) / 1e3 / device_ms,
                "calls": sum(e.count for e in hit),
                "kernels": [e.key[:80] for e in hit[:top]]}
                for name, keys in (groups or {}).items()
                for hit in ([e for e in events
                             if any(k in e.key for k in keys)],)}}


def profile_model(model, params, requests: dict, sz: Sizes, dev) -> dict:
    """Where one prefill (the prompts of rids 0-3) and one decode step
    spend their time on the card (run after the launch counts are read)."""
    prompts = np.stack([requests[r]
                        for r in sorted(requests)[:sz.model_batch]])
    tokens = torch.as_tensor(prompts, device=dev)
    cfg = model.cfg
    max_len = max(sz.prompt_lens) + sz.new_tokens + prefix_tokens(cfg)
    batch = {"tokens": tokens, **stub_inputs(cfg, tokens.shape[0], dev)}
    out = {}
    with torch.no_grad():
        model.prefill(params, batch, max_len)   # warm
        out["prefill"] = profile_step(lambda: model.prefill(
            params, batch, max_len), dev)
        _, caches = model.prefill(params, batch, max_len)
        S = tokens.shape[1] + prefix_tokens(cfg)
        model.decode_step(params, tokens[:, -1], caches, S)  # warm
        out["decode_step"] = profile_step(lambda: model.decode_step(
            params, tokens[:, -1], caches, S + 1), dev)
    return out


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _check_close(name: str, got, want, tol: float) -> float:
    err = max_err(got, want)
    bad = (got.float() - want.float()).abs() > tol + tol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bool(bad.any()):
        raise AssertionError(f"{name}: max abs error {err} beyond {tol}")
    return err


def _check_decode_close(name: str, got, want) -> tuple:
    """bf16 decode attention against its plain version: each output
    within 2**-6 of the largest |output| of its (row, head), about two
    bf16 steps at the outputs' scale (the kernels round as the plain
    version does: they differ by a step where an f32 sum in another order
    rounds the other way), and never beyond the element limit
    ``2e-2 + 2e-2 |want|``.  Returns the max abs error and its largest
    share of the limit."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    lim = torch.minimum(2.0 ** -6 * want.abs().amax(-1, keepdim=True),
                        2e-2 + 2e-2 * want.abs())
    share = float((err / lim).max())
    if not torch.isfinite(got).all() or share > 1:
        raise AssertionError(f"{name}: max abs error {float(err.max())}, "
                             f"{share:.3g} of the limit")
    return float(err.max()), share


def flash_inputs(dev, B, S, H, d, dtype, seed, K=None, Sk=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    K, Sk = K or H, Sk or S
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((B, S, H, d), (B, Sk, K, d), (B, Sk, K, d)))


# flash_attention's serve shapes: (B, H, K, d) of zamba2-7b's shared
# block and of qwen2-7b's layers (GQA 28:4, the unpadded d = 128 path)
FLASH_SHAPES = {"zamba2-7b": (4, 32, 32, 112), "qwen2-7b": (4, 28, 4, 128)}


def engine_flash_shape(sz: Sizes) -> tuple:
    """(B, S, H, K, d) of the load phase's engine-point prefills: a batch
    of ENGINE_SPEC's rids (at most ENGINE_KW's batch size), each prompt
    as long as the harness makes it, at qwen2-7b's heads."""
    cfg = model_config(sz, "qwen2-7b")
    return (min(ENGINE_SPEC.batch, ENGINE_KW["batch_size"]),
            len(LoadHarness._prompt(None, 0)), cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim)


def check_flash(sz: Sizes, dev) -> dict:
    """flash_attention against attention_ref: at the serve shapes of every
    served arch (zamba2-7b, qwen2-7b and the families', gemma3-27b's local
    layers with their window) and at the engine
    point's shape (shorter than one tile) in bf16 (reference in f32,
    2e-2), and the tests/test_kernels.py sweep in f32 (2e-5: f32 sums in
    another order)."""
    errs = {}

    def bf16(key, B, S, H, K, d, Sk=None, causal=True, window=0):
        q, k, v = flash_inputs(dev, B, S, H, d, torch.bfloat16, S, K, Sk)
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
        errs[key] = _check_close(
            f"flash {key} {[B, S, Sk or S, H, K, d, causal, window]}", got,
            want, 2e-2)
    for arch, (B, H, K, d) in FLASH_SHAPES.items():
        tag = "" if arch == "zamba2-7b" else "qwen2_"
        for S in sz.check_lens:
            bf16(f"{tag}bf16_S{S}", B, S, H, K, d)
    bf16("qwen2_engine_bf16", *engine_flash_shape(sz))
    # the families' shapes: non-causal (a ragged last KV tile), Sq != Sk,
    # d = 64, GQA 6:1 and 7:1, MHA 40:40, gemma3's window
    for S in sz.check_lens:
        for key, (B, Sq, Sk, H, K, d, causal, window) in \
                family_flash_shapes(sz, S).items():
            name = f"{key}_bf16" if key == "whisper_encoder" else \
                f"{key}_bf16_S{S}"
            if name not in errs:
                bf16(name, B, Sq, H, K, d, Sk, causal, window)
    sweep = [(1, 128, 128, 2, 2, 64), (2, 256, 256, 4, 2, 64),
             (1, 256, 256, 8, 2, 32), (2, 64, 192, 2, 1, 128)]
    for i, (B, Sq, Sk, H, K, d) in enumerate(sweep):
        q, k, v = flash_inputs(dev, B, Sq, H, d, torch.float32, i, K, Sk)
        for causal in (True, False):
            errs[f"f32_{B}x{Sq}x{Sk}x{H}x{K}x{d}_{'c' if causal else 'f'}"] \
                = _check_close("flash f32 sweep", flash_attention(
                    q, k, v, causal=causal), flash_attention_plain(
                    q, k, v, causal=causal), 2e-5)
    for window in (32, 64, 128):
        q, k, v = flash_inputs(dev, 2, 256, 4, 64, torch.float32, window)
        errs[f"f32_window{window}"] = _check_close(
            "flash f32 window", flash_attention(q, k, v, window=window),
            flash_attention_plain(q, k, v, window=window), 2e-5)
    return errs


# the backward's tolerances, each gradient's max error over its max
# magnitude (an all-zero gradient would pass an abs-plus-rel test): bf16
# rounds P and dS to bf16 before the tensor-core products; f32 sums in
# another order
FLASH_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
LSE_TOL = 1e-4


def flash_bwd_shapes(sz: Sizes) -> dict:
    """(B, Sq, Sk, H, K, d, causal, window) of the backward checks: a
    qwen3-1.7b training microbatch, a zamba2-7b one (its shared block,
    d = 112, the wgmma pair on 128-column tiles), a qwen2-moe-a2.7b one
    (MHA 16:16 over [1, 4096]), zamba2-7b's d = 112 at
    the serve shape, whisper-medium's cross shape (non-causal, Sq != Sk,
    a ragged last tile), a gemma3-27b local layer (its window over twice
    its length), rows with no visible key (ROADMAP Queue 3's case), and
    two head dims no arch has: 96 (the wgmma pair) and 100 (not a
    multiple of 8, so the mma.sync pair) over a ragged GQA shape."""
    S = max(sz.check_lens)
    z = model_config(sz, "zamba2-7b")
    w = model_config(sz, "whisper-medium")
    g = model_config(sz, "gemma3-27b")
    return {"qwen3_train": train_shape(sz) + (0,),
            "zamba2_train": train_shape(sz, "zamba2-7b") + (0,),
            "qwen2_moe_train": train_shape(sz, MOE_TRAIN_ARCH) + (0,),
            "zamba2_d112": (sz.model_batch, S, S, z.n_heads, z.n_kv_heads,
                            z.head_dim, True, 0),
            "whisper_cross": (sz.model_batch, min(sz.check_lens), w.enc_seq,
                              w.n_heads, w.n_kv_heads, w.head_dim, False,
                              0),
            "gemma3_window": (1, 2 * g.local_window, 2 * g.local_window,
                              g.n_heads, g.n_kv_heads, g.head_dim, True,
                              g.local_window),
            "no_visible_key": (1, 48, 16, 2, 2, 8, False, 8),
            "d96_wgmma": (1, 300, 300, 4, 2, 96, True, 0),
            "d100_mma_sync": (1, 300, 300, 4, 2, 100, True, 0)}


def _scaled(got, want) -> tuple:
    """max|got - want| / max|want|, max|want| and max|got - want|."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    return err / scale if scale else float("inf"), scale, err


def check_flash_bwd(sz: Sizes, dev) -> dict:
    """The backward kernels, through ``flash_attention``'s autograd
    Function, against the plain backward from the same o and lse
    (``flash_attention_bwd_plain``) and against autograd through
    ``flash_attention_plain``, all in f32 on the same values, at each of
    flash_bwd_shapes in bf16 and f32: each gradient within
    ``FLASH_BWD_TOL * max|ref|`` and ``max|ref| > 0``, and a second
    backward call the same bits (no atomics); the forward's lse against
    the plain log-sum-exp (LSE_TOL abs + rel, +inf exactly where a row
    sees no key) and its o against the plain forward.  Each shape reports
    the backward route its dtype and head dim take
    (``kernel.bwd_route``)."""
    out = {}
    for key, (B, Sq, Sk, H, K, d, causal, window) in \
            flash_bwd_shapes(sz).items():
        for dtype, tol in FLASH_BWD_TOL.items():
            tag = f"{key}_{str(dtype)[6:]}"
            q, k, v = flash_inputs(dev, B, Sq, H, d, dtype, Sq + Sk, K, Sk)
            do = flash_inputs(dev, B, Sq, H, d, dtype, Sq + Sk + 1)[0]
            mask = dict(causal=causal, window=window)
            if dev.type == "cuda":
                o, lse = fa_kernel.flash_attention_kernel(q, k, v, **mask,
                                                          with_lse=True)
            else:          # the rehearsal: the plain versions' o and lse
                o = flash_attention_plain(q, k, v, **mask)
                lse = flash_attention_lse_plain(q.float(), k.float(), **mask)
            ref_o = flash_attention_plain(q.float(), k.float(), v.float(),
                                          **mask)
            fwd_err = _check_close(f"flash fwd {tag}", o, ref_o,
                                   2e-2 if dtype == torch.bfloat16 else 2e-5)
            want_lse = flash_attention_lse_plain(q.float(), k.float(), **mask)
            fin = torch.isfinite(want_lse)
            if not torch.equal(fin, torch.isfinite(lse)):
                raise AssertionError(f"flash lse {tag}: +inf rows differ")
            lse_err = _check_close(f"flash lse {tag}", lse[fin],
                                   want_lse[fin], LSE_TOL) if fin.any() \
                else 0.0
            qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
            got, again = (torch.autograd.grad(
                flash_attention(qg, kg, vg, **mask), (qg, kg, vg), do)
                for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash bwd {tag}: two calls differ")
            plain = flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                **mask)
            q32, k32, v32 = (t.float().requires_grad_(True)
                             for t in (q, k, v))
            auto = torch.autograd.grad(flash_attention_plain(
                q32, k32, v32, **mask), (q32, k32, v32), do.float())
            errs = {}
            for name, a, wp, wa in zip(("dq", "dk", "dv"), got, plain, auto):
                for ref_name, w in (("plain", wp), ("autograd", wa)):
                    rel, scale, err = _scaled(a, w)
                    if not scale > 0 or not rel <= tol:
                        raise AssertionError(
                            f"flash bwd {tag} {name} vs {ref_name}: "
                            f"{err} = {rel} x max|ref| {scale}, tol {tol}")
                    errs[f"{name}_vs_{ref_name}"] = rel
                errs[f"{name}_max_abs_err"] = _scaled(a, wp)[2]
            out[tag] = {"shape": [B, Sq, Sk, H, K, d], "causal": causal,
                        "window": window,
                        "route": fa_kernel.bwd_route(d, dtype),
                        "bitwise_repeat": True, "tol": tol,
                        "fwd_err": fwd_err,
                        "lse_err": lse_err,
                        "inf_rows": int((~fin).sum()), **errs}
            del q, k, v, do, o, lse, got, again, plain, auto, q32, k32, v32
    free_card(dev)
    return out


class plain_attention:
    """Within the block, the models attend through
    ``flash_attention_plain`` instead of the kernels (the f32 gradient
    check's other side)."""

    def __enter__(self):
        self.saved = model_layers.flash_attention
        model_layers.flash_attention = flash_attention_plain

    def __exit__(self, *exc):
        model_layers.flash_attention = self.saved


def _plain_ssd_scan(xh, dt, A, Bm, Cm, *, chunk, init_state=None):
    return ssd_chunked(xh, dt, A, Bm, Cm, chunk, init_state=init_state)


class plain_ssd:
    """Within the block, the Mamba2 layers scan through the plain
    ``ssd_chunked`` (which autograd differentiates) instead of the
    kernels."""

    def __enter__(self):
        self.saved = model_mamba2.ssd_scan
        model_mamba2.ssd_scan = _plain_ssd_scan

    def __exit__(self, *exc):
        model_mamba2.ssd_scan = self.saved


def no_drops(cfg):
    """A MoE ``cfg`` with its capacity factor raised to ``n_experts /
    top_k``, so that no token is dropped (the two sides of a consistency
    check may route a near-tied token otherwise, and with drops one
    changed route moves which tokens drop); other configs as they are."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=max(
        cfg.capacity_factor, cfg.n_experts / cfg.top_k))


TRAIN_CONSISTENCY_TOL = 1e-4
# the depth of each arch's f32 gradient check, where not
# ``sz.train_check_layers``: zamba2-7b keeps one shared-attention call
TRAIN_CHECK_LAYERS = {"zamba2-7b": 6}


def train_check_layers(sz: Sizes, arch: str) -> int:
    return TRAIN_CHECK_LAYERS.get(arch, sz.train_check_layers)


def check_train_consistency(sz: Sizes, dev, seed: int,
                            arch: str = TRAIN_ARCH) -> dict:
    """``arch``'s loss and every parameter's gradient, in f32 at full
    width cut to :func:`train_check_layers` over one sequence of
    ``train_check_seq``, with the kernels (the flash and SSD forwards and
    backwards, remat recompute included) against the plain attention and
    the plain chunked SSD: the loss within 1e-5 (abs and rel), each leaf
    within TRAIN_CONSISTENCY_TOL x its max magnitude, which must be
    nonzero (f32 sums in other orders; a dropped or wrong gradient moves
    a leaf by O(1)).  On the card the kernel side must launch each
    backward once a layer that runs its kernel.  A MoE's capacity factor
    is raised so that no token drops (:func:`no_drops`)."""
    cfg = no_drops(train_config(sz, arch,
                                n_layers=train_check_layers(sz, arch),
                                param_dtype="float32",
                                compute_dtype="float32", microbatches=1))
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed + 2),
                        trainable=True)
    named = dict(params.named_parameters())
    batch = {"tokens": np.random.default_rng(seed + 2).integers(
        0, cfg.vocab, size=(1, sz.train_check_seq + 1)).astype(np.int32)}

    def loss_and_grads():
        loss = model.loss(params, batch)
        return loss.detach(), torch.autograd.grad(loss, list(named.values()))
    before = (flash_attention_bwd.launches, ssd_scan_bwd.launches)
    lk, gk = loss_and_grads()
    want = train_launches(cfg, 1)
    got = (flash_attention_bwd.launches - before[0],
           ssd_scan_bwd.launches - before[1])
    if dev.type == "cuda" and got != (want["flash_attention_bwd"],
                                      want.get("ssd_scan_bwd", 0)):
        raise AssertionError(f"{arch}: the kernel side launched {got} "
                             f"backwards (flash, ssd), not {want}")
    with plain_attention(), plain_ssd():
        lp, gp = loss_and_grads()
    loss_err = _check_close(f"{arch} train consistency loss", lk, lp, 1e-5)
    worst, worst_leaf = 0.0, None
    for n, a, w in zip(named, gk, gp):
        rel, scale, _ = _scaled(a, w)
        if not scale > 0 or not rel <= TRAIN_CONSISTENCY_TOL:
            raise AssertionError(f"{arch} train consistency {n}: {rel} x "
                                 f"max|ref| {scale}, tol "
                                 f"{TRAIN_CONSISTENCY_TOL}")
        if rel >= worst:
            worst, worst_leaf = rel, n
    del params, named, gk, gp
    free_card(dev)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "S": sz.train_check_seq,
           "loss": float(lk), "loss_err": loss_err,
           "worst_grad_rel_err": worst, "worst_leaf": worst_leaf,
           "tol": TRAIN_CONSISTENCY_TOL}
    if cfg.family == "hybrid":
        out["shared_attn_calls"] = cfg.n_layers // cfg.shared_attn_every
    if cfg.n_experts:
        out["capacity_factor"] = cfg.capacity_factor
    return out


def _leaf(dev, shape, seed: int) -> torch.Tensor:
    """f32 values of many magnitudes (a normal times e^(3 N)), drawn on
    ``dev`` from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev) * torch.exp(
        3 * torch.randn(shape, generator=g, device=dev))


def check_compressed_grads(sz: Sizes, dev, seed: int) -> dict:
    """``make_compressed_psum_grads``: the replica form (``axis=0``) at
    ``sz.reduce_replicas`` replicas of a ``sz.reduce_elems``-element f32
    leaf, with an error of residual size, on ``dev`` and on the CPU: the
    reduced gradient and the new error bit for bit the same.  The process
    group form at world size 1 (NCCL on the card, gloo on the CPU; its
    store a ``FileStore``, no network) equal to the replica form at R = 1.
    And ``tests/test_train_loop.py``'s error-feedback sum: a gradient of
    1e-3 + 1e-6 (below bf16's resolution there) on 2 replicas, 50 steps,
    within rel 1e-3 of 50 x its value."""
    import torch.distributed as dist
    R, n = sz.reduce_replicas, sz.reduce_elems
    g = _leaf(dev, (R, n), seed)
    e = _leaf(dev, (R, n), seed + 1) * 2.0 ** -12
    f = make_compressed_psum_grads(axis=0)
    t0 = time.perf_counter()
    red, err = f({"w": g}, {"w": e})
    _sync(dev)
    dev_s = time.perf_counter() - t0
    hred, herr = f({"w": g.cpu()}, {"w": e.cpu()})
    if not (torch.equal(red["w"].cpu(), hred["w"])
            and torch.equal(err["w"].cpu(), herr["w"])):
        raise AssertionError("compressed reduce: the card's replica form "
                             "is not the CPU's bits")
    one = make_compressed_psum_grads(axis=0)(
        {"w": g[:1]}, {"w": e[:1]})
    with tempfile.TemporaryDirectory() as d:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.FileStore(
            f"{d}/store", 1), rank=0, world_size=1)
        try:
            fg = make_compressed_psum_grads(group=dist.group.WORLD)
            gred, gerr = fg({"w": g[0]}, {"w": e[0]})
            _sync(dev)
        finally:
            dist.destroy_process_group()
    if not (torch.equal(gred["w"], one[0]["w"][0])
            and torch.equal(gerr["w"], one[1]["w"][0])):
        raise AssertionError(f"compressed reduce: the {backend} form at "
                             f"world size 1 is not the replica form's")
    w = torch.full((2, 1), 1e-3 + 1e-6, device=dev)
    es = {"w": torch.zeros_like(w)}
    total = 0.0
    for _ in range(50):
        r, es = f({"w": w}, es)
        total += float(r["w"][0, 0])
    want = 50 * (1e-3 + 1e-6)
    if not abs(total - want) <= 1e-3 * want:
        raise AssertionError(f"error feedback: {total} after 50 steps, "
                             f"not {want}")
    del g, e, red, err, hred, herr
    free_card(dev)
    return {"replicas": R, "elements": n, "replica_bitwise_vs_cpu": True,
            "replica_s": dev_s, "group_backend": backend,
            "group_world_1_equals_replica": True,
            "feedback_sum_50": total, "feedback_want": want,
            "feedback_rel_err": abs(total - want) / want}


GPIPE_TOL = 1e-5


def check_gpipe(sz: Sizes, dev, seed: int) -> dict:
    """The GPipe schedule (``training/pipeline.py``) on ``dev``:
    ``sz.gpipe_stages`` stages of ``sz.gpipe_layers`` blocks at d_model
    ``sz.gpipe_d`` and d_ff ``sz.gpipe_ff``, ``sz.gpipe_micro``
    microbatches of [``sz.gpipe_batch``, ``sz.gpipe_seq``], f32, through
    ``make_gpipe_fn``, against the port's sequential stack on the same
    values: within GPIPE_TOL of the stack's max magnitude (f32 products
    batched over the stages against one block at a time).  Both times on
    the host clock, the device synced, after a warm-up call of each."""
    S, L, M = sz.gpipe_stages, sz.gpipe_layers, sz.gpipe_micro
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_pipeline_params(gen, n_stages=S, layers_per_stage=L,
                                  d_model=sz.gpipe_d, d_ff=sz.gpipe_ff)
    x = torch.randn((M, sz.gpipe_batch, sz.gpipe_seq, sz.gpipe_d),
                    generator=gen, device=dev)
    fn = make_gpipe_fn(S, device=dev)
    stage, times = _timer(dev)
    with torch.no_grad():
        fn(params, x)
        out = stage("pipelined_s", lambda: fn(params, x))
        flat = x.reshape((-1,) + tuple(x.shape[2:]))
        sequential_forward(params, flat)
        ref = stage("sequential_s", lambda: sequential_forward(
            params, flat)).reshape(x.shape)
    rel, scale, err = _scaled(out, ref)
    if not torch.isfinite(out).all() or not rel <= GPIPE_TOL:
        raise AssertionError(f"gpipe: {err} = {rel} x max|ref| {scale}, "
                             f"tol {GPIPE_TOL}")
    del params, x, out, ref
    free_card(dev)
    return {"stages": S, "layers_per_stage": L, "microbatches": M,
            "microbatch": [sz.gpipe_batch, sz.gpipe_seq],
            "d_model": sz.gpipe_d, "d_ff": sz.gpipe_ff, "dtype": "float32",
            "ticks": gpipe_ticks(M, S), "max_rel_err": rel,
            "max_abs_err": err, "tol": GPIPE_TOL, **times}


def ssd_inputs(dev, B, S, H, P, N, dtype, seed):
    """Model-like inputs (tests/test_kernels.py's distributions)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    xh = rnd(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, S, H))
    A = -torch.exp(rnd(H) * 0.3)
    return xh, dt, A, (rnd(B, S, N) * 0.5).to(dtype), \
        (rnd(B, S, N) * 0.5).to(dtype)


# the archs whose scan shapes check_ssd holds, and their keys' prefixes
SSD_ARCHS = {"zamba2-7b": "", "mamba2-370m": "mamba2_"}


def ssd_shape(sz: Sizes, arch: str) -> tuple:
    """(B, H, P, N, chunk) of an arch's scan at the model batch; 4 heads
    at a tiny size."""
    cfg = model_config(sz, arch)
    return (sz.model_batch, 4 if sz.model_tiny else cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)


def check_ssd(sz: Sizes, dev) -> dict:
    """ssd_scan's y and final state at the serve shapes of zamba2-7b
    (P = N = 64) and mamba2-370m (P = 64, N = 128: the wgmma passes at two
    64-column boxes of N, and the f32 kernel with its P split over
    blocks) against the plain
    chunked version computed in f32 on the same values and against the
    sequential ssd_ref (f32 arithmetic, y rounded to the input dtype):
    bf16 at 5e-2, f32 at 1e-4.  The reference's own bf16 chunked form
    rounds its scores, partial sums and carried state to bf16 where the
    kernel keeps f32; its distance to ssd_ref is reported beside the
    kernel's (``chunked_bf16_vs_ref``), not held to the tolerance."""
    errs = {}
    for arch, prefix in SSD_ARCHS.items():
        errs.update(_check_ssd_arch(sz, dev, arch, prefix))
    return errs


def _check_ssd_arch(sz: Sizes, dev, arch: str, prefix: str) -> dict:
    errs = {}
    B, H, P, N, Q = ssd_shape(sz, arch)
    for S in sz.check_lens:
        for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-4)):
            tag = f"{prefix}{str(dtype)[6:]}_S{S}"
            xh, dt, A, Bm, Cm = ssd_inputs(dev, B, S, H, P, N, dtype, S)
            y, final = ssd_scan(xh, dt, A, Bm, Cm, chunk=Q)
            cy, cfin = ssd_chunked(xh.float(), dt, A, Bm.float(),
                                   Cm.float(), Q)
            errs[f"{tag}_y_vs_chunked"] = _check_close(
                f"ssd {tag} y", y, cy, tol)
            errs[f"{tag}_state_vs_chunked"] = _check_close(
                f"ssd {tag} state", final, cfin, tol)
            # the sequential oracle on the kernel layout (padded chunks)
            pad = (-S) % Q
            C = (S + pad) // Q

            def lay(t):
                t = torch.nn.functional.pad(
                    t, (0, 0) * (t.dim() - 2) + (0, pad))
                return t.movedim(2, 1).reshape((B * H, C, Q) + t.shape[3:])
            dtk = lay(dt)
            bc = [t[:, :, None].expand(B, S, H, N) for t in (Bm, Cm)]
            ry, rstate = ssd_ref(lay(xh), dtk, dtk * A.repeat(B)[:, None,
                                                                  None],
                                 lay(bc[0]), lay(bc[1]))
            ry = ry.reshape(B, H, C * Q, P).movedim(1, 2)[:, :S]
            errs[f"{tag}_y_vs_ref"] = _check_close(f"ssd {tag} y vs ref", y,
                                                   ry, tol)
            errs[f"{tag}_state_vs_ref"] = _check_close(
                f"ssd {tag} state vs ref", final,
                rstate.reshape(B, H, P, N), tol)
            if dtype == torch.bfloat16:
                by, bfin = ssd_chunked(xh, dt, A, Bm, Cm, Q)
                errs[f"{tag}_chunked_bf16_vs_ref"] = max_err(by, ry)
                errs[f"{tag}_chunked_bf16_vs_kernel"] = max_err(by, y)
    return errs


# the SSD backward's tolerances, each gradient's max error over its max
# magnitude (as the flash backward's): bf16 rounds x, B, C and dy and
# splits the f32 operands of its products into two bf16 parts; f32 sums
# in another order
SSD_BWD_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}
SSD_BWD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def ssd_bwd_shapes(sz: Sizes) -> dict:
    """(B, S, H, P, N, chunk, with init_state) of the backward checks:
    mamba2-370m's and zamba2-7b's training microbatches, and a ragged S
    (``min(check_lens)``, not a multiple of the chunk) at zamba2's P and N
    with an init_state and a cotangent on the final state."""
    z = model_config(sz, "zamba2-7b")
    return {"mamba2_train": ssd_train_shape(sz, "mamba2-370m") + (False,),
            "zamba2_train": ssd_train_shape(sz, "zamba2-7b") + (False,),
            "ragged_init": (sz.model_batch, min(sz.check_lens), 8,
                            z.ssm_head_dim, z.ssm_state, z.ssm_chunk, True)}


def ssd_bwd_inputs(dev, B, S, H, P, N, dtype, seed) -> dict:
    """x, B and C as slices of one fused ``xBC`` [B, S, H P + 2 N] (the
    model's strides), dt, A, the cotangent dy, an init_state and a
    cotangent on the final state."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    return {"xbc": torch.cat([rnd(B, S, H * P), rnd(B, S, N) * 0.5,
                              rnd(B, S, N) * 0.5], -1).to(dtype),
            "dt": torch.nn.functional.softplus(rnd(B, S, H)),
            "A": -torch.exp(rnd(H) * 0.3), "dy": rnd(B, S, H, P).to(dtype),
            "init": rnd(B, H, P, N) * 0.5, "dfinal": rnd(B, H, P, N)}


def split_xbc(t: torch.Tensor, H: int, P: int, N: int):
    """x [B, S, H, P], B and C [B, S, N]: views of ``t``."""
    B, S, _ = t.shape
    return (t[..., :H * P].reshape(B, S, H, P), t[..., H * P:H * P + N],
            t[..., H * P + N:])


def _ssd_grads(scan, inp: dict, shape, cast=None) -> dict:
    """The gradients of ``scan`` (``ssd_scan``, or the plain chunked
    version) on ``inp`` (each leaf in ``cast``'s dtype where given) by
    ``torch.autograd.grad``, named as :func:`ssd_scan_bwd`'s."""
    B, S, H, P, N, Q, with_init = shape
    names = ("xbc", "dt", "A") + (("init",) if with_init else ())
    leaves = [(inp[n] if cast is None else inp[n].to(cast)).clone()
              .requires_grad_(True) for n in names]
    xs, bs, cs = split_xbc(leaves[0], H, P, N)
    y, final = scan(xs, leaves[1], leaves[2], bs, cs, chunk=Q,
                    init_state=leaves[3] if with_init else None)
    dy = inp["dy"] if cast is None else inp["dy"].to(cast)
    outs, cots = ((y, final), (dy, inp["dfinal"])) if with_init \
        else ((y,), (dy,))
    g = torch.autograd.grad(outs, leaves, cots)
    dx, dB, dC = split_xbc(g[0], H, P, N)
    return {"dx": dx, "ddt": g[1], "dA": g[2], "dB": dB, "dC": dC,
            "dinit": g[3] if with_init else None}


def check_ssd_bwd(sz: Sizes, dev) -> dict:
    """The SSD backward kernels, through ``ssd_scan``'s autograd Function
    on strided ``xBC`` slices, against the plain backward
    (``ssd_scan_bwd_plain``) and against autograd through the plain
    chunked version in f32 on the same values, at each of
    :func:`ssd_bwd_shapes` in bf16 and f32: every gradient (ddt and dA
    each on their own) within ``SSD_BWD_TOL * max|ref|`` with ``max|ref|
    > 0``, and a second call the same bits (no atomics).  Each shape
    reports its route and each pass's shared memory."""
    out = {}
    for key, shape in ssd_bwd_shapes(sz).items():
        B, S, H, P, N, Q, with_init = shape
        for dtype, tol in SSD_BWD_TOL.items():
            tag = f"{key}_{str(dtype)[6:]}"
            inp = ssd_bwd_inputs(dev, B, S, H, P, N, dtype, S + H)
            got, again = (_ssd_grads(ssd_scan, inp, shape)
                          for _ in range(2))
            if not all(torch.equal(got[n], again[n]) for n in got
                       if got[n] is not None):
                raise AssertionError(f"ssd bwd {tag}: two calls differ")
            xs, bs, cs = split_xbc(inp["xbc"].float(), H, P, N)
            plain = dict(zip(SSD_BWD_GRADS, ssd_scan_bwd_plain(
                xs, inp["dt"], inp["A"], bs, cs, inp["dy"].float(), chunk=Q,
                init_state=inp["init"] if with_init else None,
                dfinal=inp["dfinal"] if with_init else None)))
            auto = _ssd_grads(_plain_ssd_scan, inp, shape, torch.float32)
            errs = {}
            for n in SSD_BWD_GRADS:
                if got[n] is None:
                    continue
                for ref_name, w in (("plain", plain[n]),
                                    ("autograd", auto[n])):
                    rel, scale, err = _scaled(got[n], w)
                    if not scale > 0 or not rel <= tol:
                        raise AssertionError(
                            f"ssd bwd {tag} {n} vs {ref_name}: {err} = "
                            f"{rel} x max|ref| {scale}, tol {tol}")
                    errs[f"{n}_vs_{ref_name}"] = rel
                errs[f"{n}_max_abs_err"] = _scaled(got[n], plain[n])[2]
            out[tag] = {"shape": [B, S, H, P, N, Q], "init_state": with_init,
                        "route": "wgmma" if dtype == torch.bfloat16
                        else "scalar",
                        "smem_bytes": dict(zip(
                            ("delta", "chunk") if dtype == torch.bfloat16
                            else ("carry", "chunk"),
                            ssd_kernel.bwd_smem_bytes(Q, P, N, dtype))),
                        "bitwise_repeat": True, "tol": tol, **errs}
            del inp, got, again, plain, auto
    free_card(dev)
    return out


CONSISTENCY_TOL = 2e-3
# the families' archs held to prefill/decode consistency on the card
# (arctic-480b's one f32 layer alone is 56 GB: its parity is held on the
# CPU)
CONSISTENCY_ARCHS = ("qwen2-moe-a2.7b", "mamba2-370m", "whisper-medium",
                     "internvl2-26b", "qwen1.5-32b", "gemma3-27b")


def check_consistency(sz: Sizes, dev, seed: int,
                      arch: str = "zamba2-7b") -> dict:
    """prefill(prompt[:S]) + decode_step(token S) -- the plain recurrent
    SSD step and decode attention -- against the last logits of
    prefill(prompt[:S+1]), which runs the kernels on a ragged length, in
    f32 at full width and ``consistency_layers`` deep.  Tolerance
    CONSISTENCY_TOL (abs and rel): the two sides sum in other orders
    (chunked scan against recurrence, blocked softmax against one softmax)
    and the differences grow through the layers, far below this bound in
    f32; a wrong mask, state or cache would move logits by O(1).  A
    dense ``arch`` has no SSD: its decode step runs decode attention
    against the cache that prefill filled through ``flash_attention``.
    A VLM's vision prefix and an encoder-decoder's frames are drawn from
    the frontend stubs; a MoE's capacity factor is raised to
    ``n_experts / top_k``, so that no token is dropped (with drops, S + 1
    tokens may route otherwise than S tokens and one step)."""
    cfg = no_drops(model_config(sz, arch, n_layers=sz.consistency_layers,
                                param_dtype="float32",
                                compute_dtype="float32"))
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    params = model.init(gen)
    S = max(sz.prompt_lens)
    pre = prefix_tokens(cfg)
    extra = synth_inputs(cfg, 2, gen)
    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, size=(2, S + 1)), device=dev)
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": toks[:, :S], **extra},
                                  pre + S + 1)
        dec, _ = model.decode_step(params, toks[:, S], caches, pre + S)
        full, _ = model.prefill(params, {"tokens": toks, **extra},
                                pre + S + 1)
    err = _check_close(f"{arch} prefill/decode consistency", dec[:, 0],
                       full[:, 0], CONSISTENCY_TOL)
    del params, caches
    free_card(dev)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "S": S, "max_abs_err": err,
           "tol": CONSISTENCY_TOL,
           "max_abs_logit": float(full[..., :cfg.vocab].abs().max())}
    if cfg.family == "hybrid":
        out["shared_attn_calls"] = cfg.n_layers // cfg.shared_attn_every
    if cfg.n_experts:
        out["capacity_factor"] = cfg.capacity_factor
    return out


# --------------------------------------------------------------------- #
# ordered, migrate and crash phases (no kernel of their own: plain torch  #
# on the card, held against host oracles)                                #
# --------------------------------------------------------------------- #
class CrashAtPublish(CrashPlan):
    """A crash plan that fires at the publish of one named file."""

    def __init__(self, target: str, **kw):
        super().__init__(**kw)
        self.target = target

    def on_site(self, kind: str, target: str = "") -> None:
        if self.fired_at is None and (kind, target) == ("publish",
                                                        self.target):
            self.crash_at = len(self.sites)
        super().on_site(kind, target)


def plan_steps() -> int:
    """Frontier-walk steps the ordered plan has taken so far."""
    return get_registry().counter("ordered_plan_steps_total").value


def range_bounds(sz: Sizes, seed: int):
    """``sz.ranges`` zipf-placed spans over ``[1, 2*prefill)``, as in the
    reference's ordered bench (lo from a zipf draw, widths 50-2000)."""
    rng = np.random.default_rng(seed + 7)
    span = 2 * sz.prefill
    lo = ((rng.zipf(1.3, sz.ranges) * 37) % span).astype(np.int64)
    hi = lo + rng.integers(50, 2000, sz.ranges)
    return lo.astype(np.int32), np.minimum(hi, O.KEY_PAD - 1).astype(
        np.int32)


def run_ordered(sz: Sizes, stream: dict, dev, seed: int) -> dict:
    """The map phase's stream on the ordered map at the same scale: the
    prefill and the mixed rounds through ``update_parallel_ordered`` (the
    towers rebuilt after every batch, as the durable map does), the
    rounds' lookups, then one batch of range reads, a scan and a top-k.
    Returns every result the checks read and the stage times."""
    dev = B.resolve_device(dev)
    stage, times = _timer(dev)
    out = {"ok": [], "lookups": [], "steps": {}}
    st = stage("make_state", lambda: O.make_ordered(sz.capacity, dev))
    tw = stage("towers_empty", lambda: O.build_towers(st))
    pre = stream["prefill"]
    s0 = plan_steps()
    st, ok, _ = stage("prefill", lambda: O.update_parallel_ordered(
        st, np.zeros_like(pre), pre, pre, towers=tw))
    out["steps"]["prefill"] = plan_steps() - s0
    out["prefill_ok"] = ok
    tw = stage("towers_prefill", lambda: O.build_towers(st))
    for ratio, (ops, ks, vs, look) in zip(sz.ratios, stream["rounds"]):
        out["before_last"] = (st, tw)
        s0 = plan_steps()
        st, ok, _ = stage(f"update_{ratio}", lambda: O.update_parallel_ordered(
            st, ops, ks, vs, towers=tw))
        out["steps"][f"update_{ratio}"] = plan_steps() - s0
        out["ok"].append(ok)
        tw = stage(f"towers_{ratio}", lambda: O.build_towers(st))
        s0 = plan_steps()
        out["lookups"].append(stage(f"lookup_{ratio}", lambda:
                                    O.lookup_ordered(st, look, tw)))
        out["steps"][f"lookup_{ratio}"] = plan_steps() - s0
    lo, hi = range_bounds(sz, seed)
    s0 = plan_steps()
    out["ranges"] = stage("range", lambda: O.range_query(
        st, lo, hi, sz.max_items, tw))
    out["steps"]["range"] = plan_steps() - s0
    out["scan"] = stage("scan", lambda: O.scan(st, sz.max_items, tw))
    out["top_k"] = stage("top_k", lambda: O.top_k(st, sz.top_k))
    # the last round again, warm, from the same state and towers
    st0, tw0 = out.pop("before_last")
    ops, ks, vs, _ = stream["rounds"][-1]
    again = stage(f"update_{sz.ratios[-1]}_warm",
                  lambda: O.update_parallel_ordered(st0, ops, ks, vs,
                                                    towers=tw0))
    same_arrays(again[0], st, "the warm round")
    out.update(state=st, towers=tw, bounds=(lo, hi), times=times)
    return out


def check_ordered(sz: Sizes, stream: dict, out: dict) -> dict:
    """The ordered phase against the host oracles: ``oracle_apply`` for
    the ok flags, the lookups and every node (live and dead), the per-op
    law for the accounting, the sorted live keys for every range read
    (``oracle_range`` literally on two of them), ``check_sorted``, and
    ``update_parallel_ordered`` against ``apply_ordered`` on a 4096-op
    batch, field by field.  Raises on the first failure."""
    host = lambda t: t.cpu().numpy()  # noqa: E731
    items: dict = {}
    n_ok = 0
    pre = stream["prefill"]
    want = O.oracle_apply(items, np.zeros_like(pre), pre, pre, sz.capacity)
    if host(out["prefill_ok"]).tolist() != want:
        raise AssertionError("ordered prefill ok flags differ")
    n_ok += sum(want)
    for i, (ops, ks, vs, look) in enumerate(stream["rounds"]):
        want = O.oracle_apply(items, ops, ks, vs, sz.capacity)
        if host(out["ok"][i]).tolist() != want:
            raise AssertionError(f"ordered round {i}: ok flags differ")
        n_ok += sum(want)
        cells = [items.get(k, (False, 0)) for k in look.tolist()]
        found, vals = out["lookups"][i]
        if host(found).tolist() != [c[0] for c in cells] or \
                host(vals).tolist() != [c[1] if c[0] else 0 for c in cells]:
            raise AssertionError(f"ordered round {i}: lookups differ")
    st = out["state"]
    if O.items_host(st) != items:
        raise AssertionError("ordered chain differs from oracle_apply")
    O.check_sorted(st)
    # fresh 2 flushes, resurrect/delete 1, 2 fences: one node per key
    if (int(st.flushes), int(st.fences)) != (len(items) + n_ok, 2 * n_ok):
        raise AssertionError("ordered flush/fence accounting differs")

    live = sorted((k, v) for k, (lv, v) in items.items() if lv)
    lk = np.asarray([k for k, _ in live], np.int64)
    lv = np.asarray([v for _, v in live], np.int64)

    def expect(lo, hi, m):
        a, b = np.searchsorted(lk, lo), np.searchsorted(lk, hi, "right")
        n = min(b - a, m)
        keys = np.full(m, O.KEY_PAD, np.int64)
        vals = np.zeros(m, np.int64)
        keys[:n], vals[:n] = lk[a:a + n], lv[a:a + n]
        return b - a, keys, vals

    lo, hi = out["bounds"]
    total, keys, vals = (host(t) for t in out["ranges"])
    for i in range(sz.ranges):
        t, k, v = expect(int(lo[i]), int(hi[i]), sz.max_items)
        if total[i] != t or not (np.array_equal(keys[i], k)
                                 and np.array_equal(vals[i], v)):
            raise AssertionError(f"range [{lo[i]}, {hi[i]}] differs")
    for i in (0, sz.ranges - 1):
        lit = O.oracle_range(items, int(lo[i]), int(hi[i]))
        if lit[:sz.max_items] != list(zip(keys[i][:len(lit)].tolist(),
                                          vals[i][:len(lit)].tolist())):
            raise AssertionError("range differs from oracle_range")
    t, k, v = expect(O.KEY_MIN + 1, O.KEY_PAD - 1, sz.max_items)
    st_t, st_k, st_v = (host(x) for x in out["scan"])
    if st_t != t or not (np.array_equal(st_k, k) and np.array_equal(st_v, v)):
        raise AssertionError("scan differs from the sorted live set")
    cnt, tk, tv = (host(x) for x in out["top_k"])
    if cnt != min(sz.top_k, len(live)) or \
            tk[:cnt].tolist() != lk[-sz.top_k:].tolist() or \
            tv[:cnt].tolist() != lv[-sz.top_k:].tolist():
        raise AssertionError("top_k differs from the largest live keys")

    # the plan/commit engine against the sequential oracle
    ops, ks, vs = (np.asarray(a) for a in stream["check"])
    ks = ks * (2 * sz.prefill // (sz.check_ops // 2))   # across the map
    t0 = time.perf_counter()
    st_p, ok_p, stats = O.update_parallel_ordered(st, ops, ks, vs,
                                                  towers=out["towers"])
    st_o, ok_o = O.apply_ordered(st, ops, ks, vs)
    if not torch.equal(ok_p, ok_o):
        raise AssertionError("update_parallel_ordered ok flags differ "
                             "from apply_ordered")
    same_arrays(st_p, st_o, "update_parallel_ordered vs apply_ordered")
    return {"live_keys": len(live), "nodes": len(items),
            "flushes": int(st.flushes), "fences": int(st.fences),
            "range_hits": int(total.sum()),
            "check_ops_committed": int(stats.ops_committed),
            "check_max_group": int(stats.max_group),
            "engine_vs_oracle_s": time.perf_counter() - t0}


def dur_batches(sz: Sizes, seed: int) -> list:
    """The durable map's input: a prefill batch of ``dur_keys`` inserts,
    then ``dur_batches`` mixed batches (half inserts, half deletes, keys
    uniform in ``[1, 2*dur_keys)``)."""
    rng = np.random.default_rng(seed + 11)
    pre = np.arange(1, sz.dur_keys + 1, dtype=np.int32)
    out = [(np.zeros_like(pre), pre, pre * 3)]
    for _ in range(sz.dur_batches):
        out.append((rng.integers(0, 2, sz.dur_batch).astype(np.int32),
                    rng.integers(1, 2 * sz.dur_keys,
                                 sz.dur_batch).astype(np.int32),
                    rng.integers(0, 1 << 20, sz.dur_batch).astype(
                        np.int32)))
    return out


def run_durable_ordered(sz: Sizes, dev, seed: int) -> dict:
    """``DurableOrderedMap``: the batches journaled, a snapshot after the
    4th mixed batch, a crash (``evict="random"``) at the publish of the
    7th mixed batch, recovery, and the rest of the batches.  The
    recovered map must hold exactly the acknowledged batches, equal an
    uncrashed twin at that boundary array for array (towers included),
    and finish equal to the twin and to ``oracle_apply``."""
    dev = B.resolve_device(dev)
    batches = dur_batches(sz, seed)
    crash_at, snap_after = 7, 4        # batch indices; 0 is the prefill
    stage, times = _timer(dev)
    with tempfile.TemporaryDirectory() as d:
        root = Path(d) / "map"
        m = O.DurableOrderedMap(root, capacity=sz.dur_capacity, device=dev)
        twin = O.DurableOrderedMap(Path(d) / "twin",
                                   capacity=sz.dur_capacity, device=dev)
        plan = CrashAtPublish(f"ord_{crash_at:06d}.json", evict="random",
                              seed=seed).attach(m.io)
        acked = []
        for b, (ops, ks, vs) in enumerate(batches[:crash_at + 1]):
            if b < crash_at:
                twin.update(ops, ks, vs)
            try:
                stage(f"batch_{b}", lambda: m.update(ops, ks, vs))
            except CrashPoint:
                break
            acked.append(b)
            if b == snap_after:
                stage("snapshot", m.snapshot)
        boundary = (twin.state, twin.towers)
        if plan.fired_at is None or acked != list(range(crash_at)):
            raise AssertionError(f"the crash did not fire at batch "
                                 f"{crash_at}: acked {acked}")
        # exactly once: the durable batches are the acked ones, verbatim
        horizon, durable = 0, []
        for p in sorted(root.glob("osnap_*.json")):
            horizon = max(horizon, int(json.loads(p.read_text())["horizon"]))
        for p in sorted(root.glob("ord_*.json")):
            if int(p.name[4:-5]) >= horizon:
                durable.append(json.loads(p.read_text()))
        want = [{"ops": o.tolist(), "ks": k.tolist(), "vs": v.tolist()}
                for o, k, v in batches[horizon:crash_at]]
        if horizon + len(durable) != crash_at or durable != want:
            raise AssertionError("durable batches differ from the acked "
                                 "ones")
        journal_bytes = sum(p.stat().st_size for p in root.iterdir())
        rec = stage("recover", lambda: O.DurableOrderedMap(
            root, capacity=sz.dur_capacity, device=dev))
        if rec._n != crash_at:
            raise AssertionError(f"recovered {rec._n} batches, "
                                 f"{crash_at} acked")
        same_arrays(rec.state, boundary[0], "recovered map vs the twin")
        same_arrays(rec.towers, boundary[1], "recovered towers vs the twin")
        for b in range(crash_at, len(batches)):
            twin.update(*batches[b])
            stage(f"batch_{b}_after", lambda: rec.update(*batches[b]))
        items: dict = {}
        for ops, ks, vs in batches:
            O.oracle_apply(items, ops, ks, vs, sz.dur_capacity)
        same_arrays(rec.state, twin.state, "finished map vs the twin")
        if rec.items() != items:
            raise AssertionError("durable map differs from oracle_apply")
        O.check_sorted(rec.state)
        return {"capacity": sz.dur_capacity, "keys": sz.dur_keys,
                "batches": len(batches), "crash_batch": crash_at,
                "crash_site": dataclasses.asdict(plan.fired_at),
                "snapshot_horizon": horizon, "journal_bytes": journal_bytes,
                "live_keys": len(O.live_items(rec.state)),
                "stage_s": times}


def mig_stream(sz: Sizes, seed: int) -> dict:
    """The migrate phase's input: the prefill, a mixed round on the
    prefilled keys (so some are deleted), the batch of fresh keys that
    does not fit, and mixed rounds over old and fresh keys (half of each
    round updates, inserts and deletes alike; the other half lookups)."""
    rng = np.random.default_rng(seed + 13)
    top = sz.mig_prefill + sz.mig_fresh
    n_upd = sz.mig_round_ops // 2

    def mixed(hi):
        return (rng.integers(0, 2, n_upd).astype(np.int32),
                rng.integers(1, hi + 1, n_upd).astype(np.int32),
                rng.integers(0, 1 << 20, n_upd).astype(np.int32),
                rng.integers(1, hi + 1, n_upd).astype(np.int32))

    pre = np.arange(1, sz.mig_prefill + 1, dtype=np.int32)
    fresh = np.arange(sz.mig_prefill + 1, top + 1, dtype=np.int32)
    return {"prefill": pre, "before": mixed(sz.mig_prefill),
            "fresh": fresh,
            "rounds": [mixed(top) for _ in range(sz.mig_crash_round // 2
                                                 + 1)]}


def _replay_map(cells: dict, ops, ks, vs) -> list:
    """Host dict replay of one batch ({key: [live, val]}); per-op ok."""
    ok = []
    for op, k, v in zip(ops.tolist(), ks.tolist(), vs.tolist()):
        c = cells.get(k)
        if op == B.OP_INSERT:
            ok.append(c is None or not c[0])
            if ok[-1]:
                cells[k] = [True, v]
        else:
            ok.append(c is not None and c[0])
            if ok[-1]:
                c[0] = False
    return ok


def run_migrate(sz: Sizes, dev, seed: int) -> dict:
    """A journaled ``MigratingMap`` grows under live traffic and crashes
    (``evict="random"``) at the publish of its 9th journaled round.
    ``MigratingMap.recover`` must equal an uncrashed twin at that round
    boundary, array for array; it then finishes the migration equal to
    the twin and to a host dict replay of every acknowledged op.  Every
    user op's ok flag and every lookup is held against the replay too."""
    if sz.mig_crash_round % 2:
        raise ValueError("the crash round must be a drain round: each "
                         "update journals a drain round, then its own")
    dev = B.resolve_device(dev)
    s = mig_stream(sz, seed)
    stage, times = _timer(dev)
    cells: dict = {}
    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        kw = dict(capacity=sz.mig_capacity, n_buckets=sz.mig_buckets,
                  buckets_per_round=sz.mig_bpr, device=dev)
        m = MigratingMap(root=root, **kw)
        twin = MigratingMap(**kw)
        crash_name = f"mig_0001/round_{sz.mig_crash_round:06d}.npz"
        plan = CrashAtPublish(crash_name, evict="random",
                              seed=seed).attach(m.io)

        def step(name, ops, ks, vs, look=None):
            """One user batch through the twin and the map (the map's
            call timed), ok flags and lookups held against the replay."""
            want = _replay_map(cells, ops, ks, vs)
            got = (twin.update(ops, ks, vs),
                   stage(name, lambda: m.update(ops, ks, vs)))
            if any(g.tolist() != want for g in got):
                raise AssertionError(f"{name}: ok flags differ from the "
                                     f"replay")
            if look is None:
                return
            c = [cells.get(k, [False, 0]) for k in look.tolist()]
            want = ([x[0] for x in c], [x[1] if x[0] else 0 for x in c])
            for mm in (twin, m):
                if tuple(r.tolist() for r in mm.lookup(look)) != want:
                    raise AssertionError(f"{name}: lookups differ")

        pre, fresh = s["prefill"], s["fresh"]
        step("prefill", np.zeros_like(pre), pre, pre)
        step("mixed_before", *s["before"])
        step("grow", np.zeros_like(fresh), fresh, fresh * 3)
        if not m.migrating or m._mig["cap_new"] != 2 * sz.mig_capacity:
            raise AssertionError("the fresh batch did not open growth to "
                                 "twice the pool")
        crashed = None
        for i, (ops, ks, vs, look) in enumerate(s["rounds"]):
            if m._mig["n_rounds"] + 2 <= sz.mig_crash_round:
                step(f"round_{i}", ops, ks, vs, look)
                continue
            try:                             # this update's drain round
                m.update(ops, ks, vs)        # is the crash round
            except CrashPoint as e:
                crashed = e.site
                break
            raise AssertionError("the crash did not fire")
        if crashed is None:
            raise AssertionError("the rounds ended before the crash round")
        pulls = m.pulls_total
        journal_bytes = sum(p.stat().st_size for p in root.rglob("*")
                            if p.is_file())
        rec = stage("recover", lambda: MigratingMap.recover(root,
                                                           device=dev))
        mg, tm = rec._mig, twin._mig
        at_crash = {k: mg[k] for k in ("frontier", "n_rounds",
                                       "remaining_live")}
        t0 = time.perf_counter()
        drained = live_chain_nodes(mg["old_host"], 0, mg["frontier"]).size
        times["drained_count"] = time.perf_counter() - t0
        if at_crash != {k: tm[k] for k in at_crash}:
            raise AssertionError("recovered frontier/rounds/reserve differ "
                                 "from the twin")
        same_arrays(mg["new"], tm["new"], "recovered new table vs the twin")
        same_arrays(rec.state, twin.state, "recovered old table vs the twin")
        rep = stage("finish", rec.run_migration)
        twin.run_migration()
        same_arrays(rec.state, twin.state, "finished table vs the twin")
        live = {k: v for k, (lv, v) in rec.items().items() if lv}
        if live != {k: c[1] for k, c in cells.items() if c[0]}:
            raise AssertionError("finished map differs from the replay")
        return {"old": [sz.mig_capacity, sz.mig_buckets],
                "new": [rec.capacity, rec.n_buckets],
                "crash_site": dataclasses.asdict(crashed),
                "recovered": at_crash,
                "journal_bytes": journal_bytes, "pulls": pulls,
                "drained_keys": int(drained), "live_keys": len(live),
                "finish_rounds": rep.rounds, "stage_s": times}


# --------------------------------------------------------------------- #
# sharded and checkpoint phases                                          #
# --------------------------------------------------------------------- #
def node_table(host: dict) -> np.ndarray:
    """Every allocated node of a host state as sorted ``(key, live, val)``
    rows: one map's arrays, or a sharded map's stacked ones (a key holds
    at most one node in the whole map, so the table is canonical)."""
    key, live, val = (np.atleast_2d(host[f]) for f in ("key", "live",
                                                        "val"))
    rows = [np.stack([key[s, 1:c], live[s, 1:c], val[s, 1:c]], 1)
            for s, c in enumerate(np.atleast_1d(host["cursor"]))]
    t = np.concatenate(rows).astype(np.int64)
    return t[np.argsort(t[:, 0], kind="stable")]


def run_sharded(sz: Sizes, stream: dict, single: dict, dev) -> dict:
    """The map phase's stream on a ``ShardedDurableMap`` of ``sz.shards``
    shards (the same total pool and buckets, split evenly), held against
    the single-device run: per-op ok, per-bucket flushes, no foreign op,
    every round's lookups and 2^20 more, flush/fence totals and every
    node.  Returns the stage times and each round's share spent in the
    per-shard engine loop."""
    stage, times = _timer(dev)
    m = stage("make", lambda: ShardedDurableMap(
        sz.shards, capacity=sz.capacity, n_buckets=sz.n_buckets,
        device=dev))
    host = lambda t: t.cpu().numpy()  # noqa: E731
    loop = {}

    def round_(name, want_ok, want_bf, ops, ks, vs):
        l0 = m.loop_s
        ok, st = stage(name, lambda: m.update(ops, ks, vs))
        loop[name] = (m.loop_s - l0) / times[name]
        if not np.array_equal(ok, host(want_ok)):
            raise AssertionError(f"sharded {name}: ok flags differ")
        if not np.array_equal(st.bucket_flushes, host(want_bf)):
            raise AssertionError(f"sharded {name}: bucket flushes differ")
        if st.foreign_ops.any():
            raise AssertionError(f"sharded {name}: foreign ops "
                                 f"{st.foreign_ops.tolist()}")

    pre = stream["prefill"]
    round_("prefill", single["prefill_ok"], single["bucket_flushes"][0],
           np.zeros_like(pre), pre, pre)
    for i, (ratio, (ops, ks, vs, look)) in enumerate(
            zip(sz.ratios, stream["rounds"])):
        round_(f"update_{ratio}", single["ok"][i],
               single["bucket_flushes"][i + 1], ops, ks, vs)
        got = stage(f"lookup_{ratio}", lambda: m.lookup(look))
        if not all(np.array_equal(g, host(w))
                   for g, w in zip(got, single["lookups"][i])):
            raise AssertionError(f"sharded round {ratio}%: lookups differ")
    q = stream["queries"]
    got = stage("lookup_queries", lambda: m.lookup(q))
    qt = torch.as_tensor(q, device=dev)
    want = stage("lookup_queries_single", lambda: B.lookup(
        single["state"], qt, sz.n_buckets))
    if not all(np.array_equal(g, host(w)) for g, w in zip(got, want)):
        raise AssertionError("sharded lookups of the queries differ")
    st = single["state"]
    if (m.flushes, m.fences) != (int(st.flushes), int(st.fences)):
        raise AssertionError("sharded flush/fence totals differ")
    t0 = time.perf_counter()
    if not np.array_equal(node_table(m.host()),
                          node_table(B.state_to_numpy(st))):
        raise AssertionError("sharded nodes differ from the single map's")
    times["node_check"] = time.perf_counter() - t0
    return {"shards": sz.shards, "splits": list(m.splits),
            "cursors": m.cursors.tolist(), "flushes": m.flushes,
            "fences": m.fences, "chain": list(m.chain_stats()),
            "stage_s": times, "loop_share": loop}


def reb_stream(sz: Sizes, seed: int) -> list:
    """The live-rebalance rounds: half updates (inserts and deletes
    alike), half lookups, every key a zipf(1.3) rank over the keys
    ``[1, 2*reb_prefill)`` ordered by bucket, so the hottest keys sit in
    the lowest buckets, shard 0's range under the even split."""
    rng = np.random.default_rng(seed + 17)
    domain = np.arange(1, 2 * sz.reb_prefill, dtype=np.int32)
    by_bucket = domain[np.argsort(B.bucket_of_np(domain, sz.n_buckets),
                                  kind="stable")]

    def draw(n):
        return by_bucket[np.minimum(rng.zipf(1.3, n), domain.size) - 1]

    n_upd = sz.reb_round_ops // 2
    return [(rng.integers(0, 2, n_upd).astype(np.int32), draw(n_upd),
             rng.integers(0, 1 << 20, n_upd).astype(np.int32),
             draw(sz.reb_round_ops - n_upd))
            for _ in range(sz.reb_rounds + sz.reb_post)]


def reb_gauges(n_shards: int) -> dict:
    reg = get_registry()
    return {"map_shard_load": [reg.gauge("map_shard_load",
                                         shard=str(s)).value
                               for s in range(n_shards)],
            "map_load_imbalance": reg.gauge("map_load_imbalance").value,
            "map_trigger_imbalance":
                reg.gauge("map_trigger_imbalance").value}


def run_live_rebalance(sz: Sizes, dev, seed: int) -> dict:
    """A journaled ``RebalancingShardedMap`` of ``sz.shards`` shards
    (the map phase's pool and buckets, ``reb_prefill`` keys) beside an
    uncrashed twin, the auto policy armed after the prefill, under
    zipf-skewed rounds.  The policy must trigger; the map crashes
    (``evict="random"``) at the publish of its journal's round
    ``reb_crash_round``; ``recover`` must equal the twin at that boundary,
    then take the rest of the rounds and the post rounds (policy
    disarmed) equal to the twin and to a host dict replay, with the final
    load imbalance at most the trigger's."""
    rounds = reb_stream(sz, seed)
    stage, times = _timer(dev)
    policy = AutoRebalancePolicy(threshold=1.3,
                                 min_load=sz.reb_round_ops // 4,
                                 check_every=2,
                                 buckets_per_round=sz.reb_bpr)
    kw = dict(capacity=sz.capacity, n_buckets=sz.n_buckets,
              rounds_per_update=2, device=dev)
    cells: dict = {}
    round_s = {"steady": [], "rebalancing": []}
    get_registry().reset()
    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        m = RebalancingShardedMap(sz.shards, root=root, seed=seed, **kw)
        twin = RebalancingShardedMap(sz.shards, **kw)
        pre = np.arange(1, sz.reb_prefill + 1, dtype=np.int32)
        stage("prefill", lambda: m.insert(pre, pre * 3))
        twin.insert(pre, pre * 3)
        for x in (m, twin):
            # arm the policy on the skewed traffic, not the uniform prefill
            x.policy = policy
            x.loads[:] = 0
        _replay_map(cells, np.zeros_like(pre), pre, pre * 3)
        plan = CrashAtPublish(f"reb_0001/round_{sz.reb_crash_round:06d}.npz",
                              evict="random", seed=seed).attach(m.io)

        def step(mm, i, ops, ks, vs, look, want_ok, timed):
            """One round on ``mm``, its ok flags and lookups held against
            the replay (already advanced by this round)."""
            busy = mm.rebalancing
            t0 = time.perf_counter()
            ok, _ = mm.update(ops, ks, vs)
            _sync(dev)
            if timed:
                round_s["rebalancing" if busy or mm.rebalancing
                        else "steady"].append(time.perf_counter() - t0)
            if ok.tolist() != want_ok:
                raise AssertionError(f"rebalance round {i}: ok flags "
                                     f"differ from the replay")
            c = [cells.get(k, [False, 0]) for k in look.tolist()]
            f, v = mm.lookup(look)
            if f.tolist() != [x[0] for x in c] or \
                    v.tolist() != [x[1] if x[0] else 0 for x in c]:
                raise AssertionError(f"rebalance round {i}: lookups differ")

        crashed = None
        for i, (ops, ks, vs, look) in enumerate(rounds[:sz.reb_rounds]):
            saved = {k: list(cells[k]) for k in set(ks.tolist())
                     if k in cells}
            want_ok = _replay_map(cells, ops, ks, vs)
            try:
                step(m, i, ops, ks, vs, look, want_ok, True)
            except CrashPoint as e:
                crashed = (i, e.site)
                for k in set(ks.tolist()):       # not acked: undo it
                    cells.pop(k, None)
                cells.update(saved)
                break
            step(twin, i, ops, ks, vs, look, want_ok, False)
            if m.rebalancing and "gauges_at_trigger" not in times:
                times["gauges_at_trigger"] = reb_gauges(sz.shards)
        if crashed is None:
            raise AssertionError("the crash round was never journaled")
        if twin.rebalances_completed + twin.rebalancing < 1:
            raise AssertionError("the policy never triggered")
        trigger = twin.last_trigger_imbalance
        journal_bytes = sum(p.stat().st_size for p in root.rglob("*")
                            if p.is_file())
        rec = stage("recover", lambda: RebalancingShardedMap.recover(
            root, sz.shards, seed=seed, rounds_per_update=2, policy=policy,
            device=dev))
        # the crashed update had published its first drain rounds: the
        # twin drains as far to reach the same round boundary
        while twin._reb["n_rounds"] < rec._reb["n_rounds"]:
            twin.rebalance_round()
        if (rec.frontier, rec.splits) != (twin.frontier, twin.splits) or \
                rec._reb["remaining"].tolist() != \
                twin._reb["remaining"].tolist():
            raise AssertionError("recovered frontier/splits/reserve differ "
                                 "from the twin")
        same_arrays(rec._reb["new"].state, twin._reb["new"].state,
                    "recovered new map vs the twin")
        same_arrays(rec.map.state, twin.map.state,
                    "recovered frozen map vs the twin")
        at_crash = {"round": crashed[0], "frontier": rec.frontier,
                    "splits_new": list(rec.splits),
                    "site": dataclasses.asdict(crashed[1])}
        for j, (ops, ks, vs, look) in enumerate(rounds[crashed[0]:],
                                                crashed[0]):
            if j == sz.reb_rounds:       # the post rounds: disarmed
                for x in (rec, twin):
                    if x.rebalancing:
                        stage("finish", x.run_rebalance)
                    x.policy = None
            want_ok = _replay_map(cells, ops, ks, vs)
            step(rec, j, ops, ks, vs, look, want_ok, True)
            step(twin, j, ops, ks, vs, look, want_ok, False)
        same_arrays(rec.map.state, twin.map.state, "finished map vs twin")
        want = np.asarray(sorted((k, c[1]) for k, c in cells.items()
                                 if c[0]), np.int64).reshape(-1, 2)
        t = node_table(rec.map.host())
        if not np.array_equal(t[t[:, 1] == 1][:, [0, 2]], want):
            raise AssertionError("rebalanced map differs from the replay")
        after = reb_gauges(sz.shards)
        if after["map_load_imbalance"] > trigger:
            raise AssertionError(f"final imbalance "
                                 f"{after['map_load_imbalance']} above "
                                 f"the trigger's {trigger}")
        return {"prefill": sz.reb_prefill, "rounds": len(rounds),
                "round_ops": sz.reb_round_ops, "bpr": sz.reb_bpr,
                "rebalances": twin.rebalances_completed,
                "drain_rounds": twin.rounds_total,
                "pulls": twin.pulls_total, "trigger_imbalance": trigger,
                "gauges_at_trigger": times.pop("gauges_at_trigger"),
                "gauges_after": after, "splits": list(rec.splits),
                "crash": at_crash, "journal_bytes": journal_bytes,
                "reduced": [f"prefill 2^22 -> {sz.reb_prefill} keys: "
                            "the split that isolates zipf's hot buckets "
                            "puts nearly every live key in one shard, "
                            "whose pool is a quarter of the map's"],
                "round_s": {k: {"n": len(v),
                                "median": float(np.median(v)) if v else
                                None, "max": max(v, default=None)}
                            for k, v in round_s.items()},
                "stage_s": times}


# --------------------------------------------------------------------- #
# load phase: LoadScope (obs/loadgen.py) against the card's log + engine  #
# --------------------------------------------------------------------- #
def load_kw(sz: Sizes) -> dict:
    """The fields every log point shares."""
    return dict(update_frac=0.6, batch=sz.load_batch, retain=sz.load_retain,
                capacity=sz.load_capacity, snapshot_every=20,
                window_us=50_000.0, warmup_ops=6)


def load_log_specs(sz: Sizes) -> dict:
    """The log points' specs but the open one, whose rate comes from
    closed_zipf1.1's run (:func:`open_spec`)."""
    kw = load_kw(sz)
    closed = dict(kw, n_ops=sz.load_ops)
    return {
        "closed_zipf1.1": LoadSpec(seed=11, dist="zipf", skew=1.1, **closed),
        "closed_zipf1.5": LoadSpec(seed=11, dist="zipf", skew=1.5, **closed),
        "closed_uniform": LoadSpec(seed=17, dist="uniform", **closed),
        "closed_crash": LoadSpec(seed=19, dist="zipf", skew=1.3,
                                 crash_at_op=sz.load_ops // 2,
                                 crash_evict="torn", **closed),
        "closed_zipf1.3_shards4": LoadSpec(
            seed=23, dist="zipf", skew=1.3, shards=4, rebalance=True,
            **dict(kw, n_ops=sz.load_open_ops)),
    }


def open_spec(sz: Sizes, closed_ops_s: float) -> LoadSpec:
    """open_zipf1.3 paced at half the op rate closed_zipf1.1 sustained
    (``sustained_ops_s`` counts rids, a op commits or probes a batch)."""
    return LoadSpec(seed=13, dist="zipf", skew=1.3, mode="open",
                    n_ops=sz.load_open_ops,
                    rate_ops_s=closed_ops_s / sz.load_batch / 2,
                    **load_kw(sz))


# benchmarks/loadtest.py:_engine_point's spec and engine
ENGINE_SPEC = LoadSpec(n_ops=60, seed=29, dist="zipf", skew=1.3,
                       update_frac=0.5, batch=2, window_us=100_000.0,
                       retain=64, snapshot_every=None, warmup_ops=3)
ENGINE_KW = dict(max_len=24, batch_size=2, retain=64, snapshot_every=10)


def acked_rids(spec: LoadSpec) -> list:
    """The rids a log point acknowledged, in order: the harness commits
    ``batch`` fresh rids per warm-up op and per scheduled update."""
    n = max(1, spec.warmup_ops) + int(make_schedule(spec).is_update.sum())
    return list(range(n * spec.batch))


def check_load_report(name: str, spec: LoadSpec, rep: dict) -> None:
    if rep["schedule_fingerprint"] != make_schedule(spec).fingerprint():
        raise AssertionError(f"{name}: schedule fingerprint differs")
    if sum(r["count"] for r in rep["series"]) != spec.n_ops:
        raise AssertionError(f"{name}: series counts do not sum to n_ops")
    if not rep["p99_us"] >= rep["p50_us"] > 0:
        raise AssertionError(f"{name}: p50 {rep['p50_us']} p99 "
                             f"{rep['p99_us']}")


def span_table(reg) -> dict:
    """Every phase's ``span_us`` histogram of a registry: count, p50,
    p99 and total milliseconds (where a point's time went)."""
    return {e.labels["phase"]: {
        "n": e.obj.count, "p50": e.obj.quantile(0.5),
        "p99": e.obj.quantile(0.99), "sum_ms": e.obj.sum / 1e3}
        for e in reg.entries() if e.name == "span_us"}


def load_summary(rep: dict, point_s: float, reg) -> dict:
    kinds = {}
    for e in rep["timeline"]:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    return {k: rep[k] for k in (
        "target", "schedule_fingerprint", "p50_us", "p99_us", "mean_us",
        "sustained_ops_s", "wall_s", "n_excursions",
        "n_attributed_excursions", "counters")} | {
        "windows": len(rep["series"]),
        "dedup_migrations": kinds.get("dedup_migration", 0),
        "timeline_kinds": kinds, "crash": rep.get("crash"),
        "excursions": [{k: x[k] for k in ("epoch", "p99_us", "baseline_us",
                                          "count")}
                       | {"events": [e["kind"] for e in x["events"]]}
                       for x in rep["excursions"]],
        "span_us": span_table(reg), "point_s": point_s}


def run_log_point(name: str, spec: LoadSpec, root: Path, dev,
                  flight_path=None) -> tuple:
    """One log point, then the log reopened (a restart): every acked rid
    of the retain window must still answer ``took_effect``."""
    t0 = time.perf_counter()
    harness = LoadHarness(str(root / name), spec, flight_path=flight_path,
                          device=dev)
    rep = harness.run()
    point_s = time.perf_counter() - t0
    check_load_report(name, spec, rep)
    window = acked_rids(spec)[-spec.retain:]
    again = RequestLog(root / name, capacity=spec.capacity,
                       shards=spec.shards, rebalance=spec.rebalance,
                       registry=MetricsRegistry(), device=dev)
    lost = int((~again.took_effect(window)).sum())
    if lost:
        raise AssertionError(f"{name}: {lost} acked rids of the retain "
                             f"window do not take effect after a reopen")
    return rep, load_summary(rep, point_s, harness.registry)


def run_engine_point(sz: Sizes, root: Path, dev, seed: int) -> dict:
    """benchmarks/loadtest.py's engine point over qwen2-7b at full width
    on the card: updates serve fresh rids (prefill + decode + commit),
    reads re-serve committed ones, which must be dedup hits that launch
    no prefill (flash_attention's count must not move)."""
    cfg = model_config(sz, "qwen2-7b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))

    def factory(registry, timeline):
        return ServeEngine(model, params, log_dir=str(root / "engine"),
                           registry=registry, timeline=timeline,
                           device=dev, **ENGINE_KW)

    reset_launches()
    t0 = time.perf_counter()
    harness = LoadHarness(str(root / "engine_point"), ENGINE_SPEC,
                          engine=factory)
    rep = harness.run()
    point_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    check_load_report("engine_closed_zipf1.3", ENGINE_SPEC, rep)
    # a prefill per update (warm-up included), none per read: reads are
    # dedup hits
    warm = max(1, ENGINE_SPEC.warmup_ops)
    n_upd = int(make_schedule(ENGINE_SPEC).is_update.sum())
    want = cfg.n_layers * (warm + n_upd)
    if dev.type == "cuda" and launches["flash_attention"] != want:
        raise AssertionError(f"engine point: {launches['flash_attention']} "
                             f"flash_attention launches, not {want} (a "
                             f"prefill of {cfg.n_layers} a fresh-rid op, "
                             f"none on reads)")
    del params
    free_card(dev)
    return load_summary(rep, point_s, harness.registry) | {
        "arch": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "reads": warm + ENGINE_SPEC.n_ops - n_upd, "updates": warm + n_upd,
        "launches": launches}


# what differs from benchmarks/loadtest.py's full bench (not --quick)
LOAD_REDUCED = [
    "closed points: n_ops 400 -> 200, so closed_crash crashes at op 100, "
    "not 200",
    "open points: open_zipf1.1 and open_zipf1.5 (300 ops at 400 ops/s) -> "
    "one open_zipf1.3, 150 ops at half of closed_zipf1.1's measured op "
    "rate",
    "sharded point: closed_zipf1.3_shards2 (400 ops, 2 devices) -> "
    "closed_zipf1.3_shards4, 150 ops, 4 shards on one card",
    "window_us 10 ms (closed) and 20 ms (open) -> 50 ms",
    "raised, not cut: batch 4 -> 1024 rids, retain 128 -> 2^16, "
    "capacity 2^12 -> 2^15",
    "engine point: the same spec and engine, over qwen2-7b at full width "
    "where the reference serves tiny(qwen2-7b)",
]


def run_load(sz: Sizes, dev, seed: int) -> dict:
    """The load phase: the log points, the open point at half of
    closed_zipf1.1's rate, the torn crash with its flight dump, and the
    engine point.  Fails on any point's check; returns the summaries."""
    points = {}
    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        specs = load_log_specs(sz)
        for name in ("closed_zipf1.1", "closed_zipf1.5", "closed_uniform"):
            points[name] = run_log_point(name, specs[name], root, dev)[1]
        spec = open_spec(sz, points["closed_zipf1.1"]["sustained_ops_s"])
        points["open_zipf1.3"] = run_log_point("open_zipf1.3", spec, root,
                                               dev)[1]
        points["open_zipf1.3"]["rate_ops_s"] = spec.rate_ops_s
        flight = root / "closed_crash_flight.json"
        rep, points["closed_crash"] = run_log_point(
            "closed_crash", specs["closed_crash"], root, dev,
            flight_path=str(flight))
        dump = json.loads(flight.read_text())
        types = {e["type"] for e in dump["entries"]}
        if not rep["crash"]["no_acked_lost"] or \
                dump["reason"] != "injected_crash" or \
                not {"span", "persist"} <= types:
            raise AssertionError(f"closed_crash: no_acked_lost "
                                 f"{rep['crash']['no_acked_lost']}, dump "
                                 f"{dump['reason']} with {sorted(types)}")
        points["closed_crash"]["flight_entry_types"] = sorted(types)
        name = "closed_zipf1.3_shards4"
        points[name] = run_log_point(name, specs[name], root, dev)[1]
        points["engine_closed_zipf1.3"] = run_engine_point(sz, root, dev,
                                                           seed)
    n_att = sum(p["n_attributed_excursions"] for p in points.values())
    return {"points": points,
            "n_excursions_total": sum(p["n_excursions"]
                                      for p in points.values()),
            "n_attributed_total": n_att, "any_attributed": n_att >= 1,
            "reduced": LOAD_REDUCED}


def run_sharded_serve(sz: Sizes, dev) -> dict:
    """The serve phase's commits through a ``RequestLog`` whose dedup map
    is sharded over ``sz.shards`` shards and may re-split them live:
    growth, snapshot, crash and restart keep exactly-once."""
    with tempfile.TemporaryDirectory() as d:
        kw = dict(capacity=sz.serve_capacity, shards=sz.shards,
                  rebalance=True, device=dev)
        t0 = time.perf_counter()
        rlog = RequestLog(d, registry=MetricsRegistry(), **kw)
        rid = 0
        for _ in range(sz.serve_batches):
            batch = {r: [r, (r * 7) % 1000]
                     for r in range(rid, rid + sz.serve_batch)}
            rlog.commit(batch, evict=rlog.expired_rids(sz.serve_retain))
            rid += sz.serve_batch
        rlog.snapshot()
        rlog.commit({rid: [rid, 0]},
                    evict=rlog.expired_rids(sz.serve_retain))
        rid += 1
        before = rlog.committed()
        kept = sorted(before)
        evicted = sorted(set(range(rid)) - set(before))
        rlog.io.crash(evict="random")
        t1 = time.perf_counter()
        again = RequestLog(d, registry=MetricsRegistry(), **kw)
        t2 = time.perf_counter()
        if again.committed() != before:
            raise AssertionError("sharded log: committed() changed across "
                                 "the crash")
        if not again.took_effect(kept).all() or \
                again.took_effect(evicted).any():
            raise AssertionError("sharded log: took_effect differs")
        if rlog.dedup_migrations < 1 or not evicted:
            raise AssertionError("sharded log: no growth or no eviction")
        return {"shards": sz.shards, "rids": rid, "kept": len(kept),
                "evicted": len(evicted),
                "dedup_migrations": rlog.dedup_migrations,
                "dedup_rebalances": rlog.dedup_rebalances,
                "commit_s": t1 - t0, "restart_s": t2 - t1}


def run_checkpoint(sz: Sizes, dev, seed: int) -> dict:
    """zamba2-7b's parameters (full width, ``ckpt_layers`` deep, random
    from ``seed``) saved as 4 checkpoint steps, each step changing one
    leaf as a trainer's step would, ``gc(keep=2)`` after step 3 and a
    crash (``evict="random"``) at step 4's manifest publish.  ``recover``
    must land on step 3, ``restore`` onto the card must give step 3's
    tensors bit for bit, and a prefill with the restored weights (through
    ``flash_attention`` and ``ssd_scan``) the in-memory step-3 model's
    logits.  The same sequence under the Izraelevitz policy gives its
    fence count."""
    cfg = model_config(sz, n_layers=sz.ckpt_layers)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed + 2))
    trees = [{n: p.detach() for n, p in params.named_parameters()}]
    for s, name in ((2, "embed"), (3, "blocks.mamba.0.in_proj"),
                    (4, "final_norm")):
        t = dict(trees[-1])
        g = torch.Generator(device=dev).manual_seed(seed + 10 * s)
        t[name] = (t[name].float() - 1e-3 * torch.randn(
            t[name].shape, generator=g, device=dev)).to(t[name].dtype)
        trees.append(t)
    n_bytes = sum(t.numel() * t.element_size() for t in trees[0].values())
    stage, times = _timer(dev)
    with tempfile.TemporaryDirectory() as d:
        fences = {}
        for policy in ("nvtraverse", "izraelevitz"):
            root = Path(d) / policy
            plan = CrashAtPublish("step_00000004/MANIFEST.json",
                                  evict="random", seed=seed)
            mgr = CheckpointManager(root, policy=policy, faults=plan,
                                    device=dev)
            tag = "" if policy == "nvtraverse" else "iz_"
            for s, tree in enumerate(trees, 1):
                try:
                    stage(f"{tag}save_{s}", lambda: mgr.save(
                        s, tree, aux={"step": s}))
                except CrashPoint:
                    break
                if s == 3:
                    stage(f"{tag}gc", lambda: mgr.gc(keep=2))
            if plan.fired_at is None or s != 4:
                raise AssertionError(f"{policy}: the crash did not fire "
                                     f"at step 4's publish")
            fences[policy] = mgr.io.counters.fences
            if policy == "nvtraverse":
                written = mgr.io.counters.bytes_fenced
                on_disk = sum(p.stat().st_size for p in root.rglob("*")
                              if p.is_file())
                rec = CheckpointManager(root, device=dev)
                man = stage("recover", rec.recover)
                if man is None or man.step != 3:
                    raise AssertionError(f"recovered step "
                                         f"{man and man.step}, not 3")
                man, restored = stage("restore", lambda: rec.restore(
                    trees[2]))
                for n, t in trees[2].items():
                    r = restored[n]
                    if r.device != t.device or not torch.equal(r, t):
                        raise AssertionError(f"restored {n} differs from "
                                             f"step 3's")
            shutil.rmtree(root)
    S = max(sz.prompt_lens)
    toks = torch.as_tensor(np.random.default_rng(seed + 3).integers(
        0, cfg.vocab, size=(sz.model_batch, S)), device=dev)
    logits = {}
    with torch.no_grad():
        for which, tree in (("memory", trees[2]), ("restored", restored)):
            for n, p in params.named_parameters():
                p.data = tree[n]
            reset_launches()
            logits[which], _ = model.prefill(params, {"tokens": toks}, S)
            launches = {"flash_attention": flash_attention.launches,
                        "ssd_scan": ssd_scan.launches}
    n_inv = cfg.n_layers // cfg.shared_attn_every
    if dev.type == "cuda" and launches != {"flash_attention": n_inv,
                                           "ssd_scan": cfg.n_layers}:
        raise AssertionError(f"restored prefill launches {launches}")
    diff = max_err(logits["restored"], logits["memory"])
    if not torch.isfinite(logits["restored"].float()).all():
        raise AssertionError("restored prefill logits not finite")
    if diff:         # only a GEMM that is not bit-reproducible allows it
        _check_close("restored prefill", logits["restored"],
                     logits["memory"], 2e-2)
    save_s = sum(v for k, v in times.items() if k.startswith("save_"))
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.param_dtype,
            "leaves": len(trees[0]), "param_bytes": n_bytes,
            "bytes_written": written, "bytes_on_disk": on_disk,
            "save_gb_per_s": written / save_s / 1e9,
            "recovered_step": 3, "fences": fences,
            "prefill_shape": list(toks.shape), "launches": launches,
            "logits_max_abs_diff": diff, "bit_identical": diff == 0,
            "stage_s": times,
            "reduced": [f"layers {get_arch('zamba2-7b').n_layers} -> "
                        f"{cfg.n_layers}: every save writes every byte "
                        f"to the host's disk and digests it"]}


def run_crash(dev) -> dict:
    """Every crash scenario (``rebalance`` at 1 and 4 shards) swept at
    every site under each eviction adversary on ``dev``; any failure
    fails the phase."""
    out = {}
    for layer, (name, kw) in CRASH_SWEEPS.items():
        t0 = time.perf_counter()
        rep = sweep(SCENARIOS[name], evict_modes=("none", "random", "torn"),
                    scenario_kw={"device": dev, **kw})
        if rep["n_sites"] != CRASH_SITES[layer]:
            raise AssertionError(f"{layer}: {rep['n_sites']} crash sites, "
                                 f"{CRASH_SITES[layer]} expected")
        if rep["failures"] or rep["runs"] != 3 * rep["n_sites"]:
            raise AssertionError(f"{layer}: {rep['failures'][:3]}")
        out[layer] = {"n_sites": rep["n_sites"], "runs": rep["runs"],
                      "failures": len(rep["failures"]),
                      "kinds": sorted({x["kind"] for x in rep["sites"]}),
                      "s": time.perf_counter() - t0}
    return out


# --------------------------------------------------------------------- #
# paper phase: the paper's transformation on the host's instruction-     #
# level machine, its checkers and trace analysis, bridged to the card's  #
# engines                                                                #
# --------------------------------------------------------------------- #
PAPER_MODULES = ("pmem", "policies", "traversal", "harris_list",
                 "hash_table", "bst", "skiplist", "queue", "stack",
                 "scheduler", "linearizability")


def core_modules(package: str = "repro_torch") -> SimpleNamespace:
    """The instruction-level modules of ``package`` (this script only ever
    loads the port's; the CPU tests hand the functions below the
    reference's to hold them against it)."""
    return SimpleNamespace(**{m: importlib.import_module(f"{package}.core.{m}")
                              for m in PAPER_MODULES})


PORT_CORE = core_modules()
POLICY_NAMES = ("volatile", "izraelevitz", "nvtraverse")
# trace events of each scenario of the crash phase (tests/
# test_torch_analysis.py holds the same streams against the JAX scenarios)
TRACE_EVENTS = {"log": 38, "log2": 41, "checkpoint": 29, "migrate": 34,
                "rebalance": 30, "rebalance4": 30, "ordered": 32}
# the crash points of the instruction-level histories: the same seeded
# interleaving crashed at a quarter, half and three quarters of its steps
HIST_CRASH_QUARTERS = (1, 2, 3)
HIST_SEEDS = (0, 1)
# a volatile-policy list history the checker must reject (no flush at
# all: completed updates are lost at the crash)
VOLATILE_LOSS = {"seed": 0, "crash_at": 248, "evict": "none"}


def paper_workload(structure: str, policies, size: int, n_ops: int,
                   update_pct: int = 20, seed: int = 0,
                   core=PORT_CORE) -> dict:
    """``benchmarks/paper_figures.py:run_workload``'s workload under each
    of ``policies``: an ``nvtraverse`` prefill of ``size`` keys out of
    ``2 * size``, then ``n_ops`` ops, ``update_pct``% split between
    inserts and deletes, the rest finds.  The prefill is built once and
    each policy runs on a copy of it (memory, structure and the seeded
    generator), which is what a fresh prefill would give.  Returns, per
    policy, the instruction counts per op and the host seconds of the
    measured ops."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    mem = core.pmem.PMem(1 << 19)
    ds = {"list": lambda: core.harris_list.HarrisList(mem),
          "hash": lambda: core.hash_table.HashTable(mem, n_buckets=64),
          "bst": lambda: core.bst.ExternalBST(mem),
          "skiplist": lambda: core.skiplist.SkipList(mem)}[structure]()
    run, get = core.traversal.run_operation, core.policies.get_policy
    for k in rng.permutation(2 * size)[:size]:
        run(ds, get("nvtraverse"), "insert", (int(k), 1))
    mem.persist_all()
    mem.counters.reset()
    prefill_s = time.perf_counter() - t0
    out = {}
    for policy in policies:
        rng_p, ds_p = copy.deepcopy((rng, ds))
        pol = get(policy)
        t0 = time.perf_counter()
        for _ in range(n_ops):
            r = rng_p.random()
            k = int(rng_p.integers(0, 2 * size))
            if r < update_pct / 200:
                run(ds_p, pol, "insert", (k, 1))
            elif r < update_pct / 100:
                run(ds_p, pol, "delete", (k,))
            else:
                run(ds_p, pol, "find", (k,))
        out[policy] = {**{f"{f}_per_op": v / n_ops
                          for f, v in ds_p.mem.counters.snapshot().items()},
                       "ops_s": time.perf_counter() - t0,
                       "prefill_s": prefill_s}
    return out


def paper_counts(sz: Sizes) -> dict:
    """The paper's count sweep: the list at two sizes and hash, bst and
    skiplist at one, under every policy.  The journey persists nothing,
    NVTraverse fences stay O(1) an op and Izraelevitz fences O(path)
    (``tests/test_paper_claims.py``'s bounds)."""
    runs = [("list", n, sz.paper_list_ops) for n in sz.paper_list_sizes] + \
        [(s, sz.paper_size, sz.paper_ops) for s in ("hash", "bst",
                                                     "skiplist")]
    out = {}
    for structure, size, n_ops in runs:
        got = paper_workload(structure, POLICY_NAMES, size, n_ops)
        for policy, r in got.items():
            out[f"{structure}{size}_{policy}"] = r
            if policy == "nvtraverse":
                if r["traverse_flushes_per_op"] or \
                        r["traverse_fences_per_op"]:
                    raise AssertionError(f"{structure}: nvtraverse "
                                         f"persisted during a traversal")
                if r["fences_per_op"] >= (4 if structure == "list" else 5):
                    raise AssertionError(f"{structure}{size}: "
                                         f"{r['fences_per_op']} fences/op")
            if policy == "volatile" and (r["flushes_per_op"]
                                         or r["fences_per_op"]):
                raise AssertionError(f"{structure}: volatile persisted")
    big = max(sz.paper_list_sizes)
    iz = out[f"list{big}_izraelevitz"]["fences_per_op"]
    if not iz > 0.8 * big * 0.9:
        raise AssertionError(f"izraelevitz list{big}: {iz} fences/op")
    return out


def hist_structure(core, name: str, mem):
    return {"list": lambda: core.harris_list.HarrisList(mem),
            "hash": lambda: core.hash_table.HashTable(mem, n_buckets=4),
            "bst": lambda: core.bst.ExternalBST(mem),
            "skiplist": lambda: core.skiplist.SkipList(mem, max_level=6),
            "queue": lambda: core.queue.MSQueue(mem),
            "stack": lambda: core.stack.TreiberStack(mem)}[name]()


def crash_trial(name: str, policy: str, seed: int, crash_at, evict,
                core=PORT_CORE) -> dict:
    """One seeded interleaving of concurrent ops on a prefilled, persisted
    structure under ``policy``, crashed at global step ``crash_at``
    (``None``: run to the end) with the ``evict`` adversary and recovered
    by ``disconnect``; the history is judged against the recovered state
    by the durable-linearizability checker of the structure's kind.  The
    ops and their interleaving depend on ``seed`` alone, so an uncrashed
    run's ``steps`` place the crash points of the others."""
    rng = np.random.default_rng(seed)
    mem = core.pmem.PMem(1 << 16, seed=seed)
    ds = hist_structure(core, name, mem)
    run, nv = core.traversal.run_operation, core.policies.get_policy(
        "nvtraverse")
    ops = []
    if name in ("queue", "stack"):
        put, take = (("enqueue", "dequeue") if name == "queue"
                     else ("push", "pop"))
        initial = list(range(1, 6))
        for v in initial:
            run(ds, nv, put, (v,))
        for v in range(100, 108):
            ops.append((put, (v,)) if rng.random() < 0.6 else (take, ()))
    else:
        initial = list(range(0, 16, 2))
        for k in initial:
            run(ds, nv, "insert", (k, k * 10))
        for _ in range(16):
            op = str(rng.choice(["insert", "delete", "find"]))
            k = int(rng.integers(0, 16))
            ops.append((op, (k, k) if op == "insert" else (k,)))
    mem.persist_all()
    il = core.scheduler.Interleaver(ds, core.policies.get_policy(policy),
                                    ops, seed=seed)
    recs = il.run(crash_at=crash_at, evict=evict)
    if il.crashed:
        if name == "skiplist":
            ds.index = {}                 # the towers die with the crash
        ds.disconnect()
    ds.check_integrity(require_unmarked=il.crashed)
    state = ds.contents()
    return {"records": recs, "state": state, "initial": initial,
            "crashed": il.crashed, "steps": il.global_step,
            "ok": history_verdict(name, recs, state, initial, core)}


def history_verdict(name: str, records, state, initial,
                    core=PORT_CORE) -> bool:
    """The durable-linearizability checker of the structure's kind: FIFO,
    LIFO (``state`` and ``initial`` front or top first) or set."""
    lin = core.linearizability
    if name == "queue":
        return lin.check_queue_durably_linearizable(records, state, initial)
    if name == "stack":
        return lin.check_stack_durably_linearizable(records, state,
                                                    initial[::-1])
    return lin.check_durably_linearizable(records, set(state),
                                          initial_keys=initial)


def paper_histories() -> dict:
    """Every structure under ``nvtraverse`` and ``izraelevitz``: each seeded
    interleaving run to its end, then crashed at each quarter under each
    adversary and recovered.  Every history must be durably linearizable;
    the volatile list's must not."""
    out = {}
    for name in ("list", "hash", "bst", "skiplist", "queue", "stack"):
        for policy in ("nvtraverse", "izraelevitz"):
            t0, runs, crashed = time.perf_counter(), 0, 0
            for seed in HIST_SEEDS:
                steps = None
                for evict in ("none", "random", "all"):
                    for q in (None, *HIST_CRASH_QUARTERS):
                        if q is None and steps is not None:
                            continue              # one uncrashed run
                        at = None if q is None else steps * q // 4
                        r = crash_trial(name, policy, seed, at, evict)
                        if not r["ok"] or r["crashed"] != (q is not None):
                            raise AssertionError(
                                f"{name}/{policy}/{evict} seed {seed} "
                                f"crash at {at}: not durably linearizable")
                        steps = steps or r["steps"]
                        runs += 1
                        crashed += r["crashed"]
            out[f"{name}_{policy}"] = {"histories": runs, "crashed": crashed,
                                       "s": time.perf_counter() - t0}
    bad = crash_trial("list", "volatile", **VOLATILE_LOSS)
    if not bad["crashed"] or bad["ok"]:
        raise AssertionError("the volatile list's lost update was not caught")
    out["volatile_list_rejected"] = PORT_CORE.linearizability.explain_failure(
        bad["records"], bad["state"], bad["initial"])
    return out


def paper_traces(dev) -> dict:
    """Each crash scenario (``rebalance`` at 1 and 4 shards) traced on
    ``dev``: its pinned event count, and no finding of the checker."""
    out = {}
    for layer, (name, kw) in CRASH_SWEEPS.items():
        t0 = time.perf_counter()
        events = trace_scenario(name, {"device": dev, **kw}).events
        rep = check_events(events)
        if len(events) != TRACE_EVENTS[layer]:
            raise AssertionError(f"{layer}: {len(events)} trace events, "
                                 f"{TRACE_EVENTS[layer]} expected")
        if not rep.ok or rep.diagnostics:
            raise AssertionError(f"{layer}: {rep.to_dict()}")
        out[layer] = {"events": len(events),
                      "kinds": sorted({e.kind for e in events}),
                      "s": time.perf_counter() - t0}
    return out


def batch_records(batches, oks, core=PORT_CORE, crashed_batch=None) -> list:
    """Engine batches as a concurrent history: the ops of batch ``b`` are
    concurrent (invoked at step 2b, responding at 2b+1) and batches are
    ordered in time.  The crashed batch's ops stay pending; later batches
    were never invoked."""
    records, opid = [], 0
    for b, (ops, ks, _vs) in enumerate(batches):
        acked = crashed_batch is None or b < crashed_batch
        invoked = acked or b == crashed_batch
        for i, (o, k) in enumerate(zip(ops.tolist(), ks.tolist())):
            records.append(core.scheduler.OpRecord(
                opid=opid, op="insert" if o == B.OP_INSERT else "delete",
                args=(k,), invoke_step=2 * b if invoked else None,
                respond_step=2 * b + 1 if acked else None,
                result=bool(oks[b][i]) if acked else None))
            opid += 1
    return records


def mixed_batches(rng, n_batches: int, n: int, key_hi: int) -> list:
    return [(rng.integers(0, 2, n).astype(np.int32),
             rng.integers(1, key_hi, n).astype(np.int32),
             rng.integers(0, 1 << 20, n).astype(np.int32))
            for _ in range(n_batches)]


def paper_fence_bridge(sz: Sizes, dev, seed: int, core=PORT_CORE) -> dict:
    """The same keys through the instruction-level ``HashTable`` (3 fences
    an op: makePersistent, the CAS's and the return's) and the card map's
    ``update_parallel`` (2: the plan persists nothing), then the card map
    converted to tiles and probed by ``nvt_probe``: every found flag and
    value must be the ``HashTable``'s."""
    rng = np.random.default_rng(seed)
    n = sz.bridge_keys
    ks = rng.choice(np.arange(1, 1 << 15), n, replace=False).astype(np.int32)
    vs = rng.integers(0, 1 << 20, n).astype(np.int32)
    mem = core.pmem.PMem(1 << 16)
    ht = core.hash_table.HashTable(mem, n_buckets=256)
    pol = core.policies.get_policy("nvtraverse")
    mem.counters.reset()
    t0 = time.perf_counter()
    for k, v in zip(ks.tolist(), vs.tolist()):
        if not core.traversal.run_operation(ht, pol, "insert", (k, v)):
            raise AssertionError(f"HashTable refused fresh key {k}")
    inst_s = time.perf_counter() - t0
    want = ht.contents()
    nb = sz.bridge_buckets
    st = B.make_state(2 * n, nb, dev)
    st, ok, _ = B.update_parallel(st, np.zeros(n, np.int32), ks, vs, nb)
    inst_f, eng_f = mem.counters.fences / n, int(st.fences) / n
    if not bool(ok.all()) or (inst_f, eng_f) != (3.0, 2.0):
        raise AssertionError(f"fences an op {inst_f} / {eng_f}, "
                             f"ok {int(ok.sum())}/{n}")
    if int(st.live.sum()) != len(want):
        raise AssertionError("the card map's live set differs")
    kt, vt = tiles_from_hashmap(st, nb, sz.cap)
    absent = np.arange(1 << 15, (1 << 15) + n, dtype=np.int32)
    q = np.concatenate([ks, absent])
    _sync(dev)
    t0 = time.perf_counter()
    found, vals = nvt_probe(kt, vt, torch.as_tensor(q, device=dev))
    _sync(dev)
    probe_s = time.perf_counter() - t0
    exp_found = np.array([int(k in want) for k in q.tolist()], np.int32)
    exp_vals = np.array([want.get(k, 0) for k in q.tolist()], np.int32)
    if not (np.array_equal(found.cpu().numpy(), exp_found)
            and np.array_equal(vals.cpu().numpy(), exp_vals)):
        raise AssertionError("nvt_probe disagrees with the HashTable")
    return {"keys": n, "fences_per_op": {"instruction": inst_f,
                                         "engine": eng_f},
            "queries": int(q.size), "instruction_s": inst_s,
            "probe_s": probe_s}


def paper_engine_history(sz: Sizes, dev, seed: int, core=PORT_CORE) -> dict:
    """Rounds of concurrent insert/delete ops through the card map's
    ``update_parallel``: the history must linearize, and end in the card
    map's live set."""
    rng = np.random.default_rng(seed + 1)
    nb, hi = sz.bridge_buckets, sz.hist_key_hi
    batches = mixed_batches(rng, sz.hist_rounds, sz.hist_ops, hi)
    st = B.make_state(hi, nb, dev)
    t0 = time.perf_counter()
    oks = []
    for ops, ks, vs in batches:
        st, ok, _ = B.update_parallel(st, ops, ks, vs, nb)
        oks.append(ok.cpu().numpy())
    engine_s = time.perf_counter() - t0
    universe = np.arange(1, hi, dtype=np.int32)
    found, _ = B.lookup(st, universe, nb)
    live = set(universe[found.cpu().numpy()].tolist())
    records = batch_records(batches, oks, core)
    lin = core.linearizability
    t0 = time.perf_counter()
    if not lin.check_linearizable(records):
        raise AssertionError("the card map's history does not linearize")
    if not lin.check_durably_linearizable(records, live):
        raise AssertionError("the card map's live set is not the "
                             "history's")
    per_key = np.bincount(np.concatenate([b[1] for b in batches]))
    return {"ops": len(records), "keys": int((per_key > 0).sum()),
            "max_ops_per_key": int(per_key.max()), "live": len(live),
            "engine_s": engine_s, "check_s": time.perf_counter() - t0}


def paper_crash_prefixes(sz: Sizes, dev, seed: int,
                         core=PORT_CORE) -> dict:
    """A ``DurableOrderedMap`` on ``dev`` crashed at the publish of each
    batch in turn (and once not at all) and reopened: every recovered
    live set must durably linearize the history, the crashed batch
    pending."""
    rng = np.random.default_rng(seed + 2)
    n = sz.prefix_ops
    batches = mixed_batches(rng, sz.prefix_batches, n, n)
    out = {"batches": len(batches), "ops": n, "recovered_live": []}
    t0 = time.perf_counter()
    for c in range(len(batches) + 1):
        crash = c < len(batches)
        with tempfile.TemporaryDirectory() as d:
            m = O.DurableOrderedMap(d, capacity=2 * n, device=dev)
            # sites per batch: flush, fence, publish of its round file
            CrashPlan(crash_at=3 * c + 2 if crash else None,
                      evict="random", seed=c).attach(m.io)
            oks = []
            try:
                for ops, ks, vs in batches:
                    oks.append(m.update(ops, ks, vs))
            except CrashPoint:
                pass
            if len(oks) != c:
                raise AssertionError(f"prefix {c}: {len(oks)} acked")
            live = set(O.live_items(O.DurableOrderedMap(
                d, capacity=2 * n, device=dev).state))
        records = batch_records(batches, oks, core,
                                crashed_batch=c if crash else None)
        if not core.linearizability.check_durably_linearizable(records,
                                                               live):
            raise AssertionError(f"prefix {c} not durably linearizable")
        out["recovered_live"].append(len(live))
    out["s"] = time.perf_counter() - t0
    return out


def paper_towers(sz: Sizes, dev, seed: int, core=PORT_CORE) -> dict:
    """``SkipList.rebuild_index`` after inserts and deletes at the
    instruction level promotes the same keys at every level as
    ``build_towers`` over the same live keys on the card."""
    rng = np.random.default_rng(seed + 3)
    n = sz.bridge_keys
    keys = rng.choice(np.arange(1, 1 << 15), n, replace=False).tolist()
    mem = core.pmem.PMem(1 << 16)
    sl = core.skiplist.SkipList(mem, max_level=O.MAX_LEVEL)
    run, pol = core.traversal.run_operation, core.policies.get_policy(
        "nvtraverse")
    t0 = time.perf_counter()
    for k in keys:
        run(sl, pol, "insert", (k, 2 * k))
    for k in keys[::5]:
        run(sl, pol, "delete", (k,))
    sl.rebuild_index()
    inst_s = time.perf_counter() - t0
    live = np.asarray(sorted(set(keys) - set(keys[::5])), np.int32)
    stt = O.make_ordered(2 * n, dev)
    stt, ok, _ = O.update_parallel_ordered(
        stt, np.zeros(live.size, np.int32), live, 2 * live)
    rows = O.build_towers(stt).keys.cpu().numpy()
    promoted = {}
    for lvl in range(2, O.MAX_LEVEL + 1):
        seed_keys = [k for k, _ in sl.index[lvl]]
        row = rows[lvl - 2]
        if not (bool(ok.all()) and row[:len(seed_keys)].tolist() == seed_keys
                and (row[len(seed_keys):] == O.KEY_PAD).all()):
            raise AssertionError(f"level {lvl} promotion differs")
        promoted[lvl] = len(seed_keys)
    return {"live": int(live.size), "promoted": promoted,
            "instruction_s": inst_s}


def run_paper(sz: Sizes, dev, seed: int) -> dict:
    """The paper phase; raises on the first failed check."""
    out, times = {}, {}
    for part, fn in (("counts", lambda: paper_counts(sz)),
                     ("histories", paper_histories),
                     ("traces", lambda: paper_traces(dev)),
                     ("fence_bridge",
                      lambda: paper_fence_bridge(sz, dev, seed)),
                     ("engine_history",
                      lambda: paper_engine_history(sz, dev, seed)),
                     ("crash_prefixes",
                      lambda: paper_crash_prefixes(sz, dev, seed)),
                     ("towers", lambda: paper_towers(sz, dev, seed))):
        t0 = time.perf_counter()
        out[part] = fn()
        times[part] = time.perf_counter() - t0
    out["part_s"] = times
    return out


# --------------------------------------------------------------------- #
# examples phase: the port's examples and tools, run on the card         #
# --------------------------------------------------------------------- #
ROOT = Path(__file__).resolve().parent
# the training example's steps on the card and in the host rehearsal
# (None: its default 200).  On the card 100, a checkpoint every 25 (its
# default cadence): at 60 its learning assert fails, and its 200 take
# about 98 s, most of them its 16 saves digested on the host; on the
# host 10, a checkpoint every 3
EXAMPLE_STEPS = {"cuda": 100, "cpu": 10}
EXAMPLE_ARCHS = {"torch_serve_batch": "tiny(qwen2-7b)",
                 "torch_train_tiny_lm": "qwen3-family ~100M"}


def load_script(rel: str):
    """An example or tool of the repo as a module (its ``main`` is not
    run)."""
    import importlib.util
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(rel: str, argv=None):
    """``main(argv)`` of a script of the repo, its printing kept:
    (result, seconds, last printed line, flash launches by shape,
    backward launches by shape), the counts from 0."""
    import contextlib
    import io
    mod = load_script(rel)
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = mod.main() if argv is None else mod.main(list(argv))
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    return (res, seconds, lines[-1] if lines else "",
            dict(flash_attention.shapes), dict(flash_attention_bwd.shapes))


def run_examples(dev) -> dict:
    """The five examples and three tools on ``dev``, each with its own
    assertions, in this process; each one's seconds, last line and
    ``flash_attention`` launches (forward and backward) by shape."""
    d = str(dev.type)
    out, shapes = {}, []

    def one(name, rel, argv=None):
        res, sec, last, fwd, bwd = run_script(rel, argv)
        out[name] = {"seconds": sec, "last_line": last,
                     "flash_launches": sum(fwd.values()),
                     "flash_bwd_launches": sum(bwd.values())}
        for key, n in fwd.items():
            shapes.append({"script": name, "key": list(key), "launches": n,
                           "bwd_launches": bwd.get(key, 0)})
        return res

    one("torch_quickstart", "examples/torch_quickstart.py")
    one("torch_nvtraverse_demo", "examples/torch_nvtraverse_demo.py")
    reb = one("torch_rebalance_live", "examples/torch_rebalance_live.py",
              ["--device", d])
    if reb["rebalances"] < 1 or not isinstance(reb["live"], dict):
        raise AssertionError(f"rebalance example: {reb['rebalances']}")
    out["torch_rebalance_live"].update(splits=list(reb["splits"]),
                                       live_keys=len(reb["live"]))
    served = one("torch_serve_batch", "examples/torch_serve_batch.py",
                 ["--device", d])
    if sorted(served["full"]) != list(range(8)):
        raise AssertionError(f"serve example: {sorted(served['full'])}")
    steps = EXAMPLE_STEPS[d]
    trained = one("torch_train_tiny_lm", "examples/torch_train_tiny_lm.py",
                  ["--device", d] + ([] if steps is None
                                     else ["--steps", str(steps)]))
    ref = trained["ref"]
    out["torch_train_tiny_lm"].update(
        steps=trained["steps"], ckpt_every=trained["ckpt_every"],
        drift=trained["drift"],
        first_loss=ref["losses"][1],
        final_loss=ref["final_loss"], fences=ref["io"]["fences"])
    with tempfile.TemporaryDirectory() as tmp:
        sweep_json = f"{tmp}/sweep.json"
        rc = one("torch_crash_sweep", "tools/torch_crash_sweep.py",
                 ["--layers", "log,migrate", "--budget", "6", "--evict",
                  "none,torn", "--device", d, "--json", sweep_json])
        rep = json.loads(Path(sweep_json).read_text())
        out["torch_crash_sweep"].update(rc=rc, layers={
            k: {"n_sites": v["n_sites"], "runs": v["runs"],
                "failures": len(v["failures"])}
            for k, v in rep["layers"].items()})
        if rc or any(v["failures"] for v in rep["layers"].values()):
            raise AssertionError(f"crash sweep: {out['torch_crash_sweep']}")
        reports = {}
        for where in sorted({d, "cpu"}):
            path = f"{tmp}/lint_{where}.json"
            rc = one(f"torch_persist_lint_{where}",
                     "tools/torch_persist_lint.py",
                     ["--static", "--trace", "--device", where, "--json",
                      path])
            reports[where] = (rc, json.loads(Path(path).read_text()))
        if len({json.dumps(r, sort_keys=True) for r in reports.values()}) \
                != 1:
            raise AssertionError("persist lint: the card's report is not "
                                 "the host's")
        rc, rep = reports[d]
        out["torch_persist_lint"] = {
            "rc": rc, "ok": rep["ok"],
            "static_violations": len(rep["static"]["violations"]),
            "waivers": rep["static"]["n_waived"],
            "trace_events": {k: v["n_events"]
                             for k, v in rep["trace"].items()},
            "same_as_host": True}
        if rc or not rep["ok"]:
            raise AssertionError(f"persist lint: {out['torch_persist_lint']}")
    if dev.type == "cuda" and not (
            out["torch_serve_batch"]["flash_launches"]
            and out["torch_train_tiny_lm"]["flash_launches"]
            and out["torch_train_tiny_lm"]["flash_bwd_launches"]):
        raise AssertionError("the examples never launched flash_attention "
                             f"on the card: {out}")
    return {"scripts": out, "flash_shapes": shapes}


# --------------------------------------------------------------------- #
# dryrun phase: the port's cells on the meta device, against this run    #
# --------------------------------------------------------------------- #
SERVED_ARCHS = ("zamba2-7b", "qwen2-7b") + FAMILY_ARCHS
# processes tracing the cells: the card's host has 8 cores
DRYRUN_WORKERS = 6
# the depth cuts the card needs, (arch, kind), each traced at full depth
DRYRUN_CUTS = (("zamba2-7b", "train"), ("qwen2-moe-a2.7b", "train"),
               ("arctic-480b", "serve_prefill"))


def dryrun_cells(sz: Sizes) -> dict:
    """{name: (role, cfg, shape)}: every cell this run drives on the card
    ("ran": each served arch's prefill of ``model_batch`` x the longest
    prompt and its decode step against a cache of ``max_len``, each
    trained arch's step) and, at full size, the depth cuts ("cut": each
    arch at its full depth)."""
    cells = {}
    for arch in SERVED_ARCHS:
        cfg = model_config(sz, arch)
        S = max(sz.prompt_lens)
        max_len = S + sz.new_tokens + prefix_tokens(cfg)
        cells[f"{arch}:serve_prefill"] = ("ran", cfg, ShapeConfig(
            "serve_prefill", S, sz.model_batch, "prefill"))
        cells[f"{arch}:serve_decode"] = ("ran", cfg, ShapeConfig(
            "serve_decode", max_len, sz.model_batch, "decode"))
    train = ShapeConfig("train_4k", sz.train_seq, sz.train_batch, "train")
    for arch in (TRAIN_ARCH,) + SSM_TRAIN_ARCHS + (MOE_TRAIN_ARCH,):
        cells[f"{arch}:train"] = ("ran", train_config(sz, arch), train)
    if not sz.model_tiny:
        for arch, kind in DRYRUN_CUTS:
            n = get_arch(arch).n_layers
            if kind == "train":
                cells[f"{arch}:train@{n}"] = (
                    "cut", train_config(sz, arch, n_layers=n), train)
            else:
                role, _, shape = cells[f"{arch}:{kind}"]
                cells[f"{arch}:{kind}@{n}"] = (
                    "cut", model_config(sz, arch, n_layers=n), shape)
    return cells


def allocator_bytes(tensors) -> tuple:
    """The least and the most the card's caching allocator can hold for
    ``tensors``, a block each: a block's bytes are the tensor's rounded up
    to 512, plus, for a tensor over 1 MiB, the rest of a free block it
    does not split, which is at most 1 MiB (it splits one that would
    leave more)."""
    least = sum(-(-(t.numel() * t.element_size()) // 512) * 512
                for t in tensors)
    large = sum(t.numel() * t.element_size() > 2**20 for t in tensors)
    return least, least + large * 2**20


def predict_cell(item) -> tuple:
    """One of :func:`dryrun_cells`, ``(name, (role, cfg, shape))``, made
    from shapes alone and run once on meta tensors (``lower_cell``):
    ``(name, record)``, the record holding its bytes, whether it fits the
    card, its flops and bytes moved, and for a train cell the parameters'
    and the optimizer state's bytes and the allocator's bounds for them
    (:func:`allocator_bytes`)."""
    name, (role, cfg, shape) = item
    mesh = make_card_mesh()
    cell = make_cell(cfg, shape, mesh)
    lo = lower_cell(cell, mesh)
    m, c = lo.memory_analysis(), lo.cost_analysis()
    total = m.argument_size_in_bytes + m.output_size_in_bytes \
        - m.alias_size_in_bytes + m.temp_size_in_bytes
    rec = {"role": role, "arch": cfg.name, "n_layers": cfg.n_layers,
           "shape": [shape.kind, shape.global_batch, shape.seq_len],
           "argument_bytes": m.argument_size_in_bytes,
           "output_bytes": m.output_size_in_bytes,
           "alias_bytes": m.alias_size_in_bytes,
           "temp_bytes": m.temp_size_in_bytes, "total_bytes": total,
           "fits": total <= HBM_BYTES, "flops": c["flops"],
           "bytes_accessed": c["bytes accessed"], "trace_s": lo.seconds}
    if shape.kind == "train":
        for key, tree in (("param", cell.args[0]), ("opt", cell.args[1])):
            ts = cell_leaves(tree)
            rec[f"{key}_bytes"] = sum(t.numel() * t.element_size()
                                      for t in ts)
            rec[f"{key}_alloc_bytes"] = list(allocator_bytes(ts))
    return name, rec


def predict_cells(sz: Sizes, workers: int = 1) -> dict:
    """Every cell of :func:`dryrun_cells` through :func:`predict_cell`,
    in ``workers`` spawned processes (meta tensors: none touches the
    card), the deepest cells first; in :func:`dryrun_cells`'s order."""
    cells = dryrun_cells(sz)
    items = sorted(cells.items(), key=lambda kv: -kv[1][1].n_layers * (
        3 if kv[1][2].kind == "train" else 1))
    if workers <= 1:
        out = dict(map(predict_cell, items))
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                min(workers, len(items)),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            out = dict(pool.map(predict_cell, items))
    return {name: out[name] for name in cells}


def run_dryrun(pred: dict, model: dict, dense: dict, families: dict,
               train: dict, sz: Sizes) -> dict:
    """Hold the predictions against this run: (a) every cell the card
    ran fits, its predicted peak beside the phase's measured one; (b)
    every depth cut is predicted not to fit; (c) qwen3-1.7b's parameter
    and optimizer tensors have the bytes the train phase's tensors have
    (their shapes and dtypes), and what the card's allocator took for
    them (``torch.cuda.memory_allocated`` across their init) lies within
    the allocator's bounds for those tensors (:func:`allocator_bytes`);
    (d) the compute term of qwen3-1.7b's step beside its profiled device
    time."""
    served = {r["arch"]: r for r in [model, dense] + families["archs"]}
    trained = {TRAIN_ARCH: train, **{a: train[a] for a in
                                     SSM_TRAIN_ARCHS + (MOE_TRAIN_ARCH,)}}
    ran = []

    def row(name, cells, measured):
        worst = max(cells, key=lambda c: c["total_bytes"])
        for c in cells:
            if not c["fits"]:
                raise AssertionError(f"{name}: the card ran it, but it is "
                                     f"predicted not to fit: {c}")
        ran.append({"cell": name, "n_layers": worst["n_layers"],
                    "predicted_argument_bytes": worst["argument_bytes"],
                    "predicted_temp_bytes": worst["temp_bytes"],
                    "predicted_total_bytes": worst["total_bytes"],
                    "measured_peak_bytes": measured,
                    "measured_over_predicted":
                        measured / worst["total_bytes"] if measured else None,
                    "trace_s": sum(c["trace_s"] for c in cells)})
    for arch in SERVED_ARCHS:
        row(f"{arch}:serve", [pred[f"{arch}:serve_prefill"],
                              pred[f"{arch}:serve_decode"]],
            served[arch]["peak_bytes"])
    for arch, res in trained.items():
        row(f"{arch}:train", [pred[f"{arch}:train"]], res["peak_bytes"])
    cuts = []
    for name, c in pred.items():
        if c["role"] == "cut":
            if c["fits"]:
                raise AssertionError(f"{name}: a cut the card needs is "
                                     f"predicted to fit: {c}")
            cuts.append({"cell": name, "n_layers": c["n_layers"],
                         "predicted_argument_bytes": c["argument_bytes"],
                         "predicted_total_bytes": c["total_bytes"],
                         "fits": False})
    q = pred[f"{TRAIN_ARCH}:train"]
    exact = {k: [q[k], train[k]] for k in ("param_bytes", "opt_bytes")}
    if any(a != b for a, b in exact.values()):
        raise AssertionError(f"{TRAIN_ARCH}: predicted and allocated bytes "
                             f"differ: {exact}")
    allocated = {}
    if train.get("param_alloc_bytes") is not None:      # on the card
        for key in ("param", "opt"):
            (least, most) = q[f"{key}_alloc_bytes"]
            got = train[f"{key}_alloc_bytes"]
            allocated[key] = {"least": least, "most": most, "measured": got,
                              "over_tensors": got - q[f"{key}_bytes"]}
            if not least <= got <= most:
                raise AssertionError(f"{TRAIN_ARCH}: the allocator took "
                                     f"{got} bytes for the {key} tensors, "
                                     f"not in [{least}, {most}]")
    compute_ms = q["flops"] / PEAK_FLOPS_BF16 * 1e3
    prof = train.get("profile") or {}
    device_ms = prof.get("device_ms")
    return {"ran": ran, "cuts": cuts, "exact_bytes": exact,
            "allocated_bytes": allocated,
            "train_step": {
                "arch": TRAIN_ARCH, "flops": q["flops"],
                "bytes_accessed": q["bytes_accessed"],
                "compute_term_ms": compute_ms,
                "memory_term_ms": q["bytes_accessed"] / HBM_BYTES_PER_S
                * 1e3,
                "profiled_device_ms": device_ms,
                "compute_share": compute_ms / device_ms if device_ms
                else None},
            "predict_trace_s": sum(c["trace_s"] for c in pred.values())}


def dryrun_phase(sz: Sizes, model: dict, dense: dict, families: dict,
                 train: dict) -> dict:
    """The dryrun phase's record: :func:`predict_cells` in
    ``DRYRUN_WORKERS`` processes, held against this run
    (:func:`run_dryrun`)."""
    t0 = time.perf_counter()
    pred = predict_cells(sz, workers=DRYRUN_WORKERS)
    return {"phase": "dryrun", "ok": True,
            **run_dryrun(pred, model, dense, families, train, sz),
            "workers": DRYRUN_WORKERS, "phase_s": time.perf_counter() - t0}


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean time of ``fn`` on the card (CUDA events, after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def sync_step_us(dev, iters: int = 200) -> float:
    """Host time of one chain-walk step's control round trip: a tiny
    reduction on the card read back by the host."""
    x = torch.zeros(1024, dtype=torch.int32, device=dev)
    bool((x != 0).any())
    t0 = time.perf_counter()
    for _ in range(iters):
        bool((x != 0).any())
    return (time.perf_counter() - t0) / iters * 1e6


def warm_stages(sz: Sizes, stream: dict, out: dict, dev) -> dict:
    """Host-clock seconds of the main path's map stages run again, warm
    (the first run also pays for loading PyTorch's CUDA modules)."""
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    pre = torch.as_tensor(stream["prefill"], device=dev)
    fresh = B.make_state(sz.capacity, sz.n_buckets, dev)
    ops, ks, vs, look = (torch.as_tensor(a, device=dev)
                         for a in stream["rounds"][-1])
    q = torch.as_tensor(stream["queries"], device=dev)
    st = out["state"]
    return {
        "prefill": timed(lambda: B.update_parallel(
            fresh, torch.zeros_like(pre), pre, pre, sz.n_buckets)),
        f"update_{sz.ratios[-1]}": timed(lambda: B.update_parallel(
            st, ops, ks, vs, sz.n_buckets)),
        f"lookup_{sz.ratios[-1]}": timed(lambda: B.lookup(st, look,
                                                          sz.n_buckets)),
        "tiles": timed(lambda: tiles_from_hashmap(st, sz.n_buckets, sz.cap)),
        "probe": timed(lambda: nvt_probe(*out["tiles"], q)),
    }


def _sectors(start, nbytes):
    """The 32-byte sectors that the byte ranges ``[start, start+nbytes)``
    touch (tensors of starts, one length)."""
    return start // 32, (start + nbytes - 1) // 32


def probe_bytes(kt: torch.Tensor, vt: torch.Tensor,
                q: torch.Tensor) -> dict:
    """What the probe of ``q`` over tiles ``kt``/``vt`` must move.

    ``bytes``: each input read once -- the distinct rows the queries
    touch, the queries, the values of the hit slots (repeats included) --
    and each output written once.  ``bytes_sectors``: the same inputs at
    the card's 32-byte sector granularity, from the tensors' addresses:
    the sectors of the distinct rows, the distinct sectors that hold a
    hit slot's value, and the sectors of the queries and of the two
    outputs.  ``bytes_row_per_query``: one whole row per query, repeats
    included, as a kernel with no reuse between queries reads them."""
    nb, cap = kt.shape
    nq = q.shape[0]
    b = mix32(q) % nb
    rows = torch.unique(b)
    hit = kt[b] == q[:, None]
    hit_slots = int(hit.sum())
    need = rows.numel() * cap * 4 + nq * 4 + hit_slots * 4 + 2 * nq * 4
    per_query = nq * cap * 4 + 3 * nq * 4 + hit_slots * 4
    # the rows' sectors; a row may share its first sector with the row
    # before it where rows do not end on a sector boundary
    first, last = _sectors(kt.data_ptr() + rows * cap * 4, cap * 4)
    row_sectors = int((last - first + 1).sum()) - int(
        ((rows[1:] == rows[:-1] + 1) & (last[:-1] == first[1:])).sum())
    qi, slot = hit.nonzero(as_tuple=True)
    hit_sectors = int(torch.unique(
        (vt.data_ptr() + (b[qi] * cap + slot) * 4) // 32).numel())
    stream = sum(int(e - f + 1) for f, e in (
        _sectors(q.data_ptr(), nq * 4), _sectors(0, nq * 4),
        _sectors(0, nq * 4)))
    return {"bytes": need, "bytes_row_per_query": per_query,
            "bytes_sectors": 32 * (row_sectors + hit_sectors + stream),
            "distinct_rows": int(rows.numel()), "hit_slots": hit_slots,
            "row_sectors": row_sectors, "hit_sectors": hit_sectors}


def cuda_ms_cold_l2(fn, dev, iters: int = 20) -> float:
    """Mean time of ``fn`` on the card with L2 cold: each launch timed
    alone (CUDA events around it), after a write of L2_FLUSH_BYTES
    (over twice the 50 MB L2) that evicts what the last launch left."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for i, (e0, e1) in enumerate(ev):
        flush.fill_(i)
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in ev) / iters


def warp_a_query_probe(kt, vt, q):
    """A call of the earlier one-warp-a-query kernel (Q a multiple of 8)
    from its copy at WARP_A_QUERY_PROBE, built like the port's kernels,
    and its ``(found, vals)``; None where the copy is absent."""
    if not WARP_A_QUERY_PROBE.exists() or q.shape[0] % 8:
        return None
    (so, _), = _build.build_all([WARP_A_QUERY_PROBE])
    lib = ctypes.CDLL(str(so))
    lib.nvt_probe_launch.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.nvt_probe_launch.restype = ctypes.c_int
    found, vals = torch.empty_like(q), torch.empty_like(q)

    def call():
        err = lib.nvt_probe_launch(
            kt.data_ptr(), vt.data_ptr(), q.data_ptr(), found.data_ptr(),
            vals.data_ptr(), kt.shape[0], kt.shape[1], q.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"warp-a-query nvt_probe launch failed: {err}")
    return call, (found, vals)


def time_probe(out: dict, launches: int, err: int) -> dict:
    """``nvt_probe`` at the map shape: back to back (CUDA events over 20
    launches) and with L2 cold, each in turns with the warp-a-query kernel
    (new, old, old, new) where its copy is present; the plain version;
    the bounds of :func:`probe_bytes` at the HBM rate."""
    kt, vt = out["tiles"]
    dev = kt.device
    q = torch.as_tensor(np.asarray(out["queries"]), device=dev)
    new = lambda: probe_kernel.nvt_probe_kernel(kt, vt, q)  # noqa: E731
    old = warp_a_query_probe(kt, vt, q)
    turns = {"ms": [], "ms_cold_l2": [], "warp_a_query_ms": [],
             "warp_a_query_ms_cold_l2": []}
    if old is not None:
        old[0]()
        if not (torch.equal(old[1][0], out["probe"][0])
                and torch.equal(old[1][1], out["probe"][1])):
            raise AssertionError("the warp-a-query kernel and nvt_probe "
                                 "disagree")
    # a longer warm-up: without it the first turn read up to 40% slow
    for fn in (new, old[0]) if old else (new,):
        cuda_ms(fn, iters=200)
    old_tag = "warp_a_query_"
    for who in ("", old_tag, old_tag, "") if old else ("", ""):
        fn = old[0] if who else new
        turns[who + "ms"].append(cuda_ms(fn))
        turns[who + "ms_cold_l2"].append(cuda_ms_cold_l2(fn, dev))
    mean = {k: sum(v) / len(v) if v else None for k, v in turns.items()}
    plain_ms = cuda_ms(lambda: probe_ref(kt, vt, q))
    nb = probe_bytes(kt, vt, q)
    bound = {k: nb[b] / HBM_BYTES_PER_S * 1e3 for k, b in (
        ("bound_ms", "bytes"), ("bound_ms_sectors", "bytes_sectors"),
        ("bound_ms_row_per_query", "bytes_row_per_query"))}
    g = probe_kernel.launch_geometry(kt.shape[1], kt.data_ptr() % 16 == 0)
    return {"name": "nvt_probe", "route": "cuda",
            "source": "src/repro_torch/kernels/nvt_probe/csrc/nvt_probe.cu",
            "replaces": "src/repro/kernels/nvt_probe/kernel.py:48",
            "design": "batch32: 32 queries a warp, rows as 16-byte vectors, "
                      "each lane loads its own hit values, persistent grid",
            "geometry": dataclasses.asdict(g),
            "launches": launches, "max_abs_err": err, "max_abs_diff": err,
            "ms": mean["ms"], "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "ms_cold_l2": mean["ms_cold_l2"],
            "warp_a_query_ms": mean["warp_a_query_ms"],
            "warp_a_query_ms_cold_l2": mean["warp_a_query_ms_cold_l2"],
            "turns": {k: v for k, v in turns.items() if v},
            "below_bound": [k for k, v in turns.items()
                            if any(t < bound["bound_ms"] for t in v)],
            **{k: v for k, v in bound.items() if k != "bound_ms"}, **nb}


def bound_of(work: dict, flop_rate: float = BF16_FLOP_PER_S) -> dict:
    """The least time of ``work`` (a kernel's ``work`` formula: its
    flops and bytes): its bytes at the HBM rate or its flops at
    ``flop_rate``, the longer."""
    t_b, t_o = work["bytes"] / HBM_BYTES_PER_S, work["flops"] / flop_rate
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "flops": work["flops"], "bytes": work["bytes"]}


# every compiled function's build row by name (the build phase's), which
# the timing entries carry beside their kernels
BUILD_ROWS = {}
FWD_DESIGN = {
    "wgmma": "wgmma fed by a TMA ring, warp-specialised (a producer warp, "
             "two consumer warpgroups of 64 query rows), no atomics",
    "mma_sync": "mma.sync bf16", "scalar": "scalar f32"}


def build_fields(name: str) -> dict:
    row = BUILD_ROWS.get(name, {})
    return {k: row.get(k) for k in ("registers", "spill_bytes",
                                    "hgmma_instr", "tensor_core_instr")}


def time_flash(dev, launches: int, err, arch: str = "zamba2-7b",
               shape=None, path: str = "model",
               dtype=torch.bfloat16) -> dict:
    """flash_attention at one shape of the main path, bf16: by default an
    arch's causal serve shape (S=512; zamba2-7b: B=4, H=K=32, d=112;
    qwen2-7b: B=4, H=28, K=4, d=128), else ``shape`` = (B, Sq, Sk, H, K,
    d, causal[, window]); ``launches`` are those at that shape.  The
    bound is the kernel's ``work`` (``flash_attention/ops.py``: q, k, v
    read once and o written once, 2 * 2 * d flops per visible (query,
    key) pair) at the bf16 peak (:func:`bound_of`).  The
    library call is SDPA with the same mask (``is_causal``, or the
    window's boolean mask), and ``enable_gqa=True`` where K < H (k and v
    are not repeated).  ``dtype`` float32 times the scalar kernel (its
    bound at the f32 peak outside the tensor cores); an ``err`` of None
    is measured here against the plain version (2e-5 in f32, 2e-2 in
    bf16).  Where the rule's route is the wgmma forward, ``tc_ms`` times
    the mma.sync kernel (``flash_fwd_tc``) on the same tensors in the same
    run, ``tc_max_abs_err`` its distance to the plain version."""
    if shape is None:
        B, H, K, d = FLASH_SHAPES[arch]
        shape = (B, 512, 512, H, K, d, True)
    B, Sq, Sk, H, K, d, causal, *rest = shape
    window = rest[0] if rest else 0
    mask = dict(causal=causal, window=window)
    q, k, v = flash_inputs(dev, B, Sq, H, d, dtype, 0, K, Sk)
    f32 = dtype == torch.float32
    if err is None:
        err = _check_close(
            f"flash {arch} {path} {list(shape)}",
            fa_kernel.flash_attention_kernel(q, k, v, **mask),
            flash_attention_plain(q.float(), k.float(), v.float(), **mask),
            2e-5 if f32 else 2e-2)
    route = fa_kernel.fwd_route(d, dtype)
    ms = cuda_ms(lambda: fa_kernel.flash_attention_kernel(q, k, v, **mask))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **mask))
    tc = {}
    if route == "wgmma":
        tc["tc_max_abs_err"] = _check_close(
            f"flash_fwd_tc {arch} {path} {list(shape)}",
            fa_kernel.flash_attention_kernel(q, k, v, **mask,
                                             route="mma_sync"),
            flash_attention_plain(q.float(), k.float(), v.float(), **mask),
            2e-2)
        tc["tc_ms"] = cuda_ms(lambda: fa_kernel.flash_attention_kernel(
            q, k, v, **mask, route="mma_sync"))
    kernel_name = {"wgmma": f"flash_fwd_wg<{fa_kernel.wgmma_tile_cols(d)}>",
                   "mma_sync": f"flash_fwd_tc<{-(-d // 16) * 16}>",
                   "scalar": "flash_fwd<float>"}[route]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = {"enable_gqa": True} if K < H else {}
    if window and window < Sq:
        pos = torch.arange(Sq, device=dev)
        rel = pos[:, None] - pos[None, :]
        sdpa_mask = {"attn_mask": (rel >= 0) & (rel < window)}
    else:
        sdpa_mask = {"is_causal": causal}
    library_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             qt, kt, vt, **sdpa_mask, **gqa))
    # causal shapes are self-attention (Sq == Sk)
    bound = bound_of(flash_work(B, Sq, Sk, H, K, d, causal=causal,
                                window=window, itemsize=q.element_size()),
                     F32_FLOP_PER_S if f32 else BF16_FLOP_PER_S)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
            "design": FWD_DESIGN[route], "fwd_route": route,
            "kernel": kernel_name, **build_fields(kernel_name),
            "arch": arch, "path": path,
            "launches": launches,
            "max_abs_err": err, "max_abs_diff": err,
            "ms": ms, "plain_ms": plain_ms, **tc, **bound,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention(" + (
                "attn_mask=window" if "attn_mask" in sdpa_mask
                else f"is_causal={causal}")
                       + (", enable_gqa=True)" if gqa else ")"),
            "shape": [B, Sq, Sk, H, K, d], "causal": causal,
            "window": window, "dtype": str(dtype).split(".")[-1]}


def flash_bwd_bounds(shape) -> dict:
    """The least time of each backward kernel's function and of the
    pair's at ``shape`` = (B, Sq, Sk, H, K, d, causal), bf16
    (:func:`bound_of`).  The pair's work is the kernel's ``work``
    (``flash_attention/ops.py``, ``backward=True``: S, dP, dV, dQ and dK,
    2 d flops a visible (query, key) pair each); the split counts each
    kernel's own products (dq: S, dP, dQ; dkdv: S, dP, dV, dK) and bytes
    (each input read once, each output written once; dq and dkdv pass the
    f32 row sums D between them)."""
    B, Sq, Sk, H, K, d, causal = shape
    pairs = B * H * visible_pairs(Sq, Sk, causal)
    e = 2                                      # bf16 bytes
    n_q, n_kv, n_rows = B * Sq * H * d, B * Sk * K * d, B * H * Sq
    split = {"dq": (3, (4 * n_q + 2 * n_kv) * e + 8 * n_rows),
             "dkdv": (4, (2 * n_q + 4 * n_kv) * e + 8 * n_rows)}
    bounds = {n: bound_of({"flops": products * 2 * d * pairs,
                           "bytes": nbytes})
              for n, (products, nbytes) in split.items()}
    bounds["pair"] = bound_of(flash_work(B, Sq, Sk, H, K, d, causal=causal,
                                         itemsize=e, backward=True))
    return bounds


def time_flash_bwd(dev, launches: int, errs: dict, sz: Sizes,
                   build_rows: dict, arch: str = TRAIN_ARCH,
                   tag: str = "qwen3_train") -> list:
    """The backward kernels at the training shape, bf16 (CUDA events), on
    the route ``kernel.bwd_route`` gives it (at d = 128 the wgmma pair:
    TMA rings, warp-specialised, no atomics; ``build_rows`` holds its
    functions' registers): ``flash_bwd_dq`` alone, ``flash_bwd_dkdv``
    alone (on the row sums the first wrote), and the pair; the plain
    backward; SDPA's backward
    (``torch.autograd.grad`` of ``scaled_dot_product_attention(...,
    is_causal=True, enable_gqa=True)`` on the same tensors, the library
    call that computes the pair's function).  Bounds: each kernel's
    function's least products at the bf16 peak (2 d flops a visible
    (query, key) pair a product: S, dP and dQ for dq; S, dP, dV and dK for
    dkdv; the pair's function S, dP, dV, dQ and dK, 2.5x the forward), or
    its bytes (each input read once, each output written once) at the HBM
    rate, the longer (:func:`flash_bwd_bounds`).  ``arch`` names the
    trained arch (its training shape; zamba2-7b's d = 112 takes the
    wgmma pair on 128-column tiles) and ``tag`` its backward check's
    key."""
    B, Sq, Sk, H, K, d, causal = train_shape(sz, arch)
    q, k, v = flash_inputs(dev, B, Sq, H, d, torch.bfloat16, 0, K, Sk)
    do = flash_inputs(dev, B, Sq, H, d, torch.bfloat16, 1)[0]
    o, lse = fa_kernel.flash_attention_kernel(q, k, v, causal=causal,
                                              with_lse=True)
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    bwd = fa_kernel.flash_attention_bwd_kernel
    bwd(q, k, v, o, lse, do, causal=causal, scratch=D)
    ms = {n: cuda_ms(lambda: bwd(q, k, v, o, lse, do, causal=causal,
                                 parts=parts, scratch=D))
          for n, parts in (("dq", 1), ("dkdv", 2), ("pair", 3))}
    plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=causal), iters=3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=K < H)
    dot = do.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa, (qt, kt, vt), dot, retain_graph=True))
    bounds = flash_bwd_bounds(train_shape(sz, arch))
    tag = f"{tag}_bfloat16"
    bwd_route = fa_kernel.bwd_route(d, torch.bfloat16)
    suffix = f"wg<{fa_kernel.wgmma_tile_cols(d)}>" if bwd_route == "wgmma" \
        else f"tc<{-(-d // 16) * 16}>"
    design = {"wgmma": "FlashAttention-2 split on wgmma fed by TMA rings, "
                       "warp-specialised (a producer warp, two consumer "
                       "warpgroups), no atomics",
              "mma_sync": "FlashAttention-2 split on mma.sync bf16, no "
                          "atomics"}[bwd_route]
    out = []
    for n in ("dq", "dkdv"):
        grads = ("dq",) if n == "dq" else ("dk", "dv")
        row = build_rows.get(f"flash_bwd_{n}_{suffix}", {})
        out.append({
            "name": f"flash_bwd_{n}", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
            "replaces_note": "the reference has no backward kernel: its "
                             "training differentiates attention_blocked "
                             "(src/repro/models/layers.py:128)",
            "design": design, "bwd_route": bwd_route,
            "registers": row.get("registers"),
            "spill_bytes": row.get("spill_bytes"),
            "hgmma_instr": row.get("hgmma_instr"),
            "tensor_core_instr": row.get("tensor_core_instr"),
            "arch": arch, "path": "train", "launches": launches,
            "max_abs_err": max(errs[tag][f"{g}_max_abs_err"]
                               for g in grads),
            "max_rel_err": max(errs[tag][f"{g}_vs_plain"] for g in grads),
            "ms": ms[n], "plain_ms": plain_ms, **bounds[n],
            "library_ms": library_ms,
            "library": "torch.autograd.grad of scaled_dot_product_attention"
                       "(is_causal=True" + (", enable_gqa=True" if K < H
                                            else "") + "): the pair's "
                       "function",
            "pair_ms": ms["pair"], "pair_bound_ms": bounds["pair"]["bound_ms"],
            "shape": [B, Sq, Sk, H, K, d], "causal": causal,
            "dtype": "bfloat16"})
    return out


def time_ssd(dev, launches: int, err: float, arch: str = "zamba2-7b",
             path: str = "model", sz: Sizes = None) -> dict:
    """ssd_scan at an arch's serve shape (S=512; zamba2-7b: B=4, H=112,
    P=N=64; mamba2-370m: B=4, H=32, P=64, N=128; chunk 128, bf16), from a
    zero f32 state as prefill into a cache passes it; or, given ``sz``, at
    its training shape (:func:`ssd_train_shape`) as a training step
    launches it: from zeros, on strided xBC slices, writing each chunk's
    start state for the backward (then ``err`` is measured here, against
    the plain chunked version in f32, and held to 5e-2).  The bound is
    the kernel's ``work`` (``ssd_scan/ops.py``: the inputs read once, y,
    the final state (and the chunk states) written once, the chunk
    products' flops) at the bf16 peak.  ``f32_ms`` times the f32
    kernel on the same values in f32 (the checks' kernel); where the
    rule's route is the wgmma passes, ``tc_ms`` times the mma.sync kernel
    (``ssd_scan_tc``) on the same values in the same run, and the entry
    carries each wgmma pass's build row."""
    if sz is None:
        B, H, P, N, Q = ssd_shape(FULL, arch)
        S = 512
        xh, dt, A, Bm, Cm = ssd_inputs(dev, B, S, H, P, N, torch.bfloat16,
                                       0)
        init = torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
    else:
        B, S, H, P, N, Q = ssd_train_shape(sz, arch)
        inp = ssd_bwd_inputs(dev, B, S, H, P, N, torch.bfloat16, 0)
        xh, Bm, Cm = split_xbc(inp["xbc"], H, P, N)
        dt, A, init = inp["dt"], inp["A"], None
    train = sz is not None
    route = ssd_kernel.fwd_route(P, N, Q, xh.dtype)
    ms = cuda_ms(lambda: ssd_kernel.ssd_scan_kernel(
        xh, dt, A, Bm, Cm, chunk=Q, init_state=init, with_states=train))
    tc = {}
    if route == "wgmma":
        tc["tc_ms"] = cuda_ms(lambda: ssd_kernel.ssd_scan_kernel(
            xh, dt, A, Bm, Cm, chunk=Q, init_state=init, with_states=train,
            route="mma_sync"))
        nb = 1 if N <= 64 else 2
        tc["passes"] = {n: build_fields(f"ssd_{n}<{nb}>") for n in (
            "fwd_state_wg", "fwd_state_scan", "fwd_chunk_wg")}
        tc["heads_per_block"] = ssd_kernel.bwd_heads_per_block(
            B, -(-S // Q), H)
    plain_ms = cuda_ms(lambda: ssd_chunked(xh, dt, A, Bm, Cm, Q,
                                           init_state=init))
    x32, b32, c32 = (t.float() for t in (xh, Bm, Cm))
    f32_ms = cuda_ms(lambda: ssd_kernel.ssd_scan_kernel(
        x32, dt, A, b32, c32, chunk=Q, init_state=init, with_states=train))
    if train:
        y = ssd_kernel.ssd_scan_kernel(xh, dt, A, Bm, Cm, chunk=Q)[0]
        err = _check_close(f"ssd {arch} training shape y", y, ssd_chunked(
            x32, dt, A, b32, c32, Q)[0], 5e-2)
    if route == "wgmma":
        tc["tc_max_abs_err"] = _check_close(
            f"ssd_scan_tc {arch} {path} y", ssd_kernel.ssd_scan_kernel(
                xh, dt, A, Bm, Cm, chunk=Q, init_state=init,
                route="mma_sync")[0],
            ssd_chunked(x32, dt, A, b32, c32, Q, init_state=init)[0], 5e-2)
    # serving passes its zero state in; training writes the chunk states
    bound = bound_of(ssd_work(B, S, H, P, N, Q, itemsize=xh.element_size(),
                              with_states=train, init_state=not train))
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:34",
            "design": {"wgmma": "three chunk-parallel passes: each chunk's "
                                "own state contribution on wgmma, an f32 "
                                "scan over the chunks parallel over "
                                "(batch, head, state element), the chunk "
                                "outputs on wgmma a group of heads a "
                                "block; no atomics",
                       "mma_sync": "mma.sync bf16"}[route]
            + (", writing each chunk's start state" if train else ""),
            "fwd_route": route,
            "arch": arch, "path": path, "launches": launches,
            "max_abs_err": err, "max_abs_diff": err,
            "ms": ms, "plain_ms": plain_ms, "f32_ms": f32_ms, **tc, **bound,
            "library_ms": None, "shape": [B, S, H, P, N, Q],
            "dtype": "bfloat16"}


def time_ssd_bwd(dev, launches: int, errs: dict, sz: Sizes, arch: str,
                 build_rows: dict) -> dict:
    """The SSD backward kernels at ``arch``'s training shape, bf16 (CUDA
    events): the delta pass, the state scan, the chunk pass, the d cum
    scan and the reduction over head groups as one call of
    ``ssd_scan_bwd_kernel``, from the chunk states the forward wrote; the
    plain backward (``ssd_scan_bwd_plain``, f32) on the same values; no
    library call computes it.  The bound is the backward's ``work``
    (``ssd_scan/ops.py``, ``backward=True``) at the bf16 peak; ``build_rows``
    holds the wgmma passes' registers, spills and HGMMA counts."""
    B, S, H, P, N, Q = ssd_train_shape(sz, arch)
    inp = ssd_bwd_inputs(dev, B, S, H, P, N, torch.bfloat16, 1)
    xh, Bm, Cm = split_xbc(inp["xbc"], H, P, N)
    dt, A, dy = inp["dt"], inp["A"], inp["dy"]
    _, _, states = ssd_kernel.ssd_scan_kernel(xh, dt, A, Bm, Cm, chunk=Q,
                                              with_states=True)
    ms = cuda_ms(lambda: ssd_kernel.ssd_scan_bwd_kernel(
        xh, dt, A, Bm, Cm, dy, states, chunk=Q))
    plain_ms = cuda_ms(lambda: ssd_scan_bwd_plain(
        xh, dt, A, Bm, Cm, dy, chunk=Q), iters=3)
    tag = f"{dict(zip(SSM_TRAIN_ARCHS, ('mamba2', 'zamba2')))[arch]}" \
          f"_train_bfloat16"
    nb = 1 if N <= 64 else 2
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:34",
            "replaces_note": "the reference has no backward kernel: its "
                             "training differentiates ssd_chunked "
                             "(src/repro/models/mamba2.py:85)",
            "design": "delta pass (each chunk's own state gradient, all "
                      "chunks at once) on wgmma, a reverse scan over the "
                      "chunks parallel over (batch, head, state element), "
                      "and a chunk pass on wgmma owning a group of heads "
                      "(C B^T once, dy x^T once a head, dB and dC summed "
                      "over the group in the block), a warp-a-head scan of "
                      "d cum, then an ordered sum over the groups; no "
                      "atomics",
            "bwd_route": "wgmma",
            "heads_per_block": ssd_kernel.bwd_heads_per_block(
                B, -(-S // Q), H),
            "passes": {n: build_rows.get(f"ssd_bwd_{n}_wg<{nb}>", {})
                       for n in ("delta", "chunk")},
            "arch": arch, "path": "train", "launches": launches,
            "max_abs_err": max(v for k, v in errs[tag].items()
                               if k.endswith("_max_abs_err")),
            "max_rel_err": max(v for k, v in errs[tag].items()
                               if k.endswith("_vs_plain")),
            "ms": ms, "plain_ms": plain_ms,
            **bound_of(ssd_work(B, S, H, P, N, Q, backward=True)),
            "library_ms": None, "shape": [B, S, H, P, N, Q],
            "dtype": "bfloat16"}


# decode_attention at the served cell's decode shapes (B, H, K, d, S_max,
# the positions written): qwen3-1.7b's batches of 61 prompts of 512 and of
# 20 of 4096 through their 13 steps, and qwen2-7b's GQA 7:1 at the first
DECODE_SHAPES = {
    "qwen3-1.7b B61": (61, 16, 8, 128, 4109, range(512, 525)),
    "qwen3-1.7b B20": (20, 16, 8, 128, 4109, range(4096, 4109)),
    "qwen2-7b B61": (61, 28, 4, 128, 4109, range(512, 525))}


def time_decode_attention(dev) -> list:
    """decode_attention at :data:`DECODE_SHAPES`, bf16 (CUDA events, a
    call's mean over the shape's positions in turn): the kernels' time
    beside their bound (``decode_attention/ops.py:work``: q read, the
    filled K and V rows read and the output written once, at 3.35 TB/s),
    the plain version's (the filled slice through ``attention_scores``),
    ``full_length_ms`` (``attention_scores`` over the whole cache under
    the full-length mask, the decode step's attention before the kernel)
    and SDPA over the filled slice with ``enable_gqa`` as
    ``library_ms`` (timed only; the port never calls it).  Each entry
    carries its three passes' build rows and its distance to the plain
    version."""
    out = []
    for name, (B, H, K, d, S, pos_range) in DECODE_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(B * H)
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16) for shape in (
                       (B, 1, H, d), (B, S, K, d), (B, S, K, d)))
        positions = [torch.full((B, 1), p, dtype=torch.int32, device=dev)
                     for p in pos_range]
        n = len(positions)
        err, share = map(max, zip(*(_check_decode_close(
            f"decode_attention {name} pos {int(p[0])}",
            da_kernel.decode_attention_kernel(q, k, v, p),
            decode_attention_plain(q, k, v, p))
            for p in (positions[0], positions[-1]))))

        def each(fn):
            return lambda: [fn(p) for p in positions]
        ms = cuda_ms(each(lambda p: da_kernel.decode_attention_kernel(
            q, k, v, p))) / n
        plain_ms = cuda_ms(each(lambda p: decode_attention_plain(
            q, k, v, p)), iters=5) / n
        kpos = torch.arange(S, device=dev)
        full_ms = cuda_ms(each(lambda p: model_layers.attention_scores(
            q, k, v, (kpos <= p[0, 0])[None, None, None, :])), iters=5) / n
        qt = q.transpose(1, 2)
        slices = [(k[:, :p + 1].transpose(1, 2), v[:, :p + 1].transpose(1, 2))
                  for p in pos_range]
        library_ms = cuda_ms(lambda: [
            torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=K < H) for kt, vt in slices]) / n
        works = [decode_work(B, H, K, d, p + 1) for p in pos_range]
        bound = bound_of({key: sum(w[key] for w in works) / n
                          for key in ("flops", "bytes")})
        G = H // K
        out.append({
            "name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/csrc/"
                      "decode_attention.cu",
            "replaces": "none: the JAX package's decode attention is jnp "
                        "(src/repro/models/layers.py:self_attention)",
            "design": "split-K over 128-key splits in three passes (scores "
                      "and per-split max and sum, P V with the row's max "
                      "and sum, the splits combined in order), the cache "
                      "read in place by 16-byte cp.async, the filled end "
                      "from the device; no atomics",
            "passes": {f: build_fields(f) for f in (
                f"decode_attn_scores<bf16,{G}>", f"decode_attn_pv<bf16,{G}>",
                "decode_attn_combine<bf16>")},
            "arch": name.split()[0], "path": "serve-docs decode step",
            "max_abs_err": err, "limit_share": share, "ms": ms,
            "plain_ms": plain_ms, "full_length_ms": full_ms, **bound,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention(enable_gqa=True) over "
                       "the filled slice",
            "shape": [B, H, K, d, S], "filled": [pos_range[0] + 1,
                                                 pos_range[-1] + 1],
            "dtype": "bfloat16"})
        del q, k, v, slices
        free_card(dev)
    return out


def build_report(so: Path, ptxas: str) -> list:
    """Per compiled function of one library: registers and spill bytes
    (from the ``ptxas -v`` report) and the count of tensor-core
    instructions in its SASS (``HMMA`` from ``mma.sync``, ``HGMMA`` from
    ``wgmma``), and of the ``HGMMA`` alone."""
    funcs = _build.ptxas_functions(ptxas)
    for f in funcs.values():
        f["tensor_core_instr"] = f["hgmma_instr"] = 0
    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "--dump-sass",
         str(so)], capture_output=True, text=True, check=True).stdout
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), {
                "kernel": _build.readable_name(m.group(1)),
                "registers": None, "spill_bytes": None,
                "tensor_core_instr": 0, "hgmma_instr": 0})
        elif cur is not None and re.search(r"\bH(G)?MMA\b", line):
            cur["tensor_core_instr"] += 1
            cur["hgmma_instr"] += "HGMMA" in line
    return sorted(funcs.values(), key=lambda f: f["kernel"])


WGMMA_BWD_FUNCTIONS = tuple(f"flash_bwd_{k}_wg<{d}>" for k in ("dq", "dkdv")
                            for d in fa_kernel.WGMMA_TILE_COLS)
WGMMA_FWD_FUNCTIONS = tuple(f"flash_fwd_wg<{d}>"
                            for d in fa_kernel.WGMMA_TILE_COLS)
SSD_BWD_FUNCTIONS = tuple(f"ssd_bwd_{p}_wg<{n}>" for p in ("delta", "chunk")
                          for n in (1, 2))
SSD_FWD_FUNCTIONS = tuple(f"ssd_fwd_{p}_wg<{n}>" for p in ("state", "chunk")
                          for n in (1, 2))


def check_hgmma_build(functions: list, names: tuple, source: str) -> dict:
    """Each of ``names`` is a function of ``source``'s library with
    ``HGMMA`` instructions and no spill; their build rows by name."""
    rows = {f["kernel"]: f for f in functions if f["kernel"] in names}
    missing = set(names) - set(rows)
    if missing:
        raise AssertionError(f"{source} lacks {sorted(missing)}")
    for name, f in rows.items():
        if not f["hgmma_instr"]:
            raise AssertionError(f"{name} has no HGMMA instruction")
        if f["spill_bytes"] != 0:
            raise AssertionError(f"{name} spills {f['spill_bytes']} bytes")
    return rows


def check_wgmma_bwd_build(functions: list) -> dict:
    """Each function of the wgmma backward pair (at every head dim it
    takes) is in the library, has ``HGMMA`` instructions and no spill;
    their build rows by name."""
    return check_hgmma_build(functions, WGMMA_BWD_FUNCTIONS,
                             "flash_attention")


def check_ssd_bwd_build(functions: list) -> dict:
    """Each wgmma pass of the SSD backward (at N <= 64 and <= 128: one or
    two 64-column boxes of N) is in the library, has ``HGMMA``
    instructions and no spill; their build rows by name."""
    return check_hgmma_build(functions, SSD_BWD_FUNCTIONS, "ssd_scan")


def card_name_and_limit() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    # the train phase runs deterministic on the card: cuBLAS's workspace
    # must be fixed before CUDA starts (repro_torch.launch.train)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (use --device cpu to rehearse "
              "on the host)", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    sz = FULL if on_card else SMALL
    # every f32 check runs in full f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build: one nvcc per kernel source, all started together
    if on_card:
        t0 = time.perf_counter()
        built = _build.build_all([k.SOURCE for k in KERNELS])
        build_s = time.perf_counter() - t0
        functions = {k.SOURCE.stem: build_report(so, report)
                     for k, (so, report) in zip(KERNELS, built)}
        for src in TENSOR_CORE_SOURCES:
            if not sum(f["tensor_core_instr"] for f in functions[src]):
                raise AssertionError(f"{src} has no HMMA/HGMMA instruction")
        spills = [f["kernel"] for f in functions["nvt_probe"]
                  if f["spill_bytes"]]
        if spills:
            raise AssertionError(f"nvt_probe functions spill: {spills}")
        check_wgmma_bwd_build(functions["flash_attention"])
        check_ssd_bwd_build(functions["ssd_scan"])
        # the forward kernels on wgmma (flash_fwd_wg, the SSD's state and
        # chunk passes) likewise
        check_hgmma_build(functions["flash_attention"], WGMMA_FWD_FUNCTIONS,
                          "flash_attention")
        check_hgmma_build(functions["ssd_scan"], SSD_FWD_FUNCTIONS,
                          "ssd_scan")
        for src in TENSOR_CORE_SOURCES:
            BUILD_ROWS.update((f["kernel"], f) for f in functions[src])
        spills = [f["kernel"] for f in functions["decode_attention"]
                  if f["spill_bytes"]]
        if spills:
            raise AssertionError(f"decode_attention functions spill: "
                                 f"{spills}")
        BUILD_ROWS.update((f["kernel"], f)
                          for f in functions["decode_attention"])
        log({"phase": "build", "ok": True,
             "kernels": [k.SOURCE.stem for k in KERNELS],
             "libraries": [so.name for so, _ in built],
             "build_s": build_s, "functions": functions})
    else:
        log({"phase": "build", "skipped": "no card: --device cpu runs "
             "the plain versions"})

    # 2. map: the map's main path, with every kernel's launch count from 0
    stream = make_stream(sz, args.seed)
    reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    out = run_map(sz, stream, dev)
    launches = nvt_probe.launches
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    if on_card and launches == 0:
        raise AssertionError("the main path never launched nvt_probe")
    out["queries"] = stream["queries"]
    t0 = time.perf_counter()
    checks = check_map(sz, stream, out)
    log({"phase": "map", "ok": True, "device": str(dev),
         "sizes": dataclasses.asdict(sz), "stage_s": out["times"],
         "check_s": time.perf_counter() - t0, "launches": launches,
         **checks})

    # 3. sharded: the map's stream over 4 shards on the card, held
    # against the map phase, then a journaled live rebalance through a
    # crash (the shards probe by chain walk: no kernel launches)
    reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sharded = run_sharded(sz, stream, out, dev)
    live = run_live_rebalance(sz, dev, args.seed)
    log({"phase": "sharded", "ok": True, **sharded, "live_rebalance": live,
         "single_stage_s": out["times"],
         "peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card
         else None, "phase_s": time.perf_counter() - t0,
         "launches": {w.__name__: w.launches for w in WRAPPERS}})

    # 4. serve, then the same commits on a sharded, rebalancing log
    t0 = time.perf_counter()
    log({"phase": "serve", "ok": True, **run_serve(sz, dev),
         "sharded_log": run_sharded_serve(sz, dev),
         "phase_s": time.perf_counter() - t0})

    # 5. model: the serving path of both archs, one at a time, launch
    # counts from 0 (inside run_model)
    model = run_model(sz, dev, args.seed)
    dense = run_model(sz, dev, args.seed, "qwen2-7b")
    log({"phase": "model", "ok": True, "device": str(dev), **model,
         "qwen2-7b": dense})

    # 6. families: the MoE, SSM, encoder-decoder and VLM archs served the
    # same way, one at a time, launch counts from 0 (inside run_model)
    families = run_families(sz, dev, args.seed)
    log({"phase": "families", "ok": True, **families})
    fam = {a["arch"]: a for a in families["archs"]}

    # 7. train: qwen3-1.7b, mamba2-370m and zamba2-7b trained at full
    # width through the flash and SSD forward and backward kernels, launch
    # counts from 0 (inside _train_run), each twice from one seed; the
    # crash/resume recipe on each one's tiny form
    train = run_train(sz, dev, args.seed)
    log({"phase": "train", "ok": True, **train})

    # 8. load: LoadHarness points against the card's log and a qwen2-7b
    # engine, launch counts from 0 (inside run_engine_point)
    t0 = time.perf_counter()
    load = run_load(sz, dev, args.seed)
    log({"phase": "load", "ok": True, **load,
         "phase_s": time.perf_counter() - t0})

    # 9. checkpoint: zamba2-7b's parameters saved, crashed, recovered,
    # restored onto the card and served by a prefill
    t0 = time.perf_counter()
    log({"phase": "checkpoint", "ok": True,
         **run_checkpoint(sz, dev, args.seed),
         "phase_s": time.perf_counter() - t0})

    # 10. checks: kernels against their plain versions, and consistency
    t0 = time.perf_counter()
    fa_errs = check_flash(sz, dev)
    ssd_errs = check_ssd(sz, dev)
    cons = check_consistency(sz, dev, args.seed)
    dense_cons = check_consistency(sz, dev, args.seed, "qwen2-7b")
    fam_cons = {arch: check_consistency(sz, dev, args.seed, arch)
                for arch in CONSISTENCY_ARCHS}
    bwd_errs = check_flash_bwd(sz, dev)
    ssd_bwd_errs = check_ssd_bwd(sz, dev)
    train_cons = {arch: check_train_consistency(sz, dev, args.seed, arch)
                  for arch in (TRAIN_ARCH,) + SSM_TRAIN_ARCHS
                  + (MOE_TRAIN_ARCH,)}
    reduce_check = check_compressed_grads(sz, dev, args.seed)
    gpipe_check = check_gpipe(sz, dev, args.seed)
    log({"phase": "checks", "ok": True, "flash_attention": fa_errs,
         "compressed_grads": reduce_check, "gpipe": gpipe_check,
         "flash_attention_bwd": bwd_errs, "ssd_scan_bwd": ssd_bwd_errs,
         **{f"consistency_train_{a}": c for a, c in train_cons.items()},
         "ssd_scan": ssd_errs, "consistency": cons,
         "consistency_qwen2-7b": dense_cons,
         **{f"consistency_{a}": c for a, c in fam_cons.items()},
         "reduced": [f"{a} consistency: capacity_factor "
                     f"{get_arch(a).capacity_factor} -> "
                     f"{c['capacity_factor']} (no token dropped)"
                     for a, c in fam_cons.items() if "capacity_factor" in c]
         + [f"{a} gradient check: n_layers {get_arch(a).n_layers} -> "
            f"{c['n_layers']}, one sequence of {c['S']}"
            + (f", capacity_factor {get_arch(a).capacity_factor} -> "
               f"{c['capacity_factor']} (no token dropped)"
               if "capacity_factor" in c else "")
            for a, c in train_cons.items()]
         + ["gpipe: a demo stack of dense blocks with no published config "
            "(the reference's own demo): 4 stages of 2 blocks at d_model "
            "2048, d_ff 8192, 8 microbatches of [2, 512], on one card"],
         "check_s": time.perf_counter() - t0})

    # 11. ordered: the map's stream on the ordered map, its reads, and the
    # journaled durable ordered map through a crash (no kernel launches)
    reset_launches()
    ordered = run_ordered(sz, stream, dev, args.seed)
    t0 = time.perf_counter()
    ord_checks = check_ordered(sz, stream, ordered)
    ord_checks["check_s"] = time.perf_counter() - t0
    durable = run_durable_ordered(sz, dev, args.seed)
    log({"phase": "ordered", "ok": True, "stage_s": ordered["times"],
         "plan_steps": ordered["steps"], **ord_checks, "durable": durable,
         "launches": {w.__name__: w.launches for w in WRAPPERS}})
    del ordered

    # 12. migrate: journaled growth through a crash and a recovery
    reset_launches()
    log({"phase": "migrate", "ok": True, **run_migrate(sz, dev, args.seed),
         "launches": {w.__name__: w.launches for w in WRAPPERS}})

    # 13. crash: every crash scenario at every site x adversary
    t0 = time.perf_counter()
    log({"phase": "crash", "ok": True, "scenarios": run_crash(dev),
         "crash_s": time.perf_counter() - t0})

    # 14. paper: the instruction-level structures, checkers and traces on
    # the host, bridged to the card's engines (nvt_probe launched once)
    reset_launches()
    t0 = time.perf_counter()
    paper = run_paper(sz, dev, args.seed)
    paper_launches = {w.__name__: w.launches for w in WRAPPERS}
    if on_card and paper_launches["nvt_probe"] < 1:
        raise AssertionError("the paper phase never launched nvt_probe")
    log({"phase": "paper", "ok": True, **paper, "launches": paper_launches,
         "phase_s": time.perf_counter() - t0})

    # 15. examples: the port's examples and tools on the card, each with
    # its own assertions, launch counts from 0 (inside run_script)
    t0 = time.perf_counter()
    examples = run_examples(dev)
    log({"phase": "examples", "ok": True, **examples,
         "phase_s": time.perf_counter() - t0})

    # 16. timing; then 17. dryrun: the cells of this run on the meta
    # device, held against what the card did, traced once every phase
    # that reads the host's clock is over
    if not on_card:
        log({"phase": "timing", "skipped": "no card"})
        log(dryrun_phase(sz, model, dense, families, train))
        print(json.dumps({"ok": True, "rehearsal": "cpu"}))
        return 0
    kern = time_probe(out, launches, checks["max_abs_err"])
    # each kernel against its plain versions at the serve shape (the
    # reference's own bf16 rounding, chunked_bf16_*, is not the kernel's)
    fa_err = fa_errs["bf16_S512"]
    ssd_err = max(v for k, v in ssd_errs.items()
                  if k.startswith("bfloat16_S512") and "chunked_bf16" not in k)
    # flash_attention: an entry a main-path shape, each with the launches
    # made at that shape (zamba2-7b's and qwen2-7b's model runs, the load
    # phase's engine point)
    engine = load["points"]["engine_closed_zipf1.3"]
    B, S, H, K, d = engine_flash_shape(sz)
    kernels = [
        kern, time_flash(dev, model["launches"]["flash_attention"], fa_err),
        time_flash(dev, dense["launches"]["flash_attention"], max(
            fa_errs["qwen2_bf16_S512"], fa_errs["qwen2_bf16_S500"]),
            "qwen2-7b"),
        time_flash(dev, engine["launches"]["flash_attention"],
                   fa_errs["qwen2_engine_bf16"], "qwen2-7b",
                   (B, S, S, H, K, d, True), "load engine point"),
        time_ssd(dev, model["launches"]["ssd_scan"], ssd_err)]
    # the families' shapes: an entry a new main-path shape, with the
    # launches the families phase made at it
    for key, shape in family_flash_shapes(sz).items():
        arch = FLASH_SHAPE_ARCHS.get(key, "whisper-medium")
        err = max(v for k, v in fa_errs.items() if k.startswith(key))
        kernels.append(time_flash(
            dev, launches_at(fam[arch]["flash_shapes"], shape), err, arch,
            shape, "families" + ("" if arch != "whisper-medium"
                                 else " " + key[len("whisper_"):])))
    # the training shape: the forward (each layer's and its remat
    # recompute) and the two backward kernels, with the train phase's
    # launches at that shape
    kernels.append(time_flash(
        dev, train["launches"]["flash_attention"],
        bwd_errs["qwen3_train_bfloat16"]["fwd_err"], TRAIN_ARCH,
        train_shape(sz), "train"))
    kernels.extend(time_flash_bwd(
        dev, train["launches"]["flash_attention_bwd"], bwd_errs, sz,
        BUILD_ROWS))
    # the SSM and hybrid training shapes: ssd_scan's forward (each Mamba2
    # layer's and its remat recompute, writing the chunk states) and its
    # backward; zamba2's shared block's flash forward and its wgmma
    # backward pair, each with the launches the train phase made there
    for arch in SSM_TRAIN_ARCHS:
        at = train[arch]["launches_at_shape"]
        kernels.append(time_ssd(dev, at["ssd_scan"], None, arch, "train",
                                sz))
        kernels.append(time_ssd_bwd(dev, at["ssd_scan_bwd"], ssd_bwd_errs,
                                    sz, arch, BUILD_ROWS))
    z = train["zamba2-7b"]["launches_at_shape"]
    kernels.append(time_flash(
        dev, z["flash_attention"], bwd_errs["zamba2_train_bfloat16"][
            "fwd_err"], "zamba2-7b", train_shape(sz, "zamba2-7b"), "train"))
    kernels.extend(time_flash_bwd(dev, z["flash_attention_bwd"], bwd_errs,
                                  sz, BUILD_ROWS, "zamba2-7b",
                                  "zamba2_train"))
    # the MoE training shape: the flash forward and the wgmma backward
    # pair at [1, 4096, 4096, 16, 16, 128], with the train phase's launches
    moe = train[MOE_TRAIN_ARCH]["launches_at_shape"]
    kernels.append(time_flash(
        dev, moe["flash_attention"], bwd_errs["qwen2_moe_train_bfloat16"][
            "fwd_err"], MOE_TRAIN_ARCH, train_shape(sz, MOE_TRAIN_ARCH),
        "train"))
    kernels.extend(time_flash_bwd(dev, moe["flash_attention_bwd"], bwd_errs,
                                  sz, BUILD_ROWS, MOE_TRAIN_ARCH,
                                  "qwen2_moe_train"))
    kernels.append(time_ssd(
        dev, fam["mamba2-370m"]["launches"]["ssd_scan"],
        max(v for k, v in ssd_errs.items()
            if k.startswith("mamba2_bfloat16_S512")
            and "chunked_bf16" not in k), "mamba2-370m", "families"))
    # decode_attention at the served cell's decode shapes (the model
    # phase holds its launches to a call a layer and decode step)
    kernels.extend(time_decode_attention(dev))
    # the examples' shapes: the f32 scalar kernel, with the launches the
    # examples phase made at each
    for ex in examples["flash_shapes"]:
        B, Sq, Sk, H, K, d, causal, window = ex["key"]
        entry = time_flash(dev, ex["launches"], None,
                           EXAMPLE_ARCHS[ex["script"]],
                           (B, Sq, Sk, H, K, d, causal, window), "examples",
                           torch.float32)
        entry.update(script=ex["script"], bwd_launches=ex["bwd_launches"])
        kernels.append(entry)
    log({"phase": "timing", "ok": True, "warm_s": warm_stages(sz, stream,
                                                             out, dev),
         "walk_step_sync_us": sync_step_us(dev),
         "max_chain": checks["max_chain"], "peak_map_bytes": peak})
    log(dryrun_phase(sz, model, dense, families, train))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
