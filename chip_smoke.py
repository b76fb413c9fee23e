#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card. Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. card: name and power limit (nvidia-smi);
2. build: the ten CUDA sources (rbf, rbf_icf, xcov_diag,
   flash_attention, flash_attention_bwd, ssd_intra_chunk,
   ssd_intra_chunk_bwd, chol_downdate and its probes,
   chol_downdate_probe, row_products) from the checkout
   (nvcc, sm_90a, one compiler per source, started together) into
   build/kernels/; every float32 xcov_diag instance must hold wgmma (HGMMA)
   in its SASS;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main paths' shapes and at edge cases, within the tolerances
   stated below, and each timed at its main path's shape (flash also
   against ``scaled_dot_product_attention``, a yardstick the port never
   calls, with its TFLOP/s and the host cost of a decode launch, and
   without the causal mask at whisper's encoder, cross-attention and
   cross decode shapes; rbf's
   block instance by profiler device time, and its ICF instance (all of
   select_support's pivot steps in one launch) against the plain loop in
   float64 (pivots identical) and float32 (replayed along its pivots), with
   its operations bound and a probe of R empty grid barriers, and in its
   prose line the modelled time of streaming the GEMVs from HBM; SSD with
   both its bounds and, in its prose line, the GFLOP its tiles execute as
   counted from them; xcov_diag at four of the GP path's query buckets,
   with its 3xTF32, bytes and f32 CUDA-core bounds, and on a fitted,
   conditioned pPITC state; the Cholesky downdate in float32 and float64
   at the streaming path's (2048, 1600), at ragged shapes, at the edges of
   its 32 x 32 tiles and with zero columns, every case bitwise
   the plain version, its float64 instance free of spills, timed beside
   its bounds, its issue bound (a model from the SASS of its row
   update), its serial floor (a probe of its chain of diagonal items),
   the plain version and, in float64,
   ``torch.linalg.cholesky`` of the formed difference as a yardstick).
   Each flash, SSD, xcov_diag, ICF
   and downdate case runs three times and every run must equal the first
   (an ICF case also with fewer factor rows kept on chip); every float32
   xcov_diag launch must take the tensor-core instance; the two backward
   kernels against autograd through their plain versions (flash at qwen3's
   training shape as phase 8 launches it, a microbatch on (B, T, H, D)
   views, and at its prefill shape, whisper's encoder and cross shapes, a
   sliding window and small edge cases in bf16 and f32; SSD in f32 at
   mamba2's training shape, whose head groups are phase 8's, at its
   prefill shape and at edges), each case launched twice (equal: no
   atomics); each flash case also holds the forward's log-sum-exp against
   the plain one and its output bitwise against the forward without that
   store, and counts the wgmma route's launches (bf16 at D = 64 and 128,
   not D = 256, not f32); both timed at the training and prefill shapes
   beside their bounds, the plain versions, the flash backward's two-pass
   mma.sync route on the same inputs and, for flash, SDPA's backward; the
   row products of pPIC's routed diag (rows_mm, rows_reduce) at a 256-row
   request's shapes in float32 and float64, each stage on the previous
   one's output (bitwise the plain version in float64 and for
   rows_reduce, rows_mm float32 within TOL_ROWS_F32), three runs equal,
   each row the same bits alone, in the capacity-|U| batch and as an
   indexed overflow group, timed beside their bounds, the plain versions,
   the library's GEMMs on the same inverses (bmm, baddbmm) and the
   parent's route (trsm and GEMM against the factors) on the same stages;
4. GP main path: pPITC at the paper's AIMPEAK configuration (|D| = 32000,
   M = 20, |S| = 2048, d = 5, float32): support selection, fit, plan,
   warm-up, 8 requests through ``plan.diag``; support selection must be
   one launch of the ICF kernel, outputs must be finite, the test RMSE
   0.3040 +- 0.002 with no negative variance, the fused diag must agree
   with the compose path, the requests must build no triangular inverse
   (the plan's are cached per state) and every xcov_diag launch must take
   the float32 tensor-core instance;
4b. GP pPIC routed: phase 4's data, support set and hyperparameters,
   co-clustered (Remark 2), ``api.fit("ppic")`` in float32, then the same
   8 requests through ``plan(ServeSpec(routed=True)).routed_diag`` after
   warming the whole overflow ladder; the test RMSE must be at most
   0.3040 + 0.002 with no negative variance, the error against a float64
   fit of the same data within 10 x pPITC's own + 1e-4, every request
   launching rows_mm and rows_reduce, a permuted request and the request
   served in chunks of 7 and 64 bitwise equal to the whole, a skewed request at each of four blocks must overflow (g > 0)
   and equal the capacity-|U| layout bitwise (the first is also run stage
   by stage in both layouts, every stage of the per-block program
   bitwise), the cached C^-1 with the default path, a dead block's rows
   must be served by xcov_diag from the global posterior, and a traced
   256-row request (kernels, busy share) must show rows_mm and
   rows_reduce and no trsm kernel;
4c. GP pICF and MLE, on phase 4's data and hyperparameters, M = 20,
   R = 2048: the ICF kernel at pICF's instance (32000, 2048, 5) against
   the plain loop in float64 (pivots identical; F, residual and pivot
   values within icf_tolerance) and float32 (near ties), timed beside its
   operations bound and the streaming model of its plan; then
   ``api.fit("picf")`` in float32 (exactly one ICF launch, rbf block
   launches for K_{U,D_m}) and the 8 requests through ``plan.diag``; the
   kernel path against the plain path (``impl="torch"``) in float64:
   pivots, F, Phi_L and ydd, and the served mean and variance within
   limits derived from rbf.cu's float32 accumulation; float32 against
   float64 (RMSE within 10%, negative-variance shares within 0.05; the
   method's instability at low rank is reproduced, with no RMSE gate);
   then ``hyper.fit`` (exact likelihood, 10 Adam steps on the paper's
   10000-point subset) in float64 (losses must fall) and float32 (step 0
   within its stated limit), and ``hyper.fit_parallel`` on all 32000 rows
   in float32 (3 steps, finite: Sdd factored from its square root);
4d. GP streaming and faults, on phase 4's data, support set and
   hyperparameters, float32 unless stated: (a) a pPITC store on the first
   16000 rows over 10 machines, the other 16000 assimilated over 10 more
   (blocks of 1600, the cold fit's partition), ``to_state`` and the 8
   requests through ``plan.diag`` (RMSE 0.3040 +- 0.002), Sdd_L, alpha
   and the served output against phase 4's cold fit; (b) ``retire(3)``
   (exactly one chol_downdate launch: the float32 factor downdated in
   float64) against a float64 refold of the 19 survivors, ``revive(3)``
   against (a), with the downdated factor's errors printed beside the
   reference's float32 downdate; (c) ``with_alive`` missing 2
   machines (incremental) and 12 (auto: the refold), each against a
   float64 refold; (d) ``fault.fail`` then ``fault.recover_reassign``
   against (a); (e) pPIC on phase 4b's co-clustered order streamed the
   same way, the 8 requests through ``routed_diag`` (RMSE <= 0.3060,
   against phase 4b's fit), a dead block's rows from the global posterior
   through xcov_diag, and the block retired from the store (one
   downdate, 19 blocks served) against a float64 pPIC store streamed and
   retired the same way; (f) pICF at R = 2048 streamed the same way and
   ``retire(3)`` (one downdate of Phi_L), in float32 and float64
   (negative-variance shares within 0.05), and phase 4c's float32-vs-
   float64 rules on a second AIMPEAK draw (seed 1), cold and streamed.
   Limits: 10 x the cold float32 fit's own error against a float64 fit +
   1e-4, quantity by quantity. Each step is timed (host clock +
   synchronize), with the phase's peak device memory, and its kernel
   launches are counted apart: those of the float32 stores' own steps and
   serving (the main path's, in phase 7's line) and those of the float64
   yardsticks and the records;
4f. GP serving runtime, on phase 4's data, its fitted pPITC state and
   phase 4b's co-clustered pPIC fit: (a) a ``GPServer`` over pPITC
   (max_batch 256, deadline 2 ms, warmed up) fed the 3200 test points one
   by one in a seeded order with ``pump()`` between submits, each flush's
   tickets collected at once; every ticket must equal ``plan.diag`` of its
   flush's rows bitwise; it prints the submit-to-result latency p50/p99,
   the flushes by trigger and the launches a flush; (b) one
   ``TenantScheduler`` over the pPITC tenant (weight 1) and a routed pPIC
   tenant (weight 2), the same points alternating: each tenant bitwise a
   single-tenant ``GPServer`` fed the same flushes (the dispatch log's),
   the pPIC tenant's tickets bitwise one ``routed_diag`` over all of their
   queries, no callable built after warm-up, a third tenant of pPIC's lineage
   sharing its callables; (c) a server over ``init_store("ppitc")`` on
   the first wave, then ``update`` (the second), ``retire_machine(3)``
   and ``revive_machine(3)``, 100 tickets pending across each swap
   resolved bitwise against the state before it, each posterior within
   phase 4d's limit of its phase 4d yardstick, one ``chol_downdate``
   launch (the retire); (d) ``checkpoint_store``/``restore_store`` of the
   pPITC and pPIC stores into fresh servers (bitwise), a state's
   ``swap_from_checkpoint`` (detaches the store, bitwise),
   ``TenantRegistry.admit_from_checkpoint`` (an equal ServeSpec,
   bitwise), each file's bytes and save/load seconds, in a temporary
   directory the phase removes; (e) the routed pPIC tenant with a health
   policy reviving from its store checkpoint: a block poisoned by
   ``chaos.poison_state`` is retired, its rows served degraded through
   ``xcov_diag`` and every ticket finite, ``pump()`` revives it and the
   output equals the one before the poisoning bitwise; then the
   checkpoint is corrupted (``FaultInjector.corrupt``) and the next revive
   must be refused (``n_revive_failures == 1``), the block left retired.
   Its kernels' launches (``launches_serving`` in phase 7's line) are
   counted apart from the yardsticks' (the plan's output on each flush,
   the single-tenant replays, the restored servers' checks);
4g. GP over processes, on phase 4's data, support set and hyperparameters
   (M = 20, R = 2048, U = the 3200 test inputs): it prints the backend
   table (``parallel/runner.py``'s constant ``BACKEND_TABLE``), then runs
   the collective programs (pPITC and pPIC ``predict_distributed`` and
   fits; pICF's ``icf_factor_local`` once, its pivot columns from rbf.cu's
   exact instance, and ``machine_step``, ``machine_step_sharded_u`` and
   the store from that factor; ``select_support_parallel`` on
   ds.X[:8192]; ``hyper.pitc_nlml`` and its gradient; the axis's
   collectives and ``ring_all_reduce``; all float64; in float32 the pPITC
   fit served through ``plan.diag``, the pICF fit and the collective
   selection) (a) on the stacked axis, one process (``VmapRunner``), the
   yardstick; there the collective ICF loop must find the ICF kernel's
   pivots and its store the ``VmapRunner`` fit's state, and it prints how
   far the float32 loop's selection agrees with phase 4's S, whether the
   reference's float32 formed-Sdd Cholesky gives NaN, and pICF's two
   layouts on float32 data; (b) on 4 gloo ranks sharing cuda:0, 5
   machines each, spawned (``torch.multiprocessing``, a ``file://``
   rendezvous in a temporary directory); (c) on one NCCL rank holding all
   20 (a one-rank ``ShardMapRunner`` takes the collective route: the TSQR,
   the pivot loop, NCCL's all-gather and reduce-scatter). Each rank loads
   phase 2's kernels (never nvcc), reads (a)'s results through CUDA IPC,
   and holds its own within DIST_TOL of 1 + |value| (pivots and the
   float32 selection equal; the float32 pPITC fit's RMSE and its error
   against the float64 fit as phase 4's); it prints each program's wall
   time and collective calls and bytes beside the paper's Table 1 term,
   its peak device memory and its rbf launches, block and exact
   (``launches_dist``, ``launches_dist_exact`` in phase 7's line). A
   rank's exception, or no answer within DIST_JOIN_S, fails the run;
4e. phase 4's pPITC fit FIT_REPEAT more times, each traced for the
   device's busy time beside its wall time, then once more for its
   largest kernels;
5. LM main path, qwen3-1.7b at full width and depth (random weights from
   seed 0, bfloat16 compute): prefill of 4 x 4096 tokens through
   ``forward(logits_last_only=True)``, then ``prefill_then_decode`` (4
   prompts of 32 tokens, 32 greedy new tokens), every flash launch of
   which must take the sm90 kernel; then, in float32, the forward logits
   against ``decode_step``'s at every position;
5b. LM MoE, qwen3-moe-30b-a3b at full width, 8 of its 48 layers (einsum
   dispatch, capacity 1.25): the same prefill and generation, with the
   prefill's dropped fraction and load-balance loss; the float32 check
   with a capacity that drops nothing; one MoE layer at the prefill's
   shape in both dispatch modes, which must agree when nothing drops; the
   prefill again on Zipf, uniform and distinct ids, each MoE layer's
   dropped pairs held to the overflow of its routed counts, with its
   busiest expert and the first layer's routing of the embeddings alone;
5c. LM encoder-decoder, whisper-medium whole: ``encode`` of 4 x 1500
   frames, ``precompute_cross_kv``, a decoder prefill of 4 x 448 over the
   encoder, greedy generation over the precomputed cross K/V; the
   encoder's and the cross-attention's flash launches (non-causal) are
   counted apart and must number as the layers say; the float32 check
   over precomputed cross K/V;
5d. LM VLM input, qwen2-vl-72b at full width, 4 of its 80 layers: a
   prefill of 4 x 4096 from ``inputs_embeds`` (text embeddings around a
   block of patch embeddings) with distinct (t, h, w) M-RoPE position
   rows, finite logits; in float32, ``inputs_embeds`` of the tokens equal
   to the tokens' forward, bit for bit;
6. LM main path, mamba2-130m, the same as phase 5;
8. LM training through ``launch.train`` (``init_state``,
   ``make_train_step``, ``TokenLoader``), remat on, bf16 compute, f32
   weights and Adam: qwen3-1.7b whole at seq 4096, global batch cut
   256 -> 4 (2 microbatches of 2), and mamba2-130m whole at 8 x 4096; a
   warm-up step, then 3 timed steps (s, tokens/s, losses finite, peak
   memory), each step's forward and backward kernel launches equal to the
   layers x microbatches (twice for the forward: remat), every qwen3
   backward launch on the flash backward's wgmma route; one more step of
   each traced (``launch.train_profile``: wall, busy, the backward
   kernels' share of device time); mamba2's state at step 2 through a
   ``CheckpointManager`` (async save), the next step retaken from the
   restored state bit for bit; then one float32 gradient at smoke width on
   the card (the kernels) against the CPU (the plain versions);
9. LM continuous batching (``launch.scheduler.ContinuousBatcher``),
   qwen3-1.7b and mamba2-130m whole (random weights, seed 0, bf16): 4
   slots, max_len 128, 8 requests from a seed (prompts of 8-48 tokens,
   max_new 8-32), eos_id a token that request 0's greedy run alone emits
   midway; each request's tokens must be bitwise ``prefill_then_decode``'s
   for it alone (batch 1, the same max_len, cut at EOS; on a difference
   the first position and the logit gap there are printed), at least one
   request must end on EOS, and qwen3's flash_sm90 launches must be 28 a
   decode step; it prints generated tokens/s, each request's latency in
   ticks and ms (p50, max) and the ticks;
10. the LM's steps over a ``DeviceMesh``: (a) one NCCL rank, mesh (1, 1)
   ("data", "model"): ``on_mesh``'s 2 steps bitwise ``train_step``'s
   (losses, metrics, every leaf; ``TokenLoader(mesh)``'s rows bitwise) on
   mamba2-130m whole at 8 x 4096 and qwen3-1.7b cut to 4 layers at 4 x
   4096 in 2 microbatches, and ``make_serve_step`` on qwen3-1.7b whole, B
   = 4, 16 steps, logits bitwise ``decode_step``'s; (b) four gloo ranks
   sharing cuda:0, mesh (2, 2), float32 compute: qwen3-1.7b at 2 layers
   (tensor parallelism forced on) and mamba2-130m whole (pure data
   parallelism) at 4 x 512, the sharded train step against the one-process
   step on the card (loss 1e-5; Adam's moments 1e-4 of each leaf's max;
   the parameters' update its sign and size within 0.1 lr where mu settles
   the gradient's sign) and 4 serve steps (B = 4) against
   ``decode_step`` (MESH_TOL_LOGITS); each run's kernel launches counted;
   each rank's shard bytes (train state; parameters and serve state) must
   equal the dry-run's per-rank bytes (``launch.dryrun`` on the meta
   device, mesh (2, 2), the same cut configs), and its collectives'
   calls and bytes in each train step and in the 4 serve steps the
   dry-run's recording axes', collective by collective;
11. the dry-run against the card (``launch.dryrun`` at mesh (1, 1), rank
   0's step traced on the meta device): qwen3-1.7b's phase-8 step (4 x
   4096, 2 microbatches) and mamba2-130m's (8 x 4096), qwen3's prefill (4
   x 4096) and decode step (B = 4): the dry-run's per-rank state bytes
   must equal the real state's on the card (parameters and Adam's
   moments; parameters; parameters and serve state), printed beside one
   step's peak memory and seconds, the traced and the model FLOP and the
   roofline's t_compute / t_memory (``roofline.analysis``); then the
   contract audit on the card (``analysis.contracts.run_audit``): 3 rebind
   generations with no callable built, identical fingerprints and kernel
   launches in each, the tenant interleaving, no ``no_retrace``
   violation;
7. one JSON line listing each kernel's launches, error, times and bound.
   Phases 8-11 run before it; every phase prints its seconds.

Each main path zeroes its kernels' launch counts just before it and reads
them just after; a kernel of the path that was not launched fails the run.

The last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
Imports nothing of JAX and nothing of the JAX package.

``python3 chip_smoke.py --phases 3,8`` runs phases 1 and 2, then only the
backward kernels' checks of phase 3 and/or phase 8 (no kernels line; the
last line also names the phases): the quick run after a change to the
backward kernels or the training path. ``--phases downdate`` runs phases
1 and 2, then only phase 3's ``check_downdate``: the quick run after a
change to the downdate kernel. ``--phases 9,10`` runs phases 1 and 2, then
9 and 10: the quick run after a change to the batcher or the steps over a
mesh. ``--phases 11`` runs phases 1 and 2, then 11. ``--phases 4b`` runs
phases 1 and 2, phase 3's ``check_rows``, phase 4 (for the data, support
set and state 4b reuses) and 4b, then prints a kernels line of rows_mm and
rows_reduce alone: the quick run after a change to the row products or to
pPIC's routed serving.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The H100's published peaks (``repro_torch.roofline.hw``) and each
# kernel's FLOP and byte counts (``repro_torch.roofline.kernels``): one copy,
# which ``launch.profile``, ``launch.train_profile`` and ``launch.xcov_sweep``
# read too. Bound in ``main`` once ``src`` is on the path (spawned children
# do not use them).
hw = rk = None

# Kernel-vs-plain tolerances (max abs error):
#  rbf f32 1e-5 and bf16 3e-2 are the reference's own (tests/test_kernels.py).
#  xcov_diag f64 1e-10 is the reference's fused-vs-compose gate.
#  xcov_diag f32 at s = 2048 is 1e-4, not the reference's 1e-5 (which it set
#  at s <= 130): the kernel multiplies by an explicit triangular inverse where
#  the plain version solves, and both sum 2048 products per entry in
#  different orders, so the float32 rounding differences grow with s. The
#  kernel's products are 3xTF32 (float32-like error); one TF32 product would
#  miss this limit on a fitted state, which check_xcov shows.
TOL_RBF = {"float32": 1e-5, "bfloat16": 3e-2}
#  rbf's exact instance (the ICF loop's pivot column) against its plain
#  version, which forms the cross term by a matmul: the squared distance
#  (up to ~15 here) rounds differently by a few eps x 15, and exp passes it
#  on times the output (<= sig2 = 1.3): float32 1e-5 as rbf's, float64
#  1e-13 (~30x that estimate).
TOL_RBF_EXACT = {"float32": 1e-5, "float64": 1e-13}
#  ICF float32: the plain loop replayed along the kernel's pivots must find
#  each of them within 1e-4 sig2 of its own largest residual. Both round
#  each step's GEMV (i terms) in their own order, an error of ~sqrt(i) eps
#  sig2 in f that the division by sqrt(d_p) amplifies and d accumulates:
#  ~1e-5 sig2 late in a 2048-step run, so 1e-4 leaves 10x. Where the plain
#  loop's two largest residuals are closer than that, the two may pick apart
#  (printed: the steps they agree for). float64 pivots must be identical.
TOL_ICF_TIE = 1e-4
#  ICF float32 F against that replay, x sqrt(sig2) (F's largest entry): set
#  from readings on the H100, ~13x the largest. They were 2.9e-5 on the
#  AIMPEAK candidates (sig2 1) and 2.9e-5 to 3.9e-5 sqrt(sig2) at (8192,
#  2048, 5) on random inputs, seeds 3-5 (tests/test_torch_cuda.py); late
#  rows' entries are ~0.07 sqrt(sig2), so a wrong row or column errs by
#  100x this limit.
TOL_ICF_F32 = 5e-4
ICF_REPEAT = 3           # launches of each ICF case (each equal)
TOL_XCOV_F64 = 1e-10
TOL_XCOV_F32_S2048 = 1e-4
XCOV_REPEAT = 3          # launches of each xcov case (each equals the first)
XCOV_TIMED_N = (8, 256, 1024, 3328)   # the main path's query buckets
PROFILE_TRIES = 3        # traces of one measurement before giving up
#  flash 2e-3 f32 and 3e-2 bf16 are the reference's own
#  (tests/test_kernels.py). They are absolute, and at the main path's shapes
#  a row that sees n keys of random data has outputs of ~0.8 sqrt(e / n)
#  (0.03 at n = 2048), so a wrong tile would pass them. Each flash case is
#  therefore also held to a limit scaled to the output's size, row by row:
#  max_d (|got - want| - r |want|)+ <= c rms_d(want). r = 2^-7 in bf16 is
#  one bf16 ulp of the output (both sides round their float32 result to
#  bf16), 0 in f32. c = 2e-2 in bf16: the kernel rounds P to bf16 for the
#  P.V product, as FlashAttention does, an error of up to 2^-9 per term that
#  reaches 0.74% of the row RMS over 8M outputs in a CPU emulation of that
#  rounding; one key tile dropped errs by > 10x the row RMS and late rows
#  scaled by 1.02 by 6.9%. c = 1e-4 in f32 (rounding order only).
#  SSD 3e-4 for Y and S, 1e-5 for cum, are the reference's own
#  (tests/test_ssd_kernel.py), set for outputs of up to ~10 whose cumsum
#  both sides computed alike. The kernel's block scan and torch.cumsum round
#  cum (~ -20 at cs = 256) differently by ~1e-6, which exp(cum_i - cum_j)
#  carries into Y and S relative to their size, and at cs = 256, N = 128
#  they reach ~1e2: beyond 10 the tolerance grows with the output's size
#  (3e-5 relative; a wrong tile or mask errs by the output's own size).
TOL_FLASH = {"float32": 2e-3, "bfloat16": 3e-2}
TOL_FLASH_ROW = {"float32": (0.0, 1e-4), "bfloat16": (2.0 ** -7, 2e-2)}
# launches of each flash case (each must equal the first), and of the loop
# that reads the host cost of one decode launch
FLASH_REPEAT, FLASH_HOST_CALLS = 3, 200
TOL_SSD = (3e-4, 3e-4, 1e-5)
SSD_REPEAT = 3           # launches of each SSD case (each must equal the first)
# Forward vs decode logits, float32 compute, full width and depth: the
# reference holds 5e-4 on its two-layer smoke widths (tests/test_models.py).
# The batched forward and the one-token decode sum in different orders
# (cuBLAS picks other algorithms for 256 rows than for 2, the flash kernel
# tiles the keys differently), and those float32 roundings compound over
# 14x more layers of the residual stream: 2e-3, on logits of order 1.
TOL_CONSISTENCY = 2e-3
#  The Cholesky downdate against its plain version (ref.py), max abs error
#  on factors of entries O(1): the kernel does the plain version's
#  operations on the same values with the same roundings (the _rn
#  intrinsics, no FMA), so it should agree bit for bit (printed); the limit
#  is the reference's own 1e-12 in f64 (tests/test_state_store.py) and
#  1e-5 in f32, where a wrong row, column or sweep errs by O(0.1).
TOL_DOWNDATE = {"float32": 1e-5, "float64": 1e-12}
DOWNDATE_REPEAT = 3      # launches of each downdate case (each equal)
#  The row products of pPIC's diag (row_products.cu) against their plain
#  versions (ref.rows_mm, ref.rows_reduce) on the same inputs. float64 and
#  rows_reduce in both types: bitwise (the same correctly rounded products
#  and sums in the same order). rows_mm float32: max |kernel - plain| over
#  max (|C0| + |X| |op B|) <= TOL_ROWS_F32. Both sum K products in float32:
#  the plain version over K / 8 tree sums in turn (<= (K / 8 + 3) 2^-24 of
#  the sum of |terms|, 1.5e-5 at K = 2048), the kernel over K / 8 mma steps
#  (the same, 1.5e-5), and 3xTF32 drops lo lo' and truncates lo (<= 3 x
#  2^-21 a product, 1.4e-6); 1e-4 is 3x their sum. A wrong tile, entry or
#  mask errs by O(1) of the scale.
TOL_ROWS_F32 = 1e-4
ROWS_REPEAT = 3          # launches of each row-product case (each equal)
ROWS_U = 32              # rows a block: the main bucket of a 256-row request
#  rows a block of the 3200-row request's main bucket: routed_capacity(3328,
#  20) at the 8-row query tile, 6720 rows in all
ROWS_U_LARGE = 336
#  The backward kernels against their plain versions (autograd through
#  ref.attention / ref.intra_chunk in float32 on the same inputs), max abs
#  error per gradient <= tol x max|want| of that gradient.
#  flash f32 1e-4: the FMA kernel sums in another order, nothing else.
#  flash bf16 2e-2: the kernel rounds P and dS to bf16 for their products
#  (2^-9 a term) and dq, dk, dv to bf16 (2^-8 of each value). A term's
#  rounding is at most 2^-9 |P_ij dO_i|; summed over a causal row of n
#  keys against a gradient of size ~sqrt(sum P^2), the worst case is
#  ~ln(n) / 1.3 x 2^-9 = 1.2% at n = 4096, random signs far less; a wrong
#  tile or mask errs by the gradient's own size.
#  SSD f32 1e-4: both sum in float32 in other orders (the kernel's cumsum
#  is the forward's compensated scan, torch.cumsum another); cum reaches
#  ~-20 at cs = 256, so exp(cum_i - cum_j) carries ~1e-6 relative.
TOL_BWD = {"flash": {"float32": 1e-4, "bfloat16": 2e-2},
           "ssd": {"float32": 1e-4, "bfloat16": 1e-2}}
#  The forward's log-sum-exp (written for the backward) against the plain
#  one from the same inputs, absolute, in natural-log units: both sum the
#  products and the exponentials in float32 in other orders, and the
#  kernel's exp2 / log2 are the hardware approximations (~2 ulp), on LSEs
#  of ~10 over up to 4096 keys: ~1e-5; 1e-4 leaves 10x. A missing tile or
#  key errs by its share of the sum, a wrong mask by O(1).
TOL_LSE = 1e-4
BWD_REPEAT = 2      # launches of each backward case (each equal: no atomics)


def ssd_tol(want, base: float) -> float:
    return base * max(1.0, float(want.abs().max()) / 10.0)


def flash_row_err(got, want, r: float) -> float:
    """max over rows of max_d (|got - want| - r |want|)+ / rms_d(want); a
    row whose want is all zero (no valid key) must match exactly."""
    g, w = got.double(), want.double()
    excess = ((g - w).abs() - r * w.abs()).clamp(min=0).amax(-1)
    rms = w.pow(2).mean(-1).sqrt()
    ratio = excess / rms.clamp(min=1e-300)
    return float(ratio.max())


M, N_TRAIN, N_TEST, S_SIZE, D = 20, 32000, 3200, 2048, 5
# The fit's test RMSE at this configuration (standardized; every run since
# the port's first, at the noise floor of 0.3): the support set selected on
# the card must leave it there.
RMSE_AIMPEAK, TOL_RMSE = 0.3040, 0.002
ICF_CANDIDATES = 8192        # select_support's pool: ds.X[:8192]
FIT_REPEAT = 5               # the pPITC fit timed again in phase 4e
REQUEST_SIZES = (1, 7, 64, 200, 256, 256, 1000, 3200)

# LM serving: prefill batch x length, generation prompt and new tokens, and
# the length of the float32 forward-vs-decode check (two SSD chunks for
# mamba2).
LM_BATCH, LM_SEQ = 4, 4096
GEN_PROMPT, GEN_NEW = 32, 32
CONSISTENCY_T = {"qwen3-1.7b": 128, "mamba2-130m": 512,
                 "qwen3-moe-30b-a3b": 128, "whisper-medium": 64}
# Depth cuts of the models whose float32 weights do not fit on one 80 GB
# card whole (width untouched): qwen3-moe-30b-a3b 48 -> 8 layers (2.49 GB a
# layer), qwen2-vl-72b 80 -> 4 (3.5 GB a layer + 10 GB of embeddings).
MOE_LAYERS, VLM_LAYERS = 8, 4
# qwen2-vl's prefill input: VLM_TEXT text tokens, a (t, h, w) block of
# patch embeddings at M-RoPE grid positions, then text to LM_SEQ.
VLM_TEXT, VLM_GRID = 16, (2, 32, 32)
# LM training (phase 8): warm-up plus TRAIN_STEPS steps at full width and
# depth, seq LM_SEQ (qwen3-1.7b's train_4k cell), remat on, bf16 compute.
# qwen3-1.7b's global batch is cut 256 -> 4 (2 microbatches of 2): its
# float32 parameters, gradients and Adam moments take 27.5 GB and a
# microbatch's float32 logits 5 GB. mamba2-130m: batch 8, one microbatch.
TRAIN_STEPS = 3
TRAIN_QWEN = dict(batch=4, microbatches=2, full_batch=256)
TRAIN_MAMBA = dict(batch=8, microbatches=1)
# Adam's first steps move every element by ~lr along the gradient's sign:
# at lr 1e-4 that is a 0.35 spectral-norm change of qwen3's 2048 x 6144
# matrices (a rank-one gradient's sign pattern), and its loss rose after
# the first step on the card; 1e-5 keeps the steps small.
TRAIN_LR = 1e-5
# The card's step against the CPU's on a smoke-width model in float32: the
# same function summed in other orders (cuBLAS against the CPU's BLAS, the
# kernels against the plain versions), the CPU tests' own limits
# (tests/test_torch_train.py): the loss to 1e-5, each gradient leaf to
# 1e-4 of its largest entry.
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD = 1e-5, 1e-4
# einsum against gather dispatch when nothing drops, relative to the
# largest output: the modes fill each expert's rows in another order and
# combine in the same one, so only the products' rounding at another row
# position could part them: one bf16 ulp (2^-8) of the largest output.
TOL_MOE_MODES = 2.0 ** -8
# a capacity at which one MoE layer of random normal input overflows its
# experts (C = 512 of ~1024 pairs an expert at qwen3-moe's prefill)
MOE_TIGHT_CF = 0.5

# whisper-medium's attention shapes (batch LM_BATCH, 16 heads of 64; 1500
# encoder frames, 448 decoder positions): flash cases (B, Hq, Hkv, Tq, Tk,
# D, window, q_offset, causal) held and timed in phase 3, non-causal
WHISPER_ENC = (LM_BATCH, 16, 16, 1500, 1500, 64, None, 0, False)
WHISPER_CROSS = (LM_BATCH, 16, 16, 448, 1500, 64, None, 0, False)
WHISPER_CROSS_DECODE = (LM_BATCH, 16, 16, 1, 1500, 64, None, 0, False)
# The causal attention shapes of phases 5b-5d beyond qwen3-1.7b's, held in
# phase 3: qwen3-moe-30b-a3b (32 query heads on 4 K/V heads, GQA 8:1) and
# qwen2-vl-72b (64 on 8) prefill 4 x 4096; qwen3-moe's decode steps (the
# cache's GEN_PROMPT + GEN_NEW slots, the first and the last position);
# whisper's decoder self-attention (16 heads of 64) at its prefill of
# max_seq 448 and a decode step.
MAIN_PATH_CAUSAL = [
    (LM_BATCH, 32, 4, LM_SEQ, LM_SEQ, 128, None, 0, True),
    (LM_BATCH, 32, 4, 1, GEN_PROMPT + GEN_NEW, 128, None, GEN_PROMPT, True),
    (LM_BATCH, 32, 4, 1, GEN_PROMPT + GEN_NEW, 128, None,
     GEN_PROMPT + GEN_NEW - 1, True),
    (LM_BATCH, 64, 8, LM_SEQ, LM_SEQ, 128, None, 0, True),
    (LM_BATCH, 16, 16, 448, 448, 64, None, 0, True),
    (LM_BATCH, 16, 16, 1, GEN_PROMPT + GEN_NEW, 64, None, GEN_PROMPT + 7,
     True)]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_functions(lib, what: str) -> dict:
    """Per kernel function of the shared library ``lib``: its lines of
    SASS, from ``cuobjdump -sass`` (shipped with the nvcc that builds the
    kernels; fails without it, saying ``what`` cannot be read)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        fail(f"cuobjdump not found: {what} cannot be read")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
    return funcs


def hgmma_counts(lib) -> dict:
    """Per kernel function of the shared library ``lib``: its count of
    wgmma (HGMMA) instructions."""
    return {name: sum(bool(re.search(r"\bHGMMA\b", line)) for line in lines)
            for name, lines in sass_functions(
                lib, "the xcov_diag SASS").items()}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(torch, fn, name: str, iters: int,
                     per_call: tuple[int, ...] = (1,)) -> float:
    """Mean device time, per call of ``fn``, of the kernels named ``name``
    that ``iters`` calls launch, from a ``torch.profiler`` trace (after a
    warm-up). The trace must hold k x iters of them for a k in
    ``per_call``; one that lost records is taken again, up to
    PROFILE_TRIES times in all."""
    from repro_torch.launch.profile import kernels
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # one fill kernel first: a trace on one H100 machine saw 4
            # bwd_prep kernels in 5 calls three times running; whether a
            # first launch cures that is not known
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # the fill is left out by its place, the trace's first kernel, and
        # not by the name filter: the library timings pass name "" and
        # count every kernel (were it lost, nothing is left out)
        ks = sorted(kernels(prof), key=lambda k: k[1])
        if ks and "FillFunctor" in ks[0][0]:
            ks = ks[1:]
        spans = [e - s for n, s, e in ks if name in n]
        if len(spans) in [k * iters for k in per_call]:
            return sum(spans) / iters / 1e3
        print(f"  (the profiler saw {len(spans)} {name} kernels in "
              f"{iters} calls; tracing again)", flush=True)
    fail(f"the profiler saw {len(spans)} {name} kernels in {iters} calls, "
         f"{PROFILE_TRIES} times")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check_rbf(torch, ops, ref, gen):
    """rbf vs plain at the fit shapes; timed at K_{S,D_m} over M machines by
    profiler device time, with sig2 on the card as the path passes it."""
    cases = [("K_SDm", (S_SIZE, D), (M, N_TRAIN // M, D)),
             ("K_DmDm", (M, N_TRAIN // M, D), (M, N_TRAIN // M, D)),
             ("K_SS", (S_SIZE, D), (S_SIZE, D)),
             ("ragged", (33, 7), (17, 7)),
             ("m=1601", (S_SIZE, D), (1601, D))]     # rows not 16-byte aligned
    worst = {}
    for name, sq, sk in cases:
        for dt in (torch.float32, torch.bfloat16):
            Xq = (torch.rand(sq, generator=gen, device="cuda") * 4 - 2) / 1.2
            Xk = (torch.rand(sk, generator=gen, device="cuda") * 4 - 2) / 1.2
            Xq, Xk = Xq.to(dt), Xk.to(dt)
            got = ops.rbf_covariance(Xq, Xk, 1.3)
            want = ref.rbf_covariance(Xq, Xk, 1.3)
            torch.cuda.synchronize()
            key = str(dt).split(".")[1]
            err = max_err(got, want)
            print(f"  rbf {name} {tuple(sq)}x{tuple(sk)} {key}: "
                  f"max|err| {err:.3e} (tol {TOL_RBF[key]})", flush=True)
            if not err <= TOL_RBF[key]:
                fail(f"rbf {name} {key} error {err} > {TOL_RBF[key]}")
            if name == "K_SDm" and key == "float32":
                worst["err"] = err
    # timing at the main path's largest launch: K_{S,D_m} for all machines,
    # sig2 on the card (a Python float is copied to the card, and the
    # stream synchronized, on every call: timed too, to show what it cost)
    S = (torch.rand((S_SIZE, D), generator=gen, device="cuda") * 4 - 2) / 1.2
    Xb = (torch.rand((M, N_TRAIN // M, D), generator=gen, device="cuda")
          * 4 - 2) / 1.2
    s2 = torch.tensor(1.3, device="cuda")
    ms = kernel_device_ms(torch, lambda: ops.rbf_covariance(S, Xb, s2),
                          "rbf_kernel", 20)
    b2b = time_ms(lambda: ops.rbf_covariance(S, Xb, s2), 20)
    b2b_float = time_ms(lambda: ops.rbf_covariance(S, Xb, 1.3), 20)
    plain = time_ms(lambda: ref.rbf_covariance(S, Xb, s2), 5)
    n_out = M * S_SIZE * (N_TRAIN // M)
    b_ms, b_by = rk.bound_ms(rk.rbf_bytes(S_SIZE, M * (N_TRAIN // M),
                                          n_out, D), rk.rbf_flops(n_out, D))
    print(f"  rbf at the K_SDm shape: device {ms:.4f} ms (bound {b_ms:.4f} "
          f"ms, {b_by}; {100 * b_ms / ms:.0f}% of it); back to back "
          f"{b2b:.4f} ms a call, {b2b_float:.4f} ms with a Python-float "
          f"sig2; plain {plain:.4f} ms", flush=True)
    exact = check_rbf_exact(torch, ops, ref, gen)
    return dict(name="rbf", route="cuda",
                source="src/repro_torch/kernels/rbf/csrc/rbf.cu",
                replaces="src/repro/kernels/rbf/rbf.py:55",
                max_abs_err=worst["err"], tol=TOL_RBF["float32"], ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, back_to_back_ms=b2b,
                float_sig2_ms=b2b_float,
                shape=f"K_SDm: ({S_SIZE},{D}) x ({M},{N_TRAIN // M},{D}) "
                      f"f32", exact=exact)


def check_rbf_exact(torch, ops, ref, gen) -> dict:
    """rbf.cu's exact instance, the collective ICF loop's pivot column K(x_p,
    D_m) for the M machines, (1, d) x (M, b, d), against its plain version
    in float32 and float64 (TOL_RBF_EXACT); timed in float64 by profiler
    device time."""
    out = {}
    for dt in (torch.float32, torch.float64):
        key = str(dt).split(".")[1]
        xp = ((torch.rand((1, D), generator=gen, device="cuda") * 4 - 2)
              / 1.2).to(dt)
        Xb = ((torch.rand((M, N_TRAIN // M, D), generator=gen, device="cuda")
               * 4 - 2) / 1.2).to(dt)
        s2 = torch.tensor(1.3, dtype=dt, device="cuda")
        err = max_err(ops.rbf_covariance_exact(xp, Xb, s2),
                      ref.rbf_covariance_exact(xp, Xb, s2))
        print(f"  rbf exact (1,{D})x({M},{N_TRAIN // M},{D}) {key}: "
              f"max|err| {err:.3e} (tol {TOL_RBF_EXACT[key]})", flush=True)
        if not err <= TOL_RBF_EXACT[key]:
            fail(f"rbf exact {key} error {err} > {TOL_RBF_EXACT[key]}")
        out[f"max_abs_err_{key}"] = err
    ms = kernel_device_ms(torch, lambda: ops.rbf_covariance_exact(xp, Xb, s2),
                          "rbf_exact_kernel", 20)
    plain = time_ms(lambda: ref.rbf_covariance_exact(xp, Xb, s2), 20)
    n_out = Xb.shape[0] * Xb.shape[1]
    b_ms, b_by = rk.bound_ms(rk.rbf_bytes(1, n_out, n_out, D, 8),
                             rk.rbf_exact_flops(n_out, D), hw.PEAK_FLOPS_F64)
    print(f"  rbf exact f64 column: device {ms:.4f} ms (bound {b_ms:.4f} ms, "
          f"{b_by}); plain {plain:.4f} ms", flush=True)
    out.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
               shape=f"(1,{D}) x ({M},{N_TRAIN // M},{D}) f64")
    return out


def icf_tolerance(F, piv, sig2: float) -> tuple[float, float, float]:
    """Limits for the ICF kernel's F and residual against the plain loop
    (same pivots). Each f sums i <= R products of factor entries bounded by
    sig2 (|F[:, j]|^2 <= K_jj), rounded in another order than the plain
    loop's, then divides by sqrt(d_p): R eps sig2 / sqrt(min d_p), times 64
    for the errors earlier rows carry into later ones. The residual
    sig2 - sum_i f_ij^2 moves by at most 2 sqrt(R sig2) times that. Returns
    (tol F, tol residual, min d_p); min d_p = min_i F[i, p_i]^2, since
    f_p = sqrt(d_p)."""
    import torch
    R = F.shape[0]
    eps = torch.finfo(F.dtype).eps
    min_dp = float(F[torch.arange(R, device=F.device), piv].pow(2).min())
    tol_f = 64 * R * eps * sig2 / max(min_dp, 1e-300) ** 0.5
    return tol_f, 2 * (R * sig2) ** 0.5 * tol_f, min_dp


def _same_runs(torch, runs) -> bool:
    return all(torch.equal(a, b) for run in runs[1:]
               for a, b in zip(run, runs[0]))


def _icf_case(torch, ops, ref, Xs, sig2: float, R: int, tag: str) -> None:
    """float64: ICF_REPEAT launches bitwise equal (one more with no factor
    rows cached in shared memory, equal too), pivots identical to the plain
    loop's, F and residual within icf_tolerance."""
    s2 = torch.tensor(sig2, dtype=Xs.dtype, device="cuda")
    n0 = ops.icf_launches
    runs = [ops.icf_factor(Xs, s2, R) for _ in range(ICF_REPEAT)]
    runs.append(ops.icf_factor(Xs, s2, R, cached_rows=0))
    F_w, piv_w, res_w = ref.icf_factor(Xs, s2, R)
    torch.cuda.synchronize()
    if ops.icf_launches - n0 != ICF_REPEAT + 1:
        fail(f"ICF {tag}: {ops.icf_launches - n0} launches for "
             f"{ICF_REPEAT + 1} calls")
    if not _same_runs(torch, runs):
        fail(f"ICF {tag}: repeated launches (or the uncached one) disagree")
    F, piv, res = runs[0]
    same = bool(torch.equal(piv, piv_w))
    tol_f, tol_r, min_dp = icf_tolerance(F_w, piv_w, sig2)
    err_f, err_r = max_err(F, F_w), max_err(res, res_w)
    print(f"  ICF {tag} x{ICF_REPEAT} (+1 uncached): pivots identical "
          f"{same}; min d_p {min_dp:.3e}; max|dF| {err_f:.3e} (tol "
          f"{tol_f:.3e}), max|dresidual| {err_r:.3e} (tol {tol_r:.3e})",
          flush=True)
    if not (same and err_f <= tol_f and err_r <= tol_r):
        fail(f"ICF {tag}: pivots identical {same}, errors {err_f}, {err_r}")


def check_icf(torch, ops, ref, gen):
    """The ICF kernel (select_support's pivot loop) vs the plain loop: f64 at
    the path's shape (8192, 2048, 5), a ragged case and exact ties; f32 on
    the AIMPEAK candidates, held by replaying the plain loop along the
    kernel's pivots (each within TOL_ICF_TIE of the plain loop's largest
    residual, F within TOL_ICF_F32), its launches with factor rows in
    registers and shared memory, in shared memory only, and none on chip
    bitwise equal. Timed there, beside its bound, the barrier probe and the
    plain loop. Returns the rbf row's ICF fields."""
    from repro_torch.core import covariance as cov
    from repro_torch.data import synthetic
    n, R = ICF_CANDIDATES, S_SIZE
    X64 = (torch.rand((n, D), generator=gen, device="cuda",
                      dtype=torch.float64) * 4 - 2) / 1.2
    _icf_case(torch, ops, ref, X64, 1.3, R, f"f64 ({n}, {R}, {D})")
    Xr = torch.rand((1000, 7), generator=gen, device="cuda",
                    dtype=torch.float64) * 4 - 2
    _icf_case(torch, ops, ref, Xr, 1.3, 120, "f64 ragged (1000, 120, 7)")
    P = torch.randn((40, 3), generator=gen, device="cuda",
                    dtype=torch.float64)
    _icf_case(torch, ops, ref, torch.cat([P, P]), 1.3, 30,
              "f64 40 points twice (80, 30, 3)")

    # float32 on select_support's candidates: the path's own inputs
    ds = synthetic.standardize(synthetic.aimpeak_like(
        n=N_TRAIN, n_test=N_TEST, seed=0))
    params = cov.init_params(D, signal=1.0, noise=0.3, lengthscale=1.2)
    Xs = cov._scale(params, ds.X[:n])
    s2 = cov.signal_var(params)
    sig2 = float(s2)
    del ds
    plan = ops.icf_plan(torch.float32, n, R, D)
    runs = [ops.icf_factor(Xs, s2, R) for _ in range(ICF_REPEAT)]
    runs.append(ops.icf_factor(Xs, s2, R, cached_rows=plan["smem_rows"]))
    runs.append(ops.icf_factor(Xs, s2, R, cached_rows=0))
    if not _same_runs(torch, runs):
        fail("ICF f32: repeated launches, or those with fewer factor rows "
             "on chip, disagree")
    F, piv, _ = runs[0]
    F_r, _, _ = ref.icf_factor(Xs, s2, R, pivots=piv)
    slack = float(ref.icf_slack(F_r, piv, s2).max())
    _, piv_w, _ = ref.icf_factor(Xs, s2, R)
    differ = (piv != piv_w).nonzero()
    prefix = int(differ[0]) if differ.numel() else R
    tol_f = TOL_ICF_F32 * sig2 ** 0.5
    err_f = max_err(F, F_r)
    print(f"  ICF f32 AIMPEAK candidates ({n}, {R}, {D}) x{ICF_REPEAT} (+1 "
          f"with shared memory only, +1 with no rows on chip): bitwise "
          f"equal; pivots agree with the plain loop for {prefix} of {R} "
          f"steps; the plain loop replayed along the kernel's pivots finds "
          f"each within {slack:.3e} of its largest residual (tol "
          f"{TOL_ICF_TIE * sig2:.1e}); max|dF| {err_f:.3e} (tol "
          f"{tol_f:.1e})", flush=True)
    if not (slack <= TOL_ICF_TIE * sig2 and err_f <= tol_f):
        fail(f"ICF f32: slack {slack}, F error {err_f}")

    icf_ms = kernel_device_ms(torch, lambda: ops.icf_factor(Xs, s2, R),
                              "icf_kernel", 5)
    uncached_ms = kernel_device_ms(
        torch, lambda: ops.icf_factor(Xs, s2, R, cached_rows=0),
        "icf_kernel", 5)
    barrier_ms = kernel_device_ms(
        torch, lambda: ops.icf_barrier_probe(torch.float32, n, R, D),
        "icf_barrier_probe", 5)
    plain = time_ms(lambda: ref.icf_factor(Xs, s2, R), 2, warmup=1)
    flops = rk.icf_flops(n, R)               # the GEMVs: 2 i n at step i
    b_ms, b_by = rk.bound_ms(rk.icf_bytes(n, R, D), flops)
    stream_bytes = rk.icf_gemv_bytes(n, R)   # F[:i] read from HBM each step
    print(f"  ICF kernel f32 ({n}, {R}, {D}), {plan['blocks']} blocks of "
          f"{plan['width']} columns, {plan['cached_rows']} factor rows a "
          f"column on chip ({plan['smem_rows']} in shared memory, "
          f"{plan['smem']} B, the rest in registers): device {icf_ms:.3f} "
          f"ms ({icf_ms / R * 1e3:.2f} us a step; {uncached_ms:.3f} ms "
          f"with no rows on chip); bound {b_ms:.3f} ms ({b_by}, "
          f"{flops / 1e9:.1f} GFLOP); {R} empty grid barriers "
          f"{barrier_ms:.3f} ms ({barrier_ms / R * 1e3:.2f} us each); the "
          f"GEMVs would take {stream_bytes / hw.HBM_BW * 1e3:.2f} ms "
          f"streamed from HBM ({stream_bytes / 1e9:.1f} GB, a model), the "
          f"kernel reads them at {stream_bytes / icf_ms / 1e9:.2f} TB/s "
          f"effective; plain loop {plain:.1f} ms", flush=True)
    return dict(icf_source="src/repro_torch/kernels/rbf/csrc/rbf_icf.cu",
                icf_ms=icf_ms, icf_uncached_ms=uncached_ms,
                icf_plain_ms=plain, icf_bound_ms=b_ms, icf_bound_by=b_by,
                icf_barrier_ms=barrier_ms, icf_prefix=prefix,
                icf_slack=slack, icf_max_abs_err=err_f, icf_tol=tol_f,
                icf_shape=f"({n}, {R}, {D}) f32, AIMPEAK candidates")


def _factors(torch, s, gen, dtype):
    """The well-conditioned factors of the reference's fused-kernel tests."""
    A1 = torch.randn((s, s), generator=gen, device="cuda", dtype=torch.float64)
    A2 = torch.randn((s, s), generator=gen, device="cuda", dtype=torch.float64)
    eye = torch.eye(s, dtype=torch.float64, device="cuda")
    L1 = torch.linalg.cholesky(A1 @ A1.T + s * eye)
    L2 = torch.linalg.cholesky(A2 @ A2.T + 2 * s * eye)
    alpha = torch.randn((s,), generator=gen, device="cuda",
                        dtype=torch.float64)
    return L1.to(dtype), L2.to(dtype), alpha.to(dtype)


def _xcov_case(torch, ops, ref, args, tag, tol):
    """One xcov_diag case, launched XCOV_REPEAT times: each run must equal
    the first, each float32 run must take the tensor-core instance, and
    the first must meet ``tol`` against the plain version. Returns the
    error."""
    n0, t0 = ops.xcov_launches, ops.xcov_tc_launches
    runs = [ops.xcov_diag(*args) for _ in range(XCOV_REPEAT)]
    want = ref.xcov_diag(*args)
    torch.cuda.synchronize()
    want_tc = XCOV_REPEAT if args[0].dtype == torch.float32 else 0
    if ops.xcov_launches - n0 != XCOV_REPEAT or \
            ops.xcov_tc_launches - t0 != want_tc:
        fail(f"xcov_diag {tag}: {ops.xcov_launches - n0} launches, "
             f"{ops.xcov_tc_launches - t0} of the tensor-core instance")
    if not all(torch.equal(a, b) for run in runs[1:]
               for a, b in zip(run, runs[0])):
        fail(f"xcov_diag {tag}: repeated launches disagree")
    err = max(max_err(g, w) for g, w in zip(runs[0], want))
    print(f"  xcov_diag {tag} x{XCOV_REPEAT}: max|err| {err:.3e} (tol "
          f"{tol})", flush=True)
    if not err <= tol:
        fail(f"xcov_diag {tag} error {err} > {tol}")
    return err


def _tf32_trunc(torch, x):
    """float32 -> float64 with the low 13 mantissa bits cleared: what the
    tensor core reads of a float32 register as TF32."""
    return (x.view(torch.int32) & ~0x1fff).view(torch.float32).double()


def check_xcov(torch, ops, ref, gen):
    """xcov_diag vs plain: f64 small; f32 at |S| = 2048 and at the float32
    kernel's tile edges (s = 2047, 2049, 100; n = 1, 9, 257, 3328), with and
    without L2; f32 on a fitted pPITC state (cond Sdd ~1e8), where one TF32
    product would miss the limit. Every case launched XCOV_REPEAT times.
    Timed at n = 8, 256, 1024 and 3328 (|S| = 2048, with L2, f32)."""
    worst_f32 = 0.0
    f64_cases = [(torch.float64, s, n, d) for s, d in ((12, 3), (130, 21))
                 for n in (1, 16, 33, 256)]
    f32_cases = [(torch.float32, S_SIZE, n, D) for n in (8, 256, 1024)] + \
        [(torch.float32, s, n, D) for s in (2047, 2049, 100)
         for n in (1, 9, 257, 3328)]
    for dtype, s, n, d in f64_cases + f32_cases:
        Xq = torch.randn((n, d), generator=gen, device="cuda",
                         dtype=torch.float64).to(dtype)
        Xk = torch.randn((s, d), generator=gen, device="cuda",
                         dtype=torch.float64).to(dtype)
        L1, L2, alpha = _factors(torch, s, gen, dtype)
        tol = TOL_XCOV_F64 if dtype == torch.float64 else \
            TOL_XCOV_F32_S2048
        for L2_ in (L2, None):
            tag = (f"s={s} n={n} d={d} {str(dtype)[6:]} "
                   f"{'L1+L2' if L2_ is not None else 'L1'}")
            err = _xcov_case(torch, ops, ref,
                             (Xq, Xk, L1, alpha, 1.3, L2_), tag, tol)
            if dtype == torch.float32:
                worst_f32 = max(worst_f32, err)

    # conditioned factors: pPITC fitted on the card at |D| = 16384, M = 8,
    # |S| = 2048 (AIMPEAK-like, seed 0)
    from repro_torch.core import api, covariance as cov, support
    from repro_torch.data import synthetic
    from repro_torch.parallel.runner import VmapRunner
    ds = synthetic.standardize(synthetic.aimpeak_like(
        n=16384, n_test=1024, seed=0))
    spec = cov.make_spec("se")
    params = cov.init_params(D, signal=1.0, noise=0.3, lengthscale=1.2)
    Sc = support.select_support(spec, params, ds.X[:ICF_CANDIDATES], S_SIZE)
    model = api.fit("ppitc", spec, params, ds.X, ds.y, S=Sc,
                    runner=VmapRunner(M=8))
    st, sig2 = model.state, cov.signal_var(params)
    Uc, Skc = cov._scale(params, ds.X_test), cov._scale(params, st.S)
    ev = torch.linalg.eigvalsh(st.Sdd_L.double() @ st.Sdd_L.double().T)
    cond = float(ev.max() / ev.min())
    err_c = _xcov_case(torch, ops, ref,
                       (Uc, Skc, st.Kss_L, st.alpha, sig2, st.Sdd_L),
                       f"fitted s={S_SIZE} n={Uc.shape[0]} (cond Sdd "
                       f"{cond:.2e}) float32 L1+L2", TOL_XCOV_F32_S2048)
    worst_f32 = max(worst_f32, err_c)
    # the same products with one TF32 product each, in float64
    q2 = (Uc * Uc).sum(1)[:, None]
    k2 = (Skc * Skc).sum(1)[None]
    K = _tf32_trunc(torch, sig2 * torch.exp(
        -0.5 * torch.clamp(q2 + k2 - 2 * Uc @ Skc.T, min=0)))
    v1 = K @ _tf32_trunc(torch, ops.tri_inv(st.Kss_L)).T
    v2 = K @ _tf32_trunc(torch, ops.tri_inv(st.Sdd_L)).T
    var1 = float(sig2) - (v1 * v1).sum(1) + (v2 * v2).sum(1)
    want = ref.xcov_diag(Uc, Skc, st.Kss_L, st.alpha, sig2, st.Sdd_L)[1]
    err_1x = max_err(var1, want)
    print(f"  xcov_diag fitted: one TF32 product (emulated in float64) "
          f"would err {err_1x:.3e} on var (tol {TOL_XCOV_F32_S2048})",
          flush=True)
    if not err_1x > TOL_XCOV_F32_S2048:
        fail(f"the conditioned case does not need 3xTF32: {err_1x}")
    del model, ds, K, v1, v2

    # timing at the main path's buckets, on the fit's kind of inputs
    s = S_SIZE
    Xk = (torch.rand((s, D), generator=gen, device="cuda") * 4 - 2) / 1.2
    L1, L2, alpha = _factors(torch, s, gen, torch.float32)
    L1inv, L2inv = ops.tri_inv(L1), ops.tri_inv(L2)
    # sig2 on the card, as the path passes it (a float would be copied to
    # the card, and the stream synchronized, on every call)
    s2 = torch.tensor(1.3, device="cuda")
    ms_by_n, dev_by_n = {}, {}
    for n in XCOV_TIMED_N:
        Xq = (torch.rand((n, D), generator=gen, device="cuda") * 4 - 2) / 1.2

        def call():
            return ops.xcov_diag_inv(Xq, Xk, L1inv, alpha, s2, L2inv)
        ms_by_n[n] = time_ms(call, 50)
        # the two or three kernels of a call (panels, chunk sums, reduce)
        dev_by_n[n] = kernel_device_ms(torch, call, "xcov_", 50, (2, 3))
        flops = rk.xcov_flops(n, s)
        nbytes = rk.xcov_bytes(n, s, D, True)
        b3, b3_by = rk.bound_ms(nbytes, 3 * flops, hw.PEAK_FLOPS_TF32)
        bf32, _ = rk.bound_ms(nbytes, flops, hw.PEAK_FLOPS_F32)
        print(f"  xcov_diag n={n}, |S|={s}, with L2, f32: "
              f"{ms_by_n[n]:.4f} ms a call back to back, device "
              f"{dev_by_n[n]:.4f} ms; {flops / dev_by_n[n] / 1e9:.1f} "
              f"TFLOP/s of 2 n s^2 = {flops / 1e9:.3f} GFLOP on the device "
              f"time; bound {b3:.4f} ms ({b3_by}, 3xTF32; bytes "
              f"{nbytes / hw.HBM_BW * 1e3:.4f} ms), f32 CUDA-core "
              f"bound {bf32:.4f} ms", flush=True)
    n = 256
    Xq = (torch.rand((n, D), generator=gen, device="cuda") * 4 - 2) / 1.2
    ms = ms_by_n[n]
    plain = time_ms(lambda: ref.xcov_diag(Xq, Xk, L1, alpha, s2, L2), 10)
    inv_ms = time_ms(lambda: (ops._embed_tri_inv(L1, s),
                              ops._embed_tri_inv(L2, s)), 10)
    flops = rk.xcov_flops(n, s)
    nbytes = rk.xcov_bytes(n, s, D, True)
    b_ms, b_by = rk.bound_ms(nbytes, 3 * flops, hw.PEAK_FLOPS_TF32)
    b_f32_ms, _ = rk.bound_ms(nbytes, flops, hw.PEAK_FLOPS_F32)
    print(f"  xcov_diag plain at n={n}: {plain:.4f} ms; both inverses "
          f"(once per state): {inv_ms:.4f} ms", flush=True)
    return dict(name="xcov_diag", route="cuda",
                source="src/repro_torch/kernels/rbf/csrc/xcov_diag.cu",
                replaces="src/repro/kernels/rbf/xcov.py:103",
                max_abs_err=worst_f32, tol=TOL_XCOV_F32_S2048, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, bound_f32_ms=b_f32_ms,
                tflops=flops / dev_by_n[n] / 1e9, device_ms=dev_by_n[n],
                ms_by_n={str(k): v for k, v in ms_by_n.items()},
                device_ms_by_n={str(k): v for k, v in dev_by_n.items()},
                tri_inv_ms=inv_ms,
                shape=f"n={n}, |S|={s}, d={D}, with L2, f32")


def _flash_case(torch, ops, ref, gen, case, dt, strided=False):
    """One flash case, launched FLASH_REPEAT times: each run must equal the
    first (a ring stage released too early shows as a run that differs)
    and meet the absolute and row-scaled limits against the plain version.
    Returns (max abs error, row-scaled error). ``case`` is (B, Hq, Hkv,
    Tq, Tk, D, window, q_offset, causal)."""
    B, Hq, Hkv, Tq, Tk, Dh, window, off, causal = case
    shapes = ((B, Hq, Tq, Dh), (B, Hkv, Tk, Dh), (B, Hkv, Tk, Dh))
    if strided:      # (B, T, H, D) buffers seen as (B, H, T, D)
        q, k, v = (torch.randn((s[0], s[2], s[1], s[3]), generator=gen,
                               device="cuda").to(dt).transpose(1, 2)
                   for s in shapes)
    else:
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dt)
                   for s in shapes)
    route = ops.route(q, k, v)
    n0, s0 = ops.flash_launches, ops.flash_sm90_launches
    c0 = ops.flash_noncausal_launches
    runs = [ops.attention(q, k, v, causal=causal, window=window,
                          q_offset=off) for _ in range(FLASH_REPEAT)]
    # the plain version one batch row at a time (the same function): its
    # float32 scores at qwen2-vl's prefill are 17 GB for the whole batch
    want = torch.cat([ref.attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                    causal=causal, window=window,
                                    q_offset=off) for b in range(B)])
    torch.cuda.synchronize()
    key = str(dt).split(".")[1]
    want_sm90 = FLASH_REPEAT if key == "bfloat16" else 0
    if ops.flash_launches - n0 != FLASH_REPEAT or \
            ops.flash_sm90_launches - s0 != want_sm90 or \
            ops.flash_noncausal_launches - c0 != (0 if causal
                                                  else FLASH_REPEAT):
        fail(f"flash {case} {key}: {ops.flash_launches - n0} launches, "
             f"{ops.flash_sm90_launches - s0} of the sm90 kernel, "
             f"{ops.flash_noncausal_launches - c0} non-causal")
    if not all(torch.equal(r, runs[0]) for r in runs[1:]):
        fail(f"flash {case} {key}: repeated launches disagree")
    got = runs[0]
    err = max_err(got, want)
    r, c = TOL_FLASH_ROW[key]
    row = flash_row_err(got, want, r)
    size = float(want.float().abs().mean())
    print(f"  flash B={B} Hq={Hq} Hkv={Hkv} Tq={Tq} Tk={Tk} D={Dh} "
          f"window={window} offset={off}{'' if causal else ' non-causal'}"
          f"{' (B,T,H,D) view' if strided else ''}"
          f" {key} [{route} x{FLASH_REPEAT}]: max|err| {err:.3e} (tol "
          f"{TOL_FLASH[key]}), row-scaled {row:.3e} (tol {c}), mean|want| "
          f"{size:.3e}", flush=True)
    if not (err <= TOL_FLASH[key] and row <= c):
        fail(f"flash {case} {key} error {err} > {TOL_FLASH[key]} or "
             f"row-scaled {row} > {c}")
    return err, row


def check_flash(torch, ops, ref, gen):
    """flash attention vs plain in f32 and bf16: the qwen3 prefill shape
    (also as (B, T, H, D) views), the reference's cases (window, offset,
    ragged Tq != Tk, GQA 4:1), D = 16, 100 and 256, decode steps, the
    sm90 kernel's tile boundaries, the causal shapes of the MoE, enc-dec
    and VLM paths and the non-causal ones of whisper's encoder and
    cross-attention, each launched FLASH_REPEAT times; timed
    at the prefill shape in bf16, beside SDPA, with its TFLOP/s and the
    host cost of a decode launch."""
    prefill = (LM_BATCH, 16, 8, LM_SEQ, LM_SEQ, 128, None, 0, True)
    cases = [prefill,
             (1, 4, 4, 128, 128, 64, None, 0, True),
             (2, 8, 2, 128, 128, 64, None, 0, True),     # GQA 4:1
             (1, 4, 4, 256, 256, 32, 128, 0, True),      # sliding window
             (1, 2, 2, 64, 256, 64, None, 192, True),    # offset
             (1, 4, 2, 100, 200, 48, None, 100, True),   # ragged Tq != Tk
             (1, 1, 1, 64, 64, 128, 32, 0, True),
             (2, 8, 4, 300, 300, 16, None, 0, True),     # D = 16
             (2, 8, 4, 300, 300, 256, 100, 0, True),     # D = 256
             (2, 4, 2, 33, 33, 100, None, 0, True),      # D % 8 != 0: pad
             (LM_BATCH, 16, 8, 1, 2 * GEN_PROMPT, 128, None, 45, True),
             (LM_BATCH, 16, 8, 1, LM_SEQ, 128, None, LM_SEQ - 1, True),
             # the sm90 kernel's boundaries: 128 query rows, 128 keys (64 at
             # D = 256), a K/V ring of 3 stages (2 at D = 256)
             (1, 4, 2, 127, 127, 128, None, 0, True),
             (1, 4, 2, 128, 128, 128, None, 0, True),
             (1, 4, 2, 129, 129, 128, None, 0, True),
             (1, 4, 2, 257, 257, 128, None, 0, True),
             (1, 4, 2, 1000, 1000, 128, None, 0, True),
             (1, 64, 8, 200, 200, 128, None, 0, True),   # GQA 8:1
             (2, 4, 2, 300, 300, 256, 100, 0, True),     # D = 256, window
             (2, 16, 8, 1, 1024, 128, None, 700, True),  # decode, 6 KV tiles
             *MAIN_PATH_CAUSAL,
             # non-causal: whisper's encoder, its cross-attention prefill
             # and decode step over the encoder's 1500 frames (ragged key
             # tiles), ragged GQA, a single key
             WHISPER_ENC, WHISPER_CROSS, WHISPER_CROSS_DECODE,
             (1, 4, 2, 100, 200, 48, None, 0, False),
             (2, 4, 2, 16, 1, 64, None, 0, False)]
    worst = worst_row = 0.0
    for case in cases:
        for dt in (torch.float32, torch.bfloat16):
            err, row = _flash_case(torch, ops, ref, gen, case, dt)
            if dt == torch.bfloat16:
                worst, worst_row = max(worst, err), max(worst_row, row)
    err, row = _flash_case(torch, ops, ref, gen, prefill, torch.bfloat16,
                           strided=True)
    worst, worst_row = max(worst, err), max(worst_row, row)
    # a base 8 bytes past a 16-byte boundary: the padded copy
    q, k, v = (torch.randn((2, 8, 150, 72), generator=gen, device="cuda")
               .to(torch.bfloat16)[..., 4:68] for _ in range(3))
    if ops.route(q, k, v) != "pad":
        fail("a misaligned bf16 slice did not take the pad route")
    got, want = ops.attention(q, k, v), ref.attention(q, k, v)
    row = flash_row_err(got, want, TOL_FLASH_ROW["bfloat16"][0])
    err = max_err(got, want)
    print(f"  flash misaligned slice bf16 [pad]: max|err| {err:.3e}, "
          f"row-scaled {row:.3e}", flush=True)
    if not (err <= TOL_FLASH["bfloat16"]
            and row <= TOL_FLASH_ROW["bfloat16"][1]):
        fail(f"flash pad route error {err}, row-scaled {row}")
    del q, k, v, got, want

    # timing at the qwen3 prefill shape, bf16, causal
    B, Hq, Hkv, T, Dh = prefill[:4] + (prefill[5],)
    q = torch.randn((B, Hq, T, Dh), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((B, Hkv, T, Dh), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn((B, Hkv, T, Dh), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    ms = time_ms(lambda: ops.attention(q, k, v), 20)
    plain = time_ms(lambda: ref.attention(q, k, v), 3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 20)
    got = ops.attention(q, k, v)
    want = sdpa(q, k, v, is_causal=True, enable_gqa=True)
    # both round P to bf16, independently: the row-scaled limit still holds
    row = flash_row_err(got, want, TOL_FLASH_ROW["bfloat16"][0])
    print(f"  flash vs scaled_dot_product_attention at the prefill shape: "
          f"max|err| {max_err(got, want):.3e}, row-scaled {row:.3e} (tol "
          f"{TOL_FLASH_ROW['bfloat16'][1]})", flush=True)
    if not row <= TOL_FLASH_ROW["bfloat16"][1]:
        fail(f"flash disagrees with scaled_dot_product_attention: "
             f"row-scaled {row}")
    flops = rk.flash_flops(B, Hq, T, T, Dh, True)
    nbytes = rk.flash_bytes(B, Hq, Hkv, T, T, Dh)
    b_ms, b_by = rk.bound_ms(nbytes, flops, hw.PEAK_FLOPS_BF16)
    tflops, lib_tflops = flops / ms / 1e9, flops / lib / 1e9
    # host cost of one decode launch (tensor maps encoded in the C entry
    # point): back-to-back calls that keep the device queue short
    qd = q[:, :, :1]
    kd, vd = k[:, :, :GEN_PROMPT + GEN_NEW], v[:, :, :GEN_PROMPT + GEN_NEW]
    for _ in range(3):
        ops.attention(qd, kd, vd, q_offset=GEN_PROMPT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FLASH_HOST_CALLS):
        ops.attention(qd, kd, vd, q_offset=GEN_PROMPT)
    host_us = (time.perf_counter() - t0) / FLASH_HOST_CALLS * 1e6
    torch.cuda.synchronize()
    encode_us = ops.last_encode_us()
    decode_ms = kernel_device_ms(
        torch, lambda: ops.attention(qd, kd, vd, q_offset=GEN_PROMPT),
        "flash_sm90", FLASH_HOST_CALLS)
    print(f"  flash at the prefill shape: {ms:.4f} ms, {tflops:.1f} TFLOP/s "
          f"({100 * tflops * 1e12 / hw.PEAK_FLOPS_BF16:.1f}% of the bf16 "
          f"peak); SDPA {lib:.4f} ms, {lib_tflops:.1f} TFLOP/s; bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    print(f"  flash decode launch (B={B}, Hq={Hq}, Tq=1, {GEN_PROMPT + 1} "
          f"keys): device {decode_ms * 1e3:.2f} us; host {host_us:.1f} us, "
          f"of which encoding the three tensor maps {encode_us:.2f} us",
          flush=True)
    return dict(name="flash_attention", route="cuda", ops_route="sm90",
                source="src/repro_torch/kernels/attention/csrc/"
                       "flash_attention.cu",
                replaces="src/repro/kernels/attention/flash.py:90",
                max_abs_err=worst, tol=TOL_FLASH["bfloat16"],
                row_scaled_err=worst_row,
                row_scaled_tol=TOL_FLASH_ROW["bfloat16"][1], ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, tflops=tflops, decode_ms=decode_ms,
                host_us=host_us, encode_us=encode_us,
                shape=f"B={B}, Hq={Hq}, Hkv={Hkv}, T={T}, D={Dh}, causal, "
                      f"bf16",
                noncausal=[time_noncausal(torch, ops, ref, gen, case)
                           for case in (WHISPER_ENC, WHISPER_CROSS,
                                        WHISPER_CROSS_DECODE)])


def time_noncausal(torch, ops, ref, gen, case) -> dict:
    """The non-causal kernel at one of whisper's shapes, bf16: device time
    (events over back-to-back calls; for a decode step, whose calls are
    shorter than their host cost, the profiler's kernel time, SDPA's
    kernels included), beside the plain version, SDPA (``is_causal=False``)
    and its bound."""
    B, Hq, Hkv, Tq, Tk, Dh = case[:6]
    q = torch.randn((B, Hq, Tq, Dh), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, Hkv, Tk, Dh), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    call = lambda: ops.attention(q, k, v, causal=False)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_call = lambda: sdpa(q, k, v, is_causal=False)
    if Tq == 1:
        ms = kernel_device_ms(torch, call, "flash_sm90", FLASH_HOST_CALLS)
        lib = kernel_device_ms(torch, lib_call, "", FLASH_HOST_CALLS,
                               per_call=(1, 2, 3, 4, 5, 6))
    else:
        ms, lib = time_ms(call, 20), time_ms(lib_call, 20)
    plain = time_ms(lambda: ref.attention(q, k, v, causal=False), 3,
                    warmup=1)
    row = flash_row_err(call(), lib_call(), TOL_FLASH_ROW["bfloat16"][0])
    flops = rk.flash_flops(B, Hq, Tq, Tk, Dh, False)
    nbytes = rk.flash_bytes(B, Hq, Hkv, Tq, Tk, Dh)
    b_ms, b_by = rk.bound_ms(nbytes, flops, hw.PEAK_FLOPS_BF16)
    shape = f"B={B}, Hq={Hq}, Hkv={Hkv}, Tq={Tq}, Tk={Tk}, D={Dh}"
    print(f"  flash non-causal at {shape} bf16: {ms:.4f} ms"
          f"{' (device, profiler)' if Tq == 1 else ''}, "
          f"{flops / ms / 1e9:.1f} TFLOP/s; SDPA {lib:.4f} ms (row-scaled "
          f"{row:.3e} from it); plain {plain:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)
    if not row <= TOL_FLASH_ROW["bfloat16"][1]:
        fail(f"non-causal flash at {shape} disagrees with SDPA: row-scaled "
             f"{row}")
    return dict(shape=shape, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


def check_ssd(torch, ops, ref, gen):
    """SSD intra-chunk vs plain in f32 (as the path feeds it) and bf16: the
    mamba2 prefill shape, a ragged small case, and the kernel's group and
    strip edges (H not a multiple of the 8-head group, cs = 200 and a single
    strip at cs = 64); each case launched SSD_REPEAT times, every run equal
    to the first. Timed at the prefill shape in f32."""
    prefill = (LM_BATCH * LM_SEQ // 256, 256, 24, 64, 128)
    cases = [prefill, (3, 100, 5, 24, 40), (2, 256, 5, 64, 128),
             (1, 256, 25, 64, 128), (2, 200, 3, 64, 128),
             (4, 64, 24, 64, 128)]
    worst, worst_tol = [0.0, 0.0, 0.0], list(TOL_SSD)

    def inputs(BC, cs, H, P, N, dt):
        xdt = torch.randn((BC, cs, H, P), generator=gen, device="cuda")
        dA = -torch.randn((BC, H, cs), generator=gen, device="cuda").abs() \
            * 0.1
        Bc = torch.randn((BC, cs, N), generator=gen, device="cuda")
        Cc = torch.randn((BC, cs, N), generator=gen, device="cuda")
        return [t.to(dt) for t in (xdt, dA, Bc, Cc)]

    for shape in cases:
        for dt in (torch.float32, torch.bfloat16):
            args = inputs(*shape, dt)
            n0 = ops.ssd_launches
            runs = [ops.intra_chunk(*args) for _ in range(SSD_REPEAT)]
            want = ref.intra_chunk(*args)
            torch.cuda.synchronize()
            key = str(dt).split(".")[1]
            if ops.ssd_launches - n0 != SSD_REPEAT:
                fail(f"ssd {shape} {key}: {ops.ssd_launches - n0} launches")
            if not all(torch.equal(a, b) for run in runs[1:]
                       for a, b in zip(run, runs[0])):
                fail(f"ssd {shape} {key}: repeated launches disagree")
            got = runs[0]
            errs = [max_err(g, w) for g, w in zip(got, want)]
            tols = [ssd_tol(w, b) for w, b in zip(want, TOL_SSD)]
            print(f"  ssd (BC, cs, H, P, N)={shape} {key} x{SSD_REPEAT}: "
                  f"max|err| Y {errs[0]:.3e}, S {errs[1]:.3e}, cum "
                  f"{errs[2]:.3e} (tol {tols[0]:.3e}, {tols[1]:.3e}, "
                  f"{tols[2]:.3e})", flush=True)
            if not all(e <= t for e, t in zip(errs, tols)):
                fail(f"ssd {shape} {key} errors {errs} > {tols}")
            if shape == prefill and key == "float32":
                worst, worst_tol = errs, tols
    BC, cs, H, P, N = prefill
    args = inputs(*prefill, torch.float32)
    ms = time_ms(lambda: ops.intra_chunk(*args), 20)
    plain = time_ms(lambda: ref.intra_chunk(*args), 5)
    flops, executed = rk.ssd_flops(*prefill)
    nbytes = rk.ssd_bytes(*prefill)
    # the products run in 3xTF32 on the tensor cores: three TF32 products
    # for each one of the function's
    b_ms, b_by = rk.bound_ms(nbytes, 3 * flops, hw.PEAK_FLOPS_TF32)
    b_f32_ms, _ = rk.bound_ms(nbytes, flops, hw.PEAK_FLOPS_F32)
    tflops = flops / ms / 1e9
    print(f"  ssd at the prefill shape: {ms:.4f} ms, {tflops:.1f} TFLOP/s "
          f"of the function's {flops / 1e9:.2f} GFLOP (modelled from the "
          f"tiles: {executed / 1e9:.2f} GFLOP executed, "
          f"{3 * executed / 1e9:.2f} on the tensor cores in 3xTF32, "
          f"{3 * executed / ms / 1e9:.1f} TFLOP/s); bound "
          f"{b_ms:.4f} ms ({b_by}, 3xTF32), f32 CUDA-core bound "
          f"{b_f32_ms:.4f} ms; plain {plain:.4f} ms", flush=True)
    return dict(name="ssd_intra_chunk", route="cuda",
                source="src/repro_torch/kernels/ssd/csrc/ssd_intra_chunk.cu",
                replaces="src/repro/kernels/ssd/ssd.py:57",
                max_abs_err=worst[0], tol=worst_tol[0], ms=ms,
                plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                bound_f32_ms=b_f32_ms, tflops=tflops,
                shape=f"BC={BC}, cs={cs}, H={H}, P={P}, N={N}, f32")


def _bwd_errs(torch, got, want, tol: float) -> tuple[list, list, float]:
    """Per gradient: max|err| and its limit tol x max|want| (+ 1e-6, for
    gradients that are all zero); and the largest max|err| / max|want|."""
    errs = [max_err(g, w) for g, w in zip(got, want)]
    sizes = [float(w.double().abs().max()) for w in want]
    lims = [tol * m + 1e-6 for m in sizes]
    rel = max((e / m if m > 0 else 0.0) for e, m in zip(errs, sizes))
    return errs, lims, rel


def _flash_bwd_inputs(torch, gen, case, dt, bthd: bool):
    """q, k, v, dO of a case; with ``bthd``, (B, H, T, D) views of (B, T,
    H, D) buffers, as training hands them to the backward: q, k, v are the
    projections' heads and dO the gradient through the output's merge."""
    B, Hq, Hkv, Tq, Tk, Dh = case[:6]

    def one(H, T):
        if not bthd:
            return torch.randn((B, H, T, Dh), generator=gen,
                               device="cuda").to(dt)
        return torch.randn((B, T, H, Dh), generator=gen,
                           device="cuda").to(dt).transpose(1, 2)
    return one(Hq, Tq), one(Hkv, Tk), one(Hkv, Tk), one(Hq, Tq)


def _flash_bwd_case(torch, ops, ref, gen, case, dt, bthd=False) -> float:
    """One backward case, BWD_REPEAT launches (each equal to the first),
    against the plain version one batch row at a time, from the forward's
    log-sum-exp as training hands it over (``attention_with_lse``), which is
    held against the plain one, and the forward's output bitwise against
    the forward without that store. The wgmma route must take exactly the
    bf16 cases at D = 64 and 128. Returns the largest gradient error
    relative to its gradient's size."""
    B, Hq, Hkv, Tq, Tk, Dh, window, off, causal = case
    q, k, v, do = _flash_bwd_inputs(torch, gen, case, dt, bthd)
    kw = dict(causal=causal, window=window, q_offset=off)
    key = str(dt).split(".")[1]
    with torch.no_grad():
        o, lse = ops.attention_with_lse(q, k, v, **kw)
        if not torch.equal(o, ops.attention(q, k, v, **kw)):
            fail(f"flash {case} {key}: the forward's output changes with "
                 f"its LSE store")
    want_lse = torch.cat([ref.attention_lse(q[b:b + 1], k[b:b + 1], **kw)
                          for b in range(B)])
    keyed = torch.isfinite(want_lse)
    lse_err = float((lse[keyed] - want_lse[keyed]).abs().max()) \
        if keyed.any() else 0.0
    if not (torch.equal(torch.isneginf(lse), ~keyed)
            and lse_err <= TOL_LSE):
        fail(f"flash {case} {key}: forward LSE error {lse_err} (tol "
             f"{TOL_LSE}) or rows without a key not -inf")
    n0, s0 = ops.flash_bwd_launches, ops.flash_bwd_sm90_launches
    runs = [ops.attention_backward(q, k, v, o, do, lse=lse, **kw)
            for _ in range(BWD_REPEAT)]
    want = [torch.cat(parts) for parts in zip(*(
        ref.attention_backward(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                               do[b:b + 1], **kw) for b in range(B)))]
    torch.cuda.synchronize()
    sm90 = ops.flash_bwd_sm90_launches - s0
    want_sm90 = BWD_REPEAT * (dt == torch.bfloat16 and Dh in (64, 128))
    if ops.flash_bwd_launches - n0 != BWD_REPEAT or sm90 != want_sm90:
        fail(f"flash backward {case} {key}: "
             f"{ops.flash_bwd_launches - n0} launches, {sm90} on the wgmma "
             f"route (want {BWD_REPEAT}, {want_sm90})")
    if not all(torch.equal(a, b) for run in runs[1:]
               for a, b in zip(run, runs[0])):
        fail(f"flash backward {case} {key}: repeated launches disagree")
    errs, lims, rel = _bwd_errs(torch, runs[0], want,
                                TOL_BWD["flash"][key])
    print(f"  flash backward B={B} Hq={Hq} Hkv={Hkv} Tq={Tq} Tk={Tk} D={Dh} "
          f"window={window} offset={off}{'' if causal else ' non-causal'} "
          f"{key}{' (B, T, H, D) views' if bthd else ''} x{BWD_REPEAT} "
          f"({'wgmma' if sm90 else 'mma.sync' if key != 'float32' else 'FMA'}"
          f" route): max|err| dq {errs[0]:.3e}, dk {errs[1]:.3e},"
          f" dv {errs[2]:.3e} (tol {lims[0]:.3e}, {lims[1]:.3e}, "
          f"{lims[2]:.3e}); forward LSE max|err| {lse_err:.2e} (tol "
          f"{TOL_LSE}), output bitwise without the store", flush=True)
    if not all(e <= t for e, t in zip(errs, lims)):
        fail(f"flash backward {case} {key}: errors {errs} > {lims}")
    return rel


def _flash_bwd_timing(torch, ops, ref, gen, case, bthd: bool) -> dict:
    """The flash backward at ``case`` (bf16, causal GQA) from the forward's
    LSE, as training calls it: time, its three kernels apart (profiler
    device time), the two-pass mma.sync kernels on the same inputs (the
    route that recomputes the LSE; its gradients held to the new ones under the
    bf16 limit), the plain version, SDPA's backward (``torch.autograd.grad``
    through ``scaled_dot_product_attention``, a yardstick the port never
    calls; its gradients held to the kernel's under the bf16 limit) and the
    bound: the five products the function needs over the causal half."""
    B, Hq, Hkv, T, _, Dh = case[:6]
    q, k, v, do = _flash_bwd_inputs(torch, gen, case, torch.bfloat16, bthd)
    with torch.no_grad():
        o, lse = ops.attention_with_lse(q, k, v)
    call = lambda: ops.attention_backward(q, k, v, o, do, lse=lse)
    old = lambda: ops._launch_bwd(q, k, v, o, do, True, None, Dh ** -0.5, 0)
    ms = time_ms(call, 10)
    old_ms = time_ms(old, 10)
    prep_ms = kernel_device_ms(torch, call, "bwd_prep", 5)
    dq_ms = kernel_device_ms(torch, call, "bwd_dq_sm90", 5)
    kv_ms = kernel_device_ms(torch, call, "bwd_dkdv_sm90", 5)
    errs, lims, _ = _bwd_errs(torch, old(), call(),
                              TOL_BWD["flash"]["bfloat16"])
    if not all(e <= t for e, t in zip(errs, lims)):
        fail(f"the flash backward's routes disagree: {errs} > {lims}")
    plain = time_ms(lambda: ref.attention_backward(q, k, v, do), 2,
                    warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    lo = sdpa(*leaves, is_causal=True, enable_gqa=True)
    lib = time_ms(lambda: torch.autograd.grad(lo, leaves, do,
                                              retain_graph=True), 10)
    lib_grads = torch.autograd.grad(lo, leaves, do)
    errs, lims, _ = _bwd_errs(torch, call(), lib_grads,
                              TOL_BWD["flash"]["bfloat16"])
    shape = (f"B={B}, Hq={Hq}, Hkv={Hkv}, T={T}, D={Dh}, causal, bf16"
             f"{', (B, T, H, D) views' if bthd else ''}")
    print(f"  flash backward vs SDPA's at {shape}: max|err| dq "
          f"{errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} (tol "
          f"{lims[0]:.3e}, {lims[1]:.3e}, {lims[2]:.3e})", flush=True)
    if not all(e <= t for e, t in zip(errs, lims)):
        fail(f"the flash backward disagrees with SDPA's: {errs} > {lims}")
    flops = rk.flash_bwd_flops(B, Hq, T, Dh)     # S, dP, dq, dk, dv
    b_ms, b_by = rk.bound_ms(rk.flash_bwd_bytes(B, Hq, Hkv, T, Dh), flops,
                             hw.PEAK_FLOPS_BF16)
    tflops = flops / ms / 1e9
    print(f"  flash backward at {shape}: {ms:.4f} ms, {tflops:.1f} TFLOP/s "
          f"of the bound's {flops / 1e9:.0f} GFLOP (5 products; the kernels "
          f"run 7, {7 / 5 * tflops:.1f} TFLOP/s executed); the two-pass "
          f"mma.sync kernels {old_ms:.4f} ms ({old_ms / ms:.2f}x); SDPA's "
          f"backward {lib:.4f} ms; plain {plain:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}); device: prep {prep_ms:.4f} ms, dq kernel "
          f"{dq_ms:.4f} ms, dk/dv kernel {kv_ms:.4f} ms", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, tflops=tflops, prep_ms=prep_ms, dq_ms=dq_ms,
                dkdv_ms=kv_ms, twopass_ms=old_ms, shape=shape)


def check_flash_bwd(torch, ops, ref, gen):
    """The flash backward kernel against autograd through the plain version:
    qwen3's training shape as phase 8 launches it (a microbatch of
    TRAIN_QWEN's batch; q, k, v and dO as (B, T, H, D) views), its prefill
    shape (causal GQA, D = 128), whisper's encoder and cross-attention
    shapes (non-causal, D = 64), a sliding window, and the kernel's other
    modes at small shapes (q_offset with Tq != Tk, D = 256, the pad route
    at D = 12, a row with no valid key) in bf16 and on the f32 instance.
    Timed at the training shape (the row) and at the prefill shape."""
    train = (TRAIN_QWEN["batch"] // TRAIN_QWEN["microbatches"], 16, 8,
             LM_SEQ, LM_SEQ, 128, None, 0, True)
    prefill = (LM_BATCH, 16, 8, LM_SEQ, LM_SEQ, 128, None, 0, True)
    bf16_cases = [prefill, WHISPER_ENC, WHISPER_CROSS,
                  (2, 16, 8, 2048, 2048, 128, 512, 0, True)]
    small = [(2, 8, 2, 300, 300, 128, None, 0, True),
             (1, 4, 2, 100, 200, 128, None, 100, True),
             (2, 4, 2, 300, 300, 256, 100, 0, True),
             (1, 4, 1, 96, 96, 12, None, 0, True),
             (2, 4, 4, 45, 150, 64, None, 0, False),
             (1, 2, 2, 4, 8, 64, 2, 20, True)]
    worst = _flash_bwd_case(torch, ops, ref, gen, train, torch.bfloat16,
                            bthd=True)
    for case in bf16_cases + small:
        worst = max(worst, _flash_bwd_case(torch, ops, ref, gen, case,
                                           torch.bfloat16))
    for case in small:
        _flash_bwd_case(torch, ops, ref, gen, case, torch.float32)
    _flash_bwd_case(torch, ops, ref, gen, small[0], torch.float32, bthd=True)

    row = _flash_bwd_timing(torch, ops, ref, gen, train, bthd=True)
    pre = _flash_bwd_timing(torch, ops, ref, gen, prefill, bthd=False)
    row.update({f"prefill_{k}": v for k, v in pre.items()})
    row.update(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/kernels/attention/csrc/"
                      "flash_attention_bwd.cu",
               replaces="src/repro/kernels/attention/flash.py:90",
               pallas="none: the port's own backward (the reference "
                      "defines none; its training differentiates the jnp "
                      "reference)",
               max_abs_err=worst, tol=TOL_BWD["flash"]["bfloat16"],
               err_is="max|err| / max|want| over the three gradients")
    return row


def _ssd_bwd_inputs(torch, gen, BC, cs, H, P, N, dt):
    xdt = torch.randn((BC, cs, H, P), generator=gen, device="cuda")
    dA = -torch.randn((BC, H, cs), generator=gen, device="cuda").abs() * 0.1
    Bc, Cc = (torch.randn((BC, cs, N), generator=gen, device="cuda")
              for _ in range(2))
    douts = [torch.randn(s, generator=gen, device="cuda")
             for s in ((BC, cs, H, P), (BC, H, P, N), (BC, H, cs))]
    return [t.to(dt) for t in (xdt, dA, Bc, Cc)], douts


def _ssd_bwd_timing(torch, ops, ref, gen, shape) -> dict:
    """The SSD backward at ``shape`` in f32: time, its four kernels apart
    (profiler device time), the plain version's, and the bound (3xTF32
    operations or bytes, as the kernels run; and on the f32 CUDA cores)."""
    BC, cs, H, P, N = shape
    args, douts = _ssd_bwd_inputs(torch, gen, *shape, torch.float32)
    call = lambda: ops.intra_chunk_backward(*args, *douts)
    ms = time_ms(call, 10)
    parts = {name: kernel_device_ms(torch, call, name, 5)
             for name in ("ssd_bwd_u", "ssd_bwd_e", "ssd_bwd_dbdc",
                          "ssd_bwd_dda")}
    plain = time_ms(lambda: ref.intra_chunk_backward(*args, *douts), 3,
                    warmup=1)
    flops = rk.ssd_bwd_flops(*shape)
    nbytes = rk.ssd_bwd_bytes(*shape)
    b_ms, b_by = rk.bound_ms(nbytes, 3 * flops, hw.PEAK_FLOPS_TF32)
    b_f32_ms, _ = rk.bound_ms(nbytes, flops, hw.PEAK_FLOPS_F32)
    desc = f"BC={BC}, cs={cs}, H={H}, P={P}, N={N}, f32"
    print(f"  ssd backward at {desc}: {ms:.4f} ms, {flops / ms / 1e9:.1f} "
          f"TFLOP/s of the function's {flops / 1e9:.2f} GFLOP (3xTF32 on "
          f"the tensor cores); bound {b_ms:.4f} ms ({b_by}, 3xTF32), f32 "
          f"CUDA-core bound {b_f32_ms:.4f} ms; plain {plain:.4f} ms; device: "
          + ", ".join(f"{n[8:]} {v:.4f} ms" for n, v in parts.items()),
          flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, bound_f32_ms=b_f32_ms,
                tflops=flops / ms / 1e9, shape=desc,
                **{f"{n[8:]}_ms": v for n, v in parts.items()})


def check_ssd_bwd(torch, ops, ref, gen):
    """The SSD backward kernel against autograd through the plain version,
    in f32 (as training feeds it) at mamba2's training shape as phase 8
    launches it (BC = TRAIN_MAMBA's batch x LM_SEQ / 256 chunks, so the
    wrapper splits the heads into the main path's groups) and at its
    prefill shape (another split), and at edges (ragged cs, H not a
    multiple of anything, a bf16 case); timed at the training shape (the
    row) and at the prefill shape."""
    train = (TRAIN_MAMBA["batch"] * LM_SEQ // 256, 256, 24, 64, 128)
    prefill = (LM_BATCH * LM_SEQ // 256, 256, 24, 64, 128)
    cases = [(train, torch.float32), (prefill, torch.float32),
             ((2, 200, 5, 64, 128), torch.float32),
             ((3, 100, 2, 80, 150), torch.float32),
             ((2, 256, 3, 64, 128), torch.bfloat16)]
    worst = 0.0
    for shape, dt in cases:
        args, douts = _ssd_bwd_inputs(torch, gen, *shape, dt)
        hpg, ng = ops.bwd_head_groups(shape[0], shape[2])
        n0 = ops.ssd_bwd_launches
        runs = [ops.intra_chunk_backward(*args, *douts)
                for _ in range(BWD_REPEAT)]
        want = ref.intra_chunk_backward(*args, *douts)
        torch.cuda.synchronize()
        key = str(dt).split(".")[1]
        if ops.ssd_bwd_launches - n0 != BWD_REPEAT:
            fail(f"ssd backward {shape} {key}: "
                 f"{ops.ssd_bwd_launches - n0} launches")
        if not all(torch.equal(a, b) for run in runs[1:]
                   for a, b in zip(run, runs[0])):
            fail(f"ssd backward {shape} {key}: repeated launches disagree")
        errs, lims, rel = _bwd_errs(torch, runs[0], want,
                                    TOL_BWD["ssd"][key])
        print(f"  ssd backward (BC, cs, H, P, N)={shape} {key} ({ng} head "
              f"groups of {hpg}) x{BWD_REPEAT}: max|err| dxdt "
              f"{errs[0]:.3e}, ddA {errs[1]:.3e}, dB {errs[2]:.3e}, dC "
              f"{errs[3]:.3e} (tol {', '.join(f'{t:.3e}' for t in lims)})",
              flush=True)
        if not all(e <= t for e, t in zip(errs, lims)):
            fail(f"ssd backward {shape} {key}: errors {errs} > {lims}")
        if key == "float32":
            worst = max(worst, rel)
    row = _ssd_bwd_timing(torch, ops, ref, gen, train)
    pre = _ssd_bwd_timing(torch, ops, ref, gen, prefill)
    row.update({f"prefill_{k}": v for k, v in pre.items()})
    row.update(name="ssd_intra_chunk_bwd", route="cuda",
               source="src/repro_torch/kernels/ssd/csrc/"
                      "ssd_intra_chunk_bwd.cu",
               replaces="src/repro/kernels/ssd/ssd.py:57",
               pallas="none: the port's own backward (the reference "
                      "defines none; its training differentiates the jnp "
                      "reference)",
               max_abs_err=worst, tol=TOL_BWD["ssd"]["float32"],
               err_is="max|err| / max|want| over the four gradients")
    return row


def ptxas_report(log: str) -> dict:
    """Per entry function of an ``-Xptxas -v`` log: its registers and its
    spill stores and loads, in bytes."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


# opcode classes of a SASS listing; what is in none of them (integer and
# logic, moves, selects) counts as "other"; "scaffold" is a probe kernel's
# own global loads and stores, constants and control
SASS_FP64 = {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"}
SASS_FP32 = {"FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FCHK",
             "FSET", "MUFU"}
SASS_SHARED = {"LDS", "STS", "SHFL"}
SASS_SCAFFOLD = {"LDG", "STG", "LD", "ST", "LDC", "ULDC", "LDL", "STL",
                 "S2R", "S2UR", "CS2R", "BRA", "EXIT", "BSSY", "BSYNC",
                 "CALL", "RET", "NOP", "WARPSYNC", "BAR", "YIELD", "BPT"}


def sass_classes(lib, fragment: str) -> dict:
    """Per function of the shared library ``lib`` whose mangled name holds
    ``fragment``: its SASS instructions by class (fp64, fp32, shared:
    shared-memory accesses and shuffles, other, and the global loads,
    stores and control around them apart), from ``cuobjdump -sass``."""
    counts = {}
    for name, lines in sass_functions(lib, "the downdate's SASS").items():
        if fragment not in name:
            continue
        cur = counts[name] = dict.fromkeys(
            ("fp64", "fp32", "shared", "other", "scaffold"), 0)
        for line in lines:
            m = re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                line)
            if not m:
                continue
            op = m.group(1)
            if op in SASS_FP64 or (op == "MUFU" and "64H" in line):
                cur["fp64"] += 1
            elif op in SASS_FP32:
                cur["fp32"] += 1
            elif op in SASS_SHARED:
                cur["shared"] += 1
            elif op in SASS_SCAFFOLD:
                cur["scaffold"] += 1
            else:
                cur["other"] += 1
    return counts


def downdate_issue_bound(lib, n: int, b: int) -> dict:
    """The downdate's issue bound, a model from its SASS (not a time the
    run measures): the instructions of one step of a full off-diagonal
    item (``update_issue_probe`` of the probes' library ``lib``, 32 rows a
    lane, the common path: w passed on through shared memory, the
    numerators, their range, the fast quotients, the new w), a row
    update's share of them times the b n (n - 1) / 2 row updates, over the
    card's rate: 64 FP64 lanes a clock an SM for the FP64 pipe, 128 issue
    slots a clock an SM for every instruction (the guide's peaks,
    hw.PEAK_FLOPS_F64 / 2 and hw.PEAK_FLOPS_F32 / 2 lane-instructions a
    second)."""
    updates = b * n * (n - 1) // 2
    found = {}
    for name, c in sass_classes(lib, "update_issue_probe").items():
        key = "float64" if "IdE" in name else "float32"
        per = {k: v / 32 for k, v in c.items()}
        issued = per["fp64"] + per["fp32"] + per["shared"] + per["other"]
        t_issue = updates * issued / (hw.PEAK_FLOPS_F32 / 2)
        t_fp64 = updates * per["fp64"] / (hw.PEAK_FLOPS_F64 / 2)
        found[key] = dict(per_update=per, issued=issued,
                          bound_ms=max(t_issue, t_fp64) * 1e3,
                          by="the FP64 pipe" if t_fp64 > t_issue
                          else "issue")
    if set(found) != {"float32", "float64"}:
        fail(f"update_issue_probe's SASS: found {sorted(found)}")
    return found


def check_downdate(torch, ops, ref, gen):
    """The Cholesky downdate chol(L Lᵀ - W Wᵀ) against its plain version
    (the reference's sweeps in wavefront order) in f32 and f64: the main
    path's (n, b) = (|S|, |D|/M) = (2048, 1600) (a machine retired from
    Sdd_L, or pICF's Phi_L at R = 2048), ragged tiles, b = 1, b > n,
    n = 1, zero columns, and n one less than, equal to and one more than
    the kernel's 32-row and 32-column tiles (an item runs all b sweeps, a
    sweep at a time, so b = 1 and b > n are its edges in b); each case
    launched DOWNDATE_REPEAT times, every run equal to the first and
    bitwise the plain version's (the run fails otherwise). Inputs:
    L1 = chol(L0 L0ᵀ + W Wᵀ) from the QR of its root, so the downdate
    gives back L0. The float64 instance must spill nothing (ptxas). Timed
    at the main shape beside its bounds, its issue bound (a model from the
    SASS of the probes' library), its serial floor (``ops.chain_probe``,
    of the probes' library: the diagonal and sub-diagonal
    items alone, on L1 and W / 10 so that no step leaves the fast
    quotient's range), the plain version and, in float64, the yardstick
    ``torch.linalg.cholesky(L1 @ L1.mT - W @ W.mT)`` (two calls, and not
    the same function: it forms the difference); also at (256, 64), back
    to back with the wrapper's copies (``ms_256x64``, as the grid-barrier
    design before this one was timed) and on the device
    (``device_ms_256x64``)."""
    from repro_torch.core import linalg
    from repro_torch.kernels import build
    main = (S_SIZE, N_TRAIN // M)
    cases = [(main, ()), ((300, 257), ()), ((128, 1), ()), ((8, 40), ()),
             ((1, 3), ()), ((96, 12), (0, 5, 11)), ((31, 7), ()),
             ((32, 8), ()), ((33, 9), ()), ((63, 9), ()), ((64, 8), ()),
             ((65, 7), ())]
    so = build.target("chol_downdate")
    report = ptxas_report(so.with_suffix(".log").read_text())
    for name, r in sorted(report.items()):
        if "downdate_kernel" in name:
            print(f"  chol_downdate ptxas {name[-40:]}: {r}", flush=True)
            if r.get("spill", 0):
                fail(f"chol_downdate: {name} spills ({r})")

    def inputs(n, b, dt, zero=()):
        L0 = torch.tril(torch.randn((n, n), generator=gen, device="cuda")
                        * 0.1, -1) \
            + torch.diag(1.0 + torch.rand(n, generator=gen, device="cuda"))
        W = torch.randn((n, b), generator=gen, device="cuda") * 0.5 / b ** 0.5
        W[:, list(zero)] = 0.0
        L0, W = L0.to(dt), W.to(dt)
        return L0, linalg.chol_from_root(L0, W), W

    worst, rows = {}, {}
    for (n, b), zero in cases:
        for dt in (torch.float32, torch.float64):
            key = str(dt).split(".")[1]
            L0, L1, W = inputs(n, b, dt, zero)
            n0 = ops.chol_downdate_launches
            runs = [ops.chol_downdate(L1, W) for _ in range(DOWNDATE_REPEAT)]
            t0 = time.perf_counter()
            want = ref.chol_downdate(L1, W)
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
            if ops.chol_downdate_launches - n0 != DOWNDATE_REPEAT:
                fail(f"chol_downdate ({n}, {b}) {key}: "
                     f"{ops.chol_downdate_launches - n0} launches")
            if not all(torch.equal(r, runs[0]) for r in runs[1:]):
                fail(f"chol_downdate ({n}, {b}) {key}: repeated launches "
                     f"disagree")
            got = runs[0]
            err, back = max_err(got, want), max_err(got, L0)
            bitwise = bool(torch.equal(got, want))
            print(f"  chol_downdate (n, b)=({n}, {b}) zero columns "
                  f"{list(zero)} {key} x{DOWNDATE_REPEAT}: max|err| vs plain "
                  f"{err:.3e} (tol {TOL_DOWNDATE[key]:.0e}), bitwise "
                  f"{bitwise}; vs the factor before the update {back:.3e}; "
                  f"plain {t_plain:.3f} s", flush=True)
            if not (err <= TOL_DOWNDATE[key] and bitwise):
                fail(f"chol_downdate ({n}, {b}) {key} error {err}, bitwise "
                     f"{bitwise}")
            if zero and not torch.equal(
                    ops.chol_downdate(L0, W[:, list(zero)]), L0):
                fail("chol_downdate: zero columns changed L")
            if (n, b) == main:
                worst[key] = err
                rows[key] = (L1, W, t_plain)
    n, b = main
    issue = downdate_issue_bound(build.target("chol_downdate_probe"), n, b)
    out = {}
    for key, (L1, W, t_plain) in rows.items():
        dt = L1.dtype
        ms = kernel_device_ms(torch, lambda: ops.chol_downdate(L1, W),
                              "downdate_kernel", 5)
        b2b = time_ms(lambda: ops.chol_downdate(L1, W), 5)
        peak = hw.PEAK_FLOPS_F32 if dt == torch.float32 \
            else hw.PEAK_FLOPS_F64
        b_ms, b_by = rk.bound_ms(rk.downdate_bytes(n, b, L1.element_size()),
                                 rk.downdate_flops(n, b), peak)
        W10 = W / 10
        chain = kernel_device_ms(torch, lambda: ops.chain_probe(L1, W10),
                                 "downdate_kernel", 5)
        L1s, Ws = L1[:256, :256].contiguous(), W[:256, :64].contiguous()
        small = time_ms(lambda: ops.chol_downdate(L1s, Ws), 5)
        small_dev = kernel_device_ms(
            torch, lambda: ops.chol_downdate(L1s, Ws), "downdate_kernel", 5)
        small_plain = time_ms(lambda: ref.chol_downdate(L1s, Ws), 1, 1)
        model = issue[key]
        per = model["per_update"]
        print(f"  chol_downdate at ({n}, {b}) {key}: device {ms:.4f} ms "
              f"(back to back with the wrapper's copies {b2b:.4f} ms); "
              f"bound {b_ms:.4f} ms ({b_by}: "
              f"{rk.downdate_flops(n, b) / 1e9:.1f} GFLOP, "
              f"{rk.downdate_bytes(n, b, L1.element_size()) / 1e6:.1f} MB); "
              f"issue bound (a model from the SASS) "
              f"{model['bound_ms']:.4f} ms ({model['by']}; SASS a row "
              f"update: {per['fp64']:.3f} FP64, {per['fp32']:.3f} FP32, "
              f"{per['shared']:.3f} shared, {per['other']:.3f} other); "
              f"serial floor (chain probe) {chain:.4f} ms; plain "
              f"{t_plain * 1e3:.1f} ms; at (256, 64) back to back with the "
              f"wrapper's copies {small:.4f} ms, device {small_dev:.4f} ms, "
              f"plain {small_plain:.2f} ms", flush=True)
        out[key] = dict(ms=ms, plain_ms=t_plain * 1e3, bound_ms=b_ms,
                        bound_by=b_by, issue_bound_ms=model["bound_ms"],
                        issue_bound_by=model["by"], chain_floor_ms=chain,
                        back_to_back_ms=b2b, ms_256x64=small,
                        device_ms_256x64=small_dev,
                        plain_ms_256x64=small_plain)
    L1, W, _ = rows["float64"]
    yard = time_ms(lambda: torch.linalg.cholesky(L1 @ L1.mT - W @ W.mT), 5)
    yard_err = max_err(torch.linalg.cholesky(L1 @ L1.mT - W @ W.mT),
                       ops.chol_downdate(L1, W))
    print(f"  yardstick (not the same function): torch.linalg.cholesky("
          f"L1 @ L1.mT - W @ W.mT) float64 at ({n}, {b}) {yard:.4f} ms "
          f"back to back, max|diff| from the kernel's factor "
          f"{yard_err:.3e}", flush=True)
    f32, f64 = out["float32"], out["float64"]
    return dict(name="chol_downdate", route="cuda",
                source="src/repro_torch/kernels/linalg/csrc/chol_downdate.cu",
                replaces="src/repro/core/linalg.py:125",
                pallas="none: the port's own kernel (the reference's "
                       "downdate is jitted LINPACK sweeps)",
                max_abs_err=worst["float32"], tol=TOL_DOWNDATE["float32"],
                ms=f32["ms"], plain_ms=f32["plain_ms"],
                bound_ms=f32["bound_ms"], bound_by=f32["bound_by"],
                library_ms=None,
                issue_bound_ms=f32["issue_bound_ms"],
                issue_bound_by=f32["issue_bound_by"],
                chain_floor_ms=f32["chain_floor_ms"],
                back_to_back_ms=f32["back_to_back_ms"],
                ms_256x64=f32["ms_256x64"],
                device_ms_256x64=f32["device_ms_256x64"],
                plain_ms_256x64=f32["plain_ms_256x64"],
                f64_ms=f64["ms"], f64_plain_ms=f64["plain_ms"],
                f64_bound_ms=f64["bound_ms"],
                f64_issue_bound_ms=f64["issue_bound_ms"],
                f64_issue_bound_by=f64["issue_bound_by"],
                f64_chain_floor_ms=f64["chain_floor_ms"],
                f64_ms_256x64=f64["ms_256x64"],
                f64_device_ms_256x64=f64["device_ms_256x64"],
                f64_max_abs_err=worst["float64"],
                f64_yardstick_cholesky_ms=yard,
                shape=f"(n, b) = ({n}, {b}) f32")


def _rows_tables(torch, gen, dt) -> dict:
    """Random operands of the routed diag program at AIMPEAK's widths, M
    blocks of ROWS_U rows (the 256-row request's main bucket): K_US,
    K_UD, the factors L, L2 (s, s) and C_L (M, b, b) with their inverses,
    Q and K_SD (M, s, b), alpha and Wy; entries O(1) over their sums."""
    from repro_torch.core import ppic
    s, b = S_SIZE, N_TRAIN // M

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def factor(*shape):
        n = shape[-1]
        return (torch.tril(randn(*shape, scale=0.3 / n ** 0.5), -1)
                + torch.diag_embed(1.0 + torch.rand(shape[:-1], generator=gen,
                                                    device="cuda")))
    t = dict(Kus=randn(M, ROWS_U, s), Kud=randn(M, ROWS_U, b),
             L=factor(s, s), L2=factor(s, s), C_L=factor(M, b, b),
             Q=randn(M, s, b, scale=s ** -0.5),
             Ksd=randn(M, s, b, scale=b ** -0.5), alpha=randn(s, scale=0.1),
             Wy=randn(M, b, scale=0.1), kdiag=1.0 + torch.rand(
                 (M, ROWS_U), generator=gen, device="cuda"))
    t = {k: v.to(dt) for k, v in t.items()}
    eye = torch.eye(s, dtype=dt, device="cuda")
    t["Linv"] = torch.linalg.solve_triangular(t["L"], eye, upper=False)
    t["L2inv"] = torch.linalg.solve_triangular(t["L2"], eye, upper=False)
    t["CLinv"] = ppic.chol_inv_blocks(t["C_L"])
    return t


def _rows_stages(mm, t: dict, X=None, idx=None) -> list:
    """The program's six rows_mm stages (``ppic._diag_stages``) through
    ``mm`` (the wrapper or the plain version), each on the previous one's
    output; X in place of K_US (then t's K_UD matches it) and idx for the
    tables where given."""
    Kus = t["Kus"] if X is None else X
    A = mm(Kus, t["Linv"], trans=True, lower=True)
    R = mm(A, t["Q"], idx, C0=t["Kud"])
    V = mm(R, t["CLinv"], idx, trans=True, lower=True)
    W = mm(V, t["CLinv"], idx, lower=True)
    Phi = mm(W, t["Ksd"], idx, trans=True, C0=Kus)
    return [A, R, V, W, Phi, mm(Phi, t["L2inv"], trans=True, lower=True)]


def _rows_library(torch, t: dict) -> list:
    """The same six stages, one PyTorch call each on the same cached
    inverses and tables (cuBLAS GEMM; its blocking and split-K follow the
    row count): the library's time for the same function."""
    A = torch.matmul(t["Kus"], t["Linv"].mT)
    R = torch.baddbmm(t["Kud"], A, t["Q"], alpha=-1)
    V = torch.bmm(R, t["CLinv"].mT)
    W = torch.bmm(V, t["CLinv"])
    Phi = torch.baddbmm(t["Kus"], W, t["Ksd"].mT, alpha=-1)
    return [A, R, V, W, Phi, torch.matmul(Phi, t["L2inv"].mT)]


def _rows_parent_route(torch, t: dict) -> list:
    """The same six stages as the port's earlier route took them to the
    library (cuBLAS trsm and GEMM against the factors)."""
    from repro_torch.core import linalg
    Kus, s = t["Kus"], t["Kus"].shape[-1]

    def right(L, X):
        return linalg.tri_solve_right(L, X.reshape(-1, X.shape[-1])
                                      ).reshape(X.shape)
    A = right(t["L"], Kus)
    R = t["Kud"] - A @ t["Q"]
    V = linalg.tri_solve_right(t["C_L"], R)
    W = torch.linalg.solve_triangular(t["C_L"], V, upper=False, left=False)
    Phi = Kus - W @ t["Ksd"].mT
    return [A, R, V, W, Phi, right(t["L2"], Phi)]


def _rows_large(torch, ops, ref, gen, t: dict, got: list, key: str
                ) -> dict:
    """The six stages at the 3200-row request's shape, M blocks of
    ROWS_U_LARGE rows whose first ROWS_U rows are ``t``'s (``got``: the
    kernel's stages on ``t`` alone): f64 bitwise the plain version, f32
    within TOL_ROWS_F32 of its scale, each ROWS_U row the same bits inside
    the larger batch. Timed (device, from a trace) beside the bound and the
    library's GEMMs at that shape."""
    dt = t["Kus"].dtype
    b = t["Kud"].shape[-1]

    def widen(x, cols):
        w = torch.randn((M, ROWS_U_LARGE, cols), generator=gen,
                        device="cuda").to(dt)
        w[:, :ROWS_U] = x
        return w
    tl = dict(t, Kus=widen(t["Kus"], S_SIZE), Kud=widen(t["Kud"], b))
    calls = []

    def recorded(X, B, idx=None, **kw):
        calls.append((X, B, idx, kw))
        return ops.rows_mm(X, B, idx, **kw)
    large = _rows_stages(recorded, tl)
    same = all(bool(torch.equal(y[:, :ROWS_U], g))
               for y, g in zip(large, got))
    errs, bitwise = [], []
    for (X, B, idx, kw), y in zip(calls, large):
        want = ref.rows_mm(X, B, idx, **kw)
        scale = (X.abs().double() @ (B.abs().double().mT if kw.get(
            "trans") else B.abs().double())).amax()
        if kw.get("C0") is not None:
            scale = scale + kw["C0"].abs().amax()
        errs.append(max_err(y, want) / float(scale))
        bitwise.append(bool(torch.equal(y, want)))
        del want
    ms = kernel_device_ms(torch, lambda: _rows_stages(ops.rows_mm, tl),
                          "rows_mm", 3, per_call=(6,))
    lib = kernel_device_ms(torch, lambda: _rows_library(torch, tl), "", 3,
                           per_call=tuple(range(1, 10000)))
    peak = hw.PEAK_FLOPS_TF32 if dt == torch.float32 \
        else hw.PEAK_FLOPS_F64_TENSOR
    mult = 3 if dt == torch.float32 else 1
    size = torch.finfo(dt).bits // 8
    stages = rk.ppic_diag_stages(M, ROWS_U_LARGE, S_SIZE, b)
    bounds = [rk.bound_ms(rk.rows_mm_bytes(r, K, N, e, lo, c, size),
                          mult * rk.rows_mm_flops(r, K, N, lo), peak)
              for _, r, K, N, e, lo, c in stages]
    flops = sum(rk.rows_mm_flops(r, K, N, lo)
                for _, r, K, N, e, lo, c in stages)
    b_ms = sum(x for x, _ in bounds)
    by = "+".join(sorted({w for _, w in bounds}))
    tol = 0.0 if dt == torch.float64 else TOL_ROWS_F32
    print(f"  rows_mm {key} at the 3200-row request's shape (M, u, s, b) = "
          f"({M}, {ROWS_U_LARGE}, {S_SIZE}, {b}): device {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s of {flops / 1e9:.1f} GFLOP); "
          f"bound {b_ms:.4f} ms ({by}); the library's GEMMs {lib:.4f} ms; "
          f"error vs plain over scale {[float(f'{e:.2e}') for e in errs]} "
          f"(limit {tol:.0e}), bitwise {bitwise}; the {ROWS_U}-row blocks' "
          f"rows the same bits inside the {ROWS_U_LARGE}-row batch: {same}",
          flush=True)
    if not same or (dt == torch.float64 and not all(bitwise)) \
            or max(errs) > tol:
        fail(f"rows_mm {key} at u = {ROWS_U_LARGE}: errors {errs}, bitwise "
             f"{bitwise}, the {ROWS_U}-row rows the same {same}")
    return dict(ms=ms, bound_ms=b_ms, bound_by=by, library_ms=lib,
                max_rel_err=max(errs))


def check_rows(torch, ops, ref, gen) -> list:
    """The row products of pPIC's routed diag (``ops.rows_mm``,
    ``ops.rows_reduce``) against their plain versions at the 256-row
    request's shapes (M = 20 blocks of 32 rows, s = 2048, b = 1600), in
    float32 and float64, each stage on the previous one's kernel output:
    f64 and rows_reduce bitwise, rows_mm f32 within TOL_ROWS_F32 of its
    scale; each launched ROWS_REPEAT times, every run equal. Row-count
    independence: each stage's rows are the same bits alone (one block, one
    row), inside the capacity-|U| batch (256 rows a block) and as overflow
    groups reading their owner's entries through an index. Timed (device,
    from a trace) over the six stages of a request beside their summed
    bounds, the plain version, the library's GEMMs on the same inverses
    and the parent's route (trsm and GEMM against the factors) on the same
    stages; rows_reduce alone."""
    def eq(a, b):
        return bool(torch.equal(a, b))

    out = {}
    for dt in (torch.float32, torch.float64):
        key = str(dt).split(".")[1]
        t = _rows_tables(torch, gen, dt)
        n0, calls = ops.rows_mm_launches, []

        def recorded(X, B, idx=None, **kw):
            calls.append((X, B, idx, kw))
            return ops.rows_mm(X, B, idx, **kw)
        runs = [_rows_stages(recorded, t)] + [
            _rows_stages(ops.rows_mm, t) for _ in range(ROWS_REPEAT - 1)]
        if ops.rows_mm_launches - n0 != 6 * ROWS_REPEAT:
            fail(f"rows_mm {key}: {ops.rows_mm_launches - n0} launches for "
                 f"{ROWS_REPEAT} x 6 stages")
        if not all(eq(a, b) for r in runs[1:] for a, b in zip(r, runs[0])):
            fail(f"rows_mm {key}: repeated launches disagree")
        got = runs[0]
        errs, abs_errs, bitwise = [], [], []
        for (X, B, idx, kw), y in zip(calls, got):
            want = ref.rows_mm(X, B, idx, **kw)
            abs_errs.append(max_err(y, want))
            scale = (X.abs().double() @ (B.abs().double().mT if kw.get(
                "trans") else B.abs().double())).amax()
            if kw.get("C0") is not None:
                scale = scale + kw["C0"].abs().amax()
            errs.append(max_err(y, want) / float(scale))
            bitwise.append(eq(y, want))
        # row-count independence: one row alone; the capacity-|U| batch;
        # overflow groups (blocks 3, 3, 7) through an index
        big = torch.randn((M, 8 * ROWS_U, S_SIZE), generator=gen,
                          device="cuda").to(dt)
        big[:, :ROWS_U] = t["Kus"]
        cap = _rows_stages(ops.rows_mm, dict(t, Kud=torch.cat(
            [t["Kud"], big[:, ROWS_U:, :t["Kud"].shape[-1]]], 1)), big)
        grp = torch.tensor([3, 3, 7], device="cuda")
        over = _rows_stages(ops.rows_mm, dict(t, Kud=t["Kud"][grp]),
                            t["Kus"][grp], grp)
        one = _rows_stages(ops.rows_mm, dict(t, Kud=t["Kud"][5:6, 9:10]),
                           t["Kus"][5:6, 9:10], torch.tensor([5],
                                                             device="cuda"))
        indep = all(eq(c[:, :ROWS_U], g) and eq(o, g[grp])
                    and eq(z[0, 0], g[5, 9])
                    for c, o, z, g in zip(cap, over, one, got))
        # a table read in place through other strides (Q column-major, as
        # the triangular solve returns it): the same bits
        Qc = t["Q"].mT.contiguous().mT
        indep &= eq(ops.rows_mm(got[0], Qc, C0=t["Kud"]), got[1])
        tol = 0.0 if dt == torch.float64 else TOL_ROWS_F32
        print(f"  rows_mm {key} (M, u, s, b) = ({M}, {ROWS_U}, {S_SIZE}, "
              f"{N_TRAIN // M}) x{ROWS_REPEAT}, stages A R V W Phi Z: error "
              f"vs plain over scale {[float(f'{e:.2e}') for e in errs]} (limit "
              f"{tol:.0e}), bitwise {bitwise}; rows the same alone, in the "
              f"capacity batch and as indexed groups, and Q read "
              f"column-major the same: {indep}", flush=True)
        if not indep or (dt == torch.float64 and not all(bitwise)) \
                or max(errs) > tol:
            fail(f"rows_mm {key}: errors {errs}, bitwise {bitwise}, "
                 f"row-independent {indep}")

        A, R, V, W, Phi, Z = got
        red, red_errs = [], []
        for cinv, T in ((False, V), (True, W)):
            args = (t["kdiag"], Phi, t["alpha"], R, t["Wy"], None, A, T, Z)
            n0 = ops.rows_reduce_launches
            rr = [ops.rows_reduce(*args, cinv=cinv)
                  for _ in range(ROWS_REPEAT)]
            want = ref.rows_reduce(*args, cinv=cinv)
            red_errs += [max_err(rr[0][0], want[0]),
                         max_err(rr[0][1], want[1])]
            m1, v1 = ops.rows_reduce(
                args[0][3:4, 9:10], Phi[3:4, 9:10], t["alpha"],
                R[3:4, 9:10], t["Wy"], torch.tensor([3], device="cuda"),
                A[3:4, 9:10], T[3:4, 9:10], Z[3:4, 9:10], cinv=cinv)
            ok = (ops.rows_reduce_launches - n0 == ROWS_REPEAT + 1
                  and all(eq(r[0], rr[0][0]) and eq(r[1], rr[0][1])
                          for r in rr)
                  and eq(rr[0][0], want[0]) and eq(rr[0][1], want[1])
                  and eq(m1[0, 0], want[0][3, 9])
                  and eq(v1[0, 0], want[1][3, 9]))
            red.append(ok)
        print(f"  rows_reduce {key} (cinv False, True) x{ROWS_REPEAT}: "
              f"bitwise the plain version, repeated runs equal, a row alone "
              f"the same: {red}; max|kernel - plain| {max(red_errs):.3e}",
              flush=True)
        if not all(red):
            fail(f"rows_reduce {key}: {red}")

        large = _rows_large(torch, ops, ref, gen, t, got, key)
        torch.cuda.empty_cache()
        # times: the six stages of one request, device, from a trace
        ms = kernel_device_ms(torch, lambda: _rows_stages(ops.rows_mm, t),
                              "rows_mm", 5, per_call=(6,))
        stage_ms = [kernel_device_ms(
            torch, lambda a=a: ops.rows_mm(*a[:3], **a[3]), "rows_mm", 5)
            for a in calls]
        t0 = time.perf_counter()
        _rows_stages(ref.rows_mm, t)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        lib = kernel_device_ms(torch, lambda: _rows_library(torch, t), "", 5,
                               per_call=tuple(range(1, 10000)))
        lib_err = max(max_rel(a, b) for a, b in zip(_rows_library(torch, t),
                                                    got))
        parent = kernel_device_ms(
            torch, lambda: _rows_parent_route(torch, t), "", 5,
            per_call=tuple(range(1, 10000)))
        parent_err = max(max_rel(a, b) for a, b in zip(
            _rows_parent_route(torch, t), got))
        # a matrix product: f64 at the tensor cores' (DMMA) rate
        peak = hw.PEAK_FLOPS_TF32 if dt == torch.float32 \
            else hw.PEAK_FLOPS_F64_TENSOR
        mult = 3 if dt == torch.float32 else 1
        size = torch.finfo(dt).bits // 8
        stages = rk.ppic_diag_stages(M, ROWS_U, S_SIZE, N_TRAIN // M)
        nbytes = [rk.rows_mm_bytes(r, K, N, e, lo, c, size)
                  for _, r, K, N, e, lo, c in stages]
        fl = [rk.rows_mm_flops(r, K, N, lo)
              for _, r, K, N, e, lo, c in stages]
        bounds = [rk.bound_ms(nb, mult * f, peak) for nb, f in zip(nbytes, fl)]
        b_ms, flops = sum(b for b, _ in bounds), sum(fl)
        by = "bytes" if sum(nbytes) / hw.HBM_BW >= mult * flops / peak \
            else "operations"
        args = (t["kdiag"], Phi, t["alpha"], R, t["Wy"], None, A, V, Z)
        r_ms = kernel_device_ms(torch, lambda: ops.rows_reduce(*args),
                                "rows_reduce", 5)
        t0 = time.perf_counter()
        ref.rows_reduce(*args)
        torch.cuda.synchronize()
        r_plain = (time.perf_counter() - t0) * 1e3
        sums = time_ms(lambda: (
            torch.sum(Phi * t["alpha"], -1) + torch.sum(R * t["Wy"][:, None],
                                                        -1),
            t["kdiag"] - torch.sum(A * A, -1) - torch.sum(V * V, -1)
            + torch.sum(Z * Z, -1)), 5)
        rows = M * ROWS_U
        r_b, r_by = rk.bound_ms(
            rk.rows_reduce_bytes(rows, S_SIZE, N_TRAIN // M, M, size),
            rk.rows_reduce_flops(rows, S_SIZE, N_TRAIN // M),
            hw.PEAK_FLOPS_F32 if dt == torch.float32 else hw.PEAK_FLOPS_F64)
        print(f"  rows_mm {key}, the six stages of a 256-row request: device "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; stages "
              f"{[round(x, 4) for x in stage_ms]} ms); bound {b_ms:.4f} ms "
              f"(stages {[(round(b, 4), w) for b, w in bounds]}); plain "
              f"{plain:.2f} ms; the library's GEMMs on the same inverses "
              f"(bmm, baddbmm) {lib:.4f} ms device, its rows within "
              f"{lib_err:.2e} of 1 + |value| of the kernel's; the parent's "
              f"route (trsm and GEMM against the factors) {parent:.4f} ms "
              f"device, within {parent_err:.2e}", flush=True)
        print(f"  rows_reduce {key} ({rows} rows): device {r_ms:.4f} ms; "
              f"bound {r_b:.4f} ms ({r_by}); plain {r_plain:.2f} ms; "
              f"torch.sum of the products (the earlier route) {sums:.4f} ms "
              f"back to back", flush=True)
        out[key] = dict(mm=dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                bound_by=by, library_ms=lib,
                                parent_route_ms=parent, stage_ms=stage_ms,
                                max_abs_err=max(abs_errs),
                                max_rel_err=max(errs)),
                        large=large,
                        red=dict(ms=r_ms, plain_ms=r_plain, bound_ms=r_b,
                                 bound_by=r_by, sums_ms=sums,
                                 max_abs_err=max(red_errs)))
        del t, runs, got, cap, over, one, big, calls
        torch.cuda.empty_cache()
    f32, f64 = out["float32"], out["float64"]
    src = "src/repro_torch/kernels/linalg/csrc/row_products.cu"
    pallas = ("none: the port's own kernel (the reference computes the "
              "routed diag in jnp under jit)")
    shape = (f"a 256-row request's main bucket: (M, u, s, b) = ({M}, "
             f"{ROWS_U}, {S_SIZE}, {N_TRAIN // M}) f32")
    mm = dict(name="rows_mm", route="cuda", source=src,
              replaces="src/repro/core/ppic.py:141", pallas=pallas,
              **{k: f32["mm"][k] for k in ("max_abs_err", "max_rel_err",
                                           "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "parent_route_ms", "stage_ms")},
              rel_tol=TOL_ROWS_F32,
              err_is="max_abs_err: max|kernel - plain| over the six stages; "
                     "max_rel_err: each stage's over max(|X| |op(B)|) + "
                     "max|C0|, held to rel_tol",
              library="the same six stages, one cuBLAS GEMM each (bmm, "
                      "baddbmm) on the same inverses and tables, summed",
              parent_route="the six stages through cuBLAS trsm and GEMM "
                           "against the factors (the parent's route), summed",
              timed_as="the six stages of one request, device time summed",
              f64_ms=f64["mm"]["ms"], f64_plain_ms=f64["mm"]["plain_ms"],
              f64_bound_ms=f64["mm"]["bound_ms"],
              f64_library_ms=f64["mm"]["library_ms"],
              f64_parent_route_ms=f64["mm"]["parent_route_ms"],
              f64_max_abs_err=f64["mm"]["max_abs_err"], shape=shape,
              **{f"u{ROWS_U_LARGE}_{k}": v for k, v in f32["large"].items()},
              **{f"f64_u{ROWS_U_LARGE}_{k}": v
                 for k, v in f64["large"].items()})
    red = dict(name="rows_reduce", route="cuda", source=src,
               replaces="src/repro/core/ppic.py:162", pallas=pallas,
               max_abs_err=f32["red"]["max_abs_err"], tol=0.0,
               f64_max_abs_err=f64["red"]["max_abs_err"],
               **{k: f32["red"][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")},
               library_ms=None, sums_ms=f32["red"]["sums_ms"],
               f64_ms=f64["red"]["ms"], f64_plain_ms=f64["red"]["plain_ms"],
               f64_bound_ms=f64["red"]["bound_ms"], shape=shape)
    return [mm, red]


def lm_path(torch, card: str, cfg, counter, params, gen, *,
            check_cfg=None) -> dict:
    """Prefill and generation of ``cfg`` at full width (and the depth it
    gives) through the port's entry points, on ``params`` and inputs drawn
    from ``gen`` (``init_lm``'s), then the float32 forward-vs-decode check
    (on ``check_cfg`` when given: an MoE model's with a capacity that drops
    nothing). Returns the launches of the path's kernel (``counter``: its
    ops module, its count attribute, and the attribute of a count that must
    equal it, or None) during prefill and generation, the prefill's Aux,
    its tokens and its readings."""
    from repro_torch.data import synthetic
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    name = cfg.name
    ops_mod, attr, same = counter
    toks = synthetic.lm_tokens(gen, batch=LM_BATCH, seq=LM_SEQ - 1,
                               vocab=cfg.vocab)
    prompt = synthetic.lm_tokens(gen, batch=LM_BATCH, seq=GEN_PROMPT - 1,
                                 vocab=cfg.vocab)

    ops_mod.reset_counts()
    tf.forward(params, toks, cfg, logits_last_only=True)      # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, aux = tf.forward(params, toks, cfg, logits_last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    step_ms: list = []
    out = serve.prefill_then_decode(params, prompt, cfg,
                                    max_len=GEN_PROMPT + GEN_NEW,
                                    n_decode=GEN_NEW, step_ms=step_ms)
    torch.cuda.synchronize()
    launches = getattr(ops_mod, attr)
    launches_same = getattr(ops_mod, same) if same else launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check_logits(torch, name, logits, (LM_BATCH, 1, cfg.vocab_padded),
                 cfg.vocab)
    check_generation(torch, name, out, prompt, cfg.vocab)
    p50 = sorted(step_ms)[len(step_ms) // 2]
    print(f"  [{card}] {name} prefill {LM_BATCH} x {LM_SEQ} tokens: "
          f"{prefill_s * 1e3:.1f} ms, {LM_BATCH * LM_SEQ / prefill_s:.0f} "
          f"tokens/s; logits finite", flush=True)
    n_moe = sum(d.moe for d in cfg.plan())
    if n_moe:
        print(f"  [{card}] {name} prefill MoE ({n_moe} layers, "
              f"{cfg.moe_dispatch} dispatch, capacity factor "
              f"{cfg.capacity_factor}): dropped fraction "
              f"{float(aux.dropped):.5f}, load-balance loss "
              f"{float(aux.moe_loss):.5f} (means over the MoE layers)",
              flush=True)
    print(f"  [{card}] {name} generation B={LM_BATCH}, prompt {GEN_PROMPT}, "
          f"{GEN_NEW} greedy tokens: per-token latency p50 {p50:.3f} ms, "
          f"max {max(step_ms):.3f} ms; peak device memory {peak_gb:.2f} GB",
          flush=True)
    print(f"  {name} launches of {attr} during prefill + generation: "
          f"{launches}", flush=True)
    if launches <= 0:
        fail(f"kernel {attr} was not launched on the {name} path")
    if same:
        print(f"  {name} launches of {same}: {launches_same}", flush=True)
        if launches_same != launches:
            fail(f"{name}: {launches - launches_same} of {launches} "
                 f"{attr} did not take {same}")

    consistency(torch, params, check_cfg or cfg, gen, CONSISTENCY_T[name])
    return {"launches": launches, "aux": aux, "tokens": toks,
            "prefill_ms": prefill_s * 1e3, "p50_ms": p50, "peak_gb": peak_gb}


def init_lm(torch, card: str, cfg):
    """``cfg``'s random float32 parameters on the card (seed 0), with
    their count (the encoder's too) and init time printed; returns them
    and the generator, for the inputs."""
    from repro_torch.models import transformer as tf
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = tf.init_model(cfg, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    enc = (f" ({cfg.enc_layers} encoder layers)" if cfg.enc_dec else "")
    print(f"  [{card}] {cfg.name}: {cfg.n_layers} layers{enc}, d "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B float32 parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return params, gen


def check_logits(torch, name: str, logits, shape: tuple, vocab: int):
    finite = bool(torch.isfinite(logits[..., :vocab]).all())
    if tuple(logits.shape) != shape or not finite:
        fail(f"{name} logits {tuple(logits.shape)} (want {shape}), finite "
             f"{finite}")


def check_generation(torch, name: str, out, prompt, vocab: int):
    if out.shape != (LM_BATCH, GEN_PROMPT + GEN_NEW) \
            or not torch.equal(out[:, :GEN_PROMPT], prompt) \
            or int(out.min()) < 0 or int(out.max()) >= vocab:
        fail(f"{name} generation gave {tuple(out.shape)} tokens in "
             f"[{int(out.min())}, {int(out.max())}]")


def consistency(torch, params, cfg, gen, T: int, frames=None) -> float:
    """Forward vs ``decode_step`` logits at every one of T positions, B =
    2, float32 compute; an enc-dec model encodes ``frames`` (float32) and
    decodes over the cross K/V projected once."""
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as tf
    f32 = torch.float32
    toks = synthetic.lm_tokens(gen, batch=2, seq=T - 1, vocab=cfg.vocab)
    enc = None if frames is None else tf.encode(params, frames, cfg,
                                                compute_dtype=f32)
    full, aux = tf.forward(params, toks, cfg, enc_kv=enc, compute_dtype=f32)
    last, _ = tf.forward(params, toks, cfg, enc_kv=enc, compute_dtype=f32,
                         logits_last_only=True)
    state = tf.init_serve(cfg, 2, T, cache_dtype=f32)
    if enc is not None:
        state = state._replace(cross_kv=tf.precompute_cross_kv(
            params, enc, cfg, compute_dtype=f32))
    errs = []
    for t in range(T):
        lg, state = tf.decode_step(params, toks[:, t:t + 1], state, cfg,
                                   compute_dtype=f32)
        errs.append((lg[:, 0, :cfg.vocab] - full[:, t, :cfg.vocab]).abs()
                    .max())
    err = float(torch.stack(errs).max())
    err_last = max_err(last[:, 0, :cfg.vocab], full[:, -1, :cfg.vocab])
    scale = float(full[..., :cfg.vocab].abs().max())
    moe = (f"; capacity factor {cfg.capacity_factor}, dropped "
           f"{float(aux.dropped)}" if cfg.moe_experts else "")
    cross = "; over precomputed cross K/V" if enc is not None else ""
    print(f"  {cfg.name} float32 forward vs decode_step over {T} positions, "
          f"B=2: max|dlogit| {err:.3e} (tol {TOL_CONSISTENCY}; max|logit| "
          f"{scale:.3f}); logits_last_only vs full {err_last:.3e}{moe}"
          f"{cross}", flush=True)
    if not (err <= TOL_CONSISTENCY and err_last <= TOL_CONSISTENCY):
        fail(f"{cfg.name} forward and decode disagree: {err}, {err_last}")
    if cfg.moe_experts and float(aux.dropped) != 0:
        fail(f"{cfg.name}: the consistency check's forward dropped "
             f"{float(aux.dropped)}")
    return err


def moe_modes(torch, card: str, params, cfg, gen) -> None:
    """One MoE layer at the prefill's shape (LM_BATCH x LM_SEQ tokens of
    random normal input, bf16) in both dispatch modes, each call timed
    (host clock, synchronized): at a capacity that drops nothing they must
    agree (TOL_MOE_MODES); at MOE_TIGHT_CF they must drop as many pairs,
    not the same ones; at the config's capacity they are timed."""
    from repro_torch.models import moe
    p = params["layers"][0]["moe"]
    E, k = cfg.moe_experts, cfg.moe_top_k
    N = LM_BATCH * LM_SEQ
    x = torch.randn((LM_BATCH, LM_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    _, _, idx = moe.route(p, x.reshape(1, N, -1), k)
    most = int(torch.bincount(idx.flatten(), minlength=E).max())
    roomy = (most + 1) * E / (N * k)
    if moe.capacity(N, k, E, roomy) < most:
        fail(f"MoE check: capacity factor {roomy} leaves fewer than {most} "
             f"slots")
    runs = {}
    for cf in (cfg.capacity_factor, roomy, MOE_TIGHT_CF):
        for mode in moe.DISPATCH:
            moe.moe_ffn(p, x, top_k=k, capacity_factor=cf, dispatch=mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, aux = moe.moe_ffn(p, x, top_k=k, capacity_factor=cf,
                                 dispatch=mode)
            torch.cuda.synchronize()
            runs[cf, mode] = (y, float(aux.dropped_fraction),
                              (time.perf_counter() - t0) * 1e3)
    for cf in (cfg.capacity_factor, roomy, MOE_TIGHT_CF):
        (ye, de, te), (yg, dg, tg) = runs[cf, "einsum"], runs[cf, "gather"]
        print(f"  [{card}] one MoE layer at {LM_BATCH} x {LM_SEQ} tokens, "
              f"bf16, capacity factor {cf:.4f} (C = "
              f"{moe.capacity(N, k, E, cf)}; the busiest expert has {most} "
              f"pairs): einsum {te:.3f} ms, gather {tg:.3f} ms; dropped "
              f"{de:.5f} / {dg:.5f}; max|einsum - gather| "
              f"{max_err(ye, yg):.3e}, bitwise {bool(torch.equal(ye, yg))}",
              flush=True)
    (ye, de, _), (yg, dg, _) = runs[roomy, "einsum"], runs[roomy, "gather"]
    err, tol = max_err(ye, yg), TOL_MOE_MODES * float(ye.abs().max())
    (yt, dt, _), (ytg, dtg, _) = (runs[MOE_TIGHT_CF, "einsum"],
                                  runs[MOE_TIGHT_CF, "gather"])
    parted = max_err(yt, ytg)
    if not (de == dg == 0 and err <= tol):
        fail(f"MoE dispatch modes disagree with nothing dropped: dropped "
             f"{de} / {dg}, error {err} > {tol}")
    if not (dt == dtg > 0 and parted > tol):
        fail(f"MoE dispatch modes under capacity {MOE_TIGHT_CF}: dropped "
             f"{dt} / {dtg}, outputs apart by {parted} (the modes keep "
             f"other pairs)")


def moe_drops(torch, card: str, params, cfg, gen, toks, aux) -> None:
    """Where the prefill's drops come from. The prefill's forward (bf16,
    the config's capacity and dispatch) again on three token streams of
    LM_BATCH x LM_SEQ: the main path's Zipf stream ``toks`` (its Aux must
    equal the main path's ``aux``), uniform ids and distinct ids (no id
    repeats). Each MoE layer's input is routed once more beside the layer
    (``moe.route`` on the layer's router, as ``moe_ffn`` routes it) for its
    per-expert pair counts: the layer's dropped pairs must be the overflow
    those counts give at its C, sum_e max(0, count_e - C), plus at most its
    zero gates (einsum mode), or the dispatch dropped pairs that fit.
    Prints each layer's dropped fraction, its busiest expert's pairs and
    the share of its input's energy in the input's mean over all tokens
    and, averaged over the sequences, over each sequence's tokens (a
    direction the tokens share); and the first MoE layer's routing of the
    token embeddings alone (its own norm and router, no attention before
    it): the drops that the stream's id repeats cause by themselves."""
    from repro_torch.models import layers, moe
    from repro_torch.models import transformer as tf
    E, k = cfg.moe_experts, cfg.moe_top_k
    N = LM_BATCH * LM_SEQ
    C = moe.capacity(N, k, E, cfg.capacity_factor)
    shape = (LM_BATCH, LM_SEQ)
    first = params["layers"][[d.moe for d in cfg.plan()].index(True)]
    _, norm = layers.make_norm(cfg)

    def share(xf):                    # (..., tokens, d) float32
        return (xf.mean(-2).pow(2).sum(-1)
                / xf.pow(2).sum(-1).mean(-1)).mean()

    def overflow(counts):
        return int((counts - C).clamp(min=0).sum())

    streams = {
        "Zipf (the main path's)": toks,
        "uniform": torch.randint(0, cfg.vocab, shape, generator=gen,
                                 device="cuda"),
        "distinct": torch.randperm(cfg.vocab, generator=gen,
                                   device="cuda")[:N].reshape(shape)}
    plain, rows = moe.moe_ffn, []

    def recorded(p, x, **kw):
        y, a = plain(p, x, **kw)
        _, gates, idx = moe.route(p, x.reshape(1, N, -1), k)
        counts = torch.bincount(idx.flatten(), minlength=E)
        xf = x.reshape(LM_BATCH, LM_SEQ, -1).to(torch.float32)
        rows.append(dict(
            dropped=round(float(a.dropped_fraction) * N * k),
            overflow=overflow(counts), zero=int((gates == 0).sum()),
            busiest=int(counts.max()), shared=float(share(xf.reshape(N, -1))),
            shared_seq=float(share(xf))))
        return y, a

    moe.moe_ffn = recorded
    try:
        for name, t in streams.items():
            rows.clear()
            _, a = tf.forward(params, t, cfg, logits_last_only=True)
            ids = torch.bincount(t.flatten())
            emb = norm(layers.embed(params["embed"], t).to(torch.bfloat16),
                       first["ln2"])
            _, _, idx = moe.route(first["moe"], emb.reshape(1, N, -1), k)
            counts = torch.bincount(idx.flatten(), minlength=E)
            print(f"  [{card}] {cfg.name} prefill MoE drops, {name} stream "
                  f"({int((ids > 0).sum())} distinct ids, the commonest "
                  f"{float(ids.max()) / N:.4f} of the tokens), C = {C}: "
                  f"mean dropped {float(a.dropped):.5f}, load-balance loss "
                  f"{float(a.moe_loss):.5f}; the first MoE layer routing "
                  f"the embeddings alone: dropped "
                  f"{overflow(counts) / (N * k):.5f}, busiest expert "
                  f"{int(counts.max())} pairs", flush=True)
            for i, r in enumerate(rows):
                print(f"    MoE layer {i}: dropped {r['dropped'] / (N * k):.5f}"
                      f" ({r['dropped']} pairs; overflow of the counts "
                      f"{r['overflow']}, zero gates {r['zero']}), busiest "
                      f"expert {r['busiest']} pairs, shared-direction share "
                      f"{r['shared']:.4f} of all tokens, "
                      f"{r['shared_seq']:.4f} within a sequence", flush=True)
                if not r["overflow"] <= r["dropped"] <= (r["overflow"]
                                                         + r["zero"]):
                    fail(f"{cfg.name} MoE layer {i} ({name} stream) dropped "
                         f"{r['dropped']} pairs; its counts overflow "
                         f"{r['overflow']} slots, zero gates {r['zero']}")
            if t is toks and not (torch.equal(a.dropped, aux.dropped) and
                                  torch.equal(a.moe_loss, aux.moe_loss)):
                fail(f"{cfg.name}: the drop reading's forward on the main "
                     f"path's tokens gave {a}, the main path {aux}")
    finally:
        moe.moe_ffn = plain


def encdec_path(torch, card: str, ops) -> dict:
    """whisper-medium whole: ``encode`` of LM_BATCH x 1500 frames,
    ``precompute_cross_kv``, a decoder prefill ``forward(enc_kv=...)`` at
    T = max_seq, greedy generation over the cross K/V, then the float32
    forward-vs-decode check; every attention launches the flash kernel
    (bf16: flash_sm90), the encoder's and the cross-attention's without
    the causal mask, counted apart."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    cfg = get_config("whisper-medium")
    params, gen = init_lm(torch, card, cfg)
    frames = torch.randn((LM_BATCH, cfg.enc_seq, cfg.d_model), generator=gen,
                         device="cuda")
    toks = synthetic.lm_tokens(gen, batch=LM_BATCH, seq=cfg.max_seq - 1,
                               vocab=cfg.vocab)
    prompt = synthetic.lm_tokens(gen, batch=LM_BATCH, seq=GEN_PROMPT - 1,
                                 vocab=cfg.vocab)
    enc = tf.encode(params, frames, cfg)                       # warm-up
    tf.forward(params, toks, cfg, enc_kv=enc, logits_last_only=True)
    torch.cuda.synchronize()

    ops.reset_counts()
    times = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[key] = (time.perf_counter() - t0) * 1e3
        return out

    enc = timed("encode", lambda: tf.encode(params, frames, cfg))
    timed("cross_kv", lambda: tf.precompute_cross_kv(params, enc, cfg))
    logits, _ = timed("prefill", lambda: tf.forward(
        params, toks, cfg, enc_kv=enc, logits_last_only=True))
    step_ms: list = []
    out = serve.prefill_then_decode(params, prompt, cfg,
                                    max_len=GEN_PROMPT + GEN_NEW,
                                    n_decode=GEN_NEW, step_ms=step_ms,
                                    enc_kv=enc)
    torch.cuda.synchronize()
    launches = {"flash": ops.flash_launches, "sm90": ops.flash_sm90_launches,
                "noncausal": ops.flash_noncausal_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_logits(torch, cfg.name, logits, (LM_BATCH, 1, cfg.vocab_padded),
                 cfg.vocab)
    check_generation(torch, cfg.name, out, prompt, cfg.vocab)
    steps = GEN_PROMPT + GEN_NEW
    want_nc = cfg.enc_layers + cfg.n_layers * (1 + steps)
    want = want_nc + cfg.n_layers * (1 + steps)
    p50 = sorted(step_ms)[len(step_ms) // 2]
    print(f"  [{card}] {cfg.name} encode {LM_BATCH} x {cfg.enc_seq} frames: "
          f"{times['encode']:.2f} ms; precompute_cross_kv "
          f"{times['cross_kv']:.2f} ms; decoder prefill {LM_BATCH} x "
          f"{cfg.max_seq} tokens over the encoder: {times['prefill']:.2f} ms",
          flush=True)
    print(f"  [{card}] {cfg.name} generation B={LM_BATCH}, prompt "
          f"{GEN_PROMPT}, {GEN_NEW} greedy tokens over precomputed cross "
          f"K/V: per-token latency p50 {p50:.3f} ms, max {max(step_ms):.3f} "
          f"ms; peak device memory {peak_gb:.2f} GB", flush=True)
    print(f"  {cfg.name} flash launches: {launches['flash']} ({want} "
          f"expected), {launches['sm90']} flash_sm90, "
          f"{launches['noncausal']} non-causal ({want_nc} expected: "
          f"{cfg.enc_layers} encoder, {cfg.n_layers} x {1 + steps} cross)",
          flush=True)
    if not (launches["flash"] == launches["sm90"] == want
            and launches["noncausal"] == want_nc):
        fail(f"{cfg.name}: flash launches {launches}, expected {want} "
             f"({want_nc} non-causal), all flash_sm90")
    frames2 = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=gen,
                          device="cuda")
    consistency(torch, params, cfg, gen, CONSISTENCY_T[cfg.name],
                frames=frames2)
    del params, enc, frames, frames2
    torch.cuda.empty_cache()
    return {"launches": launches, "times_ms": times, "p50_ms": p50,
            "peak_gb": peak_gb}


def mrope_positions(torch, batch: int, n_text: int, grid: tuple,
                    n_after: int):
    """Qwen2-VL's (t, h, w) position rows: ``n_text`` text tokens, a
    t x h x w block of patches offset by the text before it, then text
    positions from one past the block's largest; (batch, 3, T) on the
    card."""
    t, h, w = grid
    text = torch.arange(n_text).expand(3, n_text)
    tt, hh, ww = torch.meshgrid(torch.arange(t), torch.arange(h),
                                torch.arange(w), indexing="ij")
    vis = torch.stack([tt.flatten(), hh.flatten(), ww.flatten()]) + n_text
    start = int(vis.max()) + 1
    after = torch.arange(start, start + n_after).expand(3, n_after)
    pos = torch.cat([text, vis, after], dim=1)
    return pos.expand(batch, 3, pos.shape[1]).contiguous().to("cuda")


def vlm_path(torch, card: str, ops) -> dict:
    """qwen2-vl-72b at full width, VLM_LAYERS of its layers: a prefill of
    LM_BATCH x LM_SEQ through ``forward(inputs_embeds=..., positions=(B,
    3, T))``, text embeddings around a block of random patch embeddings at
    M-RoPE grid positions; then, in float32, ``forward(inputs_embeds=
    embed(tokens))`` with broadcast positions against ``forward(tokens)``,
    bit for bit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    full = get_config("qwen2-vl-72b")
    print(f"  reduced: n_layers {full.n_layers} -> {VLM_LAYERS} (float32 "
          f"weights; all {full.n_layers} take "
          f"{4 * full.param_counts()['total'] / 1e9:.0f} GB)", flush=True)
    cfg = full.scaled(n_layers=VLM_LAYERS)
    params, gen = init_lm(torch, card, cfg)
    n_text, grid = VLM_TEXT, VLM_GRID
    n_vis = grid[0] * grid[1] * grid[2]
    pos = mrope_positions(torch, LM_BATCH, n_text, grid,
                          LM_SEQ - n_text - n_vis)
    toks = synthetic.lm_tokens(gen, batch=LM_BATCH, seq=LM_SEQ - 1,
                               vocab=cfg.vocab)
    embeds = layers.embed(params["embed"], toks)
    embeds[:, n_text:n_text + n_vis] = torch.randn(
        (LM_BATCH, n_vis, cfg.d_model), generator=gen, device="cuda") * 0.02
    distinct = bool((pos[:, 0] != pos[:, 1]).any()
                    and (pos[:, 1] != pos[:, 2]).any())
    if not distinct:
        fail("the M-RoPE position rows are not distinct")

    ops.reset_counts()
    tf.forward(params, None, cfg, inputs_embeds=embeds, positions=pos,
               logits_last_only=True)                          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = tf.forward(params, None, cfg, inputs_embeds=embeds,
                           positions=pos, logits_last_only=True)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.flash_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_logits(torch, cfg.name, logits, (LM_BATCH, 1, cfg.vocab_padded),
                 cfg.vocab)
    print(f"  [{card}] {cfg.name} prefill {LM_BATCH} x {LM_SEQ} from "
          f"inputs_embeds ({n_text} text, {grid[0]}x{grid[1]}x{grid[2]} "
          f"patches, {LM_SEQ - n_text - n_vis} text), (B, 3, T) positions: "
          f"{prefill_ms:.1f} ms, {LM_BATCH * LM_SEQ / prefill_ms * 1e3:.0f} "
          f"tokens/s; logits finite; flash launches {launches} "
          f"({ops.flash_sm90_launches} flash_sm90); peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    if not (launches == ops.flash_sm90_launches == 2 * cfg.n_layers):
        fail(f"{cfg.name}: {launches} flash launches "
             f"({ops.flash_sm90_launches} sm90), expected "
             f"{2 * cfg.n_layers}")

    f32 = torch.float32
    T = CONSISTENCY_T["qwen3-1.7b"]
    toks2 = synthetic.lm_tokens(gen, batch=2, seq=T - 1, vocab=cfg.vocab)
    pos3 = torch.arange(T, device="cuda").expand(2, 3, T)
    a, _ = tf.forward(params, None, cfg, compute_dtype=f32, positions=pos3,
                      inputs_embeds=layers.embed(params["embed"], toks2))
    b, _ = tf.forward(params, toks2, cfg, compute_dtype=f32)
    same = bool(torch.equal(a, b))
    print(f"  {cfg.name} float32 forward(inputs_embeds=embed(tokens), "
          f"(B, 3, T) broadcast positions) vs forward(tokens), B=2, T={T}: "
          f"bitwise {same}, max|d| {max_err(a, b):.3e}", flush=True)
    if not same:
        fail(f"{cfg.name}: inputs_embeds of the tokens changed the logits")
    del params, embeds, a, b
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_ms": prefill_ms,
            "peak_gb": peak_gb}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _named_leaves(tree, prefix: str = ""):
    """(path, tensor) of each leaf, in ``_leaves``' order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def main_path(torch, card: str):
    """Fit pPITC at the paper's AIMPEAK configuration and serve through the
    plan API; returns the kernels' launch counts during the run, the
    timings, the data and the fitted state (phase 4d's yardstick)."""
    from repro_torch.core import api, covariance as cov, support
    from repro_torch.data import synthetic
    from repro_torch.kernels.rbf import ops
    from repro_torch.parallel.runner import VmapRunner

    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    ds = synthetic.standardize(
        synthetic.aimpeak_like(n=N_TRAIN, n_test=N_TEST, seed=0))
    spec = cov.make_spec("se")
    params = cov.init_params(D, signal=1.0, noise=0.3, lengthscale=1.2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    S = support.select_support(spec, params, ds.X[:ICF_CANDIDATES],
                               S_SIZE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model = api.fit("ppitc", spec, params, ds.X, ds.y, S=S,
                    runner=VmapRunner(M=M))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    plan = model.plan(api.ServeSpec(max_batch=256)).warmup(D)
    t4 = time.perf_counter()
    builds = ops.inverse_builds
    outs, lat_ms, off = [], [], 0
    for size in REQUEST_SIZES:
        idx = torch.arange(off, off + size, device="cuda") % N_TEST
        U = ds.X_test.index_select(0, idx)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        mean, var = plan.diag(U)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - ts) * 1e3)
        outs.append((idx, mean, var))
        off = (off + size) % N_TEST
    block, icf_n = ops.rbf_launches, ops.icf_launches
    launches = {"rbf": block + icf_n, "xcov_diag": ops.xcov_launches}
    tc, req_builds = ops.xcov_tc_launches, ops.inverse_builds - builds
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"  counts during the main path: {launches} (rbf: {block} block "
          f"launches, {icf_n} of the ICF kernel); xcov_diag on the tensor "
          f"cores: {tc}; inverses built: {builds} before the requests, "
          f"{req_builds} during them", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if icf_n != 1 or block <= 0:
        fail(f"select_support took {icf_n} ICF launches (want 1) and the "
             f"fit {block} rbf block launches")
    if tc != launches["xcov_diag"]:
        fail(f"{launches['xcov_diag'] - tc} xcov_diag launches did not "
             f"take the tensor-core instance")
    if req_builds:
        fail(f"the requests built {req_builds} triangular inverses")
    for idx, mean, var in outs:
        if mean.shape != idx.shape or var.shape != idx.shape:
            fail(f"plan.diag shapes {tuple(mean.shape)}/{tuple(var.shape)} "
                 f"for {idx.numel()} queries")
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all()):
            fail(f"non-finite plan.diag output at batch {idx.numel()}")
    idx_all, mean_all, var_all = outs[-1]     # the 3200-row request
    y_all = ds.y_test.index_select(0, idx_all)
    rmse = float(torch.sqrt(torch.mean((mean_all - y_all) ** 2)))
    neg = float((var_all < 0).double().mean())

    # fused (kernel) vs compose (plain solves) on the same state, with a
    # float64 evaluation of the same state as the yardstick
    U = ds.X_test[:1024]
    compose = model.plan(api.ServeSpec(kernel=cov.make_spec("se",
                                                            fused=False)))
    m_f, v_f = plan.diag(U)
    m_c, v_c = compose.diag(U)
    p64 = {k: v.double() for k, v in model.params.items()}
    st64 = api.PITCState(*(t.double() for t in model.state))
    truth = model.method.plan(cov.make_spec("se", impl="torch"), p64, st64)
    m_t, v_t = truth.diag(U.double())
    torch.cuda.synchronize()
    d_mean, d_var = max_err(m_f, m_c), max_err(v_f, v_c)
    e_f = max(max_err(m_f, m_t), max_err(v_f, v_t))
    e_c = max(max_err(m_c, m_t), max_err(v_c, v_t))
    # Both paths evaluate the same state in float32: they cannot agree more
    # closely than the compose path's own error against float64, and a
    # kernel defect (a panel, mask or term wrong) errs by O(sig2) = O(1).
    agree_tol = 10 * e_c + 1e-4
    print(f"  fused vs compose (1024 queries): max|dmean| {d_mean:.3e}, "
          f"max|dvar| {d_var:.3e} (tol {agree_tol:.3e} = 10 x compose's "
          f"error vs f64 + 1e-4); vs f64: fused {e_f:.3e}, compose "
          f"{e_c:.3e}", flush=True)
    if not max(d_mean, d_var) <= agree_tol:
        fail(f"fused plan.diag disagrees with the compose path: "
             f"{max(d_mean, d_var)} > {agree_tol}")

    # why the fit factors Sdd from its square root (online._sdd_chol): its
    # conditioning, and the reference's way (form Sdd, then Cholesky) in f32
    L = model.state.Sdd_L
    ev = torch.linalg.eigvalsh(L.double() @ L.double().T)
    info = int(torch.linalg.cholesky_ex(L @ L.T)[1])
    verdict = f"fails (info {info})" if info else "succeeds"
    print(f"  Sdd + jitter (float64, from the fitted factor): eigenvalues "
          f"{float(ev.min()):.3e} .. {float(ev.max()):.3e}, cond "
          f"{float(ev.max() / ev.min()):.3e}; formed in float32, its "
          f"Cholesky {verdict}", flush=True)

    p50 = sorted(lat_ms)[len(lat_ms) // 2]
    print(f"  [{card}] data {t1 - t0:.3f} s, select_support {t2 - t1:.3f} "
          f"s, fit {t3 - t2:.3f} s, plan+warmup {t4 - t3:.3f} s, peak "
          f"{peak_gb:.2f} GB", flush=True)
    print(f"  [{card}] requests {list(REQUEST_SIZES)}: latency ms "
          f"{[round(x, 3) for x in lat_ms]}, p50 {p50:.3f} ms", flush=True)
    print(f"  [{card}] test RMSE {rmse:.4f} (standardized; "
          f"{rmse * float(ds.std_y):.3f} km/h), negative-variance share "
          f"{neg:.4f} of {N_TEST}", flush=True)
    if not (abs(rmse - RMSE_AIMPEAK) <= TOL_RMSE and neg == 0.0):
        fail(f"test RMSE {rmse} (want {RMSE_AIMPEAK} +- {TOL_RMSE}), "
             f"negative-variance share {neg} (want 0)")
    data = {"ds": ds, "spec": spec, "params": params, "S": S}
    return launches, {"block_launches": block, "icf_launches": icf_n,
                      "select_support_s": t2 - t1}, data, model.state


# pPIC routed serving (phase 4b). Tolerances:
#  the permuted request must be bitwise equal (same shapes, same programs);
#  skewed traffic against the capacity-|U| layout: bitwise (torch.equal,
#  mean and var) at SKEW_TARGETS blocks' centroids, each with overflow
#  groups. Every stage of the per-block program runs through the row
#  products (row_products.cu), whose arithmetic for a row does not depend
#  on the batch, so the layouts are the same bits, as in the CPU tests;
#  cached C^-1 against the default path (C_L^-1 twice): the reference's
#  1e-3 (tests/test_plan.py), a different float path of the same math;
#  f32 against an f64 fit of the same data: <= 10 x pPITC's own f32-vs-f64
#  error on the same queries + 1e-4, the shape of phase 4's limit;
#  degraded rows against global_diag: 1e-6 (1 + |value|) (same call).
PPIC_F64_QUERIES = 1024
SKEW_ROWS, SKEW_SCALE = 256, 0.01
SKEW_TARGETS = (0, 5, 10, 15)
RECHUNK = (7, 64)            # the 256-row request served in chunks of these


def max_rel(a, b) -> float:
    return float(((a.double() - b.double()).abs()
                  / (1.0 + b.double().abs())).max())


def layout_stages(torch, plan, state, U, layout: str) -> list:
    """The per-block program of a routed request (``ppic._diag_stages``),
    stage by stage, in the two-bucket layout the plan serves
    (``layout="two"``, its host assignment and group count; the groups in
    one batch with the main bucket, as the program runs them) or in the
    capacity-|U| layout (``"capacity"``), each stage's rows gathered back
    to the caller's order: ``ppic.DIAG_STAGES``."""
    from repro_torch.core import ppic
    from repro_torch.parallel import runner as rn
    M = state.Xb.shape[0]
    assign, g = plan._route(U.cpu().numpy(), U.shape[0])
    assign = torch.as_tensor(assign).to(U.device)

    def stages(Ub, blk=None):
        return ppic._diag_stages(plan.kfn, plan.params, state, Ub,
                                 plan.caches, blk)

    if layout == "capacity":
        Ub, order, block_of, slot = rn.scatter_by_block(U, assign, M)
        return [rn.gather_by_block(t, order, block_of, slot)
                for t in stages(Ub)]
    lay = rn.scatter_two_bucket(U, assign, M, alpha=plan.spec.alpha,
                                tile=plan.block_q, max_groups=g)
    if lay.Xo is None:
        return [rn.gather_two_bucket(t, None, lay) for t in stages(lay.Xb)]
    blk = torch.cat([torch.arange(M, device=U.device), lay.o_blk])
    return [rn.gather_two_bucket(t[:M], t[M:], lay)
            for t in stages(torch.cat([lay.Xb, lay.Xo]), blk)]


def layout_divergence(torch, plan, state, U) -> str:
    """Where the two-bucket and capacity layouts part for request U: each
    stage's max |difference| / (1 + |value|) or "bitwise", and the first
    stage that is not bitwise (None where every stage is)."""
    from repro_torch.core import ppic
    two = layout_stages(torch, plan, state, U, "two")
    cap = layout_stages(torch, plan, state, U, "capacity")
    parts, first = [], None
    for name, a, b in zip(ppic.DIAG_STAGES, two, cap):
        same = bool(torch.equal(a, b))
        if not same and first is None:
            first = name
        parts.append(f"{name} {'bitwise' if same else f'{max_rel(a, b):.2e}'}")
    return f"first stage that differs: {first}; " + ", ".join(parts), first


def ppic_path(torch, card: str, ds, spec, params, S) -> dict:
    """Fit pPIC on the co-clustered AIMPEAK data (phase 4's support set and
    hyperparameters) and serve it routed through the plan API; returns the
    kernels' launch counts during the fit and requests, and the
    co-clustered data with the fit's output on the float64 check's queries
    (phase 4d's yardstick)."""
    import numpy as np
    from repro_torch.core import api, clustering, covariance as cov, linalg, \
        ppic
    from repro_torch.kernels.linalg import ops as lops
    from repro_torch.kernels.rbf import ops
    from repro_torch.parallel.runner import VmapRunner

    dev = ds.X.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    lops.reset_counts()
    t0 = time.perf_counter()
    Xc, yc, _, _, _ = clustering.cocluster(
        ds.X.cpu().numpy(), ds.y.cpu().numpy(), ds.X_test.cpu().numpy(), M,
        np.random.default_rng(0))
    Xc, yc = torch.as_tensor(Xc).to(dev), torch.as_tensor(yc).to(dev)
    t1 = time.perf_counter()
    model = api.fit("ppic", spec, params, Xc, yc, S=S,
                    runner=VmapRunner(M=M))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    t_fit = t2 - t1
    # B and beta are fields of the reference's state that the port's
    # serving does not read: their share of the fit, as the fit solves them
    st = model.state
    t_bb = time.perf_counter()
    linalg.chol_solve(st.Kss_L, st.Sdot)
    linalg.chol_solve(st.Kss_L, st.ydot[..., None])
    torch.cuda.synchronize()
    t_bb = time.perf_counter() - t_bb
    del st
    t2 = time.perf_counter()
    plan = model.plan(api.ServeSpec(routed=True, max_batch=256))
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t2
    plan.warmup(D)
    t3 = time.perf_counter()
    outs, lat_ms, gs, per_req, off = [], [], [], [], 0
    for size in REQUEST_SIZES:
        idx = torch.arange(off, off + size, device=dev) % N_TEST
        U = ds.X_test.index_select(0, idx)
        n0 = (lops.rows_mm_launches, lops.rows_reduce_launches)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        mean, var = plan.routed_diag(U)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - ts) * 1e3)
        per_req.append((lops.rows_mm_launches - n0[0],
                        lops.rows_reduce_launches - n0[1]))
        gs.append(plan.stats.last_g)
        outs.append((idx, mean, var))
        off = (off + size) % N_TEST
    launches = {"rbf": ops.rbf_launches + ops.icf_launches,
                "xcov_diag": ops.xcov_launches,
                "rows_mm": lops.rows_mm_launches,
                "rows_reduce": lops.rows_reduce_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  counts during the fit and requests: {launches} (xcov_diag: "
          f"the degraded programs' warm-up; rows_mm, rows_reduce a request: "
          f"{per_req})", flush=True)
    if launches["rbf"] <= 0:
        fail("kernel rbf was not launched on the pPIC path")
    if not all(a > 0 and b > 0 for a, b in per_req):
        fail(f"a routed request launched no rows_mm or rows_reduce: "
             f"{per_req}")
    for idx, mean, var in outs:
        if mean.shape != idx.shape or var.shape != idx.shape:
            fail(f"routed_diag shapes {tuple(mean.shape)}/"
                 f"{tuple(var.shape)} for {idx.numel()} queries")
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all()):
            fail(f"non-finite routed_diag output at batch {idx.numel()}")
    idx_all, mean_all, var_all = outs[-1]     # the 3200-row request
    y_all = ds.y_test.index_select(0, idx_all)
    rmse = float(torch.sqrt(torch.mean((mean_all - y_all) ** 2)))
    neg = float((var_all < 0).double().mean())
    p50 = sorted(lat_ms)[len(lat_ms) // 2]
    print(f"  [{card}] cocluster {t1 - t0:.3f} s, fit {t_fit:.3f} s (of "
          f"which the B and beta solves, timed alone: {t_bb:.4f} s), plan "
          f"(Q = L^-1 K_SD) {t_plan:.4f} s, warmup {t3 - t2 - t_plan:.3f} s "
          f"({plan.stats.n_traces} programs), peak {peak_gb:.2f} GB",
          flush=True)
    print(f"  [{card}] requests {list(REQUEST_SIZES)}: latency ms "
          f"{[round(x, 3) for x in lat_ms]}, p50 {p50:.3f} ms, last_g "
          f"{gs}", flush=True)
    print(f"  [{card}] test RMSE {rmse:.4f} (standardized; "
          f"{rmse * float(ds.std_y):.3f} km/h), negative-variance share "
          f"{neg:.4f} of {N_TEST}", flush=True)
    if not (rmse <= RMSE_AIMPEAK + TOL_RMSE and neg == 0.0):
        fail(f"pPIC test RMSE {rmse} (want <= {RMSE_AIMPEAK + TOL_RMSE}), "
             f"negative-variance share {neg} (want 0)")

    # float32 against a float64 fit of the same data (plain kernels: the
    # rbf kernel accumulates in float32 whatever its input type)
    spec64 = cov.make_spec("se", impl="torch")
    p64 = {k: v.double() for k, v in params.items()}
    t4 = time.perf_counter()
    model64 = api.fit("ppic", spec64, p64, Xc.double(), yc.double(),
                      S=S.double(), runner=VmapRunner(M=M))
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    U = ds.X_test[:PPIC_F64_QUERIES]
    m32, v32 = plan.routed_diag(U)
    m64, v64 = model64.plan(api.ServeSpec(routed=True, max_batch=256)) \
        .routed_diag(U.double())
    g32 = ppic.global_diag(plan.kfn, params, model.state, U)
    g64 = ppic.global_diag(spec64, p64, model64.state, U.double())
    e_pic = max(max_err(m32, m64), max_err(v32, v64))
    e_pitc = max(max_err(g32[0], g64[0]), max_err(g32[1], g64[1]))
    fields = {f: max_err(getattr(model.state, f),
                         getattr(model64.state, f))
              / float(getattr(model64.state, f).abs().max())
              for f in ("Sdd_L", "alpha", "C_L", "Wy", "beta", "B")}
    lim = 10 * e_pitc + 1e-4
    print(f"  f32 vs f64 fit ({t5 - t4:.3f} s), {PPIC_F64_QUERIES} routed "
          f"queries: pPIC {e_pic:.3e}, pPITC (global_diag) {e_pitc:.3e}; "
          f"limit {lim:.3e} = 10 x pPITC + 1e-4; state fields' max error "
          f"over max |f64|: "
          f"{ {k: float(f'{v:.2e}') for k, v in fields.items()} }",
          flush=True)
    cold = {"Xc": Xc, "yc": yc, "m": m32, "v": v32, "state": model.state}
    del model64, m64, v64, g64
    torch.cuda.empty_cache()
    if not e_pic <= lim:
        fail(f"pPIC f32 error against the f64 fit {e_pic} > {lim}")

    # invariants on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    U = ds.X_test[:256]
    m, v = plan.routed_diag(U)
    perm = torch.randperm(256, device=dev, generator=gen)
    mp, vp = plan.routed_diag(U[perm])
    bitwise = bool(torch.equal(mp, m[perm]) and torch.equal(vp, v[perm]))
    print(f"  permuted 256-row request bitwise equal: {bitwise}", flush=True)
    if not bitwise:
        fail("a permuted request is not bitwise equal row by row")
    for c in RECHUNK:
        parts = [plan.routed_diag(U[i:i + c]) for i in range(0, 256, c)]
        mc, vc = (torch.cat([p[j] for p in parts]) for j in (0, 1))
        same = bool(torch.equal(mc, m) and torch.equal(vc, v))
        print(f"  the 256-row request served in chunks of {c}: bitwise the "
              f"whole request {same}"
              + ("" if same else f", max {max(max_rel(mc, m), max_rel(vc, v)):.3e} "
                 f"of 1 + |value|"), flush=True)
        if not same:
            fail(f"the 256-row request served in chunks of {c} is not "
                 f"bitwise the whole request")

    st64 = api.PICState(*(t.double() for t in model.state))
    skew = []
    for blk in SKEW_TARGETS:
        c = model.state.centroids[blk]
        Us = c[None, :] + SKEW_SCALE * torch.randn(SKEW_ROWS, D, device=dev,
                                                   generator=gen)
        ms, vs = plan.routed_diag(Us)
        g_skew = plan.stats.last_g
        mc, vc = ppic.predict_routed_diag_capacity(plan.kfn, params,
                                                   model.state, Us)
        mt, vt = ppic.predict_routed_diag_capacity(spec64, p64, st64,
                                                   Us.double())
        same = bool(torch.equal(ms, mc) and torch.equal(vs, vc))
        e_skew = max(max_rel(ms, mc), max_rel(vs, vc))
        e_cap = max(max_rel(mc, mt), max_rel(vc, vt))
        e_two = max(max_rel(ms, mt), max_rel(vs, vt))
        skew.append((g_skew, same, e_skew))
        print(f"  skewed request ({SKEW_ROWS} rows around block {blk}'s "
              f"centroid): g {g_skew}, against the capacity layout bitwise "
              f"{same} (max {e_skew:.3e} of 1 + |value|); each layout "
              f"against an f64 evaluation of the state: capacity "
              f"{e_cap:.3e}, two-bucket {e_two:.3e}", flush=True)
        if blk == SKEW_TARGETS[0]:
            line, first = layout_divergence(torch, plan, model.state, Us)
            print(f"  the layouts' per-block program, stage by stage: {line}",
                  flush=True)
            if first is not None:
                fail(f"the layouts part at stage {first}")
    del st64
    if not all(g > 0 and same for g, same, _ in skew):
        fail(f"skewed requests (g, bitwise, error): {skew}")

    t6 = time.perf_counter()
    cplan = model.plan(api.ServeSpec(routed=True, max_batch=256,
                                     cached_cinv=True))
    torch.cuda.synchronize()
    t7 = time.perf_counter()
    mi, vi = cplan.routed_diag(U)
    e_cinv = max(max_err(mi, m), max_err(vi, v))
    print(f"  cached C^-1 (built in {t7 - t6:.3f} s) against the default "
          f"path (C_L^-1 twice): {e_cinv:.3e} (limit 1e-3)", flush=True)
    if not e_cinv <= 1e-3:
        fail(f"cached C^-1 disagrees with the default path: {e_cinv}")

    dead_blk = int(np.bincount(clustering.nearest_center_np(
        U.cpu().numpy(), plan._centroids_host), minlength=M).argmax())
    alive = np.ones(M, bool)
    alive[dead_blk] = False
    x0, n0 = ops.xcov_launches, plan.stats.n_degraded_rows
    md, vd = plan.routed_diag(U, block_alive=alive)
    torch.cuda.synchronize()
    deg = torch.as_tensor(plan.stats.last_degraded, device=dev)
    n_deg, x_deg = plan.stats.n_degraded_rows - n0, ops.xcov_launches - x0
    mg, vg = ppic.global_diag(plan.kfn, params, model.state, U)
    e_deg = max(max_rel(md[deg], mg[deg]), max_rel(vd[deg], vg[deg]))
    same = bool(torch.equal(md[~deg], m[~deg])
                and torch.equal(vd[~deg], v[~deg]))
    print(f"  block {dead_blk} dead: {n_deg} degraded rows (stats), "
          f"{int(deg.sum())} in the mask; xcov_diag launches {x_deg}; "
          f"against global_diag {e_deg:.3e} (limit 1e-6), bitwise "
          f"{bool(torch.equal(md[deg], mg[deg]))}; other rows unchanged "
          f"{same}", flush=True)
    if not (n_deg == int(deg.sum()) > 0 and x_deg >= 1 and e_deg <= 1e-6
            and same and torch.isfinite(md).all()):
        fail("bounded degradation: degraded rows, xcov_diag launch or "
             "agreement with global_diag wrong")

    # where a request's time goes: one 256-row routed request, traced; the
    # per-block program takes no triangular solve of the library
    from repro_torch.launch.profile import report
    tr = report("  one 256-row routed request", lambda: plan.routed_diag(U))
    named = {k: sum(n for name, (n, _) in tr["by_name"].items() if k in name)
             for k in ("rows_mm", "rows_reduce", "trsm")}
    print(f"  [{card}] traced 256-row routed request: {tr['n_kernels']} "
          f"kernels (PR 19: 467), device busy "
          f"{100 * tr['busy_ms'] / tr['wall_ms']:.1f}% of {tr['wall_ms']:.3f} "
          f"ms (PR 19: 25-37%); rows_mm {named['rows_mm']}, rows_reduce "
          f"{named['rows_reduce']}, trsm {named['trsm']}", flush=True)
    if named["trsm"] or not (named["rows_mm"] and named["rows_reduce"]):
        fail(f"the traced routed request's kernels: {named}")
    print(f"  [{card}] phase peak device memory (the f64 fit included) "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return launches, cold


# pICF and MLE (phase 4c), on phase 4's data and hyperparameters. R = |S|:
# AIMPEAK's rank_multiplier is 1 (configs/gp_experiments.py).
PICF_RANK = S_SIZE
#  float32 against the float64 fit of the same data: RMSE within 10% of the
#  float64 fit's, negative-variance shares within 0.05 (the method's own
#  instability sets both shares; on the CPU probes of (n, R) = (4000, 1024)
#  and (8000, 1024) the two dtypes were 0.6% / 0.002 and 3.7% / 0.017
#  apart, and pivots chosen differently at near ties add some).
PICF_RMSE_REL, PICF_NEG_SHARE = 0.10, 0.05
MLE_SUBSET = 10000           # the paper's MLE subset (mle_subset)
MLE_STEPS, MLE_PARALLEL_STEPS = 10, 3
F32_EPS = 2.0 ** -24         # unit roundoff of float32


def check_icf_picf(torch, ops, ref, ds, params) -> dict:
    """The ICF kernel at pICF's instance, (|D|, R, d) = (32000, 2048, 5),
    the AIMPEAK training inputs: float64 against the plain loop (pivots
    identical; F, residual and pivot values within icf_tolerance) and
    float32 (the plain loop replayed along the kernel's pivots finds each
    within TOL_ICF_TIE of its largest residual; F within TOL_ICF_F32, the
    pivot values within TOL_ICF_F32 sig2). Timed in both dtypes beside the
    operations bound and the modelled streaming time from its plan."""
    from repro_torch.core import covariance as cov
    n, R = N_TRAIN, PICF_RANK
    s2 = cov.signal_var(params)
    sig2 = float(s2)
    out = {}
    for dt in (torch.float64, torch.float32):
        Xs = cov._scale(params, ds.X).to(dt)
        s2d = s2.to(dt)
        plan = ops.icf_plan(dt, n, R, D)
        n0 = ops.icf_launches
        runs = [ops.icf_factor(Xs, s2d, R, pivot_values=True)
                for _ in range(2)]
        torch.cuda.synchronize()
        if ops.icf_launches - n0 != 2 or not _same_runs(torch, runs):
            fail(f"ICF at pICF's instance {dt}: launches "
                 f"{ops.icf_launches - n0} for 2 calls, or they disagree")
        F, piv, res, dp = runs[0]
        key = str(dt).split(".")[1]
        if dt == torch.float64:
            Fw, pw, rw, dw = ref.icf_factor(Xs, s2d, R, pivot_values=True)
            same = bool(torch.equal(piv, pw))
            tol_f, tol_r, min_dp = icf_tolerance(Fw, pw, sig2)
            errs = (max_err(F, Fw), max_err(res, rw), max_err(dp, dw))
            ok = same and errs[0] <= tol_f and max(errs[1:]) <= tol_r
            print(f"  ICF ({n}, {R}, {D}) {key} x2: pivots identical "
                  f"{same}; min d_p {min_dp:.3e}; max|dF| {errs[0]:.3e} (tol "
                  f"{tol_f:.3e}), max|dresidual| {errs[1]:.3e}, max|dd_p| "
                  f"{errs[2]:.3e} (tol {tol_r:.3e})", flush=True)
            del Fw, rw
        else:
            Fr, _, _, dr = ref.icf_factor(Xs, s2d, R, piv,
                                          pivot_values=True)
            slack = float(ref.icf_slack(Fr, piv, s2d).max())
            _, pw, _ = ref.icf_factor(Xs, s2d, R)
            differ = (piv != pw).nonzero()
            prefix = int(differ[0]) if differ.numel() else R
            tol_f = TOL_ICF_F32 * sig2 ** 0.5
            errs = (max_err(F, Fr), max_err(dp, dr))
            ok = slack <= TOL_ICF_TIE * sig2 and errs[0] <= tol_f \
                and errs[1] <= TOL_ICF_F32 * sig2
            print(f"  ICF ({n}, {R}, {D}) {key} x2: bitwise equal; pivots "
                  f"agree with the plain loop for {prefix} of {R} steps; "
                  f"replayed along the kernel's pivots each within "
                  f"{slack:.3e} of the largest residual (tol "
                  f"{TOL_ICF_TIE * sig2:.1e}); max|dF| {errs[0]:.3e} (tol "
                  f"{tol_f:.1e}); max|dd_p| {errs[1]:.3e} (tol "
                  f"{TOL_ICF_F32 * sig2:.1e})", flush=True)
            out.update(picf_icf_prefix=prefix, picf_icf_slack=slack,
                       picf_icf_max_abs_err=errs[0])
            del Fr
        if not ok:
            fail(f"ICF at pICF's instance {key}: {errs}")
        del runs, F
        torch.cuda.empty_cache()
        ms = kernel_device_ms(torch, lambda: ops.icf_factor(Xs, s2d, R),
                              "icf_kernel", 3)
        isz = torch.finfo(dt).bits // 8
        flops = rk.icf_flops(n, R)
        # float64 on the tensor cores' FP64 rate, as its GEMVs could run
        peak = hw.PEAK_FLOPS_F32 if dt == torch.float32 \
            else hw.PEAK_FLOPS_F64_TENSOR
        b_ms, b_by = rk.bound_ms(rk.icf_bytes(n, R, D, isz), flops, peak)
        stream = rk.icf_stream_bytes(plan, n, R, isz)
        full = isz * n * R * (R - 1) // 2
        print(f"  ICF ({n}, {R}, {D}) {key} plan: {plan}; device {ms:.3f} "
              f"ms ({ms / R * 1e3:.2f} us a step); bound {b_ms:.3f} ms "
              f"({b_by}, {flops / 1e9:.1f} GFLOP); the GEMVs stream "
              f"{stream / 1e9:.1f} GB of {full / 1e9:.1f} GB from L2/HBM "
              f"({100 * (1 - stream / full):.1f}% on chip): "
              f"{stream / hw.HBM_BW * 1e3:.2f} ms at "
              f"{hw.HBM_BW / 1e12:.2f} TB/s (a model), read at "
              f"{stream / ms / 1e9:.2f} TB/s effective", flush=True)
        out.update({f"picf_icf_{key}_ms": ms, f"picf_icf_{key}_bound_ms":
                    b_ms, f"picf_icf_{key}_stream_ms":
                    stream / hw.HBM_BW * 1e3,
                    f"picf_icf_{key}_plan": plan})
        del Xs
    out["picf_icf_shape"] = f"({n}, {R}, {D}), AIMPEAK training inputs"
    return out


def picf_state_limits(torch, st_p, dF: float, y, s2: float) -> dict:
    """Limits for the kernel path's pICF state against the plain path's,
    from the measured factor difference dF = |F_k - F_p|_F (F itself is
    held to icf_tolerance). Phi = I + F Fᵀ / s2 moves by |dPhi|_F <=
    (2 |F|_2 dF + dF^2) / s2, and yF = F y by |dF|_F |y|; to first order
    the Cholesky factor moves by |dL|_F <= kappa |dPhi|_F / |Phi|_2 |L|_2
    and the solve ydd = Phi⁻¹ yF by kappa (|dPhi| / |Phi| + |dyF| / |yF|)
    |ydd|, kappa = cond(Phi) (Sun 1991; standard perturbation of a linear
    system). Each gets a float64 rounding floor of kappa R eps in the same
    units, and the limits are on max|.| <= |.|_F."""
    F = st_p.F.permute(1, 0, 2).reshape(st_p.F.shape[1], -1)
    R = F.shape[0]
    F2 = float(torch.linalg.matrix_norm(F, 2))
    sv = torch.linalg.svdvals(st_p.Phi_L)
    kappa = float((sv.max() / sv.min()) ** 2)
    L2, Phi2 = float(sv.max()), float(sv.max()) ** 2
    dPhi = (2 * F2 * dF + dF * dF) / s2
    yF = float(torch.linalg.vector_norm(F @ y))
    rel_phi = dPhi / Phi2
    floor = kappa * R * torch.finfo(torch.float64).eps
    ydd = float(torch.linalg.vector_norm(st_p.ydd))
    return dict(kappa=kappa,
                Phi_L=(kappa * rel_phi + floor) * L2,
                ydd=(kappa * (rel_phi + dF * float(
                    torch.linalg.vector_norm(y)) / max(yF, 1e-300))
                     + floor) * ydd)


def rbf_served_limit(torch, st, params, U):
    """Per-query limits (mean, var) on the served pICF output's change when
    K_{U,D} comes from rbf.cu instead of the float64 plain covariance.

    rbf.cu computes each entry in float32 from the inputs rounded to
    float32 (rbf.cu:5): out = exp2(a_i + b_j + log2(e) q_i.k_j), a_i =
    log2(sig2) - log2(e)/2 |q_i|^2, b_j = -log2(e)/2 |k_j|^2. The rounding
    of the inputs moves |q|^2, |k|^2 and q.k by <= 2 eps times their size,
    the d-term FMA chains by <= d eps, the two sums by 2 eps, all of
    T_uj = log2(e) (|q_u| + |k_j|)^2 + |log2 sig2|: the exponent errs by
    <= (d + 5) eps T_uj, so the entry by a relative rho_uj = ln 2 (d + 5)
    eps T_uj, plus 2^-22 (ex2.approx) and eps (its float32 result), eps =
    2^-24. Eqs. 24-27 are linear in K_U: mean_u = K_u w, w = y / s2 -
    Fᵀ ydd / s2^2, and var_u = sig2 - K_u B K_uᵀ, B = (FᵀF + s2 I)⁻¹, so
    to first order |dmean_u| <= sum_j rho_uj K_uj |w_j| and |dvar_u| <= 2
    sum_j rho_uj K_uj |(B K_uᵀ)_j| + |dK_u|^2 |B|_2, |B|_2 <= 1 / s2 (the
    second-order term). Worst-case signs: a bound, not an estimate.
    Computed in float64 from the plain path's state, 400 queries at a
    time."""
    import math
    from repro_torch.core import covariance as cov
    s2, sig2 = float(cov.noise_var(params)), float(cov.signal_var(params))
    ls = torch.exp(params["log_lengthscale"])
    Xf = st.Xb.reshape(-1, D)
    F = st.F.permute(1, 0, 2).reshape(st.F.shape[1], -1)
    y = st.yb.reshape(-1)
    w = y / s2 - F.T @ st.ydd / s2 ** 2
    k = (Xf / ls).norm(dim=1)
    L2E = 1.4426950408889634
    alpha = 2.0 ** -22 + F32_EPS
    beta = math.log(2.0) * (D + 5) * F32_EPS
    lim_m, lim_v = [], []
    for i in range(0, U.shape[0], 400):
        Uc = U[i:i + 400]
        q = (Uc / ls).norm(dim=1)
        d2 = torch.cdist(Uc / ls, Xf / ls).pow(2)
        K = sig2 * torch.exp(-0.5 * d2)                   # (u, n)
        T = L2E * (q[:, None] + k[None, :]) ** 2 + abs(math.log2(sig2))
        rho = alpha + beta * T
        Sdot = F @ K.T                                     # (R, u)
        V = K / s2 - (torch.cholesky_solve(Sdot, st.Phi_L).T @ F) / s2 ** 2
        dK2 = ((rho * K) ** 2).sum(1)
        lim_m.append((rho * K * w.abs()[None, :]).sum(1))
        lim_v.append(2 * (rho * K * V.abs()).sum(1) + dK2 / s2)
    return torch.cat(lim_m), torch.cat(lim_v)


def picf_path(torch, card: str, ds, spec, params, S) -> dict:
    """pICF through the ICF kernel at AIMPEAK (phase 4's data and
    hyperparameters, M = 20, R = 2048): fit and serve in float32, the
    kernel path against the plain path in float64, float32 against
    float64, then hyperparameter MLE (exact on the 10000-point subset,
    PITC on all the data from the square-root factorization). Returns the
    kernels' launch counts during the float32 fit and requests."""
    from repro_torch.core import api, covariance as cov, hyper, linalg, picf
    from repro_torch.kernels.rbf import ops
    from repro_torch.parallel.runner import VmapRunner

    runner = VmapRunner(M=M)
    dev = ds.X.device
    torch.cuda.synchronize()
    peaks = [torch.cuda.max_memory_allocated()]   # the ICF checks'
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    model = api.fit("picf", spec, params, ds.X, ds.y, rank=PICF_RANK,
                    runner=runner)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    icf_fit, block_fit = ops.icf_launches, ops.rbf_launches
    plan = model.plan(api.ServeSpec(max_batch=256)).warmup(D)
    outs, lat_ms, off = [], [], 0
    for size in REQUEST_SIZES:
        idx = torch.arange(off, off + size, device=dev) % N_TEST
        U = ds.X_test.index_select(0, idx)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        mean, var = plan.diag(U)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - ts) * 1e3)
        outs.append((idx, mean, var))
        off = (off + size) % N_TEST
    launches = {"rbf": ops.rbf_launches + ops.icf_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  counts during the fit and requests: {launches} (the fit: "
          f"{icf_fit} ICF, {block_fit} rbf block launches; the requests: "
          f"{ops.rbf_launches - block_fit} rbf block launches)", flush=True)
    if icf_fit != 1 or ops.rbf_launches < 1:
        fail(f"pICF: the fit took {icf_fit} ICF launches (want 1) and the "
             f"path {ops.rbf_launches} rbf block launches (want >= 1)")
    for idx, mean, var in outs:
        if mean.shape != idx.shape or var.shape != idx.shape:
            fail(f"pICF plan.diag shapes {tuple(mean.shape)}/"
                 f"{tuple(var.shape)} for {idx.numel()} queries")
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all()):
            fail(f"non-finite pICF output at batch {idx.numel()}")
    idx_all, mean32, var32 = outs[-1]          # the 3200-row request
    y_all = ds.y_test.index_select(0, idx_all)
    rmse32 = float(torch.sqrt(torch.mean((mean32 - y_all) ** 2)))
    neg32 = float((var32 < 0).double().mean())
    p50 = sorted(lat_ms)[len(lat_ms) // 2]
    print(f"  [{card}] pICF fit {t_fit:.3f} s, peak {peak_gb:.2f} GB; "
          f"requests {list(REQUEST_SIZES)}: latency ms "
          f"{[round(x, 3) for x in lat_ms]}, p50 {p50:.3f} ms, max "
          f"{max(lat_ms):.3f} ms", flush=True)
    print(f"  [{card}] pICF float32: test RMSE {rmse32:.4f}, negative-"
          f"variance share {neg32:.4f} of {N_TEST}", flush=True)
    del model, plan, outs
    torch.cuda.empty_cache()

    # the kernel path against the plain path, float64: the stores (pivot
    # inputs, F, the pivot triangle's basis) and the state, then the served
    # output; the served difference splits into the state's part (the
    # kernel path's state served by the plain covariance) and K_UD's
    p64 = {k: v.double() for k, v in params.items()}
    X64, y64, U64 = ds.X.double(), ds.y.double(), ds.X_test.double()
    plain = cov.make_spec("se", impl="torch")
    t1 = time.perf_counter()
    st_k = picf.init_picf_store(spec, p64, X64, y64, rank=PICF_RANK,
                                runner=runner)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    st_p = picf.init_picf_store(plain, p64, X64, y64, rank=PICF_RANK,
                                runner=runner)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    same_piv = bool(torch.equal(st_k.Xp, st_p.Xp))
    Fk = st_k.F.permute(1, 0, 2).reshape(PICF_RANK, -1)
    Fp = st_p.F.permute(1, 0, 2).reshape(PICF_RANK, -1)
    sig2 = float(cov.signal_var(params))
    eps64 = torch.finfo(torch.float64).eps
    min_dp = float(torch.diagonal(st_p.Lp).pow(2).min())
    tol_f = 64 * PICF_RANK * eps64 * sig2 / max(min_dp, 1e-300) ** 0.5
    err_f = max_err(Fk, Fp)
    dF = float(torch.linalg.matrix_norm(Fk - Fp))
    state_k, state_p = st_k.to_state(), st_p.to_state()
    lim = picf_state_limits(torch, state_p, dF, y64,
                            float(cov.noise_var(p64)))
    e_L = max_err(state_k.Phi_L, state_p.Phi_L)
    e_y = max_err(state_k.ydd, state_p.ydd)
    print(f"  pICF f64 stores: kernel path {t2 - t1:.3f} s, plain path "
          f"{t3 - t2:.3f} s; pivots identical {same_piv}; max|dF| "
          f"{err_f:.3e} (tol {tol_f:.3e}); cond(Phi) {lim['kappa']:.3e}; "
          f"max|dPhi_L| {e_L:.3e} (limit {lim['Phi_L']:.3e}), max|dydd| "
          f"{e_y:.3e} (limit {lim['ydd']:.3e})", flush=True)
    if not (same_piv and err_f <= tol_f and e_L <= lim["Phi_L"]
            and e_y <= lim["ydd"]):
        fail("pICF kernel-path state disagrees with the plain path")
    del st_k, st_p, Fk, Fp
    kk = picf.predict_batch_diag(spec, p64, state_k, U64)
    kp = picf.predict_batch_diag(plain, p64, state_k, U64)
    pp = picf.predict_batch_diag(plain, p64, state_p, U64)
    lim_m, lim_v = rbf_served_limit(torch, state_p, p64, U64)
    d_state = [(a - b).abs() for a, b in zip(kp, pp)]
    d_k = [(a - b).abs() for a, b in zip(kk, kp)]
    d_all = [(a - b).abs() for a, b in zip(kk, pp)]
    floor = [1e-12 * (1 + b.abs()) for b in pp]
    ok_k = all(bool((d <= lm + f).all())
               for d, lm, f in zip(d_k, (lim_m, lim_v), floor))
    ok_all = all(bool((d <= lm + 2 * ds_ + f).all())
                 for d, lm, ds_, f in zip(d_all, (lim_m, lim_v), d_state,
                                          floor))
    ratio = max(float((d / (lm + f)).max())
                for d, lm, f in zip(d_k, (lim_m, lim_v), floor))
    print(f"  pICF f64 served, {N_TEST} queries: kernel vs plain path "
          f"max|dmean| {float(d_all[0].max()):.3e}, max|dvar| "
          f"{float(d_all[1].max()):.3e}; of which the state's part "
          f"{float(d_state[0].max()):.3e} / {float(d_state[1].max()):.3e} "
          f"and K_UD's {float(d_k[0].max()):.3e} / {float(d_k[1].max()):.3e}"
          f" against rbf.cu's derived per-query limits (largest "
          f"{float(lim_m.max()):.3e} / {float(lim_v.max()):.3e}; the K_UD "
          f"part reaches {ratio:.3f} of its limit)", flush=True)
    if not (ok_k and ok_all):
        fail("pICF kernel-path serving disagrees with the plain path")
    y_t = ds.y_test.double()
    rmse64 = float(torch.sqrt(torch.mean((kk[0] - y_t) ** 2)))
    neg64 = float((kk[1] < 0).double().mean())
    rmse_p = float(torch.sqrt(torch.mean((pp[0] - y_t) ** 2)))
    neg_p = float((pp[1] < 0).double().mean())
    print(f"  [{card}] pICF float64 (kernel path): test RMSE {rmse64:.4f}, "
          f"negative-variance share {neg64:.4f}; plain path {rmse_p:.4f} / "
          f"{neg_p:.4f}; float32 {rmse32:.4f} / {neg32:.4f} (limits: RMSE "
          f"within {PICF_RMSE_REL:.0%}, shares within {PICF_NEG_SHARE})",
          flush=True)
    if not (abs(rmse32 - rmse64) <= PICF_RMSE_REL * rmse64
            and abs(neg32 - neg64) <= PICF_NEG_SHARE):
        fail(f"pICF float32 vs float64: RMSE {rmse32} vs {rmse64}, shares "
             f"{neg32} vs {neg64}")
    del kk, kp, pp, state_k, state_p
    torch.cuda.empty_cache()

    # MLE: the exact likelihood on the paper's 10000-point subset, float32
    # and float64, then the PITC likelihood on all the data (float32)
    kfn = cov.make_kernel("se")
    Xm, ym = ds.X[:MLE_SUBSET], ds.y[:MLE_SUBSET]
    mle = {}
    for dt in (torch.float64, torch.float32):
        p0 = {k: v.to(dt) for k, v in params.items()}
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        _, losses = hyper.fit(kfn, p0, Xm.to(dt), ym.to(dt), steps=MLE_STEPS)
        torch.cuda.synchronize()
        mle[dt] = (losses.double(), (time.perf_counter() - t4) / MLE_STEPS)
    l64, s64 = mle[torch.float64]
    l32, s32 = mle[torch.float32]
    # step 0 float32 against float64: chol(K + s2 I) in float32 at
    # n = 10000 has cond <= 1 + n sig2 / s2; its quadratic form and
    # log-determinant (each of size ~n) err by ~cond x eps relative: the
    # loss by <= n cond eps / 2 nats
    kappa = 1 + MLE_SUBSET * sig2 / float(cov.noise_var(params))
    tol0 = MLE_SUBSET * kappa * F32_EPS / 2
    d0 = abs(float(l32[0] - l64[0]))
    print(f"  [{card}] MLE exact, n = {MLE_SUBSET}, {MLE_STEPS} Adam steps: "
          f"float64 {s64:.4f} s a step, losses {float(l64[0]):.3f} -> "
          f"{float(l64[-1]):.3f}; float32 {s32:.4f} s a step, "
          f"{float(l32[0]):.3f} -> {float(l32[-1]):.3f}; step 0 apart by "
          f"{d0:.3e} (limit {tol0:.3e} = n cond eps / 2)", flush=True)
    if not (bool(torch.isfinite(l64).all() and torch.isfinite(l32).all())
            and float(l64[-1]) < float(l64[0]) and d0 <= tol0):
        fail(f"MLE: float64 {l64.tolist()}, float32 {l32.tolist()}")

    # the reference's form of the PITC likelihood (Sdd formed, then a
    # float32 Cholesky with 1e-6 x its mean diagonal) at this scale
    with torch.no_grad():
        Kss = kfn(params, S, S)
        Ksd = kfn(params, S, runner.shard_blocks(ds.X))
        V = linalg.tri_solve(linalg.chol(Kss), Ksd)
        Kdd = cov.add_noise(kfn(params, runner.shard_blocks(ds.X),
                                runner.shard_blocks(ds.X)), params)
        C_L = linalg.chol(Kdd - V.mT @ V)
        G = linalg.tri_solve(C_L, Ksd.mT)
        Sdd = Kss + torch.einsum("mbs,mbt->st", G, G)
        info = int(torch.linalg.cholesky_ex(linalg.add_jitter(Sdd))[1])
        del Ksd, V, Kdd, C_L, G, Sdd
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    t5 = time.perf_counter()
    _, lp = hyper.fit_parallel(kfn, params, S, ds.X, ds.y, runner,
                               steps=MLE_PARALLEL_STEPS)
    torch.cuda.synchronize()
    sp = (time.perf_counter() - t5) / MLE_PARALLEL_STEPS
    peak_mle = torch.cuda.max_memory_allocated() / 1e9
    peak_phase = max(peaks + [torch.cuda.max_memory_allocated()]) / 1e9
    print(f"  [{card}] MLE PITC, all {N_TRAIN} rows, M = {M}, |S| = "
          f"{S_SIZE}, float32, {MLE_PARALLEL_STEPS} steps: {sp:.4f} s a "
          f"step, losses {[round(float(x), 3) for x in lp]}, peak "
          f"{peak_mle:.2f} GB; the reference's form (Sdd formed, float32 "
          f"Cholesky) {'fails (info %d)' % info if info else 'succeeds'} "
          f"at the start", flush=True)
    print(f"  [{card}] phase 4c peak device memory (the ICF checks, the f64 "
          f"fits and the exact MLE included) {peak_phase:.2f} GB",
          flush=True)
    if not bool(torch.isfinite(lp).all()):
        fail(f"fit_parallel in float32: losses {lp.tolist()}")
    return dict(launches=launches, fit_s=t_fit, p50_ms=p50,
                lat_ms=lat_ms, rmse32=rmse32, neg32=neg32, rmse64=rmse64,
                neg64=neg64, mle64_s=s64, mle32_s=s32, mle_parallel_s=sp,
                peak_gb=peak_phase)


# Streaming stores and faults (phase 4d), on phase 4's data, support set and
# hyperparameters: two waves of N_TRAIN / 2 rows, each over M / 2 machines,
# so blocks of 1600 rows, the partition of the cold M = 20 fit. Limits:
#  each streamed, retired, revived, straggler or recovered quantity against
#  its yardstick (the cold fit, a float64 refold of the same machines, or a
#  float64 store on the same path):
#  <= 10 x the cold float32 fit's own error against a float64 fit in that
#  quantity + 1e-4 (the shape of phase 4b's limit; served mean and variance
#  on PPIC_F64_QUERIES queries, then Sdd_L and alpha each);
#  the test RMSE of the streamed pPITC state: phase 4's gate; of the
#  streamed pPIC state: phase 4b's; pICF float32 against float64 on the same
#  path: phase 4c's negative-variance rule, no RMSE gate; on the second
#  draw, cold: phase 4c's two rules, streamed: its share rule.
STREAM_RETIRE = 3                 # the machine retired and revived
STRAGGLE_FEW = (5, 17)            # a deadline that misses two machines
STRAGGLE_MANY = 12                # ... and one that misses twelve
PICF_SEED2 = 1                    # a second AIMPEAK draw for pICF's shares


def stream_path(torch, card: str, ds, spec, params, S, cold_state,
                cold_pic) -> dict:
    """The streaming stores of all three parallel GPs and the fault runtime
    at AIMPEAK: pPITC streamed in two waves and served through the plan,
    retire and revive (the downdate kernel), stragglers (incremental and
    refold), a machine's failure and its reassignment, pPIC streamed and
    served routed with a block retired, pICF streamed and retired.

    Every step runs through ``run``, which sets the kernels' launch counts
    to 0 just before it and reads them just after, and adds them to the
    main path's tally (the float32 stores' own steps and their serving) or
    to the yardsticks' (float64 stores and refolds, the reference's float32
    routes printed for the record, the second seed). Returns both tallies
    and the timings."""
    import dataclasses

    import numpy as np
    from repro_torch.core import api, covariance as cov, linalg, online, \
        picf, ppic, ppitc
    from repro_torch.data import synthetic
    from repro_torch.kernels.linalg import ops as lops
    from repro_torch.kernels.rbf import ops
    from repro_torch.parallel.runner import VmapRunner
    from repro_torch.runtime import fault

    dev = ds.X.device
    half, H = VmapRunner(M=M // 2), N_TRAIN // 2
    b = N_TRAIN // M
    spec64 = cov.make_spec("se", impl="torch")
    p64 = {k: v.double() for k, v in params.items()}
    X64, y64, S64 = ds.X.double(), ds.y.double(), S.double()
    U = ds.X_test[:PPIC_F64_QUERIES]
    U64 = U.double()
    times = {}
    tally = {"main": {}, "yardsticks": {}}
    last = {}                      # the counts of the latest step

    def run(fn, name=None, main=False):
        torch.cuda.synchronize()
        ops.reset_counts()
        lops.reset_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if name:
            times[name] = time.perf_counter() - t
        last.update(rbf=ops.rbf_launches, icf=ops.icf_launches,
                    xcov_diag=ops.xcov_launches,
                    chol_downdate=lops.chol_downdate_launches,
                    rows_mm=lops.rows_mm_launches,
                    rows_reduce=lops.rows_reduce_launches)
        into = tally["main" if main else "yardsticks"]
        for k, v in last.items():
            into[k] = into.get(k, 0) + v
        return out

    def served32(state):
        return run(lambda: ppitc.predict_batch_diag(spec, params, state, U))

    def served64(state):
        return run(lambda: ppitc.predict_batch_diag(spec64, p64, state, U64))

    def err2(a, b_):
        return max(max_err(a[0], b_[0]), max_err(a[1], b_[1]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the yardsticks: pPITC's own f32-vs-f64 error (phase 4's cold fit
    # against a float64 cold fit of the same data), and a float64 store on
    # the same streaming path
    cold64 = run(lambda: api.fit("ppitc", spec64, p64, X64, y64, S=S64,
                                 runner=VmapRunner(M=M)).state,
                 "cold f64 fit")
    cold_served = served32(cold_state)
    own = {"served": err2(cold_served, served64(cold64)),
           "Sdd_L": max_err(cold_state.Sdd_L, cold64.Sdd_L),
           "alpha": max_err(cold_state.alpha, cold64.alpha)}
    lim = {k: 10 * v + 1e-4 for k, v in own.items()}
    print(f"  yardsticks: the cold f32 fit against an f64 fit: served "
          f"{own['served']:.3e}, Sdd_L {own['Sdd_L']:.3e}, alpha "
          f"{own['alpha']:.3e}; limits 10 x these + 1e-4", flush=True)
    st64 = run(lambda: api.init_store(
        "ppitc", spec64, p64, X64[:H], y64[:H], S=S64,
        runner=half).assimilate(X64[H:], y64[H:]))
    failures = []

    def check(what, e, limit):
        ok = e <= limit
        print(f"  {what}: {e:.3e} (limit {limit:.3e}){'' if ok else ' FAIL'}",
              flush=True)
        if not ok:
            failures.append(what)

    # (a) pPITC: the first wave over 10 machines, the second assimilated
    st0 = run(lambda: api.init_store("ppitc", spec, params, ds.X[:H],
                                     ds.y[:H], S=S, runner=half),
              "init_store ppitc", main=True)
    st = run(lambda: st0.assimilate(ds.X[H:], ds.y[H:]), "assimilate ppitc",
             main=True)
    del st0
    state = run(st.to_state, "to_state", main=True)
    model = api.FittedGP(api.get("ppitc"), spec, params, state)
    plan = run(lambda: model.plan(api.ServeSpec(max_batch=256)).warmup(D),
               main=True)
    outs, lat_ms, off = [], [], 0
    for size in REQUEST_SIZES:
        idx = torch.arange(off, off + size, device=dev) % N_TEST
        Uq = ds.X_test.index_select(0, idx)
        mean, var = run(lambda: plan.diag(Uq), "request", main=True)
        lat_ms.append(times["request"] * 1e3)
        outs.append((idx, mean, var))
        off = (off + size) % N_TEST
    for idx, mean, var in outs:
        if mean.shape != idx.shape or not (torch.isfinite(mean).all()
                                           and torch.isfinite(var).all()):
            fail(f"streamed pPITC: bad output at batch {idx.numel()}")
    idx_all, mean_all, var_all = outs[-1]
    rmse = float(torch.sqrt(torch.mean(
        (mean_all - ds.y_test.index_select(0, idx_all)) ** 2)))
    neg = float((var_all < 0).double().mean())
    print(f"  [{card}] (a) pPITC streamed (2 waves x 10 machines x {b}): "
          f"init {times['init_store ppitc']:.3f} s, assimilate "
          f"{times['assimilate ppitc']:.3f} s, to_state "
          f"{times['to_state']:.4f} s; requests {list(REQUEST_SIZES)}: "
          f"latency ms {[round(x, 3) for x in lat_ms]}; test RMSE "
          f"{rmse:.4f}, negative-variance share {neg:.4f}", flush=True)
    if not (abs(rmse - RMSE_AIMPEAK) <= TOL_RMSE and neg == 0.0):
        failures.append(f"streamed pPITC RMSE {rmse}, share {neg}")
    full = run(lambda: plan.diag(U))
    check("(a) streamed vs the cold fit, served", err2(full, cold_served),
          lim["served"])
    check("(a) streamed vs the cold fit, Sdd_L",
          max_err(state.Sdd_L, cold_state.Sdd_L), lim["Sdd_L"])
    check("(a) streamed vs the cold fit, alpha",
          max_err(state.alpha, cold_state.alpha), lim["alpha"])

    # (b) retire and revive: a float64 downdate of the float32 factor
    r = STREAM_RETIRE
    dead = run(lambda: st.retire(r), "retire", main=True)
    n_retire = last["chol_downdate"]
    alive = dead.store.alive
    ref64 = run(lambda: online.with_alive(st64.store, alive, mode="refold"),
                "f64 refold")
    dead64 = run(lambda: st64.retire(r), "f64 retire")
    refold32 = run(lambda: online.with_alive(st.store, alive, mode="refold"),
                   "f32 refold")
    s_ref64 = online.to_state(ref64, S64)
    retired64 = served64(s_ref64)     # also phase 4f's yardstick
    e_dead = err2(served32(dead.to_state()), retired64)
    e_refold = err2(served32(online.to_state(refold32, S)), retired64)
    # the reference's route, for the record: the downdate in float32
    dd32 = run(lambda: st.store._replace(
        alive=alive, ydd=dead.store.ydd, Sdd_L=linalg.chol_update_rank(
            st.store.Sdd_L, st.store.F[r], sign=-1.0)))
    e_dd32 = err2(served32(online.to_state(dd32, S)), retired64)
    scale = float(ref64.Sdd_L.abs().max())
    print(f"  [{card}] (b) retire({r}): {times['retire']:.4f} s, "
          f"{n_retire} chol_downdate launch(es) (float64); f64 store's "
          f"retire {times['f64 retire']:.4f} s; the alternatives: f32 "
          f"refold {times['f32 refold']:.4f} s, f64 refold (chol_from_root "
          f"over {int(alive.sum())} machines' roots) "
          f"{times['f64 refold']:.4f} s", flush=True)
    print(f"  downdated Sdd_L, max|err| / max|Sdd_L|: f32 retire vs f64 "
          f"refold {max_err(dead.store.Sdd_L, ref64.Sdd_L) / scale:.3e}, f32 "
          f"retire vs f64 retire "
          f"{max_err(dead.store.Sdd_L, dead64.store.Sdd_L) / scale:.3e}, f64 "
          f"retire vs f64 refold "
          f"{max_err(dead64.store.Sdd_L, ref64.Sdd_L) / scale:.3e}, f32 "
          f"refold vs f64 refold "
          f"{max_err(refold32.Sdd_L, ref64.Sdd_L) / scale:.3e}, f32 "
          f"downdate in f32 vs f64 refold "
          f"{max_err(dd32.Sdd_L, ref64.Sdd_L) / scale:.3e}; served vs the "
          f"f64 refold: f32 refold {e_refold:.3e}, f32 downdate in f32 (the "
          f"reference's route) {e_dd32:.3e}", flush=True)
    if n_retire != 1:
        failures.append(f"retire took {n_retire} downdate launches")
    check(f"(b) retire({r}) vs the f64 refold of the survivors, served",
          e_dead, lim["served"])
    del refold32, ref64, s_ref64, dead64, dd32
    back = run(lambda: dead.revive(r), "revive", main=True)
    check(f"(b) revive({r}) vs (a), served", err2(served32(back.to_state()),
                                                  full), lim["served"])
    if last["chol_downdate"]:
        failures.append("revive launched the downdate kernel")
    del back

    # (c) stragglers: deadlines that miss 2 and 12 machines
    for dead_set, mode in ((STRAGGLE_FEW, "incremental"),
                           (tuple(range(STRAGGLE_MANY)), "auto")):
        mask = torch.ones(M, dtype=torch.bool, device=dev)
        mask[list(dead_set)] = False
        key = f"with_alive {len(dead_set)}"
        view = run(lambda: st.with_alive(mask, mode=mode), key, main=True)
        n_dd = last["chol_downdate"]
        ref = served64(online.to_state(run(lambda: online.with_alive(
            st64.store, mask, mode="refold")), S64))
        print(f"  [{card}] (c) with_alive, {len(dead_set)} machines "
              f"missed, mode {mode}: {times[key]:.4f} s, {n_dd} "
              f"chol_downdate launch(es)", flush=True)
        if mode == "incremental":
            # the reference's chain, for the record: downdates in float32
            def chain_fn():
                chain = st.store
                for m in dead_set:
                    chain = chain._replace(Sdd_L=linalg.chol_update_rank(
                        chain.Sdd_L, chain.F[m], sign=-1.0),
                        ydd=chain.ydd - chain.locals_.ydot[m])
                return chain
            chain = run(chain_fn)
            print(f"  (c) the reference's chain of {len(dead_set)} float32 "
                  f"downdates vs the f64 refold, served: "
                  f"{err2(served32(online.to_state(chain, S)), ref):.3e}",
                  flush=True)
            del chain
            if n_dd != len(dead_set):
                failures.append(f"incremental with_alive took {n_dd} "
                                f"launches")
        check(f"(c) {len(dead_set)} missed vs the f64 refold, served",
              err2(served32(view.to_state()), ref), lim["served"])
        if mode == "auto":
            same = run(lambda: online.with_alive(st.store, mask,
                                                 mode="refold"))
            if not torch.equal(same.Sdd_L, view.store.Sdd_L):
                failures.append("auto did not take the refold at 12 flips")
        del view

    # (d) a machine fails and a standby recomputes its block
    cl = fault.ClusterState(st, torch.arange(M, dtype=torch.int32,
                                             device=dev))
    cl = run(lambda: fault.fail(cl, r), "fail", main=True)
    n_fail = last["chol_downdate"]
    Xm, ym = ds.X[r * b:(r + 1) * b], ds.y[r * b:(r + 1) * b]
    cl = run(lambda: fault.recover_reassign(cl, Xm, ym, machine=r,
                                            new_owner=0),
             "recover_reassign", main=True)
    print(f"  [{card}] (d) fault.fail {times['fail']:.4f} s ({n_fail} "
          f"chol_downdate launch), recover_reassign "
          f"{times['recover_reassign']:.4f} s ({last['rbf']} rbf launches: "
          f"the block's summary)", flush=True)
    check("(d) recovered vs (a), served",
          err2(served32(cl.store.to_state()), full), lim["served"])
    del cl, st, st64, plan, model, outs
    torch.cuda.empty_cache()

    # (e) pPIC on phase 4b's co-clustered order: blocks are clusters
    Xc, yc = cold_pic["Xc"], cold_pic["yc"]
    pst0 = run(lambda: api.init_store("ppic", spec, params, Xc[:H], yc[:H],
                                      S=S, runner=half),
               "init_store ppic", main=True)
    pst = run(lambda: pst0.assimilate(Xc[H:], yc[H:]), "assimilate ppic",
              main=True)
    del pst0
    pm = api.FittedGP(api.get("ppic"), spec, params,
                      run(pst.to_state, main=True))
    routed = api.ServeSpec(routed=True, max_batch=256)
    pplan = run(lambda: pm.plan(routed).warmup(D), "ppic plan+warmup",
                main=True)
    lat_p, outs = [], []
    for size in REQUEST_SIZES:
        Uq = ds.X_test[:size]
        outs.append(run(lambda: pplan.routed_diag(Uq), "request", main=True))
        lat_p.append(times["request"] * 1e3)
    mean, var = outs[-1]
    rmse_p = float(torch.sqrt(torch.mean((mean - ds.y_test[:N_TEST]) ** 2)))
    neg_p = float((var < 0).double().mean())
    print(f"  [{card}] (e) pPIC streamed: init "
          f"{times['init_store ppic']:.3f} s, assimilate "
          f"{times['assimilate ppic']:.3f} s, plan + warm-up "
          f"{times['ppic plan+warmup']:.3f} s; requests latency ms "
          f"{[round(x, 3) for x in lat_p]}; test RMSE {rmse_p:.4f}, "
          f"negative-variance share {neg_p:.4f}", flush=True)
    if not (rmse_p <= RMSE_AIMPEAK + TOL_RMSE and neg_p == 0.0
            and all(torch.isfinite(m).all() and torch.isfinite(v).all()
                    for m, v in outs)):
        failures.append(f"streamed pPIC RMSE {rmse_p}, share {neg_p}")
    check("(e) streamed vs phase 4b's cold fit, routed",
          err2(run(lambda: pplan.routed_diag(U)),
               (cold_pic["m"], cold_pic["v"])), lim["served"])
    # a block dead at serving: its rows from the global posterior
    U256 = ds.X_test[:256]
    m_all, v_all = run(lambda: pplan.routed_diag(U256))
    blk = np.ones(M, bool)
    blk[r] = False
    md, vd = run(lambda: pplan.routed_diag(U256, block_alive=blk), main=True)
    n_xcov = last["xcov_diag"]
    deg = torch.as_tensor(pplan.stats.last_degraded, device=dev)
    mg, vg = run(lambda: ppic.global_diag(pplan.kfn, params, pm.state, U256))
    e_deg = max(max_rel(md[deg], mg[deg]), max_rel(vd[deg], vg[deg]))
    same = bool(torch.equal(md[~deg], m_all[~deg])
                and torch.equal(vd[~deg], v_all[~deg]))
    print(f"  (e) block {r} dead at serving: {int(deg.sum())} rows from the "
          f"global posterior, xcov_diag launches {n_xcov}, against "
          f"global_diag {e_deg:.3e} (limit 1e-6); other rows unchanged "
          f"{same}", flush=True)
    if not (int(deg.sum()) > 0 and n_xcov > 0 and e_deg <= 1e-6 and same):
        failures.append("pPIC dead block's rows not from the global "
                        "posterior")
    # the block retired from the store: one downdate, 19 blocks served,
    # against a float64 store streamed and retired the same way
    pdead = run(lambda: pst.retire(r), "retire ppic", main=True)
    n_pd = last["chol_downdate"]
    pstate = run(pdead.to_state, main=True)
    pplan = run(lambda: pm.with_state(pstate).plan(routed), main=True)
    m_d, v_d = run(lambda: pplan.routed_diag(U), main=True)
    Xc64, yc64 = Xc.double(), yc.double()
    pdead64 = run(lambda: api.init_store(
        "ppic", spec64, p64, Xc64[:H], yc64[:H], S=S64, runner=half)
        .assimilate(Xc64[H:], yc64[H:]).retire(r), "ppic f64 store")
    m64, v64 = run(lambda: api.FittedGP(
        api.get("ppic"), spec64, p64, pdead64.to_state()).plan(routed)
        .routed_diag(U64))
    print(f"  [{card}] (e) pPIC retire({r}): {times['retire ppic']:.4f} s, "
          f"{n_pd} chol_downdate launch(es), {pstate.centroids.shape[0]} "
          f"blocks served; {PPIC_F64_QUERIES} routed rows finite "
          f"{bool(torch.isfinite(m_d).all() and torch.isfinite(v_d).all())}, "
          f"negative variances {int((v_d < 0).sum())}", flush=True)
    check(f"(e) retire({r}) vs an f64 pPIC store retired the same way, "
          f"routed", err2((m_d, v_d), (m64, v64)), lim["served"])
    if pstate.centroids.shape[0] != M - 1 or n_pd != 1 \
            or not bool(torch.isfinite(m_d).all() and (v_d > 0).all()):
        failures.append("pPIC store retire")
    del pst, pdead, pstate, pdead64, pm, pplan, m64, v64
    torch.cuda.empty_cache()

    # (f) pICF: a store on the first wave at R = 2048, the second wave
    # assimilated in the frozen pivot basis, then one machine retired (one
    # downdate of Phi_L); the same path in float64 (a yardstick)
    res = {}
    for dt, p_, X_, y_ in ((torch.float32, params, ds.X, ds.y),
                           (torch.float64, p64, X64, y64)):
        key = str(dt).split(".")[1]
        on_main = dt == torch.float32
        f0 = run(lambda: api.init_store(
            "picf", spec, p_, X_[:H], y_[:H], rank=PICF_RANK, runner=half),
            f"init_store picf {key}", main=on_main)
        n_icf = last["icf"]
        f1 = run(lambda: f0.assimilate(X_[H:], y_[H:]),
                 f"assimilate picf {key}", main=on_main)
        del f0
        f2 = run(lambda: f1.retire(r), f"retire picf {key}", main=on_main)
        n_f = last["chol_downdate"]
        if f2.Phi_L.dtype != torch.float64:
            failures.append(f"pICF {key}: Phi_L in {f2.Phi_L.dtype}")
        rd = f2.Phi_L.dtype            # the R-space dtype: float64
        keep = torch.as_tensor(np.r_[0:r, r + 1:M], device=dev)
        Phi_ref = linalg.chol_from_root(
            torch.eye(PICF_RANK, dtype=rd, device=dev),
            f2.F[keep].to(rd) / cov.noise_var(p_).to(rd).sqrt())
        e_phi = max_err(f2.Phi_L, Phi_ref) / float(Phi_ref.abs().max())
        m_, v_ = run(lambda: picf.predict_batch_diag(
            spec, p_, f2.to_state(), ds.X_test.to(dt)), main=on_main)
        rm = float(torch.sqrt(torch.mean((m_ - ds.y_test.to(dt)) ** 2)))
        ng = float((v_ < 0).double().mean())
        res[key] = (rm, ng)
        print(f"  [{card}] (f) pICF {key}: init "
              f"{times[f'init_store picf {key}']:.3f} s ({n_icf} ICF "
              f"launch), assimilate {times[f'assimilate picf {key}']:.3f} s, "
              f"retire({r}) {times[f'retire picf {key}']:.4f} s ({n_f} "
              f"chol_downdate launch); downdated Phi_L vs the refold of its "
              f"root, max|err| / max|Phi_L| {e_phi:.3e}; test RMSE "
              f"{rm:.4f}, negative-variance share {ng:.4f}", flush=True)
        if n_f != 1 or not (torch.isfinite(m_).all()
                            and torch.isfinite(v_).all()):
            failures.append(f"pICF {key}: {n_f} downdate launches, or "
                            f"non-finite output")
        if dt == torch.float32:
            # the reference's form, for the record: the R-space algebra in
            # float32 too (Phi_L from the float32 root, then updated and
            # downdated in float32)
            F0 = f1.F[:M // 2]

            def ref_form_fn():
                rf = dataclasses.replace(
                    f1, F=F0, Xb=f1.Xb[:M // 2], yb=f1.yb[:M // 2],
                    alive=f1.alive[:M // 2],
                    Phi_L=linalg.chol_from_root(
                        torch.eye(PICF_RANK, dtype=dt, device=dev),
                        F0 / cov.noise_var(p_).sqrt()),
                    yF=(F0 @ f1.yb[:M // 2, :, None])[..., 0].sum(0))
                rf = rf.assimilate(X_[H:], y_[H:]).retire(r)
                return picf.predict_batch_diag(spec, p_, rf.to_state(),
                                               ds.X_test)[1]
            v_r = run(ref_form_fn)
            print(f"  (f) the reference's form in float32 (Phi_L float32): "
                  f"negative-variance share "
                  f"{float((v_r < 0).double().mean()):.4f}", flush=True)
            del v_r
        del f1, f2, m_, v_, Phi_ref
    torch.cuda.empty_cache()
    if not abs(res["float32"][1] - res["float64"][1]) <= PICF_NEG_SHARE:
        failures.append(f"pICF f32 vs f64 shares {res}")

    # pICF's float32-vs-float64 rules (phase 4c's) on a second AIMPEAK
    # draw, cold and streamed: the R-space dtype chosen on seed 0 must hold
    ds2 = synthetic.standardize(synthetic.aimpeak_like(
        n=N_TRAIN, n_test=N_TEST, seed=PICF_SEED2))
    seed2 = {}
    for dt, p_ in ((torch.float32, params), (torch.float64, p64)):
        X_, y_, Ut, yt = (t.to(dt) for t in (ds2.X, ds2.y, ds2.X_test,
                                              ds2.y_test))

        def cold_fn():
            st_ = api.fit("picf", spec, p_, X_, y_, rank=PICF_RANK,
                          runner=VmapRunner(M=M)).state
            return picf.predict_batch_diag(spec, p_, st_, Ut)

        def stream_fn():
            st_ = api.init_store("picf", spec, p_, X_[:H], y_[:H],
                                 rank=PICF_RANK, runner=half)
            st_ = st_.assimilate(X_[H:], y_[H:]).retire(r)
            return picf.predict_batch_diag(spec, p_, st_.to_state(), Ut)

        for what, fn in (("cold", cold_fn), ("streamed", stream_fn)):
            m_, v_ = run(fn)
            seed2[(what, dt)] = (
                float(torch.sqrt(torch.mean((m_ - yt) ** 2))),
                float((v_ < 0).double().mean()))
        torch.cuda.empty_cache()
    for what in ("cold", "streamed"):
        (rm32, ng32), (rm64, ng64) = (seed2[(what, torch.float32)],
                                      seed2[(what, torch.float64)])
        ok = abs(ng32 - ng64) <= PICF_NEG_SHARE and (
            what == "streamed" or abs(rm32 - rm64) <= PICF_RMSE_REL * rm64)
        print(f"  [{card}] (f) pICF on AIMPEAK seed {PICF_SEED2}, {what}: "
              f"test RMSE f32 {rm32:.4f} / f64 {rm64:.4f}, negative-variance "
              f"share f32 {ng32:.4f} / f64 {ng64:.4f}"
              f"{'' if ok else ' FAIL'}", flush=True)
        if not ok:
            failures.append(f"pICF seed {PICF_SEED2} {what}: f32 vs f64 "
                            f"{seed2}")
    del ds2

    times.pop("request")
    launches = {"rbf": tally["main"]["rbf"] + tally["main"]["icf"],
                **{k: tally["main"][k] for k in ("xcov_diag", "chol_downdate",
                                                 "rows_mm", "rows_reduce")}}
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  counts of the main path (the float32 stores' steps and "
          f"serving): {launches} (rbf: {tally['main']['rbf']} block "
          f"launches, {tally['main']['icf']} of the ICF kernel); of the "
          f"yardsticks and records: {tally['yardsticks']}", flush=True)
    print(f"  [{card}] phase 4d step times (s): "
          f"{ {k: round(v, 4) for k, v in times.items()} }; peak device "
          f"memory {peak:.2f} GB", flush=True)
    for name, n in launches.items():
        if n <= 0:
            failures.append(f"kernel {name} was not launched on phase 4d's "
                            f"main path")
    if failures:
        fail(f"phase 4d: {failures}")
    return dict(launches=launches, yardstick_launches=tally["yardsticks"],
                times=times, peak_gb=peak, rmse=rmse, rmse_ppic=rmse_p,
                picf=res, yardsticks=dict(
                    limit=lim["served"], U=U, cold=cold_served,
                    streamed=full, retired=retired64))


# The serving runtime (phase 4f), on phase 4's data, support set and
# hyperparameters, phase 4's fitted pPITC state and phase 4b's co-clustered
# pPIC fit. The server's tickets are held to the plan's output on the same
# flush's rows bit for bit (the same program on the same staged rows), the
# multiplexed tenants to single-tenant servers fed the same flushes, the
# restored checkpoints to the servers that wrote them, and the healed block
# to its output before the poisoning; the streamed posteriors to phase 4d's
# yardsticks within phase 4d's limit.
SERVE_MAX_BATCH = 256
SERVE_DEADLINE_MS = 2.0
SERVE_WEIGHTS = {"ppitc": 1.0, "ppic": 2.0}
SERVE_PENDING = 100       # tickets left pending across each store swap
SERVE_HEAL_ROWS = 1024    # test rows served before, during and after healing


def serving_path(torch, card: str, ds, spec, params, S, cold_state,
                 cold_pic, yard) -> dict:
    """The serving runtime at AIMPEAK: (a) one pPITC ``GPServer`` fed the
    test inputs one by one with a deadline; (b) a ``TenantScheduler``
    multiplexing pPITC and routed pPIC tenants; (c) a store-backed server
    through ``update``, ``retire_machine`` and ``revive_machine`` with
    tickets pending across each swap; (d) store and state checkpoints
    through the server and the registry; (e) a poisoned block healed by the
    health ladder, and a corrupt checkpoint refused. Returns the kernels'
    launches on the serving path (the yardsticks' apart) and the
    readings."""
    import os
    import tempfile

    import numpy as np
    from repro_torch.core import api, clustering
    from repro_torch.kernels.linalg import ops as lops
    from repro_torch.kernels.rbf import ops
    from repro_torch.launch.gp_serve import GPServer
    from repro_torch.parallel.runner import VmapRunner
    from repro_torch.serving import (FaultInjector, FaultPlan, HealthPolicy,
                                     TenantRegistry, TenantScheduler)
    from repro_torch.serving.chaos import poison_state

    ops.reset_counts()
    lops.reset_counts()
    failures, readings = [], {}
    tally = {"serving": dict.fromkeys(("rbf", "xcov_diag", "chol_downdate",
                                       "rows_mm", "rows_reduce"), 0)}
    tally["yardsticks"] = dict(tally["serving"])

    def counts():
        return {"rbf": ops.rbf_launches + ops.icf_launches,
                "xcov_diag": ops.xcov_launches,
                "chol_downdate": lops.chol_downdate_launches,
                "rows_mm": lops.rows_mm_launches,
                "rows_reduce": lops.rows_reduce_launches}

    def run(fn, serving=True):
        """``fn()``, its kernels' launches added to the serving tally (or
        the yardsticks'); returns its output and those launches."""
        c0 = counts()
        out = fn()
        c1 = counts()
        diff = {k: c1[k] - c0[k] for k in c0}
        into = tally["serving" if serving else "yardsticks"]
        for k, v in diff.items():
            into[k] += v
        return out, diff

    def need(ok, what):
        print(f"  {what}: {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(what)

    def bitwise(got, want) -> bool:
        return bool(torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]))

    def stacked(results):
        return (torch.stack([r[0] for r in results]),
                torch.stack([r[1] for r in results]))

    def finite(results) -> bool:
        m, v = stacked(results)
        return bool(torch.isfinite(m).all() and torch.isfinite(v).all())

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q))

    Uh = ds.X_test.cpu().numpy()                       # queries arrive here
    order = np.random.default_rng(0).permutation(N_TEST)
    pitc = api.FittedGP(api.get("ppitc"), spec, params, cold_state)
    pic = api.FittedGP(api.get("ppic"), spec, params, cold_pic["state"])
    sspec = api.ServeSpec(max_batch=SERVE_MAX_BATCH)
    rspec = api.ServeSpec(routed=True, max_batch=SERVE_MAX_BATCH)

    # (a) one tenant: submit, pump, and collect each flush's tickets as soon
    # as it is dispatched (the client waits for its answer)
    srv = GPServer(pitc, spec=sspec, flush_deadline_ms=SERVE_DEADLINE_MS)
    srv.plan.warmup(D)
    torch.cuda.synchronize()
    groups, lat, res, t_sub, open_ = [], [], {}, {}, []

    def drive():
        for i in order:
            now = time.monotonic()
            tk = srv.submit(Uh[i])
            t_sub[tk] = now
            open_.append((tk, i))
            if srv.pending:
                srv.pump()
            if not srv.pending:
                groups.append(list(open_))
                open_.clear()
                for k, _ in groups[-1]:
                    res[k] = srv.result(k)
                    lat.append((time.monotonic() - t_sub[k]) * 1e3)
        srv.flush()
        if open_:
            groups.append(list(open_))
            for k, _ in open_:
                res[k] = srv.result(k)
                lat.append((time.monotonic() - t_sub[k]) * 1e3)
            open_.clear()

    t0 = time.perf_counter()
    _, la = run(drive)
    wall = time.perf_counter() - t0
    st = srv.stats
    ok = len(res) == N_TEST and finite(list(res.values()))
    same = True
    for g in groups:
        rows = np.array([i for _, i in g])
        want, _ = run(lambda: srv.plan.diag(Uh[rows]), serving=False)
        same &= bitwise(stacked([res[k] for k, _ in g]), want)
    n_fl = st.n_flushes
    readings["a"] = dict(p50_ms=pct(lat, 50), p99_ms=pct(lat, 99),
                         flushes=n_fl, size=st.n_size_flushes,
                         deadline=st.n_deadline_flushes,
                         manual=st.n_manual_flushes, wall_s=wall)
    print(f"  [{card}] (a) GPServer pPITC, {N_TEST} points one by one, "
          f"deadline {SERVE_DEADLINE_MS} ms, max_batch {SERVE_MAX_BATCH}: "
          f"{wall:.3f} s; submit-to-result latency per ticket p50 "
          f"{readings['a']['p50_ms']:.3f} ms, p99 "
          f"{readings['a']['p99_ms']:.3f} ms; {n_fl} flushes (size "
          f"{st.n_size_flushes}, deadline {st.n_deadline_flushes}, manual "
          f"{st.n_manual_flushes}), mean {N_TEST / n_fl:.1f} tickets a "
          f"flush; launches {la} ({la['xcov_diag'] / n_fl:.2f} xcov_diag, "
          f"{la['rbf'] / n_fl:.2f} rbf a flush); queue time p50/p99 "
          f"{st.staleness.percentile(50):.3f}/"
          f"{st.staleness.percentile(99):.3f} ms", flush=True)
    need(ok, "(a) every ticket answered, finite")
    need(same and len(groups) == n_fl,
         f"(a) tickets bitwise plan.diag of their flush's rows "
         f"({len(groups)} flushes)")
    del srv, res

    # (b) two tenants in one scheduler, the same arrivals alternating
    sched = TenantScheduler(clock=time.monotonic, log_len=4 * N_TEST)
    tens = {"ppitc": sched.admit("ppitc", pitc, sspec,
                                 weight=SERVE_WEIGHTS["ppitc"],
                                 flush_deadline_ms=SERVE_DEADLINE_MS),
            "ppic": sched.admit("ppic", pic, rspec,
                                weight=SERVE_WEIGHTS["ppic"],
                                flush_deadline_ms=SERVE_DEADLINE_MS)}
    for t in tens.values():
        t.plan.warmup(D)
    torch.cuda.synchronize()
    traces = {k: t.plan.stats.n_traces for k, t in tens.items()}
    rows_of = {k: [] for k in tens}
    sub = {k: {} for k in tens}
    got = {k: {} for k in tens}
    lat_b = {k: [] for k in tens}

    def drive_b():
        for j, i in enumerate(order):
            tid = "ppitc" if j % 2 == 0 else "ppic"
            now = time.monotonic()
            tk = sched.submit(tid, Uh[i])
            sub[tid][tk] = now
            rows_of[tid].append(i)
            sched.pump()
            for t_id, t in tens.items():
                for k in list(t.ready):
                    got[t_id][k] = sched.result(t_id, k)
                    lat_b[t_id].append((time.monotonic() - sub[t_id][k])
                                       * 1e3)
        sched.flush()
        for t_id, t in tens.items():
            for k in list(t.ready):
                got[t_id][k] = sched.result(t_id, k)
                lat_b[t_id].append((time.monotonic() - sub[t_id][k]) * 1e3)

    t0 = time.perf_counter()
    _, lb = run(drive_b)
    wall = time.perf_counter() - t0
    log = list(sched.dispatch_log)
    same, answered = True, True
    for tid, model, spec_ in (("ppitc", pitc, sspec), ("ppic", pic, rspec)):
        solo = GPServer(model, spec=spec_)
        answered &= (len(got[tid]) == N_TEST // 2
                     and finite(list(got[tid].values())))
        rows = np.array(rows_of[tid])

        def replay():
            out, k0 = [], 0
            for t_id, _, n in log:
                if t_id != tid:
                    continue
                tks = [solo.submit(Uh[r]) for r in rows[k0:k0 + n]]
                solo.flush()
                out += [solo.result(k) for k in tks]
                k0 += n
            return out, k0

        (out, nxt), _ = run(replay, serving=False)
        same &= nxt == len(rows) and bitwise(
            stacked(out), stacked([got[tid][k] for k in range(len(rows))]))
    grow = {k: t.plan.stats.n_traces - traces[k] for k, t in tens.items()}
    # a routed ticket is a function of its query and the state alone: the
    # pPIC tenant's tickets, bitwise one routed_diag over all its queries
    rows = np.array(rows_of["ppic"])
    whole, _ = run(lambda: tens["ppic"].plan.routed_diag(Uh[rows]),
                   serving=False)
    one_call = bitwise(stacked([got["ppic"][k] for k in range(len(rows))]),
                       whole)
    # a third tenant of pPIC's lineage: the same callables, none built
    third = sched.admit("ppic2", api.FittedGP(api.get("ppic"), spec, params,
                                              cold_pic["state"]), rspec)
    n3 = third.plan.stats.n_traces
    run(lambda: sched.predict("ppic2", Uh[order[:SERVE_MAX_BATCH]]))
    shared = (third.plan._exec is tens["ppic"].plan._exec
              and third.plan.stats.n_traces == n3
              and sched.registry.n_lineages == 2)
    roll = sched.rollup()["tenants"]
    readings["b"] = {tid: dict(p50_ms=pct(lat_b[tid], 50),
                               p99_ms=pct(lat_b[tid], 99),
                               flushes=roll[tid]["n_flushes"])
                     for tid in tens}
    print(f"  [{card}] (b) TenantScheduler, pPITC (weight 1) and routed "
          f"pPIC (weight 2), {N_TEST} points alternating: {wall:.3f} s; "
          + "; ".join(
              f"{tid}: p50 {readings['b'][tid]['p50_ms']:.3f} ms, p99 "
              f"{readings['b'][tid]['p99_ms']:.3f} ms, "
              f"{roll[tid]['n_flushes']} flushes (size "
              f"{roll[tid]['n_size_flushes']}, deadline "
              f"{roll[tid]['n_deadline_flushes']}), g_hist "
              f"{roll[tid]['g_hist']}" for tid in tens)
          + f"; launches {lb}; callables built after warm-up {grow}",
          flush=True)
    need(answered, "(b) every ticket answered, finite")
    need(same, "(b) each tenant bitwise a single-tenant GPServer fed the "
               "same flushes")
    need(one_call, f"(b) the routed tickets bitwise one plan.routed_diag "
                   f"over all {len(rows)} of their queries")
    need(not any(grow.values()), "(b) no callable built after warm-up")
    need(shared, "(b) a third tenant of the lineage shares its callables, "
                 "none built")
    del sched, tens, third, got

    # (c) streaming through the server: pending tickets across each swap
    H, half = N_TRAIN // 2, VmapRunner(M=M // 2)
    Uy, lim = yard["U"], yard["limit"]

    def err2(a, b_):
        return max(max_err(a[0], b_[0]), max_err(a[1], b_[1]))

    st1, _ = run(lambda: api.init_store("ppitc", spec, params, ds.X[:H],
                                        ds.y[:H], S=S, runner=half))
    srv = GPServer(api.FittedGP(api.get("ppitc"), spec, params,
                                st1.to_state()), spec=sspec, store=st1)
    srv.plan.warmup(D)
    rows = order[:SERVE_PENDING]
    swap_s, swap_launches = {}, {}

    def swap(name, fn, yardstick):
        old = srv.plan
        tks = [srv.submit(Uh[i]) for i in rows]
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, n = run(fn)
        torch.cuda.synchronize()
        swap_s[name], swap_launches[name] = time.perf_counter() - t, n
        out = [srv.result(k) for k in tks]
        want, _ = run(lambda: old.diag(Uh[rows]), serving=False)
        need(bitwise(stacked(out), want),
             f"(c) {SERVE_PENDING} tickets pending across {name} resolved "
             f"bitwise against the state before it")
        served, _ = run(lambda: srv.predict(Uy))
        e = err2(served, yardstick)
        ok = e <= lim
        print(f"  (c) after {name}: served vs its phase 4d yardstick "
              f"{e:.3e} (limit {lim:.3e}){'' if ok else ' FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"(c) {name} drift {e}")

    r = STREAM_RETIRE
    swap("update", lambda: srv.update(ds.X[H:], ds.y[H:]), yard["cold"])
    swap(f"retire_machine({r})", lambda: srv.retire_machine(r),
         yard["retired"])
    swap(f"revive_machine({r})", lambda: srv.revive_machine(r),
         yard["streamed"])
    n_dd = sum(n["chol_downdate"] for n in swap_launches.values())
    readings["c"] = swap_s
    print(f"  [{card}] (c) through the server (pending tickets flushed "
          f"first): " + ", ".join(f"{k} {v:.4f} s {swap_launches[k]}"
                                 for k, v in swap_s.items()), flush=True)
    need(n_dd == 1 and swap_launches[f"retire_machine({r})"][
        "chol_downdate"] == 1, f"(c) chol_downdate launched once, by the "
                               f"retire (got {n_dd})")
    pitc_srv = srv

    # (d) checkpoints, in a directory the phase removes
    pic_store, _ = run(lambda: api.init_store(
        "ppic", spec, params, cold_pic["Xc"], cold_pic["yc"], S=S,
        runner=VmapRunner(M=M)))
    pic_model = api.FittedGP(api.get("ppic"), spec, params,
                             pic_store.to_state())
    pic_srv = GPServer(pic_model, spec=rspec, store=pic_store)
    Ud = Uh[order[:SERVE_HEAL_ROWS]]
    tmp = tempfile.TemporaryDirectory()
    files = {}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    for name, server, fresh_model, spec_ in (
            ("pPITC store", pitc_srv, pitc, sspec),
            ("pPIC store", pic_srv, pic, rspec)):
        path = os.path.join(tmp.name, name.replace(" ", "_") + ".npz")
        _, t_save = timed(lambda: server.checkpoint_store(path))
        fresh = GPServer(fresh_model, spec=spec_)
        _, t_load = timed(lambda: fresh.restore_store(path))
        files[name] = (path, os.path.getsize(path), t_save, t_load)
        a_, _ = run(lambda: server.predict(Ud))
        b_, _ = run(lambda: fresh.predict(Ud))
        need(bitwise(a_, b_), f"(d) {name}: restore_store into a fresh "
                              f"server serves bitwise the first server")
        if name == "pPITC store":
            spath = os.path.join(tmp.name, "pPITC_state.npz")
            _, t_s = timed(lambda: server.checkpoint(spath))
            _, t_l = timed(lambda: fresh.swap_from_checkpoint(spath))
            files["pPITC state"] = (spath, os.path.getsize(spath), t_s, t_l)
            c_, _ = run(lambda: fresh.predict(Ud))
            need(fresh.store is None and bitwise(a_, c_),
                 "(d) swap_from_checkpoint of a state detaches the store "
                 "and serves bitwise")
        del fresh
    pic_path = files["pPIC store"][0]
    reg = TenantRegistry()
    (t_adm, t_l), _ = run(lambda: timed(
        lambda: reg.admit_from_checkpoint("pic", pic_path)))
    a_, _ = run(lambda: pic_srv.predict(Ud))
    b_, _ = run(lambda: t_adm.plan.routed_diag(Ud))
    need(t_adm.spec == rspec and bitwise(a_, b_),
         f"(d) admit_from_checkpoint: an equal ServeSpec, bitwise "
         f"({t_l:.3f} s)")
    del reg, t_adm, pitc_srv
    readings["d"] = {k: dict(bytes=v[1], save_s=v[2], load_s=v[3])
                     for k, v in files.items()}
    print(f"  [{card}] (d) checkpoints: " + "; ".join(
        f"{k} {v[1]} bytes, save {v[2]:.3f} s, load {v[3]:.3f} s"
        for k, v in files.items()), flush=True)
    torch.cuda.empty_cache()

    # (e) self-healing: a poisoned block retired, served degraded, revived
    heal = GPServer(pic_model, spec=rspec, store=pic_store,
                    health=HealthPolicy(max_consecutive_failures=1,
                                        checkpoint=pic_path,
                                        revive_after_ms=0.0))
    heal.plan.warmup(D)

    def serve_rows():
        out = []
        for j in range(0, len(Ud), SERVE_MAX_BATCH):
            tks = [heal.submit(x) for x in Ud[j:j + SERVE_MAX_BATCH]]
            heal.flush()
            out += [heal.collect(k) for k in tks]
        return out

    before, _ = run(serve_rows)
    assign = clustering.nearest_center_np(Ud, heal.plan._centroids_host)
    k = int(np.bincount(assign, minlength=M).argmax())
    heal.swap_state(poison_state(heal.model.state, k))
    during, le = run(serve_rows)
    deg = np.array([bool(d) for _, _, d in during])
    need(heal.health.dead_blocks() == [k] and le["xcov_diag"] >= 1
         and np.array_equal(deg, assign == k) and finite(during),
         f"(e) block {k} poisoned: retired, its {int(deg.sum())} rows "
         f"served degraded through xcov_diag ({le['xcov_diag']} launches), "
         f"every ticket finite")
    (_, t_rev), _ = run(lambda: timed(heal.pump))
    after, _ = run(serve_rows)
    need(heal.stats.n_revives == 1 and heal.health.dead_blocks() == []
         and all(not d for _, _, d in after)
         and bitwise(stacked(before), stacked(after)),
         f"(e) revived from the checkpoint on pump ({t_rev:.3f} s): "
         f"bitwise the output before the poisoning")
    FaultInjector(FaultPlan(seed=0)).corrupt(pic_path)
    poisoned = poison_state(heal.model.state, k)
    heal.swap_state(poisoned)
    again, _ = run(serve_rows)
    run(heal.pump)
    s = heal.stats
    need(s.n_revive_failures == 1 and s.n_revives == 1
         and heal.health.dead_blocks() == [k]
         and heal.model.state is poisoned and finite(again),
         "(e) a corrupt checkpoint: the revive raised and counted "
         "CheckpointError, the file was not loaded, the block stays "
         "retired and every ticket is finite")
    readings["e"] = dict(revive_s=t_rev, n_retries=s.n_retries,
                         degraded_rows=s.n_degraded_rows)
    print(f"  [{card}] (e) health: {s.n_auto_retired} auto-retires, "
          f"{s.n_retries} retries, {s.n_degraded_rows} degraded rows, "
          f"{s.n_revives} revive ({t_rev:.3f} s, the {files['pPIC store'][1]}"
          f"-byte store), {s.n_revive_failures} refused", flush=True)
    tmp.cleanup()
    del heal, pic_srv, pic_store, pic_model
    torch.cuda.empty_cache()

    print(f"  counts of the serving path: {tally['serving']}; of the "
          f"yardsticks (plan.diag of each flush, the single-tenant "
          f"replays, the restored servers' checks): {tally['yardsticks']}",
          flush=True)
    for name, n in tally["serving"].items():
        if n <= 0:
            failures.append(f"kernel {name} was not launched on phase 4f's "
                            f"serving path")
    if failures:
        fail(f"phase 4f: {failures}")
    return dict(launches=tally["serving"], yardsticks=tally["yardsticks"],
                readings=readings)


# GP over processes (phase 4g). The machine axis spread over ranks:
# (a) every machine in this process (VmapRunner, the yardstick), (b) P = 4
# gloo ranks sharing the card, L = 5 machines each, (c) one NCCL rank
# holding all 20. Tolerance for float64 results across realizations, in
# units of 1 + |value|: the ranks add the machines' sums in another order,
# and the largest amplification on the path is Sdd's condition number,
# 2.4e9 at this configuration (phase 4 prints it), times float64's 2.2e-16:
# 5.3e-7; DIST_TOL leaves about 2x. A wrong machine, block or pivot errs by
# O(0.1). The float32 pPITC fit over ranks is held to phase 4's gates: test
# RMSE RMSE_AIMPEAK +- TOL_RMSE, and its served error against a float64 fit
# within 10 x the stacked float32 fit's own + 1e-4.
DIST_TOL = 1e-6
DIST_RANKS, DIST_LOCAL = 4, 5
DIST_JOIN_S = 600.0
DIST_R = S_SIZE             # pICF's rank, as phase 4c
# select_support's 8192 candidates do not divide among 20 machines: the
# collective selection runs over 16 (4 a rank), and its pivots do not
# depend on the blocking (the first index of the largest residual over the
# blocks in order is the argmax over all of them)
DIST_SELECT_M = 16


def dist_rel(torch, got, want) -> float:
    """max |got - want| / (1 + |want|) (0 for empty tensors)."""
    if got.shape != want.shape:
        return math.inf
    if got.numel() == 0:
        return 0.0
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (1 + w.abs())).max())


def _prefix(torch, a, b) -> int:
    """How many leading rows of a and b are equal."""
    same = (a == b).all(-1)
    bad = (~same).nonzero()
    return int(bad[0]) if bad.numel() else int(same.numel())


def dist_programs(torch, runner, sh: dict, *, select_runner) -> dict:
    """Phase 4g's programs over ``runner`` (the collective selection over
    ``select_runner``, DIST_SELECT_M machines), on the shared data ``sh``
    (phase 4's data, support set and hyperparameters). Returns name ->
    {"out": tensors, "s": wall seconds, "stats": the axis's collective
    calls and bytes a machine received}. Every output is the whole result
    on every process.

    pICF's factor is the collective pivot loop (``icf_factor_local``) on
    either axis, its pivot column rbf.cu's exact instance: float64, taken
    once, and both prediction layouts and the store come from it; float32
    end to end through ``api.fit`` over ranks, and on the stacked axis the
    same loop and store called by hand (a ``VmapRunner``'s pICF fit is
    one ICF kernel launch, which in float32 sums F[:i, p]'s products in
    another order). The selections likewise: float64 through
    ``select_support_parallel`` on both (the ICF kernel on the stacked
    axis, the loop over ranks), float32 the loop on both."""
    from repro_torch.core import api, covariance as cov, hyper, picf, ppic, \
        ppitc, support
    from repro_torch.parallel.collectives import ring_all_reduce
    spec = cov.make_spec("se")
    ax = runner.axis
    p32 = sh["params"]
    p64 = {k: v.double() for k, v in p32.items()}
    X64, y64, U64, S64 = (sh[k].double() for k in ("X", "y", "X_test", "S"))
    res = {}

    def run(name, fn):
        ax.reset_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res[name] = {"out": out, "s": time.perf_counter() - t,
                     "stats": dict(ax.stats)}

    def served(model, U):
        m, v = model.plan(api.ServeSpec(max_batch=256)).diag(U)
        return {"mean": m, "var": v}

    def fit64(method, **kw):
        model = api.fit(method, spec, p64, X64, y64, runner=runner, **kw)
        out = dict(model.state._asdict())
        if method == "ppitc":
            out.update({f"served.{k}": v
                        for k, v in served(model, U64).items()})
        return out

    run("ppitc.predict_distributed", lambda: ppitc.predict_distributed(
        spec, p64, S64, X64, y64, U64, runner)._asdict())
    run("ppitc.fit", lambda: fit64("ppitc", S=S64))
    run("ppitc.fit f32", lambda: served(api.fit(
        "ppitc", spec, p32, sh["X"], sh["y"], S=sh["S"], runner=runner),
        sh["X_test"]))
    run("ppic.predict_distributed", lambda: ppic.predict_distributed(
        spec, p64, S64, X64, y64, U64, runner)._asdict())
    run("ppic.fit", lambda: fit64("ppic", S=S64))

    Xb, yb = runner.shard_blocks(X64), runner.shard_blocks(y64)
    fac = {}

    def icf_local():
        fac["loc"] = picf.icf_factor_local(spec, p64, Xb, DIST_R,
                                           axis_name=ax)
        return {"F": runner.gather(fac["loc"].F),
                "pivots": fac["loc"].pivots[0]}
    run("picf.icf_factor_local", icf_local)
    F = fac["loc"].F
    run("picf.machine_step", lambda: dict(zip(("mean", "cov"), runner.map(
        lambda Xm, ym, Fm, q, U: picf.machine_step(
            spec, q, Xm, ym, U, Fm, axis_name=ax), (Xb, yb, F),
        (p64, U64)))))

    def sharded_u():
        mean, blocks = runner.gather(runner.map(
            lambda Xm, ym, Fm, q, Ub: picf.machine_step_sharded_u(
                spec, q, Xm, ym, Ub, Fm, axis_name=ax), (Xb, yb, F),
            (p64, runner.block_layout(U64))))
        return {"mean": runner.unshard(mean), "blocks": blocks}
    run("picf.machine_step_sharded_u", sharded_u)
    run("picf.store", lambda: dict(picf.init_picf_store(
        spec, p64, X64, y64, rank=DIST_R, runner=runner,
        local=fac.pop("loc")).to_state()._asdict()))
    del F

    def picf32():
        X, y = sh["X"], sh["y"]
        if ax.distributed:
            st = api.fit("picf", spec, p32, X, y, rank=DIST_R,
                         runner=runner).state
        else:
            local = picf.icf_factor_local(spec, p32, runner.shard_blocks(X),
                                          DIST_R, axis_name=ax)
            st = picf.init_picf_store(spec, p32, X, y, rank=DIST_R,
                                      runner=runner, local=local).to_state()
        return dict(st._asdict())
    run("picf.fit f32", picf32)

    cand = sh["X"][:ICF_CANDIDATES]
    sel = select_runner
    run("select_support_parallel", lambda: {"S": support.
        select_support_parallel(spec, p64, cand.double(), S_SIZE, sel)})

    def select32():
        if sel.axis.distributed:
            return {"S": support.select_support_parallel(spec, p32, cand,
                                                         S_SIZE, sel)}
        return {"S": picf.icf_factor_local(
            spec, p32, sel.shard_blocks(cand), S_SIZE,
            axis_name=sel.axis).pivots[0]}
    run("select_support_parallel f32", select32)

    def nlml():
        obj = lambda q: hyper.pitc_nlml(cov.make_kernel("se"), q, S64, X64,
                                        y64, runner)
        val, grads = hyper.value_and_grad(obj, p64, runner.reduce_grads)
        return {"nlml": val, **{f"grad.{k}": g for k, g in grads.items()}}
    run("hyper.pitc_nlml + grad", nlml)

    def axis_ops():
        n, dev = runner.num_machines, X64.device
        g = torch.Generator(device=dev).manual_seed(7)
        x = torch.randn((n * n, 64), generator=g, device=dev,
                        dtype=torch.float64)
        mine = runner.shard_blocks(x)                       # (L, M, 64)
        ring = [(i, (i + 1) % n) for i in range(n)]
        return {"psum_scatter": runner.gather(ax.psum_scatter(mine)),
                "all_gather": ax.all_gather(mine[:, 0]),
                "ppermute": runner.gather(ax.ppermute(mine[:, 0], ring)),
                "ring_all_reduce": runner.gather(ring_all_reduce(
                    mine[:, 0], ax, axis_size=n))}
    run("axis collectives", axis_ops)
    return res


# the programs whose outputs are held, field by field, within DIST_TOL of
# the stacked axis's (every one but the float32 pPITC fit, which phase 4's
# gates hold)
DIST_HELD = ("ppitc.predict_distributed", "ppitc.fit",
             "ppic.predict_distributed", "ppic.fit", "picf.icf_factor_local",
             "picf.machine_step", "picf.machine_step_sharded_u",
             "picf.store", "picf.fit f32", "select_support_parallel",
             "select_support_parallel f32", "hyper.pitc_nlml + grad",
             "axis collectives")
# outputs that must be equal: pivot inputs are copies of training rows
DIST_EXACT = {("picf.icf_factor_local", "pivots"),
              ("select_support_parallel", "S"),
              ("select_support_parallel f32", "S")}


def dist_check(torch, res: dict, yard: dict, sh: dict) -> dict:
    """Errors of one realization's results against the stacked one's:
    per program the largest relative error (or pivot equality), and the
    float32 fit's RMSE and served error against the float64 fit."""
    out = {}
    for name, r in res.items():
        row = {"s": r["s"], "stats": r["stats"]}
        if name in DIST_HELD:
            want = yard[name]
            errs = {}
            for k, v in r["out"].items():
                if (name, k) in DIST_EXACT:
                    errs[k] = 0.0 if torch.equal(v, want[k]) else math.inf
                else:
                    errs[k] = dist_rel(torch, v, want[k])
            row["err"] = max(errs.values())
            row["worst"] = max(errs, key=errs.get)
        out[name] = row
    served = res["ppitc.fit f32"]["out"]
    y = sh["y_test"]
    out["rmse32"] = float(torch.sqrt(torch.mean((served["mean"] - y) ** 2)))
    truth = yard["ppitc.fit"]
    out["err32"] = max(
        float((served["mean"].double() - truth["served.mean"]).abs().max()),
        float((served["var"].double() - truth["served.var"]).abs().max()))
    return out


def _dist_rank(rank, world, backend, local, rdv, sh, q):
    """One rank of phase 4g (b) or (c): joins the process group, runs the
    programs over a ShardMapRunner of ``local`` machines, holds them
    against the stacked results in ``sh`` (shared from the parent through
    CUDA IPC) and puts its readings on ``q``. Loads the kernels phase 2
    built; never runs nvcc."""
    import traceback
    import torch
    import torch.distributed as dist
    try:
        from repro_torch.kernels import build
        missing = [n for n in build.sources() if not build.target(n).exists()]
        if missing:
            raise RuntimeError(f"kernels {missing} are not built: phase 2 "
                               f"builds them, a rank only loads them")
        from repro_torch.kernels.rbf import ops
        from repro_torch.launch import mesh as tmesh
        from repro_torch.parallel.runner import ShardMapRunner
        dev = torch.device("cuda", 0)
        mesh = tmesh.make_mesh((world,), ("data",), rank=rank,
                               world_size=world, init_method=f"file://{rdv}",
                               backend=backend, device=dev,
                               timeout_s=DIST_JOIN_S)
        sm = ShardMapRunner(mesh=mesh, axis_name="data",
                            local_machines=local)
        sel = ShardMapRunner(mesh=mesh, axis_name="data",
                             local_machines=DIST_SELECT_M // world)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        res = dist_programs(torch, sm, sh, select_runner=sel)
        launches = {"rbf": ops.rbf_launches,
                    "rbf_exact": ops.rbf_exact_launches,
                    "icf": ops.icf_launches, "xcov_diag": ops.xcov_launches}
        out = dist_check(torch, res, sh["yard"], sh)
        del res
        out.update(launches=launches, backend=sm.axis.backend,
                   table=sm.axis.table,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        q.put((rank, out, None))
    except Exception:
        q.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        # drop the parent's tensors (CUDA IPC): the process's arguments
        # keep ``sh`` alive to the exit, where nothing releases them, and
        # the parent then keeps their blocks allocated
        import gc
        sh.clear()
        gc.collect()


def dist_spawn(torch, world: int, backend: str, local: int, sh: dict,
               tmp: str) -> dict:
    """Spawn ``world`` ranks of ``_dist_rank`` and collect their readings;
    a rank's exception, or no answer within DIST_JOIN_S, fails the run."""
    import queue
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    rdv = f"{tmp}/{backend}{world}.rdv"
    procs = [ctx.Process(target=_dist_rank, args=(
        r, world, backend, local, rdv, sh, q)) for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + DIST_JOIN_S
    try:
        while len(got) + len(errors) < world:
            try:
                rank, out, tb = q.get(timeout=max(
                    0.1, min(5.0, deadline - time.monotonic())))
            except queue.Empty:
                if time.monotonic() > deadline or not any(
                        p.is_alive() for p in procs):
                    break
                continue
            if tb is None:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{tb}")
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        fail(f"phase 4g ({backend}, {world} ranks): a rank raised:\n"
             + "\n".join(errors))
    if len(got) < world:
        fail(f"phase 4g ({backend}, {world} ranks): only ranks "
             f"{sorted(got)} answered within {DIST_JOIN_S:.0f} s; exit "
             f"codes {[p.exitcode for p in procs]}")
    return got


def _table1(name: str, stats: dict, M: int, u: int) -> str:
    """A program's collectives (calls, bytes a machine received) beside the
    paper's Table 1 term for it (float64 values)."""
    s, R = S_SIZE, DIST_R
    ops = sorted({k.split(":")[0] for k in stats})
    got = ", ".join(f"{op} {stats[op + ':calls']}x {stats[op + ':bytes']:,} B"
                    for op in ops)
    terms = {
        "ppitc.predict_distributed": f"|S|^2 + |S| = {8 * (s * s + s):,} B",
        "ppic.predict_distributed": f"|S|^2 + |S| = {8 * (s * s + s):,} B",
        "picf.machine_step":
            f"Remark after Def. 7, replicated U: R(R+1+|U|) = "
            f"{8 * R * (R + 1 + u):,} B",
        "picf.machine_step_sharded_u":
            f"sharded U: R(R+1) + R|U|/M = "
            f"{8 * (R * (R + 1) + R * u // M):,} B",
        "picf.icf_factor_local": f"R(M + d) + R(R-1)/2 = "
                                 f"{8 * (R * (M + D) + R * (R - 1) // 2):,} B",
    }
    return f"{got or 'none'}" + (f"; Table 1: {terms[name]}"
                                 if name in terms else "")


def dist_path(torch, card: str, ds, spec, params, S) -> dict:
    """Phase 4g: the GP programs over processes; returns the rbf row's
    fields (launches_dist and the readings)."""
    import tempfile
    from repro_torch.core import api, picf, ppitc
    from repro_torch.kernels.rbf import ops
    from repro_torch.parallel import runner as prunner
    from repro_torch.parallel.runner import VmapRunner

    print(f"  backend table (the constant parallel/runner.py BACKEND_TABLE; "
          f"its gloo-on-CUDA row as python -m repro_torch.launch."
          f"backend_probe read it under {prunner.GLOO_CUDA_READ_ON}; this "
          f"run has torch {torch.__version__}):", flush=True)
    for row in prunner.backend_table():
        note = f" ({row['note']})" if "note" in row else ""
        print(f"    {row['backend']:5s} {row['device']:4s} "
              f"{row['op']:14s} {row['realization']}{note}", flush=True)

    sh = {"X": ds.X, "y": ds.y, "X_test": ds.X_test, "y_test": ds.y_test,
          "S": S, "params": params}
    u = ds.X_test.shape[0]

    # (a) the stacked axis: every machine here
    vm = VmapRunner(M=M)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    res_a = dist_programs(torch, vm, sh,
                          select_runner=VmapRunner(M=DIST_SELECT_M))
    launches_a = {"rbf": ops.rbf_launches,
                  "rbf_exact": ops.rbf_exact_launches,
                  "icf": ops.icf_launches}
    yard = {k: r["out"] for k, r in res_a.items()}
    own = yard["ppitc.fit f32"]
    truth = yard["ppitc.fit"]
    own_err = max(float((own["mean"].double() - truth["served.mean"])
                        .abs().max()),
                  float((own["var"].double() - truth["served.var"])
                        .abs().max()))
    rmse_a = float(torch.sqrt(torch.mean((own["mean"] - ds.y_test) ** 2)))
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    for name, r in res_a.items():
        print(f"  (a) [{card}] {name}: {r['s']:.3f} s; "
              f"{_table1(name, r['stats'], M, u)}", flush=True)
    for name, r in res_a.items():
        for k, v in r["out"].items():
            if v.is_floating_point() and not torch.isfinite(v).all():
                fail(f"phase 4g (a) {name}: non-finite {k}")

    # the VmapRunner's own pICF route, one launch of the ICF kernel: its
    # factor against the collective loop's (float64: pivots identical, F
    # within DIST_TOL) and its fitted state against the store from the
    # loop's factor
    p64 = {k: v.double() for k, v in params.items()}
    X64 = ds.X.double()
    n0 = ops.icf_launches
    kern = picf.factor(spec, p64, X64, DIST_R, vm)
    if ops.icf_launches - n0 != 1:
        fail("phase 4g (a): the ICF kernel's factor took "
             f"{ops.icf_launches - n0} launches")
    loop = yard["picf.icf_factor_local"]
    same = bool(torch.equal(loop["pivots"], kern.pivots[0]))
    f_err = dist_rel(torch, loop["F"], kern.F)
    del kern
    st = api.fit("picf", spec, p64, X64, ds.y.double(), rank=DIST_R,
                 runner=vm).state
    st_err = max(dist_rel(torch, getattr(st, k), yard["picf.store"][k])
                 for k in st._fields)
    del st
    print(f"  (a) icf_factor_local (32000, {DIST_R}, {D}) f64 on the stacked "
          f"axis (pivot columns from rbf.cu's exact instance) vs the ICF "
          f"kernel's factor (one launch): pivots identical {same}, F within "
          f"{f_err:.3e} of 1 + |value|; the VmapRunner's pICF fit (the ICF "
          f"kernel) vs the store from the loop's factor: {st_err:.3e}",
          flush=True)
    if not (same and f_err <= DIST_TOL and st_err <= DIST_TOL):
        fail(f"phase 4g (a): the collective ICF loop's pivots identical "
             f"{same}, F error {f_err}, state error {st_err} (limit "
             f"{DIST_TOL})")
    agree32 = _prefix(torch, yard["select_support_parallel f32"]["S"], S)
    print(f"  (a) float32: the collective selection (the stacked loop) "
          f"agrees with phase 4's S (the float32 ICF kernel) for {agree32} "
          f"of {S_SIZE} steps; not gated: the kernel sums F[:i, p]'s "
          f"products in another order, and the two part at the first near "
          f"tie (the ranks are held to the stacked loop, bit for bit)",
          flush=True)

    # float32 on the stacked axis: the reference's formed-Sdd Cholesky,
    # and pICF with float32 data and the float64 R-space
    U32 = ds.X_test
    post = ppitc.predict_distributed(spec, params, S, ds.X, ds.y, U32, vm)
    nan32 = bool(torch.isnan(post.mean).any())
    print(f"  (a) ppitc.predict_distributed float32 (Sdd formed, then "
          f"Cholesky, the reference's form): NaN {nan32}", flush=True)
    for name, fn in (("predict_distributed", lambda: picf.predict_distributed(
            spec, params, ds.X, ds.y, U32, DIST_R, vm)),
                     ("predict shard_u", lambda: picf.predict(
                         spec, params, ds.X, ds.y, U32, DIST_R, vm,
                         shard_u=True))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        post = fn()
        torch.cuda.synchronize()
        var = post.var if hasattr(post, "blocks") else torch.diagonal(
            post.cov)
        rm = float(torch.sqrt(torch.mean((post.mean - ds.y_test) ** 2)))
        finite = bool(torch.isfinite(post.mean).all()
                      and torch.isfinite(var).all())
        print(f"  (a) [{card}] picf.{name} f32 data, f64 R-space: "
              f"{time.perf_counter() - t:.3f} s, finite {finite}, RMSE "
              f"{rm:.4f}, negative-variance share "
              f"{float((var < 0).double().mean()):.3f}", flush=True)
        if not finite:
            fail(f"phase 4g (a) picf.{name} float32: non-finite output")
    del post
    print(f"  (a) float32 pPITC fit served: RMSE {rmse_a:.4f}, its error "
          f"against the float64 fit {own_err:.3e}; rbf launches "
          f"{launches_a['rbf']} block, {launches_a['rbf_exact']} exact "
          f"(pivot columns), {launches_a['icf']} ICF; peak {peak_a:.2f} GB",
          flush=True)
    del res_a
    torch.cuda.empty_cache()

    sh["yard"] = yard
    limit32 = 10 * own_err + 1e-4
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, world, backend, local in (
                ("b", DIST_RANKS, "gloo", DIST_LOCAL), ("c", 1, "nccl", M)):
            t = time.perf_counter()
            got = dist_spawn(torch, world, backend, local, sh, tmp)
            wall = time.perf_counter() - t
            print(f"  ({tag}) {world} {backend} rank(s) on cuda:0, {local} "
                  f"machines each: {wall:.1f} s from spawn to the last "
                  f"reading", flush=True)
            readings[tag] = {"launches": [], "launches_exact": [],
                             "peak_gb": [], "wall_s": wall}
            for rank in sorted(got):
                out = got[rank]
                readings[tag]["launches"].append(out["launches"]["rbf"])
                readings[tag]["launches_exact"].append(
                    out["launches"]["rbf_exact"])
                readings[tag]["peak_gb"].append(out["peak_gb"])
                for name in out:
                    r = out[name]
                    if not isinstance(r, dict) or "s" not in r:
                        continue
                    err = (f", max err {r['err']:.3e} of 1 + |value| "
                           f"({r['worst']})" if "err" in r else "")
                    if rank == 0:
                        print(f"  ({tag}) [{card}] rank 0 {name}: "
                              f"{r['s']:.3f} s{err}; "
                              f"{_table1(name, r['stats'], M, u)}",
                              flush=True)
                    if r.get("err", 0.0) > DIST_TOL:
                        fail(f"phase 4g ({tag}) rank {rank} {name}: "
                             f"{r['worst']} errs {r['err']} > {DIST_TOL}")
                ok32 = (abs(out["rmse32"] - RMSE_AIMPEAK) <= TOL_RMSE
                        and out["err32"] <= limit32)
                print(f"  ({tag}) rank {rank}: float32 pPITC fit over the "
                      f"ranks served RMSE {out['rmse32']:.4f}, error vs "
                      f"the float64 fit {out['err32']:.3e} (limit "
                      f"{limit32:.3e}); rbf launches "
                      f"{out['launches']['rbf']} block, "
                      f"{out['launches']['rbf_exact']} exact, ICF "
                      f"{out['launches']['icf']}, xcov_diag "
                      f"{out['launches']['xcov_diag']}; peak "
                      f"{out['peak_gb']:.2f} GB; collectives {out['backend']}"
                      f" {out['table']}", flush=True)
                if not ok32:
                    fail(f"phase 4g ({tag}) rank {rank}: float32 fit RMSE "
                         f"{out['rmse32']}, error {out['err32']} > "
                         f"{limit32}")
                if out["launches"]["rbf"] <= 0 \
                        or out["launches"]["rbf_exact"] <= 0:
                    fail(f"phase 4g ({tag}) rank {rank}: rbf launches "
                         f"{out['launches']}")
    del sh["yard"], yard
    # the blocks shared with the ranks stay allocated until collected
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    return {"launches_dist": {"gloo_4_ranks": readings["b"]["launches"],
                              "nccl_1_rank": readings["c"]["launches"][0]},
            "launches_dist_exact": {
                "gloo_4_ranks": readings["b"]["launches_exact"],
                "nccl_1_rank": readings["c"]["launches_exact"][0]},
            "dist_peak_gb": {"stacked": peak_a, **{
                k: v["peak_gb"] for k, v in readings.items()}},
            "dist_wall_s": {k: v["wall_s"] for k, v in readings.items()}}


def fit_spread(torch, card: str, ds, spec, params, S) -> list:
    """Phase 4's pPITC fit run FIT_REPEAT more times, each traced for the
    device's busy time, then once more for its largest kernels: the fit's
    spread within one process, and whether a slow fit waited on the host
    or on the device. It runs after the phases whose kernel timings read
    traces: with it in phase 4, phase 4c's traces of the ICF kernel lost
    kernels. Returns the (wall, busy) pairs in seconds."""
    from repro_torch.core import api
    from repro_torch.launch import profile
    from repro_torch.parallel.runner import VmapRunner
    from torch.profiler import ProfilerActivity

    def refit():
        api.fit("ppitc", spec, params, ds.X, ds.y, S=S,
                runner=VmapRunner(M=M))

    pairs = []
    for _ in range(FIT_REPEAT):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            refit()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        pairs.append((round(wall, 4),
                      round(profile.busy_us(profile.kernels(prof)) / 1e6, 4)))
    print(f"  [{card}] pPITC api.fit x{FIT_REPEAT}, traced, (wall, device "
          f"busy) s: {pairs}", flush=True)
    profile.report(f"  [{card}] pPITC api.fit traced once more", refit)
    return pairs


def _launch_counts(counters) -> dict:
    return {name: getattr(mod, attr) for mod, attr, name in counters}


def train_path(torch, card: str, cfg, counters, *, batch: int,
               microbatches: int, resume: bool = False) -> dict:
    """LM training through the port's entry points (``launch.train``:
    ``init_state``, ``make_train_step``, ``TokenLoader``) at ``cfg``'s full
    width and depth: a warm-up step, then TRAIN_STEPS timed steps, each
    with its loss (finite), seconds, tokens/s and the launches of the
    forward and backward kernels (``counters``: (module, count, kernel
    name) of each), which must be the attention or SSD layers x
    microbatches for the backward and twice that for the forward (remat
    runs each period's forward again); a third counter, where given, is a
    route of the backward that every backward launch must take. Then one
    more step under ``torch.profiler`` (``launch.train_profile``: the
    backward kernels' share of device time). With ``resume``: the state
    at step 2 goes through a ``CheckpointManager`` (async save), the next
    step is retaken from the restored state and must give the same
    bits."""
    import tempfile
    from repro_torch.checkpoint import io
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.loader import TokenLoader
    from repro_torch.launch import train
    from repro_torch.optim.adam import Adam, tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = Adam(lr=TRAIN_LR)
    t0 = time.perf_counter()
    state = train.init_state(
        cfg, opt, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"  [{card}] {cfg.name} training state: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B float32 parameters with "
          f"Adam's moments, {torch.cuda.memory_allocated() / 1e9:.2f} GB, "
          f"init {time.perf_counter() - t0:.2f} s", flush=True)
    step, _ = train.make_train_step(cfg, None, opt,
                                    microbatches=microbatches, remat=True)
    loader = TokenLoader(cfg, batch=batch, seq=LM_SEQ, seed=0)
    batches = [next(loader) for _ in range(1 + TRAIN_STEPS)]
    kind = cfg.plan()[0].kind
    n_kind = sum(d.kind == kind for d in cfg.plan())
    full = cfg.n_layers // cfg.period * cfg.period
    n_remat = sum(d.kind == kind for d in cfg.plan()[:full])
    want_bwd = n_kind * microbatches
    want_fwd = (n_kind + n_remat) * microbatches
    fwd_name, bwd_name = counters[0][2], counters[1][2]

    tmp = tempfile.TemporaryDirectory() if resume else None
    mgr = CheckpointManager(tmp.name, keep=2) if resume else None
    losses, secs, per_step = [], [], []
    saved = None
    for mod in {c[0] for c in counters}:
        mod.reset_counts()
    for i, b in enumerate(batches):
        if resume and int(state.step) == 2:
            t1 = time.perf_counter()
            mgr.save(2, state, sync=False)
            snap_s = time.perf_counter() - t1
            mgr.wait()
            save_s = time.perf_counter() - t1
            saved = dict(batch=b, save_s=save_s, snapshot_s=snap_s,
                         bytes=(Path(tmp.name) / "ckpt_0000000002.msgpack")
                         .stat().st_size)
        c0 = _launch_counts(counters)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        c1 = _launch_counts(counters)
        per_step.append({k: c1[k] - c0[k] for k in c1})
        if saved is not None and "after" not in saved:
            saved["after"] = state
        if i:
            secs.append(dt)
            losses.append(float(m.loss))
        if not math.isfinite(float(m.loss)):
            fail(f"{cfg.name} training: step {i} loss {float(m.loss)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = _launch_counts(counters)
    toks = batch * LM_SEQ
    p50 = sorted(secs)[len(secs) // 2]
    print(f"  [{card}] {cfg.name} training, batch {batch} x {LM_SEQ} tokens "
          f"({microbatches} microbatch{'es' if microbatches > 1 else ''}), "
          f"remat: step s {', '.join(f'{x:.3f}' for x in secs)} (p50 "
          f"{p50:.3f} s, {toks / p50:.0f} tokens/s); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    print(f"  {cfg.name} launches a step (warm-up first): "
          f"{per_step}; want {fwd_name} {want_fwd} ({n_kind} {kind} layers "
          f"x {microbatches}, twice: remat), {bwd_name} {want_bwd}",
          flush=True)
    for n, d in enumerate(per_step):
        if d[bwd_name] != want_bwd or d[fwd_name] != want_fwd or any(
                d[c[2]] != want_bwd for c in counters[2:]):
            fail(f"{cfg.name} training step {n}: launches {d}, want "
                 f"{fwd_name} {want_fwd} and {bwd_name} {want_bwd}"
                 + "".join(f", {c[2]} {want_bwd}" for c in counters[2:]))
    from repro_torch.launch.train_profile import report, trace_step
    state, traced = trace_step(step, state, batches[-1])
    report(f"  [{card}] {cfg.name} training step traced (one more, on the "
           f"last batch)", traced)
    out = dict(launches=launches, step_s=secs, tokens_per_s=toks / p50,
               losses=losses, peak_gb=peak_gb,
               trace={k: v for k, v in traced.items() if k != "top"})
    if resume:
        t1 = time.perf_counter()
        back = mgr.restore(2, state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        if int(back.step) != 2:
            fail(f"{cfg.name} resume: restored step {int(back.step)}")
        again, _ = step(back, saved["batch"])
        torch.cuda.synchronize()
        diff = [k for (k, a), (_, b) in zip(
            io.flatten(again), io.flatten(saved["after"]))
            if not torch.equal(a, b)]
        print(f"  [{card}] {cfg.name} resume: state at step 2 "
              f"{saved['bytes']:,} bytes, async save {saved['save_s']:.3f} s "
              f"(host snapshot {saved['snapshot_s']:.3f} s), restore "
              f"{load_s:.3f} s; the step retaken from it equals the first "
              f"{'bit for bit' if not diff else 'NOT: ' + str(diff[:5])}",
              flush=True)
        if diff:
            fail(f"{cfg.name} resume: {len(diff)} leaves differ after the "
                 f"retaken step, first {diff[:5]}")
        tmp.cleanup()
        out.update(ckpt_bytes=saved["bytes"], save_s=saved["save_s"],
                   load_s=load_s)
    return out


def train_card_vs_cpu(torch, card: str) -> None:
    """One gradient of the float32 loss (remat on) at smoke width, on the
    card through the kernels and on the CPU through the plain versions:
    qwen3-1.7b's (the f32 flash instances) and mamba2-130m's (the SSD
    kernels); loss and every gradient leaf within TOL_TRAIN_*."""
    import numpy as np
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data import synthetic
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adam import tree_leaves, tree_map

    for name, mod, fwd, bwd in (
            ("qwen3-1.7b", attn_ops, "flash_launches", "flash_bwd_launches"),
            ("mamba2-130m", ssd_ops, "ssd_launches", "ssd_bwd_launches")):
        cfg = smoke_config(name)
        params = tf.init_model(cfg, generator=torch.Generator()
                               .manual_seed(0), device="cpu")
        toks = synthetic.lm_tokens(np.random.default_rng(0), batch=2,
                                   seq=64, vocab=cfg.vocab)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

        def loss(p, b):
            return tf.lm_loss(p, b["tokens"], b["labels"], cfg,
                              compute_dtype=torch.float32, remat=True)

        (l_cpu, _), g_cpu = train.value_and_grad(loss, params, batch)
        mod.reset_counts()
        on = lambda t: t.to("cuda")
        (l_gpu, _), g_gpu = train.value_and_grad(
            loss, tree_map(on, params), {k: on(v) for k, v in batch.items()})
        torch.cuda.synchronize()
        n_fwd, n_bwd = getattr(mod, fwd), getattr(mod, bwd)
        l_err = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
        worst = max(max_err(a.cpu(), b) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)))
        print(f"  [{card}] {cfg.name} float32 gradient, card vs CPU: loss "
              f"{float(l_gpu):.6f} vs {float(l_cpu):.6f} (rel {l_err:.2e}, "
              f"tol {TOL_TRAIN_LOSS}); worst leaf max|err| / max|g| "
              f"{worst:.2e} (tol {TOL_TRAIN_GRAD}); launches on the card "
              f"{fwd} {n_fwd}, {bwd} {n_bwd}", flush=True)
        if n_fwd <= 0 or n_bwd <= 0:
            fail(f"{cfg.name} card-vs-CPU gradient: the kernels were not "
                 f"launched ({n_fwd}, {n_bwd})")
        if not (l_err <= TOL_TRAIN_LOSS and worst <= TOL_TRAIN_GRAD):
            fail(f"{cfg.name} card and CPU gradients disagree: loss {l_err}, "
                 f"leaf {worst}")


def training(torch, card: str, attn_ops, ssd_ops) -> tuple[dict, dict]:
    """Phase 8: qwen3-1.7b and mamba2-130m training runs, then the card's
    float32 gradient against the CPU's."""
    from repro_torch.configs.registry import get_config
    print(f"  reduced: qwen3-1.7b global batch {TRAIN_QWEN['full_batch']} -> "
          f"{TRAIN_QWEN['batch']} ({TRAIN_QWEN['microbatches']} microbatches "
          f"of {TRAIN_QWEN['batch'] // TRAIN_QWEN['microbatches']}), seq "
          f"{LM_SEQ}; width and depth whole", flush=True)
    qwen_train = train_path(
        torch, card, get_config("qwen3-1.7b"),
        [(attn_ops, "flash_launches", "flash_attention"),
         (attn_ops, "flash_bwd_launches", "flash_attention_bwd"),
         (attn_ops, "flash_bwd_sm90_launches", "flash_attention_bwd wgmma")],
        batch=TRAIN_QWEN["batch"], microbatches=TRAIN_QWEN["microbatches"])
    torch.cuda.empty_cache()
    mamba_train = train_path(
        torch, card, get_config("mamba2-130m"),
        [(ssd_ops, "ssd_launches", "ssd_intra_chunk"),
         (ssd_ops, "ssd_bwd_launches", "ssd_intra_chunk_bwd")],
        batch=TRAIN_MAMBA["batch"], microbatches=TRAIN_MAMBA["microbatches"],
        resume=True)
    torch.cuda.empty_cache()
    train_card_vs_cpu(torch, card)
    return qwen_train, mamba_train


# ---------------------------------------------------------------------------
# Phase 9: the continuous batcher (launch.scheduler) on the card. Each
# request's tokens must equal prefill_then_decode's greedy tokens for it
# alone (batch 1, the same max_len, cut at EOS) bit for bit: the calls and
# shapes are the same, so any difference is a fault.
# ---------------------------------------------------------------------------
BATCHER_SLOTS, BATCHER_MAX_LEN, BATCHER_REQUESTS = 4, 128, 8
BATCHER_PROMPT, BATCHER_NEW = (8, 48), (8, 32)     # inclusive ranges


def batcher_requests(cfg, seed: int = 0) -> list:
    """(prompt, max_new) of each request, from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(BATCHER_REQUESTS):
        n = int(rng.integers(BATCHER_PROMPT[0], BATCHER_PROMPT[1] + 1))
        new = int(rng.integers(BATCHER_NEW[0], BATCHER_NEW[1] + 1))
        out.append((rng.integers(0, cfg.vocab, n).tolist(), new))
    return out


def _alone(torch, params, cfg, prompt: list, n: int, eos) -> list:
    """``prefill_then_decode``'s n greedy tokens for ``prompt`` alone, cut
    after the first ``eos``."""
    from repro_torch.launch import serve
    toks = torch.tensor([prompt], dtype=torch.long, device="cuda")
    out = serve.prefill_then_decode(params, toks, cfg,
                                    max_len=BATCHER_MAX_LEN,
                                    n_decode=n)[0, len(prompt):].tolist()
    return out[:out.index(eos) + 1] if eos in out else out


def _logit_gap(torch, params, cfg, prompt: list, want: list, i: int,
               got: int) -> float:
    """The alone run's logit of its token i minus that of the batcher's
    token there (its decode steps replayed)."""
    from repro_torch.models import transformer as tf
    state = tf.init_serve(cfg, 1, BATCHER_MAX_LEN)
    for tok in prompt + want[:i]:
        logits, state = tf.decode_step(params, torch.tensor(
            [[tok]], device="cuda"), state, cfg)
    last = logits[0, -1].float()
    return float(last[want[i]] - last[got])


def batcher_path(torch, card: str, name: str, attn_ops) -> dict:
    """Phase 9 for one model at full width and depth (random weights, seed
    0, bf16 compute)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.scheduler import ContinuousBatcher, Request

    cfg = get_config(name)
    params, _ = init_lm(torch, card, cfg)
    reqs = batcher_requests(cfg)
    # EOS: the token request 0's greedy run alone emits midway
    first = _alone(torch, params, cfg, reqs[0][0], reqs[0][1], None)
    eos = first[len(first) // 2]
    b = ContinuousBatcher(params, cfg, slots=BATCHER_SLOTS,
                          max_len=BATCHER_MAX_LEN, eos_id=eos)
    for rid, (prompt, new) in enumerate(reqs):
        b.submit(Request(rid, list(prompt), max_new=new))
    attn_ops.reset_counts()
    done_at, ticks, steps = {}, 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while b.queue or any(not s.free for s in b.slots):
        steps += b.tick()
        ticks += 1
        for r in b.finished[len(done_at):]:
            done_at[r.rid] = (ticks, (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash = attn_ops.flash_sm90_launches
    n_attn = sum(d.kind == "attn" for d in cfg.plan())
    generated = sum(len(r.out) for r in b.finished)
    lat_ms = sorted(ms for _, ms in done_at.values())
    lat_t = sorted(t for t, _ in done_at.values())
    print(f"  [{card}] {name} batcher: {BATCHER_REQUESTS} requests "
          f"(prompts {[len(p) for p, _ in reqs]}, max_new "
          f"{[n for _, n in reqs]}), {BATCHER_SLOTS} slots, max_len "
          f"{BATCHER_MAX_LEN}, eos_id {eos}: {ticks} ticks, {steps} decode "
          f"steps, {generated} tokens generated in {wall:.3f} s "
          f"({generated / wall:.1f} generated tokens/s)", flush=True)
    print(f"  [{card}] {name} latency from submit, ticks / ms by request: "
          + ", ".join(f"{rid}: {done_at[rid][0]} / {done_at[rid][1]:.1f}"
                      for rid in sorted(done_at))
          + f"; p50 {lat_t[len(lat_t) // 2]} ticks / "
          f"{lat_ms[len(lat_ms) // 2]:.1f} ms, max {lat_t[-1]} / "
          f"{lat_ms[-1]:.1f} ms; finish order "
          f"{[r.rid for r in b.finished]}", flush=True)
    if n_attn:
        print(f"  {name} flash_sm90 launches in the batcher's run: {flash} "
              f"(want {n_attn} x {steps} decode steps = {n_attn * steps})",
              flush=True)
        if flash != n_attn * steps:
            fail(f"{name} batcher: {flash} flash_sm90 launches for {steps} "
                 f"decode steps of {n_attn} attention layers")
    on_eos, bad = [], []
    for r in sorted(b.finished, key=lambda r: r.rid):
        prompt, new = reqs[r.rid]
        want = first if r.rid == 0 else _alone(torch, params, cfg, prompt,
                                               len(r.out), eos)
        want = want[:len(r.out)] if r.rid == 0 else want
        if r.out != want:
            i = next((j for j, (x, y) in enumerate(zip(r.out, want))
                      if x != y), min(len(r.out), len(want)))
            gap = (_logit_gap(torch, params, cfg, prompt, want, i, r.out[i])
                   if i < min(len(r.out), len(want)) else float("nan"))
            bad.append(f"request {r.rid}: first difference at token {i} "
                       f"(batcher {r.out[i:i + 1]}, alone {want[i:i + 1]}; "
                       f"lengths {len(r.out)} / {len(want)}), logit gap "
                       f"there {gap:.4e}")
        if r.out and r.out[-1] == eos and len(r.out) < new:
            on_eos.append(r.rid)
    print(f"  {name}: each request's tokens against prefill_then_decode "
          f"alone: {'bitwise equal' if not bad else 'DIFFER'}; ended on EOS: "
          f"requests {on_eos}", flush=True)
    if bad:
        fail(f"{name} batcher differs from prefill_then_decode alone: "
             + "; ".join(bad))
    if not on_eos:
        fail(f"{name} batcher: no request ended on eos_id {eos}")
    del params
    torch.cuda.empty_cache()
    return {"tokens_per_s": generated / wall, "ticks": ticks, "steps": steps,
            "latency_ms": [done_at[i][1] for i in sorted(done_at)],
            "flash_sm90_launches": flash}


# ---------------------------------------------------------------------------
# Phase 10: the LM's steps over a DeviceMesh. (a) one NCCL rank, mesh (1, 1)
# ("data", "model"): every collective is the identity, so on_mesh and the
# sharded serve step must be bitwise the one-process steps. (b) four gloo
# ranks sharing the card, mesh (2, 2), float32 compute, against the
# one-process step on the card:
#  the train step: the loss within phase 8's card-vs-CPU 1e-5 relative;
#  each leaf of Adam's moments (0.1 g and 0.001 g^2 after one step: the
#  gradient) within phase 8's 1e-4 of its max, or within 10x the
#  one-process step's own spread where that is larger: the same step with
#  2 microbatches against 1, on the same batch, sums the rows in another
#  order, as the ranks do (on an NVIDIA H100 80GB HBM3 at 700 W, a mamba2
#  leaf's moment moved by 3.3e-4 of its max against the one-process step,
#  qwen3's worst by 4.8e-6); the parameters by their update (Adam's first
#  is lr g / (|g| + eps), within 2 lr of any other, so a limit on the
#  parameters alone could not fail): where mu settles the sign of g, the
#  update's sign and size within 0.1 lr (``_update_agrees``), on at least
#  MESH_HELD_MIN of the elements;
#  the serve step's logits within MESH_TOL_LOGITS of max|logit| over the
#  vocabulary: the ranks' products run over 2 of 4 rows and half the
#  heads' or vocabulary's columns, so cuBLAS may sum in other orders
#  (~sqrt(K) eps relative, K <= 2048: 3e-6 a product); 1e-4 leaves 30x
#  over two layers (mamba2: 24), and a wrong head, row or rank errs by the
#  logits' own size.
# ---------------------------------------------------------------------------
MESH_QWEN_LAYERS = 4        # 10a: qwen3 28 -> 4 layers, two states fit
MESH_STEPS = 2
MESH_SERVE_B, MESH_SERVE_STEPS = 4, 16
MESH_GLOO = dict(world=4, shape=(2, 2), qwen_layers=2, batch=4, seq=512,
                 serve_steps=4)
MESH_TOL_LOGITS = 1e-4
MESH_HELD_MIN = 0.01        # the share of parameters 10b's update check holds
MESH_JOIN_S = 300.0


def _mesh_counts(attn_ops, ssd_ops) -> dict:
    return {"flash": attn_ops.flash_launches,
            "flash_bwd": attn_ops.flash_bwd_launches,
            "ssd": ssd_ops.ssd_launches, "ssd_bwd": ssd_ops.ssd_bwd_launches}


def _mesh_reset(attn_ops, ssd_ops) -> None:
    attn_ops.reset_counts()
    ssd_ops.reset_counts()


def mesh_train_one_rank(torch, card, mesh, cfg, *, batch: int,
                        microbatches: int, attn_ops, ssd_ops) -> dict:
    """10a: ``on_mesh``'s MESH_STEPS steps against ``train_step``'s from
    the same state, bitwise (losses, metrics, every leaf)."""
    from repro_torch.data.loader import TokenLoader
    from repro_torch.launch import train
    from repro_torch.optim.adam import Adam, tree_leaves
    from repro_torch.parallel import sharding as shd

    torch.cuda.empty_cache()
    opt = Adam(lr=TRAIN_LR)
    state = train.init_state(
        cfg, opt, generator=torch.Generator(device="cuda").manual_seed(0))
    specs = train.state_specs(state, mesh)
    local = shd.local_shards(state, specs, mesh)
    step, on_mesh = train.make_train_step(cfg, mesh, opt,
                                          microbatches=microbatches)
    mstep = on_mesh(state)
    one = TokenLoader(cfg, batch=batch, seq=LM_SEQ, seed=0)
    ranked = TokenLoader(cfg, mesh, batch=batch, seq=LM_SEQ, seed=0)
    batches = [next(one) for _ in range(MESH_STEPS)]
    mbatches = [next(ranked) for _ in range(MESH_STEPS)]
    rows_equal = all(torch.equal(a[k], b[k]) for a, b in
                     zip(batches, mbatches) for k in a)
    runs = {}
    for tag, fn, st, bs in (("train_step", step, state, batches),
                            ("on_mesh", mstep, local, mbatches)):
        _mesh_reset(attn_ops, ssd_ops)
        secs, ms = [], []
        for b in bs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = fn(st, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            ms.append(m)
        runs[tag] = (st, ms, secs, _mesh_counts(attn_ops, ssd_ops))
    (s1, m1, t1, c1), (s2, m2, t2, c2) = runs["train_step"], runs["on_mesh"]
    same_m = all(torch.equal(getattr(a, f), getattr(b, f))
                 for a, b in zip(m1, m2) for f in type(a)._fields)
    diff = [i for i, (a, b) in enumerate(zip(tree_leaves(s1),
                                             tree_leaves(s2)))
            if not torch.equal(a, b)]
    print(f"  [{card}] 10a {cfg.name} ({cfg.n_layers} layers), {batch} x "
          f"{LM_SEQ} ({microbatches} microbatch"
          f"{'es' if microbatches > 1 else ''}): on_mesh step s "
          f"{', '.join(f'{x:.3f}' for x in t2)} (train_step "
          f"{', '.join(f'{x:.3f}' for x in t1)}); losses "
          f"{[round(float(m.loss), 6) for m in m2]}; launches on_mesh "
          f"{c2} (train_step {c1}); TokenLoader(mesh) rows "
          f"{'bitwise' if rows_equal else 'DIFFER'}; metrics "
          f"{'bitwise' if same_m else 'DIFFER'}; state "
          f"{'bitwise' if not diff else f'{len(diff)} leaves DIFFER'}",
          flush=True)
    if not (rows_equal and same_m and not diff):
        fail(f"10a {cfg.name}: on_mesh is not bitwise train_step "
             f"(rows {rows_equal}, metrics {same_m}, leaves {diff[:5]})")
    kind = ("flash", "flash_bwd") if cfg.plan()[0].kind == "attn" \
        else ("ssd", "ssd_bwd")
    if not all(c2[k] > 0 for k in kind) or c2 != c1:
        fail(f"10a {cfg.name}: launches on_mesh {c2}, train_step {c1}")
    return {"step_s": t2, "train_step_s": t1, "launches": c2}


def mesh_serve_one_rank(torch, card, mesh, attn_ops) -> dict:
    """10a: ``make_serve_step`` on qwen3-1.7b whole, B = MESH_SERVE_B, for
    MESH_SERVE_STEPS steps: its logits bitwise ``decode_step``'s."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import sharding as shd

    cfg = get_config("qwen3-1.7b")
    params, gen = init_lm(torch, card, cfg)
    B, n = MESH_SERVE_B, MESH_SERVE_STEPS
    toks = synthetic.lm_tokens(gen, batch=B, seq=n - 1, vocab=cfg.vocab)
    step, built = serve.make_serve_step(cfg, mesh, batch=B)
    sharded = built(params)
    local_p = shd.local_shards(params, shd.param_specs(params, mesh), mesh)
    state = tf.init_serve(cfg, B, n)
    local_s = shd.local_shards(state, serve.serve_state_specs(cfg, mesh,
                                                              batch=B), mesh)
    wants = []
    for t in range(n):                  # the one-process steps first
        want, state = step(params, toks[:, t:t + 1], state)
        wants.append(want)
    equal, ms = True, []
    attn_ops.reset_counts()             # the sharded step's own launches
    for t in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, local_s = sharded(local_p, toks[:, t:t + 1], local_s)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        equal &= torch.equal(got, wants[t])
    flash = attn_ops.flash_sm90_launches
    p50 = sorted(ms)[len(ms) // 2]
    print(f"  [{card}] 10a qwen3-1.7b make_serve_step, B={B}, {n} steps: "
          f"per-token p50 {p50:.3f} ms (max {max(ms):.3f}); logits "
          f"{'bitwise' if equal else 'DIFFER from'} decode_step's; "
          f"flash_sm90 launches {flash} (the sharded steps alone, {n} x "
          f"{cfg.n_layers})", flush=True)
    if not equal:
        fail("10a: make_serve_step's logits differ from decode_step's")
    if flash != n * cfg.n_layers:
        fail(f"10a serve: {flash} flash_sm90 launches")
    del params, local_p, wants
    torch.cuda.empty_cache()
    return {"p50_ms": p50, "flash_sm90_launches": flash}


def mesh_one_rank(torch, card, attn_ops, ssd_ops) -> dict:
    """Phase 10a on one NCCL rank holding mesh (1, 1)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import mesh as tmesh
    print(f"  reduced: 10a qwen3-1.7b n_layers 28 -> {MESH_QWEN_LAYERS} "
          f"(two training states on the card), batch 4 x {LM_SEQ}; "
          f"mamba2-130m whole at 8 x {LM_SEQ}; serving qwen3-1.7b whole",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = tmesh.make_mesh((1, 1), ("data", "model"), rank=0,
                               world_size=1, init_method=f"file://{tmp}/rdv",
                               backend="nccl", timeout_s=MESH_JOIN_S)
        try:
            out = {"mamba2-130m": mesh_train_one_rank(
                torch, card, mesh, get_config("mamba2-130m"), batch=8,
                microbatches=1, attn_ops=attn_ops, ssd_ops=ssd_ops)}
            out["qwen3-1.7b"] = mesh_train_one_rank(
                torch, card, mesh, get_config("qwen3-1.7b").scaled(
                    n_layers=MESH_QWEN_LAYERS), batch=4, microbatches=2,
                attn_ops=attn_ops, ssd_ops=ssd_ops)
            out["serve"] = mesh_serve_one_rank(torch, card, mesh, attn_ops)
        finally:
            dist.destroy_process_group()
    return out


def _tensor_bytes(torch, tree) -> int:
    """numel x element size over the tensors of ``tree`` (a cache's
    host-int length holds no device bytes)."""
    from repro_torch.optim.adam import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def mesh_dryrun(torch, cfg, force_tp: bool) -> dict:
    """10b's steps as the dry-run traces them for rank 0 of mesh (2, 2) on
    the meta device (``launch.dryrun``; MESH_GLOO's cut config, float32
    compute, tensor parallelism forced as the ranks force it): the
    per-rank bytes of the train state and of the parameters with the serve
    state, and the collectives' calls and bytes of one train step and of
    the 4 serve steps."""
    from repro_torch.launch import dryrun
    from repro_torch.parallel import sharding as shd
    g, f32 = MESH_GLOO, torch.float32
    sizes = dict(zip(("data", "model"), g["shape"]))
    keep, t0 = shd.PURE_DP_THRESHOLD_BYTES, time.perf_counter()
    shd.PURE_DP_THRESHOLD_BYTES = 0 if force_tp else keep
    try:
        tr = dryrun.trace_train(cfg, sizes, batch=g["batch"], seq=g["seq"],
                                compute_dtype=f32)
        sv = dryrun.trace_decode(cfg, sizes, batch=g["batch"],
                                 max_len=2 * g["serve_steps"],
                                 steps=g["serve_steps"], cache_dtype=f32,
                                 compute_dtype=f32)
    finally:
        shd.PURE_DP_THRESHOLD_BYTES = keep
    table = lambda c: {k: (v["calls"], v["bytes"])
                       for k, v in c["collectives"].items()}
    return {"train_bytes": tr["bytes_per_device"],
            "serve_bytes": sv["bytes_per_device"],
            "train": table(tr["collective"]), "serve": table(sv["collective"]),
            "s": time.perf_counter() - t0}


def mesh_vs_dryrun(card: str, name: str, dry: dict, ranks: list) -> None:
    """10b's ranks against the dry-run (``mesh_dryrun``): each rank's shard
    bytes, and its collectives' calls and bytes in both train steps and in
    the serve steps, collective by collective, must be the dry-run's."""
    got = lambda c: {k: (v[0], v[2]) for k, v in c.items()}
    bad = []
    for i, r in enumerate(ranks):
        if r["shard_bytes"] != dry["train_bytes"] or \
                r["serve_bytes"] != dry["serve_bytes"]:
            bad.append(f"rank {i} bytes {r['shard_bytes']}, "
                       f"{r['serve_bytes']}")
        for j, c in enumerate(r["train_coll"]):
            if got(c) != dry["train"]:
                bad.append(f"rank {i} train step {j + 1}: {got(c)}")
        if got(r["serve_coll"]) != dry["serve"]:
            bad.append(f"rank {i} serve: {got(r['serve_coll'])}")
    fmt = lambda t: ", ".join(f"{k.strip('_')} {n} calls {b / 1e9:.4f} GB"
                              for k, (n, b) in sorted(t.items()))
    print(f"  [{card}] 10b {name} vs the dry-run (meta, rank 0, "
          f"{dry['s']:.1f} s): shard bytes a rank, train state "
          f"{dry['train_bytes']:.0f} B, parameters and serve state "
          f"{dry['serve_bytes']:.0f} B; a train step's collectives "
          f"{fmt(dry['train'])}; the serve steps' {fmt(dry['serve'])}: "
          f"{'every rank equal' if not bad else 'DIFFER'}", flush=True)
    if bad:
        fail(f"10b {name}: the ranks differ from the dry-run (want "
             f"{dry['train_bytes']:.0f} / {dry['serve_bytes']:.0f} B, "
             f"{dry['train']}, {dry['serve']}): {bad}")


def _time_collectives(torch, cls) -> dict:
    """Wrap the collectives of ``cls`` (``sharding.MeshAxes``) in this
    process: each call synchronizes the card before and after and adds
    its seconds, calls and bytes received to the returned dict, by
    collective."""
    spent = {}

    def wrap(name, fn):
        def timed(self, t, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, t, *args)
            torch.cuda.synchronize()
            row = spent.setdefault(name, [0, 0.0, 0])
            row[0] += 1
            row[1] += time.perf_counter() - t0
            row[2] += out.numel() * out.element_size()
            return out
        return timed

    for name in ("_cat", "sum", "max"):
        setattr(cls, name, wrap(name, getattr(cls, name)))
    return spent


def _flat(torch, tree):
    """The leaves of ``tree`` in one flat tensor: one CUDA IPC export for
    a child in place of one a leaf (~300 leaves a child took ~10 s a child
    to spawn on an NVIDIA H100 80GB HBM3, 700 W machine)."""
    from repro_torch.optim.adam import tree_leaves
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


def _unflat(flat, like):
    """``_flat``'s inverse: views of ``flat`` shaped like ``like``'s
    leaves."""
    from repro_torch.optim.adam import tree_map
    at = [0]

    def take(t):
        v = flat[at[0]:at[0] + t.numel()].view(t.shape)
        at[0] += t.numel()
        return v
    return tree_map(take, like)


def _update_agrees(torch, p0, got, want, mu, mu_limits, opt) -> tuple:
    """10b's parameter check. Adam's first update from zero moments is
    lr g / (|g| + eps): lr times the sign of g wherever |g| >> eps. On the
    elements whose one-process mu (0.1 g) exceeds twice its leaf's limit
    (so the mesh's mu, held within that limit, has its sign) and 100 eps
    (so the update is within 1% of lr), the mesh step's update
    ``got - p0`` must have the one-process update's sign and lie within
    0.1 lr + 2 ulps of ``p0`` of it. Returns (elements off, the first leaf
    with one, the share of elements so held)."""
    from repro_torch.optim.adam import tree_leaves
    floor = 100 * (1 - opt.b1) * opt.eps
    off, held, total, where = 0, 0, 0, ""
    for (path, w0), a, w, m, lim in zip(
            _named_leaves(p0), tree_leaves(got), tree_leaves(want),
            tree_leaves(mu), mu_limits):
        sure = m.abs() > max(2 * lim, floor)
        dg, dw = a - w0, w - w0
        tol = 0.1 * TRAIN_LR + 2 * torch.finfo(w0.dtype).eps * w0.abs()
        n = int((sure & ((dg * dw <= 0) | ((dg - dw).abs() > tol))).sum())
        if n and not where:
            where = path
        off, held, total = off + n, held + int(sure.sum()), \
            total + w0.numel()
    return off, where, held / total


def _mesh_rank(rank, rdv, sh, q):
    """One rank of phase 10b: the sharded train and serve steps of each
    model in ``sh``, from the initial state it draws from the parent's seed,
    held against the parent's one-process results (shared through CUDA
    IPC, a few flat tensors); puts its readings on ``q``. Loads the kernels
    phase 2 built; never runs nvcc."""
    entered = time.time()
    import traceback
    import torch
    import torch.distributed as dist
    try:
        from repro_torch.kernels import build
        missing = [n for n in build.sources() if not build.target(n).exists()]
        if missing:
            raise RuntimeError(f"kernels {missing} are not built: phase 2 "
                               f"builds them, a rank only loads them")
        from repro_torch.data.loader import TokenLoader
        from repro_torch.kernels.attention import ops as attn_ops
        from repro_torch.kernels.ssd import ops as ssd_ops
        from repro_torch.launch import mesh as tmesh, serve, train
        from repro_torch.models import transformer as tf
        from repro_torch.optim.adam import Adam, tree_leaves
        from repro_torch.parallel import sharding as shd
        dev = torch.device("cuda", 0)
        g = MESH_GLOO
        spent = _time_collectives(torch, shd.MeshAxes)
        mesh = tmesh.make_mesh(g["shape"], ("data", "model"), rank=rank,
                               world_size=g["world"],
                               init_method=f"file://{rdv}", backend="gloo",
                               device=dev, timeout_s=MESH_JOIN_S)
        out = {"entered": entered, "joined": time.time()}
        for name, d in sh.items():
            spent.clear()
            t_case = time.perf_counter()
            cfg, f32 = d["cfg"], torch.float32
            shd.PURE_DP_THRESHOLD_BYTES = 0 if d["force_tp"] else 4e9
            opt = Adam(lr=TRAIN_LR)
            state0 = train.init_state(cfg, opt, generator=torch.Generator(
                device=dev).manual_seed(0), device=dev)
            specs = train.state_specs(state0, mesh)
            local = shd.local_shards(state0, specs, mesh)
            shard_bytes = _tensor_bytes(torch, (local.params, local.opt.mu,
                                                local.opt.nu))
            b = next(TokenLoader(cfg, mesh, batch=g["batch"], seq=g["seq"],
                                 seed=0, device=dev))
            place = lambda spec, t: shd.Placement(
                spec, shd.axis_sizes(mesh)).shard(
                    t, dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())))
            rows = {k: place((shd.batch_spec(mesh)[0],), v)
                    for k, v in d["batch"].items()}
            rows_equal = all(torch.equal(b[k], rows[k]) for k in rows)
            _, on_mesh = train.make_train_step(cfg, mesh, opt,
                                               compute_dtype=f32)
            step = on_mesh(state0)
            _, built = serve.make_serve_step(cfg, mesh, batch=g["batch"],
                                             compute_dtype=f32)
            sharded = built(state0.params)
            yard = _unflat(d["yard"], {"params": state0.params,
                                       "mu": state0.params,
                                       "nu": state0.params})
            del state0
            # the step twice from the same state: the first pays the
            # process's first-use costs, the second is the step's own time
            # (and must give the same bits)
            train_s, train_coll = [], []
            for _ in range(2):
                _mesh_reset(attn_ops, ssd_ops)
                spent.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, m = step(local, b)
                torch.cuda.synchronize()
                train_s.append(time.perf_counter() - t0)
                train_coll.append({k: list(v) for k, v in spent.items()})
                if len(train_s) == 1:
                    first = (new, m)
            counts = _mesh_counts(attn_ops, ssd_ops)
            repeat_equal = torch.equal(first[1].loss, m.loss) and all(
                torch.equal(a, c) for a, c in zip(tree_leaves(first[0]),
                                                  tree_leaves(new)))
            del first
            spent.clear()
            errs, mu_limits = {}, []
            for part in ("mu", "nu"):
                want_t = shd.map_specs(place, specs.params, yard[part])
                worst = (0.0, "")
                for (path, w), a, spread in zip(
                        _named_leaves(want_t),
                        tree_leaves(getattr(new.opt, part)),
                        d["spread"][part]):
                    limit = max(1e-4 * float(w.abs().max()), 10 * spread,
                                1e-30)
                    worst = max(worst, (float((a - w).abs().max()) / limit,
                                        path))
                    if part == "mu":
                        mu_limits.append(limit)
                errs[part] = worst
            errs["params"] = _update_agrees(
                torch, local.params, new.params,
                shd.map_specs(place, specs.params, yard["params"]),
                shd.map_specs(place, specs.params, yard["mu"]), mu_limits,
                opt)
            # serving from the initial parameters
            B = g["batch"]
            sspec = serve.serve_state_specs(cfg, mesh, batch=B)
            st = shd.local_shards(tf.init_serve(cfg, B, 2 * g["serve_steps"],
                                                device=dev, cache_dtype=f32),
                                  sspec, mesh)
            serve_bytes = _tensor_bytes(torch, (local.params, st))
            lspec = shd.logits_spec(mesh, batch=B, vocab=cfg.vocab_padded)
            serve_err, t1 = 0.0, time.perf_counter()
            _mesh_reset(attn_ops, ssd_ops)
            for t in range(g["serve_steps"]):
                tok = place((lspec[0], None), d["tokens"][:, t:t + 1])
                lg, st = sharded(local.params, tok, st)
                w = place(lspec, d["logits"][t])
                serve_err = max(serve_err, float((lg - w).abs().max())
                                / d["logit_max"][t])
            torch.cuda.synchronize()
            out[name] = dict(loss=float(m.loss), grad_norm=float(m.grad_norm),
                             rows_equal=rows_equal, errs=errs,
                             repeat_equal=repeat_equal,
                             train_s=train_s, counts=counts,
                             serve_err=serve_err,
                             serve_s=time.perf_counter() - t1,
                             serve_counts=_mesh_counts(attn_ops, ssd_ops),
                             train_coll=train_coll, serve_coll=dict(spent),
                             shard_bytes=shard_bytes,
                             serve_bytes=serve_bytes,
                             case_s=time.perf_counter() - t_case)
            del local, new, yard, st
            torch.cuda.empty_cache()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        q.put((rank, out, None))
    except Exception:
        q.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        import gc
        sh.clear()
        gc.collect()


def mesh_gloo(torch, card) -> dict:
    """Phase 10b: the parent's one-process steps on the card (float32
    compute), then MESH_GLOO's ranks over gloo on cuda:0."""
    import queue
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic
    from repro_torch.data.loader import TokenLoader
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adam import Adam, tree_leaves

    g, f32 = MESH_GLOO, torch.float32
    print(f"  reduced: 10b qwen3-1.7b n_layers 28 -> {g['qwen_layers']} "
          f"(tensor parallelism forced on), mamba2-130m whole (pure data "
          f"parallelism, by the size policy); {g['batch']} x {g['seq']} "
          f"tokens, float32 compute", flush=True)
    sh = {}
    for name, cfg, force_tp in (
            ("qwen3-1.7b", get_config("qwen3-1.7b").scaled(
                n_layers=g["qwen_layers"]), True),
            ("mamba2-130m", get_config("mamba2-130m"), False)):
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(0)
        opt = Adam(lr=TRAIN_LR)
        state0 = train.init_state(cfg, opt, generator=gen)
        batch = next(TokenLoader(cfg, batch=g["batch"], seq=g["seq"],
                                 seed=0))
        step, _ = train.make_train_step(cfg, None, opt, compute_dtype=f32)
        yard, m = step(state0, batch)
        # the one-process step's own spread: 2 microbatches against 1
        step2, _ = train.make_train_step(cfg, None, opt, microbatches=2,
                                         compute_dtype=f32)
        other, _ = step2(state0, batch)
        spread = {part: [float((a - b).abs().max()) for a, b in zip(
            tree_leaves(x(yard)), tree_leaves(x(other)))]
            for part, x in (("params", lambda s: s.params),
                            ("mu", lambda s: s.opt.mu),
                            ("nu", lambda s: s.opt.nu))}
        del other
        toks = synthetic.lm_tokens(gen, batch=g["batch"],
                                   seq=g["serve_steps"] - 1, vocab=cfg.vocab)
        st = tf.init_serve(cfg, g["batch"], 2 * g["serve_steps"],
                           cache_dtype=f32)
        logits = []
        for t in range(g["serve_steps"]):
            lg, st = tf.decode_step(state0.params, toks[:, t:t + 1], st, cfg,
                                    compute_dtype=f32)
            logits.append(lg)
        torch.cuda.synchronize()
        sh[name] = dict(cfg=cfg, force_tp=force_tp, batch=batch, tokens=toks,
                        yard=_flat(torch, {"params": yard.params,
                                           "mu": yard.opt.mu,
                                           "nu": yard.opt.nu}),
                        logits=torch.stack(logits),
                        logit_max=[float(lg[..., :cfg.vocab].abs().max())
                                   for lg in logits], spread=spread,
                        loss=float(m.loss), grad_norm=float(m.grad_norm))
        del state0, yard, logits, st
        sh[name]["dry"] = mesh_dryrun(torch, cfg, force_tp)
    t0, wall0 = time.perf_counter(), time.time()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_mesh_rank, args=(
            r, f"{tmp}/gloo.rdv", sh, q)) for r in range(g["world"])]
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = time.monotonic() + MESH_JOIN_S
        try:
            while len(got) + len(errors) < g["world"]:
                try:
                    rank, out, tb = q.get(timeout=max(
                        0.1, min(5.0, deadline - time.monotonic())))
                except queue.Empty:
                    if time.monotonic() > deadline or not any(
                            p.is_alive() for p in procs):
                        break
                    continue
                if tb is None:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{tb}")
        finally:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join()
    spawn_s = time.perf_counter() - t0
    if errors:
        fail("phase 10b: a rank raised:\n" + "\n".join(errors))
    if len(got) < g["world"]:
        fail(f"phase 10b: only ranks {sorted(got)} answered within "
             f"{MESH_JOIN_S:.0f} s; exit codes {[p.exitcode for p in procs]}")
    out = {"spawn_to_last_s": spawn_s}
    for name, d in sh.items():
        ranks = [got[r][name] for r in sorted(got)]
        loss_rel = max(abs(r["loss"] - d["loss"]) / abs(d["loss"])
                       for r in ranks)
        worst = {k: max(tuple(r["errs"][k]) for r in ranks)
                 for k in ("mu", "nu")}
        off = sum(r["errs"]["params"][0] for r in ranks)
        held = min(r["errs"]["params"][2] for r in ranks)
        off_at = next((r["errs"]["params"][1] for r in ranks
                       if r["errs"]["params"][0]), "")
        serve_err = max(r["serve_err"] for r in ranks)
        kind = ("flash", "flash_bwd") if d["cfg"].plan()[0].kind == "attn" \
            else ("ssd", "ssd_bwd")
        launched = all(r["counts"][k] > 0 for r in ranks for k in kind)
        serve_launched = d["cfg"].plan()[0].kind != "attn" or all(
            r["serve_counts"]["flash"] > 0 for r in ranks)
        rows_ok = all(r["rows_equal"] for r in ranks)
        rep_ok = all(r["repeat_equal"] for r in ranks)
        train_s = [[round(x, 3) for x in r["train_s"]] for r in ranks]
        serve_s = [round(r["serve_s"], 3) for r in ranks]
        print(f"  [{card}] 10b {name} ({d['cfg'].n_layers} layers) on "
              f"{g['world']} gloo ranks {g['shape']}: train step s (first, "
              f"again: the same bits {rep_ok}) {train_s}, loss "
              f"{ranks[0]['loss']:.7f} vs {d['loss']:.7f} "
              f"(rel {loss_rel:.2e}, tol {TOL_TRAIN_LOSS}); worst leaf error "
              f"over its limit (1): mu {worst['mu'][0]:.3f} "
              f"({worst['mu'][1]}), nu {worst['nu'][0]:.3f} "
              f"({worst['nu'][1]}); the one-process spread's largest, mu "
              f"{max(d['spread']['mu']):.3e}; parameters: the update held "
              f"on {held:.4f} of the elements (a rank's least), {off} off "
              f"({off_at or 'none'}); serve "
              f"{g['serve_steps']} steps B={g['batch']}: max|dlogit| / "
              f"max|logit| {serve_err:.2e} (tol {MESH_TOL_LOGITS}), s "
              f"{serve_s}; launches a rank {ranks[0]['counts']}, serving "
              f"{ranks[0]['serve_counts']}; TokenLoader(mesh) rows "
              f"{'bitwise' if rows_ok else 'DIFFER'}", flush=True)
        if not (loss_rel <= TOL_TRAIN_LOSS
                and max(w[0] for w in worst.values()) <= 1
                and off == 0 and held >= MESH_HELD_MIN
                and serve_err <= MESH_TOL_LOGITS and rows_ok and rep_ok):
            fail(f"10b {name}: loss {loss_rel}, moments {worst}, parameter "
                 f"updates off {off} ({off_at}) held on {held}, serve "
                 f"{serve_err}")
        if not (launched and serve_launched):
            fail(f"10b {name}: a kernel was not launched: "
                 f"{[r['counts'] for r in ranks]}")
        mesh_vs_dryrun(card, name, d["dry"], ranks)
        coll = lambda c: ", ".join(
            f"{k.strip('_')} {n} calls {sec:.2f} s {b / 1e9:.2f} GB"
            for k, (n, sec, b) in sorted(c.items()))
        print(f"  [{card}] 10b {name} rank 0: case {ranks[0]['case_s']:.1f} "
              f"s; collectives (card synchronized around each) in the first "
              f"train step: {coll(ranks[0]['train_coll'][0])}; in the "
              f"second: {coll(ranks[0]['train_coll'][1])}; in the 4 serve "
              f"steps: {coll(ranks[0]['serve_coll'])}", flush=True)
        out[name] = {"loss_rel": loss_rel, "errs": worst,
                     "params": {"off": off, "held": held},
                     "serve_err": serve_err,
                     "train_s": [r["train_s"] for r in ranks]}
    peak = [round(got[r]["peak_gb"], 2) for r in sorted(got)]
    enter = [round(got[r]["entered"] - wall0, 1) for r in sorted(got)]
    joined = [round(got[r]["joined"] - wall0, 1) for r in sorted(got)]
    print(f"  [{card}] 10b spawn to the last reading {spawn_s:.1f} s; the "
          f"ranks entered at {enter} s and joined the mesh at {joined} s; "
          f"peak device memory a rank {peak} GB", flush=True)
    sh.clear()
    torch.cuda.empty_cache()
    return out


def batching(torch, card: str, attn_ops) -> dict:
    """Phase 9: the continuous batcher on qwen3-1.7b and mamba2-130m."""
    return {name: batcher_path(torch, card, name, attn_ops)
            for name in ("qwen3-1.7b", "mamba2-130m")}


def mesh_steps(torch, card: str, attn_ops, ssd_ops) -> dict:
    """Phase 10: (a) one NCCL rank, then (b) four gloo ranks."""
    t0 = time.perf_counter()
    one = mesh_one_rank(torch, card, attn_ops, ssd_ops)
    t1 = time.perf_counter()
    gloo = mesh_gloo(torch, card)
    print(f"  10a {t1 - t0:.1f} s, 10b {time.perf_counter() - t1:.1f} s",
          flush=True)
    return {"one_rank": one, "gloo": gloo}


DRY_MESH = {"data": 1, "model": 1}
DECODE_TIMED = 8            # phase 11's decode steps timed after a warm-up


def _dry_line(card, what, dry, real_bytes, peak_gb, seconds, roof) -> None:
    print(f"  [{card}] 11 {what}: per-rank bytes dry-run "
          f"{dry['bytes_per_device']:.0f}, card {real_bytes} "
          f"({'equal' if real_bytes == dry['bytes_per_device'] else 'DIFFER'}"
          f"); peak {peak_gb:.2f} GB; traced {dry['flops'] / 1e12:.3f} "
          f"TFLOP (meta, {dry['compile_s']:.1f} s), model "
          f"{roof.model_flops / 1e12:.3f} TFLOP; t_compute "
          f"{roof.t_compute * 1e3:.3f} ms, t_memory {roof.t_memory * 1e3:.3f}"
          f" ms ({roof.bottleneck}); measured {seconds * 1e3:.3f} ms",
          flush=True)
    if real_bytes != dry["bytes_per_device"]:
        fail(f"11 {what}: the dry-run's per-rank bytes "
             f"{dry['bytes_per_device']} differ from the card's {real_bytes}")


def dryrun_vs_card(torch, card: str) -> dict:
    """Phase 11: (a) the dry-run (``launch.dryrun`` at mesh (1, 1), rank 0
    on meta) against the same steps on the card; (c) the contract audit on
    the card."""
    from repro_torch.analysis import contracts
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import synthetic
    from repro_torch.data.loader import TokenLoader
    from repro_torch.launch import dryrun, train
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adam import Adam
    from repro_torch.roofline import analysis

    def roof(name, dry, shape, last=False):
        return analysis.analyze(
            name, shape.name, "data1_model1", chips=1,
            traced={"flops": dry["flops"], "bytes": dry["bytes"],
                    "collective": dry["collective"]}, cfg=get_config(name),
            shape=shape, bytes_per_device=dry["bytes_per_device"],
            last_logits=last)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated() / 1e9

    out = {}
    for name, run in (("qwen3-1.7b", TRAIN_QWEN),
                      ("mamba2-130m", TRAIN_MAMBA)):
        cfg = get_config(name)
        B, mb = run["batch"], run["microbatches"]
        dry = dryrun.trace_train(cfg, DRY_MESH, batch=B, seq=LM_SEQ,
                                 microbatches=mb)
        torch.cuda.empty_cache()
        opt = Adam(lr=TRAIN_LR)
        state = train.init_state(
            cfg, opt, generator=torch.Generator(device="cuda").manual_seed(0))
        real = _tensor_bytes(torch, (state.params, state.opt.mu,
                                     state.opt.nu))
        step, _ = train.make_train_step(cfg, None, opt, microbatches=mb,
                                        remat=True)
        loader = TokenLoader(cfg, batch=B, seq=LM_SEQ, seed=0)
        state, _ = step(state, next(loader))                  # warm-up
        batch = next(loader)
        (state, m), sec, peak = timed(lambda: step(state, batch))
        if not math.isfinite(float(m.loss)):
            fail(f"11 {name}: the step's loss is not finite")
        shape = ShapeSpec("train", LM_SEQ, B, "train")
        _dry_line(card, f"{name} train step {B} x {LM_SEQ} ({mb} "
                  f"microbatches)", dry, real, peak, sec,
                  roof(name, dry, shape))
        out[f"{name} train"] = dict(bytes=real, peak_gb=peak, s=sec,
                                    flops=dry["flops"])
        if name != "qwen3-1.7b":
            del state
            continue
        params = state.params
        del state
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(0)
        toks = synthetic.lm_tokens(gen, batch=LM_BATCH, seq=LM_SEQ - 1,
                                   vocab=cfg.vocab)
        dry = dryrun.trace_prefill(cfg, DRY_MESH, batch=LM_BATCH, seq=LM_SEQ,
                                   last_logits=True)
        fwd = lambda: tf.forward(params, toks, cfg, logits_last_only=True)
        fwd()                                                  # warm-up
        _, sec, peak = timed(fwd)
        shape = ShapeSpec("prefill", LM_SEQ, LM_BATCH, "prefill")
        _dry_line(card, f"{name} prefill {LM_BATCH} x {LM_SEQ}", dry,
                  _tensor_bytes(torch, params), peak, sec,
                  roof(name, dry, shape, last=True))
        max_len = GEN_PROMPT + GEN_NEW
        dry = dryrun.trace_decode(cfg, DRY_MESH, batch=LM_BATCH,
                                  max_len=max_len)
        st = tf.init_serve(cfg, LM_BATCH, max_len)
        real = _tensor_bytes(torch, (params, st))
        tok = toks[:, :1]
        for _ in range(GEN_PROMPT):                            # a prompt
            _, st = tf.decode_step(params, tok, st, cfg)
        step_s = []
        for _ in range(DECODE_TIMED):
            (_, st), sec, peak = timed(
                lambda: tf.decode_step(params, tok, st, cfg))
            step_s.append(sec)
        shape = ShapeSpec("decode", GEN_PROMPT, LM_BATCH, "decode")
        _dry_line(card, f"{name} decode step B={LM_BATCH} (p50 of "
                  f"{DECODE_TIMED})", dry, real, peak,
                  sorted(step_s)[len(step_s) // 2], roof(name, dry, shape))
        del params, st
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    contracts.reset_registry()
    report = contracts.run_audit()
    gens = report["launches"]
    print(f"  [{card}] 11 contract audit (routed pPIC on the card): "
          f"{report['n_executables']} callables, {report['n_audited']} "
          f"audited over {report['n_rebind_generations']} rebind "
          f"generations: fingerprints and launches identical "
          f"{report['rebind_identical']}, callables built "
          f"{report['rebind_new_traces']}; kernel launches a generation "
          f"{gens[0]}; tenant interleaving identical "
          f"{report['interleaving_identical']}; no_retrace "
          f"{report['no_retrace']}, violations "
          f"{report['no_retrace_violations']}; {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    launched = sum(n for made in gens[0].values() for n in made.values())
    if not (report["ok"] and all(g == gens[0] for g in gens)
            and launched > 0):
        fail(f"11 the contract audit on the card: {report}")
    out["audit_ok"] = report["ok"]
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "card; every phase unless --phases.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated subset of 3 (the backward "
                    "kernels' checks), 4b (the row products' checks, then "
                    "phase 4 for the data and 4b, pPIC routed serving; "
                    "prints the kernels line of those two kernels), 8 (LM "
                    "training), 9 (the continuous batcher), 10 (the LM's "
                    "steps over a mesh), 11 (the dry-run against the card, "
                    "the contract audit) and downdate (the downdate's "
                    "checks) to run after the card and build phases")
    only = ap.parse_args(argv).phases
    only = None if only is None else set(only.split(","))
    if only is not None and not only <= {"3", "4b", "8", "9", "10", "11",
                                         "downdate"}:
        print(f"FAIL: --phases takes 3, 4b, 8, 9, 10, 11 and downdate; got "
              f"{sorted(only)}", flush=True)
        return 2
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run "
              "needs one CUDA card", flush=True)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"FAIL: {ROOT} is not a checkout of the repository "
              f"(src/repro_torch is missing)", flush=True)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (turns TF32 off)
    global hw, rk
    from repro_torch.roofline import hw, kernels as rk
    from repro_torch.kernels import build
    from repro_torch.kernels.rbf import ops, ref

    clock = {"name": None, "t": time.perf_counter()}

    def phase(title: str) -> None:
        """Print the last phase's seconds, then this one's title."""
        now = time.perf_counter()
        if clock["name"]:
            print(f"  ({clock['name']}: {now - clock['t']:.1f} s)",
                  flush=True)
        clock.update(name=title.split(":")[0], t=now)
        if title:
            print(title, flush=True)

    phase("phase 1: card")
    card = card_line()
    print(card, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    phase("phase 2: build")
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"  built {built or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in build.sources():
        log = build.target(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)

    # the float32 xcov_diag instances run their products on the tensor
    # cores (HGMMA)
    tc = {k: v for k, v in hgmma_counts(build.target("xcov_diag")).items()
          if "xcov_tc_kernel" in k}
    for name, c in sorted(tc.items()):
        print(f"  xcov_diag SASS {name[-40:]}: {c} HGMMA", flush=True)
    if not tc or not all(tc.values()):
        fail("a float32 xcov_diag instance has no HGMMA")

    from repro_torch.kernels.attention import ops as attn_ops, ref as attn_ref
    from repro_torch.kernels.linalg import ops as lin_ops, ref as lin_ref
    from repro_torch.kernels.ssd import ops as ssd_ops, ref as ssd_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    if only is not None:
        if "downdate" in only:
            phase("phase 3: kernel vs plain (the downdate only)")
            check_downdate(torch, lin_ops, lin_ref, gen)
        if "3" in only:
            phase("phase 3: kernel vs plain (the backward kernels)")
            check_flash_bwd(torch, attn_ops, attn_ref, gen)
            check_ssd_bwd(torch, ssd_ops, ssd_ref, gen)
        if "4b" in only:
            phase("phase 3: kernel vs plain (the row products)")
            rows_only = check_rows(torch, lin_ops, lin_ref, gen)
            torch.cuda.empty_cache()
            phase("phase 4: GP main path (the data 4b reuses)")
            data = main_path(torch, card)[2]
            phase("phase 4b: GP pPIC routed")
            ppic_launches = ppic_path(torch, card, **data)[0]
            del data
            torch.cuda.empty_cache()
            for row in rows_only:
                row["launches"] = row["launches_ppic"] = \
                    ppic_launches[row["name"]]
        if "8" in only:
            phase("phase 8: LM training")
            training(torch, card, attn_ops, ssd_ops)
        if "9" in only:
            phase("phase 9: LM continuous batcher")
            batching(torch, card, attn_ops)
        if "10" in only:
            phase("phase 10: LM steps over a mesh")
            mesh_steps(torch, card, attn_ops, ssd_ops)
        if "11" in only:
            phase("phase 11: the dry-run against the card; contract audit")
            dryrun_vs_card(torch, card)
        phase("")
        print(card, flush=True)
        if "4b" in only:
            print(json.dumps({"kernels": rows_only}), flush=True)
        print(json.dumps({"ok": True, "phases": sorted(only), "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    phase("phase 3: kernel vs plain")
    rows = [check_rbf(torch, ops, ref, gen), check_xcov(torch, ops, ref, gen),
            check_flash(torch, attn_ops, attn_ref, gen),
            check_ssd(torch, ssd_ops, ssd_ref, gen),
            check_downdate(torch, lin_ops, lin_ref, gen),
            check_flash_bwd(torch, attn_ops, attn_ref, gen),
            check_ssd_bwd(torch, ssd_ops, ssd_ref, gen),
            *check_rows(torch, lin_ops, lin_ref, gen)]
    rows[0].update(check_icf(torch, ops, ref, gen))
    torch.cuda.empty_cache()

    phase("phase 4: GP main path")
    launches, gp, data, cold_state = main_path(torch, card)
    rows[0].update(gp)
    del gp
    torch.cuda.empty_cache()

    phase("phase 4b: GP pPIC routed")
    ppic_launches, cold_pic = ppic_path(torch, card, **data)
    for row in rows:
        if row["name"] in ppic_launches:
            row["launches_ppic"] = ppic_launches[row["name"]]
    for name in ("rows_mm", "rows_reduce"):     # the routed path's kernels
        launches[name] = ppic_launches[name]
    torch.cuda.empty_cache()

    phase("phase 4c: GP pICF and MLE")
    torch.cuda.reset_peak_memory_stats()
    rows[0].update(check_icf_picf(torch, ops, ref, data["ds"],
                                  data["params"]))
    torch.cuda.empty_cache()
    picf = picf_path(torch, card, **data)
    for row in rows:
        if row["name"] in picf["launches"]:
            row["launches_picf"] = picf["launches"][row["name"]]
    rows[0].update({f"picf_{k}": v for k, v in picf.items()
                    if k != "launches"})
    del picf
    torch.cuda.empty_cache()

    phase("phase 4d: GP streaming and faults")
    stream = stream_path(torch, card, **data, cold_state=cold_state,
                         cold_pic=cold_pic)
    side = stream["yardstick_launches"]
    side = {"rbf": side["rbf"] + side["icf"],
            **{k: side[k] for k in ("xcov_diag", "chol_downdate", "rows_mm",
                                    "rows_reduce")}}
    for row in rows:
        if row["name"] in stream["launches"]:
            row["launches_stream"] = stream["launches"][row["name"]]
            row["launches_stream_yardsticks"] = side[row["name"]]
    launches["chol_downdate"] = stream["launches"]["chol_downdate"]
    next(r for r in rows if r["name"] == "chol_downdate").update(
        stream_retire_s=stream["times"]["retire"],
        stream_f64_retire_s=stream["times"]["f64 retire"],
        stream_f64_refold_s=stream["times"]["f64 refold"],
        stream_f32_refold_s=stream["times"]["f32 refold"],
        stream_peak_gb=stream["peak_gb"])
    yard = stream["yardsticks"]
    del stream
    torch.cuda.empty_cache()

    phase("phase 4f: GP serving runtime")
    torch.cuda.reset_peak_memory_stats()
    serving = serving_path(torch, card, **data, cold_state=cold_state,
                           cold_pic=cold_pic, yard=yard)
    for row in rows:
        row["launches_serving"] = serving["launches"].get(row["name"], 0)
        row["launches_serving_yardsticks"] = serving["yardsticks"].get(
            row["name"], 0)
    rows[0]["serving"] = serving["readings"]
    rows[0]["serving_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  phase 4f peak device memory {rows[0]['serving_peak_gb']:.2f} "
          f"GB", flush=True)
    del cold_state, cold_pic, yard, serving
    torch.cuda.empty_cache()

    phase("phase 4g: GP over processes")
    rows[0].update(dist_path(torch, card, **data))
    torch.cuda.empty_cache()

    phase("phase 4e: the pPITC fit's spread")
    rows[0]["fit_spread_s"] = fit_spread(torch, card, **data)
    del data
    torch.cuda.empty_cache()

    from repro_torch.configs.registry import get_config
    flash = (attn_ops, "flash_launches", "flash_sm90_launches")
    phase("phase 5: LM main path, qwen3-1.7b")
    cfg = get_config("qwen3-1.7b")
    params, gen = init_lm(torch, card, cfg)
    launches["flash_attention"] = lm_path(torch, card, cfg, flash, params,
                                          gen)["launches"]
    del params
    torch.cuda.empty_cache()

    phase("phase 5b: LM MoE, qwen3-moe-30b-a3b")
    full = get_config("qwen3-moe-30b-a3b")
    print(f"  reduced: n_layers {full.n_layers} -> {MOE_LAYERS} (float32 "
          f"weights; all {full.n_layers} take "
          f"{4 * full.param_counts()['total'] / 1e9:.0f} GB)", flush=True)
    moe_cfg = full.scaled(n_layers=MOE_LAYERS)
    params, gen = init_lm(torch, card, moe_cfg)
    moe_run = lm_path(
        torch, card, moe_cfg, flash, params, gen,
        # every pair fits: C = int(n k / E * E / k) = n tokens
        check_cfg=moe_cfg.scaled(
            capacity_factor=moe_cfg.moe_experts / moe_cfg.moe_top_k))
    moe_modes(torch, card, params, moe_cfg, gen)
    moe_drops(torch, card, params, moe_cfg, gen, moe_run["tokens"],
              moe_run["aux"])
    del params
    torch.cuda.empty_cache()

    phase("phase 5c: LM encoder-decoder, whisper-medium")
    encdec = encdec_path(torch, card, attn_ops)

    phase("phase 5d: LM VLM input, qwen2-vl-72b")
    vlm = vlm_path(torch, card, attn_ops)
    flash_row = next(r for r in rows if r["name"] == "flash_attention")
    flash_row.update(launches_moe=moe_run["launches"],
                     launches_encdec=encdec["launches"]["flash"],
                     launches_encdec_noncausal=encdec["launches"][
                         "noncausal"],
                     launches_vlm=vlm["launches"])

    phase("phase 6: LM main path, mamba2-130m")
    cfg = get_config("mamba2-130m")
    params, gen = init_lm(torch, card, cfg)
    launches["ssd_intra_chunk"] = lm_path(
        torch, card, cfg, (ssd_ops, "ssd_launches", None), params,
        gen)["launches"]
    del params
    torch.cuda.empty_cache()

    phase("phase 8: LM training")
    qwen_train, mamba_train = training(torch, card, attn_ops, ssd_ops)
    launches["flash_attention_bwd"] = \
        qwen_train["launches"]["flash_attention_bwd"]
    launches["ssd_intra_chunk_bwd"] = \
        mamba_train["launches"]["ssd_intra_chunk_bwd"]
    for row in rows:
        run = {"flash_attention": qwen_train, "flash_attention_bwd":
               qwen_train, "ssd_intra_chunk": mamba_train,
               "ssd_intra_chunk_bwd": mamba_train}.get(row["name"])
        if run is not None:
            row["launches_train"] = run["launches"][row["name"]]
    for tag, run in (("qwen3-1.7b", qwen_train), ("mamba2-130m",
                                                   mamba_train)):
        rows[0].setdefault("train", {})[tag] = {
            k: v for k, v in run.items() if k != "launches"}

    phase("phase 9: LM continuous batcher")
    batched = batching(torch, card, attn_ops)
    phase("phase 10: LM steps over a mesh")
    meshed = mesh_steps(torch, card, attn_ops, ssd_ops)
    flash_row.update(
        launches_batcher=batched["qwen3-1.7b"]["flash_sm90_launches"],
        launches_mesh_serve=meshed["one_rank"]["serve"][
            "flash_sm90_launches"],
        launches_mesh_train=meshed["one_rank"]["qwen3-1.7b"]["launches"][
            "flash"])
    for row in rows:
        name = {"flash_attention_bwd": ("qwen3-1.7b", "flash_bwd"),
                "ssd_intra_chunk": ("mamba2-130m", "ssd"),
                "ssd_intra_chunk_bwd": ("mamba2-130m", "ssd_bwd")}.get(
                    row["name"])
        if name is not None:
            row["launches_mesh_train"] = meshed["one_rank"][name[0]][
                "launches"][name[1]]
    rows[0]["lm_batcher"] = batched
    rows[0]["lm_mesh"] = meshed
    phase("phase 11: the dry-run against the card; contract audit")
    rows[0]["dryrun_vs_card"] = dryrun_vs_card(torch, card)

    for row in rows:
        row["launches"] = launches[row["name"]]

    phase("phase 7: kernels")
    for row in rows:
        if not all(math.isfinite(row[k]) for k in ("ms", "plain_ms",
                                                   "bound_ms")):
            fail(f"non-finite timing for {row['name']}")
    phase("")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
