#!/usr/bin/env python3
"""Start-up, kernel and main-path check of lightgbm_torch on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each:

1. environment: torch, CUDA and nvcc versions, the card's name and power
   limit, the digest of the measured sources (``source_digest``), and the
   build of every kernel from ``lightgbm_torch/csrc``;
2. data: a synthetic HIGGS-shaped set (1,000,000 x 28 train, 200,000 x 28
   valid, 63 bins), binned by ``lightgbm_torch.Dataset``;
3. kernels: B1-B4, B3s and B12 at the main path's shapes, each held
   against its plain PyTorch version on the card (B3, B3s and B4 bit for
   bit, B1, B2 and B12 within the tolerances below; B3 from the root and
   from a mid-tree state with an NA bin, B2 field by field with each
   regularisation term on in turn, B4 with NA bins, B3s at every step of
   whole 31-leaf trees, a max_depth tree and a stump, B12a with forced
   ties and zero-weight rows, B12b for each metric id), with the
   kernel's, the plain version's and the library call's median times
   from CUDA events, and the bound from the bytes and operations of this
   run's inputs;
4. main path: the default ``lightgbm_torch.train`` (binary, 31 leaves, 63
   bins, 50 rounds, one valid set, metrics auc and binary_logloss, early
   stopping at 10 on the first metric), which takes the super-epoch
   route: epochs of k = 10 iterations, each k replays of one captured
   CUDA graph and one host fetch.  It reports iterations/s, epoch
   milliseconds, epochs, host fetches (checked equal to the epochs),
   graph replays, the valid AUC and best iteration, and the launches of
   every kernel (captured launches times replays, checked against the
   per-iteration count the grower's fixed step sequence gives; no eager
   launch beyond the warm-up before capture);
5. per_iteration: the same training with ``superepoch=-1, fused_chunk=1``
   and the traced metrics (``fused_eval=true``), with per-phase
   milliseconds; its model text equals the main path's (minus the path
   parameter lines), it fetches once per tree and once per eval, and its
   launches are PER_ITERATION per iteration.  The ``fused_loop`` line
   then sets the captured iteration's (B14) steady milliseconds per
   iteration beside this path's and beside the bound of the work the
   main path's own trees needed (``iteration_bound``);
6. fused_chunk: no valid set, 50 rounds as chunks of 25 replays; its model
   text equals a per-iteration run's without a valid set, and both runs'
   launches are PER_ITERATION_NO_VALID per iteration (captured and
   warm-up, or eager);
7. reference: on a small input, training on the card agrees with the
   port's CPU path (plain versions);
8. round trip and determinism: predict, model text -> Booster -> equal
   predictions, and a second training run gives byte-identical model text.

9. profile: one more main-path training traced with ``torch.profiler``:
   the device time of each kernel and the device's busy share inside the
   steady epochs;
   wide_kernels (run after the kernels phase): B1-K (K-slot histogram),
   B3-K (batched partition), B3s-K (batched split step) and B6 (bagging
   draw) against their plain versions at 1M x 28, 63 bins, 255 leaves:
   B3s-K and B3-K bit for bit at every super-step of whole trees (K = 16
   and 8, max_depth 5, a stump; the full trees end in budget-cut
   super-steps) and on a table with tied gains, B1-K within HIST_RTOL at K
   = 16 and 8 on a real super-step's target slots (and ``check_b1k_card``:
   bitwise at three row ranges, zero past slots_used, no write on a dead
   step, NaN / +-Inf rows as the plain version's), B6 bit for bit for a
   fraction and pos/neg fractions at two refresh epochs (whose masks
   differ), with times, bounds and ``index_add_`` for B1-K;
   wide_train: the default ``train`` at 255 leaves (split_batch auto ->
   16) with bagging_fraction 0.8, bagging_freq 5, feature_fraction 0.8,
   as super-epochs (launch counts held to WIDE_PER_ITERATION), with
   it/s, live against launched super-steps per tree and the valid AUC;
   the per-iteration path (10 rounds: the same trees and evals, eager
   launches held) and fused chunks (25 rounds without a valid set: the
   same trees, launches held); a profiled byte-identical rerun (device
   busy share); ``Booster.predict`` of the wide model through
   the engine (one walk per bucket chunk, no other launch), byte-identical
   to the host walk; then the ``wide_loop``
   line (the captured wide iteration against its eager run and bound);
   sample_kernels (run after wide_kernels): B6-GOSS bit for bit against
   its plain version at 1M rows on random and tied gradients at two
   iterations, its threshold equal to ``torch.kthvalue``'s top_k-th
   largest; B6-node bit for bit for a strict step (2 children) and a 2K =
   32 super-step at two iterations, and writing nothing on an inactive
   step; B2 with the super-step's [2K, F] masks and random bins within
   SPLIT_RTOL; each timed, and compared on its timed call's inputs; then
   the GOSS and node draws captured in one graph and replayed at two
   iterations, the replays differing and each equal to the eager calls;
   goss_train: the default ``train`` at 255 leaves with GOSS (top_rate
   0.2, other_rate 0.1) and feature_fraction_bynode 0.8 as super-epochs
   (launches held to GOSS_PER_ITERATION), the per-iteration path (10
   rounds, the same trees and evals) and fused chunks (25 rounds, the
   same trees), a profiled rerun (byte-identical, device busy share), the
   in-bag share, live super-steps and ``Booster.predict`` through the
   engine, byte-identical to the host walk; extra_train: the same at 31
   leaves (strict grower) with extra_trees and feature_fraction_bynode
   0.8 (EXTRA_PER_ITERATION);
   cat_data and cat_kernels (run after sample_kernels): an airline-shaped
   set (the reference's Expo experiment in the 8-column airline schema:
   Month, DayofMonth, DayOfWeek, UniqueCarrier, Origin, Dest categorical,
   DepTime and Distance numerical; 1M train and 200k valid rows, 255
   bins, columns and cardinalities as drawn), then B2-cat against its
   plain version on 2K = 32 children (one-vs-rest, subsets over 7, 31 and
   255 categories, a max_cat_threshold cut, cat_l2 and cat_smooth in
   turn, tied ratios, [2K, F] masks, an inactive step, both merge
   outcomes), B1 and B1-K at 255 bins, B3 with categorical records and
   rank tables, B3s/B3 and B3s-K/B3-K at every step of whole categorical
   trees (31 leaves; 255 at K = 16) and B4 on a categorical tree, each
   timed; cat_train: the default ``train`` on that set at 255 leaves
   (K = 16) without sampling (CAT_PER_ITERATION), and cat_strict_train at
   31 leaves (CAT_STRICT_PER_ITERATION), each as goss_train (three paths,
   profiled byte-identical rerun, engine predict) plus categorical nodes
   a tree (> 0 in every tree), the fetch bytes an epoch, the model text
   round trip and ``fused_predict`` held as fused_serve; cat_cons_train:
   cat_strict_train with CAT_CONS_PARAMS (monotone on the two numerical
   columns, penalty, contri, CEGB), so that B2-cat runs with its control
   operands on a train path, held to CAT_STRICT_PER_ITERATION, with no
   monotone violation over CONS_SWEEP_ROWS swept valid rows;
   multiclass_data and multiclass_kernels (after cat_kernels): a
   Covertype-shaped set (``make_covertype_like``: 581,012 rows, 10
   integer numeric and 44 one-hot columns, 7 classes at Covertype's
   counts, 80/20 train and valid, 255 bins, the default ``enable_bundle``:
   the one-hot blocks bundle, G columns printed beside F = 54),
   then B4's column form bit for bit at K = 7 for every column on the
   grouped valid matrix through the EFB maps (a
   numerical and a categorical tree; stride 1 and column 0 against the
   one-column call) and B12c within POINTWISE_RTOL (random scores,
   saturated rows, zero weights; NaN for a label outside [0, K)), each
   timed beside ``cross_entropy``; multiclass_train (softmax, 31 leaves,
   20 rounds), multiclassova_train (20 rounds) and multiclass_wide (255
   leaves, bagging and feature_fraction, 10 rounds) on the per-iteration
   loop: launches held to K x MC_PER_TREE (MC_WIDE_PER_TREE) plus K
   walks an iteration, one tree fetch and one eval fetch an iteration,
   a ``fused_eval=true`` run (one B12c launch an iteration, the same
   model text, traced values held to the host ones) and a byte-identical
   rerun; multiclass_serve: the softmax model through
   ``Booster.predict`` (engine route), ``fused_predict`` and a
   ``Server`` on both routes, every [rows, 7] answer checked;
   efb_data and efb_kernels (after multiclass_kernels): a
   Flight-Delay-shaped set (``make_flight_like``, after the EFB
   experiment of Ke et al. 2017: six one-hot blocks of 12, 31, 7, 22, 255
   and 255 columns and two numerical ones, 584 columns; 500,000 train and
   100,000 valid rows, 255 bins), bundled at the defaults into EFB_GROUPS
   groups (uint8) and checked to unbundle to its ``enable_bundle=false``
   twin; then B9 bit for bit against its plain version on 1, 2 and 32
   children's group histograms, an inactive step and singleton-only maps,
   B3/B3-K and B4 with the decode maps bit for bit against their plain
   versions on CPU copies (a permuted rank row and categorical nodes
   beside the bundles), each timed; efb_train (after cat_strict_train):
   the main path's configuration at 255 bins on that set as the sampled
   cells run (EFB_PER_ITERATION, three paths, profiled byte-identical
   rerun, engine predict), then the unbundled twin: the same trees bit
   for bit on exact gradients, the bundled first tree's leaves within
   EFB_LEAF_RTOL of the f64 sums of their rows, the unbundled binary
   run's predictions, leaf error and steady it/s and B1's root pass
   reported beside the bundled one; efb_wide_train: 255 leaves (K = 16) with
   bagging for EFB_WIDE_ROUNDS rounds (EFB_WIDE_PER_ITERATION); the
   unbundled twin's first-tree leaves are held to EFB_UNBUNDLED_LEAF_RTOL,
   and the two first trees to equal structure;
   rank_data, rank_kernels, rank_train and xendcg_train (after
   efb_train): an MSLR-WEB30K-shaped set (``make_mslr_like``: 2,270,296 x
   136 in about 18,900 queries, labels 0-4, most features zero; 200,000
   valid rows), then B13a and B13b against their plain versions on the
   card over every query (ranks and draws bit for bit, g and h within
   RANK_GRAD_RTOL of each query's largest; tied, tied-in-part and random
   scores, all-zero-label queries, truncation 30 and 3, norm on and off,
   sigmoid 1 and 2, one query past the shared-memory tile), with times
   and bounds; rank_train: lambdarank at 255 leaves on the per-iteration
   loop (NDCG on the valid queries, RANK_PER_ITERATION) and as
   super-epochs without a valid set (B13a in the graph), the same model
   text, a profiled run; xendcg_train: rank_xendcg on the per-iteration
   loop and a byte-identical rerun;
   quant_kernels (after efb_kernels): B7a (scales) and B7b (int8/int16
   packing) bit for bit against their plain versions at 1M x 3 (int8
   stochastic at four iteration keys and two seeds, int8 nearest) and at
   65,536 rows (int16), zero rows staying zero; B1-int and B1-K-int bit
   for bit at the main shape, at 255 bins, at the rank shape (2,270,296 x
   136) and on efb_data's unbundled 584 columns, and writing nothing on an
   inactive step; B7c bit for bit on a child pair; each timed beside its
   bound and library call; the int16 overflow refusal at 1M rows;
   quant_train and quant_wide_train (after extra_train): the main and the
   wide configurations with ``quant_train`` (int8, stochastic) as the
   sampled cells run (QUANT_PER_ITERATION, QUANT_WIDE_PER_ITERATION; three
   paths with equal trees, a profiled byte-identical rerun, engine
   predict), quant_train's valid AUC within QUANT_AUC_GAP of the f32 main
   path's at its best round; quant_efb (after efb_wide_train): efb_train's
   bundled set with nearest rounding, one super-epoch and the
   per-iteration path, equal model text (QUANT_EFB_PER_ITERATION: B7c
   before every B9); quant_rank (after xendcg_train): lambdarank at 255
   leaves with ``quant_train`` for QUANT_RANK_ROUNDS per-iteration rounds
   (QUANT_RANK_PER_ITERATION), NDCG@10 rising and within QUANT_NDCG_GAP of
   rank_train's at the same round;
   sparse_data, sparse_kernels, sparse_train and sparse_wide_train (after
   quant_efb): an Allstate-shaped wide sparse set (``make_allstate_like``,
   the JAX package's own width test's shape: 4,228 columns, 35 stored
   values a row on two levels; 1M train and 200k valid CSR rows, built
   with enable_bundle=false), which both sets keep as the k-hot layout
   (K, its bytes beside the dense matrix's and the construction seconds
   printed); then B8a against its plain version within HIST_RTOL at every
   live pass of whole 31-, 255- (K = 16) and 64-leaf (K = 8) trees, and in
   its three forms (root, a strict step's slot, K = 16 and 8 slots)
   bitwise on a rerun, NaN / +-Inf rows giving exactly the plain
   version's non-finite cells, nothing written on an inactive step, zeros with
   every slot at -1; B3/B3-K's k-hot decode bit for bit at every step of
   those trees; B4's k-hot walk equal to the grower's row -> leaf vector
   on the train rows and bit for bit on the valid rows; each timed beside
   its bound and library call (``index_add_`` of the stored entries for
   B8a); sparse_train: binary at 31 leaves, per-iteration with the k-hot
   valid set (SPARSE_PI_ROUNDS rounds, host metrics), 50 rounds as
   super-epochs and 2 x 25 as fused chunks without it, launches held to
   SPARSE_PER_ITERATION, the shared trees equal on the three paths, a
   byte-identical rerun, the AUC rising, the first tree's leaves within
   SPARSE_LEAF_RTOL of their f64 sums (leaves from B8c's walk of the
   device k-hot rows), the valid scores against the host walk of the raw
   rows, a profiled run; sparse_wide_train: 255 leaves with bagging and
   feature_fraction (SPARSE_WIDE_PER_ITERATION) the same way;
   constraint_kernels (after sample_kernels): the kernels the split
   controls extend, B2 and B2-cat (each control alone and all together,
   each under the grower's params, path_smooth and max_delta_step),
   B3s/B3s-K (tree, step outputs and the controls' state: output ranges,
   branch sets, allowed masks, used features) and B6-node (per-child
   bases), bit for bit against their plain versions at every live step
   of a 31-leaf strict and a 255-leaf K = 16 tree (bynode 0.5) grown with
   CONS_PARAMS on the 1M x 28 rows from iteration 0's exact gradients,
   bitwise on a rerun, each timed on a middle step's inputs (B2 also
   without the controls); constraint_train and constraint_wide_train
   (after extra_train): CONS_PARAMS at 31 leaves (PER_ITERATION) and
   CONS_WIDE_PARAMS at 255 leaves with bynode 0.5 (CONS_WIDE_PER_ITERATION,
   held against the same run without the controls) as the sampled cells
   run (three paths,
   profiled byte-identical rerun, engine predict), plus no monotone
   violation over CONS_SWEEP_ROWS valid rows swept across each monotone
   feature's bin bounds on ``Booster.predict``, no root-to-leaf path
   outside one interaction group, fewer features than without CEGB, each
   CEGB penalty alone changing the first tree, and the steady it/s beside
   the unconstrained runs';
   partitioned_kernels (after constraint_kernels): B11a (segment
   histogram, f32 and int8, on the root segment and a 7,500-row segment
   of a permuted order, f32 also on segments of 1 and 33 rows with the
   scale the root pass computed, bitwise and with NaN / +-Inf rows),
   B11b (the root split, a mid-tree segment with an
   NA bin and with a categorical rank vector) and B11c (a finished
   partitioned tree's segment table) against their plain versions at 1M
   x 28, 63 bins, B11b bit for bit and B11a f32 within HIST_RTOL, int8
   exact, and B2/B2-cat with the mono_bounds form, the per-leaf CEGB
   penalty, the monotone penalty and contri bit for bit (also under
   path_smooth and max_delta_step); B11b through an EFB group column
   inside efb_kernels; partitioned_train (after constraint_wide_train):
   the partitioned learner on the per-iteration loop, six runs (the main
   configuration against the masked main path's first tree and AUC; 255
   leaves with WIDE_PARAMS against the batched wide path's AUC; monotone
   intermediate and advanced with no violation, advanced's training loss
   against basic's; forced splits starting every tree; quant_train int8),
   each with steady ms an iteration, host syncs a tree and B11a/b/c
   launches an iteration held to the learner's counts;
   fleet_kernels (after quant_kernels): the member forms B1-M, B1-K-M,
   B1-int-M, B1-K-int-M, B3-M, B3-K-M and B4-M at four members, each
   member bit for bit against its solo launch with one member on a dead
   step, and against the plain version (B1-M and B1-K-M within
   HIST_RTOL, the rest exact), timed beside four solo launches;
   fleet_train, fleet_sweep_train, fleet_ragged_train, fleet_quant_train
   and fleet_wide_train (after quant_wide_train, ``FLEET_CELLS``):
   ``fleet_train`` of seed replicas, of the lr x num_leaves sweep and of
   an lr sweep whose members leave the fleet early (``FLEET_RAGGED``:
   one rides its lane dead while the others train on, and the last
   finishes solo), every member's model text and best iteration equal to
   its solo run on the card, the fleet graph's launches held to
   ``fleet_per_iteration``, one ``fleet_fetch`` an epoch, the shared
   operands one tensor, the fleet's ms an iteration beside the members'
   solo ms summed;
   integrity_kernels (after fleet_kernels): the shadow set (the grower's
   libraries built a second time with ``-DLGBT_SHADOW_BUILD=1`` and
   loaded apart) grows a 31-leaf and a 255-leaf (K = 16) tree bit for bit
   as the primary set, each shadow launch counted under ``shadow:`` as
   the primary's, B1 through it bitwise the primary's; B17a (tree
   invariants) bit for bit against its plain version on the healthy
   trees, 72 single bit flips of counts, an infinite gain and a stump;
   B17b (score re-gather) on the healthy gather, a ``score_sdc`` flip,
   three flipped rows and an out-of-range leaf; B17c (feature totals
   residual) as the oracle on B1's root pass of the main data (its one
   launch, ``totals_oracle``), then within TOTALS_RTOL (exact for the
   int32 form) of its plain version on flipped f32 and int32 inputs;
   each timed, the shadow grow beside the primary's;
   wide_k_kernels (after wide_kernels): every K-shaped kernel at K = 32
   and 64 on the wide configuration's rows: whole 255-leaf trees with
   B3s-K and B3-K bit for bit at every super-step (``check_batched_tree``),
   then on the first super-step with all K slots valid B1-K within
   HIST_RTOL (bitwise on a rerun, ``check_b1k_card``), B1-K-int bit for
   bit, B3s-K and B3-K,
   B6-node on the 2K children bit for bit at two iterations, B2 on the 2K
   children with their masks and random bins and B2-cat on
   WIDE_K_CAT_COLS columns read as categories, each timed beside its
   bound and library call; rows_per_block: B1, B1-K and their integer
   forms at the automatic row block and at RPB_VALUES against their plain
   versions, bitwise on reruns, B1-K and the integer forms bitwise across the
   values, each timed, and the shadow grower's strict and K = 16 trees
   at an explicit value bit for bit as the primary's;
   hist_tune_train (after wide_train): HIST_TUNE_PARAMS as super-epochs
   for CUT_ROUNDS rounds on a cold table: one sweep of the shipped B1-K
   over K in {8, 16, 32, 64} x three row blocks (record, candidates,
   sweep seconds, ``tune_counts()``), the model bytes equal to the
   untuned run at the record's ``split_batch`` and ``rows_per_block``
   (launches: the tuned run's less the sweep's passes), a warm
   ``ensure`` from disk with no sweep, ms an iteration tuned, untuned and
   wide_train's (K = 16); quant_wide_k32_train and quant_wide_k64_train
   (after quant_wide_train) and cat_k32_train and cat_k64_train (after
   cat_cons_train): the per-iteration loop for WIDE_K_ROUNDS rounds at
   each width, ``quant_train`` at the wide configuration (B1-K-int) and
   the categorical set's 255-leaf configuration with
   feature_fraction_bynode 0.8 (B1-K, B3-K, B3s-K, B2, B2-cat, B6-node),
   launches held, reruns byte-identical;
   integrity_train (after the fleet cells): the main configuration
   per-iteration with ``integrity_check_freq=1`` for INTEGRITY_ROUNDS
   rounds: the unchecked run's model text and evals, launches held to
   ``checked_per_iteration(PER_ITERATION)`` (shadow launches the primary
   grower's), fetches ``integrity``, ``integrity_score``, ``tree`` and
   ``traced_eval`` once an iteration, ms an iteration checked and
   unchecked; ``hist_sdc:3`` and ``score_sdc:3`` absorbed byte-identically
   over INTEGRITY_FAULT_ROUNDS rounds, ``hist_sdc:3-4`` raising
   ``IntegrityFailure`` (kind sdc, iteration 3, leaf_count, the card
   named) under ``raise`` and ``quarantine`` (the card marked); and the
   255-leaf ``quant_train`` configuration checked the same way at
   CUT_ROUNDS;
   dist_kernels (after integrity_kernels): B16a (the best-split
   select, at S = 2, 4 and 8 ranks and 2 and 2K = 32 children, numerical
   and categorical records, the owner plan and the offset form) and
   B16c (the vote's top 2k and the masked histogram, f32 and int32) bit
   for bit against their plain versions on the card, B16b (the local
   gains and vote, f32 and a dequantized int32 histogram) within
   VOTE_RTOL with equal votes, at the HIGGS shape (28 features, 63
   bins), each timed beside its bound and library call;
   dist_nccl1 (after integrity_train): a one-rank NCCL process group
   running every operation of the port's communicator on card tensors
   (reduce-scatter, all-gather, SUM and MAX all-reduce; f32 and int32);
   dist_train: ``distributed.run`` spawns DIST_RANKS ranks that share the
   card over gloo (the communicator stages each operation through pinned
   host buffers, and the line names them) on the 1M x 28 rows split
   500k/500k, every rank evaluating the full valid set: DIST_CELLS
   (owner-shard data-parallel, full-reduce, batched K = 16 at 255 leaves,
   quant_train under data, voting with top_k DIST_TOP_K, feature); every
   rank's model text equal, the owner run's first tree's integer arrays
   equal to the serial per-iteration run's and its valid AUC within
   DIST_AUC_ATOL, the quant run's trees equal to the serial quant run's,
   B16a-c launched on every step of the fixed step sequence
   (``dist_per_iteration``); ms an iteration per rank, collective ms and
   bytes by CommLedger site;
   objectives_train (after multiclass_serve): each of the ten pointwise
   objectives on the HIGGS-shaped rows with a label in its domain, every
   path the JAX package allows with equal model text, the engine route's
   predictions equal to the host walk's;
10. serving_model: the serving model, SERVE_ROUNDS rounds of 31 leaves on
   the 1M x 28 train set without a valid set (fused chunks);
11. serve_kernels: B10a (forest walk), B10b (device binning) and B10c
   (fused forest predict) against their plain versions on the card, bit
   for bit, with the serving model's packed and int32 tables and with a
   synthetic SERVE_ROUNDS-tree forest with categorical splits and
   stumps, on the 200,000 valid rows with NaNs, exact threshold ties and
   out-of-range values; then each kernel's, plain version's and library
   call's times and bound on the plain valid rows;
12. predict: ``Booster.predict`` of the main path's booster and of the
   serving model on the 200,000 valid rows at ``predict_bucketed=auto``:
   the engine route (B10a launched once per bucket chunk of each call,
   counted around those calls alone), byte-identical to the host walk,
   ``pred_leaf`` equal to the host trees' leaves, rows/s of both routes
   and the engine route's breakdown (host binning, upload, walk, the
   [rows, trees] leaf-id fetch, host accumulation);
13. fused_serve: ``PredictorEngine.fused_predict`` on the 200,000 rows,
   byte-identical to ``_fused_reference`` on the rows where f32 and f64
   binning agree and to the fused plain version on all rows, with
   ``self_check(device_binning=True)``, the launches of those calls held
   to the self-check's probe chunks and one fused launch per chunk; the
   deviation from the host f64 path is reported;
14. serve_host and serve_fused: a ``Server`` over the serving model at the
   defaults and with ``serve_device_binning=true``: eight client threads
   send SERVE_REQUESTS requests of 1 to 64 rows, every answer is checked
   (against the host walk, or the fused reference and plain version),
   the launches of the server's load are held to its self-check's probe
   chunks and those of the requests to one per batch, no batch falls
   back to the host walk, the breaker stays
   closed; rows/s, p50/p99 latency and batches; one ``/predict`` and one
   ``/healthz`` round trip over HTTP on 127.0.0.1.

Then the ``kernels`` summary line, the card line, and the last line
``{"ok": true, "device": {...}}``.  Any failure raises, exits non-zero and
prints no ``ok`` line.  Without a CUDA card it exits with code 2.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_TRAIN, N_VALID, N_FEAT = 1_000_000, 200_000, 28
NUM_LEAVES, MAX_BIN, ROUNDS, ES_ROUNDS = 31, 63, 50, 10
# the serving model and the server's traffic (100 trees: the host walks
# that check every answer set the serving phases' time, which keeps the
# script within its limit)
SERVE_ROUNDS, SERVE_REQUESTS, SERVE_THREADS, SERVE_MAX_BATCH = \
    100, 2000, 8, 1024
# integer operations of one level of a forest walk (gathers, compares,
# selects), counted against the f32 rate: the published peaks used here
# list no int32 rate outside the tensor cores, and the H100 issues int32
# at half its f32 rate, so this bound is lower (stricter) than an int32
# one
WALK_OPS_PER_LEVEL = 12
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores
# integer operations of one threefry2x32: 20 rounds of an add, a rotation
# (two shifts and an or) and a xor (its five key injections not counted)
THREEFRY_OPS = 100
# B1 and B2 sum in another order than their plain versions (index_add_
# and torch.cumsum): f32 agreement relative to the largest magnitude of
# the histogram (B1) or of each field of the split records (B2)
HIST_RTOL = 1e-5
SPLIT_RTOL = 1e-4
# B12 sums f32 terms in blocks of 2048 in another order than the plain
# version (torch.sum, index_add_ and cumsum over 200,000 rows)
AUC_ATOL = 1e-5
POINTWISE_RTOL = 1e-5
METRICS = ["auc", "binary_logloss"]
PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")
# launches of each kernel in one iteration: the root pass and L - 1 steps
# of the grower (every step launches; a dead step's kernels exit at once),
# one valid walk and one kernel per metric
PER_ITERATION = {"histogram": NUM_LEAVES, "split": NUM_LEAVES,
                 "partition": NUM_LEAVES - 1, "grow_step": NUM_LEAVES - 1,
                 "histogram_slots": 0, "partition_slots": 0,
                 "grow_step_batched": 0, "bag_vals": 0, "goss_vals": 0,
                 "node_draws": 0, "predict": 1, "auc": 1, "pointwise": 1,
                 "forest_walk": 0, "bin_rows": 0, "fused_predict": 0,
                 "split_cat": 0, "multi_logloss": 0, "expand_group_hist": 0,
                 "lambdarank": 0, "xendcg": 0, "histogram_int": 0,
                 "histogram_slots_int": 0, "quant_scales": 0,
                 "quantize_stack": 0, "dequant_hist": 0,
                 "histogram_sparse": 0, "histogram_slots_sparse": 0,
                 "segment_histogram": 0, "segment_histogram_int": 0,
                 "partition_segment": 0, "leaf_of_row": 0,
                 "histogram_members": 0, "histogram_slots_members": 0,
                 "histogram_int_members": 0,
                 "histogram_slots_int_members": 0, "partition_members": 0,
                 "partition_slots_members": 0, "predict_members": 0}
# the integrity layer's kernels (B17a-c) and the kernels of the shadow
# set's libraries, counted under "shadow:<kernel>": none on an unchecked
# iteration (phase_environment holds these keys to the port's counters)
SHADOW_COUNTED = ("histogram", "split", "split_cat", "partition",
                  "grow_step", "histogram_slots", "partition_slots",
                  "grow_step_batched", "bag_vals", "goss_vals", "node_draws",
                  "expand_group_hist", "histogram_int",
                  "histogram_slots_int", "quant_scales", "quantize_stack",
                  "dequant_hist", "histogram_sparse",
                  "histogram_slots_sparse", "histogram_members",
                  "histogram_slots_members", "histogram_int_members",
                  "histogram_slots_int_members", "partition_members",
                  "partition_slots_members")
PER_ITERATION.update({"invariant_flags": 0, "score_recheck": 0,
                      "totals_residual": 0,
                      **{"shadow:" + k: 0 for k in SHADOW_COUNTED}})
# the distributed learners' kernels (B16a-c): none on a serial iteration
PER_ITERATION.update({"gather_best": 0, "vote_gains": 0,
                      "vote_select": 0})
# the kernels the grower launches (the bagging and GOSS draws run before
# it, the member forms in the fleet's lockstep grower): the shadow grower
# launches each of them as often as the primary one
GROWER_KERNELS = tuple(k for k in SHADOW_COUNTED
                       if k not in ("bag_vals", "goss_vals")
                       and not k.endswith("_members"))
# without a valid set: no walk and no metric
PER_ITERATION_NO_VALID = {**PER_ITERATION, "predict": 0, "auc": 0,
                          "pointwise": 0}
# the wide path: 255 leaves (split_batch auto -> 16), bagging and
# feature_fraction; the reference's headline tree shape
# (docs/Experiments.rst, bench.py higgs1m_255leaf)
WIDE_LEAVES, WIDE_K = 255, 16
WIDE_PARAMS = {"num_leaves": WIDE_LEAVES, "bagging_fraction": 0.8,
               "bagging_freq": 5, "feature_fraction": 0.8}
# per iteration: the root pass (B1, B2), L - 1 super-steps (B3s-K, B3-K,
# B1-K and B2 on the 2K children; a dead super-step's kernels exit at
# once), one bagging draw, one valid walk, one kernel per metric
WIDE_PER_ITERATION = {**{k: 0 for k in PER_ITERATION},
                      "histogram": 1, "split": WIDE_LEAVES,
                      "histogram_slots": WIDE_LEAVES - 1,
                      "partition_slots": WIDE_LEAVES - 1,
                      "grow_step_batched": WIDE_LEAVES - 1, "bag_vals": 1,
                      "predict": 1, "auc": 1, "pointwise": 1}
# GOSS (top_rate 0.2, other_rate 0.1 by default) with
# feature_fraction_bynode at the wide shape: the GOSS draw replaces the
# bagging draw, and the root and every super-step draw their children's
# feature subsets (B6-node)
GOSS_PARAMS = {"num_leaves": WIDE_LEAVES, "data_sample_strategy": "goss",
               "feature_fraction_bynode": 0.8}
GOSS_PER_ITERATION = {**WIDE_PER_ITERATION, "bag_vals": 0, "goss_vals": 1,
                      "node_draws": WIDE_LEAVES}
# extra_trees with feature_fraction_bynode at the main path's shape: the
# root and every step of the strict grower draw masks and random bins
EXTRA_PARAMS = {"num_leaves": NUM_LEAVES, "extra_trees": True,
                "feature_fraction_bynode": 0.8}
EXTRA_PER_ITERATION = {**PER_ITERATION, "node_draws": NUM_LEAVES}
SAMPLED_PER_ITERATION_ROUNDS = 10
# the super-epoch rounds of goss_train, cat_train and cat_strict_train,
# cut from ROUNDS so that the script keeps near its former length beside
# the ranking and objective cells
CUT_ROUNDS = 20
# the categorical cells: an airline-shaped set (the reference's Expo
# experiment, docs/Experiments.rst, in the common 8-column airline schema):
# Month, DayofMonth, DayOfWeek, UniqueCarrier, Origin and Dest categorical
# (Origin and Dest Zipf-skewed), DepTime and Distance numerical; rows cut
# to N_TRAIN / N_VALID, columns and cardinalities not cut
CAT_COLS = (0, 1, 2, 3, 4, 5)
CAT_CARDS = (12, 31, 7, 22, 300, 300)
CAT_ZIPF = (0.2, 0.1, 0.2, 0.9, 1.1, 1.1)
CAT_EFFECT = (0.4, 0.2, 0.3, 0.8, 1.0, 1.0)
CAT_MAX_BIN = 255
# the wide path's settings without sampling, at 255 bins
CAT_PARAMS = {"num_leaves": WIDE_LEAVES, "max_bin": CAT_MAX_BIN}
# per iteration: the wide path's launches without the bagging draw, and
# B2-cat beside every B2
CAT_PER_ITERATION = {**WIDE_PER_ITERATION, "bag_vals": 0,
                     "split_cat": WIDE_LEAVES}
CAT_STRICT_PARAMS = {**CAT_PARAMS, "num_leaves": NUM_LEAVES}
CAT_STRICT_PER_ITERATION = {**PER_ITERATION, "split_cat": NUM_LEAVES}
# the multiclass cells: a Covertype-shaped set (UCI Covertype, Blackard &
# Dean 1999; scikit-learn's fetch_covtype): 581,012 rows, 10 integer
# numeric columns, 4 wilderness and 40 soil one-hot columns, 7 classes at
# Covertype's counts; 80/20 train and valid, at the default
# enable_bundle (the one-hot blocks bundle)
COVTYPE_ROWS, COVTYPE_AREAS, COVTYPE_SOILS = 581_012, 4, 40
COVTYPE_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
MC_CLASSES, MC_MAX_BIN, MC_ROUNDS, MC_OVA_ROUNDS, MC_WIDE_ROUNDS = \
    7, 255, 20, 20, 10
# rounds of the traced multiclass run (the tracer's post-processing
# grows with the launches it saw)
MC_PROFILE_ROUNDS = 5
MC_PARAMS = {"objective": "multiclass", "num_class": MC_CLASSES,
             "num_leaves": NUM_LEAVES, "max_bin": MC_MAX_BIN,
             "learning_rate": 0.1,
             "metric": ["multi_logloss", "multi_error"], "verbosity": -1}
MC_WIDE_PARAMS = {"num_leaves": WIDE_LEAVES, "bagging_fraction": 0.8,
                  "bagging_freq": 5, "feature_fraction": 0.8}
# launches of one tree: the strict grower's (PER_ITERATION's grower
# part), and the batched grower's with bagging (WIDE_PER_ITERATION's:
# the bagging draw runs once a class, on the iteration's one mask)
# the bundled one-hot blocks add B9 beside every B2
MC_PER_TREE = {**{k: 0 for k in PER_ITERATION},
               **{k: PER_ITERATION[k] for k in ("histogram", "split",
                                                "partition", "grow_step")},
               "expand_group_hist": NUM_LEAVES}
MC_WIDE_PER_TREE = {**{k: 0 for k in PER_ITERATION},
                    **{k: WIDE_PER_ITERATION[k] for k in (
                        "histogram", "split", "histogram_slots",
                        "partition_slots", "grow_step_batched",
                        "bag_vals")}, "expand_group_hist": WIDE_LEAVES}
# the traced multi_logloss (f32, B12c) and the host metric (numpy f32
# softmax and a pairwise mean) against the same formula in f64 over the
# 116,203 valid rows: f32 sums of the same terms in other orders, and
# expf against numpy's exp
MC_TRACED_RTOL = 1e-4
# the valid rows multiclass_serve predicts and serves (its host-walk
# checks of a 350-tree model take seconds per 10,000 rows)
MC_SERVE_ROWS = 40_000
# the EFB cells: a Flight-Delay-shaped binary set after the EFB experiment
# of Ke et al. 2017 (the airline on-time data, one-hot encoded): Month,
# DayofMonth, DayOfWeek, UniqueCarrier, Origin and Dest one-hot (Origin
# and Dest Zipf-skewed as CAT_ZIPF), DepTime and Distance numerical; rows
# cut from the paper's 10M, airports capped at 255 so that every bundle
# keeps to 256 bins (uint8) until ROADMAP A9.5
EFB_CARDS = (12, 31, 7, 22, 255, 255)
EFB_TRAIN, EFB_VALID, EFB_MAX_BIN = 500_000, 100_000, 255
EFB_COLS = sum(EFB_CARDS) + 2
# the six one-hot blocks as six groups, DepTime and Distance singletons
EFB_GROUPS = 8
# the main path's configuration at 255 bins (train_main's binary, 31
# leaves, auc and logloss, early stopping); the wide one (255 leaves,
# K = 16, bagging) for EFB_WIDE_ROUNDS rounds
EFB_PARAMS = {"num_leaves": NUM_LEAVES, "max_bin": EFB_MAX_BIN}
EFB_PER_ITERATION = {**PER_ITERATION, "expand_group_hist": NUM_LEAVES}
EFB_WIDE_PARAMS = {"num_leaves": WIDE_LEAVES, "max_bin": EFB_MAX_BIN,
                   "bagging_fraction": 0.8, "bagging_freq": 5}
EFB_WIDE_PER_ITERATION = {**WIDE_PER_ITERATION,
                          "expand_group_hist": WIDE_LEAVES}
EFB_WIDE_ROUNDS = 10
# the bundled run against its unbundled twin: on exact gradients (every
# histogram sum exact in f32) the two write the same trees, bit for bit,
# in EFB_EXACT_ROUNDS rounds; on the binary run the bundled first tree's
# leaf values sit within EFB_LEAF_RTOL of the f64 sums of their rows (f32
# sums of up to 500,000 rows: B1 sums a one-hot feature's bin 0, nearly
# every row, in f64; the unbundled one within EFB_UNBUNDLED_LEAF_RTOL),
# and the two first trees are equal in structure
EFB_EXACT_ROUNDS = 10
EFB_LEAF_RTOL = 1e-4
# the unbundled first tree's leaves: B1 now sums bin 0 in f64, but a small
# leaf's sums still come through f32 prefix sums over 255 bins (B2) and
# f32 parent - child subtractions of bins that hold nearly every row, the
# JAX package's own arithmetic (the bundled run rebuilds bin 0 from the
# leaf's totals instead)
EFB_UNBUNDLED_LEAF_RTOL = 2e-4
# the ranking cells: an MSLR-WEB30K-Fold1-shaped set (Microsoft's LETOR web
# search set, Qin & Liu 2013; the reference's "MS LTR" row of
# docs/Experiments.rst): 2,270,296 train documents in about 18,900 queries
# (about 120 a query, a tail to 1,251), 136 features, relevance labels 0-4
# at about 51/33/13/2/1 %; 200,000 valid documents from another seed; 255
# bins at the default enable_bundle
RANK_TRAIN, RANK_FEAT, RANK_VALID, RANK_MAX_QUERY = \
    2_270_296, 136, 200_000, 1_251
RANK_LABEL_SHARE = (0.51, 0.33, 0.13, 0.02, 0.01)
RANK_MAX_BIN = 255
RANK_PARAMS = {"objective": "lambdarank", "num_leaves": WIDE_LEAVES,
               "learning_rate": 0.1, "max_bin": RANK_MAX_BIN,
               "metric": "ndcg", "eval_at": [1, 3, 5, 10], "verbosity": -1}
# (RANK_ROUNDS cut from 20, XENDCG_ROUNDS from 10, MC_ROUNDS from 50 and
# OBJ_ROUNDS from 10, and the wide, extra, constraint and unbundled EFB
# runs to CUT_ROUNDS, when the distributed phases came, to keep the
# script well inside its limit on a slow host)
RANK_ROUNDS, XENDCG_ROUNDS, RANK_PROFILE_ROUNDS = 10, 5, 5
# B13 against its plain version: f32 sums of the same pair terms in
# another order, g and h within this share of each query's largest |g|
# (|h|)
RANK_GRAD_RTOL = 1e-5
# f32 operations of one pair B13a's function needs: delta 5 (two
# differences, a product, abs, the 1/maxDCG product), the clipped sigmoid
# argument 4, p 3 (exp among them), lambda 2, the hessian term 4, two sums
RANK_PAIR_OPS = 20
# a query past csrc/rank.cu's shared-memory tile (kTile, 2,048 documents):
# the global tile loop
RANK_BIG_QUERY = 5_000
# per iteration of rank_train: the wide grower without bagging, one valid
# walk and B13a (B9 beside every B2 when the set bundles)
RANK_PER_ITERATION = {**WIDE_PER_ITERATION, "bag_vals": 0, "auc": 0,
                      "pointwise": 0, "lambdarank": 1}
# the ten pointwise objectives on the HIGGS-shaped rows (objectives_train):
# the main path's tree shape, OBJ_ROUNDS rounds each
OBJECTIVES_FUSABLE = ("huber", "fair", "poisson", "gamma", "tweedie",
                      "cross_entropy", "cross_entropy_lambda")
OBJECTIVES_RENEWING = ("regression_l1", "quantile", "mape")
OBJ_ROUNDS = 5
OBJ_PARAMS = {"num_leaves": NUM_LEAVES, "max_bin": MAX_BIN,
              "learning_rate": 0.1, "verbosity": -1}
# the quantized cells (quant_train=true, int8 stochastic rounding): the
# main configuration; the wide one with bagging (B1-K-int), CUT_ROUNDS
# super-epoch rounds; rank_train's lambdarank for QUANT_RANK_ROUNDS
# per-iteration rounds; efb_train's bundled set with nearest rounding for
# QUANT_EFB_ROUNDS rounds.  Each iteration packs its rows once (B7a, B7b);
# every histogram pass takes the integer form (B1-int, B1-K-int) and every
# split scan's children are dequantized first (B7c, as often as B2)
QUANT = {"quant_train": True, "quant_bits": 8, "quant_round": "stochastic"}
QUANT_PARAMS = {"num_leaves": NUM_LEAVES, **QUANT}
QUANT_ONCE = {"quant_scales": 1, "quantize_stack": 1}
QUANT_PER_ITERATION = {**PER_ITERATION, **QUANT_ONCE, "histogram": 0,
                       "histogram_int": NUM_LEAVES,
                       "dequant_hist": NUM_LEAVES}
QUANT_WIDE_PARAMS = {**WIDE_PARAMS, **QUANT}
QUANT_WIDE_PER_ITERATION = {**WIDE_PER_ITERATION, **QUANT_ONCE,
                            "histogram": 0, "histogram_int": 1,
                            "histogram_slots": 0,
                            "histogram_slots_int": WIDE_LEAVES - 1,
                            "dequant_hist": WIDE_LEAVES}
# the quantized main cell's valid AUC against the f32 main path's at the
# same round: the JAX package's own epsilon (tests/test_quant.py:168-174)
QUANT_AUC_GAP = 0.02
# quant_rank: NDCG@10 at round QUANT_RANK_ROUNDS against rank_train's
# (the JAX package's lambdarank epsilon)
QUANT_RANK_ROUNDS, QUANT_NDCG_GAP = 5, 0.05
QUANT_RANK_PER_ITERATION = {**RANK_PER_ITERATION, **QUANT_ONCE,
                            "histogram": 0, "histogram_int": 1,
                            "histogram_slots": 0,
                            "histogram_slots_int": WIDE_LEAVES - 1,
                            "dequant_hist": WIDE_LEAVES}
QUANT_EFB_PARAMS = {**EFB_PARAMS, **QUANT, "quant_round": "nearest"}
QUANT_EFB_ROUNDS = 10
QUANT_EFB_PER_ITERATION = {**EFB_PER_ITERATION, **QUANT_ONCE,
                           "histogram": 0, "histogram_int": NUM_LEAVES,
                           "dequant_hist": NUM_LEAVES}
# the sparse cells: an Allstate-shaped set (the reference's Allstate
# experiment, docs/Experiments.rst: 13.2M rows of 4,228 dummy-encoded
# columns) drawn as the JAX package's own width test draws it
# (tests/test_sparse_bin.py:204-232); rows cut to 1M train and 200k valid.
# The EFB search finds no bundle on such data (every column pair shares
# rows) but costs minutes at this width, so the set is built with
# enable_bundle=false: the layout is the same either way
SPARSE_TRAIN, SPARSE_VALID = 1_000_000, 200_000
SPARSE_COLS, SPARSE_NNZ = 4228, 35
SPARSE_DATA_PARAMS = {"verbosity": -1, "enable_bundle": False}
SPARSE_PARAMS = {"num_leaves": NUM_LEAVES}
SPARSE_PI_ROUNDS = 20
# per iteration on the per-iteration loop with the k-hot valid set: the
# strict grower with B8a in place of B1, one valid walk, host metrics
SPARSE_PER_ITERATION = {**PER_ITERATION, "histogram": 0,
                        "histogram_sparse": NUM_LEAVES, "auc": 0,
                        "pointwise": 0}
SPARSE_WIDE_PER_ITERATION = {**WIDE_PER_ITERATION, "histogram": 0,
                             "histogram_sparse": 1, "histogram_slots": 0,
                             "histogram_slots_sparse": WIDE_LEAVES - 1,
                             "auc": 0, "pointwise": 0}
# the first tree's leaves against the f64 sums of their rows (the EFB
# precedent, EFB_LEAF_RTOL)
SPARSE_LEAF_RTOL = 1e-4
# the int16 lanes' row cap: rows * 32767 must stay under 2^31
INT16_MAX_ROWS = (2 ** 31 - 1) // 32767
# the split controls (constraint_kernels, constraint_train,
# constraint_wide_train) on the HIGGS-shaped rows: monotone +1 on
# features 0-3 and -1 on 4-5 with monotone_penalty 1 (no monotone split
# at the root, half gain at depth 1), three overlapping interaction
# groups, feature_contri 0.5 on features 20-27, and CEGB: a split penalty
# of CEGB_SPLIT a row and a coupled penalty on features 10-27 (none on
# 0-9).  The root may split only on non-monotone features, whose gains
# are noise here (1.3-8.2 at iteration 0, after contri): without CEGB it
# takes feature 17 and keeps every tree in the second group, away from the
# signal of features 0-4 (12 features, valid AUC 0.50); a coupled penalty
# of CEGB_COUPLED (50) moves it to feature 9 and the trees to the first
# group.  The wide cell draws each root from half the features (bynode
# 0.5), which may leave out 6-9, so its coupled penalty is
# CEGB_WIDE_COUPLED (3): enough that each penalty alone changes the first
# tree and the run uses fewer features, small enough that every root
# keeps a split.  constraint_after checks both
CONS_MONO = [1, 1, 1, 1, -1, -1] + [0] * (N_FEAT - 6)
CONS_INTER = (tuple(range(0, 10)), tuple(range(8, 20)),
              tuple(range(18, N_FEAT)))
CEGB_SPLIT, CEGB_COUPLED, CEGB_WIDE_COUPLED = 1e-7, 50.0, 3.0
CONS_PARAMS = {"monotone_constraints": CONS_MONO, "monotone_penalty": 1.0,
               "interaction_constraints": ",".join(
                   "[" + ",".join(map(str, g)) + "]" for g in CONS_INTER),
               "feature_contri": [1.0] * 20 + [0.5] * (N_FEAT - 20),
               "cegb_penalty_split": CEGB_SPLIT,
               "cegb_penalty_feature_coupled":
                   [0.0] * 10 + [CEGB_COUPLED] * (N_FEAT - 10)}
# constraint_kernels also compares B2 and B2-cat with the controls under
# path_smooth and max_delta_step (outputs there are about +-2)
CONS_PATH_SMOOTH, CONS_MAX_DELTA_STEP = 2.0, 0.5
# the valid rows swept across each monotone feature's bin bounds
CONS_SWEEP_ROWS = 1000
# the live step (strict) and super-step (K = 16) whose inputs
# constraint_kernels times
CONS_TIMED_STEP = {1: 10, WIDE_K: 4}
# the controls ride the unconstrained launches: constraint_train is held
# to PER_ITERATION, constraint_wide_train (255 leaves, bynode 0.5, no
# bagging) to the wide grower's launches with a node draw a step, as the
# same run without the controls (trained beside it)
CONS_WIDE_BASE = {"num_leaves": WIDE_LEAVES, "feature_fraction_bynode": 0.5}
CONS_WIDE_PARAMS = {**CONS_WIDE_BASE, **CONS_PARAMS,
                    "cegb_penalty_feature_coupled":
                        [0.0] * 10 + [CEGB_WIDE_COUPLED] * (N_FEAT - 10)}
CONS_WIDE_PER_ITERATION = {**WIDE_PER_ITERATION, "bag_vals": 0,
                           "node_draws": WIDE_LEAVES}
# B2-cat with its control operands on a train path: cat_strict_train's
# airline-shaped set with monotone +1 on DepTime and Distance (the
# label rises with both), penalty, contri below 1 on two categorical
# columns and CEGB (a coupled penalty on one), held to
# CAT_STRICT_PER_ITERATION
CAT_CONS_MONO = [0] * len(CAT_COLS) + [1, 1]
CAT_CONS_PARAMS = {**CAT_STRICT_PARAMS, "monotone_constraints": CAT_CONS_MONO,
                   "monotone_penalty": 1.0,
                   "feature_contri": [1.0] * 4 + [0.9, 0.9, 1.0, 1.0],
                   "cegb_penalty_split": CEGB_SPLIT,
                   "cegb_penalty_feature_coupled":
                       [0.0] * 4 + [CEGB_WIDE_COUPLED] + [0.0] * 3}
# the partitioned learner (partitioned_kernels, partitioned_*_train): the
# small segment B11a is timed on (about a strict step's smaller child at
# the main path); the main configuration's best valid AUC against the
# masked strict main path's (the same first tree; later trees' f32 sums
# differ in order, the masked root totals from the rows, the partitioned
# from the root histogram); the 255-leaf strict run's AUC against the
# batched wide path's at the same round (a different growth order: top-K
# batches against strict leaf-wise); advanced's training logloss against
# basic's on the same learner (the JAX package's criterion,
# tests/test_constraints.py:164-178); the forced cell's rounds
PART_SMALL_ROWS = 7_500
PART_AUC_ATOL = 1e-3
PART_WIDE_AUC_GAP = 0.01
PART_ADV_LOSS_RATIO = 1.05
PART_FORCED_ROUNDS = 10
KERNEL_ORDER = ("histogram", "split", "split_per_child", "split_cat",
                "partition",
                "grow_step", "histogram_slots", "partition_slots",
                "grow_step_batched", "bag_vals", "goss_vals", "node_draws",
                "predict", "predict_column", "auc", "pointwise",
                "multi_logloss", "expand_group_hist", "lambdarank",
                "xendcg", "quant_scales", "quantize_stack", "dequant_hist",
                "histogram_int", "histogram_slots_int",
                "histogram_sparse", "histogram_slots_sparse",
                "partition_sparse", "partition_slots_sparse",
                "predict_sparse", "split_cons", "split_cat_cons",
                "grow_step_cons", "grow_step_batched_cons",
                "node_draws_base", "segment_histogram",
                "segment_histogram_int", "partition_segment", "leaf_of_row",
                "split_mono_bounds", "forest_walk", "bin_rows",
                "fused_predict")
# the launch counter of a kernels-line entry, where it is not its own key
# (B2's per-child form is B2's wrapper and counter, B4's column form B4's)
KERNEL_COUNTER = {"split_per_child": "split", "predict_column": "predict",
                  "partition_sparse": "partition",
                  "partition_slots_sparse": "partition_slots",
                  "predict_sparse": "predict", "split_cons": "split",
                  "split_cat_cons": "split_cat",
                  "grow_step_cons": "grow_step",
                  "grow_step_batched_cons": "grow_step_batched",
                  "node_draws_base": "node_draws",
                  "split_mono_bounds": "split"}
# the path whose run gives a kernel's ``launches`` (the main path's where
# not listed)
KERNEL_PATH = {"forest_walk": "predict", "bin_rows": "serve_fused",
               "fused_predict": "serve_fused",
               "histogram_slots": "wide_train",
               "partition_slots": "wide_train",
               "grow_step_batched": "wide_train", "bag_vals": "wide_train",
               "goss_vals": "goss_train", "node_draws": "goss_train",
               "split_per_child": "extra_train", "split_cat": "cat_train",
               "predict_column": "multiclass_train",
               "multi_logloss": "multiclass_train_fused_eval",
               "expand_group_hist": "efb_train",
               "lambdarank": "rank_train", "xendcg": "xendcg_train",
               "quant_scales": "quant_train", "quantize_stack": "quant_train",
               "dequant_hist": "quant_train", "histogram_int": "quant_train",
               "histogram_slots_int": "quant_wide_train",
               "histogram_sparse": "sparse_train",
               "histogram_slots_sparse": "sparse_wide_train",
               "partition_sparse": "sparse_train",
               "partition_slots_sparse": "sparse_wide_train",
               "predict_sparse": "sparse_train_per_iteration",
               "split_cons": "constraint_train",
               "split_cat_cons": "cat_cons_train",
               "grow_step_cons": "constraint_train",
               "grow_step_batched_cons": "constraint_wide_train",
               "node_draws_base": "constraint_wide_train",
               "segment_histogram": "partitioned_train",
               "segment_histogram_int": "partitioned_quant_train",
               "partition_segment": "partitioned_train",
               "leaf_of_row": "partitioned_train",
               "split_mono_bounds": "partitioned_advanced_train"}
# the fleet (fleet_kernels, fleet_*_train): FLEET_MEMBERS seed replicas
# of the main configuration with bagging 0.8 every 5 and
# feature_fraction 0.8 (without sampling, seed replicas would be one
# model); the lr x num_leaves sweep with early stopping at 5 (mixed leaf
# budgets, 31 and 63: the lockstep runs 62 steps); the lr sweep
# 0.2|0.5|0.8 with early stopping at 3 (the CPU test's ragged roster),
# whose larger rates stop at different epochs, so a member rides its lane
# dead and the last one finishes through the solo path; quant_train
# int8 and the wide shape (255 leaves, bagging, K = 16) with 2 members
# each, at CUT_ROUNDS.  Every member's model text is held to its solo run
# on the card
FLEET_MEMBERS = 4
FLEET_RAGGED = "fleet_ragged_train"
FLEET_BASE = {"objective": "binary", "max_bin": MAX_BIN,
              "learning_rate": 0.1, "metric": METRICS, "verbosity": -1,
              "first_metric_only": True, "early_stopping_round": ES_ROUNDS}
FLEET_CELLS = (
    ("fleet_train", {"num_leaves": NUM_LEAVES, "bagging_fraction": 0.8,
                     "bagging_freq": 5, "feature_fraction": 0.8,
                     "fleet_members": FLEET_MEMBERS}, ROUNDS),
    ("fleet_sweep_train", {"num_leaves": NUM_LEAVES,
                           "fleet_sweep": "learning_rate=0.05|0.1;"
                                          "num_leaves=31|63",
                           "early_stopping_round": 5}, ROUNDS),
    (FLEET_RAGGED, {"num_leaves": NUM_LEAVES,
                    "fleet_sweep": "learning_rate=0.2|0.5|0.8",
                    "early_stopping_round": 3}, ROUNDS),
    ("fleet_quant_train", {"num_leaves": NUM_LEAVES, **QUANT,
                           "fleet_members": 2}, CUT_ROUNDS),
    ("fleet_wide_train", {**WIDE_PARAMS, "fleet_members": 2}, CUT_ROUNDS))
# the member forms' kernels-line rows, and the fleet cell whose run gives
# each one's launches
FLEET_KERNELS = ("histogram_members", "histogram_slots_members",
                 "histogram_int_members", "partition_members",
                 "partition_slots_members", "predict_members")
KERNEL_ORDER = KERNEL_ORDER + FLEET_KERNELS
KERNEL_PATH.update({"histogram_members": "fleet_train",
                    "histogram_slots_members": "fleet_wide_train",
                    "histogram_int_members": "fleet_quant_train",
                    "partition_members": "fleet_train",
                    "partition_slots_members": "fleet_wide_train",
                    "predict_members": "fleet_train"})


# the integrity layer (integrity_kernels, integrity_train): the rounds of
# the checked main run and its unchecked twin (per-iteration), and of the
# injected runs; the timed grows of each set in the shadow row; B17c sums
# in f64 in another order than its plain version (torch.sum), so the two
# agree within TOTALS_RTOL of the largest column total (or residual)
INTEGRITY_ROUNDS, INTEGRITY_FAULT_ROUNDS, SHADOW_GROW_REPS = 20, 6, 10
TOTALS_RTOL = 1e-9
INTEGRITY_KERNELS = ("invariant_flags", "score_recheck", "totals_residual",
                     "shadow_grow")
KERNEL_ORDER = KERNEL_ORDER + INTEGRITY_KERNELS
KERNEL_PATH.update({"invariant_flags": "integrity_train",
                    "score_recheck": "integrity_train",
                    "shadow_grow": "integrity_train",
                    "totals_residual": "totals_oracle"})
# the wide widths K = 32 and 64 (wide_k_kernels and the wide-K cells):
# every K-shaped kernel against its plain version at both widths on whole
# 255-leaf trees of the wide configuration's rows, then the per-iteration
# loop for WIDE_K_ROUNDS rounds at each width on two cells whose launches
# give the K forms' rows: quant_train at the wide configuration
# (B1-K-int) and the categorical set's wide configuration with
# feature_fraction_bynode 0.8 (B1-K, B3-K, B3s-K, B2 on 2K children,
# B2-cat, B6-node); B2-cat's check reads the first WIDE_K_CAT_COLS columns
# of the HIGGS-shaped rows as categories
WIDE_KS = (32, 64)
WIDE_K_ROUNDS = 5
WIDE_K_CAT_COLS = 4
WIDE_K_FORMS = ("histogram_slots", "histogram_slots_int", "partition_slots",
                "grow_step_batched", "split_per_child", "split_cat",
                "node_draws")
WIDE_K_KERNELS = tuple(f"{form}_k{K}" for K in WIDE_KS
                       for form in WIDE_K_FORMS)
KERNEL_ORDER = KERNEL_ORDER + WIDE_K_KERNELS
KERNEL_COUNTER.update({f"{form}_k{K}": "split" if form == "split_per_child"
                       else form for K in WIDE_KS for form in WIDE_K_FORMS})
KERNEL_PATH.update({f"{form}_k{K}": f"quant_wide_k{K}_train"
                    if form == "histogram_slots_int" else f"cat_k{K}_train"
                    for K in WIDE_KS for form in WIDE_K_FORMS})
# the explicit row blocks of the rows_per_block phase, beside the automatic
# one (7,580 rows for B1 and 7,680 for B1-K at 1M rows)
RPB_VALUES = (2048, 16384)
# hist_tune_train: the wide configuration with the tuner on, at CUT_ROUNDS
HIST_TUNE_PARAMS = {**WIDE_PARAMS, "hist_tune": "on"}
# every library's build seconds (phase_environment)
BUILD_S = {}


# distributed training (dist_kernels, dist_nccl1, dist_train): B16a
# (the best-split select), B16b (the local vote) and B16c (the global
# vote's mask), counted on the owner-shard and voting cells; the cells'
# (name, parameters, rounds) on DIST_RANKS ranks sharing the card; B16b's
# gains within VOTE_RTOL of its plain version (votes equal); the owner
# run's valid AUC within DIST_AUC_ATOL of the serial run's
DIST_KERNELS = ("gather_best", "vote_gains", "vote_select")
KERNEL_ORDER = KERNEL_ORDER + DIST_KERNELS
KERNEL_PATH.update({"gather_best": "dist_owner_train",
                    "vote_gains": "dist_voting_train",
                    "vote_select": "dist_voting_train"})
DIST_RANKS, DIST_TOP_K = 2, 4
DIST_SHAPES = (2, 4, 8)
DIST_CELLS = (
    ("owner", {"tree_learner": "data"}, 20),
    ("full", {"tree_learner": "data", "dp_owner_shard": False}, 5),
    ("batched", {"tree_learner": "data", "num_leaves": WIDE_LEAVES}, 5),
    ("quant", {"tree_learner": "data", **QUANT}, 10),
    ("voting", {"tree_learner": "voting", "top_k": DIST_TOP_K}, 10),
    ("feature", {"tree_learner": "feature"}, 10),
)
VOTE_RTOL = 1e-6
DIST_AUC_ATOL = 1e-3


def fleet_per_iteration(leaves, K: int, bagging: bool, quant: bool,
                        valid_sets: int = 1) -> dict:
    """A fleet iteration's launches (the captured body) of members with
    leaf budgets ``leaves`` and split batch K: the shared passes once for
    every member a step of the largest budget (B1-M and B3-M strict, the
    root's B1-M and B1-K-M and B3-K-M batched, their integer forms under
    quant) and one B4-M a valid set; the rest a member at a time (B3s or
    B3s-K a step of its own budget, B2 a node, the bagging draw, B7a/B7b
    a tree and B7c as often as B2, the two metrics)."""
    M, Lmax = len(leaves), max(leaves)
    out = {"split": sum(leaves), "predict_members": valid_sets,
           "auc": M * valid_sets, "pointwise": M * valid_sets}
    if K == 1:
        hist = "histogram_int_members" if quant else "histogram_members"
        out.update({hist: Lmax, "partition_members": Lmax - 1,
                    "grow_step": sum(L - 1 for L in leaves)})
    else:
        out.update({"histogram_int_members" if quant
                    else "histogram_members": 1,
                    "histogram_slots_int_members" if quant
                    else "histogram_slots_members": Lmax - 1,
                    "partition_slots_members": Lmax - 1,
                    "grow_step_batched": sum(L - 1 for L in leaves)})
    if bagging:
        out["bag_vals"] = M
    if quant:
        out.update({"quant_scales": M, "quantize_stack": M,
                    "dequant_hist": sum(leaves)})
    return out


def times(counts, n: int):
    return {k: n * v for k, v in counts.items()}


def source_digest(root: Path = Path(__file__).resolve().parent) -> str:
    """sha256 over the relative path and bytes of this script and every
    ``.py``, ``.cu`` and ``.cuh`` file of ``lightgbm_torch``: names the
    code a run measured.  Raises if the package is not beside the script."""
    pkg = root / "lightgbm_torch"
    files = sorted(p for p in pkg.rglob("*")
                   if p.suffix in (".py", ".cu", ".cuh")
                   and "_build" not in p.relative_to(pkg).parts)
    if not files:
        raise FileNotFoundError(f"no lightgbm_torch sources under {root}")
    h = hashlib.sha256()
    for p in [root / "chip_smoke.py", *files]:
        h.update(str(p.relative_to(root)).encode() + b"\0")
        h.update(p.read_bytes() + b"\0")
    return h.hexdigest()


_START = time.perf_counter()


def emit(obj) -> None:
    """Print ``obj`` as one JSON line; a phase line also carries ``t``,
    the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def make_higgs_like(n: int, f: int, seed: int):
    """bench.py's synthetic HIGGS-shaped recipe."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    logit = (1.2 * x[:, 0] - 0.8 * x[:, 1] + 0.6 * x[:, 2] * x[:, 3]
             + 0.4 * np.abs(x[:, 4]) + 0.5 * rng.randn(n))
    return x, (logit > 0).astype(np.float32)


def median_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median milliseconds of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def iteration_bound(trees, n: int, f: int, B: int, L: int, nv: int,
                    super_steps=None, scan=None):
    """The least time of one boosting iteration of the main path, from
    its own trees: the bytes and operations each step needs at the row
    counts that tree gave it, averaged over the trees.  Per iteration:
    gradients (score, label, weight read, [N, 3] vals written), the
    root's histogram pass (every row's bins and vals), the train-score
    update (score read and written, row -> leaf read), the valid walk
    (B4's bytes) and the two metrics (B12's).  Per active split step: B3s
    (table, tree buffer read and written), B3 over the split leaf's rows
    (column byte and leaf id read, leaf id written), B1 over the smaller
    child's rows (bins and vals) and its histogram out, the subtraction
    (three histograms), B2 on the pair (two histograms in, two records
    out).  A dead step needs nothing.  With ``super_steps`` (the live
    super-steps of each tree, batched growth) the bookkeeping (B3s-K: the
    table and the tree buffer) is counted once per super-step, and the
    rest per split.  With ``scan`` = (F, Bs) (EFB) ``f`` and ``B`` are the
    bundled matrix's G columns and group bins, the histogram passes and
    the subtraction work in group space, and each child's histogram is
    expanded (B9: its group histogram read, its [F, Bs, 3] written) before
    B2 reads it.  Returns (ms, by, bytes)."""
    from lightgbm_torch.grower import tree_words
    hist = f * B * 12
    sf, sb = (f, B) if scan is None else scan
    shist = sf * sb * 12
    rec = 12 * 4
    expand = 0 if scan is None else hist + shist
    fixed = (24 * n + n * (f + 12) + hist + expand + shist + rec + 12 * n
             + nv * f + 8 * nv + 2 * (12 * nv + 4))
    fixed_ops = (12 * n + 3 * n * f + 40 * 2 * sf * sb + 2 * n + 7 * nv
                 + nv * float(np.log2(nv)) + 10 * nv + 30 * nv)
    books = L * rec + 2 * tree_words(L) * 4
    step = 4 * hist + 2 * expand + 2 * shist + 2 * rec \
        + (books if super_steps is None else 0)
    step_ops = 40 * 2 * 2 * sf * sb + 3 * f * B
    total = ops = 0.0
    for i, t in enumerate(trees):
        if super_steps is not None:
            total += books * super_steps[i]
        for s in range(t.num_leaves - 1):
            kids = [t.internal_count[c] if c >= 0 else t.leaf_count[~c]
                    for c in (t.left_child[s], t.right_child[s])]
            parent, small = int(t.internal_count[s]), int(min(kids))
            total += step + 9 * parent + small * (f + 12)
            ops += step_ops + 2 * parent + 3 * small * f
    nbytes = fixed + total / len(trees)
    ms, by = bound_ms(nbytes, fixed_ops + ops / len(trees))
    return ms, by, nbytes


def check_partition(torch, lor_k, lor_p, slot_k, slot_p, what: str) -> None:
    """B3 against its plain version: leaf_of_row and slot bit for bit."""
    bad = max(int((lor_k != lor_p).sum()), int((slot_k != slot_p).sum()))
    if bad != 0:
        raise AssertionError(f"B3 ({what}) differs from its plain version "
                             f"in {bad} rows")


def check_split(torch, sp, r_k, r_p, what: str):
    """B2 records against the plain version's, field by field: feature,
    threshold and direction equal; -inf gains equal; every other float
    field finite in both, its error within SPLIT_RTOL times the largest
    magnitude of that field.  Returns (max abs, max relative) error."""
    ints = [sp.FEATURE, sp.THRESHOLD, sp.DEFAULT_LEFT]
    if not torch.equal(r_k[:, ints], r_p[:, ints]):
        raise AssertionError(f"B2 ({what}) picks another split: "
                             f"{r_k[:, ints].tolist()} vs "
                             f"{r_p[:, ints].tolist()}")
    none_k = torch.isneginf(r_k[:, sp.GAIN])
    none_p = torch.isneginf(r_p[:, sp.GAIN])
    if not torch.equal(none_k, none_p):
        raise AssertionError(f"B2 ({what}) finds a split where the plain "
                             f"version finds none, or the reverse")
    worst_abs = worst_rel = 0.0
    for col in range(sp.RECORD):
        if col in ints:
            continue
        a, b = r_k[:, col], r_p[:, col]
        if col == sp.GAIN:
            a, b = a[~none_p], b[~none_p]
        if a.numel() == 0:
            continue
        if not (bool(torch.isfinite(a).all())
                and bool(torch.isfinite(b).all())):
            raise AssertionError(f"B2 ({what}) field {col} not finite: "
                                 f"{a.tolist()} vs {b.tolist()}")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if err > SPLIT_RTOL * scale:
            raise AssertionError(f"B2 ({what}) field {col}: max abs error "
                                 f"{err} against scale {scale}")
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale if scale > 0 else 0.0)
    return worst_abs, worst_rel


def split_cases(torch, sp, tot, base):
    """Split parameters that each turn on one term of the gain, validity
    or leaf output, sized from the leaves' sums ``tot`` [2, 3]
    and the default parameters' records ``base`` so that each term moves
    the result by far more than SPLIT_RTOL at any data size, while both
    leaves keep a valid split; then all terms at once with the CPU test's
    values.  Each case maps to (SplitParams,
    parent_output [2])."""
    g = float(tot[:, 0].abs().min())
    h = float(tot[:, 1].min())
    c = float(tot[:, 2].min())
    side = torch.stack([base[:, sp.LEFT_SUM], base[:, sp.RIGHT_SUM]], 1)
    outs = base[:, [sp.LEFT_OUTPUT, sp.RIGHT_OUTPUT]].abs()
    out_min = float(outs.min())
    po = torch.tensor([0.5, -0.5], device=tot.device) * out_min
    zero = torch.zeros(2, device=tot.device)
    gain = max(0.0, float(base[:, sp.GAIN].min()))
    terms = {
        "l1": {"lambda_l1": 0.1 * g},
        "l2": {"lambda_l2": 0.2 * h},
        # one more row / a little more hessian than the default pick's
        # smaller side has, so that its split is no longer valid
        "min_data": {"min_data_in_leaf": int(side[:, :, 2].min()) + 1},
        "min_hess": {"min_sum_hessian_in_leaf":
                     1.01 * float(side[:, :, 1].min())},
        "max_delta": {"max_delta_step": 0.5 * out_min},
        "path_smooth": {"path_smooth": 0.2 * c},
        "min_gain": {"min_gain_to_split": 0.2 * gain},
    }
    cases = {k: (sp.SplitParams(**v), po if k == "path_smooth" else zero)
             for k, v in terms.items()}
    # every term at once, with the CPU test's "all" values
    cases["all"] = (sp.SplitParams(lambda_l1=1.0, lambda_l2=2.0,
                                   max_delta_step=0.3, path_smooth=3.0,
                                   min_data_in_leaf=50), po)
    return cases


def check_grow_step(torch, binned, vals, fmask, num_bin, na_bin, B, params,
                    max_depth, case, snap, is_cat=None):
    """Grow one tree on the card with the B3s kernel, and at every step
    run its plain version on copies of the step's inputs: the step record,
    index, sums, flags and the whole tree buffer must be bit-equal.  Keeps
    the state before the middle step in ``snap`` (for timing) and the
    workspace in ``snap["ws"]``.  With ``is_cat`` (a categorical tree) B3
    is held against its plain version at every step too.  Returns (steps,
    active steps)."""
    from lightgbm_torch import grower as gr
    n, f = binned.shape
    ws = gr.GrowWorkspace(n, f, B, NUM_LEAVES, binned.device,
                          categorical=is_cat is not None)
    kernel, part_k = gr.grow_step, gr.partition
    seen = {"steps": 0, "active": 0}

    def both(table, tree, na, **kw):
        if seen["steps"] == NUM_LEAVES // 2 and "state" not in snap:
            snap["state"] = {"table": table.clone(), "tree0": tree.clone(),
                             "tree": tree.clone(),
                             **{k: kw[k].clone() for k in
                                ("rec", "idx", "fstep", "flags")}}
        tree_p = tree.clone()
        kw_p = {k: (v.clone() if torch.is_tensor(v) else v)
                for k, v in kw.items()}
        gr.grow_step_plain(table, tree_p, na, **kw_p)
        kernel(table, tree, na, **kw)
        for k in ("rec", "idx", "fstep", "flags"):
            if not torch.equal(kw[k], kw_p[k]):
                raise AssertionError(f"B3s ({case}, step {seen['steps']}) "
                                     f"{k}: {kw[k].tolist()} vs plain "
                                     f"{kw_p[k].tolist()}")
        if not torch.equal(tree, tree_p):
            raise AssertionError(f"B3s ({case}, step {seen['steps']}) "
                                 "tree buffer differs from the plain "
                                 "version's")
        seen["steps"] += 1
        seen["active"] += int(kw["rec"][gr.ACTIVE])

    def part_both(binned_, lor, rec, rank, efb=None):
        lor_p = lor.clone()
        s_p = gr.partition_plain(binned_, lor_p, rec, rank, efb)
        s_k = part_k(binned_, lor, rec, rank, efb)
        if bool(rec[gr.ACTIVE]):
            check_partition(torch, lor, lor_p, s_k, s_p,
                            f"{case}, step {seen['steps'] - 1}")
        return s_k

    gr.grow_step = both
    if is_cat is not None:
        gr.partition = part_both
    try:
        gr.grow_tree(binned, vals, fmask, num_bin, na_bin,
                     num_leaves=NUM_LEAVES, num_bins=B, params=params,
                     max_depth=max_depth, workspace=ws, is_cat=is_cat)
    finally:
        gr.grow_step, gr.partition = kernel, part_k
    snap["ws"] = ws
    tree = gr.fetch_tree(ws)
    if tree.num_leaves != seen["active"] + 1:
        raise AssertionError(f"B3s ({case}): {tree.num_leaves} leaves "
                             f"after {seen['active']} active steps")
    return seen["steps"], seen["active"]


def phase_environment(torch, lgt_kernels):
    nvcc = subprocess.run([lgt_kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if set(lgt_kernels.LAUNCHES) != set(PER_ITERATION):
        raise AssertionError(
            "the port's launch counters and PER_ITERATION's keys differ: "
            f"{sorted(set(lgt_kernels.LAUNCHES) ^ set(PER_ITERATION))}")
    t0 = time.perf_counter()
    per_kernel = lgt_kernels.build_all()
    build_s = time.perf_counter() - t0
    BUILD_S.update(per_kernel)
    emit({"phase": "environment", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "card": smi, "device": torch.cuda.get_device_name(0),
          "source_sha256": source_digest(), "build_s": build_s, "build_s_by_kernel": per_kernel})
    return smi


def phase_data(lgt):
    t0 = time.perf_counter()
    x, y = make_higgs_like(N_TRAIN, N_FEAT, seed=0)
    xv, yv = make_higgs_like(N_VALID, N_FEAT, seed=1)
    params = {"max_bin": MAX_BIN, "verbosity": -1}
    train = lgt.Dataset(x, y, params=params).construct()
    valid = lgt.Dataset(xv, yv, reference=train, params=params).construct()
    if train.binned.shape != (N_TRAIN, N_FEAT) \
            or train.binned.dtype != np.uint8:
        raise AssertionError(f"unexpected binned matrix {train.binned.shape}")
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "train": list(train.binned.shape), "valid": list(valid.binned.shape),
          "max_bin": int(train.max_bin)})
    return x, y, xv, yv, train, valid


def phase_kernels(torch, lgt, train, valid):
    """Each kernel against its plain version at the main path's shapes."""
    from lightgbm_torch.grower import partition, partition_plain
    from lightgbm_torch.ops import split as sp
    from lightgbm_torch.ops.histogram import compute_histogram, histogram_plain
    from lightgbm_torch.predict_device import (add_tree_score,
                                               add_tree_score_plain)
    dev = torch.device("cuda", 0)
    binned = torch.as_tensor(train.binned).to(dev)
    vbinned = torch.as_tensor(valid.binned).to(dev)
    n, f = binned.shape
    nv = vbinned.shape[0]
    B = int(train.max_bin)
    mappers = [train.bin_mappers[i] for i in train.used_features]
    num_bin = torch.tensor([m.num_bin for m in mappers], dtype=torch.int32,
                           device=dev)
    na_bin = torch.tensor([m.na_bin for m in mappers], dtype=torch.int32,
                          device=dev)
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    # binary-objective gradients at a random score (at score 0 they are
    # exactly +-0.5 and 0.25, and every sum would be exact)
    y = torch.as_tensor(train.metadata.label).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
    vals = torch.stack([p - y, p * (1 - p), torch.ones_like(y)], dim=1)
    params = sp.SplitParams()
    rows = []

    def rec(leaf, new_leaf, feat, thr, dleft, na, smaller):
        return torch.tensor([leaf, new_leaf, feat, thr, int(dleft), na,
                             smaller, 1], dtype=torch.int32, device=dev)

    # B3 at the root split of feature 0, threshold mid-range
    lor = torch.zeros(n, dtype=torch.int32, device=dev)
    iota = torch.arange(B, dtype=torch.int32, device=dev)
    thr = int(num_bin[0].item()) // 2
    args = (rec(0, 1, 0, thr, False, int(na_bin[0].item()), 1), iota)
    lor_k, lor_p = lor.clone(), lor.clone()
    slot_k = partition(binned, lor_k, *args)
    slot_p = partition_plain(binned, lor_p, *args)
    check_partition(torch, lor_k, lor_p, slot_k, slot_p, "root")
    # and mid-tree: rows spread over 17 leaves, leaf 5 split into leaf 17,
    # a bin of the column taken as the NA bin, both NA directions, the
    # identity and a permuted rank vector
    lor_mid = torch.randint(0, 17, (n,), dtype=torch.int32, device=dev,
                            generator=gen)
    perm = torch.randperm(B, device=dev, generator=gen).to(torch.int32)
    for feat, dleft, na, rank, smaller in ((3, False, "top", iota, 17),
                                           (7, True, 0, perm, 5)):
        na = int(num_bin[feat].item()) - 1 if na == "top" else na
        margs = (rec(5, 17, feat, int(num_bin[feat].item()) // 2, dleft, na,
                     smaller), rank)
        in_leaf = lor_mid == 5
        if int(((binned[:, feat] == na) & in_leaf).sum()) == 0 \
                or int((~in_leaf).sum()) == 0:
            raise AssertionError("B3 mid-tree check takes no NA row or no "
                                 "row of another leaf")
        lk, lp = lor_mid.clone(), lor_mid.clone()
        sk = partition(binned, lk, *margs)
        sp_ = partition_plain(binned, lp, *margs)
        check_partition(torch, lk, lp, sk, sp_, f"mid-tree feature {feat}")
    # every timed call starts from the root state again (a 4 MB fill,
    # counted in both times)
    lor_p = lor.clone()
    t_k = median_ms(torch, lambda: partition(binned, lor.fill_(0), *args))
    t_p = median_ms(torch, lambda: partition_plain(binned, lor_p.fill_(0),
                                                   *args))
    # the timed call's outputs against the plain version's: one more call
    # of each from the same state
    err3 = exact_err(torch, [
        (partition(binned, lor.fill_(0), *args),
         partition_plain(binned, lor_p.fill_(0), *args)), (lor, lor_p)],
        "B3 (timed call)")
    b3_bytes = n * f + 12 * n
    rows.append(("partition", "B3 row partition",
                 "lightgbm_torch/csrc/partition.cu",
                 "lightgbm_tpu/grower.py:768", err3, err3, t_k, t_p,
                 bound_ms(b3_bytes, 2 * n), None))

    # B1: the smaller child's pass (slot from B3) and the root pass
    h_k = compute_histogram(binned, vals, num_bins=B, slot=slot_k)
    h_p = histogram_plain(binned, vals, num_bins=B, slot=slot_k)
    h_k2 = compute_histogram(binned, vals, num_bins=B, slot=slot_k)
    torch.cuda.synchronize()
    if not torch.equal(h_k, h_k2):
        raise AssertionError("B1 is not bitwise reproducible")
    if not torch.equal(h_k[..., 2], h_p[..., 2]):
        raise AssertionError("B1 count channel differs from its plain version")
    err1 = float((h_k - h_p).abs().max())
    scale1 = float(h_p.abs().max())
    if err1 > HIST_RTOL * max(1.0, scale1):
        raise AssertionError(f"B1 max abs error {err1} (scale {scale1})")
    t_k = median_ms(torch, lambda: compute_histogram(binned, vals, num_bins=B,
                                                     slot=slot_k))
    t_p = median_ms(torch, lambda: histogram_plain(binned, vals, num_bins=B,
                                                   slot=slot_k))
    # library yardstick: one index_add_ over precomputed (f*B + bin) indices
    keep = slot_k >= 0
    idx = (binned[keep].to(torch.int64)
           + torch.arange(f, device=dev) * B).reshape(-1)
    src = vals[keep].repeat_interleave(f, dim=0)
    acc = torch.zeros((f * B, 3), device=dev)
    t_lib = median_ms(torch, lambda: acc.zero_().index_add_(0, idx, src))
    b1_bytes = n * f + 12 * n + 4 * n + f * B * 12
    rows.append(("histogram", "B1 histogram", "lightgbm_torch/csrc/histogram.cu",
                 "lightgbm_tpu/ops/histogram.py:129", err1,
                 err1 / max(scale1, 1e-30), t_k, t_p,
                 bound_ms(b1_bytes, 3 * n * f), t_lib))

    # B2 on the two children of that split: the default parameters (timed),
    # then each regularisation term alone and all together
    root = compute_histogram(binned, vals, num_bins=B)
    pair = torch.stack([h_k, root - h_k]).contiguous()
    tot = pair[:, 0].sum(dim=1).contiguous()            # [2, 3]
    po = torch.zeros(2, device=dev)
    r_k = sp.find_best_split(pair, tot, po, num_bin, na_bin, fmask, params)
    r_p = sp.find_best_split_plain(pair, tot, po, num_bin, na_bin, fmask,
                                   params)
    err2, rel2 = check_split(torch, sp, r_k, r_p, "default")
    for case, (prm, po_c) in split_cases(torch, sp, tot, r_p).items():
        r_k = sp.find_best_split(pair, tot, po_c, num_bin, na_bin, fmask,
                                 prm)
        r_p2 = sp.find_best_split_plain(pair, tot, po_c, num_bin, na_bin,
                                        fmask, prm)
        if bool(torch.isneginf(r_p2[:, sp.GAIN]).any()):
            raise AssertionError(f"B2 case {case} finds no split, so it "
                                 "checks no gain")
        e, r = check_split(torch, sp, r_k, r_p2, case)
        err2, rel2 = max(err2, e), max(rel2, r)
    t_k = median_ms(torch, lambda: sp.find_best_split(
        pair, tot, po, num_bin, na_bin, fmask, params))
    t_p = median_ms(torch, lambda: sp.find_best_split_plain(
        pair, tot, po, num_bin, na_bin, fmask, params))
    # one launch of an empty kernel: the floor of a kernel this small
    launch_ms = median_ms(torch, lambda: torch.cuda._sleep(0))
    cand = 2 * 2 * f * B
    b2_bytes = pair.numel() * 4 + 2 * 3 * 4 + 2 * 4 + 2 * f * 4 + f \
        + 2 * sp.RECORD * 4
    rows.append(("split", "B2 split scan", "lightgbm_torch/csrc/split.cu",
                 "lightgbm_tpu/ops/split.py:343", err2, rel2, t_k, t_p,
                 bound_ms(b2_bytes, 40 * cand), None))

    # a wide input, checked and not timed: 100 features x 255 bins takes
    # B1's feature tiling (F*B*12 bytes exceed shared memory) and B2's
    # 256-thread blocks
    wf, wb_ = 100, 255
    wbinned = torch.randint(0, wb_, (50_000, wf), dtype=torch.uint8,
                            device=dev, generator=gen)
    wg = torch.randn(50_000, device=dev, generator=gen)
    wvals = torch.stack([wg, wg.abs() + 0.1, torch.ones_like(wg)], dim=1)
    wh_k = compute_histogram(wbinned, wvals, num_bins=wb_)
    wh_p = histogram_plain(wbinned, wvals, num_bins=wb_)
    werr = float((wh_k - wh_p).abs().max())
    if not torch.equal(wh_k[..., 2], wh_p[..., 2]) \
            or werr > HIST_RTOL * max(1.0, float(wh_p.abs().max())):
        raise AssertionError(f"B1 (wide) differs from its plain version: "
                             f"{werr}")
    wpair = torch.stack([wh_k, wh_k * 0.5]).contiguous()
    wtot = wpair[:, 0].sum(dim=1).contiguous()
    wnb = torch.full((wf,), wb_, dtype=torch.int32, device=dev)
    wna = torch.full((wf,), -1, dtype=torch.int32, device=dev)
    wna[::3] = wb_ - 1
    wm = torch.ones(wf, dtype=torch.bool, device=dev)
    wr_k = sp.find_best_split(wpair, wtot, po, wnb, wna, wm, params)
    wr_p = sp.find_best_split_plain(wpair, wtot, po, wnb, wna, wm, params)
    werr2, _ = check_split(torch, sp, wr_k, wr_p, "wide")
    emit({"phase": "kernel_wide", "features": wf, "bins": wb_,
          "hist_max_abs_err": werr, "split_max_abs_err": werr2})

    # B4: a depth-5 tree over the valid rows
    nodes = 2 ** 5 - 1
    rng = np.random.RandomState(3)
    sf = rng.randint(0, f, nodes).astype(np.int32)
    th = rng.randint(0, B - 1, nodes).astype(np.int32)
    lc = np.where(np.arange(nodes) * 2 + 1 < nodes,
                  np.arange(nodes) * 2 + 1, 0).astype(np.int32)
    rc = np.where(np.arange(nodes) * 2 + 2 < nodes,
                  np.arange(nodes) * 2 + 2, 0).astype(np.int32)
    leaves = np.arange(nodes + 1)
    first_leaf = nodes // 2
    for node in range(first_leaf, nodes):            # bottom level -> leaves
        lc[node] = ~leaves[2 * (node - first_leaf)]
        rc[node] = ~leaves[2 * (node - first_leaf) + 1]
    tree = [torch.as_tensor(a).to(dev) for a in (sf, th)]
    # int32 default_left, as the grower's device tree arrays carry it
    dl = torch.as_tensor((rng.rand(nodes) < 0.5).astype(np.int32)).to(dev)
    lct, rct = torch.as_tensor(lc).to(dev), torch.as_tensor(rc).to(dev)
    lv = torch.as_tensor(rng.randn(nodes + 1).astype(np.float32)).to(dev)
    # a bin of each of half the features taken as its NA bin, so that
    # rows take the default_left branch
    vna = na_bin.clone()
    vna[0::2] = num_bin[0::2] - 1
    vna[1::4] = 0
    score0 = torch.as_tensor(rng.randn(nv).astype(np.float32)).to(dev)
    s_k, s_p = score0.clone(), score0.clone()
    add_tree_score(s_k, vbinned, tree[0], tree[1], dl, lct, rct, vna, lv, 0.1,
                   steps=5)
    add_tree_score_plain(s_p, vbinned, tree[0], tree[1], dl, lct, rct, vna, lv,
                         0.1, steps=5)
    torch.cuda.synchronize()
    if not torch.equal(s_k, s_p):
        raise AssertionError(f"B4 differs from its plain version: max "
                             f"{float((s_k - s_p).abs().max())}")
    s = score0.clone()
    t_k = median_ms(torch, lambda: add_tree_score(
        s, vbinned, tree[0], tree[1], dl, lct, rct, vna, lv, 0.1, steps=5))
    t_p = median_ms(torch, lambda: add_tree_score_plain(
        s, vbinned, tree[0], tree[1], dl, lct, rct, vna, lv, 0.1, steps=5))
    # the timed call against the plain version, from the timed score state
    s_k, s_p = s.clone(), s.clone()
    add_tree_score(s_k, vbinned, tree[0], tree[1], dl, lct, rct, vna, lv,
                   0.1, steps=5)
    add_tree_score_plain(s_p, vbinned, tree[0], tree[1], dl, lct, rct, vna,
                         lv, 0.1, steps=5)
    err4 = exact_err(torch, [(s_k, s_p)], "B4 (timed call)")
    rel4 = err4 / max(float(s_p.abs().max()), 1e-30)
    b4_bytes = nv * f + 8 * nv
    rows.append(("predict", "B4 tree score update",
                 "lightgbm_torch/csrc/predict.cu",
                 "lightgbm_tpu/predict_device.py:72", err4, rel4, t_k, t_p,
                 bound_ms(b4_bytes, 2 * nv + 5 * nv), None))

    # B3s: whole trees at the main path's shape, with the plain version run
    # on copies of the same inputs at every step (records and tree buffer
    # bit for bit): the default parameters, max_depth 3, and a stump
    snap = {}
    cases = {"full": (params, -1), "max_depth_3": (params, 3),
             "stump": (sp.SplitParams(min_gain_to_split=1e30), -1)}
    b3s_steps = {}
    for case, (prm, depth) in cases.items():
        steps, active = check_grow_step(torch, binned, vals, fmask, num_bin,
                                        na_bin, B, prm, depth, case, snap)
        b3s_steps[case] = {"steps": steps, "active": active}
    if b3s_steps["full"]["active"] != NUM_LEAVES - 1 \
            or not 0 < b3s_steps["max_depth_3"]["active"] < NUM_LEAVES - 1 \
            or b3s_steps["stump"]["active"] != 0:
        raise AssertionError(f"B3s cases do not cover active, dead and "
                             f"stump steps: {b3s_steps}")
    from lightgbm_torch import grower as gr
    st = snap["state"]

    outs = ("tree", "rec", "idx", "fstep", "flags")

    def b3s_call(fn):
        st["tree"].copy_(st["tree0"])
        fn(st["table"], st["tree"], na_bin, num_leaves=NUM_LEAVES,
           max_depth=-1, rec=st["rec"], idx=st["idx"], fstep=st["fstep"],
           flags=st["flags"])
    # the outputs of the last timed call of each, compared after both
    t_k = median_ms(torch, lambda: b3s_call(gr.grow_step))
    got_k = [st[o].clone() for o in outs]
    t_p = median_ms(torch, lambda: b3s_call(gr.grow_step_plain))
    err3s = exact_err(torch, zip(got_k, [st[o] for o in outs]),
                      "B3s (timed call)")
    words = st["tree"].numel()
    b3s_bytes = st["table"].numel() * 4 + 2 * words * 4 + f * 4 \
        + 8 * 4 + 2 * 8 + 8 * 4 + 2
    rows.append(("grow_step", "B3s split step", "lightgbm_torch/csrc/"
                 "grow_step.cu", "lightgbm_tpu/grower.py:742", err3s, err3s,
                 t_k, t_p, bound_ms(b3s_bytes, 2 * NUM_LEAVES), None))
    emit({"phase": "kernel_grow_step", "cases": b3s_steps,
          "timed_ms_includes": "a copy of the tree buffer to reset it"})

    # B12a on the valid set's shape: random scores, scores with forced
    # ties (the 32 values of one tree, as early in training), and the tied
    # scores with zero-weight rows
    from lightgbm_torch import metrics as tm
    yv = torch.as_tensor(np.asarray(valid.metadata.label, np.float32)).to(dev)
    ones = torch.ones(nv, device=dev)
    sv = torch.randn(nv, device=dev, generator=gen)
    tied = add_tree_score(torch.zeros(nv, device=dev), vbinned, tree[0],
                          tree[1], dl, lct, rct, vna, lv, 1.0, steps=5)
    zw = ones.clone()
    zw[::7] = 0.0
    err12a = 0.0
    for case, (sc, w) in {"random": (sv, ones), "ties": (tied, ones),
                          "ties_zero_weights": (tied, zw)}.items():
        a = float(tm.traced_auc(sc, yv, w))
        b = float(tm.traced_auc_plain(sc, yv, w))
        if not abs(a - b) <= AUC_ATOL:
            raise AssertionError(f"B12a ({case}): {a} vs plain {b}")
        err12a = max(err12a, abs(a - b))
    if int(torch.unique(tied).numel()) > 2 ** 5:
        raise AssertionError("B12a tie case has no ties")
    t_k = median_ms(torch, lambda: tm.traced_auc(sv, yv, ones))
    t_p = median_ms(torch, lambda: tm.traced_auc_plain(sv, yv, ones))
    t_lib = median_ms(torch, lambda: torch.sort(sv, stable=True))
    lg = float(np.log2(nv))
    rows.append(("auc", "B12a traced AUC", "lightgbm_torch/csrc/metrics.cu",
                 "lightgbm_tpu/metrics.py:402", err12a, err12a, t_k, t_p,
                 bound_ms(12 * nv + 4, nv * lg + 10 * nv), t_lib))

    # B12b, each metric id on the valid set's shape
    err12b = rel12b = 0.0
    per_metric = {}
    for metric in tm.POINTWISE_IDS:
        a = float(tm.traced_pointwise(sv, yv, zw, metric=metric))
        b = float(tm.traced_pointwise_plain(sv, yv, zw, metric=metric))
        rel = abs(a - b) / abs(b)
        if not rel <= POINTWISE_RTOL:
            raise AssertionError(f"B12b {metric}: {a} vs plain {b}")
        err12b, rel12b = max(err12b, abs(a - b)), max(rel12b, rel)
        per_metric[metric] = {
            "value": a, "plain": b,
            "ms": median_ms(torch, lambda: tm.traced_pointwise(
                sv, yv, ones, metric=metric)),
            "plain_ms": median_ms(torch, lambda: tm.traced_pointwise_plain(
                sv, yv, ones, metric=metric))}
    import torch.nn.functional as F
    t_lib = median_ms(torch, lambda: F.binary_cross_entropy_with_logits(
        sv, yv, weight=ones))
    lm = per_metric["binary_logloss"]
    rows.append(("pointwise", "B12b traced pointwise metrics "
                 "(binary_logloss timed)", "lightgbm_torch/csrc/metrics.cu",
                 "lightgbm_tpu/metrics.py:391", err12b, rel12b, lm["ms"],
                 lm["plain_ms"], bound_ms(12 * nv + 4, 30 * nv), t_lib))
    emit({"phase": "kernel_pointwise", "metrics": per_metric})

    # B5 (torch ops, no kernel of its own): the binary gradients and the
    # [N, 3] vals stack at the training shape; bound: score, label and
    # label weight read, vals written
    from lightgbm_torch.config import Config
    from lightgbm_torch.objectives import BinaryLogloss
    obj = BinaryLogloss(Config({"objective": "binary"}))
    obj.init(train.metadata, n, dev)
    score5 = torch.randn(n, device=dev, generator=gen)

    def b5():
        g, h = obj.get_gradients(score5)
        return torch.stack([g, h, torch.ones_like(g)], dim=1)
    b5_bound, b5_by = bound_ms(12 * n + 12 * n, 12 * n)
    emit({"phase": "b5_gradients", "ms": median_ms(torch, b5),
          "bound_ms": b5_bound, "bound_by": b5_by})

    out = {}
    for key, name, src_path, replaces, err, rel, tk, tp, (bms, by), tl \
            in rows:
        out[key] = {"name": name, "route": "cuda", "source": src_path,
                    "replaces": replaces, "max_abs_err": err, "ms": tk,
                    "plain_ms": tp, "bound_ms": bms, "bound_by": by,
                    "library_ms": tl}
        extra = {"empty_launch_ms": launch_ms} if key == "split" else {}
        emit({"phase": "kernel", **out[key], "max_rel_err": rel,
              "kernel_ms": tk, **extra})
    return out


def _attach_timer(env):
    from lightgbm_torch.models.gbdt import PhaseTimer
    m = env.model._model
    if m.phase_timer is None:
        m.phase_timer = PhaseTimer(m.device)


_attach_timer.before_iteration = True


def train_main(lgt, train, valid, extra=None, timed=False, rounds=ROUNDS):
    """The main path's training: default path parameters unless ``extra``
    says otherwise."""
    ev = {}
    cbs = [lgt.early_stopping(ES_ROUNDS, first_metric_only=True,
                              verbose=False),
           lgt.record_evaluation(ev)]
    if timed:
        cbs.append(_attach_timer)
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "max_bin": MAX_BIN, "learning_rate": 0.1, "metric": METRICS,
              "verbosity": -1, **(extra or {})}
    t0 = time.perf_counter()
    bst = lgt.train(params, train, rounds, valid_sets=[valid],
                    callbacks=cbs)
    return bst, ev, time.perf_counter() - t0


def without_path_params(text: str, *more: str) -> str:
    """``text`` without the path parameter lines (and lines starting with
    any of ``more``)."""
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(PATH_PARAMS + more))


def fused_program(m):
    """The one captured program of a fused run."""
    progs = [p for p in m._programs.values() if p.graph is not None]
    if len(progs) != 1:
        raise AssertionError(f"expected one captured program, found "
                             f"{len(progs)}")
    return progs[0]


def phase_main_path(torch, lgt, lgt_kernels, train, valid):
    lgt_kernels.reset_launch_counts()
    bst, ev, secs = train_main(lgt, train, valid)
    torch.cuda.synchronize()
    eager = lgt_kernels.launch_counts()
    m = bst._model
    prog = fused_program(m)
    iters = m.num_iterations_trained
    epochs = len(m.epoch_ms)
    k = max(2, min(25, ES_ROUNDS))
    if m.fetch_counts != {"epoch": epochs}:
        raise AssertionError(f"host fetches {m.fetch_counts} are not one "
                             f"per epoch ({epochs} epochs)")
    if prog.replays != k * epochs or iters > prog.replays:
        raise AssertionError(f"{prog.replays} replays for {epochs} epochs "
                             f"of {k} and {iters} iterations")
    # wrapper calls: the warm-up before capture and the capture, nothing
    # eager besides
    if prog.captured != PER_ITERATION or prog.warmup != PER_ITERATION \
            or eager != {kk: 2 * v for kk, v in PER_ITERATION.items()}:
        raise AssertionError(f"launches: captured {prog.captured}, warm-up "
                             f"{prog.warmup}, wrapper calls {eager}, "
                             f"expected {PER_ITERATION} each")
    device = {kk: prog.warmup[kk] + v for kk, v in prog.launches().items()}
    auc = ev["valid_0"]["auc"]
    best = bst.best_iteration
    best_auc = auc[best - 1]
    if not 0.5 < best_auc <= 1.0:
        raise AssertionError(f"valid AUC {best_auc}")
    steady = m.epoch_ms[1:] if epochs > 1 else m.epoch_ms
    emit({"phase": "main_path", "path": "super-epoch", "k": k,
          "iterations": iters, "best_iteration": best,
          "valid_auc": best_auc, "seconds": secs,
          "iterations_per_s": iters / secs, "epochs": epochs,
          "epoch_ms": m.epoch_ms,
          "steady_epoch_ms_median": statistics.median(steady),
          "steady_iterations_per_s": 1e3 * k / statistics.median(steady),
          "host_fetches": m.fetches, "graph_replays": prog.replays,
          "active_split_steps": sum(m.step_counts),
          "split_steps_launched": (prog.replays + 1) * (NUM_LEAVES - 1),
          "captured_launches_per_replay": prog.captured,
          "capture_ms": prog.capture_ms, "device_launches": device})
    return bst, ev, device, statistics.median(steady) / k


def phase_per_iteration(torch, lgt, lgt_kernels, train, valid, main_bst,
                        main_ev):
    """The same training on the per-iteration path, with the traced
    metrics so that it makes the same early-stopping decisions: the same
    model text and values, one fetch per tree and one per eval, and every
    kernel launched eagerly PER_ITERATION times per iteration."""
    lgt_kernels.reset_launch_counts()
    bst, ev, secs = train_main(lgt, train, valid, timed=True, extra={
        "superepoch": -1, "fused_chunk": 1, "fused_eval": "true"})
    torch.cuda.synchronize()
    launches = lgt_kernels.launch_counts()
    m = bst._model
    n = m.num_iterations_trained
    if launches != times(PER_ITERATION, n):
        raise AssertionError(f"per-iteration launches {launches} for {n} "
                             f"iterations, expected {PER_ITERATION} each")
    same = without_path_params(bst.model_to_string()) \
        == without_path_params(main_bst.model_to_string())
    if not same or ev != main_ev:
        raise AssertionError("per-iteration model text or evals differ "
                             "from the main path's")
    if m.fetch_counts != {"tree": n, "traced_eval": n} or m._programs and \
            any(p.graph is not None for p in m._programs.values()):
        raise AssertionError(f"per-iteration fetches {m.fetch_counts}")
    eval_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        bst.eval_valid()
        eval_s.append(time.perf_counter() - t0)
    emit({"phase": "per_iteration", "iterations": n, "seconds": secs,
          "iterations_per_s": n / secs,
          "phase_ms": m.phase_timer.totals_ms(),
          "host_fetches": m.fetch_counts, "model_text_equal": same,
          "launches": launches,
          "host_eval_ms_per_iteration": 1e3 * statistics.median(eval_s)})
    return 1e3 * secs / n, launches


def phase_fused_chunk(torch, lgt, lgt_kernels, train):
    """No valid set: 50 rounds as fused chunks of 25, against a
    per-iteration run; each run's launches are PER_ITERATION_NO_VALID per
    iteration (captured once and replayed, or eagerly).  Returns the
    fused run's device launches."""
    texts, info = {}, {}
    for name, extra in (("fused_chunk", {}),
                        ("per_iteration", {"superepoch": -1,
                                           "fused_chunk": 1})):
        params = {"objective": "binary", "num_leaves": NUM_LEAVES,
                  "max_bin": MAX_BIN, "learning_rate": 0.1,
                  "verbosity": -1, **extra}
        lgt_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        bst = lgt.train(params, train, ROUNDS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        eager = lgt_kernels.launch_counts()
        m = bst._model
        n = m.num_iterations_trained
        texts[name] = without_path_params(bst.model_to_string())
        info[name] = {"seconds": secs, "iterations_per_s": ROUNDS / secs,
                      "host_fetches": m.fetch_counts}
        if name == "fused_chunk":
            prog = fused_program(m)
            device = {kk: prog.warmup[kk] + v
                      for kk, v in prog.launches().items()}
            info[name].update(graph_replays=prog.replays,
                              epoch_ms=m.epoch_ms,
                              capture_ms=prog.capture_ms,
                              captured_launches_per_replay=prog.captured,
                              launches=device)
            if m.fetch_counts != {"epoch": 2} or prog.replays != ROUNDS:
                raise AssertionError(f"fused chunks: {m.fetch_counts}, "
                                     f"{prog.replays} replays")
            # wrapper calls: the warm-up before capture and the capture
            if prog.captured != PER_ITERATION_NO_VALID \
                    or prog.warmup != PER_ITERATION_NO_VALID \
                    or eager != times(PER_ITERATION_NO_VALID, 2):
                raise AssertionError(
                    f"fused-chunk launches: captured {prog.captured}, "
                    f"warm-up {prog.warmup}, wrapper calls {eager}, "
                    f"expected {PER_ITERATION_NO_VALID} each")
        else:
            info[name]["launches"] = eager
            if eager != times(PER_ITERATION_NO_VALID, n):
                raise AssertionError(
                    f"per-iteration launches without a valid set {eager} "
                    f"for {n} iterations, expected "
                    f"{PER_ITERATION_NO_VALID} each")
    if texts["fused_chunk"] != texts["per_iteration"]:
        raise AssertionError("fused-chunk model text differs from the "
                             "per-iteration run's")
    emit({"phase": "fused_chunk", "rounds": ROUNDS, "model_text_equal": True,
          **info})
    return info["fused_chunk"]["launches"]


def phase_reference(torch, lgt):
    """The card's training against the port's CPU path on a small input."""
    x, y = make_higgs_like(20_000, N_FEAT, seed=7)
    xv, yv = make_higgs_like(5_000, N_FEAT, seed=8)
    preds, aucs = [], []
    for device in ("cuda", "cpu"):
        params = {"objective": "binary", "num_leaves": 15, "max_bin": MAX_BIN,
                  "metric": "auc", "verbosity": -1, "device_type": device}
        # the default path on both devices: a super-epoch of 10 replays on
        # the card, the same epoch run eagerly through the plain versions
        # on the CPU
        tr = lgt.Dataset(x, y)
        ev = {}
        bst = lgt.train(params, tr, 10,
                        valid_sets=[lgt.Dataset(xv, yv, reference=tr)],
                        callbacks=[lgt.record_evaluation(ev)])
        preds.append(bst.predict(xv))
        aucs.append(ev["valid_0"]["auc"][-1])
    diff = float(np.abs(preds[0] - preds[1]).mean())
    if not (np.isfinite(preds[0]).all() and preds[0].shape == (5_000,)):
        raise AssertionError("non-finite or misshapen predictions")
    if diff > 1e-3 or abs(aucs[0] - aucs[1]) > 2e-3:
        raise AssertionError(f"card vs CPU: mean |dp| {diff}, AUC {aucs}")
    emit({"phase": "reference", "mean_abs_pred_diff": diff,
          "auc_cuda": aucs[0], "auc_cpu": aucs[1]})


def phase_roundtrip(lgt, bst, train, valid, xv):
    pred = bst.predict(xv)
    if pred.shape != (N_VALID,) or not np.isfinite(pred).all() \
            or pred.min() <= 0.0 or pred.max() >= 1.0:
        raise AssertionError("predictions are not finite probabilities")
    text = bst.model_to_string()
    again = lgt.Booster(model_str=text).predict(xv)
    if not np.array_equal(pred, again):
        raise AssertionError("model text round trip changed predictions")
    bst2, _, secs = train_main(lgt, train, valid)
    same = bst2.model_to_string() == text
    if not same:
        raise AssertionError("a second training run gave other model text")
    emit({"phase": "roundtrip", "trees": bst.num_trees(),
          "model_text_bytes": len(text), "byte_identical_rerun": same,
          "rerun_seconds": secs})


def phase_profile(torch, lgt, train, valid):
    """One more main-path training under ``torch.profiler``: device time
    by kernel name, and the share of the steady epochs' wall time that
    the device is busy (kernel time per iteration over the epoch
    milliseconds per iteration)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bst, _, secs = train_main(lgt, train, valid)
        torch.cuda.synchronize()
    m = bst._model
    prog = fused_program(m)

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0
    # device kernels only: not the host ops' attributed time nor the
    # dataset's upload, which happen outside the epochs
    kernels = sorted(((e.key, dev_us(e), e.count)
                      for e in prof.key_averages() if dev_us(e) > 0
                      and not e.key.startswith(("aten::", "Memcpy HtoD"))),
                     key=lambda r: -r[1])
    total_ms = sum(r[1] for r in kernels) / 1e3
    # the warm-up and every replay ran the body once each
    per_iter_ms = total_ms / (prog.replays + 1) if kernels else None
    steady = m.epoch_ms[1:]
    k = prog.replays // len(m.epoch_ms)
    busy = per_iter_ms * k / statistics.median(steady) \
        if kernels and steady else None
    emit({"phase": "profile", "seconds": secs,
          "device_kernel_ms_total": total_ms if kernels else None,
          "device_kernel_ms_per_iteration": per_iter_ms,
          "steady_epoch_ms": steady,
          "steady_busy_share": busy,
          "top_kernels": [{"name": n[:90], "device_ms": us / 1e3,
                           "count": c} for n, us, c in kernels[:20]]})


# ---------------------------------------------------------------------------
# wide trees with row and feature sampling (B1-K, B3-K, B3s-K, B6)

def equal_bits(torch, a, b) -> bool:
    """Whether two tensors hold the same bits (f32 by their int32 view, so
    that NaN in a scratch row equals the same NaN)."""
    if a.dtype == torch.float32:
        return same_bits(torch, a, b)
    return torch.equal(a, b)


def check_batched_tree(torch, binned, vals, fmask, num_bin, na_bin, B, L, K,
                       params, max_depth, case, snap, is_cat=None):
    """Grow one tree on the card with the batched grower, and at every
    super-step run the plain versions of B3s-K and B3-K on copies of the
    step's inputs: every step output, the tree buffer, leaf_of_row and
    the target slots bit for bit.  Keeps the state of the first super-step
    with all K slots valid in ``snap`` (for timing and B1-K).  Returns
    counts of super-steps: launched, live, budget-cut (0 < valid < K with
    the budget exhausted)."""
    from lightgbm_torch import grower as gr
    n, f = binned.shape
    ws = gr.GrowWorkspace(n, f, B, L, binned.device, split_batch=K,
                          categorical=is_cat is not None)
    step_k, part_k = gr.grow_step_batched, gr.partition_slots
    seen = {"steps": 0, "live": 0, "budget_cut": 0}

    def clone_step(st):
        return gr.BatchedStep(*[t.clone() for t in st])

    def step_both(table, tree, na, *, step, **kw):
        tree_p, step_p = tree.clone(), clone_step(step)
        nl = int(gr.tree_fields(tree, L)["num_leaves"][0])
        if "state" not in snap:
            snap["pre"] = {"table": table.clone(), "tree0": tree.clone(),
                           "lor": ws.leaf_of_row.clone()}
        gr.grow_step_batched_plain(table, tree_p, na, step=step_p, **kw)
        step_k(table, tree, na, step=step, **kw)
        for name in gr.BatchedStep._fields:
            if not equal_bits(torch, getattr(step, name),
                              getattr(step_p, name)):
                raise AssertionError(
                    f"B3s-K ({case}, super-step {seen['steps']}) {name}: "
                    f"{getattr(step, name).tolist()} vs plain "
                    f"{getattr(step_p, name).tolist()}")
        if not torch.equal(tree, tree_p):
            raise AssertionError(f"B3s-K ({case}, super-step "
                                 f"{seen['steps']}) tree buffer differs "
                                 "from the plain version's")
        nv = int(step.status[1])
        seen["steps"] += 1
        seen["live"] += int(nv > 0)
        seen["budget_cut"] += int(0 < nv < K and nv == L - nl)
        if nv == K and "state" not in snap:
            snap["state"] = {**snap["pre"], "step": clone_step(step),
                             "step0": clone_step(step)}
        if nv > 0 and "first" not in snap:
            snap["first"] = {"used": step.status[1:2].clone()}

    def part_both(binned_, lor, step, rank, efb=None):
        lor_p = lor.clone()
        t_p = gr.partition_slots_plain(binned_, lor_p, step, rank, efb)
        t_k = part_k(binned_, lor, step, rank, efb)
        live = bool(step.status[0])
        if not torch.equal(lor, lor_p) or (live and not torch.equal(t_k,
                                                                     t_p)):
            raise AssertionError(f"B3-K ({case}, super-step "
                                 f"{seen['steps'] - 1}) differs from its "
                                 "plain version")
        if "state" in snap and "tslot" not in snap["state"]:
            snap["state"]["tslot"] = t_k.clone()
            snap["state"]["used"] = step.status[1:2].clone()
        if "first" in snap and "tslot" not in snap["first"]:
            snap["first"]["tslot"] = t_k.clone()
        return t_k

    gr.grow_step_batched, gr.partition_slots = step_both, part_both
    try:
        gr.grow_tree_batched(binned, vals, fmask, num_bin, na_bin,
                             num_leaves=L, num_bins=B, params=params,
                             max_depth=max_depth, split_batch=K,
                             workspace=ws, is_cat=is_cat)
    finally:
        gr.grow_step_batched, gr.partition_slots = step_k, part_k
    snap["ws"] = ws
    tree = gr.fetch_tree(ws)
    if tree.n_steps != seen["live"] or seen["steps"] != L - 1:
        raise AssertionError(f"B3s-K ({case}): {tree.n_steps} live "
                             f"super-steps counted, {seen}")
    return {**seen, "leaves": tree.num_leaves}


def phase_wide_kernels(torch, lgt, train):
    """B1-K, B3-K, B3s-K and B6 against their plain versions at the wide
    path's shapes (1M x 28, 63 bins, 255 leaves, K = 16 and 8), with
    times, bounds and library times; B1-K also through
    ``check_b1k_card`` at K = 16 and 8."""
    from lightgbm_torch import _kernels as lgt_kernels
    from lightgbm_torch import grower as gr
    from lightgbm_torch.ops import split as sp
    from lightgbm_torch.ops.histogram import (compute_histogram,
                                              histogram_slots_plain)
    from lightgbm_torch.ops.random import bag_vals, bag_vals_plain
    dev = torch.device("cuda", 0)
    binned = torch.as_tensor(train.binned).to(dev)
    n, f = binned.shape
    B = int(train.max_bin)
    mappers = [train.bin_mappers[i] for i in train.used_features]
    num_bin = torch.tensor([m.num_bin for m in mappers], dtype=torch.int32,
                           device=dev)
    na_bin = torch.tensor([m.na_bin for m in mappers], dtype=torch.int32,
                          device=dev)
    y = torch.as_tensor(train.metadata.label).to(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    p = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
    g, h = (p - y).contiguous(), (p * (1 - p)).contiguous()
    positive = (y > 0).to(torch.uint8)
    rows = []

    # B6: bitwise, plain fraction and pos/neg, two refresh epochs
    bag = {"seed": 3, "freq": 5, "fraction": 0.8}
    posneg = {**bag, "pos_fraction": 0.7, "neg_fraction": 0.9,
              "positive": positive}
    masks = {}
    for case, kw in (("bagging", bag), ("pos_neg", posneg)):
        for it in (0, 7):
            itd = torch.tensor([it], dtype=torch.int32, device=dev)
            a = bag_vals(g, h, itd, **kw)
            b = bag_vals_plain(g, h, itd, **kw)
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"B6 ({case}, iteration {it}) differs "
                                     "from its plain version")
            masks[(case, it)] = a[:, 2].clone()
    for case in ("bagging", "pos_neg"):
        if torch.equal(masks[(case, 0)], masks[(case, 7)]):
            raise AssertionError(f"B6 ({case}): the masks of refresh "
                                 "epochs 0 and 5 are equal")
    in_bag = float(masks[("bagging", 0)].mean())
    if not 0.79 < in_bag < 0.81:
        raise AssertionError(f"B6 in-bag share {in_bag}, fraction 0.8")
    it5 = torch.tensor([5], dtype=torch.int32, device=dev)
    out6 = torch.empty((n, 3), device=dev)
    t_k = median_ms(torch, lambda: bag_vals(g, h, it5, out=out6, **bag))
    t_p = median_ms(torch, lambda: bag_vals_plain(g, h, it5, **bag))
    err6 = exact_err(torch, [(out6, bag_vals_plain(g, h, it5, **bag))],
                     "B6 (timed call)")
    rel6 = err6 / max(float(out6.abs().max()), 1e-30)
    rows.append(("bag_vals", "B6 bagging draw and vals stack",
                 "lightgbm_torch/csrc/sample.cu",
                 "lightgbm_tpu/models/gbdt.py:1305", err6, rel6, t_k, t_p,
                 # one threefry2x32 a row, the bits to float, the
                 # compare and the three products
                 bound_ms(8 * n + 12 * n, (THREEFRY_OPS + 7) * n), None))

    # whole 255-leaf trees with the plain versions of B3s-K and B3-K at
    # every super-step: the default parameters (K = 16 and 8; budget-cut
    # super-steps at the end), max_depth 5, and a stump; B3s-K again on a
    # table with tied gains
    vals = bag_vals(g, h, torch.tensor([0], dtype=torch.int32, device=dev),
                    **bag)
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    fmask[torch.randperm(f, device=dev, generator=gen)[:f // 5]] = False
    params = sp.SplitParams()
    snaps, cases = {}, {}
    for case, K, prm, depth in (
            ("full_k16", 16, params, -1), ("full_k8", 8, params, -1),
            ("max_depth_5", 16, params, 5),
            ("stump", 16, sp.SplitParams(min_gain_to_split=1e30), -1)):
        snaps[case] = {}
        cases[case] = check_batched_tree(
            torch, binned, vals, fmask, num_bin, na_bin, B, WIDE_LEAVES, K,
            prm, depth, case, snaps[case])
    full = cases["full_k16"]
    if full["leaves"] != WIDE_LEAVES or full["budget_cut"] < 1 \
            or cases["full_k8"]["leaves"] != WIDE_LEAVES \
            or not 1 < cases["max_depth_5"]["leaves"] <= 32 \
            or cases["stump"]["live"] != 0:
        raise AssertionError(f"batched cases do not cover full, "
                             f"budget-cut, depth-cut and stump trees: "
                             f"{cases}")
    st = snaps["full_k16"]["state"]
    L, K = WIDE_LEAVES, WIDE_K
    # ties: four leaves of the snapshot's table given one gain
    tie_table = st["table"].clone()
    live = torch.nonzero(tie_table[:L, sp.GAIN] > 0).flatten()[:4]
    tie_table[live, sp.GAIN] = float(tie_table[live, sp.GAIN].max())
    for case, table in (("ties", tie_table), ("snapshot", st["table"])):
        tk, tp = st["tree0"].clone(), st["tree0"].clone()
        sk, sp_ = (gr.BatchedStep(*[t.clone() for t in st["step0"]])
                   for _ in range(2))
        gr.grow_step_batched(table, tk, na_bin, num_leaves=L, split_batch=K,
                             max_depth=-1, step=sk)
        gr.grow_step_batched_plain(table, tp, na_bin, num_leaves=L,
                                   split_batch=K, max_depth=-1, step=sp_)
        if not torch.equal(tk, tp) or any(
                not equal_bits(torch, a, b) for a, b in zip(sk, sp_)):
            raise AssertionError(f"B3s-K ({case}) differs from its plain "
                                 "version")
        if case == "ties":
            leaves = sk.recs[:, 0].tolist()
            order = [leaves.index(int(x)) for x in sorted(live.tolist())]
            if order != sorted(order):
                raise AssertionError(f"B3s-K tie order {leaves} does not "
                                     "take the lower leaf first")
    # what a dead super-step costs on the device: 20 of them (the full
    # tree's workspace is done) captured as one graph and replayed
    ws = snaps["full_k16"]["ws"]
    dead_args = (ws, binned, vals, fmask, num_bin, na_bin, params, -1)
    words0 = ws.tree.clone()
    gr._super_step(*dead_args)
    torch.cuda.synchronize()
    dead_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(dead_graph):
        for _ in range(20):
            gr._super_step(*dead_args)
    dead_ms = median_ms(torch, dead_graph.replay, reps=10, warmup=2) / 20
    if not torch.equal(ws.tree, words0):
        raise AssertionError("dead super-steps changed the tree")
    emit({"phase": "wide_kernel_checks", "cases": cases,
          "b6_in_bag_share": in_bag, "dead_super_step_ms": dead_ms})

    def b3sk_call(fn):
        st["tree"] = st.get("tree", st["tree0"].clone())
        st["tree"].copy_(st["tree0"])
        fn(st["table"], st["tree"], na_bin, num_leaves=L, split_batch=K,
           max_depth=-1, step=st["step"])
    # the outputs of the last timed call of each, compared after both
    t_k = median_ms(torch, lambda: b3sk_call(gr.grow_step_batched))
    got_k = [t.clone() for t in (st["tree"], *st["step"])]
    t_p = median_ms(torch, lambda: b3sk_call(gr.grow_step_batched_plain))
    err3sk = exact_err(torch, zip(got_k, (st["tree"], *st["step"])),
                       "B3s-K (timed call)")
    words = st["tree0"].numel()
    b3sk_bytes = L * 4 + K * sp.RECORD * 4 + 2 * words * 4 + f * 4 \
        + K * 8 * 4 + L * 4 + 2 * K * (8 + 16 + 1) + K + 8
    rows.append(("grow_step_batched", "B3s-K batched split step",
                 "lightgbm_torch/csrc/grow_step.cu",
                 "lightgbm_tpu/grower.py:999", err3sk, err3sk, t_k, t_p,
                 bound_ms(b3sk_bytes, L * L), None))

    # B3-K on the snapshot's super-step, every timed call from its state
    lor, lor_p = st["lor"].clone(), st["lor"].clone()
    iota = torch.arange(B, dtype=torch.int32, device=dev)
    step = st["step"]
    t_k = median_ms(torch, lambda: gr.partition_slots(
        binned, lor.copy_(st["lor"]), step, iota))
    t_p = median_ms(torch, lambda: gr.partition_slots_plain(
        binned, lor_p.copy_(st["lor"]), step, iota))
    # the timed call's outputs against the plain version's: one more call
    # of each from the same state
    err3k = exact_err(torch, [
        (gr.partition_slots(binned, lor.copy_(st["lor"]), step, iota),
         gr.partition_slots_plain(binned, lor_p.copy_(st["lor"]), step,
                                  iota)), (lor, lor_p)], "B3-K (timed call)")
    rows.append(("partition_slots", "B3-K batched row partition",
                 "lightgbm_torch/csrc/partition.cu",
                 "lightgbm_tpu/grower.py:1029", err3k, err3k, t_k, t_p,
                 bound_ms(n * f + 12 * n, 3 * n), None))

    # B1-K at K = 16 and 8 on the target slots of a real super-step with
    # every slot valid, and at K = 16 on the first super-step's (one slot
    # valid), each with the super-step's count of slots in use
    err, rel, t16, fixed = 0.0, 0.0, None, {}
    for case, k, snap_key in (("full_k16", 16, "state"),
                              ("full_k8", 8, "state"),
                              ("full_k16", 16, "first")):
        tslot = snaps[case][snap_key]["tslot"]
        used = snaps[case][snap_key]["used"]
        b = histogram_slots_plain(binned, vals, tslot, num_slots=k,
                                  num_bins=B)
        a = compute_histogram(binned, vals, num_bins=B, slot=tslot,
                              num_slots=k, slots_used=used)
        a2 = compute_histogram(binned, vals, num_bins=B, slot=tslot,
                               num_slots=k, slots_used=used)
        what = f"K={k}, {snap_key}"
        if not torch.equal(a, a2):
            raise AssertionError(f"B1-K ({what}) is not bitwise "
                                 "reproducible")
        if not torch.equal(a[..., 2], b[..., 2]):
            raise AssertionError(f"B1-K ({what}) count channel differs")
        e = float((a - b).abs().max())
        scale = float(b.abs().max())
        if e > HIST_RTOL * max(1.0, scale):
            raise AssertionError(f"B1-K ({what}) max abs error {e} "
                                 f"(scale {scale})")
        err, rel = max(err, e), max(rel, e / max(scale, 1e-30))
        if snap_key == "state":
            fixed[k] = check_b1k_card(torch, lgt_kernels, binned, vals,
                                      tslot, used, B, k, what)
        if k == 16 and snap_key == "state":
            t16, used16 = tslot, used
    first = snaps["full_k16"]["first"]
    all16 = torch.tensor([16], dtype=torch.int32, device=dev)
    if int(first["used"][0]) >= 16:
        raise AssertionError("the first super-step has every slot valid")
    first_ms = {
        "slots_used": int(first["used"][0]),
        "rows_in_slots": int((first["tslot"] >= 0).sum()),
        "ms": median_ms(torch, lambda: compute_histogram(
            binned, vals, num_bins=B, slot=first["tslot"], num_slots=16,
            slots_used=first["used"])),
        "ms_slots_used_16": median_ms(torch, lambda: compute_histogram(
            binned, vals, num_bins=B, slot=first["tslot"], num_slots=16,
            slots_used=all16))}
    in_slots = int((t16 >= 0).sum())
    t_k = median_ms(torch, lambda: compute_histogram(
        binned, vals, num_bins=B, slot=t16, num_slots=16,
        slots_used=used16))
    t_p = median_ms(torch, lambda: histogram_slots_plain(
        binned, vals, t16, num_slots=16, num_bins=B))
    keep = t16 >= 0
    sl = t16[keep].to(torch.int64)
    idx = (binned[keep].to(torch.int64) + torch.arange(f, device=dev) * B
           + (sl * (f * B))[:, None]).reshape(-1)
    src = vals[keep].repeat_interleave(f, dim=0)
    acc = torch.zeros((16 * f * B, 3), device=dev)
    t_lib = median_ms(torch, lambda: acc.zero_().index_add_(0, idx, src))
    b1k_bytes = n * f + 12 * n + 4 * n + 16 * f * B * 12
    rows.append(("histogram_slots", "B1-K K-slot histogram (K = 16)",
                 "lightgbm_torch/csrc/histogram.cu",
                 "lightgbm_tpu/ops/histogram.py:129", err, rel, t_k, t_p,
                 bound_ms(b1k_bytes, 3 * in_slots * f), t_lib))
    # odd shapes, checked and not timed: 13 features x 255 bins (two pair
    # tiles at K = 8), a row count that leaves a short last chunk, and a
    # binned matrix 3 bytes into its allocation (byte-wise staging)
    on, of_, ob = 50_001, 13, 255
    obinned = torch.randint(0, ob, (on * of_ + 3,), dtype=torch.uint8,
                            device=dev, generator=gen)[3:].view(on, of_)
    og = torch.randn(on, device=dev, generator=gen)
    ovals = torch.stack([og, og.abs() + 0.1, torch.ones_like(og)], dim=1)
    oslot = torch.randint(-2, 8, (on,), dtype=torch.int32, device=dev,
                          generator=gen)
    a = compute_histogram(obinned, ovals, num_bins=ob, slot=oslot,
                          num_slots=8, slots_used=torch.tensor(
                              [8], dtype=torch.int32, device=dev))
    b = histogram_slots_plain(obinned, ovals, oslot, num_slots=8,
                              num_bins=ob)
    oerr = float((a - b).abs().max())
    if not torch.equal(a[..., 2], b[..., 2]) \
            or oerr > HIST_RTOL * max(1.0, float(b.abs().max())):
        raise AssertionError(f"B1-K (odd shapes) differs from its plain "
                             f"version: {oerr}")
    emit({"phase": "wide_kernel_odd", "rows": on, "features": of_,
          "bins": ob, "hist_slots_max_abs_err": oerr})

    out = {}
    for key, name, src_path, replaces, e, r, tk, tp, (bms, by), tl in rows:
        out[key] = {"name": name, "route": "cuda", "source": src_path,
                    "replaces": replaces, "max_abs_err": e, "ms": tk,
                    "plain_ms": tp, "bound_ms": bms, "bound_by": by,
                    "library_ms": tl}
        extra = {"rows_in_slots": in_slots, "fixed_point": fixed,
                 "first_super_step": first_ms} \
            if key == "histogram_slots" else {}
        emit({"phase": "kernel", **out[key], "max_rel_err": r,
              "kernel_ms": tk, **extra})
    return out, dead_ms


def tree_sections(text: str, k: int):
    """The first ``k`` trees of a model text."""
    return [t.strip() for t in
            text.split("end of trees")[0].split("\nTree=")[1:k + 1]]


# ---------------------------------------------------------------------------
# GOSS, feature_fraction_bynode and extra_trees (B6-GOSS, B6-node, B2's
# per-child form)

def goss_threshold_check(torch, g, h, vals, top_k: int, what: str):
    """B6-GOSS's selection from its output: the smallest |g| * h of the
    rows weighted 1 is the threshold; it equals ``torch.kthvalue``'s
    top_k-th largest, every row at or above it is weighted 1, and fewer
    than top_k rows lie above it.  Returns the threshold."""
    a = g.abs() * h
    n = a.numel()
    top = vals[:, 2] == 1.0
    thresh = a[top].min()
    kth = torch.kthvalue(a, n - top_k + 1).values
    if not same_bits(torch, thresh[None], kth[None]):
        raise AssertionError(f"B6-GOSS ({what}) threshold {float(thresh)} "
                             f"is not the {top_k}-th largest "
                             f"{float(kth)}")
    if not torch.equal(top, a >= thresh) or int((a > thresh).sum()) \
            >= top_k or int(top.sum()) < top_k:
        raise AssertionError(f"B6-GOSS ({what}) top set is not every row "
                             "at or above the threshold")
    return float(thresh)


def phase_sample_kernels(torch, lgt, train):
    """B6-GOSS, B6-node and B2 with per-child masks and random bins
    against their plain versions at 1M x 28, 63 bins, each compared on
    its timed call's own inputs; then the draws of two replays of one
    captured graph against the eager calls of the same iterations."""
    from lightgbm_torch.ops import random as rnd
    from lightgbm_torch.ops import split as sp
    from lightgbm_torch.ops.histogram import compute_histogram
    dev = torch.device("cuda", 0)
    binned = torch.as_tensor(train.binned).to(dev)
    n, f = binned.shape
    B = int(train.max_bin)
    mappers = [train.bin_mappers[i] for i in train.used_features]
    num_bin = torch.tensor([m.num_bin for m in mappers], dtype=torch.int32,
                           device=dev)
    na_bin = torch.tensor([m.na_bin for m in mappers], dtype=torch.int32,
                          device=dev)
    y = torch.as_tensor(train.metadata.label).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    p = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
    # gradients at a random score, and at iteration 0's constant score
    # (two values of |g| * h: ties on every row)
    p0 = torch.full_like(y, 0.47)
    grads = {"random": ((p - y).contiguous(), (p * (1 - p)).contiguous()),
             "ties": ((p0 - y).contiguous(), (p0 * (1 - p0)).contiguous())}
    goss = {"seed": 3, "top_rate": 0.2, "other_rate": 0.1}
    top_k, p_other, amp = rnd.goss_constants(n, 0.2, 0.1)
    rows, checks = [], {}

    # B6-GOSS: bitwise at two iterations, both gradient cases
    for case, (g, h) in grads.items():
        drawn = []
        for it in (0, 7):
            itd = torch.tensor([it], dtype=torch.int32, device=dev)
            a = rnd.goss_vals(g, h, itd, **goss)
            b = rnd.goss_vals_plain(g, h, itd, **goss)
            if not same_bits(torch, a, b):
                raise AssertionError(f"B6-GOSS ({case}, iteration {it}) "
                                     "differs from its plain version")
            thresh = goss_threshold_check(torch, g, h, a, top_k,
                                          f"{case}, iteration {it}")
            drawn.append(a[:, 2].clone())
        if torch.equal(drawn[0], drawn[1]):
            raise AssertionError(f"B6-GOSS ({case}): iterations 0 and 7 "
                                 "drew the same weights")
        w = drawn[0]
        checks[f"goss_{case}"] = {
            "threshold": thresh, "top_rows": int((w == 1.0).sum()),
            "in_bag_share": float((w > 0).float().mean())}
    if checks["goss_ties"]["top_rows"] <= top_k:
        raise AssertionError("B6-GOSS tie case keeps no tie above top_k")
    g, h = grads["random"]
    it3 = torch.tensor([3], dtype=torch.int32, device=dev)
    out6 = torch.empty((n, 3), device=dev)
    gbuf = rnd.goss_buffers(n, dev)       # as the training body holds them
    t_k = median_ms(torch, lambda: rnd.goss_vals(g, h, it3, out=out6,
                                                 buffers=gbuf, **goss))
    t_p = median_ms(torch, lambda: rnd.goss_vals_plain(g, h, it3, **goss))
    a = g.abs() * h
    t_lib = median_ms(torch, lambda: torch.kthvalue(a, n - top_k + 1))
    err = exact_err(torch, [(out6, rnd.goss_vals_plain(g, h, it3, **goss))],
                    "B6-GOSS (timed call)")
    goss_threshold_check(torch, g, h, out6, top_k, "timed call")
    # least bytes: g and h in, vals out (the kernel itself moves about
    # 40 N: its three select passes read keys it writes); operations: one
    # threefry2x32 a row (THREEFRY_OPS), and about 14 more: |g| * h, the
    # uniform's bits to float, a linear select's two compares, the two
    # compares and two selects of the weight, the three products
    rows.append(("goss_vals", "B6-GOSS top-k threshold, keyed draw and "
                 "vals stack", "lightgbm_torch/csrc/sample.cu",
                 "lightgbm_tpu/models/gbdt.py:1337", err,
                 err / max(float(out6.abs().max()), 1e-30), t_k, t_p,
                 bound_ms(8 * n + 12 * n, (THREEFRY_OPS + 14) * n), t_lib))

    # B6-node: a strict step (2 children) and a 2K = 32 super-step, two
    # iterations each, both draws on
    samp = rnd.NodeSampling(bynode_frac=0.8, bynode_seed=3,
                            extra_trees=True, extra_seed=6)
    base = torch.ones(f, dtype=torch.bool, device=dev)
    base[torch.randperm(f, device=dev, generator=gen)[:f // 5]] = False
    node = {}
    for C, s in ((2, 4), (32, 2)):
        for it in (0, 9):
            itd = torch.tensor([it], dtype=torch.int32, device=dev)
            kw = dict(count=C, bynode_id0=(s + 1) * C, extra_step=s + 1,
                      sampling=samp)
            mk = torch.zeros((C, f), dtype=torch.bool, device=dev)
            bk = torch.zeros((C, f), dtype=torch.int32, device=dev)
            rnd.node_draws(base, num_bin, itd, masks=mk, bins=bk, **kw)
            mp, bp = rnd.node_draws_plain(base, num_bin, itd, **kw)
            if not (torch.equal(mk, mp) and torch.equal(bk, bp)):
                raise AssertionError(f"B6-node ({C} children, iteration "
                                     f"{it}) differs from its plain version")
            keep = rnd.bynode_count(int(base.sum()), 0.8)
            if not torch.equal(mk.sum(dim=1), torch.full(
                    (C,), keep, device=dev)) or bool((mk & ~base).any()):
                raise AssertionError(f"B6-node ({C} children) masks keep "
                                     "other than the drawn features")
            node[(C, it)] = (mk, bk)
        if torch.equal(node[(C, 0)][0], node[(C, 9)][0]) or torch.equal(
                node[(C, 0)][1], node[(C, 9)][1]):
            raise AssertionError(f"B6-node ({C} children): iterations 0 "
                                 "and 9 drew the same")
    # an inactive step writes nothing
    mk, bk = (t.clone() for t in node[(32, 9)])
    rnd.node_draws(base, num_bin, torch.tensor([1], dtype=torch.int32,
                                               device=dev),
                   count=32, bynode_id0=64, extra_step=2, sampling=samp,
                   masks=mk, bins=bk,
                   active=torch.zeros(1, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    if not (torch.equal(mk, node[(32, 9)][0])
            and torch.equal(bk, node[(32, 9)][1])):
        raise AssertionError("B6-node wrote on an inactive step")
    it9 = torch.tensor([9], dtype=torch.int32, device=dev)
    kw32 = dict(count=32, bynode_id0=96, extra_step=3, sampling=samp)
    t_k = median_ms(torch, lambda: rnd.node_draws(base, num_bin, it9,
                                                  masks=mk, bins=bk, **kw32))
    t_p = median_ms(torch, lambda: rnd.node_draws_plain(base, num_bin, it9,
                                                        **kw32))
    mp, bp = rnd.node_draws_plain(base, num_bin, it9, **kw32)
    err = exact_err(torch, [(mk, mp), (bk, bp)], "B6-node (timed call)")
    C = 32
    # operations of each (child, feature): two threefry2x32 (the bynode
    # uniform and the random bin's) and the stable rank of the uniform, a
    # sort's log2 F compares and a scatter (the kernel's own all-pairs
    # rank does F compares, which the bound does not count)
    rows.append(("node_draws", "B6-node per-child feature subsets and "
                 "random bins (2K = 32 children)",
                 "lightgbm_torch/csrc/sample.cu",
                 "lightgbm_tpu/grower.py:495", err, err, t_k, t_p,
                 bound_ms(f + 4 * f + 4 + C * f + 4 * C * f,
                          C * f * (2 * THREEFRY_OPS
                                   + int(np.ceil(np.log2(f))) + 1)), None))

    # B2 on 2K = 32 children of a real split of the rows into 16 slots,
    # with the super-step's masks and random bins: each operand alone and
    # both (timed), within SPLIT_RTOL of the plain version
    vals = torch.stack([g, h, torch.ones_like(g)], dim=1)
    slot = torch.randint(0, 16, (n,), dtype=torch.int32, device=dev,
                         generator=gen)
    small = compute_histogram(binned, vals, num_bins=B, slot=slot,
                              num_slots=16,
                              slots_used=torch.tensor([16], dtype=torch.int32,
                                                      device=dev))
    root = compute_histogram(binned, vals, num_bins=B)
    pair = torch.cat([small, root[None] - small]).contiguous()
    tot = pair[:, 0].sum(dim=1).contiguous()
    po = torch.zeros(C, device=dev)
    masks, bins = node[(32, 9)]
    params = sp.SplitParams()
    err2 = rel2 = 0.0
    for case, (fm, rb) in {"masks": (masks, None), "bins": (base, bins),
                           "both": (masks, bins)}.items():
        r_k = sp.find_best_split(pair, tot, po, num_bin, na_bin, fm, params,
                                 rand_bin=rb)
        r_p = sp.find_best_split_plain(pair, tot, po, num_bin, na_bin, fm,
                                       params, rand_bin=rb)
        e, r = check_split(torch, sp, r_k, r_p, f"per-child {case}")
        err2, rel2 = max(err2, e), max(rel2, r)
        picked = r_k[:, sp.FEATURE].long()
        live = ~torch.isneginf(r_k[:, sp.GAIN])
        fmr = fm if fm.dim() == 2 else fm[None].expand(C, f)
        if not bool(fmr[torch.arange(C, device=dev), picked][live].all()):
            raise AssertionError(f"B2 per-child ({case}) splits on a "
                                 "masked feature")
        if rb is not None and not torch.equal(
                r_k[live, sp.THRESHOLD].long(),
                rb[torch.arange(C, device=dev), picked][live].long()):
            raise AssertionError(f"B2 per-child ({case}) splits off its "
                                 "random bin")
        checks[f"split_{case}_children_with_a_split"] = int(live.sum())
    t_k = median_ms(torch, lambda: sp.find_best_split(
        pair, tot, po, num_bin, na_bin, masks, params, rand_bin=bins))
    t_p = median_ms(torch, lambda: sp.find_best_split_plain(
        pair, tot, po, num_bin, na_bin, masks, params, rand_bin=bins))
    r_k = sp.find_best_split(pair, tot, po, num_bin, na_bin, masks, params,
                             rand_bin=bins)
    e, r = check_split(torch, sp, r_k, sp.find_best_split_plain(
        pair, tot, po, num_bin, na_bin, masks, params, rand_bin=bins),
        "per-child, timed inputs")
    err2, rel2 = max(err2, e), max(rel2, r)
    cand = 2 * C * f * B
    b2_bytes = pair.numel() * 4 + C * 3 * 4 + C * 4 + 2 * f * 4 \
        + C * f * 5 + C * sp.RECORD * 4
    rows.append(("split_per_child", "B2 split scan, per-child masks and "
                 "random bins (2K = 32 children)",
                 "lightgbm_torch/csrc/split.cu",
                 "lightgbm_tpu/ops/split.py:229", err2, rel2, t_k, t_p,
                 bound_ms(b2_bytes, 40 * cand), None))

    # keys in a graph: the GOSS draw and a super-step's node draws captured
    # once, replayed at iterations 4 and 5, each replay equal to the eager
    # calls (the per-iteration path's form) of its iteration
    itg = torch.zeros(1, dtype=torch.int32, device=dev)
    gv = torch.empty((n, 3), device=dev)
    gm = torch.zeros((C, f), dtype=torch.bool, device=dev)
    gb = torch.zeros((C, f), dtype=torch.int32, device=dev)

    def draws():
        rnd.goss_vals(g, h, itg, out=gv, **goss)
        rnd.node_draws(base, num_bin, itg, masks=gm, bins=gb, **kw32)
    draws()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        draws()
    replays = []
    for it in (4, 5):
        itg.fill_(it)
        graph.replay()
        torch.cuda.synchronize()
        replays.append((gv.clone(), gm.clone(), gb.clone()))
        itd = torch.tensor([it], dtype=torch.int32, device=dev)
        ev = rnd.goss_vals(g, h, itd, **goss)
        em = torch.zeros_like(gm)
        eb = torch.zeros_like(gb)
        rnd.node_draws(base, num_bin, itd, masks=em, bins=eb, **kw32)
        if not (same_bits(torch, gv, ev) and torch.equal(gm, em)
                and torch.equal(gb, eb)):
            raise AssertionError(f"graph replay at iteration {it} draws "
                                 "other than the eager calls")
    if any(torch.equal(a, b) for a, b in zip(*replays)):
        raise AssertionError("two replays drew the same weights, masks or "
                             "bins")
    checks["graph_replays_differ_and_equal_eager"] = True

    out = {}
    for key, name, src_path, replaces, e, r, tk, tp, (bms, by), tl in rows:
        out[key] = {"name": name, "route": "cuda", "source": src_path,
                    "replaces": replaces, "max_abs_err": e, "ms": tk,
                    "plain_ms": tp, "bound_ms": bms, "bound_by": by,
                    "library_ms": tl}
        emit({"phase": "kernel", **out[key], "max_rel_err": r,
              "kernel_ms": tk})
    emit({"phase": "sample_kernels", "top_k": top_k,
          "p_other": float(p_other), "amp": float(amp), **checks})
    return out


def phase_sampled_train(torch, lgt, lgt_kernels, train, valid, xv,
                        prefix: str, params: dict, per_it: dict,
                        dead_ms=None, after=None, rounds=ROUNDS,
                        ref_auc=None):
    """Default ``train`` with ``params`` (sampling at a tree shape) as
    super-epochs, launch counts held to ``per_it`` per iteration; the
    per-iteration path (SAMPLED_PER_ITERATION_ROUNDS rounds: the same
    trees and evals, eager launches held) and fused chunks (25 rounds
    without a valid set: the same trees, launches held); a profiled rerun
    with byte-identical model text (device busy share); ``Booster.predict``
    of the model through the engine, byte-identical to the host walk.
    Emits the ``{prefix}_train`` line; ``dead_ms`` (batched growth): what
    one dead super-step costs; ``after(bst, prog)``: more checks of the
    super-epoch model, whose dict joins the line; ``rounds``: the
    super-epoch run's rounds; ``ref_auc``: the f32 main path's valid AUC
    by round, which the run's AUC at its best iteration must stay within
    QUANT_AUC_GAP of (the gap at every common round is reported).
    Returns (device launches by path, steady ms
    per iteration, eager ms per iteration, the iteration's (bound ms, by,
    bytes) from the run's own trees)."""
    name = f"{prefix}_train"
    no_valid = {**per_it, "predict": 0, "auc": 0, "pointwise": 0}
    L = params["num_leaves"]
    lgt_kernels.reset_launch_counts()
    bst, ev, secs = train_main(lgt, train, valid, extra=params,
                               rounds=rounds)
    torch.cuda.synchronize()
    eager = lgt_kernels.launch_counts()
    m = bst._model
    batched = L == WIDE_LEAVES
    if m.split_batch != (WIDE_K if batched else 1):
        raise AssertionError(f"{name}: split_batch {m.split_batch}")
    prog = fused_program(m)
    iters = m.num_iterations_trained
    epochs = len(m.epoch_ms)
    k = max(2, min(25, ES_ROUNDS))
    if m.fetch_counts != {"epoch": epochs} or prog.replays != k * epochs:
        raise AssertionError(f"{name}: fetches {m.fetch_counts}, "
                             f"{prog.replays} replays, {epochs} epochs")
    if prog.captured != per_it or prog.warmup != per_it \
            or eager != times(per_it, 2):
        raise AssertionError(f"{name} launches: captured {prog.captured}, "
                             f"warm-up {prog.warmup}, wrapper calls "
                             f"{eager}, expected {per_it} each")
    device = {kk: prog.warmup[kk] + v for kk, v in prog.launches().items()}
    auc = ev["valid_0"]["auc"]
    best = bst.best_iteration
    if not 0.5 < auc[best - 1] <= 1.0:
        raise AssertionError(f"{name} valid AUC {auc[best - 1]}")
    if max(t.num_leaves for t in m.models) != L:
        raise AssertionError(f"{name} trees never reach {L} leaves")
    steady = m.epoch_ms[1:] if epochs > 1 else m.epoch_ms
    ms_it = statistics.median(steady) / k
    live = m.step_counts
    (n_rows, n_cols), n_valid = train.binned.shape, valid.binned.shape[0]
    efb = m.efb_dev
    b_ms, b_by, b_bytes = iteration_bound(
        m.models, n_rows, n_cols,
        int(train.max_bin) if efb is None else efb.group_bins, L, n_valid,
        super_steps=live if batched else None,
        scan=None if efb is None else (m.num_features, int(train.max_bin)))
    text = bst.model_to_string()
    # the rows the last replay's GOSS draw kept (w > 0), read from the
    # program's own vals buffer
    in_bag = None
    if m._goss:
        in_bag = float((prog.vals[:, 2] > 0).float().mean())
        if not 0.25 < in_bag < 0.35:
            raise AssertionError(f"{name}: in-bag share {in_bag}")
    main = {"iterations": iters, "best_iteration": best,
            "valid_auc": auc[best - 1], "seconds": secs,
            "iterations_per_s": iters / secs, "epochs": epochs,
            "epoch_ms": m.epoch_ms, "steady_iterations_per_s": 1e3 / ms_it,
            "ms_per_iteration": ms_it, "bound_ms_per_iteration": b_ms,
            "bound_by": b_by, "bound_bytes_per_iteration": b_bytes,
            "in_bag_share": in_bag,
            "live_steps_per_tree": statistics.mean(live),
            "live_steps_max": max(live), "launched_steps_per_tree": L - 1,
            "leaves_per_tree": statistics.mean(t.num_leaves
                                               for t in m.models),
            "capture_ms": prog.capture_ms, "device_launches": device}
    if dead_ms is not None:
        main["dead_super_steps_ms_per_iteration"] = dead_ms * \
            statistics.mean([L - 1 - x for x in live])
    if ref_auc is not None:
        common = min(len(auc), len(ref_auc))
        gaps = [auc[i] - ref_auc[i] for i in range(common)]
        if best > common or abs(gaps[best - 1]) > QUANT_AUC_GAP:
            raise AssertionError(f"{name}: valid AUC {auc[best - 1]} at "
                                 f"round {best}, the f32 main path's "
                                 f"{ref_auc[:best][-1]}")
        main["f32_auc_gap"] = {"round": best, "gap": gaps[best - 1],
                               "f32_valid_auc": ref_auc[best - 1],
                               "max_abs_gap": max(abs(g) for g in gaps),
                               "limit": QUANT_AUC_GAP}

    # per-iteration, fewer rounds: the same first trees and evals
    lgt_kernels.reset_launch_counts()
    bp, evp, secs_p = train_main(
        lgt, train, valid, rounds=SAMPLED_PER_ITERATION_ROUNDS,
        extra={**params, "superepoch": -1, "fused_chunk": 1,
               "fused_eval": "true"})
    torch.cuda.synchronize()
    per_it_counts = lgt_kernels.launch_counts()
    n_p = bp._model.num_iterations_trained
    if per_it_counts != times(per_it, n_p):
        raise AssertionError(f"{name} per-iteration launches "
                             f"{per_it_counts} for {n_p} iterations")
    ta, tb = tree_sections(bp.model_to_string(), n_p), \
        tree_sections(text, n_p)
    if n_p != SAMPLED_PER_ITERATION_ROUNDS or iters < n_p or ta != tb \
            or any(evp["valid_0"][kk] != ev["valid_0"][kk][:n_p]
                   for kk in evp["valid_0"]):
        first = next((i for i, (a, b) in enumerate(zip(ta, tb)) if a != b),
                     None)
        lines = [] if first is None else [
            (x[:120], y[:120]) for x, y in zip(ta[first].splitlines(),
                                               tb[first].splitlines())
            if x != y][:3]
        raise AssertionError(
            f"{name}: per-iteration trees or evals differ from the "
            f"super-epoch run's: {n_p} and {iters} iterations, first tree "
            f"differing {first}: {lines}; evals {evp['valid_0']} vs "
            f"{ {kk: v[:n_p] for kk, v in ev['valid_0'].items()} }")

    # fused chunks without a valid set: the same first trees
    cparams = {"objective": "binary", "max_bin": MAX_BIN,
               "learning_rate": 0.1, "verbosity": -1, **params}
    lgt_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    bc = lgt.train(cparams, train, 25)
    torch.cuda.synchronize()
    secs_c = time.perf_counter() - t0
    eager_c = lgt_kernels.launch_counts()
    pc = fused_program(bc._model)
    chunk = {kk: pc.warmup[kk] + v for kk, v in pc.launches().items()}
    if pc.captured != no_valid or eager_c != times(no_valid, 2) \
            or pc.replays != 25 \
            or tree_sections(bc.model_to_string(), n_p) != tb:
        raise AssertionError(f"{name} fused chunks: captured {pc.captured}, "
                             f"wrapper calls {eager_c}, {pc.replays} "
                             "replays, or trees differ")

    # a profiled rerun: byte-identical model text, device busy share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        b2, _, secs2 = train_main(lgt, train, valid, extra=params,
                                  rounds=rounds)
        torch.cuda.synchronize()
    if b2.model_to_string() != text:
        raise AssertionError(f"a second {name} run gave other model text")
    p2 = fused_program(b2._model)

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", 0) or 0)
    events = [e for e in prof.key_averages() if dev_us(e) > 0
              and not e.key.startswith(("aten::", "Memcpy HtoD"))]
    dev_ms = sum(dev_us(e) for e in events) / 1e3
    per_iter = dev_ms / (p2.replays + 1)
    st2 = b2._model.epoch_ms[1:]
    busy = per_iter * k / statistics.median(st2) if st2 and dev_ms \
        else None
    top = sorted(((e.key[:90], dev_us(e) / 1e3, e.count) for e in events),
                 key=lambda r: -r[1])[:15]

    # Booster.predict: the engine route, one walk per bucket chunk and no
    # other launch, byte-identical to the host walk
    from lightgbm_torch.serve import PredictorEngine
    bst._drop_predict_cache()
    torch.cuda.synchronize()
    lgt_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pe = bst.predict(xv)
    t_eng = time.perf_counter() - t0
    torch.cuda.synchronize()
    pred_counts = lgt_kernels.launch_counts()
    eng = bst._engine_cache
    if not isinstance(eng, PredictorEngine):
        raise AssertionError(f"{name} predict did not take the engine "
                             "route")
    hold_launches(f"{name} predict", pred_counts, forest_launches(
        lgt_kernels, forest_walk=chunks(eng, len(xv))))
    if not np.array_equal(pe, host_walk(bst, xv)):
        raise AssertionError(f"{name} predict: the engine route differs "
                             "from the host walk")
    if after is not None:
        main.update(after(bst, prog))
    emit({"phase": name, "params": params, **main,
          "per_iteration": {"iterations": n_p, "seconds": secs_p,
                            "iterations_per_s": n_p / secs_p,
                            "ms_per_iteration": 1e3 * secs_p / n_p},
          "fused_chunk": {"rounds": 25, "seconds": secs_c,
                          "iterations_per_s": 25 / secs_c,
                          "epoch_ms": bc._model.epoch_ms},
          "rerun_byte_identical": True, "rerun_seconds": secs2,
          "profile": {"device_kernel_ms_per_iteration": per_iter,
                      "steady_busy_share": busy, "top_kernels": [
                          {"name": n_, "device_ms": d, "count": c}
                          for n_, d, c in top]},
          "predict": {"rows_per_s": len(xv) / t_eng,
                      "forest_walk_launches": pred_counts["forest_walk"],
                      "byte_identical_to_host_walk": True}})
    return {name: device, f"{prefix}_per_iteration": per_it_counts,
            f"{prefix}_fused_chunk": chunk}, ms_it, 1e3 * secs_p / n_p, \
        (b_ms, b_by, b_bytes)


# ---------------------------------------------------------------------------
# categorical splits (B2-cat, rank rows through B3/B3-K, B3s/B3s-K, B4)
# ---------------------------------------------------------------------------

def make_expo_like(n: int, seed: int):
    """An airline-shaped set (``CAT_CARDS`` categories a column, Zipf-
    skewed by ``CAT_ZIPF``; DepTime as hhmm-like integers and Distance,
    2% NaN each) with a binary label from seeded per-category effects
    (the same effects for every seed), about 20% positive."""
    rng = np.random.RandomState(seed)
    eff = np.random.RandomState(1234)
    x = np.empty((n, 8), np.float32)
    logit = np.zeros(n)
    for j, (c, z, e) in enumerate(zip(CAT_CARDS, CAT_ZIPF, CAT_EFFECT)):
        p = 1.0 / np.arange(1, c + 1) ** z
        col = rng.choice(c, size=n, p=p / p.sum())
        x[:, j] = col
        logit += e * eff.randn(c)[col]
    dep = rng.randint(0, 2400, n)
    dist = rng.gamma(2.0, 400.0, n)
    logit += 0.8 * (dep > 1700) + 0.3 * np.log(dist / 800.0)
    logit += 0.5 * rng.randn(n)
    x[:, 6], x[:, 7] = dep, dist
    x[:, 6:][rng.rand(n, 2) < 0.02] = np.nan
    return x, (logit > 1.4).astype(np.float32)


def phase_cat_data(lgt):
    t0 = time.perf_counter()
    x, y = make_expo_like(N_TRAIN, seed=10)
    xv, yv = make_expo_like(N_VALID, seed=11)
    params = {"max_bin": CAT_MAX_BIN, "verbosity": -1}
    train = lgt.Dataset(x, y, categorical_feature=list(CAT_COLS),
                        params=params).construct()
    valid = lgt.Dataset(xv, yv, reference=train, params=params).construct()
    mappers = [train.bin_mappers[i] for i in train.used_features]
    cats = [len(m.categories) for m in mappers
            if m.bin_type.name == "CATEGORICAL"]
    if train.binned.shape != (N_TRAIN, 8) or train.binned.dtype != np.uint8 \
            or len(cats) != len(CAT_COLS) or max(cats) < 250:
        raise AssertionError(f"unexpected categorical set: "
                             f"{train.binned.shape}, categories {cats}")
    emit({"phase": "cat_data", "seconds": time.perf_counter() - t0,
          "train": list(train.binned.shape),
          "valid": list(valid.binned.shape), "max_bin": int(train.max_bin),
          "categories_kept": cats, "categories_drawn": list(CAT_CARDS),
          "positive_share": float(y.mean()),
          "cut": "rows cut from Expo's millions to 1M train and 200k "
                 "valid rows; columns and cardinalities not cut"})
    return xv, train, valid


def check_cat_split(torch, sp, args, params, is_cat, what):
    """B2 with B2-cat on the card against the plain version on CPU copies
    of the same inputs.  B2-cat's prefix sums, in the kernel and in the
    plain version, accumulate in f64 in bin order (the CPU's cumsum), so
    the mirrored subsets of a feature (an ascending prefix and the
    descending prefix of the other used bins, whose gains tie up to
    rounding) resolve alike; B2's numerical prefix sums are f32 in the
    kernel, and its fields are held within SPLIT_RTOL.  The feature,
    threshold, direction, is-categorical flag and rank rows are held
    exactly.  Returns (max abs, max rel error, cat flags, thresholds)."""
    rec, cat, rank = sp.find_best_split(*args, params, is_cat=is_cat)
    cpu = [t.cpu() for t in args]
    rp, cp, kp = sp.find_best_split_plain(*cpu, params,
                                          is_cat=is_cat.cpu())
    err, rel = check_split(torch, sp, rec.cpu(), rp, what)
    if not torch.equal(cat.cpu(), cp) or not torch.equal(rank.cpu(), kp):
        bad = torch.nonzero((rank.cpu() != kp).any(dim=1)).flatten()
        raise AssertionError(f"B2-cat ({what}): flags {cat.tolist()} vs "
                             f"{cp.tolist()}, rank rows differ at "
                             f"{bad.tolist()}")
    return err, rel, cp, rp[:, sp.THRESHOLD].to(torch.int64)


def phase_cat_kernels(torch, lgt, train, valid):
    """B2-cat against its plain version on 2K = 32 children of the
    categorical set (255 bins): at the training shape, with [2K, F]
    per-child masks, one-vs-rest, subsets over 7, 31 and 254 categories, a
    max_cat_threshold cut, cat_l2 and cat_smooth in turn, exactly tied
    ratios, an inactive step and both outcomes of the
    numerical/categorical merge; B1 and B1-K at 255 bins; B3 with
    categorical records and rank tables; B3s and B3-K/B3s-K at every step
    of whole categorical trees (31 leaves, and 255 leaves at K = 16); B4
    on a categorical tree over the valid rows with NaN in the numerical
    columns.  Each timed, with bounds; emits the cat_kernels line and
    returns the kernels-line row of B2-cat."""
    from lightgbm_torch import grower as gr
    from lightgbm_torch.ops import split as sp
    from lightgbm_torch.ops.histogram import (compute_histogram,
                                              histogram_plain,
                                              histogram_slots_plain)
    from lightgbm_torch.predict_device import (add_tree_score,
                                               add_tree_score_plain)
    dev = torch.device("cuda", 0)
    binned = torch.as_tensor(train.binned).to(dev)
    vbinned = torch.as_tensor(valid.binned).to(dev)
    n, f = binned.shape
    nv = vbinned.shape[0]
    B = int(train.max_bin)
    mappers = [train.bin_mappers[i] for i in train.used_features]
    num_bin = torch.tensor([m.num_bin for m in mappers], dtype=torch.int32,
                           device=dev)
    na_bin = torch.tensor([m.na_bin for m in mappers], dtype=torch.int32,
                          device=dev)
    is_cat = torch.tensor([m.bin_type.name == "CATEGORICAL"
                           for m in mappers], dtype=torch.bool, device=dev)
    cat_f = torch.nonzero(is_cat).flatten().tolist()
    num_f = [j for j in range(f) if j not in cat_f]
    by_card = {int(num_bin[j]): j for j in cat_f}
    y = torch.as_tensor(train.metadata.label).to(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    p = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
    vals = torch.stack([p - y, p * (1 - p), torch.ones_like(y)], dim=1)
    # the binary gradients at score 0 (+-0.5, 0.25): every histogram sum
    # is exact in f32 whatever the order, so B1 and B1-K are held bit for
    # bit on them.  On the gradients at a random score a bin of 250,000
    # rows (the commonest carrier) sums to about 1e5, and the kernel's and
    # index_add_'s f32 orders differ by units there: that difference is
    # reported, not held
    vals_exact = torch.stack([0.5 - y, torch.full_like(y, 0.25),
                              torch.ones_like(y)], dim=1)
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    params = sp.SplitParams()
    out = {}

    # B1 at 255 bins: the root pass
    h_k = compute_histogram(binned, vals_exact, num_bins=B)
    h_p = histogram_plain(binned, vals_exact, num_bins=B)
    if not torch.equal(h_k, h_p):
        raise AssertionError(f"B1 (255 bins, exact sums) differs from its "
                             f"plain version: "
                             f"{float((h_k - h_p).abs().max())}")
    h_k = compute_histogram(binned, vals, num_bins=B)
    e1 = float((h_k - histogram_plain(binned, vals, num_bins=B)).abs().max())
    idx = (binned.to(torch.int64) + torch.arange(f, device=dev) * B
           ).reshape(-1)
    src = vals.repeat_interleave(f, dim=0)
    acc = torch.zeros((f * B, 3), device=dev)
    out["histogram"] = {
        "max_abs_err": 0.0, "max_abs_err_inexact": e1,
        "ms": median_ms(torch, lambda: compute_histogram(binned, vals,
                                                         num_bins=B)),
        "plain_ms": median_ms(torch, lambda: histogram_plain(
            binned, vals, num_bins=B)),
        "library_ms": median_ms(torch, lambda: acc.zero_().index_add_(
            0, idx, src)),
        "bound": bound_ms(n * f + 12 * n + f * B * 12, 3 * n * f)}

    # 2K = 32 children: nested random row subsets of the set
    K2 = 2 * WIDE_K
    u = torch.rand(n, device=dev, generator=gen)
    fracs = torch.linspace(0.05, 1.0, K2)
    hist = torch.stack([compute_histogram(
        binned, vals, num_bins=B,
        slot=torch.where(u < float(fr), 0, -1).to(torch.int32))
        for fr in fracs]).contiguous()
    tot = hist[:, num_f[0]].sum(dim=1).contiguous()
    po = (0.01 * torch.randn(K2, device=dev, generator=gen)).contiguous()
    base = (hist, tot, po, num_bin, na_bin, fmask)
    err = rel = 0.0
    cases = {}

    def case(what, args, prm=params, want_cat=None):
        nonlocal err, rel
        e, r, cat, thr = check_cat_split(torch, sp, args, prm, is_cat, what)
        err, rel = max(err, e), max(rel, r)
        cases[what] = {"categorical_winners": int(cat.sum()),
                       "max_threshold": int(thr[cat.bool()].max())
                       if bool(cat.any()) else None}
        if want_cat is True and not bool(cat.all()):
            raise AssertionError(f"B2-cat ({what}): a numerical winner")
        if want_cat is False and bool(cat.any()):
            raise AssertionError(f"B2-cat ({what}): a categorical winner")
        return cat, thr

    case("training_shape", base)
    masks = torch.rand((K2, f), device=dev, generator=gen) < 0.6
    masks[:, cat_f[0]] = True
    case("per_child_masks", base[:5] + (masks.contiguous(),))
    for card in (7, 31, max(by_card)):
        only = torch.zeros(f, dtype=torch.bool, device=dev)
        only[by_card[card]] = True
        cat, thr = case(f"subsets_{card}_categories", base[:5] + (only,),
                        want_cat=True)
        if not bool((thr > 0).any()):
            raise AssertionError(f"B2-cat over {card} categories takes no "
                                 "subset of more than one category")
    origin = torch.zeros(f, dtype=torch.bool, device=dev)
    origin[by_card[max(by_card)]] = True
    _, thr = case("max_cat_threshold_4", base[:5] + (origin,),
                  sp.SplitParams(max_cat_threshold=4), want_cat=True)
    if int(thr.max()) > 3:
        raise AssertionError("B2-cat exceeds max_cat_threshold")
    case("cat_l2_0", base, sp.SplitParams(cat_l2=0.0))
    case("cat_smooth_1", base, sp.SplitParams(cat_smooth=1.0))
    # one-vs-rest: every categorical feature keeps 4 used bins
    ovr = hist.clone()
    ovr[:, cat_f, 4:] = 0.0
    _, thr = case("one_vs_rest", (ovr,) + base[1:], want_cat=True)
    if bool((thr != 0).any()):
        raise AssertionError("B2-cat one-vs-rest threshold is not 0")
    # exactly tied ratios: two Origin categories with equal sums
    tied = hist.clone()
    fo = by_card[max(by_card)]
    tied[:, fo, 9] = tied[:, fo, 2]
    case("tied_ratios", (tied,) + base[1:5] + (origin,), want_cat=True)
    # the merge: a flat Month (no categorical gain) against DepTime, and
    # Origin against a flat DepTime (no numerical gain)
    dep = num_f[0]
    pair = torch.zeros(f, dtype=torch.bool, device=dev)
    pair[[by_card[12], dep]] = True
    flat = hist.clone()
    flat[:, by_card[12], :, 0] = flat[:, by_card[12], :, 1] * (
        tot[:, 0] / tot[:, 1])[:, None]
    case("numerical_wins", (flat,) + base[1:5] + (pair,), want_cat=False)
    pair2 = torch.zeros(f, dtype=torch.bool, device=dev)
    pair2[[fo, dep]] = True
    flat2 = hist.clone()
    flat2[:, dep] = 0.0
    flat2[:, dep, 0] = tot
    case("categorical_wins", (flat2,) + base[1:5] + (pair2,),
         want_cat=True)
    # an inactive step writes nothing into the records
    r_num = sp.find_best_split(*base, params)
    kept = r_num.clone()
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    sp._split_cat(hist, tot, po, fmask, 0, is_cat, params, zero.data_ptr(),
                  kept)
    torch.cuda.synchronize()
    if not torch.equal(kept, r_num):
        raise AssertionError("B2-cat wrote records on an inactive step")

    # timing at the training shape: B2-cat alone (its merge into a copy
    # of the numerical records), its plain version on the card, and
    # torch.sort of the keys alone
    work = r_num.clone()
    t_k = median_ms(torch, lambda: sp._split_cat(
        hist, tot, po, fmask, 0, is_cat, params, None, work.copy_(r_num)))
    t_p = median_ms(torch, lambda: sp._categorical_plain(
        hist, tot, po, fmask & is_cat, params, r_num))
    hc = hist[:, cat_f]
    used = hc[..., 2] >= max(0.5, params.min_data_per_group - 0.5)
    ratio = hc[..., 0] / (hc[..., 1] + params.cat_smooth)
    keys = torch.stack([torch.where(used, ratio, 1e30),
                        torch.where(used, -ratio, 1e30)], dim=2)
    t_lib = median_ms(torch, lambda: torch.sort(keys, dim=-1, stable=True))
    nc = len(cat_f)
    b2c_bytes = K2 * nc * B * 12 + K2 * 16 + 2 * K2 * sp.RECORD * 4 \
        + K2 * 4 + K2 * B * 4 + 2 * f
    # two stable sorts (B log2 B compares each), six prefix sums and
    # three candidates' gains (about 40 operations) a bin
    b2c_ops = K2 * nc * (2 * B * float(np.log2(B)) + 6 * B + 120 * B)
    bms, by = bound_ms(b2c_bytes, b2c_ops)
    row = {"name": "B2-cat categorical split scan", "route": "cuda",
           "source": "lightgbm_torch/csrc/split.cu",
           "replaces": "lightgbm_tpu/ops/split.py:236", "max_abs_err": err,
           "ms": t_k, "plain_ms": t_p, "bound_ms": bms, "bound_by": by,
           "library_ms": t_lib}
    emit({"phase": "kernel", **row, "max_rel_err": rel, "kernel_ms": t_k,
          "children": K2, "categorical_features": nc, "bins": B,
          "cases": cases})

    # B3 with categorical records: the root's B2-cat winner over Origin
    # (na_bin -1, the rank row in row 0 of a [L, B] table), and mid-tree
    # with rows spread over 17 leaves and a permuted rank row a leaf
    res = sp.find_best_split(h_k[None], tot[-1:], po[:1], num_bin, na_bin,
                             origin, params, is_cat=is_cat)
    table = torch.stack([torch.randperm(B, device=dev, generator=gen)
                         for _ in range(NUM_LEAVES)]).to(torch.int32)
    table[0] = res[2][0]
    thr0 = int(res[0][0, sp.THRESHOLD])

    def crec(leaf, new_leaf, feat, thr, smaller):
        return torch.tensor([leaf, new_leaf, feat, thr, 0, -1, smaller, 1],
                            dtype=torch.int32, device=dev)
    lor0 = torch.zeros(n, dtype=torch.int32, device=dev)
    lor_mid = torch.randint(0, 17, (n,), dtype=torch.int32, device=dev,
                            generator=gen)
    e3 = 0.0
    for what, lor, rec in (("root", lor0, crec(0, 1, fo, thr0, 1)),
                           ("mid_tree", lor_mid,
                            crec(5, 17, by_card[31], 12, 5))):
        lk, lp = lor.clone(), lor.clone()
        sk = gr.partition(binned, lk, rec, table)
        sp_ = gr.partition_plain(binned, lp, rec, table)
        check_partition(torch, lk, lp, sk, sp_, f"categorical {what}")
        if what == "root" and int((lk == 1).sum()) == 0:
            raise AssertionError("B3 categorical root split moves no row")
    args3 = (crec(0, 1, fo, thr0, 1), table)
    lor_k, lor_p = lor0.clone(), lor0.clone()
    out["partition"] = {
        "ms": median_ms(torch, lambda: gr.partition(
            binned, lor_k.fill_(0), *args3)),
        "plain_ms": median_ms(torch, lambda: gr.partition_plain(
            binned, lor_p.fill_(0), *args3)),
        "bound": bound_ms(n * f + 12 * n, 2 * n)}
    out["partition"]["max_abs_err"] = exact_err(torch, [
        (gr.partition(binned, lor_k.fill_(0), *args3),
         gr.partition_plain(binned, lor_p.fill_(0), *args3)),
        (lor_k, lor_p)], "B3 categorical (timed call)")

    # B3s (and B3) at every step of a whole categorical 31-leaf tree
    snap = {}
    steps, active = check_grow_step(torch, binned, vals, fmask, num_bin,
                                    na_bin, B, params, -1, "categorical",
                                    snap, is_cat=is_cat)
    ws = snap["ws"]
    tree = gr.fetch_tree(ws)
    nn = tree.num_leaves - 1
    n_cat_nodes = int(tree.is_cat_node[:nn].sum())
    if active != NUM_LEAVES - 1 or n_cat_nodes == 0:
        raise AssertionError(f"categorical strict tree: {active} active "
                             f"steps, {n_cat_nodes} categorical nodes")
    st = snap["state"]
    outs = ("tree", "rec", "idx", "fstep", "flags")
    lcat, lrank = ws.leaf_cat.clone(), ws.leaf_rank.clone()

    def b3s_call(fn):
        st["tree"].copy_(st["tree0"])
        fn(st["table"], st["tree"], na_bin, num_leaves=NUM_LEAVES,
           max_depth=-1, rec=st["rec"], idx=st["idx"], fstep=st["fstep"],
           flags=st["flags"], leaf_cat=lcat, leaf_rank=lrank)
    t_k = median_ms(torch, lambda: b3s_call(gr.grow_step))
    got = [st[o].clone() for o in outs]
    t_p = median_ms(torch, lambda: b3s_call(gr.grow_step_plain))
    words = st["tree"].numel()
    out["grow_step"] = {
        "ms": t_k, "plain_ms": t_p,
        "max_abs_err": exact_err(torch, zip(got, [st[o] for o in outs]),
                                 "B3s categorical (timed call)"),
        "bound": bound_ms(st["table"].numel() * 4 + 2 * words * 4
                          + 2 * B * 4 + f * 4 + 64, 2 * NUM_LEAVES),
        "tree_words": words}

    # B4 on that tree over the valid rows (NaN bins in DepTime and
    # Distance; a categorical node never takes the NA branch)
    arr = ws.arrays()
    walk = (vbinned, arr.split_feature, arr.threshold_bin, arr.default_left,
            arr.left_child, arr.right_child, na_bin, arr.leaf_value, 0.1)
    cat4 = {"steps": 32, "is_cat_node": arr.is_cat_node,
            "cat_rank": arr.cat_rank}
    na_rows = int(sum(int((vbinned[:, j] == na_bin[j]).sum())
                      for j in num_f if int(na_bin[j]) >= 0))
    if na_rows == 0:
        raise AssertionError("B4 categorical check has no NA row")
    score0 = torch.randn(nv, device=dev, generator=gen)
    s_k, s_p = score0.clone(), score0.clone()
    add_tree_score(s_k, *walk, **cat4)
    add_tree_score_plain(s_p, *walk, **cat4)
    e4 = exact_err(torch, [(s_k, s_p)], "B4 categorical")
    s = score0.clone()
    out["predict"] = {
        "max_abs_err": e4,
        "ms": median_ms(torch, lambda: add_tree_score(s, *walk, **cat4)),
        "plain_ms": median_ms(torch, lambda: add_tree_score_plain(
            s, *walk, **cat4)),
        "bound": bound_ms(nv * f + 8 * nv, 7 * nv), "na_rows": na_rows}

    # B3s-K and B3-K at every super-step of a whole 255-leaf categorical
    # tree (K = 16), then B1-K at 255 bins on a super-step with every slot
    # valid, B3-K and B3s-K timed on it
    snaps = {}
    bcase = check_batched_tree(torch, binned, vals, fmask, num_bin, na_bin,
                               B, WIDE_LEAVES, WIDE_K, params, -1,
                               "categorical", snaps, is_cat=is_cat)
    wsb = snaps["ws"]
    btree = gr.fetch_tree(wsb)
    bn = btree.num_leaves - 1
    b_cat_nodes = int(btree.is_cat_node[:bn].sum())
    if btree.num_leaves != WIDE_LEAVES or b_cat_nodes == 0:
        raise AssertionError(f"categorical batched tree: {bcase}, "
                             f"{b_cat_nodes} categorical nodes")
    sb = snaps["state"]
    tslot, used = sb["tslot"], sb["used"]
    a = compute_histogram(binned, vals_exact, num_bins=B, slot=tslot,
                          num_slots=WIDE_K, slots_used=used)
    b = histogram_slots_plain(binned, vals_exact, tslot, num_slots=WIDE_K,
                              num_bins=B)
    if not torch.equal(a, b):
        raise AssertionError(f"B1-K (255 bins, exact sums) differs from its "
                             f"plain version: {float((a - b).abs().max())}")
    e1k = float((compute_histogram(
        binned, vals, num_bins=B, slot=tslot, num_slots=WIDE_K,
        slots_used=used) - histogram_slots_plain(
            binned, vals, tslot, num_slots=WIDE_K, num_bins=B)).abs().max())
    in_slots = int((tslot >= 0).sum())
    out["histogram_slots"] = {
        "max_abs_err": 0.0, "max_abs_err_inexact": e1k,
        "ms": median_ms(torch, lambda: compute_histogram(
            binned, vals, num_bins=B, slot=tslot, num_slots=WIDE_K,
            slots_used=used)),
        "plain_ms": median_ms(torch, lambda: histogram_slots_plain(
            binned, vals, tslot, num_slots=WIDE_K, num_bins=B)),
        "bound": bound_ms(n * f + 16 * n + WIDE_K * f * B * 12,
                          3 * in_slots * f)}
    lork, lorp = sb["lor"].clone(), sb["lor"].clone()
    rank_t = wsb.leaf_rank.clone()
    stp = sb["step"]
    out["partition_slots"] = {
        "ms": median_ms(torch, lambda: gr.partition_slots(
            binned, lork.copy_(sb["lor"]), stp, rank_t)),
        "plain_ms": median_ms(torch, lambda: gr.partition_slots_plain(
            binned, lorp.copy_(sb["lor"]), stp, rank_t)),
        "bound": bound_ms(n * f + 12 * n, 3 * n)}
    out["partition_slots"]["max_abs_err"] = exact_err(torch, [
        (gr.partition_slots(binned, lork.copy_(sb["lor"]), stp, rank_t),
         gr.partition_slots_plain(binned, lorp.copy_(sb["lor"]), stp,
                                  rank_t)), (lork, lorp)],
        "B3-K categorical (timed call)")
    bcat, brank = wsb.leaf_cat.clone(), wsb.leaf_rank.clone()

    def b3sk_call(fn):
        sb["tree"] = sb.get("tree", sb["tree0"].clone())
        sb["tree"].copy_(sb["tree0"])
        fn(sb["table"], sb["tree"], na_bin, num_leaves=WIDE_LEAVES,
           split_batch=WIDE_K, max_depth=-1, step=sb["step"],
           leaf_cat=bcat, leaf_rank=brank)
    t_k = median_ms(torch, lambda: b3sk_call(gr.grow_step_batched))
    got = [t.clone() for t in (sb["tree"], *sb["step"])]
    t_p = median_ms(torch, lambda: b3sk_call(gr.grow_step_batched_plain))
    words_b = sb["tree0"].numel()
    out["grow_step_batched"] = {
        "ms": t_k, "plain_ms": t_p,
        "max_abs_err": exact_err(torch, zip(got, (sb["tree"], *sb["step"])),
                                 "B3s-K categorical (timed call)"),
        "bound": bound_ms(WIDE_LEAVES * 4 + WIDE_K * sp.RECORD * 4
                          + 2 * words_b * 4 + WIDE_K * (B + 1) * 4
                          + WIDE_K * 8 * 4 + 4 * WIDE_LEAVES,
                          WIDE_LEAVES * WIDE_LEAVES),
        "tree_words": words_b}
    for v in out.values():
        bms_, by_ = v.pop("bound")
        v["bound_ms"], v["bound_by"] = bms_, by_
    emit({"phase": "cat_kernels", "kernels": out,
          "strict_tree": {"steps": steps, "active": active,
                          "categorical_nodes": n_cat_nodes},
          "batched_tree": {**bcase, "categorical_nodes": b_cat_nodes}})
    return {"split_cat": row}


def cat_after(torch, lgt, lgt_kernels, xv, prefix):
    """cat_train's and cat_strict_train's own checks of the super-epoch
    model: categorical nodes in every tree, the fetch bytes an epoch, the
    model text round trip and ``fused_predict`` held as fused_serve holds
    it."""
    def after(bst, prog):
        m = bst._model
        cat_nodes = [int(sum(int(d) & 1 for d in t.decision_type))
                     for t in m.models]
        if min(cat_nodes) == 0:
            raise AssertionError(f"{prefix}: a tree without a categorical "
                                 f"node: {cat_nodes}")
        k = max(2, min(25, ES_ROUNDS))
        text = bst.model_to_string()
        again = lgt.Booster(model_str=text)
        if not np.array_equal(again.predict(xv), bst.predict(xv)):
            raise AssertionError(f"{prefix}: model text -> Booster predicts "
                                 "otherwise")
        launches = phase_fused_serve(torch, lgt, lgt_kernels, bst, xv,
                                     name=f"{prefix}_fused_serve")
        return {"categorical_nodes_per_tree": statistics.mean(cat_nodes),
                "categorical_nodes_min": min(cat_nodes),
                "tree_words": prog.W, "fetch_bytes_per_epoch":
                    int(prog.out[:k].numel()) * 4,
                "round_trip_equal": True,
                "fused_serve_launches": launches}
    return after


def cat_cons_after(torch, lgt, lgt_kernels, train, xv):
    """cat_cons_train's checks: cat_after's, the model's controls on
    (so B2-cat took its control operands at every launch of the run) and
    no monotone violation over CONS_SWEEP_ROWS swept valid rows."""
    cat = cat_after(torch, lgt, lgt_kernels, xv, "cat_cons")

    def after(bst, prog):
        out = cat(bst, prog)
        c = bst._model.constraints
        if c is None or c.mono is None or c.mono_factor is None \
                or c.contri is None or c.cegb_coupled is None:
            raise AssertionError(f"cat_cons: the controls are off: {c}")
        mono = _sweep_violations(bst, train, xv, CONS_SWEEP_ROWS,
                                 CAT_CONS_MONO)
        if any(mono.values()):
            raise AssertionError(f"cat_cons: monotone violations {mono}")
        return {**out, "monotone_violations": mono,
                "features_used": sorted(_features_used(bst))}
    return after


# ---------------------------------------------------------------------------
# EFB (bundled one-hot blocks: B9, the bundle decode of B3/B3-K and B4)
# ---------------------------------------------------------------------------

def make_flight_like(n: int, seed: int):
    """A Flight-Delay-shaped set (the EFB experiment of Ke et al. 2017: the
    airline on-time data, one-hot encoded): Month, DayofMonth, DayOfWeek,
    UniqueCarrier, Origin and Dest drawn as ``make_expo_like`` draws them
    (``EFB_CARDS`` categories, ``CAT_ZIPF`` skew) and one-hot encoded,
    then DepTime (hhmm-like integers) and Distance; a binary "delayed"
    label from seeded per-category effects (the same for every seed),
    about 20% positive.  Returns (x f32 [n, EFB_COLS], y f32 [n])."""
    rng = np.random.RandomState(seed)
    eff = np.random.RandomState(1234)
    x = np.zeros((n, EFB_COLS), np.float32)
    logit = np.zeros(n)
    rows = np.arange(n)
    off = 0
    for c, z, e in zip(EFB_CARDS, CAT_ZIPF, CAT_EFFECT):
        p = 1.0 / np.arange(1, c + 1) ** z
        col = rng.choice(c, size=n, p=p / p.sum())
        x[rows, off + col] = 1.0
        logit += e * eff.randn(c)[col]
        off += c
    dep = rng.randint(0, 2400, n)
    dist = rng.gamma(2.0, 400.0, n)
    logit += 0.8 * (dep > 1700) + 0.3 * np.log(dist / 800.0)
    logit += 0.5 * rng.randn(n)
    x[:, off], x[:, off + 1] = dep, dist
    return x, (logit > 1.4).astype(np.float32)


def phase_efb_data(lgt):
    """The Flight-Delay-shaped set, binned at 255 bins at the default
    ``enable_bundle`` (the six one-hot blocks bundle into six groups, the
    two numerical columns stay singletons: G = EFB_GROUPS, uint8), its
    valid set built with ``reference=``, and the same rows unbundled
    (``enable_bundle=false``, [N, F]) for the comparison run; the bundled
    matrix unbundles to the unbundled one."""
    t0 = time.perf_counter()
    x, y = make_flight_like(EFB_TRAIN, seed=40)
    xv, yv = make_flight_like(EFB_VALID, seed=41)
    t_make = time.perf_counter() - t0
    params = {"max_bin": EFB_MAX_BIN, "verbosity": -1}
    t1 = time.perf_counter()
    train = lgt.Dataset(x, y, params=params).construct()
    valid = lgt.Dataset(xv, yv, reference=train, params=params).construct()
    t_build = time.perf_counter() - t1
    efb = train.efb
    nf = train.num_features
    if efb is None or efb.num_groups != EFB_GROUPS \
            or train.binned.shape != (EFB_TRAIN, EFB_GROUPS) \
            or train.binned.dtype != np.uint8 or valid.efb is not efb \
            or nf < EFB_COLS - 10:
        raise AssertionError(
            f"unexpected bundles: binned {train.binned.shape} "
            f"{train.binned.dtype}, {nf} features, groups "
            f"{None if efb is None else efb.num_groups}")
    flat = {**params, "enable_bundle": False}
    t2 = time.perf_counter()
    train_u = lgt.Dataset(x, y, params=flat).construct()
    valid_u = lgt.Dataset(xv, yv, reference=train_u, params=flat).construct()
    t_build_u = time.perf_counter() - t2
    if train_u.efb is not None or train_u.binned.shape != (EFB_TRAIN, nf) \
            or not np.array_equal(train.feature_binned(), train_u.binned) \
            or not np.array_equal(valid.feature_binned(), valid_u.binned):
        raise AssertionError("the bundled matrix does not unbundle to the "
                             "unbundled one")
    sizes = sorted(len(g) for g in efb.groups)
    emit({"phase": "efb_data", "seconds": time.perf_counter() - t0,
          "make_seconds": t_make, "dataset_build_seconds": t_build,
          "unbundled_build_seconds": t_build_u,
          "train": [EFB_TRAIN, nf], "valid": [EFB_VALID, nf],
          "groups": efb.num_groups, "group_sizes": sizes,
          "max_group_bin": efb.max_group_bin,
          "group_bins": efb.group_num_bin.tolist(),
          "grouped_dtype": str(train.binned.dtype),
          "max_bin": int(train.max_bin), "positive_share": float(y.mean()),
          "reduced": ["rows: 500,000 train and 100,000 valid, cut from the "
                      "paper's 10M", "Origin and Dest capped at 255 "
                      "airports each, so that every bundle keeps to 256 "
                      "bins (uint8) until ROADMAP A9.5"]})
    return xv, train, valid, train_u, valid_u, x, y


def phase_efb_kernels(torch, lgt, train, valid):
    """B9 bit for bit against its plain version at the cell's shapes, on
    C = 1, 2 and 2K = 32 children's real group histograms (B1-K over
    random row slots, each child's totals its rows' sums), an inactive
    step (output untouched) and singleton-only maps; B3 and B3-K with the
    decode maps against their plain versions on CPU copies (bundled
    one-hot features, a numerical singleton with an NA bin, a singleton
    split through a permuted rank row as a categorical split is); B4 with
    the maps on the grouped valid matrix (numerical and categorical
    nodes, one column and the column form) against its plain version on
    CPU copies; B11b through a bundled feature's group column and offset
    (``check_b11b_efb``); each timed."""
    from lightgbm_torch.efb import (EFBInfo, expand_group_hist,
                                    expand_group_hist_plain,
                                    make_device_efb)
    from lightgbm_torch.grower import (BatchedStep, partition,
                                       partition_plain, partition_slots,
                                       partition_slots_plain)
    from lightgbm_torch.ops.histogram import compute_histogram
    from lightgbm_torch.predict_device import (add_tree_score,
                                               add_tree_score_plain)
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    nb = np.asarray([train.bin_mappers[i].num_bin
                     for i in train.used_features], np.int32)
    F, B = len(nb), int(nb.max())
    efb, efb_c = (make_device_efb(train.efb, nb, B, d) for d in (dev, cpu))
    binned = torch.as_tensor(train.binned).to(dev)
    n, G = binned.shape
    Bg = efb.group_bins
    y = torch.as_tensor(np.asarray(train.metadata.label,
                                   np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(40)
    pr = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
    vals = torch.stack([pr - y, pr * (1 - pr), torch.ones_like(y)], 1)
    one = torch.ones(1, dtype=torch.int32, device=dev)

    # B9
    err9 = 0.0
    cases = {}
    for C in (1, 2, 2 * WIDE_K):
        slot = torch.randint(0, C, (n,), dtype=torch.int32, device=dev,
                             generator=gen)
        gh = compute_histogram(binned, vals, num_bins=Bg, slot=slot,
                               num_slots=C, active=one,
                               slots_used=torch.tensor(
                                   [C], dtype=torch.int32, device=dev))
        tot = torch.zeros((C, 3), device=dev).index_add_(0, slot.long(),
                                                          vals)
        out_k = expand_group_hist(gh, tot, efb)
        out_p = expand_group_hist_plain(gh, tot, efb)
        err9 = max(err9, exact_err(torch, [
            (out_k, out_p),
            (out_k.cpu(), expand_group_hist_plain(gh.cpu(), tot.cpu(),
                                                  efb_c))],
            f"B9 at C = {C}"))
        cases[C] = (gh, tot)
    gh, tot = cases[2]
    out = torch.full((2, F, B, 3), 7.0, device=dev)
    keep = out.clone()
    expand_group_hist(gh, tot, efb, active=torch.zeros(
        1, dtype=torch.int32, device=dev), out=out)
    torch.cuda.synchronize()
    if not torch.equal(out, keep):
        raise AssertionError("B9 wrote on an inactive step")
    single = EFBInfo(groups=[[j] for j in range(F)],
                     group_of_feat=np.arange(F, dtype=np.int32),
                     off_of_feat=np.full(F, -1, np.int32),
                     group_num_bin=nb.copy())
    sdev = make_device_efb(single, nb, B, dev)
    inside = (torch.arange(B, device=dev)[None, :]
              < torch.as_tensor(nb).to(dev)[:, None])[None, :, :, None]
    hs = torch.where(inside, torch.randn((2, F, B, 3), device=dev,
                                         generator=gen), 0.0)
    err9 = max(err9, exact_err(torch, [
        (expand_group_hist(hs, tot, sdev), hs),
        (expand_group_hist_plain(hs, tot, sdev), hs)], "B9 singletons"))
    t_k = {C: median_ms(torch, lambda: expand_group_hist(*cases[C], efb))
           for C in cases}
    t_p = median_ms(torch, lambda: expand_group_hist_plain(gh, tot, efb))
    gof = efb.group_of_feat.long()
    idx = efb.col_idx.clamp_min(0).long()[None, :, :, None].expand(
        2, F, B, 3)

    def library():
        return torch.gather(gh.index_select(1, gof), 2, idx)[:, :, 1:] \
            .sum(dim=2)
    t_l = median_ms(torch, library)

    def b9_bound(C):
        nbytes = C * G * Bg * 12 + F * B * 4 + 5 * F + C * 12 \
            + C * F * B * 12
        return bound_ms(nbytes, C * 3 * int((efb_c.fix0).sum()) * B)
    bd = b9_bound(2)
    rows = {"expand_group_hist": {
        "name": "B9 EFB group -> feature histogram expansion",
        "route": "cuda", "source": "lightgbm_torch/csrc/efb.cu",
        "replaces": "lightgbm_tpu/efb.py:257", "max_abs_err": err9,
        "ms": t_k[2], "plain_ms": t_p, "bound_ms": bd[0],
        "bound_by": bd[1], "library_ms": t_l}}
    emit({"phase": "kernel", **rows["expand_group_hist"],
          "children": 2, "groups": G, "group_bins": Bg, "features": F,
          "bins": B, "ms_by_children": t_k,
          "bound_ms_by_children": {C: b9_bound(C)[0] for C in cases},
          "library_call": "index_select + gather + sum (no mask, no "
                          "bin-0 fix)"})

    # B3 and B3-K with the decode maps, against the plain versions on CPU
    # copies
    off = np.asarray(train.efb.off_of_feat)
    bundled = np.nonzero(off >= 0)[0]
    singles = np.nonzero(off < 0)[0]
    perm = torch.as_tensor(np.random.RandomState(41).permutation(B).astype(
        np.int32))
    rank = torch.arange(B, dtype=torch.int32).repeat(40, 1)
    rank[5] = perm                            # leaf 5's split: by rank row
    bcpu = torch.as_tensor(train.binned)
    lor_mid = torch.randint(0, 17, (n,), dtype=torch.int32, device=dev,
                            generator=gen)
    splits = [(int(bundled[0]), 0, -1, 3), (int(bundled[len(bundled) // 2]),
                                            0, -1, 5),
              (int(bundled[-1]), 0, -1, 7),
              (int(singles[0]), int(nb[singles[0]]) // 2,
               int(nb[singles[0]]) - 1, 9),
              (int(singles[-1]), int(nb[singles[-1]]) // 3, -1, 5)]
    pairs = []
    moved = 0
    for feat, thr, na, leaf in splits:
        rec = torch.tensor([leaf, 17, feat, thr, 1, na, 17, 1],
                           dtype=torch.int32)
        lk, lp = lor_mid.clone(), lor_mid.cpu().clone()
        sk = partition(binned, lk, rec.to(dev), rank.to(dev), efb)
        sp_ = partition_plain(bcpu, lp, rec, rank, efb_c)
        pairs += [(lk.cpu(), lp), (sk.cpu(), sp_)]
        moved += int((lp == 17).sum())
    if moved == 0:
        raise AssertionError("B3 with maps moved no row")
    K = WIDE_K
    feats = np.concatenate([bundled[:: max(1, len(bundled) // (K - 2))]
                            [:K - 2], singles])[:K]
    recs = torch.tensor([[k, 17 + k, int(feats[k]),
                          int(nb[feats[k]]) // 2 if off[feats[k]] < 0 else 0,
                          k % 2, -1, k, 1] for k in range(K)],
                        dtype=torch.int32)
    slot_of_leaf = torch.full((40,), -1, dtype=torch.int32)
    slot_of_leaf[:K] = torch.arange(K, dtype=torch.int32)
    z = torch.zeros
    step = BatchedStep(recs=recs, slot_of_leaf=slot_of_leaf,
                       idx2=z(2 * K, dtype=torch.int64), tot2=z((2 * K, 3)),
                       po2=z(2 * K), small_left=z(K, dtype=torch.bool),
                       keep2=z(2 * K, dtype=torch.bool),
                       status=torch.tensor([1, K], dtype=torch.int32))
    step_d = BatchedStep(*(t.to(dev) for t in step))
    lk, lp = lor_mid.clone(), lor_mid.cpu().clone()
    tk = partition_slots(binned, lk, step_d, rank.to(dev), efb)
    tp = partition_slots_plain(bcpu, lp, step, rank, efb_c)
    pairs += [(lk.cpu(), lp), (tk.cpu(), tp)]
    err3 = exact_err(torch, pairs, "B3/B3-K with EFB maps")
    lor = torch.zeros(n, dtype=torch.int32, device=dev)
    rec0 = torch.tensor([0, 1, int(bundled[0]), 0, 1, -1, 1, 1],
                        dtype=torch.int32, device=dev)
    iota = torch.arange(B, dtype=torch.int32, device=dev)
    t3k = median_ms(torch, lambda: partition(binned, lor.fill_(0), rec0,
                                             iota, efb))
    lor_p = lor.clone()
    t3p = median_ms(torch, lambda: partition_plain(binned, lor_p.fill_(0),
                                                   rec0, iota, efb))
    b3 = bound_ms(n * G + 12 * n, 2 * n)
    emit({"phase": "kernel", "name": "B3 row partition, EFB decode",
          "route": "cuda", "source": "lightgbm_torch/csrc/partition.cu",
          "replaces": "lightgbm_tpu/grower.py:778", "max_abs_err": err3,
          "ms": t3k, "plain_ms": t3p, "bound_ms": b3[0], "bound_by": b3[1],
          "library_ms": None, "columns": G, "rows_moved": moved,
          "batched_checked": K})

    # B4 with the maps on the grouped valid matrix
    vb = torch.as_tensor(valid.binned).to(dev)
    vcpu = torch.as_tensor(valid.binned)
    nv = vb.shape[0]
    rng = np.random.RandomState(42)
    nodes = 2 ** 6 - 1
    sf = np.where(rng.rand(nodes) < 0.8, rng.choice(bundled, nodes),
                  rng.choice(singles, nodes)).astype(np.int32)
    th = np.asarray([0 if off[j] >= 0 else rng.randint(0, int(nb[j]) - 1)
                     for j in sf], np.int32)
    ix = np.arange(nodes)
    lc = np.where(2 * ix + 1 < nodes, 2 * ix + 1, 0).astype(np.int32)
    rc = np.where(2 * ix + 2 < nodes, 2 * ix + 2, 0).astype(np.int32)
    first = nodes // 2
    for node in range(first, nodes):
        lc[node] = ~(2 * (node - first))
        rc[node] = ~(2 * (node - first) + 1)
    na_np = np.full(F, -1, np.int32)
    na_np[singles] = nb[singles] - 1
    tree_c = [torch.as_tensor(a) for a in (
        sf, th, (rng.rand(nodes) < 0.5).astype(np.int32), lc, rc)]
    cat_c = {"is_cat_node": torch.as_tensor(
                 (np.isin(sf, singles) & (ix % 2 == 0)).astype(np.int32)),
             "cat_rank": torch.as_tensor(np.stack(
                 [rng.permutation(B) for _ in range(nodes)]).astype(
                     np.int32))}
    lv_c = torch.as_tensor(rng.randn(nodes + 1).astype(np.float32))
    na_c = torch.as_tensor(na_np)
    tree_d = [t.to(dev) for t in tree_c]
    cat_d = {k: v.to(dev) for k, v in cat_c.items()}
    lv_d, na_d = lv_c.to(dev), na_c.to(dev)
    s0 = torch.randn(nv, 3, generator=torch.Generator().manual_seed(43))
    pairs = []
    for w, cat, col in ((1.0, False, 0), (-0.1, True, 2)):
        kw_d = {**(cat_d if cat else {}), "efb_maps": efb.maps}
        kw_c = {**(cat_c if cat else {}), "efb_maps": efb_c.maps}
        for sc in (s0[:, 0].contiguous(), s0):
            extra = {} if sc.dim() == 1 else {"column": col}
            sk, sp_ = sc.clone().to(dev), sc.clone()
            add_tree_score(sk, vb, *tree_d, na_d, lv_d, w, steps=8,
                           **kw_d, **extra)
            add_tree_score_plain(sp_, vcpu, *tree_c, na_c, lv_c, w,
                                 steps=8, **kw_c, **extra)
            pairs.append((sk.cpu(), sp_))
    err4 = exact_err(torch, pairs, "B4 with EFB maps")
    s1 = s0[:, 0].contiguous().to(dev)
    t4k = median_ms(torch, lambda: add_tree_score(
        s1, vb, *tree_d, na_d, lv_d, 1.0, steps=8, efb_maps=efb.maps))
    t4p = median_ms(torch, lambda: add_tree_score_plain(
        s1, vb, *tree_d, na_d, lv_d, 1.0, steps=8, efb_maps=efb.maps))
    b4 = bound_ms(nv * G + 8 * nv, 7 * nv)
    emit({"phase": "kernel", "name": "B4 tree score update, EFB decode",
          "route": "cuda", "source": "lightgbm_torch/csrc/predict.cu",
          "replaces": "lightgbm_tpu/predict_device.py:49", "max_abs_err":
              err4, "ms": t4k, "plain_ms": t4p, "bound_ms": b4[0],
          "bound_by": b4[1], "library_ms": None, "rows": nv,
          "columns": G})
    # B11b (the partitioned learner's partition) through a bundle column
    check_b11b_efb(torch, train)
    return rows


def _exact_l2(preds, ds):
    """A custom objective whose every histogram sum is exact in f32: L2
    gradients rounded to 1/8, hessians 1."""
    g = np.round(8.0 * (np.asarray(preds, np.float64) - ds.get_label())) / 8
    return g.astype(np.float32), np.ones(len(g), np.float32)


def _tree0_leaf_err(bst, x, y) -> float:
    """Largest relative error of the first tree's shrunk leaf values
    against the f64 sums of its own rows' first gradients (binary, all
    rows at the BoostFromAverage bias, learning rate 0.1)."""
    lbl = y.astype(np.float64)
    bias = np.log(lbl.mean() / (1 - lbl.mean()))
    p0 = 1 / (1 + np.exp(-bias))
    leaves = bst.predict(x, pred_leaf=True, num_iteration=1)[:, 0]
    t = bst._model.models[0]
    nl = t.num_leaves
    g = np.bincount(leaves, weights=p0 - lbl, minlength=nl)
    h = np.bincount(leaves, minlength=nl) * p0 * (1 - p0)
    exact = -0.1 * g / h
    got = np.asarray(t.leaf_value, np.float64)[:nl] - bias
    return float(np.max(np.abs(got - exact) / np.abs(exact)))


def phase_efb_train(torch, lgt, lgt_kernels, train, valid, xv, train_u,
                    valid_u, x, y):
    """efb_train: the main path's configuration (binary, 31 leaves, 255
    bins) on the bundled set as ``phase_sampled_train`` runs a cell
    (super-epochs held to EFB_PER_ITERATION, the per-iteration path and
    fused chunks with the same trees, a profiled byte-identical rerun,
    engine predict), then against the unbundled twin: on exact gradients
    (``_exact_l2``, the per-iteration path) the two write the same trees
    bit for bit, and on the binary run the first trees' leaf values sit
    within EFB_LEAF_RTOL (bundled) and EFB_UNBUNDLED_LEAF_RTOL of the f64
    sums of their rows and the two first trees are equal in structure; the unbundled binary run's predictions
    (their gap after the run beside the JAX test's bound, rtol 1e-5 and
    atol 1e-6), steady it/s and first-tree error, and B1's ms a launch (the
    root pass, all rows) on both matrices, are reported beside the bundled
    run's.  efb_wide_train: 255 leaves
    (K = 16) with bagging for EFB_WIDE_ROUNDS rounds, held to
    EFB_WIDE_PER_ITERATION.  Returns the launches by path."""
    from lightgbm_torch.ops.histogram import compute_histogram
    k = max(2, min(25, ES_ROUNDS))

    def after(bst, prog):
        m = bst._model
        if m.efb_dev is None or m.binned_dev.shape[1] >= m.num_features:
            raise AssertionError("efb_train did not train on the bundled "
                                 "matrix")
        exact = {}
        for tag, (a, b) in (("bundled", (train, valid)),
                            ("unbundled", (train_u, valid_u))):
            be = lgt.train({"objective": "none", "num_leaves": NUM_LEAVES,
                            "max_bin": EFB_MAX_BIN, "learning_rate": 0.5,
                            "metric": "l2", "verbosity": -1}, a,
                           EFB_EXACT_ROUNDS, valid_sets=[b], fobj=_exact_l2)
            if (be._model.efb_dev is None) != (tag == "unbundled"):
                raise AssertionError(f"the exact {tag} run's matrix")
            exact[tag] = be
        te = {tag: tree_sections(be.model_to_string(), EFB_EXACT_ROUNDS)
              for tag, be in exact.items()}
        if te["bundled"] != te["unbundled"] or not np.array_equal(
                exact["bundled"].predict(xv), exact["unbundled"].predict(xv)):
            raise AssertionError("on exact gradients the bundled and "
                                 "unbundled runs wrote other trees")
        bu, _, secs_u = train_main(lgt, train_u, valid_u, extra=EFB_PARAMS,
                                   rounds=CUT_ROUNDS)
        mu = bu._model
        if mu.efb_dev is not None:
            raise AssertionError("the unbundled run bundled")
        err_b, err_u = _tree0_leaf_err(bst, x, y), _tree0_leaf_err(bu, x, y)
        for tag, err, tol in (("bundled", err_b, EFB_LEAF_RTOL),
                              ("unbundled", err_u, EFB_UNBUNDLED_LEAF_RTOL)):
            if not err <= tol:
                raise AssertionError(f"the {tag} first tree's leaf values "
                                     f"sit {err} from the f64 sums of "
                                     "their rows")
        pb, pu = bst.predict(xv), bu.predict(xv)
        fields = ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count")
        first = next((i for i, (a, b) in enumerate(zip(m.models, mu.models))
                      if not all(np.array_equal(getattr(a, f_),
                                                getattr(b, f_))
                                 for f_ in fields)), None)
        if first == 0:
            raise AssertionError("the bundled and unbundled first trees "
                                 "differ in structure")
        dev = m.device
        vals = torch.rand((m.num_data, 3), device=dev)
        bins = {}
        for tag, mm in (("bundled", m), ("unbundled", mu)):
            hb = mm.grow_ws.hist_bins
            bins[tag] = median_ms(torch, lambda: compute_histogram(
                mm.binned_dev, vals, num_bins=hb))
        st_u = mu.epoch_ms[1:] if len(mu.epoch_ms) > 1 else mu.epoch_ms
        return {"groups": int(m.binned_dev.shape[1]),
                "features": m.num_features,
                "exact_gradients_same_trees": True,
                "exact_rounds": EFB_EXACT_ROUNDS,
                "tree0_leaf_rel_err": err_b,
                "tree0_root_gain": float(m.models[0].split_gain[0]),
                "unbundled": {
                    "seconds": secs_u,
                    "steady_iterations_per_s":
                        1e3 * k / statistics.median(st_u),
                    "ms_per_iteration": statistics.median(st_u) / k,
                    "tree0_leaf_rel_err": err_u,
                    "tree0_root_gain": float(mu.models[0].split_gain[0]),
                    "first_tree_parting": first,
                    "predictions_max_abs_diff": float(
                        np.max(np.abs(pb - pu))),
                    "predictions_within_rtol_1e-5": bool(np.allclose(
                        pb, pu, rtol=1e-5, atol=1e-6))},
                "b1_root_pass_ms": bins}
    counts = phase_sampled_train(torch, lgt, lgt_kernels, train, valid, xv,
                                 "efb", EFB_PARAMS, EFB_PER_ITERATION,
                                 after=after, rounds=CUT_ROUNDS)[0]
    counts.update(phase_sampled_train(
        torch, lgt, lgt_kernels, train, valid, xv, "efb_wide",
        EFB_WIDE_PARAMS, EFB_WIDE_PER_ITERATION,
        rounds=EFB_WIDE_ROUNDS)[0])
    return counts


# ---------------------------------------------------------------------------
# sparse binned storage (B8a, the k-hot decode in B3/B3-K and B4)
# ---------------------------------------------------------------------------

def make_allstate_like(n: int, seed: int):
    """An Allstate-shaped wide sparse set, drawn as the JAX package's own
    width test draws it (tests/test_sparse_bin.py:204-232): SPARSE_NNZ
    stored values a row at distinct random columns of SPARSE_COLS, on two
    non-zero levels (1 and 2), so that no two columns are exclusive and
    no bundle can form; a binary label drawn through a logistic of a
    sparse weight vector (a tenth of the columns, the same for every
    seed).  Returns (CSR f64 [n, SPARSE_COLS], y f32 [n])."""
    import scipy.sparse as sps
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.integers(0, SPARSE_COLS, size=(n, SPARSE_NNZ)),
                   axis=1)
    while True:
        dup = np.zeros(cols.shape, bool)
        dup[:, 1:] = cols[:, 1:] == cols[:, :-1]
        if not dup.any():
            break
        cols[dup] = rng.integers(0, SPARSE_COLS, size=int(dup.sum()))
        cols.sort(axis=1)
    vals = rng.integers(1, 3, size=(n, SPARSE_NNZ)).astype(np.float64)
    x = sps.csr_matrix((vals.ravel(), cols.ravel().astype(np.int32),
                        np.arange(0, n * SPARSE_NNZ + 1, SPARSE_NNZ)),
                       shape=(n, SPARSE_COLS))
    wr = np.random.default_rng(1234)
    w = wr.normal(size=SPARSE_COLS) * (wr.random(SPARSE_COLS) < 0.1)
    logit = x @ w - 0.5
    y = rng.random(n) < 1.0 / (1.0 + np.exp(-logit))
    return x, y.astype(np.float32)


def phase_sparse_data(lgt):
    """The Allstate-shaped set (SPARSE_TRAIN train rows, SPARSE_VALID
    valid rows from another seed), binned by ``lightgbm_torch.Dataset``
    with SPARSE_DATA_PARAMS: both sets take the k-hot layout (K entries
    a row, int32), which is printed beside the dense [N, F] uint8
    alternative's bytes and the construction seconds."""
    t0 = time.perf_counter()
    x, y = make_allstate_like(SPARSE_TRAIN, seed=50)
    xv, yv = make_allstate_like(SPARSE_VALID, seed=51)
    t_make = time.perf_counter() - t0
    t1 = time.perf_counter()
    train = lgt.Dataset(x, y, params=SPARSE_DATA_PARAMS).construct()
    t_train = time.perf_counter() - t1
    t2 = time.perf_counter()
    valid = lgt.Dataset(xv, yv, reference=train,
                        params=SPARSE_DATA_PARAMS).construct()
    t_valid = time.perf_counter() - t2
    sp, spv = train.binned_sparse, valid.binned_sparse
    nf = train.num_features
    if sp is None or spv is None or train.binned is not None \
            or nf != SPARSE_COLS or sp.stride > 256 \
            or sp.flat.shape[0] != SPARSE_TRAIN:
        raise AssertionError(
            f"the sparse set did not take the k-hot layout: features {nf}, "
            f"binned {None if train.binned is None else train.binned.shape}"
            f", k-hot {None if sp is None else sp.flat.shape}")
    emit({"phase": "sparse_data", "seconds": time.perf_counter() - t0,
          "make_seconds": t_make, "dataset_build_seconds": t_train,
          "valid_build_seconds": t_valid,
          "train": [SPARSE_TRAIN, nf], "valid": [SPARSE_VALID, nf],
          "stored_per_row": SPARSE_NNZ, "k": sp.k, "valid_k": spv.k,
          "stride": sp.stride, "khot_bytes": sp.nbytes(),
          "dense_bytes": SPARSE_TRAIN * nf,
          "valid_khot_bytes": spv.nbytes(),
          "positive_share": float(y.mean()),
          "params": SPARSE_DATA_PARAMS,
          "reduced": ["rows: 1,000,000 train and 200,000 valid, cut from "
                      "Allstate's 13.2M"]})
    return train, valid, x, y, xv, yv


def _khot_library(torch, sp, vals, slot=None, num_slots=1):
    """The library yardstick of B8a: one f32 ``index_add_`` of the stored
    entries' vals into their (slot, feature, bin) cells, without the
    default-bin fill."""
    fl = sp.flat.to(torch.int64)
    ok = fl >= 0
    if slot is not None:
        ok &= ((slot >= 0) & (slot < num_slots))[:, None]
    rows, ks = torch.nonzero(ok, as_tuple=True)
    cell = fl[rows, ks]
    if slot is not None:
        cell = cell + slot.to(torch.int64)[rows] * (sp.num_features
                                                    * sp.stride)
    src = vals.index_select(0, rows)
    acc = torch.zeros((num_slots * sp.num_features * sp.stride, 3),
                      device=vals.device)
    return median_ms(torch, lambda: acc.zero_().index_add_(0, cell, src))


def _dead_khot_pass(torch, lgt_kernels, sp, vals, slot, num_slots, B):
    """B8a launched on an inactive step into a sentinel-filled output
    through the C entry: True when the output was not written."""
    dev = vals.device
    s = max(num_slots, 1)
    out = torch.full((s, sp.num_features, B, 3), -7.0, device=dev)
    ints = s * sp.num_features * sp.stride * 3 + s * 3
    ws = torch.empty(ints + -(-ints // 2) + 2, dtype=torch.int64,
                     device=dev)
    off = torch.zeros(1, dtype=torch.int32, device=dev)
    err = lgt_kernels.lib("sparse").lgbt_sparse_histogram(
        sp.flat.data_ptr(), sp.flat.shape[0], sp.k, vals.data_ptr(),
        slot.data_ptr(), num_slots, sp.num_features, sp.stride, B,
        sp.default_bin.data_ptr(), off.data_ptr(), ws.data_ptr(),
        out.data_ptr(), lgt_kernels.stream_ptr(dev))
    lgt_kernels.check(err, "B8a on an inactive step")
    torch.cuda.synchronize()
    return bool((out == -7.0).all())


def khot_pass_bound(n: int, k: int, f: int, B: int, kept: int, S: int = 1,
                    slotted: bool = True):
    """bound_ms of one B8a pass: every row's slot (4 B, none for the root
    pass) and, of the ``kept`` rows in the pass only, the k-hot entries
    (4 K) and vals (12) read once, the [S, F, B, 3] f32 output written; 3
    adds a stored entry of a kept row."""
    return bound_ms(4 * n * slotted + kept * (4 * k + 12) + S * f * B * 12,
                    3 * kept * k)


def _hist_rel(torch, h_k, h_p) -> float:
    return float((h_k.double() - h_p.double()).abs().max()
                 / max(float(h_p.double().abs().max()), 1e-30))


# non-finite channel values planted in five rows of a pass: a NaN, a +Inf,
# a -Inf, then a +Inf and a -Inf in one channel (NaN where they share a
# cell)
NONFINITE_PLANT = ((0, float("nan")), (1, float("inf")), (2, float("-inf")),
                   (0, float("inf")), (0, float("-inf")))


def check_nonfinite(torch, run, plain, vals, rows, what: str) -> int:
    """``run`` (the kernel) and ``plain`` (its plain version) on ``vals``
    with NONFINITE_PLANT in ``rows`` (five rows of the pass): the same
    non-finite cells (NaN where NaN, the same infinity), every other cell
    within HIST_RTOL of the largest finite one.  Returns the count of
    non-finite cells."""
    v = vals.clone()
    for (c, x), r in zip(NONFINITE_PLANT, rows):
        v[int(r), c] = x
    a, b = run(v).double(), plain(v).double()
    na, nb = ~torch.isfinite(a), ~torch.isfinite(b)
    same = torch.equal(na, nb) \
        and torch.equal(torch.isnan(a), torch.isnan(b)) \
        and torch.equal(a[na & ~torch.isnan(a)], b[nb & ~torch.isnan(b)])
    fin = ~nb
    err = float((a[fin] - b[fin]).abs().max()) \
        / max(float(b[fin].abs().max()), 1e-30)
    if not same or int(nb.sum()) == 0 or err > HIST_RTOL:
        raise AssertionError(f"{what} with NaN/Inf rows: non-finite cells "
                             f"equal to the plain version's {same} "
                             f"({int(nb.sum())} cells), other cells off by "
                             f"{err:.3g}")
    return int(nb.sum())


def _dead_slots_pass(torch, lgt_kernels, binned, vals, slot, used, B, K):
    """B1-K launched on an inactive step into a sentinel-filled output and
    workspace through the C entry: True when nothing was written (its
    three kernels exit at once)."""
    from lightgbm_torch.ops import histogram as th
    n, f = binned.shape
    dev = binned.device
    out = torch.full((K, f, B, 3), -7.0, device=dev)
    ws = torch.full((th._slot_ws_words(K, f, B),), -7, dtype=torch.int64,
                    device=dev)
    off = torch.zeros(1, dtype=torch.int32, device=dev)
    err = lgt_kernels.lib("histogram").lgbt_histogram_slots(
        binned.data_ptr(), vals.data_ptr(), slot.data_ptr(), n, f, B, K,
        *th.slots_launch_shape(n, f, B, K), th._SCALE_PARTS, off.data_ptr(),
        used.data_ptr(), ws.data_ptr(), out.data_ptr(),
        lgt_kernels.stream_ptr(dev))
    lgt_kernels.check(err, "B1-K on an inactive step")
    torch.cuda.synchronize()
    return bool((out == -7.0).all()) and bool((ws == -7).all())


def check_b1k_card(torch, lgt_kernels, binned, vals, slot, used, B, K,
                   what: str) -> dict:
    """B1-K's fixed-point checks beyond its plain version, on a real
    super-step's slots: bitwise equal at three row ranges (half, double
    and 4,096 rows against the automatic one); zero for every slot at or
    past a halved ``slots_used`` (the rows of those slots moved to -1);
    nothing written on a dead step; NaN / +-Inf rows giving exactly the
    plain version's non-finite cells.  Returns the report."""
    from lightgbm_torch.ops.histogram import (compute_histogram,
                                              histogram_slots_plain,
                                              slots_launch_shape)
    n, f = binned.shape

    def run(v=vals, r=0, s=slot, u=used):
        return compute_histogram(binned, v, num_bins=B, slot=s,
                                 num_slots=K, slots_used=u,
                                 rows_per_block=r)
    ref = run()
    auto = slots_launch_shape(n, f, B, K)[0]
    rpb = (auto // 2, 2 * auto, 4096)
    for r in rpb:
        if not same_bits(torch, run(r=r), ref):
            raise AssertionError(f"B1-K ({what}) at rows_per_block={r} "
                                 "differs from the automatic row range")
    half = max(1, int(used[0]) // 2)
    s2 = torch.where(slot >= half, -1, slot)
    h2 = run(s=s2, u=torch.tensor([half], dtype=torch.int32,
                                  device=binned.device))
    if not bool((h2[half:] == 0).all()) or _hist_rel(
            torch, h2, histogram_slots_plain(binned, vals, s2, num_slots=K,
                                             num_bins=B)) > HIST_RTOL:
        raise AssertionError(f"B1-K ({what}) with {half} slots in use: "
                             "slots past them not zero or off the plain "
                             "version")
    if not _dead_slots_pass(torch, lgt_kernels, binned, vals, slot, used, B,
                            K):
        raise AssertionError(f"B1-K ({what}) wrote on a dead step")
    rows = torch.nonzero((slot >= 0) & (slot < K)).flatten()[:5]
    nonfin = check_nonfinite(
        torch, lambda v: run(v=v),
        lambda v: histogram_slots_plain(binned, v, slot, num_slots=K,
                                        num_bins=B), vals, rows,
        f"B1-K ({what})")
    return {"rows_per_block_bitwise": [auto] + list(rpb),
            "zero_past_slots_used": half, "dead_step_clean": True,
            "nonfinite_cells": nonfin,
            "launch_shape": list(slots_launch_shape(n, f, B, K))}


def _walk_leaves(torch, sp, tree, na_bin, steps):
    """B4 (B8c on k-hot rows) walking ``tree`` with leaf values 0..L-1
    onto a zero score: each row's leaf id."""
    from lightgbm_torch.predict_device import add_tree_score
    n = sp.shape[0]
    lv = torch.arange(tree.leaf_value.shape[0], dtype=torch.float32,
                      device=sp.device)
    score = torch.zeros(n, device=sp.device)
    add_tree_score(score, sp, tree.split_feature, tree.threshold_bin,
                   tree.default_left, tree.left_child, tree.right_child,
                   na_bin, lv, 1.0, steps=steps,
                   is_cat_node=tree.is_cat_node, cat_rank=tree.cat_rank)
    return score.to(torch.int32)


def _grow_checked(torch, sp, vals, fmask, nb, na, B, L, K, params, case,
                  snap):
    """One whole tree on the k-hot rows, with B3 (K = 1) or B3-K held bit
    for bit to its plain version at every step, and B8a within HIST_RTOL
    of its plain version at every live pass (the root's included);
    ``snap`` keeps the first live slotted pass's inputs (for timing) and
    the worst histogram error.  Returns (workspace, steps, live passes)."""
    from lightgbm_torch import grower as gr
    from lightgbm_torch.sparse_data import histogram_plain
    n, f = sp.shape
    ws = gr.GrowWorkspace(n, f, B, L, sp.device, split_batch=K)
    hist_k, part_k, slots_k = (gr.compute_histogram, gr.partition,
                               gr.partition_slots)
    seen = {"steps": 0, "live": 0}

    def hist_both(binned, vals_, *, num_bins, slot=None, num_slots=None,
                  active=None, slots_used=None, rows_per_block=0):
        h = hist_k(binned, vals_, num_bins=num_bins, slot=slot,
                   num_slots=num_slots, active=active, slots_used=slots_used,
                   rows_per_block=rows_per_block)
        if active is not None and not bool(active[0]):
            return h
        hp = histogram_plain(binned, vals_, num_bins=num_bins, slot=slot,
                             num_slots=num_slots)
        err = _hist_rel(torch, h, hp)
        if not err <= HIST_RTOL:
            raise AssertionError(f"B8a ({case}, pass {seen['live']}) "
                                 f"{err} from its plain version")
        snap["hist_err"] = max(snap.get("hist_err", 0.0), err)
        seen["live"] += 1
        # the pass to time: a mid-tree strict step, or the first
        # super-step with the most valid slots
        if slot is not None and (
                "slot" not in snap and seen["live"] > L // 2
                if num_slots is None
                else int(slots_used[0]) > snap.get("most_used", 0)):
            snap.update(slot=slot.clone(), active=active.clone(),
                        used=None if slots_used is None
                        else slots_used.clone())
            if num_slots is not None:
                snap["most_used"] = int(slots_used[0])
        return h

    def part_both(binned, lor, rec, rank, efb=None):
        lor0, lor_p = lor.clone(), lor.clone()
        s_p = gr.partition_plain(binned, lor_p, rec, rank, efb)
        s_k = part_k(binned, lor, rec, rank, efb)
        if bool(rec[gr.ACTIVE]):
            check_partition(torch, lor, lor_p, s_k, s_p,
                            f"{case}, step {seen['steps']}")
            if "rec" not in snap:
                snap["rec"], snap["lor"] = rec.clone(), lor0
        seen["steps"] += 1
        return s_k

    def slots_both(binned, lor, step, rank, efb=None):
        lor0, lor_p = lor.clone(), lor.clone()
        t_p = gr.partition_slots_plain(binned, lor_p, step, rank, efb)
        t_k = slots_k(binned, lor, step, rank, efb)
        live = bool(step.status[0])
        if not torch.equal(lor, lor_p) or (live and not torch.equal(t_k,
                                                                     t_p)):
            raise AssertionError(f"B3-K ({case}, super-step "
                                 f"{seen['steps']}) differs from its plain "
                                 "version")
        if live and int(step.status[1]) > snap.get("step_used", 0):
            snap["step"] = gr.BatchedStep(*[t.clone() for t in step])
            snap["lor"], snap["step_used"] = lor0, int(step.status[1])
        seen["steps"] += 1
        return t_k

    gr.compute_histogram, gr.partition, gr.partition_slots = \
        hist_both, part_both, slots_both
    try:
        if K == 1:
            gr.grow_tree(sp, vals, fmask, nb, na, num_leaves=L, num_bins=B,
                         params=params, workspace=ws)
        else:
            gr.grow_tree_batched(sp, vals, fmask, nb, na, num_leaves=L,
                                 num_bins=B, params=params, split_batch=K,
                                 workspace=ws)
    finally:
        gr.compute_histogram, gr.partition, gr.partition_slots = \
            hist_k, part_k, slots_k
    return ws, seen["steps"], seen["live"]


def phase_sparse_kernels(torch, lgt, lgt_kernels, train, valid):
    """B8a against its plain version within HIST_RTOL in its three forms
    on real passes (every live pass of a 31-leaf strict tree, of a
    255-leaf tree at K = 16 and of a 64-leaf tree at K = 8), bitwise
    equal on a rerun, NaN / +-Inf rows giving exactly the plain version's
    non-finite cells (``check_nonfinite``), writing nothing on an
    inactive step and zeros
    with every row's slot at -1; B3 and B3-K's k-hot decode bit for bit
    to their plain versions at every step of those trees; B4's k-hot walk
    of each tree over the train rows equal to the grower's row -> leaf
    vector, and over the valid rows bit for bit to its plain version;
    each timed beside its bound and library call."""
    from lightgbm_torch import grower as gr
    from lightgbm_torch.ops.split import SplitParams
    from lightgbm_torch.predict_device import (add_tree_score,
                                               add_tree_score_plain)
    from lightgbm_torch.sparse_data import histogram, histogram_plain
    dev = torch.device("cuda", 0)
    sp = train.binned_sparse.to_device(dev)
    spv = valid.binned_sparse.to_device(dev)
    n, F = sp.shape
    K_e = sp.k
    nb_np = np.asarray([train.bin_mappers[i].num_bin
                        for i in train.used_features], np.int32)
    na_np = np.asarray([train.bin_mappers[i].na_bin
                        for i in train.used_features], np.int32)
    B = int(nb_np.max())
    nb, na = (torch.as_tensor(a).to(dev) for a in (nb_np, na_np))
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    y = torch.as_tensor(np.asarray(train.metadata.label,
                                   np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(50)
    pr = torch.sigmoid(0.3 * torch.randn(n, device=dev, generator=gen))
    vals = torch.stack([pr - y, pr * (1 - pr), torch.ones_like(y)], 1)
    params = SplitParams(min_data_in_leaf=20)
    trees, snaps = {}, {}
    for case, L, K in (("strict", NUM_LEAVES, 1),
                       ("wide", WIDE_LEAVES, WIDE_K), ("k8", 64, 8)):
        snap = {}
        ws, steps, live = _grow_checked(torch, sp, vals, fmask, nb, na, B,
                                        L, K, params, case, snap)
        tree = gr.fetch_tree(ws)
        if tree.num_leaves < L // 2:
            raise AssertionError(f"sparse {case} tree: {tree.num_leaves} "
                                 "leaves")
        steps_walk = 64 if K == 1 else 256
        arrays = ws.arrays()
        leaves = _walk_leaves(torch, sp, arrays, na, steps_walk)
        if not torch.equal(leaves, ws.leaf_of_row):
            raise AssertionError(f"B4 on k-hot rows ({case}) does not walk "
                                 "the train rows to the grower's leaves")
        trees[case] = (tree, ws, steps, live)
        snaps[case] = snap
    hist_err = max(s["hist_err"] for s in snaps.values())

    # B4 on the valid rows against its plain version, bit for bit
    arrays = trees["wide"][1].arrays()
    gen_c = torch.Generator(device=dev).manual_seed(51)
    lv = torch.randn(WIDE_LEAVES, device=dev, generator=gen_c)
    s0 = torch.randn(spv.shape[0], device=dev, generator=gen_c)
    pairs = []
    for w in (1.0, -0.1):
        sk, spp = s0.clone(), s0.clone()
        for fn, sc in ((add_tree_score, sk), (add_tree_score_plain, spp)):
            fn(sc, spv, arrays.split_feature, arrays.threshold_bin,
               arrays.default_left, arrays.left_child, arrays.right_child,
               na, lv, w, steps=256)
        pairs.append((sk, spp))
    err4 = exact_err(torch, pairs, "B4 on k-hot valid rows")
    t4k = median_ms(torch, lambda: add_tree_score(
        s0, spv, arrays.split_feature, arrays.threshold_bin,
        arrays.default_left, arrays.left_child, arrays.right_child, na, lv,
        1.0, steps=256))
    t4p = median_ms(torch, lambda: add_tree_score_plain(
        s0, spv, arrays.split_feature, arrays.threshold_bin,
        arrays.default_left, arrays.left_child, arrays.right_child, na, lv,
        1.0, steps=256), reps=5, warmup=1)
    nv = spv.shape[0]
    b4 = bound_ms(4 * nv * spv.k + 8 * nv, 0)

    # B8a's forms, reruns, an inactive step and empty slots
    one = torch.ones(1, dtype=torch.int32, device=dev)
    st = snaps["strict"]
    forms = {
        "root": dict(),
        "strict": dict(slot=st["slot"], active=st["active"]),
        "k16": dict(slot=snaps["wide"]["slot"], num_slots=WIDE_K,
                    active=one, slots_used=snaps["wide"]["used"]),
        "k8": dict(slot=snaps["k8"]["slot"], num_slots=8, active=one,
                   slots_used=snaps["k8"]["used"])}
    res = {}
    for form, kw in forms.items():
        h1 = histogram(sp, vals, num_bins=B, **kw)
        h2 = histogram(sp, vals, num_bins=B, **kw)
        kw_p = {k: v for k, v in kw.items() if k != "slots_used"}
        hp = histogram_plain(sp, vals, num_bins=B, **kw_p)
        err = _hist_rel(torch, h1, hp)
        if not same_bits(torch, h1, h2) or not err <= HIST_RTOL:
            raise AssertionError(f"B8a ({form}): rerun equal "
                                 f"{same_bits(torch, h1, h2)}, error {err}")
        slot = kw.get("slot")
        S = kw.get("num_slots", 1)
        kept = n if slot is None else int(((slot >= 0)
                                           & (slot < S)).sum())
        in_pass = torch.ones(n, dtype=torch.bool, device=dev) \
            if slot is None else (slot >= 0) & (slot < S)
        nonfin = check_nonfinite(
            torch, lambda v: histogram(sp, v, num_bins=B, **kw),
            lambda v: histogram_plain(sp, v, num_bins=B, **kw_p), vals,
            torch.nonzero(in_pass).flatten()[:5], f"B8a ({form})")
        res[form] = {
            "nonfinite_cells": nonfin,
            "ms": median_ms(torch, lambda: histogram(sp, vals, num_bins=B,
                                                     **kw)),
            "plain_ms": median_ms(torch, lambda: histogram_plain(
                sp, vals, num_bins=B, **kw_p), reps=5, warmup=1),
            "library_ms": _khot_library(torch, sp, vals, slot, S),
            "bound": khot_pass_bound(n, K_e, F, B, kept, S,
                                     slot is not None),
            "rows_in_pass": kept, "max_rel_err": err,
            "max_abs_err": float((h1.double() - hp.double()).abs().max())}
    neg = torch.full((n,), -1, dtype=torch.int32, device=dev)
    empty = histogram(sp, vals, num_bins=B, slot=neg, active=one)
    if float(empty.abs().max()) != 0.0:
        raise AssertionError("B8a with every row's slot at -1 is not zero")
    for S in (0, WIDE_K):
        if not _dead_khot_pass(torch, lgt_kernels, sp, vals, st["slot"], S,
                               B):
            raise AssertionError(f"B8a wrote on an inactive step (num_slots "
                                 f"{S})")

    # B3 and B3-K on the k-hot rows, timed on the strict tree's first split
    # and the wide tree's first full super-step
    rec, lor0 = st["rec"], st["lor"]
    rank = torch.arange(B, dtype=torch.int32, device=dev)
    lor = lor0.clone()
    t3k = median_ms(torch, lambda: gr.partition(sp, lor.copy_(lor0), rec,
                                                rank))
    t3p = median_ms(torch, lambda: gr.partition_plain(
        sp, lor.copy_(lor0), rec, rank), reps=5, warmup=1)
    # B3 and B3-K read the entries of the rows of a splitting leaf only,
    # and every row's leaf (read and written) and slot (written)
    b3_rows = int((lor0 == rec[gr.LEAF]).sum())
    b3 = bound_ms(4 * K_e * b3_rows + 12 * n, 0)
    stw = snaps["wide"]
    t3kk = median_ms(torch, lambda: gr.partition_slots(
        sp, lor.copy_(stw["lor"]), stw["step"], rank))
    t3kp = median_ms(torch, lambda: gr.partition_slots_plain(
        sp, lor.copy_(stw["lor"]), stw["step"], rank), reps=5, warmup=1)
    b3k_rows = int((stw["step"].slot_of_leaf[stw["lor"].long()]
                    >= 0).sum())
    b3k = bound_ms(4 * K_e * b3k_rows + 12 * n, 0)
    steps = {c: {"steps": t[2], "live_passes": t[3],
                 "leaves": t[0].num_leaves} for c, t in trees.items()}

    def row(name, route_src, replaces, ms, plain, bd, lib, err):
        return {"name": name, "route": "cuda", "source": route_src,
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bd[0], "bound_by": bd[1],
                "library_ms": lib}
    rows = {
        "histogram_sparse": row(
            "B8a k-hot histogram (strict step's smaller child)",
            "lightgbm_torch/csrc/sparse.cu", "lightgbm_tpu/sparse_data.py:108",
            res["strict"]["ms"], res["strict"]["plain_ms"],
            res["strict"]["bound"], res["strict"]["library_ms"],
            res["strict"]["max_abs_err"]),
        "histogram_slots_sparse": row(
            "B8a k-hot histogram, K = 16 slots",
            "lightgbm_torch/csrc/sparse.cu", "lightgbm_tpu/sparse_data.py:108",
            res["k16"]["ms"], res["k16"]["plain_ms"], res["k16"]["bound"],
            res["k16"]["library_ms"], res["k16"]["max_abs_err"]),
        "partition_sparse": row(
            "B8b B3 row partition, k-hot decode",
            "lightgbm_torch/csrc/partition.cu",
            "lightgbm_tpu/sparse_data.py:86", t3k, t3p, b3, None, 0.0),
        "partition_slots_sparse": row(
            "B8b B3-K batched partition, k-hot decode",
            "lightgbm_torch/csrc/partition.cu",
            "lightgbm_tpu/sparse_data.py:97", t3kk, t3kp, b3k, None, 0.0),
        "predict_sparse": row(
            "B8c B4 tree score update on k-hot rows",
            "lightgbm_torch/csrc/predict.cu",
            "lightgbm_tpu/sparse_data.py:204", t4k, t4p, b4, None, err4)}
    for k, r in rows.items():
        emit({"phase": "kernel", **r})
    emit({"phase": "sparse_kernels", "rows": n, "features": F, "k": K_e,
          "bins": B, "valid_rows": nv, "valid_k": spv.k,
          "b8a_by_form": {f_: {k: (v if k != "bound" else v[0])
                               for k, v in r.items()}
                          for f_, r in res.items()},
          "b8a_max_rel_err_every_pass": hist_err,
          "b8a_rerun_bitwise": True, "b8a_inactive_writes_nothing": True,
          "b8a_empty_slots_zero": True, "trees": steps,
          "b3_rows_read": b3_rows, "b3k_rows_read": b3k_rows,
          "slots_used_of_timed_pass": {
              "k16": snaps["wide"]["most_used"],
              "k8": snaps["k8"]["most_used"]},
          "b3_b3k_b4_bit_for_bit": True,
          "b4_train_walk_equals_grower_leaves": True})
    return rows


def _tree0_leaf_err_khot(torch, bst, y) -> float:
    """``_tree0_leaf_err`` with each row's leaf from B8c's walk of the
    device k-hot train matrix (no dense copy): the largest relative error
    of the first tree's shrunk leaf values against the f64 sums of its
    rows' first gradients."""
    m = bst._model
    dt = m.device_trees[0]
    leaves = _walk_leaves(torch, m.binned_dev, dt, m.na_bin_dev,
                          dt.steps).cpu().numpy()
    lbl = y.astype(np.float64)
    bias = np.log(lbl.mean() / (1 - lbl.mean()))
    p0 = 1 / (1 + np.exp(-bias))
    t = m.models[0]
    nl = t.num_leaves
    g = np.bincount(leaves, weights=p0 - lbl, minlength=nl)
    h = np.bincount(leaves, minlength=nl) * p0 * (1 - p0)
    exact = -0.1 * g / h
    got = np.asarray(t.leaf_value, np.float64)[:nl] - bias
    return float(np.max(np.abs(got - exact) / np.abs(exact)))


def _sparse_paths(torch, lgt, lgt_kernels, train, valid, name, params,
                  per_it, se_rounds, pi_rounds):
    """One sparse cell on the three paths: the per-iteration loop with the
    sparse valid set (auc and binary_logloss on the host, early stopping
    ES_ROUNDS; ``pi_rounds`` rounds; launches held to ``per_it``, one tree
    and one valid-score fetch an iteration), super-epochs of 10 without a
    valid set (``se_rounds`` rounds, one fetch an epoch; captured and
    warm-up launches held) and fused chunks of 25 (2 x 25 rounds, or 25);
    the shared trees equal on the three, and a byte-identical rerun of the
    super-epoch run.  Returns (line fields, launches by path, per-iteration
    booster, super-epoch booster)."""
    no_valid = {**per_it, "predict": 0}
    base = {"objective": "binary", "learning_rate": 0.1,
            "verbosity": -1, **params}
    # per-iteration with the sparse valid set (the super-epoch plan
    # refuses a k-hot valid set, as in the JAX package)
    ev, clock = {}, _IterClock()
    lgt_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clock.stamps[0] = t0
    bp = lgt.train({**base, "metric": METRICS}, train, pi_rounds,
                   valid_sets=[valid],
                   callbacks=[lgt.early_stopping(ES_ROUNDS,
                                                 first_metric_only=True,
                                                 verbose=False),
                              lgt.record_evaluation(ev), clock])
    torch.cuda.synchronize()
    secs_p = time.perf_counter() - t0
    lp = lgt_kernels.launch_counts()
    mp = bp._model
    n_p = mp.num_iterations_trained
    from lightgbm_torch.sparse_data import SparseBinned
    if not isinstance(mp.binned_dev, SparseBinned) \
            or not isinstance(mp.valid_sets[0][1], SparseBinned):
        raise AssertionError(f"{name}: the trainer holds no k-hot rows")
    if lp != times(per_it, n_p) or mp.fetch_counts != {
            "tree": n_p, "valid_score": n_p}:
        raise AssertionError(f"{name} per-iteration: launches {lp} for "
                             f"{n_p} iterations (expected {per_it} each), "
                             f"fetches {mp.fetch_counts}")
    auc = ev["valid_0"]["auc"]
    if not (n_p == pi_rounds and auc[-1] > auc[0] and 0.5 < auc[-1] <= 1):
        raise AssertionError(f"{name}: {n_p} iterations, valid AUC {auc}")
    # super-epochs without a valid set
    lgt_kernels.reset_launch_counts()
    t1 = time.perf_counter()
    bs = lgt.train({**base, "superepoch": 10, "fused_chunk": se_rounds + 1},
                   train, se_rounds)
    torch.cuda.synchronize()
    secs_s = time.perf_counter() - t1
    eager = lgt_kernels.launch_counts()
    ms = bs._model
    prog = fused_program(ms)
    epochs = se_rounds // 10
    if ms.fetch_counts != {"epoch": epochs} or prog.replays != se_rounds:
        raise AssertionError(f"{name} super-epochs: fetches "
                             f"{ms.fetch_counts}, {prog.replays} replays")
    if prog.captured != no_valid or prog.warmup != no_valid \
            or eager != times(no_valid, 2):
        raise AssertionError(f"{name} super-epoch launches: captured "
                             f"{prog.captured}, warm-up {prog.warmup}, "
                             f"wrapper calls {eager}, expected {no_valid}")
    device = {k: prog.warmup[k] + v for k, v in prog.launches().items()}
    text = bs.model_to_string()
    # fused chunks of 25
    crounds = 50 if se_rounds >= 50 else 25
    lgt_kernels.reset_launch_counts()
    t2 = time.perf_counter()
    bc = lgt.train(base, train, crounds)
    torch.cuda.synchronize()
    secs_c = time.perf_counter() - t2
    eager_c = lgt_kernels.launch_counts()
    pc = fused_program(bc._model)
    chunk = {k: pc.warmup[k] + v for k, v in pc.launches().items()}
    if pc.captured != no_valid or eager_c != times(no_valid, 2) \
            or pc.replays != crounds \
            or bc._model.fetch_counts != {"epoch": crounds // 25}:
        raise AssertionError(f"{name} fused chunks: captured {pc.captured}, "
                             f"wrapper calls {eager_c}, {pc.replays} "
                             f"replays, fetches {bc._model.fetch_counts}")
    shared = min(n_p, crounds)
    tp, ts, tc = (tree_sections(b.model_to_string(), shared)
                  for b in (bp, bs, bc))
    if not tp == ts == tc:
        first = next(i for i, (a, b_, c) in enumerate(zip(tp, ts, tc))
                     if not a == b_ == c)
        raise AssertionError(f"{name}: the paths' trees differ from tree "
                             f"{first}")
    # a byte-identical rerun of the super-epoch run
    b2 = lgt.train({**base, "superepoch": 10, "fused_chunk": se_rounds + 1},
                   train, se_rounds)
    if b2.model_to_string() != text:
        raise AssertionError(f"a second {name} super-epoch run gave other "
                             "model text")
    steady = ms.epoch_ms[1:] if len(ms.epoch_ms) > 1 else ms.epoch_ms
    ms_it = statistics.median(steady) / 10
    fields = {"valid_auc": [auc[0], auc[-1]],
              "valid_binary_logloss": [ev["valid_0"]["binary_logloss"][0],
                                       ev["valid_0"]["binary_logloss"][-1]],
              "per_iteration": {"iterations": n_p, "seconds": secs_p,
                                "steady_ms_per_iteration": clock.steady_ms(),
                                "steady_iterations_per_s":
                                    1e3 / clock.steady_ms(),
                                "host_fetches": mp.fetch_counts,
                                "launches": lp},
              "superepoch": {"iterations": ms.num_iterations_trained,
                             "seconds": secs_s, "epoch_ms": ms.epoch_ms,
                             "steady_ms_per_iteration": ms_it,
                             "steady_iterations_per_s": 1e3 / ms_it,
                             "capture_ms": prog.capture_ms,
                             "host_fetches": ms.fetch_counts,
                             "device_launches": device},
              "fused_chunk": {"rounds": crounds, "seconds": secs_c,
                              "epoch_ms": bc._model.epoch_ms,
                              "host_fetches": bc._model.fetch_counts},
              "shared_trees_equal": shared, "rerun_byte_identical": True,
              "live_steps_per_tree": statistics.mean(ms.step_counts),
              "leaves_per_tree": statistics.mean(t.num_leaves
                                                 for t in ms.models)}
    return fields, {name: device, f"{name}_per_iteration": lp,
                    f"{name}_fused_chunk": chunk}, bp, bs


def phase_sparse_train(torch, lgt, lgt_kernels, train, valid, y, xv):
    """sparse_train: binary at 31 leaves on the Allstate-shaped set on the
    three paths (``_sparse_paths``: SPARSE_PI_ROUNDS per-iteration rounds
    with the sparse valid set, ROUNDS as super-epochs, 2 x 25 as fused
    chunks; SPARSE_PER_ITERATION), the first tree's leaves within
    SPARSE_LEAF_RTOL of the f64 sums of their rows (each row's leaf from
    B8c's walk of the device k-hot matrix), the trainer's valid scores
    against ``Booster.predict`` on raw CSR rows, a profiled super-epoch
    run (device busy share, top kernels).  sparse_wide_train: 255 leaves
    (K = 16) with WIDE_PARAMS' bagging and feature_fraction, CUT_ROUNDS
    super-epoch rounds, SAMPLED_PER_ITERATION_ROUNDS per-iteration, 25 as
    one chunk (SPARSE_WIDE_PER_ITERATION).  Returns the launches by
    path."""
    fields, counts, bp, bs = _sparse_paths(
        torch, lgt, lgt_kernels, train, valid, "sparse_train",
        SPARSE_PARAMS, SPARSE_PER_ITERATION, ROUNDS, SPARSE_PI_ROUNDS)
    err = _tree0_leaf_err_khot(torch, bs, y)
    if not err <= SPARSE_LEAF_RTOL:
        raise AssertionError(f"sparse_train: the first tree's leaf values "
                             f"sit {err} from the f64 sums of their rows")
    # the trainer's valid scores (B8c walks of k-hot rows) against the
    # host walk of the raw rows
    rows = 5_000
    vscore = bp._model.valid_sets[0][2][:rows].double().cpu().numpy()
    pred = host_walk(bp, xv[:rows], raw_score=True,
                     num_iteration=bp.num_trees())
    walk_err = float(np.max(np.abs(vscore - pred)))
    if not walk_err <= 1e-4:
        raise AssertionError(f"sparse_train: valid scores {walk_err} from "
                             "the host walk of the raw rows")
    prounds = 10
    _, dev_ms, psecs, top = _profile_busy(torch, lambda: lgt.train(
        {"objective": "binary", "verbosity": -1, **SPARSE_PARAMS,
         "superepoch": prounds, "fused_chunk": prounds + 1}, train,
        prounds))
    dev_it = dev_ms / (prounds + 1)
    se = fields["superepoch"]
    emit({"phase": "sparse_train", "params": SPARSE_PARAMS, **fields,
          "tree0_leaf_rel_err": err, "tree0_leaf_rtol": SPARSE_LEAF_RTOL,
          "valid_score_vs_host_walk_max_abs": walk_err,
          "profile": {"iterations": prounds, "seconds": psecs,
                      "device_ms_per_iteration": dev_it,
                      "steady_busy_share":
                          dev_it / se["steady_ms_per_iteration"],
                      "top_kernels": top}})
    wfields, wcounts, _, _ = _sparse_paths(
        torch, lgt, lgt_kernels, train, valid, "sparse_wide_train",
        WIDE_PARAMS, SPARSE_WIDE_PER_ITERATION, CUT_ROUNDS,
        SAMPLED_PER_ITERATION_ROUNDS)
    emit({"phase": "sparse_wide_train", "params": WIDE_PARAMS, **wfields})
    return {**counts, **wcounts}


# ---------------------------------------------------------------------------
# multiclass (K trees an iteration on the per-iteration loop, B4's column
# form, B12c)
# ---------------------------------------------------------------------------

def make_covertype_like(n: int, seed: int):
    """A Covertype-shaped set (UCI Covertype, Blackard & Dean 1999;
    scikit-learn's ``fetch_covtype``): ``n`` rows of 54 columns, 10
    integer-valued numeric ones at the data set's ranges (elevation,
    aspect, slope, horizontal and vertical distance to hydrology, distance
    to roadways, hillshade at 9am, noon and 3pm, distance to fire points),
    then 4 wilderness-area and 40 soil-type 0/1 columns, each group one-hot;
    7 classes at Covertype's counts (scaled to ``n``), each with its own
    elevation, area, soil and distance profile so that the classes can be
    learned.  Returns (x f32 [n, 54], label f32 [n])."""
    rng = np.random.RandomState(seed)
    prof = np.random.RandomState(1000)       # the class profiles
    share = np.asarray(COVTYPE_COUNTS, np.float64) / sum(COVTYPE_COUNTS)
    counts = np.floor(share * n).astype(np.int64)
    counts[1] += n - counts.sum()
    y = rng.permutation(np.repeat(np.arange(MC_CLASSES), counts))
    elev_mu = np.asarray([3129, 2920, 2394, 2224, 2787, 2420, 3362.0])
    elev_sd = np.asarray([120, 140, 180, 80, 100, 160, 90.0])
    area_p = np.asarray([[.50, .05, .40, .05], [.45, .04, .40, .11],
                         [0, 0, .30, .70], [0, 0, 0, 1], [.60, 0, .40, 0],
                         [0, 0, .35, .65], [.30, .10, .60, 0]])
    # every soil type drawn in every class, a few types dominating each
    soil_p = 0.9 * prof.dirichlet(np.full(COVTYPE_SOILS, 0.2), MC_CLASSES) \
        + 0.1 / COVTYPE_SOILS
    scale = 0.6 + 0.8 * prof.rand(MC_CLASSES, 6)   # per-class distances
    x = np.zeros((n, 10 + COVTYPE_AREAS + COVTYPE_SOILS), np.float32)

    def clip(v, lo, hi):
        return np.clip(np.rint(v), lo, hi)
    x[:, 0] = clip(elev_mu[y] + elev_sd[y] * rng.randn(n), 1859, 3858)
    x[:, 1] = clip(360 * rng.rand(n) + 40 * (y - 3), 0, 360)
    x[:, 2] = clip(rng.gamma(2.5, 5.5 * scale[y, 0]), 0, 66)
    x[:, 3] = clip(rng.exponential(250 * scale[y, 1]), 0, 1397)
    x[:, 4] = clip(45 * scale[y, 2] + 55 * rng.randn(n), -173, 601)
    x[:, 5] = clip(rng.exponential(1500 * scale[y, 3]), 0, 7117)
    x[:, 6] = clip(212 + 27 * rng.randn(n) - 5 * (y - 3), 0, 254)
    x[:, 7] = clip(223 + 20 * rng.randn(n), 0, 254)
    x[:, 8] = clip(143 + 38 * rng.randn(n) + 4 * (y - 3), 0, 254)
    x[:, 9] = clip(rng.exponential(1500 * scale[y, 4]), 0, 7173)
    u = rng.rand(n)
    area = np.zeros(n, np.int64)
    soil = np.zeros(n, np.int64)
    for c in range(MC_CLASSES):
        rows = y == c
        area[rows] = np.minimum(np.searchsorted(np.cumsum(area_p[c]),
                                                u[rows], side="right"),
                                COVTYPE_AREAS - 1)
        soil[rows] = np.minimum(np.searchsorted(
            np.cumsum(soil_p[c]), rng.rand(int(rows.sum())), side="right"),
            COVTYPE_SOILS - 1)
    x[np.arange(n), 10 + area] = 1.0
    x[np.arange(n), 10 + COVTYPE_AREAS + soil] = 1.0
    return x, y.astype(np.float32)


def phase_mc_data(lgt):
    """The Covertype-shaped set, 80/20 train and valid from one seeded
    draw, binned at 255 bins at the default ``enable_bundle``: the 4
    wilderness and 40 soil one-hot columns bundle, so the matrix has G
    columns where PR 7's unbundled one had F = 54."""
    t0 = time.perf_counter()
    x, y = make_covertype_like(COVTYPE_ROWS, seed=30)
    perm = np.random.RandomState(31).permutation(len(y))
    cut = int(0.8 * len(y))
    tr, va = perm[:cut], perm[cut:]
    params = {"max_bin": MC_MAX_BIN, "verbosity": -1}
    train = lgt.Dataset(x[tr], y[tr], params=params).construct()
    valid = lgt.Dataset(x[va], y[va], reference=train,
                        params=params).construct()
    f = 10 + COVTYPE_AREAS + COVTYPE_SOILS
    if train.efb is None or train.num_features != f \
            or train.binned.shape[1] >= f or train.binned.dtype != np.uint8 \
            or valid.efb is not train.efb:
        raise AssertionError(f"unexpected covertype set "
                             f"{train.binned.shape}, efb {train.efb}")
    onehot = x[:, 10:]
    if not (onehot[:, :COVTYPE_AREAS].sum(1) == 1).all() \
            or not (onehot[:, COVTYPE_AREAS:].sum(1) == 1).all():
        raise AssertionError("wilderness or soil columns are not one-hot")
    emit({"phase": "multiclass_data", "seconds": time.perf_counter() - t0,
          "train": list(train.binned.shape),
          "valid": list(valid.binned.shape), "max_bin": int(train.max_bin),
          "class_counts": np.bincount(y.astype(np.int64)).tolist(),
          "features": f, "groups": train.efb.num_groups,
          "group_sizes": sorted(len(g) for g in train.efb.groups),
          "max_group_bin": train.efb.max_group_bin,
          "pr7_columns_unbundled": f})
    return x[va], train, valid


def check_b4_columns(torch, score0, binned, tree, na_bin, lv, weight,
                     steps, what, **cat):
    """B4's column form bit for bit against its plain version, for every
    column of ``score0`` [Nv, K]; returns the largest |kernel - plain|."""
    from lightgbm_torch.predict_device import (add_tree_score,
                                               add_tree_score_plain)
    err = 0.0
    for col in range(score0.shape[1]):
        s_k, s_p = score0.clone(), score0.clone()
        add_tree_score(s_k, binned, *tree, na_bin, lv, weight, steps=steps,
                       column=col, **cat)
        add_tree_score_plain(s_p, binned, *tree, na_bin, lv, weight,
                             steps=steps, column=col, **cat)
        err = max(err, exact_err(torch, [(s_k, s_p)],
                                 f"B4 column {col} ({what})"))
        others = [c for c in range(score0.shape[1]) if c != col]
        if not torch.equal(s_k[:, others], score0[:, others]) \
                or torch.equal(s_k[:, col], score0[:, col]):
            raise AssertionError(f"B4 column {col} ({what}) wrote outside "
                                 "its column or not at all")
    return err


def phase_mc_kernels(torch, lgt, valid, xv):
    """B4's column form at K = 7 on the Covertype-shaped valid matrix,
    grouped by its EFB bundles and walked through the decode maps (a
    numerical and a categorical tree, every column, stride 1 and column 0
    against the one-column call) and B12c against its plain version
    (random scores, saturated rows, zero weights), each timed."""
    from lightgbm_torch import metrics as tm
    from lightgbm_torch.efb import make_device_efb
    from lightgbm_torch.predict_device import (add_tree_score,
                                               add_tree_score_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    vbinned = torch.as_tensor(np.ascontiguousarray(valid.binned)).to(dev)
    nv, g = vbinned.shape
    K = MC_CLASSES
    nb = np.asarray([valid.bin_mappers[j].num_bin
                     for j in valid.used_features], np.int32)
    f = len(nb)
    maps = {"efb_maps": make_device_efb(valid.efb, nb, int(nb.max()),
                                        dev).maps}
    na = torch.full((f,), -1, dtype=torch.int32, device=dev)
    na[::5] = torch.as_tensor(nb[::5] - 1).to(dev)   # NA branches taken
    rng = np.random.RandomState(8)
    nodes = 2 ** 6 - 1
    sf = rng.randint(0, f, nodes).astype(np.int32)
    th = np.asarray([rng.randint(0, max(int(nb[j]) - 1, 1)) for j in sf],
                    np.int32)
    idx = np.arange(nodes)
    lc = np.where(2 * idx + 1 < nodes, 2 * idx + 1, 0).astype(np.int32)
    rc = np.where(2 * idx + 2 < nodes, 2 * idx + 2, 0).astype(np.int32)
    first = nodes // 2
    for node in range(first, nodes):
        lc[node] = ~(2 * (node - first))
        rc[node] = ~(2 * (node - first) + 1)
    tree = [torch.as_tensor(a).to(dev) for a in (sf, th)]
    tree += [torch.as_tensor((rng.rand(nodes) < 0.5).astype(np.int32)
                             ).to(dev), torch.as_tensor(lc).to(dev),
             torch.as_tensor(rc).to(dev)]
    lv = torch.as_tensor(rng.randn(nodes + 1).astype(np.float32)).to(dev)
    # a categorical tree: every third node categorical, with a random
    # rank table over the 256 bin values
    cat = {"is_cat_node": torch.as_tensor(
               (idx % 3 == 0).astype(np.int32)).to(dev),
           "cat_rank": torch.as_tensor(np.stack(
               [rng.permutation(256) for _ in range(nodes)]).astype(
                   np.int32)).to(dev)}
    score0 = torch.randn(nv, K, device=dev, generator=gen)
    err = max(check_b4_columns(torch, score0, vbinned, tree, na, lv, 1.0, 8,
                               "numerical", **maps),
              check_b4_columns(torch, score0, vbinned, tree, na, lv, -0.1,
                               8, "categorical", **cat, **maps))
    # stride 1 and column 0: the one-column call's launch and bits
    one = score0[:, 0].contiguous()
    a, b, c = one.clone(), one.clone(), one[:, None].clone()
    add_tree_score(a, vbinned, *tree, na, lv, 0.1, steps=8, **maps)
    add_tree_score_plain(b, vbinned, *tree, na, lv, 0.1, steps=8, **maps)
    add_tree_score(c, vbinned, *tree, na, lv, 0.1, steps=8, column=0,
                   **maps)
    err = max(err, exact_err(torch, [(a, b), (c[:, 0], b)],
                             "B4 stride 1 column 0"))
    s = score0.clone()
    t_k = median_ms(torch, lambda: add_tree_score(
        s, vbinned, *tree, na, lv, 1.0, steps=8, column=K - 1, **maps))
    t_p = median_ms(torch, lambda: add_tree_score_plain(
        s, vbinned, *tree, na, lv, 1.0, steps=8, column=K - 1, **maps))
    t_one = median_ms(torch, lambda: add_tree_score(
        a, vbinned, *tree, na, lv, 1.0, steps=8, **maps))
    b4_bound = bound_ms(nv * g + 8 * nv, 7 * nv)
    rows = {"predict_column": {
        "name": "B4 tree score update, class column form (K = 7)",
        "route": "cuda", "source": "lightgbm_torch/csrc/predict.cu",
        "replaces": "lightgbm_tpu/predict_device.py:72", "max_abs_err": err,
        "ms": t_k, "plain_ms": t_p, "bound_ms": b4_bound[0],
        "bound_by": b4_bound[1], "library_ms": None}}
    emit({"phase": "kernel", **rows["predict_column"], "kernel_ms": t_k,
          "one_column_ms": t_one, "rows": nv, "features": f, "columns": g,
          "classes": K})

    # B12c on the valid labels
    yv = torch.as_tensor(np.asarray(valid.metadata.label,
                                    np.float32)).to(dev)
    ones = torch.ones(nv, device=dev)
    zw = ones.clone()
    zw[::7] = 0.0
    sv = 2.0 * torch.randn(nv, K, device=dev, generator=gen)
    sat = sv.clone()
    sat[::3] = 0.0
    sat[::3, 0] = 80.0          # the label's probability under the clip
    cases = {"random": (sv, ones), "saturated": (sat, ones),
             "zero_weights": (sv, zw)}
    err12 = 0.0
    values = {}
    for case, (sc, w) in cases.items():
        got = float(tm.traced_multi_logloss(sc, yv, w))
        want = float(tm.traced_multi_logloss_plain(sc, yv, w))
        if not abs(got - want) <= POINTWISE_RTOL * abs(want):
            raise AssertionError(f"B12c ({case}): {got} vs plain {want}")
        err12 = max(err12, abs(got - want))
        values[case] = {"kernel": got, "plain": want}
    bad = yv.clone()
    bad[5] = K
    if not bool(torch.isnan(tm.traced_multi_logloss(sv, bad, ones))):
        raise AssertionError("B12c took a label outside [0, K)")
    import torch.nn.functional as F
    ylong = yv.long()

    def library():
        ce = F.cross_entropy(sv, ylong, reduction="none")
        return torch.sum(ce * ones) / torch.sum(ones)
    lib_v = float(library())
    t_k = median_ms(torch, lambda: tm.traced_multi_logloss(sv, yv, ones))
    t_p = median_ms(torch, lambda: tm.traced_multi_logloss_plain(sv, yv,
                                                                 ones))
    t_l = median_ms(torch, library)
    b12 = bound_ms(nv * K * 4 + 8 * nv + 4, (4 * K + 6) * nv)
    rows["multi_logloss"] = {
        "name": "B12c traced multi_logloss", "route": "cuda",
        "source": "lightgbm_torch/csrc/metrics.cu",
        "replaces": "lightgbm_tpu/metrics.py:445", "max_abs_err": err12,
        "ms": t_k, "plain_ms": t_p, "bound_ms": b12[0], "bound_by": b12[1],
        "library_ms": t_l}
    emit({"phase": "kernel", **rows["multi_logloss"], "kernel_ms": t_k,
          "cases": values, "library_value_unclipped": lib_v,
          "library_call": "cross_entropy(reduction='none') and a weighted "
                          "mean (no clip)"})
    return rows


class _IterClock:
    """A callback that records the host clock after every iteration."""

    def __init__(self):
        self.stamps = [time.perf_counter()]

    def __call__(self, env):
        self.stamps.append(time.perf_counter())

    def steady_ms(self, warmup: int = 1) -> float:
        """Median gap between iterations, the first ``warmup`` gaps
        dropped where more are left."""
        d = np.diff(self.stamps)
        d = d[warmup:] if len(d) > warmup else d
        return 1e3 * float(np.median(d)) if len(d) else float("nan")


def train_mc(lgt, train, valid, rounds, extra=None, timed=False):
    """Multiclass training on the Covertype-shaped set: 31 leaves, 255
    bins, learning rate 0.1, multi_logloss and multi_error, early stopping
    10 on the first metric."""
    ev = {}
    clock = _IterClock()
    cbs = [lgt.early_stopping(ES_ROUNDS, first_metric_only=True,
                              verbose=False),
           lgt.record_evaluation(ev), clock]
    if timed:
        cbs.append(_attach_timer)
    params = {**MC_PARAMS, **(extra or {})}
    t0 = time.perf_counter()
    clock.stamps[0] = t0
    bst = lgt.train(params, train, rounds, valid_sets=[valid],
                    callbacks=cbs)
    return bst, ev, time.perf_counter() - t0, clock


def phase_mc_train(torch, lgt, lgt_kernels, train, valid, name, extra,
                   rounds, per_tree, fused_eval=True, rerun=True,
                   profile_rounds=0):
    """``objective=multiclass`` (or ``extra``'s) on the per-iteration
    loop: launches held to K x ``per_tree`` plus K walks an iteration,
    fetches to one tree fetch of K rows and one valid-score fetch an
    iteration; then (``fused_eval``) the same run with the traced
    multi_logloss alone: the same model text but for the path and metric
    parameter lines, one B12c launch and one traced-eval fetch an
    iteration, values held to the host ones as the comment below says;
    (``rerun``) a second default run with byte-identical model text; and
    (``profile_rounds``) a run of that many rounds traced by
    ``torch.profiler`` (device ms an iteration, busy share).  Returns
    (booster, launches by path)."""
    K = MC_CLASSES
    want_it = {k: K * v for k, v in per_tree.items()}
    want_it["predict"] = K
    lgt_kernels.reset_launch_counts()
    bst, ev, secs, clock = train_mc(lgt, train, valid, rounds, extra,
                                    timed=True)
    torch.cuda.synchronize()
    launches = lgt_kernels.launch_counts()
    m = bst._model
    n = m.num_iterations_trained
    if bst.num_trees() != K * n or m.num_class != K:
        raise AssertionError(f"{name}: {bst.num_trees()} trees for {n} "
                             "iterations")
    if launches != times(want_it, n):
        raise AssertionError(f"{name}: launches {launches} for {n} "
                             f"iterations, expected {want_it} each")
    if m.fetch_counts != {"tree": n, "valid_score": n}:
        raise AssertionError(f"{name}: host fetches {m.fetch_counts}")
    if m._programs and any(p.graph is not None
                           for p in m._programs.values()):
        raise AssertionError(f"{name}: a graph was captured")
    if not any("num_class" in r for r in bst.fused_reasons()):
        raise AssertionError(f"{name}: fused_reasons {bst.fused_reasons()}")
    best = bst.best_iteration if bst.best_iteration > 0 else n
    ll = ev["valid_0"]["multi_logloss"]
    err_key = [k for k in ev["valid_0"] if k.startswith("multi_error")][0]
    if not (np.isfinite(ll).all() and ll[best - 1] < ll[0]
            and ev["valid_0"][err_key][best - 1] < 0.5):
        raise AssertionError(f"{name}: valid metrics {ev['valid_0']}")
    if max(t.num_leaves for t in m.models) != MC_PARAMS["num_leaves"] \
            and "num_leaves" not in (extra or {}):
        raise AssertionError(f"{name}: no tree reaches the leaf budget")
    text = bst.model_to_string()
    phases = {k: v / n for k, v in m.phase_timer.totals_ms().items()}
    out = {"phase": name, "params": {**MC_PARAMS, **(extra or {})},
           "iterations": n, "trees": bst.num_trees(),
           "best_iteration": best, "valid_multi_logloss": ll[best - 1],
           "valid_multi_error": ev["valid_0"][err_key][best - 1],
           "seconds": secs, "iterations_per_s": n / secs,
           "steady_ms_per_iteration": clock.steady_ms(),
           "steady_iterations_per_s": 1e3 / clock.steady_ms(),
           "phase_ms_per_iteration": phases,
           "host_fetches": m.fetch_counts, "launches": launches,
           "split_steps_live_per_tree": statistics.mean(m.step_counts),
           "leaves_per_tree": statistics.mean(t.num_leaves
                                              for t in m.models)}
    by_path = {name: launches}
    if fused_eval:
        lgt_kernels.reset_launch_counts()
        # the traced path needs every metric traced: multi_logloss alone
        # (multi_error has no traced form, as in the JAX package)
        bf, evf, secs_f, clock_f = train_mc(
            lgt, train, valid, rounds, {**(extra or {}),
                                        "fused_eval": "true",
                                        "metric": "multi_logloss"})
        torch.cuda.synchronize()
        lf = lgt_kernels.launch_counts()
        nf = bf._model.num_iterations_trained
        want_f = {**want_it, "multi_logloss": 1}
        if lf != times(want_f, nf):
            raise AssertionError(f"{name} fused_eval: launches {lf} for "
                                 f"{nf} iterations, expected {want_f}")
        fetches_f = dict(bf._model.fetch_counts)
        if fetches_f != {"tree": nf, "traced_eval": nf}:
            raise AssertionError(f"{name} fused_eval: fetches {fetches_f}")
        if without_path_params(bf.model_to_string(), "[metric:") \
                != without_path_params(text, "[metric:"):
            raise AssertionError(f"{name}: the fused_eval run's model "
                                 "text differs")
        # the traced metric clips the label's probability at 1e-7, the
        # host one at 1e-15 (as in the JAX package), so the two differ on
        # rows past the clip: each iteration's traced value is at most the
        # host one, and the last one equals, within MC_TRACED_RTOL, both
        # clips applied on the host to the run's final valid scores
        traced = np.asarray(evf["valid_0"]["multi_logloss"])
        host = np.asarray(ll[:nf])
        final = bf._model.valid_score(0).astype(np.float64)
        p = np.exp(final - final.max(axis=1, keepdims=True))
        p = (p / p.sum(axis=1, keepdims=True))[
            np.arange(len(final)),
            np.asarray(valid.metadata.label).astype(np.int64)]
        clip7, clip15 = (float(np.mean(-np.log(np.maximum(p, c))))
                         for c in (1e-7, 1e-15))
        rel = max(abs(traced[-1] - clip7) / clip7,
                  abs(host[-1] - clip15) / clip15)
        if not (rel <= MC_TRACED_RTOL
                and (traced <= host * (1 + MC_TRACED_RTOL)).all()):
            raise AssertionError(
                f"{name}: traced multi_logloss {traced} against host "
                f"{host}; last {traced[-1]} vs {clip7} (clip 1e-7), host "
                f"{host[-1]} vs {clip15} (clip 1e-15): {rel}")
        out["fused_eval"] = {"iterations": nf, "seconds": secs_f,
                             "iterations_per_s": nf / secs_f,
                             "steady_ms_per_iteration": clock_f.steady_ms(),
                             "traced_last_vs_host_recomputed_rel": rel,
                             "host_minus_traced_max": float(
                                 np.max(host - traced)),
                             "rows_past_the_clip": int((p < 1e-7).sum()),
                             "host_fetches": fetches_f,
                             "launches": lf}
        by_path[f"{name}_fused_eval"] = lf
    if rerun:
        b2, _, secs2, _ = train_mc(lgt, train, valid, rounds, extra)
        if b2.model_to_string() != text:
            raise AssertionError(f"a second {name} run gave other model "
                                 "text")
        out.update({"rerun_byte_identical": True, "rerun_seconds": secs2})
    if profile_rounds:
        # a short traced run: device time by kernel, and the device's busy
        # share of the loop's wall time (the tracer's own host cost in it)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            b3, _, secs3, _ = train_mc(lgt, train, valid, profile_rounds,
                                       extra)
            torch.cuda.synchronize()
        n3 = b3._model.num_iterations_trained

        def dev_us(e):
            return float(getattr(e, "self_device_time_total", 0) or 0)
        # kernel events only: an aten op's device time is its kernels'
        events = [e for e in prof.key_averages() if dev_us(e) > 0
                  and not e.key.startswith(("aten::", "Memcpy HtoD"))]
        dev_ms = sum(dev_us(e) for e in events) / 1e3
        top = sorted(((e.key[:90], dev_us(e) / 1e3, e.count)
                      for e in events), key=lambda r: -r[1])[:10]
        out["profile"] = {
            "iterations": n3, "device_ms_per_iteration": dev_ms / n3,
            "busy_share": dev_ms / (1e3 * secs3),
            "top_kernels": [{"name": n_, "device_ms": d, "count": c}
                            for n_, d, c in top]}
    emit(out)
    return bst, by_path


def phase_mc_serve(torch, lgt, lgt_kernels, bst, xv):
    """The softmax model's serving: ``Booster.predict`` through the engine
    (raw scores byte-identical to the host walk, probabilities equal, one
    walk per bucket chunk), ``fused_predict`` against
    ``_fused_reference`` (as fused_serve), and a Server host-binned and
    fused (as serve_host and serve_fused), every answer [rows, 7]."""
    from lightgbm_torch.serve import PredictorEngine
    x = np.asarray(xv, np.float64)
    bst._drop_predict_cache()
    torch.cuda.synchronize()
    lgt_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    raw = bst.predict(x, raw_score=True)
    prob = bst.predict(x)
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = lgt_kernels.launch_counts()
    eng = bst._engine_cache
    if not isinstance(eng, PredictorEngine):
        raise AssertionError("multiclass predict did not take the engine "
                             "route")
    hold_launches("multiclass predict", launches, forest_launches(
        lgt_kernels, forest_walk=2 * chunks(eng, len(x))))
    if raw.shape != (len(x), MC_CLASSES) \
            or not np.array_equal(raw, host_walk(bst, x, raw_score=True)) \
            or not np.array_equal(prob, host_walk(bst, x)) \
            or not np.allclose(prob.sum(axis=1), 1.0, rtol=1e-5):
        raise AssertionError("multiclass predict: the engine route differs "
                             "from the host walk")
    emit({"phase": "multiclass_predict", "rows": len(x),
          "trees": bst.num_trees(), "rows_per_s": 2 * len(x) / secs,
          "byte_identical_to_host_walk": True, "launches": launches})
    return {"multiclass_predict": launches,
            "multiclass_fused_serve": phase_fused_serve(
                torch, lgt, lgt_kernels, bst, x,
                name="multiclass_fused_serve"),
            "multiclass_serve_host": phase_serve(
                torch, lgt, lgt_kernels, bst, x, device_binning=False,
                name="multiclass_serve_host"),
            "multiclass_serve_fused": phase_serve(
                torch, lgt, lgt_kernels, bst, x, device_binning=True,
                name="multiclass_serve_fused")}


# ---------------------------------------------------------------------------
# ranking (B13a lambdarank, B13b XE-NDCG) and the pointwise objectives
# ---------------------------------------------------------------------------

def make_mslr_like(n: int, seed: int):
    """An MSLR-WEB30K-shaped set (Microsoft's LETOR web search set, Qin &
    Liu 2013): ``n`` documents in queries of about 120 (log-normal, a tail
    to RANK_MAX_QUERY; the first query has RANK_MAX_QUERY documents), 136
    features each zero for most documents (each nonzero for 5-45% of them,
    log-normal values), and relevance labels 0-4 at RANK_LABEL_SHARE from a
    hidden relevance (twelve of the features, a per-query shift and noise),
    cut at the global quantiles.  Returns (x f32 [n, 136], labels f32 [n],
    query sizes int64)."""
    rng = np.random.default_rng(seed)
    nq = max(1, int(round(n / 120)))
    sizes = np.clip(np.round(rng.lognormal(np.log(90.0), 0.75, nq)), 1,
                    RANK_MAX_QUERY).astype(np.int64)
    sizes[0] = min(RANK_MAX_QUERY, n)
    while sizes.sum() != n:
        diff = int(n - sizes.sum())
        pick = np.unique(rng.integers(1, nq, min(abs(diff), nq)))
        sizes[pick] = np.clip(sizes[pick] + np.sign(diff), 1,
                              RANK_MAX_QUERY)
    x = np.zeros((n, RANK_FEAT), np.float32)
    for f in range(RANK_FEAT):
        on = np.flatnonzero(rng.random(n, dtype=np.float32)
                            < rng.uniform(0.05, 0.45))
        x[on, f] = np.exp(rng.standard_normal(len(on), dtype=np.float32))
    eff = np.random.default_rng(4321).standard_normal(12)
    rel = (np.log1p(x[:, :12]) * eff).sum(axis=1)
    rel += np.repeat(0.5 * rng.standard_normal(nq), sizes) \
        + 0.6 * rng.standard_normal(n)
    cuts = np.quantile(rel, np.cumsum(RANK_LABEL_SHARE)[:-1])
    return x, np.digitize(rel, cuts).astype(np.float32), sizes


def phase_rank_data(lgt):
    """The MSLR-WEB30K-shaped train and valid sets, binned at 255 bins at
    the default ``enable_bundle``, with their query groups."""
    t0 = time.perf_counter()
    x, y, sizes = make_mslr_like(RANK_TRAIN, seed=70)
    xv, yv, sv = make_mslr_like(RANK_VALID, seed=71)
    t_make = time.perf_counter() - t0
    params = {"max_bin": RANK_MAX_BIN, "verbosity": -1}
    t1 = time.perf_counter()
    train = lgt.Dataset(x, y, group=sizes, params=params).construct()
    valid = lgt.Dataset(xv, yv, group=sv, reference=train,
                        params=params).construct()
    t_build = time.perf_counter() - t1
    del x, xv
    b = np.asarray(train.metadata.query_boundaries)
    if len(b) - 1 != len(sizes) or b[-1] != RANK_TRAIN \
            or train.binned.dtype != np.uint8:
        raise AssertionError(f"unexpected ranking set: {len(b) - 1} "
                             f"queries, {b[-1]} rows, {train.binned.dtype}")
    share = np.bincount(y.astype(np.int64), minlength=5) / len(y)
    classes = {f"({lo}, {hi}]": int(((sizes > lo) & (sizes <= hi)).sum())
               for lo, hi in ((0, 16), (16, 64), (64, 256), (256, 1024),
                              (1024, RANK_MAX_QUERY))}
    emit({"phase": "rank_data", "seconds": time.perf_counter() - t0,
          "make_seconds": t_make, "dataset_build_seconds": t_build,
          "train": [RANK_TRAIN, RANK_FEAT], "valid": [RANK_VALID, RANK_FEAT],
          "queries": len(sizes), "valid_queries": len(sv),
          "query_size_mean": float(sizes.mean()),
          "query_size_max": int(sizes.max()), "queries_by_size": classes,
          "label_share": share.tolist(),
          "zero_share": float((train.feature_binned() == 0).mean())
          if train.efb is None else None,
          "columns": int(train.binned.shape[1]),
          "groups": None if train.efb is None else train.efb.num_groups,
          "max_bin": int(train.max_bin),
          "reduced": ["none: MSLR-WEB30K Fold1's train rows, queries and "
                      "136 features; the valid set cut to 200,000 rows"]})
    return train, valid


def _query_err(torch, a, b, qid, q):
    """Largest |a - b| over each query's largest |b|; a query whose b is
    all zero must give a of zero (inf otherwise)."""
    den = torch.zeros(q, device=b.device).scatter_reduce_(
        0, qid, b.abs(), "amax")[qid]
    d = (a - b).abs()
    inf = torch.full_like(d, float("inf"))
    rel = torch.where(den > 0, d / den.clamp_min(1e-30),
                      torch.where(d > 0, inf, torch.zeros_like(d)))
    return float(rel.max()) if rel.numel() else 0.0


def phase_rank_kernels(torch, lgt, train):
    """B13a and B13b against their plain versions on the card, on the
    train set's 18,919 queries (every size class) and on a query past the
    kernel's shared-memory tile (RANK_BIG_QUERY documents, the global tile
    loop): ranks and the draws bit for bit, g and h within RANK_GRAD_RTOL
    of each query's largest magnitude; B13a at iteration 0 (all scores
    tied), on random scores with forced ties and on all-zero-label
    queries, at truncation 30 and 3, lambdarank_norm on and off, sigmoid 1
    and 2; B13b's draws also against ``ops.random.uniform`` per query;
    times and bounds from this run's inputs (B13a's by the pairs the
    function needs)."""
    from lightgbm_torch.objectives import default_label_gain, \
        inverse_max_dcg
    from lightgbm_torch.ops import random as rnd
    from lightgbm_torch.ops import rank as tr
    dev = torch.device("cuda")
    md = train.metadata
    b_np = np.asarray(md.query_boundaries, np.int64)
    label_np = np.asarray(md.label, np.float32)
    n, q = len(label_np), len(b_np) - 1
    gains = default_label_gain(label_np, None)
    bnd = torch.as_tensor(b_np.astype(np.int32)).to(dev)
    label = torch.as_tensor(label_np).to(dev)
    lg = torch.as_tensor(gains).to(dev)
    qid = torch.as_tensor(np.repeat(np.arange(q), np.diff(b_np))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(90)
    # 300 queries' labels zeroed: no gain, no valid pair
    zl_np = label_np.copy()
    for qi in np.random.RandomState(91).choice(q, min(300, q // 2),
                                               replace=False):
        zl_np[b_np[qi]:b_np[qi + 1]] = 0.0
    zlabel = torch.as_tensor(zl_np).to(dev)
    inv = {}
    for trunc in (30, 3):
        for name, lab in (("labels", label_np), ("zeroed", zl_np)):
            inv[(trunc, name)] = torch.as_tensor(
                inverse_max_dcg(lab, b_np, gains, trunc)).to(dev)
    rnd_s = torch.randn(n, device=dev, generator=gen)
    scores = {"iteration0": torch.zeros(n, device=dev),
              "ties": torch.round(rnd_s * 2) / 2, "random": rnd_s}
    cases = [("iteration0", "labels", 30, True, 1.0),
             ("ties", "labels", 30, False, 2.0),
             ("random", "zeroed", 3, True, 2.0),
             ("ties", "zeroed", 3, False, 1.0),
             ("random", "labels", 30, True, 1.0)]
    worst_g = worst_h = 0.0
    for sname, lname, trunc, norm, sig in cases:
        lab = label if lname == "labels" else zlabel
        args = (scores[sname], lab, bnd, lg, inv[(trunc, lname)])
        kw = dict(trunc=trunc, norm=norm, sigmoid=sig, with_ranks=True)
        gk, hk, rk = tr.lambdarank_grad(*args, **kw)
        gp, hp, rp = tr.lambdarank_grad_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(rk, rp):
            raise AssertionError(f"B13a ranks ({sname}, {lname}) differ "
                                 f"from the plain version's in "
                                 f"{int((rk != rp).sum())} rows")
        eg, eh = _query_err(torch, gk, gp, qid, q), \
            _query_err(torch, hk, hp, qid, q)
        if not (eg <= RANK_GRAD_RTOL and eh <= RANK_GRAD_RTOL):
            raise AssertionError(f"B13a ({sname}, {lname}, trunc {trunc}, "
                                 f"norm {norm}, sigmoid {sig}): g {eg}, "
                                 f"h {eh} of the query's largest")
        if lname == "zeroed":
            z = torch.as_tensor(zl_np == 0).to(dev) & (
                torch.zeros(q, device=dev).scatter_reduce_(
                    0, qid, lab, "amax")[qid] == 0)
            if bool((gk[z] != 0).any()) or bool((hk[z] != 1e-9).any()):
                raise AssertionError("B13a: a query without gain moved")
        worst_g, worst_h = max(worst_g, eg), max(worst_h, eh)
    # one query past the shared-memory tile, beside small ones
    rs = np.random.RandomState(92)
    big_sizes = np.asarray([RANK_BIG_QUERY, 1, 2, 17, 300])
    bb = torch.as_tensor(np.concatenate([[0], np.cumsum(big_sizes)])
                         .astype(np.int32)).to(dev)
    nb = int(big_sizes.sum())
    bl = torch.as_tensor(rs.choice(5, nb, p=RANK_LABEL_SHARE)
                         .astype(np.float32)).to(dev)
    bqid = torch.as_tensor(np.repeat(np.arange(5), big_sizes)).to(dev)
    binv = torch.rand(5, device=dev, generator=gen)
    for bs in (torch.zeros(nb, device=dev),
               torch.round(torch.randn(nb, device=dev, generator=gen) * 2)
               / 2):
        kw = dict(trunc=30, norm=True, sigmoid=1.0, with_ranks=True)
        gk, hk, rk = tr.lambdarank_grad(bs, bl, bb, lg, binv, **kw)
        gp, hp, rp = tr.lambdarank_grad_plain(bs, bl, bb, lg, binv, **kw)
        torch.cuda.synchronize()
        eg, eh = _query_err(torch, gk, gp, bqid, 5), \
            _query_err(torch, hk, hp, bqid, 5)
        if not torch.equal(rk, rp) or not (eg <= RANK_GRAD_RTOL
                                           and eh <= RANK_GRAD_RTOL):
            raise AssertionError(f"B13a on a {RANK_BIG_QUERY}-document "
                                 f"query: ranks equal {torch.equal(rk, rp)}"
                                 f", g {eg}, h {eh}")
        worst_g, worst_h = max(worst_g, eg), max(worst_h, eh)
    sc, inv30 = scores["random"], inv[(30, "labels")]
    a_kw = dict(trunc=30, norm=True, sigmoid=1.0)
    t_k = median_ms(torch, lambda: tr.lambdarank_grad(
        sc, label, bnd, lg, inv30, **a_kw))
    t_k0 = median_ms(torch, lambda: tr.lambdarank_grad(
        scores["iteration0"], label, bnd, lg, inv30, **a_kw))
    t_p = median_ms(torch, lambda: tr.lambdarank_grad_plain(
        sc, label, bnd, lg, inv30, **a_kw), reps=3, warmup=1)
    pairs = tr.valid_pairs(sc, label, bnd, lg, 30)
    bytes_a = 16 * n + 8 * q + 4 + 4 * len(gains)
    ba = bound_ms(bytes_a, RANK_PAIR_OPS * pairs)
    rows = {"lambdarank": {
        "name": "B13a lambdarank gradients", "route": "cuda",
        "source": "lightgbm_torch/csrc/rank.cu",
        "replaces": "lightgbm_tpu/objectives.py:515",
        "max_abs_err": worst_g, "ms": t_k, "plain_ms": t_p,
        "bound_ms": ba[0], "bound_by": ba[1], "library_ms": None}}
    emit({"phase": "kernel", **rows["lambdarank"],
          "max_rel_err_g": worst_g, "max_rel_err_h": worst_h,
          "ms_iteration0": t_k0, "rows": n, "queries": q,
          "valid_pairs": pairs, "bound_bytes": bytes_a,
          "pair_ops": RANK_PAIR_OPS,
          "big_query": RANK_BIG_QUERY,
          "cases": [list(c) for c in cases]})

    # B13b: the first iteration's key at objective_seed 5
    key = rnd.fold_in(rnd.prng_key(5), 1)
    gk, hk, gak = tr.xendcg_grad(sc, label, bnd, key, with_gamma=True)
    gp, hp, gap = tr.xendcg_grad_plain(sc, label, bnd, key, with_gamma=True)
    torch.cuda.synchronize()
    if not torch.equal(gak, gap):
        raise AssertionError("B13b's draws differ from the plain "
                             "version's")
    for qi in np.random.RandomState(93).choice(q, min(200, q),
                                               replace=False):
        lo, hi = int(b_np[qi]), int(b_np[qi + 1])
        want = rnd.uniform(rnd.fold_in(key, int(qi)), hi - lo, dev)
        if not torch.equal(gak[lo:hi], want):
            raise AssertionError(f"B13b's draws of query {qi} differ from "
                                 "ops.random.uniform")
    egx, ehx = _query_err(torch, gk, gp, qid, q), \
        _query_err(torch, hk, hp, qid, q)
    if not (egx <= RANK_GRAD_RTOL and ehx <= RANK_GRAD_RTOL):
        raise AssertionError(f"B13b: g {egx}, h {ehx} of the query's "
                             "largest")
    t_xk = median_ms(torch, lambda: tr.xendcg_grad(sc, label, bnd, key))
    t_xp = median_ms(torch, lambda: tr.xendcg_grad_plain(
        sc, label, bnd, key), reps=3, warmup=1)
    bx = bound_ms(16 * n + 4 * (q + 1), n * (THREEFRY_OPS + 15))
    rows["xendcg"] = {
        "name": "B13b rank_xendcg gradients", "route": "cuda",
        "source": "lightgbm_torch/csrc/rank.cu",
        "replaces": "lightgbm_tpu/objectives.py:597",
        "max_abs_err": egx, "ms": t_xk, "plain_ms": t_xp,
        "bound_ms": bx[0], "bound_by": bx[1], "library_ms": None}
    emit({"phase": "kernel", **rows["xendcg"], "max_rel_err_g": egx,
          "max_rel_err_h": ehx, "draws_bit_for_bit": True,
          "draws_checked_against_uniform": 200, "rows": n, "queries": q})
    return rows


def _profile_busy(torch, fn):
    """Run ``fn`` under ``torch.profiler``: the device kernels' total ms,
    the wall seconds, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", 0) or 0)
    events = [e for e in prof.key_averages() if dev_us(e) > 0
              and not e.key.startswith(("aten::", "Memcpy HtoD"))]
    dev_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(((e.key[:90], dev_us(e) / 1e3, e.count) for e in events),
                 key=lambda r: -r[1])[:10]
    return out, dev_ms, secs, [{"name": n_, "device_ms": d, "count": c}
                               for n_, d, c in top]


def phase_rank_train(torch, lgt, lgt_kernels, train, valid):
    """rank_train: ``objective=lambdarank`` at 255 leaves (K = 16), NDCG at
    RANK_PARAMS' eval_at on the valid queries (no traced form: the
    per-iteration loop), RANK_ROUNDS rounds, launches held to
    RANK_PER_ITERATION, one tree and one valid-score fetch an iteration,
    NDCG@10 above its first value, ms by phase (the gradients span is
    B13a); then the same rounds without a valid set as super-epochs of
    RANK_ROUNDS / 2 (B13a captured in the graph and replayed; launches
    held), the same model text; a profiled super-epoch run of
    RANK_PROFILE_ROUNDS rounds (device busy share).  xendcg_train:
    ``rank_xendcg`` at 255 leaves, XENDCG_ROUNDS rounds on the
    per-iteration loop (the fused paths refuse it with the JAX package's
    reason), launches held to XENDCG_PER_ITERATION, a byte-identical
    rerun.  Returns the launches by path."""
    per_it = dict(RANK_PER_ITERATION)
    ev, clock = {}, _IterClock()
    lgt_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clock.stamps[0] = t0
    bst = lgt.train(RANK_PARAMS, train, RANK_ROUNDS, valid_sets=[valid],
                    callbacks=[lgt.record_evaluation(ev), clock,
                               _attach_timer])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = lgt_kernels.launch_counts()
    m = bst._model
    if m.efb_dev is not None:
        per_it["expand_group_hist"] = WIDE_LEAVES
    n = m.num_iterations_trained
    if m.split_batch != WIDE_K or n != RANK_ROUNDS:
        raise AssertionError(f"rank_train: split_batch {m.split_batch}, "
                             f"{n} iterations")
    if launches != times(per_it, n):
        raise AssertionError(f"rank_train launches {launches} for {n} "
                             f"iterations, expected {per_it} each")
    if m.fetch_counts != {"tree": n, "valid_score": n}:
        raise AssertionError(f"rank_train fetches {m.fetch_counts}")
    nd = ev["valid_0"]
    if not nd["ndcg@10"][-1] > nd["ndcg@10"][0]:
        raise AssertionError(f"rank_train NDCG@10 {nd['ndcg@10']}")
    phases = {k: v / n for k, v in m.phase_timer.totals_ms().items()}
    text = bst.model_to_string()

    # super-epochs without a valid set: B13a inside the captured graph
    no_valid = {**per_it, "predict": 0}
    lgt_kernels.reset_launch_counts()
    t1 = time.perf_counter()
    bs = lgt.train({**RANK_PARAMS, "superepoch": RANK_ROUNDS // 2}, train,
                   RANK_ROUNDS)
    torch.cuda.synchronize()
    secs_se = time.perf_counter() - t1
    eager = lgt_kernels.launch_counts()
    ms = bs._model
    prog = fused_program(ms)
    if ms.fetch_counts != {"epoch": 2} or prog.replays != RANK_ROUNDS:
        raise AssertionError(f"rank_train super-epochs: fetches "
                             f"{ms.fetch_counts}, {prog.replays} replays")
    if prog.captured != no_valid or prog.warmup != no_valid \
            or eager != times(no_valid, 2):
        raise AssertionError(f"rank_train super-epoch launches: captured "
                             f"{prog.captured}, warm-up {prog.warmup}, "
                             f"wrapper calls {eager}, expected {no_valid}")
    device = {k: prog.warmup[k] + v for k, v in prog.launches().items()}
    if without_path_params(bs.model_to_string()) \
            != without_path_params(text):
        raise AssertionError("rank_train: the super-epoch model text "
                             "differs from the per-iteration one")
    se_ms = ms.epoch_ms[1] / (RANK_ROUNDS // 2)
    _, dev_ms, psecs, top = _profile_busy(torch, lambda: lgt.train(
        {**RANK_PARAMS, "superepoch": RANK_PROFILE_ROUNDS}, train,
        RANK_PROFILE_ROUNDS))
    # the warm-up and every replay ran the body once each
    dev_it = dev_ms / (RANK_PROFILE_ROUNDS + 1)
    emit({"phase": "rank_train", "params": RANK_PARAMS,
          "iterations": n, "seconds": secs, "iterations_per_s": n / secs,
          "steady_ms_per_iteration": clock.steady_ms(),
          "steady_iterations_per_s": 1e3 / clock.steady_ms(),
          "phase_ms_per_iteration": phases,
          "b13a_ms_per_iteration": phases.get("gradients"),
          "valid_ndcg": {k: [v[0], v[-1]] for k, v in nd.items()},
          "host_fetches": m.fetch_counts, "launches": launches,
          "split_steps_live_per_tree": statistics.mean(m.step_counts),
          "leaves_per_tree": statistics.mean(t.num_leaves
                                             for t in m.models),
          "superepoch": {"seconds": secs_se,
                         "steady_ms_per_iteration": se_ms,
                         "steady_iterations_per_s": 1e3 / se_ms,
                         "epoch_ms": ms.epoch_ms,
                         "capture_ms": prog.capture_ms,
                         "host_fetches": ms.fetch_counts,
                         "device_launches": device,
                         "same_model_text": True},
          "profile": {"iterations": RANK_PROFILE_ROUNDS, "seconds": psecs,
                      "device_ms_per_iteration": dev_it,
                      "steady_busy_share": dev_it / se_ms,
                      "busy_share_of_profiled_wall":
                          dev_ms / (1e3 * psecs),
                      "top_kernels": top}})
    by_path = {"rank_train": launches, "rank_train_superepoch": device}

    # rank_xendcg: per-iteration only, keyed draws
    xparams = {**RANK_PARAMS, "objective": "rank_xendcg"}
    xper = {**per_it, "lambdarank": 0, "xendcg": 1}
    runs = []
    for _ in range(2):
        ev, clock = {}, _IterClock()
        lgt_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        clock.stamps[0] = t0
        bx = lgt.train(xparams, train, XENDCG_ROUNDS, valid_sets=[valid],
                       callbacks=[lgt.record_evaluation(ev), clock])
        torch.cuda.synchronize()
        runs.append((bx, ev, clock, time.perf_counter() - t0,
                     lgt_kernels.launch_counts()))
    (bx, ev, clock, secs_x, lx), (bx2, *_rest) = runs
    nx = bx._model.num_iterations_trained
    reason = "objective=rank_xendcg mutates host state every iteration"
    if lx != times(xper, nx) or reason not in bx.fused_reasons() \
            or bx._model.fetch_counts != {"tree": nx, "valid_score": nx}:
        raise AssertionError(f"xendcg_train: launches {lx}, reasons "
                             f"{bx.fused_reasons()}, fetches "
                             f"{bx._model.fetch_counts}")
    if bx2.model_to_string() != bx.model_to_string():
        raise AssertionError("a second xendcg_train run gave other model "
                             "text")
    emit({"phase": "xendcg_train", "params": xparams, "iterations": nx,
          "seconds": secs_x, "iterations_per_s": nx / secs_x,
          "steady_ms_per_iteration": clock.steady_ms(),
          "steady_iterations_per_s": 1e3 / clock.steady_ms(),
          "valid_ndcg": {k: [v[0], v[-1]] for k, v in ev["valid_0"].items()},
          "fused_reason": reason, "rerun_byte_identical": True,
          "host_fetches": bx._model.fetch_counts, "launches": lx})
    by_path["xendcg_train"] = lx
    return by_path, nd["ndcg@10"]


# ---------------------------------------------------------------------------
# quantized training (B7a-c, B1-int, B1-K-int)
# ---------------------------------------------------------------------------

def _int_index_add(torch, binned, vals, slot, num_bins, num_slots=None):
    """The library yardstick of B1-int / B1-K-int: one int32
    ``index_add_`` over precomputed cell indices (None where CUDA has no
    int32 index_add_)."""
    n, f = binned.shape
    keep = slot >= 0
    b = binned[keep].to(torch.int64)
    cells = b + torch.arange(f, device=binned.device) * num_bins
    size = f * num_bins
    if num_slots is not None:
        cells = cells + (slot[keep].to(torch.int64) * size)[:, None]
        size *= num_slots
    idx = cells.reshape(-1)
    src = vals[keep].to(torch.int32).repeat_interleave(f, dim=0)
    acc = torch.zeros((size, 3), dtype=torch.int32, device=binned.device)
    try:
        return median_ms(torch, lambda: acc.zero_().index_add_(0, idx, src))
    except RuntimeError:
        return None


def _dead_int_pass(torch, lgt_kernels, binned, q, slot, B, K=None):
    """B1-int (K None) or B1-K-int launched on an inactive step into
    sentinel-filled outputs through the C entry: True when nothing was
    written (the kernel and its reduce exit at once)."""
    from lightgbm_torch.ops.histogram import int_launch_shape
    n, f = binned.shape
    dev = binned.device
    rows, tile_f, tile_k = int_launch_shape(n, f, B, K)
    nb = -(-n // rows)
    shape = (f, B, 3) if K is None else (K, f, B, 3)
    out = torch.full(shape, -7, dtype=torch.int32, device=dev)
    partial = torch.full((nb,) + shape, -7, dtype=torch.int32, device=dev)
    off = torch.zeros(1, dtype=torch.int32, device=dev)
    err = lgt_kernels.lib("histogram").lgbt_histogram_int(
        binned.data_ptr(), q.data_ptr(), 8, slot.data_ptr(), n, f, B, K or 1,
        rows, tile_f, tile_k, off.data_ptr(), None, partial.data_ptr(),
        out.data_ptr(), lgt_kernels.stream_ptr(dev))
    lgt_kernels.check(err, "B1-int on an inactive step")
    torch.cuda.synchronize()
    return bool((out == -7).all()) and bool((partial == -7).all())


def int_pass_bound(n: int, f: int, B: int, kept: int, K: int = 1,
                   slotted: bool = True):
    """bound_ms of one B1-int (K = 1) or B1-K-int pass over int8 vals:
    every row's slot (4 B, none for the root pass) and, of the ``kept``
    rows in the pass only, the binned row and the 3 bytes of vals read,
    the [K, F, B, 3] int32 histogram written; 3 adds a kept row and
    feature."""
    return bound_ms(4 * n * slotted + kept * (f + 3) + K * f * B * 12,
                    3 * kept * f)


def phase_quant_kernels(torch, lgt, lgt_kernels, train, train_u):
    """B7a (scales) and B7b (packing) bit for bit against their plain
    versions at 1M x 3 (int8 stochastic over four iteration keys and two
    seeds, int8 nearest) and at 65,536 rows (int16, both roundings), zero
    rows staying zero; B1-int and B1-K-int bit for bit at the main shape
    (28 x 63: all rows, a smaller child's slot, K = 16 slots, 5 of 16 in
    use), at 255 bins, at the rank shape (2,270,296 x 136, 255 bins) and
    on efb_data's unbundled 584-column matrix, and writing nothing on an
    inactive step; B7c bit for bit on a child pair and writing nothing on
    an inactive step; each timed beside its bound and library call; the
    int16 overflow refusal at 1M rows.  Returns the kernels-line rows."""
    from lightgbm_torch.ops import quantize as Q
    from lightgbm_torch.ops.histogram import (compute_histogram,
                                              histogram_int_plain,
                                              histogram_slots_int_plain)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    binned = torch.as_tensor(train.binned).to(dev)
    n, f = binned.shape
    B = int(train.max_bin)

    def grad_vals(rows):
        # binary-objective (g, h, w) at a random score, a 0.8 bag
        y = (torch.rand(rows, device=dev, generator=gen) < 0.5).float()
        p = torch.sigmoid(torch.randn(rows, device=dev, generator=gen))
        w = (torch.rand(rows, device=dev, generator=gen) < 0.8).float()
        return torch.stack([(p - y) * w, p * (1 - p) * w, w], 1) \
            .contiguous()

    vals = grad_vals(n)
    pairs7 = []
    for bits, stochastic, rows, seeds, its in (
            (8, True, n, (0, 12345), (0, 1, 49, 2 ** 31 - 1)),
            (8, False, n, (0,), (0,)),
            (16, True, 65_536, (0, 7), (0, 5)),
            (16, False, 65_536, (0,), (0,))):
        v = vals[:rows]
        spec = Q.QuantSpec(bits, stochastic, 0)
        s_k = Q.quant_scales(v, spec.qmax)
        s_p = Q.quant_scales_plain(v, spec.qmax)
        pairs7.append((s_k, s_p))
        for seed in seeds:
            for it in its:
                sp_ = spec._replace(seed=seed)
                q_k = Q.quantize_stack(v, s_k, sp_, torch.tensor(
                    [it], dtype=torch.int32, device=dev))
                pairs7.append((q_k, Q.quantize_stack_plain(v, s_p, sp_, it)))
                if not bool((q_k[v[:, 2] == 0] == 0).all()):
                    raise AssertionError("B7b: a zero row did not stay zero")
    err7 = exact_err(torch, pairs7, "B7a/B7b")
    spec = Q.QuantSpec(8, True, 0)
    it = torch.tensor([3], dtype=torch.int32, device=dev)
    s = Q.quant_scales(vals, spec.qmax)
    q = Q.quantize_stack(vals, s, spec, it)
    t_a = median_ms(torch, lambda: Q.quant_scales(vals, spec.qmax, out=s))
    t_ap = median_ms(torch, lambda: Q.quant_scales_plain(vals, spec.qmax))
    t_al = median_ms(torch, lambda: vals.abs().amax(0))
    t_b = median_ms(torch, lambda: Q.quantize_stack(vals, s, spec, it,
                                                    out=q))
    t_bp = median_ms(torch, lambda: Q.quantize_stack_plain(vals, s, spec, 3))
    b7a = bound_ms(12 * n + 12, 2 * 3 * n)
    b7b = bound_ms(12 * n + 12 + 3 * n, 10 * 3 * n)
    rows = {"quant_scales": {
        "name": "B7a quantized-training scales", "route": "cuda",
        "source": "lightgbm_torch/csrc/quantize.cu",
        "replaces": "lightgbm_tpu/ops/quantize.py:98", "max_abs_err": err7,
        "ms": t_a, "plain_ms": t_ap, "bound_ms": b7a[0],
        "bound_by": b7a[1], "library_ms": t_al},
        "quantize_stack": {
        "name": "B7b int8/int16 packing (stochastic rounding)",
        "route": "cuda", "source": "lightgbm_torch/csrc/quantize.cu",
        "replaces": "lightgbm_tpu/ops/quantize.py:109", "max_abs_err": err7,
        "ms": t_b, "plain_ms": t_bp, "bound_ms": b7b[0], "bound_by": b7b[1],
        "library_ms": None}}

    # B1-int and B1-K-int at the main shape, on the packed stack
    slot = torch.where(torch.rand(n, device=dev, generator=gen) < 0.4, 0,
                       -1).to(torch.int32)
    kslot = torch.where(torch.rand(n, device=dev, generator=gen) < 0.5,
                        torch.randint(0, WIDE_K, (n,), device=dev,
                                      generator=gen), -1).to(torch.int32)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    K16 = torch.tensor([WIDE_K], dtype=torch.int32, device=dev)

    def int_pairs(bn, qq, sl, ks, nbins):
        used5 = torch.tensor([5], dtype=torch.int32, device=dev)
        ks5 = torch.where(ks < 5, ks, -1)
        return [
            (compute_histogram(bn, qq, num_bins=nbins),
             histogram_int_plain(bn, qq, num_bins=nbins)),
            (compute_histogram(bn, qq, num_bins=nbins, slot=sl, active=one),
             histogram_int_plain(bn, qq, num_bins=nbins, slot=sl)),
            (compute_histogram(bn, qq, num_bins=nbins, slot=ks,
                               num_slots=WIDE_K, active=one, slots_used=K16),
             histogram_slots_int_plain(bn, qq, ks, num_slots=WIDE_K,
                                       num_bins=nbins)),
            (compute_histogram(bn, qq, num_bins=nbins, slot=ks5,
                               num_slots=WIDE_K, active=one,
                               slots_used=used5),
             histogram_slots_int_plain(bn, qq, ks5, num_slots=WIDE_K,
                                       num_bins=nbins))]

    cases = {"main": int_pairs(binned, q, slot, kslot, B)}
    b255 = torch.randint(0, 255, (n, f), dtype=torch.uint8, device=dev,
                         generator=gen)
    cases["bins_255"] = int_pairs(b255, q, slot, kslot, 255)
    del b255
    # the rank shape: most features at bin 0, as MSLR's are
    nr = RANK_TRAIN
    br = torch.randint(1, 255, (nr, RANK_FEAT), dtype=torch.uint8,
                       device=dev, generator=gen)
    br.mul_((torch.randint(0, 10, (nr, RANK_FEAT), dtype=torch.uint8,
                           device=dev, generator=gen) < 3).to(torch.uint8))
    vr = grad_vals(nr)
    qr = Q.quantize_stack(vr, Q.quant_scales(vr, 127), spec, it)
    slot_r = torch.where(torch.rand(nr, device=dev, generator=gen) < 0.4, 0,
                         -1).to(torch.int32)
    kslot_r = torch.where(torch.rand(nr, device=dev, generator=gen) < 0.5,
                          torch.randint(0, WIDE_K, (nr,), device=dev,
                                        generator=gen), -1).to(torch.int32)
    cases["rank_shape"] = int_pairs(br, qr, slot_r, kslot_r, 255)
    b_rank = (int_pass_bound(nr, RANK_FEAT, 255, int((slot_r >= 0).sum())),
              int_pass_bound(nr, RANK_FEAT, 255, int((kslot_r >= 0).sum()),
                             WIDE_K))
    t_rank_b7 = (median_ms(torch, lambda: Q.quant_scales(vr, 127)),
                 median_ms(torch, lambda: Q.quantize_stack(
                     vr, Q.quant_scales(vr, 127), spec, it)))
    t_rank = (
        median_ms(torch, lambda: compute_histogram(
            br, qr, num_bins=255, slot=slot_r, active=one)),
        median_ms(torch, lambda: compute_histogram(
            br, qr, num_bins=255, slot=kslot_r, num_slots=WIDE_K,
            active=one, slots_used=K16)))
    del br, vr, qr
    # efb_data's unbundled matrix, 584 columns at 255 bins
    bu = torch.as_tensor(train_u.binned).to(dev)
    nu = bu.shape[0]
    cases["efb_unbundled"] = int_pairs(bu, q[:nu].contiguous(), slot[:nu],
                                       kslot[:nu], int(train_u.max_bin))
    t_unb = median_ms(torch, lambda: compute_histogram(
        bu, q[:nu].contiguous(), num_bins=int(train_u.max_bin)))
    b_unb = int_pass_bound(nu, bu.shape[1], int(train_u.max_bin), nu,
                           slotted=False)
    del bu
    err1 = {c: exact_err(torch, p_, f"B1-int/B1-K-int ({c})")
            for c, p_ in cases.items()}
    dead = (_dead_int_pass(torch, lgt_kernels, binned, q, slot, B),
            _dead_int_pass(torch, lgt_kernels, binned, q, kslot, B, WIDE_K))
    if not all(dead):
        raise AssertionError(f"B1-int/B1-K-int wrote on an inactive step "
                             f"{dead}")

    t_1 = median_ms(torch, lambda: compute_histogram(
        binned, q, num_bins=B, slot=slot, active=one))
    t_1p = median_ms(torch, lambda: histogram_int_plain(
        binned, q, num_bins=B, slot=slot))
    t_k = median_ms(torch, lambda: compute_histogram(
        binned, q, num_bins=B, slot=kslot, num_slots=WIDE_K, active=one,
        slots_used=K16))
    t_kp = median_ms(torch, lambda: histogram_slots_int_plain(
        binned, q, kslot, num_slots=WIDE_K, num_bins=B))
    b1 = int_pass_bound(n, f, B, int((slot >= 0).sum()))
    b1k = int_pass_bound(n, f, B, int((kslot >= 0).sum()), WIDE_K)
    rows["histogram_int"] = {
        "name": "B1-int integer histogram (smaller child's pass)",
        "route": "cuda", "source": "lightgbm_torch/csrc/histogram.cu",
        "replaces": "lightgbm_tpu/ops/histogram.py:143",
        "max_abs_err": max(err1.values()), "ms": t_1, "plain_ms": t_1p,
        "bound_ms": b1[0], "bound_by": b1[1],
        "library_ms": _int_index_add(torch, binned, q, slot, B)}
    rows["histogram_slots_int"] = {
        "name": "B1-K-int integer K-slot histogram (K = 16)",
        "route": "cuda", "source": "lightgbm_torch/csrc/histogram.cu",
        "replaces": "lightgbm_tpu/ops/histogram.py:143",
        "max_abs_err": max(err1.values()), "ms": t_k, "plain_ms": t_kp,
        "bound_ms": b1k[0], "bound_by": b1k[1],
        "library_ms": _int_index_add(torch, binned, q, kslot, B, WIDE_K)}

    # B7c on a child pair (the smaller child's pass, the larger by
    # subtraction), and an inactive step
    small = compute_histogram(binned, q, num_bins=B, slot=slot, active=one)
    pair = torch.stack([small, compute_histogram(binned, q, num_bins=B)
                        - small]).contiguous()
    d_k = Q.dequantize_hist(pair, s)
    err7c = exact_err(torch, [(d_k, Q.dequantize_hist_plain(pair, s))],
                      "B7c")
    out = torch.full(pair.shape, 5.0, device=dev)
    Q.dequantize_hist(pair, s, active=torch.zeros(1, dtype=torch.int32,
                                                  device=dev), out=out)
    torch.cuda.synchronize()
    if not bool((out == 5.0).all()):
        raise AssertionError("B7c wrote on an inactive step")
    t_c = median_ms(torch, lambda: Q.dequantize_hist(pair, s, active=one,
                                                     out=d_k))
    t_cp = median_ms(torch, lambda: Q.dequantize_hist_plain(pair, s))
    t_cl = median_ms(torch, lambda: pair.float() * s)
    b7c = bound_ms(pair.numel() * 8 + 12, pair.numel())
    rows["dequant_hist"] = {
        "name": "B7c histogram dequantization (a child pair)",
        "route": "cuda", "source": "lightgbm_torch/csrc/quantize.cu",
        "replaces": "lightgbm_tpu/ops/split.py:29", "max_abs_err": err7c,
        "ms": t_c, "plain_ms": t_cp, "bound_ms": b7c[0], "bound_by": b7c[1],
        "library_ms": t_cl}

    # the int16 refusal: 1M rows could overflow an int16 lane's int32 bins
    try:
        lgt.train({"objective": "binary", "max_bin": MAX_BIN,
                   "verbosity": -1, "quant_train": True, "quant_bits": 16},
                  train, 1)
    except ValueError as e:
        if "int32 histogram" not in str(e):
            raise
        refusal = str(e)
    else:
        raise AssertionError("quant_bits=16 trained 1M rows")
    for k in ("quant_scales", "quantize_stack", "histogram_int",
              "histogram_slots_int", "dequant_hist"):
        emit({"phase": "kernel", **rows[k]})
    emit({"phase": "quant_kernels", "b7_cases": len(pairs7),
          "int_max_abs_err": err1, "inactive_steps_write_nothing": True,
          "b7_rank_shape_ms": {"quant_scales": t_rank_b7[0],
                               "quantize_stack": t_rank_b7[1],
                               "rows": RANK_TRAIN},
          "b7_rank_shape_bound_ms": {
              "quant_scales": bound_ms(12 * RANK_TRAIN, 0)[0],
              "quantize_stack": bound_ms(15 * RANK_TRAIN, 0)[0]},
          "rank_shape_ms": {"histogram_int": t_rank[0],
                            "histogram_slots_int": t_rank[1],
                            "rows": RANK_TRAIN, "features": RANK_FEAT,
                            "bins": 255},
          "rank_shape_bound_ms": {"histogram_int": b_rank[0][0],
                                  "histogram_slots_int": b_rank[1][0]},
          "efb_unbundled_root_ms": t_unb,
          "efb_unbundled_root_bound_ms": b_unb[0],
          "int16_refusal": refusal[:160],
          "int16_max_rows": INT16_MAX_ROWS})
    return rows


def phase_quant_rank(torch, lgt, lgt_kernels, train, valid, f32_ndcg10):
    """quant_rank: rank_train's lambdarank (255 leaves, K = 16) with
    ``quant_train`` (int8, stochastic) for QUANT_RANK_ROUNDS per-iteration
    rounds: launches held to QUANT_RANK_PER_ITERATION, one tree and one
    valid-score fetch an iteration, NDCG@10 rising and within
    QUANT_NDCG_GAP of rank_train's at the same round.  Returns the
    launches by path."""
    per_it = dict(QUANT_RANK_PER_ITERATION)
    params = {**RANK_PARAMS, **QUANT}
    ev, clock = {}, _IterClock()
    lgt_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clock.stamps[0] = t0
    bst = lgt.train(params, train, QUANT_RANK_ROUNDS, valid_sets=[valid],
                    callbacks=[lgt.record_evaluation(ev), clock])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = lgt_kernels.launch_counts()
    m = bst._model
    if m.efb_dev is not None:
        per_it["expand_group_hist"] = WIDE_LEAVES
    n = m.num_iterations_trained
    if m.split_batch != WIDE_K or n != QUANT_RANK_ROUNDS or m.quant is None:
        raise AssertionError(f"quant_rank: split_batch {m.split_batch}, "
                             f"{n} iterations, quant {m.quant}")
    hold_launches("quant_rank", launches, times(per_it, n))
    if m.fetch_counts != {"tree": n, "valid_score": n}:
        raise AssertionError(f"quant_rank fetches {m.fetch_counts}")
    nd = ev["valid_0"]["ndcg@10"]
    r = QUANT_RANK_ROUNDS - 1
    gap = nd[r] - f32_ndcg10[r]
    if not nd[-1] > nd[0] or abs(gap) > QUANT_NDCG_GAP:
        raise AssertionError(f"quant_rank NDCG@10 {nd}, f32 "
                             f"{f32_ndcg10[:r + 1]}")
    emit({"phase": "quant_rank", "params": params, "iterations": n,
          "seconds": secs, "steady_ms_per_iteration": clock.steady_ms(),
          "steady_iterations_per_s": 1e3 / clock.steady_ms(),
          "valid_ndcg10": nd, "f32_ndcg10": f32_ndcg10[:r + 1],
          "ndcg10_gap_at_round": [QUANT_RANK_ROUNDS, gap],
          "limit": QUANT_NDCG_GAP, "host_fetches": m.fetch_counts,
          "launches": launches,
          "leaves_per_tree": statistics.mean(t.num_leaves
                                             for t in m.models)})
    return {"quant_rank": launches}


def phase_quant_efb(torch, lgt, lgt_kernels, train, valid):
    """quant_efb: efb_train's bundled set with ``quant_train`` (int8,
    nearest rounding), QUANT_EFB_ROUNDS rounds as one super-epoch (launches
    held to QUANT_EFB_PER_ITERATION: B7c before every B9, one fetch) and on
    the per-iteration path (the same model text, eager launches held).
    Returns the launches by path."""
    per_it = QUANT_EFB_PER_ITERATION
    lgt_kernels.reset_launch_counts()
    bst, ev, secs = train_main(lgt, train, valid, extra=QUANT_EFB_PARAMS,
                               rounds=QUANT_EFB_ROUNDS)
    torch.cuda.synchronize()
    eager = lgt_kernels.launch_counts()
    m = bst._model
    prog = fused_program(m)
    n = m.num_iterations_trained
    epochs = len(m.epoch_ms)
    if m.efb_dev is None or m.quant is None or n != QUANT_EFB_ROUNDS \
            or m.fetch_counts != {"epoch": epochs}:
        raise AssertionError(f"quant_efb: efb {m.efb_dev is not None}, "
                             f"{n} iterations, fetches {m.fetch_counts}")
    if prog.captured != per_it or prog.warmup != per_it \
            or eager != times(per_it, 2):
        raise AssertionError(f"quant_efb launches: captured "
                             f"{prog.captured}, warm-up {prog.warmup}, "
                             f"wrapper calls {eager}, expected {per_it}")
    device = {k: prog.warmup[k] + v for k, v in prog.launches().items()}
    lgt_kernels.reset_launch_counts()
    bp, evp, secs_p = train_main(
        lgt, train, valid, rounds=QUANT_EFB_ROUNDS,
        extra={**QUANT_EFB_PARAMS, "superepoch": -1, "fused_chunk": 1,
               "fused_eval": "true"})
    torch.cuda.synchronize()
    per_counts = lgt_kernels.launch_counts()
    hold_launches("quant_efb per-iteration", per_counts,
                  times(per_it, QUANT_EFB_ROUNDS))
    text = without_path_params(bst.model_to_string())
    if without_path_params(bp.model_to_string()) != text:
        raise AssertionError("quant_efb: the per-iteration model text "
                             "differs from the super-epoch one")
    auc = ev["valid_0"]["auc"]
    if not 0.5 < auc[-1] <= 1.0 or not auc[-1] > auc[0]:
        raise AssertionError(f"quant_efb valid AUC {auc}")
    steady = m.epoch_ms[1:] if epochs > 1 else m.epoch_ms
    emit({"phase": "quant_efb", "params": QUANT_EFB_PARAMS,
          "iterations": n, "valid_auc": [auc[0], auc[-1]], "seconds": secs,
          "epoch_ms": m.epoch_ms,
          "epoch_ms_per_iteration": statistics.median(steady) / n,
          "per_iteration_seconds": secs_p, "same_model_text": True,
          "host_fetches": m.fetch_counts, "device_launches": device,
          "per_iteration_launches": per_counts})
    return {"quant_efb": device, "quant_efb_per_iteration": per_counts}


def objective_target(obj: str, x: np.ndarray, seed: int) -> np.ndarray:
    """A label in ``obj``'s domain from the HIGGS-shaped rows' hidden
    function: continuous for the L1 family, counts for poisson, positive
    for gamma, zero-inflated positive for tweedie, away from zero for mape,
    probabilities for the cross-entropy pair."""
    rng = np.random.RandomState(seed)
    base = (1.2 * x[:, 0] - 0.8 * x[:, 1] + 0.6 * x[:, 2] * x[:, 3]
            + 0.4 * np.abs(x[:, 4]) + 0.5 * rng.randn(len(x)))
    if obj == "poisson":
        y = rng.poisson(np.exp(0.4 * base))
    elif obj == "gamma":
        y = rng.gamma(2.0, np.exp(0.3 * base) / 2.0)
    elif obj == "tweedie":
        y = rng.poisson(np.exp(0.3 * base)) * rng.gamma(2.0, 1.0, len(x))
    elif obj == "mape":
        y = 10.0 + base
    elif obj in ("cross_entropy", "cross_entropy_lambda"):
        y = 1.0 / (1.0 + np.exp(-base))
    else:
        y = base
    return np.asarray(y, np.float32)


def phase_objectives_train(torch, lgt, lgt_kernels, train, x, y, xv):
    """objectives_train: each of the ten pointwise objectives
    (OBJECTIVES_FUSABLE, OBJECTIVES_RENEWING) for OBJ_ROUNDS rounds of the
    main path's tree shape on the HIGGS-shaped rows with a label in its
    domain (``objective_target``): the fusable ones as one super-epoch
    and on the per-iteration loop (equal model text), l1, quantile and
    mape on the per-iteration loop (their leaves renewed on the host:
    four fetches an iteration; the fused paths refuse them with the JAX
    package's reason); launches held to PER_ITERATION_NO_VALID;
    ``Booster.predict`` of the valid rows through the engine route equal
    to the host walk's, output transform included; the objective's own
    metric on the train rows better after OBJ_ROUNDS rounds than after
    one.  The train set's label is restored afterwards.  Returns the
    launches by path."""
    from lightgbm_torch.metrics import create_metric
    from lightgbm_torch.config import Config
    per_it = PER_ITERATION_NO_VALID
    out, by_path = {}, {}
    try:
        for i, obj in enumerate(OBJECTIVES_FUSABLE + OBJECTIVES_RENEWING):
            yo = objective_target(obj, x, 80 + i)
            train.set_label(yo)
            params = {**OBJ_PARAMS, "objective": obj}
            paths = {"per_iteration": {"superepoch": -1, "fused_chunk": 1}}
            if obj in OBJECTIVES_FUSABLE:
                paths["superepoch"] = {}
            texts, rec = {}, {"label_mean": float(yo.mean())}
            for path, extra in paths.items():
                lgt_kernels.reset_launch_counts()
                t0 = time.perf_counter()
                bst = lgt.train({**params, **extra}, train, OBJ_ROUNDS)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches = lgt_kernels.launch_counts()
                m = bst._model
                nit = m.num_iterations_trained
                if path == "superepoch":
                    prog = fused_program(m)
                    if m.fetch_counts != {"epoch": 1} \
                            or prog.captured != per_it \
                            or launches != times(per_it, 2):
                        raise AssertionError(
                            f"objectives_train {obj}: fetches "
                            f"{m.fetch_counts}, captured {prog.captured}, "
                            f"wrapper calls {launches}")
                    launches = {k: prog.warmup[k] + v
                                for k, v in prog.launches().items()}
                    rec["superepoch_epoch_ms_with_capture"] = \
                        m.epoch_ms[0]
                else:
                    want_f = {"tree": nit}
                    if obj in OBJECTIVES_RENEWING:
                        want_f["renew"] = 4 * nit
                        if not any("RenewTreeOutput" in r
                                   for r in bst.fused_reasons()):
                            raise AssertionError(f"{obj}: fused_reasons "
                                                 f"{bst.fused_reasons()}")
                    if launches != times(per_it, nit) \
                            or m.fetch_counts != want_f:
                        raise AssertionError(
                            f"objectives_train {obj}: launches {launches}"
                            f", fetches {m.fetch_counts}")
                    rec["per_iteration_seconds"] = secs
                    rec["per_iteration_ms_per_iteration"] = 1e3 * secs / nit
                texts[path] = without_path_params(bst.model_to_string())
                by_path[f"objectives_{obj}_{path}"] = launches
            if len(set(texts.values())) != 1:
                raise AssertionError(f"objectives_train {obj}: the paths "
                                     "wrote other model text")
            eng = bst.predict(xv)
            host = host_walk(bst, xv)
            if bst._engine_cache in (None, False) \
                    or not np.array_equal(eng, host) \
                    or not np.isfinite(eng).all():
                raise AssertionError(f"objectives_train {obj}: the engine "
                                     "route's predictions differ from the "
                                     "host walk's")
            metric = create_metric(Config(params).default_metric()[0],
                                   Config(params))
            metric.init(train.metadata, train.num_data)
            first = metric.eval(bst.predict(x, raw_score=True,
                                            num_iteration=1))[0]
            last = metric.eval(bst.predict(x, raw_score=True))[0]
            if not last[1] < first[1]:
                raise AssertionError(f"objectives_train {obj}: {first} -> "
                                     f"{last}")
            rec.update({"paths": sorted(paths), "metric": last[0],
                        "metric_round1": first[1], "metric_last": last[1],
                        "prediction_mean": float(eng.mean())})
            out[obj] = rec
    finally:
        train.set_label(y)
    emit({"phase": "objectives_train", "params": OBJ_PARAMS,
          "rounds": OBJ_ROUNDS, "objectives": out,
          "engine_equals_host_walk": True})
    return by_path


# ---------------------------------------------------------------------------
# serving (B10)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the split controls: monotone basic, interaction constraints,
# feature_contri and CEGB (B2/B2-cat's operands, B3s/B3s-K's state, B6-node
# drawing from each child's allowed features)
# ---------------------------------------------------------------------------

def _cons_config(params: dict, L: int):
    """The Config of the main path's training with ``params``."""
    from lightgbm_torch.config import Config
    return Config({"objective": "binary", "num_leaves": L,
                   "max_bin": MAX_BIN, "verbosity": -1, **params})


def _device_constraints(torch, train, params: dict, L: int):
    from lightgbm_torch import constraints as tc
    cfg = _cons_config(params, L)
    cegb = tc.make_cegb(cfg, train)
    return tc.device_constraints(
        L, torch.device("cuda", 0), mono=tc.monotone_vector(cfg, train),
        mono_penalty=cfg.monotone_penalty,
        contri=tc.contri_vector(cfg, train),
        groups=tc.interaction_allow(cfg, train), cegb=cegb)


def _split_variants(sp, cons):
    """B2's split controls of one call, each control alone and all
    together: name -> SplitConstraints."""
    if cons is None:
        return {}
    return {
        "mono_penalty": sp.SplitConstraints(
            mono=cons.mono, out_lo=cons.out_lo, out_hi=cons.out_hi,
            depth=cons.depth, factor=cons.factor),
        "contri": sp.SplitConstraints(contri=cons.contri),
        "cegb": sp.SplitConstraints(cegb_slope=cons.cegb_slope,
                                    cegb_coupled=cons.cegb_coupled,
                                    cuse=cons.cuse),
        "all": cons}


def _param_variants(prm):
    """The split parameters B2's controls are compared under: the
    grower's, with path smoothing (the monotone recompute's shift then
    takes the long form of leaf_gain) and with max_delta_step (the
    outputs clamped before the ranges clip them)."""
    return {"params": prm,
            "path_smooth": prm._replace(path_smooth=CONS_PATH_SMOOTH),
            "max_delta_step": prm._replace(
                max_delta_step=CONS_MAX_DELTA_STEP)}


def _same_state(torch, a, b) -> bool:
    return all(x is None or equal_bits(torch, x, y) for x, y in zip(a, b))


def _cons_tree(torch, gr, sp, rnd, binned, vals, fmask, num_bin, na_bin, B,
               L, K, params, cons, sampling, cat_flags, counts, snaps):
    """Grow one tree with the split controls on the card; at every live
    step hold B3s/B3s-K (tree, step outputs and the controls' state), B2
    and B2-cat (each control alone and all together, each under the
    grower's params, path_smooth and max_delta_step; B2-cat on the same
    children with ``cat_flags`` [F] bool as the categorical features) and
    B6-node (per-child bases) against their plain versions, bit for
    bit.  Keeps the
    middle live step's inputs in ``snaps``.  Returns the workspace."""
    dev = binned.device
    ws = gr.GrowWorkspace(binned.shape[0], num_bin.shape[0], B, L, dev,
                          split_batch=K, constraints=cons)
    it = torch.tensor([3], dtype=torch.int32, device=dev)
    real = {"grow_step": gr.grow_step,
            "grow_step_batched": gr.grow_step_batched,
            "find_best_split": gr.find_best_split,
            "node_draws": gr.node_draws}
    tag = "B3s" if K == 1 else "B3s-K"
    # the live step whose inputs are kept for timing
    mid = CONS_TIMED_STEP[K]
    state = {"live": 0}

    def step_both(table, tree, na, **kw):
        cs = kw["cons"]
        nl0 = int(tree[0])
        if K == 1:
            outs = ("rec", "idx", "fstep", "flags")
            kw_p = {k: (v.clone() if torch.is_tensor(v) else v)
                    for k, v in kw.items()}
        else:
            outs = ("step",)
            kw_p = dict(kw, step=gr.BatchedStep(*[t.clone()
                                                  for t in kw["step"]]))
        kw_p["cons"] = gr.StepConstraints(*[None if t is None else t.clone()
                                            for t in cs])
        tree_p = tree.clone()
        pre = None
        if "b3s" not in snaps.get(K, {}) and counts[tag] == mid:
            pre = {"table": table.clone(), "tree": tree.clone(),
                   "kw": {k: (v.clone() if torch.is_tensor(v) else v)
                          for k, v in kw_p.items()},
                   "cons": gr.StepConstraints(*[
                       None if t is None else t.clone() for t in cs])}
        (gr.grow_step_plain if K == 1 else gr.grow_step_batched_plain)(
            table, tree_p, na, **kw_p)
        real["grow_step" if K == 1 else "grow_step_batched"](
            table, tree, na, **kw)
        same = torch.equal(tree, tree_p) and _same_state(
            torch, cs, kw_p["cons"])
        for o in outs:
            a, b = kw[o], kw_p[o]
            same &= _same_state(torch, a, b) if o == "step" \
                else equal_bits(torch, a, b)
        if not same:
            raise AssertionError(f"{tag} with the split controls (step "
                                 f"{counts['steps'][K]}) differs from its "
                                 "plain version")
        counts["steps"][K] += 1
        live = int(tree[0]) > nl0
        state["live"] = live
        counts[tag] += int(live)
        if pre is not None and live:
            snaps.setdefault(K, {})["b3s"] = pre

    def split_both(hist, total, po, nb, na, fm, prm, active=None,
                   rand_bin=None, is_cat=None, cons=None):
        res = real["find_best_split"](hist, total, po, nb, na, fm, prm,
                                      active=active, rand_bin=rand_bin,
                                      is_cat=is_cat, cons=cons)
        if active is not None and not bool(active[0]):
            return res
        args = (hist.clone(), total.clone(), po.clone(), nb, na, fm.clone(),
                prm)
        for cat in (None, cat_flags):
            for (name, c), (pname, pv) in itertools.product(
                    _split_variants(sp, cons).items(),
                    _param_variants(prm).items()):
                va = args[:-1] + (pv,)
                r_k = real["find_best_split"](*va, rand_bin=rand_bin,
                                              is_cat=cat, cons=c)
                r_p = sp.find_best_split_plain(*va, rand_bin=rand_bin,
                                               is_cat=cat, cons=c)
                r_k = r_k if cat is not None else (r_k,)
                r_p = r_p if cat is not None else (r_p,)
                if not all(equal_bits(torch, a, b)
                           for a, b in zip(r_k, r_p)):
                    raise AssertionError(
                        f"B2{'-cat' if cat is not None else ''} ({name}, "
                        f"{pname}, {hist.shape[0]} children) differs from "
                        "its plain version")
                counts["B2" if cat is None else "B2-cat"] += 1
            if "b2" not in snaps.get(K, {}) and hist.shape[0] == \
                    (2 if K == 1 else 2 * K) and state["live"] \
                    and counts[tag] == mid + 1:
                snaps.setdefault(K, {})["b2"] = {
                    "args": args, "rand_bin": rand_bin,
                    "cons": sp.SplitConstraints(*[
                        None if t is None else t.clone() for t in cons])}
        return res

    def draws_both(base, nb, rng_iter, *, masks, bins, active=None, **kw):
        if active is not None and not bool(active[0]):
            return real["node_draws"](base, nb, rng_iter, masks=masks,
                                      bins=bins, active=active, **kw)
        base_c = base.clone()
        real["node_draws"](base, nb, rng_iter, masks=masks, bins=bins,
                           active=active, **kw)
        mp, bp = rnd.node_draws_plain(base_c, nb, rng_iter, **kw)
        if not torch.equal(masks, mp) or (
                kw["sampling"].extra_trees and not torch.equal(bins, bp)):
            raise AssertionError(f"B6-node ({masks.shape[0]} children, "
                                 "per-child bases) differs from its plain "
                                 "version")
        if base.dim() == 2 and bool((masks & ~base).any()):
            raise AssertionError("B6-node drew a feature outside its "
                                 "child's allowed set")
        counts["B6-node"] += 1
        if "b6" not in snaps.get(K, {}) and base.dim() == 2 and \
                masks.shape[0] == 2 * K and counts[tag] == mid + 1:
            snaps.setdefault(K, {})["b6"] = {
                "base": base_c, "it": rng_iter.clone(), "kw": kw}

    gr.grow_step, gr.grow_step_batched = step_both, step_both
    gr.find_best_split, gr.node_draws = split_both, draws_both
    try:
        grow = gr.grow_tree if K == 1 else gr.grow_tree_batched
        kw = {} if K == 1 else {"split_batch": K}
        ws.cuse.zero_()
        grow(binned, vals, fmask, num_bin, na_bin, num_leaves=L, num_bins=B,
             params=params, workspace=ws, sampling=sampling, rng_iter=it,
             constraints=cons, **kw)
    finally:
        gr.grow_step, gr.grow_step_batched = real["grow_step"], \
            real["grow_step_batched"]
        gr.find_best_split, gr.node_draws = real["find_best_split"], \
            real["node_draws"]
    torch.cuda.synchronize()
    return ws


def phase_constraint_kernels(torch, lgt, train):
    """The kernels the split controls extend (B2, B2-cat, B3s, B3s-K,
    B6-node) against their plain versions bit for bit at every live step
    of a 31-leaf strict tree and a 255-leaf K = 16 tree with bynode 0.5,
    grown with CONS_PARAMS (CONS_WIDE_PARAMS) on the 1M x 28 rows; the
    vals are iteration
    0's binary gradients (g = 0.5 - y, h = 0.25), so every histogram and
    prefix sum is exact in f32 and the plain versions' other summation
    orders give the same bits.  Both trees grown twice: the reruns
    bitwise.  Each kernel timed on its middle live step's inputs beside
    its plain version (B2 also without the controls, on the same
    inputs), with the bound of that call's bytes and operations."""
    from lightgbm_torch import grower as gr
    from lightgbm_torch.ops import random as rnd
    from lightgbm_torch.ops import split as sp
    dev = torch.device("cuda", 0)
    binned = torch.as_tensor(train.binned).to(dev)
    n, f = binned.shape
    B = int(train.max_bin)
    mappers = [train.bin_mappers[i] for i in train.used_features]
    num_bin = torch.tensor([m.num_bin for m in mappers], dtype=torch.int32,
                           device=dev)
    na_bin = torch.tensor([m.na_bin for m in mappers], dtype=torch.int32,
                          device=dev)
    y = torch.as_tensor(np.asarray(train.metadata.label, np.float32)).to(dev)
    vals = torch.stack([0.5 - y, torch.full_like(y, 0.25),
                        torch.ones_like(y)], dim=1).contiguous()
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    fmask[13] = False
    is_cat = torch.zeros(f, dtype=torch.bool, device=dev)
    is_cat[20:] = True
    params = sp.SplitParams(min_data_in_leaf=20)
    counts = {"B2": 0, "B2-cat": 0, "B3s": 0, "B3s-K": 0, "B6-node": 0,
              "steps": {1: 0, WIDE_K: 0}}
    snaps, trees = {}, {}
    for L, K, cparams in ((NUM_LEAVES, 1, CONS_PARAMS),
                          (WIDE_LEAVES, WIDE_K, CONS_WIDE_PARAMS)):
        cons = _device_constraints(torch, train, cparams, L)
        sampling = rnd.NodeSampling(bynode_frac=0.5, bynode_seed=3) \
            if K > 1 else None
        words = []
        for rerun in range(2):
            ws = _cons_tree(torch, gr, sp, rnd, binned, vals, fmask,
                            num_bin, na_bin, B, L, K, params, cons, sampling,
                            is_cat, counts, snaps)
            words.append([ws.tree.clone(), ws.olo.clone(), ws.fallow.clone(),
                          ws.cuse.clone()])
        if not all(torch.equal(a, b) for a, b in zip(*words)):
            raise AssertionError(f"the {L}-leaf tree with the split "
                                 "controls differs on a rerun")
        t = gr.fetch_tree(ws)
        feats = set(int(v) for v in t.split_feature[:t.num_leaves - 1])
        if t.num_leaves < L // 2 or 13 in feats:
            raise AssertionError(f"the {L}-leaf tree: {t.num_leaves} "
                                 f"leaves, features {sorted(feats)}")
        trees[L] = {"leaves": t.num_leaves, "features": sorted(feats),
                    "cuse": int(ws.cuse.sum())}
        snaps[K]["ws"], snaps[K]["cons"] = ws, cons
    if min(counts["B2"], counts["B2-cat"], counts["B3s"], counts["B3s-K"],
           counts["B6-node"]) < 1:
        raise AssertionError(f"a kernel was not compared: {counts}")

    rows = []
    # B2 with every control on the strict tree's timed step (2 children),
    # B2-cat on the wide tree's (2K = 32 children)
    for K, key, cat in ((1, "split", None), (WIDE_K, "split_cat", is_cat)):
        s = snaps[K]["b2"]
        args, cons, rb = s["args"], s["cons"], s["rand_bin"]
        C = args[0].shape[0]
        cand = 2 * C * f * B
        cons_bytes = C * 12 + 4 * f * 4 + f + f * 4

        def kern(c=cons, cat=cat):
            return sp.find_best_split(*args, rand_bin=rb, is_cat=cat,
                                      cons=c)

        def plain(c=cons, cat=cat):
            return sp.find_best_split_plain(*args, rand_bin=rb,
                                            is_cat=cat, cons=c)
        t_k = median_ms(torch, kern)
        t_p = median_ms(torch, plain)
        t_u = median_ms(torch, lambda: kern(None))
        r_k, r_p = kern(), plain()
        r_k = r_k if cat is not None else (r_k,)
        r_p = r_p if cat is not None else (r_p,)
        err = exact_err(torch, zip(r_k, r_p), f"{key} with the "
                        "controls (timed call)")
        nbytes = args[0].numel() * 4 + C * 16 + 2 * f * 4 + C * f \
            + cons_bytes + C * sp.RECORD * 4 \
            + (0 if cat is None else C * B * 4 + f)
        ops = 60 * cand if cat is None else 60 * cand + 2 * C * f * B * B
        name = "B2 split scan" if cat is None else "B2-cat scan"
        rows.append((f"{key}_cons",
                     f"{name} with monotone clamps, penalty, contri "
                     f"and CEGB ({C} children)",
                     "lightgbm_torch/csrc/split.cu",
                     "lightgbm_tpu/ops/split.py:301" if cat is None
                     else "lightgbm_tpu/ops/split.py:401", err, t_k, t_p,
                     bound_ms(nbytes, ops), None,
                     {"unconstrained_ms": t_u}))
    # B3s and B3s-K with the controls' state on the timed step
    for K, key, fn_k, fn_p in ((1, "grow_step_cons", gr.grow_step,
                                gr.grow_step_plain),
                               (WIDE_K, "grow_step_batched_cons",
                                gr.grow_step_batched,
                                gr.grow_step_batched_plain)):
        s = snaps[K]["b3s"]
        L = NUM_LEAVES if K == 1 else WIDE_LEAVES
        table, tree0, cons0 = s["table"], s["tree"], s["cons"]
        tree = tree0.clone()
        kw = dict(s["kw"])
        live_cons = gr.StepConstraints(*[None if t is None else t.clone()
                                         for t in cons0])
        kw["cons"] = live_cons

        def call(fn, reset_state=False, kw=kw, tree=tree, tree0=tree0,
                 table=table, cons0=cons0, live_cons=live_cons):
            tree.copy_(tree0)
            if reset_state:
                for a, b in zip(live_cons, cons0):
                    if a is not None:
                        a.copy_(b)
            fn(table, tree, na_bin, **kw)
        # timed from the step's tree (its reset copy in the time); the
        # controls' state is overwritten by each call, the same work
        t_k = median_ms(torch, lambda: call(fn_k))
        t_p = median_ms(torch, lambda: call(fn_p))
        call(fn_k, True)
        got_k = [tree.clone()] + [t.clone() for t in live_cons
                                  if t is not None]
        call(fn_p, True)
        got_p = [tree] + [t for t in live_cons if t is not None]
        err = exact_err(torch, zip(got_k, got_p), f"{key} (the timed "
                        "step)")
        state_bytes = sum(t.numel() * t.element_size() for t in cons0
                          if t is not None)
        nbytes = table.numel() * 4 + 2 * tree0.numel() * 4 + 2 * state_bytes
        g = int(cons0.groups.shape[0])
        rows.append((key, ("B3s split step" if K == 1 else
                           "B3s-K batched split step")
                     + " with monotone ranges, branch sets and CEGB marks",
                     "lightgbm_torch/csrc/grow_step.cu",
                     "lightgbm_tpu/grower.py:819" if K == 1 else
                     "lightgbm_tpu/grower.py:1094", err, t_k, t_p,
                     bound_ms(nbytes, L * L + 3 * K * g * f), None, {}))
    # B6-node with per-child bases on the wide tree's middle super-step
    s = snaps[WIDE_K]["b6"]
    base, it6, kw6 = s["base"], s["it"], s["kw"]
    C = base.shape[0]
    mk = torch.zeros((C, f), dtype=torch.bool, device=dev)
    bk = torch.zeros((C, f), dtype=torch.int32, device=dev)
    t_k = median_ms(torch, lambda: rnd.node_draws(base, num_bin, it6,
                                                  masks=mk, bins=bk, **kw6))
    t_p = median_ms(torch, lambda: rnd.node_draws_plain(base, num_bin, it6,
                                                        **kw6))
    mp, _ = rnd.node_draws_plain(base, num_bin, it6, **kw6)
    err = exact_err(torch, [(mk, mp)], "B6-node per-child bases (timed "
                    "call)")
    rows.append(("node_draws_base", "B6-node per-child subsets drawn from "
                 f"each child's allowed features ({C} children)",
                 "lightgbm_torch/csrc/sample.cu",
                 "lightgbm_tpu/grower.py:495", err, t_k, t_p,
                 bound_ms(C * f + 4 * f + 4 + C * f,
                          C * f * (THREEFRY_OPS
                                   + int(np.ceil(np.log2(f))) + 1)), None,
                 {}))
    out = {}
    for key, name, src_path, replaces, e, tk, tp, (bms, by), tl, more \
            in rows:
        out[key] = {"name": name, "route": "cuda", "source": src_path,
                    "replaces": replaces, "max_abs_err": e, "ms": tk,
                    "plain_ms": tp, "bound_ms": bms, "bound_by": by,
                    "library_ms": tl}
        emit({"phase": "kernel", **out[key], "kernel_ms": tk, **more})
    emit({"phase": "constraint_kernels", "compared_bitwise": {
        k: v for k, v in counts.items() if k != "steps"},
        "steps": {str(k): v for k, v in counts["steps"].items()},
        "trees": {str(k): v for k, v in trees.items()},
        "reruns_bitwise": True})
    return out


def _sweep_violations(bst, train, xv, rows: int, mono=CONS_MONO) -> dict:
    """Monotone violations of ``Booster.predict`` (raw scores) over
    ``rows`` valid rows, each swept across every feature's finite bin
    bounds that ``mono`` constrains: consecutive predictions that move
    against the constraint, by feature."""
    out = {}
    base = np.ascontiguousarray(xv[:rows], np.float32)
    for j, sign in enumerate(mono):
        if sign == 0:
            continue
        ub = train.bin_mappers[j].bin_upper_bound
        grid = np.asarray(ub[np.isfinite(ub)], np.float32)
        grid = np.concatenate([[grid[0] - 1.0], grid])
        x = np.repeat(base, len(grid), axis=0)
        x[:, j] = np.tile(grid, rows)
        p = np.asarray(bst.predict(x, raw_score=True)).reshape(
            rows, len(grid))
        d = np.diff(p, axis=1)
        out[str(j)] = int((d < 0).sum() if sign > 0 else (d > 0).sum())
    return out


def _interaction_violations(bst) -> int:
    """Root-to-leaf paths whose features lie in no one group of
    CONS_INTER."""
    groups = [set(g) for g in CONS_INTER]
    bad = 0
    for t in bst._model.models:
        if t.num_leaves <= 1:
            continue
        stack = [(0, frozenset())]
        while stack:
            node, feats = stack.pop()
            if node < 0:
                bad += not any(feats <= g for g in groups)
                continue
            f2 = feats | {int(t.split_feature[node])}
            stack += [(int(t.left_child[node]), f2),
                      (int(t.right_child[node]), f2)]
    return bad


def _features_used(bst) -> set:
    out = set()
    for t in bst._model.models:
        out |= set(int(v) for v in t.split_feature[:t.num_leaves - 1])
    return out


def constraint_after(torch, lgt, lgt_kernels, train, valid, xv, params,
                     per_it, rounds, plain_steady, twin=None):
    """More checks of a constraint_train super-epoch model: no monotone
    violation over CONS_SWEEP_ROWS swept valid rows, no interaction
    violation, fewer distinct features than the same run without CEGB,
    each CEGB penalty alone changing the first tree (per-iteration runs
    of one round), and the steady it/s beside the unconstrained runs'
    (``plain_steady``: name -> it/s; ``twin``: the params of the same
    run without the four controls, trained here as super-epochs with
    launches held to ``per_it``)."""
    cegb_keys = ("cegb_penalty_split", "cegb_penalty_feature_coupled")

    def after(bst, prog):
        mono = _sweep_violations(bst, train, xv, CONS_SWEEP_ROWS)
        inter = _interaction_violations(bst)
        if any(mono.values()) or inter:
            raise AssertionError(f"constraint violations: monotone "
                                 f"{mono}, interaction paths {inter}")
        no_cegb = {k: v for k, v in params.items() if k not in cegb_keys}
        b0, _, _ = train_main(lgt, train, valid, extra=no_cegb,
                              rounds=rounds)
        used, used0 = _features_used(bst), _features_used(b0)
        if not len(used) < len(used0):
            raise AssertionError(f"CEGB: {len(used)} features used, "
                                 f"{len(used0)} without it")
        one = {**no_cegb, "superepoch": -1, "fused_chunk": 1}
        first = {}
        for name, extra in (("none", {}), *(
                (k, {k: params[k]}) for k in cegb_keys)):
            b1, _, _ = train_main(lgt, train, valid, extra={**one, **extra},
                                  rounds=1)
            first[name] = tree_sections(b1.model_to_string(), 1)
        if any(first[k] == first["none"] for k in cegb_keys):
            raise AssertionError("a CEGB penalty alone leaves the first "
                                 "tree as it is")
        out = {"monotone_violations": mono,
               "interaction_violations": inter,
               "features_used": len(used),
               "features_used_without_cegb": len(used0),
               "cegb_each_changes_first_tree": True,
               "steady_iterations_per_s_unconstrained": dict(plain_steady)}
        if twin is not None:
            lgt_kernels.reset_launch_counts()
            bt, _, _ = train_main(lgt, train, valid, extra=twin,
                                  rounds=rounds)
            pt = fused_program(bt._model)
            if pt.captured != per_it:
                raise AssertionError(f"the unconstrained twin's launches "
                                     f"{pt.captured}, expected {per_it}")
            st = bt._model.epoch_ms[1:] or bt._model.epoch_ms
            k = max(2, min(25, ES_ROUNDS))
            out["steady_iterations_per_s_unconstrained"]["twin"] = \
                1e3 * k / statistics.median(st)
        return out
    return after


def _segment_library(torch, binned, vals, order, begin, count, B):
    """``index_add_`` of a segment's gathered rows over precomputed (f*B +
    bin) cells: one library call computing B11a's sums, timed."""
    f = binned.shape[1]
    idx_rows = order[begin:begin + count].to(torch.int64)
    cells = (binned.index_select(0, idx_rows).to(torch.int64)
             + torch.arange(f, device=binned.device) * B).reshape(-1)
    src = vals.index_select(0, idx_rows)
    src = (src.to(torch.int32) if src.dtype != torch.float32 else src) \
        .repeat_interleave(f, dim=0)
    acc = torch.zeros((f * B, 3), dtype=src.dtype, device=binned.device)
    return median_ms(torch, lambda: acc.zero_().index_add_(0, cells, src))


def segment_pass_bound(count: int, f: int, B: int, val_bytes: int):
    """B11a's least time: the segment's ids (4 B), its rows of the matrix
    (f B) and of vals, and the histogram written."""
    return bound_ms(count * (4 + f + val_bytes) + f * B * 12, 3 * count * f)


def phase_partitioned_kernels(torch, lgt, train):
    """B11a (f32 and int8), B11b, B11c and B2's mono_bounds form against
    their plain versions at the main path's shapes (1M x 28, 63 bins):
    B11a on the root segment and on a small segment of PART_SMALL_ROWS
    rows of a permuted order (f32 also on segments of 1 and 33 rows, with
    the scale the root pass computed), f32 within HIST_RTOL of the largest
    bin (random-score gradients), bitwise on a rerun and with its own
    scale, NaN / +-Inf rows giving exactly the plain version's non-finite
    cells, int8 exact; B11b on
    the root split and on a mid-tree segment with an NA bin and with a
    categorical rank vector, order and left count bitwise; B11c on a
    finished partitioned tree's segment table, bitwise; B2 (and B2-cat)
    with the mono_bounds, the per-leaf CEGB penalty, the monotone penalty
    and contri on two children of exact histograms, bitwise under the
    default parameters, path_smooth CONS_PATH_SMOOTH and max_delta_step
    CONS_MAX_DELTA_STEP.  Each timed beside its plain version, its bound
    and a library call where one computes it."""
    from lightgbm_torch import grower_partitioned as gp
    from lightgbm_torch.ops import segment as seg
    from lightgbm_torch.ops import split as sp
    from lightgbm_torch.ops.quantize import (QuantSpec, quant_scales,
                                             quantize_stack)
    dev = torch.device("cuda", 0)
    binned = torch.as_tensor(train.binned).to(dev)
    n, f = binned.shape
    B = int(train.max_bin)
    mappers = [train.bin_mappers[i] for i in train.used_features]
    num_bin = np.asarray([m.num_bin for m in mappers], np.int32)
    na_bin = np.asarray([m.na_bin for m in mappers], np.int32)
    y = torch.as_tensor(np.asarray(train.metadata.label, np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
    vals = torch.stack([p - y, p * (1 - p), torch.ones_like(y)],
                       dim=1).contiguous()
    spec = QuantSpec(bits=8, stochastic=True, seed=0)
    qvals = quantize_stack(vals, quant_scales(vals, spec.qmax), spec,
                           torch.zeros(1, dtype=torch.int32, device=dev))
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    perm = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
    small = (123_457, PART_SMALL_ROWS)
    rows, checked = [], {"B11a": 0, "B11a-int": 0, "B11b": 0, "B11c": 0,
                         "B2 mono_bounds": 0}

    # B11a: f32 and int8, the root segment and a small one (f32 also
    # segments of 1 and 33 rows), the f32 scale computed by the root pass
    # and handed to the others, as the learner does
    times_a, nonfin_a = {}, {}
    scale_a = seg.new_scale(dev)
    for key, v, vb in (("segment_histogram", vals, 12),
                       ("segment_histogram_int", qvals, 3)):
        errs = []
        f32 = v.dtype == torch.float32
        segs = (("root", iota, (0, n)), ("small", perm, small))
        if f32:
            segs += (("one", perm, (5, 1)),
                     ("thirty_three", perm, (999_000, 33)))
        for what, order, (begin, count) in segs:
            kw = dict(num_bins=B)
            if f32:
                kw.update(scale=scale_a, fill_scale=what == "root")
            h_k = seg.segment_histogram(binned, v, order, begin, count, **kw)
            h_p = seg.segment_histogram_plain(binned, v, order, begin, count,
                                              num_bins=B)
            if f32:
                kw["fill_scale"] = False
            h_k2 = seg.segment_histogram(binned, v, order, begin, count,
                                         **kw)
            torch.cuda.synchronize()
            if not torch.equal(h_k, h_k2):
                raise AssertionError(f"B11a ({key}, {what}) is not bitwise "
                                     "reproducible")
            if f32:
                err = float((h_k - h_p).abs().max())
                scale = float(h_p.abs().max())
                if not torch.equal(h_k[..., 2], h_p[..., 2]) \
                        or err > HIST_RTOL * max(1.0, scale):
                    raise AssertionError(f"B11a ({what}) max abs error "
                                         f"{err} (scale {scale})")
                # its own scale (a pass that computes it) gives the bits
                if not same_bits(torch, h_k, seg.segment_histogram(
                        binned, v, order, begin, count, num_bins=B)):
                    raise AssertionError(f"B11a ({what}): the handed scale "
                                         "and its own differ")
                seg_rows = order[begin:begin + count].long()
                nonfin_a[what] = check_nonfinite(
                    torch, lambda pv: seg.segment_histogram(
                        binned, pv, order, begin, count, num_bins=B),
                    lambda pv: seg.segment_histogram_plain(
                        binned, pv, order, begin, count, num_bins=B),
                    vals, (seg_rows.tolist() * 5)[:5], f"B11a ({what})")
                errs.append(err)
            else:
                errs.append(exact_err(torch, [(h_k, h_p)],
                                      f"B11a-int ({what})"))
            checked["B11a" if f32 else "B11a-int"] += 1
            if what not in ("root", "small"):
                continue
            t_k = median_ms(torch, lambda: seg.segment_histogram(
                binned, v, order, begin, count, **kw))
            t_p = median_ms(torch, lambda: seg.segment_histogram_plain(
                binned, v, order, begin, count, num_bins=B))
            t_l = _segment_library(torch, binned, v, order, begin, count, B)
            times_a[(key, what)] = (t_k, t_p, t_l,
                                    segment_pass_bound(count, f, B, vb))
        tk, tp, tl, (bms, by) = times_a[(key, "root")]
        sk, spp, sl, (sbms, _) = times_a[(key, "small")]
        rows.append((key, "B11a segment histogram" + (
            "" if v.dtype == torch.float32 else ", int8 packed vals, exact "
            "int32") + " (root segment of 1M rows; small_* a 7,500-row "
            "segment)", "lightgbm_torch/csrc/segment.cu",
            "lightgbm_tpu/grower_partitioned.py:55", max(errs), tk, tp,
            (bms, by), tl, {"small_ms": sk, "small_plain_ms": spp,
                            "small_library_ms": sl, "small_bound_ms": sbms,
                            **({"nonfinite_cells": nonfin_a} if f32
                               else {})}))

    # B11b: the root split, then a mid-tree segment with an NA bin (the
    # feature's top bin taken as NA) and with a categorical rank vector
    rank_iota = torch.arange(B, dtype=torch.int32, device=dev)
    rank_perm = torch.randperm(B, device=dev, generator=gen).to(torch.int32)
    mid = (250_000, 400_000)
    order0 = perm.clone()
    cases = (("root", iota, (0, n), dict(col=0, na_bin=int(na_bin[0]),
                                         goff=-1, nbm1=int(num_bin[0]) - 1,
                                         threshold=int(num_bin[0]) // 2,
                                         default_left=False,
                                         rank=rank_iota)),
             ("mid_na", order0, mid, dict(col=3, na_bin=int(num_bin[3]) - 1,
                                          goff=-1, nbm1=int(num_bin[3]) - 1,
                                          threshold=int(num_bin[3]) // 3,
                                          default_left=True,
                                          rank=rank_iota)),
             ("mid_categorical", order0, mid, dict(
                 col=7, na_bin=-1, goff=-1, nbm1=int(num_bin[7]) - 1,
                 threshold=B // 2, default_left=False, rank=rank_perm)))
    scratch = torch.empty(n, dtype=torch.int32, device=dev)
    err_b, lefts = 0.0, {}
    for what, base, (begin, count), kw in cases:
        ok_, op_ = base.clone(), base.clone()
        lk = seg.partition_segment(binned, ok_, begin, count,
                                   scratch=scratch, **kw)
        lp = seg.partition_segment_plain(binned, op_, begin, count, **kw)
        err_b = max(err_b, exact_err(torch, [(ok_, op_), (lk, lp)],
                                     f"B11b ({what})"))
        lefts[what] = int(lk[0])
        if not 0 < lefts[what] < count:
            raise AssertionError(f"B11b ({what}) moves every row one way")
        checked["B11b"] += 1
    # timed on the root split; each call restores the identity order (a
    # 4 MB copy, counted in both times)
    work = iota.clone()
    root_kw = cases[0][3]
    t_k = median_ms(torch, lambda: seg.partition_segment(
        binned, work.copy_(iota), 0, n, scratch=scratch, **root_kw))
    t_p = median_ms(torch, lambda: seg.partition_segment_plain(
        binned, work.copy_(iota), 0, n, **root_kw))
    # bound: what the function needs, each id and its column byte read
    # once and each id written once (9 B a row), not this design's passes
    rows.append(("partition_segment", "B11b stable segment partition "
                 "(the root split of 1M rows)",
                 "lightgbm_torch/csrc/segment.cu",
                 "lightgbm_tpu/grower_partitioned.py:69", err_b, t_k, t_p,
                 bound_ms(9 * n, 6 * n), None, {"left_counts": lefts}))

    # B11c on a finished partitioned tree: grow one 31-leaf tree and read
    # its segment table back from the order and the row -> leaf vector
    grower = gp.PartitionedGrower(
        num_leaves=NUM_LEAVES, num_bins=B, params=sp.SplitParams(),
        num_bin=num_bin, na_bin=na_bin, device=dev)
    exact = torch.stack([0.5 - y, torch.full_like(y, 0.25),
                         torch.ones_like(y)], dim=1).contiguous()
    arrays = grower.grow(binned, exact, np.ones(f, bool))
    order = grower._order
    lor_tree = arrays.leaf_of_row.clone()
    by_pos = lor_tree.index_select(0, order.to(torch.int64)).cpu().numpy()
    starts = np.concatenate([[0], np.nonzero(np.diff(by_pos))[0] + 1])
    seg_begin = torch.as_tensor(starts.astype(np.int32)).to(dev)
    seg_leaf = torch.as_tensor(by_pos[starts].astype(np.int32)).to(dev)
    if len(starts) != int(arrays.num_leaves[0]):
        raise AssertionError("the tree's segments are not its leaves")
    out_k = torch.empty(n, dtype=torch.int32, device=dev)
    seg.leaf_of_row(order, seg_begin, seg_leaf, out=out_k)
    err_c = exact_err(torch, [(out_k, seg.leaf_of_row_plain(
        order, seg_begin, seg_leaf)), (out_k, lor_tree)], "B11c")
    checked["B11c"] += 1
    t_k = median_ms(torch, lambda: seg.leaf_of_row(order, seg_begin,
                                                   seg_leaf, out=out_k))
    t_p = median_ms(torch, lambda: seg.leaf_of_row_plain(order, seg_begin,
                                                         seg_leaf))
    S = len(starts)
    rows.append(("leaf_of_row", f"B11c leaf of row ({S} segments, 1M rows)",
                 "lightgbm_torch/csrc/segment.cu",
                 "lightgbm_tpu/grower_partitioned.py:103", err_c, t_k, t_p,
                 bound_ms(8 * n + 8 * S, n * int(np.ceil(np.log2(S + 1)))),
                 None, {}))

    # B2's mono_bounds form with every control: the root split's two
    # children of exact histograms (iteration 0's gradients)
    h0 = seg.segment_histogram(binned, exact, iota, 0, n, num_bins=B)
    lo_cnt = lefts["root"]
    order_r = iota.clone()
    seg.partition_segment(binned, order_r, 0, n, scratch=scratch,
                          **root_kw)
    h_l = seg.segment_histogram(binned, exact, order_r, 0, lo_cnt,
                                num_bins=B)
    pair = torch.stack([h_l, h0 - h_l]).contiguous()
    tot = pair[:, 0].sum(dim=1).contiguous()
    po = torch.tensor([0.01, -0.02], device=dev)
    rs = np.random.RandomState(3)
    C = 2

    def bnd(lo):
        a = np.where(rs.rand(C, f, B) < 0.5, np.inf if not lo else -np.inf,
                     (-1 if lo else 1) * 0.3 * rs.rand(C, f, B))
        return torch.as_tensor(a.astype(np.float32)).to(dev)
    mono = torch.as_tensor(np.asarray(CONS_MONO, np.int8)).to(dev)
    fmax = float(np.finfo(np.float32).max)
    from lightgbm_torch.constraints import monotone_penalty_factor
    cons = sp.SplitConstraints(
        mono=mono, out_lo=torch.full((C,), -fmax, device=dev),
        out_hi=torch.full((C,), fmax, device=dev),
        depth=torch.tensor([1, 1], dtype=torch.int32, device=dev),
        factor=torch.as_tensor(monotone_penalty_factor(
            1.0, np.arange(NUM_LEAVES + 1))).to(dev),
        contri=torch.as_tensor(np.asarray(CONS_PARAMS["feature_contri"],
                                          np.float32)).to(dev),
        penalty=torch.as_tensor((rs.rand(C, f) * 50).astype(
            np.float32)).to(dev),
        lo_l=bnd(True), hi_l=bnd(False), lo_r=bnd(True), hi_r=bnd(False))
    nb_d = torch.as_tensor(num_bin).to(dev)
    na_d = torch.as_tensor(na_bin).to(dev)
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    is_cat = torch.zeros(f, dtype=torch.bool, device=dev)
    is_cat[20:] = True
    prm = sp.SplitParams(min_data_in_leaf=20)
    err_2 = 0.0
    for pname, pv in _param_variants(prm).items():
        for cat in (None, is_cat):
            r_k = sp.find_best_split(pair, tot, po, nb_d, na_d, fmask, pv,
                                     is_cat=cat, cons=cons)
            r_p = sp.find_best_split_plain(pair, tot, po, nb_d, na_d, fmask,
                                           pv, is_cat=cat, cons=cons)
            r_k = r_k if cat is not None else (r_k,)
            r_p = r_p if cat is not None else (r_p,)
            err_2 = max(err_2, exact_err(torch, zip(r_k, r_p),
                                         f"B2 mono_bounds ({pname}, "
                                         f"{'cat' if cat is not None else 'num'})"))
            checked["B2 mono_bounds"] += 1
    t_k = median_ms(torch, lambda: sp.find_best_split(
        pair, tot, po, nb_d, na_d, fmask, prm, cons=cons))
    t_p = median_ms(torch, lambda: sp.find_best_split_plain(
        pair, tot, po, nb_d, na_d, fmask, prm, cons=cons))
    t_u = median_ms(torch, lambda: sp.find_best_split(
        pair, tot, po, nb_d, na_d, fmask, prm))
    cand = 2 * C * f * B
    nbytes = pair.numel() * 4 + C * 16 + 2 * f * 4 + f + C * 12 \
        + 4 * C * f * B * 4 + C * f * 4 + 2 * f * 4 + C * sp.RECORD * 4
    rows.append(("split_mono_bounds", "B2 split scan with mono_bounds "
                 "(advanced), per-leaf CEGB penalty, monotone penalty and "
                 "contri (2 children)", "lightgbm_torch/csrc/split.cu",
                 "lightgbm_tpu/ops/split.py:301", err_2, t_k, t_p,
                 bound_ms(nbytes, 60 * cand), None,
                 {"unconstrained_ms": t_u}))
    out = {}
    for key, name, src_path, replaces, e, tk, tp, (bms, by), tl, more \
            in rows:
        out[key] = {"name": name, "route": "cuda", "source": src_path,
                    "replaces": replaces, "max_abs_err": e, "ms": tk,
                    "plain_ms": tp, "bound_ms": bms, "bound_by": by,
                    "library_ms": tl}
        emit({"phase": "kernel", **out[key], "kernel_ms": tk, **more})
    emit({"phase": "partitioned_kernels", "compared": checked,
          "tree_leaves": int(arrays.num_leaves[0])})
    return out


def check_b11b_efb(torch, train):
    """B11b on an EFB-bundled matrix: the root segment partitioned by a
    bundled feature through its group column and offset, order and left
    count bitwise against the plain version, timed."""
    from lightgbm_torch.ops import segment as seg
    dev = torch.device("cuda", 0)
    efb = train.efb
    binned = torch.as_tensor(np.ascontiguousarray(train.binned)).to(dev)
    n = binned.shape[0]
    mappers = [train.bin_mappers[i] for i in train.used_features]
    bundled = [j for j in range(len(mappers)) if efb.off_of_feat[j] >= 0]
    j = max(bundled, key=lambda k: mappers[k].num_bin)
    nb = int(mappers[j].num_bin)
    kw = dict(col=int(efb.group_of_feat[j]), na_bin=int(mappers[j].na_bin),
              goff=int(efb.off_of_feat[j]), nbm1=nb - 1, threshold=0,
              default_left=False,
              rank=torch.arange(int(train.max_bin), dtype=torch.int32,
                                device=dev))
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    ok_, op_ = iota.clone(), iota.clone()
    lk = seg.partition_segment(binned, ok_, 0, n, **kw)
    lp = seg.partition_segment_plain(binned, op_, 0, n, **kw)
    exact_err(torch, [(ok_, op_), (lk, lp)], "B11b on the EFB group column")
    if not 0 < int(lk[0]) < n:
        raise AssertionError("B11b (EFB) moves every row one way")
    work = iota.clone()
    t_k = median_ms(torch, lambda: seg.partition_segment(
        binned, work.copy_(iota), 0, n, **kw))
    emit({"phase": "kernel_check", "kernel": "partition_segment",
          "case": "EFB group column", "feature": j, "group": kw["col"],
          "offset": kw["goff"], "left_count": int(lk[0]), "rows": n,
          "ms": t_k, "bitwise": True})


def _train_partitioned(lgt, train, valid, params, rounds, es=True):
    """One partitioned run on the per-iteration loop (binary, MAX_BIN,
    learning_rate 0.1, auc and logloss on the valid set by the traced
    metrics, ``fused_eval=true``, as phase_per_iteration runs the masked
    twin; phase timer on): (booster, evals, per-iteration clock)."""
    ev = {}
    clock = _IterClock()
    cbs = [lgt.record_evaluation(ev), clock, _attach_timer]
    if es:
        cbs.insert(0, lgt.early_stopping(ES_ROUNDS, first_metric_only=True,
                                         verbose=False))
    p = {"objective": "binary", "num_leaves": NUM_LEAVES,
         "max_bin": MAX_BIN, "learning_rate": 0.1, "metric": METRICS,
         "verbosity": -1, "tpu_learner": "partitioned",
         "fused_eval": "true", **params}
    bst = lgt.train(p, train, rounds, valid_sets=[valid], callbacks=cbs)
    return bst, ev, clock


def _part_report(torch, lgt_kernels, name, bst, ev, clock, twin=None,
                 extra=None):
    """Checks and one JSON line of a partitioned run: the per-iteration
    path only (no epoch, no captured program), launches held to the
    learner's count (B11a once at the root and once a split, or more
    with pool rebuilds; B11b once a split; B11c once a tree; B2 at the
    root and once a split; the valid walk once an iteration; no B1, B3
    or B3s), host syncs a tree.  Returns the launches."""
    torch.cuda.synchronize()
    launches = lgt_kernels.launch_counts()
    m = bst._model
    iters = m.num_iterations_trained
    splits = sum(m.step_counts)
    fc = m.fetch_counts
    if m.learner != "partitioned" or "epoch" in fc \
            or fc.get("tree") != iters:
        raise AssertionError(f"{name}: learner {m.learner}, fetches {fc}")
    hist = launches["segment_histogram"] + launches["segment_histogram_int"]
    want = {"partition_segment": splits, "leaf_of_row": iters,
            "predict": iters, "auc": iters, "pointwise": iters,
            "histogram": 0, "histogram_int": 0, "partition": 0,
            "grow_step": 0}
    got = {k: launches[k] for k in want}
    if got != want or hist < iters + splits \
            or launches["split"] < iters + splits:
        raise AssertionError(f"{name}: launches {launches} for {iters} "
                             f"iterations and {splits} splits")
    syncs = sum(fc.get(k, 0) for k in ("root", "split_count",
                                       "split_records", "forced"))
    phase_ms = {k: v / iters for k, v in
                m.phase_timer.totals_ms().items()}
    auc = ev["valid_0"]["auc"]
    line = {"phase": name, "path": "per-iteration", "iterations": iters,
            "splits": splits, "valid_auc_last": auc[-1],
            "valid_auc_best": max(auc),
            "steady_ms_per_iteration": clock.steady_ms(warmup=2),
            "host_syncs_per_tree": syncs / iters,
            "phase_ms_per_iteration": phase_ms, "host_fetches": fc,
            "launches_per_iteration": {
                k: launches[k] / iters for k in (
                    "segment_histogram", "segment_histogram_int",
                    "partition_segment", "leaf_of_row", "split",
                    "split_cat", "dequant_hist", "predict")},
            **(twin or {}), **(extra or {})}
    if not all(np.isfinite(auc)) or not 0.5 < max(auc) <= 1.0:
        raise AssertionError(f"{name}: valid AUC {auc}")
    emit(line)
    return launches


def _train_logloss(bst, train) -> float:
    s = np.asarray(bst._model.train_score(), np.float64)
    y = np.asarray(train.metadata.label, np.float64)
    p = np.clip(1.0 / (1.0 + np.exp(-s)), 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def phase_partitioned_train(torch, lgt, lgt_kernels, train, valid, x, xv,
                            main_bst, main_ev, main_ms, eager_ms):
    """The partitioned learner through ``lightgbm_torch.train`` on the
    HIGGS-shaped set, on the per-iteration loop, six runs: the main
    configuration (first tree's integer arrays equal to the masked strict
    main path's, best AUC within PART_AUC_ATOL); 255 leaves with
    WIDE_PARAMS for CUT_ROUNDS (AUC within PART_WIDE_AUC_GAP of the
    batched wide path's at that round); monotone intermediate and
    advanced with CONS_MONO at penalty 0 (no violation over
    CONS_SWEEP_ROWS swept rows; advanced's training logloss at most
    PART_ADV_LOSS_RATIO times basic's on the same learner); forced splits
    (every tree starts with them); quant_train int8 stochastic (AUC within
    QUANT_AUC_GAP of the main run's at the same round, B11a's integer
    form launched).  Returns launches by path."""
    import tempfile
    out = {}
    twin = {"masked_steady_ms_per_iteration_fused": main_ms,
            "masked_ms_per_iteration_per_iteration_path": eager_ms}

    # 1. the main configuration
    lgt_kernels.reset_launch_counts()
    bst, ev, clock = _train_partitioned(lgt, train, valid, {}, ROUNDS)
    t0, m0 = bst._model.models[0], main_bst._model.models[0]
    nl = t0.num_leaves
    same = nl == m0.num_leaves and all(
        np.array_equal(np.asarray(getattr(t0, k))[:nl - 1],
                       np.asarray(getattr(m0, k))[:nl - 1])
        for k in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child")) and np.array_equal(
        np.asarray(t0.leaf_count)[:nl], np.asarray(m0.leaf_count)[:nl])
    best_p = max(ev["valid_0"]["auc"])
    best_m = max(main_ev["valid_0"]["auc"])
    if not same or abs(best_p - best_m) > PART_AUC_ATOL:
        raise AssertionError(f"partitioned_train: first tree equal {same}, "
                             f"AUC {best_p} against {best_m}")
    out["partitioned_train"] = _part_report(
        torch, lgt_kernels, "partitioned_train", bst, ev, clock, twin,
        {"first_tree_integer_arrays_equal_masked": same,
         "masked_valid_auc_best": best_m})
    auc_main = ev["valid_0"]["auc"]

    # 2. 255 leaves, bagging and feature_fraction, against the batched
    # wide path (super-epochs) at the same round
    _, wev, _ = train_main(lgt, train, valid, extra=WIDE_PARAMS,
                           rounds=CUT_ROUNDS)
    lgt_kernels.reset_launch_counts()
    bst, ev, clock = _train_partitioned(lgt, train, valid, WIDE_PARAMS,
                                        CUT_ROUNDS, es=False)
    a = ev["valid_0"]["auc"][-1]
    wide_auc = wev["valid_0"]["auc"][min(len(wev["valid_0"]["auc"]),
                                         len(ev["valid_0"]["auc"])) - 1]
    if abs(a - wide_auc) > PART_WIDE_AUC_GAP:
        raise AssertionError(f"partitioned_wide_train AUC {a} against the "
                             f"batched wide path's {wide_auc}")
    out["partitioned_wide_train"] = _part_report(
        torch, lgt_kernels, "partitioned_wide_train", bst, ev, clock,
        extra={"batched_wide_valid_auc": wide_auc})

    # 3, 4. monotone intermediate and advanced (and basic, the loss
    # reference, on the same learner)
    losses = {}
    for method in ("basic", "intermediate", "advanced"):
        lgt_kernels.reset_launch_counts()
        bst, ev, clock = _train_partitioned(
            lgt, train, valid, {"monotone_constraints": CONS_MONO,
                                "monotone_penalty": 0.0,
                                "monotone_constraints_method": method},
            CUT_ROUNDS, es=False)
        losses[method] = _train_logloss(bst, train)
        if method == "basic":
            continue
        bad = _sweep_violations(bst, train, xv, CONS_SWEEP_ROWS)
        if any(bad.values()):
            raise AssertionError(f"monotone {method}: violations {bad}")
        name = f"partitioned_{method}_train"
        out[name] = _part_report(
            torch, lgt_kernels, name, bst, ev, clock,
            extra={"monotone_violations": bad,
                   "train_logloss": losses[method],
                   "basic_train_logloss": losses["basic"]})
    if losses["advanced"] > PART_ADV_LOSS_RATIO * losses["basic"]:
        raise AssertionError(f"advanced's training loss {losses}")

    # 5. forced splits: the root on feature 0 at its median, its left
    # child on feature 1 at its median
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "forced.json"
        path.write_text(json.dumps({
            "feature": 0, "threshold": float(np.median(x[:, 0])),
            "left": {"feature": 1, "threshold": float(np.median(x[:, 1]))}}))
        lgt_kernels.reset_launch_counts()
        bst, ev, clock = _train_partitioned(
            lgt, train, valid, {"forcedsplits_filename": str(path)},
            PART_FORCED_ROUNDS, es=False)
    for t in bst._model.models:
        lc = int(t.left_child[0])
        if int(t.split_feature[0]) != 0 or lc < 0 \
                or int(t.split_feature[lc]) != 1:
            raise AssertionError("a tree does not start with the forced "
                                 "splits")
    out["partitioned_forced_train"] = _part_report(
        torch, lgt_kernels, "partitioned_forced_train", bst, ev, clock,
        extra={"trees_starting_with_the_forced_splits":
               len(bst._model.models)})

    # 6. quantized training (int8, stochastic rounding)
    lgt_kernels.reset_launch_counts()
    bst, ev, clock = _train_partitioned(lgt, train, valid, QUANT,
                                        CUT_ROUNDS, es=False)
    a_q = ev["valid_0"]["auc"][-1]
    a_f = auc_main[min(CUT_ROUNDS, len(auc_main)) - 1]
    launches = _part_report(
        torch, lgt_kernels, "partitioned_quant_train", bst, ev, clock,
        extra={"f32_valid_auc_same_round": a_f})
    if abs(a_q - a_f) > QUANT_AUC_GAP or launches["segment_histogram"] \
            or launches["segment_histogram_int"] < 1:
        raise AssertionError(f"partitioned quant: AUC {a_q} against {a_f}, "
                             f"launches {launches}")
    out["partitioned_quant_train"] = launches
    return out


def host_walk(bst, x, **kw):
    """``Booster.predict`` by the host tree walk (``predict_bucketed=false``),
    leaving the booster's mode and engine cache as they were."""
    old, cache = bst.config.predict_bucketed, bst._engine_cache
    bst.config.predict_bucketed = "false"
    try:
        return bst.predict(x, **kw)
    finally:
        bst.config.predict_bucketed = old
        bst._engine_cache = cache


def random_forest(rng, n_trees, n_feat, cat_feats, max_leaves, x):
    """A forest of random leaf-wise trees over the columns of ``x``:
    numerical splits at values taken from ``x`` (so rows tie them exactly),
    NaN routed by default_left on every third feature and converted to 0.0
    on the others, categorical splits (bitsets over 0..39) on
    ``cat_feats``, and a stump every 37 trees."""
    from lightgbm_torch.tree_model import Tree
    miss = {f: (2 if f % 3 == 0 else 0) for f in range(n_feat)}
    trees = []
    for ti in range(n_trees):
        nl = 1 if ti % 37 == 5 else int(rng.randint(2, max_leaves + 1))
        t = Tree(nl)
        parent = {0: None}
        for i in range(nl - 1):
            leaf = int(rng.randint(0, i + 1))
            f = int(rng.randint(0, n_feat))
            t.split_feature[i] = f
            if f in cat_feats:
                t.threshold[i] = t._add_cat_bitset(
                    np.flatnonzero(rng.rand(40) < 0.4))
                t.decision_type[i] = 1
            else:
                col = x[:, f]
                col = col[np.isfinite(col)]
                t.threshold[i] = float(col[rng.randint(0, len(col))])
                t.decision_type[i] = (miss[f] << 2) \
                    | (int(rng.rand() < 0.5) << 1)
            if parent[leaf] is not None:
                node, left = parent[leaf]
                if left:
                    t.left_child[node] = i
                else:
                    t.right_child[node] = i
            t.left_child[i], t.right_child[i] = ~leaf, ~(i + 1)
            parent[leaf], parent[i + 1] = (i, True), (i, False)
        t.leaf_value[:] = rng.randn(nl) * 0.1
        trees.append(t)
    return trees


def hard_rows(x, trees, rng, nan_frac=0.02):
    """``x`` with NaNs, every numerical threshold of ``trees`` copied into
    some row (exact ties), and out-of-range values (+-1e30, +-inf, -0.0)."""
    x = np.array(x, np.float64)
    x[rng.rand(*x.shape) < nan_frac] = np.nan
    for t in trees:
        for i in range(t.num_nodes()):
            if not int(t.decision_type[i]) & 1:
                x[rng.randint(0, len(x)), int(t.split_feature[i])] = \
                    t.threshold[i]
    for v in (1e30, -1e30, np.inf, -np.inf, -0.0):
        x[rng.randint(0, len(x), 50), rng.randint(0, x.shape[1], 50)] = v
    return x


def forest_args(eng):
    """The engine's node tables in ``traverse_forest_binned`` order (after
    ``binned``), and in ``fused_forest_predict`` order (after the binning
    tables) with its leaf values and weights."""
    d = eng._dev
    walk = (d["split_feature"], d["threshold_bin"], d["default_left"],
            d["left_child"], d["right_child"], d["na_bin"],
            d["is_cat_node"], d["cat_index"], d["cat_table"])
    thr, zero_bin, cat_vals, cat_len = eng._device_bin_tables()
    lv, w = eng._fused_dev_arrays()
    bins = (thr, d["na_bin"], zero_bin, cat_vals, cat_len)
    fused = (d["split_feature"], d["threshold_bin"], d["default_left"],
             d["left_child"], d["right_child"], d["is_cat_node"],
             d["cat_index"], d["cat_table"], lv, w)
    return walk, bins, fused


def leaf_depths(trees, leaves):
    """Levels walked by every (row, tree) pair of ``leaves`` [N, T]: the
    depth of the leaf it reached."""
    total = 0
    for ti, t in enumerate(trees):
        depth = np.zeros(max(t.num_leaves, 1), np.int64)
        stack = [(0, 1)] if t.num_leaves > 1 else []
        while stack:
            node, dep = stack.pop()
            for c in (t.left_child[node], t.right_child[node]):
                if c >= 0:
                    stack.append((int(c), dep + 1))
                else:
                    depth[~c] = dep
        # a stump's padded root is one level
        depth = depth if t.num_leaves > 1 else np.ones(1, np.int64)
        total += int(depth[leaves[:, ti]].sum())
    return total


def max_abs_diff(torch, a, b) -> float:
    """Largest |a - b| over two tensors of one shape, in f64; raises when
    they differ, as every B10 kernel must equal its plain version."""
    d = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    if a.shape != b.shape or d != 0.0:
        raise AssertionError(f"kernel differs from its plain version: "
                             f"max |diff| {d}, shapes {a.shape} {b.shape}")
    return d


def forest_launches(lgt_kernels, **counts) -> dict:
    """Every kernel's expected launches: ``counts``, the rest 0."""
    return {k: counts.get(k, 0) for k in lgt_kernels.launch_counts()}


def chunks(eng, n: int) -> int:
    """Launches of one engine call on ``n`` rows: one per bucket chunk."""
    return -(-n // eng._bucket(n))


def self_check_launches(eng, device_binning: bool) -> dict:
    """The launches a passing ``eng.self_check`` (at its default probe
    sizes, 64 rows per chunk up to 4,096) makes: a walk per probe chunk
    and, with device binning, on each chunk that holds rows where f32 and
    f64 binning agree, one more binning and walk and, for a fused-capable
    model, one fused launch."""
    cands = eng._probe_candidates()
    total = min(max(len(c) for c in cands), 4096)
    n = {"forest_walk": 0, "bin_rows": 0, "fused_predict": 0}
    for off in range(0, total, 64):
        idx = off + np.arange(min(64, total - off))
        probe = np.stack([c[idx % len(c)] for c in cands], axis=1)
        n["forest_walk"] += 1
        if device_binning and eng._f32_consensus_mask(probe).any():
            n["bin_rows"] += 1
            n["forest_walk"] += 1
            n["fused_predict"] += int(eng.fused_reason is None)
    return n


def hold_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def exact_err(torch, pairs, what: str) -> float:
    """Largest |kernel - plain| in f64 over (kernel, plain) output pairs
    of a kernel that must equal its plain version, over the entries finite
    in both; raises unless every pair holds the same bits."""
    err = 0.0
    for a, b in pairs:
        if a.shape != b.shape or not equal_bits(torch, a, b):
            raise AssertionError(f"{what} differs from its plain version")
        d = a.double() - b.double()
        d = d[torch.isfinite(a.double()) & torch.isfinite(b.double())]
        if d.numel():
            err = max(err, float(d.abs().max()))
    return err


def same_bits(torch, a, b) -> bool:
    """Whether two f32 tensors hold the same bits."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def check_forest_kernels(torch, eng, x, what: str) -> dict:
    """B10a, B10b and B10c against their plain versions on the card, bit
    for bit, on rows ``x`` (float64 host rows)."""
    from lightgbm_torch import predict_device as pdv
    from lightgbm_torch.serve.engine import _upload
    walk, bins, fused = forest_args(eng)
    binned = _upload(eng.bin_rows(x).astype(eng._bin_dtype), eng.device)
    lk = pdv.traverse_forest_binned(binned, *walk, steps=eng._steps)
    lp = pdv.traverse_forest_plain(binned, *walk, steps=eng._steps)
    xd = torch.from_numpy(x.astype(np.float32)).to(eng.device)
    bk = pdv.bin_rows_device_full(xd, *bins)
    bp = pdv.bin_rows_plain(xd, *bins)
    fk = pdv.fused_forest_predict(xd, *bins, *fused, eng._avg_denom,
                                  steps=eng._steps, num_class=eng.num_class)
    fp = pdv.fused_forest_plain(xd, *bins, *fused, eng._avg_denom,
                                steps=eng._steps, num_class=eng.num_class)
    torch.cuda.synchronize()
    out = {"walk_equal": torch.equal(lk, lp),
           "bins_equal": torch.equal(bk, bp),
           "fused_bits_equal": same_bits(torch, fk, fp),
           "binned_dtype": str(binned.dtype),
           "threshold_dtype": str(walk[1].dtype),
           "child_dtype": str(walk[3].dtype),
           "cat_index_dtype": str(walk[7].dtype),
           "cat_nodes": int(eng._is_cat_node.sum()),
           "stumps": int(sum(t.num_leaves <= 1 for t in eng.trees)),
           "nan_cells": int(np.isnan(x).sum()), "steps": eng._steps}
    if not all(out[k] for k in ("walk_equal", "bins_equal",
                                "fused_bits_equal")):
        raise AssertionError(f"B10 ({what}) differs from its plain "
                             f"version: {out}")
    return out


def phase_serving_model(torch, lgt, lgt_kernels, train):
    """The serving model: SERVE_ROUNDS rounds on the train set without a
    valid set, which takes fused chunks."""
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "max_bin": MAX_BIN, "learning_rate": 0.1, "verbosity": -1}
    t0 = time.perf_counter()
    bst = lgt.train(params, train, SERVE_ROUNDS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    m = bst._model
    fused_program(m)
    if set(m.fetch_counts) != {"epoch"}:
        raise AssertionError(f"serving model did not take fused chunks: "
                             f"{m.fetch_counts}")
    depths = [t.max_depth() for t in bst.trees]
    emit({"phase": "serving_model", "rounds": SERVE_ROUNDS,
          "trees": bst.num_trees(), "seconds": secs,
          "host_fetches": m.fetch_counts, "max_depth": max(depths),
          "mean_depth": float(np.mean(depths))})
    return bst


def phase_serve_kernels(torch, lgt, bst, xv):
    """B10a-c against their plain versions at the serving shapes, then
    timed on the plain valid rows."""
    from lightgbm_torch import predict_device as pdv
    from lightgbm_torch.serve import PredictorEngine
    from lightgbm_torch.serve.engine import _upload
    rng = np.random.RandomState(11)
    checks = {}
    hard = hard_rows(xv, bst.trees, rng)
    engines = {}
    for packed in (True, False):
        eng = PredictorEngine.from_booster(bst, packed=packed)
        engines[packed] = eng
        checks[f"serving_model_packed={packed}"] = check_forest_kernels(
            torch, eng, hard, f"serving model, packed={packed}")
    cat_feats = {5, 11, 20}
    xs = np.array(xv[:, :N_FEAT], np.float64)
    for f in cat_feats:
        xs[:, f] = rng.randint(-2, 45, len(xs))
    forest = random_forest(rng, SERVE_ROUNDS, N_FEAT, cat_feats, NUM_LEAVES,
                           xs)
    xs = hard_rows(xs, forest, rng, nan_frac=0.05)
    for packed in (True, False):
        eng = PredictorEngine(forest, [1.0] * len(forest), 1, N_FEAT,
                              packed=packed,
                              device_type=bst.config.device_type)
        checks[f"categorical_forest_packed={packed}"] = check_forest_kernels(
            torch, eng, xs, f"categorical forest, packed={packed}")
    emit({"phase": "serve_kernels_check", "rows": len(xv), "cases": checks})

    # times on the plain valid rows, with the serving model's packed tables
    eng = engines[True]
    walk, bins, fused = forest_args(eng)
    x = np.asarray(xv, np.float64)
    n, f, T = len(x), x.shape[1], len(eng.trees)
    binned = _upload(eng.bin_rows(x).astype(eng._bin_dtype), eng.device)
    xd = torch.from_numpy(x.astype(np.float32)).to(eng.device)
    leaves = pdv.traverse_forest_binned(binned, *walk, steps=eng._steps)
    visits = leaf_depths(eng.trees, leaves.cpu().numpy())
    table_bytes = sum(t.numel() * t.element_size() for t in walk)
    rows = {}
    steps = eng._steps
    # each kernel's largest deviation from its plain version on these rows
    fargs = (xd, *bins, *fused, eng._avg_denom)
    err = {"forest_walk": max_abs_diff(
               torch, leaves,
               pdv.traverse_forest_plain(binned, *walk, steps=steps)),
           "bin_rows": max_abs_diff(
               torch, pdv.bin_rows_device_full(xd, *bins),
               pdv.bin_rows_plain(xd, *bins)),
           "fused_predict": max_abs_diff(
               torch,
               pdv.fused_forest_predict(*fargs, steps=steps, num_class=1),
               pdv.fused_forest_plain(*fargs, steps=steps, num_class=1))}
    t_k = median_ms(torch, lambda: pdv.traverse_forest_binned(
        binned, *walk, steps=steps))
    t_p = median_ms(torch, lambda: pdv.traverse_forest_plain(
        binned, *walk, steps=steps), reps=5, warmup=1)
    rows["forest_walk"] = ("B10a forest walk", t_k, t_p, bound_ms(
        binned.numel() * binned.element_size() + 4 * n * T + table_bytes,
        WALK_OPS_PER_LEVEL * visits), None)
    t_k = median_ms(torch, lambda: pdv.bin_rows_device_full(xd, *bins))
    t_p = median_ms(torch, lambda: pdv.bin_rows_plain(xd, *bins), reps=10)
    thr = bins[0]
    xt = xd.t().contiguous()
    t_lib = median_ms(torch, lambda: torch.searchsorted(thr, xt))
    # a search needs ceil(log2(B)) + 1 compares per value
    search = int(np.ceil(np.log2(thr.shape[1]))) + 1
    rows["bin_rows"] = ("B10b device binning", t_k, t_p, bound_ms(
        8 * n * f + thr.numel() * 4 + 12 * f, 2 * n * f * search), t_lib)
    t_k = median_ms(torch, lambda: pdv.fused_forest_predict(
        xd, *bins, *fused, eng._avg_denom, steps=steps, num_class=1))
    t_p = median_ms(torch, lambda: pdv.fused_forest_plain(
        xd, *bins, *fused, eng._avg_denom, steps=steps, num_class=1),
        reps=5, warmup=1)
    lv_bytes = fused[-2].numel() * 4 + fused[-1].numel() * 4
    rows["fused_predict"] = ("B10c fused forest predict", t_k, t_p, bound_ms(
        4 * n * f + 4 * n + table_bytes + lv_bytes,
        WALK_OPS_PER_LEVEL * visits + 2 * n * f * search + 2 * n * T), None)
    out = {}
    src = {"forest_walk": "lightgbm_tpu/predict_device.py:144",
           "bin_rows": "lightgbm_tpu/predict_device.py:195",
           "fused_predict": "lightgbm_tpu/predict_device.py:245"}
    for key, (name, tk, tp, (bms, by), tl) in rows.items():
        out[key] = {"name": name, "route": "cuda",
                    "source": "lightgbm_torch/csrc/forest.cu",
                    "replaces": src[key], "max_abs_err": err[key], "ms": tk,
                    "plain_ms": tp, "bound_ms": bms, "bound_by": by,
                    "library_ms": tl}
        emit({"phase": "kernel", **out[key], "rows": n, "trees": T,
              "levels_walked": visits})
    return out


def phase_predict(torch, lgt, lgt_kernels, main_bst, serve_bst, xv):
    """``Booster.predict`` at ``predict_bucketed=auto`` on the valid rows:
    the engine route, byte-identical to the host walk, with pred_leaf;
    returns the launches of those calls alone, held to one walk per
    bucket chunk of each call (the breakdown's timing runs after)."""
    from lightgbm_torch.serve import PredictorEngine
    from lightgbm_torch.serve.engine import _upload
    x = np.asarray(xv, np.float64)
    launches = forest_launches(lgt_kernels)
    info = {}
    for name, bst in (("main_path_model", main_bst),
                      ("serving_model", serve_bst)):
        bst._drop_predict_cache()
        torch.cuda.synchronize()
        lgt_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = bst.predict(x)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = bst.predict(x)
        eng_s = time.perf_counter() - t0
        leaf = bst.predict(x, pred_leaf=True)
        torch.cuda.synchronize()
        path = lgt_kernels.launch_counts()
        eng = bst._engine_cache
        if not isinstance(eng, PredictorEngine):
            raise AssertionError(f"{name}: Booster.predict did not take "
                                 "the engine route")
        hold_launches(f"predict ({name})", path, forest_launches(
            lgt_kernels, forest_walk=3 * chunks(eng, len(x))))
        launches = {k: launches[k] + path[k] for k in launches}
        t0 = time.perf_counter()
        ref = host_walk(bst, x)
        host_s = time.perf_counter() - t0
        if not (np.array_equal(got, ref) and np.array_equal(again, ref)):
            raise AssertionError(f"{name}: the engine route differs from "
                                 "the host walk")
        host_leaf = np.stack([t.predict_leaf(x) for t in bst.trees], axis=1)
        if not np.array_equal(leaf, host_leaf):
            raise AssertionError(f"{name}: pred_leaf differs from the host "
                                 "trees' leaves")
        # the engine route's parts, on the same rows
        t0 = time.perf_counter()
        binned = eng.bin_rows(x).astype(eng._bin_dtype)
        bin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bd = _upload(binned, eng.device)
        torch.cuda.synchronize()
        up_s = time.perf_counter() - t0
        walk_ms = median_ms(torch, lambda: eng._traverse(bd), reps=10)
        dl = eng._traverse(bd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_ids = dl.cpu().numpy()
        fetch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.raw_scores(x, leaves=host_ids)
        acc_s = time.perf_counter() - t0
        info[name] = {
            "trees": len(bst.trees), "engine_first_call_s": first_s,
            "engine_rows_per_s": len(x) / eng_s,
            "host_walk_rows_per_s": len(x) / host_s,
            "byte_identical": True, "pred_leaf_equal": True,
            "launches": path,
            "breakdown_s": {"host_binning": bin_s, "upload": up_s,
                            "walk_kernel": walk_ms / 1e3,
                            "leaf_id_fetch": fetch_s,
                            "leaf_id_fetch_bytes": host_ids.nbytes,
                            "host_accumulate": acc_s}}
    emit({"phase": "predict", "rows": len(x), **info, "launches": launches})
    return launches


def phase_fused_serve(torch, lgt, lgt_kernels, bst, xv,
                      name: str = "fused_serve"):
    """``fused_predict`` on the valid rows against ``_fused_reference`` and
    the fused plain version, and ``self_check(device_binning=True)``;
    returns the launches of those two engine calls alone."""
    x = np.asarray(xv, np.float64)
    eng = bst._engine_cache
    torch.cuda.synchronize()
    lgt_kernels.reset_launch_counts()
    ok = eng.self_check(device_binning=True)
    if ok is not True:
        raise AssertionError("self_check(device_binning=True) failed")
    eng.fused_predict(x)
    t0 = time.perf_counter()
    got = eng.fused_predict(x)
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = lgt_kernels.launch_counts()
    want = self_check_launches(eng, device_binning=True)
    want["fused_predict"] += 2 * chunks(eng, len(x))
    hold_launches(name, launches, forest_launches(lgt_kernels, **want))
    mask = eng._f32_consensus_mask(x)
    ref = eng._fused_reference(x[mask])
    if not np.array_equal(got[mask], ref):
        raise AssertionError("fused_predict differs from _fused_reference "
                             "on the consensus rows")
    if not np.array_equal(got, fused_plain_scores(torch, eng, x)):
        raise AssertionError("fused_predict differs from its plain version")
    host = host_walk(bst, x)
    dev = np.abs(got.astype(np.float64) - host.astype(np.float64))
    emit({"phase": name, "rows": len(x), "self_check": True,
          "consensus_rows": int(mask.sum()),
          "non_consensus_rows": int((~mask).sum()),
          "equal_reference_on_consensus": True, "equal_plain_all": True,
          "rows_per_s": len(x) / secs,
          "max_abs_dev_from_host_f64": float(dev.max()),
          "max_abs_dev_from_host_f64_consensus": float(dev[mask].max()),
          "mean_abs_dev_from_host_f64": float(dev.mean()),
          "launches": launches})
    return launches


def fused_plain_scores(torch, eng, rows):
    """The fused path's answers by its plain version on the card (the
    same device binning, walk, sum and transform, op by op)."""
    from lightgbm_torch import predict_device as pdv
    _, bins, fused = forest_args(eng)
    xd = torch.from_numpy(rows.astype(np.float32)).to(eng.device)
    return eng._transform(pdv.fused_forest_plain(
        xd, *bins, *fused, eng._avg_denom, steps=eng._steps,
        num_class=eng.num_class)).cpu().numpy()


def drive_server(srv, reqs):
    """SERVE_THREADS closed-loop clients, each sending its share of
    ``reqs`` one after another; returns (answers, seconds per request,
    wall seconds)."""
    import threading
    answers = [None] * len(reqs)
    lat = [0.0] * len(reqs)
    errors = []

    def client(ids):
        try:
            for i in ids:
                t = time.perf_counter()
                answers[i] = srv.predict(reqs[i], timeout=120)
                lat[i] = time.perf_counter() - t
        except Exception as e:       # noqa: BLE001 — reported below
            errors.append(repr(e))
    threads = [threading.Thread(target=client,
                                args=(range(c, len(reqs), SERVE_THREADS),))
               for c in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"serve clients failed: {errors[:3]}")
    return answers, np.asarray(lat), wall


def http_roundtrip(lgt, srv, rows):
    """One ``/predict`` and one ``/healthz`` over HTTP on 127.0.0.1."""
    import urllib.request
    fe = lgt.serve.start_http(srv, host="127.0.0.1", port=0)
    try:
        base = f"http://127.0.0.1:{fe.port}"
        resp = json.loads(urllib.request.urlopen(urllib.request.Request(
            base + "/predict", data=json.dumps({"rows": rows.tolist()}
                                               ).encode(),
            headers={"Content-Type": "application/json"}),
            timeout=60).read())
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=60).read())
    finally:
        fe.close()
    return resp, health


def phase_serve(torch, lgt, lgt_kernels, bst, xv, device_binning: bool,
                name: str = ""):
    """A Server over ``bst``: SERVE_THREADS client threads send
    SERVE_REQUESTS requests of 1-64 rows; every answer is checked.
    Returns the launches of the server's load (its self-check) and of the
    clients' requests, held to the self-check's probe chunks and one
    launch per batch; the checks and the HTTP trip run after."""
    rng = np.random.RandomState(21 + int(device_binning))
    sizes = rng.randint(1, 65, SERVE_REQUESTS)
    starts = rng.randint(0, len(xv) - 64, SERVE_REQUESTS)
    x = np.asarray(xv, np.float64)
    reqs = [x[s:s + k] for s, k in zip(starts, sizes)]
    allrows = np.concatenate(reqs)
    kernel = "fused_predict" if device_binning else "forest_walk"
    torch.cuda.synchronize()
    lgt_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    srv = lgt.Server({"serve_max_batch": SERVE_MAX_BATCH,
                      "serve_device_binning": device_binning,
                      "verbosity": -1}, booster=bst)
    try:
        load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        load = lgt_kernels.launch_counts()
        served = srv.registry.current()
        if served.engine is None or served.self_check_failed:
            raise AssertionError("the server's engine failed its "
                                 "self-check")
        eng = served.engine
        hold_launches("server load", load, forest_launches(
            lgt_kernels, **self_check_launches(eng, device_binning)))
        lgt_kernels.reset_launch_counts()
        answers, lat, wall = drive_server(srv, reqs)
        torch.cuda.synchronize()
        batches = srv.batcher.batches_dispatched
        drive = lgt_kernels.launch_counts()
        hold_launches("server requests", drive,
                      forest_launches(lgt_kernels, **{kernel: batches}))
        launches = {k: load[k] + drive[k] for k in load}
        got = np.concatenate(answers)
        check = {}
        if device_binning:
            mask = eng._f32_consensus_mask(allrows)
            if not (np.array_equal(got[mask],
                                   eng._fused_reference(allrows[mask]))
                    and np.array_equal(got, fused_plain_scores(
                        torch, eng, allrows))):
                raise AssertionError("fused serve answers differ from the "
                                     "reference")
            check = {"consensus_rows": int(mask.sum()),
                     "non_consensus_rows": int((~mask).sum())}
        elif not np.array_equal(got, host_walk(bst, allrows)):
            raise AssertionError("served answers differ from the host "
                                 "walk")
        lgt_kernels.reset_launch_counts()
        resp, health = http_roundtrip(lgt, srv, reqs[0])
        torch.cuda.synchronize()
        hold_launches("HTTP /predict", lgt_kernels.launch_counts(),
                      forest_launches(lgt_kernels, **{kernel: 1}))
        if not np.array_equal(np.asarray(resp["predictions"], got.dtype),
                              answers[0]) or health["status"] != "ok":
            raise AssertionError(f"HTTP round trip: {resp}, {health}")
        snap = srv.metrics_snapshot()
        breaker = srv.breaker.describe()["state"]
    finally:
        srv.close()
    fallback = snap.get("serve.host_fallback_batches", {}).get("value", 0)
    fused_b = snap.get("serve.fused_batches", {}).get("value", 0)
    # the HTTP trip is one more batch
    if fallback != 0 or breaker != "closed" \
            or (device_binning and fused_b != batches + 1):
        raise AssertionError(f"fallback batches {fallback}, fused batches "
                             f"{fused_b} of {batches} + 1, breaker "
                             f"{breaker}")
    lat_ms = 1e3 * lat
    emit({"phase": name or ("serve_fused" if device_binning
                            else "serve_host"),
          "requests": SERVE_REQUESTS, "rows": int(len(allrows)),
          "client_threads": SERVE_THREADS, "max_batch": SERVE_MAX_BATCH,
          "load_s": load_s, "seconds": wall,
          "rows_per_s": len(allrows) / wall,
          "requests_per_s": SERVE_REQUESTS / wall,
          "p50_ms": float(np.percentile(lat_ms, 50)),
          "p99_ms": float(np.percentile(lat_ms, 99)),
          "batches": batches, "fused_batches": fused_b,
          "host_fallback_batches": fallback, "breaker": breaker,
          "http_roundtrip": True, "answers_checked": SERVE_REQUESTS,
          **check, "launches": launches, "load_launches": load,
          "request_launches": drive})
    return launches


def phase_fleet_kernels(torch, lgt, train, valid):
    """The member forms of the fleet (B14's member axis: the JAX package's
    ``build_fleet_superepoch`` vmap) at the main shape with FLEET_MEMBERS
    members, each with its own operands: B1-M (a smaller child's slot),
    B1-K-M (K = 16, one member with 5 of 16 slots in use), B1-int-M and
    B1-K-int-M (int8 packed stacks), B3-M (a strict record each), B3-K-M
    (16 records each) and B4-M (each member's own 31-leaf tree over the
    valid matrix).  In the checks member 2 is on a dead step (active 0,
    or status 0; B4-M, which has no step, walks the other three): every
    other member's result is bitwise its solo launch's, and the dead
    member's rows stay as they were.  Each form is held
    to its plain version (B1-M and B1-K-M within HIST_RTOL, the rest
    exact), and timed at N = 4 live members beside four solo launches of
    the same kernel, its plain version and its bound: the shared matrix
    once plus each member's operands.  Returns the kernels-line rows."""
    from lightgbm_torch.grower import (ACTIVE, STEP_RECORD, BatchedStep,
                                       GrowWorkspace, grow_tree, partition,
                                       partition_members,
                                       partition_members_plain,
                                       partition_slots,
                                       partition_slots_members,
                                       partition_slots_members_plain)
    from lightgbm_torch.ops import quantize as Q
    from lightgbm_torch.ops.histogram import (compute_histogram,
                                              compute_histogram_members,
                                              histogram_members_plain)
    from lightgbm_torch.ops.split import SplitParams
    from lightgbm_torch.predict_device import (add_tree_score,
                                               add_tree_score_members,
                                               add_tree_score_members_plain)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(23)
    binned = torch.as_tensor(train.binned).to(dev)
    vbinned = torch.as_tensor(valid.binned).to(dev)
    n, f = binned.shape
    nv = vbinned.shape[0]
    B, M, K, DEAD = int(train.max_bin), FLEET_MEMBERS, WIDE_K, 2
    feats = train.used_features
    na_bin = torch.as_tensor(np.asarray(
        [train.bin_mappers[j].na_bin for j in feats], np.int32)).to(dev)
    num_bin = torch.as_tensor(np.asarray(
        [train.bin_mappers[j].num_bin for j in feats], np.int32)).to(dev)
    i32 = torch.int32

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    def grad_vals():
        y = (rand(n) < 0.5).float()
        p = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
        w = (rand(n) < 0.8).float()
        return torch.stack([(p - y) * w, p * (1 - p) * w, w], 1) \
            .contiguous()

    one = torch.ones(1, dtype=i32, device=dev)
    vals = [grad_vals() for _ in range(M)]
    qvals = [Q.quantize_stack(v, Q.quant_scales(v, 127),
                              Q.QuantSpec(8, True, j),
                              torch.tensor([j], dtype=i32, device=dev))
             for j, v in enumerate(vals)]
    slots = [torch.where(rand(n) < 0.4, 0, -1).to(i32) for _ in range(M)]
    used = [K, 5, K, K]
    kslots = [(torch.floor(rand(n) * (u + 1)) - 1).to(i32) for u in used]
    kused = [torch.tensor([u], dtype=i32, device=dev) for u in used]
    actives = [torch.tensor([int(j != DEAD)], dtype=i32, device=dev)
               for j in range(M)]
    live = [j for j in range(M) if j != DEAD]
    rows, errs, checked = {}, {}, {}

    def hist_check(name, vs, ss=None, k=None, su=None):
        kw = dict(num_bins=B, num_slots=k)
        out = compute_histogram_members(binned, vs, slots=ss, actives=actives,
                                        slots_used=su, **kw)
        plain = histogram_members_plain(binned, vs, slots=ss,
                                        actives=actives, **kw)
        for j in live:
            solo = compute_histogram(binned, vs[j], slot=None if ss is None
                                     else ss[j], active=actives[j],
                                     slots_used=None if su is None
                                     else su[j], **kw)
            if not equal_bits(torch, out[j], solo):
                raise AssertionError(f"{name}: member {j} differs from its "
                                     "solo launch")
        integer = vs[0].dtype != torch.float32
        if integer:
            errs[name] = exact_err(torch, [(out[j], plain[j]) for j in live],
                                   name)
        else:
            errs[name] = max(_hist_rel(torch, out[j], plain[j])
                             for j in live)
            if errs[name] > HIST_RTOL:
                raise AssertionError(f"{name} off its plain version by "
                                     f"{errs[name]:.3g}")
        checked[name] = len(live)

    hist_check("B1-M", vals, slots)
    hist_check("B1-K-M", vals, kslots, K, kused)
    hist_check("B1-int-M", qvals, slots)
    hist_check("B1-K-int-M", qvals, kslots, K, kused)

    # B3-M: a strict step's record each (member 2's inactive)
    lor0 = [torch.floor(rand(n) * 8).to(i32) for _ in range(M)]
    recs = []
    for j in range(M):
        feat = 3 * j + 1
        rec = [j, 8 + j, feat, 20 + 5 * j, j % 2,
               int(na_bin[feat]), j if j % 2 else 8 + j, int(j != DEAD)]
        recs.append(torch.tensor(rec, dtype=i32, device=dev))
    rank = torch.arange(B, dtype=i32, device=dev)
    ranks = [rank] * M

    def part_check(name, member_fn, solo_fn, plain_fn):
        lm = [t.clone() for t in lor0]
        lp = [t.clone() for t in lor0]
        out = member_fn(lm)
        plain = plain_fn(lp)
        pairs = [(lm[j], lp[j]) for j in range(M)] \
            + [(out[j], plain[j]) for j in live]
        for j in live:
            ls = lor0[j].clone()
            solo = solo_fn(j, ls)
            if not (torch.equal(lm[j], ls) and torch.equal(out[j], solo)):
                raise AssertionError(f"{name}: member {j} differs from its "
                                     "solo launch")
        if not torch.equal(lm[DEAD], lor0[DEAD]):
            raise AssertionError(f"{name}: the dead member's rows moved")
        errs[name] = exact_err(torch, pairs, name)
        checked[name] = len(live)

    part_check("B3-M",
               lambda lm: partition_members(binned, lm, recs, ranks),
               lambda j, ls: partition(binned, ls, recs[j], rank),
               lambda lp: partition_members_plain(binned, lp, recs, ranks))

    # B3-K-M: 16 records each over 32 leaves (member 2's status 0)
    lor0 = [torch.floor(rand(n) * 32).to(i32) for _ in range(M)]
    steps = []
    for j in range(M):
        L = WIDE_LEAVES
        sol = torch.full((L,), -1, dtype=i32)
        recs_k = torch.zeros((K, STEP_RECORD), dtype=i32)
        for k in range(K):
            leaf, feat = (3 * k + j) % 32, (k + j) % f
            sol[leaf] = k
            recs_k[k] = torch.tensor([leaf, 32 + k, feat, 10 + 3 * k,
                                      k % 2, int(na_bin[feat]),
                                      leaf if k % 3 else 32 + k, 1])
        status = torch.tensor([int(j != DEAD), K * int(j != DEAD)],
                              dtype=i32)
        z = dict(device=dev)
        steps.append(BatchedStep(
            recs=recs_k.to(dev), slot_of_leaf=sol.to(dev),
            idx2=torch.zeros(2 * K, dtype=torch.int64, **z),
            tot2=torch.zeros((2 * K, 3), **z), po2=torch.zeros(2 * K, **z),
            small_left=torch.zeros(K, dtype=torch.bool, **z),
            keep2=torch.zeros(2 * K, dtype=torch.bool, **z),
            status=status.to(dev)))
    part_check("B3-K-M",
               lambda lm: partition_slots_members(binned, lm, steps, ranks),
               lambda j, ls: partition_slots(binned, ls, steps[j], rank),
               lambda lp: partition_slots_members_plain(binned, lp, steps,
                                                        ranks))

    # B4-M: each member's own 31-leaf tree (the solo strict grower on its
    # vals) over the valid matrix, member 2's scores left as they were
    params = SplitParams(min_data_in_leaf=20)
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    trees, lvs = [], []
    for j in range(M):
        ws = GrowWorkspace(n, f, B, NUM_LEAVES, dev)
        grow_tree(binned, vals[j], fmask, num_bin, na_bin,
                  num_leaves=NUM_LEAVES, num_bins=B, params=params,
                  workspace=ws)
        trees.append(ws.fields)
        lvs.append(ws.fields["leaf_value"] * 0.1)
    steps_w = [8] * M
    score0 = [torch.randn(nv, device=dev, generator=gen) for _ in range(M)]
    walk = [j for j in range(M) if j != DEAD]
    sm = [score0[j].clone() for j in walk]
    sp_ = [score0[j].clone() for j in walk]
    add_tree_score_members(sm, vbinned, [trees[j] for j in walk], na_bin,
                           [lvs[j] for j in walk], 1.0,
                           steps=[steps_w[j] for j in walk])
    add_tree_score_members_plain(sp_, vbinned, [trees[j] for j in walk],
                                 na_bin, [lvs[j] for j in walk], 1.0,
                                 steps=[steps_w[j] for j in walk])
    for i, j in enumerate(walk):
        ss = score0[j].clone()
        t = trees[j]
        add_tree_score(ss, vbinned, t["split_feature"], t["threshold_bin"],
                       t["default_left"], t["left_child"],
                       t["right_child"], na_bin, lvs[j], 1.0,
                       steps=steps_w[j])
        if not same_bits(torch, sm[i], ss):
            raise AssertionError(f"B4-M: member {j} differs from its solo "
                                 "launch")
    errs["B4-M"] = exact_err(torch, list(zip(sm, sp_)), "B4-M")
    checked["B4-M"] = len(walk)

    # times at N = 4 live members: the member form, four solo launches,
    # the plain version; bounds from the shared matrix once plus each
    # member's operands
    actives[DEAD].fill_(1)
    for st in steps:
        st.status.copy_(torch.tensor([1, K], dtype=i32, device=dev))
    for r in recs:
        r[ACTIVE] = 1
    # bytes: the shared matrix once; a member's slot column, the vals of
    # its rows in a slot (12 B, or 3 B packed) and its histogram out
    kept = [int((s_ >= 0).sum()) for s_ in slots]
    kkept = [int((s_ >= 0).sum()) for s_ in kslots]
    hist_out = f * B * 12
    cases = {
        "histogram_members": (
            "B1-M member-batched histogram (a smaller child's pass each)",
            lambda: compute_histogram_members(binned, vals, num_bins=B,
                                              slots=slots, actives=actives),
            lambda: [compute_histogram(binned, vals[j], num_bins=B,
                                       slot=slots[j], active=actives[j])
                     for j in range(M)],
            lambda: histogram_members_plain(binned, vals, num_bins=B,
                                            slots=slots, actives=actives),
            bound_ms(n * f + sum(4 * n + 12 * kp + hist_out
                                 for kp in kept),
                     3 * f * sum(kept)), "B1-M"),
        "histogram_slots_members": (
            "B1-K-M member-batched K-slot histogram (K = 16)",
            lambda: compute_histogram_members(
                binned, vals, num_bins=B, slots=kslots, num_slots=K,
                actives=actives, slots_used=kused),
            lambda: [compute_histogram(binned, vals[j], num_bins=B,
                                       slot=kslots[j], num_slots=K,
                                       active=actives[j],
                                       slots_used=kused[j])
                     for j in range(M)],
            lambda: histogram_members_plain(
                binned, vals, num_bins=B, slots=kslots, num_slots=K,
                actives=actives),
            bound_ms(n * f + sum(4 * n + 12 * kp + K * hist_out
                                 for kp in kkept),
                     3 * f * sum(kkept)), "B1-K-M"),
        "histogram_int_members": (
            "B1-int-M member-batched integer histogram (int8)",
            lambda: compute_histogram_members(binned, qvals, num_bins=B,
                                              slots=slots, actives=actives),
            lambda: [compute_histogram(binned, qvals[j], num_bins=B,
                                       slot=slots[j], active=actives[j])
                     for j in range(M)],
            lambda: histogram_members_plain(binned, qvals, num_bins=B,
                                            slots=slots, actives=actives),
            bound_ms(n * f + sum(4 * n + 3 * kp + hist_out for kp in kept),
                     3 * f * sum(kept)), "B1-int-M"),
        "partition_members": (
            "B3-M member-batched row partition",
            lambda: partition_members(binned, lor0, recs, ranks),
            lambda: [partition(binned, lor0[j], recs[j], rank)
                     for j in range(M)],
            lambda: partition_members_plain(binned, lor0, recs, ranks),
            bound_ms(n * f + M * 12 * n, 0), "B3-M"),
        "partition_slots_members": (
            "B3-K-M member-batched batched partition (K = 16)",
            lambda: partition_slots_members(binned, lor0, steps, ranks),
            lambda: [partition_slots(binned, lor0[j], steps[j], rank)
                     for j in range(M)],
            lambda: partition_slots_members_plain(binned, lor0, steps,
                                                  ranks),
            bound_ms(n * f + M * 12 * n, 0), "B3-K-M"),
        "predict_members": (
            "B4-M member-batched tree score update (valid set)",
            lambda: add_tree_score_members(score0, vbinned, trees, na_bin,
                                           lvs, 1.0, steps=steps_w),
            lambda: [add_tree_score(
                score0[j], vbinned, trees[j]["split_feature"],
                trees[j]["threshold_bin"], trees[j]["default_left"],
                trees[j]["left_child"], trees[j]["right_child"], na_bin,
                lvs[j], 1.0, steps=steps_w[j]) for j in range(M)],
            lambda: add_tree_score_members_plain(
                score0, vbinned, trees, na_bin, lvs, 1.0, steps=steps_w),
            bound_ms(nv * f + M * 8 * nv, 0), "B4-M")}
    for key, (name, fn, solo, plain, bnd, short) in cases.items():
        t_m = median_ms(torch, fn)
        t_s = median_ms(torch, solo)
        t_p = median_ms(torch, plain, reps=5, warmup=1)
        rows[key] = {"name": name, "route": "cuda",
                     "source": "lightgbm_torch/csrc/" + (
                         "histogram.cu" if key.startswith("histogram")
                         else "partition.cu" if key.startswith("partition")
                         else "predict.cu"),
                     "replaces": "lightgbm_tpu/models/gbdt.py:2200",
                     "max_abs_err": errs[short], "ms": t_m,
                     "plain_ms": t_p, "bound_ms": bnd[0],
                     "bound_by": bnd[1], "library_ms": None,
                     "members": M, "solo_launches_ms": t_s}
        emit({"phase": "kernel", **rows[key]})
    emit({"phase": "fleet_kernels", "members": M, "dead_member": DEAD,
          "members_checked_bitwise": checked, "max_err": errs,
          "b1_k_int_m_max_abs_err": errs["B1-K-int-M"]})
    return rows


def phase_fleet_train(torch, lgt, lgt_kernels, train, valid, name: str,
                      extra: dict, rounds: int):
    """``lightgbm_torch.fleet.fleet_train`` of one fleet cell (FLEET_CELLS)
    on the card: every member's model text and best iteration equal to its
    solo ``train`` on the card; the fleet's launches held to
    ``fleet_per_iteration`` a replay (captured once, then replayed, with
    nothing eager besides the warm-up), one ``fleet_fetch`` an epoch on
    member 0 and no solo fetch while the fleet ran; the shared operands
    one tensor (member 0's).  Of FLEET_RAGGED, that a member left the
    fleet before its last epoch (its lane rode dead in the graph) and
    that the last member finished through the solo path's epochs.
    Reports the fleet's steady ms an iteration against the members' solo
    steady ms summed, and the launches of the shared passes an iteration.
    Returns the cell's device launches."""
    from lightgbm_torch.fleet import fleet_train
    params = {**FLEET_BASE, **extra}
    lgt_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fr = fleet_train(dict(params), train, rounds, valid_sets=[valid])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    eager = lgt_kernels.launch_counts()
    prog = fr.program
    ms = [b._model for b in fr.boosters]
    M = len(ms)
    leaves = [m.config.num_leaves for m in ms]
    K = ms[0].split_batch
    per_it = fleet_per_iteration(leaves, K, ms[0]._use_bagging,
                                 ms[0].quant is not None)
    got = {k: v for k, v in prog.captured.items() if v}
    if got != per_it or {k: v for k, v in prog.warmup.items() if v} \
            != per_it:
        raise AssertionError(f"{name} launches: captured {got}, warm-up "
                             f"{prog.warmup}, expected {per_it}")
    base_k = max(2, min(25, params["early_stopping_round"]))
    solo_fetch = sum(m.fetch_counts.get("epoch", 0) for m in ms)
    if ms[0].fetch_counts.get("fleet_fetch") != fr.epochs \
            or prog.replays != fr.epochs * base_k:
        raise AssertionError(f"{name}: fetches {ms[0].fetch_counts}, "
                             f"{prog.replays} replays for {fr.epochs} "
                             f"epochs of {base_k}")
    for m in ms[1:]:
        if m.binned_dev is not ms[0].binned_dev \
                or m.valid_sets[0][1] is not ms[0].valid_sets[0][1] \
                or m.na_bin_dev is not ms[0].na_bin_dev:
            raise AssertionError(f"{name}: a shared operand was copied")
    its = [b.current_iteration for b in fr.boosters]
    left_early = [j for j, it in enumerate(its)
                  if it < fr.epochs * base_k]
    if name == FLEET_RAGGED and (not left_early or solo_fetch < 1
                                 or sum(fr.stopped) < 2):
        raise AssertionError(f"{name}: iterations {its} after {fr.epochs} "
                             f"fleet epochs of {base_k}, stopped "
                             f"{fr.stopped}, {solo_fetch} solo epochs: no "
                             "member rode its lane dead, or none finished "
                             "solo")
    device = {k: v * prog.replays + prog.warmup.get(k, 0)
              for k, v in prog.captured.items() if v}
    # wrapper calls: the warm-up before capture and the capture, nothing
    # eager besides (unless members finished solo, whose epochs then
    # fetched as "epoch")
    if solo_fetch == 0 and {k: v for k, v in eager.items() if v} \
            != {k: 2 * v for k, v in per_it.items()}:
        raise AssertionError(f"{name}: wrapper calls {eager}, expected "
                             f"twice {per_it}")
    solo_ms, texts_equal = [], []
    for j, b in enumerate(fr.boosters):
        sb = lgt.train(dict(fr.member_params[j]), train, rounds,
                       valid_sets=[valid])
        if b.model_to_string() != sb.model_to_string() \
                or b.best_iteration != sb.best_iteration:
            raise AssertionError(f"{name}: member {j} differs from its "
                                 "solo run on the card")
        texts_equal.append(True)
        st = sb._model.epoch_ms
        solo_ms.append(statistics.median(st[1:] if len(st) > 1 else st))
    steady = fr.epoch_ms[1:] if len(fr.epoch_ms) > 1 else fr.epoch_ms
    fleet_it_ms = statistics.median(steady) / base_k
    solo_it_ms = sum(solo_ms) / base_k
    # B14's fleet form against its bound: every member's iteration_bound
    # over its own trees, summed, less the shared reads of the root pass
    # and the valid walk (the matrices once for all members); and against
    # its plain version, the fleet body run eagerly (fleet_train only)
    nbytes, bounds = 0.0, []
    for m in ms:
        b_ms, b_by, b_bytes = iteration_bound(
            m.models, N_TRAIN, N_FEAT, int(train.max_bin),
            m.config.num_leaves, N_VALID,
            super_steps=m.step_counts if K > 1 else None)
        nbytes += b_bytes
        bounds.append((b_ms, b_by))
    nbytes -= (M - 1) * (N_TRAIN + N_VALID) * N_FEAT
    fleet_bound = bound_ms(nbytes, 0)
    if any(by == "operations" for _, by in bounds):
        fleet_bound = max(fleet_bound, (sum(b for b, _ in bounds),
                                        "operations"))
    plain_ms = None
    if name == FLEET_CELLS[0][0]:
        eager_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prog.run(1, [0] * M, [m._feature_masks(1) for m in ms],
                     [m.it_global for m in ms], eager=True)
            torch.cuda.synchronize()
            eager_ms.append(1e3 * (time.perf_counter() - t1))
        plain_ms = statistics.median(eager_ms)
    emit({"phase": name, "members": M, "leaves": leaves,
          "split_batch": K, "rounds": rounds, "k": base_k,
          "epochs": fr.epochs, "seconds": secs,
          "iterations": its, "left_the_fleet_early": left_early,
          "best_iteration": [b.best_iteration for b in fr.boosters],
          "stopped": fr.stopped,
          "valid_auc": [b.best_score.get("valid_0", {}).get("auc")
                        for b in fr.boosters],
          "fleet_fetches": ms[0].fetch_counts.get("fleet_fetch", 0),
          "solo_epoch_fetches": solo_fetch,
          "graph_replays": prog.replays,
          "captured_launches_per_replay": got,
          "shared_pass_launches_per_iteration": {
              kk: v for kk, v in got.items() if kk.endswith("_members")},
          "capture_ms": prog.capture_ms, "device_launches": device,
          "epoch_ms": fr.epoch_ms, "fleet_ms_per_iteration": fleet_it_ms,
          "solo_ms_per_iteration_summed": solo_it_ms,
          "solo_ms_per_iteration": [t / base_k for t in solo_ms],
          "models_equal_solo": texts_equal,
          "fleet_bound_ms_per_iteration": fleet_bound[0],
          "fleet_bound_by": fleet_bound[1],
          "fleet_bound_bytes_per_iteration": nbytes,
          "fleet_plain_ms_per_iteration": plain_ms})
    return {name: device}


# --- the computation-integrity layer (B17) ----------------------------------

def grow_bound(t, n: int, f: int, B: int, L: int):
    """The least time of one tree's growth at the main shape, from the
    tree ``t`` (host ``TreeArrays``): the root pass (every row's bins and
    vals in, its histogram out, B2 on it) and each active split step as
    ``iteration_bound`` counts it (B3s, B3 over the split leaf's rows, B1
    over the smaller child's, the subtraction, B2 on the pair).  Returns
    (ms, by, bytes)."""
    from lightgbm_torch.grower import tree_words
    hist = f * B * 12
    rec = 12 * 4
    books = L * rec + 2 * tree_words(L) * 4
    nbytes = n * (f + 12) + 2 * hist + rec + 4 * n
    ops = 3.0 * n * f + 40 * 2 * f * B
    for s in range(t.num_leaves - 1):
        kids = [t.internal_count[c] if c >= 0 else t.leaf_count[~c]
                for c in (t.left_child[s], t.right_child[s])]
        parent, small = int(t.internal_count[s]), int(min(kids))
        nbytes += 4 * hist + 2 * hist + 2 * rec + books + 9 * parent \
            + small * (f + 12)
        ops += 40 * 2 * 2 * f * B + 3 * f * B + 2 * parent + 3 * small * f
    ms, by = bound_ms(nbytes, ops)
    return ms, by, nbytes


def checked_per_iteration(per_it: dict) -> dict:
    """An iteration's launches with ``integrity_check_freq=1``: ``per_it``,
    one B17a and one B17b, and every grower kernel once more through the
    shadow set."""
    return {**per_it, "invariant_flags": 1, "score_recheck": 1,
            **{"shadow:" + k: per_it[k] for k in GROWER_KERNELS}}


def _flip_word(torch, t, idx: int, bit: int):
    """A copy of the int32/f32 tensor ``t`` with bit ``bit`` of its
    ``idx``-th flat word flipped."""
    c = t.clone()
    c.view(-1).view(torch.int32)[idx] ^= 1 << bit
    return c


def phase_integrity_kernels(torch, lgt, lgt_kernels, train):
    """B17a, B17b and B17c against their plain versions on the card, on
    healthy and bit-flipped inputs, and the shadow set against the
    primary one (trees bit for bit, every shadow launch counted under
    ``shadow:``); each timed beside its bound and library call.  Returns
    (kernels-line rows, the launches of B17c's oracle run)."""
    from lightgbm_torch import grower as gr
    from lightgbm_torch import integrity as itg
    from lightgbm_torch.ops import split as sp
    from lightgbm_torch.ops.histogram import (compute_histogram,
                                              feature_totals_residual,
                                              feature_totals_residual_plain,
                                              histogram_plain)
    from lightgbm_torch.utils import faultinject
    dev = torch.device("cuda", 0)
    binned = torch.as_tensor(train.binned).to(dev)
    n, f = binned.shape
    B = int(train.max_bin)
    L = NUM_LEAVES
    mappers = [train.bin_mappers[i] for i in train.used_features]
    num_bin = torch.tensor([m.num_bin for m in mappers], dtype=torch.int32,
                           device=dev)
    na_bin = torch.tensor([m.na_bin for m in mappers], dtype=torch.int32,
                          device=dev)
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    y = torch.as_tensor(train.metadata.label).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    p = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
    vals = torch.stack([p - y, p * (1 - p), torch.ones_like(y)], dim=1)
    params = sp.SplitParams()
    out = {}

    # the shadow set: a strict 31-leaf and a 255-leaf K = 16 tree grown by
    # both sets from the same operands, bit for bit, each shadow launch
    # the primary's under "shadow:"
    kw = dict(num_leaves=L, num_bins=B, params=params)
    ws = gr.GrowWorkspace(n, f, B, L, dev)
    shadow = gr.make_shadow_grower(ws)
    if not shadow.independent:
        raise AssertionError("the shadow grower on the card must be "
                             "independent")
    wkw = dict(num_leaves=WIDE_LEAVES, num_bins=B, params=params,
               split_batch=WIDE_K)
    wws = gr.GrowWorkspace(n, f, B, WIDE_LEAVES, dev, split_batch=WIDE_K)
    wshadow = gr.make_shadow_grower(wws)
    shadow_launches = {}
    for name, grow, w, sh, k in (("strict", gr.grow_tree, ws, shadow, kw),
                                 ("wide", gr.grow_tree_batched, wws,
                                  wshadow, wkw)):
        lgt_kernels.reset_launch_counts()
        grow(binned, vals, fmask, num_bin, na_bin, workspace=w, **k)
        mid = lgt_kernels.launch_counts()
        sh_tree = sh.grow(grow, binned, vals, fmask, num_bin, na_bin, **k)
        torch.cuda.synchronize()
        after = lgt_kernels.launch_counts()
        prim = {kk: v for kk, v in mid.items() if v}
        shad = {kk: after[kk] - mid[kk] for kk in after
                if after[kk] != mid[kk]}
        if shad != {"shadow:" + kk: v for kk, v in prim.items()}:
            raise AssertionError(f"shadow {name} tree launched {shad}, the "
                                 f"primary {prim}")
        if not torch.equal(sh_tree, w.tree) or not torch.equal(
                sh.ws.leaf_of_row, w.leaf_of_row):
            raise AssertionError(f"the shadow set's {name} tree differs "
                                 "from the primary's")
        shadow_launches[name] = shad
    # B1 through the shadow set: the primary's bits, and its plain version
    # within HIST_RTOL
    h_k = compute_histogram(binned, vals, num_bins=B)
    with lgt_kernels.shadow_set():
        h_s = compute_histogram(binned, vals, num_bins=B)
    h_p = histogram_plain(binned, vals, num_bins=B)
    errs = float((h_s - h_p).abs().max())
    if not torch.equal(h_s, h_k) \
            or errs > HIST_RTOL * max(1.0, float(h_p.abs().max())):
        raise AssertionError(f"shadow B1 differs (max abs err {errs} "
                             "against the plain version)")

    def grow_p():
        gr.grow_tree(binned, vals, fmask, num_bin, na_bin, workspace=ws,
                     **kw)

    def grow_s():
        shadow.grow(gr.grow_tree, binned, vals, fmask, num_bin, na_bin,
                    **kw)
    t_p = median_ms(torch, grow_p, reps=SHADOW_GROW_REPS, warmup=2)
    t_s = median_ms(torch, grow_s, reps=SHADOW_GROW_REPS, warmup=2)
    t_s2 = median_ms(torch, grow_s, reps=SHADOW_GROW_REPS, warmup=2)
    t_p2 = median_ms(torch, grow_p, reps=SHADOW_GROW_REPS, warmup=2)
    if not torch.equal(shadow.ws.tree, ws.tree):
        raise AssertionError("the timed shadow tree differs")
    tree = gr.fetch_tree(ws)
    gb_ms, gb_by, gb_bytes = grow_bound(tree, n, f, B, L)
    shadow_build = {k: v for k, v in BUILD_S.items()
                    if k.endswith("_shadow")}
    out["shadow_grow"] = {
        "name": "B17-shadow grower (the grower's kernels from the shadow "
                "libraries; 31-leaf tree)",
        "route": "cuda", "source": "lightgbm_torch/grower.py",
        "replaces": "lightgbm_tpu/grower.py:1284", "max_abs_err": 0.0,
        "ms": statistics.median([t_s, t_s2]),
        "plain_ms": statistics.median([t_p, t_p2]),
        "bound_ms": gb_ms, "bound_by": gb_by, "library_ms": None}
    emit({"phase": "kernel", **out["shadow_grow"],
          "plain_is": "the primary set's grow of the same tree",
          "times_p_s_s_p": [t_p, t_s, t_s2, t_p2],
          "bound_bytes": gb_bytes, "tree_leaves": tree.num_leaves,
          "shadow_launches_per_tree": shadow_launches,
          "shadow_build_s": shadow_build})

    # B17a: the healthy trees, then bit flips of counts and gains, a
    # non-finite gain and a stump
    lay = gr.tree_layout(L)
    cases = [("healthy", ws.tree)]
    for fld in ("leaf_count", "internal_count"):
        off = lay[fld][0]
        for i in (0, 3, 11):
            for bit in range(8, 31, 2):
                cases.append((f"{fld}[{i}] bit {bit}",
                              _flip_word(torch, ws.tree, off + i, bit)))
    g_inf = ws.tree.clone()
    g_inf[lay["split_gain"][0] + 2] = 0x7F800000       # +inf
    stump = ws.tree.clone()
    stump[lay["num_leaves"][0]] = 1
    cases += [("gain inf", g_inf), ("stump", stump)]
    tripped = 0
    for what, t in cases:
        fk = itg.invariant_flags(t, L)
        fp = itg.invariant_flags_plain(t, L)
        if not torch.equal(fk, fp):
            raise AssertionError(f"B17a ({what}): {fk.item()} against the "
                                 f"plain version's {fp.item()}")
        tripped += int(fk.item() == 0)
    for what, t, LL in (("wide healthy", wws.tree, WIDE_LEAVES),
                        ("wide leaf_count[0] bit 29",
                         _flip_word(torch, wws.tree,
                                    gr.tree_layout(WIDE_LEAVES)
                                    ["leaf_count"][0], 29), WIDE_LEAVES)):
        fk = itg.invariant_flags(t, LL)
        if not torch.equal(fk, itg.invariant_flags_plain(t, LL)):
            raise AssertionError(f"B17a ({what}) differs")
        tripped += int(fk.item() == 0)
    if int(itg.invariant_flags(ws.tree, L)[0]) != 1 \
            or int(itg.invariant_flags(g_inf, L)[0]) != 0:
        raise AssertionError("B17a's flags on the healthy tree or the "
                             "infinite gain are wrong")
    ta_k = median_ms(torch, lambda: itg.invariant_flags(ws.tree, L))
    ta_p = median_ms(torch, lambda: itg.invariant_flags_plain(ws.tree, L))
    a_bytes = 4 + 16 * (L - 1) + 4 * L + 4
    out["invariant_flags"] = {
        "name": "B17a tree invariants", "route": "cuda",
        "source": "lightgbm_torch/csrc/integrity.cu",
        "replaces": "lightgbm_tpu/integrity.py:179", "max_abs_err": 0.0,
        "ms": ta_k, "plain_ms": ta_p,
        **dict(zip(("bound_ms", "bound_by"), bound_ms(a_bytes, 12 * L))),
        "library_ms": None}
    emit({"phase": "kernel", **out["invariant_flags"],
          "cases": len(cases) + 2, "tripped": tripped})

    # B17b: the tree's shrunk values, its rows' leaves and the primary
    # gather; healthy, flipped rows (one through the score_sdc site) and
    # a leaf index out of range
    lv = (ws.fields["leaf_value"] * 0.1).contiguous()
    lor = ws.leaf_of_row
    delta = lv.index_select(0, lor)
    faultinject.configure("score_sdc:1")
    try:
        sdc = faultinject.maybe_bitflip("score_sdc", delta.clone())
    finally:
        faultinject.clear()
    lor_out = lor.clone()
    lor_out[n - 1] = L
    bcases = [("healthy", lv, lor, delta, 0), ("score_sdc:1", lv, lor, sdc, 1),
              ("leaf out of range", lv, lor_out, delta, 1)]
    for r, bit in ((0, 9), (n // 2, 22), (n - 1, 30)):
        bcases.append((f"row {r} bit {bit}", lv, lor,
                       _flip_word(torch, delta, r, bit), 1))
    for what, a, b, c, want in bcases:
        fk = itg.score_mismatch(a, b, c)
        fp = itg.score_mismatch_plain(a, b, c)
        if not torch.equal(fk, fp) or int(fk[0]) != want:
            raise AssertionError(f"B17b ({what}): {fk.item()}, plain "
                                 f"{fp.item()}, expected {want}")
    tb_k = median_ms(torch, lambda: itg.score_mismatch(lv, lor, delta))
    tb_p = median_ms(torch, lambda: itg.score_mismatch_plain(lv, lor,
                                                             delta))
    tb_l = median_ms(torch, lambda: (lv.index_select(0, lor)
                                     != delta).any())
    out["score_recheck"] = {
        "name": "B17b score re-gather check", "route": "cuda",
        "source": "lightgbm_torch/csrc/integrity.cu",
        "replaces": "lightgbm_tpu/integrity.py:361", "max_abs_err": 0.0,
        "ms": tb_k, "plain_ms": tb_p,
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(8 * n + 4 * L + 4, 2 * n))),
        "library_ms": tb_l}
    emit({"phase": "kernel", **out["score_recheck"], "cases": len(bcases)})

    # B17c: the oracle on B1's root pass of the main data (its path), then
    # against its plain version on that and on flipped inputs, f32 and
    # the integer form (B1-int's exact histogram of int8 vals)
    hist = compute_histogram(binned, vals, num_bins=B)
    lgt_kernels.reset_launch_counts()
    r_oracle = float(feature_totals_residual(hist, vals))
    oracle = lgt_kernels.launch_counts()
    scale = float(vals.abs().to(torch.float64).sum(0).max())
    if r_oracle > HIST_RTOL * scale:
        raise AssertionError(f"B17c: B1's root pass leaves a residual "
                             f"{r_oracle} (column scale {scale})")
    qv = torch.randint(-127, 128, (n, 3), dtype=torch.int8, device=dev,
                       generator=gen)
    hq = compute_histogram(binned, qv, num_bins=B)
    ccases = [("f32 root pass", hist, vals),
              ("f32 hist bit 27", _flip_word(torch, hist, 2 * B * 3 + 17,
                                             27), vals),
              ("f32 vals bit 30", hist, _flip_word(torch, vals, 3 * 777,
                                                   30)),
              ("int8 root pass", hq, qv),
              ("int32 hist bit 12", _flip_word(torch, hq, 5 * B * 3 + 4,
                                               12), qv)]
    err_c = 0.0
    for what, h, v in ccases:
        rk = float(feature_totals_residual(h, v))
        rp = float(feature_totals_residual_plain(h, v))
        e = abs(rk - rp)
        exact = h.dtype == torch.int32
        if (exact and e != 0.0) or e > TOTALS_RTOL * max(scale, rp):
            raise AssertionError(f"B17c ({what}): {rk} against the plain "
                                 f"version's {rp}")
        if ("bit" in what) != (rk > 1.0):
            raise AssertionError(f"B17c ({what}): residual {rk}")
        err_c = max(err_c, e)
    tc_k = median_ms(torch, lambda: feature_totals_residual(hist, vals))
    tc_p = median_ms(torch, lambda: feature_totals_residual_plain(hist,
                                                                  vals))
    tc_l = median_ms(torch, lambda: (hist.sum(1) - vals.sum(0))
                     .abs().amax())
    out["totals_residual"] = {
        "name": "B17c feature totals residual (f32, B1's root pass)",
        "route": "cuda", "source": "lightgbm_torch/csrc/integrity.cu",
        "replaces": "lightgbm_tpu/ops/histogram.py:242",
        "max_abs_err": err_c, "ms": tc_k, "plain_ms": tc_p,
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(hist.numel() * 4 + vals.numel() * 4 + 8,
                            vals.numel() + hist.numel()))),
        "library_ms": tc_l}
    emit({"phase": "kernel", **out["totals_residual"],
          "oracle_residual": r_oracle, "column_scale": scale,
          "cases": len(ccases)})
    return out, oracle


def phase_integrity_train(torch, lgt, lgt_kernels, train, valid):
    """The main configuration on the per-iteration loop with
    ``integrity_check_freq=1`` against the same run unchecked, the
    injected transients and sticky failures, and one 255-leaf quant_train
    checked run (module docstring).  Returns the launches of the checked
    runs by path."""
    from lightgbm_torch import integrity as itg
    from lightgbm_torch.parallel import elastic
    from lightgbm_torch.utils import faultinject
    pi = {"superepoch": -1, "fused_chunk": 1, "fused_eval": "true"}
    chk = {**pi, "integrity_check_freq": 1}
    drop = "[integrity_check_freq:", "[integrity_policy:"

    def text(b):
        return without_path_params(b.model_to_string(), *drop)

    def mvals():
        return {k: v["value"] for k, v in itg.metrics_snapshot().items()}

    out = {}
    res = {}
    for name, extra, per_it, rounds in (
            ("integrity_train", {}, PER_ITERATION, INTEGRITY_ROUNDS),
            ("integrity_quant_wide_train", QUANT_WIDE_PARAMS,
             QUANT_WIDE_PER_ITERATION, CUT_ROUNDS)):
        ref, ref_ev, ref_s = train_main(lgt, train, valid, timed=True,
                                        extra={**extra, **pi},
                                        rounds=rounds)
        rm = ref._model
        itg.reset_metrics()
        lgt_kernels.reset_launch_counts()
        bst, ev, secs = train_main(lgt, train, valid, timed=True,
                                   extra={**extra, **chk}, rounds=rounds)
        torch.cuda.synchronize()
        launches = lgt_kernels.launch_counts()
        m = bst._model
        n = m.num_iterations_trained
        want = checked_per_iteration(per_it)
        if n != rm.num_iterations_trained \
                or launches != times(want, n):
            raise AssertionError(f"{name}: launches {launches} for {n} "
                                 f"iterations, expected {want} each")
        shadow = {k: v for k, v in launches.items()
                  if k.startswith("shadow:") and v}
        if shadow != {"shadow:" + k: v for k, v in launches.items()
                      if k in GROWER_KERNELS and v}:
            raise AssertionError(f"{name}: shadow launches {shadow} are "
                                 "not the primary grower's")
        if text(bst) != text(ref) or ev != ref_ev:
            raise AssertionError(f"{name}: checked model text or evals "
                                 "differ from the unchecked run's")
        fetches = {"tree": n, "traced_eval": n, "integrity": n,
                   "integrity_score": n}
        mv = mvals()
        if m.fetch_counts != fetches \
                or mv.get("integrity.checks{path=grow}") != n \
                or mv.get("integrity.checks{path=score}") != n \
                or any("mismatches" in k for k in mv):
            raise AssertionError(f"{name}: fetches {m.fetch_counts}, "
                                 f"metrics {mv}")
        man = m.integrity_manifest(n)
        if not (man["verified"] and man["independent_trace"]):
            raise AssertionError(f"{name}: manifest {man}")
        out[name] = {**launches, "shadow_grow": sum(shadow.values())}
        res[name] = {
            "iterations": n, "rounds": rounds,
            "ms_per_iteration": 1e3 * secs / n,
            "unchecked_ms_per_iteration":
                1e3 * ref_s / rm.num_iterations_trained,
            "phase_ms_per_iteration": {
                k: v / n for k, v in m.phase_timer.totals_ms().items()},
            "unchecked_phase_ms_per_iteration": {
                k: v / n for k, v in rm.phase_timer.totals_ms().items()},
            "host_fetches": m.fetch_counts,
            "unchecked_host_fetches": rm.fetch_counts,
            "launches_per_iteration": {k: v // n for k, v in
                                       launches.items() if v},
            "model_text_equal": True, "manifest": man}

    # injected transients, absorbed byte-identically, and sticky failures
    # under the raise and quarantine policies
    def fault_run(spec, extra=None):
        faultinject.configure(spec)
        try:
            return train_main(lgt, train, valid, extra={**chk,
                                                        **(extra or {})},
                              rounds=INTEGRITY_FAULT_ROUNDS)[0]
        finally:
            faultinject.clear()

    clean = text(fault_run(None))
    faults = {}
    for spec, path in (("hist_sdc:3", "grow"), ("score_sdc:3", "score")):
        itg.reset_metrics()
        b = fault_run(spec)
        mv = mvals()
        if text(b) != clean \
                or mv.get(f"integrity.mismatches{{path={path}}}") != 1 \
                or mv.get("integrity.transient_absorbed") != 1 \
                or b._model.fetch_counts.get("integrity_recheck") != 1:
            raise AssertionError(f"{spec}: not absorbed byte-identically "
                                 f"({mv}, {b._model.fetch_counts})")
        faults[spec] = {"absorbed": True, "byte_identical": True,
                        "metrics": mv}
    card = torch.cuda.current_device()
    for policy in ("raise", "quarantine"):
        elastic.clear_suspects()
        itg.reset_metrics()
        try:
            fault_run("hist_sdc:3-4", {"integrity_policy": policy})
        except itg.IntegrityFailure as e:
            fail = e
        else:
            raise AssertionError(f"hist_sdc:3-4 ({policy}) raised nothing")
        suspects = elastic.suspected_devices()
        if elastic.failure_kind(fail) != "sdc" or fail.iteration != 3 \
                or fail.devices != (card,) \
                or not any(d["field"] == "leaf_count"
                           for d in fail.divergences) \
                or suspects != (frozenset({card}) if policy == "quarantine"
                                else frozenset()):
            raise AssertionError(f"sticky failure ({policy}): {fail!r}, "
                                 f"devices {fail.devices}, suspects "
                                 f"{suspects}")
        faults[f"hist_sdc:3-4 {policy}"] = {
            "raised": type(fail).__name__, "kind": fail.kind,
            "iteration": fail.iteration, "devices": list(fail.devices),
            "fields": [d["field"] for d in fail.divergences],
            "suspects": sorted(suspects)}
    elastic.clear_suspects()
    emit({"phase": "integrity_train", **res["integrity_train"],
          "faults": faults,
          "quant_wide": res["integrity_quant_wide_train"]})
    return out


# ---------------------------------------------------------------------------
# the wide widths K = 32 and 64, rows_per_block and the autotuner (B15)
# ---------------------------------------------------------------------------

def _wide_operands(torch, train, seed: int):
    """The wide configuration's device operands on the HIGGS-shaped rows:
    binned, bin metadata, a logistic step's (g, h) and iteration 0's
    bagging vals."""
    from lightgbm_torch.ops.random import bag_vals
    dev = torch.device("cuda", 0)
    binned = torch.as_tensor(train.binned).to(dev)
    mappers = [train.bin_mappers[i] for i in train.used_features]
    num_bin = torch.tensor([m.num_bin for m in mappers], dtype=torch.int32,
                           device=dev)
    na_bin = torch.tensor([m.na_bin for m in mappers], dtype=torch.int32,
                          device=dev)
    y = torch.as_tensor(train.metadata.label).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = torch.sigmoid(torch.randn(binned.shape[0], device=dev,
                                  generator=gen))
    g, h = (p - y).contiguous(), (p * (1 - p)).contiguous()
    vals = bag_vals(g, h, torch.tensor([0], dtype=torch.int32, device=dev),
                    seed=3, freq=5, fraction=0.8)
    return binned, num_bin, na_bin, vals, gen


def _int8_vals(torch, vals):
    """int8 vals of the same rows (B1-K-int's operand): each channel
    scaled to 127 by its largest magnitude and rounded."""
    scale = vals.abs().amax(dim=0).clamp_min(1e-30)
    return torch.round(vals / scale * 127).to(torch.int8).contiguous()


def _slots_library(torch, binned, vals, slot, B, K):
    """``index_add_`` of the K-slot pass's rows over precomputed cells:
    B1-K's library yardstick."""
    n, f = binned.shape
    keep = slot >= 0
    sl = slot[keep].to(torch.int64)
    idx = (binned[keep].to(torch.int64)
           + torch.arange(f, device=binned.device) * B
           + (sl * (f * B))[:, None]).reshape(-1)
    src = vals[keep].repeat_interleave(f, dim=0)
    acc = torch.zeros((K * f * B, 3), device=binned.device)
    return median_ms(torch, lambda: acc.zero_().index_add_(0, idx, src))


def _kernel_row(key, name, src, replaces, err, rel, t_k, t_p, bound, t_lib,
                **extra):
    bms, by = bound
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "max_abs_err": err, "ms": t_k,
           "plain_ms": t_p, "bound_ms": bms, "bound_by": by,
           "library_ms": t_lib}
    emit({"phase": "kernel", "key": key, **row, "max_rel_err": rel,
          "kernel_ms": t_k, **extra})
    return row


def phase_wide_k_kernels(torch, lgt, train):
    """Every K-shaped kernel at K = 32 and 64 against its plain version on
    the wide configuration's rows (1M x 28, 63 bins, 255 leaves): whole
    trees with B3s-K and B3-K bit for bit at every super-step
    (``check_batched_tree``), then on the first super-step with all K
    slots valid B1-K (within HIST_RTOL, bitwise on a rerun, and
    ``check_b1k_card``), B1-K-int
    (bitwise), B3s-K and B3-K (timed), B6-node on the 2K children (bit
    for bit, two iterations), B2 on the 2K children with their masks and
    random bins and B2-cat on WIDE_K_CAT_COLS columns read as categories
    (against the plain version on CPU copies), each timed beside its
    bound and library call."""
    from lightgbm_torch import _kernels as lgt_kernels
    from lightgbm_torch import grower as gr
    from lightgbm_torch.ops import random as rnd
    from lightgbm_torch.ops import split as sp
    from lightgbm_torch.ops.histogram import (compute_histogram,
                                              histogram_slots_int_plain,
                                              histogram_slots_plain,
                                              int_launch_shape)
    binned, num_bin, na_bin, vals, gen = _wide_operands(torch, train, 5)
    dev = binned.device
    n, f = binned.shape
    B, L = int(train.max_bin), WIDE_LEAVES
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    params = sp.SplitParams()
    q = _int8_vals(torch, vals)
    root = compute_histogram(binned, vals, num_bins=B)
    samp = rnd.NodeSampling(bynode_frac=0.8, bynode_seed=3,
                            extra_trees=True, extra_seed=6)
    is_cat = torch.zeros(f, dtype=torch.bool, device=dev)
    is_cat[:WIDE_K_CAT_COLS] = True
    out, cases = {}, {}
    for K in WIDE_KS:
        C = 2 * K
        snap = {}
        cases[K] = check_batched_tree(
            torch, binned, vals, fmask, num_bin, na_bin, B, L, K, params,
            -1, f"full_k{K}", snap)
        if cases[K]["leaves"] != L or "state" not in snap:
            raise AssertionError(f"K = {K}: the tree has no super-step "
                                 f"with all slots valid: {cases[K]}")
        st = snap["state"]
        tslot, used = st["tslot"], st["used"]
        in_slots = int((tslot >= 0).sum())

        # B1-K: within HIST_RTOL of the plain version, bitwise reruns
        a = compute_histogram(binned, vals, num_bins=B, slot=tslot,
                              num_slots=K, slots_used=used)
        if not torch.equal(a, compute_histogram(
                binned, vals, num_bins=B, slot=tslot, num_slots=K,
                slots_used=used)):
            raise AssertionError(f"B1-K (K = {K}) is not bitwise "
                                 "reproducible")
        b = histogram_slots_plain(binned, vals, tslot, num_slots=K,
                                  num_bins=B)
        e = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not torch.equal(a[..., 2], b[..., 2]) \
                or e > HIST_RTOL * max(1.0, scale):
            raise AssertionError(f"B1-K (K = {K}) max abs error {e} "
                                 f"(scale {scale})")
        t_k = median_ms(torch, lambda: compute_histogram(
            binned, vals, num_bins=B, slot=tslot, num_slots=K,
            slots_used=used))
        t_p = median_ms(torch, lambda: histogram_slots_plain(
            binned, vals, tslot, num_slots=K, num_bins=B), reps=10,
            warmup=2)
        t_lib = _slots_library(torch, binned, vals, tslot, B, K)
        fixed = check_b1k_card(torch, lgt_kernels, binned, vals, tslot,
                               used, B, K, f"K = {K}")
        out[f"histogram_slots_k{K}"] = _kernel_row(
            f"histogram_slots_k{K}", f"B1-K K-slot histogram (K = {K})",
            "lightgbm_torch/csrc/histogram.cu",
            "lightgbm_tpu/ops/histogram.py:129", e, e / max(scale, 1e-30),
            t_k, t_p, bound_ms(n * f + 16 * n + K * f * B * 12,
                               3 * in_slots * f), t_lib,
            rows_in_slots=in_slots, slots_used=int(used[0]),
            fixed_point=fixed)

        # B1-K-int: bitwise against its plain version
        ai = compute_histogram(binned, q, num_bins=B, slot=tslot,
                               num_slots=K, slots_used=used)
        bi = histogram_slots_int_plain(binned, q, tslot, num_slots=K,
                                       num_bins=B)
        err_i = exact_err(torch, [(ai, bi)], f"B1-K-int (K = {K})")
        t_k = median_ms(torch, lambda: compute_histogram(
            binned, q, num_bins=B, slot=tslot, num_slots=K,
            slots_used=used))
        t_p = median_ms(torch, lambda: histogram_slots_int_plain(
            binned, q, tslot, num_slots=K, num_bins=B), reps=10, warmup=2)
        err_i = max(err_i, exact_err(torch, [(ai, compute_histogram(
            binned, q, num_bins=B, slot=tslot, num_slots=K,
            slots_used=used))], f"B1-K-int (K = {K}, timed call)"))
        out[f"histogram_slots_int_k{K}"] = _kernel_row(
            f"histogram_slots_int_k{K}",
            f"B1-K-int K-slot integer histogram (K = {K}, int8)",
            "lightgbm_torch/csrc/histogram.cu",
            "lightgbm_tpu/ops/histogram.py:143", err_i, err_i, t_k, t_p,
            int_pass_bound(n, f, B, in_slots, K),
            _int_index_add(torch, binned, q, tslot, B, K),
            rows_in_slots=in_slots,
            launch_shape=list(int_launch_shape(n, f, B, K)))

        # B3s-K on the snapshot's table and tree, every timed call from
        # its state; the outputs of the last timed call of each compared
        def b3sk_call(fn):
            st["tree"] = st.get("tree", st["tree0"].clone())
            st["tree"].copy_(st["tree0"])
            fn(st["table"], st["tree"], na_bin, num_leaves=L,
               split_batch=K, max_depth=-1, step=st["step"])
        t_k = median_ms(torch, lambda: b3sk_call(gr.grow_step_batched))
        got_k = [t.clone() for t in (st["tree"], *st["step"])]
        t_p = median_ms(torch, lambda: b3sk_call(gr.grow_step_batched_plain))
        err3sk = exact_err(torch, zip(got_k, (st["tree"], *st["step"])),
                           f"B3s-K (K = {K}, timed call)")
        words = st["tree0"].numel()
        b3sk_bytes = L * 4 + K * sp.RECORD * 4 + 2 * words * 4 + f * 4 \
            + K * 8 * 4 + L * 4 + 2 * K * (8 + 16 + 1) + K + 8
        out[f"grow_step_batched_k{K}"] = _kernel_row(
            f"grow_step_batched_k{K}", f"B3s-K batched split step (K = {K})",
            "lightgbm_torch/csrc/grow_step.cu", "lightgbm_tpu/grower.py:999",
            err3sk, err3sk, t_k, t_p, bound_ms(b3sk_bytes, L * L), None)

        # B3-K on the snapshot's super-step, every timed call from its
        # state
        lor, lor_p = st["lor"].clone(), st["lor"].clone()
        iota = torch.arange(B, dtype=torch.int32, device=dev)
        step = st["step"]
        t_k = median_ms(torch, lambda: gr.partition_slots(
            binned, lor.copy_(st["lor"]), step, iota))
        t_p = median_ms(torch, lambda: gr.partition_slots_plain(
            binned, lor_p.copy_(st["lor"]), step, iota))
        err3k = exact_err(torch, [
            (gr.partition_slots(binned, lor.copy_(st["lor"]), step, iota),
             gr.partition_slots_plain(binned, lor_p.copy_(st["lor"]), step,
                                      iota)), (lor, lor_p)],
            f"B3-K (K = {K}, timed call)")
        out[f"partition_slots_k{K}"] = _kernel_row(
            f"partition_slots_k{K}", f"B3-K batched row partition (K = {K})",
            "lightgbm_torch/csrc/partition.cu",
            "lightgbm_tpu/grower.py:1029", err3k, err3k, t_k, t_p,
            bound_ms(n * f + 12 * n, 3 * n), None)

        # B6-node on the 2K children, two iterations, bit for bit
        base = fmask.clone()
        base[torch.randperm(f, device=dev, generator=gen)[:f // 5]] = False
        draws = {}
        for it in (0, 9):
            itd = torch.tensor([it], dtype=torch.int32, device=dev)
            kw = dict(count=C, bynode_id0=2 * C, extra_step=2,
                      sampling=samp)
            mk = torch.zeros((C, f), dtype=torch.bool, device=dev)
            bk = torch.zeros((C, f), dtype=torch.int32, device=dev)
            rnd.node_draws(base, num_bin, itd, masks=mk, bins=bk, **kw)
            mp, bp = rnd.node_draws_plain(base, num_bin, itd, **kw)
            if not (torch.equal(mk, mp) and torch.equal(bk, bp)):
                raise AssertionError(f"B6-node ({C} children, iteration "
                                     f"{it}) differs from its plain "
                                     "version")
            draws[it] = (mk, bk)
        if torch.equal(draws[0][0], draws[9][0]):
            raise AssertionError(f"B6-node ({C} children): iterations 0 "
                                 "and 9 drew the same masks")
        it9 = torch.tensor([9], dtype=torch.int32, device=dev)
        kw = dict(count=C, bynode_id0=2 * C, extra_step=2, sampling=samp)
        mk, bk = (t.clone() for t in draws[9])
        t_k = median_ms(torch, lambda: rnd.node_draws(
            base, num_bin, it9, masks=mk, bins=bk, **kw))
        # the plain version's per-child loop takes a few hundred ms a call
        t_p = median_ms(torch, lambda: rnd.node_draws_plain(
            base, num_bin, it9, **kw), reps=5, warmup=1)
        mp, bp = rnd.node_draws_plain(base, num_bin, it9, **kw)
        err6 = exact_err(torch, [(mk, mp), (bk, bp)],
                         f"B6-node ({C} children, timed call)")
        out[f"node_draws_k{K}"] = _kernel_row(
            f"node_draws_k{K}", "B6-node per-child feature subsets and "
            f"random bins (2K = {C} children)",
            "lightgbm_torch/csrc/sample.cu", "lightgbm_tpu/grower.py:495",
            err6, err6, t_k, t_p,
            bound_ms(f + 4 * f + 4 + C * f + 4 * C * f,
                     C * f * (2 * THREEFRY_OPS
                              + int(np.ceil(np.log2(f))) + 1)), None)

        # B2 on the 2K children (the super-step's smaller children and
        # their root complements) with the children's masks and random
        # bins, against the plain version on the same inputs
        masks, bins = draws[9]
        pair = torch.cat([a, root[None] - a]).contiguous()
        tot = pair[:, 0].sum(dim=1).contiguous()
        po = torch.zeros(C, device=dev)
        r_k = sp.find_best_split(pair, tot, po, num_bin, na_bin, masks,
                                 params, rand_bin=bins)
        r_p = sp.find_best_split_plain(pair, tot, po, num_bin, na_bin,
                                       masks, params, rand_bin=bins)
        err2, rel2 = check_split(torch, sp, r_k, r_p,
                                 f"per child, 2K = {C}")
        t_k = median_ms(torch, lambda: sp.find_best_split(
            pair, tot, po, num_bin, na_bin, masks, params, rand_bin=bins))
        t_p = median_ms(torch, lambda: sp.find_best_split_plain(
            pair, tot, po, num_bin, na_bin, masks, params, rand_bin=bins))
        e, r = check_split(torch, sp, sp.find_best_split(
            pair, tot, po, num_bin, na_bin, masks, params, rand_bin=bins),
            r_p, f"per child, 2K = {C}, timed inputs")
        err2, rel2 = max(err2, e), max(rel2, r)
        b2_bytes = pair.numel() * 4 + C * 3 * 4 + C * 4 + 2 * f * 4 \
            + C * f * 5 + C * sp.RECORD * 4
        out[f"split_per_child_k{K}"] = _kernel_row(
            f"split_per_child_k{K}", "B2 split scan, per-child masks and "
            f"random bins (2K = {C} children)",
            "lightgbm_torch/csrc/split.cu", "lightgbm_tpu/ops/split.py:229",
            err2, rel2, t_k, t_p, bound_ms(b2_bytes, 40 * C * f * B), None,
            children_with_a_split=int((~torch.isneginf(
                r_k[:, sp.GAIN])).sum()))

        # B2-cat on the 2K children, the first WIDE_K_CAT_COLS columns read
        # as categories: B2 with B2-cat against the plain version on CPU
        # copies (per-child masks), then B2-cat alone timed
        errc, relc, cat, _ = check_cat_split(
            torch, sp, (pair, tot, po, num_bin, na_bin, masks), params,
            is_cat, f"2K = {C}")
        r_num = sp.find_best_split(pair, tot, po, num_bin, na_bin, fmask,
                                   params)
        work = r_num.clone()
        t_k = median_ms(torch, lambda: sp._split_cat(
            pair, tot, po, fmask, 0, is_cat, params, None,
            work.copy_(r_num)))
        t_p = median_ms(torch, lambda: sp._categorical_plain(
            pair, tot, po, fmask & is_cat, params, r_num))
        hc = pair[:, :WIDE_K_CAT_COLS]
        use = hc[..., 2] >= max(0.5, params.min_data_per_group - 0.5)
        ratio = hc[..., 0] / (hc[..., 1] + params.cat_smooth)
        keys = torch.stack([torch.where(use, ratio, 1e30),
                            torch.where(use, -ratio, 1e30)], dim=2)
        t_lib = median_ms(torch, lambda: torch.sort(keys, dim=-1,
                                                    stable=True))
        nc = WIDE_K_CAT_COLS
        b2c_bytes = C * nc * B * 12 + C * 16 + 2 * C * sp.RECORD * 4 \
            + C * 4 + C * B * 4 + 2 * f
        b2c_ops = C * nc * (2 * B * float(np.log2(B)) + 6 * B + 120 * B)
        out[f"split_cat_k{K}"] = _kernel_row(
            f"split_cat_k{K}", f"B2-cat categorical split scan (2K = {C} "
            "children)", "lightgbm_torch/csrc/split.cu",
            "lightgbm_tpu/ops/split.py:236", errc, relc, t_k, t_p,
            bound_ms(b2c_bytes, b2c_ops), t_lib,
            categorical_winners=int(cat.sum()))
    emit({"phase": "wide_k_checks", "cases": {str(k): v
                                              for k, v in cases.items()}})
    return out


def phase_rows_per_block(torch, lgt, lgt_kernels, train):
    """``rows_per_block`` on the card: B1 and B1-K (K = 16) at the
    automatic row block and at RPB_VALUES against their plain versions
    (within HIST_RTOL), bitwise on a rerun at each value, B1-K bitwise
    equal across the values; B1-int and B1-K-int bitwise equal across the
    values and to their plain versions;
    each timed at every value; and the shadow grower at an explicit value
    growing a strict and a K = 16 tree bit for bit as the primary grower
    (the same launch geometry).  Returns the kernel times by value."""
    from lightgbm_torch import grower as gr
    from lightgbm_torch.ops import split as sp
    from lightgbm_torch.ops.histogram import (compute_histogram,
                                              histogram_int_plain,
                                              histogram_plain,
                                              histogram_slots_int_plain,
                                              histogram_slots_plain,
                                              int_launch_shape,
                                              launch_shape,
                                              slots_launch_shape)
    binned, num_bin, na_bin, vals, gen = _wide_operands(torch, train, 6)
    dev = binned.device
    n, f = binned.shape
    B, K = int(train.max_bin), WIDE_K
    q = _int8_vals(torch, vals)
    slot = torch.randint(-1, K, (n,), dtype=torch.int32, device=dev,
                         generator=gen)
    used = torch.tensor([K], dtype=torch.int32, device=dev)
    plain = {"B1": histogram_plain(binned, vals, num_bins=B),
             "B1-K": histogram_slots_plain(binned, vals, slot, num_slots=K,
                                           num_bins=B),
             "B1-int": histogram_int_plain(binned, q, num_bins=B),
             "B1-K-int": histogram_slots_int_plain(binned, q, slot,
                                                   num_slots=K, num_bins=B)}
    calls = {"B1": lambda r: compute_histogram(binned, vals, num_bins=B,
                                               rows_per_block=r),
             "B1-K": lambda r: compute_histogram(
                 binned, vals, num_bins=B, slot=slot, num_slots=K,
                 slots_used=used, rows_per_block=r),
             "B1-int": lambda r: compute_histogram(binned, q, num_bins=B,
                                                   rows_per_block=r),
             "B1-K-int": lambda r: compute_histogram(
                 binned, q, num_bins=B, slot=slot, num_slots=K,
                 slots_used=used, rows_per_block=r)}
    shapes = {"B1": lambda r: launch_shape(n, f, B, r),
              "B1-K": lambda r: slots_launch_shape(n, f, B, K, r),
              "B1-int": lambda r: int_launch_shape(n, f, B, None, r),
              "B1-K-int": lambda r: int_launch_shape(n, f, B, K, r)}
    report = {}
    for form, call in calls.items():
        first = None
        report[form] = {}
        for r in (0,) + RPB_VALUES:
            h = call(r)
            if not torch.equal(h, call(r)):
                raise AssertionError(f"{form} at rows_per_block={r} is not "
                                     "bitwise reproducible")
            p = plain[form]
            if h.dtype == torch.int32:
                if not torch.equal(h, p) or (first is not None
                                             and not torch.equal(h, first)):
                    raise AssertionError(f"{form} at rows_per_block={r} "
                                         "differs from its plain version "
                                         "or from the automatic shape")
                e = 0.0
            else:
                e = float((h - p).abs().max())
                if e > HIST_RTOL * max(1.0, float(p.abs().max())):
                    raise AssertionError(f"{form} at rows_per_block={r}: "
                                         f"max abs error {e}")
                # B1-K's fixed-point sums: the same bits at every value
                if form == "B1-K" and first is not None \
                        and not same_bits(torch, h, first):
                    raise AssertionError(f"B1-K at rows_per_block={r} "
                                         "differs from the automatic shape")
            first = h if first is None else first
            rows = shapes[form](r)[0]
            report[form][str(r)] = {
                "rows_per_block": rows, "row_blocks": -(-n // rows),
                "max_abs_err": e,
                "bits_equal_to_automatic": bool(torch.equal(h, first)),
                "ms": median_ms(torch, lambda: call(r))}
    # the shadow grower at an explicit row block: a strict and a K = 16
    # tree bit for bit as the primary's
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    params = sp.SplitParams()
    rpb = RPB_VALUES[0]
    shadow_equal = {}
    for name, L, k, grow in (("strict", NUM_LEAVES, 1, gr.grow_tree),
                             ("wide", WIDE_LEAVES, WIDE_K,
                              gr.grow_tree_batched)):
        kw = dict(num_leaves=L, num_bins=B, params=params)
        if k > 1:
            kw["split_batch"] = k
        ws = gr.GrowWorkspace(n, f, B, L, dev, split_batch=k,
                              rows_per_block=rpb)
        shadow = gr.make_shadow_grower(ws)
        if shadow.ws.rows_per_block != rpb or not shadow.independent:
            raise AssertionError("the shadow workspace lost the row block")
        grow(binned, vals, fmask, num_bin, na_bin, workspace=ws, **kw)
        sh_tree = shadow.grow(grow, binned, vals, fmask, num_bin, na_bin,
                              **kw)
        torch.cuda.synchronize()
        if not torch.equal(sh_tree, ws.tree) or not torch.equal(
                shadow.ws.leaf_of_row, ws.leaf_of_row):
            raise AssertionError(f"the shadow {name} tree at rows_per_block"
                                 f"={rpb} differs from the primary's")
        shadow_equal[name] = gr.fetch_tree(ws).num_leaves
    emit({"phase": "rows_per_block", "values": list(RPB_VALUES),
          "forms": report, "shadow_trees_bit_equal_leaves": shadow_equal})
    return report


def phase_wide_k_train(torch, lgt, lgt_kernels, train, valid, name, params,
                       per_it, K):
    """``params`` at ``split_batch=K`` on the per-iteration loop for
    WIDE_K_ROUNDS rounds (``fused_eval=true``): launches held to ``per_it``
    an iteration, the trees at 255 leaves with K-wide super-steps, the
    valid AUC; a rerun byte-identical.  Returns {name: launches}."""
    extra = {**params, "split_batch": K, "superepoch": -1,
             "fused_chunk": 1, "fused_eval": "true"}
    lgt_kernels.reset_launch_counts()
    bst, ev, secs = train_main(lgt, train, valid, extra=extra,
                               rounds=WIDE_K_ROUNDS)
    torch.cuda.synchronize()
    counts = lgt_kernels.launch_counts()
    m = bst._model
    iters = m.num_iterations_trained
    if m.split_batch != K or iters != WIDE_K_ROUNDS \
            or counts != times(per_it, iters):
        raise AssertionError(f"{name}: split_batch {m.split_batch}, "
                             f"{iters} iterations, launches {counts}")
    if max(t.num_leaves for t in m.models) != WIDE_LEAVES:
        raise AssertionError(f"{name}: the trees never reach "
                             f"{WIDE_LEAVES} leaves")
    auc = ev["valid_0"]["auc"]
    if not 0.5 < auc[-1] <= 1.0 or auc[-1] < auc[0]:
        raise AssertionError(f"{name}: valid AUC {auc}")
    b2, _, _ = train_main(lgt, train, valid, extra=extra,
                          rounds=WIDE_K_ROUNDS)
    if b2.model_to_string() != bst.model_to_string():
        raise AssertionError(f"a second {name} run gave other model text")
    emit({"phase": name, "params": extra, "iterations": iters,
          "seconds": secs, "ms_per_iteration": 1e3 * secs / iters,
          "valid_auc": auc, "live_steps_per_tree": statistics.mean(
              m.step_counts),
          "leaves_per_tree": statistics.mean(t.num_leaves for t in m.models),
          "rerun_byte_identical": True, "launches": counts})
    return {name: counts}


def phase_hist_tune_train(torch, lgt, lgt_kernels, train, valid, wide_ms):
    """``hist_tune=on`` at the wide configuration (HIST_TUNE_PARAMS, 255
    leaves, 1M x 28, 63 bins) as super-epochs for CUT_ROUNDS rounds on a
    cold table: one sweep of the shipped B1-K over K in {8, 16, 32, 64} x
    three row blocks (the record, every candidate, the sweep's seconds and
    ``tune_counts()`` printed); the model bytes equal to the untuned run at
    the record's ``split_batch`` and ``rows_per_block``, whose launches
    are the tuned run's less the sweep's passes; a second ``ensure`` with
    the process memo cleared resolves from disk with no sweep; ms an
    iteration tuned against the untuned run and against wide_train's
    (K = 16, ``wide_ms``).  Returns ({hist_tune_train: launches}, the
    B15 line)."""
    import shutil

    from lightgbm_torch.ops import hist_tune
    tune_dir = Path(lgt_kernels.BUILD_DIR) / "hist_tune_smoke"
    shutil.rmtree(tune_dir, ignore_errors=True)
    with hist_tune._LOCK:
        hist_tune._MEM.clear()
    real_tune, spent = hist_tune.tune, []

    def timed_tune(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real_tune(*a, **kw)
        finally:
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t0)

    params = {**HIST_TUNE_PARAMS, "compile_cache_dir": str(tune_dir)}
    c0 = hist_tune.tune_counts()
    hist_tune.tune = timed_tune
    try:
        lgt_kernels.reset_launch_counts()
        bst, ev, secs = train_main(lgt, train, valid, extra=params,
                                   rounds=CUT_ROUNDS)
        torch.cuda.synchronize()
        counts = lgt_kernels.launch_counts()
    finally:
        hist_tune.tune = real_tune
    c1 = hist_tune.tune_counts()
    m = bst._model
    rec = m.hist_tuned
    sweep = hist_tune.last_sweep()
    if rec is None or c1["sweeps"] != c0["sweeps"] + 1 or len(spent) != 1:
        raise AssertionError(f"hist_tune_train: no cold sweep ({c0} -> "
                             f"{c1}, record {rec})")
    if sorted({c["k"] for c in sweep}) != [8, 16, 32, 64] \
            or any(sum(c["k"] == k for c in sweep) != 3
                   for k in (8, 16, 32, 64)):
        raise AssertionError(f"hist_tune_train: the sweep covered "
                             f"{[(c['k'], c['block_rows']) for c in sweep]}")
    if m.split_batch != rec["k"] or m.rows_per_block != rec["block_rows"] \
            or not (tune_dir / hist_tune.TUNE_FILE).exists():
        raise AssertionError(f"hist_tune_train: trained at K = "
                             f"{m.split_batch}, rows {m.rows_per_block}, "
                             f"record {rec}")
    sweep_passes = len(sweep) * (1 + rec["reps"])
    epochs = len(m.epoch_ms)
    k = max(2, min(25, ES_ROUNDS))
    tuned_ms = statistics.median(m.epoch_ms[1:] if epochs > 1
                                 else m.epoch_ms) / k
    # the untuned twin at the record's K and row block: the same bytes,
    # and the same launches less the sweep's
    twin_params = {**WIDE_PARAMS, "split_batch": rec["k"],
                   "rows_per_block": rec["block_rows"]}
    lgt_kernels.reset_launch_counts()
    twin, ev_t, secs_t = train_main(lgt, train, valid, extra=twin_params,
                                    rounds=CUT_ROUNDS)
    torch.cuda.synchronize()
    twin_counts = lgt_kernels.launch_counts()
    tm = twin._model
    twin_ms = statistics.median(tm.epoch_ms[1:] if len(tm.epoch_ms) > 1
                                else tm.epoch_ms) / k
    if bst.model_to_string().split("parameters:")[0] != \
            twin.model_to_string().split("parameters:")[0]:
        raise AssertionError("hist_tune_train: the tuned model differs from "
                             "the untuned run at the record's shapes")
    less = dict(counts)
    less["histogram_slots"] -= sweep_passes
    if less != twin_counts:
        raise AssertionError(f"hist_tune_train launches {counts}, less the "
                             f"sweep's {sweep_passes} passes, differ from "
                             f"the twin's {twin_counts}")
    # a second lookup, the process memo cleared: from disk, no sweep
    with hist_tune._LOCK:
        hist_tune._MEM.clear()
    lgt_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    again = hist_tune.ensure(m.num_data, int(m.binned_dev.shape[1]),
                             m.max_bin, itemsize=4, kmax=rec["kmax"],
                             config=m.config, device=m.device)
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm_launches = sum(lgt_kernels.launch_counts().values())
    if again != rec or hist_tune.tune_counts()["sweeps"] != c1["sweeps"] \
            or warm_launches:
        raise AssertionError(f"hist_tune_train: the warm lookup gave "
                             f"{again} (record {rec}) with "
                             f"{warm_launches} launches")
    line = {"phase": "hist_tune_train", "params": HIST_TUNE_PARAMS,
            "record": rec, "candidates": sweep,
            "sweep_seconds": spent[0], "sweep_passes": sweep_passes,
            "tune_counts": hist_tune.tune_counts(),
            "warm_ensure_ms": warm_ms, "warm_ensure_launches": warm_launches,
            "table": str(tune_dir / hist_tune.TUNE_FILE),
            "iterations": m.num_iterations_trained, "seconds": secs,
            "valid_auc": ev["valid_0"]["auc"][bst.best_iteration - 1],
            "ms_per_iteration_tuned": tuned_ms,
            "ms_per_iteration_untuned_twin": twin_ms,
            "ms_per_iteration_wide_k16": wide_ms,
            "twin_seconds": secs_t, "model_equal_to_twin": True,
            "launches": counts}
    emit(line)
    return {"hist_tune_train": counts, "hist_tune_twin": twin_counts}, line


def _dist_records(torch, S, C, fmax, B, seed, dev):
    """S ranks' best-split records of C children on the card: gains with
    cross-rank ties and an all -inf child, local slots, categorical flags
    and rank rows (B16a's inputs)."""
    from lightgbm_torch.ops import split as sp
    rs = np.random.RandomState(seed)
    rec = rs.uniform(-5, 5, (S, C, sp.RECORD)).astype(np.float32)
    rec[..., sp.GAIN] = rs.uniform(0.5, 2.0, (S, C))
    rec[:, 0, sp.GAIN] = 1.75
    rec[1::2, min(1, C - 1), sp.GAIN] = 3.0
    rec[:, C - 1, sp.GAIN] = -np.inf
    rec[..., sp.FEATURE] = rs.randint(0, fmax, (S, C))
    cat = (rs.rand(S, C) < 0.3).astype(np.int32)
    rank = np.stack([[rs.permutation(B) for _ in range(C)]
                     for _ in range(S)]).astype(np.int32)
    return tuple(torch.as_tensor(a).to(dev) for a in (rec, cat, rank))


def phase_dist_kernels(torch, lgt, train):
    """B16a, B16b and B16c against their plain versions on the card at the
    HIGGS shape (module docstring), each timed beside its bound and
    library call.  Returns the kernels-line rows."""
    from lightgbm_torch.ops import split as sp
    from lightgbm_torch.ops import vote as vt
    from lightgbm_torch.ops.histogram import compute_histogram
    from lightgbm_torch.ops.quantize import (QuantSpec, quant_scales,
                                             quantize_stack)
    from lightgbm_torch.parallel.mesh import owner_shard_plan
    dev = torch.device("cuda", 0)
    F, B = N_FEAT, int(train.max_bin)
    out, cases = {}, []
    # B16a: every S, 2 and 2K children, categorical and numerical records,
    # the owner plan (S = 8: the last rank owns only pad slots) and the
    # offset form
    row16a = None
    for S in DIST_SHAPES:
        plan = owner_shard_plan(np.arange(F), S)
        sf = torch.as_tensor(plan.shard_feat).to(dev)
        for C in (2, 2 * WIDE_K):
            rec, cat, rank = _dist_records(torch, S, C, plan.fmax, B,
                                           S * 100 + C, dev)
            for form in ("owner", "offset"):
                kw = {"shard_feat": sf} if form == "owner" \
                    else {"f_local": -(-F // S)}
                for with_cat in (True, False):
                    args = (rec, cat, rank) if with_cat else (rec,)
                    k = sp.gather_best(*args, **kw)
                    p = sp.gather_best_plain(*args, **kw)
                    k, p = (k, p) if with_cat else ((k,), (p,))
                    if not all(torch.equal(a, b) for a, b in zip(k, p)):
                        raise AssertionError(
                            f"B16a differs from its plain version (S {S}, "
                            f"C {C}, {form}, categorical {with_cat})")
                    cases.append([S, C, form, with_cat])
            if S == DIST_RANKS and C == 2:
                args = (rec, cat, rank)
                t_k = median_ms(torch, lambda: sp.gather_best(
                    *args, shard_feat=sf))
                t_p = median_ms(torch, lambda: sp.gather_best_plain(
                    *args, shard_feat=sf))
                nbytes = 4 * (S * C * (sp.RECORD + 1 + B) + sf.numel()
                              + C * (sp.RECORD + 1 + B))
                row16a = _kernel_row(
                    "gather_best", "B16a best-split select",
                    "lightgbm_torch/csrc/dist.cu",
                    "lightgbm_tpu/ops/split.py:105", 0.0, 0.0, t_k, t_p,
                    bound_ms(nbytes, 0), None, S=S, children=C,
                    cases=len(cases) + 1)
    out["gather_best"] = row16a
    # B16b and B16c on a rank's histograms of the HIGGS rows (the first
    # half: one of DIST_RANKS ranks), f32 and the int8 pass's int32
    half = N_TRAIN // DIST_RANKS
    binned = torch.as_tensor(train.binned[:half]).to(dev)
    y = torch.as_tensor(train.metadata.label[:half]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    prob = torch.sigmoid(torch.randn(half, device=dev, generator=gen))
    vals = torch.stack([prob - y, prob * (1 - prob), torch.ones_like(y)],
                       dim=1)
    h32 = compute_histogram(binned, vals, num_bins=B)
    spec = QuantSpec(bits=8, stochastic=True, seed=0)
    scales = quant_scales(vals, spec.qmax)
    hint = compute_histogram(binned, quantize_stack(vals, scales, spec),
                             num_bins=B)
    params = sp.SplitParams(lambda_l1=0.5, lambda_l2=1.0)
    err16b = 0.0
    for h, sc in ((h32, None), (hint, scales)):
        vk, gk = vt.vote_gains(h, params, DIST_RANKS, DIST_TOP_K, sc)
        vp, gp = vt.vote_gains_plain(h, params, DIST_RANKS, DIST_TOP_K, sc)
        e = float((gk - gp).abs().max())
        if not torch.equal(vk, vp) or e > VOTE_RTOL * max(
                1.0, float(gp.abs().max())):
            raise AssertionError(f"B16b differs from its plain version "
                                 f"(votes equal {torch.equal(vk, vp)}, "
                                 f"gain err {e})")
        err16b = max(err16b, e)
    t_k = median_ms(torch, lambda: vt.vote_gains(h32, params, DIST_RANKS,
                                                 DIST_TOP_K))
    t_p = median_ms(torch, lambda: vt.vote_gains_plain(
        h32, params, DIST_RANKS, DIST_TOP_K), reps=10, warmup=2)
    ops = F * B * 16.0
    out["vote_gains"] = _kernel_row(
        "vote_gains", "B16b local vote", "lightgbm_torch/csrc/vote.cu",
        "lightgbm_tpu/parallel/voting_parallel.py:55", err16b, 0.0, t_k,
        t_p, bound_ms(4 * (F * B * 3 + 2 * F), ops), None,
        features=F, bins=B, top_k=DIST_TOP_K)
    # B16c on the all-reduced pair of two ranks' votes and gains
    k2 = 2 * DIST_TOP_K
    votes = vk * 2
    gsum = gk * 2
    for h in (h32, hint):
        a = vt.vote_select(votes, gsum, h.clone(), k2)
        b = vt.vote_select_plain(votes, gsum, h.clone(), k2)
        if not torch.equal(a, b):
            raise AssertionError("B16c differs from its plain version")
    hk = h32.clone()
    t_k = median_ms(torch, lambda: vt.vote_select(votes, gsum, hk, k2))
    hp = h32.clone()
    t_p = median_ms(torch, lambda: vt.vote_select_plain(votes, gsum, hp,
                                                        k2))
    score = vt.vote_score(votes, gsum)
    t_lib = median_ms(torch, lambda: torch.topk(score, k2))
    out["vote_select"] = _kernel_row(
        "vote_select", "B16c global vote mask", "lightgbm_torch/csrc/vote.cu",
        "lightgbm_tpu/parallel/voting_parallel.py:137", 0.0, 0.0, t_k, t_p,
        bound_ms(4 * (2 * F + (F - k2) * B * 3), 0), t_lib,
        features=F, bins=B, k2=k2)
    # the owner-shard learner's rank-major layout of a K-slot pass: one
    # strided copy of each rank's feature chunk (OwnerShardHooks.reduce)
    copy_ms = {}
    for K in (WIDE_K, 64):
        hk = torch.randn((K, F, B, 3), device=dev)
        chunk = -(-F // DIST_RANKS)
        major = torch.zeros((DIST_RANKS, K, chunk, B, 3), device=dev)

        def lay():
            for r in range(DIST_RANKS):
                f0, f1 = r * chunk, min(F, (r + 1) * chunk)
                major[r, :, :f1 - f0].copy_(hk[:, f0:f1])
        copy_ms[K] = median_ms(torch, lay)
    emit({"phase": "dist_kernels", "b16a_cases": cases,
          "b16b_max_abs_err": err16b, "rank_major_copy_ms": copy_ms,
          "rows": {k: {kk: v[kk] for kk in ("ms", "plain_ms", "bound_ms",
                                            "library_ms")}
                   for k, v in out.items()}})
    return out


def phase_dist_nccl1(torch):
    """A one-rank NCCL process group: every communicator operation on card
    tensors (f32 and int32), each result held to its input (one rank),
    with its milliseconds; nothing staged."""
    import socket
    import torch.distributed as dist
    from lightgbm_torch.obs.comm import CommLedger
    from lightgbm_torch.parallel.mesh import ProcessMesh
    dev = torch.device("cuda", 0)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = ProcessMesh(None, "data", dev)
        mesh.timed = True
        led = CommLedger(1)
        gen = torch.Generator(device=dev).manual_seed(3)
        for dt in (torch.float32, torch.int32):
            t = (torch.randn((N_FEAT, MAX_BIN, 3), device=dev,
                             generator=gen) * 100).to(dt)
            name = str(dt).split(".")[-1]
            checks = {
                "reduce_scatter": mesh.reduce_scatter(
                    t, ledger=led, site=f"reduce_scatter_{name}"),
                "all_gather": mesh.all_gather(
                    t, ledger=led, site=f"all_gather_{name}")[0],
                "all_reduce_sum": mesh.all_reduce(
                    t.clone(), "sum", ledger=led,
                    site=f"all_reduce_sum_{name}"),
                "all_reduce_max": mesh.all_reduce(
                    t.clone(), "max", ledger=led,
                    site=f"all_reduce_max_{name}")}
            torch.cuda.synchronize()
            for op, r in checks.items():
                if not torch.equal(r, t):
                    raise AssertionError(f"one-rank NCCL {op} ({name}) "
                                         "changed its tensor")
        if mesh.backend != "nccl" or mesh.staged:
            raise AssertionError(f"backend {mesh.backend}, staged "
                                 f"{mesh.staged}")
        emit({"phase": "dist_nccl1", "backend": mesh.backend,
              "calls": led.calls, "bytes": led.bytes, "ms": led.ms,
              "staged": mesh.staged})
    finally:
        dist.destroy_process_group()


def dist_per_iteration(name: str, params: dict) -> dict:
    """B16a-c launches of one iteration of a DIST_CELLS cell: the grower's
    fixed step sequence (the root pass and L - 1 steps or super-steps,
    dead ones included); voting builds both children, so B16b and B16c
    run on the root and twice a step."""
    L = params.get("num_leaves", NUM_LEAVES)
    learner = params["tree_learner"]
    owner = params.get("dp_owner_shard", True)
    return {"gather_best": L if learner == "feature"
            or (learner == "data" and owner) else 0,
            "vote_gains": 1 + 2 * (L - 1) if learner == "voting" else 0,
            "vote_select": 1 + 2 * (L - 1) if learner == "voting" else 0}


def dist_worker(ctx, args):
    """One rank of dist_train (spawned by ``distributed.run``): every
    DIST_CELLS cell on this rank's half of the HIGGS rows (every row
    under feature-parallel) with the full valid set, the collectives
    timed; returns each cell's model text, valid AUCs, ms an iteration,
    B16a-c launches, ledger and staged operations."""
    import torch
    import lightgbm_torch as lgt
    from lightgbm_torch import _kernels

    x, y = make_higgs_like(N_TRAIN, N_FEAT, seed=0)
    xv, yv = make_higgs_like(N_VALID, N_FEAT, seed=1)
    idx = np.array_split(np.arange(N_TRAIN), ctx.num_workers)[ctx.rank]
    out = {}
    for name, extra, rounds in DIST_CELLS:
        p = {**args["base"], **extra}
        rows = slice(None) if extra["tree_learner"] == "feature" else idx
        ds = lgt.Dataset(x[rows], label=y[rows], params=p,
                         bin_mappers=args["mappers"])
        vs = lgt.Dataset(xv, label=yv, params=p, reference=ds)
        ev, stamps = {}, []

        def timed(env):
            env.model._model.mesh.timed = True
        timed.before_iteration = True

        def stamp(env):
            stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        bst = lgt.train(p, ds, rounds, valid_sets=[vs],
                        callbacks=[timed, stamp, lgt.record_evaluation(ev)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _kernels.launch_counts()
        m = bst._model
        led = m.dist_grower.comm
        gaps = np.diff([t0] + stamps) * 1e3
        out[name] = {
            "text": bst.model_to_string(), "auc": ev["valid_0"]["auc"],
            "iterations": m.num_iterations_trained, "seconds": secs,
            "ms_per_iteration": float(np.median(gaps[1:])),
            "first_iteration_ms": float(gaps[0]),
            "launches": {k: launches[k] for k in DIST_KERNELS},
            "all_launches": {k: v for k, v in launches.items() if v},
            "sites": {s.site: {"collective": s.collective,
                               "payload_bytes": s.payload_bytes,
                               "calls": led.calls[s.site],
                               "bytes": led.bytes[s.site],
                               "ms": led.ms.get(s.site, 0.0)}
                      for s in led.sites()},
            "staged": dict(m.mesh.staged), "backend": m.mesh.backend}
    return out


def phase_dist_train(torch, lgt, lgt_kernels, train, valid):
    """dist_train (module docstring).  Returns the launches of the owner
    and voting cells (rank 0), for the kernels line."""
    from lightgbm_torch import distributed
    base = {"objective": "binary", "num_leaves": NUM_LEAVES,
            "max_bin": MAX_BIN, "learning_rate": 0.1, "metric": "auc",
            "verbosity": -1}
    t0 = time.perf_counter()
    res = distributed.run("chip_smoke:dist_worker", DIST_RANKS,
                          backend="gloo",
                          args={"base": base, "mappers": train.bin_mappers},
                          timeout=900)
    spawn_s = time.perf_counter() - t0
    # the serial per-iteration twins of the owner and quant cells
    serial = {}
    for name in ("owner", "quant"):
        _, extra, rounds = next(c for c in DIST_CELLS if c[0] == name)
        extra = {k: v for k, v in extra.items() if k != "tree_learner"}
        ev = {}
        bst = lgt.train({**base, **extra, "superepoch": -1,
                         "fused_chunk": 1}, train, rounds,
                        valid_sets=[valid],
                        callbacks=[lgt.record_evaluation(ev)])
        serial[name] = (bst.model_to_string(), ev["valid_0"]["auc"])
    cells = {}
    for name, extra, rounds in DIST_CELLS:
        r0 = res[0][name]
        if any(r[name]["text"] != r0["text"] for r in res):
            raise AssertionError(f"dist_train {name}: the ranks' model "
                                 "texts differ")
        n = r0["iterations"]
        want = times(dist_per_iteration(name, {**base, **extra}), n)
        for r in res:
            if r[name]["launches"] != want:
                raise AssertionError(
                    f"dist_train {name}: B16 launches "
                    f"{r[name]['launches']} for {n} iterations, expected "
                    f"{want}")
        cells[name] = {
            "iterations": n,
            "ms_per_iteration_by_rank": [r[name]["ms_per_iteration"]
                                         for r in res],
            "first_iteration_ms_by_rank": [r[name]["first_iteration_ms"]
                                           for r in res],
            "valid_auc": r0["auc"][-1], "b16_launches": r0["launches"],
            "sites_rank0": r0["sites"], "staged_rank0": r0["staged"],
            "backend": r0["backend"]}
    # the owner run's first tree: the serial run's integer arrays
    st, sauc = serial["owner"]
    dt = res[0]["owner"]["text"]
    ints = ("split_feature=", "threshold=", "decision_type=",
            "left_child=", "right_child=", "leaf_count=", "internal_count=")

    def first_tree(text):
        tree = text.split("Tree=")[1]
        return [ln for ln in tree.splitlines() if ln.startswith(ints)]
    if first_tree(dt) != first_tree(st):
        raise AssertionError("dist_train owner: the first tree's integer "
                             "arrays differ from the serial run's")
    auc_gap = abs(res[0]["owner"]["auc"][-1] - sauc[-1])
    if auc_gap > DIST_AUC_ATOL:
        raise AssertionError(f"dist_train owner: valid AUC "
                             f"{res[0]['owner']['auc'][-1]} against the "
                             f"serial {sauc[-1]}")
    qd = without_path_params(res[0]["quant"]["text"], "[tree_learner:")
    qs = without_path_params(serial["quant"][0], "[tree_learner:")
    if qd != qs:
        raise AssertionError("dist_train quant: the model text differs "
                             "from the serial quant run's")
    emit({"phase": "dist_train", "ranks": DIST_RANKS,
          "rows_by_rank": [int(len(a)) for a in np.array_split(
              np.arange(N_TRAIN), DIST_RANKS)],
          "seconds": spawn_s, "cells": cells,
          "owner_first_tree_equal_serial": True,
          "owner_auc_gap": auc_gap, "quant_text_equal_serial": True,
          "serial_owner_auc": sauc[-1]})
    return ({"dist_owner_train": res[0]["owner"]["all_launches"],
             "dist_voting_train": res[0]["voting"]["all_launches"]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import lightgbm_torch as lgt
    from lightgbm_torch import _kernels as lgt_kernels

    smi = phase_environment(torch, lgt_kernels)
    x, y, xv, yv, train, valid = phase_data(lgt)
    kernels = phase_kernels(torch, lgt, train, valid)
    wide_kernels, dead_ms = phase_wide_kernels(torch, lgt, train)
    kernels.update(wide_kernels)
    kernels.update(phase_wide_k_kernels(torch, lgt, train))
    phase_rows_per_block(torch, lgt, lgt_kernels, train)
    kernels.update(phase_sample_kernels(torch, lgt, train))
    kernels.update(phase_constraint_kernels(torch, lgt, train))
    kernels.update(phase_partitioned_kernels(torch, lgt, train))
    cat_xv, cat_train, cat_valid = phase_cat_data(lgt)
    kernels.update(phase_cat_kernels(torch, lgt, cat_train, cat_valid))
    mc_xv, mc_train, mc_valid = phase_mc_data(lgt)
    kernels.update(phase_mc_kernels(torch, lgt, mc_valid, mc_xv))
    efb_sets = phase_efb_data(lgt)
    kernels.update(phase_efb_kernels(torch, lgt, *efb_sets[1:3]))
    kernels.update(phase_quant_kernels(torch, lgt, lgt_kernels, train,
                                       efb_sets[3]))
    kernels.update(phase_fleet_kernels(torch, lgt, train, valid))
    integrity_rows, oracle_counts = phase_integrity_kernels(
        torch, lgt, lgt_kernels, train)
    kernels.update(integrity_rows)
    kernels.update(phase_dist_kernels(torch, lgt, train))
    bst, ev, counts, epoch_ms_per_it = phase_main_path(
        torch, lgt, lgt_kernels, train, valid)
    eager_ms_per_it, per_it_counts = phase_per_iteration(
        torch, lgt, lgt_kernels, train, valid, bst, ev)
    # B14, the captured iteration: its steady time per iteration against
    # the same body run eagerly (its plain version) and against the bound
    # of the work the main path's own trees needed
    b14_ms, b14_by, b14_bytes = iteration_bound(
        bst._model.models, N_TRAIN, N_FEAT, int(train.max_bin), NUM_LEAVES,
        N_VALID)
    emit({"phase": "fused_loop", "ms_per_iteration": epoch_ms_per_it,
          "plain_ms_per_iteration": eager_ms_per_it,
          "bound_ms_per_iteration": b14_ms, "bound_by": b14_by,
          "bound_bytes_per_iteration": b14_bytes, "library_ms": None})
    chunk_counts = phase_fused_chunk(torch, lgt, lgt_kernels, train)
    phase_reference(torch, lgt)
    phase_roundtrip(lgt, bst, train, valid, xv)
    phase_profile(torch, lgt, train, valid)
    wide_counts, wide_ms, wide_eager_ms, (wb_ms, wb_by, wb_bytes) = \
        phase_sampled_train(torch, lgt, lgt_kernels, train, valid, xv,
                            "wide", WIDE_PARAMS, WIDE_PER_ITERATION, dead_ms,
                            rounds=CUT_ROUNDS)
    emit({"phase": "wide_loop", "ms_per_iteration": wide_ms,
          "plain_ms_per_iteration": wide_eager_ms,
          "bound_ms_per_iteration": wb_ms, "bound_by": wb_by,
          "bound_bytes_per_iteration": wb_bytes, "library_ms": None})
    # the histogram autotuner (B15) at the wide configuration, against
    # the untuned run at its record and wide_train's K = 16
    sampled_counts = dict(phase_hist_tune_train(
        torch, lgt, lgt_kernels, train, valid, wide_ms)[0])
    for prefix, params, per_it, rounds in (
            ("goss", GOSS_PARAMS, GOSS_PER_ITERATION, CUT_ROUNDS),
            ("extra", EXTRA_PARAMS, EXTRA_PER_ITERATION, CUT_ROUNDS)):
        sampled_counts.update(phase_sampled_train(
            torch, lgt, lgt_kernels, train, valid, xv, prefix, params,
            per_it, rounds=rounds)[0])
    # the split controls: the strict and the wide shape, launches held to
    # those of the same runs without the controls
    plain_steady = {"main_path": 1e3 / epoch_ms_per_it,
                    "wide_train": 1e3 / wide_ms}
    for prefix, params, per_it, rounds, twin in (
            ("constraint", {"num_leaves": NUM_LEAVES, **CONS_PARAMS},
             PER_ITERATION, CUT_ROUNDS, None),
            ("constraint_wide", CONS_WIDE_PARAMS, CONS_WIDE_PER_ITERATION,
             CUT_ROUNDS, CONS_WIDE_BASE)):
        sampled_counts.update(phase_sampled_train(
            torch, lgt, lgt_kernels, train, valid, xv, prefix, params,
            per_it, rounds=rounds, after=constraint_after(
                torch, lgt, lgt_kernels, train, valid, xv, params, per_it,
                rounds, plain_steady, twin))[0])
    # the partitioned learner's six runs, on the per-iteration loop
    sampled_counts.update(phase_partitioned_train(
        torch, lgt, lgt_kernels, train, valid, x, xv, bst, ev,
        epoch_ms_per_it, eager_ms_per_it))
    # quantized training: the main configuration (its AUC held to the f32
    # main path's) and the wide one
    for prefix, params, per_it, rounds in (
            ("quant", QUANT_PARAMS, QUANT_PER_ITERATION, ROUNDS),
            ("quant_wide", QUANT_WIDE_PARAMS, QUANT_WIDE_PER_ITERATION,
             CUT_ROUNDS)):
        sampled_counts.update(phase_sampled_train(
            torch, lgt, lgt_kernels, train, valid, xv, prefix, params,
            per_it, rounds=rounds,
            ref_auc=ev["valid_0"]["auc"] if prefix == "quant" else None)[0])
    # B1-K-int at the wide widths on a train path
    for K in WIDE_KS:
        sampled_counts.update(phase_wide_k_train(
            torch, lgt, lgt_kernels, train, valid, f"quant_wide_k{K}_train",
            QUANT_WIDE_PARAMS, QUANT_WIDE_PER_ITERATION, K))
    # the fleet: every member held to its solo run on the card
    for name, extra, rounds in FLEET_CELLS:
        sampled_counts.update(phase_fleet_train(
            torch, lgt, lgt_kernels, train, valid, name, extra, rounds))
    # the integrity layer: checked training against unchecked, injected
    # transients and sticky failures
    sampled_counts.update(phase_integrity_train(torch, lgt, lgt_kernels,
                                                train, valid))
    # distributed training: the NCCL route on one rank, then two ranks
    # sharing the card over gloo
    phase_dist_nccl1(torch)
    sampled_counts.update(phase_dist_train(torch, lgt, lgt_kernels, train,
                                           valid))
    sampled_counts["totals_oracle"] = oracle_counts
    for prefix, params, per_it in (
            ("cat", CAT_PARAMS, CAT_PER_ITERATION),
            ("cat_strict", CAT_STRICT_PARAMS, CAT_STRICT_PER_ITERATION)):
        sampled_counts.update(phase_sampled_train(
            torch, lgt, lgt_kernels, cat_train, cat_valid, cat_xv, prefix,
            params, per_it, rounds=CUT_ROUNDS,
            after=cat_after(torch, lgt, lgt_kernels, cat_xv, prefix))[0])
    sampled_counts.update(phase_sampled_train(
        torch, lgt, lgt_kernels, cat_train, cat_valid, cat_xv, "cat_cons",
        CAT_CONS_PARAMS, CAT_STRICT_PER_ITERATION, rounds=CUT_ROUNDS,
        after=cat_cons_after(torch, lgt, lgt_kernels, cat_train,
                             cat_xv))[0])
    # the wide widths on a train path: B1-K, B3-K, B3s-K, B2 on 2K
    # children, B2-cat and B6-node at K = 32 and 64
    for K in WIDE_KS:
        sampled_counts.update(phase_wide_k_train(
            torch, lgt, lgt_kernels, cat_train, cat_valid, f"cat_k{K}_train",
            {**CAT_PARAMS, "feature_fraction_bynode": 0.8},
            {**CAT_PER_ITERATION, "node_draws": WIDE_LEAVES}, K))
    sampled_counts.update(phase_efb_train(
        torch, lgt, lgt_kernels, efb_sets[1], efb_sets[2], efb_sets[0],
        *efb_sets[3:]))
    sampled_counts.update(phase_quant_efb(torch, lgt, lgt_kernels,
                                          *efb_sets[1:3]))
    del efb_sets
    sparse_sets = phase_sparse_data(lgt)
    kernels.update(phase_sparse_kernels(torch, lgt, lgt_kernels,
                                        *sparse_sets[:2]))
    sampled_counts.update(phase_sparse_train(
        torch, lgt, lgt_kernels, sparse_sets[0], sparse_sets[1],
        sparse_sets[3], sparse_sets[4]))
    del sparse_sets
    rank_train, rank_valid = phase_rank_data(lgt)
    kernels.update(phase_rank_kernels(torch, lgt, rank_train))
    rank_counts, rank_ndcg10 = phase_rank_train(torch, lgt, lgt_kernels,
                                                rank_train, rank_valid)
    sampled_counts.update(rank_counts)
    sampled_counts.update(phase_quant_rank(torch, lgt, lgt_kernels,
                                           rank_train, rank_valid,
                                           rank_ndcg10))
    del rank_train, rank_valid
    mc_bst, mc_counts = phase_mc_train(
        torch, lgt, lgt_kernels, mc_train, mc_valid, "multiclass_train",
        None, MC_ROUNDS, MC_PER_TREE, profile_rounds=MC_PROFILE_ROUNDS)
    for name, extra, rounds, per_tree, full in (
            ("multiclassova_train", {"objective": "multiclassova"},
             MC_OVA_ROUNDS, MC_PER_TREE, True),
            ("multiclass_wide", MC_WIDE_PARAMS, MC_WIDE_ROUNDS,
             MC_WIDE_PER_TREE, False)):
        mc_counts.update(phase_mc_train(
            torch, lgt, lgt_kernels, mc_train, mc_valid, name, extra,
            rounds, per_tree, fused_eval=full, rerun=full)[1])
    mc_counts.update(phase_mc_serve(torch, lgt, lgt_kernels, mc_bst,
                                    mc_xv[:MC_SERVE_ROWS]))
    mc_counts.update(phase_objectives_train(torch, lgt, lgt_kernels, train,
                                            x, y, xv))
    serve_bst = phase_serving_model(torch, lgt, lgt_kernels, train)
    kernels.update(phase_serve_kernels(torch, lgt, serve_bst, xv))
    by_path = {"main_path": counts, "per_iteration": per_it_counts,
               "fused_chunk": chunk_counts, **wide_counts,
               **sampled_counts, **mc_counts,
               "predict": phase_predict(torch, lgt, lgt_kernels, bst,
                                        serve_bst, xv),
               "fused_serve": phase_fused_serve(torch, lgt, lgt_kernels,
                                                serve_bst, xv),
               "serve_host": phase_serve(torch, lgt, lgt_kernels, serve_bst,
                                         xv, device_binning=False),
               "serve_fused": phase_serve(torch, lgt, lgt_kernels,
                                          serve_bst, xv,
                                          device_binning=True)}
    counter = {k: KERNEL_COUNTER.get(k, k) for k in KERNEL_ORDER}
    emit({"kernels": [{**kernels[k],
                       "launches": by_path[KERNEL_PATH.get(
                           k, "main_path")].get(counter[k], 0),
                       "launches_by_path": {p: c.get(counter[k], 0)
                                            for p, c in by_path.items()}}
                      for k in KERNEL_ORDER]})
    for k in ("goss_vals", "node_draws", "split_per_child", "split_cat",
              "predict_column", "multi_logloss", "expand_group_hist",
              "lambdarank", "xendcg", "quant_scales", "quantize_stack",
              "dequant_hist", "histogram_int", "histogram_slots_int",
              "histogram_sparse", "histogram_slots_sparse",
              "partition_sparse", "partition_slots_sparse",
              "predict_sparse", "split_cons", "split_cat_cons",
              "grow_step_cons", "grow_step_batched_cons",
              "node_draws_base", "segment_histogram",
              "segment_histogram_int", "partition_segment", "leaf_of_row",
              "split_mono_bounds") + FLEET_KERNELS + INTEGRITY_KERNELS \
            + WIDE_K_KERNELS + DIST_KERNELS:
        if by_path[KERNEL_PATH[k]].get(counter[k], 0) < 1:
            raise AssertionError(f"{k} was not launched on its path")
    emit({"phase": "total", "seconds": time.perf_counter() - _START})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
