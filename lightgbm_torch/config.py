"""Configuration system of the PyTorch/CUDA GBDT port.

A copy of the JAX package's table, so that both packages accept the same
parameters, aliases and defaults.  Only ``device_type`` differs: its
default is ``"cuda"`` and it accepts ``"cuda"`` (alias ``"gpu"``) or
``"cpu"``.  Many parameters below drive modules the port does not have
yet; the trainer (models/gbdt.py) refuses those values with
``NotImplementedError`` rather than ignoring them.

Mirrors the reference's single Config-struct-of-record design
(include/LightGBM/config.h:34-1234, src/io/config.cpp:195
``Config::Set`` pipeline: KV2Map -> alias resolution -> member parse ->
``CheckParamConflict``), rebuilt as a Python dataclass-of-record with the
same parameter names, aliases and defaults.  Docs and alias tables are
derived from the single ``_PARAMS`` table below (the reference generates
them from header comments via helpers/parameter_generator.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

# ---------------------------------------------------------------------------
# Parameter table: name -> (type, default, aliases)
# Names/defaults follow the reference parameter list
# (include/LightGBM/config.h and docs/Parameters.rst).
# ---------------------------------------------------------------------------

_PARAMS: Dict[str, tuple] = {
    # ---- core ----
    "objective": (str, "regression", ["objective_type", "app", "application", "loss"]),
    "boosting": (str, "gbdt", ["boosting_type", "boost"]),
    "data_sample_strategy": (str, "bagging", []),
    "num_iterations": (int, 100, ["num_iteration", "n_iter", "num_tree", "num_trees",
                                  "num_round", "num_rounds", "nrounds", "num_boost_round",
                                  "n_estimators", "max_iter"]),
    "learning_rate": (float, 0.1, ["shrinkage_rate", "eta"]),
    "num_leaves": (int, 31, ["num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes"]),
    "tree_learner": (str, "serial", ["tree", "tree_type", "tree_learner_type"]),
    "num_threads": (int, 0, ["num_thread", "nthread", "nthreads", "n_jobs"]),
    "device_type": (str, "cuda", ["device"]),
    "seed": (int, 0, ["random_seed", "random_state"]),
    # Honored by design: the functional JAX training path is
    # deterministic for a fixed config+data+device regardless of this
    # flag (host RNGs are seeded; XLA reduction order is fixed per
    # compiled program) — unlike the reference, where it forces
    # col/row-wise choice to tame OpenMP ordering (config.h:233).
    # Tested by tests/test_extra_params.py::test_deterministic_by_design.
    "deterministic": (bool, False, []),
    # ---- learning control ----
    "force_col_wise": (bool, False, []),
    "force_row_wise": (bool, False, []),
    "histogram_pool_size": (float, -1.0, ["hist_pool_size"]),
    "max_depth": (int, -1, []),
    "min_data_in_leaf": (int, 20, ["min_data_per_leaf", "min_data", "min_child_samples",
                                   "min_samples_leaf"]),
    "min_sum_hessian_in_leaf": (float, 1e-3, ["min_sum_hessian_per_leaf", "min_sum_hessian",
                                              "min_hessian", "min_child_weight"]),
    "bagging_fraction": (float, 1.0, ["sub_row", "subsample", "bagging"]),
    "pos_bagging_fraction": (float, 1.0, ["pos_sub_row", "pos_subsample", "pos_bagging"]),
    "neg_bagging_fraction": (float, 1.0, ["neg_sub_row", "neg_subsample", "neg_bagging"]),
    "bagging_freq": (int, 0, ["subsample_freq"]),
    "bagging_seed": (int, 3, ["bagging_fraction_seed"]),
    "feature_fraction": (float, 1.0, ["sub_feature", "colsample_bytree"]),
    "feature_fraction_bynode": (float, 1.0, ["sub_feature_bynode", "colsample_bynode"]),
    "feature_fraction_seed": (int, 2, []),
    "extra_trees": (bool, False, ["extra_tree"]),
    "extra_seed": (int, 6, []),
    "early_stopping_round": (int, 0, ["early_stopping_rounds", "early_stopping",
                                      "n_iter_no_change"]),
    "first_metric_only": (bool, False, []),
    "max_delta_step": (float, 0.0, ["max_tree_output", "max_leaf_output"]),
    "lambda_l1": (float, 0.0, ["reg_alpha", "l1_regularization"]),
    "lambda_l2": (float, 0.0, ["reg_lambda", "lambda", "l2_regularization"]),
    "linear_lambda": (float, 0.0, []),
    "min_gain_to_split": (float, 0.0, ["min_split_gain"]),
    "drop_rate": (float, 0.1, ["rate_drop"]),
    "max_drop": (int, 50, []),
    "skip_drop": (float, 0.5, []),
    "xgboost_dart_mode": (bool, False, []),
    "uniform_drop": (bool, False, []),
    "drop_seed": (int, 4, []),
    "top_rate": (float, 0.2, []),
    "other_rate": (float, 0.1, []),
    "min_data_per_group": (int, 100, []),
    "max_cat_threshold": (int, 32, []),
    "cat_l2": (float, 10.0, []),
    "cat_smooth": (float, 10.0, []),
    "max_cat_to_onehot": (int, 4, []),
    "top_k": (int, 20, ["topk"]),
    "monotone_constraints": (list, None, ["mc", "monotone_constraint", "monotonic_cst"]),
    "monotone_constraints_method": (str, "basic", ["monotone_constraining_method", "mc_method"]),
    "monotone_penalty": (float, 0.0, ["monotone_splits_penalty", "ms_penalty", "mc_penalty"]),
    "feature_contri": (list, None, ["feature_contrib", "fc", "fp", "feature_penalty"]),
    "forcedsplits_filename": (str, "", ["fs", "forced_splits_filename", "forced_splits_file",
                                        "forced_splits"]),
    "refit_decay_rate": (float, 0.9, []),
    "cegb_tradeoff": (float, 1.0, []),
    "cegb_penalty_split": (float, 0.0, []),
    "cegb_penalty_feature_lazy": (list, None, []),
    "cegb_penalty_feature_coupled": (list, None, []),
    "path_smooth": (float, 0.0, []),
    "interaction_constraints": (str, "", []),
    "verbosity": (int, 1, ["verbose"]),
    "linear_tree": (bool, False, ["linear_trees"]),
    # ---- dataset ----
    "max_bin": (int, 255, ["max_bins"]),
    "max_bin_by_feature": (list, None, []),
    "min_data_in_bin": (int, 3, []),
    "bin_construct_sample_cnt": (int, 200000, ["subsample_for_bin"]),
    "data_random_seed": (int, 1, ["data_seed"]),
    "is_enable_sparse": (bool, True, ["is_sparse", "enable_sparse", "sparse"]),
    "enable_bundle": (bool, True, ["is_enable_bundle", "bundle"]),
    "max_conflict_rate": (float, 0.0, []),
    "use_missing": (bool, True, []),
    "zero_as_missing": (bool, False, []),
    "feature_pre_filter": (bool, True, []),
    "pre_partition": (bool, False, ["is_pre_partition"]),
    "two_round": (bool, False, ["two_round_loading", "use_two_round_loading"]),
    "header": (bool, False, ["has_header"]),
    "label_column": (str, "", ["label"]),
    "weight_column": (str, "", ["weight"]),
    "group_column": (str, "", ["group", "group_id", "query_column", "query", "query_id"]),
    "ignore_column": (str, "", ["ignore_feature", "blacklist"]),
    "categorical_feature": (str, "", ["cat_feature", "categorical_column", "cat_column",
                                      "categorical_features"]),
    "forcedbins_filename": (str, "", []),
    "save_binary": (bool, False, ["is_save_binary", "is_save_binary_file"]),
    "precise_float_parser": (bool, False, []),
    # ---- predict ----
    "start_iteration_predict": (int, 0, []),
    "num_iteration_predict": (int, -1, []),
    "predict_raw_score": (bool, False, ["is_predict_raw_score", "predict_rawscore", "raw_score"]),
    "predict_leaf_index": (bool, False, ["is_predict_leaf_index", "leaf_index"]),
    "predict_contrib": (bool, False, ["is_predict_contrib", "contrib"]),
    "predict_disable_shape_check": (bool, False, []),
    # route Booster.predict through the bucketed SoA predictor engine
    # (serve/engine.py): batch sizes round up to power-of-two buckets so
    # repeated predicts with varying row counts stay within a bounded
    # compile cache.  auto = engine when rows x trees is large enough to
    # repay the trace (or when serving already built one); true =
    # always; false = legacy host-tree walk.  Results are byte-identical
    # on every path
    "predict_bucketed": (str, "auto", []),
    "pred_early_stop": (bool, False, []),
    "pred_early_stop_freq": (int, 10, []),
    "pred_early_stop_margin": (float, 10.0, []),
    # ---- objective ----
    "num_class": (int, 1, ["num_classes"]),
    "is_unbalance": (bool, False, ["unbalance", "unbalanced_sets"]),
    "scale_pos_weight": (float, 1.0, []),
    "sigmoid": (float, 1.0, []),
    "boost_from_average": (bool, True, []),
    "reg_sqrt": (bool, False, []),
    "alpha": (float, 0.9, []),
    "fair_c": (float, 1.0, []),
    "poisson_max_delta_step": (float, 0.7, []),
    "tweedie_variance_power": (float, 1.5, []),
    "lambdarank_truncation_level": (int, 30, []),
    "lambdarank_norm": (bool, True, []),
    "label_gain": (list, None, []),
    "objective_seed": (int, 5, []),
    # ---- metric ----
    # CLI conf-file pointer (config.h:99 ``config``): consumed by the
    # CLI layer (cli.py loads the file and merges); inert as a library
    # param, mirroring the reference where only main.cpp reads it
    "config": (str, "", ["config_file"]),
    # external parser spec (config.h parser_config_file): the reference
    # feeds it to its pluggable Parser factory; this framework covers the
    # same extension point with the Python-side registry
    # (data_io.py register_parser), so the path is accepted for CLI/conf
    # compatibility and custom formats are registered in Python instead
    "parser_config_file": (str, "", []),
    "metric": (list, None, ["metrics", "metric_types"]),
    "metric_freq": (int, 1, ["output_freq"]),
    "is_provide_training_metric": (bool, False, ["training_metric", "is_training_metric",
                                                 "train_metric"]),
    "eval_at": (list, None, ["ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at"]),
    "multi_error_top_k": (int, 1, []),
    "auc_mu_weights": (list, None, []),
    # ---- network ----
    "num_machines": (int, 1, ["num_machine"]),
    "local_listen_port": (int, 12400, ["local_port", "port"]),
    "time_out": (int, 120, []),
    "machine_list_filename": (str, "", ["machine_list_file", "machine_list", "mlist"]),
    "machines": (str, "", ["workers", "nodes"]),
    # ---- GPU/device (kept for API parity; TPU uses mesh_* below) ----
    "gpu_platform_id": (int, -1, []),
    "gpu_device_id": (int, -1, []),
    "gpu_use_dp": (bool, False, []),
    "num_gpu": (int, 1, []),
    # ---- TPU-specific (new axis, cf. SURVEY.md §1 device dimension) ----
    "mesh_shape": (list, None, []),          # one axis, e.g. [8]
    "mesh_axis_names": (list, None, []),     # one axis, e.g. ["data"]
    # tree_learner=data histogram reduction: true = reduce-scatter the
    # feature-chunked histograms so each shard carries only [L, F/n, B, 3]
    # of GLOBAL histograms (the reference's ReduceScatter owner shape,
    # data_parallel_tree_learner.cpp:174-186); false = legacy full psum
    # (every shard holds all global histograms) — A/B escape hatch
    "dp_owner_shard": (bool, True, []),
    "hist_dtype": (str, "float32", []),      # histogram accumulation dtype
    # auto: masked on both devices (the port's CPU path is its card
    # path's twin); forced splits and the monotone methods past basic
    # promote it to partitioned (models/gbdt.py resolve_learner)
    "tpu_learner": (str, "auto", []),  # auto | partitioned | masked
    # rows of one row block of every dense histogram pass (B1, B1-K and
    # their integer and member forms, the partitioned learner's segment
    # histogram), rounded up to the kernel's granularity
    # (ops/histogram.py); 0 = the kernels' automatic shape, or under
    # hist_tune=on the tuner's choice.  Another value re-partitions B1's
    # f32 sums (a histogram a few ulps away; B1-K's and the segment
    # histogram's fixed-point sums and the integer forms are exact at
    # every value); k-hot sparse storage keeps its own blocking
    "rows_per_block": (int, 0, []),
    # iterations fused into one on-device program (lax.scan) when the
    # objective/bagging config allows it — amortizes the host<->device
    # round-trip over the chunk (JAX package; this port runs per iteration).
    # 0/1 disables fusion.
    "fused_chunk": (int, 25, []),
    # super-epoch trainer (docs/Fused-Training.md): lax.scan over k FULL
    # boosting iterations — grow + score update + traced metric eval
    # over the bucketed validation sets + an early-stop vote carried as
    # a traced flag — with exactly ONE host sync per epoch.  0 = auto
    # (engine picks k from fused_chunk / early_stopping_round when the
    # config qualifies), >0 = explicit epoch size, -1 = disable (always
    # per-iteration eval)
    "superepoch": (int, 0, []),
    # ---- fleet training (lightgbm_tpu/fleet/, docs/Fleet.md) ----
    # number of fleet members when no explicit sweep is given: N seed
    # replicas of the base params — member j trains with seed+j,
    # bagging_seed+j, feature_fraction_seed+j, byte-identical to a solo
    # run with those seeds.  0 disables (fleet_train needs members from
    # one of fleet_members / fleet_sweep / the members= argument)
    "fleet_members": (int, 0, []),
    # sweep spec: "param=v1|v2;param2=v3|v4" — the cartesian grid of
    # the listed member-axis params (learning_rate, seed, bagging_seed,
    # feature_fraction_seed, num_leaves) becomes the fleet roster.  All
    # members grow inside ONE vmapped super-epoch program; num_leaves
    # variation requires padded_leaves bucketing (the same one-trace
    # rule the solo path pins)
    "fleet_sweep": (str, "", []),
    # traced on-device metric evaluation (metrics.traced_metric_fn):
    # "auto" uses traced (f32) eval wherever the super-epoch engages and
    # host (f64) eval elsewhere; "true" forces traced eval in the
    # per-iteration loop too (the byte-identity partner of the scan
    # path); "false" disables traced eval AND the super-epoch whenever
    # validation sets are attached
    "fused_eval": (str, "auto", []),
    # quantized training (docs/Quantized-Training.md, ROADMAP item 3):
    # pack per-row gradients/hessians to int8/int16 with one shared
    # per-channel scale per iteration and stochastic rounding, and
    # accumulate EXACT int32 histograms through the one-hot contraction
    # — 2-4x less HBM traffic per histogram pass and a step toward the
    # MXU's low-precision throughput.  Gains/leaf values are computed
    # from dequantized totals at split-scan time only; an AUC/metric
    # parity harness (tests/test_quant.py) pins quant-vs-f32 quality on
    # regression/binary/multiclass/lambdarank.  false (default) is
    # byte-identical to pre-quantization training
    "quant_train": (bool, False, ["use_quantized_grad"]),
    # packed gradient/hessian width: 8 (int8 lanes, the full HBM win)
    # or 16 (int16, tighter parity at half the bandwidth saving)
    "quant_bits": (int, 8, []),
    # stochastic (unbiased, iteration-keyed counter RNG — resume stays
    # byte-identical) | nearest (deterministic, biased).  No alias to
    # the reference's bool `stochastic_rounding` on purpose: a bool
    # value would coerce to a nonsense mode string
    "quant_round": (str, "stochastic", []),
    # leaves split per grower super-step (masked learner).  1 = exact
    # strict leaf-wise growth (reference semantics).  K>1 splits the top-K
    # leaves by cached gain per step and builds all K child histograms in
    # ONE C=3K one-hot contraction — ~K× more MXU sublane utilization and
    # 1/K the one-hot passes (PROFILE.md), at the cost of a slightly
    # different (still best-first) growth order.  0 = auto: 1 below 64
    # leaves, then 8.
    "split_batch": (int, 0, []),
    # measured (K, rows_per_block) autotuner of the histogram kernels
    # (ops/hist_tune.py): "on" runs a one-shot sweep of the shipped B1-K
    # (B1-K-int under quant_train) over the split_batch widths and three
    # row blocks each at FIRST fit per (card model, shape bucket),
    # persists the choice in hist_tune.json (in compile_cache_dir when
    # set, else the kernels' build directory), and applies it ONLY on
    # the masked learner, on dense storage, when split_batch=0 (auto; an
    # explicit width is the user's choice and skips the sweep entirely),
    # with the paired block_rows filling rows_per_block=0.  The tuned K
    # changes the (equally valid) growth order, so "on" trades
    # cross-platform model determinism for measured throughput; "off"
    # (default) reproduces today's exact shapes, traces and models
    "hist_tune": (str, "off", []),
    # strict (split_batch=1) grower: build the per-split smaller-child
    # histogram through the batched path's slot mechanism (one [N]
    # int32 slot vector as the scan operand) instead of materializing
    # a fresh masked [N, 3] vals temp per split.  BYTE-IDENTICAL
    # models by construction (the 0/1 multiply happens inside the
    # row-block scan on the same values; pinned by
    # tests/test_hist_width.py) — false restores the serialized
    # masked-operand baseline for A/B
    "hist_overlap": (bool, True, []),
    # ---- compile cache / trace buckets ----
    # compile-time management (ROADMAP item 4; docs/Compile-Cache.md)
    # persistent XLA compilation cache across processes (train -> serve
    # warm start): enabled by default; the directory precedence is
    # compile_cache_dir > a pre-set JAX_COMPILATION_CACHE_DIR (the
    # user's choice is respected, never clobbered) > a per-user,
    # per-host-fingerprint tmp path (utils/compile_cache.py)
    "compile_cache": (bool, True, ["persistent_compile_cache"]),
    "compile_cache_dir": (str, "", []),
    # persistence thresholds (previously hardwired): only compiles at
    # least this long / this large are written to the cache
    "compile_cache_min_compile_s": (float, 0.5, []),
    "compile_cache_min_entry_bytes": (int, 0, []),
    # bucket the trace-relevant static dims (utils/shapes.py): the
    # grower's leaf budget pads to a pow2 bucket (num_leaves 31/40/63
    # share ONE L=64 trace with bit-identical trees — the while_loop
    # exits on the actual budget), explicit split_batch snaps to the
    # shipped {1, 8, 16, 32, 64} widths (fitted under the leaf
    # budget), and DENSE validation sets row-bucket
    # so early stopping over differently-sized valid sets stops
    # re-tracing (sparse-binned valid sets keep exact shapes).
    # false = exact per-shape traces (A/B escape hatch);
    # tools/check_retraces.py pins the bucketed trace budget
    "trace_buckets": (bool, True, []),
    # ---- telemetry / observability ----
    # master switch for the obs subsystem (lightgbm_tpu/obs/): per-phase
    # spans + metrics registry + comm-bytes counters on the training
    # loop.  false (default) keeps the hot path byte-identical: zero
    # extra host syncs, no per-iteration allocation beyond a branch
    "telemetry": (bool, False, []),
    # JSONL span sink path; convert with obs.trace.jsonl_to_chrome for
    # Perfetto / chrome://tracing.  Empty = in-memory events only
    "telemetry_trace_file": (str, "", []),
    # [k, n] — capture iterations [k, k+n) with jax.profiler (best
    # effort; requires telemetry=true).  [k] captures one iteration
    "telemetry_profile_iters": (list, None, []),
    # flight recorder (obs/blackbox.py): keep a bounded ring of
    # per-iteration records (phase seconds, eval results, finite-guard
    # flags, static comm/flop counters) and dump the last K as JSONL on
    # exception, watchdog fire, or a finite_check_policy trigger.
    # false (default) allocates nothing and never touches disk
    "telemetry_blackbox": (bool, False, []),
    # dump path; empty derives <output_model>.blackbox.jsonl (train)
    # or lgbtpu_serve_blackbox.jsonl (serve)
    "telemetry_blackbox_path": (str, "", []),
    # ring capacity: how many trailing iteration records a dump holds
    "telemetry_blackbox_last_k": (int, 64, []),
    # roofline peak overrides for device kinds obs/attrib.py's table
    # does not know (0 = auto-detect from the device kind): MXU peak
    # FLOP/s and HBM bandwidth in GB/s — the denominators of the
    # perf.* mfu / bound keys
    "telemetry_peak_flops": (float, 0.0, []),
    "telemetry_peak_hbm_gbs": (float, 0.0, []),
    # ---- fault tolerance ----
    # retries after the first failed device-claim / jax.distributed
    # bring-up attempt (jittered exponential backoff, utils/resilience.py)
    "dist_init_retries": (int, 2, []),
    # watchdog + retry deadline (seconds) for device/distributed bring-up:
    # a blocking claim exceeding this dumps all-thread stacks via
    # faulthandler (a wedged claim is otherwise silent); 0 disables
    "dist_init_timeout_s": (float, 300.0, []),
    # when multi-chip bring-up exhausts its retries, degrade to the
    # serial learner with a logged warning instead of raising
    "dist_fallback_serial": (bool, False, []),
    # ---- elastic training (lightgbm_tpu/parallel/elastic.py) ----
    # master switch for the elastic liveness + recovery layer: the
    # training loop's host fetch runs under the collective deadline,
    # the device claim under a cancel-and-raise watchdog, peers are
    # liveness-checked per iteration, and snapshot params-signatures
    # treat the topology (tree_learner=data|serial, mesh_shape,
    # num_machines) as volatile so a shrunk mesh can resume the same
    # run.  false (default) keeps every path byte-identical to before
    "elastic_enable": (bool, False, []),
    # per-iteration collective deadline (seconds): the training loop's
    # one host fetch — where every queued collective actually blocks —
    # is abandoned past this and classified as
    # ElasticFailure("collective_timeout"); 0 disables the deadline
    "elastic_collective_timeout_s": (float, 300.0, []),
    # heartbeat cadence of the per-process liveness thread (elastic
    # ladder runs only; requires elastic_heartbeat_dir)
    "elastic_heartbeat_interval_s": (float, 1.0, []),
    # a peer whose heartbeat file is staler than this is declared lost
    # (ElasticFailure("host_loss"))
    "elastic_heartbeat_timeout_s": (float, 10.0, []),
    # shared directory for heartbeat files (one hb_<process>.json per
    # process); empty disables the heartbeat layer
    "elastic_heartbeat_dir": (str, "", []),
    # wall-clock budget (seconds) for one recovery episode: from the
    # first classified failure until training runs again, across all
    # retry/shrink attempts; past it the ladder re-raises.  0 = no
    # budget
    "elastic_recover_timeout_s": (float, 600.0, []),
    # same-rung retries (jittered backoff) before the ladder shrinks
    # the mesh; host_loss always shrinks immediately
    "elastic_retries": (int, 1, []),
    # check grad/hess and new-tree leaf outputs for non-finite values
    # every k iterations (one amortized scalar sync; fused-chunk
    # compatible); 0 disables
    "finite_check_freq": (int, 0, []),
    # what to do when the finite check trips: raise | skip_iter (the
    # iteration contributes a zero stump) | clamp (nan_to_num gradients
    # and leaf outputs, applied every iteration — it is sync-free)
    "finite_check_policy": (str, "raise", []),
    # ---- computation integrity (lightgbm_tpu/integrity.py) ----
    # silent-data-corruption detection: every k iterations re-execute
    # the iteration's grow (histogram contraction + split scan) through
    # an independently-jitted shadow program and compare — bitwise on
    # int32 fields, ulp-bounded on f32 — plus cheap in-graph invariants
    # riding the existing consolidated fetch every iteration.  0
    # disables the layer entirely (byte-identical to pre-integrity
    # behavior, zero extra host syncs).  Forces the per-iteration
    # training path (fused_chunk/super-epoch fall back; see
    # GBDTModel.fused_reasons)
    "integrity_check_freq": (int, 0, []),
    # what a STICKY mismatch (fails the one re-check) does: raise
    # (IntegrityFailure, kind "sdc") | rewind (engine.train re-enters
    # from the newest integrity-verified snapshot, up to
    # integrity.MAX_REWINDS times) | quarantine (additionally marks the
    # suspect devices so the elastic ladder's next mesh excludes them)
    "integrity_policy": (str, "raise", []),
    # float32 comparison slack for the shadow compare, in ulps (units
    # in the last place); int32 fields are always compared bitwise.
    # 0 = exact; the default absorbs benign reassociation between the
    # two traces
    "integrity_ulp_tol": (int, 2, []),
    # newest snapshots kept on disk (model + manifest + state pruned
    # together); <= 0 keeps all
    "snapshot_keep": (int, 3, []),
    # auto-resume: locate the latest VALID snapshot of output_model
    # (manifest params-signature + data fingerprint match) and continue
    # through the init_model path (engine.py); never recorded in the
    # saved model's parameters section
    "resume": (bool, False, ["auto_resume"]),
    # ---- continual training (lightgbm_tpu/pipeline/continual.py) ----
    # boosting iterations per continual generation: each generation
    # appends a data chunk and boosts this many more rounds from the
    # newest complete snapshot via the init_model path
    "continual_rounds": (int, 10, []),
    # shrink the contribution of the trees carried over from previous
    # generations by this factor each generation (Tree::Shrinkage over
    # the loaded model before the init score is computed); 1.0 = no
    # decay.  Refused for linear-tree models (only the constant leaf
    # values would decay, like refit)
    "continual_decay": (float, 1.0, []),
    # retries per pipeline stage (append/boost/publish/promote) for
    # transient failures, on top of the first attempt; gate refusals
    # (GateFailure) are never retried — they roll back
    "continual_retries": (int, 1, []),
    # promotion-gate budget (seconds): a shadow-parity probe that has
    # not finished within it is a gate FAILURE (automatic rollback), not
    # a wait.  0 = no timeout
    "continual_timeout_s": (float, 30.0, []),
    # where gate-failed candidates are moved (model + sidecars + a
    # blackbox reason dump) so the next generation can never boost from
    # them; empty derives <output_model>.quarantine
    "continual_quarantine_dir": (str, "", []),
    # CLI task=continual chunk sources: files appended one generation
    # each, after the base generation trained from ``data``
    "continual_data": (list, None, ["continual_chunks"]),
    # shadow-traffic parity probe: how many of the last live serve
    # batches are replayed through a promotion candidate (the serve
    # server keeps a ring of this many batches; without live traffic
    # the probe replays slices of the newest data chunk).  0 disables
    # the replay entirely — the metric-regression gate still applies
    "shadow_probe_batches": (int, 8, []),
    # objective-aware score-DRIFT bound of the probe: probability-like
    # outputs (binary/multiclass/xentropy) compare absolutely, unbounded
    # outputs relative to the incumbent's scale.  This is the
    # freshness-vs-stability budget — how far a candidate may move live
    # scores — not a corruption check (that is the lineage gate below);
    # the permissive default only rejects insanity.  NOTE: probability
    # drift is bounded by 1.0, so at the default the probability leg
    # enforces only finiteness/shape — set an explicit tolerance to
    # bound how far a candidate may move classification scores
    "shadow_probe_tolerance": (float, 1.0, []),
    # lineage-parity tolerance (relative): the candidate's raw-score
    # prefix over the incumbent's iteration count must reproduce the
    # (decayed) incumbent's raw scores to float rounding — the
    # convergence-independent corruption catcher.  Applied only when the
    # candidate is a continuation of the serving incumbent (the
    # trainer's own promotions; POST /promote of an unrelated retrain
    # skips it)
    "shadow_probe_lineage_tolerance": (float, 1e-9, []),
    # allowed eval-metric regression of the candidate vs the incumbent
    # on the gate set (the newest chunk): worse by more than this and
    # the promotion rolls back
    "shadow_probe_metric_tolerance": (float, 0.0, []),
    # ---- serving (lightgbm_tpu/serve/, docs/Serving.md) ----
    # micro-batch cap in rows: the batcher dispatches a batch as soon as
    # this many rows are queued; also the engine's bucket cap, bounding
    # XLA compiles per model to ~log2(serve_max_batch)
    "serve_max_batch": (int, 1024, []),
    # how long the first queued request holds the coalescing window open
    # before the batch dispatches short of serve_max_batch
    "serve_max_wait_ms": (float, 2.0, []),
    # bounded queue size in ROWS: beyond it, submissions are rejected
    # with an explicit retry-after (HTTP 429) instead of growing the
    # backlog without bound
    "serve_queue_rows": (int, 8192, ["serve_queue_size"]),
    # smallest padded-batch bucket: tiny requests all share one compiled
    # shape instead of one per power of two below it
    "serve_min_bucket": (int, 16, []),
    # retries for TRANSIENT device errors during a serve batch
    # (utils/resilience.py classifier; programming errors never retry)
    "serve_retries": (int, 2, []),
    # opt-in device-resident fast path: bin + traverse + accumulate +
    # objective transform run as ONE jitted program per (model,
    # row-bucket) — the only host<->device sync per batch is the final
    # score fetch.  Approximate vs the exact host path: rows tying a
    # split threshold within f32 rounding may bin differently, and leaf
    # values accumulate in f32 (tree order).  The engine self-check
    # gates the path; a parity failure demotes the model to the host
    # walk (serve.host_fallback_batches) instead of refusing traffic
    "serve_device_binning": (bool, False, []),
    # pack the serve engine's flattened node tables to the narrowest
    # dtypes the model allows (thresholds uint8/uint16 by bin count,
    # children/features by node/feature count): ~4x smaller HBM/VMEM
    # footprint per resident model — the headroom multi-model
    # co-hosting spends.  Decisions are identical either way
    "serve_packed_tables": (bool, True, []),
    # co-hosting cap: max model versions kept device-resident in the
    # serving registry; loading past it evicts the oldest non-current
    # version (hot-swap/shadow versions below the cap serve without
    # re-upload or re-trace).  The current version and the incoming
    # load are never evicted, so a shadow load may exceed the cap by
    # one until the next load/swap.  0 = unlimited
    "serve_max_resident": (int, 0, []),
    "serve_host": (str, "127.0.0.1", []),
    "serve_port": (int, 7070, []),
    # default per-request deadline (ms): requests are failed-fast at
    # admission when the queue's estimated wait already exceeds it, and
    # shed before dispatch when it lapsed while queued — device time is
    # never spent on a request the client has abandoned.  0 = none;
    # per-request deadline_ms overrides
    "serve_deadline_ms": (float, 0.0, ["serve_default_deadline_ms"]),
    # consecutive FAILED batches (infrastructure errors, after
    # serve_retries) that open the serving circuit breaker: while open,
    # submissions are rejected up front (HTTP 503 + Retry-After)
    # instead of queuing onto a failing device; after the cooldown a
    # probe batch decides close vs re-open (cooldown doubles, capped at
    # 16x).  0 disables the breaker
    "serve_breaker_failures": (int, 5, []),
    "serve_breaker_cooldown_ms": (float, 1000.0, []),
    # graceful-drain budget (seconds) on shutdown (SIGTERM / POST
    # /drain / Server.drain): new work is refused, queued work finishes
    # within the budget, leftovers fail with BatcherClosed
    "serve_drain_s": (float, 5.0, []),
    # per-request segment routing (fleet serving, docs/Fleet.md):
    # requests carrying segment=<key> are routed to the model version
    # the SegmentRouter maps that key to; unknown keys fall back to the
    # default segment's version (or the registry's current model when
    # the default is unassigned)
    "serve_default_segment": (str, "default", []),
    # cardinality bound for per-version / per-segment serve metric
    # labels: beyond this many distinct label values, further ones
    # aggregate into one "__other__" bucket so a 500-segment fleet
    # cannot bloat the /metrics exposition.  0 = unlimited
    "serve_metrics_max_versions": (int, 32, []),
    # verify artifacts before activation: SHA-256 of model files
    # against the snapshot manifest's recorded checksum, plus the
    # engine's byte-parity self-check probe (fall back to the host walk
    # on mismatch).  Disable only to shave load latency
    "serve_verify_artifacts": (bool, True, []),
    # ---- out-of-core ingest (lightgbm_tpu/ingest.py) ----
    # stream text data through bounded-memory chunks with a per-chunk
    # spool + manifest (sha256, row span) so a killed loader resumes
    # from the last complete chunk, and fit bin mappers from mergeable
    # quantile sketches (binning.QuantileSketch) instead of a full
    # in-memory sample.  Implied by passing a directory as ``data``
    "ingest_enable": (bool, False, ["streaming_ingest"]),
    # rows per chunk when splitting a single text file (directory
    # sources use one chunk per file)
    "ingest_chunk_rows": (int, 65536, []),
    # spool/manifest directory; empty -> "<data>.ingest" next to the
    # source
    "ingest_dir": (str, "", ["ingest_spool_dir"]),
    # resume from spooled chunks whose manifest verifies (byte-identical
    # to the uninterrupted run); false re-ingests from scratch
    "ingest_resume": (bool, True, []),
    # persistently corrupt chunk (sha mismatch, parse failure, row-count
    # drift) policy: "raise" fails the run, "skip" quarantines the chunk
    # and keeps an accounting of the dropped rows
    "ingest_bad_chunk": (str, "raise", []),
    # transient read-error retries per chunk (attempts = retries + 1)
    # and the base of their jittered exponential backoff
    "ingest_retries": (int, 2, []),
    "ingest_retry_backoff_s": (float, 0.1, []),
    # per-chunk read+parse deadline: a reader wedged on a dead
    # filesystem is abandoned (resilience.Watchdog raise mode) and the
    # timeout classifies as retryable.  0 disables
    "ingest_read_timeout_s": (float, 60.0, []),
    # per-feature quantile-sketch capacity: distinct (value, count)
    # pairs kept exactly; past this the sketch compacts with rank error
    # ~2*rows/capacity per compaction generation (docs/Ingest.md)
    "ingest_sketch_size": (int, 2048, []),
    # ---- IO / task ----
    "task": (str, "train", ["task_type"]),
    "data": (str, "", ["train", "train_data", "train_data_file", "data_filename"]),
    "valid": (list, None, ["test", "valid_data", "valid_data_file", "test_data",
                           "test_data_file", "valid_filenames"]),
    "input_model": (str, "", ["model_input", "model_in"]),
    "output_model": (str, "LightGBM_model.txt", ["model_output", "model_out"]),
    "convert_model": (str, "gbdt_prediction.c", ["convert_model_file"]),
    "convert_model_language": (str, "c", []),
    "saved_feature_importance_type": (int, 0, []),
    "snapshot_freq": (int, -1, ["save_period"]),
    "output_result": (str, "LightGBM_predict_result.txt",
                      ["predict_result", "prediction_result", "predict_name",
                       "prediction_name", "pred_name", "name_pred"]),
}

# alias -> canonical name
_ALIASES: Dict[str, str] = {}
for _name, (_t, _d, _al) in _PARAMS.items():
    for _a in _al:
        _ALIASES[_a] = _name


def canonical_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Keys alias-resolved to canonical names (first writer wins among
    aliases within one dict, matching _set's alias priority).  Use when
    MERGING two param dicts — a raw {**a, **b} lets an alias in one dict
    silently coexist with the canonical name in the other, and _set's
    first-writer rule would then pick the wrong source."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        name = _ALIASES.get(k, k)
        if name not in out:
            out[name] = v
    return out

# Objective aliases (config_auto.cpp ParseObjectiveAlias analog)
_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary", "binary_logloss": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "none": "custom", "null": "custom", "custom": "custom", "na": "custom",
}

_METRIC_ALIASES = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression_l2": "l2",
    "regression": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "quantile": "quantile", "mape": "mape", "mean_absolute_percentage_error": "mape",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg", "xendcg": "ndcg",
    "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg", "xendcg_mart": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "auc": "auc", "average_precision": "average_precision",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc_mu": "auc_mu",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss", "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kldiv", "kldiv": "kldiv",
    "none": "custom", "null": "custom", "custom": "custom", "na": "custom",
}

_RANKING_OBJECTIVES = {"lambdarank", "rank_xendcg"}
_MULTICLASS_OBJECTIVES = {"multiclass", "multiclassova"}


def _coerce(name: str, typ: type, value: Any) -> Any:
    """Coerce a raw (possibly string) parameter value to its declared type."""
    if value is None:
        return None
    if typ is bool:
        if isinstance(value, str):
            v = value.strip().lower()
            if v in ("true", "1", "+", "yes", "on"):
                return True
            if v in ("false", "0", "-", "no", "off"):
                return False
            raise ValueError(f"Cannot parse bool parameter {name}={value!r}")
        return bool(value)
    if typ is int:
        if isinstance(value, bool):
            return int(value)
        return int(float(value)) if isinstance(value, str) else int(value)
    if typ is float:
        return float(value)
    if typ is list:
        if isinstance(value, str):
            if not value:
                return None
            return [_auto_num(tok) for tok in value.replace(";", ",").split(",") if tok != ""]
        if isinstance(value, (list, tuple)):
            return list(value)
        if hasattr(value, "tolist"):      # ndarray / pandas
            v = value.tolist()
            return v if isinstance(v, list) else [v]
        return [value]
    if typ is str:
        return str(value)
    return value


def _auto_num(tok: str) -> Union[int, float, str]:
    tok = tok.strip()
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


# unknown parameter names already warned about (once per process)
_warned_unknown: set = set()


class Config:
    """Dataclass-of-record holding every hyperparameter.

    ``Config(params_dict)`` replicates ``Config::Set``
    (src/io/config.cpp:195-259): alias resolution, value
    parsing, then conflict checking/auto-promotion (``CheckParamConflict``
    config.cpp:261).
    """

    def __init__(self, params: Optional[Dict[str, Any]] = None, **kw):
        for name, (typ, default, _aliases) in _PARAMS.items():
            setattr(self, name, default)
        merged: Dict[str, Any] = {}
        if params:
            merged.update(params)
        merged.update(kw)
        self.raw_params: Dict[str, Any] = dict(merged)
        # apply the requested (or default) verbosity BEFORE parsing, so
        # parse-time warnings (unknown parameters) honor THIS
        # construction's level rather than a previous Config's — the
        # level is process-global, like the reference's Log state
        from .utils.log import Log
        v = merged.get("verbosity", merged.get("verbose", self.verbosity))
        try:
            Log.set_verbosity(_coerce("verbosity", int, v))
        except (TypeError, ValueError):
            pass            # bad value: surfaced by _set's typed coerce
        self._set(merged)
        self._check_param_conflict()

    def _set(self, params: Dict[str, Any]) -> None:
        seen: Dict[str, str] = {}
        for key, value in params.items():
            name = _ALIASES.get(key, key)
            if name not in _PARAMS:
                # Unknown keys are kept (callbacks / custom use) but not
                # typed — and warned ONCE per key per process, like the
                # reference's "Unknown parameter" message (config.cpp Set
                # tail); one train() call constructs several Configs
                # (engine/booster/dataset), so an unconditional warning
                # would repeat 2-4x per call
                if key not in _warned_unknown:
                    _warned_unknown.add(key)
                    from .utils.log import Log
                    Log.warning(f"Unknown parameter: {key}")
                setattr(self, name, value)
                continue
            if name in seen:
                # First writer wins for a canonical name through distinct
                # aliases, matching the reference alias-priority behavior.
                continue
            seen[name] = key
            typ = _PARAMS[name][0]
            setattr(self, name, _coerce(name, typ, value))

        if "objective" in seen or "objective" in params:
            obj = str(self.objective).lower()
            self.objective = _OBJECTIVE_ALIASES.get(obj, obj)
        if self.metric is not None:
            norm = []
            for m in self.metric:
                m = str(m).strip().lower()
                norm.append(_METRIC_ALIASES.get(m, m))
            self.metric = norm

    def _check_param_conflict(self) -> None:
        # Mirrors CheckParamConflict (config.cpp:261+): auto-select parallel
        # learner, clamp fractions, task-implied settings.
        if self.num_machines > 1 and self.tree_learner == "serial":
            self.tree_learner = "data"
        self.is_parallel = self.tree_learner in ("data", "feature", "voting")
        self.is_data_based_parallel = self.tree_learner in ("data", "voting")
        if self.objective in _RANKING_OBJECTIVES and self.metric is None:
            self.metric = ["ndcg"]
        if self.objective in _MULTICLASS_OBJECTIVES and self.num_class <= 1:
            raise ValueError("num_class must be >1 for multiclass objectives")
        if self.objective not in _MULTICLASS_OBJECTIVES \
                and self.num_class != 1 and self.objective != "custom":
            # custom-objective training (objective=none) legitimately
            # carries num_class>1: the caller's fobj produces per-class
            # gradients (basic.py __boost F-ravels [n, num_class])
            raise ValueError("num_class can only be used with multiclass objectives")
        if self.bagging_freq > 0 and (self.bagging_fraction >= 1.0 and
                                      self.pos_bagging_fraction >= 1.0 and
                                      self.neg_bagging_fraction >= 1.0):
            self.bagging_freq = 0
        if self.boosting == "goss":  # legacy alias: boosting=goss
            self.boosting = "gbdt"
            self.data_sample_strategy = "goss"
        if self.boosting == "rf":
            if self.bagging_freq <= 0 or self.bagging_fraction >= 1.0 or self.bagging_fraction <= 0.0:
                raise ValueError("Random forest needs bagging_freq>0 and 0<bagging_fraction<1")
        if self.max_bin < 2:
            raise ValueError("max_bin must be >= 2")
        if self.num_leaves < 2:
            raise ValueError("num_leaves must be >= 2")
        if self.quant_bits not in (8, 16):
            raise ValueError(f"quant_bits={self.quant_bits} must be 8 "
                             "or 16")
        if self.quant_round not in ("stochastic", "nearest"):
            raise ValueError(
                f"quant_round={self.quant_round!r} must be one of: "
                "stochastic, nearest")
        if self.hist_tune not in ("off", "on"):
            raise ValueError(
                f"hist_tune={self.hist_tune!r} must be one of: off, on")
        if self.finite_check_policy not in ("raise", "skip_iter", "clamp"):
            raise ValueError(
                f"finite_check_policy={self.finite_check_policy!r} must be "
                "one of: raise, skip_iter, clamp")
        if self.integrity_check_freq < 0:
            raise ValueError("integrity_check_freq must be >= 0")
        if self.integrity_policy not in ("raise", "rewind", "quarantine"):
            raise ValueError(
                f"integrity_policy={self.integrity_policy!r} must be "
                "one of: raise, rewind, quarantine")
        if self.integrity_ulp_tol < 0:
            raise ValueError("integrity_ulp_tol must be >= 0")
        if self.compile_cache_min_compile_s < 0:
            raise ValueError("compile_cache_min_compile_s must be >= 0")
        if self.compile_cache_min_entry_bytes < 0:
            raise ValueError("compile_cache_min_entry_bytes must be >= 0")
        if self.telemetry_profile_iters is not None \
                and len(self.telemetry_profile_iters) not in (1, 2):
            raise ValueError(
                "telemetry_profile_iters must be [start] or [start, count]")
        if self.telemetry_blackbox_last_k < 1:
            raise ValueError("telemetry_blackbox_last_k must be >= 1")
        for knob in ("telemetry_peak_flops", "telemetry_peak_hbm_gbs"):
            if getattr(self, knob) < 0:
                raise ValueError(f"{knob} must be >= 0 (0 = auto-detect)")
        dt = str(self.device_type).strip().lower()
        dt = "cuda" if dt == "gpu" else dt
        if dt not in ("cuda", "cpu"):
            raise ValueError(f"device_type={self.device_type!r} must be "
                             "cuda (alias gpu) or cpu")
        self.device_type = dt
        pb = str(self.predict_bucketed).strip().lower()
        if pb in ("true", "1", "+", "yes", "on"):
            self.predict_bucketed = "true"
        elif pb in ("false", "0", "-", "no", "off"):
            self.predict_bucketed = "false"
        elif pb == "auto":
            self.predict_bucketed = "auto"
        else:
            raise ValueError(
                f"predict_bucketed={self.predict_bucketed!r} must be "
                "auto, true or false")
        if self.serve_max_batch < 1:
            raise ValueError("serve_max_batch must be >= 1")
        if self.serve_max_wait_ms < 0:
            raise ValueError("serve_max_wait_ms must be >= 0")
        # the bucket floor can never exceed the batch cap, and the queue
        # must hold at least one full batch (clamped, not rejected: both
        # are derived sizing knobs)
        self.serve_min_bucket = max(1, min(self.serve_min_bucket,
                                           self.serve_max_batch))
        self.serve_queue_rows = max(self.serve_queue_rows,
                                    self.serve_max_batch)
        for knob in ("serve_deadline_ms", "serve_drain_s"):
            if getattr(self, knob) < 0:
                raise ValueError(f"{knob} must be >= 0")
        if self.serve_breaker_cooldown_ms <= 0:
            # 0 is not "retry immediately": a zero cooldown makes every
            # caller the half-open probe, so an open circuit would
            # never reject anything — the breaker would silently not
            # exist (disable it via serve_breaker_failures=0 instead)
            raise ValueError("serve_breaker_cooldown_ms must be > 0 "
                             "(set serve_breaker_failures=0 to disable "
                             "the breaker)")
        if self.serve_max_resident < 0:
            raise ValueError("serve_max_resident must be >= 0 "
                             "(0 = unlimited resident versions)")
        if self.serve_metrics_max_versions < 0:
            raise ValueError("serve_metrics_max_versions must be >= 0 "
                             "(0 = unlimited metric label values)")
        if self.fleet_members < 0:
            raise ValueError("fleet_members must be >= 0 "
                             "(0 = no implicit seed-replica roster)")
        if self.serve_breaker_failures < 0:
            raise ValueError("serve_breaker_failures must be >= 0 "
                             "(0 disables the breaker)")
        if self.continual_rounds < 1:
            raise ValueError("continual_rounds must be >= 1")
        if not (0.0 < self.continual_decay <= 1.0):
            raise ValueError("continual_decay must be in (0, 1] "
                             "(1 = no decay)")
        if self.continual_retries < 0:
            raise ValueError("continual_retries must be >= 0")
        if self.continual_timeout_s < 0:
            raise ValueError("continual_timeout_s must be >= 0 "
                             "(0 = no gate timeout)")
        if self.shadow_probe_batches < 0:
            raise ValueError("shadow_probe_batches must be >= 0")
        for knob in ("elastic_collective_timeout_s",
                     "elastic_recover_timeout_s"):
            if getattr(self, knob) < 0:
                raise ValueError(f"{knob} must be >= 0 (0 disables)")
        if self.elastic_heartbeat_interval_s <= 0:
            raise ValueError("elastic_heartbeat_interval_s must be > 0")
        if self.elastic_heartbeat_timeout_s \
                <= self.elastic_heartbeat_interval_s:
            # a deadline at or under the write cadence declares every
            # healthy peer dead on scheduler jitter alone
            raise ValueError(
                "elastic_heartbeat_timeout_s must exceed "
                "elastic_heartbeat_interval_s")
        if self.elastic_retries < 0:
            raise ValueError("elastic_retries must be >= 0")
        if self.ingest_bad_chunk not in ("raise", "skip"):
            raise ValueError(
                f"ingest_bad_chunk={self.ingest_bad_chunk!r} must be one "
                "of: raise, skip")
        if self.ingest_chunk_rows < 1:
            raise ValueError("ingest_chunk_rows must be >= 1")
        if self.ingest_retries < 0:
            raise ValueError("ingest_retries must be >= 0")
        for knob in ("ingest_retry_backoff_s", "ingest_read_timeout_s"):
            if getattr(self, knob) < 0:
                raise ValueError(f"{knob} must be >= 0 (0 disables)")
        if self.ingest_sketch_size < 16:
            raise ValueError("ingest_sketch_size must be >= 16")
        for knob in ("shadow_probe_tolerance",
                     "shadow_probe_metric_tolerance",
                     "shadow_probe_lineage_tolerance"):
            if getattr(self, knob) < 0:
                raise ValueError(f"{knob} must be >= 0")
        # verbosity drives the global log level with reference semantics
        # (config.h: <0 fatal-only, 0 warnings, 1 info, >=2 debug; the
        # reference's Config::Set calls Log::ResetLogLevel the same way)
        from .utils.log import Log
        Log.set_verbosity(self.verbosity)
        if self.eval_at is None:
            self.eval_at = [1, 2, 3, 4, 5]

    # -- helpers -----------------------------------------------------------
    @property
    def num_model_per_iteration(self) -> int:
        if self.objective in _MULTICLASS_OBJECTIVES \
                or (self.objective == "custom" and self.num_class > 1):
            # custom-objective multiclass: num_class models per iter,
            # gradients class-major from the caller (boosting.h
            # num_model_per_iteration via num_class)
            return self.num_class
        return 1

    def default_metric(self) -> List[str]:
        if self.metric is not None and len(self.metric) > 0:
            return list(self.metric)
        obj = self.objective
        table = {
            "regression": ["l2"], "regression_l1": ["l1"], "huber": ["huber"],
            "fair": ["fair"], "poisson": ["poisson"], "quantile": ["quantile"],
            "mape": ["mape"], "gamma": ["gamma"], "tweedie": ["tweedie"],
            "binary": ["binary_logloss"], "multiclass": ["multi_logloss"],
            "multiclassova": ["multi_logloss"], "cross_entropy": ["cross_entropy"],
            "cross_entropy_lambda": ["cross_entropy_lambda"],
            "lambdarank": ["ndcg"], "rank_xendcg": ["ndcg"],
        }
        return table.get(obj, [])

    def to_dict(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in _PARAMS}

    def copy(self, **updates) -> "Config":
        d = self.to_dict()
        d.update(updates)
        d.pop("eval_at", None) if updates.get("objective") else None
        return Config(d)

    def __repr__(self) -> str:
        changed = {k: getattr(self, k) for k, (t, d, a) in _PARAMS.items()
                   if getattr(self, k) != d}
        return f"Config({changed})"


def kv2map(argv: List[str]) -> Dict[str, str]:
    """Parse ``key=value`` CLI tokens (config.h:81 ``KV2Map`` analog)."""
    out: Dict[str, str] = {}
    for tok in argv:
        tok = tok.strip()
        if not tok or tok.startswith("#"):
            continue
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k.strip()] = v.split("#")[0].strip()
    return out


def load_config_file(path: str) -> Dict[str, str]:
    """Parse a LightGBM-style ``key = value`` config file (application.cpp:50)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out
