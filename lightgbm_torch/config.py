"""Parameter/config system of the port.

A copy of ``lightgbm_tpu/config.py`` trimmed to the keys batch prediction,
single-device training, sampling and evaluation read, plus the
training keys whose non-default values the port refuses.  The alias table is kept whole, so ``resolve_aliases`` maps every
parameter name exactly as the reference does and the ``parameters:`` block
of a saved model is the same text.  Keys the trimmed ``Config`` does not
hold are kept in ``_unknown`` without a warning, as the reference keeps the
keys it has no field for.

``device_type`` (alias ``device``) defaults to ``"cuda"``: the port runs on
the GPU unless the caller asks for ``"cpu"`` (reference:
include/LightGBM/config.h:41).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .robustness.guards import VALID_MODES
from .utils.log import LightGBMError, log_warning

# ---------------------------------------------------------------------------
# Alias table (reference: src/io/config_auto.cpp alias map; config.cpp:23-98 resolution rules:
# first the canonical name wins, then aliases in table order).
# ---------------------------------------------------------------------------

_PARAM_ALIASES: Dict[str, List[str]] = {
    "config": ["config_file"],
    "task": ["task_type"],
    "objective": ["objective_type", "app", "application", "loss"],
    "boosting": ["boosting_type", "boost"],
    "data_sample_strategy": [],
    "data": ["train", "train_data", "train_data_file", "data_filename"],
    "valid": ["test", "valid_data", "valid_data_file", "test_data", "test_data_file",
              "valid_filenames"],
    "num_iterations": ["num_iteration", "n_iter", "num_tree", "num_trees", "num_round",
                       "num_rounds", "nrounds", "num_boost_round", "n_estimators",
                       "max_iter"],
    "learning_rate": ["shrinkage_rate", "eta"],
    "num_leaves": ["num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes"],
    "tree_learner": ["tree", "tree_type", "tree_learner_type"],
    "num_threads": ["num_thread", "nthread", "nthreads", "n_jobs"],
    "device_type": ["device"],
    "seed": ["random_seed", "random_state"],
    "deterministic": [],
    "force_col_wise": [],
    "force_row_wise": [],
    "histogram_pool_size": ["hist_pool_size"],
    "max_depth": [],
    "min_data_in_leaf": ["min_data_per_leaf", "min_data", "min_child_samples",
                         "min_samples_leaf"],
    "min_sum_hessian_in_leaf": ["min_sum_hessian_per_leaf", "min_sum_hessian",
                                "min_hessian", "min_child_weight"],
    "bagging_fraction": ["sub_row", "subsample", "bagging"],
    "pos_bagging_fraction": ["pos_sub_row", "pos_subsample", "pos_bagging"],
    "neg_bagging_fraction": ["neg_sub_row", "neg_subsample", "neg_bagging"],
    "bagging_freq": ["subsample_freq"],
    "bagging_seed": ["bagging_fraction_seed"],
    "bagging_by_query": [],
    "feature_fraction": ["sub_feature", "colsample_bytree"],
    "feature_fraction_bynode": ["sub_feature_bynode", "colsample_bynode"],
    "feature_fraction_seed": [],
    "extra_trees": ["extra_tree"],
    "extra_seed": [],
    "early_stopping_round": ["early_stopping_rounds", "early_stopping",
                             "n_iter_no_change"],
    "early_stopping_min_delta": [],
    "first_metric_only": [],
    "max_delta_step": ["max_tree_output", "max_leaf_output"],
    "lambda_l1": ["reg_alpha", "l1_regularization"],
    "lambda_l2": ["reg_lambda", "lambda", "l2_regularization"],
    "linear_lambda": [],
    "min_gain_to_split": ["min_split_gain"],
    "drop_rate": ["rate_drop"],
    "max_drop": [],
    "skip_drop": [],
    "xgboost_dart_mode": [],
    "uniform_drop": [],
    "drop_seed": [],
    "top_rate": [],
    "other_rate": [],
    "min_data_per_group": [],
    "max_cat_threshold": [],
    "cat_l2": [],
    "cat_smooth": [],
    "max_cat_to_onehot": [],
    "top_k": ["topk"],
    "monotone_constraints": ["mc", "monotone_constraint", "monotonic_cst"],
    "monotone_constraints_method": ["monotone_constraining_method", "mc_method"],
    "monotone_penalty": ["monotone_splits_penalty", "ms_penalty", "mc_penalty"],
    "feature_contri": ["feature_contrib", "fc", "fp", "feature_penalty"],
    "forcedsplits_filename": ["fs", "forced_splits_filename", "forced_splits_file",
                              "forced_splits"],
    "refit_decay_rate": [],
    "cegb_tradeoff": [],
    "cegb_penalty_split": [],
    "cegb_penalty_feature_lazy": [],
    "cegb_penalty_feature_coupled": [],
    "path_smooth": [],
    "interaction_constraints": [],
    "verbosity": ["verbose"],
    "input_model": ["model_input", "model_in"],
    "output_model": ["model_output", "model_out"],
    "saved_feature_importance_type": [],
    "snapshot_freq": ["save_period"],
    "snapshot_keep": [],
    "resume_from": ["resume"],
    "linear_tree": ["linear_trees"],
    "max_bin": ["max_bins"],
    "max_bin_by_feature": [],
    "min_data_in_bin": [],
    "bin_construct_sample_cnt": ["subsample_for_bin"],
    "data_random_seed": ["data_seed"],
    "is_enable_sparse": ["is_sparse", "enable_sparse", "sparse"],
    "enable_bundle": ["is_enable_bundle", "bundle"],
    "use_missing": [],
    "zero_as_missing": [],
    "feature_pre_filter": [],
    "pre_partition": ["is_pre_partition"],
    "two_round": ["two_round_loading", "use_two_round_loading"],
    "ingest_mode": ["ingest"],
    "ingest_chunk_rows": ["ingest_batch_rows"],
    "ingest_cache": ["binned_cache"],
    "ingest_cache_path": ["binned_cache_path"],
    "ingest_sketch_size": ["sketch_size"],
    "header": ["has_header"],
    "label_column": ["label"],
    "weight_column": ["weight"],
    "group_column": ["group", "group_id", "query_column", "query", "query_id"],
    "ignore_column": ["ignore_feature", "blacklist"],
    "categorical_feature": ["cat_feature", "categorical_column", "cat_column",
                            "categorical_features"],
    "forcedbins_filename": [],
    "save_binary": ["is_save_binary", "is_save_binary_file"],
    "precise_float_parser": [],
    "parser_config_file": [],
    "start_iteration_predict": [],
    "num_iteration_predict": [],
    "predict_raw_score": ["is_predict_raw_score", "predict_rawscore", "raw_score"],
    "predict_leaf_index": ["is_predict_leaf_index", "leaf_index"],
    "predict_contrib": ["is_predict_contrib", "contrib"],
    "predict_disable_shape_check": [],
    "pred_early_stop": [],
    "pred_early_stop_freq": [],
    "pred_early_stop_margin": [],
    "output_result": ["predict_result", "prediction_result", "predict_name",
                      "prediction_name", "pred_name", "name_pred"],
    "convert_model_language": [],
    "convert_model": ["convert_model_file"],
    "objective_seed": [],
    "num_class": ["num_classes"],
    "is_unbalance": ["unbalance", "unbalanced_sets"],
    "scale_pos_weight": [],
    "sigmoid": [],
    "boost_from_average": [],
    "reg_sqrt": [],
    "alpha": [],
    "fair_c": [],
    "poisson_max_delta_step": [],
    "tweedie_variance_power": [],
    "lambdarank_truncation_level": [],
    "lambdarank_norm": [],
    "label_gain": [],
    "lambdarank_position_bias_regularization": [],
    "metric": ["metrics", "metric_types"],
    "metric_freq": ["output_freq"],
    "is_provide_training_metric": ["training_metric", "is_training_metric",
                                   "train_metric"],
    "eval_at": ["ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at"],
    "multi_error_top_k": [],
    "auc_mu_weights": [],
    "num_machines": ["num_machine"],
    "local_listen_port": ["local_port", "port"],
    "time_out": [],
    "machine_list_filename": ["machine_list_file", "machine_list", "mlist"],
    "machines": ["workers", "nodes"],
    "gpu_platform_id": [],
    "gpu_device_id": [],
    "gpu_use_dp": [],
    "num_gpu": [],
    "use_quantized_grad": [],
    "num_grad_quant_bins": [],
    "quant_train_renew_leaf": [],
    "stochastic_rounding": [],
    # --- TPU-specific knobs (new in this framework) ---
    "hist_backend": [],          # auto | segsum | onehot | pallas | stream
                                 # | scatter
    "hist_packed_width": ["histogram_packed_width"],  # 32 | 16 | 8
    "route_fusion": ["goss_route_fusion"],  # auto | on | off
    "hist_precision": [],        # auto | mixed (two-pass bf16, ~f32) | single
    "max_splits_per_round": [],  # batched leaf-wise: leaves split per device round
    "multiclass_batched": ["batched_multiclass"],
    "mesh_shape": [],            # e.g. "data:8" or "data:4,feature:2"
    "hist_comms": ["histogram_comms"],        # psum | reduce_scatter
    "hist_comms_dtype": ["histogram_comms_dtype"],  # f32 | bf16_pair
    "hist_comms_pipeline": ["histogram_comms_pipeline"],  # scatter chunks
    "row_compaction": ["sample_compaction"],  # auto | off | pad
    "fused_iter": ["fused_iteration"],        # auto | on | off
    "eval_fetch_freq": ["fetch_freq", "flag_poll_freq"],
    "tpu_dtype": [],             # f32 | bf16 accumulate dtype for histograms
    # --- robustness (docs/ROBUSTNESS.md) ---
    "nan_guard": ["nan_policy"],
    "dist_retries": [],
    "dist_backoff": [],
    # --- online serving (docs/SERVING.md) ---
    "serve_host": ["serving_host"],
    "serve_port": ["serving_port"],
    "serve_max_batch": ["serve_batch_size"],
    "serve_max_delay_ms": ["serve_batch_delay_ms"],
    "serve_queue_size": [],
    "serve_buckets": ["serve_bucket_ladder"],
    "serve_warmup": [],
    "serve_heartbeat": ["serve_heartbeat_file"],
    "serve_binary_port": ["binary_port", "serve_wire_port"],
    "serve_binary_accept_threads": ["binary_accept_threads"],
    "serve_models": ["model_roster", "serve_model_roster"],
    "serve_hbm_budget_mb": ["hbm_budget_mb", "serve_cache_budget_mb"],
    "serve_default_model": ["default_model_id"],
    "serve_explain_max_batch": ["explain_max_batch"],
    "serve_explain_queue_size": ["explain_queue_size"],
    "serve_explain_max_delay_ms": ["explain_max_delay_ms"],
    "serve_replicas": ["num_replicas", "serve_num_replicas"],
    "serve_fleet_mode": ["fleet_mode"],
    "serve_fleet_dir": ["fleet_dir"],
    "serve_deadline_ms": ["serve_deadline", "deadline_ms"],
    "serve_retries": [],
    "serve_retry_backoff_ms": [],
    "serve_breaker_failures": [],
    "serve_breaker_cooldown_s": [],
    "serve_restart_backoff_s": [],
    "serve_hang_timeout_s": ["serve_hang_timeout"],
    "serve_trace_sample": ["trace_sample_rate"],
    "serve_trace_tail": ["trace_tail_capacity"],
    "serve_access_log": ["access_log"],
    "serve_slo_availability": ["slo_availability_target"],
    "serve_slo_p99_ms": ["slo_p99_ms", "slo_latency_target_ms"],
    "serve_slo_window_s": ["slo_window"],
    "serve_slo_burn": ["slo_burn_threshold"],
    "quality_profile": ["quality_sidecar"],
    "quality_sample": ["drift_sample"],
    "quality_audit_sample": ["shadow_audit_sample"],
    "quality_min_rows": ["drift_min_rows"],
    "quality_topk": ["drift_topk"],
    "drift_threshold": ["drift_psi_threshold"],
    "drift_window_s": ["drift_window"],
    # --- closed-loop pipeline (docs/ROBUSTNESS.md) ---
    "pipeline_fresh_data": ["fresh_data"],
    "pipeline_refit_iterations": ["refit_iterations"],
    "pipeline_gate_margin": ["gate_margin"],
    "pipeline_observe_s": ["observe_window_s"],
    "pipeline_observe_poll_s": [],
    "pipeline_promote": [],
    "pipeline_model_id": ["model_id"],
    # --- telemetry (docs/OBSERVABILITY.md) ---
    "telemetry": ["enable_telemetry"],
    "telemetry_out": ["telemetry_output", "metrics_out"],
    "trace_out": ["trace_output", "trace_file"],
    "telemetry_recompile_threshold": ["recompile_warn_threshold"],
    "telemetry_straggler_every": ["straggler_check_every"],
    "telemetry_straggler_skew": ["straggler_warn_skew"],
    "telemetry_cost": ["cost_capture", "telemetry_cost_capture"],
    "profile_out": ["profile_dir", "profile_output"],
}

# alias -> canonical
_ALIAS_TO_CANONICAL: Dict[str, str] = {}
for _canon, _aliases in _PARAM_ALIASES.items():
    for _a in _aliases:
        _ALIAS_TO_CANONICAL[_a] = _canon


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
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg", "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}


# Metric aliases (reference: src/metric/metric.cpp; the JAX package's table,
# copied whole)
_METRIC_ALIASES = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression_l2": "l2",
    "regression": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance",
    "tweedie": "tweedie",
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
    "r2": "r2",
    "": "", "none": "none", "null": "none", "custom": "none", "na": "none",
}


def canonical_metric(name: str) -> str:
    name = name.strip().lower()
    if name not in _METRIC_ALIASES:
        raise ValueError(f"Unknown metric: {name!r}")
    return _METRIC_ALIASES[name]


def canonical_objective(name: str) -> str:
    name = name.strip().lower()
    if name not in _OBJECTIVE_ALIASES:
        raise ValueError(f"Unknown objective: {name!r}")
    return _OBJECTIVE_ALIASES[name]


@dataclass
class Config:
    """Flat parameter set (reference: include/LightGBM/config.h:41), trimmed
    to the fields the port reads."""

    # Core
    objective: str = "regression"
    boosting: str = "gbdt"
    num_leaves: int = 31
    device_type: str = "cuda"
    verbosity: int = 1

    # Dataset
    max_bin: int = 255
    max_bin_by_feature: Any = None
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    enable_bundle: bool = True
    use_missing: bool = True
    zero_as_missing: bool = False
    forcedbins_filename: str = ""

    # Objective
    num_class: int = 1
    sigmoid: float = 1.0
    reg_sqrt: bool = False
    boost_from_average: bool = True
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    # the regression family (objectives.py): huber's clip and quantile's
    # level, fair's c, poisson's hessian offset, tweedie's variance power
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    # ranking (ranking.py): the gain of each relevance label (None = 2**l -
    # 1), the pairs' truncation and normalisation, the position-bias
    # regularisation, and the seed of rank_xendcg's per-iteration draws
    objective_seed: int = 5
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    label_gain: Any = None
    lambdarank_position_bias_regularization: float = 0.0

    # Learning control
    num_iterations: int = 100
    learning_rate: float = 0.1
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0

    # DART (models/gbdt.DART): the share of the trees dropped an iteration
    # (each with that chance under uniform_drop, else that many drawn), at
    # most max_drop of them, none with chance skip_drop, the xgboost
    # normalisation, and the seed of the drop draws
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4

    # Leaf refit (refit.py, Booster.refit): a refitted leaf is decay times
    # its old value plus (1 - decay) times the new data's
    refit_decay_rate: float = 0.9

    # Checkpoints (robustness/checkpoint.py): one every snapshot_freq
    # iterations beside output_model, the snapshot_keep newest kept (-1:
    # all), and the snapshot a run resumes from
    snapshot_freq: int = -1
    snapshot_keep: int = -1
    resume_from: str = ""

    # Categorical splits (ops/split.py): a category bin takes part only
    # with min_data_per_group rows; features of at most max_cat_to_onehot
    # bins split one category against the rest, wider ones a subset of at
    # most max_cat_threshold categories sorted by grad / (hess +
    # cat_smooth), with cat_l2 added to lambda_l2
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4

    # Histogram formulation of the growth loop: auto (= stream) | stream |
    # scatter | pallas, auto | single | mixed, and the leaves split per
    # round (0 = auto = 64)
    hist_backend: str = "auto"
    hist_precision: str = "auto"
    max_splits_per_round: int = 0
    # multiclass: grow the K class trees of an iteration in lockstep, one
    # histogram pass per round for all classes (ops/grow.py grow_tree_k),
    # or one tree after another; the trees are the same either way
    multiclass_batched: bool = True

    # Row and feature sampling (models/sample_strategy.py): bagging
    # (fraction or pos/neg, every bagging_freq iterations) or GOSS (keep the
    # top_rate largest |grad * hess|, draw other_rate of the rest); the
    # sampled rows are compacted (row_compaction auto | pad | off) and a
    # compacted tree's per-round full-row routes fused into one replay
    # (route_fusion auto | on | off)
    data_sample_strategy: str = "bagging"
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    top_rate: float = 0.2
    other_rate: float = 0.1
    row_compaction: str = "auto"
    route_fusion: str = "auto"
    feature_fraction: float = 1.0
    feature_fraction_seed: int = 2
    # one bagging draw per query, its rows kept or dropped together
    bagging_by_query: bool = False

    # Evaluation and early stopping (metrics.py, callback.py, engine.py)
    metric: Any = ""
    metric_freq: int = 1
    early_stopping_round: int = 0
    early_stopping_min_delta: float = 0.0
    first_metric_only: bool = False
    multi_error_top_k: int = 1
    eval_at: Any = None  # the ranking metrics' cutoffs; None = [1, 2, 3, 4, 5]

    # Growth constraints (ops/grow.py, ops/split.py): monotone constraints
    # (the basic, intermediate and advanced methods) with their split
    # penalty, interaction constraints, path smoothing; per-node feature
    # sampling and random thresholds, drawn from a key seeded by extra_seed
    monotone_constraints: Any = None
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    interaction_constraints: Any = None
    path_smooth: float = 0.0
    feature_fraction_bynode: float = 1.0
    extra_trees: bool = False
    extra_seed: int = 6

    # Cost-effective gradient boosting: a split's gain less tradeoff times
    # a per-split cost, a coupled cost per feature the model does not use
    # yet, and a lazy cost per row of the leaf not yet charged for the
    # feature (ops/grow.py, ops/split.py)
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: Any = None
    cegb_penalty_feature_coupled: Any = None
    # forced splits: a JSON tree of (feature, threshold) splits that every
    # tree takes first (models/gbdt.GBDT._parse_forced_splits)
    forcedsplits_filename: str = ""
    # linear trees: a ridge fit of each leaf on its path's numerical
    # features (models/gbdt.GBDT._fit_linear_tree)
    linear_tree: bool = False
    linear_lambda: float = 0.0

    # Training features that are not ported yet: a value other than the
    # default raises (models/gbdt.GBDT._check_unsupported_params)
    tree_learner: str = "serial"
    auc_mu_weights: Any = None  # auc_mu's class-pair weights

    # Quantized-gradient training: gradients and hessians rounded onto a
    # grid of num_grad_quant_bins levels (stochastically or to nearest);
    # the stream backend sums their integer grid values into exact int32
    # histograms (K2's int form), the others the grid-valued floats;
    # quant_train_renew_leaf recomputes leaf values from the raw gradients
    use_quantized_grad: bool = False
    num_grad_quant_bins: int = 4
    quant_train_renew_leaf: bool = False
    stochastic_rounding: bool = True
    # bits per grad/hess field of the quantized histograms on a mesh wire
    # (32, 16 or 8); one device has no wire, so every width trains the same
    # model there
    hist_packed_width: int = 32

    # Non-finite gradient policy (robustness/guards.py): warn (log and skip
    # the poisoned iteration), skip (skip silently), raise, none (guard off)
    nan_guard: str = "warn"

    # The fused iteration (models/gbdt.py ``_iter_fused``): the grower's
    # state on the device, no host read inside a round, and each iteration
    # replayed as CUDA graphs (auto = on for a CUDA device under the stream
    # backend, off on the CPU; on | off force it); its flags (finished,
    # the guard's, the sampled count, compaction overflow) are read in one
    # batched poll every eval_fetch_freq iterations (0 = auto: 16 when
    # fused, 1 otherwise)
    fused_iter: str = "auto"
    eval_fetch_freq: int = 0

    def __post_init__(self) -> None:
        self._unknown: Dict[str, Any] = {}

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]]) -> "Config":
        cfg = cls()
        cfg.update(params or {})
        return cfg

    def update(self, params: Dict[str, Any]) -> None:
        resolved = resolve_aliases(params)
        fields = {f.name for f in dataclasses.fields(self)}
        for key, value in resolved.items():
            if (key in _VECTOR_FIELDS and isinstance(value, str)
                    and value.strip()):
                # conf-file vector syntax "1,3,5" (reference:
                # Config::GetIntVector / GetDoubleVector, config.h)
                elt = _VECTOR_FIELDS[key]
                value = [elt(tok) for tok in value.split(",") if tok.strip()]
            if key in fields:
                setattr(self, key, _coerce(getattr(self, key), value))
            else:
                self._unknown[key] = value
        self._check()

    def _check(self) -> None:
        """Parameter conflict resolution (reference: Config::CheckParamConflict,
        src/io/config.cpp)."""
        if self.num_leaves < 2:
            self.num_leaves = 2
        obj = canonical_objective(str(self.objective)) if isinstance(self.objective, str) else "none"
        if obj in ("multiclass", "multiclassova") and self.num_class < 2:
            raise ValueError("num_class must be >= 2 for multiclass objectives")
        if obj not in ("multiclass", "multiclassova") and self.num_class != 1:
            if obj != "none":
                raise ValueError("num_class must be 1 for non-multiclass objectives")
        if str(self.nan_guard).strip().lower() not in VALID_MODES:
            raise ValueError(
                f"nan_guard={self.nan_guard!r} is not one of "
                f"{', '.join(repr(m) for m in VALID_MODES)}")
        if str(self.device_type).strip().lower() not in ("cuda", "gpu", "cpu"):
            raise LightGBMError(
                f"device_type={self.device_type!r} is not one of 'cuda' "
                "('gpu' is an alias) or 'cpu'")
        for key in ("row_compaction", "route_fusion", "fused_iter"):
            allowed = (("auto", "off", "pad") if key == "row_compaction"
                       else ("auto", "on", "off"))
            if str(getattr(self, key)).strip().lower() not in allowed:
                raise LightGBMError(
                    f"{key}={getattr(self, key)!r} is not one of "
                    + ", ".join(repr(a) for a in allowed))
        if self.eval_fetch_freq < 0:
            raise LightGBMError(
                f"eval_fetch_freq={self.eval_fetch_freq} must be >= 0 "
                "(0 = auto)")
        # GOSS conflicts (reference: Config::CheckParamConflict,
        # src/io/config.cpp): the rates partition the data, and active
        # bagging cannot be combined with GOSS
        if (str(self.data_sample_strategy).strip().lower() == "goss"
                or str(self.boosting).strip().lower() == "goss"):
            if self.top_rate < 0.0 or self.other_rate < 0.0:
                raise LightGBMError(
                    f"GOSS rates must be non-negative, got top_rate="
                    f"{self.top_rate}, other_rate={self.other_rate}")
            if self.top_rate + self.other_rate > 1.0:
                raise LightGBMError(
                    f"top_rate + other_rate must be <= 1.0 for GOSS, got "
                    f"{self.top_rate} + {self.other_rate} = "
                    f"{self.top_rate + self.other_rate}")
            bagging_on = min(self.bagging_fraction, self.pos_bagging_fraction,
                             self.neg_bagging_fraction) < 1.0
            if self.bagging_freq > 0 and bagging_on:
                raise LightGBMError(
                    "GOSS (data_sample_strategy=goss) cannot be combined "
                    "with bagging; set bagging_freq=0 (reference: "
                    "Config::CheckParamConflict)")
        if self.boosting == "rf":
            if not (self.bagging_freq > 0
                    and 0.0 < self.bagging_fraction < 1.0):
                # rf requires bagging (reference: config.cpp
                # CheckParamConflict; lightgbm_tpu/config.py:1033-1038)
                self.bagging_freq = max(self.bagging_freq, 1)
                if not (0.0 < self.bagging_fraction < 1.0):
                    self.bagging_fraction = 0.9


# vector-valued params that conf files pass as comma-separated strings
_VECTOR_FIELDS: Dict[str, Any] = {
    "eval_at": int,
    "label_gain": float,
    "monotone_constraints": int,
    "cegb_penalty_feature_lazy": float,
    "cegb_penalty_feature_coupled": float,
    "max_bin_by_feature": int,
}


def _coerce(current: Any, value: Any) -> Any:
    """Coerce a user-supplied value to the type of the dataclass default."""
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes", "+")
        return bool(value)
    if isinstance(current, int) and not isinstance(value, bool):
        try:
            return int(value)
        except (TypeError, ValueError):
            return value
    if isinstance(current, float):
        try:
            return float(value)
        except (TypeError, ValueError):
            return value
    return value


def resolve_aliases(params: Dict[str, Any]) -> Dict[str, Any]:
    """Map aliased parameter names to canonical ones.

    Canonical name in the dict wins over aliases; among aliases the first in table
    order wins, with a warning on conflicts (reference: config.cpp:23-98
    KeyAliasTransform)."""
    out: Dict[str, Any] = {}
    alias_hits: Dict[str, List[str]] = {}
    for key, value in params.items():
        canon = _ALIAS_TO_CANONICAL.get(key, key)
        if canon != key:
            alias_hits.setdefault(canon, []).append(key)
        if canon in out:
            if key == canon:
                out[canon] = value  # canonical name wins
            else:
                log_warning(
                    f"{key} is set with {value}, {canon}={out[canon]} will be used. "
                    f"Current value: {canon}={out[canon]}")
        else:
            out[canon] = value
    # canonical name in original params always wins over any alias
    for canon, hits in alias_hits.items():
        if canon in params:
            out[canon] = params[canon]
    return out
