"""The boosting engine: training state, one boosting iteration, and the
trees it grows.

The port's counterpart of ``lightgbm_tpu/models/gbdt.py`` (reference:
src/boosting/gbdt.h GBDT), the single-device iteration of the reference
(eager: ``_train_one_iter_impl``, gbdt.py:2089-2403: one tree per
iteration, or one per class) with ``hist_backend`` ``stream`` (the
default), ``scatter`` or ``pallas``.  An iteration computes the
objective's gradients on the training score (or takes custom ones), samples
rows (bagging or GOSS, models/sample_strategy.py) and features
(``feature_fraction``), picks the compaction capacity of a sampled tree,
grows a tree on the device (ops/grow.py: K2, and K3 for a fused sampled
tree; K5, or K6/K7, for the other backends), adds its shrunk leaf values to the score through K4
(kernels/leaf_gather.py), adds them to each validation set's score with the
bin-space walk, and keeps the grown arrays on the device; ``models`` turns
every pending tree into a host ``Tree`` in one transfer.  The first tree
carries the boost-from-average init score as a folded bias, and trailing
single-leaf trees are trimmed as the reference trims them.
``load_init_model`` seeds the engine with an existing model and rebuilds the
training score with the bin-space tree walk (gbdt.py:2542), unless a
checkpoint's saved score replaces it (robustness/checkpoint.py).

A multiclass iteration (``multiclass`` and ``multiclassova``, K = num_class)
grows K class trees from the (N, K) gradients: in lockstep through
``grow_tree_k`` (``multiclass_batched``, the default, with plain growth) or
one ``grow_tree`` per class, the same trees either way, and adds all K to
the (N, K) score with one K4 launch over the flattened (K * L) leaf values.
Under bagging or GOSS the K trees grow on one compacted view of the in-bag
rows (reference: gbdt.py:1538-1578).

Growth constraints (reference: gbdt.py:1090-1140): ``monotone_constraints``
(the basic, intermediate and advanced methods; the last two split one leaf
a round, gbdt.py:840-855) with ``monotone_penalty``,
``interaction_constraints`` and ``path_smooth`` reach the grower as (F,)
signs, (C, F) feature groups and parameters; ``feature_fraction_bynode``
and ``extra_trees`` as parameters and a key for each class tree,
``prng_key((extra_seed or 3) * 1000003 + iter * (K + 1) + k)``
(gbdt.py:2246-2249), in a device buffer when fused.  Under any of them K
class trees grow one at a time, as in the reference (gbdt.py:1478), and a
single tree may fuse.

Quantized gradients (``use_quantized_grad``, reference: gbdt.py:56-77,
:2192-2208, :2517-2540): after sampling and pad masking, ``quantize_gh``
rounds each class's gradients and hessians onto a grid of
``num_grad_quant_bins`` levels (stochastically, from the reference's
``jax.random`` stream), and the tree grows on the grid values, under
``stream`` through K2's int form when the ``int_hist`` gate holds.
``quant_train_renew_leaf`` then sets each leaf's value from the raw
gradients' sums (exact fixed point; K class trees grow one at a time).

The fused iteration (``fused_iter``; reference: ``_iter_fused``,
gbdt.py:1727-1928): under the stream backend, without custom gradients or
leaf renewal, an iteration is a head (gradients, sampling, the guard,
quantization, compaction and the root pass), the tree's rounds and a tail
(the sprint, K3, K4), each step captured once as a CUDA graph and replayed
after (utils/graphs.py), over a ``TrainState`` and a device-state grower
(ops/grow.py ``_DeviceGrower``) whose tensors live at fixed addresses.  The
host reads one small vector per tree and polls the iteration's flags every
``eval_fetch_freq`` iterations; the trees equal the eager iteration's, bit
for bit.

``nan_guard`` (robustness/guards.py): non-finite init scores are zeroed,
an iteration with a non-finite gradient grows a no-op tree from zeroed
gradients and does not end training, and a model with non-finite leaves
does not seed one.

Leaf renewal (the objective's ``need_renew_leaf``: regression_l1,
quantile, mape; reference: ``_post_grow``, gbdt.py:2600-2613): after the
quantizer's renewal and before K4, each leaf of the grown tree is set to a
percentile of its in-bag rows' residuals on the score before the tree
(``_renew_leaves_percentile``, on the device).  Such an objective trains
eager, as the reference's fused gate keeps it (gbdt.py:1611-1612); of the
other objectives, regression, huber, fair, poisson, gamma, tweedie,
binary, cross_entropy, cross_entropy_lambda, lockstep multiclass and
multiclassova and lambdarank fuse under ``stream`` on the card, their
gradients in the head graph (every per-row array they read is moved to the
device at the head's first, uncaptured run); rank_xendcg draws on the host
and runs eager.

CEGB (reference: gbdt.py:341-347, :2259-2275): the engine keeps the
features the model splits on and the (N, F) bitset of rows charged for
each feature on the device for the whole run (``CegbState``); K class
trees grow one at a time, each seeing the previous class's updates, and
never fuse.  Forced splits (``forcedsplits_filename``, gbdt.py:1031-1086):
the JSON tree is parsed into static levels that every tree splits first;
a single forced tree fuses, its levels captured rounds of their own.
Linear trees (``linear_tree``, gbdt.py:2292-2300, :2435-2498): after each
class tree the host reads its arrays, leaf ids and raw gradients once and
fits each leaf's ridge on its path's numerical features in NumPy float64;
the training score takes the host delta and each validation set the
host walk of its raw rows.  Linear trees run eager.

DART and RF (reference: gbdt.py:2695-2847): ``DART`` drops earlier trees
from the training score before an iteration and rescales the new and the
dropped trees after it (host walks around a gbdt iteration, which may
fuse); ``RF`` takes every tree's gradients at the constant init score,
adds the trees unshrunk and averages them, and runs eager.

Training covers gbdt, dart and rf on numeric and categorical features with
every objective of the reference (or custom gradients), ranking with
``bagging_by_query``, the growth constraints, by-node sampling, extra
trees, CEGB, forced splits and linear trees; what is still refused
(``_check_unsupported_params``: another tree learner, ``auc_mu_weights``,
the segsum and onehot backends) raises "not yet ported" instead of
training a different model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..binning import BIN_CATEGORICAL
from ..config import Config
from ..device_data import DeviceData
from ..kernels.leaf_gather import leaf_gather
from ..kernels.predict import tree_max_depth
from ..metrics import Metric
from ..objectives import ObjectiveFunction
from ..ops.grow import (CegbState, GrowParams, _DeviceGrower,
                        fusion_applies, grow_device, grow_tree, grow_tree_k,
                        loop_plan, sprint_and_replay)
from ..ops.histogram import dequantize, hist_shift, quantize
from ..ops.predict import _walk_one_tree
from ..ops.split import CatParams, leaf_output
from ..robustness.guards import NanGuard, check_finite_init, check_model_trees
from ..tree import (DIR_CATEGORICAL, DIR_DEFAULT_LEFT, Tree, TreeArrays,
                    finalize_tree)
from ..utils.graphs import GraphRunner
from ..utils.log import LightGBMError, log_warning
from ..utils.random import prng_key, split, uniform
from ..utils.timer import host_int, host_list, phase
from .sample_strategy import SampleStrategy, create_sample_strategy

# row quantum of a compacted view: the port's kernels take any row count,
# and 256 is the Dataset's own row padding
_COMPACT_UNIT = 256

# accepted hist_backend values (reference: gbdt.py:44); segsum and onehot
# are not ported
HIST_BACKENDS = ("auto", "segsum", "onehot", "pallas", "stream", "scatter")


def _nonempty(v) -> bool:
    """A vector parameter that holds a value (reference: gbdt.py:1181)."""
    return v is not None and len(np.atleast_1d(v)) > 0


def _not_ported(what: str) -> LightGBMError:
    return LightGBMError(f"{what} is not yet ported to lightgbm_torch "
                         "training")


def quantize_gh(grad, hess, key, num_bins: int, stochastic: bool):
    """Gradient and hessian discretization onto a symmetric integer grid of
    ``num_bins`` levels (reference: lightgbm_tpu/models/gbdt.py:56-77,
    src/treelearner/gradient_discretizer.cpp).  grad, hess: (N,) or (N, K)
    float32; key: a ``utils.random`` key, split into the grad and hess
    streams.  Returns the grid-valued grad and hess (``q * scale``, q an
    integer in [-half, half], hessians in [0, half]) and the stacked (grad,
    hess) scales, (2,) or (2, K)."""
    half = max(num_bins, 2) / 2.0
    kg, kh = split(key)

    def q(x, maxv, kq, lo):
        scale = torch.clamp(maxv, min=1e-10) / half
        u = uniform(kq, tuple(x.shape), x.device) if stochastic else 0.5
        qi = torch.clamp(torch.floor(x / scale + u), lo, half)
        return qi * scale, scale

    gq, gs = q(grad, grad.abs().amax(dim=0), kg, -half)
    hq, hs = q(hess, hess.amax(dim=0), kh, 0.0)
    return gq, hq, torch.stack([gs, hs])


@dataclass
class TrainState:
    """The fused iteration's state on the device, the single-device
    counterpart of ``lightgbm_tpu/parallel/sharded_state.py:26-60``
    ``ShardedTrainState`` (no sharding).  Every tensor is allocated once and
    written in place by the iteration's graphs; the host reads the flags
    only at the poll (``GBDT._poll_device_flags``)."""
    score: torch.Tensor      # (N,) or (N, K) training score
    grad: torch.Tensor       # the last iteration's sampled gradients
    hess: torch.Tensor
    leaf_id: torch.Tensor    # (K, N) int32 every row's leaf in each tree
    mask: torch.Tensor       # (N,) float32 in-bag count weights
    sampled: torch.Tensor    # () int64 in-bag rows of the last iteration
    overflow: torch.Tensor   # () int64 iterations whose in-bag rows
                             # outgrew the compaction capacity
    finished: torch.Tensor   # () bool the last iteration made no split
                             # (and its gradients were finite)
    ok: torch.Tensor         # () bool its gradients were finite


@dataclass
class FusedInputs:
    """What changes from one fused iteration to the next, in device buffers
    the host fills before the replays (a Python value would be baked into a
    graph at capture): the bagging epoch's mask, the quantizer's, GOSS's
    and the grower's key words (``prng_key``: (0, seed & 0xFFFFFFFF)), the
    learning rate and the feature sample."""
    mask: torch.Tensor       # (N,) float32
    qkey: torch.Tensor       # (2,) int64
    skey: torch.Tensor       # (2,) int64
    gkey: torch.Tensor       # (2,) int64 the per-node draws' key
    rate: torch.Tensor       # () float32
    col_mask: Optional[torch.Tensor]   # (F,) bool, or None


# the fields of a grown tree packed into one int32 buffer (float32 fields
# by their bits), then each class's leaf count; the categorical bitsets
# travel apart
_PACKED_FIELDS = [f for f in TreeArrays._fields
                  if f not in ("num_leaves", "cat_bitset")]


class GBDT:
    """The main booster (reference: src/boosting/gbdt.h GBDT class)."""

    boosting_type = "gbdt"
    _average_output = False

    def __init__(self, config: Config, train_data,
                 objective: Optional[ObjectiveFunction],
                 metrics: Sequence[Metric] = ()):
        self.config = config
        self.train_data = train_data          # basic.Dataset (constructed)
        self.objective = objective
        self.train_metrics = list(metrics)
        self.valid_sets: List = []
        self.valid_names: List[str] = []
        self.valid_metrics: List[List[Metric]] = []
        self.valid_scores: List[torch.Tensor] = []
        self._models_list: List[Tree] = []    # host trees, iteration-major
        self._lazy_trees: List[dict] = []     # grown, not yet on the host
        self.iter_ = 0
        self.num_class = config.num_class
        self.num_tree_per_iteration = (objective.num_model_per_iteration
                                       if objective is not None
                                       else config.num_class)
        self.dd: DeviceData = train_data.device_data()
        self.device = self.dd.device
        self.num_data = train_data.num_data()
        k = self.num_tree_per_iteration
        n_pad = self.dd.bins.shape[0]
        self._score_shape = (n_pad,) if k == 1 else (n_pad, k)
        self.init_scores = self._compute_init_score()
        self.score = torch.zeros(self._score_shape, dtype=torch.float32,
                                 device=self.device) + torch.tensor(
            self.init_scores if k > 1 else self.init_scores[0],
            dtype=torch.float32, device=self.device)
        base = train_data.get_init_score_padded(n_pad, k)
        if base is not None:
            # one non-finite init score would poison every gradient of
            # every iteration: the gradient guard's policy applies
            base = check_finite_init(base, "init_score", config.nan_guard)
            self.score = self.score + torch.as_tensor(base, device=self.device)
        # row-pad mask: padded rows add nothing to any histogram
        self._pad_mask = (torch.arange(n_pad, device=self.device)
                          < self.num_data).to(torch.float32)
        self._bins_T: Optional[torch.Tensor] = None
        self.grow_params: Optional[GrowParams] = None
        self.sample_strategy: Optional[SampleStrategy] = None
        # feature_fraction draws, one per iteration (reference: gbdt.py:418)
        self._rng = np.random.RandomState(config.feature_fraction_seed)
        # row compaction: the in-bag count of the last distinct mask, the
        # sticky capacity, and the capacity and in-bag rows of the last tree
        self._sample_count_cache: Optional[Tuple[int, int]] = None
        self._compact_cap = 0
        self.last_compact_rows = 0
        self.last_sampled_rows: Optional[int] = None
        # non-finite gradient guard: a tripped check zeroes the
        # iteration's gradients, so it grows an exact no-op tree
        self._nan_guard = NanGuard(config.nan_guard,
                                   objective.name if objective else "none")
        # a utils.timer.PhaseTimer here times the phases of each iteration
        self.timer = None
        # the fused iteration: its state, inputs, graphs, a device-state
        # grower per compaction capacity, the loop rounds of recent trees
        # (each tree's plan), the guard's unread flags, and GOSS's
        # compaction overflow
        self._fused: Optional[bool] = None
        self._train_state: Optional[TrainState] = None
        self._fused_in: Optional[FusedInputs] = None
        self._graphs = GraphRunner(self.device)
        self._fused_growers = {}
        self._loop_rounds: List[int] = []
        self._tree_out = self._bits_out = None
        self._pending_ok: List[Tuple[int, torch.Tensor]] = []
        self._compact_overflow = False
        self._overflow_seen = 0
        self._finished_check_every = 1
        self._finished_last = False

    def _compute_init_score(self) -> List[float]:
        k = self.num_tree_per_iteration
        if self.objective is None or not self.config.boost_from_average:
            return [0.0] * k
        return [float(self.objective.boost_from_score())] * k

    def _shrinkage_rate(self) -> float:
        """The factor a new tree's leaf values take (reference:
        gbdt.py:2431)."""
        return self.config.learning_rate

    def _gradient_score(self) -> torch.Tensor:
        """The padded score the objective's gradients are taken at
        (reference: ``_boost``, gbdt.py:1352)."""
        return self.score

    # ------------------------------------------------------------------
    @property
    def models(self) -> List[Tree]:
        """Host trees; moves every pending grown tree to the host first."""
        self._flush_models()
        return self._models_list

    @models.setter
    def models(self, value) -> None:
        self._lazy_trees = []
        self._models_list = list(value)

    def _flush_models(self) -> None:
        """All pending trees to the host in one transfer, then finalized
        (bin thresholds to real thresholds, shrinkage, the folded bias)."""
        if not self._lazy_trees:
            return
        pending, self._lazy_trees = self._lazy_trees, []
        with phase(self.timer, "finalize"):
            host = _arrays_to_host([e["arrays"] for e in pending])
            mappers = self.train_data.bin_mappers()
            for e, arrays in zip(pending, host):
                tree = finalize_tree(arrays, mappers, learning_rate=e["rate"])
                if e["bias"]:
                    tree.add_bias(e["bias"])
                self._models_list.append(tree)

    # ------------------------------------------------------------------
    def _check_unsupported_params(self) -> None:
        """Refuse what this slice does not train, instead of training a
        different model (reference: gbdt.py:1141)."""
        c = self.config
        # the reference's own validation first (gbdt.py:1150-1159)
        if c.hist_precision not in ("auto", "single", "mixed", "double"):
            raise LightGBMError(
                f"hist_precision={c.hist_precision!r} is not one of "
                "'auto', 'single', 'mixed', 'double'")
        if c.hist_backend not in HIST_BACKENDS:
            raise LightGBMError(
                f"unknown hist_backend={c.hist_backend!r}; one of "
                f"{HIST_BACKENDS}")
        if c.hist_backend == "scatter" and c.tree_learner == "feature":
            raise LightGBMError(
                "hist_backend=scatter is not supported with "
                "tree_learner=feature (the scatter tile is one unsharded "
                "VMEM block; group sharding cannot slice it) — use "
                "hist_backend=segsum or onehot")
        if c.hist_packed_width not in (32, 16, 8):
            raise LightGBMError(
                f"hist_packed_width={c.hist_packed_width!r} is not one of "
                "32, 16, 8")
        if c.hist_packed_width != 32:
            if not c.use_quantized_grad:
                raise LightGBMError(
                    "hist_packed_width=16/8 packs the QUANTIZED int32 "
                    "grad/hess wire and needs use_quantized_grad=True "
                    "(the f32 histograms have no integer wire to pack)")
            if c.linear_tree:
                raise LightGBMError(
                    "hist_packed_width=16/8 is not supported with "
                    "linear_tree (leaf regressions feed on exact "
                    "histogram sums; the requantized wire is "
                    "documented-ulp, not exact)")
        if c.hist_backend in ("segsum", "onehot"):
            raise _not_ported(f"hist_backend={c.hist_backend!r}")
        if c.hist_precision == "double":
            # reference: gbdt.py:801-805; segsum and onehot, which take
            # it there, are not ported
            raise LightGBMError(
                "hist_precision=double requires hist_backend=segsum or "
                "onehot (the TPU stream/pallas/scatter kernels are "
                "f32/int8)")
        if c.tree_learner != "serial":
            raise _not_ported(f"tree_learner={c.tree_learner!r}")
        # the CEGB vectors and linear_tree (reference: gbdt.py:1184-1203;
        # its boosting check is in create_boosting)
        for key in ("cegb_penalty_feature_lazy",
                    "cegb_penalty_feature_coupled"):
            v = getattr(c, key)
            if _nonempty(v) and \
                    len(np.atleast_1d(v)) != self.dd.num_features:
                raise LightGBMError(f"{key} should be the same size as the "
                                    "feature count")
        if c.linear_tree and self.train_data.raw_data is None:
            raise LightGBMError(
                "linear_tree needs the raw feature matrix; construct the "
                "Dataset with free_raw_data=False")
        w = c.auc_mu_weights
        if w is not None and (w.strip() if isinstance(w, str)
                              else np.size(w)):
            raise _not_ported("auc_mu_weights")

    def _resolve_hist_backend(self) -> str:
        """The histogram backend (the single-device part of reference
        gbdt.py:740-785).  ``auto`` is ``stream``: the reference leaves
        stream for ``pallas`` only where the stream kernel's histogram block
        outgrows the TPU's VMEM (``_stream_fits``), a limit K2 on the card
        does not have."""
        b = self.config.hist_backend
        return "stream" if b == "auto" else b

    def _monotone_array(self) -> Optional[torch.Tensor]:
        """(F,) int64 in {-1, 0, 1} on the device, or None (reference:
        gbdt.py:1090-1111; monotone_constraints.hpp basic method)."""
        mc = self.config.monotone_constraints
        if mc is None or (hasattr(mc, "__len__") and len(mc) == 0):
            return None
        arr = np.asarray(mc, np.int32)
        F = self.dd.num_features
        if arr.shape[0] != F:
            raise LightGBMError(
                f"monotone_constraints has {arr.shape[0]} entries but the "
                f"dataset has {F} features")
        if not np.any(arr):
            return None
        if self.config.monotone_constraints_method not in (
                "basic", "intermediate", "advanced"):
            log_warning(
                f"monotone_constraints_method="
                f"{self.config.monotone_constraints_method!r} is not "
                "implemented; falling back to 'basic'")
        return torch.as_tensor(arr.astype(np.int64), device=self.device)

    def _interaction_group_masks(self) -> Optional[torch.Tensor]:
        """(C, F) bool allowed-feature groups on the device, or None
        (reference: gbdt.py:1117-1140; col_sampler.hpp; config.cpp
        ParseInteractionConstraints)."""
        ic = self.config.interaction_constraints
        if not ic:
            return None
        if isinstance(ic, str):
            import json
            s = ic.strip()
            if not s.startswith("[["):
                s = "[" + s + "]"    # "[0,1],[2,3]" -> "[[0,1],[2,3]]"
            ic = json.loads(s)
        if ic and not isinstance(ic[0], (list, tuple)):
            ic = [ic]
        F = self.dd.num_features
        masks = np.zeros((len(ic), F), bool)
        for i, group in enumerate(ic):
            for f in group:
                if not 0 <= int(f) < F:
                    raise LightGBMError(
                        f"interaction_constraints feature index {f} out of "
                        "range")
                masks[i, int(f)] = True
        return torch.as_tensor(masks, device=self.device)

    def _use_batched_multiclass(self) -> bool:
        """K class trees in lockstep (reference: gbdt.py:1460-1499, :2205):
        ``multiclass_batched``, plain growth, no forced splits and no
        linear trees; under a growth constraint, a per-node draw, CEGB,
        forced splits or linear trees they grow one at a time."""
        gp = self.grow_params
        return (self.config.multiclass_batched and gp.plain_growth
                and not gp.forced and not self.config.linear_tree)

    def _cegb_vector(self, key: str) -> Optional[torch.Tensor]:
        """A CEGB cost vector as (F,) float32 on the device, or None
        (reference: gbdt.py:1018-1029)."""
        v = getattr(self.config, key)
        if not _nonempty(v):
            return None
        return torch.as_tensor(np.asarray(np.atleast_1d(v), np.float32),
                               device=self.device)

    def _parse_forced_splits(self) -> tuple:
        """The ``forcedsplits_filename`` JSON as static levels, each a
        (leaves, features, threshold bins, default lefts) tuple of tuples,
        () for none (reference: gbdt.py:1031-1086; numeric splits only, the
        threshold's bin by ``searchsorted(upper_bounds, threshold,
        side="left")``)."""
        fn = self.config.forcedsplits_filename
        if not fn:
            return ()
        import json
        try:
            with open(fn) as fh:
                spec = json.load(fh)
        except FileNotFoundError:
            raise LightGBMError(f"forcedsplits_filename {fn!r} not found")
        except json.JSONDecodeError as e:
            raise LightGBMError(
                f"forcedsplits_filename {fn!r} is not valid JSON: {e}")
        if not spec:
            return ()
        mappers = self.train_data.bin_mappers()
        L = max(self.config.num_leaves, 2)
        levels = []
        frontier = [(spec, 0)]
        cur_count = 1
        while frontier:
            start = cur_count
            leaves, feats, thrs, dls = [], [], [], []
            nxt = []
            for idx, (node, leaf) in enumerate(frontier):
                f = int(node["feature"])
                if not 0 <= f < len(mappers):
                    raise LightGBMError(
                        f"forced split feature {f} out of range")
                if mappers[f].bin_type == BIN_CATEGORICAL:
                    raise LightGBMError(
                        "categorical forced splits are not supported")
                tb = int(np.searchsorted(mappers[f].upper_bounds,
                                         float(node["threshold"]),
                                         side="left"))
                leaves.append(int(leaf))
                feats.append(f)
                thrs.append(tb)
                dls.append(bool(node.get("default_left", False)))
                if node.get("left"):
                    nxt.append((node["left"], leaf))
                if node.get("right"):
                    nxt.append((node["right"], start + idx))
            cur_count = start + len(frontier)
            if cur_count > L:
                raise LightGBMError(
                    f"forced splits need {cur_count} leaves but num_leaves="
                    f"{L}")
            levels.append((tuple(leaves), tuple(feats), tuple(thrs),
                           tuple(dls)))
            frontier = nxt
        return tuple(levels)

    def _make_grow_params(self) -> GrowParams:
        c = self.config
        has_mono = self._monotone_array() is not None
        method = c.monotone_constraints_method
        cat_bins = [int(m.num_bins) for m in self.train_data.bin_mappers()
                    if m.bin_type == BIN_CATEGORICAL]
        imono = has_mono and method in ("intermediate", "advanced")
        return GrowParams(
            num_leaves=max(c.num_leaves, 2), max_depth=c.max_depth,
            # auto (0) is 64, as the reference resolves it for its stream
            # backend on every device; the intermediate and advanced
            # monotone methods split one leaf a round (reference:
            # gbdt.py:840-855), since each split tightens other leaves'
            # bounds before the next is chosen
            max_splits_per_round=(1 if imono else c.max_splits_per_round
                                  if c.max_splits_per_round > 0 else 64),
            lambda_l1=c.lambda_l1, lambda_l2=c.lambda_l2,
            min_data_in_leaf=c.min_data_in_leaf,
            min_sum_hessian_in_leaf=c.min_sum_hessian_in_leaf,
            min_gain_to_split=c.min_gain_to_split,
            max_delta_step=c.max_delta_step,
            cat=(CatParams(c.cat_l2, c.cat_smooth, c.max_cat_threshold,
                           c.max_cat_to_onehot, c.min_data_per_group)
                 if cat_bins else None),
            cat_bins=max(cat_bins, default=0),
            has_monotone=has_mono,
            monotone_penalty=c.monotone_penalty,
            # the reference's gate (gbdt.py:941-944, :1112-1115): advanced
            # implies intermediate
            monotone_intermediate=imono,
            monotone_advanced=has_mono and method == "advanced",
            path_smooth=c.path_smooth,
            has_interaction=self._interaction_group_masks() is not None,
            extra_trees=c.extra_trees,
            bynode_fraction=c.feature_fraction_bynode,
            # the reference's gate (gbdt.py:957-965): a split cost, or a
            # cost vector given
            has_cegb=(c.cegb_penalty_split > 0.0
                      or _nonempty(c.cegb_penalty_feature_coupled)
                      or _nonempty(c.cegb_penalty_feature_lazy)),
            cegb_tradeoff=c.cegb_tradeoff,
            cegb_penalty_split=c.cegb_penalty_split,
            forced=self._parse_forced_splits(),
            # auto resolves on: the replay gives the same leaves as the
            # per-round route-only passes, and the grower applies the
            # reference's gate
            route_fusion=str(c.route_fusion).lower() in ("auto", "on"),
            hist_backend=self._resolve_hist_backend(),
            # the reference's gate, letter for letter (gbdt.py:950-955):
            # int8 operands, exact int32 sums, and an even level count (an
            # odd one clips to a non-integer +half grid value); N is the
            # padded row count, a multiple of 256 (the reference pads to
            # its own block size, so the two can differ above ~16.9M rows
            # at 254 levels)
            int_hist=(c.use_quantized_grad
                      and self._resolve_hist_backend() == "stream"
                      and c.num_grad_quant_bins <= 254
                      and c.num_grad_quant_bins % 2 == 0
                      and (c.num_grad_quant_bins / 2)
                      * self.dd.bins.shape[0] < 2 ** 31))

    def _ensure_training(self) -> None:
        if self.grow_params is None:
            self._check_unsupported_params()
            n_pad = self._score_shape[0]
            label = self.train_data.get_label()
            label_pad = None
            if label is not None:
                label_pad = np.zeros(n_pad, np.float64)
                label_pad[:len(label)] = label
            self.sample_strategy = create_sample_strategy(
                self.config, n_pad, label_pad, self.device,
                self.train_data.get_query_boundaries())
            self._set_constraints()
            self.grow_params = self._make_grow_params()
            # K2, K5 and K8 read the (G, N) layout K1 reads, K6/K7 the
            # (N, G) rows of DeviceData.bins
            self._bins_T = self.dd.bins.t().contiguous()
            self._set_fused_gate()

    def reset_config(self, params: Dict[str, Any]) -> None:
        """New parameters from the next iteration on (reference:
        GBDT::ResetConfig; lightgbm_tpu/basic.py:1917-1934): the config is
        updated and checked again, as at the first iteration.  Where a
        field other than ``learning_rate`` changed, the grow parameters are
        rebuilt and every captured CUDA graph and every device-state grower
        is dropped: the steps read tree-shape parameters (num_leaves,
        min_data_in_leaf, lambda_l2, min_gain_to_split, the split budget)
        as Python numbers, which a replay would keep.  The next fused
        iteration then runs each step eagerly and captures it again.
        ``learning_rate`` reaches the fused tail through its input buffer,
        filled every iteration, so a rate schedule keeps the graphs."""
        before = _config_values(self.config)
        self.config.update(params)
        self._check_unsupported_params()
        changed = {k for k, v in _config_values(self.config).items()
                   if v != before[k]}
        if self.grow_params is None or changed <= {"learning_rate"}:
            # no iteration yet (_ensure_training builds what follows), or
            # only the rate, which no step holds
            return
        self._set_constraints()
        self.grow_params = self._make_grow_params()
        self._set_fused_gate()
        self._graphs = GraphRunner(self.device)
        self._fused_growers = {}
        self._loop_rounds = []
        self._tree_out = self._bits_out = None

    def _set_constraints(self) -> None:
        """The growth constraints' device tensors and CEGB's run state,
        from the config.  CEGB's used features and charged rows persist
        over the run (reference: gbdt.py:341-347): a reset keeps them
        while CEGB stays on, starts them empty when it turns on, and drops
        them when it turns off."""
        self._monotone = self._monotone_array()
        self._groups = self._interaction_group_masks()
        c = self.config
        old = getattr(self, "_cegb", None)
        if not (c.cegb_penalty_split > 0.0
                or _nonempty(c.cegb_penalty_feature_coupled)
                or _nonempty(c.cegb_penalty_feature_lazy)):
            self._cegb = None
            return
        F = self.dd.num_features
        used = (old.used if old is not None
                else torch.zeros(F, dtype=torch.bool, device=self.device))
        lazy_pen = self._cegb_vector("cegb_penalty_feature_lazy")
        lazy = None
        if lazy_pen is not None:
            lazy = (old.lazy if old is not None and old.lazy is not None
                    else torch.zeros((self._score_shape[0], F),
                                     dtype=torch.bool, device=self.device))
        self._cegb = CegbState(used, self._cegb_vector(
            "cegb_penalty_feature_coupled"), lazy_pen, lazy)

    def _set_fused_gate(self) -> None:
        """Whether iterations fuse, and the batched flag poll's cadence
        (reference: gbdt.py:398-410)."""
        self._fused = self._can_fuse_iteration()
        eff = int(self.config.eval_fetch_freq or 0)
        self._finished_check_every = (eff if eff > 0
                                      else 16 if self._fused else 1)

    def _can_fuse_iteration(self) -> bool:
        """The fused iteration's gate (reference: gbdt.py:1583-1625):
        objectives whose gradients trace, no leaf renewal (the objective's
        or the quantizer's), multiclass only in lockstep; custom gradients
        run eager at each update (``train_one_iter``).  Lambdarank fuses,
        with position biases too (they are updated in place in the head
        graph); rank_xendcg draws on the host each iteration
        (``jit_safe_gradients`` False) and runs eager.  The port fuses only
        the stream backend: the scatter and pallas rounds size their slot
        maps and block plans from the data.  ``auto`` fuses on a CUDA
        device and not on the CPU, as the reference's auto fuses on its
        accelerator; ``on`` on the CPU runs the same device-state grower
        without graphs.  Growth constraints fuse for one class tree (as in
        the reference); K constrained class trees grow one at a time and
        run eager."""
        c = self.config
        mode = str(c.fused_iter).strip().lower()
        if mode == "off":
            return False
        obj = self.objective
        # linear trees and CEGB run eager even under "on", as in the
        # reference (gbdt.py:1603-1605)
        if (c.linear_tree or self.grow_params.has_cegb
                or obj is None or not getattr(obj, "jit_safe_gradients", True)
                or getattr(obj, "need_renew_leaf", False)
                or (c.use_quantized_grad and c.quant_train_renew_leaf)
                or (self.num_tree_per_iteration > 1
                    and not self._use_batched_multiclass())):
            return False
        backend = self.grow_params.hist_backend
        if backend != "stream":
            if mode == "on":
                raise _not_ported(f"fused_iter=on with hist_backend="
                                  f"{backend!r}")
            return False
        return mode == "on" or self.device.type == "cuda"

    def _feature_mask(self) -> Optional[torch.Tensor]:
        """This tree's feature sample (reference: gbdt.py:1287-1296), one
        draw of the engine's RandomState per iteration; None without
        feature_fraction."""
        mask = self._feature_mask_host()
        return None if mask is None else torch.as_tensor(mask,
                                                         device=self.device)

    def _feature_mask_host(self) -> Optional[np.ndarray]:
        f = self.dd.num_features
        frac = self.config.feature_fraction
        if frac >= 1.0:
            return None
        kcnt = max(1, int(round(frac * f)))
        keep = self._rng.choice(f, size=kcnt, replace=False)
        mask = np.zeros(f, bool)
        mask[keep] = True
        return mask

    def _row_compaction_capacity(self, mask: torch.Tensor) -> int:
        """Row capacity of this iteration's compacted view, 0 for none
        (reference: gbdt.py:498-590).  The in-bag count is read once per
        distinct mask (``mask_key``; K class trees share the mask) and
        rounded up to a ~3 % quantum of 256-row units; compaction stays
        off when it would save under 25 % of the rows.  ``pad`` partitions
        at the full row count.  The capacity is sticky while it still
        covers the count, as in the
        reference (whose jitted grower recompiles at each new capacity);
        out-of-bag rows in the view weigh zero, so the capacity never
        changes the tree.  Only ``stream`` and ``scatter`` compact
        (reference: gbdt.py:525-529): a sampled ``pallas`` tree grows on
        masked weights over all rows."""
        if not self.sample_strategy.is_active():
            return 0
        mode = str(self.config.row_compaction).strip().lower()
        if mode == "off" or self.grow_params.hist_backend == "pallas":
            return 0
        ck = self.sample_strategy.mask_key(self.iter_)
        if self._sample_count_cache is not None \
                and self._sample_count_cache[0] == ck:
            nc = self._sample_count_cache[1]
        else:
            with phase(self.timer, "host_sync"):
                nc = host_int((mask > 0).sum(), self.timer)
            self._sample_count_cache = (ck, nc)
        self.last_sampled_rows = nc
        local = self._score_shape[0]
        unit = _COMPACT_UNIT
        q = max(unit, -(-local // (32 * unit)) * unit)
        cap_min = max(unit, -(-nc // q) * q)
        if nc * 4 >= local * 3 or cap_min >= local:
            return 0
        if mode == "pad":
            return -(-local // unit) * unit
        if cap_min <= self._compact_cap < local:
            return self._compact_cap
        cap = cap_min + q if cap_min + q < local else cap_min
        self._compact_cap = cap
        return cap

    def _fused_compact_rows(self, sample_mode: str) -> int:
        """The compaction capacity of a fused iteration (reference:
        gbdt.py:1664-1725).  Bagging keeps the eager rule and its in-bag
        count read, one per epoch (``mask_key``).  A GOSS mask is drawn
        inside the graph, so its capacity is analytic: the expected in-bag
        share plus 25 % and six binomial sigmas, rounded up to the eager
        quantum, sticky while it covers; an in-bag count past it is counted
        in ``TrainState.overflow``, and the poll then warns and turns
        compaction off for the rest of the run."""
        if sample_mode == "none" or self._compact_overflow:
            return 0
        if sample_mode == "mask_arg":
            return self._row_compaction_capacity(self._fused_in.mask
                                                 * self._pad_mask)
        mode = str(self.config.row_compaction).strip().lower()
        if mode == "off":
            return 0
        local = self._score_shape[0]
        unit = _COMPACT_UNIT
        if mode == "pad":
            return -(-local // unit) * unit
        frac = self.sample_strategy.expected_fraction(self.iter_)
        sigma = float(np.sqrt(max(local * frac * (1.0 - frac), 1.0)))
        q = max(unit, -(-local // (32 * unit)) * unit)
        cap = max(unit, -(-int(1.25 * frac * local + 6.0 * sigma) // q) * q)
        if cap * 4 >= local * 3 or cap >= local:
            return 0
        if not (self._compact_cap and cap <= self._compact_cap < local):
            self._compact_cap = cap
        return self._compact_cap

    def route_only_passes_per_tree(self) -> int:
        """Full-row route-only passes the last tree cost (reference:
        gbdt.py:705-728): none unless it was compacted; one replay when
        fused; else the reference's estimate of one per round."""
        gp = self.grow_params
        if (gp is None or self.last_compact_rows <= 0
                or gp.hist_backend != "stream"):
            # the other backends route every row with torch ops
            return 0
        if fusion_applies(gp, self.last_compact_rows,
                          self.num_tree_per_iteration):
            return 1
        L = gp.num_leaves
        S = min(gp.max_splits_per_round, max(L - 1, 1))
        return -(-(L - 1) // max(S, 1)) + 1

    def _pad(self, a: torch.Tensor) -> torch.Tensor:
        n = self._score_shape[0]
        if a.shape[0] == n:
            return a
        return torch.cat([a, torch.zeros((n - a.shape[0],) + a.shape[1:],
                                         dtype=a.dtype, device=a.device)])

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration (reference: GBDT::TrainOneIter,
        gbdt.cpp:353).  ``grad``/``hess`` are custom gradients of the
        unpadded rows, (N, K) for K trees per iteration.  Returns True when
        no tree made a split: training cannot go on, and the trailing no-op
        trees are dropped.  The flag is read every ``eval_fetch_freq``
        iterations; without custom gradients, the gate
        (``_can_fuse_iteration``) sends the iteration down the fused path
        (``_iter_fused``)."""
        self._ensure_training()
        if grad is None and hess is None and self._fused:
            return self._iter_fused()
        dev = self.device
        k = self.num_tree_per_iteration
        with phase(self.timer, "gradients"):
            if grad is None or hess is None:
                if self.objective is None:
                    raise LightGBMError("cannot boost without an objective "
                                        "(use custom-gradient update)")
                grad, hess = self.objective.get_gradients(
                    self._gradient_score()[:self.num_data])
            else:
                grad = torch.as_tensor(np.asarray(grad, np.float32)).to(dev)
                hess = torch.as_tensor(np.asarray(hess, np.float32)).to(dev)
                want = (self.num_data,) if k == 1 else (self.num_data, k)
                if tuple(grad.shape) != want or tuple(hess.shape) != want:
                    raise LightGBMError(
                        f"custom gradients must have shape {want}, got "
                        f"{tuple(grad.shape)} and {tuple(hess.shape)}")
        with phase(self.timer, "sample"):
            # reference order: sample the padded gradients, then mask the
            # pad rows (gbdt.py:2165-2177)
            mask, grad, hess = self.sample_strategy.sample(
                self.iter_, self._pad(grad), self._pad(hess))
            col_mask = self._feature_mask()
        c = self.config
        with phase(self.timer, "gradients"):
            mask, grad, hess, ok, gh_scales, grad_raw, hess_raw = \
                self._guard_and_quantize(mask, grad, hess,
                                         prng_key(self._quant_seed()))
            if ok is not None and self._nan_guard.mode == "raise" \
                    and not bool(ok):
                self._nan_guard.record(self.iter_)
        renew = c.use_quantized_grad and c.quant_train_renew_leaf
        compact = self._row_compaction_capacity(mask)
        self.last_compact_rows = compact
        rate = self._shrinkage_rate()
        if k == 1:
            res = grow_tree(self._bins_T, grad, hess, mask, self.dd.layout,
                            self.dd.routing, self.grow_params,
                            self.dd.max_bins, timer=self.timer,
                            col_mask=col_mask, compact_rows=compact,
                            bins=self.dd.bins, gh_scales=gh_scales,
                            monotone=self._monotone,
                            interaction_groups=self._groups,
                            key=self._grow_key(), cegb=self._cegb)
            self._cegb_note(res.arrays)
            if renew:
                res = res._replace(arrays=self._renew_leaves_exact(
                    res.arrays, res.leaf_id, grad_raw, hess_raw))
            if self.objective is not None and self.objective.need_renew_leaf:
                with phase(self.timer, "renew"):
                    res = res._replace(arrays=self._renew_leaves_percentile(
                        res.arrays, res.leaf_id, mask))
            trees = [(res.arrays, res.rounds)]
            if c.linear_tree:
                linear = [self._linear_step(res.arrays, res.leaf_id,
                                            grad_raw, hess_raw, 0)]
            else:
                with phase(self.timer, "k4"):
                    # score update (reference: ScoreUpdater::AddScore); a
                    # single-leaf tree has leaf value 0
                    delta = leaf_gather(res.leaf_id,
                                        res.arrays.leaf_value * rate)
                    self.score = self.score + delta
        else:
            trees, leaf_k, values = self._grow_classes(
                grad, hess, mask, col_mask, compact, gh_scales,
                (grad_raw, hess_raw) if renew else None)
            if c.linear_tree:
                linear = [self._linear_step(arrays, leaf_k[kk],
                                            grad_raw[:, kk], hess_raw[:, kk],
                                            kk)
                          for kk, (arrays, _) in enumerate(trees)]
            else:
                with phase(self.timer, "k4"):
                    # every class's leaf values added to its score column
                    # in one launch (reference: score_add_k,
                    # gbdt.py:2218-2241)
                    L = values.shape[1]
                    off = torch.arange(k, dtype=torch.int32, device=dev) * L
                    delta = leaf_gather((leaf_k + off[:, None]).reshape(-1),
                                        (values * rate).reshape(-1))
                    self.score = self.score + delta.view(k, -1).t()
        if c.linear_tree:
            self._add_linear_trees(linear)
        else:
            self._add_trees(trees, rate)
        # a trivial iteration ends training unless the guard tripped: a
        # skipped iteration grows no-op trees by design (reference:
        # gbdt.py:2383-2390); the flag is read only then
        finished = all(arrays.num_leaves <= 1 for arrays, _ in trees)
        if finished and ok is not None:
            with phase(self.timer, "host_sync"):
                finished = bool(host_int(ok, self.timer))
            if not finished:
                self._nan_guard.record(self.iter_)
        self._finished_last = finished
        self.iter_ += 1
        if self.iter_ % self._finished_check_every == 0 \
                and self._finished_last:
            self._trim_trailing_trivial()
            return True
        return False

    def _cegb_note(self, arrays: TreeArrays) -> None:
        """A grown tree's split features marked used in CEGB's state
        (reference: gbdt.py:2268-2275)."""
        if self._cegb is None or arrays.num_leaves <= 1:
            return
        ni = arrays.num_leaves - 1
        self._cegb.used.index_fill_(
            0, arrays.split_feature[:ni].to(torch.int64), True)

    def _linear_step(self, arrays: TreeArrays, leaf_id, grad_raw, hess_raw,
                     kk: int) -> Tree:
        """Class kk's grown tree made linear and added to the training
        score (reference: gbdt.py:2292-2300): the fit, the host delta into
        the score's column, then the init bias folded into the tree."""
        with phase(self.timer, "linear_fit"):
            delta_np, tree = self._fit_linear_tree(arrays, leaf_id, grad_raw,
                                                   hess_raw)
        bias = self.init_scores[kk] if self.iter_ == 0 else 0.0
        if bias:
            tree.add_bias(bias)
        delta = torch.zeros(self._score_shape[0], dtype=torch.float32)
        delta[:self.num_data] = torch.from_numpy(
            np.asarray(delta_np, np.float32))
        delta = delta.to(self.device)
        if self.num_tree_per_iteration == 1:
            self.score = self.score + delta
        else:
            self.score = self.score.clone()
            self.score[:, kk] += delta
        return tree

    def _fit_linear_tree(self, arrays: TreeArrays, leaf_id, grad_raw,
                         hess_raw):
        """Each leaf's linear model on the raw features (reference:
        ``_fit_linear_tree``, gbdt.py:2435-2519; linear_tree_learner.cpp
        CalculateLinear, Eq 3 of arXiv 1802.05640): the tree at learning
        rate 1.0, each leaf's numerical path features, a weighted ridge
        solved per leaf in NumPy float64 in the reference's operation
        order (its ``solve``, ``pinv`` where singular, rows with a NaN
        dropped, coefficients of at most 1e-35 cut, the first tree kept
        constant), then shrunk.  One host read of the tree's arrays, leaf
        ids and raw gradients.  Returns (the training score's delta over
        the unpadded rows, the host Tree)."""
        nd = self.num_data
        arrays_h = _arrays_to_host([arrays])[0]
        leaf_h, g_h, h_h = (t[:nd].cpu().numpy()
                            for t in (leaf_id, grad_raw, hess_raw))
        X = self.train_data.raw_data
        mappers = self.train_data.bin_mappers()
        tree = finalize_tree(arrays_h, mappers, learning_rate=1.0)
        c = self.config
        L = tree.num_leaves
        ni = max(L - 1, 0)

        # branch (path) features per leaf, numerical only
        parent = np.full(ni, -1, np.int64)
        leaf_parent = np.full(L, -1, np.int64)
        for i in range(ni):
            for ch in (int(tree.left_child[i]), int(tree.right_child[i])):
                if ch >= 0:
                    parent[ch] = i
                else:
                    leaf_parent[~ch] = i
        leaf_feats: List[List[int]] = []
        for ln in range(L):
            feats = set()
            node = leaf_parent[ln]
            while node >= 0:
                f = int(tree.split_feature[node])
                if mappers[f].bin_type != BIN_CATEGORICAL:
                    feats.add(f)
                node = parent[node]
            leaf_feats.append(sorted(feats))

        tree.is_linear = True
        tree.leaf_const = np.asarray(tree.leaf_value, np.float64).copy()
        tree.leaf_features = [[] for _ in range(L)]
        tree.leaf_coeff = [[] for _ in range(L)]
        if self.iter_ > 0:   # reference: the first tree stays constant
            lam = float(c.linear_lambda)
            for ln in range(L):
                feats = leaf_feats[ln]
                d = len(feats)
                rows = np.flatnonzero(leaf_h == ln)
                if d == 0 or len(rows) == 0:
                    continue
                A = np.column_stack([X[np.ix_(rows, feats)],
                                     np.ones(len(rows))])
                ok = ~np.isnan(A).any(axis=1)
                if int(ok.sum()) < d + 1:
                    continue
                A = A[ok]
                g = g_h[rows][ok]
                h = h_h[rows][ok]
                M = (A * h[:, None]).T @ A
                M[np.arange(d), np.arange(d)] += lam
                v = A.T @ g
                try:
                    coef = -np.linalg.solve(M, v)
                except np.linalg.LinAlgError:
                    coef = -np.linalg.pinv(M) @ v
                keep = np.abs(coef[:d]) > 1e-35
                tree.leaf_features[ln] = [f for f, kp in zip(feats, keep)
                                          if kp]
                tree.leaf_coeff[ln] = [float(cf) for cf, kp
                                       in zip(coef[:d], keep) if kp]
                tree.leaf_const[ln] = float(coef[d])
        rate = self.config.learning_rate
        if rate != 1.0:
            tree.shrink(rate)
        return tree._linear_output(X, leaf_h), tree

    def _add_linear_trees(self, trees: List[Tree]) -> None:
        """An iteration's linear trees: each validation set's score takes
        the host walk of its raw rows, less the init bias folded into a
        first tree (reference: gbdt.py:2350-2370), and the trees go to the
        host model list."""
        k = self.num_tree_per_iteration
        with phase(self.timer, "valid"):
            for vi, vset in enumerate(self.valid_sets):
                if vset.raw_data is None:
                    raise LightGBMError(
                        "linear_tree validation needs the raw feature "
                        "matrix; construct the valid Dataset with "
                        "free_raw_data=False")
                score = self.valid_scores[vi]
                for kk, tree in enumerate(trees):
                    dv = np.asarray(tree.predict_raw(vset.raw_data))
                    if self.iter_ == 0 and self.init_scores[kk] != 0.0:
                        dv = dv - self.init_scores[kk]
                    pad = torch.zeros(score.shape[0], dtype=torch.float32)
                    pad[:len(dv)] = torch.from_numpy(dv.astype(np.float32))
                    pad = pad.to(self.device)
                    if k == 1:
                        score = score + pad
                    else:
                        score = score.clone()
                        score[:, kk] += pad
                self.valid_scores[vi] = score
        self._flush_models()
        self._models_list.extend(trees)

    def _grow_key(self, kk: int = 0):
        """The key of class kk's per-node draws this iteration, or None
        when no draw is needed (reference: gbdt.py:2246-2249, :1571-1572;
        one class: ``iter * 2``, its fused form :1879)."""
        gp = self.grow_params
        if not (gp.extra_trees or gp.bynode_fraction < 1.0):
            return None
        k = self.num_tree_per_iteration
        return prng_key((self.config.extra_seed or 3) * 1000003
                        + self.iter_ * (k + 1) + kk)

    def _quant_seed(self) -> int:
        """The seed of this iteration's quantizer key (reference:
        gbdt.py:1866)."""
        return (self.config.data_random_seed + 11) * 131071 + self.iter_

    def _guard_and_quantize(self, mask, grad, hess, qkey):
        """The pad rows masked out of a sampled iteration's mask and
        gradients, the non-finite guard's flag and zeroing (reference:
        _guard_gh, gbdt.py:1308-1321) and the quantizer under ``qkey``:
        (mask, grad, hess, ok or None, gh_scales or None, grad_raw,
        hess_raw), the raw ones before quantization."""
        k = self.num_tree_per_iteration
        c = self.config
        mask = mask * self._pad_mask
        rows = self._pad_mask if k == 1 else self._pad_mask[:, None]
        grad = grad * rows
        hess = hess * rows
        ok = gh_scales = None
        if self._nan_guard.enabled:
            # one all-finite flag on the device; a tripped flag zeroes
            # the iteration
            ok = torch.isfinite(grad).all() & torch.isfinite(hess).all()
            grad = torch.where(ok, grad, 0.0)
            hess = torch.where(ok, hess, 0.0)
        grad_raw, hess_raw = grad, hess
        if c.use_quantized_grad:
            grad, hess, gh_scales = quantize_gh(
                grad, hess, qkey, c.num_grad_quant_bins,
                c.stochastic_rounding)
        return mask, grad, hess, ok, gh_scales, grad_raw, hess_raw

    def _add_trees(self, trees, rate: float) -> None:
        """Each class's grown tree walked on every validation set and kept
        for the host (``models``); ``trees``: (arrays, rounds) per class,
        rounds bounding its depth."""
        k = self.num_tree_per_iteration
        with phase(self.timer, "valid"):
            # the walk is stationary once a row reaches its leaf, and no
            # leaf is deeper than the rounds that grew the tree; every
            # class's column takes its tree's values in one add
            for vi, vset in enumerate(self.valid_sets):
                deltas = [self._tree_arrays_delta(arrays, vset.device_data(),
                                                  rate, rounds)
                          for arrays, rounds in trees]
                self.valid_scores[vi] = self.valid_scores[vi] + (
                    deltas[0] if k == 1 else torch.stack(deltas, dim=1))
        for kk, (arrays, _) in enumerate(trees):
            # the init score folds into the first tree, and under averaged
            # output (rf) into every tree (reference: gbdt.py:2281-2283)
            bias = (self.init_scores[kk]
                    if self.iter_ == 0 or self._average_output else 0.0)
            self._lazy_trees.append({"arrays": arrays, "rate": rate,
                                     "bias": bias})

    # ------------------------------------------------------------------
    def _ensure_train_state(self) -> TrainState:
        """The fused iteration's state and input buffers, allocated at its
        first iteration; a score set outside the fused iteration (a loaded
        init model, an eager update) is copied into the state's."""
        st = self._train_state
        if st is None:
            k = self.num_tree_per_iteration
            n = self._score_shape[0]
            dev = self.device
            z = torch.zeros(self._score_shape, dtype=torch.float32,
                            device=dev)

            def scalar(dtype, v=0):
                return torch.full((), v, dtype=dtype, device=dev)

            st = self._train_state = TrainState(
                score=self.score.clone(), grad=z, hess=z.clone(),
                leaf_id=torch.zeros((k, n), dtype=torch.int32, device=dev),
                mask=self._pad_mask.clone(), sampled=scalar(torch.int64),
                overflow=scalar(torch.int64),
                finished=scalar(torch.bool, False),
                ok=scalar(torch.bool, True))
            ncol = self.dd.num_features
            self._fused_in = FusedInputs(
                mask=torch.ones(n, dtype=torch.float32, device=dev),
                qkey=torch.zeros(2, dtype=torch.int64, device=dev),
                skey=torch.zeros(2, dtype=torch.int64, device=dev),
                gkey=torch.zeros(2, dtype=torch.int64, device=dev),
                rate=scalar(torch.float32),
                col_mask=(torch.ones(ncol, dtype=torch.bool, device=dev)
                          if self.config.feature_fraction < 1.0 else None))
        if st.score is not self.score:
            st.score.copy_(self.score)
            self.score = st.score
        return st

    def _fill_inputs(self, sample_mode: str) -> None:
        """This iteration's inputs into their device buffers, before any
        replay reads them; none waits for the device."""
        inp = self._fused_in
        strategy = self.sample_strategy
        mask32 = 0xFFFFFFFF
        if sample_mode == "mask_arg":
            inp.mask.copy_(strategy.epoch_mask(self.iter_))
        elif sample_mode == "traced":
            inp.skey[1].fill_(strategy.key_seed(self.iter_) & mask32)
        if self.config.use_quantized_grad:
            inp.qkey[1].fill_(self._quant_seed() & mask32)
        gkey = self._grow_key()
        if gkey is not None:
            inp.gkey[1].fill_(gkey[1])
        inp.rate.fill_(self._shrinkage_rate())
        col = self._feature_mask_host()
        if col is not None:
            src = torch.from_numpy(col)
            if self.device.type == "cuda":
                src = src.pin_memory()
            inp.col_mask.copy_(src, non_blocking=True)

    def _fused_grower(self, compact: int) -> _DeviceGrower:
        gr = self._fused_growers.get(compact)
        if gr is None:
            gr = self._fused_growers[compact] = _DeviceGrower(
                self._bins_T, self.num_tree_per_iteration, self.dd.layout,
                self.dd.routing, self.grow_params, self.dd.max_bins,
                col_mask=self._fused_in.col_mask, compact_rows=compact,
                monotone=self._monotone, interaction_groups=self._groups,
                key=(None if self._grow_key() is None
                     else tuple(self._fused_in.gkey.unbind())))
        return gr

    def _fused_head(self, st: TrainState, gr: _DeviceGrower,
                    sample_mode: str, compact: int) -> None:
        """The head graph: gradients on the training score, sampling, the
        guard, quantization, then the grower's compaction and root pass."""
        inp = self._fused_in
        k = self.num_tree_per_iteration
        grad, hess = self.objective.get_gradients(st.score[:self.num_data])
        grad, hess = self._pad(grad), self._pad(hess)
        if sample_mode == "mask_arg":
            m = inp.mask if k == 1 else inp.mask[:, None]
            mask, grad, hess = inp.mask, grad * m, hess * m
        elif sample_mode == "traced":
            mask, grad, hess = self.sample_strategy.sample_keyed(
                (inp.skey[0], inp.skey[1]), grad, hess)
        else:
            mask = torch.ones_like(self._pad_mask)
        mask, grad, hess, ok, gh_scales, _, _ = self._guard_and_quantize(
            mask, grad, hess, (inp.qkey[0], inp.qkey[1]))
        st.grad.copy_(grad)
        st.hess.copy_(hess)
        st.mask.copy_(mask)
        if ok is not None:
            st.ok.copy_(ok)
        nc = (mask > 0).sum()
        st.sampled.copy_(nc)
        if compact:
            st.overflow.add_(nc > compact)
        if k == 1:
            gr.begin(st.grad[None], st.hess[None], st.mask,
                     None if gh_scales is None else gh_scales[None])
        else:
            gr.begin(st.grad.t().contiguous(), st.hess.t().contiguous(),
                     st.mask,
                     None if gh_scales is None else gh_scales.t().contiguous())

    def _fused_tail(self, st: TrainState, gr: _DeviceGrower, rounds: int,
                    sprint) -> None:
        """The tail graph: the sprint, K3's replay, K4's score add, the
        finished flag, and the trees packed into the output buffers."""
        k = self.num_tree_per_iteration
        sprint_and_replay(gr, rounds, sprint)
        a = gr.result_arrays()
        values = a["leaf_value"] * self._fused_in.rate
        if k == 1:
            st.score.add_(leaf_gather(gr.leaf_id[0], values[0]))
        else:
            L = values.shape[1]
            off = torch.arange(k, dtype=torch.int32, device=self.device) * L
            delta = leaf_gather((gr.leaf_id + off[:, None]).reshape(-1),
                                values.reshape(-1))
            st.score.add_(delta.view(k, -1).t())
        st.leaf_id.copy_(gr.leaf_id)
        fin = (gr.cur <= 1).all()
        if self._nan_guard.enabled:
            fin = fin & st.ok
        st.finished.copy_(fin)
        packed = torch.cat(
            [a[f].reshape(-1).view(torch.int32) for f in _PACKED_FIELDS]
            + [gr.cur.to(torch.int32)])
        if self._tree_out is None:
            self._tree_out, self._bits_out = packed, a["cat_bitset"].clone()
        else:
            self._tree_out.copy_(packed)
            self._bits_out.copy_(a["cat_bitset"])

    def _fused_trees(self) -> List[TreeArrays]:
        """Each class's tree of the last fused iteration, views of one copy
        of the output buffers (the next replay overwrites them)."""
        k = self.num_tree_per_iteration
        L = self.grow_params.num_leaves
        flat = self._tree_out.clone()
        bits = self._bits_out.clone()
        fields, pos = {}, 0
        for f in _PACKED_FIELDS:
            v = flat[pos:pos + k * L].view(k, L)
            if f in ("split_gain", "internal_value", "internal_weight",
                     "internal_count", "leaf_value", "leaf_weight",
                     "leaf_count"):
                v = v.view(torch.float32)
            fields[f] = v
            pos += k * L
        num_leaves = flat[pos:pos + k]
        return [TreeArrays(num_leaves=num_leaves[kk], cat_bitset=bits[kk],
                           **{f: v[kk] for f, v in fields.items()})
                for kk in range(k)]

    def _iter_fused(self) -> bool:
        """One fused iteration (reference: ``_iter_fused``, gbdt.py:1727-
        1889): the head graph, the tree's round graphs (the host plans
        their number from recent trees and reads one (K,) vector per tree,
        after them: does a class still need a full round?), the tail graph.
        No host read happens inside a round.  The finished flag, the
        guard's flags and the sampled and overflow counts are read at the
        poll, every ``eval_fetch_freq`` iterations (16 by default)."""
        st = self._ensure_train_state()
        gp = self.grow_params
        strategy = self.sample_strategy
        sample_mode = (strategy.fused_mode(self.iter_)
                       if strategy.is_active() else "none")
        self._fill_inputs(sample_mode)
        compact = self._fused_compact_rows(sample_mode)
        self.last_compact_rows = compact
        gr = self._fused_grower(compact)

        def run(key, fn):
            # one grower, and so one set of graphs, per capacity
            self._graphs.run((compact,) + key, fn)

        def read(t):
            with phase(self.timer, "host_sync"):
                return host_list(t, self.timer)

        with phase(self.timer, "fused_head"):
            run(("head", sample_mode),
                lambda: self._fused_head(st, gr, sample_mode, compact))
        plan = max(self._loop_rounds[-4:], default=loop_plan(gp))
        with phase(self.timer, "fused_rounds"):
            rounds, sprint, used = grow_device(gr, gp, run, read, plan)
        self._loop_rounds.append(used)
        with phase(self.timer, "fused_tail"):
            run(("tail", rounds, sprint),
                lambda: self._fused_tail(st, gr, rounds, sprint))
        depth = rounds + (sprint is not None)
        rate = self._shrinkage_rate()
        self._add_trees([(a, depth) for a in self._fused_trees()], rate)
        if self._nan_guard.enabled:
            if self._nan_guard.mode == "raise":
                # the reference reads the flag at once under raise
                if not bool(host_int(st.ok, self.timer)):
                    self._nan_guard.record(self.iter_)
            else:
                self._pending_ok.append((self.iter_, st.ok.clone()))
        self.iter_ += 1
        if self.iter_ % self._finished_check_every == 0 \
                and self._poll_device_flags():
            self._trim_trailing_trivial()
            return True
        return False

    def _poll_device_flags(self) -> bool:
        """One batched read of every flag the host loop needs (reference:
        gbdt.py:1891-1928): the last fused iteration's finished flag, the
        guard's unread flags, the in-bag row count and the overflow count.
        An overflow warns and turns compaction off for the rest of the
        run.  Returns the finished flag."""
        st = self._train_state
        pending, self._pending_ok = self._pending_ok, []
        got = host_list(torch.stack(
            [st.finished.to(torch.int64), st.sampled, st.overflow]
            + [ok.to(torch.int64) for _, ok in pending]), self.timer)
        self.last_sampled_rows = got[1]
        if got[2] > self._overflow_seen:
            self._overflow_seen = got[2]
            if not self._compact_overflow:
                self._compact_overflow = True
                log_warning(
                    "fused iteration: the in-bag row count exceeded the "
                    "analytic compaction capacity "
                    f"({self.last_compact_rows}); trees since the last poll "
                    "trained on a truncated sample - disabling row "
                    "compaction for the rest of this run (set "
                    "row_compaction=off to silence)")
        for (iteration, _), ok in zip(pending, got[3:]):
            if not ok:
                self._nan_guard.record(iteration)
        return bool(got[0])

    def flush_pending_ok(self) -> None:
        """Record the guard's flags of fused iterations that no poll has
        read yet, and only those (a checkpoint's capture: the other flags
        keep their cadence)."""
        pending, self._pending_ok = self._pending_ok, []
        if not pending:
            return
        got = host_list(torch.stack([ok.to(torch.int64)
                                     for _, ok in pending]), self.timer)
        for (iteration, _), ok in zip(pending, got):
            if not ok:
                self._nan_guard.record(iteration)

    def flush_nan_guard(self) -> None:
        """Read the flags no poll has read yet (reference: gbdt.py:1337,
        at the end of ``train``)."""
        if self._train_state is not None and self._fused:
            self._poll_device_flags()

    def _renew_leaves_exact(self, arrays: TreeArrays, leaf_id, grad_raw,
                            hess_raw) -> TreeArrays:
        """Leaf values from the raw (unquantized) gradients' per-leaf sums
        (reference: ``_renew_leaves_exact``, gbdt.py:2523-2540;
        RenewIntGradTreeOutput).  The reference adds float32 in
        ``segment_sum``; here the sums are exact fixed point (one host read
        of the largest weights), the same on every device and run, and
        equal to the reference's wherever its float32 sums are exact."""
        L = self.grow_params.num_leaves
        if arrays.num_leaves <= 1:
            return arrays
        lid = torch.clamp(leaf_id.to(torch.int64), 0, L - 1)
        with phase(self.timer, "host_sync"):
            m = host_list(torch.stack([grad_raw.abs().amax(),
                                       hess_raw.abs().amax()]), self.timer)
        sums = []
        for w, mx in zip((grad_raw, hess_raw), m):
            shift = hist_shift(mx, lid.numel())
            acc = torch.zeros(L, dtype=torch.int64, device=lid.device)
            sums.append(dequantize(acc.index_add_(0, lid, quantize(w, shift)),
                                   shift))
        c = self.config
        vals = leaf_output(sums[0], sums[1], c.lambda_l1, c.lambda_l2,
                           c.max_delta_step)
        keep = ((torch.arange(L, device=lid.device) < arrays.num_leaves)
                & (arrays.leaf_count > 0))
        return arrays._replace(
            leaf_value=torch.where(keep, vals, arrays.leaf_value))

    def _renew_leaves_percentile(self, arrays: TreeArrays, leaf_id,
                                 mask) -> TreeArrays:
        """Leaf values renewed to a percentile of each leaf's in-bag
        residuals on the training score before this tree (reference:
        ``_post_grow``, gbdt.py:2600-2613; TreeLearner::RenewTreeOutput,
        gbdt.cpp:419).  A leaf keeps its value where it holds no in-bag
        row, past the tree's leaves, or when the tree has one leaf.
        ``leaf_id``: every row's leaf (K3's replay on a sampled tree);
        ``mask``: the tree's in-bag mask."""
        if arrays.num_leaves <= 1:
            return arrays
        n, L = self.num_data, self.grow_params.num_leaves
        vals = self.objective.renew_leaf_values(
            self.score[:n], leaf_id[:n], L, mask[:n])
        keep = ((torch.arange(L, device=vals.device) < arrays.num_leaves)
                & (arrays.leaf_count > 0))
        return arrays._replace(
            leaf_value=torch.where(keep, vals, arrays.leaf_value))

    def _grow_classes(self, grad, hess, mask, col_mask, compact: int,
                      gh_scales=None, raw=None):
        """The K class trees of an iteration from the (n_pad, K) gradients
        (reference: ``_grow_classes``, gbdt.py:1538-1578): in lockstep
        (``_use_batched_multiclass``) or one ``grow_tree`` per class, each
        on the compacted view of ``compact`` rows (0: none).  gh_scales: the
        (2, K) quantized scales, or None; raw: the (n_pad, K) raw (grad,
        hess) when leaves are renewed, which grows one class at a time as
        the reference does (gbdt.py:2204-2208).  One at a time, each class
        tree grows after the previous one has updated CEGB's state.
        Returns each class's (arrays, rounds), the (K, n_pad) leaf ids and
        the (K, L) leaf values."""
        k = self.num_tree_per_iteration
        gT, hT = grad.t().contiguous(), hess.t().contiguous()
        scales = None if gh_scales is None else gh_scales.t().contiguous()
        kw = dict(timer=self.timer, col_mask=col_mask, compact_rows=compact)
        if self._use_batched_multiclass() and raw is None:
            res = grow_tree_k(self._bins_T, gT, hT, mask, self.dd.layout,
                              self.dd.routing, self.grow_params,
                              self.dd.max_bins, gh_scales=scales, **kw)
            a = res.arrays
            trees = [(TreeArrays(num_leaves=a.num_leaves[kk],
                                 **{f: getattr(a, f)[kk]
                                    for f in TreeArrays._fields
                                    if f != "num_leaves"}),
                      res.rounds[kk]) for kk in range(k)]
            return trees, res.leaf_id, a.leaf_value
        results = []
        for kk in range(k):
            results.append(grow_tree(
                self._bins_T, gT[kk], hT[kk], mask, self.dd.layout,
                self.dd.routing, self.grow_params, self.dd.max_bins,
                bins=self.dd.bins,
                gh_scales=None if scales is None else scales[kk],
                monotone=self._monotone, interaction_groups=self._groups,
                key=self._grow_key(kk), cegb=self._cegb, **kw))
            self._cegb_note(results[-1].arrays)
        if raw is not None:
            results = [r._replace(arrays=self._renew_leaves_exact(
                r.arrays, r.leaf_id, raw[0][:, kk], raw[1][:, kk]))
                for kk, r in enumerate(results)]
        trees = [(r.arrays, r.rounds) for r in results]
        return (trees, torch.stack([r.leaf_id for r in results]),
                torch.stack([r.arrays.leaf_value for r in results]))

    def load_init_model(self, trees: List[Tree],
                        num_tree_per_iteration: int,
                        skip_score_rebuild: bool = False) -> None:
        """Seed the engine with an existing model's trees and rebuild the
        training score (reference: GBDT::ResetTrainingData +
        model-continuation init, src/boosting/gbdt.cpp:259-263;
        lightgbm_tpu/models/gbdt.py:2542-2598).  ``skip_score_rebuild``: a
        checkpoint resume restores the exact saved score next, so the
        O(trees x rows) walk would be wasted."""
        k = self.num_tree_per_iteration
        if self._nan_guard.enabled:
            # refuse to boost on top of a poisoned model
            check_model_trees(trees, "init model")
        if num_tree_per_iteration != k:
            raise LightGBMError(
                f"init_model has {num_tree_per_iteration} trees/iteration but "
                f"this training run needs {k}")
        if len(trees) % k != 0:
            raise LightGBMError("init_model tree count is not a multiple of "
                                "num_tree_per_iteration")
        budget = self.config.num_leaves
        worst = max((t.num_leaves for t in trees), default=0)
        if worst > budget:
            raise LightGBMError(
                f"init_model contains a tree with {worst} leaves but this "
                f"training run's num_leaves budget is {budget}; continue with "
                f"num_leaves >= {worst}")
        self.models = list(trees)
        self.iter_ = len(trees) // k
        # loaded trees already contain the folded init bias (AddBias at save
        # time), so the restored score is exactly the summed tree outputs plus
        # any user-provided init_score offsets
        score = torch.zeros(self._score_shape, dtype=torch.float32,
                            device=self.device)
        base = self.train_data.get_init_score_padded(self._score_shape[0], k)
        if base is not None:
            score = score + torch.as_tensor(base, device=self.device)
        if not skip_score_rebuild:
            for it in range(self.iter_):
                for kk in range(k):
                    score = self._add_tree_to_score(
                        score, self.models[it * k + kk], self.dd, kk)
        self.score = score
        # prevent re-folding the from-average bias into future first trees
        self.init_scores = [0.0] * k

    # ------------------------------------------------------------------
    def add_valid(self, valid_data, name: str,
                  metrics: Sequence[Metric]) -> None:
        """Track a validation set's score from now on (reference:
        gbdt.py:1218-1250): the init score before the first tree, else the
        trees grown so far walked on its bins."""
        dd = valid_data.device_data()
        n = dd.bins.shape[0]
        k = self.num_tree_per_iteration
        score = torch.zeros((n,) if k == 1 else (n, k), dtype=torch.float32,
                            device=self.device)
        if self.iter_ == 0:
            # once trees exist the init score is folded into tree 0
            score = score + torch.tensor(
                self.init_scores if k > 1 else self.init_scores[0],
                dtype=torch.float32, device=self.device)
        base = valid_data.get_init_score_padded(n, k)
        if base is not None:
            score = score + torch.as_tensor(base, device=self.device)
        for i, tree in enumerate(self.models):
            score = self._add_tree_to_score(score, tree, dd, i % k)
        self.valid_sets.append(valid_data)
        self.valid_names.append(name)
        self.valid_metrics.append(list(metrics))
        self.valid_scores.append(score)

    def _tree_arrays_delta(self, arrays: TreeArrays, dd: DeviceData,
                           rate: float, depth: int) -> torch.Tensor:
        """(n,) shrunk leaf values of a grown tree's device arrays, walked
        on ``dd``'s bins (reference: gbdt.py:2616-2625)."""
        fields = (arrays.split_feature, arrays.threshold_bin,
                  arrays.dir_flags, arrays.left_child, arrays.right_child,
                  arrays.cat_bitset)
        leaf = _walk_one_tree(fields, dd.bins, dd.routing, depth)
        return arrays.leaf_value[leaf.long()] * rate

    def score_to_host(self, score: torch.Tensor, n: int) -> np.ndarray:
        return score[:n].cpu().numpy()

    def _convert(self):
        return (self.objective.convert_output if self.objective is not None
                else (lambda x: x))

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        """(reference: gbdt.py:2633-2642)"""
        score = self.score_to_host(self.score, self.num_data)
        conv = self._convert()
        return [("training", name, val, hb) for m in self.train_metrics
                for name, val, hb in m.evaluate(score, conv)]

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        """(reference: gbdt.py:2644-2655)"""
        conv = self._convert()
        out = []
        for vi, vset in enumerate(self.valid_sets):
            score = self.score_to_host(self.valid_scores[vi],
                                       vset.num_data())
            for m in self.valid_metrics[vi]:
                for name, val, hb in m.evaluate(score, conv):
                    out.append((self.valid_names[vi], name, val, hb))
        return out

    def _add_tree_to_score(self, score: torch.Tensor, tree: Tree,
                           dd: DeviceData, kk: int,
                           scale: Optional[float] = None) -> torch.Tensor:
        """``score`` plus a host tree's float32 leaf values (times
        ``scale``, in float32, when given) walked on ``dd``'s bins."""
        fields, leaf_value = _tree_to_device(tree, self.config.num_leaves,
                                             dd.max_bins, self.train_data,
                                             dd.device)
        if scale is not None:
            leaf_value = leaf_value * scale
        # the walk is stationary once a row reaches its leaf, so the tree's
        # exact depth gives the same leaves as the reference's num_leaves
        # bound in fewer steps
        leaf = _walk_one_tree(fields, dd.bins, dd.routing,
                              tree_max_depth(tree))
        delta = leaf_value[leaf.long()]
        if score.dim() == 1:
            return score + delta
        score = score.clone()
        score[:, kk] += delta
        return score

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's K trees and subtract them from the
        training and every validation score (reference:
        GBDT::RollbackOneIter, gbdt.cpp:463; lightgbm_tpu/models/gbdt.py
        :2658).  The float32 score is restored to rounding, as there.  The
        fused iteration copies the rolled-back score into its state before
        its next replay (``_ensure_train_state``)."""
        if self.iter_ <= 0:
            return
        k = self.num_tree_per_iteration
        models = self.models                    # the lazy trees flushed
        dropped = models[-k:]
        del models[-k:]
        for kk, tree in enumerate(dropped):
            neg = replace(
                tree, leaf_value=-np.asarray(tree.leaf_value, np.float64))
            self.score = self._add_tree_to_score(self.score, neg, self.dd,
                                                 kk)
            for vi, vset in enumerate(self.valid_sets):
                self.valid_scores[vi] = self._add_tree_to_score(
                    self.valid_scores[vi], neg, vset.device_data(), kk)
        self.iter_ -= 1
        # a re-run of the iteration may draw another in-bag count
        self._sample_count_cache = None

    def _trim_trailing_trivial(self) -> None:
        """Drop trailing no-op iterations (every class tree single-leaf with
        zero output) (reference: gbdt.cpp:436-447 stops without keeping the
        splitless tree)."""
        k = self.num_tree_per_iteration
        models = self.models
        while self.iter_ > 0 and len(models) >= k:
            tail = models[-k:]
            if not all(t.num_leaves <= 1 and all(v == 0.0 for v in t.leaf_value)
                       for t in tail):
                break
            del models[-k:]
            self.iter_ -= 1


def _arrays_to_host(arrays_list: List[TreeArrays]) -> List[TreeArrays]:
    """Device TreeArrays -> numpy TreeArrays, every field of every tree in
    one float64 transfer (int32, float32 and bool values are exact in
    float64)."""
    names = [n for n in TreeArrays._fields if n != "num_leaves"]
    # a fused iteration's leaf count is a device scalar: it rides along
    parts = [getattr(a, n).reshape(-1).to(torch.float64)
             for a in arrays_list
             for n in names + (["num_leaves"]
                               if isinstance(a.num_leaves, torch.Tensor)
                               else [])]
    flat = torch.cat(parts).cpu().numpy()
    out, pos = [], 0
    for a in arrays_list:
        fields = {}
        for n in names:
            t = getattr(a, n)
            size = t.numel()
            np_dtype = {torch.int32: np.int32, torch.float32: np.float32,
                        torch.bool: np.bool_}[t.dtype]
            fields[n] = flat[pos:pos + size].astype(np_dtype).reshape(
                tuple(t.shape))
            pos += size
        num_leaves = a.num_leaves
        if isinstance(num_leaves, torch.Tensor):
            num_leaves = flat[pos]
            pos += 1
        out.append(TreeArrays(num_leaves=int(num_leaves), **fields))
    return out


def _tree_to_device(tree: Tree, num_leaves_budget: int, max_bins: int,
                    train_data, device: torch.device):
    """Host Tree -> padded bin-space tensors for score walks: ((split_feature,
    threshold_bin, dir_flags, left_child, right_child, cat_bitset),
    leaf_value f32)."""
    L = num_leaves_budget
    Bmax = max_bins

    def pad1(a, size, dtype, fill=0):
        out = np.full(size, fill, dtype)
        out[:len(a)] = a
        return out

    n_int = len(tree.split_feature)
    dirf = np.zeros(n_int, np.int32)
    cat_bits = np.zeros((L, Bmax), bool)
    mappers = train_data.bin_mappers()
    thr_bin = np.asarray(tree.threshold_bin, np.int64).copy()
    for i in range(n_int):
        dt = int(tree.decision_type[i])
        f = int(tree.split_feature[i])
        m = mappers[f]
        if dt & 1:
            dirf[i] |= DIR_CATEGORICAL
            # rebuild the bin-space bitset from the category-value bitset
            kcat = int(tree.threshold_bin[i])
            s, e = tree.cat_boundaries[kcat], tree.cat_boundaries[kcat + 1]
            words = tree.cat_threshold[s:e]
            for b, c in enumerate(m.categories):
                c = int(c)
                if c // 32 < len(words) and (int(words[c // 32]) >> (c % 32)) & 1:
                    cat_bits[i, b] = True
        else:
            if dt & 2:
                dirf[i] |= DIR_DEFAULT_LEFT
            # bin threshold from the real threshold
            thr_bin[i] = int(np.searchsorted(m.upper_bounds, tree.threshold[i],
                                             side="left"))

    def t(a):
        return torch.as_tensor(a, device=device)

    fields = (t(pad1(tree.split_feature, L, np.int32)),
              t(pad1(thr_bin, L, np.int32)),
              t(pad1(dirf, L, np.int32)),
              t(pad1(tree.left_child, L, np.int32)),
              t(pad1(tree.right_child, L, np.int32)),
              t(cat_bits))
    return fields, t(pad1(tree.leaf_value, L, np.float32))


def _config_values(config: Config) -> Dict[str, str]:
    """Each field of the config by its repr, to see which a reset
    changed."""
    return {f.name: repr(getattr(config, f.name))
            for f in dataclasses.fields(config)}


class DART(GBDT):
    """Dropout boosting (reference: src/boosting/dart.hpp;
    lightgbm_tpu/models/gbdt.py:2695-2775).  Before each iteration some
    earlier iterations' trees are drawn from the host ``RandomState`` of
    ``drop_seed`` (``rand()``, then ``rand(n)`` under ``uniform_drop`` or
    ``choice``), at most ``max_drop``, and subtracted from the training
    score by the bin-space walk; the iteration grows its trees as a gbdt
    iteration does (fused or eager); then the new trees are scaled to 1 /
    (k + 1) of a full step and the dropped ones to k / (k + 1) (the
    xgboost form under ``xgboost_dart_mode``), in the host trees and in the
    score, and the dropped trees go back in.  When the new trees are
    trivial the dropped ones go back unchanged.  Validation scores keep
    each new tree at the learning rate and the dropped trees unscaled, as
    in the JAX package (stock dart.hpp rescales them too; ROADMAP §3).
    The score edits are host-driven walks between iterations: the fused
    iteration copies the edited score into its state at its first step."""

    boosting_type = "dart"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._drop_rng = np.random.RandomState(self.config.drop_seed)
        # the trees are rescaled on the host every iteration, so the
        # finished flag is read every iteration too
        self._finished_check_every = 1
        self.last_drop: List[int] = []

    def _set_fused_gate(self) -> None:
        super()._set_fused_gate()
        self._finished_check_every = 1

    def _drop_indices(self) -> List[int]:
        """This iteration's dropped iterations, drawn in the reference's
        order (gbdt.py:2713-2725)."""
        c = self.config
        n_iters = self.iter_
        drop_idx: List[int] = []
        if n_iters > 0 and self._drop_rng.rand() >= c.skip_drop:
            if c.uniform_drop:
                sel = self._drop_rng.rand(n_iters) < c.drop_rate
                drop_idx = list(np.where(sel)[0])
            else:
                kcnt = max(1, int(round(c.drop_rate * n_iters)))
                drop_idx = list(self._drop_rng.choice(
                    n_iters, size=min(kcnt, n_iters), replace=False))
            if len(drop_idx) > c.max_drop > 0:
                drop_idx = drop_idx[:c.max_drop]
        return [int(i) for i in drop_idx]

    def _walk_trees(self, pairs, scale: Optional[float] = None) -> None:
        """Each (host tree, class) walked into the training score."""
        with phase(self.timer, "dart_walk"):
            for tree, kk in pairs:
                self.score = self._add_tree_to_score(self.score, tree,
                                                     self.dd, kk, scale)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        c = self.config
        k = self.num_tree_per_iteration
        drop_idx = self._drop_indices()
        self.last_drop = drop_idx
        kfac = len(drop_idx)
        models = self.models if drop_idx else []
        dropped = [(models[it * k + kk], kk) for it in drop_idx
                   for kk in range(k)]
        self._walk_trees(dropped, -1.0)
        finished = super().train_one_iter(grad, hess)
        if kfac == 0:
            return finished
        if finished:
            # the new trees were trivial: the dropped trees go back as
            # they were
            self._walk_trees(dropped)
            return finished
        # normalization (reference: dart.hpp Normalize)
        lr = c.learning_rate
        if c.xgboost_dart_mode:
            new_scale, old_scale = lr / (kfac + lr), kfac / (kfac + lr)
        else:
            new_scale, old_scale = 1.0 / (kfac + 1.0), kfac / (kfac + 1.0)
        models = self.models
        factor = new_scale / self._shrinkage_rate()
        for kk in range(k):
            tree = models[-k + kk]
            self._walk_trees([(tree, kk)], factor - 1.0)
            tree.shrink(new_scale / tree.shrinkage if tree.shrinkage
                        else new_scale)
        for tree, _ in dropped:
            tree.shrink(old_scale)
        self._walk_trees(dropped)
        return finished


class RF(GBDT):
    """Random forest (reference: src/boosting/rf.hpp;
    lightgbm_tpu/models/gbdt.py:2777-2847): bagging on (the config's
    fix-up), no shrinkage, every tree's gradients taken at the constant
    init score, each tree's output averaged: the trees' sum is kept apart
    and the score is init + sum / t.  Every tree carries the init bias, and
    the model text says ``average_output``.  RF runs eager: the fused head
    takes its gradients from ``TrainState.score``, the averaged score, not
    the init constant (ROADMAP item 15)."""

    boosting_type = "rf"
    _average_output = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        k = self.num_tree_per_iteration
        self._init_score_const = torch.zeros(
            self._score_shape, dtype=torch.float32,
            device=self.device) + torch.tensor(
            self.init_scores if k > 1 else self.init_scores[0],
            dtype=torch.float32, device=self.device)
        self._tree_sum = torch.zeros(self._score_shape, dtype=torch.float32,
                                     device=self.device)

    def _gradient_score(self) -> torch.Tensor:
        if self.objective is None:
            raise LightGBMError("rf requires an objective")
        return self._init_score_const

    def _shrinkage_rate(self) -> float:
        return 1.0

    def _can_fuse_iteration(self) -> bool:
        return False

    def load_init_model(self, trees, num_tree_per_iteration,
                        skip_score_rebuild: bool = False) -> None:
        raise LightGBMError(
            "continued training (init_model) is not supported with "
            "boosting=rf: the averaged-output bookkeeping cannot be rebuilt "
            "from a saved model")

    def train_one_iter(self, grad=None, hess=None) -> bool:
        # the trees' sum is the score the iteration adds to
        self.score = self._tree_sum
        finished = super().train_one_iter(grad, hess)
        self._tree_sum = self.score
        t = max(self.iter_, 1)
        self.score = self._init_score_const + self._tree_sum / t
        return finished

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        """The validation scores started at the init score and took every
        tree whole: averaged, init + (raw - init) / t.  (The training
        score is averaged at every iteration, so ``eval_train`` reads it
        as it is.)"""
        t = max(self.iter_, 1)
        conv = self._convert()
        k = self.num_tree_per_iteration
        init = np.asarray(self.init_scores if k > 1 else self.init_scores[0])
        out = []
        for vi, vset in enumerate(self.valid_sets):
            raw = self.score_to_host(self.valid_scores[vi], vset.num_data())
            score = init + (raw - init) / t
            for m in self.valid_metrics[vi]:
                for name, val, hb in m.evaluate(score, conv):
                    out.append((self.valid_names[vi], name, val, hb))
        return out


def create_boosting(config: Config, train_data, objective,
                    metrics: Sequence[Metric] = ()) -> GBDT:
    """reference: Boosting::CreateBoosting (boosting.cpp:42;
    lightgbm_tpu/models/gbdt.py:2910-2919): gbdt (``goss`` is gbdt with the
    GOSS strategy), dart and rf.  ``linear_tree`` under dart or rf raises
    the reference's error (gbdt.py:1196-1199)."""
    t = config.boosting
    if config.linear_tree and t in ("dart", "rf", "random_forest"):
        raise LightGBMError(
            "linear_tree is not supported with boosting="
            f"{'dart' if t == 'dart' else 'rf'}")
    if t in ("gbdt", "gbrt", "goss"):
        return GBDT(config, train_data, objective, metrics)
    if t == "dart":
        return DART(config, train_data, objective, metrics)
    if t in ("rf", "random_forest"):
        return RF(config, train_data, objective, metrics)
    raise LightGBMError(f"Unknown boosting type {t}")
