"""Batched best-first (leaf-wise) tree growth on one device.

The port's counterpart of ``lightgbm_tpu/ops/grow.py:348-1614`` with plain
growth (reference: src/treelearner/serial_tree_learner.cpp:183-249).  Each
round splits the top-S leaves by cached gain together, every row goes to
its new leaf, the histograms of the S smaller children are built, the
larger siblings come by subtraction, and the 2S children are scanned for
their own best splits.

``hist_backend="stream"``: one K2 pass (kernels/route_hist.py) routes the
rows and builds the histograms together.  The schedule is the reference's:

- a root pass through K2 with every row kept in slot 0;
- rounds of S = min(max_splits_per_round, L - 1) splits, the leaves taken
  in a stable descending sort of their cached gains;
- for S > 64, seven budget-64 rounds first;
- for S >= 64 and no depth limit, the main loop stops once one route-only
  round can make the remaining splits, and that last "sprint" round splits
  up to S_f = min(2S, 255, L - 1) leaves through K2 without histograms.

A sampled tree (bagging or GOSS, ``compact_rows > 0``) grows on a compacted
view: one stable partition per tree (ops/compact.py) puts the in-bag rows
first, and every K2 pass with histograms (root, rounds, sprint) reads the
(G, compact_rows) view and its own leaf ids; K class trees share the one
partition, their (K, compact_rows) weights gathered together (reference:
:1805-1813).  Every row of the full set still needs its leaf for the
score update.  Unfused, each round adds a route-only K2 pass over all N
rows, for K classes one class-axis pass (reference: :1023-1032,
:2120-2126).  Fused (``route_fusion``, one class tree only, under the
reference's gate :626-633: S >= 64, no depth limit, at most 256 leaves,
plain growth), each round's (L, 16) route records are
kept, and after growth one K3 launch (kernels/route_replay.py) replays them
over all rows from leaf 0 (:1562-1585).  The histograms are exact fixed
point and the shift is chosen from the full row count, so compaction and
fusion change no bit of the tree.

``hist_backend="scatter"`` or ``"pallas"`` (the reference's
``use_stream=False`` path, :717-754 and :1037-1085): each round routes every
row with torch ops over the split features' bins, maps the smaller
children to slots, and builds their (S, G, Bmax, 3) histograms through
``ops/histogram.build_histograms``: K5 (kernels/scatter_hist.py) over the
rows in their order, or the slot-sorted block plan and K6/K7
(kernels/hist_sorted.py).  Each slot's exact row count is the sum of its
group 0 count channel.  The schedule is plain rounds of S: no budget-64
prefix and no sprint, so every round builds histograms.  A sampled
``scatter`` tree builds them over its compacted rows, each round's slots
gathered through the partition (``compact_row_views``); ``pallas`` does not
compact, and a sampled tree runs on masked weights over all rows.

K class trees (multiclass, ``grow_tree_k``; reference: ops/grow.py:1650-2301)
grow in lockstep: every per-leaf tensor has a leading class axis, each
class splits its own top leaves in a round, and one histogram pass serves
all classes (K2 over K > 1 classes under ``stream``, K8 under ``scatter``
and ``pallas``), then subtraction and one split scan over every class's
children.  Each class keeps its own fixed-point shift, from its own largest
weight, so its sums are those of a tree grown alone.  A class whose own
loop would have stopped takes no split in a round; in the sprint schedule a
class ready for the route-only sprint waits, frozen, until every class has
made its full rounds, and then all sprint together.  So each class tree is
the tree ``grow_tree`` grows from that class's gradients, bit for bit.

Quantized gradients (``use_quantized_grad``; reference: ops/grow.py:587-596,
:715-716, :1010-1011, and :1791-1796, :1867-1869, :2116-2118 for K
classes): the grower gets grid-valued grad and hess (``q * scale``) and each
class's (grad, hess) scales.  Under ``stream`` with ``int_hist`` (the
reference's gate, models/gbdt.py) every K2 pass takes its int form
(``route_and_hist_int``): the rows' integer grid values, ``round(w * (1 /
scale))`` as int8, are summed into exact int32 histograms, and the grower
unscales each pass's histograms at once, ``hist.to(float32) * scale`` per
class and channel, before any subtraction (which stays float32, parent
minus child).  No fixed-point shift is chosen then.  The other backends, and
``stream`` outside the gate, sum the grid-valued floats as any float
weights.

Growth constraints (reference: :1360-1385, :466-475, :1563-1569), one
class tree at a time as in the reference (``grow_tree_k`` grows plain
trees only): with basic monotone constraints or ``path_smooth`` every leaf
keeps output bounds ``out_lo`` / ``out_hi`` and its output ``leaf_out``.
A split sets its children's outputs from their sums under the parent's
bounds (smoothed toward the parent's output), and under a monotone
feature (numeric splits only) the midpoint of the two outputs bounds each
child on its side; the split scan gains at the constrained outputs
(ops/split.py) and the grown leaves keep those outputs.  Interaction
constraints keep each leaf's (F,) path features, and a leaf's scan sees
only the features of the groups that hold its whole path.

The intermediate and advanced monotone methods (reference: :1109-1359,
:1425-1511) split one leaf a round.  Each split's children take the
split leaf's bounds tightened with their actual outputs, and the leaves
across the split leaf's monotone ancestors that its plane touches take
the children's outputs as bounds (``_mono_pairs``, ``_walk``); the tree
keeps each leaf's ancestry (leaf x node, left and right), each node's
monotone sign and depth, and each leaf's bin rectangle.  Every leaf then
rescans, and the children and the leaves whose bounds changed take their
results.  The advanced method bounds each threshold instead, from per-leaf
(F, Bmax) constraint slabs: the children clone the split leaf's and clamp
them, and the leaves the walk flags recompute theirs
(``advanced_constraint_slabs``).  By-node feature sampling and extra trees
(reference: :466-487; ops/split.py:442-447) draw from the tree's key:
uniform numbers over each scanned leaf's allowed features and a random
threshold a feature, each leaf in its row of the reference's (R, F) draw
for the round.  None of these is plain growth: K class trees grow one at
a time.

Cost-effective gradient boosting (CEGB; reference: :444-464, :765-777,
:1391-1405, :1485-1494; cost_effective_gradient_boosting.hpp) takes a
cost off each (leaf, feature) best gain in the split scan: tradeoff times
``cegb_penalty_split`` per row of the leaf, plus the feature's coupled cost
while no tree of the model splits on it, plus its lazy cost per row of the
leaf not yet charged for it.  ``CegbState`` carries the model's used
features and the (N, F) bitset of charged rows from tree to tree; each
round marks its split features used and charges every row of its split
leaves, before their rows move, and the lazy counts read every row's
current leaf (out-of-bag and pad rows too, as the reference's
``segment_sum`` over all N does).  Forced splits (``GrowParams.forced``;
reference: :866-891, :1516-1520) run first, one round a level of the
forced tree: pair i splits leaf ``f_leaves[i]`` at its forced bin, the
left sums from the leaf's cached histogram (the NaN bin on the default
side), the left count estimated as ``round(lh * pc / ph)``, gain 0; the
rest of the round is the shared code.  A tree with forced splits never
sprints.  Neither is plain growth (CEGB) or fuses its route (either): K
class trees grow one at a time.

Categorical splits (reference: ops/grow.py:936-951, :2017-2031): each
chosen categorical split's left bins are recomputed from the split leaf's
cached histogram (``categorical_left_bitset``), kept in the node arrays'
``cat_bitset`` and packed into the leaf's row of the (K, L, W) words K2
routes by; the torch routing of the other backends reads the same bits.
Route fusion is off for a tree with a categorical feature, as in the
reference: K3's records carry no bitsets.

The eager loop (``_Grower``, ``_grow``) is a Python loop over rounds.
Each round reads one (K,) vector on the host (each class's number of
splittable leaves), and each iteration one more (each class's largest
weight, which fixes its histograms' fixed-point shift; not under the int
form).  The fused iteration's grower (``_DeviceGrower``, ``grow_device``;
reference: the ``lax.while_loop`` of :849 and the prefix and sprint loops
of :1530-1560) keeps those counts on the device, gives every round a static
shape (K * min(2**r, B) pair slots, K2 at min(2**r, B) slots) and reads the
host once per tree, after the rounds its caller planned: the same trees, bit
for bit, since a round no class needs changes nothing.  Not ported:
meshes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device_data import FeatureLayout, RoutingLayout
from ..kernels.layout import (ROUTE_FIELDS, build_route_tables,
                              cat_words_from_bits)
from ..kernels.route_hist import route_and_hist, route_and_hist_int
from ..kernels.route_replay import route_replay
from ..tree import DIR_CATEGORICAL, DIR_DEFAULT_LEFT, TreeArrays
from ..utils.random import fold_in, uniform_rows
from ..utils.timer import host_list, phase
from .compact import (check_compact_supported, compact_row_views,
                      compact_transposed_view, plan_sample_rows)
from .histogram import (build_histograms, build_histograms_k, hist_shift,
                        hist_shifts, hist_subtract, scale_table,
                        scale_table_dev)
from .predict import feature_local_bin
from .split import (EPS_HESS, NEG_INF, CatParams, categorical_left_bitset,
                    child_output, constrained_child_outputs,
                    find_best_splits, gather_feature_histograms, leaf_output,
                    penalty_table, round_int)


class GrowParams(NamedTuple):
    """Hyper-parameters of one tree build (the reference's GrowParams, the
    fields plain stream growth reads)."""
    num_leaves: int
    max_depth: int
    max_splits_per_round: int
    lambda_l1: float
    lambda_l2: float
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float
    max_delta_step: float
    route_fusion: bool = False
    hist_backend: str = "stream"     # stream | scatter | pallas
    # quantized gradients through K2's int form (models/gbdt.py gate)
    int_hist: bool = False
    # the categorical split parameters, set only when the data has a
    # categorical feature: only then does the split scan run its
    # categorical branch
    cat: Optional[CatParams] = None
    # the most bins of a categorical feature, which sizes the bitset words
    # a round routes by (0: not given, Bmax)
    cat_bins: int = 0
    # growth constraints (reference: ops/grow.py:57-89); the monotone signs
    # and the interaction groups themselves go to the grower as tensors
    has_monotone: bool = False
    monotone_penalty: float = 0.0
    # the intermediate method (each leaf's bounds tightened with the actual
    # outputs of the leaves across its monotone ancestors) and the advanced
    # one, which implies it (bounds per threshold from constraint slabs)
    monotone_intermediate: bool = False
    monotone_advanced: bool = False
    path_smooth: float = 0.0
    has_interaction: bool = False
    # per-node feature sampling and random thresholds, drawn from the key
    # the grower is given
    extra_trees: bool = False
    bynode_fraction: float = 1.0
    # CEGB (reference: :87-89); its per-feature costs and the run's state
    # go to the grower as a CegbState
    has_cegb: bool = False
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    # forced splits, one level of the forced tree each: (leaves, features,
    # threshold bins, default lefts) tuples (reference: forced, :369)
    forced: tuple = ()

    @property
    def plain_growth(self) -> bool:
        """No growth constraint, per-node draw or CEGB is on (reference:
        :116-123): the gate of route fusion and of K class trees in
        lockstep.  Forced splits have gates of their own."""
        return not (self.has_monotone or self.has_interaction
                    or self.path_smooth > 0.0 or self.extra_trees
                    or self.bynode_fraction < 1.0 or self.has_cegb)


class CegbState(NamedTuple):
    """CEGB's state across the trees of a run (reference:
    models/gbdt.py:341-347, :2259-2275): the features some tree of the
    model splits on, the per-feature costs, and which features each row
    has been charged for.  The grower marks ``lazy`` in place."""
    used: torch.Tensor                  # (F,) bool
    coupled: Optional[torch.Tensor]     # (F,) float32 coupled costs, or None
    lazy_pen: Optional[torch.Tensor]    # (F,) float32 lazy costs, or None
    lazy: Optional[torch.Tensor]        # (N, F) bool charged rows, or None


class GrowResult(NamedTuple):
    """One tree; for K class trees (``grow_tree_k``) every array has a
    leading K axis, ``arrays.num_leaves`` and ``rounds`` are K-tuples."""
    arrays: TreeArrays
    leaf_id: torch.Tensor     # (N,) int32 leaf of every row
    rounds: int               # splitting rounds run: bounds the tree's depth


def fusion_applies(params: GrowParams, compact_rows: int,
                   num_class: int = 1) -> bool:
    """The reference's gate for route fusion (ops/grow.py:626-633): one
    compacted stream tree (``grow_tree_k`` has no replay) grown in the
    sprint schedule (S >= 64, no depth limit, no forced splits) with at
    most 256 leaves and plain growth (no CEGB, whose lazy counts read every
    row's leaf mid-growth), on data without a categorical feature (K3's
    route records carry no bitsets)."""
    L = params.num_leaves
    S = min(params.max_splits_per_round, max(L - 1, 1))
    return (params.route_fusion and params.hist_backend == "stream"
            and num_class == 1 and compact_rows > 0 and S >= 64
            and params.max_depth <= 0 and L <= 256 and params.cat is None
            and params.plain_growth and not params.forced)


# per-leaf fields of the growing trees: (dtype, initial value); each is a
# flat (K * L + 1) tensor whose last entry is a spare leaf, which takes the
# writes of a dead pair (a device-state round's split slot that no class
# fills) and of a link from a leaf without a parent
_I64, _F32 = torch.int64, torch.float32
# the output bound of an unconstrained leaf (reference: BIG, :421)
BIG = 1e30
_LEAF_FIELDS = {
    "split_feature": (_I64, 0), "threshold_bin": (_I64, 0),
    "dir_flags": (_I64, 0), "left_child": (_I64, 0),
    "right_child": (_I64, 0), "split_gain": (_F32, 0),
    "internal_value": (_F32, 0), "internal_weight": (_F32, 0),
    "internal_count": (_F32, 0), "sum_g": (_F32, 0), "sum_h": (_F32, 0),
    "cnt_leaf": (_F32, 0), "depth": (_I64, 0), "leaf_parent": (_I64, -1),
    "best_gain": (_F32, NEG_INF), "best_feat": (_I64, 0),
    "best_thr": (_I64, 0), "best_dir": (_I64, 0),
    "best_left_g": (_F32, 0), "best_left_h": (_F32, 0),
    "best_left_c": (_F32, 0), "out_lo": (_F32, -BIG), "out_hi": (_F32, BIG),
    "leaf_out": (_F32, 0)}


# the open end of a leaf's bin rectangle (reference: :817)
_RECT_OPEN = 2 ** 30
# elements of the largest temporary of one chunk of the slab computation
_SLAB_CHUNK_ELEMS = 1 << 25


def intermediate_monotone_bounds(anc_left, anc_right, node_mono, leaf_out,
                                 big: float = BIG):
    """Each leaf's (lo, hi) output bounds from its monotone ancestors and
    the actual outputs of the leaves on their other side (reference:
    intermediate_monotone_bounds, ops/grow.py:201-226): the dense form over
    every leaf.  The grower applies the method through the serial walk of
    each split (``_Grower._mono_pairs``), over the leaves each split can
    reach; on one feature, where every two leaves are comparable, a grown
    tree's outputs lie inside these bounds.  anc_left, anc_right: (L, L)
    bool, leaf row in the left or right subtree of node column; node_mono:
    (L,) int; leaf_out: (L,) float32."""
    out = leaf_out[:, None]
    lmax = torch.where(anc_left, out, -big).amax(dim=0)
    lmin = torch.where(anc_left, out, big).amin(dim=0)
    rmax = torch.where(anc_right, out, -big).amax(dim=0)
    rmin = torch.where(anc_right, out, big).amin(dim=0)
    inc = (node_mono > 0)[None, :]
    dec = (node_mono < 0)[None, :]
    hi = torch.minimum(torch.where(anc_left & inc, rmin[None, :], big),
                       torch.where(anc_right & dec, lmin[None, :], big)
                       ).amin(dim=1)
    lo = torch.maximum(torch.where(anc_right & inc, lmax[None, :], -big),
                       torch.where(anc_left & dec, rmax[None, :], -big)
                       ).amax(dim=1)
    return lo, hi


def advanced_constraint_slabs(anc_l, anc_r, node_mono, node_depth, node_feat,
                              node_thr, node_num, rect_lo, rect_hi, leaf_out,
                              bmax: int, big: float = BIG,
                              rows: Optional[torch.Tensor] = None):
    """The advanced method's (P, F, bmax) constraint slabs (reference:
    advanced_constraint_slabs, ops/grow.py:229-343): v_min[P, f, b] the
    largest output of the leaves that bound leaf P from below and whose
    interval on f covers bin b (-big where none), v_max the smallest of
    those bounding it from above (big where none).  A leaf Q bounds P
    through their lowest common ancestor, when it is a monotone numeric
    node recorded on P's path (no deeper node of P's path splits on its
    feature from the same side), Q lies across it and Q's rectangle meets
    every recorded plane of P's path below it.  anc_l, anc_r: (L, L) bool
    leaf row in the left or right subtree of node column; node_*: (L,) per
    node; rect_lo, rect_hi: (L, F) each leaf's bin rectangle [lo, hi);
    leaf_out: (L,) float32.  ``rows``: the leaves P to compute (all L by
    default).  The (P, Q, node) masks and the (P, Q, F, bmax) selections
    run in chunks of P, each at most ``_SLAB_CHUNK_ELEMS`` elements."""
    L, F = rect_lo.shape
    dev = anc_l.device
    if rows is None:
        rows = torch.arange(L, device=dev)
    anc = anc_l | anc_r
    same_feat = node_feat[:, None] == node_feat[None, :]       # (B', B)
    deeper = node_depth[:, None] > node_depth[None, :]         # (B', B)
    base = same_feat & deeper & node_num[:, None]              # (B', B)
    okR = rect_hi[:, node_feat] > (node_thr[None, :] + 1)      # (Q, B)
    okL = rect_lo[:, node_feat] <= node_thr[None, :]
    bb = torch.arange(bmax, device=dev)
    f_iota = torch.arange(F, device=dev)
    arQ = torch.arange(L, device=dev)
    out = leaf_out[None, :, None, None]
    chunk = max(1, _SLAB_CHUNK_ELEMS // max(L * max(L, F * bmax), 1))
    v_min, v_max = [], []
    for c0 in range(0, rows.shape[0], chunk):
        P = rows[c0:c0 + chunk]
        aP, arP = anc[P], anc_r[P]                             # (p, B)
        sides_eq = arP[:, :, None] == arP[:, None, :]          # (p, B', B)
        blocked = (aP[:, :, None] & base[None] & sides_eq).any(dim=1)
        recorded = aP & node_num[None, :] & ~blocked           # (p, B)
        common = aP[:, None, :] & anc[None, :, :]              # (p, Q, B)
        d_masked = torch.where(common, node_depth[None, None, :], -1)
        lca = d_masked.argmax(dim=2)                           # (p, Q)
        has_common = d_masked.amax(dim=2) >= 0
        lca_depth = node_depth[lca]
        rec_at = torch.gather(recorded, 1, lca)
        mono_at = node_mono[lca]
        sideP = torch.gather(arP, 1, lca)
        sideQ = anc_r[arQ[None, :], lca]
        opposite = sideP != sideQ
        upd_min = torch.where(mono_at > 0, sideP, ~sideP)
        ok2 = torch.where(arP[:, None, :], okR[None], okL[None])  # (p, Q, B)
        bad = (recorded[:, None, :]
               & (node_depth[None, None, :] > lca_depth[:, :, None])
               & ~ok2).any(dim=2)
        C = has_common & rec_at & (mono_at != 0) & opposite & ~bad
        # Q's slice of P's threshold axis on each feature: P's interval
        # widened one bin down, meeting Q's, whose bound facing the lowest
        # common ancestor's plane is dropped where that node splits on f
        thrA, featA, numA = node_thr[lca], node_feat[lca], node_num[lca]
        q_right = sideQ
        facing = ((f_iota[None, None, :] == featA[..., None])
                  & numA[..., None])                            # (p, Q, F)
        qlo = torch.where(facing & q_right[..., None]
                          & (rect_lo[None] == (thrA + 1)[..., None]),
                          -_RECT_OPEN, rect_lo[None])
        qhi = torch.where(facing & ~q_right[..., None]
                          & (rect_hi[None] == (thrA + 1)[..., None]),
                          _RECT_OPEN, rect_hi[None])
        lo_s = torch.maximum(rect_lo[P][:, None, :] - 1, qlo)
        hi_s = torch.minimum(rect_hi[P][:, None, :], qhi)
        inside = ((bb >= lo_s[..., None])
                  & (bb < hi_s[..., None]))                     # (p, Q, F, b)
        for sel, fill, acc, red in (
                (C & upd_min, -big, v_min, torch.amax),
                (C & ~upd_min, big, v_max, torch.amin)):
            vals = torch.where(sel[..., None, None] & inside, out,
                               torch.full((), fill, dtype=leaf_out.dtype,
                                          device=dev))
            acc.append(red(vals, dim=1))
    return torch.cat(v_min), torch.cat(v_max)


class _Grower:
    """The state of K class trees while they grow (K = 1: one tree):
    per-leaf sums, cached best splits and histograms, node arrays, and
    every row's leaf, each with a leading class axis.  The ``*_h`` tensors
    are the rows the histogram passes read: the compacted view of a sampled
    tree, else the full rows themselves (row-major bins for a single-class
    ``pallas`` tree).  K2 takes the class axis for any K; the non-stream
    backends run the single-class K5 or K6/K7 for one class and K8 for
    K.  ``gh_scales``: (K, 2) each class's quantized (grad, hess) scales,
    or None; with ``params.int_hist`` the ``*_h`` weights are then the int8
    grid values K2's int form reads (``wg``, ``wh``: the weights K2 reads,
    the int8 grid values or the float ``*_h`` rows).  ``monotone``: (F,)
    int64 signs under ``params.has_monotone``; ``interaction_groups``: (C,
    F) bool groups under ``params.has_interaction``; ``cegb``: the run's
    ``CegbState`` under ``params.has_cegb``.

    The per-leaf tensors are (K, L) views of flat (K * L + 1) tensors
    (``self.fl``) whose last entry is a spare leaf; a round writes the node
    and leaf entries of its splits through flat indices (``_split_pairs``),
    and every write it makes in place.  This eager grower keeps the
    schedule's counts (``cur``, ``progressed``, ``npos``, ``rounds``) on
    the host and reads one (K,) vector a round; ``_DeviceGrower`` keeps
    them on the device."""

    # a device-state grower writes its buffers in place (``_put``)
    persistent = False

    def __init__(self, bins_T, grad, hess, cnt, layout: FeatureLayout,
                 routing: RoutingLayout, params: GrowParams, max_bins: int,
                 timer=None, col_mask=None, compact_rows: int = 0,
                 bins=None, gh_scales=None, monotone=None,
                 interaction_groups=None, key=None, cegb=None):
        self._alloc(bins_T, grad.shape[0], layout, routing, params, max_bins,
                    timer, col_mask, compact_rows, monotone,
                    interaction_groups, key, cegb)
        self.records = []          # the rounds' route tables, when fused
        # per class on the host: leaves so far, whether the last round
        # split, splittable leaves, rounds that split
        self.cur = [1] * self.K
        self.progressed = [True] * self.K
        self.npos = [0] * self.K
        self.rounds = [0] * self.K
        # rounds run so far, which index the per-node draws (reference:
        # round_idx, :184)
        self.round_idx = 0
        self._setup_rows(grad, hess, cnt, gh_scales, bins)

    def _alloc(self, bins_T, K, layout, routing, params, max_bins, timer,
               col_mask, compact_rows, monotone=None, interaction_groups=None,
               key=None, cegb=None):
        """The per-leaf tensors, zeroed, and what does not change over a
        run."""
        self.bins_T = bins_T
        self.K = K
        self.stream = params.hist_backend == "stream"
        self.layout, self.routing, self.p = layout, routing, params
        self.Bmax = max_bins
        self.timer = timer
        self.col_mask = col_mask
        self.compact_rows = compact_rows
        self.compact = compact_rows > 0
        self.fuse = fusion_applies(params, compact_rows, K)
        dev = self.dev = bins_T.device
        L = self.L = params.num_leaves
        G, n = bins_T.shape
        KL = self.KL = K * L
        self.fl = {name: torch.full((KL + 1,), fill, dtype=dtype, device=dev)
                   for name, (dtype, fill) in _LEAF_FIELDS.items()}
        for name, t in self.fl.items():
            setattr(self, name, t[:KL].view(K, L))
        self.monotone = monotone if params.has_monotone else None
        self.groups = interaction_groups if params.has_interaction else None
        # outputs fixed at split time (reference: use_output, :427)
        self.use_output = (self.monotone is not None
                           or params.path_smooth > 0.0)
        self.pen_table = (penalty_table(params.monotone_penalty, dev)
                          if self.monotone is not None
                          and params.monotone_penalty > 0.0 else None)
        F = layout.num_bins.shape[0]
        if self.groups is not None:
            # each leaf's path features
            self.used_feat_f = torch.zeros((KL + 1, F), dtype=torch.bool,
                                           device=dev)
        # the key of the per-node draws: two Python ints, or two 0-d device
        # tensors a fused iteration fills
        self.key = key
        self.bynode = params.bynode_fraction < 1.0 and key is not None
        # float32, as the reference's weakly typed product takes it
        self.bynode_frac = torch.full((), params.bynode_fraction,
                                      dtype=_F32, device=dev)
        self.extra = params.extra_trees and key is not None
        self.imono = (self.monotone is not None
                      and params.monotone_intermediate)
        self.amono = self.imono and params.monotone_advanced
        if self.imono:
            if K != 1:
                raise ValueError("the intermediate and advanced monotone "
                                 "methods grow one class tree at a time")
            # leaf rows x node columns (reference: :164-182, :816-826)
            n1 = KL + 1
            self.anc_l = torch.zeros((n1, n1), dtype=torch.bool, device=dev)
            self.anc_r = torch.zeros_like(self.anc_l)
            self.node_mono = torch.zeros(n1, dtype=_I64, device=dev)
            self.node_depth = torch.zeros(n1, dtype=_I64, device=dev)
            self.rect_lo = torch.zeros((n1, F), dtype=_I64, device=dev)
            self.rect_hi = torch.full((n1, F), _RECT_OPEN, dtype=_I64,
                                      device=dev)
            self.in_mono = torch.zeros(n1, dtype=torch.bool, device=dev)
            self._true = torch.ones(1, dtype=torch.bool, device=dev)
            if self.amono:
                self.adv_vmin = torch.full((n1, F, max_bins), -BIG,
                                           dtype=_F32, device=dev)
                self.adv_vmax = torch.full((n1, F, max_bins), BIG,
                                           dtype=_F32, device=dev)
                self.adv_ok = torch.ones((n1, F), dtype=torch.bool,
                                         device=dev)
        self.cegb = cegb if params.has_cegb else None
        if K != 1 and (self.cegb is not None or params.forced):
            raise ValueError("CEGB and forced splits grow one class tree "
                             "at a time")
        if self.cegb is not None:
            # the features used so far, this tree's splits included
            self.cegb_used = self.cegb.used.clone()
        # each forced level's (leaves, features, threshold bins, direction
        # flags, classes, ranks), made once: a tensor made from Python
        # values inside a captured round would be a host copy
        self.forced = []
        for leaves, feats, thrs, dls in params.forced:
            t = [torch.tensor(v, dtype=_I64, device=dev) for v in (
                leaves, feats, thrs,
                [DIR_DEFAULT_LEFT if d else 0 for d in dls])]
            nf = len(leaves)
            self.forced.append((*t, torch.zeros(nf, dtype=_I64, device=dev),
                                torch.arange(nf, device=dev)))
        self.hist_f = torch.zeros((KL + 1, G, max_bins, 2), dtype=_F32,
                                  device=dev)
        self.hist = self.hist_f[:KL].view(K, L, G, max_bins, 2)
        self.cat = params.cat
        # the left bins of each node's categorical split, and of each
        # leaf's split of the round as the words K2 reads
        self.cat_bitset_f = torch.zeros((KL + 1, max_bins), dtype=torch.bool,
                                        device=dev)
        self.cat_bitset = self.cat_bitset_f[:KL].view(K, L, max_bins)
        # words for the categorical features' bins only (EFB never
        # bundles a categorical feature, so no wide bundle sizes them;
        # without their count, for Bmax)
        cat_bins = ((params.cat_bins or max_bins)
                    if params.cat is not None else 0)
        W = max(-(-cat_bins // 32), 1)
        self.cat_words_f = torch.zeros((KL + 1, W), dtype=torch.int32,
                                       device=dev)
        self.cat_words = self.cat_words_f[:KL].view(K, L, W)
        self.leaf_id = torch.zeros((K, n), dtype=torch.int32, device=dev)
        if self.compact and self.stream:
            # the compacted rows' leaves
            self.leaf_id_h = torch.zeros((K, compact_rows),
                                         dtype=torch.int32, device=dev)
        # offset of class k's leaves in the flattened (K * L) leaf axis
        self.class_base = torch.arange(K, device=dev)[:, None] * L

    def _put(self, name, value):
        """Bind attribute ``name`` to ``value``; a device-state grower
        copies it into the tensor already bound there, whose address its
        captured graphs hold."""
        old = getattr(self, name, None)
        if self.persistent and old is not None:
            old.copy_(value)
        else:
            setattr(self, name, value)

    def _setup_rows(self, grad, hess, cnt, gh_scales, bins=None):
        """The rows every histogram pass of the tree reads, and the
        fixed-point shifts or int scales."""
        p, timer, K = self.p, self.timer, self.K
        bins_T = self.bins_T
        self._put("grad", grad)
        self._put("hess", hess)
        self._put("cnt", cnt)
        grad, hess, cnt = self.grad, self.hess, self.cnt
        if not self.stream:
            self.rows = torch.arange(bins_T.shape[1], device=self.dev)
            if self.compact:
                check_compact_supported(p.hist_backend)
                with phase(timer, "compact"):
                    (self.bins_h, self.grad_h, self.hess_h, self.cnt_h,
                     self.c_perm) = compact_row_views(
                         bins_T, grad, hess, cnt, self.compact_rows)
            else:
                # K6/K7 read the (N, G) rows; K5 and K8 the (G, N) layout
                self.bins_h = (bins if p.hist_backend == "pallas"
                               and K == 1 else bins_T)
                self.grad_h, self.hess_h, self.cnt_h = grad, hess, cnt
        elif self.compact:
            with phase(timer, "compact"):
                plan = plan_sample_rows(cnt, self.compact_rows)
                bins_h, g, h, cnt_h = compact_transposed_view(
                    bins_T, plan.perm, grad, hess, cnt)
            self._put("bins_h", bins_h)
            self._put("cnt_h", cnt_h)
            self._put("grad_h", g)
            self._put("hess_h", h)
        else:
            self.bins_h, self.grad_h, self.hess_h, self.cnt_h = \
                bins_T, grad, hess, cnt
            self.leaf_id_h = self.leaf_id
        self.use_int = (self.stream and p.int_hist
                        and gh_scales is not None)
        if self.use_int:
            # the rows' integer grid values for K2's int form (reference:
            # ops/grow.py:592-594), exact: round(q * scale * (1 / scale))
            # is q for every |q| <= 127
            self._put("gh_scales", gh_scales)
            inv = 1.0 / torch.clamp(self.gh_scales, min=1e-30)
            self._put("grad_q", torch.round(self.grad_h * inv[:, 0:1]).to(
                torch.int8))
            self._put("hess_q", torch.round(self.hess_h * inv[:, 1:2]).to(
                torch.int8))
            self.wg, self.wh = self.grad_q, self.hess_q
            self.hscale = self.gh_scales[:, None, None, None, :]
            self.shifts = self.scales = None
        else:
            self.wg, self.wh = self.grad_h, self.hess_h
            # one fixed-point scale per class tree, from all N rows, so
            # that the compacted and the full passes quantize alike
            m = torch.maximum(grad.abs().amax(dim=1), hess.abs().amax(dim=1))
            self._set_shifts(m)

    def _set_shifts(self, m):
        """Every class's shift from its largest weight, in one read."""
        n = self.bins_T.shape[1]
        self.shifts = tuple(hist_shift(v, n)
                            for v in host_list(m, self.timer))
        self.scales = scale_table(self.shifts, self.dev)

    def _round_key(self, offset: int):
        """The key of this round's draws, ``fold_in(key, offset +
        round_idx)`` (reference: :1462, :1482)."""
        return fold_in(self.key, offset + self.round_idx)

    def find_splits(self, hist, g, h, c, ids, rows=None, root=False):
        """Best splits of the leaves at flat (K * L) positions ``ids``, whose
        (R, G, Bmax, 2) histograms and (R,) sums are given, under their
        constraints.  ``rows``: (R,) each leaf's row in the reference's
        draws of the round (the per-node draws); ``root``: the root's scan,
        whose draws take their own keys (reference: :767-796)."""
        p = self.p
        with phase(self.timer, "split_scan"):
            col_mask, kw = self.col_mask, {}
            if self.groups is not None or self.bynode:
                bkey = None
                if self.bynode:
                    bkey = (fold_in(self.key, 0) if root
                            else self._round_key(2))
                col_mask = self._node_col_mask(ids, rows, bkey)
            if self.extra:
                kw.update(extra_key=(fold_in(self.key, 1) if root
                                     else self._round_key(100000)),
                          draw_rows=rows)
            if self.amono:
                kw["adv_bounds"] = (self.adv_vmin[ids], self.adv_vmax[ids])
                if not root:
                    kw["splittable"] = self.adv_ok[ids]
            if self.cegb is not None:
                kw["cegb_penalty"] = self._cegb_penalty(c, ids)
            if self.use_output:
                fl = self.fl
                kw.update(out_lo=fl["out_lo"][ids], out_hi=fl["out_hi"][ids],
                          parent_out=fl["leaf_out"][ids],
                          path_smooth=p.path_smooth)
                if self.monotone is not None:
                    kw["monotone"] = self.monotone
                if self.pen_table is not None:
                    kw["slot_penalty"] = self.pen_table[torch.clamp(
                        fl["depth"][ids], max=self.pen_table.shape[0] - 1)]
            return find_best_splits(
                hist, g, h, c, self.layout, p.lambda_l1, p.lambda_l2,
                max(p.min_data_in_leaf, 1), p.min_sum_hessian_in_leaf,
                p.min_gain_to_split, p.max_delta_step, col_mask,
                self.cat, **kw)

    def _cegb_penalty(self, c, ids):
        """(R, F) CEGB's cost of splitting each leaf at flat positions
        ``ids`` on each feature, the leaves' (R,) counts ``c`` (reference:
        cegb_pen, :444-455): tradeoff * (penalty_split * count + coupled[f]
        while f is unused + lazy[f] * the leaf's rows not yet charged for
        f), in the reference's operation order."""
        p, cg = self.p, self.cegb
        F = self.cegb_used.shape[0]
        pen = (p.cegb_tradeoff * p.cegb_penalty_split) * c[:, None]
        if cg.coupled is not None:
            pen = pen + p.cegb_tradeoff * cg.coupled[None, :] * \
                (~self.cegb_used)[None, :]
        if cg.lazy is not None:
            pen = pen + p.cegb_tradeoff * cg.lazy_pen[None, :] * \
                self._lazy_unused(ids)
        return pen.expand(ids.shape[0], F)

    def _lazy_unused(self, ids):
        """(R, F) float32: the rows of each leaf at flat positions ``ids``
        not yet charged for each feature (reference: lazy_unused_counts,
        :457-464), over every row's current leaf: exact integer counts."""
        R = ids.shape[0]
        slot_of = torch.full((self.KL + 1,), R, dtype=_I64, device=self.dev)
        slot_of[ids] = torch.arange(R, device=self.dev)
        slot = slot_of[self._flat_leaf()[0]]
        lazy = self.cegb.lazy
        counts = torch.zeros((R + 1, lazy.shape[1]), dtype=torch.int32,
                             device=self.dev)
        counts.index_add_(0, slot, (~lazy).to(torch.int32))
        return counts[:R].to(_F32)

    def _cegb_mark(self, feat, chosen, lfeat):
        """A round's splits in CEGB's state, before any row moves
        (reference: :1391-1405): their features used, and every row of a
        split leaf charged for its split feature."""
        self.cegb_used.index_fill_(0, feat, True)
        lazy = self.cegb.lazy
        if lazy is not None:
            lid = self._flat_leaf()[0]
            f_iota = torch.arange(lazy.shape[1], device=self.dev)
            lazy |= ((f_iota[None, :] == lfeat[lid][:, None])
                     & (chosen[lid] > 0)[:, None])

    def _forced_left(self, fo, feat, thr, dirf, pg, ph, pc):
        """(lg, lh, lc) of forced splits (reference: :885-902): the left
        sums from each split leaf's cached histogram, the bins up to the
        threshold and, on the default-left side, the NaN bin, added in
        float64 and rounded once; the count estimated from them."""
        hf = gather_feature_histograms(self.hist_f[fo], self.layout, pg, ph)
        hsel = hf[torch.arange(fo.shape[0], device=self.dev), feat]
        b = torch.arange(self.Bmax, device=self.dev)[None, :]
        nanb = self.routing.nan_bin[feat].to(_I64)[:, None]
        at_nan = (nanb >= 0) & (b == nanb)
        take = (((b <= thr[:, None]) & ~at_nan)
                | (at_nan & (dirf[:, None] == DIR_DEFAULT_LEFT)))
        lg, lh = (torch.where(take, hsel[..., i], 0.0).double().sum(dim=1)
                  .to(_F32) for i in (0, 1))
        lc = round_int(lh * pc / torch.clamp(ph, min=EPS_HESS))
        return lg, lh, lc

    def _node_col_mask(self, ids, rows, bkey):
        """(R, F) the features each leaf at flat positions ``ids`` may split
        on (reference: node_col_mask, :466-487): the tree's feature sample,
        the union of the interaction groups that hold every feature of the
        leaf's path, and by-node sampling: of the features left,
        ceil(fraction * count), at least one, those of the largest
        ``uniform(bkey)`` draws in row ``rows[i]`` of the reference's (R,
        F) draw, taken by a stable double argsort."""
        F = self.layout.num_bins.shape[0]
        m = torch.ones((ids.shape[0], F), dtype=torch.bool, device=self.dev)
        if self.col_mask is not None:
            m = m & self.col_mask[None, :]
        if self.groups is not None:
            g = self.groups
            used = self.used_feat_f[ids]
            contains = ~(used[:, None, :] & ~g[None]).any(dim=-1)  # (R, C)
            m = m & (contains[:, :, None] & g[None]).any(dim=1)    # (R, F)
        if self.bynode:
            u = torch.where(m, uniform_rows(bkey, rows, F), -1.0)
            avail = m.sum(dim=1, keepdim=True).to(_F32)
            kcnt = torch.clamp(torch.ceil(self.bynode_frac * avail),
                               min=1.0).to(_I64)
            order = torch.argsort(-u, dim=1, stable=True)
            rank = torch.argsort(order, dim=1)
            m = m & (rank < kcnt)
        return m

    def _k2(self, bins_T, leaf_id, tabs, grad, hess, cnt, num_slots,
            with_hist):
        """K2 with the trees' bitsets, shifts and scale table; under the
        int form its int32 histograms unscaled to float32 (reference:
        ops/grow.py:1010-1011, :2116-2118)."""
        if not self.use_int:
            return route_and_hist(bins_T, leaf_id, tabs, self.cat_words,
                                  grad, hess, cnt, num_slots, self.Bmax,
                                  self.shifts, with_hist, self.scales)
        new_leaf, hist, counts = route_and_hist_int(
            bins_T, leaf_id, tabs, self.cat_words, grad, hess, cnt,
            num_slots, self.Bmax, with_hist)
        if hist is not None:
            hist = hist.to(torch.float32) * self.hscale
        return new_leaf, hist, counts

    def k2(self, tabs, num_slots, with_hist):
        """The round's K2 pass over the histogram rows; for a compacted
        tree also every row's route (a route-only pass, or the tables kept
        for the replay).  Returns the pass's (K, S, ...) histograms and
        (K, S) counts."""
        with phase(self.timer, "k2"):
            new_leaf, hist, counts = self._k2(
                self.bins_h, self.leaf_id_h, tabs, self.wg, self.wh,
                self.cnt_h, num_slots, with_hist)
        if self.compact and self.fuse:
            self._keep_record(tabs[0])
        elif self.compact:
            # a route-only pass reads no weights (the int form takes none)
            w = (None, None) if self.use_int else (self.grad, self.hess)
            with phase(self.timer, "k2"):
                full, _, _ = self._k2(self.bins_T, self.leaf_id, tabs, *w,
                                      self.cnt, num_slots, False)
            self.leaf_id.copy_(full)
        self.leaf_id_h.copy_(new_leaf)
        return hist, counts

    def _keep_record(self, tab):
        self.records.append(tab)

    def replay(self):
        """Every row's leaf from the kept route tables (K3), once per fused
        tree that made a split."""
        if self.fuse and self.records:
            with phase(self.timer, "k3"):
                self.leaf_id.copy_(route_replay(
                    self.bins_T, torch.stack(self.records))[None])

    def _splittable(self):
        """(K,) each class's leaves whose cached split can be taken."""
        p = self.p
        cand = self.best_gain > 0
        if p.max_depth > 0:
            cand = cand & (self.depth < p.max_depth)
        return cand.sum(dim=1)

    def count_splittable(self):
        with phase(self.timer, "host_sync"):
            self.npos = host_list(self._splittable(), self.timer)

    def histograms(self, slot, num_slots: int):
        """The non-stream backend's (K, S, G, Bmax, 3) histograms of the
        histogram rows' (K, N) slots (None: every row in slot 0)."""
        p = self.p
        with phase(self.timer, "hist"):
            if self.K == 1:
                # the single-class K5 or K6/K7
                return build_histograms(
                    self.bins_h, None if slot is None else slot[0],
                    self.grad_h[0], self.hess_h[0], self.cnt_h, num_slots,
                    self.Bmax, self.shifts[0], p.hist_backend)[None]
            if slot is None:
                slot = torch.zeros((self.K, self.bins_h.shape[1]),
                                   dtype=torch.int32, device=self.dev)
            return build_histograms_k(self.bins_h, slot, self.grad_h,
                                      self.hess_h, self.cnt_h, self.K,
                                      num_slots, self.Bmax, self.shifts,
                                      p.hist_backend, self.scales)

    def root(self):
        K, L, dev = self.K, self.L, self.dev
        G = self.bins_T.shape[0]
        if self.stream:
            zL = torch.zeros((K, L), dtype=torch.int64, device=dev)
            keep = torch.full((K, L), -1, dtype=torch.int64, device=dev)
            keep[:, 0] = 0
            tabs0 = build_route_tables(zL, zL, zL, zL, zL, keep, keep, keep,
                                       self.routing)
            with phase(self.timer, "k2"):
                _, root_hist, _ = self._k2(
                    self.bins_h, self.leaf_id_h, tabs0, self.wg, self.wh,
                    self.cnt_h, 1, True)
            root_hist = root_hist[:, 0]
        else:
            root_hist = self.histograms(None, 1)[:, 0, ..., :2]
        # root totals of all N rows in float64, rounded once: the same on
        # every device, at every compaction capacity, and for a class
        # whether it grows alone or with the others
        g = torch.stack([x.double().sum().float() for x in self.grad])
        h = torch.stack([x.double().sum().float() for x in self.hess])
        c = self.cnt.double().sum().float().expand(K)
        if self.use_output:
            p = self.p
            self.leaf_out[:, 0] = leaf_output(g, h, p.lambda_l1, p.lambda_l2,
                                              p.max_delta_step)
        ids = self.class_base[:, 0]
        res = self.find_splits(root_hist.reshape(K, G, self.Bmax, 2), g, h, c,
                               ids, torch.zeros_like(ids), root=True)
        self.hist[:, 0] = root_hist
        self.sum_g[:, 0], self.sum_h[:, 0], self.cnt_leaf[:, 0] = g, h, c
        self._store_best(ids, res)
        if self.amono:
            self.adv_ok[0] = res.feat_ok[0]
        self.count_splittable()

    def _store_best(self, ids, res):
        """Best splits of the leaves at flat (K * L) positions ``ids``."""
        for name, v in (("best_gain", res.gain), ("best_feat", res.feature),
                        ("best_thr", res.threshold),
                        ("best_dir", res.dir_flags),
                        ("best_left_g", res.left_sum_g),
                        ("best_left_h", res.left_sum_h),
                        ("best_left_c", res.left_count)):
            self.fl[name][ids] = v

    def _can_finish(self, c: int, sprint: int) -> bool:
        """Class c can make its remaining splits in one route-only round of
        ``sprint`` splits."""
        remaining = self.L - self.cur[c]
        return remaining <= sprint and remaining <= self.npos[c]

    def round(self, budget: int, with_hist: bool = True,
              freeze_sprint: Optional[int] = None):
        """One round splitting up to ``budget`` leaves of each class
        (reference: the body of make_body / make_body_k, stream branch).  A
        class whose own loop would have stopped (no progress, its leaf
        budget reached or, with ``freeze_sprint``, ready for a sprint of
        that many splits) takes no split."""
        L, K = self.L, self.K
        ksp = []
        for c in range(K):
            active = self.progressed[c] and self.cur[c] < L and not (
                freeze_sprint is not None
                and self._can_finish(c, freeze_sprint))
            k = min(L - self.cur[c], budget, self.npos[c]) if active else 0
            if active and k <= 0:
                self.progressed[c] = False
            ksp.append(k)
        if sum(ksp) == 0:
            self.round_idx += 1
            return
        with phase(self.timer, "other"):
            cls, rank, new = _pair_index(ksp, self.cur, self.dev)
        # the leaves after the round: what the rescan and the slab refresh
        # of the monotone methods read (one class tree)
        span = self.cur[0] + ksp[0] if self.imono else None
        self._split_pairs(cls, rank, new, None, max(ksp), with_hist, budget,
                          span)
        self.round_idx += 1
        for c in range(K):
            self.rounds[c] += ksp[c] > 0
            self.cur[c] += ksp[c]
        if with_hist:
            self.count_splittable()

    def forced_round(self, level):
        """One forced level: its pairs split their static leaves at their
        forced bins (reference: make_body's forced branch, :866-902), a
        round of as many K2 slots as the level has splits."""
        nf = level[0].shape[0]
        with phase(self.timer, "other"):
            cls, rank, new = _pair_index([nf], self.cur, self.dev)
        span = self.cur[0] + nf if self.imono else None
        self._split_pairs(cls, rank, new, None, nf, True, nf, span,
                          forced=level[:4])
        self.round_idx += 1
        self.rounds[0] += 1
        self.cur[0] += nf
        self.count_splittable()

    def _split_pairs(self, cls, rank, new, live, num_slots: int,
                     with_hist: bool, budget: int,
                     span: Optional[int] = None, forced=None):
        """The splits of one round, class-major pairs: pair i splits the
        rank[i]-th leaf by cached gain of class cls[i] into it and leaf
        new[i].  ``live``: None (every pair splits), or (P,) bool, and a
        dead pair's writes all go to the spare leaf.  Routes every row,
        builds the histograms of the smaller children in slot rank[i] of
        their class (``num_slots`` slots a class), subtracts the larger
        siblings' and scans the children for their best splits; under the
        intermediate monotone method, every leaf, the children and the
        leaves whose bounds the round tightened taking their results.
        ``budget``: the round's split budget, which places the children in
        the rows of the reference's per-node draws (pair i's split leaf in
        row i, its new leaf in row ``budget + i``; under the intermediate
        method leaf j in row j).  ``span``: under the intermediate method,
        a bound on the leaves after the round (every leaf by default); the
        rescan and the slab refresh read those only.  ``forced``: a forced
        level's (leaves, features, threshold bins, direction flags), which
        pair i splits in place of the rank[i]-th leaf by cached gain."""
        p, L, dev, K = self.p, self.L, self.dev, self.K
        G = self.bins_T.shape[0]
        KL = self.KL
        fl = self.fl
        with phase(self.timer, "other"):
            if forced is None:
                cand = torch.where(self.best_gain > 0, self.best_gain,
                                   NEG_INF)
                if p.max_depth > 0:
                    cand = torch.where(self.depth < p.max_depth, cand,
                                       NEG_INF)
                order = torch.argsort(-cand, dim=1, stable=True)
                # split i of class c takes its rank-th leaf and makes leaf
                # cur[c] + rank
                old = order[cls, rank]
            else:
                old = forced[0]
            base = cls * L
            node = new - 1
            fo, fn, fnode = base + old, base + new, base + node
            if live is not None:
                fo, fn, fnode = (torch.where(live, x, KL)
                                 for x in (fo, fn, fnode))
            if forced is None:
                (feat, thr, dirf, gain, pg, ph, pc, lg, lh, lc) = (
                    fl[name][fo] for name in (
                        "best_feat", "best_thr", "best_dir", "best_gain",
                        "sum_g", "sum_h", "cnt_leaf", "best_left_g",
                        "best_left_h", "best_left_c"))
            else:
                feat, thr, dirf = forced[1:4]
                pg, ph, pc = (fl[name][fo]
                              for name in ("sum_g", "sum_h", "cnt_leaf"))
                lg, lh, lc = self._forced_left(fo, feat, thr, dirf, pg, ph,
                                               pc)
                gain = torch.zeros_like(pg)
            rg, rh, rc = pg - lg, ph - lh, pc - lc
            parent_hist = self.hist_f[fo] if with_hist else None

            # node arrays, then the link from the split leaf's parent node
            fl["split_feature"][fnode] = feat
            fl["threshold_bin"][fnode] = thr
            fl["dir_flags"][fnode] = dirf
            fl["split_gain"][fnode] = gain
            fl["internal_value"][fnode] = leaf_output(
                pg, ph, p.lambda_l1, p.lambda_l2, p.max_delta_step)
            fl["internal_weight"][fnode] = ph
            fl["internal_count"][fnode] = pc
            fl["left_child"][fnode] = ~old
            fl["right_child"][fnode] = ~new
            parent = fl["leaf_parent"][fo]
            has_p = parent >= 0
            if live is not None:
                has_p = has_p & live
            pidx = torch.where(has_p, base + torch.clamp(parent, min=0), KL)
            was_left = (fl["left_child"][pidx] == ~old) & has_p
            # links without a parent write to the spare leaf
            fl["left_child"][torch.where(was_left, pidx, KL)] = node
            fl["right_child"][torch.where(has_p & ~was_left, pidx, KL)] = node
            fl["leaf_parent"][fo] = node
            fl["leaf_parent"][fn] = node

            # the smaller child of split i fills histogram slot rank[i] of
            # its class
            smaller_is_left = lc <= rc
            zi = torch.zeros(KL + 1, dtype=torch.int64, device=dev)
            chosen, new_id, lfeat, lthr, ldir = (zi.clone() for _ in range(5))
            # (an index fill: a scalar put would copy from the host)
            chosen.index_fill_(0, fo, 1)
            new_id[fo] = new
            lfeat[fo] = feat
            lthr[fo] = thr
            ldir[fo] = dirf
            if self.cegb is not None:
                self._cegb_mark(feat, chosen, lfeat)
            if self.stream:
                slot_l = torch.full((KL + 1,), -1, dtype=torch.int64,
                                    device=dev)
                slot_r, slot_keep = slot_l.clone(), slot_l.clone()
                slot_l[fo] = torch.where(smaller_is_left, rank, -1)
                slot_r[fo] = torch.where(smaller_is_left, -1, rank)
                tabs = build_route_tables(
                    *(x[:KL].view(K, L) for x in (chosen, new_id, lfeat,
                                                  lthr, ldir, slot_l, slot_r,
                                                  slot_keep)),
                    self.routing)
        bits = None
        if self.cat is not None:
            bits = self._cat_bits(fo, fnode, feat, thr, dirf, pg, ph, pc)
        if self.stream:
            hist_k, cnt_k = self.k2(tabs, num_slots, with_hist)
        else:
            lbits = None
            if bits is not None:
                lbits = torch.zeros((KL + 1, self.Bmax), dtype=torch.bool,
                                    device=dev)
                lbits[fo] = bits
            self.route_rows(chosen, new_id, lfeat, lthr, ldir, lbits)
            with phase(self.timer, "other"):
                slot_map = torch.full((KL + 1,), -1, dtype=torch.int32,
                                      device=dev)
                slot_map[torch.where(smaller_is_left, fo, fn)] = \
                    rank.to(torch.int32)
                slot = slot_map[self._flat_leaf()]
                if self.compact:
                    slot = slot[:, self.c_perm]
            hist3 = self.histograms(slot, num_slots)
            hist_k = hist3[..., :2]
            # any one group's bins partition a slot's rows, so group 0's
            # count channel sums to the slot's exact row count
            cnt_k = hist3[:, :, 0, :, 2].sum(dim=-1)
        hist_small = None if hist_k is None else hist_k[cls, rank]
        slot_cnt = cnt_k[cls, rank]
        with phase(self.timer, "other"):
            # exact child counts from the routed rows (reference:
            # serial_tree_learner.cpp:798)
            lc_x = torch.where(smaller_is_left, slot_cnt, pc - slot_cnt)
            rc_x = pc - lc_x
            fl["sum_g"][fo], fl["sum_g"][fn] = lg, rg
            fl["sum_h"][fo], fl["sum_h"][fn] = lh, rh
            fl["cnt_leaf"][fo] = lc_x
            fl["cnt_leaf"][fn] = rc_x
            d = fl["depth"][fo] + 1
            fl["depth"][fn] = d
            fl["depth"][fo] = d
            if self.use_output and not self.imono:
                self._bound_children(fo, fn, feat, dirf, lg, lh, lc, rg, rh,
                                     rc)
            if self.groups is not None:
                F = self.used_feat_f.shape[1]
                used = self.used_feat_f[fo] | (
                    torch.arange(F, device=dev)[None, :] == feat[:, None])
                self.used_feat_f[fo] = used
                self.used_feat_f[fn] = used
        span = KL if span is None else span
        if self.imono:
            self._mono_pairs(fo, fn, fnode, live, feat, thr, dirf, lg, lh, lc,
                             rg, rh, rc, d - 1, with_hist, span)
        if not with_hist:
            return
        with phase(self.timer, "other"):
            smaller = torch.where(smaller_is_left, fo, fn)
            larger = torch.where(smaller_is_left, fn, fo)
            hf = self.hist_f
            hf[smaller] = hist_small
            hf[larger] = hist_subtract(parent_hist, hist_small)
            if self.imono:
                # every leaf rescans; the children and the leaves whose
                # bounds tightened take the results (reference: :1425-1511)
                ids2 = rows = torch.arange(span, device=dev)
                if self.amono:
                    # fresh children inherit the parent's feature flags
                    self.adv_ok[fn] = self.adv_ok[fo]
                child = torch.zeros(KL + 1, dtype=torch.bool, device=dev)
                child.index_fill_(0, fo, True)
                child.index_fill_(0, fn, True)
                valid2 = (child | self.mono_changed)[:span]
            else:
                ids2 = torch.cat([fo, fn])
                ar = torch.arange(fo.shape[0], device=dev)
                rows = torch.cat([ar, ar + budget])
        res = self.find_splits(hf[ids2], fl["sum_g"][ids2],
                               fl["sum_h"][ids2], fl["cnt_leaf"][ids2], ids2,
                               rows)
        with phase(self.timer, "other"):
            if self.imono:
                self._store_best(torch.where(valid2, ids2, KL), res)
                if self.amono:
                    # the flags refresh where a leaf rescanned
                    self.adv_ok[:span] = torch.where(valid2[:, None],
                                                     res.feat_ok,
                                                     self.adv_ok[:span])
            else:
                self._store_best(ids2, res)

    def _mono_pairs(self, fo, fn, fnode, live, feat, thr, dirf, lg, lh, lc,
                    rg, rh, rc, depth_o, with_hist: bool, span: int):
        """The intermediate (and advanced) method's update of a round's
        splits, one pair after another in the round's best-gain order, as
        the reference applies them (``_one_split``, ops/grow.py:1109-1340):
        each pair's constrained child outputs, its children's bound entries
        tightened with the actual outputs, the leaves across its monotone
        ancestors whose bounds those outputs tighten, the ancestry and
        bin-rectangle writes and, under the advanced method, the children's
        slabs cloned and clamped; then the advanced method's slabs of the
        flagged leaves recomputed, min before max (:1344-1359).  Sets
        ``mono_changed`` (KL + 1,) the leaves whose bounds changed.  A dead
        pair (``live``) writes the spare leaf only."""
        p, fl, dev = self.p, self.fl, self.dev
        lo_v, hi_v, lov = fl["out_lo"], fl["out_hi"], fl["leaf_out"]
        n1 = lo_v.shape[0]
        is_num = (dirf & DIR_CATEGORICAL) == 0
        m_split = torch.where(is_num, self.monotone[feat], 0)
        node_num = (fl["dir_flags"] & DIR_CATEGORICAL) == 0
        # the walk reads the bests cached before the round
        splittable = fl["best_gain"] > NEG_INF / 2
        chg_min = torch.zeros(n1, dtype=torch.bool, device=dev)
        chg_max = torch.zeros_like(chg_min)
        with phase(self.timer, "mono_pairs"):
            if self.amono:
                adv_out = self._adv_child_outputs(fo, feat, thr, dirf, lg,
                                                  lh, lc, rg, rh, rc)
            for i in range(fo.shape[0]):
                sl = slice(i, i + 1)
                o, nw, nd = fo[sl], fn[sl], fnode[sl]
                sf, stb, isn, ms = feat[sl], thr[sl], is_num[sl], m_split[sl]
                lo_o, hi_o = lo_v[o], hi_v[o]
                if self.amono:
                    ol, orr = adv_out[0][sl], adv_out[1][sl]
                else:
                    ol, orr = constrained_child_outputs(
                        lg[sl], lh[sl], lc[sl], rg[sl], rh[sl], rc[sl],
                        p.lambda_l1, p.lambda_l2, lo_o, hi_o, p.path_smooth,
                        lov[o], p.max_delta_step)
                lov[o] = ol
                lov[nw] = orr
                anc_o_l, anc_o_r = self.anc_l[o][0], self.anc_r[o][0]
                flag = (ms != 0) | self.in_mono[o]
                inc = flag & isn & (ms > 0)
                dec = flag & isn & (ms < 0)
                lo_v[o] = torch.where(dec, torch.maximum(lo_o, orr), lo_o)
                hi_v[o] = torch.where(inc, torch.minimum(hi_o, orr), hi_o)
                lo_v[nw] = torch.where(inc, torch.maximum(lo_o, ol), lo_o)
                hi_v[nw] = torch.where(dec, torch.minimum(hi_o, ol), hi_o)
                self._walk(anc_o_l, anc_o_r, flag if live is None
                           else flag & live[sl], sf, stb, isn, ol, orr,
                           node_num, splittable, chg_min, chg_max)
                # ancestry, node and rectangle bookkeeping
                self.anc_l[nw] = anc_o_l[None]
                self.anc_r[nw] = anc_o_r[None]
                self.anc_l.index_put_((o, nd), self._true)
                self.anc_r.index_put_((nw, nd), self._true)
                self.node_mono[nd] = ms
                self.node_depth[nd] = depth_o[sl]
                self.rect_lo[nw] = self.rect_lo[o]
                self.rect_hi[nw] = self.rect_hi[o]
                r_hi, r_lo = self.rect_hi[o, sf], self.rect_lo[o, sf]
                self.rect_hi.index_put_((o, sf), torch.where(
                    isn, torch.minimum(r_hi, stb + 1), r_hi))
                self.rect_lo.index_put_((nw, sf), torch.where(
                    isn, torch.maximum(r_lo, stb + 1), r_lo))
                self.in_mono[o] = flag
                self.in_mono[nw] = flag
                if self.amono:
                    # the new leaf clones the split leaf's slabs, then both
                    # take the split's clamp on every (feature, bin)
                    vn, vx = self.adv_vmin, self.adv_vmax
                    vn[nw] = vn[o]
                    vx[nw] = vx[o]
                    i3, d3 = inc[:, None, None], dec[:, None, None]
                    ol3, or3 = ol[:, None, None], orr[:, None, None]
                    vx[o] = torch.where(i3, torch.minimum(vx[o], or3), vx[o])
                    vn[o] = torch.where(d3, torch.maximum(vn[o], or3), vn[o])
                    vn[nw] = torch.where(i3, torch.maximum(vn[nw], ol3),
                                         vn[nw])
                    vx[nw] = torch.where(d3, torch.minimum(vx[nw], ol3),
                                         vx[nw])
        if self.amono and with_hist:
            with phase(self.timer, "mono_slabs"):
                self._refresh_slabs(chg_min, chg_max & ~chg_min, node_num,
                                    span)
        self.mono_changed = chg_min | chg_max

    def _adv_child_outputs(self, fo, feat, thr, dirf, lg, lh, lc, rg, rh,
                           rc):
        """(P,) each pair's child outputs under the bounds its winning scan
        used, from the split leaf's slabs on the split feature before the
        round (reference: :1129-1168): the reverse scan's running and
        suffix extrema at the threshold; the forward scan's bin 0 on the
        left and the whole slab on the right; none for a categorical
        split."""
        p = self.p
        vmn, vmx = self.adv_vmin[fo, feat], self.adv_vmax[fo, feat]  # (P, B)
        left = (torch.arange(self.Bmax, device=self.dev)[None, :]
                <= thr[:, None])
        rev = (dirf & DIR_DEFAULT_LEFT) != 0
        cat = (dirf & DIR_CATEGORICAL) != 0
        lo_l = torch.where(rev, torch.where(left, vmn, -BIG).amax(dim=1),
                           vmn[:, 0])
        hi_l = torch.where(rev, torch.where(left, vmx, BIG).amin(dim=1),
                           vmx[:, 0])
        lo_r = torch.where(rev, torch.where(~left, vmn, -BIG).amax(dim=1),
                           vmn.amax(dim=1))
        hi_r = torch.where(rev, torch.where(~left, vmx, BIG).amin(dim=1),
                           vmx.amin(dim=1))
        lo_l, lo_r = (torch.where(cat, -BIG, x) for x in (lo_l, lo_r))
        hi_l, hi_r = (torch.where(cat, BIG, x) for x in (hi_l, hi_r))
        po = self.fl["leaf_out"][fo]
        return (child_output(lg, lh, lc, p.lambda_l1, p.lambda_l2, lo_l, hi_l,
                             p.path_smooth, po, p.max_delta_step),
                child_output(rg, rh, rc, p.lambda_l1, p.lambda_l2, lo_r, hi_r,
                             p.path_smooth, po, p.max_delta_step))

    def _walk(self, anc_o_l, anc_o_r, doup_gate, sf, stb, isn, ol, orr,
              node_num, splittable, chg_min, chg_max):
        """The up-walk of one split (reference: ``_walk``, :1197-1285) over
        the split leaf's ancestors at once.  A leaf Q lies across exactly
        one ancestor A of the split leaf (their lowest common ancestor).  A
        is recorded where it is numeric and no deeper ancestor splits on
        its feature from the same side; Q's bound moves where A is recorded
        and monotone (``doup_gate``: the pair is live and under a monotone
        split), Q has a cached split, Q's rectangle meets the plane of every
        recorded ancestor deeper than A on the split leaf's side, and Q
        touches the split's plane: toward the children's outputs (its max
        where A's order puts it above the split leaf, its min below).  The
        advanced method clamps Q's whole slabs on that side and flags it
        (``chg_min`` / ``chg_max``); the intermediate one flags Q where its
        bounds changed."""
        fl = self.fl
        nf, nt = fl["split_feature"], fl["threshold_bin"]
        nd_, nm = self.node_depth, self.node_mono
        isanc = anc_o_l | anc_o_r
        side_r = anc_o_r
        cand = isanc & node_num
        blocked = (cand[:, None] & (nf[:, None] == nf[None, :])
                   & (side_r[:, None] == side_r[None, :])
                   & (nd_[:, None] > nd_[None, :])).any(dim=0)
        recorded = cand & ~blocked
        doup = recorded & (nm != 0) & doup_gate
        # Q across ancestor B: on B's other side than the split leaf
        across = torch.where(side_r[None, :], self.anc_l,
                             self.anc_r) & isanc[None, :]       # (Q, B)
        lca_depth = torch.where(across, nd_[None, :], -1).amax(dim=1)
        moves = (across & doup[None, :]).any(dim=1)
        up_max = (across & torch.where(nm < 0, ~side_r, side_r)[None, :]
                  ).any(dim=1)
        ok = torch.where(side_r[None, :],
                         self.rect_hi[:, nf] > (nt + 1)[None, :],
                         self.rect_lo[:, nf] <= nt[None, :])    # (Q, B)
        bad = (recorded[None, :] & ~ok
               & (nd_[None, :] > lca_depth[:, None])).any(dim=1)
        use_l = (self.rect_lo[:, sf] <= stb)[:, 0] | ~isn
        use_r = (self.rect_hi[:, sf] > stb + 1)[:, 0] | ~isn
        target = moves & splittable & ~bad & (use_l | use_r)
        both = use_l & use_r
        one = torch.where(use_l, ol, orr)
        vmax = torch.where(both, torch.maximum(ol, orr), one)
        vmin = torch.where(both, torch.minimum(ol, orr), one)
        t_max, t_min = target & up_max, target & ~up_max
        lo, hi = fl["out_lo"], fl["out_hi"]
        hi_n = torch.where(t_max, torch.minimum(hi, vmin), hi)
        lo_n = torch.where(t_min, torch.maximum(lo, vmax), lo)
        if self.amono:
            chg_min |= t_min
            chg_max |= t_max
            vn, vx = self.adv_vmin, self.adv_vmax
            vn.copy_(torch.where(t_min[:, None, None],
                                 torch.maximum(vn, vmax[:, None, None]), vn))
            vx.copy_(torch.where(t_max[:, None, None],
                                 torch.minimum(vx, vmin[:, None, None]), vx))
        else:
            chg_min |= (hi_n < hi) | (lo_n > lo)
        hi.copy_(hi_n)
        lo.copy_(lo_n)

    def _refresh_slabs(self, fm_min, fm_max, node_num, span: int):
        """Fresh slabs of the leaves the round's walks flagged, the min
        slab where the min side was flagged, else the max slab (reference:
        :1344-1359), over the first ``span`` leaves and nodes, past which
        none exists.  The device-state grower computes all of their slabs;
        the eager one reads the flagged leaves first."""
        L, fl = span, self.fl
        rows = None
        if not self.persistent:
            with phase(self.timer, "host_sync"):
                idx = host_list(torch.nonzero((fm_min | fm_max)[:L])[:, 0],
                                self.timer)
            if not idx:
                return
            rows = torch.tensor(idx, dtype=_I64, device=self.dev)
        v_mn, v_mx = advanced_constraint_slabs(
            self.anc_l[:L, :L], self.anc_r[:L, :L], self.node_mono[:L],
            self.node_depth[:L], fl["split_feature"][:L],
            fl["threshold_bin"][:L], node_num[:L], self.rect_lo[:L],
            self.rect_hi[:L], fl["leaf_out"][:L], self.Bmax, rows=rows)
        if rows is None:
            rows = torch.arange(L, device=self.dev)
        for slab, v, fm in ((self.adv_vmin, v_mn, fm_min),
                            (self.adv_vmax, v_mx, fm_max)):
            slab[rows] = torch.where(fm[rows][:, None, None], v, slab[rows])

    def _bound_children(self, fo, fn, feat, dirf, lg, lh, lc, rg, rh, rc):
        """The children's outputs under the split leaf's bounds, and their
        own bounds: under a monotone numeric split the midpoint of the two
        outputs caps the side that must stay lower and floors the other
        (reference: BasicLeafConstraints::Update, :1360-1385)."""
        p, fl = self.p, self.fl
        lo_p, hi_p, po = fl["out_lo"][fo], fl["out_hi"][fo], fl["leaf_out"][fo]
        ol, orr = constrained_child_outputs(
            lg, lh, lc, rg, rh, rc, p.lambda_l1, p.lambda_l2, lo_p, hi_p,
            p.path_smooth, po, p.max_delta_step)
        mid = (ol + orr) / 2.0
        if self.monotone is not None:
            mt = torch.where((dirf & DIR_CATEGORICAL) != 0, 0,
                             self.monotone[feat])
        else:
            mt = torch.zeros_like(feat)
        fl["out_lo"][fo] = torch.where(mt < 0, torch.maximum(lo_p, mid), lo_p)
        fl["out_hi"][fo] = torch.where(mt > 0, torch.minimum(hi_p, mid), hi_p)
        fl["out_lo"][fn] = torch.where(mt > 0, torch.maximum(lo_p, mid), lo_p)
        fl["out_hi"][fn] = torch.where(mt < 0, torch.minimum(hi_p, mid), hi_p)
        fl["leaf_out"][fo] = ol
        fl["leaf_out"][fn] = orr

    def _cat_bits(self, fo, fnode, feat, thr, dirf, pg, ph, pc):
        """(P, Bmax) left bins of the round's P splits of the leaves at
        flat positions ``fo``, from each leaf's cached histogram (reference:
        ops/grow.py:936-951), kept at the new nodes ``fnode`` and as the
        words K2 reads at the split leaves; the rows of numeric splits are
        never read."""
        with phase(self.timer, "cat_bitset"):
            parent_hist = self.hist_f[fo]
            hf = gather_feature_histograms(parent_hist, self.layout, pg, ph)
            hf_feat = hf[torch.arange(feat.shape[0], device=self.dev), feat]
            bits = categorical_left_bitset(
                hf_feat, thr, dirf, self.layout.valid_mask[feat],
                self.cat.cat_smooth, self.cat.min_data_per_group,
                pc / torch.clamp(ph, min=EPS_HESS))
            self.cat_bitset_f[fnode] = bits
            W = self.cat_words_f.shape[-1]
            self.cat_words_f[fo] = cat_words_from_bits(bits[:, :32 * W])
        return bits

    def _flat_leaf(self):
        """(K, N) int64 position of every row's leaf in the flattened
        (K * L) leaf axis."""
        return self.leaf_id.to(torch.int64) + self.class_base

    def route_rows(self, chosen, new_id, lfeat, lthr, ldir, lbits=None):
        """Every row's new leaf in each class after the round's splits, in
        torch ops over the flattened (K * L) per-leaf tensors (reference:
        ops/grow.py:1037-1065, and :2158-2185 for K classes): the split
        feature's group bin, unbundled from its EFB group; under a
        categorical split it goes left when its bit is set in the leaf's
        row of ``lbits`` (K * L, Bmax); under a numeric one a NaN or
        zero-as-missing bin goes the default way, any other bin left at
        most the threshold."""
        rt = self.routing
        with phase(self.timer, "route"):
            lid = self._flat_leaf()
            r_feat = lfeat[lid]
            gb = self.bins_T[rt.feat_group[r_feat].to(torch.int64),
                             self.rows]
            fb = feature_local_bin(gb, r_feat, rt)
            nanb, mzb = rt.nan_bin[r_feat], rt.mzero_bin[r_feat]
            missing = (((nanb >= 0) & (fb == nanb))
                       | ((mzb >= 0) & (fb == mzb)))
            default_left = (ldir[lid] & DIR_DEFAULT_LEFT) != 0
            go_left = torch.where(missing, default_left, fb <= lthr[lid])
            if lbits is not None:
                is_cat = (ldir[lid] & DIR_CATEGORICAL) != 0
                go_left = torch.where(
                    is_cat, lbits.view(-1)[lid * self.Bmax + fb], go_left)
            self.leaf_id.copy_(torch.where(
                (chosen[lid] > 0) & ~go_left, new_id[lid],
                self.leaf_id.to(torch.int64)))

    def can_continue(self) -> bool:
        """Some class can still split."""
        return any(pr and c < self.L
                   for pr, c in zip(self.progressed, self.cur))

    def needs_full_round(self, sprint: int) -> bool:
        """Some class can still split and cannot finish in one route-only
        round of ``sprint`` splits."""
        return any(self.progressed[c] and self.cur[c] < self.L
                   and not self._can_finish(c, sprint)
                   for c in range(self.K))

    def _arrays(self, single_leaf) -> dict:
        """The grown trees' fields as ``TreeArrays`` keeps them; a class
        whose ``single_leaf`` entry is set outputs 0.0."""
        p = self.p
        if self.use_output:
            # the outputs fixed at split time (reference: :1587-1592)
            lv = self.leaf_out
            if p.max_delta_step > 0.0:
                lv = torch.clamp(lv, -p.max_delta_step, p.max_delta_step)
        else:
            lv = leaf_output(self.sum_g, self.sum_h, p.lambda_l1,
                             p.lambda_l2, p.max_delta_step)
        # a single-leaf tree adds nothing
        lv = torch.where(single_leaf[:, None], 0.0, lv)
        i32 = torch.int32
        return dict(
            split_feature=self.split_feature.to(i32),
            threshold_bin=self.threshold_bin.to(i32),
            dir_flags=self.dir_flags.to(i32),
            left_child=self.left_child.to(i32),
            right_child=self.right_child.to(i32),
            split_gain=self.split_gain,
            internal_value=self.internal_value,
            internal_weight=self.internal_weight,
            internal_count=self.internal_count,
            cat_bitset=self.cat_bitset,
            leaf_value=lv, leaf_weight=self.sum_h,
            leaf_count=self.cnt_leaf,
            leaf_parent=self.leaf_parent.to(i32),
            leaf_depth=self.depth.to(i32))

    def result(self) -> GrowResult:
        """The grown trees: one tree's (L,) arrays and (N,) leaf ids, or,
        for K classes, arrays and leaf ids with a leading K axis."""
        with phase(self.timer, "other"):
            single = torch.tensor([nl <= 1 for nl in self.cur],
                                  device=self.dev)
            arrays = self._arrays(single)
        if self.K == 1:
            return GrowResult(
                TreeArrays(num_leaves=self.cur[0],
                           **{k: v[0] for k, v in arrays.items()}),
                self.leaf_id[0], self.rounds[0])
        return GrowResult(TreeArrays(num_leaves=tuple(self.cur), **arrays),
                          self.leaf_id, tuple(self.rounds))


class _DeviceGrower(_Grower):
    """The grower of the fused iteration (reference: the ``lax.while_loop``
    state of ops/grow.py:849): every tensor it holds is allocated once and
    written in place, so that CUDA graphs captured over its rounds read and
    write fixed addresses, and the schedule's counts live on the device as
    (K,) tensors.  A round of budget B at round index r runs K * min(2**r,
    B) pair slots, class-major: a pair is live where its rank is below
    ``min(L - cur, B, npos)`` of an active class, and K2 takes min(2**r, B)
    slots, the most round r can fill (round r splits at most 2**r leaves).
    A round that no class needs is an exact no-op: every write of its pairs
    goes to the spare leaf.  No round reads the host: the fixed-point shifts
    come from ``hist_shifts`` on the device, and the rounds a tree needs
    are planned by the caller (``grow_device``).  One grower serves every
    tree of a run at one compaction capacity: ``begin`` resets it."""

    persistent = True

    def __init__(self, bins_T, K: int, layout: FeatureLayout,
                 routing: RoutingLayout, params: GrowParams, max_bins: int,
                 col_mask=None, compact_rows: int = 0, monotone=None,
                 interaction_groups=None, key=None):
        if params.hist_backend != "stream":
            raise ValueError("the device-state grower runs the stream "
                             "backend")
        if params.has_cegb:
            raise ValueError("CEGB grows eager (reference: "
                             "models/gbdt.py:1605)")
        self._alloc(bins_T, K, layout, routing, params, max_bins, None,
                    col_mask, compact_rows, monotone, interaction_groups,
                    key)
        dev = self.dev
        self.round_idx = torch.zeros((), dtype=_I64, device=dev)
        self.cur = torch.ones(K, dtype=_I64, device=dev)
        self.progressed = torch.ones(K, dtype=torch.bool, device=dev)
        self.npos = torch.zeros(K, dtype=_I64, device=dev)
        self.rounds = torch.zeros(K, dtype=_I64, device=dev)
        # full rounds of the loop in which some class split
        self.loop_splits = torch.zeros((), dtype=_I64, device=dev)
        if self.fuse:
            # a record for each round a tree can run: seven budget-64
            # rounds, at most L - 1 rounds that split, the sprint, and the
            # no-op rounds of a plan past the tree's need
            self.rec_max = 2 * self.L + 8
            self.rec_buf = torch.zeros(
                (self.rec_max, self.L, len(ROUTE_FIELDS)), dtype=torch.int32,
                device=dev)
            self.rec_pos = torch.zeros(1, dtype=_I64, device=dev)

    def begin(self, grad, hess, cnt, gh_scales=None):
        """A new tree: (K, N) weights and (N,) count weights copied into
        the grower's buffers, the rows compacted, every per-leaf tensor
        reset, and the root pass."""
        for name, (_, fill) in _LEAF_FIELDS.items():
            self.fl[name].fill_(fill)
        self.hist_f.zero_()
        self.cat_bitset_f.zero_()
        self.cat_words_f.zero_()
        if self.groups is not None:
            self.used_feat_f.zero_()
        if self.imono:
            for t in (self.anc_l, self.anc_r, self.node_mono,
                      self.node_depth, self.rect_lo, self.in_mono):
                t.zero_()
            self.rect_hi.fill_(_RECT_OPEN)
            if self.amono:
                self.adv_vmin.fill_(-BIG)
                self.adv_vmax.fill_(BIG)
                self.adv_ok.fill_(True)
        self.round_idx.zero_()
        self.leaf_id.zero_()
        if self.compact:
            self.leaf_id_h.zero_()
        self.cur.fill_(1)
        self.progressed.fill_(True)
        self.rounds.zero_()
        self.loop_splits.zero_()
        if self.fuse:
            self.rec_pos.zero_()
        self._setup_rows(grad, hess, cnt, gh_scales)
        self.root()

    def _set_shifts(self, m):
        n = self.bins_T.shape[1]
        self._put("shift_t", hist_shifts(m, n))
        self.shifts = tuple(self.shift_t.unbind())
        self._put("scales", scale_table_dev(self.shift_t))

    def count_splittable(self):
        self.npos.copy_(self._splittable())

    def _keep_record(self, tab):
        self.rec_buf.index_copy_(0, self.rec_pos, tab[None])
        self.rec_pos.add_(1)

    def replay(self, num_records: int):
        """Every row's leaf from the first ``num_records`` kept route
        tables (K3), the rounds the host replayed: a no-op round's table
        routes no row."""
        if self.fuse:
            if num_records > self.rec_max:
                raise ValueError(f"{num_records} rounds past the "
                                 f"{self.rec_max} route records kept")
            self.leaf_id.copy_(route_replay(
                self.bins_T, self.rec_buf[:num_records])[None])

    def _counts(self, budget: int, freeze_sprint: Optional[int]):
        """(active (K,) bool, k (K,) int64): the classes whose own loop
        goes on, and the splits each takes in a round of ``budget``."""
        L, cur = self.L, self.cur
        active = self.progressed & (cur < L)
        if freeze_sprint is not None:
            remaining = L - cur
            active = active & ~((remaining <= freeze_sprint)
                                & (remaining <= self.npos))
        k = torch.clamp(torch.minimum(L - cur, self.npos), max=budget)
        return active, torch.where(active, k, 0)

    def span(self, r: int, budget: int) -> Optional[int]:
        """The leaves that can exist after round ``r`` of one split (the
        monotone methods' rounds: r + 2), rounded up to a multiple of 32,
        which keys a graph of its own; None (every leaf) otherwise."""
        if not self.imono or budget != 1:
            return None
        return min(self.KL, -(-(r + 2) // 32) * 32)

    def forced_dev(self, i: int):
        """Forced level i as a round of the device-state grower, from the
        level's tensors made at allocation."""
        fo, feat, thr, dirf, cls, rank = self.forced[i]
        nf = fo.shape[0]
        self._split_pairs(cls, rank, self.cur[cls] + rank, None, nf, True,
                          nf, None, forced=(fo, feat, thr, dirf))
        self.round_idx.add_(1)
        self.rounds.add_(1)
        self.cur.add_(nf)
        self.count_splittable()

    def round_dev(self, r: int, budget: int, with_hist: bool = True,
                  freeze_sprint: Optional[int] = None, loop: bool = False,
                  span: Optional[int] = None):
        """Round ``r`` of the tree (0 after the root) with a budget of
        ``budget`` splits a class; ``loop``: a full round of the sprint or
        plain loop, counted in ``loop_splits`` when some class splits;
        ``span``: ``span(r, budget)``."""
        K, dev = self.K, self.dev
        active, k = self._counts(budget, freeze_sprint)
        self.progressed.copy_(self.progressed & ~(active & (k <= 0)))
        slots = min(2 ** r, budget)
        j = torch.arange(K * slots, device=dev)
        cls, rank = j // slots, j % slots
        live = rank < k[cls]
        new = self.cur[cls] + rank
        self._split_pairs(cls, rank, new, live, slots, with_hist, budget,
                          span)
        self.round_idx.add_(1)
        self.rounds.add_(k > 0)
        self.cur.add_(k)
        if loop:
            self.loop_splits.add_((k > 0).any())
        if with_hist:
            self.count_splittable()

    def pending(self, budget: int, freeze_sprint: Optional[int]):
        """(2,) int64: whether a full round of ``budget`` would split some
        class, and the loop's splitting rounds so far: the one vector the
        host reads per tree."""
        _, k = self._counts(budget, freeze_sprint)
        return torch.stack([(k > 0).any().to(_I64), self.loop_splits])

    def result_arrays(self) -> dict:
        """The grown trees' fields, (K, L) each, on the device."""
        return self._arrays(self.cur <= 1)


def _pair_index(ksp, cur, dev: torch.device):
    """(class, rank, new leaf) of each split of a round, class-major: class
    c's ksp[c] splits take its top-ranked leaves and make leaves cur[c],
    cur[c] + 1, ...  Built on the host, which knows every count, and copied
    once, without a sync, from pinned memory."""
    cls = [c for c, k in enumerate(ksp) for _ in range(k)]
    rank = [r for k in ksp for r in range(k)]
    new = [cur[c] + r for c, k in enumerate(ksp) for r in range(k)]
    t = torch.tensor([cls, rank, new], dtype=torch.int64)
    if dev.type == "cuda":
        t = t.pin_memory()
    t = t.to(dev, non_blocking=True)
    return t[0], t[1], t[2]


def _grow(gr: _Grower, params: GrowParams) -> GrowResult:
    """The round schedule, the same for one tree and for K in lockstep."""
    L = params.num_leaves
    S = min(params.max_splits_per_round, max(L - 1, 1))
    gr.root()
    # forced splits first, a round a level
    for level in gr.forced:
        gr.forced_round(level)
    # the budget-64 prefix and the sprint are the stream schedule's; the
    # other backends run plain rounds of S, each with histograms
    stream = params.hist_backend == "stream"
    if stream and S > 64:
        # round r splits at most 2**r leaves: seven budget-64 rounds cover
        # growth to 128 leaves before the full budget
        for _ in range(7):
            if gr.can_continue():
                gr.round(64)
    if stream and S >= 64 and params.max_depth <= 0 and not params.forced:
        S_f = min(2 * S, 255, max(L - 1, 1))
        # full rounds while a class still needs one; a class that one
        # route-only round can finish waits for the others, frozen
        while gr.needs_full_round(S_f):
            gr.round(S, freeze_sprint=S_f)
        if gr.can_continue():
            gr.round(S_f, with_hist=False)
    else:
        while gr.can_continue():
            gr.round(S)
    gr.replay()
    return gr.result()


def loop_plan(params: GrowParams) -> int:
    """Full rounds the loop of ``grow_device`` takes for a tree in which
    every leaf splits: its first tree's plan."""
    L = params.num_leaves
    S = min(params.max_splits_per_round, max(L - 1, 1))
    cur = 1 + sum(len(level[0]) for level in params.forced)
    rounds = 0
    if S > 64:
        for _ in range(7):
            cur += min(cur, 64, L - cur)
    sprint = S >= 64 and params.max_depth <= 0 and not params.forced
    S_f = min(2 * S, 255, max(L - 1, 1))
    # every leaf splittable: the sprint can finish once what remains fits
    # its budget and the leaves there are
    while cur < L and not (sprint and L - cur <= min(S_f, cur)):
        cur += min(cur, S, L - cur)
        rounds += 1
    return rounds


def grow_device(gr: _DeviceGrower, params: GrowParams, run, read,
                plan: int):
    """The round schedule of ``_grow`` over a device-state grower, after
    its root: the forced levels, the budget-64 prefix, then ``plan`` full
    rounds, then one host read of ``pending``; while it says a full round would still split,
    one more round and another read.  ``run(key, fn)`` runs a round
    (replays its graph); ``read(t)`` reads a device tensor on the host.
    Returns (rounds run, the sprint's (budget, slots) or None, full rounds
    in which a class split).  The caller runs the sprint and the replay
    (``sprint_and_replay``)."""
    L = params.num_leaves
    S = min(params.max_splits_per_round, max(L - 1, 1))
    r = 0

    def round_(budget, freeze, loop):
        nonlocal r
        slots = min(2 ** r, budget)
        span = gr.span(r, budget)
        run(("round", budget, slots, freeze, loop, span),
            lambda rr=r: gr.round_dev(rr, budget, True, freeze, loop, span))
        r += 1

    for i in range(len(gr.forced)):
        run(("forced", i), lambda i=i: gr.forced_dev(i))
        r += 1
    if S > 64:
        # round r splits at most 2**r leaves: seven budget-64 rounds cover
        # growth to 128 leaves before the full budget
        for _ in range(7):
            round_(64, None, False)
    sprint = S >= 64 and params.max_depth <= 0 and not params.forced
    freeze = min(2 * S, 255, max(L - 1, 1)) if sprint else None
    done = 0
    while True:
        for _ in range(plan - done):
            round_(S, freeze, True)
        done = max(done, plan)
        more, used = read(gr.pending(S, freeze))
        if not more:
            break
        plan = done + 1
    return r, ((freeze, min(2 ** r, freeze)) if sprint else None), used


def sprint_and_replay(gr: _DeviceGrower, rounds: int, sprint):
    """The tail of a device-state tree: the route-only sprint round (K2
    without histograms) where the schedule has one, then every row's leaf
    through K3 for a fused compacted tree.  Returns the rounds run."""
    if sprint is not None:
        gr.round_dev(rounds, sprint[0], with_hist=False)
        rounds += 1
    gr.replay(rounds)
    return rounds


def grow_tree(bins_T: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              cnt: torch.Tensor, layout: FeatureLayout,
              routing: RoutingLayout, params: GrowParams, max_bins: int,
              timer=None, col_mask: Optional[torch.Tensor] = None,
              compact_rows: int = 0,
              bins: Optional[torch.Tensor] = None,
              gh_scales: Optional[torch.Tensor] = None,
              monotone: Optional[torch.Tensor] = None,
              interaction_groups: Optional[torch.Tensor] = None,
              key=None, cegb: Optional[CegbState] = None) -> GrowResult:
    """Grow one tree.  bins_T: (G, N) uint8; bins: the same (N, G)
    row-major, which ``hist_backend="pallas"`` reads; grad, hess, cnt: (N,)
    float32, zero on pad and out-of-bag rows (cnt is the in-bag mask);
    col_mask: (F,) bool feature sample, or None; compact_rows: the row
    capacity of a sampled tree's compacted view (covering every in-bag
    row), 0 for none; gh_scales: the (2,) float32 (grad, hess) scales of
    quantized gradients (grad and hess then hold grid values), or None;
    monotone: (F,) int64 signs in {-1, 0, 1} (``params.has_monotone``);
    interaction_groups: (C, F) bool allowed-feature groups
    (``params.has_interaction``); key: the ``utils.random`` key of the
    per-node draws (``params.bynode_fraction`` < 1, ``params.extra_trees``;
    reference: models/gbdt.py:2246-2249); cegb: the run's ``CegbState``
    (``params.has_cegb``), whose lazy bitset the tree marks in place."""
    gr = _Grower(bins_T, grad[None], hess[None], cnt, layout, routing,
                 params, max_bins, timer, col_mask, compact_rows, bins,
                 None if gh_scales is None else gh_scales[None], monotone,
                 interaction_groups, key, cegb)
    return _grow(gr, params)


def grow_tree_k(bins_T: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                cnt: torch.Tensor, layout: FeatureLayout,
                routing: RoutingLayout, params: GrowParams, max_bins: int,
                timer=None,
                col_mask: Optional[torch.Tensor] = None,
                gh_scales: Optional[torch.Tensor] = None,
                compact_rows: int = 0) -> GrowResult:
    """Grow K class trees in lockstep (reference: ops/grow.py grow_tree_k).
    grad, hess: (K, N) float32, class k's gradients in row k, zero on pad
    and out-of-bag rows; gh_scales: (K, 2) class k's quantized (grad,
    hess) scales, or None; compact_rows: the capacity of the one compacted
    view every class reads, 0 for none; the other arguments as
    ``grow_tree``'s, the feature sample shared by the classes.  Class k's
    tree is ``grow_tree``'s on grad[k], hess[k], bit for bit.  Plain growth
    without forced splits only, as the reference's (:1689-1694)."""
    if not params.plain_growth or params.forced:
        raise ValueError("grow_tree_k supports the plain feature set only; "
                         "use the per-class grow_tree scan path")
    gr = _Grower(bins_T, grad, hess, cnt, layout, routing, params, max_bins,
                 timer, col_mask, compact_rows, gh_scales=gh_scales)
    return _grow(gr, params)
