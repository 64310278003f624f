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
(G, compact_rows) view and its own leaf ids.  Every row of the full set
still needs its leaf for the score update.  Unfused, each round adds a
route-only K2 pass over all N rows (reference: ops/grow.py:1023-1032).
Fused (``route_fusion``, under the reference's gate :626-633: S >= 64, no
depth limit, at most 256 leaves), each round's (L, 16) route records are
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

The loop is a Python loop over rounds.  Each round reads one integer on the
host (the number of splittable leaves), and each tree one more (the largest
weight, which fixes the histograms' fixed-point shift).  Not ported:
forced splits, monotone and interaction constraints, CEGB, by-node feature
sampling, extra trees, path smoothing, meshes and quantized-gradient
histograms.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device_data import FeatureLayout, RoutingLayout
from ..kernels.layout import build_route_tables
from ..kernels.route_hist import route_and_hist
from ..kernels.route_replay import route_replay
from ..tree import DIR_DEFAULT_LEFT, TreeArrays
from ..utils.timer import host_int, phase
from .compact import (check_compact_supported, compact_row_views,
                      compact_transposed_view, plan_sample_rows)
from .histogram import build_histograms, hist_shift, hist_subtract
from .predict import feature_local_bin
from .split import NEG_INF, find_best_splits, leaf_output


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


class GrowResult(NamedTuple):
    arrays: TreeArrays
    leaf_id: torch.Tensor     # (N,) int32 leaf of every row
    rounds: int               # splitting rounds run: bounds the tree's depth


def fusion_applies(params: GrowParams, compact_rows: int) -> bool:
    """The reference's gate for route fusion (ops/grow.py:626-633): a
    compacted stream tree grown in the sprint schedule (S >= 64, no depth
    limit) with at most 256 leaves.  Categorical trees, forced splits and
    CEGB, which the gate also excludes, do not train in the port."""
    L = params.num_leaves
    S = min(params.max_splits_per_round, max(L - 1, 1))
    return (params.route_fusion and params.hist_backend == "stream"
            and compact_rows > 0 and S >= 64 and params.max_depth <= 0
            and L <= 256)


class _Grower:
    """The state of one tree while it grows: per-leaf sums, cached best
    splits and histograms, node arrays, and every row's leaf.  The ``*_h``
    tensors are the rows the histogram passes read: the compacted view of
    a sampled tree, else the full rows themselves (row-major bins for
    ``pallas``)."""

    def __init__(self, bins_T, grad, hess, cnt, layout: FeatureLayout,
                 routing: RoutingLayout, params: GrowParams, max_bins: int,
                 timer=None, col_mask=None, compact_rows: int = 0,
                 bins=None):
        self.bins_T, self.grad, self.hess, self.cnt = bins_T, grad, hess, cnt
        self.stream = params.hist_backend == "stream"
        self.layout, self.routing, self.p = layout, routing, params
        self.Bmax = max_bins
        self.timer = timer
        self.col_mask = col_mask
        self.compact = compact_rows > 0
        self.fuse = fusion_applies(params, compact_rows)
        self.records = []          # the rounds' route tables, when fused
        self.rounds = 0
        dev = bins_T.device
        self.dev = dev
        L = self.L = params.num_leaves
        G, n = bins_T.shape
        f32, i64 = torch.float32, torch.int64

        def z(dtype, fill=0):
            return torch.full((L,), fill, dtype=dtype, device=dev)

        self.split_feature, self.threshold_bin = z(i64), z(i64)
        self.dir_flags, self.left_child, self.right_child = \
            z(i64), z(i64), z(i64)
        self.split_gain, self.internal_value = z(f32), z(f32)
        self.internal_weight, self.internal_count = z(f32), z(f32)
        self.sum_g, self.sum_h, self.cnt_leaf = z(f32), z(f32), z(f32)
        self.depth, self.leaf_parent = z(i64), z(i64, -1)
        self.best_gain = z(f32, NEG_INF)
        self.best_feat, self.best_thr, self.best_dir = z(i64), z(i64), z(i64)
        self.best_left_g, self.best_left_h, self.best_left_c = \
            z(f32), z(f32), z(f32)
        self.hist = torch.zeros((L, G, max_bins, 2), dtype=f32, device=dev)
        self.cat_words = torch.zeros((L, max(-(-max_bins // 32), 1)),
                                     dtype=torch.int32, device=dev)
        self.leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
        if not self.stream:
            self.rows = torch.arange(n, device=dev)
            if self.compact:
                check_compact_supported(params.hist_backend)
                with phase(timer, "compact"):
                    (self.bins_h, self.grad_h, self.hess_h, self.cnt_h,
                     self.c_perm) = compact_row_views(bins_T, grad, hess, cnt,
                                                      compact_rows)
            else:
                self.bins_h = bins if params.hist_backend == "pallas" \
                    else bins_T
                self.grad_h, self.hess_h, self.cnt_h = grad, hess, cnt
        elif self.compact:
            with phase(timer, "compact"):
                perm = plan_sample_rows(cnt, compact_rows).perm
                (self.bins_h, self.grad_h, self.hess_h,
                 self.cnt_h) = compact_transposed_view(bins_T, perm, grad,
                                                       hess, cnt)
            self.leaf_id_h = torch.zeros(compact_rows, dtype=torch.int32,
                                         device=dev)
        else:
            self.bins_h, self.grad_h, self.hess_h, self.cnt_h = \
                bins_T, grad, hess, cnt
            self.leaf_id_h = self.leaf_id
        self.cur = 1
        self.progressed = True
        self.npos = 0
        # one fixed-point scale per tree, from all N rows, so that the
        # compacted and the full passes quantize alike
        m = torch.maximum(grad.abs().max(), hess.abs().max())
        self.shift = hist_shift(float(m.item()), n)
        if timer is not None:
            timer.host_reads += 1

    def find_splits(self, hist, g, h, c):
        p = self.p
        with phase(self.timer, "split_scan"):
            return find_best_splits(
                hist, g, h, c, self.layout, p.lambda_l1, p.lambda_l2,
                max(p.min_data_in_leaf, 1), p.min_sum_hessian_in_leaf,
                p.min_gain_to_split, p.max_delta_step, self.col_mask)

    def k2(self, tabs, num_slots, with_hist):
        """The round's K2 pass over the histogram rows; for a compacted
        tree also every row's route (a route-only pass, or the tables kept
        for the replay).  Returns the pass's histograms and counts."""
        with phase(self.timer, "k2"):
            new_leaf, hist, counts = route_and_hist(
                self.bins_h, self.leaf_id_h, tabs, self.cat_words,
                self.grad_h, self.hess_h, self.cnt_h, num_slots, self.Bmax,
                self.shift, with_hist)
        if not self.compact:
            self.leaf_id = self.leaf_id_h = new_leaf
        elif self.fuse:
            self.records.append(tabs)
            self.leaf_id_h = new_leaf
        else:
            with phase(self.timer, "k2"):
                self.leaf_id, _, _ = route_and_hist(
                    self.bins_T, self.leaf_id, tabs, self.cat_words,
                    self.grad, self.hess, self.cnt, num_slots, self.Bmax,
                    self.shift, False)
            self.leaf_id_h = new_leaf
        return hist, counts

    def replay(self):
        """Every row's leaf from the kept route tables (K3), once per fused
        tree that made a split."""
        if self.fuse and self.records:
            with phase(self.timer, "k3"):
                self.leaf_id = route_replay(self.bins_T,
                                            torch.stack(self.records))

    def count_splittable(self):
        p = self.p
        cand = self.best_gain > 0
        if p.max_depth > 0:
            cand = cand & (self.depth < p.max_depth)
        with phase(self.timer, "host_sync"):
            self.npos = host_int(cand.sum(), self.timer)

    def histograms(self, slot, num_slots: int):
        """The non-stream backend's (S, G, Bmax, 3) histograms of the
        histogram rows' slots (None: every row in slot 0)."""
        with phase(self.timer, "hist"):
            return build_histograms(self.bins_h, slot, self.grad_h,
                                    self.hess_h, self.cnt_h, num_slots,
                                    self.Bmax, self.shift,
                                    self.p.hist_backend)

    def root(self):
        p, L, dev = self.p, self.L, self.dev
        if self.stream:
            zL = torch.zeros(L, dtype=torch.int64, device=dev)
            keep = torch.full((L,), -1, dtype=torch.int64, device=dev)
            keep[0] = 0
            tabs0 = build_route_tables(zL, zL, zL, zL, zL, keep, keep, keep,
                                       self.routing)
            with phase(self.timer, "k2"):
                _, root_hist, _ = route_and_hist(
                    self.bins_h, self.leaf_id_h, tabs0, self.cat_words,
                    self.grad_h, self.hess_h, self.cnt_h, 1, self.Bmax,
                    self.shift, True)
        else:
            root_hist = self.histograms(None, 1)[..., :2]
        # root totals of all N rows in float64, rounded once: the same on
        # every device and at every compaction capacity
        g = self.grad.double().sum().float()
        h = self.hess.double().sum().float()
        c = self.cnt.double().sum().float()
        res = self.find_splits(root_hist, g[None], h[None], c[None])
        self.hist[0] = root_hist[0]
        self.sum_g[0], self.sum_h[0], self.cnt_leaf[0] = g, h, c
        self._store_best(torch.zeros(1, dtype=torch.int64, device=dev), res)
        self.count_splittable()

    def _store_best(self, ids, res):
        self.best_gain[ids] = res.gain
        self.best_feat[ids] = res.feature
        self.best_thr[ids] = res.threshold
        self.best_dir[ids] = res.dir_flags
        self.best_left_g[ids] = res.left_sum_g
        self.best_left_h[ids] = res.left_sum_h
        self.best_left_c[ids] = res.left_count

    def round(self, budget: int, with_hist: bool = True):
        """One round splitting up to ``budget`` leaves (reference: the body
        of make_body, stream branch)."""
        p, L, dev = self.p, self.L, self.dev
        k = min(L - self.cur, budget, self.npos)
        if k <= 0:
            self.progressed = False
            return
        with phase(self.timer, "other"):
            cand = torch.where(self.best_gain > 0, self.best_gain, NEG_INF)
            if p.max_depth > 0:
                cand = torch.where(self.depth < p.max_depth, cand, NEG_INF)
            order = torch.argsort(-cand, stable=True)
            ar = torch.arange(k, dtype=torch.int64, device=dev)
            old = order[:k]
            new = self.cur + ar
            node = self.cur - 1 + ar
            feat, thr = self.best_feat[old], self.best_thr[old]
            dirf, gain = self.best_dir[old], self.best_gain[old]
            pg, ph, pc = self.sum_g[old], self.sum_h[old], self.cnt_leaf[old]
            lg, lh = self.best_left_g[old], self.best_left_h[old]
            lc = self.best_left_c[old]
            rg, rh, rc = pg - lg, ph - lh, pc - lc
            parent_hist = self.hist[old] if with_hist else None

            # node arrays, then the link from the split leaf's parent node
            self.split_feature[node] = feat
            self.threshold_bin[node] = thr
            self.dir_flags[node] = dirf
            self.split_gain[node] = gain
            self.internal_value[node] = leaf_output(
                pg, ph, p.lambda_l1, p.lambda_l2, p.max_delta_step)
            self.internal_weight[node] = ph
            self.internal_count[node] = pc
            self.left_child[node] = ~old
            self.right_child[node] = ~new
            parent = self.leaf_parent[old]
            has_p = parent >= 0
            pidx = torch.clamp(parent, min=0)
            was_left = (self.left_child[pidx] == ~old) & has_p
            # rows without a parent write to a spare slot past the end
            dump = torch.full_like(parent, L)
            lc_ext = torch.cat([self.left_child, self.left_child[:1]])
            rc_ext = torch.cat([self.right_child, self.right_child[:1]])
            lc_ext[torch.where(was_left, parent, dump)] = node
            rc_ext[torch.where(has_p & ~was_left, parent, dump)] = node
            self.left_child, self.right_child = lc_ext[:L], rc_ext[:L]
            self.leaf_parent[old] = node
            self.leaf_parent[new] = node

            # the smaller child of split i fills histogram slot i
            smaller_is_left = lc <= rc
            zi = torch.zeros(L, dtype=torch.int64, device=dev)
            chosen, new_id, lfeat, lthr, ldir = (zi.clone() for _ in range(5))
            chosen[old] = 1
            new_id[old] = new
            lfeat[old] = feat
            lthr[old] = thr
            ldir[old] = dirf
            if self.stream:
                slot_l = torch.full((L,), -1, dtype=torch.int64, device=dev)
                slot_r, slot_keep = slot_l.clone(), slot_l.clone()
                slot_l[old] = torch.where(smaller_is_left, ar, -1)
                slot_r[old] = torch.where(smaller_is_left, -1, ar)
                tabs = build_route_tables(chosen, new_id, lfeat, lthr, ldir,
                                          slot_l, slot_r, slot_keep,
                                          self.routing)
        if self.stream:
            hist_small, slot_cnt = self.k2(tabs, k, with_hist)
        else:
            self.route_rows(chosen, new_id, lfeat, lthr, ldir)
            with phase(self.timer, "other"):
                slot_map = torch.full((L,), -1, dtype=torch.int32,
                                      device=dev)
                slot_map[torch.where(smaller_is_left, old, new)] = \
                    ar.to(torch.int32)
                slot = slot_map[self.leaf_id.to(torch.int64)]
                if self.compact:
                    slot = slot[self.c_perm]
            hist3 = self.histograms(slot, k)
            hist_small = hist3[..., :2]
            # any one group's bins partition a slot's rows, so group 0's
            # count channel sums to the slot's exact row count
            slot_cnt = hist3[:, 0, :, 2].sum(dim=-1)
        self.rounds += 1
        with phase(self.timer, "other"):
            # exact child counts from the routed rows (reference:
            # serial_tree_learner.cpp:798)
            lc_x = torch.where(smaller_is_left, slot_cnt, pc - slot_cnt)
            rc_x = pc - lc_x
            self.sum_g[old], self.sum_g[new] = lg, rg
            self.sum_h[old], self.sum_h[new] = lh, rh
            self.cnt_leaf[old], self.cnt_leaf[new] = lc_x, rc_x
            d = self.depth[old] + 1
            self.depth[new] = d
            self.depth[old] = d
            self.cur += k
        if not with_hist:
            return
        with phase(self.timer, "other"):
            smaller = torch.where(smaller_is_left, old, new)
            larger = torch.where(smaller_is_left, new, old)
            self.hist[smaller] = hist_small
            self.hist[larger] = hist_subtract(parent_hist, hist_small)
            ids2 = torch.cat([old, new])
        res = self.find_splits(self.hist[ids2], self.sum_g[ids2],
                               self.sum_h[ids2], self.cnt_leaf[ids2])
        with phase(self.timer, "other"):
            self._store_best(ids2, res)
        self.count_splittable()

    def route_rows(self, chosen, new_id, lfeat, lthr, ldir):
        """Every row's new leaf after the round's splits, in torch ops
        (reference: ops/grow.py:1037-1065; numeric decisions only, as the
        port trains no categorical feature): the split feature's group
        bin, unbundled from its EFB group; a NaN or zero-as-missing bin
        goes the default way, any other bin left at most the threshold."""
        rt = self.routing
        with phase(self.timer, "route"):
            lid = self.leaf_id.to(torch.int64)
            r_feat = lfeat[lid]
            gb = self.bins_T[rt.feat_group[r_feat].to(torch.int64),
                             self.rows]
            fb = feature_local_bin(gb, r_feat, rt)
            nanb, mzb = rt.nan_bin[r_feat], rt.mzero_bin[r_feat]
            missing = (((nanb >= 0) & (fb == nanb))
                       | ((mzb >= 0) & (fb == mzb)))
            default_left = (ldir[lid] & DIR_DEFAULT_LEFT) != 0
            go_left = torch.where(missing, default_left, fb <= lthr[lid])
            self.leaf_id = torch.where((chosen[lid] > 0) & ~go_left,
                                       new_id[lid], lid).to(torch.int32)

    def can_continue(self) -> bool:
        return self.progressed and self.cur < self.L

    def arrays(self) -> TreeArrays:
        p = self.p
        nl = self.cur
        with phase(self.timer, "other"):
            lv = leaf_output(self.sum_g, self.sum_h, p.lambda_l1,
                             p.lambda_l2, p.max_delta_step)
            if nl <= 1:
                lv = torch.zeros_like(lv)    # a single-leaf tree adds nothing
            i32 = torch.int32
            return TreeArrays(
                split_feature=self.split_feature.to(i32),
                threshold_bin=self.threshold_bin.to(i32),
                dir_flags=self.dir_flags.to(i32),
                left_child=self.left_child.to(i32),
                right_child=self.right_child.to(i32),
                split_gain=self.split_gain,
                internal_value=self.internal_value,
                internal_weight=self.internal_weight,
                internal_count=self.internal_count,
                cat_bitset=torch.zeros((self.L, self.Bmax), dtype=torch.bool,
                                       device=self.dev),
                leaf_value=lv, leaf_weight=self.sum_h,
                leaf_count=self.cnt_leaf,
                leaf_parent=self.leaf_parent.to(i32),
                num_leaves=nl, leaf_depth=self.depth.to(i32))


def grow_tree(bins_T: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              cnt: torch.Tensor, layout: FeatureLayout,
              routing: RoutingLayout, params: GrowParams, max_bins: int,
              timer=None, col_mask: Optional[torch.Tensor] = None,
              compact_rows: int = 0,
              bins: Optional[torch.Tensor] = None) -> GrowResult:
    """Grow one tree.  bins_T: (G, N) uint8; bins: the same (N, G)
    row-major, which ``hist_backend="pallas"`` reads; grad, hess, cnt: (N,)
    float32, zero on pad and out-of-bag rows (cnt is the in-bag mask);
    col_mask: (F,) bool feature sample, or None; compact_rows: the row
    capacity of a sampled tree's compacted view (covering every in-bag
    row), 0 for none."""
    L = params.num_leaves
    S = min(params.max_splits_per_round, max(L - 1, 1))
    gr = _Grower(bins_T, grad, hess, cnt, layout, routing, params, max_bins,
                 timer, col_mask, compact_rows, bins)
    gr.root()
    # the budget-64 prefix and the sprint are the stream schedule's; the
    # other backends run plain rounds of S, each with histograms
    stream = params.hist_backend == "stream"
    if stream and S > 64:
        # round r splits at most 2**r leaves: seven budget-64 rounds cover
        # growth to 128 leaves before the full budget
        for _ in range(7):
            if gr.can_continue():
                gr.round(64)
    if stream and S >= 64 and params.max_depth <= 0:
        S_f = min(2 * S, 255, max(L - 1, 1))
        while gr.progressed and L - gr.cur > 0:
            remaining = L - gr.cur
            if remaining <= S_f and remaining <= gr.npos:
                break                 # one route-only round can finish
            gr.round(S)
        if gr.can_continue():
            gr.round(S_f, with_hist=False)
    else:
        while gr.can_continue():
            gr.round(S)
    gr.replay()
    return GrowResult(gr.arrays(), gr.leaf_id, gr.rounds)
