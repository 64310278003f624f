"""Batch prediction over binned rows: tables, the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of ``lightgbm_tpu/pallas/predict_kernel.py:158-340``
(``predict_stream``, ``build_predict_tables``, ``tree_max_depth``).  The TPU
kernel digit-encodes every node field in 7 bits and splits leaf values into
bf16 hi/lo pairs so that its one-hot bf16 matmuls stay exact.  The port's
tables are plain int32 node records and exact float32 leaf values, read by a
pointer-chasing CUDA kernel (``csrc/predict_stream.cu``).  Its sums are
therefore closer to the host float64 walk than the TPU kernel's, and the two
packages agree to a tolerance (rtol 1e-4, atol 1e-5), not bit for bit.

``predict_stream`` launches the CUDA kernel for tensors on a CUDA device and
runs ``predict_stream_plain`` only for tensors on the CPU.  A kernel that
fails to build or launch raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..utils.log import LightGBMError
from . import build

# int32 fields of one node record, in the order csrc/predict_stream.cu reads
# them as four int4 loads
NODE_FIELDS = ("group", "span_start", "default_bin", "bundled",
               "has_nan", "nan_bin", "has_mz", "mz_bin",
               "num_bins", "threshold_bin", "default_left", "is_cat",
               "left", "right", "cat_base", "unused")
(F_GROUP, F_SPAN, F_DEFBIN, F_BUNDLED, F_HASNAN, F_NANBIN, F_HASMZ, F_MZBIN,
 F_NBINS, F_THR, F_DEFLEFT, F_ISCAT, F_LEFT, F_RIGHT, F_CATBASE,
 _F_UNUSED) = range(len(NODE_FIELDS))


class PredictTables(NamedTuple):
    """Host tables of one class's trees."""
    nodes: np.ndarray        # (n_trees, L, 16) int32 node records
    leaf_value: np.ndarray   # (n_trees, L) float32, exact
    cat_words: np.ndarray    # (W,) uint32 bin-domain bitsets, W >= 1
    depths: np.ndarray       # (n_trees,) int32 exact depth of each tree


def build_predict_tables(trees, routing_np, num_leaves: int,
                         bin_mappers) -> PredictTables:
    """Node records, leaf values and categorical bitsets from host Trees.

    routing_np: numpy routing arrays (device_data.ROUTING_FIELDS) indexed by
    ORIGINAL feature id.  Numeric thresholds are requantized from the REAL
    threshold against the training mappers (file-loaded trees carry
    threshold_bin=0; the rule of models/gbdt._tree_to_device).  Categorical
    value-domain bitsets are re-projected onto bins: bit b is set iff the
    bin's category ``categories[b]`` is in the node's value bitset.  Each cat
    node's bitset spans ceil((num_bins + 1) / 32) words, so the sentinel bin
    ``num_bins`` (NaN / unseen / negative values, pre-binned by the caller)
    reads a zero bit and routes right like the host walk.  Children: internal
    child c >= 0 stays c; leaf child c < 0 becomes L + (~c).  Single-leaf
    trees keep all-zero records: the walk stays on node 0 and resolves to
    leaf 0."""
    L = num_leaves
    n_trees = len(trees)
    nodes = np.zeros((n_trees, L, len(NODE_FIELDS)), np.int32)
    leaf_value = np.zeros((n_trees, L), np.float32)
    depths = np.zeros(n_trees, np.int32)
    words: List[int] = []
    for ti, t in enumerate(trees):
        ni = max(t.num_leaves - 1, 0)
        depths[ti] = tree_max_depth(t)
        leaf_value[ti, :t.num_leaves] = np.asarray(
            t.leaf_value[:t.num_leaves], np.float32)
        if not ni:
            continue
        rec = nodes[ti, :ni]
        feats = np.asarray(t.split_feature[:ni], np.int64)
        rec[:, F_GROUP] = routing_np["feat_group"][feats]
        rec[:, F_SPAN] = routing_np["span_start"][feats]
        rec[:, F_DEFBIN] = routing_np["default_bin"][feats]
        rec[:, F_BUNDLED] = routing_np["bundled"][feats]
        nanb = routing_np["nan_bin"][feats]
        rec[:, F_HASNAN] = nanb >= 0
        rec[:, F_NANBIN] = np.maximum(nanb, 0)
        mzb = routing_np["mzero_bin"][feats]
        rec[:, F_HASMZ] = mzb >= 0
        rec[:, F_MZBIN] = np.maximum(mzb, 0)
        rec[:, F_NBINS] = routing_np["num_bins"][feats]
        dt = np.asarray(t.decision_type[:ni], np.uint8).astype(np.int32)
        is_cat = (dt & 1) > 0
        rec[:, F_ISCAT] = is_cat
        rec[:, F_DEFLEFT] = (dt & 2) > 0
        thr = np.asarray(t.threshold[:ni], np.float64)
        for f in np.unique(feats[~is_cat]):
            sel = (feats == f) & ~is_cat
            rec[sel, F_THR] = np.searchsorted(bin_mappers[int(f)].upper_bounds,
                                              thr[sel], side="left")
        for i in np.nonzero(is_cat)[0]:
            f = int(feats[i])
            nb = int(routing_np["num_bins"][f])
            nw = (nb + 1 + 31) // 32     # +1: the sentinel bin past the span
            rec[i, F_CATBASE] = len(words)
            k = int(t.threshold_bin[i])
            s, e = int(t.cat_boundaries[k]), int(t.cat_boundaries[k + 1])
            wv = np.asarray(t.cat_threshold[s:e], np.uint32)
            bits = np.zeros(nw, np.uint32)
            cats = bin_mappers[f].categories
            for b in range(min(len(cats), nb)):
                c = int(cats[b])
                if c >= 0 and c // 32 < len(wv) \
                        and (int(wv[c // 32]) >> (c % 32)) & 1:
                    bits[b // 32] |= np.uint32(1 << (b % 32))
            words.extend(int(w) for w in bits)
        for col, child in ((F_LEFT, t.left_child), (F_RIGHT, t.right_child)):
            c = np.asarray(child[:ni], np.int64)
            rec[:, col] = np.where(c >= 0, c, L + ~c)
    cat_words = np.asarray(words or [0], np.uint32)
    return PredictTables(nodes, leaf_value, cat_words, depths)


def leaf_path_sums(t, node_weight=None) -> np.ndarray:
    """(max(num_leaves, 1),) float64: for each leaf of a host Tree, the sum
    of ``node_weight`` (one value per internal node, default 1) over the
    internal nodes on its path from the root, by iterative traversal.  With
    the default weight that is the leaf's depth; a single-leaf tree's leaf 0
    sums nothing."""
    ni = max(t.num_leaves - 1, 0)
    out = np.zeros(max(t.num_leaves, 1), np.float64)
    if ni == 0:
        return out
    w = ([1.0] * ni if node_weight is None
         else np.asarray(node_weight, np.float64)[:ni].tolist())
    lc = np.asarray(t.left_child[:ni]).tolist()
    rc = np.asarray(t.right_child[:ni]).tolist()
    stack = [(0, w[0])]
    while stack:
        node, s = stack.pop()
        for c in (lc[node], rc[node]):
            if c >= 0:
                stack.append((c, s + w[c]))
            else:
                out[~c] = s
    return out


def tree_max_depth(t) -> int:
    """Exact max depth of a host Tree: the routing steps to its deepest leaf
    (leaf-wise trees can be up to num_leaves-1 deep), at least 1."""
    return max(1, int(leaf_path_sums(t).max()))


def tables_to_device(tables: PredictTables, device: torch.device):
    """(nodes int32, leaf_value f32, cat_words int32 bit pattern) tensors."""
    return (torch.as_tensor(tables.nodes).to(device),
            torch.as_tensor(tables.leaf_value).to(device),
            torch.as_tensor(tables.cat_words.view(np.int32)).to(device))


def predict_stream(bins_T: torch.Tensor, nodes: torch.Tensor,
                   leaf_value: torch.Tensor, cat_words: torch.Tensor,
                   depths: Sequence[int], es_freq: int = 0,
                   es_margin: float = 0.0) -> torch.Tensor:
    """Raw scores (N,) f32 of one class: (G, N) uint8 bins, (T, L, 16) int32
    node records, (T, L) f32 leaf values, (W,) int32 bitset words and each
    tree's depth.  es_freq > 0 enables the binary prediction-early-stop
    margin check every es_freq trees."""
    if bins_T.device.type == "cuda":
        return predict_stream_cuda(bins_T, nodes, leaf_value, cat_words,
                                   int(max(depths, default=1)), es_freq,
                                   es_margin)
    if bins_T.device.type == "cpu":
        return predict_stream_plain(bins_T, nodes, leaf_value, cat_words,
                                    depths, es_freq, es_margin)
    raise LightGBMError(f"predict_stream has no kernel for device "
                        f"{bins_T.device}")


def predict_stream_cuda(bins_T, nodes, leaf_value, cat_words,
                        max_depth: int, es_freq: int = 0,
                        es_margin: float = 0.0) -> torch.Tensor:
    """Launch csrc/predict_stream.cu on the current stream."""
    dev = bins_T.device
    T, L, nf = nodes.shape
    for name, x, dtype in (("bins_T", bins_T, torch.uint8),
                           ("nodes", nodes, torch.int32),
                           ("leaf_value", leaf_value, torch.float32),
                           ("cat_words", cat_words, torch.int32)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise LightGBMError(
                f"predict_stream: {name} must be a contiguous {dtype} tensor "
                f"on {dev}, got {x.dtype} on {x.device}")
    if (nf != len(NODE_FIELDS) or tuple(leaf_value.shape) != (T, L)
            or bins_T.dim() != 2 or cat_words.numel() < 1):
        raise LightGBMError("predict_stream: table shapes do not agree")
    n = bins_T.shape[1]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0 or T == 0:
        return out.zero_()
    fn = build.load("predict_stream").lgbt_predict_stream
    rc = fn(bins_T.data_ptr(), n, nodes.data_ptr(), leaf_value.data_ptr(),
            cat_words.data_ptr(), T, L, int(max_depth), int(es_freq),
            float(es_margin), out.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"predict_stream kernel launch failed "
                            f"(cudaError {rc})")
    predict_stream_cuda.launches += 1
    return out


predict_stream_cuda.launches = 0


def walk_tree_plain(bins_T: torch.Tensor, tnodes: torch.Tensor,
                    cat_words: torch.Tensor, depth: int) -> torch.Tensor:
    """Leaf index (N,) int64 of every row in one tree: the kernel's walk
    written with tensor ops over all rows at once."""
    L = tnodes.shape[0]
    n = bins_T.shape[1]
    rows = torch.arange(n, device=bins_T.device)
    enc = torch.zeros(n, dtype=torch.int64, device=bins_T.device)
    for _ in range(depth):
        at_leaf = enc >= L
        nd = tnodes[torch.where(at_leaf, 0, enc)]            # (N, 16)
        gb = bins_T[nd[:, F_GROUP].long(), rows].to(torch.int32)
        ls = gb - nd[:, F_SPAN]
        defbin = nd[:, F_DEFBIN]
        in_span = (ls >= 0) & (ls < nd[:, F_NBINS] - 1)
        fb_b = torch.where(in_span, ls + (ls >= defbin).to(torch.int32),
                           defbin)
        fb = torch.where(nd[:, F_BUNDLED] > 0, fb_b, gb)
        missing = (((nd[:, F_HASNAN] > 0) & (fb == nd[:, F_NANBIN]))
                   | ((nd[:, F_HASMZ] > 0) & (fb == nd[:, F_MZBIN])))
        go_left = torch.where(missing, nd[:, F_DEFLEFT] > 0,
                              fb <= nd[:, F_THR])
        is_cat = nd[:, F_ISCAT] > 0
        wi = torch.where(is_cat, nd[:, F_CATBASE] + (fb >> 5), 0)
        cbit = ((cat_words[wi.long()] >> (fb & 31)) & 1) > 0
        go_left = torch.where(is_cat, cbit, go_left)
        nxt = torch.where(go_left, nd[:, F_LEFT], nd[:, F_RIGHT]).long()
        enc = torch.where(at_leaf, enc, nxt)
    return torch.where(enc >= L, enc - L, 0)


def predict_stream_plain(bins_T, nodes, leaf_value, cat_words,
                         depths: Sequence[int], es_freq: int = 0,
                         es_margin: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract: each tree walked with
    tensor ops over all rows, leaf values added in float32 in tree order.
    Frozen rows (early stop) add nothing further, as in the kernel."""
    n = bins_T.shape[1]
    score = torch.zeros(n, dtype=torch.float32, device=bins_T.device)
    active = torch.ones(n, dtype=torch.bool, device=bins_T.device)
    for t in range(nodes.shape[0]):
        leaf = walk_tree_plain(bins_T, nodes[t], cat_words, int(depths[t]))
        lv = leaf_value[t][leaf]
        if es_freq:
            score = score + torch.where(active, lv, 0.0)
            if (t + 1) % es_freq == 0:
                active = active & ~(2.0 * score.abs() > es_margin)
        else:
            score = score + lv
    return score
