"""Batch prediction over binned rows: tables, the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of ``lightgbm_tpu/pallas/predict_kernel.py:158-340``
(``predict_stream``, ``build_predict_tables``, ``tree_max_depth``).  The TPU
kernel digit-encodes every node field in 7 bits and splits leaf values into
bf16 hi/lo pairs so that its one-hot bf16 matmuls stay exact.  The port's
host tables are plain int32 node records of 16 fields and exact float32 leaf
values; on the device the records travel as word planes (``pack_nodes``):
two words that every routing step reads (16-bit children; group, threshold
bin and a special-node bit), and the rest, read only at special nodes (NaN
or zero bins, EFB bundles, categorical bitsets, and, over 16-bit bins, a
threshold or missing bin too wide for the walk words).  The CUDA kernel
(``csrc/predict_stream.cu``) walks tiles of rows through stages of trees
copied into shared memory, under the launch plan ``predict_plan``.  Its sums
are closer to the host float64 walk than the TPU kernel's, and the two
packages agree to a tolerance (rtol 1e-4, atol 1e-5), not bit for bit.

Its leaf form (``predict_leaf``, pred_leaf) walks the same way and writes
each (row, tree) leaf index into an (N, trees) int32 matrix instead of
summing; it replaces the JAX package's host loop over trees.
``predict_stream`` and ``predict_leaf`` launch the CUDA kernel for tensors
on a CUDA device and run their plain versions only for tensors on the CPU.
A kernel that fails to build or launch raises; nothing falls back to the
plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..utils.log import LightGBMError
from . import build
from .hist_wide import SMEM_BLOCK, SMEM_SM, SMS, _cdiv
from .layout import bin_bytes, bin_values

# int32 fields of one host node record (build_predict_tables)
NODE_FIELDS = ("group", "span_start", "default_bin", "bundled",
               "has_nan", "nan_bin", "has_mz", "mz_bin",
               "num_bins", "threshold_bin", "default_left", "is_cat",
               "left", "right", "cat_base", "unused")
(F_GROUP, F_SPAN, F_DEFBIN, F_BUNDLED, F_HASNAN, F_NANBIN, F_HASMZ, F_MZBIN,
 F_NBINS, F_THR, F_DEFLEFT, F_ISCAT, F_LEFT, F_RIGHT, F_CATBASE,
 F_UNUSED) = range(len(NODE_FIELDS))

# int32 word planes of the packed nodes (pack_nodes), in the order of the C
# enum in csrc/predict_stream.cu.  The walk reads two words a step:
# ``children16`` (left child in the low 16 bits, right in the high 16) and
# ``group_thr`` (group in bits 0-15, threshold bin in bits 16-30, bit 31
# set at a special node: NaN or zero bin, EFB bundle, categorical, a wide
# field, or children past 16 bits); a special node's step reads the rest.
# ``threshold`` is the whole threshold bin and ``missing`` the NaN bin in
# bits 0-15 and the zero bin in bits 16-31 (NO_BIN16: none); the walk reads
# them only at a node whose flags set ``wide_bit``: a threshold bin past
# group_thr's 15 bits or a missing bin past the flags' 9-bit codes, which
# only 16-bit bins (groups or features wider than 256 bins) reach.
PACKED_WORDS = ("children16", "group_thr", "flags", "left", "right",
                "span_start", "default_bin", "num_bins", "cat_base",
                "threshold", "missing")
# the flags word: the NaN and zero bins as 9-bit codes (NO_BIN: none), then
# one bit each
FLAG_BITS = (("nan_shift", 0), ("mz_shift", 9), ("default_left_bit", 18),
             ("is_cat_bit", 19), ("bundled_bit", 20), ("wide_bit", 21))
NAN_SHIFT, MZ_SHIFT, DEFLEFT_BIT, ISCAT_BIT, BUNDLED_BIT, WIDE_BIT = (
    b for _, b in FLAG_BITS)
BIN_BITS = 9
NO_BIN = (1 << BIN_BITS) - 1
NO_BIN16 = 0xFFFF                  # ``missing``'s code of none
THR_BITS = 15                      # group_thr's threshold bin
SPECIAL_BIT = 31                   # group_thr's special-node bit
CHILD16_MAX_L = 1 << 15            # children fit 16 bits up to this L


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


def pack_nodes(nodes: np.ndarray) -> np.ndarray:
    """(11, T, L) int32 word planes (``PACKED_WORDS``) of (T, L, 16) host
    records, each word of every node of a tree contiguous, so that the
    kernel stages a tree's two walk words as two contiguous runs.  Every
    field of every node kind round-trips (``unpack_nodes``).  A threshold
    bin past 32767 or a NaN or zero bin past 510 (16-bit bins) makes the
    node special and wide: its step reads ``threshold`` and ``missing``.
    Raises where a field is outside its packed width: a group past 65535,
    a negative threshold bin, a NaN or zero bin past 65534, a flag other
    than 0 or 1, or a missing-value bin set where its flag is not
    (build_predict_tables writes 0 there)."""
    rec = np.asarray(nodes, np.int64)
    if rec.ndim != 3 or rec.shape[2] != len(NODE_FIELDS):
        raise LightGBMError(f"pack_nodes takes (T, L, {len(NODE_FIELDS)}) "
                            f"records, got {rec.shape}")
    L = rec.shape[1]
    flags = rec[..., [F_BUNDLED, F_HASNAN, F_HASMZ, F_DEFLEFT, F_ISCAT]]
    bad = []
    if not ((0 <= rec[..., F_GROUP]) & (rec[..., F_GROUP] < 1 << 16)).all():
        bad.append("group")
    if not (0 <= rec[..., F_THR]).all():
        bad.append("threshold_bin")
    if not ((flags == 0) | (flags == 1)).all():
        bad.append("flags")
    for has, b, name in ((F_HASNAN, F_NANBIN, "nan_bin"),
                         (F_HASMZ, F_MZBIN, "mz_bin")):
        ok = np.where(rec[..., has] > 0,
                      (0 <= rec[..., b]) & (rec[..., b] < NO_BIN16),
                      rec[..., b] == 0)
        if not ok.all():
            bad.append(name)
    if (rec[..., F_UNUSED] != 0).any():
        bad.append("unused")
    if bad:
        raise LightGBMError(f"pack_nodes: fields outside the packed record: "
                            f"{bad}")
    nan16 = np.where(rec[..., F_HASNAN] > 0, rec[..., F_NANBIN], NO_BIN16)
    mz16 = np.where(rec[..., F_HASMZ] > 0, rec[..., F_MZBIN], NO_BIN16)
    thr = rec[..., F_THR]
    wide = ((thr >= 1 << THR_BITS) | ((nan16 >= NO_BIN) & (nan16 != NO_BIN16))
            | ((mz16 >= NO_BIN) & (mz16 != NO_BIN16)))
    nan = np.where(nan16 < NO_BIN, nan16, NO_BIN)
    mz = np.where(mz16 < NO_BIN, mz16, NO_BIN)
    flag_word = ((nan << NAN_SHIFT) | (mz << MZ_SHIFT)
                 | (rec[..., F_DEFLEFT] << DEFLEFT_BIT)
                 | (rec[..., F_ISCAT] << ISCAT_BIT)
                 | (rec[..., F_BUNDLED] << BUNDLED_BIT)
                 | (wide.astype(np.int64) << WIDE_BIT))
    special = ((rec[..., F_HASNAN] | rec[..., F_HASMZ] | rec[..., F_BUNDLED]
                | rec[..., F_ISCAT]) > 0) | wide | (L > CHILD16_MAX_L)
    group_thr = (rec[..., F_GROUP] | (np.where(wide, 0, thr) << 16)
                 | (special.astype(np.int64) << SPECIAL_BIT))
    children16 = (np.where(L > CHILD16_MAX_L, 0, (rec[..., F_LEFT] & 0xFFFF)
                           | ((rec[..., F_RIGHT] & 0xFFFF) << 16)))
    words = np.stack([children16, group_thr, flag_word, rec[..., F_LEFT],
                      rec[..., F_RIGHT], rec[..., F_SPAN], rec[..., F_DEFBIN],
                      rec[..., F_NBINS], rec[..., F_CATBASE], thr,
                      nan16 | (mz16 << 16)], axis=0)
    # int64 -> uint32 bit pattern -> int32
    return np.ascontiguousarray(
        (words & 0xFFFFFFFF).astype(np.uint32).view(np.int32))


def unpack_nodes(packed: torch.Tensor) -> torch.Tensor:
    """(T, L, 16) int32 host records of (11, T, L) packed word planes, with
    tensor ops on the packed tensor's device: the walk's threshold and
    missing bins as the kernel reads them, from the walk words and the
    flags, or from ``threshold`` and ``missing`` at a wide node."""
    (_, group_thr, flags, left, right, span, defbin, nbins, catbase,
     thr_full, missing) = (packed[i].to(torch.int64) & 0xFFFFFFFF
                           for i in range(len(PACKED_WORDS)))
    wide = ((flags >> WIDE_BIT) & 1) > 0
    nan = torch.where(wide, missing & 0xFFFF, (flags >> NAN_SHIFT) & NO_BIN)
    mz = torch.where(wide, missing >> 16, (flags >> MZ_SHIFT) & NO_BIN)
    none = torch.where(wide, NO_BIN16, NO_BIN)
    thr = torch.where(wide, thr_full, (group_thr >> 16)
                      & ((1 << THR_BITS) - 1))
    fields = [group_thr & 0xFFFF, span, defbin, (flags >> BUNDLED_BIT) & 1,
              (nan != none).to(torch.int64), torch.where(nan != none, nan, 0),
              (mz != none).to(torch.int64), torch.where(mz != none, mz, 0),
              nbins, thr, (flags >> DEFLEFT_BIT) & 1,
              (flags >> ISCAT_BIT) & 1, left, right, catbase,
              torch.zeros_like(left)]
    # back to the int32 bit pattern of each field
    out = torch.stack(fields, dim=-1)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def tables_to_device(tables: PredictTables, device: torch.device):
    """(packed nodes int32, leaf_value f32, cat_words int32 bit pattern)
    tensors."""
    return (torch.as_tensor(pack_nodes(tables.nodes)).to(device),
            torch.as_tensor(tables.leaf_value).to(device),
            torch.as_tensor(tables.cat_words.view(np.int32)).to(device))


class PredictPlan(NamedTuple):
    """One launch of csrc/predict_stream.cu, in the field order the C side
    reads.

    Block b owns rows [b * rows_per_tile, (b + 1) * rows_per_tile), one
    a thread of its ``threads`` threads (``tiles`` blocks).
    It walks every tree over its rows, ``trees_per_stage`` trees at a time
    copied into shared memory while the stage before is walked (two
    stages); 0: the trees are too large for a stage and their records are
    read from global memory.  ``bins_stride`` > 0 stages the tile's (G,
    rows) bins in shared memory, that many bins a group (a byte each, or
    two for 16-bit bins); 0 leaves them in global memory.  ``smem``: the
    block's dynamic shared memory."""
    rows_per_tile: int
    threads: int
    tiles: int
    trees_per_stage: int
    bins_stride: int
    smem: int


PREDICT_PLAN_FIELDS = PredictPlan._fields
# bytes of one tree node in a stage: its two walk words and its leaf value
STAGE_NODE_BYTES = 12
SM_THREADS = 1536                  # one-row threads an SM holds (csrc
                                   # kMinBlocks blocks of kMaxThreads)
MAX_THREADS = 512                  # a block's threads (csrc kMaxThreads)
BIN_STAGE_MAX = 64 * 1024          # the most bin bytes a tile stages


def _round16(x: int) -> int:
    return 16 * _cdiv(x, 16)


def stage_bytes(trees: int, L: int) -> int:
    """Shared memory of one stage: ``trees`` trees' children words, their
    group-and-threshold words and their leaf values, padded to 16 bytes."""
    return _round16(STAGE_NODE_BYTES * trees * L)


@functools.lru_cache(maxsize=256)
def predict_plan(n_rows: int, G: int, L: int, n_trees: int,
                 bin_width: int = 1) -> PredictPlan:
    """The launch plan of one K1 launch over ``n_rows`` rows of G groups of
    ``bin_width`` bytes a bin and ``n_trees`` trees of L node slots: 512
    threads of one row, up to 8 trees a stage, three blocks an SM."""
    return _predict_plan(n_rows, G, L, n_trees, SMEM_BLOCK, 512,
                         bin_width=bin_width)


def _predict_plan(n: int, G: int, L: int, T: int, smem_budget: int,
                  threads: int, stage_trees: int = 8,
                  bin_width: int = 1) -> PredictPlan:
    """``predict_plan`` with the block's shared memory, threads and most
    trees a stage given, so that tests reach trees and bins in global
    memory at small shapes.

    Rows: one a thread (several a thread measured slower on the card,
    PERF.md), in the fewest tiles of at most ``threads`` rows that fill
    whole waves of blocks over the card, each tile a multiple of 16
    rows (the bins' 16-byte copy).  Bins: staged where the tile's G x rows
    bins (``bin_width`` bytes each) stay within 64 KB and half the budget.
    Trees: up to
    ``stage_trees`` a stage, as many as let the SM hold the blocks its
    threads allow (one block, where not even one tree fits that), no more
    than there are; none where a tree does not fit."""
    cap = threads
    bins_stride = _round16(min(cap, _round16(max(n, 1)))) + 16
    if G * bins_stride * bin_width > min(BIN_STAGE_MAX, smem_budget // 2):
        bins_stride = 0
    bins_bytes = G * bins_stride * bin_width
    ts = 0
    for per_sm in (max(1, SM_THREADS // threads), 1):
        room = min(smem_budget, SMEM_SM // per_sm - 1024) - bins_bytes
        fit = max(room, 0) // (2 * STAGE_NODE_BYTES * L)
        while fit and 2 * stage_bytes(fit, L) > room:
            fit -= 1
        if fit:
            ts = min(fit, max(T, 1), stage_trees)
            break
    smem = bins_bytes + (2 * stage_bytes(ts, L) if ts else 0)
    per_sm = max(1, min(SM_THREADS // threads, SMEM_SM // (smem + 1024)))
    wave = SMS * per_sm
    tiles = _cdiv(max(n, 1), cap)
    tiles = max(tiles, min(wave, _cdiv(max(n, 1), 16)))
    if tiles > wave:
        tiles = wave * _cdiv(tiles, wave)
    rows_per_tile = min(cap, _round16(_cdiv(max(n, 1), tiles)))
    tiles = _cdiv(max(n, 1), rows_per_tile)
    return PredictPlan(rows_per_tile, threads, tiles, ts, bins_stride, smem)


def plan_arg(plan: PredictPlan) -> ctypes.Array:
    """The plan as the C side's int64 array."""
    return (ctypes.c_int64 * len(PREDICT_PLAN_FIELDS))(*plan)


def predict_stream(bins_T: torch.Tensor, nodes: torch.Tensor,
                   leaf_value: torch.Tensor, cat_words: torch.Tensor,
                   depths: Sequence[int], es_freq: int = 0,
                   es_margin: float = 0.0) -> torch.Tensor:
    """Raw scores (N,) f32 of one class: (G, N) bins (uint8, or the int16
    storage of 16-bit bins), (11, T, L) int32 packed nodes
    (``pack_nodes``), (T, L) f32 leaf values, (W,) int32
    bitset words and each tree's depth.  es_freq > 0 enables the binary
    prediction-early-stop margin check every es_freq trees."""
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
    """Launch csrc/predict_stream.cu on the current stream under
    ``predict_plan`` of the shapes."""
    dev = bins_T.device
    width = bin_bytes(bins_T)
    build.check_operands("predict_stream", dev, (
        ("bins_T", bins_T, bins_T.dtype), ("nodes", nodes, torch.int32),
        ("leaf_value", leaf_value, torch.float32),
        ("cat_words", cat_words, torch.int32)))
    if (nodes.dim() != 3 or nodes.shape[0] != len(PACKED_WORDS)
            or tuple(leaf_value.shape) != tuple(nodes.shape[1:])
            or bins_T.dim() != 2 or cat_words.numel() < 1):
        raise LightGBMError("predict_stream: table shapes do not agree")
    _, T, L = nodes.shape
    G, n = bins_T.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0 or T == 0:
        return out.zero_()
    plan = predict_plan(n, G, L, T, width)
    fn = build.load("predict_stream").lgbt_predict_stream
    rc = fn(bins_T.data_ptr(), width, n, G, nodes.data_ptr(),
            leaf_value.data_ptr(), cat_words.data_ptr(), T, L,
            max(int(max_depth), 1), int(es_freq), float(es_margin),
            out.data_ptr(), plan_arg(plan),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"predict_stream kernel launch failed "
                            f"(cudaError {rc}, plan {tuple(plan)})")
    build.count_launch(predict_stream_cuda, width)
    return out


build.init_counts(predict_stream_cuda)


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
        gb = bin_values(bins_T[nd[:, F_GROUP].long(), rows])
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


def predict_leaf(bins_T: torch.Tensor, nodes: torch.Tensor,
                 leaf_value: torch.Tensor, cat_words: torch.Tensor,
                 depths: Sequence[int], out: torch.Tensor, col0: int = 0,
                 col_step: int = 1) -> torch.Tensor:
    """K1's leaf form: the leaf index of every row in every tree of one
    class, written as int32 into ``out`` (N, columns), tree t at column
    ``col0 + t * col_step`` (class c of K at ``c`` and step K); the
    operands as ``predict_stream``'s.  Returns ``out``."""
    if bins_T.device.type == "cuda":
        return predict_leaf_cuda(bins_T, nodes, leaf_value, cat_words,
                                 int(max(depths, default=1)), out, col0,
                                 col_step)
    if bins_T.device.type == "cpu":
        return predict_leaf_plain(bins_T, nodes, cat_words, depths, out,
                                  col0, col_step)
    raise LightGBMError(f"predict_leaf has no kernel for device "
                        f"{bins_T.device}")


def predict_leaf_cuda(bins_T, nodes, leaf_value, cat_words, max_depth: int,
                      out: torch.Tensor, col0: int = 0,
                      col_step: int = 1) -> torch.Tensor:
    """Launch the leaf form of csrc/predict_stream.cu (``lgbt_predict_leaf``)
    on the current stream under ``predict_plan`` of the shapes."""
    dev = bins_T.device
    width = bin_bytes(bins_T)
    build.check_operands("predict_leaf", dev, (
        ("bins_T", bins_T, bins_T.dtype), ("nodes", nodes, torch.int32),
        ("leaf_value", leaf_value, torch.float32),
        ("cat_words", cat_words, torch.int32), ("out", out, torch.int32)))
    if (nodes.dim() != 3 or nodes.shape[0] != len(PACKED_WORDS)
            or tuple(leaf_value.shape) != tuple(nodes.shape[1:])
            or bins_T.dim() != 2 or cat_words.numel() < 1 or out.dim() != 2
            or out.shape[0] != bins_T.shape[1]):
        raise LightGBMError("predict_leaf: table shapes do not agree")
    _, T, L = nodes.shape
    G, n = bins_T.shape
    if col0 < 0 or col_step < 1 or col0 + (T - 1) * col_step >= out.shape[1]:
        raise LightGBMError("predict_leaf: columns outside the output")
    if n == 0 or T == 0:
        return out
    plan = predict_plan(n, G, L, T, width)
    fn = build.load("predict_leaf").lgbt_predict_leaf
    rc = fn(bins_T.data_ptr(), width, n, G, nodes.data_ptr(),
            leaf_value.data_ptr(), cat_words.data_ptr(), T, L,
            max(int(max_depth), 1), out.data_ptr(), out.shape[1], col0,
            col_step, plan_arg(plan),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"predict_leaf kernel launch failed "
                            f"(cudaError {rc}, plan {tuple(plan)})")
    build.count_launch(predict_leaf_cuda, width)
    return out


build.init_counts(predict_leaf_cuda)


def predict_leaf_plain(bins_T, nodes, cat_words, depths: Sequence[int],
                       out: torch.Tensor, col0: int = 0,
                       col_step: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the leaf form: ``walk_tree_plain`` of each
    tree, stacked into the tree's column."""
    nodes = unpack_nodes(nodes)
    for t in range(nodes.shape[0]):
        out[:, col0 + t * col_step] = walk_tree_plain(
            bins_T, nodes[t], cat_words, int(depths[t])).to(torch.int32)
    return out


def predict_stream_plain(bins_T, nodes, leaf_value, cat_words,
                         depths: Sequence[int], es_freq: int = 0,
                         es_margin: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract: the packed nodes
    unpacked, each tree walked with tensor ops over all rows, leaf values
    added in float32 in tree order.  Frozen rows (early stop) add nothing
    further, as in the kernel."""
    nodes = unpack_nodes(nodes)
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
