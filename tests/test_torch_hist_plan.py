"""The launch plan of the row-order histogram kernel (K5 ``scatter_hist``
and K8 ``hist_wide``, ``csrc/hist_rows.cu``), and of the histogram pass of
both forms of K2 (``csrc/route_and_hist.cu``), which share its tile pass
(``csrc/hist_tile.cuh``) in smaller cells, on the CPU.

``kernels/hist_wide.py::hist_plan`` picks, from (N, G, K, S, Bmax) alone,
how the kernel's shared-memory tiles of (class, slot) pairs x groups x bins
spread over the grid, and how the rows split into ranges.  The kernel
itself runs only on the card (``chip_smoke.py`` holds it bit for bit
against its plain version there); these tests hold the plan to what the
kernel needs:

- every (class, slot) pair of every group belongs to exactly one tile in
  every row range, and every row to exactly one range;
- a block's dynamic shared memory stays within the sm_90 limit, and every
  field within the limits the C side checks, in the order it reads them;
- an int64 emulation that adds tile by tile in the plan's order, with the
  kernel's 32-bit split words and carries, then flushes and converts as
  the kernel does, equals ``hist3_plain`` and ``hist_wide_plain`` bit for
  bit: integer sums, so no tolerance;
- the same for K2: its float form's two split-word channels against
  ``build_histograms_gh``, its int form's int32 words against
  ``build_histograms_int``, at 16- and 8-byte cells, edge weights and the
  int32 gate's edge included.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st

from lightgbm_torch.kernels import hist_wide as khw
from lightgbm_torch.kernels import route_hist as krh
from lightgbm_torch.kernels import scatter_hist as ksh
from lightgbm_torch.ops.histogram import (build_histograms_gh,
                                          build_histograms_int, hist3_plain,
                                          hist_shift)

MASK32 = np.uint64(0xFFFFFFFF)


def _limits(plan, n, G, K, S, Bmax, cell_bytes=khw.CELL_BYTES):
    """The limits the tile pass checks before it launches (plan_ok in
    csrc/hist_tile.cuh), for cells of ``cell_bytes``."""
    P = K * S
    ppt, gpt = plan.pairs_per_tile, plan.groups_per_tile
    assert ppt >= 1 and gpt >= 1
    assert plan.pair_tiles * ppt >= P > (plan.pair_tiles - 1) * ppt
    assert plan.group_tiles * gpt >= G > (plan.group_tiles - 1) * gpt
    assert plan.group_tiles <= 65535 and 1 <= plan.row_ranges <= 65535
    assert plan.rows_per_range >= 4 and plan.rows_per_range % 4 == 0
    assert plan.row_ranges * plan.rows_per_range >= n
    assert plan.row_ranges == 1 or (plan.row_ranges - 1) \
        * plan.rows_per_range < n
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.smem == ppt * gpt * Bmax * cell_bytes
    assert plan.smem <= khw.SMEM_BLOCK


def _tiles(plan, K, S, G):
    """[(pair range, group range)] of every tile of the plan."""
    ppt, gpt = plan.pairs_per_tile, plan.groups_per_tile
    return [((px * ppt, min(px * ppt + ppt, K * S)),
             (gy * gpt, min(gy * gpt + gpt, G)))
            for px in range(plan.pair_tiles)
            for gy in range(plan.group_tiles)]


def _check_partition(plan, n, G, K, S):
    covered = np.zeros((K * S, G), np.int64)
    for (p0, p1), (g0, g1) in _tiles(plan, K, S, G):
        assert p0 < p1 and g0 < g1          # no tile is empty
        covered[p0:p1, g0:g1] += 1
    assert (covered == 1).all()
    starts = np.arange(plan.row_ranges) * plan.rows_per_range
    assert starts[0] == 0 and (starts < max(n, 1)).all()


@settings(max_examples=300, deadline=None)
@given(S=st.integers(1, 64), Bmax=st.integers(2, 256), K=st.integers(1, 10),
       G=st.integers(1, 64), n=st.integers(0, 10 ** 6))
def test_plan_owns_every_pair_once_within_limits(S, Bmax, K, G, n):
    plan = khw.hist_plan(n, G, K, S, Bmax)
    _limits(plan, n, G, K, S, Bmax)
    assert plan.threads == khw.THREADS
    _check_partition(plan, n, G, K, S)


@settings(max_examples=200, deadline=None)
@given(S=st.integers(1, 64), Bmax=st.integers(2, 256), K=st.integers(1, 10),
       G=st.integers(1, 64), n=st.integers(0, 10 ** 5),
       budget=st.integers(40, khw.SMEM_BLOCK),
       threads=st.sampled_from([32, 64, 256, 1024]))
def test_small_budget_plans_partition_within_limits(S, Bmax, K, G, n,
                                                    budget, threads):
    """The plans the emulation tests use to reach many tiles and row
    ranges at small shapes keep the same limits and partition."""
    plan = khw._plan(n, G, K, S, Bmax, budget, threads)
    _limits(plan, n, G, K, S, Bmax)
    assert plan.smem <= max(budget, Bmax * khw.CELL_BYTES)
    _check_partition(plan, n, G, K, S)


def test_plan_fields_follow_the_c_enum():
    """kernels/hist_wide.py::PLAN_FIELDS is the order the tile pass
    (csrc/hist_tile.cuh, which csrc/hist_rows.cu includes) reads the plan
    array in."""
    src = (Path(khw.__file__).parent / "csrc" / "hist_tile.cuh").read_text()
    enum = re.search(r"enum \{([^}]*)\}", src).group(1)
    names = [w.strip() for w in enum.split(",") if w.strip()]
    camel = ["k" + "".join(w.title() for w in f.split("_"))
             for f in khw.PLAN_FIELDS]
    assert names == camel


def emulate(plan, bins_T, slot, grad, hess, cnt, S, Bmax, shifts):
    """(K, S, G, Bmax, 3) float32 histograms summed as csrc/hist_rows.cu
    sums them under ``plan``: for each row range, each tile's block adds
    each (row, class) whose pair the tile holds into its shared-memory
    words, then flushes them into the int64 sums, which are converted
    once.  Tiles hold low and high 32-bit words (the low word's carries go
    to the high word) and 32-bit counts."""
    G, n = bins_T.shape
    K = slot.shape[0]
    P = K * S
    q = plan
    vals = [np.stack([np.rint(grad[k].astype(np.float64) * 2.0 ** shifts[k]),
                      np.rint(hess[k].astype(np.float64) * 2.0 ** shifts[k])])
            .astype(np.int64).view(np.uint64) for k in range(K)]
    counts = np.rint(cnt).astype(np.int64).view(np.uint64)
    acc = np.zeros((P, G, Bmax, 3), np.uint64)
    for z in range(q.row_ranges):
        r0 = z * q.rows_per_range
        rows = np.arange(r0, min(r0 + q.rows_per_range, n))
        for (c0, c1), (g0, g1) in _tiles(q, K, S, G):
            shape = (c1 - c0, g1 - g0, Bmax)
            lo = np.zeros((2,) + shape, np.uint64)   # sums of low words
            hi = np.zeros((2,) + shape, np.uint64)   # sums of high words
            c = np.zeros(shape, np.uint64)
            for k in range(c0 // S, (c1 - 1) // S + 1):
                s = slot[k, rows].astype(np.int64)
                p = k * S + s
                ok = (s >= 0) & (s < S) & (p >= c0) & (p < c1)
                r, lp = rows[ok], p[ok] - c0
                v = vals[k][:, r]
                for gl in range(g1 - g0):
                    b = bins_T[g0 + gl, r].astype(np.int64)
                    for j in range(2):
                        np.add.at(lo[j], (lp, gl, b), v[j] & MASK32)
                        np.add.at(hi[j], (lp, gl, b), v[j] >> np.uint64(32))
                    np.add.at(c, (lp, gl, b), counts[r])
            # the tile's words, then its flush
            lo_w = lo & MASK32
            hi_w = (hi + (lo >> np.uint64(32))) & MASK32
            tile = (hi_w << np.uint64(32)) | lo_w
            cnt32 = (c & MASK32).astype(np.uint32).view(np.int32)
            acc[c0:c1, g0:g1, :, :2] += np.moveaxis(tile, 0, -1)
            acc[c0:c1, g0:g1, :, 2] += cnt32.astype(np.int64).view(np.uint64)
    out = acc.view(np.int64).astype(np.float32).reshape(K, S, G, Bmax, 3)
    for k in range(K):
        out[k, ..., :2] *= np.float32(2.0 ** -shifts[k])
    return out


def _case(seed, n, G, K, S, Bmax, kind="random"):
    rs = np.random.RandomState(seed)
    bins = rs.randint(0, Bmax, size=(G, n)).astype(np.uint8)
    slot = np.where(rs.rand(K, n) < 0.7, rs.randint(0, S, size=(K, n)),
                    -1).astype(np.int32)
    grad = rs.randn(K, n).astype(np.float32)
    hess = rs.uniform(0.01, 1.0, size=(K, n)).astype(np.float32)
    cnt = (rs.rand(n) < 0.9).astype(np.float32)
    if kind == "one_cell":          # every row in slot 0 and bin 0
        bins[:] = 0
        slot[:] = 0
    elif kind == "edge":            # the largest weights the shift allows
        grad = np.where(rs.rand(K, n) < 0.5, -1.0, 1.0).astype(np.float32)
        grad *= np.float32(1.5)
        hess[:] = np.float32(1.5)
        bins[:] = 0
        slot[:] = 0
        cnt[:] = 1.0
    elif kind == "negative":        # no row in any slot
        slot[:] = -1 - rs.randint(0, 5, size=(K, n))
    shifts = [hist_shift(float(max(np.abs(grad[k]).max(initial=0.0),
                                   np.abs(hess[k]).max(initial=0.0))), n)
              for k in range(K)]
    return bins, slot, grad, hess, cnt, shifts


def _plain(bins, slot, grad, hess, cnt, S, Bmax, shifts):
    t = torch.as_tensor
    return khw.hist_wide_plain(t(bins), t(slot), t(grad), t(hess), t(cnt),
                               S, Bmax, shifts).numpy()


# (n, G, K, S, Bmax, kind, (shared-memory budget, threads) or None for
# the default plan): small budgets and thread counts force tiles of a share
# of one class's slots, of several classes' slots, of few groups, and many
# row ranges, at test sizes
CASES = [
    (2000, 5, 1, 1, 63, "random", None),
    (2003, 5, 1, 16, 255, "random", None),
    (1500, 5, 10, 64, 256, "random", None),
    (1024, 6, 10, 7, 256, "random", (20000, 32)),
    (1999, 7, 3, 5, 40, "random", (2400, 32)),
    (1501, 4, 2, 9, 17, "random", (700, 64)),
    (1024, 6, 10, 7, 256, "random", (200000, 32)),
    (997, 3, 4, 13, 9, "random", (200, 32)),
    (1200, 9, 1, 64, 255, "random", (60000, 32)),
    (777, 3, 2, 4, 31, "one_cell", (1000, 32)),
    (4096, 3, 3, 2, 8, "edge", (400, 32)),
    (4096, 3, 3, 2, 8, "edge", None),
    (500, 2, 3, 64, 63, "negative", (5000, 32)),
    (1, 1, 1, 1, 256, "random", None),
    (1, 3, 2, 3, 5, "random", (100, 32)),
    (0, 4, 2, 6, 10, "random", (300, 32)),
]


def _plan_of(n, G, K, S, Bmax, opts):
    if opts is None:
        return khw.hist_plan(n, G, K, S, Bmax)
    return khw._plan(n, G, K, S, Bmax, *opts)


@pytest.mark.parametrize("n,G,K,S,Bmax,kind,opts", CASES)
def test_emulated_plan_equals_plain_bit_for_bit(n, G, K, S, Bmax, kind,
                                                opts):
    bins, slot, grad, hess, cnt, shifts = _case(n + K * S, n, G, K, S, Bmax,
                                                kind)
    plan = _plan_of(n, G, K, S, Bmax, opts)
    _limits(plan, n, G, K, S, Bmax)
    got = emulate(plan, bins, slot, grad, hess, cnt, S, Bmax, shifts)
    want = _plain(bins, slot, grad, hess, cnt, S, Bmax, shifts)
    np.testing.assert_array_equal(got, want)
    if K == 1:      # K5's contract is K8's at K = 1
        t = torch.as_tensor
        k5 = ksh.scatter_hist_plain(t(bins), t(slot[0]), t(grad[0]),
                                    t(hess[0]), t(cnt), S, Bmax, shifts[0])
        np.testing.assert_array_equal(got[0], k5.numpy())


def test_edge_weights_fill_the_int64_range():
    """At the shift hist_shift picks for the largest weight, n equal
    weights in one cell sum to within a factor 4 of 2**62: the split
    words carry on almost every add and the high words are far from 0."""
    n, G, K, S, Bmax = 4096, 3, 3, 2, 8
    bins, slot, grad, hess, cnt, shifts = _case(5, n, G, K, S, Bmax, "edge")
    total = n * 1.5 * 2.0 ** shifts[0]
    assert 2.0 ** 60 <= total < 2.0 ** 62
    plan = khw._plan(n, G, K, S, Bmax, 400, 32)
    assert plan.pair_tiles > 1 and plan.group_tiles > 1 \
        and plan.row_ranges > 1
    got = emulate(plan, bins, slot, grad, hess, cnt, S, Bmax, shifts)
    want = hist3_plain(torch.as_tensor(bins), torch.as_tensor(slot[0]),
                       torch.as_tensor(grad[0]), torch.as_tensor(hess[0]),
                       torch.as_tensor(cnt), S, Bmax, shifts[0]).numpy()
    np.testing.assert_array_equal(got[0], want)
    assert want[0, :, 0, 1].tolist() == [np.float32(1.5 * n)] * G


@pytest.mark.parametrize("n,K,S,Bmax,ppt,gpt", [
    (1_000_000, 1, 1, 63, 1, 28), (1_000_000, 1, 1, 255, 1, 28),
    (900_000, 10, 1, 63, 1, 28), (1_000_000, 1, 64, 63, 64, 2),
    (1_000_000, 1, 64, 255, 32, 1), (900_000, 10, 64, 63, 64, 2),
    (900_000, 10, 64, 255, 32, 1)])
def test_main_path_plans(n, K, S, Bmax, ppt, gpt):
    """The plans of the training path's launches: a block holds the slots
    of one class (half of them for 64 slots at Bmax 255) and as many
    groups as fit, so it reads the slots and weights of one class only; at
    the root (S = 1) that is every group."""
    plan = khw.hist_plan(n, 28, K, S, Bmax)
    _limits(plan, n, 28, K, S, Bmax)
    assert (plan.pairs_per_tile, plan.groups_per_tile) == (ppt, gpt)
    assert plan.pair_tiles * ppt == K * S
    # at least one full wave of blocks over the card's SMs
    assert plan.pair_tiles * plan.group_tiles * plan.row_ranges >= khw.SMS


# --------------------------------------------------------------------------
# K2: the histogram pass of both forms on the same tile pass
# --------------------------------------------------------------------------

K2_CELLS = (krh.CELL_BYTES, krh.INT_CELL_BYTES)


@settings(max_examples=200, deadline=None)
@given(S=st.integers(1, 64), Bmax=st.integers(2, 256), K=st.integers(1, 10),
       G=st.integers(1, 64), n=st.integers(0, 10 ** 6),
       cell=st.sampled_from(K2_CELLS),
       budget=st.one_of(st.none(), st.integers(8, khw.SMEM_BLOCK)),
       threads=st.sampled_from([32, 256, 1024]))
def test_k2_plan_owns_every_pair_once_within_limits(S, Bmax, K, G, n, cell,
                                                    budget, threads):
    """At K2's 16- and 8-byte cells (the default plan, or a small budget
    that forces many tiles), every (class, slot) pair of every group lies
    in one tile per row range, every row in one range, within the limits
    the C side checks."""
    plan = (khw.hist_plan(n, G, K, S, Bmax, cell) if budget is None
            else khw._plan(n, G, K, S, Bmax, budget, threads, cell))
    _limits(plan, n, G, K, S, Bmax, cell)
    _check_partition(plan, n, G, K, S)


@pytest.mark.parametrize("n,G,K,S,Bmax,plan", [
    (1_000_000, 28, 1, 1, 63, (1, 28, 1, 1, 132, 7576, 1024, 35280)),
    (1_000_000, 28, 1, 1, 255, (1, 28, 1, 1, 132, 7576, 1024, 142800)),
    (900_000, 28, 10, 1, 63, (1, 28, 10, 1, 23, 39132, 1024, 35280)),
    (1_000_000, 28, 1, 64, 63, (64, 2, 1, 14, 17, 58824, 1024, 161280)),
    (1_000_000, 28, 1, 64, 255, (32, 1, 2, 28, 7, 142860, 1024, 163200)),
    (900_000, 28, 10, 64, 63, (64, 2, 10, 14, 5, 180000, 1024, 161280)),
    (900_000, 28, 10, 64, 255, (32, 1, 20, 28, 2, 450000, 1024, 163200)),
    (1_000_000, 28, 1, 16, 63, (16, 11, 1, 3, 44, 22728, 1024, 221760)),
    (900_000, 28, 10, 16, 255, (16, 2, 10, 14, 5, 180000, 1024, 163200)),
    (250_001, 28, 3, 21, 200, (21, 2, 3, 14, 6, 41668, 1024, 168000)),
    (100_003, 1, 1, 7, 256, (7, 1, 1, 1, 25, 4004, 1024, 35840)),
    (0, 28, 10, 64, 63, (64, 2, 10, 14, 1, 4, 1024, 161280))])
def test_k5_k8_plans_unchanged_by_the_cell_size(n, G, K, S, Bmax, plan):
    """K5 and K8 (20-byte cells, the default) get the plans they had
    before the cell size became an argument."""
    # (the bin-tile fields: every bin in one tile)
    plan = plan + (Bmax, 1)
    assert tuple(khw.hist_plan(n, G, K, S, Bmax)) == plan
    assert tuple(khw.hist_plan(n, G, K, S, Bmax, khw.CELL_BYTES)) == plan


@pytest.mark.parametrize("n,K", [(1_000_000, 1), (900_000, 10)])
@pytest.mark.parametrize("cell,Bmax,ppt,gpt", [
    (krh.CELL_BYTES, 63, 64, 3), (krh.CELL_BYTES, 255, 32, 1),
    (krh.INT_CELL_BYTES, 63, 64, 7), (krh.INT_CELL_BYTES, 255, 64, 1)])
def test_k2_main_path_plans(n, K, cell, Bmax, ppt, gpt):
    """K2's plans at the training path's 64 slots: the float form's 16-byte
    cells fit 64 slots x 3 groups at Bmax 63 and half the slots x 1 group
    at 255; the int form's 8-byte cells 64 x 7 and 64 x 1.  At the root
    (S = 1) a tile holds every group."""
    plan = khw.hist_plan(n, 28, K, 64, Bmax, cell)
    _limits(plan, n, 28, K, 64, Bmax, cell)
    assert (plan.pairs_per_tile, plan.groups_per_tile) == (ppt, gpt)
    assert plan.pair_tiles * ppt == K * 64
    assert plan.pair_tiles * plan.group_tiles * plan.row_ranges >= khw.SMS
    root = khw.hist_plan(n, 28, K, 1, Bmax, cell)
    assert (root.pairs_per_tile, root.groups_per_tile) == (1, 28)


def emulate_k2(plan, bins_T, slot, grad, hess, S, Bmax, shifts=None):
    """(K, S, G, Bmax, 2) histograms summed as K2's histogram pass sums
    them under ``plan``: for each row range, each tile's block adds each
    (row, class) whose pair the tile holds into its shared-memory words,
    then flushes them.  Float form (``shifts`` given): grad and hess
    rounded to int64 multiples of 2**-shift_k, a tile's low and high 32-bit
    words per channel (the low word's carries go to the high word), flushed
    into int64 sums converted once.  Int form (``shifts`` None): the int8
    grid values in one 32-bit word per channel, flushed with 32-bit adds
    into the int32 result."""
    G, n = bins_T.shape
    K = slot.shape[0]
    P = K * S
    q = plan
    if shifts is None:
        vals = [np.stack([grad[k], hess[k]]).astype(np.int64)
                for k in range(K)]
    else:
        vals = [np.stack([np.rint(grad[k].astype(np.float64)
                                  * 2.0 ** shifts[k]),
                          np.rint(hess[k].astype(np.float64)
                                  * 2.0 ** shifts[k])]).astype(np.int64)
                for k in range(K)]
    vals = [v.view(np.uint64) for v in vals]
    acc = np.zeros((P, G, Bmax, 2), np.uint64)
    for z in range(q.row_ranges):
        r0 = z * q.rows_per_range
        rows = np.arange(r0, min(r0 + q.rows_per_range, n))
        for (c0, c1), (g0, g1) in _tiles(q, K, S, G):
            shape = (2, c1 - c0, g1 - g0, Bmax)
            lo = np.zeros(shape, np.uint64)      # sums of low words
            hi = np.zeros(shape, np.uint64)      # sums of high words
            for k in range(c0 // S, (c1 - 1) // S + 1):
                s = slot[k, rows].astype(np.int64)
                p = k * S + s
                ok = (s >= 0) & (s < S) & (p >= c0) & (p < c1)
                r, lp = rows[ok], p[ok] - c0
                v = vals[k][:, r]
                for gl in range(g1 - g0):
                    b = bins_T[g0 + gl, r].astype(np.int64)
                    for j in range(2):
                        np.add.at(lo[j], (lp, gl, b), v[j] & MASK32)
                        np.add.at(hi[j], (lp, gl, b), v[j] >> np.uint64(32))
            if shifts is None:
                # one 32-bit word per channel, flushed with a 32-bit add
                word = (lo & MASK32).astype(np.uint32).view(np.int32)
                acc[c0:c1, g0:g1] += np.moveaxis(
                    word.astype(np.int64).view(np.uint64), 0, -1)
            else:
                lo_w = lo & MASK32
                hi_w = (hi + (lo >> np.uint64(32))) & MASK32
                acc[c0:c1, g0:g1] += np.moveaxis((hi_w << np.uint64(32))
                                                 | lo_w, 0, -1)
    if shifts is None:
        out = (acc & MASK32).astype(np.uint32).view(np.int32)
        return out.reshape(K, S, G, Bmax, 2)
    out = acc.view(np.int64).astype(np.float32).reshape(K, S, G, Bmax, 2)
    for k in range(K):
        out[k] *= np.float32(2.0 ** -shifts[k])
    return out


def _k2_case(seed, n, G, K, S, Bmax, kind, int_form):
    """Slots and weights of one K2 launch's histogram pass: 70 % of the
    rows in random slots, N(0, 1) grads and hesses in [0.01, 1) (int form:
    grid values in [-127, 127] and [0, 127]).  ``kind``: "one_cell" puts
    every row in slot 0 and bin 0; "edge" also makes every weight the
    largest the form takes (float: +-1.5 and 1.5, so the sums reach 2**61;
    int: -127 and 127); "negative" puts no row in any slot."""
    bins, slot, grad, hess, cnt, _ = _case(seed, n, G, K, S, Bmax, kind)
    rs = np.random.RandomState(seed + 1)
    if int_form:
        grad = rs.randint(-127, 128, size=(K, n)).astype(np.int8)
        hess = rs.randint(0, 128, size=(K, n)).astype(np.int8)
        if kind == "edge":
            grad[:] = -127
            hess[:] = 127
        return bins, slot, grad, hess, None
    shifts = [hist_shift(float(max(np.abs(grad[k]).max(initial=0.0),
                                   np.abs(hess[k]).max(initial=0.0))), n)
              for k in range(K)]
    return bins, slot, grad, hess, shifts


def _k2_plain(bins, slot, grad, hess, S, Bmax, shifts):
    t = torch.as_tensor
    if shifts is None:
        return build_histograms_int(t(bins), t(slot), t(grad), t(hess), S,
                                    Bmax).numpy()
    cnt = torch.ones(bins.shape[1], dtype=torch.float32)
    return np.stack([build_histograms_gh(t(bins), t(slot[k]), t(grad[k]),
                                         t(hess[k]), cnt, S, Bmax,
                                         shifts[k])[0].numpy()
                     for k in range(slot.shape[0])])


# (n, G, K, S, Bmax, kind, (shared-memory budget, threads) or None for the
# default plan); each case runs for both forms
K2_CASES = [
    (2000, 5, 1, 1, 63, "random", None),
    (2003, 5, 1, 16, 255, "random", None),
    (1500, 5, 10, 64, 255, "random", None),
    (1024, 6, 10, 7, 256, "random", (20000, 32)),
    (1999, 7, 3, 5, 40, "random", (2400, 32)),
    (1501, 4, 2, 9, 17, "random", (700, 64)),
    (1200, 9, 1, 64, 255, "random", (60000, 32)),
    (777, 3, 2, 4, 31, "one_cell", (1000, 32)),
    (4096, 3, 3, 2, 8, "edge", (300, 32)),
    (500, 2, 3, 64, 63, "negative", (5000, 32)),
    (3001, 1, 4, 3, 5, "random", None),
    (1, 1, 1, 1, 256, "random", None),
    (1, 3, 2, 3, 5, "random", (100, 32)),
    (0, 4, 2, 6, 10, "random", (300, 32)),
]


@pytest.mark.parametrize("int_form", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("n,G,K,S,Bmax,kind,opts", K2_CASES)
def test_k2_emulated_plan_equals_plain_bit_for_bit(n, G, K, S, Bmax, kind,
                                                   opts, int_form):
    cell = krh.INT_CELL_BYTES if int_form else krh.CELL_BYTES
    bins, slot, grad, hess, shifts = _k2_case(n + K * S, n, G, K, S, Bmax,
                                              kind, int_form)
    plan = (khw.hist_plan(n, G, K, S, Bmax, cell) if opts is None
            else khw._plan(n, G, K, S, Bmax, *opts, cell))
    _limits(plan, n, G, K, S, Bmax, cell)
    got = emulate_k2(plan, bins, slot, grad, hess, S, Bmax, shifts)
    want = _k2_plain(bins, slot, grad, hess, S, Bmax, shifts)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_k2_edge_weights_carry_in_every_tile():
    """The float form's edge case sums n weights of 1.5 * 2**shift in one
    cell, within a factor 4 of 2**62, across several pair tiles, group
    tiles and row ranges: the split words carry on almost every add."""
    n, G, K, S, Bmax = 4096, 3, 3, 2, 8
    bins, slot, grad, hess, shifts = _k2_case(5, n, G, K, S, Bmax, "edge",
                                              False)
    assert 2.0 ** 60 <= n * 1.5 * 2.0 ** shifts[0] < 2.0 ** 62
    plan = khw._plan(n, G, K, S, Bmax, 300, 32, krh.CELL_BYTES)
    assert plan.pair_tiles > 1 and plan.group_tiles > 1 \
        and plan.row_ranges > 1
    got = emulate_k2(plan, bins, slot, grad, hess, S, Bmax, shifts)
    np.testing.assert_array_equal(got, _k2_plain(bins, slot, grad, hess, S,
                                                 Bmax, shifts))
    assert got[:, 0, :, 0, 1].tolist() == [[np.float32(1.5 * n)] * G] * K


def test_k2_int_sums_at_the_int32_gate():
    """The int form at the caller's gate: 2**31 // 127 rows of grid values
    -127 and 127 in one cell sum to within 127 of -2**31 and 2**31 - 1;
    the 32-bit tile words and flush hold them exactly, in one tile or
    spread over row ranges."""
    n = 2 ** 31 // 127
    bins = np.zeros((1, n), np.uint8)
    slot = np.zeros((1, n), np.int32)
    grad = np.full((1, n), -127, np.int8)
    hess = np.full((1, n), 127, np.int8)
    want = _k2_plain(bins, slot, grad, hess, 1, 1, None)
    assert want[0, 0, 0, 0].tolist() == [-127 * n, 127 * n]
    assert -2 ** 31 <= -127 * n and 127 * n < 2 ** 31
    plan = khw.hist_plan(n, 1, 1, 1, 1, krh.INT_CELL_BYTES)
    assert plan.row_ranges > 1
    # one range's words, then the flushes into the result, as uint32
    total = np.zeros(2, np.uint64)
    for z in range(plan.row_ranges):
        m = min(plan.rows_per_range, n - z * plan.rows_per_range)
        word = (np.array([-127 * m, 127 * m]).view(np.uint64)) & MASK32
        total = (total + word) & MASK32
    got = total.astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got, want[0, 0, 0, 0])


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A kernel's library is named by a hash of its source and of every
    shared header under csrc/, so that editing csrc/hist_tile.cuh (which
    K2, K5 and K8 include) builds their libraries anew instead of loading
    a stale one."""
    from lightgbm_torch.kernels import build
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text('#include "tile.cuh"\n')
    (tmp_path / "csrc" / "tile.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "_HERE", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {"k": "csrc/k.cu"})
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "csrc" / "tile.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "csrc" / "k.cu").write_text('#include "tile.cuh"\n// .\n')
    assert build.library_path("k") not in (first, second)
