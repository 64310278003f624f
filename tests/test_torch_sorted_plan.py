"""K6 ``hist_direct``'s and K7 ``hist_nibble``'s launch plan and tile pass
over the slot-sorted block plan, on the CPU.

K6 (Bmax <= 128) and K7 (Bmax > 128: up to 256 over uint8 bins, 65 536
over 16-bit bins) are one kernel (``csrc/hist_sorted.cu``
``direct_kernel``): it adds the rows of the plan's blocks into
shared-memory tiles of one slot x ``groups_per_tile`` groups x
``bins_per_tile`` bins (all Bmax, except past 256 bins where one group's
cells exceed a block), in the split 32-bit words of the row-order kernels'
tile pass
(``csrc/hist_tile.cuh``, 20-byte cells), each block over a range of plan
blocks, flushing into an int64 sum when the slot changes and at the range's
end; ``kernels/hist_sorted.py::sorted_plan`` picks the tiles and ranges.
The kernel runs only on the card (``chip_smoke.py`` holds it bit for bit
against its plain version there); these tests hold:

- every plan block in one range and every group and bin in one tile,
  within the sm_90 limits the C side checks, K6's and K7's main-path plans
  pinned (K7's at Bmax 255 and, over 16-bit bins, 301), and the plan's
  field order equal to the C enum;
- an int64 emulation of the pass (split words with carries, one flush per
  slot run in a range, pad blocks skipped, pad positions adding nothing)
  equal to ``hist_sorted_plain`` bit for bit: integer sums, no tolerance;
- ``hist_sorted_plain`` equal to the JAX package's
  ``build_histograms_sorted`` (``lightgbm_tpu/pallas/hist_kernel.py:357``,
  Pallas in interpret mode: ``_hist_direct`` at Bmax <= 128, ``_hist_nibble``
  above) at the same block plan, on dyadic weights that its bf16 hi/lo
  split keeps exact.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from lightgbm_tpu.pallas import hist_kernel as jhk

from lightgbm_torch.kernels import hist_sorted as khs
from lightgbm_torch.kernels import hist_wide as khw
from lightgbm_torch.kernels.layout import bins_to_torch
from lightgbm_torch.ops.compact import num_blocks, plan_blocks, \
    plan_single_slot
from lightgbm_torch.ops.histogram import hist_shift

MASK32 = np.uint64(0xFFFFFFFF)
SRC = Path(khs.__file__).parent / "csrc" / "hist_sorted.cu"


def _limits(plan, NB, G, Bmax):
    """The limits direct_plan_ok in csrc/hist_sorted.cu checks (a bin axis
    only past 256 bins, where the bins are 16-bit)."""
    gpt, bpt = plan.groups_per_tile, plan.bins_per_tile
    if Bmax <= 256:
        assert (bpt, plan.bin_tiles) == (Bmax, 1)
    assert 1 <= bpt <= Bmax and 1 <= plan.bin_tiles <= 65535
    assert plan.bin_tiles * bpt >= Bmax > (plan.bin_tiles - 1) * bpt
    assert plan.bin_tiles == 1 or gpt == 1
    assert gpt >= 1 and 1 <= plan.group_tiles <= 65535
    assert plan.group_tiles * gpt >= G > (plan.group_tiles - 1) * gpt
    assert plan.blocks_per_range >= 1 and 1 <= plan.ranges <= 2 ** 31 - 1
    assert plan.ranges * plan.blocks_per_range >= NB
    assert (plan.ranges - 1) * plan.blocks_per_range < max(NB, 1)
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.smem == gpt * bpt * khw.CELL_BYTES
    assert plan.smem <= khw.SMEM_BLOCK


def _ranges(plan, NB):
    return [range(x * plan.blocks_per_range,
                  min((x + 1) * plan.blocks_per_range, NB))
            for x in range(plan.ranges)]


@settings(max_examples=300, deadline=None)
@given(NB=st.integers(0, 20_000), T=st.sampled_from([32, 256, 1024, 4096]),
       S=st.integers(1, 64), G=st.integers(1, 3000),
       Bmax=st.integers(1, 128))
def test_plan_owns_every_block_and_group_once(NB, T, S, G, Bmax):
    plan = khs.sorted_plan(NB, T, S, G, Bmax)
    _limits(plan, NB, G, Bmax)
    blocks = [b for r in _ranges(plan, NB) for b in r]
    assert blocks == list(range(NB))
    groups = [g for y in range(plan.group_tiles)
              for g in range(y * plan.groups_per_tile,
                             min((y + 1) * plan.groups_per_tile, G))]
    assert groups == list(range(G))
    if plan.group_tiles > 1 and plan.groups_per_tile >= 4:
        # a row's group bytes load as whole words where a tile allows it
        cap = khw.SMEM_BLOCK // (Bmax * khw.CELL_BYTES)
        assert plan.groups_per_tile % 4 == 0 or \
            4 * -(-plan.groups_per_tile // 4) > cap


@settings(max_examples=300, deadline=None)
@given(NB=st.integers(0, 20_000), T=st.sampled_from([32, 256, 1024, 4096]),
       S=st.integers(1, 64), G=st.integers(1, 3000),
       Bmax=st.integers(129, 256))
def test_k7_plan_owns_every_block_and_group_once(NB, T, S, G, Bmax):
    """K7's plans (Bmax 129-256): tiles of at most NIBBLE_GROUPS groups, so
    that several blocks share an SM."""
    plan = khs.sorted_plan(NB, T, S, G, Bmax)
    _limits(plan, NB, G, Bmax)
    assert [b for r in _ranges(plan, NB) for b in r] == list(range(NB))
    groups = [g for y in range(plan.group_tiles)
              for g in range(y * plan.groups_per_tile,
                             min((y + 1) * plan.groups_per_tile, G))]
    assert groups == list(range(G))
    assert plan.groups_per_tile <= khs.NIBBLE_GROUPS
    if G >= khs.NIBBLE_GROUPS:
        # whole words of 4 groups' bins
        assert plan.groups_per_tile % 4 == 0


@settings(max_examples=300, deadline=None)
@given(NB=st.integers(0, 20_000), T=st.sampled_from([32, 256, 1024, 4096]),
       S=st.integers(1, 64), G=st.integers(1, 300),
       Bmax=st.integers(257, 65536))
def test_k7_wide_plan_owns_every_block_group_and_bin_once(NB, T, S, G,
                                                          Bmax):
    """K7's third range (16-bit bins, Bmax > 256): bins tile only where one
    group's cells exceed a block's shared memory (Bmax > 11 622), and then
    a tile holds one group and an even share of the bins."""
    plan = khs.sorted_plan(NB, T, S, G, Bmax)
    _limits(plan, NB, G, Bmax)
    assert [b for r in _ranges(plan, NB) for b in r] == list(range(NB))
    groups = [g for y in range(plan.group_tiles)
              for g in range(y * plan.groups_per_tile,
                             min((y + 1) * plan.groups_per_tile, G))]
    assert groups == list(range(G))
    bins = [b for z in range(plan.bin_tiles)
            for b in range(z * plan.bins_per_tile,
                           min((z + 1) * plan.bins_per_tile, Bmax))]
    assert bins == list(range(Bmax))
    tiled = Bmax * khw.CELL_BYTES > khw.SMEM_BLOCK
    assert (plan.bin_tiles > 1) == tiled
    assert plan.groups_per_tile <= khs.NIBBLE_GROUPS
    # the blocks of one launch fit the grid's y and z limits
    assert plan.group_tiles <= 65535 and plan.bin_tiles <= 65535


@settings(max_examples=200, deadline=None)
@given(NB=st.integers(0, 5_000), S=st.integers(1, 64),
       G=st.integers(1, 64), Bmax=st.integers(1, 128),
       budget=st.integers(20, khw.SMEM_BLOCK),
       threads=st.sampled_from([32, 128, 256, 1024]),
       waves=st.integers(0, 4))
def test_small_budget_plans_within_limits(NB, S, G, Bmax, budget, threads,
                                          waves):
    plan = khs._sorted_plan(NB, 1024, S, G, Bmax, budget, threads, waves)
    _limits(plan, NB, G, Bmax)
    assert plan.smem <= max(budget, Bmax * khw.CELL_BYTES)


def test_main_path_plan_pinned():
    """Phase train_backends at max_bin 63: 1M rows in blocks of 1024 and 64
    slots.  The tile of one slot's 28 groups x 64 bins is 35 840 bytes,
    four blocks an SM; one plan block a range makes two waves."""
    NB = 1_000_000 // 1024 + 64
    assert khs.sorted_plan(NB, 1024, 64, 28, 64) == khs.SortedPlan(
        groups_per_tile=28, group_tiles=1, blocks_per_range=1, ranges=NB,
        threads=256, smem=35840, bins_per_tile=64, bin_tiles=1)
    # the real plan's block count; the root's plan takes two plan blocks
    # a range, one wave
    assert num_blocks(1_000_000, 64, 1024) == NB + 1
    assert khs.sorted_plan(NB + 1, 1024, 64, 28, 64).ranges == NB + 1
    root = khs.sorted_plan(num_blocks(1_000_000, 1, 1024), 1024, 1, 28, 63)
    assert (root.blocks_per_range, root.ranges) == (2, 489)


def test_k7_main_path_plan_pinned():
    """Phase train_backends at max_bin 255: 1M rows in blocks of 1024, 28
    groups of 255 bins.  Tiles of 8 groups (40 800 bytes, four blocks an
    SM; the three 8-group tiles and one of 4 over the 28 groups); four plan
    blocks a range at 64 slots (two waves), eight at the root (one wave):
    the fastest of scripts/torch_hist_bench.py's sweep on an NVIDIA H100
    (tiles of 28, 16, 12, 8 and 4 groups x 256, 512 and 1024 threads x 1-12
    plan blocks a range)."""
    NB = num_blocks(1_000_000, 64, 1024)
    assert khs.sorted_plan(NB, 1024, 64, 28, 255) == khs.SortedPlan(
        groups_per_tile=8, group_tiles=4, blocks_per_range=4, ranges=261,
        threads=256, smem=40800, bins_per_tile=255, bin_tiles=1)
    root = khs.sorted_plan(num_blocks(1_000_000, 1, 1024), 1024, 1, 28, 255)
    assert root == khs.SortedPlan(
        groups_per_tile=8, group_tiles=4, blocks_per_range=8, ranges=123,
        threads=256, smem=40800, bins_per_tile=255, bin_tiles=1)
    # K6's plan is untouched by K7's group limit
    assert khs.sorted_plan(NB, 1024, 64, 28, 128).groups_per_tile == 28
    # the Flight Delay cell (phase train_wide: 500 000 rows, 8 groups, two
    # bundles of 301 bins, 16-bit): one tile of all 8 groups, no bin tiles
    NB = num_blocks(500_000, 64, 1024)
    assert khs.sorted_plan(NB, 1024, 64, 8, 301) == khs.SortedPlan(
        groups_per_tile=8, group_tiles=1, blocks_per_range=1, ranges=NB,
        threads=256, smem=48160, bins_per_tile=301, bin_tiles=1)
    # past 11 622 bins a tile holds one group and a range of the bins
    assert khs.sorted_plan(NB, 1024, 64, 3, 40_000)[6:] == (10_000, 4)


def test_plan_fields_follow_the_c_enum():
    src = SRC.read_text()
    enum = [b for b in re.findall(r"enum \{([^}]*)\}", src)
            if "kGroupsPerTile" in b][0]
    names = [w.strip() for w in enum.split(",") if w.strip()]
    camel = ["k" + "".join(w.title() for w in f.split("_"))
             for f in khs.SORTED_PLAN_FIELDS]
    # the C side prefixes the two fields hist_tile.cuh also names
    assert [n.replace("kPlan", "k") for n in names] == camel


# --------------------------------------------------- the kernel's pass

def emulate(plan, bins, gather_idx, scalars, grad, hess, cnt, S, Bmax,
            shift, T):
    """(S, G, Bmax, 3) float32 histograms summed as csrc/hist_sorted.cu's
    direct_kernel sums them under ``plan``: each (range, group tile) block
    walks its plan blocks, skips a block whose slot is outside [0, S) or
    whose first position is the pad row, flushes its tile into the int64
    sums when the slot changes and at the end, and adds each position's
    row (pad positions add nothing, nor a row whose bin lies outside a
    bin-tiled block's bins) in low and high 32-bit words (the low words'
    carries go to the high word) and 32-bit counts."""
    n, G = bins.shape
    NB = scalars.shape[0]
    vals = np.stack([np.rint(grad.astype(np.float64) * 2.0 ** shift),
                     np.rint(hess.astype(np.float64) * 2.0 ** shift)]
                    ).astype(np.int64).view(np.uint64)
    counts = np.rint(cnt).astype(np.int64).view(np.uint64)
    acc = np.zeros((S, G, Bmax, 3), np.uint64)
    gpt, bpt = plan.groups_per_tile, plan.bins_per_tile
    flushes = 0
    for blocks in _ranges(plan, NB):
        for y, z in [(y, z) for y in range(plan.group_tiles)
                     for z in range(plan.bin_tiles)]:
            g0, g1 = y * gpt, min((y + 1) * gpt, G)
            b0, b1 = z * bpt, min((z + 1) * bpt, Bmax)
            shape = (g1 - g0, b1 - b0)
            tile = None
            cur = -1

            def flush():
                lo, hi, c = tile
                lo_w = lo & MASK32
                hi_w = (hi + (lo >> np.uint64(32))) & MASK32
                words = (hi_w << np.uint64(32)) | lo_w
                acc[cur, g0:g1, b0:b1, :2] += np.moveaxis(words, 0, -1)
                c32 = (c & MASK32).astype(np.uint32).view(np.int32)
                acc[cur, g0:g1, b0:b1, 2] += \
                    c32.astype(np.int64).view(np.uint64)

            for blk in blocks:
                s = int(scalars[blk, 0])
                idx = gather_idx[blk * T:(blk + 1) * T].astype(np.int64)
                if s < 0 or s >= S or idx[0] >= n:
                    continue
                if s != cur:
                    if cur >= 0:
                        flush()
                        flushes += 1
                    tile = (np.zeros((2,) + shape, np.uint64),
                            np.zeros((2,) + shape, np.uint64),
                            np.zeros(shape, np.uint64))
                    cur = s
                r = idx[(idx >= 0) & (idx < n)]
                lo, hi, c = tile
                for gl in range(g1 - g0):
                    b = bins[r, g0 + gl].astype(np.int64) - b0
                    # a row whose bin lies outside the tile's bins skips
                    inside = (b >= 0) & (b < b1 - b0)
                    rr, b = r[inside], b[inside]
                    for j in range(2):
                        np.add.at(lo[j], (gl, b), vals[j, rr] & MASK32)
                        np.add.at(hi[j], (gl, b),
                                  vals[j, rr] >> np.uint64(32))
                    np.add.at(c, (gl, b), counts[rr])
            if cur >= 0:
                flush()
                flushes += 1
    out = acc.view(np.int64).astype(np.float32)
    out[..., :2] *= np.float32(2.0 ** -shift)
    return out, flushes


def _case(seed, n, G, S, Bmax, kind):
    rs = np.random.RandomState(seed)
    bins = rs.randint(0, Bmax, size=(n, G)).astype(
        np.uint8 if Bmax <= 256 else np.uint16)
    slot = np.where(rs.rand(n) < 0.7, rs.randint(0, S, n), -1).astype(
        np.int32)
    if S > 2:
        slot[slot == 1] = -1                    # a slot with no rows
    grad = rs.randn(n).astype(np.float32)
    hess = rs.uniform(0.01, 1.0, n).astype(np.float32)
    cnt = (rs.rand(n) < 0.9).astype(np.float32)
    if kind == "one_slot":                      # every row in one slot
        slot[:] = S - 1
    elif kind == "edge":                        # weights at the shift's edge
        grad = np.where(rs.rand(n) < 0.5, -1.5, 1.5).astype(np.float32)
        hess[:] = 1.5
        cnt[:] = 1.0
        bins[:] = 0
        slot[:] = 0
    elif kind == "single_rows":                 # one row in most slots
        slot[:] = -1
        slot[rs.choice(n, size=min(n, S - 1), replace=False)] = \
            np.arange(min(n, S - 1))
    elif kind == "none":                        # no row in any slot
        slot[:] = -1
    elif kind == "top_bin":                     # every bin Bmax - 1
        bins[:] = Bmax - 1
    shift = hist_shift(float(max(np.abs(grad).max(initial=0.0),
                                 np.abs(hess).max(initial=0.0))), n)
    return bins, slot, grad, hess, cnt, shift


# (n, G, S, Bmax, T, kind, (budget, threads, waves) or None for the
# default plan): small budgets split the groups over tiles, waves=0 puts
# every plan block in one range, so that slot runs meet inside a range
CASES = [
    (3000, 5, 6, 64, 256, "random", None),
    (3000, 5, 6, 64, 256, "random", (0, 32, 0)),
    (2999, 7, 13, 128, 128, "random", (3 * 128 * 20, 32, 0)),
    (2999, 7, 13, 17, 128, "random", (4 * 17 * 20, 64, 1)),
    (4096, 3, 2, 8, 512, "edge", None),
    (4096, 3, 2, 8, 512, "edge", (0, 32, 0)),
    (2500, 4, 64, 63, 64, "random", None),
    (2500, 4, 64, 63, 64, "single_rows", (0, 32, 0)),
    (1500, 6, 3, 40, 256, "one_slot", (0, 32, 0)),
    (700, 1, 7, 2, 32, "random", None),
    (800, 3, 5, 31, 64, "none", None),
    (1, 28, 3, 63, 1024, "random", None),
    (0, 4, 3, 10, 64, "random", None),
    # K7: Bmax 129-256 under its own plan (tiles of at most 8 groups), pad
    # blocks, a ragged end, one cell taking every row, several group tiles
    (3000, 5, 6, 129, 256, "random", None),
    (2999, 9, 13, 200, 128, "random", None),
    (2999, 13, 13, 255, 128, "random", (4 * 255 * 20, 32, 0)),
    (2500, 28, 64, 255, 64, "random", None),
    (4096, 3, 2, 255, 512, "edge", None),
    (1500, 6, 3, 256, 256, "one_slot", (0, 32, 0)),
    (2500, 4, 64, 256, 64, "single_rows", None),
    (1, 10, 3, 255, 1024, "random", None),
    # K7 over 16-bit bins (int16 storage): Bmax 257, 301 and 1525, the top
    # bin, and budgets that tile the bin axis (one group a tile, a range of
    # bins; rows outside a tile's bins skip)
    (3000, 5, 6, 257, 256, "random", None),
    (2999, 8, 13, 301, 128, "random", None),
    (2000, 3, 6, 1525, 256, "top_bin", None),
    (2999, 3, 13, 1525, 128, "random", (1525 * 20 // 4, 32, 0)),
    (2500, 2, 5, 700, 64, "top_bin", (700 * 20 // 3, 64, 1)),
    (1500, 4, 3, 301, 256, "one_slot", (301 * 20 - 1, 32, 0)),
]


def _plan_of(NB, T, S, G, Bmax, opts):
    if opts is None:
        return khs.sorted_plan(NB, T, S, G, Bmax)
    budget, threads, waves = opts
    return khs._sorted_plan(NB, T, S, G, Bmax, budget, threads, waves)


@pytest.mark.parametrize("n,G,S,Bmax,T,kind,opts", CASES)
def test_emulated_pass_equals_plain_bit_for_bit(n, G, S, Bmax, T, kind,
                                                opts):
    bins, slot, grad, hess, cnt, shift = _case(n + S, n, G, S, Bmax, kind)
    t = torch.as_tensor
    # no rows: plan_blocks sorts nothing, so take the root's plan of no
    # row (one block of pad positions)
    plan_b = (plan_single_slot(n, T) if kind == "edge" or n == 0
              else plan_blocks(t(slot), S, T))
    gi, sc = plan_b.gather_idx.numpy(), plan_b.scalars.numpy()
    plan = _plan_of(sc.shape[0], T, S, G, Bmax, opts)
    _limits(plan, sc.shape[0], G, Bmax)
    got, flushes = emulate(plan, bins, gi, sc, grad, hess, cnt, S, Bmax,
                           shift, T)
    want = khs.hist_sorted_plain(bins_to_torch(bins), plan_b.gather_idx,
                                 plan_b.scalars,
                                 t(grad), t(hess), t(cnt), S, Bmax, shift,
                                 T).numpy()
    np.testing.assert_array_equal(got, want)
    if opts is not None and opts[2] == 0 and plan.group_tiles == 1:
        # one range: a flush per slot that holds rows
        rows_in = slot if kind != "edge" else np.zeros(n, np.int32)
        assert flushes == len(np.unique(rows_in[rows_in >= 0]))
    if kind == "edge":
        # sums reach within a factor 4 of 2**62 (the shift's edge)
        assert np.abs(got[0, :, 0, :2]).max() * 2.0 ** shift >= 2 ** 60


@pytest.mark.parametrize("S,Bmax", [(6, 255), (1, 255), (3, 129)])
def test_plain_equals_jax_nibble(S, Bmax, monkeypatch):
    """At Bmax > 128 the JAX package's build_histograms_sorted runs
    _hist_nibble (interpret mode): hist_sorted_plain and the emulation of
    K7's pass under its plan equal it at the same block plan."""
    monkeypatch.setattr(jhk, "_INTERPRET", True)
    rs = np.random.RandomState(S + Bmax)
    n, G, T = 1500, 5, 256
    bins = rs.randint(0, Bmax, size=(n, G)).astype(np.uint8)
    slot = (np.zeros(n, np.int32) if S == 1
            else np.where(rs.rand(n) < 0.7, rs.randint(0, S, n), -1)
            .astype(np.int32))
    grad = (np.round(64 * rs.randn(n)) / 64).astype(np.float32)
    hess = (np.round(16 * rs.rand(n)) / 16 + 0.5).astype(np.float32)
    cnt = (rs.rand(n) > 0.2).astype(np.float32)
    grad, hess = grad * cnt, hess * cnt
    shift = hist_shift(float(max(np.abs(grad).max(), hess.max())), n)
    want = np.asarray(jhk.build_histograms_sorted(
        jnp.asarray(bins), jnp.asarray(slot), jnp.asarray(grad),
        jnp.asarray(hess), jnp.asarray(cnt), S, Bmax, block_rows=T))
    t = torch.as_tensor
    plan_b = (plan_single_slot(n, T) if S == 1
              else plan_blocks(t(slot), S, T))
    got = khs.hist_sorted_plain(t(bins), plan_b.gather_idx, plan_b.scalars,
                                t(grad), t(hess), t(cnt), S, Bmax, shift, T)
    np.testing.assert_array_equal(got.numpy(), want)
    plan = khs.sorted_plan(plan_b.scalars.shape[0], T, S, G, Bmax)
    em, _ = emulate(plan, bins, plan_b.gather_idx.numpy(),
                    plan_b.scalars.numpy(), grad, hess, cnt, S, Bmax, shift,
                    T)
    np.testing.assert_array_equal(em, want)


@pytest.mark.parametrize("S,kind", [(6, "random"), (1, "root"),
                                    (64, "random")])
def test_plain_equals_jax_build_histograms_sorted(S, kind, monkeypatch):
    """hist_sorted_plain at the port's block plan equals the JAX package's
    build_histograms_sorted (its _hist_direct in interpret mode) at the
    same plan, on dyadic weights its bf16 hi/lo split keeps exact."""
    monkeypatch.setattr(jhk, "_INTERPRET", True)
    rs = np.random.RandomState(S)
    n, G, Bmax, T = 2000, 5, 64, 256
    bins = rs.randint(0, Bmax, size=(n, G)).astype(np.uint8)
    slot = (np.zeros(n, np.int32) if kind == "root"
            else np.where(rs.rand(n) < 0.7, rs.randint(0, S, n), -1)
            .astype(np.int32))
    grad = (np.round(64 * rs.randn(n)) / 64).astype(np.float32)
    hess = (np.round(16 * rs.rand(n)) / 16 + 0.5).astype(np.float32)
    cnt = (rs.rand(n) > 0.2).astype(np.float32)
    grad, hess = grad * cnt, hess * cnt
    shift = hist_shift(float(max(np.abs(grad).max(), hess.max())), n)
    want = np.asarray(jhk.build_histograms_sorted(
        jnp.asarray(bins), jnp.asarray(slot), jnp.asarray(grad),
        jnp.asarray(hess), jnp.asarray(cnt), S, Bmax, block_rows=T))
    t = torch.as_tensor
    plan_b = (plan_single_slot(n, T) if S == 1
              else plan_blocks(t(slot), S, T))
    got = khs.hist_sorted_plain(t(bins), plan_b.gather_idx, plan_b.scalars,
                                t(grad), t(hess), t(cnt), S, Bmax, shift, T)
    np.testing.assert_array_equal(got.numpy(), want)
    plan = khs.sorted_plan(plan_b.scalars.shape[0], T, S, G, Bmax)
    em, _ = emulate(plan, bins, plan_b.gather_idx.numpy(),
                    plan_b.scalars.numpy(), grad, hess, cnt, S, Bmax, shift,
                    T)
    np.testing.assert_array_equal(em, want)
