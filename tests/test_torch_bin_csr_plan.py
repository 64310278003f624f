"""``bin_csr``'s launch plan and its keyed assembly, on the CPU.

The kernel (``csrc/bin_csr.cu``) runs only on the card, where
``chip_smoke.py`` holds every launch byte for byte against its plain
version and the host.  What it does beside the CUDA is held here:

- ``kernels/bin_csr.py::bin_csr_plan`` (a pure function of the row
  pointers): pinned on the Allstate-shaped 100 000-row chunk, a wide-G
  chunk (the group-range form) and a chunk with one row longer than a
  tile; by hypothesis, every row in exactly one tile, every (tile, group
  range) pair in one block, within the sm_90 shared-memory limit
  (``hist_wide.SMEM_BLOCK``), the tiles balanced by entries;
- a NumPy transcription of the kernel's assembly: each entry's 64-bit key
  (position + 1, its index in the tile, its bin in the group) made from
  the compact column records as the kernel reads them
  (``bin_rows.csr_records``: inline first bounds of short numeric
  features), the entries taken in a random order, the max kept a cell, a
  zero key to the group's zero bin, byte-equal to the port's and the JAX
  package's ``construct_binned_sparse`` and to ``bin_csr_plain`` on
  ``chip_smoke.csr_adversarial_cases`` (duplicates, explicit 0.0 and -0.0,
  shuffled rows, bundles with several non-default features, the sentinel
  predict form, a long row, the wide form, runs of empty rows);
- the field orders and key widths against the C enums and constants.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st

import lightgbm_tpu.binning as jbin

import chip_smoke
from lightgbm_torch import binning as tbin
from lightgbm_torch.kernels import bin_csr as kbc
from lightgbm_torch.kernels import bin_rows as kbr
from lightgbm_torch.kernels import hist_wide as khw
from lightgbm_torch.kernels.layout import bins_to_numpy
from lightgbm_torch.utils.log import LightGBMError

CPU = torch.device("cpu")
SRC = Path(kbc.__file__).resolve().parent / "csrc" / "bin_csr.cu"
# the Allstate-shaped chunk of chip_smoke.py phase train_sparse
ALLSTATE_ROWS, ALLSTATE_ENTRIES, ALLSTATE_GROUPS = 100_000, 2_849_829, 34


def _budget():
    return min(khw.SMEM_BLOCK, khw.SMEM_SM // kbc.BLOCKS_PER_SM - 1024)


def _allstate_indptr():
    """Row pointers shaped as the chunk: 30 sources, each present in 95 %
    of the rows, the total set to the chunk's entries."""
    rs = np.random.RandomState(31)
    counts = (rs.rand(ALLSTATE_ROWS, 30) >= 0.05).sum(axis=1)
    extra = ALLSTATE_ENTRIES - int(counts.sum())
    rows = rs.choice(np.flatnonzero(counts < 30 if extra > 0 else counts > 0),
                     abs(extra), replace=False)
    counts[rows] += np.sign(extra)
    return np.concatenate([[0], np.cumsum(counts)])


def _long_row_indptr():
    counts = np.full(1000, 5)
    counts[500] = 100_000
    return np.concatenate([[0], np.cumsum(counts)])


def _check_plan(indptr, G, plan, starts, sm_count=khw.SMS):
    """The plan's invariants: every row in exactly one tile, every (tile,
    range) pair in one block, limits, balance."""
    n = len(indptr) - 1
    rows = np.diff(starts)
    assert starts[0] == 0 and starts[-1] == n and (rows > 0).all()
    assert plan.tiles == len(rows)
    assert plan.max_rows == (rows.max() if len(rows) else 0)
    assert plan.threads == kbc.THREADS == 256
    assert (plan.ranges - 1) * plan.range_groups < G <= \
        plan.ranges * plan.range_groups
    assert plan.smem == kbc._smem(plan.max_rows, plan.range_groups)
    assert plan.smem <= _budget() <= khw.SMEM_BLOCK
    slots = kbc.BLOCKS_PER_SM * sm_count
    work = plan.tiles * plan.ranges
    assert plan.blocks == min(slots, work)
    if work:
        per_block = np.bincount(np.arange(work) % plan.blocks)
        assert len(per_block) == plan.blocks
        assert per_block.max() - per_block.min() <= 1
    # balance: a tile holds at most an even share of the entries and the
    # longest of its rows
    nnz = int(indptr[-1])
    parts = slots * max(1, -(-nnz // (slots * kbc.TILE_ENTRIES)))
    lens = np.diff(indptr)
    for r0, r1 in zip(starts[:-1], starts[1:]):
        assert indptr[r1] - indptr[r0] <= -(-nnz // parts) + lens[r0:r1].max()
    # the wide form exactly where a tile of WIDE_ROWS rows over every
    # group would not fit
    wide = kbc._smem(kbc.WIDE_ROWS, G) > _budget()
    assert (plan.ranges > 1 or plan.range_groups < G) == wide
    if wide:
        assert plan.max_rows <= kbc.WIDE_ROWS


# shape -> (row pointers, G, the plan)
PINNED = {
    "allstate_chunk": (_allstate_indptr, ALLSTATE_GROUPS,
                       kbc.CsrPlan(1584, 1, 34, 65, 792, 256, 18480)),
    # a CSR Dataset without EFB: every feature alone in its group
    "wide_g": (lambda: np.arange(0, 20_001 * 28, 28), 4228,
               kbc.CsrPlan(1584, 15, 282, 16, 792, 256, 36304)),
    "long_row": (_long_row_indptr, ALLSTATE_GROUPS,
                 kbc.CsrPlan(38, 1, 34, 27, 38, 256, 7680)),
}


@pytest.mark.parametrize("shape", list(PINNED))
def test_plan_pinned_and_within_limits(shape):
    make, G, want = PINNED[shape]
    indptr = make()
    plan, starts = kbc.bin_csr_plan(indptr, G)
    _check_plan(indptr, G, plan, starts)
    assert plan == want
    entries = np.diff(indptr[starts])
    if shape == "allstate_chunk":
        assert indptr[-1] == ALLSTATE_ENTRIES
        # two rounds of tiles of about 1 800 entries on 792 blocks
        assert entries.max() <= -(-ALLSTATE_ENTRIES // 1584) + 30
    if shape == "wide_g":
        # 15 ranges of 282 groups: a tile's keys within a sixth of an SM
        assert plan.ranges * plan.range_groups >= 4228
        assert plan.max_rows == kbc.WIDE_ROWS
    if shape == "long_row":
        # the cuts that fall inside the long row move past it: its tile
        # ends with it, the next starts right after
        tile = int(np.searchsorted(starts, 500, side="right")) - 1
        assert starts[tile + 1] == 501
        assert entries[tile] == entries.max() < 100_000 + 132
        assert np.delete(entries, tile).max() <= 135


@settings(max_examples=150, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(0, 3000),
       G=st.integers(1, 6000), sm_count=st.integers(1, 8),
       blocks_per_sm=st.integers(1, 8),
       tile_entries=st.sampled_from([16, 256, 2048]),
       empty=st.floats(0.0, 0.95), long_rows=st.integers(0, 3))
def test_plan_covers_every_row_once(seed, n, G, sm_count, blocks_per_sm,
                                    tile_entries, empty, long_rows):
    old = kbc.BLOCKS_PER_SM, kbc.TILE_ENTRIES
    kbc.BLOCKS_PER_SM, kbc.TILE_ENTRIES = blocks_per_sm, tile_entries
    try:
        _random_plan(seed, n, G, sm_count, empty, long_rows)
    finally:
        kbc.BLOCKS_PER_SM, kbc.TILE_ENTRIES = old


def _random_plan(seed, n, G, sm_count, empty, long_rows):
    rs = np.random.RandomState(seed)
    counts = rs.poisson(rs.uniform(0.5, 40), n)
    counts[rs.rand(n) < empty] = 0
    if n:
        counts[rs.randint(0, n, long_rows)] = rs.randint(1000, 50_000,
                                                         long_rows)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    plan, starts = kbc.bin_csr_plan(indptr, G, sm_count)
    _check_plan(indptr, G, plan, starts, sm_count)


def _entry_bins(indices, data, tables, records):
    """Each entry's bin as the kernel makes it: inline from its column's
    record (CSR_INLINE), else ``feature_bin`` (``_feature_bins``)."""
    bins = np.zeros(len(indices), np.int64)
    flags = records[indices, 1]
    first = np.ascontiguousarray(records[:, 6:8]).view("<f8")[:, 0][indices]
    inline = (flags & kbr.CSR_INLINE) != 0
    v = data.copy()
    nan = np.isnan(v)
    v[nan] = 0.0
    bins[inline] = (first[inline] < v[inline]).astype(np.int64)
    nan_bin = inline & nan & ((flags & kbr.MISSING_NAN_FLAG) != 0)
    bins[nan_bin] = records[indices[nan_bin], 4] - 1
    col_entry = tables.col_entry.numpy()
    for c in np.unique(indices[~inline]):
        sel = np.flatnonzero((indices == c) & ~inline)
        rec = tables.host_feats[col_entry[c]]
        bins[sel] = kbr._feature_bins(torch.from_numpy(data[sel]), tables,
                                      rec).numpy()
    return bins


def emulate(indptr, indices, data, tables, zeros, transpose, rs):
    """The kernel's assembly in NumPy, tile by tile and range by range
    under ``bin_csr_plan``: keys in shared words, max a cell over the
    entries in a random order, then the write-out."""
    F, G = tables.num_features, tables.num_groups
    n = len(indptr) - 1
    plan, starts = kbc.bin_csr_plan(indptr, G)
    records = tables.csr_records.numpy()
    out = np.zeros((G, n) if transpose else (n, G), np.uint16)
    ok = (indices >= 0) & (indices < F)
    col = np.where(ok, indices, 0)
    has = ok & (records[col, 0] >= 0)
    bins = np.zeros(len(indices), np.int64)
    bins[has] = _entry_bins(col[has], data[has], tables, records)
    rec = records[col]
    bundled = (rec[:, 1] & kbr.BUNDLED) != 0
    d = rec[:, 5]
    takes = has & (~bundled | (bins != d))
    local = np.where(bundled, rec[:, 3] + np.where(bins > d, bins - 1, bins),
                     bins)
    pos = np.where(bundled, rec[:, 2] + 1, 1).astype(np.uint64)
    row_of = np.repeat(np.arange(n), np.diff(indptr))
    for t in rs.permutation(plan.tiles * plan.ranges):
        tile, rng = divmod(int(t), plan.ranges)
        r0, r1 = int(starts[tile]), int(starts[tile + 1])
        g0 = rng * plan.range_groups
        gn = min(G - g0, plan.range_groups)
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        keys = np.zeros((r1 - r0) * gn, np.uint64)
        j = np.arange(e1 - e0)
        sel = e0 + j
        g = rec[sel, 0] - g0
        m = takes[sel] & (g >= 0) & (g < gn)
        key = ((pos[sel] << np.uint64(kbc.KEY_BIN_BITS + kbc.KEY_INDEX_BITS))
               | (j.astype(np.uint64) << np.uint64(kbc.KEY_BIN_BITS))
               | local[sel].astype(np.uint64))
        cell = (row_of[sel] - r0) * gn + g
        order = rs.permutation(np.flatnonzero(m))
        np.maximum.at(keys, cell[order], key[order])
        keys = keys.reshape(r1 - r0, gn)
        vals = np.where(keys != 0, keys & np.uint64(0xffff),
                        zeros[g0:g0 + gn].astype(np.uint64)).astype(np.uint16)
        if transpose:
            out[g0:g0 + gn, r0:r1] = vals.T
        else:
            out[r0:r1, g0:g0 + gn] = vals
    return out.astype(np.uint8) if tables.out_bytes == 1 else out


def _jax_mappers(ms):
    return [jbin.BinMapper(**{k: getattr(m, k) for k in (
        "upper_bounds", "bin_type", "missing_type", "categories",
        "num_bins", "default_bin", "most_freq_bin", "min_val", "max_val")})
        for m in ms]


@pytest.fixture(scope="module")
def cases():
    return list(chip_smoke.csr_adversarial_cases(0, scale=0.02))


@pytest.mark.parametrize("label", [c[0] for c in chip_smoke.CSR_ADVERSARIAL])
def test_keyed_assembly_equals_host_and_plain(label, cases):
    """The transcription, entries in two random orders, byte-equal to
    ``bin_csr_plain`` and to the host: the port's and the JAX package's
    ``construct_binned_sparse`` (Dataset form) or ``bin_rows_plain`` of
    the dense rows (predict form)."""
    _, csr, X, ms, gs, sentinel, transpose, _ = next(
        c for c in cases if c[0] == label)
    gs = tbin.device_group_order(gs, ms)
    tables = kbr.bin_tables(ms, gs, CPU, sentinel=sentinel)
    zeros = kbc.zero_bins(tables)
    indptr = np.asarray(csr.indptr, np.int64)
    indices = np.asarray(csr.indices, np.int32)
    data = np.asarray(csr.data, np.float64)
    got = [emulate(indptr, indices, data, tables, zeros, transpose,
                   np.random.RandomState(s)) for s in (0, 1)]
    assert got[0].tobytes() == got[1].tobytes()
    n, G = csr.shape[0], len(gs)
    plain = torch.zeros((G, n) if transpose else (n, G),
                        dtype=kbr.storage_dtype(tables.out_bytes))
    kbc.bin_csr_plain(torch.from_numpy(indptr), torch.from_numpy(indices),
                      torch.from_numpy(data), tables,
                      torch.from_numpy(zeros), plain, 0, transpose)
    plain = bins_to_numpy(plain)
    assert got[0].dtype == plain.dtype
    assert got[0].tobytes() == plain.tobytes()
    if sentinel:
        want = bins_to_numpy(kbr.bin_matrix(X, tables, transpose=True))
    else:
        with np.errstate(invalid="ignore"):
            want = tbin.construct_binned_sparse(csr, ms, gs).bins
            jwant = np.asarray(jbin.construct_binned_sparse(
                csr, _jax_mappers(ms), gs).bins)
        assert jwant.tobytes() == want.tobytes()
        want = want.T if transpose else want
    assert got[0].tobytes() == np.ascontiguousarray(want).tobytes()


@pytest.mark.parametrize("label", ["adv_b16_rows", "bundle_b16_rows_chunks"])
def test_csr_records_follow_the_feature_records(label, cases):
    """Each column's compact record holds its feature record's fields;
    numeric features of at most two bounds, and only they, hold their
    first bound inline (+inf for one bound)."""
    _, _, _, ms, gs, _, _, _ = next(c for c in cases if c[0] == label)
    gs = tbin.device_group_order(gs, ms)
    tables = kbr.bin_tables(ms, gs, CPU)
    rec = tables.csr_records.numpy()
    plain = kbr.csr_records(tables.host_feats, tables.num_features,
                            tables.bounds.numpy(), inline=False)
    bounds = tables.bounds.numpy()
    seen_inline = 0
    for f in tables.host_feats:
        c = int(f[kbr.F_COLUMN])
        cat = int(f[kbr.F_FLAGS]) & kbr.CATEGORICAL
        start = f[kbr.F_CATS_START] if cat else f[kbr.F_BOUNDS_START]
        size = f[kbr.F_CATS_LEN] if cat else f[kbr.F_BOUNDS_LEN]
        assert list(plain[c]) == [f[kbr.F_GROUP], f[kbr.F_FLAGS],
                                  f[kbr.F_POSITION], f[kbr.F_IN_GROUP],
                                  f[kbr.F_NUM_BINS], f[kbr.F_DEFAULT_BIN],
                                  start, size]
        assert (rec[c, :6] == plain[c, :6] | np.array(
            [0, kbr.CSR_INLINE * (not cat and size <= 2), 0, 0, 0, 0])).all()
        if not cat and size <= 2:
            seen_inline += 1
            first = rec[c, 6:8].copy().view("<f8")[0]
            assert first == (bounds[start] if size == 2 else np.inf)
        else:
            assert list(rec[c, 6:]) == [start, size]
    assert (seen_inline > 0) == (label != "adv_b16_rows")
    assert (rec[:, 0] >= -1).all()
    unused = np.setdiff1d(np.arange(tables.num_features),
                          tables.host_feats[:, kbr.F_COLUMN])
    assert (rec[unused, 0] == -1).all()


def _c_enum(first):
    body = [b for b in re.findall(r"enum \{([^}]*)\}", SRC.read_text())
            if first in b][0]
    return [w.strip() for w in body.split(",") if w.strip()]


def _c_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


def test_fields_and_key_follow_the_c_side():
    camel = ["k" + "".join(w.title() for w in f.split("_"))
             for f in kbc.CSR_PLAN_FIELDS]
    # the C enum names the thread count and shared bytes kPlanThreads /
    # kPlanSmem, beside the kernel's own constants
    camel = [{"kThreads": "kPlanThreads", "kSmem": "kPlanSmem"}.get(w, w)
             for w in camel]
    assert _c_enum("kTiles") == camel + ["kPlanFields"]
    rec = ["kRec" + "".join(w.title() for w in f.split("_"))
           for f in kbr.CSR_RECORD_FIELDS]
    assert _c_enum("kRecGroup") == rec + ["kRecFields"]
    assert _c_const("kInline") == kbr.CSR_INLINE
    assert _c_const("kThreads") == kbc.THREADS
    assert _c_const("kMinBlocks") == kbc.BLOCKS_PER_SM
    assert _c_const("kMaxSmem") == khw.SMEM_BLOCK
    assert _c_const("kBinBits") == kbc.KEY_BIN_BITS
    assert _c_const("kIndexBits") == kbc.KEY_INDEX_BITS
    assert kbc.KEY_POSITION_BITS + kbc.KEY_INDEX_BITS + kbc.KEY_BIN_BITS \
        == 64
    # chunk_rows keeps a chunk of more than one row below the entry index
    assert kbc.CHUNK_BYTES // kbc.ENTRY_BYTES < 2 ** kbc.KEY_INDEX_BITS


def test_launch_plan_refuses_a_tile_past_the_entry_index():
    ms = [tbin.BinMapper.find_numerical(np.array([0.0, 1.0, 2.0]), 15, 1,
                                        True, False)]
    tables = kbr.bin_tables(ms, [[0]], CPU)
    kbc.launch_plan(np.array([0, 2 ** 25 - 1]), tables, CPU)
    with pytest.raises(LightGBMError, match="entry index"):
        kbc.launch_plan(np.array([0, 2 ** 25]), tables, CPU)
    # a single row past it is a chunk of its own, and that chunk raises
    indptr = np.array([0, 5, 5 + 2 ** 25, 2 ** 25 + 9])
    assert kbc.chunk_rows(indptr)[1] == (1, 2)


def test_matrix_hands_each_chunk_its_plan(cases, monkeypatch):
    """bin_csr_matrix cuts each chunk's tiles from the host row pointers
    and hands them to bin_csr with the chunk."""
    _, csr, _, ms, gs, _, _, _ = next(c for c in cases
                                      if c[0] == "long_row_b16_rows")
    gs = tbin.device_group_order(gs, ms)
    tables = kbr.bin_tables(ms, gs, CPU)
    seen = []
    real = kbc.bin_csr

    def spy(indptr, indices, data, tables, zeros, out, row0=0,
            transpose=False, plan=None):
        want, starts = kbc.bin_csr_plan(indptr.numpy(), tables.num_groups)
        assert plan[0] == want and np.array_equal(plan[1].numpy(), starts)
        seen.append(row0)
        return real(indptr, indices, data, tables, zeros, out, row0,
                    transpose, plan)

    monkeypatch.setattr(kbc, "bin_csr", spy)
    got = kbc.bin_csr_matrix(csr, tables, chunk_bytes=12 * 2000)
    assert len(seen) > 2 and seen[0] == 0
    assert bins_to_numpy(got).tobytes() == \
        tbin.construct_binned_sparse(csr, ms, gs).bins.tobytes()
