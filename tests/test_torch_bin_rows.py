"""Rows binned on the card (``kernels/bin_rows.py``, ``csrc/bin_rows.cu``)
against the host binning of the port and of the JAX package, on the CPU.

``bin_rows`` has no ``pallas_call`` counterpart: it is the card's form of
the JAX package's native host binner (``lightgbm_tpu/native/binner.cpp``
``lgbt_value_to_bin``) and of the port's NumPy ``construct_binned``.  The
kernel runs only on the card (``chip_smoke.py`` holds every launch byte for
byte against its plain version and the host); here the plain version,
``bin_rows_plain`` (torch.searchsorted in float64, then the group
assembly), runs on CPU tensors, and these tests hold it byte for byte (bins
are integers: no tolerance) to:

- the port's ``construct_binned`` and the JAX package's, on numeric
  features under MISSING_NAN, MISSING_ZERO and none, categorical features
  past the host's 4096-category path and 256 bins, EFB bundles whose
  features overlap (the last non-default wins), NaN, +-inf, -0.0, bounds
  and one ulp either side, negative, non-integer and |v| >= 2**63
  categories, uint8 and 16-bit storage, rows and transposed;
- the predict form (sentinel bins of split categorical features, widened
  to 16 bits past 255) against the host re-bin ``Booster.predict`` ran
  before (``chip_smoke.host_predict_bins``);
- ``Booster.predict`` on the device path calling neither
  ``BinMapper.transform`` nor ``construct_binned``.

It also pins the launch plan and holds the field orders to the C enums.
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

import lightgbm_torch as lt
from lightgbm_torch import basic as tbasic
from lightgbm_torch import binning as tbin
from lightgbm_torch.binning import BinMapper, construct_binned, \
    device_group_order
from lightgbm_torch.device_data import to_device
from lightgbm_torch.kernels import bin_rows as kbr
from lightgbm_torch.kernels import hist_wide as khw
from lightgbm_torch.kernels.layout import bins_to_numpy, bins_to_torch

from chip_smoke import (BIN_ADVERSARIAL, BIN_BUNDLES, bin_adversarial_data,
                        bin_bundle_data, host_predict_bins)

CPU = torch.device("cpu")
SRC = Path(kbr.__file__).parent / "csrc" / "bin_rows.cu"
# the feature record fields and flags, shared with csrc/bin_csr.cu
HEADER = SRC.with_name("bin_value.cuh")


def _jax_mappers(mappers):
    """The JAX package's BinMapper of each of the port's, field by field."""
    out = []
    for m in mappers:
        j = jbin.BinMapper()
        for k in ("upper_bounds", "bin_type", "missing_type", "categories",
                  "num_bins", "default_bin", "most_freq_bin", "min_val",
                  "max_val"):
            setattr(j, k, getattr(m, k))
        out.append(j)
    return out


def _plain(X, mappers, groups, transpose=False, sentinel=()):
    tabs = kbr.bin_tables(mappers, device_group_order(groups, mappers), CPU,
                          sentinel=sentinel)
    out = kbr.bin_matrix(X, tabs, transpose=transpose)
    got = bins_to_numpy(out)
    return got.T if transpose else got


def _case(label):
    """A BIN_ADVERSARIAL case at 4003 rows: its rows, mappers, groups and
    sentinel features, renumbered as phase bin_adversarial does."""
    _, _, feats, sentinel, transpose = [c for c in BIN_ADVERSARIAL
                                        if c[0] == label][0]
    mappers, groups, X = _ADV
    where = {f: j for j, f in enumerate(feats)}
    ms = [mappers[f] for f in feats]
    gs = [[where[f] for f in g if f in where] for g in groups]
    return (np.ascontiguousarray(X[:, list(feats)]), ms,
            [g for g in gs if g], [where[f] for f in sentinel], transpose)


_ADV = bin_adversarial_data(0, 4003)


@pytest.mark.parametrize("label", ["b16_rows", "b16_transposed", "b8_rows",
                                   "b8_transposed"])
def test_plain_equals_port_and_jax_construct_binned(label, monkeypatch):
    X, ms, gs, _, transpose = _case(label)
    with np.errstate(invalid="ignore"):
        port = construct_binned(X, ms, gs).bins
        jax = jbin.construct_binned(X, _jax_mappers(ms), gs).bins
    # upload chunks of 999 rows: five chunks, the last one ragged
    monkeypatch.setattr(kbr, "CHUNK_BYTES", 8 * X.shape[1] * 999)
    got = _plain(X, ms, gs, transpose=transpose)
    assert got.dtype == port.dtype == jax.dtype
    assert got.dtype == (np.uint16 if label.startswith("b16") else np.uint8)
    np.testing.assert_array_equal(got, port)
    np.testing.assert_array_equal(got, jax)


def test_adversarial_values_reach_every_path():
    """The case's rows hold what the kernel must get right: NaN, +-inf,
    -0.0, every bound and its neighbouring ulps, out-of-range and
    non-integer categories, more than 4096 categories, overlapping
    non-defaults in the bundle, and a top bin past 255."""
    mappers, groups, X = _ADV
    assert {m.missing_type for m in mappers[:3]} == {
        tbin.MISSING_NAN, tbin.MISSING_ZERO, tbin.MISSING_NONE}
    assert len(mappers[3].categories) > 4096
    col = X[:, 0]
    assert np.isnan(col).any() and np.isinf(col).any()
    assert (np.signbit(col) & (col == 0)).any()
    ub = mappers[0].upper_bounds[:-1]
    assert np.isin(ub, col).all() and np.isin(np.nextafter(ub, np.inf),
                                              col).any()
    cats = X[:, 3][np.isfinite(X[:, 3])]
    assert (np.abs(cats) >= 2.0 ** 63).any()
    assert (cats % 1 != 0).any() and np.isinf(X[:, 3]).any()
    nondef = [X[:, f] != 0 for f in (6, 7, 8)]
    assert (nondef[0] & nondef[1]).any() and (nondef[1] & nondef[2]).any()
    with np.errstate(invalid="ignore"):
        bins = construct_binned(X, mappers, groups).bins
    assert bins.max() > 255


@pytest.mark.parametrize("label", ["predict_b16", "predict_b8_widened",
                                   "predict_b8", "n1"])
def test_predict_form_equals_the_old_host_rebin(label):
    """Sentinel bins: NaN, negative, unseen and (after clipping to [-1,
    2**62]) out-of-range categories of a split categorical feature go to
    num_bins, in 16-bit bins where that passes 255."""
    X, ms, gs, sentinel, transpose = _case(label)
    if label == "n1":
        X = X[:1]
    with np.errstate(invalid="ignore"):
        want = host_predict_bins(X, ms, gs, sentinel)
    got = _plain(X, ms, gs, transpose=transpose, sentinel=sentinel)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if label != "n1":
        g = [i for i, grp in enumerate(device_group_order(gs, ms))
             if grp == [sentinel[0]]][0]
        assert (got[:, g] == ms[sentinel[0]].num_bins).any()


def test_x86_cast_of_out_of_range_categories_pinned():
    """NumPy's float64 -> int64 cast on x86-64 gives INT64_MIN at +-inf and
    |v| >= 2**63; the plain version (and the kernel) take those values as
    that, so they bin as an unseen category (bin 0) — and in the predict
    form 2**62 is a category after clipping, +inf is too, -inf is not."""
    with np.errstate(invalid="ignore"):
        cast = np.array([np.inf, -np.inf, 2.0 ** 63, -2.0 ** 64, 1e300,
                         -2.0 ** 63]).astype(np.int64)
    assert (cast == np.iinfo(np.int64).min).all()
    m = BinMapper(bin_type=tbin.BIN_CATEGORICAL,
                  categories=np.array([7, 2 ** 62, 0, 3], np.int64),
                  num_bins=4, upper_bounds=np.array([np.inf]))
    X = np.array([[np.inf], [-np.inf], [2.0 ** 63], [1e300], [-2.0 ** 63],
                  [2.0 ** 62], [7.9], [-0.9], [-1.0], [np.nan], [3.0]])
    with np.errstate(invalid="ignore"):
        want = construct_binned(X, [m]).bins[:, 0]
        pred = host_predict_bins(X, [m], [[0]], [0])[:, 0]
    np.testing.assert_array_equal(want, [0, 0, 0, 0, 0, 1, 0, 2, 0, 0, 3])
    np.testing.assert_array_equal(pred, [0, 4, 0, 0, 4, 1, 0, 2, 4, 4, 3])
    np.testing.assert_array_equal(_plain(X, [m], [[0]])[:, 0], want)
    np.testing.assert_array_equal(
        _plain(X, [m], [[0]], sentinel=[0])[:, 0], pred)


_special = st.sampled_from([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-300,
                            -1e-300, 2.0 ** 63, -1e19, 0.5, -0.5])


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 300),
       nf=st.integers(1, 5), max_bin=st.sampled_from([3, 15, 63, 255, 300]),
       use_missing=st.booleans(), zero_as_missing=st.booleans(),
       cat_mask=st.integers(0, 31), bundle=st.booleans(),
       special=st.lists(_special, min_size=0, max_size=6))
def test_random_mappers_and_values(seed, n, nf, max_bin, use_missing,
                                   zero_as_missing, cat_mask, bundle,
                                   special):
    """Random mappers (numeric and categorical, every missing type) and
    rows with special values: the plain version equals the port's and the
    JAX package's construct_binned, rows and transposed, and its predict
    form equals the old host re-bin."""
    rs = np.random.RandomState(seed)
    sample = rs.randn(500, nf) * rs.choice([1, 10, 1000], nf)
    sample[rs.rand(500, nf) < 0.2] = 0.0
    sample[rs.rand(500, nf) < 0.05] = np.nan
    cats = [f for f in range(nf) if cat_mask >> f & 1]
    for f in cats:
        sample[:, f] = np.floor(np.abs(sample[:, f])) % 40 - 2
    mappers = tbin.find_bin_mappers(sample, max_bin, 1, cats, use_missing,
                                    zero_as_missing)
    X = sample[rs.randint(0, 500, n)] + np.where(rs.rand(n, nf) < 0.1, 0.5,
                                                 0.0)
    if special:
        X.flat[rs.randint(0, X.size, len(special))] = special
    groups = [[f] for f in range(nf)]
    num = [f for f in range(nf) if f not in cats]
    if bundle and len(num) > 1:
        groups = [num] + [[f] for f in cats]
    with np.errstate(invalid="ignore"):
        port = construct_binned(X, mappers, groups).bins
        jax = jbin.construct_binned(X, _jax_mappers(mappers), groups).bins
        for transpose in (False, True):
            got = _plain(X, mappers, groups, transpose=transpose)
            np.testing.assert_array_equal(got, port)
        np.testing.assert_array_equal(port, jax)
        if cats:
            sent = [f for f in cats if f in sum(groups, [])]
            np.testing.assert_array_equal(
                _plain(X, mappers, groups, transpose=True, sentinel=sent),
                host_predict_bins(X, mappers, groups, sent))


def test_predict_bins_on_the_device_path_not_the_host(monkeypatch):
    """Booster.predict's device path (here the plain versions on CPU
    tensors) bins through bin_rows: with BinMapper.transform and
    construct_binned patched to raise, it still predicts, within rtol 1e-4
    / atol 1e-5 of the float64 host walk, with NaN, unseen and negative
    categories in the rows."""
    rs = np.random.RandomState(3)
    n = 3000
    X = rs.randn(n, 4)
    X[:, 1] = rs.randint(0, 30, n)
    X[rs.rand(n) < 0.05, 0] = np.nan
    y = ((X[:, 0] > 1.0) ^ np.isin(X[:, 1], [2, 5, 9, 13, 17, 21, 25])
         ).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "device_type": "cpu", "min_data_in_leaf": 5,
         "min_data_per_group": 5}
    bst = lt.train(p, lt.Dataset(X, label=y, categorical_feature=[1],
                                 params=p), 5)
    Xt = rs.randn(n, 4)
    Xt[:, 1] = rs.choice([0, 5, 29, 31, -3, np.nan, 7.5], n)
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    host = tbasic._host_predict(Xt, use, 1, False, 10, 10.0)
    # the trees split the categorical column: the predict form's sentinels
    assert any((np.asarray(t.decision_type[:t.num_leaves - 1]).astype(int)
                & 1).any() for t in use)

    def boom(*a, **k):
        raise AssertionError("host binning on the device predict path")

    monkeypatch.setattr(BinMapper, "transform", boom)
    monkeypatch.setattr(tbasic, "construct_binned", boom)
    monkeypatch.setattr(tbin, "construct_binned", boom)
    monkeypatch.setattr(tbasic.Booster, "_DEVICE_PREDICT_MIN_ROWS", 100)
    seen = []
    orig = kbr.bin_rows

    def counted(*a, **k):
        seen.append(a[0].shape)
        return orig(*a, **k)

    monkeypatch.setattr(kbr, "bin_rows", counted)
    inp = bst._device_predict_inputs(Xt, use, 1)
    assert inp is not None and seen
    got = bst.predict(Xt, raw_score=True)
    np.testing.assert_allclose(got, host, rtol=1e-4, atol=1e-5)


def test_to_device_takes_the_card_bins():
    """Dataset.construct on the card hands its (N, G) bins to to_device,
    which pads them there: the same DeviceData bins as an upload of the
    host copy."""
    X, ms, gs, _, _ = _case("b16_rows")
    with np.errstate(invalid="ignore"):
        binned = construct_binned(X, ms, gs)
    a = to_device(binned, CPU)
    b = to_device(binned, CPU, bins=bins_to_torch(binned.bins))
    assert a.bins.dtype == b.bins.dtype == torch.int16
    assert a.bins.shape[0] % 256 == 0 and a.bins.shape[0] > X.shape[0]
    assert torch.equal(a.bins, b.bins)
    with pytest.raises(ValueError):
        to_device(binned, CPU, bins=bins_to_torch(binned.bins[1:]))


def test_dataset_bins_through_bin_rows(monkeypatch):
    """Dataset.construct bins on its device through bin_rows, for a training
    set and its reference= validation set: the host copy equals the port's
    and the JAX package's construct_binned byte for byte (EFB bundles, a
    categorical column with NaN and negative values, NaN in a numeric
    one), and device_data pads the Dataset's own device bins."""
    rs = np.random.RandomState(5)
    n = 4000

    def rows(m):
        X = np.zeros((m, 12))
        X[:, 0] = rs.randn(m)
        X[rs.rand(m) < 0.1, 0] = np.nan
        X[:, 1] = rs.choice([0, 1, 2, 3, 7, -1, np.nan, 40], m)
        hot = rs.randint(0, 10, m)
        X[np.arange(m), 2 + hot] = rs.rand(m) + 0.5
        return X

    X, Xv = rows(n), rows(1500)
    y = (X[:, 0] > 0).astype(float)
    p = {"device_type": "cpu", "verbosity": -1, "max_bin": 63}
    seen = []
    orig = kbr.bin_rows

    def counted(*a, **k):
        seen.append(tuple(a[0].shape))
        return orig(*a, **k)

    monkeypatch.setattr(kbr, "bin_rows", counted)
    ds = lt.Dataset(X, label=y, categorical_feature=[1], params=p).construct()
    dv = lt.Dataset(Xv, label=y[:1500], reference=ds).construct()
    assert seen == [X.shape, Xv.shape]
    mappers = ds.binned.bin_mappers
    groups = ds.binned.group_features
    assert any(len(g) > 1 for g in groups)
    for d, raw in ((ds, X), (dv, Xv)):
        with np.errstate(invalid="ignore"):
            port = construct_binned(raw, mappers, groups).bins
            jax = jbin.construct_binned(raw, _jax_mappers(mappers),
                                        groups).bins
        assert d.binned.bins.dtype == port.dtype
        np.testing.assert_array_equal(d.binned.bins, port)
        np.testing.assert_array_equal(d.binned.bins, jax)
        kept = d._device_bins
        dd = d.device_data()
        assert d._device_bins is None
        assert torch.equal(dd.bins[:raw.shape[0]], kept)
        assert torch.equal(dd.bins, to_device(d.binned, CPU).bins)


def test_plan_pinned_and_within_limits():
    """256 threads; staged tiles of as many rows as STAGE_BYTES holds, two
    in a ring, persistent blocks four an SM (the full phase's predict of 1M
    x 28 rows: 73 rows a tile, the tables in shared memory; a Flight Delay
    chunk of 49 784 x 674 rows in 8 groups: 3 rows a tile, its 47 200
    bytes of tables read from global memory); rows too wide for a block's
    ring are read from global memory, 256 a block."""
    assert kbr.bin_plan(1_000_000, 28, 28, 132, 15472) == kbr.BinPlan(
        tile_rows=73, tiles=13699, blocks=528, threads=256, staged=1,
        stage_bytes=16352, word_bytes=8480, table_bytes=15472, smem=56656)
    assert kbr.bin_plan(49_784, 674, 8, 132, 47200) == kbr.BinPlan(
        tile_rows=3, tiles=16595, blocks=528, threads=256, staged=1,
        stage_bytes=16176, word_bytes=112, table_bytes=0, smem=32464)
    assert kbr.bin_plan(2000, 30_000, 30_000) == kbr.BinPlan(
        tile_rows=256, tiles=8, blocks=8, threads=256, staged=0,
        stage_bytes=0, word_bytes=0, table_bytes=0, smem=0)
    for n, F, G in [(0, 1, 1), (1, 1, 1), (7, 7000, 7000), (5, 7300, 1),
                    (10 ** 6, 3, 2)]:
        p = kbr.bin_plan(n, F, G)
        assert p.tiles * p.tile_rows >= n and p.smem <= khw.SMEM_BLOCK
        assert p.smem <= kbr.BLOCK_BYTES


@settings(max_examples=300, deadline=None)
@given(n=st.integers(0, 3_000_000), F=st.integers(1, 40_000),
       G=st.integers(1, 5000), sm=st.integers(1, 200),
       table_bytes=st.integers(0, 200_000))
def test_plan_covers_every_row_once(n, F, G, sm, table_bytes):
    """Every row in exactly one tile and every tile in exactly one
    persistent block (tile i in block i % blocks); a staged block within
    BLOCK_BYTES (two stages of a tile, its odd-strided words, the tables
    where they fit); rows too wide for that read from global memory, a
    block a tile of THREADS rows."""
    G = min(G, F)
    p = kbr.bin_plan(n, F, G, sm, table_bytes)
    assert p.threads == kbr.THREADS and p.tile_rows >= 1
    assert p.tiles == -(-n // p.tile_rows)
    starts = [t * p.tile_rows for t in range(p.tiles)]
    assert starts == sorted(set(starts)) and (not starts or (
        starts[-1] < n <= starts[-1] + p.tile_rows))
    if p.staged:
        visited = sorted(t for b in range(p.blocks)
                         for t in range(b, p.tiles, p.blocks))
        assert visited == list(range(p.tiles))
        assert p.blocks == min(p.tiles, kbr.BLOCKS_PER_SM * sm)
        assert p.stage_bytes == 8 * F * p.tile_rows
        assert p.word_bytes == -(-4 * p.tile_rows * (G | 1) // 16) * 16
        assert p.table_bytes in (0, table_bytes)
        assert p.smem == 2 * p.stage_bytes + p.word_bytes + p.table_bytes
        assert p.smem <= kbr.BLOCK_BYTES <= khw.SMEM_BLOCK
        assert p.stage_bytes <= max(kbr.STAGE_BYTES, 8 * F)
        if p.table_bytes == 0:
            assert p.smem + table_bytes > kbr.BLOCK_BYTES or \
                table_bytes == 0
    else:
        assert 16 * F + -(-4 * (G | 1) // 16) * 16 > kbr.BLOCK_BYTES
        assert (p.tile_rows, p.blocks, p.smem) == (kbr.THREADS, p.tiles, 0)


def _bundle_case(label, n):
    """A BIN_BUNDLES case at n rows: rows, mappers and groups."""
    _, _, bundles, transpose, _ = [c for c in BIN_BUNDLES
                                   if c[0] == label][0]
    mappers, groups, X = _BUNDLES
    k = 1 + bundles * len(groups[1])
    return (np.ascontiguousarray(X[:n, :k]), mappers[:k],
            groups[:1 + bundles], transpose)


_BUNDLES = bin_bundle_data(0, 3001)


@pytest.mark.parametrize("label", [c[0] for c in BIN_BUNDLES])
def test_bundles_plain_equals_port_and_jax_construct_binned(label,
                                                          monkeypatch):
    """Flight-Delay-shaped bundles (72 one-hot columns, two or three hot in
    some rows; 72 columns of four non-default bins, past 256 bins): the
    plain version equals both packages' construct_binned, in upload chunks
    of 997 rows."""
    X, ms, gs, transpose = _bundle_case(label, 3001)
    with np.errstate(invalid="ignore"):
        port = construct_binned(X, ms, gs).bins
        jax = jbin.construct_binned(X, _jax_mappers(ms), gs).bins
    monkeypatch.setattr(kbr, "CHUNK_BYTES", 8 * X.shape[1] * 997)
    got = _plain(X, ms, gs, transpose=transpose)
    assert got.dtype == port.dtype == (np.uint16 if "b16" in label
                                       else np.uint8)
    np.testing.assert_array_equal(got, port)
    np.testing.assert_array_equal(got, jax)


@pytest.mark.parametrize("label", ["bundle_b8_rows", "bundle_b16_rows"])
def test_bundle_max_assembly_equals_construct_binned(label):
    """The kernel's bundle assembly: each feature's value, in any order,
    takes the max of its (row, group) word and (its position in the group
    << 16 | its bin in the group) where its bin is not its default; a
    group of one feature stores its bin; a word never set is 0.  The low
    16 bits equal construct_binned's bins on rows where two and three
    features of a bundle are non-default, whatever the order."""
    X, ms, gs, _ = _bundle_case(label, 3001)
    gs = device_group_order(gs, ms)
    tabs = kbr.bin_tables(ms, gs, CPU)
    n = X.shape[0]
    words = np.zeros((n, len(gs)), np.uint32)
    nondefault = np.zeros((n, len(gs)), np.int64)
    order = np.random.RandomState(1).permutation(len(tabs.host_feats))
    for rec in tabs.host_feats[order]:
        b = kbr._feature_bins(torch.from_numpy(X[:, rec[kbr.F_COLUMN]]),
                              tabs, rec).numpy()
        g = rec[kbr.F_GROUP]
        if not rec[kbr.F_FLAGS] & kbr.BUNDLED:
            words[:, g] = b
            continue
        d = rec[kbr.F_DEFAULT_BIN]
        val = (rec[kbr.F_POSITION] << 16) | (rec[kbr.F_IN_GROUP]
                                             + np.where(b > d, b - 1, b))
        words[:, g] = np.where(b != d, np.maximum(words[:, g], val),
                               words[:, g])
        nondefault[:, g] += b != d
    assert (nondefault >= 2).any() and (nondefault >= 3).any()
    with np.errstate(invalid="ignore"):
        want = construct_binned(X, ms, gs).bins
    np.testing.assert_array_equal(words & 0xFFFF, want)
    for gi, g in enumerate(gs):
        recs = tabs.host_feats[tabs.host_group_start[gi]:
                               tabs.host_group_start[gi + 1]]
        assert list(recs[:, kbr.F_GROUP]) == [gi] * len(g)
        assert list(recs[:, kbr.F_POSITION]) == list(range(len(g)))
        assert list(recs[:, kbr.F_COLUMN]) == list(g)
    col = tabs.col_entry.numpy()
    assert sorted(col[col >= 0]) == list(range(len(tabs.host_feats)))
    assert all(tabs.host_feats[col[f], kbr.F_COLUMN] == f
               for f in range(len(col)) if col[f] >= 0)


def _c_enum(first):
    src = SRC.read_text() + HEADER.read_text()
    body = [b for b in re.findall(r"enum \{([^}]*)\}", src) if first in b][0]
    return [w.strip() for w in body.split(",") if w.strip()]


def test_fields_follow_the_c_enums():
    camel = ["k" + "".join(w.title() for w in f.split("_"))
             for f in kbr.FEAT_FIELDS]
    assert _c_enum("kColumn") == camel + ["kFeatFields"]
    plan = ["k" + "".join(w.title() for w in f.split("_"))
            for f in kbr.BIN_PLAN_FIELDS]
    assert [n.replace("kPlan", "k") for n in _c_enum("kTileRows")] == \
        plan
    flags = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                            HEADER.read_text()))
    assert (int(flags["kCategorical"]), int(flags["kMissingNan"]),
            int(flags["kSentinel"]), int(flags["kBundled"])) == (
        kbr.CATEGORICAL, kbr.MISSING_NAN_FLAG, kbr.SENTINEL, kbr.BUNDLED)


def test_wrapper_refuses_cpu_tensors_and_bad_shapes():
    X, ms, gs, _, _ = _case("b8_rows")
    tabs = kbr.bin_tables(ms, device_group_order(gs, ms), CPU)
    x = torch.from_numpy(X)
    out = torch.empty((X.shape[0], len(gs)), dtype=torch.uint8)
    with pytest.raises(lt.LightGBMError, match="CUDA tensors"):
        kbr.bin_rows_cuda(x, tabs, out)
    with pytest.raises(lt.LightGBMError, match="shapes do not agree"):
        kbr.bin_rows_plain(x[:, 1:], tabs, out)
    with pytest.raises(lt.LightGBMError, match="shapes do not agree"):
        kbr.bin_rows_plain(x, tabs, out.to(torch.int16))
    with pytest.raises(lt.LightGBMError, match="alone in its group"):
        kbr.bin_tables(ms, [[0, 1, 2, 3, 4, 5, 6]], CPU, sentinel=[3])
