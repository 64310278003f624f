"""Groups wider than 256 bins (16-bit bins) in the port, against the JAX
package, on the CPU.

EFB bundles sparse columns into groups of up to ``max(255, 2e6 // F)``
bins, so sparse one-hot or count tables reach 16-bit bins at the default
``max_bin``.  The data here is that case at a small size: two dense columns
and six mutually exclusive sparse ones, 3 groups, Bmax about 1500.  The
same numpy inputs go through the JAX package and through the port with
``device_type="cpu"``, where the kernel wrappers run their plain PyTorch
versions.  The JAX package's oracles on such bins are its ``segsum`` and
``scatter`` backends (at Bmax > 128 its scatter gate takes the one-hot
contraction); its ``stream`` and ``pallas`` kernels pack 8-bit bins and
are not used here.

Tolerances and why:

- Bins, routing, leaf ids, counts, packed records and the K3 replay are
  integer operations: bit-equal.
- Histograms on dyadic weights: every formulation is exact, so the port's
  plain K2 (both forms, K = 3), K5 and K8 equal the JAX package's scatter
  and segsum sums bit for bit.
- Whole training on dyadic custom gradients: model text byte-identical to
  the JAX package's ``scatter``.  On real binary gradients: the first tree
  identical and raw scores within atol 2e-4 of the JAX package's
  ``segsum`` (single precision), the bound tests/test_torch_train.py
  states for K2.
- ``Booster.predict`` through K1's plain version: within rtol 1e-4 / atol
  1e-5 of the JAX package's ``predict`` and of the float64 host walk, the
  bound K1 is held to everywhere (float32 sums in tree order).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.ops.histogram import _hist_segsum
from lightgbm_tpu.pallas import scatter_hist_kernel as jsh

import lightgbm_torch as lt
from lightgbm_torch import basic as tbasic
from lightgbm_torch.kernels import build
from lightgbm_torch.kernels import hist_sorted as khs
from lightgbm_torch.kernels import hist_wide as khw
from lightgbm_torch.kernels import layout as tl
from lightgbm_torch.kernels import predict as tpk
from lightgbm_torch.kernels import route_hist as krh
from lightgbm_torch.kernels import route_replay as krr
from lightgbm_torch.kernels import scatter_hist as ksh
from lightgbm_torch.ops import grow as tgrow
from lightgbm_torch.ops.histogram import hist_shift, quantize

from chip_smoke import k1_wide_records, k3_records, make_wide_small, \
    wide_label3
from test_torch_multiclass import _dyadic_mc_fobj
from test_torch_quantized import _pow2_fobj
from test_torch_train import _dyadic_fobj, _structure, _trees_text

CPU = {"device_type": "cpu"}
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsh, "_INTERPRET", True)


def _probe(n, seed=0):
    """chip_smoke.make_wide_small's rows: two dense columns and six
    mutually exclusive sparse ones, which EFB bundles at the default
    max_bin 255 into one group of ~1500 bins (3 groups)."""
    return make_wide_small(n, seed)


# ------------------------------------------------------------------ bins

def test_probe_bins_equal_jax_and_storage_reads_unsigned():
    """The port's (N, G) bins equal the JAX package's uint16 bins on the
    probe (3 groups, one over 1500 bins); the card's int16 storage of
    16-bit bins reads back every value, 32 768 and past included."""
    X, y = _probe(20_000)
    jd = lgb.Dataset(X, label=y).construct()
    td = lt.Dataset(X, label=y, params=CPU).construct()
    jb, tb = jd.binned, td.binned
    assert tb.bins.dtype == jb.bins.dtype == np.uint16
    np.testing.assert_array_equal(tb.bins, jb.bins)
    assert tb.group_features == jb.group_features
    dd = td.device_data()
    assert dd.bins.dtype == torch.int16 and len(tb.group_features) == 3
    assert dd.max_bins > 1500
    np.testing.assert_array_equal(
        tl.bin_values(dd.bins).numpy()[:len(X)], tb.bins.astype(np.int32))
    host = np.array([[0, 255, 256], [32767, 32768, 65535]], np.uint16)
    t = tl.pack_bins_T(host, torch.device("cpu"))
    assert t.dtype == torch.int16 and tl.bin_bytes(t) == 2
    np.testing.assert_array_equal(tl.bin_values(t).numpy(), host.T)
    assert tl.bin_bytes(tl.pack_bins_T(host.astype(np.uint8),
                                       torch.device("cpu"))) == 1
    with pytest.raises(lt.LightGBMError, match="uint8 or torch.int16"):
        tl.bin_bytes(t.to(torch.int32))


# ------------------------------------------------------------ histograms

def _hist_case(Bmax, seed, n=3000, G=3, S=5, K=1):
    """(N, G) uint16 bins with every group reaching Bmax - 1, (K, N) slots
    (some negative), dyadic grads and hesses, 0/1 counts."""
    rs = np.random.RandomState(seed)
    bins = rs.randint(0, Bmax, (n, G)).astype(np.uint16)
    bins[0] = Bmax - 1
    slot = rs.randint(-1, S, (K, n)).astype(np.int32)
    grad = (rs.randint(-64, 65, (K, n)) / 64).astype(np.float32)
    hess = (rs.randint(1, 33, (K, n)) / 32).astype(np.float32)
    cnt = (rs.rand(n) < 0.9).astype(np.float32)
    return bins, slot, grad * cnt, hess * cnt, cnt


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _bins_T(bins):
    return tl.pack_bins_T(bins, torch.device("cpu"))


@pytest.mark.parametrize("Bmax", [257, 1524])
def test_plain_k5_k8_equal_jax_scatter_and_segsum(Bmax):
    """K5 and K8's plain versions over 16-bit bins equal the JAX package's
    build_histograms_scatter(_k) (interpret mode) and _hist_segsum bit for
    bit on dyadic weights."""
    S, K = 5, 3
    bins, slot, grad, hess, cnt = _hist_case(Bmax, Bmax, S=S, K=K)
    bT = _bins_T(bins)
    shift = hist_shift(1.0, len(cnt))
    k5 = ksh.scatter_hist_plain(bT, _t(slot[0]), _t(grad[0]), _t(hess[0]),
                                _t(cnt), S, Bmax, shift).numpy()
    jb = jnp.asarray(bins)
    j5 = np.asarray(jsh.build_histograms_scatter(
        jb, jnp.asarray(slot[0]), jnp.asarray(grad[0]), jnp.asarray(hess[0]),
        jnp.asarray(cnt), S, Bmax))
    seg = np.asarray(_hist_segsum(jb, jnp.asarray(slot[0]),
                                  jnp.asarray(grad[0]), jnp.asarray(hess[0]),
                                  jnp.asarray(cnt), S, Bmax))
    np.testing.assert_array_equal(k5, j5)
    np.testing.assert_array_equal(k5, seg)
    k8 = khw.hist_wide_plain(bT, _t(slot), _t(grad), _t(hess), _t(cnt), S,
                             Bmax, [shift] * K).numpy()
    j8 = np.asarray(jsh.build_histograms_scatter_k(
        jb, jnp.asarray(slot), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), K, S, Bmax))
    np.testing.assert_array_equal(k8, j8)
    # the top bin, past 256, is reached
    assert (k8[:, :, :, Bmax - 1, 2] > 0).any()


def _records(rs, K, L, S, G, Bmax, wide_fields=True):
    """(K, L, 16) route records: leaves 0 .. S/2 - 1 split on a random
    group (to slots 2j, 2j + 1), some EFB-bundled with spans past 256, NaN
    and zero bins and thresholds past 255; the last leaf keeps no slot."""
    half = S // 2
    tabs = np.zeros((K, L, len(tl.ROUTE_FIELDS)), np.int32)
    tabs[..., tl.R_NANBIN] = -1
    tabs[..., tl.R_MZBIN] = -1
    tabs[..., tl.R_NBINS] = Bmax
    j = np.arange(half)
    sh = (K, half)
    tabs[:, :half, tl.R_CHOSEN] = 1
    tabs[:, :half, tl.R_NEWID] = rs.randint(0, L, sh)
    tabs[:, :half, tl.R_GROUP] = rs.randint(0, G, sh)
    tabs[:, :half, tl.R_THR] = rs.randint(0, Bmax, sh)
    tabs[:, :half, tl.R_SLOT_L] = 2 * j
    tabs[:, :half, tl.R_SLOT_R] = 2 * j + 1
    tabs[:, half:, tl.R_SLOT_KEEP] = np.where(S % 2, S - 1, -1)
    tabs[:, L - 1, tl.R_SLOT_KEEP] = -1
    if wide_fields:
        nb = rs.randint(2, 600, sh)
        bundled = rs.rand(*sh) < 0.4
        tabs[:, :half, tl.R_BUNDLED] = bundled
        tabs[:, :half, tl.R_NBINS] = np.where(bundled, nb, Bmax)
        tabs[:, :half, tl.R_SPAN] = np.where(bundled,
                                             rs.randint(0, Bmax, sh), 0)
        tabs[:, :half, tl.R_DEFBIN] = rs.randint(0, Bmax, sh) % nb
        tabs[:, :half, tl.R_NANBIN] = np.where(rs.rand(*sh) < 0.5,
                                               rs.randint(0, Bmax, sh), -1)
        tabs[:, :half, tl.R_MZBIN] = np.where(rs.rand(*sh) < 0.3,
                                              rs.randint(0, Bmax, sh), -1)
        tabs[:, :half, tl.R_DEFLEFT] = rs.rand(*sh) < 0.5
    return tabs


def _full_decision(rec, gb):
    """go-left of group bins ``gb`` under one numeric route record (numpy,
    int64): the EFB span unbundled, a missing bin the default way, else
    left at most the threshold."""
    gb = np.asarray(gb, np.int64)
    ls = gb - rec[tl.R_SPAN]
    fb = np.where((ls >= 0) & (ls < rec[tl.R_NBINS] - 1),
                  ls + (ls >= rec[tl.R_DEFBIN]), rec[tl.R_DEFBIN])
    fb = np.where(rec[tl.R_BUNDLED] > 0, fb, gb)
    missing = (fb == rec[tl.R_NANBIN]) | (fb == rec[tl.R_MZBIN])
    return np.where(missing, rec[tl.R_DEFLEFT] > 0, fb <= rec[tl.R_THR])


def _numpy_route(bins, leaf, tabs):
    """(new leaf, slot) of every row under its leaf's record."""
    n = bins.shape[0]
    new, slot = leaf.copy(), np.full(n, -1, np.int64)
    for i in range(n):
        rec = tabs[leaf[i]]
        if rec[tl.R_CHOSEN] > 0:
            left = _full_decision(rec, bins[i, rec[tl.R_GROUP]])
            new[i] = leaf[i] if left else rec[tl.R_NEWID]
            slot[i] = rec[tl.R_SLOT_L] if left else rec[tl.R_SLOT_R]
        else:
            slot[i] = rec[tl.R_SLOT_KEEP]
    return new, slot


@pytest.mark.parametrize("Bmax", [257, 1524])
def test_plain_k2_forms_equal_segsum_over_their_routes(Bmax):
    """K2's plain float form (K = 1 and the class axis at K = 3) and its
    int form route every row as a numpy walk of the full records does
    (EFB spans past 256, thresholds and missing bins past 255) and sum
    the histograms of the routed slots as the JAX package's _hist_segsum
    does, bit for bit on dyadic (int: integer) weights."""
    S, K, L, G = 7, 3, 6, 3
    rs = np.random.RandomState(Bmax + 1)
    bins, _, grad, hess, cnt = _hist_case(Bmax, Bmax + 2, G=G, K=K)
    n = len(cnt)
    tabs = _records(rs, K, L, S, G, Bmax)
    leaf = rs.randint(0, L, (K, n)).astype(np.int32)
    words = np.zeros((K, L, 1), np.int32)
    bT = _bins_T(bins)
    shift = hist_shift(1.0, n)
    new, hist, counts = krh.route_and_hist_plain(
        bT, _t(leaf), _t(tabs), _t(words), _t(grad), _t(hess), _t(cnt), S,
        Bmax, [shift] * K)
    qg = np.clip(np.round(grad * 64), -127, 127).astype(np.int8)
    qh = np.clip(np.round(hess * 32), 0, 127).astype(np.int8)
    inew, ihist, icounts = krh.route_and_hist_int_plain(
        bT, _t(leaf), _t(tabs), _t(words), _t(qg), _t(qh), _t(cnt), S, Bmax)
    jb = jnp.asarray(bins)
    for k in range(K):
        want_leaf, slot = _numpy_route(bins, leaf[k], tabs[k])
        np.testing.assert_array_equal(new[k].numpy(), want_leaf)
        np.testing.assert_array_equal(inew[k].numpy(), want_leaf)
        slot = np.where(cnt > 0, slot, -1).astype(np.int32)
        seg = np.asarray(_hist_segsum(
            jb, jnp.asarray(slot), jnp.asarray(grad[k]),
            jnp.asarray(hess[k]), jnp.asarray(cnt), S, Bmax))
        np.testing.assert_array_equal(hist[k].numpy(), seg[..., :2])
        np.testing.assert_array_equal(counts[k].numpy(),
                                      seg[:, 0, :, 2].sum(axis=-1))
        np.testing.assert_array_equal(icounts[k].numpy(),
                                      seg[:, 0, :, 2].sum(axis=-1))
        iseg = np.asarray(_hist_segsum(
            jb, jnp.asarray(slot), jnp.asarray(qg[k].astype(np.float32)),
            jnp.asarray(qh[k].astype(np.float32)), jnp.asarray(cnt), S,
            Bmax))
        np.testing.assert_array_equal(ihist[k].numpy(),
                                      iseg[..., :2].astype(np.int32))
    # K = 1 is the class axis's first class
    one = krh.route_and_hist_plain(bT, _t(leaf[:1]), _t(tabs[:1]),
                                   _t(words[:1]), _t(grad[:1]),
                                   _t(hess[:1]), _t(cnt), S, Bmax, [shift])
    for a, b in zip(one, (new, hist, counts)):
        assert torch.equal(a[0], b[0])


# ------------------------------------------------------------------ plan

def _emulate_tiles(plan, bins_T, slot, grad, hess, cnt, S, Bmax, shift):
    """(K, S, G, Bmax, 3) float32 histograms summed as the 16-bit tile pass
    (csrc/hist_tile.cuh) sums them under ``plan``: for each row range and
    tile (pair tile x bin tile x group tile), the rows whose pair and bin
    the tile holds add their exact integers into the tile's cells, which
    flush once into the int64 sums at (pair, group, b0 + bin)."""
    G, n = bins_T.shape
    K = slot.shape[0]
    P = K * S
    b = tl.bin_values(bins_T).numpy().astype(np.int64)
    q = np.stack([quantize(_t(grad), shift).numpy(),
                  quantize(_t(hess), shift).numpy(),
                  np.broadcast_to(np.round(cnt).astype(np.int64), (K, n))],
                 axis=-1)
    acc = np.zeros((P, G, Bmax, 3), np.int64)
    covered = np.zeros((P, G, Bmax), np.int64)
    ppt, gpt, bpt = plan.pairs_per_tile, plan.groups_per_tile, \
        plan.bins_per_tile
    for r in range(plan.row_ranges):
        rows = np.arange(r * plan.rows_per_range,
                         min((r + 1) * plan.rows_per_range, n))
        for x in range(plan.pair_tiles * plan.bin_tiles):
            px, bt = divmod(x, plan.bin_tiles)
            c0, c1 = px * ppt, min(px * ppt + ppt, P)
            b0 = bt * bpt
            for gy in range(plan.group_tiles):
                g0, g1 = gy * gpt, min(gy * gpt + gpt, G)
                tile = np.zeros((ppt, gpt, bpt, 3), np.int64)
                if r == 0:
                    covered[c0:c1, g0:g1, b0:min(b0 + bpt, Bmax)] += 1
                for k in range(K):
                    s = slot[k, rows]
                    p = k * S + s
                    ok = (s >= 0) & (p >= c0) & (p < c1)
                    for g in range(g0, g1):
                        lb = b[g, rows] - b0
                        m = ok & (lb >= 0) & (lb < bpt)
                        np.add.at(tile, (p[m] - c0, g - g0, lb[m]),
                                  q[k, rows[m]])
                for lp in range(c1 - c0):
                    for lg in range(g1 - g0):
                        nb = min(bpt, Bmax - b0)
                        acc[c0 + lp, g0 + lg, b0:b0 + nb] += tile[lp, lg, :nb]
    assert (covered == 1).all(), "every (pair, group, bin) cell once"
    hist = acc.astype(np.float32)
    hist[..., :2] *= np.float32(2.0 ** -shift)
    return hist.reshape(K, S, G, Bmax, 3)


@pytest.mark.parametrize("Bmax,budget,cell", [
    (257, 2000, khw.CELL_BYTES), (1524, 6000, khw.CELL_BYTES),
    (1524, 10_000, krh.CELL_BYTES), (700, 1000, krh.INT_CELL_BYTES)])
def test_small_budget_plan_tiles_the_bin_axis(Bmax, budget, cell):
    """Past 256 bins, where one pair's Bmax cells exceed the budget, the
    plan tiles the bins: even shares, one pair and group a tile, every
    (pair, group, bin) cell in exactly one tile; the tile pass summed tile
    by tile under it equals the plain K8 bit for bit."""
    S, K, G = 3, 2, 2
    plan = khw._plan(3000, G, K, S, Bmax, budget, 64, cell)
    assert plan.bin_tiles > 1
    assert plan.bins_per_tile * cell <= budget
    assert (plan.pairs_per_tile, plan.groups_per_tile) == (1, 1)
    assert plan.bin_tiles * plan.bins_per_tile >= Bmax > \
        (plan.bin_tiles - 1) * plan.bins_per_tile
    assert plan.smem == plan.bins_per_tile * cell
    bins, slot, grad, hess, cnt = _hist_case(Bmax, 7, n=3000, G=G, S=S, K=K)
    bT = _bins_T(bins)
    shift = hist_shift(1.0, 3000)
    got = _emulate_tiles(plan, bT, slot, grad, hess, cnt, S, Bmax, shift)
    want = khw.hist_wide_plain(bT, _t(slot), _t(grad), _t(hess), _t(cnt), S,
                               Bmax, [shift] * K).numpy()
    np.testing.assert_array_equal(got, want)


def test_default_plans_tile_bins_only_past_a_block():
    """At the sm_90 budget no tile holds a range of bins until one pair's
    Bmax cells pass 227 KB: K2 at 16-byte cells past 14 528 bins, K5/K8 at
    20 past 11 622, K2's int form at 8 past 29 056; the Flight Delay
    phase's Bmax 2967 splits slots, not bins."""
    for cell, edge in ((krh.CELL_BYTES, 14_528), (khw.CELL_BYTES, 11_622),
                       (krh.INT_CELL_BYTES, 29_056)):
        assert khw.hist_plan(10 ** 6, 3, 1, 64, edge, cell).bin_tiles == 1
        p = khw.hist_plan(10 ** 6, 3, 1, 64, edge + 1, cell)
        assert p.bin_tiles == 2 and p.smem <= khw.SMEM_BLOCK
    p = khw.hist_plan(500_000, 3, 1, 64, 2967, krh.CELL_BYTES)
    assert p.bin_tiles == 1 and p.pairs_per_tile == 4
    assert khw.hist_plan(1000, 3, 1, 1, 256, 10 ** 4).bin_tiles == 1


# --------------------------------------------------------------- records

def _wide_packed_decision(w1, gb):
    """The 16-bit K3 kernel's fast decision: the row's bin clamped to 256,
    then compared with the packed word's 9-bit fields."""
    bits = krr.PACK_BITS
    g = np.minimum(np.asarray(gb, np.int64), 256)
    w1 = np.int64(w1)
    missing = ((g == (w1 >> bits["nan_shift"]) & 0x1ff)
               | (g == (w1 >> bits["mz_shift"]) & 0x1ff))
    return np.where(missing, ((w1 >> bits["default_left_bit"]) & 1) > 0,
                    g < (w1 & 0x1ff))


def test_wide_k3_records_special_past_255_and_decide_as_the_full_record():
    """Over 16-bit bins pack_records marks special, beside the 8-bit
    form's records, every record with a threshold or a NaN or zero bin
    past 255; every other split record decides every 16-bit bin through
    its packed word (the bin clamped to 256) as through its full record.
    The 8-bit packing is unchanged by the flag where no field passes 255."""
    rs = np.random.RandomState(3)
    Bmax, G, L = 40_000, 4, 64
    tabs = _records(rs, 1, L, 2 * (L - 1), G, Bmax)
    rec = tabs[0]
    rec[:8, tl.R_THR] = [0, 254, 255, 256, 511, 32767, 32768, 39_999]
    rec[8:12, tl.R_NANBIN] = [255, 256, 511, 35_000]
    rec[8:12, tl.R_BUNDLED] = 0
    full = krr.pack_records(torch.as_tensor(tabs), G, wide=True).numpy()
    w1 = full[0, :L, 1].view(np.uint32).astype(np.int64)
    t = tabs[0].astype(np.int64)
    chosen = t[:, tl.R_CHOSEN] > 0
    want = chosen & ((t[:, tl.R_BUNDLED] > 0) | (t[:, tl.R_THR] > 255)
                     | (t[:, tl.R_NANBIN] > 255) | (t[:, tl.R_MZBIN] > 255)
                     | (t[:, tl.R_NEWID] >= L) | (t[:, tl.R_GROUP] >= G))
    special = (w1 >> krr.PACK_BITS["special_bit"]) == 1
    np.testing.assert_array_equal(special, want)
    assert 0 < special.sum() < chosen.sum()
    gb = np.unique(np.concatenate([np.arange(0, 600), [32767, 32768, 39_999,
                                                       65_535],
                                   rs.randint(0, 65_536, 2000)]))
    for lf in np.flatnonzero(chosen & ~special):
        np.testing.assert_array_equal(_wide_packed_decision(w1[lf], gb),
                                      _full_decision(rec[lf], gb))
    narrow = tabs.copy()
    narrow[..., tl.R_THR] %= 255
    for f in (tl.R_NANBIN, tl.R_MZBIN):
        narrow[..., f] = np.where(narrow[..., f] > 255, -1, narrow[..., f])
    np.testing.assert_array_equal(
        krr.pack_records(torch.as_tensor(narrow), G, wide=True).numpy(),
        krr.pack_records(torch.as_tensor(narrow), G).numpy())


def test_wide_replay_plain_equals_its_emulation_and_the_full_records():
    """route_replay_plain over 16-bit bins (values past 32 767) equals a
    numpy walk of the full records and the 16-bit kernel's decisions
    (packed words, clamped bins, special records whole), row for row."""
    rs = np.random.RandomState(5)
    n, G, R, L, Bmax = 3000, 5, 6, 40, 40_000
    tabs = k3_records(rs, R, L, G, Bmax, "routes")
    tabs[..., tl.R_THR] = np.where(rs.rand(R, L) < 0.3,
                                   rs.randint(0, 256, (R, L)),
                                   tabs[..., tl.R_THR])
    bins = rs.randint(0, Bmax, (n, G)).astype(np.uint16)
    bins[:50] = rs.randint(32_768, Bmax, (50, G))
    got = krr.route_replay_plain(_bins_T(bins), _t(tabs)).numpy()
    packed = krr.pack_records(_t(tabs), G, wide=True).numpy()
    w0 = packed[..., 0].view(np.uint32).astype(np.int64)
    w1 = packed[..., 1].view(np.uint32).astype(np.int64)
    sp_bit = krr.PACK_BITS["special_bit"]
    want = np.zeros(n, np.int64)
    emu = np.zeros(n, np.int64)
    for r in range(R):
        for lid, out, fast_path in ((want, want, False), (emu, emu, True)):
            nxt = lid.copy()
            for i in np.flatnonzero(lid >= 0):
                rec = tabs[r, lid[i]]
                if rec[tl.R_CHOSEN] <= 0:
                    continue
                if fast_path and not (w1[r, lid[i]] >> sp_bit) & 1:
                    g = w0[r, lid[i]] >> 16
                    left = _wide_packed_decision(w1[r, lid[i]], bins[i, g])
                    child = w0[r, lid[i]] & 0xffff
                else:
                    left = _full_decision(rec, bins[i, rec[tl.R_GROUP]])
                    child = rec[tl.R_NEWID]
                nxt[i] = lid[i] if left else child
            out[:] = np.where((nxt >= 0) & (nxt < L), nxt,
                              np.where(lid >= 0, -1, lid))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emu, want)
    assert len(np.unique(got)) > 5


def _numpy_walk(bins, rec, depth):
    """Leaf of every row in one tree of host records (numpy, int64)."""
    n = bins.shape[0]
    L = rec.shape[0]
    nd = np.zeros(n, np.int64)
    for _ in range(depth):
        act = nd < L
        r = rec[np.where(act, nd, 0)].astype(np.int64)
        gb = bins[np.arange(n), r[:, tpk.F_GROUP]].astype(np.int64)
        ls = gb - r[:, tpk.F_SPAN]
        fb = np.where((ls >= 0) & (ls < r[:, tpk.F_NBINS] - 1),
                      ls + (ls >= r[:, tpk.F_DEFBIN]), r[:, tpk.F_DEFBIN])
        fb = np.where(r[:, tpk.F_BUNDLED] > 0, fb, gb)
        missing = (((r[:, tpk.F_HASNAN] > 0) & (fb == r[:, tpk.F_NANBIN]))
                   | ((r[:, tpk.F_HASMZ] > 0) & (fb == r[:, tpk.F_MZBIN])))
        left = np.where(missing, r[:, tpk.F_DEFLEFT] > 0,
                        fb <= r[:, tpk.F_THR])
        nxt = np.where(left, r[:, tpk.F_LEFT], r[:, tpk.F_RIGHT])
        nd = np.where(act, nxt, nd)
    return np.where(nd >= L, nd - L, 0)


def _emulate_k1_16bit(bins, packed, lv, depths):
    """(N,) float32 scores as csrc/predict_stream.cu's 16-bit form walks
    them from the packed planes: a plain node's walk words (unsigned
    compare of bin << 16 with group | threshold << 16); a special node's
    flags (9-bit missing codes, 0x1ff read as none, since a 16-bit bin can
    equal it) or, at a wide node, the threshold and missing planes
    (0xffff: none); EFB spans unbundled; no categorical node here."""
    W = packed.view(np.uint32).astype(np.int64)
    words = {k: W[i] for i, k in enumerate(tpk.PACKED_WORDS)}
    n = bins.shape[0]
    T, L = lv.shape
    score = np.zeros(n, np.float32)
    rows = np.arange(n)
    for t in range(T):
        nd = np.zeros(n, np.int64)
        for _ in range(depths[t]):
            act = nd < L
            at = np.where(act, nd, 0)
            c, gt = words["children16"][t, at], words["group_thr"][t, at]
            gb = bins[rows, gt & 0xFFFF].astype(np.int64)
            nx = np.where((gb << 16) <= gt, c & 0xFFFF, c >> 16)
            f = words["flags"][t, at]
            ls = gb - words["span_start"][t, at]
            defb = words["default_bin"][t, at]
            fb = np.where((f >> tpk.BUNDLED_BIT) & 1 > 0,
                          np.where((ls >= 0) & (ls < words["num_bins"][t, at]
                                                - 1), ls + (ls >= defb),
                                   defb), gb)
            wide = (f >> tpk.WIDE_BIT) & 1 > 0
            m = words["missing"][t, at]
            nan9, mz9 = (f >> tpk.NAN_SHIFT) & tpk.NO_BIN, \
                (f >> tpk.MZ_SHIFT) & tpk.NO_BIN
            nan = np.where(wide, np.where((m & 0xFFFF) == tpk.NO_BIN16, -1,
                                          m & 0xFFFF),
                           np.where(nan9 == tpk.NO_BIN, -1, nan9))
            mz = np.where(wide, np.where((m >> 16) == tpk.NO_BIN16, -1,
                                         m >> 16),
                          np.where(mz9 == tpk.NO_BIN, -1, mz9))
            thr = np.where(wide, words["threshold"][t, at],
                           (gt >> 16) & ((1 << tpk.THR_BITS) - 1))
            left = np.where((fb == nan) | (fb == mz),
                            (f >> tpk.DEFLEFT_BIT) & 1 > 0, fb <= thr)
            sp = np.where(left, words["left"][t, at], words["right"][t, at])
            nx = np.where((gt >> tpk.SPECIAL_BIT) & 1 > 0, sp, nx)
            nd = np.where(act, nx, nd)
        score = score + lv[t][np.where(nd >= L, nd - L, 0)]
    return score


def test_wide_k1_nodes_special_and_plain_walk_equals_numpy():
    """pack_nodes makes a node special and wide where its threshold passes
    32 767 or a missing bin passes 510; the plain K1 over 16-bit bins
    (values past 32 767) unpacks them and sums each row's leaf values in
    float32 in tree order, as a numpy walk of the host records does."""
    rs = np.random.RandomState(11)
    n, G, T, L, Bmax = 4000, 6, 8, 31, 40_000
    rec, depths = k1_wide_records(rs, T, L, G, [], ("nan", "efb"), Bmax)
    packed = tpk.pack_nodes(rec)
    flags = packed[tpk.PACKED_WORDS.index("flags")].view(np.uint32)
    gt = packed[tpk.PACKED_WORDS.index("group_thr")].view(np.uint32)
    wide = ((flags >> tpk.WIDE_BIT) & 1) > 0
    want_wide = ((rec[..., tpk.F_THR] >= 1 << tpk.THR_BITS)
                 | ((rec[..., tpk.F_HASNAN] > 0)
                    & (rec[..., tpk.F_NANBIN] >= tpk.NO_BIN)))
    np.testing.assert_array_equal(wide, want_wide)
    assert wide.any() and ((gt[wide] >> tpk.SPECIAL_BIT) == 1).all()
    np.testing.assert_array_equal(
        tpk.unpack_nodes(torch.as_tensor(packed)).numpy(), rec)
    bins = rs.randint(0, Bmax, (n, G)).astype(np.uint16)
    bins[: n // 4] = rs.randint(32_768, Bmax, (n // 4, G))
    bins[-50:] = tpk.NO_BIN
    lv = rs.uniform(-0.1, 0.1, (T, L)).astype(np.float32)
    got = tpk.predict_stream_plain(_bins_T(bins), torch.as_tensor(packed),
                                   torch.as_tensor(lv),
                                   torch.zeros(1, dtype=torch.int32),
                                   depths).numpy()
    want = np.zeros(n, np.float32)
    for t in range(T):
        want = want + lv[t][_numpy_walk(bins, rec[t], depths[t])]
    np.testing.assert_array_equal(got, want)
    # the 16-bit kernel's walk from the planes, bins equal to the 9-bit
    # code of none among them
    assert (bins == tpk.NO_BIN).any()
    np.testing.assert_array_equal(_emulate_k1_16bit(bins, packed, lv,
                                                    depths), want)


# -------------------------------------------------------------- training

_BASE = {"objective": "none", "hist_precision": "single",
         "min_data_in_leaf": 5, "verbosity": -1, "num_leaves": 15,
         "max_splits_per_round": 4}
_GOSS = {"data_sample_strategy": "goss", "learning_rate": 0.5,
         "top_rate": 0.5, "other_rate": 0.25}
_MC = {"objective": "multiclass", "num_class": 3}

# training setups: (extra params, fobj, iterations, rows) -- the probe's
# 20 000 rows (Bmax 1525), 4000 (Bmax ~1200) for the others
_SETUPS = {
    "plain": ({}, _dyadic_fobj, 2, 20_000),
    # 70 leaves at budget 64: the sampled stream tree fuses its rounds into
    # one K3 replay
    "goss": ({**_GOSS, "num_leaves": 70, "max_splits_per_round": 64},
             _dyadic_fobj, 3, 4000),
    "bagging": ({"bagging_fraction": 0.5, "bagging_freq": 1}, _dyadic_fobj,
                2, 4000),
    "quantized": ({"use_quantized_grad": True}, _pow2_fobj, 2, 4000),
    "multiclass": (_MC, _dyadic_mc_fobj, 2, 4000),
}
# case: (setup, the port's backend)
_DYADIC = {
    "stream": ("plain", "stream"), "scatter": ("plain", "scatter"),
    "goss": ("goss", "stream"), "goss_scatter": ("goss", "scatter"),
    "bagging": ("bagging", "stream"), "quantized": ("quantized", "stream"),
    "multiclass": ("multiclass", "stream"),
    "multiclass_scatter": ("multiclass", "scatter"),
}


def _setup_data(setup):
    extra, _, _, n = _SETUPS[setup]
    X, y = _probe(n)
    return X, (wide_label3(X, 4) if extra.get("num_class") else y)


@functools.lru_cache(maxsize=None)
def _jax_scatter_text(setup):
    """The JAX package's scatter model text of a setup (its one-hot
    contraction at Bmax > 128), shared by the port backends held to it."""
    extra, fobj, iters, _ = _SETUPS[setup]
    X, y = _setup_data(setup)
    jb = lgb.Booster({**_BASE, **extra, "hist_backend": "scatter"},
                     lgb.Dataset(X, label=y))
    for _ in range(iters):
        jb.update(fobj=fobj)
    return _trees_text(jb.model_to_string())


@pytest.mark.parametrize("case", sorted(_DYADIC))
def test_dyadic_training_byte_identical_to_jax_scatter(case, monkeypatch):
    """On the probe's 16-bit bins, dyadic custom gradients (quantized:
    power-of-two scales) grow model text byte-identical to the JAX
    package's scatter under the port's stream (K2, its int form, its class
    axis; K3 under GOSS), scatter (K5, K8), GOSS, bagging, quantized
    gradients and multiclass K = 3."""
    setup, backend = _DYADIC[case]
    extra, fobj, iters, _ = _SETUPS[setup]
    X, y = _setup_data(setup)
    calls = {"replay": 0, "int": 0}
    replay, k2int = tgrow.route_replay, tgrow.route_and_hist_int

    def counted_replay(bins_T, tabs):
        calls["replay"] += 1
        assert bins_T.dtype == torch.int16
        return replay(bins_T, tabs)

    def counted_int(bins_T, *args):
        calls["int"] += 1
        return k2int(bins_T, *args)

    monkeypatch.setattr(tgrow, "route_replay", counted_replay)
    monkeypatch.setattr(tgrow, "route_and_hist_int", counted_int)
    tb = lt.Booster({**_BASE, **extra, "hist_backend": backend, **CPU},
                    lt.Dataset(X, label=y, params=CPU))
    for _ in range(iters):
        tb.update(fobj=fobj)
    assert _trees_text(tb.model_to_string()) == _jax_scatter_text(setup)
    eng = tb.engine
    assert eng.dd.bins.dtype == torch.int16 and eng.dd.max_bins > 1000
    assert eng.grow_params.hist_backend == backend
    assert min(t.num_leaves for t in eng.models) > 4
    if case == "goss":
        assert calls["replay"] > 0 and eng.last_compact_rows > 0
    if case == "quantized":
        assert calls["int"] > 0


def test_two_sparse_columns_bundle_trains_under_stream():
    """The EFB bundle of two sparse 255-bin columns (a group of 509 bins)
    trains under stream, byte-identical to the JAX package's scatter on
    dyadic gradients."""
    rs = np.random.RandomState(0)
    Xw = rs.randn(3000, 3)
    a = rs.rand(3000)
    Xw[:, 1] = np.where(a < 0.3, rs.rand(3000) + 0.5, 0.0)
    Xw[:, 2] = np.where(a > 0.7, rs.rand(3000) + 0.5, 0.0)
    params = {**_BASE, "max_bin": 255}
    jb = lgb.Booster({**params, "hist_backend": "scatter"},
                     lgb.Dataset(Xw, label=Xw[:, 0], params=params))
    tb = lt.Booster({**params, **CPU},
                    lt.Dataset(Xw, label=Xw[:, 0], params={**params, **CPU}))
    for _ in range(2):
        jb.update(fobj=_dyadic_fobj)
        tb.update(fobj=_dyadic_fobj)
    assert tb.engine.dd.bins.dtype == torch.int16
    assert tb.engine.grow_params.hist_backend == "stream"
    assert _trees_text(tb.model_to_string()) == \
        _trees_text(jb.model_to_string())


def test_real_gradients_first_tree_and_scores_close_to_jax_segsum():
    """Binary objective on the probe: the first tree identical in structure
    and raw scores within atol 2e-4 of the JAX package's segsum (the split
    budget pinned: the two packages' CPU defaults differ)."""
    X, y = _probe(8000)
    params = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
              "min_data_in_leaf": 20, "max_bin": 255,
              "max_splits_per_round": 1, "verbosity": -1}
    jb = lgb.train({**params, "hist_backend": "segsum",
                    "hist_precision": "single"}, lgb.Dataset(X, label=y), 3)
    tb = lt.train({**params, **CPU}, lt.Dataset(X, label=y, params=CPU), 3)
    assert tb.engine.dd.bins.dtype == torch.int16
    assert _structure(tb.engine.models[0]) == _structure(jb.engine.models[0])
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=2e-4)


# pallas on 16-bit bins: K7's third Bmax range (K8 for K = 3).  case:
# setup, the JAX package's oracle backend
_PALLAS = {"plain": ("plain", "scatter"), "goss": ("goss", "scatter"),
           "quantized": ("quantized", "scatter"),
           "multiclass": ("multiclass", "scatter"),
           "plain_segsum": ("plain", "segsum")}


@functools.lru_cache(maxsize=None)
def _jax_text(setup, backend):
    if backend == "scatter":
        return _jax_scatter_text(setup)
    extra, fobj, iters, _ = _SETUPS[setup]
    X, y = _setup_data(setup)
    jb = lgb.Booster({**_BASE, **extra, "hist_backend": backend},
                     lgb.Dataset(X, label=y))
    for _ in range(iters):
        jb.update(fobj=fobj)
    return _trees_text(jb.model_to_string())


@pytest.mark.parametrize("case", sorted(_PALLAS))
def test_pallas_on_wide_bins_byte_identical_to_jax(case, monkeypatch):
    """``hist_backend="pallas"`` on the probe's 16-bit bins (Bmax ~1500):
    dyadic custom gradients (quantized: power-of-two scales) grow model text
    byte-identical to the JAX package's scatter (its one-hot contraction at
    Bmax > 128) and segsum, under plain, GOSS, quantized and K = 3
    training, the binary runs through K7's plain version on int16 storage
    (the JAX package's own pallas packs bins to a byte and is no oracle
    past 255)."""
    setup, oracle = _PALLAS[case]
    extra, fobj, iters, _ = _SETUPS[setup]
    X, y = _setup_data(setup)
    seen = []
    orig = khs.hist_sorted

    def counted(bins, *args):
        seen.append((bins.dtype, args[6]))
        return orig(bins, *args)

    monkeypatch.setattr(khs, "hist_sorted", counted)
    tb = lt.Booster({**_BASE, **extra, "hist_backend": "pallas", **CPU},
                    lt.Dataset(X, label=y, params=CPU))
    for _ in range(iters):
        tb.update(fobj=fobj)
    assert _trees_text(tb.model_to_string()) == _jax_text(setup, oracle)
    assert tb.engine.dd.bins.dtype == torch.int16
    assert tb.engine.grow_params.hist_backend == "pallas"
    if setup != "multiclass":
        # K7 (Bmax > 128) over the int16 storage of 16-bit bins
        assert seen and all(d == torch.int16 and b > 256 for d, b in seen)


@pytest.mark.parametrize("Bmax", [301, 1525])
def test_plain_k7_on_16bit_bins_equals_jax_segsum(Bmax):
    """hist_sorted_plain over a slot-sorted block plan of 16-bit bins (int16
    storage, bins past 255 and at Bmax - 1) equals the JAX package's segsum
    histograms of the same rows and slots bit for bit on dyadic weights."""
    from lightgbm_torch.ops.compact import plan_blocks
    rs = np.random.RandomState(Bmax)
    n, G, S = 3000, 3, 5
    bins = rs.randint(0, Bmax, size=(n, G)).astype(np.uint16)
    bins[::7, 1] = Bmax - 1
    slot = np.where(rs.rand(n) < 0.8, rs.randint(0, S, n), -1).astype(
        np.int32)
    grad = (rs.randint(-64, 64, n) / 64).astype(np.float32)
    hess = (rs.randint(1, 64, n) / 64).astype(np.float32)
    cnt = (rs.rand(n) < 0.9).astype(np.float32)
    plan = plan_blocks(torch.as_tensor(slot), S, 256)
    got = khs.hist_sorted_plain(tl.bins_to_torch(bins), plan.gather_idx,
                                plan.scalars, _t(grad), _t(hess), _t(cnt),
                                S, Bmax, hist_shift(1.0, n), 256).numpy()
    want = np.asarray(_hist_segsum(jnp.asarray(bins), jnp.asarray(slot),
                                   jnp.asarray(grad), jnp.asarray(hess),
                                   jnp.asarray(cnt), S, Bmax))
    np.testing.assert_array_equal(got, want)
    assert (got[:, 1, Bmax - 1, 2] > 0).any()


# --------------------------------------------------------------- predict

def _count_k1(monkeypatch):
    """Count Booster.predict's calls of K1's wrapper and the bins' dtypes
    it hands it."""
    seen = []
    orig = tbasic.predict_stream

    def counted(bins_T, *args):
        seen.append(bins_T.dtype)
        return orig(bins_T, *args)

    monkeypatch.setattr(tbasic, "predict_stream", counted)
    return seen


def test_predict_on_wide_bins_goes_through_k1_and_matches_jax(monkeypatch):
    """Booster.predict over 16-bit bins (the probe's bundle) goes through
    K1's wrapper, no host walk, and agrees with the JAX package's predict
    of the same model text within rtol 1e-4 / atol 1e-5."""
    X, y = _probe(6000)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    tb = lt.train({**params, **CPU}, lt.Dataset(X, label=y, params=CPU), 3)
    seen = _count_k1(monkeypatch)
    Xt = _probe(20_000, seed=1)[0]
    got = tb.predict(Xt, raw_score=True)
    assert seen == [torch.int16]
    jb = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(got, jb.predict(Xt, raw_score=True),
                               rtol=RTOL, atol=ATOL)


def test_thresholds_past_32767_predict_through_k1_like_jax(monkeypatch):
    """One feature at max_bin 40 000: thresholds past 32 767 (wide K1
    nodes) and bins past 32 767; Booster.predict through K1's plain
    version agrees with the JAX package's predict and with the float64
    host walk within rtol 1e-4 / atol 1e-5."""
    rs = np.random.RandomState(2)
    n = 40_000
    X = np.column_stack([rs.rand(n), rs.randn(n)])
    y = ((X[:, 0] > 0.93) | ((X[:, 0] > 0.85) & (X[:, 1] > 0))).astype(float)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 40_000,
              "min_data_in_bin": 1, "min_data_in_leaf": 20, "verbosity": -1}
    tb = lt.train({**params, **CPU},
                  lt.Dataset(X, label=y, params={**params, **CPU}), 3)
    assert tb.engine.dd.max_bins > 32_768
    use, k, _, _ = tb._resolve_tree_slice(0, None)
    inp = tb._device_predict_inputs(X, use, k)
    nodes = inp.classes[0][0].numpy()
    gt = nodes[tpk.PACKED_WORDS.index("group_thr")].view(np.uint32)
    flags = nodes[tpk.PACKED_WORDS.index("flags")].view(np.uint32)
    assert ((flags >> tpk.WIDE_BIT) & 1).any()
    assert ((gt >> tpk.SPECIAL_BIT) == 1).any()
    seen = _count_k1(monkeypatch)
    got = tb.predict(X, raw_score=True)
    assert seen == [torch.int16]
    host = tbasic._host_predict(X, use, 1, False, 10, 10.0)
    np.testing.assert_allclose(got, host, rtol=RTOL, atol=ATOL)
    jb = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(got, jb.predict(X, raw_score=True),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("max_bin,dtype", [(255, torch.uint8),
                                           (256, torch.int16)])
def test_categorical_sentinel_past_uint8_predicts_through_k1(
        max_bin, dtype, monkeypatch):
    """300 categories: at max_bin 255 the feature keeps 255 bins and its
    NaN / unseen sentinel bin 255 fits uint8; at 256 the sentinel bin 256
    does not, and the predict matrix widens to 16-bit bins.  Both go
    through K1's wrapper (no host walk) and equal the float64 host walk
    within rtol 1e-4 / atol 1e-5, over unseen, NaN and negative
    categories."""
    rs = np.random.RandomState(7)
    n = 30_000
    X = rs.randn(n, 3)
    X[:, 2] = rs.randint(0, 300, n)
    effect = 2.0 * rs.randn(300)
    y = (effect[X[:, 2].astype(int)] + 0.5 * X[:, 0] + 0.3 * rs.randn(n)
         > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": max_bin,
              "min_data_per_group": 20, "verbosity": -1}
    ds = lt.Dataset(X, label=y, categorical_feature=[2],
                    params={**params, **CPU})
    tb = lt.train({**params, **CPU}, ds, 3)
    assert ds.bin_mappers()[2].num_bins == max_bin
    assert tb.engine.dd.bins.dtype == torch.uint8
    assert any((np.asarray(t.decision_type[:t.num_leaves - 1]) & 1).any()
               for t in tb.engine.models)
    Xt = X.copy()
    Xt[:500, 2] = rs.randint(300, 400, 500)      # unseen
    Xt[500:700, 2] = np.nan
    Xt[700:800, 2] = -3
    seen = _count_k1(monkeypatch)
    got = tb.predict(Xt, raw_score=True)
    assert seen == [dtype]
    use, _, _, _ = tb._resolve_tree_slice(0, None)
    host = tbasic._host_predict(Xt, use, 1, False, 10, 10.0)
    np.testing.assert_allclose(got, host, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------- wrappers

def test_c_entry_points_take_the_bin_width():
    """Every entry point whose kernel reads bins takes the bins' pointer
    and then their width in bytes (1: uint8, 2: 16-bit), as its wrapper
    passes them (tests/test_torch_predict.py holds each argument list to
    its C prototype)."""
    import re
    from pathlib import Path
    here = Path(build.__file__).parent
    for name, (sym, argtypes) in build.SIGNATURES.items():
        src = (here / build.SOURCES[name]).read_text()
        params = re.search(r'extern "C" int ' + sym + r"\(([^)]*)\)",
                           src).group(1).split(",")
        if name in ("leaf_gather", "bin_rows", "tree_shap", "bin_csr"):
            continue        # these kernels read no bins
        # K6/K7 read row-major (N, G) bins, the others (G, N)
        bins = "bins" if name in ("hist_direct", "hist_nibble") else "bins_T"
        assert params[0].split() == ["const", "void*", bins], name
        assert params[1].split() == ["int", "bin_bytes"], name
        assert argtypes[1] is build._c_int, name


def test_wrappers_refuse_cpu_tensors_and_other_bin_types():
    """The CUDA wrappers take 16-bit bins but raise on CPU tensors and on
    any bin type but uint8 and int16."""
    bT = tl.pack_bins_T(np.zeros((8, 2), np.uint16), torch.device("cpu"))
    z = torch.zeros(8)
    s = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(lt.LightGBMError, match="CUDA tensors"):
        ksh.scatter_hist_cuda(bT, s, z, z, z, 1, 300, 0)
    with pytest.raises(lt.LightGBMError, match="uint8 or torch.int16"):
        ksh.scatter_hist_cuda(bT.to(torch.int32), s, z, z, z, 1, 300, 0)
    with pytest.raises(lt.LightGBMError, match="CUDA tensors"):
        krr.route_replay_cuda(bT, torch.zeros((1, 2, 16), dtype=torch.int32))
    assert ksh.scatter_hist(bT, s, z, z, z, 1, 300, 0).shape == (1, 2, 300, 3)
