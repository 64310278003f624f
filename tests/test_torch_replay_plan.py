"""K3 ``route_replay``'s packed records, launch plan and pass, on the CPU.

K3 (``csrc/route_replay.cu``) packs each (round, leaf) route record into
the 8 bytes its decision reads (``kernels/route_replay.py::pack_records``;
a record that does not fit is special and is read whole), then runs
persistent blocks over tiles of rows (``replay_plan``), the packed table
in shared memory.  The kernel runs only on the card
(``chip_smoke.py`` holds it bit for bit against its plain version there);
these tests hold:

- the packing: every field the decision reads round-trips, the special bit
  is set exactly where a record does not fit (EFB bundles, children or
  groups outside 16 bits or the bins), and for every bin byte the packed
  decision equals the full record's;
- every row in one tile and every tile in one block, within the sm_90
  limits the C side checks, the main path's plan pinned, and the plan's
  field order and the packed word's bits equal to the C enums;
- a numpy emulation of the kernel (tile by tile in each block's order,
  packed records, special records from the full table, the packed table
  staged or not) equal to ``route_replay_plain`` bit for bit: leaf ids are
  integers, no tolerance;
- ``route_replay_plain`` equal to the JAX package's ``route_replay``
  (Pallas in interpret mode) on tables built from the same numpy per-leaf
  arrays.
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

from lightgbm_tpu.pallas import stream_kernel as jsk

import chip_smoke
from lightgbm_torch.kernels import hist_wide as khw
from lightgbm_torch.kernels import layout as tl
from lightgbm_torch.kernels import route_replay as krr

from test_torch_sample import _grown_rounds
from test_torch_train import _datasets, _mixed

SRC = Path(krr.__file__).parent / "csrc" / "route_replay.cu"
BITS = krr.PACK_BITS


def _limits(plan, n, G, R, L):
    """The limits plan_ok in csrc/route_replay.cu checks."""
    assert 32 <= plan.threads <= krr.MAX_THREADS and plan.threads % 32 == 0
    assert plan.rows_per_tile >= 16 and plan.rows_per_tile % 16 == 0
    assert plan.rows_per_tile <= krr.ROWS_PER_THREAD * plan.threads
    assert 1 <= plan.tiles <= 2 ** 31 - 1
    assert plan.tiles * plan.rows_per_tile >= n
    assert (plan.tiles - 1) * plan.rows_per_tile < max(n, 1)
    assert 1 <= plan.blocks <= plan.tiles
    assert plan.tab_bytes in (0, -(-8 * R * (L + 1) // 16) * 16)
    assert plan.tab_bytes <= khw.SMEM_BLOCK


def _tiles_of(plan):
    """Each block's tiles, in the order it takes them."""
    return [list(range(b, plan.tiles, plan.blocks))
            for b in range(plan.blocks)]


# ------------------------------------------------------------ the packing

def _full_decision(rec, gb):
    """(go_left, next leaf) of a row whose group byte is ``gb`` (an array)
    at this full record: numeric_go_left's rule, written out."""
    fb = gb.astype(np.int64)
    if rec[tl.R_BUNDLED] > 0:
        ls = fb - rec[tl.R_SPAN]
        in_span = (ls >= 0) & (ls < rec[tl.R_NBINS] - 1)
        fb = np.where(in_span, ls + (ls >= rec[tl.R_DEFBIN]),
                      rec[tl.R_DEFBIN])
    missing = (fb == rec[tl.R_NANBIN]) | (fb == rec[tl.R_MZBIN])
    return np.where(missing, rec[tl.R_DEFLEFT] > 0, fb <= rec[tl.R_THR])


def _packed_decision(w1, gb):
    """go_left of the packed word ``w1`` (uint32) for bin bytes ``gb``, as
    the kernel decides it."""
    gb = gb.astype(np.uint32)
    missing = ((gb == (w1 >> BITS["nan_shift"]) & 0x1ff)
               | (gb == (w1 >> BITS["mz_shift"]) & 0x1ff))
    return np.where(missing, ((w1 >> BITS["default_left_bit"]) & 1) > 0,
                    gb < (w1 & 0x1ff))


def _edge_records(G):
    """Split records at the packing's edges (one round, 25 leaves):
    thresholds below 0 and past 255, missing bins past 255 or below -1,
    children at and past L and 16 bits, groups at and past G and 16 bits,
    an EFB bundle, chosen values other than 0 / 1."""
    rows = []

    def rec(**kw):
        r = np.zeros(len(tl.ROUTE_FIELDS), np.int32)
        r[tl.R_CHOSEN], r[tl.R_NEWID], r[tl.R_GROUP] = 1, 5, G - 1
        r[tl.R_NANBIN], r[tl.R_MZBIN], r[tl.R_NBINS] = -1, -1, 256
        r[tl.R_THR] = 17
        for k, v in kw.items():
            r[getattr(tl, "R_" + k)] = v
        rows.append(r)

    for thr in (-2 ** 31, -7, -1, 0, 254, 255, 256, 2 ** 31 - 1):
        rec(THR=thr)
    for nan, mz in ((255, 0), (256, -1), (-5, 300), (0, 0), (511, 255)):
        rec(NANBIN=nan, MZBIN=mz, DEFLEFT=1)
    rec(NEWID=0xffff)
    rec(NEWID=0x10000)
    rec(NEWID=-1)
    rec(NEWID=2 ** 31 - 1)
    rec(GROUP=0)
    rec(GROUP=G)
    rec(GROUP=-1)
    rec(BUNDLED=1, SPAN=3, DEFBIN=2, NBINS=9)
    rec(BUNDLED=-1)
    rec(CHOSEN=2, DEFLEFT=5)
    rec(CHOSEN=-1)
    rec(CHOSEN=0, NEWID=9)
    return np.stack(rows)[None]


@pytest.mark.parametrize("kind,G,L", [("grown", 28, 255),
                                      ("missing", 28, 255),
                                      ("routes", 300, 255),
                                      ("out_of_range", 7, 31),
                                      ("edges", 70_000, 0),
                                      ("edges", 40, 0)])
def test_pack_round_trips_and_marks_special_records(kind, G, L):
    if kind == "edges":
        tabs = _edge_records(G)
    else:
        tabs = chip_smoke.k3_records(np.random.RandomState(G + L), 9, L, G,
                                     256, kind)
    R, L = tabs.shape[:2]
    full = krr.pack_records(torch.as_tensor(tabs), G).numpy()
    assert full.shape == (R, L + 1, 2) and full.dtype == np.int32
    # leaf L, the stop leaf, is never split
    assert (full[:, L] == 0).all()
    packed = full[:, :L]
    w0, w1 = packed[..., 0].view(np.uint32), packed[..., 1].view(np.uint32)
    t = tabs.astype(np.int64)
    chosen = t[..., tl.R_CHOSEN] > 0
    new_id, group = t[..., tl.R_NEWID], t[..., tl.R_GROUP]
    special = ((t[..., tl.R_BUNDLED] > 0) | (new_id < 0)
               | (new_id >= min(L, 0x10000)) | (group < 0)
               | (group >= min(G, 0x10000)))
    # a leaf not split that round packs to zero
    assert (packed[~chosen] == 0).all()
    is_special = (w1 >> BITS["special_bit"]) == 1
    np.testing.assert_array_equal(is_special, chosen & special)
    sp = chosen & special
    assert (w0[sp] == 0).all()
    assert (w1[sp] == (1 << BITS["chosen_bit"] | 1 << BITS["special_bit"])
            ).all()
    fast = chosen & ~special
    assert (((w1[fast] >> BITS["chosen_bit"]) & 1) == 1).all()
    assert (((w1[fast] >> 29) & 3) == 0).all()        # unused bits clear
    np.testing.assert_array_equal(w0[fast] & 0xffff, new_id[fast])
    np.testing.assert_array_equal(w0[fast] >> 16, group[fast])
    np.testing.assert_array_equal(
        w1[fast] & 0x1ff, np.clip(t[..., tl.R_THR][fast] + 1, 0, 256))
    for field, shift in ((tl.R_NANBIN, "nan_shift"),
                         (tl.R_MZBIN, "mz_shift")):
        b = t[..., field][fast]
        np.testing.assert_array_equal(
            (w1[fast] >> BITS[shift]) & 0x1ff,
            np.where((b >= 0) & (b <= 255), b, 0x1ff))
    np.testing.assert_array_equal(
        (w1[fast] >> BITS["default_left_bit"]) & 1,
        t[..., tl.R_DEFLEFT][fast] > 0)
    # every bin byte decides the same way through the packed word
    gb = np.arange(256)
    for r, l in zip(*np.nonzero(fast)):
        np.testing.assert_array_equal(_packed_decision(w1[r, l], gb),
                                      _full_decision(tabs[r, l], gb))
    if kind == "routes":
        assert 0 < sp.sum() < fast.sum()
    if kind == "edges":
        # past 16 bits every group but 0 is special; else the children
        # outside [0, L), the groups outside [0, G) and the bundle
        assert sp.sum() == (22 if G >= 0x10000 else 7)


# ------------------------------------------------------------- the plan

@settings(max_examples=300, deadline=None)
@given(n=st.integers(0, 3_000_000), G=st.integers(1, 5000),
       R=st.integers(0, 40), L=st.integers(1, 20_000))
def test_plan_covers_every_row_once_within_limits(n, G, R, L):
    plan = krr.replay_plan(n, G, R, L)
    _limits(plan, n, G, R, L)
    tiles = sorted(t for ts in _tiles_of(plan) for t in ts)
    assert tiles == list(range(plan.tiles))
    # no more blocks than a wave of the card holds
    per_sm = max(1, min(krr.SM_THREADS // plan.threads,
                        khw.SMEM_SM // (plan.tab_bytes + 1024)))
    assert plan.blocks <= khw.SMS * per_sm
    if R == 0:
        assert plan.tab_bytes == 0


@settings(max_examples=200, deadline=None)
@given(n=st.integers(0, 200_000), G=st.integers(1, 300),
       R=st.integers(0, 20), L=st.integers(1, 3000),
       budget=st.integers(0, khw.SMEM_BLOCK),
       threads=st.sampled_from([32, 64, 128, 256, 512]),
       rows=st.integers(1, krr.ROWS_PER_THREAD), stage_tab=st.booleans())
def test_small_budget_plans_within_limits(n, G, R, L, budget, threads, rows,
                                          stage_tab):
    plan = krr._replay_plan(n, G, R, L, budget, threads, rows, stage_tab)
    _limits(plan, n, G, R, L)
    assert plan.tab_bytes <= budget
    assert plan.rows_per_tile <= threads * rows
    assert plan.tab_bytes == 0 or stage_tab


def test_main_path_plan_pinned():
    """Phase train_sampled: 1M rows of 28 groups, 9 rounds of 255 leaves.
    The packed table (9 x 256 records with the stop leaf, 18 432 bytes) is
    staged; one wave of 1042 blocks of 256 threads, a tile of 960 rows
    each."""
    assert krr.replay_plan(1_000_000, 28, 9, 255) == krr.ReplayPlan(
        rows_per_tile=960, threads=256, tiles=1042, blocks=1042,
        tab_bytes=18432)
    # a table past TAB_STAGE_MAX is read from global memory
    assert krr.replay_plan(1_000_000, 28, 17, 16383) == krr.ReplayPlan(
        rows_per_tile=960, threads=256, tiles=1042, blocks=1042,
        tab_bytes=0)
    # 10M rows: one wave of blocks, about ten tiles each
    big = krr.replay_plan(10_000_000, 28, 9, 255)
    assert big.blocks == 1056 and 9 * big.blocks < big.tiles <= 10 * big.blocks


def test_plan_fields_and_pack_bits_follow_the_c_enums():
    src = SRC.read_text()
    enums = re.findall(r"enum \{([^}]*)\}", src)
    plan_enum = [e for e in enums if "kRowsPerTile" in e][0]
    names = [w.strip() for w in plan_enum.split(",") if w.strip()]
    camel = ["k" + "".join(w.title() for w in f.split("_"))
             for f in krr.REPLAY_PLAN_FIELDS]
    assert names == camel
    bits_enum = [e for e in enums if "kNanShift" in e][0]
    c_bits = dict((k.strip(), int(v)) for k, v in
                  (w.split("=") for w in bits_enum.split(",") if w.strip()))
    assert c_bits == {"k" + "".join(w.title() for w in k.split("_")): v
                      for k, v in BITS.items()}
    assert f"kRows = {krr.ROWS_PER_THREAD};" in src
    assert f"kMaxThreads = {krr.MAX_THREADS};" in src
    assert "kBinMask = 0x1ff;" in src and krr.BIN_NONE == 0x1ff


# --------------------------------------------------- the kernel's pass

def emulate(plan, bins_T, tabs):
    """(N,) int32 leaves as csrc/route_replay.cu's kernel computes them
    under ``plan``: each block takes its tiles in turn; each row of the tile
    (rows t + i * threads, i < 4) starts at leaf 0 and takes each round's
    packed record of its leaf: zero keeps the leaf, a special record
    decides from the full record, any other from the packed word, both with
    the row's byte of the (G, N) bins; a child outside [0, L) stops the row
    at -1.  Each row is written exactly once."""
    G, n = bins_T.shape
    R, L = tabs.shape[:2]
    packed = krr.pack_records(torch.as_tensor(tabs), G).numpy()
    w0, w1 = packed[..., 0].view(np.uint32), packed[..., 1].view(np.uint32)
    out = np.full(n, -9, np.int32)
    written = np.zeros(n, np.int64)
    rpt = plan.rows_per_tile
    for tiles in _tiles_of(plan):
        for tile in tiles:
            r0 = tile * rpt
            nr = min(rpt, n - r0)
            if nr <= 0:
                continue
            lr = (np.arange(plan.threads)[None, :] + plan.threads
                  * np.arange(krr.ROWS_PER_THREAD)[:, None]).ravel()
            lr = np.sort(lr[lr < nr])
            assert np.array_equal(lr, np.arange(nr))   # each row once
            lid = np.zeros(nr, np.int64)
            for r in range(R):
                live = np.flatnonzero(lid >= 0)
                p0, p1 = w0[r, lid[live]], w1[r, lid[live]]
                nxt = lid[live].copy()
                sp = (p1 >> BITS["special_bit"]) == 1
                fast = (p1 != 0) & ~sp
                rows_f = live[fast]
                g = (p0[fast] >> 16).astype(np.int64)
                gb = bins_T[g, r0 + rows_f]
                left = _packed_decision(p1[fast], gb)
                nxt[fast] = np.where(left, lid[rows_f], p0[fast] & 0xffff)
                for j in np.flatnonzero(sp):
                    row = live[j]
                    rec = tabs[r, lid[row]]
                    gbs = bins_T[rec[tl.R_GROUP], r0 + row:r0 + row + 1]
                    left = _full_decision(rec, gbs)[0]
                    nxt[j] = lid[row] if left else rec[tl.R_NEWID]
                lid[live] = np.where((nxt >= 0) & (nxt < L), nxt, -1)
            out[r0:r0 + nr] = lid
            written[r0:r0 + nr] += 1
    assert (written == 1).all()
    return out


def _plan_of(n, G, R, L, opts):
    if opts is None:
        return krr.replay_plan(n, G, R, L)
    return krr._replay_plan(n, G, R, L, *opts)


# (n, G, R, L, Bmax, kind, plan options or None for the default plan):
# (budget, threads, rows a thread, stage the table)
CASES = [
    (5000, 28, 9, 255, 255, "grown", None),
    (5000, 28, 9, 255, 63, "missing", None),
    (4097, 13, 9, 255, 256, "routes", None),
    (4097, 13, 9, 255, 256, "routes", (4096, 32, 4, True)),
    (3001, 7, 6, 31, 63, "out_of_range", (0, 64, 2, False)),
    (3001, 7, 6, 31, 63, "out_of_range", None),
    (2000, 5, 1, 2, 63, "grown", None),
    (2000, 5, 0, 31, 63, "grown", None),
    (999, 300, 9, 255, 200, "routes", (65536, 32, 1, True)),
    (1, 28, 9, 255, 63, "routes", None),
    (777, 3, 17, 3000, 63, "grown", (30000, 128, 4, True)),
    (2501, 27, 9, 255, 200, "routes", None),
]


@pytest.mark.parametrize("n,G,R,L,Bmax,kind,opts", CASES)
def test_emulated_pass_equals_plain_bit_for_bit(n, G, R, L, Bmax, kind,
                                                opts):
    rs = np.random.RandomState(n + G + R)
    tabs = chip_smoke.k3_records(rs, R, L, G, Bmax, kind)
    bins_T = rs.randint(0, Bmax, size=(G, n)).astype(np.uint8)
    plan = _plan_of(n, G, R, L, opts)
    _limits(plan, n, G, R, L)
    got = emulate(plan, bins_T, tabs)
    want = krr.route_replay_plain(torch.as_tensor(bins_T),
                                  torch.as_tensor(tabs)).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "out_of_range":
        assert (want == -1).any()
    if R > 1 and n > 100:
        assert len(np.unique(want)) > 3
    if R == 0:
        assert (want == 0).all()


def test_plain_stops_rows_at_children_out_of_range():
    """A child outside [0, L) stops the row at -1 and later rounds leave it
    there, whichever side the child lies."""
    L = 4
    tabs = np.zeros((3, L, len(tl.ROUTE_FIELDS)), np.int32)
    tabs[..., tl.R_NANBIN] = tabs[..., tl.R_MZBIN] = -1
    tabs[0, 0, [tl.R_CHOSEN, tl.R_NEWID, tl.R_THR]] = (1, 1, 0)
    tabs[1, 1, [tl.R_CHOSEN, tl.R_NEWID, tl.R_THR]] = (1, L, 1)
    tabs[1, 0, [tl.R_CHOSEN, tl.R_NEWID, tl.R_THR]] = (1, -2, 1)
    tabs[2, 0, [tl.R_CHOSEN, tl.R_NEWID, tl.R_THR]] = (1, 3, 5)
    bins_T = np.array([[0, 1, 2, 3]], np.uint8)
    got = krr.route_replay_plain(torch.as_tensor(bins_T),
                                 torch.as_tensor(tabs)).numpy()
    # row 0: left, left, left; row 1: right to 1, left; rows 2 and 3:
    # right to 1, right to L: stopped
    np.testing.assert_array_equal(got, [0, 1, -1, -1])
    plan = krr._replay_plan(4, 1, 3, L, 0, 32, 1)
    np.testing.assert_array_equal(emulate(plan, bins_T, tabs), got)


# ------------------------------------------- the plain version vs JAX

@pytest.mark.parametrize("R,L,zero_as_missing", [(1, 8, False),
                                                 (4, 64, True)])
def test_plain_equals_jax_route_replay(R, L, zero_as_missing, monkeypatch):
    """route_replay_plain equals the JAX package's route_replay (interpret
    mode) on tables both packages build from the same numpy per-leaf arrays
    over a dataset with NaN, zero-as-missing and EFB-bundled features."""
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    X, y = _mixed(1500, 23 + R)
    jds, tds = _datasets(X, y, {"max_bin": 31, "verbosity": -1,
                                "zero_as_missing": zero_as_missing})
    rs = np.random.RandomState(R)
    rounds, _ = _grown_rounds(tds, rs, R, L)
    jdd, tdd = jds.device_data(), tds.device_data()
    N = X.shape[0]
    z = jnp.zeros(L, jnp.int32)
    keep = torch.full((L,), -1, dtype=torch.int32)
    t = torch.as_tensor
    j_bufs, t_tabs = [], []
    for chosen, feat, thr, dirf, new in rounds:
        j_bufs.append(jsk.build_route_tables(
            jnp.asarray(chosen), jnp.asarray(feat), jnp.asarray(thr),
            jnp.asarray(dirf), jnp.asarray(new), z, z, z, jdd.routing, L))
        t_tabs.append(tl.build_route_tables(
            t(chosen), t(new), t(feat), t(thr), t(dirf), keep, keep, keep,
            tdd.routing))
    want = np.asarray(jsk.route_replay(
        jsk.pack_bins_T(jdd.bins).bins_T, jnp.concatenate(j_bufs),
        jnp.asarray(R, jnp.int32), L))[:N]
    bins_T = tdd.bins[:N].t().contiguous()
    tabs = torch.stack(t_tabs)
    got = krr.route_replay_plain(bins_T, tabs).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        emulate(krr.replay_plan(N, bins_T.shape[0], R, L), bins_T.numpy(),
                tabs.numpy()), want)
    assert len(np.unique(want)) > (1 if R == 1 else 3)
