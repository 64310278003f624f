#!/usr/bin/env python3
"""Time the port's histogram kernels, K5 ``scatter_hist``, K8 ``hist_wide``
and both forms of K2 ``route_and_hist`` (rows in their natural order), K6
``hist_direct`` and K7 ``hist_nibble`` (the slot-sorted block plan), the
prediction kernel K1 ``predict_stream`` and the route replay K3
``route_replay``, on one NVIDIA GPU at the main paths' shapes.

    python3 scripts/torch_hist_bench.py [--root DIR]
                                        [--only k58|k2|k67|k1|k3]
                                        [--sass] [--route-probe]
                                        [--label TEXT]

``--root`` is the checkout whose ``lightgbm_torch`` is measured (default:
this repository), so a parent commit unpacked with ``git archive`` can be
timed in the same call.  Inputs are synthetic and seeded: 1M rows (K = 10:
900 000 rows x 10 classes) x 28 groups of uniform bins, N(0, 1) gradients,
hessians in [0.05, 0.25] (K2's int form: int8 grid values in [-2, 2] and
[0, 4]), count weights 1; a root round (every row in slot 0) and rounds of
S slots that hold half the rows, drawn at random in their natural order
(K2: half the rows in S / 2 leaves whose split on one group sends each row
to one of two slots by its bin, the other half in a leaf without a slot).
Each shape prints one JSON line: the kernel's device time
(``chip_smoke.device_ms``), one ``index_add_`` over the same (row, class,
group) triples (float32; int32 for K2's int form), the bound
(``chip_smoke.hist_work`` / ``k2_work``), and whether the kernel equals its
plain version bit for bit.  K6 and K7 (1M rows x 28 groups, row-major, at
Bmax 63 and 255, S = 1 (the root's plan), 16 and 64 over half the rows,
blocks of 1024) print the same, K6 also its time under other launch
plans (128, 256 and 512 threads; 1, 2 and 3 plan blocks a range) and K7
under its (tiles of 28, 16, 12, 8 and 4 groups; 256, 512 and 1024
threads; 1-12 plan blocks a range or the plan's own).  K3 runs one sampled
tree's launch (12 GOSS trees on 1M HIGGS-shaped rows) and grown synthetic
trees (``chip_smoke.k3_records``) of R = 1, 5 and 9 rounds and 31 and 255
leaves over 1M rows x 28 groups: its time with the L2 cache warm and cold,
the plain version's, its bound (``chip_smoke.k3_work``), its time under
other plans and one launch split by kernel.  K1 runs
synthetic numeric trees (``chip_smoke.k1_records``) of 31 and 255 leaves,
100 and 500 of them, over 1M rows x 28 groups: its time, its launch plan,
the node visits (the kernel itself summing per-leaf depths), the bytes its
stages copy into shared memory and its bound.  ``--sass`` also prints the
atomic instructions of each kernel function of the built libraries
(``cuobjdump -sass``) and the device time of one K8, one K6 and one K1
launch and of K2 launches of each form (K = 10 at S = 64 and at the root,
K = 1 at the root) by CUDA kernel and memset (``torch.profiler``).
``--route-probe`` trains 3 binary trees on 1M HIGGS-shaped rows with float
and with quantized gradients, and times each tree's route-only K2 launch
through its own form and through the other (``device_ms``, CUDA events
around one call, ``torch.profiler``), beside what the launch's data hold
per warp.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROWS, ROWS_K, GROUPS, CLASSES = 1_000_000, 900_000, 28, 10
LIBRARIES = ("scatter_hist", "hist_wide", "route_and_hist",
             "route_and_hist_int", "hist_direct", "hist_nibble",
             "predict_stream", "route_replay")
BLOCK_ROWS = 1024


def make_inputs(torch, n, G, K, S, Bmax, seed):
    """Seeded operands of one launch on the card: (G, N) bins, (K, N) slots
    (or (N,) for K = 0, the single-class K5 call), grads, hesses, (N,)
    counts and the shift of each class."""
    from lightgbm_torch.ops.histogram import hist_shift
    rs = np.random.RandomState(seed)
    kk = max(K, 1)
    bins = rs.randint(0, Bmax, size=(G, n)).astype(np.uint8)
    if S == 1:
        slot = np.zeros((kk, n), np.int32)
    else:
        slot = np.where(rs.rand(kk, n) < 0.5, rs.randint(0, S, size=(kk, n)),
                        -1).astype(np.int32)
    grad = rs.randn(kk, n).astype(np.float32)
    hess = rs.uniform(0.05, 0.25, size=(kk, n)).astype(np.float32)
    cnt = np.ones(n, np.float32)
    shifts = [hist_shift(float(max(np.abs(grad[k]).max(),
                                   np.abs(hess[k]).max())), n)
              for k in range(kk)]
    dev = torch.device("cuda")
    t = [torch.from_numpy(x).to(dev) for x in (bins, slot, grad, hess, cnt)]
    if K == 0:
        t[1], t[2], t[3] = t[1][0].contiguous(), t[2][0].contiguous(), \
            t[3][0].contiguous()
    return t, shifts


def make_k2_inputs(torch, n, G, K, S, Bmax, seed, int_form):
    """Seeded arguments of one K2 launch with histograms (the float form's,
    or with ``int_form`` the int form's) on the card.  S = 1 is the root
    round: every row in leaf 0, which is not split and keeps slot 0.  For
    S > 1, half the rows of each class lie in S / 2 leaves, leaf j split at
    the middle bin of group j % G, its rows going to slot 2j (left) or
    2j + 1; the other half lie in a leaf that is not split and has no
    slot."""
    from lightgbm_torch.kernels import layout as tl
    from lightgbm_torch.ops.histogram import hist_shift, scale_table
    rs = np.random.RandomState(seed)
    bins = rs.randint(0, Bmax, size=(G, n)).astype(np.uint8)
    half = S // 2
    L = 1 if S == 1 else half + 1
    tabs = np.zeros((K, L, len(tl.ROUTE_FIELDS)), np.int32)
    if S == 1:
        leaf = np.zeros((K, n), np.int32)
    else:
        leaf = np.where(rs.rand(K, n) < 0.5,
                        rs.randint(0, half, size=(K, n)), half)
        j = np.arange(half)
        for f, v in ((tl.R_CHOSEN, 1), (tl.R_NEWID, j), (tl.R_GROUP, j % G),
                     (tl.R_NBINS, Bmax), (tl.R_THR, (Bmax - 1) // 2),
                     (tl.R_NANBIN, -1), (tl.R_MZBIN, -1),
                     (tl.R_SLOT_L, 2 * j), (tl.R_SLOT_R, 2 * j + 1)):
            tabs[:, :half, f] = v
        tabs[:, half, tl.R_SLOT_KEEP] = -1
    words = np.zeros((K, L, (Bmax + 31) // 32), np.int32)
    cnt = np.ones(n, np.float32)
    dev = torch.device("cuda")
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
         for x in (bins, leaf.astype(np.int32), tabs, words)]
    if int_form:
        qg = rs.randint(-2, 3, size=(K, n)).astype(np.int8)
        qh = rs.randint(0, 5, size=(K, n)).astype(np.int8)
        return (*t, torch.from_numpy(qg).to(dev), torch.from_numpy(qh).to(dev),
                torch.from_numpy(cnt).to(dev), S, Bmax, True)
    grad = rs.randn(K, n).astype(np.float32)
    hess = rs.uniform(0.05, 0.25, size=(K, n)).astype(np.float32)
    shifts = tuple(hist_shift(float(max(np.abs(grad[k]).max(),
                                        np.abs(hess[k]).max())), n)
                   for k in range(K))
    return (*t, torch.from_numpy(grad).to(dev), torch.from_numpy(hess).to(dev),
            torch.from_numpy(cnt).to(dev), S, Bmax, shifts, True,
            scale_table(shifts, dev))


def sass_atomics(build) -> dict:
    """Atomic and CAS instructions in the SASS of each kernel function of
    each built library, counted by opcode, and each function's instruction
    count."""
    out = {}
    for name in LIBRARIES:
        path = build.library_path(name)
        text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                               str(path)], capture_output=True, text=True,
                              timeout=300).stdout
        per_fn = {}
        for chunk in text.split("Function : ")[1:]:
            fn = chunk.split()[0]
            ops = collections.Counter(
                m.group(1) for m in re.finditer(
                    r"\s((?:ATOMS|ATOMG|ATOM|RED|REDG|REDUX)\.[A-Z0-9_.]+)",
                    chunk))
            per_fn[fn] = {"instructions": len(re.findall(
                r"^\s+/\*[0-9a-f]{4}\*/", chunk, re.M)),
                **dict(sorted(ops.items()))}
        out[name] = per_fn
    return out


def profile_split(torch, fn, reps=5):
    """Device time of ``reps`` calls of ``fn`` by CUDA kernel and memset
    (``torch.profiler`` ``key_averages``), and the device operations of the
    last call in the order they ran, each with its microseconds."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if dev_us > 0:
            by_name.append({"name": ev.key[:80], "count": ev.count,
                            "device_us_total": dev_us})
    seq = sorted((ev.time_range.start, ev.name[:60],
                  ev.time_range.elapsed_us()) for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
    per_call = len(seq) // reps if reps else 0
    return {"by_name": by_name,
            "last_call_in_order": [[n, us] for _, n, us in
                                   seq[len(seq) - per_call:]]}


def time_shapes(torch, cs, emit, families):
    from lightgbm_torch.kernels import hist_wide as hw, route_hist as rh
    from lightgbm_torch.kernels import scatter_hist as sh
    shapes = []
    if "k58" in families:
        shapes += ([("scatter_hist", ROWS, GROUPS, 0, S, B)
                    for B in (63, 255) for S in (1, 16, 64)]
                   + [("hist_wide", ROWS_K, GROUPS, CLASSES, S, B)
                      for B in (63, 255) for S in (1, 16, 64)])
    if "k2" in families:
        shapes += [(name, ROWS if K == 1 else ROWS_K, GROUPS, K, S, B)
                   for name in ("route_and_hist", "route_and_hist_int")
                   for K in (1, CLASSES) for B in (63, 255)
                   for S in (1, 16, 64)]
    for i, (name, n, G, K, S, Bmax) in enumerate(shapes):
        int_form = name == "route_and_hist_int"
        if name in ("route_and_hist", "route_and_hist_int"):
            a = make_k2_inputs(torch, n, G, K, S, Bmax, i, int_form)
            kernel, plain = ((rh.route_and_hist_int_cuda,
                              rh.route_and_hist_int_plain) if int_form else
                             (rh.route_and_hist_cuda,
                              rh.route_and_hist_plain))
        else:
            (bins, slot, grad, hess, cnt), shifts = make_inputs(
                torch, n, G, K, S, Bmax, seed=i)
            if name == "scatter_hist":
                a = (bins, slot, grad, hess, cnt, S, Bmax, shifts[0])
                kernel, plain = sh.scatter_hist_cuda, sh.scatter_hist_plain
            else:
                a = (bins, slot, grad, hess, cnt, S, Bmax, shifts)
                kernel, plain = hw.hist_wide_cuda, hw.hist_wide_plain
        want = plain(*a)
        out = kernel(*a)
        torch.cuda.synchronize()
        if name.startswith("route_and_hist"):
            same = all(torch.equal(x, y) for x, y in zip(out, want))
        else:
            same = torch.equal(out, want)
        row = {"kernel": name, "rows": n, "groups": G, "classes": max(K, 1),
               "slots": S, "max_bins": Bmax, "bit_equal": bool(same),
               "ms": cs.device_ms(lambda: kernel(*a))}
        if name.startswith("route_and_hist"):
            acc, cell, vals = cs.k2k_index_add_inputs(a)
            work = cs.k2_work(a, out, int_form)
        else:
            acc, cell, vals = cs.index_add_inputs(name, a)
            work = cs.hist_work(name, a, out)
        row["index_add_ms"] = cs.device_ms(lambda: acc.index_add_(0, cell,
                                                                  vals))
        del acc, cell, vals
        row["bound_ms"], row["bound_by"] = cs.bound(*work)
        emit(row)
        del want, out, a
        torch.cuda.empty_cache()


def make_sorted_inputs(torch, n, G, S, Bmax, seed):
    """Seeded arguments of one K6 or K7 launch on the card: (N, G)
    row-major bins, the slot-sorted block plan of half the rows in S slots
    (S = 1: the root's plan of every row), the weights of make_inputs."""
    from lightgbm_torch.ops.compact import plan_blocks, plan_single_slot
    from lightgbm_torch.ops.histogram import hist_shift
    rs = np.random.RandomState(seed)
    dev = torch.device("cuda")
    bins = torch.from_numpy(rs.randint(0, Bmax, size=(n, G))
                            .astype(np.uint8)).to(dev)
    grad = rs.randn(n).astype(np.float32)
    hess = rs.uniform(0.05, 0.25, size=n).astype(np.float32)
    shift = hist_shift(float(max(np.abs(grad).max(), hess.max())), n)
    if S == 1:
        plan = plan_single_slot(n, BLOCK_ROWS, dev)
    else:
        slot = np.where(rs.rand(n) < 0.5, rs.randint(0, S, size=n),
                        -1).astype(np.int32)
        plan = plan_blocks(torch.from_numpy(slot).to(dev), S, BLOCK_ROWS)
    return (bins, plan.gather_idx, plan.scalars,
            torch.from_numpy(grad).to(dev), torch.from_numpy(hess).to(dev),
            torch.ones(n, dtype=torch.float32, device=dev), S, Bmax, shift,
            BLOCK_ROWS)


def sorted_under(torch, hs, name, a, plan):
    """One K6 or K7 launch (``name``) over make_sorted_inputs' arguments
    ``a`` under ``plan``, through the library's C entry point (the wrapper
    always launches ``sorted_plan``'s)."""
    from lightgbm_torch.kernels import build
    bins, gather_idx, scalars, grad, hess, cnt, S, Bmax, shift, T = a
    n, G = bins.shape
    hist = torch.empty((S, G, Bmax, 3), dtype=torch.float32,
                       device=bins.device)
    acc = torch.empty(hist.shape, dtype=torch.int64, device=bins.device)
    fn = getattr(build.load(name), build.SIGNATURES[name][0])
    rc = fn(bins.data_ptr(), n, G, gather_idx.data_ptr(), scalars.data_ptr(),
            scalars.shape[0], T, grad.data_ptr(), hess.data_ptr(),
            cnt.data_ptr(), S, Bmax, float(2.0 ** shift),
            float(2.0 ** -shift), acc.data_ptr(), hist.data_ptr(),
            hs.plan_arg(plan),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name} under plan {tuple(plan)}: "
                           f"cudaError {rc}")
    return hist


def plan_sweep(torch, cs, hs, name, a, want, variants):
    """Device time and bit equality of one K6 or K7 launch under each
    (label, plan) of ``variants``."""
    out = {}
    for label, p in variants:
        same = torch.equal(sorted_under(torch, hs, name, a, p), want)
        out[label] = [cs.device_ms(lambda: sorted_under(torch, hs, name, a,
                                                        p)), bool(same)]
    return out


def time_sorted(torch, cs, emit):
    """K6 at Bmax 63 and K7 at Bmax 255, S = 1, 16 and 64, each beside one
    float32 ``index_add_`` and its bound; K6 also under other plans."""
    from lightgbm_torch.kernels import hist_sorted as hs
    for i, (name, Bmax, S) in enumerate(
            (name, B, S) for name, B in (("hist_direct", 63),
                                         ("hist_nibble", 255))
            for S in (1, 16, 64)):
        a = make_sorted_inputs(torch, ROWS, GROUPS, S, Bmax, 200 + i)
        kernel = (hs.hist_direct_cuda if name == "hist_direct"
                  else hs.hist_nibble_cuda)
        want = hs.hist_sorted_plain(*a)
        out = kernel(*a)
        torch.cuda.synchronize()
        NB = a[2].shape[0]
        row = {"kernel": name, "rows": ROWS, "groups": GROUPS, "slots": S,
               "max_bins": Bmax, "plan_blocks": NB,
               "bit_equal": bool(torch.equal(out, want)),
               "ms": cs.device_ms(lambda: kernel(*a))}
        acc, cell, vals = cs.index_add_inputs(name, a)
        row["index_add_ms"] = cs.device_ms(lambda: acc.index_add_(0, cell,
                                                                  vals))
        del acc, cell, vals
        row["bound_ms"], row["bound_by"] = cs.bound(*cs.hist_work(name, a,
                                                                  out))
        if name == "hist_direct" and hasattr(hs, "sorted_plan"):
            # a checkout whose K6 takes a launch plan
            base = hs.sorted_plan(NB, BLOCK_ROWS, S, GROUPS, Bmax)
            row["plan"] = list(base)
            row["plans_ms"] = plan_sweep(torch, cs, hs, name, a, want, [
                (f"{threads}x{per_range}",
                 base._replace(threads=threads, blocks_per_range=per_range,
                               ranges=-(-NB // per_range)))
                for threads, per_range in itertools.product((128, 256, 512),
                                                            (1, 2, 3))])
        if name == "hist_nibble" and hasattr(hs, "NIBBLE_GROUPS"):
            # a checkout whose K7 takes a launch plan: groups a tile x
            # threads x plan blocks a range ("w": the plan's own, waves of
            # blocks over the card)
            base = hs.sorted_plan(NB, BLOCK_ROWS, S, GROUPS, Bmax)
            row["plan"] = list(base)
            variants = []
            for gpt, threads in itertools.product((28, 16, 12, 8, 4),
                                                  (256, 512, 1024)):
                p = hs._sorted_plan(NB, BLOCK_ROWS, S, GROUPS, Bmax,
                                    gpt * Bmax * hs.CELL_BYTES, threads,
                                    1 if S == 1 else 2, gpt)
                variants.append((f"{gpt}g_{threads}t_w{p.blocks_per_range}",
                                 p))
                for per_range in (1, 2, 3, 4, 6, 8, 12):
                    variants.append((f"{gpt}g_{threads}t_{per_range}",
                                     p._replace(blocks_per_range=per_range,
                                                ranges=-(-NB // per_range))))
            row["plans_ms"] = plan_sweep(torch, cs, hs, name, a, want,
                                         variants)
        emit(row)
        del a, want, out
        torch.cuda.empty_cache()


def own_chip_smoke():
    """This checkout's chip_smoke.py (the input generators), whichever
    checkout ``--root`` times."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bench", Path(__file__).resolve().parents[1] /
        "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def replay_under(torch, rr, bins_T, tabs, plan):
    """One K3 launch under ``plan``, through the library's C entry point
    (the wrapper always launches ``replay_plan``'s)."""
    from lightgbm_torch.kernels import build
    G, n = bins_T.shape
    R, L = tabs.shape[0], tabs.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=bins_T.device)
    packed = torch.empty((max(R * (L + 1), 1), 2), dtype=torch.int32,
                         device=bins_T.device)
    rc = build.load("route_replay").lgbt_route_replay(
        bins_T.data_ptr(), n, G, tabs.data_ptr(), R, L, packed.data_ptr(),
        out.data_ptr(), rr.plan_arg(plan),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"route_replay under plan {tuple(plan)}: "
                           f"cudaError {rc}")
    return out


def cold_ms(torch, fn, reps=10):
    """Device milliseconds of one call of ``fn`` that finds the L2 cache
    cold: each call follows a 128 MB write (more than the 50 MB L2), CUDA
    events around the call alone, everything queued behind a spin kernel
    so that the host's enqueue leaves no gap; the median over ``reps``."""
    import statistics
    import time
    flush = torch.empty(32 * 2 ** 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush.zero_()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int((2 * reps * host_s + 2e-3) * 2e9))
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in ev)


def sampled_tree_k3(torch, cs):
    """The K3 launch of one sampled tree of phase train_sampled's run (GOSS
    at LightGBM's default rates on 1M HIGGS-shaped rows, 255 leaves; the
    12th tree, after 10 warmup trees): its (bins_T, tabs)."""
    import lightgbm_torch as lt
    own = own_chip_smoke()
    X, y = own.make_higgs_like(ROWS, GROUPS, 0)
    ds = lt.Dataset(X, label=y, params={"max_bin": 63}).construct()
    del X
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "data_sample_strategy": "goss",
              "top_rate": 0.2, "other_rate": 0.1, "feature_fraction": 0.8,
              "verbosity": -1}
    with cs.TimedIters(capture_at=11) as t:
        lt.train(params, ds, 12)
    (bins_T, tabs), _ = t.cap.k3[0]
    return bins_T, tabs


def time_replay(torch, cs, emit):
    """K3 on one sampled tree's launch (``sampled_tree_k3``, the main path's
    data) and over 1M rows x 28 groups of 255 bins at R = 1, 5 and 9 rounds
    of L = 31 and 255 leaves (``chip_smoke.k3_records``: grown trees,
    numeric splits without missing bins), beside its bound
    (``chip_smoke.k3_work``) and the plain version, with the L2 cache warm
    (``device_ms``: launches back to back) and cold (``cold_ms``); in a
    checkout whose K3 takes a launch plan, also under other plans (the
    packed table in global memory, threads x rows a thread), and one launch
    split by kernel (``torch.profiler``)."""
    from lightgbm_torch.kernels import route_replay as rr
    own = own_chip_smoke()
    dev = torch.device("cuda")
    cases = [("sampled_tree",) + sampled_tree_k3(torch, cs)]
    for i, (R, L) in enumerate(itertools.product((1, 5, 9), (31, 255))):
        rs = np.random.RandomState(400 + i)
        tabs = torch.from_numpy(own.k3_records(rs, R, L, GROUPS, 255)).to(
            dev)
        bins_T = torch.from_numpy(rs.randint(0, 255, size=(GROUPS, ROWS))
                                  .astype(np.uint8)).to(dev)
        cases.append((f"R{R}_L{L}", bins_T, tabs))
    for label, bins_T, tabs in cases:
        G, n = bins_T.shape
        R, L = tabs.shape[0], tabs.shape[1]
        want = rr.route_replay_plain(bins_T, tabs)
        out = rr.route_replay_cuda(bins_T, tabs)
        torch.cuda.synchronize()
        row = {"kernel": "route_replay", "case": label, "rows": n,
               "groups": G, "rounds": R, "num_leaves": L,
               "leaves_reached": int(torch.unique(want).numel()),
               "bit_equal": bool(torch.equal(out, want)),
               "ms": cs.device_ms(lambda: rr.route_replay_cuda(bins_T,
                                                               tabs)),
               "cold_ms": cold_ms(torch, lambda: rr.route_replay_cuda(
                   bins_T, tabs)),
               "plain_ms": cs.cuda_ms(lambda: rr.route_replay_plain(
                   bins_T, tabs), reps=1, warmup=0)}
        row["bound_ms"], row["bound_by"] = cs.bound(*cs.k3_work(bins_T,
                                                                tabs))
        if hasattr(rr, "replay_plan"):
            base = rr.replay_plan(n, G, R, L)
            row["plan"] = list(base)
            variants = [("global_table", dict(stage_tab=False))]
            variants += [(f"{t}t_{k}r", dict(threads=t, rows_per_thread=k))
                         for t, k in ((128, 4), (256, 2), (256, 3),
                                      (512, 2), (512, 4))]
            row["plans_ms"] = {}
            for name, kw in variants:
                kw = {"threads": 256, "rows_per_thread": rr.ROWS_PER_THREAD,
                      **kw}
                p = rr._replay_plan(n, G, R, L, rr.SMEM_BLOCK, **kw)
                same = torch.equal(replay_under(torch, rr, bins_T, tabs, p),
                                   want)
                row["plans_ms"][name] = [
                    cs.device_ms(lambda: replay_under(torch, rr, bins_T,
                                                      tabs, p)),
                    bool(same), list(p),
                    cold_ms(torch, lambda: replay_under(torch, rr, bins_T,
                                                        tabs, p))]
            row["profile_5_launches"] = profile_split(
                torch, lambda: rr.route_replay_cuda(bins_T, tabs))
        emit(row)
        del want, out
        torch.cuda.empty_cache()
    del cases


def k1_inputs(torch, cs, T, L, seed):
    """Seeded K1 operands: T synthetic numeric trees of L leaves
    (``chip_smoke.k1_records``, thresholds among the bins' 64 values),
    (G, N) bins of 64 values, leaf values in +-0.1; and each leaf's depth
    as a table of the leaf values' shape."""
    from lightgbm_torch.kernels import predict as tpk
    rs = np.random.RandomState(seed)
    rec, depths = cs.k1_records(rs, T, L, GROUPS, [], max_bin=64)
    dev = torch.device("cuda")
    bins_T = torch.from_numpy(rs.randint(0, 64, size=(GROUPS, ROWS))
                              .astype(np.uint8)).to(dev)
    lv = torch.from_numpy(rs.uniform(-0.1, 0.1, size=(T, L))
                          .astype(np.float32)).to(dev)
    leaf_depth = np.zeros((T, L), np.float32)
    for t in range(T):
        # a leaf's depth: one more than its parent node's
        node_depth = np.zeros(L, np.int64)
        for s in range(L - 1):
            for c in rec[t, s, [tpk.F_LEFT, tpk.F_RIGHT]]:
                if c >= L:
                    leaf_depth[t, c - L] = node_depth[s] + 1
                else:
                    node_depth[c] = node_depth[s] + 1
    nodes = torch.from_numpy(tpk.pack_nodes(rec)).to(dev)
    words = torch.zeros(1, dtype=torch.int32, device=dev)
    return (bins_T, nodes, lv, words, max(depths),
            torch.from_numpy(leaf_depth).to(dev))


def time_predict(torch, cs, emit):
    """K1 on synthetic numeric trees: 100 and 500 trees of 31 and 255
    leaves over 1M rows; the visits come from the kernel summing each
    leaf's depth (float32 sums of integers below 2**24 are exact)."""
    from lightgbm_torch.kernels import predict as tpk
    if not hasattr(tpk, "pack_nodes"):
        emit({"kernel": "predict_stream", "skipped": "this checkout's K1 "
              "reads 16-field records; chip_smoke.py times it"})
        return
    for i, (T, L) in enumerate(itertools.product((100, 500), (31, 255))):
        bins_T, nodes, lv, words, maxd, leaf_depth = k1_inputs(
            torch, cs, T, L, 300 + i)
        ms = cs.device_ms(lambda: tpk.predict_stream_cuda(
            bins_T, nodes, lv, words, maxd), reps=5)
        visits = float(tpk.predict_stream_cuda(
            bins_T, nodes, leaf_depth, words, maxd).double().sum().item())
        plan = tpk.predict_plan(ROWS, GROUPS, L, T)
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (bins_T, nodes, lv, words)) + 4 * ROWS
        # numeric nodes without missing bins: 4 operations a visit, one add
        # a row and tree
        bound = cs.bound(n_bytes, 4 * visits + ROWS * T)
        lane_eff = cs.walk_lane_efficiency(bins_T, nodes, leaf_depth, words,
                                           maxd, plan.rows_per_tile)
        emit({"kernel": "predict_stream", "rows": ROWS, "groups": GROUPS,
              "trees": T, "num_leaves": L, "max_depth": maxd, "ms": ms,
              "plan": plan._asdict(), "node_visits": visits,
              "walk_lane_efficiency": lane_eff,
              "stage_copy_bytes": plan.tiles * T * tpk.STAGE_NODE_BYTES * L
              + GROUPS * ROWS, "bound_ms": bound[0], "bound_by": bound[1]})
        del bins_T, nodes, lv, words, leaf_depth
        torch.cuda.empty_cache()


def per_warp(torch, x, ignore=None):
    """Mean over the warps (32 consecutive rows) of the number of distinct
    values of ``x`` in a warp and of the most rows sharing one value, rows
    whose value is ``ignore`` left out."""
    n = x.numel()
    w = torch.full((-(-n // 32) * 32,), -(2 ** 40), dtype=torch.int64,
                   device=x.device)
    w[:n] = x.long()
    if ignore is not None:
        w[:n][x == ignore] = -(2 ** 40)
    w = w.view(-1, 32).sort(dim=1).values
    valid = w > -(2 ** 40)
    new = torch.ones_like(valid)
    new[:, 1:] = w[:, 1:] != w[:, :-1]
    distinct = (new & valid).sum(dim=1)
    # run lengths: a run starts where ``new`` is set
    idx = torch.arange(32, device=x.device).expand_as(w)
    start = torch.where(new, idx, torch.zeros_like(idx)).cummax(dim=1).values
    run = torch.where(valid, idx - start + 1, torch.zeros_like(idx))
    return (float(distinct.float().mean()),
            float(run.max(dim=1).values.float().mean()))


def route_probe(torch, cs, emit):
    """The route-only K2 launch of a float tree and of a quantized tree
    (the third of 3 binary trees on 1M rows each), each timed through the
    float form and the int form of K2 (a route-only launch reads no
    weights), with ``device_ms``, with CUDA events around one call from an
    idle device, and split by ``torch.profiler``; and what the launch's
    data hold."""
    import lightgbm_torch as lt
    from lightgbm_torch.kernels import layout as tl, route_hist as rh
    from lightgbm_torch.ops.histogram import scale_table

    X, y = cs.make_higgs_like(ROWS, GROUPS, 0)
    ds = lt.Dataset(X, label=y, params={"max_bin": 63}).construct()
    del X
    base = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
            "learning_rate": 0.1, "verbosity": -1}
    launches = {}
    for tree, extra in (("float_tree", {}),
                        ("quantized_tree", {"use_quantized_grad": True})):
        with cs.TimedIters(capture_at=2) as t:
            lt.train({**base, **extra}, ds, 3)
        if tree == "float_tree":
            launches[tree] = [a for a, _ in t.cap.k2 if not a[10]]
        else:
            launches[tree] = [a for a, _ in t.cap.k2i if not a[9]]
    for tree, items in launches.items():
        for i, a in enumerate(items):
            bins_T, lid, tabs, words = a[:4]
            cnt, S, Bmax = a[6], a[7], a[8]
            K, n = lid.shape
            zeros = torch.zeros((K, n), dtype=torch.float32,
                                device=lid.device)
            shifts = (0,) * K
            as_float = (bins_T, lid, tabs, words, zeros, zeros, cnt, S, Bmax,
                        shifts, False, scale_table(shifts, lid.device))
            as_int = (bins_T, lid, tabs, words, None, None, cnt, S, Bmax,
                      False)
            new_leaf, slot = rh.route_plain(bins_T, lid[0], tabs[0],
                                            words[0])
            rec = tabs[0][lid[0].long()]
            in_slot = slot[(slot >= 0) & (cnt > 0)]
            per_slot = torch.bincount(in_slot.long(), minlength=S)
            row = {"probe": tree, "launch": i, "rows": n, "classes": K,
                   "leaves": tabs.shape[1], "slots": S, "max_bins": Bmax,
                   "cat_words": words.shape[2],
                   "leaves_split": int((tabs[0][:, tl.R_CHOSEN] > 0).sum()),
                   "rows_routed": int((rec[:, tl.R_CHOSEN] > 0).sum()),
                   "rows_in_a_slot": int(in_slot.numel()),
                   "slots_used": int((per_slot > 0).sum()),
                   "most_rows_in_one_slot": int(per_slot.max())
                   if S else 0,
                   "lid_contiguous": bool(lid.is_contiguous()),
                   "cnt_ptr_mod_256": int(cnt.data_ptr() % 256)}
            routed = rec[:, tl.R_CHOSEN] > 0
            groups = torch.where(routed, rec[:, tl.R_GROUP], -1)
            slot_w = torch.where(cnt > 0, slot, -1)
            row["per_warp_distinct_leaves"], _ = per_warp(torch, lid[0])
            row["per_warp_distinct_groups_read"], _ = per_warp(
                torch, groups, ignore=-1)
            (row["per_warp_distinct_slots"],
             row["per_warp_most_count_adds_to_one_slot"]) = per_warp(
                torch, torch.where(slot_w >= 0, slot_w, -1), ignore=-1)
            for form, fn in (("float_form", lambda: rh.route_and_hist_cuda(
                                 *as_float)),
                             ("int_form", lambda: rh.route_and_hist_int_cuda(
                                 *as_int))):
                row[form] = {"device_ms": cs.device_ms(fn),
                             "event_ms_one_call": cs.cuda_ms(fn, reps=20),
                             "profile": profile_split(torch, fn)}
            emit(row)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--only", choices=("k58", "k2", "k67", "k1", "k3"),
                    default=None)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--route-probe", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_hist_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from lightgbm_torch.kernels import build, hist_wide as hw
    from lightgbm_torch.kernels import route_hist as rh

    def emit(obj):
        print(json.dumps({"label": args.label, **obj}), flush=True)

    emit({"card": cs.nvidia_smi_line(), "root": args.root,
          "built_s": build.build(list(LIBRARIES)),
          "ptxas": {name: [ln.strip() for ln in
                           (build.BUILD_DIR / f"{name}.log").read_text()
                           .splitlines() if "registers" in ln
                           or "spill" in ln or "Compiling entry" in ln]
                    for name in LIBRARIES
                    if (build.BUILD_DIR / f"{name}.log").exists()}})
    if args.sass:
        emit({"sass_atomics": sass_atomics(build)})
    families = (("k58", "k2", "k67", "k1", "k3") if args.only is None
                else (args.only,))
    time_shapes(torch, cs, emit, families)
    if "k67" in families:
        time_sorted(torch, cs, emit)
    if "k1" in families:
        time_predict(torch, cs, emit)
    if "k3" in families:
        time_replay(torch, cs, emit)
    if args.sass:
        # one launch of each at K = 10, S = 64, Bmax 63 under
        # torch.profiler: device time by kernel and memset
        (bins, slot, grad, hess, cnt), shifts = make_inputs(
            torch, ROWS_K, GROUPS, CLASSES, 64, 63, seed=99)
        a = (bins, slot, grad, hess, cnt, 64, 63, shifts)
        emit({"profile_hist_wide_S64_B63_5_launches":
              profile_split(torch, lambda: hw.hist_wide_cuda(*a))})
        del a, bins, slot, grad, hess, cnt
        from lightgbm_torch.kernels import hist_sorted as hs
        from lightgbm_torch.kernels import predict as tpk
        a = make_sorted_inputs(torch, ROWS, GROUPS, 64, 63, 97)
        emit({"profile_hist_direct_S64_B63_5_launches":
              profile_split(torch, lambda: hs.hist_direct_cuda(*a))})
        if hasattr(tpk, "pack_nodes"):
            k1 = k1_inputs(torch, cs, 500, 255, 96)[:5]
            emit({"profile_predict_stream_T500_L255_5_launches":
                  profile_split(torch,
                                lambda: tpk.predict_stream_cuda(*k1))})
            del k1
        del a
        for (K, S), (int_form, fn) in itertools.product(
                ((CLASSES, 64), (CLASSES, 1), (1, 1)),
                ((False, rh.route_and_hist_cuda),
                 (True, rh.route_and_hist_int_cuda))):
            a = make_k2_inputs(torch, ROWS_K if K > 1 else ROWS, GROUPS, K,
                               S, 63, 98, int_form)
            key = "route_and_hist_int" if int_form else "route_and_hist"
            emit({f"profile_{key}_K{K}_S{S}_B63_5_launches":
                  profile_split(torch, lambda: fn(*a))})
            del a
    if args.route_probe:
        route_probe(torch, cs, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
