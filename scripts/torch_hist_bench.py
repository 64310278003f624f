#!/usr/bin/env python3
"""Time the port's two row-order histogram kernels, K5 ``scatter_hist`` and
K8 ``hist_wide``, on one NVIDIA GPU at the training path's shapes.

    python3 scripts/torch_hist_bench.py [--root DIR] [--sass] [--label TEXT]

``--root`` is the checkout whose ``lightgbm_torch`` is measured (default:
this repository), so a parent commit unpacked with ``git archive`` can be
timed in the same call.  Inputs are synthetic and seeded: 1M rows (K8:
900 000 rows x 10 classes) x 28 groups of uniform bins, N(0, 1) gradients,
hessians in [0.05, 0.25], count weights 1; a root round (every row in slot
0) and rounds of S slots that hold half the rows, drawn at random in their
natural order.  Each shape prints one JSON line: the kernel's device time
(``chip_smoke.device_ms``), one float32 ``index_add_`` over the same (row,
class, group) triples, the bytes bound (``chip_smoke.hist_work``), and
whether the kernel equals its plain version bit for bit.  ``--sass`` prints
the atomic instructions of the built libraries (``cuobjdump -sass``) and
the device time of one K8 launch by CUDA kernel (``torch.profiler``).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROWS, ROWS_K, GROUPS, CLASSES = 1_000_000, 900_000, 28, 10


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


def sass_atomics(build) -> dict:
    """Atomic and CAS instructions in each built library's SASS, counted by
    opcode."""
    out = {}
    for name in ("scatter_hist", "hist_wide"):
        path = build.library_path(name)
        text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                               str(path)], capture_output=True, text=True,
                              timeout=300).stdout
        ops = collections.Counter(
            m.group(1) for m in re.finditer(
                r"\s((?:ATOMS|ATOMG|ATOM|RED|REDG|REDUX)\.[A-Z0-9_.]+)",
                text))
        out[name] = dict(sorted(ops.items()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_hist_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from lightgbm_torch.kernels import build, hist_wide as hw
    from lightgbm_torch.kernels import scatter_hist as sh

    def emit(obj):
        print(json.dumps({"label": args.label, **obj}), flush=True)

    emit({"card": cs.nvidia_smi_line(), "root": args.root,
          "built_s": build.build(["scatter_hist", "hist_wide"]),
          "ptxas": [ln.strip() for ln in
                    (build.BUILD_DIR / "hist_wide.log").read_text()
                    .splitlines() if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]})
    if args.sass:
        emit({"sass_atomics": sass_atomics(build)})
    shapes = ([("scatter_hist", ROWS, GROUPS, 0, S, B)
               for B in (63, 255) for S in (1, 16, 64)]
              + [("hist_wide", ROWS_K, GROUPS, CLASSES, S, B)
                 for B in (63, 255) for S in (1, 16, 64)])
    for i, (name, n, G, K, S, Bmax) in enumerate(shapes):
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
        row = {"kernel": name, "rows": n, "groups": G, "classes": max(K, 1),
               "slots": S, "max_bins": Bmax,
               "bit_equal": bool(torch.equal(out, want)),
               "ms": cs.device_ms(lambda: kernel(*a))}
        acc, cell, vals = cs.index_add_inputs(name, a)
        row["index_add_ms"] = cs.device_ms(lambda: acc.index_add_(0, cell,
                                                                  vals))
        del acc, cell, vals
        row["bound_ms"], row["bound_by"] = cs.bound(*cs.hist_work(name, a,
                                                                  out))
        emit(row)
        del want, out, a, bins, slot, grad, hess, cnt
        torch.cuda.empty_cache()
    if not args.sass:
        return 0
    # one K8 launch at S = 64 under torch.profiler: device time by kernel
    (bins, slot, grad, hess, cnt), shifts = make_inputs(
        torch, ROWS_K, GROUPS, CLASSES, 64, 63, seed=99)
    a = (bins, slot, grad, hess, cnt, 64, 63, shifts)
    hw.hist_wide_cuda(*a)
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(5):
            hw.hist_wide_cuda(*a)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": ev.key[:80], "count": ev.count,
                         "device_us_total": dev_us})
    emit({"profile_hist_wide_S64_B63_5_launches": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
