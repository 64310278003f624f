#!/usr/bin/env python3
"""Time the port's TreeSHAP kernel ``tree_shap`` and its binning kernels
``bin_rows`` and ``bin_csr`` on one NVIDIA GPU at their main paths' shapes.

    python3 scripts/torch_shap_bin_bench.py [--root DIR] [--model PATH]
                                            [--label TEXT] [--sweep]
                                            [--only ARM ...]

``--root`` is the checkout whose ``lightgbm_torch`` is measured (default:
this repository), so a parent commit unpacked with ``git archive`` can be
timed in the same call on the same inputs.  Inputs are seeded and made by
this checkout's ``chip_smoke.py``:

- ``tree_shap``: the model at ``--model`` (written first, by the root
  measured, if the file is missing: 20 binary trees of 255 leaves trained
  as ``chip_smoke.py``'s Train cell trains them, on 1M
  ``make_higgs_like`` rows at max_bin 63) over 100 000 and 10 000 other
  rows of ``make_higgs_like``: the kernel's device time
  (``chip_smoke.device_ms``) and its launch plan where the root has one;
- ``bin_rows``: phase full's predict form (1M x 28 rows of
  ``make_higgs_like``, the mappers of a 1M-row Dataset at max_bin 63, the
  transposed uint8 output) and one 49 784-row chunk of a Flight-Delay-
  shaped Dataset (``make_airline_onehot``, 674 columns in 8 groups, max_bin
  255, 16-bit (N, G) bins): its device time and its plan;
- ``bin_csr``: the Allstate-shaped cell of ``chip_smoke.py`` phase
  train_sparse (``make_allstate_like``, 1.25M rows, the mappers and EFB
  groups of a Dataset of the first 1M): one 100 000-row chunk of the
  Dataset's rows, (N, G), and the predict form ((G, N)) of the 250 000
  held-out rows: its device time, bound (``chip_smoke.bin_csr_work``) and
  plan where the root has one.

Every timed output is first held to the root's plain version (``bin_rows``,
``bin_csr``: byte for byte; ``tree_shap``: within 1e-10 of each row's
scale).  Prints one JSON line with the root, the card (``nvidia-smi``) and
the times.  ``--ablate`` also times ``bin_csr`` built without one part of
its work each, or with the feature fields read as before the compact
records (``CSR_ABLATIONS``: those records, the row search, the atomic,
the record loads, the entries, the entries and the write-out; the bins of
all but the first are wrong, only their times are read).  ``--only`` names the arms to run (``tree_shap``, ``bin_rows``,
``bin_csr``; default all; ``--model`` is needed for ``tree_shap``).
``--sweep`` (a root with this checkout's plans) also times each kernel
under other plans, set through the plan modules' constants:
``tree_shap`` with its decision words or its accumulators out of shared
memory and with 2, 8 and 16 blocks an SM before trees are grouped;
``bin_rows`` at 2, 3, 4, 6 and 8 blocks an SM with tiles of 4-64 KB and
with the tables in global memory; ``bin_csr`` at 2, 3, 4, 6 and 8 blocks
an SM x tiles of at most 1 024-16 384 entries, and at 4 and 6 blocks x
2 048 and 4 096 entries without the records' inline first bounds.  Needs
a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SHAP_ROWS = (100_000, 10_000)
WIDE_CHUNK_ROWS = 49_784
# the Allstate-shaped cell: training rows, held-out rows, the Dataset chunk
CSR_ROWS, CSR_HELD_OUT, CSR_CHUNK_ROWS = 1_000_000, 250_000, 100_000
ARMS = ("tree_shap", "bin_rows", "bin_csr")


def own_chip_smoke():
    """This checkout's chip_smoke.py (the input generators and timers),
    whichever checkout ``--root`` times."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bench", Path(__file__).resolve().parents[1] /
        "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plan_of(mod, name, *args):
    """The root's launch plan, where it has the function."""
    fn = getattr(mod, name, None)
    return list(fn(*args)) if fn is not None else None


SHAP_SWEEP = (("device_decisions", {"DEC_BYTES": 0}),
              ("device_acc", {"ACC_BYTES": 0}),
              ("blocks_per_sm_2", {"BLOCKS_PER_SM": 2}),
              ("blocks_per_sm_8", {"BLOCKS_PER_SM": 8}),
              ("blocks_per_sm_16", {"BLOCKS_PER_SM": 16}))
# (label, blocks an SM, bytes of a tile's rows, tables in shared memory)
BIN_SWEEP = tuple((f"{b}x{k}k{'' if t else '_global_tables'}", b, k << 10, t)
                  for b, k, t in ((2, 32, True), (2, 64, True),
                                  (2, 32, False), (3, 16, True),
                                  (3, 24, True), (4, 12, True),
                                  (4, 16, False), (4, 8, True), (6, 8, True),
                                  (8, 4, True)))


class patched:
    """Module constants set for the duration of a ``with``."""

    def __init__(self, mod, values):
        self.mod, self.values = mod, values

    def __enter__(self):
        self.old = {k: getattr(self.mod, k) for k in self.values}
        for k, v in self.values.items():
            setattr(self.mod, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.mod, k, v)


def time_tree_shap(cs, torch, model_path, sweep=False):
    import lightgbm_torch as lt
    from lightgbm_torch import shap as tshap
    from lightgbm_torch.kernels import tree_shap as kts

    if not Path(model_path).exists():
        X, y = cs.make_higgs_like(1_000_000, 28, 0)
        params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
                  "learning_rate": 0.1, "verbosity": -1}
        bst = lt.train(params, lt.Dataset(X, label=y, params=dict(params)),
                       20)
        bst.save_model(model_path)
    bst = lt.Booster(model_file=str(model_path))
    use = bst._all_trees()
    depth = tshap.device_depth(use)
    Xh, _ = cs.make_higgs_like(max(SHAP_ROWS), 28, 1)
    out = {"trees": len(use), "max_raw_depth": depth}
    for n in SHAP_ROWS:
        X_T, tabs, host = cs.shap_inputs(use, Xh[:n], 1, depth,
                                         torch.device("cuda"))
        got = kts.tree_shap_cuda(X_T, tabs, 1)
        want = kts.tree_shap_plain(X_T, tabs, 1)
        g = got.reshape(n, -1).cpu().numpy()
        w = want.reshape(n, -1).cpu().numpy()
        if not (np.abs(g - w) <= 1e-10 * cs.row_scale(w)).all():
            raise RuntimeError(f"tree_shap differs from its plain version "
                               f"on {n} rows")
        T, L, D = host.feat.shape
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        shape = (n, T, sms, X_T.shape[0], L, D)
        entry = {"ms": cs.device_ms(lambda: kts.tree_shap_cuda(X_T, tabs, 1),
                                    reps=3),
                 "plan": plan_of(kts, "shap_plan", *shape)}
        for label, values in (SHAP_SWEEP if sweep else ()):
            with patched(kts, values):
                if not torch.equal(kts.tree_shap_cuda(X_T, tabs, 1), got):
                    raise RuntimeError(f"tree_shap under {label}: other "
                                       f"bytes")
                entry[label] = {
                    "ms": cs.device_ms(
                        lambda: kts.tree_shap_cuda(X_T, tabs, 1), reps=3),
                    "plan": plan_of(kts, "shap_plan", *shape)}
        out[f"rows_{n}"] = entry
    return out


def time_one_bin(cs, torch, br, mappers, groups, x, transpose, sweep=False):
    from lightgbm_torch.binning import device_group_order

    dev = torch.device("cuda")
    gs = device_group_order(groups, mappers)
    tables = br.bin_tables(mappers, gs, dev)
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float64)).to(dev)
    n = xd.shape[0]
    shape = (len(gs), n) if transpose else (n, len(gs))
    out = torch.empty(shape, dtype=br.storage_dtype(tables.out_bytes),
                      device=dev)
    want = torch.zeros_like(out)
    br.bin_rows_cuda(xd, tables, out, 0, transpose)
    br.bin_rows_plain(xd, tables, want, 0, transpose)
    if not torch.equal(out, want):
        raise RuntimeError("bin_rows differs from its plain version")
    plan = (list(br.launch_plan(xd, tables)) if hasattr(br, "launch_plan")
            else list(br.bin_plan(n, xd.shape[1])))
    res = {"rows": n, "features": int(xd.shape[1]), "groups": len(gs),
           "out_bytes": tables.out_bytes, "transpose": transpose,
           "plan": plan,
           "ms": cs.device_ms(lambda: br.bin_rows_cuda(xd, tables, out, 0,
                                                       transpose), reps=10)}
    for label, blocks, stage, staged_tables in (BIN_SWEEP if sweep else ()):
        values = {"BLOCKS_PER_SM": blocks, "STAGE_BYTES": stage,
                  "BLOCK_BYTES": br.SMEM_SM // blocks - 1024}
        tabs = tables if staged_tables else tables._replace(table_bytes=0)
        with patched(br, values):
            out.zero_()
            br.bin_rows_cuda(xd, tabs, out, 0, transpose)
            if not torch.equal(out, want):
                raise RuntimeError(f"bin_rows under {label}: other bytes")
            res[label] = {
                "plan": list(br.launch_plan(xd, tabs)),
                "ms": cs.device_ms(lambda: br.bin_rows_cuda(
                    xd, tabs, out, 0, transpose), reps=10)}
    return res


def time_bin_rows(cs, torch, sweep=False):
    import lightgbm_torch as lt
    from lightgbm_torch.kernels import bin_rows as br

    X, y = cs.make_higgs_like(1_000_000, 28, 0)
    params = {"max_bin": 63, "verbosity": -1}
    b = lt.Dataset(X, label=y, params=dict(params)).construct().binned
    Xp, _ = cs.make_higgs_like(1_000_000, 28, 1)
    full = time_one_bin(cs, torch, br, b.bin_mappers, b.group_features, Xp,
                        True, sweep)
    Xw, yw = cs.make_airline_onehot(WIDE_CHUNK_ROWS, 0)
    params = {"max_bin": 255, "verbosity": -1}
    b = lt.Dataset(Xw, label=yw, params=dict(params)).construct().binned
    wide = time_one_bin(cs, torch, br, b.bin_mappers, b.group_features, Xw,
                        False, sweep)
    return {"full_predict_b8": full, "flight_delay_b16": wide}


# (label, bin_csr's plan constants, first bounds inline in the records)
CSR_SWEEP = tuple(
    (f"{b}x{e}{'' if i else '_no_inline'}",
     {"BLOCKS_PER_SM": b, "TILE_ENTRIES": e}, i)
    for i, blocks, entries in (
        (True, (2, 3, 4, 5, 6, 8), (1024, 2048, 4096, 8192, 16384)),
        (False, (4, 6), (2048, 4096)))
    for b in blocks for e in entries)


# (label, text of csrc/bin_csr.cu, its replacement): builds of the kernel
# each without one part of its work, timed by --ablate (their bins are
# wrong where a part is missing)
CSR_ABLATIONS = (
    # the fields from col_entry and bin_rows' feature records, as before
    # the compact column records
    ("feature_records",
     "const int4 lo = __ldg(a.records + 2 * c);\n"
     "  const int4 hi = __ldg(a.records + 2 * c + 1);\n"
     "  const int32_t r[kRecFields] = {lo.x, lo.y, lo.z, lo.w,\n"
     "                                 hi.x, hi.y, hi.z, hi.w};\n"
     "  f[kColumn] = c;\n"
     "  f[kGroup] = r[kRecGroup];\n"
     "  f[kFlags] = r[kRecFlags];\n"
     "  f[kPosition] = r[kRecPosition];\n"
     "  f[kInGroup] = r[kRecInGroup];\n"
     "  f[kNumBins] = r[kRecNumBins];\n"
     "  f[kDefaultBin] = r[kRecDefaultBin];\n"
     "  f[kBoundsStart] = f[kCatsStart] = r[kRecStart];\n"
     "  f[kBoundsLen] = f[kCatsLen] = r[kRecLen];\n"
     "  return r[kRecGroup] >= 0;",
     "const int e = __ldg(a.tab.col_entry + c);\n"
     "  if (e < 0) return false;\n"
     "  const int32_t* g = a.tab.feats + static_cast<int64_t>(e) * "
     "kFeatFields;\n"
     "  for (int k = 0; k < kFeatFields; ++k) f[k] = __ldg(g + k);\n"
     "  return true;"),
    ("no_row_search", "const int r = lower_bound(offs, rows + 1, j + 1) - 1;",
     "const int r = min(j / 28, rows - 1);"),
    ("no_atomic", "atomicMax(keys + r * (gn | 1) + g, key);",
     "keys[r * (gn | 1) + g] = key;"),
    ("no_record_loads",
     "const int4 lo = __ldg(a.records + 2 * c);\n"
     "  const int4 hi = __ldg(a.records + 2 * c + 1);",
     "const int4 lo = make_int4(c % a.G, 16, 0, 1);\n"
     "  const int4 hi = make_int4(2, 0, __double2loint(0.5),\n"
     "                            __double2hiint(0.5));"),
    ("no_entries", "for (int j = threadIdx.x; j < ne; j += kThreads) {",
     "for (int j = threadIdx.x; j < 0; j += kThreads) {"),
    ("no_entries_no_write_out", "for (int j = threadIdx.x; j < ne; "
     "j += kThreads) {\n", "for (int j = threadIdx.x; j < 0; "
     "j += kThreads) {\n"),
)


def ablated_libraries(build, root):
    """CSR_ABLATIONS built from the root's csrc/bin_csr.cu (all nvcc
    processes at once) into the root's ``lightgbm_torch/_build/ablate``,
    as {label: path}."""
    csrc = Path(root).resolve() / "lightgbm_torch" / "kernels" / "csrc"
    src = (csrc / "bin_csr.cu").read_text()
    out = csrc.parents[1] / "_build" / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, old, new in CSR_ABLATIONS:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation {label}: its text is not in the "
                               f"source once")
        text = src.replace(old, new)
        if label == "no_entries_no_write_out":
            text = text.replace("    write_tile<T>(a, out, keys, cur);\n",
                                "")
        path, tmp = out / f"{label}.cu", out / f"{label}.cu.tmp"
        tmp.write_text(text.replace('#include "bin_value.cuh"',
                                    f'#include "{csrc}/bin_value.cuh"'))
        os.replace(tmp, path)
        lib = out / f"lib{label}.so"
        procs[label] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT), lib)
    for label, (proc, lib) in procs.items():
        if proc.wait():
            raise RuntimeError(f"ablation {label} did not build")
    return {label: lib for label, (_, lib) in procs.items()}


def time_one_csr(cs, torch, bc, tables, X, transpose, sweep=False,
                 ablated=None):
    """One bin_csr launch over the CSR rows X: byte-equal to the root's
    plain version, timed under the root's plan (and, with ``sweep``,
    under CSR_SWEEP's)."""
    dev = torch.device("cuda")
    ptr_h = np.asarray(X.indptr, np.int64) - int(X.indptr[0])
    ptr = torch.from_numpy(ptr_h).to(dev)
    ind = torch.from_numpy(X.indices.astype(np.int32)).to(dev)
    val = torch.from_numpy(X.data.astype(np.float64)).to(dev)
    zeros = torch.from_numpy(bc.zero_bins(tables)).to(dev)
    n = X.shape[0]
    shape = (tables.num_groups, n) if transpose else (n, tables.num_groups)
    out = torch.empty(shape, dtype=torch.int16 if tables.out_bytes == 2
                      else torch.uint8, device=dev)
    want = torch.zeros_like(out)
    bc.bin_csr_plain(ptr, ind, val, tables, zeros, want, 0, transpose)
    planned = hasattr(bc, "launch_plan")

    def run(tabs):
        extra = ((bc.launch_plan(ptr_h, tabs, dev),) if planned else ())
        out.zero_()
        bc.bin_csr_cuda(ptr, ind, val, tabs, zeros, out, 0, transpose,
                        *extra)
        if not torch.equal(out, want):
            raise RuntimeError("bin_csr differs from its plain version")
        return {"ms": cs.device_ms(lambda: bc.bin_csr_cuda(
                    ptr, ind, val, tabs, zeros, out, 0, transpose, *extra),
                    reps=20),
                **(cs.csr_plan_stats(ptr, extra[0]) if planned else {})}

    res = {"rows": n, "entries": int(X.nnz), "groups": tables.num_groups,
           "out_bytes": tables.out_bytes, "transpose": transpose,
           **run(tables)}
    bnd = cs.bound(*cs.bin_csr_work(ptr, ind, tables, transpose))
    res.update(bound_ms=bnd[0], bound_by=bnd[1])
    if sweep:
        from lightgbm_torch.kernels import bin_rows as br
        flat = tables._replace(csr_records=torch.from_numpy(br.csr_records(
            tables.host_feats, tables.num_features,
            tables.bounds.cpu().numpy(), inline=False)).to(dev))
    for label, values, inline in (CSR_SWEEP if sweep else ()):
        with patched(bc, values):
            res[label] = run(tables if inline else flat)
    if ablated:
        import ctypes
        from lightgbm_torch.kernels import build
        own = build.load("bin_csr")
        plan = bc.launch_plan(ptr_h, tables, dev)
        for label, path in ablated.items():
            lib = ctypes.CDLL(str(path))
            symbol, argtypes = build.SIGNATURES["bin_csr"]
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = ctypes.c_int
            build._LOADED["bin_csr"] = lib
            try:
                out.zero_()
                bc.bin_csr_cuda(ptr, ind, val, tables, zeros, out, 0,
                                transpose, plan)
                if label == "feature_records" and not torch.equal(out,
                                                                  want):
                    raise RuntimeError("bin_csr on the feature records "
                                       "differs from its plain version")
                res["ablate_" + label] = cs.device_ms(lambda: bc.bin_csr_cuda(
                    ptr, ind, val, tables, zeros, out, 0, transpose, plan),
                    reps=20)
            finally:
                build._LOADED["bin_csr"] = own
    return res


def time_bin_csr(cs, torch, sweep=False, ablated=None):
    import lightgbm_torch as lt
    from lightgbm_torch.kernels import bin_csr as bc
    from lightgbm_torch.kernels import bin_rows as br

    X, y, _ = cs.make_allstate_like(CSR_ROWS + CSR_HELD_OUT, 0)
    b = lt.Dataset(X[:CSR_ROWS], label=y[:CSR_ROWS]).construct().binned
    tables = br.bin_tables(b.bin_mappers, b.group_features,
                           torch.device("cuda"))
    return {"dataset_chunk": time_one_csr(cs, torch, bc, tables,
                                          X[:CSR_CHUNK_ROWS], False, sweep,
                                          ablated),
            "predict": time_one_csr(cs, torch, bc, tables, X[CSR_ROWS:],
                                    True, sweep, ablated)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--model")
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--only", nargs="+", choices=ARMS, default=list(ARMS))
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    if "tree_shap" in args.only and not args.model:
        ap.error("--model is needed for the tree_shap arm")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_shap_bin_bench: no CUDA device", file=sys.stderr)
        return 2
    cs = own_chip_smoke()
    from lightgbm_torch.kernels import build
    build.build(args.only)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"root": args.root, "label": args.label, "card": smi}
    if "tree_shap" in args.only:
        res["tree_shap"] = time_tree_shap(cs, torch, args.model, args.sweep)
    if "bin_rows" in args.only:
        res["bin_rows"] = time_bin_rows(cs, torch, args.sweep)
    if "bin_csr" in args.only:
        res["bin_csr"] = time_bin_csr(
            cs, torch, args.sweep,
            ablated_libraries(build, args.root) if args.ablate else None)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
