#!/usr/bin/env python3
"""Time the port's TreeSHAP kernel ``tree_shap`` and its row binning kernel
``bin_rows`` on one NVIDIA GPU at their main paths' shapes.

    python3 scripts/torch_shap_bin_bench.py [--root DIR] --model PATH
                                            [--label TEXT] [--sweep]

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
  255, 16-bit (N, G) bins): its device time and its plan.

Every timed output is first held to the root's plain version (``bin_rows``:
byte for byte; ``tree_shap``: within 1e-10 of each row's scale).  Prints
one JSON line with the root, the card (``nvidia-smi``) and the times.
``--sweep`` (a root with this checkout's plans) also times each kernel
under other plans, set through the plan modules' constants:
``tree_shap`` with its decision words or its accumulators out of shared
memory and with 2, 8 and 16 blocks an SM before trees are grouped;
``bin_rows`` at 2, 3, 4, 6 and 8 blocks an SM with tiles of 4-64 KB and
with the tables in global memory.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SHAP_ROWS = (100_000, 10_000)
WIDE_CHUNK_ROWS = 49_784


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--model", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_shap_bin_bench: no CUDA device", file=sys.stderr)
        return 2
    cs = own_chip_smoke()
    from lightgbm_torch.kernels import build
    build.build(["tree_shap", "bin_rows"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"root": args.root, "label": args.label, "card": smi,
           "tree_shap": time_tree_shap(cs, torch, args.model, args.sweep),
           "bin_rows": time_bin_rows(cs, torch, args.sweep)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
