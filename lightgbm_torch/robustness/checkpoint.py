"""Crash-consistent checkpoints and resume: the port's copy of
``lightgbm_tpu/robustness/checkpoint.py``, on one process.

A snapshot is a checkpoint: the model text plus the engine state a
bit-identical continuation needs (the padded float32 score, the host RNG
streams, the objective's state), each written through a same-directory tmp
file, fsync and ``os.replace`` (``atomic_open``), and sealed by a JSON
manifest with content checksums.  The manifest is written last, so its
presence certifies a complete checkpoint and a crash mid-write never leaves
a snapshot that validates.  The files, the manifest's keys, the format
version and the error messages are the JAX package's, so a checkpoint
written by either package resumes in the other where both pad the rows
alike (256 rows).

Layout for ``output_model=M`` at iteration ``N``::

    M.snapshot_iter_N                 model text (LightGBM v4 format)
    M.snapshot_iter_N.state.npz       score + RNG/objective state
    M.snapshot_iter_N.manifest.json   iteration, params hash, checksums

``lightgbm_torch.train(..., resume_from=M.snapshot_iter_N)`` validates the
manifest, loads the trees as the init model, restores the state, and
continues from iteration N byte-identically to a run that was never
interrupted.  Other writers use ``atomic_open`` and its helpers too
(``Dataset.save_binary``, ``CVBooster.save_model``).
"""
from __future__ import annotations

import contextlib
import glob
import hashlib
import io
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_aliases
from ..utils.log import LightGBMError, log_debug, log_info
from .guards import check_model_trees

MANIFEST_SUFFIX = ".manifest.json"
STATE_SUFFIX = ".state.npz"
FORMAT_VERSION = 1

# params with no bearing on the trained model: IO paths, orchestration and
# observability knobs may differ between the checkpointing run and the
# resuming run without breaking bit-identity (the JAX package's set, whole,
# so both packages hash the same params alike)
_VOLATILE_PARAMS = frozenset({
    "config", "task", "data", "valid", "num_iterations", "verbosity",
    "input_model", "output_model", "output_result",
    "saved_feature_importance_type",
    "snapshot_freq", "snapshot_keep", "resume_from", "save_binary",
    "num_machines", "machines", "machine_list_filename", "local_listen_port",
    "time_out", "dist_retries", "dist_backoff",
    "hist_comms", "hist_comms_pipeline", "eval_fetch_freq",
    "ingest_cache", "ingest_cache_path",
    "telemetry", "telemetry_out", "trace_out",
    "telemetry_recompile_threshold",
    "telemetry_straggler_every", "telemetry_straggler_skew",
    "telemetry_cost", "profile_out",
    "serve_host", "serve_port", "serve_max_batch", "serve_max_delay_ms",
    "serve_queue_size", "serve_buckets", "serve_warmup", "serve_heartbeat",
    "serve_replicas", "serve_fleet_mode", "serve_fleet_dir",
    "serve_binary_port", "serve_binary_accept_threads",
    "serve_deadline_ms", "serve_retries", "serve_retry_backoff_ms",
    "serve_breaker_failures", "serve_breaker_cooldown_s",
    "serve_restart_backoff_s", "serve_hang_timeout_s",
    "serve_trace_sample", "serve_trace_tail", "serve_access_log",
    "serve_slo_availability", "serve_slo_p99_ms", "serve_slo_window_s",
    "serve_slo_burn",
    "quality_profile", "quality_sample", "quality_audit_sample",
    "quality_min_rows", "quality_topk", "drift_threshold",
    "drift_window_s",
    "pipeline_fresh_data", "pipeline_refit_iterations",
    "pipeline_gate_margin", "pipeline_observe_s",
    "pipeline_observe_poll_s", "pipeline_promote",
})


# ---------------------------------------------------------------------------
# atomic writes
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def atomic_open(path: str, mode: str = "w", **open_kw):
    """Open a same-directory tmp file for writing; on a clean ``with`` exit
    it is fsynced and ``os.replace``d onto ``path``, on an exception it is
    unlinked.  Truncating-write modes only: an append or update mode would
    start from an empty tmp file and ``os.replace`` would discard what is
    at ``path``."""
    if "a" in mode or "+" in mode or "r" in mode:
        raise ValueError(
            f"atomic_open mode {mode!r} unsupported: the tmp file starts "
            "empty, so append/update modes would truncate the destination; "
            "use 'w'/'wb'/'x'/'xb'")
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, mode, **open_kw) as fh:
            yield fh
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def atomic_write_bytes(path: str, data: bytes) -> None:
    """``data`` at ``path`` through ``atomic_open``."""
    with atomic_open(path, "wb") as fh:
        fh.write(data)


def atomic_write_text(path: str, text: str) -> None:
    """``text`` as UTF-8 at ``path``, through ``atomic_open``."""
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_lines(path: str, lines) -> None:
    """An iterable of text chunks streamed into the tmp file (constant
    memory), then fsynced and replaced onto ``path``."""
    with atomic_open(path, "w", encoding="utf-8") as fh:
        for chunk in lines:
            fh.write(chunk)


def _sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# params identity
# ---------------------------------------------------------------------------

def canonical_params(params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Alias-resolved params minus IO/orchestration keys, JSON-normalized
    (numpy scalars -> python, everything non-JSON stringified)."""
    resolved = resolve_aliases(dict(params or {}))
    kept = {k: v for k, v in resolved.items() if k not in _VOLATILE_PARAMS}
    return json.loads(json.dumps(kept, sort_keys=True, default=str))


def params_hash(params: Optional[Dict[str, Any]]) -> str:
    return _sha256_bytes(
        json.dumps(canonical_params(params), sort_keys=True).encode())


# ---------------------------------------------------------------------------
# engine state capture / restore
# ---------------------------------------------------------------------------

def _pack_rng(prefix: str, rng, out: Dict[str, np.ndarray]) -> None:
    name, keys, pos, has_gauss, cached = rng.get_state(legacy=True)
    if name != "MT19937":  # pragma: no cover - numpy has one legacy generator
        raise LightGBMError(f"cannot checkpoint RNG of type {name}")
    out[f"{prefix}__keys"] = np.asarray(keys, np.uint32)
    out[f"{prefix}__meta"] = np.asarray([pos, has_gauss], np.int64)
    out[f"{prefix}__gauss"] = np.asarray([cached], np.float64)


def _unpack_rng(prefix: str, rng, state: Dict[str, np.ndarray]) -> None:
    if f"{prefix}__keys" not in state:
        return
    meta = state[f"{prefix}__meta"]
    rng.set_state(("MT19937", np.asarray(state[f"{prefix}__keys"], np.uint32),
                   int(meta[0]), int(meta[1]),
                   float(state[f"{prefix}__gauss"][0])))


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def capture_state(booster) -> Dict[str, np.ndarray]:
    """Everything beyond the trees that a bit-identical continuation needs:
    the padded float32 score (the fused iteration's ``TrainState.score``
    once it runs: ``engine.score`` is that tensor), the feature-fraction,
    DART drop and objective RNG streams, and the objective's
    ``state_attrs``.  The lazy trees and the guard's unread flags are
    flushed first."""
    engine = booster.engine
    engine._flush_models()
    engine.flush_pending_ok()
    state: Dict[str, np.ndarray] = {
        "score": np.asarray(_host(engine.score), np.float32)}
    if getattr(engine, "_rng", None) is not None:
        _pack_rng("rng_feature", engine._rng, state)
    if getattr(engine, "_drop_rng", None) is not None:   # DART
        _pack_rng("rng_drop", engine._drop_rng, state)
        # DART rescales earlier trees, and the model text keeps their
        # internal values and shrinkage to six digits only: the exact ones
        # ride along (a checkpoint without them resumes from the text's)
        trees = engine.models
        state["dart_internal_value"] = np.concatenate(
            [np.asarray(t.internal_value, np.float64) for t in trees]
            + [np.zeros(0)])
        state["dart_shrinkage"] = np.asarray([t.shrinkage for t in trees],
                                             np.float64)
    obj = engine.objective
    if obj is not None:
        if getattr(obj, "_rng", None) is not None:       # rank_xendcg
            _pack_rng("rng_objective", obj._rng, state)
        for a in obj.state_attrs():
            v = getattr(obj, a, None)
            if v is not None:
                state[f"obj_state__{a}"] = _host(v)
    return state


def restore_state(booster, state: Dict[str, np.ndarray]) -> None:
    """Inverse of :func:`capture_state` on a freshly seeded engine (after
    ``load_init_model``): the restored float32 score replaces the tree-walk
    reconstruction, so the resumed run's gradients are bit-identical.  The
    fused iteration copies it into its state at its first step
    (``GBDT._ensure_train_state``)."""
    engine = booster.engine
    score = np.asarray(state["score"], np.float32)
    if tuple(score.shape) != tuple(engine.score.shape):
        raise LightGBMError(
            f"checkpoint score shape {tuple(score.shape)} does not match this "
            f"run's {tuple(engine.score.shape)} — dataset, num_class, or "
            "process topology changed since the snapshot was written")
    engine.score = torch.as_tensor(score).to(engine.device)
    if getattr(engine, "_rng", None) is not None:
        _unpack_rng("rng_feature", engine._rng, state)
    if getattr(engine, "_drop_rng", None) is not None:
        _unpack_rng("rng_drop", engine._drop_rng, state)
        _restore_dart_trees(engine.models, state)
    obj = engine.objective
    if obj is not None:
        if getattr(obj, "_rng", None) is not None:
            _unpack_rng("rng_objective", obj._rng, state)
        for a in obj.state_attrs():
            key = f"obj_state__{a}"
            if key in state:
                obj.set_state_attr(a, np.asarray(state[key]), engine.device)


def _restore_dart_trees(trees, state: Dict[str, np.ndarray]) -> None:
    """The exact internal values and shrinkage of a DART checkpoint's
    trees, where it carries them and they fit the loaded trees."""
    if "dart_internal_value" not in state:
        return
    iv = np.asarray(state["dart_internal_value"], np.float64)
    shrink = np.asarray(state["dart_shrinkage"], np.float64)
    sizes = [len(t.internal_value) for t in trees]
    if len(shrink) != len(trees) or sum(sizes) != len(iv):
        raise LightGBMError(
            "checkpoint DART state does not match its model's trees")
    pos = 0
    for t, size, s in zip(trees, sizes, shrink):
        t.internal_value = iv[pos:pos + size].copy()
        t.shrinkage = float(s)
        pos += size


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------

def snapshot_path(output_model: str, iteration: int) -> str:
    return f"{output_model}.snapshot_iter_{iteration}"


def write_checkpoint(booster, output_model: str, iteration: int,
                     keep: int = -1, fleet_dir: str = "") -> str:
    """Write the iteration-``N`` checkpoint for ``output_model`` and prune
    to the ``keep`` newest (``keep <= 0`` keeps all).  Returns the snapshot
    path."""
    path = snapshot_path(str(output_model), int(iteration))
    model_str = booster.model_to_string()
    state = capture_state(booster)
    atomic_write_text(path, model_str)
    buf = io.BytesIO()
    np.savez(buf, **state)
    state_bytes = buf.getvalue()
    atomic_write_bytes(path + STATE_SUFFIX, state_bytes)
    manifest = {
        "format_version": FORMAT_VERSION,
        "iteration": int(iteration),
        "num_trees": booster.num_trees(),
        "num_tree_per_iteration": booster.num_model_per_iteration(),
        "model_file": os.path.basename(path),
        "model_sha256": _sha256_bytes(model_str.encode("utf-8")),
        "state_file": os.path.basename(path + STATE_SUFFIX),
        # the in-memory bytes: re-reading the npz just written would be a
        # second full read on the training path
        "state_sha256": _sha256_bytes(state_bytes),
        "params_hash": params_hash(getattr(booster, "params", {})),
        "params": canonical_params(getattr(booster, "params", {})),
        "num_processes": 1,
        "created_unix": time.time(),
    }
    atomic_write_text(path + MANIFEST_SUFFIX,
                      json.dumps(manifest, indent=1, sort_keys=True))
    if keep and keep > 0:
        prune_snapshots(str(output_model), keep, fleet_dir=fleet_dir)
    return path


def promoted_paths(fleet_dir: str) -> set:
    """Real paths a live ``promote.json`` generation points at: the served
    model and its rollback target (``prev``).  A torn or unreadable
    pointer pins nothing."""
    pinned: set = set()
    if not fleet_dir:
        return pinned
    try:
        with open(os.path.join(fleet_dir, "promote.json")) as fh:
            p = json.load(fh)
    except (OSError, ValueError):
        return pinned
    for rec in (p, p.get("prev") or {}):
        target = rec.get("path")
        if target:
            pinned.add(os.path.realpath(str(target)))
    return pinned


def prune_snapshots(output_model: str, keep: int,
                    fleet_dir: str = "") -> None:
    """Delete all but the ``keep`` newest snapshots, except any snapshot a
    live promotion generation (served or rollback target) points at."""
    pinned = promoted_paths(fleet_dir)
    for it, path in list_snapshots(output_model)[:-keep]:
        if os.path.realpath(path) in pinned:
            log_debug(f"snapshot {path} pinned by a live promotion; "
                      "not pruned")
            continue
        for p in (path, path + STATE_SUFFIX, path + MANIFEST_SUFFIX):
            try:
                os.unlink(p)
            except OSError:
                pass
        log_debug(f"pruned snapshot {path} (snapshot_keep={keep})")


def list_snapshots(output_model: str) -> List[Tuple[int, str]]:
    """(iteration, path) for every on-disk snapshot, oldest first."""
    pat = re.compile(re.escape(os.path.basename(output_model))
                     + r"\.snapshot_iter_(\d+)$")
    out = []
    for p in glob.glob(glob.escape(output_model) + ".snapshot_iter_*"):
        m = pat.match(os.path.basename(p))
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


# ---------------------------------------------------------------------------
# validate / load
# ---------------------------------------------------------------------------

def read_manifest(path: str) -> Dict[str, Any]:
    mpath = path + MANIFEST_SUFFIX
    if not os.path.exists(mpath):
        raise LightGBMError(
            f"checkpoint {path!r} has no manifest ({mpath} missing) — either "
            "the file is not a checkpoint or its write never completed")
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except ValueError as e:
        raise LightGBMError(f"checkpoint manifest {mpath} is not valid "
                            f"JSON: {e}")
    if manifest.get("format_version") != FORMAT_VERSION:
        raise LightGBMError(
            f"checkpoint {path!r} has manifest format_version="
            f"{manifest.get('format_version')!r}; this build reads "
            f"{FORMAT_VERSION}")
    return manifest


def validate_checkpoint(path: str,
                        params: Optional[Dict[str, Any]] = None,
                        expect_processes: Optional[int] = None
                        ) -> Dict[str, Any]:
    """The whole chain: manifest present, checksums match, the model text
    parses completely, its trees are finite, the tree count matches, and
    (when ``params`` is given) the model-relevant params match the
    manifest's.  ``expect_processes``: the resuming job's process count,
    1 by default (the port is one process)."""
    return _validate_and_read(path, params, expect_processes)[0]


def _validate_and_read(path: str, params: Optional[Dict[str, Any]],
                       expect_processes: Optional[int]):
    """validate_checkpoint's body, returning the verified model text too,
    so resume parses the exact bytes that were checksummed."""
    from ..model_io import load_model_string

    path = str(path)
    manifest = read_manifest(path)
    if not os.path.exists(path):
        raise LightGBMError(f"checkpoint model file missing: {path}")
    with open(path, encoding="utf-8") as fh:
        model_str = fh.read()
    if _sha256_bytes(model_str.encode("utf-8")) != manifest["model_sha256"]:
        raise LightGBMError(
            f"checkpoint {path!r} failed its content checksum — the model "
            "file is truncated or corrupt; resume from an older snapshot")
    lm = load_model_string(model_str)   # raises on truncated tree blocks
    if len(lm.trees) != int(manifest["num_trees"]):
        raise LightGBMError(
            f"checkpoint {path!r} holds {len(lm.trees)} trees but its "
            f"manifest recorded {manifest['num_trees']}")
    check_model_trees(lm.trees, what=f"checkpoint {path!r}")
    spath = path + STATE_SUFFIX
    if not os.path.exists(spath):
        raise LightGBMError(f"checkpoint state file missing: {spath}")
    if _sha256_file(spath) != manifest["state_sha256"]:
        raise LightGBMError(
            f"checkpoint state {spath!r} failed its content checksum")
    want_procs = int(expect_processes) if expect_processes is not None else 1
    if int(manifest.get("num_processes", 1)) != want_procs:
        raise LightGBMError(
            f"checkpoint {path!r} was written by "
            f"{manifest.get('num_processes')} process(es) but this run has "
            f"{want_procs} — resume needs the same topology for "
            "bit-identical continuation")
    if params is not None:
        want = canonical_params(params)
        have = manifest.get("params", {})
        if want != have:
            diff = sorted(set(want) ^ set(have)
                          | {k for k in set(want) & set(have)
                             if want[k] != have[k]})
            raise LightGBMError(
                f"checkpoint {path!r} was written with different training "
                f"parameters (differing keys: {', '.join(diff) or '?'}); "
                "resume with the original params or pass params=None to "
                "skip the check")
    return manifest, model_str


def load_checkpoint(path: str,
                    params: Optional[Dict[str, Any]] = None
                    ) -> Tuple[str, Dict[str, Any], Dict[str, np.ndarray]]:
    """Validate and load: (model text, manifest, state arrays)."""
    manifest, model_str = _validate_and_read(path, params, None)
    with np.load(str(path) + STATE_SUFFIX) as z:
        state = {k: z[k] for k in z.files}
    return model_str, manifest, state


def latest_valid_snapshot(output_model: str,
                          params: Optional[Dict[str, Any]] = None,
                          expect_processes: Optional[int] = None
                          ) -> Optional[str]:
    """The newest snapshot of ``output_model`` that passes full validation;
    invalid or corrupt ones are skipped with a log line."""
    for it, path in reversed(list_snapshots(output_model)):
        try:
            validate_checkpoint(path, params=params,
                                expect_processes=expect_processes)
            return path
        except LightGBMError as e:
            log_info(f"skipping invalid snapshot {path}: {e}")
    return None
