"""Checkpoints and ``resume_from`` in the port against the JAX package, on
the CPU (robustness/checkpoint.py, engine.train, Booster.checkpoint).

The same numpy inputs go through the JAX package (its stream kernel in
Pallas interpret mode) and through the port with ``device_type="cpu"``.

Tolerances and why:

- Resume: a run resumed from a port-written snapshot gives model text
  byte-identical to the uninterrupted port run: the restored float32 score
  replaces the tree walk, and the RNG streams, the objective's state and
  DART's exact tree values are restored.
- Against the JAX package: both ``train`` loops are driven with dyadic
  gradients (``Booster.update`` patched, or the objective's gradients
  patched where the fused iteration must run), so the trees are exact and
  the model text before the parameter block is byte-identical.
- Lambdarank with position bias trains on its real gradients (a custom
  objective would not update the biases): resumed equals uninterrupted in
  the port byte for byte, the biases restored bit for bit, and the
  checkpoint carries the JAX package's state keys.
- ``params_hash`` and the manifest's params: the same JSON of the same
  alias-resolved params, equal strings.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu.pallas import stream_kernel as jsk
from lightgbm_tpu.robustness import checkpoint as jck

import lightgbm_torch as lt
from lightgbm_torch import objectives as tobj
from lightgbm_torch.robustness import checkpoint as tck
from lightgbm_torch.utils.log import LightGBMError

from test_torch_multiclass import _dyadic_mc_fobj, _mc_data
from test_torch_sample import _sampled_data
from test_torch_train import _dyadic_fobj, _trees_text

CPU = {"device_type": "cpu"}
_BASE = {"num_leaves": 15, "max_splits_per_round": 4,
         "hist_precision": "single", "min_data_in_leaf": 5,
         "learning_rate": 0.5, "hist_backend": "stream", "verbosity": -1}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)


def _dyadic_updates(monkeypatch, fobj):
    """Both packages' ``train`` loops call ``Booster.update()``: drive
    them with the dyadic custom gradients ``fobj``."""
    for mod in (lgb, lt):
        orig = mod.Booster.update
        monkeypatch.setattr(
            mod.Booster, "update",
            lambda self, train_set=None, fobj_=None, _o=orig:
            _o(self, fobj=fobj))


def _dyadic_l2_objective(monkeypatch):
    """regression's gradients on the dyadic grid in both packages, so that
    the objective (and the fused iteration) runs and the trees stay
    exact."""
    def port(self, score):
        g = torch.clamp(torch.round(64 * (score - self._tensor(
            "label", score.device))) / 64, -127 / 64, 127 / 64)
        return g, torch.ones_like(g)

    def jax(self, score):
        g = jnp.clip(jnp.round(64 * (score - self.label)) / 64, -127 / 64,
                     127 / 64)
        return g, jnp.ones_like(g)

    monkeypatch.setattr(tobj.RegressionL2, "get_gradients", port)
    monkeypatch.setattr(jobj.RegressionL2, "get_gradients", jax)


def _snap_params(params, tmp_path, name, freq=4):
    return {**params, "snapshot_freq": freq,
            "output_model": str(tmp_path / name)}


def _port_resume(params, data, tmp_path, iters=8, at=4, ds_kw=None):
    """The uninterrupted port run (writing snapshots) and the run resumed
    from ``at``'s snapshot: (uninterrupted, resumed)."""
    X, y = data
    p = {**_snap_params(params, tmp_path, "port.txt", freq=at), **CPU}

    def ds():
        return lt.Dataset(X, label=y, params=CPU, **(ds_kw or {}))

    full = lt.train(p, ds(), iters)
    resumed = lt.train(p, ds(), iters,
                       resume_from=str(tmp_path / f"port.txt."
                                       f"snapshot_iter_{at}"))
    return full, resumed


def _jax_run(params, data, tmp_path, iters=8, ds_kw=None):
    """The JAX package's uninterrupted run (snapshots every 4 iterations);
    its own fusion choice, which does not change its trees."""
    X, y = data
    p = _snap_params({k: v for k, v in params.items() if k != "fused_iter"},
                     tmp_path, "jax.txt")
    return lgb.train(p, lgb.Dataset(X, label=y, **(ds_kw or {})), iters)


_CASES = {
    "binary": ({"objective": "binary"}, _dyadic_fobj, None),
    "multiclass_lockstep": ({"objective": "multiclass", "num_class": 3,
                             "multiclass_batched": True}, _dyadic_mc_fobj,
                            None),
    "bagging_feature_fraction": ({"objective": "binary",
                                  "bagging_fraction": 0.5,
                                  "bagging_freq": 2,
                                  "feature_fraction": 0.7}, _dyadic_fobj,
                                 None),
    "goss": ({"objective": "binary", "data_sample_strategy": "goss",
              "top_rate": 0.5, "other_rate": 0.25}, _dyadic_fobj, None),
    "dart": ({"objective": "binary", "boosting": "dart", "drop_rate": 0.4,
              "skip_drop": 0.2}, _dyadic_fobj, None),
    "fused_on": ({"objective": "regression", "fused_iter": "on"}, None,
                 True),
    "fused_off": ({"objective": "regression", "fused_iter": "off"}, None,
                  False),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_resume_matches_uninterrupted_and_jax(case, tmp_path, monkeypatch):
    """Resumed from the iteration-4 snapshot, 8 iterations equal the
    uninterrupted run's model text byte for byte, and the JAX package's
    uninterrupted run's trees; the fused arms run the device-state grower
    (their gradients the objective's, patched onto the dyadic grid)."""
    extra, fobj, fused = _CASES[case]
    params = {**_BASE, **extra}
    if fobj is None:
        _dyadic_l2_objective(monkeypatch)
    else:
        _dyadic_updates(monkeypatch, fobj)
    data = (_mc_data(1200, 3, k=3) if case.startswith("multiclass")
            else _sampled_data(1200, 5))
    full, resumed = _port_resume(params, data, tmp_path)
    text = full.model_to_string()
    assert resumed.model_to_string() == text
    assert resumed.num_trees() == full.num_trees() > 4 * (
        3 if case.startswith("multiclass") else 1)
    if fused is not None:
        assert resumed.engine._fused is fused and full.engine._fused is fused
    if case == "dart":
        # some iteration dropped trees, so the resume crossed a rescale
        assert any(t.shrinkage != 0.5 for t in full.engine.models)
    jtext = _jax_run(params, data, tmp_path).model_to_string()
    assert _trees_text(text) == _trees_text(jtext)


def test_dart_checkpoint_without_exact_values_resumes_as_jax(tmp_path,
                                                              monkeypatch):
    """A DART checkpoint without the exact internal values (as the JAX
    package writes it) resumes from the text's six digits, as the JAX
    package's resume does: both resumed runs' trees are the same text."""
    _dyadic_updates(monkeypatch, _dyadic_fobj)
    params = {**_BASE, **_CASES["dart"][0]}
    data = _sampled_data(1200, 5)
    full, _ = _port_resume(params, data, tmp_path)
    snap = str(tmp_path / "port.txt.snapshot_iter_4")
    with np.load(snap + tck.STATE_SUFFIX) as z:
        state = {k: z[k] for k in z.files if not k.startswith("dart_")}
    _rewrite_state(snap, state)
    X, y = data
    p = {**_snap_params(params, tmp_path, "port.txt"), **CPU}
    resumed = lt.train(p, lt.Dataset(X, label=y, params=CPU), 8,
                       resume_from=snap)
    _jax_run(params, data, tmp_path)
    jres = lgb.train(_snap_params(params, tmp_path, "jax.txt"),
                     lgb.Dataset(X, label=y), 8,
                     resume_from=str(tmp_path / "jax.txt.snapshot_iter_4"))
    assert _trees_text(resumed.model_to_string()) == _trees_text(
        jres.model_to_string())
    assert resumed.model_to_string() != full.model_to_string()
    np.testing.assert_array_equal(
        resumed.predict(X, raw_score=True), full.predict(X, raw_score=True))


def _rewrite_state(snap, state):
    """Write a snapshot's state anew and seal its manifest over it."""
    import io
    buf = io.BytesIO()
    np.savez(buf, **state)
    data = buf.getvalue()
    with open(snap + tck.STATE_SUFFIX, "wb") as fh:
        fh.write(data)
    _reseal(snap, state_sha256=tck._sha256_bytes(data))


def _reseal(snap, **fields):
    mpath = snap + tck.MANIFEST_SUFFIX
    with open(mpath) as fh:
        manifest = json.load(fh)
    manifest.update(fields)
    with open(mpath, "w") as fh:
        json.dump(manifest, fh)


def _ranking_data(nq=40, seed=0):
    rs = np.random.RandomState(seed)
    sizes = rs.randint(5, 30, nq)
    n = int(sizes.sum())
    X = rs.randn(n, 5)
    y = np.clip(np.round(X[:, 0] + 0.5 * rs.randn(n) + 1), 0, 3)
    pos = np.concatenate([np.arange(s) % 8 for s in sizes])
    return X, y, sizes, pos


@pytest.mark.parametrize("fused", ["on", "off"])
def test_resume_lambdarank_position_bias(fused, tmp_path):
    """Lambdarank with position biases on its real gradients: resumed
    equals uninterrupted byte for byte, fused and eager; the biases after
    the last iteration are the same bits; the checkpoint's state holds the
    JAX package's keys with the same shapes."""
    X, y, sizes, pos = _ranking_data()
    params = {"objective": "lambdarank", "num_leaves": 7,
              "min_data_in_leaf": 3, "fused_iter": fused,
              "lambdarank_position_bias_regularization": 0.1,
              "verbosity": -1}
    kw = {"group": sizes, "position": pos}
    full, resumed = _port_resume(params, (X, y), tmp_path, iters=6, at=4,
                                 ds_kw=kw)
    assert resumed.model_to_string() == full.model_to_string()
    assert resumed.engine._fused is (fused == "on")
    np.testing.assert_array_equal(
        resumed.engine.objective.pos_biases.numpy(),
        full.engine.objective.pos_biases.numpy())
    _jax_run({**params, "hist_backend": "stream"}, (X, y), tmp_path,
             iters=4, ds_kw=kw)
    with np.load(str(tmp_path / "port.txt.snapshot_iter_4")
                 + tck.STATE_SUFFIX) as t, \
            np.load(str(tmp_path / "jax.txt.snapshot_iter_4")
                    + jck.STATE_SUFFIX) as j:
        assert sorted(t.files) == sorted(j.files)
        assert "obj_state__pos_biases" in t.files
        assert {k: t[k].shape for k in t.files} == {
            k: j[k].shape for k in j.files}


def test_resume_from_a_jax_written_checkpoint(tmp_path, monkeypatch):
    """A checkpoint the JAX package wrote (params, model text, state) is
    resumed by the port to the JAX package's uninterrupted model text: both
    pad the rows to 256, so the score shapes agree."""
    _dyadic_updates(monkeypatch, _dyadic_fobj)
    params = {**_BASE, "objective": "binary", "bagging_fraction": 0.5,
              "bagging_freq": 1, "feature_fraction": 0.7, **CPU}
    data = _sampled_data(1200, 5)
    jfull = _jax_run(params, data, tmp_path)
    X, y = data
    resumed = lt.train(_snap_params(params, tmp_path, "jax.txt"),
                       lt.Dataset(X, label=y, params=CPU), 8,
                       resume_from=str(tmp_path / "jax.txt.snapshot_iter_4"))
    assert _trees_text(resumed.model_to_string()) == _trees_text(
        jfull.model_to_string())


def test_manifest_params_hash_equals_jax(tmp_path):
    """The manifest's keys, params block and params_hash are the JAX
    package's for the same params."""
    X, y = _sampled_data(600, 5)
    params = {**_BASE, "objective": "binary", "sub_feature": 0.8,
              "reg_lambda": 0.5, "seed": 3, **CPU}
    p = _snap_params(params, tmp_path, "port.txt", freq=2)
    lt.train(p, lt.Dataset(X, label=y, params=CPU), 2)
    lgb.train(_snap_params(params, tmp_path, "jax.txt", freq=2),
              lgb.Dataset(X, label=y), 2)
    got = tck.read_manifest(str(tmp_path / "port.txt.snapshot_iter_2"))
    want = jck.read_manifest(str(tmp_path / "jax.txt.snapshot_iter_2"))
    assert sorted(got) == sorted(want)
    assert got["params"] == want["params"]
    assert got["params_hash"] == want["params_hash"] == jck.params_hash(p)
    assert tck.params_hash(p) == jck.params_hash(p)
    assert tck.canonical_params(p) == jck.canonical_params(p)
    assert (got["iteration"], got["num_trees"], got["num_processes"]) == (
        2, 2, 1)


# ---------------------------------------------------------------- refusals

def _written(tmp_path, iters=4, **extra):
    X, y = _sampled_data(800, 5)
    p = {**_snap_params({**_BASE, "objective": "binary", **extra}, tmp_path,
                        "m.txt"), **CPU}
    bst = lt.train(p, lt.Dataset(X, label=y, params=CPU), iters)
    return p, X, y, bst, str(tmp_path / "m.txt.snapshot_iter_4")


def _resume(p, X, y, snap, **kw):
    return lt.train(p, lt.Dataset(X, label=y, params=CPU), 8,
                    resume_from=snap, **kw)


def _jax_raises(fn, match):
    with pytest.raises(Exception, match=match):
        fn()


def test_corrupt_and_missing_manifest_refused(tmp_path):
    """A half-written model file fails its checksum, a plain model file has
    no manifest: both refused with the JAX package's messages."""
    p, X, y, bst, snap = _written(tmp_path)
    plain = str(tmp_path / "plain.txt")
    bst.save_model(plain)
    with pytest.raises(LightGBMError, match="has no manifest") as e:
        _resume(p, X, y, plain)
    _jax_raises(lambda: jck.read_manifest(plain), "has no manifest")
    assert "either the file is not a checkpoint" in str(e.value)
    text = open(snap).read()
    with open(snap, "w") as fh:
        fh.write(text[:len(text) // 2])
    with pytest.raises(LightGBMError, match="failed its content checksum"):
        tck.validate_checkpoint(snap)
    with pytest.raises(LightGBMError, match="failed its content checksum"):
        _resume(p, X, y, snap)
    _jax_raises(lambda: jck.validate_checkpoint(snap),
                "failed its content checksum")


def test_params_mismatch_and_init_model_conflict_refused(tmp_path):
    p, X, y, bst, snap = _written(tmp_path)
    with pytest.raises(LightGBMError,
                       match="different training parameters.*learning_rate"):
        _resume({**p, "learning_rate": 0.27}, X, y, snap)
    with pytest.raises(LightGBMError, match="not both"):
        _resume(p, X, y, snap, init_model=bst)
    # volatile keys may differ: a resume under another output_model and
    # snapshot cadence still validates
    tck.validate_checkpoint(snap, params={**p, "snapshot_freq": 3,
                                          "output_model": "elsewhere.txt",
                                          "verbosity": 2})
    with pytest.raises(LightGBMError, match="was written by 1 process"):
        tck.validate_checkpoint(snap, expect_processes=2)


def test_truncated_text_and_nonfinite_tree_refused(tmp_path):
    """A truncated model text or a NaN leaf, each sealed with a matching
    checksum, still fails validation, with the JAX package's message."""
    p, X, y, bst, snap = _written(tmp_path)
    text = open(snap).read()
    for bad, match in ((text[:int(len(text) * 0.5)], "truncated model"),
                       (text[:text.index("end of trees")], "end of trees")):
        with open(snap, "w") as fh:
            fh.write(bad)
        _reseal(snap, model_sha256=tck._sha256_bytes(bad.encode()))
        with pytest.raises(LightGBMError, match=match):
            tck.validate_checkpoint(snap)
        _jax_raises(lambda: jck.validate_checkpoint(snap), match)
    lines = text.split("\n")
    i = next(i for i, ln in enumerate(lines) if ln.startswith("leaf_value="))
    lines[i] = "leaf_value=nan " + lines[i].split(" ", 1)[1]
    bad = "\n".join(lines)
    with open(snap, "w") as fh:
        fh.write(bad)
    _reseal(snap, model_sha256=tck._sha256_bytes(bad.encode()))
    with pytest.raises(LightGBMError, match="non-finite leaf values in "
                                            "checkpoint"):
        _resume(p, X, y, snap)
    _jax_raises(lambda: jck.validate_checkpoint(snap),
                "non-finite leaf values in checkpoint")


def test_resume_past_the_end_trains_nothing(tmp_path):
    p, X, y, bst, snap = _written(tmp_path)
    text = bst.model_to_string()
    again = lt.train(p, lt.Dataset(X, label=y, params=CPU), 4,
                     resume_from=snap)
    assert again.model_to_string() == text


def test_prune_keeps_promoted_snapshots(tmp_path):
    """snapshot_keep prunes to the newest, never deleting a snapshot a live
    promote.json names (the served one and its rollback target), and the
    training loop passes ``serve_fleet_dir`` through Booster.checkpoint;
    no tmp file is left behind."""
    X, y = _sampled_data(800, 5)
    M = tmp_path / "snapdir" / "m.txt"
    fleet = tmp_path / "fleet"
    fleet.mkdir()
    p = {**_BASE, "objective": "binary", "snapshot_freq": 2,
         "output_model": str(M), **CPU}
    lt.train(p, lt.Dataset(X, label=y, params=CPU), 8)
    snaps = dict(tck.list_snapshots(str(M)))
    assert set(snaps) == {2, 4, 6, 8}
    (fleet / "promote.json").write_text(json.dumps(
        {"path": snaps[4], "prev": {"path": snaps[2]}}))
    assert tck.promoted_paths(str(fleet)) == {
        os.path.realpath(snaps[4]), os.path.realpath(snaps[2])}
    tck.prune_snapshots(str(M), keep=1, fleet_dir=str(fleet))
    assert set(dict(tck.list_snapshots(str(M)))) == {2, 4, 8}
    tck.prune_snapshots(str(M), keep=1)
    assert set(dict(tck.list_snapshots(str(M)))) == {8}
    M2 = tmp_path / "run2" / "m.txt"
    lt.train({**p, "output_model": str(M2), "snapshot_keep": 1,
              "serve_fleet_dir": str(fleet)},
             lt.Dataset(X, label=y, params=CPU), 4)
    (fleet / "promote.json").write_text(json.dumps(
        {"path": str(M2) + ".snapshot_iter_2"}))
    lt.train({**p, "output_model": str(M2), "snapshot_keep": 1,
              "serve_fleet_dir": str(fleet)},
             lt.Dataset(X, label=y, params=CPU), 6)
    assert [it for it, _ in tck.list_snapshots(str(M2))] == [2, 6]
    assert [f for f in os.listdir(M.parent) if ".tmp." in f] == []
    for _, path in tck.list_snapshots(str(M2)):
        assert os.path.exists(path + tck.MANIFEST_SUFFIX)
        assert os.path.exists(path + tck.STATE_SUFFIX)


def test_latest_valid_snapshot_skips_a_truncated_file(tmp_path):
    """The newest snapshot cut short by hand (a crash after its manifest)
    is skipped; the one before it is returned and resumes."""
    X, y = _sampled_data(800, 5)
    M = tmp_path / "m.txt"
    p = {**_BASE, "objective": "binary", "snapshot_freq": 2,
         "output_model": str(M), **CPU}
    full = lt.train(p, lt.Dataset(X, label=y, params=CPU), 6)
    newest = str(M) + ".snapshot_iter_6"
    text = open(newest).read()
    with open(newest, "w") as fh:
        fh.write(text[:len(text) // 3])
    assert tck.latest_valid_snapshot(str(M), params=p) == \
        str(M) + ".snapshot_iter_4"
    assert jck.latest_valid_snapshot(str(M)) == str(M) + ".snapshot_iter_4"
    resumed = lt.train({**p, "output_model": str(tmp_path / "r.txt")},
                       lt.Dataset(X, label=y, params=CPU), 6,
                       resume_from=tck.latest_valid_snapshot(str(M)))
    assert _trees_text(resumed.model_to_string()) == _trees_text(
        full.model_to_string())
    os.unlink(str(M) + ".snapshot_iter_4" + tck.MANIFEST_SUFFIX)
    assert tck.latest_valid_snapshot(str(M)) == str(M) + ".snapshot_iter_2"


def test_atomic_writers(tmp_path):
    """atomic_write_bytes / _lines write whole files through a tmp file and
    refuse append modes, as the JAX package's."""
    path = str(tmp_path / "d" / "f.txt")
    tck.atomic_write_lines(path, (f"{i}\n" for i in range(1000)))
    assert open(path).read() == "".join(f"{i}\n" for i in range(1000))
    tck.atomic_write_bytes(path, b"\x00\x01")
    assert open(path, "rb").read() == b"\x00\x01"
    with pytest.raises(ValueError, match="unsupported"):
        with tck.atomic_open(path, "a"):
            pass
    assert os.listdir(tmp_path / "d") == ["f.txt"]


def test_cegb_resume_equals_the_jax_packages_resume(tmp_path,
                                                    monkeypatch):
    """CEGB's used features and lazy bitset are not in the checkpoint, in
    either package (ROADMAP §3): a resumed CEGB run may differ from the
    uninterrupted one, and the port's resumed run equals the JAX package's
    resumed run."""
    _dyadic_updates(monkeypatch, _dyadic_fobj)
    params = {**_BASE, "objective": "binary", "num_leaves": 31,
              "max_splits_per_round": 8, "learning_rate": 0.1,
              "cegb_tradeoff": 0.5,
              "cegb_penalty_split": 0.015625,
              "cegb_penalty_feature_coupled": [0.0, 0.0, 2.0, 0.0, 1.0,
                                               4.0],
              "cegb_penalty_feature_lazy": [0.015625, 0.0, 0.0078125, 0.0,
                                            0.0, 0.0]}
    data = _sampled_data(1000, 5)
    full, resumed = _port_resume(params, data, tmp_path, iters=6, at=4)
    X, y = data
    _jax_run(params, data, tmp_path, iters=6)
    jres = lgb.train(_snap_params(params, tmp_path, "jax.txt"),
                     lgb.Dataset(X, label=y), 6,
                     resume_from=str(tmp_path / "jax.txt.snapshot_iter_4"))
    assert _trees_text(resumed.model_to_string()) == _trees_text(
        jres.model_to_string())
    assert _trees_text(full.model_to_string()).count("Tree=") == 6
    # the lazy bitset and used features start empty again after a resume
    assert _trees_text(resumed.model_to_string()) != _trees_text(
        full.model_to_string())
