"""Per-node feature sampling (``feature_fraction_bynode``) and random
thresholds (``extra_trees``) of the port against the JAX package, on the
CPU, with the draws they take: ``utils.random.fold_in`` and ``randint``.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode) and through the port with ``device_type="cpu"``.

Tolerances and why:

- ``fold_in``, ``randint`` and the rows of a draw: integer Threefry words,
  bit-equal to the installed ``jax.random`` (partitionable Threefry).
- The split scan under ``extra_key`` on dyadic histograms: bit-equal.
- Dyadic training: neither mode changes a gain's arithmetic, so the model
  text is byte-identical to the jitted JAX package's under every backend,
  one class and K classes.  The draw rows follow the reference's (R, F)
  blocks, with a split budget below 64 and more leaves than two budgets.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.config import resolve_aliases
from lightgbm_torch.ops import grow as tgrow
from lightgbm_torch.ops import split as tsplit
from lightgbm_torch.utils import random as trandom

from test_torch_constraints import _BASE, _case, _train
from test_torch_multiclass import _dyadic_mc_fobj, _mc_data
from test_torch_sample import _sampled_data
from test_torch_train import _dyadic_fobj, _trees_text

CPU = {"device_type": "cpu"}
SEEDS = [0, 5, 2 ** 31 + 5, 10 ** 12]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


# ------------------------------------------------------------------ draws

def _words(key):
    return tuple(int(x) for x in np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bit_equal(seed):
    """``fold_in`` of Python ints, and of a key and data in 0-d device
    tensors (a fused iteration's buffers), equals ``jax.random.fold_in``,
    chained as the grower chains it."""
    jk, tk = jax.random.PRNGKey(seed), trandom.prng_key(seed)
    assert _words(jk) == tk
    for data in (0, 1, 2, 7, 100000, 100003, 2 ** 31 + 1, 2 ** 32 - 1):
        want = _words(jax.random.fold_in(jk, data))
        assert trandom.fold_in(tk, data) == want
        dev = trandom.fold_in(tuple(torch.tensor(w) for w in tk),
                              torch.tensor(data))
        assert tuple(int(w) for w in dev) == want
        assert trandom.fold_in(want, 3) == _words(
            jax.random.fold_in(jax.random.fold_in(jk, data), 3))


@pytest.mark.parametrize("shape", [1, (7,), (2, 3), (255, 28)])
def test_randint_bit_equal(shape):
    """``randint`` equals ``jax.random.randint`` (int32) over spans that
    are and are not powers of two, empty and one-value spans, the full
    int32 range and reversed bounds."""
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), trandom.prng_key(seed)
        for lo, hi in ((0, 1 << 30), (0, 7), (-5, 5), (3, 3), (3, 4),
                       (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1), (10, 2)):
            np.testing.assert_array_equal(
                trandom.randint(tk, shape, lo, hi).numpy(),
                np.asarray(jax.random.randint(jk, shape, lo, hi)),
                err_msg=f"{seed} {lo} {hi}")


def test_rows_of_a_draw():
    """Under partitionable Threefry the rows of an (R, F) draw do not
    depend on R, and ``uniform_rows`` / ``randint_rows`` give any rows of
    it, in any order, as the grower reads them."""
    jk, tk = jax.random.PRNGKey(11), trandom.prng_key(11)
    small = np.asarray(jax.random.randint(jk, (2, 3), 0, 1 << 30))
    big = np.asarray(jax.random.randint(jk, (4, 3), 0, 1 << 30))
    np.testing.assert_array_equal(small, big[:2])
    rows = torch.tensor([70, 0, 3, 64, 127])
    u = np.asarray(jax.random.uniform(jk, (128, 28)))
    np.testing.assert_array_equal(
        trandom.uniform_rows(tk, rows, 28).numpy(), u[rows.numpy()])
    r = np.asarray(jax.random.randint(jk, (128, 28), 0, 1 << 30))
    np.testing.assert_array_equal(
        trandom.randint_rows(tk, rows, 28, 0, 1 << 30).numpy(),
        r[rows.numpy()])


# ------------------------------------------------------------ split scan

@pytest.mark.parametrize("with_cat", [False, True])
def test_find_best_splits_extra_trees_bit_equal(with_cat):
    """One random threshold a (slot, numeric feature), both scan
    directions, categorical features untouched: every field bit-equal to
    the JAX package's scan; the port's slots in another order with
    ``draw_rows`` naming each slot's row of the reference's draw give the
    same splits in that order."""
    jds, tds, hist, pg, ph, pc = _case()
    S = hist.shape[0]
    cat = tsplit.CatParams(min_data_per_group=5, cat_smooth=1.0)
    base = dict(lambda_l1=0.0, lambda_l2=1.0, min_data_in_leaf=5,
                min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
    jkw = cat._asdict() if with_cat else {"enable_categorical": False}
    j = jsplit.find_best_splits(
        jnp.asarray(hist), jnp.asarray(pg), jnp.asarray(ph), jnp.asarray(pc),
        jds.device_data().layout, **base, **jkw,
        extra_key=jax.random.PRNGKey(4))
    plain = jsplit.find_best_splits(
        jnp.asarray(hist), jnp.asarray(pg), jnp.asarray(ph), jnp.asarray(pc),
        jds.device_data().layout, **base, **jkw)
    perm = np.random.RandomState(0).permutation(S)
    t = torch.as_tensor
    got = tsplit.find_best_splits(
        t(hist[perm]), t(pg[perm]), t(ph[perm]), t(pc[perm]),
        tds.device_data().layout, **base, cat=cat if with_cat else None,
        extra_key=(0, 4), draw_rows=t(perm))
    assert got.feat_ok is None and j.feat_ok is None
    for name in tsplit.SplitResult._fields[:-1]:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(j, name))[perm],
                                      err_msg=name)
    assert not np.array_equal(np.asarray(j.threshold),
                              np.asarray(plain.threshold))


# -------------------------------------------------------------- training

_MODES = {
    "bynode": {"feature_fraction_bynode": 0.5},
    "extra": {"extra_trees": True},
    "both": {"feature_fraction_bynode": 0.6, "extra_trees": True},
}


@pytest.mark.parametrize("mode,backend", [
    ("bynode", "stream"), ("extra", "stream"), ("both", "stream"),
    ("both", "scatter"), ("both", "pallas")])
def test_dyadic_training_byte_identical_to_jax(mode, backend):
    """Two trees of 31 leaves at a split budget of 8 (the draw rows of a
    round: its 8 split leaves, then its 8 new leaves, whatever the live
    pairs): the JAX package's model text byte for byte, and other trees
    than without the draws."""
    params = {**_BASE, **_MODES[mode], "hist_backend": backend}
    tb = _train(lt, params)
    text = _trees_text(tb.model_to_string())
    assert text == _trees_text(_train(lgb, params).model_to_string())
    plain = _train(lt, {**_BASE, "hist_backend": backend})
    assert text != _trees_text(plain.model_to_string())
    assert not tb.engine.grow_params.plain_growth


def test_draw_rows_follow_the_reference_block(monkeypatch):
    """Every scan of a round of P live pairs reads row i for the split
    leaf of pair i and row ``budget + i`` for its new leaf, some round with
    fewer pairs than its budget of 8; the root reads row 0."""
    seen = []
    scan = tgrow.find_best_splits

    def spy(*a, **k):
        seen.append(k["draw_rows"].tolist())
        return scan(*a, **k)

    monkeypatch.setattr(tgrow, "find_best_splits", spy)
    _train(lt, {**_BASE, **_MODES["extra"], "hist_backend": "stream"},
           iters=1)
    assert seen[0] == [0]
    pairs = [len(r) // 2 for r in seen[1:]]
    for P, r in zip(pairs, seen[1:]):
        assert r == list(range(P)) + list(range(8, 8 + P))
    assert max(pairs) == 8 and any(0 < P < 8 for P in pairs)


def test_sprint_schedule_with_bagging_byte_identical():
    """A budget of 100 on 200 leaves under bagging: the budget-64 prefix
    (its rows at 64 + i), the full rounds, the route-only sprint, on
    compacted rows, byte-identical to the JAX package."""
    params = {**_BASE, **_MODES["both"], "num_leaves": 200,
              "max_splits_per_round": 100, "min_data_in_leaf": 2,
              "hist_backend": "stream", "bagging_fraction": 0.5,
              "bagging_freq": 1}
    data = _sampled_data(1500, 5)
    tb = _train(lt, params, data=data)
    jb = _train(lgb, params, data=data)
    assert _trees_text(tb.model_to_string()) == \
        _trees_text(jb.model_to_string())
    assert tb.engine.last_compact_rows > 0
    assert min(t.num_leaves for t in tb.engine.models) > 64


@pytest.mark.parametrize("backend", ["stream", "scatter"])
def test_multiclass_byte_identical(backend):
    """K = 3 class trees, each with its own key (``iter * (K + 1) + k``),
    grown one class at a time (no lockstep: ``plain_growth`` is off)."""
    params = {**_BASE, **_MODES["both"], "objective": "multiclass",
              "num_class": 3, "learning_rate": 0.5, "hist_backend": backend}
    data = _mc_data(600, 1)
    tb = _train(lt, params, data=data, fobj=_dyadic_mc_fobj)
    jb = _train(lgb, params, data=data, fobj=_dyadic_mc_fobj)
    assert _trees_text(tb.model_to_string()) == \
        _trees_text(jb.model_to_string())
    assert not tb.engine._use_batched_multiclass()
    assert not jb.engine._mc_batched_last


@pytest.mark.parametrize("extra", [
    {}, {"data_sample_strategy": "goss", "num_leaves": 127,
         "max_splits_per_round": 64}], ids=["plain", "goss-sprint"])
def test_fused_equals_eager(extra):
    """One class tree with both draws fuses (the device-state grower,
    its key and round counter in device tensors) with the eager text."""
    X, y = _sampled_data(2000, 7)
    p = {"objective": "binary", "num_leaves": 31, "max_splits_per_round": 8,
         "max_bin": 63, "min_data_in_leaf": 5, "verbosity": -1,
         **_MODES["both"], **extra, **CPU}
    texts = []
    for fused in ("off", "on"):
        b = lt.train({**p, "fused_iter": fused},
                     lt.Dataset(X, label=y, params=p), 4)
        texts.append(_trees_text(b.model_to_string()))
        assert b.engine._fused == (fused == "on")
    assert texts[0] == texts[1]


def test_reset_to_extra_trees_retrains():
    """``reset_parameter({"extra_trees": True})`` after two trees: the
    next trees draw their thresholds (other trees than without the reset),
    as the JAX package's do after the same reset once its grow-key gate is
    set again (its ``reset_parameter`` keeps the gate of construction,
    ROADMAP §3), and the fused path drops its graphs and growers."""
    data = _sampled_data(1000, 5)
    texts = []
    for pkg, reset in ((lt, True), (lgb, True), (lt, False)):
        bst = _train(pkg, {**_BASE, "hist_backend": "stream"}, data=data)
        if reset:
            bst.reset_parameter({"extra_trees": True})
            if pkg is lgb:
                bst.engine._needs_grow_key = True
        for _ in range(2):
            bst.update(fobj=_dyadic_fobj)
        texts.append(_trees_text(bst.model_to_string()))
    assert texts[0] == texts[1] != texts[2]
    X, y = _sampled_data(800, 2)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "fused_iter": "on", **CPU}
    b = lt.train(p, lt.Dataset(X, label=y, params=p), 2)
    growers = dict(b.engine._fused_growers)
    b.reset_parameter({"extra_trees": True})
    assert not b.engine._fused_growers and b.engine.grow_params.extra_trees
    b.update()
    assert b.engine._fused_growers and \
        list(b.engine._fused_growers.values())[0] is not \
        list(growers.values())[0]


def test_extra_seed_parsed_and_written():
    """``extra_seed`` is a Config field (default 6) in both packages,
    parsed from a string, kept by the alias resolution, written into the
    model's parameters as the JAX package writes it; it seeds the draws
    (``extra_seed`` 0 takes 3, as in the reference)."""
    for cfg in (TConfig.from_params({"extra_seed": "17"}),
                JConfig.from_params({"extra_seed": "17"})):
        assert cfg.extra_seed == 17
    assert TConfig().extra_seed == JConfig().extra_seed == 6
    assert resolve_aliases({"extra_seed": 17}) == {"extra_seed": 17}
    data = _sampled_data(600, 5)
    texts = {}
    for seed in (6, 17, 0, 3):
        params = {**_BASE, **_MODES["extra"], "hist_backend": "stream",
                  "extra_seed": seed}
        tb = _train(lt, params, iters=1, data=data)
        text = tb.model_to_string()
        if seed == 17:
            jb = _train(lgb, params, iters=1, data=data)
            jtext = jb.model_to_string()
            assert "\n[extra_seed: 17]\n" in text.split("parameters:")[1]
            assert "\n[extra_seed: 17]\n" in jtext.split("parameters:")[1]
            assert _trees_text(text) == _trees_text(jtext)
        texts[seed] = _trees_text(text)
    assert texts[6] != texts[17] and texts[0] == texts[3]
