"""Learning to rank in the port against the JAX package, on the CPU.

The same numpy inputs go through ``lightgbm_tpu`` and ``lightgbm_torch``
(``device_type="cpu"``: the kernels' plain versions; the JAX stream kernel
in Pallas interpret mode).

Tolerances and why:

- Query buckets, 1/maxDCG, contiguous spans, bagging-by-query masks and
  XE-NDCG's per-iteration draws: host numpy or the counter-based uniform
  draw, bit-equal.
- Lambdarank and XE-NDCG gradients: float32 in both packages, with pair
  sums taken in another order and torch's ``sigmoid`` / ``log2`` /
  ``softmax`` against XLA's: held to |a - b| <= 4e-6 * max(1, max |b|)
  (``_close``; measured at most 2.4e-6 on gradients up to 2.8 here, and
  1.6e-7 of the largest gradient on 20 000 documents in queries of up to
  400).  Against the float64 pair loop of the reference
  (rank_objective.hpp:180) by the same rule (the JAX package's own test
  holds its formulation to 2e-6 on smaller pair sums).  Position biases
  after three Newton steps: atol 1e-6, on scores without ties (an ulp in
  a bias reorders two tied documents, a real change of their pair); the
  gradients after a bias step within 2.5e-5 of their scale
  (``chip_smoke.POS_BIAS_STEP_RTOL``: the biases' last bits shift every
  score, and ``lambdarank_norm``'s 1 / (0.01 + |s_i - s_j|) weighs a
  near-tied pair's shift by up to 100; measured 1.0e-5 on 20 000
  documents).
- NDCG@k and MAP@k: the same float64 numpy arithmetic, rtol 1e-12.
- Training on real lambdas: the first tree identical in structure to the
  JAX stream backend's (whose histograms round the weights to bfloat16),
  training NDCG@5 after 5 iterations within 0.01 of the JAX package's.
- ``fused_iter`` on against off in the port: the same torch ops, so the
  model text is byte-identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu import metrics as jm
from lightgbm_tpu import ranking as jr
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.models.sample_strategy import (
    create_sample_strategy as j_create_sample_strategy)
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch import metrics as tm
from lightgbm_torch import ranking as tr
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.convert import booster_from_arrays
from lightgbm_torch.models.sample_strategy import (
    create_sample_strategy as t_create_sample_strategy)

import chip_smoke
from test_ranking import _brute_lambdarank
from test_torch_train import _structure

CPU = {"device_type": "cpu"}


def _close(got, want, rtol=4e-6):
    """Gradients within ``rtol`` of the reference's scale (at least 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rtol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, f"max abs difference {err} > {tol}"


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)


def _ragged(seed=0, nq=40, f=6):
    """Ragged queries (sizes 1 to 70, several buckets and the generic
    gather path), grades 0-4 driven by two features, one all-zero-label
    query, single-document queries."""
    rs = np.random.RandomState(seed)
    sizes = np.concatenate([rs.randint(2, 40, nq - 4), [1, 70, 1, 5]])
    n = int(sizes.sum())
    X = rs.randn(n, f)
    rel = X[:, 0] * 2.0 + X[:, 1] + 0.5 * rs.randn(n)
    y = np.clip(np.round(rel + 2), 0, 4)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    y[qb[3]:qb[4]] = 0
    return X, y, sizes


def _uniform(seed=1, nq=20, size=12, f=4):
    rs = np.random.RandomState(seed)
    sizes = np.full(nq, size)
    n = nq * size
    X = rs.randn(n, f)
    y = np.clip(np.round(X[:, 0] + 2 + 0.5 * rs.randn(n)), 0, 4)
    return X, y, sizes


def _qb(sizes):
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


# ----------------------------------------------------------------- buckets

@pytest.mark.parametrize("data", [_ragged, _uniform])
def test_bucketize_and_spans_equal_jax(data):
    _, y, sizes = data()
    qb = _qb(sizes)
    gain = jr.default_label_gain(31)
    for trunc in (1, 30):
        jb = jr._bucketize(qb, y, gain, trunc)
        tb = tr._bucketize(qb, y, tr.default_label_gain(31), trunc)
        assert tb.sizes == jb.sizes
        for name in ("doc_index", "inv_max_dcg", "query_ids"):
            for a, b in zip(getattr(tb, name), getattr(jb, name)):
                np.testing.assert_array_equal(a, b)
        assert [tr._contiguous_span(ix) for ix in tb.doc_index] == \
            [jr._contiguous_span(ix) for ix in jb.doc_index]
    # spans (nq, 2) give the same starts and sizes
    spans = np.stack([qb[:-1], sizes], axis=1)
    for a, b in zip(tr.query_spans(spans), jr.query_spans(spans)):
        np.testing.assert_array_equal(a, b)
    if data is _uniform:
        assert tr._contiguous_span(tb.doc_index[0]) == (0, 12)


# --------------------------------------------------------------- gradients

def _objectives(params, y, sizes, w=None, pos=None, cls="LambdarankNDCG"):
    p = {"objective": "lambdarank", **params}
    jo = getattr(jr, cls)(JConfig.from_params(p))
    to = getattr(tr, cls)(TConfig.from_params(p))
    n = len(y)
    jo.init(y, w, query_boundaries=_qb(sizes), position=pos, n=n)
    to.init(y, w, query_boundaries=_qb(sizes), position=pos, n=n)
    return jo, to


def _pair_loop(score, y, sizes, params, w=None):
    """The float64 pair loop of the reference, query by query."""
    trunc = params.get("lambdarank_truncation_level", 30)
    gain = tr.default_label_gain(31)
    g, h = np.zeros(len(y)), np.zeros(len(y))
    qb = _qb(sizes)
    for a, b in zip(qb[:-1], qb[1:]):
        gq = gain[y[a:b].astype(int)]
        md = np.sort(gq)[::-1][:trunc].dot(
            1 / np.log2(np.arange(2, 2 + min(trunc, b - a))))
        imd = 1.0 / md if md > 0 else 0.0
        g[a:b], h[a:b] = _brute_lambdarank(
            score[a:b].astype(np.float64), y[a:b], gq, imd,
            params.get("sigmoid", 1.0), params.get("lambdarank_norm", True),
            trunc)
    if w is not None:
        g, h = g * w, h * w
    return g, h


@pytest.mark.parametrize("params,scores,weighted", [
    ({}, "ties", False),
    ({}, "zero", False),
    ({"lambdarank_norm": False}, "ties", True),
    ({"lambdarank_truncation_level": 1}, "ties", False),
    ({"lambdarank_truncation_level": 500, "sigmoid": 2.5}, "random", True),
], ids=["norm", "zero_scores", "no_norm_weighted", "trunc_1",
        "trunc_past_m_sigmoid_2p5"])
def test_lambdarank_gradients_match_jax_and_pair_loop(params, scores,
                                                       weighted):
    X, y, sizes = _ragged()
    rs = np.random.RandomState(5)
    n = len(y)
    score = {"ties": np.round(rs.randn(n) * 2, 1),
             "zero": np.zeros(n),
             "random": rs.randn(n)}[scores].astype(np.float32)
    w = rs.rand(n) + 0.5 if weighted else None
    jo, to = _objectives(params, y, sizes, w)
    jg, jh = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
    tg, th = (a.numpy() for a in to.get_gradients(torch.as_tensor(score)))
    _close(tg, jg)
    _close(th, jh)
    pg, ph = _pair_loop(score, y, sizes, params, w)
    _close(tg, pg)
    _close(th, ph)
    # single-document and all-equal-label queries have no pair
    qb = _qb(sizes)
    for q in (3, len(sizes) - 4, len(sizes) - 2):
        assert not tg[qb[q]:qb[q + 1]].any()
        assert not th[qb[q]:qb[q + 1]].any()


def test_chunked_bucket_equals_one_chunk():
    """A bucket's queries split into chunks (the card's main path runs
    17 024 queries in 4) give the one-chunk gradients bit for bit."""
    _, y, sizes = _ragged(nq=60)
    to = _objectives({}, y, sizes)[1]
    rs = np.random.RandomState(9)
    score = torch.as_tensor(np.round(rs.randn(len(y)), 1), dtype=torch.float32)
    (b, *_) = sorted(to._device_buckets(torch.device("cpu")),
                     key=lambda b: -b.idx.shape[0])
    assert b.idx.shape[0] > 7 and b.span is None
    args = (tr._bucket_scores(score, b), b.lab, b.valid, b.inv, b.gain,
            b.disc, 1.0, True, 30)
    whole = tr._lambdarank_bucket(*args)
    for chunk in (1, 3, 7):
        for a, c in zip(tr._lambdarank_bucket(*args, chunk=chunk), whole):
            assert torch.equal(a, c)


@pytest.mark.parametrize("params", [{}, {
    "lambdarank_truncation_level": 1,
    "lambdarank_position_bias_regularization": 0.5}],
    ids=["default", "trunc_1_regularized"])
def test_position_bias_matches_jax_after_three_steps(params):
    _, y, sizes = _ragged()
    rs = np.random.RandomState(6)
    n = len(y)
    pos = rs.randint(0, 6, n)
    score = (rs.randn(n) * 2).astype(np.float32)
    jo, to = _objectives(params, y, sizes, pos=pos)
    for step in range(3):
        jg, jh = (np.asarray(a) for a in jo.get_gradients(
            jnp.asarray(score)))
        tg, th = (a.numpy() for a in to.get_gradients(
            torch.as_tensor(score)))
        rtol = 4e-6 if step == 0 else chip_smoke.POS_BIAS_STEP_RTOL
        _close(tg, jg, rtol)
        _close(th, jh, rtol)
    assert np.abs(np.asarray(jo.pos_biases)).max() > 1e-3
    np.testing.assert_allclose(to.pos_biases.numpy(),
                               np.asarray(jo.pos_biases), rtol=0, atol=1e-6)


def test_xendcg_draws_bit_identical_and_gradients_match():
    _, y, sizes = _ragged()
    rs = np.random.RandomState(7)
    n = len(y)
    w = rs.rand(n) + 0.5
    jo, to = _objectives({"objective": "rank_xendcg", "objective_seed": 9},
                         y, sizes, w, cls="RankXENDCG")
    assert not to.jit_safe_gradients
    for step in range(2):
        score = rs.randn(n).astype(np.float32)
        jg, jh = (np.asarray(a) for a in jo.get_gradients(
            jnp.asarray(score)))
        tg, th = (a.numpy() for a in to.get_gradients(
            torch.as_tensor(score)))
        _close(tg, jg)
        _close(th, jh)
        # the host generators drew the same gammas and stand at one state
        js, ts = jo._rng.get_state(), to._rng.get_state()
        assert js[2] == ts[2] and np.array_equal(js[1], ts[1])


def test_label_past_label_gain_raises():
    _, y, sizes = _ragged()
    cfg = TConfig.from_params({"objective": "lambdarank",
                               "label_gain": "0,1,3"})
    assert cfg.label_gain == [0.0, 1.0, 3.0]
    with pytest.raises(lt.LightGBMError, match="label_gain"):
        tr.LambdarankNDCG(cfg).init(y, None, _qb(sizes), n=len(y))
    with pytest.raises(lt.LightGBMError, match="group"):
        tr.LambdarankNDCG(TConfig()).init(y, None, n=len(y))
    with pytest.raises(lt.LightGBMError, match="sum of"):
        tr.LambdarankNDCG(TConfig()).init(y, None, _qb(sizes[1:]),
                                          n=len(y))


# ------------------------------------------------------- bagging by query

def test_bagging_by_query_masks_equal_jax():
    _, y, sizes = _ragged()
    n, n_pad = len(y), 256 * (-(-len(y) // 256))
    p = {"bagging_fraction": 0.5, "bagging_freq": 2, "bagging_by_query": True}
    js = j_create_sample_strategy(JConfig.from_params(p), n_pad, _qb(sizes),
                                  None)
    ts = t_create_sample_strategy(TConfig.from_params(p), n_pad, None,
                                  torch.device("cpu"), _qb(sizes))
    seen = set()
    for it in range(6):
        jmask = np.asarray(js.epoch_mask(it))
        tmask = ts.epoch_mask(it).numpy()
        np.testing.assert_array_equal(tmask, jmask)
        assert not tmask[n:].any()
        qb = _qb(sizes)
        for a, b in zip(qb[:-1], qb[1:]):
            assert len(set(tmask[a:b])) == 1   # a query in or out whole
        seen.add(tmask.tobytes())
    assert len(seen) == 3                      # one mask per epoch


# ----------------------------------------------------------------- metrics

@pytest.mark.parametrize("metric,eval_at", [("ndcg", None), ("ndcg", [1, 3, 10]),
                                            ("map", [2, 5])])
def test_ranking_metrics_equal_jax(metric, eval_at):
    rs = np.random.RandomState(8)
    for data in (_ragged, _uniform):
        _, y, sizes = data()
        score = np.round(rs.randn(len(y)), 1)
        p = {"metric": metric, "eval_at": eval_at}
        (j,) = jm.create_metrics(JConfig.from_params(p), "lambdarank")
        (t,) = tm.create_metrics(TConfig.from_params(p), "lambdarank")
        j.init(y, None, _qb(sizes))
        t.init(y, None, _qb(sizes))
        got, want = t.evaluate(score, None), j.evaluate(score, None)
        assert [(a, c) for a, _, c in got] == [(a, c) for a, _, c in want]
        np.testing.assert_allclose([v for _, v, _ in got],
                                   [v for _, v, _ in want], rtol=1e-12)
    (d,) = tm.create_metrics(TConfig(), "rank_xendcg")
    assert d.name == "ndcg"


# ---------------------------------------------------------------- training

_PARAMS = {"objective": "lambdarank", "num_leaves": 15, "max_bin": 63,
           "min_data_in_leaf": 5, "verbosity": -1, "eval_at": [5]}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's stream backend on the ragged queries, 5
    iterations, training and validation NDCG@5 recorded."""
    before, jsk._INTERPRET = jsk._INTERPRET, True
    try:
        X, y, sizes = _ragged(seed=2, nq=80)
        Xv, yv, sv = _ragged(seed=3, nq=30)
        ev = {}
        ds = lgb.Dataset(X, label=y, group=sizes)
        bst = lgb.train({**_PARAMS, "hist_backend": "stream"}, ds, 5,
                        valid_sets=[ds, lgb.Dataset(Xv, label=yv, group=sv,
                                                    reference=ds)],
                        valid_names=["training", "valid"],
                        callbacks=[lgb.record_evaluation(ev)])
    finally:
        jsk._INTERPRET = before
    return (X, y, sizes, Xv, yv, sv), bst, ev


def _port_train(data, extra=None, iters=5, ev=None):
    X, y, sizes, Xv, yv, sv = data
    p = {**_PARAMS, **CPU, **(extra or {})}
    ds = lt.Dataset(X, label=y, group=sizes, params=p)
    vs = lt.Dataset(Xv, label=yv, group=sv, reference=ds)
    cbs = [] if ev is None else [lt.record_evaluation(ev)]
    return lt.train(p, ds, iters, valid_sets=[ds, vs],
                    valid_names=["training", "valid"], callbacks=cbs)


def test_lambdarank_training_matches_jax_stream(jax_run):
    data, jb, jev = jax_run
    ev = {}
    tb = _port_train(data, ev=ev)
    assert tb.engine.objective.name == "lambdarank"
    assert _structure(tb.engine.models[0]) == _structure(jb.engine.models[0])
    for name in ("training", "valid"):
        got, want = ev[name]["ndcg@5"], jev[name]["ndcg@5"]
        assert len(got) == len(want) == 5
        np.testing.assert_allclose(got, want, rtol=0, atol=0.01)
    assert ev["training"]["ndcg@5"][-1] > ev["training"]["ndcg@5"][0]
    # the validation NDCG the engine recorded is the metric's on predict
    X, y, sizes, Xv, yv, sv = data
    (m,) = tm.create_metrics(TConfig.from_params(_PARAMS), "lambdarank")
    m.init(yv, None, _qb(sv))
    (_, v, _), = m.evaluate(tb.predict(Xv), None)
    assert v == ev["valid"]["ndcg@5"][-1]


def test_jax_saved_lambdarank_model_predicts_the_same(jax_run, tmp_path):
    (X, y, sizes, Xv, _, _), jb, _ = jax_run
    path = tmp_path / "rank.txt"
    jb.save_model(str(path))
    want = np.asarray(jb.predict(Xv))
    loaded = lt.Booster(model_file=str(path))
    assert "objective=lambdarank" in loaded.model_to_string().splitlines()
    np.testing.assert_allclose(loaded.predict(Xv), want, rtol=1e-12,
                               atol=1e-12)
    ds = lt.Dataset(X, label=y, group=sizes, params={**_PARAMS, **CPU})
    served = lt.train({**_PARAMS, **CPU}, ds, 0, init_model=str(path))
    np.testing.assert_allclose(served.predict(Xv), want, rtol=1e-12,
                               atol=1e-12)
    carried = booster_from_arrays(
        [dataclasses.asdict(t) for t in jb.engine.models],
        lt.Dataset(X, label=y, group=sizes, params=CPU), {**_PARAMS, **CPU})
    np.testing.assert_allclose(carried.predict(Xv), want, rtol=1e-12,
                               atol=1e-12)


def _fused_text(bst):
    return "\n".join(line for line in bst.model_to_string().splitlines()
                     if not line.startswith("[fused_iter:"))


@pytest.mark.parametrize("extra", [
    {},
    {"position": True, "lambdarank_position_bias_regularization": 0.1},
    {"bagging_by_query": True, "bagging_fraction": 0.5, "bagging_freq": 1},
    {"use_quantized_grad": True, "num_grad_quant_bins": 64},
], ids=["lambdarank", "position_bias", "bagging_by_query", "quantized"])
def test_fused_on_off_byte_identical(jax_run, extra):
    (X, y, sizes, _, _, _), _, _ = jax_run
    extra = dict(extra)
    pos = (np.random.RandomState(4).randint(0, 8, len(y))
           if extra.pop("position", False) else None)
    texts, objectives = [], []
    for fused in ("on", "off"):
        p = {**_PARAMS, **CPU, **extra, "fused_iter": fused}
        bst = lt.train(p, lt.Dataset(X, label=y, group=sizes, position=pos,
                                     params=p), 4)
        assert bst.engine._fused == (fused == "on")
        texts.append(_fused_text(bst))
        objectives.append(bst.engine.objective)
    assert texts[0] == texts[1]
    assert texts[0].count("Tree=") == 4
    if pos is not None:
        assert torch.equal(objectives[0].pos_biases, objectives[1].pos_biases)
        assert objectives[0].pos_biases.abs().max() > 0


def test_xendcg_map_and_bagging_train_eager(jax_run):
    """rank_xendcg (eager: a host draw every iteration) with MAP on a
    validation set and bagging by query; nothing raises "not yet ported"."""
    data, _, _ = jax_run
    ev = {}
    bst = _port_train(data, {"objective": "rank_xendcg", "metric": "map",
                             "eval_at": [3], "fused_iter": "on",
                             "bagging_by_query": True,
                             "bagging_fraction": 0.7, "bagging_freq": 1},
                      iters=3, ev=ev)
    assert not bst.engine._fused
    assert bst.num_trees() == 3
    assert list(ev["valid"]) == ["map@3"] and len(ev["valid"]["map@3"]) == 3
    assert "objective=rank_xendcg" in bst.model_to_string()
