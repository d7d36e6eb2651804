"""RBM CD-1 and recurrent-trainer tests."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import oracle
from nnet_asr_tpu.models import Network, Rbm, RbmSparse, Recurrent, BiasedLinearity, Softmax
from nnet_asr_tpu.train.rbm import (RbmTrainConfig, RbmTrainer,
                                    apply_rbm_update, init_rbm_state,
                                    make_cd1_step)
from nnet_asr_tpu.train.recurrent import (RecurrentTrainer,
                                          RecurrentTrainerConfig)
from nnet_asr_tpu.train.sgd import SgdConfig


def _rbm(rng, nv=10, nh=8, cls=Rbm, **kw):
    spec = cls(nv, nh, **kw)
    params = {
        "weight": (0.1 * rng.standard_normal((nv, nh))).astype(np.float32),
        "vis_bias": np.zeros(nv, np.float32),
        "hid_bias": np.zeros(nh, np.float32),
    }
    return spec, {k: jnp.asarray(v) for k, v in params.items()}


def test_rbm_update_matches_hinton_recipe():
    rng = np.random.default_rng(0)
    spec, params = _rbm(rng)
    cfg = RbmTrainConfig(learning_rate=0.1, momentum=0.5, weightcost=2e-4)
    state = init_rbm_state(spec, params, cfg)
    B = 16
    pos_vis = rng.random((B, 10)).astype(np.float32)
    pos_hid = rng.random((B, 8)).astype(np.float32)
    neg_vis = rng.random((B, 10)).astype(np.float32)
    neg_hid = rng.random((B, 8)).astype(np.float32)

    # two updates to exercise momentum
    p, s = params, state
    for _ in range(2):
        p, s = apply_rbm_update(spec, cfg, p, s,
                                jnp.asarray(pos_vis), jnp.asarray(pos_hid),
                                jnp.asarray(neg_vis), jnp.asarray(neg_hid))

    # NumPy oracle (cuRbm.cc:131-174)
    w = np.asarray(params["weight"]).copy()
    vb = np.zeros(10, np.float32); hb = np.zeros(8, np.float32)
    vhc = np.zeros_like(w); vbc = np.zeros_like(vb); hbc = np.zeros_like(hb)
    lr, mmt, wc, N = 0.1, 0.5, 2e-4, float(B)
    for _ in range(2):
        vhc = mmt * vhc + lr / N * (pos_vis.T @ pos_hid - neg_vis.T @ neg_hid) - lr * wc * w
        w = w + vhc
        vbc = mmt * vbc + lr / N * (pos_vis.sum(0) - neg_vis.sum(0))
        vb = vb + vbc
        hbc = mmt * hbc + lr / N * (pos_hid.sum(0) - neg_hid.sum(0))
        hb = hb + hbc
    np.testing.assert_allclose(np.asarray(p["weight"]), w, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(p["vis_bias"]), vb, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(p["hid_bias"]), hb, rtol=1e-5, atol=1e-7)


def test_rbm_sparse_update_pushes_activity_down():
    rng = np.random.default_rng(1)
    spec, params = _rbm(rng, cls=RbmSparse)
    cfg = RbmTrainConfig(learning_rate=0.0, momentum=0.0, weightcost=0.0,
                         sparsity_cost=0.1, sparsity_prior=0.01,
                         sparsity_lambda=0.0)
    state = init_rbm_state(spec, params, cfg)
    B = 4
    pos_hid = jnp.full((B, 8), 0.9)   # far above the prior
    z10 = jnp.ones((B, 10)); z8 = pos_hid
    p, s = apply_rbm_update(spec, cfg, params, state, z10, z8 * 0 + pos_hid,
                            z10, z8)
    # hidden bias pushed down toward prior activity
    assert float(jnp.max(p["hid_bias"])) < 0
    np.testing.assert_allclose(np.asarray(s["sparsity_q"]), 0.9, rtol=1e-5)


def test_cd1_reduces_reconstruction_error():
    rng = np.random.default_rng(2)
    spec, params = _rbm(rng, nv=12, nh=16)
    cfg = RbmTrainConfig(learning_rate=0.2, momentum=0.5, weightcost=2e-4)
    state = init_rbm_state(spec, params, cfg)
    step = make_cd1_step(spec, cfg)
    # structured binary data
    base = (rng.random((4, 12)) > 0.5).astype(np.float32)
    data = base[rng.integers(0, 4, 256)]
    key = jax.random.PRNGKey(0)
    mses = []
    for ep in range(60):
        key, sub = jax.random.split(key)
        params, state, mse = step(params, state, sub, jnp.asarray(data))
        mses.append(float(mse))
    assert np.mean(mses[-5:]) < 0.6 * np.mean(mses[:5])


def test_gaussian_visible_rbm():
    rng = np.random.default_rng(3)
    spec, params = _rbm(rng, cls=Rbm, vis_type="gauss")
    cfg = RbmTrainConfig(learning_rate=0.001, momentum=0.0)
    state = init_rbm_state(spec, params, cfg)
    step = make_cd1_step(spec, cfg)
    data = rng.standard_normal((64, 10)).astype(np.float32)
    p, s, mse = step(params, state, jax.random.PRNGKey(1), jnp.asarray(data))
    assert np.isfinite(float(mse))


def test_rbm_trainer_rbg_rng():
    """rng_impl='rbg' (the counter-generator mode, trbm
    --RNGIMPL=rbg) drives the same CD-1 trainer to a finite, moving
    trajectory; unknown impls are rejected."""
    from nnet_asr_tpu.train.rbm import RbmTrainer

    rng = np.random.default_rng(5)
    spec, params = _rbm(rng, cls=Rbm, vis_type="gauss")
    w0 = np.asarray(params["weight"]).copy()
    tr = RbmTrainer(spec, params,
                    RbmTrainConfig(learning_rate=0.01, rng_impl="rbg"),
                    bunchsize=16, cachesize=64, seed=3, randomize=False)
    rows = jnp.asarray(rng.standard_normal((64, 10)).astype(np.float32))
    tr.ingest_block(rows, 64)
    assert tr.frames == 64
    assert not np.array_equal(np.asarray(tr.params["weight"]), w0)
    assert np.isfinite(np.asarray(tr.params["weight"]).sum())

    with pytest.raises(ValueError, match="rng_impl"):
        RbmTrainer(spec, params, RbmTrainConfig(rng_impl="bogus"))


def _recurrent_net(rng, din=4, dh=6, dout=3):
    specs = (Recurrent(din, dh), BiasedLinearity(dh, dout),
             Softmax(dout, dout))
    params = [
        {"weight": (0.3 * rng.standard_normal((din + dh, dh))).astype(np.float32),
         "bias": np.zeros(dh, np.float32)},
        {"weight": (0.3 * rng.standard_normal((dh, dout))).astype(np.float32),
         "bias": np.zeros(dout, np.float32)},
        {},
    ]
    return Network(specs, params)


def _toy_sequences(rng, n=12, T=40, din=4, dout=3):
    """Label = index of the input channel active a few frames ago."""
    utts = []
    for _ in range(n):
        x = np.zeros((T, din), np.float32)
        ch = rng.integers(0, dout, T)
        x[np.arange(T), ch] = 1.0
        labels = np.roll(ch, 1); labels[0] = ch[0]
        utts.append((x, labels.astype(np.int32)))
    return utts


def test_recurrent_trainer_learns():
    rng = np.random.default_rng(4)
    net = _recurrent_net(rng)
    cfg = RecurrentTrainerConfig(
        bptt_order=4, sgd=SgdConfig(learning_rate=0.5, grad_div_frm=True))
    tr = RecurrentTrainer(net, cfg)
    utts = _toy_sequences(rng)
    accs = []
    for epoch in range(8):
        tr.stats = type(tr.stats)()
        tr.run_epoch(iter(utts))
        accs.append(tr.stats.accuracy)
    assert accs[-1] > accs[0] + 10.0, accs


def _serial_oracle(net, utts, K, lr, momentum):
    """NumPy re-derivation of the reference frame-serial trajectory
    (TRecurrentCu.cc:357-371 + cuRecurrent.cc:86-153): per-frame updates,
    BPTT-K history walk, weight correction without momentum but bias
    correction carrying momentum across frames, mmt_gain on the linear
    layer."""
    W = np.asarray(net.params[0]["weight"], np.float64).copy()
    b = np.asarray(net.params[0]["bias"], np.float64).copy()
    W2 = np.asarray(net.params[1]["weight"], np.float64).copy()
    b2 = np.asarray(net.params[1]["bias"], np.float64).copy()
    vW2 = np.zeros_like(W2)
    vb2 = np.zeros_like(b2)
    din = net.specs[0].n_inputs
    dout = W2.shape[1]
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))
    mmt_gain = 1.0 / (1.0 - momentum) if momentum else 1.0
    # the output buffer Y and the bias-correction accumulator persist
    # across utterances: ClearHistory zeroes only the history ring
    # (cuRecurrent.h:36-38); CuMatrix::Init is a no-op on same dims so
    # Y keeps the previous frame's output (cumatrix.tcc:18-23)
    y_prev = np.zeros_like(b)
    B = np.zeros_like(b)
    for x_utt, l_utt in utts:
        hist = np.zeros((K + 1, W.shape[0]))
        for x, lbl in zip(x_utt, l_utt):
            h_in = np.concatenate([x, y_prev])
            hist = np.vstack([h_in[None], hist[:-1]])
            y = sig(h_in @ W + b)
            y_prev = y
            z = y @ W2 + b2
            p = np.exp(z - z.max()); p /= p.sum()
            e_out = p.copy(); e_out[lbl] -= 1.0       # err = y - t
            # error to recurrent output with pre-update W2
            e_y = e_out @ W2.T
            # linear layer update (CuBiasedLinearity, n_frames=1,
            # grad_div_frm False)
            if momentum:
                vW2 = np.outer(y, e_out) + momentum * vW2
                vb2 = e_out + momentum * vb2
                W2 = W2 - (lr / mmt_gain) * vW2
                b2 = b2 - (lr / mmt_gain) * vb2
            else:
                W2 = W2 - lr * np.outer(y, e_out)
                b2 = b2 - lr * e_out
            # recurrent update
            d = e_y * y * (1.0 - y)
            corr = np.outer(hist[0], d)
            B = momentum * B - lr * d
            Wh = W[din:]
            for i in range(1, K + 1):
                e_part = d @ Wh.T
                y_hist = hist[i - 1, din:]
                d = e_part * y_hist * (1.0 - y_hist)
                corr = corr + np.outer(hist[i], d)
                B = B - lr * d
            W = W - lr * corr
            b = b + B
    return W, b, W2, b2


@pytest.mark.parametrize("momentum", [0.0, 0.3])
def test_frame_serial_matches_reference_oracle(momentum):
    rng = np.random.default_rng(6)
    net = _recurrent_net(rng)
    K, lr = 3, 0.2
    cfg = RecurrentTrainerConfig(
        bptt_order=K, frame_serial=True,
        sgd=SgdConfig(learning_rate=lr, momentum=momentum,
                      grad_div_frm=False))
    tr = RecurrentTrainer(net, cfg)
    utts = _toy_sequences(rng, n=2, T=40)
    for x, l in utts:
        tr.train_utterance_serial(x, l)
    W, b, W2, b2 = _serial_oracle(net, utts, K, lr, momentum)
    np.testing.assert_allclose(np.asarray(tr.params[0]["weight"]), W,
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(tr.params[0]["bias"]), b,
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(tr.params[1]["weight"]), W2,
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(tr.params[1]["bias"]), b2,
                               rtol=2e-4, atol=2e-5)
    assert tr.stats.frames == 80


def test_recurrent_crossvalidate_no_update():
    rng = np.random.default_rng(5)
    net = _recurrent_net(rng)
    cfg = RecurrentTrainerConfig(bptt_order=4, crossvalidate=True)
    tr = RecurrentTrainer(net, cfg)
    utts = _toy_sequences(rng, n=3)
    tr.run_epoch(iter(utts))
    np.testing.assert_allclose(np.asarray(tr.params[0]["weight"]),
                               np.asarray(net.params[0]["weight"]))
    assert tr.stats.frames == 3 * 40


def test_recurrent_batched_mode_learns():
    """batch_utts > 1 (batched truncated BPTT) also learns the toy task."""
    rng = np.random.default_rng(8)
    net = _recurrent_net(rng)
    cfg = RecurrentTrainerConfig(
        bptt_order=4, sgd=SgdConfig(learning_rate=0.5, grad_div_frm=True))
    tr = RecurrentTrainer(net, cfg)
    utts = _toy_sequences(rng)
    accs = []
    for epoch in range(8):
        tr.stats = type(tr.stats)()
        tr.run_epoch(iter(utts), batch_utts=4)
        accs.append(tr.stats.accuracy)
    assert accs[-1] > accs[0] + 10.0, accs
