"""Mesh (data-parallel) parity for the auxiliary trainers: RBM CD-1,
recurrent segment-scan, and the MPE error-backprop step (every trainer
a mesh user can reach needs multi-chip correctness evidence, not just
the frame-CE family)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nnet_asr_tpu.models import (BiasedLinearity, Network, Rbm, RbmSparse,
                                 Recurrent, Sigmoid, Softmax)
from nnet_asr_tpu.models.components import BERNOULLI, GAUSSIAN
from nnet_asr_tpu.parallel.mesh import make_mesh
from nnet_asr_tpu.parallel.sharded_aux import (make_sharded_cd1_step,
                                               make_sharded_mpe_step)
from nnet_asr_tpu.train.rbm import (RbmTrainConfig, init_rbm_state,
                                    make_cd1_step)
from nnet_asr_tpu.train.sgd import SgdConfig, apply_updates, init_momentum, \
    layer_lr_factors


def _rbm_setup(rng, spec_cls=Rbm, vis=GAUSSIAN, hid=BERNOULLI,
               n_vis=24, n_hid=32):
    spec = spec_cls(n_vis, n_hid, vis_type=vis, hid_type=hid)
    params = {
        "weight": (0.1 * rng.standard_normal((n_vis, n_hid))).astype(np.float32),
        "vis_bias": np.zeros(n_vis, np.float32),
        "hid_bias": np.zeros(n_hid, np.float32),
    }
    return spec, params


@pytest.mark.parametrize("spec_cls,vis,hid", [
    (Rbm, GAUSSIAN, BERNOULLI),     # the gauss-bern first layer
    (Rbm, BERNOULLI, BERNOULLI),    # bern-bern stack layers
    (Rbm, BERNOULLI, GAUSSIAN),     # gaussian hidden sampling path
    (RbmSparse, GAUSSIAN, BERNOULLI),  # sparsity-Q update
])
def test_sharded_cd1_matches_single_chip(spec_cls, vis, hid):
    """Same key + global-shape noise -> the sharded CD-1 reproduces the
    single-chip sampled trajectory (reduction-order tolerance only)."""
    rng = np.random.default_rng(0)
    spec, params = _rbm_setup(rng, spec_cls, vis, hid)
    cfg = RbmTrainConfig(learning_rate=0.1, momentum=0.5, weightcost=2e-4)

    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_s = init_rbm_state(spec, ref_p, cfg)
    ref_step = make_cd1_step(spec, cfg)

    mesh = make_mesh(data=4, model=2)
    sh_step = make_sharded_cd1_step(spec, cfg, mesh)
    sh_p = {k: jnp.asarray(v) for k, v in params.items()}
    sh_s = init_rbm_state(spec, sh_p, cfg)

    key = jax.random.PRNGKey(7)
    with jax.default_matmul_precision("highest"):
        for i in range(3):
            key, sub = jax.random.split(key)
            bunch = jnp.asarray(
                rng.standard_normal((32, spec.n_inputs)).astype(np.float32))
            ref_p, ref_s, ref_mse = ref_step(ref_p, ref_s, sub, bunch)
            sh_p, sh_s, sh_mse = sh_step(sh_p, sh_s, sub, bunch)
    for k in ref_p:
        np.testing.assert_allclose(np.asarray(sh_p[k]), np.asarray(ref_p[k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)
    for k in ref_s:
        np.testing.assert_allclose(np.asarray(sh_s[k]), np.asarray(ref_s[k]),
                                   rtol=2e-4, atol=1e-6, err_msg=f"state {k}")
    assert abs(float(sh_mse) - float(ref_mse)) < 1e-2 * max(float(ref_mse), 1)


def _mlp(rng, din=16, dh=32, dout=24):
    specs = (BiasedLinearity(din, dh), Sigmoid(dh, dh),
             BiasedLinearity(dh, dout), Softmax(dout, dout))
    params = [
        {"weight": (0.1 * rng.standard_normal((din, dh))).astype(np.float32),
         "bias": np.zeros(dh, np.float32)}, {},
        {"weight": (0.1 * rng.standard_normal((dh, dout))).astype(np.float32),
         "bias": np.zeros(dout, np.float32)}, {},
    ]
    return Network(specs, params)


def test_sharded_mpe_step_matches_single_chip():
    """Frame-sharded surrogate backprop == tools/tmpe.py's single-chip
    update (sum over frames commutes with the shard psum)."""
    rng = np.random.default_rng(1)
    net = _mlp(rng)
    sgd_cfg = SgdConfig(learning_rate=0.05, weightcost=1e-4,
                        grad_div_frm=True)
    factors = tuple(layer_lr_factors(net, sgd_cfg))
    body_specs = net.specs[:-1]

    def forward(params, x):
        for spec, p in zip(body_specs, params):
            x = spec.apply(p, x)
        return x

    def ref_update(params, velocity, feats, err, n):
        def surrogate(params):
            return jnp.sum(forward(params, feats) * err)
        grads = jax.grad(surrogate)(params)
        return apply_updates(net, params, velocity, grads, sgd_cfg, n,
                             factors)

    ref_p = [{k: jnp.asarray(v) for k, v in p.items()} for p in net.params]
    ref_v = init_momentum(net, sgd_cfg.momentum, None)

    mesh = make_mesh(data=8, model=1)
    fwd, upd = make_sharded_mpe_step(net, sgd_cfg, mesh)
    sh_p = [dict(p) for p in ref_p]
    sh_v = init_momentum(net, sgd_cfg.momentum, None)

    with jax.default_matmul_precision("highest"):
        for it in range(3):
            feats = jnp.asarray(
                rng.standard_normal((48, 16)).astype(np.float32))
            err = jnp.asarray(
                (0.1 * rng.standard_normal((48, 24))).astype(np.float32))
            # forward parity (the posterior fetch path)
            lp_ref = jax.nn.log_softmax(forward(ref_p, feats), axis=-1)
            lp_sh = fwd(sh_p, feats)
            np.testing.assert_allclose(np.asarray(lp_sh), np.asarray(lp_ref),
                                       rtol=1e-5, atol=1e-6)
            ref_p, ref_v = ref_update(ref_p, ref_v, feats, err,
                                      jnp.float32(40))
            sh_p, sh_v = upd(sh_p, sh_v, feats, err, jnp.float32(40))
    for i in (0, 2):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(
                np.asarray(sh_p[i][k]), np.asarray(ref_p[i][k]),
                rtol=2e-4, atol=1e-6, err_msg=f"layer {i} {k}")


def _recurrent_net(rng, din=8, dr=12, dout=5):
    specs = (BiasedLinearity(din, dr), Sigmoid(dr, dr),
             Recurrent(dr, dr), BiasedLinearity(dr, dout),
             Softmax(dout, dout))
    params = [
        {"weight": (0.3 * rng.standard_normal((din, dr))).astype(np.float32),
         "bias": np.zeros(dr, np.float32)}, {},
        {"weight": (0.3 * rng.standard_normal((2 * dr, dr))).astype(np.float32),
         "bias": np.zeros(dr, np.float32)},
        {"weight": (0.3 * rng.standard_normal((dr, dout))).astype(np.float32),
         "bias": np.zeros(dout, np.float32)}, {},
    ]
    return Network(specs, params)


@pytest.mark.parametrize("n_utts", [8, 5])   # 5: exercises batch padding
def test_sharded_recurrent_matches_single_chip(n_utts):
    from nnet_asr_tpu.train.recurrent import (RecurrentTrainer,
                                              RecurrentTrainerConfig)

    rng = np.random.default_rng(3)
    net = _recurrent_net(rng)
    cfg = RecurrentTrainerConfig(
        bptt_order=3,
        sgd=SgdConfig(learning_rate=0.1, momentum=0.5, weightcost=1e-4,
                      grad_div_frm=True))

    feats = [rng.standard_normal((t, 8)).astype(np.float32)
             for t in rng.integers(10, 30, n_utts)]
    labels = [rng.integers(0, 5, f.shape[0]).astype(np.int32) for f in feats]

    ref = RecurrentTrainer(
        Network(net.specs, [dict(p) for p in net.params]), cfg)
    mesh = make_mesh(data=4, model=2)
    sh = RecurrentTrainer(
        Network(net.specs, [dict(p) for p in net.params]), cfg, mesh=mesh)

    with jax.default_matmul_precision("highest"):
        ref.train_batch(feats, labels)
        sh.train_batch(feats, labels)
    for i in (0, 2, 3):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(
                np.asarray(sh.params[i][k]), np.asarray(ref.params[i][k]),
                rtol=3e-4, atol=1e-6, err_msg=f"layer {i} {k}")
    assert sh.stats.frames == ref.stats.frames
    assert sh.stats.corr == ref.stats.corr
    assert abs(sh.stats.error - ref.stats.error) < 1e-3 * max(
        abs(ref.stats.error), 1.0)


def test_sharded_recurrent_rejects_frame_serial():
    from nnet_asr_tpu.train.recurrent import (RecurrentTrainer,
                                              RecurrentTrainerConfig)

    rng = np.random.default_rng(4)
    net = _recurrent_net(rng)
    cfg = RecurrentTrainerConfig(frame_serial=True)
    with pytest.raises(ValueError, match="frame_serial"):
        RecurrentTrainer(net, cfg, mesh=make_mesh(data=8, model=1))
