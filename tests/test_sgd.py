"""SGD update-rule tests: L2 weight decay applies to weight MATRICES only.

Both reference backends decay the linearity and leave the bias alone:
the GPU update's "regularization weight decay (from actual weights only)"
touches just mLinearity (cuBiasedLinearity.cc:58-64), and the CPU
row-striped update decays tgt_mat (the weight stripe) while the bias
update is a plain AddScaled with no decay term (BiasedLinearity.cc:159-170).
train/sgd.py cites this file for that claim; the second test proves it
against the built reference binary itself.
"""

import os
import subprocess

import numpy as np
import pytest

from nnet_asr_tpu.models import BiasedLinearity, Network, Sigmoid, Softmax
from nnet_asr_tpu.train.sgd import (SgdConfig, apply_updates, init_momentum,
                                    layer_lr_factors)

REF_TNET = "/tmp/refsrc/TNet"


def _tiny_net(rng):
    w1 = (0.1 * rng.standard_normal((6, 8))).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(8)).astype(np.float32)
    w2 = (0.1 * rng.standard_normal((8, 5))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(5)).astype(np.float32)
    specs = (BiasedLinearity(6, 8), Sigmoid(8, 8),
             BiasedLinearity(8, 5), Softmax(5, 5))
    params = [{"weight": w1, "bias": b1}, {}, {"weight": w2, "bias": b2}, {}]
    return Network(specs, params)


@pytest.mark.parametrize("grad_div_frm", [False, True])
def test_l2_decays_matrices_not_biases(grad_div_frm):
    """With zero gradients and nonzero weightcost, one update step must
    scale every weight matrix by exactly (1 - lr*wc*scale) and leave
    every bias bit-identical (scale = bunch frames unless GRADDIVFRM,
    matching BiasedLinearity.cc:159-163 / cuBiasedLinearity.cc:58-64)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    net = _tiny_net(rng)
    lr, wc, n_frames = 0.05, 0.2, 16
    cfg = SgdConfig(learning_rate=lr, momentum=0.0, weightcost=wc,
                    grad_div_frm=grad_div_frm)
    params = [{k: jnp.asarray(v) for k, v in p.items()} for p in net.params]
    vel = init_momentum(net, cfg.momentum)
    zero_g = [{k: jnp.zeros_like(v) for k, v in p.items()} for p in params]
    new_p, _ = apply_updates(net, params, vel, zero_g, cfg, n_frames,
                             layer_lr_factors(net, cfg))

    scale = 1.0 if grad_div_frm else float(n_frames)
    factor = 1.0 - lr * wc * scale
    for i in (0, 2):
        np.testing.assert_allclose(np.asarray(new_p[i]["weight"]),
                                   np.asarray(params[i]["weight"]) * factor,
                                   rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(new_p[i]["bias"]),
                                      np.asarray(params[i]["bias"]))


@pytest.mark.skipif(not os.path.exists(REF_TNET),
                    reason="reference TNet not built (run "
                           "scripts/parity_vs_reference.sh first)")
def test_l2_bias_untouched_in_reference_binary(tmp_path, example01):
    """Run the reference CPU TNet for exactly ONE bunch, with weightcost 0
    vs 0.05. The two output models must have bit-identical biases (no L2
    on mBias) while every weight differs by exactly the decay factor
    (1 - lr*wc*bunchsize) — the direct binary-level proof of the claim in
    train/sgd.py."""
    from nnet_asr_tpu.io import htk

    # sub-SCP totalling one bunch (960..1919 trainable frames): the cache
    # trains one 960-frame bunch and discards the rest (Cache.cc:239-244),
    # so the wc=0 and wc>0 runs see identical gradients. Raw HTK frame
    # counts ARE the trainable counts: STARTFRMEXT/ENDFRMEXT extend the
    # splice context by EDGE REPLICATION (Features.cc:1185-1192, mirrored
    # in io/htk.py), they do not consume utterance frames — every raw
    # frame emits one training row, whatever the bundled file sizes.
    frm_ext = 25
    total, lines = 0, []
    for line in (example01 / "lib" / "test.scp").read_text().split():
        n = htk.read_htk_file(str(example01 / line))[0].shape[0]
        if total + n >= 1920:
            continue
        lines.append(line)
        total += n
        if total >= 960:
            break
    assert 960 <= total < 1920
    scp = tmp_path / "one_bunch.scp"
    scp.write_text("".join(f"{example01}/{l}\n" for l in lines))

    init = tmp_path / "init.mmf"
    subprocess.run(
        ["python", "-m", "nnet_asr_tpu.tools.gen_mlp_init",
         "--dim=598:64:135", "--gauss", "--negbias", "--seed=41"],
        check=True, stdout=init.open("w"),
        env={**os.environ, "PYTHONPATH": "/root/repo"})

    lr, wc, bunch = 0.008, 0.05, 960
    outs = {}
    for tag, cost in (("wc0", 0.0), ("wc", wc)):
        out = tmp_path / f"out_{tag}.mmf"
        subprocess.run(
            [REF_TNET, "-T", "00", "-H", str(init), "--THREADS=1",
             "-S", str(scp), "-I", str(example01 / "lib" / "test_3s.mlf"),
             "-L", "*/", "-X", "lab",
             "-m", str(example01 / "lib" / "mono_state_phn_set_135_phn"),
             "-n", str(lr), f"--WEIGHTCOST={cost}",
             f"--BUNCHSIZE={bunch}", f"--CACHESIZE={bunch}",
             "--RANDOMIZE=FALSE",
             f"--FEATURETRANSFORM={example01}/lib/Hamm_dct_norm",
             f"--STARTFRMEXT={frm_ext}", f"--ENDFRMEXT={frm_ext}",
             f"--TARGETMMF={out}"],
            check=True, capture_output=True, cwd=str(example01))
        outs[tag] = Network.read(str(out))

    factor = 1.0 - lr * wc * bunch
    checked = 0
    for p0, p1 in zip(outs["wc0"].params, outs["wc"].params):
        if "weight" not in p0:
            continue
        np.testing.assert_array_equal(p1["bias"], p0["bias"])
        # tolerance = ASCII-MMF print precision (6-7 significant digits),
        # far below the 0.384 decay this asserts
        np.testing.assert_allclose(p1["weight"], p0["weight"] * factor,
                                   rtol=3e-5, atol=1e-7)
        checked += 1
    assert checked == 2


def test_bf16_velocity_mode_tracks_f32_and_stores_bf16():
    """SgdConfig(velocity_dtype='bf16') is an opt-in perf mode:
    velocity is STORED bf16 but the momentum math runs in f32 on the
    upcast state, so a few steps stay close to the exact f32-velocity
    trajectory; params remain f32. Default (None) is the
    reference's f32 semantics (cuBiasedLinearity.cc:44-63)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    net = _tiny_net(rng)
    n_frames = 16
    trajs = {}
    for vdt in (None, "bf16"):
        cfg = SgdConfig(learning_rate=0.05, momentum=0.9, grad_div_frm=True,
                        velocity_dtype=vdt)
        params = [{k: jnp.asarray(v) for k, v in p.items()}
                  for p in net.params]
        vel = init_momentum(net, cfg.momentum, cfg.velocity_dtype)
        if vdt == "bf16":
            assert vel[0]["weight"].dtype == jnp.bfloat16
        else:
            assert vel[0]["weight"].dtype == jnp.float32
        grng = np.random.default_rng(3)
        for _ in range(5):
            g = [{k: jnp.asarray((0.1 * grng.standard_normal(v.shape))
                                 .astype(np.float32))
                  for k, v in p.items()} for p in params]
            params, vel = apply_updates(net, params, vel, g, cfg, n_frames,
                                        layer_lr_factors(net, cfg))
        assert params[0]["weight"].dtype == jnp.float32
        if vdt == "bf16":
            assert vel[0]["weight"].dtype == jnp.bfloat16
        trajs[vdt] = params
    for i in (0, 2):
        for k in ("weight", "bias"):
            a = np.asarray(trajs[None][i][k], np.float32)
            b = np.asarray(trajs["bf16"][i][k], np.float32)
            # bf16 has ~3 decimal digits; 5 steps of rounding stay small
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4)


def test_velocity_dtype_validation():
    with pytest.raises(ValueError):
        SgdConfig(velocity_dtype="fp8")
