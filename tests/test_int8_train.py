"""Quantized-training modes of the frame trainer (int8 fake-quant STE)."""

import numpy as np

from nnet_asr_tpu.models import Network


def test_int8_fake_quant_training_mode():
    """TrainerConfig(compute_dtype='int8') trains through the fake-quant
    STE forward: gradients are nonzero (straight-through), params move,
    and one step stays close to the f32 step (int8 has ~2 decimal
    digits)."""
    from nnet_asr_tpu.train.sgd import SgdConfig
    from nnet_asr_tpu.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(2)
    from nnet_asr_tpu.models import BiasedLinearity, Sigmoid, Softmax
    specs = (BiasedLinearity(10, 16), Sigmoid(16, 16),
             BiasedLinearity(16, 6), Softmax(6, 6))
    P = [{"weight": (0.3 * rng.standard_normal((10, 16))).astype(np.float32),
          "bias": np.zeros(16, np.float32)}, {},
         {"weight": (0.3 * rng.standard_normal((16, 6))).astype(np.float32),
          "bias": np.zeros(6, np.float32)}, {}]
    X = rng.standard_normal((64, 10)).astype(np.float32)
    y = rng.integers(0, 6, 64).astype(np.int32)

    outs = {}
    for dt in (None, "int8"):
        cfg = TrainerConfig(bunchsize=32, cachesize=64, randomize=False,
                            sgd=SgdConfig(learning_rate=0.05),
                            compute_dtype=dt)
        tr = Trainer(Network(specs, [dict(p) for p in P]), cfg)
        tr.run_epoch(iter([(X, y)]))
        outs[dt] = np.asarray(tr.params[0]["weight"])
    # params moved under int8 (STE gradient is not zero)
    assert np.abs(outs["int8"] - P[0]["weight"]).max() > 1e-5
    # and the step tracks the f32 step to quantization precision
    step_f32 = np.abs(outs[None] - P[0]["weight"]).max()
    diff = np.abs(outs["int8"] - outs[None]).max()
    assert diff < 20 * step_f32


def test_int8pfsr_stochastic_rounding_mode():
    """compute_dtype='int8pfsr': stochastic rounding on the per-frame activation quantizer during
    training. Training must (a) differ from deterministic int8pf, (b) be
    reproducible for a fixed seed, (c) advance the noise stream across
    caches, and (d) keep evaluation deterministic (round-to-nearest)."""
    from nnet_asr_tpu.train.sgd import SgdConfig
    from nnet_asr_tpu.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(5)
    from nnet_asr_tpu.models import BiasedLinearity, Sigmoid, Softmax
    specs = (BiasedLinearity(10, 16), Sigmoid(16, 16),
             BiasedLinearity(16, 6), Softmax(6, 6))
    P = [{"weight": (0.3 * rng.standard_normal((10, 16))).astype(np.float32),
          "bias": np.zeros(16, np.float32)}, {},
         {"weight": (0.3 * rng.standard_normal((16, 6))).astype(np.float32),
          "bias": np.zeros(6, np.float32)}, {}]
    X = rng.standard_normal((64, 10)).astype(np.float32)
    y = rng.integers(0, 6, 64).astype(np.int32)

    def run(dt, seed=9):
        cfg = TrainerConfig(bunchsize=32, cachesize=64, randomize=False,
                            seed=seed, sgd=SgdConfig(learning_rate=0.05),
                            compute_dtype=dt)
        tr = Trainer(Network(specs, [dict(p) for p in P]), cfg)
        # two caches: the SR key must advance across drains
        tr.run_epoch(iter([(X, y), (X, y)]))
        return tr

    w_pf = np.asarray(run("int8pf").params[0]["weight"])
    tr_sr = run("int8pfsr")
    w_sr = np.asarray(tr_sr.params[0]["weight"])
    w_sr2 = np.asarray(run("int8pfsr").params[0]["weight"])

    assert not np.array_equal(w_sr, w_pf)          # SR actually fired
    np.testing.assert_array_equal(w_sr, w_sr2)     # seeded reproducible
    # noise advanced across the two caches: key changed from the seed
    import jax.random
    k0 = jax.random.PRNGKey(9)
    assert not np.array_equal(np.asarray(tr_sr._sr_key), np.asarray(k0))
    # SR stays close to the deterministic trajectory (unbiased rounding)
    assert np.abs(w_sr - w_pf).max() < 0.05

    # evaluation is deterministic: same crossval twice, identical stats
    cfg_cv = TrainerConfig(bunchsize=32, cachesize=64, randomize=False,
                           crossvalidate=True, compute_dtype="int8pfsr")
    evals = []
    for _ in range(2):
        tr = Trainer(Network(specs, [dict(p) for p in tr_sr.params]),
                     cfg_cv)
        tr.run_epoch(iter([(X, y)]))
        evals.append((tr.stats.error, tr.stats.corr))
    assert evals[0] == evals[1]

    # resident-style interleaving: a TRAIN trainer's eval drains consume
    # donated accs that carry the SR key — the key must survive repeated
    # _zero_acc/_drain_eval rounds (regression: 'Array has been deleted')
    import jax.numpy as jnp
    fa = jnp.asarray(np.stack([X[:32], X[32:]]))
    la = jnp.asarray(np.stack([y[:32], y[32:]]))
    for _ in range(3):
        acc = tr_sr._zero_acc()
        acc = tr_sr._drain_eval(tr_sr.params, acc, fa, la)
    acc = tr_sr._zero_acc()
    tr_sr.params, tr_sr.velocity, acc = tr_sr._drain_train(
        tr_sr.params, tr_sr.velocity, acc, fa, la, tr_sr._lr)
    assert np.isfinite(float(acc["xent"]))
