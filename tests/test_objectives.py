"""CE objective and the affine+sigmoid layer pair against float64 NumPy."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nnet_asr_tpu.models import BiasedLinearity, Sigmoid
from nnet_asr_tpu.ops.objectives import xent_loss_and_stats


def _log_softmax64(z):
    z = z - z.max(axis=1, keepdims=True)
    return z - np.log(np.exp(z).sum(axis=1, keepdims=True))


def _xent_oracle(logits, labels):
    """(loss, clamped xent, correct, d loss / d logits) in float64."""
    z = logits.astype(np.float64)
    logp = _log_softmax64(z)
    picked = logp[np.arange(len(labels)), labels]
    onehot = np.eye(z.shape[1])[labels]
    pred = np.argmax(z, axis=1)                  # first max wins
    return (-picked.sum(), -np.maximum(picked, -1e10).sum(),
            int((pred == labels).sum()), np.exp(logp) - onehot)


@pytest.mark.parametrize("n_classes", [39, 135, 8192])
def test_xent_loss_and_stats_matches_float64_oracle(n_classes):
    rng = np.random.default_rng(n_classes)
    B = 64
    logits = (3 * rng.standard_normal((B, n_classes))).astype(np.float32)
    labels = rng.integers(0, n_classes, B).astype(np.int32)
    # the clamp: the label's posterior underflows, log y < -1e10
    logits[0] = 0.0
    logits[0, labels[0]] = -1e12
    # first-max-wins: a tie between columns 3 and 5, label on the second
    logits[1] = -5.0
    logits[1, [3, 5]] = 4.0
    labels[1] = 5
    logits[2] = -5.0
    logits[2, [3, 5]] = 4.0
    labels[2] = 3

    (loss, stats), g = jax.value_and_grad(
        xent_loss_and_stats, has_aux=True)(
            jnp.asarray(logits), jnp.asarray(labels))
    want_loss, want_xent, want_corr, want_g = _xent_oracle(logits, labels)

    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(stats["xent"]), want_xent, rtol=1e-5)
    assert float(stats["xent"]) < float(loss)        # row 0 was clamped
    assert int(stats["correct"]) == want_corr
    assert int(stats["frames"]) == B
    np.testing.assert_allclose(np.asarray(g), want_g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,n_in,n_out", [(32, 24, 16), (96, 598, 135)])
def test_affine_sigmoid_vjp_matches_numpy(B, n_in, n_out):
    rng = np.random.default_rng(B)
    x = rng.standard_normal((B, n_in)).astype(np.float32)
    w = (0.1 * rng.standard_normal((n_in, n_out))).astype(np.float32)
    b = rng.standard_normal(n_out).astype(np.float32)
    g = rng.standard_normal((B, n_out)).astype(np.float32)
    bl, sg = BiasedLinearity(n_in, n_out), Sigmoid(n_out, n_out)

    def f(x, w, b):
        return sg.apply({}, bl.apply({"weight": w, "bias": b}, x))

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(g))

    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    y64 = 1 / (1 + np.exp(-(x64 @ w64 + b)))
    dz = g * y64 * (1 - y64)
    np.testing.assert_allclose(np.asarray(y), y64, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dx), dz @ w64.T, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(dw), x64.T @ dz, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(db), dz.sum(0), rtol=1e-4,
                               atol=1e-5)
