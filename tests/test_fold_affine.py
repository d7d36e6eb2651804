"""Folding linear feature transforms into one splice+affine op."""

import numpy as np
import jax.numpy as jnp

from nnet_asr_tpu.ops.fold_affine import fold_transform
from nnet_asr_tpu.models import Network


def test_fold_affine_matches_layered(example01):
    net = Network.read(str(example01 / "lib" / "Hamm_dct_norm"))
    folded = fold_transform(net)
    assert folded is not None
    sa, M, c = folded
    assert sa.offsets == tuple(range(-25, 26))
    assert M.shape == (1173, 598)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((80, 23)).astype(np.float32)
    got = np.asarray(sa.apply(M, c, jnp.asarray(x)))
    want = np.asarray(net.forward(x))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_fold_affine_rejects_nonlinear():
    from nnet_asr_tpu.models import Sigmoid, BiasedLinearity
    net = Network((BiasedLinearity(4, 4), Sigmoid(4, 4)),
                  [{"weight": np.eye(4, dtype=np.float32),
                    "bias": np.zeros(4, np.float32)}, {}])
    assert fold_transform(net) is None
