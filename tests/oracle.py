"""NumPy oracle: straight re-implementation of the reference forward math.

Follows the C++ loops literally (TNetLib/*.cc) so device implementations can
be validated allclose against it — the test pattern SURVEY.md §4 prescribes
(the CPU implementation is the oracle for the accelerated one).
"""

import numpy as np


def expand(x, offsets):
    T, D = x.shape
    y = np.empty((T, D * len(offsets)), dtype=x.dtype)
    for r in range(T):
        for i, off in enumerate(offsets):
            ro = min(max(r + off, 0), T - 1)
            y[r, i * D:(i + 1) * D] = x[ro]
    return y


def transpose_perm(n, context):
    channels = n // context
    perm = []
    for ch in range(channels):
        perm.extend(range(ch, n, channels))
    return perm


def gather_cols(x, indices):
    return x[:, list(indices)]


def window(x, w):
    return x * w[None, :]


def bias(x, b):
    return x + b[None, :]


def block_linearity(x, block):
    bi, bo = block.shape
    k = x.shape[1] // bi
    y = np.empty((x.shape[0], k * bo), dtype=x.dtype)
    for i in range(k):
        y[:, i * bo:(i + 1) * bo] = x[:, i * bi:(i + 1) * bi] @ block
    return y


def biased_linearity(x, w, b):
    return x @ w + b[None, :]


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def softmax(x):
    m = x.max(axis=1, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=1, keepdims=True)


def forward_network(net, x, dtype=np.float32):
    """Forward a parsed nnet_asr_tpu Network with NumPy using the oracle ops,
    in ``dtype`` (float64 makes it the reference for float32 devices)."""
    from nnet_asr_tpu.models import components as C

    x = np.asarray(x, dtype=dtype)
    for spec, p in zip(net.specs, net.params):
        if isinstance(spec, C.Expand):
            x = expand(x, spec.offsets)
        elif isinstance(spec, C.Transpose):
            x = gather_cols(x, transpose_perm(spec.n_inputs, spec.context))
        elif isinstance(spec, C.Copy):
            x = gather_cols(x, spec.indices)
        elif isinstance(spec, C.Window):
            x = window(x, np.asarray(p["window"]))
        elif isinstance(spec, C.Bias):
            x = bias(x, np.asarray(p["bias"]))
        elif isinstance(spec, C.BlockLinearity):
            x = block_linearity(x, np.asarray(p["block"]))
        elif isinstance(spec, C.BiasedLinearity):
            x = biased_linearity(x, np.asarray(p["weight"]), np.asarray(p["bias"]))
        elif isinstance(spec, C.Sigmoid):
            x = sigmoid(x)
        elif isinstance(spec, C.Softmax):
            x = softmax(x)
        elif isinstance(spec, C.Log):
            x = np.log(x)
        else:
            raise NotImplementedError(f"oracle: {spec.tag}")
    return x


def cross_entropy_eval(net_out, target):
    """CrossEntropy::Evaluate (ObjFun.cc:76-160): returns (err, xent, corr)."""
    err = net_out - target
    corr = int((net_out.argmax(axis=1) == target.argmax(axis=1)).sum())
    xent = 0.0
    for r in range(net_out.shape[0]):
        tmax = target[r].argmax()
        if target[r, tmax] == 1.0:
            val = np.log(net_out[r, tmax])
            xent += max(val, -1e10)
        else:
            for c in range(net_out.shape[1]):
                if target[r, c] != 0.0:
                    xent += max(target[r, c] * np.log(net_out[r, c]), -1e10)
    return err, -xent, corr
