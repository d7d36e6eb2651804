"""Fold linear feature-transform networks into a single splice+affine op.

The reference's input transforms (expand → transpose → window →
blocklinearity → bias → window, CRBEDctFeat.h) are all *linear* in the
spliced input, so the whole chain collapses to

    y[t] = concat(x[t+o] for o in offsets) @ M + c

with one (k·D_in, D_out) matrix. This turns six elementwise/gather ops
+ a blocked matmul into a single matmul per frame tile for the frontend
hot spot (the reference's ``T-fe`` phase, TNetCu.cc:377-420).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from ..models import components as C
from ..models.network import Network


@dataclass(frozen=True)
class SpliceAffine:
    """y[t] = splice(x)[t] @ weight + bias with edge-clamped offsets."""

    offsets: Tuple[int, ...]        # () means no splicing (identity context)
    in_dim: int

    def apply(self, weight: jnp.ndarray, bias: jnp.ndarray,
              x: jnp.ndarray) -> jnp.ndarray:
        spliced = C.Expand(self.in_dim, self.in_dim * max(len(self.offsets), 1),
                           offsets=self.offsets or (0,)).apply({}, x)
        return spliced @ weight + bias


def fold_transform(net: Optional[Network]):
    """Try to fold a transform network into (SpliceAffine, weight, bias).

    Returns None if the network contains nonlinear or unsupported layers,
    or more than one <expand>. Supported: Expand, Copy, Transpose, Window,
    Bias, BlockLinearity, BiasedLinearity, SharedLinearity.
    """
    if net is None or not net.specs:
        return None

    offsets: Tuple[int, ...] = ()
    in_dim = net.specs[0].n_inputs
    dim = in_dim
    # running affine state: y = x_spliced @ M + c
    M: Optional[np.ndarray] = None
    c: Optional[np.ndarray] = None

    def ensure(width):
        nonlocal M, c
        if M is None:
            M = np.eye(width, dtype=np.float64)
            c = np.zeros(width, dtype=np.float64)

    for spec, p in zip(net.specs, net.params):
        if isinstance(spec, C.Expand):
            if M is not None or offsets:
                return None        # expand must be first (and unique)
            offsets = spec.offsets
            dim = spec.n_outputs
            ensure(dim)
        elif isinstance(spec, (C.Copy, C.Transpose)):
            ensure(dim)
            idx = (np.asarray(spec.indices) if isinstance(spec, C.Copy)
                   else np.asarray(spec._perm()))
            M = M[:, idx]
            c = c[idx]
            dim = len(idx)
        elif isinstance(spec, C.Window):
            ensure(dim)
            w = np.asarray(p["window"], dtype=np.float64)
            M = M * w[None, :]
            c = c * w
        elif isinstance(spec, C.Bias):
            ensure(dim)
            c = c + np.asarray(p["bias"], dtype=np.float64)
        elif isinstance(spec, C.BlockLinearity):
            ensure(dim)
            blk = np.asarray(p["block"], dtype=np.float64)
            k = dim // blk.shape[0]
            big = np.zeros((dim, k * blk.shape[1]))
            for i in range(k):
                big[i * blk.shape[0]:(i + 1) * blk.shape[0],
                    i * blk.shape[1]:(i + 1) * blk.shape[1]] = blk
            M = M @ big
            c = c @ big
            dim = k * blk.shape[1]
        elif isinstance(spec, C.BiasedLinearity):
            ensure(dim)
            w = np.asarray(p["weight"], dtype=np.float64)
            b = np.asarray(p["bias"], dtype=np.float64)
            c = c @ w + b
            M = M @ w
            dim = w.shape[1]
        elif isinstance(spec, C.SharedLinearity):
            ensure(dim)
            w = np.asarray(p["weight"], dtype=np.float64)
            b = np.asarray(p["bias"], dtype=np.float64)
            k = spec.n_instances
            big = np.zeros((dim, k * w.shape[1]))
            bigb = np.tile(b, k)
            for i in range(k):
                big[i * w.shape[0]:(i + 1) * w.shape[0],
                    i * w.shape[1]:(i + 1) * w.shape[1]] = w
            M = M @ big
            c = c @ big + bigb
            dim = k * w.shape[1]
        else:
            return None

    if M is None:
        return None
    sa = SpliceAffine(offsets=offsets, in_dim=in_dim)
    return sa, jnp.asarray(M.astype(np.float32)), jnp.asarray(c.astype(np.float32))
