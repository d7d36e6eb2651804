"""SGD with the reference's exact update semantics.

Unifies the CPU trainer (TNetLib/BiasedLinearity.cc:131-178: plain
``W -= lr * grad_sum`` + L2 decay scaled by bunch frames) and the GPU
trainer (CuTNetLib/cuBiasedLinearity.cc:44-63: momentum with
``mmt_gain = 1/(1-momentum)`` normalization, optional grad/frames, L2 from
live weights, L1 for sparse layers) into one functional optimizer over the
network's param pytree. The CPU semantics are momentum=0, grad_div_frm=False.

Per-layer learning-rate factors follow CuNetwork::SetLearnRate
(cuNetwork.cc:80-134): a ``0.1:0.5:1.0`` list maps to *updatable* layers in
order; factor 0 freezes a layer (the reference additionally stops backprop
below the first live layer — pure optimization, same math).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..models.components import SparseLinearity
from ..models.network import Network


@dataclass(frozen=True)
class SgdConfig:
    learning_rate: float = 0.008
    momentum: float = 0.0
    weightcost: float = 0.0    # L2
    l1: float = 0.0
    grad_div_frm: bool = True
    # per-updatable-layer lr factors, e.g. (0.1, 0.5, 1.0); None = all 1.0
    lr_factors: Optional[Tuple[float, ...]] = None
    # Velocity STORAGE dtype: None = f32 (the reference's exact GPU
    # semantics, cuBiasedLinearity.cc:44-63) | 'bf16' (opt-in perf mode:
    # halves the velocity read+write HBM traffic that dominates the
    # momentum-mode step; the momentum math still runs
    # in f32 on the upcast velocity, only the carried state is rounded).
    velocity_dtype: Optional[str] = None

    def __post_init__(self):
        if self.velocity_dtype not in (None, "bf16"):
            raise ValueError(
                f"velocity_dtype must be None or 'bf16', got {self.velocity_dtype!r}")

    @staticmethod
    def parse_factors(s: Optional[str]) -> Optional[Tuple[float, ...]]:
        if not s:
            return None
        return tuple(float(v) for v in s.replace(",", ":").split(":"))


def layer_lr_factors(net: Network, cfg: SgdConfig) -> List[float]:
    """Factor per component (non-updatable layers get 0)."""
    factors = []
    k = 0
    for spec in net.specs:
        if spec.updatable:
            if cfg.lr_factors is not None:
                if k >= len(cfg.lr_factors):
                    raise ValueError("Too few learning-rate factors for network")
                factors.append(cfg.lr_factors[k])
            else:
                factors.append(1.0)
            k += 1
        else:
            factors.append(0.0)
    if cfg.lr_factors is not None and k != len(cfg.lr_factors):
        raise ValueError(
            f"Learning-rate factor count {len(cfg.lr_factors)} != updatable layers {k}")
    return factors


def init_momentum(net: Network, momentum: float = 1.0,
                  dtype: Optional[str] = None) -> List[dict]:
    """Zero velocity buffers for every trainable parameter.

    With momentum == 0 no buffers are allocated (the reference CPU trainer
    has none either) — saves a full parameter-sized read+write per step.
    ``dtype='bf16'`` stores velocity in bfloat16 (SgdConfig.velocity_dtype).
    """
    if momentum == 0.0:
        return [{} for _ in net.specs]
    vdt = jnp.bfloat16 if dtype == "bf16" else None
    out = []
    for spec, p in zip(net.specs, net.params):
        out.append({k: jnp.zeros_like(v, dtype=vdt) for k, v in p.items()
                    if k in spec.trainable_keys})
    return out


def apply_updates(net: Network, params: List[dict], velocity: List[dict],
                  grads: List[dict], cfg: SgdConfig, n_frames: jnp.ndarray,
                  factors: Sequence[float],
                  learning_rate: Optional[jnp.ndarray] = None):
    """One SGD step. Pure: returns (new_params, new_velocity).

    grads are *sums* over the bunch (the reference's X^T E convention).
    ``learning_rate`` optionally overrides cfg.learning_rate as a RUNTIME
    scalar — newbob halves the rate between epochs, and a traced value
    keeps one compiled program across the whole schedule.
    """
    new_params: List[dict] = []
    new_vel: List[dict] = []
    n_frames = jnp.asarray(n_frames, jnp.float32)
    base_lr = cfg.learning_rate if learning_rate is None else learning_rate
    for spec, p, v, g, f in zip(net.specs, params, velocity, grads, factors):
        np_, nv_ = dict(p), dict(v)
        if spec.updatable and f != 0.0:
            lr = base_lr * f
            N = n_frames if cfg.grad_div_frm else jnp.asarray(1.0, jnp.float32)
            if cfg.momentum != 0.0:
                N = N * (1.0 / (1.0 - cfg.momentum))
            for k in spec.trainable_keys:
                if k not in g or g[k] is None:
                    continue
                if cfg.momentum != 0.0:
                    # momentum math in the grad dtype (f32); only the
                    # carried velocity state is stored at velocity_dtype
                    corr = g[k] + cfg.momentum * v[k].astype(g[k].dtype)
                    nv_[k] = corr.astype(v[k].dtype)
                else:
                    corr = g[k]
                w = p[k] - (lr / N) * corr
                # L2 weight decay from live weights, matrices ONLY — both
                # reference backends decay mLinearity and leave mBias alone:
                # GPU "regularization weight decay (from actual weights
                # only)" touches just mLinearity (cuBiasedLinearity.cc:62-64)
                # and the CPU row-striped update decays tgt_mat (the weight
                # stripe) while the bias update has no decay term
                # (BiasedLinearity.cc:155-170). Asserted against the built
                # reference binary in tests/test_sgd.py::test_l2_decays_
                # matrices_not_biases.
                if cfg.weightcost != 0.0 and w.ndim >= 2:
                    decay = lr * cfg.weightcost * (
                        jnp.asarray(1.0, jnp.float32) if cfg.grad_div_frm else n_frames)
                    w = w - decay * w
                # L1 for sparse layers (cuSparseLinearity ApplyL1 analog)
                if cfg.l1 != 0.0 and isinstance(spec, SparseLinearity) and w.ndim >= 2:
                    l1pen = cfg.l1 * (jnp.asarray(1.0, jnp.float32)
                                      if cfg.grad_div_frm else n_frames) * lr
                    w = jnp.sign(w) * jnp.maximum(jnp.abs(w) - l1pen, 0.0)
                np_[k] = w
            if isinstance(spec, SparseLinearity):
                np_["weight"] = np_["weight"] * p["mask"]
        new_params.append(np_)
        new_vel.append(nv_)
    return new_params, new_vel
