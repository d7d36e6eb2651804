"""Data-parallel mesh steps for the auxiliary trainers: RBM CD-1 and the
MPE error-backprop update.

The reference runs these single-device (TRbmCu.cc:291-357 and
TMpeCu.cc:630-660 both drive one GPU); on a device mesh the natural
scaling axis is ``data`` — bunch rows shard, per-shard sufficient
statistics / gradients ``psum`` across devices, and every device applies
the identical
replicated update. Semantics match the single-chip steps exactly:

  * CD-1: the update consumes bunch-summed statistics (train/rbm.py
    ``cd1_stats`` → ``apply_rbm_update_from_stats``), so psum'ing the
    per-shard sums reproduces the single-chip sums; the sampling noise is
    drawn at GLOBAL bunch shape outside the shard_map (counter PRNG: same
    key + shape = same values) and sharded in, so the sampled negative
    phase is bit-identical to the single-chip trajectory.
  * MPE: the surrogate ``sum(logits * err)`` gradient is a sum over
    frames, so frame-sharding + psum reproduces the single-chip gradient;
    the update itself is train/sgd.py ``apply_updates`` (the only home of
    SGD semantics).

The recurrent trainer's mesh mode lives in train/recurrent.py (its step
is utterance-batched, so the batch axis shards there).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.components import Rbm, Softmax
from ..models.network import Network
from ..train.rbm import (RbmTrainConfig, apply_rbm_update_from_stats,
                         cd1_stats, hidden_noise, sample_hidden)
from ..train.sgd import SgdConfig, apply_updates, layer_lr_factors


def make_sharded_cd1_step(spec: Rbm, cfg: RbmTrainConfig, mesh: Mesh):
    """Data-parallel CD-1: (params, state, key, pos_vis) ->
    (params, state, mse) with pos_vis sharded P('data', None); params and
    the correlation state replicated. Matches train/rbm.py make_cd1_step
    bit-for-bit up to f32 reduction order (tests/test_parallel_aux.py).
    """
    d_size = mesh.shape["data"]

    def _shard(params, state, pos_vis, noise):
        pos_hid = spec.apply(params, pos_vis)
        hid_sample = sample_hidden(spec, None, pos_hid, noise=noise)
        neg_vis = spec.reconstruct(params, hid_sample)
        neg_hid = spec.apply(params, neg_vis)
        stats = cd1_stats(pos_vis, pos_hid, neg_vis, neg_hid)
        stats = {k: jax.lax.psum(v, "data") for k, v in stats.items()}
        n_global = pos_vis.shape[0] * d_size
        params, state = apply_rbm_update_from_stats(
            spec, cfg, params, state, stats, n_global)
        mse = jax.lax.psum(0.5 * jnp.sum((neg_vis - pos_vis) ** 2), "data")
        return params, state, mse

    pspec = {k: P() for k in ("weight", "vis_bias", "hid_bias")}

    def step(params, state, key, pos_vis):
        sspec = {k: P() for k in state}
        sm = shard_map(
            _shard, mesh=mesh,
            in_specs=(pspec, sspec, P("data", None), P("data", None)),
            out_specs=(pspec, sspec, P()),
            check_vma=False)
        noise = hidden_noise(spec, key, (pos_vis.shape[0], spec.n_outputs),
                             pos_vis.dtype)
        return sm(params, state, pos_vis, noise)

    return jax.jit(step, donate_argnums=(0, 1))


def place_cd1_inputs(mesh: Mesh, params, state, pos_vis):
    """Device-place CD-1 operands with their mesh shardings."""
    rep = NamedSharding(mesh, P())
    params = {k: jax.device_put(jnp.asarray(v), rep) for k, v in params.items()}
    state = {k: jax.device_put(jnp.asarray(v), rep) for k, v in state.items()}
    pos_vis = jax.device_put(jnp.asarray(pos_vis),
                             NamedSharding(mesh, P("data", None)))
    return params, state, pos_vis


def make_sharded_mpe_step(net: Network, sgd_cfg: SgdConfig, mesh: Mesh):
    """Frame-sharded MPE forward + error-backprop update.

    Returns (forward_fn, update_fn):
      forward_fn(params, feats) -> log posteriors, feats P('data', None)
      update_fn(params, velocity, feats, err, n_frames) with feats/err
      frame-sharded; gradient = psum of per-shard surrogate grads,
      identical to tools/tmpe.py's single-chip update (the softmax
      backward is the identity on the externally-computed error,
      TMpeCu.cc:630-660).
    """
    if not isinstance(net.specs[-1], Softmax):
        raise ValueError("MPE training expects a terminal <softmax>")
    body_specs = net.specs[:-1]
    factors = tuple(layer_lr_factors(net, sgd_cfg))

    def forward(params, x):
        for spec, p in zip(body_specs, params):
            x = spec.apply(p, x)
        return x        # logits (pre-softmax)

    param_specs = [{k: P() for k in p} for p in net.params]
    # init_momentum allocates no buffers at momentum 0 (train/sgd.py:85)
    vel_specs = [({k: P() for k in s.trainable_keys if k in p}
                  if sgd_cfg.momentum != 0.0 else {})
                 for s, p in zip(net.specs, net.params)]

    def _shard_fwd(params, feats):
        return jax.nn.log_softmax(forward(params, feats), axis=-1)

    fwd = jax.jit(shard_map(
        _shard_fwd, mesh=mesh,
        in_specs=(param_specs, P("data", None)),
        out_specs=P("data", None),
        check_vma=False))

    def _shard_upd(params, velocity, feats, err, n_frames):
        def surrogate(params):
            return jnp.sum(forward(params, feats) * err)
        grads = jax.grad(surrogate)(params)
        grads = [{k: jax.lax.psum(v, "data") for k, v in g.items()}
                 for g in grads]
        return apply_updates(net, params, velocity, grads, sgd_cfg,
                             n_frames, factors)

    upd = jax.jit(shard_map(
        _shard_upd, mesh=mesh,
        in_specs=(param_specs, vel_specs, P("data", None), P("data", None),
                  P()),
        out_specs=(param_specs, vel_specs),
        check_vma=False), donate_argnums=(0, 1))

    return fwd, upd
