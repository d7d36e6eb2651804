"""Sharded training step: data parallelism × senone-sharded output layer.

Device-mesh replacement for the reference's two parallelism mechanisms
(SURVEY.md §2.9):

  * Platform's N trainer threads with shared weights + row-striped fp64
    gradient reduction (Platform.h:143-391, BiasedLinearity.cc:88-178)
    → the ``data`` mesh axis: per-device batch shards, gradient ``psum``
    across devices, identical replicated update on every device.
  * The embryonic column-block output structure (BlockSoftmax /
    CuDiscreteLinearity) → the ``model`` mesh axis: the senone output
    layer's weight columns live sharded, the softmax normalizer is a
    ``psum``/``pmax`` over the model axis, and each shard updates only its
    own column stripe — the exact mesh analog of the reference's
    "each thread updates a disjoint row stripe".

Head coverage matches the single-chip trainer:
  * ``...→BiasedLinearity→Softmax`` + CE: fully-distributed log-softmax
    (no logit gather — normalizer travels as two scalars per row).
  * ``...→BiasedLinearity→BlockSoftmax`` + CE (Activation.cc:55-133) and
    the MSE objective (ObjFun.cc:24-56, with the reference's
    identity-backward through a terminal softmax): local logit stripes are
    ``all_gather``-ed over the model axis (the VJP is a reduce-scatter)
    and the exact single-chip loss functions run on the
    full logits.

Senone dims that don't divide the model axis are zero-padded to the next
multiple (``n_out_pad``) and the padded columns masked out of the softmax
(-1e30 logits) — their gradients, momentum and L2 terms are identically
zero, so they stay zero and slicing them off reproduces the unpadded
model exactly (tests/test_parallel.py::test_sharded_padded_senones).

Built on ``shard_map`` so the collective placement is explicit; XLA lowers
psum/pmax/all_gather to the backend's collectives (NCCL on NVIDIA cards).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.components import BiasedLinearity, BlockSoftmax, Softmax
from ..models.network import Network
from ..ops.objectives import (mse_loss_and_stats, softmax_identity_backward,
                              xent_loss_and_stats)
from ..train.sgd import SgdConfig, apply_updates, layer_lr_factors


@dataclass
class ShardedTrainState:
    params: List[dict]
    velocity: List[dict]
    param_specs: List[dict]   # PartitionSpec pytree matching params
    out_idx: Optional[int] = None   # senone-sharded layer (None: replicated)
    n_out: int = 0                  # true senone count
    n_out_pad: int = 0              # padded to a multiple of the model axis

    def to_device(self, mesh: Mesh):
        """Place params/velocity with their shardings."""
        def put(tree, specs):
            return [
                {k: jax.device_put(v, NamedSharding(mesh, specs[i][k]))
                 for k, v in p.items()}
                for i, p in enumerate(tree)]
        self.params = put(self.params, self.param_specs)
        self.velocity = put(self.velocity, self.param_specs)
        return self

    def host_params(self) -> List[dict]:
        """Fetch params to host, slicing off senone padding columns."""
        out = []
        for i, p in enumerate(self.params):
            h = {k: np.asarray(v) for k, v in p.items()}
            if i == self.out_idx and self.n_out_pad != self.n_out:
                h["weight"] = h["weight"][:, :self.n_out]
                h["bias"] = h["bias"][:self.n_out]
            out.append(h)
        return out


def _find_output_layer(net: Network, objective: str):
    """Locate the senone-producing BiasedLinearity to column-shard.

    Returns (out_idx, block_dims, has_softmax). CE requires a terminal
    (Block)Softmax fed by a BiasedLinearity (the trainer factorizes the
    softmax into the fused loss, like the reference's err = y - t trick);
    MSE accepts that shape or a bare terminal BiasedLinearity.
    """
    specs = net.specs
    if (len(specs) >= 2 and isinstance(specs[-1], (Softmax, BlockSoftmax))
            and isinstance(specs[-2], BiasedLinearity)):
        dims = specs[-1].dims if isinstance(specs[-1], BlockSoftmax) else None
        return len(specs) - 2, dims, True
    if objective == "mse" and specs and isinstance(specs[-1], BiasedLinearity):
        return len(specs) - 1, None, False
    raise ValueError(
        "sharded step expects ... -> <biasedlinearity> -> <(block)softmax>"
        + (" (or a terminal <biasedlinearity> for MSE)"
           if objective == "mse" else ""))


def make_sharded_train_step(net: Network, sgd_cfg: SgdConfig, mesh: Mesh,
                            objective: str = "xent", scan_unroll: int = 1,
                            compute_dtype: Optional[str] = None):
    """Build (state, step_fn, eval_fn, fns) for training on a (data, model)
    mesh.

    step_fn(params, velocity, acc, feats, labels) -> (params, velocity, acc)
    with feats sharded P('data', None), labels P('data'); gradient semantics
    identical to the single-chip trainer (sums over the global bunch).
    ``fns`` additionally holds 'drain_train'/'drain_eval' whole-cache scans;
    ``drain_train`` takes an optional runtime ``lr`` scalar (newbob halving
    without recompiles, as in train.Trainer) and partially unrolls the
    bunch scan by ``scan_unroll``.

    ``compute_dtype`` mirrors TrainerConfig.compute_dtype on the mesh:
    'bf16' runs the BiasedLinearity matmuls in bfloat16 (f32 master
    params/loss/update); 'int8'/'int8pf'/'int8pfsr' run the fake-quant
    STE modes. The per-tensor activation scale of plain 'int8' is a pmax
    over the ``data`` axis so it sees the GLOBAL bunch max, matching the
    single-chip semantics exactly; 'int8pf' (per-frame) and the
    per-output-column weight scales are shard-local by construction.
    'int8pfsr' (stochastic rounding, the production quantized-training
    mode) draws its uniforms at the GLOBAL bunch shape and slices each
    shard's row block, so the trajectory is bit-comparable to the
    single-chip trainer for any data-axis layout; its PRNG key rides the
    replicated accumulator as ``acc['_sr_key']`` exactly like
    train.Trainer (advanced per step inside the drain scan, eval
    deterministic). 'int8full' (real int8 GEMMs) is single-chip-only —
    rejected here rather than silently ignored.
    """
    if objective not in ("xent", "mse"):
        raise ValueError(f"unknown objective {objective!r}")
    if compute_dtype not in (None, "bf16", "int8", "int8pf", "int8pfsr"):
        raise ValueError(
            f"compute_dtype {compute_dtype!r} is not supported on a mesh "
            "(supported: bf16, int8, int8pf, int8pfsr; int8full is "
            "single-chip-only)")
    bf16 = compute_dtype == "bf16"
    int8 = compute_dtype in ("int8", "int8pf", "int8pfsr")
    act_axis = -1 if compute_dtype in ("int8pf", "int8pfsr") else None
    sr = compute_dtype == "int8pfsr"

    def _cast(v):
        return v.astype(jnp.bfloat16) if bf16 else v

    def _fq(t, axis=None, global_bunch=False, key=None):
        # fake-quant with straight-through gradients, identical math to
        # train.Trainer._fq; for the per-tensor activation scale the max
        # rides a pmax over the data axis so every shard quantizes with
        # the global bunch scale (s is inside stop_gradient's cone: the
        # STE makes d(fq)/dt identity, so the collective carries no grad)
        amax = jnp.max(jnp.abs(jax.lax.stop_gradient(t)), axis=axis,
                       keepdims=axis is not None)
        if global_bunch and axis is None:
            amax = jax.lax.pmax(amax, "data")
        s = amax / 127.0 + 1e-12
        if key is not None:
            # stochastic rounding (int8pfsr), bit-identical to the
            # single-chip draw: generate the GLOBAL-bunch-shaped uniform
            # and slice this shard's row block, so every global row sees
            # the same u regardless of the data-axis layout (the same
            # trick the RBM mesh step uses for its Bernoulli draws)
            gb = t.shape[0] * mesh.shape["data"]
            u_full = jax.random.uniform(key, (gb,) + t.shape[1:],
                                        dtype=t.dtype)
            off = jax.lax.axis_index("data") * t.shape[0]
            u = jax.lax.dynamic_slice_in_dim(u_full, off, t.shape[0], 0)
            q = jnp.clip(jnp.floor(t / s + u), -127, 127) * s
        else:
            q = jnp.clip(jnp.round(t / s), -127, 127) * s
        return t + jax.lax.stop_gradient(q - t)
    out_idx, block_dims, has_softmax = _find_output_layer(net, objective)
    body_specs = net.specs[:out_idx]
    n_out = net.specs[out_idx].n_outputs
    m_size = mesh.shape["model"]
    d_size = mesh.shape["data"]
    n_out_pad = -(-n_out // m_size) * m_size
    out_loc = n_out_pad // m_size
    # the gather path runs the exact single-chip loss on all-gathered
    # logits; the plain-softmax CE stays fully distributed
    gather_head = (objective == "mse") or (block_dims is not None)
    factors = tuple(layer_lr_factors(net, sgd_cfg))

    # ---- parameter partition specs + senone padding -------------------
    param_specs: List[dict] = []
    padded_params: List[dict] = []
    for i, (spec, p) in enumerate(zip(net.specs, net.params)):
        if i == out_idx:
            param_specs.append({"weight": P(None, "model"), "bias": P("model")})
            w = np.asarray(p["weight"])
            b = np.asarray(p["bias"])
            if n_out_pad != n_out:
                pad = n_out_pad - n_out
                w = np.pad(w, ((0, 0), (0, pad)))
                b = np.pad(b, (0, pad))
            padded_params.append({"weight": w, "bias": b})
        else:
            param_specs.append({k: P() for k in p})
            padded_params.append(dict(p))

    state = ShardedTrainState(
        params=padded_params,
        velocity=[{k: jnp.zeros_like(
                       np.asarray(v),
                       dtype=(jnp.bfloat16 if sgd_cfg.velocity_dtype == "bf16"
                              else None))
                   for k, v in p.items() if k in s.trainable_keys}
                  for s, p in zip(net.specs, padded_params)],
        param_specs=param_specs,
        out_idx=out_idx, n_out=n_out, n_out_pad=n_out_pad)

    # ---- local (per-shard) loss --------------------------------------
    def _bl_matmul(p, h, key=None):
        """One BiasedLinearity under the compute-dtype policy (matches
        train.Trainer.forward_logits branch for branch)."""
        if int8:
            return (_fq(h, axis=act_axis, global_bunch=True, key=key)
                    @ _fq(p["weight"], axis=0) + p["bias"])
        return _cast(h) @ _cast(p["weight"]) + _cast(p["bias"])

    def local_logits(params, feats, key=None):
        # per-layer SR keys fold in the spec index, matching the
        # single-chip forward_logits (body_specs there includes the
        # output BiasedLinearity at the same index out_idx)
        h = _cast(feats)
        for i, (spec, p) in enumerate(zip(body_specs, params[:out_idx])):
            if isinstance(spec, BiasedLinearity) and (bf16 or int8):
                kk = jax.random.fold_in(key, i) if key is not None else None
                h = _bl_matmul(p, h, kk)
            else:
                h = spec.apply(p, h)
        kk = jax.random.fold_in(key, out_idx) if key is not None else None
        out = _bl_matmul(params[out_idx], h, kk)
        return out.astype(jnp.float32) if bf16 else out

    def softmax_ce_loss(params, feats, labels, key=None):
        """Fully-distributed CE: normalizer as psum/pmax scalars per row."""
        logits = local_logits(params, feats, key)
        off = jax.lax.axis_index("model") * out_loc
        if n_out_pad != n_out:
            # mask padding columns out of the softmax; where() passes zero
            # cotangent into the masked branch, so padded weights never move
            col_valid = (off + jnp.arange(out_loc)) < n_out
            logits = jnp.where(col_valid[None, :], logits, -1e30)

        m = jax.lax.pmax(jnp.max(jax.lax.stop_gradient(logits), axis=1), "model")
        s = jax.lax.psum(jnp.sum(jnp.exp(logits - m[:, None]), axis=1), "model")
        # one-hot contraction (a gather's VJP would be a scatter);
        # labels outside this shard's span give all-zero one-hot rows, so
        # non-owning shards contribute 0 to the psum automatically
        oh_loc = jax.nn.one_hot(labels - off, out_loc, dtype=logits.dtype)
        picked_loc = jnp.sum(logits * oh_loc, axis=1)
        picked = jax.lax.psum(picked_loc, "model")
        logp = picked - m - jnp.log(s)
        # each model shard computes the same loss copy redundantly; scale by
        # 1/m so psum'ing the relayed cotangents counts the loss exactly once
        loss = -jnp.sum(logp) / m_size

        # distributed argmax with first-max-wins tie-break (FindMaxId analog)
        local_max = jnp.max(jax.lax.stop_gradient(logits), axis=1)
        local_arg = jnp.argmax(jax.lax.stop_gradient(logits), axis=1) + off
        gmax = jax.lax.pmax(local_max, "model")
        cand = jnp.where(local_max >= gmax, local_arg, n_out_pad)
        pred = jax.lax.pmin(cand, "model")
        stats = {
            "xent": -jnp.sum(jnp.maximum(jax.lax.stop_gradient(logp), -1e10)),
            "correct": jnp.sum((pred == labels).astype(jnp.int32)),
            "frames": jnp.asarray(labels.shape[0], jnp.int32),
        }
        return loss, stats

    def gathered_loss(params, feats, labels, key=None):
        """BlockSoftmax / MSE heads: all_gather the logit stripes over the
        model axis (VJP = reduce-scatter) and run the exact single-chip
        loss on the full logits."""
        logits_loc = local_logits(params, feats, key)
        full = jax.lax.all_gather(logits_loc, "model", axis=1, tiled=True)
        full = full[:, :n_out]     # grad into padded columns is zero
        if objective == "xent":
            loss, stats = xent_loss_and_stats(full, labels, block_dims)
        else:
            y = softmax_identity_backward(full) if has_softmax else full
            targets = jax.nn.one_hot(labels, n_out, dtype=y.dtype)
            loss, stats = mse_loss_and_stats(y, targets)
        # every model shard computes the same loss copy; see softmax_ce_loss
        return loss / m_size, stats

    local_loss = gathered_loss if gather_head else softmax_ce_loss

    def _shard_step(params, velocity, acc, feats, labels, lr=None):
        key = next_key = None
        if sr:
            # the SR key rides the (replicated) accumulator exactly as in
            # the single-chip trainer: advance per step inside the drain
            # scan, eval stays deterministic (no key)
            next_key, key = jax.random.split(acc["_sr_key"])
        (_, stats), grads = jax.value_and_grad(
            local_loss, has_aux=True)(params, feats, labels, key)
        # replicated params: partial grads per (data, model) cell
        # sharded output layer: partial only over data
        for i in range(len(grads)):
            axes = ("data",) if i == out_idx else ("data", "model")
            grads[i] = {k: jax.lax.psum(v, axes) for k, v in grads[i].items()}
        global_frames = labels.shape[0] * d_size
        params, velocity = apply_updates(
            net, params, velocity, grads, sgd_cfg, global_frames, factors,
            learning_rate=lr)
        stats = {k: jax.lax.psum(v, "data") for k, v in stats.items()}
        acc = {k: acc[k] + stats[k] for k in acc if k != "_sr_key"}
        if sr:
            acc["_sr_key"] = next_key
        return params, velocity, acc

    def _shard_eval(params, acc, feats, labels):
        _, stats = local_loss(params, feats, labels)
        stats = {k: jax.lax.psum(v, "data") for k, v in stats.items()}
        out = {k: acc[k] + stats[k] for k in acc if k != "_sr_key"}
        if "_sr_key" in acc:
            out["_sr_key"] = acc["_sr_key"]    # passthrough, untouched
        return out

    vel_specs = [{k: param_specs[i][k] for k in v}
                 for i, v in enumerate(state.velocity)]
    acc_spec = {k: P() for k in zero_acc(objective)}
    if sr:
        # callers add acc['_sr_key'] (a PRNG key, replicated) in SR mode
        acc_spec["_sr_key"] = P()

    step = shard_map(
        _shard_step, mesh=mesh,
        in_specs=(param_specs, vel_specs, acc_spec, P("data", None), P("data")),
        out_specs=(param_specs, vel_specs, acc_spec),
        check_vma=False)
    evalf = shard_map(
        _shard_eval, mesh=mesh,
        in_specs=(param_specs, acc_spec, P("data", None), P("data")),
        out_specs=acc_spec,
        check_vma=False)

    # whole-cache drains: lax.scan over stacked bunches (nb, bunch, ...)
    # sharded P(None, 'data', ...) — one XLA program per cache, as in the
    # single-chip trainer
    def _unroll(nb):
        return max(1, min(scan_unroll, nb))

    def _drain_train_body(params, velocity, acc, feats_all, labels_all, lr):
        def body(carry, batch):
            p, v, a = carry
            p, v, a = _shard_step(p, v, a, batch[0], batch[1], lr)
            return (p, v, a), None
        (params, velocity, acc), _ = jax.lax.scan(
            body, (params, velocity, acc), (feats_all, labels_all),
            unroll=_unroll(feats_all.shape[0]))
        return params, velocity, acc

    def _drain_eval_body(params, acc, feats_all, labels_all):
        def body(a, batch):
            return _shard_eval(params, a, batch[0], batch[1]), None
        acc, _ = jax.lax.scan(body, acc, (feats_all, labels_all),
                              unroll=_unroll(feats_all.shape[0]))
        return acc

    drain_train_sm = shard_map(
        _drain_train_body, mesh=mesh,
        in_specs=(param_specs, vel_specs, acc_spec,
                  P(None, "data", None), P(None, "data"), P()),
        out_specs=(param_specs, vel_specs, acc_spec),
        check_vma=False)
    drain_eval = shard_map(
        _drain_eval_body, mesh=mesh,
        in_specs=(param_specs, acc_spec,
                  P(None, "data", None), P(None, "data")),
        out_specs=acc_spec,
        check_vma=False)

    def drain_train(params, velocity, acc, feats_all, labels_all, lr=None):
        # runtime lr scalar (replicated): newbob halves the rate between
        # epochs and a traced value keeps one compiled program
        if lr is None:
            lr = jnp.float32(sgd_cfg.learning_rate)
        return drain_train_sm(params, velocity, acc, feats_all, labels_all,
                              jnp.asarray(lr, jnp.float32))

    fns = {
        "step": jax.jit(step, donate_argnums=(0, 1, 2)),
        "eval": jax.jit(evalf, donate_argnums=(1,)),
        "drain_train": jax.jit(drain_train, donate_argnums=(0, 1, 2)),
        "drain_eval": jax.jit(drain_eval, donate_argnums=(1,)),
    }
    return state, fns["step"], fns["eval"], fns


def zero_acc(objective: str = "xent"):
    if objective == "mse":
        return {"mse": jnp.zeros((), jnp.float32),
                "frames": jnp.zeros((), jnp.int32)}
    return {"xent": jnp.zeros((), jnp.float32),
            "correct": jnp.zeros((), jnp.int32),
            "frames": jnp.zeros((), jnp.int32)}
