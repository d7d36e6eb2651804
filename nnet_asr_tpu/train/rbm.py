"""RBM CD-1 pretraining (TRbmCu path) on the device.

Functional re-design of CuRbm/CuRbmSparse + the TRbmCu main loop
(cuRbm.cc:101-174, cuRbmSparse.cc:131-195, TRbmCu.cc:291-357): one jitted
CD-1 step does propagate → hidden sampling (Bernoulli binarize or Gaussian
noise, replacing CuRand with the JAX counter PRNG) → reconstruct →
re-propagate → Hinton-recipe update with momentum + weight decay (and the
sparsity-target variant's smoothed expected-activity penalty), plus the
reconstruction-MSE statistic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..models.components import BERNOULLI, Rbm, RbmSparse


@dataclass(frozen=True)
class RbmTrainConfig:
    learning_rate: float = 0.10     # TRbmCu.cc:169 defaults
    momentum: float = 0.50
    weightcost: float = 0.0002
    # sparsity variant (cuRbmSparse.h:92-94 defaults)
    sparsity_prior: float = 0.0001
    sparsity_lambda: float = 0.95
    sparsity_cost: float = 1e-7
    # PRNG for the negative-phase sampling: 'threefry' (jax default,
    # reproducible with all recorded trajectories) or 'rbg' (a counter
    # generator; which one is faster on the H100 is to be measured,
    # ROADMAP.md queue 1 #7; a DIFFERENT but statistically equivalent
    # stream, like the reference's CuRand vs
    # our threefry already are)
    rng_impl: str = "threefry"


def init_rbm_state(spec: Rbm, params: dict, cfg: RbmTrainConfig) -> dict:
    st = {
        "vh_corr": jnp.zeros_like(params["weight"]),
        "vb_corr": jnp.zeros_like(params["vis_bias"]),
        "hb_corr": jnp.zeros_like(params["hid_bias"]),
    }
    if isinstance(spec, RbmSparse):
        st["sparsity_q"] = jnp.full_like(params["hid_bias"], cfg.sparsity_prior)
    return st


def cd1_stats(pos_vis, pos_hid, neg_vis, neg_hid):
    """CD-1 sufficient statistics: everything the Hinton update needs that
    sums over the bunch. Factored out so the data-parallel step can psum
    the per-shard sums before applying the identical update
    (parallel/sharded_aux.py)."""
    return {
        "vh": pos_vis.T @ pos_hid - neg_vis.T @ neg_hid,
        "vb": jnp.sum(pos_vis, 0) - jnp.sum(neg_vis, 0),
        "hb": jnp.sum(pos_hid, 0) - jnp.sum(neg_hid, 0),
        "q_sum": jnp.sum(pos_hid, 0),
        "vis_sum": jnp.sum(pos_vis, 0),
    }


def apply_rbm_update_from_stats(spec: Rbm, cfg: RbmTrainConfig, params,
                                state, stats, n_frames):
    """Pure Hinton-recipe CD-1 update from summed statistics
    (cuRbm.cc:131-174, cuRbmSparse.cc:131-195). Returns
    (new_params, new_state)."""
    sparse = isinstance(spec, RbmSparse)
    w, vb, hb = params["weight"], params["vis_bias"], params["hid_bias"]
    N = jnp.asarray(n_frames, jnp.float32)
    lr, mmt, wc = cfg.learning_rate, cfg.momentum, cfg.weightcost

    vh_corr = mmt * state["vh_corr"] + (lr / N) * stats["vh"] - lr * wc * w
    vb_corr = mmt * state["vb_corr"] + (lr / N) * stats["vb"]
    hb_corr = mmt * state["hb_corr"] + (lr / N) * stats["hb"]

    new_state = dict(state)
    if sparse and spec.hid_type == BERNOULLI:
        q_cur = stats["q_sum"] / N
        q = cfg.sparsity_lambda * state["sparsity_q"] \
            + (1.0 - cfg.sparsity_lambda) * q_cur
        q_diff = q - cfg.sparsity_prior
        vis_mean = stats["vis_sum"] / N
        vh_corr = vh_corr - cfg.sparsity_cost * jnp.outer(vis_mean, q_diff)
        hb_corr = hb_corr - cfg.sparsity_cost * q_diff
        new_state["sparsity_q"] = q

    new_params = dict(params)
    new_params["weight"] = w + vh_corr
    new_params["vis_bias"] = vb + vb_corr
    new_params["hid_bias"] = hb + hb_corr
    new_state.update(vh_corr=vh_corr, vb_corr=vb_corr, hb_corr=hb_corr)
    return new_params, new_state


def apply_rbm_update(spec: Rbm, cfg: RbmTrainConfig, params, state,
                     pos_vis, pos_hid, neg_vis, neg_hid):
    """Pure Hinton-recipe CD-1 update (cuRbm.cc:131-174,
    cuRbmSparse.cc:131-195). Returns (new_params, new_state)."""
    return apply_rbm_update_from_stats(
        spec, cfg, params, state,
        cd1_stats(pos_vis, pos_hid, neg_vis, neg_hid), pos_vis.shape[0])


def hidden_noise(spec: Rbm, key, shape, dtype=jnp.float32):
    """The stochastic ingredient of the negative phase: uniform thresholds
    (Bernoulli) or Gaussian noise. Separated from the thresholding so the
    data-parallel step can draw the noise at GLOBAL bunch shape (counter
    PRNG: same key + shape = same values) and shard it — bit-identical
    sampling to the single-chip step."""
    if spec.hid_type == BERNOULLI:
        return jax.random.uniform(key, shape, dtype=dtype)
    return jax.random.normal(key, shape, dtype=dtype)


def sample_hidden(spec: Rbm, key, pos_hid, noise=None):
    """Hidden sampling for the negative phase (TRbmCu.cc:332-339)."""
    if noise is None:
        noise = hidden_noise(spec, key, pos_hid.shape, pos_hid.dtype)
    if spec.hid_type == BERNOULLI:
        return (pos_hid > noise).astype(pos_hid.dtype)
    return pos_hid + noise


def make_cd1_step(spec: Rbm, cfg: RbmTrainConfig):
    """Build a jitted (params, state, key, pos_vis) -> (params, state, mse)."""

    def step(params, state, key, pos_vis):
        pos_hid = spec.apply(params, pos_vis)
        hid_sample = sample_hidden(spec, key, pos_hid)
        neg_vis = spec.reconstruct(params, hid_sample)
        neg_hid = spec.apply(params, neg_vis)
        params, state = apply_rbm_update(
            spec, cfg, params, state, pos_vis, pos_hid, neg_vis, neg_hid)
        mse = 0.5 * jnp.sum((neg_vis - pos_vis) ** 2)
        return params, state, mse

    return jax.jit(step, donate_argnums=(0, 1))


class RbmTrainer:
    """Epoch driver: cache of transformed frames → CD-1 bunches.

    Shape-stable like train.Trainer: frames arrive in bucket-padded
    blocks (``ingest_block``) into a fixed-buffer DeviceFrameCache, and
    each cache drains as ONE scanned XLA program (the PRNG key rides in
    the scan carry with the same per-bunch split order as the old host
    loop, so the sampled trajectories are unchanged)."""

    def __init__(self, spec: Rbm, params: dict, cfg: RbmTrainConfig,
                 bunchsize: int = 256, cachesize: int = 12800,
                 seed: int = 0, randomize: bool = True):
        from .cache import DeviceFrameCache

        self.spec = spec
        self.params = {k: jnp.asarray(v) for k, v in params.items()}
        self.cfg = cfg
        self.state = init_rbm_state(spec, self.params, cfg)
        self.step = make_cd1_step(spec, cfg)
        self.cache = DeviceFrameCache(cachesize, bunchsize, seed, randomize)
        if cfg.rng_impl == "rbg":
            self.key = jax.random.key(seed if seed else 12345, impl="rbg")
        elif cfg.rng_impl == "threefry":
            self.key = jax.random.PRNGKey(seed if seed else 12345)
        else:
            raise ValueError(f"unknown rng_impl {cfg.rng_impl!r} "
                             "(threefry|rbg)")
        self.mse_sum = 0.0
        self.frames = 0
        self._mses = []          # per-cache device sums, fetched at the end
        step = self.step

        def drain(params, state, key, feats_all):
            def body(carry, feats):
                p, s, k = carry
                k, sub = jax.random.split(k)
                p, s, mse = step(p, s, sub, feats)
                return (p, s, k), mse
            (params, state, key), mses = jax.lax.scan(
                body, (params, state, key), feats_all)
            return params, state, key, jnp.sum(mses)

        self._drain_scan = jax.jit(drain, donate_argnums=(0, 1, 2))

    def _drain(self):
        stacked = self.cache.take_stacked()
        if stacked is None:
            return
        feats_all, _labels = stacked
        self.params, self.state, self.key, mse = self._drain_scan(
            self.params, self.state, self.key, feats_all)
        self._mses.append(mse)
        self.frames += feats_all.shape[0] * feats_all.shape[1]

    def ingest_block(self, rows: jnp.ndarray, valid: int) -> None:
        """Feed a bucket-padded device block (rows[:valid] are real), e.g.
        from TransformPipeline.transform_block."""
        import numpy as np

        self.cache.add_block(rows, valid, np.zeros(valid, np.int32))
        while self.cache.full:
            self._drain()

    def finish_epoch(self) -> None:
        import numpy as np

        if self.cache.rows > 0:
            self._drain()
        for m in self._mses:
            self.mse_sum += float(m)
        self._mses = []
        # NaN/Inf scan after the epoch, like the reference's
        # pos_hid.CheckData() (TRbmCu.cc:356, cumatrix.h:158) — a diverged
        # CD-1 run fails fast instead of writing a poisoned model
        for k, v in self.params.items():
            a = np.asarray(v)
            if not np.isfinite(a).all():
                raise FloatingPointError(
                    f"Invalid value (NaN/Inf) in RBM parameter '{k}' "
                    "after epoch — training diverged")

    def run_epoch(self, utterances, batch_utts: int = 32) -> None:
        import numpy as np

        from .pipeline import _bucket

        pend = []

        def flush():
            if not pend:
                return
            valid = sum(f.shape[0] for f in pend)
            block = np.zeros((_bucket(valid), pend[0].shape[1]), np.float32)
            off = 0
            for f in pend:
                block[off:off + f.shape[0]] = f
                off += f.shape[0]
            self.ingest_block(jnp.asarray(block), valid)
            pend.clear()

        for feats in utterances:
            pend.append(np.asarray(feats, np.float32))
            if len(pend) >= batch_utts:
                flush()
        flush()
        self.finish_epoch()

    def report(self) -> str:
        return (f"Mse:{self.mse_sum:.10g} frames:{self.frames}"
                f" err/frm:{self.mse_sum / max(self.frames, 1):.10g}\n")
