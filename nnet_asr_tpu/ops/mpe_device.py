"""Device-side MPE within-arc recursions (lax.scan over frames).

The SURVEY §7 step-8 design: the alpha/beta recursions run as ``lax.scan``
over the frame axis, batched over all arcs of a (length, n_states) bucket
— static shapes, no data-dependent control flow, jitted once per bucket
shape. Produces exactly the same log-likelihoods and occupancies as the
host engine (train/mpe.py arc_forward_backward_batch), which remains the
default on CPU; MpeComputer(engine="jax") switches to this path so the
arc-level math stays on the accelerator next to the NN forward pass.

The lattice-level node recursions stay host-side: they are a sequential
graph walk over a few hundred nodes (microseconds) — the reference also
ran its whole decoder on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

LOG_ZERO = -1e30


def _lse(x, axis):
    m = jnp.max(x, axis=axis)
    good = m > LOG_ZERO / 2
    out = m + jnp.log(jnp.sum(jnp.exp(x - jnp.expand_dims(m, axis)),
                              axis=axis) + 1e-300)
    return jnp.where(good, out, LOG_ZERO)


@functools.partial(jax.jit, static_argnums=())
def arc_fb_device(log_obs: jnp.ndarray, lt: jnp.ndarray):
    """Batched within-arc forward-backward on device.

    log_obs: (A, L, S) emission log-probs; lt: (A, S+2, S+2) log transitions.
    Returns (log_like (A,), occupancy (A, L, S)).
    """
    A, L, S = log_obs.shape
    inner = lt[:, 1:S + 1, 1:S + 1]                     # (A, S, S)

    alpha0 = lt[:, 0, 1:S + 1] + log_obs[:, 0]          # (A, S)

    def fwd(carry, obs_t):
        prev = carry[:, :, None] + inner                # (A, S_from, S_to)
        a = _lse(prev, axis=1) + obs_t
        return a, a

    _, alphas = jax.lax.scan(fwd, alpha0,
                             jnp.moveaxis(log_obs[:, 1:], 1, 0))
    alpha = jnp.concatenate([alpha0[None], alphas], axis=0)   # (L, A, S)

    exit_scores = alpha[L - 1] + lt[:, 1:S + 1, S + 1]
    log_like = _lse(exit_scores, axis=1)

    betaL = lt[:, 1:S + 1, S + 1]                       # (A, S)

    def bwd(carry, obs_t):
        nxt = inner + (obs_t + carry)[:, None, :]
        b = _lse(nxt, axis=2)
        return b, b

    _, betas = jax.lax.scan(bwd, betaL,
                            jnp.moveaxis(log_obs[:, 1:], 1, 0),
                            reverse=True)
    beta = jnp.concatenate([betas, betaL[None]], axis=0)      # (L, A, S)

    ok = log_like > LOG_ZERO / 2
    occ = jnp.exp(jnp.clip(
        jnp.moveaxis(alpha + beta, 0, 1) - log_like[:, None, None], -700, 0))
    occ = jnp.where(ok[:, None, None], occ, 0.0)
    sums = jnp.sum(occ, axis=2, keepdims=True)
    occ = jnp.where(sums > 0, occ / jnp.where(sums > 0, sums, 1.0), 0.0)
    return jnp.where(ok, log_like, LOG_ZERO), occ


def arc_forward_backward_batch_jax(log_obs: np.ndarray, lt: np.ndarray):
    """Host-array wrapper matching train.mpe.arc_forward_backward_batch."""
    ll, occ = arc_fb_device(jnp.asarray(log_obs, jnp.float32),
                            jnp.asarray(lt, jnp.float32))
    return np.asarray(ll, dtype=np.float64), np.asarray(occ, dtype=np.float64)


@jax.jit
def arc_fwd_device(log_obs: jnp.ndarray, lt: jnp.ndarray):
    """Forward-only arc scoring (no occupancies) — the cheap pass of the
    prune-then-occupancy path (train.mpe.arc_forward_batch)."""
    A, L, S = log_obs.shape
    inner = lt[:, 1:S + 1, 1:S + 1]
    alpha0 = lt[:, 0, 1:S + 1] + log_obs[:, 0]

    def fwd(carry, obs_t):
        a = _lse(carry[:, :, None] + inner, axis=1) + obs_t
        return a, None

    alphaT, _ = jax.lax.scan(fwd, alpha0,
                             jnp.moveaxis(log_obs[:, 1:], 1, 0))
    log_like = _lse(alphaT + lt[:, 1:S + 1, S + 1], axis=1)
    return jnp.where(log_like > LOG_ZERO / 2, log_like, LOG_ZERO)


def arc_forward_batch_jax(log_obs: np.ndarray, lt: np.ndarray):
    """Host-array wrapper matching train.mpe.arc_forward_batch."""
    ll = arc_fwd_device(jnp.asarray(log_obs, jnp.float32),
                        jnp.asarray(lt, jnp.float32))
    return np.asarray(ll, dtype=np.float64)


# ---------------------------------------------------------------------------
# Bucket-padded masked variants: every distinct (A, L, S) is a distinct XLA
# program, and real lattices produce hundreds of exact shapes — pathological
# compile behavior. Padding
# A and L to power-of-two buckets with a per-arc length mask bounds the
# program count to |A buckets| x |L buckets| x |S|, ~16 total. The scan
# holds the carry (forward) / the exit vector (backward) on steps past an
# arc's true length, so results are exact, not approximate.
# ---------------------------------------------------------------------------

@jax.jit
def arc_fb_masked(log_obs: jnp.ndarray, lt: jnp.ndarray, lens: jnp.ndarray):
    """Masked within-arc FB: log_obs (A, Lp, S) zero-padded past lens[a],
    lt (A, S+2, S+2), lens (A,) int32 true lengths (>=1).
    Returns (log_like (A,), occupancy (A, Lp, S) zeroed past lens[a])."""
    A, Lp, S = log_obs.shape
    inner = lt[:, 1:S + 1, 1:S + 1]
    alpha0 = lt[:, 0, 1:S + 1] + log_obs[:, 0]

    def fwd(carry, inp):
        obs_t, t = inp
        a_new = _lse(carry[:, :, None] + inner, axis=1) + obs_t
        a = jnp.where((t < lens)[:, None], a_new, carry)   # hold past end
        return a, a

    ts = jnp.arange(1, Lp)
    _, alphas = jax.lax.scan(fwd, alpha0,
                             (jnp.moveaxis(log_obs[:, 1:], 1, 0), ts))
    alpha = jnp.concatenate([alpha0[None], alphas], axis=0)   # (Lp, A, S)

    exit_w = lt[:, 1:S + 1, S + 1]                            # (A, S)
    # carry after the scan == alpha[lens-1] (held); avoids a gather
    final_alpha = alpha[Lp - 1] if Lp > 1 else alpha0
    log_like = _lse(final_alpha + exit_w, axis=1)

    def bwd(carry, inp):
        obs_t, t = inp
        # step with input index t emits beta[t-1]: the recursion applies
        # iff t-1 <= len-2 (i.e. t < len); past the arc the emitted beta
        # AND the carry stay at the exit vector, so the first real step
        # sees carry == beta[len-1] == exit_w
        b_new = _lse(inner + (obs_t + carry)[:, None, :], axis=2)
        b = jnp.where((t < lens)[:, None], b_new, exit_w)
        return b, b

    _, betas = jax.lax.scan(bwd, exit_w,
                            (jnp.moveaxis(log_obs[:, 1:], 1, 0), ts),
                            reverse=True)
    beta = jnp.concatenate([betas, exit_w[None]], axis=0)     # (Lp, A, S)

    ok = log_like > LOG_ZERO / 2
    occ = jnp.exp(jnp.clip(
        jnp.moveaxis(alpha + beta, 0, 1) - log_like[:, None, None], -700, 0))
    occ = jnp.where(ok[:, None, None], occ, 0.0)
    tmask = (jnp.arange(Lp)[None, :] < lens[:, None])[:, :, None]
    occ = jnp.where(tmask, occ, 0.0)
    sums = jnp.sum(occ, axis=2, keepdims=True)
    occ = jnp.where(sums > 0, occ / jnp.where(sums > 0, sums, 1.0), 0.0)
    return jnp.where(ok, log_like, LOG_ZERO), occ


@jax.jit
def arc_fwd_masked(log_obs: jnp.ndarray, lt: jnp.ndarray, lens: jnp.ndarray):
    """Masked forward-only arc scoring (see arc_fb_masked)."""
    A, Lp, S = log_obs.shape
    inner = lt[:, 1:S + 1, 1:S + 1]
    alpha0 = lt[:, 0, 1:S + 1] + log_obs[:, 0]

    def fwd(carry, inp):
        obs_t, t = inp
        a_new = _lse(carry[:, :, None] + inner, axis=1) + obs_t
        return jnp.where((t < lens)[:, None], a_new, carry), None

    alphaT, _ = jax.lax.scan(fwd, alpha0,
                             (jnp.moveaxis(log_obs[:, 1:], 1, 0),
                              jnp.arange(1, Lp)))
    log_like = _lse(alphaT + lt[:, 1:S + 1, S + 1], axis=1)
    return jnp.where(log_like > LOG_ZERO / 2, log_like, LOG_ZERO)


def _pow2_bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def arc_fb_padded_jax(obs_list, lt_list):
    """Bucket-padded batch FB over per-arc (L_a, S) obs + (S+2, S+2) lt.

    Returns (log_likes list, occupancy list sliced to each true L_a)."""
    A = len(obs_list)
    S = obs_list[0].shape[1]
    lens = np.asarray([o.shape[0] for o in obs_list], np.int32)
    Lp = _pow2_bucket(int(lens.max()))
    Ap = _pow2_bucket(A, floor=64)
    obs = np.zeros((Ap, Lp, S), np.float32)
    lt = np.zeros((Ap, S + 2, S + 2), np.float32)
    lt[:] = lt_list[0]            # pad arcs reuse a valid transition matrix
    lens_pad = np.ones((Ap,), np.int32)
    for j, o in enumerate(obs_list):
        obs[j, :o.shape[0]] = o
        lt[j] = lt_list[j]
        lens_pad[j] = o.shape[0]
    ll, occ = arc_fb_masked(jnp.asarray(obs), jnp.asarray(lt),
                            jnp.asarray(lens_pad))
    ll = np.asarray(ll, np.float64)
    occ = np.asarray(occ, np.float64)
    return ([float(ll[j]) for j in range(A)],
            [occ[j, :int(lens[j])] for j in range(A)])


def arc_fwd_padded_jax(obs_list, lt_list):
    """Bucket-padded forward-only scoring (see arc_fb_padded_jax)."""
    A = len(obs_list)
    S = obs_list[0].shape[1]
    lens = np.asarray([o.shape[0] for o in obs_list], np.int32)
    Lp = _pow2_bucket(int(lens.max()))
    Ap = _pow2_bucket(A, floor=64)
    obs = np.zeros((Ap, Lp, S), np.float32)
    lt = np.zeros((Ap, S + 2, S + 2), np.float32)
    lt[:] = lt_list[0]
    lens_pad = np.ones((Ap,), np.int32)
    for j, o in enumerate(obs_list):
        obs[j, :o.shape[0]] = o
        lt[j] = lt_list[j]
        lens_pad[j] = o.shape[0]
    ll = np.asarray(arc_fwd_masked(jnp.asarray(obs), jnp.asarray(lt),
                                   jnp.asarray(lens_pad)), np.float64)
    return [float(ll[j]) for j in range(A)]
