"""Recurrent-network trainer with truncated BPTT (TRecurrentCu path).

The reference trains frame-serially: per frame forward, CE, then a
truncated BPTT-of-order-K walk over the input history with an immediate
weight update (TRecurrentCu.cc:355-371, cuRecurrent.cc:86-153). A
frame-serial Python loop would be the worst possible device program, so
this design scans *segments* of K frames: one ``lax.scan`` per
utterance carries (params, velocity, hidden state) across segments, the
gradient is truncated at segment boundaries (``stop_gradient`` on the
carried state), and the update applies per segment instead of per frame.
This changes the optimization trajectory slightly (documented deviation —
SURVEY.md §7 "frame-serial recurrent parity"); verify on loss curves, not
bits.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..models.components import Recurrent, Softmax
from ..models.network import Network
from ..ops.objectives import XentStats
from .sgd import SgdConfig, apply_updates, init_momentum, layer_lr_factors


@dataclass
class RecurrentTrainerConfig:
    bptt_order: int = 4              # TRecurrentCu.cc:194 default
    crossvalidate: bool = False
    sgd: SgdConfig = field(default_factory=SgdConfig)
    # Exact frame-serial parity mode: reproduces the reference trajectory
    # (one forward + immediate update per frame, BPTT-K history walk with
    # the quirks of cuRecurrent::Update — weight correction without
    # momentum, bias correction accumulator carrying momentum across
    # frames). Orders of magnitude slower than the segment scan; for
    # validation runs against the reference binary.
    frame_serial: bool = False


class RecurrentTrainer:
    def __init__(self, net: Network, cfg: RecurrentTrainerConfig, mesh=None):
        """``mesh``: optional jax.sharding.Mesh — utterances shard over the
        ``data`` axis (batched truncated BPTT with the segment gradient
        psum'd across devices; the reference trains single-device,
        TRecurrentCu.cc:290-371, so this is the beyond-parity scaling
        axis). Semantics match the single-device batch step: the update
        consumes the batch-summed gradient either way."""
        net.check_dims()
        if mesh is not None and cfg.frame_serial:
            raise ValueError("frame_serial parity mode is single-device "
                             "(one frame at a time has no data axis)")
        self.mesh = mesh
        self.net = net
        self.cfg = cfg
        self.params = [dict(p) for p in net.params]
        self.velocity = init_momentum(net, cfg.sgd.momentum, cfg.sgd.velocity_dtype)
        self.factors = tuple(layer_lr_factors(net, cfg.sgd))
        self._stats = XentStats()
        self.rec_idx = [i for i, s in enumerate(net.specs)
                        if isinstance(s, Recurrent)]
        self._utt_fns = {}
        self._accs = []          # per-batch device stats, merged lazily
        self._build()

    def _flush_acc(self):
        for acc in self._accs:
            self._stats.add(float(acc["xent"]), int(acc["frames"]),
                            int(acc["correct"]))
        self._accs = []

    @property
    def stats(self):
        """Merged epoch statistics (flushes device-pending accumulators
        on access; per-batch fetches would stall the dispatch pipeline)."""
        self._flush_acc()
        return self._stats

    @stats.setter
    def stats(self, value):
        self._stats = value

    def _forward_seg(self, params, x_seg, h_list):
        """Forward a (B, K, D) segment batch; recurrent layers scan time
        per utterance (vmapped over the batch)."""
        import jax

        h_out = list(h_list)
        h = x_seg
        ri = 0
        logits = None
        for i, spec in enumerate(self.net.specs):
            if isinstance(spec, Recurrent):
                h, h_last = jax.vmap(
                    lambda xs, h0, p=params[i], s=spec:
                        s.apply_with_state(p, xs, h0))(h, h_list[ri])
                h_out[ri] = h_last
                ri += 1
            elif isinstance(spec, Softmax) and i == len(self.net.specs) - 1:
                logits = h
            else:
                h = spec.apply(params[i], h)
        if logits is None:
            logits = h
        return logits, h_out

    def _build(self):
        cfg = self.cfg
        net = self.net
        factors = self.factors
        has_softmax = isinstance(net.specs[-1], Softmax)
        if not has_softmax:
            raise ValueError("recurrent trainer expects terminal <softmax>")
        n_out = net.n_outputs

        def seg_loss(params, x_seg, labels_seg, mask_seg, h_list):
            # x_seg (B, K, D), labels/mask (B, K)
            logits, h_new = self._forward_seg(params, x_seg, h_list)
            lp = jax.nn.log_softmax(logits, axis=-1)
            # one-hot contraction: take_along_axis's VJP would be a
            # scatter
            picked = jnp.sum(
                lp * jax.nn.one_hot(labels_seg, n_out, dtype=lp.dtype),
                axis=-1)
            loss = -jnp.sum(jnp.where(mask_seg, picked, 0.0))
            pred = jnp.argmax(logits, axis=-1)
            stats = {
                "xent": -jnp.sum(jnp.where(
                    mask_seg, jnp.maximum(jax.lax.stop_gradient(picked), -1e10),
                    0.0)),
                "correct": jnp.sum(jnp.where(mask_seg, pred == labels_seg,
                                             False).astype(jnp.int32)),
                "frames": jnp.sum(mask_seg.astype(jnp.int32)),
            }
            return loss, (stats, h_new)

        mesh = self.mesh

        def utt_step(params, velocity, acc, feats, labels, mask):
            """feats (n_seg, B, K, D); scan segments, truncating grads at
            boundaries via stop_gradient on the carried state. Under a
            mesh this body runs per data shard (B = local utterances) and
            the segment gradient/stats psum over the axis before the
            replicated update."""
            B = feats.shape[1]
            h_init = [jnp.zeros((B, net.specs[i].n_outputs), jnp.float32)
                      for i in self.rec_idx]

            def body(carry, seg):
                params, velocity, acc, h_list = carry
                x_seg, l_seg, m_seg = seg
                h_list = [jax.lax.stop_gradient(h) for h in h_list]
                if cfg.crossvalidate:
                    _, (stats, h_new) = seg_loss(params, x_seg, l_seg,
                                                 m_seg, h_list)
                    if mesh is not None:
                        stats = {k: jax.lax.psum(v, "data")
                                 for k, v in stats.items()}
                else:
                    (_, (stats, h_new)), grads = jax.value_and_grad(
                        seg_loss, has_aux=True)(params, x_seg, l_seg,
                                                m_seg, h_list)
                    if mesh is not None:
                        grads = [{k: jax.lax.psum(v, "data")
                                  for k, v in g.items()} for g in grads]
                        stats = {k: jax.lax.psum(v, "data")
                                 for k, v in stats.items()}
                    # all-masked padding segments (bucketed n_seg) must be
                    # exact no-ops: momentum/L2 would otherwise coast on
                    # zero grads and drift the params
                    new_p, new_v = apply_updates(
                        net, params, velocity, grads, cfg.sgd,
                        jnp.maximum(stats["frames"], 1), factors)
                    live = stats["frames"] > 0
                    params = jax.tree_util.tree_map(
                        lambda a, b: jnp.where(live, a, b), new_p, params)
                    velocity = jax.tree_util.tree_map(
                        lambda a, b: jnp.where(live, a, b), new_v, velocity)
                acc = {k: acc[k] + stats[k] for k in acc}
                return (params, velocity, acc, h_new), None

            (params, velocity, acc, _), _ = jax.lax.scan(
                body, (params, velocity, acc, h_init), (feats, labels, mask))
            return params, velocity, acc

        if mesh is None:
            self._utt_step = jax.jit(utt_step, donate_argnums=(0, 1, 2))
        else:
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            param_specs = [{k: P() for k in p} for p in self.params]
            vel_specs = [{k: P() for k in v} for v in self.velocity]
            acc_spec = {k: P() for k in self._zero_acc()}
            self._utt_step = jax.jit(shard_map(
                utt_step, mesh=mesh,
                in_specs=(param_specs, vel_specs, acc_spec,
                          P(None, "data", None, None),
                          P(None, "data", None), P(None, "data", None)),
                out_specs=(param_specs, vel_specs, acc_spec),
                check_vma=False), donate_argnums=(0, 1, 2))
        if cfg.frame_serial:
            self._build_serial()

    # ------------------------------------------------------------------
    # Exact frame-serial mode (TRecurrentCu.cc:357-371 main loop +
    # cuRecurrent.cc:86-153 Update): per frame, forward one row through
    # the whole stack, err = y − t, per-frame update of every updatable
    # layer; the recurrent layer walks its [x_t; y_{t-1}] history ring
    # with rank-1 corrections. Implemented as a lax.scan over frames with
    # (params, velocity, history, bias-correction) in the carry; padding
    # frames are masked by selecting the old state.
    def _build_serial(self):
        cfg, net = self.cfg, self.net
        if len(self.rec_idx) != 1:
            raise ValueError("frame-serial mode supports exactly one "
                             "<recurrent> layer")
        ridx = self.rec_idx[0]
        rspec = net.specs[ridx]
        n_in_r, n_out_r = rspec.n_inputs, rspec.n_outputs
        K = cfg.bptt_order
        below = net.specs[:ridx]
        above = net.specs[ridx + 1:]
        if not (above and isinstance(above[-1], Softmax)):
            raise ValueError("recurrent trainer expects terminal <softmax>")
        n_out = net.n_outputs
        factors = self.factors
        sgd = cfg.sgd
        lr_r = sgd.learning_rate * factors[ridx]
        # the recurrent layer updates manually below (its own momentum /
        # decay quirks); mask it out of the generic SGD step
        factors_no_r = tuple(0.0 if i == ridx else f
                             for i, f in enumerate(factors))

        def below_fn(pb, x):
            for spec, p in zip(below, pb):
                x = spec.apply(p, x)
            return x

        def above_loss(pa, y, label):
            h = y
            for spec, p in zip(above[:-1], pa[:-1]):
                h = spec.apply(p, h)
            lp = jax.nn.log_softmax(h, axis=-1)
            picked = jnp.sum(
                lp * jax.nn.one_hot(label, n_out, dtype=lp.dtype)[None, :])
            pred = jnp.argmax(h[0])
            stats = {
                "xent": -jnp.maximum(jax.lax.stop_gradient(picked), -1e10),
                "correct": (pred == label).astype(jnp.int32),
                "frames": jnp.asarray(1, jnp.int32),
            }
            return -picked, stats

        def frame_step(carry, frame):
            params, velocity, hist, y_prev, bias_corr, acc = carry
            x, label, m = frame                     # x (D,), scalars
            pb = params[:ridx]
            pa = params[ridx + 1:]
            W = params[ridx]["weight"]              # (in+out, out)
            b = params[ridx]["bias"]

            u, vjp_b = jax.vjp(lambda p: below_fn(p, x[None, :]), pb)
            # history row 0 is [x_t; y_{t-1}] composed from the layer's
            # persistent output buffer (cuRecurrent.cc PropagateFnc:28-32;
            # CuMatrix::Init is a no-op on same dims so Y persists) — the
            # fed-back y is the real previous output, carried in the scan
            h_in = jnp.concatenate([u[0], y_prev])
            new_hist = jnp.concatenate([h_in[None, :], hist[:-1]], axis=0)
            y = jax.nn.sigmoid(h_in @ W + b)        # (n_out_r,)

            loss, vjp_a, stats = jax.vjp(
                lambda p, yy: above_loss(p, yy, label), pa, y[None, :],
                has_aux=True)
            grads_a, g_y = vjp_a(jnp.ones(()))
            e_rec = g_y[0]                          # (n_out_r,)

            # cuRecurrent::Update — present-frame + BPTT corrections
            d = e_rec * y * (1.0 - y)
            corr_W = jnp.outer(new_hist[0], d)
            new_bias_corr = sgd.momentum * bias_corr - lr_r * d
            W_h = W[n_in_r:]
            for i in range(1, K + 1):
                e_part = d @ W_h.T
                y_hist = new_hist[i - 1, n_in_r:]   # y_{t-i}
                d = e_part * y_hist * (1.0 - y_hist)
                corr_W = corr_W + jnp.outer(new_hist[i], d)
                new_bias_corr = new_bias_corr - lr_r * d
            new_W = W - lr_r * corr_W - lr_r * sgd.weightcost * W
            new_b = b + new_bias_corr

            # error into the below stack (BackpropagateFnc: W[:n_in] @ d0)
            d0 = e_rec * y * (1.0 - y)
            e_below = (d0 @ W[:n_in_r].T)[None, :]
            (grads_b,) = vjp_b(e_below)

            grads = (list(grads_b)
                     + [{"weight": jnp.zeros_like(W),
                         "bias": jnp.zeros_like(b)}]
                     + list(grads_a))
            new_params, new_velocity = apply_updates(
                net, params, velocity, grads, sgd, 1, factors_no_r)
            new_params[ridx] = {"weight": new_W, "bias": new_b}

            # masked (padding) frame: keep everything unchanged
            sel = lambda new, old: jax.tree_util.tree_map(
                lambda a, o: jnp.where(m, a, o), new, old)
            params = sel(new_params, params)
            velocity = sel(new_velocity, velocity)
            hist = jnp.where(m, new_hist, hist)
            y_prev = jnp.where(m, y, y_prev)
            bias_corr = jnp.where(m, new_bias_corr, bias_corr)
            stats = {k: jnp.where(m, v, jnp.zeros_like(v))
                     for k, v in stats.items()}
            acc = {k: acc[k] + stats[k] for k in acc}
            return (params, velocity, hist, y_prev, bias_corr, acc), None

        def serial_utt(params, velocity, acc, y_prev, bias_corr,
                       feats, labels, mask):
            # per-utterance ClearHistory zeroes only the history ring
            # (cuRecurrent.h:36-38, TRecurrentCu.cc:345-350); the output
            # buffer y and the bias-correction accumulator persist across
            # utterances, so they come in through the carry arguments
            hist = jnp.zeros((K + 1, n_in_r + n_out_r), jnp.float32)
            (params, velocity, _, y_prev, bias_corr, acc), _ = jax.lax.scan(
                frame_step,
                (params, velocity, hist, y_prev, bias_corr, acc),
                (feats, labels, mask))
            return params, velocity, acc, y_prev, bias_corr

        self._serial_utt = jax.jit(serial_utt, donate_argnums=(0, 1, 2))
        self._serial_y = jnp.zeros((n_out_r,), jnp.float32)
        self._serial_bias_corr = jnp.zeros((n_out_r,), jnp.float32)

    def train_utterance_serial(self, feats: np.ndarray,
                               labels: np.ndarray) -> None:
        """Frame-serial parity training of one utterance (padded to a
        64-frame grid to bound recompilation across lengths)."""
        T, D = feats.shape
        Tp = -(-T // 64) * 64
        F = np.zeros((Tp, D), np.float32)
        L = np.zeros((Tp,), np.int32)
        M = np.zeros((Tp,), bool)
        F[:T], L[:T], M[:T] = feats, labels, True
        acc = self._zero_acc()
        (self.params, self.velocity, acc,
         self._serial_y, self._serial_bias_corr) = self._serial_utt(
            self.params, self.velocity, acc,
            self._serial_y, self._serial_bias_corr,
            jnp.asarray(F), jnp.asarray(L), jnp.asarray(M))
        self._accs.append(acc)

    def _zero_acc(self):
        return {"xent": jnp.zeros((), jnp.float32),
                "correct": jnp.zeros((), jnp.int32),
                "frames": jnp.zeros((), jnp.int32)}

    def train_utterance(self, feats: np.ndarray, labels: np.ndarray) -> None:
        self.train_batch([feats], [labels])

    def train_batch(self, feats_list, labels_list) -> None:
        """Train a batch of utterances together (the batched mode).

        Utterances are padded to a common segment grid and scanned as one
        program; each segment step updates once with the summed gradient
        over the batch — batched truncated BPTT. With a single utterance
        this reduces to the utterance-serial behavior.
        """
        K = self.cfg.bptt_order
        D = feats_list[0].shape[1]
        if self.mesh is not None:
            # pad the utterance batch to a multiple of the data axis with
            # empty (all-masked) utterances — exact no-ops in the step
            d = self.mesh.shape["data"]
            feats_list = list(feats_list)
            labels_list = list(labels_list)
            while len(feats_list) % d:
                feats_list.append(np.zeros((0, D), np.float32))
                labels_list.append(np.zeros((0,), np.int32))
        B = len(feats_list)
        T_max = max(f.shape[0] for f in feats_list)
        # n_seg bucketed to multiples of 16: every distinct scan length is
        # a distinct XLA program;
        # the all-masked padding segments are exact no-ops (see utt_step)
        n_seg = -(-(-(-T_max // K)) // 16) * 16
        F = np.zeros((B, n_seg * K, D), np.float32)
        L = np.zeros((B, n_seg * K), np.int32)
        M = np.zeros((B, n_seg * K), bool)
        for b, (f, l) in enumerate(zip(feats_list, labels_list)):
            T = f.shape[0]
            F[b, :T] = f
            L[b, :T] = l
            M[b, :T] = True
        # (n_seg, B, K, ...) so lax.scan walks segments
        F = np.moveaxis(F.reshape(B, n_seg, K, D), 0, 1)
        L = np.moveaxis(L.reshape(B, n_seg, K), 0, 1)
        M = np.moveaxis(M.reshape(B, n_seg, K), 0, 1)
        acc = self._zero_acc()
        self.params, self.velocity, acc = self._utt_step(
            self.params, self.velocity, acc,
            jnp.asarray(F), jnp.asarray(L), jnp.asarray(M))
        self._accs.append(acc)

    def run_epoch(self, utterances, batch_utts: int = 1) -> None:
        pend_f, pend_l = [], []
        for feats, labels in utterances:
            pend_f.append(np.asarray(feats, np.float32))
            pend_l.append(np.asarray(labels, np.int32))
            if len(pend_f) >= batch_utts:
                self.train_batch(pend_f, pend_l)
                pend_f, pend_l = [], []
        if pend_f:
            self.train_batch(pend_f, pend_l)
        self._flush_acc()

    def updated_network(self) -> Network:
        host = [{k: np.asarray(v) for k, v in p.items()} for p in self.params]
        return Network(self.net.specs, host)

    def report(self) -> str:
        return self.stats.report()
