"""Single-chip frame-level trainer (TNet/TNetCu equivalent).

The epoch loop mirrors TNetCu.cc:376-442 — fill the device cache through the
transform pipeline, shuffle, iterate fixed-size bunches through one jitted
train step (forward + CE/MSE + backward + SGD update fused into a single XLA
program) — with the CPU tool's crossvalidate mode (TNet.cc:96-231) as a
forward-only variant. Objective statistics accumulate on device within a
cache and merge into float64 host totals at cache boundaries, preserving the
reference's double-precision reporting (ObjFun.h:16-54).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..models.components import BlockSoftmax, Softmax
from ..models.network import Network
from ..ops.objectives import (MseStats, XentStats, mse_loss_and_stats,
                              softmax_identity_backward, xent_loss_and_stats)
from ..utils.profiler import profiler
from .cache import DeviceFrameCache
from .pipeline import TransformPipeline
from .sgd import SgdConfig, apply_updates, init_momentum, layer_lr_factors


@dataclass
class TrainerConfig:
    bunchsize: int = 256
    cachesize: int = 12800
    seed: int = 0
    randomize: bool = True
    crossvalidate: bool = False
    objective: str = "xent"          # 'xent' | 'mse'
    sgd: SgdConfig = field(default_factory=SgdConfig)
    trace: int = 0
    # 'bf16' runs the matmuls in bfloat16 (f32 master params, f32 loss/
    # stats/update); None = full f32
    compute_dtype: Optional[str] = None
    # CONFUSIONMODE: no|max|soft|dmax|dsoft (ObjFun.cc:132-155) —
    # accumulated on device as label^T @ {onehot(pred) | posteriors}
    confusion_mode: str = "no"
    # drain-scan partial unroll: lets XLA overlap step k+1's weight/input
    # loads with step k's compute. The default of 8 is to be settled by a
    # measurement on the H100 (ROADMAP.md queue 1 #4).
    scan_unroll: int = 8

    def __post_init__(self):
        if self.scan_unroll < 1:
            raise ValueError(f"scan_unroll must be >= 1, got {self.scan_unroll}")


class Trainer:
    def __init__(self, net: Network, cfg: TrainerConfig,
                 transform: Optional[Network] = None,
                 start_frm_ext: int = 0, end_frm_ext: int = 0):
        net.check_dims()
        self.net = net
        self.cfg = cfg
        self.pipeline = TransformPipeline(transform, start_frm_ext, end_frm_ext)
        self.factors = tuple(layer_lr_factors(net, cfg.sgd))
        self.params = [dict(p) for p in net.params]
        self.velocity = init_momentum(net, cfg.sgd.momentum, cfg.sgd.velocity_dtype)
        self.stats = XentStats() if cfg.objective == "xent" else MseStats()
        self._build_steps()
        self.total_frames = 0
        self.wall = 0.0
        self._accs = []
        # runtime learning rate (newbob halving without recompiles)
        self._lr = jnp.float32(cfg.sgd.learning_rate)

    def set_learning_rate(self, lr: float) -> None:
        self._lr = jnp.float32(lr)

    # ------------------------------------------------------------------
    def _split_head(self):
        """Separate a terminal (Block)Softmax for the fused-CE path."""
        specs = self.net.specs
        if specs and isinstance(specs[-1], Softmax):
            return specs[:-1], None, True
        if specs and isinstance(specs[-1], BlockSoftmax):
            return specs[:-1], specs[-1].dims, True
        return specs, None, False

    def _build_steps(self):
        cfg = self.cfg
        body_specs, block_dims, has_softmax = self._split_head()
        n_out = self.net.n_outputs

        bf16 = cfg.compute_dtype == "bf16"
        int8 = cfg.compute_dtype in ("int8", "int8pf", "int8pfsr",
                                     "int8full")
        # 'int8pf': per-frame (row) activation scales instead of
        # per-tensor — finer, and still valid for an int8 GEMM (a row
        # scale factors out of the contraction like the per-output-channel weight
        # scale). 'int8pfsr' additionally rounds the activation
        # quantizer STOCHASTICALLY during training (round-to-nearest at
        # eval) so the quantization error is zero-mean instead of biased
        # once the LR anneals below the noise floor.
        act_axis = (-1 if cfg.compute_dtype in ("int8pf", "int8pfsr")
                    else None)
        sr = cfg.compute_dtype == "int8pfsr"

        def _cast(v):
            return v.astype(jnp.bfloat16) if bf16 else v

        def _fq(t, axis=None, key=None):
            # int8 fake-quant with straight-through gradients: the
            # quantize-dequantize arithmetic of an int8 GEMM
            # (per-output-channel weights / per-tensor activations,
            # train/pipeline.py) computed in f32 so jax.grad sees an
            # identity — the convergence-experiment mode behind
            # compute_dtype='int8'
            s = (jnp.max(jnp.abs(t), axis=axis, keepdims=axis is not None)
                 / 127.0 + 1e-12)
            if key is not None:
                # stochastic rounding: floor(x + u), u ~ U[0,1) — unbiased
                u = jax.random.uniform(key, t.shape, dtype=t.dtype)
                q = jnp.clip(jnp.floor(t / s + u), -127, 127) * s
            else:
                q = jnp.clip(jnp.round(t / s), -127, 127) * s
            return t + jax.lax.stop_gradient(q - t)

        def forward_logits(params, x, key=None):
            from ..models.components import BiasedLinearity as BL

            x = _cast(x)
            for i, spec in enumerate(body_specs):
                if int8 and isinstance(spec, BL):
                    if cfg.compute_dtype == "int8full":
                        # all three GEMMs quantized (ops/int8_train.py)
                        from ..ops.int8_train import qmatmul
                        x = qmatmul(x, params[i]["weight"]) \
                            + params[i]["bias"]
                    else:
                        kk = (jax.random.fold_in(key, i)
                              if key is not None else None)
                        x = (_fq(x, axis=act_axis, key=kk)
                             @ _fq(params[i]["weight"], axis=0)
                             + params[i]["bias"])
                elif bf16 and isinstance(spec, BL):
                    x = (x @ _cast(params[i]["weight"])
                         + _cast(params[i]["bias"]))
                else:
                    x = spec.apply(params[i], x)
            return x.astype(jnp.float32) if bf16 else x

        conf_mode = cfg.confusion_mode

        def _confusion(logits, labels, stats):
            """Device confusion accumulation (ObjFun.cc:132-155)."""
            oh_lab = jax.nn.one_hot(labels, n_out, dtype=jnp.float32)
            if conf_mode in ("max", "dmax"):
                pred = jnp.argmax(jax.lax.stop_gradient(logits), axis=-1)
                x = jax.nn.one_hot(pred, n_out, dtype=jnp.float32)
            else:
                x = jax.nn.softmax(jax.lax.stop_gradient(logits), axis=-1)
            stats["confusion"] = oh_lab.T @ x
            stats["confusion_count"] = jnp.sum(oh_lab, axis=0)
            return stats

        def loss_fn(params, feats, labels, key=None):
            logits = forward_logits(params, feats, key)
            if cfg.objective == "xent":
                if not has_softmax:
                    raise ValueError("CE objective expects a softmax output layer")
                loss, stats = xent_loss_and_stats(logits, labels, block_dims)
                if conf_mode != "no":
                    stats = _confusion(logits, labels, stats)
                return loss, stats
            # MSE against one-hot targets; reference backprops err=y-t
            # through a terminal softmax unchanged (identity backward)
            y = softmax_identity_backward(logits) if has_softmax else logits
            targets = jax.nn.one_hot(labels, n_out, dtype=y.dtype)
            return mse_loss_and_stats(y, targets)

        factors = self.factors
        net = self.net
        sgd_cfg = cfg.sgd

        def train_step(params, velocity, acc, feats, labels, lr=None):
            # ``lr`` (runtime scalar) overrides the compile-time rate:
            # newbob halves the rate between epochs and a traced value
            # keeps one compiled program across the schedule
            key = next_key = None
            if sr:
                # the SR key rides in the stats accumulator so the drain
                # scan needs no signature change; eval stays
                # deterministic (no key -> round-to-nearest)
                next_key, key = jax.random.split(acc["_sr_key"])
            (_, stats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, feats, labels, key)
            params, velocity = apply_updates(
                net, params, velocity, grads, sgd_cfg,
                feats.shape[0], factors, learning_rate=lr)
            acc = {k: acc[k] + stats[k] for k in stats if k in acc}
            if sr:
                acc["_sr_key"] = next_key
            return params, velocity, acc

        def eval_step(acc, params, feats, labels):
            _, stats = loss_fn(params, feats, labels)
            out = {k: acc[k] + stats[k] for k in stats if k in acc}
            for k in acc:              # passthrough (the SR key, if any)
                if k not in stats:
                    out[k] = acc[k]
            return out

        self._train_step = jax.jit(train_step, donate_argnums=(0, 1, 2))
        self._eval_step = jax.jit(eval_step, donate_argnums=(0,))

        # whole-cache drain as ONE program: lax.scan over stacked bunches —
        # removes per-bunch dispatch (the device analog of the reference's
        # tight GetBunch loop, TNetCu.cc:427-441). Partial unrolling lets
        # XLA overlap each bunch's input slice with the previous bunch's
        # compute.
        def _unroll(n_bunches):
            return max(1, min(cfg.scan_unroll, n_bunches))

        def drain_train(params, velocity, acc, feats_all, labels_all,
                        lr=None):
            def body(carry, batch):
                p, v, a = carry
                p, v, a = train_step(p, v, a, batch[0], batch[1], lr)
                return (p, v, a), None
            (params, velocity, acc), _ = jax.lax.scan(
                body, (params, velocity, acc), (feats_all, labels_all),
                unroll=_unroll(feats_all.shape[0]))
            return params, velocity, acc

        def drain_eval(params, acc, feats_all, labels_all):
            def body(a, batch):
                return eval_step(a, params, batch[0], batch[1]), None
            acc, _ = jax.lax.scan(body, acc, (feats_all, labels_all),
                                  unroll=_unroll(feats_all.shape[0]))
            return acc

        self._drain_train = jax.jit(drain_train, donate_argnums=(0, 1, 2))
        self._drain_eval = jax.jit(drain_eval, donate_argnums=(1,))

    def _zero_acc(self):
        if self.cfg.objective == "xent":
            acc = {"xent": jnp.zeros((), jnp.float32),
                   "correct": jnp.zeros((), jnp.int32),
                   "frames": jnp.zeros((), jnp.int32)}
            if self.cfg.confusion_mode != "no":
                n = self.net.n_outputs
                acc["confusion"] = jnp.zeros((n, n), jnp.float32)
                acc["confusion_count"] = jnp.zeros((n,), jnp.float32)
        else:
            acc = {"mse": jnp.zeros((), jnp.float32),
                   "frames": jnp.zeros((), jnp.int32)}
        if self.cfg.compute_dtype == "int8pfsr" and not self.cfg.crossvalidate:
            # stochastic-rounding key: advances per train step inside the
            # drain scan; a fresh per-cache seed would repeat noise.
            # The acc gets a COPY — accs are donated into the drains, and
            # donating the buffer self._sr_key references would delete it
            # out from under the next cache (seen in the resident cv
            # loop, which never updates the key after eval drains)
            self._sr_key = getattr(
                self, "_sr_key", jax.random.PRNGKey(self.cfg.seed or 1))
            acc["_sr_key"] = jnp.array(self._sr_key, copy=True)
        return acc

    def _merge_acc(self, acc):
        if self.cfg.objective == "xent":
            self.stats.add(float(acc["xent"]), int(acc["frames"]), int(acc["correct"]))
            if self.cfg.confusion_mode != "no":
                self.stats.confusion_mode = self.cfg.confusion_mode
                n = self.net.n_outputs
                self.stats._ensure_confusion(n)
                conf = np.asarray(acc["confusion"], dtype=np.float64)
                self.stats.confusion += conf
                self.stats.diag_confusion += np.diag(conf)
                self.stats.confusion_count += np.asarray(
                    acc["confusion_count"], dtype=np.float64)
        else:
            self.stats.add(float(acc["mse"]), int(acc["frames"]))

    # ------------------------------------------------------------------
    def _drain_cache(self, cache) -> None:
        with profiler.phase("cache-randomize"):
            stacked = cache.take_stacked()
        if stacked is None:
            return
        feats_all, labels_all = stacked
        # per-cache stats stay on device until epoch end (fetching them
        # per drain would force a host sync that stalls the async dispatch
        # pipeline); they merge into the float64 host totals one cache at
        # a time, preserving the reference's per-cache MergeStats
        # precision (ObjFun.h:16-54)
        acc = self._zero_acc()
        with profiler.phase("train-step" if not self.cfg.crossvalidate
                            else "eval-step"):
            if self.cfg.crossvalidate:
                acc = self._drain_eval(self.params, acc, feats_all, labels_all)
            else:
                self.params, self.velocity, acc = self._drain_train(
                    self.params, self.velocity, acc, feats_all, labels_all,
                    self._lr)
        if "_sr_key" in acc:
            # carry the advanced SR key into the next cache's accumulator
            # (device array, no host sync)
            self._sr_key = acc["_sr_key"]
        self._accs.append(acc)

    def _flush_acc(self) -> None:
        for acc in self._accs:
            self._merge_acc(acc)
        self._accs = []

    def run_epoch(self, utterances: Iterable[Tuple[np.ndarray, np.ndarray]],
                  batch_utts: int = 32) -> None:
        """Train/evaluate one epoch.

        ``utterances`` yields (ext_feats (T+ext, D_in) float32, labels (T,) int32).
        ``batch_utts`` utterances are transformed together per pipeline call.
        """
        t0 = time.time()
        cache = DeviceFrameCache(self.cfg.cachesize, self.cfg.bunchsize,
                                 self.cfg.seed, self.cfg.randomize)
        pend_feats, pend_labels = [], []

        def flush_pending():
            if not pend_feats:
                return
            # shape-stable intake: one bucket-padded device block per batch
            # (transform_block) + fixed-buffer cache writes — the steady
            # state reuses a handful of compiled programs no matter how
            # utterance/batch lengths vary (each distinct shape is a fresh
            # XLA compile)
            with profiler.phase("transform"):
                rows, valid = self.pipeline.transform_block(pend_feats)
            labels_block = np.concatenate(pend_labels)
            assert labels_block.shape[0] == valid
            self.total_frames += valid
            cache.add_block(rows, valid, labels_block)
            while cache.full:
                self._drain_cache(cache)
            pend_feats.clear()
            pend_labels.clear()

        for ext_feats, labels in utterances:
            pend_feats.append(np.asarray(ext_feats, dtype=np.float32))
            pend_labels.append(np.asarray(labels, dtype=np.int32))
            if len(pend_feats) >= batch_utts:
                flush_pending()
        flush_pending()
        # last (partial) cache
        if cache.rows > 0:
            self._drain_cache(cache)
        self._flush_acc()
        self.wall += time.time() - t0

    # ------------------------------------------------------------------
    # checkpoint/resume: the reference only resumes from epoch MMFs
    # (optimizer state lives and dies within an epoch process,
    # SURVEY.md §5); here the full training state round-trips.
    def save_state(self, path: str) -> None:
        arrs = {}
        for i, p in enumerate(self.params):
            for k, v in p.items():
                arrs[f"p{i}.{k}"] = np.asarray(v)
        for i, v in enumerate(self.velocity):
            for k, vv in v.items():
                # npz can't represent bf16 (loads back as raw V2);
                # store f32 and recast to the live dtype on load
                arrs[f"v{i}.{k}"] = np.asarray(vv, dtype=np.float32)
        arrs["_rng_x"] = np.asarray([getattr(self, "_cache_rng_x", 0)],
                                    dtype=np.uint64)
        arrs["_stats"] = np.asarray(
            [self.stats.error, self.stats.frames,
             getattr(self.stats, "corr", 0)], dtype=np.float64)
        np.savez(path, **arrs)

    def load_state(self, path: str) -> None:
        data = np.load(path)
        for i in range(len(self.params)):
            for k in self.params[i]:
                key = f"p{i}.{k}"
                if key in data:
                    self.params[i][k] = jnp.asarray(data[key])
        for i in range(len(self.velocity)):
            for k in self.velocity[i]:
                key = f"v{i}.{k}"
                if key in data:
                    self.velocity[i][k] = jnp.asarray(
                        data[key], dtype=self.velocity[i][k].dtype)
        st = data["_stats"]
        self.stats.error = float(st[0])
        self.stats.frames = int(st[1])
        if hasattr(self.stats, "corr"):
            self.stats.corr = int(st[2])

    def updated_network(self) -> Network:
        host = [{k: np.asarray(v) for k, v in p.items()} for p in self.params]
        return Network(self.net.specs, host)

    def report(self) -> str:
        return self.stats.report()

    def throughput_report(self) -> str:
        fps = self.total_frames / max(self.wall, 1e-9)
        rt = fps / 100.0
        return (f"Done {self.total_frames} frames in {self.wall:.2f}s"
                f" [FPS:{fps:.1f},RT:{rt:.4f}]\n")
