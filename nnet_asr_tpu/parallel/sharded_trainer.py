"""Multi-device trainer: the Trainer epoch loop over the sharded step.

Drop-in for train.Trainer when more than one device is visible (the
cards of a host, or the virtual CPU mesh in tests): batches shard over
the ``data`` axis, gradients psum across devices, the senone output layer
lives column-sharded over ``model`` (auto-padded when the senone count
doesn't divide the axis). CE with plain or Block softmax heads and the MSE objective are
supported, matching the single-chip trainer.

Multi-host runs (``jax.distributed.initialize()`` done by the caller) use
PER-HOST input sharding — each process reads only its own SCP shard and
feeds only its local slice of every global bunch (the device analog of
SURVEY.md §2.9's "per-host data loading"; the round-1 design where every
host read the full global batch is gone). Hosts stay in lockstep through
a drain-negotiation protocol: each fill round, every host offers the
bunch count its local cache can produce, the fleet agrees on the minimum
(one tiny ``process_allgather``), drains exactly that many global bunches,
and carries its surplus rows to the next round. When the first host runs
dry the epoch ends and every host logs its dropped remainder — the
multi-host generalization of the reference Cache's sub-bunch tail discard
(Cache.cc:239-244); balanced SCP shards (TJoiner/TSegmenter-style
splitting) keep the drop below one local bunch.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.network import Network
from ..ops.objectives import MseStats, XentStats
from ..train.cache import DeviceFrameCache
from ..train.pipeline import TransformPipeline
from ..train.trainer import TrainerConfig
from .sharded_step import make_sharded_train_step, zero_acc


def _local_row_fraction(mesh: Mesh) -> float:
    """Fraction of a ``P('data')``-sharded axis this process holds."""
    sh = NamedSharding(mesh, P("data"))
    probe = mesh.shape["data"] * 8
    spans = set()
    for dev, idx in sh.addressable_devices_indices_map((probe,)).items():
        sl = idx[0]
        spans.add((sl.start or 0, probe if sl.stop is None else sl.stop))
    return sum(b - a for a, b in spans) / probe


class ShardedTrainer:
    """Epoch driver matching train.Trainer's interface on a device mesh."""

    def __init__(self, net: Network, cfg: TrainerConfig, mesh: Mesh,
                 transform: Optional[Network] = None,
                 start_frm_ext: int = 0, end_frm_ext: int = 0):
        net.check_dims()
        self.net = net
        self.cfg = cfg
        self.mesh = mesh
        self.pipeline = TransformPipeline(transform, start_frm_ext, end_frm_ext)
        self.state, self._step, self._eval, self._fns = \
            make_sharded_train_step(net, cfg.sgd, mesh,
                                    objective=cfg.objective,
                                    scan_unroll=cfg.scan_unroll,
                                    compute_dtype=cfg.compute_dtype)
        self.state.to_device(mesh)
        self._sr = cfg.compute_dtype == "int8pfsr"
        if self._sr:
            # stochastic-rounding key: same init and per-cache COPY
            # protocol as train.Trainer._zero_acc (accs are donated)
            self._sr_key = jax.random.PRNGKey(cfg.seed or 1)
        self._lr = jnp.float32(cfg.sgd.learning_rate)
        self.stats = XentStats() if cfg.objective == "xent" else MseStats()
        self.total_frames = 0
        self.wall = 0.0
        self._accs = []
        d = mesh.shape["data"]
        if cfg.bunchsize % d:
            raise ValueError(
                f"bunchsize {cfg.bunchsize} not divisible by data axis {d}")
        self.n_proc = jax.process_count()
        frac = _local_row_fraction(mesh) if self.n_proc > 1 else 1.0
        self.local_bunch = int(round(cfg.bunchsize * frac))
        self.local_cache = int(round(cfg.cachesize * frac))
        if abs(self.local_bunch - cfg.bunchsize * frac) > 1e-6:
            raise ValueError(
                f"bunchsize {cfg.bunchsize} not divisible across "
                f"{self.n_proc} processes (local fraction {frac})")
        if self.local_cache % self.local_bunch:
            raise ValueError(
                f"cachesize {cfg.cachesize} not divisible by bunchsize "
                f"under the per-process split")
        self._feats_sh = NamedSharding(mesh, P(None, "data", None))
        self._labels_sh = NamedSharding(mesh, P(None, "data"))

    @property
    def params(self):
        return self.state.params

    def set_learning_rate(self, lr: float) -> None:
        self._lr = jnp.float32(lr)

    def reload_params(self, host_params: List[dict]) -> None:
        """Replace params from host arrays (true senone count), re-padding
        and re-placing with the state's shardings; velocity resets to zero
        (the reference's per-epoch optimizer-state lifetime,
        Platform.h:143-197). The resident newbob's per-epoch reload."""
        st = self.state
        padded = []
        for i, p in enumerate(host_params):
            p = {k: np.asarray(v) for k, v in p.items()}
            if i == st.out_idx and st.n_out_pad != st.n_out:
                pad = st.n_out_pad - st.n_out
                p["weight"] = np.pad(p["weight"], ((0, 0), (0, pad)))
                p["bias"] = np.pad(p["bias"], (0, pad))
            padded.append(p)
        st.params = [
            {k: jax.device_put(v, NamedSharding(self.mesh, st.param_specs[i][k]))
             for k, v in p.items()}
            for i, p in enumerate(padded)]
        st.velocity = [
            {k: jnp.zeros_like(v) for k, v in p.items() if k in vel}
            for p, vel in zip(st.params, st.velocity)]

    # -- drain ----------------------------------------------------------
    def _assemble_on_device(self, arr, sharding, global_shape):
        """Local (nb, B_loc, ...) device array → global sharded array with
        NO host round-trip: slice the local stack into this process's
        per-device stripes (device-side slices + D2D device_put) and
        assemble with make_array_from_single_device_arrays. Replaces the
        round-2 np.asarray → make_array_from_process_local_data hop that
        dragged every cache fill through host memory."""
        idx_map = sharding.addressable_devices_indices_map(global_shape)
        spans = {}
        for dev, idx in idx_map.items():
            sl = idx[1]                       # bunch rows ride axis 1
            a = sl.start or 0
            b = global_shape[1] if sl.stop is None else sl.stop
            spans[dev] = (a, b)
        proc_start = min(a for a, _ in spans.values())
        shards = [
            jax.device_put(arr[:, a - proc_start:b - proc_start], dev)
            for dev, (a, b) in spans.items()]
        return jax.make_array_from_single_device_arrays(
            global_shape, sharding, shards)

    def _globalize(self, feats_all, labels_all):
        """Local (nb, B_loc, ...) device arrays → global sharded arrays."""
        if self.n_proc == 1:
            return (jax.device_put(feats_all, self._feats_sh),
                    jax.device_put(labels_all, self._labels_sh))
        # multi-host: each process contributes its addressable slice of
        # the global bunch axis (per-host data loading), device-resident
        nb = feats_all.shape[0]
        f = self._assemble_on_device(
            feats_all, self._feats_sh,
            (nb, self.cfg.bunchsize, feats_all.shape[2]))
        l = self._assemble_on_device(
            labels_all, self._labels_sh, (nb, self.cfg.bunchsize))
        return f, l

    def _drain_stacked(self, stacked) -> None:
        if stacked is None:
            return
        fsh, lsh = self._globalize(*stacked)
        acc = zero_acc(self.cfg.objective)
        if self._sr:
            acc["_sr_key"] = jnp.array(self._sr_key, copy=True)
        if self.cfg.crossvalidate:
            acc = self._fns["drain_eval"](self.state.params, acc, fsh, lsh)
        else:
            self.state.params, self.state.velocity, acc = \
                self._fns["drain_train"](self.state.params,
                                         self.state.velocity, acc, fsh, lsh,
                                         self._lr)
        if "_sr_key" in acc:
            self._sr_key = acc["_sr_key"]
        # per-cache stats stay on device until epoch end (no mid-epoch
        # host sync); merged per cache in f64, like train.Trainer
        self._accs.append(acc)

    def _flush_acc(self) -> None:
        for acc in self._accs:
            if self.cfg.objective == "xent":
                self.stats.add(float(acc["xent"]), int(acc["frames"]),
                               int(acc["correct"]))
            else:
                self.stats.add(float(acc["mse"]), int(acc["frames"]))
        self._accs = []

    # -- epoch ----------------------------------------------------------
    def run_epoch(self, utterances: Iterable[Tuple[np.ndarray, np.ndarray]],
                  batch_utts: int = 32) -> None:
        import time

        t0 = time.time()
        cache = DeviceFrameCache(self.local_cache, self.local_bunch,
                                 self.cfg.seed, self.cfg.randomize)
        it = iter(utterances)
        exhausted = False

        def fill():
            nonlocal exhausted
            pend_f: List[np.ndarray] = []
            pend_l: List[np.ndarray] = []

            def flush():
                if not pend_f:
                    return
                # shape-stable intake (see train.Trainer.run_epoch)
                rows, valid = self.pipeline.transform_block(pend_f)
                labels_block = np.concatenate(pend_l)
                self.total_frames += valid
                cache.add_block(rows, valid, labels_block)
                pend_f.clear()
                pend_l.clear()

            while not cache.full and not exhausted:
                try:
                    feats, labels = next(it)
                except StopIteration:
                    exhausted = True
                    break
                pend_f.append(np.asarray(feats, np.float32))
                pend_l.append(np.asarray(labels, np.int32))
                if len(pend_f) >= batch_utts:
                    flush()
            flush()

        if self.n_proc == 1:
            while True:
                fill()
                while cache.full:
                    self._drain_stacked(cache.take_stacked())
                if exhausted:
                    break
            if cache.rows > 0:
                self._drain_stacked(cache.take_stacked())
        else:
            from jax.experimental import multihost_utils

            while True:
                fill()
                nb_local = min(cache.rows, cache.cachesize) // self.local_bunch
                offers = np.asarray(multihost_utils.process_allgather(
                    np.int32(nb_local)))
                agreed = int(offers.min())
                if agreed == 0:
                    break
            # hosts agreed: drain exactly `agreed` bunches, carry surplus
                self._drain_stacked(cache.take_stacked(max_bunches=agreed))
            if cache.rows > 0:
                print(f"[sharded] host {jax.process_index()}: dropping "
                      f"{cache.rows} unmatched frames at epoch end "
                      f"(unbalanced SCP shards)", flush=True)
        self._flush_acc()
        self.wall += time.time() - t0

    # -- checkpoint/resume ------------------------------------------------
    # Same npz key format as train.Trainer (p{i}.{k} / v{i}.{k} / _stats),
    # saved UNPADDED, so states interoperate between the single-chip and
    # mesh trainers (a --MESH run can resume a single-chip state and vice
    # versa); senone padding is re-applied at load.
    def _unpad(self, i: int, a: np.ndarray) -> np.ndarray:
        st = self.state
        if i == st.out_idx and st.n_out_pad != st.n_out:
            return a[:, :st.n_out] if a.ndim == 2 else a[:st.n_out]
        return a

    def _pad(self, i: int, a: np.ndarray) -> np.ndarray:
        st = self.state
        if i == st.out_idx and st.n_out_pad != st.n_out:
            pad = st.n_out_pad - st.n_out
            return (np.pad(a, ((0, 0), (0, pad))) if a.ndim == 2
                    else np.pad(a, (0, pad)))
        return a

    def save_state(self, path: str) -> None:
        st = self.state
        arrs = {}
        for i, p in enumerate(st.host_params()):      # already unpadded
            for k, v in p.items():
                arrs[f"p{i}.{k}"] = v
        for i, v in enumerate(st.velocity):
            for k, vv in v.items():
                # npz can't represent bf16; store f32, recast on load
                arrs[f"v{i}.{k}"] = self._unpad(
                    i, np.asarray(vv, dtype=np.float32))
        arrs["_stats"] = np.asarray(
            [self.stats.error, self.stats.frames,
             getattr(self.stats, "corr", 0)], dtype=np.float64)
        np.savez(path, **arrs)

    def load_state(self, path: str) -> None:
        data = np.load(path)
        st = self.state

        def put(i, k, a):
            return jax.device_put(
                self._pad(i, a),
                NamedSharding(self.mesh, st.param_specs[i][k]))

        st.params = [
            {k: (put(i, k, data[f"p{i}.{k}"]) if f"p{i}.{k}" in data else v)
             for k, v in p.items()}
            for i, p in enumerate(st.params)]
        st.velocity = [
            {k: (put(i, k, data[f"v{i}.{k}"].astype(v.dtype))
                 if f"v{i}.{k}" in data else jnp.zeros_like(v))
             for k, v in p.items()}
            for i, p in enumerate(st.velocity)]
        s = data["_stats"]
        self.stats.error = float(s[0])
        self.stats.frames = int(s[1])
        if hasattr(self.stats, "corr"):
            self.stats.corr = int(s[2])

    def updated_network(self) -> Network:
        return Network(self.net.specs, self.state.host_params())

    def report(self) -> str:
        return self.stats.report()

    def throughput_report(self) -> str:
        fps = self.total_frames / max(self.wall, 1e-9)
        return (f"Done {self.total_frames} frames in {self.wall:.2f}s"
                f" [FPS:{fps:.1f},RT:{fps / 100.0:.4f}]"
                f" mesh=data:{self.mesh.shape['data']}"
                f"xmodel:{self.mesh.shape['model']}\n")
