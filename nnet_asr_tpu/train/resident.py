"""Device-resident newbob training: the persistent-worker fast path.

The reference scheduler restarts a TNet process per epoch; even our
in-process scheduler re-reads and re-transforms every feature file each
iteration, and that intake can take most of an epoch's wall time.
Because TNet fixes
the shuffle seed per epoch (--SEED is constant across scheduler
iterations, run_test.CPU.sh:55-70), every epoch trains on the IDENTICAL
bunch sequence — so the epoch-1 stacked bunches can live in HBM and every
later epoch is nothing but the fused drain scans:

    read + transform + shuffle ONCE  →  (nb, bunch, D) stacks in HBM
    per epoch: reload params from the newbob-selected MMF, reset momentum
    (the reference's per-process optimizer state, Platform.h:143-197),
    run drain_train over the cached stacks with the epoch's learning rate
    as a RUNTIME scalar (no recompiles across newbob halving), write the
    epoch MMF.

Bit-equivalence with the streaming path holds because the MMF writer
round-trips float32 exactly (9 significant digits, docs/DEVIATIONS.md §4)
and the drain programs are the same XLA computations.

Composition with the device mesh (round 3): pass ``mesh`` and the stacks
live SHARDED in HBM (``P(None, 'data', None)`` — each chip holds only its
batch stripe) while params/velocity ride the ShardedTrainState shardings;
every epoch runs the sharded drain scans (parallel/sharded_step.py), so
the two fastest modes — resident intake amortization and multi-chip
compute — stack.

Memory bound + partial-residency fallback: by default the whole
(transformed) training set must fit in HBM (131 MB for example-01). With
``hbm_budget_bytes`` set, stacks beyond the budget stay as HOST numpy
buffers and stream onto the device once per epoch (H2D only — still no
re-read/re-transform/re-shuffle); the trajectory is bit-identical either
way because placement timing doesn't change the math.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..models.network import Network
from ..ops.objectives import MseStats, XentStats
from .cache import DeviceFrameCache
from .pipeline import TransformPipeline
from .sgd import init_momentum
from .trainer import Trainer, TrainerConfig


class _Stack:
    """One cache's stacked bunches: device-resident or host-parked."""

    __slots__ = ("feats", "labels", "on_device")

    def __init__(self, feats, labels, on_device: bool):
        self.feats = feats
        self.labels = labels
        self.on_device = on_device

    @property
    def nbytes(self) -> int:
        return self.feats.nbytes + self.labels.nbytes


class ResidentNewbob:
    """Builds newbob train/crossvalidate closures over HBM-cached bunches.

    ``mesh``: optional jax.sharding.Mesh — stacks shard over the ``data``
    axis and epochs run the ShardedTrainer drains (single process only).
    ``hbm_budget_bytes``: optional cap on resident stack bytes; overflow
    stacks park on the host and stream per epoch.
    """

    def __init__(self, nn_init: str, transform: Optional[Network],
                 reader, labels_repo, cfg: TrainerConfig,
                 frm_ext: int = 0, mesh=None,
                 hbm_budget_bytes: Optional[int] = None):
        self.reader = reader
        self.labels_repo = labels_repo
        self.cfg = cfg
        self.frm_ext = frm_ext
        self.mesh = mesh
        self.hbm_budget = hbm_budget_bytes
        self._resident_bytes = 0
        self._parked_bytes = 0
        self.pipeline = TransformPipeline(transform, frm_ext, frm_ext)
        net0 = Network.read(nn_init)
        self.net_specs = net0.specs
        self.n_proc = jax.process_count()
        if mesh is not None:
            from ..parallel.sharded_trainer import ShardedTrainer

            # multi-host resident (n_proc > 1): each process collects its
            # own SCP shard into LOCAL stacks through the same lockstep
            # drain negotiation the streaming ShardedTrainer uses; stacks
            # are assembled into global sharded arrays once (device-side,
            # no host hop) and every epoch is just the sharded drains
            self.trainer = ShardedTrainer(net0, cfg, mesh, transform,
                                          frm_ext, frm_ext)
            self._feats_sh = self.trainer._feats_sh
            self._labels_sh = self.trainer._labels_sh
        else:
            if self.n_proc > 1:
                raise ValueError(
                    "multi-host resident mode needs a mesh (--mesh)")
            self.trainer = Trainer(net0, cfg, transform, frm_ext, frm_ext)
            self._feats_sh = self._labels_sh = None
        self._train_stacks: List[_Stack] = []
        self._cv_stacks: List[_Stack] = []
        self.train_frames = 0
        self.cv_frames = 0

    # -- placement --------------------------------------------------------
    def _admit(self, stacked) -> _Stack:
        """Keep a stack resident if the HBM budget allows, else park it on
        the host (partial residency: H2D per epoch, no re-intake).

        ``stacked`` is this process's LOCAL (nb, B_loc, ...) pair; budget
        accounting is per-process local bytes. Resident stacks globalize
        immediately (mesh: sharded assembly — multi-host stays device-
        resident via make_array_from_single_device_arrays); parked stacks
        stay as host numpy and globalize per epoch in _place."""
        feats, labels = stacked
        nbytes = feats.nbytes + labels.nbytes
        fits = (self.hbm_budget is None
                or self._resident_bytes + nbytes <= self.hbm_budget)
        if fits:
            if self.mesh is not None:
                feats, labels = self.trainer._globalize(feats, labels)
            self._resident_bytes += nbytes
            return _Stack(feats, labels, on_device=True)
        st = _Stack(np.asarray(feats), np.asarray(labels), on_device=False)
        self._parked_bytes += nbytes
        return st

    def _place(self, st: _Stack):
        """Per-epoch device placement for host-parked stacks."""
        if st.on_device:
            return st.feats, st.labels
        if self.mesh is not None:
            return self.trainer._globalize(st.feats, st.labels)
        return jnp.asarray(st.feats), jnp.asarray(st.labels)

    # -- one-time intake ------------------------------------------------
    def _utt_iter(self, scp_entries, labels_repo):
        for e in scp_entries:
            feats = self.reader.read(e.physical, e.logical)
            n_real = feats.shape[0] - 2 * self.frm_ext
            labs = labels_repo.get_frame_labels(
                n_real, self.reader.last_header.sample_period, e.logical)
            yield (np.asarray(feats, np.float32),
                   np.asarray(labs, np.int32))

    def _collect(self, scp_entries, randomize: bool,
                 batch_utts: int = 32,
                 labels_repo=None) -> Tuple[List[_Stack], int]:
        """Read+transform+shuffle once; return stacked device bunches.

        Reproduces Trainer.run_epoch's intake exactly (same seed, same
        utterance order, same cache boundaries) so the cached bunch
        sequence is identical to what every streaming epoch would see.
        Multi-host (mesh, n_proc > 1): this process's LOCAL shard flows
        through the same lockstep min-bunch drain negotiation as the
        streaming ShardedTrainer, so the stored global stack sequence is
        identical to what streaming epochs would drain.
        """
        labels_repo = labels_repo or self.labels_repo
        utts = self._utt_iter(scp_entries, labels_repo)
        if self.n_proc > 1:
            return self._collect_multihost(utts, randomize, batch_utts)
        cache = DeviceFrameCache(self.cfg.cachesize, self.cfg.bunchsize,
                                 self.cfg.seed, randomize)
        stacks: List[_Stack] = []
        total = 0
        pend_f, pend_l = [], []

        def flush():
            nonlocal total
            if not pend_f:
                return
            rows, valid = self.pipeline.transform_block(pend_f)
            labels_block = np.concatenate(pend_l)
            total += valid
            cache.add_block(rows, valid, labels_block)
            while cache.full:
                stacked = cache.take_stacked()
                if stacked is not None:
                    stacks.append(self._admit(stacked))
            pend_f.clear()
            pend_l.clear()

        for feats, labs in utts:
            pend_f.append(feats)
            pend_l.append(labs)
            if len(pend_f) >= batch_utts:
                flush()
        flush()
        if cache.rows > 0:
            stacked = cache.take_stacked()
            if stacked is not None:
                stacks.append(self._admit(stacked))
        return stacks, total

    def _collect_multihost(self, utts, randomize: bool,
                           batch_utts: int) -> Tuple[List[_Stack], int]:
        """Per-host shard intake with the ShardedTrainer's lockstep
        min-bunch negotiation (sharded_trainer.py run_epoch multi-proc
        loop), storing the agreed stacks instead of draining them."""
        from jax.experimental import multihost_utils

        tr = self.trainer
        cache = DeviceFrameCache(tr.local_cache, tr.local_bunch,
                                 self.cfg.seed, randomize)
        stacks: List[_Stack] = []
        total = 0
        it = iter(utts)
        exhausted = False
        pend_f: List[np.ndarray] = []
        pend_l: List[np.ndarray] = []

        def flush():
            nonlocal total
            if not pend_f:
                return
            rows, valid = self.pipeline.transform_block(pend_f)
            labels_block = np.concatenate(pend_l)
            total += valid
            cache.add_block(rows, valid, labels_block)
            pend_f.clear()
            pend_l.clear()

        while True:
            while not cache.full and not exhausted:
                try:
                    feats, labs = next(it)
                except StopIteration:
                    exhausted = True
                    break
                pend_f.append(feats)
                pend_l.append(labs)
                if len(pend_f) >= batch_utts:
                    flush()
            flush()
            nb_local = min(cache.rows, cache.cachesize) // tr.local_bunch
            offers = np.asarray(multihost_utils.process_allgather(
                np.int32(nb_local)))
            agreed = int(offers.min())
            if agreed == 0:
                break
            stacked = cache.take_stacked(max_bunches=agreed)
            if stacked is not None:
                stacks.append(self._admit(stacked))
        if cache.rows > 0:
            print(f"[resident] host {jax.process_index()}: dropping "
                  f"{cache.rows} unmatched frames (unbalanced SCP shards)",
                  flush=True)
        return stacks, total

    def prepare(self, train_entries, cv_entries,
                cv_labels_repo=None) -> None:
        self._train_stacks, self.train_frames = self._collect(
            train_entries, randomize=self.cfg.randomize)
        self._cv_stacks, self.cv_frames = self._collect(
            cv_entries, randomize=False, labels_repo=cv_labels_repo)
        if self._parked_bytes:
            print(f"[resident] HBM budget {self.hbm_budget}: "
                  f"{self._resident_bytes} bytes resident, "
                  f"{self._parked_bytes} bytes host-parked "
                  f"(streamed H2D per epoch)", flush=True)

    # -- per-epoch closures ----------------------------------------------
    def _load_params(self, mmf: str):
        net = Network.read(mmf)
        return [{k: jnp.asarray(v) for k, v in p.items()}
                for p in net.params]

    def _fresh_stats(self):
        return (XentStats() if self.cfg.objective == "xent" else MseStats())

    def _merge(self, stats, acc):
        if self.cfg.objective == "xent":
            stats.add(float(acc["xent"]), int(acc["frames"]),
                      int(acc["correct"]))
        else:
            stats.add(float(acc["mse"]), int(acc["frames"]))

    def train_epoch(self, src: str, lrate: float, dst: str) -> float:
        import time

        t0 = time.time()
        tr = self.trainer
        if self.cfg.compute_dtype == "int8pfsr":
            # per-epoch SR stream reset: the streaming scheduler runs one
            # tnet process per epoch, so its stochastic-rounding stream
            # restarts every epoch; resident mirrors that for byte-equal
            # trajectories (the same per-epoch-process-state argument as
            # the fresh momentum below)
            tr._sr_key = jax.random.PRNGKey(self.cfg.seed or 1)
        if self.mesh is not None:
            from ..parallel.sharded_step import zero_acc

            net = Network.read(src)
            tr.reload_params(net.params)
            tr.set_learning_rate(lrate)
            stats = self._fresh_stats()
            for st in self._train_stacks:
                feats_all, labels_all = self._place(st)
                acc = zero_acc(self.cfg.objective)
                if tr._sr:
                    # int8pfsr: the SR key rides the replicated acc
                    # (per-cache COPY — accs are donated)
                    acc["_sr_key"] = jnp.array(tr._sr_key, copy=True)
                tr.state.params, tr.state.velocity, acc = \
                    tr._fns["drain_train"](tr.state.params, tr.state.velocity,
                                           acc, feats_all, labels_all, tr._lr)
                if "_sr_key" in acc:
                    tr._sr_key = acc["_sr_key"]
                self._merge(stats, acc)
            # multi-host: params are identical on every process (psum'd
            # grads); process 0 writes the epoch MMF, the fleet syncs
            # before anyone reloads it (shared-filesystem convention,
            # like the reference's SGE staging)
            if self.n_proc > 1:
                from jax.experimental import multihost_utils

                if jax.process_index() == 0:
                    Network(self.net_specs, tr.state.host_params()).write(dst)
                multihost_utils.sync_global_devices("resident_mmf_write")
            else:
                Network(self.net_specs, tr.state.host_params()).write(dst)
        else:
            tr.params = self._load_params(src)
            # fresh momentum per epoch: the reference's optimizer state
            # lives and dies within an epoch process (SURVEY.md §5)
            tr.velocity = init_momentum(Network(self.net_specs, tr.params),
                                        self.cfg.sgd.momentum,
                                        self.cfg.sgd.velocity_dtype)
            tr.set_learning_rate(lrate)
            stats = self._fresh_stats()
            for st in self._train_stacks:
                feats_all, labels_all = self._place(st)
                acc = tr._zero_acc()
                tr.params, tr.velocity, acc = tr._drain_train(
                    tr.params, tr.velocity, acc, feats_all, labels_all,
                    tr._lr)
                if "_sr_key" in acc:
                    # advance the stochastic-rounding stream across
                    # stacks/epochs (trainer._drain_cache analog)
                    tr._sr_key = acc["_sr_key"]
                self._merge(stats, acc)
            host = [{k: np.asarray(v) for k, v in p.items()}
                    for p in tr.params]
            Network(self.net_specs, host).write(dst)
        print(stats.report(), end="")
        fps = self.train_frames / max(time.time() - t0, 1e-9)
        print(f"Done {self.train_frames} frames in {time.time() - t0:.2f}s"
              f" [FPS:{fps:.1f},RT:{fps / 100.0:.4f}] (resident"
              f"{', mesh' if self.mesh is not None else ''})")
        return stats.accuracy

    def crossvalidate(self, mmf: str) -> float:
        import time

        t0 = time.time()
        tr = self.trainer
        stats = self._fresh_stats()
        if self.mesh is not None:
            from ..parallel.sharded_step import zero_acc

            net = Network.read(mmf)
            tr.reload_params(net.params)
            for st in self._cv_stacks:
                feats_all, labels_all = self._place(st)
                acc = zero_acc(self.cfg.objective)
                if tr._sr:
                    acc["_sr_key"] = jnp.array(tr._sr_key, copy=True)
                acc = tr._fns["drain_eval"](tr.state.params, acc,
                                            feats_all, labels_all)
                self._merge(stats, acc)
        else:
            params = self._load_params(mmf)
            for st in self._cv_stacks:
                feats_all, labels_all = self._place(st)
                acc = tr._zero_acc()
                acc = tr._drain_eval(params, acc, feats_all, labels_all)
                self._merge(stats, acc)
        print(stats.report(), end="")
        fps = self.cv_frames / max(time.time() - t0, 1e-9)
        print(f"Done {self.cv_frames} frames in {time.time() - t0:.2f}s"
              f" [FPS:{fps:.1f},RT:{fps / 100.0:.4f}] (resident"
              f"{', mesh' if self.mesh is not None else ''})")
        return stats.accuracy
