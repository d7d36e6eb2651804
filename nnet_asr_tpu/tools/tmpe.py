"""TMpe — MPE/sMBR lattice sequence-training CLI (TMpeCu.cc equivalent,
SNAME "TMPECU").

Per utterance (TMpeCu.cc:461-672): forward transform+net on device → log
posteriors to host → lattice forward-backward with MPE accuracy statistics
(train/mpe.py) → ``err = -OUTPSCALE * gamma_mpe`` back to the device →
backprop + SGD update through the softmax-identity path. ``--MLGAMMA``
switches to plain ML occupancy accumulation. Lattices come from
``--LATTICEDIR/--LATTICEEXT`` as SLF files (the STK-network-from-MLF
transport of the reference is replaced by the standard lattice archive
layout); the reference phone segmentation for accuracy comes from the
``-I`` state-label MLF.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from ..io.htk_hmm import parse_mmf
from ..io.labels import LabelRepository
from ..io.scp import parse_scp_entry, read_scp
from ..io.slf import LatticeArchive
from ..models.components import Softmax
from ..models.network import Network
from ..train.mpe import MpeComputer, MpeConfig, labels_to_phone_segments
from ..train.pipeline import TransformPipeline
from ..train.sgd import SgdConfig, apply_updates, init_momentum, layer_lr_factors
from ..utils.config import UserInterface

def _fb_worker_init(hmm_path, label_map, cfg, engine):
    """Per-process MpeComputer for the -c FB pool (module-level so it
    pickles; each worker parses the HMM set once)."""
    global _FB_MPE
    from ..io.htk_hmm import parse_mmf
    from ..train.mpe import MpeComputer

    _FB_MPE = MpeComputer(parse_mmf(hmm_path), label_map, cfg,
                          engine=engine)


def _fb_one(lat, log_post, segs, weight, outprb_scale, thresh, prn_step,
            prn_limit):
    """One utterance's FB with the widen-and-retry loop; returns
    avg_acc or None (skip)."""
    mpe = _FB_MPE
    mpe.cfg.outprb_scale = outprb_scale
    while True:
        try:
            _, avg_acc, _ = mpe.compute(lat, log_post, segs,
                                        utt_weight=weight, pruning=thresh)
            return avg_acc
        except FloatingPointError:
            if thresh <= 0.0:
                raise
            if prn_step <= 0.0 or thresh + prn_step > prn_limit:
                return None
            thresh += prn_step


OPTION_STRING = (
    " -c n   CROSSVALIDATE=TRUE"
    " -m r   OUTPUTLABELMAP"
    " -n r   LEARNINGRATE"
    " -D n   PRINTCONFIG=TRUE"
    " -H l   SOURCEMMF"
    " -I r   SOURCEMLF"
    " -L r   SOURCETRANSCDIR"
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -t ror PRUNING PRUNINGINC PRUNINGMAX"
    " -V n   PRINTVERSION=TRUE"
    " -X r   SOURCETRANSCEXT"
)

SNAME = "TMPECU"


def main(argv=None) -> int:
    from .. import enable_compilation_cache
    enable_compilation_cache()
    argv = list(sys.argv if argv is None else argv)
    ui = UserInterface()
    args_parsed = ui.parse_options(argv, OPTION_STRING, SNAME)

    reader, feaparams = ui.make_feature_reader()
    p_hmm = ui.get_str("HMM")
    p_mlf = ui.get_str("SOURCEMLF")
    p_label_map = ui.get_str("OUTPUTLABELMAP")
    p_lbl_dir = ui.get_str("SOURCETRANSCDIR")
    p_lbl_ext = ui.get_str("SOURCETRANSCEXT", "lab")
    p_lat_dir = ui.get_str("LATTICEDIR")
    p_lat_ext = ui.get_str("LATTICEEXT", "lat")
    p_net_filter = ui.get_str("HNETFILTER")   # TMpeCu.cc:288-290
    p_source_mmf = ui.get_str("SOURCEMMF")
    p_transform = ui.get_str("FEATURETRANSFORM")
    p_targetmmf = ui.get_str("TARGETMMF")
    p_script = ui.get_str("SCRIPT")
    outprb_scale = ui.get_flt("OUTPSCALE", 1.0)
    lm_scale = ui.get_flt("LMSCALE", 1.0)
    learning_rate = ui.get_flt("LEARNINGRATE", 0.06)
    lr_factors = ui.get_str("LEARNRATEFACTORS", None)
    weightcost = ui.get_flt("WEIGHTCOST", 0.0)
    grad_div_frm = ui.get_bool("GRADDIVFRM", True)
    ml_gamma = ui.get_bool("MLGAMMA", False)
    state_pruning = ui.get_flt("PRUNING", 0.0)
    stprn_step = ui.get_flt("PRUNINGINC", 0.0)
    stprn_limit = ui.get_flt("PRUNINGMAX", 0.0)
    nframeoutpnorm = ui.get_bool("NFRAMEOUTPNORM", False)
    # word-lattice expansion (TMpeCu.cc:254-282, 535-544): a dictionary
    # turns word arcs into aligned phone chains (train/lattice_expand.py)
    p_dict = ui.get_str("SOURCEDICT")
    pron_scale = ui.get_flt("PRONUNSCALE", 1.0)
    word_penalty = ui.get_flt("WORDPENALTY", 0.0)
    respect_pronvars = ui.get_bool("RESPECTPRONVARS", False)
    # integrate over ALL intra-word segmentations (STK-exact) instead of
    # MAP Viterbi boundaries; EXACTSEGWINDOW=W bounds boundary times to
    # ±W frames of the MAP boundary (0 = fully exact)
    exact_seg = ui.get_bool("EXACTSEGMENTATION", False)
    exact_window = ui.get_int("EXACTSEGWINDOW", 0) or None
    # decoder scale/penalty knobs (TMpeCu.cc:256-267)
    transp_scale = ui.get_flt("TRANSPSCALE", 1.0)
    model_penalty = ui.get_flt("MODELPENALTY", 0.0)
    occup_scale = ui.get_flt("OCCUPPSCALE", 1.0)
    start_time_shift = ui.get_flt("STARTTIMESHIFT", 0.0)
    end_time_shift = ui.get_flt("ENDTIMESHIFT", 0.0)
    # STK recognition-network construction/beam knobs with no analog in
    # the factorized SLF engine: accepted for script compatibility, must
    # stay at the reference defaults (TMpeCu.cc:262-283). Our lattices
    # are always timed (DEVIATIONS.md §3), so TIMEPRUNING's
    # "ignore lattice times" default is structurally n/a.
    ui.get_bool("TIMEPRUNING", False)
    for flag, default in (("ALLOWXWRDEXP", False), ("EXACTTIMEMERGE", False),
                          ("REMEXPWRDNODES", False), ("MINIMIZENET", False),
                          ("WEIGHTPUSHING", True)):
        if ui.get_bool(flag, default) != default:
            print(f"WARNING: --{flag} has no effect: the factorized SLF "
                  f"engine builds no STK recognition network "
                  f"(docs/DEVIATIONS.md §2/§3)", file=sys.stderr)
    for flag in ("MAXACTIVEMODELS", "MINACTIVEMODELS"):
        if ui.get_int(flag, 0) != 0:
            print(f"WARNING: --{flag} has no effect: the exact lattice FB "
                  f"has no token beam; use --PRUNING* for the lattice "
                  f"beam", file=sys.stderr)
    if ui.get_flt("POSTERIORSCALE", 1.0) != 1.0:
        print("WARNING: --POSTERIORSCALE has no effect: SLF lattices carry "
              "no posterior field (STK-net 'P=' links only)",
              file=sys.stderr)
    # MMI mode: err = -kappa*(onehot(numerator alignment) - gamma_den^ML).
    # Restores the capability of TMmiCu, which the reference build lists
    # but whose source is absent from the fork (src/Makefile:46).
    mmi = ui.get_bool("MMI", False)
    show_gamma = ui.get_bool("SHOWGAMMA", False)
    # beyond-parity: evaluate the MPE criterion without updating (the
    # reference TMpeCu trains only; tnet's -c analog). With no update
    # dependency the NN forwards pipeline ``LOOKAHEAD`` utterances deep —
    # the device computes utterance i+1..i+k's posteriors while the host
    # runs utterance i's lattice forward-backward.
    crossval = ui.get_bool("CROSSVALIDATE", False)
    lookahead = ui.get_int("LOOKAHEAD", 8)
    # opt-in one-utterance-stale gradients: dispatch
    # utterance u+1's device forward BEFORE u's update lands, so the
    # forward overlaps u's host lattice FB + update dispatch. Deviates
    # from the reference's strict sequential SGD (TMpeCu.cc:461-672) by
    # exactly one update of staleness; parity default OFF.
    delayed_update = ui.get_bool("DELAYEDUPDATE", False)
    # -c only: lattice FB on a PROCESS pool (the recursions are
    # Python/numpy, so threads gain nothing); valid because evaluation
    # has no update dependency between utterances. 1 = serial (default,
    # byte-identical ordering).
    fb_workers = ui.get_int("FBWORKERS", 1)
    # --MESH=DxM: NN forward + error backprop frame-sharded over the data
    # axis of a device mesh (parallel/sharded_aux.py); the host lattice
    # engine is unchanged. tnet --MESH's analog for sequence training.
    mesh_spec = ui.get_str("MESH")
    # within-arc forward-backward engine: 'jax' batches the recursions on
    # the accelerator next to the NN forward pass (ops/mpe_device.py,
    # parity-tested vs the numpy engine); 'auto' picks jax whenever a
    # non-CPU backend is active
    mpe_engine = ui.get_enum("MPEENGINE", "auto",
                             ["auto", "jax", "numpy", "native"])
    trace = ui.get_int("TRACE", 0)
    if ui.get_bool("PRINTCONFIG", False):
        ui.print_config()
    if ui.get_bool("PRINTVERSION", False):
        from .. import __version__
        print(f"\n======= TMPECU v{__version__} (nnet_asr_tpu) =======\n")
    ui.check_command_line_param_use()

    for req, msg in ((p_source_mmf, "Source MMF must be specified [-H]"),
                     (p_hmm, "HMM MMF must be specified [--HMM]"),
                     (p_mlf, "Source MLF missing [-I]"),
                     (p_label_map, "Output label map missing [-m]"),
                     (p_lat_dir, "Lattice dir missing [--LATTICEDIR]")):
        if req is None:
            raise SystemExit(msg)

    net = Network.read(p_source_mmf)
    if not isinstance(net.specs[-1], Softmax):
        raise SystemExit("MPE training expects a terminal <softmax>")
    transform = Network.read(p_transform) if p_transform else None
    pipe = TransformPipeline(transform, feaparams["start_frm_ext"],
                             feaparams["end_frm_ext"])
    labels_repo = LabelRepository(p_mlf, p_label_map, p_lbl_dir, p_lbl_ext)
    label_names = [None] * labels_repo.n_outputs
    for tag, idx in labels_repo.label_map.items():
        label_names[idx] = tag

    hmms = parse_mmf(p_hmm)
    # 'auto' on an accelerator MEASURES instead of assuming which engine
    # is faster; a one-utterance probe below decides
    probe_pending = False
    if mpe_engine == "auto":
        # host-side C++ engine when g++ built it, numpy otherwise; on an
        # accelerator a one-utterance probe below still measures the
        # device engine against it
        from ..train import mpe_native
        mpe_engine = "native" if mpe_native.available() else "numpy"
        probe_pending = jax.default_backend() != "cpu"
    dictionary = None
    if p_dict:
        from ..io.dictionary import read_dictionary
        dictionary = read_dictionary(p_dict)
    mpe = MpeComputer(hmms, labels_repo.label_map,
                      MpeConfig(lm_scale=lm_scale, outprb_scale=outprb_scale,
                                ml_gamma=ml_gamma or mmi,
                                pron_scale=pron_scale,
                                word_penalty=word_penalty,
                                respect_pronun_var=respect_pronvars,
                                exact_segmentation=exact_seg,
                                exact_window=exact_window,
                                transp_scale=transp_scale,
                                model_penalty=model_penalty,
                                occup_scale=occup_scale,
                                start_time_shift=start_time_shift,
                                end_time_shift=end_time_shift),
                      engine=mpe_engine, dictionary=dictionary)
    lattices = LatticeArchive(p_lat_dir, p_lat_ext, filter_cmd=p_net_filter)

    entries = read_scp(p_script) if p_script else []
    for extra in argv[args_parsed:]:
        entries.append(parse_scp_entry(extra))

    sgd_cfg = SgdConfig(learning_rate=learning_rate, weightcost=weightcost,
                        grad_div_frm=grad_div_frm,
                        lr_factors=SgdConfig.parse_factors(lr_factors))
    factors = tuple(layer_lr_factors(net, sgd_cfg))
    params = [{k: jnp.asarray(v) for k, v in p.items()} for p in net.params]
    velocity = init_momentum(net, sgd_cfg.momentum, sgd_cfg.velocity_dtype)
    body_specs = net.specs[:-1]

    if mesh_spec:
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded_aux import make_sharded_mpe_step

        d, _, m = mesh_spec.lower().partition("x")
        mesh = make_mesh(data=int(d), model=int(m) if m else 1)
        # bucket-padded feats are multiples of 4096 (train/pipeline.py),
        # always divisible by the data axis
        forward_j, update_j = make_sharded_mpe_step(net, sgd_cfg, mesh)
    else:
        def forward(params, x):
            for spec, p in zip(body_specs, params):
                x = spec.apply(p, x)
            return x        # logits (pre-softmax)

        def forward_logpost(params, x):
            return jax.nn.log_softmax(forward(params, x), axis=-1)

        forward_j = jax.jit(forward_logpost)

        def update(params, velocity, feats, err, n_frames):
            # backprop the externally-computed error through the logits
            # (softmax backward = identity, as the reference does); rows
            # beyond the utterance are zero in ``err`` so T can ride
            # bucket-padded (n_frames carries the true count for
            # GRADDIVFRM)
            def surrogate(params):
                logits = forward(params, feats)
                return jnp.sum(logits * err)
            grads = jax.grad(surrogate)(params)
            return apply_updates(net, params, velocity, grads, sgd_cfg,
                                 n_frames, factors)

        update_j = jax.jit(update, donate_argnums=(0, 1))

    print(f"===== TMpe {'CROSSVALIDATION' if crossval else 'TRAINING'} "
          f"STARTED =====")
    t0 = time.time()
    frames = 0
    acc_sum = 0.0
    n_utts = 0
    t_read = 0.0      # prefetch wait (I/O not hidden by the pipeline)
    t_fwd = 0.0       # device forward dispatch + posterior fetch
    t_decode = 0.0    # host lattice forward-backward
    t_update = 0.0    # device update dispatch

    # ---- prefetch pipeline -------------------------------------------
    # Everything weight-INDEPENDENT per utterance — feature read, frame
    # labels, reference segmentation, lattice read+parse — runs on a
    # reader pool ahead of the training loop (the Platform reader-thread
    # analog, Platform.h:201-245; lattice parsing dominates host time at
    # corpus scale). The weight-dependent work (NN forward, lattice FB on
    # the current posteriors, update) stays in order on the main thread.
    # FeatureReader keeps per-read state -> one copy per worker thread;
    # MlfReader's seek+read is lock-atomic, so LatticeArchive.get is safe.
    import copy as _copy
    import threading

    from ..utils.prefetch import prefetch_map

    tls = threading.local()
    s_ext = feaparams["start_frm_ext"]
    e_ext = feaparams["end_frm_ext"]

    def read_one(e):
        rd = getattr(tls, "reader", None)
        if rd is None:
            rd = tls.reader = _copy.copy(reader)
        feats_ext = rd.read(e.physical, e.logical)
        T = feats_ext.shape[0] - s_ext - e_ext
        labs = labels_repo.get_frame_labels(
            T, rd.last_header.sample_period, e.logical)
        segs = labels_to_phone_segments(labs, label_names)
        lat = lattices.get(e.logical)
        # native engine: arc/phone flattening is weight-independent —
        # do it here on the reader pool, hidden behind the pipeline
        mpe.preflatten(lat)
        return e, feats_ext, T, labs, segs, lat

    def lattice_fb(e, T, labs, segs, lat, log_post):
        """Per-utterance FB with the reference's widen-and-retry pruning
        loop (TMpeCu.cc:570-609); NFRAMEOUTPNORM divides the decoder-
        internal kappa and all thresholds by n_frames (the error scale
        below keeps the original kappa, TMpeCu.cc:630). Returns
        (gammas|None, avg_acc, thresh_used)."""
        nonlocal mpe, probe_pending
        thresh, prn_step, prn_limit = state_pruning, stprn_step, stprn_limit
        mpe.cfg.outprb_scale = outprb_scale
        if nframeoutpnorm:
            mpe.cfg.outprb_scale = outprb_scale / T
            thresh /= T
            prn_step /= T
            prn_limit /= T
        gammas, avg_acc = None, 0.0
        while True:
            try:
                gammas, avg_acc, _ = mpe.compute(
                    lat, log_post, segs, utt_weight=e.weight,
                    pruning=thresh)
                break
            except FloatingPointError:
                if thresh <= 0.0:
                    raise           # no pruning active: genuinely bad data
                if prn_step <= 0.0 or thresh + prn_step > prn_limit:
                    # the reference raises Error here despite the wording
                    # (TMpeCu.cc:600); with no beam left to widen we skip
                    # the utterance instead of aborting the whole run
                    print(f"WARNING: Overpruning or bad data, skipping "
                          f"file {e.logical}", file=sys.stderr)
                    break
                thresh += prn_step
                print(f"WARNING: Overpruning or bad data in file "
                      f"{e.logical}, trying pruning threshold: {thresh:g}",
                      file=sys.stderr)
        if gammas is not None and probe_pending:
            # one-utterance engine probe: re-run this utterance's FB on
            # both engines and keep the faster one for the rest of the run
            probe_pending = False
            tn = time.time()
            mpe.compute(lat, log_post, segs, utt_weight=e.weight,
                        pruning=thresh)
            tn = time.time() - tn
            jax_mpe = MpeComputer(hmms, labels_repo.label_map, mpe.cfg,
                                  engine="jax", dictionary=dictionary)
            try:
                jax_mpe.compute(lat, log_post, segs,
                                utt_weight=e.weight, pruning=thresh)  # compile
                tj = time.time()
                jax_mpe.compute(lat, log_post, segs,
                                utt_weight=e.weight, pruning=thresh)
                tj = time.time() - tj
            except Exception:
                # the host engine carries on, but a broken device path
                # is reported, not hidden (--MPEENGINE=jax raises it)
                import traceback
                print("WARNING: [MPEENGINE auto] the device engine failed; "
                      "using the host engine:", file=sys.stderr)
                traceback.print_exc(file=sys.stderr)
                tj = float("inf")
            host_name = "native" if mpe._native is not None else "numpy"
            if tj < tn:
                mpe = jax_mpe
            print(f"[MPEENGINE auto] {host_name} {tn * 1e3:.1f}ms vs "
                  f"device {tj * 1e3:.1f}ms per utterance -> "
                  f"{'jax' if tj < tn else host_name}", flush=True)
        if show_gamma and gammas is not None:
            print(f"{e.logical}: avgAcc {avg_acc:.4f}")
        return gammas, avg_acc

    def consume(e, T, labs, segs, lat, log_post, feats):
        """FB + (in training mode) error backprop + update dispatch."""
        nonlocal frames, acc_sum, n_utts, t_decode, t_update
        nonlocal params, velocity
        td = time.time()
        gammas, avg_acc = lattice_fb(e, T, labs, segs, lat, log_post)
        t_decode += time.time() - td
        if gammas is None:
            return
        if not crossval:
            if mmi:
                # numerator = forced alignment one-hot; denominator = ML
                # occupancies of the lattice
                num = np.zeros_like(gammas)
                num[np.arange(T), labs] = 1.0
                gammas = num - gammas
            err_pad = np.zeros((feats.shape[0], gammas.shape[1]), np.float32)
            err_pad[:T] = -outprb_scale * gammas
            tu = time.time()
            params, velocity = update_j(params, velocity, feats,
                                        jnp.asarray(err_pad), jnp.float32(T))
            t_update += time.time() - tu
        frames += T
        acc_sum += avg_acc
        n_utts += 1
        if trace & 2:
            print(".", end="", flush=True)

    if delayed_update and crossval:
        print("WARNING: --DELAYEDUPDATE has no effect with -c "
              "(evaluation already pipelines LOOKAHEAD deep)",
              file=sys.stderr)
    if fb_workers > 1 and (not crossval or dictionary is not None
                           or show_gamma):
        print("WARNING: --FBWORKERS>1 applies to -c on plain phone "
              "lattices without --SHOWGAMMA (training is per-utterance "
              "sequential); running serial FB", file=sys.stderr)
        fb_workers = 1

    reads = prefetch_map(read_one, entries, workers=4,
                         depth=max(2 * lookahead, 16))
    if crossval:
        # fixed params: dispatch up to ``lookahead`` forwards before the
        # first fetch — host FB overlaps the device's queued forwards.
        # With --FBWORKERS>1 the FB itself fans out over a process pool
        # (evaluation has no update dependency between utterances; the
        # recursions are Python/numpy so threads gain nothing).
        from collections import deque
        pend = deque()
        pool = None
        fb_futures = []
        if fb_workers > 1:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            # spawn, not fork: the parent runs JAX + prefetch threads,
            # and fork with live threads deadlocks (JAX warns exactly
            # this); workers are numpy-only and re-import cleanly.
            # JAX_PLATFORMS=cpu keeps the children off the card (the
            # parent's backend is already initialized)
            import os as _os
            _os.environ["JAX_PLATFORMS"] = "cpu"
            pool = ProcessPoolExecutor(
                max_workers=fb_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_fb_worker_init,
                initargs=(p_hmm, labels_repo.label_map, mpe.cfg,
                          "native" if mpe._native is not None
                          else "numpy"))

        def drain_one():
            nonlocal t_fwd, frames
            e, T, labs, segs, lat, feats, dev = pend.popleft()
            tf = time.time()
            log_post = np.asarray(dev)[:T]
            t_fwd += time.time() - tf
            if pool is None:
                consume(e, T, labs, segs, lat, log_post, feats)
                return
            scale = outprb_scale
            th, st, lim = state_pruning, stprn_step, stprn_limit
            if nframeoutpnorm:
                scale = outprb_scale / T
                th, st, lim = th / T, st / T, lim / T
            # frames counted at result collection, not submit: a worker
            # may return None (overpruning skip) and the serial path only
            # counts successful utterances
            fb_futures.append((e.logical, T, pool.submit(
                _fb_one, lat, log_post, segs, e.weight, scale,
                th, st, lim)))

        for item in reads:
            tr = time.time()
            e, feats_ext, T, labs, segs, lat = item
            t_read += time.time() - tr
            # bucket-padded transform + forward: one compiled program per
            # shape bucket instead of per distinct utterance length
            feats, _ = pipe.transform_block([feats_ext])
            pend.append((e, T, labs, segs, lat, feats,
                         forward_j(params, feats)))
            if len(pend) > lookahead:
                drain_one()
        while pend:
            drain_one()
        if pool is not None:
            td = time.time()
            for name, T, fut in fb_futures:
                avg_acc = fut.result()
                if avg_acc is None:
                    print(f"WARNING: Overpruning or bad data, skipping "
                          f"file {name}", file=sys.stderr)
                    continue
                frames += T
                acc_sum += avg_acc
                n_utts += 1
                if trace & 2:
                    print(".", end="", flush=True)
            pool.shutdown()
            t_decode += time.time() - td
    elif delayed_update:
        # --DELAYEDUPDATE: one-deep software pipeline. Iteration n
        # dispatches utterance u_{n}'s forward (against params that are
        # one update stale) and only then drains u_{n-1}: fetch its
        # posteriors (device finished them while we read/dispatched),
        # host FB, update. The device forward of u_{n} runs concurrently
        # with that host work.
        it = iter(reads)
        pend = None
        while True:
            tr = time.time()
            try:
                nxt = next(it)
            except StopIteration:
                nxt = None
            t_read += time.time() - tr
            if nxt is not None:
                e, feats_ext, T, labs, segs, lat = nxt
                tf = time.time()
                feats, _ = pipe.transform_block([feats_ext])
                dev = forward_j(params, feats)       # async, stale-by-one
                t_fwd += time.time() - tf
                cur = (e, T, labs, segs, lat, feats, dev)
            else:
                cur = None
            if pend is not None:
                e0, T0, labs0, segs0, lat0, feats0, dev0 = pend
                tf = time.time()
                log_post = np.asarray(dev0)[:T0]
                t_fwd += time.time() - tf
                consume(e0, T0, labs0, segs0, lat0, log_post, feats0)
            pend = cur
            if cur is None:
                break
    else:
        # sequential SGD semantics (TMpeCu.cc:461-672): utterance i+1's
        # forward must see utterance i's update, so forwards can't run
        # ahead — the pipeline hides the I/O instead
        it = iter(reads)
        while True:
            tr = time.time()
            try:
                e, feats_ext, T, labs, segs, lat = next(it)
            except StopIteration:
                break
            t_read += time.time() - tr
            tf = time.time()
            feats, _ = pipe.transform_block([feats_ext])
            log_post = np.asarray(forward_j(params, feats))[:T]
            t_fwd += time.time() - tf
            consume(e, T, labs, segs, lat, log_post, feats)

    if p_targetmmf and not crossval:
        host = [{k: np.asarray(v) for k, v in p.items()} for p in params]
        Network(net.specs, host).write(p_targetmmf)

    dt = time.time() - t0
    fps = frames / max(dt, 1e-9)
    print(f"\n===== TMpe FINISHED ( {dt:.1f}s ) "
          f"[FPS:{fps:.1f},RT:{fps / 100.0:.4f}] =====")
    print(f"Avg MPE accuracy: {acc_sum / max(n_utts, 1):.6g} "
          f"utts: {n_utts} T-decode: {t_decode:.2f}s")
    print(f"T-read: {t_read:.2f}s T-fwd: {t_fwd:.2f}s "
          f"T-decode: {t_decode:.2f}s T-update: {t_update:.2f}s")
    return 0


def _cli():
    """Reference-style top-level error handling (TNet.cc:371-376)."""
    import sys
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception as e:
        print("Exception thrown", file=sys.stderr)
        print(e, file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    _cli()
