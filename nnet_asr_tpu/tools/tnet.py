"""TNet — frame-level CE/MSE trainer CLI (TNet.cc / TNetCu.cc equivalent).

Accepts the reference tools' option vocabulary (same short options, long
``--PARAM=VAL`` names, and ``-C`` config files, SNAME "TNET") so the
reference shell drivers (run_test.*.sh, tools/train/training_scheduler.sh)
can drive it unmodified. One device replaces both the multithreaded CPU
Platform and the CUDA path; ``--THREADS`` is accepted and ignored.

Defaults follow TNetCu.cc:192-246 (momentum/L1/lr-factors/GRADDIVFRM
supported; GRADDIVFRM default TRUE — pass =F for TNet-CPU update semantics).
"""

from __future__ import annotations

import sys
import time

from .. import __version__
from ..io.labels import LabelRepository
from ..io.scp import read_scp
from ..models.network import Network
from ..train.sgd import SgdConfig
from ..train.trainer import Trainer, TrainerConfig
from ..utils.config import UserInterface

OPTION_STRING = (
    " -c n   CROSSVALIDATE=TRUE"
    " -B n   SAVEBINARY=TRUE"
    " -m r   OUTPUTLABELMAP"
    " -n r   LEARNINGRATE"
    " -o r   TARGETMODELEXT"
    " -D n   PRINTCONFIG=TRUE"
    " -H l   SOURCEMMF"
    " -I r   SOURCEMLF"
    " -L r   SOURCETRANSCDIR"
    " -M r   TARGETMODELDIR"
    " -O r   OBJECTIVEFUNCTION"
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -V n   PRINTVERSION=TRUE"
    " -X r   SOURCETRANSCEXT"
)

SNAME = "TNET"


def main(argv=None) -> int:
    from .. import enable_compilation_cache
    enable_compilation_cache()
    argv = list(sys.argv if argv is None else argv)
    ui = UserInterface()
    args_parsed = ui.parse_options(argv, OPTION_STRING, SNAME)

    reader, feaparams = ui.make_feature_reader()

    p_source_mmf = ui.get_str("SOURCEMMF")
    p_transform = ui.get_str("FEATURETRANSFORM")
    p_targetmmf = ui.get_str("TARGETMMF")
    p_trg_dir = ui.get_str("TARGETMODELDIR", "")
    p_trg_ext = ui.get_str("TARGETMODELEXT", "")
    p_script = ui.get_str("SCRIPT")
    p_label_map = ui.get_str("OUTPUTLABELMAP")
    learning_rate = ui.get_flt("LEARNINGRATE", 0.06)
    lr_factors = ui.get_str("LEARNRATEFACTORS", None)
    momentum = ui.get_flt("MOMENTUM", 0.0)
    weightcost = ui.get_flt("WEIGHTCOST", 0.0)
    l1 = ui.get_flt("L1", 0.0)
    grad_div_frm = ui.get_bool("GRADDIVFRM", True)
    objective = ui.get_enum("OBJECTIVEFUNCTION", "ent", ["ent", "mse"])
    confusion_mode = ui.get_enum("CONFUSIONMODE", "no",
                                 ["no", "max", "soft", "dmax", "dsoft"])
    p_mlf = ui.get_str("SOURCEMLF")
    p_lbl_dir = ui.get_str("SOURCETRANSCDIR")
    p_lbl_ext = ui.get_str("SOURCETRANSCEXT", "lab")
    bunchsize = ui.get_int("BUNCHSIZE", 256)
    cachesize = ui.get_int("CACHESIZE", 12800)
    randomize = ui.get_bool("RANDOMIZE", True)
    seed = ui.get_int("SEED", 0)
    crossval = ui.get_bool("CROSSVALIDATE", False)
    trace = ui.get_int("TRACE", 0)
    ui.get_int("THREADS", 1)        # accepted for script compat; ignored
    ui.get_int("GPUSELECT", -1)     # ditto
    ui.get_bool("SAVEBINARY", False)  # accepted; models are ASCII MMF (as the
                                      # reference effectively is in this fork)
    ui.get_str("TEMPBASISFOLDER")   # cluster temp-basis staging dir; n/a
    if not ui.get_bool("MLFTRANSC", True):
        print("WARNING: --MLFTRANSC=FALSE (per-file transcriptions) is not "
              "supported; labels come from the -I MLF", file=sys.stderr)

    if ui.get_bool("PRINTCONFIG", False):
        print()
        ui.print_config()
        print()
    if ui.get_bool("PRINTVERSION", False):
        print(f"\n======= TNET v{__version__} (nnet_asr_tpu) =======\n")
    # read every accepted param BEFORE the unused-param check
    mesh_spec = ui.get_str("MESH")   # e.g. --MESH=4x2 → data=4, model=2
    # multi-host fleet membership: initialize jax.distributed from the
    # standard env (JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID
    # or the cluster autodetect) and feed this host only its SCP shard
    distributed = ui.get_bool("DISTRIBUTED", False)
    p_resume = ui.get_str("RESUMESTATE")
    p_save = ui.get_str("SAVESTATE")
    p_jaxprofile = ui.get_str("JAXPROFILE")
    # drain-scan partial unroll (perf knob): lets XLA overlap bunch
    # k+1's input slice with bunch k's compute
    scan_unroll = ui.get_int("SCANUNROLL", 8)
    # velocity STORAGE dtype (perf knob): 'bf16' halves the
    # momentum-mode velocity HBM stream; 'f32' (default) keeps the
    # reference's exact GPU semantics (cuBiasedLinearity.cc:44-63)
    velocity_dtype = ui.get_enum("VELOCITYDTYPE", "f32", ["f32", "bf16"])
    # matmul compute dtype: f32 (parity default), bf16 (explicit bf16
    # master-cast mode), int8 (fake-quant STE convergence-experiment
    # mode — int8 GEMM arithmetic computed in f32)
    compute_dtype = ui.get_enum(
        "COMPUTEDTYPE", "f32",
        ["f32", "bf16", "int8", "int8pf", "int8pfsr", "int8full"])
    ui.check_command_line_param_use()

    if p_script is None:
        print("WARNING: The script file is missing [-S]", file=sys.stderr)
    if p_mlf is None:
        raise SystemExit("Source mlf file is missing [-I]")
    if p_label_map is None:
        raise SystemExit("Output label map is missing [-m]")
    if p_source_mmf is None:
        raise SystemExit("Source MMF must be specified [-H]")

    entries = read_scp(p_script) if p_script else []
    for extra in argv[args_parsed:]:
        from ..io.scp import parse_scp_entry
        entries.append(parse_scp_entry(extra))

    if distributed:
        import jax
        jax.distributed.initialize()
    import jax as _jax
    if _jax.process_count() > 1:
        # per-host input sharding (SURVEY.md §2.9 "per-host data loading"):
        # each process reads only its stride of the SCP; ShardedTrainer
        # assembles global bunches from the per-host slices and keeps the
        # fleet in lockstep via drain negotiation
        pid, np_ = _jax.process_index(), _jax.process_count()
        entries = entries[pid::np_]
        print(f"[distributed] process {pid}/{np_}: "
              f"{len(entries)} SCP entries in local shard", flush=True)

    labels_repo = LabelRepository(p_mlf, p_label_map, p_lbl_dir, p_lbl_ext)
    transform = Network.read(p_transform) if p_transform else None
    net = Network.read(p_source_mmf)

    cfg = TrainerConfig(
        bunchsize=bunchsize, cachesize=cachesize, seed=seed,
        randomize=randomize and not crossval, crossvalidate=crossval,
        objective="xent" if objective == "ent" else "mse",
        sgd=SgdConfig(learning_rate=learning_rate, momentum=momentum,
                      weightcost=weightcost, l1=l1, grad_div_frm=grad_div_frm,
                      lr_factors=SgdConfig.parse_factors(lr_factors),
                      velocity_dtype=(None if velocity_dtype == "f32"
                                      else velocity_dtype)),
        trace=trace, confusion_mode=confusion_mode, scan_unroll=scan_unroll,
        compute_dtype=None if compute_dtype == "f32" else compute_dtype)
    if mesh_spec or _jax.process_count() > 1:
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded_trainer import ShardedTrainer

        if mesh_spec:
            d, _, m = mesh_spec.lower().partition("x")
            mesh = make_mesh(data=int(d), model=int(m) if m else 1)
        else:
            mesh = make_mesh()      # multi-host default: all-data mesh
        trainer = ShardedTrainer(net, cfg, mesh, transform,
                                 feaparams["start_frm_ext"],
                                 feaparams["end_frm_ext"])
    else:
        trainer = Trainer(net, cfg, transform,
                          feaparams["start_frm_ext"], feaparams["end_frm_ext"])
    if cfg.objective == "xent":
        trainer.stats.confusion_mode = confusion_mode
        trainer.stats.label_map_file = p_label_map

    print(f"===== TNET {'CROSSVALIDATION' if crossval else 'TRAINING'} STARTED =====")
    print(f"Objective function: {'Xent' if cfg.objective == 'xent' else 'Mse'}")
    if not crossval:
        print(f"Learning rate: {learning_rate:g}")
    sys.stdout.flush()

    t0 = time.time()

    import copy
    import threading

    from ..utils.prefetch import prefetch_map

    # FeatureReader keeps per-read state (last_header, norm caches) → one
    # instance per reader thread
    tls = threading.local()

    def read_one(e):
        rd = getattr(tls, "reader", None)
        if rd is None:
            rd = tls.reader = copy.copy(reader)
        feats = rd.read(e.physical, e.logical)
        n_real = feats.shape[0] - feaparams["start_frm_ext"] - feaparams["end_frm_ext"]
        labs = labels_repo.get_frame_labels(
            n_real, rd.last_header.sample_period, e.logical)
        return feats, labs

    def utterance_iter():
        # background reader pool (the Platform reader-thread analog)
        for feats, labs in prefetch_map(read_one, entries, workers=4):
            if trace & 2:
                print(".", end="", flush=True)
            yield feats, labs

    from ..utils.profiler import enable_from_trace, profiler

    enable_from_trace(trace)
    if p_resume and hasattr(trainer, "load_state"):
        trainer.load_state(p_resume)
    if p_jaxprofile:
        import jax
        jax.profiler.start_trace(p_jaxprofile)
    trainer.run_epoch(utterance_iter())
    if p_jaxprofile:
        import jax
        jax.profiler.stop_trace()
    if p_save and hasattr(trainer, "save_state"):
        trainer.save_state(p_save)

    if not crossval and _jax.process_index() == 0:
        # multi-host: params are replicated post-update; process 0 writes
        out_net = trainer.updated_network()
        if p_targetmmf:
            out_net.write(p_targetmmf)
        elif p_trg_dir or p_trg_ext:
            from ..io.htk import make_htk_filename
            out_net.write(make_htk_filename(p_source_mmf, p_trg_dir, p_trg_ext))
        else:
            print("WARNING: no target model specified, not saving",
                  file=sys.stderr)

    print()
    print(f"===== TNET FINISHED ( {time.time() - t0:.1f}s ) =====")
    print(trainer.report(), end="")
    print(trainer.throughput_report(), end="")
    if profiler.enabled:
        print(profiler.report(), end="")
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
