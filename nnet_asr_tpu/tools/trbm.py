"""TRbm — RBM CD-1 pretrainer CLI (TRbmCu.cc equivalent, SNAME "TRBM").

The first component of the source MMF must be <rbm> or <rbmsparse>
(TRbmCu.cc:228-232); one pass of CD-1 over the training set updates it and
the whole network is written back. Reports reconstruction MSE.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..io.scp import parse_scp_entry, read_scp
from ..models.components import Rbm
from ..models.network import Network
from ..train.pipeline import TransformPipeline
from ..train.rbm import RbmTrainConfig, RbmTrainer
from ..utils.config import UserInterface

OPTION_STRING = (
    " -D n   PRINTCONFIG=TRUE"
    " -H l   SOURCEMMF"
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -V n   PRINTVERSION=TRUE"
)

SNAME = "TRBM"


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
    p_script = ui.get_str("SCRIPT")
    learning_rate = ui.get_flt("LEARNINGRATE", 0.10)
    momentum = ui.get_flt("MOMENTUM", 0.50)
    weightcost = ui.get_flt("WEIGHTCOST", 0.0002)
    bunchsize = ui.get_int("BUNCHSIZE", 256)
    cachesize = ui.get_int("CACHESIZE", 12800)
    randomize = ui.get_bool("RANDOMIZE", True)
    seed = ui.get_int("SEED", 0)
    # sampling PRNG: rbg = counter generator, threefry = default
    # reproducible stream (train/rbm.py RbmTrainConfig.rng_impl)
    rng_impl = ui.get_enum("RNGIMPL", "threefry", ["threefry", "rbg"])
    trace = ui.get_int("TRACE", 0)
    if ui.get_bool("PRINTCONFIG", False):
        ui.print_config()
    if ui.get_bool("PRINTVERSION", False):
        from .. import __version__
        print(f"\n======= TRBM v{__version__} (nnet_asr_tpu) =======\n")
    ui.check_command_line_param_use()

    if p_source_mmf is None:
        raise SystemExit("Source MMF must be specified [-H]")
    if p_targetmmf is None:
        raise SystemExit("Target MMF must be specified [--TARGETMMF]")

    net = Network.read(p_source_mmf)
    if not net.specs or not isinstance(net.specs[0], Rbm):
        raise SystemExit("First component of the network must be <rbm> or "
                         "<rbmsparse> (TRbmCu.cc:228-232)")
    transform = Network.read(p_transform) if p_transform else None
    pipe = TransformPipeline(transform, feaparams["start_frm_ext"],
                             feaparams["end_frm_ext"])

    entries = read_scp(p_script) if p_script else []
    for extra in argv[args_parsed:]:
        entries.append(parse_scp_entry(extra))

    cfg = RbmTrainConfig(learning_rate=learning_rate, momentum=momentum,
                         weightcost=weightcost, rng_impl=rng_impl)
    trainer = RbmTrainer(net.specs[0], net.params[0], cfg,
                         bunchsize=bunchsize, cachesize=cachesize,
                         seed=seed, randomize=randomize)

    print("===== TRbm TRAINING STARTED =====")
    print(f"learning rate: {learning_rate:g} momentum: {momentum:g} "
          f"weightcost: {weightcost:g}")
    t0 = time.time()

    # shape-stable intake: batches of utterances transform as ONE
    # bucket-padded device block (see train.pipeline.transform_block)
    BATCH = 32
    for lo in range(0, len(entries), BATCH):
        pend = [reader.read(e.physical, e.logical)
                for e in entries[lo:lo + BATCH]]
        rows, valid = pipe.transform_block(pend)
        trainer.ingest_block(rows, valid)
        if trace & 2:
            print("." * len(pend), end="", flush=True)
    trainer.finish_epoch()

    net.params[0] = {k: np.asarray(v) for k, v in trainer.params.items()}
    net.write(p_targetmmf)

    dt = time.time() - t0
    fps = trainer.frames / max(dt, 1e-9)
    print(f"\n===== TRbm FINISHED ( {dt:.1f}s ) "
          f"[FPS:{fps:.1f},RT:{fps / 100.0:.4f}] =====")
    print(trainer.report(), end="")
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
