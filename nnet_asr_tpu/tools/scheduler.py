"""Training scheduler CLI — native newbob driver (training_scheduler.sh).

Runs the full newbob loop (initial CV, per-epoch train+CV, accept/reject,
LR halving) in-process against our tnet tool, reading the same environment
variables the reference shell script documents (NN_INIT, MLF_TRAIN,
MLF_CV, SCP_TRAIN_LOCAL, SCP_CV_LOCAL, PHONELIST, LEARNRATE,
FEATURE_TRANSFORM, FRM_EXT, BUNCHSIZE, CACHESIZE, MAX_ITER, ...) or the
equivalent --flags. The reference shell script itself also works: point
its $TNet at ``python -m nnet_asr_tpu.tools.tnet`` (same ``Xent:`` line).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import sys

from ..train.newbob import NewbobConfig, run_newbob


def _env(name, default=None):
    return os.environ.get(name, default)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scheduler")
    ap.add_argument("--nn-init", default=_env("NN_INIT"))
    ap.add_argument("--mlf-train", default=_env("MLF_TRAIN"))
    ap.add_argument("--mlf-cv", default=_env("MLF_CV"))
    ap.add_argument("--scp-train", default=_env("SCP_TRAIN_LOCAL"))
    ap.add_argument("--scp-cv", default=_env("SCP_CV_LOCAL"))
    ap.add_argument("--phonelist", default=_env("PHONELIST"))
    ap.add_argument("--learnrate", type=float,
                    default=float(_env("LEARNRATE", "0.06")))
    ap.add_argument("--feature-transform", default=_env("FEATURE_TRANSFORM"))
    ap.add_argument("--frm-ext", type=int, default=int(_env("FRM_EXT", "0")))
    ap.add_argument("--bunchsize", type=int,
                    default=int(_env("BUNCHSIZE", "512")))
    ap.add_argument("--cachesize", type=int,
                    default=int(_env("CACHESIZE", "16384")))
    ap.add_argument("--max-iter", type=int, default=int(_env("MAX_ITER", "20")))
    ap.add_argument("--min-iter", type=int, default=int(_env("MIN_ITER", "1")))
    ap.add_argument("--keep-lrate-iter", type=int,
                    default=int(_env("KEEP_LRATE_ITER", "0")))
    ap.add_argument("--start-halving-inc", type=float,
                    default=float(_env("START_HALVING_INC", "0.5")))
    ap.add_argument("--end-halving-inc", type=float,
                    default=float(_env("END_HALVING_INC", "0.1")))
    ap.add_argument("--halving-factor", type=float,
                    default=float(_env("HALVING_FACTOR", "0.5")))
    ap.add_argument("--momentum", type=float,
                    default=float(_env("MOMENTUM", "0")))
    ap.add_argument("--weightcost", type=float,
                    default=float(_env("WEIGHTCOST", "0")))
    ap.add_argument("--weights-dir", default="weights")
    ap.add_argument("--seed", type=int, default=123)
    # persistent-worker fast path: features transform+shuffle ONCE into
    # HBM-resident bunch stacks; each epoch is just the drain scans
    # (train/resident.py). Identical bunch sequence (fixed per-epoch
    # seed) => same trajectory as the streaming mode; needs the corpus
    # to fit in device memory.
    ap.add_argument("--resident", action="store_true",
                    default=bool(_env("RESIDENT")))
    # device mesh 'DxM' (e.g. 4x2): streaming mode forwards --MESH to tnet;
    # resident mode shards the HBM-cached stacks over the data axis and
    # runs the sharded drains — the two fast modes compose
    ap.add_argument("--mesh", default=_env("MESH"))
    # resident HBM budget in MiB: stacks beyond it park on the host and
    # stream H2D once per epoch (partial residency, train/resident.py)
    ap.add_argument("--hbm-budget-mb", type=float,
                    default=float(_env("HBM_BUDGET_MB", "0")) or None)
    # matmul compute dtype (tnet --COMPUTEDTYPE): f32 (parity default) |
    # bf16 | int8 (fake-quant STE convergence mode)
    ap.add_argument("--compute-dtype", default=_env("COMPUTE_DTYPE"),
                    choices=[None, "f32", "bf16", "int8", "int8pf",
                             "int8pfsr", "int8full"])
    args = ap.parse_args(argv)

    for req in ("nn_init", "mlf_train", "mlf_cv", "scp_train", "scp_cv",
                "phonelist"):
        if getattr(args, req) is None:
            raise SystemExit(f"--{req.replace('_', '-')} (or its env var) "
                             "is required")

    from . import tnet

    common = [
        "-m", args.phonelist,
        "--BUNCHSIZE=" + str(args.bunchsize),
        "--CACHESIZE=" + str(args.cachesize),
        "--STARTFRMEXT=" + str(args.frm_ext),
        "--ENDFRMEXT=" + str(args.frm_ext),
        "-L", "*/", "-X", "lab",
    ]
    if args.feature_transform:
        common.append("--FEATURETRANSFORM=" + args.feature_transform)
    if args.mesh and not args.resident:
        common.append("--MESH=" + args.mesh)
    if args.compute_dtype and args.compute_dtype != "f32":
        common.append("--COMPUTEDTYPE=" + args.compute_dtype)

    def parse_accu(log: str) -> float:
        hits = re.findall(r"correct\[([\d.]+)%\]", log)
        if not hits:
            raise SystemExit("Error, No accuracy returned, terminating...")
        return float(hits[-1])

    def run_tnet(extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tnet.main(["tnet"] + extra + common)
        out = buf.getvalue()
        sys.stdout.write(out)
        return parse_accu(out)

    def train_epoch(src, lrate, dst):
        return run_tnet([
            "-H", src, "-I", args.mlf_train, "-S", args.scp_train,
            "--LEARNINGRATE=" + repr(lrate),
            "--MOMENTUM=" + repr(args.momentum),
            "--WEIGHTCOST=" + repr(args.weightcost),
            "--RANDOMIZE=TRUE", "--SEED=" + str(args.seed),
            "--TARGETMMF=" + dst])

    def crossvalidate(mmf):
        return run_tnet([
            "-c", "-H", mmf, "-I", args.mlf_cv, "-S", args.scp_cv,
            "--RANDOMIZE=FALSE"])

    cfg = NewbobConfig(
        learning_rate=args.learnrate, max_iter=args.max_iter,
        min_iter=args.min_iter, keep_lrate_iter=args.keep_lrate_iter,
        start_halving_inc=args.start_halving_inc,
        end_halving_inc=args.end_halving_inc,
        halving_factor=args.halving_factor)
    if args.resident:
        from .. import enable_compilation_cache
        enable_compilation_cache()
        from ..io.labels import LabelRepository
        from ..io.scp import read_scp
        from ..models.network import Network
        from ..train.resident import ResidentNewbob
        from ..train.sgd import SgdConfig
        from ..train.trainer import TrainerConfig

        from ..io.htk import FeatureReader
        reader = FeatureReader(start_frm_ext=args.frm_ext,
                               end_frm_ext=args.frm_ext)
        labels_repo = LabelRepository(args.mlf_train, args.phonelist,
                                      "*/", "lab")
        transform = (Network.read(args.feature_transform)
                     if args.feature_transform else None)
        cdt = args.compute_dtype if args.compute_dtype not in (None, "f32") \
            else None
        tcfg = TrainerConfig(
            bunchsize=args.bunchsize, cachesize=args.cachesize,
            seed=args.seed, randomize=True, compute_dtype=cdt,
            sgd=SgdConfig(learning_rate=args.learnrate,
                          momentum=args.momentum,
                          weightcost=args.weightcost))
        cv_repo = (labels_repo if args.mlf_cv == args.mlf_train else
                   LabelRepository(args.mlf_cv, args.phonelist, "*/", "lab"))
        mesh = None
        if args.mesh:
            from ..parallel.mesh import make_mesh

            d, _, m = args.mesh.lower().partition("x")
            mesh = make_mesh(data=int(d), model=int(m) if m else 1)
        budget = (int(args.hbm_budget_mb * 1024 * 1024)
                  if args.hbm_budget_mb else None)
        runner = ResidentNewbob(args.nn_init, transform, reader,
                                labels_repo, tcfg, args.frm_ext,
                                mesh=mesh, hbm_budget_bytes=budget)
        train_entries = read_scp(args.scp_train)
        cv_entries = read_scp(args.scp_cv)
        import jax
        if jax.process_count() > 1:
            # per-host input sharding, as tnet --DISTRIBUTED does
            pid, nproc = jax.process_index(), jax.process_count()
            train_entries = train_entries[pid::nproc]
            cv_entries = cv_entries[pid::nproc]
        runner.prepare(train_entries, cv_entries, cv_labels_repo=cv_repo)
        train_epoch, crossvalidate = runner.train_epoch, runner.crossvalidate
    newbob_kwargs = {}
    if args.resident:
        import jax
        if jax.process_count() > 1:
            # every process replays the identical decision loop; only
            # process 0 touches the weight files, behind fleet barriers
            from jax.experimental import multihost_utils

            newbob_kwargs = dict(
                fs_ops=jax.process_index() == 0,
                barrier=lambda: multihost_utils.sync_global_devices(
                    "newbob_fs"))
    best, st = run_newbob(cfg, args.nn_init, args.weights_dir,
                          train_epoch, crossvalidate, **newbob_kwargs)
    print(f"Best model: {best} (CV {st.accu_best:.4f}%, "
          f"{len(st.history)} iterations)")
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
