#!/usr/bin/env python3
"""Smoke run of the acoustic-model trainer on an NVIDIA GPU.

Drives the main path once through the tools' own ``main(argv)`` entry
points, all in this one process, so that only one JAX process holds the
card. Phases, in order (each prints one line of findings):

  0 device      refuse anything but a GPU; card name and power limit
  1 corpus      seeded TIMIT-shaped corpus -> tjoiner -> hamm_dct -> tnorm
                -> gen_mlp_init (examples/run_timit_scale.sh, stages 1-4)
  2 frame CE    tnet: one epoch of the example-02 MLP3 (368:500:39),
                then tnet -c
  3 resident    scheduler --resident, two newbob iterations
  4 others      trbm (threefry and rbg), trecurrent, tfeacat f32 against
                --INT8, tnet --COMPUTEDTYPE=int8pfsr
  5 production  Trainer's drain at 1024->4096^4->8192, bunch 1024
  6 reference   example-01's MLP3 (598:1024:135, bunch 960) against the
                float64 NumPy oracle and against the same drain on the CPU
  7 plain XLA   affine+sigmoid (forward, VJP) and softmax-CE at
                production widths: the times a hand-written kernel must beat

Any failed check raises, and the script exits non-zero. The last line of
standard output is one JSON object naming the device.

    python chip_smoke.py                # one card, phases 0-7
    python chip_smoke.py --four-cards   # only the mesh path on four cards:
                                        # tnet --MESH=4x1 and 2x2, scheduler
                                        # --resident --mesh=4x1, each against
                                        # the single-card run

Long tool output goes to ``<workdir>/logs``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# example-02's TIMIT MLP3 recipe (examples/run_timit_scale.sh)
FRM_EXT = 15
DIM_IN = 23
DCT_BASE = 16
HIDDEN = 500
LEARNRATE = 4.0
BUNCH = 1024
CACHE = 65536
MIN_CV_ACC = 10.0           # percent; chance is 1/39 = 2.6%

# Phase 6 tolerances. At "highest" a float32 GPU forward agrees with a
# float64 one to float32 rounding. One 15-bunch drain on the GPU and on the
# CPU differ only in the order of float32 sums over 960-frame bunches; a
# parameter's deviation is taken relative to the largest magnitude in its
# tensor, since elements near zero have no relative precision to keep.
POST_ATOL_HIGHEST = 1e-5
XENT_RTOL_HIGHEST = 1e-5
PARAM_RTOL_HIGHEST = 1e-4
# At the default precision a float32 dot may run in TF32 (10-bit
# mantissa). That deviation is printed and held only to this wide band:
# posteriors in absolute terms, parameters relative to their tensor's
# largest magnitude.
TF32_BAND = 5e-2
# Mesh runs against the single-card run, at "highest": the tolerance the
# CPU mesh tests use (tests/test_sharded_trainer.py).
MESH_RTOL = 5e-3
MESH_ATOL = 1e-5
MESH_ACC_POINTS = 0.1


def say(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


# --------------------------------------------------------------------- 0 --

def require_gpu(devices, count=1):
    """The devices, or SystemExit when they are not ``count`` GPUs."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found {found!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs; JAX found "
                         f"{len(devices)}")
    return devices


def card_line():
    """Card name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def result_line(devices):
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def phase_device(count):
    import jax

    devices = require_gpu(jax.devices(), count)
    from nnet_asr_tpu import enable_compilation_cache
    from nnet_asr_tpu.io import native

    cache = enable_compilation_cache()
    card = card_line()
    print(card, flush=True)
    say(0, f"{devices[0].device_kind} x{len(devices)}, jax {jax.__version__},"
           f" compile cache {cache}, native HTK reader "
           f"{'built' if native.available() else 'NOT built'}")
    return devices, card.splitlines()[0]


# ----------------------------------------------------------- tool driving --

def run_tool(main, argv, log):
    """Run a tool's ``main(argv)`` with its stdout captured into ``log``."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        with open(log, "a") as f:
            f.write(f"$ {' '.join(argv)}\n{buf.getvalue()}\n")
    if rc not in (0, None):
        raise RuntimeError(f"{argv[0]} returned {rc}; see {log}")
    return buf.getvalue()


def xent_line(out):
    """(Xent per frame, accuracy %) of a tnet/trecurrent report."""
    m = re.findall(r"err/frm:(\S+) correct\[([\d.]+)%\]", out)
    if not m:
        raise RuntimeError("no Xent report in tool output")
    return float(m[-1][0]), float(m[-1][1])


def load_module(subdir, name):
    """Import ``<repo>/<subdir>/<name>.py``, a script outside the package."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, subdir, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------- 1 --

def phase_corpus(work, train_utts=400, cv_utts=40, seed=20260819):
    """Seeded corpus and the recipe's front end; returns the paths."""
    from nnet_asr_tpu.tools import gen_mlp_init, generators, tjoiner, tnorm

    t0 = time.perf_counter()
    logs = os.path.join(work, "logs")
    os.makedirs(logs, exist_ok=True)
    wd = os.path.join(work, "workdir")
    prep = load_module("examples", "prepare_timit_scale")
    with contextlib.redirect_stdout(io.StringIO()):
        prep.main([wd, f"--train-utts={train_utts}",
                   f"--cv-utts={cv_utts}", f"--seed={seed}"])
    p = {"work": work, "logs": logs,
         "mlf": os.path.join(wd, "mlfs", "ref.mlf"),
         "phones": os.path.join(wd, "dicts", "phones"),
         "scp_cv": os.path.join(wd, "lists", "cv_fea.scp"),
         "scp_train": os.path.join(work, f"train_fea_tjoiner{FRM_EXT}.scp")}
    ext = [f"--STARTFRMEXT={FRM_EXT}", f"--ENDFRMEXT={FRM_EXT}"]
    log = os.path.join(logs, "corpus.log")
    run_tool(tjoiner.main, [
        "tjoiner", "-T", "01", "-S", os.path.join(wd, "lists", "train_fea.scp"),
        "-l", os.path.join(work, "joined"),
        "--OUTPUTSCRIPT=" + p["scp_train"]] + ext, log)
    mmf = os.path.join(
        work, f"tr_{DIM_IN}Tcontext{2 * FRM_EXT + 1}_Ham_dct{DCT_BASE}")
    with open(mmf, "w") as f:
        f.write(run_tool(generators.main, [
            "hamm_dct", f"--dimIn={DIM_IN}", f"--startFrmExt={FRM_EXT}",
            f"--endFrmExt={FRM_EXT}", f"--dctBaseCnt={DCT_BASE}"], log))
    run_tool(tnorm.main, ["tnorm", "-T", "1", "-S", p["scp_train"], "-H", mmf,
                          "--TARGETMMF=" + mmf + ".norm"] + ext, log)
    p["transform"] = mmf + ".transf"
    with open(p["transform"], "w") as f:
        for part in (mmf, mmf + ".norm"):
            with open(part) as g:
                f.write(g.read())
    with open(p["phones"]) as f:
        n_phones = len(f.read().split())
    p["dim_nn"] = DIM_IN * DCT_BASE
    p["n_phones"] = n_phones
    p["init"] = os.path.join(work, f"nnet_{p['dim_nn']}_{HIDDEN}_{n_phones}.init")
    with open(p["init"], "w") as f:
        f.write(run_tool(gen_mlp_init.main, [
            f"--dim={p['dim_nn']}:{HIDDEN}:{n_phones}", "--gauss", "--negbias",
            "--seed=4242"], log))
    say(1, f"corpus {train_utts} train + {cv_utts} cv utterances, "
           f"{n_phones} phones, MLP3 {p['dim_nn']}:{HIDDEN}:{n_phones} "
           f"({time.perf_counter() - t0:.1f}s)")
    return p


def tnet_args(p, bunch=BUNCH, cache=CACHE):
    return ["-m", p["phones"], "-I", p["mlf"], "-L", "*/", "-X", "lab",
            f"--BUNCHSIZE={bunch}", f"--CACHESIZE={cache}",
            f"--STARTFRMEXT={FRM_EXT}", f"--ENDFRMEXT={FRM_EXT}",
            "--FEATURETRANSFORM=" + p["transform"]]


# --------------------------------------------------------------------- 2 --

def phase_frame_ce(p, bunch=BUNCH, cache=CACHE, min_cv_acc=MIN_CV_ACC,
                   extra=(), tag="epoch1"):
    """One tnet training epoch, then tnet -c; returns (model, cv acc)."""
    from nnet_asr_tpu.tools import tnet

    t0 = time.perf_counter()
    log = os.path.join(p["logs"], f"tnet_{tag}.log")
    model = os.path.join(p["work"], f"{tag}.mmf")
    common = tnet_args(p, bunch, cache) + list(extra)
    tr_xent, tr_acc = xent_line(run_tool(tnet.main, [
        "tnet", "-H", p["init"], "-S", p["scp_train"], "-n", str(LEARNRATE),
        "--RANDOMIZE=TRUE", "--SEED=123", "--TARGETMMF=" + model] + common,
        log))
    cv_xent, cv_acc = xent_line(run_tool(tnet.main, [
        "tnet", "-c", "-H", model, "-S", p["scp_cv"], "--RANDOMIZE=FALSE"]
        + common, log))
    if not (np.isfinite(tr_xent) and np.isfinite(cv_xent)):
        raise RuntimeError(f"non-finite Xent: train {tr_xent} cv {cv_xent}")
    if cv_acc <= min_cv_acc:
        raise RuntimeError(f"CV accuracy {cv_acc}% <= {min_cv_acc}%")
    say(2, f"tnet {tag}: train Xent/frm {tr_xent:.4f} acc {tr_acc:.2f}%, "
           f"CV Xent/frm {cv_xent:.4f} acc {cv_acc:.2f}% "
           f"({time.perf_counter() - t0:.1f}s)")
    return model, cv_acc


# --------------------------------------------------------------------- 3 --

def phase_resident(p, max_iter=2, mesh=None, tag="resident"):
    """Resident newbob; returns (best CV accuracy, best model path)."""
    from nnet_asr_tpu.tools import scheduler

    t0 = time.perf_counter()
    wdir = os.path.join(p["work"], f"weights_{tag}")
    shutil.rmtree(wdir, ignore_errors=True)
    argv = ["--nn-init=" + p["init"], "--mlf-train=" + p["mlf"],
            "--mlf-cv=" + p["mlf"], "--scp-train=" + p["scp_train"],
            "--scp-cv=" + p["scp_cv"], "--phonelist=" + p["phones"],
            f"--learnrate={LEARNRATE}", f"--frm-ext={FRM_EXT}",
            "--feature-transform=" + p["transform"],
            f"--bunchsize={BUNCH}", f"--cachesize={CACHE}",
            f"--max-iter={max_iter}", "--weights-dir=" + wdir, "--resident"]
    if mesh:
        argv.append("--mesh=" + mesh)
    out = run_tool(scheduler.main, argv,
                   os.path.join(p["logs"], f"scheduler_{tag}.log"))
    m = re.search(r"Best model: (\S+) \(CV ([\d.]+)%, (\d+) iterations\)", out)
    if not m:
        raise RuntimeError("scheduler printed no best model")
    best, cv = m.group(1), float(m.group(2))
    if cv <= MIN_CV_ACC:
        raise RuntimeError(f"resident CV accuracy {cv}% <= {MIN_CV_ACC}%")
    say(3, f"scheduler --resident{' --mesh=' + mesh if mesh else ''}: "
           f"{m.group(3)} iterations, best CV {cv:.2f}% "
           f"({time.perf_counter() - t0:.1f}s)")
    return cv, best


# --------------------------------------------------------------------- 4 --

def phase_other_tools(p, model):
    from nnet_asr_tpu.io import htk
    from nnet_asr_tpu.tools import generators, tfeacat, trbm, trecurrent

    t0 = time.perf_counter()
    work, logs = p["work"], p["logs"]
    log = os.path.join(logs, "others.log")
    ext = [f"--STARTFRMEXT={FRM_EXT}", f"--ENDFRMEXT={FRM_EXT}",
           "--FEATURETRANSFORM=" + p["transform"]]
    found = []

    # RBM CD-1 (Gaussian-Bernoulli first layer), both sampling generators
    rbm_init = os.path.join(work, "rbm.init")
    with open(rbm_init, "w") as f:
        f.write(run_tool(generators.main, [
            "rbm_init", f"--dim={p['dim_nn']}:{HIDDEN}", "--vistype=gauss",
            "--gauss", "--seed=7"], log))
    for rng in ("threefry", "rbg"):
        out = run_tool(trbm.main, [
            "trbm", "-H", rbm_init, "-S", p["scp_cv"], "--LEARNINGRATE=0.01",
            f"--BUNCHSIZE={BUNCH}", f"--CACHESIZE={CACHE}", f"--RNGIMPL={rng}",
            "--TARGETMMF=" + os.path.join(work, f"rbm_{rng}.mmf")] + ext, log)
        mse = float(re.findall(r"err/frm:(\S+)", out)[-1])
        if not np.isfinite(mse):
            raise RuntimeError(f"trbm {rng}: non-finite reconstruction MSE")
        found.append(f"trbm {rng} mse/frm {mse:.4f}")

    # truncated-BPTT recurrent net on a few utterances
    rec = io.StringIO()
    rec.write(run_tool(generators.main, [
        "recurrent_init", f"--dim={p['dim_nn']}:128", "--gauss",
        "--seed=4"], log))
    rng = np.random.default_rng(4)
    w = 0.1 * rng.standard_normal((p["n_phones"], 128))
    rec.write(f"<biasedlinearity> {p['n_phones']} 128\nm {p['n_phones']} 128\n")
    rec.write("\n".join(" ".join(repr(float(v)) for v in row) for row in w))
    rec.write(f"\nv {p['n_phones']}\n" + " ".join(["0.0"] * p["n_phones"])
              + f"\n<softmax> {p['n_phones']} {p['n_phones']}\n")
    rec_init = os.path.join(work, "rec.init")
    with open(rec_init, "w") as f:
        f.write(rec.getvalue())
    few = os.path.join(work, "cv_few.scp")
    with open(p["scp_cv"]) as f:
        lines = f.readlines()[:6]
    with open(few, "w") as f:
        f.writelines(lines)
    xe, acc = xent_line(run_tool(trecurrent.main, [
        "trec", "-H", rec_init, "-I", p["mlf"], "-L", "*/", "-X", "lab",
        "-S", few, "-m", p["phones"], "-n", "0.01", "--BPTT=4",
        "--TARGETMMF=" + os.path.join(work, "rec.mmf")] + ext, log))
    if not np.isfinite(xe):
        raise RuntimeError("trecurrent: non-finite Xent")
    found.append(f"trecurrent Xent/frm {xe:.4f}")

    # posterior dumps: f32 against the int8 inference path
    dirs = {}
    for mode, flags in (("f32", []), ("int8", ["--INT8=TRUE"])):
        d = dirs[mode] = os.path.join(work, f"post_{mode}")
        os.makedirs(d, exist_ok=True)
        run_tool(tfeacat.main, ["tfeacat", "-H", model, "-S", p["scp_cv"],
                                "-l", d, "-y", "post"] + ext + flags, log)
    names = sorted(os.listdir(dirs["f32"]))
    if not names or names != sorted(os.listdir(dirs["int8"])):
        raise RuntimeError("tfeacat f32/int8 wrote different file sets")
    dev, agree, n = 0.0, 0, 0
    for name in names:
        a, _ = htk.read_htk_file(os.path.join(dirs["f32"], name))
        b, _ = htk.read_htk_file(os.path.join(dirs["int8"], name))
        if a.shape != b.shape or not np.isfinite(b).all():
            raise RuntimeError(f"tfeacat int8 {name}: bad output")
        dev = max(dev, float(np.max(np.abs(a - b))))
        agree += int((a.argmax(1) == b.argmax(1)).sum())
        n += a.shape[0]
    # the CPU test's bounds for the same comparison
    # (tests/test_feacat_norm.py::test_tfeacat_int8_close_to_f32)
    if dev >= 5e-2 or agree / n <= 0.9:
        raise RuntimeError(f"tfeacat int8 vs f32: max |dp| {dev:.4g}, "
                           f"argmax agreement {agree / n:.4f}")
    found.append(f"tfeacat int8 vs f32 max|dp| {dev:.2e} "
                 f"argmax agree {100 * agree / n:.2f}%")

    # quantized training (stochastic rounding): one cache of CV data
    from nnet_asr_tpu.tools import tnet
    xe, acc = xent_line(run_tool(tnet.main, [
        "tnet", "-H", p["init"], "-S", p["scp_cv"], "-n", str(LEARNRATE),
        "--COMPUTEDTYPE=int8pfsr", "--SEED=5",
        "--TARGETMMF=" + os.path.join(work, "int8pfsr.mmf")]
        + tnet_args(p), log))
    if not np.isfinite(xe):
        raise RuntimeError("tnet int8pfsr: non-finite Xent")
    found.append(f"tnet int8pfsr Xent/frm {xe:.4f} acc {acc:.2f}%")
    say(4, "; ".join(found) + f" ({time.perf_counter() - t0:.1f}s)")


# ----------------------------------------------------------- MLP helpers --

def mlp(dims, scale, seed):
    """Sigmoid MLP with a softmax head and seeded Gaussian weights."""
    from nnet_asr_tpu.models import BiasedLinearity, Network, Sigmoid, Softmax

    rng = np.random.default_rng(seed)
    specs, params = [], []
    for i in range(len(dims) - 1):
        specs.append(BiasedLinearity(dims[i], dims[i + 1]))
        params.append({
            "weight": (scale * rng.standard_normal(
                (dims[i], dims[i + 1]))).astype(np.float32),
            "bias": np.zeros(dims[i + 1], np.float32)})
        if i < len(dims) - 2:
            specs.append(Sigmoid(dims[i + 1], dims[i + 1]))
            params.append({})
    specs.append(Softmax(dims[-1], dims[-1]))
    params.append({})
    return Network(tuple(specs), params)


def mib(n):
    return f"{n / 2 ** 20:.1f}"


# --------------------------------------------------------------------- 5 --

def phase_production(dims=(1024, 4096, 4096, 4096, 4096, 8192), bunch=1024,
                     n_bunches=8, n_drains=4, card=""):
    import jax
    import jax.numpy as jnp

    from nnet_asr_tpu.train.sgd import SgdConfig
    from nnet_asr_tpu.train.trainer import Trainer, TrainerConfig

    net = mlp(list(dims), 0.05, 7)
    cfg = TrainerConfig(bunchsize=bunch, cachesize=bunch * n_bunches,
                        randomize=False, sgd=SgdConfig(learning_rate=0.01))
    tr = Trainer(net, cfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    feats = jax.random.normal(k1, (n_bunches, bunch, dims[0]), jnp.float32)
    labels = jax.random.randint(k2, (n_bunches, bunch), 0, dims[-1], jnp.int32)
    params, velocity = jax.device_put(tr.params), jax.device_put(tr.velocity)
    t0 = time.perf_counter()
    compiled = tr._drain_train.lower(params, velocity, tr._zero_acc(), feats,
                                     labels, tr._lr).compile()
    t_compile = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    params, velocity, acc = compiled(params, velocity, tr._zero_acc(), feats,
                                     labels, tr._lr)
    jax.block_until_ready(acc)
    accs = []
    t0 = time.perf_counter()
    for _ in range(n_drains):
        params, velocity, acc = compiled(params, velocity, tr._zero_acc(),
                                         feats, labels, tr._lr)
        accs.append(acc)
    jax.block_until_ready((params, accs))
    per_drain = (time.perf_counter() - t0) / n_drains
    xents = [float(a["xent"]) for a in accs]
    if not all(np.isfinite(xents)) or not all(
            bool(jnp.isfinite(p["weight"]).all()) for p in params if p):
        raise RuntimeError(f"production drain: non-finite state {xents}")
    frames = n_bunches * bunch
    flops = 6 * frames * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    say(5, f"MLP {'-'.join(map(str, dims))} bunch {bunch} x{n_bunches}: "
           f"{per_drain:.6f} s/drain, {frames / per_drain:.1f} frames/s, "
           f"{flops / per_drain / 1e12:.2f} TFLOP/s (6*frames*weights), "
           f"compile {t_compile:.1f}s; memory MiB: args "
           f"{mib(ma.argument_size_in_bytes)} out "
           f"{mib(ma.output_size_in_bytes)} temp {mib(ma.temp_size_in_bytes)}"
           f" alias {mib(ma.alias_size_in_bytes)}; Xent/frm "
           f"{xents[-1] / frames:.4f}; card {card}")
    return per_drain


# --------------------------------------------------------------------- 6 --

def compare_reference(device, ref_device, precision, dims=(598, 1024, 135),
                      bunch=960, n_bunches=15, seed=0):
    """Example-01's MLP3 on ``device`` against the float64 NumPy oracle
    (forward posteriors and Xent) and against the same jitted drain on
    ``ref_device`` (parameters after one drain). Returns the deviations."""
    import jax
    import jax.numpy as jnp

    from nnet_asr_tpu.ops.objectives import xent_loss_and_stats
    from nnet_asr_tpu.train.sgd import SgdConfig
    from nnet_asr_tpu.train.trainer import Trainer, TrainerConfig

    oracle = load_module("tests", "oracle")
    net = mlp(list(dims), 0.1, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n_bunches, bunch, dims[0])).astype(np.float32)
    y = rng.integers(0, dims[-1], (n_bunches, bunch)).astype(np.int32)
    flat_x, flat_y = x.reshape(-1, dims[0]), y.reshape(-1)
    cfg = TrainerConfig(bunchsize=bunch, cachesize=bunch * n_bunches,
                        seed=123, randomize=False,
                        sgd=SgdConfig(learning_rate=0.008, grad_div_frm=False))

    def forward(params, xx, lab):
        logits = net.apply_upto(params, xx, len(net.specs) - 1)
        _, stats = xent_loss_and_stats(logits, lab)
        return jax.nn.softmax(logits, axis=-1), stats["xent"]

    def drain(dev):
        with jax.default_device(dev), jax.default_matmul_precision(precision):
            tr = Trainer(net, cfg)
            post, xent = jax.jit(forward)(tr.params, jnp.asarray(flat_x),
                                          jnp.asarray(flat_y))
            params, _, acc = tr._drain_train(
                tr.params, tr.velocity, tr._zero_acc(), jnp.asarray(x),
                jnp.asarray(y), tr._lr)
            return (np.asarray(post), float(xent),
                    [{k: np.asarray(v) for k, v in p.items()} for p in params],
                    float(acc["xent"]))

    post, xent, params, drain_xent = drain(device)
    _, _, ref_params, _ = drain(ref_device)
    post64 = oracle.forward_network(net, flat_x, dtype=np.float64)
    onehot = np.eye(dims[-1])[flat_y]
    _, xent64, _ = oracle.cross_entropy_eval(post64, onehot)
    if not (np.isfinite(post).all() and np.isfinite(drain_xent)):
        raise RuntimeError("reference comparison: non-finite output")
    dp = [(float(np.abs(p[k] - r[k]).max()), float(np.abs(r[k]).max()))
          for p, r in zip(params, ref_params) for k in p]
    return {
        "post_max_abs": float(np.abs(post - post64).max()),
        "xent_rel": abs(xent - xent64) / abs(xent64),
        "param_max_abs": max(d for d, _ in dp),
        "param_max_rel": max(d / max(m, 1e-30) for d, m in dp),
        "params": params, "ref_params": ref_params,
    }


def check_highest(dev):
    """Raise when ``compare_reference`` at "highest" is out of tolerance."""
    if dev["post_max_abs"] > POST_ATOL_HIGHEST:
        raise RuntimeError(f"posteriors off the float64 oracle by "
                           f"{dev['post_max_abs']:.3g} > {POST_ATOL_HIGHEST}")
    if dev["xent_rel"] > XENT_RTOL_HIGHEST:
        raise RuntimeError(f"Xent off the float64 oracle by "
                           f"{dev['xent_rel']:.3g} > {XENT_RTOL_HIGHEST}")
    if dev["param_max_rel"] > PARAM_RTOL_HIGHEST:
        raise RuntimeError(f"parameters off the CPU drain by "
                           f"{dev['param_max_rel']:.3g} of their tensor's "
                           f"scale > {PARAM_RTOL_HIGHEST}")


def check_band(dev):
    """Raise when a default-precision run leaves the wide TF32 band."""
    if dev["post_max_abs"] > TF32_BAND or dev["param_max_rel"] > TF32_BAND:
        raise RuntimeError(f"default precision outside the {TF32_BAND} band: "
                           f"posteriors {dev['post_max_abs']:.3g}, params "
                           f"{dev['param_max_rel']:.3g}")


def phase_reference():
    import jax

    t0 = time.perf_counter()
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    hi = compare_reference(gpu, cpu, "highest")
    check_highest(hi)
    lo = compare_reference(gpu, cpu, "default")
    check_band(lo)
    say(6, "MLP3 598:1024:135 bunch 960 x15 vs float64 oracle / CPU drain: "
           f"highest post {hi['post_max_abs']:.3e} xent {hi['xent_rel']:.3e} "
           f"params abs {hi['param_max_abs']:.3e} rel "
           f"{hi['param_max_rel']:.3e}; default (TF32) post "
           f"{lo['post_max_abs']:.3e} xent {lo['xent_rel']:.3e} params abs "
           f"{lo['param_max_abs']:.3e} rel {lo['param_max_rel']:.3e} "
           f"({time.perf_counter() - t0:.1f}s)")


# --------------------------------------------------------------------- 7 --

def time_per_item(fn, args, n_items, reps=10):
    """Median seconds per stacked item of a jitted ``fn`` (compiled first)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / n_items


def phase_plain_xla(bunch=1024, n_in=1024, n_hid=4096, n_out=8192, k=64,
                    big=8192, card=""):
    """Plain XLA at production widths, ``k`` stacked inputs per call
    (lax.map) so that device time and not dispatch sets the number; beside
    them what a large float32 matmul (``big``^3, default precision) and a
    large elementwise copy reach on this card in the same process."""
    import jax
    import jax.numpy as jnp

    from nnet_asr_tpu.models import BiasedLinearity, Sigmoid
    from nnet_asr_tpu.ops.objectives import xent_loss_and_stats

    bl, sg = BiasedLinearity(n_in, n_hid), Sigmoid(n_hid, n_hid)
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    xs = jax.random.normal(keys[0], (k, bunch, n_in), jnp.float32)
    w = 0.05 * jax.random.normal(keys[1], (n_in, n_hid), jnp.float32)
    b = jnp.zeros((n_hid,), jnp.float32)
    gs = jax.random.normal(keys[2], (k, bunch, n_hid), jnp.float32)
    logits = jax.random.normal(keys[3], (k, bunch, n_out), jnp.float32)
    labels = jax.random.randint(keys[4], (k, bunch), 0, n_out, jnp.int32)

    def affine_sigmoid(x, w, b):
        with jax.named_scope("affine_sigmoid"):
            return sg.apply({}, bl.apply({"weight": w, "bias": b}, x))

    @jax.jit
    def fwd(xs, w, b):
        return jax.lax.map(lambda x: affine_sigmoid(x, w, b), xs)

    @jax.jit
    def fwd_vjp(xs, gs, w, b):
        def one(xg):
            y, vjp = jax.vjp(affine_sigmoid, xg[0], w, b)
            return vjp(xg[1])
        return jax.lax.map(one, (xs, gs))

    @jax.jit
    def xent(logits, labels):
        def one(ll):
            with jax.named_scope("softmax_xent"):
                (_, st), g = jax.value_and_grad(
                    xent_loss_and_stats, has_aux=True)(ll[0], ll[1])
            return g, st["xent"]
        return jax.lax.map(one, (logits, labels))

    t_fwd = time_per_item(fwd, (xs, w, b), k)
    t_vjp = time_per_item(fwd_vjp, (xs, gs, w, b), k)
    t_ce = time_per_item(xent, (logits, labels), k)
    a = jax.random.normal(keys[0], (big, big), jnp.float32)
    t_mm = time_per_item(jax.jit(lambda a: a @ a), (a,), 1)
    t_cp = time_per_item(jax.jit(lambda a: a * 1.0001), (a,), 1)
    gemm = 2 * bunch * n_in * n_hid
    say(7, f"plain XLA, {card}: affine+sigmoid {bunch}x{n_in}->{n_hid} fwd "
           f"{t_fwd * 1e6:.2f}us ({gemm / t_fwd / 1e12:.2f} TFLOP/s), "
           f"fwd+VJP {t_vjp * 1e6:.2f}us ({3 * gemm / t_vjp / 1e12:.2f} "
           f"TFLOP/s); softmax-CE value+grad {bunch}x{n_out} "
           f"{t_ce * 1e6:.2f}us ({2 * 4 * bunch * n_out / t_ce / 1e9:.1f} "
           f"GB/s logits in + grad out); same card: f32 matmul {big}^3 "
           f"{2 * big ** 3 / t_mm / 1e12:.1f} TFLOP/s, copy "
           f"{2 * 4 * big * big / t_cp / 1e9:.1f} GB/s")
    return t_fwd, t_vjp, t_ce


# ------------------------------------------------------------- four cards --

def max_param_dev(a_path, b_path):
    from nnet_asr_tpu.models import Network

    a, b = Network.read(a_path), Network.read(b_path)
    worst = 0.0
    for pa, pb in zip(a.params, b.params):
        for k in pa:
            np.testing.assert_allclose(pa[k], pb[k], rtol=MESH_RTOL,
                                       atol=MESH_ATOL)
            worst = max(worst, float(np.abs(pa[k] - pb[k]).max()))
    return worst


def four_cards(p):
    """tnet --MESH=4x1 / 2x2 and resident --mesh=4x1 against one card."""
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    one, acc1 = phase_frame_ce(p, tag="single")
    for mesh in ("4x1", "2x2"):
        model, acc = phase_frame_ce(p, extra=[f"--MESH={mesh}"],
                                    tag=f"mesh{mesh}")
        dev = max_param_dev(model, one)
        if abs(acc - acc1) > MESH_ACC_POINTS:
            raise RuntimeError(f"--MESH={mesh} CV {acc}% vs single {acc1}%")
        say(2, f"--MESH={mesh} vs single card: max |dparam| {dev:.3e}, "
               f"CV {acc:.2f}% vs {acc1:.2f}%")
    cv1, best1 = phase_resident(p, max_iter=1, tag="resident_single")
    cv4, best4 = phase_resident(p, max_iter=1, mesh="4x1",
                                tag="resident_mesh4x1")
    dev = max_param_dev(best4, best1)
    if abs(cv4 - cv1) > MESH_ACC_POINTS:
        raise RuntimeError(f"resident --mesh=4x1 CV {cv4}% vs single {cv1}%")
    say(3, f"resident --mesh=4x1 vs single card: max |dparam| {dev:.3e}, "
           f"CV {cv4:.2f}% vs {cv1:.2f}%")


# ------------------------------------------------------------------- main --

def keep_logs_only(work):
    """Delete the corpus, models and posteriors; keep ``work/logs``."""
    for name in os.listdir(work) if os.path.isdir(work) else ():
        path = os.path.join(work, name)
        if name == "logs":
            continue
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh path, on four GPUs")
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, "chiprun_out", "chip_smoke"))
    args = ap.parse_args(argv)

    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        # phase 6's reference drain runs on the host CPU backend
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    t0 = time.perf_counter()
    devices, card = phase_device(4 if args.four_cards else 1)
    shutil.rmtree(args.workdir, ignore_errors=True)
    try:
        p = phase_corpus(args.workdir)
        if args.four_cards:
            four_cards(p)
        else:
            model, _ = phase_frame_ce(p)
            phase_resident(p)
            phase_other_tools(p, model)
            phase_production(card=card)
            phase_reference()
            phase_plain_xla(card=card)
    finally:
        keep_logs_only(args.workdir)
    print(f"total {time.perf_counter() - t0:.1f}s; card {card}", flush=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
