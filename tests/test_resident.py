"""Resident (persistent-worker) newbob mode: byte-identical trajectory to
the streaming per-epoch scheduler (same seed => same bunch sequence; MMF
round-trips are exact)."""

import contextlib
import io
import os
import re

import numpy as np
import pytest

from nnet_asr_tpu.io import htk
from nnet_asr_tpu.io.mlf import MlfWriter
from nnet_asr_tpu.tools import gen_mlp_init, scheduler


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resident")
    rng = np.random.default_rng(0)
    dim, n_out = 6, 4
    (tmp / "phones.map").write_text(
        "\n".join(f"p{i}" for i in range(n_out)))
    mlf = MlfWriter(str(tmp / "labels.mlf"))
    train_lines, cv_lines = [], []
    for u in range(14):
        T = int(rng.integers(30, 70))
        labels = rng.integers(0, n_out, T)
        feats = (np.eye(dim, dtype=np.float32)[labels % dim] * 2.0
                 + 0.3 * rng.standard_normal((T, dim)).astype(np.float32))
        p = str(tmp / f"u{u}.fea")
        htk.write_htk_file(p, feats, htk.PARMKIND_USER)
        mlf.write_record(f"*/u{u}.lab", [
            f"{t * 100000} {(t + 1) * 100000} p{l}"
            for t, l in enumerate(labels)])
        (train_lines if u < 10 else cv_lines).append(p)
    mlf.close()
    (tmp / "train.scp").write_text("\n".join(train_lines) + "\n")
    (tmp / "cv.scp").write_text("\n".join(cv_lines) + "\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gen_mlp_init.main([f"--dim={dim}:8:{n_out}", "--gauss", "--negbias",
                           "--seed=5"])
    (tmp / "init.mmf").write_text(buf.getvalue())
    return tmp


def _run(tmp, mode_flag, weights_dir, extra=()):
    argv = [
        "--nn-init=" + str(tmp / "init.mmf"),
        "--mlf-train=" + str(tmp / "labels.mlf"),
        "--mlf-cv=" + str(tmp / "labels.mlf"),
        "--scp-train=" + str(tmp / "train.scp"),
        "--scp-cv=" + str(tmp / "cv.scp"),
        "--phonelist=" + str(tmp / "phones.map"),
        "--learnrate=0.5", "--bunchsize=32", "--cachesize=128",
        "--max-iter=4", "--momentum=0.4", "--weightcost=1e-5",
        "--weights-dir=" + str(weights_dir),
    ] + ([mode_flag] if mode_flag else []) + list(extra)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        scheduler.main(argv)
    return buf.getvalue()


def _history(out):
    return re.findall(r"(TR|CV) accuracy:\s*([\d.]+) iter: (\d+)", out)


def _assert_same_weights(dir_a, dir_b):
    names_a, names_b = sorted(os.listdir(dir_a)), sorted(os.listdir(dir_b))
    assert names_a == names_b
    for n in names_a:
        a = (dir_a / n).read_text()
        b = (dir_b / n).read_text()
        assert a == b, f"weights differ: {n}"


def test_resident_matches_streaming(corpus, tmp_path):
    out_s = _run(corpus, None, tmp_path / "w_stream")
    out_r = _run(corpus, "--resident", tmp_path / "w_res")

    # identical newbob decision sequence and accuracies
    assert _history(out_r) == _history(out_s)
    assert ("Best model" in out_r) and ("Best model" in out_s)

    # byte-identical accepted weights at every iteration
    _assert_same_weights(tmp_path / "w_stream", tmp_path / "w_res")


def test_resident_mesh_matches_streaming_mesh(corpus, tmp_path):
    """--resident --mesh=4x2: HBM-sharded stacks + sharded drains must
    reproduce the streaming mesh run (tnet --MESH=4x2) exactly — the two
    fastest modes compose."""
    out_s = _run(corpus, None, tmp_path / "w_sm", ["--mesh=4x2"])
    out_r = _run(corpus, "--resident", tmp_path / "w_rm", ["--mesh=4x2"])
    assert "(resident, mesh)" in out_r
    assert _history(out_r) == _history(out_s)
    _assert_same_weights(tmp_path / "w_sm", tmp_path / "w_rm")


def test_resident_partial_residency_budget(corpus, tmp_path):
    """A tiny HBM budget forces most stacks to park on the host and stream
    H2D per epoch; placement timing must not change the trajectory."""
    out_full = _run(corpus, "--resident", tmp_path / "w_full")
    out_part = _run(corpus, "--resident", tmp_path / "w_part",
                    ["--hbm-budget-mb=0.004"])
    assert "host-parked" in out_part and "host-parked" not in out_full
    assert _history(out_part) == _history(out_full)
    _assert_same_weights(tmp_path / "w_full", tmp_path / "w_part")


def test_resident_mesh_partial_residency(corpus, tmp_path):
    """Budgeted residency composes with the mesh too (sharded H2D per
    epoch)."""
    out_full = _run(corpus, "--resident", tmp_path / "w_mf", ["--mesh=2x2"])
    out_part = _run(corpus, "--resident", tmp_path / "w_mp",
                    ["--mesh=2x2", "--hbm-budget-mb=0.004"])
    assert "host-parked" in out_part
    assert _history(out_part) == _history(out_full)
    _assert_same_weights(tmp_path / "w_mf", tmp_path / "w_mp")


def test_resident_lr_runtime_scalar(corpus, tmp_path):
    """Newbob halving in resident mode must not change program identity:
    set_learning_rate only swaps a scalar operand."""
    out = _run(corpus, "--resident", tmp_path / "w")
    lrs = set(re.findall(r"learnrate: ([\d.e-]+)", out))
    assert len(lrs) >= 1
    assert "(resident)" in out


def test_resident_mesh_int8pfsr(corpus, tmp_path):
    """int8pfsr composes with --resident --mesh: the SR key must ride the
    sharded drains' accumulator (regression: the resident mesh branch
    built zero_acc() without '_sr_key' and the SR-mode drain rejected the
    tree) and the trajectory must match the streaming mesh run."""
    extra = ["--mesh=4x2", "--compute-dtype=int8pfsr"]
    out_s = _run(corpus, None, tmp_path / "w_sq", extra)
    out_r = _run(corpus, "--resident", tmp_path / "w_rq", extra)
    assert "(resident, mesh)" in out_r
    assert _history(out_r) == _history(out_s)
    _assert_same_weights(tmp_path / "w_sq", tmp_path / "w_rq")

    # single-chip resident matches single-chip streaming too (per-epoch
    # SR stream reset — the streaming scheduler is one process per epoch)
    sc = ["--compute-dtype=int8pfsr"]
    out_s1 = _run(corpus, None, tmp_path / "w_s1", sc)
    out_r1 = _run(corpus, "--resident", tmp_path / "w_r1", sc)
    assert _history(out_r1) == _history(out_s1)
    _assert_same_weights(tmp_path / "w_s1", tmp_path / "w_r1")
