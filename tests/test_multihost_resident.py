"""Multi-host RESIDENT newbob: a real 2-process jax.distributed fleet
(4 devices each, one 4x2 mesh) runs the resident scheduler with per-host
SCP shards and must reproduce the streaming multi-host scheduler exactly
(identical newbob history, byte-identical accepted weights). See
tests/multihost_resident_driver.py for what each process asserts."""

import contextlib
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Same synthetic HTK corpus recipe as tests/test_resident.py."""
    from nnet_asr_tpu.io import htk
    from nnet_asr_tpu.io.mlf import MlfWriter
    from nnet_asr_tpu.tools import gen_mlp_init

    tmp = tmp_path_factory.mktemp("mh_resident")
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


def test_two_process_resident_matches_streaming(corpus, tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    env["PYTHONPATH"] = f"{REPO}:{HERE}"
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["NNET_ASR_NO_COMPILE_CACHE"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable,
             os.path.join(HERE, "multihost_resident_driver.py"),
             str(pid), str(port), str(corpus), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"driver failed:\n{out}"
    assert (tmp_path / "histories_ok").exists()
    # the resident epochs really ran on HBM-cached stacks
    assert "(resident, mesh)" in outs[0]
