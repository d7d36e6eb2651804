"""Example-02 recipe pipeline test: the stages chain end-to-end
(prepare → tjoiner → tnorm → newbob train) on the stand-in corpus.

Mirrors the reference's RUN_IT_ALL.sh flow (examples/02train_MLP3_newbob_
timit) wired to our tools; the decode stage needs the STK SVite build and
only runs when /tmp/stk/SVite already exists."""

import os
import re
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX01 = "/root/reference/examples/01test_MLP3_compare_multithread_cuda_decode_phn"

pytestmark = pytest.mark.skipif(not os.path.isdir(EX01),
                                reason="example-01 data not available")


def test_example02_pipeline_chains(tmp_path):
    env = dict(os.environ)
    env["MAX_ITER"] = "1"
    env.pop("NNET_GPU", None)
    r = subprocess.run(
        ["bash", os.path.join(REPO, "examples/run_example02.sh"),
         str(tmp_path), "--skip-decode"],
        env=env, capture_output=True, text=True, timeout=480)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out

    # stage 1: prepared corpus layout (prepare_timit workdir shape)
    assert (tmp_path / "workdir/lists/train_fea.scp").exists()
    assert (tmp_path / "workdir/lists/cv_fea.scp").exists()
    assert (tmp_path / "workdir/mlfs/ref.mlf").exists()
    phones = (tmp_path / "workdir/dicts/phones").read_text().split()
    assert len(phones) == 45

    # stage 2: joined archives + rewritten SCP with [s,e] ranges
    scp = (tmp_path / "train_fea_tjoiner15.scp").read_text().splitlines()
    assert len(scp) == 80 and "[" in scp[0]
    assert os.listdir(tmp_path / "joined")

    # stage 3: transform 23×ctx31 → DCT16 = 368 with norm appended
    transf = (tmp_path / "tr_23Tcontext31_Ham_dct16.transf").read_text()
    assert "<window> 368 368" in transf     # tnorm's variance-scale layer
    from nnet_asr_tpu.models import Network
    net = Network.read(str(tmp_path / "tr_23Tcontext31_Ham_dct16.transf"))
    assert net.n_outputs == 368

    # stage 4: newbob trained + accepted at least one epoch
    assert re.search(r"CV accuracy: [\d.]+ iter: 1", out), out
    finals = [f for f in os.listdir(tmp_path / "weights") if "_final_" in f]
    assert finals, os.listdir(tmp_path / "weights")
    trained = Network.read(str(tmp_path / "weights" / finals[0]))
    assert trained.n_outputs == 45
    accs = re.findall(r"correct\[([\d.]+)%\]", out)
    assert accs and float(accs[-1]) > 10.0   # beats chance (45 classes)


@pytest.fixture(scope="session")
def svite():
    """Build (or reuse the /tmp/stk-cached) STK SVite + SResults. The
    build is parallel g++ (~60s cold, no-op warm) so the decode stage is
    part of the default suite instead of its only skip."""
    if not os.path.isdir("/root/reference/src/STKLib/trunk"):
        pytest.skip("vendored STK trunk not available")
    r = subprocess.run(
        ["bash", os.path.join(REPO, "scripts/build_stk.sh")],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return "/tmp/stk/SVite"


def test_example02_decode_stage(tmp_path, svite):
    env = dict(os.environ)
    env["MAX_ITER"] = "1"
    env.pop("NNET_GPU", None)
    r = subprocess.run(
        ["bash", os.path.join(REPO, "examples/run_example02.sh"),
         str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out
    m = re.search(r"WORD: %Corr=([\d.]+), Acc=(-?[\d.]+)", out)
    assert m, out
    assert float(m.group(1)) > 15.0          # decode produced real phones
