"""TFeaCat / TNorm / newbob tests."""

import contextlib
import io
import os

import numpy as np
import pytest

import oracle
from nnet_asr_tpu.io import htk
from nnet_asr_tpu.models import Network
from nnet_asr_tpu.train.newbob import NewbobConfig, run_newbob


EXAMPLE01 = "/root/reference/examples/01test_MLP3_compare_multithread_cuda_decode_phn"


@pytest.fixture(scope="module")
def mlp_and_data(tmp_path_factory):
    if not os.path.isdir(EXAMPLE01):
        pytest.skip("reference example 01 not available")
    tmp = tmp_path_factory.mktemp("feacat")
    rng = np.random.default_rng(0)
    # small random MLP on top of the real transform
    from nnet_asr_tpu.models import BiasedLinearity, Sigmoid, Softmax
    specs = (BiasedLinearity(598, 64), Sigmoid(64, 64),
             BiasedLinearity(64, 135), Softmax(135, 135))
    params = [
        {"weight": (0.1 * rng.standard_normal((598, 64))).astype(np.float32),
         "bias": np.zeros(64, np.float32)}, {},
        {"weight": (0.1 * rng.standard_normal((64, 135))).astype(np.float32),
         "bias": np.zeros(135, np.float32)}, {},
    ]
    net = Network(specs, params)
    mmf = tmp / "net.mmf"
    net.write(str(mmf))
    scp = tmp / "sub.scp"
    with open(os.path.join(EXAMPLE01, "lib/test.scp")) as f:
        lines = f.readlines()[:3]
    scp.write_text("".join(os.path.join(EXAMPLE01, l) for l in lines))
    return net, str(mmf), str(scp), tmp


def test_tfeacat_bf16_close_to_f32(mlp_and_data):
    """--BF16 posterior dumps stay within bf16 rounding of the f32 path."""
    net, mmf, scp, tmp = mlp_and_data
    from nnet_asr_tpu.tools import tfeacat
    d32, d16 = tmp / "p32", tmp / "p16"
    d32.mkdir(exist_ok=True)
    d16.mkdir(exist_ok=True)
    common = ["tfeacat", "-H", mmf, "-S", scp,
              "--FEATURETRANSFORM=" + os.path.join(EXAMPLE01, "lib/Hamm_dct_norm"),
              "--STARTFRMEXT=25", "--ENDFRMEXT=25", "-y", "post"]
    tfeacat.main(common + ["-l", str(d32)])
    tfeacat.main(common + ["-l", str(d16), "--BF16=TRUE"])
    names = sorted(os.listdir(d32))
    assert names and names == sorted(os.listdir(d16))
    for name in names:
        a, _ = htk.read_htk_file(str(d32 / name))
        b, _ = htk.read_htk_file(str(d16 / name))
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) < 2e-2
        # posteriors still normalized
        np.testing.assert_allclose(b.sum(axis=1), 1.0, atol=1e-3)


def test_tfeacat_matches_oracle(mlp_and_data):
    net, mmf, scp, tmp = mlp_and_data
    outdir = tmp / "post"
    outdir.mkdir(exist_ok=True)
    from nnet_asr_tpu.tools import tfeacat
    tfeacat.main([
        "tfeacat", "-H", mmf, "-S", scp,
        "--FEATURETRANSFORM=" + os.path.join(EXAMPLE01, "lib/Hamm_dct_norm"),
        "--STARTFRMEXT=25", "--ENDFRMEXT=25",
        "-l", str(outdir), "-y", "post"])

    transform = Network.read(os.path.join(EXAMPLE01, "lib/Hamm_dct_norm"))
    reader = htk.FeatureReader(start_frm_ext=25, end_frm_ext=25)
    from nnet_asr_tpu.io.scp import read_scp
    for e in read_scp(scp):
        feats = reader.read(e.physical)
        h = oracle.forward_network(transform, feats)
        y = oracle.forward_network(net, h)[25:-25]
        name = os.path.basename(e.logical).replace(".fea", ".post")
        got, hdr = htk.read_htk_file(str(outdir / name))
        assert hdr.sample_kind == htk.PARMKIND_USER
        np.testing.assert_allclose(got, y, rtol=1e-4, atol=2e-5)


def test_tfeacat_gmm_bypass(mlp_and_data):
    net, mmf, scp, tmp = mlp_and_data
    outdir = tmp / "bypass"
    outdir.mkdir(exist_ok=True)
    from nnet_asr_tpu.tools import tfeacat
    tfeacat.main([
        "tfeacat", "-H", mmf, "-S", scp,
        "--FEATURETRANSFORM=" + os.path.join(EXAMPLE01, "lib/Hamm_dct_norm"),
        "--STARTFRMEXT=25", "--ENDFRMEXT=25", "--GMMBYPASS=TRUE",
        "-l", str(outdir), "-y", "post"])
    got, _ = htk.read_htk_file(str(outdir / "001.post"))
    # bypass features are sqrt(-2 log p) >= 0 and finite for softmax outputs
    assert (got >= 0).all() and np.isfinite(got).all()


def test_tnorm_stats(mlp_and_data, tmp_path):
    net, mmf, scp, tmp = mlp_and_data
    out = tmp_path / "norm.mmf"
    from nnet_asr_tpu.tools import tnorm
    tnorm.main([
        "tnorm", "-S", scp, "--TARGETMMF=" + str(out),
        "--FEATURETRANSFORM=" + os.path.join(EXAMPLE01, "lib/Hamm_dct_norm"),
        "--STARTFRMEXT=25", "--ENDFRMEXT=25"])
    norm = Network.read(str(out))
    assert [s.tag for s in norm.specs] == ["<bias>", "<window>"]

    # oracle accumulation (with the reference's extended-frame count quirk)
    transform = Network.read(os.path.join(EXAMPLE01, "lib/Hamm_dct_norm"))
    reader = htk.FeatureReader(start_frm_ext=25, end_frm_ext=25)
    from nnet_asr_tpu.io.scp import read_scp
    first = np.zeros(598); second = np.zeros(598); n = 0
    for e in read_scp(scp):
        feats = reader.read(e.physical)
        h = oracle.forward_network(transform, feats)[25:-25].astype(np.float64)
        first += h.sum(0); second += (h * h).sum(0); n += feats.shape[0]
    mean = first / n
    var = second / n - mean * mean
    np.testing.assert_allclose(np.asarray(norm.params[0]["bias"]), -mean,
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(norm.params[1]["window"]),
                               1 / np.sqrt(var), rtol=1e-3, atol=1e-5)


def test_newbob_schedule(tmp_path):
    """Drive newbob with a scripted CV trajectory; check accept/reject/halving."""
    init = tmp_path / "m.init"
    init.write_text("model0")
    cv_of = {"model0": 10.0}
    events = []

    def train_epoch(src, lrate, dst):
        events.append(("train", os.path.basename(src), round(lrate, 6)))
        with open(src) as f:
            gen = int(f.read().replace("model", ""))
        with open(dst, "w") as f:
            f.write(f"model{gen + 1}")
        return 50.0

    # trajectory: +2.0 (accept), +0.3 (accept, start halving),
    # +0.05 (accept, halving continues, stop next loop check)
    traj = [12.0, 12.3, 12.35, 12.36, 12.37]

    def crossvalidate(path):
        with open(path) as f:
            gen = int(f.read().replace("model", ""))
        return 10.0 if gen == 0 else traj[min(gen - 1, len(traj) - 1)]

    cfg = NewbobConfig(learning_rate=0.8, max_iter=10, min_iter=1)
    best, st = run_newbob(cfg, str(init), str(tmp_path / "w"),
                          train_epoch, crossvalidate, log=lambda s: None)
    # iter1 lr 0.8 accept; iter2 lr 0.8 accept + halving on (12.3 < 12+0.5)
    # iter3 lr 0.4; accepted 12.35 < 12.3+0.1 and iter>min → stop
    lrates = [e[2] for e in events]
    assert lrates == [0.8, 0.8, 0.4]
    assert st.accu_best == 12.35
    assert "_cv12.35" in best
    assert os.path.exists(best)


def test_tfeacat_int8_close_to_f32(mlp_and_data):
    """--INT8 posterior dumps stay close to f32 (per-channel weight quant
    + dynamic activation quant, int8 GEMMs)."""
    net, mmf, scp, tmp = mlp_and_data
    from nnet_asr_tpu.tools import tfeacat
    d32, d8 = tmp / "q32", tmp / "q8"
    d32.mkdir(exist_ok=True)
    d8.mkdir(exist_ok=True)
    common = ["tfeacat", "-H", mmf, "-S", scp,
              "--FEATURETRANSFORM=" + os.path.join(EXAMPLE01, "lib/Hamm_dct_norm"),
              "--STARTFRMEXT=25", "--ENDFRMEXT=25", "-y", "post"]
    tfeacat.main(common + ["-l", str(d32)])
    tfeacat.main(common + ["-l", str(d8), "--INT8=TRUE"])
    names = sorted(os.listdir(d32))
    assert names and names == sorted(os.listdir(d8))
    for name in names:
        a, _ = htk.read_htk_file(str(d32 / name))
        b, _ = htk.read_htk_file(str(d8 / name))
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) < 5e-2, np.max(np.abs(a - b))
        assert (a.argmax(1) == b.argmax(1)).mean() > 0.9
