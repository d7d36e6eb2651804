"""End-to-end TMpe tool test on a synthetic mini-task."""

import os

import numpy as np
import pytest

from nnet_asr_tpu.io import htk
from nnet_asr_tpu.io.mlf import MlfWriter
from nnet_asr_tpu.io.slf import Lattice, LatticeArc, LatticeNode, write_slf
from nnet_asr_tpu.models import Network


@pytest.fixture(scope="module")
def mpe_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mpe")
    rng = np.random.default_rng(0)
    n_phones, dim = 3, 8
    phones = ["a", "b", "c"]

    # label map: one emitting state per phone
    (tmp / "phones.map").write_text("\n".join(f"{p}_s2" for p in phones))

    # HMM MMF: 3-state (1 emitting) per phone
    with open(tmp / "hmms.mmf", "w") as f:
        f.write('~o <STREAMINFO> 1 8 <VECSIZE> 8 <USER>\n')
        for p in phones:
            f.write(f'~h "{p}"\n<BEGINHMM>\n<NUMSTATES> 3\n<STATE> 2\n'
                    f'~s "{p}_s2"\n<TRANSP> 3\n'
                    ' 0.0 1.0 0.0\n 0.0 0.7 0.3\n 0.0 0.0 0.0\n<ENDHMM>\n')

    # 6 utterances: each 20 frames = 2 phone segments of 10
    utts = []
    mlf = MlfWriter(str(tmp / "labels.mlf"))
    os.makedirs(tmp / "feats", exist_ok=True)
    os.makedirs(tmp / "lats", exist_ok=True)
    scp_lines = []
    for u in range(6):
        seq = rng.permutation(3)[:2]
        feats = np.zeros((20, dim), np.float32)
        labels = []
        for seg, ph in enumerate(seq):
            # features carry a noisy cue for the phone identity
            feats[seg * 10:(seg + 1) * 10, ph] = 1.5
        feats += 0.2 * rng.standard_normal(feats.shape).astype(np.float32)
        name = f"u{u}"
        htk.write_htk_file(str(tmp / "feats" / f"{name}.fea"), feats,
                           htk.PARMKIND_USER)
        mlf.write_record(f"*/{name}.lab", [
            f"{seg * 10 * 100000} {(seg + 1) * 10 * 100000} {phones[ph]}_s2"
            for seg, ph in enumerate(seq)])
        # denominator lattice: per segment, correct phone + one competitor
        lat = Lattice()
        lat.nodes = [LatticeNode(time=0.0), LatticeNode(time=0.1),
                     LatticeNode(time=0.2)]
        for seg, ph in enumerate(seq):
            comp = (ph + 1) % 3
            lat.arcs.append(LatticeArc(seg, seg + 1, phones[ph], lm=0.0))
            lat.arcs.append(LatticeArc(seg, seg + 1, phones[comp], lm=0.0))
        with open(tmp / "lats" / f"{name}.lat", "w") as f:
            write_slf(lat, f)
        scp_lines.append(str(tmp / "feats" / f"{name}.fea"))
        utts.append((name, feats, seq))
    mlf.close()
    (tmp / "train.scp").write_text("\n".join(scp_lines) + "\n")

    # weak random init MLP dim->16->3
    rng2 = np.random.default_rng(1)
    from nnet_asr_tpu.models import BiasedLinearity, Sigmoid, Softmax
    specs = (BiasedLinearity(dim, 16), Sigmoid(16, 16),
             BiasedLinearity(16, 3), Softmax(3, 3))
    params = [
        {"weight": (0.2 * rng2.standard_normal((dim, 16))).astype(np.float32),
         "bias": np.zeros(16, np.float32)}, {},
        {"weight": (0.2 * rng2.standard_normal((16, 3))).astype(np.float32),
         "bias": np.zeros(3, np.float32)}, {},
    ]
    Network(specs, params).write(str(tmp / "init.mmf"))
    return tmp, utts


def _segment_decision_accuracy(net, utts):
    """Lattice-level criterion: per segment, does the correct phone's
    summed log posterior beat its lattice competitor's?"""
    import oracle
    corr = tot = 0
    for name, feats, seq in utts:
        y = np.log(oracle.forward_network(net, feats) + 1e-30)
        for seg, ph in enumerate(seq):
            comp = (ph + 1) % 3
            sl = slice(seg * 10, (seg + 1) * 10)
            corr += int(y[sl, ph].sum() > y[sl, comp].sum())
            tot += 1
    return corr / tot


def test_tmpe_end_to_end(mpe_setup):
    tmp, utts = mpe_setup
    from nnet_asr_tpu.tools import tmpe

    net0 = Network.read(str(tmp / "init.mmf"))
    acc0 = _segment_decision_accuracy(net0, utts)

    src = str(tmp / "init.mmf")
    for it in range(6):
        dst = str(tmp / f"mpe{it}.mmf")
        tmpe.main([
            "tmpe", "-H", src, "-I", str(tmp / "labels.mlf"),
            "-L", "*/", "-X", "lab",
            "-m", str(tmp / "phones.map"),
            "-S", str(tmp / "train.scp"),
            "--HMM=" + str(tmp / "hmms.mmf"),
            "--LATTICEDIR=" + str(tmp / "lats"),
            "--OUTPSCALE=1.0", "--LEARNINGRATE=2.0",
            "--TARGETMMF=" + dst])
        src = dst

    net1 = Network.read(src)
    acc1 = _segment_decision_accuracy(net1, utts)
    assert acc1 > acc0, (acc0, acc1)
    assert acc1 >= 0.6, (acc0, acc1)


def test_tmpe_crossvalidate(mpe_setup, tmp_path, capsys):
    """-c: evaluates the MPE criterion with pipelined forwards and NO
    update — params must not change, no model written, and the reported
    avg accuracy must match the first training iteration's (both measure
    the same starting model)."""
    tmp, utts = mpe_setup
    from nnet_asr_tpu.tools import tmpe

    common = [
        "-I", str(tmp / "labels.mlf"), "-L", "*/", "-X", "lab",
        "-m", str(tmp / "phones.map"), "-S", str(tmp / "train.scp"),
        "--HMM=" + str(tmp / "hmms.mmf"),
        "--LATTICEDIR=" + str(tmp / "lats"), "--OUTPSCALE=1.0",
    ]
    out = tmp_path / "should_not_exist.mmf"
    rc = tmpe.main(["tmpe", "-c", "-H", str(tmp / "init.mmf"),
                    "--TARGETMMF=" + str(out)] + common)
    assert rc == 0
    assert not out.exists()
    cv_line = [l for l in capsys.readouterr().out.splitlines()
               if l.startswith("Avg MPE accuracy")][0]
    cv_acc = float(cv_line.split()[3])

    # small lookahead exercises the drain loop boundary conditions
    tmpe.main(["tmpe", "-c", "-H", str(tmp / "init.mmf"),
               "--LOOKAHEAD=2"] + common)
    line2 = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("Avg MPE accuracy")][0]
    assert float(line2.split()[3]) == cv_acc

    # training on the same model reports the same criterion (the FB sees
    # identical posteriors; updates happen after each utterance's stats)
    tmpe.main(["tmpe", "-H", str(tmp / "init.mmf"),
               "--LEARNINGRATE=0.0",
               "--TARGETMMF=" + str(tmp_path / "lr0.mmf")] + common)
    line3 = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("Avg MPE accuracy")][0]
    assert abs(float(line3.split()[3]) - cv_acc) < 1e-4

    # multi-process FB pool: identical criterion, all utterances counted
    tmpe.main(["tmpe", "-c", "-H", str(tmp / "init.mmf"),
               "--FBWORKERS=2"] + common)
    line4 = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("Avg MPE accuracy")][0]
    assert float(line4.split()[3]) == cv_acc
    assert int(line4.split()[5]) == 6


def test_tmpe_mesh_matches_single_chip(mpe_setup, tmp_path):
    """--MESH=8x1: the frame-sharded forward/update (sharded_aux) must
    reproduce the single-chip tmpe trajectory on the mini task."""
    tmp, utts = mpe_setup
    from nnet_asr_tpu.tools import tmpe

    common = [
        "-I", str(tmp / "labels.mlf"), "-L", "*/", "-X", "lab",
        "-m", str(tmp / "phones.map"), "-S", str(tmp / "train.scp"),
        "--HMM=" + str(tmp / "hmms.mmf"),
        "--LATTICEDIR=" + str(tmp / "lats"),
        "--OUTPSCALE=1.0", "--LEARNINGRATE=2.0",
    ]
    out_sc = tmp_path / "sc.mmf"
    tmpe.main(["tmpe", "-H", str(tmp / "init.mmf"),
               "--TARGETMMF=" + str(out_sc)] + common)
    out_mesh = tmp_path / "mesh.mmf"
    tmpe.main(["tmpe", "-H", str(tmp / "init.mmf"), "--MESH=8x1",
               "--TARGETMMF=" + str(out_mesh)] + common)
    a = Network.read(str(out_sc))
    b = Network.read(str(out_mesh))
    for pa, pb in zip(a.params, b.params):
        for k in pa:
            np.testing.assert_allclose(pb[k], pa[k], rtol=2e-4, atol=1e-6)


def test_tmpe_pruning_and_retry_loop(mpe_setup, monkeypatch, capsys):
    """-t beam inc max: the widen-and-retry loop of TMpeCu.cc:587-609.
    Force the first two compute() calls to underflow and check the tool
    retries with successively wider beams, then succeeds."""
    tmp, utts = mpe_setup
    from nnet_asr_tpu.tools import tmpe
    from nnet_asr_tpu.train import mpe as mpe_mod

    seen = []
    real_compute = mpe_mod.MpeComputer.compute

    def flaky(self, lat, log_post, ref, utt_weight=1.0, frame_weights=None,
              pruning=None):
        seen.append(pruning)
        if len(seen) <= 2:
            raise FloatingPointError("forced underflow")
        return real_compute(self, lat, log_post, ref, utt_weight,
                            frame_weights, pruning)

    monkeypatch.setattr(mpe_mod.MpeComputer, "compute", flaky)
    tmpe.main([
        "tmpe", "-H", str(tmp / "init.mmf"), "-I", str(tmp / "labels.mlf"),
        "-L", "*/", "-X", "lab",
        "-m", str(tmp / "phones.map"),
        "-t", "100", "50", "250",
        "-S", str(tmp / "train.scp"),
        "--HMM=" + str(tmp / "hmms.mmf"),
        "--LATTICEDIR=" + str(tmp / "lats"),
        "--TARGETMMF=" + str(tmp / "prune.mmf")])
    assert seen[:3] == [100.0, 150.0, 200.0]
    # remaining utterances go through at the base beam again
    assert all(p == 100.0 for p in seen[3:])
    err = capsys.readouterr().err
    assert "trying pruning threshold: 150" in err


def test_tmpe_retry_exhaustion_skips_file(mpe_setup, monkeypatch, capsys):
    """When the beam reaches PRUNINGMAX the utterance is skipped, not fatal."""
    tmp, utts = mpe_setup
    from nnet_asr_tpu.tools import tmpe
    from nnet_asr_tpu.train import mpe as mpe_mod

    calls = {"n": 0}
    real_compute = mpe_mod.MpeComputer.compute

    def first_utt_fails(self, lat, log_post, ref, utt_weight=1.0,
                        frame_weights=None, pruning=None):
        calls["n"] += 1
        if calls["n"] <= 2:       # base beam + one widening for utt 1
            raise FloatingPointError("forced underflow")
        return real_compute(self, lat, log_post, ref, utt_weight,
                            frame_weights, pruning)

    monkeypatch.setattr(mpe_mod.MpeComputer, "compute", first_utt_fails)
    rc = tmpe.main([
        "tmpe", "-H", str(tmp / "init.mmf"), "-I", str(tmp / "labels.mlf"),
        "-L", "*/", "-X", "lab",
        "-m", str(tmp / "phones.map"),
        "-t", "100", "50", "150",
        "-S", str(tmp / "train.scp"),
        "--HMM=" + str(tmp / "hmms.mmf"),
        "--LATTICEDIR=" + str(tmp / "lats"),
        "--TARGETMMF=" + str(tmp / "prune2.mmf")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "skipping file" in err


def test_tmpe_mmi_mode(mpe_setup):
    """--MMI=TRUE (the TMmiCu restoration) also improves decisions."""
    tmp, utts = mpe_setup
    from nnet_asr_tpu.tools import tmpe

    acc0 = _segment_decision_accuracy(Network.read(str(tmp / "init.mmf")), utts)
    src = str(tmp / "init.mmf")
    for it in range(4):
        dst = str(tmp / f"mmi{it}.mmf")
        tmpe.main([
            "tmpe", "-H", src, "-I", str(tmp / "labels.mlf"),
            "-L", "*/", "-X", "lab",
            "-m", str(tmp / "phones.map"),
            "-S", str(tmp / "train.scp"),
            "--HMM=" + str(tmp / "hmms.mmf"),
            "--LATTICEDIR=" + str(tmp / "lats"),
            "--MMI=TRUE", "--LEARNINGRATE=1.0",
            "--TARGETMMF=" + dst])
        src = dst
    acc1 = _segment_decision_accuracy(Network.read(src), utts)
    assert acc1 > acc0, (acc0, acc1)


def test_tmpe_word_lattices_with_dictionary(mpe_setup, tmp_path):
    """The tmpe TOOL on WORD lattices + --SOURCEDICT: with words mapping
    1:1 to phones the updated model must be byte-identical to the run on
    the pre-expanded phone lattices (the expansion path end-to-end)."""
    tmp, utts = mpe_setup
    import os

    from nnet_asr_tpu.io.slf import read_slf, write_slf
    from nnet_asr_tpu.tools import tmpe

    # derive word lattices (phone 'a' -> word 'A', ...) + dictionary
    words_dir = tmp_path / "wordlats"
    words_dir.mkdir()
    for name in os.listdir(tmp / "lats"):
        lat = read_slf(str(tmp / "lats" / name))
        for a in lat.arcs:
            a.word = a.word.upper()
        with open(words_dir / name, "w") as f:
            write_slf(lat, f)
    dict_file = tmp_path / "words.dic"
    dict_file.write_text("A a\nB b\nC c\n")

    common = [
        "-I", str(tmp / "labels.mlf"), "-L", "*/", "-X", "lab",
        "-m", str(tmp / "phones.map"), "-S", str(tmp / "train.scp"),
        "--HMM=" + str(tmp / "hmms.mmf"),
        "--OUTPSCALE=1.0", "--LEARNINGRATE=2.0",
    ]
    out_phone = tmp_path / "phone.mmf"
    tmpe.main(["tmpe", "-H", str(tmp / "init.mmf"),
               "--LATTICEDIR=" + str(tmp / "lats"),
               "--TARGETMMF=" + str(out_phone)] + common)
    out_word = tmp_path / "word.mmf"
    tmpe.main(["tmpe", "-H", str(tmp / "init.mmf"),
               "--LATTICEDIR=" + str(words_dir),
               "--SOURCEDICT=" + str(dict_file),
               "--TARGETMMF=" + str(out_word)] + common)
    assert out_word.read_text() == out_phone.read_text()


def test_tmpe_exact_segmentation_flag(mpe_setup, tmp_path):
    """--EXACTSEGMENTATION through the CLI: single-phone words have no
    internal boundaries, so exact mode must be byte-identical to MAP mode
    (and to the pre-expanded phone-lattice run)."""
    tmp, utts = mpe_setup
    import os

    from nnet_asr_tpu.io.slf import read_slf, write_slf
    from nnet_asr_tpu.tools import tmpe

    words_dir = tmp_path / "wordlats"
    words_dir.mkdir()
    for name in os.listdir(tmp / "lats"):
        lat = read_slf(str(tmp / "lats" / name))
        for a in lat.arcs:
            a.word = a.word.upper()
        with open(words_dir / name, "w") as f:
            write_slf(lat, f)
    dict_file = tmp_path / "words.dic"
    dict_file.write_text("A a\nB b\nC c\n")

    common = [
        "-I", str(tmp / "labels.mlf"), "-L", "*/", "-X", "lab",
        "-m", str(tmp / "phones.map"), "-S", str(tmp / "train.scp"),
        "--HMM=" + str(tmp / "hmms.mmf"),
        "--OUTPSCALE=1.0", "--LEARNINGRATE=2.0",
        "--LATTICEDIR=" + str(words_dir),
        "--SOURCEDICT=" + str(dict_file),
    ]
    out_map = tmp_path / "map.mmf"
    tmpe.main(["tmpe", "-H", str(tmp / "init.mmf"),
               "--TARGETMMF=" + str(out_map)] + common)
    out_exact = tmp_path / "exact.mmf"
    tmpe.main(["tmpe", "-H", str(tmp / "init.mmf"),
               "--EXACTSEGMENTATION=TRUE",
               "--TARGETMMF=" + str(out_exact)] + common)
    assert out_exact.read_text() == out_map.read_text()


def test_tmpe_delayed_update(mpe_setup, tmp_path, capsys):
    """--DELAYEDUPDATE (one-utterance-stale gradients):
    trains to a finite model whose first-iteration criterion matches the
    sequential path exactly (the criterion is measured on the pre-update
    forward of each utterance, which at staleness one differs only from
    utterance 2 on — tiny on the mini task), and the criterion still
    improves over an untrained pass."""
    tmp, utts = mpe_setup
    from nnet_asr_tpu.tools import tmpe

    common = [
        "-I", str(tmp / "labels.mlf"), "-L", "*/", "-X", "lab",
        "-m", str(tmp / "phones.map"), "-S", str(tmp / "train.scp"),
        "--HMM=" + str(tmp / "hmms.mmf"),
        "--LATTICEDIR=" + str(tmp / "lats"), "--OUTPSCALE=1.0",
        "--LEARNINGRATE=2.0",
    ]

    def run(extra, out):
        rc = tmpe.main(["tmpe", "-H", str(tmp / "init.mmf"),
                        "--TARGETMMF=" + str(out)] + extra + common)
        assert rc == 0
        line = [l for l in capsys.readouterr().out.splitlines()
                if l.startswith("Avg MPE accuracy")][0]
        return float(line.split()[3])

    acc_seq = run([], tmp_path / "seq.mmf")
    acc_del = run(["--DELAYEDUPDATE=TRUE"], tmp_path / "del.mmf")
    # same start model: per-utterance forwards see at most one stale
    # update; criterion must be close but the trained model may differ
    assert abs(acc_del - acc_seq) < 0.2, (acc_del, acc_seq)
    assert (tmp_path / "del.mmf").exists()

    # deterministic: rerunning the delayed path reproduces its criterion
    acc2 = run(["--DELAYEDUPDATE=TRUE"], tmp_path / "del2.mmf")
    assert acc2 == acc_del
