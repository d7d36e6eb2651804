#!/usr/bin/env python3
"""Synthesize a TIMIT-SCALE corpus for the example-02 recipe.

The reference's second golden test trains on TIMIT: 4620 train utterances,
~1.1M frames of 23-band FBANK at 10ms, 39 folded phones with 1-state HMMs
(examples/02train_MLP3_newbob_timit/README:33-39, prepare_timit/
prepare_timit.sh). The audio is not shipped in either repo, so scale
behavior (resident HBM bound, streaming crossover, cache arithmetic at
1M+ frames) was unexercised. This script synthesizes a corpus with TIMIT's
exact *shape* — utterance count, frame count, feature dimensionality,
phone inventory, duration statistics — that is also LEARNABLE, so the full
recipe (tjoiner → tnorm → newbob → decode) produces meaningful accuracy:

  * 39 phones (the Lee/Hon folded TIMIT set), 1-state labels;
  * per-phone 23-dim log-filterbank prototypes drawn from a LOW-RANK
    (rank-6) spectral basis, so phones share structure and some pairs are
    genuinely confusable (TIMIT-like frame accuracy, not a toy 99%),
    with smooth within-phone trajectories + observation noise;
  * phone durations ~ TIMIT-ish lognormal (median ~7 frames @10ms);
  * ~240 frames per utterance → 4620 utts ≈ 1.11M train frames.

Output layout matches prepare_example02.py / prepare_timit.sh:
workdir/{lists/{train_fea.scp,cv_fea.scp},mlfs/ref.mlf,dicts/phones} +
the feature files under workdir/fea/.

Usage: prepare_timit_scale.py <workdir> [--train-utts=4620] [--cv-utts=200]
"""

import argparse
import os
import sys

import numpy as np

# Lee & Hon folded TIMIT phone inventory (39)
PHONES = (
    "aa ae ah aw ay b ch d dh dx eh er ey f g hh ih iy jh k l m n ng ow oy "
    "p r s sh sil t th uw uh v w y z").split()


def synth_utterance(rng, proto, n_frames_target):
    """One utterance: phone walk + smooth prototype trajectories + noise."""
    n_ph = len(PHONES)
    labels = []
    segs = []          # (start, end, phone_idx) in frames
    t = 0
    prev = PHONES.index("sil")
    segs.append((0, 3, prev))
    labels += [prev] * 3
    t = 3
    while t < n_frames_target - 3:
        ph = int(rng.integers(0, n_ph))
        dur = int(np.clip(np.round(rng.lognormal(np.log(7.0), 0.45)), 3, 25))
        dur = min(dur, n_frames_target - 3 - t)
        if dur <= 0:
            break
        segs.append((t, t + dur, ph))
        labels += [ph] * dur
        t += dur
    segs.append((t, t + 3, PHONES.index("sil")))
    labels += [PHONES.index("sil")] * 3
    t += 3

    lab = np.asarray(labels, np.int32)
    feats = proto[lab]                                   # (T, 23)
    # smooth trajectory: mix each frame with its segment-neighbors (a cheap
    # coarticulation stand-in) + observation noise
    kernel = np.array([0.2, 0.6, 0.2], np.float32)
    pad = np.pad(feats, ((1, 1), (0, 0)), mode="edge")
    feats = (kernel[0] * pad[:-2] + kernel[1] * pad[1:-1]
             + kernel[2] * pad[2:])
    feats = feats + 2.0 * rng.standard_normal(feats.shape).astype(np.float32)
    return feats.astype(np.float32), segs, lab


def main(argv=None) -> int:
    from nnet_asr_tpu.io import htk

    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--train-utts", type=int, default=4620)
    ap.add_argument("--cv-utts", type=int, default=200)
    ap.add_argument("--mean-frames", type=int, default=240)
    ap.add_argument("--seed", type=int, default=20260819)
    args = ap.parse_args(argv)

    w = args.workdir
    for sub in ("lists", "mlfs", "dicts", "fea"):
        os.makedirs(os.path.join(w, sub), exist_ok=True)

    rng = np.random.default_rng(args.seed)
    # per-phone prototypes in a rank-6 spectral basis: phones share
    # structure, some pairs nearly collide — the classifier has real
    # confusions to resolve instead of 39 well-separated Gaussians
    basis = rng.standard_normal((6, 23))
    coef = rng.standard_normal((len(PHONES), 6))
    proto = (1.1 * (coef @ basis) / np.sqrt(6)).astype(np.float32)

    n_total = args.train_utts + args.cv_utts
    scps = {"train": [], "cv": []}
    total_frames = {"train": 0, "cv": 0}
    mlf_path = os.path.join(w, "mlfs/ref.mlf")
    with open(mlf_path, "w") as mlf:
        mlf.write("#!MLF!#\n")
        for u in range(n_total):
            split = "train" if u < args.train_utts else "cv"
            T = int(np.clip(rng.normal(args.mean_frames, 60), 80, 460))
            feats, segs, lab = synth_utterance(rng, proto, T)
            name = f"t{u:05d}"
            fp = os.path.join(w, "fea", name + ".fea")
            htk.write_htk_file(fp, feats, htk.PARMKIND_FBANK)
            scps[split].append(fp)
            total_frames[split] += feats.shape[0]
            mlf.write(f'"*/{name}.lab"\n')
            for st, en, ph in segs:
                # 10ms frames -> HTK 100ns units
                mlf.write(f"{st * 100000} {en * 100000} {PHONES[ph]}\n")
            mlf.write(".\n")
            if (u + 1) % 500 == 0:
                print(f"  {u + 1}/{n_total} utterances", flush=True)

    with open(os.path.join(w, "lists/train_fea.scp"), "w") as f:
        f.write("\n".join(scps["train"]) + "\n")
    with open(os.path.join(w, "lists/cv_fea.scp"), "w") as f:
        f.write("\n".join(scps["cv"]) + "\n")
    with open(os.path.join(w, "dicts/phones"), "w") as f:
        f.write("\n".join(PHONES) + "\n")
    print(f"prepared {args.train_utts} train utts ({total_frames['train']} "
          f"frames) + {args.cv_utts} cv utts ({total_frames['cv']} frames), "
          f"{len(PHONES)} phones -> {w}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
