#!/usr/bin/env python3
"""Prepare the example-02/TIMIT recipe workdir from REAL AUDIO (the one
pipeline stage that previously required HTK's HCopy).

Mirrors examples/02train_MLP3_newbob_timit/prepare_timit/ end to end,
natively:

  * audio → 23-band FBANK features via the native front end
    (nnet_asr_tpu.ops.mfcc — the hcopy23mel_16k_0.sh configuration:
    USEPOWER, Hamming, PREEMCOEF=0, 25ms/10ms, LOFREQ 0, HIFREQ 8000);
  * TIMIT .phn labels → the reference's folded 39-phone set
    (timit2our39.sh's HLEd script re-implemented: closure+stop merges,
    q deletion, the RE mappings, adjacent-duplicate collapse);
  * workdir layout identical to prepare_timit_scale.py / prepare_timit.sh
    (fea/*.fea, mlfs/ref.mlf, lists/{train,cv}_fea.scp, dicts/phones), so
    examples/run_timit_scale.sh stages 2-5 run unchanged on real data
    (set NNET_TS_WAV_DIR to use this instead of the synthetic corpus).

Audio containers (dispatched by magic bytes, not extension): RIFF WAV,
NIST SPHERE (what real TIMIT discs ship, usually named ``.wav`` —
replaces prepare_timit.sh:26's ``sox -t .sph`` stage), or headerless
PCM16 (.raw, VAX order, SOURCERATE=625) at 16 kHz. Labels:
``<name>.phn`` (TIMIT sample-indexed triples) or ``<name>.lab`` (HTK
100ns ticks) next to each audio file, case-insensitive (TIMIT discs are
often upper-case: SA1.WAV/SA1.PHN). A real TIMIT tree
(TEST/DR1/FCJF0/SA1.wav) gets reference naming ``<spk>_<base>``
(prepare_timit.sh:23-26) and the dialect sentences sa1/sa2 are excluded
as the reference's list stage does (prepare_timit.sh:58-59; keep them
with --include-sa).

``--toy N`` synthesizes a small wav corpus (per-phone tone mixtures +
noise over a 12-phone set) so the wav→features→train→decode path is
exercisable with no external data at all.

Usage:
  prepare_from_wav.py <audio_dir> <workdir> [--cv-frac=0.1]
  prepare_from_wav.py --toy 60 <workdir>
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from nnet_asr_tpu.io.htk import write_htk_file
from nnet_asr_tpu.io.mlf import MlfWriter
from nnet_asr_tpu.io.wav import read_audio_auto, write_wav
from nnet_asr_tpu.ops.mfcc import Frontend, FrontendConfig

# timit2our39.sh re-implemented (HLEd ME/RE/DE commands): closures merge
# into a following stop, else fold to the stop; then the RE renames; 'q'
# is deleted; adjacent duplicates collapse.
CLOSURES = {"bcl": "b", "dcl": "d", "gcl": "g",
            "kcl": "k", "pcl": "p", "tcl": "t"}
STOPS = set("bdgkpt")
RENAME = {"nx": "n", "ao": "aa", "ax": "ah", "ix": "ih", "em": "m",
          "en": "n", "eng": "ng", "zh": "sh", "h#": "pau", "epi": "pau",
          "hv": "hh", "ux": "uw", "axr": "er", "ax-h": "ah", "el": "l"}
DELETE = {"q"}


def fold_labels(segs):
    """[(t0, t1, phone)] raw TIMIT → folded 39-set with merges."""
    out = []
    i = 0
    while i < len(segs):
        t0, t1, ph = segs[i]
        if ph in DELETE:
            i += 1
            continue
        if ph in CLOSURES:
            nxt = segs[i + 1] if i + 1 < len(segs) else None
            if nxt is not None and nxt[2] == CLOSURES[ph]:
                # ME: closure + its stop merge into one segment
                out.append((t0, nxt[1], CLOSURES[ph]))
                i += 2
                continue
            ph = CLOSURES[ph]          # RE: bare closure -> the stop
        ph = RENAME.get(ph, ph)
        out.append((t0, t1, ph))
        i += 1
    # adjacent-duplicate collapse (the repeated 'ME x x x' loop)
    merged = []
    for t0, t1, ph in out:
        if merged and merged[-1][2] == ph:
            merged[-1] = (merged[-1][0], t1, ph)
        else:
            merged.append((t0, t1, ph))
    return merged


def read_phn(path, sample_period=625.0):
    """TIMIT .phn: 'start_sample end_sample phone' → 100ns-tick segs."""
    segs = []
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) != 3:
                continue
            s, e, ph = int(parts[0]), int(parts[1]), parts[2].lower()
            segs.append((int(round(s * sample_period)),
                         int(round(e * sample_period)), ph))
    return segs


def read_lab(path):
    segs = []
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) >= 3:
                segs.append((int(parts[0]), int(parts[1]), parts[2]))
    return segs


def fbank23_frontend():
    return Frontend(FrontendConfig(
        target_kind="FBANK", numchans=23, use_power=True,
        use_hamming=True, preemcoef=0.0, lofreq=0, hifreq=8000,
        source_rate=625.0, target_rate=100000.0, window_size=250000.0))


# ---------------------------------------------------------------------------
# toy corpus: tone-mixture "phones" over real wav files
# ---------------------------------------------------------------------------

TOY_PHONES = "sil aa iy uw m n s sh t k l r".split()


def synth_toy_wav(rng, n_phones, fs=16000):
    """A random phone sequence rendered as tone mixtures + noise."""
    segs = []
    audio = []
    t = 0
    freqs = {ph: (250 + 310 * i, 900 + 520 * i)
             for i, ph in enumerate(TOY_PHONES)}
    seq = ["sil"] + list(rng.choice(TOY_PHONES[1:], n_phones)) + ["sil"]
    for ph in seq:
        dur = int(fs * rng.uniform(0.06, 0.18))
        tt = np.arange(dur) / fs
        f1, f2 = freqs[ph]
        if ph == "sil":
            sig = 0.02 * rng.standard_normal(dur)
        else:
            sig = (0.4 * np.sin(2 * np.pi * f1 * tt + rng.uniform(0, 6))
                   + 0.3 * np.sin(2 * np.pi * f2 * tt + rng.uniform(0, 6))
                   + 0.05 * rng.standard_normal(dur))
        audio.append(sig)
        segs.append((t, t + dur, ph))
        t += dur
    wav = np.concatenate(audio)
    wav = (wav / np.abs(wav).max() * 12000).astype(np.int16)
    # sample-indexed segs (like .phn)
    return wav, segs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("audio_dir", nargs="?")
    ap.add_argument("workdir")
    ap.add_argument("--toy", type=int, default=0,
                    help="synthesize N toy wav utterances instead")
    ap.add_argument("--cv-frac", type=float, default=0.1)
    ap.add_argument("--include-sa", action="store_true",
                    help="keep TIMIT sa1/sa2 dialect sentences "
                         "(reference drops them)")
    ap.add_argument("--seed", type=int, default=999)
    args = ap.parse_args(argv)

    w = args.workdir
    for d in ("fea", "mlfs", "lists", "dicts", "wav"):
        os.makedirs(os.path.join(w, d), exist_ok=True)

    utts = []          # (name, wav_path, segs_100ns)
    if args.toy:
        rng = np.random.default_rng(args.seed)
        for i in range(args.toy):
            wav, segs = synth_toy_wav(rng, int(rng.integers(4, 10)))
            name = f"toy{i:04d}"
            path = os.path.join(w, "wav", name + ".wav")
            write_wav(path, wav, 16000)
            utts.append((name, path,
                         [(int(round(s * 625)), int(round(e * 625)), ph)
                          for s, e, ph in segs]))
        print(f"synthesized {len(utts)} toy wav utterances")
    else:
        if not args.audio_dir:
            ap.error("audio_dir required without --toy")
        seen = {}
        for root, _, files in os.walk(args.audio_dir):
            lower = {f.lower(): f for f in files}
            for fn in sorted(files):
                base, ext = os.path.splitext(fn)
                if ext.lower() not in (".wav", ".raw", ".sph"):
                    continue
                # in-place-converted trees keep SA1.sph next to SA1.wav;
                # prefer the .wav rather than hard-failing on collision
                if (ext.lower() == ".sph"
                        and (base.lower() + ".wav") in lower):
                    continue
                # sa1/sa2 are TIMIT's dialect-calibration sentences; the
                # reference's list stage drops them (prepare_timit.sh:58)
                if base.lower() in ("sa1", "sa2") and not args.include_sa:
                    continue
                # labels live next to the audio, any case (SA1.PHN)
                lab = None
                for lext, rd in ((".phn", read_phn), (".lab", read_lab)):
                    cand = lower.get(base.lower() + lext)
                    if cand is not None:
                        lab = os.path.join(root, cand)
                        segs = fold_labels(rd(lab))
                        break
                if lab is None:
                    print(f"skipping {fn}: no .phn/.lab labels",
                          file=sys.stderr)
                    continue
                # TIMIT-tree naming: <speaker>_<sentence>, the reference's
                # unique-name scheme (prepare_timit.sh:23-26); flat dirs
                # keep the bare stem
                rel = os.path.relpath(root, args.audio_dir)
                name = (base if rel == os.curdir
                        else f"{os.path.basename(root)}_{base}").lower()
                if name in seen:
                    raise SystemExit(
                        f"utterance name collision: {name} from "
                        f"{os.path.join(root, fn)} and {seen[name]}")
                seen[name] = os.path.join(root, fn)
                utts.append((name, os.path.join(root, fn), segs))
        if not utts:
            raise SystemExit(f"no labelled audio under {args.audio_dir}")
        print(f"found {len(utts)} labelled utterances")

    fe = fbank23_frontend()
    mlf = MlfWriter(os.path.join(w, "mlfs", "ref.mlf"))
    phones = set()
    names = []
    total = 0
    for name, path, segs in utts:
        samples, rate = read_audio_auto(path, rate_hint=16000)
        if rate != 16000:
            raise SystemExit(f"{path}: expected 16kHz, got {rate}")
        feats = fe.extract(samples)
        # clamp the last segment to the feature length (the reference's
        # mlf-fix-endduration awk step)
        n_ticks = feats.shape[0] * 100000
        segs = [(min(s, n_ticks), min(e, n_ticks), ph)
                for s, e, ph in segs if s < n_ticks]
        if segs:
            s0, _, ph0 = segs[-1]
            segs[-1] = (s0, n_ticks, ph0)
        write_htk_file(os.path.join(w, "fea", name + ".fea"), feats,
                       fe.kind, fe.sample_period)
        mlf.write_record(f"*/{name}.lab",
                         [f"{s} {e} {ph}" for s, e, ph in segs])
        phones.update(ph for _, _, ph in segs)
        names.append(name)
        total += feats.shape[0]
    mlf.close()

    n_cv = max(1, int(round(len(names) * args.cv_frac)))
    cv = set(names[-n_cv:])
    with open(os.path.join(w, "lists", "train_fea.scp"), "w") as f:
        f.writelines(os.path.join(w, "fea", n + ".fea") + "\n"
                     for n in names if n not in cv)
    with open(os.path.join(w, "lists", "cv_fea.scp"), "w") as f:
        f.writelines(os.path.join(w, "fea", n + ".fea") + "\n"
                     for n in sorted(cv))
    with open(os.path.join(w, "dicts", "phones"), "w") as f:
        f.writelines(p + "\n" for p in sorted(phones))
    print(f"workdir ready: {len(names)} utts, {total} frames, "
          f"{len(phones)} phones")
    return 0


if __name__ == "__main__":
    sys.exit(main())
