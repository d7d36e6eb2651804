#!/bin/bash
# MPE sequence training at TIMIT corpus scale: SVite
# denominator lattices (-z lat) over the full 4620-utterance synthetic
# corpus, then tools.tmpe epochs with the prefetch-pipelined loop, plus a
# tmpe -c criterion evaluation per iteration.
#
# Mirrors the reference sequence-training workflow (TMpeCu.cc:461-672 main
# loop; lattices from the STK decoder like scripts/mpe_example01.sh) at the
# scale the reference's TIMIT recipe targets.
#
# Prereq: examples/run_timit_scale.sh ran to completion in the workdir
# (trained CE model + decode dir with phoneloop/gmmbypass).
#
# Usage: mpe_timit_scale.sh [workdir] [iters] [n_utts]
#   NNET_GPU=1      run tmpe on the GPU (default: forced CPU)
#   NNET=...        override the source CE model
#   OUTPSCALE=, LEARNRATE= override MPE hyperparameters
set -e -o pipefail

REPO=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH=$REPO
# CPU unless NNET_GPU=1 asks for the GPU
if [ "${NNET_GPU:-}" = "1" ]; then export JAX_PLATFORMS=cuda; else export JAX_PLATFORMS=cpu; fi
W=${1:-/tmp/timit_scale}
ITERS=${2:-4}
N=${3:-0}           # 0 = all train utterances
STK=${STK:-/tmp/stk}
D=$W/decode
M=$W/mpe
FRM_EXT=15
mkdir -p $M

STK=$STK bash "$REPO/scripts/build_stk.sh"

NNET=${NNET:-$(ls -t $W/weights/*final* 2>/dev/null | head -1)}
[ -n "$NNET" ] || { echo "no trained model in $W/weights — run run_timit_scale.sh first"; exit 1; }
FEATURE_TRANSFORM=$(ls $W/tr_*.transf | head -1)
PHONES=$W/workdir/dicts/phones
echo "CE model: $NNET"

if [ "$N" = "0" ]; then
  cp $W/workdir/lists/train_fea.scp $M/raw.scp
  cp $W/train_fea_tjoiner${FRM_EXT}.scp $M/train.scp
else
  head -$N $W/workdir/lists/train_fea.scp > $M/raw.scp
  head -$N $W/train_fea_tjoiner${FRM_EXT}.scp > $M/train.scp
fi

echo "=== stage 1: train-set GMM-bypass posteriors (CE model) ==="
if [ ! -f $M/posteriors.scp ]; then
  mkdir -p $M/posteriors
  python -m nnet_asr_tpu.tools.tfeacat \
    -S $M/raw.scp -H "$NNET" -l $M/posteriors -y htk_post \
    --FEATURETRANSFORM=$FEATURE_TRANSFORM --GMMBYPASS=true \
    --START-FRM-EXT=$FRM_EXT --END-FRM-EXT=$FRM_EXT
  ls $M/posteriors/* > $M/posteriors.scp
fi

echo "=== stage 2: denominator lattices (SVite -z lat) ==="
if [ ! -f $M/den_lats.mlf ]; then
  time $STK/SVite -T 0 -w $D/phoneloop.net -S $M/posteriors.scp \
    -p ${PENALTY:--3} \
    -H $D/HTK_gmmbypass.mmf -i $M/den_lats.mlf -l $M -y rec -P HTK \
    -z lat -q JWtval -t ${LATBEAM:-60.0} --HTKCOMPAT=TRUE $D/dict $PHONES
fi
echo "lattice archive: $(du -h $M/den_lats.mlf | cut -f1)"

TMPE_COMMON=(-I $W/workdir/mlfs/ref.mlf -L '*/' -X lab -m $PHONES
  -S $M/train.scp --HMM=$D/HTK_gmmbypass.mmf --LATTICEDIR=$M/den_lats.mlf
  --FEATURETRANSFORM=$FEATURE_TRANSFORM
  --STARTFRMEXT=$FRM_EXT --ENDFRMEXT=$FRM_EXT
  --OUTPSCALE=${OUTPSCALE:-0.3})

echo "=== stage 3: MPE iterations (criterion via tmpe -c) ==="
src=$NNET
for it in $(seq $ITERS); do
  dst=$M/mpe_iter$it.mmf
  time python -m nnet_asr_tpu.tools.tmpe \
    -H $src "${TMPE_COMMON[@]}" \
    --LEARNINGRATE=${LEARNRATE:-0.02} --TARGETMMF=$dst \
    | grep -E "Avg MPE|T-read|FINISHED"
  src=$dst
done

echo "=== stage 4: final criterion (crossvalidation pass) ==="
python -m nnet_asr_tpu.tools.tmpe -c -H $src "${TMPE_COMMON[@]}" \
  | grep -E "Avg MPE|T-read|FINISHED"

echo "MPE-trained model: $src"
if [ "${SKIP_DECODE:-}" != "1" ]; then
  echo "=== stage 5: decode delta vs the CE model ==="
  bash $REPO/scripts/decode_example02.sh "$src" $W
fi
