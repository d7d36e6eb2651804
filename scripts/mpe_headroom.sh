#!/bin/bash
# MPE decode-win experiment: give the sequence criterion
# HEADROOM and show it converts to a decode improvement.
#
# Round-4 finding: at TIMIT scale the CE 368:500:39 model sits at its
# ~86% frame-accuracy ceiling on the synthetic corpus, so MPE moved the
# criterion (+37.7/4 iters) but not decode.  This experiment
# capacity-limits the CE model (HIDDEN=64 by default) so it decodes well
# below that ceiling, regenerates denominator lattices FROM THAT model,
# and runs MPE iterations with a per-iteration decode — the reference
# tool's purpose (TMpeCu.cc:461-672 exists to improve WER, not the
# criterion).
#
# Prereq: examples/run_timit_scale.sh completed in $SRC (features +
# transform + decode assets).
#
# Usage: mpe_headroom.sh [src_workdir] [exp_workdir] [iters]
#   HIDDEN=64         capacity of the headroom CE model
#   LEARNRATE=0.002   MPE learning rate
#   OUTPSCALE=0.3     kappa
#   REGEN=1           regenerate lattices+posteriors after every iter
#   FRESH_LATS=1      force regenerating the stage-3 lattices from CE
#   TMPE_EXTRA="..."  extra tmpe flags (e.g. --MODELPENALTY=-0.9 to
#                     mirror the decoder's -p insertion penalty at
#                     kappa: MPE on penalty-free phone-loop lattices
#                     otherwise optimizes an operating point the decode
#                     penalty then punishes — insertions climb)
#   MAX_ITER=8        newbob cap for the CE stage
set -e -o pipefail

REPO=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH=$REPO
export JAX_PLATFORMS=cpu
SRC=${1:-/tmp/timit_scale}
W=${2:-/tmp/timit_small}
ITERS=${3:-6}
HIDDEN=${HIDDEN:-64}
STK=${STK:-/tmp/stk}
FRM_EXT=15

STK=$STK bash "$REPO/scripts/build_stk.sh"

mkdir -p $W
[ -e $W/workdir ] || ln -s $SRC/workdir $W/workdir
cp -n $SRC/train_fea_tjoiner${FRM_EXT}.scp $W/ 2>/dev/null || true
for f in $SRC/tr_*.transf $SRC/tr_*[!f].norm; do cp -n "$f" $W/ 2>/dev/null || true; done
# decode assets are model-independent (dict/phone loop/bypass MMF)
FEATURE_TRANSFORM=$(ls $W/tr_*.transf | head -1)
PHONES=$W/workdir/dicts/phones
NPHONES=$(wc -l < $PHONES)
D=$W/decode
mkdir -p $D
sed 's/.*/& &/' $PHONES > $D/dict
python -m nnet_asr_tpu.tools.gen_phone_loop $PHONES $D/phoneloop.net
python -m nnet_asr_tpu.tools.gen_gmmbypass $PHONES $D/HTK_gmmbypass.mmf

decode_model () {  # $1=mmf $2=tag -> prints "tag %Corr %Acc"
  local mmf=$1 tag=$2 pd=$W/post_$2
  mkdir -p $pd
  python -m nnet_asr_tpu.tools.tfeacat \
    -S $W/workdir/lists/cv_fea.scp -H "$mmf" -l $pd -y htk_post \
    --FEATURETRANSFORM=$FEATURE_TRANSFORM --GMMBYPASS=true \
    --START-FRM-EXT=$FRM_EXT --END-FRM-EXT=$FRM_EXT >/dev/null
  ls $pd/* > $pd.scp
  $STK/SVite -T 0 -w $D/phoneloop.net -S $pd.scp -p ${PENALTY:--3} \
    -H $D/HTK_gmmbypass.mmf -i $W/hyp_$tag.mlf -l '*' -y rec -P HTK \
    --HTKCOMPAT=TRUE $D/dict $PHONES >/dev/null
  python -m nnet_asr_tpu.tools.sresults \
    -I $W/workdir/mlfs/ref.mlf $PHONES $W/hyp_$tag.mlf \
    | grep "Corr=" | sed "s/^/[$tag] /"
  rm -rf $pd $pd.scp
}

gen_lattices () {  # $1=mmf  (train-set posteriors + SVite -z lat)
  rm -rf $W/mpe/posteriors $W/mpe/den_lats.mlf
  mkdir -p $W/mpe/posteriors
  python -m nnet_asr_tpu.tools.tfeacat \
    -S $W/workdir/lists/train_fea.scp -H "$1" -l $W/mpe/posteriors \
    -y htk_post --FEATURETRANSFORM=$FEATURE_TRANSFORM --GMMBYPASS=true \
    --START-FRM-EXT=$FRM_EXT --END-FRM-EXT=$FRM_EXT >/dev/null
  ls $W/mpe/posteriors/* > $W/mpe/posteriors.scp
  $STK/SVite -T 0 -w $D/phoneloop.net -S $W/mpe/posteriors.scp \
    -p ${PENALTY:--3} -H $D/HTK_gmmbypass.mmf -i $W/mpe/den_lats.mlf \
    -l $W/mpe -y rec -P HTK -z lat -q JWtval -t ${LATBEAM:-60.0} \
    --HTKCOMPAT=TRUE $D/dict $PHONES >/dev/null
  rm -rf $W/mpe/posteriors $W/mpe/posteriors.scp
}

echo "=== stage 1: headroom CE model (368:${HIDDEN}:${NPHONES}) ==="
DIM_NN=368
NN_INIT=$W/nnet_${DIM_NN}_${HIDDEN}_${NPHONES}.init
if [ ! -d $W/weights ] || [ -z "$(ls $W/weights/*final* 2>/dev/null)" ]; then
  python -m nnet_asr_tpu.tools.gen_mlp_init \
    --dim=${DIM_NN}:${HIDDEN}:${NPHONES} --gauss --negbias --seed=4242 \
    > $NN_INIT
  time python -m nnet_asr_tpu.tools.scheduler \
    --nn-init=$NN_INIT \
    --mlf-train=$W/workdir/mlfs/ref.mlf --mlf-cv=$W/workdir/mlfs/ref.mlf \
    --scp-train=$W/train_fea_tjoiner${FRM_EXT}.scp \
    --scp-cv=$W/workdir/lists/cv_fea.scp \
    --phonelist=$PHONES \
    --learnrate=${CE_LEARNRATE:-4.0} --frm-ext=$FRM_EXT \
    --feature-transform=$FEATURE_TRANSFORM \
    --bunchsize=1024 --cachesize=65536 --max-iter=${MAX_ITER:-8} \
    --weights-dir=$W/weights
fi
CE=$(ls -t $W/weights/*final* | head -1)
echo "headroom CE model: $CE"

echo "=== stage 2: CE baseline decode (held-out cv) ==="
decode_model "$CE" ce_baseline

echo "=== stage 3: denominator lattices from the CE model ==="
mkdir -p $W/mpe
[ "${FRESH_LATS:-}" = "1" ] && rm -f $W/mpe/den_lats.mlf
[ -f $W/mpe/den_lats.mlf ] || gen_lattices "$CE"
echo "lattice archive: $(du -h $W/mpe/den_lats.mlf | cut -f1)"

TMPE_COMMON=(-I $W/workdir/mlfs/ref.mlf -L '*/' -X lab -m $PHONES
  -S $W/train_fea_tjoiner${FRM_EXT}.scp --HMM=$D/HTK_gmmbypass.mmf
  --LATTICEDIR=$W/mpe/den_lats.mlf --FEATURETRANSFORM=$FEATURE_TRANSFORM
  --STARTFRMEXT=$FRM_EXT --ENDFRMEXT=$FRM_EXT
  --OUTPSCALE=${OUTPSCALE:-0.3} ${TMPE_EXTRA:-})

echo "=== stage 4: MPE iterations + per-iteration decode ==="
src=$CE
for it in $(seq $ITERS); do
  dst=$W/mpe/mpe_iter$it.mmf
  python -m nnet_asr_tpu.tools.tmpe \
    -H $src "${TMPE_COMMON[@]}" \
    --LEARNINGRATE=${LEARNRATE:-0.002} --TARGETMMF=$dst \
    | grep -E "Avg MPE|FINISHED"
  decode_model "$dst" mpe_iter$it
  src=$dst
  if [ "${REGEN:-}" = "1" ] && [ "$it" -lt "$ITERS" ]; then
    echo "[regen] new lattices from iter$it model"
    gen_lattices "$src"
  fi
done

echo "=== final criterion (crossvalidation pass) ==="
python -m nnet_asr_tpu.tools.tmpe -c -H $src "${TMPE_COMMON[@]}" \
  | grep -E "Avg MPE|FINISHED"
