#!/bin/bash
# Example-02 recipe analog (examples/02train_MLP3_newbob_timit/RUN_IT_ALL.sh):
#
#   prepare -> tjoiner -> tnorm -> newbob MLP3 training -> decode
#
# TIMIT audio isn't shipped with the reference, so the prepare stage
# derives an equivalently-shaped stand-in corpus from the bundled
# example-01 data (23-dim FBANK features, 1-state phone MLF, 45 phones) —
# see examples/prepare_example02.py. Every other stage mirrors the
# reference scripts 1:1 with our tools:
#   tjoiner.sh        -> tools.tjoiner  (FRM_EXT=15 margins, NaN separators)
#   tnorm.sh          -> generators hamm_dct (23 x ctx31 -> DCT16 = 368)
#                        + tools.tnorm, cat transform+norm -> .transf
#   tnet_train.CPU.sh -> gen_mlp_init 368:500:NPHONES + tools.scheduler
#                        (newbob, LEARNRATE=4.0 like the TIMIT recipe)
#   decode.sh         -> scripts/decode_example02.sh (GMM-bypass + SVite)
#
# Usage: run_example02.sh [workdir] [--skip-decode]
set -e

REPO=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH=$REPO
# CPU unless NNET_GPU=1 asks for the GPU
if [ "${NNET_GPU:-}" = "1" ]; then export JAX_PLATFORMS=cuda; else export JAX_PLATFORMS=cpu; fi
W=${1:-/tmp/example02}
SKIP_DECODE=${2:-}

FRM_EXT=15
DIM_IN=23
DCT_BASE=16
HIDDEN=500
LEARNRATE=4.0

mkdir -p $W
cd $W

echo "=== stage 1: prepare (stand-in TIMIT-shaped corpus) ==="
python $REPO/examples/prepare_example02.py $W/workdir

NPHONES=$(wc -l < $W/workdir/dicts/phones)
echo "phones: $NPHONES"

echo "=== stage 2: tjoiner (join train features, FRM_EXT=$FRM_EXT) ==="
python -m nnet_asr_tpu.tools.tjoiner -T 021 \
  -S $W/workdir/lists/train_fea.scp \
  -l $W/joined \
  --OUTPUTSCRIPT=$W/train_fea_tjoiner${FRM_EXT}.scp \
  --STARTFRMEXT=$FRM_EXT --ENDFRMEXT=$FRM_EXT

echo "=== stage 3: tnorm (Hamm-DCT transform + mean/var normalization) ==="
MMF=$W/tr_${DIM_IN}Tcontext$((2*FRM_EXT + 1))_Ham_dct${DCT_BASE}
python -m nnet_asr_tpu.tools.generators hamm_dct \
  --dimIn=$DIM_IN --startFrmExt=$FRM_EXT --endFrmExt=$FRM_EXT \
  --dctBaseCnt=$DCT_BASE > $MMF
python -m nnet_asr_tpu.tools.tnorm -T 1 \
  -S $W/train_fea_tjoiner${FRM_EXT}.scp \
  -H $MMF --TARGETMMF=$MMF.norm \
  --STARTFRMEXT=$FRM_EXT --ENDFRMEXT=$FRM_EXT
cat $MMF $MMF.norm > $MMF.transf
FEATURE_TRANSFORM=$MMF.transf

echo "=== stage 4: newbob MLP3 training (368:${HIDDEN}:${NPHONES}) ==="
DIM_NN=$((DIM_IN * DCT_BASE))
NN_INIT=$W/nnet_${DIM_NN}_${HIDDEN}_${NPHONES}.init
python -m nnet_asr_tpu.tools.gen_mlp_init \
  --dim=${DIM_NN}:${HIDDEN}:${NPHONES} --gauss --negbias --seed=4242 \
  > $NN_INIT
python -m nnet_asr_tpu.tools.scheduler \
  --nn-init=$NN_INIT \
  --mlf-train=$W/workdir/mlfs/ref.mlf --mlf-cv=$W/workdir/mlfs/ref.mlf \
  --scp-train=$W/train_fea_tjoiner${FRM_EXT}.scp \
  --scp-cv=$W/workdir/lists/cv_fea.scp \
  --phonelist=$W/workdir/dicts/phones \
  --learnrate=$LEARNRATE --frm-ext=$FRM_EXT \
  --feature-transform=$FEATURE_TRANSFORM \
  --bunchsize=512 --cachesize=16384 --max-iter=${MAX_ITER:-8} \
  --weights-dir=$W/weights
FINAL=$(ls -t $W/weights/*_final_* 2>/dev/null | head -1)
if [ -z "$FINAL" ]; then
  FINAL=$(ls -t $W/weights/*.mmf 2>/dev/null | grep -v rejected | head -1)
fi
echo "final network: $FINAL"

if [ "$SKIP_DECODE" = "--skip-decode" ]; then
  echo "=== decode skipped ==="
  exit 0
fi
echo "=== stage 5: decode (GMM bypass + SVite phone loop) ==="
bash $REPO/scripts/decode_example02.sh "$FINAL" $W
