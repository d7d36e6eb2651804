#!/bin/bash
# TIMIT-SCALE recipe run: the example-02 pipeline at the
# reference's real corpus size (~4620 train utts / ~1.1M frames), on a
# synthetic TIMIT-shaped corpus (examples/prepare_timit_scale.py — the
# actual TIMIT audio is not shipped with the reference).
#
#   prepare -> tjoiner -> tnorm -> newbob MLP3 (368:500:39) -> [decode]
#
# Mirrors examples/02train_MLP3_newbob_timit/RUN_IT_ALL.sh stage for
# stage; tnet_train.CPU.sh's TIMIT parameters (LEARNRATE=4.0, FRM_EXT=15,
# DCT16 -> 368-dim input, HIDDEN=500).
#
# Usage: run_timit_scale.sh [workdir] [--skip-decode]
#   NNET_GPU=1         run on the GPU (default: forced CPU)
#   NNET_TS_RESIDENT=1 use the resident (HBM-cached) newbob
#   NNET_TS_BUDGET_MB= resident HBM budget (partial residency)
#   MAX_ITER=N         newbob iteration cap (default 8)
set -e -o pipefail

REPO=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH=$REPO
# CPU unless NNET_GPU=1 asks for the GPU
if [ "${NNET_GPU:-}" = "1" ]; then export JAX_PLATFORMS=cuda; else export JAX_PLATFORMS=cpu; fi
W=${1:-/tmp/timit_scale}
SKIP_DECODE=${2:-}

FRM_EXT=15
DIM_IN=23
DCT_BASE=16
HIDDEN=500
LEARNRATE=4.0
BUNCH=1024
CACHE=65536
if [ -n "${NNET_TS_TOY_WAV:-}" ]; then
  # a toy wav corpus has fewer CV frames than one production bunch —
  # the Cache's sub-bunch tail discard would evaluate 0 frames
  BUNCH=128
  CACHE=8192
fi

mkdir -p $W
cd $W

echo "=== stage 1: prepare ==="
# NNET_TS_WAV_DIR=<dir>: build the workdir from REAL labelled audio
# (wav/raw + .phn/.lab) through the native front end instead of the
# synthetic corpus — the reference's prepare_timit/HCopy stage, native
# (examples/prepare_from_wav.py). NNET_TS_TOY_WAV=N: a small synthesized
# wav corpus through the same wav->features path.
if [ ! -f $W/workdir/dicts/phones ]; then
  if [ -n "${NNET_TS_WAV_DIR:-}" ]; then
    python $REPO/examples/prepare_from_wav.py "$NNET_TS_WAV_DIR" $W/workdir
  elif [ -n "${NNET_TS_TOY_WAV:-}" ]; then
    python $REPO/examples/prepare_from_wav.py --toy "$NNET_TS_TOY_WAV" $W/workdir
  else
    python $REPO/examples/prepare_timit_scale.py $W/workdir
  fi
fi
NPHONES=$(wc -l < $W/workdir/dicts/phones)
echo "phones: $NPHONES"

echo "=== stage 2: tjoiner (join train features, FRM_EXT=$FRM_EXT) ==="
if [ ! -f $W/train_fea_tjoiner${FRM_EXT}.scp ]; then
  python -m nnet_asr_tpu.tools.tjoiner -T 01 \
    -S $W/workdir/lists/train_fea.scp \
    -l $W/joined \
    --OUTPUTSCRIPT=$W/train_fea_tjoiner${FRM_EXT}.scp \
    --STARTFRMEXT=$FRM_EXT --ENDFRMEXT=$FRM_EXT
fi

echo "=== stage 3: tnorm (Hamm-DCT transform + mean/var normalization) ==="
MMF=$W/tr_${DIM_IN}Tcontext$((2*FRM_EXT + 1))_Ham_dct${DCT_BASE}
if [ ! -f $MMF.transf ]; then
  python -m nnet_asr_tpu.tools.generators hamm_dct \
    --dimIn=$DIM_IN --startFrmExt=$FRM_EXT --endFrmExt=$FRM_EXT \
    --dctBaseCnt=$DCT_BASE > $MMF
  python -m nnet_asr_tpu.tools.tnorm -T 1 \
    -S $W/train_fea_tjoiner${FRM_EXT}.scp \
    -H $MMF --TARGETMMF=$MMF.norm \
    --STARTFRMEXT=$FRM_EXT --ENDFRMEXT=$FRM_EXT
  cat $MMF $MMF.norm > $MMF.transf
fi
FEATURE_TRANSFORM=$MMF.transf

echo "=== stage 4: newbob MLP3 training (368:${HIDDEN}:${NPHONES}) ==="
DIM_NN=$((DIM_IN * DCT_BASE))
NN_INIT=$W/nnet_${DIM_NN}_${HIDDEN}_${NPHONES}.init
python -m nnet_asr_tpu.tools.gen_mlp_init \
  --dim=${DIM_NN}:${HIDDEN}:${NPHONES} --gauss --negbias --seed=4242 \
  > $NN_INIT
SCHED_FLAGS=""
if [ "${NNET_TS_RESIDENT:-}" = "1" ]; then
  SCHED_FLAGS="--resident"
  [ -n "${NNET_TS_BUDGET_MB:-}" ] && \
    SCHED_FLAGS="$SCHED_FLAGS --hbm-budget-mb=${NNET_TS_BUDGET_MB}"
fi
time python -m nnet_asr_tpu.tools.scheduler \
  --nn-init=$NN_INIT \
  --mlf-train=$W/workdir/mlfs/ref.mlf --mlf-cv=$W/workdir/mlfs/ref.mlf \
  --scp-train=$W/train_fea_tjoiner${FRM_EXT}.scp \
  --scp-cv=$W/workdir/lists/cv_fea.scp \
  --phonelist=$W/workdir/dicts/phones \
  --learnrate=$LEARNRATE --frm-ext=$FRM_EXT \
  --feature-transform=$FEATURE_TRANSFORM \
  --bunchsize=$BUNCH --cachesize=$CACHE --max-iter=${MAX_ITER:-8} \
  --weights-dir=$W/weights $SCHED_FLAGS
FINAL=$(ls -t $W/weights/* 2>/dev/null | grep -v rejected | head -1)
echo "final network: $FINAL"

if [ "$SKIP_DECODE" = "--skip-decode" ]; then
  echo "=== decode skipped ==="
  exit 0
fi
echo "=== stage 5: decode (GMM bypass + SVite phone loop) ==="
bash $REPO/scripts/decode_example02.sh "$FINAL" $W
