#!/bin/bash
# Matched-condition QAT-ladder rung runner: resident newbob on example-01
# with a chosen --compute-dtype, same seed-317 init and same 80/20 split
# as the recorded f32 / int8 / int8pf rows, then SVite decode.
#
# Usage: [NNET_GPU=1] int8_qat_run.sh <compute-dtype> [expdir]
#   expdir defaults to /tmp/int8_qat and is created (init + split) if
#   missing; pass an existing dir (e.g. the recorded experiment's) to
#   reuse its exact init/split files.
set -e -o pipefail

MODE=${1:?usage: int8_qat_run.sh <compute-dtype> [expdir]}
D=${2:-/tmp/int8_qat}
REPO=$(cd "$(dirname "$0")/.." && pwd)
EX=/root/reference/examples/01test_MLP3_compare_multithread_cuda_decode_phn
export PYTHONPATH=$REPO
# CPU unless NNET_GPU=1 asks for the GPU
if [ "${NNET_GPU:-}" = "1" ]; then export JAX_PLATFORMS=cuda; else export JAX_PLATFORMS=cpu; fi

mkdir -p $D
if [ ! -f $D/init.mmf ]; then
  python -m nnet_asr_tpu.tools.gen_mlp_init \
    --dim=598:1024:135 --gauss --negbias --seed=317 > $D/init.mmf
fi
if [ ! -f $D/train.scp ]; then
  head -80 $EX/lib/test.scp > $D/train.scp
  tail -20 $EX/lib/test.scp > $D/cv.scp
fi

cd $EX
W=$D/weights_${MODE}
CDT_FLAG=""
[ "$MODE" != "f32" ] && CDT_FLAG="--compute-dtype=$MODE"
time python -m nnet_asr_tpu.tools.scheduler \
  --nn-init=$D/init.mmf \
  --mlf-train=lib/test_3s.mlf --mlf-cv=lib/test_3s.mlf \
  --scp-train=$D/train.scp --scp-cv=$D/cv.scp \
  --phonelist=lib/mono_state_phn_set_135_phn \
  --learnrate=4.0 --frm-ext=25 \
  --feature-transform=lib/Hamm_dct_norm \
  --weights-dir=$W --resident $CDT_FLAG

BEST=$(ls $W/* | grep -v rejected | tail -1)
echo "best model: $BEST"
if [ "${SKIP_DECODE:-}" != "1" ]; then
  bash $REPO/scripts/decode_example01.sh "$BEST" /tmp/decode_qat_${MODE}
fi
