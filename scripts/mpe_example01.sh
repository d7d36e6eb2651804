#!/bin/bash
# Full MPE sequence-training pipeline on example-01 (the TMpeCu workflow):
#   trained model -> GMM-bypass posteriors -> SVite lattice generation
#   (-z lat, STK node-format MLF transport) -> tmpe lattice MPE training.
# Prereq: scripts/decode_example01.sh ran once (builds SVite, makes the
# bypass MMF / phone loop / posteriors under $DEC).
#
# Usage: mpe_example01.sh <trained_mmf> [n_utts] [iters]
set -e

# CPU unless NNET_GPU=1 asks for the GPU
if [ "${NNET_GPU:-}" = "1" ]; then export JAX_PLATFORMS=cuda; else export JAX_PLATFORMS=cpu; fi
NNET=${1:?usage: mpe_example01.sh <trained_mmf> [n_utts] [iters]}
N=${2:-10}
ITERS=${3:-3}
EX=/root/reference/examples/01test_MLP3_compare_multithread_cuda_decode_phn
DEC=${DEC:-/tmp/decode_ex01}
STK=${STK:-/tmp/stk}
W=${W:-/tmp/mpe_ex01}
mkdir -p $W

cd $EX
head -$N $DEC/posteriors.scp > $W/post.scp
head -$N lib/test.scp > $W/feats.scp

# denominator lattices from the current model's posteriors
$STK/SVite -T 0 -w $DEC/phoneloop.net -S $W/post.scp \
  -H $DEC/HTK_gmmbypass.mmf -i $W/den_lats.mlf -l $W -y rec -P HTK \
  -z lat -q JWtval -t 60.0 --HTKCOMPAT=TRUE $DEC/dict $DEC/monophones45

src=$NNET
for it in $(seq $ITERS); do
  dst=$W/mpe_iter$it.mmf
  PYTHONPATH=/root/repo python -m nnet_asr_tpu.tools.tmpe \
    -H $src -I lib/test_3s.mlf -L '*/' -X lab \
    -m lib/mono_state_phn_set_135_phn -S $W/feats.scp \
    --HMM=$DEC/HTK_gmmbypass.mmf --LATTICEDIR=$W/den_lats.mlf \
    --FEATURETRANSFORM=lib/Hamm_dct_norm --STARTFRMEXT=25 --ENDFRMEXT=25 \
    --OUTPSCALE=0.3 --LEARNINGRATE=0.02 --TARGETMMF=$dst \
    | grep "Avg MPE"
  src=$dst
done
echo "MPE-trained model: $src"
