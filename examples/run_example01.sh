#!/bin/bash
# One-shot reproduction of the reference's example 01 with this framework:
# seeded init -> 1 training epoch -> crossvalidation -> (optional) decode.
# Mirrors run_test.{CPU,GPU}.sh (same data, options, and seed conventions).
set -e
REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="$REPO"
# CPU unless NNET_GPU=1 asks for the GPU
if [ "${NNET_GPU:-}" = "1" ]; then export JAX_PLATFORMS=cuda; else export JAX_PLATFORMS=cpu; fi
EX=/root/reference/examples/01test_MLP3_compare_multithread_cuda_decode_phn
W=${1:-/tmp/nnet_asr_tpu_example01}
mkdir -p $W
cd $EX

python -m nnet_asr_tpu.tools.gen_mlp_init \
  --dim=598:1024:135 --gauss --negbias --seed=317 > $W/init.mmf

python -m nnet_asr_tpu.tools.tnet -A -D -V -T 021 \
  -H $W/init.mmf \
  -I lib/test_3s.mlf -L '*/' -X lab \
  -S lib/test.scp \
  -m lib/mono_state_phn_set_135_phn \
  -n 0.008 \
  --GRAD-DIV-FRM=F \
  --TARGETMMF=$W/epoch1.mmf \
  --BUNCHSIZE=960 --CACHESIZE=14400 --RANDOMIZE=TRUE --SEED=123 \
  --FEATURETRANSFORM=lib/Hamm_dct_norm \
  --STARTFRMEXT=25 --ENDFRMEXT=25

python -m nnet_asr_tpu.tools.tnet -T 0 -c \
  -H $W/epoch1.mmf \
  -I lib/test_3s.mlf -L '*/' -X lab \
  -S lib/test.scp \
  -m lib/mono_state_phn_set_135_phn \
  --RANDOMIZE=FALSE --BUNCHSIZE=960 --CACHESIZE=14400 \
  --FEATURETRANSFORM=lib/Hamm_dct_norm \
  --STARTFRMEXT=25 --ENDFRMEXT=25

echo
echo "Optional decode (builds STK SVite from the vendored trunk):"
echo "  bash /root/repo/scripts/decode_example01.sh $W/epoch1.mmf"
