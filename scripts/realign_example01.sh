#!/bin/bash
# Forced-alignment regeneration of state labels (tools/realign/realign.sh
# equivalent): posteriors → SVite alignment mode (-a -f) against the word/
# phone transcription → state-level MLF usable as training targets.
# Uses the GMM-bypass posterior trick end to end.
#
# Usage: realign_example01.sh <trained_mmf> [outdir]
set -e

# CPU unless NNET_GPU=1 asks for the GPU
if [ "${NNET_GPU:-}" = "1" ]; then export JAX_PLATFORMS=cuda; else export JAX_PLATFORMS=cpu; fi

NNET=${1:?usage: realign_example01.sh <trained_mmf> [outdir]}
D=${2:-/tmp/realign_ex01}
EX=/root/reference/examples/01test_MLP3_compare_multithread_cuda_decode_phn
STK=${STK:-/tmp/stk}
[ -x $STK/SVite ] || { echo "build SVite first (scripts/decode_example01.sh)"; exit 1; }

cd $EX
mkdir -p $D/posteriors

cut -d_ -f1 lib/mono_state_phn_set_135_phn | uniq > $D/phones
sed 's/.*/& &/' $D/phones > $D/dict
PYTHONPATH=/root/repo python -m nnet_asr_tpu.tools.gen_gmmbypass \
  lib/mono_state_phn_set_135_phn $D/bypass.mmf --state-sep=_s

PYTHONPATH=/root/repo python -m nnet_asr_tpu.tools.tfeacat \
  -S lib/test.scp -H "$NNET" -l $D/posteriors -y htk_post \
  --FEATURETRANSFORM=lib/Hamm_dct_norm --GMMBYPASS=true \
  --START-FRM-EXT=25 --END-FRM-EXT=25
ls $D/posteriors/* > $D/posteriors.scp

# phone-level reference transcription for the aligner
awk '{if(NF==3){split($3,a,"_");if(phn!=a[1]){ phn=a[1]; print phn;}}else {print $0; phn="";}}' \
  lib/test_3s.mlf > $D/ref_phones.mlf

$STK/SVite -T 1 --HTKCOMPAT=TRUE -P HTK \
  -S $D/posteriors.scp -H $D/bypass.mmf \
  -i $D/realigned_raw.mlf -l '*' \
  -a -f -L '*' -I $D/ref_phones.mlf \
  $D/dict $D/phones

# state alignment "phone[N]" → state tags "phone_sN" training targets
sed -e 's|\[|_s|' -e 's|\].*||' -e 's|\.rec|.lab|' \
  $D/realigned_raw.mlf > $D/realigned.mlf
echo "Wrote $D/realigned.mlf"
head -8 $D/realigned.mlf
