#!/bin/bash
# Full decode-path validation on example-01 (the reference's decode.sh flow,
# with STK SVite built from the reference's own vendored decoder standing in
# for HVite, which is not in this container).
#
#   posteriors (our tfeacat --GMMBYPASS) -> SVite phone-loop decode ->
#   SResults + our sresults scoring vs the reference transcriptions.
#
# Usage: decode_example01.sh <trained_mmf> [outdir]
set -e

# CPU unless NNET_GPU=1 asks for the GPU
if [ "${NNET_GPU:-}" = "1" ]; then export JAX_PLATFORMS=cuda; else export JAX_PLATFORMS=cpu; fi

NNET=${1:?usage: decode_example01.sh <trained_mmf> [outdir]}
D=${2:-/tmp/decode_ex01}
EX=/root/reference/examples/01test_MLP3_compare_multithread_cuda_decode_phn
STK=${STK:-/tmp/stk}

# build SVite/SResults from the vendored STK trunk if missing
STK=$STK bash "$(dirname "$0")/build_stk.sh"

cd $EX
mkdir -p $D/posteriors

cut -d_ -f1 lib/mono_state_phn_set_135_phn | uniq > $D/monophones45
sed 's/.*/& &/' $D/monophones45 > $D/dict
PYTHONPATH=/root/repo python -m nnet_asr_tpu.tools.gen_phone_loop \
  $D/monophones45 $D/phoneloop.net
PYTHONPATH=/root/repo python -m nnet_asr_tpu.tools.gen_gmmbypass \
  lib/mono_state_phn_set_135_phn $D/HTK_gmmbypass.mmf --state-sep=_s

# NNET_DECODE_EXTRA: extra tfeacat flags (e.g. --INT8=true to decode
# with the int8 inference path — matched-condition decode of
# quantization-trained models)
PYTHONPATH=/root/repo python -m nnet_asr_tpu.tools.tfeacat \
  -S lib/test.scp -H "$NNET" -l $D/posteriors -y htk_post \
  --FEATURETRANSFORM=lib/Hamm_dct_norm --GMMBYPASS=true \
  --START-FRM-EXT=25 --END-FRM-EXT=25 ${NNET_DECODE_EXTRA:-}
ls $D/posteriors/* > $D/posteriors.scp

$STK/SVite -T 0 -w $D/phoneloop.net -S $D/posteriors.scp \
  -H $D/HTK_gmmbypass.mmf -i $D/test_hyp.mlf -l '*' -y rec -P HTK \
  --HTKCOMPAT=TRUE $D/dict $D/monophones45

awk '{if(NF==3){split($3,a,"_");if(phn!=a[1]){ phn=a[1]; print phn;}}else {print $0; phn="";}}' \
  lib/test_3s.mlf > $D/test_ref.mlf

echo "=== STK SResults ==="
$STK/SResults -I $D/test_ref.mlf $D/monophones45 $D/test_hyp.mlf | tail -4
echo "=== nnet_asr_tpu sresults ==="
PYTHONPATH=/root/repo python -m nnet_asr_tpu.tools.sresults \
  -I $D/test_ref.mlf $D/monophones45 $D/test_hyp.mlf
