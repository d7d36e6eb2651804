#!/bin/bash
# Held-out MPE decode-win experiment on example-01 — REAL speech
# (results in BASELINE_MEASURED.md "MPE decode win").
#
# 80/20 split of the example-01 corpus: CE newbob on the 80 train
# utterances (seed-317 init), denominator lattices from that CE model
# over the same 80, tmpe MPE iterations (kappa 0.3, the decoder's
# insertion penalty mirrored via --MODELPENALTY=kappa*(-3)), and a
# decode of the HELD-OUT 20 utterances after every iteration.
# Measured: held-out 20.22 -> 21.41 %Acc at iteration 12-13 of lr 0.02
# (insertions 88 -> 73), then the classic fixed-lattice overfit tail.
#
# Prereq: scripts/decode_example01.sh ran once (model-independent decode
# assets under /tmp/decode_ex01; builds STK SVite).
# Usage: [LR=0.02] [PEN=-0.9] [ITERS=8] mpe_ex01_heldout.sh
set -e
REPO=/root/repo
EX=/root/reference/examples/01test_MLP3_compare_multithread_cuda_decode_phn
D=/tmp/mpe_ho
STK=/tmp/stk
DEC=/tmp/decode_ex01          # model-independent decode assets exist
export PYTHONPATH=$REPO JAX_PLATFORMS=cpu
mkdir -p $D
cd $EX

[ -f $D/init.mmf ] || python -m nnet_asr_tpu.tools.gen_mlp_init \
  --dim=598:1024:135 --gauss --negbias --seed=317 > $D/init.mmf
[ -f $D/train.scp ] || { head -80 lib/test.scp > $D/train.scp; tail -20 lib/test.scp > $D/cv.scp; }

# phone-level reference MLF (decode_example01.sh's awk fold)
[ -f $D/ref_phone.mlf ] || awk '{if(NF==3){split($3,a,"_");if(phn!=a[1]){ phn=a[1]; print phn;}}else {print $0; phn="";}}' \
  lib/test_3s.mlf > $D/ref_phone.mlf

if [ -z "$(ls $D/weights/* 2>/dev/null | grep -v rejected | tail -1)" ]; then
  python -m nnet_asr_tpu.tools.scheduler \
    --nn-init=$D/init.mmf \
    --mlf-train=lib/test_3s.mlf --mlf-cv=lib/test_3s.mlf \
    --scp-train=$D/train.scp --scp-cv=$D/cv.scp \
    --phonelist=lib/mono_state_phn_set_135_phn \
    --learnrate=4.0 --frm-ext=25 \
    --feature-transform=lib/Hamm_dct_norm \
    --weights-dir=$D/weights >/dev/null
fi
CE=$(ls $D/weights/* | grep -v rejected | tail -1)
echo "CE model: $CE"

decode_set () {  # mmf scp tag
  local mmf=$1 scp=$2 tag=$3 pd=$D/post_$3
  mkdir -p $pd
  python -m nnet_asr_tpu.tools.tfeacat -S $scp -H "$mmf" -l $pd -y htk_post \
    --FEATURETRANSFORM=lib/Hamm_dct_norm --GMMBYPASS=true \
    --START-FRM-EXT=25 --END-FRM-EXT=25 >/dev/null 2>&1
  ls $pd/* > $pd.scp
  $STK/SVite -T 0 -w $DEC/phoneloop.net -S $pd.scp \
    -H $DEC/HTK_gmmbypass.mmf -i $D/hyp_$tag.mlf -l '*' -y rec -P HTK \
    --HTKCOMPAT=TRUE $DEC/dict $DEC/monophones45 >/dev/null 2>&1
  python -m nnet_asr_tpu.tools.sresults -I $D/ref_phone.mlf \
    $DEC/monophones45 $D/hyp_$tag.mlf 2>/dev/null | grep "Corr=" | sed "s/^/[$tag] /"
  rm -rf $pd $pd.scp
}

echo "--- CE baselines ---"
decode_set "$CE" $D/cv.scp ce_ho          # held-out 20
decode_set "$CE" $D/train.scp ce_tr       # train 80 (contaminated ref)

# lattices from the CE model over the TRAIN 80
if [ ! -f $D/den_lats.mlf ]; then
  pd=$D/post_lat; mkdir -p $pd
  python -m nnet_asr_tpu.tools.tfeacat -S $D/train.scp -H "$CE" -l $pd -y htk_post \
    --FEATURETRANSFORM=lib/Hamm_dct_norm --GMMBYPASS=true \
    --START-FRM-EXT=25 --END-FRM-EXT=25 >/dev/null 2>&1
  ls $pd/* > $pd.scp
  $STK/SVite -T 0 -w $DEC/phoneloop.net -S $pd.scp \
    -H $DEC/HTK_gmmbypass.mmf -i $D/den_lats.mlf -l $D -y rec -P HTK \
    -z lat -q JWtval -t 60.0 --HTKCOMPAT=TRUE $DEC/dict $DEC/monophones45 >/dev/null 2>&1
  rm -rf $pd $pd.scp
fi

LR=${LR:-0.002}
PEN=${PEN:--0.9}
ITERS=${ITERS:-8}
src=$CE
echo "--- MPE lr=$LR pen=$PEN ---"
for it in $(seq $ITERS); do
  dst=$D/mpe_lr${LR}_iter$it.mmf
  python -m nnet_asr_tpu.tools.tmpe -H $src \
    -I lib/test_3s.mlf -L '*/' -X lab -m lib/mono_state_phn_set_135_phn \
    -S $D/train.scp --HMM=$DEC/HTK_gmmbypass.mmf \
    --LATTICEDIR=$D/den_lats.mlf --FEATURETRANSFORM=lib/Hamm_dct_norm \
    --STARTFRMEXT=25 --ENDFRMEXT=25 \
    --OUTPSCALE=0.3 --MODELPENALTY=$PEN --LEARNINGRATE=$LR \
    --TARGETMMF=$dst 2>/dev/null | grep "Avg MPE" | sed "s/^/[lr$LR it$it] /"
  decode_set $dst $D/cv.scp mpe_lr${LR}_it${it}_ho
  src=$dst
done
decode_set $src $D/train.scp mpe_lr${LR}_final_tr
