#!/bin/bash
# Deep-MLP RBM pretraining workflow on example-01 (the TRbmCu path,
# BASELINE.json config 3): stack CD-1-pretrained RBM layers, convert with
# rbm2mlplayer, fine-tune with CE, and compare against a random init of
# the same architecture.
#
# Usage: run_rbm_pretrain_example01.sh [workdir] [hid_dim] [rbm_iters] [ce_iters]
set -e
REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="$REPO"
# CPU unless NNET_GPU=1 asks for the GPU
if [ "${NNET_GPU:-}" = "1" ]; then export JAX_PLATFORMS=cuda; else export JAX_PLATFORMS=cpu; fi
W=${1:-/tmp/rbm_ex01}
HID=${2:-512}
RBM_ITERS=${3:-3}
CE_ITERS=${4:-3}
EX=/root/reference/examples/01test_MLP3_compare_multithread_cuda_decode_phn
G="python -m nnet_asr_tpu.tools.generators"
mkdir -p $W
cd $EX

head -80 lib/test.scp > $W/train.scp
tail -20 lib/test.scp > $W/cv.scp

# ---- layer 1 RBM: gaussian visible (DCT features), bernoulli hidden ----
$G rbm_init --dim=598:$HID --gauss --vistype=gauss --seed=11 > $W/rbm1.mmf
for i in $(seq $RBM_ITERS); do
  python -m nnet_asr_tpu.tools.trbm -H $W/rbm1.mmf -S $W/train.scp \
    --TARGETMMF=$W/rbm1.mmf --FEATURETRANSFORM=lib/Hamm_dct_norm \
    --STARTFRMEXT=25 --ENDFRMEXT=25 --LEARNINGRATE=0.001 --MOMENTUM=0.5 \
    --BUNCHSIZE=256 --CACHESIZE=10240 --SEED=$((100 + i)) | grep Mse
done
$G rbm2mlplayer $W/rbm1.mmf $W/layer1.mmf

# ---- layer 2 RBM on layer-1 activations ----
$G netjoin lib/Hamm_dct_norm $W/layer1.mmf > $W/transf2.mmf
$G rbm_init --dim=$HID:$HID --gauss --seed=12 > $W/rbm2.mmf
for i in $(seq $RBM_ITERS); do
  python -m nnet_asr_tpu.tools.trbm -H $W/rbm2.mmf -S $W/train.scp \
    --TARGETMMF=$W/rbm2.mmf --FEATURETRANSFORM=$W/transf2.mmf \
    --STARTFRMEXT=25 --ENDFRMEXT=25 --LEARNINGRATE=0.1 --MOMENTUM=0.5 \
    --BUNCHSIZE=256 --CACHESIZE=10240 --SEED=$((200 + i)) | grep Mse
done
$G rbm2mlplayer $W/rbm2.mmf $W/layer2.mmf

# ---- stack + random softmax top; random-init control ----
python - <<PYEOF
import subprocess, sys, io, contextlib
sys.path.insert(0, "/root/repo")
from nnet_asr_tpu.tools import generators, gen_mlp_init
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    gen_mlp_init.main(["--dim=$HID:135", "--gauss", "--seed=13"])
open("$W/top.mmf", "w").write(buf.getvalue())
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    generators.main(["netjoin", "$W/layer1.mmf", "$W/layer2.mmf", "$W/top.mmf"])
open("$W/pretrained.mmf", "w").write(buf.getvalue())
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    gen_mlp_init.main(["--dim=598:$HID:$HID:135", "--gauss", "--negbias",
                       "--seed=14"])
open("$W/random.mmf", "w").write(buf.getvalue())
PYEOF

# ---- CE fine-tune both, report CV accuracy ----
for tag in pretrained random; do
  src=$W/$tag.mmf
  for i in $(seq $CE_ITERS); do
    dst=$W/${tag}_ce$i.mmf
    python -m nnet_asr_tpu.tools.tnet -T 0 -H $src \
      -I lib/test_3s.mlf -L '*/' -X lab -S $W/train.scp \
      -m lib/mono_state_phn_set_135_phn -n 2.0 \
      --TARGETMMF=$dst --BUNCHSIZE=512 --CACHESIZE=10240 \
      --RANDOMIZE=TRUE --SEED=123 --FEATURETRANSFORM=lib/Hamm_dct_norm \
      --STARTFRMEXT=25 --ENDFRMEXT=25 | grep Xent
    src=$dst
  done
  echo "--- $tag CV:"
  python -m nnet_asr_tpu.tools.tnet -T 0 -c -H $src \
    -I lib/test_3s.mlf -L '*/' -X lab -S $W/cv.scp \
    -m lib/mono_state_phn_set_135_phn \
    --RANDOMIZE=FALSE --BUNCHSIZE=512 --CACHESIZE=10240 \
    --FEATURETRANSFORM=lib/Hamm_dct_norm \
    --STARTFRMEXT=25 --ENDFRMEXT=25 | grep Xent
done
