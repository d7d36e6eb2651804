#!/bin/bash
# Parity check against the reference CPU binaries (built from the read-only
# checkout). Reproduces the numbers in BASELINE_MEASURED.md:
#   - TNet epoch:   Xent/accuracy parity on example-01 (same init, SEED=123)
#   - TFeaCat:      GMM-bypass posterior features allclose (<= ~1e-5)
set -e -o pipefail

REF=/root/reference
SRC=/tmp/refsrc
EX=$REF/examples/01test_MLP3_compare_multithread_cuda_decode_phn
WORK=${WORK:-/tmp/parity}
BLAS=/lib/x86_64-linux-gnu/libblas.so.3
LAPACK=/lib/x86_64-linux-gnu/liblapack.so.3

PYPATH=/root/repo
# CPU unless NNET_GPU=1 asks for the GPU
if [ "${NNET_GPU:-}" = "1" ]; then export JAX_PLATFORMS=cuda; else export JAX_PLATFORMS=cpu; fi

# run `cmd... | grep -E pat` but keep the full output on disk and dump it
# when the command fails, so python tracebacks aren't swallowed by grep
run_logged() {
  local log=$1 pat=$2; shift 2
  if ! "$@" >"$log" 2>&1; then
    echo "FAILED: $* (full output below)" >&2
    cat "$log" >&2
    return 1
  fi
  grep -E "$pat" "$log" || true
}

mkdir -p $WORK

# 1. build reference CPU binaries (KaldiLib+TNetLib only; GotoBLAS binary is
#    not shipped, link the system netlib BLAS instead)
if [ ! -x $SRC/TNet ] || [ ! -x $SRC/TJoiner ]; then
  rm -rf $SRC && cp -r $REF/src $SRC
  cd $SRC
  g++ -std=gnu++03 -fpermissive -m64 -O2 -w -DHAVE_ATLAS -IKaldiLib -ITNetLib \
      -c KaldiLib/*.cc TNetLib/*.cc TNet.cc TFeaCat.cc TNorm.cc TJoiner.cc
  for tool in TNet TFeaCat TNorm TJoiner; do
    g++ -o $tool $tool.o $(ls *.o | grep -vE '^T(Net|FeaCat|Norm|Joiner)\.o') \
        $BLAS $LAPACK -pthread
  done
fi

cd $EX

# 2. shared random init
if [ ! -f $WORK/init.mmf ]; then
  PYTHONPATH=$PYPATH python -m nnet_asr_tpu.tools.gen_mlp_init \
    --dim=598:1024:135 --gauss --negbias --seed=317 > $WORK/init.mmf
fi

# NOTE: the label dir mask rides literally quoted ('*/') so the shell
# can't glob-expand it against the cwd; UserInterface strips the quotes
# (ParseHTKString semantics), in the reference binary and here alike
COMMON="-I lib/test_3s.mlf -L '*/' -X lab -S lib/test.scp \
 -m lib/mono_state_phn_set_135_phn -n 0.008 \
 --BUNCHSIZE=960 --CACHESIZE=14400 --RANDOMIZE=TRUE --SEED=123 \
 --FEATURETRANSFORM=lib/Hamm_dct_norm --STARTFRMEXT=25 --ENDFRMEXT=25"

echo "=== reference TNet (1 thread) ==="
run_logged $WORK/tnet.ref.log 'Xent|FPS' \
  $SRC/TNet -T 00 -H $WORK/init.mmf --THREADS=1 \
  --TARGETMMF=$WORK/epoch1.ref.mmf $COMMON

echo "=== nnet_asr_tpu tnet ==="
run_logged $WORK/tnet.ours.log 'Xent|FPS' \
  env PYTHONPATH=$PYPATH \
  python -m nnet_asr_tpu.tools.tnet -T 00 -H $WORK/init.mmf --GRAD-DIV-FRM=F \
  --TARGETMMF=$WORK/epoch1.ours.mmf $COMMON

echo "=== posterior parity (TFeaCat, GMM bypass) ==="
head -5 lib/test.scp > $WORK/sub5.scp
mkdir -p $WORK/post_ref $WORK/post_ours
$SRC/TFeaCat -H $WORK/epoch1.ref.mmf -S $WORK/sub5.scp \
  --FEATURETRANSFORM=lib/Hamm_dct_norm --STARTFRMEXT=25 --ENDFRMEXT=25 \
  -l $WORK/post_ref -y post --GMMBYPASS=TRUE
PYTHONPATH=$PYPATH \
python -m nnet_asr_tpu.tools.tfeacat -H $WORK/epoch1.ref.mmf -S $WORK/sub5.scp \
  --FEATURETRANSFORM=lib/Hamm_dct_norm --STARTFRMEXT=25 --ENDFRMEXT=25 \
  -l $WORK/post_ours -y post --GMMBYPASS=TRUE
PYTHONPATH=$PYPATH python - <<'EOF'
import numpy as np, glob, os
from nnet_asr_tpu.io import htk
work = os.environ.get("WORK", "/tmp/parity")
worst = 0
for f in sorted(glob.glob(f"{work}/post_ref/*.post")):
    a, _ = htk.read_htk_file(f)
    b, _ = htk.read_htk_file(f.replace("post_ref", "post_ours"))
    assert a.shape == b.shape
    worst = max(worst, float(np.max(np.abs(a - b))))
print("max posterior-feature diff:", worst)
assert worst < 1e-4, "posterior parity failed"
print("PARITY OK")
EOF
