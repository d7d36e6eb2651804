"""CLI option-vocabulary parity with the reference binaries.

Every long option the reference tools accept (extracted from their
SNAME":PARAM" tables in /root/reference/src/*.cc) must be accepted by the
corresponding CLI here — passing any of them at its reference default
must never die with the unused-parameter check. (Flags whose semantics
have no analog in this design are accepted with a warning —
see tools/tmpe.py — but never rejected; reference shell scripts pass
them freely.)"""

import contextlib
import importlib
import io

import pytest

# tool -> reference flags at their reference defaults (TNet.cc:187-231,
# TNetCu.cc:187-246, TFeaCat.cc, TNorm.cc, TRbmCu.cc,
# TRecurrentCu.cc:218-246, TMpeCu.cc:238-296, TJoiner.cc, TSegmenter.cc)
REF_FLAGS = {
    "tnet": (
        "BUNCHSIZE=256 CACHESIZE=12800 CONFUSIONMODE=no CROSSVALIDATE=FALSE "
        "LEARNINGRATE=0.008 NATURALREADORDER=FALSE OBJECTIVEFUNCTION=ent "
        "RANDOMIZE=TRUE SEED=0 THREADS=1 TRACE=0 WEIGHTCOST=0 GPUSELECT=-1 "
        "GRADDIVFRM=TRUE L1=0 MOMENTUM=0 PRINTVERSION=TRUE MLFTRANSC=TRUE "
        "TEMPBASISFOLDER=/tmp PRINTCONFIG=FALSE SOURCETRANSCEXT=lab"),
    "tfeacat": (
        "GMMBYPASS=FALSE LOGPOSTERIOR=FALSE NATURALREADORDER=FALSE "
        "PRINTVERSION=TRUE TRACE=0 PRINTCONFIG=FALSE"),
    "tnorm": "NATURALREADORDER=FALSE PRINTVERSION=TRUE TRACE=0",
    "trbm": (
        "BUNCHSIZE=256 CACHESIZE=12800 LEARNINGRATE=0.01 MOMENTUM=0 "
        "NATURALREADORDER=FALSE PRINTVERSION=TRUE RANDOMIZE=TRUE SEED=0 "
        "TRACE=0 WEIGHTCOST=0"),
    "trecurrent": (
        "BPTT=4 BUNCHSIZE=256 CACHESIZE=12800 CROSSVALIDATE=FALSE "
        "LEARNINGRATE=0.01 MOMENTUM=0 NATURALREADORDER=FALSE "
        "PRINTVERSION=TRUE RANDOMIZE=TRUE SEED=0 TRACE=0 WEIGHTCOST=0 "
        "OBJECTIVEFUNCTION=ent MLFTRANSC=TRUE"),
    "tmpe": (
        "GRADDIVFRM=TRUE LMSCALE=1.0 MLGAMMA=FALSE NATURALREADORDER=FALSE "
        "PRINTVERSION=TRUE TRACE=0 WEIGHTCOST=0 ALLOWXWRDEXP=FALSE "
        "EXACTTIMEMERGE=FALSE MINIMIZENET=FALSE WEIGHTPUSHING=TRUE "
        "REMEXPWRDNODES=FALSE TIMEPRUNING=FALSE MAXACTIVEMODELS=0 "
        "MINACTIVEMODELS=0 POSTERIORSCALE=1.0 TRANSPSCALE=1.0 "
        "MODELPENALTY=0 OCCUPPSCALE=1.0 STARTTIMESHIFT=0 ENDTIMESHIFT=0 "
        "PRUNING=0 PRUNINGINC=0 PRUNINGMAX=0 NFRAMEOUTPNORM=FALSE "
        "PRONUNSCALE=1.0 WORDPENALTY=0 RESPECTPRONVARS=FALSE"),
    "tjoiner": (
        "DIRSTRIP=FALSE NATURALREADORDER=FALSE PRINTVERSION=TRUE TRACE=0 "
        "TARGETSIZE=100000"),
    "tsegmenter": (
        "NATURALREADORDER=FALSE NOSUBDIRS=FALSE PRINTVERSION=TRUE TRACE=0 "
        "PRINTCONFIG=FALSE"),
}


@pytest.mark.parametrize("tool", sorted(REF_FLAGS))
def test_reference_flags_accepted(tool):
    mod = importlib.import_module(f"nnet_asr_tpu.tools.{tool}")
    missing = []
    for fl in REF_FLAGS[tool].split():
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(buf):
                mod.main([tool, f"--{fl}"])
        except SystemExit:
            pass            # missing required inputs — after param checks
        except Exception as e:
            msg = str(e)
            if "Unexpected" in msg or "Invalid" in msg:
                missing.append(f"{fl}: {msg}")
    assert not missing, f"{tool} rejects reference flags: {missing}"
