"""TFeaCat — forward-pass "feature cat" CLI (TFeaCat.cc / TFeaCatCu.cc).

Propagates utterances through transform+network on device and writes HTK
PARAMKIND_USER feature files, with the decode-path post-processing:
``--GMMBYPASS`` maps posteriors to ``sqrt(-2·log p)`` pseudo-features for
HVite's GMM-bypass trick (TFeaCat.cc:244-251), ``--LOGPOSTERIOR`` takes the
log. The transform+net stack runs through the chunked halo pipeline, so
arbitrarily long utterances stream in bounded memory (the
Network::Feedforward analog, Nnet.cc:15-62).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..io.htk import PARMKIND_USER, make_htk_filename, write_htk_file
from ..io.scp import parse_scp_entry, read_scp
from ..models.network import Network
from ..train.pipeline import TransformPipeline
from ..utils.config import UserInterface

OPTION_STRING = (
    " -D n   PRINTCONFIG=TRUE"
    " -H l   SOURCEMMF"
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -V n   PRINTVERSION=TRUE"
    " -l r   TARGETPARAMDIR"
    " -y r   TARGETPARAMEXT"
)

SNAME = "TFEACAT"


def combine_networks(transform, net):
    """Stack transform+net into one component list (both optional)."""
    specs, params = [], []
    for n in (transform, net):
        if n is not None:
            specs.extend(n.specs)
            params.extend(n.params)
    combined = Network(tuple(specs), params)
    combined.check_dims()
    return combined


def main(argv=None) -> int:
    from .. import enable_compilation_cache
    enable_compilation_cache()
    argv = list(sys.argv if argv is None else argv)
    ui = UserInterface()
    args_parsed = ui.parse_options(argv, OPTION_STRING, SNAME)

    reader, feaparams = ui.make_feature_reader()

    p_source_mmf = ui.get_str("SOURCEMMF")
    p_transform = ui.get_str("FEATURETRANSFORM")
    p_script = ui.get_str("SCRIPT")
    p_dir = ui.get_str("TARGETPARAMDIR")
    p_ext = ui.get_str("TARGETPARAMEXT")
    gmm_bypass = ui.get_bool("GMMBYPASS", False)
    log_posterior = ui.get_bool("LOGPOSTERIOR", False)
    # bf16/int8 matmuls for the forward pass (posterior dumps don't need
    # f32 weights) — beyond-reference inference throughput modes
    bf16 = ui.get_bool("BF16", False)
    int8 = ui.get_bool("INT8", False)
    trace = ui.get_int("TRACE", 0)

    if ui.get_bool("PRINTVERSION", False):
        from .. import __version__
        print(f"Version: {__version__} (nnet_asr_tpu)")
    if ui.get_bool("PRINTCONFIG", False):
        print()
        ui.print_config()
        print()
    ui.check_command_line_param_use()

    transform = Network.read(p_transform) if p_transform else None
    net = Network.read(p_source_mmf) if p_source_mmf else None
    if net is None:
        raise SystemExit("Source MMF must be specified [-H]")
    combined = combine_networks(transform, net)

    entries = read_scp(p_script) if p_script else []
    for extra in argv[args_parsed:]:
        entries.append(parse_scp_entry(extra))
    if not entries:
        raise SystemExit("No input features specified, try [-S SCP] or "
                         "positional argument")

    pipe = TransformPipeline(
        combined, feaparams["start_frm_ext"], feaparams["end_frm_ext"],
        compute_dtype="int8" if int8 else ("bf16" if bf16 else None))

    t0 = time.time()
    frames = 0
    step = max(len(entries) // 100, 1)
    cnt = 0
    BATCH = 16      # utterances transformed per device call
    for lo in range(0, len(entries), BATCH):
        batch = entries[lo:lo + BATCH]
        feats_list, periods = [], []
        for e in batch:
            feats_list.append(reader.read(e.physical, e.logical))
            periods.append(reader.last_header.sample_period)
        # one device-to-host fetch per batch, not one per utterance
        outs = pipe.transform_to_host(feats_list)
        for e, out, period in zip(batch, outs, periods):
            if gmm_bypass:
                out = np.sqrt(np.maximum(-2.0 * np.log(out), 0.0))
            elif log_posterior:
                out = np.log(out)
            target = make_htk_filename(e.logical, p_dir, p_ext)
            write_htk_file(target, out, PARMKIND_USER, period,
                           feaparams["big_endian"])
            frames += out.shape[0]
            if trace & 1 and cnt % step == 0:
                print(f"{100 * (cnt + 1) // len(entries)}%, ", end="",
                      flush=True)
            cnt += 1

    if trace & 1:
        print(f"\nTFeaCat finished: {time.time() - t0:.2f}s "
              f"({frames} frames)")
    return 0


def _cli():
    """Reference-style top-level error handling (TNet.cc:371-376)."""
    import sys
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception as e:
        print("Exception thrown", file=sys.stderr)
        print(e, file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    _cli()
