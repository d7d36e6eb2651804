"""TJoiner — concatenate small HTK feature files into big archives
(TJoiner.cc equivalent).

Joins features in SCP order into large files (an HDD seek optimization in
2012; still useful for network filesystems feeding accelerators) and emits a
new SCP whose entries address the archives with ``[s,e]`` frame ranges.

Reference semantics (TJoiner.cc:232-330): each segment is read through
the FULL feature pipeline (frame extension, parmkind conversion, CMN/CVN
— so archives store the ext margins and the SCP range points at the true
segment: ``[pos+start_ext, pos+rows-end_ext-1]``), NaN/Inf segments are
skipped with a warning, a NaN separator frame sits between segments (a
canary: reading past the stored margins trips the NaN checks), archives
roll at TARGETSIZE frames and are written with TARGETKIND (ANON keeps the
source kind) — including ``_C`` re-compression via write_htk_file.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io import htk
from ..io.scp import read_scp
from ..utils.config import UserInterface

OPTION_STRING = (
    " -l r   TARGETPARAMDIR"
    " -y r   TARGETPARAMEXT"
    " -D n   PRINTCONFIG=TRUE"
    " -S l   SCRIPT"
    " -T r   TRACE"
    " -V n   PRINTVERSION=TRUE"
)

SNAME = "TJOINER"


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    ui = UserInterface()
    ui.parse_options(argv, OPTION_STRING, SNAME)

    reader, feaparams = ui.make_feature_reader()
    p_script = ui.get_str("SCRIPT")
    p_outdir = ui.get_str("TARGETPARAMDIR", ".")
    p_ext = ui.get_str("TARGETPARAMEXT", "fea_join")
    # OUTPUTSCRIPT is the reference name (TJoiner.cc:161); TARGETSCRIPT
    # kept as an alias for round-1 scripts
    p_outscp = ui.get_str("OUTPUTSCRIPT") or ui.get_str("TARGETSCRIPT")
    target_size = ui.get_int("TARGETSIZE", 20000)
    dir_strip = ui.get_bool("DIRSTRIP", True)
    ui.get_int("TRACE", 0)
    if ui.get_bool("PRINTCONFIG", False):
        ui.print_config()
    if ui.get_bool("PRINTVERSION", False):
        from .. import __version__
        print(f"\n======= TJOINER v{__version__} (nnet_asr_tpu) =======\n")
    ui.check_command_line_param_use()

    if p_script is None:
        raise SystemExit("Script file must be specified [-S]")
    if p_outscp is None:
        raise SystemExit("Output script must be specified [--OUTPUTSCRIPT]")
    os.makedirs(p_outdir, exist_ok=True)

    ext0 = feaparams["start_frm_ext"]
    ext1 = feaparams["end_frm_ext"]
    target_kind = feaparams["target_kind"]

    entries = read_scp(p_script)
    out_lines = []
    buffer = []            # segment matrices with NaN separator rows
    pos_buf = 0            # rows buffered (incl. separators)
    ctr = 1

    def file_out():
        return os.path.join(p_outdir, f"{ctr:06d}.{p_ext}")

    def write_kind():
        if target_kind != htk.PARMKIND_ANON:
            return target_kind
        return reader.last_header.sample_kind

    def logical_name(logical):
        if dir_strip and "/" in logical:
            return logical.rsplit("/", 1)[1]
        return logical

    n_joined = 0
    for e in entries:
        mat = reader.read(e.physical, e.logical)
        if not np.isfinite(mat).all():
            print(f"WARNING: Skipping:{e.logical}\nIt contains nan or "
                  f"inf!!!", file=sys.stderr)
            continue
        rows = mat.shape[0]
        name = logical_name(e.logical)
        if pos_buf + 1 + rows >= target_size:
            # flush: buffer + this segment become one archive
            out_lines.append(f"{name}={file_out()}"
                             f"[{pos_buf + ext0},{pos_buf + rows - ext1 - 1}]")
            mat_out = np.concatenate(buffer + [mat], axis=0) \
                if buffer else mat
            htk.write_htk_file(file_out(), mat_out, write_kind(),
                               reader.last_header.sample_period)
            ctr += 1
            buffer, pos_buf = [], 0
        else:
            out_lines.append(f"{name}={file_out()}"
                             f"[{pos_buf + ext0},{pos_buf + rows - ext1 - 1}]")
            sep = np.full((1, mat.shape[1]), np.nan, np.float32)
            buffer.extend([mat, sep])
            pos_buf += rows + 1
        n_joined += 1

    if pos_buf > 0:
        # drop the trailing separator (TJoiner.cc:314-316)
        mat_out = np.concatenate(buffer, axis=0)[:pos_buf - 1]
        htk.write_htk_file(file_out(), mat_out, write_kind(),
                           reader.last_header.sample_period)
    else:
        ctr -= 1

    with open(p_outscp, "w") as f:
        f.write("\n".join(out_lines) + "\n")
    print(f"TJoiner: {n_joined} files -> {ctr} archives")
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
