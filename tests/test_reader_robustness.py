"""Adversarial reader coverage: corrupt/truncated HTK
headers and data, a _K CRC-bearing feature file, wrong-endian input, and
malformed MLF/SLF/MMF — the readers must fail FAST with an error naming
the problem (the reference's Features.cc/Labels.cc fail-fast surface,
SURVEY.md §4.3), never return garbage."""

import io
import struct

import numpy as np
import pytest

from nnet_asr_tpu.io import htk
from nnet_asr_tpu.io.htk import (FeatureReader, HtkHeader, PARMKIND_C,
                                 PARMKIND_K, PARMKIND_USER, read_htk_file,
                                 write_htk_file)


def _write_user(path, data, **kw):
    write_htk_file(str(path), data, PARMKIND_USER, **kw)


@pytest.fixture
def feats():
    rng = np.random.default_rng(0)
    return rng.standard_normal((20, 8)).astype(np.float32)


def test_truncated_header(tmp_path, feats):
    p = tmp_path / "t.fea"
    _write_user(p, feats)
    raw = p.read_bytes()
    p.write_bytes(raw[:7])            # mid-header cut
    with pytest.raises((ValueError, IOError), match="[Tt]runcated|header"):
        read_htk_file(str(p))
    with pytest.raises((ValueError, IOError)):
        FeatureReader().read(str(p))


def test_truncated_data(tmp_path, feats):
    p = tmp_path / "t.fea"
    _write_user(p, feats)
    raw = p.read_bytes()
    p.write_bytes(raw[: 12 + 5 * 8 * 4 + 3])   # 5.x of 20 frames
    with pytest.raises((ValueError, IOError), match="Cannot read|read"):
        read_htk_file(str(p))
    with pytest.raises((ValueError, IOError)):
        FeatureReader().read(str(p))


def test_truncated_compressed(tmp_path, feats):
    p = tmp_path / "c.fea"
    write_htk_file(str(p), feats, PARMKIND_USER | PARMKIND_C)
    raw = p.read_bytes()
    p.write_bytes(raw[: 12 + 4 * 8])            # cut inside the A row
    with pytest.raises((ValueError, IOError)):
        read_htk_file(str(p))


def test_wrong_endian(tmp_path, feats):
    """A little-endian file read as big-endian must be rejected by the
    header sanity check (Features.cc ReadHTKHeader's swab validation),
    not produce a garbage frame count."""
    p = tmp_path / "le.fea"
    _write_user(p, feats, big_endian=False)
    with pytest.raises((ValueError, IOError), match="byte order|header"):
        read_htk_file(str(p), big_endian=True)
    # and the reader honors NATURALREADORDER-style little-endian reads
    data, hdr = read_htk_file(str(p), big_endian=False)
    np.testing.assert_allclose(data, feats, rtol=1e-6)


def test_crc_k_file_reads_clean(tmp_path, feats):
    """_K files carry a trailing 2-byte CRC after the samples; the
    reference reads exactly nSamples rows and never consumes the CRC
    (Features.cc:676-700 seek-based reads), so the data must come back
    intact with the K bit preserved in the header."""
    p = tmp_path / "k.fea"
    _write_user(p, feats)
    raw = bytearray(p.read_bytes())
    # set the K bit in the header's sampleKind and append a CRC
    n, per, sz, kind = struct.unpack(">iihH", raw[:12])
    raw[:12] = struct.pack(">iihH", n, per, sz, kind | PARMKIND_K)
    raw += struct.pack(">H", 0xBEEF)
    p.write_bytes(bytes(raw))

    data, hdr = read_htk_file(str(p))
    np.testing.assert_allclose(data, feats, rtol=1e-6)
    assert hdr.sample_kind & PARMKIND_K
    assert data.shape == feats.shape

    out = FeatureReader().read(str(p))
    np.testing.assert_allclose(out, feats, rtol=1e-6)


def test_nan_poisoned_features_fail_fast(tmp_path, feats):
    bad = feats.copy()
    bad[3, 2] = np.nan
    p = tmp_path / "nan.fea"
    _write_user(p, bad)
    with pytest.raises(ValueError, match="Invalid value"):
        FeatureReader().read(str(p))


def test_header_data_disagreement(tmp_path, feats):
    """Header claims more frames than the file holds."""
    p = tmp_path / "lie.fea"
    _write_user(p, feats)
    raw = bytearray(p.read_bytes())
    n, per, sz, kind = struct.unpack(">iihH", raw[:12])
    raw[:12] = struct.pack(">iihH", n + 100, per, sz, kind)
    p.write_bytes(bytes(raw))
    with pytest.raises((ValueError, IOError)):
        read_htk_file(str(p))


def test_mlf_missing_magic(tmp_path):
    from nnet_asr_tpu.io.mlf import MlfReader

    p = tmp_path / "bad.mlf"
    p.write_text('"*/x.lab"\n0 100 a\n.\n')
    with pytest.raises(ValueError, match="MLF"):
        MlfReader(str(p))


def test_mlf_missing_record(tmp_path):
    from nnet_asr_tpu.io.mlf import MlfReader

    p = tmp_path / "ok.mlf"
    p.write_text('#!MLF!#\n"*/x.lab"\n0 100 a\n.\n')
    r = MlfReader(str(p))
    with pytest.raises(KeyError, match="label MLF record"):
        r.read_block("nonexistent.lab")


def test_slf_node_count_mismatch():
    from nnet_asr_tpu.io.slf import read_slf

    bad = "VERSION=1.0\nN=3 L=1\nI=0 t=0.0\nI=1 t=0.1\nJ=0 S=0 E=1 W=a\n"
    with pytest.raises(ValueError, match="N=3"):
        read_slf(io.StringIO(bad))


def test_slf_arc_out_of_range():
    from nnet_asr_tpu.io.slf import read_slf

    bad = "VERSION=1.0\nN=2 L=1\nI=0 t=0.0\nI=1 t=0.1\nJ=0 S=0 E=5 W=a\n"
    with pytest.raises(ValueError, match="references node"):
        read_slf(io.StringIO(bad))


def test_mmf_truncated(tmp_path):
    from nnet_asr_tpu.models import BiasedLinearity, Network, Softmax

    rng = np.random.default_rng(1)
    net = Network(
        (BiasedLinearity(4, 6), Softmax(6, 6)),
        [{"weight": rng.standard_normal((4, 6)).astype(np.float32),
          "bias": np.zeros(6, np.float32)}, {}])
    p = tmp_path / "m.mmf"
    net.write(str(p))
    txt = p.read_text()
    p.write_text(txt[: len(txt) // 2])
    with pytest.raises((EOFError, ValueError)):
        Network.read(str(p))


def test_mmf_garbage_tag(tmp_path):
    from nnet_asr_tpu.models import Network

    p = tmp_path / "g.mmf"
    p.write_text("<nonsensecomponent> 4 4\n")
    with pytest.raises((ValueError, KeyError)):
        Network.read(str(p))
