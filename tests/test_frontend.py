"""Native HCopy-equivalent front end: HTK-book formula
oracle checks, byte-exact HTK output headers, round-trip through the
io/htk.py readers, and the THCopy CLI end-to-end from WAV/raw audio."""

import struct
import subprocess
import sys

import numpy as np
import pytest

from nnet_asr_tpu.io import htk
from nnet_asr_tpu.io.wav import (read_htk_waveform, read_raw, read_wav,
                                 write_wav)
from nnet_asr_tpu.ops.mfcc import Frontend, FrontendConfig, \
    htk_regression_deltas


def _tone(freq, dur_s=0.5, fs=16000, amp=8000):
    t = np.arange(int(dur_s * fs)) / fs
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.int16)


# -- waveform containers ------------------------------------------------

def test_wav_roundtrip(tmp_path):
    s = _tone(440)
    p = tmp_path / "a.wav"
    write_wav(str(p), s, 16000)
    out, rate = read_wav(str(p))
    assert rate == 16000
    np.testing.assert_array_equal(out, s)


def test_raw_byte_orders(tmp_path):
    s = _tone(100, 0.05)
    (tmp_path / "v.raw").write_bytes(s.astype("<i2").tobytes())
    (tmp_path / "b.raw").write_bytes(s.astype(">i2").tobytes())
    np.testing.assert_array_equal(read_raw(str(tmp_path / "v.raw"), "vax"), s)
    np.testing.assert_array_equal(read_raw(str(tmp_path / "b.raw"), "be"), s)


def test_htk_waveform_roundtrip(tmp_path):
    s = _tone(200, 0.1)
    p = tmp_path / "w.htk"
    hdr = htk.HtkHeader(len(s), 625, 2, 0)
    p.write_bytes(hdr.pack(True) + s.astype(">i2").tobytes())
    out, period = read_htk_waveform(str(p))
    assert period == 625
    np.testing.assert_array_equal(out, s)


# -- front-end oracle checks -------------------------------------------

def _fbank_cfg(**kw):
    base = dict(target_kind="FBANK", numchans=23, preemcoef=0.0,
                use_power=True, lofreq=0, hifreq=8000)
    base.update(kw)
    return FrontendConfig(**base)


def test_frame_count_and_dims():
    fe = Frontend(_fbank_cfg())
    s = _tone(440, 1.0)              # 16000 samples, 400-win, 160-shift
    out = fe.extract(s)
    assert out.shape == ((16000 - 400) // 160 + 1, 23)
    assert out.dtype == np.float32


def test_tone_peaks_in_matching_mel_channel():
    """A pure tone's energy must land in the mel channel whose centre is
    nearest the tone frequency — the filterbank geometry check."""
    fe = Frontend(_fbank_cfg())
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)
    centres_mel = mel(0) + (mel(8000) - mel(0)) * np.arange(1, 24) / 24
    # invert: centre frequencies in Hz
    centres_hz = 700.0 * (np.exp(centres_mel / 1127.0) - 1.0)
    for freq in (300.0, 1000.0, 3000.0):
        out = fe.extract(_tone(freq))
        ch = int(np.argmax(out.mean(axis=0)))
        expect = int(np.argmin(np.abs(centres_hz - freq)))
        assert abs(ch - expect) <= 1, (freq, ch, expect)


def test_mfcc_dct_oracle():
    """MFCC = lifted DCT-II of the log filterbank: re-derive one frame's
    cepstra from the FBANK output of the same front end."""
    fb = Frontend(_fbank_cfg(numchans=20))
    mf = Frontend(FrontendConfig(target_kind="MFCC", numchans=20,
                                 preemcoef=0.0, use_power=True,
                                 lofreq=0, hifreq=8000, numceps=12,
                                 ceplifter=22))
    s = (_tone(500) + _tone(1700)) // 2
    logm = fb.extract(s).astype(np.float64)
    got = mf.extract(s).astype(np.float64)
    i = np.arange(1, 13)
    j = np.arange(1, 21)
    dct = np.sqrt(2.0 / 20) * np.cos(np.pi * i[:, None] * (j - 0.5) / 20)
    lift = 1.0 + 11.0 * np.sin(np.pi * i / 22)
    want = (logm @ dct.T) * lift
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_c0_and_energy_layout():
    """_0 appends c0 after the cepstra, _E the (normalised) log energy
    last — the layout io/htk.py's reader assumes."""
    fe = Frontend(FrontendConfig(target_kind="MFCC_0_E", numchans=20,
                                 numceps=12))
    out = fe.extract(_tone(800))
    assert out.shape[1] == 14
    fb = Frontend(FrontendConfig(target_kind="MFCC", numchans=20,
                                 numceps=12))
    np.testing.assert_allclose(out[:, :12], fb.extract(_tone(800)),
                               rtol=1e-5, atol=1e-5)
    # ENORMALISE: max-normalised energy peaks at exactly 1.0
    assert abs(out[:, 13].max() - 1.0) < 1e-6


def test_deltas_match_reader_formula(tmp_path):
    """MFCC_0_D_A written by the front end == MFCC_0 written + derivative
    orders computed by the READER (both implement Features.cc:1304-1350),
    proving the extracted files are layout-compatible."""
    cfg0 = FrontendConfig(target_kind="MFCC_0", numchans=20, numceps=12)
    cfgA = FrontendConfig(target_kind="MFCC_0_D_A", numchans=20, numceps=12)
    s = _tone(600) + _tone(2500) // 3
    static = Frontend(cfg0).extract(s)
    full = Frontend(cfgA).extract(s)
    assert full.shape[1] == 3 * 13
    np.testing.assert_allclose(full[:, :13], static, rtol=1e-6)
    d = htk_regression_deltas(static, 2)
    np.testing.assert_allclose(full[:, 13:26], d, rtol=1e-5, atol=1e-6)

    # and a file written as MFCC_0 + read with DERIVWINDOWS must equal
    # the file written as MFCC_0_D_A read plain
    p0 = tmp_path / "s.fea"
    pA = tmp_path / "f.fea"
    htk.write_htk_file(str(p0), static, htk.parse_parmkind("MFCC_0"))
    htk.write_htk_file(str(pA), full, htk.parse_parmkind("MFCC_0_D_A"))
    rd = htk.FeatureReader(target_kind=htk.parse_parmkind("MFCC_0_D_A"),
                           deriv_order=2, deriv_win_lengths=[2, 2])
    via_reader = rd.read(str(p0))
    plain = htk.FeatureReader().read(str(pA))
    np.testing.assert_allclose(via_reader, plain, rtol=1e-4, atol=1e-5)


def test_header_byte_exact(tmp_path):
    """The written HTK header must be the exact 12-byte big-endian
    struct HCopy would produce for this config."""
    fe = Frontend(_fbank_cfg())
    out = fe.extract(_tone(440))
    p = tmp_path / "h.fea"
    htk.write_htk_file(str(p), out, fe.kind, fe.sample_period)
    raw = p.read_bytes()
    n, per, sz, kind = struct.unpack(">iihH", raw[:12])
    assert n == out.shape[0]
    assert per == 100000
    assert sz == 23 * 4
    assert kind == htk.parse_parmkind("FBANK")
    assert len(raw) == 12 + out.size * 4


def test_thcopy_cli_end_to_end(tmp_path):
    """The recipe's extraction stage: config file + 2-column scp, raw
    NOHEAD VAX input (hcopy23mel_16k_0.sh's configuration), output
    readable by the FeatureReader."""
    s = _tone(1000)
    raw = tmp_path / "u1.raw"
    raw.write_bytes(s.astype("<i2").tobytes())
    wav = tmp_path / "u2.wav"
    write_wav(str(wav), _tone(2000), 16000)
    cfgf = tmp_path / "hcopy.cfg"
    cfgf.write_text(
        "SOURCEKIND   = WAVEFORM\n"
        "SOURCEFORMAT = NOHEAD\n"
        "SOURCERATE   = 625\n"
        "BYTEORDER    = VAX\n"
        "TARGETKIND   = FBANK\n"
        "LOFREQ       = 0\n"
        "HIFREQ       = 8000\n"
        "NUMCHANS     = 23\n"
        "USEPOWER     = T\n"
        "USEHAMMING   = T\n"
        "PREEMCOEF    = 0\n"
        "TARGETRATE   = 100000\n"
        "WINDOWSIZE   = 250000\n"
        "SAVEWITHCRC  = F\n")
    scp = tmp_path / "pairs.scp"
    scp.write_text(f"{raw} {tmp_path / 'u1.fea'}\n")

    from nnet_asr_tpu.tools import thcopy
    rc = thcopy.main(["thcopy", "-C", str(cfgf), "-T", "1",
                      "-S", str(scp)])
    assert rc == 0
    out = htk.FeatureReader().read(str(tmp_path / "u1.fea"))
    assert out.shape == ((8000 - 400) // 160 + 1, 23)   # 0.5s tone
    assert np.isfinite(out).all()

    # WAV source for the same config
    cfg2 = tmp_path / "wav.cfg"
    cfg2.write_text(cfgf.read_text().replace("NOHEAD", "WAV"))
    rc = thcopy.main(["thcopy", "-C", str(cfg2),
                      str(wav), str(tmp_path / "u2.fea")])
    assert rc == 0
    out2 = htk.FeatureReader().read(str(tmp_path / "u2.fea"))
    assert out2.shape[1] == 23


def test_waveform_too_short():
    fe = Frontend(_fbank_cfg())
    with pytest.raises(ValueError, match="too short"):
        fe.extract(np.zeros(100, np.int16))


def _oracle_fbank_cfg():
    from nnet_asr_tpu.ops.mfcc import FrontendConfig
    return FrontendConfig(target_kind="FBANK", numchans=23, use_power=True,
                          use_hamming=True, preemcoef=0.0, lofreq=0,
                          hifreq=8000, source_rate=625.0,
                          target_rate=100000.0, window_size=250000.0)


def _oracle_mfcc_cfg():
    from nnet_asr_tpu.ops.mfcc import FrontendConfig
    return FrontendConfig(target_kind="MFCC_0_D_A", numchans=26,
                          numceps=12, ceplifter=22, use_hamming=True,
                          preemcoef=0.97, lofreq=0, hifreq=8000,
                          enormalise=False, source_rate=625.0,
                          target_rate=100000.0, window_size=250000.0)


@pytest.mark.parametrize("fea,cfg_fn", [
    ("oracle_fbank23.fea", _oracle_fbank_cfg),
    ("oracle_mfcc_0_d_a.fea", _oracle_mfcc_cfg),
])
def test_hcopy_oracle_fixture(fea, cfg_fn):
    """External-oracle check against recorded HTK HCopy output
    (tests/data/hcopy_oracle/README.md documents the exact generation
    recipe; HTK is absent from this container, so the test SKIPS until
    the fixture files are committed)."""
    import os
    d = os.path.join(os.path.dirname(__file__), "data", "hcopy_oracle")
    path = os.path.join(d, fea)
    if not os.path.exists(path):
        pytest.skip(f"HCopy fixture {fea} not generated yet — see "
                    f"tests/data/hcopy_oracle/README.md")
    from nnet_asr_tpu.io.wav import read_wav
    samples, rate = read_wav(os.path.join(d, "oracle.wav"))
    assert rate == 16000
    ours = Frontend(cfg_fn()).extract(samples)
    want = htk.FeatureReader().read(path)
    assert ours.shape == want.shape
    np.testing.assert_allclose(ours, want, rtol=1e-3, atol=2e-3)


def test_frontend_rejects_unimplemented_qualifiers():
    """_N/_C/_K/_V must error loudly: the written header would advertise
    a layout the payload doesn't have."""
    from nnet_asr_tpu.ops.mfcc import FrontendConfig
    for bad in ("FBANK_N", "MFCC_0_N", "MFCC_C", "FBANK_K", "MFCC_V"):
        with pytest.raises(ValueError, match="qualifier"):
            Frontend(FrontendConfig(target_kind=bad))


def test_sphere_roundtrip_both_byte_orders(tmp_path):
    """NIST SPHERE read/write: the 1024-byte ASCII header + PCM body,
    little ('01') and big ('10') sample_byte_format (real
    TIMIT discs ship SPHERE files named .wav)."""
    from nnet_asr_tpu.io.wav import read_sphere, sniff_audio, write_sphere
    s = _tone(700)
    for fmt in ("01", "10"):
        p = tmp_path / f"u{fmt}.wav"
        write_sphere(str(p), s, 16000, byte_format=fmt)
        assert p.stat().st_size == 1024 + 2 * s.size
        assert sniff_audio(str(p)) == "nist"
        got, rate = read_sphere(str(p))
        assert rate == 16000
        np.testing.assert_array_equal(got, s)


def test_sphere_rejects_shorten_and_truncation(tmp_path):
    from nnet_asr_tpu.io.wav import read_sphere, write_sphere
    s = _tone(500)
    p = tmp_path / "sh.wav"
    write_sphere(str(p), s, 16000)
    raw = p.read_bytes().replace(b"sample_coding -s3 pcm",
                                 b"sample_coding -s18 pcm,embedded-short")
    p.write_bytes(raw)
    with pytest.raises(ValueError, match="shorten"):
        read_sphere(str(p))

    p2 = tmp_path / "tr.wav"
    write_sphere(str(p2), s, 16000)
    p2.write_bytes(p2.read_bytes()[:1024 + s.size])   # half the samples
    with pytest.raises(ValueError, match="Truncated SPHERE data"):
        read_sphere(str(p2))

    p3 = tmp_path / "no.wav"
    p3.write_bytes(b"RIFFxxxxWAVE")
    with pytest.raises(ValueError, match="Not a NIST SPHERE"):
        read_sphere(str(p3))


def test_thcopy_nist_source(tmp_path):
    """SOURCEFORMAT=NIST produces the same features as the RIFF WAV path
    for identical samples."""
    from nnet_asr_tpu.io.wav import write_sphere
    from nnet_asr_tpu.tools import thcopy
    s = _tone(1500)
    sph = tmp_path / "u.sph"
    write_sphere(str(sph), s, 16000)
    wav = tmp_path / "u.wav"
    write_wav(str(wav), s, 16000)
    base = (
        "SOURCEKIND   = WAVEFORM\nSOURCERATE   = 625\n"
        "TARGETKIND   = FBANK\nLOFREQ = 0\nHIFREQ = 8000\n"
        "NUMCHANS = 23\nUSEPOWER = T\nPREEMCOEF = 0\n"
        "TARGETRATE = 100000\nWINDOWSIZE = 250000\n")
    feats = {}
    for tag, fmtline, src in (("nist", "SOURCEFORMAT = NIST\n", sph),
                              ("wav", "SOURCEFORMAT = WAV\n", wav)):
        cfgf = tmp_path / f"{tag}.cfg"
        cfgf.write_text(base + fmtline)
        dst = tmp_path / f"{tag}.fea"
        assert thcopy.main(["thcopy", "-C", str(cfgf),
                            str(src), str(dst)]) == 0
        feats[tag] = htk.FeatureReader().read(str(dst))
    np.testing.assert_array_equal(feats["nist"], feats["wav"])


def test_prepare_from_wav_timit_tree(tmp_path):
    """A real-TIMIT-shaped tree (TEST/DR1/<SPK>/SA1.WAV SPHERE + .PHN,
    upper-case) prepares with reference naming <spk>_<base>, sa1/sa2
    excluded (prepare_timit.sh:23-26,58)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "prepare_from_wav", "/root/repo/examples/prepare_from_wav.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from nnet_asr_tpu.io.wav import write_sphere

    rng = np.random.default_rng(0)
    tree = tmp_path / "timit"
    for spk in ("FCJF0", "MDPK0"):
        d = tree / "TRAIN" / "DR1" / spk
        d.mkdir(parents=True)
        for sent in ("SA1", "SX101"):
            wav, segs = mod.synth_toy_wav(rng, 4)
            write_sphere(str(d / f"{sent}.WAV"), wav, 16000)
            # sample-indexed .phn triples (upper-case file name)
            with open(d / f"{sent}.PHN", "w") as f:
                for s0, e0, ph in segs:
                    f.write(f"{s0} {e0} {ph}\n")
    w = tmp_path / "work"
    rc = mod.main([str(tree), str(w)])
    assert rc == 0
    feas = sorted(p.name for p in (w / "fea").iterdir())
    assert feas == ["fcjf0_sx101.fea", "mdpk0_sx101.fea"]   # sa1 dropped
    mlf = (w / "mlfs" / "ref.mlf").read_text()
    assert "fcjf0_sx101.lab" in mlf

    # --include-sa keeps the dialect sentences
    w2 = tmp_path / "work2"
    assert mod.main([str(tree), str(w2), "--include-sa"]) == 0
    assert len(list((w2 / "fea").iterdir())) == 4


def test_thcopy_nohead_byte_order_semantics(tmp_path):
    """NATURALREADORDER=TRUE means machine-natural little-endian on x86
    (TFeaCat.cc:139 swap = !GetBool(NATURALREADORDER, IsBigEndian()));
    BYTEORDER=VAX also means little; neither set defaults to HTK's
    big-endian.  NATURALREADORDER=TRUE must therefore match BYTEORDER=VAX
    bit-for-bit and differ from the no-config default."""
    from nnet_asr_tpu.tools import thcopy
    s = _tone(1000)
    raw = tmp_path / "u.raw"
    raw.write_bytes(s.astype("<i2").tobytes())
    base = (
        "SOURCEKIND   = WAVEFORM\nSOURCEFORMAT = NOHEAD\n"
        "SOURCERATE   = 625\nTARGETKIND   = FBANK\nLOFREQ = 0\n"
        "HIFREQ = 8000\nNUMCHANS = 23\nUSEPOWER = T\nPREEMCOEF = 0\n"
        "TARGETRATE = 100000\nWINDOWSIZE = 250000\n")
    outs = {}
    for tag, extra in (("vax", "BYTEORDER = VAX\n"),
                       ("nat", "NATURALREADORDER = TRUE\n"),
                       ("dflt", "")):
        cfgf = tmp_path / f"{tag}.cfg"
        cfgf.write_text(base + extra)
        dst = tmp_path / f"{tag}.fea"
        assert thcopy.main(["thcopy", "-C", str(cfgf),
                            str(raw), str(dst)]) == 0
        outs[tag] = htk.FeatureReader().read(str(dst))
    np.testing.assert_array_equal(outs["vax"], outs["nat"])
    assert not np.array_equal(outs["vax"], outs["dflt"])


def test_sniff_audio_detects_htk_waveform(tmp_path):
    """HTK WAVEFORM files must not be misread as headerless raw by the
    auto-dispatch (code-review r5): the 12-byte header would become 6
    bogus samples."""
    import struct as _struct

    from nnet_asr_tpu.io.wav import read_audio_auto, sniff_audio
    s = _tone(600)
    p = tmp_path / "u.htkwav"
    hdr = _struct.pack(">iihH", s.size, 625, 2, 0)
    p.write_bytes(hdr + s.astype(">i2").tobytes())
    assert sniff_audio(str(p)) == "htk-be"
    got, rate = read_audio_auto(str(p))
    assert rate == 16000
    np.testing.assert_array_equal(got, s)
    # little-endian variant
    p2 = tmp_path / "u2.htkwav"
    p2.write_bytes(_struct.pack("<iihH", s.size, 625, 2, 0)
                   + s.astype("<i2").tobytes())
    assert sniff_audio(str(p2)) == "htk-le"
    # raw PCM stays raw
    p3 = tmp_path / "u3.raw"
    p3.write_bytes(s.astype("<i2").tobytes())
    assert sniff_audio(str(p3)) == "raw"


def test_prepare_from_wav_prefers_wav_over_sph(tmp_path):
    """SA1.sph next to SA1.wav (in-place-converted tree) must not
    hard-fail on name collision — the .wav wins."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "prepare_from_wav2", "/root/repo/examples/prepare_from_wav.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from nnet_asr_tpu.io.wav import write_sphere, write_wav as _ww

    rng = np.random.default_rng(1)
    d = tmp_path / "tree" / "TRAIN" / "DR1" / "FAAA0"
    d.mkdir(parents=True)
    wav, segs = mod.synth_toy_wav(rng, 3)
    write_sphere(str(d / "SX9.sph"), wav, 16000)
    _ww(str(d / "SX9.wav"), wav, 16000)
    with open(d / "SX9.PHN", "w") as f:
        for s0, e0, ph in segs:
            f.write(f"{s0} {e0} {ph}\n")
    w = tmp_path / "work"
    assert mod.main([str(tmp_path / "tree"), str(w)]) == 0
    assert sorted(p.name for p in (w / "fea").iterdir()) == ["faaa0_sx9.fea"]
