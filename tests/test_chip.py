"""chip_smoke.py's phases as tests on an NVIDIA GPU.

Skips where JAX finds no GPU. On a machine with one card:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_chip.py -m gpu -q

(one process: a second JAX process on the card would find its memory
taken).
"""

import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu(chip_smoke):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX is on {devices[0].platform}")
    return devices


@pytest.fixture(scope="module")
def corpus(gpu, chip_smoke, tmp_path_factory):
    return chip_smoke.phase_corpus(str(tmp_path_factory.mktemp("chip")))


def test_frame_ce_resident_and_tools(chip_smoke, corpus):
    model, _ = chip_smoke.phase_frame_ce(corpus)
    chip_smoke.phase_resident(corpus)
    chip_smoke.phase_other_tools(corpus, model)


def test_production_drain(chip_smoke, gpu):
    chip_smoke.phase_production()


def test_reference_comparison(chip_smoke, gpu):
    chip_smoke.phase_reference()


def test_plain_xla_times(chip_smoke, gpu):
    chip_smoke.phase_plain_xla()
