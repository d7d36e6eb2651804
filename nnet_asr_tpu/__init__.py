"""nnet_asr_tpu — a hybrid NN/HMM ASR training framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of
troylee/nnet-asr (TNet v1.8 fork): HTK feature pipelines, MLP frame
classifiers with cross-entropy/MSE training, RBM CD-1 pretraining,
recurrent nets with truncated BPTT, and MPE lattice sequence training,
plus the HTK/STK interop surface (HTK features, MLFs, ASCII MMF models)
so the reference decode pipeline (HVite GMM-bypass) validates outputs.

Layer map:
  io/        host-side formats: HTK features, MLF, SCP, label maps, MMF text
  ops/       jittable array ops: objectives, affine folding, int8 numerics
  models/    components + networks as pure functions over pytrees
  train/     caches, SGD semantics, trainers, newbob scheduling
  parallel/  mesh construction, data-parallel & senone-sharded steps
  utils/     HTK-style config system, timing/profiling, logging
  tools/     CLI entry points mirroring the reference binaries
"""

__version__ = "0.1.0"


def compilation_cache_dir() -> str:
    """Directory of the persistent XLA compilation cache.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set; otherwise ``.jax_cache``
    at the root of the checkout. The path is fixed because it is part of
    the cache key: a directory that moves never hits."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def enable_compilation_cache():
    """Turn on the persistent XLA compilation cache at
    ``compilation_cache_dir()`` and return that directory, or None when
    NNET_ASR_NO_COMPILE_CACHE is set.

    Called by the CLI entry points (tools/*.py main), bench.py and
    chip_smoke.py — NOT at package import: mutating global jax config is
    too intrusive a side effect for processes that import nnet_asr_tpu as
    a library."""
    import os

    import jax

    if os.environ.get("NNET_ASR_NO_COMPILE_CACHE"):
        return None
    path = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
