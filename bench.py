"""Benchmark: frame-CE training throughput of the flagship MLP3 on one GPU.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "production_tflops", "device"}.

Workload = example-01's training configuration (598->1024->135 MLP, bunch
960, fused fwd+bwd+SGD step), measured as trained frames/second. vs_baseline
compares against the reference CPU binary's throughput on the same workload
(TNet multithreaded, GotoBLAS; BASELINE_MEASURED.md).

``production_tflops`` is the slope-timed full train step (fwd+bwd+SGD,
donated state) at the production shapes 1024->4096^4->8192, bunch 1024.
Slope timing: two runtime window sizes of ONE compiled fori_loop program;
the fixed dispatch and synchronisation cost cancels in the difference.
No peak rate is assumed for any device.

Needs a GPU: on any other backend it exits non-zero.
"""

import json
import subprocess
import time

import numpy as np

REFERENCE_BASELINE_FPS = 1754.0  # measured: reference TNet CPU binary (system BLAS,
# 2-core container, THREADS=4, example-01 workload) — see BASELINE_MEASURED.md


def _production_metric():
    """Slope-timed production-shape train step -> TFLOP/s."""
    import jax
    import jax.numpy as jnp

    from nnet_asr_tpu.models import (BiasedLinearity, Network, Sigmoid,
                                     Softmax)
    from nnet_asr_tpu.ops.objectives import xent_loss_and_stats
    from nnet_asr_tpu.train.sgd import SgdConfig, apply_updates
    from nnet_asr_tpu.train.trainer import Trainer, TrainerConfig

    dims = [1024, 4096, 4096, 4096, 4096, 8192]
    bunch = 1024
    rng = np.random.default_rng(7)
    specs, params = [], []
    for i in range(len(dims) - 1):
        specs.append(BiasedLinearity(dims[i], dims[i + 1]))
        params.append({
            "weight": (0.05 * rng.standard_normal(
                (dims[i], dims[i + 1]))).astype(np.float32),
            "bias": np.zeros(dims[i + 1], np.float32)})
        if i < len(dims) - 2:
            specs.append(Sigmoid(dims[i + 1], dims[i + 1]))
            params.append({})
    specs.append(Softmax(dims[-1], dims[-1]))
    params.append({})
    net = Network(tuple(specs), params)
    cfg = TrainerConfig(bunchsize=bunch, cachesize=bunch, seed=1,
                        randomize=False,
                        sgd=SgdConfig(learning_rate=0.01))
    tr = Trainer(net, cfg)

    x = jnp.asarray((0.1 * rng.standard_normal(
        (bunch, dims[0]))).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, dims[-1], bunch).astype(np.int32))
    body_specs = net.specs[:-1]

    def loss_fn(params, xx, lab):
        for spec, p in zip(body_specs, params[:-1]):
            xx = spec.apply(p, xx)
        return xent_loss_and_stats(xx, lab)

    def mega(params, velocity, acc, m):
        def body(_, c):
            p, v, a = c
            (_, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                p, x, labels)
            p, v = apply_updates(net, p, v, grads, cfg.sgd, bunch,
                                 tr.factors)
            return p, v, {k: a[k] + stats[k] for k in a}
        return jax.lax.fori_loop(0, m, body, (params, velocity, acc))

    jf = jax.jit(mega, donate_argnums=(0, 1, 2))
    state = (jax.device_put(tr.params), jax.device_put(tr.velocity),
             tr._zero_acc())
    # compile + warm (runtime m: same program for every window size)
    state = jax.block_until_ready(jf(*state, jnp.int32(2)))

    def timed(m, reps=4):
        nonlocal state
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            state = jax.block_until_ready(jf(*state, jnp.int32(m)))
            best = min(best, time.perf_counter() - t0)
        return best

    M1, M2 = 32, 128
    t1 = timed(M1)
    t2 = timed(M2)
    per_step = (t2 - t1) / (M2 - M1)
    n_params = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    return round(3 * 2 * n_params * bunch / per_step / 1e12, 1)


def main():
    import jax
    import jax.numpy as jnp

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{devices[0].platform!r}")
    from nnet_asr_tpu import enable_compilation_cache
    enable_compilation_cache()
    from nnet_asr_tpu.models import (BiasedLinearity, Network, Sigmoid,
                                     Softmax)
    from nnet_asr_tpu.train.sgd import SgdConfig
    from nnet_asr_tpu.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(0)
    n_in, n_hid, n_out = 598, 1024, 135
    specs = (BiasedLinearity(n_in, n_hid), Sigmoid(n_hid, n_hid),
             BiasedLinearity(n_hid, n_out), Softmax(n_out, n_out))
    params = [
        {"weight": (0.1 * rng.standard_normal((n_in, n_hid))).astype(np.float32),
         "bias": np.zeros(n_hid, np.float32)},
        {},
        {"weight": (0.1 * rng.standard_normal((n_hid, n_out))).astype(np.float32),
         "bias": np.zeros(n_out, np.float32)},
        {},
    ]
    net = Network(specs, params)

    bunch = 960
    nb = 15                      # one reference cache (CACHESIZE=14400)
    cfg = TrainerConfig(
        bunchsize=bunch, cachesize=bunch * nb, seed=123, randomize=False,
        sgd=SgdConfig(learning_rate=0.008, grad_div_frm=False))
    tr = Trainer(net, cfg)

    feats_all = jnp.asarray(
        (0.1 * rng.standard_normal((nb, bunch, n_in))).astype(np.float32))
    labels_all = jnp.asarray(
        rng.integers(0, n_out, (nb, bunch)).astype(np.int32))

    # compile + warmup (scan-drain: whole cache in one XLA program)
    acc = tr._zero_acc()
    for _ in range(2):
        tr.params, tr.velocity, acc = tr._drain_train(
            tr.params, tr.velocity, acc, feats_all, labels_all)
    jax.block_until_ready(tr.params)

    # M whole-cache drains inside one XLA call (fori_loop around the
    # scan-drain), so that per-call dispatch is a small part of the window
    def mega(params, velocity, acc, M):
        def body(_, carry):
            p, v, a = carry
            return drain(p, v, a, feats_all, labels_all)
        return jax.lax.fori_loop(0, M, body, (params, velocity, acc))

    drain = tr._drain_train
    mega = jax.jit(mega, static_argnums=(3,), donate_argnums=(0, 1, 2))

    # size M so one timed run is ~1.2s of device work (compile first)
    state = jax.block_until_ready(mega(tr.params, tr.velocity, acc, 16))
    t0 = time.perf_counter()
    state = jax.block_until_ready(mega(*state, 16))
    per_drain = (time.perf_counter() - t0) / 16
    M = max(16, min(2048, int(1.2 / max(per_drain, 1e-5))))
    state = jax.block_until_ready(mega(*state, M))          # compile

    best = float("inf")
    budget_end = time.perf_counter() + 90.0
    for _ in range(8):
        t0 = time.perf_counter()
        state = jax.block_until_ready(mega(*state, M))
        best = min(best, time.perf_counter() - t0)
        if time.perf_counter() > budget_end:
            break
    fps = M * nb * bunch / best

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {
        "metric": "mlp3_train_frames_per_sec",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / REFERENCE_BASELINE_FPS, 3),
        "production_tflops": _production_metric(),
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
    }
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
