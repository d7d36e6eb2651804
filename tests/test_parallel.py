"""Sharded-step tests on the virtual 8-device CPU mesh: dp/mp parity with
the single-chip trainer."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nnet_asr_tpu.models import BiasedLinearity, Network, Sigmoid, Softmax
from nnet_asr_tpu.parallel.mesh import make_mesh
from nnet_asr_tpu.parallel.sharded_step import (ShardedTrainState,
                                                make_sharded_train_step,
                                                zero_acc)
from nnet_asr_tpu.train.sgd import SgdConfig
from nnet_asr_tpu.train.trainer import Trainer, TrainerConfig


def _mlp(rng, din=16, dh=32, dout=24):
    specs = (BiasedLinearity(din, dh), Sigmoid(dh, dh),
             BiasedLinearity(dh, dout), Softmax(dout, dout))
    params = [
        {"weight": (0.1 * rng.standard_normal((din, dh))).astype(np.float32),
         "bias": np.zeros(dh, np.float32)},
        {},
        {"weight": (0.1 * rng.standard_normal((dh, dout))).astype(np.float32),
         "bias": np.zeros(dout, np.float32)},
        {},
    ]
    return Network(specs, params)


def _run_reference(net, bunches, sgd_cfg):
    cfg = TrainerConfig(bunchsize=bunches[0][0].shape[0],
                        cachesize=bunches[0][0].shape[0] * len(bunches),
                        randomize=False, sgd=sgd_cfg)
    tr = Trainer(net, cfg)
    for X, labels in bunches:
        acc = tr._zero_acc()
        tr.params, tr.velocity, acc = tr._train_step(
            tr.params, tr.velocity, acc, jnp.asarray(X), jnp.asarray(labels))
        tr._merge_acc(acc)
    return tr


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_single_chip(data, model):
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    rng = np.random.default_rng(0)
    net = _mlp(rng)
    sgd_cfg = SgdConfig(learning_rate=0.05, momentum=0.5, weightcost=1e-4,
                        grad_div_frm=True)
    bunches = []
    for _ in range(3):
        X = rng.standard_normal((32, 16)).astype(np.float32)
        labels = rng.integers(0, 24, 32).astype(np.int32)
        bunches.append((X, labels))

    ref = _run_reference(net, bunches, sgd_cfg)

    mesh = make_mesh(data=data, model=model)
    state, step, evalf, _ = make_sharded_train_step(net, sgd_cfg, mesh)
    state.to_device(mesh)
    acc = zero_acc()
    with jax.default_matmul_precision("highest"):
        for X, labels in bunches:
            state.params, state.velocity, acc = step(
                state.params, state.velocity, acc,
                jnp.asarray(X), jnp.asarray(labels))

    for i in (0, 2):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(
                np.asarray(state.params[i][k]), np.asarray(ref.params[i][k]),
                rtol=3e-4, atol=1e-6,
                err_msg=f"layer {i} {k} mesh {data}x{model}")
    assert int(acc["correct"]) == ref.stats.corr
    assert int(acc["frames"]) == ref.stats.frames
    assert abs(float(acc["xent"]) - ref.stats.error) < 0.05


def _mlp_head(rng, head, din=16, dh=32, dout=21):
    from nnet_asr_tpu.models import BlockSoftmax
    if head == "blocksoftmax":
        top = BlockSoftmax(dout, dout, dims=(8, 6, 7))
    elif head == "softmax":
        top = Softmax(dout, dout)
    else:
        top = None
    specs = (BiasedLinearity(din, dh), Sigmoid(dh, dh),
             BiasedLinearity(dh, dout)) + ((top,) if top else ())
    params = [
        {"weight": (0.1 * rng.standard_normal((din, dh))).astype(np.float32),
         "bias": np.zeros(dh, np.float32)},
        {},
        {"weight": (0.1 * rng.standard_normal((dh, dout))).astype(np.float32),
         "bias": np.zeros(dout, np.float32)},
    ] + ([{}] if top else [])
    return Network(specs, params)


def _run_reference_obj(net, bunches, sgd_cfg, objective):
    cfg = TrainerConfig(bunchsize=bunches[0][0].shape[0],
                        cachesize=bunches[0][0].shape[0] * len(bunches),
                        randomize=False, sgd=sgd_cfg, objective=objective)
    tr = Trainer(net, cfg)
    for X, labels in bunches:
        acc = tr._zero_acc()
        tr.params, tr.velocity, acc = tr._train_step(
            tr.params, tr.velocity, acc, jnp.asarray(X), jnp.asarray(labels))
        tr._merge_acc(acc)
    return tr


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4), (1, 8)])
def test_sharded_padded_senones(data, model):
    """n_out=21 doesn't divide the model axis: auto-padding with masked CE
    must reproduce the single-chip trajectory exactly (the round-1 fix:
    tnet --MESH on the real 135-senone example-01 model)."""
    rng = np.random.default_rng(3)
    net = _mlp_head(rng, "softmax")          # dout=21, not divisible by 2/4
    sgd_cfg = SgdConfig(learning_rate=0.05, momentum=0.5, weightcost=1e-4,
                        grad_div_frm=True)
    bunches = [(rng.standard_normal((32, 16)).astype(np.float32),
                rng.integers(0, 21, 32).astype(np.int32)) for _ in range(3)]
    ref = _run_reference_obj(net, bunches, sgd_cfg, "xent")

    mesh = make_mesh(data=data, model=model)
    state, step, evalf, _ = make_sharded_train_step(net, sgd_cfg, mesh)
    assert state.n_out_pad == -(-21 // model) * model
    state.to_device(mesh)
    acc = zero_acc()
    with jax.default_matmul_precision("highest"):
        for X, labels in bunches:
            state.params, state.velocity, acc = step(
                state.params, state.velocity, acc,
                jnp.asarray(X), jnp.asarray(labels))
    host = state.host_params()
    for i in (0, 2):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(
                host[i][k], np.asarray(ref.params[i][k]),
                rtol=3e-4, atol=1e-6,
                err_msg=f"layer {i} {k} mesh {data}x{model}")
    # padded columns never moved off zero
    padded_w = np.asarray(state.params[2]["weight"])[:, 21:]
    assert padded_w.shape[1] == state.n_out_pad - 21
    np.testing.assert_array_equal(padded_w, 0.0)
    assert int(acc["correct"]) == ref.stats.corr
    assert abs(float(acc["xent"]) - ref.stats.error) < 0.05


@pytest.mark.parametrize("head,objective", [
    ("blocksoftmax", "xent"),     # BlockSoftmax CE (Activation.cc:55-133)
    ("softmax", "mse"),           # MSE through terminal softmax (identity bwd)
    ("bare", "mse"),              # MSE on a bare linear output
])
def test_sharded_gathered_heads(head, objective):
    """BlockSoftmax and MSE heads under the mesh: all-gathered logits must
    reproduce the single-chip trainer's trajectory."""
    rng = np.random.default_rng(4)
    net = _mlp_head(rng, head)
    sgd_cfg = SgdConfig(learning_rate=0.05, momentum=0.5, weightcost=1e-4,
                        grad_div_frm=True)
    bunches = [(rng.standard_normal((24, 16)).astype(np.float32),
                rng.integers(0, 21, 24).astype(np.int32)) for _ in range(3)]
    ref = _run_reference_obj(
        Network(net.specs, [dict(p) for p in net.params]), bunches, sgd_cfg,
        objective)

    mesh = make_mesh(data=2, model=4)        # 21 % 4 != 0: also pads
    state, step, evalf, _ = make_sharded_train_step(
        net, sgd_cfg, mesh, objective=objective)
    state.to_device(mesh)
    acc = zero_acc(objective)
    with jax.default_matmul_precision("highest"):
        for X, labels in bunches:
            state.params, state.velocity, acc = step(
                state.params, state.velocity, acc,
                jnp.asarray(X), jnp.asarray(labels))
    host = state.host_params()
    for i in (0, 2):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(
                host[i][k], np.asarray(ref.params[i][k]),
                rtol=3e-4, atol=2e-6, err_msg=f"layer {i} {k} ({head})")
    if objective == "xent":
        assert int(acc["correct"]) == ref.stats.corr
        assert abs(float(acc["xent"]) - ref.stats.error) < 0.05
    else:
        assert abs(float(acc["mse"]) - ref.stats.error) < 0.05
    assert int(acc["frames"]) == ref.stats.frames


@pytest.mark.parametrize("cdt,rtol", [
    ("bf16", 2e-2),      # bf16 matmuls: shard-count-dependent rounding
    ("int8", 3e-4),      # fake-quant in f32: per-tensor scale pmax'd global
    ("int8pf", 3e-4),    # per-frame scale is shard-local by construction
    ("int8pfsr", 3e-4),  # SR draws at the GLOBAL bunch shape, row-sliced
])
def test_sharded_compute_dtype_matches_single_chip(cdt, rtol):
    """--COMPUTEDTYPE under --MESH must actually quantize (it was
    once silently ignored) and track the single-chip trajectory.
    int8pfsr additionally requires the mesh's stochastic-rounding draws
    to be bit-identical to the single chip's."""
    rng = np.random.default_rng(7)
    net = _mlp(rng)
    sgd_cfg = SgdConfig(learning_rate=0.05, momentum=0.5, grad_div_frm=True)
    bunches = [(rng.standard_normal((32, 16)).astype(np.float32),
                rng.integers(0, 24, 32).astype(np.int32)) for _ in range(3)]

    cfg = TrainerConfig(bunchsize=32, cachesize=96, randomize=False,
                        sgd=sgd_cfg, compute_dtype=cdt)
    ref = Trainer(Network(net.specs, [dict(p) for p in net.params]), cfg)
    for X, labels in bunches:
        acc = ref._zero_acc()
        ref.params, ref.velocity, acc = ref._train_step(
            ref.params, ref.velocity, acc, jnp.asarray(X), jnp.asarray(labels))
        if "_sr_key" in acc:          # per-step advance, as in the epoch loop
            ref._sr_key = acc["_sr_key"]
        ref._merge_acc(acc)

    mesh = make_mesh(data=4, model=2)
    state, step, evalf, _ = make_sharded_train_step(
        net, sgd_cfg, mesh, compute_dtype=cdt)
    state.to_device(mesh)
    acc = zero_acc()
    sr_key = jax.random.PRNGKey(cfg.seed or 1)
    with jax.default_matmul_precision("highest"):
        for X, labels in bunches:
            if cdt == "int8pfsr":
                acc["_sr_key"] = jnp.array(sr_key, copy=True)
            state.params, state.velocity, acc = step(
                state.params, state.velocity, acc,
                jnp.asarray(X), jnp.asarray(labels))
            if "_sr_key" in acc:
                sr_key = acc.pop("_sr_key")
    for i in (0, 2):
        for k in ("weight", "bias"):
            np.testing.assert_allclose(
                np.asarray(state.params[i][k]), np.asarray(ref.params[i][k]),
                rtol=rtol, atol=rtol * 0.1,
                err_msg=f"layer {i} {k} compute_dtype={cdt}")
    # the quantized trajectory must DIFFER from an f32 run (proof the knob
    # is live on the mesh, not silently f32)
    f32_state, f32_step, _, _ = make_sharded_train_step(net, sgd_cfg, mesh)
    f32_state.to_device(mesh)
    acc2 = zero_acc()
    with jax.default_matmul_precision("highest"):
        for X, labels in bunches:
            f32_state.params, f32_state.velocity, acc2 = f32_step(
                f32_state.params, f32_state.velocity, acc2,
                jnp.asarray(X), jnp.asarray(labels))
    assert not np.allclose(np.asarray(state.params[0]["weight"]),
                           np.asarray(f32_state.params[0]["weight"]),
                           rtol=1e-7, atol=1e-9)


def test_sharded_compute_dtype_rejects_int8full():
    rng = np.random.default_rng(8)
    net = _mlp(rng)
    mesh = make_mesh(data=4, model=2)
    with pytest.raises(ValueError, match="int8full"):
        make_sharded_train_step(net, SgdConfig(), mesh,
                                compute_dtype="int8full")


def test_sharded_eval():
    rng = np.random.default_rng(1)
    net = _mlp(rng)
    mesh = make_mesh(data=2, model=4)
    state, step, evalf, _ = make_sharded_train_step(net, SgdConfig(), mesh)
    state.to_device(mesh)
    X = rng.standard_normal((16, 16)).astype(np.float32)
    labels = rng.integers(0, 24, 16).astype(np.int32)
    acc = evalf(state.params, zero_acc(), jnp.asarray(X), jnp.asarray(labels))
    # oracle
    import oracle
    y = oracle.forward_network(net, X)
    T = np.eye(24, dtype=np.float32)[labels]
    _, xent, corr = oracle.cross_entropy_eval(y, T)
    assert int(acc["correct"]) == corr
    assert abs(float(acc["xent"]) - xent) < 1e-2


def test_scaling_batch_shard_shapes():
    """Sharded batch really is split: local shard sees bunch/data rows."""
    mesh = make_mesh(data=8, model=1)
    from jax.sharding import NamedSharding, PartitionSpec as P
    x = jnp.zeros((64, 16))
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    assert xs.addressable_shards[0].data.shape == (8, 16)
