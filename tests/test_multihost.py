"""Real 2-process jax.distributed training over an 8-device CPU fleet.

Two subprocesses with 4 virtual CPU devices each form one (data × model)
mesh via jax.distributed; each process feeds ONLY its own utterance shard
(per-host input sharding). The parent replays the exact same global bunch
sequence single-process (8 virtual devices) and asserts the final params
match — proving the multi-host path (make_array_from_process_local_data
assembly + drain negotiation + collectives across processes) computes the
same training trajectory as the single-process mesh.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_fleet(tmpdir, data, model):
    port = _free_port()
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    # repo PYTHONPATH + forced CPU: each
    # process gets 4 virtual devices, the fleet has 8
    env["PYTHONPATH"] = f"{REPO}:{HERE}"
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["NNET_ASR_NO_COMPILE_CACHE"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_driver.py"),
             str(pid), str(port), str(tmpdir), str(data), str(model)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"driver failed:\n{out}"
    return outs


def _oracle_replay(data, model):
    """Single-process replay of the exact global bunch sequence the two
    hosts produce: two local caches (same seed, per-host utterance shards,
    lockstep min-bunch negotiation), global bunch = concat(host0, host1)
    along the bunch axis (process 0 owns data-axis shards 0..3)."""
    import jax

    import multihost_driver as drv
    from nnet_asr_tpu.parallel.mesh import make_mesh
    from nnet_asr_tpu.parallel.sharded_step import (make_sharded_train_step,
                                                    zero_acc)
    from nnet_asr_tpu.train.cache import DeviceFrameCache
    from nnet_asr_tpu.train.pipeline import TransformPipeline

    net = drv.build_net()
    cfg = drv.trainer_config()
    utts = drv.synth_corpus()
    B_loc = cfg.bunchsize // 2
    C_loc = cfg.cachesize // 2
    pipe = TransformPipeline(None, 0, 0)

    streams = []
    for pid in range(2):
        cache = DeviceFrameCache(C_loc, B_loc, cfg.seed, cfg.randomize)
        feats = [np.asarray(f, np.float32) for f, _ in utts[pid::2]]
        labels = [np.asarray(l, np.int32) for _, l in utts[pid::2]]
        rows, valid = pipe.transform_block(feats)
        cache.add_block(rows, valid, np.concatenate(labels))
        streams.append(cache)

    mesh = make_mesh(data=data, model=model)
    # same scan_unroll as ShardedTrainer builds from cfg, so the oracle's
    # drain is the identical XLA program shape
    state, step, evalf, fns = make_sharded_train_step(
        net, cfg.sgd, mesh, scan_unroll=cfg.scan_unroll)
    state.to_device(mesh)
    total_stats = {"frames": 0, "corr": 0, "xent": 0.0}
    with jax.default_matmul_precision("highest"):
        while True:
            offers = [min(c.rows, c.cachesize) // B_loc for c in streams]
            agreed = min(offers)
            if agreed == 0:
                break
            parts = [c.take_stacked(max_bunches=agreed) for c in streams]
            feats_all = np.concatenate(
                [np.asarray(p[0]) for p in parts], axis=1)
            labels_all = np.concatenate(
                [np.asarray(p[1]) for p in parts], axis=1)
            acc = zero_acc()
            state.params, state.velocity, acc = fns["drain_train"](
                state.params, state.velocity, acc,
                jax.device_put(feats_all, jax.NamedSharding(
                    mesh, jax.sharding.PartitionSpec(None, "data", None))),
                jax.device_put(labels_all, jax.NamedSharding(
                    mesh, jax.sharding.PartitionSpec(None, "data"))))
            total_stats["frames"] += int(acc["frames"])
            total_stats["corr"] += int(acc["correct"])
            total_stats["xent"] += float(acc["xent"])
    return state.host_params(), total_stats


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2)])
def test_two_process_distributed_matches_single(tmp_path, data, model):
    outs = _run_fleet(tmp_path, data, model)

    p0 = np.load(tmp_path / "params_p0.npz")
    p1 = np.load(tmp_path / "params_p1.npz")
    # both processes hold identical final params (replicated/allgathered)
    for k in ("w0", "b0", "w2", "b2"):
        np.testing.assert_array_equal(p0[k], p1[k])
    s0 = json.load(open(tmp_path / "stats_p0.json"))
    s1 = json.load(open(tmp_path / "stats_p1.json"))
    assert s0["frames"] == s1["frames"] > 0
    # per-host reading really happened: each host read only its shard
    assert s0["local_frames_read"] != s1["local_frames_read"]
    assert s0["local_frames_read"] + s1["local_frames_read"] >= s0["frames"]

    oracle_params, oracle_stats = _oracle_replay(data, model)
    assert s0["frames"] == oracle_stats["frames"]
    assert s0["corr"] == oracle_stats["corr"]
    assert abs(s0["xent"] - oracle_stats["xent"]) < 0.05
    np.testing.assert_allclose(p0["w0"], oracle_params[0]["weight"],
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(p0["w2"], oracle_params[2]["weight"],
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(p0["b2"], oracle_params[2]["bias"],
                               rtol=2e-4, atol=1e-6)
