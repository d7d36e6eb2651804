"""Network components as static specs + pure functions over param pytrees.

JAX re-design of the reference component zoo. Where TNet models a
network as a linked list of stateful C++ objects with per-layer buffers
(TNetLib/Component.h:24-171, CuTNetLib/cuComponent.h:27-175), here each
component is a *frozen spec* (static, hashable — safe to close over in
``jax.jit``) plus a dict of parameter arrays (a pytree leaf group). Forward
passes are pure ``apply(params, x)`` functions; backward passes come from
``jax.grad`` (and match the reference's hand-written gradients analytically,
e.g. softmax+CE's fused ``err = y - t``).

Serialization follows the reference's ASCII MMF tag format exactly
(``<tag> nOutputs nInputs`` + params; weight matrices stored transposed,
SNet legacy — TNetLib/BiasedLinearity.cc:37-58) so the same model files
drive either implementation. Component tag inventory = union of the CPU
factory's 13 tags (TNetLib/Nnet.cc:243-288) and the GPU factory's 18
(CuTNetLib/cuNetwork.cc:251-308).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, TextIO, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..io import mmf
from ..io.mmf import TokenStream

Params = Dict[str, jnp.ndarray]


# ---------------------------------------------------------------------------
# Base
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Component:
    """Static description of one layer. Parameters live in a separate dict."""

    n_inputs: int
    n_outputs: int

    tag: str = field(default="", init=False, repr=False)
    updatable: bool = False       # participates in SGD
    trainable_keys: Tuple[str, ...] = ()   # which param entries get gradients

    # --- compute -----------------------------------------------------------
    def apply(self, params: Params, x: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    # --- serialization -----------------------------------------------------
    @classmethod
    def read(cls, n_inputs: int, n_outputs: int, ts: TokenStream):
        """Parse params following the ``<tag> out in`` header. Returns (spec, params)."""
        return cls(n_inputs, n_outputs), {}

    def write(self, out: TextIO, params: Params) -> None:
        """Write params (header is written by the network serializer)."""

    # --- init --------------------------------------------------------------
    def init_params(self, rng: np.random.Generator) -> Params:
        return {}


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# Updatable affine layers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BiasedLinearity(Component):
    """Dense affine layer: y = x @ W + b, W: (in, out).

    Reference: TNetLib/BiasedLinearity.{h,cc}, CuTNetLib/cuBiasedLinearity.cc.
    MMF stores W transposed as (out, in).
    """

    tag = "<biasedlinearity>"
    updatable: bool = True
    trainable_keys: Tuple[str, ...] = ("weight", "bias")

    def apply(self, params: Params, x: jnp.ndarray) -> jnp.ndarray:
        return x @ params["weight"] + params["bias"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        wt = mmf.read_matrix(ts)          # stored (out, in)
        b = mmf.read_vector(ts)
        if wt.shape != (n_outputs, n_inputs) or b.shape != (n_outputs,):
            raise ValueError(
                f"Wrong dimensionalities in network file: inputs {n_inputs} "
                f"outputs {n_outputs} matrix {wt.shape} bias {b.shape}")
        return cls(n_inputs, n_outputs), {"weight": wt.T.copy(), "bias": b}

    def write(self, out, params):
        mmf.write_matrix(out, _np(params["weight"]).T)
        mmf.write_vector(out, _np(params["bias"]))
        out.write("\n")

    def init_params(self, rng):
        # gen_mlp_init.py --gauss default: w ~ 0.1*N(0,1), b = 0
        w = (0.1 * rng.standard_normal((self.n_inputs, self.n_outputs))).astype(np.float32)
        b = np.zeros(self.n_outputs, dtype=np.float32)
        return {"weight": w, "bias": b}


@dataclass(frozen=True)
class SharedLinearity(Component):
    """Block-tied affine: one (in/k, out/k) weight applied to k column blocks.

    Reference: TNetLib/SharedLinearity.cc:8-37, CuTNetLib/cuSharedLinearity.cc.
    """

    tag = "<sharedlinearity>"
    n_instances: int = 1
    updatable: bool = True
    trainable_keys: Tuple[str, ...] = ("weight", "bias")

    def apply(self, params, x):
        k = self.n_instances
        w = params["weight"]              # (in/k, out/k)
        b = params["bias"]                # (out/k,)
        B = x.shape[0]
        xs = x.reshape(B, k, self.n_inputs // k)
        ys = jnp.einsum("bki,io->bko", xs, w) + b[None, None, :]
        return ys.reshape(B, self.n_outputs)

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        k = int(ts.next())
        if k < 1 or n_inputs % k or n_outputs % k:
            raise ValueError(f"Bad number of instances: {k}")
        wt = mmf.read_matrix(ts)
        b = mmf.read_vector(ts)
        if wt.shape != (n_outputs // k, n_inputs // k) or b.shape != (n_outputs // k,):
            raise ValueError("Wrong shared-linearity dimensions in network file")
        return cls(n_inputs, n_outputs, n_instances=k), {"weight": wt.T.copy(), "bias": b}

    def write(self, out, params):
        out.write(f"{self.n_instances}\n")
        mmf.write_matrix(out, _np(params["weight"]).T)
        mmf.write_vector(out, _np(params["bias"]))
        out.write("\n")

    def init_params(self, rng):
        k = self.n_instances
        w = (0.1 * rng.standard_normal((self.n_inputs // k, self.n_outputs // k))).astype(np.float32)
        b = np.zeros(self.n_outputs // k, dtype=np.float32)
        return {"weight": w, "bias": b}


@dataclass(frozen=True)
class DiscreteLinearity(Component):
    """Block-diagonal affine: independent per-block weights.

    Reference: CuTNetLib/cuDiscreteLinearity.{h,cc}. Serialized as
    ``n_blocks`` then per-block transposed matrices, then one bias vector.
    """

    tag = "<discretelinearity>"
    block_dims: Tuple[Tuple[int, int], ...] = ()  # ((in_i, out_i), ...)
    updatable: bool = True
    trainable_keys: Tuple[str, ...] = ("weights", "bias")

    def apply(self, params, x):
        outs = []
        in_off = 0
        for i, (di, do) in enumerate(self.block_dims):
            outs.append(x[:, in_off:in_off + di] @ params["weights"][i])
            in_off += di
        y = jnp.concatenate(outs, axis=1)
        return y + params["bias"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        nb = int(ts.next())
        if nb < 1:
            raise ValueError(f"Bad number of blocks: {nb}")
        ws, dims = [], []
        for _ in range(nb):
            wt = mmf.read_matrix(ts)
            ws.append(wt.T.copy())
            dims.append((wt.shape[1], wt.shape[0]))
        b = mmf.read_vector(ts)
        if sum(d[0] for d in dims) != n_inputs or sum(d[1] for d in dims) != n_outputs \
                or b.shape != (n_outputs,):
            raise ValueError("Wrong discrete-linearity dimensions in network file")
        return cls(n_inputs, n_outputs, block_dims=tuple(dims)), \
            {"weights": [jnp.asarray(w) for w in ws], "bias": b}

    def write(self, out, params):
        out.write(f"{len(self.block_dims)}\n")
        for w in params["weights"]:
            mmf.write_matrix(out, _np(w).T)
        mmf.write_vector(out, _np(params["bias"]))
        out.write("\n")

    def init_params(self, rng):
        ws = [jnp.asarray((0.1 * rng.standard_normal((di, do))).astype(np.float32))
              for di, do in self.block_dims]
        return {"weights": ws, "bias": np.zeros(self.n_outputs, dtype=np.float32)}


@dataclass(frozen=True)
class SparseLinearity(Component):
    """Affine layer with a 0/1 sparsity mask on the weights + L1 support.

    Reference: CuTNetLib/cuSparseLinearity.{h,cc}. The mask multiplies the
    weights on every update; ``update_mask`` prunes |w| < 1e-3. Serialized as
    weight^T, bias, optional mask^T, optional accumulator matrix (ignored).
    """

    tag = "<sparselinearity>"
    updatable: bool = True
    trainable_keys: Tuple[str, ...] = ("weight", "bias")

    def apply(self, params, x):
        return x @ (params["weight"] * params["mask"]) + params["bias"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        wt = mmf.read_matrix(ts)
        b = mmf.read_vector(ts)
        if ts.peek() == "m":
            mask = mmf.read_matrix(ts).T.copy()
        else:
            mask = np.ones((n_inputs, n_outputs), dtype=np.float32)
        if ts.peek() == "m":
            mmf.read_matrix(ts)  # dummy accumulated-gradient matrix
        if wt.shape != (n_outputs, n_inputs) or b.shape != (n_outputs,):
            raise ValueError("Wrong sparse-linearity dimensions in network file")
        return cls(n_inputs, n_outputs), \
            {"weight": wt.T.copy(), "bias": b, "mask": mask}

    def write(self, out, params):
        # the reference prunes the mask when the model is written
        # (UpdateMask() from WriteToStream, cuSparseLinearity.cc:165-167)
        w = _np(params["weight"])
        mask = np.where(np.abs(w) < 1e-3, 0.0, _np(params["mask"]))
        mmf.write_matrix(out, w.T)
        mmf.write_vector(out, _np(params["bias"]))
        mmf.write_matrix(out, mask.astype(np.float32).T)
        out.write("\n")

    def init_params(self, rng):
        return {
            "weight": (0.1 * rng.standard_normal((self.n_inputs, self.n_outputs))).astype(np.float32),
            "bias": np.zeros(self.n_outputs, dtype=np.float32),
            "mask": np.ones((self.n_inputs, self.n_outputs), dtype=np.float32),
        }

    @staticmethod
    def update_mask(params: Params, threshold: float = 1e-3) -> Params:
        """Prune small weights into the mask (cuSparseLinearity.cc:66-95)."""
        mask = jnp.where(jnp.abs(params["weight"]) < threshold, 0.0, params["mask"])
        return {**params, "mask": mask}


@dataclass(frozen=True)
class ClusterLinearity(Component):
    """Cluster-adaptive affine (Troy's fork addition).

    Forward/backward behave exactly like BiasedLinearity on the *combined*
    weights (cuClusterLinearity.cc:9-21); the per-cluster transforms and the
    constant weights are carried through serialization. Per-cluster update
    is stubbed in the reference too (cuClusterLinearity.cc:56-67).
    Format (cuClusterLinearity.cc:95-253): n_instances; per cluster
    ``c n ids...`` + square xform^T + bias(in); const weight^T + bias(out);
    combined weight^T + bias(out).
    """

    tag = "<clusterlinearity>"
    n_instances: int = 1
    cluster_map: Tuple[Tuple[int, ...], ...] = ()
    updatable: bool = True
    trainable_keys: Tuple[str, ...] = ("weight", "bias")

    def apply(self, params, x):
        return x @ params["weight"] + params["bias"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        k = int(ts.next())
        if k < 1:
            raise ValueError(f"Bad number of instances: {k}")
        cmap, cw, cb = [], [], []
        for _ in range(k):
            tag = ts.next()
            n = int(ts.next())
            if tag != "c" or n < 1:
                raise ValueError(f"Bad cluster xform header: {tag} {n}")
            ids = tuple(int(ts.next()) for _ in range(n))
            cmap.append(ids)
            xt = mmf.read_matrix(ts)
            xb = mmf.read_vector(ts)
            if xt.shape != (n_inputs, n_inputs) or xb.shape != (n_inputs,):
                raise ValueError("Wrong cluster-xform dimensions in network file")
            cw.append(xt.T.copy())
            cb.append(xb)
        ct = mmf.read_matrix(ts)
        const_b = mmf.read_vector(ts)
        wt = mmf.read_matrix(ts)
        b = mmf.read_vector(ts)
        if wt.shape != (n_outputs, n_inputs) or ct.shape != (n_outputs, n_inputs):
            raise ValueError("Wrong cluster-linearity dimensions in network file")
        params = {
            "cluster_weights": [jnp.asarray(w) for w in cw],
            "cluster_biases": [jnp.asarray(v) for v in cb],
            "const_weight": ct.T.copy(), "const_bias": const_b,
            "weight": wt.T.copy(), "bias": b,
        }
        return cls(n_inputs, n_outputs, n_instances=k, cluster_map=tuple(cmap)), params

    def write(self, out, params):
        out.write(f"{self.n_instances}\n")
        for ids, w, b in zip(self.cluster_map, params["cluster_weights"],
                             params["cluster_biases"]):
            out.write("c " + " ".join(str(i) for i in (len(ids),) + ids) + "\n")
            mmf.write_matrix(out, _np(w).T)
            mmf.write_vector(out, _np(b))
        mmf.write_matrix(out, _np(params["const_weight"]).T)
        mmf.write_vector(out, _np(params["const_bias"]))
        mmf.write_matrix(out, _np(params["weight"]).T)
        mmf.write_vector(out, _np(params["bias"]))
        out.write("\n")


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Sigmoid(Component):
    """Reference: TNetLib/Activation.cc:7-25."""

    tag = "<sigmoid>"

    def apply(self, params, x):
        return jax.nn.sigmoid(x)


@dataclass(frozen=True)
class Softmax(Component):
    """Row-wise max-shifted softmax (TNetLib/Activation.cc:29-52).

    Backward through AD matches the reference's identity-backward because the
    CE objective pairs with it (err = y - t).
    """

    tag = "<softmax>"

    def apply(self, params, x):
        return jax.nn.softmax(x, axis=-1)


@dataclass(frozen=True)
class BlockSoftmax(Component):
    """Several softmaxes over disjoint output spans (multi-task).

    Reference: TNetLib/Activation.cc:55-133. The masked backward (error only
    for blocks whose error sums to ~0) falls out of AD: softmax-CE grad in a
    block with all-zero targets is identically zero.
    """

    tag = "<blocksoftmax>"
    dims: Tuple[int, ...] = ()

    def apply(self, params, x):
        outs = []
        off = 0
        for d in self.dims:
            outs.append(jax.nn.softmax(x[:, off:off + d], axis=-1))
            off += d
        return jnp.concatenate(outs, axis=1)

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        dims = tuple(int(v) for v in mmf.read_vector(ts, dtype=np.int32))
        if sum(dims) != n_outputs:
            raise ValueError(
                f"Non-matching dimension of sum of softmaxes: {sum(dims)} vs {n_outputs}")
        return cls(n_inputs, n_outputs, dims=dims), {}

    def write(self, out, params):
        mmf.write_vector(out, np.asarray(self.dims, dtype=np.int64))


# ---------------------------------------------------------------------------
# Feature-transform components (non-trainable)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Expand(Component):
    """Frame splicing: out row r = concat of rows r+o for o in offsets,
    edge-clamped. Reference: TNetLib/CRBEDctFeat.h:18-69.
    """

    tag = "<expand>"
    offsets: Tuple[int, ...] = ()

    def apply(self, params, x):
        # static shifted slices with edge replication — compiles to pure
        # slice/concat (no gather), which XLA fuses well
        T = x.shape[0]
        cols = []
        for off in self.offsets:
            if off < 0:
                k = min(-off, T)
                head = jnp.broadcast_to(x[0], (k, x.shape[1]))
                cols.append(jnp.concatenate([head, x[:T - k]], axis=0))
            elif off > 0:
                k = min(off, T)
                tail = jnp.broadcast_to(x[T - 1], (k, x.shape[1]))
                cols.append(jnp.concatenate([x[k:], tail], axis=0))
            else:
                cols.append(x)
        return jnp.concatenate(cols, axis=1)

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        offs = tuple(int(v) for v in mmf.read_vector(ts, dtype=np.int32))
        return cls(n_inputs, n_outputs, offsets=offs), {}

    def write(self, out, params):
        mmf.write_vector(out, np.asarray(self.offsets, dtype=np.int64))


@dataclass(frozen=True)
class Copy(Component):
    """Column gather by explicit indices (1-based on disk).

    Reference: TNetLib/CRBEDctFeat.h:76-132.
    """

    tag = "<copy>"
    indices: Tuple[int, ...] = ()   # 0-based

    def apply(self, params, x):
        return x[:, jnp.asarray(self.indices, dtype=jnp.int32)]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        idx = tuple(int(v) - 1 for v in mmf.read_vector(ts, dtype=np.int32))
        return cls(n_inputs, n_outputs, indices=idx), {}

    def write(self, out, params):
        mmf.write_vector(out, np.asarray(self.indices, dtype=np.int64) + 1)


@dataclass(frozen=True)
class Transpose(Component):
    """Band/time interleave permutation for splice+DCT pipelines.

    Reference: TNetLib/CRBEDctFeat.h:134-203. With context c and
    channels = N/c, output index i (= ch*c + t) gathers input idx = t*channels + ch.
    """

    tag = "<transpose>"
    context: int = 0

    def _perm(self):
        n = self.n_inputs
        channels = n // self.context
        perm = []
        for ch in range(channels):
            perm.extend(range(ch, n, channels))
        return perm

    def apply(self, params, x):
        return x[:, jnp.asarray(self._perm(), dtype=jnp.int32)]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        if n_inputs != n_outputs:
            raise ValueError("Input dim must be same as output dim")
        ctx = int(ts.next())
        return cls(n_inputs, n_outputs, context=ctx), {}

    def write(self, out, params):
        out.write(f" {self.context}\n")


@dataclass(frozen=True)
class BlockLinearity(Component):
    """Block-diagonal matmul by a single shared block (e.g. per-band DCT).

    Reference: TNetLib/CRBEDctFeat.h:210-288. MMF stores the block transposed.
    """

    tag = "<blocklinearity>"
    block_in: int = 0
    block_out: int = 0

    def apply(self, params, x):
        k = self.n_inputs // self.block_in
        B = x.shape[0]
        xs = x.reshape(B, k, self.block_in)
        ys = jnp.einsum("bki,io->bko", xs, params["block"])
        return ys.reshape(B, self.n_outputs)

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        bt = mmf.read_matrix(ts)          # stored (out_b, in_b)
        bo, bi = bt.shape
        if n_outputs % bo or n_inputs % bi or (n_outputs // bo) != (n_inputs // bi):
            raise ValueError("BlockLinearity matrix dimensions must divide IO dims")
        return cls(n_inputs, n_outputs, block_in=bi, block_out=bo), \
            {"block": bt.T.copy()}

    def write(self, out, params):
        mmf.write_matrix(out, _np(params["block"]).T)


@dataclass(frozen=True)
class Bias(Component):
    """Add a constant vector. Reference: TNetLib/CRBEDctFeat.h:292-339."""

    tag = "<bias>"

    def apply(self, params, x):
        return x + params["bias"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        b = mmf.read_vector(ts)
        return cls(n_inputs, n_outputs), {"bias": b}

    def write(self, out, params):
        mmf.write_vector(out, _np(params["bias"]))


@dataclass(frozen=True)
class Window(Component):
    """Multiply by a constant vector (variance scale / Hamming window).

    Reference: TNetLib/CRBEDctFeat.h:343-390.
    """

    tag = "<window>"

    def apply(self, params, x):
        return x * params["window"]

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        w = mmf.read_vector(ts)
        return cls(n_inputs, n_outputs), {"window": w}

    def write(self, out, params):
        mmf.write_vector(out, _np(params["window"]))


@dataclass(frozen=True)
class Log(Component):
    """Elementwise natural log. Reference: TNetLib/CRBEDctFeat.h:392-426."""

    tag = "<log>"

    def apply(self, params, x):
        return jnp.log(x)


# ---------------------------------------------------------------------------
# RBM layers (double as MLP layers; CD-1 pretraining lives in train/rbm.py)
# ---------------------------------------------------------------------------

BERNOULLI = "bern"
GAUSSIAN = "gauss"


@dataclass(frozen=True)
class Rbm(Component):
    """Restricted Boltzmann Machine layer.

    As an MLP layer: y = sigmoid(x @ W + hid_bias) for Bernoulli hidden units,
    linear for Gaussian (cuRbm.cc:13-23). Serialized as ``vis_type hid_type``
    then W^T (hid, vis), vis bias, hid bias (cuRbm.cc:177-209).
    """

    tag = "<rbm>"
    vis_type: str = BERNOULLI
    hid_type: str = BERNOULLI
    updatable: bool = True
    trainable_keys: Tuple[str, ...] = ("weight", "hid_bias")

    def apply(self, params, x):
        pre = x @ params["weight"] + params["hid_bias"]
        if self.hid_type == BERNOULLI:
            return jax.nn.sigmoid(pre)
        return pre

    def reconstruct(self, params, h):
        """hid → vis: sigmoid for Bernoulli visible, linear for Gaussian
        (cuRbm.cc:117-128)."""
        pre = h @ params["weight"].T + params["vis_bias"]
        if self.vis_type == BERNOULLI:
            return jax.nn.sigmoid(pre)
        return pre

    @classmethod
    def _read_types(cls, ts):
        vt, ht = ts.next(), ts.next()
        for t in (vt, ht):
            if t not in (BERNOULLI, GAUSSIAN):
                raise ValueError(f"Invalid unit type: {t}")
        return vt, ht

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        vt, ht = cls._read_types(ts)
        wt = mmf.read_matrix(ts)          # (hid, vis)
        vb = mmf.read_vector(ts)
        hb = mmf.read_vector(ts)
        if wt.shape != (n_outputs, n_inputs):
            raise ValueError("Wrong RBM weight dimensions in network file")
        return cls(n_inputs, n_outputs, vis_type=vt, hid_type=ht), \
            {"weight": wt.T.copy(), "vis_bias": vb, "hid_bias": hb}

    def write(self, out, params):
        out.write(f"{self.vis_type} {self.hid_type}\n")
        mmf.write_matrix(out, _np(params["weight"]).T)
        mmf.write_vector(out, _np(params["vis_bias"]))
        mmf.write_vector(out, _np(params["hid_bias"]))
        out.write("\n")

    def init_params(self, rng):
        # gen_rbm_init.py: w ~ 0.1*N(0,1), biases 0
        return {
            "weight": (0.1 * rng.standard_normal((self.n_inputs, self.n_outputs))).astype(np.float32),
            "vis_bias": np.zeros(self.n_inputs, dtype=np.float32),
            "hid_bias": np.zeros(self.n_outputs, dtype=np.float32),
        }


@dataclass(frozen=True)
class RbmSparse(Rbm):
    """RBM with a hidden-sparsity target (cuRbmSparse.cc:143-160).

    Same serialization as <rbm>; the sparsity state (smoothed expected
    activity Q) is training state, not a model parameter.
    """

    tag = "<rbmsparse>"


# ---------------------------------------------------------------------------
# Recurrent layer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Recurrent(Component):
    """Simple recurrent sigmoid layer: y_t = sigmoid([x_t; y_{t-1}] @ W + b).

    Reference: CuTNetLib/cuRecurrent.{h,cc} — frame-serial with an input
    history ring. Here the whole utterance runs as one ``lax.scan`` (the
    idiomatic JAX design; see SURVEY.md §7 step 7 on the trainer deviation).
    W: (in+out, out).
    """

    tag = "<recurrent>"
    updatable: bool = True
    trainable_keys: Tuple[str, ...] = ("weight", "bias")

    def apply(self, params, x):
        y, _ = self.apply_with_state(params, x, None)
        return y

    def apply_with_state(self, params, x, h0):
        if h0 is None:
            h0 = jnp.zeros((self.n_outputs,), dtype=x.dtype)
        w_x = params["weight"][:self.n_inputs]
        w_h = params["weight"][self.n_inputs:]
        b = params["bias"]

        def step(h, xt):
            y = jax.nn.sigmoid(xt @ w_x + h @ w_h + b)
            return y, y

        h_last, ys = jax.lax.scan(step, h0, x)
        return ys, h_last

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        wt = mmf.read_matrix(ts)          # (out, in+out)
        b = mmf.read_vector(ts)
        if wt.shape != (n_outputs, n_inputs + n_outputs) or b.shape != (n_outputs,):
            raise ValueError("Wrong recurrent dimensions in network file")
        return cls(n_inputs, n_outputs), {"weight": wt.T.copy(), "bias": b}

    def write(self, out, params):
        mmf.write_matrix(out, _np(params["weight"]).T)
        mmf.write_vector(out, _np(params["bias"]))
        out.write("\n")

    def init_params(self, rng):
        w = (0.1 * rng.standard_normal(
            (self.n_inputs + self.n_outputs, self.n_outputs))).astype(np.float32)
        return {"weight": w, "bias": np.zeros(self.n_outputs, dtype=np.float32)}


# ---------------------------------------------------------------------------
# BlockArray — parallel column-wise array of sub-networks (forward only)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockArray(Component):
    """N sub-networks applied to consecutive input column blocks.

    Reference: TNetLib/BlockArray.{h,cc} (forward-only), serialized as
    ``n_blocks`` then ``<block> i ... <endblock>`` per sub-network.
    """

    tag = "<blockarray>"
    subnets: Tuple[tuple, ...] = ()   # tuple of tuples of specs

    def apply(self, params, x):
        nb = len(self.subnets)
        bi = self.n_inputs // nb
        outs = []
        for i, specs in enumerate(self.subnets):
            h = x[:, i * bi:(i + 1) * bi]
            for j, spec in enumerate(specs):
                h = spec.apply(params["blocks"][i][j], h)
            outs.append(h)
        return jnp.concatenate(outs, axis=1)

    @classmethod
    def read(cls, n_inputs, n_outputs, ts):
        from .network import read_components  # local import to avoid cycle
        nb = int(ts.next())
        subnets, block_params = [], []
        for i in range(nb):
            tag = ts.next()
            idx = int(ts.next())
            if tag != "<block>" or idx != i + 1:
                raise ValueError(f"Expected '<block> {i+1}', got '{tag} {idx}'")
            specs, params = read_components(ts, stop_tag="<endblock>")
            subnets.append(tuple(specs))
            block_params.append(params)
        return cls(n_inputs, n_outputs, subnets=tuple(subnets)), \
            {"blocks": block_params}

    def write(self, out, params):
        from .network import write_component
        out.write(f"{len(self.subnets)}\n")
        for i, specs in enumerate(self.subnets):
            out.write(f"<block> {i + 1}\n")
            for spec, p in zip(specs, params["blocks"][i]):
                write_component(out, spec, p)
            out.write("<endblock>\n")


# ---------------------------------------------------------------------------
# Tag registry
# ---------------------------------------------------------------------------

COMPONENT_TYPES = [
    BiasedLinearity, DiscreteLinearity, SharedLinearity, SparseLinearity,
    Rbm, RbmSparse, Recurrent,
    Softmax, Sigmoid, BlockSoftmax,
    Expand, Copy, Transpose, BlockLinearity, Bias, Window, Log,
    BlockArray, ClusterLinearity,
]

TAG_TO_TYPE = {c.tag: c for c in COMPONENT_TYPES}
