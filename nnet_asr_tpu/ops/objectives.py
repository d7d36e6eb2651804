"""Objective functions: cross-entropy and mean-square error, fused on device.

Re-designs TNetLib/ObjFun.cc + CuTNetLib/cuObjectiveFunction.cc:
  - integer frame labels replace dense one-hot targets (avoids the
    (bunch, senones) one-hot materialization — SURVEY.md §7 risk list);
  - the gradient comes from AD through log-softmax, which is analytically
    the reference's fused ``err = y - t`` (softmax backward = identity,
    Activation.cc:49-52);
  - Xent value reproduces the clamped ``max(log y, -1e10)`` accumulation
    (ObjFun.cc:110-127) and frame accuracy the argmax-match count
    (ObjFun.cc:100-108); host-side accumulation is float64 like the
    reference's ``double error_``.

Also hosts the reference-quirk ``softmax_identity_backward`` for MSE
training through a terminal softmax (the reference always backprops error
through softmax unchanged, whatever the objective).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.custom_vjp
def softmax_identity_backward(x: jnp.ndarray) -> jnp.ndarray:
    return jax.nn.softmax(x, axis=-1)


def _sib_fwd(x):
    return jax.nn.softmax(x, axis=-1), None


def _sib_bwd(_, g):
    return (g,)


softmax_identity_backward.defvjp(_sib_fwd, _sib_bwd)


# ---------------------------------------------------------------------------
# Device-side evaluation kernels (jittable pieces of the train step)
# ---------------------------------------------------------------------------

def block_log_softmax(logits: jnp.ndarray, dims) -> jnp.ndarray:
    """log-softmax over disjoint column spans (BlockSoftmax pairing)."""
    outs = []
    off = 0
    for d in dims:
        outs.append(jax.nn.log_softmax(logits[:, off:off + d], axis=-1))
        off += d
    return jnp.concatenate(outs, axis=1)


def xent_loss_and_stats(logits: jnp.ndarray, labels: jnp.ndarray,
                        block_dims=None) -> Tuple[jnp.ndarray, dict]:
    """CE loss (sum over frames) + reference-compatible stats.

    Gradient of the returned ``loss`` wrt ``logits`` is exactly the
    reference global gradient ``err = softmax(logits) - onehot``.
    Stats: ``xent`` uses the clamped posterior-log like ObjFun.cc:113-117;
    ``correct`` counts argmax(posteriors) == label.
    """
    if block_dims is not None:
        logp = block_log_softmax(logits, block_dims)
    else:
        logp = jax.nn.log_softmax(logits, axis=-1)
    # one-hot contraction instead of logp[rows, labels]: a 2-D gather's
    # VJP would be a scatter; the dense mask fuses into the softmax and
    # its gradient is the same err = softmax - onehot
    onehot = jax.nn.one_hot(labels, logits.shape[1], dtype=logp.dtype)
    picked = jnp.sum(logp * onehot, axis=-1)
    loss = -jnp.sum(picked)

    # stats (no gradient needed)
    post_logp = jax.lax.stop_gradient(picked)
    xent = -jnp.sum(jnp.maximum(post_logp, -1e10))
    pred = jnp.argmax(jax.lax.stop_gradient(logits), axis=-1)
    # argmax of per-block softmax == argmax of logits within blocks; for
    # plain softmax argmax(posterior) == argmax(logits).
    if block_dims is not None:
        pred = jnp.argmax(jax.lax.stop_gradient(logp), axis=-1)
    correct = jnp.sum((pred == labels).astype(jnp.int32))
    return loss, {"xent": xent, "correct": correct,
                  "frames": jnp.asarray(logits.shape[0], jnp.int32)}


def mse_loss_and_stats(net_out: jnp.ndarray, targets: jnp.ndarray):
    """MSE: loss = sum((y-t)^2)/2, grad = y - t (ObjFun.cc:24-56)."""
    diff = net_out - targets
    loss = 0.5 * jnp.sum(diff * diff)
    return loss, {"mse": jax.lax.stop_gradient(loss),
                  "frames": jnp.asarray(net_out.shape[0], jnp.int32)}


# ---------------------------------------------------------------------------
# Host-side accumulators (fp64, merged across shards/bunches)
# ---------------------------------------------------------------------------

@dataclass
class XentStats:
    """Accumulates like CrossEntropy (ObjFun.cc:158-228), incl. the report line
    the newbob scheduler greps (``Xent:... correct[x%]``)."""

    error: float = 0.0
    frames: int = 0
    corr: int = 0
    # optional confusion accumulation (CONFUSIONMODE=max|soft|dmax|dsoft)
    confusion_mode: str = "no"
    n_classes: int = 0
    confusion: Optional[np.ndarray] = None
    confusion_count: Optional[np.ndarray] = None
    diag_confusion: Optional[np.ndarray] = None
    label_map_file: Optional[str] = None

    def _ensure_confusion(self, n):
        if self.confusion is None:
            self.n_classes = n
            self.confusion = np.zeros((n, n), dtype=np.float64)
            self.confusion_count = np.zeros(n, dtype=np.float64)
            self.diag_confusion = np.zeros(n, dtype=np.float64)

    def add(self, xent: float, frames: int, correct: int) -> None:
        self.error += float(xent)
        self.frames += int(frames)
        self.corr += int(correct)

    def add_confusion(self, posteriors: np.ndarray, labels: np.ndarray) -> None:
        if self.confusion_mode == "no":
            return
        n = posteriors.shape[1]
        self._ensure_confusion(n)
        pred = posteriors.argmax(axis=1)
        for r in range(len(labels)):
            t, h = int(labels[r]), int(pred[r])
            if self.confusion_mode == "max":
                self.confusion[t, h] += 1
            elif self.confusion_mode == "soft":
                self.confusion[t] += posteriors[r]
            elif self.confusion_mode == "dmax":
                self.diag_confusion[t] += 1 if t == h else 0
            elif self.confusion_mode == "dsoft":
                self.diag_confusion[t] += posteriors[r, t]
            self.confusion_count[t] += 1

    def merge(self, other: "XentStats") -> None:
        self.error += other.error
        self.frames += other.frames
        self.corr += other.corr

    @property
    def accuracy(self) -> float:
        return 100.0 * self.corr / max(self.frames, 1)

    def report(self) -> str:
        s = (f"Xent:{self.error:.10g} frames:{self.frames}"
             f" err/frm:{self.error / max(self.frames, 1):.10g}"
             f" correct[{self.accuracy:.10g}%]\n")
        if self.confusion_mode != "no" and self.confusion is not None:
            tags = None
            if self.label_map_file:
                with open(self.label_map_file) as f:
                    tags = f.read().split()
            if self.confusion_mode in ("max", "soft"):
                s += "Row:label Col:hyp\n"
                s += f"m {self.n_classes} {self.n_classes}\n"
                for row in self.confusion:
                    s += " ".join(f"{v:g}" for v in row) + " \n"
            for i in range(self.n_classes):
                num = (self.confusion[i, i] if self.confusion_mode in ("max", "soft")
                       else self.diag_confusion[i])
                cnt = self.confusion_count[i]
                tag = tags[i] if tags and i < len(tags) else str(i)
                pct = 100.0 * num / cnt if cnt else 0.0
                s += f"{tag:>30} {pct:>10g}% [{num:g}/{cnt:g}]\n"
        return s


@dataclass
class MseStats:
    error: float = 0.0
    frames: int = 0

    def add(self, mse: float, frames: int) -> None:
        self.error += float(mse)
        self.frames += int(frames)

    def merge(self, other: "MseStats") -> None:
        self.error += other.error
        self.frames += other.frames

    def report(self) -> str:
        return (f"Mse:{self.error:.10g} frames:{self.frames}"
                f" err/frm:{self.error / max(self.frames, 1):.10g}\n")
