"""Device-resident frame-shuffling cache.

Re-implements the Cache/CuCache semantics (TNetLib/Cache.cc,
CuTNetLib/cuCache.cc): EMPTY→INTAKE→FULL→EXHAUST state machine, leftover
carry-over between fills, host-generated permutation (bit-exact
srand48 + std::random_shuffle order via utils.rand48) with the row gather
on device, fixed-size bunches with the trailing remainder discarded.
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.rand48 import Rand48


class FrameCache:
    def __init__(self, cachesize: int, bunchsize: int, seed: int = 0,
                 randomize: bool = True):
        if cachesize % bunchsize != 0:
            raise ValueError(
                f"Non divisible cachesize {cachesize} by bunchsize {bunchsize}")
        self.cachesize = cachesize
        self.bunchsize = bunchsize
        self.randomize = randomize
        if seed == 0:
            seed = int(time.time())
        self.rng = Rand48(seed)
        self._feats: List[jnp.ndarray] = []
        self._labels: List[np.ndarray] = []
        self._rows = 0
        self._leftover: Optional[Tuple[jnp.ndarray, np.ndarray]] = None
        self.discarded = 0

    # -- intake -------------------------------------------------------------

    def _take_leftover(self) -> None:
        if self._leftover is not None:
            f, l = self._leftover
            self._leftover = None
            if f.shape[0] > self.cachesize:
                # Too small cache: truncate like Cache.cc:80-92
                f, l = f[:self.cachesize], l[:self.cachesize]
            self._feats.append(f)
            self._labels.append(l)
            self._rows += f.shape[0]

    def add(self, feats: jnp.ndarray, labels: np.ndarray) -> None:
        """Add one utterance (device feats (T, D), host int labels (T,))."""
        assert feats.shape[0] == labels.shape[0]
        if self._rows == 0:
            self._take_leftover()
        space = self.cachesize - self._rows
        if space <= 0:
            raise RuntimeError("AddData on full cache")
        fill = min(space, feats.shape[0])
        self._feats.append(feats[:fill])
        self._labels.append(labels[:fill])
        self._rows += fill
        if fill < feats.shape[0]:
            self._leftover = (feats[fill:], labels[fill:])

    def _stash_leftover(self, f, l) -> None:
        if self._leftover is None:
            self._leftover = (f, l)
        else:
            lf, ll = self._leftover
            self._leftover = (jnp.concatenate([lf, f], axis=0),
                              np.concatenate([ll, l]))

    def _append_up_to_capacity(self, f, l) -> None:
        space = self.cachesize - self._rows
        if space <= 0:
            self._stash_leftover(f, l)
            return
        fill = min(space, f.shape[0])
        self._feats.append(f[:fill])
        self._labels.append(l[:fill])
        self._rows += fill
        if fill < f.shape[0]:
            self._stash_leftover(f[fill:], l[fill:])

    def add_block(self, feats: jnp.ndarray, labels: np.ndarray) -> None:
        """Add a multi-utterance row block (the batched intake path: one
        device array per transform batch instead of per-utterance slices).
        Fills to capacity and keeps the remainder as leftover; unlike
        ``add``, no single-utterance truncation applies — a block is many
        utterances."""
        assert feats.shape[0] == labels.shape[0]
        if self._rows == 0 and self._leftover is not None:
            lf, ll = self._leftover
            self._leftover = None
            self._append_up_to_capacity(lf, ll)
        self._append_up_to_capacity(feats, labels)

    @property
    def full(self) -> bool:
        return self._rows >= self.cachesize

    @property
    def rows(self) -> int:
        return self._rows

    @property
    def has_leftover(self) -> bool:
        return self._leftover is not None

    def absorb_leftover(self) -> bool:
        """Pull the carried-over remainder into the (empty) cache; returns
        True if it alone fills the cache again (long utterances / large
        blocks). Remainder beyond capacity stays as leftover."""
        if self._rows == 0 and self._leftover is not None:
            lf, ll = self._leftover
            self._leftover = None
            self._append_up_to_capacity(lf, ll)
        return self.full

    # -- exhaust ------------------------------------------------------------

    def bunches(self) -> Iterator[Tuple[jnp.ndarray, jnp.ndarray]]:
        """Randomize (if enabled) and yield (feats, labels) bunches.

        Resets the cache to EMPTY afterwards; the partial tail bunch is
        discarded (Cache.cc:239-244).
        """
        if self._rows == 0:
            raise RuntimeError("GetBunch on empty cache")
        feats = self._feats[0] if len(self._feats) == 1 else jnp.concatenate(self._feats, axis=0)
        labels = self._labels[0] if len(self._labels) == 1 else np.concatenate(self._labels, axis=0)
        n = self._rows
        if self.randomize:
            perm = self.rng.permutation(n)
            feats = jnp.take(feats, jnp.asarray(perm), axis=0)
            labels = labels[perm]
        nb = n // self.bunchsize
        self.discarded += n - nb * self.bunchsize
        self._feats, self._labels, self._rows = [], [], 0
        for i in range(nb):
            s = i * self.bunchsize
            yield feats[s:s + self.bunchsize], jnp.asarray(labels[s:s + self.bunchsize])

    def take_stacked(self):
        """Randomize and return ((nb, bunch, D) feats, (nb, bunch) labels)
        for a scan-based drain; resets the cache. None if < one bunch.
        (Shape-stable variant: DeviceFrameCache below.)"""
        if self._rows == 0:
            raise RuntimeError("take_stacked on empty cache")
        feats = self._feats[0] if len(self._feats) == 1 else jnp.concatenate(self._feats, axis=0)
        labels = self._labels[0] if len(self._labels) == 1 else np.concatenate(self._labels, axis=0)
        n = self._rows
        if self.randomize:
            perm = self.rng.permutation(n)
            feats = jnp.take(feats, jnp.asarray(perm), axis=0)
            labels = labels[perm]
        nb = n // self.bunchsize
        self.discarded += n - nb * self.bunchsize
        self._feats, self._labels, self._rows = [], [], 0
        if nb == 0:
            return None
        B = self.bunchsize
        feats = feats[:nb * B].reshape(nb, B, feats.shape[1])
        labels = jnp.asarray(labels[:nb * B].reshape(nb, B))
        return feats, labels


class DeviceFrameCache:
    """Shape-stable device-resident cache: one fixed (cachesize + slack, D)
    HBM buffer written with ``dynamic_update_slice`` (the write offset is
    DATA, not shape — one compiled program serves every block), drained as
    one fixed-shape permutation-gather + reshape.

    Same row semantics as :class:`FrameCache`'s block path: blocks append
    in arrival order, the cache drains at exact ``cachesize`` boundaries,
    the overflow of the block that crossed the boundary carries into the
    next fill, and the trailing sub-bunch remainder of a drain is discarded
    (Cache.cc:239-244). The shuffle is the same bit-exact srand48 +
    std::random_shuffle permutation, so given the same intake the bunch
    sequence is identical to FrameCache's.

    Why it exists: FrameCache concatenates variable-length device slices,
    and every distinct composition is a fresh XLA program (TNetCu's CuCache has the same fixed-buffer
    design for the same reason: cuCache.cc preallocates cachesize_ rows).
    """

    def __init__(self, cachesize: int, bunchsize: int, seed: int = 0,
                 randomize: bool = True):
        if cachesize % bunchsize != 0:
            raise ValueError(
                f"Non divisible cachesize {cachesize} by bunchsize {bunchsize}")
        self.cachesize = cachesize
        self.bunchsize = bunchsize
        self.randomize = randomize
        if seed == 0:
            seed = int(time.time())
        self.rng = Rand48(seed)
        self._buf: Optional[jnp.ndarray] = None     # (cachesize + slack, D)
        self._labels = np.zeros((0,), np.int32)
        self._rows = 0                              # valid rows in _buf
        self.discarded = 0
        self._write = jax.jit(
            lambda buf, blk, off: jax.lax.dynamic_update_slice(
                buf, blk, (off, 0)),
            donate_argnums=(0,))
        # roll the overflow tail [cachesize, cachesize+slack) to the front
        self._roll = jax.jit(
            lambda buf: buf.at[:buf.shape[0] - self.cachesize].set(
                buf[self.cachesize:]),
            donate_argnums=(0,))
        # generalized roll from a DATA offset (partial drains keep the
        # program shape-stable: one gather with a dynamic start row)
        self._roll_from = jax.jit(
            lambda buf, off: jnp.take(
                buf, jnp.arange(buf.shape[0]) + off, axis=0, mode="clip"),
            donate_argnums=(0,))
        B = bunchsize

        def gather_stacked(buf, perm, n_rows):
            # one program: (shuffle-)gather the cached rows + stack into
            # (nb, bunch, D) bunches (n_rows static under trace)
            nb = n_rows // B
            rows = buf[:nb * B] if perm is None \
                else jnp.take(buf, perm, axis=0)[:nb * B]
            return rows.reshape(nb, B, buf.shape[1])

        self._gather_stacked = jax.jit(gather_stacked,
                                       static_argnames=("n_rows",))

    def _ensure_buffer(self, block: jnp.ndarray) -> None:
        slack = block.shape[0]
        need = self.cachesize + slack
        if self._buf is None:
            self._buf = jnp.zeros((need, block.shape[1]), block.dtype)
        elif self._buf.shape[0] < need:
            # rare: a bigger block bucket appeared — grow (new program)
            buf = jnp.zeros((need, block.shape[1]), block.dtype)
            self._buf = jax.lax.dynamic_update_slice(buf, self._buf, (0, 0))

    def add_block(self, block: jnp.ndarray, valid: int,
                  labels: np.ndarray) -> None:
        """Append ``block[:valid]`` (a bucket-padded device block from
        ``TransformPipeline.transform_block``) + host int labels. Junk
        padding rows beyond ``valid`` land past the fill point and are
        overwritten by the next write (or ignored at drain)."""
        assert labels.shape[0] == valid <= block.shape[0]
        self._ensure_buffer(block)
        if self._rows >= self.cachesize:
            raise RuntimeError("AddData on full cache")
        self._buf = self._write(self._buf, block, jnp.int32(self._rows))
        self._rows += valid
        self._labels = np.concatenate([self._labels, labels[:valid]])

    @property
    def full(self) -> bool:
        return self._rows >= self.cachesize

    @property
    def rows(self) -> int:
        return self._rows

    def take_stacked(self, max_bunches: Optional[int] = None):
        """Shuffle + stack the cache into ((nb, bunch, D), (nb, bunch))
        and carry the overflow tail to the front for the next fill.
        Returns None if fewer than one bunch is cached.

        ``max_bunches`` drains at most that many bunches and carries ALL
        remaining rows (not just the over-cachesize overflow) — the
        multi-host lockstep protocol drains the agreed-on minimum bunch
        count per round (parallel/sharded_trainer.py); only the drained
        prefix is shuffled, carried rows keep arrival order."""
        if self._rows == 0:
            raise RuntimeError("take_stacked on empty cache")
        B = self.bunchsize
        n = min(self._rows, self.cachesize)
        if max_bunches is not None:
            n = min(n, max_bunches * B)
            n -= n % B      # partial drains take whole bunches only
            if n == 0:
                return None
        nb = n // B
        labels, self._labels = self._labels[:n], self._labels[n:]
        if self.randomize:
            perm = self.rng.permutation(n)
            labels = labels[perm]
        else:
            perm = None
        feats = None
        if nb > 0:
            perm_dev = None if perm is None \
                else jnp.asarray(perm.astype(np.int32))
            feats = self._gather_stacked(self._buf, perm_dev, n_rows=n)
            labels_dev = jnp.asarray(labels[:nb * B].reshape(nb, B))
        if max_bunches is None:
            self.discarded += n - nb * B
        if self._rows > n:
            # the runtime sequences the donated-buffer roll after the
            # pending gather that reads it — no host sync needed, and not
            # syncing lets feature IO overlap the device drain
            if n == self.cachesize:
                self._buf = self._roll(self._buf)
            else:
                self._buf = self._roll_from(self._buf, jnp.int32(n))
            self._rows -= n
        else:
            self._rows = 0
            self._labels = np.zeros((0,), np.int32)
        if nb == 0:
            return None
        return feats, labels_dev
