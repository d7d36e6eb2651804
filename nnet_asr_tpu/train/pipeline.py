"""Batched device-side feature-transform pipeline.

The reference transforms one utterance at a time on the training device and
trims the splice halo afterwards (Platform.h:274-286, TNetCu.cc:385-393).
This design keeps that contract but batches the work into
fixed-shape chunks so XLA compiles the transform once:

  1. extended utterances (each read with ±ext halo frames) are concatenated
     host-side into one frame stream;
  2. the stream runs through the transform network in CHUNK-row tiles with
     ext-row overlap (same halo-exchange trick as Network::Feedforward,
     Nnet.cc:15-62) — every tile has identical shape → one XLA program;
  3. the valid (halo-trimmed) rows of each utterance are gathered back out.

Rows kept for utterance i only ever splice into utterance i's own extended
block, so the result is bit-identical to per-utterance transformation.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..models.network import Network


def _bucket(n: int, quantum: int = 4096) -> int:
    """Round ``n`` up to a shape bucket: multiples of ``quantum`` up to 64k,
    powers of two above. Bucketing bounds the number of distinct XLA
    programs the streaming intake compiles (each distinct shape is a
    compile) while wasting at most
    one quantum of padding."""
    n = max(n, 1)
    if n <= 65536:
        return -(-n // quantum) * quantum
    b = 65536
    while b < n:
        b *= 2
    return b


class TransformPipeline:
    def __init__(self, transform: Optional[Network], start_ext: int = 0,
                 end_ext: int = 0, chunk: int = 2048,
                 compute_dtype: Optional[str] = None):
        """``compute_dtype='bf16'`` runs the affine layers' matmuls in
        bfloat16 (activations/softmax stay f32); ``'int8'`` runs them as
        int8 GEMMs (per-output-channel weight quantization + dynamic
        per-tensor activation quantization, int32 accumulate). Inference
        modes for posterior dumps; training stays f32."""
        self.transform = transform
        self.start_ext = start_ext
        self.end_ext = end_ext
        self.chunk = chunk
        bf16 = compute_dtype == "bf16"
        int8 = compute_dtype == "int8"

        def _quant_w(w):
            # per-output-channel symmetric int8
            s = jnp.max(jnp.abs(w), axis=0) / 127.0 + 1e-12
            wq = jnp.clip(jnp.round(w / s), -127, 127).astype(jnp.int8)
            return wq, s

        def _int8_matmul(x, wq, s):
            sx = jnp.max(jnp.abs(x)) / 127.0 + 1e-12
            xq = jnp.clip(jnp.round(x / sx), -127, 127).astype(jnp.int8)
            acc = jax.lax.dot_general(xq, wq, (((1,), (0,)), ((), ())),
                                      preferred_element_type=jnp.int32)
            return acc.astype(jnp.float32) * (sx * s)[None, :]

        if transform is not None:
            # linear transforms fold to one splice+matmul (the fast path;
            # see ops/fold_affine.py) — nonlinear ones run layer-by-layer
            from ..models import components as C
            from ..ops.fold_affine import fold_transform

            folded = fold_transform(transform)
            if folded is not None:
                sa, M, cvec = folded
                if bf16:
                    M = M.astype(jnp.bfloat16)
                # the folded matrix rides as an ARGUMENT, not a closure
                # constant: a multi-MB literal baked into the HLO slows
                # compilation
                if int8:
                    Mq, Ms = _quant_w(M)
                    self._folded = (Mq, Ms, cvec)

                    def apply_chunk(params, x, _sa=sa):
                        _Mq, _Ms, _c = params
                        spliced = C.Expand(
                            _sa.in_dim,
                            _sa.in_dim * max(len(_sa.offsets), 1),
                            offsets=_sa.offsets or (0,)).apply({}, x)
                        return _int8_matmul(spliced, _Mq, _Ms) + _c
                else:
                    self._folded = (M, cvec)

                    def apply_chunk(params, x, _sa=sa):
                        _M, _c = params
                        if bf16:
                            x = x.astype(jnp.bfloat16)
                        y = _sa.apply(_M, _c, x)  # bf16@bf16 + f32 bias → f32
                        return y.astype(jnp.float32)
            else:
                specs = transform.specs
                if int8:
                    self._qparams = [
                        dict(p, **dict(zip(("wq", "wscale"),
                                           _quant_w(jnp.asarray(p["weight"])))))
                        if isinstance(sp, C.BiasedLinearity) else p
                        for sp, p in zip(specs, transform.params)]

                def apply_chunk(params, x):
                    for spec, p in zip(specs, params):
                        if int8 and isinstance(spec, C.BiasedLinearity):
                            x = _int8_matmul(x, p["wq"], p["wscale"]) + p["bias"]
                        elif bf16 and isinstance(spec, C.BiasedLinearity):
                            x = (x.astype(jnp.bfloat16)
                                 @ p["weight"].astype(jnp.bfloat16)
                                 ).astype(jnp.float32) + p["bias"]
                        else:
                            x = spec.apply(p, x)
                    return x

            if folded is None:
                self._folded = None
            if not (int8 and folded is None):
                self._qparams = None
            self._apply_chunk = jax.jit(apply_chunk)

            # whole-block transform+gather as ONE program per shape bucket:
            # scan over fixed-size tiles (n_chunks is static under trace),
            # then gather the valid rows. One dispatch per intake block.
            ext_l, halo, CH = self.start_ext, self.start_ext + self.end_ext, self.chunk

            def apply_block(params, padded, idx):
                n_chunks = (padded.shape[0] - halo) // CH

                def body(_, i):
                    tile = jax.lax.dynamic_slice_in_dim(
                        padded, i * CH, CH + halo, axis=0)
                    y = apply_chunk(params, tile)
                    return None, y[ext_l:ext_l + CH]

                if n_chunks == 1:
                    out = apply_chunk(params, padded)[ext_l:ext_l + CH]
                else:
                    _, ys = jax.lax.scan(body, None, jnp.arange(n_chunks))
                    out = ys.reshape(n_chunks * CH, ys.shape[-1])
                return jnp.take(out, idx, axis=0)

            self._apply_block = jax.jit(apply_block)
        else:
            self._folded = None
            self._qparams = None
            self._apply_chunk = None
            self._apply_block = None

    @property
    def out_dim(self) -> int:
        return self.transform.n_outputs if self.transform else 0

    def _transform_stream(self, ext_feats: Sequence[np.ndarray]) -> jnp.ndarray:
        """Run the chunked transform over the concatenated extended
        utterances; returns the full (S, D_out) device stream."""
        ext_l, ext_r = self.start_ext, self.end_ext
        stream = np.concatenate(ext_feats, axis=0) if len(ext_feats) > 1 else ext_feats[0]
        S = stream.shape[0]
        C = self.chunk
        n_chunks = max(1, -(-S // C))
        halo = ext_l + ext_r
        # pad: ext_l zeros in front (context for row 0 of chunk 0 — only
        # trimmed rows read it), and tail zeros so every tile is full-size
        padded = np.zeros((ext_l + n_chunks * C + ext_r, stream.shape[1]),
                          dtype=np.float32)
        padded[ext_l:ext_l + S] = stream
        padded_dev = jnp.asarray(padded)

        params = self._folded if self._folded is not None \
            else (self._qparams if self._qparams is not None
                  else self.transform.params)
        out_chunks = []
        for i in range(n_chunks):
            tile = jax.lax.dynamic_slice_in_dim(padded_dev, i * C, C + halo, axis=0)
            y = self._apply_chunk(params, tile)
            # tile rows [ext_l, ext_l + C) are the chunk's own rows
            out_chunks.append(y[ext_l:ext_l + C])
        return jnp.concatenate(out_chunks, axis=0)[:S]

    def _valid_row_indices(self, ext_feats) -> np.ndarray:
        ext_l, ext_r = self.start_ext, self.end_ext
        idx = []
        off = 0
        for f in ext_feats:
            idx.append(np.arange(off + ext_l, off + f.shape[0] - ext_r))
            off += f.shape[0]
        return np.concatenate(idx) if idx else np.zeros((0,), np.int64)

    def transform_rows(self, ext_feats: Sequence[np.ndarray]):
        """Transform a batch and return ONE device array of the valid
        (halo-trimmed) rows of all utterances, concatenated, plus the
        per-utterance lengths.

        This is the training intake path: a single gather with host-built
        indices replaces per-utterance slicing — per-utterance slices of
        varying length each compile a distinct XLA program."""
        ext_l, ext_r = self.start_ext, self.end_ext
        lens = [f.shape[0] - ext_l - ext_r for f in ext_feats]
        if self.transform is None:
            rows = np.concatenate([f[ext_l:f.shape[0] - ext_r]
                                   for f in ext_feats], axis=0)
            return jnp.asarray(rows), lens
        stream_out = self._transform_stream(ext_feats)
        idx = self._valid_row_indices(ext_feats)
        return jnp.take(stream_out, jnp.asarray(idx), axis=0), lens

    def transform_block(self, ext_feats: Sequence[np.ndarray]):
        """Transform a batch into ONE bucket-padded device block.

        Returns ``(rows, valid)``: ``rows`` is a (V_bucket, D_out) device
        array whose first ``valid`` rows are the halo-trimmed rows of all
        utterances in arrival order (the tail is junk padding). Every shape
        the device sees is a bucket (multiple of 4096 / power of two), so
        the steady-state intake reuses a handful of compiled programs no
        matter how utterance lengths vary — the shape-stable training
        intake path (each distinct shape is a fresh XLA compile)."""
        ext_l, ext_r = self.start_ext, self.end_ext
        lens = [f.shape[0] - ext_l - ext_r for f in ext_feats]
        V = int(sum(lens))
        Vb = _bucket(V)
        if self.transform is None:
            rows = np.zeros((Vb, ext_feats[0].shape[1]), np.float32)
            off = 0
            for f in ext_feats:
                t = f.shape[0] - ext_l - ext_r
                rows[off:off + t] = f[ext_l:f.shape[0] - ext_r]
                off += t
            return jnp.asarray(rows), V
        stream = np.concatenate(ext_feats, axis=0) if len(ext_feats) > 1 \
            else ext_feats[0]
        S = stream.shape[0]
        C = self.chunk
        halo = ext_l + ext_r
        Sb = -(-_bucket(S) // C) * C
        padded = np.zeros((Sb + halo, stream.shape[1]), dtype=np.float32)
        padded[ext_l:ext_l + S] = stream
        idx = np.zeros((Vb,), np.int32)
        idx[:V] = self._valid_row_indices(ext_feats)
        params = self._folded if self._folded is not None \
            else (self._qparams if self._qparams is not None
                  else self.transform.params)
        rows = self._apply_block(params, jnp.asarray(padded), jnp.asarray(idx))
        return rows, V

    def transform_to_host(self, ext_feats: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Transform a batch and return per-utterance HOST arrays with ONE
        dispatch + ONE device-to-host fetch (the inference/dump path:
        tfeacat etc.)."""
        ext_l, ext_r = self.start_ext, self.end_ext
        lens = [f.shape[0] - ext_l - ext_r for f in ext_feats]
        rows, _ = self.transform_block(ext_feats)
        rows = np.asarray(rows)
        outs = []
        off = 0
        for t in lens:
            outs.append(rows[off:off + t])
            off += t
        return outs

    def __call__(self, ext_feats: Sequence[np.ndarray]) -> List[jnp.ndarray]:
        """Transform a batch of frame-extended utterances.

        ``ext_feats[i]`` is (T_i + start_ext + end_ext, D_in); returns a list
        of device arrays (T_i, D_out) with the halo trimmed.
        """
        ext_l, ext_r = self.start_ext, self.end_ext
        real_lens = [f.shape[0] - ext_l - ext_r for f in ext_feats]
        if self.transform is None:
            return [jnp.asarray(f[ext_l:f.shape[0] - ext_r]) for f in ext_feats]
        stream_out = self._transform_stream(ext_feats)
        outs = []
        off = 0
        for f, t_real in zip(ext_feats, real_lens):
            outs.append(jax.lax.dynamic_slice_in_dim(
                stream_out, off + ext_l, t_real, axis=0))
            off += f.shape[0]
        return outs
