"""MPE / sMBR lattice forward-backward sequence training (TMpeCu path).

Architecture mirrors the reference's split (TMpeCu.cc:461-672): the NN
forward runs on the accelerator, log posteriors come to the host, the
lattice recursions run host-side (STK's token-passing decoder was also
host code), and the resulting ``err = -kappa * gamma_mpe`` matrix goes back
to the device for backprop through the softmax-identity path.

The recursions re-implement Decoder::GetMpeGamma's math
(Decoder.tcc:2443-2578 forward-backward, 3136-3266 gamma scatter) on
phone-arc lattices in a dense, vectorizable form:

  * within-arc state-level forward-backward over the phone HMM's emitting
    states (left-to-right with <TRANSP> probabilities), emissions =
    kappa-scaled senone log posteriors — yields the arc acoustic
    log-likelihood and per-frame state occupancies;
  * lattice-level log-space alpha/beta over nodes → arc posteriors
    gamma_q;
  * MPE accuracy statistics (AlphaBetaMPE analog): per-arc raw accuracy
    against the reference phone segmentation using Povey's approximate
    phone accuracy, accuracy-weighted alpha_acc/beta_acc means, and
    gamma_mpe_q = gamma_q * (alpha_acc + c_q + beta_acc - c_avg);
  * scatter into the (frame, senone) gamma matrix through the within-arc
    occupancies. ``--MLGAMMA`` mode accumulates plain occupancies instead
    (TMpeCu.cc:564-566).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.htk_hmm import Hmm
from ..io.slf import Lattice

LOG_ZERO = -1e30


def _logsumexp(a: np.ndarray) -> float:
    m = np.max(a)
    if m <= LOG_ZERO:
        return LOG_ZERO
    return float(m + np.log(np.sum(np.exp(a - m))))


@dataclass
class MpeConfig:
    lm_scale: float = 1.0
    outprb_scale: float = 1.0          # kappa (acoustic/posterior scale)
    ml_gamma: bool = False             # plain ML occupancy accumulation
    frame_rate: float = 100.0
    pron_scale: float = 1.0            # PRONUNSCALE (TMpeCu.cc:265)
    word_penalty: float = 0.0          # WORDPENALTY (TMpeCu.cc:256)
    # RESPECTPRONVARS (TMpeCu.cc:274): True expands only the lattice's
    # variant; False (ref default) expands every dictionary variant
    respect_pronun_var: bool = False
    # lattice beam (log domain): nodes whose alpha falls more than this
    # below the best alpha at the same node time are deactivated, as
    # STK's token-passing state pruning (Decoder mPruningThresh,
    # TMpeCu.cc:559: 0 means no pruning / -LOG_0)
    pruning: float = 0.0
    # word-lattice expansion: integrate over ALL intra-word phone
    # segmentations (STK-exact, Decoder.tcc:2443-2578) instead of the MAP
    # Viterbi boundaries; exact_window=W restricts boundary times to ±W
    # frames of the MAP boundary (None = fully exact). Closes
    # docs/DEVIATIONS.md §3a at O(k·span²) arcs per word arc.
    exact_segmentation: bool = False
    exact_window: Optional[int] = None
    # TRANSPSCALE (TMpeCu.cc:266 → decoder.mTranScale, Decoder.tcc:1962):
    # multiplies the LOG transition probabilities in the within-arc FB
    transp_scale: float = 1.0
    # MODELPENALTY (TMpeCu.cc:257 → decoder.mMPenalty, Decoder.tcc:1713):
    # additive log penalty per model (= per phone arc) entry
    model_penalty: float = 0.0
    # OCCUPPSCALE (TMpeCu.cc:267 → decoder.mOcpScale, Decoder.tcc:2732):
    # exponent on the occupancy part of every gamma contribution,
    # exp(s·(α+β−P)) == (γ_q·occ)^s in the factorized engine
    occup_scale: float = 1.0
    # STARTTIMESHIFT/ENDTIMESHIFT (TMpeCu.cc:294-296, in_net_fmt): shift
    # every arc's start/end time by these SECONDS when reading lattices
    start_time_shift: float = 0.0
    end_time_shift: float = 0.0


@dataclass(slots=True)
class ArcInfo:          # slots: 16k instances per TIMIT lattice
    start: int
    end: int
    t0: int
    t1: int                            # exclusive
    phone: str
    senones: List[int]
    log_like: float = LOG_ZERO
    occupancy: Optional[np.ndarray] = None   # (t1-t0, n_emitting)
    score: float = LOG_ZERO            # log_like + lm contribution
    accuracy: float = 0.0


def arc_forward_backward(log_obs: np.ndarray, transp: np.ndarray):
    """State-level FB within one arc.

    ``log_obs``: (T, S) kappa-scaled emission log-probs for the S emitting
    states; ``transp``: (S+2, S+2) HTK transition probabilities (entry row
    0, exit col S+1). Returns (log_likelihood, occupancy (T, S)).
    """
    T, S = log_obs.shape
    with np.errstate(divide="ignore"):
        lt = np.where(transp > 0, np.log(np.maximum(transp, 1e-300)), LOG_ZERO)
    # alpha over emitting states 1..S (matrix indices 1..S)
    alpha = np.full((T, S), LOG_ZERO)
    alpha[0] = lt[0, 1:S + 1] + log_obs[0]
    for t in range(1, T):
        # logsumexp over predecessor states
        prev = alpha[t - 1][:, None] + lt[1:S + 1, 1:S + 1]
        m = prev.max(axis=0)
        good = m > LOG_ZERO / 2
        acc = np.where(good,
                       m + np.log(np.sum(np.exp(prev - m[None, :]), axis=0)
                                  + 1e-300),
                       LOG_ZERO)
        alpha[t] = acc + log_obs[t]
    exit_scores = alpha[T - 1] + lt[1:S + 1, S + 1]
    log_like = _logsumexp(exit_scores)
    if log_like <= LOG_ZERO / 2:
        return LOG_ZERO, np.zeros((T, S))

    beta = np.full((T, S), LOG_ZERO)
    beta[T - 1] = lt[1:S + 1, S + 1]
    for t in range(T - 2, -1, -1):
        nxt = lt[1:S + 1, 1:S + 1] + (log_obs[t + 1] + beta[t + 1])[None, :]
        m = nxt.max(axis=1)
        good = m > LOG_ZERO / 2
        beta[t] = np.where(good,
                           m + np.log(np.sum(np.exp(nxt - m[:, None]), axis=1)
                                      + 1e-300),
                           LOG_ZERO)
    occ = np.exp(np.clip(alpha + beta - log_like, -700, 0))
    occ[occ < 1e-300] = 0.0
    # normalize tiny numeric drift per frame
    sums = occ.sum(axis=1, keepdims=True)
    occ = np.divide(occ, sums, out=np.zeros_like(occ), where=sums > 0)
    return log_like, occ


def arc_forward_backward_batch(log_obs: np.ndarray, lt: np.ndarray):
    """Vectorized within-arc FB over a bucket of same-shape arcs.

    ``log_obs``: (A, L, S) emissions; ``lt``: (A, S+2, S+2) log transitions.
    Returns (log_like (A,), occupancy (A, L, S)). Same math as
    arc_forward_backward, batched over arcs to kill the per-arc Python
    overhead (the T-decode hot loop).
    """
    A, L, S = log_obs.shape
    inner = lt[:, 1:S + 1, 1:S + 1]                  # (A, S, S)
    alpha = np.full((A, L, S), LOG_ZERO)
    alpha[:, 0] = lt[:, 0, 1:S + 1] + log_obs[:, 0]

    def lse(x, axis):
        m = np.max(x, axis=axis)
        good = m > LOG_ZERO / 2
        with np.errstate(over="ignore"):
            out = m + np.log(np.sum(np.exp(x - np.expand_dims(m, axis)),
                                    axis=axis) + 1e-300)
        return np.where(good, out, LOG_ZERO)

    for t in range(1, L):
        prev = alpha[:, t - 1][:, :, None] + inner    # (A, S_from, S_to)
        alpha[:, t] = lse(prev, axis=1) + log_obs[:, t]
    exit_scores = alpha[:, L - 1] + lt[:, 1:S + 1, S + 1]
    log_like = lse(exit_scores, axis=1)               # (A,)

    beta = np.full((A, L, S), LOG_ZERO)
    beta[:, L - 1] = lt[:, 1:S + 1, S + 1]
    for t in range(L - 2, -1, -1):
        nxt = inner + (log_obs[:, t + 1] + beta[:, t + 1])[:, None, :]
        beta[:, t] = lse(nxt, axis=2)

    ok = log_like > LOG_ZERO / 2
    occ = np.exp(np.clip(alpha + beta - log_like[:, None, None], -700, 0))
    occ[~ok] = 0.0
    sums = occ.sum(axis=2, keepdims=True)
    occ = np.divide(occ, sums, out=np.zeros_like(occ), where=sums > 0)
    return np.where(ok, log_like, LOG_ZERO), occ


def arc_forward_batch(log_obs: np.ndarray, lt: np.ndarray) -> np.ndarray:
    """Forward-only half of ``arc_forward_backward_batch``: arc acoustic
    log-likelihoods without materializing occupancies.  This is the cheap
    scoring pass of the prune-then-occupancy path — occupancies are filled
    in later only for arcs that survive the lattice beam."""
    A, L, S = log_obs.shape
    inner = lt[:, 1:S + 1, 1:S + 1]

    def lse(x, axis):
        m = np.max(x, axis=axis)
        good = m > LOG_ZERO / 2
        with np.errstate(over="ignore"):
            out = m + np.log(np.sum(np.exp(x - np.expand_dims(m, axis)),
                                    axis=axis) + 1e-300)
        return np.where(good, out, LOG_ZERO)

    alpha = lt[:, 0, 1:S + 1] + log_obs[:, 0]
    for t in range(1, L):
        prev = alpha[:, :, None] + inner
        alpha = lse(prev, axis=1) + log_obs[:, t]
    log_like = lse(alpha + lt[:, 1:S + 1, S + 1], axis=1)
    return np.where(log_like > LOG_ZERO / 2, log_like, LOG_ZERO)


def povey_phone_accuracy(phone: str, t0: int, t1: int,
                         ref: Sequence[Tuple[int, int, str]]) -> float:
    """Approximate raw phone accuracy (Povey 2002):
    max over ref phones z of (-1 + 2e) if same phone else (-1 + e),
    e = overlap(q, z) / len(z)."""
    best = -1.0
    for (r0, r1, rp) in ref:
        if r1 <= t0 or r0 >= t1:
            continue
        e = (min(t1, r1) - max(t0, r0)) / max(r1 - r0, 1)
        acc = -1.0 + (2.0 * e if rp == phone else e)
        best = max(best, acc)
    return best


def labels_to_phone_segments(frame_labels: np.ndarray,
                             label_names: Sequence[str]):
    """Collapse per-frame state labels into (start, end, phone) segments;
    phone = state tag with the trailing ``_sN`` stripped."""
    import re

    segs = []
    prev = None
    start = 0
    phones = [re.sub(r"_s\d+$", "", label_names[l]) for l in frame_labels]
    for i, p in enumerate(phones):
        if p != prev:
            if prev is not None:
                segs.append((start, i, prev))
            prev, start = p, i
    if prev is not None:
        segs.append((start, len(phones), prev))
    return segs


class MpeComputer:
    def __init__(self, hmms: Dict[str, Hmm], label_map: Dict[str, int],
                 cfg: MpeConfig, engine: str = "numpy",
                 dictionary: Optional[dict] = None):
        self.hmms = hmms
        self.label_map = label_map
        self.cfg = cfg
        self.expander = None
        if dictionary:
            # word lattices: expand word arcs to timed phone chains
            # against the same kappa-scaled posteriors (TMpeCu.cc:535-544
            # ExpansionsAndOptimizations analog — train/lattice_expand.py)
            from .lattice_expand import LatticeExpander
            self.expander = LatticeExpander(
                hmms, label_map, dictionary,
                outprb_scale=cfg.outprb_scale, pron_scale=cfg.pron_scale,
                word_penalty=cfg.word_penalty, frame_rate=cfg.frame_rate,
                multiple_pronun=not cfg.respect_pronun_var,
                segmentation="exact" if cfg.exact_segmentation else "map",
                exact_window=cfg.exact_window,
                transp_scale=cfg.transp_scale)
        self._native = None
        self._padded = engine == "jax"
        if self._padded:
            # bucket-padded masked kernels: ONE device call per utterance
            # and a bounded program count (exact shapes would compile one
            # XLA program per distinct (n_arcs, length) — hundreds per
            # corpus)
            from ..ops.mpe_device import arc_fb_padded_jax, arc_fwd_padded_jax
            self._arc_fb_padded = arc_fb_padded_jax
            self._arc_fwd_padded = arc_fwd_padded_jax
        self._arc_fb_batch = arc_forward_backward_batch
        self._arc_fwd_batch = arc_forward_batch
        self._senone_cache = {
            name: h.senone_ids(label_map) for name, h in hmms.items()}
        self._tp_stacks: Dict[int, tuple] = {}   # n_states -> (stack, index)
        self._ones_cache: Dict[int, np.ndarray] = {}  # shared 1-state occs
        with np.errstate(divide="ignore"):
            # TRANSPSCALE multiplies the log transitions (STK stores log
            # probs in mpMatrixO; Decoder.tcc:1962 scales them by
            # mTranScale when building the recognition net)
            self._log_tp = {
                name: cfg.transp_scale * np.where(
                    h.transp > 0,
                    np.log(np.maximum(h.transp, 1e-300)), LOG_ZERO)
                for name, h in hmms.items()}
        if engine == "native":
            # compiled level-sweep engine (native/mpefb.cc): the same
            # recursions in C++ instead of numpy-over-Python-objects
            # (the remaining host hot loop, ~62% of a corpus-scale MPE
            # iteration — BASELINE_MEASURED.md). Tables reuse
            # _senone_cache/_log_tp verbatim so both engines see
            # identical bits; falls back to the numpy path when g++ is
            # unavailable.
            from . import mpe_native
            if mpe_native.available():
                self._native = mpe_native.NativeTables(
                    list(hmms), self._senone_cache, self._log_tp)

    # ------------------------------------------------------------------
    def _build_arcs(self, lat: Lattice, log_post: np.ndarray):
        T = log_post.shape[0]
        # STARTTIMESHIFT/ENDTIMESHIFT: per-arc start/end shift in frames
        sh0 = int(round(self.cfg.start_time_shift * self.cfg.frame_rate))
        sh1 = int(round(self.cfg.end_time_shift * self.cfg.frame_rate))
        # node times -> frames once (lat.frame per arc end was a measured
        # hot spot at 16k-arc lattice scale)
        nframe = np.rint(np.fromiter(
            (nd.time for nd in lat.nodes), np.float64,
            len(lat.nodes)) * self.cfg.frame_rate).astype(np.int64)
        m = len(lat.arcs)
        starts = np.fromiter((a.start for a in lat.arcs), np.int64, m)
        ends = np.fromiter((a.end for a in lat.arcs), np.int64, m)
        t0s = np.clip(nframe[starts] + sh0, 0, T)
        t1s = np.clip(nframe[ends] + sh1, 0, T)
        base = (self.cfg.lm_scale
                * np.fromiter((a.lm for a in lat.arcs), np.float64, m)
                + np.fromiter((a.prior for a in lat.arcs), np.float64, m))
        arcs: List[ArcInfo] = []
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i, a in enumerate(lat.arcs):
            phone = lat.arc_word(a)
            t0 = int(t0s[i])
            t1 = int(t1s[i])
            if phone is None or phone in ("!NULL", "<s>", "</s>"):
                arcs.append(ArcInfo(a.start, a.end, t0, t1, phone or "!NULL",
                                    [], log_like=0.0, score=float(base[i])))
                continue
            if phone not in self.hmms:
                raise KeyError(f"Phone '{phone}' not in HMM set")
            ids = self._senone_cache[phone]
            if t1 <= t0:
                raise ValueError(f"Zero-length arc for phone {phone}")
            # MODELPENALTY enters each model's (= phone arc's) score once
            info = ArcInfo(a.start, a.end, t0, t1, phone, list(ids),
                           score=float(base[i]) + self.cfg.model_penalty)
            buckets.setdefault((t1 - t0, len(ids)), []).append(len(arcs))
            arcs.append(info)
        return arcs, buckets

    def _tp_stack(self, S):
        stack, index = self._tp_stacks.get(S, (None, None))
        if stack is None:
            names = [nm for nm, tp in self._log_tp.items()
                     if tp.shape[0] == S + 2]
            index = {nm: j for j, nm in enumerate(names)}
            stack = np.stack([self._log_tp[nm] for nm in names])
            self._tp_stacks[S] = (stack, index)
        return stack, index

    def _bucket_inputs(self, arcs, idxs, L, S, log_post):
        # one fancy-index gather per bucket instead of a per-arc slice
        # loop (measured hot spot at TIMIT lattice scale)
        k = len(idxs)
        t0s = np.fromiter((arcs[i].t0 for i in idxs), np.int64, k)
        sen = np.asarray([arcs[i].senones for i in idxs], np.int64)
        tix = t0s[:, None] + np.arange(L, dtype=np.int64)[None, :]
        obs = self.cfg.outprb_scale * log_post[tix[:, :, None],
                                               sen[:, None, :]]
        stack, index = self._tp_stack(S)
        rows = np.fromiter((index[arcs[i].phone] for i in idxs), np.int64, k)
        return obs, stack[rows]

    def _single_state_lls(self, arcs, idxs, prefix):
        """Closed-form arc log-likelihoods for 1-emitting-state phones
        (the TIMIT recipe's whole HMM class): the within-arc FB has one
        forced path, ll = entry + Σobs + (L−1)·self + exit, with Σobs an
        O(1) prefix-sum difference instead of an (A, L) gather + scan —
        exact vs arc_forward_backward_batch (tests/test_mpe.py)."""
        k = len(idxs)
        t0 = np.fromiter((arcs[i].t0 for i in idxs), np.int64, k)
        t1 = np.fromiter((arcs[i].t1 for i in idxs), np.int64, k)
        sen = np.fromiter((arcs[i].senones[0] for i in idxs), np.int64, k)
        obs_sum = self.cfg.outprb_scale * (prefix[t1, sen] - prefix[t0, sen])
        stack, index = self._tp_stack(1)
        rows = np.fromiter((index[arcs[i].phone] for i in idxs),
                           np.int64, k)
        lt = stack[rows]                       # (k, 3, 3)
        L = (t1 - t0).astype(np.float64)
        with np.errstate(invalid="ignore", over="ignore"):
            ll = (obs_sum + lt[:, 0, 1] + lt[:, 1, 2]
                  + np.where(L > 1, (L - 1.0) * lt[:, 1, 1], 0.0))
        ll = np.where(np.isfinite(ll) & (ll > LOG_ZERO / 2), ll, LOG_ZERO)
        return ll

    def _ones_occ(self, L):
        occ = self._ones_cache.get(L)
        if occ is None:
            occ = self._ones_cache[L] = np.ones((L, 1))
            occ.setflags(write=False)          # shared across arcs
        return occ

    @staticmethod
    def _posterior_prefix(log_post):
        T, C = log_post.shape
        prefix = np.zeros((T + 1, C))
        np.cumsum(log_post, axis=0, dtype=np.float64, out=prefix[1:])
        return prefix

    def _obs_lt_lists(self, arcs, idxs, log_post):
        obs_list, lt_list = [], []
        for i in idxs:
            a = arcs[i]
            obs_list.append(
                self.cfg.outprb_scale * log_post[a.t0:a.t1][:, a.senones])
            lt_list.append(self._log_tp[a.phone])
        return obs_list, lt_list

    def _group_by_states(self, arcs, idxs):
        groups: Dict[int, List[int]] = {}
        for i in idxs:
            groups.setdefault(len(arcs[i].senones), []).append(i)
        return groups

    def _prepare_arcs(self, lat: Lattice, log_post: np.ndarray) -> List[ArcInfo]:
        """Full pass: arc scores AND occupancies (no-pruning fast path —
        one batched FB per (length, n_states) bucket; padded engine: one
        masked call per n_states group)."""
        arcs, buckets = self._build_arcs(lat, log_post)
        if self._padded:
            all_idxs = [i for idxs in buckets.values() for i in idxs]
            for _, idxs in self._group_by_states(arcs, all_idxs).items():
                obs_l, lt_l = self._obs_lt_lists(arcs, idxs, log_post)
                lls, occs = self._arc_fb_padded(obs_l, lt_l)
                for j, i in enumerate(idxs):
                    arcs[i].log_like = lls[j]
                    arcs[i].occupancy = occs[j]
                    arcs[i].score += lls[j]
            return arcs, buckets
        prefix = None
        for (L, S), idxs in buckets.items():
            if S == 1:
                if prefix is None:
                    prefix = self._posterior_prefix(log_post)
                lls = self._single_state_lls(arcs, idxs, prefix)
                occ1 = self._ones_occ(L)
                for j, i in enumerate(idxs):
                    arcs[i].log_like = float(lls[j])
                    arcs[i].occupancy = occ1
                    arcs[i].score += float(lls[j])
                continue
            obs, lt = self._bucket_inputs(arcs, idxs, L, S, log_post)
            lls, occs = self._arc_fb_batch(obs, lt)
            for j, i in enumerate(idxs):
                arcs[i].log_like = float(lls[j])
                arcs[i].occupancy = occs[j]
                arcs[i].score += float(lls[j])
        return arcs, buckets

    def _score_arcs(self, lat: Lattice, log_post: np.ndarray):
        """Scoring-only pass (forward recursions, no occupancies) — used
        when a lattice beam is active so occupancies are computed only for
        surviving arcs."""
        arcs, buckets = self._build_arcs(lat, log_post)
        if self._padded:
            all_idxs = [i for idxs in buckets.values() for i in idxs]
            for _, idxs in self._group_by_states(arcs, all_idxs).items():
                obs_l, lt_l = self._obs_lt_lists(arcs, idxs, log_post)
                lls = self._arc_fwd_padded(obs_l, lt_l)
                for j, i in enumerate(idxs):
                    arcs[i].log_like = lls[j]
                    arcs[i].score += lls[j]
            return arcs, buckets
        prefix = None
        for (L, S), idxs in buckets.items():
            if S == 1:
                if prefix is None:
                    prefix = self._posterior_prefix(log_post)
                lls = self._single_state_lls(arcs, idxs, prefix)
            else:
                obs, lt = self._bucket_inputs(arcs, idxs, L, S, log_post)
                lls = self._arc_fwd_batch(obs, lt)
            for j, i in enumerate(idxs):
                arcs[i].log_like = float(lls[j])
                arcs[i].score += float(lls[j])
        return arcs, buckets

    def _fill_occupancies(self, arcs, idxs, log_post):
        """Occupancy FB for the given (surviving) arc indices."""
        if self._padded:
            if not idxs:
                return
            for _, ids in self._group_by_states(arcs, idxs).items():
                obs_l, lt_l = self._obs_lt_lists(arcs, ids, log_post)
                _, occs = self._arc_fb_padded(obs_l, lt_l)
                for j, i in enumerate(ids):
                    arcs[i].occupancy = occs[j]
            return
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i in idxs:
            a = arcs[i]
            buckets.setdefault((a.t1 - a.t0, len(a.senones)), []).append(i)
        for (L, S), ids in buckets.items():
            if S == 1:                 # single forced path: occupancy 1
                occ1 = self._ones_occ(L)
                for i in ids:
                    arcs[i].occupancy = occ1
                continue
            obs, lt = self._bucket_inputs(arcs, ids, L, S, log_post)
            _, occs = self._arc_fb_batch(obs, lt)
            for j, i in enumerate(ids):
                arcs[i].occupancy = occs[j]

    def preflatten(self, lat: Lattice) -> None:
        """Weight-independent native-engine prep (arc/phone arrays) —
        callable from a prefetch pool ahead of the training loop; no-op
        for the numpy/jax engines or word lattices needing expansion."""
        if self._native is not None and (
                self.expander is None
                or not self.expander.needs_expansion(lat)):
            from .mpe_native import flatten_lattice
            flatten_lattice(lat, self._native)

    # ------------------------------------------------------------------
    def compute(self, lat: Lattice, log_post: np.ndarray,
                ref_segments: Sequence[Tuple[int, int, str]],
                utt_weight: float = 1.0,
                frame_weights: Optional[np.ndarray] = None,
                pruning: Optional[float] = None):
        """Returns (gammas (T, C), avg_accuracy, log_prob).

        ``pruning`` overrides cfg.pruning for this utterance (the
        widen-and-retry loop of TMpeCu.cc:587-609 passes successively
        wider beams). Raises FloatingPointError on forward-backward
        underflow — overpruning or bad data.
        """
        T, C = log_post.shape
        # f64 throughout: the prefix-sum scorer always ran in double;
        # lifting the bucketed emissions too keeps the numpy and native
        # engines in the same precision (they are parity-gated)
        log_post = np.asarray(log_post, np.float64)
        if self.expander is not None and self.expander.needs_expansion(lat):
            lat = self.expander.expand(lat, log_post)
        beam = self.cfg.pruning if pruning is None else pruning
        beam = beam if beam > 0.0 else None     # 0 => -LOG_0, TMpeCu.cc:559
        if self._native is not None:
            from .mpe_native import compute_native
            return compute_native(
                lat, log_post, ref_segments, self._native, self.cfg,
                kappa=self.cfg.outprb_scale, utt_weight=utt_weight,
                frame_weights=frame_weights, beam=beam)
        if beam is None:
            arcs, _ = self._prepare_arcs(lat, log_post)
        else:
            arcs, _ = self._score_arcs(lat, log_post)
        n = len(lat.nodes)
        m_arcs = len(arcs)

        # ---- vectorized node recursions ------------------------------
        # The round-3 scalar node loops cost ~0.45s per TIMIT-scale
        # phone-loop lattice (8k nodes / 16k arcs); grouping nodes into
        # topological LEVELS — (time, zero-duration-arc rank) — turns each
        # of the four sweeps into ~T segment log-sum-exp reductions via
        # np.ufunc.reduceat (50x at that scale, measured in
        # BASELINE_MEASURED.md "MPE at TIMIT scale").
        times_ns = np.asarray([nd.time for nd in lat.nodes], np.float64)
        a_start = np.fromiter((a.start for a in arcs), np.int64, m_arcs)
        a_end = np.fromiter((a.end for a in arcs), np.int64, m_arcs)
        a_score = np.fromiter((a.score for a in arcs), np.float64, m_arcs)

        has_in = np.zeros(n, bool)
        has_out = np.zeros(n, bool)
        if m_arcs:
            has_in[a_end] = True
            has_out[a_start] = True
        start_nodes = np.nonzero(~has_in)[0]
        end_nodes = np.nonzero(~has_out)[0]

        # zero-duration (!NULL) arcs connect same-time nodes; their chains
        # get rank sub-levels so the sweeps stay topological
        rank = np.zeros(n, np.int64)
        if m_arcs:
            intra = np.nonzero(times_ns[a_start] == times_ns[a_end])[0]
            for it in range(n + 1):
                if intra.size == 0:
                    break
                if it == n:
                    raise ValueError("zero-duration arc cycle in lattice")
                changed = False
                for q in intra:
                    s, e = a_start[q], a_end[q]
                    if rank[e] < rank[s] + 1:
                        rank[e] = rank[s] + 1
                        changed = True
                if not changed:
                    break

        node_order = np.lexsort((np.arange(n), rank, times_ns))
        node_pos = np.empty(n, np.int64)
        node_pos[node_order] = np.arange(n)
        key_t = times_ns[node_order]
        key_r = rank[node_order]
        lev_break = np.r_[True, (key_t[1:] != key_t[:-1])
                          | (key_r[1:] != key_r[:-1])] if n else \
            np.zeros(0, bool)
        level_of_pos = np.cumsum(lev_break) - 1

        def _csr(group_pos):
            """Group arcs into contiguous per-node segments ordered by the
            node's topological position, plus level-run bounds over the
            segments. Within a segment arcs keep their original index
            order (the in_arcs/out_arcs list order of the scalar code)."""
            ordq = np.lexsort((np.arange(m_arcs), group_pos))
            gpos = group_pos[ordq]
            seg_first = np.empty(m_arcs, bool)
            seg_first[0] = True
            np.not_equal(gpos[1:], gpos[:-1], out=seg_first[1:])
            seg_start = np.nonzero(seg_first)[0]
            seg_sizes = np.diff(np.append(seg_start, m_arcs))
            seg_pos = gpos[seg_start]
            seg_level = level_of_pos[seg_pos]
            run_first = np.empty(seg_level.shape[0], bool)
            run_first[0] = True
            np.not_equal(seg_level[1:], seg_level[:-1], out=run_first[1:])
            run_start = np.nonzero(run_first)[0]
            run_end = np.append(run_start[1:], seg_start.shape[0])
            return ordq, seg_start, seg_sizes, seg_pos, run_start, run_end

        def _run_bounds(seg_start, s0, s1):
            lo = seg_start[s0]
            hi = seg_start[s1] if s1 < seg_start.shape[0] else m_arcs
            return lo, hi

        def _seg_lse(contrib, rel_starts, sizes):
            """Per-segment log-sum-exp with the scalar _lse_list guard.
            Returns (lse, max, expsum)."""
            mx = np.maximum.reduceat(contrib, rel_starts)
            es = np.add.reduceat(np.exp(contrib - np.repeat(mx, sizes)),
                                 rel_starts)
            out = np.where(mx <= LOG_ZERO / 2, LOG_ZERO, mx + np.log(es))
            return out, mx, es

        # ---- alpha with the per-time-group beam ----------------------
        # Any node whose alpha falls more than ``beam`` below the best
        # alpha at the same node TIME is deactivated (alpha := LOG_ZERO)
        # — the lattice analog of STK's per-frame token beam (Decoder
        # mPruningThresh). Overpruning can kill every path; compute()
        # then underflows and the caller widens the beam
        # (TMpeCu.cc:587-609).
        alpha = np.full(n, LOG_ZERO)
        alpha[start_nodes] = 0.0
        pruned = np.zeros(n, bool)
        fw_csr = _csr(node_pos[a_end]) if m_arcs else None
        if fw_csr is not None:
            ordq, seg_start, seg_sizes, seg_pos, run_start, run_end = fw_csr
            fw_src = a_start[ordq]
            fw_score = a_score[ordq]
            tg_break = np.r_[True, key_t[1:] != key_t[:-1]]
            tg_start_pos = np.nonzero(tg_break)[0]
            tg_end_pos = np.r_[tg_start_pos[1:], n]
            run_tg = np.searchsorted(tg_start_pos, seg_pos[run_start],
                                     side="right") - 1
            n_runs = run_start.shape[0]
            # without a beam the final alphas equal the sweep alphas, so
            # the acc sweep below can reuse each run's (contrib, mx, es)
            fw_cache = [None] * n_runs if beam is None else None
            ri = 0
            for g in range(tg_start_pos.shape[0]):
                while ri < n_runs and run_tg[ri] == g:
                    s0, s1 = run_start[ri], run_end[ri]
                    lo, hi = _run_bounds(seg_start, s0, s1)
                    contrib = alpha[fw_src[lo:hi]] + fw_score[lo:hi]
                    vals, mx, es = _seg_lse(contrib, seg_start[s0:s1] - lo,
                                            seg_sizes[s0:s1])
                    alpha[node_order[seg_pos[s0:s1]]] = vals
                    if fw_cache is not None:
                        fw_cache[ri] = (contrib, mx, es)
                    ri += 1
                if beam is not None:
                    gp = node_order[tg_start_pos[g]:tg_end_pos[g]]
                    best = alpha[gp].max()
                    if best > LOG_ZERO / 2:
                        kill = gp[alpha[gp] < best - beam]
                        alpha[kill] = LOG_ZERO
                        pruned[kill] = True

        # ---- beta (pruned nodes stay dead) ---------------------------
        beta = np.full(n, LOG_ZERO)
        live_ends = end_nodes[~pruned[end_nodes]]
        beta[live_ends] = 0.0
        bw_csr = _csr(node_pos[a_start]) if m_arcs else None
        if bw_csr is not None:
            (ordq_b, seg_start_b, seg_sizes_b, seg_pos_b, run_start_b,
             run_end_b) = bw_csr
            bw_src = a_end[ordq_b]
            bw_score = a_score[ordq_b]
            # sources sit at later levels, already final when a run is
            # processed, so the acc sweep can always reuse these
            bw_cache = [None] * run_start_b.shape[0]
            for ri in range(run_start_b.shape[0] - 1, -1, -1):
                s0, s1 = run_start_b[ri], run_end_b[ri]
                lo, hi = _run_bounds(seg_start_b, s0, s1)
                contrib = bw_score[lo:hi] + beta[bw_src[lo:hi]]
                vals, mx, es = _seg_lse(contrib, seg_start_b[s0:s1] - lo,
                                        seg_sizes_b[s0:s1])
                bw_cache[ri] = (contrib, mx, es)
                nodes_r = node_order[seg_pos_b[s0:s1]]
                live = ~pruned[nodes_r]
                beta[nodes_r[live]] = vals[live]

        logZ = _logsumexp(alpha[end_nodes]) if end_nodes.size else LOG_ZERO
        if logZ <= LOG_ZERO / 2:
            raise FloatingPointError("lattice forward-backward underflow "
                                     "(overpruning?)")

        gamma_q = np.exp(np.clip(
            alpha[a_start] + a_score + beta[a_end] - logZ, -700, 0))

        # ---- MPE accuracy (vectorized over arcs x ref segments) ------
        seg_t0 = np.asarray([s[0] for s in ref_segments], dtype=np.float64)
        seg_t1 = np.asarray([s[1] for s in ref_segments], dtype=np.float64)
        seg_ph = [s[2] for s in ref_segments]
        a_t0 = np.fromiter((a.t0 for a in arcs), np.float64, m_arcs)
        a_t1 = np.fromiter((a.t1 for a in arcs), np.float64, m_arcs)
        overlap = (np.minimum(a_t1[:, None], seg_t1[None, :])
                   - np.maximum(a_t0[:, None], seg_t0[None, :]))
        e = np.clip(overlap, 0, None) / np.maximum(seg_t1 - seg_t0, 1)[None, :]
        # phone identity via integer codes (string == across the full
        # arcs x segments grid was a measured hot spot)
        codes: Dict[str, int] = {}
        arc_code = np.fromiter(
            (codes.setdefault(a.phone, len(codes)) for a in arcs),
            np.int64, m_arcs)
        seg_code = np.fromiter(
            (codes.setdefault(p, len(codes)) for p in seg_ph),
            np.int64, len(seg_ph))
        same = arc_code[:, None] == seg_code[None, :]
        acc_mat = np.where(same, -1.0 + 2.0 * e, -1.0 + e)
        acc_mat = np.where(e > 0, acc_mat, -1.0)
        has_sen = np.fromiter((bool(a.senones) for a in arcs), bool, m_arcs)
        arc_acc = np.where(has_sen, np.max(acc_mat, axis=1, initial=-1.0), 0.0)

        # ---- accuracy-weighted means over the same level structure ---
        alpha_acc = np.zeros(n)
        if fw_csr is not None:
            fw_acc = arc_acc[ordq]
            for ri in range(run_start.shape[0]):
                s0, s1 = run_start[ri], run_end[ri]
                lo, hi = _run_bounds(seg_start, s0, s1)
                rel = seg_start[s0:s1] - lo
                sz = seg_sizes[s0:s1]
                if fw_cache is not None:
                    contrib, mx, denom = fw_cache[ri]
                else:
                    contrib = alpha[fw_src[lo:hi]] + fw_score[lo:hi]
                    _, mx, denom = _seg_lse(contrib, rel, sz)
                vals = alpha_acc[fw_src[lo:hi]] + fw_acc[lo:hi]
                numer = np.add.reduceat(
                    np.exp(contrib - np.repeat(mx, sz)) * vals, rel)
                ok = mx > LOG_ZERO / 2
                nodes_r = node_order[seg_pos[s0:s1]]
                alpha_acc[nodes_r[ok]] = (numer[ok] / denom[ok])
        beta_acc = np.zeros(n)
        if bw_csr is not None:
            bw_acc = arc_acc[ordq_b]
            for ri in range(run_start_b.shape[0] - 1, -1, -1):
                s0, s1 = run_start_b[ri], run_end_b[ri]
                lo, hi = _run_bounds(seg_start_b, s0, s1)
                rel = seg_start_b[s0:s1] - lo
                sz = seg_sizes_b[s0:s1]
                contrib, mx, denom = bw_cache[ri]
                vals = bw_acc[lo:hi] + beta_acc[bw_src[lo:hi]]
                numer = np.add.reduceat(
                    np.exp(contrib - np.repeat(mx, sz)) * vals, rel)
                ok = mx > LOG_ZERO / 2
                nodes_r = node_order[seg_pos_b[s0:s1]]
                beta_acc[nodes_r[ok]] = (numer[ok] / denom[ok])

        c_avg = float(np.sum(np.exp(alpha[end_nodes] - logZ)
                             * alpha_acc[end_nodes]))

        # ---- scatter into (frame, senone) ----------------------------
        # OCCUPPSCALE: exponent on the occupancy part of each gamma
        # contribution, exp(s·(α+β−P)) per (state, frame) — the analog of
        # Decoder.tcc:2732/2835 applying mOcpScale to the log occupancy
        # while the MPE accuracy coefficient stays linear. Factorized:
        # (γ_q·occ)^s = γ_q^s · occ^s.
        ocp = self.cfg.occup_scale
        gq_s = gamma_q if ocp == 1.0 else gamma_q ** ocp
        if self.cfg.ml_gamma:
            coef_all = gq_s
        else:
            coef_all = gq_s * (alpha_acc[a_start] + arc_acc
                               + beta_acc[a_end] - c_avg)

        if beam is not None:
            # occupancies were deferred; compute them only for arcs that
            # survived the beam and actually contribute
            needed = [i for i, a in enumerate(arcs)
                      if a.senones and a.occupancy is None
                      and coef_all[i] != 0.0]
            self._fill_occupancies(arcs, needed, log_post)

        # bucket the contributing arcs by (length, n_states) and scatter
        # each bucket with one flat bincount (the per-arc slice loop was
        # the other measured hot spot)
        gammas_flat = np.zeros(T * C, dtype=np.float64)
        fw_w = frame_weights if frame_weights is not None else np.ones(T)
        sc_buckets: Dict[Tuple[int, int], List[int]] = {}
        for i, a in enumerate(arcs):
            if not a.senones or a.occupancy is None or coef_all[i] == 0.0:
                continue
            sc_buckets.setdefault((a.t1 - a.t0, len(a.senones)),
                                  []).append(i)
        for (L, S), idxs in sc_buckets.items():
            t0s = np.fromiter((arcs[i].t0 for i in idxs), np.int64,
                              len(idxs))
            sen = np.asarray([arcs[i].senones for i in idxs], np.int64)
            occ = np.stack([arcs[i].occupancy for i in idxs])
            if ocp != 1.0:
                occ = occ ** ocp
            tix = t0s[:, None] + np.arange(L, dtype=np.int64)[None, :]
            seg = ((coef_all[idxs] * utt_weight)[:, None, None] * occ
                   * fw_w[tix][:, :, None])
            flat = (tix[:, :, None] * C + sen[:, None, :]).ravel()
            gammas_flat += np.bincount(flat, weights=seg.ravel(),
                                       minlength=T * C)
        gammas = gammas_flat.reshape(T, C)
        return gammas.astype(np.float32), c_avg, logZ
