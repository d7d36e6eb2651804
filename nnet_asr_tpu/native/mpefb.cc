// Native MPE lattice forward-backward engine.
//
// Replicates nnet_asr_tpu/train/mpe.py MpeComputer.compute() — the
// reference's Decoder::GetMpeGamma recursions (Decoder.tcc:2443-2578
// forward-backward, 3136-3266 gamma scatter) — as one C call over flat
// arrays: within-arc state FB (closed form for 1-state phone HMMs),
// topological node alpha/beta with the per-time-group beam, Povey
// approximate accuracy, accuracy-weighted alpha_acc/beta_acc means, and
// the (frame, senone) gamma scatter.  The reference's own hot decoder
// loop is compiled C++ (Decoder.tcc); this was the last interpreted hot
// loop in the repo (~62% of a corpus-scale MPE iteration's wall,
// BASELINE_MEASURED.md).
//
// Numerics intentionally mirror the NumPy engine operation for
// operation (same guards, same summation order: arcs ascending index
// within a node, nodes ascending index in reductions, sequential
// per-column prefix sums) so the two engines agree to float rounding
// (tests/test_mpe.py gates parity).
//
// Build: g++ -O2 -shared -fPIC (train/mpe_native.py, on demand).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const double LOG_ZERO = -1e30;
const double LOG_HALF_ZERO = LOG_ZERO / 2.0;

// ---------------------------------------------------------------------
// within-arc state-level FB (multi-state general case)
// mirrors arc_forward_backward_batch (train/mpe.py:147-185) for one arc:
// lt is the (S+2)x(S+2) log transition matrix, obs (L,S) kappa-scaled.
// ---------------------------------------------------------------------
struct ArcFb {
    double ll;
    std::vector<double> occ;   // L*S, row-normalized occupancies
};

static double arc_forward_only(const double* log_post, int64_t C,
                               const int32_t* sen, int S, int t0, int L,
                               const double* lt, double kappa,
                               std::vector<double>& alpha /*scratch L*S*/) {
    const int W = S + 2;
    alpha.assign((size_t)L * S, LOG_ZERO);
    for (int s = 0; s < S; ++s)
        alpha[s] = lt[0 * W + (s + 1)]
                   + kappa * log_post[(int64_t)t0 * C + sen[s]];
    for (int t = 1; t < L; ++t) {
        const double* prev = &alpha[(size_t)(t - 1) * S];
        for (int sto = 0; sto < S; ++sto) {
            double mx = -HUGE_VAL;
            for (int sf = 0; sf < S; ++sf) {
                double v = prev[sf] + lt[(sf + 1) * W + (sto + 1)];
                if (v > mx) mx = v;
            }
            double acc;
            if (mx > LOG_HALF_ZERO) {
                double es = 0.0;
                for (int sf = 0; sf < S; ++sf)
                    es += std::exp(prev[sf] + lt[(sf + 1) * W + (sto + 1)]
                                   - mx);
                acc = mx + std::log(es + 1e-300);
            } else {
                acc = LOG_ZERO;
            }
            alpha[(size_t)t * S + sto] =
                acc + kappa * log_post[(int64_t)(t0 + t) * C + sen[sto]];
        }
    }
    // exit: lse over states of alpha[L-1,s] + lt[s+1, S+1]
    double mx = -HUGE_VAL;
    for (int s = 0; s < S; ++s) {
        double v = alpha[(size_t)(L - 1) * S + s] + lt[(s + 1) * W + S + 1];
        if (v > mx) mx = v;
    }
    double ll;
    if (mx > LOG_HALF_ZERO) {
        double es = 0.0;
        for (int s = 0; s < S; ++s)
            es += std::exp(alpha[(size_t)(L - 1) * S + s]
                           + lt[(s + 1) * W + S + 1] - mx);
        ll = mx + std::log(es + 1e-300);
    } else {
        ll = LOG_ZERO;
    }
    return (ll > LOG_HALF_ZERO) ? ll : LOG_ZERO;
}

static void arc_full_fb(const double* log_post, int64_t C,
                        const int32_t* sen, int S, int t0, int L,
                        const double* lt, double kappa, ArcFb& out) {
    const int W = S + 2;
    std::vector<double> alpha;
    out.ll = arc_forward_only(log_post, C, sen, S, t0, L, lt, kappa, alpha);
    out.occ.assign((size_t)L * S, 0.0);
    if (out.ll <= LOG_HALF_ZERO) return;   // occ stays 0 (~ok mask)

    std::vector<double> beta((size_t)L * S, LOG_ZERO);
    for (int s = 0; s < S; ++s)
        beta[(size_t)(L - 1) * S + s] = lt[(s + 1) * W + S + 1];
    for (int t = L - 2; t >= 0; --t) {
        const double* nb = &beta[(size_t)(t + 1) * S];
        for (int sf = 0; sf < S; ++sf) {
            double mx = -HUGE_VAL;
            for (int sto = 0; sto < S; ++sto) {
                double v = lt[(sf + 1) * W + (sto + 1)]
                           + kappa * log_post[(int64_t)(t0 + t + 1) * C
                                              + sen[sto]] + nb[sto];
                if (v > mx) mx = v;
            }
            if (mx > LOG_HALF_ZERO) {
                double es = 0.0;
                for (int sto = 0; sto < S; ++sto)
                    es += std::exp(lt[(sf + 1) * W + (sto + 1)]
                                   + kappa * log_post[(int64_t)(t0 + t + 1)
                                                      * C + sen[sto]]
                                   + nb[sto] - mx);
                beta[(size_t)t * S + sf] = mx + std::log(es + 1e-300);
            }   // else stays LOG_ZERO
        }
    }
    for (int t = 0; t < L; ++t) {
        double sum = 0.0;
        for (int s = 0; s < S; ++s) {
            double arg = alpha[(size_t)t * S + s] + beta[(size_t)t * S + s]
                         - out.ll;
            if (arg > 0.0) arg = 0.0;
            if (arg < -700.0) arg = -700.0;
            double o = std::exp(arg);
            out.occ[(size_t)t * S + s] = o;
            sum += o;
        }
        if (sum > 0.0)
            for (int s = 0; s < S; ++s)
                out.occ[(size_t)t * S + s] /= sum;
        else
            for (int s = 0; s < S; ++s)
                out.occ[(size_t)t * S + s] = 0.0;
    }
}

}  // namespace

extern "C" {

// Returns 0 ok, 1 lattice FB underflow (overpruning), 3 zero-duration
// arc cycle.  out2 = {avg_acc (c_avg), logZ}.
int mpe_fb(
    // nodes
    int64_t n, const double* times,
    // arcs (base score = lm_scale*lm + prior [+ model_penalty on phone
    // arcs], computed by the Python wrapper)
    int64_t m, const int32_t* a_start, const int32_t* a_end,
    const double* a_base, const int32_t* a_hmm,
    const int32_t* a_t0, const int32_t* a_t1,
    // phone HMM table (log transitions already transp-scaled, verbatim
    // from MpeComputer._log_tp)
    int32_t n_hmm, const int32_t* h_S, const int64_t* h_sen_off,
    const int32_t* h_sen, const int64_t* h_tp_off, const double* h_tp,
    // posteriors
    int64_t T, int64_t C, const double* log_post, double kappa,
    // reference segmentation (frames, phone codes in the hmm-id space,
    // unknown seg phones get codes < -1)
    int64_t nseg, const double* seg_t0, const double* seg_t1,
    const int32_t* seg_code,
    // config
    double beam /* <=0: none */, int32_t ml_gamma, double occup_scale,
    double utt_weight, const double* frame_w /* may be NULL */,
    // outputs
    double* gammas /* T*C, zeroed by caller */, double* out2) {

    if (n <= 0) return 1;

    // ---- per-arc scores ---------------------------------------------
    // prefix[t][c] = cumsum of log_post column c (sequential, matching
    // np.cumsum in _posterior_prefix) for the 1-state closed form
    std::vector<double> prefix;
    bool have_prefix = false;

    std::vector<double> a_score(m), a_ll(m);
    std::vector<double> fb_scratch;
    for (int64_t q = 0; q < m; ++q) {
        int hm = a_hmm[q];
        if (hm < 0) {                     // !NULL arc
            a_ll[q] = 0.0;
            a_score[q] = a_base[q];
            continue;
        }
        int S = h_S[hm];
        const int32_t* sen = h_sen + h_sen_off[hm];
        const double* lt = h_tp + h_tp_off[hm];
        int t0 = a_t0[q], t1 = a_t1[q];
        int L = t1 - t0;
        double ll;
        if (S == 1) {
            if (!have_prefix) {
                prefix.assign((size_t)(T + 1) * C, 0.0);
                for (int64_t t = 0; t < T; ++t)
                    for (int64_t c = 0; c < C; ++c)
                        prefix[(size_t)(t + 1) * C + c] =
                            prefix[(size_t)t * C + c]
                            + log_post[(size_t)t * C + c];
                have_prefix = true;
            }
            const int W = 3;
            double obs_sum = kappa * (prefix[(size_t)t1 * C + sen[0]]
                                      - prefix[(size_t)t0 * C + sen[0]]);
            ll = obs_sum + lt[0 * W + 1] + lt[1 * W + 2];
            if (L > 1) ll += (L - 1.0) * lt[1 * W + 1];
            if (!std::isfinite(ll) || ll <= LOG_HALF_ZERO) ll = LOG_ZERO;
        } else {
            std::vector<double> scratch;
            ll = arc_forward_only(log_post, C, sen, S, t0, L, lt, kappa,
                                  scratch);
        }
        a_ll[q] = ll;
        a_score[q] = a_base[q] + ll;
    }

    // ---- zero-duration ranks (train/mpe.py:544-559) -----------------
    std::vector<int64_t> rank(n, 0);
    {
        std::vector<int64_t> intra;
        for (int64_t q = 0; q < m; ++q)
            if (times[a_start[q]] == times[a_end[q]]) intra.push_back(q);
        if (!intra.empty()) {
            bool cycle = true;
            for (int64_t it = 0; it <= n; ++it) {
                bool changed = false;
                for (int64_t q : intra) {
                    int s = a_start[q], e = a_end[q];
                    if (rank[e] < rank[s] + 1) {
                        rank[e] = rank[s] + 1;
                        changed = true;
                    }
                }
                if (!changed) { cycle = false; break; }
            }
            if (cycle) return 3;
        }
    }

    // ---- topological order: stable sort by (time, rank) -------------
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                         if (times[a] != times[b]) return times[a] < times[b];
                         return rank[a] < rank[b];
                     });

    // per-node incoming/outgoing arc lists in ascending arc order (the
    // reduceat segments keep original arc index order — _csr lexsort)
    std::vector<int64_t> in_off(n + 1, 0), out_off(n + 1, 0);
    for (int64_t q = 0; q < m; ++q) {
        ++in_off[a_end[q] + 1];
        ++out_off[a_start[q] + 1];
    }
    for (int64_t i = 0; i < n; ++i) {
        in_off[i + 1] += in_off[i];
        out_off[i + 1] += out_off[i];
    }
    std::vector<int64_t> in_arc(m), out_arc(m);
    {
        std::vector<int64_t> ip(in_off.begin(), in_off.end() - 1),
            op(out_off.begin(), out_off.end() - 1);
        for (int64_t q = 0; q < m; ++q) {
            in_arc[ip[a_end[q]]++] = q;
            out_arc[op[a_start[q]]++] = q;
        }
    }

    // ---- alpha with the per-time-group beam -------------------------
    std::vector<double> alpha(n, LOG_ZERO);
    std::vector<char> pruned(n, 0);
    for (int64_t i = 0; i < n; ++i)
        if (in_off[i + 1] == in_off[i]) alpha[i] = 0.0;   // start nodes
    const bool use_beam = beam > 0.0;
    for (int64_t gs = 0; gs < n;) {
        int64_t ge = gs;
        while (ge < n && times[order[ge]] == times[order[gs]]) ++ge;
        for (int64_t p = gs; p < ge; ++p) {
            int64_t nd = order[p];
            int64_t lo = in_off[nd], hi = in_off[nd + 1];
            if (lo == hi) continue;                       // start node
            double mx = -HUGE_VAL;
            for (int64_t k = lo; k < hi; ++k) {
                int64_t q = in_arc[k];
                double v = alpha[a_start[q]] + a_score[q];
                if (v > mx) mx = v;
            }
            if (mx > LOG_HALF_ZERO) {
                double es = 0.0;
                for (int64_t k = lo; k < hi; ++k) {
                    int64_t q = in_arc[k];
                    es += std::exp(alpha[a_start[q]] + a_score[q] - mx);
                }
                alpha[nd] = mx + std::log(es);
            } else {
                alpha[nd] = LOG_ZERO;
            }
        }
        if (use_beam) {
            double best = -HUGE_VAL;
            for (int64_t p = gs; p < ge; ++p)
                if (alpha[order[p]] > best) best = alpha[order[p]];
            if (best > LOG_HALF_ZERO) {
                for (int64_t p = gs; p < ge; ++p) {
                    int64_t nd = order[p];
                    if (alpha[nd] < best - beam) {
                        alpha[nd] = LOG_ZERO;
                        pruned[nd] = 1;
                    }
                }
            }
        }
        gs = ge;
    }

    // ---- beta (pruned nodes stay dead) ------------------------------
    std::vector<double> beta(n, LOG_ZERO);
    for (int64_t p = n - 1; p >= 0; --p) {
        int64_t nd = order[p];
        if (pruned[nd]) continue;
        int64_t lo = out_off[nd], hi = out_off[nd + 1];
        if (lo == hi) { beta[nd] = 0.0; continue; }       // end node
        double mx = -HUGE_VAL;
        for (int64_t k = lo; k < hi; ++k) {
            int64_t q = out_arc[k];
            double v = a_score[q] + beta[a_end[q]];
            if (v > mx) mx = v;
        }
        if (mx > LOG_HALF_ZERO) {
            double es = 0.0;
            for (int64_t k = lo; k < hi; ++k) {
                int64_t q = out_arc[k];
                es += std::exp(a_score[q] + beta[a_end[q]] - mx);
            }
            beta[nd] = mx + std::log(es);
        }
    }

    // ---- logZ over end nodes (ascending node index) -----------------
    double logZ;
    {
        double mx = -HUGE_VAL;
        bool any = false;
        for (int64_t i = 0; i < n; ++i)
            if (out_off[i + 1] == out_off[i]) {
                any = true;
                if (alpha[i] > mx) mx = alpha[i];
            }
        if (!any || mx <= LOG_ZERO) {
            logZ = LOG_ZERO;
        } else {
            double es = 0.0;
            for (int64_t i = 0; i < n; ++i)
                if (out_off[i + 1] == out_off[i])
                    es += std::exp(alpha[i] - mx);
            logZ = mx + std::log(es);
        }
    }
    if (logZ <= LOG_HALF_ZERO) return 1;

    // ---- Povey approximate accuracy per arc -------------------------
    std::vector<double> arc_acc(m, 0.0);
    for (int64_t q = 0; q < m; ++q) {
        if (a_hmm[q] < 0) continue;                       // no senones: 0
        double best = -1.0;
        double t0 = (double)a_t0[q], t1 = (double)a_t1[q];
        for (int64_t z = 0; z < nseg; ++z) {
            double ov = (t1 < seg_t1[z] ? t1 : seg_t1[z])
                        - (t0 > seg_t0[z] ? t0 : seg_t0[z]);
            if (ov < 0.0) ov = 0.0;
            double len = seg_t1[z] - seg_t0[z];
            if (len < 1.0) len = 1.0;
            double e = ov / len;
            double acc = (e > 0.0)
                ? (seg_code[z] == a_hmm[q] ? -1.0 + 2.0 * e : -1.0 + e)
                : -1.0;
            if (acc > best) best = acc;
        }
        arc_acc[q] = best;
    }

    // ---- accuracy-weighted means over the same structure ------------
    std::vector<double> alpha_acc(n, 0.0), beta_acc(n, 0.0);
    for (int64_t p = 0; p < n; ++p) {
        int64_t nd = order[p];
        int64_t lo = in_off[nd], hi = in_off[nd + 1];
        if (lo == hi) continue;
        double mx = -HUGE_VAL;
        for (int64_t k = lo; k < hi; ++k) {
            int64_t q = in_arc[k];
            double v = alpha[a_start[q]] + a_score[q];
            if (v > mx) mx = v;
        }
        if (mx <= LOG_HALF_ZERO) continue;                // stays 0
        double denom = 0.0, numer = 0.0;
        for (int64_t k = lo; k < hi; ++k) {
            int64_t q = in_arc[k];
            double w = std::exp(alpha[a_start[q]] + a_score[q] - mx);
            denom += w;
            numer += w * (alpha_acc[a_start[q]] + arc_acc[q]);
        }
        alpha_acc[nd] = numer / denom;
    }
    for (int64_t p = n - 1; p >= 0; --p) {
        int64_t nd = order[p];
        int64_t lo = out_off[nd], hi = out_off[nd + 1];
        if (lo == hi) continue;
        double mx = -HUGE_VAL;
        for (int64_t k = lo; k < hi; ++k) {
            int64_t q = out_arc[k];
            double v = a_score[q] + beta[a_end[q]];
            if (v > mx) mx = v;
        }
        if (mx <= LOG_HALF_ZERO) continue;
        double denom = 0.0, numer = 0.0;
        for (int64_t k = lo; k < hi; ++k) {
            int64_t q = out_arc[k];
            double w = std::exp(a_score[q] + beta[a_end[q]] - mx);
            denom += w;
            numer += w * (arc_acc[q] + beta_acc[a_end[q]]);
        }
        beta_acc[nd] = numer / denom;
    }

    double c_avg = 0.0;
    for (int64_t i = 0; i < n; ++i)
        if (out_off[i + 1] == out_off[i])
            c_avg += std::exp(alpha[i] - logZ) * alpha_acc[i];

    // ---- gamma coefficients + deferred-occupancy scatter ------------
    const double ocp = occup_scale;
    ArcFb fb;
    for (int64_t q = 0; q < m; ++q) {
        if (a_hmm[q] < 0) continue;
        double arg = alpha[a_start[q]] + a_score[q] + beta[a_end[q]] - logZ;
        if (arg > 0.0) arg = 0.0;
        if (arg < -700.0) arg = -700.0;
        double gq = std::exp(arg);
        double gq_s = (ocp == 1.0) ? gq : std::pow(gq, ocp);
        double coef = ml_gamma
            ? gq_s
            : gq_s * (alpha_acc[a_start[q]] + arc_acc[q]
                      + beta_acc[a_end[q]] - c_avg);
        if (coef == 0.0) continue;
        coef *= utt_weight;
        int hm = a_hmm[q];
        int S = h_S[hm];
        const int32_t* sen = h_sen + h_sen_off[hm];
        int t0 = a_t0[q], L = a_t1[q] - a_t0[q];
        if (S == 1) {
            int64_t col = sen[0];
            for (int t = 0; t < L; ++t) {
                double w = frame_w ? frame_w[t0 + t] : 1.0;
                gammas[(int64_t)(t0 + t) * C + col] += coef * w;
            }
        } else {
            arc_full_fb(log_post, C, sen, S, t0, L,
                        h_tp + h_tp_off[hm], kappa, fb);
            for (int t = 0; t < L; ++t) {
                double w = frame_w ? frame_w[t0 + t] : 1.0;
                for (int s = 0; s < S; ++s) {
                    double o = fb.occ[(size_t)t * S + s];
                    if (ocp != 1.0) o = std::pow(o, ocp);
                    gammas[(int64_t)(t0 + t) * C + sen[s]] += coef * o * w;
                }
            }
        }
    }

    out2[0] = c_avg;
    out2[1] = logZ;
    return 0;
}

}  // extern "C"
