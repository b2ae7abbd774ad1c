// TFHE parameter optimizer of the PyTorch port: the native grid-search core.
//
// The C++ counterpart of tfhe_fbs_map_tpu_torch/optimizer/optimizer.py,
// enumeration for enumeration, as the JAX package's native/optimizer.cpp
// mirrors the JAX search.  The device constants are not compiled in: every
// search takes a Profile, the fields of the Python DeviceProfile plus the
// CUDA kernels' serving limits, so one build prices any card.  The Python
// module is the reference; tests/test_torch_native_optimizer.py holds the
// two equal, solution for solution and function for function.
//
// Every floating-point expression keeps the Python module's operation order
// (x ** 2 is pow(x, 2.0)), so the floats are the same bits.  Build with
// contraction off (-ffp-contract=off): a fused multiply-add rounds once
// where Python rounds twice.
//
// Build:  g++ -O3 -shared -fPIC -ffp-contract=off -o lib.so optimizer.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// DeviceProfile's fields that the search reads (the caller scales the
// generic path's cost by generic_slowdown) and the serving limits of the
// CUDA kernels (ops/fused_blind_rotate.py K1_SLICE, K1_MAX_N, K2_KC,
// K2_CHUNK; ops/blind_rotate.py KSK_MAX_BASE_LOG), filled by
// optimizer/native.py.
struct Profile {
  double int8_ops, mem_bytes, eff_fused, eff_otf;
  double k2_memory, k2_headroom;
  int32_t cuda_kernels;
  int32_t k1_slice, k1_max_n, k2_kc, k2_chunk, ksk_max_base_log;
};

}  // extern "C"

namespace {

constexpr double Q = 4294967296.0;  // 2^32
constexpr int SELECT_P = 8;         // tfhe/staged.py

double min_noise_std_rel(int n) {
  double v = std::pow(2.0, -0.0245 * n);
  double floor_v = std::pow(2.0, -31.0);
  return v >= floor_v ? v : floor_v;
}

// ---------------------------------------------------------------- noise.py

double var_blind_rotate(int n, int k, int N, int l, int base_log,
                        double glwe_std) {
  double b = double(int64_t(1) << base_log);
  double beta2 = std::pow(b, double(2 * l));
  double key_term = double(int64_t(n) * l * (k + 1) * N) *
                    ((b * b + 2.0) / 12.0) * std::pow(glwe_std, 2.0);
  double round_term =
      double(n) * (1.0 + double(k * N)) / 2.0 * (Q * Q) / (12.0 * beta2);
  return key_term + round_term;
}

double var_keyswitch(int k, int N, int l, int base_log, double lwe_std) {
  double kn = double(k * N);
  double b = double(int64_t(1) << base_log);
  double key_term = kn * l * ((b * b) / 12.0) * std::pow(lwe_std, 2.0);
  double round_term = kn * std::pow(Q / std::pow(b, double(l)), 2.0) / 24.0;
  return key_term + round_term;
}

double var_modswitch(int n, int N) {
  double w = Q / (2.0 * N);
  return (w * w) * (1.0 + n / 2.0) / 12.0;
}

double var_bsk_quantization(int n, int k, int N, int l, int base_log,
                            int dropped_limbs) {
  if (dropped_limbs == 0) return 0.0;
  double b = double(int64_t(1) << base_log);
  double err_w = double(int64_t(1) << (8 * dropped_limbs));
  double per_product = ((b * b) / 12.0) * (err_w * err_w / 12.0);
  double mask_amp = 1.0 + double(k * N) / 2.0;
  return double(int64_t(n) * l * (k + 1) * N) * per_product * mask_amp;
}

double p_error_atomic(int p, double sq_norm2, int n, int k, int N, int br_l,
                      int br_b, int ks_l, int ks_b, double lwe_std,
                      double glwe_std, int dropped_limbs) {
  double v_wire = var_blind_rotate(n, k, N, br_l, br_b, glwe_std) +
                  var_bsk_quantization(n, k, N, br_l, br_b, dropped_limbs);
  double v_total = sq_norm2 * v_wire +
                   var_keyswitch(k, N, ks_l, ks_b, lwe_std) +
                   var_modswitch(n, N);
  double sigma = std::sqrt(v_total);
  double margin = Q / (4.0 * p);
  if (sigma == 0.0) return 0.0;
  return std::erfc(margin / (sigma * std::sqrt(2.0)));
}

double p_error_from_var(int p, double v_total) {
  if (v_total <= 0.0) return 0.0;
  return std::erfc((Q / (4.0 * p)) / (std::sqrt(v_total) * std::sqrt(2.0)));
}

// ------------------------------------------- the kernels' serving rules

// ops/fused_blind_rotate.py unsupported(): whether the CUDA kernel (K1 if
// otf, else K2) serves gadget base b, levels l, at (k, N).
bool kernel_serves(const Profile& pr, int k, int N, int l, int b, bool otf) {
  int64_t rows_n = int64_t(k + 1) * l * N;
  if (b > 8 || b * l >= 32 || N % 32) return false;
  if (otf)
    return N % pr.k1_slice == 0 && (rows_n << (b + 6)) < (int64_t(1) << 31) &&
           N <= pr.k1_max_n;
  // K2: whole contraction slices, and a cluster of one CTA splits the
  // (k+1)*N coefficients into whole column chunks (k2_clusters non-empty)
  return rows_n % pr.k2_kc == 0 && (int64_t(k + 1) * N) % pr.k2_chunk == 0;
}

// ops/blind_rotate.py fused_key_bytes()
int64_t fused_key_bytes(int n, int k, int N, int l, int bsk_limbs) {
  int64_t k1 = k + 1;
  return int64_t(n) * (k1 * l * N) * bsk_limbs * k1 * N;
}

// DeviceProfile.kernel(): true for K1 ("fused_otf"), false for K2
// ("fused").  Its shell has gadget base 1, which K2's size rules ignore.
bool prices_otf(const Profile& pr, int n, int k, int N, int l, int bsk_limbs,
                bool staged) {
  if (staged && pr.cuda_kernels) return true;
  if (pr.cuda_kernels && !kernel_serves(pr, k, N, l, 1, false)) return true;
  return !(double(fused_key_bytes(n, k, N, l, bsk_limbs)) + pr.k2_headroom <=
           pr.k2_memory);
}

// DeviceProfile.serves()
bool serves(const Profile& pr, int n, int k, int N, int l, int b, int ks_b,
            int bsk_limbs, bool staged) {
  if (!pr.cuda_kernels) return true;
  bool otf = prices_otf(pr, n, k, N, l, bsk_limbs, staged);
  return ks_b <= pr.ksk_max_base_log && kernel_serves(pr, k, N, l, b, otf);
}

// optimizer.py bootstrap_cost_us(); orientation -1: the kernel the profile
// prices, 0: K2, 1: K1.
double bootstrap_cost_us(const Profile& pr, int n, int k, int N, int br_l,
                         int ks_l, int bsk_limbs, int orientation) {
  bool otf = orientation < 0
                 ? prices_otf(pr, n, k, N, br_l, bsk_limbs, false)
                 : orientation == 1;
  double eff = otf ? pr.eff_otf : pr.eff_fused;
  int64_t br_macs =
      int64_t(n) * (k + 1) * (k + 1) * br_l * N * int64_t(N) * bsk_limbs;
  int64_t ks_macs = int64_t(k) * N * ks_l * (n + 1) * 4;
  double compute_s = 2.0 * double(br_macs + ks_macs) / (pr.int8_ops * eff);
  int64_t acc_bytes = int64_t(n) * 3 * (k + 1) * N * 4;
  double mem_s = double(acc_bytes) / pr.mem_bytes;
  return std::max(compute_s, mem_s) * 1e6;
}

// ------------------------------------------------------- optimize()

const int GLWE_SHAPES[][2] = {{1, 1024}, {2, 512}, {1, 2048}, {2, 1024},
                              {3, 512},  {4, 512}, {2, 2048}, {1, 4096}};

}  // namespace

extern "C" {

struct Solution {
  int32_t lwe_dim, glwe_dim, poly_size;
  int32_t bsk_level, bsk_base_log, ksk_level, ksk_base_log;
  double lwe_noise_std, glwe_noise_std;
  double cost_us, p_error;
  int32_t bsk_limbs;
};

// optimizer.py _optimize_inner(): 1 and *out filled, or 0 when no parameter
// set meets the error target.  The caller scales the generic path's cost.
int32_t optimize_params(int32_t p, double sq_norm2, double max_p_error,
                        int32_t fast_path_only, const Profile* prof,
                        Solution* out) {
  const Profile& pr = *prof;
  // int8 digits (the fast path) need base <= 2^8; the generic path can use
  // wider digits
  const int max_base = fast_path_only ? 8 : 12;
  // limb-drop quantization is a fast-path key layout knob only
  const int max_drop = fast_path_only ? 1 : 0;
  bool found = false;
  double best_cost = 0.0;
  for (const auto& kn : GLWE_SHAPES) {
    const int k = kn[0], N = kn[1];
    if (N < 2 * p) continue;
    const double glwe_std = min_noise_std_rel(k * N) * Q;
    for (int n = 450; n < 1100; n += 32) {
      const double lwe_std = min_noise_std_rel(n) * Q;
      for (int br_b = 4; br_b <= max_base; ++br_b)
        for (int br_l = 1; br_l <= 4; ++br_l) {
          if (br_b * br_l > 32) continue;
          for (int ks_b = 2; ks_b <= max_base; ++ks_b)
            for (int ks_l = 1; ks_l <= 8; ++ks_l) {
              if (ks_b * ks_l > 32) continue;
              for (int drop = 0; drop <= max_drop; ++drop) {
                const double cost = bootstrap_cost_us(pr, n, k, N, br_l, ks_l,
                                                      4 - drop, -1);
                if (found && cost >= best_cost) continue;
                const double perr =
                    p_error_atomic(p, sq_norm2, n, k, N, br_l, br_b, ks_l,
                                   ks_b, lwe_std, glwe_std, drop);
                if (perr > max_p_error) continue;
                if (fast_path_only &&
                    !serves(pr, n, k, N, br_l, br_b, ks_b, 4 - drop, false))
                  continue;
                found = true;
                best_cost = cost;
                *out = {n,       k,        N,         br_l, br_b, ks_l, ks_b,
                        lwe_std, glwe_std, cost,      perr, 4 - drop};
              }
            }
        }
    }
  }
  return found ? 1 : 0;
}

struct StagedSolutionC {
  // family 1 (stage-1 grid p/2, or p itself when p < 32)
  int32_t p1, n, k1, N1, bl1, bb1, kl1, kb1;
  // family 2 (the select grid)
  int32_t p2, k2, N2, bl2, bb2, kl2, kb2;
  double lwe_noise_std, glwe1_noise_std, glwe2_noise_std;
  double cost_us, p_error;
};

}  // extern "C"

namespace {

struct Cand {
  double cost, vw, ks, ms;
  int k, N, bl, bb, kl, kb;
};

// optimize_staged's candidates(): cost-sorted, stable.
void staged_candidates(const Profile& pr, int n, int min_N, int select_p,
                       int big_dim, std::vector<Cand>& out) {
  const double lwe_std = min_noise_std_rel(n) * Q;
  for (int k = 1; k <= 2; ++k) {
    if (big_dim % k) continue;
    const int N = big_dim / k;
    if (N < 2 * select_p || N < min_N) continue;
    const double g = min_noise_std_rel(k * N) * Q;
    const double ms = var_modswitch(n, N);
    // per key-switch level, the base of least variance
    double best_v[9];
    int best_kb[9] = {0};
    for (int kb = 2; kb <= 8; ++kb) {
      if (pr.cuda_kernels && kb > pr.ksk_max_base_log) continue;
      for (int kl = 1; kl <= 8; ++kl) {
        if (kb * kl > 32) continue;
        const double v = var_keyswitch(k, N, kl, kb, lwe_std);
        if (!best_kb[kl] || v < best_v[kl]) best_v[kl] = v, best_kb[kl] = kb;
      }
    }
    for (int bb = 4; bb <= 8; ++bb)
      for (int bl = 1; bl <= 5; ++bl) {
        const double vw = var_blind_rotate(n, k, N, bl, bb, g);
        for (int kl = 1; kl <= 8; ++kl) {
          if (!best_kb[kl]) continue;
          if (!serves(pr, n, k, N, bl, bb, best_kb[kl], 4, true)) continue;
          const int orient = prices_otf(pr, n, k, N, bl, 4, true) ? 1 : 0;
          out.push_back({bootstrap_cost_us(pr, n, k, N, bl, kl, 4, orient),
                         vw, best_v[kl], ms, k, N, bl, bb, kl, best_kb[kl]});
        }
      }
  }
  std::stable_sort(
      out.begin(), out.end(),
      [](const Cand& a, const Cand& b) { return a.cost < b.cost; });
}

}  // namespace

extern "C" {

// optimizer.py optimize_staged(), the same enumeration and pruning.
int32_t optimize_staged_params(int32_t p, double sq_norm1, double sq_norm2,
                               double max_p_error, int32_t big_dim,
                               int32_t wires_from_stage2, double weight1,
                               double weight2, const Profile* prof,
                               StagedSolutionC* out) {
  const Profile& pr = *prof;
  if (p % 2 || p < 8) return 0;
  const int stage1_p = p >= 2 * SELECT_P * 2 ? p / 2 : p;
  const int select_p = p % SELECT_P == 0 ? SELECT_P : p / 2;
  bool found = false;
  double best_cost = 0.0;
  for (int n = 450; n < 1100; n += 32) {
    const double lwe_std = min_noise_std_rel(n) * Q;
    std::vector<Cand> c2s, c1s;
    staged_candidates(pr, n, 2 * select_p, select_p, big_dim, c2s);
    staged_candidates(pr, n, 2 * stage1_p, select_p, big_dim, c1s);
    if (c2s.empty() || c1s.empty()) continue;
    const double min_c1 = c1s.front().cost;
    for (const Cand& c2 : c2s) {
      if (found && weight2 * c2.cost + weight1 * min_c1 >= best_cost) break;
      for (const Cand& c1 : c1s) {
        const double tot = weight1 * c1.cost + weight2 * c2.cost;
        if (found && tot >= best_cost) break;
        const double vw =
            wires_from_stage2 ? c2.vw : (c1.vw >= c2.vw ? c1.vw : c2.vw);
        const double e1 =
            p_error_from_var(stage1_p, sq_norm1 * vw + c1.ks + c1.ms);
        if (e1 > max_p_error) continue;
        const double e2 =
            p_error_from_var(select_p, c1.vw + sq_norm2 * vw + c2.ks + c2.ms);
        if (e2 > max_p_error) continue;
        found = true;
        best_cost = tot;
        *out = {stage1_p, n,     c1.k,  c1.N,  c1.bl,
                c1.bb,    c1.kl, c1.kb, select_p,
                c2.k,     c2.N,  c2.bl, c2.bb, c2.kl,
                c2.kb,    lwe_std,
                min_noise_std_rel(c1.k * c1.N) * Q,
                min_noise_std_rel(c2.k * c2.N) * Q,
                tot,      e1 + e2};
        break;  // c1s is cost-sorted: the first feasible is best for this c2
      }
    }
  }
  return found ? 1 : 0;
}

// The model functions one by one, for the lockstep tests: a compensating
// pair of errors cannot hide behind equal solutions.
double nv_var_blind_rotate(int32_t n, int32_t k, int32_t N, int32_t l,
                           int32_t base_log, double glwe_std) {
  return var_blind_rotate(n, k, N, l, base_log, glwe_std);
}
double nv_var_keyswitch(int32_t k, int32_t N, int32_t l, int32_t base_log,
                        double lwe_std) {
  return var_keyswitch(k, N, l, base_log, lwe_std);
}
double nv_var_modswitch(int32_t n, int32_t N) { return var_modswitch(n, N); }
double nv_var_bsk_quantization(int32_t n, int32_t k, int32_t N, int32_t l,
                               int32_t base_log, int32_t dropped_limbs) {
  return var_bsk_quantization(n, k, N, l, base_log, dropped_limbs);
}
double nv_p_error_atomic(int32_t p, double sq_norm2, int32_t n, int32_t k,
                         int32_t N, int32_t br_l, int32_t br_b, int32_t ks_l,
                         int32_t ks_b, double lwe_std, double glwe_std,
                         int32_t dropped_limbs) {
  return p_error_atomic(p, sq_norm2, n, k, N, br_l, br_b, ks_l, ks_b, lwe_std,
                        glwe_std, dropped_limbs);
}
double nv_p_error_from_var(int32_t p, double v_total) {
  return p_error_from_var(p, v_total);
}
double nv_bootstrap_cost_us(int32_t n, int32_t k, int32_t N, int32_t br_l,
                            int32_t ks_l, int32_t bsk_limbs,
                            int32_t orientation, const Profile* prof) {
  return bootstrap_cost_us(*prof, n, k, N, br_l, ks_l, bsk_limbs,
                           orientation);
}
int32_t nv_serves(int32_t n, int32_t k, int32_t N, int32_t l, int32_t b,
                  int32_t ks_b, int32_t bsk_limbs, int32_t staged,
                  const Profile* prof) {
  return serves(*prof, n, k, N, l, b, ks_b, bsk_limbs, staged != 0);
}

}  // extern "C"
