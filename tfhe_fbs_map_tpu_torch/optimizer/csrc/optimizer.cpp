// TFHE parameter optimizer of the PyTorch port: the native grid-search core.
//
// The C++ counterpart of tfhe_fbs_map_tpu_torch/optimizer/optimizer.py,
// enumeration for enumeration, as the JAX package's native/optimizer.cpp
// mirrors the JAX search.  The device constants are not compiled in: every
// search takes a Profile, the fields of the Python DeviceProfile plus the
// CUDA kernels' serving limits and the calibration's prices of K1 and K2,
// so one build prices any card.  The Python module is the reference;
// tests/test_torch_native_optimizer.py holds the two equal, solution for
// solution and function for function.
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
// generic path's cost by generic_slowdown), the serving limits of the
// CUDA kernels (ops/fused_blind_rotate.py K1_SLICE, K1_MAX_N, K1S_MAX_KN,
// K2_KC, K2_CHUNK; ops/blind_rotate.py KSK_MAX_BASE_LOG), and what
// runtime_model prices a launch by on the calibrated card: the launch
// sizes kernel_us sums over; the plans each kernel may launch at the
// shapes the searches walk (N >= k1_slice), with the clusters of each the
// card runs at once, from which a launch of any size takes its plan and
// waves as fused_blind_rotate's k1_ring_plan, k2_plan and k1_wide_plan
// take them; the kernels' fits across families and the families' own
// entries; and K1's small-tile plan: the families with its calibrated
// entry (their points, the ring's points beside them, and where timed on
// every tile and cluster each plan's µs by waves), else its fit across
// families at its own launch sizes (runtime_model.small_points: n times a
// step's µs at a shape timed, else n·step_us + scale·cost at 4 limbs) and
// the shapes it serves at 3 and 4 limbs.  Kernel index 0 is K2 ("fused"),
// 1 K1 ("fused_otf").  Filled by optimizer/native.py.
struct Profile {
  double int8_ops, mem_bytes, eff_fused, eff_otf;
  double k2_memory, k2_headroom;
  double k1_pair_cost;  // fused_blind_rotate.K1_PAIR_COST
  int32_t cuda_kernels;
  int32_t k1_slice, k1_max_n, k1s_max_kn, k2_kc, k2_chunk, ksk_max_base_log;
  int32_t sms;
  int32_t n_rows;
  const int32_t* rows;         // [n_rows]
  int32_t n_ring;
  const int32_t* ring;         // [n_ring][8]: k, N, bsk limbs, cb, cluster,
                               // nw, tiles a cluster, resident (K1's ring
                               // kernel)
  int32_t n_k2;
  const int32_t* k2;           // [n_k2][7]: k, N, bsk limbs, cb, cluster,
                               // resident, rows a ring stage
  int32_t n_tiles;
  const int32_t* tiles;        // [n_tiles][7]: k, N, l, bsk limbs, cb,
                               // cluster, resident (K1's small-tile plan)
  double fixed_us[2], scale[2], pair_scale[2];
  double around_a_us, around_b_us;
  int32_t n_entries;
  const int32_t* entry_keys;   // [n_entries][6]: n, k, N, l, ks_l, kernel
  const double* entry_fits;    // [n_entries][5]: fixed, scale, a, b,
                               // pair_scale (a paired wave's time over a
                               // wave of one tile)
  int32_t n_small;
  const int32_t* small_keys;   // [n_small][5]: n, k, N, l, ks_l (an entry)
  int32_t n_points;
  const int32_t* point_keys;   // [n_points][3]: family, rows, ring (0/1)
  const double* point_us;      // [n_points]: its kernel µs there
  int32_t n_plans;
  const int32_t* plans;        // [n_plans][6]: family, cb, cluster,
                               // resident, first, count (of plan_waves)
  const int32_t* plan_waves;   // the wave counts timed, ascending
  const double* plan_us;       // µs of the plan's fullest launch of each
  int32_t n_fit;
  const int32_t* fit_rows;     // [n_fit]: the fit's launch sizes
  const double* fit_step_us;   // [n_fit]
  const double* fit_scale;     // [n_fit]
  int32_t n_shape_fit;
  const int32_t* shape_fit_keys;  // [n_shape_fit][3]: k, N, l
  const double* shape_fit_step;   // [n_shape_fit][n_fit]: µs a step
  int32_t n_served;
  const int32_t* served;       // [n_served][3]: k, N, l
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
  if (b > 8 || b * l >= 32 || N % 32 || (N & (N - 1))) return false;
  // K1 below k1_slice is its small-N kernel, up to k1s_max_kn columns
  if (otf)
    return (N >= pr.k1_slice || int64_t(k + 1) * N <= pr.k1s_max_kn) &&
           (rows_n << (b + 6)) < (int64_t(1) << 31) && N <= pr.k1_max_n;
  // K2: whole contraction slices, and a cluster of one CTA splits the
  // (k+1)*N coefficients into whole column chunks (k2_clusters non-empty)
  return rows_n % pr.k2_kc == 0 && (int64_t(k + 1) * N) % pr.k2_chunk == 0;
}

// ops/blind_rotate.py fused_key_bytes()
int64_t fused_key_bytes(int n, int k, int N, int l, int bsk_limbs) {
  int64_t k1 = k + 1;
  return int64_t(n) * (k1 * l * N) * bsk_limbs * k1 * N;
}

bool prices_otf(const Profile& pr, int n, int k, int N, int l, int ks_l,
                int bsk_limbs, bool staged);

// optimizer.py bootstrap_cost_us(); orientation -1: the kernel the profile
// prices, 0: K2, 1: K1.
double bootstrap_cost_us(const Profile& pr, int n, int k, int N, int br_l,
                         int ks_l, int bsk_limbs, int orientation) {
  bool otf = orientation < 0
                 ? prices_otf(pr, n, k, N, br_l, ks_l, bsk_limbs, false)
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

// ------------------------------------------- a launch on the calibrated card

struct Plan {
  int cb = 0, cluster = 0, waves = 0, pair = 1;  // pair: tiles a cluster
};

// runtime_model._waves(): the waves of ``rows`` on tiles of ``cb``, ``pair``
// tiles a cluster, with ``resident`` clusters at once.
int waves_of(int rows, int cb, int resident, int pair = 1) {
  const int tiles = (std::max(rows, 1) + cb - 1) / cb;
  const int clusters = (tiles + pair - 1) / pair;
  const int at_once = std::max(1, resident);
  return (clusters + at_once - 1) / at_once;
}

// fused_blind_rotate.k1_ring_plan(): the least waves × span × cb × (64 +
// nw) / nw (times k1_pair_cost where a cluster carries two tiles), then
// the fewest CTAs, the larger tile, the wider nw, one tile a cluster.
bool ring_plan(const Profile& pr, int k, int N, int limbs, int rows,
               Plan* out) {
  const int64_t kn = int64_t(k + 1) * N;
  bool found = false;
  double best0 = 0.0;
  int64_t best1 = 0;
  int best2 = 0, best3 = 0, best4 = 0;
  for (int i = 0; i < pr.n_ring; ++i) {
    const int32_t* c = pr.ring + 8 * i;
    if (c[0] != k || c[1] != N || c[2] != limbs) continue;
    const int cb = c[3], cl = c[4], nw = c[5], pair = c[6];
    const int tiles = (std::max(rows, 1) + cb - 1) / cb;
    const int clusters = (tiles + pair - 1) / pair;
    const int w = waves_of(rows, cb, c[7], pair);
    const double cost = double(int64_t(w) * (kn / cl) * cb * (64 + nw)) / nw;
    const double k0 = pair == 2 ? cost * pr.k1_pair_cost : cost;
    const int64_t k1 = int64_t(clusters) * cl;
    if (!found || k0 < best0 ||
        (k0 == best0 &&
         (k1 < best1 ||
          (k1 == best1 &&
           (-cb < best2 ||
            (-cb == best2 &&
             (-nw < best3 || (-nw == best3 && pair < best4)))))))) {
      found = true;
      best0 = k0, best1 = k1, best2 = -cb, best3 = -nw, best4 = pair;
      *out = {cb, cl, w, pair};
    }
  }
  return found;
}

// fused_blind_rotate.k2_plan(): the least waves × stage rows / cluster,
// then the fewest CTAs, the larger tile.
bool k2_plan(const Profile& pr, int k, int N, int limbs, int rows,
             Plan* out) {
  bool found = false;
  double best0 = 0.0;
  int64_t best1 = 0;
  int best2 = 0;
  for (int i = 0; i < pr.n_k2; ++i) {
    const int32_t* c = pr.k2 + 7 * i;
    if (c[0] != k || c[1] != N || c[2] != limbs) continue;
    const int cb = c[3], cl = c[4];
    const int tiles = (std::max(rows, 1) + cb - 1) / cb;
    const int w = waves_of(rows, cb, c[5]);
    const double k0 = double(int64_t(w) * c[6]) / cl;
    const int64_t k1 = int64_t(tiles) * cl;
    if (!found || k0 < best0 ||
        (k0 == best0 && (k1 < best1 || (k1 == best1 && -cb < best2)))) {
      found = true;
      best0 = k0, best1 = k1, best2 = -cb;
      *out = {cb, cl, w};
    }
  }
  return found;
}

// The resident clusters of K1's small-tile plan (cb, cluster) at (k, N,
// l) and limbs, or -1 where it is not built for them.
int tile_resident(const Profile& pr, int k, int N, int l, int limbs, int cb,
                  int cluster) {
  for (int i = 0; i < pr.n_tiles; ++i) {
    const int32_t* c = pr.tiles + 7 * i;
    if (c[0] == k && c[1] == N && c[2] == l && c[3] == limbs &&
        c[4] == cb && (cluster < 0 || c[5] == cluster))
      return c[6];
  }
  return -1;
}

int small_family(const Profile& pr, int n, int k, int N, int l, int ks_l) {
  for (int f = 0; f < pr.n_small; ++f) {
    const int32_t* key = pr.small_keys + 5 * f;
    if (key[0] == n && key[1] == k && key[2] == N && key[3] == l &&
        key[4] == ks_l)
      return f;
  }
  return -1;
}

// runtime_model._plan_us(): a timed plan's µs at the waves of ``rows``.
double plan_us(const Profile& pr, int plan, int rows) {
  const int32_t* p = pr.plans + 6 * plan;
  const int w = waves_of(rows, p[1], p[3]);
  const int32_t* ws = pr.plan_waves + p[4];
  const double* us = pr.plan_us + p[4];
  const int count = p[5];
  for (int i = 0; i < count; ++i)
    if (ws[i] == w) return us[i];
  if (w < ws[0]) return us[0];
  if (w > ws[count - 1])
    return us[count - 1] * double(w) / double(ws[count - 1]);
  int hi = 0;
  while (ws[hi] < w) ++hi;
  const int lo = hi - 1;
  return us[lo] + (us[hi] - us[lo]) * double(w - ws[lo]) /
                      double(ws[hi] - ws[lo]);
}

// The timed plan (cb, cluster) of family f, or -1.
int family_plan(const Profile& pr, int f, int cb, int cluster) {
  for (int i = 0; i < pr.n_plans; ++i) {
    const int32_t* p = pr.plans + 6 * i;
    if (p[0] == f && p[1] == cb && p[2] == cluster) return i;
  }
  return -1;
}

// Whether family f of the small-tile plan's entries was timed on every
// tile and cluster.
bool timed(const Profile& pr, int f) {
  for (int i = 0; i < pr.n_plans; ++i)
    if (pr.plans[6 * i] == f) return true;
  return false;
}

bool of_shape(const Profile& pr, int f, int k, int N, int l) {
  const int32_t* key = pr.small_keys + 5 * f;
  return key[1] == k && key[2] == N && key[3] == l;
}

// runtime_model.small_tile_pick(): the plan of the least µs by waves at
// ``rows``, summed over the timed families of the shape (k, N, l) in the
// calibration's order; ties to the smaller tile, the larger cluster.
// False where no family of the shape was timed.
bool small_pick(const Profile& pr, int k, int N, int l, int rows, int* cb,
                int* cluster) {
  int first = 0;
  while (first < pr.n_small &&
         !(of_shape(pr, first, k, N, l) && timed(pr, first)))
    ++first;
  if (first == pr.n_small) return false;
  bool found = false;
  double best = 0.0;
  for (int i = 0; i < pr.n_plans; ++i) {
    const int32_t* p = pr.plans + 6 * i;
    if (p[0] != first) continue;
    double sum = 0.0;
    bool common = true;
    for (int f = first; f < pr.n_small && common; ++f) {
      if (!of_shape(pr, f, k, N, l) || !timed(pr, f)) continue;
      const int q = family_plan(pr, f, p[1], p[2]);
      if (q < 0)
        common = false;
      else
        sum += plan_us(pr, q, rows);
    }
    if (!common) continue;
    if (!found || sum < best ||
        (sum == best && (p[1] < *cb || (p[1] == *cb && p[2] > *cluster)))) {
      found = true;
      best = sum, *cb = p[1], *cluster = p[2];
    }
  }
  return found;
}

// fused_blind_rotate.k1_wide_plan() without a tile or cluster given: the
// pick where it serves the limbs, else the fewest waves, the smaller tile,
// the larger cluster.
bool wide_plan(const Profile& pr, int k, int N, int l, int limbs, int rows,
               Plan* out) {
  int cb = 0, cluster = 0;
  if (small_pick(pr, k, N, l, rows, &cb, &cluster)) {
    const int res = tile_resident(pr, k, N, l, limbs, cb, cluster);
    if (res >= 0) {
      *out = {cb, cluster, waves_of(rows, cb, res)};
      return true;
    }
  }
  bool found = false;
  for (int i = 0; i < pr.n_tiles; ++i) {
    const int32_t* c = pr.tiles + 7 * i;
    if (c[0] != k || c[1] != N || c[2] != l || c[3] != limbs) continue;
    const int w = waves_of(rows, c[4], c[6]);
    if (!found || w < out->waves ||
        (w == out->waves && (c[4] < out->cb ||
                             (c[4] == out->cb && c[5] > out->cluster)))) {
      found = true;
      *out = {c[4], c[5], w};
    }
  }
  return found;
}

// runtime_model.small_tile_us() of a family without points at a launch
// size, from the fit's points at 4 limbs (pts), scaled by cost / cost4.
double fit_tile_us(const Profile& pr, const std::vector<double>& pts,
                   int rows, double cost, double cost4) {
  const int last = pr.n_fit - 1;
  double us;
  if (rows <= pr.fit_rows[0]) {
    us = pts[0];
  } else if (rows >= pr.fit_rows[last]) {
    us = pts[last] * double(rows) / double(pr.fit_rows[last]);
  } else {
    int i = 1;
    while (rows > pr.fit_rows[i]) ++i;
    const int r0 = pr.fit_rows[i - 1], r1 = pr.fit_rows[i];
    us = pts[i - 1] +
         (pts[i] - pts[i - 1]) * double(rows - r0) / double(r1 - r0);
  }
  return us * (cost / cost4);
}

// A family's point of K1's small-tile plan (ring 0) or of the ring kernel
// (ring 1) at ``rows``; false where it has none.
bool point_at(const Profile& pr, int f, int rows, int ring, double* us) {
  for (int i = 0; i < pr.n_points; ++i) {
    const int32_t* p = pr.point_keys + 3 * i;
    if (p[0] == f && p[1] == rows && p[2] == ring) {
      *us = pr.point_us[i];
      return true;
    }
  }
  return false;
}

// runtime_model.small_tile_us(): K1's small-tile kernel µs at ``rows``, at
// the per-boot cost ``cost`` (over the cost at 4 limbs); NaN without a
// price.  The family's timed plans by waves where the pick is one of them,
// else its own points, else the fit across families where it serves the
// shape at 3 and 4 limbs.
double small_tile_us(const Profile& pr, int n, int k, int N, int l, int ks_l,
                     int rows, double cost) {
  const double cost4 = bootstrap_cost_us(pr, n, k, N, l, ks_l, 4, 1);
  const int f = small_family(pr, n, k, N, l, ks_l);
  if (f >= 0) {
    int cb = 0, cluster = 0;
    if (small_pick(pr, k, N, l, rows, &cb, &cluster)) {
      const int q = family_plan(pr, f, cb, cluster);
      if (q >= 0) return plan_us(pr, q, rows) * (cost / cost4);
    }
    std::vector<double> pts;
    std::vector<int> at;
    for (int i = 0; i < pr.n_points; ++i) {
      const int32_t* p = pr.point_keys + 3 * i;
      if (p[0] == f && p[2] == 0) {
        at.push_back(p[1]);
        pts.push_back(pr.point_us[i]);
      }
    }
    const int last = int(pts.size()) - 1;
    double us;
    if (rows <= at[0]) {
      us = pts[0];
    } else if (rows >= at[last]) {
      us = pts[last] * double(rows) / double(at[last]);
    } else {
      int i = 1;
      while (rows > at[i]) ++i;
      us = pts[i - 1] + (pts[i] - pts[i - 1]) * double(rows - at[i - 1]) /
                            double(at[i] - at[i - 1]);
    }
    return us * (cost / cost4);
  }
  if (pr.n_fit == 0 || N < pr.k1_slice) return NAN;
  int e = 0;
  while (e < pr.n_served &&
         !(pr.served[3 * e] == k && pr.served[3 * e + 1] == N &&
           pr.served[3 * e + 2] == l))
    ++e;
  if (e == pr.n_served) return NAN;
  int sh = 0;
  while (sh < pr.n_shape_fit &&
         !(pr.shape_fit_keys[3 * sh] == k &&
           pr.shape_fit_keys[3 * sh + 1] == N &&
           pr.shape_fit_keys[3 * sh + 2] == l))
    ++sh;
  std::vector<double> pts;
  for (int j = 0; j < pr.n_fit; ++j)
    pts.push_back(sh < pr.n_shape_fit
                      ? double(n) * pr.shape_fit_step[sh * pr.n_fit + j]
                      : double(n) * pr.fit_step_us[j] +
                            pr.fit_scale[j] * cost4);
  return fit_tile_us(pr, pts, rows, cost, cost4);
}

// The family's own entry of a kernel (fixed, scale, a, b), else the
// kernel's fit and the around fit across families.
void kernel_fit(const Profile& pr, int n, int k, int N, int l, int ks_l,
                int kern, double fit[5]) {
  fit[0] = pr.fixed_us[kern], fit[1] = pr.scale[kern];
  fit[2] = pr.around_a_us, fit[3] = pr.around_b_us;
  fit[4] = pr.pair_scale[kern];
  for (int e = 0; e < pr.n_entries; ++e) {
    const int32_t* key = pr.entry_keys + 6 * e;
    if (key[0] == n && key[1] == k && key[2] == N && key[3] == l &&
        key[4] == ks_l && key[5] == kern) {
      for (int i = 0; i < 5; ++i) fit[i] = pr.entry_fits[5 * e + i];
      return;
    }
  }
}

// runtime_model.small_tile_wins(): whether a K1 launch of ``rows`` takes
// the small-tile plan: it serves the family's shape at the limbs (tiles of
// 16), and its price is below the ring's, point against point where the
// family has both points at ``rows``, else against the ring's model.
bool small_tile_wins(const Profile& pr, int n, int k, int N, int l, int ks_l,
                     int limbs, int rows) {
  if (N < pr.k1_slice || tile_resident(pr, k, N, l, limbs, 16, -1) < 0)
    return false;
  const double cost = bootstrap_cost_us(pr, n, k, N, l, ks_l, limbs, 1);
  const double small = small_tile_us(pr, n, k, N, l, ks_l, rows, cost);
  if (std::isnan(small)) return false;
  const int f = small_family(pr, n, k, N, l, ks_l);
  double own = 0.0, ring = 0.0;
  if (f >= 0 && point_at(pr, f, rows, 1, &ring) &&
      point_at(pr, f, rows, 0, &own))
    return own < ring;
  Plan plan;
  if (!ring_plan(pr, k, N, limbs, rows, &plan)) return false;
  double fit[5];
  kernel_fit(pr, n, k, N, l, ks_l, 1, fit);
  const double wave = double(plan.cb) * pr.sms / plan.cluster * cost *
                      fit[1] * (plan.pair == 2 ? fit[4] : 1.0);
  return small < fit[0] + double(plan.waves) * wave;
}

// K1's or K2's plan of a launch of ``rows`` (runtime_model.launch_plan),
// and whether it is K1's small-tile plan (*small).
bool launch_plan(const Profile& pr, int n, int k, int N, int l, int ks_l,
                 int limbs, bool otf, int rows, Plan* plan, bool* small) {
  *small = otf && small_tile_wins(pr, n, k, N, l, ks_l, limbs, rows);
  if (*small) return wide_plan(pr, k, N, l, limbs, rows, plan);
  return otf ? ring_plan(pr, k, N, limbs, rows, plan)
             : k2_plan(pr, k, N, limbs, rows, plan);
}

// runtime_model.launch_us(): µs of a launch of ``rows`` at the per-boot
// cost ``cost``: its kernel and the work around it; NaN for a shape
// outside the profile's plans.
double launch_us(const Profile& pr, int n, int k, int N, int l, int ks_l,
                 int limbs, bool otf, int rows, double cost) {
  Plan plan;
  bool small = false;
  if (N < pr.k1_slice ||
      !launch_plan(pr, n, k, N, l, ks_l, limbs, otf, rows, &plan, &small))
    return NAN;
  double fit[5];
  kernel_fit(pr, n, k, N, l, ks_l, otf ? 1 : 0, fit);
  double kernel;
  if (small) {
    kernel = small_tile_us(pr, n, k, N, l, ks_l, rows, cost);
  } else {
    const double wave = double(plan.cb) * pr.sms / plan.cluster * cost *
                        fit[1] * (plan.pair == 2 ? fit[4] : 1.0);
    kernel = fit[0] + double(plan.waves) * wave;
  }
  return kernel + fit[2] + fit[3] * double(rows) * double(k * N + 1);
}

// runtime_model.launch_rows(): the ciphertexts a level's launch of
// ``real`` bootstraps an evaluation runs at ``v`` evaluations: v·r, r the
// least count at or above ``real`` whose v·r fills whole tiles of the plan
// that serves v·real, at most the level's power-of-two bucket; -1 for a
// shape outside the profile's plans.
int launch_rows(const Profile& pr, int n, int k, int N, int l, int ks_l,
                int limbs, bool otf, int real, int v) {
  if (real <= 0) return 0;
  Plan plan;
  bool small = false;
  int tile = 16;   // K1's small-N kernel
  if (!(otf && N < pr.k1_slice)) {
    if (!launch_plan(pr, n, k, N, l, ks_l, limbs, otf, v * real, &plan,
                     &small))
      return -1;
    tile = plan.cb;
  }
  int a = tile, b = v;
  while (b) a %= b, std::swap(a, b);
  const int step = tile / a;
  int bucket = 1;
  while (bucket < real) bucket *= 2;
  return v * std::min(bucket, (real + step - 1) / step * step);
}

// runtime_model.kernel_us(): launch_us of one call of each launch size
// through K1 (otf) or K2, at the profile's per-boot cost, summed in order;
// NaN for a shape outside the profile's plans.
double kernel_us(const Profile& pr, int n, int k, int N, int l, int ks_l,
                 int bsk_limbs, bool otf) {
  const double cost =
      bootstrap_cost_us(pr, n, k, N, l, ks_l, bsk_limbs, otf ? 1 : 0);
  double total = 0.0;
  for (int r = 0; r < pr.n_rows; ++r)
    total += launch_us(pr, n, k, N, l, ks_l, bsk_limbs, otf, pr.rows[r],
                       cost);
  return total;
}

// DeviceProfile.kernel() through ops/blind_rotate.py pick_kernel(): true
// for K1 ("fused_otf"), false for K2 ("fused").  K1 where K2 does not serve
// the family or its matrices do not fit, K2 where K1 does not serve it,
// else the lower kernel_us (K1 on a tie); without cuda_kernels the fit
// alone.  Its shell has gadget base 1, which neither kernel's size rules
// read.
bool prices_otf(const Profile& pr, int n, int k, int N, int l, int ks_l,
                int bsk_limbs, bool staged) {
  if (staged && pr.cuda_kernels) return true;
  if (pr.cuda_kernels && !kernel_serves(pr, k, N, l, 1, false)) return true;
  if (!(double(fused_key_bytes(n, k, N, l, bsk_limbs)) + pr.k2_headroom <=
        pr.k2_memory))
    return true;
  if (!pr.cuda_kernels || !kernel_serves(pr, k, N, l, 1, true)) return false;
  const double k2 = kernel_us(pr, n, k, N, l, ks_l, bsk_limbs, false);
  return !(k2 < kernel_us(pr, n, k, N, l, ks_l, bsk_limbs, true));
}

// DeviceProfile.serves()
bool serves(const Profile& pr, int n, int k, int N, int l, int b, int ks_l,
            int ks_b, int bsk_limbs, bool staged) {
  if (!pr.cuda_kernels) return true;
  bool otf = prices_otf(pr, n, k, N, l, ks_l, bsk_limbs, staged);
  return ks_b <= pr.ksk_max_base_log && kernel_serves(pr, k, N, l, b, otf);
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
                if (fast_path_only && !serves(pr, n, k, N, br_l, br_b, ks_l,
                                              ks_b, 4 - drop, false))
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
          if (!serves(pr, n, k, N, bl, bb, kl, best_kb[kl], 4, true))
            continue;
          const int orient = prices_otf(pr, n, k, N, bl, kl, 4, true) ? 1 : 0;
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
                  int32_t ks_l, int32_t ks_b, int32_t bsk_limbs,
                  int32_t staged, const Profile* prof) {
  return serves(*prof, n, k, N, l, b, ks_l, ks_b, bsk_limbs, staged != 0);
}
double nv_kernel_us(int32_t n, int32_t k, int32_t N, int32_t l, int32_t ks_l,
                    int32_t bsk_limbs, int32_t otf, const Profile* prof) {
  return kernel_us(*prof, n, k, N, l, ks_l, bsk_limbs, otf != 0);
}
int32_t nv_prices_otf(int32_t n, int32_t k, int32_t N, int32_t l,
                      int32_t ks_l, int32_t bsk_limbs, int32_t staged,
                      const Profile* prof) {
  return prices_otf(*prof, n, k, N, l, ks_l, bsk_limbs, staged != 0);
}
double nv_launch_us(int32_t n, int32_t k, int32_t N, int32_t l, int32_t ks_l,
                    int32_t bsk_limbs, int32_t otf, int32_t rows,
                    const Profile* prof) {
  const double cost =
      bootstrap_cost_us(*prof, n, k, N, l, ks_l, bsk_limbs, otf ? 1 : 0);
  return launch_us(*prof, n, k, N, l, ks_l, bsk_limbs, otf != 0, rows, cost);
}
int32_t nv_launch_rows(int32_t n, int32_t k, int32_t N, int32_t l,
                       int32_t ks_l, int32_t bsk_limbs, int32_t otf,
                       int32_t real, int32_t v, const Profile* prof) {
  return launch_rows(*prof, n, k, N, l, ks_l, bsk_limbs, otf != 0, real, v);
}
int32_t nv_small_tile_wins(int32_t n, int32_t k, int32_t N, int32_t l,
                           int32_t ks_l, int32_t bsk_limbs, int32_t rows,
                           const Profile* prof) {
  return small_tile_wins(*prof, n, k, N, l, ks_l, bsk_limbs, rows);
}

}  // extern "C"
