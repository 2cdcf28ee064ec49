// Native transform kernels for the host-side data pipeline.
//
// The vocabulary-defining transforms must produce values bit-identical to
// CPython's round(x, n) (correctly-rounded decimal rounding, half-even on
// the printed representation). CPython implements that via David Gay style
// correctly-rounded dtoa; glibc's printf("%.*f") is likewise correctly
// rounded (arbitrary-precision), so snprintf+strtod reproduces Python's
// round() exactly. These kernels move the per-element Python loops of the
// reference pipeline (reference: data_utils.py:361-662, measured 0.6-1.0M
// rows/s) into tight C++ loops.
//
// The PyTorch port's copy of the JAX package's runtime/transforms.cpp: the
// same functions, the same semantics. Built at first use (g++ -O2 -shared
// -fPIC, into runtime/_build/) and bound via ctypes
// (trade_aid_multimodal_transformer_tpu_torch/runtime/native.py), with the
// numpy/Python paths of data/transforms.py as the fallback.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>

// Correctly-rounded decimal rounding of one double to dp places, matching
// CPython round(float, dp) bit-for-bit.
//
// Fast path: s = x*10^dp carries <= a few ulps of error; when s is farther
// from a half-integer than that error bound, nearbyint(s) (round-half-even)
// picks the same integer N as exact decimal rounding would, and N/10^dp
// (both exactly representable for dp <= 22, |N| < 2^53) is the correctly
// rounded double of the decimal result. Near ties — where binary error
// could flip the decision — fall back to glibc's arbitrary-precision
// snprintf("%.*f") + strtod, which is correctly rounded like CPython's dtoa.
static inline double round_dp(double x, int dp, double p10) {
    if (!std::isfinite(x)) return x;
    double s = x * p10;
    double as = std::fabs(s);
    if (as < 9.0e15 && dp <= 22) {   // integers exact below 2^53
        double fl = std::floor(s);
        double frac = s - fl;
        double tie_dist = std::fabs(frac - 0.5);
        double tol = 1.0e-12 * (as + 1.0);
        if (tie_dist > tol) {
            return std::nearbyint(s) / p10;
        }
    }
    char buf[512];
    snprintf(buf, sizeof(buf), "%.*f", dp, x);
    return strtod(buf, nullptr);
}

extern "C" {

// Correctly-rounded decimal rounding of each element to `dp` places.
void tat_round_decimal(const double* in, int64_t n, int dp, double* out) {
    const double p10 = std::pow(10.0, dp);
    for (int64_t i = 0; i < n; ++i) out[i] = round_dp(in[i], dp, p10);
}

// Backward-looking percent changes: out[0] = 0.0;
// out[i] = round((in[i]-in[i-1])/in[i-1]*100, dp).
// Returns the index of the first zero previous value (lenient callers emit
// 0.0 there and continue; strict callers raise), or -1 if none.
// zero_mask[i] is set to 1 where the previous value was zero.
int64_t tat_percent_changes(
    const double* in, int64_t n, int dp, double* out, uint8_t* zero_mask) {
    const double p10 = std::pow(10.0, dp);
    int64_t first_zero = -1;
    if (n > 0) out[0] = 0.0;
    if (zero_mask && n > 0) zero_mask[0] = 0;
    for (int64_t i = 1; i < n; ++i) {
        double prev = in[i - 1];
        if (prev == 0.0) {
            if (first_zero < 0) first_zero = i - 1;
            out[i] = 0.0;
            if (zero_mask) zero_mask[i] = 1;
            continue;
        }
        if (zero_mask) zero_mask[i] = 0;
        double pct = ((in[i] - prev) / prev) * 100.0;
        out[i] = round_dp(pct, dp, p10);
    }
    return first_zero;
}

// Range scaling with fixed decimal places (the hot path; decimal_places
// inferred-per-element stays in Python). Reproduces the reference clip
// semantics (reference: data_utils.py:425-465): scale each element so its
// magnitude has `nwd` whole digits, round to `dp` places, clip into
// [10^(nwd-1), 10^nwd) with the boundary adjustments, restore sign.
// clip_lower/clip_upper flag positions where the reference produces Python
// ints (for exact type parity in the wrapper).
void tat_range_numeric(
    const double* in, int64_t n, int nwd, int dp,
    double* out, uint8_t* clip_lower, uint8_t* clip_upper_int) {
    const double lower = std::pow(10.0, nwd - 1);
    const double upper = std::pow(10.0, nwd);
    const double p10 = std::pow(10.0, dp);
    for (int64_t i = 0; i < n; ++i) {
        double x = in[i];
        int power;
        if (x == 0.0) {
            power = 0;
        } else {
            power = (int)std::floor(std::log10(std::fabs(x)));
        }
        double sf = std::pow(10.0, (double)(nwd - 1 - power));
        double scaled = round_dp(x * sf, dp, p10);

        double a = std::fabs(scaled);
        uint8_t cl = 0, cu = 0;
        if (a < lower && a > 0.0) { a = lower; cl = 1; }
        if (dp > 0) {
            if (a >= upper) a = upper - std::pow(10.0, -dp);
        } else {
            if (a >= upper) { a = upper - 1.0; cu = 1; }
        }
        out[i] = (x < 0.0) ? -a : a;
        if (clip_lower) clip_lower[i] = cl;
        if (clip_upper_int) clip_upper_int[i] = cu;
    }
}

// Exponential-boundary bin assignment (reference: data_utils.py:529-560).
// pos_b: G+1 ascending positive boundaries starting at 0.0.
// Positive values -> bin in [1, G]; zeros -> 0; negatives mirror to [-G, -1].
void tat_bin_assign(
    const double* in, int64_t n, const double* pos_b, int g, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        double v = in[i];
        if (v == 0.0) { out[i] = 0; continue; }
        if (v > 0.0) {
            // positive: [pos_b[j], pos_b[j+1]) -> bin j+1; beyond -> bin g
            int idx = g;
            for (int j = 0; j < g; ++j) {
                if (v >= pos_b[j] && v < pos_b[j + 1]) { idx = j + 1; break; }
            }
            out[i] = idx;
        } else {
            // negative boundaries are [-pos_b[g-j], -pos_b[g-j-1]) half-open
            // on the SIGNED value — not a mirror of the positive intervals
            // (reference: data_utils.py:549-558).
            int idx = -g;
            for (int j = 0; j < g; ++j) {
                double lo = -pos_b[g - j];
                double hi = -pos_b[g - j - 1];
                if (v >= lo && v < hi) { idx = -(g - j); break; }
            }
            out[i] = idx;
        }
    }
}

}  // extern "C"

// ------------------------------------------------------------- factorize
//
// Vocabulary build + tokenize (reference: data_utils.py:212-225 —
// sorted(set(data)) then per-element dict lookups). numpy's
// unique(return_inverse) pays an O(n log n) argsort over ALL rows; real
// vocabularies here are tiny (tens to hundreds of uniques per million
// rows), so an open-addressing hash (O(n) expected) + a sort of just the
// uniques wins. Semantics match np.unique for finite doubles: -0.0
// canonicalizes to +0.0 (they compare equal), codes are ranks in the
// sorted unique array. Callers must route NaN-containing inputs to the
// numpy path (NaN identity semantics differ).

#include <vector>
#include <algorithm>

// splitmix64 finalizer: masking with (cap-1) keeps only LOW hash bits, and
// the low bits of a bare multiply depend only on the low key bits — which
// cluster badly for decimal-rounded doubles (measured 20x slowdown from
// probe chains). A full avalanche mixer decorrelates every output bit.
static inline uint64_t mix64(uint64_t x) {
    x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
    x ^= x >> 27; x *= 0x94D049BB133111EBull;
    x ^= x >> 31;
    return x;
}

extern "C" {

// in: n doubles (no NaN). codes: n int32 sorted-rank ids. uniq: capacity-n
// buffer receiving the sorted unique values. Returns the unique count.
int64_t tat_factorize(const double* in, int64_t n, int32_t* codes,
                      double* uniq) {
    if (n <= 0) return 0;
    // open addressing, power-of-two capacity, bit-pattern keys
    int64_t cap = 1024;
    std::vector<uint64_t> keys(cap, 0);
    std::vector<int32_t> vals(cap, -1);
    std::vector<double> firsts;         // first-seen order
    firsts.reserve(1024);
    const uint64_t EMPTY = 0;           // key 0 == +0.0 handled via sentinel id
    int32_t zero_id = -1;

    auto rehash = [&]() {
        int64_t ncap = cap * 2;
        std::vector<uint64_t> nk(ncap, 0);
        std::vector<int32_t> nv(ncap, -1);
        for (int64_t i = 0; i < cap; ++i) {
            if (vals[i] < 0) continue;
            uint64_t kk = keys[i];
            uint64_t h = mix64(kk);
            int64_t j = (int64_t)(h & (uint64_t)(ncap - 1));
            while (nv[j] >= 0) j = (j + 1) & (ncap - 1);
            nk[j] = kk; nv[j] = vals[i];
        }
        keys.swap(nk); vals.swap(nv); cap = ncap;
    };

    for (int64_t i = 0; i < n; ++i) {
        double v = in[i];
        if (v == 0.0) v = 0.0;          // canonicalize -0.0
        uint64_t kk;
        std::memcpy(&kk, &v, 8);
        if (kk == EMPTY) {              // +0.0
            if (zero_id < 0) { zero_id = (int32_t)firsts.size(); firsts.push_back(0.0); }
            codes[i] = zero_id;
            continue;
        }
        uint64_t h = mix64(kk);
        int64_t j = (int64_t)(h & (uint64_t)(cap - 1));
        while (true) {
            if (vals[j] < 0) {
                int32_t id = (int32_t)firsts.size();
                keys[j] = kk; vals[j] = id;
                firsts.push_back(v);
                codes[i] = id;
                if ((int64_t)firsts.size() * 10 > cap * 7) rehash();
                break;
            }
            if (keys[j] == kk) { codes[i] = vals[j]; break; }
            j = (j + 1) & (cap - 1);
        }
    }

    // rank the first-seen uniques by value, remap codes to sorted ranks
    int64_t u = (int64_t)firsts.size();
    std::vector<int32_t> order(u);
    for (int64_t i = 0; i < u; ++i) order[i] = (int32_t)i;
    std::sort(order.begin(), order.end(),
              [&](int32_t a, int32_t b) { return firsts[a] < firsts[b]; });
    std::vector<int32_t> rank(u);
    for (int64_t r = 0; r < u; ++r) {
        rank[order[r]] = (int32_t)r;
        uniq[r] = firsts[order[r]];
    }
    for (int64_t i = 0; i < n; ++i) codes[i] = rank[codes[i]];
    return u;
}

}  // extern "C"
