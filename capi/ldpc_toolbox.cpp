// Native (host CPU) serving shim for ldpc-toolbox-tpu.
//
// A self-contained C++17 implementation of the encode/decode serving path
// with the exact numeric semantics of the framework's decoder arithmetic
// (ldpc_toolbox_tpu/decoder/arithmetic.py, itself mirroring the reference
// crate's src/decoder/arithmetic.rs): the Phi / Tanh / Minstarapprox /
// Aminstar families in f64/f32 and the 8-bit quantized variants with the
// Jones / partial-hard-limit / degree-1 clipping combinations, under the
// flooding and horizontal-layered schedules, selected by the same 36
// implementation names. Intended for GNU Radio-style consumers that link
// against the C ABI (capi/ldpc_toolbox.h) without a Python or JAX runtime.

#include "ldpc_toolbox.h"

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <functional>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Sparse parity-check matrix + alist parsing
// ---------------------------------------------------------------------------

struct SparseMatrix {
  size_t n_rows = 0, n_cols = 0;
  std::vector<std::vector<int>> rows;  // per check: variable indices
  std::vector<std::vector<int>> cols;  // per variable: check indices
};

bool parse_alist(const std::string &text, SparseMatrix &h) {
  std::istringstream in(text);
  std::string line;
  if (!std::getline(in, line)) return false;
  std::istringstream first(line);
  long ncols, nrows;
  if (!(first >> ncols >> nrows) || ncols <= 0 || nrows <= 0) return false;
  h.n_rows = static_cast<size_t>(nrows);
  h.n_cols = static_cast<size_t>(ncols);
  h.rows.assign(h.n_rows, {});
  h.cols.assign(h.n_cols, {});
  // skip the max-weight line and the two weight lines
  for (int skip = 0; skip < 3; ++skip) {
    if (!std::getline(in, line)) return false;
  }
  // column adjacency section (authoritative; 0 entries are padding)
  for (size_t c = 0; c < h.n_cols; ++c) {
    if (!std::getline(in, line)) return false;
    std::istringstream ls(line);
    long r;
    while (ls >> r) {
      if (r == 0) continue;
      if (r < 1 || static_cast<size_t>(r) > h.n_rows) return false;
      h.cols[c].push_back(static_cast<int>(r - 1));
      h.rows[static_cast<size_t>(r - 1)].push_back(static_cast<int>(c));
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Puncturing (block pattern; depuncture inserts zero-LLR erasures)
// ---------------------------------------------------------------------------

struct Puncturer {
  std::vector<bool> pattern;
  size_t num_trues = 0;

  bool parse(const std::string &s) {
    pattern.clear();
    num_trues = 0;
    std::istringstream in(s);
    std::string tok;
    while (std::getline(in, tok, ',')) {
      if (tok == "1") {
        pattern.push_back(true);
        ++num_trues;
      } else if (tok == "0") {
        pattern.push_back(false);
      } else {
        return false;
      }
    }
    return !pattern.empty() && num_trues > 0;
  }

  template <typename T>
  bool puncture(const std::vector<T> &in, std::vector<T> &out) const {
    if (in.size() % pattern.size() != 0) return false;
    size_t bs = in.size() / pattern.size();
    out.clear();
    out.reserve(bs * num_trues);
    for (size_t k = 0; k < pattern.size(); ++k) {
      if (pattern[k]) out.insert(out.end(), in.begin() + k * bs, in.begin() + (k + 1) * bs);
    }
    return true;
  }

  template <typename T>
  bool depuncture(const T *in, size_t len, std::vector<T> &out) const {
    if (len % num_trues != 0) return false;
    size_t bs = len / num_trues;
    out.assign(pattern.size() * bs, T(0));
    size_t j = 0;
    for (size_t k = 0; k < pattern.size(); ++k) {
      if (!pattern[k]) continue;
      std::copy(in + j * bs, in + (j + 1) * bs, out.begin() + k * bs);
      ++j;
    }
    return true;
  }
};

// ---------------------------------------------------------------------------
// Systematic encoder: staircase fast path or dense GF(2) generator
// ---------------------------------------------------------------------------

struct Encoder {
  size_t n = 0;  // rows of H (parity bits)
  size_t m = 0;  // cols of H (codeword bits)
  size_t k = 0;  // message bits
  bool staircase = false;
  // staircase: per parity row, message indices of H0
  std::vector<std::vector<int>> h0_rows;
  // dense: generator G0 = H1^-1 H0 as bit-packed rows of length k
  std::vector<std::vector<uint64_t>> g0;

  bool init(const SparseMatrix &h) {
    n = h.n_rows;
    m = h.n_cols;
    if (m < n) return false;
    k = m - n;
    staircase = is_staircase(h);
    if (staircase) {
      h0_rows.assign(n, {});
      for (size_t r = 0; r < n; ++r)
        for (int c : h.rows[r])
          if (static_cast<size_t>(c) < k) h0_rows[r].push_back(c);
      return true;
    }
    return build_dense(h);
  }

  static bool is_staircase(const SparseMatrix &h) {
    // exactly 2n-1 ones on the double diagonal of the parity part
    size_t n = h.n_rows, m = h.n_cols, count = 0;
    for (size_t r = 0; r < n; ++r) {
      for (int ci : h.rows[r]) {
        size_t c = static_cast<size_t>(ci);
        if (c < m - n) continue;
        if (r == 0 && c != m - n) return false;
        if (r != 0 && c != m - n + r - 1 && c != m - n + r) return false;
        ++count;
      }
    }
    return count == 2 * n - 1;
  }

  bool build_dense(const SparseMatrix &h) {
    // A = [H1 | H0] bit-packed; Gauss-Jordan the left block to identity
    size_t words = (m + 63) / 64;
    std::vector<std::vector<uint64_t>> a(n, std::vector<uint64_t>(words, 0));
    for (size_t r = 0; r < n; ++r) {
      for (int ci : h.rows[r]) {
        size_t c = static_cast<size_t>(ci);
        size_t t = (c < m - n) ? c + n : c - (m - n);
        a[r][t / 64] |= uint64_t(1) << (t % 64);
      }
    }
    auto get = [&](size_t r, size_t c) {
      return (a[r][c / 64] >> (c % 64)) & 1;
    };
    for (size_t j = 0; j < n; ++j) {
      size_t piv = j;
      while (piv < n && !get(piv, j)) ++piv;
      if (piv == n) return false;  // singular
      if (piv != j) std::swap(a[piv], a[j]);
      for (size_t r = 0; r < n; ++r) {
        if (r != j && get(r, j)) {
          for (size_t w = 0; w < words; ++w) a[r][w] ^= a[j][w];
        }
      }
    }
    // G0 = right block: columns n .. m-1, repacked per row over k bits
    size_t kw = (k + 63) / 64;
    g0.assign(n, std::vector<uint64_t>(kw, 0));
    for (size_t r = 0; r < n; ++r)
      for (size_t c = 0; c < k; ++c)
        if (get(r, n + c)) g0[r][c / 64] |= uint64_t(1) << (c % 64);
    return true;
  }

  void encode(const uint8_t *msg, std::vector<uint8_t> &cw) const {
    cw.assign(m, 0);
    std::copy(msg, msg + k, cw.begin());
    if (staircase) {
      uint8_t acc = 0;
      for (size_t r = 0; r < n; ++r) {
        uint8_t p = 0;
        for (int c : h0_rows[r]) p ^= msg[c] & 1;
        acc ^= p;
        cw[k + r] = acc;
      }
    } else {
      size_t kw = (k + 63) / 64;
      std::vector<uint64_t> mbits(kw, 0);
      for (size_t c = 0; c < k; ++c)
        if (msg[c] & 1) mbits[c / 64] |= uint64_t(1) << (c % 64);
      for (size_t r = 0; r < n; ++r) {
        uint64_t x = 0;
        for (size_t w = 0; w < kw; ++w) x ^= g0[r][w] & mbits[w];
        cw[k + r] = static_cast<uint8_t>(__builtin_popcountll(x) & 1);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Decoder arithmetic (scalar semantics identical to the reference)
// ---------------------------------------------------------------------------

// float families -------------------------------------------------------------

template <typename F>
struct PhiArith {
  using Llr = F;
  using Msg = F;
  static Llr quantize(double x) { return static_cast<F>(x); }
  static bool hard(Llr x) { return x <= 0; }
  static F phi(F x) {
    x = std::max<F>(x, static_cast<F>(1e-30));
    return -std::log(std::tanh(F(0.5) * x));
  }
  static void check(const std::vector<Msg> &in, std::vector<Msg> &out) {
    unsigned sign = 0;
    F sum = 0;
    thread_local std::vector<F> phis;
    phis.resize(in.size());
    for (size_t i = 0; i < in.size(); ++i) {
      F p = phi(std::abs(in[i]));
      phis[i] = p;
      sum += p;
      if (in[i] < 0) sign ^= 1;
    }
    out.resize(in.size());
    for (size_t i = 0; i < in.size(); ++i) {
      F y = phi(sum - phis[i]);
      unsigned s = (in[i] < 0) ? sign ^ 1 : sign;
      out[i] = s ? -y : y;
    }
  }
  static Llr var(Llr input, const std::vector<Msg> &in, std::vector<Msg> &out) {
    F total = input;
    for (F v : in) total += v;
    out.resize(in.size());
    for (size_t i = 0; i < in.size(); ++i) out[i] = total - in[i];
    return total;
  }
  static Msg layered_x(Llr qv, Msg rold) { return qv - rold; }
};

template <typename F, int CLAMP>
struct TanhArith : PhiArith<F> {
  using Msg = F;
  static void check(const std::vector<Msg> &in, std::vector<Msg> &out) {
    thread_local std::vector<F> tanhs;
    tanhs.resize(in.size());
    for (size_t i = 0; i < in.size(); ++i) {
      F half = F(0.5) * in[i];
      half = std::max<F>(std::min<F>(half, F(CLAMP)), F(-CLAMP));
      tanhs[i] = std::tanh(half);
    }
    out.resize(in.size());
    for (size_t i = 0; i < in.size(); ++i) {
      F prod = 1;
      for (size_t j = 0; j < in.size(); ++j)
        if (j != i) prod *= tanhs[j];
      out[i] = F(2) * std::atanh(prod);
    }
  }
};

template <typename F>
struct MinstarApproxArith : PhiArith<F> {
  using Msg = F;
  static void check(const std::vector<Msg> &in, std::vector<Msg> &out) {
    out.resize(in.size());
    for (size_t i = 0; i < in.size(); ++i) {
      unsigned sign = 0;
      bool first = true;
      F acc = 0;
      for (size_t j = 0; j < in.size(); ++j) {
        if (j == i) continue;
        F x = in[j];
        if (x < 0) sign ^= 1;
        x = std::abs(x);
        if (first) {
          acc = x;
          first = false;
        } else {
          acc = std::max<F>(
              std::min(x, acc) - std::log1p(std::exp(-std::abs(x - acc))), 0);
        }
      }
      out[i] = sign ? -acc : acc;
    }
  }
};

// Framework extension (matches the Python factory's Minsum* names, not in
// the reference's 36): plain min-sum via the two-minima trick, the cheapest
// scalar check rule — used as the honest CPU floor for the flagship bench.
template <typename F>
struct MinsumArith : PhiArith<F> {
  using Msg = F;
  static void check(const std::vector<Msg> &in, std::vector<Msg> &out) {
    F m1 = std::numeric_limits<F>::max();
    F m2 = std::numeric_limits<F>::max();
    size_t arg = 0;
    unsigned sign = 0;
    for (size_t j = 0; j < in.size(); ++j) {
      const F x = std::abs(in[j]);
      if (x < m1) {
        m2 = m1;
        m1 = x;
        arg = j;
      } else if (x < m2) {
        m2 = x;
      }
      if (in[j] < 0) sign ^= 1;
    }
    out.resize(in.size());
    for (size_t j = 0; j < in.size(); ++j) {
      const F mag = (j == arg) ? m2 : m1;
      const unsigned s = (in[j] < 0) ? sign ^ 1 : sign;
      out[j] = s ? -mag : mag;
    }
  }
};

template <typename F>
struct AminstarArith : PhiArith<F> {
  using Msg = F;
  static F mstar(F a, F b) {
    return std::min(a, b) - std::log1p(std::exp(-std::abs(a - b))) +
           std::log1p(std::exp(-(a + b)));
  }
  static void check(const std::vector<Msg> &in, std::vector<Msg> &out) {
    size_t argmin = 0;
    for (size_t j = 1; j < in.size(); ++j)
      if (std::abs(in[j]) < std::abs(in[argmin])) argmin = j;
    unsigned sign = 0;
    bool first = true;
    F delta = 0;
    for (size_t j = 0; j < in.size(); ++j) {
      if (in[j] < 0) sign ^= 1;
      if (j == argmin) continue;
      F x = std::abs(in[j]);
      if (first) {
        delta = x;
        first = false;
      } else {
        delta = mstar(delta, x);
      }
    }
    out.resize(in.size());
    out[argmin] = ((sign != 0) ^ (in[argmin] < 0)) ? -delta : delta;
    F d2 = mstar(delta, std::abs(in[argmin]));
    for (size_t j = 0; j < in.size(); ++j) {
      if (j == argmin) continue;
      out[j] = ((sign != 0) ^ (in[j] < 0)) ? -d2 : d2;
    }
  }
};

// 8-bit quantized families ----------------------------------------------------

struct I8Table {
  int8_t table[128];
  I8Table() {
    for (int t = 0; t < 128; ++t) {
      double x = std::floor(8.0 * std::log1p(std::exp(-t / 8.0)) + 0.5);
      table[t] = (x > 0) ? static_cast<int8_t>(x) : 0;
    }
  }
  int lookup(int t) const { return (t >= 0 && t < 128) ? table[t] : 0; }
};

const I8Table kI8Table;

inline int clip127(int x) { return std::max(-127, std::min(127, x)); }

template <bool JONES, bool HARD_LIMIT, bool DEG1, bool AMIN>
struct I8Arith {
  using Llr = int;   // int8-valued
  using Msg = int;   // int8-valued; layered Qv is int16-valued
  static Llr quantize(double llr) {
    double x = 8.0 * llr;
    if (x >= 127.0) return 127;
    if (x <= -127.0) return -127;
    return static_cast<int>(std::floor(std::abs(x) + 0.5)) * (x >= 0 ? 1 : -1);
  }
  static bool hard(Llr x) { return x <= 0; }
  static int phl(int x) {
    if (!HARD_LIMIT) return x;
    if (x <= -100) return -127;
    if (x >= 100) return 127;
    return x;
  }
  static void check(const std::vector<Msg> &in, std::vector<Msg> &out) {
    out.resize(in.size());
    if (!AMIN) {
      for (size_t i = 0; i < in.size(); ++i) {
        unsigned sign = 0;
        bool first = true;
        int acc = 0;
        for (size_t j = 0; j < in.size(); ++j) {
          if (j == i) continue;
          int x = in[j];
          if (x < 0) sign ^= 1;
          x = std::abs(x);
          if (first) {
            acc = x;
            first = false;
          } else {
            acc = std::max(std::min(x, acc) - kI8Table.lookup(std::abs(x - acc)), 0);
          }
        }
        out[i] = phl(sign ? -acc : acc);
      }
      return;
    }
    size_t argmin = 0;
    for (size_t j = 1; j < in.size(); ++j)
      if (std::abs(in[j]) < std::abs(in[argmin])) argmin = j;
    unsigned sign = 0;
    bool first = true;
    int delta = 0;
    auto mstar = [](int a, int b) {
      return std::max(std::min(a, b) - kI8Table.lookup(std::abs(a - b)) +
                          kI8Table.lookup(std::min(a + b, 127)),
                      0);
    };
    for (size_t j = 0; j < in.size(); ++j) {
      if (in[j] < 0) sign ^= 1;
      if (j == argmin) continue;
      int x = std::abs(in[j]);
      delta = first ? x : mstar(delta, x);
      first = false;
    }
    int dhl = phl(delta);
    out[argmin] = ((sign != 0) ^ (in[argmin] < 0)) ? -dhl : dhl;
    int d2 = phl(mstar(delta, std::abs(in[argmin])));
    for (size_t j = 0; j < in.size(); ++j) {
      if (j == argmin) continue;
      out[j] = ((sign != 0) ^ (in[j] < 0)) ? -d2 : d2;
    }
  }
  static Llr var(Llr input, const std::vector<Msg> &in, std::vector<Msg> &out) {
    if (DEG1 && in.size() == 1) input = std::max(-116, std::min(116, input));
    int total = input;  // i16-capacity accumulator
    for (int v : in) total += v;
    if (JONES) total = clip127(total);
    out.resize(in.size());
    for (size_t i = 0; i < in.size(); ++i) out[i] = clip127(total - in[i]);
    return clip127(total);
  }
  static Msg layered_x(int qv, Msg rold) { return clip127(qv - rold); }
};

// ---------------------------------------------------------------------------
// Schedules
// ---------------------------------------------------------------------------

struct IDecoder {
  virtual ~IDecoder() = default;
  // returns iterations >= 0 on success, -1 on failure; writes hard bits
  virtual int decode(const double *llrs, uint8_t *out, size_t out_len,
                     uint32_t max_iter) = 0;
};

template <typename A, bool LAYERED>
struct Decoder : IDecoder {
  SparseMatrix h;
  explicit Decoder(SparseMatrix hh) : h(std::move(hh)) {}

  bool check_hard(const std::vector<uint8_t> &bits) const {
    for (const auto &row : h.rows) {
      unsigned par = 0;
      for (int v : row) par ^= bits[static_cast<size_t>(v)];
      if (par & 1) return false;
    }
    return true;
  }

  int decode(const double *llrs, uint8_t *out, size_t out_len,
             uint32_t max_iter) override {
    size_t n = h.n_cols;
    std::vector<uint8_t> hard(n);
    for (size_t v = 0; v < n; ++v) hard[v] = llrs[v] <= 0;
    if (check_hard(hard)) {
      std::copy(hard.begin(), hard.begin() + out_len, out);
      return 0;
    }
    std::vector<typename A::Llr> q(n);
    for (size_t v = 0; v < n; ++v) q[v] = A::quantize(llrs[v]);

    int result = -1;
    if (!LAYERED) {
      result = flood(q, hard, max_iter);
    } else {
      result = layered(q, hard, max_iter);
    }
    std::copy(hard.begin(), hard.begin() + out_len, out);
    return result;
  }

  int flood(const std::vector<typename A::Llr> &q, std::vector<uint8_t> &hard,
            uint32_t max_iter) {
    size_t n = h.n_cols, m = h.n_rows;
    // v2c[c][slot] in row order; c2v likewise
    std::vector<std::vector<typename A::Msg>> v2c(m), c2v(m);
    for (size_t c = 0; c < m; ++c) {
      v2c[c].resize(h.rows[c].size());
      c2v[c].resize(h.rows[c].size());
      for (size_t t = 0; t < h.rows[c].size(); ++t)
        v2c[c][t] = q[static_cast<size_t>(h.rows[c][t])];
    }
    // slot of variable v within each incident row, precomputed once
    std::vector<std::vector<size_t>> var_slot(n);
    for (size_t v = 0; v < n; ++v) {
      var_slot[v].reserve(h.cols[v].size());
      for (int c : h.cols[v]) {
        const auto &row = h.rows[static_cast<size_t>(c)];
        var_slot[v].push_back(
            std::find(row.begin(), row.end(), static_cast<int>(v)) -
            row.begin());
      }
    }
    std::vector<typename A::Llr> post(n);
    std::vector<typename A::Msg> tmp_in, tmp_out;
    for (uint32_t it = 1; it <= max_iter; ++it) {
      for (size_t c = 0; c < m; ++c) A::check(v2c[c], c2v[c]);
      for (size_t v = 0; v < n; ++v) {
        tmp_in.clear();
        for (size_t i = 0; i < h.cols[v].size(); ++i)
          tmp_in.push_back(
              c2v[static_cast<size_t>(h.cols[v][i])][var_slot[v][i]]);
        post[v] = A::var(q[v], tmp_in, tmp_out);
        for (size_t i = 0; i < h.cols[v].size(); ++i)
          v2c[static_cast<size_t>(h.cols[v][i])][var_slot[v][i]] = tmp_out[i];
      }
      for (size_t v = 0; v < n; ++v) hard[v] = A::hard(post[v]);
      if (check_hard(hard)) return static_cast<int>(it);
    }
    return -1;
  }

  int layered(const std::vector<typename A::Llr> &q, std::vector<uint8_t> &hard,
              uint32_t max_iter) {
    size_t n = h.n_cols, m = h.n_rows;
    // posteriors in the arithmetic's Llr domain (int covers the i16
    // accumulator range of the quantized rules)
    std::vector<typename A::Llr> qvf(n);
    for (size_t v = 0; v < n; ++v) qvf[v] = q[v];
    std::vector<std::vector<typename A::Msg>> rcv(m);
    for (size_t c = 0; c < m; ++c) rcv[c].assign(h.rows[c].size(), typename A::Msg(0));
    std::vector<typename A::Msg> x, rnew;
    for (uint32_t it = 1; it <= max_iter; ++it) {
      for (size_t c = 0; c < m; ++c) {
        const auto &row = h.rows[c];
        x.resize(row.size());
        for (size_t t = 0; t < row.size(); ++t)
          x[t] = A::layered_x(qvf[static_cast<size_t>(row[t])], rcv[c][t]);
        A::check(x, rnew);
        for (size_t t = 0; t < row.size(); ++t) {
          qvf[static_cast<size_t>(row[t])] += rnew[t] - rcv[c][t];
          rcv[c][t] = rnew[t];
        }
      }
      for (size_t v = 0; v < n; ++v) hard[v] = A::hard(qvf[v]);
      if (check_hard(hard)) return static_cast<int>(it);
    }
    return -1;
  }
};

// ---------------------------------------------------------------------------
// Registry (the reference's 36 names, factory.rs:240-277)
// ---------------------------------------------------------------------------

std::unique_ptr<IDecoder> make_decoder(const std::string &name, SparseMatrix h) {
  using D64 = double;
  using D32 = float;
  using Tanh64 = TanhArith<D64, 18>;
  using Tanh32 = TanhArith<D32, 9>;
#define MK(NAME, ARITH, LAYERED) \
  if (name == NAME) return std::make_unique<Decoder<ARITH, LAYERED>>(std::move(h));
  MK("Phif64", PhiArith<D64>, false)
  MK("Phif32", PhiArith<D32>, false)
  MK("Tanhf64", Tanh64, false)
  MK("Tanhf32", Tanh32, false)
  MK("Minstarapproxf64", MinstarApproxArith<D64>, false)
  MK("Minstarapproxf32", MinstarApproxArith<D32>, false)
  MK("Aminstarf64", AminstarArith<D64>, false)
  MK("Aminstarf32", AminstarArith<D32>, false)
  MK("HLPhif64", PhiArith<D64>, true)
  MK("HLPhif32", PhiArith<D32>, true)
  MK("HLTanhf64", Tanh64, true)
  MK("HLTanhf32", Tanh32, true)
  MK("HLMinstarapproxf64", MinstarApproxArith<D64>, true)
  MK("HLMinstarapproxf32", MinstarApproxArith<D32>, true)
  MK("HLAminstarf64", AminstarArith<D64>, true)
  MK("HLAminstarf32", AminstarArith<D32>, true)
  // framework extensions (factory.py:74-75; bf16 storage is a device-side
  // concern — scalar CPU computes in f32 either way)
  MK("Minsumf64", MinsumArith<D64>, false)
  MK("Minsumf32", MinsumArith<D32>, false)
  MK("Minsumbf16", MinsumArith<D32>, false)
  MK("HLMinsumf64", MinsumArith<D64>, true)
  MK("HLMinsumf32", MinsumArith<D32>, true)
  MK("HLMinsumbf16", MinsumArith<D32>, true)
#define MKI8(NAME, J, H_, D, A, LAYERED) \
  if (name == NAME) \
    return std::make_unique<Decoder<I8Arith<J, H_, D, A>, LAYERED>>(std::move(h));
  MKI8("Minstarapproxi8", false, false, false, false, false)
  MKI8("Minstarapproxi8Jones", true, false, false, false, false)
  MKI8("Minstarapproxi8PartialHardLimit", false, true, false, false, false)
  MKI8("Minstarapproxi8JonesPartialHardLimit", true, true, false, false, false)
  MKI8("Minstarapproxi8Deg1Clip", false, false, true, false, false)
  MKI8("Minstarapproxi8JonesDeg1Clip", true, false, true, false, false)
  MKI8("Minstarapproxi8PartialHardLimitDeg1Clip", false, true, true, false, false)
  MKI8("Minstarapproxi8JonesPartialHardLimitDeg1Clip", true, true, true, false, false)
  MKI8("Aminstari8", false, false, false, true, false)
  MKI8("Aminstari8Jones", true, false, false, true, false)
  MKI8("Aminstari8PartialHardLimit", false, true, false, true, false)
  MKI8("Aminstari8JonesPartialHardLimit", true, true, false, true, false)
  MKI8("Aminstari8Deg1Clip", false, false, true, true, false)
  MKI8("Aminstari8JonesDeg1Clip", true, false, true, true, false)
  MKI8("Aminstari8PartialHardLimitDeg1Clip", false, true, true, true, false)
  MKI8("Aminstari8JonesPartialHardLimitDeg1Clip", true, true, true, true, false)
  MKI8("HLMinstarapproxi8", false, false, false, false, true)
  MKI8("HLMinstarapproxi8PartialHardLimit", false, true, false, false, true)
  MKI8("HLAminstari8", false, false, false, true, true)
  MKI8("HLAminstari8PartialHardLimit", false, true, false, true, true)
#undef MKI8
#undef MK
  return nullptr;
}

// ---------------------------------------------------------------------------
// C ABI objects
// ---------------------------------------------------------------------------

struct CDecoder {
  std::unique_ptr<IDecoder> dec;
  Puncturer punct;
  bool has_punct = false;
};

struct CEncoder {
  Encoder enc;
  Puncturer punct;
  bool has_punct = false;
};

bool read_file(const char *path, std::string &out) {
  std::ifstream f(path);
  if (!f) return false;
  std::ostringstream ss;
  ss << f.rdbuf();
  out = ss.str();
  return true;
}

CDecoder *decoder_from_alist(const std::string &alist, const char *impl,
                             const char *punct) {
  SparseMatrix h;
  if (!parse_alist(alist, h)) return nullptr;
  auto obj = std::make_unique<CDecoder>();
  if (punct && punct[0] != '\0') {
    if (!obj->punct.parse(punct)) return nullptr;
    obj->has_punct = true;
  }
  obj->dec = make_decoder(impl ? impl : "", std::move(h));
  if (!obj->dec) return nullptr;
  return obj.release();
}

CEncoder *encoder_from_alist(const std::string &alist, const char *punct) {
  SparseMatrix h;
  if (!parse_alist(alist, h)) return nullptr;
  auto obj = std::make_unique<CEncoder>();
  if (punct && punct[0] != '\0') {
    if (!obj->punct.parse(punct)) return nullptr;
    obj->has_punct = true;
  }
  if (!obj->enc.init(h)) return nullptr;
  return obj.release();
}

}  // namespace

extern "C" {

void *ldpc_toolbox_decoder_ctor(const char *alist_file_path,
                                const char *implementation,
                                const char *puncturing) {
  std::string alist;
  if (!alist_file_path || !read_file(alist_file_path, alist)) return nullptr;
  return decoder_from_alist(alist, implementation, puncturing);
}

void *ldpc_toolbox_decoder_ctor_alist_string(const char *alist,
                                             const char *implementation,
                                             const char *puncturing) {
  if (!alist) return nullptr;
  return decoder_from_alist(alist, implementation, puncturing);
}

void ldpc_toolbox_decoder_dtor(void *decoder) {
  delete static_cast<CDecoder *>(decoder);
}

int32_t ldpc_toolbox_decoder_decode_f64(void *decoder, uint8_t *output,
                                        size_t output_len, const double *llrs,
                                        size_t llrs_len,
                                        uint32_t max_iterations) {
  auto *d = static_cast<CDecoder *>(decoder);
  if (!d || !output || !llrs) return -1;
  if (d->has_punct) {
    std::vector<double> full;
    if (!d->punct.depuncture(llrs, llrs_len, full)) return -1;
    return d->dec->decode(full.data(), output, output_len, max_iterations);
  }
  return d->dec->decode(llrs, output, output_len, max_iterations);
}

int32_t ldpc_toolbox_decoder_decode_f32(void *decoder, uint8_t *output,
                                        size_t output_len, const float *llrs,
                                        size_t llrs_len,
                                        uint32_t max_iterations) {
  std::vector<double> as64(llrs, llrs + llrs_len);
  return ldpc_toolbox_decoder_decode_f64(decoder, output, output_len,
                                         as64.data(), llrs_len,
                                         max_iterations);
}

void *ldpc_toolbox_encoder_ctor(const char *alist_file_path,
                                const char *puncturing) {
  std::string alist;
  if (!alist_file_path || !read_file(alist_file_path, alist)) return nullptr;
  return encoder_from_alist(alist, puncturing);
}

void *ldpc_toolbox_encoder_ctor_alist_string(const char *alist,
                                             const char *puncturing) {
  if (!alist) return nullptr;
  return encoder_from_alist(alist, puncturing);
}

void ldpc_toolbox_encoder_dtor(void *encoder) {
  delete static_cast<CEncoder *>(encoder);
}

void ldpc_toolbox_encoder_encode(void *encoder, uint8_t *output,
                                 size_t output_len, const uint8_t *input,
                                 size_t input_len) {
  auto *e = static_cast<CEncoder *>(encoder);
  if (!e || !output || !input || input_len < e->enc.k) return;
  std::vector<uint8_t> cw;
  e->enc.encode(input, cw);
  if (e->has_punct) {
    std::vector<uint8_t> punctured;
    if (!e->punct.puncture(cw, punctured)) return;
    cw = std::move(punctured);
  }
  std::memcpy(output, cw.data(), std::min(output_len, cw.size()));
}

}  // extern "C"
