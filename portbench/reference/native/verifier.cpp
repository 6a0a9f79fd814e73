// luminair native verifier: full Circle-STARK verification in standalone C++.
//
// The cheap side of the protocol, independent of the Python/JAX stack --
// the role of the reference's Rust verifier crate
// (crates/verifiers/rust/src/verifier.rs:21-143).  Consumes the flat wire
// format written by luminair_tpu/serde.py (proof_to_flat_bytes /
// settings_to_flat_bytes) and replays the exact transcript of
// luminair_tpu/verifier.py:
//
//   claim -> recommit preprocessed tree -> roots -> interaction elements ->
//   LogUp balance -> composition alpha -> OODS point -> composition
//   identity -> sampled values -> gamma -> FRI replay -> PoW -> queries ->
//   Merkle decommitments -> DEEP quotients -> FRI fold checks.
//
// Build: see native/Makefile (shared lib for ctypes + `luminair-verify` CLI).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <set>
#include <string>
#include <vector>
#include <algorithm>

namespace luminair {

// ===========================================================================
// M31 / QM31 field arithmetic (mirrors luminair_tpu/fields/{m31,qm31}.py)
// ===========================================================================

static const uint32_t P = 2147483647u;  // 2^31 - 1
static const uint32_t INV2 = (P + 1) / 2;

static inline uint32_t m_add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // both < 2^31, no wrap
  return s >= P ? s - P : s;
}
static inline uint32_t m_sub(uint32_t a, uint32_t b) {
  uint32_t d = a + (P - b);
  return d >= P ? d - P : d;
}
static inline uint32_t m_neg(uint32_t a) {
  uint32_t r = P - a;
  return r >= P ? r - P : r;
}
static inline uint32_t m_mul(uint32_t a, uint32_t b) {
  uint64_t p = (uint64_t)a * (uint64_t)b;
  uint64_t r = (p & P) + (p >> 31);
  r = (r & P) + (r >> 31);
  return r >= P ? (uint32_t)(r - P) : (uint32_t)r;
}
static inline uint32_t m_pow(uint32_t a, uint64_t e) {
  uint32_t r = 1, base = a;
  while (e) {
    if (e & 1) r = m_mul(r, base);
    base = m_mul(base, base);
    e >>= 1;
  }
  return r;
}
static inline uint32_t m_inv(uint32_t a) { return m_pow(a, (uint64_t)P - 2); }

struct QM31 {
  uint32_t c[4];
  QM31() { c[0] = c[1] = c[2] = c[3] = 0; }
  QM31(uint32_t a, uint32_t b, uint32_t cc, uint32_t d) {
    c[0] = a; c[1] = b; c[2] = cc; c[3] = d;
  }
  static QM31 from_m31(uint32_t a) { return QM31(a, 0, 0, 0); }
  static QM31 one() { return QM31(1, 0, 0, 0); }
  bool operator==(const QM31& o) const {
    return c[0] == o.c[0] && c[1] == o.c[1] && c[2] == o.c[2] && c[3] == o.c[3];
  }
  bool is_zero() const { return c[0] == 0 && c[1] == 0 && c[2] == 0 && c[3] == 0; }
};

static inline QM31 q_add(const QM31& x, const QM31& y) {
  return QM31(m_add(x.c[0], y.c[0]), m_add(x.c[1], y.c[1]),
              m_add(x.c[2], y.c[2]), m_add(x.c[3], y.c[3]));
}
static inline QM31 q_sub(const QM31& x, const QM31& y) {
  return QM31(m_sub(x.c[0], y.c[0]), m_sub(x.c[1], y.c[1]),
              m_sub(x.c[2], y.c[2]), m_sub(x.c[3], y.c[3]));
}
static inline QM31 q_neg(const QM31& x) {
  return QM31(m_neg(x.c[0]), m_neg(x.c[1]), m_neg(x.c[2]), m_neg(x.c[3]));
}
static inline void cm_mul(uint32_t ar, uint32_t ai, uint32_t br, uint32_t bi,
                          uint32_t& rr, uint32_t& ri) {
  rr = m_sub(m_mul(ar, br), m_mul(ai, bi));
  ri = m_add(m_mul(ar, bi), m_mul(ai, br));
}
static inline QM31 q_mul(const QM31& x, const QM31& y) {
  // QM31 = CM31[u]/(u^2 - (2+i)): (A + Bu)(C + Du) = AC + R BD + (AD + BC)u
  uint32_t ac_r, ac_i, bd_r, bd_i, ad_r, ad_i, bc_r, bc_i;
  cm_mul(x.c[0], x.c[1], y.c[0], y.c[1], ac_r, ac_i);
  cm_mul(x.c[2], x.c[3], y.c[2], y.c[3], bd_r, bd_i);
  cm_mul(x.c[0], x.c[1], y.c[2], y.c[3], ad_r, ad_i);
  cm_mul(x.c[2], x.c[3], y.c[0], y.c[1], bc_r, bc_i);
  uint32_t rbd_r = m_sub(m_add(bd_r, bd_r), bd_i);
  uint32_t rbd_i = m_add(bd_r, m_add(bd_i, bd_i));
  return QM31(m_add(ac_r, rbd_r), m_add(ac_i, rbd_i),
              m_add(ad_r, bc_r), m_add(ad_i, bc_i));
}
static inline QM31 q_mul_m31(const QM31& x, uint32_t s) {
  return QM31(m_mul(x.c[0], s), m_mul(x.c[1], s), m_mul(x.c[2], s), m_mul(x.c[3], s));
}
static inline QM31 q_inv(const QM31& x) {
  // (A + Bu)^-1 = (A - Bu)/(A^2 - R B^2)
  uint32_t a2_r, a2_i, b2_r, b2_i;
  cm_mul(x.c[0], x.c[1], x.c[0], x.c[1], a2_r, a2_i);
  cm_mul(x.c[2], x.c[3], x.c[2], x.c[3], b2_r, b2_i);
  uint32_t rb2_r = m_sub(m_add(b2_r, b2_r), b2_i);
  uint32_t rb2_i = m_add(b2_r, m_add(b2_i, b2_i));
  uint32_t den_r = m_sub(a2_r, rb2_r);
  uint32_t den_i = m_sub(a2_i, rb2_i);
  uint32_t n = m_add(m_mul(den_r, den_r), m_mul(den_i, den_i));
  uint32_t ninv = m_inv(n);
  uint32_t di_r = m_mul(den_r, ninv);
  uint32_t di_i = m_mul(m_neg(den_i), ninv);
  uint32_t na_r, na_i, nb_r, nb_i;
  cm_mul(x.c[0], x.c[1], di_r, di_i, na_r, na_i);
  cm_mul(m_neg(x.c[2]), m_neg(x.c[3]), di_r, di_i, nb_r, nb_i);
  return QM31(na_r, na_i, nb_r, nb_i);
}
static inline QM31 q_pow(const QM31& x, uint64_t e) {
  QM31 r = QM31::one(), base = x;
  while (e) {
    if (e & 1) r = q_mul(r, base);
    base = q_mul(base, base);
    e >>= 1;
  }
  return r;
}
static inline QM31 q_conj_cm31(const QM31& x) {
  // Gal(QM31/CM31): (A + Bu) -> (A - Bu)
  return QM31(x.c[0], x.c[1], m_neg(x.c[2]), m_neg(x.c[3]));
}

// ===========================================================================
// Blake2s-256 (scalar; bit-identical to hashlib.blake2s)
// ===========================================================================

static const uint32_t B2S_IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};

static const uint8_t B2S_SIGMA[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0}};

static inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void b2s_compress(uint32_t h[8], const uint32_t m[16], uint64_t t, bool last) {
  uint32_t v[16];
  for (int i = 0; i < 8; i++) v[i] = h[i];
  for (int i = 0; i < 8; i++) v[8 + i] = B2S_IV[i];
  v[12] ^= (uint32_t)(t & 0xFFFFFFFFu);
  v[13] ^= (uint32_t)(t >> 32);
  if (last) v[14] ^= 0xFFFFFFFFu;
#define G(a, b, c, d, x, y)            \
  v[a] = v[a] + v[b] + (x);            \
  v[d] = rotr32(v[d] ^ v[a], 16);      \
  v[c] = v[c] + v[d];                  \
  v[b] = rotr32(v[b] ^ v[c], 12);      \
  v[a] = v[a] + v[b] + (y);            \
  v[d] = rotr32(v[d] ^ v[a], 8);       \
  v[c] = v[c] + v[d];                  \
  v[b] = rotr32(v[b] ^ v[c], 7);
  for (int r = 0; r < 10; r++) {
    const uint8_t* s = B2S_SIGMA[r];
    G(0, 4, 8, 12, m[s[0]], m[s[1]]);
    G(1, 5, 9, 13, m[s[2]], m[s[3]]);
    G(2, 6, 10, 14, m[s[4]], m[s[5]]);
    G(3, 7, 11, 15, m[s[6]], m[s[7]]);
    G(0, 5, 10, 15, m[s[8]], m[s[9]]);
    G(1, 6, 11, 12, m[s[10]], m[s[11]]);
    G(2, 7, 8, 13, m[s[12]], m[s[13]]);
    G(3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
#undef G
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[8 + i];
}

// Hash raw bytes -> 32-byte digest.
static void blake2s(const uint8_t* data, size_t len, uint8_t out[32]) {
  uint32_t h[8];
  for (int i = 0; i < 8; i++) h[i] = B2S_IV[i];
  h[0] ^= 0x01010000u ^ 32u;
  size_t off = 0;
  uint64_t t = 0;
  // Process all but the final block.
  while (len - off > 64) {
    uint32_t m[16];
    memcpy(m, data + off, 64);  // little-endian host assumed (x86/ARM LE)
    t += 64;
    b2s_compress(h, m, t, false);
    off += 64;
  }
  uint32_t m[16] = {0};
  size_t take = len - off;
  memcpy(m, data + off, take);
  t += take;
  b2s_compress(h, m, t, true);
  memcpy(out, h, 32);
}

struct Digest {
  uint32_t w[8];
  bool operator==(const Digest& o) const { return memcmp(w, o.w, 32) == 0; }
};

// Hash a message given as uint32 words (LE serialization), like
// crypto/blake2s.py hash_words.
static Digest hash_words(const uint32_t* words, size_t n_words) {
  Digest d;
  blake2s((const uint8_t*)words, n_words * 4, (uint8_t*)d.w);
  return d;
}

// ===========================================================================
// Fiat-Shamir channel (mirrors crypto/channel.py exactly)
// ===========================================================================

struct Channel {
  uint8_t digest[32];
  uint64_t counter;

  Channel() : counter(0) { memset(digest, 0, 32); }

  void mix_bytes(const uint8_t* data, size_t len) {
    std::vector<uint8_t> buf(32 + len);
    memcpy(buf.data(), digest, 32);
    memcpy(buf.data() + 32, data, len);
    blake2s(buf.data(), buf.size(), digest);
    counter = 0;
  }
  void mix_u32s(const uint32_t* v, size_t n) { mix_bytes((const uint8_t*)v, n * 4); }
  void mix_u64(uint64_t v) {
    uint8_t b[8];
    memcpy(b, &v, 8);
    mix_bytes(b, 8);
  }
  void mix_root(const Digest& d) { mix_u32s(d.w, 8); }
  void mix_felt(const QM31& f) { mix_u32s(f.c, 4); }
  void mix_felts(const uint32_t* v, size_t n_words) { mix_u32s(v, n_words); }

  void draw_block(uint8_t out[32]) {
    uint8_t buf[40];
    memcpy(buf, digest, 32);
    memcpy(buf + 32, &counter, 8);
    blake2s(buf, 40, out);
    counter++;
  }
  void draw_base_felts(uint32_t* out, size_t n) {
    size_t got = 0;
    while (got < n) {
      uint8_t blk[32];
      draw_block(blk);
      uint32_t words[8];
      memcpy(words, blk, 32);
      for (int i = 0; i < 8 && got < n; i++) {
        uint32_t w = words[i];
        if (w < 2 * (uint64_t)P) out[got++] = w % P;
      }
    }
  }
  QM31 draw_felt() {
    QM31 f;
    draw_base_felts(f.c, 4);
    return f;
  }
  std::vector<int64_t> draw_queries(size_t n, int log_domain) {
    uint64_t mask = ((uint64_t)1 << log_domain) - 1;
    std::vector<int64_t> picked;
    while (picked.size() < n) {
      uint8_t blk[32];
      draw_block(blk);
      uint32_t words[8];
      memcpy(words, blk, 32);
      for (int i = 0; i < 8 && picked.size() < n; i++)
        picked.push_back((int64_t)(words[i] & mask));
    }
    std::sort(picked.begin(), picked.end());
    picked.erase(std::unique(picked.begin(), picked.end()), picked.end());
    return picked;
  }
  bool check_pow_nonce(int bits, uint64_t nonce) {
    if (bits == 0) return true;
    uint8_t buf[40], h[32];
    memcpy(buf, digest, 32);
    memcpy(buf + 32, &nonce, 8);
    blake2s(buf, 40, h);
    uint64_t v;
    memcpy(&v, h, 8);
    return (v & (((uint64_t)1 << bits) - 1)) == 0;
  }
};

// ===========================================================================
// Circle group / domains / twiddles (mirrors circle.py)
// ===========================================================================

struct Pt {
  uint32_t x, y;
};

static inline Pt pt_add(Pt p, Pt q) {
  return {m_sub(m_mul(p.x, q.x), m_mul(p.y, q.y)),
          m_add(m_mul(p.x, q.y), m_mul(p.y, q.x))};
}
static inline Pt pt_double(Pt p) {
  uint32_t x2 = m_mul(p.x, p.x);
  return {m_sub(m_add(x2, x2), 1u), m_add(m_mul(p.x, p.y), m_mul(p.x, p.y))};
}

static const Pt CIRCLE_GEN = {2u, 1268011823u};
static const int CIRCLE_LOG_ORDER = 31;

static Pt group_gen(int log_size) {
  Pt g = CIRCLE_GEN;
  for (int i = 0; i < CIRCLE_LOG_ORDER - log_size; i++) g = pt_double(g);
  return g;
}

// (2i+1) * G_{log+1}, i in [0, 2^log)
struct Domain {
  std::vector<uint32_t> xs, ys;
};

static Domain domain_points(int log_size) {
  size_t n = (size_t)1 << log_size;
  Pt q = group_gen(log_size + 1);
  Pt step = pt_double(q);
  Domain d;
  d.xs.resize(n);
  d.ys.resize(n);
  Pt cur = q;
  for (size_t i = 0; i < n; i++) {
    d.xs[i] = cur.x;
    d.ys[i] = cur.y;
    cur = pt_add(cur, step);
  }
  return d;
}

static inline uint32_t pi_x(uint32_t x) {
  uint32_t x2 = m_mul(x, x);
  return m_sub(m_add(x2, x2), 1u);
}
static inline QM31 pi_x_q(const QM31& x) {
  QM31 x2 = q_mul(x, x);
  return q_sub(q_add(x2, x2), QM31::one());
}

struct QPt {
  QM31 x, y;
};
static inline QPt qpt_add(const QPt& p, const QPt& q) {
  return {q_sub(q_mul(p.x, q.x), q_mul(p.y, q.y)),
          q_add(q_mul(p.x, q.y), q_mul(p.y, q.x))};
}
static inline QPt qpt_sub(const QPt& p, const QPt& q) {
  QPt nq = {q.x, q_neg(q.y)};
  return qpt_add(p, nq);
}
static QPt point_from_t(const QM31& t) {
  QM31 one = QM31::one();
  QM31 t2 = q_mul(t, t);
  QM31 dinv = q_inv(q_add(one, t2));
  return {q_mul(q_sub(one, t2), dinv), q_mul(q_add(t, t), dinv)};
}

// Forward-FFT twiddles (top first): tw[0] = ys[:n/2]; tw[k] = x chain.
static std::vector<std::vector<uint32_t>> fft_twiddles(int log_n) {
  Domain d = domain_points(log_n);
  size_t n = (size_t)1 << log_n;
  std::vector<std::vector<uint32_t>> tw;
  tw.emplace_back(d.ys.begin(), d.ys.begin() + n / 2);
  std::vector<uint32_t> cur(d.xs.begin(), d.xs.begin() + n / 2);
  while (cur.size() >= 2) {
    tw.emplace_back(cur.begin(), cur.begin() + cur.size() / 2);
    std::vector<uint32_t> nxt(cur.size() / 2);
    for (size_t i = 0; i < nxt.size(); i++) nxt[i] = pi_x(cur[i]);
    cur = nxt;
  }
  return tw;
}

static std::vector<std::vector<uint32_t>> ifft_twiddles(int log_n) {
  auto tw = fft_twiddles(log_n);
  for (auto& stage : tw)
    for (auto& t : stage) t = m_mul(m_inv(t), INV2);  // 1/(2t)
  return tw;
}

// V_n evaluated at a QM31 x-coordinate: pi^(n-1)(x).
static QM31 coset_vanishing_q(const QM31& x, int trace_log) {
  QM31 v = x;
  for (int i = 0; i < trace_log - 1; i++) v = pi_x_q(v);
  return v;
}

// ===========================================================================
// Circle FFT / iFFT / LDE on M31 columns (mirrors fft.py, scalar loops)
// ===========================================================================

static void ifft_inplace(std::vector<uint32_t>& a,
                         const std::vector<std::vector<uint32_t>>& tw_inv) {
  size_t n = a.size();
  if (n <= 1) return;
  std::vector<uint32_t> b(n);
  // Circle stage: pair (i, n-1-i).
  for (size_t i = 0; i < n / 2; i++) {
    uint32_t v0 = a[i], v1 = a[n - 1 - i];
    b[i] = m_mul(m_add(v0, v1), INV2);
    b[n / 2 + i] = m_mul(m_sub(v0, v1), tw_inv[0][i]);
  }
  a.swap(b);
  // Line stages.
  size_t n_blocks = 2, m = n / 2;
  int stage = 1;
  while (m >= 2) {
    const auto& t = tw_inv[stage];
    for (size_t blk = 0; blk < n_blocks; blk++) {
      size_t base = blk * m;
      for (size_t j = 0; j < m / 2; j++) {
        uint32_t v0 = a[base + j], v1 = a[base + m - 1 - j];
        b[base + j] = m_mul(m_add(v0, v1), INV2);
        b[base + m / 2 + j] = m_mul(m_sub(v0, v1), t[j]);
      }
    }
    a.swap(b);
    n_blocks *= 2;
    m /= 2;
    stage++;
  }
}

static void fft_inplace(std::vector<uint32_t>& a,
                        const std::vector<std::vector<uint32_t>>& tw) {
  size_t n = a.size();
  if (n <= 1) return;
  int log_n = 0;
  while (((size_t)1 << log_n) < n) log_n++;
  std::vector<uint32_t> b(n);
  size_t m = 2, n_blocks = n / 2;
  int stage = log_n - 1;
  while (m <= n / 2) {
    const auto& t = tw[stage];
    for (size_t blk = 0; blk < n_blocks; blk++) {
      size_t base = blk * m;
      for (size_t j = 0; j < m / 2; j++) {
        uint32_t e = a[base + j], o = a[base + m / 2 + j];
        uint32_t to = m_mul(t[j], o);
        b[base + j] = m_add(e, to);
        b[base + m - 1 - j] = m_sub(e, to);
      }
    }
    a.swap(b);
    m *= 2;
    n_blocks /= 2;
    stage--;
  }
  // Circle stage.
  const auto& t = tw[0];
  for (size_t j = 0; j < n / 2; j++) {
    uint32_t e = a[j], o = a[n / 2 + j];
    uint32_t to = m_mul(t[j], o);
    b[j] = m_add(e, to);
    b[n - 1 - j] = m_sub(e, to);
  }
  a.swap(b);
}

// LDE: trace values (2^log) -> commit-domain values (2^(log+blowup)).
static std::vector<uint32_t> lde_column(
    const std::vector<uint32_t>& values, int log_blowup,
    std::map<int, std::vector<std::vector<uint32_t>>>& tw_cache,
    std::map<int, std::vector<std::vector<uint32_t>>>& twi_cache) {
  size_t n = values.size();
  int log_n = 0;
  while (((size_t)1 << log_n) < n) log_n++;
  if (!twi_cache.count(log_n)) twi_cache[log_n] = ifft_twiddles(log_n);
  std::vector<uint32_t> coeffs = values;
  ifft_inplace(coeffs, twi_cache[log_n]);
  int big_log = log_n + log_blowup;
  size_t stride = (size_t)1 << log_blowup;
  std::vector<uint32_t> ext((size_t)1 << big_log, 0);
  for (size_t i = 0; i < n; i++) ext[i * stride] = coeffs[i];
  if (!tw_cache.count(big_log)) tw_cache[big_log] = fft_twiddles(big_log);
  fft_inplace(ext, tw_cache[big_log]);
  return ext;
}

// ===========================================================================
// Merkle commitments (mirrors crypto/merkle.py)
// ===========================================================================

// Per-layer recomputed-node positions.
static std::map<int, std::vector<int64_t>> computed_positions(
    int bottom_log, const std::map<int, std::vector<int64_t>>& queries) {
  std::map<int, std::vector<int64_t>> out;
  std::set<int64_t> s;
  auto it = queries.find(bottom_log);
  if (it != queries.end()) s.insert(it->second.begin(), it->second.end());
  out[bottom_log] = std::vector<int64_t>(s.begin(), s.end());
  for (int log = bottom_log - 1; log >= 0; log--) {
    std::set<int64_t> nxt;
    for (int64_t p : s) nxt.insert(p >> 1);
    auto qi = queries.find(log);
    if (qi != queries.end()) nxt.insert(qi->second.begin(), qi->second.end());
    s = nxt;
    out[log] = std::vector<int64_t>(s.begin(), s.end());
  }
  return out;
}

// Full tree build (used to recommit the preprocessed tree).
// cols_by_log: insertion-ordered columns per log.
static Digest merkle_root(const std::map<int, std::vector<const std::vector<uint32_t>*>>& cols_by_log) {
  int max_log = cols_by_log.rbegin()->first;
  std::vector<Digest> prev;
  for (int log = max_log; log >= 0; log--) {
    size_t n = (size_t)1 << log;
    auto ci = cols_by_log.find(log);
    size_t n_cols = (ci != cols_by_log.end()) ? ci->second.size() : 0;
    size_t words_per = (prev.empty() ? 0 : 16) + n_cols;
    std::vector<Digest> layer(n);
    std::vector<uint32_t> msg(words_per);
    for (size_t i = 0; i < n; i++) {
      size_t w = 0;
      if (!prev.empty()) {
        memcpy(&msg[0], prev[2 * i].w, 32);
        memcpy(&msg[8], prev[2 * i + 1].w, 32);
        w = 16;
      }
      if (n_cols)
        for (size_t c = 0; c < n_cols; c++) msg[w + c] = (*ci->second[c])[i];
      layer[i] = hash_words(msg.data(), words_per);
    }
    prev.swap(layer);
  }
  return prev[0];
}

// Partial recompute from openings (mirrors merkle.verify_decommitment).
static bool verify_decommitment(
    const Digest& root, const std::vector<int>& column_logs,
    const std::map<int, std::vector<int64_t>>& queries,
    const std::vector<std::vector<uint32_t>>& queried_values,
    const std::vector<Digest>& witness) {
  std::map<int, int> cols_count;
  for (int log : column_logs) cols_count[log]++;
  int bottom = cols_count.rbegin()->first;
  auto comp = computed_positions(bottom, queries);

  // Consume values: logs descending, column insertion order within log.
  std::map<int, std::vector<const std::vector<uint32_t>*>> values_by_log;
  size_t vi = 0;
  for (auto it = cols_count.rbegin(); it != cols_count.rend(); ++it) {
    for (int k = 0; k < it->second; k++) {
      if (vi >= queried_values.size()) return false;
      values_by_log[it->first].push_back(&queried_values[vi++]);
    }
  }
  if (vi != queried_values.size()) return false;
  for (auto& kv : values_by_log)
    for (auto* v : kv.second)
      if (v->size() != comp[kv.first].size()) return false;

  size_t wi = 0;
  std::map<int64_t, Digest> node_hashes;
  const auto& sbot = comp[bottom];
  if (!sbot.empty()) {
    auto vb = values_by_log.find(bottom);
    if (vb == values_by_log.end() || vb->second.empty()) return false;
    size_t n_cols = vb->second.size();
    std::vector<uint32_t> msg(n_cols);
    for (size_t i = 0; i < sbot.size(); i++) {
      for (size_t c = 0; c < n_cols; c++) msg[c] = (*vb->second[c])[i];
      node_hashes[sbot[i]] = hash_words(msg.data(), n_cols);
    }
  }
  std::vector<int64_t> s = sbot;
  for (int log = bottom; log >= 1; log--) {
    std::set<int64_t> known(s.begin(), s.end());
    const auto& nxt = comp[log - 1];
    auto vn = values_by_log.find(log - 1);
    size_t n_new = (vn != values_by_log.end()) ? vn->second.size() : 0;
    std::map<int64_t, Digest> parent_hashes;
    std::vector<uint32_t> msg(16 + n_new);
    for (size_t idx = 0; idx < nxt.size(); idx++) {
      int64_t par = nxt[idx];
      for (int ci = 0; ci < 2; ci++) {
        int64_t child = 2 * par + ci;
        if (known.count(child)) {
          memcpy(&msg[ci * 8], node_hashes[child].w, 32);
        } else {
          if (wi >= witness.size()) return false;
          memcpy(&msg[ci * 8], witness[wi++].w, 32);
        }
      }
      for (size_t c = 0; c < n_new; c++) msg[16 + c] = (*vn->second[c])[idx];
      parent_hashes[par] = hash_words(msg.data(), 16 + n_new);
    }
    node_hashes.swap(parent_hashes);
    s = nxt;
  }
  if (node_hashes.size() != 1 || node_hashes.begin()->first != 0) return false;
  if (wi != witness.size()) return false;  // trailing witness data
  return node_hashes[0] == root;
}

// ===========================================================================
// Wire format parsing (mirrors serde.py proof/settings_to_flat_bytes)
// ===========================================================================

struct Reader {
  const uint8_t* p;
  size_t len, off;
  bool ok;
  Reader(const uint8_t* data, size_t n) : p(data), len(n), off(0), ok(true) {}
  bool need(size_t n) {
    if (!ok || off + n > len) { ok = false; return false; }
    return true;
  }
  uint8_t u8() { if (!need(1)) return 0; return p[off++]; }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v; memcpy(&v, p + off, 4); off += 4; return v;
  }
  uint64_t u64() {
    if (!need(8)) return 0;
    uint64_t v; memcpy(&v, p + off, 8); off += 8; return v;
  }
  int64_t i64() { return (int64_t)u64(); }
  QM31 qm31() {
    QM31 f;
    for (int i = 0; i < 4; i++) f.c[i] = u32();
    return f;
  }
  Digest digest() {
    Digest d;
    for (int i = 0; i < 8; i++) d.w[i] = u32();
    return d;
  }
  std::vector<uint32_t> u32s() {
    uint32_t n = u32();
    if (!need((size_t)n * 4)) return {};
    std::vector<uint32_t> v(n);
    memcpy(v.data(), p + off, (size_t)n * 4);
    off += (size_t)n * 4;
    return v;
  }
  bool magic(const char* m) {
    if (!need(4)) return false;
    bool good = memcmp(p + off, m, 4) == 0;
    off += 4;
    ok = ok && good;
    return good;
  }
};

struct RangeI { int64_t lo, hi; };
struct LutLayout {
  bool present = false;
  int log_size = 0;
  std::vector<RangeI> ranges;
  // Settings v2: the NORMATIVE output table (raw fixed f(x) per enumerated
  // input, serde.py settings_to_flat_bytes).  Empty for v1 settings, where
  // the column is recomputed from libm (legacy, implementation-defined).
  std::vector<int64_t> outputs;
};
struct Settings {
  LutLayout sin, exp2, log2;
  bool rc_present = false;
  int rc_bits = 0;
};

struct FriProofData {
  std::vector<Digest> layer_roots;
  std::vector<std::vector<std::vector<uint32_t>>> layer_queried_values;
  std::vector<std::vector<Digest>> layer_witnesses;
  std::vector<QM31> last_layer_coeffs;
};

struct Proof {
  // config
  int pow_bits = 0, log_blowup = 1, log_last_layer = 0, n_queries = 0;
  int folds_per_layer = 1;
  // claim: (component index, log size)
  std::vector<std::pair<int, int>> claim;
  std::vector<QM31> sums;  // same order as claim
  std::vector<Digest> roots;
  std::vector<std::vector<std::vector<QM31>>> sampled_values;  // [tree][col][pt]
  uint64_t pow_nonce = 0;
  std::vector<std::vector<std::vector<uint32_t>>> tree_queried_values;
  std::vector<std::vector<Digest>> tree_witnesses;
  FriProofData fri;
};

static bool parse_settings(Reader& r, Settings& s) {
  if (!r.magic("LMSF")) return false;
  uint32_t version = r.u32();
  if (version != 1 && version != 2) return false;
  LutLayout* luts[3] = {&s.sin, &s.exp2, &s.log2};
  for (int k = 0; k < 3; k++) {
    if (r.u8()) {
      luts[k]->present = true;
      luts[k]->log_size = (int)r.u32();
      uint32_t nr = r.u32();
      if (nr > 1u << 20) return false;
      uint64_t n_values = 0;
      for (uint32_t i = 0; i < nr; i++) {
        RangeI rg;
        rg.lo = r.i64();
        rg.hi = r.i64();
        if (rg.hi < rg.lo) return false;
        n_values += (uint64_t)(rg.hi - rg.lo) + 1;
        luts[k]->ranges.push_back(rg);
      }
      if (version >= 2) {
        uint32_t no = r.u32();
        // The table must cover the enumeration exactly.
        if ((uint64_t)no != n_values || no > 1u << 26) return false;
        luts[k]->outputs.resize(no);
        for (uint32_t i = 0; i < no; i++) luts[k]->outputs[i] = r.i64();
      }
    }
  }
  if (r.u8()) {
    s.rc_present = true;
    s.rc_bits = (int)r.u32();
  }
  return r.ok;
}

static const uint32_t LIMIT = 1u << 26;  // structural sanity bound

static bool parse_proof(Reader& r, Proof& pf) {
  if (!r.magic("LMVF")) return false;
  uint32_t version = r.u32();
  if (version != 1 && version != 2) return false;
  pf.pow_bits = (int)r.u32();
  pf.log_blowup = (int)r.u32();
  pf.log_last_layer = (int)r.u32();
  // Bound before any `1 << log_last_layer`: values >= 64 are UB on size_t
  // shifts and huge values distort last_line_log arithmetic downstream.
  if (pf.log_last_layer > 30) return false;
  pf.n_queries = (int)r.u32();
  // v2: line-fold steps per committed FRI layer (v1 proofs fold once).
  pf.folds_per_layer = version >= 2 ? (int)r.u32() : 1;
  if (pf.folds_per_layer < 1 || pf.folds_per_layer > 8) return false;
  uint32_t n_claim = r.u32();
  if (n_claim > 32) return false;
  for (uint32_t i = 0; i < n_claim; i++) {
    int idx = (int)r.u32();
    int log = (int)r.u32();
    pf.claim.push_back({idx, log});
  }
  for (uint32_t i = 0; i < n_claim; i++) pf.sums.push_back(r.qm31());
  uint32_t n_roots = r.u32();
  if (n_roots > 8) return false;
  for (uint32_t i = 0; i < n_roots; i++) pf.roots.push_back(r.digest());
  uint32_t n_trees = r.u32();
  if (n_trees > 8) return false;
  for (uint32_t t = 0; t < n_trees; t++) {
    uint32_t n_cols = r.u32();
    if (n_cols > LIMIT) return false;
    std::vector<std::vector<QM31>> tree;
    for (uint32_t c = 0; c < n_cols; c++) {
      uint32_t n_pts = r.u32();
      if (n_pts > 16) return false;
      std::vector<QM31> col;
      for (uint32_t k = 0; k < n_pts; k++) col.push_back(r.qm31());
      tree.push_back(col);
    }
    pf.sampled_values.push_back(tree);
  }
  pf.pow_nonce = r.u64();
  uint32_t nt = r.u32();
  if (nt > 8) return false;
  for (uint32_t t = 0; t < nt; t++) {
    uint32_t n_arr = r.u32();
    if (n_arr > LIMIT) return false;
    std::vector<std::vector<uint32_t>> arrays;
    for (uint32_t a = 0; a < n_arr; a++) arrays.push_back(r.u32s());
    pf.tree_queried_values.push_back(arrays);
  }
  nt = r.u32();
  if (nt > 8) return false;
  for (uint32_t t = 0; t < nt; t++) {
    uint32_t n_dig = r.u32();
    if (n_dig > LIMIT) return false;
    std::vector<Digest> digs;
    for (uint32_t d = 0; d < n_dig; d++) digs.push_back(r.digest());
    pf.tree_witnesses.push_back(digs);
  }
  uint32_t n_layers = r.u32();
  if (n_layers > 64) return false;
  for (uint32_t i = 0; i < n_layers; i++) pf.fri.layer_roots.push_back(r.digest());
  uint32_t nl = r.u32();
  if (nl > 64) return false;
  for (uint32_t i = 0; i < nl; i++) {
    uint32_t n_arr = r.u32();
    if (n_arr > 16) return false;
    std::vector<std::vector<uint32_t>> arrays;
    for (uint32_t a = 0; a < n_arr; a++) arrays.push_back(r.u32s());
    pf.fri.layer_queried_values.push_back(arrays);
  }
  nl = r.u32();
  if (nl > 64) return false;
  for (uint32_t i = 0; i < nl; i++) {
    uint32_t n_dig = r.u32();
    if (n_dig > LIMIT) return false;
    std::vector<Digest> digs;
    for (uint32_t d = 0; d < n_dig; d++) digs.push_back(r.digest());
    pf.fri.layer_witnesses.push_back(digs);
  }
  uint32_t n_coeffs = r.u32();
  if (n_coeffs > LIMIT) return false;
  for (uint32_t i = 0; i < n_coeffs; i++) pf.fri.last_layer_coeffs.push_back(r.qm31());
  return r.ok;
}

}  // namespace luminair

#include "air.inc"      // components + layout + preprocessed columns
#include "verify.inc"   // verification pipeline + C ABI
