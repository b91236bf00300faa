// The benchmark's frozen Kronecker (Graph500 RMAT) edge stream: a copy of
// the port's native generator (tpu_bfs_torch/native/rmat.cpp), the stream
// the flagship graph is drawn from, kept here so that a change to the
// program cannot change the benchmark's graphs. bfsbench/graphs/kronecker.py
// builds it with g++ into the benchmark's cache directory and applies the
// Graph500 vertex permutation.
//
// Determinism: edge index space is split into fixed 64K-edge blocks; each
// block's RNG is seeded by splitmix64(seed, block), so the output depends
// only on (scale, m, seed, a, b, c), never on the thread count.
//
// Exported C ABI:
//   bfsbench_rmat_edges(scale, m, seed, a, b, c, out_u, out_v) -> 0 on success

#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kBlock = 1 << 16;

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct Xoshiro256pp {
  uint64_t s[4];

  explicit Xoshiro256pp(uint64_t seed) {
    for (int i = 0; i < 4; ++i) {
      seed = splitmix64(seed);
      s[i] = seed;
    }
  }

  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }

  inline uint64_t next() {
    uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  // Uniform double in [0, 1) with 53 bits.
  inline double uniform() { return (next() >> 11) * 0x1.0p-53; }
};

}  // namespace

extern "C" {

int64_t bfsbench_rmat_edges(int64_t scale, int64_t m, int64_t seed,
                                double a, double b, double c, int64_t* out_u,
                                int64_t* out_v) {
  if (scale < 1 || scale > 40 || m < 0) return 2;
  // Quadrant probabilities must leave room for d = 1-a-b-c > 0; a+b >= 1
  // would divide by zero (or flip sign) in c_norm below and emit silently
  // wrong edges with rc=0. Phrased positively so NaNs fail too.
  if (!(a > 0.0 && b >= 0.0 && c >= 0.0 && a + b + c < 1.0)) return 3;
  const double ab = a + b;
  const double a_norm = a / ab;
  const double c_norm = c / (1.0 - ab);

  const int64_t nblocks = (m + kBlock - 1) / kBlock;
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = hw ? static_cast<int>(hw) : 4;
  if (nthreads > nblocks) nthreads = static_cast<int>(nblocks ? nblocks : 1);

  auto work = [&](int t) {
    for (int64_t blk = t; blk < nblocks; blk += nthreads) {
      Xoshiro256pp rng(splitmix64(static_cast<uint64_t>(seed) * 0x100000001b3ULL +
                                  static_cast<uint64_t>(blk)));
      const int64_t lo = blk * kBlock;
      const int64_t hi = lo + kBlock < m ? lo + kBlock : m;
      for (int64_t e = lo; e < hi; ++e) {
        int64_t u = 0, v = 0;
        for (int64_t lvl = 0; lvl < scale; ++lvl) {
          const double ru = rng.uniform();
          const double rv = rng.uniform();
          const bool u_bit = ru > ab;
          const bool v_bit = rv > (u_bit ? c_norm : a_norm);
          u = (u << 1) | (u_bit ? 1 : 0);
          v = (v << 1) | (v_bit ? 1 : 0);
        }
        out_u[e] = u;
        out_v[e] = v;
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
