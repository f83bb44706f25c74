// Phase/variant micro-benchmark for the native encoder (scratch; not shipped).
//
// History (round 3): single-symbol packers — the old pack_span accumulator,
// a 4-way interleaved OR-deposit, branchless rolling stores — all measured
// 0.35-0.65 GB/s on this 2.1 GHz host: the loop is ISSUE-bound (~10 uops
// per symbol), so interleaving independent chains moved nothing. Halving
// the op count with a 64K PAIR table (two symbols per lookup) measured
// ~1.18 GB/s single-core; that variant is now the production packer in
// mht_codec.cpp (pack_chunk_or). This harness times the shipped encoder.
#include "../metalhuffman/native/src/mht_codec.cpp"
#include <chrono>
#include <cstdio>
#include <random>

int main() {
  const int64_t n = 94371840 / 3;  // ~31 MB
  std::vector<uint8_t> data(n);
  std::mt19937 rng(7);
  std::normal_distribution<float> nd(0.f, 12.f);  // photo-like deltas
  for (int64_t i = 0; i < n; ++i) data[i] = (uint8_t)(int)nd(rng);
  std::vector<uint8_t> widths(256), code(2 * n + 16);
  std::vector<uint32_t> offs(n / 64);
  int64_t code_len, total_bits;
  for (int nt : {1, 2, 4, 8}) {
    double best = 1e9;
    for (int r = 0; r < 5; ++r) {
      auto t0 = std::chrono::steady_clock::now();
      mht_encode_mt(data.data(), n, 64, widths.data(), code.data(),
                    (int64_t)code.size(), &code_len, offs.data(),
                    &total_bits, nt);
      auto t1 = std::chrono::steady_clock::now();
      best = std::min(best, std::chrono::duration<double>(t1 - t0).count());
    }
    printf("mht_encode_mt nt=%d: %.3f GB/s (best of 5)\n", nt, n / best / 1e9);
  }
  // single-thread full encode (hist + tree + pack, no threading overhead)
  double best = 1e9;
  for (int r = 0; r < 5; ++r) {
    auto t0 = std::chrono::steady_clock::now();
    mht_encode(data.data(), n, 64, widths.data(), code.data(),
               (int64_t)code.size(), &code_len, offs.data(), &total_bits);
    auto t1 = std::chrono::steady_clock::now();
    best = std::min(best, std::chrono::duration<double>(t1 - t0).count());
  }
  printf("mht_encode 1t: %.3f GB/s (best of 5)\n", n / best / 1e9);
  return 0;
}
