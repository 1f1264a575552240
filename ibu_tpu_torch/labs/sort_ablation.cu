// Ablation and variants of the sort lab's rank and store kernels, timed on
// the card without torch: the TPU-shaped first designs (one block per tile,
// __match_any_sync over 64 runs with a 64 x 256 u16 table and a 64-step
// scan; 2048 ordered stores per thread into a shared tile) with parts
// removed, the shipped kernels of csrc/sort_lab.cu through their C entry
// points, the shipped bodies at other block shapes, and a plain copy of the
// same 8 bytes per key. Every exact variant is checked against host
// references (lab keys, one-digit keys; in-range and out-of-range offsets)
// before anything is timed; then CUDA events over 30 calls per run, 3 key
// sets cycled, variants interleaved over rounds. Build and run on the card
// from the repository root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -I ibu_tpu_torch/csrc -o build/sort_ablation ibu_tpu_torch/labs/sort_ablation.cu
//   ./build/sort_ablation [keys, default 2^24] [rounds, default 7]
//
// It includes csrc/sort_lab.cu, so it always times the package's kernels.
#include "sort_lab.cu"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <vector>
#include <algorithm>
#include <type_traits>

#define CK(x) do { cudaError_t e_ = (x); if (e_ != cudaSuccess) { \
  std::printf("CUDA error %s at %s:%d\n", cudaGetErrorString(e_), __FILE__, __LINE__); std::exit(1);} } while (0)

namespace first {
constexpr int kWarps = 8;
constexpr int kRuns = kTile / 32;
// mode 0 full, 1 no scan, 2 no zeroing, 3 peers by 8 ballots, 4 no peers
template <int kMode>
__global__ void __launch_bounds__(kDigits)
rank_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ rank) {
  __shared__ uint16_t counts[kRuns][kDigits];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t* words = reinterpret_cast<uint32_t*>(&counts[0][0]);
  if (kMode != 2) {
    for (int i = tid; i < kRuns * kDigits / 2; i += kDigits) words[i] = 0;
  }
  __syncthreads();
  const int64_t base = int64_t(blockIdx.x) * kTile;
  const unsigned below = (1u << lane) - 1u;
  int digit[kRuns / kWarps];
  int local[kRuns / kWarps];
#pragma unroll
  for (int k = 0; k < kRuns / kWarps; ++k) {
    const int run = warp + k * kWarps;
    const int d = keys[base + run * 32 + lane] & 0xFF;
    unsigned peers;
    if (kMode == 3) peers = digit_peers(d);
    else if (kMode == 4) peers = 1u << lane;
    else peers = __match_any_sync(0xFFFFFFFFu, d);
    digit[k] = d;
    local[k] = __popc(peers & below);
    if (local[k] == 0) counts[run][d] = uint16_t(__popc(peers));
  }
  __syncthreads();
  if (kMode != 1) {
    unsigned sum = 0;
    for (int run = 0; run < kRuns; ++run) {
      const unsigned c = counts[run][tid];
      counts[run][tid] = uint16_t(sum);
      sum += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRuns / kWarps; ++k) {
    const int run = warp + k * kWarps;
    rank[base + run * 32 + lane] = int(counts[run][digit[k]]) + local[k];
  }
}

__global__ void __launch_bounds__(kLanes)
store_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ offs,
             int32_t* __restrict__ out) {
  __shared__ int32_t block[kRows][kLanes];
  __shared__ int32_t off[kDigits];
  const int j = threadIdx.x;
  const int64_t base = int64_t(blockIdx.x) * kTile;
  const int32_t* tile_offs = offs + int64_t(blockIdx.x) * kOffRows * kLanes;
  off[j] = tile_offs[j];
  off[kLanes + j] = tile_offs[kLanes + j];
  int32_t col[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    col[r] = keys[base + r * kLanes + j];
    block[r][j] = 0;
  }
  __syncthreads();
  for (int c = 0; c < kDigits; c += 2) {
    const int lo = off[c];
    const int hi = off[c + 1];
    if (unsigned(lo) <= 8u) {
#pragma unroll
      for (int k = 0; k < 8; ++k) block[lo + k][j] = col[k];
    }
    if (unsigned(hi) <= 8u) {
#pragma unroll
      for (int k = 0; k < 8; ++k) block[hi + k][j] = col[8 + k];
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[base + r * kLanes + j] = block[r][j];
}
}  // namespace first

// the package rank body with warps per tile W, peers by ballot or match, and a minimum of blocks per SM
template <int W, bool kBallot, int kMinBlocks>
__global__ void __launch_bounds__(W * 32, kMinBlocks)
rank_var(const int32_t* __restrict__ keys, int32_t* __restrict__ rank) {
  constexpr int R = kTile / 32 / W;
  __shared__ unsigned counts[W][kDigits];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = int64_t(blockIdx.x) * kTile + warp * (R * 32) + lane;
  int digit[R];
#pragma unroll
  for (int k = 0; k < R; ++k) digit[k] = keys[base + k * 32] & 0xFF;
#pragma unroll
  for (int c = lane; c < kDigits; c += 32) counts[warp][c] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  unsigned local[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int d = digit[k];
    const unsigned peers = kBallot ? digit_peers(d) : __match_any_sync(0xFFFFFFFFu, d);
    const unsigned before = __popc(peers & below);
    const unsigned prior = counts[warp][d];
    local[k] = prior + before;
    __syncwarp();
    if (before == 0) counts[warp][d] = prior + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kDigits; c += W * 32) {
    unsigned sum = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const unsigned n = counts[w][c];
      counts[w][c] = sum;
      sum += n;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < R; ++k) rank[base + k * 32] = int(counts[warp][digit[k]] + local[k]);
}

// the package store body with T tiles per block
template <int T>
__global__ void __launch_bounds__(T * 32)
store_var(const int4* __restrict__ keys, const int4* __restrict__ offs, int4* __restrict__ out,
          int64_t tiles) {
  constexpr int kVecs = kLanes / 4;
  const int lane = threadIdx.x & 31;
  const int64_t tile = int64_t(blockIdx.x) * T + (threadIdx.x >> 5);
  if (tile >= tiles) return;
  const int4* own = offs + tile * (kOffRows * kVecs) + 2 * lane;
  const int4 lo = own[0], hi = own[1];
  const int start[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  int last[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) last[r] = -1;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = 8 * lane + k;
    const int s = start[k];
    if (unsigned(s) <= unsigned(kRows - 8)) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= s && r < s + 8) last[r] = (c << 4) | (8 * (k & 1) + r - s);
      }
    }
  }
  const int4* src = keys + tile * (kRows * kVecs) + lane;
  int4* dst = out + tile * (kRows * kVecs) + lane;
  int4 row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int winner = __reduce_max_sync(0xFFFFFFFFu, last[r]);
    row[r] = winner < 0 ? make_int4(0, 0, 0, 0) : src[(winner & 15) * kVecs];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) dst[r * kVecs] = row[r];
}

__global__ void copy_kernel(const int4* __restrict__ in, int4* __restrict__ out, int64_t n4) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n4) out[i] = in[i];
}

using Launch = std::function<void(const int32_t*, const int32_t*, int32_t*)>;

template <int T>
Launch store_launch(int64_t tiles) {
  return [=](const int32_t* k, const int32_t* o, int32_t* out) {
    store_var<T><<<unsigned((tiles + T - 1) / T), T * 32>>>(
        reinterpret_cast<const int4*>(k), reinterpret_cast<const int4*>(o),
        reinterpret_cast<int4*>(out), tiles);
  };
}

static uint32_t lab_key(uint64_t i, uint32_t seed) {
  return uint32_t(((i * 2654435761ull) ^ (i >> 3) ^ seed) & 0xFFFFFFFFull);
}

static uint32_t mix(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU; x ^= x >> 16;
  return x;
}

static void ref_rank(const std::vector<int32_t>& keys, std::vector<int32_t>& rank) {
  const int64_t tiles = int64_t(keys.size()) / kTile;
  for (int64_t t = 0; t < tiles; ++t) {
    int cnt[256] = {0};
    for (int i = 0; i < kTile; ++i) {
      const int d = keys[t * kTile + i] & 0xFF;
      rank[t * kTile + i] = cnt[d]++;
    }
  }
}

static void ref_store(const std::vector<int32_t>& keys, const std::vector<int32_t>& offs,
                      std::vector<int32_t>& out) {
  const int64_t tiles = int64_t(keys.size()) / kTile;
  for (int64_t t = 0; t < tiles; ++t) {
    int32_t* blk = &out[t * kTile];
    std::memset(blk, 0, kTile * 4);
    for (int c = 0; c < 256; ++c) {
      const int s = offs[t * kOffRows * kLanes + c];
      if (s < 0 || s > 8) continue;
      const int g = c % 2;
      std::memcpy(blk + s * kLanes, &keys[t * kTile + 8 * g * kLanes], 8 * kLanes * 4);
    }
  }
}

int main(int argc, char** argv) {
  const int64_t n = argc > 1 ? std::atoll(argv[1]) : (int64_t(1) << 24);
  const int rounds = argc > 2 ? std::atoi(argv[2]) : 7;
  const int iters = 30;
  const int64_t tiles = n / kTile;
  std::printf("n=%lld tiles=%lld rounds=%d iters=%d\n", (long long)n, (long long)tiles, rounds, iters);
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  std::printf("device %s, %d SMs\n", prop.name, prop.multiProcessorCount);

  // inputs: 3 timed key sets, a check set, one-digit keys; lab-like offsets and edge offsets
  std::vector<std::vector<int32_t>> hkeys(5, std::vector<int32_t>(n));
  for (int s = 0; s < 3; ++s)
    for (int64_t i = 0; i < n; ++i) hkeys[s][i] = int32_t(lab_key(i, 100 + s));
  for (int64_t i = 0; i < n; ++i) hkeys[3][i] = int32_t(lab_key(i, 0));
  for (int64_t i = 0; i < n; ++i) hkeys[4][i] = int32_t((lab_key(i, 7) & 0xFFFFFF00u) | 0x5Au);
  std::vector<int32_t> hoffs(tiles * kOffRows * kLanes, 0), hedge(tiles * kOffRows * kLanes, 0);
  for (int64_t t = 0; t < tiles; ++t)
    for (int c = 0; c < 256; ++c) {
      const int s = int(mix(uint32_t(t * 256 + c) * 2u + 1u) % 9u);
      hoffs[t * 1024 + c] = s;
      hedge[t * 1024 + c] = c % 3 == 0 ? -1 : (c % 5 == 1 ? 9 : s);
    }
  std::vector<int32_t*> dkeys(5);
  for (int s = 0; s < 5; ++s) {
    CK(cudaMalloc(&dkeys[s], n * 4));
    CK(cudaMemcpy(dkeys[s], hkeys[s].data(), n * 4, cudaMemcpyHostToDevice));
  }
  int32_t *doffs, *dedge, *dout;
  CK(cudaMalloc(&doffs, hoffs.size() * 4));
  CK(cudaMalloc(&dedge, hedge.size() * 4));
  CK(cudaMalloc(&dout, n * 4));
  CK(cudaMemcpy(doffs, hoffs.data(), hoffs.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(dedge, hedge.data(), hedge.size() * 4, cudaMemcpyHostToDevice));

  struct V { std::string name; bool rank; int check; Launch fn; };  // check: 1 exact, 0 timing only
  std::vector<V> vs;
  vs.push_back({"copy 8 B/key", false, 0, [=](const int32_t* k, const int32_t*, int32_t* o) {
    copy_kernel<<<unsigned((n / 4 + 255) / 256), 256>>>(reinterpret_cast<const int4*>(k),
                                                      reinterpret_cast<int4*>(o), n / 4); }});
  vs.push_back({"K2 first full", true, 1, [=](const int32_t* k, const int32_t*, int32_t* o) {
    first::rank_kernel<0><<<unsigned(tiles), kDigits>>>(k, o); }});
  vs.push_back({"K2 first no scan", true, 0, [=](const int32_t* k, const int32_t*, int32_t* o) {
    first::rank_kernel<1><<<unsigned(tiles), kDigits>>>(k, o); }});
  vs.push_back({"K2 first no zeroing", true, 0, [=](const int32_t* k, const int32_t*, int32_t* o) {
    first::rank_kernel<2><<<unsigned(tiles), kDigits>>>(k, o); }});
  vs.push_back({"K2 first ballot peers", true, 1, [=](const int32_t* k, const int32_t*, int32_t* o) {
    first::rank_kernel<3><<<unsigned(tiles), kDigits>>>(k, o); }});
  vs.push_back({"K2 first no peers", true, 0, [=](const int32_t* k, const int32_t*, int32_t* o) {
    first::rank_kernel<4><<<unsigned(tiles), kDigits>>>(k, o); }});
  vs.push_back({"K2 w4 match", true, 1, [=](const int32_t* k, const int32_t*, int32_t* o) {
    rank_var<4, false, 1><<<unsigned(tiles), 128>>>(k, o); }});
  vs.push_back({"K2 w8 match", true, 1, [=](const int32_t* k, const int32_t*, int32_t* o) {
    rank_var<8, false, 1><<<unsigned(tiles), 256>>>(k, o); }});
  vs.push_back({"K2 w16 match", true, 1, [=](const int32_t* k, const int32_t*, int32_t* o) {
    rank_var<16, false, 1><<<unsigned(tiles), 512>>>(k, o); }});
  vs.push_back({"K2 w4 ballot", true, 1, [=](const int32_t* k, const int32_t*, int32_t* o) {
    rank_var<4, true, 1><<<unsigned(tiles), 128>>>(k, o); }});
  vs.push_back({"K2 w8 ballot", true, 1, [=](const int32_t* k, const int32_t*, int32_t* o) {
    rank_var<8, true, 1><<<unsigned(tiles), 256>>>(k, o); }});
  vs.push_back({"K2 w16 ballot", true, 1, [=](const int32_t* k, const int32_t*, int32_t* o) {
    rank_var<16, true, 1><<<unsigned(tiles), 512>>>(k, o); }});
  vs.push_back({"K2 w4 ballot min12", true, 1, [=](const int32_t* k, const int32_t*, int32_t* o) {
    rank_var<4, true, 12><<<unsigned(tiles), 128>>>(k, o); }});
  vs.push_back({"K2 w4 ballot min16", true, 1, [=](const int32_t* k, const int32_t*, int32_t* o) {
    rank_var<4, true, 16><<<unsigned(tiles), 128>>>(k, o); }});
  vs.push_back({"K2 package entry", true, 1, [=](const int32_t* k, const int32_t*, int32_t* o) {
    ibu_lab_rank_cumsum(k, o, tiles, nullptr); }});
  vs.push_back({"K3 first", false, 1, [=](const int32_t* k, const int32_t* f, int32_t* o) {
    first::store_kernel<<<unsigned(tiles), kLanes>>>(k, f, o); }});
  vs.push_back({"K3 t1", false, 1, store_launch<1>(tiles)});
  vs.push_back({"K3 t2", false, 1, store_launch<2>(tiles)});
  vs.push_back({"K3 t8", false, 1, store_launch<8>(tiles)});
  vs.push_back({"K3 package entry", false, 1, [=](const int32_t* k, const int32_t* f, int32_t* o) {
    ibu_lab_dynamic_store(k, f, o, tiles, nullptr); }});
  CK(cudaDeviceSynchronize());
  CK(cudaGetLastError());

  // exact checks
  std::vector<int32_t> want(n), got(n);
  bool all_ok = true;
  for (int ks : {3, 4}) {
    ref_rank(hkeys[ks], want);
    for (auto& v : vs) {
      if (!v.rank || !v.check) continue;
      CK(cudaMemset(dout, 0xFF, n * 4));
      v.fn(dkeys[ks], doffs, dout);
      CK(cudaGetLastError());
      CK(cudaDeviceSynchronize());
      CK(cudaMemcpy(got.data(), dout, n * 4, cudaMemcpyDeviceToHost));
      const bool ok = got == want;
      all_ok &= ok;
      std::printf("check %-22s keys %d: %s\n", v.name.c_str(), ks, ok ? "exact" : "WRONG");
    }
  }
  for (int which = 0; which < 2; ++which) {
    const std::vector<int32_t>& ho = which ? hedge : hoffs;
    int32_t* dof = which ? dedge : doffs;
    ref_store(hkeys[3], ho, want);
    for (auto& v : vs) {
      if (v.rank || !v.check) continue;
      CK(cudaMemset(dout, 0xFF, n * 4));
      v.fn(dkeys[3], dof, dout);
      CK(cudaGetLastError());
      CK(cudaDeviceSynchronize());
      CK(cudaMemcpy(got.data(), dout, n * 4, cudaMemcpyDeviceToHost));
      const bool ok = got == want;
      all_ok &= ok;
      std::printf("check %-22s offsets %s: %s\n", v.name.c_str(), which ? "edge" : "lab", ok ? "exact" : "WRONG");
    }
  }
  // rows the lab-like offsets select, per tile
  double selected = 0;
  for (int64_t t = 0; t < tiles; ++t) {
    int src[16];
    for (int r = 0; r < 16; ++r) src[r] = -1;
    for (int c = 0; c < 256; ++c) {
      const int s = hoffs[t * 1024 + c];
      for (int r = s; r < s + 8; ++r) src[r] = 8 * (c % 2) + r - s;
    }
    bool seen[16] = {false};
    for (int r = 0; r < 16; ++r) if (src[r] >= 0) seen[src[r]] = true;
    for (int r = 0; r < 16; ++r) selected += seen[r];
  }
  std::printf("distinct key rows selected per tile (these offsets): %.4f of 16\n", selected / tiles);

  // timing, interleaved
  std::vector<std::vector<float>> ms(vs.size());
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  for (int round = -1; round < rounds; ++round) {
    for (size_t j = 0; j < vs.size(); ++j) {
      CK(cudaEventRecord(a));
      for (int i = 0; i < iters; ++i) vs[j].fn(dkeys[i % 3], doffs, dout);
      CK(cudaEventRecord(b));
      CK(cudaEventSynchronize(b));
      float t;
      CK(cudaEventElapsedTime(&t, a, b));
      if (round >= 0) ms[j].push_back(t / iters);
    }
  }
  CK(cudaGetLastError());
  const double gbps = 3350.0;
  std::printf("%-24s %9s %9s %9s\n", "variant", "mean ms", "min ms", "8B/key %");
  for (size_t j = 0; j < vs.size(); ++j) {
    double s = 0, m = 1e9;
    for (float t : ms[j]) { s += t; m = std::min<double>(m, t); }
    s /= ms[j].size();
    const double bound = 8.0 * n / (gbps * 1e6);
    std::printf("%-24s %9.4f %9.4f %9.1f\n", vs[j].name.c_str(), s, m, 100.0 * bound / s);
  }
  std::printf("%s\n", all_ok ? "ALL EXACT" : "SOME WRONG");
  return all_ok ? 0 : 1;
}
