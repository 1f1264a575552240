// The record sort's kernels (ibu_tpu_torch/csrc/record_sort.cu) timed one by
// one, and the pass kernel and the rebuild timed with parts changed or
// removed, on 2^22 records shaped like a Drop-seq batch (24-bit barcode,
// 16-bit UMI, a Zipf-like gene id below 36,601: a 56-bit key, 7 passes).
// Every variant that sorts is checked exactly against std::sort first; a
// variant with a part removed writes wrong places on purpose and is timed
// only. CUDA events, the median of 9 repetitions after one warm-up.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -I ibu_tpu_torch/csrc ibu_tpu_torch/labs/record_sort_ablation.cu -o build/record_sort_ablation
//   ./build/record_sort_ablation
//
// One JSON line per measurement. It is not built by ops/_build.py (which
// compiles csrc/ alone) and needs no torch.

#include "record_sort.cu"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <random>
#include <vector>

namespace {

constexpr int kRank = 1, kLookBack = 2, kScatter = 4, kAll = 7;
constexpr int kReps = 9;

// exclusive scan over the first 256 threads (one per digit); every thread calls it
__device__ __forceinline__ long long scan256(long long v, long long* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
  if (warp < 8) {
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, s);
      if (lane >= s) x += y;
    }
    if (lane == 31) scratch[warp] = x;
  }
  __syncthreads();
  long long before = 0;
  if (warp < 8)
    for (int w = 0; w < warp; ++w) before += scratch[w];
  __syncthreads();
  return before + x - v;
}

// pass_kernel<1, ITEMS> with THREADS threads a block, at least MINB blocks an
// SM, EARLY: the tile's counts by shared atomics and published before the
// rank; PARTS: which of rank, look-back and scatter run (without the rank a
// key's place is its slot; without the look-back the prefix is a guess;
// without the scatter one word is written).
template <int THREADS, int ITEMS, int MINB, bool EARLY, int PARTS>
__global__ void __launch_bounds__(THREADS, MINB)
pass_variant(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n, int pass,
             const unsigned* __restrict__ hist, unsigned long long* status, unsigned* counter) {
  constexpr int WARPS = THREADS / 32;
  constexpr int TILE = THREADS * ITEMS;
  constexpr bool RANK = PARTS & kRank, LOOKBACK = PARTS & kLookBack, SCATTER = PARTS & kScatter;
  __shared__ unsigned warp_counts[WARPS][kDigits];
  __shared__ unsigned local_start[kDigits];
  __shared__ long long global_base[kDigits];
  __shared__ long long scan_scratch[8];
  __shared__ unsigned tile_slot;
  extern __shared__ uint64_t exchange[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_slot = atomicAdd(counter + pass, 1u);
  for (int c = tid; c < WARPS * kDigits; c += THREADS) (&warp_counts[0][0])[c] = 0;
  __syncthreads();
  const int64_t tile = tile_slot;
  const int64_t base = tile * TILE;
  const int64_t first = base + warp * (ITEMS * 32) + lane;
  const int shift = (pass & 7) * 8;
  uint64_t key[ITEMS];
  unsigned place[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) key[k] = first + k * 32 < n ? in[first + k * 32] : 0;
  auto digit = [&](int k) { return int((key[k] >> shift) & 0xFF); };
  const uint64_t tag = uint64_t(pass + 1) << 56;
  volatile unsigned long long* vstatus = status;
  unsigned count = 0;
  if (EARLY || !RANK) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (first + k * 32 < n) atomicAdd(&warp_counts[warp][digit(k)], 1u);
    __syncthreads();
    if (tid < kDigits) {
      for (int w = 0; w < WARPS; ++w) {
        const unsigned c = warp_counts[w][tid];
        warp_counts[w][tid] = count;
        count += c;
      }
      vstatus[tile * kDigits + tid] = (tile == 0 ? kPrefix : kAggregate) | tag | count;
    }
    __syncthreads();
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (!RANK) {
      place[k] = 0;
      continue;
    }
    const bool valid = first + k * 32 < n;
    const int d = digit(k);
    const unsigned peers = digit_peers(d) & __ballot_sync(kFull, valid);
    const unsigned before = __popc(peers & below);
    unsigned prior = 0;
    if (valid) prior = warp_counts[warp][d];
    place[k] = prior + before;
    __syncwarp();
    if (valid && before == 0) warp_counts[warp][d] = prior + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  long long prefix = 0;
  if (!EARLY && RANK && tid < kDigits) {
    for (int w = 0; w < WARPS; ++w) {
      const unsigned c = warp_counts[w][tid];
      warp_counts[w][tid] = count;
      count += c;
    }
    vstatus[tile * kDigits + tid] = (tile == 0 ? kPrefix : kAggregate) | tag | count;
  }
  if (tid < kDigits && tile > 0) {
    if (LOOKBACK) {
      for (int64_t t = tile - 1;;) {
        const uint64_t s = vstatus[t * kDigits + tid];
        if ((s & kTagMask) != tag || (s >> 62) == 0) continue;
        prefix += static_cast<long long>(s & kCountMask);
        if ((s >> 62) == 2) break;
        --t;
      }
    } else {
      prefix = tile * (TILE / kDigits);
    }
    vstatus[tile * kDigits + tid] = kPrefix | tag | uint64_t(prefix + count);
  }
  const long long start = scan256(count, scan_scratch);
  const long long bucket = scan256(tid < kDigits ? hist[pass * kDigits + tid] : 0, scan_scratch);
  if (tid < kDigits) {
    local_start[tid] = unsigned(start);
    global_base[tid] = bucket + prefix - start;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int d = digit(k);
    place[k] += local_start[d] + (EARLY || !RANK ? 0u : warp_counts[warp][d]);
    if (!RANK) place[k] = (warp * ITEMS + k) * 32 + lane;
    if (first + k * 32 < n) exchange[place[k]] = key[k];
  }
  __syncthreads();
  const int tile_keys = int(n - base < TILE ? n - base : TILE);
  if (!SCATTER) {
    if (exchange[tid] == 12345) out[0] = 1;  // keeps the exchange live
    return;
  }
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = tid + r * THREADS;
    if (i < tile_keys) {
      const uint64_t v = exchange[i];
      long long dst = global_base[int((v >> shift) & 0xFF)] + i;
      if (PARTS != kAll) dst &= n - 1;  // wrong places: keep them inside (n is 2^22)
      out[dst] = v;
    }
  }
}

// the rebuild without staging: each thread stores its record's three words
__global__ void __launch_bounds__(kThreads)
unpack_direct(const uint64_t* __restrict__ keys, int64_t n, const unsigned long long* __restrict__ ors,
              Masks masks, uint64_t* __restrict__ out) {
  const Layout l = key_layout(ors, masks);
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x; r < n; r += stride) {
    const uint64_t k[1] = {keys[r]};
#pragma unroll
    for (int f = 0; f < 3; ++f) out[3 * r + f] = get(k, l.offset[f], l.width[f]);
  }
}

struct Timer {
  cudaEvent_t a, b;
  std::vector<float> ms;
  Timer() {
    cudaEventCreate(&a);
    cudaEventCreate(&b);
  }
  void start() { cudaEventRecord(a); }
  void stop(bool keep) {
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float t;
    cudaEventElapsedTime(&t, a, b);
    if (keep) ms.push_back(t);
  }
  float median() {
    std::sort(ms.begin(), ms.end());
    return ms[ms.size() / 2];
  }
};

void report(const char* what, float ms, double bound_bytes, const char* correct) {
  printf("{\"what\": \"%s\", \"ms\": %.5f, \"bound_ms\": %.5f, \"pct_of_bound\": %.1f, \"correct\": %s}\n",
         what, ms, bound_bytes / 3350e9 * 1e3, 100.0 * bound_bytes / 3350e9 * 1e3 / ms, correct);
}

struct Bench {
  int64_t n;
  uint64_t *rec, *keys, *a, *b, *out;
  unsigned* hist;
  unsigned* counter;
  unsigned long long *status, *ors;
  std::vector<uint64_t> sorted_keys, sorted_rec;
};

template <int THREADS, int ITEMS, int MINB, bool EARLY, int PARTS>
void pass_run(Bench& m, const char* what) {
  auto k = pass_variant<THREADS, ITEMS, MINB, EARLY, PARTS>;
  constexpr int TILE = THREADS * ITEMS;
  const int dyn = TILE * 8;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  int occupancy = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, k, THREADS, dyn);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, k);
  const unsigned tiles = unsigned((m.n + TILE - 1) / TILE);
  Timer t;
  for (int rep = 0; rep <= kReps; ++rep) {
    cudaMemcpy(m.a, m.keys, m.n * 8, cudaMemcpyDeviceToDevice);
    cudaMemset(m.status, 0, size_t(tiles) * kDigits * 8);
    cudaMemset(m.counter, 0, 256);
    t.start();
    for (int p = 0; p < 7; ++p)
      k<<<tiles, THREADS, dyn>>>(p & 1 ? m.b : m.a, p & 1 ? m.a : m.b, m.n, p, m.hist, m.status, m.counter);
    t.stop(rep > 0);
  }
  const char* correct = "null";
  if (PARTS == kAll) {
    std::vector<uint64_t> got(m.n);
    cudaMemcpy(got.data(), m.b, m.n * 8, cudaMemcpyDeviceToHost);  // 7 passes end in b
    correct = got == m.sorted_keys ? "true" : "false";
  }
  char label[256];
  snprintf(label, sizeof label, "7 passes: %s (%dx%d, min %d blocks, %d regs, %d blocks an SM)",
           what, THREADS, ITEMS, MINB, attr.numRegs, occupancy);
  report(label, t.median(), 7 * 16.0 * m.n, correct);
}

}  // namespace

int main() {
  Bench m;
  m.n = int64_t(1) << 22;
  const int64_t n = m.n;
  std::mt19937_64 rng(12345);
  std::vector<uint64_t> rec(3 * n), keys(n);
  for (int64_t r = 0; r < n; ++r) {
    const uint64_t bc = rng() & 0xFFFFFF, umi = rng() & 0xFFFF;
    const double u = double(rng() >> 11) / double(uint64_t(1) << 53);
    const uint64_t gene = uint64_t(std::pow(36601.0, u)) - 1;
    rec[3 * r] = bc, rec[3 * r + 1] = umi, rec[3 * r + 2] = gene;
    keys[r] = bc << 32 | umi << 16 | gene;  // the packed key: widths 24, 16, 16
  }
  m.sorted_keys = keys;
  std::sort(m.sorted_keys.begin(), m.sorted_keys.end());
  m.sorted_rec.resize(3 * n);
  for (int64_t r = 0; r < n; ++r) {
    const uint64_t k = m.sorted_keys[r];
    m.sorted_rec[3 * r] = k >> 32, m.sorted_rec[3 * r + 1] = (k >> 16) & 0xFFFF,
    m.sorted_rec[3 * r + 2] = k & 0xFFFF;
  }
  std::vector<unsigned> hist(kMaxPasses * kDigits, 0);
  for (auto k : keys)
    for (int p = 0; p < 7; ++p) hist[p * kDigits + ((k >> (8 * p)) & 0xFF)]++;
  // the gene ids' OR has bit 15 set only if some id reaches 32768: set the
  // widths the key above assumes
  const unsigned long long ors_h[3] = {0xFFFFFFull, 0xFFFFull, 0xFFFFull};
  cudaMalloc(&m.rec, 3 * n * 8);
  cudaMalloc(&m.keys, n * 8);
  cudaMalloc(&m.a, n * 8);
  cudaMalloc(&m.b, n * 8);
  cudaMalloc(&m.out, 3 * n * 8);
  cudaMalloc(&m.hist, hist.size() * 4);
  cudaMalloc(&m.counter, 256);
  cudaMalloc(&m.status, (n / 1024 + 1) * kDigits * 8);
  cudaMalloc(&m.ors, 24);
  cudaMemcpy(m.rec, rec.data(), 3 * n * 8, cudaMemcpyHostToDevice);
  cudaMemcpy(m.keys, keys.data(), n * 8, cudaMemcpyHostToDevice);
  cudaMemcpy(m.hist, hist.data(), hist.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(m.ors, ors_h, 24, cudaMemcpyHostToDevice);
  const Masks lo = {{0xFFFFFFFFull, 0xFFFFFFFFull, 0xFFFFFFFFull}};
  const unsigned tiles = unsigned((n + 4095) / 4096);

  // the shipped kernels, one by one
  {
    Timer t_or, t_pack, t_pass, t_unpack;
    unsigned* d_hist2;
    cudaMalloc(&d_hist2, hist.size() * 4);
    unsigned long long* ors2;
    cudaMalloc(&ors2, 24);
    for (int rep = 0; rep <= kReps; ++rep) {
      cudaMemset(ors2, 0, 24);
      cudaMemset(d_hist2, 0, hist.size() * 4);
      cudaMemset(m.status, 0, size_t(tiles) * kDigits * 8);
      cudaMemset(m.counter, 0, 256);
      t_or.start();
      field_or_kernel<<<grid_for(n, 8), kThreads>>>(m.rec, n, ors2);
      t_or.stop(rep > 0);
      t_pack.start();
      pack_kernel<1><<<grid_for(n, 4), kThreads>>>(m.rec, n, m.ors, lo, m.a, d_hist2);
      t_pack.stop(rep > 0);
      t_pass.start();
      for (int p = 0; p < 7; ++p)
        pass_kernel<1, 16><<<tiles, kThreads>>>(p & 1 ? m.b : m.a, p & 1 ? m.a : m.b, n, m.ors, lo, p,
                                                 d_hist2, m.status, m.counter);
      t_pass.stop(rep > 0);
      t_unpack.start();
      unpack_kernel<1><<<grid_for(n, 8), kThreads>>>(m.a, m.b, n, m.ors, lo, m.out);
      t_unpack.stop(rep > 0);
    }
    std::vector<uint64_t> got(3 * n);
    cudaMemcpy(got.data(), m.out, 3 * n * 8, cudaMemcpyDeviceToHost);
    const char* ok = got == m.sorted_rec ? "true" : "false";
    report("field_or_kernel", t_or.median(), 24.0 * n, "null");
    report("pack_kernel<1>", t_pack.median(), 32.0 * n, "null");
    report("pass_kernel<1, 16> x 7", t_pass.median(), 7 * 16.0 * n, "null");
    report("unpack_kernel<1> (staged)", t_unpack.median(), 32.0 * n, ok);
    Timer t_direct;
    for (int rep = 0; rep <= kReps; ++rep) {
      t_direct.start();
      unpack_direct<<<grid_for(n, 8), kThreads>>>(m.b, n, m.ors, lo, m.out);
      t_direct.stop(rep > 0);
    }
    cudaMemcpy(got.data(), m.out, 3 * n * 8, cudaMemcpyDeviceToHost);
    report("unpack_direct (three strided stores a thread)", t_direct.median(), 32.0 * n,
           got == m.sorted_rec ? "true" : "false");
  }

  // the pass kernel with parts removed, and at other shapes
  pass_run<256, 16, 1, false, kAll>(m, "warm-up");
  pass_run<256, 16, 1, false, kAll>(m, "as shipped");
  pass_run<256, 16, 1, false, kRank>(m, "rank only");
  pass_run<256, 16, 1, false, kRank | kScatter>(m, "no look-back");
  pass_run<256, 16, 1, false, kRank | kLookBack>(m, "no scatter");
  pass_run<256, 16, 1, false, 0>(m, "load, count and scans only");
  pass_run<256, 16, 4, false, kAll>(m, "as shipped");
  pass_run<256, 16, 1, true, kAll>(m, "early counts");
  pass_run<256, 8, 1, false, kAll>(m, "as shipped");
  pass_run<256, 12, 3, true, kAll>(m, "early counts");
  pass_run<512, 8, 2, true, kAll>(m, "early counts");
  pass_run<256, 32, 1, false, kAll>(m, "as shipped");
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(e));
    return 1;
  }
  return 0;
}
