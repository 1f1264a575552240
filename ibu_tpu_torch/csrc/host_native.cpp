// Host runtime of ibu_tpu_torch: the threaded field-sum engine and the host
// 2-bit codec, with a plain C interface loaded by ctypes
// (ibu_tpu_torch/native.py).
//
// A copy of the functions of ibu_tpu/native/ibu_native.cpp that the port
// uses: ibu_checksum_parallel and ibu_pack_2bit / ibu_unpack_2bit with their
// threaded _mt forms. Built with g++ (not nvcc) into its own library, so it
// builds and runs where there is no CUDA toolkit. Every function returns 0
// on success or a negative errno-style code.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

static const uint64_t RECORD_SIZE = 24;

struct IbuRecord {
  uint64_t barcode;
  uint64_t umi;
  uint64_t index;
};
static_assert(sizeof(IbuRecord) == 24, "wire record must be 24 bytes");

// Sum the three record fields over [0, n) records with nthreads, using the
// reference's contiguous remainder-to-last partition. Wrapping u64 adds.
int ibu_checksum_parallel(const char* path, uint64_t n_records,
                          uint64_t* out3, int nthreads) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  struct stat st;
  if (::fstat(fd, &st) != 0) { int e = errno; ::close(fd); return -e; }
  uint64_t need = 32 + n_records * RECORD_SIZE;
  if (static_cast<uint64_t>(st.st_size) < need) { ::close(fd); return -EINVAL; }
  void* map = ::mmap(nullptr, need, PROT_READ, MAP_SHARED, fd, 0);
  ::close(fd);
  if (map == MAP_FAILED) return -errno;
  const IbuRecord* recs =
      reinterpret_cast<const IbuRecord*>(static_cast<const uint8_t*>(map) + 32);

  if (nthreads <= 0) nthreads = std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, 256));
  uint64_t per = n_records / nthreads;
  std::vector<std::thread> threads;
  std::vector<uint64_t> partial(static_cast<size_t>(nthreads) * 3, 0);
  for (int t = 0; t < nthreads; ++t) {
    uint64_t start = static_cast<uint64_t>(t) * per;
    uint64_t end = (t == nthreads - 1) ? n_records : start + per;
    threads.emplace_back([recs, start, end, t, &partial]() {
      uint64_t b = 0, u = 0, i = 0;
      for (uint64_t k = start; k < end; ++k) {
        b += recs[k].barcode;
        u += recs[k].umi;
        i += recs[k].index;
      }
      partial[3 * t + 0] = b;
      partial[3 * t + 1] = u;
      partial[3 * t + 2] = i;
    });
  }
  for (auto& th : threads) th.join();
  out3[0] = out3[1] = out3[2] = 0;
  for (int t = 0; t < nthreads; ++t) {
    out3[0] += partial[3 * t + 0];
    out3[1] += partial[3 * t + 1];
    out3[2] += partial[3 * t + 2];
  }
  ::munmap(map, need);
  return 0;
}

// Pack n sequences of L ASCII bases (row-major, n x L) into u64 words, base
// i at bits 2i, A=00 C=01 G=10 T=11 (case-insensitive, total). Returns
// -EINVAL on the first invalid base when validate != 0.
int ibu_pack_2bit(const uint8_t* ascii, uint64_t n, uint32_t L,
                  uint64_t* out, int validate) {
  if (L == 0 || L > 32) return -EINVAL;
  for (uint64_t r = 0; r < n; ++r) {
    const uint8_t* row = ascii + r * L;
    uint64_t word = 0;
    if (validate) {
      for (uint32_t i = 0; i < L; ++i) {
        uint8_t c = row[i] & 0xDF;  // uppercase
        if (c != 'A' && c != 'C' && c != 'G' && c != 'T') return -EINVAL;
      }
    }
    for (uint32_t i = 0; i < L; ++i) {
      uint64_t t = (row[i] >> 1) & 3;
      word |= (t ^ (t >> 1)) << (2 * i);
    }
    out[r] = word;
  }
  return 0;
}

// Unpack n u64 words into n x L uppercase ASCII bases (row-major).
int ibu_unpack_2bit(const uint64_t* words, uint64_t n, uint32_t L,
                    uint8_t* out) {
  if (L == 0 || L > 32) return -EINVAL;
  static const char LUT[4] = {'A', 'C', 'G', 'T'};
  for (uint64_t r = 0; r < n; ++r) {
    uint64_t w = words[r];
    uint8_t* row = out + r * L;
    for (uint32_t i = 0; i < L; ++i) {
      row[i] = static_cast<uint8_t>(LUT[(w >> (2 * i)) & 3]);
    }
  }
  return 0;
}

// Threaded forms: rows split contiguously over nthreads (0: all cores) from
// 65536 rows up; below that, or with one thread, the scalar path. A failed
// validation surfaces as -EINVAL exactly as in the scalar path.
int ibu_pack_2bit_mt(const uint8_t* ascii, uint64_t n, uint32_t L,
                     uint64_t* out, int validate, int nthreads) {
  if (L == 0 || L > 32) return -EINVAL;
  if (nthreads <= 0) nthreads = std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, 64));
  if (n < 65536 || nthreads == 1)
    return ibu_pack_2bit(ascii, n, L, out, validate);
  std::atomic<int> failure(0);
  std::vector<std::thread> threads;
  uint64_t per = n / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    uint64_t start = static_cast<uint64_t>(t) * per;
    uint64_t end = (t == nthreads - 1) ? n : start + per;
    threads.emplace_back([=, &failure]() {
      int rc = ibu_pack_2bit(ascii + start * L, end - start, L,
                             out + start, validate);
      if (rc != 0) failure.store(-rc);
    });
  }
  for (auto& th : threads) th.join();
  return -failure.load();
}

int ibu_unpack_2bit_mt(const uint64_t* words, uint64_t n, uint32_t L,
                       uint8_t* out, int nthreads) {
  if (L == 0 || L > 32) return -EINVAL;
  if (nthreads <= 0) nthreads = std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, 64));
  if (n < 65536 || nthreads == 1)
    return ibu_unpack_2bit(words, n, L, out);
  std::atomic<int> failure(0);
  std::vector<std::thread> threads;
  uint64_t per = n / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    uint64_t start = static_cast<uint64_t>(t) * per;
    uint64_t end = (t == nthreads - 1) ? n : start + per;
    threads.emplace_back([=, &failure]() {
      int rc = ibu_unpack_2bit(words + start, end - start, L,
                               out + start * L);
      if (rc != 0) failure.store(-rc);
    });
  }
  for (auto& th : threads) th.join();
  return -failure.load();
}

}  // extern "C"
