// Device code of the 2-bit codec shared by the production kernels
// (codec.cu) and the codec labs (codec_lab.cu), so the labs' `prod` rows run
// the production per-record code itself.
//
// Base i of a field sits at bits 2i of its u64 word (A=00, C=01, G=10,
// T=11). The code is total: any byte maps to a code, lowercase like
// uppercase; decoding gives uppercase ASCII.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ibu {

// 'A','C','G','T' as little-endian bytes: code -> ASCII is a byte select.
constexpr uint32_t kAsciiTable = 0x54474341u;

__device__ __forceinline__ uint64_t base_code(uint32_t c) {
  // (c >> 1) & 3 maps A,C,G,T (either case) to 0,1,3,2; the 2-bit Gray
  // code t ^ (t >> 1) reorders that to 0,1,2,3.
  uint32_t t = (c >> 1) & 3u;
  return uint64_t(t ^ (t >> 1));
}

__device__ __forceinline__ uint32_t code_ascii(uint64_t word, int i) {
  uint32_t code = uint32_t(word >> (2 * i)) & 3u;
  return (kAsciiTable >> (8u * code)) & 0xFFu;
}

__device__ __forceinline__ bool word_rows(const void* base, int len) {
  return (len % 4 == 0) && (reinterpret_cast<uintptr_t>(base) % 4 == 0);
}

__device__ __forceinline__ uint64_t pack_row(const uint8_t* row, int len,
                                             bool words) {
  unsigned long long w = 0;
  if (words) {
    const uint32_t* row4 = reinterpret_cast<const uint32_t*>(row);
    for (int j = 0; j < len / 4; ++j) {
      uint32_t v = row4[j];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w |= base_code((v >> (8 * k)) & 0xFFu) << (2 * (4 * j + k));
      }
    }
  } else {
    for (int i = 0; i < len; ++i) {
      w |= base_code(row[i]) << (2 * i);
    }
  }
  return w;
}

__device__ __forceinline__ void unpack_row(uint64_t word, uint8_t* row,
                                           int len, bool words) {
  if (words) {
    uint32_t* row4 = reinterpret_cast<uint32_t*>(row);
    for (int j = 0; j < len / 4; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v |= code_ascii(word, 4 * j + k) << (8 * k);
      }
      row4[j] = v;
    }
  } else {
    for (int i = 0; i < len; ++i) {
      row[i] = uint8_t(code_ascii(word, i));
    }
  }
}

}  // namespace ibu
