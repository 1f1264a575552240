// Codec speed-of-light and layout labs for Hopper (sm_90a), bound through a
// plain C interface beside the production codec (codec.cu) and loaded with
// ctypes (see ibu_tpu_torch/ops/_build.py and ibu_tpu_torch/labs/_kernels.py).
//
// lab_encode_kernel and lab_decode_kernel replace the TPU lab kernels
//   tools/sol_lab.py::_call (make_plane, make_packed: enc/dec modes, the
//     touch and reduce floors, the packed-word codec)
//   tools/kernel_lab.py::make_roundtrip -> encode (enc-in x soa rows)
//   tools/kernel_lab.py::make_roundtrip -> decode (soa rows x dec-out)
// as one encode and one decode template over three axes:
//
//   Mode    encode: real (production pack_row), tree (halving or-tree over
//           pre-shifted codes), swar (the code transform on four bases in one
//           u32), dp4a (four codes to one byte by __dp4a against 1,4,16,64),
//           touch, reduce; decode: nib (production unpack_row), lut (the
//           arithmetic 65 + 2c + 2(c>>1) + 11(c & (c>>1))), touch, reduce.
//   Layout  sep: (N,16) + (N,12) uint8 rows, read as production reads them
//           (4-byte words where aligned, else bytes); comb: one (N,32) row,
//           bases 28-31 'A' padding, moved as two 16-byte vectors; packed:
//           (N,4) + (N,3) int32 words, the barcode as one 16-byte vector.
//   Cols    3: (N,3) int64 records [barcode, umi, index], as in production;
//           4: (N,4) with a zero word, stored as two 16-byte vectors.
//
// The floors have to read every byte: a CUDA thread moves only what it
// loads, unlike the TPU's grid pipeline, which moved whole blocks whatever
// the body touched. So touch folds each row with one XOR per 8 bytes
// (barcode bytes 0-7 ^ 8-15, UMI bytes 0-7 ^ 8-11) and its decode writes
// the record's bytes back (barcode = barcode word ‖ UMI word, UMI = its
// first 12 bytes); reduce takes the largest byte of each field with
// __vmaxu4 and writes it to every base. Both copy the index.
//
// What bounds them: device-memory bytes, as for the production kernels
// (codec.cu). One thread per record with a grid-stride loop and 64-bit
// offsets; the block size is the caller's. Kernels launch on the caller's
// stream, allocate nothing and never synchronise; each C entry point returns
// cudaGetLastError(), or cudaErrorInvalidValue for a combination that is not
// built.

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec_device.cuh"

namespace {

using namespace ibu;

constexpr int64_t kMaxGrid = int64_t(1) << 20;
constexpr uint32_t kPadA = 0x41414141u;  // four 'A's

enum EncMode { kReal = 0, kTree = 1, kSwar = 2, kDp4a = 3, kEncTouch = 4, kEncReduce = 5 };
enum DecMode { kNib = 0, kLut = 1, kDecTouch = 2, kDecReduce = 3 };
enum Layout { kSep = 0, kComb = 1, kPacked = 2 };

// Widest access a row allows: 16-byte vectors, 4-byte words or bytes.
__device__ __forceinline__ int row_align(const void* base, int stride) {
  uintptr_t p = reinterpret_cast<uintptr_t>(base);
  if (p % 16 == 0 && stride % 16 == 0) return 16;
  if (p % 4 == 0 && stride % 4 == 0) return 4;
  return 1;
}

template <int NW>
__device__ __forceinline__ void load_row(const uint8_t* row, int align,
                                         uint32_t (&w)[NW]) {
  if (NW % 4 == 0 && align == 16) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      uint4 x = v[q];
      w[4 * q] = x.x;
      w[4 * q + 1] = x.y;
      w[4 * q + 2] = x.z;
      w[4 * q + 3] = x.w;
    }
  } else if (align >= 4) {
    const uint32_t* r4 = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = r4[j];
  } else {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      w[j] = uint32_t(row[4 * j]) | uint32_t(row[4 * j + 1]) << 8 |
             uint32_t(row[4 * j + 2]) << 16 | uint32_t(row[4 * j + 3]) << 24;
    }
  }
}

template <int NW>
__device__ __forceinline__ void store_row(uint8_t* row, int align,
                                          const uint32_t (&w)[NW]) {
  if (NW % 4 == 0 && align == 16) {
    uint4* v = reinterpret_cast<uint4*>(row);
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      v[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    }
  } else if (align >= 4) {
    uint32_t* r4 = reinterpret_cast<uint32_t*>(row);
#pragma unroll
    for (int j = 0; j < NW; ++j) r4[j] = w[j];
  } else {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) row[4 * j + k] = uint8_t(w[j] >> (8 * k));
    }
  }
}

// Four ASCII bytes -> their four 2-bit codes, one per byte.
__device__ __forceinline__ uint32_t swar_codes(uint32_t v) {
  uint32_t t = (v >> 1) & 0x03030303u;
  return (t ^ (t >> 1)) & 0x03030303u;
}

// The or of R pre-shifted terms as a halving tree: the upper half onto the
// lower, an odd term out carried to the next level, as the TPU lab's
// _encode_tile_tree does. Recursion on R keeps every index a constant, so
// the terms stay in registers.
template <int R>
__device__ __forceinline__ uint64_t or_tree(uint64_t* t) {
  if constexpr (R == 1) {
    return t[0];
  } else {
#pragma unroll
    for (int i = 0; i < R / 2; ++i) t[i] |= t[i + R / 2];
    if constexpr (R % 2 == 1) t[R / 2] = t[R - 1];
    return or_tree<R / 2 + R % 2>(t);
  }
}

// The first NW words of a row (4 bases each) -> the packed field word.
template <int Mode, int NW>
__device__ __forceinline__ uint64_t pack_words(const uint32_t (&w)[NW]) {
  uint64_t out = 0;
  if constexpr (Mode == kReal) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        out |= base_code((w[j] >> (8 * k)) & 0xFFu) << (2 * (4 * j + k));
      }
    }
  } else if constexpr (Mode == kTree) {
    uint64_t t[4 * NW];
#pragma unroll
    for (int i = 0; i < 4 * NW; ++i) {
      t[i] = base_code((w[i / 4] >> (8 * (i % 4))) & 0xFFu) << (2 * i);
    }
    out = or_tree<4 * NW>(t);
  } else if constexpr (Mode == kSwar) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint32_t c = swar_codes(w[j]);
      uint32_t b = (c | (c >> 6) | (c >> 12) | (c >> 18)) & 0xFFu;
      out |= uint64_t(b) << (8 * j);
    }
  } else {  // kDp4a
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint32_t b = __dp4a(swar_codes(w[j]), 0x40100401u, 0u);
      out |= uint64_t(b) << (8 * j);
    }
  }
  return out;
}

// A packed field word -> NW words of uppercase ASCII.
template <int Mode, int NW>
__device__ __forceinline__ void unpack_words(uint64_t word, uint32_t (&w)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t a;
      if constexpr (Mode == kNib) {
        a = code_ascii(word, 4 * j + k);
      } else {
        uint32_t c = uint32_t(word >> (2 * (4 * j + k))) & 3u;
        a = 65u + 2u * c + 2u * (c >> 1) + 11u * (c & (c >> 1));
      }
      v |= a << (8 * k);
    }
    w[j] = v;
  }
}

__device__ __forceinline__ uint32_t max_byte(uint32_t m) {
  m = __vmaxu4(m, m >> 16);
  m = __vmaxu4(m, m >> 8);
  return m & 0xFFu;
}

__device__ __forceinline__ uint64_t pair(uint32_t lo, uint32_t hi) {
  return uint64_t(lo) | (uint64_t(hi) << 32);
}

template <int Cols>
__device__ __forceinline__ void store_record(int64_t* out, uint64_t b,
                                             uint64_t u, int64_t index) {
  if constexpr (Cols == 4) {
    longlong2* v = reinterpret_cast<longlong2*>(out);
    v[0] = make_longlong2(int64_t(b), int64_t(u));
    v[1] = make_longlong2(index, 0);
  } else {
    out[0] = int64_t(b);
    out[1] = int64_t(u);
    out[2] = index;
  }
}

template <int Cols>
__device__ __forceinline__ void load_record(const int64_t* in, uint64_t& b,
                                            uint64_t& u, int64_t& index) {
  if constexpr (Cols == 4) {
    const longlong2* v = reinterpret_cast<const longlong2*>(in);
    longlong2 x = v[0];
    b = uint64_t(x.x);
    u = uint64_t(x.y);
    index = v[1].x;
  } else {
    b = uint64_t(in[0]);
    u = uint64_t(in[1]);
    index = in[2];
  }
}

// a: barcode rows (sep: (N,16) u8; comb: (N,32) u8; packed: (N,4) int32),
// b: UMI rows (sep: (N,12) u8; packed: (N,3) int32; comb: unused).
template <int Mode, int Lay, int Cols>
__global__ void lab_encode_kernel(const uint8_t* __restrict__ a,
                                  const uint8_t* __restrict__ b,
                                  const int64_t* __restrict__ index,
                                  int64_t* __restrict__ out, int64_t n) {
  constexpr int kBcStride = Lay == kComb ? 32 : 16;
  constexpr int kUmiStride = Lay == kComb ? 32 : 12;
  const uint8_t* umi_base = Lay == kComb ? a + 16 : b;
  // sep reads rows as production does: 4-byte words where aligned.
  const int bc_align = Lay == kSep ? (word_rows(a, 16) ? 4 : 1) : row_align(a, kBcStride);
  const int umi_align =
      Lay == kSep ? (word_rows(b, 12) ? 4 : 1) : row_align(umi_base, kUmiStride);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const uint8_t* bc = a + r * kBcStride;
    const uint8_t* umi = umi_base + r * kUmiStride;
    uint64_t wb, wu;
    if constexpr (Mode == kReal && Lay == kSep) {
      wb = pack_row(bc, 16, bc_align == 4);
      wu = pack_row(umi, 12, umi_align == 4);
    } else {
      uint32_t bw[4], uw[3];
      if constexpr (Lay == kComb) {
        uint32_t cw[8];
        load_row<8>(bc, bc_align, cw);
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = cw[j];
#pragma unroll
        for (int j = 0; j < 3; ++j) uw[j] = cw[4 + j];
      } else {
        load_row<4>(bc, bc_align, bw);
        load_row<3>(umi, umi_align, uw);
      }
      if constexpr (Mode == kEncTouch) {
        wb = pair(bw[0], bw[1]) ^ pair(bw[2], bw[3]);
        wu = pair(uw[0], uw[1]) ^ uint64_t(uw[2]);
      } else if constexpr (Mode == kEncReduce) {
        wb = max_byte(__vmaxu4(__vmaxu4(bw[0], bw[1]), __vmaxu4(bw[2], bw[3])));
        wu = max_byte(__vmaxu4(__vmaxu4(uw[0], uw[1]), uw[2]));
      } else {
        wb = pack_words<Mode, 4>(bw);
        wu = pack_words<Mode, 3>(uw);
      }
    }
    store_record<Cols>(out + r * Cols, wb, wu, index[r]);
  }
}

// a, b: the output rows, laid out as lab_encode_kernel's inputs.
template <int Mode, int Lay, int Cols>
__global__ void lab_decode_kernel(const int64_t* __restrict__ records,
                                  uint8_t* __restrict__ a,
                                  uint8_t* __restrict__ b,
                                  int64_t* __restrict__ index, int64_t n) {
  constexpr int kBcStride = Lay == kComb ? 32 : 16;
  const int bc_align = Lay == kSep ? (word_rows(a, 16) ? 4 : 1) : row_align(a, kBcStride);
  const int umi_align = Lay == kSep ? (word_rows(b, 12) ? 4 : 1) : row_align(b, 12);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    uint64_t wb, wu;
    int64_t idx;
    load_record<Cols>(records + r * Cols, wb, wu, idx);
    index[r] = idx;
    uint8_t* bc = a + r * kBcStride;
    if constexpr (Mode == kNib && Lay == kSep) {
      unpack_row(wb, bc, 16, bc_align == 4);
      unpack_row(wu, b + r * 12, 12, umi_align == 4);
      continue;
    }
    uint32_t bw[4], uw[3];
    if constexpr (Mode == kDecTouch) {
      bw[0] = uint32_t(wb);
      bw[1] = uint32_t(wb >> 32);
      bw[2] = uint32_t(wu);
      bw[3] = uint32_t(wu >> 32);
#pragma unroll
      for (int j = 0; j < 3; ++j) uw[j] = bw[j];
    } else if constexpr (Mode == kDecReduce) {
      uint32_t m = max_byte(__vmaxu4(__vmaxu4(uint32_t(wb), uint32_t(wb >> 32)),
                                     __vmaxu4(uint32_t(wu), uint32_t(wu >> 32))));
      m *= 0x01010101u;
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = m;
#pragma unroll
      for (int j = 0; j < 3; ++j) uw[j] = m;
    } else {
      unpack_words<Mode, 4>(wb, bw);
      unpack_words<Mode, 3>(wu, uw);
    }
    if constexpr (Lay == kComb) {
      uint32_t cw[8] = {bw[0], bw[1], bw[2], bw[3], uw[0], uw[1], uw[2], kPadA};
      store_row<8>(bc, bc_align, cw);
    } else {
      store_row<4>(bc, bc_align, bw);
      store_row<3>(b + r * 12, umi_align, uw);
    }
  }
}

unsigned int grid_for(int64_t n, int block) {
  int64_t blocks = (n + block - 1) / block;
  return unsigned(blocks < kMaxGrid ? blocks : kMaxGrid);
}

template <int Mode, int Lay, int Cols>
int launch_encode(const void* a, const void* b, const void* index, void* out,
                  int64_t n, int block, cudaStream_t stream) {
  lab_encode_kernel<Mode, Lay, Cols><<<grid_for(n, block), block, 0, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const int64_t*>(index), static_cast<int64_t*>(out), n);
  return int(cudaGetLastError());
}

template <int Mode, int Lay, int Cols>
int launch_decode(const void* records, void* a, void* b, void* index,
                  int64_t n, int block, cudaStream_t stream) {
  lab_decode_kernel<Mode, Lay, Cols><<<grid_for(n, block), block, 0, stream>>>(
      static_cast<const int64_t*>(records), static_cast<uint8_t*>(a),
      static_cast<uint8_t*>(b), static_cast<int64_t*>(index), n);
  return int(cudaGetLastError());
}

}  // namespace

// The combinations the labs run: sol_lab's modes on sep rows and (N,3)
// records, the packed codec and its floor, and kernel_lab's layouts with the
// production codec.
extern "C" int ibu_lab_encode(const void* a, const void* b, const void* index,
                              void* out, int64_t n, int mode, int layout,
                              int cols, int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == kSep && cols == 3) {
    switch (mode) {
      case kReal: return launch_encode<kReal, kSep, 3>(a, b, index, out, n, block, s);
      case kTree: return launch_encode<kTree, kSep, 3>(a, b, index, out, n, block, s);
      case kSwar: return launch_encode<kSwar, kSep, 3>(a, b, index, out, n, block, s);
      case kDp4a: return launch_encode<kDp4a, kSep, 3>(a, b, index, out, n, block, s);
      case kEncTouch: return launch_encode<kEncTouch, kSep, 3>(a, b, index, out, n, block, s);
      case kEncReduce: return launch_encode<kEncReduce, kSep, 3>(a, b, index, out, n, block, s);
    }
  } else if (layout == kPacked && cols == 3) {
    switch (mode) {
      case kReal: return launch_encode<kReal, kPacked, 3>(a, b, index, out, n, block, s);
      case kEncTouch: return launch_encode<kEncTouch, kPacked, 3>(a, b, index, out, n, block, s);
    }
  } else if (mode == kReal) {
    if (layout == kSep && cols == 4) return launch_encode<kReal, kSep, 4>(a, b, index, out, n, block, s);
    if (layout == kComb && cols == 3) return launch_encode<kReal, kComb, 3>(a, b, index, out, n, block, s);
    if (layout == kComb && cols == 4) return launch_encode<kReal, kComb, 4>(a, b, index, out, n, block, s);
  }
  return int(cudaErrorInvalidValue);
}

extern "C" int ibu_lab_decode(const void* records, void* a, void* b,
                              void* index, int64_t n, int mode, int layout,
                              int cols, int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == kSep && cols == 3) {
    switch (mode) {
      case kNib: return launch_decode<kNib, kSep, 3>(records, a, b, index, n, block, s);
      case kLut: return launch_decode<kLut, kSep, 3>(records, a, b, index, n, block, s);
      case kDecTouch: return launch_decode<kDecTouch, kSep, 3>(records, a, b, index, n, block, s);
      case kDecReduce: return launch_decode<kDecReduce, kSep, 3>(records, a, b, index, n, block, s);
    }
  } else if (layout == kPacked && cols == 3) {
    switch (mode) {
      case kNib: return launch_decode<kNib, kPacked, 3>(records, a, b, index, n, block, s);
      case kDecTouch: return launch_decode<kDecTouch, kPacked, 3>(records, a, b, index, n, block, s);
    }
  } else if (mode == kNib) {
    if (layout == kSep && cols == 4) return launch_decode<kNib, kSep, 4>(records, a, b, index, n, block, s);
    if (layout == kComb && cols == 3) return launch_decode<kNib, kComb, 3>(records, a, b, index, n, block, s);
    if (layout == kComb && cols == 4) return launch_decode<kNib, kComb, 4>(records, a, b, index, n, block, s);
  }
  return int(cudaErrorInvalidValue);
}
