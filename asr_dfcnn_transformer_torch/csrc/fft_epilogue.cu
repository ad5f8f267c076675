// The last stage of the matmul inverse real FFT (ops/matfft.py
// irfft_matmul, epilogue "pallas") for the PyTorch port.
//
// Replaces asr_dfcnn_transformer_tpu/ops/pallas/fft_epilogue.py
// interleave_epilogue (its pallas_call and the body _epilogue_kernel). From
// the DFT stages' output zr, zi [B, n2, n1] (float32 or bfloat16) it writes
//
//   x[b, 2 (m2 + n2 m1) + p] = f32(z_p[b, m2, m1]) * (1 / n),  n = 2 n1 n2
//
// as float32: the [n2, n1] -> [n1, n2] transpose, the even/odd interleave
// of the real and imaginary parts, the upcast and the exact power-of-two
// scale, in one read of z and one write of x. The values are those of the
// plain relayout (kernels/fft_epilogue.py), bit for bit: the scale is
// applied after the upcast, and 1/n is exact.
//
// Bound: bytes. At batch 128, n 262,144 and bf16 z ([128, 256, 512] twice)
// it reads 67.1 MB and writes 134.2 MB: 0.0601 ms at 3.35 TB/s. The TPU
// kernel held one batch row's whole [n2, n1] pair in VMEM; here the
// relayout runs as a tiled transpose that keeps enough bytes in flight to
// stream device memory:
//   - a tile is 32 rows m2 by kCols = 16 V columns m1, V the elements of a
//     16-byte load (8 bf16, 4 f32); a thread loads rows m2 and m2 + 1 of
//     zr and zi at V columns, four 16-byte loads, so a half-warp reads 256
//     contiguous bytes of a row;
//   - the pair of rows gives, for each of its columns m1, the two (re, im)
//     pairs of output row m1 at m2 and m2 + 1: one float4, stored to
//     shared memory at [m1][pair chunk], the chunk XOR-swizzled by (m1 / V)
//     mod 8 so that neither these stores nor the reads below conflict;
//   - each output row m1 of the tile is 16 such chunks, 256 contiguous
//     bytes of x written by a half-warp's float4 stores;
//   - a block a tile and batch row, (m2 tile, m1 tile, b) its grid, four
//     or five blocks an SM, so that 64 KB or more of loads are in flight an
//     SM. A persistent grid that loaded the next tile before writing the
//     current one measured slower on an H100 (PERF.md): the block
//     scheduler balances the last wave better.
// Where a row's V columns are not all inside n1 or not 16-byte aligned (n1
// not a multiple of V, a batch row starting off a 16-byte boundary), the
// thread loads them one at a time, and a chunk of x that is cut by n2 or
// misaligned is written as (re, im) pairs: the same kernel takes every
// shape down to n 16 ([2, 4]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "dtype.cuh"

namespace {

constexpr int kRows = 32;      // m2 rows a tile: 16 pairs
constexpr int kThreads = 256;  // a pair and a column group each, to load
constexpr int kMaxGrid = 65535;  // grid y and z at most

template <typename T>
struct Tile {
  static constexpr int V = 16 / sizeof(T);  // elements a 16-byte load
  static constexpr int kCols = 16 * V;      // m1 columns a tile
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// row[m1 .. m1 + V - 1] as 16 raw bytes: one load where the V elements lie
// inside the row and are 16-byte aligned, else one at a time, 0 past n1,
// every load issued before any is packed (packing a 16-bit value as it
// lands would wait out each load's latency in turn)
template <typename T>
__device__ __forceinline__ uint4 load_group(const T* row, int m1, int n1) {
  constexpr int V = Tile<T>::V;
  using Bits = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
  const T* p = row + m1;
  if (m1 + V <= n1 && aligned16(p)) return *reinterpret_cast<const uint4*>(p);
  const Bits* pb = reinterpret_cast<const Bits*>(p);
  Bits e[V];
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = m1 + i < n1 ? pb[i] : 0;
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (V == 8)
      w[k] = e[2 * k] | static_cast<uint32_t>(e[2 * k + 1]) << 16;
    else
      w[k] = e[k];
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
interleave_epilogue_kernel(const T* __restrict__ zr,
                           const T* __restrict__ zi, float* __restrict__ out,
                           int B, int n2, int n1, float inv_n) {
  constexpr int V = Tile<T>::V;
  constexpr int kCols = Tile<T>::kCols;
  __shared__ float4 tile[kCols][kRows / 2];
  const int g = threadIdx.x & 15;  // load: columns gV ..; store: pairs 2g ..
  const int q = threadIdx.x >> 4;  // load: rows 2q, 2q + 1; store: row q ..
  const int m2_0 = blockIdx.x * kRows;
  const int m1_0 = blockIdx.y * kCols;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    // load: rows m2, m2 + 1 of zr and zi at columns m1 .. m1 + V - 1 give
    // the chunk (re, im, re, im) of each of these output rows m1
    const int m2 = m2_0 + 2 * q;
    const int m1 = m1_0 + g * V;
    if (m2 < n2 && m1 < n1) {
      uint4 raw[4];  // zr at rows m2, m2 + 1, then zi
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t off = (static_cast<size_t>(b) * n2 + m2 + r) * n1;
        const uint4 none = make_uint4(0, 0, 0, 0);
        const bool in = m2 + r < n2;
        raw[r] = in ? load_group(zr + off, m1, n1) : none;
        raw[2 + r] = in ? load_group(zi + off, m1, n1) : none;
      }
      const T* e[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) e[r] = reinterpret_cast<const T*>(&raw[r]);
#pragma unroll
      for (int i = 0; i < V; ++i)
        tile[g * V + i][q ^ (g & 7)] =
            make_float4(to_f32(e[0][i]) * inv_n, to_f32(e[2][i]) * inv_n,
                        to_f32(e[1][i]) * inv_n, to_f32(e[3][i]) * inv_n);
    }
    __syncthreads();
    // store: output row m1_0 + r, pairs m2o and m2o + 1
    const int m2o = m2_0 + 2 * g;
    float* out_b = out + 2 * static_cast<size_t>(b) * n2 * n1;
#pragma unroll
    for (int i = 0; i < kCols / (kThreads / 16); ++i) {
      const int r = q + i * (kThreads / 16);
      const int m1o = m1_0 + r;
      if (m1o >= n1 || m2o >= n2) continue;
      const float4 v = tile[r][g ^ ((r / V) & 7)];
      float* dst = out_b + static_cast<size_t>(m1o) * 2 * n2 + 2 * m2o;
      if (m2o + 1 < n2 && aligned16(dst)) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(v.x, v.y);
        if (m2o + 1 < n2)
          *reinterpret_cast<float2*>(dst + 2) = make_float2(v.z, v.w);
      }
    }
    __syncthreads();  // the tile is read before the next batch row's
  }
}

template <typename T>
cudaError_t launch(const void* zr, const void* zi, float* out, int B, int n2,
                   int n1, float inv_n, cudaStream_t s) {
  const dim3 grid((n2 + kRows - 1) / kRows,
                  (n1 + Tile<T>::kCols - 1) / Tile<T>::kCols,
                  B < kMaxGrid ? B : kMaxGrid);
  if (grid.y > kMaxGrid) return cudaErrorInvalidValue;
  interleave_epilogue_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(zr), static_cast<const T*>(zi), out, B, n2, n1,
      inv_n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype_code 0: float32, 1: bfloat16. zr, zi [B, n2, n1] of that type,
// contiguous -> out [B, n1, 2 n2] float32 (the length-2 n1 n2 signal),
// scaled by inv_n. n1 or n2 below 1, or n1 above 65535 tiles of 16 V
// columns, returns cudaErrorInvalidValue before anything is launched.
int asr_interleave_epilogue(int dtype_code, const void* zr, const void* zi,
                            void* out, int B, int n2, int n1, float inv_n,
                            void* stream) {
  if (n1 < 1 || n2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype_code == 0)
    return static_cast<int>(launch<float>(zr, zi, o, B, n2, n1, inv_n, s));
  if (dtype_code == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(zr, zi, o, B, n2, n1, inv_n, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
