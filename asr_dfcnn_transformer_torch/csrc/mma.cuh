// Tensor-core building blocks shared by the bf16 attention kernels
// (dual_attention.cu, attention.cu) and the bf16 fused FFN (ffn.cu):
// cp.async copies, ldmatrix fragments and mma.sync m16n8k16 (bf16 in, f32
// accumulate), a bf16 matrix in shared memory with its zero-block padding,
// and the score / dP / store helpers of the attention backwards. Every
// definition sits in an unnamed namespace, so each source that includes
// this header gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 16;  // rows of T and columns of C per mma tile

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ constexpr int tiles16(int n) { return (n + 15) / 16; }

// Row stride (elements) of a [rows][n] bf16 matrix in shared memory: n
// rounded up to 8, plus 8 where that leaves an even count of 16-byte
// chunks, so that the eight rows an ldmatrix reads start in eight
// different 16-byte bank groups.
__host__ __device__ constexpr int row_stride(int n, bool pad) {
  return round8(n) + (pad && (round8(n) / 8) % 2 == 0 ? 8 : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b on one 16 x 8 tile: a 16 x 16 (row), b 16 x 8 (col), bf16 in,
// f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A [rows][round8(cols)] bf16 matrix in shared memory. at() gives the
// address of the 8-element block at (r, c), c a multiple of 8, or of the
// zero block for a row or block past the stored ones: the padding of the
// mma tiles.
struct SmemMat {
  uint32_t base, zero;
  int rows, cols8, stride;
  __device__ __forceinline__ uint32_t at(int r, int c) const {
    return r < rows && c < cols8
               ? base + 2u * static_cast<uint32_t>(r * stride + c)
               : zero;
  }
};

// ldmatrix lane addresses (lane l): an A fragment of rows r0.., columns
// c0.. of a matrix stored row-major (l & 15 the row, l >> 4 the 8-column
// half); B fragments of two 8-wide n-tiles n0.. and n0+8.., k c0.., from a
// matrix stored [n][k] (non-trans) or [k][n] (trans); an A fragment of the
// transpose of a matrix stored [k][m] (trans).
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const SmemMat& m,
                                       int r0, int c0, int lane) {
  ldsm_x4(r, m.at(r0 + (lane & 15), c0 + (lane >> 4) * 8));
}
__device__ __forceinline__ void frag_b_nk(uint32_t (&r)[4], const SmemMat& m,
                                          int n0, int k0, int lane) {
  ldsm_x4(r, m.at(n0 + (lane & 7) + (lane >> 4) * 8,
                  k0 + ((lane >> 3) & 1) * 8));
}
__device__ __forceinline__ void frag_b_kn(uint32_t (&r)[4], const SmemMat& m,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(r, m.at(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                    n0 + (lane >> 4) * 8));
}
__device__ __forceinline__ void frag_a_t(uint32_t (&r)[4], const SmemMat& m,
                                         int m0, int k0, int lane) {
  ldsm_x4_t(r, m.at(k0 + (lane & 7) + (lane >> 4) * 8,
                    m0 + ((lane >> 3) & 1) * 8));
}

// Copies one row's [rows][cols] matrix from global into shared memory at
// row stride `stride`, zero-filling columns cols..round8(cols): 16-byte
// cp.async copies where `vec` (cols a multiple of 8, rows 16-byte aligned),
// else element by element.
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int rows,
                                      int cols, int stride, bool vec) {
  if (vec) {
    const int chunks = cols / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 8;
      cp_async16(smem_u32(dst + r * stride + c),
                 src + static_cast<size_t>(r) * cols + c);
    }
    return;
  }
  const int c8 = round8(cols);
  for (int i = threadIdx.x; i < rows * c8; i += blockDim.x) {
    const int r = i / c8;
    const int c = i - r * c8;
    dst[r * stride + c] = c < cols ? src[static_cast<size_t>(r) * cols + c]
                                   : __float2bfloat16_rn(0.f);
  }
}

// S = Q.K^T for the warp's 16 query rows i0.. against all keys: s[j] is
// the 16 x 8 accumulator of keys 8j..8j+7.
template <int MT, int MC>
__device__ __forceinline__ void score_tile(float (&s)[2 * MT][4],
                                           const SmemMat& q, const SmemMat& k,
                                           int i0, int nt, int nc, int lane) {
#pragma unroll
  for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < MC; ++kc) {
    if (kc >= nc) break;
    uint32_t a[4];
    frag_a(a, q, i0, kc * kTile, lane);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j >= nt) break;
      uint32_t b[4];
      frag_b_nk(b, k, j * kTile, kc * kTile, lane);
      mma16816(s[2 * j], a, b[0], b[1]);
      mma16816(s[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// The A fragment of keys 16kk.. from two 16 x 8 accumulators (rounded to
// bf16): the accumulator layout of m16n8 is the A layout of m16k16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Writes the warp's 16 x 16 MC accumulator (rows r0 + g and r0 + g + 8) to
// a row-major output of row stride ld in bf16, pairs of columns at once
// where ld is even; rows past Tn and columns past `cols` are dropped.
template <int MC>
__device__ __forceinline__ void store_tile(const float (&o)[2 * MC][4],
                                           bf16* dst, int r0, int Tn, int ld,
                                           int cols, int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int j = 0; j < 2 * MC; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    if (col >= cols) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= Tn) continue;
      bf16* p = dst + static_cast<size_t>(r) * ld + col;
      if ((ld & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(o[j][2 * h], o[j][2 * h + 1]);
      } else {
        p[0] = __float2bfloat16_rn(o[j][2 * h]);
        if (col + 1 < cols) p[1] = __float2bfloat16_rn(o[j][2 * h + 1]);
      }
    }
  }
}

// Stores a 16 x 16 bf16 A fragment (rows r0 + g, + 8; columns c0 + 2(l&3),
// + 8) into a [rows][cols8] tile in shared memory (cols8 a multiple of 8);
// what falls outside is dropped.
__device__ __forceinline__ void store_frag(bf16* tile, int stride,
                                           const uint32_t (&a)[4], int r0,
                                           int c0, int rows, int cols8,
                                           int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + (lane >> 2) + 8 * (e & 1);
    const int c = c0 + 2 * (lane & 3) + 8 * (e >> 1);
    if (r < rows && c < cols8)
      *reinterpret_cast<uint32_t*>(tile + r * stride + c) = a[e];
  }
}

// dP = dO.V^T for the warp's 16 query rows and keys 16kk.. (two 16 x 8
// accumulators), from the dO A fragments da.
template <int MC>
__device__ __forceinline__ void dp_slice(float (&dp)[2][4],
                                         const uint32_t (&da)[MC][4],
                                         const SmemMat& v, int kk, int nc,
                                         int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[h][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < MC; ++kc) {
    if (kc >= nc) break;
    uint32_t b[4];
    frag_b_nk(b, v, kk * kTile, kc * kTile, lane);
    mma16816(dp[0], da[kc], b[0], b[1]);
    mma16816(dp[1], da[kc], b[2], b[3]);
  }
}

}  // namespace
