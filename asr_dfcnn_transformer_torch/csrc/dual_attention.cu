// Single-head, unmasked attention per row, for the e2e pre-net's dual-axis
// blocks, for the PyTorch port: forward and recompute backward.
//
// Replaces asr_dfcnn_transformer_tpu/ops/pallas/attn_kernel.py
// dual_axis_attention: its forward (_attn_packed -> _grid_call ->
// _fwd_kernel) and its custom VJP (_attn_packed_bwd -> _bwd_kernel).
//
// For each row r of q, k, v [R, T, C]:
//   out[r] = softmax(q[r] . k[r]^T * scale) . v[r],  scale = 1/sqrt(C)
// Scores in f32, multiplied by the caller's f32 scale; softmax in f32 with
// the max subtracted, P = exp(s - max) / sum as a division; probabilities
// rounded to the input type before P.V; f32 accumulation; output rounded to
// the input type. No mask: the TPU kernel's block-diagonal packing of short
// rows (_pack_geometry, _slot_mask) was a device for the MXU's tile shape
// that changes nothing for real positions, and is not carried over.
//
// Backward, per row with dO the cotangent in the input type (as
// _bwd_kernel): P = exp(s - max) / sum in f32 (not the forward's softmax
// call); dP = dO.V^T in f32; dsum = sum_j dP * P over the unrounded f32 P;
// dS = (P * (dP - dsum)) * scale rounded to the input type; dQ = dS.K,
// dK = dS^T.Q, dV = P_type^T.dO, each accumulated in f32 and written in
// the input type.
//
// Bounds at the pre-net's frequency rows ([1072, 80, 64] bf16 at batch 8,
// bucket 1600): the forward moves 4 * R * T * C * 2 = 43.9 MB (13.1 us at
// 3.35 TB/s) for 4 * R * T^2 * C = 1.76 GFLOP (1.8 us of bf16 tensor-core
// time); the backward 7 * R * T * C * 2 = 76.8 MB (22.9 us) for
// 10 * R * T^2 * C = 4.39 GFLOP (4.4 us). Both are bound by bytes. The
// [R, T, T] scores (27 MB in f32) never leave the SM.
//
// bf16 (dual_attention_mma_kernel, dual_attention_bwd_mma_kernel): one
// block per row, one warp per 16-row tile of T (5 warps at T 80). K, V
// (and Q, dO in the backward) are copied into shared memory with 16-byte
// cp.async (element by element where C is not a multiple of 8), each
// matrix [T][round8(C)] with a row stride whose count of 16-byte chunks is
// odd, so that the eight rows an ldmatrix reads fall in eight different
// bank groups. Rows past T and 8-column blocks past round8(C) are never
// stored: the lanes that would address them point at one 16-byte block of
// zeros, which is how T and C are padded to the 16 x 16 tiles. The tensor
// -core products are mma.sync m16n8k16 (bf16 in, f32 accumulate) from
// ldmatrix fragments (.trans where the operand is stored the other way).
//   Forward: P must equal the plain version's bit for bit, because the
//   check holds every output within one bf16 ulp of it and one P a bf16
//   ulp off moves an output near zero by many of its ulps. The plain
//   version's scores are a sequential f32 product and the tensor cores'
//   accumulation rounds otherwise (on the card, 1344 of 5,488,640 outputs
//   then differed, 15 by more than an ulp). So the scores are f32 FMAs, each
//   summed over the channels in order, Q in f32 in shared memory read
//   broadcast and each lane owning keys lane + 32 kt; the softmax follows
//   PyTorch's warp softmax (lane sums, xor butterfly) with a correctly
//   rounded division, and P, rounded to bf16 only then, overwrites the
//   warp's own rows of Q. P.V runs on the tensor cores beside P.|V| and
//   the magnitudes of its partial sums, which bound how far the tensor
//   cores' sum can lie from a sequential one; the few outputs near zero
//   whose rounding that could move by more than an ulp are summed again
//   sequentially. The scalar scores are 0.44 G
//   FMAs at [1072, 80, 64], 0.53 G with the lanes' idle key slots (15.7 us
//   at the data sheet's 67 TFLOP/s of f32), above the 13.1 us of bytes:
//   they, not the bytes, bound this forward.
//   Backward: phase 1, one warp per 16-query tile: S, P in f32 as the
//   forward; dP = dO.V^T key tile by key tile, twice (first for dsum over
//   the unrounded P, then for dS, so that only one 16-key slice of dP is
//   live); dS and P_bf16 go to two [T][round8(T)] tiles in shared memory,
//   and dQ = dS.K takes dS's fragments from registers. Phase 2, after one
//   barrier, one warp per 16-key tile: dK = dS^T.Q and dV = P_bf16^T.dO
//   through ldmatrix.trans of the tiles. Each output element is written
//   once, with no atomics. Shared memory (asr_dual_attention_bwd_smem):
//   16 + T * (4 * stride(C) + 2 * stride(T)) * 2 bytes, 74,256 at [80, 64]
//   (3 blocks an SM); where the padded strides would exceed the card's
//   227 KB the strides drop the padding (bank conflicts, no other change),
//   so the layout takes every (T, C) the scalar layout took and more;
//   [160, 128] needs 281,616 bytes and is refused.
//   Why mma.sync and not wgmma: a row is 80 x 64; wgmma's 64-row tiles
//   would pad 80 queries to 128, and the backward is bound by bytes, not
//   by tensor-core rate.
// f32: scalar FMAs (dual_attention_kernel, dual_attention_bwd_kernel),
// because the tensor cores would round f32 inputs to TF32, which is another
// function. One block per row; K and V of that row staged once in shared
// memory (K rows padded by one 32-bit word so lanes reading different keys
// hit different banks); each warp takes kQB query rows at a time. The
// backward keeps Q, dO, K, V and the [T, T] P and dS tiles in shared memory:
// first one warp per query row, then, after one barrier, one warp per key
// row, lanes owning pairs of channels (143 KB at f32 [80, 64]; f32 [134, 64]
// needs 294,624 bytes and is refused).
// T <= 160, C <= 128; the launcher refuses larger sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kQB = 4;            // query rows a warp takes at once
constexpr int kMaxT = 160;
constexpr int kMaxC = 128;
constexpr int kMaxSmem = 232448;  // 227 KB opt-in limit of sm_90

// two neighbouring elements as f32 (bf16: one 32-bit load)
__device__ __forceinline__ float2 load2(const float* p) {
  return make_float2(p[0], p[1]);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__host__ __device__ constexpr int even(int c) { return (c + 1) / 2 * 2; }

// K row stride in elements: C rounded up to even, plus one 32-bit word.
template <typename T>
__host__ __device__ constexpr int k_stride(int c) {
  return even(c) + static_cast<int>(4 / sizeof(T));
}

template <typename T>
__host__ __device__ size_t kv_bytes(int t, int c) {
  const size_t b =
      static_cast<size_t>(t) * (k_stride<T>(c) + even(c)) * sizeof(T);
  return (b + 15) / 16 * 16;
}

// per warp: kQB query rows [even(C)] and kQB score rows [T], f32
template <typename T>
size_t smem_bytes(int t, int c) {
  return kv_bytes<T>(t, c) +
         static_cast<size_t>(kWarps) * kQB * (even(c) + t) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
dual_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int Tn,
                      int C, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ce = even(C);
  const int ks = k_stride<T>(C);
  T* kss = reinterpret_cast<T*>(smem);
  T* vss = kss + static_cast<size_t>(Tn) * ks;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qs = reinterpret_cast<float*>(smem + kv_bytes<T>(Tn, C)) +
              warp * kQB * (ce + Tn);
  float* ps = qs + kQB * ce;

  const size_t base = static_cast<size_t>(blockIdx.x) * Tn * C;
  for (int i = threadIdx.x; i < Tn * C; i += blockDim.x) {
    const int r = i / C;
    const int c = i - r * C;
    kss[r * ks + c] = k[base + i];
    vss[r * ce + c] = v[base + i];
  }
  __syncthreads();

  const int pairs = C / 2;  // channel pairs; an odd C leaves one channel
  for (int i0 = warp * kQB; i0 < Tn; i0 += kWarps * kQB) {
    const int nq = min(kQB, Tn - i0);
    // the group's query rows in f32; rows past T are zero and never written
    for (int x = lane; x < kQB * C; x += 32) {
      const int r = x / C;
      const int c = x - r * C;
      qs[r * ce + c] =
          r < nq ? to_f32(q[base + static_cast<size_t>(i0 + r) * C + c])
                 : 0.f;
    }
    __syncwarp();

    float m[kQB];
#pragma unroll
    for (int b = 0; b < kQB; ++b) m[b] = -INFINITY;
    for (int j = lane; j < Tn; j += 32) {
      const T* kr = kss + j * ks;
      float acc[kQB] = {};
      for (int p = 0; p < pairs; ++p) {
        const float2 kv = load2(kr + 2 * p);
#pragma unroll
        for (int b = 0; b < kQB; ++b) {
          const float2 qv = *reinterpret_cast<const float2*>(
              qs + b * ce + 2 * p);
          acc[b] = fmaf(qv.x, kv.x, acc[b]);
          acc[b] = fmaf(qv.y, kv.y, acc[b]);
        }
      }
      if (C & 1) {
        const float kx = to_f32(kr[C - 1]);
#pragma unroll
        for (int b = 0; b < kQB; ++b)
          acc[b] = fmaf(qs[b * ce + C - 1], kx, acc[b]);
      }
#pragma unroll
      for (int b = 0; b < kQB; ++b) {
        const float s = __fmul_rn(acc[b], scale);
        ps[b * Tn + j] = s;
        m[b] = fmaxf(m[b], s);
      }
    }
    float sum[kQB];
#pragma unroll
    for (int b = 0; b < kQB; ++b) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m[b] = fmaxf(m[b], __shfl_xor_sync(0xffffffffu, m[b], o));
      sum[b] = 0.f;
    }
    for (int j = lane; j < Tn; j += 32) {
#pragma unroll
      for (int b = 0; b < kQB; ++b) {
        const float e = expf(ps[b * Tn + j] - m[b]);
        ps[b * Tn + j] = e;
        sum[b] += e;
      }
    }
#pragma unroll
    for (int b = 0; b < kQB; ++b) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum[b] += __shfl_xor_sync(0xffffffffu, sum[b], o);
    }
    // probabilities rounded to the input type before P.V
    for (int j = lane; j < Tn; j += 32) {
#pragma unroll
      for (int b = 0; b < kQB; ++b)
        ps[b * Tn + j] = to_f32(from_f32<T>(ps[b * Tn + j] / sum[b]));
    }
    __syncwarp();

    for (int p = lane; p < (C + 1) / 2; p += 32) {
      const int d = 2 * p;
      const bool both = d + 1 < C;
      float a0[kQB] = {}, a1[kQB] = {};
      for (int j = 0; j < Tn; ++j) {
        const T* vr = vss + j * ce + d;
        const float2 vv = both ? load2(vr) : make_float2(to_f32(vr[0]), 0.f);
#pragma unroll
        for (int b = 0; b < kQB; ++b) {
          const float pj = ps[b * Tn + j];
          a0[b] = fmaf(pj, vv.x, a0[b]);
          a1[b] = fmaf(pj, vv.y, a1[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < kQB; ++b) {
        if (b >= nq) break;
        const size_t o = base + static_cast<size_t>(i0 + b) * C + d;
        out[o] = from_f32<T>(a0[b]);
        if (both) out[o + 1] = from_f32<T>(a1[b]);
      }
    }
    __syncwarp();  // qs / ps are rewritten by the next group
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int R,
           int Tn, int C, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(Tn, C);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dual_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dual_attention_kernel<T><<<R, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tn, C, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- backward

constexpr int kBwdWarps = 8;

// Reserves `bytes` at `off` (kept 16-byte aligned) and returns its offset.
__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off = (off + bytes + 15) / 16 * 16;
  return at;
}

// Shared layout of one backward block, in this order: Q and dO [T][even C]
// and K and V [T][k_stride] in T; the P_type and dS tiles [T][T] in T; per
// warp a q row and a dO row [even C] and P and dP rows [T] in f32.
template <typename T>
struct BwdLayout {
  size_t q, dout, k, v, p, ds, scratch, total;
  __host__ __device__ BwdLayout(int t, int c) {
    const size_t rows = static_cast<size_t>(t);
    const size_t ce = static_cast<size_t>(even(c));
    const size_t ks = static_cast<size_t>(k_stride<T>(c));
    size_t off = 0;
    q = take(off, rows * ce * sizeof(T));
    dout = take(off, rows * ce * sizeof(T));
    k = take(off, rows * ks * sizeof(T));
    v = take(off, rows * ks * sizeof(T));
    p = take(off, rows * rows * sizeof(T));
    ds = take(off, rows * rows * sizeof(T));
    scratch = take(off, static_cast<size_t>(kBwdWarps) * (2 * ce + 2 * rows) *
                            sizeof(float));
    total = off;
  }
};

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
dual_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          T* __restrict__ dq, T* __restrict__ dk,
                          T* __restrict__ dv, int Tn, int C, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout<T> lay(Tn, C);
  const int ce = even(C);
  const int ks = k_stride<T>(C);
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  T* dos = reinterpret_cast<T*>(smem + lay.dout);
  T* kss = reinterpret_cast<T*>(smem + lay.k);
  T* vss = reinterpret_cast<T*>(smem + lay.v);
  T* pss = reinterpret_cast<T*>(smem + lay.p);
  T* dss = reinterpret_cast<T*>(smem + lay.ds);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qrow = reinterpret_cast<float*>(smem + lay.scratch) +
                warp * (2 * ce + 2 * Tn);
  float* dorow = qrow + ce;
  float* prow = dorow + ce;
  float* dprow = prow + Tn;

  const size_t base = static_cast<size_t>(blockIdx.x) * Tn * C;
  for (int i = threadIdx.x; i < Tn * C; i += blockDim.x) {
    const int r = i / C;
    const int c = i - r * C;
    qs[r * ce + c] = q[base + i];
    dos[r * ce + c] = dout[base + i];
    kss[r * ks + c] = k[base + i];
    vss[r * ks + c] = v[base + i];
  }
  __syncthreads();

  const int pairs = C / 2;  // channel pairs; an odd C leaves one channel
  // phase 1: one warp per query row -> P, dP, dS and dQ
  for (int row = warp; row < Tn; row += kBwdWarps) {
    for (int d = lane; d < C; d += 32) {
      qrow[d] = to_f32(qs[row * ce + d]);
      dorow[d] = to_f32(dos[row * ce + d]);
    }
    __syncwarp();
    float m = -INFINITY;
    for (int j = lane; j < Tn; j += 32) {
      const T* kr = kss + j * ks;
      const T* vr = vss + j * ks;
      float acc = 0.f, dacc = 0.f;
      for (int p = 0; p < pairs; ++p) {
        const float2 qv = *reinterpret_cast<const float2*>(qrow + 2 * p);
        const float2 dov = *reinterpret_cast<const float2*>(dorow + 2 * p);
        const float2 kv = load2(kr + 2 * p);
        const float2 vv = load2(vr + 2 * p);
        acc = fmaf(qv.x, kv.x, acc);
        acc = fmaf(qv.y, kv.y, acc);
        dacc = fmaf(dov.x, vv.x, dacc);
        dacc = fmaf(dov.y, vv.y, dacc);
      }
      if (C & 1) {
        acc = fmaf(qrow[C - 1], to_f32(kr[C - 1]), acc);
        dacc = fmaf(dorow[C - 1], to_f32(vr[C - 1]), dacc);
      }
      const float s = __fmul_rn(acc, scale);
      prow[j] = s;
      dprow[j] = dacc;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < Tn; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float dsum = 0.f;
    for (int j = lane; j < Tn; j += 32) {
      const float p = prow[j] / sum;
      prow[j] = p;
      pss[row * Tn + j] = from_f32<T>(p);
      dsum = fmaf(dprow[j], p, dsum);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    for (int j = lane; j < Tn; j += 32) {
      const float g = __fmul_rn(__fmul_rn(prow[j], dprow[j] - dsum), scale);
      dss[row * Tn + j] = from_f32<T>(g);
    }
    __syncwarp();
    for (int p = lane; p < (C + 1) / 2; p += 32) {
      const int d = 2 * p;
      const bool both = d + 1 < C;
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < Tn; ++j) {
        const float g = to_f32(dss[row * Tn + j]);
        const T* kr = kss + j * ks + d;
        const float2 kv = both ? load2(kr) : make_float2(to_f32(kr[0]), 0.f);
        a0 = fmaf(g, kv.x, a0);
        a1 = fmaf(g, kv.y, a1);
      }
      const size_t o = base + static_cast<size_t>(row) * C + d;
      dq[o] = from_f32<T>(a0);
      if (both) dq[o + 1] = from_f32<T>(a1);
    }
    __syncwarp();  // the row scratch is rewritten by the next row
  }
  __syncthreads();

  // phase 2: one warp per key row -> dK = dS^T.Q, dV = P_type^T.dO
  for (int col = warp; col < Tn; col += kBwdWarps) {
    for (int p = lane; p < (C + 1) / 2; p += 32) {
      const int d = 2 * p;
      const bool both = d + 1 < C;
      float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
      for (int i = 0; i < Tn; ++i) {
        const float g = to_f32(dss[i * Tn + col]);
        const float pt = to_f32(pss[i * Tn + col]);
        const T* qr = qs + i * ce + d;
        const T* dr = dos + i * ce + d;
        const float2 qv = both ? load2(qr) : make_float2(to_f32(qr[0]), 0.f);
        const float2 dv2 = both ? load2(dr) : make_float2(to_f32(dr[0]), 0.f);
        k0 = fmaf(g, qv.x, k0);
        k1 = fmaf(g, qv.y, k1);
        v0 = fmaf(pt, dv2.x, v0);
        v1 = fmaf(pt, dv2.y, v1);
      }
      const size_t o = base + static_cast<size_t>(col) * C + d;
      dk[o] = from_f32<T>(k0);
      dv[o] = from_f32<T>(v0);
      if (both) {
        dk[o + 1] = from_f32<T>(k1);
        dv[o + 1] = from_f32<T>(v1);
      }
    }
  }
}

template <typename T>
size_t bwd_smem_bytes(int t, int c) {
  return BwdLayout<T>(t, c).total;
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, int R, int Tn, int C, float scale,
               cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T>(Tn, C);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dual_attention_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dual_attention_bwd_kernel<T><<<R, kBwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), Tn, C,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- bf16 on the tensor cores
//
// (the tensor-core helpers are mma.cuh's)

// Bytes of one row slot of the forward's Q / P region: the row of Q in f32
// (round8(C) floats) and, once its scores are done, the row of P in bf16
// (round8(T) values), rounded up to an odd count of 16-byte chunks so that
// ldmatrix reads of P rows are free of bank conflicts.
__host__ __device__ constexpr int fwd_slot_bytes(int t, int c) {
  return ((4 * round8(c) > 2 * round8(t) ? 4 * round8(c) : 2 * round8(t)) /
              32 * 32 + 16);
}

// The forward: one 16-byte block of zeros; the Q / P slots [T]; K and V
// [T][row_stride(C)] in bf16; then, per warp, a list of 32 outputs to
// recompute (uint32 each).
__host__ __device__ inline size_t mma_fwd_kv_bytes(int t, int c) {
  return static_cast<size_t>(t) * row_stride(c, true) * 2;
}
__host__ __device__ inline size_t mma_fwd_bytes(int t, int c) {
  return 16 + static_cast<size_t>(t) * fwd_slot_bytes(t, c) +
         2 * mma_fwd_kv_bytes(t, c) + static_cast<size_t>(tiles16(t)) * 128;
}

// One 16-byte block of zeros, then Q, dO, K, V [T][row_stride(C)], then
// the P_bf16 and dS tiles [T][row_stride(T)]; unpadded strides where the
// padded ones would not fit.
__host__ __device__ inline size_t mma_bwd_bytes(int t, int c, bool pad) {
  return 16 + static_cast<size_t>(t) *
                  (4 * row_stride(c, pad) + 2 * row_stride(t, pad)) * 2;
}
__host__ __device__ inline bool mma_bwd_pad(int t, int c) {
  return mma_bwd_bytes(t, c, true) <= static_cast<size_t>(kMaxSmem);
}
__host__ __device__ inline size_t mma_bwd_smem(int t, int c) {
  return mma_bwd_bytes(t, c, mma_bwd_pad(t, c));
}

// In place, s -> P = exp(s * scale - max) / sum in f32, keys past T -> 0.
// A thread holds rows g (s[j][0..1]) and g + 8 (s[j][2..3]) at keys
// 8j + 2 (lane & 3) + {0, 1}; a row's four holders are one quad.
template <int MT>
__device__ __forceinline__ void softmax_tile(float (&s)[2 * MT][4], int Tn,
                                             float scale, int lane) {
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * (lane & 3) + (e & 1);
      s[j][e] = col < Tn ? __fmul_rn(s[j][e], scale) : -INFINITY;
      m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
#pragma unroll
  for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
#pragma unroll
  for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] / sum[e >> 1];
}


// Copies one row's [rows][cols] bf16 matrix from global memory into shared
// memory as f32 at row stride `stride`, zero-filling columns
// cols..round8(cols); where `vec`, 16-byte loads, four in flight a thread.
__device__ __forceinline__ void stage_f32(float* dst, const bf16* src,
                                          int rows, int cols, int stride,
                                          bool vec) {
  if (vec) {
    const int chunks = cols / 8, n = rows * chunks;
    for (int i0 = threadIdx.x; i0 < n; i0 += 4 * blockDim.x) {
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n)
          raw[u] = __ldg(reinterpret_cast<const uint4*>(src) + i);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i >= n) break;
        const int r = i / chunks;
        const int c = (i - r * chunks) * 8;
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
        const float2 x0 = __bfloat1622float2(h[0]);
        const float2 x1 = __bfloat1622float2(h[1]);
        const float2 x2 = __bfloat1622float2(h[2]);
        const float2 x3 = __bfloat1622float2(h[3]);
        float4* d = reinterpret_cast<float4*>(dst + r * stride + c);
        d[0] = make_float4(x0.x, x0.y, x1.x, x1.y);
        d[1] = make_float4(x2.x, x2.y, x3.x, x3.y);
      }
    }
    return;
  }
  const int c8 = round8(cols);
  for (int i = threadIdx.x; i < rows * c8; i += blockDim.x) {
    const int r = i / c8;
    const int c = i - r * c8;
    dst[r * stride + c] =
        c < cols ? __bfloat162float(src[static_cast<size_t>(r) * cols + c])
                 : 0.f;
  }
}

// Recomputes the outputs listed in `list` (row << 16 | column; n <= 32, one
// a lane) as a sequential f32 matrix product sums them, keys 0..T-1 in
// order from 0, and writes them in bf16 over what store_tile wrote.
__device__ __forceinline__ void recompute_outputs(
    const uint32_t* list, int n, const bf16* ps, int st, const bf16* vss,
    int sc, bf16* out, int Tn, int C, int lane) {
  __syncwarp();
  if (lane < n) {
    const int row = static_cast<int>(list[lane] >> 16);
    const int col = static_cast<int>(list[lane] & 0xffffu);
    const bf16* pr = ps + row * st;
    const bf16* vc = vss + col;
    float acc = 0.f;
    const int whole = Tn / 8 * 8;
    uint4 praw;     // the next 8 keys' P and V, loaded ahead of the FMAs
    float vv[8];
    if (whole > 0) {
      praw = *reinterpret_cast<const uint4*>(pr);
#pragma unroll
      for (int u = 0; u < 8; ++u) vv[u] = __bfloat162float(vc[u * sc]);
    }
    for (int j = 0; j < whole; j += 8) {
      const uint4 pcur = praw;
      float vcur[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) vcur[u] = vv[u];
      if (j + 8 < whole) {
        praw = *reinterpret_cast<const uint4*>(pr + j + 8);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          vv[u] = __bfloat162float(vc[(j + 8 + u) * sc]);
      }
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&pcur);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 pp = __bfloat1622float2(h[u]);
        acc = fmaf(pp.x, vcur[2 * u], acc);
        acc = fmaf(pp.y, vcur[2 * u + 1], acc);
      }
    }
    for (int j = whole; j < Tn; ++j)
      acc = fmaf(__bfloat162float(pr[j]), __bfloat162float(vc[j * sc]), acc);
    out[static_cast<size_t>(row) * C + col] = __float2bfloat16_rn(acc);
  }
  __syncwarp();
}

// The forward. Scores by f32 FMAs, each summed over c = 0..C-1 in order,
// then the f32 scale: the products of bf16 values are exact, so these are
// the scores of a sequential f32 matrix product, bit for bit, which the
// tensor cores' accumulation is not; then the softmax in the order of
// PyTorch's warp softmax (lane l sums keys l, l + 32, ... from 0, then the
// xor butterfly 16, 8, 4, 2, 1), max subtracted, exp, division, and only
// then the rounding of P to bf16. P bit for bit is what holds each output
// within one bf16 ulp of the plain version: one P a bf16 ulp off moves an
// output near zero by many of its ulps. P.V then runs on the tensor cores,
// and beside it P.|V| (V's sign bits cleared) and X = P.|V| + the sum of
// |P.V| before each 16-key step, which bound how far the tensor cores' sum
// and a sequential f32 sum can lie apart. The sequential sum's error is at
// most 2^-24 times the sum of its T partial sums' magnitudes (Higham), each
// at most the partial at its 16-key step plus that step's share of P.|V|:
// 2^-20 X in all; an mma step that truncates each of its 17 aligned terms
// by an ulp errs by at most 17 2^-23 times its largest, 2.125 2^-20 X in
// all. An output whose bf16 rounding the gap could move by more than one
// bf16 ulp (|O| at most 2^-8 X: 2^9 times the bound, with a margin of
// 2.5) is recomputed as a sequential f32 sum, one output a lane.
// A warp takes 16 query rows: lanes own keys lane + 32 kt (kt < KT); each
// step reads 8 bf16 channels of its KT keys and, broadcast, two float4 of
// each of the 16 rows of Q, kept in f32 (384 FMAs for 35 loads and 24
// conversions at KT 3). MC: the most 16-column tiles of C the instance
// takes.
// Scores of 8 query rows r0.. against the lane's KT keys (lane + 32 kt),
// each summed over c = 0..C-1 in order: CW bf16 channels of the keys and,
// broadcast, CW / 4 float4 of each row of Q a step (192 FMAs for 19 loads
// and 24 conversions at KT 3, CW 8).
template <int KT, int CW>
__device__ __forceinline__ void score_rows(float (&acc)[8][KT],
                                           const float* qf, int qs,
                                           const bf16* const (&krow)[KT],
                                           int r0, int Tn, int C) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) acc[r][kt] = 0.f;
  for (int c = 0; c < C; c += CW) {
    float kv[KT][CW];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t w[4];  // one 8- or 16-byte load
      if constexpr (CW == 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow[kt] + c);
        w[0] = raw.x, w[1] = raw.y, w[2] = raw.z, w[3] = raw.w;
      } else {
        const uint2 raw = *reinterpret_cast<const uint2*>(krow[kt] + c);
        w[0] = raw.x, w[1] = raw.y;
      }
#pragma unroll
      for (int u = 0; u < CW / 2; ++u) {  // bf16 -> f32: the high halves
        kv[kt][2 * u] = __uint_as_float(w[u] << 16);
        kv[kt][2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {  // rows past T repeat row T-1, unstored
      const float* qr = qf + min(r0 + r, Tn - 1) * qs + c;
#pragma unroll
      for (int w = 0; w < CW / 4; ++w) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + 4 * w);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          acc[r][kt] = fmaf(qv.x, kv[kt][4 * w], acc[r][kt]);
          acc[r][kt] = fmaf(qv.y, kv[kt][4 * w + 1], acc[r][kt]);
          acc[r][kt] = fmaf(qv.z, kv[kt][4 * w + 2], acc[r][kt]);
          acc[r][kt] = fmaf(qv.w, kv[kt][4 * w + 3], acc[r][kt]);
        }
      }
    }
  }
}

// In place, the scores of 8 rows -> P = exp(s * scale - max) / sum in f32
// in the order of PyTorch's warp softmax; keys past T -> 0. Each step runs
// over the 8 rows before the next, so that their shuffles overlap.
template <int KT>
__device__ __forceinline__ void softmax_rows(float (&acc)[8][KT], int Tn,
                                             float scale, int lane) {
  float m[8], sum[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -INFINITY;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      acc[r][kt] = lane + 32 * kt < Tn ? __fmul_rn(acc[r][kt], scale)
                                       : -INFINITY;
      m[r] = fmaxf(m[r], acc[r][kt]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < 8; ++r)
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    sum[r] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      acc[r][kt] = expf(acc[r][kt] - m[r]);
      sum[r] += acc[r][kt];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < 8; ++r)
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
  // e / sum correctly rounded, as the division: with y = 1/sum correctly
  // rounded, q = e y, then q + (e - q sum) y (Markstein) is the rounded
  // quotient for every quotient in the normal range, and 0 for e = 0 (the
  // keys past T); for 0 < e < 2^-100, the division itself
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float y = __frcp_rn(sum[r]);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const float e = acc[r][kt];
      const float q0 = __fmul_rn(e, y);
      acc[r][kt] = __fmaf_rn(__fmaf_rn(-q0, sum[r], e), y, q0);
      if (e < 0x1p-100f && e > 0.f) acc[r][kt] = e / sum[r];
    }
  }
}

// KT: key slots a lane (3: T <= 80, five warps; 5: T <= 160, ten warps).
// The scores go 8 rows at a time and P.V 32 channels at a time, so that
// four blocks of five warps (two of ten) fit an SM's registers.
template <int KT>
__global__ void __launch_bounds__(KT == 3 ? 160 : 320, KT == 3 ? 4 : 2)
dual_attention_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          int Tn, int C, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = fwd_slot_bytes(Tn, C);
  const int qs = slot / 4, pst = slot / 2;  // Q (f32) and P (bf16) strides
  const int sc = row_stride(C, true);
  const int nt = tiles16(Tn), nc = tiles16(C);
  float* qf = reinterpret_cast<float*>(smem + 16);
  bf16* ps = reinterpret_cast<bf16*>(qf);  // row i over Q's row i
  bf16* kss =
      reinterpret_cast<bf16*>(smem + 16 + static_cast<size_t>(Tn) * slot);
  bf16* vss = kss + Tn * sc;
  uint32_t* list = reinterpret_cast<uint32_t*>(vss + Tn * sc) +
                   (threadIdx.x >> 5) * 32;
  const size_t base = static_cast<size_t>(blockIdx.x) * Tn * C;
  stage(kss, k + base, Tn, C, sc, vec);
  cp_async_commit();
  stage(vss, v + base, Tn, C, sc, vec);  // in flight while S is computed
  cp_async_commit();
  stage_f32(qf, q + base, Tn, C, qs, vec);
  if (threadIdx.x == 0)
    *reinterpret_cast<uint4*>(smem) = make_uint4(0, 0, 0, 0);
  cp_async_wait<1>();
  __syncthreads();

  // A warp's 16 query rows, 8 at a time; only this warp reads them, so
  // each 8 rows' P overwrites their Q as soon as their scores are done.
  const int lane = threadIdx.x & 31;
  const int i0 = (threadIdx.x >> 5) * kTile;
  const int t8 = round8(Tn);
  const bf16* krow[KT];  // keys past T read row T-1 and are masked
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    krow[kt] = kss + min(lane + 32 * kt, Tn - 1) * sc;
#pragma unroll 1
  for (int r0 = i0; r0 < i0 + kTile && r0 < Tn; r0 += 8) {
    float acc[8][KT];
    score_rows<KT, KT == 3 ? 8 : 4>(acc, qf, qs, krow, r0, Tn, C);
    softmax_rows<KT>(acc, Tn, scale, lane);
    __syncwarp();  // every lane is done with these rows of Q
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r0 + r >= Tn) break;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const int j = lane + 32 * kt;
        if (j < t8) ps[(r0 + r) * pst + j] = __float2bfloat16_rn(acc[r][kt]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // V is in, and every P row is written

  const uint32_t zero = smem_u32(smem);
  const SmemMat tp{smem_u32(ps), zero, Tn, t8, pst};
  const SmemMat tv{smem_u32(vss), zero, Tn, round8(C), sc};
  int n = 0;  // outputs queued for the sequential sum
#pragma unroll 1
  for (int c0 = 0; c0 < nc; c0 += 2) {  // 32 channels at a time
    // P.V, P.|V| and the sum of |P.V| before each 16-key step
    float o[4][4], bound[4][4], part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = bound[j][e] = part[j][e] = 0.f;
    for (int kk = 0; kk < nt; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] += fabsf(o[j][e]);
      uint32_t a[4];
      frag_a(a, tp, i0, kk * kTile, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (c0 + h >= nc) break;
        uint32_t b[4];
        frag_b_kn(b, tv, kk * kTile, (c0 + h) * kTile, lane);
        mma16816(o[2 * h], a, b[0], b[1]);
        mma16816(o[2 * h + 1], a, b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] &= 0x7fff7fffu;
        mma16816(bound[2 * h], a, b[0], b[1]);
        mma16816(bound[2 * h + 1], a, b[2], b[3]);
      }
    }
    store_tile<2>(o, out + base + c0 * kTile, i0, Tn, C, C - c0 * kTile,
                  lane);
    // the outputs near zero, sequentially, 32 at a time
    uint32_t redo = 0;  // bit 4 j + e: o[j][e]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i0 + (lane >> 2) + 8 * (e >> 1);
        const int col = c0 * kTile + j * 8 + 2 * (lane & 3) + (e & 1);
        if (row < Tn && col < C &&
            fabsf(o[j][e]) <= 0x1p-8f * (part[j][e] + bound[j][e]))
          redo |= 1u << (4 * j + e);
      }
#pragma unroll 1
    for (int b = 0; b < 16; ++b) {
      const bool mine = (redo >> b) & 1u;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (m == 0) continue;
      if (n + __popc(m) > 32) {
        recompute_outputs(list, n, ps, pst, vss, sc, out + base, Tn, C,
                          lane);
        n = 0;
      }
      if (mine) {
        const int row = i0 + (lane >> 2) + 8 * ((b & 3) >> 1);
        const int col = c0 * kTile + (b >> 2) * 8 + 2 * (lane & 3) + (b & 1);
        list[n + __popc(m & ((1u << lane) - 1u))] =
            static_cast<uint32_t>(row) << 16 | static_cast<uint32_t>(col);
      }
      n += __popc(m);
    }
  }
  recompute_outputs(list, n, ps, pst, vss, sc, out + base, Tn, C, lane);
}

// The backward. MT: the most 16-row tiles of T, MC: the most 16-column
// tiles of C the instance takes (5 and 4 fit [80, 64] exactly).
template <int MT, int MC>
__global__ void __launch_bounds__(MT * 32)
dual_attention_bwd_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              bf16* __restrict__ dq, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, int Tn, int C,
                              float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool pad = mma_bwd_pad(Tn, C);
  const int sc = row_stride(C, pad), st = row_stride(Tn, pad);
  const int nt = tiles16(Tn), nc = tiles16(C);
  bf16* qs = reinterpret_cast<bf16*>(smem + 16);
  bf16* dos = qs + Tn * sc;
  bf16* kss = dos + Tn * sc;
  bf16* vss = kss + Tn * sc;
  bf16* pss = vss + Tn * sc;
  bf16* dss = pss + Tn * st;
  const size_t base = static_cast<size_t>(blockIdx.x) * Tn * C;
  stage(qs, q + base, Tn, C, sc, vec);
  stage(kss, k + base, Tn, C, sc, vec);
  cp_async_commit();
  stage(vss, v + base, Tn, C, sc, vec);
  stage(dos, dout + base, Tn, C, sc, vec);
  cp_async_commit();
  if (threadIdx.x == 0)
    *reinterpret_cast<uint4*>(smem) = make_uint4(0, 0, 0, 0);
  cp_async_wait<1>();
  __syncthreads();

  const uint32_t zero = smem_u32(smem);
  const SmemMat tq{smem_u32(qs), zero, Tn, round8(C), sc};
  const SmemMat tdo{smem_u32(dos), zero, Tn, round8(C), sc};
  const SmemMat tk{smem_u32(kss), zero, Tn, round8(C), sc};
  const SmemMat tv{smem_u32(vss), zero, Tn, round8(C), sc};
  const SmemMat tp{smem_u32(pss), zero, Tn, round8(Tn), st};
  const SmemMat tds{smem_u32(dss), zero, Tn, round8(Tn), st};
  const int lane = threadIdx.x & 31;
  const int i0 = (threadIdx.x >> 5) * kTile;  // phase 1 queries, 2 keys

  // phase 1: one warp per 16 query rows -> P, dS tiles and dQ
  float s[2 * MT][4];
  score_tile<MT, MC>(s, tq, tk, i0, nt, nc, lane);
  softmax_tile<MT>(s, Tn, scale, lane);  // f32 P, kept unrounded
#pragma unroll
  for (int kk = 0; kk < MT; ++kk) {
    if (kk >= nt) break;
    uint32_t pa[4];
    acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
    store_frag(pss, st, pa, i0, kk * kTile, Tn, round8(Tn), lane);
  }
  cp_async_wait<0>();
  __syncthreads();

  uint32_t da[MC][4];  // the warp's dO rows as A fragments
#pragma unroll
  for (int kc = 0; kc < MC; ++kc)
    if (kc < nc) frag_a(da[kc], tdo, i0, kc * kTile, lane);

  float dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < MT; ++kk) {
    if (kk >= nt) break;
    float dp[2][4];
    dp_slice<MC>(dp, da, tv, kk, nc, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dsum[e >> 1] = fmaf(dp[h][e], s[2 * kk + h][e], dsum[e >> 1]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 1);
    dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 2);
  }

  float acc[2 * MC][4];
#pragma unroll
  for (int j = 0; j < 2 * MC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < MT; ++kk) {
    if (kk >= nt) break;
    float dp[2][4];
    dp_slice<MC>(dp, da, tv, kk, nc, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[h][e] = __fmul_rn(
            __fmul_rn(s[2 * kk + h][e], dp[h][e] - dsum[e >> 1]), scale);
    uint32_t dsa[4];
    acc_to_a(dsa, dp[0], dp[1]);
    store_frag(dss, st, dsa, i0, kk * kTile, Tn, round8(Tn), lane);
#pragma unroll
    for (int cc = 0; cc < MC; ++cc) {
      if (cc >= nc) break;
      uint32_t b[4];
      frag_b_kn(b, tk, kk * kTile, cc * kTile, lane);
      mma16816(acc[2 * cc], dsa, b[0], b[1]);
      mma16816(acc[2 * cc + 1], dsa, b[2], b[3]);
    }
  }
  store_tile<MC>(acc, dq + base, i0, Tn, C, C, lane);
  __syncthreads();

  // phase 2: one warp per 16 key rows i0.. -> dK = dS^T.Q, dV = P^T.dO
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const SmemMat& tile = which == 0 ? tds : tp;
    const SmemMat& rhs = which == 0 ? tq : tdo;
#pragma unroll
    for (int j = 0; j < 2 * MC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int qq = 0; qq < MT; ++qq) {
      if (qq >= nt) break;
      uint32_t a[4];
      frag_a_t(a, tile, i0, qq * kTile, lane);
#pragma unroll
      for (int cc = 0; cc < MC; ++cc) {
        if (cc >= nc) break;
        uint32_t b[4];
        frag_b_kn(b, rhs, qq * kTile, cc * kTile, lane);
        mma16816(acc[2 * cc], a, b[0], b[1]);
        mma16816(acc[2 * cc + 1], a, b[2], b[3]);
      }
    }
    store_tile<MC>(acc, (which == 0 ? dk : dv) + base, i0, Tn, C, C, lane);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename Kernel>
int opt_in_smem(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= 48 * 1024) return static_cast<int>(cudaSuccess);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int KT>
int launch_mma(const void* q, const void* k, const void* v, void* out, int R,
               int Tn, int C, float scale, cudaStream_t stream) {
  const size_t smem = mma_fwd_bytes(Tn, C);
  const int err = opt_in_smem(dual_attention_mma_kernel<KT>, smem);
  if (err != static_cast<int>(cudaSuccess)) return err;
  const int vec = C % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  dual_attention_mma_kernel<KT><<<R, 32 * tiles16(Tn), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Tn, C, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, int MC>
int launch_bwd_mma(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv, int R,
                   int Tn, int C, float scale, cudaStream_t stream) {
  const size_t smem = mma_bwd_smem(Tn, C);
  const int err = opt_in_smem(dual_attention_bwd_mma_kernel<MT, MC>, smem);
  if (err != static_cast<int>(cudaSuccess)) return err;
  const int vec = C % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout);
  dual_attention_bwd_mma_kernel<MT, MC>
      <<<R, 32 * tiles16(Tn), smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<bf16*>(dq), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), Tn, C, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// The instance for T: keys in 3 or 5 slots a lane (T <= 80 or 160).
int launch_bf16(const void* q, const void* k, const void* v, void* out, int R,
                int Tn, int C, float scale, cudaStream_t s) {
  return Tn <= 80 ? launch_mma<3>(q, k, v, out, R, Tn, C, scale, s)
                  : launch_mma<5>(q, k, v, out, R, Tn, C, scale, s);
}

// The backward's instance: up to 5 or 10 16-row tiles of T, 4 or 8 of C.

int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* dout, void* dq, void* dk, void* dv, int R,
                    int Tn, int C, float scale, cudaStream_t s) {
  if (Tn <= 80)
    return C <= 64 ? launch_bwd_mma<5, 4>(q, k, v, dout, dq, dk, dv, R, Tn,
                                          C, scale, s)
                   : launch_bwd_mma<5, 8>(q, k, v, dout, dq, dk, dv, R, Tn,
                                          C, scale, s);
  return C <= 64 ? launch_bwd_mma<10, 4>(q, k, v, dout, dq, dk, dv, R, Tn, C,
                                         scale, s)
                 : launch_bwd_mma<10, 8>(q, k, v, dout, dq, dk, dv, R, Tn, C,
                                         scale, s);
}

}  // namespace

extern "C" {

// dtype_code 0: float32, 1: bfloat16. q, k, v, out [R, T, C] contiguous;
// scale is 1/sqrt(C) as the caller rounds it. 1 <= T <= 160, 1 <= C <= 128.
int asr_dual_attention(int dtype_code, const void* q, const void* k,
                       const void* v, void* out, int R, int T, int C,
                       float scale, void* stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  if (T < 1 || T > kMaxT || C < 1 || C > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1) return launch_bf16(q, k, v, out, R, T, C, scale, s);
  if (dtype_code == 0) return launch<float>(q, k, v, out, R, T, C, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory one backward launch needs at [., T, C].
long long asr_dual_attention_bwd_smem(int dtype_code, int T, int C) {
  return static_cast<long long>(dtype_code == 1 ? mma_bwd_smem(T, C)
                                                : bwd_smem_bytes<float>(T, C));
}

// The backward: q, k, v and the cotangent dout [R, T, C] contiguous, in one
// dtype -> dq, dk, dv [R, T, C] in it. Sizes as the forward's; the launcher
// refuses a (T, C) whose layout exceeds the card's shared memory.
int asr_dual_attention_bwd(int dtype_code, const void* q, const void* k,
                           const void* v, const void* dout, void* dq, void* dk,
                           void* dv, int R, int T, int C, float scale,
                           void* stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  if (T < 1 || T > kMaxT || C < 1 || C > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch_bwd_bf16(q, k, v, dout, dq, dk, dv, R, T, C, scale, s);
  if (dtype_code == 0)
    return launch_bwd<float>(q, k, v, dout, dq, dk, dv, R, T, C, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
