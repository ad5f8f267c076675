// Single-head, unmasked attention per row, for the e2e pre-net's dual-axis
// blocks, for the PyTorch port.
//
// Replaces asr_dfcnn_transformer_tpu/ops/pallas/attn_kernel.py
// dual_axis_attention: its forward (_attn_packed -> _grid_call ->
// _fwd_kernel). The backward (_bwd_kernel) is not ported yet.
//
// For each row r of q, k, v [R, T, C]:
//   out[r] = softmax(q[r] . k[r]^T * scale) . v[r],  scale = 1/sqrt(C)
// Scores in f32, multiplied by the caller's f32 scale; softmax in f32 with
// the max subtracted; probabilities rounded to the input type before P.V;
// f32 accumulation; output rounded to the input type. No mask: the TPU
// kernel's block-diagonal packing of short rows (_pack_geometry,
// _slot_mask) was a device for the MXU's tile shape that changes nothing
// for real positions, and is not carried over.
//
// Bound: at the pre-net's frequency rows ([1072, 80, 64] bf16 at batch 8,
// bucket 1600) the bytes are 4 * R * T * C * 2 = 43.9 MB (13.1 us at
// 3.35 TB/s) against 1.76 GFLOP (1.8 us of bf16 tensor-core time): bound by
// bytes. The [R, T, T] f32 scores (27 MB) never leave shared memory.
// Design: one block per row; K and V of that row staged once in shared
// memory (K rows padded by one 32-bit word so lanes reading different keys
// hit different banks); each warp takes kQB query rows at a time, so a K
// or V element read from shared memory feeds kQB FMAs. For the scores the
// lanes own keys and sum over C in order; for P.V they own pairs of
// channels and sum over the keys in order, as the masked attention kernel
// does. Scalar f32 FMAs, no tensor cores: mma/wgmma tiles are later work.
// T <= 160, C <= 128; the launcher refuses larger sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "dtype.cuh"

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
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(q, k, v, out, R, T, C, scale, s);
  if (dtype_code == 0) return launch<float>(q, k, v, out, R, T, C, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
