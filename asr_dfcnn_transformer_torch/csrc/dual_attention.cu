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
//
// Backward, per row with dO the cotangent in the input type (as
// _bwd_kernel): P = exp(s - max) / sum in f32 (not the forward's softmax
// call); dP = dO.V^T in f32; dsum = sum_j dP * P over the unrounded f32 P;
// dS = P * (dP - dsum) * scale rounded to the input type; dQ = dS.K,
// dK = dS^T.Q, dV = P_type^T.dO, each accumulated in f32 and written in
// the input type.
// Bound: at [1072, 80, 64] bf16 it reads q, k, v, dO and writes dq, dk, dv,
// 7 * R * T * C * 2 = 76.8 MB (22.9 us at 3.35 TB/s), against
// 10 * R * T^2 * C = 4.39 GFLOP (4.4 us of bf16 tensor-core time): bound by
// bytes. Design, as the masked attention backward: one block per row with
// Q, dO, K and V staged in shared memory (K and V rows padded by one 32-bit
// word), and the [T, T] tiles of P_type and dS kept there in the input type
// (both are rounded to it, so storing them so loses nothing and halves the
// bf16 tiles); first one warp per query row (scores, P, dP, dsum, dS, dQ),
// then, after one barrier, one warp per key row (dK, dV), lanes owning
// pairs of channels. Every output element is written once by one lane: no
// atomics, each sum in a fixed order. Shared memory bounds T and C (154 KB
// at bf16 [134, 64], 143 KB at f32 [80, 64]; f32 [134, 64] needs 294,624
// bytes and is refused); asr_dual_attention_bwd_smem gives the layout's
// size, which the wrapper mirrors to refuse a size at forward time.

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

// Shared memory one backward launch needs at [., T, C].
long long asr_dual_attention_bwd_smem(int dtype_code, int T, int C) {
  return static_cast<long long>(dtype_code == 1
                                    ? bwd_smem_bytes<__nv_bfloat16>(T, C)
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
    return launch_bwd<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, R, T, C,
                                     scale, s);
  if (dtype_code == 0)
    return launch_bwd<float>(q, k, v, dout, dq, dk, dv, R, T, C, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
