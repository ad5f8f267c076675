// Masked multi-head attention, forward and backward, for the PyTorch port.
//
// Replaces asr_dfcnn_transformer_tpu/ops/pallas/attn_kernel.py
// masked_flash_attention: the forward (_mflash_run_fwd / _mflash_fwd_kernel,
// with and without dropout) and the recompute backward (_mflash_run_bwd /
// _mflash_bwd_kernel, with and without dropout).
//
// Forward:
//   out = softmax(q.k^T * 1/sqrt(Dh) + m) . v,  m = 0 for an allowed key,
//   -1e9 for a key that is invalid or (causal) in the future (col <= row,
//   jnp.tril over [Tq, Tk]). Scores and softmax in f32; probabilities are
//   rounded to the input type before P.V; f32 accumulation; output in q's
//   type. The -1e9 is additive, never -inf and never a skip, so a query
//   row whose keys are all invalid gets a uniform softmax over the Tk real
//   keys, exactly as models/layers.py attention_mask gives it. With a keep
//   mask [B, H, Tq, Tk] (dropout), the rounded probabilities become
//   (p / keep_prob) * mask in the input type before P.V, flax Dropout's
//   semantics as _mflash_fwd_kernel applies them; a null mask leaves the
//   path without dropout exactly as it was.
//
// Forward bound: at the LM's shape ([B, 8, 100, 64] bf16) the whole problem is a
// few hundred KB, so the kernel is bound by latency and instruction issue,
// not by bytes or tensor-core FLOPs. Design: one block per (b*h, 16-query
// tile) with K and V for that (b, h) staged once in shared memory (K rows
// padded by one 32-bit word so lanes reading different keys hit different
// banks), one warp per query row: lanes own keys for the scores and the
// softmax (warp shuffles for max and sum), then own head dims for P.V.
// The [Tq, Tk] score matrix never leaves shared memory. The TPU version's
// block-diagonal row packing was an MXU-shape device and is dropped. Tk is
// limited by shared memory (raises above it); Dh <= 128. Tensor-core
// (mma/wgmma) tiles are later work.
//
// Backward (recompute VJP, as _mflash_bwd_kernel): P = exp(s - max) / sum
// in f32 (not the forward's softmax call); dP = dO.V^T; with dropout
// dP *= mask / keep_prob and dropped = (P_type / keep) * mask, else
// dropped = P_type; dsum = sum(dP * P) over the undropped f32 P;
// dS = P * (dP - dsum) * scale rounded to the input type; dQ = dS.K,
// dK = dS^T.Q, dV = dropped^T.dO, all accumulated in f32.
// Bound: at the LM's training shape ([64, 8, 64, 64]) the problem is again
// a few MB, so it is latency- and issue-bound. Design: one block per (b, h)
// with Q, K, V and dO staged in shared memory (K and V rows padded by one
// word), and the [Tq, Tk] f32 tiles of the dropped probabilities and of dS
// kept in shared memory too; first one warp per query row (scores, P, dP,
// dS, dQ), then, after one barrier, one warp per key row (dK, dV). Every
// output element is written once by one lane: no atomics. The -1e9 stays
// additive, so a fully invalid query row's gradient is the einsum path's.
// Tk and Dh are bounded by shared memory (about 190 KB at f32, T = 100,
// Dh = 64); the wrapper raises above it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "dtype.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerBlock = 16;
constexpr int kMaxSmem = 232448;  // 227 KB opt-in limit of sm_90
constexpr float kBigNeg = -1e9f;

// K row stride in elements: Dh plus one 32-bit word of padding.
template <typename T>
__host__ __device__ constexpr int k_stride(int dh) {
  return dh + static_cast<int>(4 / sizeof(T));
}

template <typename T>
size_t smem_bytes(int tk, int dh) {
  size_t kv = static_cast<size_t>(tk) * (k_stride<T>(dh) + dh) * sizeof(T);
  kv = (kv + 15) / 16 * 16;
  return kv + static_cast<size_t>(kWarps) * (dh + tk) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const unsigned char* __restrict__ k_valid,
                        const unsigned char* __restrict__ keep,
                        float keep_prob, T* __restrict__ out, int H, int Tq,
                        int Tk, int Dh, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks_stride = k_stride<T>(Dh);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + static_cast<size_t>(Tk) * ks_stride;
  size_t kv_bytes =
      static_cast<size_t>(Tk) * (ks_stride + Dh) * sizeof(T);
  kv_bytes = (kv_bytes + 15) / 16 * 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qs = reinterpret_cast<float*>(smem + kv_bytes) + warp * (Dh + Tk);
  float* ps = qs + Dh;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const size_t kv_off = static_cast<size_t>(bh) * Tk * Dh;
  for (int i = threadIdx.x; i < Tk * Dh; i += blockDim.x) {
    const int r = i / Dh;
    const int c = i - r * Dh;
    ks[r * ks_stride + c] = k[kv_off + i];
    vs[i] = v[kv_off + i];
  }
  __syncthreads();

  const unsigned char* valid_row =
      k_valid + static_cast<size_t>(b) * Tk;
  const int row0 = static_cast<int>(blockIdx.y) * kRowsPerBlock;
  const int row_end = min(Tq, row0 + kRowsPerBlock);
  for (int row = row0 + warp; row < row_end;
       row += kWarps) {
    const size_t q_off = (static_cast<size_t>(bh) * Tq + row) * Dh;
    for (int d = lane; d < Dh; d += 32) qs[d] = to_f32(q[q_off + d]);
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < Tk; j += 32) {
      const T* kr = ks + j * ks_stride;
      float acc = 0.f;
      for (int d = 0; d < Dh; ++d) acc = fmaf(qs[d], to_f32(kr[d]), acc);
      const bool ok = valid_row[j] != 0 && (!causal || j <= row);
      // no contraction: the score is rounded before the mask is added
      const float s = __fadd_rn(__fmul_rn(acc, scale), ok ? 0.f : kBigNeg);
      ps[j] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

    float sum = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float e = expf(ps[j] - m);
      ps[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    // probabilities rounded to the input type before P.V
    for (int j = lane; j < Tk; j += 32)
      ps[j] = to_f32(from_f32<T>(ps[j] / sum));
    if (keep != nullptr) {
      // dropout: (p / keep_prob) * mask in the input type
      const float kp = to_f32(from_f32<T>(keep_prob));
      const unsigned char* keep_row =
          keep + (static_cast<size_t>(bh) * Tq + row) * Tk;
      for (int j = lane; j < Tk; j += 32)
        ps[j] = keep_row[j] ? to_f32(from_f32<T>(ps[j] / kp)) : 0.f;
    }
    __syncwarp();

    for (int d = lane; d < Dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Tk; ++j)
        acc = fmaf(ps[j], to_f32(vs[static_cast<size_t>(j) * Dh + d]), acc);
      out[q_off + d] = from_f32<T>(acc);
    }
    __syncwarp();  // qs / ps are rewritten by the next row
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* k_valid,
           const void* keep, float keep_prob, void* out, int B, int H, int Tq,
           int Tk, int Dh, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(Tk, Dh);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (Tq + kRowsPerBlock - 1) / kRowsPerBlock);
  masked_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(k_valid),
      static_cast<const unsigned char*>(keep), keep_prob,
      static_cast<T*>(out), H, Tq, Tk, Dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- backward

constexpr int kBwdWarps = 8;

// Shared layout of one backward block, in this order: Q [Tq][Dh] and dO
// [Tq][Dh] in T; K and V [Tk][k_stride] in T; the dropped probabilities
// and dS [Tq][Tk] f32; per warp a q row, a dO row, P and dP rows (f32).
// Reserves `bytes` at `off` (kept 16-byte aligned) and returns its offset.
__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off = (off + bytes + 15) / 16 * 16;
  return at;
}

template <typename T>
struct BwdLayout {
  size_t q, dout, k, v, pd, ds, scratch, total;
  __host__ __device__ BwdLayout(int tq, int tk, int dh) {
    const size_t ks = static_cast<size_t>(k_stride<T>(dh));
    size_t off = 0;
    q = take(off, static_cast<size_t>(tq) * dh * sizeof(T));
    dout = take(off, static_cast<size_t>(tq) * dh * sizeof(T));
    k = take(off, static_cast<size_t>(tk) * ks * sizeof(T));
    v = take(off, static_cast<size_t>(tk) * ks * sizeof(T));
    pd = take(off, static_cast<size_t>(tq) * tk * sizeof(float));
    ds = take(off, static_cast<size_t>(tq) * tk * sizeof(float));
    scratch = take(off, static_cast<size_t>(kBwdWarps) * (2 * dh + 2 * tk) *
                            sizeof(float));
    total = off;
  }
};

template <typename T>
size_t bwd_smem_bytes(int tq, int tk, int dh) {
  return BwdLayout<T>(tq, tk, dh).total;
}

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
masked_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const unsigned char* __restrict__ k_valid,
                            const unsigned char* __restrict__ keep,
                            float keep_prob, const T* __restrict__ dout,
                            T* __restrict__ dq, T* __restrict__ dk,
                            T* __restrict__ dv, int H, int Tq, int Tk, int Dh,
                            float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout<T> lay(Tq, Tk, Dh);
  const int ks_stride = k_stride<T>(Dh);
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  T* dos = reinterpret_cast<T*>(smem + lay.dout);
  T* ks = reinterpret_cast<T*>(smem + lay.k);
  T* vs = reinterpret_cast<T*>(smem + lay.v);
  float* pds = reinterpret_cast<float*>(smem + lay.pd);
  float* dss = reinterpret_cast<float*>(smem + lay.ds);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qrow = reinterpret_cast<float*>(smem + lay.scratch) +
                warp * (2 * Dh + 2 * Tk);
  float* dorow = qrow + Dh;
  float* prow = dorow + Dh;
  float* dprow = prow + Tk;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const size_t q_off = static_cast<size_t>(bh) * Tq * Dh;
  const size_t kv_off = static_cast<size_t>(bh) * Tk * Dh;
  for (int i = threadIdx.x; i < Tq * Dh; i += blockDim.x) {
    qs[i] = q[q_off + i];
    dos[i] = dout[q_off + i];
  }
  for (int i = threadIdx.x; i < Tk * Dh; i += blockDim.x) {
    const int r = i / Dh;
    const int c = i - r * Dh;
    ks[r * ks_stride + c] = k[kv_off + i];
    vs[r * ks_stride + c] = v[kv_off + i];
  }
  __syncthreads();

  const unsigned char* valid_row = k_valid + static_cast<size_t>(b) * Tk;
  const float kp_t = to_f32(from_f32<T>(keep_prob));  // keep in the type
  // phase 1: one warp per query row -> P, dP, dS and dQ
  for (int row = warp; row < Tq; row += kBwdWarps) {
    for (int d = lane; d < Dh; d += 32) {
      qrow[d] = to_f32(qs[row * Dh + d]);
      dorow[d] = to_f32(dos[row * Dh + d]);
    }
    __syncwarp();
    float m = -INFINITY;
    for (int j = lane; j < Tk; j += 32) {
      const T* kr = ks + j * ks_stride;
      const T* vr = vs + j * ks_stride;
      float acc = 0.f, dacc = 0.f;
      for (int d = 0; d < Dh; ++d) {
        acc = fmaf(qrow[d], to_f32(kr[d]), acc);
        dacc = fmaf(dorow[d], to_f32(vr[d]), dacc);
      }
      const bool ok = valid_row[j] != 0 && (!causal || j <= row);
      const float s = __fadd_rn(__fmul_rn(acc, scale), ok ? 0.f : kBigNeg);
      prow[j] = s;
      dprow[j] = dacc;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const unsigned char* keep_row =
        keep == nullptr ? nullptr
                        : keep + (static_cast<size_t>(bh) * Tq + row) * Tk;
    float dsum = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float p = prow[j] / sum;
      const float p_t = to_f32(from_f32<T>(p));
      float dp = dprow[j];
      float dropped = p_t;
      if (keep_row != nullptr) {
        const float mk = keep_row[j] ? 1.f : 0.f;
        dropped = to_f32(from_f32<T>(p_t / kp_t)) * mk;
        dp = __fmul_rn(dp, mk / keep_prob);
      }
      prow[j] = p;
      dprow[j] = dp;
      pds[row * Tk + j] = dropped;
      dsum = fmaf(dp, p, dsum);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    for (int j = lane; j < Tk; j += 32) {
      const float g = __fmul_rn(__fmul_rn(prow[j], dprow[j] - dsum), scale);
      dss[row * Tk + j] = to_f32(from_f32<T>(g));
    }
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Tk; ++j)
        acc = fmaf(dss[row * Tk + j], to_f32(ks[j * ks_stride + d]), acc);
      dq[q_off + static_cast<size_t>(row) * Dh + d] = from_f32<T>(acc);
    }
    __syncwarp();  // the row scratch is rewritten by the next row
  }
  __syncthreads();

  // phase 2: one warp per key row -> dK = dS^T.Q, dV = dropped^T.dO
  for (int col = warp; col < Tk; col += kBwdWarps) {
    for (int d = lane; d < Dh; d += 32) {
      float gk = 0.f, gv = 0.f;
      for (int i = 0; i < Tq; ++i) {
        gk = fmaf(dss[i * Tk + col], to_f32(qs[i * Dh + d]), gk);
        gv = fmaf(pds[i * Tk + col], to_f32(dos[i * Dh + d]), gv);
      }
      const size_t o = kv_off + static_cast<size_t>(col) * Dh + d;
      dk[o] = from_f32<T>(gk);
      dv[o] = from_f32<T>(gv);
    }
  }
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v,
               const void* k_valid, const void* keep, float keep_prob,
               const void* dout, void* dq, void* dk, void* dv, int B, int H,
               int Tq, int Tk, int Dh, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T>(Tq, Tk, Dh);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_attention_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  masked_attention_bwd_kernel<T><<<B * H, kBwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(k_valid),
      static_cast<const unsigned char*>(keep), keep_prob,
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tq, Tk, Dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one launch needs; the wrapper refuses shapes above the
// card's limit before launching.
long long asr_masked_attention_smem(int dtype_code, int tk, int dh) {
  return static_cast<long long>(dtype_code == 1
                                    ? smem_bytes<__nv_bfloat16>(tk, dh)
                                    : smem_bytes<float>(tk, dh));
}

// dtype_code 0: float32, 1: bfloat16. q [B, H, Tq, Dh], k/v [B, H, Tk, Dh],
// k_valid [B, Tk] bool (one byte each), keep [B, H, Tq, Tk] bool or null
// (no dropout) -> out [B, H, Tq, Dh]; scale is 1/sqrt(Dh) as the caller
// rounds it.
int asr_masked_attention(int dtype_code, const void* q, const void* k,
                         const void* v, const void* k_valid, const void* keep,
                         float keep_prob, void* out, int B, int H, int Tq,
                         int Tk, int Dh, float scale, int causal,
                         void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(q, k, v, k_valid, keep, keep_prob, out, B,
                                 H, Tq, Tk, Dh, scale, causal, s);
  if (dtype_code == 0)
    return launch<float>(q, k, v, k_valid, keep, keep_prob, out, B, H, Tq,
                         Tk, Dh, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory one backward launch needs.
long long asr_masked_attention_bwd_smem(int dtype_code, int tq, int tk,
                                        int dh) {
  return static_cast<long long>(dtype_code == 1
                                    ? bwd_smem_bytes<__nv_bfloat16>(tq, tk, dh)
                                    : bwd_smem_bytes<float>(tq, tk, dh));
}

// The backward: q, dout [B, H, Tq, Dh], k/v [B, H, Tk, Dh], k_valid, keep
// as the forward -> dq [B, H, Tq, Dh], dk / dv [B, H, Tk, Dh], all in the
// input type.
int asr_masked_attention_bwd(int dtype_code, const void* q, const void* k,
                             const void* v, const void* k_valid,
                             const void* keep, float keep_prob,
                             const void* dout, void* dq, void* dk, void* dv,
                             int B, int H, int Tq, int Tk, int Dh,
                             float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, k_valid, keep, keep_prob, dout,
                                     dq, dk, dv, B, H, Tq, Tk, Dh, scale,
                                     causal, s);
  if (dtype_code == 0)
    return launch_bwd<float>(q, k, v, k_valid, keep, keep_prob, dout, dq, dk,
                             dv, B, H, Tq, Tk, Dh, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
