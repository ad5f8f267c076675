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
// a few MB, so it is latency- and issue-bound. Design: FlashAttention-2's
// recompute in two launches, so that a block's shared memory depends on Dh
// alone and the backward takes every (Tq, Tk) the forward takes. Launch
// (a), one block per (b*h, 16 query rows), one warp per two rows: it walks
// the keys in chunks of 64 staged in shared memory four times (the row
// max, the sum, dsum, then dS and dQ), keeps each row's state in registers
// and writes dQ and the row's max, sum and dsum to a [3, B, H, Tq] f32
// scratch. Launch (b), one block per (b*h, 16 key rows), one warp per two
// keys: it walks the queries in chunks of 32 (one a lane), rebuilds P from
// the saved max and sum with (a)'s arithmetic, re-applies the keep mask and
// accumulates dK and dV. Every output element is written once by one lane:
// no atomics, so the result is deterministic. Each sum runs in the order
// of the earlier one-block-per-(b, h) kernel (lane-strided over keys for
// the max, sum and dsum; key by key for dQ, query by query for dK and dV).
// The -1e9 stays additive, so a fully invalid query row's gradient is the
// einsum path's.

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
constexpr int kMaxDh = 128;
constexpr int kDSlots = kMaxDh / 32;    // head dims a lane owns
constexpr int kRowsPerWarp = 2;         // launch (a): query rows of a warp
constexpr int kBwdQRows = kBwdWarps * kRowsPerWarp;
constexpr int kKeyChunk = 64;           // launch (a): keys staged at a time
constexpr int kKeysPerWarp = 2;         // launch (b): key rows of a warp
constexpr int kBwdKRows = kBwdWarps * kKeysPerWarp;
constexpr int kQueryChunk = 32;         // launch (b): queries staged, one a lane

// Reserves `bytes` at `off` (kept 16-byte aligned) and returns its offset.
__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off = (off + bytes + 15) / 16 * 16;
  return at;
}

// Launch (a)'s shared memory, in this order: a K and a V chunk [64][k_stride]
// in T; each row's q and dO in f32 [16][2 * Dh]; per warp a dS chunk [64] f32.
template <typename T>
struct RowsLayout {
  size_t k, v, rows, ds, total;
  __host__ __device__ explicit RowsLayout(int dh) {
    const size_t kv = static_cast<size_t>(kKeyChunk) * k_stride<T>(dh) *
                      sizeof(T);
    size_t off = 0;
    k = take(off, kv);
    v = take(off, kv);
    rows = take(off, static_cast<size_t>(kBwdQRows) * 2 * dh * sizeof(float));
    ds = take(off, static_cast<size_t>(kBwdWarps) * kKeyChunk * sizeof(float));
    total = off;
  }
};

// Launch (b)'s shared memory, in this order: a Q and a dO chunk
// [32][k_stride] in T; the chunk's max, sum and dsum [3][32] f32; each key
// row's k and v in f32 [16][2 * Dh]; per warp the dS and dropped-P columns
// [2][32] f32.
template <typename T>
struct KeysLayout {
  size_t q, dout, stats, keys, cols, total;
  __host__ __device__ explicit KeysLayout(int dh) {
    const size_t qd = static_cast<size_t>(kQueryChunk) * k_stride<T>(dh) *
                      sizeof(T);
    size_t off = 0;
    q = take(off, qd);
    dout = take(off, qd);
    stats = take(off, 3 * kQueryChunk * sizeof(float));
    keys = take(off, static_cast<size_t>(kBwdKRows) * 2 * dh * sizeof(float));
    cols = take(off, static_cast<size_t>(kBwdWarps) * 2 * kQueryChunk *
                         sizeof(float));
    total = off;
  }
};

template <typename T>
size_t bwd_smem_bytes(int dh) {
  const size_t a = RowsLayout<T>(dh).total;
  const size_t b = KeysLayout<T>(dh).total;
  return a > b ? a : b;
}

// The score of one (query, key) pair, exactly as the forward kernel forms
// it: an f32 dot product over d in order, times scale, plus the mask.
template <typename Q, typename K>
__device__ __forceinline__ float score(const Q* qr, const K* kr, int Dh,
                                       float scale, bool ok) {
  float acc = 0.f;
  for (int d = 0; d < Dh; ++d) acc = fmaf(to_f32(qr[d]), to_f32(kr[d]), acc);
  return __fadd_rn(__fmul_rn(acc, scale), ok ? 0.f : kBigNeg);
}

template <typename A, typename B>
__device__ __forceinline__ float dot(const A* a, const B* b, int Dh) {
  float acc = 0.f;
  for (int d = 0; d < Dh; ++d) acc = fmaf(to_f32(a[d]), to_f32(b[d]), acc);
  return acc;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Launch (a): dQ, and each query row's max, sum and dsum into `stats`
// ([3][B*H*Tq]: max, sum, dsum). Pass 0 takes the row max, pass 1 the sum
// of exp(s - max), pass 2 dsum = sum(dP * P) over the unrounded f32 P,
// pass 3 dS (rounded to T) and dQ = dS.K.
template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
masked_attention_bwd_rows_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const unsigned char* __restrict__ k_valid,
                                 const unsigned char* __restrict__ keep,
                                 float keep_prob, const T* __restrict__ dout,
                                 T* __restrict__ dq, float* __restrict__ stats,
                                 int BH, int H, int Tq, int Tk, int Dh,
                                 float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RowsLayout<T> lay(Dh);
  const int ks_stride = k_stride<T>(Dh);
  T* kc = reinterpret_cast<T*>(smem + lay.k);
  T* vc = reinterpret_cast<T*>(smem + lay.v);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* rows = reinterpret_cast<float*>(smem + lay.rows) +
                warp * kRowsPerWarp * 2 * Dh;
  float* dsc = reinterpret_cast<float*>(smem + lay.ds) + warp * kKeyChunk;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int row0 = static_cast<int>(blockIdx.y) * kBwdQRows +
                   warp * kRowsPerWarp;
  const size_t q_off = static_cast<size_t>(bh) * Tq * Dh;
  const size_t kv_off = static_cast<size_t>(bh) * Tk * Dh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    for (int d = lane; d < Dh; d += 32) {
      const size_t o = q_off + static_cast<size_t>(row) * Dh + d;
      rows[2 * r * Dh + d] = row < Tq ? to_f32(q[o]) : 0.f;
      rows[(2 * r + 1) * Dh + d] = row < Tq ? to_f32(dout[o]) : 0.f;
    }
  }
  __syncwarp();

  const unsigned char* valid_row = k_valid + static_cast<size_t>(b) * Tk;
  float m[kRowsPerWarp], l[kRowsPerWarp], dsum[kRowsPerWarp];
  float acc[kRowsPerWarp][kDSlots];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    dsum[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kDSlots; ++t) acc[r][t] = 0.f;
  }

  for (int pass = 0; pass < 4; ++pass) {
    for (int c0 = 0; c0 < Tk; c0 += kKeyChunk) {
      const int n = min(kKeyChunk, Tk - c0);
      __syncthreads();  // the previous chunk is read by every warp
      for (int i = threadIdx.x; i < n * Dh; i += blockDim.x) {
        const int r = i / Dh;
        const int c = i - r * Dh;
        const size_t g = kv_off + static_cast<size_t>(c0) * Dh + i;
        kc[r * ks_stride + c] = k[g];
        if (pass >= 2) vc[r * ks_stride + c] = v[g];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = row0 + r;
        if (row >= Tq) break;  // warp-uniform
        const float* qrow = rows + 2 * r * Dh;
        const float* dorow = qrow + Dh;
        const unsigned char* keep_row =
            keep == nullptr ? nullptr
                            : keep + (static_cast<size_t>(bh) * Tq + row) * Tk;
        for (int jj = lane; jj < n; jj += 32) {
          const int j = c0 + jj;
          const bool ok = valid_row[j] != 0 && (!causal || j <= row);
          const float s = score(qrow, kc + jj * ks_stride, Dh, scale, ok);
          if (pass == 0) {
            m[r] = fmaxf(m[r], s);
            continue;
          }
          const float e = expf(s - m[r]);
          if (pass == 1) {
            l[r] += e;
            continue;
          }
          const float p = e / l[r];
          float dp = dot(dorow, vc + jj * ks_stride, Dh);
          if (keep_row != nullptr)
            dp = __fmul_rn(dp, (keep_row[j] ? 1.f : 0.f) / keep_prob);
          if (pass == 2) {
            dsum[r] = fmaf(dp, p, dsum[r]);
            continue;
          }
          const float g = __fmul_rn(__fmul_rn(p, dp - dsum[r]), scale);
          dsc[jj] = to_f32(from_f32<T>(g));  // dS rounded to the type
        }
        if (pass == 3) {
          __syncwarp();
#pragma unroll
          for (int t = 0; t < kDSlots; ++t) {
            const int d = lane + 32 * t;
            if (d < Dh)
              for (int jj = 0; jj < n; ++jj)
                acc[r][t] = fmaf(dsc[jj], to_f32(kc[jj * ks_stride + d]),
                                 acc[r][t]);
          }
          __syncwarp();  // dsc is rewritten by the next row
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (pass == 0) m[r] = warp_max(m[r]);
      if (pass == 1) l[r] = warp_sum(l[r]);
      if (pass == 2) dsum[r] = warp_sum(dsum[r]);
    }
  }

  const size_t n_rows = static_cast<size_t>(BH) * Tq;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= Tq) break;
#pragma unroll
    for (int t = 0; t < kDSlots; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh)
        dq[q_off + static_cast<size_t>(row) * Dh + d] = from_f32<T>(acc[r][t]);
    }
    if (lane == 0) {
      const size_t at = static_cast<size_t>(bh) * Tq + row;
      stats[at] = m[r];
      stats[n_rows + at] = l[r];
      stats[2 * n_rows + at] = dsum[r];
    }
  }
}

// Launch (b): dK = dS^T.Q and dV = dropped^T.dO for 16 key rows, P rebuilt
// from launch (a)'s max and sum.
template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
masked_attention_bwd_keys_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const unsigned char* __restrict__ k_valid,
                                 const unsigned char* __restrict__ keep,
                                 float keep_prob, const T* __restrict__ dout,
                                 const float* __restrict__ stats,
                                 T* __restrict__ dk, T* __restrict__ dv,
                                 int BH, int H, int Tq, int Tk, int Dh,
                                 float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const KeysLayout<T> lay(Dh);
  const int ks_stride = k_stride<T>(Dh);
  T* qc = reinterpret_cast<T*>(smem + lay.q);
  T* doc = reinterpret_cast<T*>(smem + lay.dout);
  float* st = reinterpret_cast<float*>(smem + lay.stats);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* keys = reinterpret_cast<float*>(smem + lay.keys) +
                warp * kKeysPerWarp * 2 * Dh;
  float* dsc = reinterpret_cast<float*>(smem + lay.cols) +
               warp * 2 * kQueryChunk;
  float* drc = dsc + kQueryChunk;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int col0 = static_cast<int>(blockIdx.y) * kBwdKRows +
                   warp * kKeysPerWarp;
  const size_t q_off = static_cast<size_t>(bh) * Tq * Dh;
  const size_t kv_off = static_cast<size_t>(bh) * Tk * Dh;
#pragma unroll
  for (int kk = 0; kk < kKeysPerWarp; ++kk) {
    const int col = col0 + kk;
    for (int d = lane; d < Dh; d += 32) {
      const size_t o = kv_off + static_cast<size_t>(col) * Dh + d;
      keys[2 * kk * Dh + d] = col < Tk ? to_f32(k[o]) : 0.f;
      keys[(2 * kk + 1) * Dh + d] = col < Tk ? to_f32(v[o]) : 0.f;
    }
  }
  __syncwarp();

  const unsigned char* valid_row = k_valid + static_cast<size_t>(b) * Tk;
  const float kp_t = to_f32(from_f32<T>(keep_prob));  // keep in the type
  const size_t n_rows = static_cast<size_t>(BH) * Tq;
  float gk[kKeysPerWarp][kDSlots], gv[kKeysPerWarp][kDSlots];
#pragma unroll
  for (int kk = 0; kk < kKeysPerWarp; ++kk)
#pragma unroll
    for (int t = 0; t < kDSlots; ++t) gk[kk][t] = gv[kk][t] = 0.f;

  for (int i0 = 0; i0 < Tq; i0 += kQueryChunk) {
    const int n = min(kQueryChunk, Tq - i0);
    __syncthreads();  // the previous chunk is read by every warp
    for (int i = threadIdx.x; i < n * Dh; i += blockDim.x) {
      const int r = i / Dh;
      const int c = i - r * Dh;
      const size_t g = q_off + static_cast<size_t>(i0) * Dh + i;
      qc[r * ks_stride + c] = q[g];
      doc[r * ks_stride + c] = dout[g];
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const size_t at = static_cast<size_t>(bh) * Tq + i0 + i;
      st[i] = stats[at];
      st[kQueryChunk + i] = stats[n_rows + at];
      st[2 * kQueryChunk + i] = stats[2 * n_rows + at];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKeysPerWarp; ++kk) {
      const int col = col0 + kk;
      if (col >= Tk) break;  // warp-uniform
      const float* kr = keys + 2 * kk * Dh;
      const float* vr = kr + Dh;
      if (lane < n) {
        const int row = i0 + lane;
        const bool ok = valid_row[col] != 0 && (!causal || col <= row);
        const float s = score(qc + lane * ks_stride, kr, Dh, scale, ok);
        const float p = expf(s - st[lane]) / st[kQueryChunk + lane];
        const float p_t = to_f32(from_f32<T>(p));
        float dp = dot(doc + lane * ks_stride, vr, Dh);
        float dropped = p_t;
        if (keep != nullptr) {
          const float mk =
              keep[(static_cast<size_t>(bh) * Tq + row) * Tk + col] ? 1.f
                                                                    : 0.f;
          dropped = to_f32(from_f32<T>(p_t / kp_t)) * mk;
          dp = __fmul_rn(dp, mk / keep_prob);
        }
        const float g = __fmul_rn(
            __fmul_rn(p, dp - st[2 * kQueryChunk + lane]), scale);
        dsc[lane] = to_f32(from_f32<T>(g));
        drc[lane] = dropped;
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kDSlots; ++t) {
        const int d = lane + 32 * t;
        if (d < Dh)
          for (int i = 0; i < n; ++i) {
            gk[kk][t] = fmaf(dsc[i], to_f32(qc[i * ks_stride + d]), gk[kk][t]);
            gv[kk][t] = fmaf(drc[i], to_f32(doc[i * ks_stride + d]),
                             gv[kk][t]);
          }
      }
      __syncwarp();  // dsc / drc are rewritten by the next key
    }
  }

#pragma unroll
  for (int kk = 0; kk < kKeysPerWarp; ++kk) {
    const int col = col0 + kk;
    if (col >= Tk) break;
#pragma unroll
    for (int t = 0; t < kDSlots; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) {
        const size_t o = kv_off + static_cast<size_t>(col) * Dh + d;
        dk[o] = from_f32<T>(gk[kk][t]);
        dv[o] = from_f32<T>(gv[kk][t]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v,
               const void* k_valid, const void* keep, float keep_prob,
               const void* dout, void* dq, void* dk, void* dv, void* stats,
               int B, int H, int Tq, int Tk, int Dh, float scale, int causal,
               cudaStream_t stream) {
  if (Dh > kMaxDh) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_a = RowsLayout<T>(Dh).total;
  const size_t smem_b = KeysLayout<T>(Dh).total;
  cudaError_t err = allow_smem(masked_attention_bwd_rows_kernel<T>, smem_a);
  if (err == cudaSuccess)
    err = allow_smem(masked_attention_bwd_keys_kernel<T>, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot_ = static_cast<const T*>(dout);
  const unsigned char* valid = static_cast<const unsigned char*>(k_valid);
  const unsigned char* mask = static_cast<const unsigned char*>(keep);
  float* st = static_cast<float*>(stats);
  const dim3 grid_a(B * H, (Tq + kBwdQRows - 1) / kBwdQRows);
  masked_attention_bwd_rows_kernel<T><<<grid_a, kBwdWarps * 32, smem_a,
                                        stream>>>(
      qt, kt, vt, valid, mask, keep_prob, dot_, static_cast<T*>(dq), st,
      B * H, H, Tq, Tk, Dh, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(B * H, (Tk + kBwdKRows - 1) / kBwdKRows);
  masked_attention_bwd_keys_kernel<T><<<grid_b, kBwdWarps * 32, smem_b,
                                        stream>>>(
      qt, kt, vt, valid, mask, keep_prob, dot_, st, static_cast<T*>(dk),
      static_cast<T*>(dv), B * H, H, Tq, Tk, Dh, scale, causal);
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

// Shared memory of the larger of the backward's two launches: it depends
// on Dh alone, and stays within the card's limit for every Dh <= 128.
long long asr_masked_attention_bwd_smem(int dtype_code, int dh) {
  return static_cast<long long>(dtype_code == 1
                                    ? bwd_smem_bytes<__nv_bfloat16>(dh)
                                    : bwd_smem_bytes<float>(dh));
}

// The backward: q, dout [B, H, Tq, Dh], k/v [B, H, Tk, Dh], k_valid, keep
// as the forward -> dq [B, H, Tq, Dh], dk / dv [B, H, Tk, Dh], all in the
// input type; stats is an f32 scratch of 3 * B * H * Tq (each query row's
// max, sum and dsum, written by the first launch and read by the second).
int asr_masked_attention_bwd(int dtype_code, const void* q, const void* k,
                             const void* v, const void* k_valid,
                             const void* keep, float keep_prob,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* stats, int B, int H, int Tq, int Tk,
                             int Dh, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0)
    return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, k_valid, keep, keep_prob, dout,
                                     dq, dk, dv, stats, B, H, Tq, Tk, Dh,
                                     scale, causal, s);
  if (dtype_code == 0)
    return launch_bwd<float>(q, k, v, k_valid, keep, keep_prob, dout, dq, dk,
                             dv, stats, B, H, Tq, Tk, Dh, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
