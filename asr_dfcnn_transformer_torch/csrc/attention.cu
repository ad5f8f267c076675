// Masked multi-head attention forward for the PyTorch port.
//
// Replaces asr_dfcnn_transformer_tpu/ops/pallas/attn_kernel.py
// masked_flash_attention (forward, no dropout: _mflash_run_fwd /
// _mflash_fwd_kernel):
//
//   out = softmax(q.k^T * 1/sqrt(Dh) + m) . v,  m = 0 for an allowed key,
//   -1e9 for a key that is invalid or (causal) in the future (col <= row,
//   jnp.tril over [Tq, Tk]). Scores and softmax in f32; probabilities are
//   rounded to the input type before P.V; f32 accumulation; output in q's
//   type. The -1e9 is additive, never -inf and never a skip, so a query
//   row whose keys are all invalid gets a uniform softmax over the Tk real
//   keys, exactly as models/layers.py attention_mask gives it.
//
// Bound: at the LM's shape ([B, 8, 100, 64] bf16) the whole problem is a
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerBlock = 16;
constexpr int kMaxSmem = 232448;  // 227 KB opt-in limit of sm_90
constexpr float kBigNeg = -1e9f;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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
                        T* __restrict__ out, int H, int Tq, int Tk, int Dh,
                        float scale, int causal) {
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
           void* out, int B, int H, int Tq, int Tk, int Dh, float scale,
           int causal, cudaStream_t stream) {
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
      static_cast<T*>(out), H, Tq, Tk, Dh, scale, causal);
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
// k_valid [B, Tk] bool (one byte each) -> out [B, H, Tq, Dh]; scale is
// 1/sqrt(Dh) as the caller rounds it.
int asr_masked_attention(int dtype_code, const void* q, const void* k,
                         const void* v, const void* k_valid, void* out,
                         int B, int H, int Tq, int Tk, int Dh, float scale,
                         int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(q, k, v, k_valid, out, B, H, Tq, Tk, Dh,
                                 scale, causal, s);
  if (dtype_code == 0)
    return launch<float>(q, k, v, k_valid, out, B, H, Tq, Tk, Dh, scale,
                         causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
