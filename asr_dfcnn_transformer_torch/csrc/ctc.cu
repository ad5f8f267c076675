// CTC forward and backward dynamic programs for the PyTorch port.
//
// Replaces asr_dfcnn_transformer_tpu/ops/pallas/ctc_kernel.py:
//
//   asr_ctc_alpha    <- alpha_stack (_alpha_kernel): the forward DP over
//                       the blank-interleaved extended labels, writing every
//                       alpha_t to [T, B, S] f32 and freezing each row past
//                       its valid length;
//   asr_ctc_beta_xi  <- beta_xi (_beta_xi_kernel): the reverse DP fused with
//                       the posteriors xi_t(s) = exp(min(alpha + beta - logP,
//                       0)), masked by finite logP & t < len & valid state;
//                       beta lives in shared memory and never reaches device
//                       memory.
//
// The recurrence's numerics are those of ops/ctc.py _logaddexp3 exactly:
// NEG_INF = -1e30 (never -inf), the 1e-37 clamp inside the log and the
// m <= NEG_INF/2 readout. The JAX package shares them between its scan and
// Pallas backends, and the port's twins (kernels/ctc.py) share them too.
// Built without --use_fast_math: expf/logf stay the accurate versions.
//
// Bound: a chain of T (<= 200) dependent steps over at most a few dozen
// utterances. Each step moves S floats per utterance, so the kernels are
// bound by the latency of one step (a shared-memory round trip, three
// expf, one logf and a __syncthreads), not by bytes or FLOPs: at B = 16
// only 16 of 132 SMs have work. Design: one block per utterance, one
// thread per extended-label state (block rounded up to a warp multiple:
// 160 threads for S = 129), the DP row double-buffered in shared memory so
// each step needs one barrier. The TPU version's 128-lane S padding, its
// lane rolls and its blocks of 8 utterances are not carried over.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxStates = 1024;  // one thread per state, one block per row

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float m_safe = fmaxf(m, kNegInf / 2);
  const float s = expf(a - m_safe) + expf(b - m_safe) + expf(c - m_safe);
  const float out = m_safe + logf(fmaxf(s, 1e-37f));
  return m <= kNegInf / 2 ? kNegInf : out;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ emit,
                                 const float* __restrict__ init,
                                 const unsigned char* __restrict__ can_skip,
                                 const unsigned char* __restrict__ valid,
                                 const int* __restrict__ lens,
                                 float* __restrict__ alphas, int T, int B,
                                 int S) {
  extern __shared__ float buf[];  // [2][S]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < S;
  const size_t row = static_cast<size_t>(b) * S + s;
  const bool skip = on && can_skip[row] != 0;
  const bool ok = on && valid[row] != 0;
  const int len = lens[b];
  const size_t t_stride = static_cast<size_t>(B) * S;

  float alpha = on ? init[row] : kNegInf;
  if (on) {
    buf[s] = alpha;
    alphas[row] = alpha;
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float* prev = buf + ((t - 1) & 1) * S;
    float* next = buf + (t & 1) * S;
    if (on) {
      const float p1 = s >= 1 ? prev[s - 1] : kNegInf;
      const float p2 = (skip && s >= 2) ? prev[s - 2] : kNegInf;
      float nv = logaddexp3(alpha, p1, p2) + emit[t * t_stride + row];
      nv = ok ? nv : kNegInf;
      alpha = t < len ? nv : alpha;  // freeze past the valid frames
      next[s] = alpha;
      alphas[t * t_stride + row] = alpha;
    }
    __syncthreads();
  }
}

__global__ void ctc_beta_xi_kernel(const float* __restrict__ emit,
                                   const float* __restrict__ alphas,
                                   const float* __restrict__ init,
                                   const unsigned char* __restrict__ skip_from,
                                   const unsigned char* __restrict__ valid,
                                   const int* __restrict__ lens,
                                   const float* __restrict__ log_total,
                                   float* __restrict__ xi, int T, int B,
                                   int S) {
  extern __shared__ float buf[];  // [2][S]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < S;
  const size_t row = static_cast<size_t>(b) * S + s;
  const bool skip = on && s + 2 < S && skip_from[row] != 0;
  const bool ok = on && valid[row] != 0;
  const int len = lens[b];
  const float total = log_total[b];
  const bool finite = total > kNegInf / 2;
  const size_t t_stride = static_cast<size_t>(B) * S;
  const float beta0 = on ? init[row] : kNegInf;

  float beta = beta0;
  if (on) {
    buf[s] = beta;
    const int t = T - 1;
    const float lg = alphas[t * t_stride + row] + beta - total;
    xi[t * t_stride + row] =
        (finite && t < len && ok) ? expf(fminf(lg, 0.f)) : 0.f;
  }
  __syncthreads();
  for (int k = 1; k < T; ++k) {
    const int t = T - 1 - k;
    const float* prev = buf + ((k - 1) & 1) * S;  // beta_{t+1}
    float* next = buf + (k & 1) * S;
    if (on) {
      // nxt(s') = beta_{t+1}(s') + e_{t+1}(s'), read for s, s+1 and s+2:
      // each thread forms its neighbours' sums itself (the same f32 adds),
      // so one barrier per step suffices
      const float* e = emit + (t + 1) * t_stride + static_cast<size_t>(b) * S;
      const float n0 = beta + e[s];
      const float n1 = s + 1 < S ? prev[s + 1] + e[s + 1] : kNegInf;
      const float n2 = skip ? prev[s + 2] + e[s + 2] : kNegInf;
      float nv = logaddexp3(n0, n1, n2);
      nv = ok ? nv : kNegInf;
      beta = t < len - 1 ? nv : beta0;  // pinned to the end states
      next[s] = beta;
      const float lg = alphas[t * t_stride + row] + beta - total;
      xi[t * t_stride + row] =
          (finite && t < len && ok) ? expf(fminf(lg, 0.f)) : 0.f;
    }
    __syncthreads();
  }
}

int block_threads(int S) { return (S + 31) / 32 * 32; }

}  // namespace

extern "C" {

// Largest extended-label width S = 2L + 1 one block takes.
int asr_ctc_max_states() { return kMaxStates; }

// emit [T, B, S] f32, init [B, S] f32, can_skip / valid [B, S] bool (one
// byte each), lens [B] int32 -> alphas [T, B, S] f32.
int asr_ctc_alpha(const void* emit, const void* init, const void* can_skip,
                  const void* valid, const void* lens, void* alphas, int T,
                  int B, int S, void* stream) {
  if (T <= 0 || B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (S > kMaxStates) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  ctc_alpha_kernel<<<B, block_threads(S), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emit), static_cast<const float*>(init),
      static_cast<const unsigned char*>(can_skip),
      static_cast<const unsigned char*>(valid), static_cast<const int*>(lens),
      static_cast<float*>(alphas), T, B, S);
  return static_cast<int>(cudaGetLastError());
}

// emit / alphas [T, B, S] f32, init [B, S] f32 (the end-state beta row),
// skip_from / valid [B, S] bool, lens [B] int32, log_total [B] f32 ->
// xi [T, B, S] f32.
int asr_ctc_beta_xi(const void* emit, const void* alphas, const void* init,
                    const void* skip_from, const void* valid, const void* lens,
                    const void* log_total, void* xi, int T, int B, int S,
                    void* stream) {
  if (T <= 0 || B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (S > kMaxStates) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  ctc_beta_xi_kernel<<<B, block_threads(S), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emit), static_cast<const float*>(alphas),
      static_cast<const float*>(init),
      static_cast<const unsigned char*>(skip_from),
      static_cast<const unsigned char*>(valid), static_cast<const int*>(lens),
      static_cast<const float*>(log_total), static_cast<float*>(xi), T, B, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
