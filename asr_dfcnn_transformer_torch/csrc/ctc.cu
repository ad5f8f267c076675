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
// expf, one logf and a barrier), not by bytes or FLOPs: at B = 16 only 16
// of 132 SMs have work. One block per utterance, one thread per
// extended-label state (rounded up to a warp multiple: 160 threads for S =
// 129). The TPU version's 128-lane S padding, its lane rolls and its
// blocks of 8 utterances are not carried over.
//
// ctc_alpha_kernel double-buffers the DP row in shared memory (one barrier
// a step) and reads each step's emissions from device memory. Two designs
// without the barrier measured slower on an H100 at [200, 16, 129]
// (PERF.md): a wavefront of warps handing boundary states on, and one warp
// an utterance with ceil(S / 32) states a lane in registers, whose one
// sub-partition issues every state's logaddexp3 (about 66 instructions a
// state, at ~0.36 a cycle) where this kernel spreads them over four.
//
// ctc_beta_xi_kernel keeps the chain on shared memory alone. The earlier
// kernel's step (~1070 cycles, a clock64 split on an H100) waited on the
// device-memory emission loads of frame t + 1 (31%) and on xi's alpha load
// and expf (38%) before its barrier; logaddexp3 took 26%. Now three roles
// share the block around a ring of kRing slots, each slot [emit row t + 1
// | alpha row t | beta row t] of one step k = T - 1 - t:
//   - a producer thread copies step k's emission and alpha rows into slot
//     k % kRing by bulk copies (the TMA's non-tensor form; a row of S = 2L
//     + 1 floats is copied whole 16-byte chunks from the boundary below it,
//     see lead_of), completing on the slot's `full` mbarrier, up to kRing
//     steps ahead, once its `empty` mbarrier says step k - kRing has left;
//   - the chain warps (one state a thread, two above kChainMax states)
//     read the emissions and beta_{t+1} from the ring and write beta_t;
//   - four writer warps write xi_t = exp(min(alpha + beta - logP, 0)) for
//     step k's row (coalesced) while the chain runs step k + 1;
//   - a watcher warp waits on step k + 1's `full` while the chain runs
//     step k, and frees step k - 1's slot after step k.
// The chain, the writers and the watcher meet at one named barrier a step,
// so the chain's step is its shared-memory loads, logaddexp3, one store
// and that barrier: no wait and no device-memory access of its own.
// At [200, 16, 129] it takes 44.7 us against the earlier kernel's 85.3 on
// an NVIDIA H100 80GB HBM3 at 700 W; with the writers on the step's
// barrier their global stores still cost a few us, and forming every
// element's expf before any store was the fastest order.
// The step's arithmetic is the earlier kernel's, in the same order, so xi
// is the same bits. kernels/ctc.py beta_xi_plan mirrors the launch's
// shape (asr_ctc_beta_xi_plan), and beta_ring_schedule its slot and phase
// arithmetic.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxStates = 1024;  // one block per row
// beta_xi: steps staged ahead, writer warps, chain threads at most
constexpr int kRing = 8;
constexpr int kWriterWarps = 4;
constexpr int kHelperThreads = 32 * (2 + kWriterWarps);  // + producer, watcher
constexpr int kChainMax = 512;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "CTC_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra CTC_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy (the TMA's non-tensor form) of `bytes` (a multiple of 16,
// both ends 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Floats from the 16-byte boundary below `row` to `row`. A ring row is
// copied from that boundary, whole 16-byte chunks, and read `lead` floats
// into its slot: the copy reads at most 12 bytes on either side of the
// row, inside the 16-byte chunks that hold its ends.
__device__ __forceinline__ int lead_of(const float* row) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
}

__device__ __forceinline__ uint32_t row_bytes(int lead, int S) {
  return static_cast<uint32_t>((lead + S + 3) / 4 * 16);
}

// Shared-memory load and store at a 32-bit shared address (volatile: they
// keep their place against the step's barrier).
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// Named barrier 1 ends each step: the chain's warps, the watcher warp and
// the writer warps meet there once a step.
__device__ __forceinline__ void step_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// Step k (t = T - 1 - k) lives in slot k % kRing; its mbarriers' k /
// kRing-th phase, parity (k / kRing) & 1, completes once per use of the
// slot.
__device__ __forceinline__ uint32_t ring_parity(int k) {
  return static_cast<uint32_t>(k / kRing) & 1u;
}

// P states a chain thread; launched with chain + kHelperThreads threads,
// chain = a warp multiple of ceil(S / P), and beta_xi_smem(S) bytes.
template <int P>
__global__ void __launch_bounds__(kChainMax + kHelperThreads)
ctc_beta_xi_kernel(const float* __restrict__ emit,
                   const float* __restrict__ alphas,
                   const float* __restrict__ init,
                   const unsigned char* __restrict__ skip_from,
                   const unsigned char* __restrict__ valid,
                   const int* __restrict__ lens,
                   const float* __restrict__ log_total,
                   float* __restrict__ xi, int T, int B, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* full = reinterpret_cast<uint64_t*>(smem);  // emit + alpha landed
  uint64_t* empty = full + kRing;                  // the step left its slot
  float* ring = reinterpret_cast<float*>(empty + kRing);
  const int sp = (S + 6) / 4 * 4;  // a row and its lead, in 16-byte chunks
  const int slot_words = 3 * sp;   // [emit | alpha | beta]
  const int chain = static_cast<int>(blockDim.x) - kHelperThreads;
  const int producer = chain, watcher = chain + 32, writers = chain + 64;
  const int stepping = chain + 32 + 32 * kWriterWarps;  // at step_sync
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const size_t t_stride = static_cast<size_t>(B) * S;
  const size_t brow = static_cast<size_t>(b) * S;
  const int len = lens[b];
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < chain) {
    // the chain: beta_t of step k into slot k % kRing, from the emissions
    // of frame t + 1 in the same slot and beta_{t+1} in the slot before
    float beta[P], beta0[P];
    bool skip[P], ok[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int s = tid + p * chain;
      const bool on = s < S;
      skip[p] = on && s + 2 < S && skip_from[brow + s] != 0;
      ok[p] = on && valid[brow + s] != 0;
      beta0[p] = on ? init[brow + s] : kNegInf;
      beta[p] = beta0[p];
      if (on) ring[2 * sp + s] = beta[p];  // step 0: beta_{T-1}
    }
    step_sync(stepping);
    // shared addresses of step k's emission row (at the row's lead), of
    // beta_{t+1} (step k - 1's slot) and of beta_t, this thread's first
    // state; the next step's are formed before the barrier
    const uint32_t ring_s = smem_u32(ring);
    const uint32_t slot_b = 4 * slot_words;
    const uint32_t own = 4 * tid;
    const int lead_step = static_cast<int>(t_stride & 3);
    int lead = lead_of(emit + static_cast<size_t>(T - 1) * t_stride + brow);
    uint32_t e_a = ring_s + (1 % kRing) * slot_b + 4 * lead + own;
    uint32_t prev_a = ring_s + 8 * sp + own;
    uint32_t next_a = ring_s + (1 % kRing) * slot_b + 8 * sp + own;
    for (int k = 1; k < T; ++k) {
      const int t = T - 1 - k;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int s = tid + p * chain;
        const uint32_t off = 4 * p * chain;
        if (s < S) {
          // nxt(s') = beta_{t+1}(s') + e_{t+1}(s'), for s, s+1 and s+2
          // (the loads past S stay inside the slot and go unused)
          const float e0 = lds(e_a + off), e1 = lds(e_a + off + 4);
          const float e2 = lds(e_a + off + 8);
          const float b1 = lds(prev_a + off + 4), b2 = lds(prev_a + off + 8);
          const float n0 = beta[p] + e0;
          const float n1 = s + 1 < S ? b1 + e1 : kNegInf;
          const float n2 = skip[p] ? b2 + e2 : kNegInf;
          float nv = logaddexp3(n0, n1, n2);
          nv = ok[p] ? nv : kNegInf;
          beta[p] = t < len - 1 ? nv : beta0[p];  // pinned to the end states
          sts(next_a + off, beta[p]);
        }
      }
      const int k1 = k + 1;
      lead = (lead - lead_step) & 3;  // frame t: t_stride floats lower
      e_a = ring_s + (k1 % kRing) * slot_b + 4 * lead + own;
      prev_a = next_a;
      next_a = ring_s + (k1 % kRing) * slot_b + 8 * sp + own;
      asm volatile("" : "+r"(e_a), "+r"(prev_a), "+r"(next_a));
      step_sync(stepping);
    }
  } else if (tid == producer) {
    // the producer: step k's alpha row t and emission row t + 1 (none at
    // k = 0) into slot k % kRing, once step k - kRing has left it
    for (int k = 0; k < T; ++k) {
      const int i = k % kRing;
      if (k >= kRing) mbar_wait(empty + i, ring_parity(k - kRing));
      // the slot's earlier generic reads before the async proxy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const int t = T - 1 - k;
      float* slot = ring + i * slot_words;
      const float* a_row = alphas + t * t_stride + brow;
      const int la = lead_of(a_row);
      const uint32_t a_bytes = row_bytes(la, S);
      const float* e_row = emit + (t + 1) * t_stride + brow;
      const int le = k >= 1 ? lead_of(e_row) : 0;
      const uint32_t e_bytes = k >= 1 ? row_bytes(le, S) : 0;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(full + i)),
          "r"(a_bytes + e_bytes)
          : "memory");
      bulk_copy(slot + sp, a_row - la, a_bytes, full + i);
      if (k >= 1) bulk_copy(slot, e_row - le, e_bytes, full + i);
    }
  } else if (tid >= watcher && tid < writers) {
    // the watcher: before step k's barrier, step k + 1's rows have landed
    // (so that the chain and the writers read them after it with no wait
    // of their own); after it, step k - 1 has left its slot
    mbar_wait(full, ring_parity(0));
    if (T > 1) mbar_wait(full + 1 % kRing, ring_parity(1));
    step_sync(stepping);
    for (int k = 1; k < T; ++k) {
      if (k + 1 < T) mbar_wait(full + (k + 1) % kRing, ring_parity(k + 1));
      step_sync(stepping);
      if (tid == watcher) mbar_arrive(empty + (k - 1) % kRing);
    }
  } else if (tid >= writers) {
    // the writers: after step k's barrier, step k's xi row from the slot
    // while the chain runs step k + 1: a thread's states w, w + 128, ..
    // (at most kPer) loaded at once, then their expf, then their stores
    constexpr int kStride = 32 * kWriterWarps;
    constexpr int kPer = kChainMax * P / kStride;
    const int w = tid - writers;
    const float total = log_total[b];
    const bool finite = total > kNegInf / 2;
    uint32_t ok_bits = 0;  // bit j: state w + j * kStride is valid
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int s = w + j * kStride;
      if (s < S) ok_bits |= static_cast<uint32_t>(valid[brow + s] != 0) << j;
    }
    const uint32_t ring_s = smem_u32(ring);
    const uint32_t slot_b = 4 * slot_words;
    const uint32_t own = 4 * w;
    const int lead_step = static_cast<int>(t_stride & 3);
    int lead = lead_of(alphas + static_cast<size_t>(T - 1) * t_stride + brow);
    float* x_row = xi + static_cast<size_t>(T - 1) * t_stride + brow;
    for (int k = 0; k < T; ++k) {
      const int t = T - 1 - k;
      const uint32_t slot = ring_s + (k % kRing) * slot_b;
      const uint32_t a_a = slot + 4 * (sp + lead) + own;
      const uint32_t b_a = slot + 8 * sp + own;
      lead = (lead - lead_step) & 3;  // frame t - 1: t_stride floats lower
      step_sync(stepping);
      float lg[kPer], xv[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        lg[j] = w + j * kStride < S
                    ? lds(a_a + 4 * j * kStride) + lds(b_a + 4 * j * kStride)
                    : 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        xv[j] = (finite && t < len && ((ok_bits >> j) & 1u))
                    ? expf(fminf(lg[j] - total, 0.f))
                    : 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (w + j * kStride < S) x_row[w + j * kStride] = xv[j];
      x_row -= t_stride;
    }
  }
}

int block_threads(int S) { return (S + 31) / 32 * 32; }

// beta_xi's launch: states a chain thread, threads a block, shared bytes.
int beta_xi_states(int S) { return S > kChainMax ? 2 : 1; }

int beta_xi_threads(int S) {
  const int p = beta_xi_states(S);
  return block_threads((S + p - 1) / p) + kHelperThreads;
}

size_t beta_xi_smem(int S) {
  return 2 * kRing * sizeof(uint64_t) +
         static_cast<size_t>(kRing) * 3 * ((S + 6) / 4 * 4) * sizeof(float);
}

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

// One field of ctc_beta_xi's launch at S states: 0 steps staged ahead (the
// ring's slots), 1 states a chain thread, 2 threads a block, 3 dynamic
// shared memory a block; -1 for an unknown field or S outside 1 ..
// asr_ctc_max_states(). kernels/ctc.py beta_xi_plan mirrors it.
long long asr_ctc_beta_xi_plan(int S, int field) {
  if (S <= 0 || S > kMaxStates) return -1;
  const long long v[] = {kRing, beta_xi_states(S), beta_xi_threads(S),
                         static_cast<long long>(beta_xi_smem(S))};
  return field >= 0 && field < 4 ? v[field] : -1;
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
  const size_t smem = beta_xi_smem(S);
  auto kernel = beta_xi_states(S) == 1 ? ctc_beta_xi_kernel<1>
                                       : ctc_beta_xi_kernel<2>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, beta_xi_threads(S), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emit), static_cast<const float*>(alphas),
      static_cast<const float*>(init),
      static_cast<const unsigned char*>(skip_from),
      static_cast<const unsigned char*>(valid), static_cast<const int*>(lens),
      static_cast<const float*>(log_total), static_cast<float*>(xi), T, B, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
