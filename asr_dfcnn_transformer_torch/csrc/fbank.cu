// Log-mel filterbank and per-utterance CMVN for the PyTorch port.
//
// asr_log_mel replaces asr_dfcnn_transformer_tpu/ops/pallas/fbank_kernel.py
// pallas_log_mel (_kernel): pre-emphasis 0.97 with the signal-end mask,
// 400-sample frames at hop 160, the 512-point DFT power as products against
// cos/sin bases, the 200-filter mel projection and log(max(., f64 eps)).
//
//   Numerics: the DFT sums accumulate in f64. A bin whose power is tiny
//   next to the frame's energy (the DC-only low mel filters after
//   pre-emphasis) cancels badly in f32: an f32 sum misses the exact value
//   there by up to ~0.005 in the log, by an amount that depends on the
//   summation order. In f64 the kernel and its twin agree to
//   ~1e-6 and both sit on the exact value of the f32 inputs (the
//   python_speech_features reference is f64 too). Power, mel projection
//   (a sum of non-negative terms) and log stay f32.
//
//   Bound: bytes. The function reads the signal and writes the features,
//   ~18 MB at [8, 1600] frames, ~5.6 us at 3.35 TB/s; its operations are
//   fewer in FFT form (~12 k f64 a frame for a 512-point real FFT, and the
//   mel bank is sparse) and take ~3 us even at the 67 TFLOP/s of f64 on
//   the tensor cores. This kernel's direct DFT instead costs 400 x 257 x 2
//   f64 FMAs a frame (~2.6 G a batch, ~30x the FFT's operations) on the
//   34 TFLOP/s of f64 outside the tensor cores, and so runs ~80x over the
//   function's bound.
//   Design: one block per (utterance, 8-frame tile). The tile's
//   pre-emphasised, masked samples sit in shared memory (1520 values, the
//   2.5x frame matrix is never built), widened to f64 once. Thread k owns
//   DFT bin k and keeps 8 re/im accumulators in registers, so each basis
//   value it reads (the 822 KB cos/sin bases stay L2-resident; the next
//   step's are in flight during this step's FMAs) feeds 8 frames; the
//   frame samples are warp-wide broadcasts from shared memory. The power
//   rows go back to shared memory and thread j then owns mel filter j. No
//   cuBLAS. Tiles of 16 frames measured slower (0.62 vs 0.46 ms at
//   [8, 1600] on an H100 SXM at 700 W), likely from fewer blocks in
//   flight per SM.
//   It runs at ~1/3 of the non-tensor f64 FMA rate. Later work: an FFT
//   form in f64, or tensor-core products (f64 DMMA, or split f32) over the
//   frame matrix, towards the bound of bytes.
//
// asr_cmvn replaces fbank_kernel.py pallas_cmvn (_cmvn_kernel): per
// utterance and per bin, masked mean and std over the valid frames (ddof 0,
// std 0 -> 1), sklearn's second re-centering, rows at/past `valid` zeroed.
//
//   Bound: memory, four reads and one write of [B, T, F] f32 (L2 serves
//   the re-reads at these sizes). Design: one block per (utterance, 32
//   bins) with 8 warps striding over time; neighbouring lanes own
//   neighbouring bins so every row read is one coalesced 128-byte line.
//   Partial sums meet in shared memory. Sums stay in f32 with exact
//   division and sqrt, so a constant column (an empty mel filter) comes out
//   exactly 0, as in the JAX path.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWin = 400;
constexpr int kHop = 160;
constexpr int kBins = 257;          // nfft / 2 + 1 for nfft = 512
constexpr int kTileFrames = 8;      // a multiple of 4
constexpr int kTileSamples = (kTileFrames - 1) * kHop + kWin;
constexpr int kLogMelThreads = 288;  // >= kBins, whole warps
constexpr float kLogEps = 2.220446049250313e-16f;  // float64 eps

constexpr int kCmvnBins = 32;
constexpr int kCmvnRows = 8;

__global__ void __launch_bounds__(kLogMelThreads)
log_mel_kernel(const float* __restrict__ sig, const int* __restrict__ lens,
               const float* __restrict__ cosb,
               const float* __restrict__ sinb,
               const float* __restrict__ mel, float* __restrict__ out,
               int S, int T, int nfilt, float preemph, float inv_nfft) {
  // pre-emphasised samples, rounded in f32 (as the JAX path) and widened
  // once here: a float -> double conversion per FMA would cost more than
  // the FMA (conversions to 64 bits issue at a quarter of the f64 FMA
  // rate). Frame starts are 32-byte aligned (kHop % 4 == 0): double2 reads.
  __shared__ __align__(16) double pe[kTileSamples];
  // power[bin][frame]: a mel-phase thread reads a bin's frames as float4s
  __shared__ __align__(16) float power[kBins][kTileFrames];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTileFrames;
  const int len = lens[b];
  const float* x = sig + static_cast<size_t>(b) * S;
  const long long base = static_cast<long long>(f0) * kHop;

  // pe[t] = x[t] - c * x[t-1] with x[-1] = 0, then zero at/past the
  // utterance length (kills the -c * x[len-1] spike just past the end)
  // and past the padded signal.
  for (int i = threadIdx.x; i < kTileSamples; i += blockDim.x) {
    const long long t = base + i;
    float v = 0.f;
    if (t < len && t < S) {
      const float prev = t > 0 ? x[t - 1] : 0.f;
      v = __fsub_rn(x[t], __fmul_rn(preemph, prev));
    }
    pe[i] = static_cast<double>(v);
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < kBins) {
    double re[kTileFrames];
    double im[kTileFrames];
#pragma unroll
    for (int f = 0; f < kTileFrames; ++f) {
      re[f] = 0.0;
      im[f] = 0.0;
    }
    // Four samples per step. The next step's basis values are loaded
    // before this step's FMAs, so their L2 latency hides behind them.
    float c_next[4];
    float s_next[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c_next[u] = __ldg(cosb + u * kBins + k);
      s_next[u] = __ldg(sinb + u * kBins + k);
    }
    for (int n = 0; n < kWin; n += 4) {
      double c[4];
      double s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u] = c_next[u];
        s[u] = s_next[u];
      }
      if (n + 4 < kWin) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          c_next[u] = __ldg(cosb + (n + 4 + u) * kBins + k);
          s_next[u] = __ldg(sinb + (n + 4 + u) * kBins + k);
        }
      }
      // two 16-byte shared-memory reads (warp-wide broadcasts) per frame
      double v[kTileFrames][4];
#pragma unroll
      for (int f = 0; f < kTileFrames; ++f) {
        const double2 a = *reinterpret_cast<const double2*>(pe + f * kHop + n);
        const double2 b =
            *reinterpret_cast<const double2*>(pe + f * kHop + n + 2);
        v[f][0] = a.x;
        v[f][1] = a.y;
        v[f][2] = b.x;
        v[f][3] = b.y;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int f = 0; f < kTileFrames; ++f) {
          re[f] = fma(v[f][u], c[u], re[f]);
          im[f] = fma(v[f][u], s[u], im[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kTileFrames; ++f)
      power[k][f] = static_cast<float>((re[f] * re[f] + im[f] * im[f]) *
                                       static_cast<double>(inv_nfft));
  }
  __syncthreads();

  const int nf = min(kTileFrames, T - f0);
  for (int j = threadIdx.x; j < nfilt; j += blockDim.x) {
    float acc[kTileFrames];
#pragma unroll
    for (int f = 0; f < kTileFrames; ++f) acc[f] = 0.f;
    for (int kk = 0; kk < kBins; ++kk) {
      const float w = __ldg(mel + kk * nfilt + j);
      const float4* p = reinterpret_cast<const float4*>(power[kk]);
#pragma unroll
      for (int q = 0; q < kTileFrames / 4; ++q) {
        const float4 v = p[q];
        acc[4 * q] = fmaf(v.x, w, acc[4 * q]);
        acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTileFrames; ++f) {
      if (f < nf)
        out[(static_cast<size_t>(b) * T + f0 + f) * nfilt + j] =
            logf(fmaxf(acc[f], kLogEps));
    }
  }
}

// Sum of one value per thread over the block's kCmvnRows rows, per column;
// every thread of a column gets the total.
__device__ float column_sum(float v, float (*red)[kCmvnBins]) {
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kCmvnRows; ++r) total += red[r][threadIdx.x];
  __syncthreads();  // red is rewritten by the next call
  return total;
}

__global__ void __launch_bounds__(kCmvnBins * kCmvnRows)
cmvn_kernel(const float* __restrict__ feat, const int* __restrict__ valid,
            float* __restrict__ out, int T, int F) {
  __shared__ float red[kCmvnRows][kCmvnBins];
  const int b = blockIdx.y;
  const int j = blockIdx.x * kCmvnBins + threadIdx.x;
  const bool active = j < F;
  const int nv = valid[b];
  const int rows = max(0, min(nv, T));
  const float cnt = static_cast<float>(max(nv, 1));
  const size_t off = static_cast<size_t>(b) * T * F + j;
  const float* x = feat + off;
  float* y = out + off;

  float s = 0.f;
  if (active)
    for (int t = threadIdx.y; t < rows; t += kCmvnRows)
      s += x[static_cast<size_t>(t) * F];
  const float mean = column_sum(s, red) / cnt;

  s = 0.f;
  if (active)
    for (int t = threadIdx.y; t < rows; t += kCmvnRows) {
      const float d = x[static_cast<size_t>(t) * F] - mean;
      s += d * d;
    }
  float sd = sqrtf(column_sum(s, red) / cnt);
  if (sd == 0.f) sd = 1.f;

  s = 0.f;
  if (active)
    for (int t = threadIdx.y; t < rows; t += kCmvnRows)
      s += (x[static_cast<size_t>(t) * F] - mean) / sd;
  const float mean2 = column_sum(s, red) / cnt;

  if (active)
    for (int t = threadIdx.y; t < T; t += kCmvnRows) {
      const size_t o = static_cast<size_t>(t) * F;
      y[o] = t < rows ? (x[o] - mean) / sd - mean2 : 0.f;
    }
}

}  // namespace

extern "C" {

const char* asr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// signals [B, S] f32, lengths [B] int32, cos/sin [400, 257] f32,
// mel [257, nfilt] f32 -> out [B, T, nfilt] f32.
int asr_log_mel(const void* signals, const void* lengths, const void* cosb,
                const void* sinb, const void* mel, void* out, int B, int S,
                int T, int nfilt, float preemph, float inv_nfft,
                void* stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((T + kTileFrames - 1) / kTileFrames, B);
  log_mel_kernel<<<grid, kLogMelThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(signals), static_cast<const int*>(lengths),
      static_cast<const float*>(cosb), static_cast<const float*>(sinb),
      static_cast<const float*>(mel), static_cast<float*>(out), S, T, nfilt,
      preemph, inv_nfft);
  return static_cast<int>(cudaGetLastError());
}

// feat [B, T, F] f32, valid [B] int32 -> out [B, T, F] f32.
int asr_cmvn(const void* feat, const void* valid, void* out, int B, int T,
             int F, void* stream) {
  if (B <= 0 || T <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((F + kCmvnBins - 1) / kCmvnBins, B);
  const dim3 block(kCmvnBins, kCmvnRows);
  cmvn_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const int*>(valid),
      static_cast<float*>(out), T, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
