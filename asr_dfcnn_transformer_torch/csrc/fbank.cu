// Log-mel filterbank and per-utterance CMVN for the PyTorch port.
//
// asr_log_mel replaces asr_dfcnn_transformer_tpu/ops/pallas/fbank_kernel.py
// pallas_log_mel (_kernel): pre-emphasis 0.97 with the signal-end mask,
// 400-sample frames at hop 160, the 512-point DFT power, the mel projection
// (200 filters for the AM, 80 for the e2e front end) and log(max(., f64
// eps)).
//
//   Numerics: the DFT sums run in f64. A bin whose power is tiny next to
//   the frame's energy (the DC-only low mel filters after pre-emphasis)
//   cancels badly in f32: an f32 sum misses the exact value there by up
//   to ~0.005 in the log, by an amount that depends on the summation
//   order. In f64 the kernel sits on the exact value of the f32 inputs
//   (the python_speech_features reference is f64 too); an FFT in f64 errs
//   no more than the direct sum. Power, mel projection (a sum of
//   non-negative terms) and log stay f32. The twin is the f64 matrix
//   product with the f32 cos / sin bases: another sum, so the two agree
//   to ~3e-5 in the log, not bit for bit.
//
//   Bound: bytes. The function reads the signal and writes the features,
//   ~18 MB at [8, 1600] frames, ~5.6 us at 3.35 TB/s; a 512-point real
//   FFT is ~12 k f64 operations a frame (~0.15 G a batch, ~2 us at the
//   67 TFLOP/s of f64), and the mel bank is sparse (353 non-zeros at 200
//   filters, 425 at 80). The earlier kernel's direct DFT (400 x 257 x 2
//   f64 FMAs a frame, ~30x the FFT's operations, with the 822 KB cos / sin
//   bases read from L2) ran at 474.3 us, 85x the bound of bytes, on an
//   NVIDIA H100 80GB HBM3 at 700 W.
//   Design: one block per (utterance, 8-frame tile), 16 threads a frame.
//   The tile's pre-emphasised, masked samples sit in shared memory in f32
//   (1520 values), each thread's twelve loads of them in flight at once
//   (four blocks an SM, 128 registers a thread). Each frame's 400
//   samples, zero-padded to 512, are packed as the 256-point complex
//   sequence z[n] = x[2n] + i x[2n + 1] and transformed in two radix-16
//   passes (256 = 16 x 16): thread n1
//   takes the 16-point DFT of z[n1 + 16 n2] over n2 in registers (two
//   radix-4 passes with the W16 twiddles between them), multiplies by
//   W256^(n1 k2), and after one exchange through shared memory (rows
//   padded to 17 against bank conflicts) thread k2 takes the second
//   16-point DFT over n1, which gives Z[16 k1 + k2]. One post-processing
//   pass forms X[k] = (Z[k] + conj Z[256 - k]) / 2 + W512^k (Z[k] -
//   conj Z[256 - k]) / 2i for bins 0..256 and the power rounded to f32.
//   The twiddles exp(-2 pi i m / 512) are built in f64 on the host and
//   read through the L1 cache. The mel projection walks each filter's span
//   of bins only (first bin, count and weights computed on the host from
//   the dense bank): skipping the zero weights in bin order leaves the
//   dense sum's bits (fmaf(p, 0, acc) == acc for a finite p), and an empty
//   filter writes log(eps). The block writes its [8, nfilt] rows as one
//   coalesced run. No cuFFT.
//   It takes 42 us at [8, 1600, 200] (46 us in the served batch, whose
//   tile comes from a cold L2), 7.6x the bound of bytes, on the same card.
//   Rejected: f64 DMMA over the frame matrix (the direct DFT's 5.3 GFLOP a
//   batch, a floor of ~79 us at 67 TFLOP/s).
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
constexpr int kFftThreads = 16;     // threads per frame
constexpr int kTileFrames = 8;      // frames per block
constexpr int kTileSamples = (kTileFrames - 1) * kHop + kWin;
constexpr int kLogMelThreads = kFftThreads * kTileFrames;
constexpr int kPeLoads =   // tile samples a thread loads
    (kTileSamples + kLogMelThreads - 1) / kLogMelThreads;
constexpr int kHalf = 256;          // the complex FFT's length, nfft / 2
constexpr int kLive = kWin / 2;     // z[n] is 0 from n = 200 on
constexpr int kXStride = kFftThreads + 1;  // padded exchange rows
constexpr float kLogEps = 2.220446049250313e-16f;  // float64 eps

constexpr int kCmvnBins = 32;
constexpr int kCmvnRows = 8;

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}

// a * -i
__device__ __forceinline__ double2 mul_mi(double2 a) {
  return make_double2(a.y, -a.x);
}

// The 4-point forward DFT in place.
__device__ __forceinline__ void dft4(double2& a0, double2& a1, double2& a2,
                                     double2& a3) {
  const double2 t0 = cadd(a0, a2);
  const double2 t1 = csub(a0, a2);
  const double2 t2 = cadd(a1, a3);
  const double2 t3 = mul_mi(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

// The 16-point forward DFT in registers, natural order in and out, as two
// radix-4 passes: n = 4 na + nb, k = ka + 4 kb. w16[m] = exp(-2 pi i m / 16).
__device__ __forceinline__ void dft16(double2 (&y)[16],
                                      const double2 (&w16)[10]) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) dft4(y[nb], y[4 + nb], y[8 + nb], y[12 + nb]);
  // y[4 ka + nb] is the first pass's output ka for nb
#pragma unroll
  for (int nb = 1; nb < 4; ++nb) {
#pragma unroll
    for (int ka = 1; ka < 4; ++ka) {
      const int m = nb * ka;
      y[4 * ka + nb] =
          m == 4 ? mul_mi(y[4 * ka + nb]) : cmul(y[4 * ka + nb], w16[m]);
    }
  }
#pragma unroll
  for (int ka = 0; ka < 4; ++ka)
    dft4(y[4 * ka], y[4 * ka + 1], y[4 * ka + 2], y[4 * ka + 3]);
  // y[4 ka + kb] is Y[ka + 4 kb]
  double2 r[16];
#pragma unroll
  for (int ka = 0; ka < 4; ++ka) {
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) r[ka + 4 * kb] = y[4 * ka + kb];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) y[i] = r[i];
}

// four blocks an SM: up to 128 registers a thread, for the tile's loads
__global__ void __launch_bounds__(kLogMelThreads, 4)
log_mel_kernel(const float* __restrict__ sig, const int* __restrict__ lens,
               const double2* __restrict__ tw,
               const int* __restrict__ spans,
               const float* __restrict__ mel_w, float* __restrict__ out,
               int S, int T, int nfilt, float preemph, float inv_nfft) {
  // pre-emphasised samples, rounded in f32 as the JAX path rounds them
  __shared__ __align__(16) float pe[kTileSamples];
  // per frame: the 16 x 16 exchange, then Z, then the frame's power
  __shared__ __align__(16) double2 xbuf[kTileFrames][kFftThreads][kXStride];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTileFrames;
  const int len = lens[b];
  const float* x = sig + static_cast<size_t>(b) * S;
  const long long base = static_cast<long long>(f0) * kHop;

  // pe[t] = x[t] - c * x[t-1] with x[-1] = 0, then zero at/past the
  // utterance length (kills the -c * x[len-1] spike just past the end)
  // and past the padded signal. Every load of the tile first, all in
  // flight at once, then the arithmetic: a block's start waits on one
  // round trip to device memory, not on one a sample stride.
  float cur[kPeLoads], prev[kPeLoads];
#pragma unroll
  for (int u = 0; u < kPeLoads; ++u) {
    const int i = threadIdx.x + u * kLogMelThreads;
    const long long t = base + i;
    const bool live = i < kTileSamples && t < len && t < S;
    cur[u] = live ? x[t] : 0.f;
    prev[u] = live && t > 0 ? x[t - 1] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kPeLoads; ++u) {
    const int i = threadIdx.x + u * kLogMelThreads;
    const long long t = base + i;
    if (i < kTileSamples)
      pe[i] = t < len && t < S ? __fsub_rn(cur[u], __fmul_rn(preemph, prev[u]))
                               : 0.f;
  }
  double2 w16[10];
#pragma unroll
  for (int m = 0; m < 10; ++m) w16[m] = __ldg(tw + 32 * m);
  __syncthreads();

  const int fi = threadIdx.x / kFftThreads;
  const int p = threadIdx.x % kFftThreads;  // n1, then k2
  double2(*xb)[kXStride] = xbuf[fi];
  // first pass: thread n1 = p, the DFT over n2 of z[n1 + 16 n2]
  const float* fr = pe + fi * kHop;
  double2 y[16];
#pragma unroll
  for (int n2 = 0; n2 < 16; ++n2) {
    const int n = p + kFftThreads * n2;
    if (n < kLive) {
      const float2 v = *reinterpret_cast<const float2*>(fr + 2 * n);
      y[n2] = make_double2(v.x, v.y);
    } else {
      y[n2] = make_double2(0.0, 0.0);
    }
  }
  dft16(y, w16);
#pragma unroll
  for (int k2 = 1; k2 < 16; ++k2)  // W256^(n1 k2) = W512^(2 n1 k2)
    y[k2] = cmul(y[k2], __ldg(tw + 2 * p * k2));
#pragma unroll
  for (int k2 = 0; k2 < 16; ++k2) xb[k2][p] = y[k2];
  __syncwarp();
  // second pass: thread k2 = p, the DFT over n1: Z[16 k1 + k2]
#pragma unroll
  for (int n1 = 0; n1 < 16; ++n1) y[n1] = xb[p][n1];
  dft16(y, w16);
  __syncwarp();
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1) xb[k1][p] = y[k1];
  __syncwarp();
  // the real FFT's bins k = 16 k1 + p (and 256 at p = 0), power in f32
  const double inv = static_cast<double>(inv_nfft);
  float pw[16];
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1) {
    const int k = 16 * k1 + p;
    const int km = (kHalf - k) & (kHalf - 1);
    const double2 a = y[k1];   // Z[k]
    const double2 c = xb[km >> 4][km & 15];  // Z[256 - k]
    const double er = 0.5 * (a.x + c.x), ei = 0.5 * (a.y - c.y);
    const double orr = 0.5 * (a.y + c.y), oi = 0.5 * (c.x - a.x);
    const double2 w = __ldg(tw + k);
    const double xr = er + (w.x * orr - w.y * oi);
    const double xi = ei + (w.x * oi + w.y * orr);
    pw[k1] = static_cast<float>((xr * xr + xi * xi) * inv);
  }
  const double nyq = y[0].x - y[0].y;  // X[256], real
  __syncwarp();  // xb becomes the frame's power
  float* power = reinterpret_cast<float*>(&xb[0][0]);
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1) power[16 * k1 + p] = pw[k1];
  if (p == 0) power[kHalf] = static_cast<float>(nyq * nyq * inv);
  __syncthreads();

  const int nf = min(kTileFrames, T - f0);
  float* dst = out + (static_cast<size_t>(b) * T + f0) * nfilt;
  for (int e = threadIdx.x; e < nf * nfilt; e += blockDim.x) {
    const int f = e / nfilt;
    const int j = e - f * nfilt;
    const int first = __ldg(spans + 3 * j);
    const int count = __ldg(spans + 3 * j + 1);
    const float* wj = mel_w + __ldg(spans + 3 * j + 2);
    const float* pf = reinterpret_cast<const float*>(&xbuf[f][0][0]) + first;
    float acc = 0.f;
    for (int i = 0; i < count; ++i) acc = fmaf(pf[i], __ldg(wj + i), acc);
    dst[e] = logf(fmaxf(acc, kLogEps));
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

// signals [B, S] f32, lengths [B] int32, twiddles [512] complex f64
// (exp(-2 pi i m / 512), re / im pairs), spans [nfilt, 3] int32 (each
// filter's first bin, count and offset into weights), weights f32 (the
// spans' mel weights) -> out [B, T, nfilt] f32.
int asr_log_mel(const void* signals, const void* lengths,
                const void* twiddles, const void* spans, const void* weights,
                void* out, int B, int S, int T, int nfilt, float preemph,
                float inv_nfft, void* stream) {
  if (B <= 0 || T <= 0 || nfilt <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((T + kTileFrames - 1) / kTileFrames, B);
  log_mel_kernel<<<grid, kLogMelThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(signals), static_cast<const int*>(lengths),
      static_cast<const double2*>(twiddles), static_cast<const int*>(spans),
      static_cast<const float*>(weights), static_cast<float*>(out), S, T,
      nfilt, preemph, inv_nfft);
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
