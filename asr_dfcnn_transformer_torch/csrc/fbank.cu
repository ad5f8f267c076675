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
//   Bound: bytes, one read and one write of [B, T, F] f32 (10.24 MB each at
//   [8, 1600, 200]: 6.11 us at 3.35 TB/s). The earlier kernel (one block
//   per utterance and 32 bins, 56 blocks at that shape) walked every row
//   four times with one 4-byte load in flight a thread: 101.0 us against
//   this one's 20.4 on an NVIDIA H100 80GB HBM3 at 700 W.
//   Design: one thread-block cluster per utterance (16 blocks, the
//   non-portable size; 8 where the occupancy query cannot place 16). Block
//   r owns the contiguous run of ceil(T / c) frames r ceil(T / c) .. and
//   loads its valid rows once into shared memory by one bulk copy (the
//   TMA's non-tensor form; the unaligned head and tail, under 16 bytes
//   each, by plain loads). Each of the three statistics (sum x, sum (x -
//   mean)^2, sum (x - mean) / sd) is summed per bin over the block's rows
//   (G row groups, each in four interleaved accumulators, then the groups
//   in order); one thread bulk-copies the block's row of partials into
//   row `rank` of every block's table in distributed shared memory, each
//   copy completing on the receiver's mbarrier for that statistic, and
//   every block adds the c rows in rank order: a fixed order, no atomics,
//   so two calls give the same bits and every block the same statistics.
//   x - mean and then (x - mean) / sd are kept in the tile in place, so
//   each element is divided once; the block then writes its rows once.
//   64 registers let two blocks share an SM, so that 8 utterances' clusters
//   fit the card at once. Bins are taken in passes of at most kCmvnChunk
//   (one pass at F 200 and 80), so any F runs. An utterance whose rows do
//   not fit c blocks' shared memory takes the same kernel's streaming
//   branch: the same sums in the same order over the rows read from L2 /
//   device memory. asr_cmvn_plan gives the tiling (kernels/fbank.py
//   cmvn_plan mirrors it, cmvn_blocked_np the order of sums).
//   Numerics: f32 sums, the products and quotients rounded on their own (no
//   contraction into FMAs), exact `/` and sqrtf; so a constant column (an
//   empty mel filter) comes out exactly 0 wherever valid <= T, as in the
//   JAX path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

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

constexpr int kCmvnThreads = 512;
constexpr int kCmvnChunk = 256;      // bins a pass of the three statistics
constexpr int kCmvnMaxCluster = 16;  // non-portable; 8 is portable
constexpr int kCmvnMinCluster = 8;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block

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

// The tiling of one cmvn launch for T frames of F bins on clusters of c
// blocks: rows a block, bins a pass (chunk), row groups a bin, whether the
// rows stream from device memory, and the dynamic shared memory a block.
// Shared memory: four mbarriers (the load's and one a statistic's, 32
// bytes); the block's three partial rows and two [c][chunk] tables of the
// cluster's partials (rows padded to 4 floats); per bin of the chunk G
// group sums, the mean, sd and mean2; then the tile of the block's rows
// (16-byte aligned, up to 3 floats of lead so that the bulk copy's ends
// fall on 16-byte boundaries of both spaces) unless streaming.
struct CmvnPlan {
  int rows, chunk, groups, stream;
  size_t smem;
};

__host__ __device__ size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ int pad4(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ size_t cmvn_fixed_bytes(int chunk, int groups, int c) {
  return 32 + round16(4 * (static_cast<size_t>(3 + 2 * c) * pad4(chunk) +
                           static_cast<size_t>(groups + 3) * chunk));
}

CmvnPlan cmvn_plan(int T, int F, int c) {
  CmvnPlan p;
  p.rows = (T + c - 1) / c;
  p.chunk = F < kCmvnChunk ? F : kCmvnChunk;
  p.groups = kCmvnThreads / p.chunk > 1 ? kCmvnThreads / p.chunk : 1;
  const size_t fixed = cmvn_fixed_bytes(p.chunk, p.groups, c);
  const size_t tile = round16(4 * (static_cast<size_t>(p.rows) * F + 3));
  p.stream = fixed + tile > kSmemLimit ? 1 : 0;
  p.smem = p.stream ? fixed : fixed + tile;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of this block's shared `addr` in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_u32(const void* addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(addr)), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_u32(bar)));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "CMVN_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra CMVN_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Copies n floats from src (global) to dst (shared), dst and src equal
// mod 16 bytes: the 16-byte aligned body by one bulk copy completing on
// bar (thread 0), head and tail by plain loads. Returns whether a bulk
// copy was issued (the caller then waits on bar's phase 0).
__device__ bool load_rows(float* dst, const float* __restrict__ src,
                          size_t n, uint64_t* bar) {
  const size_t lead = (reinterpret_cast<uintptr_t>(src) >> 2) & 3;
  const size_t to_boundary = (4 - lead) & 3;
  const size_t head = to_boundary < n ? to_boundary : n;
  const size_t body = (n - head) & ~static_cast<size_t>(3);
  for (size_t i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (size_t i = head + body + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
  if (body == 0) return false;
  if (threadIdx.x == 0) {
    mbar_expect(bar, static_cast<uint32_t>(4 * body));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst + head)),
        "l"(src + head), "r"(static_cast<uint32_t>(4 * body)),
        "r"(smem_u32(bar))
        : "memory");
  }
  return true;
}

// Over m = 0 .. count - 1: u = map(col[m * step]), written back in place
// when kStore, and the sum of term(u) in four interleaved accumulators
// (element m into accumulator m % 4, each in order), combined as (a0 + a1)
// + (a2 + a3): four loads in flight instead of one.
template <bool kStore, typename Map, typename Term>
__device__ __forceinline__ float strided_pass(float* col, size_t step,
                                              int count, Map map, Term term) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  int m = 0;
  for (; m + 4 <= count; m += 4) {
    float* q = col + m * step;
    float u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = map(q[i * step]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kStore) q[i * step] = u[i];
      a[i] = __fadd_rn(a[i], term(u[i]));
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (m + i < count) {
      float* q = col + (m + i) * step;
      const float u = map(*q);
      if (kStore) *q = u;
      a[i] = __fadd_rn(a[i], term(u));
    }
  }
  return __fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3]));
}

// Rows g, g + G, .. below n: how many.
__device__ __forceinline__ int group_rows(int n, int g, int groups) {
  return n > g ? (n - g + groups - 1) / groups : 0;
}

// One statistic over the block's n valid rows for bins f0 .. f0 + fc:
// thread (g, j) runs strided_pass over rows g, g + G, .. of bin j (map_of(j)
// maps x[r][f0 + j], term sums), the block adds the G group sums of bin j
// in group order into mine[j], and one thread copies that row into row
// `rank` of every block's table (bulk copies completing on each block's
// mbarrier `bar`). On return the table holds the whole cluster's partials.
template <bool kStore, typename MapOf, typename Term>
__device__ __forceinline__ void statistic(
    int c, int rank, float* x, int F, int n, int f0, int fc, int chunk,
    int groups, float* red, float* mine, float* table, uint64_t* bar,
    uint32_t parity, MapOf map_of, Term term) {
  for (int it = threadIdx.x; it < groups * fc; it += blockDim.x) {
    const int g = it / fc;
    const int j = it - g * fc;
    red[g * chunk + j] = strided_pass<kStore>(
        x + static_cast<size_t>(g) * F + f0 + j,
        static_cast<size_t>(groups) * F, group_rows(n, g, groups), map_of(j),
        term);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < fc; j += blockDim.x) {
    float p = red[j];
    for (int g = 1; g < groups; ++g) p = __fadd_rn(p, red[g * chunk + j]);
    mine[j] = p;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = 4 * pad4(fc);
    // the row's generic writes before the async proxy reads it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(bar, c * bytes);
    for (int r = 0; r < c; ++r)
      asm volatile(
          "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];\n" ::"r"(
              peer_u32(table + rank * pad4(chunk), r)),
          "r"(smem_u32(mine)), "r"(bytes), "r"(peer_u32(bar, r))
          : "memory");
  }
  mbar_wait(bar, parity);
}

// The cluster's total of bin j from a table: the c blocks' partials added
// in rank order.
__device__ __forceinline__ float cluster_total(const float* table, int cp,
                                               int j, int c) {
  float total = table[j];
  for (int r = 1; r < c; ++r) total = __fadd_rn(total, table[r * cp + j]);
  return total;
}

// The three statistics and the write of one block's rows (see the
// header): x is the block's first row, y the output's; n valid rows of the
// `rows` the block owns. kTile: x is the block's tile in shared memory,
// which keeps x - mean after the second statistic and (x - mean) / sd
// after the third (the same roundings as computing them again); else x
// streams from device memory and each pass computes them anew.
template <bool kTile>
__device__ __forceinline__ void cmvn_rows(
    int c, int rank, float* x, float* __restrict__ y, int F, int n,
    int rows, int chunk, int groups, float cnt, uint64_t* bars, float* mine,
    float* table_a, float* table_b, float* red, float* mean, float* sd,
    float* mean2) {
  const int cp = pad4(chunk);
  for (int f0 = 0, ci = 0; f0 < F; f0 += chunk, ++ci) {
    const int fc = min(chunk, F - f0);
    const uint32_t par = static_cast<uint32_t>(ci) & 1u;
    statistic<false>(c, rank, x, F, n, f0, fc, chunk, groups, red, mine,
                     table_a, bars + 1, par,
                     [](int) { return [](float v) { return v; }; },
                     [](float v) { return v; });
    for (int j = threadIdx.x; j < fc; j += blockDim.x)
      mean[j] = cluster_total(table_a, cp, j, c) / cnt;
    __syncthreads();
    statistic<kTile>(c, rank, x, F, n, f0, fc, chunk, groups, red,
                     mine + cp, table_b, bars + 2, par,
                     [mean](int j) {
                       const float m = mean[j];
                       return [m](float v) { return v - m; };
                     },
                     [](float d) { return __fmul_rn(d, d); });
    for (int j = threadIdx.x; j < fc; j += blockDim.x) {
      const float s = sqrtf(cluster_total(table_b, cp, j, c) / cnt);
      sd[j] = s == 0.f ? 1.f : s;
    }
    __syncthreads();
    // table_a again: each block read its first statistic before it sent
    // its second, which every block's third waits on
    statistic<kTile>(c, rank, x, F, n, f0, fc, chunk, groups, red,
                     mine + 2 * cp, table_a, bars + 3, par,
                     [mean, sd](int j) {
                       const float m = mean[j], s = sd[j];
                       return [m, s](float v) {
                         return kTile ? v / s : (v - m) / s;
                       };
                     },
                     [](float q) { return q; });
    for (int j = threadIdx.x; j < fc; j += blockDim.x)
      mean2[j] = cluster_total(table_a, cp, j, c) / cnt;
    cluster_arrive();  // done with table_a, which the next chunk fills
    __syncthreads();
    for (int it = threadIdx.x; it < groups * fc; it += blockDim.x) {
      const int g = it / fc;
      const int j = it - g * fc;
      const float m = mean[j], s = sd[j], m2 = mean2[j];
      const size_t step = static_cast<size_t>(groups) * F;
      const float* xc = x + static_cast<size_t>(g) * F + f0 + j;
      float* yc = y + static_cast<size_t>(g) * F + f0 + j;
      const int valid_rows = group_rows(n, g, groups);
      const int all_rows = group_rows(rows, g, groups);
#pragma unroll 4
      for (int r = 0; r < valid_rows; ++r)
        yc[r * step] = kTile ? xc[r * step] - m2 : (xc[r * step] - m) / s - m2;
      for (int r = valid_rows; r < all_rows; ++r) yc[r * step] = 0.f;
    }
    // every block has received its copies and read its table_a: none
    // writes into another's, or is written into, after this
    cluster_wait();
  }
}

// One cluster per utterance, block rank r owning frames r rows .. (see the
// header). Launched with B x c blocks in clusters of c.
__global__ void __launch_bounds__(kCmvnThreads, 2)
cmvn_kernel(const float* __restrict__ feat, const int* __restrict__ valid,
            float* __restrict__ out, int T, int F, int rows_blk, int chunk,
            int groups, int stream) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / c;
  const int cp = pad4(chunk);
  auto* bars = reinterpret_cast<uint64_t*>(smem);  // load, three statistics
  float* mine = reinterpret_cast<float*>(smem + 32);
  float* table_a = mine + 3 * cp;
  float* table_b = table_a + c * cp;
  float* red = table_b + c * cp;
  float* mean = red + groups * chunk;
  float* sd = mean + chunk;
  float* mean2 = sd + chunk;
  float* tile =
      reinterpret_cast<float*>(smem + cmvn_fixed_bytes(chunk, groups, c));

  const int nv = valid[b];
  const int rows = max(0, min(nv, T));
  const float cnt = static_cast<float>(max(nv, 1));
  const int r0 = min(rank * rows_blk, T);
  const int r1 = min(r0 + rows_blk, T);
  const int n = max(0, min(r1, rows) - r0);  // valid rows of the block
  const size_t base = (static_cast<size_t>(b) * T + r0) * F;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float* x = tile + ((reinterpret_cast<uintptr_t>(feat + base) >> 2) & 3);
  const bool copying =
      !stream && load_rows(x, feat + base, static_cast<size_t>(n) * F, bars);
  // every block's mbarriers are set before any block copies into it
  cluster.sync();
  if (stream) {
    cmvn_rows<false>(c, rank, const_cast<float*>(feat + base), out + base, F,
                     n, r1 - r0, chunk, groups, cnt, bars, mine, table_a,
                     table_b, red, mean, sd, mean2);
    return;
  }
  if (copying) mbar_wait(bars, 0);
  __syncthreads();
  cmvn_rows<true>(c, rank, x, out + base, F, n, r1 - r0, chunk, groups, cnt,
                  bars, mine, table_a, table_b, red, mean, sd, mean2);
}

// One (device, T, F)'s cluster size and how many such clusters the card
// holds at once, as the occupancy query gave them.
struct CmvnChoice {
  int dev, T, F, cluster, active;
};
constexpr int kCmvnChoices = 64;  // kept; the oldest replaced past that

// Cluster size for the plan's shared memory: 16 where the occupancy query
// places a cluster of 16, else 8; 0 where neither can be placed. *active,
// when given, receives how many such clusters the card holds at once. The
// answer depends on (device, T, F) alone, so each is asked once and kept.
int cmvn_cluster(int T, int F, cudaStream_t stream, int* active = nullptr) {
  static bool configured[64] = {};  // per device ordinal
  static CmvnChoice choices[kCmvnChoices];
  static int n_choices = 0, next_choice = 0;
  static std::mutex mu;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_choices; ++i) {
    const CmvnChoice& k = choices[i];
    if (k.dev == dev && k.T == T && k.F == F) {
      if (active != nullptr) *active = k.active;
      return k.cluster;
    }
  }
  if (!configured[dev]) {
    if (cudaFuncSetAttribute(cmvn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit)) != cudaSuccess ||
        cudaFuncSetAttribute(cmvn_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    configured[dev] = true;
  }
  for (int c = kCmvnMaxCluster; c >= kCmvnMinCluster; c /= 2) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kCmvnThreads);
    cfg.dynamicSmemBytes = cmvn_plan(T, F, c).smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, cmvn_kernel, &cfg) !=
        cudaSuccess)
      cudaGetLastError();  // a refused query leaves no error behind
    else if (clusters > 0) {
      choices[next_choice] = {dev, T, F, c, clusters};
      next_choice = (next_choice + 1) % kCmvnChoices;
      if (n_choices < kCmvnChoices) ++n_choices;
      if (active != nullptr) *active = clusters;
      return c;
    }
  }
  return 0;
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

// One field of the tiling asr_cmvn launches at [B, T, F] on the current
// device: 0 the cluster's size (0: none can be placed), 1 rows a block, 2
// bins a pass, 3 row groups, 4 streams (1) or holds its rows in shared
// memory (0), 5 dynamic shared memory a block, 6 clusters the card holds
// at once (the occupancy query's); -1 for an unknown field.
// kernels/fbank.py cmvn_plan mirrors fields 1-5 for a given cluster size.
long long asr_cmvn_plan(int B, int T, int F, int field) {
  if (B <= 0 || T <= 0 || F <= 0) return -1;
  int active = 0;
  const int c = cmvn_cluster(T, F, nullptr, &active);
  const CmvnPlan p = cmvn_plan(T, F, c > 0 ? c : kCmvnMaxCluster);
  const long long v[] = {c, p.rows, p.chunk, p.groups, p.stream,
                         static_cast<long long>(p.smem), active};
  return field >= 0 && field < 7 ? v[field] : -1;
}

// feat [B, T, F] f32, valid [B] int32 -> out [B, T, F] f32; any sizes.
int asr_cmvn(const void* feat, const void* valid, void* out, int B, int T,
             int F, void* stream) {
  if (B <= 0 || T <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = cmvn_cluster(T, F, s);
  if (c == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const CmvnPlan p = cmvn_plan(T, F, c);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * c);
  cfg.blockDim = dim3(kCmvnThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, cmvn_kernel, static_cast<const float*>(feat),
      static_cast<const int*>(valid), static_cast<float*>(out), T, F, p.rows,
      p.chunk, p.groups, p.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
